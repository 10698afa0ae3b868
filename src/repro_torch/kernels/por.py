"""CoDec POR (partial output reduction, paper Alg. 3): CUDA kernel + plain
version.

``por`` merges two flash partials over the same queries with the CUDA
kernel in ``csrc/por.cu`` (the port of the Pallas kernel
``repro.kernels.por.por``) when its tensors lie on the card, and through
``por_torch`` (= ``ref.por_ref``) when they lie on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .ref import por_ref

# launches of the CUDA kernel in this process (plain-path calls are not
# counted); chip_smoke.py resets it before driving the serving path
launches = 0

por_torch = por_ref


def por(o1: torch.Tensor, m1: torch.Tensor, l1: torch.Tensor,
        o2: torch.Tensor, m2: torch.Tensor, l2: torch.Tensor,
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Merge partials. o*: (N, h, d) float32; m*/l*: (N, h) float32."""
    if o1.device.type == "cpu":
        return por_torch(o1, m1, l1, o2, m2, l2)
    if o1.device.type != "cuda":
        raise ValueError(f"por: no kernel for device {o1.device}")
    n, h, d = o1.shape
    for name, t, shape in (("o1", o1, (n, h, d)), ("o2", o2, (n, h, d)),
                           ("m1", m1, (n, h)), ("l1", l1, (n, h)),
                           ("m2", m2, (n, h)), ("l2", l2, (n, h))):
        if t.device != o1.device:
            raise ValueError(f"por: {name} on {t.device}, expected "
                             f"{o1.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"por: {name} has dtype {t.dtype}, expected "
                            f"torch.float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"por: {name} shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"por: {name} must be contiguous")
    lib = build.load()
    o = torch.empty_like(o1)
    m = torch.empty_like(m1)
    l = torch.empty_like(l1)
    stream = torch.cuda.current_stream(o1.device).cuda_stream
    err = lib.codec_por(o1.data_ptr(), m1.data_ptr(), l1.data_ptr(),
                        o2.data_ptr(), m2.data_ptr(), l2.data_ptr(),
                        o.data_ptr(), m.data_ptr(), l.data_ptr(),
                        n * h, d, stream)
    build.check(err, "codec_por")
    global launches
    launches += 1
    return o, m, l
