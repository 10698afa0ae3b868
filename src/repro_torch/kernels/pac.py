"""CoDec PAC (partial attention computation): CUDA kernel + plain version.

``pac`` runs a compiled ``DecodePlan`` through the hand-written CUDA
kernel in ``csrc/pac.cu`` (the port of the Pallas kernel
``repro.kernels.pac.pac``) when its tensors lie on the card, and through
``pac_torch`` — the plain PyTorch twin of ``repro.kernels.ops.pac_xla``,
over the plan's task-major arrays — when they lie on the CPU.

Outputs are task-major partials ``(o, m, l)``: ``(T+1, max_q, h_q, d)``,
``(T+1, max_q, h_q)``, ``(T+1, max_q, h_q)`` in float32, ``o`` normalised
within the task's KV slice.  The kernel writes only live query slots
(``slot < task_qnum``); the rest hold whatever ``torch.empty`` gave and are
masked by the caller (``ops.codec_partials_arrays``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import build
from .ref import MASK_VALUE

# launches of the CUDA kernel in this process (plain-path calls are not
# counted); chip_smoke.py resets it before driving the serving path
launches = 0

_DTYPES = (torch.float32, torch.bfloat16)


def pac_torch(q_tasks: torch.Tensor,     # (T+1, max_q, h_q, d)
              qpos_tasks: torch.Tensor,  # (T+1, max_q)
              k_pool: torch.Tensor,      # (P, page, n_kv, d)
              v_pool: torch.Tensor,
              task_pages: torch.Tensor,  # (T+1, max_pages)
              task_kvlen: torch.Tensor,  # (T+1,)
              task_pos: torch.Tensor,    # (T+1,)
              window: int = 0,
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PAC over the task-major plan arrays as dense torch ops."""
    Tp1, max_q, h_q, d = q_tasks.shape
    _, page, n_kv, _ = k_pool.shape
    max_pages = task_pages.shape[1]
    n = max_pages * page
    group = h_q // n_kv
    scale = 1.0 / math.sqrt(d)
    dev = q_tasks.device

    pages = task_pages.long()
    k_t = k_pool[pages].reshape(Tp1, n, n_kv, d)
    v_t = v_pool[pages].reshape(Tp1, n, n_kv, d)

    qf = (q_tasks.float()
          .reshape(Tp1, max_q, n_kv, group, d)
          .permute(0, 2, 1, 3, 4)
          .reshape(Tp1, n_kv, max_q * group, d))
    kf = k_t.float().permute(0, 2, 1, 3)                  # (T, n_kv, n, d)
    vf = v_t.float().permute(0, 2, 1, 3)

    s = torch.einsum("thrd,thnd->thrn", qf, kf) * scale

    off = torch.arange(n, device=dev)
    pos = task_pos.long()[:, None] + off[None, :]              # (T, n)
    valid = off[None, :] < task_kvlen.long()[:, None]
    qp = qpos_tasks.long()                                     # (T, max_q)
    mask = valid[:, None, :] & (pos[:, None, :] <= qp[:, :, None])
    if window > 0:
        mask = mask & (pos[:, None, :] > qp[:, :, None] - window)
    # (T, max_q, n) -> (T, n_kv, max_q*group, n)
    mask_r = (mask[:, :, None, :].expand(Tp1, max_q, group, n)
              .reshape(Tp1, 1, max_q * group, n).expand_as(s))

    s = torch.where(mask_r, s, torch.full_like(s, MASK_VALUE))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * mask_r
    l = p.sum(dim=-1)
    u = torch.einsum("thrn,thnd->thrd", p, vf)
    o = u / torch.clamp(l, min=1e-30)[..., None]

    def unfold(x):
        tail = x.shape[3:]
        return (x.reshape(Tp1, n_kv, max_q, group, *tail)
                 .permute(0, 2, 1, 3, *(4 + i for i in range(len(tail))))
                 .reshape(Tp1, max_q, h_q, *tail))

    return unfold(o), unfold(m), unfold(l)


def _check(name: str, t: torch.Tensor, dev, dtypes) -> None:
    if t.device != dev:
        raise ValueError(f"pac: {name} on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"pac: {name} has dtype {t.dtype}, expected one "
                        f"of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"pac: {name} must be contiguous")


def pac(q: torch.Tensor, pa, k_pool: torch.Tensor, v_pool: torch.Tensor,
        *, window: int = 0,
        out: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PAC over a plan's arrays (``ops.PlanArrays``).

    q: (B, h_q, d) float32/bfloat16; pools: (P, page, n_kv, d) float32 or
    bfloat16.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise).  ``out``: float32 ``(o, m, l)`` for the kernel to
    write into instead of fresh ``torch.empty`` tensors; its dead slots
    keep what they held.
    """
    if q.device.type == "cpu":
        return pac_torch(q[pa.q_gather.long()], pa.q_pos, k_pool, v_pool,
                         pa.task_pages, pa.task_kvlen, pa.task_pos,
                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"pac: no kernel for device {q.device}")
    dev = q.device
    _check("q", q, dev, _DTYPES)
    _check("k_pool", k_pool, dev, _DTYPES)
    _check("v_pool", v_pool, dev, (k_pool.dtype,))
    ints = ("q_gather", "q_pos", "task_qnum", "step_task", "step_page",
            "step_valid", "step_first", "step_last", "step_pos",
            "step_kvlen")
    for f in ints:
        _check(f, getattr(pa, f), dev, (torch.int32,))
    B, h_q, d = q.shape
    P, page, n_kv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"pac: pool shapes {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q {tuple(q.shape)}")
    if h_q % n_kv or d % 4 or d > 512:
        raise ValueError(f"pac: needs h_q % n_kv == 0, d % 4 == 0 and "
                         f"d <= 512, got h_q={h_q} n_kv={n_kv} d={d}")
    if page >= 1 << 20:
        raise ValueError(f"pac: page {page} >= {1 << 20}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pac: pools must be 16-byte aligned (vector loads)")
    Tp1, max_q = pa.q_gather.shape
    num_lanes, max_steps = pa.step_task.shape
    for f in ("step_page", "step_valid", "step_first", "step_last",
              "step_pos", "step_kvlen"):
        if getattr(pa, f).shape != (num_lanes, max_steps):
            raise ValueError(f"pac: {f} shape {tuple(getattr(pa, f).shape)}")
    if pa.q_pos.shape != (Tp1, max_q) or pa.task_qnum.shape != (Tp1,):
        raise ValueError("pac: task arrays disagree with q_gather")
    lib = build.load()
    shapes = ((Tp1, max_q, h_q, d), (Tp1, max_q, h_q), (Tp1, max_q, h_q))
    if out is None:
        out = tuple(torch.empty(sh, dtype=torch.float32, device=dev)
                    for sh in shapes)
    for name, t, sh in zip("oml", out, shapes):
        _check(name, t, dev, (torch.float32,))
        if t.shape != sh:
            raise ValueError(f"pac: out {name} shape {tuple(t.shape)}, "
                             f"expected {sh}")
    o, m, l = out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.codec_pac(
        q.data_ptr(), int(q.dtype == torch.bfloat16),
        pa.q_gather.data_ptr(), pa.q_pos.data_ptr(), pa.task_qnum.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(),
        int(k_pool.dtype == torch.bfloat16),
        pa.step_task.data_ptr(), pa.step_page.data_ptr(),
        pa.step_valid.data_ptr(), pa.step_first.data_ptr(),
        pa.step_last.data_ptr(), pa.step_pos.data_ptr(),
        pa.step_kvlen.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(),
        num_lanes, max_steps, max_q, h_q, n_kv, d, page, int(window),
        1.0 / math.sqrt(d), stream)
    build.check(err, "codec_pac")
    global launches
    launches += 1
    return o, m, l
