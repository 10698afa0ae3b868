"""CoDec POR (partial output reduction, paper Alg. 3): CUDA kernels + plain
versions.

``por`` merges two flash partials over the same queries with the CUDA
kernel in ``csrc/por.cu`` (the port of the Pallas kernel
``repro.kernels.por.por``) when its tensors lie on the card, and through
``por_torch`` (= ``ref.por_ref``) when they lie on the CPU.

``por_epilogue`` is the decode engine's attention epilogue for one layer,
built around POR: the segment log-sum-exp reduction of a backend's raw
partials (``ops.Parts``), the growing tail page's attention and their POR
merge, written in q's type, in one launch of the kernel
``codec_por_epilogue`` for CUDA tensors and through
``por_epilogue_torch`` (the same composition as plain torch ops) for CPU
tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import build, ops
from .ref import por_ref

# launches of the CUDA kernels in this process (plain-path calls are not
# counted); chip_smoke.py resets them before driving the serving path
launches = 0
epilogue_launches = 0

por_torch = por_ref

# what the epilogue kernel takes
EPILOGUE_HEAD_DIMS = (64, 128, 256)
EPILOGUE_PAGES = (16, 64)
EPILOGUE_MAX_GROUP = 8


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


def por_epilogue_torch(q, o_parts, m_parts, l_parts, seg_offsets, seg_rows,
                       k_pool, v_pool, tail_pages, tail_base, q_pos, *,
                       window: int = 0):
    """The epilogue as plain torch ops, in the engine's order before the
    kernel existed: the live select and segment reduction
    (``ops.combine_parts``), the tail page (``ops.single_page_attention``
    over the gathered pages), ``por_torch`` and the cast.  Returns
    ``(o in q's type, m, l)``."""
    o_f, m_f, l_f = ops.combine_parts(ops.Parts(o_parts, m_parts, l_parts,
                                                seg_offsets, seg_rows))
    o_t, m_t, l_t = ops.single_page_attention(
        q, k_pool[tail_pages], v_pool[tail_pages], tail_base, q_pos,
        window=window)
    o, m, l = por_torch(o_f, m_f, l_f, o_t, m_t, l_t)
    return o.to(q.dtype), m, l


def _check_shapes(q, o_parts, m_parts, l_parts, seg_offsets, seg_rows,
                  k_pool, v_pool, tail_pages, tail_base, q_pos) -> None:
    if q.dim() != 3 or o_parts.dim() != 3:
        raise ValueError(f"por_epilogue: q {tuple(q.shape)} and o_parts "
                         f"{tuple(o_parts.shape)} must be 3-D")
    B, h_q, d = q.shape
    P = o_parts.shape[0]
    want = {"o_parts": (P, h_q, d), "m_parts": (P, h_q),
            "l_parts": (P, h_q), "seg_offsets": (B + 1,),
            "seg_rows": (seg_rows.numel(),), "tail_pages": (B,),
            "tail_base": (B,), "q_pos": (B,)}
    got = {"o_parts": o_parts, "m_parts": m_parts, "l_parts": l_parts,
           "seg_offsets": seg_offsets, "seg_rows": seg_rows,
           "tail_pages": tail_pages, "tail_base": tail_base, "q_pos": q_pos}
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"por_epilogue: {name} shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if (k_pool.dim() != 4 or v_pool.shape != k_pool.shape
            or k_pool.shape[3] != d or h_q % k_pool.shape[2]):
        raise ValueError(f"por_epilogue: pool shapes {tuple(k_pool.shape)} "
                         f"/ {tuple(v_pool.shape)} do not fit q "
                         f"{tuple(q.shape)}")


def _check(name: str, t: torch.Tensor, dev, dtypes) -> None:
    if t.device != dev:
        raise ValueError(f"por_epilogue: {name} on {t.device}, expected "
                         f"{dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"por_epilogue: {name} has dtype {t.dtype}, "
                        f"expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"por_epilogue: {name} must be contiguous")


def por_epilogue(q: torch.Tensor, o_parts: torch.Tensor,
                 m_parts: torch.Tensor, l_parts: torch.Tensor,
                 seg_offsets: torch.Tensor, seg_rows: torch.Tensor,
                 k_pool: torch.Tensor, v_pool: torch.Tensor,
                 tail_pages: torch.Tensor, tail_base: torch.Tensor,
                 q_pos: torch.Tensor, *, window: int = 0,
                 stats: bool = False,
                 out: Optional[torch.Tensor] = None):
    """Decode attention's epilogue: segment reduction + tail page + POR.

    q: (B, h_q, d) float32/bfloat16; o_parts (P, h_q, d), m_parts /
    l_parts (P, h_q) float32: a backend's raw partials, of which only the
    rows that the CSR ``seg_offsets`` (B+1,) / ``seg_rows`` (nnz,) int32
    lists are read; pools (pages, page, n_kv, d) float32/bfloat16;
    ``tail_pages``, ``tail_base``, ``q_pos`` (B,) int64: each query's
    growing last page, the absolute position of its token 0 and the
    query's position.  Returns the attention output (B, h_q, d) in q's
    type, or ``(o, m, l)`` with float32 ``m``, ``l`` (B, h_q) when
    ``stats``.  CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise).  ``out``: a (B, h_q, d) tensor of q's type for
    the kernel to write into.
    """
    args = (q, o_parts, m_parts, l_parts, seg_offsets, seg_rows, k_pool,
            v_pool, tail_pages, tail_base, q_pos)
    _check_shapes(*args)
    if q.device.type == "cpu":
        o, m, l = por_epilogue_torch(*args, window=window)
        if out is not None:
            out.copy_(o)
            o = out
        return (o, m, l) if stats else o
    if q.device.type != "cuda":
        raise ValueError(f"por_epilogue: no kernel for device {q.device}")
    dev = q.device
    f32, bf16, i32, i64 = (torch.float32, torch.bfloat16, torch.int32,
                           torch.int64)
    for name, t, dtypes in (
            ("q", q, (f32, bf16)), ("o_parts", o_parts, (f32,)),
            ("m_parts", m_parts, (f32,)), ("l_parts", l_parts, (f32,)),
            ("seg_offsets", seg_offsets, (i32,)),
            ("seg_rows", seg_rows, (i32,)), ("k_pool", k_pool, (f32, bf16)),
            ("v_pool", v_pool, (k_pool.dtype,)),
            ("tail_pages", tail_pages, (i64,)),
            ("tail_base", tail_base, (i64,)), ("q_pos", q_pos, (i64,))):
        _check(name, t, dev, dtypes)
    B, h_q, d = q.shape
    _, page, n_kv, _ = k_pool.shape
    if (d not in EPILOGUE_HEAD_DIMS or page not in EPILOGUE_PAGES
            or not 1 <= h_q // n_kv <= EPILOGUE_MAX_GROUP):
        raise ValueError(
            f"por_epilogue: the kernel takes d in {EPILOGUE_HEAD_DIMS}, "
            f"pages of {EPILOGUE_PAGES} and 1 to {EPILOGUE_MAX_GROUP} query "
            f"heads per KV head, got d={d} page={page} h_q={h_q} "
            f"n_kv={n_kv}")
    if out is None:
        out = torch.empty_like(q)
    _check("out", out, dev, (q.dtype,))
    if out.shape != q.shape:
        raise ValueError(f"por_epilogue: out shape {tuple(out.shape)}, "
                         f"expected {tuple(q.shape)}")
    for name, t in (("o_parts", o_parts), ("k_pool", k_pool),
                    ("v_pool", v_pool), ("out", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"por_epilogue: {name} must be 16-byte aligned "
                             f"(vector loads)")
    m = l = None
    if stats:
        m = torch.empty(B, h_q, dtype=f32, device=dev)
        l = torch.empty(B, h_q, dtype=f32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.codec_por_epilogue(
        q.data_ptr(), int(q.dtype == bf16), o_parts.data_ptr(),
        m_parts.data_ptr(), l_parts.data_ptr(), seg_offsets.data_ptr(),
        seg_rows.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        int(k_pool.dtype == bf16), tail_pages.data_ptr(),
        tail_base.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(),
        B, h_q, n_kv, d, page, int(window), 1.0 / math.sqrt(d), stream)
    build.check(err, "codec_por_epilogue")
    global epilogue_launches
    epilogue_launches += 1
    return (out, m, l) if stats else out
