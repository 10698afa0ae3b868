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
tensors.  ``tail=False`` (the speculative verify step, whose plan covers
every page) keeps the segment reduction and the cast only.  The mesh's
step runs it once per shard with ``owner=`` (a shard that does not hold
a row's tail contributes the POR identity), ``o_f32=True`` (float32
``o``, so the cross-shard merge sees unrounded partials) and ``m`` /
``l`` written into its fixed buffers (``out_m=`` / ``out_l=``).

``por_allmerge`` and ``por_subgroup_merge`` merge partials stacked over a
leading data-shard axis ``(D, ...)``, the counterparts of ``repro``'s
cross-device merges under ``shard_map``: a round's ``ppermute`` is
``exchange`` (shard ``i`` receives shard ``i ^ shift``'s buffer) and a
merge round runs the pairwise ``por`` (the CUDA ``codec_por`` kernel on
the card) over every shard at once.  No serving path calls them.

``mesh_merge`` is what the mesh's step runs once a layer: shard 0's view
of ``por_subgroup_merge`` over the rows that span shards, scattered into
the layer's output and cast, in one launch of the kernel
``codec_mesh_merge`` (``csrc/mesh_merge.cu``) for CUDA tensors and
through ``mesh_merge_torch`` (the same composition as plain torch ops, its
rounds on ``por_ref``) for CPU tensors.  Its rows are bitwise those of
the stacked butterfly on ``codec_por``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import build, ops
from .ref import MASK_VALUE, por_ref

# launches of the CUDA kernels in this process (plain-path calls are not
# counted); chip_smoke.py resets them before driving the serving path
launches = 0
epilogue_launches = 0
mesh_merge_launches = 0

por_torch = por_ref

# what the epilogue kernel takes: the kernels' head dims (d % 16 == 0,
# 16 <= d <= 256), any page up to EPILOGUE_MAX_PAGE tokens (PAC's bound:
# a page's token count has 20 bits) and any number of query heads per KV
# head
EPILOGUE_MAX_PAGE = (1 << 20) - 1
# what the mesh merge kernel takes: the same head dims and any
# power-of-two data axis up to MERGE_MAX_SHARDS (its stack of block
# results has 16 levels)
MERGE_MAX_SHARDS = 1 << 19


def epilogue_refusal(d: int, page: int) -> Optional[str]:
    """Why ``codec_por_epilogue`` does not take head dim ``d`` at pages of
    ``page`` tokens, or None where it does."""
    if d not in build.HEAD_DIMS or not 1 <= page <= EPILOGUE_MAX_PAGE:
        return (f"the kernel takes d a multiple of 16 from 16 to 256 and "
                f"pages of 1 to {EPILOGUE_MAX_PAGE} tokens, got d={d} "
                f"page={page}")
    return None


def merge_refusal(D: int, hd: int) -> Optional[str]:
    """Why ``codec_mesh_merge`` does not take a data axis of ``D`` shards
    at head dim ``hd``, or None where it does."""
    if D < 1 or D & (D - 1) or D > MERGE_MAX_SHARDS \
            or hd not in build.HEAD_DIMS:
        return (f"the kernel takes a power-of-two shard axis up to "
                f"{MERGE_MAX_SHARDS} and hd a multiple of 16 from 16 to "
                f"256, got D={D} hd={hd}")
    return None


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
                       window: int = 0, tail: bool = True, owner=None,
                       o_f32: bool = False):
    """The epilogue as plain torch ops, in the engine's order before the
    kernel existed: the live select and segment reduction
    (``ops.combine_parts``), the tail page (``ops.single_page_attention``
    over the gathered pages), ``por_torch`` and the cast.  Returns
    ``(o in q's type, m, l)``, ``o`` in float32 with ``o_f32``.
    ``tail=False`` stops after the segment reduction (``repro``'s
    ``codec_partials_arrays`` arithmetic) and casts.  ``owner`` (B,):
    rows where it is 0 take the POR identity (``o = 0``, ``m =
    MASK_VALUE``, ``l = 0``) as their tail partial, as ``repro``'s
    sharded step selects it."""
    dtype = torch.float32 if o_f32 else q.dtype
    o_f, m_f, l_f = ops.combine_parts(ops.Parts(o_parts, m_parts, l_parts,
                                                seg_offsets, seg_rows))
    if not tail:
        return o_f.to(dtype), m_f, l_f
    o_t, m_t, l_t = ops.single_page_attention(
        q, k_pool[tail_pages], v_pool[tail_pages], tail_base, q_pos,
        window=window)
    if owner is not None:
        own = owner.bool()
        m_t = torch.where(own[:, None], m_t, MASK_VALUE)
        l_t = torch.where(own[:, None], l_t, 0.0)
        o_t = torch.where(own[:, None, None], o_t, 0.0)
    o, m, l = por_torch(o_f, m_f, l_f, o_t, m_t, l_t)
    return o.to(dtype), m, l


def _check_shapes(q, o_parts, m_parts, l_parts, seg_offsets, seg_rows,
                  k_pool, v_pool, tail_pages, tail_base, q_pos,
                  tail: bool = True, owner=None) -> None:
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
    if owner is not None:
        want["owner"], got["owner"] = (B,), owner
    if not tail:        # nothing of the tail is read
        for name in ("tail_pages", "tail_base", "q_pos", "owner"):
            got.pop(name, None)
    for name, t in got.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"por_epilogue: {name} shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if not tail:
        return
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
                 out: Optional[torch.Tensor] = None, tail: bool = True,
                 owner: Optional[torch.Tensor] = None, o_f32: bool = False,
                 out_m: Optional[torch.Tensor] = None,
                 out_l: Optional[torch.Tensor] = None):
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

    ``tail=False``: the segment reduction and the cast only, for a plan
    that already covers every page (the speculative verify step); the
    pools and the tail arrays are not read and may be ``None``, and a
    query with an empty segment comes out 0.

    The mesh's options: ``owner`` (B,) int64, where 0 marks a row whose
    tail page this shard does not hold (its tail partial is the POR
    identity and no tail slot is read); ``o_f32`` writes ``o`` (and takes
    ``out``) in float32 whatever q's type; ``out_m`` / ``out_l``: (B, h_q)
    float32 tensors that take ``m`` and ``l`` (both or neither; with
    ``stats`` they are the ones returned).
    """
    args = (q, o_parts, m_parts, l_parts, seg_offsets, seg_rows, k_pool,
            v_pool, tail_pages, tail_base, q_pos)
    _check_shapes(*args, tail=tail, owner=owner)
    if (out_m is None) != (out_l is None):
        raise ValueError("por_epilogue: give out_m and out_l together")
    for name, t in (("out_m", out_m), ("out_l", out_l)):
        if t is not None and tuple(t.shape) != tuple(q.shape[:2]):
            raise ValueError(f"por_epilogue: {name} shape "
                             f"{tuple(t.shape)}, expected "
                             f"{tuple(q.shape[:2])}")
    if q.device.type == "cpu":
        o, m, l = por_epilogue_torch(*args, window=window, tail=tail,
                                     owner=owner, o_f32=o_f32)
        if out is not None:
            out.copy_(o)
            o = out
        if out_m is not None:
            m, l = out_m.copy_(m), out_l.copy_(l)
        return (o, m, l) if stats else o
    if q.device.type != "cuda":
        raise ValueError(f"por_epilogue: no kernel for device {q.device}")
    dev = q.device
    f32, bf16, i32, i64 = (torch.float32, torch.bfloat16, torch.int32,
                           torch.int64)
    checks = [("q", q, (f32, bf16)), ("o_parts", o_parts, (f32,)),
              ("m_parts", m_parts, (f32,)), ("l_parts", l_parts, (f32,)),
              ("seg_offsets", seg_offsets, (i32,)),
              ("seg_rows", seg_rows, (i32,))]
    if tail:
        checks += [("k_pool", k_pool, (f32, bf16)),
                   ("v_pool", v_pool, (k_pool.dtype,)),
                   ("tail_pages", tail_pages, (i64,)),
                   ("tail_base", tail_base, (i64,)), ("q_pos", q_pos, (i64,))]
        if owner is not None:
            checks.append(("owner", owner, (i64,)))
    for name, t, dtypes in checks:
        _check(name, t, dev, dtypes)
    B, h_q, d = q.shape
    if tail:
        _, page, n_kv, _ = k_pool.shape
    else:       # only the head grouping matters: one KV head a block
        page, n_kv = 1, (k_pool.shape[2] if k_pool is not None else h_q)
    why = epilogue_refusal(d, page)
    if why is None and (n_kv < 1 or h_q % n_kv):
        why = f"h_q={h_q} is not a multiple of n_kv={n_kv}"
    if why is not None:
        raise ValueError(f"por_epilogue: {why}")
    out_dtype = f32 if o_f32 else q.dtype
    if out is None:
        out = torch.empty_like(q, dtype=out_dtype)
    _check("out", out, dev, (out_dtype,))
    if out.shape != q.shape:
        raise ValueError(f"por_epilogue: out shape {tuple(out.shape)}, "
                         f"expected {tuple(q.shape)}")
    for name, t in (("o_parts", o_parts), ("out", out)) + (
            (("k_pool", k_pool), ("v_pool", v_pool)) if tail else ()):
        if t.data_ptr() % 16:
            raise ValueError(f"por_epilogue: {name} must be 16-byte aligned "
                             f"(vector loads)")
    m, l = out_m, out_l
    if m is not None:
        _check("out_m", m, dev, (f32,))
        _check("out_l", l, dev, (f32,))
    elif stats:
        m = torch.empty(B, h_q, dtype=f32, device=dev)
        l = torch.empty(B, h_q, dtype=f32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def ptr(t):
        return t.data_ptr() if tail else None
    err = lib.codec_por_epilogue(
        q.data_ptr(), int(q.dtype == bf16), o_parts.data_ptr(),
        m_parts.data_ptr(), l_parts.data_ptr(), seg_offsets.data_ptr(),
        seg_rows.data_ptr(), ptr(k_pool), ptr(v_pool),
        int(tail and k_pool.dtype == bf16), ptr(tail_pages),
        ptr(tail_base), ptr(q_pos),
        None if owner is None or not tail else owner.data_ptr(),
        out.data_ptr(), int(o_f32),
        None if m is None else m.data_ptr(),
        None if l is None else l.data_ptr(),
        B, h_q, n_kv, d, page, int(window), int(tail), 1.0 / math.sqrt(d),
        stream)
    build.check(err, "codec_por_epilogue")
    global epilogue_launches
    epilogue_launches += 1
    return (out, m, l) if stats else out


# --------------------------------------------------------------------- #
# the cross-shard merge of the mesh: partials stacked (D, ...) over the
# data-shard axis
# --------------------------------------------------------------------- #
def exchange(x: torch.Tensor, shift: int) -> torch.Tensor:
    """One round's transfer: shard ``i`` receives shard ``i ^ shift``'s
    buffer (``repro``'s ``ppermute`` with the XOR permutation), for ``x``
    stacked over a leading shard axis of a power-of-two size.  The
    shards of a mesh share one device, so the transfer is a copy."""
    D = x.shape[0]
    pairs = x.reshape((D // (2 * shift), 2, shift) + tuple(x.shape[1:]))
    return pairs.flip(1).reshape(x.shape)


def _por_stacked(o1, m1, l1, o2, m2, l2, pairwise=por):
    """``pairwise`` (``por`` or ``por_ref``) over stacked partials: every
    leading axis folds into rows, so one launch merges every shard's
    rows."""
    h, d = o1.shape[-2:]

    def rows(t, *tail):
        return t.reshape((-1,) + tail).contiguous()
    o, m, l = pairwise(rows(o1, h, d), rows(m1, h), rows(l1, h),
                       rows(o2, h, d), rows(m2, h), rows(l2, h))
    return o.view(o1.shape), m.view(m1.shape), l.view(l1.shape)


def _check_axis(name: str, D: int) -> None:
    if D & (D - 1):
        raise ValueError(f"{name} needs a power-of-two shard axis, got {D}")


def por_allmerge(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All-reduce partials stacked ``(D, ...)`` over the shard axis with
    POR only (port of ``repro``'s ``por_allmerge``): ``log2 D``
    recursive-doubling rounds, each an ``exchange`` of ``o``, ``m`` and
    ``l`` and one pairwise merge, local partials first.  Afterwards every
    shard holds the full merge, alike in ``m`` and to one rounding in
    ``o`` / ``l`` (XOR partners merge in swapped order)."""
    D = o.shape[0]
    if D <= 1:
        return o, m, l
    _check_axis("por_allmerge", D)
    shift = 1
    while shift < D:
        o, m, l = _por_stacked(o, m, l, exchange(o, shift),
                               exchange(m, shift), exchange(l, shift))
        shift *= 2
    return o, m, l


def _pack(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    return torch.cat([o, m[..., None], l[..., None]], dim=-1)


def _unpack(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    return p[..., :-2], p[..., -2], p[..., -1]


def por_subgroup_merge(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                       contrib: torch.Tensor,
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sparse merge over the smallest aligned subgroup of contributing
    shards (port of ``repro``'s ``por_subgroup_merge``), on partials
    stacked ``(D, rows, ..., h, d)`` / ``(D, rows, ..., h)`` over the
    shard axis.

    ``contrib`` (D,) marks the shards that hold non-identity partials for
    these rows.  ``(o, m, l)`` travel as one packed ``(..., d + 2)``
    buffer, one ``exchange`` a round.  With the contributors inside an
    aligned block of ``2^k`` shards, the first ``k`` rounds merge (one
    ``por`` launch over every shard's rows) and the rest copy: the
    block's finished result is forwarded by a select, no arithmetic, so a
    single contributor's partials reach every shard bitwise unchanged.
    The round structure is chosen on the device (anchor = first
    contributor, ``xall`` = the OR-fold of ``id ^ anchor`` over the
    contributors; round ``s`` merges iff ``xall >= s``), so one captured
    step serves every contributor pattern.
    """
    return _subgroup_merge(o, m, l, contrib, por)


def _subgroup_merge(o, m, l, contrib, pairwise):
    """``por_subgroup_merge`` with its merge rounds on ``pairwise``."""
    D = o.shape[0]
    if D <= 1:
        return o, m, l
    _check_axis("por_subgroup_merge", D)
    c = contrib.to(torch.int64)
    ids = torch.arange(D, device=o.device)
    anchor = torch.argmax(c)             # first contributor (0 if none)
    xall = torch.where(c > 0, ids ^ anchor, 0).max()
    packed = _pack(o, m, l)
    bshape = (D,) + (1,) * (packed.dim() - 1)
    shift = 1
    while shift < D:
        recv = exchange(packed, shift)
        merged = _pack(*_por_stacked(*_unpack(packed), *_unpack(recv),
                                     pairwise=pairwise))
        # a copy round: the anchor's aligned block of ``shift`` shards
        # already holds the finished merge; its XOR partners take it
        have = ((ids // shift) == (anchor // shift)).view(bshape)
        copied = torch.where(have, packed, recv)
        packed = torch.where(xall >= shift, merged, copied)
        shift *= 2
    return _unpack(packed)


# --------------------------------------------------------------------- #
# the mesh step's merge of one layer: gather, butterfly, scatter, cast
# --------------------------------------------------------------------- #
def mesh_merge_torch(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     merge_gather: torch.Tensor, merge_scatter: torch.Tensor,
                     contrib: torch.Tensor, out_dtype: torch.dtype, *,
                     stats: bool = False):
    """``mesh_merge`` as plain torch ops, the mesh step's composition
    before the kernel existed: the rows ``merge_gather`` names go through
    ``por_subgroup_merge`` with its rounds on ``por_ref`` (on whatever
    device the tensors lie), shard 0's merged rows go back to the rows
    ``merge_scatter`` names (padding scatters to a spare row, dropped),
    then the cast."""
    D, M, B = o.shape[:3]
    o0, m0, l0 = o[0], m[0], l[0]
    if D > 1 and merge_gather.shape[0] > 0:
        gi = merge_gather
        merged = _subgroup_merge(o[:, :, gi], m[:, :, gi], l[:, :, gi],
                                 contrib, por_ref)

        def put(x, y):
            x = torch.cat([x, x.new_zeros((M, 1) + tuple(x.shape[2:]))], 1)
            x.index_copy_(1, merge_scatter, y[0])
            return x[:, :B]
        o0, m0, l0 = (put(x, y) for x, y in zip((o0, m0, l0), merged))
    o0 = o0.to(out_dtype)
    return (o0, m0, l0) if stats else o0


def _check_merge(o, m, l, merge_gather, merge_scatter, contrib) -> None:
    if o.dim() != 5:
        raise ValueError(f"mesh_merge: o shape {tuple(o.shape)}, expected "
                         f"(D, M, B, h, hd)")
    D, M, B, h, _ = o.shape
    Bm = merge_gather.shape[0]
    for name, t, shape in (("m", m, (D, M, B, h)), ("l", l, (D, M, B, h)),
                           ("merge_gather", merge_gather, (Bm,)),
                           ("merge_scatter", merge_scatter, (Bm,)),
                           ("contrib", contrib, (D,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"mesh_merge: {name} shape {tuple(t.shape)}, "
                             f"expected {shape}")
    _check_axis("mesh_merge", D)


def mesh_merge(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
               merge_gather: torch.Tensor, merge_scatter: torch.Tensor,
               contrib: torch.Tensor, out_dtype: torch.dtype, *,
               stats: bool = False):
    """The mesh step's cross-shard merge of one layer: shard 0's view.

    o: (D, M, B, h, hd) float32 and m / l: (D, M, B, h) float32, each data
    shard's stats-mode epilogue output for each model shard's heads;
    ``merge_gather`` / ``merge_scatter`` (Bm,) int64, the rows that span
    shards and where their result goes (gather padded with 0, scatter
    with B: a padded slot writes nothing); ``contrib`` (D,) int64, 1 for
    the shards that hold partials of those rows.  Returns (M, B, h, hd) in
    ``out_dtype`` (float32 or bfloat16): the rows ``merge_scatter`` names
    hold shard 0's result of ``por_subgroup_merge`` over the D shards,
    every other row is ``o[0]`` cast.  ``stats`` also returns shard 0's
    (M, B, h) ``m`` and ``l``.  CPU tensors take ``mesh_merge_torch``;
    CUDA tensors launch ``codec_mesh_merge`` once (or raise): nothing is
    read on the host, so it runs inside a captured graph, and the indices
    must lie below B (the kernel does not check them).
    """
    _check_merge(o, m, l, merge_gather, merge_scatter, contrib)
    if o.device.type == "cpu":
        return mesh_merge_torch(o, m, l, merge_gather, merge_scatter,
                                contrib, out_dtype, stats=stats)
    if o.device.type != "cuda":
        raise ValueError(f"mesh_merge: no kernel for device {o.device}")
    dev = o.device
    f32, i64 = torch.float32, torch.int64
    for name, t, dtype in (("o", o, f32), ("m", m, f32), ("l", l, f32),
                           ("merge_gather", merge_gather, i64),
                           ("merge_scatter", merge_scatter, i64),
                           ("contrib", contrib, i64)):
        if t.device != dev:
            raise ValueError(f"mesh_merge: {name} on {t.device}, expected "
                             f"{dev}")
        if t.dtype != dtype:
            raise TypeError(f"mesh_merge: {name} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mesh_merge: {name} must be contiguous")
    D, M, B, h, hd = o.shape
    why = merge_refusal(D, hd)
    if why is None and out_dtype not in (f32, torch.bfloat16):
        why = f"the kernel writes float32 or bfloat16, got {out_dtype}"
    if why is not None:
        raise ValueError(f"mesh_merge: {why}")
    if o.data_ptr() % 16:
        raise ValueError("mesh_merge: o must be 16-byte aligned (vector "
                         "loads)")
    out = torch.empty((M, B, h, hd), dtype=out_dtype, device=dev)
    om = ol = None
    if stats:
        om = torch.empty((M, B, h), dtype=f32, device=dev)
        ol = torch.empty((M, B, h), dtype=f32, device=dev)
    lib = build.load()
    err = lib.codec_mesh_merge(
        o.data_ptr(), m.data_ptr(), l.data_ptr(), merge_gather.data_ptr(),
        merge_scatter.data_ptr(), contrib.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16),
        None if om is None else om.data_ptr(),
        None if ol is None else ol.data_ptr(), D, M, B, h, hd,
        merge_gather.shape[0], torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "codec_mesh_merge")
    global mesh_merge_launches
    mesh_merge_launches += 1
    return (out, om, ol) if stats else out
