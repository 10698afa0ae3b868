"""The train step over a process mesh (``repro.launch.train``'s step on
its ``(data, model)`` mesh, one process a shard).

``repro`` jits one train step over a mesh of devices: each data shard
takes its rows of the global batch and XLA averages the gradient over
``data``; the model axis's specs are built and never applied, so the
state is replicated over ``model`` too.  The port runs one rank a shard
(``mesh.process_mesh``), and rank ``(d, m)``:

* computes the gradient of each of its ``microbatches`` slices of data
  shard ``d``'s rows (``trainer.make_micro_step``, the single
  controller's ``micro``);
* gathers every slice's gradient, loss, ``ce`` and ``moe_aux`` over its
  data group as slot gathers (``ProcessMesh.slot_gather``: each rank
  writes its slot of a zeroed ``(D, microbatches, n)`` buffer, the words
  are summed as ``int32``, so the bits arrive exactly), in buckets of at
  most ``BUCKET_BYTES`` a buffer;
* sums the ``D * microbatches`` contributions in shard order, then slice
  order, into float32 zeros and scales by ``1 / (D * microbatches)``:
  the order in which the single controller (``launch/train.py --data
  D``, the shards run in turn as microbatches) sums them, so the result
  is the single controller's bit for bit, at any ``microbatches``.  At
  ``D * microbatches == 1`` the gradient stays in the weights' dtype, as
  the trainer's does, and still goes through the gather;
* clips and updates (``trainer.apply_update``) on identical inputs, so
  weights and optimizer state stay bitwise alike on every rank;
* checks with every rank that the step's metrics agree
  (``ProcessMesh.agree``: ``MeshDivergenceError`` otherwise).

The M ranks of a data shard compute the same step, as ``repro``'s
replicated state does.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..training import trainer
from ..training.optimizer import Optimizer
from .mesh import ProcessMesh, digest

_F32 = torch.float32
# bytes of one bucket's gather buffer, all its D x microbatches slots
BUCKET_BYTES = 256 << 20
METRICS = ("loss", "ce", "moe_aux")

# (name, lo, hi, offset): elements [lo, hi) of a flattened leaf at
# ``offset`` in its bucket
Segment = Tuple[str, int, int, int]


def buckets(params: Dict[str, torch.Tensor], slots: int,
            bucket_bytes: int = BUCKET_BYTES
            ) -> List[Tuple[torch.dtype, int, List[Segment]]]:
    """The gather's buckets over ``params`` (by state-dict order, one
    dtype a bucket): ``(dtype, elements a slot, segments)``; a leaf
    larger than a bucket is cut across several.  A slot's elements are a
    whole number of 32-bit words."""
    out = []
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for k, p in params.items():
        by_dtype.setdefault(p.dtype, []).append(k)
    for dtype, names in by_dtype.items():
        size = torch.empty((), dtype=dtype).element_size()
        word = max(1, 4 // size)
        cap = max(word, bucket_bytes // (slots * size) // word * word)
        segs: List[Segment] = []
        fill = 0
        for k in names:
            n, lo = params[k].numel(), 0
            while lo < n:
                take = min(n - lo, cap - fill)
                segs.append((k, lo, lo + take, fill))
                lo += take
                fill += take
                if fill == cap:
                    out.append((dtype, cap, segs))
                    segs, fill = [], 0
        if segs:
            out.append((dtype, -(-fill // word) * word, segs))
    return out


def make_rank_train_step(cfg, optimizer: Optimizer, mesh: ProcessMesh, *,
                         microbatches: int = 1, remat: bool = True,
                         clip_norm: float = 1.0, aux_weight: float = 0.01,
                         ce_impl: str = "gather") -> Callable:
    """``train_step(state, (tokens, labels)) -> (state, metrics)`` on
    this rank's rows (data shard ``d``'s of the global batch), as
    ``trainer.make_train_step(microbatches=D * microbatches)`` on the
    whole global batch."""
    micro = trainer.make_micro_step(cfg, aux_weight=aux_weight, remat=remat,
                                    ce_impl=ce_impl)
    D = mesh.shape["data"]
    me = mesh.slot("data")
    n = D * microbatches

    def train_step(state: trainer.TrainState, batch):
        tokens, labels = batch
        B = tokens.shape[0]
        assert B % microbatches == 0, (B, microbatches)
        mb = B // microbatches
        dev = tokens.device
        mets = torch.zeros((D, microbatches, len(METRICS)), dtype=_F32,
                           device=dev)
        grads, dtypes = [], None
        for j in range(microbatches):
            sl = slice(j * mb, (j + 1) * mb)
            loss, met, g = micro(state, tokens[sl], labels[sl])
            vals = (loss, met["ce"], met["moe_aux"])
            dtypes = [v.dtype for v in vals]
            mets[me, j] = torch.stack([v.to(_F32) for v in vals])
            grads.append(g)
        mesh.slot_gather(mets, "data")
        if n == 1:
            # the trainer's one-microbatch step: weight-dtype gradient,
            # gathered back into the rank's own tensors
            vals = [mets[0, 0, i].to(dt) for i, dt in enumerate(dtypes)]
            total = grads[0]
        else:
            vals = [torch.zeros((), dtype=_F32, device=dev)
                    for _ in METRICS]
            for s in range(D):
                for j in range(microbatches):
                    vals = [v + mets[s, j, i] for i, v in enumerate(vals)]
            inv = 1.0 / n
            vals = [v * inv for v in vals]
            total = {k: torch.zeros(p.shape, dtype=_F32, device=p.device)
                     for k, p in state.params.items()}
        _gather_grads(mesh, grads, total, n == 1, BUCKET_BYTES)
        if n > 1:
            for g in total.values():
                g.mul_(1.0 / n)
        del grads
        gnorm = trainer.apply_update(state, total, optimizer, clip_norm)
        metrics = dict(zip(METRICS, vals), grad_norm=gnorm)
        mesh.agree(digest(torch.stack(
            [metrics[k].to(_F32) for k in METRICS + ("grad_norm",)]
        ).cpu().numpy().tobytes()), "the step's metrics")
        return state, metrics

    return train_step


@torch.no_grad()
def _gather_grads(mesh: ProcessMesh, grads: List[Dict[str, torch.Tensor]],
                  total: Dict[str, torch.Tensor], in_place: bool,
                  bucket_bytes: int) -> None:
    """Gather each microbatch's gradient over the data group, bucket by
    bucket, and sum the contributions into ``total`` in shard order,
    then microbatch order (``in_place``: one contribution, copied back
    into ``total``, which is ``grads[0]``).  One buffer a dtype serves
    every bucket of it; a bucket is filled by one ``cat`` a microbatch
    and read back by one ``_foreach`` launch a contribution.  A rank's
    own leaves are dropped once their last segment is in a buffer."""
    D = mesh.shape["data"]
    me = mesh.slot("data")
    slots = D * len(grads)
    for g in grads:
        for k, v in g.items():
            if not v.is_contiguous():   # an autograd view: flat copies
                g[k] = v.contiguous()
    left: Dict[str, int] = {}
    plan = buckets(grads[0], slots, bucket_bytes)
    need: Dict[torch.dtype, int] = {}
    for dtype, size, segs in plan:
        need[dtype] = max(need.get(dtype, 0), slots * size)
        for k, _, _, _ in segs:
            left[k] = left.get(k, 0) + 1
    dev = next(iter(total.values())).device
    flat = {dt: torch.empty(n, dtype=dt, device=dev)
            for dt, n in need.items()}
    for dtype, size, segs in plan:
        buf = flat[dtype][:slots * size].view(D, len(grads), size)
        buf.zero_()
        n = segs[-1][3] + segs[-1][2] - segs[-1][1]
        lengths = [hi - lo for _, lo, hi, _ in segs]
        for j, g in enumerate(grads):
            torch.cat([g[k].view(-1)[lo:hi] for k, lo, hi, _ in segs],
                      out=buf[me, j, :n])
        for k, _, _, _ in segs:
            left[k] -= 1
            if not left[k] and not in_place:
                for g in grads:
                    del g[k]
        mesh.slot_gather(buf, "data")
        dsts = [total[k].view(-1)[lo:hi] for k, lo, hi, _ in segs]
        if in_place:
            torch._foreach_copy_(dsts, list(buf[0, 0, :n].split(lengths)))
            continue
        for s in range(D):
            for j in range(len(grads)):
                torch._foreach_add_(dsts,
                                    list(buf[s, j, :n].split(lengths)))
