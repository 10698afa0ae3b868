"""Profile-based PAC cost estimator (paper §5.2) for the H100.

The paper shows (Table 2) that PAC execution time is neither pure-IO nor
pure-compute: small tasks are launch-bound, long-thin tasks memory-bound,
fat tasks compute-bound.  It therefore profiles ``C_est(n_q, n)`` on the
target GPU and interpolates.  Two sources, as in ``repro.core.cost_model``:

* an **analytic roofline model** from the H100 SXM datasheet (989 TFLOP/s
  dense bf16, 3.35 TB/s HBM3) plus a per-step overhead — the default;
* an optional **profiled table** measured by ``profile()`` with bilinear
  interpolation in (log2 n_q, log2 n), the paper's scheme.

The mesh's terms (``merge_cost``, ``replicate_gain``) charge the
cross-shard POR merge at ``HardwareSpec.ici_bw``, and ``fit`` refits the
coefficients from measured mesh steps (``DecodeEngine.recalibrate``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM datasheet figures (dense, no sparsity).
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
HBM_BW = 3.35e12                  # B/s
# NVLink 4 between H100 SXM cards: 900 GB/s all to all, 450 GB/s each way
ICI_BW = 450e9                    # B/s


@dataclasses.dataclass
class HardwareSpec:
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    # Uncalibrated: the NVLink datasheet figure as the merge's wire rate
    # (the mesh's shards share one card today, so no link has been
    # measured), and no per-step or per-launch overhead of the CUDA
    # kernels, so the analytic model charges none (``CostModel.calibrated``
    # stays False until a table is profiled or ``fit`` installs a fit).
    ici_bw: float = ICI_BW
    grid_step_overhead: float = 0.0
    launch_overhead: float = 0.0


class CostModel:
    """``C_est(n_q, n)`` — estimated seconds for one PAC task.

    ``n_q`` is the number of *queries* (requests) in the task, ``n`` the KV
    length of the (possibly divided) node slice.  Head count / head dim /
    dtype are fixed per model, supplied at construction (the paper likewise
    profiles per model).
    """

    def __init__(self, n_q_heads: int, n_kv_heads: int, head_dim: int,
                 bytes_per: int = 2, page_size: int = 64,
                 hw: Optional[HardwareSpec] = None,
                 table: Optional[Dict[Tuple[int, int], float]] = None):
        self.h_q = int(n_q_heads)
        self.h_kv = int(n_kv_heads)
        self.d = int(head_dim)
        self.bytes_per = int(bytes_per)
        self.page_size = int(page_size)
        self.hw = hw or HardwareSpec()
        self._table = dict(table) if table else None
        self.calibrated = self._table is not None
        self._grid: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None
        if self._table:
            self._build_grid()

    # ------------------------------------------------------------------ #
    # analytic roofline term
    # ------------------------------------------------------------------ #
    def flops(self, n_q: int, n: int) -> float:
        # QK^T and PV, over all query heads.
        return 2.0 * 2.0 * n_q * self.h_q * n * self.d

    def hbm_bytes(self, n_q: int, n: int) -> float:
        kv = 2.0 * n * self.h_kv * self.d * self.bytes_per
        q = n_q * self.h_q * self.d * self.bytes_per
        o = n_q * self.h_q * self.d * 4  # f32 partials + m/l (negligible)
        return kv + q + o

    def analytic(self, n_q: int, n: int) -> float:
        t_flop = self.flops(n_q, n) / self.hw.peak_flops
        t_mem = self.hbm_bytes(n_q, n) / self.hw.hbm_bw
        steps = max(1, -(-int(n) // self.page_size))
        return max(t_flop, t_mem) + steps * self.hw.grid_step_overhead

    # ------------------------------------------------------------------ #
    # profiled table + bilinear interpolation (paper's estimator)
    # ------------------------------------------------------------------ #
    def _build_grid(self) -> None:
        nqs = np.array(sorted({k[0] for k in self._table}), dtype=np.float64)
        ns = np.array(sorted({k[1] for k in self._table}), dtype=np.float64)
        vals = np.full((len(nqs), len(ns)), np.nan)
        for (nq, n), v in self._table.items():
            vals[np.searchsorted(nqs, nq), np.searchsorted(ns, n)] = v
        # fill holes with analytic model so interpolation is total
        for i, nq in enumerate(nqs):
            for j, n in enumerate(ns):
                if np.isnan(vals[i, j]):
                    vals[i, j] = self.analytic(int(nq), int(n))
        self._grid = (np.log2(nqs), np.log2(ns), vals)

    @staticmethod
    def _axis_cell(axis: np.ndarray, x: float) -> Tuple[int, int, float]:
        """Clamped 1-D interpolation cell ``(lo, hi, t)`` on a log2 axis
        (a single-valued axis degrades to nearest)."""
        if len(axis) == 1:
            return 0, 0, 0.0
        lo = int(np.clip(np.searchsorted(axis, x) - 1, 0, len(axis) - 2))
        hi = lo + 1
        t = float(np.clip((x - axis[lo]) / (axis[hi] - axis[lo]), 0.0, 1.0))
        return lo, hi, t

    def _interp(self, n_q: int, n: int) -> float:
        lnq, ln, vals = self._grid
        x, y = np.log2(max(n_q, 1)), np.log2(max(n, 1))
        i, i2, tx = self._axis_cell(lnq, x)
        j, j2, ty = self._axis_cell(ln, y)
        v = (vals[i, j] * (1 - tx) * (1 - ty) + vals[i2, j] * tx * (1 - ty)
             + vals[i, j2] * (1 - tx) * ty + vals[i2, j2] * tx * ty)
        return float(v)

    # ------------------------------------------------------------------ #
    def __call__(self, n_q: int, n: int) -> float:
        if n <= 0 or n_q <= 0:
            return 0.0
        if self._grid is not None:
            return self._interp(n_q, n)
        return self.analytic(n_q, n)

    # ------------------------------------------------------------------ #
    # cross-shard merge term (the mesh's POR butterfly)
    # ------------------------------------------------------------------ #
    def merge_cost(self, n_splits: int, n_q: int) -> float:
        """Estimated seconds to POR-merge ``n_splits`` sequence-split
        partials of ``n_q`` queries across shards.

        The merge (``kernels.por.por_subgroup_merge``) packs the ``(o, m,
        l)`` partials of the ``n_q`` rows that span shards into one
        ``(n_q, h_q, d + 2)`` float32 buffer and runs ``ceil(log2
        n_splits)`` rounds of one exchange each: one launch and one wire
        move a round.  Rows whose KV is replicated are packed out and cost
        nothing (``n_q == 0`` skips the merge).  The scheduler charges
        this once a step on top of the slowest shard.
        """
        if n_splits <= 1 or n_q <= 0:
            return 0.0
        rounds = int(np.ceil(np.log2(n_splits)))
        wire = n_q * self.h_q * (self.d + 2) * 4  # packed f32 o/m/l buffer
        return rounds * (wire / self.hw.ici_bw + self.hw.launch_overhead)

    def replicate_gain(self, n_q: int, n: int, num_shards: int) -> float:
        """Per-step seconds saved by replicating a node on every shard
        instead of sequence-splitting it across ``num_shards``: the merge
        its rows no longer pay, less the ``(D-1)/D`` of the node's cost
        that each shard then reads on top.  Positive: replicate (short hot
        prefixes); negative: split (long documents).  Callers still gate
        on free pages: this is a time trade, not a memory one."""
        if num_shards <= 1:
            return 0.0
        extra = self(n_q, n) * (num_shards - 1) / num_shards
        return self.merge_cost(num_shards, n_q) - extra

    def fit(self, samples: Sequence[Dict[str, float]],
            min_samples: int = 8) -> bool:
        """Refit the hardware coefficients from measured step timings.

        ``samples`` are per-step feature dicts (``hbm_bytes``,
        ``grid_steps``, ``merge_bytes``, ``merge_rounds``, ``seconds``) as
        the engine's ``step_stats`` record them.  Solves the least squares
        ``seconds ~= hbm_bytes/bw + grid_steps*step_ovh +
        merge_bytes/ici_bw + merge_rounds*launch + const`` with the
        coefficients clipped at zero, and installs the fitted
        :class:`HardwareSpec`.  A column that varies by less than 30% of
        its largest value is collinear with the constant, so its
        coefficient keeps the current value.  Returns True when a fit was
        installed.
        """
        rows = [s for s in samples
                if s.get("seconds", 0.0) > 0.0 and s.get("hbm_bytes", 0) > 0]
        if len(rows) < min_samples:
            return False
        feats = ["hbm_bytes", "grid_steps", "merge_bytes", "merge_rounds"]
        A = np.array([[float(s.get(f, 0.0)) for f in feats] + [1.0]
                      for s in rows])
        b = np.array([float(s["seconds"]) for s in rows])
        # normalise columns so lstsq conditioning survives byte counts
        scale = np.maximum(np.abs(A).max(axis=0), 1e-30)
        coef, *_ = np.linalg.lstsq(A / scale, b, rcond=None)
        coef = np.maximum(coef / scale, 0.0)
        hw = self.hw
        varies = (np.abs(A - A.mean(axis=0)).max(axis=0)
                  > 0.3 * np.maximum(np.abs(A).max(axis=0), 1e-30))
        self.hw = HardwareSpec(
            peak_flops=hw.peak_flops,
            hbm_bw=(1.0 / coef[0] if varies[0] and coef[0] > 0
                    else hw.hbm_bw),
            ici_bw=(1.0 / coef[2] if varies[2] and coef[2] > 0
                    else hw.ici_bw),
            grid_step_overhead=(float(coef[1]) if varies[1]
                                else hw.grid_step_overhead),
            launch_overhead=(float(coef[3]) if varies[3] and coef[3] > 0
                             else hw.launch_overhead))
        self.calibrated = True
        return True

    def bound(self, n_q: int, n: int) -> str:
        """Whether a task is ``"compute"``- or ``"memory"``-bound under the
        analytic model."""
        t_flop = self.flops(n_q, n) / self.hw.peak_flops
        t_mem = self.hbm_bytes(n_q, n) / self.hw.hbm_bw
        return "compute" if t_flop > t_mem else "memory"


def profile(cost_model: CostModel,
            runner: Callable[[int, int], None],
            n_qs=(1, 2, 4, 8, 16, 32, 64),
            ns=(512, 1024, 2048, 4096, 8192, 16384),
            repeats: int = 3) -> CostModel:
    """Measure ``runner(n_q, n)`` wall time and return a table-backed model.

    ``runner`` must execute one PAC of the given shape and block until
    complete (e.g. end with ``torch.cuda.synchronize()``).
    """
    table: Dict[Tuple[int, int], float] = {}
    for nq in n_qs:
        for n in ns:
            runner(nq, n)  # warmup / build
            t0 = time.perf_counter()
            for _ in range(repeats):
                runner(nq, n)
            table[(nq, n)] = (time.perf_counter() - t0) / repeats
    return CostModel(cost_model.h_q, cost_model.h_kv, cost_model.d,
                     cost_model.bytes_per, cost_model.page_size,
                     cost_model.hw, table)
