"""Deterministic fault injection for the serving engine (port of
``repro.serving.faults``; ``repro``'s DESIGN.md §12).

The engine cannot be hardened against failures that cannot be
reproduced, so every fault the serving stack is expected to survive is
modelled as a :class:`FaultSpec` that a :class:`FaultInjector` delivers
through a *narrow seam* in the engine:

* ``alloc``      — the page allocator reports exhaustion even though the
                   free list is non-empty (``_alloc_pages`` returns
                   ``None``), exercising the stall / preempt /
                   mid-step-recovery paths;
* ``dispatch``   — the decode dispatch raises a simulated device
                   out-of-memory (:class:`ResourceExhausted`),
                   exercising the degradation ladder + bounded retry;
* ``nan_logits`` — one request's logits turn NaN (eager: the row is
                   overwritten on the way to the sampler; fused: a KV
                   slot of the request's private leaf is corrupted so
                   the step's own attention produces NaNs), exercising
                   the per-row NaN guard and quarantine;
* ``callback``   — the user's ``on_token`` callback raises, exercising
                   callback isolation;
* ``stall``      — the dispatch sleeps ``payload`` seconds first,
                   emulating a slow device/shard (visible as an outlier
                   in the step's wall time; streams are unaffected).

A :class:`FaultPlan` is an immutable schedule of specs — hand-written
in tests, parsed from a CLI string (``--inject``), or generated from a
seed (:meth:`FaultPlan.seeded`) so chaos runs are reproducible
byte-for-byte.  The injector consumes specs at most ``times`` each and
counts every firing in ``fired``; a seam that cannot apply a fault yet
(e.g. the target request is not running) puts the spec back with
:meth:`FaultInjector.requeue`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "KINDS", "FaultSpec", "FaultPlan", "FaultInjector",
    "InjectedFault", "ResourceExhausted", "EngineInvariantError",
]

# every seam the engine exposes, in a fixed order so seeded plans are
# stable across python versions
KINDS: Tuple[str, ...] = (
    "alloc", "dispatch", "nan_logits", "callback", "stall")


class InjectedFault(RuntimeError):
    """Raised by a seam to stand in for a real failure (callback bugs,
    device errors).  Carries the spec so handlers can attribute it."""

    def __init__(self, spec: "FaultSpec", msg: Optional[str] = None):
        super().__init__(msg or f"injected fault {spec.kind!r} "
                                f"(step {spec.step}, rid {spec.rid})")
        self.spec = spec


class ResourceExhausted(RuntimeError):
    """Simulated device-memory exhaustion at the decode dispatch.
    Backends/dispatch wrappers may also raise this directly for
    *recoverable* OOM conditions; the engine's degradation ladder catches
    it."""


class EngineInvariantError(RuntimeError):
    """A serving-time self-check (``DecodeEngine.check``) failed.

    ``failures`` lists every violated invariant, not just the first, so
    one chaos run diagnoses all the damage at once."""

    def __init__(self, failures: Sequence[str]):
        self.failures = list(failures)
        super().__init__(
            "engine invariants violated:\n  - " + "\n  - ".join(failures))


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.

    ``step`` is the earliest engine step the fault may fire at (it fires
    at the first matching seam visit at or after it); ``rid`` targets a
    specific request (``None`` = first eligible); ``times`` lets one
    spec fire repeatedly (e.g. fail a dispatch twice so the ladder must
    walk two rungs); ``payload`` is kind-specific (stall seconds).
    """

    kind: str
    step: int
    rid: Optional[int] = None
    times: int = 1
    payload: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.times < 1:
            raise ValueError("times must be >= 1")


class FaultPlan:
    """Immutable, ordered schedule of :class:`FaultSpec`."""

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: Tuple[FaultSpec, ...] = tuple(
            sorted(specs, key=lambda s: (s.step, KINDS.index(s.kind),
                                         -1 if s.rid is None else s.rid)))

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.specs)!r})"

    @classmethod
    def seeded(cls, seed: int, steps: int = 48, rate: float = 0.08,
               kinds: Sequence[str] = KINDS,
               rids: Optional[Sequence[int]] = None,
               stall_s: float = 0.002) -> "FaultPlan":
        """Reproducible random schedule: each step draws each kind with
        probability ``rate``; row-targeted kinds pick a rid from
        ``rids`` (when given) so the chaos harness knows exactly which
        requests a schedule may corrupt."""
        rng = np.random.default_rng(seed)
        specs: List[FaultSpec] = []
        for step in range(steps):
            for kind in kinds:
                if rng.random() >= rate:
                    continue
                rid = None
                if kind in ("nan_logits", "callback") and rids:
                    rid = int(rng.choice(np.asarray(rids)))
                specs.append(FaultSpec(
                    kind, step, rid=rid,
                    payload=stall_s if kind == "stall" else 0.0))
        return cls(specs)

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """Parse a CLI schedule.

        Grammar (comma-separated)::

            kind@step              one firing at/after ``step``
            kind@step:rid          targeted at request ``rid``
            kind@step*times        fire up to ``times`` times
            kind@step=payload      kind-specific payload (stall seconds)
            seed:SEED[:RATE]       a whole FaultPlan.seeded schedule

        e.g. ``--inject dispatch@3*2,nan_logits@5:0,stall@8=0.01``.
        """
        text = text.strip()
        if not text:
            return cls()
        if text.startswith("seed:"):
            parts = text.split(":")
            seed = int(parts[1])
            rate = float(parts[2]) if len(parts) > 2 else 0.08
            return cls.seeded(seed, rate=rate)
        specs = []
        for item in text.split(","):
            item = item.strip()
            if not item:
                continue
            payload = 0.0
            if "=" in item:
                item, pay = item.split("=", 1)
                payload = float(pay)
            times = 1
            if "*" in item:
                item, t = item.split("*", 1)
                times = int(t)
            kind, _, at = item.partition("@")
            if not at:
                raise ValueError(f"fault spec {item!r} needs kind@step")
            step, _, rid = at.partition(":")
            specs.append(FaultSpec(kind.strip(), int(step),
                                   rid=int(rid) if rid else None,
                                   times=times, payload=payload))
        return cls(specs)


class FaultInjector:
    """Consumes a :class:`FaultPlan` at the engine's seams.

    The engine calls :meth:`tick` once per step and each seam calls
    :meth:`take` at its decision point; a spec fires at the first
    eligible visit at/after its step.  All state is host-side and
    deterministic given the plan and the engine's (deterministic) seam
    visit order.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.step = 0
        # mutable remaining-firings per spec, in plan order
        self._armed: List[List] = [[s, s.times] for s in plan.specs]
        self.fired: Dict[str, int] = {k: 0 for k in KINDS}

    def tick(self, step: int) -> None:
        self.step = step

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def pending(self) -> int:
        """Firings still scheduled (chaos harness quiescence check)."""
        return sum(n for _, n in self._armed)

    def take(self, kind: str,
             rid: Optional[int] = None) -> Optional[FaultSpec]:
        """Consume one firing of the first eligible spec, else None."""
        for ent in self._armed:
            spec, left = ent
            if (spec.kind != kind or spec.step > self.step or left <= 0):
                continue
            if spec.rid is not None and rid is not None \
                    and spec.rid != rid:
                continue
            ent[1] -= 1
            if ent[1] == 0:
                self._armed.remove(ent)
            self.fired[kind] += 1
            return spec
        return None

    def requeue(self, spec: FaultSpec) -> None:
        """Put back a firing a seam could not apply yet (e.g. the target
        request is not in the running batch this step)."""
        self.fired[spec.kind] -= 1
        for ent in self._armed:
            if ent[0] is spec:
                ent[1] += 1
                return
        self._armed.append([spec, 1])
