"""What the host did in the window, beside the metrics: the readings that
tell one run's speed from another's.  The result line carries them under
``host``; no metric and no bound reads them.

* ``loop``: the window split into the engine's steps (``step_s``, the
  decode steps with their flushes and callbacks) and the clients'
  ``add_request`` calls (``submit_s``, each a prefill on the host);
* ``proc_cpu_s``: this process's CPU seconds in the window
  (``getrusage``);
* ``gc_s``, ``gc_collections``, ``gc_gen2``: the garbage collector's pauses
  in the window (``gc.callbacks``);
* ``python_loop_s``: after the window, the best of three timings of one
  fixed pure-Python loop: the interpreter's speed in this process.
"""

from __future__ import annotations

import gc
import resource
import time


def python_loop_s() -> float:
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        x = 0
        for i in range(1_000_000):
            x += i * i % 7
        best = min(best, time.perf_counter() - t)
    return best


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


class Probe:
    def __init__(self):
        self.gc_s = 0.0
        self.gc_n = 0
        self.gc_gen2 = 0
        self._t_gc = None

    def _gc(self, phase, info):
        if phase == "start":
            self._t_gc = time.perf_counter()
        elif self._t_gc is not None:
            self.gc_s += time.perf_counter() - self._t_gc
            self.gc_n += 1
            self.gc_gen2 += info["generation"] == 2

    def open(self) -> None:
        self.t0 = time.perf_counter()
        self.cpu0 = _cpu_s()
        gc.callbacks.append(self._gc)

    def close(self, loop_split: dict) -> dict:
        gc.callbacks.remove(self._gc)
        return {"window_s": time.perf_counter() - self.t0,
                "loop": dict(loop_split),
                "proc_cpu_s": _cpu_s() - self.cpu0,
                "gc_s": self.gc_s, "gc_collections": self.gc_n,
                "gc_gen2": self.gc_gen2, "python_loop_s": python_loop_s()}
