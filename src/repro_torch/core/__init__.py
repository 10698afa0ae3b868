"""Host-side CoDec planning: prefix forest, cost model, scheduler, plans.

Framework-free (numpy only); the port's own copies of ``repro.core``.
"""
