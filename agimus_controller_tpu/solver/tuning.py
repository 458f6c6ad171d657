"""Solver tuning knobs.

The Riccati backward/forward sweeps are sequential `lax.scan`s over the
horizon with tiny per-step bodies, so at B=1 their cost is per-step
overhead rather than FLOPs. `lax.scan(..., unroll=k)` is the direct lever,
plumbed here into the sqp/csqp batch sweeps via ``AGIMUS_SCAN_UNROLL``. The
default stays 1, which also keeps XLA:CPU test and dryrun compile budgets
flat; its effect on the GPU is not measured yet.
"""

from __future__ import annotations

import os


def scan_unroll(T: int | None = None) -> int:
    """Unroll factor for horizon scans (bounded by T when given)."""
    u = max(1, int(os.environ.get("AGIMUS_SCAN_UNROLL", "1")))
    if T is not None:
        u = min(u, max(1, int(T)))
    return u
