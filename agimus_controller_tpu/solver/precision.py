"""Matrix-product precision of the solvers.

On a GPU with tensor cores an f32 matrix product may run in TF32, which
keeps about three decimal digits, unless a precision is asked for. The
Riccati, ADMM and line-search recursions are full of small f32 products
whose rounding sets the KKT level the solvers can reach, so every solver
entry traces its products at HIGHEST precision.
"""

from __future__ import annotations

import functools

import jax


def highest_precision(fn):
    """Wrap ``fn`` so that everything it traces uses HIGHEST matmul
    precision (a trace-time setting: it lands in each `dot_general`)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped
