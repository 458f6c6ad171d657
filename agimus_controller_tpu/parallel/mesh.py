"""Mesh construction and sharded batch solving.

Design (SURVEY.md §2c / §5): scenarios are data-parallel over the mesh's
``batch`` axis, within one host or across hosts; every solve is independent
so the only collectives are those XLA inserts for the sharded batch.
Horizon-parallel Riccati (sequence-parallel analog) layers on later via
associative scan — the solver itself is already pure and shardable.
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ocp.costs import CostFunctions
from ..solver.fddp import SolverSettings, Solution, solve_fddp


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "batch") -> Mesh:
    devices = jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.asarray(devices[:n]).reshape(n), (axis_name,))


def make_batch_solver(cf: CostFunctions, settings: SolverSettings):
    """vmapped + jitted multi-scenario solver.

    Batched axes: x0 [B,nx], xs [B,T+1,nx], us [B,T,nu]. The refs dict is
    shared across scenarios (axis None) — per-scenario refs can be threaded
    by passing batched arrays and switching in_axes at call site.
    """
    batched = jax.vmap(
        lambda x0, refs, xs, us: solve_fddp(cf, x0, refs, xs, us, settings),
        in_axes=(0, None, 0, 0),
    )
    return jax.jit(batched)


def batch_solve(cf, settings, x0s, refs, xs0, us0) -> Solution:
    return make_batch_solver(cf, settings)(x0s, refs, xs0, us0)


def sharded_batch_solver(
    cf: CostFunctions,
    settings: SolverSettings,
    mesh: Mesh,
    axis_name: str = "batch",
):
    """Batch solver with scenarios sharded over the mesh.

    Uses NamedSharding constraints on a jitted vmapped solve: XLA partitions
    the embarrassingly-parallel batch across devices (solves never
    communicate; the partitioner keeps every per-scenario op local)."""
    spec_b = NamedSharding(mesh, P(axis_name))
    spec_r = NamedSharding(mesh, P())

    batched = jax.vmap(
        lambda x0, refs, xs, us: solve_fddp(cf, x0, refs, xs, us, settings),
        in_axes=(0, None, 0, 0),
    )

    def solve(x0s, refs, xs0, us0):
        x0s = jax.lax.with_sharding_constraint(x0s, spec_b)
        xs0 = jax.lax.with_sharding_constraint(xs0, spec_b)
        us0 = jax.lax.with_sharding_constraint(us0, spec_b)
        refs = {k: jax.lax.with_sharding_constraint(v, spec_r) for k, v in refs.items()}
        return batched(x0s, refs, xs0, us0)

    return jax.jit(solve)


def shard_batch(mesh: Mesh, arrays, axis_name: str = "batch"):
    """Place host arrays onto the mesh sharded along the leading axis."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, sharding), arrays)


def sharded_batch_csqp(model, params, spec, cf, settings, mesh: Mesh,
                       axis_name: str = "batch"):
    """Batch-native constrained CSQP sharded over the mesh (same layout as
    `sharded_batch_fddp`; the ADMM while_loop's all-done reduction is the
    only cross-scenario collective, a cheap scalar `psum`-style AND)."""
    from ..solver.csqp_batch import make_batch_csqp

    solve = make_batch_csqp(model, params, spec, cf, settings)
    spec_b = NamedSharding(mesh, P(axis_name))
    spec_r = NamedSharding(mesh, P())

    def sharded(x0s, refs, xs0, us0):
        x0s = jax.lax.with_sharding_constraint(x0s, spec_b)
        xs0 = jax.lax.with_sharding_constraint(xs0, spec_b)
        us0 = jax.lax.with_sharding_constraint(us0, spec_b)
        refs = {k: jax.lax.with_sharding_constraint(v, spec_r) for k, v in refs.items()}
        return solve(x0s, refs, xs0, us0)

    return jax.jit(sharded)


def sharded_batch_sqp(model, params, spec, cf, settings, mesh: Mesh,
                      axis_name: str = "batch"):
    """The latency solver (multiple-shooting SQP/CSQP, `solver/sqp_batch.py`)
    sharded over the mesh. Constrained specs get the full ADMM treatment;
    scenarios are data-parallel so collectives stay on the scalar
    convergence reductions."""
    from ..solver.sqp_batch import make_batch_sqp

    solve = make_batch_sqp(model, params, spec, cf, settings)
    spec_b = NamedSharding(mesh, P(axis_name))
    spec_r = NamedSharding(mesh, P())

    def sharded(x0s, refs, xs0, us0):
        x0s = jax.lax.with_sharding_constraint(x0s, spec_b)
        xs0 = jax.lax.with_sharding_constraint(xs0, spec_b)
        us0 = jax.lax.with_sharding_constraint(us0, spec_b)
        refs = {k: jax.lax.with_sharding_constraint(v, spec_r) for k, v in refs.items()}
        return solve(x0s, refs, xs0, us0)

    return jax.jit(sharded)


def sharded_batch_fddp(model, params, spec, cf, settings, mesh: Mesh,
                       axis_name: str = "batch", riccati: str = "component"):
    """Batch-native FDDP sharded over the mesh: the scenario axis is data
    parallel across devices (within one host or across hosts); solves are
    independent so XLA keeps every per-scenario op local — linear scaling.
    ``riccati="pscan"`` selects the horizon-parallel associative-scan
    backward sweep (the sequence-parallel analog, SURVEY.md §5)."""
    from ..solver.fddp_batch import make_batch_fddp

    solve = make_batch_fddp(model, params, spec, cf, settings, riccati=riccati)
    spec_b = NamedSharding(mesh, P(axis_name))
    spec_r = NamedSharding(mesh, P())

    def sharded(x0s, refs, xs0, us0):
        x0s = jax.lax.with_sharding_constraint(x0s, spec_b)
        xs0 = jax.lax.with_sharding_constraint(xs0, spec_b)
        us0 = jax.lax.with_sharding_constraint(us0, spec_b)
        refs = {k: jax.lax.with_sharding_constraint(v, spec_r) for k, v in refs.items()}
        return solve(x0s, refs, xs0, us0)

    return jax.jit(sharded)
