"""Cross-chip horizon-sharded Riccati: the T axis over a device mesh.

`riccati_pscan.parallel_riccati` parallelizes the backward sweep *within one
device program*.  This module shards the horizon itself over a
`jax.sharding.Mesh` with `shard_map` — the design SURVEY.md §5
("long-context") calls for: blocked scans with the Riccati block interfaces
reduced via device collectives (cf. PAPERS.md, "The Parallelization of Riccati
Recursion"; the reference's mim_solvers runs the same recursion sequentially
in C++ on one CPU).

Two-level scheme, exact (no approximation):

1. **Within block** — each device holds a contiguous horizon block of
   Tb = T / n_dev stages, builds its conditional-value elements and runs the
   in-device `associative_scan` suffix composition: `S_t` = composition of
   local stages t..Tb-1.  Its full-block composite is `S_0`.
2. **Across blocks** — ONE `all_gather` over the mesh axis moves the n_dev
   block composites (a few kB) to every device; the cross-block suffix
   recursion runs replicated (n_dev is small, unrolled), giving each block
   the value-function element at its right edge `E_right`.
3. **Local recovery** — every local node's value function is
   `combine(E_right, S_t)`; gains come from the standard one-shot pass.
   d1/d2 line-search expectations are `psum`-reduced over the axis.

Communication: one all_gather of n_dev elements + two scalar psums per
backward sweep — O(n_dev * nx^2) bytes between devices, independent of T.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .riccati_pscan import (
    _Elem,
    _combine,
    _gains_at,
    _stage_elements,
    _terminal_element,
)


def _block_riccati(axis_name, n_dev,
                   lx, lu, lxx, lxu, luu, Fx, Fu, fsn, term_lx, term_lxx,
                   reg):
    """Per-device body (runs under shard_map; [Tb, ...] local blocks)."""
    elems = _stage_elements(lx, lu, lxx, lxu, luu, Fx, Fu, fsn, reg)
    # local suffix compositions S_t = e_t o ... o e_{Tb-1}
    S = jax.lax.associative_scan(_combine, elems, reverse=True)
    block = jax.tree.map(lambda a: a[0], S)  # whole-block composite

    # one all_gather of the n_dev block composites (tiled=False: [n_dev,...])
    allB = jax.lax.all_gather(block, axis_name)

    # cross-block suffix recursion, replicated (n_dev static, unrolled):
    # rights[d] = composition of blocks d+1.. and the terminal element
    term = _terminal_element(term_lx, term_lxx)
    rights = [None] * n_dev
    R = term
    for d in reversed(range(n_dev)):
        rights[d] = R
        R = _combine(R, jax.tree.map(lambda a: a[d], allB))
    rights_st = jax.tree.map(lambda *xs: jnp.stack(xs), *rights)
    idx = jax.lax.axis_index(axis_name)
    E_right = jax.tree.map(
        lambda a: jax.lax.dynamic_index_in_dim(a, idx, keepdims=False),
        rights_st)

    # value functions at all local nodes: V(t) from combine(E_right, S_t)
    full = jax.vmap(lambda s: _combine(E_right, s))(S)
    Vx_loc = -full.eta          # [Tb, nx]
    Vxx_loc = full.J            # [Tb, nx, nx]
    # V_{t+1} for the gain pass: shift left; the block's right edge is
    # E_right's own value function
    Vx_next = jnp.concatenate([Vx_loc[1:], (-E_right.eta)[None]])
    Vxx_next = jnp.concatenate([Vxx_loc[1:], E_right.J[None]])

    ks, Ks, Qus, d1_t, d2_t = jax.vmap(
        lambda *a: _gains_at(*a, reg))(
        lx, lu, lxx, lxu, luu, Fx, Fu, fsn, Vx_next, Vxx_next)
    d1 = jax.lax.psum(jnp.sum(d1_t), axis_name)
    d2 = jax.lax.psum(jnp.sum(d2_t), axis_name)
    return ks, Ks, Qus, Vx_loc, Vxx_loc, d1, d2


def make_tsharded_riccati(mesh: Mesh, axis_name: str = "t"):
    """Build `riccati(lx, lu, lxx, lxu, luu, Fx, Fu, fs_next, term_lx,
    term_lxx, reg) -> (ks, Ks, Qus, Vx, Vxx, d1, d2)` with every [T, ...]
    input and output sharded along ``axis_name``; `reg` is a traced scalar
    (Levenberg-Marquardt parameter, replicated).  T must divide evenly by
    the mesh axis size."""
    n_dev = mesh.shape[axis_name]
    sh = P(axis_name)
    rep = P()
    body = partial(_block_riccati, axis_name, n_dev)
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(sh,) * 8 + (rep, rep, rep),
        out_specs=(sh, sh, sh, sh, sh, rep, rep),
        check_vma=False,
    )


def solve_fddp_tsharded(cf, x0, refs, xs_init, us_init, settings, mesh: Mesh,
                        axis_name: str = "t"):
    """Single-scenario FDDP with the horizon sharded over the mesh.

    The per-node work (stage derivatives, Gauss-Newton packs, the Riccati
    sweep) runs T-sharded via `shard_map`; the genuinely sequential parts
    (gap computation, line-search rollouts) consume gathered arrays — GSPMD
    inserts the all_gathers.  Semantics match `fddp.solve_fddp` (Crocoddyl
    FDDP); intended for long horizons (T >= several hundred) where one
    device's backward sweep dominates.
    """
    from .fddp import Solution, _forward, _gaps, _total_cost

    T = us_init.shape[0]
    n_dev = mesh.shape[axis_name]
    assert T % n_dev == 0, f"T={T} must divide over {n_dev} devices"
    dtype = xs_init.dtype
    # tangent dimension: Lie-state CostFunctions carry derivative blocks in
    # ntan coords (ADVICE r03: sizing gains with the ambient nx broke the
    # scan carry for free-flyer states)
    nx = cf.ntan if getattr(cf, "ntan", None) else xs_init.shape[1]
    nu = us_init.shape[1]
    alphas = jnp.asarray([0.5**i for i in range(settings.n_alphas)], dtype)
    sh = NamedSharding(mesh, P(axis_name))

    def derivs_block(xs_b, us_b, ts_b):
        return jax.vmap(lambda x, u, t: cf.stage_derivs(x, u, t, refs))(
            xs_b, us_b, ts_b)

    sharded_derivs = jax.shard_map(
        derivs_block, mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name)),
        out_specs=P(axis_name), check_vma=False)

    def derivs_of(xs, us):
        ts = jnp.arange(T)
        xs_sh = jax.lax.with_sharding_constraint(xs[:-1], sh)
        us_sh = jax.lax.with_sharding_constraint(us, sh)
        d = sharded_derivs(xs_sh, us_sh, ts)
        term = cf.terminal_derivs(xs[-1], refs)
        return d, term

    riccati = make_tsharded_riccati(mesh, axis_name)

    def iteration(carry, _):
        xs, us, cost, reg, kkt, converged, iters, ks, Ks = carry
        d, term = derivs_of(xs, us)
        fs = _gaps(cf, x0, xs, d.xnext)
        gap_norm = jnp.max(jnp.abs(fs))
        ks_new, Ks_new, Qus, _Vx, _Vxx, d1, d2 = riccati(
            d.lx, d.lu, d.lxx, d.lxu, d.luu, d.Fx, d.Fu, fs[1:],
            term.lx, term.lxx, reg)
        diverged = ~jnp.all(jnp.isfinite(ks_new)) | ~jnp.all(
            jnp.isfinite(Ks_new))
        kkt_new = jnp.maximum(jnp.max(jnp.abs(Qus)), gap_norm)

        xs_a, us_a, cost_a = jax.vmap(
            lambda a: _forward(cf, T, x0, xs, us, ks_new, Ks_new, fs, a, refs)
        )(alphas)
        finite = jnp.all(
            jnp.isfinite(cost_a.reshape(settings.n_alphas, -1)), axis=-1
        ) & jnp.all(jnp.isfinite(xs_a.reshape(settings.n_alphas, -1)), axis=-1)
        reduction = cost - cost_a
        gaps_a = (1.0 - alphas) * gap_norm
        # feasibility-gated filter (see fddp.py): a feasible iterate accepts
        # on cost decrease only
        infeasible = gap_norm > 1e-9
        accept = finite & ((reduction > 0.0)
                           | (infeasible & (gaps_a < gap_norm * (1.0 - 1e-6))))
        any_accept = jnp.any(accept)
        best = jnp.argmax(accept)
        step_ok = any_accept & ~diverged
        xs_next = jnp.where(step_ok, xs_a[best], xs)
        us_next = jnp.where(step_ok, us_a[best], us)
        cost_next = jnp.where(step_ok, cost_a[best], cost)
        reg_next = jnp.clip(
            jnp.where(step_ok, reg / settings.reg_dec, reg * settings.reg_inc),
            settings.reg_min, settings.reg_max)
        newly_converged = kkt_new < settings.termination_tolerance
        xs_out = jnp.where(converged, xs, xs_next)
        us_out = jnp.where(converged, us, us_next)
        cost_out = jnp.where(converged, cost, cost_next)
        reg_out = jnp.where(converged, reg, reg_next)
        kkt_out = jnp.where(converged, kkt, kkt_new)
        ks_out = jnp.where(converged, ks, ks_new)
        Ks_out = jnp.where(converged, Ks, Ks_new)
        iters_out = iters + jnp.where(converged, 0, 1)
        return (xs_out, us_out, cost_out, reg_out, kkt_out,
                converged | newly_converged, iters_out, ks_out, Ks_out), None

    cost0 = _total_cost(cf, T, xs_init, us_init, refs)
    init = (xs_init, us_init, cost0,
            jnp.asarray(settings.reg_init, dtype),
            jnp.asarray(jnp.inf, dtype), jnp.asarray(False), jnp.asarray(0),
            jnp.zeros((T, nu), dtype), jnp.zeros((T, nu, nx), dtype))
    (xs, us, cost, reg, kkt, converged, iters, ks, Ks), _ = jax.lax.scan(
        iteration, init, None, length=settings.max_iters)

    d, term = derivs_of(xs, us)
    fs = _gaps(cf, x0, xs, d.xnext)
    ks_f, Ks_f, Qus, _Vx, _Vxx, d1, d2 = riccati(
        d.lx, d.lu, d.lxx, d.lxu, d.luu, d.Fx, d.Fu, fs[1:],
        term.lx, term.lxx, jnp.asarray(settings.reg_min, dtype))
    kkt_f = jnp.maximum(jnp.max(jnp.abs(Qus)), jnp.max(jnp.abs(fs)))
    return Solution(
        xs=xs, us=us, K=Ks_f, k=ks_f, cost=cost,
        kkt=kkt_f, gap_norm=jnp.max(jnp.abs(fs)), iters=iters, reg=reg,
        converged=converged,
    )
