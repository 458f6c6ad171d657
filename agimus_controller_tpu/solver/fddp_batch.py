"""Batch-native FDDP: thousands of scenarios in ONE jitted program.

Unlike `vmap(solve_fddp)` — which replicates the tiny-op single-scenario
program per lane and runs at ~0.1% of peak (see `ops/batched_dynamics.py`) —
this solver carries the batch dimension through every stage explicitly:

- dynamics + analytic derivatives come from the component-form kernels
  (`make_batched_step_with_derivs`), one fused dispatch for all B*T nodes,
- cost Gauss-Newton packs are vmapped (cheap relative to dynamics),
- the Riccati backward pass is a `lax.scan` over T of `[B, n, n]` batched
  matmuls/Cholesky (MXU-friendly block shapes),
- line search, Levenberg-Marquardt regularization and convergence are all
  PER SCENARIO (`[B]` masks) — scenarios that converge early become no-ops
  while the rest keep iterating, which `vmap(solve_fddp)` cannot express.

Semantics per scenario are identical to `solve_fddp` (Crocoddyl FDDP).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import ModelParams, RobotModel
from ..ocp.costs import CostFunctions
from ..ocp.spec import ProblemSpec
from ..ops.batched_costs import make_batched_cost_pack
from ..ops.batched_dynamics import make_batched_step, make_batched_step_with_derivs
from .fddp import Solution, SolverSettings
from .precision import highest_precision


def _tri_solve(L, b):
    """Batched SPD solve with given Cholesky factors: L [B,n,n], b [B,n]."""
    y = jax.lax.linalg.triangular_solve(
        L, b[..., None], left_side=True, lower=True)
    x = jax.lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True)
    return x[..., 0]


def _tri_solve_mat(L, Bm):
    y = jax.lax.linalg.triangular_solve(L, Bm, left_side=True, lower=True)
    return jax.lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True)


def make_batch_fddp(
    model: RobotModel,
    params: ModelParams,
    spec: ProblemSpec,
    cf: CostFunctions,
    settings: SolverSettings = SolverSettings(),
    riccati: str = "component",
):
    """Build `solve(x0s [B,nx], refs, xs [B,T+1,nx], us [B,T,nu]) -> Solution`
    (leaves carry a leading [B]). Multi-resolution horizons supported
    (per-node dt arrays feed the component step directly).

    ``riccati``: backward-sweep implementation —
      - "component" (default): full-lane component layout
        (`riccati_components.py`), fastest at large B (no lane padding);
      - "pscan": associative-scan parallel Riccati (`riccati_pscan.py`),
        O(log T) depth — the latency choice for small B / long horizons;
      - "dense": `[B, n, n]` einsum scan (reference implementation).
    """
    if riccati not in ("component", "pscan", "dense"):
        raise ValueError(riccati)
    T = spec.horizon
    ts_np = spec.timesteps()  # per-node dt (multi-resolution supported)
    soft = spec.soft_contact is not None
    # Lie-group (manifold) state (quaternion free-flyer): tangent-dim
    # derivative blocks, sdiff/sint for gaps and rollout corrections — the
    # reference's StateMultibody semantics through the batch solver
    # (VERDICT r03 #2)
    manifold = cf.ntan is not None
    if manifold:
        assert not soft, "manifold + soft contact not supported yet"
        step_b = step_d = None
    elif soft:
        from ..ops.batched_dynamics import (
            make_batched_soft_step,
            make_batched_soft_step_with_derivs,
        )

        step_b = make_batched_soft_step(model, params, spec.soft_contact)
        step_d = make_batched_soft_step_with_derivs(
            model, params, spec.soft_contact)
    else:
        step_b = make_batched_step(model, params)
        step_d = make_batched_step_with_derivs(model, params)

    if manifold:
        sdiff_b = jax.vmap(cf.state_diff)
        sint_b = jax.vmap(cf.state_integrate)
        sdiff_tb = jax.vmap(sdiff_b)
    else:
        # plain broadcasting (vmap wrappers cost ~14% XLA:CPU compile time)
        sdiff_b = sdiff_tb = (lambda x1, x0_: x1 - x0_)
        sint_b = (lambda x, dx: x + dx)

    def dyn_step(x, u, dts, t_idx, refs):
        """Rigid (x,u,dt) or force-augmented step with per-node contact
        activation from refs (runtime array, not object mutation)."""
        if manifold:
            return jax.vmap(lambda xx, uu: cf.step(xx, uu, t_idx, refs))(x, u)
        if soft:
            act = jnp.broadcast_to(
                refs["contact_active"][t_idx], x.shape[:1]).astype(x.dtype)
            d = jnp.broadcast_to(jnp.asarray(dts, x.dtype), x.shape[:1])
            return step_b(x, u, d, act)
        return step_b(x, u, dts)

    def dyn_derivs(x, u, dts, t_idx, refs):
        if soft:
            act = jnp.broadcast_to(
                refs["contact_active"][t_idx], x.shape[:1]).astype(x.dtype)
            d = jnp.broadcast_to(jnp.asarray(dts, x.dtype), x.shape[:1])
            return step_d(x, u, d, act)
        return step_d(x, u, dts)
    n_alphas = settings.n_alphas
    alphas_np = [0.5**i for i in range(n_alphas)]

    packed = None if manifold else make_batched_cost_pack(model, params, spec)
    if manifold:
        cost_derivs_b = None
        term_derivs_b = jax.vmap(cf.terminal_derivs, in_axes=(0, None))
        stage_cost_b = jax.vmap(cf.stage_cost, in_axes=(0, 0, None, None))
        term_cost_b = jax.vmap(cf.terminal_cost, in_axes=(0, None))
    elif packed is not None:
        # component-form cost packs (full-lane layout; the fast path)
        cost_derivs_b, _term_pack, stage_cost_b, term_cost_b = packed

        def term_derivs_b(x, refs):
            from ..ocp.costs import TerminalDerivs

            l, lx, lxx = _term_pack(x, refs)
            return TerminalDerivs(l, lx, lxx)
    else:
        cost_derivs_b = jax.vmap(cf.cost_derivs, in_axes=(0, 0, None, None))
        term_derivs_b = jax.vmap(cf.terminal_derivs, in_axes=(0, None))
        stage_cost_b = jax.vmap(cf.stage_cost, in_axes=(0, 0, None, None))
        term_cost_b = jax.vmap(cf.terminal_cost, in_axes=(0, None))

    def total_cost(xs, us, refs):
        # xs [T+1, B, nx]
        def body(acc, inp):
            x, u, t = inp
            return acc + stage_cost_b(x, u, t, refs), None

        acc0 = jnp.zeros(xs.shape[1], xs.dtype)
        acc, _ = jax.lax.scan(body, acc0, (xs[:-1], us, jnp.arange(T)))
        return acc + term_cost_b(xs[-1], refs)

    def derivs_of(xs, us, refs):
        B = xs.shape[1]
        nx = xs.shape[2]
        nu = us.shape[2]
        x_flat = xs[:-1].reshape(T * B, nx)
        u_flat = us.reshape(T * B, nu)
        dts_flat = jnp.repeat(jnp.asarray(ts_np, xs.dtype), B)
        t_flat = jnp.repeat(jnp.arange(T, dtype=jnp.int32), B)
        if manifold:
            nt = cf.ntan
            d = jax.vmap(
                lambda x, u, t: cf.stage_derivs(x, u, t, refs)
            )(x_flat, u_flat, t_flat)
            dyn = (d.xnext.reshape(T, B, nx),
                   d.Fx.reshape(T, B, nt, nt), d.Fu.reshape(T, B, nt, nu))
            costs = (d.cost.reshape(T, B), d.lx.reshape(T, B, nt),
                     d.lu.reshape(T, B, nu), d.lxx.reshape(T, B, nt, nt),
                     d.lxu.reshape(T, B, nt, nu),
                     d.luu.reshape(T, B, nu, nu))
            return dyn, costs, term_derivs_b(xs[-1], refs)
        xnext, Fx, Fu = dyn_derivs(x_flat, u_flat, dts_flat, t_flat, refs)
        dyn = (
            xnext.reshape(T, B, nx),
            Fx.reshape(T, B, nx, nx),
            Fu.reshape(T, B, nx, nu),
        )
        costs = jax.vmap(
            lambda x, u, t: cost_derivs_b(x, u, t, refs)
        )(xs[:-1], us, jnp.arange(T))  # each [T, B, ...]
        term = term_derivs_b(xs[-1], refs)
        return dyn, costs, term

    def backward(dyn, costs, term, fs, reg):
        xnext, Fx_all, Fu_all = dyn
        l, lx, lu, lxx, lxu, luu = costs
        if riccati == "component":
            from .riccati_components import backward_components

            return backward_components(
                Fx_all, Fu_all, lx, lu, lxx, lxu, luu, fs,
                term.lx, term.lxx, reg)
        if riccati == "pscan":
            from .riccati_pscan import parallel_riccati

            B = fs.shape[1]
            ks, Ks, Qus, _Vx, _Vxx, d1, d2 = jax.vmap(
                parallel_riccati,
                in_axes=(1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0),
                out_axes=(1, 1, 1, 1, 1, 0, 0),
            )(lx, lu, lxx, lxu, luu, Fx_all, Fu_all, fs,
              term.lx, term.lxx, reg)
            bad = ~jnp.all(jnp.isfinite(ks.reshape(T, B, -1)), axis=(0, 2)) | (
                ~jnp.all(jnp.isfinite(Ks.reshape(T, B, -1)), axis=(0, 2)))
            return ks, Ks, Qus, d1, d2, bad
        B = fs.shape[1]
        nu = lu.shape[-1]
        eye_u = jnp.eye(nu, dtype=fs.dtype)

        def body(carry, inp):
            Vx, Vxx, d1, d2 = carry
            lx_t, lu_t, lxx_t, lxu_t, luu_t, Fx, Fu, f_next = inp
            Vx_plus = Vx + jnp.einsum("bij,bj->bi", Vxx, f_next)
            Qx = lx_t + jnp.einsum("bji,bj->bi", Fx, Vx_plus)
            Qu = lu_t + jnp.einsum("bji,bj->bi", Fu, Vx_plus)
            VF = jnp.einsum("bij,bjk->bik", Vxx, Fx)
            Qxx = lxx_t + jnp.einsum("bji,bjk->bik", Fx, VF)
            Qux = jnp.swapaxes(lxu_t, -1, -2) + jnp.einsum(
                "bji,bjk->bik", Fu, VF)
            VFu = jnp.einsum("bij,bjk->bik", Vxx, Fu)
            Quu = luu_t + jnp.einsum("bji,bjk->bik", Fu, VFu) + (
                reg[:, None, None] * eye_u)
            L = jnp.linalg.cholesky(Quu)
            kk = _tri_solve(L, Qu)
            KK = _tri_solve_mat(L, Qux)
            Vx_new = Qx - jnp.einsum("bji,bj->bi", Qux, kk)
            Vxx_new = Qxx - jnp.einsum("bji,bjk->bik", Qux, KK)
            Vxx_new = 0.5 * (Vxx_new + jnp.swapaxes(Vxx_new, -1, -2))
            d1n = d1 + jnp.einsum("bi,bi->b", Qu, kk)
            d2n = d2 + jnp.einsum("bi,bij,bj->b", kk, Quu, kk)
            return (Vx_new, Vxx_new, d1n, d2n), (kk, KK, Qu)

        zero = jnp.zeros(B, fs.dtype)
        (Vx, Vxx, d1, d2), (ks, Ks, Qus) = jax.lax.scan(
            body, (term.lx, term.lxx, zero, zero),
            (lx, lu, lxx, lxu, luu, Fx_all, Fu_all, fs[1:]),
            reverse=True,
        )
        bad = ~jnp.all(jnp.isfinite(ks.reshape(T, B, -1)), axis=(0, 2)) | (
            ~jnp.all(jnp.isfinite(Ks.reshape(T, B, -1)), axis=(0, 2)))
        return ks, Ks, Qus, d1, d2, bad

    def rollout_alpha(alpha, x0s, xs, us, ks, Ks, fs, refs):
        """One gap-contracting FDDP rollout at step length ``alpha``;
        trial cost accumulates inside the scan (one pass over T)."""
        B = xs.shape[1]
        one_m_a = 1.0 - alpha

        def body(carry, inp):
            x, acc = carry
            xref, uref, kk, KK, f_next, dt_t, t = inp
            du = -alpha * kk - jnp.einsum(
                "bij,bj->bi", KK, sdiff_b(x, xref))
            u = uref + du
            c = stage_cost_b(x, u, t, refs)
            xn = sint_b(dyn_step(x, u, dt_t, t, refs), -one_m_a * f_next)
            return (xn, acc + c), (xn, u)

        x_init = sint_b(x0s, -one_m_a * fs[0])
        acc0 = jnp.zeros((B,), xs.dtype)
        (xT, acc), (xs_new, us_new) = jax.lax.scan(
            body, (x_init, acc0),
            (xs[:-1], us, ks, Ks, fs[1:], jnp.asarray(ts_np, xs.dtype),
             jnp.arange(T)))
        xs_try = jnp.concatenate([x_init[None], xs_new], axis=0)
        cost_try = acc + term_cost_b(xT, refs)
        return xs_try, us_new, cost_try  # [T+1,B,nx], [T,B,nu], [B]

    def solve(x0s, refs, xs_in, us_in) -> Solution:
        # internal layout: time-major [T+1, B, nx]
        xs = jnp.swapaxes(xs_in, 0, 1)
        us = jnp.swapaxes(us_in, 0, 1)
        B = xs.shape[1]
        dtype = xs.dtype
        alphas = jnp.asarray(alphas_np, dtype)

        def gaps_of(xnext, xs):
            return jnp.concatenate(
                [sdiff_b(x0s, xs[0])[None], sdiff_tb(xnext, xs[1:])], axis=0)

        def iteration(carry, _):
            xs, us, cost, reg, kkt, converged, iters, ks, Ks = carry
            dyn, costs, term = derivs_of(xs, us, refs)
            fs = gaps_of(dyn[0], xs)
            gap_norm = jnp.max(jnp.abs(fs), axis=(0, 2))  # [B]
            ks_new, Ks_new, Qus, d1, d2, bad = backward(dyn, costs, term, fs, reg)
            kkt_new = jnp.maximum(
                jnp.max(jnp.abs(Qus), axis=(0, 2)), gap_norm)  # [B]

            # ---- line search: sequential alpha ladder with per-scenario
            # first-accept masks (the order Crocoddyl tries step lengths);
            # the while_loop exits as soon as EVERY live scenario accepted —
            # typically after 1-2 rollouts instead of all n_alphas ----------
            def accept_of(alpha, cost_a, finite):
                reduction = cost - cost_a  # [B]
                if settings.use_filter_line_search:
                    # feasibility-gated filter (see fddp.py): a feasible
                    # scenario accepts on cost decrease only — otherwise
                    # (1-a)*gap < gap admits cost-increasing steps
                    gaps_a = (1.0 - alpha) * gap_norm
                    infeasible = gap_norm > 1e-9
                    return finite & (
                        (reduction > 0.0)
                        | (infeasible & (gaps_a < gap_norm * (1.0 - 1e-6))))
                expected = alpha * d1 - 0.5 * (alpha**2) * d2
                return finite & jnp.where(
                    expected > 0.0,
                    reduction >= settings.accept_ratio * expected,
                    reduction > 0.0)

            def ls_cond(state):
                i, done, took, _, _, _ = state
                return (i < n_alphas) & ~jnp.all(done)

            def ls_body(state):
                i, done, took, xs_b, us_b, cost_b = state
                alpha = alphas[i]
                xs_t, us_t, cost_t = rollout_alpha(
                    alpha, x0s, xs, us, ks_new, Ks_new, fs, refs)
                finite = jnp.all(
                    jnp.isfinite(xs_t), axis=(0, 2)) & jnp.isfinite(cost_t)
                take = accept_of(alpha, cost_t, finite) & ~done
                xs_b = jnp.where(take[None, :, None], xs_t, xs_b)
                us_b = jnp.where(take[None, :, None], us_t, us_b)
                cost_b = jnp.where(take, cost_t, cost_b)
                return (i + 1, done | take, took | take, xs_b, us_b, cost_b)

            skip = converged | bad  # no trial needed for these scenarios
            ls_init = (jnp.asarray(0, jnp.int32), skip,
                       jnp.zeros((B,), bool), xs, us, cost)
            _, _, took, xs_best, us_best, cost_best = jax.lax.while_loop(
                ls_cond, ls_body, ls_init)
            any_accept = took  # [B]

            ok = any_accept & ~converged
            xs_out = jnp.where(ok[None, :, None], xs_best, xs)
            us_out = jnp.where(ok[None, :, None], us_best, us)
            cost_out = jnp.where(ok, cost_best, cost)
            reg_out = jnp.where(
                converged, reg,
                jnp.clip(
                    jnp.where(any_accept & ~bad, reg / settings.reg_dec,
                              reg * settings.reg_inc),
                    settings.reg_min, settings.reg_max))
            live = ~converged
            kkt_out = jnp.where(live, kkt_new, kkt)
            ks_out = jnp.where(live[None, :, None], ks_new, ks)
            Ks_out = jnp.where(live[None, :, None, None], Ks_new, Ks)
            iters_out = iters + live.astype(iters.dtype)
            conv_out = converged | (kkt_new < settings.termination_tolerance)
            return (xs_out, us_out, cost_out, reg_out, kkt_out, conv_out,
                    iters_out, ks_out, Ks_out), None

        nx = xs.shape[2]
        nt = cf.ntan if manifold else nx
        nu = us.shape[2]
        cost0 = total_cost(xs, us, refs)
        init = (
            xs, us, cost0,
            jnp.full((B,), settings.reg_init, dtype),
            jnp.full((B,), jnp.inf, dtype),
            jnp.zeros((B,), bool),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((T, B, nu), dtype),
            jnp.zeros((T, B, nu, nt), dtype),
        )
        (xs, us, cost, reg, kkt, converged, iters, ks, Ks), _ = jax.lax.scan(
            iteration, init, None, length=settings.max_iters)

        # final report pass
        dyn, costs, term = derivs_of(xs, us, refs)
        fs = gaps_of(dyn[0], xs)
        ks_f, Ks_f, Qus, d1, d2, bad = backward(
            dyn, costs, term, fs, jnp.full((B,), settings.reg_min, dtype))
        kkt_f = jnp.maximum(
            jnp.max(jnp.abs(Qus), axis=(0, 2)),
            jnp.max(jnp.abs(fs), axis=(0, 2)))
        keep = bad
        return Solution(
            xs=jnp.swapaxes(xs, 0, 1),
            us=jnp.swapaxes(us, 0, 1),
            K=jnp.swapaxes(jnp.where(keep[None, :, None, None], Ks, Ks_f), 0, 1),
            k=jnp.swapaxes(jnp.where(keep[None, :, None], ks, ks_f), 0, 1),
            cost=cost,
            kkt=kkt_f,
            gap_norm=jnp.max(jnp.abs(fs), axis=(0, 2)),
            iters=iters,
            reg=reg,
            converged=converged | (kkt_f < settings.termination_tolerance),
        )

    return highest_precision(solve)
