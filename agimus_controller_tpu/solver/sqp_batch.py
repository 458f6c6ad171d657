"""Batch-native multiple-shooting SQP / CSQP — the LATENCY solver.

This implements the reference's *actual runtime solver* semantics
(mim_solvers ``SolverSQP`` / ``SolverCSQP``, reference call site
`ocp_base_croco.py:64-80`): multiple shooting with linear step updates

    xs_try = xs + alpha * dxs,   us_try = us + alpha * dus

instead of FDDP's nonlinear rollout. The nonlinear rollout is a sequential
``lax.scan`` over the horizon whose tiny per-node body is dominated by
per-step overhead, while every stage here is node-parallel:

- dynamics + analytic derivatives and the cost Gauss-Newton packs: one
  flattened [T*B] evaluation (`make_batched_step_with_derivs` +
  `make_batched_cost_pack`),
- Riccati backward: factor-once batch-minor sweep (`riccati_components`
  layout) — the only remaining sequential-in-T stage, with a tiny body,
- QP (constrained case): OSQP-style ADMM over the *cached* Riccati
  factorization — each of up to ``max_qp_iters`` iterations is a cheap
  linear backward/forward vector sweep plus slack clip + dual update
  (mim_solvers' trick; reference `ocp_param_base.py:53-61` for eps_abs/rel),
- line search: the WHOLE alpha ladder evaluated in one batched node-parallel
  dispatch (costs + exact dynamics gaps + constraint violations), then a
  per-scenario first-accept filter rule — semantics of mim_solvers'
  filter line search.

Everything carries a leading scenario batch B with per-scenario convergence
masks; scenarios that converge early become no-ops while the rest iterate.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import ModelParams, RobotModel
from ..ocp.costs import CostFunctions
from ..ocp.spec import ProblemSpec
from ..ops.batched_costs import make_batched_cost_pack
from ..ops.batched_dynamics import make_batched_step, make_batched_step_with_derivs
from .csqp import CSQPSettings
from .precision import highest_precision
from .tuning import scan_unroll
from .riccati_components import (
    _chol_lanes,
    _chol_solve_lanes,
    _mm,
    _mm_T1,
    _mv,
    _mv_T,
)


class BatchSQPSolution(NamedTuple):
    xs: jnp.ndarray  # [B, T+1, nx]
    us: jnp.ndarray  # [B, T, nu]
    K: jnp.ndarray  # [B, T, nu, nx]
    k: jnp.ndarray  # [B, T, nu]
    cost: jnp.ndarray  # [B]
    kkt: jnp.ndarray  # [B]
    gap_norm: jnp.ndarray  # [B]
    constraint_norm: jnp.ndarray  # [B]
    iters: jnp.ndarray  # [B]
    qp_iters: jnp.ndarray  # [B]
    converged: jnp.ndarray  # [B]
    # final scaled ADMM duals [B, T+1, nc] (zeros-shaped [B, T+1, 1] when
    # unconstrained). Feed back as `y0` on the NEXT warm-started MPC tick:
    # the previous optimum sits ON the active constraint boundary, and
    # restarting the duals from zero there makes the ADMM re-discover the
    # active set every tick (measured: 40% convergence over a drifting
    # chain at max_iters=100 vs ~100% warm — mim_solvers warm-starts its
    # QP duals the same way across solves).
    y: Optional[jnp.ndarray] = None
    # per-iteration telemetry (CallbackVerbose/CallbackLogger analog,
    # reference `ocp_base_croco.py:77-80`): populated when the solver is
    # built with `trace=True`, NaN-padded past each scenario's last iteration
    trace_cost: Optional[jnp.ndarray] = None  # [max_iters, B]
    trace_kkt: Optional[jnp.ndarray] = None  # [max_iters, B]
    trace_gap: Optional[jnp.ndarray] = None  # [max_iters, B]


def _violation(g, lb, ub):
    return jnp.maximum(jnp.maximum(lb - g, g - ub), 0.0)


def _sweep_dtype(dtype, settings):
    """Working dtype for the Riccati/ADMM sweeps and the line-search
    accumulations: f64 when the trajectories are f32 and sweep_f64 is on
    (inert without jax x64 — f64 would canonicalize back to f32)."""
    if (settings.sweep_f64 and dtype == jnp.dtype(jnp.float32)
            and jax.config.jax_enable_x64):
        return jnp.float64
    return dtype


def _flatten_nodes(xs, us, ts_np):
    """Time-major trajectories -> the [T*B] stage nodes, (t, b) with b
    fastest: (x [T*B,nx], u [T*B,nu], dt [T*B], t_idx [T*B])."""
    T, B = us.shape[0], xs.shape[1]
    x_flat = xs[:-1].reshape(T * B, xs.shape[2])
    u_flat = us.reshape(T * B, us.shape[2])
    dts_flat = jnp.repeat(jnp.asarray(ts_np, xs.dtype), B)
    t_idx = jnp.repeat(jnp.arange(T, dtype=jnp.int32), B)
    return x_flat, u_flat, dts_flat, t_idx


def _soft_inputs(x, dts, t_idx, refs):
    """Per-node (dt, contact activation) of the force-augmented step: the
    reference mutates `dam.active_contact` per tick; here it is a runtime
    array in refs."""
    act = jnp.broadcast_to(
        refs["contact_active"][t_idx], x.shape[:1]).astype(x.dtype)
    d = jnp.broadcast_to(jnp.asarray(dts, x.dtype), x.shape[:1])
    return d, act


def make_stage_derivs(model: RobotModel, params: ModelParams,
                      spec: ProblemSpec, cf: CostFunctions, cost_pack=None):
    """The stage evaluation of `make_batch_sqp`'s derivative pass:
    `derivs(xs [T+1,B,nx], us [T,B,nu], refs) -> (dyn, costs, term)`, all
    time-major: dyn = (xnext, Fx, Fu) [T,B,...], costs = (l, lx, lu, lxx,
    lxu, luu) [T,B,...], term = `TerminalDerivs` of xs[-1]. Derivative
    blocks are in tangent coordinates (dim cf.ntan) on a manifold state.

    Dynamics and their Jacobians run over the T*B flattened nodes
    (`make_batched_step_with_derivs`), the running-cost Gauss-Newton packs
    over [T] x [B] (`make_batched_cost_pack`, or ``cost_pack`` when the
    caller has built it already); a manifold state takes both from
    `cf.stage_derivs`."""
    from ..ocp.costs import TerminalDerivs

    T = spec.horizon
    ts_np = np.asarray(spec.timesteps())
    if cf.ntan is not None:
        nt = cf.ntan
        term_derivs_b = jax.vmap(cf.terminal_derivs, in_axes=(0, None))

        def derivs_manifold(xs, us, refs):
            B, nx, nu = xs.shape[1], xs.shape[2], us.shape[2]
            x_flat, u_flat, _, t_idx = _flatten_nodes(xs, us, ts_np)
            d = jax.vmap(
                lambda x, u, t: cf.stage_derivs(x, u, t, refs)
            )(x_flat, u_flat, t_idx)
            dyn = (d.xnext.reshape(T, B, nx),
                   d.Fx.reshape(T, B, nt, nt), d.Fu.reshape(T, B, nt, nu))
            costs = (d.cost.reshape(T, B), d.lx.reshape(T, B, nt),
                     d.lu.reshape(T, B, nu), d.lxx.reshape(T, B, nt, nt),
                     d.lxu.reshape(T, B, nt, nu),
                     d.luu.reshape(T, B, nu, nu))
            return dyn, costs, term_derivs_b(xs[-1], refs)

        return derivs_manifold

    soft = spec.soft_contact is not None
    if soft:
        from ..ops.batched_dynamics import make_batched_soft_step_with_derivs

        step_d = make_batched_soft_step_with_derivs(
            model, params, spec.soft_contact)
    else:
        step_d = make_batched_step_with_derivs(model, params)
    packed = cost_pack or make_batched_cost_pack(model, params, spec)
    if packed is None:  # cost kinds outside the component-form pack
        cost_derivs_b = jax.vmap(cf.cost_derivs, in_axes=(0, 0, None, None))
        term_derivs_b = jax.vmap(cf.terminal_derivs, in_axes=(0, None))
    else:
        cost_derivs_b, term_pack = packed[:2]

        def term_derivs_b(x, refs):
            l, lx, lxx = term_pack(x, refs)
            return TerminalDerivs(l, lx, lxx)

    def derivs(xs, us, refs):
        B, nx, nu = xs.shape[1], xs.shape[2], us.shape[2]
        x_flat, u_flat, dts_flat, t_idx = _flatten_nodes(xs, us, ts_np)
        if soft:
            xnext, Fx, Fu = step_d(
                x_flat, u_flat, *_soft_inputs(x_flat, dts_flat, t_idx, refs))
        else:
            xnext, Fx, Fu = step_d(x_flat, u_flat, dts_flat)
        dyn = (
            xnext.reshape(T, B, nx),
            Fx.reshape(T, B, nx, nx),
            Fu.reshape(T, B, nx, nu),
        )
        costs = jax.vmap(
            lambda x, u, t: cost_derivs_b(x, u, t, refs)
        )(xs[:-1], us, jnp.arange(T, dtype=jnp.int32))
        term = term_derivs_b(xs[-1], refs)
        return dyn, costs, term

    return derivs


def make_batch_sqp(
    model: RobotModel,
    params: ModelParams,
    spec: ProblemSpec,
    cf: CostFunctions,
    settings: CSQPSettings = CSQPSettings(),
    trace: bool = False,
):
    """Build `solve(x0s [B,nx], refs, xs [B,T+1,nx], us [B,T,nu])
    -> BatchSQPSolution` (leaves carry a leading [B]).

    Unconstrained specs get plain multiple-shooting SQP; specs with
    constraints get the full CSQP ADMM treatment. Multi-resolution horizons
    supported (per-node dt arrays feed the flattened dynamics dispatch).

    The derivative pass evaluates the stages with `make_stage_derivs`.
    Matrix products trace at HIGHEST precision.
    """
    T = spec.horizon
    nc = cf.n_constraints
    ts_np = np.asarray(spec.timesteps())
    soft = spec.soft_contact is not None
    # Lie-group (manifold) state: derivative blocks live in tangent coords
    # of dim cf.ntan; states stay ambient (quaternion free-flyer). Gaps and
    # step updates go through cf.state_diff / cf.state_integrate — the
    # reference's StateMultibody semantics (`ocp_base_croco.py:36-41`)
    # threaded through the batch solver (VERDICT r03 #2).
    manifold = cf.ntan is not None
    if soft:
        from ..ops.batched_dynamics import make_batched_soft_step

        step_b = make_batched_soft_step(model, params, spec.soft_contact)
    elif manifold:
        # manifold + soft contact composes: the ff cost pack's step/diff/
        # integrate already carry the force-augmented state (ff_costs.py)
        step_b = None
    else:
        step_b = make_batched_step(model, params)

    if manifold:
        sdiff_b = jax.vmap(cf.state_diff)
        sdiff_tb = jax.vmap(sdiff_b)
        sint_tb = jax.vmap(jax.vmap(cf.state_integrate))
    else:
        # plain broadcasting (vmap wrappers cost ~14% XLA:CPU compile time)
        sdiff_b = sdiff_tb = (lambda x1, x0_: x1 - x0_)
        sint_tb = (lambda x, dx: x + dx)

    def dyn_step(x, u, dts, t_idx, refs):
        """Uniform step dispatch: rigid (x,u,dt) or augmented with the
        per-node contact activation pulled from refs."""
        if soft:
            return step_b(x, u, *_soft_inputs(x, dts, t_idx, refs))
        return step_b(x, u, dts)

    n_alphas = settings.n_alphas
    alphas_np = np.asarray([0.5 ** i for i in range(n_alphas)])

    packed = None if manifold else make_batched_cost_pack(model, params, spec)
    if packed is None:
        stage_cost_b = jax.vmap(cf.stage_cost, in_axes=(0, 0, None, None))
        term_cost_b = jax.vmap(cf.terminal_cost, in_axes=(0, None))
    else:
        stage_cost_b, term_cost_b = packed[2:]
    derivs_of = make_stage_derivs(model, params, spec, cf, cost_pack=packed)

    constraint_b = (
        jax.vmap(cf.constraint_derivs, in_axes=(0, 0, None, None))
        if nc > 0 else None
    )
    constraint_value_b = (
        jax.vmap(cf.constraints, in_axes=(0, 0, None, None))
        if nc > 0 else None
    )

    rho = float(settings.rho)

    # ------------------------------------------------------------------
    # node-parallel evaluations
    # ------------------------------------------------------------------
    def _gaps_of(x0s, xs, xnext):
        """Dynamics defects in TANGENT coords, [T+1, B, ntan]."""
        return jnp.concatenate(
            [sdiff_b(x0s, xs[0])[None], sdiff_tb(xnext, xs[1:])], axis=0)

    def cost_and_gaps(x0s, xs, us, refs):
        """(total cost [B], defects fs [T+1,B,ntan]) — the line-search merit
        terms.

        The cost SUM accumulates in the sweep dtype (f64 when sweep_f64 is
        live): near the optimum the per-step descent is O(kkt^2) ~ 1e-7 of
        a ~0.1 total — below f32 summation resolution, so f32 acceptance
        tests go blind and the filter line search limit-cycles (observed:
        T=100 chained CSQP oscillating at kkt ~1e-3 with every alpha
        rejected for stretches)."""
        B = xs.shape[1]
        nx = xs.shape[2]
        cdt = _sweep_dtype(xs.dtype, settings)
        x_flat, u_flat, dts_flat, t_idx = _flatten_nodes(xs, us, ts_np)
        costs = jax.vmap(
            lambda x, u, t: stage_cost_b(x, u, t, refs)
        )(xs[:-1], us, jnp.arange(T, dtype=jnp.int32))
        cost = (jnp.sum(costs.astype(cdt), axis=0)
                + term_cost_b(xs[-1], refs).astype(cdt))
        if manifold:
            xnext = jax.vmap(
                lambda x, u, t: cf.step(x, u, t, refs)
            )(x_flat, u_flat, t_idx).reshape(T, B, nx)
        else:
            xnext = dyn_step(
                x_flat, u_flat, dts_flat, t_idx, refs).reshape(T, B, nx)
        fs = _gaps_of(x0s, xs, xnext)
        return cost, fs

    def eval_gaps(x0s, xs, us, refs):
        _, fs = cost_and_gaps(x0s, xs, us, refs)
        return fs

    def constraint_vals(xs, us, refs):
        """Constraint values + bounds only (line-search merit), [T+1,B,nc]."""
        B = xs.shape[1]
        nu = us.shape[2]
        dtype = xs.dtype
        g, lb, ub = jax.vmap(
            lambda x, u, t: constraint_value_b(x, u, t, refs)
        )(xs[:-1], us, jnp.arange(T, dtype=jnp.int32))
        u0 = jnp.zeros((B, nu), dtype)
        gT, lbT, ubT = constraint_value_b(xs[-1], u0, T, refs)
        rmask = jnp.asarray(cf.terminal_constraint_row_mask)
        inf = jnp.asarray(jnp.inf, dtype)
        lbT = jnp.where(rmask, lbT, -inf)
        ubT = jnp.where(rmask, ubT, inf)
        g = jnp.concatenate([g, gT[None]])
        lb = jnp.concatenate([lb, jnp.broadcast_to(lbT, (1, B, nc))])
        ub = jnp.concatenate([ub, jnp.broadcast_to(ubT, (1, B, nc))])
        return g, lb, ub

    def constraints_of(xs, us, refs):
        """[T+1]-node constraint data; terminal keeps terminal-flagged rows
        (mirror of `csqp.constraint_all`). Time-major [T+1, B, nc, ...]."""
        B = xs.shape[1]
        nu = us.shape[2]
        dtype = xs.dtype
        g, lb, ub, Gx, Gu = jax.vmap(
            lambda x, u, t: constraint_b(x, u, t, refs)
        )(xs[:-1], us, jnp.arange(T, dtype=jnp.int32))
        u0 = jnp.zeros((B, nu), dtype)
        gT, lbT, ubT, GxT, _ = constraint_b(xs[-1], u0, T, refs)
        rmask = jnp.asarray(cf.terminal_constraint_row_mask)
        inf = jnp.asarray(jnp.inf, dtype)
        lbT = jnp.where(rmask, lbT, -inf)
        ubT = jnp.where(rmask, ubT, inf)
        g = jnp.concatenate([g, gT[None]])
        lb = jnp.concatenate([lb, jnp.broadcast_to(lbT, (1, B, nc))])
        ub = jnp.concatenate([ub, jnp.broadcast_to(ubT, (1, B, nc))])
        Gx = jnp.concatenate([Gx, GxT[None]])
        Gu = jnp.concatenate([Gu, jnp.zeros((1, B, nc, nu), dtype)])
        return g, lb, ub, Gx, Gu

    # ------------------------------------------------------------------
    # Riccati: factor once, then cheap vector sweeps (mim_solvers trick)
    # ------------------------------------------------------------------
    def factor(Fx_t, Fu_t, lxx_t, lxu_t, luu_t, vxx_term, reg):
        nu = Fu_t.shape[2]
        dtype = Fx_t.dtype
        eye_u = jnp.eye(nu, dtype=dtype)[:, :, None]

        def body(Vxx, inp):
            lxxn, lxun, luun, Fxn, Fun = inp
            M = _mm(Vxx, Fxn)
            N = _mm(Vxx, Fun)
            Qxx = lxxn + _mm_T1(Fxn, M)
            Qux = jnp.swapaxes(lxun, 0, 1) + _mm_T1(Fun, M)
            Quu = luun + _mm_T1(Fun, N) + reg[None, None, :] * eye_u
            Lr = _chol_lanes(Quu, nu)
            KK = _chol_solve_lanes(Lr, Qux, nu)
            QK = _mm_T1(Qux, KK)
            Vxx_new = Qxx - 0.5 * (QK + jnp.swapaxes(QK, 0, 1))
            Ld = jnp.stack(
                [jnp.stack([Lr[i][j] if j <= i else jnp.zeros_like(Lr[0][0])
                            for j in range(nu)]) for i in range(nu)])
            return Vxx_new, (Ld, KK, Vxx)

        _, (Ls, Ks, Vxx_next) = jax.lax.scan(
            body, vxx_term,
            (lxx_t, lxu_t, luu_t, Fx_t, Fu_t),
            reverse=True, unroll=scan_unroll(T))
        bad = ~(jnp.all(jnp.isfinite(Ls), axis=(0, 1, 2))
                & jnp.all(jnp.isfinite(Ks), axis=(0, 1, 2)))
        return Ls, Ks, Vxx_next, bad

    def chol_solve_dense(Ld, rhs, nu):
        """Solve (L L^T) x = rhs with Ld [nu,nu,B] dense lower, rhs [nu,B]."""
        y = [None] * nu
        for i in range(nu):
            s = rhs[i]
            for k in range(i):
                s = s - Ld[i, k] * y[k]
            y[i] = s / Ld[i, i]
        x = [None] * nu
        for i in reversed(range(nu)):
            s = y[i]
            for k in range(i + 1, nu):
                s = s - Ld[k, i] * x[k]
            x[i] = s / Ld[i, i]
        return jnp.stack(x)

    def vector_sweep(Ls, Ks, Vxx_next, Fx_t, Fu_t, rx_t, ru_t, rxT, fs_t):
        """Linear backward (vectors only, cached factors) then forward.

        rx_t [T,nx,B], ru_t [T,nu,B], rxT [nx,B], fs_t [T+1,nx,B].
        Returns dxs_t [T+1,nx,B], dus_t [T,nu,B], ks_t [T,nu,B],
        Qus_t [T,nu,B].
        """
        nu = Fu_t.shape[2]

        def bwd(Vx, inp):
            rxn, run, Fxn, Fun, fn, Ld, KK, Vxxn = inp
            Vxp = Vx + _mv(Vxxn, fn)
            Qx = rxn + _mv_T(Fxn, Vxp)
            Qu = run + _mv_T(Fun, Vxp)
            kk = chol_solve_dense(Ld, Qu, nu)
            Vx_new = Qx - _mv_T(KK, Qu)
            return Vx_new, (kk, Qu)

        _, (ks_t, Qus_t) = jax.lax.scan(
            bwd, rxT,
            (rx_t, ru_t, Fx_t, Fu_t, fs_t[1:], Ls, Ks, Vxx_next),
            reverse=True, unroll=scan_unroll(T))

        def fwd(dx, inp):
            kk, KK, Fxn, Fun, fn = inp
            du = -kk - _mv(KK, dx)
            dx_next = _mv(Fxn, dx) + _mv(Fun, du) + fn
            return dx_next, (dx, du)

        dxT, (dxs_t, dus_t) = jax.lax.scan(
            fwd, fs_t[0], (ks_t, Ks, Fx_t, Fu_t, fs_t[1:]),
            unroll=scan_unroll(T))
        dxs_t = jnp.concatenate([dxs_t, dxT[None]], axis=0)
        return dxs_t, dus_t, ks_t, Qus_t

    # ------------------------------------------------------------------
    # line search: sequential alpha ladder with per-scenario first-accept
    # (mim_solvers tries step lengths in order and usually accepts the
    # first; the while_loop exits as soon as every live scenario accepted,
    # so a warm-started tick costs ONE trial evaluation)
    # ------------------------------------------------------------------
    def trial_infeas(x0s, xs_t, us_t, refs):
        """(cost, gap+viol L1, viol_inf) of a trial trajectory."""
        cost_t, fs_t = cost_and_gaps(x0s, xs_t, us_t, refs)
        cdt = cost_t.dtype  # sweep dtype: f32 sums go blind near optimum
        gap = jnp.sum(jnp.abs(fs_t).astype(cdt), axis=(0, 2))  # L1
        if nc > 0:
            g, lb, ub = constraint_vals(xs_t, us_t, refs)
            v = _violation(g, lb, ub)
            viol_inf = jnp.max(v, axis=(0, 2))
            gap = gap + jnp.sum(v.astype(cdt), axis=(0, 2))
        else:
            viol_inf = jnp.zeros(cost_t.shape, xs_t.dtype)
        return cost_t, gap, viol_inf

    def line_search(x0s, xs, us, dxs, dus, refs, cost, infeas0, viol0,
                    skip):
        """Returns (accepted [B], xs_new, us_new, cost_new).

        Filter acceptance with a CONSTRAINT ENVELOPE on the cost branch:
        a cost-improving step is only accepted while the trial's max
        constraint violation stays within max(current, tol) — without the
        envelope the filter limit-cycles on boundary-riding optima
        (cost-branch steps dig into the band, feasibility-branch steps
        climb back out; measured 1.5-3.5 mm residual violation on the
        chained keep-away bench)."""
        B = xs.shape[1]
        dtype = xs.dtype
        alphas = jnp.asarray(alphas_np, dtype)
        vtol = jnp.asarray(
            max(settings.termination_tolerance, settings.envelope_tol),
            dtype)

        def cond(st):
            i, done = st[0], st[1]
            return (i < n_alphas) & ~jnp.all(done)

        def body(st):
            i, done, took, xs_b, us_b, cost_b = st
            alpha = alphas[i]
            xs_t = sint_tb(xs, alpha * dxs)  # retraction (manifold-safe)
            us_t = us + alpha * dus
            cost_t, infeas_t, viol_t = trial_infeas(x0s, xs_t, us_t, refs)
            finite = jnp.isfinite(cost_t) & jnp.isfinite(infeas_t)
            # the envelope never blocks REPAIR steps (they reduce viol and
            # pass trivially); it only rejects steps that trade constraint
            # violation for cost/gap progress. A scenario with no
            # admissible alpha holds its feasible iterate this iteration —
            # the safe choice for a physical robot.
            if settings.constraint_envelope and nc > 0:
                envelope = viol_t <= jnp.maximum(viol0, vtol)
            else:
                envelope = jnp.ones_like(viol_t, dtype=bool)
            accept = finite & envelope & (
                (cost_t < cost) | (infeas_t < infeas0 * (1.0 - 1e-8)))
            take = accept & ~done
            xs_b = jnp.where(take[None, :, None], xs_t, xs_b)
            us_b = jnp.where(take[None, :, None], us_t, us_b)
            cost_b = jnp.where(take, cost_t, cost_b)
            return (i + 1, done | take, took | take, xs_b, us_b, cost_b)

        init = (jnp.asarray(0, jnp.int32), skip,
                jnp.zeros((B,), bool), xs, us, cost)
        _, _, took, xs_b, us_b, cost_b = jax.lax.while_loop(cond, body, init)
        return took, xs_b, us_b, cost_b

    # ------------------------------------------------------------------
    def solve(x0s, refs, xs_in, us_in, max_iters=None,
              y0=None) -> BatchSQPSolution:
        """``max_iters``: optional RUNTIME iteration limit (int or scalar
        array). Lets one compiled program serve the reference's unlimited
        first solve, the per-tick budget, and the `max_solve_time` cap
        (`ocp_base_croco.py:160-171`) without recompiling. Defaults to the
        static ``settings.max_iters``; with ``trace=True`` the telemetry
        buffers stay sized by the static value (iterations past it drop).

        ``y0`` [B, T+1, nc]: scaled ADMM duals to warm-start from —
        normally the previous tick's `solution.y` (MPC dual warm start
        across solves). Default zeros (cold)."""
        limit = jnp.asarray(
            settings.max_iters if max_iters is None else max_iters, jnp.int32)
        xs = jnp.swapaxes(xs_in, 0, 1)  # [T+1, B, nx] time-major
        us = jnp.swapaxes(us_in, 0, 1)
        B = xs.shape[1]
        nx = xs.shape[2]
        nt = cf.ntan if manifold else nx  # tangent dim of steps/gains
        nu = us.shape[2]
        dtype = xs.dtype
        # sweep working dtype: f64 accumulation for the tiny per-node
        # recursions when the trajectory runs f32 (inert when x64 is off —
        # f64 would canonicalize back to f32 anyway)
        wdt = _sweep_dtype(dtype, settings)
        eps_abs = jnp.asarray(settings.eps_abs, dtype)
        eps_rel = jnp.asarray(settings.eps_rel, dtype)

        def iteration(carry):
            (xs, us, cost, kkt, converged, iters, qp_total, ks, Ks_d,
             reg, rho_b, y_carry) = carry[:12]
            tr = carry[12:]
            dyn, costs, term = derivs_of(xs, us, refs)
            xnext, Fx, Fu = dyn
            l, lx, lu, lxx, lxu, luu = costs
            fs = _gaps_of(x0s, xs, xnext)
            gap_l1 = jnp.sum(jnp.abs(fs).astype(wdt), axis=(0, 2))  # [B]
            gap_inf = jnp.max(jnp.abs(fs), axis=(0, 2))

            # batch-minor relayout (once per iteration); the Riccati
            # factorization / QP sweeps / KKT promote to f64 when enabled
            # (CSQPSettings.sweep_f64): the per-node [nx,nx] recursions are
            # a negligible FLOP fraction but set the f32 stationarity
            # floor (~1e-3 over T=100) that stalled the chained CSQP
            # (VERDICT r04 #4). Stage evaluation and line-search rollouts
            # stay in the trajectory dtype.
            w = lambda a: a.astype(wdt)  # noqa: E731
            Fx_t = w(jnp.transpose(Fx, (0, 2, 3, 1)))
            Fu_t = w(jnp.transpose(Fu, (0, 2, 3, 1)))
            lx_t = w(jnp.transpose(lx, (0, 2, 1)))
            lu_t = w(jnp.transpose(lu, (0, 2, 1)))
            lxx_t = w(jnp.transpose(lxx, (0, 2, 3, 1)))
            lxu_t = w(jnp.transpose(lxu, (0, 2, 3, 1)))
            luu_t = w(jnp.transpose(luu, (0, 2, 3, 1)))
            fs_t = w(jnp.transpose(fs, (0, 2, 1)))
            rxT = w(jnp.transpose(term.lx))
            vxxT = w(jnp.transpose(term.lxx, (1, 2, 0)))
            reg_w = w(reg)

            if nc > 0:
                g, lb, ub, Gx, Gu = constraints_of(xs, us, refs)
                viol = jnp.sum(
                    _violation(g, lb, ub).astype(wdt), axis=(0, 2))  # [B]
                viol_inf = jnp.max(_violation(g, lb, ub), axis=(0, 2))
                Gx_t = w(jnp.transpose(Gx, (0, 2, 3, 1)))  # [T+1,nc,nx,B]
                Gu_t = w(jnp.transpose(Gu, (0, 2, 3, 1)))
                # rho-augmented quadratics (fixed for this SQP iteration;
                # rho is per-scenario, adapted OSQP-style between iterations)
                rho_w = w(rho_b)
                rho4 = rho_w[None, None, None, :]
                gtg = lambda A, Bm: jnp.einsum("tcib,tcjb->tijb", A, Bm)
                lxx_q = lxx_t + rho4 * gtg(Gx_t[:-1], Gx_t[:-1])
                lxu_q = lxu_t + rho4 * gtg(Gx_t[:-1], Gu_t[:-1])
                luu_q = luu_t + rho4 * gtg(Gu_t[:-1], Gu_t[:-1])
                vxx_q = vxxT + rho_w[None, None, :] * _mm_T1(
                    Gx_t[-1], Gx_t[-1])
            else:
                viol = jnp.zeros((B,), wdt)
                viol_inf = jnp.zeros((B,), dtype)
                lxx_q, lxu_q, luu_q, vxx_q = lxx_t, lxu_t, luu_t, vxxT

            Ls, Ks, Vxx_next, bad = factor(
                Fx_t, Fu_t, lxx_q, lxu_q, luu_q, vxx_q, reg_w)

            if nc > 0:
                # ---- ADMM over the cached factorization ------------------
                lo = lb - g
                hi = ub - g
                lo_t = w(jnp.transpose(lo, (0, 2, 1)))  # [T+1, nc, B]
                hi_t = w(jnp.transpose(hi, (0, 2, 1)))

                def cvals_t(dxs_t, dus_t):
                    cx = jnp.sum(Gx_t * dxs_t[:, None, :, :], axis=2)
                    cu = jnp.sum(Gu_t[:-1] * dus_t[:, None, :, :], axis=2)
                    return cx + jnp.concatenate(
                        [cu, jnp.zeros_like(cu[:1])], axis=0)  # [T+1,nc,B]

                def sweep_with(z_t, y_t):
                    yz = y_t - z_t  # [T+1, nc, B]
                    rho3 = rho_w[None, None, :]
                    rx_t = lx_t + rho3 * jnp.sum(
                        Gx_t[:-1] * yz[:-1, :, None, :], axis=1)
                    ru_t = lu_t + rho3 * jnp.sum(
                        Gu_t[:-1] * yz[:-1, :, None, :], axis=1)
                    rxT_q = rxT + rho_w[None, :] * jnp.sum(
                        Gx_t[-1] * yz[-1, :, None, :], axis=0)
                    return vector_sweep(
                        Ls, Ks, Vxx_next, Fx_t, Fu_t, rx_t, ru_t, rxT_q, fs_t)

                # WARM-STARTED duals: y carries over from the previous SQP
                # iteration (mim_solvers warm-starts its QP the same way).
                # Cold-started duals make the outer loop creep on curved
                # active constraints (observed: a collision band violated by
                # ~9e-4 decaying ~1/k for hundreds of iterations).
                z0 = jnp.clip(jnp.zeros((T + 1, nc, B), wdt), lo_t, hi_t)
                y0 = w(y_carry)

                def admm_body(state):
                    (z, y, dxs_t, dus_t, ks_t, Qus_t, done, n,
                     rp0, rd0) = state
                    dxs2, dus2, ks2, Qus2 = sweep_with(z, y)
                    c = cvals_t(dxs2, dus2)
                    z2 = jnp.clip(c + y, lo_t, hi_t)
                    y2 = y + c - z2
                    rp = jnp.max(jnp.abs(c - z2), axis=(0, 1))  # [B]
                    dz = z2 - z
                    rd = rho_w * jnp.maximum(
                        jnp.max(jnp.abs(jnp.sum(
                            Gx_t * dz[:, :, None, :], axis=1)), axis=(0, 1)),
                        jnp.max(jnp.abs(jnp.sum(
                            Gu_t * dz[:, :, None, :], axis=1)), axis=(0, 1)))
                    tol = w(eps_abs) + w(eps_rel) * jnp.maximum(
                        jnp.max(jnp.abs(z2), axis=(0, 1)), 1.0)
                    # scenarios already done keep their state
                    keep = done
                    z_out = jnp.where(keep[None, None, :], z, z2)
                    y_out = jnp.where(keep[None, None, :], y, y2)
                    dxs_out = jnp.where(keep[None, None, :], dxs_t, dxs2)
                    dus_out = jnp.where(keep[None, None, :], dus_t, dus2)
                    ks_out = jnp.where(keep[None, None, :], ks_t, ks2)
                    Qus_out = jnp.where(keep[None, None, :], Qus_t, Qus2)
                    done2 = done | ((rp < tol) & (rd < tol))
                    n2 = n + (~keep).astype(n.dtype)
                    rp_out = jnp.where(keep, rp0, rp)
                    rd_out = jnp.where(keep, rd0, rd)
                    return (z_out, y_out, dxs_out, dus_out, ks_out, Qus_out,
                            done2, n2, rp_out, rd_out)

                def admm_cond(state):
                    done = state[6]
                    n = state[7]
                    return (jnp.max(n) < settings.max_qp_iters) & ~jnp.all(done)

                dxs0 = jnp.zeros((T + 1, nt, B), wdt)
                dus0 = jnp.zeros((T, nu, B), wdt)
                ks0 = jnp.zeros((T, nu, B), wdt)
                Qus0 = jnp.zeros((T, nu, B), wdt)
                inf_b = jnp.full((B,), jnp.inf, wdt)
                state = (z0, y0, dxs0, dus0, ks0, Qus0,
                         jnp.zeros((B,), bool), jnp.zeros((B,), jnp.int32),
                         inf_b, inf_b)
                (z, y, dxs_t, dus_t, ks_t, Qus_t, qp_done, qp_n,
                 rp_f, rd_f) = (
                    jax.lax.while_loop(admm_cond, admm_body, state))

                if settings.soc_iters > 0:
                    # ---- second-order (Maratos) correction -------------
                    # The ADMM step satisfies the LINEARIZED constraints;
                    # on a curved active boundary (e.g. the keep-away
                    # band with the goal pulling inside it) the true
                    # constraint at the trial point carries an
                    # O(|step|^2 * curvature) violation that plain SQP
                    # can only repair NEXT iteration — the classic
                    # Maratos effect (measured: 1.4-3.5 mm intrusion of a
                    # 20 mm band riding the boundary). Re-evaluate the
                    # NONLINEAR constraints at the trial point, shift the
                    # bounds by the curvature residual, and re-run a few
                    # warm-started ADMM iterations on the cached
                    # factorization.
                    dxs_b = jnp.transpose(dxs_t, (0, 2, 1)).astype(dtype)
                    dus_b = jnp.transpose(dus_t, (0, 2, 1)).astype(dtype)
                    xs_try = sint_tb(xs, dxs_b)
                    us_try = us + dus_b
                    g_try, _, _ = constraint_vals(xs_try, us_try, refs)
                    g_try_t = w(jnp.transpose(g_try, (0, 2, 1)))
                    d_t = (g_try_t - w(jnp.transpose(g, (0, 2, 1)))
                           - cvals_t(dxs_t, dus_t))
                    lo_soc = lo_t - d_t
                    hi_soc = hi_t - d_t

                    def soc_body(_, st):
                        z_s, y_s = st[0], st[1]
                        dxs2, dus2, ks2, Qus2 = sweep_with(z_s, y_s)
                        c = cvals_t(dxs2, dus2)
                        z2 = jnp.clip(c + y_s, lo_soc, hi_soc)
                        y2 = y_s + c - z2
                        return (z2, y2, dxs2, dus2, ks2, Qus2)

                    soc = jax.lax.fori_loop(
                        0, settings.soc_iters, soc_body,
                        (z, y, dxs_t, dus_t, ks_t, Qus_t))
                    # guard: SOC is a boundary-riding refinement; during
                    # large repair steps the curvature shift is stale and
                    # can WORSEN the true violation (measured). Keep the
                    # corrected step per scenario only when its true
                    # violation is not worse.
                    xs_soc = sint_tb(
                        xs, jnp.transpose(soc[2], (0, 2, 1)).astype(dtype))
                    us_soc = us + jnp.transpose(
                        soc[3], (0, 2, 1)).astype(dtype)
                    g_soc, lb_soc_v, ub_soc_v = constraint_vals(
                        xs_soc, us_soc, refs)
                    v_soc = jnp.max(
                        _violation(g_soc, lb_soc_v, ub_soc_v), axis=(0, 2))
                    v_try = jnp.max(
                        _violation(g_try, lb, ub), axis=(0, 2))
                    take_soc = v_soc <= v_try  # [B]
                    m3 = take_soc[None, None, :]
                    z = jnp.where(m3, soc[0], z)
                    y = jnp.where(m3, soc[1], y)
                    dxs_t = jnp.where(m3, soc[2], dxs_t)
                    dus_t = jnp.where(m3, soc[3], dus_t)
                    ks_t = jnp.where(m3, soc[4], ks_t)
                    Qus_t = jnp.where(m3, soc[5], Qus_t)
                # TRUE stationarity at the current iterate: Lagrangian
                # gradient in the reduced u-space with the inequality
                # multipliers mu = rho*y (mim_solvers KKT criterion,
                # VERDICT r03 #3). sweep_with(0, y) builds the linear terms
                # l* + G^T mu; its Qu output is the reduced gradient.
                _, _, _, Qus_kkt = sweep_with(jnp.zeros_like(z), y)
                # OSQP-style per-scenario rho adaptation for the NEXT SQP
                # iteration (mim_solvers adapts rho the same way; the cached
                # factorization is rebuilt each SQP iteration anyway)
                if settings.adaptive_rho:
                    rp_f = rp_f.astype(dtype)
                    rd_f = rd_f.astype(dtype)
                    ratio = jnp.sqrt((rp_f + 1e-12) / (rd_f + 1e-12))
                    rho_next = jnp.clip(
                        rho_b * jnp.clip(ratio, 0.2, 5.0), 1e-4, 1e4)
                    rho_next = jnp.where(
                        jnp.isfinite(rho_next), rho_next, rho_b)
                else:
                    rho_next = rho_b
            else:
                dxs_t, dus_t, ks_t, Qus_t = vector_sweep(
                    Ls, Ks, Vxx_next, Fx_t, Fu_t, lx_t, lu_t, rxT, fs_t)
                # unconstrained: Qu from the plain sweep IS the reduced
                # Lagrangian gradient
                Qus_kkt = Qus_t
                qp_n = jnp.ones((B,), jnp.int32)
                rho_next = rho_b

            step_bad = bad | ~(
                jnp.all(jnp.isfinite(dxs_t), axis=(0, 1))
                & jnp.all(jnp.isfinite(dus_t), axis=(0, 1)))
            # back to the trajectory dtype for the line-search rollouts
            dxs = jnp.transpose(dxs_t, (0, 2, 1)).astype(dtype)
            dus = jnp.transpose(dus_t, (0, 2, 1)).astype(dtype)
            dxs = jnp.where(step_bad[None, :, None], 0.0, dxs)
            dus = jnp.where(step_bad[None, :, None], 0.0, dus)

            # ---- filter line search (first-accept alpha ladder) ---------
            infeas0 = gap_l1 + viol
            skip = converged | step_bad
            any_accept, xs_best, us_best, cost_best = line_search(
                x0s, xs, us, dxs, dus, refs, cost, infeas0, viol_inf,
                skip)
            any_accept = any_accept & ~step_bad

            # honest KKT at the current iterate (pre-step): Lagrangian
            # stationarity (ADMM duals included in the constrained case) +
            # primal feasibility — the mim_solvers criterion.
            # A failed factorization keeps the previous value (NaN guard).
            kkt_raw = jnp.maximum(
                jnp.max(jnp.abs(Qus_kkt), axis=(0, 1)).astype(dtype),
                jnp.maximum(gap_inf, viol_inf))
            kkt_new = jnp.where(step_bad | ~jnp.isfinite(kkt_raw),
                                kkt, kkt_raw)

            # a scenario is live until it converges OR exhausts its own
            # iteration budget (mim_solvers `max_iters` is per solve; without
            # the cap here one diverging scenario would spin the while_loop
            # unboundedly once any other scenario's `iters` froze early)
            live = ~converged & (iters < limit)
            # KKT is measured at the CURRENT iterate: when it already meets
            # the tolerance, return this iterate — applying one more step
            # would hand back an unverified point (observed: the collision
            # band violated by ~2e-3 on a "converged" solve)
            conv_now = live & (kkt_new < settings.termination_tolerance)
            ok = any_accept & live & ~conv_now
            xs_out = jnp.where(ok[None, :, None], xs_best, xs)
            us_out = jnp.where(ok[None, :, None], us_best, us)
            cost_out = jnp.where(ok, cost_best, cost)
            kkt_out = jnp.where(live, kkt_new, kkt)
            ks_out = jnp.where(live[None, :, None],
                               jnp.transpose(ks_t, (0, 2, 1)).astype(dtype),
                               ks)
            Ks_out = jnp.where(live[None, :, None, None],
                               jnp.transpose(Ks, (0, 3, 1, 2)).astype(dtype),
                               Ks_d)
            iters_out = iters + live.astype(iters.dtype)
            qp_out = qp_total + jnp.where(live, qp_n, 0)
            conv_out = converged | conv_now
            # Levenberg-Marquardt schedule on the Quu regularization: grow on
            # failed factorizations / rejected steps, shrink on accepts —
            # required for float32 robustness at long horizons.
            reg_out = jnp.where(
                converged, reg,
                jnp.clip(
                    jnp.where(any_accept & ~step_bad,
                              reg / settings.reg_dec,
                              reg * settings.reg_inc),
                    settings.reg_min, settings.reg_max))
            rho_out = jnp.where(converged, rho_b, rho_next)
            if trace:
                tc, tk, tg = tr
                bidx = jnp.arange(B, dtype=jnp.int32)
                # dead scenarios scatter out of bounds and are dropped, so a
                # scenario that finished at the iteration cap keeps its final
                # row while other scenarios stay live
                idx = jnp.where(live, iters, settings.max_iters)
                tc = tc.at[idx, bidx].set(cost_out.astype(dtype),
                                          mode="drop")
                tk = tk.at[idx, bidx].set(kkt_new, mode="drop")
                tg = tg.at[idx, bidx].set(gap_inf, mode="drop")
                tr_out = (tc, tk, tg)
            else:
                tr_out = ()
            if nc > 0:
                # carry the MULTIPLIER mu = rho*y invariantly across the
                # OSQP rho adaptation: y is the scaled dual, so rescale
                y_scaled = (y.astype(dtype)
                            * (rho_b / rho_next)[None, None, :])
                y_next = jnp.where(live[None, None, :], y_scaled, y_carry)
            else:
                y_next = y_carry
            return (xs_out, us_out, cost_out, kkt_out, conv_out, iters_out,
                    qp_out, ks_out, Ks_out, reg_out, rho_out,
                    y_next) + tr_out

        cost0, _ = cost_and_gaps(x0s, xs, us, refs)
        init = (
            xs, us, cost0,
            jnp.full((B,), jnp.inf, dtype),
            jnp.zeros((B,), bool),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((T, B, nu), dtype),
            jnp.zeros((T, B, nu, nt), dtype),
            jnp.full((B,), settings.reg_init, dtype),
            jnp.full((B,), float(settings.rho), dtype),
            # ADMM dual carry, warm-startable from the previous solve
            (jnp.zeros((T + 1, max(nc, 1), B), dtype) if y0 is None
             else jnp.transpose(jnp.asarray(y0, dtype), (1, 2, 0))),
        )
        if trace:
            init = init + (
                jnp.full((settings.max_iters, B), jnp.nan, dtype),
                jnp.full((settings.max_iters, B), jnp.nan, dtype),
                jnp.full((settings.max_iters, B), jnp.nan, dtype),
            )
        # early-exit iteration loop: mim_solvers terminates on the KKT
        # criterion too (`termination_tolerance`, ocp_param_base.py:54-57);
        # warm-started MPC ticks typically converge in 2-4 iterations, so a
        # while_loop beats a masked fixed-trip scan on wall-clock.
        def loop_cond(carry):
            converged = carry[4]
            iters = carry[5]
            # run while any scenario is live (per-scenario budget)
            return ~jnp.all(converged | (iters >= limit))

        out = jax.lax.while_loop(loop_cond, iteration, init)
        (xs, us, cost, kkt, converged, iters, qp_total, ks, Ks, _reg,
         _rho, y_final) = out[:12]
        tr_final = out[12:]

        # final feasibility report (node-parallel)
        fs = eval_gaps(x0s, xs, us, refs)
        gap_inf = jnp.max(jnp.abs(fs), axis=(0, 2))
        if nc > 0:
            g, lb, ub, _, _ = constraints_of(xs, us, refs)
            cnorm = jnp.max(_violation(g, lb, ub), axis=(0, 2))
        else:
            cnorm = jnp.zeros_like(gap_inf)
        return BatchSQPSolution(
            xs=jnp.swapaxes(xs, 0, 1),
            us=jnp.swapaxes(us, 0, 1),
            K=jnp.swapaxes(Ks, 0, 1),
            k=jnp.swapaxes(ks, 0, 1),
            cost=cost.astype(dtype),
            kkt=kkt,
            gap_norm=gap_inf,
            constraint_norm=cnorm,
            iters=iters,
            qp_iters=qp_total,
            converged=converged,
            # re-scale for the NEXT solve's initial rho so the multiplier
            # mu = rho*y is what carries across solves, not the scaled y
            y=jnp.transpose(
                y_final * (_rho / jnp.asarray(float(settings.rho), dtype)
                           )[None, None, :], (2, 0, 1)),
            trace_cost=tr_final[0] if trace else None,
            trace_kkt=tr_final[1] if trace else None,
            trace_gap=tr_final[2] if trace else None,
        )

    return highest_precision(solve)
