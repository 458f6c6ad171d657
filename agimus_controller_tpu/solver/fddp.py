"""Feasibility-driven DDP solver (Crocoddyl `SolverFDDP` semantics) in JAX.

JAX-native replacement for the unconstrained path of mim_solvers/Crocoddyl
(reference call site: `OCPBaseCroco.solve`, `ocp_base_croco.py:142-182`).
Everything is a fixed-shape jitted program:

- stage derivatives are evaluated for ALL nodes at once with `jax.vmap`
  (the reference parallelizes this with OpenMP threads across the horizon,
  `ocp_base_croco.py:62`; here it is one fused batched evaluation),
- the backward Riccati recursion is a `lax.scan` over the horizon,
- the line search evaluates the whole ladder of step lengths as one extra
  batched rollout (`vmap` over alpha) and selects the first acceptable step
  — semantically identical to Crocoddyl's sequential try-and-accept,
- iterations run to a fixed `max_iters` with a convergence mask making
  converged iterations no-ops (XLA-friendly early exit),
- divergence is handled with the standard Levenberg-Marquardt schedule on
  the Quu regularization.

The solver is dtype-polymorphic and contains no data-dependent Python
control flow, so it vmaps over scenario batches and pjits over meshes.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ocp.costs import CostFunctions
from .precision import highest_precision


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static solver configuration (mirrors `OCPParamsBaseCroco`,
    `ocp_param_base.py:31-85`, solver side)."""

    max_iters: int = 10
    n_alphas: int = 10  # step ladder alpha_i = 0.5 ** i
    termination_tolerance: float = 1e-3  # KKT inf-norm
    reg_init: float = 1e-9
    reg_min: float = 1e-9
    reg_max: float = 1e9
    reg_inc: float = 10.0
    reg_dec: float = 10.0
    use_filter_line_search: bool = True  # mim_solvers default in the reference
    accept_ratio: float = 0.1  # fraction of expected decrease to accept


class Solution(NamedTuple):
    xs: jnp.ndarray  # [T+1, nx]
    us: jnp.ndarray  # [T, nu]
    K: jnp.ndarray  # [T, nu, nx] Riccati feedback gains
    k: jnp.ndarray  # [T, nu] feed-forward corrections (last pass)
    cost: jnp.ndarray
    kkt: jnp.ndarray  # KKT inf-norm (criterion of mim_solvers SQP)
    gap_norm: jnp.ndarray
    iters: jnp.ndarray
    reg: jnp.ndarray
    converged: jnp.ndarray


def _total_cost(cf: CostFunctions, T: int, xs, us, refs):
    ts = jnp.arange(T)
    running = jax.vmap(lambda x, u, t: cf.stage_cost(x, u, t, refs))(xs[:-1], us, ts)
    return jnp.sum(running) + cf.terminal_cost(xs[-1], refs)


def _state_ops(cf: CostFunctions):
    """(difference, integrate) — vector ops unless the cost functions carry
    Lie-group state semantics (quaternion free-flyer, `ops/lie.py`; the
    reference's `StateMultibody.diff/integrate`)."""
    sdiff = cf.state_diff if cf.state_diff is not None else (
        lambda x1, x0_: x1 - x0_)
    sint = cf.state_integrate if cf.state_integrate is not None else (
        lambda x, dx: x + dx)
    return sdiff, sint


def _gaps(cf: CostFunctions, x0, xs, xnexts):
    sdiff, _ = _state_ops(cf)
    f0 = sdiff(x0, xs[0])[None]
    return jnp.concatenate(
        [f0, jax.vmap(sdiff)(xnexts, xs[1:])], axis=0)  # [T+1, ntan]


def _backward(derivs, term, fs, reg):
    """Riccati sweep with FDDP gap folding. Returns gains + expected model."""
    VxT, VxxT = term.lx, term.lxx

    def body(carry, inp):
        Vx, Vxx, d1, d2 = carry
        lx, lu, lxx, lxu, luu, Fx, Fu, f_next = inp
        Vx_plus = Vx + Vxx @ f_next  # fold the next-node gap (FDDP)
        Qx = lx + Fx.T @ Vx_plus
        Qu = lu + Fu.T @ Vx_plus
        Qxx = lxx + Fx.T @ Vxx @ Fx
        Qux = lxu.T + Fu.T @ Vxx @ Fx
        Quu = luu + Fu.T @ Vxx @ Fu + reg * jnp.eye(lu.shape[0], dtype=lu.dtype)
        L = jnp.linalg.cholesky(Quu)
        kk = jax.scipy.linalg.cho_solve((L, True), Qu)
        KK = jax.scipy.linalg.cho_solve((L, True), Qux)
        Vx_new = Qx - Qux.T @ kk
        Vxx_new = Qxx - Qux.T @ KK
        Vxx_new = 0.5 * (Vxx_new + Vxx_new.T)
        d1 = d1 + jnp.dot(Qu, kk)
        d2 = d2 + jnp.dot(kk, Quu @ kk)
        return (Vx_new, Vxx_new, d1, d2), (kk, KK, Qu)

    inputs = (
        derivs.lx, derivs.lu, derivs.lxx, derivs.lxu, derivs.luu,
        derivs.Fx, derivs.Fu, fs[1:],
    )
    zero = jnp.zeros((), VxT.dtype)
    (Vx, Vxx, d1, d2), (ks, Ks, Qus) = jax.lax.scan(
        body, (VxT, VxxT, zero, zero), inputs, reverse=True
    )
    diverged = ~jnp.all(jnp.isfinite(ks)) | ~jnp.all(jnp.isfinite(Ks))
    return ks, Ks, Qus, d1, d2, diverged


def _forward(cf: CostFunctions, T, x0, xs, us, ks, Ks, fs, alpha, refs):
    """Feasibility-driven rollout at step length alpha: gaps contract by
    (1 - alpha) (Crocoddyl FDDP forwardPass semantics)."""
    sdiff, sint = _state_ops(cf)
    x_init = sint(x0, -(1.0 - alpha) * fs[0])

    def body(x, inp):
        xref, uref, kk, KK, f_next, t = inp
        u = uref - alpha * kk - KK @ sdiff(x, xref)
        xn = sint(cf.step(x, u, t, refs), -(1.0 - alpha) * f_next)
        return xn, (xn, u)

    ts = jnp.arange(T)
    _, (xs_new, us_new) = jax.lax.scan(
        body, x_init, (xs[:-1], us, ks, Ks, fs[1:], ts)
    )
    xs_try = jnp.concatenate([x_init[None], xs_new], axis=0)
    cost_try = _total_cost(cf, T, xs_try, us_new, refs)
    return xs_try, us_new, cost_try


@highest_precision
def solve_fddp(
    cf: CostFunctions,
    x0,
    refs,
    xs_init,
    us_init,
    settings: SolverSettings = SolverSettings(),
) -> Solution:
    """Solve the OCP from a warm start. Pure & jittable; `vmap` to batch."""
    T = us_init.shape[0]
    dtype = xs_init.dtype
    alphas = jnp.asarray([0.5**i for i in range(settings.n_alphas)], dtype)

    def derivs_of(xs, us):
        ts = jnp.arange(T)
        d = jax.vmap(lambda x, u, t: cf.stage_derivs(x, u, t, refs))(xs[:-1], us, ts)
        term = cf.terminal_derivs(xs[-1], refs)
        return d, term

    def iteration(carry, _):
        xs, us, cost, reg, kkt, converged, iters, ks, Ks = carry

        d, term = derivs_of(xs, us)
        fs = _gaps(cf, x0, xs, d.xnext)
        gap_norm = jnp.max(jnp.abs(fs))
        ks_new, Ks_new, Qus, d1, d2, diverged = _backward(d, term, fs, reg)
        kkt_new = jnp.maximum(jnp.max(jnp.abs(Qus)), gap_norm)

        # line search over the whole alpha ladder in one batched rollout
        xs_a, us_a, cost_a = jax.vmap(
            lambda a: _forward(cf, T, x0, xs, us, ks_new, Ks_new, fs, a, refs)
        )(alphas)
        finite = jnp.all(jnp.isfinite(cost_a.reshape(settings.n_alphas, -1)), axis=-1) & (
            jnp.all(jnp.isfinite(xs_a.reshape(settings.n_alphas, -1)), axis=-1)
        )
        expected = alphas * d1 - 0.5 * alphas**2 * d2
        reduction = cost - cost_a
        if settings.use_filter_line_search:
            # mim_solvers filter: accept if cost OR infeasibility improves.
            # The FDDP rollout contracts gaps *exactly* to (1-alpha)*fs by
            # construction, so the trial gap norm needs no recomputation.
            gaps_a = (1.0 - alphas) * gap_norm
            # a feasible iterate (gap below tolerance) must not accept on
            # the infeasibility criterion — (1-a)*gap < gap holds for ANY
            # step then, which would admit cost-increasing steps
            # (mim_solvers gates the filter on feasibility the same way)
            infeasible = gap_norm > 1e-9
            accept = finite & ((reduction > 0.0) | (
                infeasible & (gaps_a < gap_norm * (1.0 - 1e-6))))
        else:
            # Goldstein-style acceptance against the expected model
            accept = finite & jnp.where(
                expected > 0.0,
                reduction >= settings.accept_ratio * expected,
                reduction > 0.0,
            )
        any_accept = jnp.any(accept)
        best = jnp.argmax(accept)  # first True = largest accepted step

        step_ok = any_accept & ~diverged
        xs_next = jnp.where(step_ok, xs_a[best], xs)
        us_next = jnp.where(step_ok, us_a[best], us)
        cost_next = jnp.where(step_ok, cost_a[best], cost)
        reg_next = jnp.clip(
            jnp.where(step_ok, reg / settings.reg_dec, reg * settings.reg_inc),
            settings.reg_min,
            settings.reg_max,
        )

        newly_converged = kkt_new < settings.termination_tolerance
        # masked early exit: once converged, iterations are identity
        xs_out = jnp.where(converged, xs, xs_next)
        us_out = jnp.where(converged, us, us_next)
        cost_out = jnp.where(converged, cost, cost_next)
        reg_out = jnp.where(converged, reg, reg_next)
        kkt_out = jnp.where(converged, kkt, kkt_new)
        ks_out = jnp.where(converged, ks, ks_new)
        Ks_out = jnp.where(converged, Ks, Ks_new)
        iters_out = iters + jnp.where(converged, 0, 1)
        conv_out = converged | newly_converged
        return (
            xs_out, us_out, cost_out, reg_out, kkt_out, conv_out, iters_out,
            ks_out, Ks_out,
        ), None

    cost0 = _total_cost(cf, T, xs_init, us_init, refs)
    reg0 = jnp.asarray(settings.reg_init, dtype)
    kkt0 = jnp.asarray(jnp.inf, dtype)
    ntan = cf.ntan if cf.ntan is not None else xs_init.shape[1]
    ks0 = jnp.zeros((T, us_init.shape[1]), dtype)
    Ks0 = jnp.zeros((T, us_init.shape[1], ntan), dtype)
    init = (
        xs_init, us_init, cost0, reg0, kkt0, jnp.asarray(False), jnp.asarray(0),
        ks0, Ks0,
    )
    (xs, us, cost, reg, kkt, converged, iters, ks, Ks), _ = jax.lax.scan(
        iteration, init, None, length=settings.max_iters
    )
    # final KKT + gains from the solution point (the published Riccati gains,
    # reference `ocp_results.ricatti_gains`, `ocp_base_croco.py:172-177`)
    d, term = derivs_of(xs, us)
    fs = _gaps(cf, x0, xs, d.xnext)
    ks_f, Ks_f, Qus, d1, d2, diverged = _backward(d, term, fs, jnp.asarray(settings.reg_min, dtype))
    kkt_f = jnp.maximum(jnp.max(jnp.abs(Qus)), jnp.max(jnp.abs(fs)))
    return Solution(
        xs=xs,
        us=us,
        K=jnp.where(diverged, Ks, Ks_f),
        k=jnp.where(diverged, ks, ks_f),
        cost=cost,
        kkt=kkt_f,
        gap_norm=jnp.max(jnp.abs(fs)),
        iters=iters,
        reg=reg,
        converged=converged | (kkt_f < settings.termination_tolerance),
    )
