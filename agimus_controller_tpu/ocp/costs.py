"""Cost/constraint assembly: compile a ProblemSpec into jitted stage functions.

This is the JAX-native replacement for Crocoddyl's CostModelSum +
DifferentialActionModelFreeFwdDynamics + IntegratedActionModelEuler +
ConstraintModelManager object graph (`ocp/ocp_croco_generic.py:560-762`):
the spec compiles once into pure functions

    step(x, u, t)                 -> x_next            (semi-implicit Euler)
    stage_cost(x, u, t, refs)     -> dt_t * l(x, u)    (running node)
    terminal_cost(x, refs)        -> l(x)              (unscaled, dt=0
                                      convention of `ocp_croco_generic.py:811`)
    stage_derivs / terminal_derivs -> Gauss-Newton derivative packs
    constraints(x, u, t, refs)    -> (g, lb, ub) and Jacobians

Derivative strategy: residual Jacobians via `jax.jacfwd` (shared primal work
is CSE'd by XLA), activation derivatives analytic, Hessians Gauss-Newton
(J^T diag(a'') J) — exactly Crocoddyl's approximation, which keeps the
Riccati pass positive definite.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..models.model import ModelParams, RobotModel
from ..ops import activations as act
from ..ops import integrator, residuals
from ..ops.soft_contact import soft_contact_step
from .spec import CostItem, ConstraintItem, ProblemSpec, make_timesteps, slice_refs


class StageDerivs(NamedTuple):
    cost: jnp.ndarray
    lx: jnp.ndarray
    lu: jnp.ndarray
    lxx: jnp.ndarray
    lxu: jnp.ndarray
    luu: jnp.ndarray
    xnext: jnp.ndarray
    Fx: jnp.ndarray
    Fu: jnp.ndarray


class TerminalDerivs(NamedTuple):
    cost: jnp.ndarray
    lx: jnp.ndarray
    lxx: jnp.ndarray


def _maybe_override_geoms(params: ModelParams, refs: Dict) -> ModelParams:
    """Moving obstacles: refs may carry full geometry placement overrides
    (the reference's `update_geometry_placement`, `ocp_base_croco.py:110-132`)."""
    if "geom_rot" in refs:
        params = params._replace(geom_rot=refs["geom_rot"])
    if "geom_trans" in refs:
        params = params._replace(geom_trans=refs["geom_trans"])
    return params


def _item_residual(item: CostItem, model: RobotModel, params: ModelParams,
                   x, u, rt: Dict):
    """Residual vector for one cost item at one node (refs pre-sliced)."""
    params = _maybe_override_geoms(params, rt)
    if item.kind == "state":
        xref = rt["xref"] if item.update else (
            jnp.asarray(item.static_ref, x.dtype) if item.static_ref else jnp.zeros_like(x))
        return residuals.state_residual(model, x, xref)
    if item.kind == "control":
        uref = rt["uref"] if item.update else (
            jnp.asarray(item.static_ref, x.dtype) if item.static_ref else jnp.zeros_like(u))
        return residuals.control_residual(u, uref)
    if item.kind == "control_grav":
        return residuals.control_grav_residual(model, params, x, u)
    fid = model.frame_id(item.frame) if item.frame else None
    if item.kind == "frame_placement":
        return residuals.frame_placement_residual(
            model, params, x, fid, rt[f"ee_rot:{item.frame}"], rt[f"ee_trans:{item.frame}"])
    if item.kind == "frame_translation":
        return residuals.frame_translation_residual(
            model, params, x, fid, rt[f"ee_trans:{item.frame}"])
    if item.kind == "frame_rotation":
        return residuals.frame_rotation_residual(
            model, params, x, fid, rt[f"ee_rot:{item.frame}"])
    if item.kind == "frame_velocity":
        return residuals.frame_velocity_residual(
            model, params, x, fid, rt[f"ee_vel:{item.frame}"], item.reference_frame)
    if item.kind == "visual_servoing":
        return residuals.visual_servoing_residual(
            model, params, x, fid,
            rt[f"wMo_rot:{item.object_frame}"], rt[f"wMo_trans:{item.object_frame}"],
            rt[f"ee_rot:{item.frame}"], rt[f"ee_trans:{item.frame}"])
    if item.kind == "collision_distance":
        return residuals.collision_distance_residual(model, params, x, item.pair_id)
    if item.kind == "force_tracking":
        # soft-contact force cost: r = f - f_des (force part of the state,
        # reference `dam.f_des/f_weight`, `ocp_croco_generic_force_feedback.py:141-150`)
        return x[model.nx:] - rt["f_des"]
    raise ValueError(item.kind)


def _item_act_weights(item: CostItem, model: RobotModel, rt: Dict, dtype, nc=0):
    """Runtime activation weight vector for weighted_quad items."""
    nr = item.residual_dim(model, nc)
    if item.update:
        if item.kind == "state":
            return rt["w_x"]
        if item.kind == "force_tracking":
            return rt["w_force"]
        if item.kind in ("control", "control_grav"):
            return rt["w_u"]
        if item.kind in ("frame_placement", "visual_servoing"):
            return rt[f"w_ee:{item.frame}"]
        if item.kind == "frame_rotation":
            return rt[f"w_ee:{item.frame}"][:3]
        if item.kind == "frame_translation":
            return rt[f"w_ee:{item.frame}"][3:]
        if item.kind == "frame_velocity":
            return rt[f"w_ee_vel:{item.frame}"]
    if item.act_weights is not None:
        w = jnp.asarray(item.act_weights, dtype)
        return jnp.broadcast_to(w, (nr,)) if w.ndim == 0 or w.shape[0] != nr else w
    return jnp.ones((nr,), dtype)


def _item_weight(item: CostItem, rt: Dict, dtype):
    """Scalar cost weight; collision items scale by the streamed
    w_collision_avoidance when update=True."""
    w = jnp.asarray(item.weight, dtype)
    if item.kind == "collision_distance" and item.update:
        w = w * rt["w_coll"]
    return w


def _item_activation(item: CostItem):
    if item.activation == "weighted_quad":
        return (act.weighted_quad_value, act.weighted_quad_dr, act.weighted_quad_drr)
    if item.activation == "exp":
        a = item.act_alpha
        return (
            lambda r, w: act.exp_value(r, w, a),
            lambda r, w: act.exp_dr(r, w, a),
            lambda r, w: act.exp_drr(r, w, a),
        )
    if item.activation == "quad_exp":
        a = item.act_alpha
        return (
            lambda r, w: act.quad_exp_value(r, w, a),
            lambda r, w: act.quad_exp_dr(r, w, a),
            lambda r, w: act.quad_exp_drr(r, w, a),
        )
    raise ValueError(item.activation)


class CostFunctions(NamedTuple):
    step: callable
    stage_cost: callable
    terminal_cost: callable
    stage_derivs: callable
    terminal_derivs: callable
    constraints: callable  # (x, u, t, refs) -> (g, lb, ub) or None
    constraint_derivs: callable  # adds (Gx, Gu)
    n_constraints: int
    terminal_constraint_mask: Tuple[bool, ...]  # per constraint item
    terminal_constraint_row_mask: Tuple[bool, ...]  # per stacked residual row
    cost_breakdown: callable = None  # per-cost (value, residual) dict at a node
    cost_derivs: callable = None  # GN cost pack without dynamics
    # Lie-group state semantics (None = plain vector state). When set, the
    # solvers use these for gaps/rollout and all derivative blocks are in
    # tangent coordinates of dimension ntan (reference: StateMultibody
    # diff/integrate, `factory/robot_model.py:17`).
    state_diff: callable = None  # (x1, x0) -> tangent [ntan]
    state_integrate: callable = None  # (x, dx[ntan]) -> x
    ntan: int = None


def build_cost_functions(
    model: RobotModel, params: ModelParams, spec: ProblemSpec, dtype=jnp.float32
) -> CostFunctions:
    timesteps = make_timesteps(spec, dtype)
    nc = spec.nc
    sc = spec.soft_contact

    def step(x, u, t, refs):
        dt = timesteps[t]
        if sc is not None:
            active = refs["contact_active"][t]
            return soft_contact_step(model, params, sc, x, u, dt, active)
        return integrator.euler_step(model, params, x, u, dt)

    def _cost_sum(items, x, u, rt, dtype):
        total = jnp.zeros((), dtype)
        for item in items:
            if not item.active:
                continue
            value, _, _ = _item_activation(item)
            r = _item_residual(item, model, params, x, u, rt)
            w = _item_act_weights(item, model, rt, dtype, nc)
            total = total + _item_weight(item, rt, dtype) * value(r, w)
        return total

    def stage_cost(x, u, t, refs):
        rt = slice_refs(refs, t)
        return timesteps[t] * _cost_sum(spec.running_costs, x, u, rt, x.dtype)

    def cost_breakdown(x, u, t, refs, terminal=False):
        """Per-cost values + residuals at one node — the debugger's live
        cost-bar-chart data (reference `MPCDebuggerNode._evaluate_ocp`,
        `mpc_debugger_node.py:269-328`, which re-runs calc/calcDiff)."""
        items = spec.terminal_costs if terminal else spec.running_costs
        rt = slice_refs(refs, t)
        out = {}
        for item in items:
            if not item.active:
                continue
            value, _, _ = _item_activation(item)
            r = _item_residual(item, model, params, x, u, rt)
            w = _item_act_weights(item, model, rt, x.dtype, nc)
            out[item.name] = (
                _item_weight(item, rt, x.dtype) * value(r, w), r)
        return out

    def terminal_cost(x, refs):
        rt = slice_refs(refs, spec.horizon)
        u0 = jnp.zeros((model.nv,), x.dtype)
        return _cost_sum(spec.terminal_costs, x, u0, rt, x.dtype)

    def _gn_derivs(items, x, u, rt, with_u: bool):
        nx, nu = model.nx + nc, model.nv
        dtype = x.dtype
        l = jnp.zeros((), dtype)
        lx = jnp.zeros((nx,), dtype)
        lu = jnp.zeros((nu,), dtype)
        lxx = jnp.zeros((nx, nx), dtype)
        lxu = jnp.zeros((nx, nu), dtype)
        luu = jnp.zeros((nu, nu), dtype)
        for item in items:
            if not item.active:
                continue
            value, dr, drr = _item_activation(item)
            w_act = _item_act_weights(item, model, rt, dtype, nc)
            w_cost = _item_weight(item, rt, dtype)
            r_fn = lambda xx, uu: _item_residual(item, model, params, xx, uu, rt)
            r = r_fn(x, u)
            a_dr = dr(r, w_act)
            a_drr = drr(r, w_act)
            l = l + w_cost * value(r, w_act)
            u_dep = item.kind in ("control", "control_grav")
            # residual Jacobians (analytic where trivial, jacfwd otherwise)
            if item.kind == "control":
                Ju = jnp.eye(nu, dtype=dtype)
                lu = lu + w_cost * a_dr
                luu = luu + w_cost * jnp.diag(a_drr)
            elif item.kind == "control_grav":
                Jx = jax.jacfwd(lambda xx: r_fn(xx, u))(x)
                Ju = jnp.eye(nu, dtype=dtype)
                lx = lx + w_cost * (Jx.T @ a_dr)
                lu = lu + w_cost * a_dr
                lxx = lxx + w_cost * (Jx.T * a_drr) @ Jx
                lxu = lxu + w_cost * (Jx.T * a_drr)
                luu = luu + w_cost * jnp.diag(a_drr)
            else:
                Jx = jax.jacfwd(lambda xx: r_fn(xx, u))(x)
                lx = lx + w_cost * (Jx.T @ a_dr)
                lxx = lxx + w_cost * (Jx.T * a_drr) @ Jx
        if not with_u:
            return l, lx, lxx
        return l, lx, lu, lxx, lxu, luu

    def cost_derivs(x, u, t, refs):
        """dt-scaled Gauss-Newton cost pack only (no dynamics) — used by the
        batch-native solver, which supplies dynamics from the component-form
        kernels (`ops/batched_dynamics.py`)."""
        rt = slice_refs(refs, t)
        dt = timesteps[t]
        l, lx, lu, lxx, lxu, luu = _gn_derivs(spec.running_costs, x, u, rt, True)
        return dt * l, dt * lx, dt * lu, dt * lxx, dt * lxu, dt * luu

    def stage_derivs(x, u, t, refs) -> StageDerivs:
        l, lx, lu, lxx, lxu, luu = cost_derivs(x, u, t, refs)
        step_local = lambda xx, uu: step(xx, uu, t, refs)
        xnext = step_local(x, u)
        Fx = jax.jacfwd(step_local, argnums=0)(x, u)
        Fu = jax.jacfwd(step_local, argnums=1)(x, u)
        return StageDerivs(l, lx, lu, lxx, lxu, luu, xnext, Fx, Fu)

    def terminal_derivs(x, refs) -> TerminalDerivs:
        rt = slice_refs(refs, spec.horizon)
        u0 = jnp.zeros((model.nv,), x.dtype)
        l, lx, lxx = _gn_derivs(spec.terminal_costs, x, u0, rt, False)
        return TerminalDerivs(l, lx, lxx)

    # ------------------------------------------------------------------
    # constraints
    # ------------------------------------------------------------------
    c_items = spec.constraints
    n_con = sum(c.residual_dim(model, nc) for c in c_items)
    term_mask = tuple(c.terminal for c in c_items)
    term_row_mask = tuple(
        flag for c in c_items for flag in [c.terminal] * c.residual_dim(model, nc)
    )

    def _con_residual(c: ConstraintItem, x, u, rt):
        if c.kind == "control_limit":
            return u
        if c.kind == "force_box":
            # IAMSoftContactAugmented appends force bounds to the node
            # constraints (`ocp_croco_generic_force_feedback.py:191-215`)
            return x[model.nx:]
        as_cost = CostItem(
            name=c.name, kind=c.kind, frame=c.frame, pair_id=c.pair_id,
            reference_frame=c.reference_frame, update=False,
        )
        return _item_residual(as_cost, model, params, x, u, rt)

    def _bounds(c: ConstraintItem, dtype):
        nr = c.residual_dim(model, nc)
        if c.kind == "control_limit":
            # default: +-effortLimit (reference ConstraintModelControlLimit);
            # explicit lower/upper tighten/override the box
            lim = jnp.asarray(params.effort_limit, dtype)
            lo = jnp.broadcast_to(
                jnp.asarray(c.lower, dtype), (nr,)) if c.lower else -lim
            hi = jnp.broadcast_to(
                jnp.asarray(c.upper, dtype), (nr,)) if c.upper else lim
            return lo, hi
        if c.kind == "force_box" and not c.lower and not c.upper and sc is not None:
            lo = (jnp.asarray(sc.force_lb, dtype) if sc.force_lb
                  else jnp.full((nr,), -jnp.inf, dtype))
            hi = (jnp.asarray(sc.force_ub, dtype) if sc.force_ub
                  else jnp.full((nr,), jnp.inf, dtype))
            return jnp.broadcast_to(lo, (nr,)), jnp.broadcast_to(hi, (nr,))
        lo = jnp.asarray(c.lower, dtype) if c.lower else jnp.full((nr,), -jnp.inf, dtype)
        hi = jnp.asarray(c.upper, dtype) if c.upper else jnp.full((nr,), jnp.inf, dtype)
        return jnp.broadcast_to(lo, (nr,)), jnp.broadcast_to(hi, (nr,))

    def constraints(x, u, t, refs):
        if not c_items:
            return None
        rt = slice_refs(refs, t)
        gs, lbs, ubs = [], [], []
        for c in c_items:
            g = jnp.atleast_1d(_con_residual(c, x, u, rt))
            lo, hi = _bounds(c, x.dtype)
            gs.append(g)
            lbs.append(lo)
            ubs.append(hi)
        return jnp.concatenate(gs), jnp.concatenate(lbs), jnp.concatenate(ubs)

    def constraint_derivs(x, u, t, refs):
        if not c_items:
            return None
        g, lb, ub = constraints(x, u, t, refs)
        Gx = jax.jacfwd(lambda xx: constraints(xx, u, t, refs)[0])(x)
        Gu = jax.jacfwd(lambda uu: constraints(x, uu, t, refs)[0])(u)
        return g, lb, ub, Gx, Gu

    return CostFunctions(
        step=step,
        stage_cost=stage_cost,
        terminal_cost=terminal_cost,
        cost_breakdown=cost_breakdown,
        cost_derivs=cost_derivs,
        stage_derivs=stage_derivs,
        terminal_derivs=terminal_derivs,
        constraints=constraints,
        constraint_derivs=constraint_derivs,
        n_constraints=n_con,
        terminal_constraint_mask=term_mask,
        terminal_constraint_row_mask=term_row_mask,
    )
