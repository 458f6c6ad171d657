"""Component-form batched Gauss-Newton cost packs.

Companion to `batched_dynamics.py`: the generic cost path evaluates residual
Jacobians with per-sample `jacfwd` over tiny-op FK graphs (the same layout
problem as the dynamics). Here the standard cost set of the reference's OCPs
(state / control / control-grav / frame-placement) is assembled directly on
`[B]`-component arrays; frame-placement Jacobians come from
`jax.linearize` over a component-form FK + log6 (tangents stay `[B]`-shaped,
so the whole pack fuses into full-lane elementwise kernels).

Falls back to the generic vmapped path for cost kinds not covered
(`fddp_batch.make_batch_fddp` decides per spec).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import ModelParams, RobotModel
from ..ocp.spec import CostItem, ProblemSpec
from . import activations as act
from .batched_dynamics import (
    _StackedModel,
    _StaticModel,
    _add,
    _cross,
    _dot,
    _joint_transforms,
    _matmul,
    _mattvec,
    _matvec,
    _scale,
    _sub,
)

SUPPORTED_KINDS = (
    "state",
    "control",
    "control_grav",
    "frame_placement",
    "frame_translation",
    "frame_rotation",
    "frame_velocity",
    "visual_servoing",
    "collision_distance",
)

# x-only residual kinds routed through the generic linearize-based GN path
_X_ONLY_KINDS = (
    "frame_placement",
    "frame_translation",
    "frame_rotation",
    "frame_velocity",
    "visual_servoing",
    "collision_distance",
)


def _fk_world(sm: _StaticModel, q: List):
    """World placements of every joint in component form (unrolled chain)."""
    Xs = _joint_transforms(sm, q)
    oR, op = [], []
    for i in range(sm.nj):
        R, p = Xs[i]
        par = sm.parents[i]
        if par < 0:
            oR.append(R)
            op.append(p)
        else:
            oR.append(_matmul(oR[par], R))
            op.append(_add(_matvec(oR[par], p), op[par]))
    return oR, op


def _frame_placement_c(model: RobotModel, params: ModelParams,
                       sm: _StaticModel, q: List, frame_id: int):
    """(R, p) of an operational frame, component form."""
    fr = model.frames[frame_id]
    # numpy-convert the WHOLE leaf before indexing: jax stages getitem on
    # concrete arrays inside traced code, which would yield a tracer here
    fR = tuple(float(v) for v in np.asarray(params.frame_rot)[frame_id].reshape(-1))
    fp = tuple(float(v) for v in np.asarray(params.frame_trans)[frame_id])
    oR, op = _fk_world(sm, q)
    j = fr.parent_joint
    R = _matmul(oR[j], fR)
    p = _add(_matvec(oR[j], fp), op[j])
    return R, p


def _quat_c(R):
    """Branchless rotation-matrix -> quaternion [x,y,z,w], component form
    (same candidate-select construction as `spatial.matrix_to_quat`)."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = R
    tr = m00 + m11 + m22
    cands = [
        ((1.0 + m00 - m11 - m22), (m01 + m10), (m02 + m20), (m21 - m12)),
        ((m01 + m10), (1.0 - m00 + m11 - m22), (m12 + m21), (m02 - m20)),
        ((m02 + m20), (m12 + m21), (1.0 - m00 - m11 + m22), (m10 - m01)),
        ((m21 - m12), (m02 - m20), (m10 - m01), (1.0 + tr)),
    ]
    scores = [m00, m11, m22, tr]
    best = scores[0]
    out = list(cands[0])
    for s, c in zip(scores[1:], cands[1:]):
        take = s > best
        best = jnp.where(take, s, best)
        out = [jnp.where(take, cc, oo) for cc, oo in zip(c, out)]
    n = jnp.sqrt(out[0] ** 2 + out[1] ** 2 + out[2] ** 2 + out[3] ** 2)
    return tuple(o / n for o in out)


def _atan2_unit_fq(s, c):
    """atan2(s, c) restricted to the first quadrant of the unit circle
    (s, c >= 0, s^2 + c^2 = 1) from square roots and one polynomial, without
    the `atan2` primitive. Three exact half-angle reductions map the angle
    into [0, pi/8] where an odd Taylor to w^19 is ~2e-16 accurate:

        t = tan(phi/2) = s / (1 + c),   u = tan(phi/4),  w = tan(phi/8)
    """
    t = s / (1.0 + c)
    u = t / (1.0 + jnp.sqrt(1.0 + t * t))
    w = u / (1.0 + jnp.sqrt(1.0 + u * u))
    w2 = w * w
    S = -1.0 / 19.0
    for d in (17.0, -15.0, 13.0, -11.0, 9.0, -7.0, 5.0, -3.0, 1.0):
        S = 1.0 / d + w2 * S
    return 8.0 * w * S  # phi = 8 * atan(w)


def _log3_c(R):
    """SO(3) log, component form (quaternion/atan2 route of `spatial.log3`)."""
    qx, qy, qz, qw = _quat_c(R)
    sign = jnp.where(qw < 0.0, -1.0, 1.0)
    qx, qy, qz = qx * sign, qy * sign, qz * sign
    c = jnp.abs(qw)
    s2 = qx * qx + qy * qy + qz * qz
    # float32-robust branch: s2 carries ~1e-12 of rounding noise near the
    # identity, and theta/s vs its 2/c limit agree to ~s2 there — a 1e-8
    # threshold keeps the Jacobian branch choice deterministic across
    # backends without losing accuracy
    small = s2 < 1e-8
    s = jnp.sqrt(jnp.where(small, jnp.ones_like(s2), s2))
    theta = 2.0 * _atan2_unit_fq(s, c)
    scale = jnp.where(small, 2.0 / c, theta / s)
    return (scale * qx, scale * qy, scale * qz)


def _log6_c(R, p):
    """SE(3) log -> ([w; v] 6-tuple), mirrors `spatial.log6`."""
    w = _log3_c(R)
    t2 = _dot(w, w)
    small = t2 < 1e-8
    t2s = jnp.where(small, jnp.ones_like(t2), t2)
    th = jnp.sqrt(t2s)
    half = th * 0.5
    sin_half = jnp.where(small, jnp.ones_like(th), jnp.sin(half))
    coef = jnp.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * jnp.cos(half) / sin_half) / t2s)
    # V^-1 p = p - 0.5 w x p + coef * w x (w x p)
    wxp = _cross(w, p)
    wwxp = _cross(w, wxp)
    v = tuple(p[i] - 0.5 * wxp[i] + coef * wwxp[i] for i in range(3))
    return w + v  # 6-tuple


def _ancestors_static(model: RobotModel, joint: int):
    out = []
    j = joint
    while j >= 0:
        out.append(j)
        j = model.parents[j]
    return out[::-1]


def _frame_pose_c(model: RobotModel, params: ModelParams, oR, op,
                  frame_id: int):
    """(R, p) of frame `frame_id` from world joint placements (components)."""
    fr = model.frames[frame_id]
    fR = tuple(float(x) for x in np.asarray(params.frame_rot)[frame_id].reshape(-1))
    fp = tuple(float(x) for x in np.asarray(params.frame_trans)[frame_id])
    j = fr.parent_joint
    return _matmul(oR[j], fR), _add(_matvec(oR[j], fp), op[j])


def _frame_velocity_c(model: RobotModel, sm: _StaticModel, oR, op,
                      v: List, frame_id: int, reference_frame: str,
                      Rf, pf):
    """Spatial velocity [w(3); v(3)] 6-tuple of a frame, component form.

    Mirrors `kinematics.frame_velocity` (= frame_jacobian @ v with pinocchio
    LOCAL / WORLD / LOCAL_WORLD_ALIGNED conventions, `kinematics.py:79-128`)."""
    fr = model.frames[frame_id]
    zero3 = (0.0, 0.0, 0.0)
    w, v0 = zero3, zero3  # world spatial twist at the world origin
    for i in _ancestors_static(model, fr.parent_joint):
        ax = sm.axis[i]
        if sm.types[i] == "revolute":
            Sw = _matvec(oR[i], ax)
            col_w = Sw
            col_v = _cross(op[i], Sw)  # R Sv (=0) + p x (R Sw)
        else:
            col_w = zero3
            col_v = _matvec(oR[i], ax)
        w = _add(w, _scale(v[i], col_w))
        v0 = _add(v0, _scale(v[i], col_v))
    if reference_frame == "world":
        return w + v0
    # v at the frame origin: v0 - pf x w  (motion_act_inv's v - p x w term)
    v_at = _sub(v0, _cross(pf, w))
    if reference_frame == "local":
        return _mattvec(Rf, w) + _mattvec(Rf, v_at)
    # local_world_aligned: local parts rotated back to world
    return w + v_at


def _capsule_distance_c(R1, p1, r1, l1, R2, p2, r2, l2):
    """Signed capsule-capsule distance, component form. Mirrors
    `collision.capsule_capsule_distance` (branch-free Ericson clamps)."""
    d1 = (R1[2], R1[5], R1[8])  # local z column
    d2 = (R2[2], R2[5], R2[8])
    r = _sub(p1, p2)
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    b = _dot(d1, d2)
    c = _dot(d1, r)
    f = _dot(d2, r)
    denom = a * e - b * b
    denom_safe = jnp.where(denom < 1e-9, jnp.ones_like(denom), denom)
    s = jnp.where(denom < 1e-9, jnp.zeros_like(denom),
                  (b * f - c * e) / denom_safe)
    s = jnp.clip(s, -l1, l1)
    e_safe = jnp.where(e < 1e-12, jnp.ones_like(e), e)
    t = (b * s + f) / e_safe
    t_cl = jnp.clip(t, -l2, l2)
    a_safe = jnp.where(a < 1e-12, jnp.ones_like(a), a)
    s = jnp.clip((b * t_cl - c) / a_safe, -l1, l1)
    c1 = _add(p1, _scale(s, d1))
    c2 = _add(p2, _scale(t_cl, d2))
    diff = _sub(c1, c2)
    dist = jnp.sqrt(_dot(diff, diff) + 1e-12)
    return dist - r1 - r2


def _geom_placement_c(model: RobotModel, params: ModelParams, oR, op,
                      gi: int, refs):
    """World placement of collision geometry `gi`, component form. Local
    placements come from refs overrides when present (moving obstacles,
    the reference's `update_geometry_placement`, `ocp_base_croco.py:110-132`)."""
    g = model.geometries[gi]
    if "geom_rot" in refs:
        gRa = refs["geom_rot"][gi]
        gR = tuple(gRa[r, c] for r in range(3) for c in range(3))
    else:
        gR = tuple(float(x) for x in np.asarray(params.geom_rot)[gi].reshape(-1))
    if "geom_trans" in refs:
        gpa = refs["geom_trans"][gi]
        gp = tuple(gpa[i] for i in range(3))
    else:
        gp = tuple(float(x) for x in np.asarray(params.geom_trans)[gi])
    if g.parent_joint < 0:
        return gR, gp
    j = g.parent_joint
    return _matmul(oR[j], gR), _add(_matvec(oR[j], gp), op[j])


def make_batched_cost_pack(
    model: RobotModel, params: ModelParams, spec: ProblemSpec, dtype=jnp.float32
):
    """Build `pack(x [B,nx], u [B,nu], t, refs) -> (l, lx, lu, lxx, lxu, luu)`
    (all `[B, ...]`, dt-scaled) and `term_pack(x, refs)`.

    Returns None when the spec uses cost kinds outside SUPPORTED_KINDS or a
    soft-contact state (caller falls back to the generic path)."""
    if spec.soft_contact is not None:
        return None
    for item in spec.all_costs():
        if item.kind not in SUPPORTED_KINDS:
            return None
        if item.activation != "weighted_quad" and item.kind not in _X_ONLY_KINDS:
            return None
    sm = _StaticModel(model, params)
    nj = sm.nj
    nx = 2 * nj
    timesteps = jnp.asarray(spec.timesteps(), dtype)

    # ------------------------------------------------------------------
    # Component-native assembly.
    #
    # Derivative blocks are carried as nested python lists of [B] scalars
    # (or python-float 0.0 for structural zeros, or shape-() tracers for
    # state-independent entries like activation weights) and stacked into
    # dense [B, ...] arrays exactly ONCE per pack. The dense-per-item
    # einsum route lowers to [B, 14, 14] batched tiny matmuls that no
    # matrix unit runs well; the component MAC loops fuse into large
    # elementwise kernels instead.
    # ------------------------------------------------------------------

    def _cadd(a, b):
        if isinstance(a, float) and a == 0.0:
            return b
        if isinstance(b, float) and b == 0.0:
            return a
        return a + b

    def _cscale(s, a):
        if isinstance(a, float) and a == 0.0:
            return 0.0
        return s * a

    def _acc_vec(acc, contrib, wgt):
        return [_cadd(a, _cscale(wgt, c)) for a, c in zip(acc, contrib)]

    def _acc_mat(acc, contrib, wgt):
        return [[_cadd(a, _cscale(wgt, c)) for a, c in zip(ar, cr)]
                for ar, cr in zip(acc, contrib)]

    def item_terms(item: CostItem, x, u, t, refs, B, with_u):
        """-> (l [B], lx_c, lu_c, lxx_c, lxu_c, luu_c) component
        contributions (None where the item has no such block)."""
        if item.kind == "state":
            xref = refs["xref"][t] if item.update else (
                jnp.asarray(item.static_ref, x.dtype) if item.static_ref
                else jnp.zeros((nx,), x.dtype))
            w = refs["w_x"][t] if item.update else (
                jnp.broadcast_to(jnp.asarray(item.act_weights, x.dtype), (nx,))
                if item.act_weights is not None else jnp.ones((nx,), x.dtype))
            r_c = [x[:, i] - xref[i] for i in range(nx)]
            lx_c = [w[i] * r_c[i] for i in range(nx)]
            l = 0.5 * sum(lx_c[i] * r_c[i] for i in range(nx))
            lxx_c = [[w[i] if i == j else 0.0 for j in range(nx)]
                     for i in range(nx)]
            return l, lx_c, None, lxx_c, None, None
        if item.kind == "control":
            uref = refs["uref"][t] if item.update else (
                jnp.asarray(item.static_ref, x.dtype) if item.static_ref
                else jnp.zeros((nj,), x.dtype))
            w = refs["w_u"][t] if item.update else (
                jnp.broadcast_to(jnp.asarray(item.act_weights, x.dtype), (nj,))
                if item.act_weights is not None else jnp.ones((nj,), x.dtype))
            r_c = [u[:, i] - uref[i] for i in range(nj)]
            lu_c = [w[i] * r_c[i] for i in range(nj)]
            l = 0.5 * sum(lu_c[i] * r_c[i] for i in range(nj))
            luu_c = [[w[i] if i == j else 0.0 for j in range(nj)]
                     for i in range(nj)]
            return l, None, lu_c, None, None, luu_c
        if item.kind == "control_grav":
            w = refs["w_u"][t] if item.update else (
                jnp.broadcast_to(jnp.asarray(item.act_weights, x.dtype), (nj,))
                if item.act_weights is not None else jnp.ones((nj,), x.dtype))
            from .analytic_derivs import gravity_torque_with_dq

            tau_g, Dg = gravity_torque_with_dq(
                sm, [x[:, i] for i in range(nj)])
            r_c = [u[:, i] - tau_g[i] for i in range(nj)]
            wr_c = [w[i] * r_c[i] for i in range(nj)]
            l = 0.5 * sum(wr_c[i] * r_c[i] for i in range(nj))
            lu_c = wr_c
            luu_c = [[w[i] if i == j else 0.0 for j in range(nj)]
                     for i in range(nj)]
            # residual Jacobians: J_u = I, J_x = [-dg/dq, 0]
            lx_c = [0.0] * nx
            lxu_c = [[0.0] * nj for _ in range(nx)]
            lxx_c = [[0.0] * nx for _ in range(nx)]
            for i in range(nj):
                s = 0.0
                for r in range(nj):
                    if not isinstance(Dg[r][i], float):
                        s = _cadd(s, Dg[r][i] * wr_c[r])
                        lxu_c[i][r] = -(w[r] * Dg[r][i])
                lx_c[i] = _cscale(-1.0, s)
            for i in range(nj):
                for j in range(i, nj):
                    s = 0.0
                    for r in range(nj):
                        if not (isinstance(Dg[r][i], float)
                                or isinstance(Dg[r][j], float)):
                            s = _cadd(s, w[r] * Dg[r][i] * Dg[r][j])
                    lxx_c[i][j] = s
                    lxx_c[j][i] = s
            return l, lx_c, lu_c, lxx_c, lxu_c, luu_c
        if item.kind in _X_ONLY_KINDS:
            nr = item.residual_dim(model)
            fid = model.frame_id(item.frame) if item.frame else None

            def _pose_target():
                """(refR components [9], refp components [3]) at node t."""
                if item.kind == "visual_servoing":
                    # wMf_target = wMo_vision * oMf_target
                    # (`ocp_croco_generic.py:436-495`)
                    wR = refs[f"wMo_rot:{item.object_frame}"]
                    wp = refs[f"wMo_trans:{item.object_frame}"]
                    oR_ = refs[f"ee_rot:{item.frame}"][t]
                    op_ = refs[f"ee_trans:{item.frame}"][t]
                    wRc = tuple(wR[r, c] for r in range(3) for c in range(3))
                    oRc = tuple(oR_[r, c] for r in range(3) for c in range(3))
                    R = _matmul(wRc, oRc)
                    p = _add(_matvec(wRc, tuple(op_[i] for i in range(3))),
                             tuple(wp[i] for i in range(3)))
                    return R, p
                Ra = refs[f"ee_rot:{item.frame}"][t]
                pa = refs[f"ee_trans:{item.frame}"][t]
                return (tuple(Ra[r, c] for r in range(3) for c in range(3)),
                        tuple(pa[i] for i in range(3)))

            def r_flat(xx):
                q = [xx[:, i] for i in range(nj)]
                oR, op = _fk_world(sm, q)
                if item.kind == "frame_velocity":
                    v = [xx[:, nj + i] for i in range(nj)]
                    Rf, pf = _frame_pose_c(model, params, oR, op, fid)
                    nu = _frame_velocity_c(
                        model, sm, oR, op, v, fid,
                        item.reference_frame, Rf, pf)
                    ref_nu = refs[f"ee_vel:{item.frame}"][t]
                    return jnp.stack(
                        tuple(nu[i] - ref_nu[i] for i in range(6)), axis=1)
                if item.kind == "collision_distance":
                    gi, gj = model.collision_pairs[item.pair_id]
                    R1, p1 = _geom_placement_c(model, params, oR, op, gi, refs)
                    R2, p2 = _geom_placement_c(model, params, oR, op, gj, refs)
                    ri = float(np.asarray(params.geom_radius)[gi])
                    li = float(np.asarray(params.geom_halflen)[gi])
                    rj = float(np.asarray(params.geom_radius)[gj])
                    lj = float(np.asarray(params.geom_halflen)[gj])
                    d = _capsule_distance_c(R1, p1, ri, li, R2, p2, rj, lj)
                    return d[:, None]  # [B, 1]
                raise ValueError(item.kind)

            def _world_joint_twists(oR, op):
                """World twist columns (w, v_at_origin) of each ancestor
                joint of the frame's parent joint; None for non-ancestors."""
                fr = model.frames[fid]
                cols = [None] * nj
                for k in _ancestors_static(model, fr.parent_joint):
                    ax = sm.axis[k]
                    if sm.types[k] == "revolute":
                        wk = _matvec(oR[k], ax)
                        cols[k] = (wk, _cross(op[k], wk))
                    else:
                        cols[k] = (None, _matvec(oR[k], ax))
                return cols

            # Jc[o][i]: residual Jacobian components ([B] scalars / 0.0),
            # o < nr, i < nx
            Jc = [[0.0] * nx for _ in range(nr)]

            if item.kind in ("frame_placement", "visual_servoing",
                             "frame_rotation", "frame_translation"):
                # analytic frame Jacobian + tangents only through the small
                # log map (6 or 3 dims) instead of nj full FK+log passes
                q = [x[:, i] for i in range(nj)]
                oR, op = _fk_world(sm, q)
                Rf, pf = _frame_pose_c(model, params, oR, op, fid)
                refR, refp = _pose_target()
                rRT = (refR[0], refR[3], refR[6], refR[1], refR[4],
                       refR[7], refR[2], refR[5], refR[8])
                twists = _world_joint_twists(oR, op)

                if item.kind == "frame_translation":
                    r = jnp.stack(_sub(pf, refp), axis=1)  # [B, 3]
                    for k, tw in enumerate(twists):
                        if tw is None:
                            continue
                        wk, v0 = tw
                        # d p / d q_k = v0 + w x p (velocity of the frame
                        # origin under the joint's unit twist)
                        dp = _add(v0, _cross(wk, pf)) if wk is not None else v0
                        for o in range(3):
                            Jc[o][k] = dp[o]
                else:
                    dR = _matmul(rRT, Rf)
                    dp = _matvec(rRT, _sub(pf, refp))
                    rot_only = item.kind == "frame_rotation"
                    ndelta = 3 if rot_only else 6

                    def log_of_delta(delta):
                        # D exp(dlt) to first order: R' = dR (I + [w x]),
                        # p' = dR v + dp ; exact at delta = 0 where the
                        # linearization is taken
                        wd = (delta[:, 0], delta[:, 1], delta[:, 2])
                        wx = (0.0, -wd[2], wd[1],
                              wd[2], 0.0, -wd[0],
                              -wd[1], wd[0], 0.0)
                        Rp = _add(dR, _matmul(dR, wx))
                        if rot_only:
                            return jnp.stack(_log3_c(Rp), axis=1)
                        vd = (delta[:, 3], delta[:, 4], delta[:, 5])
                        pp = _add(_matvec(dR, vd), dp)
                        return jnp.stack(_log6_c(Rp, pp), axis=1)

                    zero_d = jnp.zeros((B, ndelta), x.dtype)
                    r, lin = jax.linearize(log_of_delta, zero_d)
                    # Jlog columns as components: [nr][ndelta] of [B]
                    Jl = [[None] * ndelta for _ in range(nr)]
                    for s_ in range(ndelta):
                        e = jnp.zeros((ndelta,), x.dtype).at[s_].set(1.0)
                        col = lin(jnp.broadcast_to(e, (B, ndelta)))  # [B, nr]
                        for o in range(nr):
                            Jl[o][s_] = col[:, o]

                    # local frame Jacobian columns: delta = Jf dq
                    rows = [[0.0] * nj for _ in range(ndelta)]
                    RfT = (Rf[0], Rf[3], Rf[6], Rf[1], Rf[4], Rf[7],
                           Rf[2], Rf[5], Rf[8])
                    for k, tw in enumerate(twists):
                        if tw is None:
                            continue
                        wk, v0 = tw
                        if wk is not None:
                            wl = _matvec(RfT, wk)
                            v_at = _add(v0, _cross(wk, pf))
                            for o in range(3):
                                rows[o][k] = wl[o]
                        else:
                            v_at = v0
                        if not rot_only:
                            vl = _matvec(RfT, v_at)
                            for o in range(3):
                                rows[3 + o][k] = vl[o]
                    # Jc = Jlog @ Jf, component MACs
                    for o in range(nr):
                        for k in range(nj):
                            s = 0.0
                            for s_ in range(ndelta):
                                if not isinstance(rows[s_][k], float):
                                    s = _cadd(s, Jl[o][s_] * rows[s_][k])
                            Jc[o][k] = s
            elif item.kind == "collision_distance":
                # scalar residual: ONE reverse pull instead of nj tangents
                r, pull = jax.vjp(r_flat, x)
                (Jx,) = pull(jnp.ones_like(r))
                for i in range(nj):
                    Jc[0][i] = Jx[:, i]
            else:  # frame_velocity: generic tangents (x-dependent residual)
                r, lin = jax.linearize(r_flat, x)  # r [B, nr]
                for i in range(nx):
                    e = jnp.zeros((nx,), x.dtype).at[i].set(1.0)
                    col = lin(jnp.broadcast_to(e, (B, nx)))  # [B, nr]
                    for o in range(nr):
                        Jc[o][i] = col[:, o]

            # activation weights (mirrors costs._item_act_weights)
            if item.update and item.kind in ("frame_placement",
                                             "visual_servoing"):
                w = refs[f"w_ee:{item.frame}"][t]
            elif item.update and item.kind == "frame_rotation":
                w = refs[f"w_ee:{item.frame}"][t][:3]
            elif item.update and item.kind == "frame_translation":
                w = refs[f"w_ee:{item.frame}"][t][3:]
            elif item.update and item.kind == "frame_velocity":
                w = refs[f"w_ee_vel:{item.frame}"][t]
            elif item.act_weights is not None:
                wv = jnp.asarray(item.act_weights, x.dtype)
                w = jnp.broadcast_to(wv, (nr,)) if (
                    wv.ndim == 0 or wv.shape[0] != nr) else wv
            else:
                w = jnp.ones((nr,), x.dtype)

            if item.activation == "weighted_quad":
                l = act.weighted_quad_value(r, w[None])
                a_dr = act.weighted_quad_dr(r, w[None])
                a_drr = jnp.broadcast_to(w[None], r.shape)
            elif item.activation == "exp":
                l = act.exp_value(r, w, item.act_alpha)
                a_dr = act.exp_dr(r, w, item.act_alpha)
                a_drr = act.exp_drr(r, w, item.act_alpha)
            else:  # quad_exp
                l = act.quad_exp_value(r, w, item.act_alpha)
                a_dr = act.quad_exp_dr(r, w, item.act_alpha)
                a_drr = act.quad_exp_drr(r, w, item.act_alpha)

            adr_c = [a_dr[:, o] for o in range(nr)]
            adrr_c = [a_drr[:, o] for o in range(nr)]
            lx_c = [0.0] * nx
            lxx_c = [[0.0] * nx for _ in range(nx)]
            # scaled rows JW[o][i] = a_drr[o] * Jc[o][i] shared across lxx
            JW = [[_cscale_arr(adrr_c[o], Jc[o][i]) for i in range(nx)]
                  for o in range(nr)]
            for i in range(nx):
                s = 0.0
                for o in range(nr):
                    if not isinstance(Jc[o][i], float):
                        s = _cadd(s, Jc[o][i] * adr_c[o])
                lx_c[i] = s
            for i in range(nx):
                for j in range(i, nx):
                    s = 0.0
                    for o in range(nr):
                        if not (isinstance(JW[o][i], float)
                                or isinstance(Jc[o][j], float)):
                            s = _cadd(s, JW[o][i] * Jc[o][j])
                    lxx_c[i][j] = s
                    lxx_c[j][i] = s
            return l, lx_c, None, lxx_c, None, None
        raise ValueError(item.kind)

    def _cscale_arr(s, a):
        if isinstance(a, float) and a == 0.0:
            return 0.0
        return s * a

    def assemble(items, x, u, t, refs, with_u: bool):
        """Accumulate all items in component form; returns components."""
        B = x.shape[0]
        l = jnp.zeros((B,), x.dtype)
        lx = [0.0] * nx
        lu = [0.0] * nj
        lxx = [[0.0] * nx for _ in range(nx)]
        lxu = [[0.0] * nj for _ in range(nx)]
        luu = [[0.0] * nj for _ in range(nj)]
        for item in items:
            if not item.active:
                continue
            wgt = item.weight
            if item.kind == "collision_distance" and item.update:
                # streamed w_collision_avoidance scale (`trajectory.py:84-158`)
                wgt = wgt * refs["w_coll"][t]
            li, lxi, lui, lxxi, lxui, luui = item_terms(
                item, x, u, t, refs, B, with_u)
            l = l + wgt * li
            if lxi is not None:
                lx = _acc_vec(lx, lxi, wgt)
            if lui is not None:
                lu = _acc_vec(lu, lui, wgt)
            if lxxi is not None:
                lxx = _acc_mat(lxx, lxxi, wgt)
            if lxui is not None:
                lxu = _acc_mat(lxu, lxui, wgt)
            if luui is not None:
                luu = _acc_mat(luu, luui, wgt)
        return l, lx, lu, lxx, lxu, luu

    def _stack_vec(comps, B, dtype_, scale=None):
        cols = []
        for c in comps:
            if scale is not None:
                c = _cscale(scale, c)
            if isinstance(c, float):
                cols.append(jnp.full((B,), c, dtype_))
            else:
                cols.append(jnp.broadcast_to(jnp.asarray(c, dtype_), (B,)))
        return jnp.stack(cols, axis=1)

    def _stack_mat(comps, B, dtype_, scale=None):
        return jnp.stack(
            [_stack_vec(row, B, dtype_, scale) for row in comps], axis=1)

    def pack(x, u, t, refs):
        dt_ = timesteps[t]
        B = x.shape[0]
        dtp = x.dtype
        l, lx, lu, lxx, lxu, luu = assemble(
            spec.running_costs, x, u, t, refs, True)
        return (dt_ * l,
                _stack_vec(lx, B, dtp, dt_),
                _stack_vec(lu, B, dtp, dt_),
                _stack_mat(lxx, B, dtp, dt_),
                _stack_mat(lxu, B, dtp, dt_),
                _stack_mat(luu, B, dtp, dt_))

    def term_pack(x, refs):
        u0 = jnp.zeros((x.shape[0], nj), x.dtype)
        B = x.shape[0]
        l, lx, _, lxx, _, _ = assemble(
            spec.terminal_costs, x, u0, spec.horizon, refs, False)
        return l, _stack_vec(lx, B, x.dtype), _stack_mat(lxx, B, x.dtype)

    def value(x, u, t, refs):
        l, *_ = assemble(spec.running_costs, x, u, t, refs, True)
        return timesteps[t] * l

    def term_value(x, refs):
        u0 = jnp.zeros((x.shape[0], nj), x.dtype)
        l, *_ = assemble(spec.terminal_costs, x, u0, spec.horizon, refs, False)
        return l

    return pack, term_pack, value, term_value
