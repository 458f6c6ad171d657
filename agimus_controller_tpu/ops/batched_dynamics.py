"""Component-form batched dynamics: the throughput kernel path.

Why this exists: the straightforward `vmap(euler_step)` lowers to
thousands of tiny ops on `[B, 3, 3]`-shaped arrays, whose trailing 3x3
dimensions fit no vector unit. Here every *scalar* of the rigid-body
computation is a `[B]` array (structure dims live in Python tuples, not
array dims), so XLA fuses the whole step into large elementwise kernels with
the batch dim mapped straight onto the vector lanes — the CusADi-style
"scalar SSA over the batch" layout (PAPERS.md), with no hand-written kernels
needed.

Also uses the cheap derivative route: for fd(q,v,tau) = M~^-1 (tau - b),
  d a / d(q,v) = -M~^-1 * d rnea(q,v,a) / d(q,v)   (a held fixed)
  d a / d tau  =  M~^-1
so stage Jacobians cost 14 RNEA tangents + triangular solves instead of 21
tangents of the full step (jax.linearize shares the primal).

Model constants are baked in as Python floats (static for a given robot);
model-parameter sweeps keep using the general `ops.dynamics` path.
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import ModelParams, RobotModel

Vec3 = Tuple  # 3-tuple of [B] arrays (or python floats for constants)
Mat3 = Tuple  # 9-tuple, row-major


def _cross(a: Vec3, b: Vec3) -> Vec3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _scale(s, a):
    return tuple(s * x for x in a)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _matvec(R: Mat3, v: Vec3) -> Vec3:
    return (
        R[0] * v[0] + R[1] * v[1] + R[2] * v[2],
        R[3] * v[0] + R[4] * v[1] + R[5] * v[2],
        R[6] * v[0] + R[7] * v[1] + R[8] * v[2],
    )


def _mattvec(R: Mat3, v: Vec3) -> Vec3:
    return (
        R[0] * v[0] + R[3] * v[1] + R[6] * v[2],
        R[1] * v[0] + R[4] * v[1] + R[7] * v[2],
        R[2] * v[0] + R[5] * v[1] + R[8] * v[2],
    )


def _matmul(A: Mat3, B: Mat3) -> Mat3:
    out = []
    for i in range(3):
        for j in range(3):
            out.append(
                A[3 * i + 0] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j]
            )
    return tuple(out)


def _axis_rotation(axis, q) -> Mat3:
    """Rodrigues about a unit axis (components: python floats fold at trace,
    or traced scalars in the scan form)."""
    x, y, z = axis[0], axis[1], axis[2]
    c = jnp.cos(q)
    s = jnp.sin(q)
    t = 1.0 - c
    return (
        t * x * x + c, t * x * y - s * z, t * x * z + s * y,
        t * x * y + s * z, t * y * y + c, t * y * z - s * x,
        t * x * z - s * y, t * y * z + s * x, t * z * z + c,
    )


class _StaticModel:
    """Model constants as plain Python floats (trace-time constants)."""

    def __init__(self, model: RobotModel, params: ModelParams):
        self.nj = model.nj
        self.parents = model.parents
        self.types = model.joint_types
        # plain Python floats (weak-typed): np.float64 scalars would promote
        # float32 arrays to float64 under jax_enable_x64 (dtype-mismatched
        # vjp, and slow)
        p = lambda a: tuple(
            float(v) for v in np.asarray(a, dtype=np.float64).reshape(-1))
        self.joint_rot = [p(params.joint_rot[i]) for i in range(model.nj)]
        self.joint_trans = [p(params.joint_trans[i]) for i in range(model.nj)]
        self.axis = [p(params.axis[i]) for i in range(model.nj)]
        self.mass = [float(params.mass[i]) for i in range(model.nj)]
        self.com = [p(params.com[i]) for i in range(model.nj)]
        self.inertia = [p(params.inertia[i]) for i in range(model.nj)]
        self.armature = [float(params.armature[i]) for i in range(model.nj)]
        self.gravity = p(params.gravity)


def _joint_X(sm: _StaticModel, i: int, qi):
    Rj = sm.joint_rot[i]
    pj = sm.joint_trans[i]
    if sm.types[i] == "revolute":
        return _matmul(Rj, _axis_rotation(sm.axis[i], qi)), pj
    ax = sm.axis[i]
    disp = _matvec(Rj, _scale(qi, ax))
    return Rj, _add(pj, disp)


def _joint_transforms(sm: _StaticModel, q: List):
    return [_joint_X(sm, i, q[i]) for i in range(sm.nj)]


def _rnea_c(sm: _StaticModel, q: List, v: List, a: List, Xs=None) -> List:
    """Component-form RNEA. q/v/a: lists of [B] arrays. Returns tau list."""
    nj = sm.nj
    if Xs is None:
        Xs = _joint_transforms(sm, q)
    vels, accs, frcs = [], [], []
    zero3 = (0.0, 0.0, 0.0)
    g = sm.gravity
    for i in range(nj):
        R, p = Xs[i]
        par = sm.parents[i]
        vp = vels[par] if par >= 0 else (zero3, zero3)
        ap = accs[par] if par >= 0 else (zero3, (-g[0], -g[1], -g[2]))
        # motion_act_inv: w = R^T w_p ; v = R^T (v_p - p x w_p)
        wi = _mattvec(R, vp[0])
        vi = _mattvec(R, _sub(vp[1], _cross(p, vp[0])))
        wai = _mattvec(R, ap[0])
        vai = _mattvec(R, _sub(ap[1], _cross(p, ap[0])))
        ax = sm.axis[i]
        if sm.types[i] == "revolute":
            Sw, Sv = ax, zero3
        else:
            Sw, Sv = zero3, ax
        wi = _add(wi, _scale(v[i], Sw))
        vi = _add(vi, _scale(v[i], Sv))
        wai = _add(wai, _scale(a[i], Sw))
        vai = _add(vai, _scale(a[i], Sv))
        # + v x (S qdot)
        sw, sv = _scale(v[i], Sw), _scale(v[i], Sv)
        wai = _add(wai, _cross(wi, sw))
        vai = _add(vai, _add(_cross(wi, sv), _cross(vi, sw)))
        vels.append((wi, vi))
        accs.append((wai, vai))
        # inertia apply + bias: f = I a + v x* (I v)
        m, c, I = sm.mass[i], sm.com[i], sm.inertia[i]

        def iner(mot):
            w, vv = mot
            plin = _scale(m, _add(vv, _cross(w, c)))
            n = _add(_matvec(I, w), _cross(c, plin))
            return n, plin

        hn, hf = iner((wi, vi))
        fn, ff = iner((wai, vai))
        fn = _add(fn, _add(_cross(wi, hn), _cross(vi, hf)))
        ff = _add(ff, _cross(wi, hf))
        frcs.append([fn, ff])
    tau = [None] * nj
    for i in reversed(range(nj)):
        ax = sm.axis[i]
        fn, ff = frcs[i]
        tau[i] = _dot(ax, fn) if sm.types[i] == "revolute" else _dot(ax, ff)
        par = sm.parents[i]
        if par >= 0:
            R, p = Xs[i]
            flp = _matvec(R, ff)
            fnp = _add(_matvec(R, fn), _cross(p, flp))
            frcs[par][0] = _add(frcs[par][0], fnp)
            frcs[par][1] = _add(frcs[par][1], flp)
    return tau


def _mass_matrix_cols(sm: _StaticModel, Xs) -> List[List]:
    """M + diag(armature) via zero-velocity unit-acceleration columns.

    With v = 0 and no gravity, rnea(q, 0, e_j) = M e_j and all velocity
    products vanish: only the subtree at j propagates accelerations and only
    ancestors of j receive forces — ~4x fewer ops than full RNEA columns
    (this dominated the compile time of the naive version)."""
    nj = sm.nj
    zero3 = (0.0, 0.0, 0.0)
    M = [[None] * nj for _ in range(nj)]
    for j in range(nj):
        ax_j = sm.axis[j]
        if sm.types[j] == "revolute":
            a_j = (ax_j, zero3)
        else:
            a_j = (zero3, ax_j)
        accs = {j: a_j}
        frcs = {}
        for i in range(j, nj):
            if i > j:
                par = sm.parents[i]
                if par not in accs:
                    continue
                R, p = Xs[i]
                ap = accs[par]
                accs[i] = (
                    _mattvec(R, ap[0]),
                    _mattvec(R, _sub(ap[1], _cross(p, ap[0]))),
                )
            m, c, I = sm.mass[i], sm.com[i], sm.inertia[i]
            w, vv = accs[i]
            plin = _scale(m, _add(vv, _cross(w, c)))
            frcs[i] = [_add(_matvec(I, w), _cross(c, plin)), plin]
        # back-substitute forces to ancestors; read off tau at k <= j and
        # at subtree nodes (symmetric fill)
        for i in reversed(range(nj)):
            if i not in frcs:
                continue
            fn, ff = frcs[i]
            ax = sm.axis[i]
            tau_i = _dot(ax, fn) if sm.types[i] == "revolute" else _dot(ax, ff)
            M[i][j] = tau_i
            if i < j:
                M[j][i] = tau_i  # symmetry (only ancestors of j reached here)
            par = sm.parents[i]
            if par >= 0:
                R, p = Xs[i]
                flp = _matvec(R, ff)
                fnp = _add(_matvec(R, fn), _cross(p, flp))
                if par in frcs:
                    frcs[par][0] = _add(frcs[par][0], fnp)
                    frcs[par][1] = _add(frcs[par][1], flp)
                else:
                    frcs[par] = [fnp, flp]
    zero = None
    for i in range(nj):
        for j in range(nj):
            if M[i][j] is None:
                M[i][j] = 0.0  # non-interacting pair (branching trees)
        M[i][i] = M[i][i] + sm.armature[i]
    return M


def _chol_solve_c(M: List[List], rhs_cols: List[List]) -> List[List]:
    """Unrolled scalar Cholesky solve: M (list of lists of [B] scalars,
    SPD) ; rhs_cols = list of column vectors. Returns solved columns."""
    n = len(M)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    outs = []
    for b in rhs_cols:
        y = [None] * n
        for i in range(n):
            s = b[i]
            for k in range(i):
                s = s - L[i][k] * y[k]
            y[i] = s / L[i][i]
        x = [None] * n
        for i in reversed(range(n)):
            s = y[i]
            for k in range(i + 1, n):
                s = s - L[k][i] * x[k]
            x[i] = s / L[i][i]
        outs.append(x)
    return outs


def _mass_matrix_c(sm: _StaticModel, q: List, Xs=None) -> List[List]:
    """M + diag(armature), entries are [B] scalars."""
    if Xs is None:
        Xs = _joint_transforms(sm, q)
    return _mass_matrix_cols(sm, Xs)


def _chol_solve_packed(M: List[List], rhs: List):
    """Cholesky solve with a packed trailing columns axis: M entries `[B]`,
    rhs entries `[B, C]` (C columns solved simultaneously — one factorization
    and ~n^2 ops regardless of C; this packing is what keeps the compiled
    graph small)."""
    n = len(M)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = jnp.sqrt(s) if i == j else s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k][..., None] * y[k]
        y[i] = s / L[i][i][..., None]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * x[k]
        x[i] = s / L[i][i][..., None]
    return x


# ---------------------------------------------------------------------------
# scan-over-joints forms: same math, O(1)-size compiled graphs
# ---------------------------------------------------------------------------

class _StackedModel:
    """Per-joint constants stacked into [nj] arrays (scan inputs)."""

    def __init__(self, model: RobotModel, params: ModelParams, dtype):
        assert model.parents == tuple(range(-1, model.nj - 1)), (
            "scan-form kernels support serial chains"
        )
        self.nj = model.nj
        f = lambda a: jnp.asarray(np.asarray(a, np.float64), dtype)
        self.R = f(params.joint_rot)  # [nj, 3, 3] -> indexed per scan step
        self.p = f(params.joint_trans)
        self.axis = f(params.axis)
        self.is_rev = f([1.0 if t == "revolute" else 0.0 for t in model.joint_types])
        self.mass = f(params.mass)
        self.com = f(params.com)
        self.inertia = f(params.inertia)
        self.armature = f(params.armature)
        self.gravity = f(params.gravity)


def _v3split(a):
    return (a[..., 0], a[..., 1], a[..., 2])


def _m3split(a):
    return tuple(a[..., i, j] for i in range(3) for j in range(3))


def _rnea_scan(st: _StackedModel, q, v, a):
    """Scan-over-joints RNEA. q/v/a: [nj, B]. Returns (tau [nj, B], X data).

    Two scans: forward kinematics/force computation, reverse force
    accumulation. All carry/body values are [B] component tuples, so the
    compiled body is a few hundred fused elementwise ops total.
    """
    nj = st.nj
    B = q.shape[1]
    dtype = q.dtype
    z = jnp.zeros((B,), dtype)
    zero3 = (z, z, z)
    g = st.gravity

    def fwd_body(carry, inp):
        wp, vp, wap, vap = carry
        qi, vi_s, ai_s, Rj, pj, ax, is_rev, m, com, I = inp
        Rq = _axis_rotation(tuple(ax), qi)
        Rj_c = _m3split(Rj)
        R = _matmul(Rj_c, Rq)
        axc = tuple(ax)
        pj_c = tuple(pj)
        # prismatic displacement
        disp = _matvec(Rj_c, _scale(qi * (1.0 - is_rev), axc))
        p = _add(pj_c, disp)
        w = _mattvec(R, wp)
        vv = _mattvec(R, _sub(vp, _cross(p, wp)))
        wa = _mattvec(R, wap)
        va = _mattvec(R, _sub(vap, _cross(p, wap)))
        Sw = _scale(is_rev, axc)
        Sv = _scale(1.0 - is_rev, axc)
        w = _add(w, _scale(vi_s, Sw))
        vv = _add(vv, _scale(vi_s, Sv))
        wa = _add(wa, _scale(ai_s, Sw))
        va = _add(va, _scale(ai_s, Sv))
        sw, sv = _scale(vi_s, Sw), _scale(vi_s, Sv)
        wa = _add(wa, _cross(w, sw))
        va = _add(va, _add(_cross(w, sv), _cross(vv, sw)))
        I_c = _m3split(I)
        com_c = tuple(com)

        def iner(mw, mv):
            plin = _scale(m, _add(mv, _cross(mw, com_c)))
            return _add(_matvec(I_c, mw), _cross(com_c, plin)), plin

        hn, hf = iner(w, vv)
        fn, ff = iner(wa, va)
        fn = _add(fn, _add(_cross(w, hn), _cross(vv, hf)))
        ff = _add(ff, _cross(w, hf))
        out = (jnp.stack(R), jnp.stack(p), jnp.stack(fn), jnp.stack(ff))
        return (w, vv, wa, va), out

    g_lin = tuple(-gi for gi in (g[0], g[1], g[2]))
    init = (zero3, zero3, zero3,
            tuple(jnp.broadcast_to(gl, (B,)) for gl in g_lin))
    inputs = (q, v, a, st.R, st.p, st.axis, st.is_rev, st.mass, st.com, st.inertia)
    (_, _, _, _), (Rs, ps, fns, ffs) = jax.lax.scan(fwd_body, init, inputs)

    def bwd_body(carry, inp):
        cn, cf = carry  # force from child, in this joint's frame
        R, p, fn, ff, ax, is_rev = inp
        Rc = tuple(R[i] for i in range(9))
        pc = tuple(p[i] for i in range(3))
        tn = _add((fn[0], fn[1], fn[2]), cn)
        tf = _add((ff[0], ff[1], ff[2]), cf)
        axc = tuple(ax)
        tau_i = is_rev * _dot(axc, tn) + (1.0 - is_rev) * _dot(axc, tf)
        flp = _matvec(Rc, tf)
        fnp = _add(_matvec(Rc, tn), _cross(pc, flp))
        return (fnp, flp), tau_i

    (_, _), tau = jax.lax.scan(
        bwd_body, (zero3, zero3),
        (Rs, ps, fns, ffs, st.axis, st.is_rev),
        reverse=True,
    )
    return tau, (Rs, ps)


def _xs_list_from_scan(Rs, ps, nj):
    """Stacked scan outputs (Rs [nj,9,B], ps [nj,3,B]) -> per-joint
    component-tuple placements for the unrolled helpers."""
    return [
        (tuple(Rs[i][k] for k in range(9)), tuple(ps[i][k] for k in range(3)))
        for i in range(nj)
    ]


def _fd_core(st: _StackedModel, sm: _StaticModel, x, u):
    """Shared forward-dynamics core: (a cols list, M, Xs_list, q, v)."""
    nj = sm.nj
    qm = x[:, :nj].T  # [nj, B]
    vm = x[:, nj:2 * nj].T
    zero = jnp.zeros_like(qm)
    b, (Rs, ps) = _rnea_scan(st, qm, vm, zero)
    Xs = _xs_list_from_scan(Rs, ps, nj)
    M = _mass_matrix_cols(sm, Xs)
    rhs = [u[:, i] - b[i] for i in range(nj)]
    (a,) = _chol_solve_c(M, [rhs])
    return a, M, Xs, qm, vm


def make_batched_step(model: RobotModel, params: ModelParams, dt: float = None,
                      dtype=jnp.float32, unroll: bool = False):
    """Returns jit-ready `step(x, u, dt_=None) -> x_next` on `[B, nx]`
    batches in the component layout (semi-implicit Euler, same semantics as
    `integrator.euler_step`). `dt` may be fixed at build time or passed per
    call as a scalar or `[B]` array (multi-resolution horizons). Scan-over-
    joints RNEA keeps the compiled graph small; dtype follows the input.

    ``unroll=True`` uses the fully-unrolled component RNEA (`_rnea_c`) —
    larger graph but no nested joint scans, which matters when the step
    itself sits inside a long time scan (the solver's forward rollout)."""
    sm = _StaticModel(model, params)
    nj = sm.nj

    if unroll:
        def step(x, u, dt_=None):
            d = dt if dt_ is None else dt_
            q = [x[:, i] for i in range(nj)]
            v = [x[:, nj + i] for i in range(nj)]
            zero = [jnp.zeros_like(q[0])] * nj
            Xs = _joint_transforms(sm, q)
            b = _rnea_c(sm, q, v, zero, Xs)
            M = _mass_matrix_cols(sm, Xs)
            rhs = [u[:, i] - b[i] for i in range(nj)]
            (a,) = _chol_solve_c(M, [rhs])
            v_next = [v[i] + d * a[i] for i in range(nj)]
            q_next = [q[i] + d * v_next[i] for i in range(nj)]
            return jnp.stack(q_next + v_next, axis=1)

        return step

    def step(x, u, dt_=None):
        d = dt if dt_ is None else dt_
        st = _StackedModel(model, params, x.dtype)
        a, M, Xs, qm, vm = _fd_core(st, sm, x, u)
        v_next = [vm[i] + d * a[i] for i in range(nj)]
        q_next = [qm[i] + d * v_next[i] for i in range(nj)]
        return jnp.stack(q_next + v_next, axis=1)

    return step


def make_batched_step_with_derivs(model: RobotModel, params: ModelParams,
                                  dt: float = None,
                                  deriv_mode: str = None):
    """Returns `f(x, u, dt_=None) -> (x_next [B,nx], Fx [B,nx,nx],
    Fu [B,nx,nu])`. `dt` fixed at build or per call (scalar or [B]).

    Derivatives via the RNEA identity, then the Euler chain rule — all in
    component layout. ``deriv_mode`` selects how d rnea/d(q,v) is formed:

    - "analytic" (default): closed-form derivatives of the recursive
      Newton-Euler algorithm (`ops/analytic_derivs.py`) — the batched
      equivalent of Pinocchio's `computeRNEADerivatives` (the reference's
      hot-loop path, SURVEY.md N3) at ~1/5 the flops of the AD routes.
    - "vjp": nj reverse-mode pulls (~2x cheaper than 2nj forward tangents).
      Mathematically identical to "analytic" (tested to 2e-5 in f32); its
      scan-of-scans graph is ~10x smaller, which matters only for XLA:CPU
      compile time (the virtual-mesh dryrun).
    - "jvp": 2nj forward tangents via `jax.linearize`.

    When ``deriv_mode`` is None it resolves from ``AGIMUS_DERIV_MODE``
    (default "analytic") at build time.
    """
    if deriv_mode is None:
        import os

        deriv_mode = os.environ.get("AGIMUS_DERIV_MODE", "analytic")
    if deriv_mode not in ("analytic", "vjp", "jvp"):
        raise ValueError(deriv_mode)
    sm = _StaticModel(model, params)
    nj = sm.nj

    def f(x, u, dt_=None):
        dt_l = dt if dt_ is None else dt_
        B = x.shape[0]
        st = _StackedModel(model, params, x.dtype)
        a, M, Xs, qm, vm = _fd_core(st, sm, x, u)

        eye = jnp.eye(nj, dtype=x.dtype)
        if deriv_mode == "analytic":
            from .analytic_derivs import rnea_qv_derivatives

            q_l = [qm[i] for i in range(nj)]
            v_l = [vm[i] for i in range(nj)]
            Dq, Dv = rnea_qv_derivatives(sm, q_l, v_l, list(a), Xs)
            zero = jnp.zeros_like(qm[0])
            pack = lambda e: e if not isinstance(e, float) else zero
            # Drow[i] : [B, 2nj] = d tau_i / d (q, v)
            Drow = [
                jnp.stack([pack(Dq[i][j]) for j in range(nj)]
                          + [pack(Dv[i][j]) for j in range(nj)], axis=1)
                for i in range(nj)
            ]
        else:
            a_stacked = jnp.stack(a)  # [nj, B]

            # d rnea(q, v, a)/d(q, v) at the solution a (a held fixed)
            def rnea_flat(qv):
                taus, _ = _rnea_scan(st, qv[:, :nj].T, qv[:, nj:].T, a_stacked)
                return jnp.stack(taus, axis=1)  # [B, nj]

            if deriv_mode == "vjp":
                _, pullback = jax.vjp(rnea_flat, x)
                basis_o = jnp.eye(nj, dtype=x.dtype)
                # Drow[i] = d tau_i / d qv : [nj, B, 2nj]
                Drow = jax.vmap(
                    lambda e: pullback(jnp.broadcast_to(e, (B, nj)))[0]
                )(basis_o)
            else:
                _, rnea_lin = jax.linearize(rnea_flat, x)
                basis = jnp.eye(2 * nj, dtype=x.dtype)
                # D[k] = d rnea / d qv_k : [2nj, B, nj]
                D = jax.vmap(
                    lambda e: rnea_lin(jnp.broadcast_to(e, (B, 2 * nj)))
                )(basis)
                Drow = jnp.moveaxis(D, (0, 2), (2, 0))  # [nj, B, 2nj]

        # ONE factorization, ALL columns packed on a trailing axis:
        # nj unit columns (-> M~^-1) then 2nj tangent columns (-> da/dqv)
        rhs = [
            jnp.concatenate(
                [jnp.broadcast_to(eye[i], (B, nj)), -Drow[i]],
                axis=1)  # [B, nj + 2nj]
            for i in range(nj)
        ]
        sols = _chol_solve_packed(M, rhs)  # list nj of [B, 3nj]
        Minv = jnp.stack([s[:, :nj] for s in sols], axis=1)  # [B, nj, nj]
        da = jnp.stack([s[:, nj:] for s in sols], axis=1)  # [B, nj, 2nj]

        # assemble Fx, Fu for semi-implicit Euler:
        # v+ = v + dt a ; q+ = q + dt v+ = q + dt v + dt^2 a
        dta = jnp.asarray(dt_l, x.dtype)
        dtm = dta[:, None, None] if dta.ndim == 1 else dta  # [B]->[B,1,1]
        dt2m = dtm * dtm
        I2 = jnp.broadcast_to(eye, (B, nj, nj))
        Fq_q = I2 + dt2m * da[:, :, :nj]
        Fq_v = dtm * I2 + dt2m * da[:, :, nj:]
        Fv_q = dtm * da[:, :, :nj]
        Fv_v = I2 + dtm * da[:, :, nj:]
        Fx = jnp.concatenate(
            [jnp.concatenate([Fq_q, Fq_v], axis=2),
             jnp.concatenate([Fv_q, Fv_v], axis=2)], axis=1)
        Fu = jnp.concatenate([dt2m * Minv, dtm * Minv], axis=1)

        dtv = dta if dta.ndim == 1 else dta  # [B] or scalar, broadcasts on [B]
        v_next = [vm[i] + dtv * a[i] for i in range(nj)]
        q_next = [qm[i] + dtv * v_next[i] for i in range(nj)]
        x_next = jnp.stack(q_next + v_next, axis=1)
        return x_next, Fx, Fu

    return f


def make_batched_soft_step(model: RobotModel, params: ModelParams, sc):
    """Augmented-state (x = [q; v; f]) batched step for soft-contact specs
    (force_feedback_mpc `IAMSoftContactAugmented` semantics,
    `ocp/ocp_croco_generic_force_feedback.py:161-215`).

    Returns `step(x [B,nx+nc], u [B,nu], dt [B], active [B]) -> x_next`.
    vmapped over the single-sample kernel: the augmented dynamics needs the
    contact-frame Jacobian chain, which isn't worth a bespoke component
    layout at current force-feedback problem sizes.
    """
    from .soft_contact import soft_contact_step

    def step1(x, u, d, a):
        return soft_contact_step(model, params, sc, x, u, d, a)

    return jax.vmap(step1)


def make_batched_soft_step_with_derivs(model: RobotModel,
                                       params: ModelParams, sc):
    """`f(x, u, dt, active) -> (x_next, Fx, Fu)` on the augmented state."""
    from .soft_contact import soft_contact_step

    def step1(x, u, d, a):
        return soft_contact_step(model, params, sc, x, u, d, a)

    def f1(x, u, d, a):
        xn = step1(x, u, d, a)
        Fx, Fu = jax.jacfwd(step1, argnums=(0, 1))(x, u, d, a)
        return xn, Fx, Fu

    return jax.vmap(f1)
