"""Batched rigid-body dynamics: RNEA, CRBA, forward dynamics.

JAX-native replacement for the dynamics kernels the reference consumes from
Pinocchio/Crocoddyl (SURVEY.md §2b N1/N3): `pin.rnea` (warm-start inverse
dynamics, `warm_start_reference.py:82-88`; trajectory efforts,
`trajectories/generic_trajectory.py:37-65`) and
`DifferentialActionModelFreeFwdDynamics.calc` (forward dynamics with armature,
`ocp_base_croco.py:184-189`).

Design notes:
- The kinematic tree is static: joint recursions are Python loops unrolled at
  trace time into straight-line fused elementwise code. Batch with `vmap`
  outside.
- Forward dynamics uses the mass-matrix route `solve(M + diag(armature),
  tau - nle)` rather than the O(n) articulated-body recursion: at nq = 7 a
  7x7 Cholesky is a handful of fused ops, the armature term is exact (this is
  what Crocoddyl does when armature is set), and the whole thing is cleanly
  differentiable with `jacfwd` for the OCP derivatives.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.model import ModelParams, RobotModel
from . import spatial
from .kinematics import _joint_motion_subspace, joint_transform


def rnea(model: RobotModel, params: ModelParams, q, v, a, fext=None):
    """Recursive Newton-Euler inverse dynamics: tau(q, v, a).

    ``fext``: optional `[nj, 6]` external forces `[n; f]` expressed in each
    joint's local frame (subtracted, pinocchio convention). Armature is NOT
    included (matching `pin.rnea`; armature enters the mass matrix only).
    """
    nj = model.nj
    g = params.gravity
    a_base = jnp.concatenate([jnp.zeros_like(g), -g])  # gravity trick
    Xl = [joint_transform(model, params, q, i) for i in range(nj)]
    vels, accs, forces = [], [], []
    for i in range(nj):
        S = _joint_motion_subspace(model, params, i)
        p = model.parents[i]
        v_parent = vels[p] if p >= 0 else jnp.zeros(6, dtype=q.dtype)
        a_parent = accs[p] if p >= 0 else a_base
        vi = spatial.motion_act_inv(Xl[i], v_parent) + S * v[i]
        ai = (
            spatial.motion_act_inv(Xl[i], a_parent)
            + S * a[i]
            + spatial.motion_cross(vi, S * v[i])
        )
        hi = spatial.inertia_apply(params.mass[i], params.com[i], params.inertia[i], vi)
        fi = (
            spatial.inertia_apply(params.mass[i], params.com[i], params.inertia[i], ai)
            + spatial.motion_cross_force(vi, hi)
        )
        if fext is not None:
            fi = fi - fext[i]
        vels.append(vi)
        accs.append(ai)
        forces.append(fi)
    tau = [None] * nj
    for i in reversed(range(nj)):
        S = _joint_motion_subspace(model, params, i)
        tau[i] = jnp.dot(S, forces[i])
        p = model.parents[i]
        if p >= 0:
            forces[p] = forces[p] + spatial.force_act(Xl[i], forces[i])
    return jnp.stack(tau)


def nonlinear_effects(model: RobotModel, params: ModelParams, q, v):
    """Coriolis + gravity bias b(q, v) = rnea(q, v, 0)."""
    return rnea(model, params, q, v, jnp.zeros_like(v))


def generalized_gravity(model: RobotModel, params: ModelParams, q):
    """g(q) = rnea(q, 0, 0) — the reference's `pin.computeGeneralizedGravity`
    (control-grav residual, `ocp/ocp_croco_generic.py:186-197`)."""
    z = jnp.zeros_like(q)
    return rnea(model, params, q, z, z)


def _spatial_inertia_matrix(mass, com, I_com, dtype):
    C = spatial.hat(com)
    mC = mass * C
    top = jnp.concatenate([I_com - mass * (C @ C), mC], axis=-1)
    bot = jnp.concatenate([-mC, mass * jnp.eye(3, dtype=dtype)], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def _force_act_matrix(X):
    """6x6 matrix of `spatial.force_act` for placement X = (R, p)."""
    R, p = X
    Z = jnp.zeros_like(R)
    pR = spatial.hat(p) @ R
    return jnp.concatenate(
        [jnp.concatenate([R, pR], axis=-1), jnp.concatenate([Z, R], axis=-1)], axis=-2
    )


def _motion_act_inv_matrix(X):
    """6x6 matrix of `spatial.motion_act_inv` for placement X = (R, p)."""
    R, p = X
    Rt = jnp.swapaxes(R, -1, -2)
    Z = jnp.zeros_like(R)
    return jnp.concatenate(
        [
            jnp.concatenate([Rt, Z], axis=-1),
            jnp.concatenate([-Rt @ spatial.hat(p), Rt], axis=-1),
        ],
        axis=-2,
    )


def crba(model: RobotModel, params: ModelParams, q):
    """Composite rigid-body algorithm: joint-space mass matrix M(q), `[nv,nv]`.

    Armature is NOT included; use `mass_matrix` for M + diag(armature).
    """
    nj = model.nj
    dtype = q.dtype
    Xl = [joint_transform(model, params, q, i) for i in range(nj)]
    Ic = [
        _spatial_inertia_matrix(params.mass[i], params.com[i], params.inertia[i], dtype)
        for i in range(nj)
    ]
    for i in reversed(range(nj)):
        p = model.parents[i]
        if p >= 0:
            XF = _force_act_matrix(Xl[i])
            XMi = _motion_act_inv_matrix(Xl[i])
            Ic[p] = Ic[p] + XF @ Ic[i] @ XMi
    entries = {}
    for i in range(nj):
        Si = _joint_motion_subspace(model, params, i)
        F = Ic[i] @ Si
        entries[(i, i)] = jnp.dot(Si, F)
        j = i
        while model.parents[j] >= 0:
            F = _force_act_matrix(Xl[j]) @ F
            j = model.parents[j]
            Sj = _joint_motion_subspace(model, params, j)
            entries[(i, j)] = jnp.dot(Sj, F)
    rows = []
    for i in range(nj):
        row = []
        for j in range(nj):
            key = (max(i, j), min(i, j))
            row.append(entries.get(key, jnp.zeros((), dtype=dtype)))
        rows.append(jnp.stack(row))
    return jnp.stack(rows)


def mass_matrix(model: RobotModel, params: ModelParams, q):
    """M(q) + diag(armature) — the inertia actually inverted by the solver
    (Crocoddyl DAM-with-armature semantics)."""
    return crba(model, params, q) + jnp.diag(params.armature)


def forward_dynamics(model: RobotModel, params: ModelParams, q, v, tau, fext=None):
    """Forward dynamics a(q, v, tau) with armature.

    Equivalent of `DifferentialActionModelFreeFwdDynamics.calc`'s ABA-with-
    armature (`ocp_base_croco.py:184-189` via `runningModels[0].calc`).
    """
    M = mass_matrix(model, params, q)
    b = rnea(model, params, q, v, jnp.zeros_like(v), fext=fext)
    L = jnp.linalg.cholesky(M)
    y = jax.scipy.linalg.solve_triangular(L, tau - b, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, y, lower=False)


def kinetic_energy(model: RobotModel, params: ModelParams, q, v):
    return 0.5 * v @ crba(model, params, q) @ v


def potential_energy(model: RobotModel, params: ModelParams, q):
    from .kinematics import joint_placements

    rots, trans = joint_placements(model, params, q)
    com_w = jnp.einsum("nij,nj->ni", rots, params.com) + trans
    return -jnp.sum(params.mass * (com_w @ params.gravity))
