"""Batched forward kinematics and frame Jacobians.

JAX-native equivalent of the Pinocchio kinematics surface the reference uses:
`pin.forwardKinematics` / `pin.updateFramePlacements`
(`agimus_controller/trajectories/trajectory_base.py:38-45`,
`plots/pin_utils.py:21-200`), `pin.computeFrameJacobian` (IK in
`trajectories/sine_wave_cartesian_space.py:62-111`) and `pin.integrate`.

All functions are single-sample over a *static* topology (the joint loop is a
Python loop unrolled at trace time); wrap with `jax.vmap` for batches.
Motion vectors are `[w; v]` local-frame unless noted.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..models.model import ModelParams, RobotModel
from . import spatial


def joint_transform(model: RobotModel, params: ModelParams, q, i: int):
    """Placement of joint-i frame in its parent joint frame at angle q[i]."""
    Rj, pj = params.joint_rot[i], params.joint_trans[i]
    axis = params.axis[i]
    if model.joint_types[i] == "revolute":
        Rq = spatial.exp3(axis * q[..., i, None])
        return Rj @ Rq, pj
    elif model.joint_types[i] == "prismatic":
        return Rj, pj + Rj @ (axis * q[..., i, None])
    raise ValueError(f"unsupported joint type {model.joint_types[i]}")


def joint_placements(model: RobotModel, params: ModelParams, q):
    """World placements of all joint frames: ([nj,3,3], [nj,3])."""
    rots, trans = [], []
    for i in range(model.nj):
        Xl = joint_transform(model, params, q, i)
        p = model.parents[i]
        if p < 0:
            oMi = Xl
        else:
            oMi = spatial.se3_mul((rots[p], trans[p]), Xl)
        rots.append(oMi[0])
        trans.append(oMi[1])
    return jnp.stack(rots), jnp.stack(trans)


def frame_placement(model: RobotModel, params: ModelParams, q, frame_id: int):
    """World placement (R, p) of an operational frame."""
    fr = model.frames[frame_id]
    fR, fp = params.frame_rot[frame_id], params.frame_trans[frame_id]
    if fr.parent_joint < 0:
        return fR, fp
    rots, trans = joint_placements(model, params, q)
    return spatial.se3_mul((rots[fr.parent_joint], trans[fr.parent_joint]), (fR, fp))


def _ancestors(model: RobotModel, joint: int):
    out = []
    j = joint
    while j >= 0:
        out.append(j)
        j = model.parents[j]
    return out[::-1]


def _joint_motion_subspace(model: RobotModel, params: ModelParams, i: int):
    axis = params.axis[i]
    zero = jnp.zeros_like(axis)
    if model.joint_types[i] == "revolute":
        return jnp.concatenate([axis, zero])
    return jnp.concatenate([zero, axis])


def frame_jacobian(
    model: RobotModel,
    params: ModelParams,
    q,
    frame_id: int,
    reference_frame: str = "local_world_aligned",
):
    """Geometric Jacobian of a frame, `[6, nv]`, rows `[w; v]`.

    ``reference_frame``: "local", "world", or "local_world_aligned" (pinocchio
    `pin.LOCAL_WORLD_ALIGNED`, the convention the reference IK uses,
    `sine_wave_cartesian_space.py:104-110`).
    """
    fr = model.frames[frame_id]
    rots, trans = joint_placements(model, params, q)
    oMf = spatial.se3_mul(
        (rots[fr.parent_joint], trans[fr.parent_joint]),
        (params.frame_rot[frame_id], params.frame_trans[frame_id]),
    )
    fMo = spatial.se3_inv(oMf)
    cols = []
    anc = set(_ancestors(model, fr.parent_joint))
    for i in range(model.nj):
        if i not in anc:
            cols.append(jnp.zeros(6, dtype=q.dtype))
            continue
        S = _joint_motion_subspace(model, params, i)
        S_world = spatial.motion_act((rots[i], trans[i]), S)
        if reference_frame == "world":
            cols.append(S_world)
        elif reference_frame == "local":
            cols.append(spatial.motion_act_inv(oMf, S_world))
        else:  # local_world_aligned: local linear/angular parts rotated to world
            S_local = spatial.motion_act_inv(oMf, S_world)
            R = oMf[0]
            cols.append(jnp.concatenate([R @ S_local[:3], R @ S_local[3:]]))
    return jnp.stack(cols, axis=-1)


def frame_velocity(
    model: RobotModel,
    params: ModelParams,
    q,
    v,
    frame_id: int,
    reference_frame: str = "local_world_aligned",
):
    """Spatial velocity `[w; v]` of a frame (J @ v)."""
    J = frame_jacobian(model, params, q, frame_id, reference_frame)
    return J @ v


def integrate(model: RobotModel, q, dq):
    """Lie-group configuration integration (pinocchio `pin.integrate`).

    All supported joints are vector-space (revolute/prismatic), so this is
    plain addition; kept as the single entry point so a free-flyer state can
    slot in later (reference `StateMultibody.integrate`)."""
    return q + dq


def difference(model: RobotModel, q0, q1):
    """Tangent-space difference (pinocchio `pin.difference`)."""
    return q1 - q0
