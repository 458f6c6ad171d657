"""Spatial (screw) algebra in JAX: SO(3)/SE(3) maps and 6-D motion/force ops.

JAX-native equivalent of the SE3/Motion/Force algebra the reference consumes
from Pinocchio (reference: `pin.SE3/Motion/Force`, `pin.integrate`, `pin.log`,
quaternion conversions — e.g. `agimus_controller/trajectory.py:9-178`,
`agimus_controller_ros/ros_utils.py:22-170`).

Conventions
-----------
- A *placement* is the pair ``(R, p)``: ``x_A = R @ x_B + p`` maps coordinates
  of a point from frame B into frame A ("B placed in A").
- 6-D *motion* vectors are Featherstone-ordered ``[angular w; linear v]``,
  expressed in the *local* frame unless stated otherwise.
- 6-D *force* vectors are ``[torque n; force f]`` (dual order to motion).
- All functions are single-sample and shape-static; use ``jax.vmap`` to batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def hat(w):
    """3-vector -> skew-symmetric matrix (so3 hat map)."""
    z = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -w[..., 2], w[..., 1]], axis=-1),
            jnp.stack([w[..., 2], z, -w[..., 0]], axis=-1),
            jnp.stack([-w[..., 1], w[..., 0], z], axis=-1),
        ],
        axis=-2,
    )


def exp3(w):
    """so(3) exponential: rotation vector -> rotation matrix (Rodrigues).

    Taylor-safe near ||w|| = 0 so it is differentiable everywhere (the
    "double-where" trick keeps NaNs out of the untaken branch's gradient).
    """
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    # safe value only feeds the branch that is NOT selected near zero
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    W = hat(w)
    eye = jnp.eye(3, dtype=w.dtype)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log3(R):
    """SO(3) log: rotation matrix -> rotation vector.

    Quaternion/atan2 formulation: numerically stable and smoothly
    differentiable everywhere except the true antipodal singularity at
    theta == pi (where SO(3) log is non-differentiable mathematically).
    With q = [sin(t/2) n; cos(t/2)]:  w = (theta / sin(theta/2)) * q_xyz.
    """
    q = matrix_to_quat(R)
    xyz = q[..., :3]
    # fix the double cover: force w >= 0 so theta in [0, pi]
    sign = jnp.where(q[..., 3] < 0.0, -1.0, 1.0)
    xyz = xyz * sign[..., None]
    c = jnp.abs(q[..., 3])  # cos(theta/2) >= 0
    s2 = jnp.sum(xyz * xyz, axis=-1)
    small = s2 < 1e-12
    s = jnp.sqrt(jnp.where(small, jnp.ones_like(s2), s2))  # sin(theta/2)
    theta = 2.0 * jnp.arctan2(s, c)
    # scale = theta / sin(theta/2); series 2/c - 2 s^2/(3 c^3) for small s
    scale = jnp.where(small, 2.0 / c + s2 * 0.0, theta / s)
    return scale[..., None] * xyz


def exp6(nu):
    """se(3) exponential. ``nu = [w; v]`` -> placement ``(R, p)``."""
    w, v = nu[..., :3], nu[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)
    W = hat(w)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2_safe)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2_safe)
    eye = jnp.eye(3, dtype=nu.dtype)
    R = eye + a[..., None, None] * W + b[..., None, None] * (W @ W)
    V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
    p = jnp.einsum("...ij,...j->...i", V, v)
    return R, p


def log6(R, p):
    """SE(3) log: placement -> twist ``[w; v]`` with ``exp6(log6(M)) = M``."""
    w = log3(R)
    theta2 = jnp.sum(w * w, axis=-1)
    small = theta2 < 1e-8
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)
    W = hat(w)
    # V^{-1} = I - W/2 + (1/theta^2 - (1 + cos)/(2 theta sin)) W^2
    half_t = theta * 0.5
    sin_half_safe = jnp.where(small, jnp.ones_like(theta), jnp.sin(half_t))
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_t * jnp.cos(half_t) / sin_half_safe) / theta2_safe,
    )
    eye = jnp.eye(3, dtype=R.dtype)
    Vinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    v = jnp.einsum("...ij,...j->...i", Vinv, p)
    return jnp.concatenate([w, v], axis=-1)


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------

def se3_identity(dtype=jnp.float32):
    return jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype=dtype)


def se3_mul(a, b):
    """Compose placements: (R, p) of ``a @ b`` (b placed in a's parent)."""
    Ra, pa = a
    Rb, pb = b
    return Ra @ Rb, jnp.einsum("...ij,...j->...i", Ra, pb) + pa


def se3_inv(m):
    R, p = m
    Rt = jnp.swapaxes(R, -1, -2)
    return Rt, -jnp.einsum("...ij,...j->...i", Rt, p)


def se3_act_point(m, x):
    R, p = m
    return jnp.einsum("...ij,...j->...i", R, x) + p


def rpy_to_matrix(rpy):
    """URDF roll-pitch-yaw (extrinsic XYZ) -> rotation matrix: Rz Ry Rx."""
    r, pch, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(pch), jnp.sin(pch)
    cy, sy = jnp.cos(y), jnp.sin(y)
    row0 = jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1)
    row1 = jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1)
    row2 = jnp.stack([-sp, cp * sr, cp * cr], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def quat_to_matrix(q):
    """Quaternion ``[x, y, z, w]`` (pinocchio/eigen order) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / jnp.where(n > 0, n, jnp.ones_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    row0 = jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1)
    row1 = jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1)
    row2 = jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def matrix_to_quat(R):
    """Rotation matrix -> quaternion ``[x, y, z, w]`` (branchless, jit-safe)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate quaternions (unnormalized), one per dominant component
    qw = jnp.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr], axis=-1)
    qx = jnp.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12], axis=-1)
    qy = jnp.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20], axis=-1)
    qz = jnp.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01], axis=-1)
    cand = jnp.stack([qx, qy, qz, qw], axis=-2)  # [..., 4 candidates, 4]
    scores = jnp.stack([m00, m11, m22, tr], axis=-1)
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cand, idx[..., None, None].repeat(4, -1), axis=-2)[..., 0, :]
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Motion / force vector ops  ([w; v] motion, [n; f] force)
# ---------------------------------------------------------------------------

def motion_cross(m1, m2):
    """Spatial motion cross product  m1 x m2."""
    w1, v1 = m1[..., :3], m1[..., 3:]
    w2, v2 = m2[..., :3], m2[..., 3:]
    return jnp.concatenate(
        [jnp.cross(w1, w2), jnp.cross(w1, v2) + jnp.cross(v1, w2)], axis=-1
    )


def motion_cross_force(m, f):
    """Spatial force cross product  m x* f  (dual of motion_cross)."""
    w, v = m[..., :3], m[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return jnp.concatenate(
        [jnp.cross(w, n) + jnp.cross(v, fl), jnp.cross(w, fl)], axis=-1
    )


def motion_act(m, nu):
    """Transform a motion vector from frame B to frame A given placement
    ``m = (R, p)`` of B in A."""
    R, p = m
    w = jnp.einsum("...ij,...j->...i", R, nu[..., :3])
    v = jnp.einsum("...ij,...j->...i", R, nu[..., 3:]) + jnp.cross(p, w)
    return jnp.concatenate([w, v], axis=-1)


def motion_act_inv(m, nu):
    """Transform a motion vector from frame A to frame B (inverse of act)."""
    R, p = m
    Rt = jnp.swapaxes(R, -1, -2)
    w_a = nu[..., :3]
    w = jnp.einsum("...ij,...j->...i", Rt, w_a)
    v = jnp.einsum("...ij,...j->...i", Rt, nu[..., 3:] - jnp.cross(p, w_a))
    return jnp.concatenate([w, v], axis=-1)


def force_act(m, f):
    """Transform a force vector from frame B to frame A given ``m = (R, p)``."""
    R, p = m
    fl = jnp.einsum("...ij,...j->...i", R, f[..., 3:])
    n = jnp.einsum("...ij,...j->...i", R, f[..., :3]) + jnp.cross(p, fl)
    return jnp.concatenate([n, fl], axis=-1)


def force_act_inv(m, f):
    """Transform a force vector from frame A to frame B (inverse of act)."""
    R, p = m
    Rt = jnp.swapaxes(R, -1, -2)
    fl_a = f[..., 3:]
    n = jnp.einsum("...ij,...j->...i", Rt, f[..., :3] - jnp.cross(p, fl_a))
    fl = jnp.einsum("...ij,...j->...i", Rt, fl_a)
    return jnp.concatenate([n, fl], axis=-1)


def inertia_apply(mass, com, I_com, nu):
    """Apply a body spatial inertia (mass, CoM offset, rotational inertia
    about the CoM, all in the body frame) to a local motion ``[w; v]``.

    Returns the spatial momentum/force ``[n; f]`` about the body origin.
    """
    w, v = nu[..., :3], nu[..., 3:]
    p_lin = mass[..., None] * (v + jnp.cross(w, com))
    n = jnp.einsum("...ij,...j->...i", I_com, w) + jnp.cross(com, p_lin)
    return jnp.concatenate([n, p_lin], axis=-1)
