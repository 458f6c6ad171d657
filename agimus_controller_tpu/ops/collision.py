"""Capsule/sphere signed-distance kernels with subgradient-consistent clamps.

JAX-native replacement for colmpc's `ResidualDistanceCollision` + coal/hpp-fcl
narrow phase (SURVEY.md §2b N5/N6). The reference reduces every collision
shape to capsules/spheres at model build (`factory/robot_model.py:261-302`),
so the closed-form segment-segment distance covers the whole geometry set —
no GJK needed, and everything is branch-free `jnp.clip`/`where`, which is
exactly what the VPU wants.

A capsule is (placement (R, p), radius, halflen) with its axis along local z;
halflen == 0 degrades to a sphere, so one kernel serves all pairs.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..models.model import ModelParams, RobotModel
from .kinematics import joint_placements
from . import spatial


def _segment_closest_params(p1, d1, l1, p2, d2, l2):
    """Closest points between segments p1 + s*d1 (s in [-l1, l1]) and
    p2 + t*d2 (t in [-l2, l2]). Returns (s, t). Branch-free Ericson scheme."""
    r = p1 - p2
    a = jnp.sum(d1 * d1, axis=-1)  # = 1 for unit axes
    e = jnp.sum(d2 * d2, axis=-1)
    b = jnp.sum(d1 * d2, axis=-1)
    c = jnp.sum(d1 * r, axis=-1)
    f = jnp.sum(d2 * r, axis=-1)
    denom = a * e - b * b
    denom_safe = jnp.where(denom < 1e-9, jnp.ones_like(denom), denom)
    s = jnp.where(denom < 1e-9, jnp.zeros_like(denom), (b * f - c * e) / denom_safe)
    s = jnp.clip(s, -l1, l1)
    e_safe = jnp.where(e < 1e-12, jnp.ones_like(e), e)
    t = (b * s + f) / e_safe
    t_cl = jnp.clip(t, -l2, l2)
    # re-project s for clamped t
    s = jnp.clip((b * t_cl - c) / jnp.where(a < 1e-12, jnp.ones_like(a), a), -l1, l1)
    return s, t_cl


def capsule_capsule_distance(R1, p1, r1, l1, R2, p2, r2, l2):
    """Signed distance between two capsules given world placements.

    Negative when penetrating (matching colmpc's signed distance residual).
    """
    d1 = R1[..., :, 2]
    d2 = R2[..., :, 2]
    s, t = _segment_closest_params(p1, d1, l1, p2, d2, l2)
    c1 = p1 + s[..., None] * d1
    c2 = p2 + t[..., None] * d2
    dist = jnp.sqrt(jnp.sum((c1 - c2) ** 2, axis=-1) + 1e-12)
    return dist - r1 - r2


def geometry_placements(model: RobotModel, params: ModelParams, q):
    """World placements of all collision geometries: ([ng,3,3],[ng,3]).

    Environment geometries (parent_joint == -1) are world-fixed; moving
    obstacles are handled by overriding their rows in ``params.geom_rot/
    geom_trans`` at call time (the reference's `update_geometry_placement`,
    `ocp_base_croco.py:110-132`, becomes an array input here).
    """
    rots, trans = joint_placements(model, params, q)
    out_R, out_p = [], []
    for g in model.geometries:
        gR, gp = params.geom_rot[g.index], params.geom_trans[g.index]
        if g.parent_joint < 0:
            out_R.append(gR)
            out_p.append(gp)
        else:
            R, p = spatial.se3_mul((rots[g.parent_joint], trans[g.parent_joint]), (gR, gp))
            out_R.append(R)
            out_p.append(p)
    return jnp.stack(out_R), jnp.stack(out_p)


def pair_distance(model: RobotModel, params: ModelParams, q, pair_id: int):
    """Signed distance of collision pair ``pair_id`` (colmpc
    `ResidualDistanceCollision.calc` equivalent)."""
    i, j = model.collision_pairs[pair_id]
    gR, gp = geometry_placements(model, params, q)
    return capsule_capsule_distance(
        gR[i], gp[i], params.geom_radius[i], params.geom_halflen[i],
        gR[j], gp[j], params.geom_radius[j], params.geom_halflen[j],
    )


def all_pair_distances(model: RobotModel, params: ModelParams, q):
    """Signed distances of every registered collision pair, `[n_pairs]`.

    One FK pass shared across pairs (unlike per-residual FK in the
    reference's per-pair C++ residuals)."""
    gR, gp = geometry_placements(model, params, q)
    ds = []
    for (i, j) in model.collision_pairs:
        ds.append(
            capsule_capsule_distance(
                gR[i], gp[i], params.geom_radius[i], params.geom_halflen[i],
                gR[j], gp[j], params.geom_radius[j], params.geom_halflen[j],
            )
        )
    return jnp.stack(ds) if ds else jnp.zeros((0,), dtype=q.dtype)
