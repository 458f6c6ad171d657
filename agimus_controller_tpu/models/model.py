"""Static robot model structures.

Split deliberately (for jit): the *topology* (`RobotModel`) is plain Python
— tuples of ints/strings, hashable, closed over at trace time so XLA unrolls
the kinematic tree — while every *numeric constant* lives in `ModelParams`, a
pytree of arrays passed as a runtime argument. That makes model-parameter
perturbation sweeps (the reference's model-sensitivity study,
`agimus_controller_examples/main/model_sensibility/evaluate_model_sensibility.py`)
a simple `vmap` over `ModelParams` leaves rather than N model rebuilds.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np


class ModelParams(NamedTuple):
    """Numeric model constants (pytree). Leading dims may be batched.

    Shapes use nj = number of movable joints, nf = number of frames,
    ng = number of collision geometries.
    """

    # joint placements in the parent joint frame (fixed part of the chain)
    joint_rot: jax.Array  # [nj, 3, 3]
    joint_trans: jax.Array  # [nj, 3]
    axis: jax.Array  # [nj, 3] unit joint axis in the joint frame
    # per-body (== per movable joint) inertial constants, in the joint frame
    mass: jax.Array  # [nj]
    com: jax.Array  # [nj, 3]
    inertia: jax.Array  # [nj, 3, 3] rotational inertia about the CoM
    armature: jax.Array  # [nj] rotor inertia added to the mass-matrix diagonal
    # operational frames attached to joints
    frame_rot: jax.Array  # [nf, 3, 3]
    frame_trans: jax.Array  # [nf, 3]
    # limits
    q_lower: jax.Array  # [nj]
    q_upper: jax.Array  # [nj]
    velocity_limit: jax.Array  # [nj]
    effort_limit: jax.Array  # [nj]
    # collision geometry (capsules/spheres: halflen == 0 -> sphere)
    geom_rot: jax.Array  # [ng, 3, 3] placement in parent joint frame
    geom_trans: jax.Array  # [ng, 3]
    geom_radius: jax.Array  # [ng]
    geom_halflen: jax.Array  # [ng]
    # gravity vector in the world frame
    gravity: jax.Array  # [3]


@dataclasses.dataclass(frozen=True)
class Frame:
    name: str
    parent_joint: int  # -1 = universe/root
    index: int


@dataclasses.dataclass(frozen=True)
class Geometry:
    name: str
    parent_joint: int  # -1 = world-fixed (environment) geometry
    gtype: str  # "capsule" | "sphere" (boxes are capsule-approximated)
    index: int


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static kinematic topology. Hashable; safe to close over under jit.

    Reference equivalent: the pinocchio `pin.Model` + `pin.GeometryModel` pair
    produced by `RobotModels` (`factory/robot_model.py:88-351`), flattened to
    arrays for a fixed, compile-time tree.
    """

    name: str
    joint_names: Tuple[str, ...]
    joint_types: Tuple[str, ...]  # "revolute" | "prismatic"
    parents: Tuple[int, ...]  # parent movable-joint index, -1 for root
    frames: Tuple[Frame, ...]
    geometries: Tuple[Geometry, ...]
    collision_pairs: Tuple[Tuple[int, int], ...]  # geometry index pairs

    @property
    def nj(self) -> int:
        return len(self.joint_names)

    @property
    def nq(self) -> int:
        return self.nj

    @property
    def nv(self) -> int:
        return self.nj

    @property
    def nx(self) -> int:
        return self.nq + self.nv

    @property
    def nframes(self) -> int:
        return len(self.frames)

    @property
    def ngeoms(self) -> int:
        return len(self.geometries)

    def frame_id(self, name: str) -> int:
        for f in self.frames:
            if f.name == name:
                return f.index
        raise KeyError(f"unknown frame {name!r}; have {[f.name for f in self.frames]}")

    def joint_id(self, name: str) -> int:
        return self.joint_names.index(name)

    def geometry_id(self, name: str) -> int:
        for g in self.geometries:
            if g.name == name:
                return g.index
        raise KeyError(f"unknown geometry {name!r}")

    def neutral(self, params: ModelParams) -> jax.Array:
        """Neutral configuration: midpoint of finite limits, else zero
        (pinocchio `pin.neutral` analog used at `factory/robot_model.py`)."""
        lo = np.asarray(params.q_lower)
        hi = np.asarray(params.q_upper)
        mid = np.where(np.isfinite(lo) & np.isfinite(hi), 0.5 * (lo + hi), 0.0)
        return jnp.asarray(mid, dtype=params.joint_trans.dtype)
