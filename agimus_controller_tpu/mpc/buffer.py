"""Trajectory points, weights, and the reference ring buffer.

Host-side analog of the reference's `trajectory.py` wire types (points
`:9-81`, weights `:84-158`, weighted point `:161-178`) — poses are `(R, p)`
numpy pairs and spatial vectors are `[w; v]` 6-vectors instead of pinocchio
objects, everything else is field-compatible so message conversions port
1:1.

The buffer itself is a device-first redesign (SURVEY.md §7 step 6): a
preallocated ring with an explicit read head (every mutation is O(1), no
list shifting), multi-resolution horizon extraction computed vectorially
from the `DTFactorsNSeq` spec, and an optional PACKED-ROW lane: each point
is flattened into one numeric row exactly once on append, so the per-tick
horizon becomes a single array gather instead of a Python loop over
T+1 points x fields (the reference's per-tick hot path,
`ocp_croco_generic.py:855-892`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Pose = Tuple[np.ndarray, np.ndarray]  # (R [3,3], p [3])


@dataclasses.dataclass
class DTFactorsNSeq:
    """Multi-resolution horizon spec (reference `ocp_param_base.py:6-28`):
    segment i uses timestep `factors[i] * dt` for `n_steps[i]` nodes."""

    factors: List[int]
    n_steps: List[int]

    def __post_init__(self):
        if len(self.factors) != len(self.n_steps):
            raise ValueError("factors and n_steps must pair up")
        if any(f < 1 for f in self.factors):
            raise ValueError("dt factors must be >= 1")

    def horizon_indexes(self) -> np.ndarray:
        """Buffer subsampling offsets for the non-uniform horizon.

        Node k sits `sum of the first k per-node factors` base-dt steps from
        the head; e.g. factors [1,2] x n_steps [2,2] -> [0, 1, 2, 4, 6].
        """
        per_node = np.repeat(np.asarray(self.factors, np.int64),
                             np.asarray(self.n_steps, np.int64))
        return np.concatenate([np.zeros(1, np.int64), np.cumsum(per_node)])


@dataclasses.dataclass
class TrajectoryPoint:
    """Reference for one MPC node (reference `TrajectoryPoint`,
    `trajectory.py:9-81`)."""

    id: Optional[int] = None
    time_ns: Optional[int] = None
    robot_configuration: Optional[np.ndarray] = None
    robot_velocity: Optional[np.ndarray] = None
    robot_acceleration: Optional[np.ndarray] = None
    robot_effort: Optional[np.ndarray] = None
    forces: Optional[Dict[str, np.ndarray]] = None  # [n; f] 6-vectors
    end_effector_poses: Optional[Dict[str, Pose]] = None
    end_effector_velocities: Optional[Dict[str, np.ndarray]] = None  # [w; v]

    @property
    def robot_state(self) -> np.ndarray:
        return np.concatenate((self.robot_configuration, self.robot_velocity))


@dataclasses.dataclass
class TrajectoryPointWeights:
    """Weights for one MPC node (reference `TrajectoryPointWeights`,
    `trajectory.py:84-158`). EE pose weights are 6-vectors ordered
    [translation(3), rotation(3)] like the reference wire format."""

    w_robot_configuration: Optional[np.ndarray] = None
    w_robot_velocity: Optional[np.ndarray] = None
    w_robot_acceleration: Optional[np.ndarray] = None
    w_robot_effort: Optional[np.ndarray] = None
    w_forces: Optional[Dict[str, np.ndarray]] = None
    w_end_effector_poses: Optional[Dict[str, np.ndarray]] = None
    w_end_effector_velocities: Optional[Dict[str, np.ndarray]] = None
    w_collision_avoidance: Optional[float] = None

    @property
    def w_robot_state(self) -> np.ndarray:
        return np.concatenate((self.w_robot_configuration, self.w_robot_velocity))


@dataclasses.dataclass
class WeightedTrajectoryPoint:
    """Point + weights (reference `WeightedTrajectoryPoint`,
    `trajectory.py:161-178`)."""

    point: TrajectoryPoint
    weights: TrajectoryPointWeights


class TrajectoryBuffer:
    """Preallocated ring of WeightedTrajectoryPoints with multi-resolution
    horizon extraction.

    Functional contract of the reference `TrajectoryBuffer`
    (`trajectory.py:181-231`) — append/extend, horizon at the subsampling
    offsets, head consumption — over a different mechanism: a power-of-two
    ring with monotone read/write counters. `clear_past` advances the read
    head; nothing is shifted or reallocated at the control rate.
    """

    def __init__(self, dt_factor_n_seq: DTFactorsNSeq,
                 min_capacity: int = 4096):
        self.dt_factor_n_seq = dataclasses.replace(
            dt_factor_n_seq,
            factors=list(dt_factor_n_seq.factors),
            n_steps=list(dt_factor_n_seq.n_steps),
        )
        self._horizon_idx = self.dt_factor_n_seq.horizon_indexes()
        span = int(self._horizon_idx[-1]) + 1
        cap = 1
        while cap < max(min_capacity, 4 * span):
            cap <<= 1
        self._cap = cap
        self._slots: List[Optional[WeightedTrajectoryPoint]] = [None] * cap
        self._read = 0   # monotone counters; slot = counter & (cap - 1)
        self._write = 0

    # -- mutation ------------------------------------------------------
    def append(self, item: WeightedTrajectoryPoint):
        if self._write - self._read >= self._cap:
            raise OverflowError(
                f"reference ring full ({self._cap} points); the consumer "
                "stopped draining")
        self._slots[self._write & (self._cap - 1)] = item
        self._write += 1

    def extend(self, items: Sequence[WeightedTrajectoryPoint]):
        for it in items:
            self.append(it)

    def clear(self):
        """Drop every buffered point (checkpoint restore)."""
        self._slots = [None] * self._cap
        self._read = 0
        self._write = 0

    def clear_past(self):
        """Consume the head (one base-dt step)."""
        if self._write > self._read:
            self._slots[self._read & (self._cap - 1)] = None
            self._read += 1

    def pop(self, index: int = -1):
        """Remove and return the newest (-1) or oldest (0) entry."""
        if self._write == self._read:
            raise IndexError("pop from empty buffer")
        if index in (0,):
            item = self[0]
            self.clear_past()
            return item
        if index in (-1, len(self) - 1):
            self._write -= 1
            slot = self._write & (self._cap - 1)
            item = self._slots[slot]
            self._slots[slot] = None
            return item
        raise IndexError("ring buffer pops only at the ends")

    # -- access --------------------------------------------------------
    @property
    def horizon_indexes(self) -> List[int]:
        return [int(i) for i in self._horizon_idx]

    @property
    def horizon(self) -> List[WeightedTrajectoryPoint]:
        span = int(self._horizon_idx[-1])
        if span >= len(self):
            raise AssertionError(
                "Size of the reference buffer must exceed the horizon span "
                f"({span + 1} points needed, {len(self)} buffered)")
        return [self[int(i)] for i in self._horizon_idx]

    def __len__(self):
        return self._write - self._read

    def __getitem__(self, index: int):
        n = len(self)
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(index)
        return self._slots[(self._read + index) & (self._cap - 1)]

    def __setitem__(self, index: int, value: WeightedTrajectoryPoint):
        n = len(self)
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(index)
        self._slots[(self._read + index) & (self._cap - 1)] = value


def interpolate_weights(
    p1: TrajectoryPointWeights, p2: TrajectoryPointWeights, alpha: float
) -> TrajectoryPointWeights:
    """Linear, dict-aware weight interpolation (reference
    `interpolate_weights`, `trajectory.py:234-279`). Missing dict keys
    interpolate against zero, like the reference."""
    alpha = float(np.clip(alpha, 0.0, 1.0))

    def lerp(a, b):
        return (1.0 - alpha) * a + alpha * b

    def lerp_dict(d1, d2):
        if d1 is None and d2 is None:
            return None
        d1 = d1 or {}
        d2 = d2 or {}
        out = {}
        for key in set(d1) | set(d2):
            if key not in d2:
                out[key] = lerp(d1[key], np.zeros_like(d1[key]))
            elif key not in d1:
                out[key] = lerp(np.zeros_like(d2[key]), d2[key])
            else:
                out[key] = lerp(d1[key], d2[key])
        return out

    def combine(a, b):
        if a is None and b is None:
            return None
        if isinstance(a, dict) or isinstance(b, dict):
            return lerp_dict(a, b)
        if a is None or b is None:
            return a if b is None else b
        return lerp(a, b)

    return TrajectoryPointWeights(
        **{
            f.name: combine(getattr(p1, f.name), getattr(p2, f.name))
            for f in dataclasses.fields(TrajectoryPointWeights)
        }
    )
