"""Meshcat visualization / trajectory replay (reference
`agimus_controller_examples/.../utils/wrapper_meshcat.py:49-162`).

The reference renders the collision model (capsules/spheres) in meshcat and
replays planned/solved trajectories.  meshcat is an optional dependency
here (often not installed): `MeshcatReplay` gates on the import
with a clear error, and `export_scene_json` provides the headless fallback
— the same primitive scene (type/radius/length/per-frame placements) as a
JSON document any external viewer (including a meshcat session elsewhere)
can replay.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..models.model import ModelParams, RobotModel
from ..ops import kinematics


def _geom_world_placements(model: RobotModel, params: ModelParams, q):
    """World (R, p) of every collision geometry at configuration q."""
    import jax.numpy as jnp

    Rs, ps = kinematics.joint_placements(model, params, jnp.asarray(q))
    out = []
    gR = np.asarray(params.geom_rot)
    gp = np.asarray(params.geom_trans)
    for gi, g in enumerate(model.geometries):
        if g.parent_joint < 0:
            out.append((gR[gi], gp[gi]))
        else:
            Rj = np.asarray(Rs[g.parent_joint])
            pj = np.asarray(ps[g.parent_joint])
            out.append((Rj @ gR[gi], Rj @ gp[gi] + pj))
    return out


def scene_description(model: RobotModel, params: ModelParams):
    """Static primitive list: the data `wrapper_meshcat` builds meshcat
    geometries from (capsule radius/length, sphere radius)."""
    rad = np.asarray(params.geom_radius)
    hl = np.asarray(params.geom_halflen)
    return [
        {
            "name": g.name,
            "type": "sphere" if hl[i] == 0.0 else "capsule",
            "radius": float(rad[i]),
            "length": float(2.0 * hl[i]),
        }
        for i, g in enumerate(model.geometries)
    ]


def export_scene_json(model: RobotModel, params: ModelParams, qs, path,
                      every: int = 1) -> dict:
    """Headless replay export: scene primitives + per-frame placements for
    a trajectory qs [K, nq]. Returns the document (also written to path)."""
    doc = {"geometries": scene_description(model, params), "frames": []}
    for k in range(0, len(qs), every):
        frame = []
        for R, p in _geom_world_placements(model, params, qs[k]):
            frame.append({
                "rot": np.asarray(R, float).reshape(-1).tolist(),
                "trans": np.asarray(p, float).tolist(),
            })
        doc["frames"].append(frame)
    Path(path).write_text(json.dumps(doc))
    return doc


class MeshcatReplay:
    """Live meshcat replay (requires the optional `meshcat` package)."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 zmq_url: Optional[str] = None):
        try:
            import meshcat
            import meshcat.geometry as mg
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "meshcat is not installed in this environment; use "
                "export_scene_json for the headless replay document"
            ) from e
        self._model = model
        self._params = params
        self._vis = (meshcat.Visualizer(zmq_url=zmq_url)
                     if zmq_url else meshcat.Visualizer())
        rad = np.asarray(params.geom_radius)
        hl = np.asarray(params.geom_halflen)
        for i, g in enumerate(model.geometries):  # pragma: no cover
            geom = (mg.Sphere(float(rad[i])) if hl[i] == 0.0
                    else mg.Cylinder(float(2 * hl[i]), float(rad[i])))
            self._vis[f"geoms/{g.name}"].set_object(geom)

    def display(self, q) -> None:  # pragma: no cover - optional dep
        for (R, p), g in zip(
                _geom_world_placements(self._model, self._params, q),
                self._model.geometries):
            T = np.eye(4)
            T[:3, :3] = R
            T[:3, 3] = p
            self._vis[f"geoms/{g.name}"].set_transform(T)

    def replay(self, qs, dt: float = 0.01) -> None:  # pragma: no cover
        import time

        for q in qs:
            self.display(q)
            time.sleep(dt)
