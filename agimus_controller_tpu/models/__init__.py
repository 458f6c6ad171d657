"""Robot model layer: URDF/SRDF -> static model-constant arrays.

JAX-native equivalent of the reference's model factory
(`agimus_controller/factory/robot_model.py`): instead of building a mutable
Pinocchio model object, the URDF is compiled host-side into a static topology
(`RobotModel`) plus a pytree of numeric constants (`ModelParams`) that flow
through jitted kernels — so model-parameter sweeps batch with `vmap`.
"""

from .model import Frame, Geometry, ModelParams, RobotModel
from .urdf import RobotModelParameters, build_model_from_urdf, build_robot_models

__all__ = [
    "Frame",
    "Geometry",
    "ModelParams",
    "RobotModel",
    "RobotModelParameters",
    "build_model_from_urdf",
    "build_robot_models",
]
