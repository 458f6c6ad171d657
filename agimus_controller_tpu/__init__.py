"""agimus_controller_tpu — batched, accelerator-native whole-body MPC engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``agimus-project/agimus_controller``: receding-horizon MPC for torque-controlled
manipulators. The reference orchestrates C++ numerics (Pinocchio dynamics,
Crocoddyl OCP models, mim_solvers CSQP) from Python; here every numeric path is
a pure, jittable, batched JAX function designed for an accelerator:

- ``ops``     — spatial algebra, FK, RNEA, CRBA, forward dynamics, residuals,
                activations, collision distances (the Pinocchio/Crocoddyl/colmpc
                numeric surface, reference SURVEY.md §2b N1-N7).
- ``models``  — URDF -> static model-constant arrays compiler + Panda fixture
                (reference: agimus_controller/factory/robot_model.py).
- ``ocp``     — static OCP problem specs + the YAML OCP DSL compiler
                (reference: agimus_controller/ocp/ocp_croco_generic.py).
- ``solver``  — FDDP / constrained CSQP solvers as jitted lax.scan Riccati
                recursions (reference: mim_solvers SolverCSQP).
- ``mpc``     — MPC orchestration, trajectory buffer, warm starts
                (reference: agimus_controller/mpc.py, trajectory.py).
- ``trajectories`` — reference trajectory generators (sine, quintic, generic,
                visual servoing; reference: agimus_controller/trajectories/).
- ``parallel`` — scenario batching + mesh sharding (vmap/pjit/shard_map).
"""

__version__ = "0.1.0"
