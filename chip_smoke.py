"""Smoke run of the MPC engine on NVIDIA GPUs: the quickest proof that the
system still starts on the card.

    python chip_smoke.py          # phases 1-4 on one GPU
    python chip_smoke.py --four   # only the multi-card phase, on four GPUs

Every phase drives the engine through its public entry points at the full
width of the Panda 7-DoF model (nx=14, nu=7), in f32 unless stated, prints
its compile time and its check, and raises on a failed check. The script
exits non-zero, and prints no result line, when JAX finds no GPU. The last
line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Phases (one card):
  1. stage evaluation: the derivative pass the SQP solver runs
     (`sqp_batch.make_stage_derivs`) against the plain pointwise reference
     (`vmap` of `CostFunctions.stage_derivs`, jacfwd dynamics) at T=100,
     B=1, 8, 1024, on the constrained collision spec;
  2. the reference's controller loop: `create_ocp("goal_reaching")`,
     `create_warm_start`, `MPC`, `ControllerRuntime`, default solver,
     30 ticks of a streamed quintic end-effector goal;
  3. the fused runtime tick (`FusedTickRunner`) at T=100: 50 ticks with the
     K0/u0 readback in every tick;
  4. the batch solvers: constrained CSQP at B=1024 (one cold, 5 warm
     solves, collision band held) and batch FDDP at B=4096, T=100.
Phase ``--four``: the scenario-sharded SQP (B=4x256) and the
horizon-sharded FDDP, each against the same problem solved on one card.

Phases 3 and 4a also print their steady-state times. They are taken while
the other phases compile and run beside them, so they are a sign of life,
not a benchmark.

The phases are independent and run in threads: a cold run is dominated by
XLA compilation (minutes per solver program), and threads let the
compilations overlap. Each phase's output is printed in order at the end.
"""

from __future__ import annotations

import argparse
import io
import json
import subprocess
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

T = 100
DT = 0.01
EE = "panda_hand_tcp"
OBSTACLE_URDF = """<?xml version="1.0"?>
<robot name="env"><link name="obstacle_base"/>
<joint name="obstacle_joint" type="fixed">
<parent link="obstacle_base"/><child link="obstacle"/>
<origin xyz="0.5 0.0 0.5" rpy="0 0 0"/></joint>
<link name="obstacle"><collision name="obstacle_sphere">
<geometry><sphere radius="0.1"/></geometry></collision></link></robot>"""


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  check {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise CheckFailed(what)


def compile_timed(name, fn, *args):
    """jit + lower + compile ``fn`` at ``args``; prints the compile time and
    the executable's memory analysis. Returns the compiled executable."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    mem = compiled.memory_analysis()
    mib = lambda b: f"{b / 2**20:.1f} MiB"  # noqa: E731
    print(f"  compile {name}: {time.perf_counter() - t0:.1f} s; memory: "
          f"args {mib(mem.argument_size_in_bytes)}, "
          f"out {mib(mem.output_size_in_bytes)}, "
          f"temp {mib(mem.temp_size_in_bytes)}, "
          f"code {mib(mem.generated_code_size_in_bytes)}", flush=True)
    return compiled


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

def collision_problem(horizon: int = T, dtype=None):
    """The constrained benchmark problem: goal placement + gravity-control
    regularisation, a 2 cm keep-away band between the last link's capsule
    and a sphere. Returns (model, params, spec, cf, refs, x0)."""
    import jax.numpy as jnp

    from agimus_controller_tpu.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu.ocp.costs import build_cost_functions
    from agimus_controller_tpu.ocp.spec import (
        ConstraintItem,
        CostItem,
        ProblemSpec,
        default_references,
    )
    from agimus_controller_tpu.ops import kinematics

    dtype = dtype or jnp.float32
    model, params = load_panda(
        env_urdf=OBSTACLE_URDF,
        collision_pairs=[("panda_link7_capsule", "obstacle_sphere")])
    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="ctrl", kind="control_grav", weight=1e-3,
                     act_weights=(1.0,) * 7),
            CostItem(name="goal", kind="frame_placement", weight=10.0,
                     update=True, frame=EE),
        ),
        terminal_costs=(
            CostItem(name="goal", kind="frame_placement", weight=100.0,
                     update=True, frame=EE),
        ),
        constraints=(
            ConstraintItem(name="coll", kind="collision_distance",
                           pair_id=0, lower=(0.02,)),
        ),
        horizon=horizon, dt=DT,
    )
    cf = build_cost_functions(model, params, spec, dtype=dtype)
    refs = default_references(spec, model, dtype=dtype)
    q0 = jnp.asarray(PANDA_Q_READY, dtype)
    x0 = jnp.concatenate([q0, jnp.zeros(7, dtype)])
    R0, _ = kinematics.frame_placement(model, params, q0, model.frame_id(EE))
    n = horizon + 1
    refs["xref"] = jnp.tile(x0[None], (n, 1))
    refs["w_x"] = jnp.tile(jnp.concatenate(
        [jnp.full(7, 0.1), jnp.full(7, 1.0)]).astype(dtype)[None], (n, 1))
    refs[f"ee_rot:{EE}"] = jnp.tile(R0[None], (n, 1, 1))
    refs[f"ee_trans:{EE}"] = jnp.tile(
        jnp.asarray([0.45, 0.05, 0.55], dtype)[None], (n, 1))
    return model, params, spec, cf, refs, x0


def min_band_distance(model, params, xs) -> float:
    """Smallest capsule-sphere distance over the controllable nodes t>=1
    (node 0 is the measured state, which no solver can move)."""
    import jax
    import jax.numpy as jnp

    from agimus_controller_tpu.ops import collision

    qs = jnp.asarray(np.asarray(xs)[:, 1:, :7].reshape(-1, 7))
    return float(jnp.min(jax.jit(jax.vmap(
        lambda q: collision.pair_distance(model, params, q, 0)))(qs)))


# ---------------------------------------------------------------------------
# phase 1: stage evaluation against the plain reference
# ---------------------------------------------------------------------------

# (atol, rtol) per output, as |route - reference| <= atol + rtol * |reference|.
# Both sides run on the card in f32 at HIGHEST matmul precision. They differ
# in operation order only: the reference takes jacfwd of the pointwise Euler
# step and of every residual; the solver's route uses closed-form RNEA
# derivatives, component-form Cholesky and cost tangents. In f64 the CPU
# tests hold the same pair to 1e-8 (tests/test_batched_costs.py,
# tests/test_batched_dynamics.py); these f32 bounds are the ones the stage
# math was held to in f32 against its XLA form, with no loosening.
STAGE_TOL = {
    "xnext": (2e-5, 0.0), "Fx": (2e-4, 0.0), "Fu": (2e-5, 0.0),
    "l": (1e-6, 2e-4), "lx": (2e-4, 1e-3), "lu": (2e-5, 1e-3),
    "lxx": (5e-4, 1e-3), "lxu": (2e-5, 1e-3), "luu": (2e-5, 1e-3),
}


def phase_stage(batches=(1, 8, 1024), horizon: int = T, seed: int = 0):
    import jax
    import jax.numpy as jnp

    from agimus_controller_tpu.models.panda import PANDA_Q_READY
    from agimus_controller_tpu.solver.sqp_batch import make_stage_derivs

    print(f"phase 1: stage evaluation vs the pointwise reference, T={horizon}, "
          "f32, matmul precision HIGHEST", flush=True)
    print("  tolerances (atol, rtol): " + ", ".join(
        f"{k} {v}" for k, v in STAGE_TOL.items()), flush=True)
    model, params, spec, cf, refs, _ = collision_problem(horizon)
    rng = np.random.default_rng(seed)
    derivs = make_stage_derivs(model, params, spec, cf)
    ref_fn = jax.vmap(cf.stage_derivs, in_axes=(0, 0, 0, None))
    names = ("xnext", "Fx", "Fu", "l", "lx", "lu", "lxx", "lxu", "luu")

    def solver_route(xs, us, refs):
        # the solver's time-major [T, B, ...] blocks as node-major rows,
        # nodes (t, b) with b fastest, as the reference takes them
        dyn, costs, _ = derivs(xs, us, refs)
        return tuple(a.reshape((-1,) + a.shape[2:]) for a in (*dyn, *costs))

    for B in batches:
        N = horizon * B
        x = jnp.asarray(np.concatenate(
            [np.tile(PANDA_Q_READY, (N, 1)), np.zeros((N, 7))], 1)
            + rng.normal(size=(N, 14)) * 0.1, jnp.float32)
        u = jnp.asarray(rng.normal(size=(N, 7)) * 2.0, jnp.float32)
        t_idx = jnp.repeat(jnp.arange(horizon, dtype=jnp.int32), B)
        xs = jnp.concatenate([x.reshape(horizon, B, 14), x[-B:][None]])
        us = u.reshape(horizon, B, 7)
        with jax.default_matmul_precision("highest"):
            got_c = compile_timed(f"stage[solver] B={B} N={N}", solver_route,
                                  xs, us, refs)
            ref_c = compile_timed(f"stage[reference] B={B}", ref_fn,
                                  x, u, t_idx, refs)
        got = got_c(xs, us, refs)
        r = ref_c(x, u, t_idx, refs)
        want = dict(xnext=r.xnext, Fx=r.Fx, Fu=r.Fu, l=r.cost, lx=r.lx,
                    lu=r.lu, lxx=r.lxx, lxu=r.lxu, luu=r.luu)
        for name, g in zip(names, got):
            w = np.asarray(want[name], np.float64)
            g = np.asarray(g, np.float64)
            atol, rtol = STAGE_TOL[name]
            err = np.abs(g - w)
            worst = float(np.max(err - rtol * np.abs(w)))
            check(g.shape == w.shape and np.isfinite(g).all()
                  and worst <= atol,
                  f"B={B} {name}{tuple(g.shape)}: max|err| "
                  f"{float(err.max()):.2e}, worst excess over rtol "
                  f"{worst:.2e} <= atol {atol:.0e}")


# ---------------------------------------------------------------------------
# phase 2: the reference's controller loop
# ---------------------------------------------------------------------------

def phase_controller(horizon: int = T, ticks: int = 30):
    import jax.numpy as jnp

    from agimus_controller_tpu.factory import create_ocp, create_warm_start
    from agimus_controller_tpu.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryBuffer,
        TrajectoryPoint,
        TrajectoryPointWeights,
        WeightedTrajectoryPoint,
    )
    from agimus_controller_tpu.mpc.mpc import MPC
    from agimus_controller_tpu.mpc.ocp_base import OCPParams
    from agimus_controller_tpu.ops import dynamics, kinematics
    from agimus_controller_tpu.runtime.controller import (
        ControllerRuntime,
        RuntimeParams,
        Sensor,
    )
    from agimus_controller_tpu.trajectories.base import QuinticTrajectory

    print(f"phase 2: controller loop (goal_reaching OCP, T={horizon}, "
          f"solver=auto, {ticks} ticks)", flush=True)
    model, params = load_panda()
    ocp = create_ocp("goal_reaching", model, params,
                     OCPParams(dt=DT, horizon_size=horizon), ee_frame=EE,
                     w_goal_terminal=10.0)
    print(f"  solver route: {ocp._solver_kind}", flush=True)
    buffer = TrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[horizon]))
    ws = create_warm_start("shift_previous_solution", model, params,
                           timesteps=ocp.spec.timesteps())
    ws_ref = create_warm_start("reference", model, params)
    mpc = MPC()
    mpc.setup(ocp, ws, buffer)
    rt = ControllerRuntime(mpc, buffer, ws_ref, RuntimeParams())

    q0 = np.asarray(PANDA_Q_READY, np.float64)
    fid = model.frame_id(EE)
    ee = lambda q: np.asarray(kinematics.frame_placement(  # noqa: E731
        model, params, jnp.asarray(q, jnp.float32), fid)[1], np.float64)
    R0 = np.asarray(kinematics.frame_placement(
        model, params, jnp.asarray(q0, jnp.float32), fid)[0])
    p0 = ee(q0)
    goal = p0 + np.asarray([0.05, -0.05, 0.08])
    tau_g = np.asarray(dynamics.rnea(
        model, params, jnp.asarray(q0, jnp.float32), jnp.zeros(7),
        jnp.zeros(7)), np.float64)
    ramp = QuinticTrajectory(scale_duration=[0.5])

    def point(i):
        s = float(ramp.get_value_at_t(i * DT)[0][0])
        pt = TrajectoryPoint(
            id=i, time_ns=int(i * DT * 1e9), robot_configuration=q0,
            robot_velocity=np.zeros(7), robot_acceleration=np.zeros(7),
            robot_effort=tau_g,
            end_effector_poses={EE: (R0, p0 + s * (goal - p0))})
        w = TrajectoryPointWeights(
            w_robot_configuration=np.full(7, 0.1),
            w_robot_velocity=np.full(7, 1.0), w_robot_effort=np.full(7, 1e-2),
            w_end_effector_poses={EE: np.full(6, 100.0)})
        return WeightedTrajectoryPoint(point=pt, weights=w)

    n_stream = 0
    for _ in range(2 * horizon + 2):
        rt.append_reference(point(n_stream))
        n_stream += 1
    q, v = q0.copy(), np.zeros(7)
    err0 = float(np.linalg.norm(ee(q) - goal))
    errs_T = []
    for it in range(ticks):
        now = int(it * DT * 1e9)
        rt.set_sensor(Sensor(time_ns=now, position=q, velocity=v))
        t0 = time.perf_counter()
        ctrl = rt.step(now_ns=now)
        if it == 0:
            print(f"  first tick (compile + unlimited first solve + budget "
                  f"calibration): {time.perf_counter() - t0:.1f} s",
                  flush=True)
        if ctrl is None or not (
                np.isfinite(ctrl.feedback_gain).all()
                and np.isfinite(ctrl.feedforward).all()
                and ctrl.feedback_gain.shape == (7, 14)):
            check(False, f"tick {it}: K[0] [7,14] and u[0] finite")
        xT = np.asarray(ocp.ocp_results.states[-1])
        errs_T.append(float(np.linalg.norm(ee(xT[:7]) - goal)))
        x = ocp.integrate(np.concatenate([q, v]), ctrl.feedforward)
        q, v = np.asarray(x[:7], np.float64), np.asarray(x[7:], np.float64)
        rt.append_reference(point(n_stream))
        n_stream += 1
    check(True, f"{ticks} ticks: K[0] [7,14] and u[0] finite in every tick")
    err_plant = float(np.linalg.norm(ee(q) - goal))
    print(f"  plant EE error to the goal: {err0 * 1e3:.1f} mm at start, "
          f"{err_plant * 1e3:.1f} mm after {ticks} ticks", flush=True)
    check(max(errs_T) < err0, f"predicted terminal EE error below the "
          f"start's {err0 * 1e3:.1f} mm in every tick (worst "
          f"{max(errs_T) * 1e3:.1f} mm)")
    check(errs_T[-1] < 0.02, f"predicted terminal EE error "
          f"{errs_T[-1] * 1e3:.1f} mm < 20 mm")


# ---------------------------------------------------------------------------
# phase 3: the fused runtime tick
# ---------------------------------------------------------------------------

def phase_tick(horizon: int = T, ticks: int = 50):
    import jax.numpy as jnp

    from __graft_entry__ import _build_spec
    from agimus_controller_tpu.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu.mpc.buffer import (
        DTFactorsNSeq,
        TrajectoryPoint,
        TrajectoryPointWeights,
        WeightedTrajectoryPoint,
    )
    from agimus_controller_tpu.mpc.ring import PackedTrajectoryBuffer, RowLayout
    from agimus_controller_tpu.mpc.tick import FusedTickRunner
    from agimus_controller_tpu.ops import dynamics, kinematics
    from agimus_controller_tpu.solver.csqp import CSQPSettings

    print(f"phase 3: fused runtime tick, T={horizon}, {ticks} ticks with "
          "K0/u0 readback", flush=True)
    dtype = jnp.float32
    model, params = load_panda()
    spec, cf, refs, x0 = _build_spec(model, params, horizon, dtype)
    layout = RowLayout(spec, model)
    buf = PackedTrajectoryBuffer(
        DTFactorsNSeq(factors=[1], n_steps=[horizon]), layout, dtype=dtype)
    q0 = np.asarray(PANDA_Q_READY)
    fid = model.frame_id(EE)
    R0, p0 = (np.asarray(a) for a in kinematics.frame_placement(
        model, params, jnp.asarray(q0, dtype), fid))
    tau_g = np.asarray(dynamics.rnea(
        model, params, jnp.asarray(q0, dtype), jnp.zeros(7, dtype),
        jnp.zeros(7, dtype)))
    goal = p0 + np.asarray([0.05, -0.05, 0.08])

    def mk(i):
        pt = TrajectoryPoint(
            id=i, time_ns=int(i * 1e7), robot_configuration=q0,
            robot_velocity=np.zeros(7), robot_acceleration=np.zeros(7),
            robot_effort=tau_g, end_effector_poses={EE: (R0, goal)})
        w = TrajectoryPointWeights(
            w_robot_configuration=np.full(7, 0.1),
            w_robot_velocity=np.full(7, 1.0), w_robot_effort=np.ones(7),
            w_end_effector_poses={EE: np.ones(6)})
        return WeightedTrajectoryPoint(point=pt, weights=w)

    for i in range(3 * horizon + ticks + 10):
        buf.append(mk(i))
    runner = FusedTickRunner(
        model, params, spec, cf, buf.ring, refs,
        CSQPSettings(max_iters=10, reg_init=1e-7, termination_tolerance=1e-4),
        dtype=dtype)
    x0h = np.asarray(x0)
    t0 = time.perf_counter()
    runner.initialize(x0h, np.tile(x0h[None], (horizon + 1, 1)),
                      np.tile(tau_g[None], (horizon, 1)), limit=300)
    _, _, kkt0, it0, conv0 = runner.fetch()
    print(f"  compile + first solve: {time.perf_counter() - t0:.1f} s "
          f"(iters={it0}, kkt={kkt0:.2e}, converged={conv0})", flush=True)
    rng = np.random.default_rng(0)
    finite = True
    times = []
    for i in range(ticks):
        xi = np.concatenate([q0 + rng.normal(size=7) * 0.002, np.zeros(7)])
        t0 = time.perf_counter()
        runner.step(xi, limit=2)
        K0, u0, *_ = runner.fetch()
        times.append(time.perf_counter() - t0)
        finite &= bool(np.isfinite(K0).all() and np.isfinite(u0).all())
    print(f"  tick (2 iterations + K0/u0 readback): median "
          f"{np.median(times) * 1e3:.3f} ms, max {max(times) * 1e3:.3f} ms "
          "over the ticks, beside the other phases", flush=True)
    check(finite, f"{ticks} ticks: K0 and u0 finite in every tick")
    runner.step(x0h, limit=10)
    K0, u0, kkt, iters, conv = runner.fetch()
    check(conv and np.isfinite(u0).all() and np.isfinite(K0).all(),
          f"full-budget tick converges: kkt={kkt:.2e}, iters={iters}")
    xT = np.asarray(runner._xs[-1])
    _, pT = kinematics.frame_placement(
        model, params, jnp.asarray(xT[:7], dtype), fid)
    ee_err = float(np.linalg.norm(np.asarray(pT) - goal))
    check(ee_err < 0.02, f"terminal EE error {ee_err * 1e3:.1f} mm < 20 mm")


# ---------------------------------------------------------------------------
# phase 4: the batch solvers at the benchmark's shapes
# ---------------------------------------------------------------------------

def phase_csqp(b_csqp: int = 1024, horizon: int = T, n_warm: int = 5):
    import jax
    import jax.numpy as jnp

    from agimus_controller_tpu.solver.csqp import CSQPSettings
    from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp

    print(f"phase 4a: constrained batch CSQP, B={b_csqp}, T={horizon}",
          flush=True)
    dtype = jnp.float32
    model, params, spec, cf, refs, x0 = collision_problem(horizon)
    # one executable serves the cold and the warm solves: the iteration
    # limit is a runtime argument
    solve = make_batch_sqp(model, params, spec, cf, CSQPSettings(
        max_iters=100, max_qp_iters=100, reg_init=1e-7,
        termination_tolerance=1e-4))
    x0s = jnp.tile(x0[None], (b_csqp, 1))
    xs0 = jnp.tile(x0[None, None], (b_csqp, horizon + 1, 1))
    us0 = jnp.zeros((b_csqp, horizon, 7), dtype)
    y0 = jnp.zeros((b_csqp, horizon + 1, 1), dtype)
    lim = lambda n: jnp.asarray(n, jnp.int32)  # noqa: E731
    csqp = compile_timed(f"csqp B={b_csqp}", solve, x0s, refs, xs0, us0,
                         lim(100), y0)
    t0 = time.perf_counter()
    sol = csqp(x0s, refs, xs0, us0, lim(100), y0)
    jax.block_until_ready(sol.cost)
    t_cold = time.perf_counter() - t0
    check(bool(jnp.all(jnp.isfinite(sol.us))),
          f"cold solve finite; converged {int(jnp.sum(sol.converged))}"
          f"/{b_csqp}, max kkt {float(jnp.max(sol.kkt)):.2e}")
    rng = np.random.default_rng(0)
    times = []
    for _ in range(n_warm):
        x0w = x0s + jnp.asarray(np.concatenate(
            [rng.normal(size=(b_csqp, 7)) * 0.005,
             np.zeros((b_csqp, 7))], 1), dtype)
        t0 = time.perf_counter()
        sol = csqp(x0w, refs, sol.xs, sol.us, lim(10), sol.y)
        jax.block_until_ready(sol.cost)
        times.append(time.perf_counter() - t0)
    print(f"  solve times beside the other phases: cold {t_cold * 1e3:.1f} ms"
          f" (iters <= 100), warm median {np.median(times) * 1e3:.1f} ms "
          "(iters <= 10)", flush=True)
    dmin = min_band_distance(model, params, sol.xs)
    check(bool(jnp.all(jnp.isfinite(sol.us))) and dmin > 0.02 - 1e-3,
          f"{n_warm} warm solves: min distance over t>=1 {dmin:.4f} m "
          "> band 0.02 - 1e-3")


def phase_fddp(b_fddp: int = 4096, horizon: int = T):
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build_spec
    from agimus_controller_tpu.models.panda import load_panda
    from agimus_controller_tpu.solver.fddp import SolverSettings
    from agimus_controller_tpu.solver.fddp_batch import make_batch_fddp

    print(f"phase 4b: batch FDDP, B={b_fddp}, T={horizon}", flush=True)
    dtype = jnp.float32
    model, params = load_panda()
    spec, cf, refs, x0 = _build_spec(model, params, horizon, dtype)
    fddp = make_batch_fddp(model, params, spec, cf,
                           SolverSettings(max_iters=10))
    x0s = jnp.tile(x0[None], (b_fddp, 1))
    xs0 = jnp.tile(x0[None, None], (b_fddp, horizon + 1, 1))
    us0 = jnp.zeros((b_fddp, horizon, 7), dtype)
    fddp_c = compile_timed(f"fddp B={b_fddp}", fddp, x0s, refs, xs0, us0)
    sol = fddp_c(x0s, refs, xs0, us0)
    cost0 = float(jnp.sum(jax.vmap(lambda x, u, t: cf.stage_cost(
        x, u, t, refs))(xs0[0, :-1], us0[0], jnp.arange(horizon)))
        + cf.terminal_cost(xs0[0, -1], refs))
    cost = np.asarray(sol.cost)
    check(bool(jnp.all(jnp.isfinite(sol.us))) and np.isfinite(cost).all()
          and float(cost.max()) < cost0,
          f"solve finite, cost {float(cost.max()):.4f} < initial {cost0:.4f}")


# ---------------------------------------------------------------------------
# phase --four: the multi-card paths
# ---------------------------------------------------------------------------

def _four_sqp(n_cards: int, b_per_card: int, horizon: int, sharded: bool):
    """(us, xs, converged) of the collision CSQP on ``b_per_card`` scenarios
    whose initial joint positions are perturbed: solved on one card, or
    repeated once per card (B = n_cards x b_per_card) with the batch sharded
    over the cards, so that card c holds copy c."""
    import jax
    import jax.numpy as jnp

    from agimus_controller_tpu.parallel.mesh import (
        make_mesh,
        shard_batch,
        sharded_batch_sqp,
    )
    from agimus_controller_tpu.solver.csqp import CSQPSettings
    from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp

    model, params, spec, cf, refs, x0 = collision_problem(horizon)
    # phase 4a's settings: every scenario converges, so the solutions are
    # pinned by the termination tolerance, not by the iteration path
    st = CSQPSettings(max_iters=100, max_qp_iters=100, reg_init=1e-7,
                      termination_tolerance=1e-4)
    dq = np.random.default_rng(0).normal(size=(b_per_card, 7)) * 0.005
    x0s = x0[None] + jnp.asarray(
        np.concatenate([dq, np.zeros((b_per_card, 7))], 1), jnp.float32)
    copies = n_cards if sharded else 1
    B = copies * b_per_card
    args = (jnp.tile(x0s, (copies, 1)),
            jnp.tile(x0[None, None], (B, horizon + 1, 1)),
            jnp.zeros((B, horizon, 7), jnp.float32))
    t0 = time.perf_counter()
    if sharded:
        mesh = make_mesh(n_cards)
        x0s, xs0, us0 = shard_batch(mesh, args)
        solve = sharded_batch_sqp(model, params, spec, cf, st, mesh)
    else:
        x0s, xs0, us0 = args
        solve = jax.jit(make_batch_sqp(model, params, spec, cf, st))
    sol = solve(x0s, refs, xs0, us0)
    jax.block_until_ready(sol.cost)
    print(f"  CSQP B={B} {'sharded' if sharded else 'one card'}: compile + "
          f"solve {time.perf_counter() - t0:.1f} s; converged "
          f"{int(np.sum(sol.converged))}/{B}", flush=True)
    return np.asarray(sol.us), np.asarray(sol.xs), np.asarray(sol.converged)


def _four_fddp(n_cards: int, horizon: int, sharded: bool):
    """(us, cost, initial cost) of the f64 FDDP solve with the horizon
    sharded over the cards, or on one card."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build_problem
    from agimus_controller_tpu.parallel.mesh import make_mesh
    from agimus_controller_tpu.solver.fddp import SolverSettings, solve_fddp
    from agimus_controller_tpu.solver.riccati_sharded import solve_fddp_tsharded

    # thread-local: the sharded SQP traced beside this stays f32
    with jax.enable_x64(True):
        cf, x0, refs, xs0, us0 = _build_problem(horizon, jnp.float64)
        st = SolverSettings(max_iters=2, n_alphas=4)
        t0 = time.perf_counter()
        if sharded:
            mesh = make_mesh(n_cards, axis_name="t")
            sol = jax.jit(lambda: solve_fddp_tsharded(
                cf, x0, refs, xs0, us0, st, mesh))()
        else:
            sol = jax.jit(lambda: solve_fddp(cf, x0, refs, xs0, us0, st))()
        jax.block_until_ready(sol.cost)
        print(f"  FDDP T={horizon} {'sharded' if sharded else 'one card'}: "
              f"compile + solve {time.perf_counter() - t0:.1f} s", flush=True)
        cost0 = float(jax.jit(lambda: jnp.sum(jax.vmap(
            lambda x, u, t: cf.stage_cost(x, u, t, refs))(
                xs0[:-1], us0, jnp.arange(horizon)))
            + cf.terminal_cost(xs0[-1], refs))())
        return np.asarray(sol.us), float(sol.cost), cost0


def phase_four(n_cards: int = 4, b_per_card: int = 256, horizon: int = T,
               t_sharded: int = 160):
    print(f"phase four: scenario-sharded CSQP (B={n_cards}x{b_per_card}, "
          f"T={horizon}) and horizon-sharded FDDP (T={t_sharded}, f64) over "
          f"{n_cards} cards, each against one card", flush=True)
    (us, xs, _), (us1, xs1, _), (fus, fcost, fcost0), (fus1, _, _) = (
        run_phases([
            ("CSQP sharded", lambda: _four_sqp(n_cards, b_per_card, horizon,
                                               True)),
            ("CSQP one card", lambda: _four_sqp(n_cards, b_per_card, horizon,
                                                False)),
            ("FDDP sharded", lambda: _four_fddp(n_cards, t_sharded, True)),
            ("FDDP one card", lambda: _four_fddp(n_cards, t_sharded, False)),
        ]))
    us = us.reshape((n_cards,) + us1.shape)
    xs = xs.reshape((n_cards,) + xs1.shape)
    check(np.isfinite(us).all() and (us == us[:1]).all()
          and (xs == xs[:1]).all(),
          f"CSQP: the {n_cards} copies of the {b_per_card} scenarios bitwise "
          f"equal across {n_cards} cards")
    du = float(np.max(np.abs(us1 - us[0])))
    dx = float(np.max(np.abs(xs1 - xs[0])))
    # Each card runs the one-card computation on its own scenarios, but the
    # two programs are compiled apart, so their rounding differs, and a
    # solve stops anywhere inside its KKT tolerance of 1e-4. Two one-card
    # f32 solves of these problems whose x0 differ by 1e-7 (relative) end
    # up to 5.6e-3 apart in u and 2.6e-4 in x (XLA:CPU, T=100, B=8); the
    # bounds are about twenty times that, for the worst of 256 scenarios.
    # A scenario on the wrong card or in the wrong place misses them:
    # initial joint positions differ by ~1e-2 between scenarios.
    check(du < 1e-1 and dx < 5e-3,
          f"CSQP same solutions as one card, scenario by scenario: max|du| "
          f"{du:.2e} < 1e-1, max|dx| {dx:.2e} < 5e-3")
    check(bool(np.isfinite(fus).all()) and fcost < fcost0,
          f"FDDP finite, cost {fcost:.6f} < initial {fcost0:.6f}")
    dfu = float(np.max(np.abs(fus - fus1)))
    # f64, exact block composition: only reduction order differs
    check(dfu < 1e-8, f"FDDP same solution as one card: max|du| {dfu:.2e} "
          "< 1e-8")


# ---------------------------------------------------------------------------

class _PhaseOutput:
    """sys.stdout stand-in that keeps each phase thread's prints apart."""

    def __init__(self, real):
        self.real = real
        self.bufs = {}

    def write(self, text):
        return self.bufs.get(threading.get_ident(), self.real).write(text)

    def flush(self):
        self.real.flush()


def run_phases(phases):
    """Run independent phases in threads, so that their XLA compilations
    (which dominate a cold run) overlap; then print each phase's output in
    order. Returns the phases' results; raises if any phase failed."""
    out = _PhaseOutput(sys.stdout)

    def run(fn):
        buf = out.bufs[threading.get_ident()] = io.StringIO()
        try:
            return buf, fn(), None
        except Exception as exc:  # printed in order below, then re-raised
            traceback.print_exc(file=buf)
            return buf, None, exc

    sys.stdout = out
    try:
        with ThreadPoolExecutor(len(phases)) as pool:
            done = list(pool.map(run, [fn for _, fn in phases]))
    finally:
        sys.stdout = out.real
    failed = []
    for (name, _), (buf, _, exc) in zip(phases, done):
        print(buf.getvalue(), end="", flush=True)
        if exc is not None:
            failed.append(name)
    if failed:
        raise CheckFailed(f"phases failed: {', '.join(failed)}")
    return [result for _, result, _ in done]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-card phase, on four GPUs")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four else 1

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"{devices[0].platform!r}); nothing was run", file=sys.stderr)
        return 2
    if len(devices) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2

    from agimus_controller_tpu.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    print(f"jax {jax.__version__}; {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)

    print("phases run concurrently: compile times overlap", flush=True)
    t_start = time.perf_counter()
    if args.four:
        phase_four(n_cards)
    else:
        run_phases([
            ("stage B=1", lambda: phase_stage(batches=(1,))),
            ("stage B=8", lambda: phase_stage(batches=(8,))),
            ("stage B=1024", lambda: phase_stage(batches=(1024,))),
            ("controller", phase_controller),
            ("tick", phase_tick),
            ("csqp", phase_csqp),
            ("fddp", phase_fddp),
        ])
    print(f"all phases passed in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
