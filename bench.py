"""Benchmark: Panda MPC on one GPU at T=100 (BASELINE.json config 1/3).

Prints one JSON line {"metric", "value", "unit", "vs_baseline"} per mode.

Baseline: the reference runs ~100 solves/s/robot on CPU (one CSQP solve per
10 ms tick at 100 Hz, BASELINE.md). Problem: Panda 7-DoF tracking OCP, T=100
horizon, 10 solver-iteration budget per tick.

Modes (env BENCH_MODE):
  batch    (default) batch-native throughput, B=4096 scenarios -> solves/s;
           vs_baseline = solves/s / 100. The default run ALSO executes the
           latency/csqp/runtime modes in the same process and prints their
           JSON lines after the headline line (BENCH_EXTRA=0 skips them);
           the headline is printed again last.
  latency  per-solve latency of the multiple-shooting SQP latency path.
           Measures an MPC-style chain: each solve warm-starts from the
           previous solution, so solves are device-serialized and total/K
           is the per-solve device latency. vs_baseline = 10 ms / p50.
  csqp     constrained CSQP throughput (collision keep-away band active,
           matching the reference's runtime solver + colmpc stack,
           BASELINE configs 3-4); vs_baseline = solves/s / 100.
  runtime  END-TO-END MPC tick on the production control loop: the fused
           single-dispatch tick (`mpc/tick.py` — device-resident warm-start
           shift + ring gather + batch-SQP solve) driven tick-by-tick with
           per-tick host reference packing and a drifting sensor state.
           Ticks are chained (each depends on the previous device carry) and
           synced once per chunk, so chunk_time/K is the per-tick cost
           including host packing. vs_baseline = 10 ms / p50.
  vmap     naive vmapped FDDP (diagnostic).

BENCH_BATCH, BENCH_T, BENCH_SOLVER (batch mode: fddp|sqp) override defaults.
All modes run in one process (one process per card). A mode that fails
makes the run exit non-zero.
"""

import json
import os
import sys
import time
import traceback

import numpy as np

DEFAULT_BATCH = {"batch": 4096, "latency": 8, "csqp": 1024}


def _metric(name, value, unit, vs_baseline):
    return json.dumps({"metric": name, "value": round(value, 3), "unit": unit,
                       "vs_baseline": round(vs_baseline, 3)})


def _chain_latency(solver, x0s, refs, xs0, us0, k=40):
    """MPC-tick-style chained solves: each tick gets a NEW initial state (a
    drifting sensor reading) and warm-starts from the previous solution —
    the reference's 100 Hz loop (`agimus_controller.py:474-523`). Solves are
    device-serialized through the warm-start dependency, so chain_time / k
    is the per-solve device latency."""
    import jax
    import jax.numpy as jnp

    B, nx = x0s.shape
    rng = np.random.default_rng(0)
    drift = 0.05 * np.sin(np.linspace(0, 4 * np.pi, 2 * k))[:, None, None] \
        * rng.normal(size=(1, B, nx // 2))
    x0_seq = jnp.asarray(np.concatenate(
        [np.asarray(x0s)[None, :, :nx // 2] + drift,
         np.tile(np.asarray(x0s)[None, :, nx // 2:], (2 * k, 1, 1))],
        axis=2), x0s.dtype)

    sol = solver(x0s, refs, xs0, us0)
    jax.block_until_ready(sol.cost)

    def chain(n, s):
        t0 = time.perf_counter()
        for i in range(n):
            s = solver(x0_seq[i % (2 * k)], refs, s.xs, s.us)
        jax.block_until_ready(s.cost)
        return time.perf_counter() - t0, s

    _, sol = chain(10, sol)  # settle into the warm-started regime
    n = 3 * k
    total, s2 = chain(n, sol)
    per_solve = total / n  # one sync for the whole chain
    assert bool(jnp.all(jnp.isfinite(s2.us))), "non-finite solver output"
    assert bool(jnp.all(s2.converged)), "chained solves must converge"
    return per_solve * 1e3, s2


def run_latency(T, BATCH):
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build_spec
    from agimus_controller_tpu.models.panda import load_panda
    from agimus_controller_tpu.solver.csqp import CSQPSettings
    from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp

    dtype = jnp.float32
    model, params = load_panda()
    spec, cf, refs, x0 = _build_spec(model, params, T, dtype)
    x0s = jnp.tile(x0[None], (BATCH, 1))
    xs0 = jnp.tile(x0[None, None], (BATCH, T + 1, 1))
    us0 = jnp.zeros((BATCH, T, 7), dtype)
    sqp = CSQPSettings(max_iters=10, reg_init=1e-7)
    solver = jax.jit(make_batch_sqp(model, params, spec, cf, sqp))
    p50_ms, _ = _chain_latency(solver, x0s, refs, xs0, us0)
    return _metric(f"panda_mpc_p50_latency_ms_T{T}_B{BATCH}_1chip", p50_ms,
                   "ms", 10.0 / p50_ms)


def run_runtime(T, BATCH):
    import jax
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

    dtype = jnp.float32
    model, params = load_panda()
    spec, cf, refs, x0 = _build_spec(model, params, T, dtype)
    layout = RowLayout(spec, model)
    buf = PackedTrajectoryBuffer(
        DTFactorsNSeq(factors=[1], n_steps=[T]), layout, dtype=dtype)
    q0 = np.asarray(PANDA_Q_READY)
    fid = model.frame_id("panda_hand_tcp")
    R0, p0 = (np.asarray(a) for a in kinematics.frame_placement(
        model, params, jnp.asarray(q0, dtype), fid))
    tau_g = np.asarray(dynamics.rnea(
        model, params, jnp.asarray(q0, dtype),
        jnp.zeros(7, dtype), jnp.zeros(7, dtype)))
    goal = p0 + np.asarray([0.05, -0.05, 0.08])

    def mk(i):
        pt = TrajectoryPoint(
            id=i, time_ns=int(i * 1e7), robot_configuration=q0,
            robot_velocity=np.zeros(7), robot_acceleration=np.zeros(7),
            robot_effort=tau_g,
            end_effector_poses={"panda_hand_tcp": (R0, goal)})
        w = TrajectoryPointWeights(
            w_robot_configuration=np.full(7, 0.1),
            w_robot_velocity=np.full(7, 1.0),
            w_robot_effort=np.ones(7),
            w_end_effector_poses={"panda_hand_tcp": np.ones(6)})
        return WeightedTrajectoryPoint(point=pt, weights=w)

    n_ticks = 120
    for i in range(3 * T + n_ticks + 40):
        buf.append(mk(i))
    # per-tick iteration budget (the reference's own mechanism — its
    # `max_solve_time` caps the CPU solver the same way, and its demo runs
    # max_iter=3, BASELINE.md); warm starts make the receding-horizon loop
    # converge across ticks (the physics assert below proves it)
    tick_iters = int(os.environ.get("BENCH_TICK_ITERS", "2"))
    runner = FusedTickRunner(
        model, params, spec, cf, buf.ring, refs,
        CSQPSettings(max_iters=10, reg_init=1e-7,
                     termination_tolerance=1e-4),
        dtype=dtype)
    x0h = np.asarray(x0)
    xs0 = np.tile(x0h[None], (T + 1, 1))
    us0 = np.tile(tau_g[None], (T, 1))
    runner.initialize(x0h, xs0, us0, limit=300)  # unlimited first solve
    _, _, kkt0, it0, conv0 = runner.fetch()
    print(f"first solve: iters={it0} kkt={kkt0:.2e} conv={conv0}",
          file=sys.stderr)

    rng = np.random.default_rng(0)
    n_total = n_ticks + 40
    drift = rng.normal(size=(n_total, 7)) * 0.002
    # pre-staged sensor sequence: the chain consumes device-resident slices
    x0_seq = jnp.asarray(np.concatenate(
        [q0[None] + drift, np.zeros((n_total, 7))], axis=1), dtype)

    # host-side per-tick work, timed separately: pack the streamed point
    # into its ring row (the entire per-tick host cost of the data path)
    wp = mk(10_000)
    t0 = time.perf_counter()
    n_pack = 200
    for _ in range(n_pack):
        layout.pack_point(wp)
    host_ms = (time.perf_counter() - t0) / n_pack * 1e3

    def run_chunk(k0, k):
        t0 = time.perf_counter()
        for i in range(k0, k0 + k):
            runner.step(x0_seq[i], limit=tick_iters)
        # one sync per chunk: the tick chain is device-serialized through
        # the xs/us/read-slot carry, so chunk/k is the per-tick device cost
        jax.block_until_ready(runner.last.u0)
        return (time.perf_counter() - t0) / k

    run_chunk(0, 20)  # settle into the warm-started regime
    per_tick = [run_chunk(20 + 20 * j, 20) for j in range(5)]
    dev_ms = float(np.median(per_tick)) * 1e3
    p50_ms = dev_ms + host_ms
    print(f"device tick p50 {dev_ms:.3f} ms ({tick_iters} SQP iters "
          f"budget) + host packing {host_ms:.3f} ms/tick", file=sys.stderr)
    # final verification tick with the full iteration budget: the
    # budget-capped chain must have kept the loop converged
    runner.step(x0_seq[0], limit=10)
    K0, u0, kkt, iters, conv = runner.fetch()
    assert np.all(np.isfinite(u0)) and np.all(np.isfinite(K0))
    assert conv, f"runtime tick did not converge (kkt={kkt:.2e})"
    # physics: the predicted terminal EE must be at the streamed goal
    xT = np.asarray(runner._xs[-1])
    _, pT = kinematics.frame_placement(
        model, params, jnp.asarray(xT[:7], dtype), fid)
    ee_err = float(np.linalg.norm(np.asarray(pT) - goal))
    print(f"terminal EE error {ee_err * 1e3:.1f} mm; kkt={kkt:.2e}",
          file=sys.stderr)
    assert ee_err < 0.02, f"EE never reached the goal ({ee_err:.3f} m)"
    return _metric(f"panda_mpc_runtime_tick_p50_ms_T{T}_1chip", p50_ms, "ms",
                   10.0 / p50_ms)


def run_csqp(T, BATCH):
    import jax
    import jax.numpy as jnp

    from agimus_controller_tpu.ocp.costs import build_cost_functions
    from agimus_controller_tpu.ocp.spec import (
        ConstraintItem,
        CostItem,
        ProblemSpec,
        default_references,
    )
    from agimus_controller_tpu.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu.ops import collision, kinematics
    from agimus_controller_tpu.solver.csqp import CSQPSettings
    from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp

    dtype = jnp.float32
    env_urdf = """<?xml version="1.0"?>
<robot name="env"><link name="obstacle_base"/>
<joint name="obstacle_joint" type="fixed">
<parent link="obstacle_base"/><child link="obstacle"/>
<origin xyz="0.5 0.0 0.5" rpy="0 0 0"/></joint>
<link name="obstacle"><collision name="obstacle_sphere">
<geometry><sphere radius="0.1"/></geometry></collision></link></robot>"""
    model, params = load_panda(
        env_urdf=env_urdf,
        collision_pairs=[("panda_link7_capsule", "obstacle_sphere")])
    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1,
                     update=True),
            CostItem(name="ctrl", kind="control_grav", weight=1e-3,
                     act_weights=(1.0,) * 7),
            CostItem(name="goal", kind="frame_placement", weight=10.0,
                     update=True, frame="panda_hand_tcp"),
        ),
        terminal_costs=(
            CostItem(name="goal", kind="frame_placement", weight=100.0,
                     update=True, frame="panda_hand_tcp"),
        ),
        constraints=(
            ConstraintItem(name="coll", kind="collision_distance",
                           pair_id=0, lower=(0.02,)),
        ),
        horizon=T, dt=0.01,
    )
    cf = build_cost_functions(model, params, spec, dtype=dtype)
    refs = default_references(spec, model, dtype=dtype)
    q0 = jnp.asarray(PANDA_Q_READY, dtype)
    x0 = jnp.concatenate([q0, jnp.zeros(7, dtype)])
    fid = model.frame_id("panda_hand_tcp")
    R0, p0 = kinematics.frame_placement(model, params, q0, fid)
    refs["xref"] = jnp.tile(x0[None], (T + 1, 1))
    refs["w_x"] = jnp.tile(jnp.concatenate(
        [jnp.full(7, 0.1), jnp.full(7, 1.0)]).astype(dtype)[None],
        (T + 1, 1))
    refs["ee_rot:panda_hand_tcp"] = jnp.tile(R0[None], (T + 1, 1, 1))
    refs["ee_trans:panda_hand_tcp"] = jnp.tile(
        jnp.asarray([0.45, 0.05, 0.55], dtype)[None], (T + 1, 1))
    # 1e-4 KKT: at the reference's 1e-3 default the termination
    # legitimately stops with ~1e-3 band violations; the physics assert
    # below wants the band held to 1e-3 over the chain
    sqp = CSQPSettings(max_iters=10, max_qp_iters=25, reg_init=1e-7,
                       termination_tolerance=1e-4)
    solver = jax.jit(make_batch_sqp(model, params, spec, cf, sqp))
    x0s = jnp.tile(x0[None], (BATCH, 1))
    xs0 = jnp.tile(x0[None, None], (BATCH, T + 1, 1))
    us0 = jnp.zeros((BATCH, T, 7), dtype)
    # converge hard once (the reference's unlimited first solve,
    # `ocp_base_croco.py:160-171`), then measure the warm-started MPC
    # regime through a dependency-serialized chain and one final sync
    cold = CSQPSettings(max_iters=100, max_qp_iters=100, reg_init=1e-7,
                        termination_tolerance=1e-4)
    first = jax.jit(make_batch_sqp(model, params, spec, cf, cold))
    sol = first(x0s, refs, xs0, us0)
    jax.block_until_ready(sol.cost)
    rng = np.random.default_rng(0)
    n = 20
    # per-tick sensor drift at 100 Hz scale (~0.005 rad between ticks);
    # each tick re-solves from the previous solution like the MPC loop
    x0_seq = jnp.asarray(np.asarray(x0s)[None] + np.concatenate(
        [rng.normal(size=(n, BATCH, 7)) * 0.005,
         np.zeros((n, BATCH, 7))], axis=2), dtype)
    # cross-solve ADMM dual warm start: the previous optimum rides the
    # active boundary; restarting duals from zero makes the QP re-discover
    # the active set every tick
    sol = solver(x0_seq[0], refs, sol.xs, sol.us, None, sol.y)
    jax.block_until_ready(sol.cost)  # warm cache for the measured executable
    t0 = time.perf_counter()
    for i in range(n):
        sol = solver(x0_seq[i], refs, sol.xs, sol.us, None, sol.y)
    jax.block_until_ready(sol.cost)
    t_total = time.perf_counter() - t0
    cn = float(np.max(np.asarray(sol.constraint_norm)))
    solves_per_s = BATCH * n / t_total
    assert bool(jnp.all(jnp.isfinite(sol.us)))
    # physics: the keep-away band must hold on the solution over the
    # CONTROLLABLE nodes t>=1 (node 0 is the measured initial state — when
    # the sensor puts the arm inside the band, no solver can repair the
    # past; the reference behaves identically)
    qs = np.asarray(sol.xs[:, 1:, :7]).reshape(-1, 7)
    dmin = float(np.min(np.asarray(jax.vmap(
        lambda qq: collision.pair_distance(model, params, qq, 0)
    )(jnp.asarray(qs, dtype)))))
    print(f"constraint_violation_max={cn:.2e} (incl. node 0); "
          f"min distance over t>=1: {dmin:.4f} m (band 0.02)",
          file=sys.stderr)
    # grace 1e-3: the constraint-envelope filter, the second-order
    # correction and the dual warm start hold the boundary-riding optimum
    # inside the band over a drifted chain
    assert dmin > 0.02 - 1e-3, (
        f"collision band violated on controllable nodes: {dmin:.4f}")
    return _metric(f"panda_csqp_collision_solves_per_s_T{T}_1chip",
                   solves_per_s, "solves/s", solves_per_s / 100.0)


def run_throughput(mode, T, BATCH):
    """batch (default) and vmap modes: solves/s of one batched solve."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build_problem, _build_spec
    from agimus_controller_tpu.models.panda import load_panda
    from agimus_controller_tpu.solver.fddp import SolverSettings, solve_fddp

    dtype = jnp.float32
    settings = SolverSettings(max_iters=10)
    if mode == "batch":
        model, params = load_panda()
        spec, cf, refs, x0 = _build_spec(model, params, T, dtype)
        x0s = jnp.tile(x0[None], (BATCH, 1))
        xs0 = jnp.tile(x0[None, None], (BATCH, T + 1, 1))
        us0 = jnp.zeros((BATCH, T, 7), dtype)
        which = os.environ.get("BENCH_SOLVER", "fddp")
        if which == "sqp":
            from agimus_controller_tpu.solver.csqp import CSQPSettings
            from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp

            solver = jax.jit(make_batch_sqp(
                model, params, spec, cf,
                CSQPSettings(max_iters=10, reg_init=1e-7)))
        else:
            from agimus_controller_tpu.solver.fddp_batch import make_batch_fddp

            solver = jax.jit(make_batch_fddp(model, params, spec, cf,
                                             settings))
        run = lambda xv: solver(xv, refs, xs0, us0)  # noqa: E731
    else:
        cf, x0s, refs, xs0, us0 = _build_problem(T, dtype, batch=BATCH)
        solver = jax.jit(
            jax.vmap(
                lambda x0, xs, us: solve_fddp(cf, x0, refs, xs, us, settings),
                in_axes=(0, 0, 0),
            )
        )
        run = lambda xv: solver(xv, xs0, us0)  # noqa: E731

    # Protocol: median of 5 perturbed-x0 repetitions, B=4096, T=100,
    # 10 iterations (BASELINE.md)
    sol = run(x0s)
    sol.cost.block_until_ready()

    # vary x0 per repetition: identical back-to-back dispatches can be
    # pipelined/coalesced by the runtime and under-measure device time
    rng = np.random.default_rng(0)
    x0_variants = [
        x0s + jnp.asarray(np.concatenate(
            [rng.normal(size=(BATCH, x0s.shape[1] // 2)) * 0.02,
             np.zeros((BATCH, x0s.shape[1] - x0s.shape[1] // 2))],
            axis=1), dtype)
        for _ in range(5)
    ]
    times = []
    for xv in x0_variants:
        t0 = time.perf_counter()
        sol = run(xv)
        jax.block_until_ready(sol.cost)
        times.append(time.perf_counter() - t0)
    t_batch = float(np.median(times))
    solves_per_s = BATCH / t_batch
    assert t_batch > 0.01, (
        f"implausible batch time {t_batch:.6f}s — device sync failed")
    assert bool(jnp.all(jnp.isfinite(sol.us))), "non-finite solver output"
    return _metric("panda_mpc_solves_per_s_T100_1chip", solves_per_s,
                   "solves/s", solves_per_s / 100.0)


MODES = {"latency": run_latency, "runtime": run_runtime, "csqp": run_csqp}


def main() -> int:
    import jax

    from agimus_controller_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    # multi-process launches (AGIMUS_COORDINATOR / SLURM) wire the JAX
    # distributed runtime here; single-device runs are a no-op
    from agimus_controller_tpu.parallel import initialize_distributed

    initialize_distributed()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          file=sys.stderr)

    T = int(os.environ.get("BENCH_T", "100"))
    mode = os.environ.get("BENCH_MODE", "batch")

    def batch_for(m):
        if m == mode and "BENCH_BATCH" in os.environ:
            return int(os.environ["BENCH_BATCH"])
        return DEFAULT_BATCH.get(m, 256)

    if mode in MODES:
        print(MODES[mode](T, batch_for(mode)), flush=True)
        return 0
    headline = run_throughput(mode, T, batch_for(mode))
    # headline FIRST (so a run cut short mid-extras still has a parseable
    # line on stdout) and again LAST (the last-line parse)
    print(headline, flush=True)
    failed = []
    if mode == "batch" and os.environ.get("BENCH_EXTRA", "1") != "0":
        # secondary runtime-workload metrics, run in this process: a second
        # JAX process could not get the card's memory
        for extra, fn in MODES.items():
            try:
                print(fn(T, batch_for(extra)), flush=True)
            except Exception:  # report every mode, then fail the run
                traceback.print_exc()
                print(f"extra[{extra}] failed", file=sys.stderr)
                failed.append(extra)
        print(headline)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
