"""Platform-facing setup: the solvers' matmul-precision pin, the compile-cache
location, and `chip_smoke.py` refusing to run without a GPU."""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jex_core

from agimus_controller_tpu import compile_cache
from agimus_controller_tpu.models.panda import PANDA_Q_READY, load_panda
from agimus_controller_tpu.ocp.costs import build_cost_functions
from agimus_controller_tpu.ocp.spec import (
    ConstraintItem,
    CostItem,
    ProblemSpec,
    default_references,
)
from tests.test_robot_models import ENV_URDF

REPO = Path(__file__).resolve().parent.parent
T = 3


@pytest.fixture(scope="module")
def problem():
    model, params = load_panda(
        env_urdf=ENV_URDF,
        collision_pairs=[("panda_link7_capsule", "obstacle_sphere")])
    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
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
    dtype = jnp.float32
    cf = build_cost_functions(model, params, spec, dtype=dtype)
    refs = default_references(spec, model, dtype=dtype)
    x0 = jnp.concatenate([jnp.asarray(PANDA_Q_READY, dtype),
                          jnp.zeros(7, dtype)])
    return model, params, spec, cf, refs, x0


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a closed jaxpr, nested ones too."""
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                for item in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(item, jex_core.ClosedJaxpr):
                        walk(item.jaxpr)
                    elif isinstance(item, jex_core.Jaxpr):
                        walk(item)

    walk(jaxpr.jaxpr)
    return out


def _entry(name, problem):
    """(fn, args) for one solver entry point at a tiny horizon."""
    from agimus_controller_tpu.solver.csqp import CSQPSettings, solve_csqp
    from agimus_controller_tpu.solver.fddp import SolverSettings, solve_fddp

    model, params, spec, cf, refs, x0 = problem
    B = 2
    x0s = jnp.tile(x0[None], (B, 1))
    xs0 = jnp.tile(x0[None, None], (B, T + 1, 1))
    us0 = jnp.zeros((B, T, 7), jnp.float32)
    st = CSQPSettings(max_iters=2, max_qp_iters=3)
    if name == "make_batch_sqp":
        from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp

        return make_batch_sqp(model, params, spec, cf, st), (
            x0s, refs, xs0, us0)
    if name == "make_batch_csqp":
        from agimus_controller_tpu.solver.csqp_batch import make_batch_csqp

        return make_batch_csqp(model, params, spec, cf, st), (
            x0s, refs, xs0, us0)
    if name == "make_batch_fddp":
        from agimus_controller_tpu.solver.fddp_batch import make_batch_fddp

        free = ProblemSpec(running_costs=spec.running_costs,
                           terminal_costs=spec.terminal_costs,
                           horizon=T, dt=spec.dt)
        cf_free = build_cost_functions(model, params, free)
        return make_batch_fddp(model, params, free, cf_free,
                               SolverSettings(max_iters=2)), (
            x0s, default_references(free, model), xs0, us0)
    if name == "solve_csqp":
        return (lambda *a: solve_csqp(cf, *a, st)), (
            x0, refs, xs0[0], us0[0])
    if name == "solve_fddp":
        free = ProblemSpec(running_costs=spec.running_costs,
                           terminal_costs=spec.terminal_costs,
                           horizon=T, dt=spec.dt)
        cf_free = build_cost_functions(model, params, free)
        return (lambda *a: solve_fddp(cf_free, *a,
                                      SolverSettings(max_iters=2))), (
            x0, default_references(free, model), xs0[0], us0[0])
    if name == "fused_tick":
        from agimus_controller_tpu.mpc.buffer import DTFactorsNSeq
        from agimus_controller_tpu.mpc.ring import (
            PackedTrajectoryBuffer,
            RowLayout,
        )
        from agimus_controller_tpu.mpc.tick import make_fused_tick

        buf = PackedTrajectoryBuffer(
            DTFactorsNSeq(factors=[1], n_steps=[T]), RowLayout(spec, model),
            dtype=jnp.float32)
        tick = make_fused_tick(model, params, spec, cf, buf.ring, st)
        ring_arr, slot = buf.ring.device_state()
        return tick, (ring_arr, jnp.asarray(slot, jnp.int32), refs, x0,
                      xs0[0], us0[0], jnp.asarray(2, jnp.int32),
                      jnp.zeros((T + 1, 1), jnp.float32))
    raise ValueError(name)


@pytest.mark.parametrize("name", [
    "make_batch_sqp", "make_batch_csqp", "make_batch_fddp", "solve_csqp",
    "solve_fddp", "fused_tick"])
def test_solver_entries_trace_at_highest_precision(problem, name):
    """On a GPU an unpinned f32 product may run in TF32; every solver entry
    traces its matrix products at HIGHEST precision, even when the caller
    asks for less."""
    fn, args = _entry(name, problem)
    with jax.default_matmul_precision("tensorfloat32"):
        jaxpr = jax.make_jaxpr(fn)(*args)
    precs = _dot_precisions(jaxpr)
    assert precs, f"{name}: no dot_general traced"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precs), (name, set(precs))


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_leaves_env_dir_to_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # nothing set in code: JAX reads the variable itself
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_repo_cache_dir_is_git_ignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_chip_smoke_refuses_a_host_without_gpu(argv, capsys):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(argv) != 0
    out, err = capsys.readouterr()
    assert "no GPU found" in err
    assert '"ok"' not in out


def test_factory_and_controller_do_not_import_yaml():
    """The controller path must run where PyYAML is not installed."""
    code = ("import sys\n"
            "import agimus_controller_tpu.factory\n"
            "import agimus_controller_tpu.runtime.config\n"
            "import agimus_controller_tpu.runtime\n"
            "import agimus_controller_tpu.mpc.mpc\n"
            "sys.exit(1 if 'yaml' in sys.modules else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.gpu
def test_batch_sqp_on_gpu_matches_cpu(gpu, problem):
    """The constrained batch SQP gives the same solution on the GPU as on
    the CPU (f32 on both; only reduction order differs)."""
    from agimus_controller_tpu.solver.csqp import CSQPSettings
    from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp

    model, params, spec, cf, refs, x0 = problem
    solve = jax.jit(make_batch_sqp(model, params, spec, cf,
                                   CSQPSettings(max_iters=10)))
    B = 2
    args = (jnp.tile(x0[None], (B, 1)), refs,
            jnp.tile(x0[None, None], (B, T + 1, 1)),
            jnp.zeros((B, T, 7), jnp.float32))
    sols = [solve(*jax.device_put(args, dev)) for dev in
            (jax.devices("gpu")[0], jax.devices("cpu")[0])]
    assert sols[0].us.devices() == {jax.devices("gpu")[0]}
    np.testing.assert_allclose(np.asarray(sols[0].us), np.asarray(sols[1].us),
                               atol=1e-4)
