"""Batch-native multiple-shooting SQP (the latency solver) vs validated paths.

`solve_csqp` is validated against scipy SLSQP (test_solver_csqp.py) and
`make_batch_csqp` against it per-row (test_csqp_batch.py); the node-parallel
SQP here must reach the same optima: same controls on the constrained goal
problem, constraints active and respected, gaps closed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agimus_controller_tpu.models.panda import PANDA_Q_READY, load_panda
from agimus_controller_tpu.ocp.costs import build_cost_functions
from agimus_controller_tpu.ocp.spec import (
    ConstraintItem,
    CostItem,
    ProblemSpec,
    default_references,
)
from agimus_controller_tpu.solver.csqp import CSQPSettings, solve_csqp
from agimus_controller_tpu.solver.sqp_batch import (
    make_batch_sqp,
    make_stage_derivs,
)
from tests.test_csqp_batch import constrained_goal_problem
from tests.test_robot_models import ENV_URDF

pytestmark = pytest.mark.slow  # heavy XLA solver compiles; see pyproject tiers


@pytest.fixture(scope="module")
def panda():
    return load_panda(dtype=np.float64)


@pytest.fixture(scope="module")
def panda_env():
    return load_panda(
        env_urdf=ENV_URDF,
        collision_pairs=[("panda_link7_capsule", "obstacle_sphere")],
        dtype=np.float64,
    )


def test_batch_sqp_constrained_matches_single(panda):
    model, params = panda
    T = 10
    u_lim = 12.0
    spec, cf, refs, x0, params_tight = constrained_goal_problem(
        model, params, T, u_lim)

    B = 3
    rng = np.random.default_rng(0)
    x0s = jnp.asarray(np.asarray(x0)[None] + 0.02 * np.concatenate(
        [rng.normal(size=(B, 7)), np.zeros((B, 7))], axis=1))
    xs0 = jnp.tile(x0s[:, None, :], (1, T + 1, 1))
    us0 = jnp.zeros((B, T, 7))

    # fixed rho: element-wise match against the fixed-rho single-scenario
    # solver (adaptive rho reaches the same optimum along a different
    # path). soc_iters=0 / constraint_envelope=False: the second-order
    # correction and envelope filter are batch-solver enhancements
    # solve_csqp doesn't implement — at 20 iterations both solvers are
    # still CONVERGING (kkt ~3e-4), so this test pins identical iteration
    # PATHS and must run the identical core algorithm; the enhancements'
    # behavior is pinned by the collision physics tests and the bench
    # band assert.
    settings = CSQPSettings(
        max_iters=20, max_qp_iters=200, eps_abs=1e-10,
        termination_tolerance=1e-8, rho=1e-1, adaptive_rho=False,
        soc_iters=0, constraint_envelope=False)
    solver = jax.jit(make_batch_sqp(model, params_tight, spec, cf, settings))
    sol_b = solver(x0s, refs, xs0, us0)

    assert float(jnp.max(jnp.abs(sol_b.us))) <= u_lim + 1e-5
    assert np.all(np.asarray(sol_b.gap_norm) < 1e-5)
    for i in range(B):
        sol_i = solve_csqp(cf, x0s[i], refs, xs0[i], us0[i], settings)
        np.testing.assert_allclose(
            np.asarray(sol_b.us[i]), np.asarray(sol_i.us), atol=5e-5,
            err_msg=f"scenario {i}")
        np.testing.assert_allclose(
            np.asarray(sol_b.cost[i]), np.asarray(sol_i.cost), rtol=1e-5)


def test_batch_sqp_unconstrained_goal(panda):
    """Unconstrained path (no ADMM): converges to the tracking optimum with
    closed gaps and the replicated scenarios stay bitwise identical."""
    model, params = panda
    from tests.test_solver_fddp import goal_reaching_problem
    from agimus_controller_tpu.ops import kinematics

    T = 12
    spec, cf, refs = goal_reaching_problem(model, params, T=T, dt=0.02)
    q0 = jnp.asarray(PANDA_Q_READY)
    x0 = jnp.concatenate([q0, jnp.zeros(7)])
    fid = model.frame_id("panda_hand_tcp")
    R0, p0 = kinematics.frame_placement(model, params, q0, fid)
    target = p0 + jnp.asarray([0.1, 0.05, -0.05])
    Tn = T + 1
    refs["xref"] = jnp.tile(x0[None], (Tn, 1))
    refs["ee_rot:panda_hand_tcp"] = jnp.tile(R0[None], (Tn, 1, 1))
    refs["ee_trans:panda_hand_tcp"] = jnp.tile(target[None], (Tn, 1))

    B = 2
    x0s = jnp.tile(x0[None], (B, 1))
    xs0 = jnp.tile(x0[None, None], (B, T + 1, 1))
    us0 = jnp.zeros((B, T, 7))
    settings = CSQPSettings(max_iters=40, termination_tolerance=1e-8)
    solver = jax.jit(make_batch_sqp(model, params, spec, cf, settings))
    sol = solver(x0s, refs, xs0, us0)

    assert bool(jnp.all(sol.converged)), f"kkt={np.asarray(sol.kkt)}"
    np.testing.assert_array_equal(np.asarray(sol.us[0]), np.asarray(sol.us[1]))
    assert np.all(np.asarray(sol.gap_norm) < 1e-7)

    # same optimum as the (SLSQP-validated) single-scenario solver. Both
    # converge to KKT < 1e-8 but take different iteration paths; agreement
    # is bounded by the BASELINE accuracy target (u-error < 1e-4), not by
    # float epsilon — measured 8.0e-5 max abs on |u| ~ 27 (rel ~ 1.2e-5).
    sol_ref = solve_csqp(cf, x0, refs, xs0[0], us0[0], settings)
    np.testing.assert_allclose(
        np.asarray(sol.us[0]), np.asarray(sol_ref.us), atol=1e-4)


def test_batch_sqp_collision_constraint(panda_env):
    """Collision-avoidance hard constraint active and respected along the
    solution (round-1 VERDICT item 2 acceptance: distance >= lower bound)."""
    model, params = panda_env
    T = 12
    from agimus_controller_tpu.ops import kinematics
    from agimus_controller_tpu.ops.collision import pair_distance

    q0 = jnp.asarray(PANDA_Q_READY)
    pair_id = 0  # (panda_link7_capsule, obstacle_sphere)
    d_start = float(pair_distance(model, params, q0, pair_id))
    lower = d_start * 0.75  # feasible at start; the goal drives through it

    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.05, update=True),
            CostItem(name="goal", kind="frame_placement", weight=50.0,
                     update=True, frame="panda_hand_tcp"),
        ),
        terminal_costs=(
            CostItem(name="goal", kind="frame_placement", weight=200.0,
                     update=True, frame="panda_hand_tcp"),
        ),
        constraints=(
            ConstraintItem(name="coll", kind="collision_distance",
                           pair_id=pair_id, lower=(lower,)),
        ),
        horizon=T,
        dt=0.02,
    )
    cf = build_cost_functions(model, params, spec, dtype=jnp.float64)
    refs = default_references(spec, model, dtype=jnp.float64)
    x0 = jnp.concatenate([q0, jnp.zeros(7)])
    fid = model.frame_id("panda_hand_tcp")
    R0, p0 = kinematics.frame_placement(model, params, q0, fid)
    refs["xref"] = jnp.tile(x0[None], (T + 1, 1))
    refs["ee_rot:panda_hand_tcp"] = jnp.tile(R0[None], (T + 1, 1, 1))
    refs["ee_trans:panda_hand_tcp"] = jnp.tile(
        jnp.asarray([0.5, 0.0, 0.5])[None], (T + 1, 1))  # the obstacle center

    B = 2
    x0s = jnp.tile(x0[None], (B, 1))
    xs0 = jnp.tile(x0[None, None], (B, T + 1, 1))
    us0 = jnp.zeros((B, T, 7))
    settings = CSQPSettings(max_iters=30, max_qp_iters=100,
                            termination_tolerance=1e-6)

    # without the constraint the optimum violates the keep-away band ...
    spec_free = ProblemSpec(
        running_costs=spec.running_costs,
        terminal_costs=spec.terminal_costs,
        horizon=T, dt=spec.dt)
    cf_free = build_cost_functions(model, params, spec_free, dtype=jnp.float64)
    free = jax.jit(make_batch_sqp(model, params, spec_free, cf_free, settings))
    sol_free = free(x0s, refs, xs0, us0)
    d_free = min(
        float(pair_distance(model, params, sol_free.xs[0, t, :7], pair_id))
        for t in range(T + 1))
    assert d_free < lower, f"fixture: unconstrained min dist {d_free}"

    # ... with it the constraint is active and respected
    solver = jax.jit(make_batch_sqp(model, params, spec, cf, settings))
    sol = solver(x0s, refs, xs0, us0)
    assert np.all(np.asarray(sol.gap_norm) < 1e-5)
    dists = [
        float(pair_distance(model, params, sol.xs[0, t, :7], pair_id))
        for t in range(T + 1)
    ]
    assert min(dists) >= lower - 2e-3, f"min distance {min(dists)}"
    assert min(dists) <= lower + 0.03, "constraint should be active"


def test_stage_derivs_match_pointwise_reference(panda):
    """The solver's derivative pass (`make_stage_derivs`, time-major blocks)
    equals the pointwise `cf.stage_derivs` / `cf.terminal_derivs` at every
    node, node (t, b) mapping to row t*B + b."""
    model, params = panda
    T, B = 4, 3
    spec, cf, refs, x0, _ = constrained_goal_problem(model, params, T, 12.0)
    rng = np.random.default_rng(1)
    xs = jnp.asarray(np.asarray(x0) + 0.1 * rng.normal(size=(T + 1, B, 14)))
    us = jnp.asarray(2.0 * rng.normal(size=(T, B, 7)))
    dyn, costs, term = jax.jit(make_stage_derivs(model, params, spec, cf))(
        xs, us, refs)
    t_idx = jnp.repeat(jnp.arange(T), B)
    want = jax.vmap(cf.stage_derivs, in_axes=(0, 0, 0, None))(
        xs[:-1].reshape(T * B, 14), us.reshape(T * B, 7), t_idx, refs)
    for got, ref in zip((*dyn, *costs),
                        (want.xnext, want.Fx, want.Fu, want.cost, want.lx,
                         want.lu, want.lxx, want.lxu, want.luu)):
        np.testing.assert_allclose(
            np.asarray(got).reshape(np.shape(ref)), np.asarray(ref),
            rtol=1e-7, atol=1e-8)
    want_T = jax.vmap(cf.terminal_derivs, in_axes=(0, None))(xs[-1], refs)
    for got, ref in zip(term, want_T):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-7, atol=1e-8)
