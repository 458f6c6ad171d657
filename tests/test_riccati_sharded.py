"""Cross-device horizon-sharded Riccati vs the in-device reference.

SURVEY.md §5 (long-context): the reference's mim_solvers runs the backward
Riccati recursion sequentially; this design shards the horizon over the
mesh with block composites reduced via device collectives. These tests run the
8-virtual-device CPU mesh (conftest) and require exact agreement with the
unsharded associative-scan implementation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from agimus_controller_tpu.parallel.mesh import make_mesh
from agimus_controller_tpu.solver.riccati_pscan import parallel_riccati
from agimus_controller_tpu.solver.riccati_sharded import (
    make_tsharded_riccati,
    solve_fddp_tsharded,
)


def _random_lqr(T, nx, nu, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    sym = lambda a: 0.5 * (a + np.swapaxes(a, -1, -2))
    lxx = sym(rng.normal(size=(T, nx, nx)) * 0.1)
    lxx += 2.0 * np.eye(nx)
    luu = sym(rng.normal(size=(T, nu, nu)) * 0.1)
    luu += 2.0 * np.eye(nu)
    lxu = rng.normal(size=(T, nx, nu)) * 0.05
    lx = rng.normal(size=(T, nx))
    lu = rng.normal(size=(T, nu))
    Fx = np.tile(np.eye(nx), (T, 1, 1)) + rng.normal(size=(T, nx, nx)) * 0.02
    Fu = rng.normal(size=(T, nx, nu)) * 0.1
    fs = rng.normal(size=(T + 1, nx)) * 0.01
    term_lx = rng.normal(size=(nx,))
    term_lxx = sym(rng.normal(size=(nx, nx)) * 0.1) + 3.0 * np.eye(nx)
    c = lambda a: jnp.asarray(a, dtype)
    return (c(lx), c(lu), c(lxx), c(lxu), c(luu), c(Fx), c(Fu), c(fs),
            c(term_lx), c(term_lxx))


def test_tsharded_riccati_matches_pscan():
    T, nx, nu = 64, 14, 7
    lx, lu, lxx, lxu, luu, Fx, Fu, fs, tlx, tlxx = _random_lqr(T, nx, nu)
    reg = 1e-6
    ks_r, Ks_r, Qus_r, Vx_r, Vxx_r, d1_r, d2_r = parallel_riccati(
        lx, lu, lxx, lxu, luu, Fx, Fu, fs, tlx, tlxx, reg)

    mesh = make_mesh(8, axis_name="t")
    riccati = jax.jit(make_tsharded_riccati(mesh, "t"))
    ks, Ks, Qus, Vx, Vxx, d1, d2 = riccati(
        lx, lu, lxx, lxu, luu, Fx, Fu, fs[1:], tlx, tlxx,
        jnp.asarray(reg, lx.dtype))

    np.testing.assert_allclose(np.asarray(ks), np.asarray(ks_r),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(Ks), np.asarray(Ks_r),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(Vx), np.asarray(Vx_r[:T]),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(np.asarray(Vxx), np.asarray(Vxx_r[:T]),
                               rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(float(d1), float(d1_r), rtol=1e-9)
    np.testing.assert_allclose(float(d2), float(d2_r), rtol=1e-9)


@pytest.mark.slow
def test_tsharded_fddp_matches_unsharded():
    # full solve with the horizon sharded across the mesh: same math, same
    # answer (the dryrun's third leg runs this shape at T=400)
    from __graft_entry__ import _build_problem
    from agimus_controller_tpu.solver.fddp import SolverSettings, solve_fddp

    # f64: the sequential backward and the block composition differ only in
    # rounding, but in f32 a one-ulp difference can flip a line-search
    # accept and the iterates branch; in f64 they stay together
    T = 64
    dtype = jnp.float64
    cf, x0, refs, xs0, us0 = _build_problem(T, dtype)
    settings = SolverSettings(max_iters=3, n_alphas=4)
    ref = jax.jit(lambda: solve_fddp(cf, x0, refs, xs0, us0, settings))()
    mesh = make_mesh(8, axis_name="t")
    sol = jax.jit(lambda: solve_fddp_tsharded(
        cf, x0, refs, xs0, us0, settings, mesh))()
    np.testing.assert_allclose(np.asarray(sol.us), np.asarray(ref.us),
                               rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(float(sol.cost), float(ref.cost), rtol=1e-4)
