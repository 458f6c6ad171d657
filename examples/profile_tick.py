"""Per-stage DEVICE-time profile of the B=1, T=100 SQP tick on the GPU.

Every measurement wraps its candidate in an ON-DEVICE `lax.fori_loop` of R
repetitions with a data dependency through the carry: one dispatch, one
sync, device time = total / R (kernel launches included, host dispatch
not).

Run on the GPU: python examples/profile_tick.py   (PROF_T, PROF_B, PROF_R)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from __graft_entry__ import _build_spec
from agimus_controller_tpu.compile_cache import enable_compile_cache
from agimus_controller_tpu.models.panda import load_panda
from agimus_controller_tpu.solver.csqp import CSQPSettings
from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp

T = int(os.environ.get("PROF_T", "100"))
B = int(os.environ.get("PROF_B", "1"))
R = int(os.environ.get("PROF_R", "50"))
dtype = jnp.float32


def timed_loop(name, make_loop):
    """make_loop() -> jitted zero-arg fn running R reps on device."""
    fn = make_loop()
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    total = time.perf_counter() - t0
    print(f"{name:44s} {total / R * 1e3:8.3f} ms/rep  ({total:.3f} s/{R})")


def main():
    enable_compile_cache()
    model, params = load_panda()
    spec, cf, refs, x0 = _build_spec(model, params, T, dtype)
    x0s = jnp.tile(x0[None], (B, 1))
    xs0 = jnp.tile(x0[None, None], (B, T + 1, 1))
    us0 = jnp.zeros((B, T, 7), dtype)

    # --- full solver, fixed iteration counts, chained on device -------
    for iters in (1, 2):
        st = CSQPSettings(max_iters=iters, termination_tolerance=0.0,
                          reg_init=1e-7)
        solver = make_batch_sqp(model, params, spec, cf, st)

        def make_loop(solver=solver):
            def body(i, carry):
                xs, us = carry
                sol = solver(x0s, refs, xs, us)
                return (sol.xs, sol.us)

            return jax.jit(
                lambda: jax.lax.fori_loop(0, R, body, (xs0, us0))[1])

        timed_loop(f"full sqp solve, {iters} iter (device)", make_loop)

    # --- stage derivatives: the XLA component route (T*B nodes) -------
    from agimus_controller_tpu.ops.batched_dynamics import (
        make_batched_step_with_derivs,
    )

    step_d = make_batched_step_with_derivs(model, params)
    x_flat = jnp.tile(x0[None], (T * B, 1))
    u_flat = jnp.zeros((T * B, 7), dtype)

    def make_loop():
        def body(i, x):
            xn, Fx, Fu = step_d(x, u_flat, 0.01)
            return x + 0.0 * xn + 0.0 * Fx[:, :, 0] + 0.0 * Fu[:, :, 0]

        return jax.jit(lambda: jax.lax.fori_loop(0, R, body, x_flat))

    timed_loop("dynamics + derivatives (T*B nodes)", make_loop)

    # --- the Riccati factor scan shape (B-minor lanes layout) ---------
    nx, nu = 14, 7
    rng = np.random.default_rng(0)
    Fx_t = jnp.asarray(rng.normal(0, 0.1, (T, nx, nx, B)), dtype)
    Fu_t = jnp.asarray(rng.normal(0, 0.1, (T, nx, nu, B)), dtype)
    lxx_t = jnp.asarray(
        np.tile(np.eye(nx)[None, :, :, None], (T, 1, 1, B)), dtype)

    from agimus_controller_tpu.solver.riccati_components import (
        _chol_lanes,
        _chol_solve_lanes,
        _mm,
        _mm_T1,
    )

    def factor_scan(Fx_t, Fu_t, lxx_t, seed):
        eye_u = jnp.eye(nu, dtype=dtype)[:, :, None]

        def body(Vxx, inp):
            lxxn, Fxn, Fun = inp
            M = _mm(Vxx, Fxn)
            N = _mm(Vxx, Fun)
            Qxx = lxxn + _mm_T1(Fxn, M)
            Qux = _mm_T1(Fun, M)
            Quu = _mm_T1(Fun, N) + 1e-2 * eye_u
            Lr = _chol_lanes(Quu, nu)
            KK = _chol_solve_lanes(Lr, Qux, nu)
            QK = _mm_T1(Qux, KK)
            Vxx2 = Qxx - 0.5 * (QK + jnp.swapaxes(QK, 0, 1))
            return Vxx2, KK[0][0]

        vT = lxx_t[0] + seed
        out, _ = jax.lax.scan(body, vT, (lxx_t, Fx_t, Fu_t), reverse=True)
        return out

    def make_loop():
        def body(i, acc):
            return factor_scan(Fx_t, Fu_t, lxx_t, 0.0 * acc[0, 0]) * 0.0 + acc

        return jax.jit(
            lambda: jax.lax.fori_loop(0, R, body, lxx_t[0] * 0.0))

    timed_loop(f"riccati factor scan T={T} (device)", make_loop)

    # --- line-search trial: one cost_and_gaps-shaped evaluation -------
    # (already covered by 'stage values' above; the full solver deltas
    # bound the remaining glue)


if __name__ == "__main__":
    main()
