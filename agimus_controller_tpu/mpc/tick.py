"""Fused MPC tick: warm-start shift + ring gather + solve in ONE dispatch.

The device-resident form of the reference's 100 Hz `run_callback`
(`agimus_controller_ros/agimus_controller.py:474-523`): everything that
iterates per tick lives on device —

    host:    pack the (typically one) new reference row, ship it + x0
    device:  gather horizon rows from the ring  (refs update, O(1)/tick —
             the `problem.circularAppend` analog, `ocp_croco_generic.py:865`)
             shift the previous solution by one base dt   (warm start,
             `warm_start_shift_previous_solution.py:85-109` semantics)
             batch-SQP solve                              (the runtime solver)
    host:    read back (K[0], us[0], stats)               (the control msg)

so a tick is one upload, one XLA dispatch, one small download; the previous
solution never leaves the device. `ControllerRuntime`+`MPC`+`OCPJax(ring=...)`
expose the same math through the reference-shaped API (per-phase timers,
debug data); this fused path is the latency-optimal runner used by
`bench.py` BENCH_MODE=runtime and validated against the step-by-step path in
`tests/test_ring_control_loop.py`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..models.model import ModelParams, RobotModel
from ..ocp.costs import CostFunctions
from ..ocp.spec import ProblemSpec
from ..ops import integrator
from ..solver.csqp import CSQPSettings
from ..solver.precision import highest_precision
from ..solver.sqp_batch import make_batch_sqp
from .ring import RefRing, gather_horizon_rows


class TickOutput(NamedTuple):
    # device-resident carry (stays on device between ticks)
    xs: jnp.ndarray  # [T+1, nx]
    us: jnp.ndarray  # [T, nu]
    y: jnp.ndarray  # [T+1, nc] ADMM duals (next tick's warm start)
    next_slot: jnp.ndarray  # read slot after consuming the head (device)
    # the control message payload (small; fetched per tick)
    K0: jnp.ndarray  # [nu, nx]
    u0: jnp.ndarray  # [nu]
    kkt: jnp.ndarray
    iters: jnp.ndarray
    converged: jnp.ndarray


def make_fused_tick(
    model: RobotModel,
    params: ModelParams,
    spec: ProblemSpec,
    cf: CostFunctions,
    ring: RefRing,
    settings: CSQPSettings = CSQPSettings(),
):
    """Build `tick(ring_arr, read_slot, base_refs, x0, xs_prev, us_prev,
    limit) -> TickOutput`, jitted.

    The warm-start shift matches `WarmStartShiftPreviousSolution.shift`:
    uniform-dt nodes copy the successor (`xs[i]=xs[i+1]`, `us[i]=us[i+1]`),
    nodes inside a coarser segment advance by one BASE dt re-integration
    with the held control (reference `:85-109`).
    """
    ts = np.asarray(spec.timesteps())
    dt = float(ts[0])
    uniform = jnp.asarray(ts == dt)  # [T]
    hidx, cap_mask = ring.gather_spec()
    layout = ring.layout
    batch = make_batch_sqp(model, params, spec, cf, settings)

    all_uniform = bool(np.all(ts == dt))

    def shift(xs, us):
        if all_uniform:
            # pure roll — no dynamics evaluation needed
            return (jnp.concatenate([xs[1:], xs[-1:]], axis=0),
                    jnp.concatenate([us[1:], us[-1:]], axis=0))
        # candidate A: copy successor; candidate B: re-integrate at base dt
        xs_copy = xs[1:]
        xs_reint = jax.vmap(
            lambda x, u: integrator.euler_step(model, params, x, u, dt)
        )(xs[:-1], us)
        xs_sh = jnp.where(uniform[:, None], xs_copy, xs_reint)
        xs_sh = jnp.concatenate([xs_sh, xs[-1:]], axis=0)  # terminal repeats
        us_next = jnp.concatenate([us[1:], us[-1:]], axis=0)
        us_sh = jnp.where(uniform[:, None], us_next, us)
        # last uniform node has no successor control: hold it
        us_sh = us_sh.at[-1].set(us[-1])
        return xs_sh, us_sh

    def tick(ring_arr, read_slot, base_refs, x0, xs_prev, us_prev, limit,
             y_prev):
        rows = gather_horizon_rows(ring_arr, read_slot, hidx, cap_mask)
        refs = layout.unpack_refs(rows, base_refs)
        xs0, us0 = shift(xs_prev, us_prev)
        # ADMM dual warm start across ticks (constrained specs): the
        # previous optimum rides the active boundary, so zero-restarted
        # duals re-discover the active set every tick
        sol = batch(x0[None], refs, xs0[None], us0[None], limit,
                    y_prev[None])
        return TickOutput(
            xs=sol.xs[0], us=sol.us[0], y=sol.y[0],
            next_slot=(read_slot + 1) & cap_mask,
            K0=sol.K[0, 0], u0=sol.us[0, 0],
            kkt=sol.kkt[0], iters=sol.iters[0], converged=sol.converged[0],
        )

    return jax.jit(highest_precision(tick))


class FusedTickRunner:
    """Minimal driver for the fused tick: owns the device-resident previous
    solution, feeds the ring, publishes (K0, u0).

    `step()` returns the (K0, u0) arrays WITHOUT forcing a host sync —
    call `fetch()` (or np.asarray them) to materialize; chaining steps
    between fetches keeps the device pipeline full.
    """

    def __init__(self, model, params, spec, cf, ring: RefRing,
                 base_refs, settings: CSQPSettings = CSQPSettings(),
                 dtype=jnp.float32):
        self._tick = make_fused_tick(model, params, spec, cf, ring, settings)
        self._ring = ring
        self._refs = base_refs
        self._dtype = dtype
        self._nc = max(cf.n_constraints, 1)
        self._T = spec.horizon
        self._xs: Optional[jnp.ndarray] = None
        self._us: Optional[jnp.ndarray] = None
        self._y: Optional[jnp.ndarray] = None  # device ADMM dual carry
        self._slot: Optional[jnp.ndarray] = None  # device-carried read slot
        self._settings = settings
        self._limits = {}  # int -> cached device scalar (avoid re-uploads)
        self.last: Optional[TickOutput] = None

    def _limit_arr(self, limit: int):
        arr = self._limits.get(int(limit))
        if arr is None:
            arr = self._limits.setdefault(
                int(limit), jnp.asarray(int(limit), jnp.int32))
        return arr

    def initialize(self, x0, xs_init, us_init, limit: int = 1000):
        """First solve with the unlimited budget (reference
        `ocp_base_croco.py:160-171`) from a caller-provided warm start."""
        _, slot = self._ring.device_state()
        self._slot = jnp.asarray(slot, jnp.int32)
        out = self._run(x0, jnp.asarray(xs_init, self._dtype),
                        jnp.asarray(us_init, self._dtype), limit)
        return out

    def _run(self, x0, xs, us, limit):
        # ship any newly appended rows (no-op when pre-staged); the read
        # slot stays ON DEVICE across ticks so a steady-state tick uploads
        # nothing but x0 (and x0 may itself be a device array)
        if self._slot is None:
            self._slot = jnp.asarray(
                self._ring.device_state()[1], jnp.int32)
        ring_arr = self._ring.sync()
        if self._y is None:
            self._y = jnp.zeros((self._T + 1, self._nc), self._dtype)
        out = self._tick(
            ring_arr, self._slot, self._refs,
            jnp.asarray(x0, self._dtype), xs, us,
            self._limit_arr(limit), self._y)
        self._xs, self._us, self._y = out.xs, out.us, out.y
        self.last = out
        return out

    def step(self, x0, limit: Optional[int] = None) -> TickOutput:
        """One control tick: solve at the current ring head from the shifted
        previous solution, then consume the head (the `MPC.run` order:
        horizon -> solve -> `buffer.clear_past`)."""
        assert self._xs is not None, "call initialize() first"
        out = self._run(
            x0, self._xs, self._us,
            self._settings.max_iters if limit is None else limit)
        self._slot = out.next_slot  # device-side head advance
        self._ring.clear_past()  # host bookkeeping mirror
        return out

    def fetch(self, out: Optional[TickOutput] = None):
        """Materialize a tick's control message on host (one transfer)."""
        out = out or self.last
        K0, u0, kkt, iters, conv = jax.device_get(
            (out.K0, out.u0, out.kkt, out.iters, out.converged))
        return K0, u0, float(kkt), int(iters), bool(conv)
