"""Standalone trajectory-publisher process.

The reference runs reference generation as a SEPARATE ROS node streaming
`MpcInput` messages to the controller over DDS
(`agimus_controller_ros/simple_trajectory_publisher.py:162-406`): it waits
for the robot description and the first sensor reading, builds the selected
trajectory generator, then publishes one weighted trajectory point per
timer tick with a monotonically increasing id.

Here the node graph is process-based: `TrajectoryPublisherProcess` runs the
generator in its own OS process and streams points over a
`multiprocessing.Queue` "topic" (named `/mpc_input` for parity). The
controller side drains the queue into its `TrajectoryBuffer` with
`pump_into`. Scalar weights are broadcast to vectors exactly like the
reference (`get_weights`, `simple_trajectory_publisher.py:351`).

Design note: reference generation is host-side control logic —
it stays out of the jitted solve path entirely; the only thing crossing
into the device world is the packed refs arrays built by the OCP layer.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
import queue as _queue
import time
from typing import Callable, Optional

import numpy as np

from ..mpc.buffer import WeightedTrajectoryPoint

MPC_INPUT_TOPIC = "/mpc_input"


@dataclasses.dataclass
class PublisherParams:
    """Mirror of the publisher node's parameters
    (`simple_trajectory_publisher.py:184-195`)."""

    ocp_dt: float = 0.01  # read from the controller's params in the reference
    rate_s: float = 0.01  # publish timer period (reference: 0.01 s)
    max_points: int = 10_000  # stop after this many points (safety)
    queue_depth: int = 1000  # reference QoS depth for /mpc_input


def _publisher_main(make_trajectory, model_args, q0, params: PublisherParams,
                    q_out: mp.Queue, stop_evt) -> None:
    """Child-process body: build models + generator, stream points."""
    # Reference generation is host-side control logic and must not take
    # the GPU held by the controller process (a second JAX process on the
    # card would reserve its memory) — pin the child to the CPU backend
    # before any jax computation runs.
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    # rebuild the model inside the child (process separation: the reference
    # node independently parses /robot_description, `:55-159`)
    from ..models.panda import load_panda  # default factory

    if model_args is None:
        model, mparams = load_panda(dtype=np.float64)
    else:
        factory, kwargs = model_args
        model, mparams = factory(**kwargs)
    traj = make_trajectory()
    traj.initialize(model, mparams, np.asarray(q0, float))
    t = 0.0
    next_id = 0
    period = params.rate_s
    deadline = time.monotonic()
    while not stop_evt.is_set() and next_id < params.max_points:
        pt = traj.get_traj_point_at_t(t)
        pt.point.id = next_id  # monotonically increasing (`:382-384`)
        try:
            q_out.put(pt, timeout=1.0)
        except _queue.Full:
            if stop_evt.is_set():
                break
            continue
        next_id += 1
        t += params.ocp_dt
        if getattr(traj, "trajectory_is_done", False):
            break
        deadline += period
        delay = deadline - time.monotonic()
        if delay > 0:
            time.sleep(delay)
    q_out.put(None)  # end-of-stream sentinel (trajectory-done future analog)


class TrajectoryPublisherProcess:
    """Run a trajectory generator in a standalone process and stream
    `WeightedTrajectoryPoint`s to the consumer.

    ``make_trajectory``: zero-arg callable returning a `TrajectoryBase`
    (constructed IN THE CHILD — generators hold jitted closures that must
    not cross a fork). ``model_args``: optional `(factory, kwargs)` pair to
    rebuild the robot model in the child; defaults to the Panda.
    """

    def __init__(
        self,
        make_trajectory: Callable,
        q0: np.ndarray,
        params: Optional[PublisherParams] = None,
        model_args=None,
    ):
        self.params = params or PublisherParams()
        ctx = mp.get_context("spawn")  # never fork a process holding a GPU
        self.topic = ctx.Queue(self.params.queue_depth)
        self._stop = ctx.Event()
        self._proc = ctx.Process(
            target=_publisher_main,
            args=(make_trajectory, model_args, np.asarray(q0, float),
                  self.params, self.topic, self._stop),
            daemon=True,
            name="trajectory_publisher",
        )
        self.done = False

    def start(self) -> "TrajectoryPublisherProcess":
        # The child must come up on the CPU backend and never take the GPU;
        # JAX reads JAX_PLATFORMS at interpreter start in the child, so
        # stage the inherited environment around the spawn.
        import os

        saved = {"JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS")}
        os.environ["JAX_PLATFORMS"] = "cpu"
        try:
            self._proc.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return self

    def pump_into(self, append: Callable[[WeightedTrajectoryPoint], None],
                  max_points: Optional[int] = None,
                  timeout_s: float = 0.0) -> int:
        """Drain available points into ``append`` (the controller's
        `append_reference`); returns the number of points transferred."""
        n = 0
        while max_points is None or n < max_points:
            try:
                pt = self.topic.get(timeout=timeout_s) if timeout_s else \
                    self.topic.get_nowait()
            except _queue.Empty:
                # a crashed child leaves the queue permanently empty: surface
                # it instead of letting consumers spin to their own deadline
                if (not self._proc.is_alive()
                        and (self._proc.exitcode or 0) != 0):
                    self.done = True
                    raise RuntimeError(
                        "trajectory publisher child exited with code "
                        f"{self._proc.exitcode} before end-of-stream")
                break
            if pt is None:
                self.done = True
                break
            append(pt)
            n += 1
        return n

    def stop(self, join_timeout_s: float = 5.0) -> None:
        self._stop.set()
        try:
            while True:
                self.topic.get_nowait()
        except _queue.Empty:
            pass
        self._proc.join(join_timeout_s)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(1.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
