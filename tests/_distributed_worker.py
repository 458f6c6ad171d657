"""Worker process for the 2-process `jax.distributed` test.

Launched (never collected) by tests/test_distributed.py::
test_two_process_sharded_solve — each OS process wires itself into the
cluster via the AGIMUS_* env path (`parallel/distributed.py`), builds the
global (batch, t) mesh, places its OWN scenarios with
`host_local_to_global`, runs the sharded batch SQP, and dumps its local
shard of the solution for the parent to compare against a single-process
solve.  Reference analog: the multi-node topic graph (`README.md:93-196`)
— the engine's multi-process story is SPMD over `jax.distributed` rather
than DDS fan-out.
"""

import os
import sys

# both workers run on virtual CPU devices, like tests/conftest.py
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=2").strip()
if "parallel_codegen" not in _flags:
    _flags = (_flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main(out_path: str) -> None:
    from agimus_controller_tpu.parallel import (
        host_local_to_global,
        initialize_distributed,
        make_global_mesh,
    )
    from agimus_controller_tpu.parallel.mesh import sharded_batch_sqp
    from agimus_controller_tpu.solver.csqp import CSQPSettings
    from tests._distributed_problem import build_tiny_problem

    # env path: AGIMUS_COORDINATOR / AGIMUS_NUM_PROCESSES / AGIMUS_PROCESS_ID
    assert initialize_distributed(), "multi-process launch not detected"
    nproc = jax.process_count()
    pid = jax.process_index()
    assert nproc == 2, nproc
    assert len(jax.devices()) == 4, len(jax.devices())

    mesh = make_global_mesh(t_shards=1)
    assert mesh.shape == {"batch": 4, "t": 1}
    # collapse the t=1 axis to the batch-only layout the solvers shard over
    from jax.sharding import Mesh

    mesh_b = Mesh(np.asarray(mesh.devices).reshape(-1), ("batch",))

    model, params, spec, cf, refs, x0_of = build_tiny_problem()
    T = spec.horizon
    local_b = 2
    x0s_local = np.stack(
        [x0_of(pid * local_b + i) for i in range(local_b)])
    xs_local = np.repeat(x0s_local[:, None], T + 1, axis=1)
    us_local = np.zeros((local_b, T, 7))

    x0s, xs0, us0 = host_local_to_global(
        mesh_b, (x0s_local, xs_local, us_local))
    assert x0s.shape[0] == 4

    st = CSQPSettings(max_iters=4, reg_init=1e-7)
    solver = sharded_batch_sqp(model, params, spec, cf, st, mesh_b)
    refs = {k: jnp.asarray(v) for k, v in refs.items()}
    sol = solver(x0s, refs, xs0, us0)
    jax.block_until_ready(sol.cost)

    # each process persists the scenarios IT owns, keyed by global index
    rows = {}
    for shard in sol.us.addressable_shards:
        start = shard.index[0].start or 0
        data = np.asarray(shard.data)
        for i in range(data.shape[0]):
            rows[start + i] = data[i]
    np.savez(out_path,
             idx=np.asarray(sorted(rows)),
             us=np.stack([rows[i] for i in sorted(rows)]))
    print(f"worker {pid}: wrote {sorted(rows)} -> {out_path}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main(sys.argv[1])
