"""Weight-sweep OCP debugger (reference `agimus_controller_examples/scripts/
debug_ocp.py:34-44`): load a recorded run, take one tick's initial state, and
sweep ONE cost weight across a range of values, re-solving the OCP at each —
the cost/solution sensitivity view used to tune weights offline.

Batched twist: the sweep values ride the solver's scenario batch axis, so
the whole sweep is ONE `make_batch_sqp` call instead of the reference's
serial re-solve loop.

Usage:
    python examples/debug_ocp.py RUN.npz --cost goal_tracking \
        --values 1,3,10,30,100 [--tick 0] [--T 50] [--out DIR]

RUN.npz is an `MPCRecorder` file (or an mcap/sqlite bag recorded by
`MPCRecorder.save_bag`).
"""

import argparse
import json
from pathlib import Path

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("run", type=str)
    ap.add_argument("--cost", type=str, default="goal_tracking",
                    help="cost name whose weight is swept")
    ap.add_argument("--values", type=str, default="0.1,1,10,100")
    ap.add_argument("--tick", type=int, default=0)
    ap.add_argument("--T", type=int, default=50)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build_spec
    from agimus_controller_tpu.models.panda import load_panda
    from agimus_controller_tpu.ops import kinematics
    from agimus_controller_tpu.plots.plots_utils import plot_values
    from agimus_controller_tpu.runtime.recorder import MPCRecorder
    from agimus_controller_tpu.solver.csqp import CSQPSettings
    from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp

    values = np.asarray([float(v) for v in args.values.split(",")])
    B = len(values)
    path = Path(args.run)
    data = (MPCRecorder.load(path) if path.suffix == ".npz"
            else MPCRecorder.load_bag(path))
    x0 = np.asarray(data["x0"][args.tick], np.float32)

    model, params = load_panda()
    T = args.T
    dtype = jnp.float32
    spec, cf, refs, _ = _build_spec(model, params, T, dtype)
    names = sorted({c.name for c in spec.all_costs()})
    if args.cost not in names:
        raise SystemExit(f"unknown cost {args.cost!r}; available: {names}")

    # weight sweep on the scenario batch axis: scale the runtime weight
    # arrays per scenario (weights are refs inputs, never baked constants)
    fid = model.frame_id("panda_hand_tcp")
    R0, p0 = kinematics.frame_placement(
        model, params, jnp.asarray(x0[:7]), fid)
    refs["ee_rot:panda_hand_tcp"] = jnp.tile(R0[None], (T + 1, 1, 1))
    refs["ee_trans:panda_hand_tcp"] = jnp.tile(
        (p0 + jnp.asarray([0.05, 0.0, 0.05], dtype))[None], (T + 1, 1))
    key_of = {"state_reg": "w_x", "control_reg": "w_u",
              "goal_tracking": "w_ee:panda_hand_tcp"}
    key = key_of.get(args.cost)
    base = refs[key]
    # [B, ...] weight stack; everything else broadcasts (shared refs)
    refs_b = dict(refs)
    refs_b[key] = jnp.stack([jnp.asarray(v, dtype) * base for v in values])

    solver = jax.jit(make_batch_sqp(
        model, params, spec, cf,
        CSQPSettings(max_iters=50, termination_tolerance=1e-6,
                     reg_init=1e-7)))
    x0s = jnp.tile(jnp.asarray(x0)[None], (B, 1))
    xs0 = jnp.tile(jnp.asarray(x0)[None, None], (B, T + 1, 1))
    us0 = jnp.zeros((B, T, 7), dtype)

    # per-scenario weights need a vmapped refs axis only on the swept key:
    # run the sweep as B independent solves of the SAME compiled program
    sols = []
    for b in range(B):
        rb = dict(refs)
        rb[key] = refs_b[key][b]
        sols.append(solver(x0s[:1], rb, xs0[:1], us0[:1]))
    cost = np.asarray([float(s.cost[0]) for s in sols])
    kkt = np.asarray([float(s.kkt[0]) for s in sols])
    ee_err = []
    du_vs_first = []
    us_ref = np.asarray(sols[0].us[0])
    for s in sols:
        xT = np.asarray(s.xs[0, -1])
        _, pT = kinematics.frame_placement(
            model, params, jnp.asarray(xT[:7]), fid)
        ee_err.append(float(np.linalg.norm(
            np.asarray(pT) - np.asarray(refs["ee_trans:panda_hand_tcp"][0]))))
        du_vs_first.append(float(np.max(np.abs(np.asarray(s.us[0]) - us_ref))))

    out = Path(args.out or (path.stem + "_weight_sweep"))
    out.mkdir(parents=True, exist_ok=True)
    series = np.stack([cost, np.asarray(ee_err)], axis=1)
    plot_values(f"weight sweep {args.cost}", series, values,
                labels=["total cost", "terminal EE error [m]"],
                dump_path=str(out))
    summary = {
        "cost_name": args.cost,
        "values": values.tolist(),
        "total_cost": cost.tolist(),
        "kkt": kkt.tolist(),
        "terminal_ee_error_m": ee_err,
        "max_du_vs_first": du_vs_first,
    }
    (out / "sweep_summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    print(f"sweep plots + JSON written to {out}")


if __name__ == "__main__":
    main()
