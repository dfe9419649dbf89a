#!/usr/bin/env python
"""CNOT3 plateau-diagnosis probes (VERDICT.md round-2 item 1a).

Round-2's flagship stalled at infidelity 0.494. Round-3 diagnosis showed the
plateau is a *phase* problem: per-column overlaps with the target are
0.95-0.99 in magnitude but scattered in phase, and the gradient norm at the
plateau is 3.3 (nowhere near stationary — the run was killed by its own
5400 s cap, not by convergence). These probes characterize the landscape at
a cheap-but-faithful operating point (order 4, nsteps=1024 reproduces the
flagship objective to 2e-6) so the device budget is spent on a
configuration known to converge.

Usage: python tools/probes/cnot3_probe.py NAME [--d1 N] [--bound B]
           [--max-iter N] [--nsteps N] [--order N] [--start plateau|seedK]
           [--ridge R] [--tf T]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("name")
    p.add_argument("--d1", type=int, default=10)
    p.add_argument("--bound", type=float, default=0.02)
    p.add_argument("--max-iter", type=int, default=400)
    p.add_argument("--nsteps", type=int, default=1024)
    p.add_argument("--order", type=int, default=4)
    p.add_argument("--start", default="plateau")
    p.add_argument("--ridge", type=float, default=1e-2)
    p.add_argument("--tf", type=float, default=550.0)
    p.add_argument("--max-cpu-time", type=float, default=86400.0)
    p.add_argument("--carriers", default="default",
                   help="carrier set: 'default' ([0,-xqp,-xqr] per osc), "
                        "'extended' (adds the combined sideband "
                        "-(xqp+xqr)), or 'none'")
    p.add_argument("--guard-scale", type=float, default=1.0,
                   help="scale the guard-subspace projector (0 = no guard "
                        "penalty); probes whether a plateau is the "
                        "infidelity-guard tradeoff")
    p.add_argument("--lbfgs-history", type=int, default=40)
    p.add_argument("--rotate-target", action="store_true",
                   help="transform the CNOT target into the rotating frame "
                        "(rotation_matrix(tf) @ target) — the reference's "
                        "documented workflow (docs/src/examples.md:142-146) "
                        "that examples/cnot3_optimize_gate.py omitted")
    args = p.parse_args()

    import numpy as np
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import qgd_tpu

    import dataclasses

    prob = qgd_tpu.models.cnot3_problem(tf=args.tf, nsteps=args.nsteps)
    if args.guard_scale != 1.0:
        prob = dataclasses.replace(
            prob, guard_subspace_projector=(
                args.guard_scale * prob.guard_subspace_projector))
    freq_sets = qgd_tpu.models.cnot3_carrier_frequencies()
    if args.carriers == "extended":
        freq_sets = [list(f) + [f[1] + f[2]] for f in freq_sets]
    if args.carriers == "none":
        controls = tuple(qgd_tpu.BSpline2Control(args.d1, args.tf)
                         for _ in range(3))
    else:
        controls = tuple(
            qgd_tpu.CarrierControl(qgd_tpu.BSpline2Control(args.d1, args.tf),
                                   f)
            for f in freq_sets)
    n = sum(c.N_coeff for c in controls)

    if args.start == "plateau":
        d = np.load(os.path.join(os.path.dirname(__file__), "..", "..",
                                 "results", "cnot3_order4_f32.npz"))
        pcof0 = d["pcof"][-1]
        assert pcof0.size == n, (pcof0.size, n)
    elif args.start.startswith("file="):
        d = np.load(args.start[5:])
        pcof0 = d["pcof"][-1]
        assert pcof0.size == n, (pcof0.size, n)
    elif args.start.startswith("seed"):
        rng = np.random.default_rng(int(args.start[4:]))
        pcof0 = rng.uniform(-args.bound / 10, args.bound / 10, n)
    else:
        raise SystemExit(f"bad --start {args.start}")

    target = qgd_tpu.models.cnot3_target(tf=args.tf,
                                         rotating_frame=args.rotate_target)

    out = os.path.join(os.path.dirname(__file__), "..", "..", "results",
                       "diag", f"cnot3_{args.name}")
    t0 = time.time()
    hist = qgd_tpu.optimize_gate(
        prob, controls, jnp.asarray(pcof0), target, order=args.order,
        pcof_L=-args.bound, pcof_U=args.bound, maxIter=args.max_iter,
        max_cpu_time=args.max_cpu_time, lbfgs_history=args.lbfgs_history,
        ridge_penalty_strength=args.ridge, filename=out, print_level=5)
    wall = time.time() - t0
    inf = np.asarray(hist.infidelity)
    rec = {
        "name": args.name, "config": vars(args), "n_params": int(n),
        "iters": len(inf), "wall_s": round(wall, 1),
        "final_infidelity": float(inf[-1]),
        "min_infidelity": float(inf.min()),
        "final_gradnorm": float(np.linalg.norm(hist.grad_pcof[-1])),
    }
    print("PROBE_RESULT " + json.dumps(rec), flush=True)
    with open(out + ".summary.json", "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
