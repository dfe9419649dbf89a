#!/usr/bin/env python
"""CNOT3 gate-design CLI — the counterpart of the reference's
headline batch script (examples/cnot3_optimize_gate.jl:6-32 ArgParse CLI and
examples/cnot3_optimize_gate.sb SLURM array).

Usage:
    python examples/cnot3_optimize_gate.py ORDER STEPSIZE \
        [-m MAX_ITER] [--tf TF] [--d1 D1] [--amp-bound B] [-o OUT]

Where the reference sweeps (order, stepsize) pairs across SLURM array jobs,
here a single invocation optimizes one configuration; the scenario-batched
multi-chip sweep lives in examples/cnot3_scenario_sweep.py.
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("order", type=int, help="Hermite method order (2,4,6,...)")
    p.add_argument("stepsize", type=float, help="timestep size dt")
    p.add_argument("-m", "--max-iter", type=int, default=50)
    p.add_argument("--tf", type=float, default=550.0)
    p.add_argument("--d1", type=int, default=10,
                   help="B-spline coefficients per pulse quadrature")
    p.add_argument("--amp-bound", type=float, default=0.02,
                   help="box bound on control amplitudes (rad/ns)")
    p.add_argument("--ridge", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-cpu-time", type=float, default=86400.0)
    p.add_argument("--nsteps", type=int, default=None,
                   help="override the nsteps derived from stepsize (e.g. a "
                        "highly-divisible count for segmented gradients)")
    p.add_argument("--solver", default=None,
                   help="stage solver override (e.g. schulz)")
    p.add_argument("--no-carriers", action="store_true",
                   help="plain B-spline envelopes instead of the default "
                        "carrier-wave controls (carriers at the cross-Kerr "
                        "sidebands, the Juqbox cnot3 scheme — without them "
                        "the conditional CNOT transition is unresolvable "
                        "and the optimization stalls near infidelity 0.75)")
    p.add_argument("--dtype", default=None,
                   help="propagation dtype override (float32 fast mode)")
    p.add_argument("--gradient-route", default="auto",
                   help="evaluation route: auto (plain/segmented by "
                        "horizon) or prefix (log-depth associative-scan "
                        "propagation)")
    p.add_argument("--lab-frame-target", action="store_true",
                   help="skip the rotating-frame transform of the target "
                        "(the round-2 mistake, kept for comparison: the "
                        "frame's single-qudit Z phases are unreachable for "
                        "bounded resonant drives and the optimization "
                        "plateaus at infidelity ~0.47)")
    p.add_argument("-o", "--output", default=None,
                   help="history checkpoint basename (JSON+npz)")
    args = p.parse_args(argv)

    import dataclasses

    import jax.numpy as jnp
    import qgd_tpu
    from qgd_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    nsteps = args.nsteps or max(int(np.ceil(args.tf / args.stepsize)), 1)
    prob = qgd_tpu.models.cnot3_problem(tf=args.tf, nsteps=nsteps)
    overrides = {}
    if args.solver:
        overrides["solver"] = args.solver
    if args.dtype:
        overrides["dtype"] = args.dtype
    if overrides:
        prob = dataclasses.replace(prob, **overrides)
    if args.no_carriers:
        controls = [qgd_tpu.BSpline2Control(args.d1, args.tf)
                    for _ in range(3)]
    else:
        controls = [
            qgd_tpu.CarrierControl(qgd_tpu.BSpline2Control(args.d1, args.tf),
                                   freqs)
            for freqs in qgd_tpu.models.cnot3_carrier_frequencies()
        ]
    n = sum(c.N_coeff for c in controls)
    rng = np.random.default_rng(args.seed)
    pcof0 = jnp.asarray(rng.uniform(-args.amp_bound / 10,
                                    args.amp_bound / 10, n))

    # CNOT on the first two qudits, identity on the third, in the rotating
    # frame (docs/src/examples.md:142-146; see models.cnot3_target)
    target = qgd_tpu.models.cnot3_target(
        tf=args.tf, rotating_frame=not args.lab_frame_target)

    print(f"CNOT3: order={args.order} dt={args.stepsize} nsteps={nsteps} "
          f"n_params={n}")
    # target stays host numpy (the library realifies it host-side)
    hist = qgd_tpu.optimize_gate(
        prob, controls, pcof0, target, order=args.order,
        pcof_L=-args.amp_bound, pcof_U=args.amp_bound,
        maxIter=args.max_iter, max_cpu_time=args.max_cpu_time,
        ridge_penalty_strength=args.ridge,
        gradient_route=args.gradient_route,
        filename=args.output, print_level=5)
    print(hist.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
