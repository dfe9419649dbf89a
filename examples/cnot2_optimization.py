#!/usr/bin/env python
"""CNOT2 gate optimization — the reference's 2-transmon dispersive workflow
(examples/cnot2_optimization.jl:10-65): kerr 2pi*(0.2198, 0.2252),
cross-kerr 2pi*0.01, tf=100, order-4 Hermite, degree-2 B-splines with 10
coefficients, amplitude bound 0.5, 70 iterations."""

import argparse

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--max-iter", type=int, default=70)
    p.add_argument("--nsteps", type=int, default=2000)
    p.add_argument("--order", type=int, default=4)
    p.add_argument("--d1", type=int, default=10)
    p.add_argument("--amp-bound", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-cpu-time", type=float, default=86400.0)
    p.add_argument("--solver", default=None,
                   help="stage solver override (e.g. schulz)")
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args()

    import dataclasses

    import jax.numpy as jnp
    import qgd_tpu
    from qgd_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    prob = qgd_tpu.models.cnot2_problem(nsteps=args.nsteps)
    if args.solver:
        prob = dataclasses.replace(prob, solver=args.solver)
    tf = float(prob.tf)
    controls = [qgd_tpu.BSpline2Control(args.d1, tf) for _ in range(2)]
    n = sum(c.N_coeff for c in controls)
    rng = np.random.default_rng(args.seed)
    pcof0 = jnp.asarray(rng.uniform(-0.02, 0.02, n))

    # keep the complex target as host numpy (the library realifies it
    # host-side)
    target = qgd_tpu.create_gate(
        (2, 2), (2, 2), [((1, 0), (1, 1)), ((1, 1), (1, 0))])

    hist = qgd_tpu.optimize_gate(
        prob, controls, pcof0, target, order=args.order,
        pcof_L=-args.amp_bound, pcof_U=args.amp_bound,
        maxIter=args.max_iter, max_cpu_time=args.max_cpu_time,
        filename=args.output)
    print(hist.summary())


if __name__ == "__main__":
    main()
