#!/usr/bin/env python
"""Forward-solve profiling on the (4,4,4) dispersive system — the
reference's profiling workload (examples/dispersive_profile.jl:1-44,
examples/regression.jl:20-55: tf=500, nsteps=2000, orders 4/8, spline
D1=10), instrumented with per-phase timing and optional JAX profiler
traces (the reference uses Profile+PProf)."""

import argparse
import time

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--tf", type=float, default=500.0)
    p.add_argument("--nsteps", type=int, default=2000)
    p.add_argument("--orders", type=int, nargs="+", default=[4, 8])
    p.add_argument("--d1", type=int, default=10)
    p.add_argument("--trace-dir", default=None,
                   help="write a JAX profiler trace here")
    p.add_argument("--with-gradient", action="store_true")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import qgd_tpu
    from qgd_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    from qgd_tpu.adjoint import discrete_adjoint

    prob = qgd_tpu.models.cnot3_problem(tf=args.tf, nsteps=args.nsteps)
    controls = tuple(qgd_tpu.BSpline2Control(args.d1, args.tf)
                     for _ in range(3))
    rng = np.random.default_rng(0)
    pcof = jnp.asarray(rng.standard_normal(6 * args.d1) * 0.01)
    # host numpy: the library realifies complex targets host-side
    tgt = (rng.standard_normal((64, 8))
           + 1j * rng.standard_normal((64, 8)))

    print(f"backend={jax.default_backend()} nsteps={args.nsteps} "
          f"tf={args.tf}")
    for order in args.orders:
        hist = qgd_tpu.eval_forward(prob, controls, pcof, order)
        jax.block_until_ready(hist)
        t0 = time.perf_counter()
        if args.trace_dir:
            with jax.profiler.trace(args.trace_dir):
                hist = qgd_tpu.eval_forward(prob, controls, pcof, order)
                jax.block_until_ready(hist)
        else:
            hist = qgd_tpu.eval_forward(prob, controls, pcof, order)
            jax.block_until_ready(hist)
        dt = time.perf_counter() - t0
        print(f"order {order}: forward {dt:.3f}s "
              f"({args.nsteps / dt:.0f} steps/s)")
        if args.with_gradient:
            g = discrete_adjoint(prob, controls, pcof, tgt, order)
            jax.block_until_ready(g)
            t0 = time.perf_counter()
            g = discrete_adjoint(prob, controls, pcof, tgt, order)
            jax.block_until_ready(g)
            dt = time.perf_counter() - t0
            print(f"order {order}: gradient {dt:.3f}s "
                  f"({2 * args.nsteps / dt:.0f} fwd+adj steps/s)")


if __name__ == "__main__":
    main()
