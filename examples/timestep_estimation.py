#!/usr/bin/env python
"""Timestep-resolution study (reference examples/timestep_estimation.jl):
sweep steps-per-shortest-period over 2^-3..2^6 at several method orders and
report the Richardson relative errors."""

import argparse

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--orders", type=int, nargs="+", default=[2, 4, 6, 8])
    p.add_argument("--max-amp", type=float, default=0.02)
    p.add_argument("--tf", type=float, default=100.0)
    args = p.parse_args()

    import qgd_tpu
    from qgd_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    prob = qgd_tpu.models.cnot2_problem(tf=args.tf, nsteps=10)
    amps = [args.max_amp] * prob.N_operators
    period = qgd_tpu.get_shortest_period(prob, amps)
    print(f"shortest period {period:.4f}; "
          f"tf/period = {args.tf / period:.1f}")
    for order in args.orders:
        errs = qgd_tpu.estimate_timesteps_per_period(
            prob, amps, order, verbose=False)
        res = [2.0 ** i for i in range(-3, 7)][1:len(errs) + 1]
        print(f"order {order}:")
        for r, e in zip(res, errs):
            print(f"  {r:7.3f} steps/period -> rel err {e:.3e}")


if __name__ == "__main__":
    main()
