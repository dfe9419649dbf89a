#!/usr/bin/env python
"""Compare control parameterizations on forward-solve cost and convergence
(reference examples/control_comparison.jl and
compare_juqbox_vs_fortran.jl): run the Richardson harness for several
control families on the same problem and print runtime/error tables."""

import argparse

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--order", type=int, default=4)
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--base-nsteps", type=int, default=50)
    args = p.parse_args()

    import jax.numpy as jnp
    import qgd_tpu
    from qgd_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()

    prob = qgd_tpu.construct_rabi_prob(tf=2 * np.pi, nsteps=args.base_nsteps)
    tf = float(prob.tf)
    rng = np.random.default_rng(0)
    families = {
        "GRAPE(8)": qgd_tpu.GRAPEControl(8, tf),
        "BSpline2(10)": qgd_tpu.BSpline2Control(10, tf),
        "deBoor(deg6,12)": qgd_tpu.FortranBSplineControl(6, 12, tf),
        "Hermite(5,m2)": qgd_tpu.HermiteControl(5, tf, 2),
        "BSpline2xCarrier": qgd_tpu.CarrierControl(
            qgd_tpu.BSpline2Control(6, tf), [1.0, 2.0]),
    }
    for name, ctrl in families.items():
        pcof = jnp.asarray(rng.standard_normal(ctrl.N_coeff) * 0.3)
        res = qgd_tpu.get_histories(
            prob, [ctrl], pcof, args.iterations, orders=(args.order,),
            base_nsteps=args.base_nsteps, verbose=False)
        entry = res[f"Order {args.order}"]
        errs = ", ".join(f"{e:.2e}" for e in entry["rel_errs"])
        times = ", ".join(f"{t:.3f}" for t in entry["elapsed"])
        print(f"{name:18s} errs [{errs}]  times [{times}]s")


if __name__ == "__main__":
    main()
