#!/usr/bin/env python
"""Scenario-parallel CNOT3 sweep over a device mesh — the batched
replacement for the reference's SLURM job array
(examples/cnot3_optimize_gate.sb:13,28-47) and the random-pcof batch
template (examples/optimization_with_random_pcof.jl): a batch of random
control-vector starts optimized simultaneously, scenarios sharded over the
``scenario`` mesh axis and gate-basis columns over ``ic``.

Run on N virtual devices for a smoke test:
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/cnot3_scenario_sweep.py --scenarios 8 --steps 20
"""

import argparse

import numpy as np


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scenarios", type=int, default=8)
    p.add_argument("--steps", type=int, default=50,
                   help="gradient-descent steps")
    p.add_argument("--order", type=int, default=4)
    p.add_argument("--nsteps", type=int, default=550)
    p.add_argument("--tf", type=float, default=550.0)
    p.add_argument("--d1", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import qgd_tpu
    from qgd_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    from qgd_tpu.parallel import make_mesh, multichip_train_step

    prob = qgd_tpu.models.cnot3_problem(tf=args.tf, nsteps=args.nsteps)
    # carrier-wave controls (cross-Kerr sidebands) — without them the
    # conditional CNOT transition is unresolvable (see cnot3_optimize_gate)
    controls = tuple(
        qgd_tpu.CarrierControl(qgd_tpu.BSpline2Control(args.d1, args.tf),
                               freqs)
        for freqs in qgd_tpu.models.cnot3_carrier_frequencies())
    n = sum(c.N_coeff for c in controls)
    rng = np.random.default_rng(args.seed)
    pcofs = jnp.asarray(rng.uniform(-2e-3, 2e-3, (args.scenarios, n)))

    pairs = []
    for k in range(2):
        pairs.append(((1, 1, k), (1, 0, k)))
        pairs.append(((1, 0, k), (1, 1, k)))
    # host numpy: multichip_train_step realifies it host-side
    target = qgd_tpu.create_gate((4, 4, 4), (2, 2, 2), pairs)

    n_dev = len(jax.devices())
    n_ic = 8 if n_dev % 8 == 0 and n_dev >= 8 else (
        4 if n_dev % 4 == 0 else 1)
    n_sc = max(n_dev // n_ic, 1)
    mesh = make_mesh(n_sc, n_ic)
    print(f"devices={n_dev} mesh=(scenario={n_sc}, ic={n_ic}) "
          f"scenarios={args.scenarios} params={n}")

    step = multichip_train_step(prob, controls, target, mesh,
                                order=args.order, learning_rate=args.lr)
    for it in range(args.steps):
        pcofs, vals = step(pcofs)
        if it % 10 == 0 or it == args.steps - 1:
            v = np.asarray(vals)
            print(f"iter {it:4d}: best obj {v.min():.6e} "
                  f"median {np.median(v):.3e}")


if __name__ == "__main__":
    main()
