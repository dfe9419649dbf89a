#!/usr/bin/env python
"""Long-horizon gradient probes (VERDICT r2 item 5).

(a) Time the f64 segmented gradient between nsteps=1e4 and 1e5.
(b) Demonstrate a >=5e5-step CNOT3 gradient (the reference's dt=1e-4
    order-2 operating point class, examples/cnot3_optimize_gate.sb:30-33)
    in f32 on the device / f64 on CPU.

One shape per invocation.

(c) ``--chunk-steps N``: route through the host-chunked driver
    (qgd_tpu/chunked.py) so every device execution covers at most N steps,
    which bounds device memory.

Usage: python tools/probes/probe_longhorizon.py NSTEPS [--f64] [--order N]
           [--chunk-steps N]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("nsteps", type=int)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--order", type=int, default=2)
    p.add_argument("--d1", type=int, default=10)
    p.add_argument("--chunk-steps", type=int, default=0,
                   help="max Hermite steps per device dispatch (0 = one "
                        "dispatch, the plain segmented path)")
    args = p.parse_args()

    import dataclasses

    import numpy as np
    import jax
    import jax.numpy as jnp
    import qgd_tpu
    from qgd_tpu.segmented import segmented_objective_and_gradient

    prob = qgd_tpu.models.cnot3_problem(tf=550.0, nsteps=args.nsteps)
    prob = dataclasses.replace(
        prob, solver="schulz",
        dtype="float64" if args.f64 else "float32")
    controls = tuple(
        qgd_tpu.CarrierControl(qgd_tpu.BSpline2Control(args.d1, 550.0), f)
        for f in qgd_tpu.models.cnot3_carrier_frequencies())
    tgt = qgd_tpu.models.cnot3_target()
    rng = np.random.default_rng(1)
    pcof = jnp.asarray(rng.uniform(-0.002, 0.002,
                                   sum(c.N_coeff for c in controls)))

    print(f"backend={jax.default_backend()} nsteps={args.nsteps} "
          f"dtype={prob.dtype} order={args.order} "
          f"chunk_steps={args.chunk_steps}", flush=True)
    t0 = time.time()
    if args.chunk_steps > 0:
        from qgd_tpu.chunked import chunked_objective_and_gradient

        def prog(phase, k, n, w):
            print(f"  {phase} chunk {k + 1}/{n}: {w:.1f} s", flush=True)

        (j1, guard, _), grad = chunked_objective_and_gradient(
            prob, controls, pcof, tgt, args.order,
            max_dispatch_steps=args.chunk_steps, progress=prog)
    else:
        (j1, guard, _), grad = segmented_objective_and_gradient(
            prob, controls, pcof, tgt, args.order)
    gnorm = float(jnp.linalg.norm(jnp.asarray(grad)))  # fetch = real sync
    wall = time.time() - t0
    rec = {"nsteps": args.nsteps, "dtype": prob.dtype, "order": args.order,
           "chunk_steps": args.chunk_steps,
           "wall_s": round(wall, 1), "j1": float(j1),
           "guard": float(guard), "gradnorm": gnorm,
           "steps_per_sec": round(3 * args.nsteps / wall, 1)}
    print("LONGHORIZON_RESULT " + json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
