"""Probe: scenario-vmapped PREFIX route at bench shape (round-5 follow-up).

The round-5 bench sweep settled on the segmented (serial-solve) route at
S=256 / warm 0 (103,043 steps/s).  The prefix-product route
(qgd_tpu/prefix.py) was built for single-run latency, but its FLOP
profile — batched 128x128 matmuls instead of serial matvec refinement —
is what dense matmul hardware prices well, so under a scenario batch it
may also win THROUGHPUT.  This probe measures the bench program
(CNOT3, nsteps=1000, order 4, f32, schulz warm 0) with
``prefix_objective_and_gradient`` vmapped over S scenarios.

Memory: live per-segment tensors are O(S_batch * L * (2N)^2) f32 — at
L=125, S_batch=32 that is ~0.5 GB per tensor (several live at once), so
sweep S_batch upward carefully; probe tiny first.

Usage:
    python tools/probes/probe_prefix_bench.py --scenarios 8 --nsteps 200 \
        --segments 4
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", type=int, default=8)
    ap.add_argument("--nsteps", type=int, default=200)
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import qgd_tpu
    from qgd_tpu.prefix import prefix_objective_and_gradient

    backend = jax.default_backend()
    prob = qgd_tpu.models.cnot3_problem(nsteps=args.nsteps)
    prob = dataclasses.replace(prob, solver="schulz", dtype="float32",
                               schulz_iters=48, schulz_warm_budget=0,
                               hoist_batch_hint=args.scenarios)
    controls = tuple(qgd_tpu.BSpline2Control(10, float(prob.tf))
                     for _ in range(3))
    rng = np.random.default_rng(0)
    pcofs = jnp.asarray(rng.standard_normal((args.scenarios, 60)) * 0.01)
    rng2 = np.random.default_rng(1)
    tgt = rng2.standard_normal((64, 8)) + 1j * rng2.standard_normal((64, 8))

    def one(pc):
        (j1, guard, _), grad = prefix_objective_and_gradient(
            prob, controls, pc, tgt, 4, n_segments=args.segments)
        return j1 + guard, grad

    fn = jax.jit(jax.vmap(one))

    t0 = time.perf_counter()
    out = fn(pcofs)
    first = float(jax.block_until_ready(out)[0][0])
    t_compile = time.perf_counter() - t0
    print(f"backend={backend} compile+first={t_compile:.1f}s "
          f"obj[0]={first:.6e}", flush=True)

    t0 = time.perf_counter()
    for _ in range(args.reps):
        out = fn(pcofs)
        _ = float(out[0][0])
    elapsed = (time.perf_counter() - t0) / args.reps
    steps_s = 2 * args.nsteps * args.scenarios / elapsed
    print(f"S={args.scenarios} nsteps={args.nsteps} segs={args.segments} "
          f"eval={elapsed:.3f}s steps/s={steps_s:,.0f}", flush=True)


if __name__ == "__main__":
    main()
