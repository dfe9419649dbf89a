#!/usr/bin/env python
"""Multistart flagship for CNOT3: S random seeds optimized in lockstep on
one device (optimize_gate_multistart, the batched replacement of the
reference's SLURM array scale-out,
examples/cnot3_optimize_gate.sb:13,28-41). Tests whether the guarded
objective's infid~1.2e-2 equilibrium is the global basin or a seed
artifact, and converts batched throughput into an optimization record.

Ladder usage (the flagship protocol):
  stage 1:  python cnot3_multistart.py --name ms1 -S 24 --nsteps 3072
  stage 2:  python cnot3_multistart.py --name ms2 -S 4 --nsteps 30720 \
                --from-npz results/diag/cnot3_ms1.npz --top 4
(stage 2 re-optimizes the best stage-1 starts at the flagship resolution;
starts that reach stop_objective freeze.)
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

# Hoisted stage builds keep each vmapped L-BFGS dispatch short (the
# in-scan fallback is far slower). Keep S * nsteps small enough that
# 3*nsteps*(2N)^2*4B*S fits this cap: S=16 x 1024 -> 3.2 GB.
os.environ.setdefault("QGD_HOIST_CAP_BYTES", "9000000000")

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

import qgd_tpu

ap = argparse.ArgumentParser()
ap.add_argument("--name", default="multistart")
ap.add_argument("-S", type=int, default=16)
ap.add_argument("--nsteps", type=int, default=1024)
ap.add_argument("--max-iter", type=int, default=300)
ap.add_argument("--bound", type=float, default=0.02)
ap.add_argument("--from-npz", default=None,
                help="seed pcofs from a previous run's best starts")
ap.add_argument("--top", type=int, default=4)
ap.add_argument("--seed", type=int, default=100)
ap.add_argument("--perturb-from", default=None,
                help="seed all S starts as PERTURBATIONS of the last pcof "
                     "in this OptimizationHistory npz (basin scan around a "
                     "known optimum)")
ap.add_argument("--perturb-scale", type=float, default=2e-3)
args = ap.parse_args()

S, nsteps, max_iter = args.S, args.nsteps, args.max_iter

prob = qgd_tpu.models.cnot3_problem(tf=550.0, nsteps=nsteps)
prob = dataclasses.replace(prob, solver="schulz", dtype="float32",
                           hoist_batch_hint=S)
controls = tuple(qgd_tpu.CarrierControl(qgd_tpu.BSpline2Control(10, 550.0), f)
                 for f in qgd_tpu.models.cnot3_carrier_frequencies())
tgt = qgd_tpu.models.cnot3_target()
n = sum(c.N_coeff for c in controls)

if args.perturb_from:
    d = np.load(args.perturb_from)
    base = d["pcof"][-1]
    rng = np.random.default_rng(args.seed)
    pcofs0 = jnp.asarray(
        base[None, :] + rng.normal(0.0, args.perturb_scale, (S, base.size)))
    pcofs0 = jnp.clip(pcofs0, -args.bound, args.bound)
    print(f"seeded as {S} perturbations (sigma={args.perturb_scale}) of "
          f"{args.perturb_from}", flush=True)
elif args.from_npz:
    d = np.load(args.from_npz)
    order_idx = np.argsort(d["objs"][-1])[:args.top]
    pcofs0 = jnp.asarray(d["pcofs"][order_idx])
    S = pcofs0.shape[0]
    print(f"seeded from {args.from_npz} top-{S} "
          f"(objs {d['objs'][-1][order_idx]})", flush=True)
else:
    rng = np.random.default_rng(args.seed)
    pcofs0 = jnp.asarray(rng.uniform(-args.bound / 10, args.bound / 10,
                                     (S, n)))

print(f"backend={jax.default_backend()} S={S} nsteps={nsteps} "
      f"maxIter={max_iter}", flush=True)
t0 = time.time()
pcofs, objs = qgd_tpu.optimize_gate_multistart(
    prob, controls, pcofs0, tgt, order=4, pcof_L=-args.bound,
    pcof_U=args.bound, maxIter=max_iter, ridge_penalty_strength=1e-2,
    print_level=5)
wall = time.time() - t0

final = objs[-1]
best = int(np.argmin(final))
out = os.path.join(os.path.dirname(__file__), "..", "..", "results", "diag",
                   f"cnot3_{args.name}")
np.savez(out + ".npz", pcofs=np.asarray(pcofs), objs=objs,
         pcofs0=np.asarray(pcofs0))
rec = {"name": args.name, "S": int(S), "nsteps": nsteps,
       "maxIter": max_iter, "wall_s": round(wall, 1),
       "iters_run": int(objs.shape[0]),
       "best_obj": float(final[best]), "best_seed_idx": best,
       "obj_min": float(final.min()), "obj_median": float(np.median(final)),
       "obj_max": float(final.max()),
       "finals_sorted": sorted(round(float(v), 6) for v in final)}
print("MULTISTART_RESULT " + json.dumps(rec), flush=True)
with open(out + ".summary.json", "w") as f:
    json.dump(rec, f, indent=1)
