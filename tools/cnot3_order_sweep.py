#!/usr/bin/env python
"""CNOT3 (order x stepsize) sweep — the reference's headline experiment
(examples/cnot3_optimize_gate.sb:28-41: order 2 at dt 1e-2/1e-4 vs orders
4-10 at coarse dt), measured as forward time-to-error plus one gradient
timing per config (VERDICT r3 missing #5 / next #6).

Runs CPU f64 — the same footing as the reference's own sweep (a
single-core CPU SLURM array) and as the runtime-ratio artifact
(tools/juqbox_ratio.py). Device timings for these program shapes are
not measured here.

Error = relative final-state deviation from an order-10 nsteps=4096 f64
truth (its own discretization error is ~1e-13-class, orders below every
sweep point). Memory stays bounded via eval_forward(save_every=K): the
nested scan hoists stage matrices per K-step segment only.

Writes results/cnot3_order_sweep.json.

Usage: JAX_PLATFORMS=cpu python -u tools/cnot3_order_sweep.py [--quick]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# (order, nsteps, gradient?) — dt = 550/nsteps; nsteps rounded to
# divisor-rich values within <1% of the reference's stepsizes. The
# reference's o2 dt=1e-4 point (5.5M steps) is NOT run here: a CPU f64
# forward costs ~2 h (measured 73.5 s at 55k -> ~7350 s at 5.5M); its
# row is synthesized from the o2 O(h^2) slope measured at 55k/220k
# (labeled extrapolated).
CONFIGS = [
    (2, 55_000, True),        # dt 1e-2 (reference o2 coarse)
    (2, 220_000, False),      # dt 2.5e-3 (o2 slope anchor)
    (4, 30_720, True),        # dt ~1.8e-2 (flagship nsteps)
    (4, 307_200, False),      # dt ~1.8e-3 (fwd-only: CPU f64 gradient
                              #   here is ~1 h; grad cost scales as the
                              #   55k row's measured grad/fwd ratio)
    (6, 982, True),           # dt ~5.6e-1
    (6, 5_500, True),         # dt 1e-1
    (8, 550, True),           # dt 1e0
    (8, 1_719, True),         # dt ~3.2e-1
    (10, 423, True),          # dt ~1.3
    (10, 982, True),          # dt ~5.6e-1
]


def build(nsteps):
    import dataclasses
    import jax.numpy as jnp
    import numpy as np
    import qgd_tpu

    prob = qgd_tpu.models.cnot3_problem(tf=550.0, nsteps=nsteps)
    prob = dataclasses.replace(prob, solver="schulz", dtype="float64")
    controls = tuple(
        qgd_tpu.CarrierControl(qgd_tpu.BSpline2Control(10, 550.0), f)
        for f in qgd_tpu.models.cnot3_carrier_frequencies())
    d = np.load(os.path.join(os.path.dirname(__file__), "..", "results",
                             "cnot3_r3_flagship.npz"))
    pcof = jnp.asarray(d["pcof"][-1], dtype=jnp.float64)
    return prob, controls, pcof


def _save_every(T):
    """Largest divisor of T <= 1100 — bounds the per-segment stage-matrix
    hoist of the thinned forward at ~400 MB f64."""
    if T <= 2000:
        return 1
    return max(d for d in range(1, 1101) if T % d == 0)


def forward_final(prob, controls, pcof, order):
    """(w_final ndarray, wall_seconds) — jit-warm timing (second call) for
    affordable sizes; single timed call (compile included, negligible at
    these horizons) past 100k steps."""
    import numpy as np
    import jax
    from qgd_tpu.forward import eval_forward

    k = _save_every(prob.nsteps)
    if prob.nsteps <= 100_000:
        hist = eval_forward(prob, controls, pcof, order, save_every=k)
        jax.block_until_ready(hist)      # warm: compile + run
    t0 = time.perf_counter()
    hist = eval_forward(prob, controls, pcof, order, save_every=k)
    w = np.asarray(hist[-1])
    return w, time.perf_counter() - t0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="skip the 5.5M-step config")
    ap.add_argument("-o", "--out", default="results/cnot3_order_sweep.json")
    args = ap.parse_args()

    import numpy as np
    import jax

    print(f"backend={jax.default_backend()}", flush=True)
    import qgd_tpu
    from qgd_tpu.segmented import segmented_objective_and_gradient

    tprob, controls, pcof = build(4096)
    truth, t_truth = forward_final(tprob, controls, pcof, 10)
    tnorm = float(np.linalg.norm(truth))
    print(f"truth (o10 n4096 f64): {t_truth:.1f} s norm={tnorm:.6f}",
          flush=True)
    tgt = qgd_tpu.models.cnot3_target()

    rows = []
    for order, nsteps, do_grad in CONFIGS:
        if args.quick and nsteps > 1_000_000:
            continue
        prob, controls, pcof = build(nsteps)
        w, wall = forward_final(prob, controls, pcof, order)
        err = float(np.linalg.norm(w - truth)) / tnorm
        row = {"order": order, "nsteps": nsteps,
               "dt": 550.0 / nsteps, "fwd_wall_s": round(wall, 3),
               "rel_err": err}
        if do_grad:
            # O(sqrt T)-memory segmented gradient, jit-warm timing
            segmented_objective_and_gradient(prob, controls, pcof, tgt,
                                             order)
            t0 = time.perf_counter()
            (j1, guard, _), grad = segmented_objective_and_gradient(
                prob, controls, pcof, tgt, order)
            gn = float(np.linalg.norm(np.asarray(grad)))
            row["grad_wall_s"] = round(time.perf_counter() - t0, 3)
            row["gradnorm"] = gn
            row["infidelity"] = float(j1)
        rows.append(row)
        print("SWEEP_ROW " + json.dumps(row), flush=True)

    # synthesized o2 dt=1e-4 row: error from the measured o2 O(h^2) slope,
    # walls from the round-3 on-chip f32 chunked record (measured).
    o2 = [r for r in rows if r["order"] == 2]
    extrap_row = None
    if len(o2) >= 2:
        import math

        p = (math.log(o2[0]["rel_err"] / o2[1]["rel_err"])
             / math.log(o2[1]["nsteps"] / o2[0]["nsteps"]))
        err_55e6 = o2[-1]["rel_err"] * (o2[-1]["nsteps"] / 5_500_000) ** p
        extrap_row = {
            "order": 2, "nsteps": 5_500_000, "dt": 1e-4,
            "rel_err_extrapolated": err_55e6,
            "slope_measured": round(p, 3),
            "source": "error from the o2 slope above, NOT measured",
        }
        print("SWEEP_ROW(extrap) " + json.dumps(extrap_row), flush=True)

    rec = {"truth": "order 10, nsteps=4096, f64 (schulz)",
           "pcof_source": "results/cnot3_r3_flagship.npz (optimized)",
           "machine": "CPU f64 (the reference's own sweep footing)",
           "rows": rows, "o2_dt1e-4_reference_point": extrap_row}
    with open(os.path.join(os.path.dirname(__file__), "..", args.out),
              "w") as f:
        json.dump(rec, f, indent=1)
    print("ORDER_SWEEP_DONE", flush=True)


if __name__ == "__main__":
    main()
