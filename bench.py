"""Throughput of the batched CNOT3 gradient on one GPU: Hermite timesteps
per second, forward + adjoint.

Times the jitted objective + discrete-adjoint gradient of the CNOT3 system
((4,4,4) qudits, 128-dim real-stacked state, 8 gate-basis columns, order-4
Hermite, B-spline controls) for a batch of control-vector scenarios — the
multistart workload shape (the reference's SLURM-array scale-out). Counted
timesteps = nsteps x (1 forward + 1 adjoint sweep) x scenarios.

Configured program: f32 propagation with the f64 objective reduction,
Newton–Schulz stage solver with warm budget 0 (stages solved by refinement
sweeps preconditioned with the drift-only inverse, 3 sweeps), the segmented
gradient route, 256 scenarios. The f64 gradient-exactness gates are
enforced by the CPU test suite.

Usage: ``python bench.py`` — exits non-zero when JAX finds no GPU. Prints
one JSON line naming the device, its count and the card's power limit.
"""

import json
import os
import subprocess
import sys
import time

NSTEPS = 1000
ORDER = 4
SCENARIOS = 256
WARM_BUDGET = 0
REFINE_SWEEPS = 3
WORK_DTYPE = "float32"
REPS = 3


def card_line() -> str:
    """``name, power.limit`` of the card, from nvidia-smi in a child
    process."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main() -> int:
    # resolved when qgd_tpu is imported (ops/linalg.REFINE_SWEEPS_F32)
    os.environ.setdefault("QGD_REFINE_SWEEPS_F32", str(REFINE_SWEEPS))

    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX default device is {dev.platform})",
              file=sys.stderr)
        return 2

    import qgd_tpu
    from qgd_tpu.diagnostics import stage_residuals
    from qgd_tpu.ops.linalg import REFINE_SWEEPS_F32
    from qgd_tpu.segmented import segmented_objective_and_gradient
    from qgd_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    prob = dataclasses.replace(
        qgd_tpu.models.cnot3_problem(nsteps=NSTEPS), solver="schulz",
        dtype=WORK_DTYPE, schulz_warm_budget=WARM_BUDGET,
        hoist_batch_hint=SCENARIOS)
    controls = tuple(qgd_tpu.BSpline2Control(10, float(prob.tf))
                     for _ in range(3))
    rng = np.random.default_rng(0)
    pcofs = jnp.asarray(rng.standard_normal((SCENARIOS, 60)) * 0.01)
    target = qgd_tpu.models.cnot3_target(tf=float(prob.tf))

    def one(pc):
        (j1, guard, _), grad = segmented_objective_and_gradient(
            prob, controls, pc, target, ORDER)
        return j1 + guard, grad

    fn = jax.jit(jax.vmap(one))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(pcofs))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn(pcofs)
    jax.block_until_ready(out)
    elapsed = (time.perf_counter() - t0) / REPS
    objs = np.asarray(out[0])
    if not np.all(np.isfinite(objs)):
        print("bench: non-finite objective", file=sys.stderr)
        return 1

    rec = {
        "metric": "cnot3_hermite_steps_per_sec_fwd_adj",
        "value": 2 * NSTEPS * SCENARIOS / elapsed,
        "unit": "timesteps/sec",
        "seconds_per_batch": elapsed,
        "compile_and_first_call_s": compile_s,
        "scenarios": SCENARIOS,
        "route": "segmented",
        "schulz_warm_budget": prob.schulz_warm_budget,
        "refine_sweeps_f32": REFINE_SWEEPS_F32,
        "stage_residual_max": stage_residuals(
            prob, controls, np.asarray(pcofs[0]), ORDER)["max"],
        "peak_bytes_in_use": (dev.memory_stats() or {}).get(
            "peak_bytes_in_use"),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_line(),
    }
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
