"""Probe: segmented CNOT3 order-4 objective+gradient at long horizons.
Usage: probe_segmented.py NSTEPS [SEGMENTS] [f32]"""
import json, sys, time, dataclasses

import jax, jax.numpy as jnp, numpy as np
import qgd_tpu
from qgd_tpu.segmented import segmented_objective_and_gradient

NSTEPS = int(sys.argv[1])
SEGS = int(sys.argv[2]) if len(sys.argv) > 2 else 0
F32 = "f32" in sys.argv[3:]

prob = qgd_tpu.models.cnot3_problem(nsteps=NSTEPS)
if F32:
    prob = dataclasses.replace(prob, dtype="float32")
controls = tuple(qgd_tpu.BSpline2Control(10, float(prob.tf)) for _ in range(3))
rng = np.random.default_rng(0)
pcof = jnp.asarray(rng.standard_normal(60) * 0.01)
rng2 = np.random.default_rng(1)
tgt = rng2.standard_normal((64, 8)) + 1j * rng2.standard_normal((64, 8))

t0 = time.time()
(j1, g, r), grad = segmented_objective_and_gradient(
    prob, controls, pcof, tgt, 4, n_segments=SEGS)
jax.block_until_ready(grad)
compile_s = time.time() - t0
t0 = time.perf_counter()
(j1, g, r), grad = segmented_objective_and_gradient(
    prob, controls, pcof, tgt, 4, n_segments=SEGS)
jax.block_until_ready(grad)
run_s = time.perf_counter() - t0
print(json.dumps({
    "probe": "segmented", "nsteps": NSTEPS, "segments": SEGS, "f32": F32,
    "backend": jax.default_backend(), "compile_s": round(compile_s, 1),
    "run_s": round(run_s, 2),
    "steps_per_sec": round(2 * NSTEPS / run_s, 1),
    "j1": float(j1), "guard": float(g), "grad_norm": float(jnp.linalg.norm(grad)),
}), flush=True)
