"""Probe: f32-mode scenario-vmapped CNOT3 objective+gradient.

Tiny shapes first: nsteps=8, scenarios=2. Prints timing JSON on success.
"""
import dataclasses, json, sys, time

import jax, jax.numpy as jnp, numpy as np
import qgd_tpu
from qgd_tpu.adjoint import objective_and_gradient

NSTEPS = int(sys.argv[1]) if len(sys.argv) > 1 else 8
SCEN = int(sys.argv[2]) if len(sys.argv) > 2 else 2

prob = qgd_tpu.models.cnot3_problem(nsteps=NSTEPS)
prob = dataclasses.replace(prob, solver="schulz", dtype="float32",
                           hoist_batch_hint=SCEN)
controls = tuple(qgd_tpu.BSpline2Control(10, float(prob.tf)) for _ in range(3))
rng = np.random.default_rng(0)
pcofs = jnp.asarray(rng.standard_normal((SCEN, 60)) * 0.01)
rng2 = np.random.default_rng(1)
tgt = rng2.standard_normal((64, 8)) + 1j * rng2.standard_normal((64, 8))

def one(pc):
    (j1, guard, _), grad = objective_and_gradient(prob, controls, pc, tgt, 4)
    return j1 + guard, grad

fn = jax.jit(jax.vmap(one))
t0 = time.time()
out = fn(pcofs)
jax.block_until_ready(out)
compile_s = time.time() - t0

reps = 3
t0 = time.perf_counter()
for _ in range(reps):
    jax.block_until_ready(fn(pcofs))
elapsed = (time.perf_counter() - t0) / reps
print(json.dumps({
    "probe": "f32_vmap", "nsteps": NSTEPS, "scenarios": SCEN,
    "backend": jax.default_backend(), "compile_s": round(compile_s, 1),
    "steps_per_sec": round(2 * NSTEPS * SCEN / elapsed, 1),
    "obj": [float(x) for x in np.asarray(out[0])],
}), flush=True)
