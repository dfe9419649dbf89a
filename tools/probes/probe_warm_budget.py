#!/usr/bin/env python
"""CPU probe: drift-only stage solves (schulz_warm_budget=0) vs per-step
Newton-Schulz inverses vs the exact LU path, at the BENCH configuration
(CNOT3, order 4, nsteps=1000, f32 propagation, bench-style small pcofs)
and at the flagship dt (nsteps=30720 scaled down horizon).

Measures: drift-preconditioner contraction ||I - X_drift M_n||, achieved
stage residuals, and objective/gradient agreement vs the f64 LU reference.

Usage: JAX_PLATFORMS=cpu python probe_warm_budget.py
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np
import jax
import jax.numpy as jnp

import qgd_tpu
from qgd_tpu.adjoint import objective_and_gradient
from qgd_tpu.diagnostics import stage_residuals
from qgd_tpu.forward import _drift_stage_inverse, _stage_matrices, _time_grid
from qgd_tpu.controls import control_tables
from qgd_tpu.problem import working_problem


def contraction(prob, controls, pcof, order):
    """max_n ||I - X_drift M_n||_F over the grid (the per-sweep error
    contraction of drift-preconditioned refinement)."""
    m = order // 2
    dt, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    wprob = working_problem(prob)
    P, Q, dtw = P.astype(wd), Q.astype(wd), dt.astype(wd)
    M = _stage_matrices(wprob, m, dtw, P[1:], Q[1:], -1.0)
    X = _drift_stage_inverse(wprob, m, dtw)
    eye = jnp.eye(M.shape[-1], dtype=M.dtype)
    R = eye[None] - jnp.einsum("ab,tbc->tac", X, M)
    fro = jnp.sqrt(jnp.sum(R ** 2, axis=(-2, -1)))
    return float(jnp.max(fro))


def run(tag, nsteps, amp, refine_env):
    os.environ["QGD_REFINE_SWEEPS_F32"] = str(refine_env)
    # reimport-time constant: spawn values through direct arg instead
    prob0 = qgd_tpu.models.cnot3_problem(nsteps=nsteps)
    controls = tuple(qgd_tpu.BSpline2Control(10, float(prob0.tf))
                     for _ in range(3))
    rng = np.random.default_rng(0)
    pcof = jnp.asarray(rng.standard_normal(60) * amp)
    rng2 = np.random.default_rng(1)
    tgt = rng2.standard_normal((64, 8)) + 1j * rng2.standard_normal((64, 8))

    # f64 LU ground truth
    (j1_ref, g_ref, _), grad_ref = objective_and_gradient(
        prob0, controls, pcof, tgt, 4)
    j_ref = float(j1_ref) + float(g_ref)
    grad_ref = np.asarray(grad_ref)

    for warm in (-1, 8, 2, 1, 0):
        prob = dataclasses.replace(prob0, solver="schulz", dtype="float32",
                                   schulz_iters=48, schulz_warm_budget=warm)
        q = contraction(prob, controls, pcof, 4)
        res = stage_residuals(prob, controls, np.asarray(pcof), 4)
        (j1, g, _), grad = objective_and_gradient(prob, controls, pcof, tgt, 4)
        j = float(j1) + float(g)
        gerr = float(np.linalg.norm(np.asarray(grad) - grad_ref)
                     / max(np.linalg.norm(grad_ref), 1e-30))
        print(f"[{tag}] warm={warm:3d} q={q:.3e} stage_res={res['max']:.3e} "
              f"obj_err={abs(j - j_ref):.3e} grad_relerr={gerr:.3e}",
              flush=True)
    jax.clear_caches()


if __name__ == "__main__":
    # bench config: nsteps=1000, tf=550 (dt=0.55), small random pcofs
    run("bench  dt=0.55 ", 1000, 0.01, 2)
    # flagship-like dt: nsteps=4000 on tf=550 -> dt=0.1375 (cheap stand-in)
    run("mid    dt=0.1375", 4000, 0.01, 2)
