"""Stage-solver diagnostics — the analogue of the reference's GMRES
iteration counters (min/max/avg reported per forward solve,
src/forward_evolution.jl:224-229).

Our stage solvers are fixed-iteration (static shapes; no host sync in the
hot loop), so the meaningful health metric is the *achieved relative
residual* of the implicit stage solve ``LHS(t_{n+1}) w_{n+1} = rhs``:

* ``"lu"`` — LU roundoff in the working dtype,
* ``"schulz"`` — the Newton–Schulz inverse contraction + refinement,
* ``"gmres"`` — fixed-budget Arnoldi truncation error; checked here
  against ``prob.gmres_abstol``/``gmres_reltol`` (which the fixed-iteration
  solver itself deliberately ignores).

``stage_residuals`` re-runs the solve at a sample of timesteps outside the
scan and measures residuals — a diagnostic pass, not a hot-loop tax.
"""

from __future__ import annotations

import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .controls import as_control_tuple, control_tables
from .forward import _time_grid, _hermite_step, _drift_stage_inverse, \
    eval_forward
from .problem import working_problem
from .ops.hermite import (
    assemble_generator_stack,
    scaled_derivatives,
    build_rhs,
    build_lhs,
)


def _probe_indices(nsteps: int, sample: int) -> np.ndarray:
    """Evenly spaced probe steps that divide ``nsteps`` so a thinned forward
    pass lands states exactly on them."""
    sample = max(1, min(sample, nsteps))
    every = max(nsteps // sample, 1)
    while nsteps % every:
        every -= 1
    return np.arange(0, nsteps, every)


@partial(jax.jit, static_argnames=("order", "sample"))
def _stage_residuals_jit(prob, controls, pcof, order: int, sample: int):
    controls = as_control_tuple(controls)
    m = order // 2
    dt, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    wprob = working_problem(prob)
    P, Q, dtw = P.astype(wd), Q.astype(wd), dt.astype(wd)

    # Probe each sampled step with the state the propagation actually
    # reaches there (one thinned forward pass) — NOT just w0: the relative
    # residual depends on the state's alignment with the poorly solved
    # directions, and late-time states under large controls are exactly
    # where warm-started Newton-Schulz degradation shows up (the round-2
    # divergence-guard bug class). If the solver is sick the probe states
    # themselves are polluted, which only makes the residuals louder.
    idx = _probe_indices(prob.nsteps, sample)
    every = int(idx[1] - idx[0]) if idx.size > 1 else prob.nsteps
    w_probe = eval_forward(prob, controls, pcof, order,
                           save_every=every)[:len(idx)].astype(wd)

    schulz_X0 = (_drift_stage_inverse(wprob, m, dtw)
                 if prob.solver == "schulz" else None)

    def one(k, i):
        w = w_probe[k]
        pq_n = (P[i], Q[i])
        pq_np1 = (P[i + 1], Q[i + 1])
        w_next, Ws = _hermite_step(wprob, m, dtw, w, pq_n, pq_np1,
                                   None, None, schulz_X0=schulz_X0)
        # residual of the implicit solve in f64
        A_np1 = assemble_generator_stack(wprob, pq_np1[0], pq_np1[1], m)
        eye = jnp.eye(prob.real_system_size, dtype=wd)
        D = scaled_derivatives(A_np1, eye, m)
        lhs = build_lhs(D, dtw, m).astype(jnp.float64)
        rhs = build_rhs(Ws, dtw, m).astype(jnp.float64)
        r = rhs - lhs @ w_next.astype(jnp.float64)
        return (jnp.linalg.norm(r) /
                jnp.maximum(jnp.linalg.norm(rhs), 1e-300))

    res = jnp.stack([one(k, int(i)) for k, i in enumerate(idx)])
    return res


def stage_residuals(prob, controls, pcof, order: int = 4, sample: int = 8):
    """Relative stage-solve residuals at ``sample`` evenly spaced timesteps.

    Returns ``{"max": float, "mean": float, "solver": str, "n_sampled": int}``.
    For ``solver="gmres"`` a warning is emitted if the achieved residual
    exceeds ``max(gmres_abstol, gmres_reltol)`` — the requested tolerances
    are otherwise advisory for the fixed-iteration solver.
    """
    res = np.asarray(_stage_residuals_jit(
        prob, controls, jnp.asarray(pcof, dtype=jnp.float64), order, sample))
    out = {"max": float(res.max()), "mean": float(res.mean()),
           "solver": prob.solver, "n_sampled": int(res.size)}
    if prob.solver == "gmres":
        tol = max(prob.gmres_abstol, prob.gmres_reltol)
        if out["max"] > tol:
            warnings.warn(
                f"qgd_tpu: fixed-budget GMRES stage residual {out['max']:.2e} "
                f"exceeds requested tolerance {tol:.2e} "
                f"(gmres_abstol/gmres_reltol); increase prob.gmres_iters.",
                stacklevel=2)
    return out
