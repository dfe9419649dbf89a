"""Forward and adjoint propagation of the implicit Hermite scheme.

Accelerator-shaped redesign of the reference's propagators
(src/forward_evolution.jl):

* The time loop is a ``lax.scan``; every step does a *batched* dense linear
  solve ``LHS(t_{n+1}) W_{n+1} = RHS-vector`` over all initial-condition
  columns (and any extra batch axes) at once. The reference instead runs
  per-initial-condition GMRES iterations inside Julia threads
  (src/forward_evolution.jl:33-70, 142-220); a dense LU is exact, has static
  shapes, runs as batched dense linear algebra, and removes the
  preconditioner machinery
  (src/preconditioners.jl) along with GMRES-iteration data dependence.
* Control derivative tables for the whole timestep grid are precomputed in
  one vectorized pass (they are pcof-dependent but state-independent), so
  the scan consumes tiny ``(nsteps+1, m, N_ops)`` tensors.
* Everything is pure and differentiable: ``jax.grad`` through this scan *is*
  the reference's discrete adjoint (see qgd_tpu/adjoint.py). Each step is
  wrapped in ``jax.checkpoint`` so reverse-mode stores only the state
  history, recomputing step internals — the recompute-vs-store trade the
  reference never had to make because it kept all histories in RAM
  (src/eval_grad_discrete_adjoint.jl:94-96).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .controls import control_tables, as_control_tuple
from .problem import working_problem
from .ops.hermite import (
    assemble_generator_stack,
    scaled_derivatives,
    build_rhs,
    build_lhs,
    taylor_expand,
)
from .ops.linalg import (
    stage_solve,
    stage_solve_transposed,
    factorize_stages,
    solve_factored,
    schulz_inverse_auto,
    inverse_stage_solve,
)

# Hoisting the per-step LHS matrices + factorizations out of the scan
# costs (2 + lu) * nsteps * (2N)^2 * itemsize bytes of device memory; cap
# it. Overridable via QGD_HOIST_CAP_BYTES.
import os as _os

_PRECOMPUTE_BYTES_LIMIT = int(
    _os.environ.get("QGD_HOIST_CAP_BYTES", 1_500_000_000))

# Device-memory budget for the materialized residuals of one batched
# per-time-point VJP pass (vjp_chunk_size).
_VJP_RESIDUAL_BYTES = 1 << 30
_VJP_CHUNK_MAX = 4096


def _use_precomputed_stages(prob) -> str | None:
    """Which state-independent work to hoist out of the scan:

    * ``"full"`` — stage matrices AND batched LU factorizations
      (``solver="lu"``).
    * ``"schulz"`` — stage matrices AND their Newton–Schulz approximate
      inverses (matmul-only).
    * ``None`` — build everything in the scan body (iterative solver, or
      memory cap exceeded).

    The memory estimate is multiplied by ``prob.hoist_batch_hint``: stage
    matrices are pcof-dependent, so under a scenario ``vmap`` the hoisted
    tensors carry the batch axis — callers batching S scenarios should set
    ``hoist_batch_hint=S`` so the precompute degrades to the in-scan solver
    instead of OOMing.
    """
    if prob.solver not in ("schulz", "lu"):
        return None
    n2 = prob.real_system_size
    itemsize = 4 if prob.dtype == "float32" else 8
    hint = max(int(prob.hoist_batch_hint), 1)
    need = 3 * prob.nsteps * n2 * n2 * itemsize * hint
    if need > _PRECOMPUTE_BYTES_LIMIT:
        import warnings
        warnings.warn(
            f"qgd_tpu: hoisted stage precompute disabled — it would need "
            f"~{need / 1e9:.1f} GB (> {_PRECOMPUTE_BYTES_LIMIT / 1e9:.1f} GB "
            f"cap) for nsteps={prob.nsteps}, 2N={n2}, "
            f"batch_hint={hint}; falling back to the (slower) in-scan "
            f"stage solver. Reduce nsteps/batch or raise the cap.",
            stacklevel=3)
        return None
    return "schulz" if prob.solver == "schulz" else "full"


def vjp_chunk_size(prob, m: int) -> int:
    """Time points per batched per-time-point VJP pass (the control-table
    cotangents of every gradient route).

    Each time point's VJP keeps its generator stack ``(m, 2N, 2N)`` and its
    derivative stack ``(m+1, 2N, B)`` as residuals, and a scenario ``vmap``
    multiplies them by ``prob.hoist_batch_hint``; the chunk is the largest
    count whose residuals fit ``_VJP_RESIDUAL_BYTES`` (at least 1, at most
    ``_VJP_CHUNK_MAX``). Callers vmap over all time points when they number
    at most this, and ``lax.map`` in chunks of it otherwise."""
    n2 = prob.real_system_size
    cols = max(prob.N_initial_conditions, 1)
    itemsize = 4 if prob.dtype == "float32" else 8
    per_point = (m * n2 * n2 + (m + 1) * n2 * cols) * itemsize
    per_point *= max(int(prob.hoist_batch_hint), 1)
    return int(min(max(_VJP_RESIDUAL_BYTES // per_point, 1), _VJP_CHUNK_MAX))


def _stage_matrices(prob, m, dt, P, Q, sign: float):
    """Batched dense one-step matrices ``sum_j (sign*dt)^j c_j D_j`` at the
    time points whose control tables are ``P, Q (T, m, N_ops)`` — the fully
    parallel, state-independent precompute (batched matmuls), hoisted out
    of the sequential scan."""
    eye = jnp.eye(prob.real_system_size, dtype=prob.system_sym.dtype)

    def build(p, q):
        A = assemble_generator_stack(prob, p, q, m)
        D = scaled_derivatives(A, eye, m)
        return build_rhs(D, sign * dt, m)

    return jax.vmap(build)(P, Q)


def _stage_matrices_both(prob, m, dt, P, Q):
    """Both one-step matrices ``(RHS, LHS)`` from a single identity
    recursion (the adjoint sweep needs both at every interior time point)."""
    eye = jnp.eye(prob.real_system_size, dtype=prob.system_sym.dtype)

    def build(p, q):
        A = assemble_generator_stack(prob, p, q, m)
        D = scaled_derivatives(A, eye, m)
        return build_rhs(D, dt, m), build_lhs(D, dt, m)

    return jax.vmap(build)(P, Q)


def _make_preconditioner(prob, dt, order: int):
    """Build the (apply, apply_T) preconditioner pair for the GMRES stage
    from ``prob.preconditioner_type`` (reference selects the preconditioner
    per problem type, src/SchrodingerProb.jl:63)."""
    if prob.solver != "gmres" or prob.preconditioner_type == "identity":
        return None
    from .ops.preconditioners import PRECONDITIONERS

    return PRECONDITIONERS[prob.preconditioner_type](prob, dt, order)


def _time_grid(prob):
    dt = prob.tf / prob.nsteps
    ts = jnp.arange(prob.nsteps + 1, dtype=jnp.float64) * dt
    return dt, ts


def _warm_budget(prob):
    """Explicit warm-start Schulz budget from the problem, or ``None`` to
    use the derived default (``schulz_warm_iters(prob.schulz_iters)``).
    ``0`` = no per-step inverse construction: stages are solved purely by
    drift-inverse-preconditioned refinement sweeps."""
    return prob.schulz_warm_budget if prob.schulz_warm_budget >= 0 else None


def _drift_stage_inverse(prob, m, dt, transpose: bool = False):
    """Newton–Schulz inverse of the *drift-only* implicit stage matrix —
    the warm start for per-step in-scan Schulz solves (control terms
    perturb the stage matrix by O(dt * amplitude), so the warm-started
    iteration converges in a handful of sweeps; same observation as the
    reference's LUPreconditioner, src/preconditioners.jl:44-55). Computed
    once, outside the scan, from the always-convergent universal init."""
    wd = prob.work_dtype
    zeros_pq = jnp.zeros((m, prob.N_operators), dtype=wd)
    A = assemble_generator_stack(prob, zeros_pq, zeros_pq, m)
    eye = jnp.eye(prob.real_system_size, dtype=wd)
    D = scaled_derivatives(A, eye, m)
    lhs = build_lhs(D, dt, m)
    if transpose:
        lhs = lhs.T
    return schulz_inverse_auto(lhs, prob.schulz_iters)


def _hermite_step(prob, m, dt, w, pq_n, pq_np1, forcing_n, forcing_np1,
                  precond=None, schulz_X0=None):
    """One Hermite-Obreshkov step ``w_n -> w_{n+1}``.

    ``pq_* = (P, Q)`` control tables ``(m, N_ops)`` at the two endpoints;
    ``forcing_*`` optional ``(m, 2N, B)`` scaled forcing derivatives.
    Returns ``(w_{n+1}, W_derivs_at_t_n)``.

    Stage solver (``prob.solver``):

    * ``"lu"`` (default): materialize the dense LHS by running the
      recursion on the identity; one batched direct solve.
    * ``"gmres"``: matrix-free fixed-iteration GMRES with the reference's
      Taylor-expansion initial guess (src/forward_evolution.jl:184) and
      optional preconditioner — for systems too large to materialize.
    """
    A_n = assemble_generator_stack(prob, pq_n[0], pq_n[1], m)
    A_np1 = assemble_generator_stack(prob, pq_np1[0], pq_np1[1], m)

    Ws = scaled_derivatives(A_n, w, m, forcing=forcing_n)
    rhs = build_rhs(Ws, dt, m)

    if forcing_np1 is not None:
        # Implicit-side forcing: derivatives at t_{n+1} are affine in w_{n+1},
        # w^{(j)} = D_j w + g_j with g from the zero-state forced recursion;
        # move the g-part to the RHS (reference src/forward_evolution.jl:195-206).
        G = scaled_derivatives(A_np1, jnp.zeros_like(w), m, forcing=forcing_np1)
        rhs = rhs - build_lhs(G, dt, m)

    if prob.solver == "gmres":
        from .ops.gmres import hermite_gmres_stage

        def apply_lhs(v):
            return build_lhs(scaled_derivatives(A_np1, v, m), dt, m)

        def apply_lhs_T(v):
            AT = jnp.swapaxes(A_np1, -1, -2)
            return build_lhs(scaled_derivatives(AT, v, m), dt, m)

        x0 = taylor_expand(Ws, dt, m)
        pc, pc_T = (None, None) if precond is None else precond
        w_next = hermite_gmres_stage(apply_lhs, apply_lhs_T, rhs, x0,
                                     iters=prob.gmres_iters, precond=pc,
                                     precond_T=pc_T)
    elif prob.solver == "schulz":
        eye = jnp.eye(prob.real_system_size, dtype=w.dtype)
        D = scaled_derivatives(A_np1, eye, m)
        lhs_mat = build_lhs(D, dt, m)
        # warm-started when the caller hoisted the drift-only stage inverse
        # out of the scan (a few sweeps instead of the full universal ramp)
        X = schulz_inverse_auto(lhs_mat, prob.schulz_iters, X0=schulz_X0,
                                warm_iters=_warm_budget(prob))
        w_next = inverse_stage_solve(lhs_mat, X, rhs)
    else:
        eye = jnp.eye(prob.real_system_size, dtype=w.dtype)
        D = scaled_derivatives(A_np1, eye, m)
        lhs_mat = build_lhs(D, dt, m)
        w_next = stage_solve(lhs_mat, rhs)
    return w_next, Ws


@partial(jax.jit, static_argnames=("order", "remat"))
def hermite_forward_history(prob, controls, pcof, order: int = 2,
                            forcing=None, remat: bool = True):
    """Propagate all initial conditions through ``prob.nsteps`` steps.

    Returns the state history ``(nsteps+1, 2N, B)`` (time-major; index 0 is
    the initial state). ``forcing``, if given, has shape
    ``(nsteps+1, m, 2N, B)`` holding scaled forcing derivatives
    ``f^{(j)}(t_n)/j!`` on the time grid.
    """
    controls = as_control_tuple(controls)
    m = order // 2
    dt, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    prob = working_problem(prob)
    P, Q, dt = P.astype(wd), Q.astype(wd), dt.astype(wd)
    if forcing is not None:
        forcing = forcing.astype(wd)
    w0 = prob.w0

    precompute = _use_precomputed_stages(prob) if forcing is None else None
    if precompute:
        # Fast path: LHS matrices (and their LU factorizations or
        # approximate inverses) built batched outside the scan; the
        # sequential body is only the state-dependent derivative recursion
        # plus the solve.
        lhs_mats = _stage_matrices(prob, m, dt, P[1:], Q[1:], -1.0)

        if precompute == "full":
            lu, piv = factorize_stages(lhs_mats)

            def step_fast(w, xs):
                pq_n, M, lu_n, piv_n = xs
                A_n = assemble_generator_stack(prob, pq_n[0], pq_n[1], m)
                Ws = scaled_derivatives(A_n, w, m)
                rhs = build_rhs(Ws, dt, m)
                w_next = solve_factored(M, lu_n, piv_n, rhs)
                return w_next, w_next

            xs = ((P[:-1], Q[:-1]), lhs_mats, lu, piv)
        else:
            # Warm-start the whole batch of stage inverses from the ONE
            # drift-only inverse (controls perturb each stage matrix by
            # O(dt*amp)) — same scheme the in-scan path uses; ~3.5x fewer
            # Newton-Schulz matmuls than the universal-init ramp, and these
            # dominate the hot path's FLOPs.
            Xs = schulz_inverse_auto(lhs_mats, prob.schulz_iters,
                                     X0=_drift_stage_inverse(prob, m, dt),
                                     warm_iters=_warm_budget(prob))

            def step_fast(w, xs):
                pq_n, M, X = xs
                A_n = assemble_generator_stack(prob, pq_n[0], pq_n[1], m)
                Ws = scaled_derivatives(A_n, w, m)
                rhs = build_rhs(Ws, dt, m)
                w_next = inverse_stage_solve(M, X, rhs)
                return w_next, w_next

            xs = ((P[:-1], Q[:-1]), lhs_mats, Xs)

        if remat:
            step_fast = jax.checkpoint(step_fast)
        _, traj = jax.lax.scan(step_fast, w0, xs)
        return jnp.concatenate([w0[None], traj], axis=0)

    precond = _make_preconditioner(prob, dt, order)
    schulz_X0 = (_drift_stage_inverse(prob, m, dt)
                 if prob.solver == "schulz" else None)

    def step(w, xs):
        if forcing is None:
            pq_n, pq_np1 = xs
            f_n = f_np1 = None
        else:
            pq_n, pq_np1, f_n, f_np1 = xs
        w_next, _ = _hermite_step(prob, m, dt, w, pq_n, pq_np1, f_n, f_np1,
                                  precond=precond, schulz_X0=schulz_X0)
        return w_next, w_next

    if remat:
        step = jax.checkpoint(step)

    xs = ((P[:-1], Q[:-1]), (P[1:], Q[1:]))
    if forcing is not None:
        xs = xs + (forcing[:-1], forcing[1:])
    _, traj = jax.lax.scan(step, w0, xs)
    return jnp.concatenate([w0[None], traj], axis=0)


def _derivatives_on_grid(prob, controls, pcof, ts, states, order: int,
                         forcing=None):
    """Scaled-derivative stacks ``(T, m+1, 2N, B)`` at given times/states —
    used to emit reference-parity histories with derivative columns
    (reference stores them per saved step, src/forward_evolution.jl:163-179)."""
    m = order // 2
    P, Q = control_tables(controls, pcof, ts, m)

    def one(p, q, w, f):
        A = assemble_generator_stack(prob, p, q, m)
        return scaled_derivatives(A, w, m, forcing=f)

    if forcing is None:
        return jax.vmap(lambda p, q, w: one(p, q, w, None))(P, Q, states)
    return jax.vmap(one)(P, Q, states, forcing)


def _thinned_forward_history(prob, controls, pcof, order: int,
                             save_every: int):
    """State history at every ``save_every``-th step WITHOUT materializing
    the full ``(nsteps+1, 2N, B)`` trajectory: a nested scan whose outer
    level emits one state per saved point and whose inner level advances
    ``save_every`` steps, keeping only O(save_every) states live — the
    memory behavior of the reference's ``saveEveryNsteps``
    (src/forward_evolution.jl:22,177-179), which stores saved steps only.
    """
    from .segmented import _forward_segment_scan, _segment_mode

    controls = as_control_tuple(controls)
    m = order // 2
    dt, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    prob = working_problem(prob)
    P, Q, dt = P.astype(wd), Q.astype(wd), dt.astype(wd)
    mode = _segment_mode(prob)
    precond = _make_preconditioner(prob, dt, order)
    schulz_X0 = (_drift_stage_inverse(prob, m, dt)
                 if mode == "schulz" else None)
    S = prob.nsteps // save_every
    L = save_every

    def seg(arr):
        return (arr[:-1].reshape(S, L, *arr.shape[1:]),
                arr[1:].reshape(S, L, *arr.shape[1:]))

    Pl, Pr = seg(P)
    Ql, Qr = seg(Q)

    def outer(w, xs):
        pl_, ql_, pr_, qr_ = xs
        hist = _forward_segment_scan(prob, m, dt, pl_, ql_, pr_, qr_, w, mode,
                                     precond=precond, schulz_X0=schulz_X0)
        return hist[-1], hist[-1]

    w0 = prob.w0
    _, saved = jax.lax.scan(outer, w0, (Pl, Ql, Pr, Qr))
    return jnp.concatenate([w0[None], saved], axis=0)


@partial(jax.jit, static_argnames=("order", "save_every", "return_derivatives"))
def eval_forward(prob, controls, pcof, order: int = 2, *, save_every: int = 1,
                 forcing=None, return_derivatives: bool = False):
    """Forward evolution (reference ``eval_forward``,
    src/forward_evolution.jl:15-70).

    Returns the real-stacked state history:

    * ``return_derivatives=False`` (default): ``(n_saved, 2N, B)``
    * ``return_derivatives=True``: ``(n_saved, m+1, 2N, B)`` including the
      scaled-derivative columns the reference stores
      (``uv_matrix`` layout, transposed to time-major).

    ``save_every`` mirrors ``saveEveryNsteps`` (src/forward_evolution.jl:22);
    ``nsteps`` must be divisible by it. ``save_every > 1`` also THINS
    memory (the full trajectory is never materialized), matching the
    reference's storage behavior (src/forward_evolution.jl:177-179).
    """
    controls = as_control_tuple(controls)
    if prob.nsteps % save_every != 0:
        raise ValueError("nsteps must be divisible by save_every")
    if save_every > 1 and forcing is None:
        saved = _thinned_forward_history(prob, controls, pcof, order,
                                         save_every)
    else:
        hist = hermite_forward_history(prob, controls, pcof, order,
                                       forcing=forcing)
        saved = hist[::save_every]
    if not return_derivatives:
        return saved
    dt, ts = _time_grid(prob)
    ts_saved = ts[::save_every]
    f_saved = None if forcing is None else forcing[::save_every]
    return _derivatives_on_grid(prob, controls, pcof, ts_saved, saved, order,
                                forcing=f_saved)


def eval_forward_complex(prob, controls, pcof, order: int = 2, **kwargs):
    """Complex-valued history ``(n_saved, N, B)`` (reference complex wrapper,
    src/forward_evolution.jl:15-29)."""
    hist = eval_forward(prob, controls, pcof, order, **kwargs)
    N = prob.N_tot_levels
    return hist[..., :N, :] + 1j * hist[..., N:, :]


@partial(jax.jit, static_argnames=("order",))
def eval_adjoint(prob, controls, pcof, terminal_condition, order: int = 2,
                 forcing=None):
    """Backward adjoint propagation (reference ``eval_adjoint``,
    src/forward_evolution.jl:278-483).

    Solves the discrete-adjoint recursion of the Hermite step: with the
    forward step ``LHS_{n+1} w_{n+1} = RHS_n w_n`` the adjoint variable
    lambda (the reference's lambda history) satisfies::

        lambda_N   = terminal_condition              (pre-solved, see
                                                      adjoint.compute_terminal_condition)
        mu_n       = RHS_n^T lambda_{n+1} + forcing_n
        lambda_n   = LHS_n^{-T} mu_n                 for n = N-1 .. 1

    ``forcing`` is the per-step adjoint source term, shape
    ``(nsteps+1, 2N, B)`` (the guard-penalty source,
    src/eval_grad_discrete_adjoint.jl:732-752).

    Returns ``(nsteps+1, 2N, B)`` with index n holding lambda_n; index 0 is
    zero, matching the reference's convention that the backward sweep writes
    columns 2..nsteps+1 (src/forward_evolution.jl:421-483).
    """
    controls = as_control_tuple(controls)
    m = order // 2
    dt, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    prob = working_problem(prob)
    P, Q, dt = P.astype(wd), Q.astype(wd), dt.astype(wd)
    eye = jnp.eye(prob.real_system_size, dtype=wd)

    lam_N = terminal_condition.astype(wd)
    n = prob.nsteps
    if forcing is None:
        f_mid = jnp.zeros((n - 1,) + lam_N.shape, dtype=wd)
    else:
        f_mid = forcing[1:n].astype(wd)

    # A forward scan over time-reversed inputs.
    precompute = _use_precomputed_stages(prob)
    if precompute:
        # Hoisted state-independent work: RHS matrices and transposed-LHS
        # (and their factorizations or approximate inverses) for
        # t_1..t_{N-1}, batched outside the scan.
        rhs_mats, lhs_mats = _stage_matrices_both(prob, m, dt, P[1:n], Q[1:n])
        lhs_T = jnp.swapaxes(lhs_mats, -1, -2)

        if precompute == "full":
            lu, piv = factorize_stages(lhs_T)

            def step_fast(lam, xs):
                R, MT, lu_n, piv_n, f_n = xs
                mu = jnp.swapaxes(R, -1, -2) @ lam + f_n
                lam_prev = solve_factored(MT, lu_n, piv_n, mu)
                return lam_prev, lam_prev

            xs = (rhs_mats[::-1], lhs_T[::-1], lu[::-1], piv[::-1],
                  f_mid[::-1])
        else:
            XT = schulz_inverse_auto(
                lhs_T, prob.schulz_iters,
                X0=_drift_stage_inverse(prob, m, dt, transpose=True),
                warm_iters=_warm_budget(prob))

            def step_fast(lam, xs):
                R, MT, X, f_n = xs
                mu = jnp.swapaxes(R, -1, -2) @ lam + f_n
                lam_prev = inverse_stage_solve(MT, X, mu)
                return lam_prev, lam_prev

            xs = (rhs_mats[::-1], lhs_T[::-1], XT[::-1], f_mid[::-1])

        lam0, lams_rev = jax.lax.scan(step_fast, lam_N, xs)
    else:
        schulz_X0T = (_drift_stage_inverse(prob, m, dt, transpose=True)
                      if prob.solver == "schulz" else None)

        def step(lam, xs):
            pq_n, f_n = xs
            A_n = assemble_generator_stack(prob, pq_n[0], pq_n[1], m)
            # mu_n = RHS_n^T lambda_{n+1} (+ forcing)
            D_n = scaled_derivatives(A_n, eye, m)
            rhs_mat = build_rhs(D_n, dt, m)
            mu = rhs_mat.T @ lam + f_n
            # lambda_n = LHS_n^{-T} mu_n
            lhs_mat = build_lhs(D_n, dt, m)
            if prob.solver == "schulz":
                MT = lhs_mat.T
                lam_prev = inverse_stage_solve(
                    MT, schulz_inverse_auto(MT, prob.schulz_iters,
                                            X0=schulz_X0T,
                                            warm_iters=_warm_budget(prob)),
                    mu)
            else:
                lam_prev = stage_solve_transposed(lhs_mat, mu)
            return lam_prev, lam_prev

        xs = ((P[1:n][::-1], Q[1:n][::-1]), f_mid[::-1])
        lam0, lams_rev = jax.lax.scan(step, lam_N, xs)

    lams = lams_rev[::-1]
    zeros = jnp.zeros_like(lam_N)
    return jnp.concatenate([zeros[None], lams, lam_N[None]], axis=0)
