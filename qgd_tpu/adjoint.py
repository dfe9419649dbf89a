"""Gradient engines (reference src/eval_grad_discrete_adjoint.jl,
eval_grad_forced.jl, eval_grad_finite_difference.jl, eval_hessian.jl).

Four independent routes to the gradient of the discretized objective, which
must agree to the reference's test tolerances
(test/GradientTests/compare_gradients.jl:47-48: adjoint-vs-forced 1e-14,
vs finite differences 1e-9):

1. ``discrete_adjoint`` (default ``method="ad"``): reverse-mode AD through
   the ``lax.scan`` propagator. The VJP of the per-step LU solve is exactly
   the transposed-LHS adjoint solve, so this *is* the reference's discrete
   adjoint algorithm, derived by the compiler instead of by hand.
2. ``discrete_adjoint(method="lagrange")``: the hand-structured version —
   explicit guard forcing, terminal-condition solve, backward lambda sweep
   (qgd_tpu/forward.eval_adjoint), and per-step gradient accumulation
   ``sum_n lambda_{n+1}^T d/dtheta [RHS_n w_n - LHS_{n+1} w_{n+1}]`` (the
   reference's ``accumulate_gradient!``/``recursive_magic!``,
   src/eval_grad_discrete_adjoint.jl:582-726, with the chain rule through
   the control tables done by per-step VJP instead of hand recursion).
   Kept as a structural cross-check of (1).
3. ``eval_grad_forced``: forward-mode AD (jacfwd), one tangent per control
   parameter — mathematically the reference's forced/GOAT method
   (src/eval_grad_forced.jl): the jvp tangent state satisfies the forced
   variational equation with forcing ``(dA/dtheta_k) w``.
4. ``eval_grad_finite_difference``: central differences
   (src/eval_grad_finite_difference.jl, default eps 1e-5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .controls import as_control_tuple, control_tables_at
from .forward import eval_forward, eval_adjoint, _time_grid, vjp_chunk_size
from .objective import (
    with_host_target,
    objective_value,
    objective_parts,
    terminal_cost,
    terminal_cost_and_grad,
    _realify_target,
)
from .ops.hermite import (
    assemble_generator_stack,
    scaled_derivatives,
    build_rhs,
    build_lhs,
)
from .ops.linalg import stage_solve_transposed


def _objective_fn(prob, controls, pcof, target, order, cost_type):
    return objective_value(prob, controls, pcof, target, order,
                           ridge_penalty_strength=0.0, cost_type=cost_type)


def default_adjoint_method() -> str:
    """Default gradient route: the hand-structured Lagrange adjoint.

    On CPU the Lagrange route is ~6-7x faster than AD-of-scan (2.97s vs
    19.9s for the CNOT3 order-4 gradient at nsteps=1000 — remat
    recomputation plus scan-transpose overhead). ``method="ad"`` is kept as
    an independent verification route; both agree to 1e-13
    (tests/test_gradients.py)."""
    return "lagrange"


@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "cost_type", "method"))
def discrete_adjoint(prob, controls, pcof, target, order: int = 2,
                     cost_type: str = "Infidelity", method: str = "auto"):
    """Exact gradient of (terminal cost + guard penalty) w.r.t. pcof
    (reference ``discrete_adjoint``, src/eval_grad_discrete_adjoint.jl:83-160;
    ridge gradient is added by the optimizer, as in the reference,
    src/ipopt_optimal_control.jl:311)."""
    controls = as_control_tuple(controls)
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    if method == "auto":
        method = default_adjoint_method()
    if method == "ad":
        return jax.grad(
            lambda pc: _objective_fn(prob, controls, pc, target, order,
                                     cost_type)
        )(pcof)
    if method == "lagrange":
        return _discrete_adjoint_lagrange(prob, controls, pcof, target, order,
                                          cost_type)
    if method == "segmented":
        # O(sqrt T)-memory route for long horizons (qgd_tpu/segmented.py)
        from .segmented import segmented_gradient

        return segmented_gradient(prob, controls, pcof, target, order,
                                  cost_type=cost_type)
    raise ValueError(f"unknown method {method!r}")


def compute_guard_forcing(prob, history):
    """Adjoint source from the guard penalty: ``dJ_guard/dw_n =
    (2 dt/T) tau_n W w_n`` with trapezoid weights ``tau`` (reference
    ``compute_guard_forcing!``, src/eval_grad_discrete_adjoint.jl:732-752,
    modulo the reference's opposite lambda sign convention).

    ``history``: (nsteps+1, 2N, B). Returns the same shape.
    """
    dt = prob.tf / prob.nsteps
    W = prob.guard_subspace_projector
    f = jnp.einsum("ab,tbj->taj", W, history) * (2.0 * dt / prob.tf)
    n = f.shape[0]
    weights = jnp.ones(n, dtype=f.dtype).at[0].set(0.5).at[-1].set(0.5)
    return f * weights[:, None, None]


@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "cost_type"))
def compute_terminal_condition(prob, controls, pcof, target, final_state,
                               order: int = 2, cost_type: str = "Infidelity",
                               forcing=None):
    """Solve ``LHS(t_f)^T lambda_N = dJ/dw_N (+ forcing)`` (reference
    ``compute_terminal_condition``, src/eval_grad_discrete_adjoint.jl:1-67,
    which uses GMRES on the adjoint derivative recursion; here a direct
    transposed dense solve).

    Sign convention: lambda is the gradient-of-cost adjoint (d(total J)/d...),
    the negative of the reference's descent-direction lambda; the reference's
    ``-(final - target)`` etc. appear here without the minus.
    """
    controls = as_control_tuple(controls)
    target_real = _realify_target(prob, target)
    _, g = terminal_cost_and_grad(final_state, target_real,
                                  prob.N_ess_levels, cost_type)
    if forcing is not None:
        g = g + forcing
    return _solve_lhsT_at_tf(prob, controls, pcof, g, order)


def _solve_lhsT_at_tf(prob, controls, pcof, g, order: int):
    """Solve the transposed one-step LHS at t_f against ``g`` (the stage
    solve shared by :func:`compute_terminal_condition` and the sharded
    Lagrange route)."""
    m = order // 2
    dt, ts = _time_grid(prob)
    p_vals, q_vals = control_tables_at(controls, pcof, prob.tf, m)
    A = assemble_generator_stack(prob, p_vals, q_vals, m)
    eye = jnp.eye(prob.real_system_size, dtype=jnp.float64)
    D = scaled_derivatives(A, eye, m)
    lhs_mat = build_lhs(D, dt, m)
    if prob.solver == "schulz":
        from .ops.linalg import inverse_stage_solve, schulz_inverse_auto

        MT = lhs_mat.T
        return inverse_stage_solve(
            MT, schulz_inverse_auto(MT, prob.schulz_iters), g)
    return stage_solve_transposed(lhs_mat, g)


def _step_residual(prob, controls, pcof, t_n, t_np1, dt, w_n, w_np1, m):
    """``RHS_n(theta) w_n - LHS_{n+1}(theta) w_{n+1}`` as a function of pcof,
    evaluated in the problem's working dtype (f32 in fast mode)."""
    from .problem import working_problem

    wd = prob.work_dtype
    prob = working_problem(prob)
    p_n, q_n = control_tables_at(controls, pcof, t_n, m)
    p_np1, q_np1 = control_tables_at(controls, pcof, t_np1, m)
    p_n, q_n = p_n.astype(wd), q_n.astype(wd)
    p_np1, q_np1 = p_np1.astype(wd), q_np1.astype(wd)
    dt = jnp.asarray(dt, wd)
    A_n = assemble_generator_stack(prob, p_n, q_n, m)
    A_np1 = assemble_generator_stack(prob, p_np1, q_np1, m)
    rhs = build_rhs(scaled_derivatives(A_n, w_n.astype(wd), m), dt, m)
    lhs = build_lhs(scaled_derivatives(A_np1, w_np1.astype(wd), m), dt, m)
    return rhs - lhs


@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "cost_type",
                                   "ridge_penalty_strength", "ic_axis"))
def objective_and_gradient(prob, controls, pcof, target, order: int = 4,
                           cost_type: str = "Infidelity",
                           ridge_penalty_strength: float = 0.0,
                           ic_axis: str | None = None):
    """One forward solve shared between the objective and its Lagrange
    gradient (the reference arranges the same sharing with its
    ``history_precomputed`` flag + pcof-memoization tracker,
    src/eval_grad_discrete_adjoint.jl:107-130,
    src/ipopt_optimal_control.jl:1-19).

    Returns ``((j1, guard, ridge), grad)`` with the ridge term and its
    gradient included.

    ``ic_axis``: when called inside ``shard_map`` with the gate-basis
    columns split over that mesh axis, all cross-column reductions (the
    infidelity trace, the guard integral, the gradient accumulation) are
    ``psum``-ed over it — the multi-device gradient path, structured so NO
    reverse-mode AD of the scan propagator is ever needed.
    """
    from .objective import guard_penalty_real

    controls = as_control_tuple(controls)
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    target_real = _realify_target(prob, target)
    history = eval_forward(prob, controls, pcof, order)
    dt = prob.tf / prob.nsteps
    j1, _ = terminal_cost_and_grad(history[-1], target_real,
                                   prob.N_ess_levels, cost_type, ic_axis)
    guard = guard_penalty_real(history, dt, prob.tf,
                               prob.guard_subspace_projector)
    if ic_axis is not None:
        guard = jax.lax.psum(guard, ic_axis)
    ridge = ridge_penalty_strength * jnp.vdot(pcof, pcof) / pcof.shape[0]
    grad = _discrete_adjoint_lagrange(prob, controls, pcof, target, order,
                                      cost_type, history=history,
                                      ic_axis=ic_axis)
    grad = grad + 2.0 * ridge_penalty_strength * pcof / pcof.shape[0]
    return (j1, guard, ridge), grad


def _discrete_adjoint_lagrange(prob, controls, pcof, target, order, cost_type,
                               history=None, ic_axis=None):
    """Hand-structured discrete adjoint; see module docstring item (2).
    ``ic_axis``: psum cross-column reductions (see
    :func:`objective_and_gradient`)."""
    m = order // 2
    dt, ts = _time_grid(prob)

    # (1) forward history (src/eval_grad_discrete_adjoint.jl:130), reused
    # from the objective evaluation when provided
    if history is None:
        history = eval_forward(prob, controls, pcof, order)

    # (2) guard forcing (:134)
    forcing = compute_guard_forcing(prob, history)

    # (3) terminal condition (:138) — the terminal gradient's infidelity
    # trace reduces over ALL gate columns (psum under sharding)
    target_real = _realify_target(prob, target)
    _, g_T = terminal_cost_and_grad(history[-1], target_real,
                                    prob.N_ess_levels, cost_type, ic_axis)
    lam_N = _solve_lhsT_at_tf(prob, controls, pcof, g_T + forcing[-1], order)

    # (4) backward lambda sweep (:144)
    lam_hist = eval_adjoint(prob, controls, pcof, lam_N, order,
                            forcing=forcing)

    # (5) gradient accumulation (:150-158):
    # dJ/dtheta = +sum_n lambda_{n+1}^T d/dtheta [RHS_n w_n - LHS_{n+1} w_{n+1}]
    # (Lagrangian with multiplier -lambda on LHS w_{n+1} - RHS w_n = 0).
    # Both RHS_n (used by step n) and LHS_n (used by step n-1) are linear
    # combinations of the SAME derivative stack W_j(t_n, w_n), so each time
    # point needs exactly ONE stack VJP with the combined cotangent
    #   cot_j(t_k) = dt^j c_j lambda_{k+1}  -  (-dt)^j c_j lambda_k
    # (RHS term absent at k=N, LHS term absent at k=0 where lambda_0 = 0).
    # This halves the recursion-transpose work vs differentiating each
    # step's residual separately, and the sum over time points has no
    # sequential dependency — one batched vmap, unlike the reference's
    # serial per-step loop (src/eval_grad_discrete_adjoint.jl:614-639).
    from .ops.hermite import hermite_coefficients

    c = jnp.asarray(hermite_coefficients(m), dtype=jnp.float64)
    jpow = jnp.arange(m + 1, dtype=jnp.float64)
    w_rhs = c * dt ** jpow            # (m+1,) RHS weights  dt^j c_j
    w_lhs = c * (-dt) ** jpow         # (m+1,) LHS weights  (-dt)^j c_j

    lam_next = jnp.concatenate(      # lambda_{k+1}; zero beyond the end
        [lam_hist[1:], jnp.zeros_like(lam_hist[:1])], axis=0)
    # cot (T, m+1, 2N, B)
    cot = (w_rhs[None, :, None, None] * lam_next[:, None]
           - w_lhs[None, :, None, None] * lam_hist[:, None])

    # The per-step VJP is split at the control-table boundary: the chain
    #   pcof -> tables(t_k) -> A-stack -> derivative stack
    # used to be transposed as one graph PER TIME POINT, which re-embedded
    # the whole control-table build (for carrier controls: per-frequency
    # spline evals + Cauchy products — hundreds of small ops) T times over.
    # Instead: per-step VJPs stop at the table values (dense
    # assembly/recursion transposes — batched matmuls), and the pcof chain
    # rule is
    # ONE reverse pass through the vectorized whole-grid table build.
    # Identical chain rule, ~5x cheaper for the flagship carrier config.
    from .controls import control_tables
    from .problem import working_problem

    wd = prob.work_dtype
    wprob = working_problem(prob)
    P64, Q64 = control_tables(controls, pcof, ts, m)    # (T+1, m+1, N_ops)
    Pw, Qw = P64.astype(wd), Q64.astype(wd)

    def stack_from_tables(p_t, q_t, w):
        A = assemble_generator_stack(wprob, p_t, q_t, m)
        return scaled_derivatives(A, w.astype(wd), m)

    def table_cot(p_t, q_t, w_k, cot_k):
        _, vjp = jax.vjp(lambda p, q: stack_from_tables(p, q, w_k),
                         p_t, q_t)
        return vjp(cot_k.astype(wd))     # (dP_t, dQ_t) each (m+1, N_ops)

    # Chunk the batched VJPs so the materialized derivative-stack
    # residuals fit device memory (forward.vjp_chunk_size).
    T = ts.shape[0]
    chunk = vjp_chunk_size(wprob, m)
    if T <= chunk:
        cotP, cotQ = jax.vmap(table_cot)(Pw, Qw, history, cot)
    else:
        cotP, cotQ = jax.lax.map(lambda a: table_cot(*a),
                                 (Pw, Qw, history, cot), batch_size=chunk)
    _, vjp_tables = jax.vjp(
        lambda pc: control_tables(controls, pc, ts, m), pcof)
    (grad,) = vjp_tables((cotP.astype(jnp.float64),
                          cotQ.astype(jnp.float64)))
    if ic_axis is not None:
        grad = jax.lax.psum(grad, ic_axis)
    return grad


@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "cost_type", "return_forcing"))
def eval_grad_forced(prob, controls, pcof, target, order: int = 2,
                     cost_type: str = "Infidelity",
                     return_forcing: bool = False):
    """Forced/GOAT gradient: forward-mode differentiation of the discrete
    scheme, one tangent solve per parameter (reference ``eval_grad_forced``,
    src/eval_grad_forced.jl:18-195 — its explicitly-built forcing arrays
    ``(dA/dtheta_k) w`` are exactly the jvp tangents of this computation)."""
    controls = as_control_tuple(controls)
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    return jax.jacfwd(
        lambda pc: _objective_fn(prob, controls, pc, target, order, cost_type)
    )(pcof)


def eval_grad_finite_difference(prob, controls, pcof, target, order: int = 2,
                                dpcof: float = 1e-5,
                                cost_type: str = "Infidelity"):
    """Central-difference gradient (reference
    ``eval_grad_finite_difference``, src/eval_grad_finite_difference.jl:16-72)."""
    from .objective import host_realify_target

    target = host_realify_target(target)
    controls = as_control_tuple(controls)
    pcof = np.asarray(pcof, dtype=np.float64)
    grad = np.zeros_like(pcof)
    f = jax.jit(lambda pc: _objective_fn(prob, controls, pc, target, order,
                                         cost_type))
    for i in range(pcof.size):
        pp = pcof.copy()
        pp[i] += dpcof
        fr = float(f(jnp.asarray(pp)))
        pp[i] -= 2 * dpcof
        fl = float(f(jnp.asarray(pp)))
        grad[i] = (fr - fl) / (2 * dpcof)
    return jnp.asarray(grad)


def eval_hessian(prob, controls, pcof, target, order: int = 2,
                 cost_type: str = "Infidelity", method: str = "ad"):
    """Hessian of the objective. ``method="ad"`` uses exact forward-over-
    reverse AD (an upgrade over the reference's finite-difference Hessian);
    ``method="fd"`` reproduces the reference's central-difference scheme
    (src/eval_hessian.jl:1-58)."""
    from .objective import host_realify_target

    target = host_realify_target(target)
    controls = as_control_tuple(controls)
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    fn = lambda pc: _objective_fn(prob, controls, pc, target, order, cost_type)
    if method == "ad":
        # forward-over-Lagrange: jvp through the hand-structured adjoint
        # (no reverse-mode-of-scan anywhere)
        return jax.jacfwd(
            lambda pc: discrete_adjoint(prob, controls, pc, target, order,
                                        cost_type=cost_type,
                                        method="lagrange"))(pcof)
    if method == "fd":
        eps = 1e-4
        n = pcof.shape[0]
        f = jax.jit(fn)
        H = np.zeros((n, n))
        pc = np.asarray(pcof)
        for i in range(n):
            for j in range(i, n):
                pij = pc.copy()
                pij[i] += eps
                pij[j] += eps
                fpp = float(f(jnp.asarray(pij)))
                pij[j] -= 2 * eps
                fpm = float(f(jnp.asarray(pij)))
                pij[i] -= 2 * eps
                fmm = float(f(jnp.asarray(pij)))
                pij[j] += 2 * eps
                fmp = float(f(jnp.asarray(pij)))
                H[i, j] = H[j, i] = (fpp - fpm - fmp + fmm) / (4 * eps * eps)
        return jnp.asarray(H)
    raise ValueError(f"unknown method {method!r}")
