"""Hermite-Obreshkov (two-point Taylor) timestep core.

The scheme integrates ``dw/dt = A(t) w`` (real-stacked, ``A = [[S,K],[-K,S]]``)
with the order-``2m`` one-step relation (reference src/hermite.jl:389-427)::

    sum_{j=0}^{m} (-dt)^j c_jm  w_{n+1}^{(j)}/j!  =  sum_{j=0}^{m} dt^j c_jm  w_n^{(j)}/j!

where ``c_jm = m! (2m-j)! / ((2m)! (m-j)!)`` are the diagonal Pade /
Hermite-Obreshkov weights and ``w^{(j)}/j!`` are *scaled* time derivatives,
generated by the Leibniz recursion (src/hermite.jl:10-101)::

    w^{(j+1)}/(j+1)!  =  1/(j+1) * sum_{i=0}^{j}  [A^{(j-i)}/(j-i)!]  [w^{(i)}/i!]

Accelerator formulation
-----------------------
Everything here is a handful of dense matmuls with static shapes:

* The scaled generator derivatives ``A~_k = A^{(k)}(t)/k!`` are assembled as a
  stacked ``(m, 2N, 2N)`` tensor from the drift and an einsum of control
  derivative tables against the stacked control operators.
* Applied to a *batch* of states ``W (2N, B)`` the recursion is
  ``m(m+1)/2`` matmuls.
* Applied to the identity it materializes the dense one-step LHS/RHS
  matrices, so the implicit stage is a single batched LU solve — no GMRES,
  no data-dependent iteration counts, no per-initial-condition loop
  (contrast reference src/forward_evolution.jl:131-220).

All functions are pure and differentiable; ``m`` is static.
"""

from __future__ import annotations

from functools import lru_cache
import math

import jax.numpy as jnp


def hermite_coefficient(j: int, p: int, q: int) -> float:
    """Hermite/Pade quadrature weight ``c_j = p! (p+q-j)! / ((p+q)! (p-j)!)``
    (reference ``coefficient``, src/hermite.jl:389-391)."""
    return (math.factorial(p) * math.factorial(p + q - j)
            / (math.factorial(p + q) * math.factorial(p - j)))


@lru_cache(maxsize=None)
def hermite_coefficients(m: int) -> tuple:
    """The weights ``c_jm = coefficient(j, m, m)`` for ``j = 0..m``."""
    return tuple(hermite_coefficient(j, m, m) for j in range(m + 1))


def assemble_generator_stack(prob, p_vals: jnp.ndarray, q_vals: jnp.ndarray,
                             m: int) -> jnp.ndarray:
    """Assemble the stacked scaled generator derivatives ``A~_k`` for
    ``k = 0..m-1`` at one time point.

    ``p_vals``/``q_vals`` have shape ``(m, N_ops)`` holding
    ``p_j^{(k)}(t)/k!`` (resp. ``q``) — the reference's
    ``fill_p_mat!``/``fill_q_mat!`` tables (src/Controls/Control.jl:125-149).

    Returns ``(m, 2N, 2N)`` with
    ``A~_k = [[S_k, K_k], [-K_k, S_k]]`` where (src/hermite.jl:556-588)::

        S_k = delta_{k0} S_drift + sum_j q_vals[k, j] * asym_op[j]
        K_k = delta_{k0} K_drift + sum_j p_vals[k, j] * sym_op[j]
    """
    N = prob.N_tot_levels
    if prob.N_operators > 0:
        S = jnp.einsum("kj,jab->kab", q_vals, prob.asym_operators)
        K = jnp.einsum("kj,jab->kab", p_vals, prob.sym_operators)
    else:
        S = jnp.zeros((m, N, N), dtype=jnp.float64)
        K = jnp.zeros((m, N, N), dtype=jnp.float64)
    S = S.at[0].add(prob.system_asym)
    K = K.at[0].add(prob.system_sym)
    top = jnp.concatenate([S, K], axis=-1)
    bot = jnp.concatenate([-K, S], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def scaled_derivatives(A_stack: jnp.ndarray, W0: jnp.ndarray, m: int,
                       forcing: jnp.ndarray | None = None) -> jnp.ndarray:
    """Run the Leibniz recursion: given ``A_stack (m, 2N, 2N)`` and a state
    batch ``W0 (2N, B)``, return ``(m+1, 2N, B)`` of scaled derivatives
    ``W_j = w^{(j)}/j!`` (reference ``compute_derivatives!``,
    src/hermite.jl:10-101).

    ``forcing``, if given, has shape ``(m, 2N, B)`` with ``forcing[j]`` the
    scaled forcing derivative ``f^{(j)}(t)/j!`` added at level ``j`` before
    the ``1/(j+1)`` factor (inhomogeneous term of the variational/forced
    equation, src/hermite.jl:43-46).
    """
    Ws = [W0]
    for j in range(m):
        acc = A_stack[j] @ Ws[0]
        for i in range(1, j + 1):
            acc = acc + A_stack[j - i] @ Ws[i]
        if forcing is not None:
            acc = acc + forcing[j]
        Ws.append(acc / (j + 1))
    return jnp.stack(Ws)


def adjoint_scaled_derivatives(A_stack: jnp.ndarray, L0: jnp.ndarray,
                               m: int) -> jnp.ndarray:
    """Adjoint-derivative recursion (reference
    ``compute_adjoint_derivatives!``, src/hermite.jl:225-305).

    Identical to :func:`scaled_derivatives` but with each generator replaced
    by its transpose ``A~_k^T = -A~_k`` applied on the left; equivalently it
    computes the scaled derivatives of the adjoint system
    ``d lambda/dt = A(t)^T lambda`` *as if the generator's time-derivative
    tables were those of A*. Used for the terminal-condition solve and for
    parity tests against hand-built operator oracles.
    """
    AT_stack = jnp.swapaxes(A_stack, -1, -2)
    Ls = [L0]
    for j in range(m):
        acc = AT_stack[j] @ Ls[0]
        for i in range(1, j + 1):
            acc = acc + AT_stack[j - i] @ Ls[i]
        Ls.append(acc / (j + 1))
    return jnp.stack(Ls)


def build_rhs(W_derivs: jnp.ndarray, dt, m: int) -> jnp.ndarray:
    """Explicit side: ``sum_j dt^j c_jm W_j`` (reference ``build_RHS!``,
    src/hermite.jl:394-403). ``W_derivs`` is ``(m+1, ...)``."""
    c = hermite_coefficients(m)
    acc = c[0] * W_derivs[0]
    dt_pow = jnp.asarray(1.0, dtype=W_derivs.dtype)
    for j in range(1, m + 1):
        dt_pow = dt_pow * dt
        acc = acc + (c[j] * dt_pow) * W_derivs[j]
    return acc


def build_lhs(W_derivs: jnp.ndarray, dt, m: int) -> jnp.ndarray:
    """Implicit side: ``sum_j (-dt)^j c_jm W_j`` (reference ``build_LHS!``,
    src/hermite.jl:418-427)."""
    return build_rhs(W_derivs, -dt, m)


def taylor_expand(W_derivs: jnp.ndarray, dt, m: int) -> jnp.ndarray:
    """Taylor-series extrapolation ``sum_j dt^j W_j`` of the state at
    ``t + dt`` from scaled derivatives at ``t`` (reference ``taylor_expand!``,
    src/hermite.jl:447-457; note columns are already divided by j!)."""
    acc = W_derivs[m]
    for j in range(m - 1, -1, -1):
        acc = W_derivs[j] + dt * acc
    return acc


def step_matrices(A_stack_n: jnp.ndarray, A_stack_np1: jnp.ndarray, dt,
                  m: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Materialize the dense one-step matrices ``(LHS, RHS)`` such that
    ``LHS @ w_{n+1} = RHS @ w_n``.

    Runs the derivative recursion on the identity — the dense analogue of the
    reference's column-probing ``form_LHS``/``form_RHS`` (src/hermite.jl:594-640)
    but O(m^2) matmuls instead of O(2N) recursion sweeps, and used in the hot
    path (the reference only uses the materialized forms for analysis; its hot
    path is GMRES with operator closures, src/forward_evolution.jl:561-592).
    """
    two_n = A_stack_n.shape[-1]
    eye = jnp.eye(two_n, dtype=A_stack_n.dtype)
    D_n = scaled_derivatives(A_stack_n, eye, m)
    D_np1 = scaled_derivatives(A_stack_np1, eye, m)
    rhs_mat = build_rhs(D_n, dt, m)
    lhs_mat = build_lhs(D_np1, dt, m)
    return lhs_mat, rhs_mat


def form_lhs_matrix(prob, controls, t, pcof, dt, order: int) -> jnp.ndarray:
    """Dense LHS matrix at time ``t`` (reference ``form_LHS``,
    src/hermite.jl:594-614)."""
    from ..controls import control_tables_at

    m = order // 2
    p_vals, q_vals = control_tables_at(controls, pcof, t, m)
    A_stack = assemble_generator_stack(prob, p_vals, q_vals, m)
    eye = jnp.eye(prob.real_system_size, dtype=jnp.float64)
    D = scaled_derivatives(A_stack, eye, m)
    return build_lhs(D, dt, m)


def form_rhs_matrix(prob, controls, t, pcof, dt, order: int) -> jnp.ndarray:
    """Dense RHS matrix at time ``t`` (reference ``form_RHS``,
    src/hermite.jl:620-640)."""
    from ..controls import control_tables_at

    m = order // 2
    p_vals, q_vals = control_tables_at(controls, pcof, t, m)
    A_stack = assemble_generator_stack(prob, p_vals, q_vals, m)
    eye = jnp.eye(prob.real_system_size, dtype=jnp.float64)
    D = scaled_derivatives(A_stack, eye, m)
    return build_rhs(D, dt, m)
