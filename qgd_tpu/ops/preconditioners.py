"""Preconditioners for the GMRES stage solve
(reference src/preconditioners.jl).

Each preconditioner is a factory returning ``(apply, apply_T)`` closures for
the forward and transposed solves. They approximate the inverse of the
*no-control* LHS ``sum_j (-dt)^j c_j D_j(drift only)`` — exactly the
reference's construction (src/preconditioners.jl:44-131,
src/forward_evolution.jl:772-802 ``form_LHS_no_control``).
"""

from __future__ import annotations

import jax.numpy as jnp
import jax.scipy.linalg as jsp_linalg

from .hermite import assemble_generator_stack, scaled_derivatives, build_lhs


def no_control_lhs(prob, dt, order: int) -> jnp.ndarray:
    """Dense drift-only LHS matrix (reference ``form_LHS_no_control``,
    src/forward_evolution.jl:777-802)."""
    m = order // 2
    zeros = jnp.zeros((m, max(prob.N_operators, 1)), dtype=jnp.float64)
    A = assemble_generator_stack(prob, zeros[:, :prob.N_operators],
                                 zeros[:, :prob.N_operators], m)
    eye = jnp.eye(prob.real_system_size, dtype=jnp.float64)
    D = scaled_derivatives(A, eye, m)
    return build_lhs(D, dt, m)


def identity_preconditioner(prob, dt, order: int):
    """No-op (reference ``IdentityPreconditioner``,
    src/preconditioners.jl:35-40)."""
    f = lambda v: v
    return f, f


def lu_preconditioner(prob, dt, order: int):
    """Exact inverse of the no-control LHS via one LU factorization
    (reference ``LUPreconditioner``, src/preconditioners.jl:44-55)."""
    lu_piv = jsp_linalg.lu_factor(no_control_lhs(prob, dt, order))

    def apply(v):
        return jsp_linalg.lu_solve(lu_piv, v)

    def apply_T(v):
        return jsp_linalg.lu_solve(lu_piv, v, trans=1)

    return apply, apply_T


def diagonal_hamiltonian_preconditioner(prob, dt, order: int):
    """Exact block-2x2 elimination when the drift Hamiltonian is diagonal
    (reference ``DiagonalHamiltonianPreconditioner``,
    src/preconditioners.jl:64-131): the no-control LHS then couples only
    the (u_i, v_i) pairs, giving N independent 2x2 systems stored as three
    diagonals [[a, b], [-b, a]]."""
    N = prob.N_tot_levels
    M = no_control_lhs(prob, dt, order)
    a = jnp.diagonal(M[:N, :N])       # upper-left diag (== lower-right)
    b = jnp.diagonal(M[:N, N:])       # upper-right diag; lower-left is -b
    det = a * a + b * b

    def _mul(ca, cb, v):
        # [[ca, cb], [-cb, ca]] block-diagonal action on stacked (2N, B)
        u, w = v[:N], v[N:]
        ca = ca.reshape((N,) + (1,) * (v.ndim - 1))
        cb = cb.reshape((N,) + (1,) * (v.ndim - 1))
        return jnp.concatenate([ca * u + cb * w, -cb * u + ca * w], axis=0)

    def apply(v):
        # inverse of [[a, b], [-b, a]] is [[a, -b], [b, a]] / det
        return _mul(a / det, -b / det, v)

    def apply_T(v):
        return _mul(a / det, b / det, v)

    return apply, apply_T


PRECONDITIONERS = {
    "identity": identity_preconditioner,
    "lu": lu_preconditioner,
    "diagonal": diagonal_hamiltonian_preconditioner,
}
