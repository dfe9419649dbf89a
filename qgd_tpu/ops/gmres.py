"""Matrix-free batched GMRES for the implicit Hermite stage — the large-N
alternative to the dense-LU stage solve.

The reference's production path is restarted GMRES with a reusable Arnoldi
workspace per initial condition (src/forward_evolution.jl:142-220,487-505)
and data-dependent iteration counts. On an accelerator, data-dependent
trip counts force host round-trips, so this implementation uses a *fixed* iteration
budget (restart-free Arnoldi of static size), batched over the
initial-condition axis, wrapped in ``lax.custom_linear_solve`` so
reverse-mode AD solves the transposed system with the same machinery.

With the reference's preconditioners (qgd_tpu/ops/preconditioners.py) the
iteration counts it reports are flat and small (~5-15), so a static budget
matches its effective cost without the dynamism.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def gmres_solve_single(matvec, b, x0, *, iters: int, precond=None):
    """Left-preconditioned GMRES(iters) for one right-hand side ``b (n,)``.

    Static ``iters``-step Arnoldi followed by a least-squares solve of the
    (iters+1, iters) Hessenberg system. No early exit — converged iterations
    add numerically-zero Krylov directions, which the least-squares handles.
    """
    if precond is None:
        precond = lambda v: v

    n = b.shape[0]
    r0 = precond(b - matvec(x0))
    beta = jnp.linalg.norm(r0)
    eps = jnp.asarray(1e-300, dtype=b.dtype)
    V = jnp.zeros((iters + 1, n), dtype=b.dtype)
    V = V.at[0].set(r0 / jnp.maximum(beta, eps))
    H = jnp.zeros((iters + 1, iters), dtype=b.dtype)

    def arnoldi_step(j, carry):
        V, H = carry
        w = precond(matvec(V[j]))
        # modified Gram-Schmidt against all previous vectors (masked)
        def mgs(i, wh):
            w, h = wh
            hij = jnp.where(i <= j, jnp.vdot(V[i], w), 0.0)
            w = w - hij * V[i]
            return w, h.at[i].set(hij)

        w, hcol = lax.fori_loop(0, iters + 1, mgs,
                                (w, jnp.zeros(iters + 1, dtype=b.dtype)))
        hnorm = jnp.linalg.norm(w)
        hcol = hcol.at[j + 1].set(hnorm)
        V = V.at[j + 1].set(w / jnp.maximum(hnorm, eps))
        H = H.at[:, j].set(hcol)
        return V, H

    V, H = lax.fori_loop(0, iters, arnoldi_step, (V, H))

    e1 = jnp.zeros(iters + 1, dtype=b.dtype).at[0].set(beta)
    y, *_ = jnp.linalg.lstsq(H, e1)
    return x0 + V[:iters].T @ y


def gmres_solve(matvec, B, X0, *, iters: int, precond=None):
    """Batched over trailing axis: ``B (n, nb)``."""
    f = lambda b, x0: gmres_solve_single(matvec, b, x0, iters=iters,
                                         precond=precond)
    return jax.vmap(f, in_axes=1, out_axes=1)(B, X0)


def hermite_gmres_stage(apply_lhs, apply_lhs_T, B, X0, *, iters: int,
                        precond=None, precond_T=None):
    """Differentiable implicit-stage solve ``LHS X = B`` with matrix-free
    operators; the transpose solve (used by reverse-mode AD — the discrete
    adjoint's transposed-LHS solve) runs GMRES on ``apply_lhs_T``."""
    def solve(mv, b):
        return gmres_solve(apply_lhs, b, X0, iters=iters, precond=precond)

    def transpose_solve(mv, b):
        return gmres_solve(apply_lhs_T, b, jnp.zeros_like(b), iters=iters,
                           precond=precond_T)

    return lax.custom_linear_solve(apply_lhs, B, solve=solve,
                                   transpose_solve=transpose_solve)
