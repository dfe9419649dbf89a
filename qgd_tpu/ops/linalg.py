"""Linear solvers for the implicit Hermite stage.

The stage matrix ``LHS = I - (dt/2) A + O(dt^2)`` is a small, extremely
well-conditioned perturbation of the identity. Two strategies solve it:

* ``solver="lu"``: a dense LU (``jnp.linalg.solve`` / batched ``getrf``),
  in the working dtype — f64 LU is native on the GPU and the CPU.
* ``solver="schulz"``: a matmul-only approximate inverse (Newton–Schulz,
  warm-started from the drift-only stage inverse) polished by iterative
  refinement with residuals in the right-hand side's dtype.

Both replace the reference's per-vector GMRES + preconditioner machinery
(src/forward_evolution.jl:142-220, src/preconditioners.jl) with a batched
direct method, and both are wrapped in ``lax.custom_linear_solve`` so
reverse-mode AD solves the transposed system with the same factorization
(``lu_solve(trans=1)``) — which *is* the discrete-adjoint transposed-LHS
solve of the reference (src/eval_grad_discrete_adjoint.jl:42-50), derived
rather than hand-written.
"""

from __future__ import annotations

import os
import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsp_linalg
from jax import lax

# Resolved ONCE at import, like the jax_default_matmul_precision pin in
# qgd_tpu/__init__: changing the env mid-process would affect newly traced
# shapes but not already-cached compilations, giving inconsistent precision
# across a session.
SCHULZ_PRECISION = os.environ.get("QGD_SCHULZ_PRECISION", "default")

# Refinement sweeps for f32 right-hand sides (import-time; see
# inverse_stage_solve). 3 keeps the stage residual under the 1e-7 guard of
# diagnostics.stage_residuals with warm budget 0 at dt = 0.55 (CNOT3 at
# nsteps=1000; 2 sweeps leave ~3e-6). 0 is valid ONLY with
# QGD_SCHULZ_PRECISION=highest (an f32-exact inverse needs no polish; the
# serial per-step solve then collapses to one matmul).
REFINE_SWEEPS_F32 = int(os.environ.get("QGD_REFINE_SWEEPS_F32", "3"))

# Matmul precision of the PRECONDITIONER APPLICATIONS inside f32
# refinement sweeps (``x += Xinv r``). The preconditioner only sets the
# convergence RATE — the fixed point is pinned by the residual
# ``b - M x``, which always runs at the session precision ("highest") — so
# these matmuls may run at "default", which on the GPU is TF32 (about 3
# decimal digits). f64 right-hand sides never use this (their sweeps
# target 1e-13-class residuals). diagnostics.stage_residuals guards the
# result (<= 1e-7 for the f32 production configuration).
PRECOND_PRECISION = os.environ.get("QGD_PRECOND_PRECISION", "default")


def factorize_stages(M):
    """Batched LU factorization of precomputed stage matrices
    ``M (T, n, n)`` — one ``getrf`` per timestep, all in parallel (this is
    the state-independent work hoisted out of the sequential scan).

    Returns ``(lu, piv)`` batched, in the stage matrices' dtype.
    """
    return jax.vmap(jsp_linalg.lu_factor)(M)


def solve_factored(M_n, lu_n, piv_n, b):
    """Solve ``M_n x = b`` with a precomputed factorization of ``M_n``.
    Wrapped in ``custom_linear_solve`` so AD solves the transposed system
    with the same factors (no differentiation through ``getrf``)."""

    def direct(rhs, trans):
        return jsp_linalg.lu_solve((lu_n, piv_n), rhs, trans=trans)

    return lax.custom_linear_solve(
        lambda v: M_n @ v, b,
        solve=lambda mv, rhs: direct(rhs, 0),
        transpose_solve=lambda mv, rhs: direct(rhs, 1),
    )


def schulz_inverse(M, X0, iters: int = 8, precision=None):
    """Newton–Schulz iteration ``X <- X (2I - M X)`` for the inverse of
    ``M`` — matmul-only, so a batch of inverses is a batch of GEMMs.

    Converges quadratically when ``||I - M X0|| < 1``. The implicit Hermite
    stage supplies an excellent warm start: the inverse of the *drift-only*
    stage matrix (control terms are an O(dt * amplitude) perturbation), the
    same observation behind the reference's ``LUPreconditioner``
    (src/preconditioners.jl:44-55). Iteration count is static; converged
    iterations are numerically idempotent.

    ``precision``: matmul precision for the iteration itself. The default
    (``None``) inherits the global setting (``highest`` under qgd_tpu).
    Each iteration is 2 matmuls per stage matrix, and Newton–Schulz is
    self-correcting, so running them at ``lax.Precision.DEFAULT`` (TF32 on
    the GPU) and letting :func:`inverse_stage_solve`'s
    refinement sweeps (at full precision) polish the solve recovers the
    accuracy at a fraction of the cost — the residual after refinement is
    ``||I - X M||^(1+refine_iters)`` regardless of how X was built.
    """
    eye = jnp.eye(M.shape[-1], dtype=M.dtype)

    def body(_, X):
        MX = jnp.matmul(M, X, precision=precision)
        return jnp.matmul(X, 2.0 * eye - MX, precision=precision)

    # rolled loop (not unrolled Python) — keeps the HLO small
    return lax.fori_loop(0, iters, body, X0)


def schulz_universal_init(M):
    """Initial guess ``X0 = M^T / (||M||_1 ||M||_inf)`` for which the
    Newton–Schulz iteration provably converges for any nonsingular ``M``
    (``rho(I - M X0) < 1``). Pure arithmetic — no LAPACK anywhere."""
    MT = jnp.swapaxes(M, -1, -2)
    n1 = jnp.max(jnp.sum(jnp.abs(M), axis=-2), axis=-1)
    ninf = jnp.max(jnp.sum(jnp.abs(M), axis=-1), axis=-1)
    return MT / (n1 * ninf)[..., None, None]


def schulz_warm_iters(total_iters: int) -> int:
    """Warm-start iteration budget used by :func:`schulz_inverse_auto` when
    an ``X0`` is supplied: the total budget minus the ~40-iteration
    universal-init ramp, floored at 8. Exposed so external FLOP/latency
    models (bench.py) derive it from the library instead of duplicating the
    formula."""
    return max(total_iters - 40, 8)


def schulz_inverse_auto(M, iters: int = 56, dtype=jnp.float32, X0=None,
                        warm_iters: int | None = None, precision=None):
    """Approximate inverse of ``M`` by Newton–Schulz, computed in ``dtype``
    (f32 by default).

    ``iters`` is the TOTAL iteration budget from the universal init (which
    converges for any nonsingular ``M`` but needs ~``2 log2(cond(M))`` ramp
    iterations before the quadratic phase; the default 56 = 40 ramp + 16
    converging sweeps reaches f32 inverse accuracy for the well-conditioned
    Hermite stage matrices). ``X0`` warm-starts the iteration — e.g. the
    inverse of the drift-only stage matrix, a control-sized perturbation
    away — in which case only ``warm_iters`` (default ``max(iters-40, 8)``)
    iterations run. No hidden budget is added in either case.

    ``precision`` is forwarded to :func:`schulz_inverse` (see there for the
    reduced-precision construction + full-precision refinement
    rationale). When ``None`` it resolves to the import-time
    ``QGD_SCHULZ_PRECISION`` snapshot (default ``"default"``, i.e. TF32 on
    the GPU): every call site feeds the result through a full-precision
    refinement solve, so cheap construction is safe.

    On warm-start fallback the iteration count stays at the warm budget —
    adding iterations only-when-needed would require ``lax.cond``, which
    the scenario-vmapped production path lowers to ``select`` (both
    branches always execute, ~4x the matmul bill). Instead the fallback is
    made *observable*: solve quality is asserted by
    ``qgd_tpu.diagnostics.stage_residuals`` (state-aware probes), and the
    universal init's ramp is short for the well-conditioned stage
    matrices this library builds (~2 log2(cond) iterations).
    """
    if precision is None:
        precision = SCHULZ_PRECISION
    M32 = M.astype(dtype)
    if X0 is None:
        X0 = schulz_universal_init(M32)
    else:
        X0 = jnp.broadcast_to(X0.astype(dtype), M32.shape)
        # Convergence guard: Newton-Schulz DIVERGES (to inf/NaN) when
        # ||I - M X0|| >= 1, and a warm start from the drift-only inverse
        # can exceed that radius at coarse dt (large control perturbation,
        # e.g. Richardson sweeps / carrier sidebands with dt*w ~ O(1)).
        # Fall back per-matrix to the universal init — crude within the
        # warm budget but always convergent, and the refinement sweeps in
        # inverse_stage_solve recover what the budget allows: degrade
        # gracefully instead of NaN. One extra batched matmul (~3% of a
        # 16-iteration budget). Frobenius >= spectral norm, so the test
        # is conservative. The guard residual itself runs at full matmul
        # precision: it decides converge-vs-diverge, and at reduced
        # precision it would carry ~1e-3 relative error — enough to misclassify a borderline
        # warm start (one batched matmul, negligible vs the iteration
        # budget).
        eye = jnp.eye(M32.shape[-1], dtype=M32.dtype)
        R = eye - jnp.matmul(M32, X0, precision=jax.lax.Precision.HIGHEST)
        r = jnp.sqrt(jnp.sum(R * R, axis=(-2, -1), keepdims=True))
        X0 = jnp.where(r < 1.0, X0, schulz_universal_init(M32))
        iters = warm_iters if warm_iters is not None else \
            schulz_warm_iters(iters)
    return schulz_inverse(M32, X0, iters, precision=precision)


def inverse_stage_solve(M, Xinv, B, refine_iters: int | None = None):
    """Solve ``M X = B`` given an approximate inverse ``Xinv`` (typically
    f32 from :func:`schulz_inverse`), recovering the right-hand side's
    precision by iterative refinement with residuals in ``B.dtype``:
    ``x <- x + Xinv (b - M x)``, error contraction ``||I - Xinv M||`` per
    sweep. Matmul-only. Wrapped in ``custom_linear_solve`` so reverse-mode
    AD solves the transposed system with ``Xinv^T`` — the discrete
    adjoint's transposed-LHS solve.

    ``refine_iters`` defaults by target precision: the drift-only or a
    reduced-precision inverse has ``||I - Xinv M|| <~ 1e-2``, so
    ``REFINE_SWEEPS_F32`` (3) sweeps reach ~1e-8 and 4 reach f64. These
    sweeps run
    SERIALLY inside the propagation scan — the hot latency path — so the
    f64 budget must not be paid for f32 rhs."""
    bd = B.dtype
    if refine_iters is None:
        refine_iters = REFINE_SWEEPS_F32 if bd == jnp.float32 else 4

    def refine(rhs, trans):
        Mop = jnp.swapaxes(M, -1, -2) if trans else M
        Xop = jnp.swapaxes(Xinv, -1, -2) if trans else Xinv
        Xop = Xop.astype(bd)
        if bd == jnp.float32:
            # Preconditioner applications set only the contraction rate
            # (see PRECOND_PRECISION above); the residual matmul below
            # stays at the session precision and pins the fixed point.
            papply = lambda v: jnp.matmul(Xop, v,
                                          precision=PRECOND_PRECISION)
        else:
            papply = lambda v: Xop @ v
        x = papply(rhs)
        for _ in range(refine_iters):
            r = rhs - Mop @ x
            x = x + papply(r)
        return x

    return lax.custom_linear_solve(
        lambda v: M @ v, B,
        solve=lambda mv, rhs: refine(rhs, False),
        transpose_solve=lambda mv, rhs: refine(rhs, True),
    )


def direct_f32_solve(A, B):
    """Plain f32 LU solve, wrapped for exact AD transposes."""
    lu, piv = jsp_linalg.lu_factor(A)

    def solve(trans):
        return lambda mv, rhs: jsp_linalg.lu_solve((lu, piv), rhs,
                                                   trans=trans)

    return lax.custom_linear_solve(
        lambda v: A @ v, B, solve=solve(0), transpose_solve=solve(1))


def stage_solve(A, B):
    """Dtype-dispatched dense solve of the implicit stage.
    ``A (n, n)``, ``B (n, ...)``."""
    if A.dtype == jnp.float32:
        return direct_f32_solve(A, B)
    return jnp.linalg.solve(A, B)


def stage_solve_transposed(A, B):
    """Solve ``A^T X = B`` (terminal-condition / adjoint sweeps)."""
    AT = jnp.swapaxes(A, -1, -2)
    if A.dtype == jnp.float32:
        return direct_f32_solve(AT, B)
    return jnp.linalg.solve(AT, B)
