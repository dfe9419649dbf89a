"""Prefix-product propagation: log-depth Hermite evolution via
``lax.associative_scan`` over the per-step affine maps.

The serial floor of the scan propagators (forward.py, segmented.py) is
3T sequential stage solves of ~5 small matvecs each — at the flagship
operating point (CNOT3, nsteps=30720) that chain is long however cheaply
each stage inverse is built. But after hoisting, each Hermite step is a
*fixed linear map*::

    w_{n+1} = Xeff(t_{n+1}) R(t_n) w_n  =:  F_n w_n

where ``R`` is the explicit-side matrix and ``Xeff`` the refined stage
inverse (the same arithmetic inverse_stage_solve applies to vectors,
folded into a matrix: ``Xeff = (sum_i (I - X M)^i) X``). The whole
trajectory is then prefix products ``w_n = F_{n-1} ... F_0 w_0``,
computed by ``lax.associative_scan`` in O(log L) depth of batched
128x128 matmuls instead of 3L serial matvecs. The backward lambda
sweep is the same trick on *affine* maps::

    lam_k = B_k lam_{k+1} + g_k,   B_k = Xeff(t_k)^T R(t_k)^T,
                                   g_k = Xeff(t_k)^T f_k (guard forcing)

with the associative combine ``(A2,b2) o (A1,b1) = (A2 A1, A2 b1 + b2)``.

Segmentation bounds memory: segments of ``L`` steps are processed by an
outer ``lax.scan`` (serial in S = T/L, parallel within each segment), so
live tensors are O(L * (2N)^2) — the same O(sqrt T) trade as
segmented.py, but each segment body has ~log2(L) sequential matmul levels
instead of L sequential solves.

Numerics: the per-step map error is the refined stage residual
(``||I - Xeff M|| ~ q^(1+r)`` with q the drift-preconditioner contraction
O(dt*amp)); products of the near-orthogonal F maps are stable, so the
accumulated error matches the serial path's f32 drift — verified against
the segmented path in tests/test_prefix.py.

Gradient semantics are identical to segmented.py (same Lagrange
cotangents, same table VJPs, same terminal condition); reference parity:
discrete_adjoint, src/eval_grad_discrete_adjoint.jl:83-160.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .controls import as_control_tuple, control_tables, control_tables_at
from .problem import working_problem
from .objective import (
    with_host_target,
    _realify_target,
    terminal_cost_and_grad,
)
from .ops.hermite import (
    assemble_generator_stack,
    scaled_derivatives,
    build_lhs,
    hermite_coefficients,
)
from .ops.linalg import (
    REFINE_SWEEPS_F32,
    schulz_inverse_auto,
    inverse_stage_solve,
)
from .forward import (_time_grid, _stage_matrices, _stage_matrices_both,
                      _drift_stage_inverse, _warm_budget, vjp_chunk_size)
from .segmented import choose_segments, _make_seg_table_cot, _guard_quad


def _eff_inverses(wprob, M, X_drift=None, refine: int | None = None):
    """Batched *effective* stage inverses ``Xeff (T, n, n)`` — the matrix
    form of inverse_stage_solve's refinement: ``Xeff = (sum_{i<=r} E^i) X``
    with ``E = I - X M`` (Horner), where ``X`` is the warm-started
    Newton-Schulz inverse (f32) or the exact inverse (f64). ``Xeff^T`` is exactly the transposed-refinement
    operator, so one tensor serves forward and adjoint solves."""
    n = M.shape[-1]
    eye = jnp.eye(n, dtype=M.dtype)
    if M.dtype == jnp.float64:
        return jnp.linalg.inv(M)
    X = schulz_inverse_auto(M, wprob.schulz_iters, X0=X_drift,
                            warm_iters=_warm_budget(wprob))
    X = X.astype(M.dtype)
    r = REFINE_SWEEPS_F32 if refine is None else refine
    if r == 0:
        return X
    E = eye - jnp.matmul(X, M)
    S = eye + E
    for _ in range(r - 1):
        S = eye + jnp.matmul(E, S)
    return jnp.matmul(S, X)


def _prefix_states(F_seg, w_start):
    """In-segment history via matrix prefix products: ``F_seg (L, n, n)``,
    ``w_start (n, B)`` -> ``(L+1, n, B)`` (index 0 = w_start)."""
    P = lax.associative_scan(lambda a, b: jnp.matmul(b, a), F_seg)
    hist = jnp.concatenate([w_start[None], P @ w_start], axis=0)
    return hist


def _affine_prefix_lams(B_seg, g_seg, lam_b):
    """In-segment lambda sweep via affine prefix products.

    ``B_seg (L, n, n)``, ``g_seg (L, n, B)`` indexed by global step
    ``k = a..b-1``; ``lam_b (n, B)`` the lambda at the segment's right
    edge. Returns ``lam_seg (L+1, n, B)`` with ``lam_seg[i] = lam_{a+i}``.
    """

    def comb(x, y):
        A1, b1 = x
        A2, b2 = y
        return jnp.matmul(A2, A1), jnp.matmul(A2, b1) + b2

    # application order: k = b-1 first (adjacent to lam_b)
    A, bb = lax.associative_scan(comb, (B_seg[::-1], g_seg[::-1]))
    lams = A @ lam_b + bb              # lams[i] = lam_{b-1-i}
    return jnp.concatenate([lams[::-1], lam_b[None]], axis=0)


def _segment_maps(wprob, m, dt, pl_, ql_, pr_, qr_, X_drift,
                  need_left: bool):
    """Per-segment stage tensors.

    Returns ``(F_seg, R_left, Xeff_left)`` where ``F_seg (L, n, n)`` are
    the forward step maps ``Xeff(t_right) R(t_left)``; ``R_left`` and
    ``Xeff_left`` (both at the L left endpoints) are ``None`` unless
    ``need_left`` (the backward sweep needs them for the affine maps).
    """
    if need_left:
        R_left, M_left = _stage_matrices_both(wprob, m, dt, pl_, ql_)
        Xeff_left = _eff_inverses(wprob, M_left, X_drift)
    else:
        R_left = _stage_matrices(wprob, m, dt, pl_, ql_, 1.0)
        Xeff_left = None
    M_right = _stage_matrices(wprob, m, dt, pr_, qr_, -1.0)
    Xeff_right = _eff_inverses(wprob, M_right, X_drift)
    F_seg = jnp.matmul(Xeff_right, R_left)
    return F_seg, R_left, Xeff_left


@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "cost_type",
                                   "ridge_penalty_strength", "n_segments",
                                   "ic_axis"))
def prefix_objective_and_gradient(prob, controls, pcof, target,
                                  order: int = 4,
                                  cost_type: str = "Infidelity",
                                  ridge_penalty_strength: float = 0.0,
                                  n_segments: int = 0,
                                  ic_axis: str | None = None):
    """Objective + Lagrange gradient with log-depth in-segment propagation.

    Same ``((j1, guard, ridge), grad)`` semantics as
    ``segmented.segmented_objective_and_gradient`` — different
    latency/FLOP trade: every in-segment serial chain is replaced by
    associative-scan prefix products (O(log L) matmul levels), at the cost
    of matrix-matrix instead of matrix-vector work (a factor ~n/B more
    FLOPs, paid in batched matmuls in exchange for the serial floor).

    ``n_segments=0`` -> segment length near ``sqrt(T)`` scaled for the
    prefix trade (min 256).
    """
    controls = as_control_tuple(controls)
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    target_real = _realify_target(prob, target)

    T = prob.nsteps
    if n_segments > 0:
        S = n_segments
    else:
        S = choose_segments(T, target_len=max(256, int(T ** 0.5)))
    if T % S:
        raise ValueError(f"n_segments={S} must divide nsteps={T}")
    L = T // S
    m = order // 2

    dt64, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    wprob = working_problem(prob)
    Pw, Qw, dt = P.astype(wd), Q.astype(wd), dt64.astype(wd)
    X_drift = (_drift_stage_inverse(wprob, m, dt)
               if wd == jnp.float32 else None)

    tau = jnp.ones(T + 1, dtype=jnp.float64).at[0].set(0.5).at[-1].set(0.5)

    def seg_tables(arr):
        return (arr[:-1].reshape(S, L, *arr.shape[1:]),
                arr[1:].reshape(S, L, *arr.shape[1:]))

    Pl, Pr = seg_tables(Pw)
    Ql, Qr = seg_tables(Qw)
    tau_seg = tau[:-1].reshape(S, L)

    # ---------------- forward: snapshots + guard accumulation -------------
    def fwd_body(carry, xs):
        w, guard_acc = carry
        pl_, ql_, pr_, qr_, tau_k = xs
        F_seg, _, _ = _segment_maps(wprob, m, dt, pl_, ql_, pr_, qr_,
                                    X_drift, need_left=False)
        hist = _prefix_states(F_seg, w)
        guard_acc = guard_acc + _guard_quad(prob, hist[:-1], tau_k)
        return (hist[-1], guard_acc), w

    w0 = wprob.w0
    (w_final, guard_sum), snapshots = lax.scan(
        fwd_body, (w0, jnp.zeros((), dtype=jnp.float64)),
        (Pl, Ql, Pr, Qr, tau_seg))

    guard_sum = guard_sum + tau[-1] * _guard_quad(
        prob, w_final[None].astype(jnp.float64),
        jnp.ones((1,), dtype=jnp.float64))
    guard = guard_sum * dt64 / prob.tf
    if ic_axis is not None:
        guard = jax.lax.psum(guard, ic_axis)

    w_final64 = w_final.astype(jnp.float64)
    j1, dj1 = terminal_cost_and_grad(w_final64, target_real,
                                     prob.N_ess_levels, cost_type, ic_axis)
    ridge = ridge_penalty_strength * jnp.vdot(pcof, pcof) / pcof.shape[0]

    # ---------------- terminal condition (as segmented.py) ----------------
    guard_scale = 2.0 * dt64 / prob.tf
    W = prob.guard_subspace_projector
    f_T = (guard_scale * tau[-1]) * (W @ w_final64)
    g_T = dj1 + f_T
    p_f, q_f = control_tables_at(controls, pcof, prob.tf, m)
    A_f = assemble_generator_stack(wprob, p_f.astype(wd), q_f.astype(wd), m)
    eye = jnp.eye(prob.real_system_size, dtype=wd)
    D_f = scaled_derivatives(A_f, eye, m)
    lhs_f = build_lhs(D_f, dt, m)
    MT = lhs_f.T
    if wd == jnp.float32 or prob.solver == "schulz":
        lam_T = inverse_stage_solve(
            MT, schulz_inverse_auto(MT, prob.schulz_iters), g_T.astype(wd))
    else:
        from .ops.linalg import stage_solve

        lam_T = stage_solve(MT, g_T.astype(wd))

    # ---------------- cotangent weights -----------------------------------
    c = jnp.asarray(hermite_coefficients(m), dtype=jnp.float64)
    jpow = jnp.arange(m + 1, dtype=jnp.float64)
    w_rhs = (c * dt64 ** jpow).astype(wd)
    w_lhs = (c * (-dt64) ** jpow).astype(wd)

    table_cot, _ = _make_seg_table_cot(wprob, m, L)

    # ---------------- backward over segments ------------------------------
    # The segment scan emits the in-segment lambda and state arrays
    # ((L, n, B) each — (T, n, B) total, ~126 MB f32 at the flagship
    # point) instead of doing the control-table cotangent VJPs in-body:
    # those VJPs would serialize per segment, and they are time-pointwise,
    # so ONE globally-chunked pass after the scan does the identical
    # arithmetic at a fraction of the dispatch count.
    def bwd_body(lam_b, xs):
        snap, pl_, ql_, pr_, qr_, tau_k, k_rev = xs
        F_seg, R_left, Xeff_left = _segment_maps(
            wprob, m, dt, pl_, ql_, pr_, qr_, X_drift, need_left=True)
        hist = _prefix_states(F_seg, snap)          # re-forward (L+1, n, B)

        f_seg = (guard_scale * tau_k)[:, None, None] * jnp.einsum(
            "ab,tbj->taj", W, hist[:-1].astype(jnp.float64))
        f_seg = f_seg.astype(wd)

        XT = jnp.swapaxes(Xeff_left, -1, -2)
        B_seg = jnp.matmul(XT, jnp.swapaxes(R_left, -1, -2))
        g_seg = XT @ f_seg
        lam_seg = _affine_prefix_lams(B_seg, g_seg, lam_b)

        first_scale = jnp.where(k_rev == S - 1, 0.0, 1.0)
        lam_seg = lam_seg.at[0].multiply(first_scale.astype(wd))
        return lam_seg[0], (lam_seg[:-1], hist[:-1])

    rev = lambda a: a[::-1]
    k_rev_idx = jnp.arange(S)
    lam0, (lam_rev, hist_rev) = lax.scan(
        bwd_body, lam_T,
        (rev(snapshots), rev(Pl), rev(Ql), rev(Pr), rev(Qr),
         rev(tau_seg), k_rev_idx))

    n2 = prob.real_system_size
    Bc = lam_T.shape[-1]
    lam_all = jnp.concatenate(
        [lam_rev[::-1].reshape(T, n2, Bc), lam_T[None]], axis=0)  # (T+1,n,B)
    hist_all = hist_rev[::-1].reshape(T, n2, Bc)                  # (T, n, B)

    # merged cotangents for indices 0..T-1 (cot_T handled separately)
    cot = (w_rhs[None, :, None, None] * lam_all[1:, None]
           - w_lhs[None, :, None, None] * lam_all[:-1, None])

    # one chunked pass over ALL time points: the per-point VJP residuals
    # ((m, 2N, 2N) assembly stacks) bound the chunk size in device memory
    chunk = vjp_chunk_size(wprob, m)
    if T <= chunk:
        cotP_all, cotQ_all = jax.vmap(table_cot)(Pw[:-1], Qw[:-1],
                                                 hist_all, cot)
    else:
        cotP_all, cotQ_all = jax.lax.map(
            lambda a: table_cot(*a), (Pw[:-1], Qw[:-1], hist_all, cot),
            batch_size=chunk)

    cot_T = -w_lhs[:, None, None] * lam_T[None]
    cotPT, cotQT = table_cot(p_f.astype(wd), q_f.astype(wd), w_final, cot_T)

    cotP = jnp.concatenate([cotP_all, cotPT[None]], axis=0)
    cotQ = jnp.concatenate([cotQ_all, cotQT[None]], axis=0)
    _, vjp_tables = jax.vjp(
        lambda pc: control_tables(controls, pc, ts, m), pcof)
    (grad,) = vjp_tables((cotP.astype(jnp.float64),
                          cotQ.astype(jnp.float64)))

    if ic_axis is not None:
        grad = jax.lax.psum(grad, ic_axis)
    grad = grad + 2.0 * ridge_penalty_strength * pcof / pcof.shape[0]
    return (j1, guard, ridge), grad


@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "cost_type",
                                   "ridge_penalty_strength", "n_segments"))
def prefix_objective_value(prob, controls, pcof, target, order: int = 4,
                           cost_type: str = "Infidelity",
                           ridge_penalty_strength: float = 0.0,
                           n_segments: int = 0):
    """VALUE-ONLY objective via prefix-product propagation — the
    line-search probe evaluation for latency-bound on-device optimization
    (optimize_gate_multistart route="prefix")."""
    from .objective import terminal_cost

    controls = as_control_tuple(controls)
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    target_real = _realify_target(prob, target)

    T = prob.nsteps
    if n_segments > 0:
        S = n_segments
    else:
        S = choose_segments(T, target_len=max(256, int(T ** 0.5)))
    if T % S:
        raise ValueError(f"n_segments={S} must divide nsteps={T}")
    L = T // S
    m = order // 2
    dt64, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    wprob = working_problem(prob)
    Pw, Qw, dt = P.astype(wd), Q.astype(wd), dt64.astype(wd)
    X_drift = (_drift_stage_inverse(wprob, m, dt)
               if wd == jnp.float32 else None)

    tau = jnp.ones(T + 1, dtype=jnp.float64).at[0].set(0.5).at[-1].set(0.5)

    def seg_tables(arr):
        return (arr[:-1].reshape(S, L, *arr.shape[1:]),
                arr[1:].reshape(S, L, *arr.shape[1:]))

    Pl, Pr = seg_tables(Pw)
    Ql, Qr = seg_tables(Qw)
    tau_seg = tau[:-1].reshape(S, L)

    def fwd_body(carry, xs):
        w, guard_acc = carry
        pl_, ql_, pr_, qr_, tau_k = xs
        F_seg, _, _ = _segment_maps(wprob, m, dt, pl_, ql_, pr_, qr_,
                                    X_drift, need_left=False)
        hist = _prefix_states(F_seg, w)
        guard_acc = guard_acc + _guard_quad(prob, hist[:-1], tau_k)
        return (hist[-1], guard_acc), None

    w0 = wprob.w0
    (w_final, guard_sum), _ = lax.scan(
        fwd_body, (w0, jnp.zeros((), dtype=jnp.float64)),
        (Pl, Ql, Pr, Qr, tau_seg))
    guard_sum = guard_sum + tau[-1] * _guard_quad(
        prob, w_final[None].astype(jnp.float64),
        jnp.ones((1,), dtype=jnp.float64))
    guard = guard_sum * dt64 / prob.tf
    j1 = terminal_cost(w_final.astype(jnp.float64), target_real,
                       prob.N_ess_levels, cost_type)
    ridge = ridge_penalty_strength * jnp.vdot(pcof, pcof) / pcof.shape[0]
    return j1 + guard + ridge


@partial(jax.jit, static_argnames=("order", "n_segments"))
def eval_forward_prefix(prob, controls, pcof, order: int = 4,
                        n_segments: int = 0):
    """Forward history ``(T+1, 2N, B)`` by prefix products — the
    propagation-only entry (tests / latency probes)."""
    controls = as_control_tuple(controls)
    T = prob.nsteps
    if n_segments > 0:
        S = n_segments
    else:
        S = choose_segments(T, target_len=max(256, int(T ** 0.5)))
    if T % S:
        raise ValueError(f"n_segments={S} must divide nsteps={T}")
    L = T // S
    m = order // 2
    dt64, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    wprob = working_problem(prob)
    Pw, Qw, dt = P.astype(wd), Q.astype(wd), dt64.astype(wd)
    X_drift = (_drift_stage_inverse(wprob, m, dt)
               if wd == jnp.float32 else None)

    def seg_tables(arr):
        return (arr[:-1].reshape(S, L, *arr.shape[1:]),
                arr[1:].reshape(S, L, *arr.shape[1:]))

    Pl, Pr = seg_tables(Pw)
    Ql, Qr = seg_tables(Qw)

    def body(w, xs):
        pl_, ql_, pr_, qr_ = xs
        F_seg, _, _ = _segment_maps(wprob, m, dt, pl_, ql_, pr_, qr_,
                                    X_drift, need_left=False)
        hist = _prefix_states(F_seg, w)
        return hist[-1], hist[1:]

    w0 = wprob.w0
    _, traj = lax.scan(body, w0, (Pl, Ql, Pr, Qr))
    return jnp.concatenate([w0[None], traj.reshape(T, *w0.shape)], axis=0)
