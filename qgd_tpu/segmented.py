"""Memory-scalable objective + discrete-adjoint gradient for long horizons.

The plain Lagrange adjoint (qgd_tpu/adjoint.py) materializes the full state
history ``(T+1, 2N, B)``, the lambda history, and the merged cotangent tensor
``(T+1, m+1, 2N, B)`` — exactly like the reference, which holds both full
histories in RAM (src/eval_grad_discrete_adjoint.jl:94-96). At the
reference's long-horizon operating points (dt=1e-4 sweeps -> nsteps ~ 1e5,
examples/cnot3_optimize_gate.sb:30-33) those O(T) tensors exceed a
device's memory.

This module trades FLOPs for memory with two-level (sqrt-T) checkpointing:

* **Forward pass**: a nested scan over ``S`` segments of ``L = T/S`` steps.
  Only the ``S+1`` segment-boundary states are stored; the guard penalty is
  accumulated on the fly (in f64), so the full history is never
  materialized.
* **Backward pass**: a scan over segments in reverse. Each segment
  re-forwards its ``L`` states from the stored snapshot (bit-identical to
  the first pass — determinism the threaded Julia reference cannot
  guarantee), runs the backward lambda sweep within the segment, forms the
  per-step merged cotangents, and accumulates the gradient contribution;
  all per-segment tensors are freed before the next segment.

Peak memory is O(S + L) = O(sqrt(T)) state tensors plus the per-segment
hoisted stage matrices ``(L, 2N, 2N)``, vs O(T) for the plain path. The
extra cost is one additional forward propagation (the re-forward), the same
trade as binomial checkpointing at its first level.

The arithmetic within a segment is identical to the plain Lagrange path
(same solves, same cotangent structure), so gradients agree with
``discrete_adjoint`` to summation-reordering roundoff (~1e-15 relative) and
meet the reference's 1e-14 adjoint-vs-forced gate
(test/GradientTests/compare_gradients.jl:47-48); see
tests/test_segmented.py.
"""

from __future__ import annotations

from functools import partial

import os

import jax
import jax.numpy as jnp

from .controls import as_control_tuple, control_tables, control_tables_at
from .problem import working_problem
from .objective import (
    with_host_target,
    _realify_target,
    terminal_cost,
    terminal_cost_and_grad,
)
from .ops.hermite import (
    assemble_generator_stack,
    scaled_derivatives,
    build_rhs,
    build_lhs,
    hermite_coefficients,
)
from .ops.linalg import (
    factorize_stages,
    solve_factored,
    schulz_inverse_auto,
    inverse_stage_solve,
)
from .forward import (_time_grid, _stage_matrices, _stage_matrices_both,
                      _make_preconditioner, vjp_chunk_size)


def choose_segments(nsteps: int, target_len: int = 0) -> int:
    """Pick a segment count ``S`` dividing ``nsteps`` with segment length
    near ``sqrt(nsteps)`` (or near ``target_len`` if given) — the O(sqrt T)
    memory sweet spot."""
    import math

    want_len = target_len if target_len > 0 else int(math.sqrt(nsteps))
    want_S = max(nsteps // max(want_len, 1), 1)
    best, best_cost = 1, float("inf")
    for S in range(1, nsteps + 1):
        if nsteps % S:
            continue
        cost = abs(S - want_S)
        if cost < best_cost:
            best, best_cost = S, cost
    return best


# Unroll factor for the segment scans (forward pass + backward pass).
# Default 1; kept as a knob for other shapes. Resolved at import.
_SEG_SCAN_UNROLL = int(os.environ.get("QGD_SEG_SCAN_UNROLL", "1"))


def _segment_mode(prob) -> str | None:
    """Per-segment stage hoisting mode. Segment lengths are O(sqrt T), so
    the hoisted ``(L, 2N, 2N)`` tensors are always affordable — no memory
    cap needed (that is the point of segmentation)."""
    return {"schulz": "schulz", "lu": "full"}.get(prob.solver)


def _forward_segment_scan(prob, m, dt, P_seg_l, Q_seg_l, P_seg_r, Q_seg_r,
                          w_start, mode, precond=None, schulz_X0=None):
    """Propagate one segment of ``L`` steps from ``w_start``; returns the
    in-segment history ``(L+1, 2N, B)`` (index 0 = ``w_start``).

    ``P_seg_l/Q_seg_l``: control tables at the L step left endpoints;
    ``P_seg_r/Q_seg_r``: at the L right endpoints. ``schulz_X0``
    optionally warm-starts the batched stage inverses (the drift-only
    inverse, hoisted once by the caller — ~3.5x fewer Newton-Schulz
    matmuls than the per-segment universal-init ramp).
    """
    if mode in ("schulz", "full"):
        lhs_mats = _stage_matrices(prob, m, dt, P_seg_r, Q_seg_r, -1.0)
        if mode == "schulz":
            from .forward import _warm_budget

            Xs = schulz_inverse_auto(lhs_mats, prob.schulz_iters,
                                     X0=schulz_X0,
                                     warm_iters=_warm_budget(prob))

            def solve(M, X, rhs):
                return inverse_stage_solve(M, X, rhs)

            solve_xs = (lhs_mats, Xs)
        else:
            lu, piv = factorize_stages(lhs_mats)

            def solve(M, lupiv, rhs):
                return solve_factored(M, lupiv[0], lupiv[1], rhs)

            solve_xs = (lhs_mats, (lu, piv))

        def step(w, xs):
            pq_n, M, aux = xs
            A_n = assemble_generator_stack(prob, pq_n[0], pq_n[1], m)
            Ws = scaled_derivatives(A_n, w, m)
            rhs = build_rhs(Ws, dt, m)
            w_next = solve(M, aux, rhs)
            return w_next, w_next

        xs = ((P_seg_l, Q_seg_l),) + (solve_xs[0], solve_xs[1])
    else:
        from .forward import _hermite_step, _drift_stage_inverse

        schulz_X0 = (_drift_stage_inverse(prob, m, dt)
                     if prob.solver == "schulz" else None)

        def step(w, xs):
            pq_n, pq_np1 = xs
            w_next, _ = _hermite_step(prob, m, dt, w, pq_n, pq_np1,
                                      None, None, precond=precond,
                                      schulz_X0=schulz_X0)
            return w_next, w_next

        xs = ((P_seg_l, Q_seg_l), (P_seg_r, Q_seg_r))

    _, traj = jax.lax.scan(step, w_start, xs)
    return jnp.concatenate([w_start[None], traj], axis=0)


def _make_seg_table_cot(wprob, m: int, L: int):
    """Build the (table_cot, seg_table_cot) pair shared by the segmented and
    chunked backward drivers.

    ``table_cot(p_t, q_t, w_k, cot_k)``: VJP of the per-time-point scaled
    derivative stack w.r.t. the control-table values (the per-step cotangent
    stops at the table boundary; the pcof chain rule happens once, at the
    end, through the vectorized grid table build).
    ``seg_table_cot``: the same mapped over a segment's ``L`` time points
    (vmap when they fit ``vjp_chunk_size``, chunked ``lax.map`` otherwise).
    """
    wd = wprob.work_dtype

    def stack_from_tables(p_t, q_t, w):
        A = assemble_generator_stack(wprob, p_t, q_t, m)
        return scaled_derivatives(A, w.astype(wd), m)

    def table_cot(p_t, q_t, w_k, cot_k):
        _, vjp = jax.vjp(lambda p, q: stack_from_tables(p, q, w_k),
                         p_t, q_t)
        return vjp(cot_k.astype(wd))     # (dP_t, dQ_t)

    chunk = vjp_chunk_size(wprob, m)

    def seg_table_cot(pl_, ql_, hist_k, cot_k):
        if L <= chunk:
            return jax.vmap(table_cot)(pl_, ql_, hist_k, cot_k)
        return jax.lax.map(lambda a: table_cot(*a),
                           (pl_, ql_, hist_k, cot_k), batch_size=chunk)

    return table_cot, seg_table_cot


def _segment_bwd_body(wprob, m, dt, mode, precond, schulz_X0, schulz_X0T,
                      schulz_iters, guard_scale, W, w_rhs, w_lhs,
                      seg_table_cot, lam_b, snap, pl_, ql_, pr_, qr_,
                      tau_k, first_scale, snap_next=None):
    """One segment of the backward pass — the body shared by
    ``segmented_objective_and_gradient`` and ``chunked._bwd_chunk``
    (per segment k spanning global steps a=kL .. b=kL+L):

      1. re-forward the L states from ``snap``                (hist: a..b)
      2. lambda sweep n = b-1 .. a:
           lam_n = LHS_n^{-T} (RHS_n^T lam_{n+1} + f_n),  f_n = guard forcing
         (reference backward sweep, src/forward_evolution.jl:421-483, with
          the guard source of src/eval_grad_discrete_adjoint.jl:732-752)
      3. merged cotangents for indices a..b-1:
           cot_i = w_rhs lam_{i+1} - w_lhs lam_i   (lam_0 := 0)
      4. the segment's control-table cotangents via ``seg_table_cot``

    ``first_scale``: 0.0 at the globally-first segment (drops the
    ``lambda_0`` multiplier — the initial state is fixed), 1.0 elsewhere.
    Returns ``(lam at the segment's left edge, (cotP_seg, cotQ_seg))``.

    ``snap_next``: at L=1 (``n_segments=nsteps``) the stored boundary states ARE the full trajectory, so step 1's
    re-forward — a full extra propagation with stage solves — is
    redundant; the caller passes the next boundary state and ``hist`` is
    assembled directly (bit-identical: both states come from the same
    forward pass).
    """
    wd = wprob.work_dtype
    if snap_next is not None:
        hist = jnp.stack([snap, snap_next], axis=0)        # L=1: (2, 2N, B)
    else:
        hist = _forward_segment_scan(wprob, m, dt, pl_, ql_, pr_, qr_,
                                     snap, mode, precond=precond,
                                     schulz_X0=schulz_X0)  # (L+1, 2N, B)

    # guard forcing at indices a..b-1 (f64 weights, work-dtype result)
    f_seg = (guard_scale * tau_k)[:, None, None] * jnp.einsum(
        "ab,tbj->taj", W, hist[:-1].astype(jnp.float64))
    f_seg = f_seg.astype(wd)

    # stage matrices at the L left endpoints (times a..b-1)
    rhs_mats, lhs_mats = _stage_matrices_both(wprob, m, dt, pl_, ql_)
    lhs_T = jnp.swapaxes(lhs_mats, -1, -2)
    if mode == "schulz":
        from .forward import _warm_budget

        XT = schulz_inverse_auto(lhs_T, schulz_iters, X0=schulz_X0T,
                                 warm_iters=_warm_budget(wprob))

        def lam_step(lam, xs_):
            R, MT, X, f_n = xs_
            mu = jnp.swapaxes(R, -1, -2) @ lam + f_n
            lam_prev = inverse_stage_solve(MT, X, mu)
            return lam_prev, lam_prev

        lam_xs = (rhs_mats[::-1], lhs_T[::-1], XT[::-1], f_seg[::-1])
    else:
        lu, piv = factorize_stages(lhs_T)

        def lam_step(lam, xs_):
            R, MT, lu_n, piv_n, f_n = xs_
            mu = jnp.swapaxes(R, -1, -2) @ lam + f_n
            lam_prev = solve_factored(MT, lu_n, piv_n, mu)
            return lam_prev, lam_prev

        lam_xs = (rhs_mats[::-1], lhs_T[::-1], lu[::-1], piv[::-1],
                  f_seg[::-1])

    lam_a, lams_rev = jax.lax.scan(lam_step, lam_b, lam_xs)
    lam_seg = jnp.concatenate([lams_rev[::-1], lam_b[None]], axis=0)
    # lam_seg[i] = lam_{a+i} for i = 0..L
    lam_seg = lam_seg.at[0].multiply(jnp.asarray(first_scale).astype(wd))

    cot = (w_rhs[None, :, None, None] * lam_seg[1:, None]
           - w_lhs[None, :, None, None] * lam_seg[:-1, None])
    cotP_seg, cotQ_seg = seg_table_cot(pl_, ql_, hist[:-1], cot)
    return lam_seg[0], (cotP_seg, cotQ_seg)


def _guard_quad(prob, hist_seg, tau_seg):
    """f64 partial guard-penalty sum over one segment's states (indices
    weighted by the global trapezoid weights ``tau_seg``)."""
    W = prob.guard_subspace_projector
    h = hist_seg.astype(jnp.float64)
    Wh = jnp.einsum("ab,tbj->taj", W, h)
    per_t = jnp.einsum("taj,taj->t", h, Wh)
    return jnp.sum(tau_seg * per_t)


@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "cost_type",
                                  "ridge_penalty_strength", "n_segments",
                                  "ic_axis"))
def segmented_objective_and_gradient(prob, controls, pcof, target,
                                     order: int = 4,
                                     cost_type: str = "Infidelity",
                                     ridge_penalty_strength: float = 0.0,
                                     n_segments: int = 0,
                                     ic_axis: str | None = None):
    """O(sqrt T)-memory equivalent of ``adjoint.objective_and_gradient``.

    Returns ``((j1, guard, ridge), grad)``; identical semantics to the plain
    path, different memory/recompute trade. ``n_segments=0`` -> auto
    (segment length near sqrt(nsteps)).

    ``ic_axis``: psum the cross-column reductions over that mesh axis when
    called inside ``shard_map`` with gate-basis columns sharded (see
    ``adjoint.objective_and_gradient``) — the long-horizon multi-chip
    gradient, still with no reverse-mode AD of any scan.
    """
    controls = as_control_tuple(controls)
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    target_real = _realify_target(prob, target)

    T = prob.nsteps
    S = n_segments if n_segments > 0 else choose_segments(T)
    if T % S:
        raise ValueError(f"n_segments={S} must divide nsteps={T}")
    L = T // S
    m = order // 2

    dt64, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    wprob = working_problem(prob)
    Pw, Qw, dt = P.astype(wd), Q.astype(wd), dt64.astype(wd)
    mode = _segment_mode(wprob)
    precond = _make_preconditioner(wprob, dt, order)
    # drift-only stage inverse, hoisted once: warm start for every
    # segment's batched Newton-Schulz stage inverses (fwd and lambda sweep)
    if mode == "schulz":
        from .forward import _drift_stage_inverse

        schulz_X0 = _drift_stage_inverse(wprob, m, dt)
        schulz_X0T = _drift_stage_inverse(wprob, m, dt, transpose=True)
    else:
        schulz_X0 = schulz_X0T = None

    # trapezoid weights on the global grid
    tau = jnp.ones(T + 1, dtype=jnp.float64).at[0].set(0.5).at[-1].set(0.5)

    # per-segment control-table slices: left endpoints of the L steps of
    # segment k are global indices kL..kL+L-1, right endpoints kL+1..kL+L
    def seg_tables(arr):
        return (arr[:-1].reshape(S, L, *arr.shape[1:]),
                arr[1:].reshape(S, L, *arr.shape[1:]))

    Pl, Pr = seg_tables(Pw)
    Ql, Qr = seg_tables(Qw)
    tau_seg = tau[:-1].reshape(S, L)          # weights for indices kL..kL+L-1

    # ---------------- forward pass: snapshots + guard accumulation --------
    w_final, guard, snapshots = _forward_objective_pass(
        prob, wprob, m, dt, dt64, tau, Pl, Ql, Pr, Qr, tau_seg, mode,
        precond, schulz_X0, ic_axis)

    w_final64 = w_final.astype(jnp.float64)
    j1, dj1 = terminal_cost_and_grad(w_final64, target_real,
                                     prob.N_ess_levels, cost_type, ic_axis)
    ridge = ridge_penalty_strength * jnp.vdot(pcof, pcof) / pcof.shape[0]

    # ---------------- terminal condition ---------------------------------
    guard_scale = 2.0 * dt64 / prob.tf
    W = prob.guard_subspace_projector
    f_T = (guard_scale * tau[-1]) * (W @ w_final64)
    g_T = dj1 + f_T
    p_f, q_f = control_tables_at(controls, pcof, prob.tf, m)
    A_f = assemble_generator_stack(wprob, p_f.astype(wd), q_f.astype(wd), m)
    eye = jnp.eye(prob.real_system_size, dtype=wd)
    D_f = scaled_derivatives(A_f, eye, m)
    lhs_f = build_lhs(D_f, dt, m)
    if prob.solver == "schulz":
        MT = lhs_f.T
        lam_T = inverse_stage_solve(
            MT, schulz_inverse_auto(MT, prob.schulz_iters), g_T.astype(wd))
    else:
        from .ops.linalg import stage_solve_transposed

        lam_T = stage_solve_transposed(lhs_f, g_T.astype(wd))

    # ---------------- cotangent weights ----------------------------------
    c = jnp.asarray(hermite_coefficients(m), dtype=jnp.float64)
    jpow = jnp.arange(m + 1, dtype=jnp.float64)
    w_rhs = (c * dt64 ** jpow).astype(wd)      # RHS weights  dt^j c_j
    w_lhs = (c * (-dt64) ** jpow).astype(wd)   # LHS weights  (-dt)^j c_j

    # Per-step VJPs stop at the control-table values (dense transposes);
    # the pcof chain rule is ONE reverse pass through the vectorized grid
    # table build at the very end — see adjoint._discrete_adjoint_lagrange
    # for the rationale (the per-point table rebuild dominated carrier-
    # control gradient latency). The per-segment table cotangents are tiny
    # ((L, m+1, N_ops)), so emitting them keeps the O(sqrt T) state memory.
    table_cot, seg_table_cot = _make_seg_table_cot(wprob, m, L)

    # ---------------- backward pass over segments ------------------------
    # Body shared with the chunked driver: _segment_bwd_body (re-forward,
    # lambda sweep, merged cotangents, per-segment table VJP).
    # At L=1 the boundary states are the full trajectory: hand each
    # segment its RIGHT state too and skip the redundant re-forward (one
    # whole propagation's worth of stage solves) — see _segment_bwd_body.
    if L == 1:
        snap_next = jnp.concatenate([snapshots[1:], w_final[None]], axis=0)
    else:
        snap_next = None

    def bwd_body(lam_b, xs):
        snap, snap_nx, pl_, ql_, pr_, qr_, tau_k, k_rev = xs
        # lam_0 := 0 (no multiplier for the fixed initial state) — drop it
        # on the globally-first segment
        first_scale = jnp.where(k_rev == S - 1, 0.0, 1.0)
        return _segment_bwd_body(
            wprob, m, dt, mode, precond, schulz_X0, schulz_X0T,
            prob.schulz_iters, guard_scale, W, w_rhs, w_lhs, seg_table_cot,
            lam_b, snap, pl_, ql_, pr_, qr_, tau_k, first_scale,
            snap_next=(snap_nx if L == 1 else None))

    rev = lambda a: a[::-1]
    k_rev_idx = jnp.arange(S)          # position in the REVERSED scan
    snap_nx_rev = (rev(snap_next) if snap_next is not None
                   else jnp.zeros((S, 0, 0), dtype=snapshots.dtype))
    lam0, (cotP_rev, cotQ_rev) = jax.lax.scan(
        bwd_body, lam_T,
        (rev(snapshots), snap_nx_rev, rev(Pl), rev(Ql), rev(Pr), rev(Qr),
         rev(tau_seg), k_rev_idx), unroll=_SEG_SCAN_UNROLL)

    # terminal index T: only the LHS term survives (no step starts at T)
    cot_T = -w_lhs[:, None, None] * lam_T[None]
    cotPT, cotQT = table_cot(p_f.astype(wd), q_f.astype(wd), w_final, cot_T)

    cotP = jnp.concatenate(
        [cotP_rev[::-1].reshape(T, *cotPT.shape), cotPT[None]], axis=0)
    cotQ = jnp.concatenate(
        [cotQ_rev[::-1].reshape(T, *cotQT.shape), cotQT[None]], axis=0)
    _, vjp_tables = jax.vjp(
        lambda pc: control_tables(controls, pc, ts, m), pcof)
    (grad,) = vjp_tables((cotP.astype(jnp.float64),
                          cotQ.astype(jnp.float64)))

    if ic_axis is not None:
        grad = jax.lax.psum(grad, ic_axis)
    grad = grad + 2.0 * ridge_penalty_strength * pcof / pcof.shape[0]
    return (j1, guard, ridge), grad


def segmented_gradient(prob, controls, pcof, target, order: int = 4,
                       cost_type: str = "Infidelity", n_segments: int = 0):
    """Gradient-only wrapper (the reference's ``discrete_adjoint`` shape)."""
    (_, _, _), grad = segmented_objective_and_gradient(
        prob, controls, pcof, target, order, cost_type=cost_type,
        n_segments=n_segments)
    return grad

def _forward_objective_pass(prob, wprob, m, dt, dt64, tau, Pl, Ql, Pr, Qr,
                            tau_seg, mode, precond, schulz_X0, ic_axis):
    """Segment-scan forward pass shared by the objective+gradient and the
    value-only entries: returns ``(w_final, guard, snapshots)``."""

    def fwd_body(carry, xs):
        w, guard_acc = carry
        pl_, ql_, pr_, qr_, tau_k = xs
        hist = _forward_segment_scan(wprob, m, dt, pl_, ql_, pr_, qr_,
                                     w, mode, precond=precond,
                                     schulz_X0=schulz_X0)
        guard_acc = guard_acc + _guard_quad(prob, hist[:-1], tau_k)
        return (hist[-1], guard_acc), w       # emit segment-start snapshot

    w0 = wprob.w0
    (w_final, guard_sum), snapshots = jax.lax.scan(
        fwd_body, (w0, jnp.zeros((), dtype=jnp.float64)),
        (Pl, Ql, Pr, Qr, tau_seg), unroll=_SEG_SCAN_UNROLL)

    guard_sum = guard_sum + tau[-1] * _guard_quad(
        prob, w_final[None].astype(jnp.float64),
        jnp.ones((1,), dtype=jnp.float64))
    guard = guard_sum * dt64 / prob.tf
    if ic_axis is not None:
        guard = jax.lax.psum(guard, ic_axis)
    return w_final, guard, snapshots


@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "cost_type",
                                  "ridge_penalty_strength", "n_segments"))
def segmented_objective_value(prob, controls, pcof, target, order: int = 4,
                              cost_type: str = "Infidelity",
                              ridge_penalty_strength: float = 0.0,
                              n_segments: int = 0):
    """VALUE-ONLY segmented objective (one forward pass, O(sqrt T) memory,
    no adjoint work) — the line-search probe evaluation for long-horizon
    on-device optimization (optimize_gate_multistart route="segmented")."""
    controls = as_control_tuple(controls)
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    target_real = _realify_target(prob, target)

    T = prob.nsteps
    S = n_segments if n_segments > 0 else choose_segments(T)
    if T % S:
        raise ValueError(f"n_segments={S} must divide nsteps={T}")
    L = T // S
    m = order // 2

    dt64, ts = _time_grid(prob)
    P, Q = control_tables(controls, pcof, ts, m)
    wd = prob.work_dtype
    wprob = working_problem(prob)
    Pw, Qw, dt = P.astype(wd), Q.astype(wd), dt64.astype(wd)
    mode = _segment_mode(wprob)
    precond = _make_preconditioner(wprob, dt, order)
    if mode == "schulz":
        from .forward import _drift_stage_inverse

        schulz_X0 = _drift_stage_inverse(wprob, m, dt)
    else:
        schulz_X0 = None

    tau = jnp.ones(T + 1, dtype=jnp.float64).at[0].set(0.5).at[-1].set(0.5)

    def seg_tables(arr):
        return (arr[:-1].reshape(S, L, *arr.shape[1:]),
                arr[1:].reshape(S, L, *arr.shape[1:]))

    Pl, Pr = seg_tables(Pw)
    Ql, Qr = seg_tables(Qw)
    tau_seg = tau[:-1].reshape(S, L)

    w_final, guard, _ = _forward_objective_pass(
        prob, wprob, m, dt, dt64, tau, Pl, Ql, Pr, Qr, tau_seg, mode,
        precond, schulz_X0, None)
    j1 = terminal_cost(w_final.astype(jnp.float64), target_real,
                       prob.N_ess_levels, cost_type)
    ridge = ridge_penalty_strength * jnp.vdot(pcof, pcof) / pcof.shape[0]
    return j1 + guard + ridge
