"""Host-chunked long-horizon gradient: the O(sqrt T) segmented adjoint
split into multiple bounded device dispatches.

Even the O(sqrt T)-memory segmented program
(qgd_tpu/segmented.py) holds all of its segment-boundary snapshots, its
stage hoists and its gradient tables in device memory for the whole
evaluation, inside one device execution. At the reference's long-horizon
operating points (dt=1e-4 -> ~5.5e6 steps,
examples/cnot3_optimize_gate.sb:30-33) that bound is what fails first.

This module drives the SAME segment arithmetic through a host-side loop
over *chunks* of segments, so each device execution covers only
``segments_per_chunk * L`` timesteps:

* **forward chunk**: propagate the chunk's segments from the incoming
  state; return the chunk-final state, the segment-start snapshots, and
  the chunk's partial (trapezoid-weighted) guard sum.
* **terminal dispatch**: terminal cost + gradient, the transposed stage
  solve for ``lambda_T``, and the isolated index-``T`` pcof-gradient term.
* **backward chunk**: re-forward each segment from its snapshot, run the
  in-segment lambda sweep, form the merged cotangents, and reduce them
  through the chunk's control-table VJP; return ``lambda`` at the chunk's
  left edge plus the chunk's partial pcof gradient.

The pcof chain rule decomposes exactly across chunks because the control
tables are pointwise in t (``grad = sum_i vjp[table build at t_i](cot_i)``
— each chunk reduces its own time indices and the host adds the partials),
so the only difference vs the single-dispatch segmented path is the
summation order of that final reduction: values agree to summation
roundoff (tests/test_chunked.py pins ~1e-14 relative on f64).

Each chunk's outputs are fetched before the next dispatch is enqueued,
so device memory holds one chunk's tensors at a time and the host sees an
honest per-chunk wall-clock.

Multi-chip: pass ``mesh=`` to run every chunk dispatch under
``shard_map`` with the gate-basis columns split over the mesh's ``ic``
axis (cross-column reductions psum-ed inside each dispatch) — the
long-horizon workload then scales chips x wall-clock; see
``_make_sharded_chunk_fns``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .controls import as_control_tuple, control_tables, control_tables_at
from .problem import working_problem
from .objective import host_realify_target, terminal_cost_and_grad
from .ops.hermite import (
    assemble_generator_stack,
    scaled_derivatives,
    build_lhs,
    hermite_coefficients,
)
from .ops.linalg import schulz_inverse_auto, inverse_stage_solve
from .forward import _make_preconditioner, _drift_stage_inverse
from .segmented import (choose_segments, _segment_mode,
                        _forward_segment_scan, _guard_quad,
                        _make_seg_table_cot, _segment_bwd_body)


def _chunk_divisor(S: int, L: int, max_dispatch_steps: int) -> int:
    """Largest divisor ``S_c`` of ``S`` with ``S_c * L <= cap`` (so every
    chunk has the same shape -> one compile per program kind)."""
    if max_dispatch_steps <= 0:
        return S
    best = 1
    for d in range(1, S + 1):
        if S % d == 0 and d * L <= max_dispatch_steps:
            best = d
    return best


@partial(jax.jit, static_argnames=("order", "S_c", "L", "ic_axis"))
def _fwd_chunk(prob, controls, pcof, w_in, ts_chunk, tau_chunk,
               order: int, S_c: int, L: int, ic_axis: str | None = None):
    """Propagate ``S_c`` segments (``S_c * L`` steps) from ``w_in``.

    ``ts_chunk``: the ``S_c*L + 1`` global grid times covered by the chunk;
    ``tau_chunk``: global trapezoid weights for its ``S_c*L`` left
    endpoints. Returns ``(w_out, snapshots (S_c, 2N, B), guard_partial)``.
    """
    m = order // 2
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    # exact same scalar as _time_grid (NOT ts_chunk[1]-ts_chunk[0], which
    # for a chunk offset a is the rounded (a+1)*dt - a*dt)
    dt64 = jnp.asarray(prob.tf / prob.nsteps, dtype=jnp.float64)
    P, Q = control_tables(controls, pcof, ts_chunk, m)

    wd = prob.work_dtype
    wprob = working_problem(prob)
    Pw, Qw, dt = P.astype(wd), Q.astype(wd), dt64.astype(wd)
    mode = _segment_mode(wprob)
    precond = _make_preconditioner(wprob, dt, order)
    schulz_X0 = (_drift_stage_inverse(wprob, m, dt)
                 if mode == "schulz" else None)

    def seg_tables(arr):
        return (arr[:-1].reshape(S_c, L, *arr.shape[1:]),
                arr[1:].reshape(S_c, L, *arr.shape[1:]))

    Pl, Pr = seg_tables(Pw)
    Ql, Qr = seg_tables(Qw)
    tau_seg = tau_chunk.reshape(S_c, L)

    def fwd_body(carry, xs):
        w, guard_acc = carry
        pl_, ql_, pr_, qr_, tau_k = xs
        hist = _forward_segment_scan(wprob, m, dt, pl_, ql_, pr_, qr_,
                                     w, mode, precond=precond,
                                     schulz_X0=schulz_X0)
        guard_acc = guard_acc + _guard_quad(prob, hist[:-1], tau_k)
        return (hist[-1], guard_acc), w

    (w_out, guard_partial), snapshots = jax.lax.scan(
        fwd_body, (w_in, jnp.zeros((), dtype=jnp.float64)),
        (Pl, Ql, Pr, Qr, tau_seg))
    if ic_axis is not None:
        guard_partial = jax.lax.psum(guard_partial, ic_axis)
    return w_out, snapshots, guard_partial


@partial(jax.jit, static_argnames=("order", "cost_type", "ic_axis"))
def _terminal_chunk(prob, controls, pcof, w_final, target_real,
                    order: int, cost_type: str,
                    ic_axis: str | None = None):
    """Terminal cost/gradient, ``lambda_T`` via the transposed stage solve,
    the final trapezoid guard term, and the index-``T`` pcof-gradient
    contribution (only the LHS cotangent survives at ``T`` — no step
    starts there). Mirrors segmented_objective_and_gradient's terminal
    block."""
    m = order // 2
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    wd = prob.work_dtype
    wprob = working_problem(prob)
    dt64 = jnp.asarray(prob.tf / prob.nsteps, dtype=jnp.float64)
    dt = dt64.astype(wd)

    guard_term = 0.5 * _guard_quad(
        prob, w_final[None].astype(jnp.float64),
        jnp.ones((1,), dtype=jnp.float64))
    if ic_axis is not None:
        guard_term = jax.lax.psum(guard_term, ic_axis)

    w_final64 = w_final.astype(jnp.float64)
    j1, dj1 = terminal_cost_and_grad(w_final64, target_real,
                                     prob.N_ess_levels, cost_type, ic_axis)

    guard_scale = 2.0 * dt64 / prob.tf
    W = prob.guard_subspace_projector
    f_T = (guard_scale * 0.5) * (W @ w_final64)
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

    c = jnp.asarray(hermite_coefficients(m), dtype=jnp.float64)
    jpow = jnp.arange(m + 1, dtype=jnp.float64)
    w_lhs = (c * (-dt64) ** jpow).astype(wd)
    cot_T = -w_lhs[:, None, None] * lam_T[None]

    def stack_from_tables(p_t, q_t):
        A = assemble_generator_stack(wprob, p_t, q_t, m)
        return scaled_derivatives(A, w_final.astype(wd), m)

    _, vjp_f = jax.vjp(stack_from_tables, p_f.astype(wd), q_f.astype(wd))
    cotPT, cotQT = vjp_f(cot_T.astype(wd))
    _, vjp_tf = jax.vjp(
        lambda pc: control_tables_at(controls, pc, prob.tf, m), pcof)
    (grad_T,) = vjp_tf((cotPT.astype(jnp.float64),
                        cotQT.astype(jnp.float64)))
    if ic_axis is not None:
        grad_T = jax.lax.psum(grad_T, ic_axis)
    return j1, guard_term, lam_T, grad_T


@partial(jax.jit, static_argnames=("order", "S_c", "L", "ic_axis"))
def _bwd_chunk(prob, controls, pcof, lam_in, snaps, ts_chunk, tau_chunk,
               first_mask, order: int, S_c: int, L: int,
               ic_axis: str | None = None):
    """Backward sweep over one chunk's ``S_c`` segments (global order
    reversed by the caller): re-forward each segment from its snapshot,
    lambda sweep, merged cotangents, and the chunk's control-table VJP.

    ``first_mask (S_c,)``: 0.0 at the globally-first segment (its
    ``lambda_0`` multiplier is dropped — the initial state is fixed),
    1.0 elsewhere. Returns ``(lam_out, grad_partial)``.
    """
    m = order // 2
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    dt64 = jnp.asarray(prob.tf / prob.nsteps, dtype=jnp.float64)
    P, Q = control_tables(controls, pcof, ts_chunk, m)

    wd = prob.work_dtype
    wprob = working_problem(prob)
    Pw, Qw, dt = P.astype(wd), Q.astype(wd), dt64.astype(wd)
    mode = _segment_mode(wprob)
    precond = _make_preconditioner(wprob, dt, order)
    if mode == "schulz":
        schulz_X0 = _drift_stage_inverse(wprob, m, dt)
        schulz_X0T = _drift_stage_inverse(wprob, m, dt, transpose=True)
    else:
        schulz_X0 = schulz_X0T = None

    def seg_tables(arr):
        return (arr[:-1].reshape(S_c, L, *arr.shape[1:]),
                arr[1:].reshape(S_c, L, *arr.shape[1:]))

    Pl, Pr = seg_tables(Pw)
    Ql, Qr = seg_tables(Qw)
    tau_seg = tau_chunk.reshape(S_c, L)

    guard_scale = 2.0 * dt64 / prob.tf
    W = prob.guard_subspace_projector
    c = jnp.asarray(hermite_coefficients(m), dtype=jnp.float64)
    jpow = jnp.arange(m + 1, dtype=jnp.float64)
    w_rhs = (c * dt64 ** jpow).astype(wd)
    w_lhs = (c * (-dt64) ** jpow).astype(wd)

    # Segment body + table-cotangent builders shared with
    # segmented_objective_and_gradient (segmented.py) — one implementation
    # of the re-forward / lambda-sweep / merged-cotangent arithmetic.
    _, seg_table_cot = _make_seg_table_cot(wprob, m, L)

    def bwd_body(lam_b, xs):
        snap, pl_, ql_, pr_, qr_, tau_k, first_k = xs
        return _segment_bwd_body(
            wprob, m, dt, mode, precond, schulz_X0, schulz_X0T,
            prob.schulz_iters, guard_scale, W, w_rhs, w_lhs, seg_table_cot,
            lam_b, snap, pl_, ql_, pr_, qr_, tau_k, first_k)

    rev = lambda a: a[::-1]
    lam_out, (cotP_rev, cotQ_rev) = jax.lax.scan(
        bwd_body, lam_in,
        (rev(snaps), rev(Pl), rev(Ql), rev(Pr), rev(Qr), rev(tau_seg),
         rev(first_mask)))

    cotP = cotP_rev[::-1].reshape(S_c * L, *cotP_rev.shape[2:])
    cotQ = cotQ_rev[::-1].reshape(S_c * L, *cotQ_rev.shape[2:])
    _, vjp_tables = jax.vjp(
        lambda pc: control_tables(controls, pc, ts_chunk[:-1], m), pcof)
    (grad_partial,) = vjp_tables((cotP.astype(jnp.float64),
                                  cotQ.astype(jnp.float64)))
    if ic_axis is not None:
        grad_partial = jax.lax.psum(grad_partial, ic_axis)
    return lam_out, grad_partial


def _make_sharded_chunk_fns(prob, controls, order, cost_type, S_c, L,
                            mesh, ic_axis: str):
    """shard_map-wrapped chunk dispatch functions with the gate-basis
    columns split over ``ic_axis`` (VERDICT r4 #7: the long-horizon
    chunked driver composes with ic sharding — the chunk bodies already
    take ``ic_axis`` for their psums; this builds the per-dispatch
    wrappers once so every chunk reuses the same traced callables)."""
    import dataclasses

    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    ic = P(None, ic_axis)
    snaps_spec = P(None, None, ic_axis)

    def fwd_local(u0, v0, pc, w_in, ts_chunk, tau_chunk):
        p = dataclasses.replace(prob, u0=u0, v0=v0)
        return _fwd_chunk(p, controls, pc, w_in, ts_chunk, tau_chunk,
                          order, S_c, L, ic_axis=ic_axis)

    fwd = jax.jit(shard_map(
        fwd_local, mesh=mesh,
        in_specs=(ic, ic, P(), ic, P(), P()),
        out_specs=(ic, snaps_spec, P()), check_vma=False))

    def term_local(u0, v0, pc, w_final, tgt):
        p = dataclasses.replace(prob, u0=u0, v0=v0)
        return _terminal_chunk(p, controls, pc, w_final, tgt,
                               order, cost_type, ic_axis=ic_axis)

    term = jax.jit(shard_map(
        term_local, mesh=mesh,
        in_specs=(ic, ic, P(), ic, ic),
        out_specs=(P(), P(), ic, P()), check_vma=False))

    def bwd_local(u0, v0, pc, lam_in, snaps, ts_chunk, tau_chunk,
                  first_mask):
        p = dataclasses.replace(prob, u0=u0, v0=v0)
        return _bwd_chunk(p, controls, pc, lam_in, snaps, ts_chunk,
                          tau_chunk, first_mask, order, S_c, L,
                          ic_axis=ic_axis)

    bwd = jax.jit(shard_map(
        bwd_local, mesh=mesh,
        in_specs=(ic, ic, P(), ic, snaps_spec, P(), P(), P()),
        out_specs=(ic, P()), check_vma=False))

    return fwd, term, bwd


def chunked_objective_and_gradient(prob, controls, pcof, target,
                                   order: int = 4,
                                   cost_type: str = "Infidelity",
                                   ridge_penalty_strength: float = 0.0,
                                   n_segments: int = 0,
                                   max_dispatch_steps: int = 0,
                                   segments_per_chunk: int = 0,
                                   progress=None,
                                   mesh=None, ic_axis: str = "ic"):
    """Host-chunked equivalent of
    ``segmented.segmented_objective_and_gradient``: same
    ``((j1, guard, ridge), grad)`` semantics, device time per dispatch
    bounded by ``max_dispatch_steps`` Hermite steps (or an explicit
    ``segments_per_chunk``).

    ``progress``: optional callable ``(phase, chunk_index, n_chunks,
    wall_seconds)`` invoked after each fetched dispatch — the per-chunk
    fetch is also the host-side synchronization that bounds each device
    execution.

    ``mesh``: optional device mesh with an ``ic_axis`` axis — every chunk
    dispatch then runs under ``shard_map`` with the gate-basis columns
    split over it and all cross-column reductions psum-ed, so the
    long-horizon workload scales across chips (chips x wall-clock); the
    host loop and chunk pacing are unchanged. Values equal the
    single-device path to summation roundoff
    (tests/test_chunked.py::test_chunked_sharded_matches_single).
    """
    import time

    controls = as_control_tuple(controls)
    pcof = jnp.asarray(pcof, dtype=jnp.float64)
    target_real = jnp.asarray(host_realify_target(target))

    T = prob.nsteps
    S = n_segments if n_segments > 0 else choose_segments(T)
    if T % S:
        raise ValueError(f"n_segments={S} must divide nsteps={T}")
    L = T // S
    if segments_per_chunk > 0:
        if S % segments_per_chunk:
            raise ValueError(
                f"segments_per_chunk={segments_per_chunk} must divide S={S}")
        S_c = segments_per_chunk
    else:
        S_c = _chunk_divisor(S, L, max_dispatch_steps)
        if max_dispatch_steps > 0 and S_c * L > max_dispatch_steps:
            import warnings

            warnings.warn(
                f"segment length L={L} alone exceeds max_dispatch_steps="
                f"{max_dispatch_steps}; dispatches will cover {S_c * L} "
                f"steps. Pass n_segments to shorten segments.")
    C = S // S_c
    dt = prob.tf / T

    if mesh is not None:
        fwd_fn, term_fn, bwd_fn = _make_sharded_chunk_fns(
            prob, controls, order, cost_type, S_c, L, mesh, ic_axis)

    # global trapezoid weights for the left endpoints (index T handled in
    # the terminal dispatch)
    tau = np.ones(T, dtype=np.float64)
    tau[0] = 0.5

    wprob = working_problem(prob)
    w = wprob.w0
    snaps_chunks = []
    guard_sum = 0.0
    for k in range(C):
        t0 = time.perf_counter()
        a = k * S_c * L
        b = (k + 1) * S_c * L
        ts_chunk = jnp.arange(a, b + 1, dtype=jnp.float64) * dt
        if mesh is not None:
            w, snaps, gp = fwd_fn(prob.u0, prob.v0, pcof, w, ts_chunk,
                                  jnp.asarray(tau[a:b]))
        else:
            w, snaps, gp = _fwd_chunk(prob, controls, pcof, w,
                                      ts_chunk, jnp.asarray(tau[a:b]),
                                      order, S_c, L)
        guard_sum += float(gp)               # fetch = sync
        snaps_chunks.append(snaps)
        if progress is not None:
            progress("fwd", k, C, time.perf_counter() - t0)

    t0 = time.perf_counter()
    if mesh is not None:
        j1, guard_term, lam, grad_T = term_fn(prob.u0, prob.v0, pcof, w,
                                              target_real)
    else:
        j1, guard_term, lam, grad_T = _terminal_chunk(
            prob, controls, pcof, w, target_real, order, cost_type)
    j1 = float(j1)
    guard_sum += float(guard_term)
    grad = np.asarray(grad_T, dtype=np.float64)
    if progress is not None:
        progress("terminal", 0, 1, time.perf_counter() - t0)

    for k in reversed(range(C)):
        t0 = time.perf_counter()
        a = k * S_c * L
        b = (k + 1) * S_c * L
        ts_chunk = jnp.arange(a, b + 1, dtype=jnp.float64) * dt
        first_mask = np.ones(S_c, dtype=np.float64)
        if k == 0:
            first_mask[0] = 0.0
        if mesh is not None:
            lam, gpart = bwd_fn(prob.u0, prob.v0, pcof, lam,
                                snaps_chunks[k], ts_chunk,
                                jnp.asarray(tau[a:b]),
                                jnp.asarray(first_mask))
        else:
            lam, gpart = _bwd_chunk(prob, controls, pcof, lam,
                                    snaps_chunks[k], ts_chunk,
                                    jnp.asarray(tau[a:b]),
                                    jnp.asarray(first_mask), order, S_c, L)
        grad = grad + np.asarray(gpart, dtype=np.float64)  # fetch = sync
        snaps_chunks[k] = None                             # free device refs
        if progress is not None:
            progress("bwd", C - 1 - k, C, time.perf_counter() - t0)

    guard = guard_sum * dt / prob.tf
    n = pcof.shape[0]
    pc_np = np.asarray(pcof)
    ridge = ridge_penalty_strength * float(pc_np @ pc_np) / n
    grad = grad + 2.0 * ridge_penalty_strength * pc_np / n
    return (j1, guard, ridge), grad
