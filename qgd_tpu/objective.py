"""Gate-infidelity, guard-penalty, and ridge objective
(reference src/infidelity.jl, ridge term src/ipopt_optimal_control.jl:272-280).

All pure functions of (problem, controls, pcof, target); batched over
initial-condition columns by construction. The dot products over the
initial-condition axis become ``psum`` reductions under sharding
(qgd_tpu/parallel).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .forward import eval_forward
from .controls import as_control_tuple


def _target_T(target_real: jnp.ndarray, N_tot: int) -> jnp.ndarray:
    """Real-stacked version of ``i * target``: ``T = [R_v; -R_u]``
    (src/infidelity.jl:13-16)."""
    return jnp.concatenate([target_real[N_tot:], -target_real[:N_tot]], axis=0)


def infidelity_real(psi_real, target_real, N_ess: int):
    """``1 - (<psi,R>^2 + <psi,T>^2)/N_ess^2`` — the real form of
    ``1 - |tr(V' U)|^2 / N_ess^2`` (src/infidelity.jl:7-18).

    ``psi_real``/``target_real`` are (2N,) or (2N, B); the inner products are
    over all elements (Frobenius over the gate basis).
    """
    N_tot = psi_real.shape[0] // 2
    R = target_real
    T = _target_T(target_real, N_tot)
    a = jnp.vdot(psi_real, R)
    b = jnp.vdot(psi_real, T)
    return 1.0 - (a * a + b * b) / (N_ess ** 2)


def infidelity(psi, target, N_ess: int):
    """Complex-argument wrapper (src/infidelity.jl:20-29)."""
    psi_r = jnp.concatenate([jnp.real(psi), jnp.imag(psi)], axis=0)
    tgt_r = jnp.concatenate([jnp.real(target), jnp.imag(target)], axis=0)
    return infidelity_real(psi_r, tgt_r, N_ess)


def infidelity_of(prob, controls, pcof, target, order: int = 2, forcing=None):
    """Forward-solve-then-infidelity convenience (src/infidelity.jl:33-47)."""
    # host_realify_target, not _realify_target: a complex target is split
    # on the host, so only real arrays cross to the device.
    target_real = jnp.asarray(host_realify_target(target))
    hist = eval_forward(prob, controls, pcof, order, forcing=forcing)
    return infidelity_real(hist[-1], target_real, prob.N_ess_levels)


def guard_penalty_real(history, dt, total_time, W):
    """Trapezoid-in-time of ``<w, W w> * dt/T`` over the state history
    (src/infidelity.jl:56-96). ``history`` is time-major ``(T, 2N, B)``."""
    Wh = jnp.einsum("ab,tbj->taj", W, history)
    per_t = jnp.einsum("taj,taj->t", history, Wh)
    n = per_t.shape[0]
    weights = jnp.ones(n, dtype=per_t.dtype).at[0].set(0.5).at[-1].set(0.5)
    return jnp.sum(weights * per_t) * dt / total_time


def guard_penalty(history_complex, dt, total_time, W):
    """Complex wrapper (src/infidelity.jl:124-146): history ``(T, N, B)``."""
    hist = jnp.concatenate(
        [jnp.real(history_complex), jnp.imag(history_complex)], axis=-2)
    return guard_penalty_real(hist, dt, total_time, W)


def _realify_target(prob, target):
    target = jnp.asarray(target)
    if jnp.iscomplexobj(target):
        target = jnp.concatenate([jnp.real(target), jnp.imag(target)], axis=0)
    target = target.astype(jnp.float64)
    if target.ndim == 1:
        target = target[:, None]
    return target


def host_realify_target(target):
    """Split a complex target gate into the real-stacked ``[Re; Im]`` form
    on the HOST (numpy), before it can cross a jit boundary, so jitted
    programs only ever see real arrays. Idempotent on already-real
    targets. Tracer-safe: inside a trace (internal nested calls) it falls
    back to the on-device realification — no transfer happens there."""
    import numpy as np

    if isinstance(target, jax.core.Tracer):
        t = jnp.asarray(target)
        if jnp.iscomplexobj(t):
            t = jnp.concatenate([jnp.real(t), jnp.imag(t)], axis=0)
        t = t.astype(jnp.float64)
        if t.ndim == 1:
            t = t[:, None]
        return t
    t = np.asarray(target)
    if np.iscomplexobj(t):
        t = np.concatenate([t.real, t.imag], axis=0)
    t = t.astype(np.float64)
    if t.ndim == 1:
        t = t[:, None]
    return t


def with_host_target(argnum):
    """Decorator (applied OUTSIDE jit): realify the ``target`` argument on
    host before the wrapped jitted function transfers its inputs."""
    import functools

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if "target" in kwargs:
                kwargs = dict(kwargs)
                kwargs["target"] = host_realify_target(kwargs["target"])
            elif len(args) > argnum:
                args = (args[:argnum]
                        + (host_realify_target(args[argnum]),)
                        + args[argnum + 1:])
            return fn(*args, **kwargs)
        return wrapper
    return deco


def terminal_cost(final_state, target_real, N_ess: int,
                  cost_type: str = "Infidelity"):
    """Terminal cost J1(w_N); the ``cost_type`` variants of
    ``compute_terminal_condition`` (src/eval_grad_discrete_adjoint.jl:26-36):

    * ``Infidelity`` — gate infidelity (default; the only production cost)
    * ``Tracking``   — ``0.5 ||w_N - target||^2``
    * ``Norm``       — ``0.5 ||w_N||^2``
    """
    if cost_type == "Infidelity":
        return infidelity_real(final_state, target_real, N_ess)
    if cost_type == "Tracking":
        d = final_state - target_real
        return 0.5 * jnp.vdot(d, d)
    if cost_type == "Norm":
        return 0.5 * jnp.vdot(final_state, final_state)
    raise ValueError(f"Invalid cost type: {cost_type}")


def terminal_cost_and_grad(final_state, target_real, N_ess: int,
                           cost_type: str = "Infidelity",
                           ic_axis: str | None = None):
    """``(J1, dJ1/d final_state)`` with optional initial-condition-axis
    reduction for sharded evaluation.

    Under ``shard_map`` with gate-basis columns split over ``ic_axis``,
    the infidelity trace ``a + ib = tr(V' U)`` is a sum over ALL columns:
    the local partial traces are ``psum``-ed before the value and the
    per-local-column gradient ``-(2/N_ess^2)(a R + b T)`` are formed —
    that gradient is exact for the *global* objective restricted to the
    local columns (the only cross-column coupling is through the scalars
    ``a, b``). Tracking/Norm costs are column-separable: value is psum-ed,
    gradient is purely local.
    """
    if cost_type == "Infidelity":
        N_tot = final_state.shape[0] // 2
        R = target_real
        T = _target_T(target_real, N_tot)
        a = jnp.vdot(final_state, R)
        b = jnp.vdot(final_state, T)
        if ic_axis is not None:
            a = jax.lax.psum(a, ic_axis)
            b = jax.lax.psum(b, ic_axis)
        val = 1.0 - (a * a + b * b) / (N_ess ** 2)
        g = (-2.0 / N_ess ** 2) * (a * R + b * T)
        return val, g
    val, g = jax.value_and_grad(
        lambda w: terminal_cost(w, target_real, N_ess, cost_type)
    )(final_state)
    if ic_axis is not None:
        val = jax.lax.psum(val, ic_axis)
    return val, g


@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "cost_type"))
def objective_parts(prob, controls, pcof, target, order: int = 2,
                    ridge_penalty_strength: float = 0.0,
                    cost_type: str = "Infidelity"):
    """Evaluate (terminal cost, guard penalty, ridge) in one forward solve.

    The ridge term is ``lambda_r * ||pcof||^2 / N_params``
    (src/ipopt_optimal_control.jl:272-280).
    """
    controls = as_control_tuple(controls)
    target_real = _realify_target(prob, target)
    hist = eval_forward(prob, controls, pcof, order)
    final_state = hist[-1]
    dt = prob.tf / prob.nsteps
    j1 = terminal_cost(final_state, target_real, prob.N_ess_levels, cost_type)
    guard = guard_penalty_real(hist, dt, prob.tf,
                               prob.guard_subspace_projector)
    ridge = ridge_penalty_strength * jnp.vdot(pcof, pcof) / pcof.shape[0]
    return j1, guard, ridge


def objective_value(prob, controls, pcof, target, order: int = 2,
                    ridge_penalty_strength: float = 0.0,
                    cost_type: str = "Infidelity"):
    """Total objective (infidelity + guard + ridge)."""
    j1, guard, ridge = objective_parts(
        prob, controls, pcof, target, order, ridge_penalty_strength, cost_type)
    return j1 + guard + ridge


def infidelity_plus_guard(prob, controls, pcof, target, order: int = 2):
    """Reference ``infidelity_plus_guard`` (src/infidelity.jl:148-165)."""
    j1, guard, _ = objective_parts(prob, controls, pcof, target, order)
    return j1 + guard
