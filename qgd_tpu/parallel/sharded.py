"""Sharded objective/gradient evaluation and the multi-chip training step.

See package docstring for the mesh design. Everything here is built on
``shard_map`` + explicit ``psum`` so the communication pattern is exactly
what the docstring promises — XLA inserts nothing else.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..adjoint import objective_and_gradient
from ..controls import as_control_tuple
from ..forward import eval_forward
from ..objective import (_realify_target, _target_T, host_realify_target,
                         with_host_target)
from ..segmented import segmented_objective_and_gradient


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Initialize multi-host JAX (``jax.distributed``) so
    :func:`make_mesh` sees every host's devices. The scenario axis is the
    natural cross-host (DCN) axis — scenarios never communicate; the ic
    axis's scalar psums should stay within a host/slice (ICI).

    No-op when already initialized or running single-process.
    """
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError:
        pass  # already initialized


def make_mesh(n_scenario: int = 1, n_ic: int = 1, devices=None) -> Mesh:
    """Build a ``(scenario, ic)`` device mesh from the available devices."""
    if devices is None:
        devices = jax.devices()
    n = n_scenario * n_ic
    if n > len(devices):
        raise ValueError(f"mesh {n_scenario}x{n_ic} needs {n} devices, "
                         f"have {len(devices)}")
    dev_array = np.asarray(devices[:n]).reshape(n_scenario, n_ic)
    return Mesh(dev_array, axis_names=("scenario", "ic"))


def _resolve_gradient_method(prob, gradient_method: str) -> str:
    """``auto`` mirrors optimize_gate's rule: the O(sqrt T) segmented route
    once the plain path's O(T) history tensors dominate memory."""
    if gradient_method != "auto":
        return gradient_method
    return "segmented" if prob.nsteps >= 16384 else "lagrange"


def _local_value_and_grad(prob, controls, pcof, target_real, order: int,
                          gradient_method: str, ic_axis: str):
    """Objective (infidelity + guard) and exact gradient for the LOCAL gate
    columns, all cross-column reductions psum-ed over ``ic_axis``.

    The production routes ("lagrange", "segmented") are the hand-structured
    discrete adjoints — forward scans + per-step VJPs only. ``"ad"`` keeps
    the reverse-AD-of-scan route as an independent cross-check
    (tests/test_sharding.py asserts all routes agree).
    """
    if gradient_method == "ad":
        val, grad = jax.value_and_grad(
            lambda q: _local_objective(prob, controls, q, target_real,
                                       order, ic_axis))(pcof)
        # psum transposes to psum, so each shard's local grad carries an
        # extra axis-size factor on its own contribution; psum/n recovers
        # the exact full gradient.
        return val, jax.lax.psum(grad, ic_axis) / jax.lax.axis_size(ic_axis)
    if gradient_method == "segmented":
        (j1, guard, _), grad = segmented_objective_and_gradient(
            prob, controls, pcof, target_real, order, ic_axis=ic_axis)
    elif gradient_method == "lagrange":
        (j1, guard, _), grad = objective_and_gradient(
            prob, controls, pcof, target_real, order, ic_axis=ic_axis)
    else:
        raise ValueError(f"unknown gradient_method {gradient_method!r}")
    return j1 + guard, grad


def _local_objective(prob, controls, pcof, target_real, order: int,
                     ic_axis: str | None):
    """Objective where every initial-condition reduction optionally psums
    over ``ic_axis`` — the sharded counterpart of
    qgd_tpu.objective.objective_parts (the reverse-AD cross-check route;
    production gradients go through :func:`_local_value_and_grad`)."""
    hist = eval_forward(prob, controls, pcof, order)
    final_state = hist[-1]
    N_tot = prob.N_tot_levels
    R = target_real
    T = _target_T(target_real, N_tot)
    a = jnp.vdot(final_state, R)
    b = jnp.vdot(final_state, T)

    dt = prob.tf / prob.nsteps
    W = prob.guard_subspace_projector
    Wh = jnp.einsum("ab,tbj->taj", W, hist)
    per_t = jnp.einsum("taj,taj->t", hist, Wh)
    n = per_t.shape[0]
    wts = jnp.ones(n, dtype=per_t.dtype).at[0].set(0.5).at[-1].set(0.5)
    guard_local = jnp.sum(wts * per_t) * dt / prob.tf

    if ic_axis is not None:
        a = jax.lax.psum(a, ic_axis)
        b = jax.lax.psum(b, ic_axis)
        guard = jax.lax.psum(guard_local, ic_axis)
    else:
        guard = guard_local

    infid = 1.0 - (a * a + b * b) / (prob.N_ess_levels ** 2)
    return infid + guard


# with_host_target sits OUTSIDE jit: a complex target is realified on the
# host before it becomes a jit input (see objective.host_realify_target).
@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "mesh", "ridge_penalty_strength",
                                   "gradient_method"))
def sharded_objective_and_grad(prob, controls, pcof, target, mesh: Mesh,
                               order: int = 4,
                               ridge_penalty_strength: float = 0.0,
                               gradient_method: str = "auto"):
    """Objective + gradient with initial-condition columns sharded over the
    mesh's ``ic`` axis (single control vector). Gradients via the
    hand-structured Lagrange/segmented adjoint; equality
    vs the single-device path in tests/test_sharding.py."""
    controls = as_control_tuple(controls)
    target_real = jnp.asarray(host_realify_target(target))
    ic_spec = P(None, "ic")
    gradient_method = _resolve_gradient_method(prob, gradient_method)

    def local(u0, v0, tgt, pc):
        p_local = dataclasses.replace(prob, u0=u0, v0=v0)
        return _local_value_and_grad(p_local, controls, pc, tgt, order,
                                     gradient_method, "ic")

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(ic_spec, ic_spec, ic_spec, P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    val, grad = fn(prob.u0, prob.v0, target_real, jnp.asarray(pcof))
    pcof = jnp.asarray(pcof)
    ridge = ridge_penalty_strength * jnp.vdot(pcof, pcof) / pcof.shape[0]
    return val + ridge, grad + 2.0 * ridge_penalty_strength * pcof / pcof.shape[0]


@with_host_target(3)
@partial(jax.jit, static_argnames=("order", "mesh", "ridge_penalty_strength",
                                   "gradient_method"))
def batched_objective_and_grad(prob, controls, pcofs, target, mesh: Mesh,
                               order: int = 4,
                               ridge_penalty_strength: float = 0.0,
                               gradient_method: str = "auto"):
    """Per-scenario objective + gradient for a batch of control vectors
    ``pcofs (S, n_params)``, scenarios sharded over ``scenario`` and
    initial-condition columns over ``ic``. Gradients via the
    hand-structured Lagrange/segmented adjoint."""
    controls = as_control_tuple(controls)
    target_real = jnp.asarray(host_realify_target(target))
    gradient_method = _resolve_gradient_method(prob, gradient_method)

    def local(u0, v0, tgt, pcs):
        p_local = dataclasses.replace(prob, u0=u0, v0=v0)

        def one(pc):
            return _local_value_and_grad(p_local, controls, pc, tgt, order,
                                         gradient_method, "ic")

        return jax.vmap(one)(pcs)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "ic"), P(None, "ic"), P(None, "ic"),
                  P("scenario", None)),
        out_specs=(P("scenario"), P("scenario", None)),
        check_vma=False,
    )
    pcofs = jnp.asarray(pcofs)
    vals, grads = fn(prob.u0, prob.v0, target_real, pcofs)
    n = pcofs.shape[-1]
    ridge = ridge_penalty_strength * jnp.sum(pcofs * pcofs, axis=-1) / n
    return vals + ridge, grads + 2.0 * ridge_penalty_strength * pcofs / n


def multichip_train_step(prob, controls, target, mesh: Mesh, order: int = 4,
                         ridge_penalty_strength: float = 1e-2,
                         learning_rate: float = 0.02,
                         gradient_method: str = "auto"):
    """Build a jitted multi-chip optimization step: batched scenario
    gradients + a gradient-descent update, all device-resident. Returns
    ``step(pcofs) -> (pcofs', objectives)``.

    (The production driver uses L-BFGS on the host or optax on device; this
    fixed-step variant is what the multi-chip dry-run compiles.)
    """
    # Realify once, before ``target`` is closed over: inside jit(step) a
    # complex target would otherwise become an embedded complex128
    # constant.
    target = host_realify_target(target)

    def step(pcofs):
        vals, grads = batched_objective_and_grad(
            prob, controls, pcofs, target, mesh, order,
            ridge_penalty_strength, gradient_method=gradient_method)
        return pcofs - learning_rate * grads, vals

    return jax.jit(step)
