"""Control-pulse protocol.

The reference contract (src/Controls/Control.jl:6-27): a control has
``N_coeff`` parameters and a final time ``tf``, and exposes ``eval_p/eval_q``
(the symmetric/anti-symmetric pulse amplitudes), k-th time derivatives
``eval_p_derivative``/``eval_q_derivative``, and pcof-gradients of those.
The parameter vector ``pcof`` packs each control's parameters contiguously,
concatenated across controls (src/Controls/Control.jl:67-75).

Design
------
A control here is a pure pytree whose ``p(t, pcof)``/``q(t, pcof)`` are
jax-traceable scalar functions. What the propagator actually consumes is the
*scaled derivative table* ``p^{(k)}(t)/k!`` for ``k = 0..m-1`` — the
reference's ``fill_p_mat!`` (src/Controls/Control.jl:125-149) — evaluated
vectorized over the whole timestep grid in one ``vmap``. Concrete controls
override :meth:`Control.p_derivatives` with closed forms; the default derives
them with Taylor-mode AD, so *any* differentiable pulse parameterization
works at arbitrary method order (the reference's ForwardDiff fallback,
src/Controls/Control.jl:217-251, made total).

pcof-gradients are not part of the protocol at all: objectives differentiate
straight through the tables with JAX AD. Explicit ``eval_grad_*`` wrappers
are provided for API parity and tests.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp


def _static(**kw):
    return field(metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Control:
    """Abstract pulse parameterization. Subclasses must set ``N_coeff`` and
    ``tf`` and implement ``p``/``q`` (and ideally ``p_derivatives``)."""

    N_coeff: int = _static()
    tf: float = _static()

    # -- required scalar evaluations ---------------------------------------
    def p(self, t, pcof):
        raise NotImplementedError

    def q(self, t, pcof):
        raise NotImplementedError

    # -- scaled derivative tables ------------------------------------------
    def p_derivatives(self, t, pcof, m: int) -> jnp.ndarray:
        """``(m,)`` array of ``p^{(k)}(t)/k!``, ``k = 0..m-1``. Default:
        Taylor-mode AD of :meth:`p`."""
        return taylor_coefficients(lambda tt: self.p(tt, pcof), t, m)

    def q_derivatives(self, t, pcof, m: int) -> jnp.ndarray:
        return taylor_coefficients(lambda tt: self.q(tt, pcof), t, m)


def taylor_coefficients(f, t, m: int) -> jnp.ndarray:
    """Scaled Taylor coefficients ``f^{(k)}(t)/k!`` for ``k = 0..m-1`` of a
    scalar function, by nested forward-mode AD.

    Cost grows combinatorially with ``m`` but ``m <= 6`` for order-12 methods
    and this only runs on the (vmapped) timestep grid at trace time, far from
    the hot loop.
    """
    if m <= 0:
        return jnp.zeros((0,), dtype=jnp.float64)
    derivs = [f(t)]
    g = f
    fact = 1.0
    for k in range(1, m):
        g = _scalar_derivative(g)
        fact *= k
        derivs.append(g(t) / fact)
    return jnp.stack([jnp.asarray(d, dtype=jnp.float64) for d in derivs])


def _scalar_derivative(f):
    def df(t):
        _, tangent = jax.jvp(f, (t,), (jnp.ones_like(t),))
        return tangent
    return df


# ---------------------------------------------------------------------------
# pcof bookkeeping (reference src/Controls/Control.jl:67-97)
# ---------------------------------------------------------------------------

def as_control_tuple(controls) -> tuple:
    """Accept a bare control where a sequence is expected (the reference makes
    controls iterate like 1-element collections, src/Controls/Control.jl:44-54)."""
    if isinstance(controls, Control):
        return (controls,)
    return tuple(controls)


def total_control_parameters(controls) -> int:
    """Total pcof length (``get_number_of_control_parameters``,
    src/Controls/Control.jl:94-96)."""
    return sum(c.N_coeff for c in as_control_tuple(controls))


def control_vector_slice(pcof, controls, control_index: int):
    """Slice of ``pcof`` owned by control ``control_index`` (0-based;
    reference ``get_control_vector_slice``, src/Controls/Control.jl:67-75)."""
    controls = as_control_tuple(controls)
    start = sum(c.N_coeff for c in controls[:control_index])
    return pcof[start:start + controls[control_index].N_coeff]


def local_control_index(controls, global_index: int) -> tuple[int, int]:
    """Map a global pcof index to (control_index, local_index), both 0-based
    (reference ``get_local_control_indices``, src/Controls/Control.jl:78-91)."""
    controls = as_control_tuple(controls)
    for ci, c in enumerate(controls):
        if global_index < c.N_coeff:
            return ci, global_index
        global_index -= c.N_coeff
    raise IndexError("global pcof index out of range")


# ---------------------------------------------------------------------------
# Vectorized derivative tables — what the propagator consumes
# ---------------------------------------------------------------------------

def control_tables_at(controls, pcof, t, m: int):
    """Tables ``(P, Q)`` each of shape ``(m, N_ops)`` with
    ``P[k, j] = p_j^{(k)}(t)/k!`` at a single time (the reference's
    ``fill_p_mat!``/``fill_q_mat!``, src/Controls/Control.jl:125-149)."""
    controls = as_control_tuple(controls)
    ps, qs = [], []
    for ci, ctrl in enumerate(controls):
        local = control_vector_slice(pcof, controls, ci)
        ps.append(ctrl.p_derivatives(t, local, m))
        qs.append(ctrl.q_derivatives(t, local, m))
    if not controls:
        return (jnp.zeros((m, 0), dtype=jnp.float64),
                jnp.zeros((m, 0), dtype=jnp.float64))
    return jnp.stack(ps, axis=-1), jnp.stack(qs, axis=-1)


def control_tables(controls, pcof, ts, m: int):
    """Vectorized tables over a time grid: ``(P, Q)`` of shape
    ``(T, m, N_ops)``. This is the setup-time precomputation that replaces
    per-step scalar control evaluation inside the reference's hot loop
    (src/forward_evolution.jl:159-193)."""
    fn = lambda t: control_tables_at(controls, pcof, t, m)
    return jax.vmap(fn)(jnp.asarray(ts, dtype=jnp.float64))


# ---------------------------------------------------------------------------
# Reference-parity scalar API
# ---------------------------------------------------------------------------

def eval_p(control: Control, t, pcof):
    return control.p(jnp.asarray(t, jnp.float64), jnp.asarray(pcof, jnp.float64))


def eval_q(control: Control, t, pcof):
    return control.q(jnp.asarray(t, jnp.float64), jnp.asarray(pcof, jnp.float64))


def eval_p_derivative(control: Control, t, pcof, order: int):
    """Unscaled k-th derivative ``p^{(k)}(t)`` (reference
    ``eval_p_derivative``)."""
    table = control.p_derivatives(
        jnp.asarray(t, jnp.float64), jnp.asarray(pcof, jnp.float64), order + 1)
    return table[order] * math.factorial(order)


def eval_q_derivative(control: Control, t, pcof, order: int):
    table = control.q_derivatives(
        jnp.asarray(t, jnp.float64), jnp.asarray(pcof, jnp.float64), order + 1)
    return table[order] * math.factorial(order)


def eval_grad_p_derivative(control: Control, t, pcof, order: int):
    """Gradient of ``p^{(k)}(t)`` w.r.t. pcof, via AD (reference computes
    these analytically per control, e.g. src/Controls/bspline_control.jl:207-270)."""
    return jax.grad(
        lambda pc: eval_p_derivative(control, t, pc, order)
    )(jnp.asarray(pcof, jnp.float64))


def eval_grad_q_derivative(control: Control, t, pcof, order: int):
    return jax.grad(
        lambda pc: eval_q_derivative(control, t, pc, order)
    )(jnp.asarray(pcof, jnp.float64))
