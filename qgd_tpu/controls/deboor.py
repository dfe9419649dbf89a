"""Arbitrary-degree clamped B-spline controls via the de Boor recurrence
(reference ``GeneralBSplineControl``, src/Controls/GeneralBSplineControl.jl,
and ``FortranBSplineControl``, src/Controls/FortranBSpline.jl, which ccalls
de Boor's pppack ``bsplvd`` Fortran routine, src/Fortran/bsplvd.f).

Design: the Cox-de Boor *value* recurrence is implemented as a
pure jnp function with static loop bounds (order <= ~10); time-derivative
tables come from Taylor-mode AD of that recurrence — exact, because the
spline is polynomial within each knot interval and the interval index is
piecewise-constant (zero derivative). This replaces pppack's explicit
``bsplvd`` differencing scheme; a C++ port of the differencing scheme lives
in qgd_tpu/native as an independent parity oracle.

Knots: uniform distinct knots with the first/last knot repeated ``order``
times (clamped), exactly as the reference builds them
(src/Controls/FortranBSpline.jl:44-57). A clamped B-spline of order k with
``N_knots = N_basis + k`` total knots has ``N_basis`` basis functions.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .base import Control


def _static():
    return field(metadata=dict(static=True))


def clamped_uniform_knots(order: int, n_distinct: int) -> np.ndarray:
    """Padded knot vector on [0, 1]: uniform distinct knots with the ends
    repeated ``order - 1`` extra times (src/Controls/FortranBSpline.jl:52-57)."""
    distinct = np.linspace(0.0, 1.0, n_distinct)
    return np.concatenate([
        np.full(order - 1, distinct[0]), distinct,
        np.full(order - 1, distinct[-1]),
    ])


def deboor_nonzero_values(knots: jnp.ndarray, order: int, x, left):
    """Values at ``x`` of the ``order`` B-splines of order ``order`` that do
    not vanish on the knot interval ``(knots[left], knots[left+1])`` — the
    ``bsplvb`` recurrence (src/Fortran/bsplvb.f:1-92), unrolled with static
    bounds.

    Returns ``(order,)``; entry ``j`` is spline ``left - order + 1 + j``.
    """
    biatx = [jnp.ones_like(x)]
    deltal, deltar = [], []
    for j in range(1, order):
        deltar.append(knots[left + j] - x)
        deltal.append(x - knots[left + 1 - j])
        saved = jnp.zeros_like(x)
        new = []
        for i in range(j):
            denom = deltar[i] + deltal[j - 1 - i]
            term = biatx[i] / denom
            new.append(saved + deltar[i] * term)
            saved = deltal[j - 1 - i] * term
        new.append(saved)
        biatx = new
    return jnp.stack(biatx)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _DeBoorBSpline(Control):
    """Clamped uniform B-spline on a scaled domain [0, 1];
    ``p(t) = sum_i pcof[i] B_i(t/tf)``, q from the second half of pcof."""
    knot_vector: jnp.ndarray
    degree: int = _static()
    N_basis_functions: int = _static()
    N_distinct_knots: int = _static()

    @property
    def bspline_order(self) -> int:
        return self.degree + 1

    def _value(self, x, coeffs):
        order = self.bspline_order
        nd = self.N_distinct_knots
        # distinct-interval index, clamped (FortranBSpline.jl:265-266)
        l_dist = jnp.clip(jnp.floor(x * (nd - 1)).astype(jnp.int32), 0, nd - 2)
        left = self.degree + l_dist
        vals = deboor_nonzero_values(self.knot_vector, order, x, left)
        taps = jax.lax.dynamic_slice(coeffs, (l_dist,), (order,))
        return jnp.sum(vals * taps)

    def p(self, t, pcof):
        x = t / self.tf
        return self._value(x, pcof[:self.N_basis_functions])

    def q(self, t, pcof):
        x = t / self.tf
        return self._value(x, pcof[self.N_basis_functions:])


def FortranBSplineControl(degree, N_basis_functions, tf):
    """Arbitrary-degree clamped B-spline control
    (src/Controls/FortranBSpline.jl:16-64). ``N_coeff = 2 * N_basis_functions``
    with pcof = [p-coeffs; q-coeffs]."""
    degree = int(degree)
    N_basis_functions = int(N_basis_functions)
    order = degree + 1
    n_knots = N_basis_functions + order
    n_distinct = n_knots - 2 * (order - 1)
    if n_distinct < 2:
        raise ValueError("Too few basis functions for this degree.")
    knots = clamped_uniform_knots(order, n_distinct)
    return _DeBoorBSpline(
        N_coeff=2 * N_basis_functions,
        tf=float(tf),
        knot_vector=jnp.asarray(knots),
        degree=degree,
        N_basis_functions=N_basis_functions,
        N_distinct_knots=n_distinct,
    )


def GeneralBSplineControl(degree, N_knots, tf):
    """Arbitrary-degree B-spline over ``N_knots`` uniform distinct knots on
    [0, tf] (src/Controls/GeneralBSplineControl.jl:1-22):
    ``N_basis = degree + N_knots - 1`` per quadrature."""
    degree = int(degree)
    n_distinct = int(N_knots)
    order = degree + 1
    n_basis = order + n_distinct - 2
    knots = clamped_uniform_knots(order, n_distinct)
    return _DeBoorBSpline(
        N_coeff=2 * n_basis,
        tf=float(tf),
        knot_vector=jnp.asarray(knots),
        degree=degree,
        N_basis_functions=n_basis,
        N_distinct_knots=n_distinct,
    )
