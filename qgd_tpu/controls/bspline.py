"""Quadratic B-spline control (reference ``BSpline2Control``,
src/Controls/bspline_control.jl:21-270).

Uniform-knot quadratic B-spline with ``D1`` basis functions per quadrature
(p and q each get ``D1`` coefficients; ``pcof = [p-coeffs; q-coeffs]``).
Knot spacing ``dtknot = tf/(D1-2)``, centers ``tcenter[k] = dtknot*(k - 0.5)``
for ``k = 0..D1-1`` (0-based; reference line 38-39 uses 1-based
``dtknot*(k-1.5)``).

At any ``t`` exactly three basis functions are non-zero (segments of splines
``k, k-1, k-2`` where ``k = clip(ceil(t/dtknot) + 1, 2, D1-1)`` 0-based);
their closed-form values/derivatives are the three quadratic segments
(reference ``bspline2``, lines 140-204). Derivatives of order > 2 are zero.

Vectorized: the 3-tap gather + closed form is evaluated vectorized over the
whole timestep grid; gradients w.r.t. pcof flow through the gather by AD
(the scatter transpose XLA generates is exactly the reference's
3-nonzero-entry ``gradbspline2!``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp

from .base import Control


def _static():
    return field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _BSpline2(Control):
    D1: int = _static()

    @property
    def dtknot(self) -> float:
        return self.tf / (self.D1 - 2)

    def _segment_values(self, t, derivative_order: int):
        """Returns (k, vals) with ``vals[0..2]`` the contributions of splines
        ``k, k-1, k-2`` (0-based indices into a D1-length coefficient slice)."""
        dtknot = self.dtknot
        width = 3.0 * dtknot
        # reference: k = clamp(ceil(t/dtknot) + 2, 3, D1), 1-based (line 152)
        k = jnp.ceil(t / dtknot).astype(jnp.int32) + 2
        k = jnp.clip(k, 3, self.D1)  # still 1-based
        k0 = k - 1  # 0-based index of the leading spline

        def tau(offset):
            # tcenter (0-based index j) = dtknot * (j - 0.5)
            tc = dtknot * (k0.astype(jnp.float64) - offset - 0.5)
            return (t - tc) / width

        t0, t1, t2 = tau(0.0), tau(1.0), tau(2.0)
        if derivative_order == 0:
            vals = jnp.stack([
                9.0 / 8.0 + 4.5 * t0 + 4.5 * t0 ** 2,
                0.75 - 9.0 * t1 ** 2,
                9.0 / 8.0 - 4.5 * t2 + 4.5 * t2 ** 2,
            ])
        elif derivative_order == 1:
            vals = jnp.stack([
                (4.5 + 9.0 * t0) / width,
                (-18.0 * t1) / width,
                (-4.5 + 9.0 * t2) / width,
            ])
        elif derivative_order == 2:
            vals = jnp.stack([
                jnp.full_like(t0, 9.0 / width ** 2),
                jnp.full_like(t1, -18.0 / width ** 2),
                jnp.full_like(t2, 9.0 / width ** 2),
            ])
        else:
            vals = jnp.zeros((3,), dtype=jnp.float64) * t0
        return k0, vals

    def _eval(self, t, coeffs, derivative_order: int):
        k0, vals = self._segment_values(t, derivative_order)
        taps = jnp.stack([coeffs[k0], coeffs[k0 - 1], coeffs[k0 - 2]])
        return jnp.sum(vals * taps)

    def p(self, t, pcof):
        return self._eval(t, pcof[:self.D1], 0)

    def q(self, t, pcof):
        return self._eval(t, pcof[self.D1:], 0)

    def p_derivatives(self, t, pcof, m: int):
        coeffs = pcof[:self.D1]
        return jnp.stack([
            self._eval(t, coeffs, k) / math.factorial(k) for k in range(m)
        ])

    def q_derivatives(self, t, pcof, m: int):
        coeffs = pcof[self.D1:]
        return jnp.stack([
            self._eval(t, coeffs, k) / math.factorial(k) for k in range(m)
        ])


def BSpline2Control(D1, tf):
    """Quadratic B-spline control with ``D1 >= 3`` coefficients per pulse
    quadrature (src/Controls/bspline_control.jl:28-43)."""
    D1 = int(D1)
    if D1 < 3:
        raise ValueError(
            f"Number of coefficients per spline (D1 = {D1}) must be >= 3.")
    return _BSpline2(N_coeff=2 * D1, tf=float(tf), D1=D1)
