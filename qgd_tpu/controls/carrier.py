"""Carrier-wave wrapper: any base control modulated by a set of carrier
frequencies (reference ``CarrierControl``, src/Controls/CarrierControl.jl).

With complex envelope ``e_f(t) = p_f(t) + i q_f(t)`` (one base-control
parameter block per frequency) and carrier ``c_f(t) = exp(i w_f t)``, the
wrapped pulse is ``P + iQ = sum_f e_f(t) c_f(t)`` — this reproduces the
reference's k=0 case (CarrierControl.jl:100-117)::

    P = sum_f [ p_f cos(w t) - q_f sin(w t) ]
    Q = sum_f [ p_f sin(w t) + q_f cos(w t) ]

Scaled derivative tables follow by the Cauchy-product rule on scaled Taylor
coefficients (the reference's explicit binomial product rule,
CarrierControl.jl:94-146, in coefficient form)::

    (e c)^{(k)}/k! = sum_{j<=k} (e^{(j)}/j!) ((i w)^{k-j}/(k-j)!) c
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
class _Carrier(Control):
    base_control: Control
    carrier_frequencies: jnp.ndarray  # (N_freq,)
    N_freq: int = _static()

    @property
    def N_coeffs_per_frequency(self) -> int:
        return self.base_control.N_coeff

    def _tables(self, t, pcof, m: int):
        """(P_table, Q_table) each (m,).

        Pure REAL arithmetic (no complex dtypes inside jit), so the scaled carrier derivatives ``(i w)^k/k! e^{iwt}`` are built
        from their real/imaginary quarter-phase cycle and the Cauchy
        product becomes two small lower-triangular real matmuls — the
        reference's explicit real product rule (CarrierControl.jl:94-146,
        hermite_carrier.jl fill_coswt/sinwt_derivatives!).
        """
        npc = self.base_control.N_coeff
        ks = jnp.arange(m)
        fact = jnp.asarray([math.factorial(k) for k in range(m)],
                           dtype=jnp.float64)
        # lower-triangular Cauchy-product index map: T[k, j] = g(k - j)
        d = ks[:, None] - ks[None, :]
        tri = d >= 0
        dc = jnp.clip(d, 0)
        # One vmap over the frequency axis instead of a Python-unrolled
        # loop: the loop re-embedded the whole per-frequency subgraph
        # (spline evals + Cauchy products) N_freq times in the HLO, costing
        # trace time and program size at every new shape (round-3/4 weak
        # item; measured at the flagship shape in round 5).
        locals_ = pcof.reshape(self.N_freq, npc)

        def per_freq(w, local):
            ep = self.base_control.p_derivatives(t, local, m)
            eq = self.base_control.q_derivatives(t, local, m)
            # i^k e^{iwt} cycles through (cos, -sin, -cos, sin) + i*(...)
            th = w * t
            c, s = jnp.cos(th), jnp.sin(th)
            re4 = jnp.stack([c, -s, -c, s])
            im4 = jnp.stack([s, c, -s, -c])
            # integer powers w^k by cumprod, NOT ``w ** ks``: the int
            # exponent promotes to f64, and pow(negative base, float
            # exponent) may lower to NaN (carrier frequencies are negative)
            wpow = jnp.concatenate([jnp.ones((1,), dtype=jnp.float64),
                                    jnp.cumprod(jnp.full((m - 1,), w))])
            scale = wpow / fact
            cr = scale * re4[ks % 4]     # Re[(i w)^k/k! e^{iwt}]
            ci = scale * im4[ks % 4]     # Im[...]
            Cr = jnp.where(tri, cr[dc], 0.0)
            Ci = jnp.where(tri, ci[dc], 0.0)
            # (ep + i eq) * (cr + i ci), truncated Cauchy product
            return Cr @ ep - Ci @ eq, Ci @ ep + Cr @ eq

        Pf, Qf = jax.vmap(per_freq)(self.carrier_frequencies, locals_)
        return jnp.sum(Pf, axis=0), jnp.sum(Qf, axis=0)

    def p(self, t, pcof):
        return self._tables(t, pcof, 1)[0][0]

    def q(self, t, pcof):
        return self._tables(t, pcof, 1)[1][0]

    def p_derivatives(self, t, pcof, m: int):
        return self._tables(t, pcof, m)[0]

    def q_derivatives(self, t, pcof, m: int):
        return self._tables(t, pcof, m)[1]


def CarrierControl(base_control: Control, carrier_frequencies):
    """Wrap ``base_control`` with carrier waves; pcof is one base-control
    block per frequency, concatenated (CarrierControl.jl:12-31)."""
    freqs = jnp.asarray(carrier_frequencies, dtype=jnp.float64)
    n_freq = int(freqs.shape[0])
    return _Carrier(
        N_coeff=base_control.N_coeff * n_freq,
        tf=base_control.tf,
        base_control=base_control,
        carrier_frequencies=freqs,
        N_freq=n_freq,
    )
