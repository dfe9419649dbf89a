"""Piecewise-Hermite interpolant controls (reference ``HermiteControl``,
src/Controls/hermite_control.jl, and ``HermiteCarrierControl``,
src/Controls/hermite_carrier.jl).

The pulse is the degree-(2m+1) Hermite interpolating polynomial of the value
and first ``m = N_derivatives`` derivatives at ``N_points`` evenly spaced
control points; pcof holds that (scaled) derivative data, laid out as
``reshape((1+m, N_points))`` per quadrature, p-half then q-half
(hermite_control.jl:340-356 ``construct_pcof_from_sample``).

Scaling types (hermite_control.jl:237-252): pcof entry ``(i, n)`` times the
scaling factor equals the *normalized Taylor datum* ``dt^i p^{(i)}(t_n)/i!``:

* ``Taylor``     — factor 1 (pcof stores normalized data directly)
* ``Derivative`` — factor ``dt^i/i!`` (pcof stores raw derivatives)
* ``Heuristic``  — factor ``(i+1)! 2^i`` (reference default)

Formulation: instead of the reference's stateful
interval-caching + polynomial-recentering scheme (its cache is documented as
thread-unsafe, hermite_control.jl:190-193), the interpolation map is a small
constant matrix ``Hmat (2m+2, 2m+2)`` precomputed at construction:
normalized data at the interval ends -> scaled derivatives
``dt^k p^{(k)}(t_c)/k!`` at the interval midpoint. Evaluation is then a
gather + one matvec + a static Taylor evaluation — pure and batchable.

``Hmat`` is built by solving the Hermite two-point interpolation conditions
directly (a structured Vandermonde solve), which is mathematically identical
to the reference's ``Hermite_map!`` recursion (Daniel/hermite_map.jl:1-127).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from .base import Control
from .carrier import CarrierControl


def _static():
    return field(metadata=dict(static=True))


def hermite_interp_map(m: int, xc: float = 0.5) -> np.ndarray:
    """Matrix mapping two-point normalized Hermite data to scaled derivatives
    at ``xc`` (in the unit-interval coordinate).

    Input ordering: ``[p^{(j)}(0)/j! for j=0..m] ++ [p^{(j)}(1)/j! for j=0..m]``.
    Output row ``k``: ``p^{(k)}(xc)/k!`` of the unique degree-(2m+1)
    interpolant, ``k = 0..2m+1``.

    Equivalent to ``Hermite_map!(m, 0, 1, xc, 0)`` (Daniel/hermite_map.jl).
    """
    n = 2 * m + 2
    # Interpolation conditions on monomial coefficients a_k of p(x) = sum a_k x^k:
    #   p^{(j)}(0)/j! = a_j
    #   p^{(j)}(1)/j! = sum_k C(k, j) a_k
    V = np.zeros((n, n))
    for j in range(m + 1):
        V[j, j] = 1.0
        for k in range(n):
            if k >= j:
                V[m + 1 + j, k] = math.comb(k, j)
    A = np.linalg.solve(V, np.eye(n))
    # Recenter to xc: b_k = p^{(k)}(xc)/k! = sum_j C(j, k) a_j xc^(j-k)
    R = np.zeros((n, n))
    for k in range(n):
        for j in range(k, n):
            R[k, j] = math.comb(j, k) * xc ** (j - k)
    return R @ A


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class _Hermite(Control):
    Hmat: jnp.ndarray           # (2m+2, 2m+2)
    scaling: jnp.ndarray        # (1+m,) per-derivative pcof scaling factors
    N_points: int = _static()
    N_derivatives: int = _static()

    @property
    def dt(self) -> float:
        return self.tf / (self.N_points - 1)

    def _midpoint_coeffs(self, t, coeffs):
        """Polynomial coefficients ``b_k = dt^k p^{(k)}(t_c)/k!`` in the
        normalized coordinate ``tau = (t - t_c)/dt`` for the interval
        containing ``t``; returns (b (2m+2,), tau)."""
        nd1 = self.N_derivatives + 1
        dt = self.dt
        i = jnp.clip(jnp.floor(t / dt).astype(jnp.int32), 0, self.N_points - 2)
        data_n = jax.lax.dynamic_slice(coeffs, (i * nd1,), (nd1,))
        data_np1 = jax.lax.dynamic_slice(coeffs, ((i + 1) * nd1,), (nd1,))
        data = jnp.concatenate([data_n * self.scaling,
                                data_np1 * self.scaling])
        b = self.Hmat @ data
        t_center = (i.astype(jnp.float64) + 0.5) * dt
        tau = (t - t_center) / dt
        return b, tau

    def _derivative_table(self, t, coeffs, m_out: int):
        """``(m_out,)`` scaled derivatives ``p^{(k)}(t)/k!`` via the static
        Taylor evaluation ``p^{(k)}(t)/k! = dt^{-k} sum_j C(j,k) b_j tau^{j-k}``."""
        b, tau = self._midpoint_coeffs(t, coeffs)
        n = b.shape[0]
        dt = self.dt
        out = []
        for k in range(m_out):
            if k >= n:
                out.append(jnp.zeros_like(tau))
                continue
            acc = b[n - 1] * math.comb(n - 1, k)
            for j in range(n - 2, k - 1, -1):
                acc = acc * tau + b[j] * math.comb(j, k)
            out.append(acc / dt ** k)
        return jnp.stack(out)

    def _half(self, pcof, which: int):
        h = self.N_coeff // 2
        return pcof[:h] if which == 0 else pcof[h:]

    def p(self, t, pcof):
        return self._derivative_table(t, self._half(pcof, 0), 1)[0]

    def q(self, t, pcof):
        return self._derivative_table(t, self._half(pcof, 1), 1)[0]

    def p_derivatives(self, t, pcof, m: int):
        return self._derivative_table(t, self._half(pcof, 0), m)

    def q_derivatives(self, t, pcof, m: int):
        return self._derivative_table(t, self._half(pcof, 1), m)


def HermiteControl(N_points, tf, N_derivatives, scaling_type: str = "Heuristic"):
    """Hermite-interpolant control (hermite_control.jl:20-100)."""
    N_points = int(N_points)
    N_derivatives = int(N_derivatives)
    if N_points < 2:
        raise ValueError("N_points must be > 1")
    dt = float(tf) / (N_points - 1)
    if scaling_type == "Taylor":
        scaling = [1.0] * (N_derivatives + 1)
    elif scaling_type == "Derivative":
        scaling = [dt ** i / math.factorial(i) for i in range(N_derivatives + 1)]
    elif scaling_type == "Heuristic":
        scaling = [math.factorial(i + 1) * 2.0 ** i
                   for i in range(N_derivatives + 1)]
    else:
        raise ValueError(f"Unknown scaling_type {scaling_type!r}")
    return _Hermite(
        N_coeff=2 * N_points * (N_derivatives + 1),
        tf=float(tf),
        Hmat=jnp.asarray(hermite_interp_map(N_derivatives)),
        scaling=jnp.asarray(scaling, dtype=jnp.float64),
        N_points=N_points,
        N_derivatives=N_derivatives,
    )


def HermiteCarrierControl(N_points, tf, N_derivatives, carrier_frequencies,
                          scaling_type: str = "Taylor"):
    """Hermite interpolants modulated by carrier waves
    (src/Controls/hermite_carrier.jl) — realized as
    ``CarrierControl(HermiteControl(...))``; one Hermite parameter block per
    carrier frequency, product-rule derivatives handled by the carrier
    wrapper's Cauchy-product tables."""
    base = HermiteControl(N_points, tf, N_derivatives, scaling_type)
    return CarrierControl(base, carrier_frequencies)


def sample_from_controls(controls_orig, pcof_orig, N_samples, N_derivatives,
                         scaling_type: str = "Derivative"):
    """Build Hermite controls sampling an existing control set
    (hermite_control.jl:361-381): one Hermite control per original control,
    pcofs concatenated. Returns (controls_new, pcof_new)."""
    import jax.numpy as jnp

    from .base import as_control_tuple, control_vector_slice

    controls_orig = as_control_tuple(controls_orig)
    new_controls = []
    new_pcofs = []
    for i, ctrl in enumerate(controls_orig):
        local = control_vector_slice(jnp.asarray(pcof_orig), controls_orig, i)
        hc = HermiteControl(N_samples, ctrl.tf, N_derivatives, scaling_type)
        new_controls.append(hc)
        new_pcofs.append(np.asarray(construct_pcof_from_sample(ctrl, local,
                                                               hc)))
    return new_controls, jnp.asarray(np.concatenate(new_pcofs))


def construct_pcof_from_sample(control_orig, pcof_orig, hermite_control):
    """Sample an existing control's values/derivatives at the Hermite control
    points to build an equivalent Hermite pcof
    (hermite_control.jl:340-356). Only supports ``Taylor``-free scalings by
    inverting the scaling factors."""
    from .base import eval_p_derivative, eval_q_derivative

    inner = hermite_control
    # unwrap carrier if present
    if hasattr(inner, "base_control"):
        inner = inner.base_control
    nd1 = inner.N_derivatives + 1
    n_pts = inner.N_points
    scaling = np.asarray(inner.scaling)
    dt = inner.dt
    halves = []
    for which in ("p", "q"):
        blocks = []
        for n in range(n_pts):
            t = n * dt
            col = []
            for j in range(nd1):
                if which == "p":
                    val = eval_p_derivative(control_orig, t, pcof_orig, j)
                else:
                    val = eval_q_derivative(control_orig, t, pcof_orig, j)
                # pcof entry * scaling = dt^j f^(j)/j!  =>  entry = dt^j f^(j) / (j! scaling)
                col.append(float(val) * dt ** j / (math.factorial(j) * scaling[j]))
            blocks.append(col)
        halves.append(np.asarray(blocks).reshape(-1))
    return jnp.asarray(np.concatenate(halves))
