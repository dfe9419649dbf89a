"""Control-function unit tests (reference
test/ControlFunctionTests/test_control_derivatives.jl and
test_control_gradients.jl): analytic/AD derivative tables vs central finite
differences in t, and pcof-gradients vs finite differences in pcof."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qgd_tpu import (
    GRAPEControl,
    GeneralGRAPEControl,
    SinCosControl,
    SquaredAmpCosControl,
    BSpline2Control,
    BSplineControl,
    CarrierControl,
    GeneralBSplineControl,
    FortranBSplineControl,
    HermiteControl,
    HermiteCarrierControl,
    eval_p_derivative,
    eval_q_derivative,
    eval_grad_p_derivative,
)

TF = 2.0


def _controls():
    rng = np.random.default_rng(3)
    cases = []
    for name, ctrl in [
        ("grape", GRAPEControl(4, TF)),
        ("gen_grape", GeneralGRAPEControl(3, TF, 2)),
        ("sincos", SinCosControl(TF, frequency=1.3)),
        ("sq_cos", SquaredAmpCosControl(TF, frequency=0.9)),
        ("bspline2", BSpline2Control(6, TF)),
        ("bspline2_carrier", CarrierControl(BSpline2Control(5, TF), [1.1, 3.0])),
        ("bcarrier_legacy", BSplineControl(TF, 5, [0.8])),
        ("deboor_d2", FortranBSplineControl(2, 6, TF)),
        ("deboor_d4", FortranBSplineControl(4, 8, TF)),
        ("deboor_d6", FortranBSplineControl(6, 10, TF)),
        ("general_bspline", GeneralBSplineControl(3, 5, TF)),
        ("hermite", HermiteControl(4, TF, 2)),
        ("hermite_carrier", HermiteCarrierControl(3, TF, 2, [1.7])),
    ]:
        pcof = rng.standard_normal(ctrl.N_coeff)
        cases.append((name, ctrl, jnp.asarray(pcof)))
    return cases


CASES = _controls()


def _fd_derivative(f, t, k, h):
    """k-th derivative by nested central differences (richardson-free)."""
    if k == 0:
        return f(t)
    g = lambda tt: _fd_derivative(f, tt, k - 1, h)
    return (g(t + h) - g(t - h)) / (2 * h)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_time_derivatives_vs_fd(case):
    name, ctrl, pcof = next(c for c in CASES if c[0] == case)
    # sample away from knot/region boundaries where piecewise controls jump
    ts = np.linspace(0.013, TF - 0.017, 7)
    max_order = 2
    for order in range(1, max_order + 1):
        h = 1e-5 if order == 1 else 1e-4
        for t in ts:
            exact = float(eval_p_derivative(ctrl, t, pcof, order))
            approx = _fd_derivative(
                lambda tt: float(ctrl.p(jnp.asarray(tt), pcof)), t, order, h)
            tol = 5e-5 * max(1.0, abs(exact))
            assert abs(exact - approx) < tol, (
                f"{name} order={order} t={t}: {exact} vs {approx}")


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_pcof_gradients_vs_fd(case):
    name, ctrl, pcof = next(c for c in CASES if c[0] == case)
    t = 0.37 * TF
    for order in (0, 1):
        g = np.asarray(eval_grad_p_derivative(ctrl, t, pcof, order))
        fd = np.zeros_like(g)
        eps = 1e-6
        pc = np.asarray(pcof)
        for i in range(pc.size):
            pp = pc.copy()
            pp[i] += eps
            fr = float(eval_p_derivative(ctrl, t, jnp.asarray(pp), order))
            pp[i] -= 2 * eps
            fl = float(eval_p_derivative(ctrl, t, jnp.asarray(pp), order))
            fd[i] = (fr - fl) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=1e-4, atol=1e-5)


def test_bspline2_matches_reference_formulas():
    """Spot-check the quadratic B-spline segments against the closed forms
    (src/Controls/bspline_control.jl:140-204)."""
    ctrl = BSpline2Control(5, TF)
    D1 = 5
    dtknot = TF / (D1 - 2)
    width = 3 * dtknot
    pcof = np.zeros(2 * D1)
    pcof[3] = 1.0  # single basis function k=3 (0-based)
    t = 1.1
    # basis 3 (0-based) has center dtknot*(3-0.5)
    tc = dtknot * (3 - 0.5)
    tau = (t - tc) / width
    k1b = int(np.ceil(t / dtknot)) + 2
    k1b = min(max(k1b, 3), D1)
    vals = {k1b - 1: 9 / 8 + 4.5 * tau + 4.5 * tau ** 2,
            k1b - 2: 0.75 - 9 * tau ** 2,
            k1b - 3: 9 / 8 - 4.5 * tau + 4.5 * tau ** 2}
    expected = vals.get(3, 0.0)
    got = float(ctrl.p(jnp.asarray(t), jnp.asarray(pcof)))
    assert abs(got - expected) < 1e-14


def test_hermite_control_reproduces_polynomial():
    """A Hermite control with m derivatives must exactly reproduce any
    polynomial of degree <= 2m+1 (reference hermite_polynomial.jl test)."""
    m = 2
    n_pts = 3
    ctrl = HermiteControl(n_pts, TF, m, scaling_type="Derivative")
    rng = np.random.default_rng(5)
    coeffs = rng.standard_normal(2 * m + 2)  # degree 2m+1 polynomial

    def poly_deriv(t, k):
        return sum(coeffs[j] * math.factorial(j) / math.factorial(j - k)
                   * t ** (j - k) for j in range(k, 2 * m + 2))

    dt = TF / (n_pts - 1)
    pc = np.zeros(ctrl.N_coeff)
    half = ctrl.N_coeff // 2
    for n in range(n_pts):
        for j in range(m + 1):
            # Derivative scaling: pcof holds raw derivatives
            pc[n * (m + 1) + j] = poly_deriv(n * dt, j)
            pc[half + n * (m + 1) + j] = 0.0
    for t in np.linspace(0.05, TF - 0.05, 9):
        got = float(ctrl.p(jnp.asarray(t), jnp.asarray(pc)))
        assert abs(got - poly_deriv(t, 0)) < 1e-10 * max(
            1.0, abs(poly_deriv(t, 0)))
        got1 = float(eval_p_derivative(ctrl, t, jnp.asarray(pc), 1))
        assert abs(got1 - poly_deriv(t, 1)) < 1e-9 * max(
            1.0, abs(poly_deriv(t, 1)))


def test_deboor_partition_of_unity():
    """Clamped B-spline basis sums to 1 everywhere (all-ones coefficients)."""
    for degree, nb in [(2, 6), (3, 7), (5, 9)]:
        ctrl = FortranBSplineControl(degree, nb, TF)
        pcof = jnp.ones(ctrl.N_coeff)
        for t in np.linspace(0.0, TF, 11):
            val = float(ctrl.p(jnp.asarray(t), pcof))
            assert abs(val - 1.0) < 1e-12, (degree, nb, t, val)


def test_carrier_product_rule_high_order():
    """Carrier wrapper's Cauchy-product tables vs Taylor-mode AD of the
    wrapped scalar function (reference test/product_rule.jl)."""
    from qgd_tpu.controls.base import taylor_coefficients

    base = SinCosControl(TF, frequency=0.7)
    ctrl = CarrierControl(base, [1.9])
    pcof = jnp.asarray([0.4, -0.8])
    t = jnp.asarray(0.63)
    m = 5
    table = np.asarray(ctrl.p_derivatives(t, pcof, m))
    ad_table = np.asarray(
        taylor_coefficients(lambda tt: ctrl.p(tt, pcof), t, m))
    np.testing.assert_allclose(table, ad_table, rtol=1e-12, atol=1e-12)


def test_carrier_negative_and_zero_frequencies():
    """Negative and zero carrier frequencies (the CNOT3 sidebands are
    [0, -chi, -chi']) — both the p/q tables and the pcof gradient. Guards
    the real-arithmetic Cauchy product's integer frequency powers, which
    must not lower to pow(negative, float) (NaN on some backends)."""
    from qgd_tpu.controls.base import taylor_coefficients

    base = SinCosControl(TF, frequency=0.7)
    ctrl = CarrierControl(base, [0.0, -1.3])
    pcof = jnp.asarray([0.4, -0.8, 0.25, 0.6])
    t = jnp.asarray(0.63)
    m = 5
    for which in ("p", "q"):
        table = np.asarray(getattr(ctrl, which + "_derivatives")(t, pcof, m))
        ad_table = np.asarray(taylor_coefficients(
            lambda tt: getattr(ctrl, which)(tt, pcof), t, m))
        np.testing.assert_allclose(table, ad_table, rtol=1e-12, atol=1e-12,
                                   err_msg=which)
        assert np.all(np.isfinite(table))
    g = np.asarray(jax.grad(lambda pc: ctrl.p(t, pc))(pcof))
    eps = 1e-6
    for i in range(4):
        e = np.zeros(4)
        e[i] = eps
        fd = (float(ctrl.p(t, pcof + e)) - float(ctrl.p(t, pcof - e))) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=1e-8, atol=1e-10)
