"""Newton–Schulz batched stage solver (``solver="schulz"``) — the
matmul-only implicit-stage solve of the f32 production configuration
(see qgd_tpu/ops/linalg.py). Must agree with the exact LU
path to near-f64 and survive vmap + AD."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qgd_tpu
from qgd_tpu.adjoint import objective_and_gradient, discrete_adjoint
from qgd_tpu.ops.linalg import (
    schulz_inverse_auto,
    inverse_stage_solve,
)


def _cnot_like(nsteps):
    prob = qgd_tpu.models.rotating_frame_qubit(
        4, 2, tf=3.0, nsteps=nsteps, detuning_frequency=0.7,
        self_kerr_coefficient=0.3)
    control = qgd_tpu.BSpline2Control(5, 3.0)
    rng = np.random.default_rng(3)
    pcof = jnp.asarray(rng.standard_normal(10) * 0.3)
    N = prob.N_tot_levels
    tgt = jnp.asarray(rng.standard_normal((N, 4))
                      + 1j * rng.standard_normal((N, 4)))
    return prob, control, pcof, tgt


def test_schulz_inverse_accuracy():
    rng = np.random.default_rng(0)
    A = np.eye(16) + 0.3 * rng.standard_normal((16, 16))
    # default budget (56 total from the universal init) reaches the f32 floor
    X = schulz_inverse_auto(jnp.asarray(A))
    assert np.max(np.abs(np.asarray(X) @ A - np.eye(16))) < 1e-4   # f32 floor
    b = jnp.asarray(rng.standard_normal((16, 3)))
    x = inverse_stage_solve(jnp.asarray(A), X, b)
    assert np.max(np.abs(A @ np.asarray(x) - np.asarray(b))) < 1e-13


def test_schulz_warm_start_matches_cold():
    """A drift-like warm start reaches the same f32-accurate inverse with
    the reduced warm budget (the in-scan fallback path, forward.py)."""
    rng = np.random.default_rng(1)
    A0 = np.eye(16) + 0.1 * rng.standard_normal((16, 16))   # "drift" stage
    A = A0 + 0.02 * rng.standard_normal((16, 16))           # + control term
    X0 = schulz_inverse_auto(jnp.asarray(A0))
    Xw = schulz_inverse_auto(jnp.asarray(A), X0=X0)
    assert np.max(np.abs(np.asarray(Xw) @ A - np.eye(16))) < 1e-4
    b = jnp.asarray(rng.standard_normal((16, 3)))
    x = inverse_stage_solve(jnp.asarray(A), Xw, b)
    assert np.max(np.abs(A @ np.asarray(x) - np.asarray(b))) < 1e-13


@pytest.mark.parametrize("order", [2, 4, 8])
def test_schulz_matches_lu_forward_and_gradient(order):
    prob, control, pcof, tgt = _cnot_like(40)
    ps = dataclasses.replace(prob, solver="schulz")
    h_lu = qgd_tpu.eval_forward(prob, control, pcof, order)
    h_s = qgd_tpu.eval_forward(ps, control, pcof, order)
    assert np.max(np.abs(np.asarray(h_lu - h_s))) < 1e-12

    (j1, g, _), gr_lu = objective_and_gradient(prob, control, pcof, tgt, order)
    (j1s, gs, _), gr_s = objective_and_gradient(ps, control, pcof, tgt, order)
    assert abs(float(j1 + g - j1s - gs)) < 1e-12
    scale = np.max(np.abs(np.asarray(gr_lu)))
    assert np.max(np.abs(np.asarray(gr_lu - gr_s))) / scale < 1e-11


def test_schulz_vmapped_scenarios():
    """The bench shape: vmap over pcof scenarios."""
    prob, control, pcof, tgt = _cnot_like(20)
    ps = dataclasses.replace(prob, solver="schulz")
    rng = np.random.default_rng(9)
    pcofs = jnp.asarray(rng.standard_normal((3, 10)) * 0.2)

    def one(solver_prob):
        def f(pc):
            (j1, g, _), gr = objective_and_gradient(
                solver_prob, control, pc, tgt, 4)
            return j1 + g, gr
        return jax.jit(jax.vmap(f))(pcofs)

    obj_lu, gr_lu = one(prob)
    obj_s, gr_s = one(ps)
    np.testing.assert_allclose(np.asarray(obj_s), np.asarray(obj_lu),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(gr_s), np.asarray(gr_lu),
                               rtol=0, atol=1e-10)


def test_schulz_adjoint_vs_forced_exactness():
    """The reference's exactness gate holds on the schulz path itself."""
    prob, control, pcof, tgt = _cnot_like(10)
    ps = dataclasses.replace(prob, solver="schulz")
    ga = discrete_adjoint(ps, control, pcof, tgt, 4)
    gf = qgd_tpu.eval_grad_forced(ps, control, pcof, tgt, 4)
    scale = np.max(np.abs(np.asarray(gf)))
    assert np.max(np.abs(np.asarray(ga - gf))) / scale < 1e-12


def test_matmul_precision_default_is_highest():
    """qgd_tpu must pin jax_default_matmul_precision to "highest": the
    GPU's "default" f32 matmul is TF32 (~3 decimal digits), which gives
    every stage solve a biased ~1e-3 per-step error that grows without
    bound over long horizons. CPU numerics are unaffected by the flag —
    this guards the config."""
    import os

    if "QGD_MATMUL_PRECISION" in os.environ:
        pytest.skip("user override active")
    assert jax.config.jax_default_matmul_precision == "highest"


def test_schulz_low_precision_construction_refines_to_f64():
    """The stage solve must stay f64-accurate even when the Newton-Schulz
    construction itself runs at reduced matmul precision (TF32
    construction + full-precision refinement on the GPU). On CPU the
    precision flag is a no-op, so emulate a low-quality inverse by
    truncating the iteration budget to the reduced-precision regime."""
    rng = np.random.default_rng(2)
    A0 = np.eye(16) + 0.1 * rng.standard_normal((16, 16))
    A = A0 + 0.02 * rng.standard_normal((16, 16))
    X0 = schulz_inverse_auto(jnp.asarray(A0))
    # 2 warm iterations: inverse only good to ~1e-3 (TF32-like quality)
    Xc = schulz_inverse_auto(jnp.asarray(A), X0=X0, warm_iters=2,
                             precision="default")
    resid = np.max(np.abs(np.asarray(Xc) @ A - np.eye(16)))
    assert 1e-8 < resid < 0.05, resid    # genuinely crude inverse
    b = jnp.asarray(rng.standard_normal((16, 3)))
    x = inverse_stage_solve(jnp.asarray(A), Xc, b)
    # refinement sweeps contract resid^(1+refine_iters) -> f64-level solve
    assert np.max(np.abs(A @ np.asarray(x) - np.asarray(b))) < 1e-12


def test_schulz_warm_start_diverging_falls_back():
    """A warm start outside the Newton-Schulz convergence radius
    (||I - M X0|| >= 1, e.g. the drift-only inverse at very coarse dt with
    strong controls) must fall back to the universal init per matrix and
    return a finite, refinable inverse instead of diverging to NaN."""
    rng = np.random.default_rng(7)
    A = np.eye(16) + 0.3 * rng.standard_normal((16, 16))
    X0_bad = jnp.asarray(5.0 * rng.standard_normal((16, 16)))  # way off
    X = schulz_inverse_auto(jnp.asarray(A), X0=X0_bad, warm_iters=40)
    assert np.all(np.isfinite(np.asarray(X)))
    b = jnp.asarray(rng.standard_normal((16, 3)))
    x = inverse_stage_solve(jnp.asarray(A), X, b)
    assert np.max(np.abs(A @ np.asarray(x) - np.asarray(b))) < 1e-10
    # batched: one good warm start, one bad — each resolved independently
    Ab = jnp.stack([jnp.asarray(A), jnp.asarray(A)])
    X0b = jnp.stack([jnp.asarray(np.linalg.inv(A)), X0_bad])
    Xb = schulz_inverse_auto(Ab, X0=X0b, warm_iters=40)
    assert np.all(np.isfinite(np.asarray(Xb)))
    resid = np.max(np.abs(np.asarray(Xb) @ A - np.eye(16)), axis=(1, 2))
    assert resid[0] < 1e-4 and resid[1] < 1e-2, resid
