"""Prefix-product propagator (qgd_tpu/prefix.py) vs the scan paths.

The prefix route must reproduce the serial propagation and the Lagrange
gradient exactly (f64, exact inverses) / to f32-drift tolerance (f32,
Schulz effective inverses) — same acceptance logic as the segmented path
(reference gradient gates: test/GradientTests/compare_gradients.jl:47-48).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import qgd_tpu
from qgd_tpu.forward import eval_forward
from qgd_tpu.prefix import eval_forward_prefix, prefix_objective_and_gradient
from qgd_tpu.segmented import segmented_objective_and_gradient


@pytest.fixture(scope="module")
def cnot3_setup():
    prob = qgd_tpu.models.cnot3_problem(nsteps=128)
    ctrls = tuple(qgd_tpu.BSpline2Control(10, float(prob.tf))
                  for _ in range(3))
    rng = np.random.default_rng(0)
    pcof = jnp.asarray(rng.standard_normal(60) * 0.01)
    rng2 = np.random.default_rng(1)
    tgt = rng2.standard_normal((64, 8)) + 1j * rng2.standard_normal((64, 8))
    return prob, ctrls, pcof, tgt


@pytest.mark.parametrize("order", [2, 4, 6])
def test_prefix_forward_matches_scan_f64(cnot3_setup, order):
    prob, ctrls, pcof, _ = cnot3_setup
    h_ref = eval_forward(prob, ctrls, pcof, order)
    h_pfx = eval_forward_prefix(prob, ctrls, pcof, order, n_segments=4)
    np.testing.assert_allclose(np.asarray(h_pfx), np.asarray(h_ref),
                               atol=1e-12)


@pytest.mark.parametrize("order", [2, 4])
def test_prefix_gradient_matches_segmented_f64(cnot3_setup, order):
    prob, ctrls, pcof, tgt = cnot3_setup
    (o_ref, g_ref) = segmented_objective_and_gradient(
        prob, ctrls, pcof, tgt, order, n_segments=4)
    (o_pfx, g_pfx) = prefix_objective_and_gradient(
        prob, ctrls, pcof, tgt, order, n_segments=4)
    assert abs(float(o_pfx[0] - o_ref[0])) < 1e-12
    assert abs(float(o_pfx[1] - o_ref[1])) < 1e-12
    rel = float(jnp.linalg.norm(g_pfx - g_ref) / jnp.linalg.norm(g_ref))
    assert rel < 1e-12


def test_prefix_gradient_f32_schulz(cnot3_setup):
    """f32 + Schulz effective inverses (the f32 production configuration,
    traced on CPU): agreement at the documented f32-drift scale."""
    prob, ctrls, pcof, tgt = cnot3_setup
    (o_ref, g_ref) = segmented_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4, n_segments=4)
    prob32 = dataclasses.replace(prob, solver="schulz", dtype="float32",
                                 schulz_iters=48)
    (o32, g32) = prefix_objective_and_gradient(
        prob32, ctrls, pcof, tgt, 4, n_segments=4)
    assert abs(float(o32[0] + o32[1]) - float(o_ref[0] + o_ref[1])) < 1e-4
    rel = float(jnp.linalg.norm(g32 - g_ref) / jnp.linalg.norm(g_ref))
    assert rel < 1e-3


def test_prefix_ridge_and_auto_segments(cnot3_setup):
    prob, ctrls, pcof, tgt = cnot3_setup
    (parts, grad) = prefix_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4, ridge_penalty_strength=1e-2)
    (parts_ref, grad_ref) = segmented_objective_and_gradient(
        prob, ctrls, pcof, tgt, 4, ridge_penalty_strength=1e-2)
    assert abs(float(parts[2] - parts_ref[2])) < 1e-14
    np.testing.assert_allclose(np.asarray(grad), np.asarray(grad_ref),
                               atol=1e-10)


def test_prefix_bad_segments_raises(cnot3_setup):
    prob, ctrls, pcof, tgt = cnot3_setup
    with pytest.raises(ValueError):
        prefix_objective_and_gradient(prob, ctrls, pcof, tgt, 4,
                                      n_segments=7)
