"""f32 propagation mode (the fast optimization path): forward and gradients
must track the f64 reference to single-precision accuracy, and optimization
must still converge to optimization-grade infidelities."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import qgd_tpu
from qgd_tpu import eval_forward, discrete_adjoint, BSpline2Control
from qgd_tpu.models.builders import construct_rabi_prob, rotating_frame_qubit


def _f32(prob):
    return dataclasses.replace(prob, dtype="float32")


def test_forward_f32_tracks_f64():
    prob = rotating_frame_qubit(3, 1, tf=1.0, nsteps=100,
                                detuning_frequency=0.4,
                                self_kerr_coefficient=0.2)
    ctrl = BSpline2Control(5, 1.0)
    pcof = jnp.asarray(np.linspace(-0.3, 0.4, 10))
    h64 = np.asarray(eval_forward(prob, ctrl, pcof, 4))
    h32 = np.asarray(eval_forward(_f32(prob), ctrl, pcof, 4))
    assert h32.dtype == np.float32
    assert np.abs(h32 - h64).max() < 5e-5


def test_gradient_f32_tracks_f64():
    prob = construct_rabi_prob(nsteps=50)
    ctrl = BSpline2Control(4, float(prob.tf))
    rng = np.random.default_rng(0)
    pcof = jnp.asarray(rng.standard_normal(8) * 0.3)
    tgt = jnp.asarray(rng.standard_normal((2, 2))
                      + 1j * rng.standard_normal((2, 2)))
    g64 = np.asarray(discrete_adjoint(prob, ctrl, pcof, tgt, 4))
    g32 = np.asarray(discrete_adjoint(_f32(prob), ctrl, pcof, tgt, 4))
    scale = max(1.0, np.abs(g64).max())
    assert np.abs(g32 - g64).max() < 2e-4 * scale


def test_optimize_f32_converges():
    prob = _f32(construct_rabi_prob(nsteps=40))
    ctrl = qgd_tpu.GRAPEControl(1, float(prob.tf))
    target = np.array([[0, 1], [1, 0]], dtype=complex)
    hist = qgd_tpu.optimize_gate(
        prob, ctrl, jnp.asarray([0.42, 0.08]), target, order=4,
        ridge_penalty_strength=0.0, maxIter=60, print_level=0,
        stop_objective=1e-6)
    # f32 floor is ~1e-6 in the objective; amplitude still lands on 0.5
    assert hist.obj_value[hist.best_index] < 1e-5
    assert abs(np.hypot(*hist.best_pcof) - 0.5) < 5e-3
