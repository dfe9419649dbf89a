"""End-to-end optimization test (reference
test/OptimizationTests/optimization_rabi_osc_SWAP.jl:15-45): the Rabi
oscillator SWAP gate has analytic optimum pcof = [0.5, 0]; from nearby
starts, ``optimize_gate`` (order 8) must recover it."""

import numpy as np
import jax.numpy as jnp
import pytest

import qgd_tpu
from qgd_tpu import construct_rabi_prob, GRAPEControl, optimize_gate


def _swap_target():
    # SWAP in this 2-level convention: |0> <-> |1| (columns swapped identity);
    # the evolution at amplitude 0.5 reaches it up to the -i global phase,
    # which the |tr|^2 infidelity ignores.
    return np.array([[0.0, 1.0], [1.0, 0.0]], dtype=np.complex128)


@pytest.mark.parametrize("start", [
    [0.4, 0.1], [0.62, -0.1], [0.45, 0.0],
])
def test_rabi_swap_recovers_analytic_optimum(start):
    prob = construct_rabi_prob(nsteps=40)
    control = GRAPEControl(1, float(prob.tf))
    target = _swap_target()
    hist = optimize_gate(
        prob, control, jnp.asarray(start), target, order=8,
        ridge_penalty_strength=0.0, maxIter=100, print_level=0)
    best = hist.best_pcof
    assert hist.obj_value[hist.best_index] < 1e-7
    # |amplitude| must be 0.5 up to rtol 5e-4 (reference :28-39); the
    # optimum is a circle p^2+q^2=0.25, reachable anywhere on it.
    amp = np.hypot(best[0], best[1])
    assert abs(amp - 0.5) < 5e-4


def test_history_records_and_roundtrip(tmp_path):
    prob = construct_rabi_prob(nsteps=20)
    control = GRAPEControl(1, float(prob.tf))
    hist = optimize_gate(
        prob, control, jnp.asarray([0.4, 0.05]), _swap_target(), order=4,
        maxIter=3, print_level=0, filename=str(tmp_path / "ckpt"))
    assert len(hist.obj_value) >= 3
    assert "min objective" in hist.summary()
    loaded = qgd_tpu.OptimizationHistory.load(str(tmp_path / "ckpt"))
    assert loaded.obj_value[:3] == hist.obj_value[:3]
    np.testing.assert_allclose(loaded.pcof[0], hist.pcof[0])


def test_ridge_term_included():
    prob = construct_rabi_prob(nsteps=20)
    control = GRAPEControl(1, float(prob.tf))
    pcof = jnp.asarray([0.4, 0.05])
    lam = 1e-2
    j1, guard, ridge = qgd_tpu.objective.objective_parts(
        prob, control, pcof, _swap_target(), 4, ridge_penalty_strength=lam)
    expected = lam * float(pcof @ pcof) / pcof.size
    assert abs(float(ridge) - expected) < 1e-15


def test_gradient_descent_decreases_objective():
    prob = construct_rabi_prob(nsteps=20)
    control = GRAPEControl(1, float(prob.tf))
    target = _swap_target()
    p0 = jnp.asarray([0.42, 0.03])
    from qgd_tpu.objective import infidelity_plus_guard
    before = float(infidelity_plus_guard(prob, control, p0, target, order=4))
    p1 = qgd_tpu.gradient_descent(prob, control, p0, target, order=4,
                                  learning_rate=0.05, max_iter=20)
    after = float(infidelity_plus_guard(prob, control, p1, target, order=4))
    assert after < before


def test_optax_lbfgs_method():
    """On-device optax L-BFGS backend reaches the analytic optimum too."""
    prob = construct_rabi_prob(nsteps=30)
    control = GRAPEControl(1, float(prob.tf))
    hist = optimize_gate(
        prob, control, jnp.asarray([0.42, 0.06]), _swap_target(), order=6,
        method="lbfgs", ridge_penalty_strength=0.0, maxIter=200,
        print_level=0)
    assert hist.obj_value[hist.best_index] < 1e-6
    amp = np.hypot(*hist.best_pcof)
    assert abs(amp - 0.5) < 5e-3


def test_resume_from_checkpoint(tmp_path):
    """Checkpoint/resume: restart continues from the saved pcof and appends
    to the loaded history."""
    prob = construct_rabi_prob(nsteps=20)
    control = GRAPEControl(1, float(prob.tf))
    ck = str(tmp_path / "resume_ck")
    h1 = optimize_gate(prob, control, jnp.asarray([0.40, 0.08]),
                       _swap_target(), order=4, maxIter=3, print_level=0,
                       filename=ck)
    n1 = len(h1.obj_value)
    h2 = optimize_gate(prob, control, jnp.asarray([0.0, 0.0]),  # ignored
                       _swap_target(), order=4, maxIter=3, print_level=0,
                       resume_from=ck)
    assert len(h2.obj_value) > n1
    np.testing.assert_allclose(h2.pcof[n1], h1.pcof[-1])


def test_multistart_batched_lbfgs():
    """Vmapped on-device L-BFGS multi-start (the reference's SLURM-array
    scale-out as one jitted program), on the schulz solver the batched
    f32 production configuration uses."""
    import dataclasses

    prob = dataclasses.replace(construct_rabi_prob(nsteps=20),
                               solver="schulz")
    ctrl = GRAPEControl(1, float(prob.tf))
    pcofs0 = jnp.asarray([[0.4, 0.1], [0.55, -0.05], [0.35, 0.2]])
    pcofs, objs = qgd_tpu.optimize_gate_multistart(
        prob, ctrl, pcofs0, _swap_target(), order=8, maxIter=60,
        ridge_penalty_strength=0.0, print_level=0)
    amps = np.hypot(np.asarray(pcofs)[:, 0], np.asarray(pcofs)[:, 1])
    assert np.all(objs[-1] < 1e-6)
    assert np.allclose(amps, 0.5, atol=5e-4)
