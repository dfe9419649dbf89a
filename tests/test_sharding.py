"""Multi-device sharding tests on the 8-virtual-CPU-device mesh: sharded
objective/gradient must match the single-device path to roundoff (the
analogue of the reference running its seeded-problem tests under different
thread counts — SURVEY.md §4)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import qgd_tpu
from qgd_tpu import construct_rabi_prob, GRAPEControl, BSpline2Control
from qgd_tpu.models.builders import rotating_frame_qubit
from qgd_tpu.objective import objective_parts
from qgd_tpu.adjoint import discrete_adjoint
from qgd_tpu.parallel import (
    make_mesh,
    sharded_objective_and_grad,
    batched_objective_and_grad,
    multichip_train_step,
)


def _problem():
    # 4 essential levels + 2 guard levels -> 4 IC columns, shardable over 4
    prob = rotating_frame_qubit(4, 2, tf=1.0, nsteps=20,
                                detuning_frequency=0.3,
                                self_kerr_coefficient=0.1)
    control = BSpline2Control(5, 1.0)
    rng = np.random.default_rng(11)
    pcof = jnp.asarray(rng.standard_normal(control.N_coeff) * 0.2)
    tgt = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    return prob, control, pcof, jnp.asarray(tgt)


def test_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("n_sc,n_ic", [(1, 4), (2, 4), (1, 2), (8, 1)])
def test_sharded_objective_matches_single_device(n_sc, n_ic):
    prob, control, pcof, target = _problem()
    mesh = make_mesh(n_sc, n_ic)
    ridge = 1e-2
    val_s, grad_s = sharded_objective_and_grad(
        prob, control, pcof, target, mesh, 4, ridge_penalty_strength=ridge)
    j1, guard, rdg = objective_parts(prob, control, pcof, target, 4,
                                     ridge_penalty_strength=ridge)
    val_ref = float(j1 + guard + rdg)
    grad_ref = np.asarray(
        discrete_adjoint(prob, control, pcof, target, 4)
        + 2 * ridge * pcof / pcof.shape[0])
    assert abs(float(val_s) - val_ref) < 1e-13
    np.testing.assert_allclose(np.asarray(grad_s), grad_ref, rtol=1e-12,
                               atol=1e-13)


def test_batched_scenarios_match_loop():
    prob, control, _, target = _problem()
    mesh = make_mesh(2, 4)
    rng = np.random.default_rng(12)
    pcofs = jnp.asarray(rng.standard_normal((4, control.N_coeff)) * 0.2)
    vals, grads = batched_objective_and_grad(
        prob, control, pcofs, target, mesh, 4, ridge_penalty_strength=1e-2)
    for i in range(pcofs.shape[0]):
        v, g = sharded_objective_and_grad(
            prob, control, pcofs[i], target, make_mesh(1, 1), 4,
            ridge_penalty_strength=1e-2)
        assert abs(float(vals[i]) - float(v)) < 1e-13
        np.testing.assert_allclose(np.asarray(grads[i]), np.asarray(g),
                                   rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("method", ["lagrange", "segmented", "ad"])
def test_sharded_gradient_routes_agree(method):
    """The production sharded gradient is the hand-structured Lagrange (or
    segmented) adjoint under shard_map — no reverse-AD-of-scan. All routes
    must agree with the single-device adjoint to roundoff; "ad" stays as
    the independent CPU cross-check."""
    prob, control, pcof, target = _problem()
    if method == "segmented":
        import dataclasses
        prob = dataclasses.replace(prob, nsteps=16)
    mesh = make_mesh(2, 4)
    val_s, grad_s = sharded_objective_and_grad(
        prob, control, pcof, target, mesh, 4, gradient_method=method)
    j1, guard, _ = objective_parts(prob, control, pcof, target, 4)
    grad_ref = np.asarray(discrete_adjoint(prob, control, pcof, target, 4))
    assert abs(float(val_s) - float(j1 + guard)) < 1e-13
    np.testing.assert_allclose(np.asarray(grad_s), grad_ref, rtol=1e-12,
                               atol=1e-13)


def test_batched_segmented_scenarios_match_plain():
    """Scenario-sharded + segmented interplay (VERDICT r2 weak #6): the
    flagship-scale program family — the O(sqrt T) segmented gradient under
    scenario vmap inside shard_map — against the plain per-scenario path."""
    import dataclasses
    prob, control, _, target = _problem()
    prob = dataclasses.replace(prob, nsteps=16)
    mesh = make_mesh(2, 4)
    rng = np.random.default_rng(21)
    pcofs = jnp.asarray(rng.standard_normal((4, control.N_coeff)) * 0.2)
    vals, grads = batched_objective_and_grad(
        prob, control, pcofs, target, mesh, 4,
        gradient_method="segmented")
    for i in range(pcofs.shape[0]):
        j1, guard, _ = objective_parts(prob, control, pcofs[i], target, 4)
        grad_ref = np.asarray(
            discrete_adjoint(prob, control, pcofs[i], target, 4))
        assert abs(float(vals[i]) - float(j1 + guard)) < 1e-13
        np.testing.assert_allclose(np.asarray(grads[i]), grad_ref,
                                   rtol=1e-12, atol=1e-13)


def test_multichip_train_step_runs_and_descends():
    prob, control, _, target = _problem()
    mesh = make_mesh(4, 2)
    rng = np.random.default_rng(13)
    pcofs = jnp.asarray(rng.standard_normal((8, control.N_coeff)) * 0.1)
    step = multichip_train_step(prob, control, target, mesh, order=4,
                                learning_rate=0.05)
    p1, v0 = step(pcofs)
    p2, v1 = step(p1)
    _, v2 = step(p2)
    assert float(jnp.mean(v2)) < float(jnp.mean(v0))


def test_graft_entry_dryrun():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", "/root/repo/__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    mod.dryrun_multichip(8)


def test_state_sharded_tp_forward_matches_single_device():
    """Tensor-parallel (level-sharded) propagation over a 4-way tp mesh
    must match the single-device GMRES path to roundoff."""
    import dataclasses
    from qgd_tpu.parallel.state_sharded import make_tp_mesh, tp_forward_history

    prob = rotating_frame_qubit(6, 2, tf=1.0, nsteps=15,
                                detuning_frequency=0.3,
                                self_kerr_coefficient=0.1)  # N=8, 2N=16
    ctrl = BSpline2Control(4, 1.0)
    rng = np.random.default_rng(4)
    pcof = jnp.asarray(rng.standard_normal(8) * 0.2)

    ref_prob = dataclasses.replace(prob, solver="gmres", gmres_iters=16)
    h_ref = np.asarray(qgd_tpu.eval_forward(ref_prob, ctrl, pcof, 4))

    mesh = make_tp_mesh(4)
    h_tp = np.asarray(tp_forward_history(prob, ctrl, pcof, mesh, 4,
                                         gmres_iters=16))
    np.testing.assert_allclose(h_tp, h_ref, atol=1e-9)
