"""Full-setup checkpoint persistence + resume-after-process-restart
(reference writes prob/controls/target/bounds/order once per run,
src/ipopt_optimal_control.jl:222-241; resume must need nothing but the
files)."""

import numpy as np
import jax.numpy as jnp

import qgd_tpu
from qgd_tpu import (
    construct_rabi_prob,
    BSpline2Control,
    CarrierControl,
    GRAPEControl,
    optimize_gate,
)
from qgd_tpu.checkpoint import (
    save_setup,
    load_setup,
    resume_optimization,
    control_to_spec,
    control_from_spec,
)


def test_control_spec_roundtrip():
    ctrls = [
        GRAPEControl(3, 2.0),
        BSpline2Control(5, 2.0),
        CarrierControl(BSpline2Control(4, 2.0), [0.7, 2.1]),
        qgd_tpu.HermiteControl(4, 2.0, 2),
        qgd_tpu.FortranBSplineControl(3, 6, 2.0),
    ]
    rng = np.random.default_rng(0)
    for c in ctrls:
        arrays = {}
        spec = control_to_spec(c, arrays, "c")
        c2 = control_from_spec(spec, arrays)
        assert type(c2) is type(c)
        pcof = jnp.asarray(rng.standard_normal(c.N_coeff))
        ts = jnp.linspace(0.0, 1.9, 7)
        for t in ts:
            np.testing.assert_allclose(
                np.asarray(c.p_derivatives(t, pcof, 3)),
                np.asarray(c2.p_derivatives(t, pcof, 3)), rtol=0, atol=0)


def test_setup_roundtrip(tmp_path):
    prob = qgd_tpu.models.cnot2_problem(nsteps=40)
    controls = (CarrierControl(BSpline2Control(4, float(prob.tf)), [1.1]),
                BSpline2Control(4, float(prob.tf)))
    rng = np.random.default_rng(1)
    tgt = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    base = str(tmp_path / "ckpt")
    save_setup(base, prob, controls, tgt, order=6, pcof_L=-0.5, pcof_U=0.5,
               ridge_penalty_strength=3e-3, cost_type="Infidelity",
               maxIter=17)
    s = load_setup(base)
    assert s["order"] == 6 and s["maxIter"] == 17
    assert s["pcof_L"] == -0.5 and s["pcof_U"] == 0.5
    assert s["ridge_penalty_strength"] == 3e-3
    np.testing.assert_array_equal(np.asarray(s["target"]), tgt)
    p2 = s["prob"]
    assert p2.nsteps == prob.nsteps and p2.solver == prob.solver
    np.testing.assert_array_equal(np.asarray(p2.system_sym),
                                  np.asarray(prob.system_sym))
    # loaded setup must produce identical objectives
    pcof = jnp.asarray(rng.standard_normal(16) * 0.1)
    v1 = qgd_tpu.objective_value(prob, controls, pcof, tgt, 4)
    v2 = qgd_tpu.objective_value(p2, s["controls"], pcof, tgt, 4)
    assert float(v1) == float(v2)


def test_resume_after_restart(tmp_path):
    """Run a few iterations, then resume purely from disk (fresh objects)
    and check the history continues from the recorded state."""
    prob = construct_rabi_prob(nsteps=40)
    ctrl = GRAPEControl(1, float(prob.tf))
    target = np.array([[0, 1], [1, 0]], dtype=complex)
    base = str(tmp_path / "run")
    h1 = optimize_gate(prob, ctrl, jnp.array([0.4, 0.1]), target, order=4,
                       maxIter=3, ridge_penalty_strength=0.0,
                       print_level=0, filename=base)
    n1 = len(h1.obj_value)
    assert n1 >= 3
    # simulate a process restart: resume with NO python objects carried over
    h2 = resume_optimization(base, maxIter=3, print_level=0)
    assert len(h2.obj_value) > n1
    assert h2.obj_value[-1] <= h1.obj_value[0]
    np.testing.assert_array_equal(h2.pcof[n1 - 1], h1.pcof[-1])


def test_verify_history_f64(tmp_path):
    """The f64 final-verification pass (optimize in f32, verify in f64): an
    f32-propagated optimization record re-evaluated in f64 must agree to
    the f32 noise scale, and the record lands next to the checkpoint."""
    import dataclasses
    import json
    from qgd_tpu.checkpoint import verify_history_f64

    prob = qgd_tpu.models.cnot2_problem(nsteps=40)
    prob = dataclasses.replace(prob, dtype="float32")
    controls = (BSpline2Control(4, float(prob.tf)),
                BSpline2Control(4, float(prob.tf)))
    rng = np.random.default_rng(2)
    tgt = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    base = str(tmp_path / "run")
    qgd_tpu.optimize_gate(prob, controls, jnp.asarray(
        rng.standard_normal(16) * 0.05), tgt, order=4, maxIter=3,
        filename=base, print_level=0)
    rec = verify_history_f64(base, which="best")
    assert abs(rec["delta_objective"]) < 1e-4
    on_disk = json.load(open(base + ".f64check.json"))
    assert on_disk["f64_objective"] == rec["f64_objective"]
