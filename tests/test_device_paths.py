"""The device main path without the device: the batched stage-matrix build
against an independent float64 numpy reference, the route decisions (which
must not depend on the backend's name), the VJP chunk rule, the L=1
segmented backward, the compile-cache placement, and chip_smoke.py's phases
at tiny sizes. Tests marked ``gpu`` need the card and skip elsewhere."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import qgd_tpu
from qgd_tpu.adjoint import objective_and_gradient
from qgd_tpu.forward import (_stage_matrices, _use_precomputed_stages,
                             vjp_chunk_size)
from qgd_tpu.ops.hermite import assemble_generator_stack
from qgd_tpu.problem import working_problem
from qgd_tpu.segmented import (_segment_mode, choose_segments,
                               segmented_objective_and_gradient)


@pytest.fixture(scope="module")
def chip_smoke():
    import chip_smoke as module

    return module


@pytest.fixture(scope="module")
def small_problem():
    prob = qgd_tpu.construct_rand_prob(4, 2, tf=1.0, nsteps=6, seed=3)
    controls = (qgd_tpu.CarrierControl(qgd_tpu.BSpline2Control(4, 1.0),
                                       [0.0, 1.3]),
                qgd_tpu.GRAPEControl(2, 1.0))
    n = qgd_tpu.total_control_parameters(controls)
    pcof = jnp.asarray(np.random.default_rng(0).standard_normal(n) * 0.3)
    return prob, controls, pcof


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-13), ("float32", 2e-6)])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 6])
def test_stage_matrices_match_numpy_reference(small_problem, chip_smoke, m,
                                              dtype, tol):
    """Against chip_smoke's float64 numpy reference (no library code)."""
    prob, controls, pcof = small_problem
    wprob = working_problem(dataclasses.replace(prob, dtype=dtype))
    wd = wprob.work_dtype
    ts = jnp.linspace(0.05, 1.0, 7)
    P, Q = qgd_tpu.control_tables(controls, pcof, ts, m)
    P, Q = P.astype(wd), Q.astype(wd)
    dt = 0.17
    for sign in (-1.0, 1.0):
        got = np.asarray(_stage_matrices(wprob, m, jnp.asarray(dt, wd), P, Q,
                                         sign))
        A = jax.vmap(lambda p, q: assemble_generator_stack(wprob, p, q, m))(
            P, Q)
        ref = chip_smoke._numpy_stage_matrices(
            A, sign * float(np.asarray(dt, wd)), m)
        assert got.dtype == wd
        assert got.shape == (7, wprob.real_system_size,
                             wprob.real_system_size)
        err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert err < tol, (m, dtype, sign, err)


@pytest.mark.parametrize("backend", ["cpu", "gpu", "cuda"])
def test_route_decisions_ignore_backend_name(monkeypatch, backend):
    """Hoisting mode, segment mode, segment count and the VJP chunk are
    decided from the problem alone."""
    prob = qgd_tpu.models.cnot3_problem(nsteps=1000)
    schulz = dataclasses.replace(prob, solver="schulz", dtype="float32")
    batched = dataclasses.replace(schulz, hoist_batch_hint=256)
    cases = [(prob, "full", "full"), (schulz, "schulz", "schulz"),
             (batched, None, "schulz"),         # over the hoist cap
             (dataclasses.replace(prob, solver="gmres"), None, None)]
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    for p, hoist, seg in cases:
        assert _use_precomputed_stages(p) == hoist
        assert _segment_mode(p) == seg
    assert choose_segments(1000) == 25
    assert vjp_chunk_size(prob, 2) == 3744
    assert vjp_chunk_size(batched, 2) == 29


def test_vjp_chunk_size_bounds_residual_bytes():
    prob = qgd_tpu.models.cnot3_problem(nsteps=1000)
    for hint, dtype, m in ((1, "float64", 2), (256, "float32", 2),
                           (256, "float32", 4), (4096, "float64", 6)):
        p = dataclasses.replace(prob, hoist_batch_hint=hint, dtype=dtype)
        chunk = vjp_chunk_size(p, m)
        itemsize = 4 if dtype == "float32" else 8
        per_point = (m * 128 * 128 + (m + 1) * 128 * 8) * itemsize * hint
        assert 1 <= chunk <= 4096
        assert chunk == 1 or chunk * per_point <= 1 << 30
    small = qgd_tpu.construct_rabi_prob(nsteps=10)
    assert vjp_chunk_size(small, 4) == 4096


@pytest.mark.parametrize("order", [2, 4])
def test_segmented_L1_backward_matches_plain(small_problem, order):
    """n_segments = nsteps (L = 1) skips the re-forward and builds each
    segment's history from the stored boundary states; it must equal the
    plain Lagrange gradient in f64."""
    prob, controls, pcof = small_problem
    rng = np.random.default_rng(1)
    shape = (prob.N_tot_levels, prob.N_initial_conditions)
    tgt = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    (j1, g, r), grad = objective_and_gradient(
        prob, controls, pcof, tgt, order, ridge_penalty_strength=1e-2)
    (j1s, gs, rs), grads = segmented_objective_and_gradient(
        prob, controls, pcof, tgt, order, ridge_penalty_strength=1e-2,
        n_segments=prob.nsteps)
    assert abs(float(j1s + gs + rs) - float(j1 + g + r)) < 1e-14
    np.testing.assert_allclose(np.asarray(grads), np.asarray(grad),
                               rtol=1e-12, atol=1e-15)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    from qgd_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    import os

    from qgd_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.setup_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(qgd_tpu.__file__)))
    assert path == os.path.join(repo, ".jax_cache")


def test_chip_smoke_exits_nonzero_without_gpu(chip_smoke, capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_stage_build_tiny(chip_smoke):
    recs = chip_smoke.stage_build(n_points=4)
    assert {(r["order"], r["dtype"]) for r in recs} == {
        (4, "float64"), (4, "float32"), (8, "float64"), (8, "float32")}


def test_chip_smoke_gradient_tiny(chip_smoke):
    rec64, rec32 = chip_smoke.gradient(nsteps=8, tf=4.4)
    assert rec64["grad_rel_norm"] <= 1e-8
    assert rec32["stage_residual_max"] <= chip_smoke.RESIDUAL_GUARD


def test_chip_smoke_optimize_tiny(chip_smoke):
    rec = chip_smoke.optimize(nsteps=16, tf=8.8, max_iter=2)
    assert rec["objective_best"] < rec["objective_first"]


def test_chip_smoke_multistart_tiny(chip_smoke):
    rec = chip_smoke.multistart(n_starts=2, nsteps=8, tf=4.4, max_iter=2)
    assert rec["iterations"] == 2


@pytest.fixture
def gpu():
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is "
                    f"{devices[0].platform}")
    return devices[0]


@pytest.mark.gpu
def test_stage_build_and_gradient_on_gpu(gpu, chip_smoke):
    """The compiled GPU stage build against the numpy reference, and the
    f64 gradient on the GPU against the host CPU, at small sizes."""
    chip_smoke.stage_build(n_points=64)
    chip_smoke.gradient(nsteps=64, tf=35.2)
