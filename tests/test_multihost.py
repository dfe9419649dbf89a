"""Multi-host (multi-process) execution proof: a real 2-process
``jax.distributed`` run on CPU, scenario axis split across processes,
asserting the distributed objective + gradient equal the single-process
values (SURVEY.md §2.6: scenario axis over DCN, ic psums within a host)."""

import os
import socket
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

import qgd_tpu
from qgd_tpu.parallel import make_mesh, batched_objective_and_grad

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _single_process_reference():
    """Same computation as tools/multihost_worker.py on this process's
    8 virtual devices (conftest sets host_platform_device_count=8)."""
    prob = qgd_tpu.construct_rand_prob(4, 2, tf=2.0, nsteps=32, seed=11)
    controls = tuple(qgd_tpu.BSpline2Control(4, float(prob.tf))
                     for _ in range(2))
    rng = np.random.default_rng(0)
    pcofs = rng.standard_normal((2, 16)) * 0.2
    tgt = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    mesh = make_mesh(2, 4)
    vals, grads = batched_objective_and_grad(prob, controls,
                                             jnp.asarray(pcofs), tgt, mesh, 4)
    return np.asarray(vals), np.asarray(grads)


@pytest.mark.slow
def test_two_process_distributed_matches_single(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the workers set their own JAX_PLATFORMS/XLA_FLAGS; scrub this
    # process's 8-device forcing so each worker gets exactly 4
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, "-u",
             os.path.join(_REPO, "tools", "multihost_worker.py"),
             coord, "2", str(pid), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"

    vals_ref, grads_ref = _single_process_reference()
    for pid in range(2):
        r = np.load(tmp_path / f"result_{pid}.npz")
        np.testing.assert_allclose(r["vals"], vals_ref, rtol=1e-13, atol=0)
        scale = max(1.0, np.abs(grads_ref).max())
        np.testing.assert_allclose(r["grads"], grads_ref, rtol=1e-12,
                                   atol=1e-14 * scale)
