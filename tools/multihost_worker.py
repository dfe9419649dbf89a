"""Worker for the 2-process jax.distributed test (tests/test_multihost.py).

Each process owns 4 virtual CPU devices (8 global). The (scenario=2, ic=4)
mesh places one scenario row per process — the DCN-crossing axis of the
design (qgd_tpu/parallel: scenarios never communicate; ic psums stay within
a process's devices, the ICI analogue).

Usage: multihost_worker.py COORD_ADDR NUM_PROCS PROC_ID OUTDIR
Writes OUTDIR/result_PROC_ID.npz with the scenario objectives + gradients.
"""

import os
import sys

coord, nprocs, pid, outdir = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(coordinator_address=coord, num_processes=nprocs,
                           process_id=pid)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

import qgd_tpu  # noqa: E402
from qgd_tpu.parallel import make_mesh, batched_objective_and_grad  # noqa: E402

assert jax.process_count() == nprocs, jax.process_count()
assert len(jax.devices()) == 4 * nprocs, len(jax.devices())

prob = qgd_tpu.construct_rand_prob(4, 2, tf=2.0, nsteps=32, seed=11)
controls = tuple(qgd_tpu.BSpline2Control(4, float(prob.tf))
                 for _ in range(2))
rng = np.random.default_rng(0)
S = nprocs  # one scenario row per process
pcofs = rng.standard_normal((S, 16)) * 0.2
tgt = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))

mesh = make_mesh(S, 4)

# Scenario-sharded global array: each process contributes its own row(s).
sc_sharding = NamedSharding(mesh, P("scenario", None))
pcofs_global = jax.make_array_from_process_local_data(
    sc_sharding, pcofs[pid:pid + 1], global_shape=pcofs.shape)

vals, grads = batched_objective_and_grad(prob, controls, pcofs_global, tgt,
                                         mesh, 4)
# gather the full result on every process for comparison
from jax.experimental import multihost_utils  # noqa: E402

vals_all = multihost_utils.process_allgather(vals, tiled=True)
grads_all = multihost_utils.process_allgather(grads, tiled=True)

np.savez(os.path.join(outdir, f"result_{pid}.npz"),
         vals=np.asarray(vals_all), grads=np.asarray(grads_all),
         pcofs=pcofs)
print(f"proc {pid}: ok vals={np.asarray(vals_all)}", flush=True)
