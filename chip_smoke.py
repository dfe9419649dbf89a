#!/usr/bin/env python
"""Run the CNOT3 gate-design path once on one GPU and check what it computes.

Usage:
    python chip_smoke.py            # every phase below, on one GPU
    python chip_smoke.py --four     # only the 4-device mesh path and its
                                    # single-device comparison

The system under test is the upstream's dispersive CNOT3 deployment: (4,4,4)
qudits (2N = 128 real state rows, 8 gate-basis columns), order-4 Hermite
stepping. Phases, each an importable function that takes its sizes:

1. ``stage_build``  — ``forward._stage_matrices`` at T = 1000 time points,
   orders 4 and 8, f64 and f32, against a float64 numpy reference of
   ``sum_j c_j D_j`` built on the host from the same generator stacks.
2. ``gradient``     — ``adjoint.objective_and_gradient`` in f64 (LU) on the
   GPU against the same call on the host CPU; then the f32 production
   configuration (Newton–Schulz, warm budget 0, segmented route) with its
   f64 objective gap and its stage-solve residual guard.
3. ``optimize``     — ``optimize_gate`` on carrier controls at the upstream
   horizon (tf = 550, nsteps = 30720), f64, a few L-BFGS-B iterations.
4. ``multistart``   — ``optimize_gate_multistart`` with 256 starts at
   nsteps = 1000 in the f32 production configuration.

Any failed check raises, so the script exits non-zero and prints no result
line. It also exits non-zero when JAX finds no GPU. The last line of a
passing run is one JSON object naming the device.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

RESIDUAL_GUARD = 1e-7


def card_line() -> str:
    """Name and power limit of the card, from nvidia-smi in a child process
    (which never imports JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def _rel(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _hermite_weights(m: int):
    """c_j = m! (2m-j)! / ((2m)! (m-j)!), j = 0..m."""
    f = math.factorial
    return [f(m) * f(2 * m - j) / (f(2 * m) * f(m - j)) for j in range(m + 1)]


def _numpy_stage_matrices(A, s, m):
    """float64 numpy reference: ``sum_j s^j c_j D_j`` with the Leibniz
    recursion ``D_{j+1} = 1/(j+1) sum_i A_{j-i} D_i`` from ``D_0 = I``.
    ``A (T, m, n, n)``."""
    A = np.asarray(A, dtype=np.float64)
    n = A.shape[-1]
    D = [np.broadcast_to(np.eye(n), A.shape[:1] + (n, n))]
    for j in range(m):
        acc = sum(A[:, j - i] @ D[i] for i in range(j + 1))
        D.append(acc / (j + 1))
    c = _hermite_weights(m)
    return sum((s ** j) * c[j] * D[j] for j in range(m + 1))


def _carrier_controls(tf):
    import qgd_tpu

    return tuple(
        qgd_tpu.CarrierControl(qgd_tpu.BSpline2Control(10, tf), freqs)
        for freqs in qgd_tpu.models.cnot3_carrier_frequencies())


def _bspline_controls(tf):
    import qgd_tpu

    return tuple(qgd_tpu.BSpline2Control(10, tf) for _ in range(3))


def stage_build(n_points: int = 1000, orders=(4, 8), seed: int = 0):
    """Phase 1: batched stage-matrix build vs a host numpy reference."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import qgd_tpu
    from qgd_tpu.forward import _stage_matrices
    from qgd_tpu.ops.hermite import assemble_generator_stack
    from qgd_tpu.problem import working_problem

    tf = 0.55 * n_points
    prob = qgd_tpu.models.cnot3_problem(tf=tf, nsteps=n_points)
    controls = _carrier_controls(tf)
    rng = np.random.default_rng(seed)
    n_par = sum(c.N_coeff for c in controls)
    pcof = jnp.asarray(rng.uniform(-0.02, 0.02, n_par))
    dt = tf / n_points
    ts = jnp.arange(1, n_points + 1, dtype=jnp.float64) * dt
    # f32 tolerance under the library's "highest" pin: true FP32 matmuls on
    # the GPU (not TF32, which would keep ~3 digits).
    tols = {"float64": 1e-12, "float32": 1e-5}
    out = []
    for order in orders:
        m = order // 2
        P, Q = qgd_tpu.control_tables(controls, pcof, ts, m)
        for dtype, tol in tols.items():
            wprob = working_problem(dataclasses.replace(prob, dtype=dtype))
            wd = wprob.work_dtype
            Pw, Qw = P.astype(wd), Q.astype(wd)
            build = jax.jit(lambda p, q: _stage_matrices(
                wprob, m, jnp.asarray(dt, wd), p, q, -1.0))
            got = np.asarray(jax.block_until_ready(build(Pw, Qw)))
            A = np.asarray(jax.vmap(
                lambda p, q: assemble_generator_stack(wprob, p, q, m))(Pw, Qw))
            ref = _numpy_stage_matrices(A, -float(np.asarray(dt, wd)), m)
            err = _rel(got, ref)
            rec = {"order": order, "dtype": dtype, "shape": list(got.shape),
                   "rel_err": err, "tol": tol}
            print("stage_build", json.dumps(rec), flush=True)
            _check(got.shape == (n_points, 128, 128), f"shape {got.shape}")
            _check(np.all(np.isfinite(got)), "non-finite stage matrices")
            _check(err <= tol, f"stage build {dtype} order {order}: "
                               f"rel err {err:.3e} > {tol:.0e}")
            out.append(rec)
    return out


def gradient(nsteps: int = 1000, tf: float = 550.0, seed: int = 0):
    """Phase 2: f64 objective+gradient on the default device vs the host
    CPU; then the f32 production configuration and its residual guard."""
    import dataclasses

    import jax
    import qgd_tpu
    from qgd_tpu.adjoint import objective_and_gradient
    from qgd_tpu.diagnostics import stage_residuals
    from qgd_tpu.segmented import segmented_objective_and_gradient

    prob = qgd_tpu.models.cnot3_problem(tf=tf, nsteps=nsteps)
    controls = _bspline_controls(tf)
    pcof = np.random.default_rng(seed).standard_normal(60) * 0.01
    target = qgd_tpu.models.cnot3_target(tf=tf)

    def f64_oag():
        (j1, guard, ridge), grad = objective_and_gradient(
            prob, controls, pcof, target, 4)
        return float(j1 + guard), np.asarray(grad)

    t0 = time.perf_counter()
    obj_dev, grad_dev = f64_oag()
    t_dev = time.perf_counter() - t0
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        prob = jax.device_put(prob, cpu)
        obj_cpu, grad_cpu = f64_oag()
    rec = {"device": jax.devices()[0].platform, "objective": obj_dev,
           "objective_cpu": obj_cpu,
           "objective_rel": abs(obj_dev - obj_cpu) / abs(obj_cpu),
           "grad_rel_norm": _rel(grad_dev, grad_cpu),
           "first_call_s": t_dev}
    print("gradient f64", json.dumps(rec), flush=True)
    _check(np.isfinite(obj_dev) and np.all(np.isfinite(grad_dev)),
           "non-finite f64 gradient")
    _check(rec["objective_rel"] <= 1e-10,
           f"f64 objective vs CPU rel {rec['objective_rel']:.3e} > 1e-10")
    _check(rec["grad_rel_norm"] <= 1e-8,
           f"f64 gradient vs CPU rel {rec['grad_rel_norm']:.3e} > 1e-8")

    prob = qgd_tpu.models.cnot3_problem(tf=tf, nsteps=nsteps)
    p32 = dataclasses.replace(prob, dtype="float32", solver="schulz",
                              schulz_warm_budget=0)
    (j1, guard, _), grad32 = segmented_objective_and_gradient(
        p32, controls, pcof, target, 4)
    obj32 = float(j1 + guard)
    res = stage_residuals(p32, controls, pcof, 4)["max"]
    rec32 = {"objective_f32": obj32, "gap_vs_f64": obj32 - obj_dev,
             "grad_rel_vs_f64": _rel(grad32, grad_dev),
             "stage_residual_max": res, "guard": RESIDUAL_GUARD}
    print("gradient f32", json.dumps(rec32), flush=True)
    _check(np.isfinite(obj32) and np.all(np.isfinite(np.asarray(grad32))),
           "non-finite f32 gradient")
    _check(res <= RESIDUAL_GUARD,
           f"f32 stage residual {res:.3e} > {RESIDUAL_GUARD:.0e}")
    return rec, rec32


def optimize(nsteps: int = 30720, tf: float = 550.0, max_iter: int = 3,
             seed: int = 0):
    """Phase 3: ``optimize_gate`` on carrier controls, f64, auto route."""
    import qgd_tpu

    prob = qgd_tpu.models.cnot3_problem(tf=tf, nsteps=nsteps)
    controls = _carrier_controls(tf)
    n = sum(c.N_coeff for c in controls)
    amp = 0.02
    pcof0 = np.random.default_rng(seed).uniform(-amp / 10, amp / 10, n)
    target = qgd_tpu.models.cnot3_target(tf=tf)
    hist = qgd_tpu.optimize_gate(
        prob, controls, pcof0, target, order=4, pcof_L=-amp, pcof_U=amp,
        maxIter=max_iter, max_cpu_time=1e9, print_level=0)
    objs = np.asarray(hist.obj_value)
    wall = np.asarray(hist.wall_time)
    per_eval = (float(np.mean(np.diff(wall))) if wall.size > 1
                else float("nan"))
    rec = {"nsteps": nsteps, "evaluations": int(objs.size),
           "objective_first": float(objs[0]), "objective_best": float(
               objs.min()), "s_per_objective_gradient": per_eval,
           "compile_s": float(wall[0] - per_eval) if wall.size > 1
           else float(wall[0])}
    print("optimize_gate", json.dumps(rec), flush=True)
    _check(objs.size >= 2, "optimize_gate made fewer than 2 evaluations")
    _check(bool(np.all(np.isfinite(objs))), "non-finite objective")
    _check(objs.min() < objs[0], "best objective not below the initial one")
    return rec


def multistart(n_starts: int = 256, nsteps: int = 1000, tf: float = 550.0,
               max_iter: int = 2, seed: int = 0):
    """Phase 4: batched multistart in the f32 production configuration."""
    import dataclasses

    import jax
    import qgd_tpu

    prob = dataclasses.replace(
        qgd_tpu.models.cnot3_problem(tf=tf, nsteps=nsteps),
        dtype="float32", solver="schulz", schulz_warm_budget=0)
    controls = _bspline_controls(tf)
    pcofs = np.random.default_rng(seed).standard_normal((n_starts, 60)) * 0.01
    target = qgd_tpu.models.cnot3_target(tf=tf)
    t0 = time.perf_counter()
    _, objs = qgd_tpu.optimize_gate_multistart(
        prob, controls, pcofs, target, order=4, maxIter=max_iter,
        gradient_route="segmented", print_level=0)
    wall = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    best = objs.min(axis=1)
    rec = {"starts": n_starts, "iterations": int(objs.shape[0]),
           "best_per_iteration": best.tolist(), "wall_s": wall,
           "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
    print("multistart", json.dumps(rec), flush=True)
    _check(objs.shape == (max_iter, n_starts), f"objs shape {objs.shape}")
    _check(bool(np.all(np.isfinite(objs))), "non-finite multistart objective")
    _check(bool(np.all(np.diff(best) <= 0)),
           "minimum over starts increased between iterations")
    return rec


def four_device(nsteps: int = 1000, tf: float = 550.0, n_scenarios: int = 8,
                seed: int = 0):
    """The mesh path on 4 devices vs the same computation on one device:
    ``multichip_train_step`` on a (scenario 2, ic 2) mesh for the "auto"
    and "segmented" gradient methods, and the chunked gradient with the
    gate columns over a (1, 4) mesh."""
    import jax
    import qgd_tpu
    from qgd_tpu.parallel import make_mesh, multichip_train_step

    _check(len(jax.devices()) >= 4, f"{len(jax.devices())} devices, need 4")
    prob = qgd_tpu.models.cnot3_problem(tf=tf, nsteps=nsteps)
    controls = _carrier_controls(tf)
    n = sum(c.N_coeff for c in controls)
    rng = np.random.default_rng(seed)
    pcofs = rng.uniform(-0.002, 0.002, (n_scenarios, n))
    target = qgd_tpu.models.cnot3_target(tf=tf)
    out = []
    for method in ("auto", "segmented"):
        runs = {}
        for shape in ((2, 2), (1, 1)):
            mesh = make_mesh(*shape)
            step = multichip_train_step(prob, controls, target, mesh,
                                        gradient_method=method)
            new, vals = jax.block_until_ready(step(pcofs))
            runs[shape] = (np.asarray(new), np.asarray(vals),
                           len(vals.sharding.device_set),
                           len(new.sharding.device_set))
        rec = {"path": f"multichip_train_step/{method}",
               "devices_used": runs[(2, 2)][3],
               "objective_rel": _rel(runs[(2, 2)][1], runs[(1, 1)][1]),
               "pcof_rel": _rel(runs[(2, 2)][0] - pcofs,
                                runs[(1, 1)][0] - pcofs)}
        print("four", json.dumps(rec), flush=True)
        _check(rec["devices_used"] == 4, f"{method}: not on 4 devices")
        _check(bool(np.all(np.isfinite(runs[(2, 2)][1]))), "non-finite")
        _check(rec["objective_rel"] <= 1e-10 and rec["pcof_rel"] <= 1e-10,
               f"{method}: sharded vs single-device {rec}")
        out.append(rec)

    kw = dict(ridge_penalty_strength=1e-2, max_dispatch_steps=nsteps // 4)
    (a1, a2, a3), ga = qgd_tpu.chunked_objective_and_gradient(
        prob, controls, pcofs[0], target, 4, mesh=make_mesh(1, 4), **kw)
    (b1, b2, b3), gb = qgd_tpu.chunked_objective_and_gradient(
        prob, controls, pcofs[0], target, 4, **kw)
    rec = {"path": "chunked_objective_and_gradient/mesh(1,4)",
           "devices_used": len(make_mesh(1, 4).devices.flat),
           "objective_rel": abs(float(a1 + a2 + a3) - float(b1 + b2 + b3))
           / abs(float(b1 + b2 + b3)),
           "grad_rel_norm": _rel(ga, gb)}
    print("four", json.dumps(rec), flush=True)
    _check(rec["objective_rel"] <= 1e-10 and rec["grad_rel_norm"] <= 1e-10,
           f"chunked mesh vs single-device {rec}")
    out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device mesh path and its "
                         "single-device comparison")
    args = ap.parse_args(argv)

    # Keep the host CPU visible next to the GPU: phase 2 compares against
    # it. (Before JAX initializes its backends.)
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX default device is "
              f"{devices[0].platform}); nothing was run", file=sys.stderr)
        return 2
    from qgd_tpu.utils.compile_cache import setup_compile_cache

    cache = setup_compile_cache()
    import jaxlib

    card = card_line()
    print(card)
    print(f"device_kind {devices[0].device_kind}; count {len(devices)}")
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}")
    print(f"XLA_FLAGS {os.environ.get('XLA_FLAGS', '')!r}")
    print(f"compile cache {cache}", flush=True)

    phases = ([("four_device", four_device)] if args.four else
              [("stage_build", stage_build), ("gradient", gradient),
               ("optimize", optimize), ("multistart", multistart)])
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        print(f"phase {name} ok in {time.perf_counter() - t0:.1f} s "
              f"({card.replace(chr(10), '; ')})", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
