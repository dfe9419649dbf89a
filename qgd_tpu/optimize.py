"""Optimizer driver (reference src/ipopt_optimal_control.jl).

``optimize_gate`` minimizes ``infidelity + guard penalty + ridge`` over the
control vector with a bound-constrained limited-memory quasi-Newton method.

The reference drives C++ IPOPT configured as pure L-BFGS
(hessian_approximation=limited-memory, history 40, tol 1e-5,
src/ipopt_optimal_control.jl:442-460). Here:

* ``method="lbfgsb"`` (default): scipy L-BFGS-B on the host, driving a
  single jitted ``value_and_grad`` on device. Objective and gradient share
  one forward solve by construction (AD), which is what the reference's
  pcof-keyed memoization tracker laboriously arranges
  (src/ipopt_optimal_control.jl:1-19, 243-346).
* ``method="lbfgs"``: fully on-device optax L-BFGS with projected box
  bounds, for device-resident/batched optimization.

Per-iteration metrics go into :class:`OptimizationHistory` (reference
OptimizationHistory, src/ipopt_optimal_control.jl:21-68) with optional
JSON+npz checkpointing each iteration (the reference writes JLD2 every IPOPT
iteration, :222-241, :373), and the loop hard-stops once the objective drops
below ``stop_objective = 1e-7`` (:381-384).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field as dfield

import jax
import jax.numpy as jnp
import numpy as np

from .controls import as_control_tuple


@dataclass
class OptimizationHistory:
    """Per-iteration record (reference src/ipopt_optimal_control.jl:21-45)."""
    iter_count: list = dfield(default_factory=list)
    obj_value: list = dfield(default_factory=list)
    wall_time: list = dfield(default_factory=list)
    pcof: list = dfield(default_factory=list)
    grad_pcof: list = dfield(default_factory=list)
    analytic_obj_value: list = dfield(default_factory=list)
    infidelity: list = dfield(default_factory=list)
    guard_penalty: list = dfield(default_factory=list)
    ridge_penalty: list = dfield(default_factory=list)

    def append(self, it, obj, wall, pcof, grad, infid, guard, ridge):
        self.iter_count.append(int(it))
        self.obj_value.append(float(obj))
        self.wall_time.append(float(wall))
        self.pcof.append(np.asarray(pcof).copy())
        self.grad_pcof.append(np.asarray(grad).copy())
        self.analytic_obj_value.append(float(infid) + float(guard) + float(ridge))
        self.infidelity.append(float(infid))
        self.guard_penalty.append(float(guard))
        self.ridge_penalty.append(float(ridge))

    @property
    def best_index(self) -> int:
        return int(np.argmin(self.obj_value))

    @property
    def best_pcof(self):
        return self.pcof[self.best_index]

    def summary(self) -> str:
        """Human summary (reference ``show``,
        src/ipopt_optimal_control.jl:51-68)."""
        if not self.obj_value:
            return "OptimizationHistory (empty)"
        i_obj = self.best_index
        i_inf = int(np.argmin(self.infidelity))
        return (
            f"OptimizationHistory: {len(self.obj_value)} iterations\n"
            f"  min objective  {self.obj_value[i_obj]:.6e} at iter "
            f"{self.iter_count[i_obj]}\n"
            f"  min infidelity {self.infidelity[i_inf]:.6e} at iter "
            f"{self.iter_count[i_inf]}")

    def save(self, filename: str):
        """Checkpoint history (reference ``write_optimization_history`` JLD2
        dumps, src/ipopt_optimal_control.jl:74-104)."""
        meta = {k: getattr(self, k) for k in (
            "iter_count", "obj_value", "wall_time", "analytic_obj_value",
            "infidelity", "guard_penalty", "ridge_penalty")}
        with open(filename + ".json", "w") as f:
            json.dump(meta, f)
        np.savez_compressed(filename + ".npz",
                            pcof=np.asarray(self.pcof),
                            grad_pcof=np.asarray(self.grad_pcof))

    @staticmethod
    def load(filename: str) -> "OptimizationHistory":
        with open(filename + ".json") as f:
            meta = json.load(f)
        arrs = np.load(filename + ".npz")
        h = OptimizationHistory(**meta)
        h.pcof = list(arrs["pcof"])
        h.grad_pcof = list(arrs["grad_pcof"])
        return h


class _StopOptimization(Exception):
    pass


def optimize_gate(prob, controls, pcof_init, target, *, order: int = 4,
                  pcof_L=None, pcof_U=None, maxIter: int = 50,
                  max_cpu_time: float = 300.0,
                  ridge_penalty_strength: float = 1e-2,
                  stop_objective: float = 1e-7,
                  tol: float = 1e-5,
                  lbfgs_history: int = 40,
                  method: str = "lbfgsb",
                  filename: str | None = None,
                  print_level: int = 5,
                  cost_type: str = "Infidelity",
                  n_segments: int | None = None,
                  max_dispatch_steps: int = 0,
                  gradient_route: str = "auto",
                  resume_from: str | None = None) -> OptimizationHistory:
    """Optimize the control vector (reference ``optimize_gate``,
    src/ipopt_optimal_control.jl:187-471).

    ``pcof_L``/``pcof_U``: box bounds, scalar or per-parameter vector
    (:389-460). ``resume_from``: a history checkpoint basename; restarts
    from its last pcof and keeps appending to the loaded history (the
    reference's resume is manual re-launch with the last pcof,
    SURVEY.md §5). ``n_segments``: ``None`` (default) auto-selects the
    O(sqrt T)-memory segmented gradient (qgd_tpu/segmented.py) once
    ``nsteps`` is long enough that the O(T) history tensors matter;
    ``0`` forces the plain path; ``>0`` forces that segment count.
    ``max_dispatch_steps > 0`` routes every evaluation through the
    host-chunked driver (qgd_tpu/chunked.py) with at most that many
    Hermite steps per device execution, which bounds device memory at
    horizons whose single-dispatch gradient would not fit.
    ``gradient_route``: ``"auto"`` (plain/segmented by horizon) or
    ``"prefix"`` (log-depth associative-scan propagation,
    qgd_tpu/prefix.py).
    Returns the :class:`OptimizationHistory`.
    """
    controls = as_control_tuple(controls)
    resumed = None
    if resume_from is not None:
        resumed = OptimizationHistory.load(resume_from)
        pcof_init = resumed.pcof[-1]
    pcof0 = np.asarray(pcof_init, dtype=np.float64)
    n = pcof0.size

    def _bounds_vec(b, default):
        if b is None:
            return np.full(n, default)
        b = np.asarray(b, dtype=np.float64)
        return np.full(n, float(b)) if b.ndim == 0 else b

    lower = _bounds_vec(pcof_L, -np.inf)
    upper = _bounds_vec(pcof_U, np.inf)

    if filename is not None and resume_from is None:
        # Persist the FULL setup once per run (problem, controls, target,
        # bounds, order — reference src/ipopt_optimal_control.jl:222-241) so
        # checkpoint.resume_optimization needs only the filename.
        from .checkpoint import save_setup

        save_setup(filename, prob, controls, target, order=order,
                   pcof_L=pcof_L, pcof_U=pcof_U,
                   ridge_penalty_strength=ridge_penalty_strength,
                   cost_type=cost_type, maxIter=maxIter,
                   max_cpu_time=max_cpu_time, stop_objective=stop_objective,
                   tol=tol, lbfgs_history=lbfgs_history, method=method,
                   print_level=print_level,
                   gradient_route=gradient_route,
                   # Routing flags must survive into resume_optimization:
                   # resuming a long-horizon run without max_dispatch_steps
                   # would re-enter the single-dispatch configuration the
                   # flag exists to avoid.
                   n_segments=n_segments,
                   max_dispatch_steps=max_dispatch_steps)

    from .adjoint import objective_and_gradient
    from .segmented import segmented_objective_and_gradient

    if n_segments is None:
        # Auto: past ~16k steps the plain path's O(T) history + cotangent
        # tensors dominate memory; switch to the O(sqrt T) segmented route.
        n_segments = 0 if prob.nsteps < 16384 else -1

    if max_dispatch_steps > 0:
        from .chunked import chunked_objective_and_gradient

        # Chunking always implies segmentation (the chunk driver iterates
        # over segments); n_segments<=0 (incl. the explicit "force plain
        # path" 0 and the auto sentinel -1) means auto-select inside the
        # chunked driver.
        chunk_segments = n_segments if n_segments and n_segments > 0 else 0

        def value_parts_and_grad(pc):
            # Host loop over bounded device dispatches — not jittable as
            # one program by design (that is the point).
            (j1, guard, ridge), grad = chunked_objective_and_gradient(
                prob, controls, pc, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength,
                n_segments=chunk_segments,
                max_dispatch_steps=max_dispatch_steps)
            return j1 + guard + ridge, (j1, guard, ridge), grad
    else:
        @jax.jit
        def value_parts_and_grad(pc):
            # Objective and gradient share one forward solve explicitly (the
            # role of the reference's pcof-keyed memoization tracker).
            if gradient_route == "prefix":
                # log-depth associative-scan propagation (qgd_tpu/prefix.py)
                from .prefix import prefix_objective_and_gradient

                (j1, guard, ridge), grad = prefix_objective_and_gradient(
                    prob, controls, pc, target, order, cost_type=cost_type,
                    ridge_penalty_strength=ridge_penalty_strength,
                    n_segments=max(n_segments or 0, 0))
            elif n_segments == 0:
                (j1, guard, ridge), grad = objective_and_gradient(
                    prob, controls, pc, target, order, cost_type=cost_type,
                    ridge_penalty_strength=ridge_penalty_strength)
            else:
                (j1, guard, ridge), grad = segmented_objective_and_gradient(
                    prob, controls, pc, target, order, cost_type=cost_type,
                    ridge_penalty_strength=ridge_penalty_strength,
                    n_segments=max(n_segments, 0))
            return j1 + guard + ridge, (j1, guard, ridge), grad

    history = resumed if resumed is not None else OptimizationHistory()
    t_start = time.perf_counter()
    state = dict(it=history.iter_count[-1] + 1 if history.iter_count else 0)

    def eval_and_record(pc):
        val, (j1, guard, ridge), grad = value_parts_and_grad(jnp.asarray(pc))
        val = float(val)
        grad = np.asarray(grad)
        wall = time.perf_counter() - t_start
        history.append(state["it"], val, wall, pc, grad, j1, guard, ridge)
        state["it"] += 1
        if print_level >= 5:
            print(f"iter {state['it']:4d}  obj {val:.6e}  infid {float(j1):.6e} "
                  f"guard {float(guard):.3e}  |g| {np.linalg.norm(grad):.3e}")
        if not (0.0 <= float(j1) <= 1.0) and cost_type == "Infidelity":
            print("Warning: infidelity outside [0, 1] "
                  "(loss of accuracy or optimizer out of bounds)")
        if filename is not None:
            history.save(filename)
        if val < stop_objective:
            raise _StopOptimization
        if wall > max_cpu_time:
            raise _StopOptimization
        return val, grad

    if method == "lbfgsb":
        from scipy.optimize import minimize

        try:
            minimize(
                eval_and_record, pcof0, jac=True, method="L-BFGS-B",
                bounds=list(zip(lower, upper)),
                options=dict(maxiter=maxIter, maxcor=lbfgs_history,
                             ftol=1e-18, gtol=tol))
        except _StopOptimization:
            pass
    elif method == "lbfgs":
        if max_dispatch_steps > 0:
            # The chunked evaluator is a host loop of device dispatches
            # (per-chunk scalar fetches); optax's zoom linesearch traces
            # value_fn inside a lax.while_loop, so it cannot call it —
            # jit or not, tracing raises ConcretizationTypeError mid-run.
            raise ValueError(
                "method='lbfgs' (on-device optax) cannot drive the "
                "host-chunked evaluator (max_dispatch_steps > 0): the "
                "zoom linesearch traces its value_fn. Use the default "
                "method='lbfgsb' for chunked long-horizon runs.")
        silent_value = jax.jit(
            lambda pc: value_parts_and_grad(pc)[0])
        _optax_lbfgs_loop(eval_and_record, silent_value, pcof0, lower, upper,
                          maxIter, lbfgs_history)
    else:
        raise ValueError(f"unknown method {method!r}")

    if print_level >= 3:
        print(history.summary())
    return history


def _optax_lbfgs_loop(eval_and_record, silent_value, pcof0, lower, upper,
                      max_iter, memory):
    """On-device L-BFGS with projected box bounds. Line-search probes use
    the silent objective; the history records one entry per iteration."""
    import optax

    opt = optax.lbfgs(memory_size=memory)
    pc = jnp.asarray(pcof0)
    lo = jnp.asarray(lower)
    hi = jnp.asarray(upper)
    opt_state = opt.init(pc)
    try:
        for _ in range(max_iter):
            val, grad = eval_and_record(np.asarray(pc))
            updates, opt_state = opt.update(
                jnp.asarray(grad), opt_state, pc,
                value=jnp.asarray(val), grad=jnp.asarray(grad),
                value_fn=silent_value)
            pc = jnp.clip(optax.apply_updates(pc, updates), lo, hi)
    except _StopOptimization:
        pass


def optimize_gate_multistart(prob, controls, pcofs_init, target, *,
                             order: int = 4, pcof_L=None, pcof_U=None,
                             maxIter: int = 50,
                             ridge_penalty_strength: float = 1e-2,
                             stop_objective: float = 1e-7,
                             lbfgs_history: int = 40,
                             print_level: int = 5,
                             cost_type: str = "Infidelity",
                             ls_max_steps: int = 25,
                             ls_decrease_factor: float = 0.5,
                             ls_increase_factor: float = 1.5,
                             gradient_route: str = "plain",
                             n_segments: int = 0):
    """Batched multi-start optimization: vmapped on-device L-BFGS over a
    batch of initial control vectors ``pcofs_init (S, n)``.

    This is the batched replacement for the reference's scale-out
    strategy — SLURM job arrays running one optimization per process
    (examples/cnot3_optimize_gate.sb:13,28-47): every start advances in
    lockstep inside ONE jitted update (vmapped L-BFGS direction + zoom
    line search + projected box bounds), so a single chip optimizes S
    scenarios at once; shard the batch axis over a mesh for more chips
    (qgd_tpu/parallel). Starts that reach ``stop_objective`` are frozen
    (their pcof stops moving) while the rest continue.

    The line search is value-only Armijo backtracking, NOT optax's default
    zoom: zoom differentiates its ``value_fn``, which on this workload
    means reverse-mode AD through the forward scan, and its probe count
    is unbounded. Backtracking probes evaluate the hand-structured
    objective only — no AD, bounded work per dispatch.

    Returns ``(pcofs (S, n), objs (maxIter, S))`` — final parameters and
    the per-iteration objective trajectories.
    """
    import optax

    controls = as_control_tuple(controls)
    pcofs = jnp.asarray(pcofs_init, dtype=jnp.float64)
    S, n = pcofs.shape
    lo = -jnp.inf if pcof_L is None else jnp.asarray(pcof_L)
    hi = jnp.inf if pcof_U is None else jnp.asarray(pcof_U)

    # The routes size their memory/hoist decisions (forward hoist cap,
    # segmented auto segment length) by ``prob.hoist_batch_hint`` — the
    # vmap batch is known HERE, so set it rather than relying on callers.
    if int(prob.hoist_batch_hint) < S:
        import dataclasses

        prob = dataclasses.replace(prob, hoist_batch_hint=S)

    # ``gradient_route="segmented"``: the O(sqrt T)-memory adjoint with
    # per-segment hoisting — REQUIRED at flagship horizons under a
    # scenario vmap (the plain path's O(S*T) hoisted stage tensors exceed
    # device memory and its in-scan fallback is far slower).
    if gradient_route == "segmented":
        from .segmented import (segmented_objective_and_gradient,
                                segmented_objective_value)

        def oag(pc):
            return segmented_objective_and_gradient(
                prob, controls, pc, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength,
                n_segments=n_segments)

        def value_fn(pc):
            return segmented_objective_value(
                prob, controls, pc, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength,
                n_segments=n_segments)
    elif gradient_route == "prefix":
        # log-depth propagation (qgd_tpu/prefix.py): probes are
        # value-only forward passes whose serial floor the prefix
        # products remove.
        from .prefix import (prefix_objective_and_gradient,
                             prefix_objective_value)

        def oag(pc):
            return prefix_objective_and_gradient(
                prob, controls, pc, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength,
                n_segments=n_segments)

        def value_fn(pc):
            return prefix_objective_value(
                prob, controls, pc, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength,
                n_segments=n_segments)
    else:
        from .adjoint import objective_and_gradient
        from .objective import objective_value

        def oag(pc):
            return objective_and_gradient(
                prob, controls, pc, target, order, cost_type=cost_type,
                ridge_penalty_strength=ridge_penalty_strength)

        def value_fn(pc):
            # Probe evaluations are VALUE-ONLY (one forward sweep, no
            # adjoint): round 4 paid a full objective+gradient per Armijo
            # probe — up to 15x the necessary linesearch cost per
            # iteration.
            return objective_value(
                prob, controls, pc, target, order,
                ridge_penalty_strength=ridge_penalty_strength,
                cost_type=cost_type)

    # Round-4's defaults (15 steps x 0.8) could only shrink the step to
    # 0.8^15 = 3.5% of the trial — far too coarse for this objective's
    # narrow valleys (results/MULTISTART.md finding 1: random starts
    # stalled at obj ~1.35-1.48 while scipy's strong-Wolfe descended to
    # 1.2e-2). 25 x 0.5 reaches 3e-8 of the trial step; increase_factor
    # re-grows it between iterations (adaptive initial step).
    opt = optax.lbfgs(
        memory_size=lbfgs_history,
        linesearch=optax.scale_by_backtracking_linesearch(
            max_backtracking_steps=ls_max_steps,
            decrease_factor=ls_decrease_factor,
            increase_factor=ls_increase_factor,
            store_grad=False))

    def one_step(pc, st):
        (j1, guard, ridge), grad = oag(pc)
        val = j1 + guard + ridge
        updates, st = opt.update(grad, st, pc, value=val, grad=grad,
                                 value_fn=value_fn)
        pc_new = jnp.clip(pc + updates, lo, hi)
        # freeze converged starts
        pc_new = jnp.where(val < stop_objective, pc, pc_new)
        return pc_new, st, val

    step = jax.jit(jax.vmap(one_step))
    states = jax.vmap(opt.init)(pcofs)
    objs = []
    for it in range(maxIter):
        pcofs, states, vals = step(pcofs, states)
        vals_np = np.asarray(vals)
        objs.append(vals_np)
        if print_level >= 5:
            print(f"iter {it:4d}  obj min {vals_np.min():.6e} "
                  f"median {np.median(vals_np):.3e}")
        if bool(np.all(vals_np < stop_objective)):
            break
    return pcofs, np.asarray(objs)


def gradient_descent(prob, controls, pcof_init, target, *, order: int = 4,
                     learning_rate: float = 0.01, max_iter: int = 100,
                     cost_type: str = "Infidelity"):
    """Plain fixed-step gradient *descent* (the reference's version ascends —
    ``pcof += lr*grad``, a latent sign bug at src/gradient_descent.jl:29 —
    implemented here with the documented intent)."""
    from .adjoint import discrete_adjoint

    pcof = jnp.asarray(pcof_init, dtype=jnp.float64)
    for _ in range(max_iter):
        grad = discrete_adjoint(prob, controls, pcof, target, order,
                                cost_type=cost_type)
        pcof = pcof - learning_rate * grad
    return pcof
