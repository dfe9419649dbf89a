"""Full-setup checkpointing for optimization runs.

The reference persists the complete run setup — problem, controls, target,
bounds, order — once per optimization, alongside the per-iteration history
(src/ipopt_optimal_control.jl:222-241 ``update_jld2``), so a run can be
resumed from the file alone. The round-1 checkpoints stored only the
history arrays (qgd_tpu/optimize.py OptimizationHistory.save); this module
adds the setup so ``resume_optimization(filename)`` needs nothing else.

Format: ``<name>.setup.json`` (static metadata + control specs) plus
``<name>.setup.npz`` (all arrays). Controls are frozen dataclasses, so they
round-trip generically: each field is a scalar, an array, or a nested
Control, serialized recursively by class name against a registry of all
Control subclasses.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import jax.numpy as jnp

from .controls.base import Control, as_control_tuple
from .problem import SchrodingerProblem


# ---------------------------------------------------------------------------
# Control (de)serialization
# ---------------------------------------------------------------------------

def _control_registry() -> dict:
    """All concrete Control subclasses by class name (imports the control
    modules so every family is registered)."""
    from . import controls as _controls_pkg  # noqa: F401  (registers classes)
    from .controls import analytic, bspline, carrier, deboor, hermite  # noqa: F401

    reg = {}

    def walk(cls):
        for sub in cls.__subclasses__():
            reg[sub.__name__] = sub
            walk(sub)

    walk(Control)
    return reg


def control_to_spec(ctrl: Control, arrays: dict, prefix: str) -> dict:
    """Recursively serialize a control dataclass. Arrays go into ``arrays``
    under ``prefix``-derived keys; the returned spec is JSON-safe."""
    spec = {"__control__": type(ctrl).__name__, "fields": {}}
    for f in dataclasses.fields(ctrl):
        v = getattr(ctrl, f.name)
        key = f"{prefix}.{f.name}"
        if isinstance(v, Control):
            spec["fields"][f.name] = control_to_spec(v, arrays, key)
        elif isinstance(v, (jnp.ndarray, np.ndarray)):
            arrays[key] = np.asarray(v)
            spec["fields"][f.name] = {"__array__": key}
        elif isinstance(v, (bool, int, float, str)) or v is None:
            spec["fields"][f.name] = v
        elif isinstance(v, (tuple, list)):
            spec["fields"][f.name] = {"__seq__": list(v)}
        else:
            raise TypeError(
                f"cannot serialize control field {f.name} of type {type(v)}")
    return spec


def control_from_spec(spec: dict, arrays: dict) -> Control:
    reg = _control_registry()
    cls = reg[spec["__control__"]]
    kwargs = {}
    for name, v in spec["fields"].items():
        if isinstance(v, dict) and "__control__" in v:
            kwargs[name] = control_from_spec(v, arrays)
        elif isinstance(v, dict) and "__array__" in v:
            kwargs[name] = jnp.asarray(arrays[v["__array__"]])
        elif isinstance(v, dict) and "__seq__" in v:
            kwargs[name] = tuple(v["__seq__"])
        else:
            kwargs[name] = v
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# Problem (de)serialization
# ---------------------------------------------------------------------------

_PROB_ARRAYS = ("system_sym", "system_asym", "sym_operators",
                "asym_operators", "u0", "v0", "guard_subspace_projector",
                "tf")


def problem_to_spec(prob: SchrodingerProblem, arrays: dict) -> dict:
    spec = {}
    for f in dataclasses.fields(prob):
        v = getattr(prob, f.name)
        if f.name in _PROB_ARRAYS:
            arrays[f"prob.{f.name}"] = np.asarray(v)
        else:
            spec[f.name] = v
    return spec


def problem_from_spec(spec: dict, arrays: dict) -> SchrodingerProblem:
    kwargs = {k: jnp.asarray(arrays[f"prob.{k}"]) for k in _PROB_ARRAYS}
    kwargs.update(spec)
    return SchrodingerProblem(**kwargs)


# ---------------------------------------------------------------------------
# Setup save / load / resume
# ---------------------------------------------------------------------------

def save_setup(filename: str, prob, controls, target, *, order: int = 4,
               pcof_L=None, pcof_U=None, ridge_penalty_strength: float = 1e-2,
               cost_type: str = "Infidelity", **extra_options):
    """Persist the full optimization setup (the reference's one-time setup
    block in the JLD2 file, src/ipopt_optimal_control.jl:222-241). Written
    once per run by ``optimize_gate(filename=...)``."""
    arrays = {}
    controls = as_control_tuple(controls)
    spec = {
        "problem": problem_to_spec(prob, arrays),
        "controls": [control_to_spec(c, arrays, f"ctrl{i}")
                     for i, c in enumerate(controls)],
        "order": int(order),
        "ridge_penalty_strength": float(ridge_penalty_strength),
        "cost_type": cost_type,
        "options": {k: v for k, v in extra_options.items()
                    if isinstance(v, (bool, int, float, str)) or v is None},
    }
    tgt = np.asarray(target)
    if np.iscomplexobj(tgt):
        arrays["target.re"] = tgt.real
        arrays["target.im"] = tgt.imag
        spec["target_complex"] = True
    else:
        arrays["target.re"] = tgt
        spec["target_complex"] = False
    for name, b in (("pcof_L", pcof_L), ("pcof_U", pcof_U)):
        if b is None:
            spec[name] = None
        elif np.ndim(b) == 0:
            spec[name] = float(b)
        else:
            arrays[name] = np.asarray(b, dtype=np.float64)
            spec[name] = {"__array__": name}
    with open(filename + ".setup.json", "w") as f:
        json.dump(spec, f)
    np.savez_compressed(filename + ".setup.npz", **arrays)


def load_setup(filename: str) -> dict:
    """Load a persisted setup: returns a dict with ``prob``, ``controls``,
    ``target``, ``order``, ``pcof_L``/``pcof_U``, ``ridge_penalty_strength``,
    ``cost_type``, and any extra options."""
    with open(filename + ".setup.json") as f:
        spec = json.load(f)
    arrays = dict(np.load(filename + ".setup.npz", allow_pickle=False))
    prob = problem_from_spec(spec["problem"], arrays)
    controls = tuple(control_from_spec(s, arrays) for s in spec["controls"])
    if spec["target_complex"]:
        target = arrays["target.re"] + 1j * arrays["target.im"]
    else:
        target = arrays["target.re"]

    def bound(name):
        v = spec[name]
        if isinstance(v, dict) and "__array__" in v:
            return arrays[v["__array__"]]
        return v

    return dict(prob=prob, controls=controls, target=target,
                order=spec["order"],
                pcof_L=bound("pcof_L"), pcof_U=bound("pcof_U"),
                ridge_penalty_strength=spec["ridge_penalty_strength"],
                cost_type=spec["cost_type"], **spec.get("options", {}))


def verify_history_f64(filename: str, which: str = "best") -> dict:
    """f64 final-verification pass over a recorded optimization (the
    production discipline: f32 propagation optimizes, f64 verifies). Rebuilds the setup from ``<filename>.setup.*``, forces
    ``dtype="float64"`` / the f64 solve path, re-evaluates the recorded
    ``best`` (min objective) or ``last`` pcof, and writes the comparison
    to ``<filename>.f64check.json``.

    Returns the record: f32-recorded vs f64-verified (j1, guard, ridge)
    and their deltas.
    """
    import dataclasses

    import jax.numpy as jnp

    from .objective import objective_parts
    from .optimize import OptimizationHistory

    setup = load_setup(filename)
    hist = OptimizationHistory.load(filename)
    idx = (int(np.argmin(hist.obj_value)) if which == "best"
           else len(hist.obj_value) - 1)
    pcof = jnp.asarray(hist.pcof[idx], dtype=jnp.float64)
    prob = dataclasses.replace(setup["prob"], dtype="float64")
    if prob.solver == "schulz":
        # keep the matmul-only solver (valid in f64 too) — the point is
        # the precision of the propagation, not the solve algorithm
        prob = dataclasses.replace(prob, solver="schulz")
    j1, guard, ridge = objective_parts(
        prob, setup["controls"], pcof, setup["target"], setup["order"],
        ridge_penalty_strength=setup["ridge_penalty_strength"],
        cost_type=setup["cost_type"])
    rec = {
        "which": which, "eval_index": idx,
        "recorded_objective": float(hist.obj_value[idx]),
        "recorded_infidelity": float(hist.infidelity[idx]),
        "f64_infidelity": float(j1),
        "f64_guard": float(guard),
        "f64_objective": float(j1 + guard + ridge),
        "delta_infidelity": float(j1) - float(hist.infidelity[idx]),
        "delta_objective": (float(j1 + guard + ridge)
                            - float(hist.obj_value[idx])),
    }
    with open(filename + ".f64check.json", "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def resume_optimization(filename: str, **overrides):
    """Resume an optimization run from its checkpoint files alone: rebuilds
    the problem/controls/target/bounds from ``<filename>.setup.*`` and
    restarts ``optimize_gate`` from the last recorded pcof (appending to the
    loaded history). ``overrides`` replace any saved option (e.g. a larger
    ``maxIter``)."""
    from .optimize import optimize_gate

    setup = load_setup(filename)
    setup.update(overrides)
    return optimize_gate(
        setup.pop("prob"), setup.pop("controls"), None,
        setup.pop("target"), resume_from=filename, filename=filename,
        **setup)
