"""qgd_tpu — accelerator-native quantum optimal control (gate design).

A ground-up JAX/XLA re-design of the capabilities of
``leespen1/QuantumGateDesign.jl``: arbitrary-even-order implicit Hermite
(two-point Taylor / Hermite-Obreshkov) integration of the time-dependent
Schrödinger equation, exact discrete-adjoint gradients of a gate-infidelity +
guard-penalty + ridge objective, and bound-constrained quasi-Newton
optimization of control-pulse parameters — batched, jitted, and sharded over
device meshes.

Design notes (vs the reference, cited throughout as ``file:line`` of the
reference repo):

* The reference propagates each initial condition separately with per-vector
  GMRES solves inside a Julia ``Threads.@threads`` loop
  (src/forward_evolution.jl:33-70). Here the implicit Hermite stage is a dense
  2N x 2N LHS materialized by running the same Taylor recursion on the
  identity, and ONE LU solve handles *all* initial-condition columns (and any
  batched parameter scenarios) at once — batched dense linear algebra with
  static shapes and no host round-trips.
* Control pulses are pure functions of ``(t, pcof)``; their time-derivative
  tables are evaluated vectorized over the whole timestep grid up front, so
  the hot ``lax.scan`` consumes precomputed (nsteps, m, N_ops) tensors.
* Gradients: reverse-mode AD through the scan *is* the discrete adjoint of
  the scheme (the implicit-function transpose of the LU solve is exactly the
  reference's transposed-LHS adjoint solve, src/eval_grad_discrete_adjoint.jl),
  and forward-mode AD is the reference's "forced"/GOAT method
  (src/eval_grad_forced.jl). Both are exposed, plus finite differences, and
  they agree to the reference's 1e-14/1e-9 test gates.
* Scale-out is a ``jax.sharding.Mesh`` over (scenario, initial-condition)
  axes with psum reductions — replacing the reference's SLURM job arrays and
  Julia threads (examples/cnot3_optimize_gate.sb, src/forward_evolution.jl:48).

Everything is float64 by default (enabled at import) to meet the reference's
gradient-exactness tolerances (test/GradientTests/compare_gradients.jl:47-48).
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# On the GPU an f32 matmul at "default" precision runs in TF32, which keeps
# about 3 decimal digits (10-bit mantissa). That breaks long-horizon
# implicit stepping: every stage solve carries a biased ~1e-3 relative
# error, and over >~1e4 steps the propagation drifts and goes unstable.
# "highest" asks for true FP32. f64 matmuls are unaffected by this flag.
# Override with QGD_MATMUL_PRECISION=default|high|highest.
_jax.config.update("jax_default_matmul_precision",
                   _os.environ.get("QGD_MATMUL_PRECISION", "highest"))

from .problem import SchrodingerProblem, vector_problem  # noqa: E402
from .ops.hermite import (  # noqa: E402
    hermite_coefficient,
    assemble_generator_stack,
    scaled_derivatives,
    adjoint_scaled_derivatives,
    build_rhs,
    build_lhs,
    taylor_expand,
    form_lhs_matrix,
    form_rhs_matrix,
)
from .controls import (  # noqa: E402
    Control,
    GRAPEControl,
    GeneralGRAPEControl,
    SinCosControl,
    SinControl,
    CosControl,
    SquaredAmpCosControl,
    SingleSymCosControl,
    ZeroControl,
    BSpline2Control,
    BSplineControl,
    GeneralBSplineControl,
    FortranBSplineControl,
    CarrierControl,
    HermiteControl,
    HermiteCarrierControl,
    control_tables,
    total_control_parameters,
    control_vector_slice,
    eval_p,
    eval_q,
    eval_p_derivative,
    eval_q_derivative,
    eval_grad_p_derivative,
    eval_grad_q_derivative,
)
from .forward import eval_forward, eval_forward_complex, eval_adjoint  # noqa: E402
from .objective import (  # noqa: E402
    infidelity,
    infidelity_real,
    guard_penalty,
    guard_penalty_real,
    infidelity_plus_guard,
    objective_value,
)
from .adjoint import (  # noqa: E402
    discrete_adjoint,
    eval_grad_forced,
    eval_grad_finite_difference,
    eval_hessian,
    compute_terminal_condition,
)
from .segmented import (  # noqa: E402
    segmented_objective_and_gradient,
    segmented_gradient,
    choose_segments,
)
from .chunked import chunked_objective_and_gradient  # noqa: E402
from .prefix import (  # noqa: E402
    prefix_objective_and_gradient,
    eval_forward_prefix,
)
from .diagnostics import stage_residuals  # noqa: E402
from .checkpoint import (  # noqa: E402
    save_setup,
    load_setup,
    resume_optimization,
)
from .optimize import (  # noqa: E402
    optimize_gate,
    optimize_gate_multistart,
    OptimizationHistory,
    gradient_descent,
)
from .models.juqbox_io import (  # noqa: E402
    convert_juqbox,
    convert_to_juqbox,
    load_juqbox_npz,
)
from .models import (  # noqa: E402
    construct_rabi_prob,
    construct_rand_prob,
    dahlquist_problem,
    rotating_frame_qubit,
    DispersiveProblem,
    JaynesCummingsProblem,
    multi_qudit_hamiltonian_dispersive,
    multi_qudit_hamiltonian_jayne,
    control_ops,
    lowering_operator_subsystem,
    lowering_operators_system,
    basis_state,
    create_initial_conditions,
    create_gate,
    guard_projector,
    rotation_matrix,
)
from .controls.hermite import (  # noqa: E402
    sample_from_controls,
    construct_pcof_from_sample,
)
from . import parallel  # noqa: E402
from . import native  # noqa: E402
from .utils import (  # noqa: E402
    get_populations,
    target_helper,
    complex_to_real,
    real_to_complex,
    initial_basis,
    get_shortest_period,
    estimate_N_timesteps,
    estimate_timesteps_per_period,
    richardson_extrap_sol,
    richardson_extrap_rel_err,
    get_histories,
    get_runtime_ratios,
)

__version__ = "0.1.0"

__all__ = [
    "SchrodingerProblem",
    "vector_problem",
    "hermite_coefficient",
    "assemble_generator_stack",
    "scaled_derivatives",
    "adjoint_scaled_derivatives",
    "build_rhs",
    "build_lhs",
    "taylor_expand",
    "form_lhs_matrix",
    "form_rhs_matrix",
    "Control",
    "GRAPEControl",
    "GeneralGRAPEControl",
    "SinCosControl",
    "SinControl",
    "CosControl",
    "SquaredAmpCosControl",
    "SingleSymCosControl",
    "ZeroControl",
    "BSpline2Control",
    "BSplineControl",
    "GeneralBSplineControl",
    "FortranBSplineControl",
    "CarrierControl",
    "HermiteControl",
    "HermiteCarrierControl",
    "control_tables",
    "total_control_parameters",
    "control_vector_slice",
    "eval_p",
    "eval_q",
    "eval_p_derivative",
    "eval_q_derivative",
    "eval_grad_p_derivative",
    "eval_grad_q_derivative",
    "eval_forward",
    "eval_forward_complex",
    "eval_adjoint",
    "infidelity",
    "infidelity_real",
    "guard_penalty",
    "guard_penalty_real",
    "infidelity_plus_guard",
    "objective_value",
    "discrete_adjoint",
    "segmented_objective_and_gradient",
    "segmented_gradient",
    "chunked_objective_and_gradient",
    "prefix_objective_and_gradient",
    "eval_forward_prefix",
    "choose_segments",
    "stage_residuals",
    "save_setup",
    "load_setup",
    "resume_optimization",
    "eval_grad_forced",
    "eval_grad_finite_difference",
    "eval_hessian",
    "compute_terminal_condition",
    "optimize_gate",
    "optimize_gate_multistart",
    "OptimizationHistory",
    "gradient_descent",
    "construct_rabi_prob",
    "construct_rand_prob",
    "dahlquist_problem",
    "rotating_frame_qubit",
    "DispersiveProblem",
    "JaynesCummingsProblem",
    "multi_qudit_hamiltonian_dispersive",
    "multi_qudit_hamiltonian_jayne",
    "control_ops",
    "lowering_operator_subsystem",
    "lowering_operators_system",
    "basis_state",
    "create_initial_conditions",
    "create_gate",
    "guard_projector",
    "rotation_matrix",
    "get_populations",
    "target_helper",
    "complex_to_real",
    "real_to_complex",
    "initial_basis",
    "get_shortest_period",
    "estimate_N_timesteps",
    "estimate_timesteps_per_period",
    "richardson_extrap_sol",
    "richardson_extrap_rel_err",
    "get_histories",
    "get_runtime_ratios",
    "convert_juqbox",
    "convert_to_juqbox",
    "load_juqbox_npz",
    "sample_from_controls",
    "construct_pcof_from_sample",
    "parallel",
    "native",
]
