"""Core numerical operators: Hermite-Obreshkov timestep assembly and the
Taylor-derivative recursion, formulated as dense batched linear algebra."""

from .hermite import (
    hermite_coefficient,
    hermite_coefficients,
    assemble_generator_stack,
    scaled_derivatives,
    adjoint_scaled_derivatives,
    build_rhs,
    build_lhs,
    taylor_expand,
    form_lhs_matrix,
    form_rhs_matrix,
    step_matrices,
)

__all__ = [
    "hermite_coefficient",
    "hermite_coefficients",
    "assemble_generator_stack",
    "scaled_derivatives",
    "adjoint_scaled_derivatives",
    "build_rhs",
    "build_lhs",
    "taylor_expand",
    "form_lhs_matrix",
    "form_rhs_matrix",
    "step_matrices",
]
