"""Problem container: the analogue of the reference's
``SchrodingerProb`` (src/SchrodingerProb.jl:25-233).

Differences from the reference, by design:

* Immutable pytree dataclass instead of a Julia mutable struct — works under
  ``jit``/``vmap``/``shard_map``; "mutation" is ``dataclasses.replace``.
* Operators are stored as *stacked dense* float64 arrays ``(N_ops, N, N)``.
  Quantum-control system sizes are at most a few hundred levels, where dense
  matmul dominates any sparse format on an accelerator; the reference's
  sparse path (src/SchrodingerProb.jl:196-202) has no payoff here.
* GMRES tolerances / preconditioner type are replaced by a ``solver`` string:
  the default implicit-stage solver is a direct dense LU (exact, batched over
  initial conditions) — see qgd_tpu/forward.py. An iterative option is kept
  for very large systems.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


def _as_f64(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.float64)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class SchrodingerProblem:
    """Definition of a gate-design problem.

    State representation is the real-stacked form ``w = [u; v]`` with
    ``u = Re(psi)``, ``v = Im(psi)`` (reference docs/src/index.md:37-47), so
    the generator of ``dw/dt = A(t) w`` is ``A = [[S, K], [-K, S]]`` where
    ``K = Re(H)`` (symmetric) and ``S = Im(H)`` (anti-symmetric); the control
    Hamiltonians contribute ``p_j(t) * sym_op[j]`` to ``K`` and
    ``q_j(t) * asym_op[j]`` to ``S`` (src/hermite.jl:464-498).

    Fields
    ------
    system_sym : (N, N) symmetric real part of the drift Hamiltonian.
    system_asym : (N, N) anti-symmetric imaginary part of the drift.
    sym_operators : (N_ops, N, N) stacked symmetric control operators
        (``a + a^dag``); empty-op problems use ``N_ops = 0``.
    asym_operators : (N_ops, N, N) stacked anti-symmetric control operators.
    u0, v0 : (N, N_ic) real/imag initial conditions, one column per
        gate-basis initial state.
    guard_subspace_projector : (2N, 2N) real-valued projector onto the guard
        (forbidden) subspace, i.e. ``[[G, 0], [0, G]]``.
    tf : gate duration.
    nsteps : number of Hermite timesteps (static — part of the jit cache key).
    N_ess_levels : essential-subspace dimension (static).

    Mirrors the reference's validated container (src/SchrodingerProb.jl:50-165)
    including the symmetry/shape checks, which run at construction time in
    numpy (never inside jit).
    """

    # --- traced array data ---
    system_sym: jnp.ndarray
    system_asym: jnp.ndarray
    sym_operators: jnp.ndarray
    asym_operators: jnp.ndarray
    u0: jnp.ndarray
    v0: jnp.ndarray
    guard_subspace_projector: jnp.ndarray
    tf: jnp.ndarray
    # --- static metadata ---
    nsteps: int = field(metadata=dict(static=True))
    N_ess_levels: int = field(metadata=dict(static=True))
    solver: str = field(default="lu", metadata=dict(static=True))
    # Requested stage-solve tolerances (reference src/SchrodingerProb.jl:
    # 176-177). The fixed-iteration solvers do not iterate to a
    # tolerance; these are CHECKED (not enforced) by
    # qgd_tpu.diagnostics.stage_residuals, which warns when the achieved
    # fixed-budget GMRES residual exceeds them.
    gmres_abstol: float = field(default=1e-10, metadata=dict(static=True))
    gmres_reltol: float = field(default=1e-10, metadata=dict(static=True))
    gmres_iters: int = field(default=20, metadata=dict(static=True))
    # Newton-Schulz TOTAL iteration budget for ``solver="schulz"`` — the
    # matmul-only batched stage solver. Counted from the universal init
    # (ops/linalg.schulz_universal_init): ~40 iterations ramp through the
    # cond(M) phase, then ~16 quadratically-converging sweeps reach f32
    # inverse accuracy for the well-conditioned Hermite stage matrices.
    # Warm-started solves (drift-only inverse as X0) use
    # ``max(schulz_iters - 40, 8)`` iterations instead.
    schulz_iters: int = field(default=56, metadata=dict(static=True))
    # Explicit warm-start Newton-Schulz budget for the per-step stage
    # inverses (-1 = derive from schulz_iters via
    # ops.linalg.schulz_warm_iters, i.e. max(schulz_iters-40, 8)).
    # ``0`` deletes per-step inverse construction entirely: every stage is
    # solved by iterative-refinement sweeps preconditioned with the ONE
    # hoisted drift-only inverse (contraction ||I - X_drift M_n|| =
    # O(dt * control amplitude) per sweep — the reference's
    # LUPreconditioner observation, src/preconditioners.jl:44-55, taken to
    # its conclusion). Requires enough refinement sweeps for the target
    # residual: see ops/linalg.REFINE_SWEEPS_F32 and
    # diagnostics.stage_residuals, which guards the achieved quality.
    schulz_warm_budget: int = field(default=-1, metadata=dict(static=True))
    preconditioner_type: str = field(default="identity",
                                     metadata=dict(static=True))
    # Propagation dtype: "float64" (default; required for the 1e-14
    # gradient-exactness gates) or "float32" (the fast optimization mode,
    # with the objective still reduced in f64). Switch via
    # ``dataclasses.replace(prob, dtype="float32")``.
    dtype: str = field(default="float64", metadata=dict(static=True))
    # How many scenario copies of the hoisted per-step stage tensors will
    # coexist (a scenario ``vmap`` batches them, since stage matrices are
    # pcof-dependent). Used only by the forward/adjoint hoisting memory cap
    # (forward._use_precomputed_stages); set it to the vmap batch size.
    hoist_batch_hint: int = field(default=1, metadata=dict(static=True))

    @property
    def work_dtype(self):
        import jax.numpy as _jnp
        return _jnp.float32 if self.dtype == "float32" else _jnp.float64

    # ------------------------------------------------------------------
    # Derived sizes (static Python ints; usable as jit-static values)
    # ------------------------------------------------------------------
    @property
    def N_tot_levels(self) -> int:
        return self.system_sym.shape[-1]

    @property
    def real_system_size(self) -> int:
        return 2 * self.N_tot_levels

    @property
    def N_operators(self) -> int:
        return self.sym_operators.shape[0]

    @property
    def N_initial_conditions(self) -> int:
        return 1 if self.u0.ndim == 1 else self.u0.shape[-1]

    @property
    def w0(self) -> jnp.ndarray:
        """Real-stacked initial state(s), shape (2N, N_ic)."""
        u0 = self.u0 if self.u0.ndim == 2 else self.u0[:, None]
        v0 = self.v0 if self.v0.ndim == 2 else self.v0[:, None]
        return jnp.concatenate([u0, v0], axis=0)

    def with_nsteps(self, nsteps: int) -> "SchrodingerProblem":
        """Return a copy with a different step count (the Richardson harness
        halves/doubles nsteps; reference mutates prob.nsteps in place,
        src/Tests/test_convergence.jl:85-86)."""
        return dataclasses.replace(self, nsteps=int(nsteps))

    def copy(self) -> "SchrodingerProblem":
        return dataclasses.replace(self)

    def __repr__(self) -> str:
        """Informative summary (the reference's pretty-printer,
        src/SchrodingerProb.jl:278-327, which reports operator shapes,
        sizes, tf/nsteps/dt and solver configuration)."""
        try:
            n_ops = self.N_operators
            n_ic = self.N_initial_conditions
            N = self.N_tot_levels
            guard_rank = int(np.count_nonzero(
                np.diag(np.asarray(self.guard_subspace_projector)))) // 2
            tf = float(np.asarray(self.tf))
            dt = tf / self.nsteps
            lines = [
                "SchrodingerProblem:",
                f"  levels: {N} total, {self.N_ess_levels} essential, "
                f"{guard_rank} guarded (real system size {2 * N})",
                f"  control operators: {n_ops}  |  initial conditions: "
                f"{n_ic}",
                f"  tf = {tf:g}, nsteps = {self.nsteps}, dt = {dt:g}",
                f"  solver = {self.solver!r}, dtype = {self.dtype!r}"
                + (f", schulz_iters = {self.schulz_iters}"
                   if self.solver == "schulz" else "")
                + (f", gmres_iters = {self.gmres_iters}, "
                   f"preconditioner = {self.preconditioner_type!r}"
                   if self.solver == "gmres" else ""),
            ]
            return "\n".join(lines)
        except Exception:
            # tracers / abstract values inside jit: fall back to the terse
            # default rather than crashing a debug print
            return (f"SchrodingerProblem(nsteps={self.nsteps}, "
                    f"solver={self.solver!r}, dtype={self.dtype!r})")


def _check_problem(system_sym, system_asym, sym_ops, asym_ops, u0, v0,
                   guard, N_ess_levels):
    """Input validation, mirroring src/SchrodingerProb.jl:73-154."""
    N = system_sym.shape[0]
    if system_sym.shape != (N, N):
        raise ValueError("Real part of system Hamiltonian is not square.")
    if system_asym.shape != (N, N):
        raise ValueError(
            f"Size {system_asym.shape} of imaginary part of Hamiltonian does "
            f"not match size {(N, N)} of real part.")
    if not np.allclose(system_sym, system_sym.T, atol=0.0):
        raise ValueError("Real part of system Hamiltonian is not symmetric.")
    if not np.allclose(system_asym, -system_asym.T, atol=0.0):
        raise ValueError(
            "Imaginary part of system Hamiltonian is not anti-symmetric.")
    if sym_ops.shape[0] != asym_ops.shape[0]:
        raise ValueError(
            f"Number of symmetric operators {sym_ops.shape[0]} does not match "
            f"number of anti-symmetric operators {asym_ops.shape[0]}.")
    for i, op in enumerate(sym_ops):
        if op.shape != (N, N):
            raise ValueError(f"Symmetric operator {i} has wrong shape.")
        if not np.allclose(op, op.T, atol=0.0):
            raise ValueError(f"Symmetric operator {i} is not symmetric.")
    for i, op in enumerate(asym_ops):
        if op.shape != (N, N):
            raise ValueError(f"Anti-symmetric operator {i} has wrong shape.")
        if not np.allclose(op, -op.T, atol=0.0):
            raise ValueError(f"Anti-symmetric operator {i} is not anti-symmetric.")
    if u0.shape != v0.shape:
        raise ValueError(
            f"Size {u0.shape} of the real part of the initial condition does "
            f"not match size {v0.shape} of the imaginary part.")
    if u0.shape[0] != N:
        raise ValueError(
            f"Number of levels {u0.shape[0]} in initial condition is "
            f"inconsistent with system Hamiltonian size {N}.")
    if guard.shape != (2 * N, 2 * N):
        raise ValueError(
            f"Guard subspace projector size {guard.shape} should be twice the "
            f"size {(N, N)} of the complex-valued system.")
    if N_ess_levels > N:
        raise ValueError(
            f"Number of essential levels {N_ess_levels} cannot be greater "
            f"than the total number of levels {N}.")


def schrodinger_problem(
    system_sym,
    system_asym,
    sym_operators,
    asym_operators,
    u0,
    v0,
    tf: float,
    nsteps: int,
    N_ess_levels: int,
    guard_subspace_projector=None,
    *,
    solver: str = "lu",
    gmres_abstol: float = 1e-10,
    gmres_reltol: float = 1e-10,
    gmres_iters: int = 20,
    preconditioner_type: str = "identity",
) -> SchrodingerProblem:
    """Build a validated :class:`SchrodingerProblem` from real split operators.

    Analogue of the inner constructor at src/SchrodingerProb.jl:50-165.
    ``sym_operators``/``asym_operators`` may be a list of (N, N) arrays or a
    stacked (N_ops, N, N) array (an empty list means no controls).
    """
    system_sym = np.asarray(system_sym, dtype=np.float64)
    system_asym = np.asarray(system_asym, dtype=np.float64)
    N = system_sym.shape[0]

    def _stack(ops):
        ops = np.asarray(ops, dtype=np.float64)
        if ops.size == 0:
            return np.zeros((0, N, N), dtype=np.float64)
        if ops.ndim == 2:
            ops = ops[None]
        return ops

    sym_operators = _stack(sym_operators)
    asym_operators = _stack(asym_operators)
    u0 = np.asarray(u0, dtype=np.float64)
    v0 = np.asarray(v0, dtype=np.float64)
    if u0.ndim == 1:
        u0 = u0[:, None]
        v0 = v0[:, None]
    if guard_subspace_projector is None:
        guard_subspace_projector = np.zeros((2 * N, 2 * N), dtype=np.float64)
    guard_subspace_projector = np.asarray(
        guard_subspace_projector, dtype=np.float64)

    _check_problem(system_sym, system_asym, sym_operators, asym_operators,
                   u0, v0, guard_subspace_projector, N_ess_levels)

    return SchrodingerProblem(
        system_sym=_as_f64(system_sym),
        system_asym=_as_f64(system_asym),
        sym_operators=_as_f64(sym_operators),
        asym_operators=_as_f64(asym_operators),
        u0=_as_f64(u0),
        v0=_as_f64(v0),
        guard_subspace_projector=_as_f64(guard_subspace_projector),
        tf=_as_f64(tf),
        nsteps=int(nsteps),
        N_ess_levels=int(N_ess_levels),
        solver=solver,
        gmres_abstol=float(gmres_abstol),
        gmres_reltol=float(gmres_reltol),
        gmres_iters=int(gmres_iters),
        preconditioner_type=preconditioner_type,
    )


def schrodinger_problem_complex(
    system_hamiltonian,
    sym_operators,
    asym_operators,
    U0,
    tf: float,
    nsteps: int,
    N_ess_levels: int,
    guard_subspace_projector=None,
    **kwargs,
) -> SchrodingerProblem:
    """Build from a complex Hermitian Hamiltonian and complex initial states,
    splitting real/imaginary parts (outer constructor,
    src/SchrodingerProb.jl:167-233)."""
    H = np.asarray(system_hamiltonian, dtype=np.complex128)
    if not np.allclose(H, H.conj().T):
        raise ValueError("System Hamiltonian is not Hermitian.")
    U0 = np.asarray(U0, dtype=np.complex128)
    return schrodinger_problem(
        np.real(H), np.imag(H), sym_operators, asym_operators,
        np.real(U0), np.imag(U0), tf, nsteps, N_ess_levels,
        guard_subspace_projector, **kwargs)


def working_problem(prob: SchrodingerProblem) -> SchrodingerProblem:
    """Cast the propagation arrays to the problem's working dtype (no-op for
    the default f64). The guard projector and ``tf`` stay f64 — objectives
    always reduce in f64."""
    if prob.dtype != "float32":
        return prob
    c = lambda x: x.astype(jnp.float32)
    return dataclasses.replace(
        prob,
        system_sym=c(prob.system_sym),
        system_asym=c(prob.system_asym),
        sym_operators=c(prob.sym_operators),
        asym_operators=c(prob.asym_operators),
        u0=c(prob.u0),
        v0=c(prob.v0),
    )


def vector_problem(prob: SchrodingerProblem, ic_index: int) -> SchrodingerProblem:
    """Slice out a single initial-condition column
    (``VectorSchrodingerProb``, src/SchrodingerProb.jl:257-272)."""
    return dataclasses.replace(
        prob,
        u0=prob.u0[:, ic_index:ic_index + 1],
        v0=prob.v0[:, ic_index:ic_index + 1],
    )
