"""State-sharded (tensor-parallel) propagation for large systems.

For systems too large for one device's memory (many coupled qudits: N grows
as the product of subsystem sizes), the level dimension itself is sharded
over a ``tp`` mesh axis:

* drift and control operators are *row-sharded*: each device holds
  ``(N/tp, N)`` row blocks of ``K``/``S``;
* the state keeps u/v stacked per shard: ``w_local = (2, N/tp, B)``;
* a Hamiltonian application is ``all_gather`` of the state over ``tp``
  followed by local row-block matmuls — one collective of ``2NB`` floats
  per matvec, riding ICI;
* the implicit stage is matrix-free GMRES whose inner products ``psum``
  over ``tp`` (a dense LU is not available across shards) — this is where
  the reference's GMRES formulation (src/forward_evolution.jl:142-220)
  earns its keep here: it is the natural *distributed* solver,
  while the single-chip path uses the dense direct solve.

The (scenario, ic) axes of qgd_tpu/parallel/sharded.py compose with this:
scenario x tp is the production mesh for large-N sweeps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..controls import control_tables, as_control_tuple
from ..ops.hermite import hermite_coefficients


def make_tp_mesh(n_tp: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    dev = np.asarray(devices[:n_tp])
    return Mesh(dev, axis_names=("tp",))


def _apply_A_local(S_loc, K_loc, p_k, q_k, S_drift_loc, K_drift_loc,
                   u_full, v_full, k: int):
    """Row-block application of the scaled generator ``A~_k``:
    given the *gathered* full state (u_full, v_full) and local row blocks,
    return local rows of (S u + K v, S v - K u)."""
    S_eff = jnp.einsum("j,jab->ab", q_k, S_loc)
    K_eff = jnp.einsum("j,jab->ab", p_k, K_loc)
    if k == 0:
        S_eff = S_eff + S_drift_loc
        K_eff = K_eff + K_drift_loc
    out_u = S_eff @ u_full + K_eff @ v_full
    out_v = S_eff @ v_full - K_eff @ u_full
    return out_u, out_v


def _sharded_derivs(blocks, P_t, Q_t, w_loc, m, axis):
    """Scaled-derivative recursion with the state sharded over ``axis``.
    ``w_loc (2, N_loc, B)``; returns list of local derivative blocks."""
    S_loc, K_loc, Sd_loc, Kd_loc = blocks
    Ws = [w_loc]
    for j in range(m):
        acc_u = acc_v = None
        for i in range(j + 1):
            k = j - i
            w_full = jax.lax.all_gather(Ws[i], axis, axis=1, tiled=True)
            ou, ov = _apply_A_local(S_loc, K_loc, P_t[k], Q_t[k],
                                    Sd_loc, Kd_loc,
                                    w_full[0], w_full[1], k)
            acc_u = ou if acc_u is None else acc_u + ou
            acc_v = ov if acc_v is None else acc_v + ov
        Ws.append(jnp.stack([acc_u, acc_v]) / (j + 1))
    return Ws


def _combine(Ws, dt, m, sign):
    c = hermite_coefficients(m)
    acc = c[0] * Ws[0]
    dt_pow = 1.0
    for j in range(1, m + 1):
        dt_pow = dt_pow * (sign * dt)
        acc = acc + (c[j] * dt_pow) * Ws[j]
    return acc


def _sharded_gmres(apply_lhs, b_loc, x0_loc, iters: int, axis):
    """GMRES with vectors sharded over ``axis``: all inner products and
    norms psum over the shards; the small Hessenberg solve is replicated."""
    def pdot(a, b):
        return jax.lax.psum(jnp.sum(a * b), axis)

    def pnorm(a):
        return jnp.sqrt(pdot(a, a))

    shape = b_loc.shape
    r0 = b_loc - apply_lhs(x0_loc)
    beta = pnorm(r0)
    eps = jnp.asarray(1e-300, dtype=b_loc.dtype)
    V = jnp.zeros((iters + 1,) + shape, dtype=b_loc.dtype)
    V = V.at[0].set(r0 / jnp.maximum(beta, eps))
    H = jnp.zeros((iters + 1, iters), dtype=b_loc.dtype)

    def arnoldi(j, carry):
        V, H = carry
        w = apply_lhs(V[j])

        def mgs(i, wh):
            w, h = wh
            hij = jnp.where(i <= j, pdot(V[i], w), 0.0)
            w = w - hij * V[i]
            return w, h.at[i].set(hij)

        w, hcol = jax.lax.fori_loop(
            0, iters + 1, mgs, (w, jnp.zeros(iters + 1, dtype=b_loc.dtype)))
        hnorm = pnorm(w)
        hcol = hcol.at[j + 1].set(hnorm)
        V = V.at[j + 1].set(w / jnp.maximum(hnorm, eps))
        H = H.at[:, j].set(hcol)
        return V, H

    V, H = jax.lax.fori_loop(0, iters, arnoldi, (V, H))
    e1 = jnp.zeros(iters + 1, dtype=b_loc.dtype).at[0].set(beta)
    y, *_ = jnp.linalg.lstsq(H, e1)
    return x0_loc + jnp.tensordot(y, V[:iters], axes=1)


@partial(jax.jit, static_argnames=("order", "mesh", "gmres_iters"))
def tp_forward_history(prob, controls, pcof, mesh: Mesh, order: int = 4,
                       gmres_iters: int = 20):
    """Forward evolution with the level dimension sharded over the mesh's
    ``tp`` axis. Returns the full (replicated) history ``(T, 2N, B)``,
    bit-comparable to :func:`qgd_tpu.eval_forward` with the GMRES solver.
    """
    controls = as_control_tuple(controls)
    m = order // 2
    dt = prob.tf / prob.nsteps
    ts = jnp.arange(prob.nsteps + 1, dtype=jnp.float64) * dt
    Pt, Qt = control_tables(controls, pcof, ts, m)
    N = prob.N_tot_levels
    B = prob.N_initial_conditions

    # (2, N, B) stacked u/v state; operators stacked (N_ops, N, N)
    w0 = jnp.stack([prob.u0, prob.v0])

    def local(S_ops, K_ops, Sd, Kd, w0_loc, Pt_a, Qt_a):
        blocks = (S_ops, K_ops, Sd, Kd)

        def step(w_loc, xs):
            pq_n, pq_np1 = xs
            Ws = _sharded_derivs(blocks, pq_n[0], pq_n[1], w_loc, m, "tp")
            rhs = _combine(Ws, dt, m, 1.0)

            def apply_lhs(v_loc):
                Vs = _sharded_derivs(blocks, pq_np1[0], pq_np1[1], v_loc,
                                     m, "tp")
                return _combine(Vs, dt, m, -1.0)

            # Taylor initial guess (reference src/forward_evolution.jl:184)
            x0 = Ws[m]
            for j in range(m - 1, -1, -1):
                x0 = Ws[j] + dt * x0
            w_next = _sharded_gmres(apply_lhs, rhs, x0, gmres_iters, "tp")
            return w_next, w_next

        xs = ((Pt_a[:-1], Qt_a[:-1]), (Pt_a[1:], Qt_a[1:]))
        _, traj = jax.lax.scan(step, w0_loc, xs)
        hist_loc = jnp.concatenate([w0_loc[None], traj], axis=0)
        # gather the full history for the (replicated) return value
        return jax.lax.all_gather(hist_loc, "tp", axis=2, tiled=True)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(None, "tp", None), P(None, "tp", None),
                  P("tp", None), P("tp", None), P(None, "tp", None),
                  P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    n_ops = max(prob.N_operators, 1)
    S_ops = prob.asym_operators if prob.N_operators else jnp.zeros(
        (0, N, N), dtype=jnp.float64)
    K_ops = prob.sym_operators if prob.N_operators else jnp.zeros(
        (0, N, N), dtype=jnp.float64)
    hist = fn(S_ops, K_ops, prob.system_asym, prob.system_sym, w0, Pt, Qt)
    # (T, 2, N, B) -> (T, 2N, B)
    return hist.reshape(hist.shape[0], 2 * N, B)
