"""Juqbox interchange (reference
src/ProblemConstructors/juqbox_converter.jl:1-91).

The reference converts in-memory between its ``SchrodingerProb`` and
Juqbox.jl's ``objparams``. Juqbox is a Julia package, so the Python
equivalent works through a serialized dict/JSON/npz representation of
``objparams``'s fields (the same field names the reference reads:
``Hconst``, ``Hsym_ops``, ``Hanti_ops``, ``Uinit``, ``T``, ``nsteps``,
``N``, ``Ne``, ``Ng``, ``wmat_real``) so problems exported from a Julia
session (e.g. via ``NPZ.jl``) round-trip into this framework.
"""

from __future__ import annotations

import numpy as np

from ..problem import SchrodingerProblem, schrodinger_problem_complex


def convert_juqbox(params: dict, **kwargs) -> SchrodingerProblem:
    """Build a problem from a dict of Juqbox ``objparams`` fields
    (reference ``convert_juqbox``, juqbox_converter.jl:1-49).

    Required keys: ``Hconst`` (N, N) complex; ``Hsym_ops``/``Hanti_ops``
    lists of (N, N); ``Uinit`` (N, N_ess); ``T``; ``nsteps``; ``N``
    (essential dimension). Optional: ``wmat_real`` (N, N) guard weight
    matrix (lifted to ``[[W, 0], [0, W]]`` exactly as the reference does);
    ``Hunc_ops`` must be absent or empty.
    """
    if params.get("Hunc_ops"):
        raise ValueError("Uncoupled operators (Hunc_ops) are not supported "
                         "(the reference asserts the same, "
                         "juqbox_converter.jl:13).")
    H = np.asarray(params["Hconst"], dtype=np.complex128)
    N = H.shape[0]
    sym_ops = [np.asarray(op, dtype=np.float64)
               for op in params.get("Hsym_ops", [])]
    asym_ops = [np.asarray(op, dtype=np.float64)
                for op in params.get("Hanti_ops", [])]
    U0 = np.asarray(params["Uinit"], dtype=np.complex128)
    W_r = params.get("wmat_real")
    if W_r is not None:
        W_r = np.asarray(W_r, dtype=np.float64)
        Z = np.zeros_like(W_r)
        guard = np.block([[W_r, Z], [Z, W_r]])
    else:
        guard = None
    return schrodinger_problem_complex(
        H, sym_ops, asym_ops, U0, float(params["T"]),
        int(params["nsteps"]), int(params["N"]), guard, **kwargs)


def convert_to_juqbox(prob: SchrodingerProblem, Ne, Ng, Cfreq, nCoeff,
                      target_complex) -> dict:
    """Export a problem to a dict of Juqbox ``objparams`` keyword fields
    (reference ``convert_to_juqbox``, juqbox_converter.jl:57-91), ready to
    be fed to ``Juqbox.objparams`` from a Julia session (e.g. via npz)."""
    u0 = np.asarray(prob.u0)
    v0 = np.asarray(prob.v0)
    S = np.asarray(prob.system_asym)
    K = np.asarray(prob.system_sym)
    return dict(
        Ne=list(Ne),
        Ng=list(Ng),
        Tmax=float(prob.tf),
        nsteps=int(prob.nsteps),
        Uinit=u0 - 1j * v0,
        Utarget=np.asarray(target_complex),
        Cfreq=np.asarray(Cfreq),
        Rfreq=np.full(prob.N_operators, np.nan),
        Hconst=np.block([[S, -K], [K, S]]),
        Hsym_ops=[np.asarray(op) for op in prob.sym_operators],
        Hanti_ops=[np.asarray(op) for op in prob.asym_operators],
        nCoeff=int(nCoeff),
    )


def load_juqbox_npz(path: str, **kwargs) -> SchrodingerProblem:
    """Load a Juqbox problem exported as .npz (arrays keyed by objparams
    field names; operator lists as ``Hsym_ops_0``, ``Hsym_ops_1``, ...)."""
    data = np.load(path)
    params = {k: data[k] for k in ("Hconst", "Uinit", "T", "nsteps", "N")}
    for key in ("Hsym_ops", "Hanti_ops"):
        ops = []
        i = 0
        while f"{key}_{i}" in data:
            ops.append(data[f"{key}_{i}"])
            i += 1
        params[key] = ops
    if "wmat_real" in data:
        params["wmat_real"] = data["wmat_real"]
    return convert_juqbox(params, **kwargs)
