#!/usr/bin/env python
"""CNOT3 plateau phase analysis (VERDICT r2 item 1a).

Hypothesis: the round-2 flagship stalled at infidelity ~0.47 because the
target gate was never transformed into the rotating frame. The reference's
documented workflow (docs/src/examples.md:142-146) multiplies the target by
``rotation_matrix(subsystem_sizes, rotation_freqs, tf)`` before optimizing;
our examples/cnot3_optimize_gate.py passed the bare CNOT.

Sharp test: at the plateau pcof, the per-column overlaps <V_col, U_col>
have magnitude 0.95-0.99 but scattered phases phi_col. If the scatter is a
*frame* artifact, phi_col must factorize as single-qudit Z phases:
    phi_col = c + th1*n1(col) + th2*n2(col) + th3*n3(col)  (mod 2pi)
where (n1,n2,n3) are the FINAL-state level indices of that column. We fit
the 4 unknowns to the 8 columns and report the residual. Also reports the
infidelity of the plateau state vs the frame-rotated target with the fitted
thetas, and vs rotation_matrix(..., tf) exactly.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import numpy as np

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

import qgd_tpu
from qgd_tpu.utils.states import real_to_complex

NSTEPS = 1024
TF = 550.0
D1 = 10

prob = qgd_tpu.models.cnot3_problem(tf=TF, nsteps=NSTEPS)
controls = tuple(
    qgd_tpu.CarrierControl(qgd_tpu.BSpline2Control(D1, TF), f)
    for f in qgd_tpu.models.cnot3_carrier_frequencies())

d = np.load(os.path.join(os.path.dirname(__file__), "..", "..",
                         "results", "cnot3_order4_f32.npz"))
pcof = jnp.asarray(d["pcof"][-1])

pairs = []
for k in range(2):
    pairs.append(((1, 1, k), (1, 0, k)))
    pairs.append(((1, 0, k), (1, 1, k)))
target = qgd_tpu.create_gate((4, 4, 4), (2, 2, 2), pairs)   # complex (64, 8)

hist = qgd_tpu.eval_forward_complex(prob, controls, pcof, order=4,
                                    save_every=NSTEPS)
psi_f = np.asarray(hist[-1]) if hist.ndim == 3 else np.asarray(hist)
print("final state shape:", psi_f.shape)

ov = np.einsum("nc,nc->c", target.conj(), psi_f)
print("\nper-column overlaps vs UNROTATED CNOT target:")
ess = list(__import__("itertools").product(range(2), range(2), range(2)))
# final level indices per column (CNOT flips qubit2 when qubit1=1)
finals = [(n1, n2 ^ n1, n3) for (n1, n2, n3) in ess]
for c, (o, fin) in enumerate(zip(ov, finals)):
    print(f"  col {c} {ess[c]}->{fin}: |ov|={abs(o):.4f} "
          f"phase={np.angle(o):+.4f}")

phi = np.angle(ov)
# Fit phi ~ c + th . n  (mod 2pi) via complex least squares on e^{i phi}
A = np.array([[1.0, *fin] for fin in finals])
# solve in the lifted space: minimize sum |e^{i phi} - e^{i A x}|^2 by
# Gauss-Newton from the unwrapped LSQ solution
x0, *_ = np.linalg.lstsq(A, phi, rcond=None)


def resid(x):
    return np.angle(np.exp(1j * (phi - A @ x)))


from scipy.optimize import least_squares
sol = least_squares(resid, x0)
print("\nfit phi = c + th.n (mod 2pi):  x =", sol.x)
print("residual per column:", np.round(resid(sol.x), 4),
      " max:", np.abs(resid(sol.x)).max())

# weighted gate fidelity vs phase-corrected target
corr = np.exp(1j * (A @ sol.x))
tr = (ov * np.conj(corr)).sum()
print(f"\n|tr|/8 vs fitted-phase target: {abs(tr)/8:.6f} "
      f"-> infidelity {1 - (abs(tr)/8)**2:.3e}")

# and vs the documented rotation_matrix(tf) transform
rots = qgd_tpu.rotation_matrix((4, 4, 4),
                               2 * np.pi * np.array([4.10336, 4.81831,
                                                     7.8447]), TF)
R = rots[0] @ rots[1] @ rots[2]
trot = R @ target
ovr = np.einsum("nc,nc->c", trot.conj(), psi_f)
tr2 = ovr.sum()
print(f"|tr|/8 vs rotation_matrix(tf) target: {abs(tr2)/8:.6f} "
      f"-> infidelity {1 - (abs(tr2)/8)**2:.3e}")
print("per-column phases vs rotated target:", np.round(np.angle(ovr), 3))
