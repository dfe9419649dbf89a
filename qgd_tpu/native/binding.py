"""ctypes binding + on-demand build for the native de Boor library.

The reference builds its Fortran with a makefile and loads via ccall
(src/Fortran/makefile, src/Controls/FortranBSpline.jl:257-278); here a
single g++ invocation at first use produces ``libqgd_bspline.so`` next to
this file, cached across sessions.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bsplvd.cc")
_LIB = os.path.join(_HERE, "libqgd_bspline.so")

_lib = None


def build_library(force: bool = False) -> str:
    """Compile bsplvd.cc -> libqgd_bspline.so (g++ -O3 -shared -fPIC).
    The library is written under a per-process name and renamed into place,
    so concurrent first uses never load a half-written file."""
    if force or (not os.path.exists(_LIB)
                 or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        tmp = f"{_LIB}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
             "-o", tmp],
            check=True, capture_output=True)
        os.replace(tmp, _LIB)
    return _LIB


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.qgd_bsplvb.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_double, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double)]
        lib.qgd_bsplvd.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_double, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
        lib.qgd_bspline_tables.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def bsplvb(knots, k: int, x: float, left: int) -> np.ndarray:
    """Values of the k non-vanishing order-k B-splines at x
    (0-based ``left``: t[left] <= x < t[left+1])."""
    lib = _load()
    knots = np.ascontiguousarray(knots, dtype=np.float64)
    out = np.zeros(k)
    lib.qgd_bsplvb(_dptr(knots), k, float(x), int(left), _dptr(out))
    return out


def bsplvd(knots, k: int, x: float, left: int, nderiv: int) -> np.ndarray:
    """(k, nderiv) array: entry (i, m) is the m-th derivative of the i-th
    non-vanishing order-k B-spline at x."""
    lib = _load()
    knots = np.ascontiguousarray(knots, dtype=np.float64)
    out = np.zeros((nderiv, k))
    lib.qgd_bsplvd(_dptr(knots), k, float(x), int(left), _dptr(out),
                   int(nderiv))
    return out.T.copy()


def bspline_tables(knots, k: int, n_distinct: int, xs, nderiv: int):
    """Batched basis tables over points ``xs`` in [0, 1]:
    returns (values (n_x, nderiv, k), offsets (n_x,))."""
    lib = _load()
    knots = np.ascontiguousarray(knots, dtype=np.float64)
    xs = np.ascontiguousarray(xs, dtype=np.float64)
    n_x = xs.shape[0]
    out = np.zeros((n_x, nderiv, k))
    offsets = np.zeros(n_x, dtype=np.int64)
    lib.qgd_bspline_tables(
        _dptr(knots), int(k), int(n_distinct), _dptr(xs), n_x, int(nderiv),
        _dptr(out), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out, offsets
