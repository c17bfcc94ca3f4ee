"""ctypes bindings over oracle_hot.cpp — native rotation-scan + ICP used by
scripts/calibrate_oracle.py to bound the measured-baseline denominator
(VERDICT round-2 item #5). Compiled on first use with g++ (same pattern as
native/__init__.py); callers must handle `available() == False`."""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "oracle_hot.cpp"
_SO = _HERE / "libkssicp_oracle_hot.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_D = ctypes.POINTER(ctypes.c_double)
_F = ctypes.POINTER(ctypes.c_float)


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           str(_SRC), "-o", str(_SO)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
        return True
    except Exception:
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None
        lib.kssicp_kd_build.restype = ctypes.c_void_p
        lib.kssicp_kd_build.argtypes = [_F, ctypes.c_int]
        lib.kssicp_kd_free.restype = None
        lib.kssicp_kd_free.argtypes = [ctypes.c_void_p]
        lib.kssicp_mean_nn.restype = ctypes.c_double
        lib.kssicp_mean_nn.argtypes = [ctypes.c_void_p, _F, ctypes.c_int]
        lib.kssicp_rotation_scan.restype = ctypes.c_int
        lib.kssicp_rotation_scan.argtypes = [
            _F, ctypes.c_int, ctypes.c_void_p, ctypes.c_double, _D]
        lib.kssicp_icp.restype = ctypes.c_int
        lib.kssicp_icp.argtypes = [
            _F, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, _D, _D,
            ctypes.POINTER(ctypes.c_int)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _as_f32(pts: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(pts), dtype=np.float32)


class NativeKDTree:
    """RAII wrapper over the C++ median-split tree (FLANN's role)."""

    def __init__(self, points: np.ndarray):
        lib = _load()
        if lib is None:
            raise RuntimeError("native oracle_hot unavailable")
        self._lib = lib
        p = _as_f32(points)
        self.n = len(p)
        self._handle = lib.kssicp_kd_build(
            p.ctypes.data_as(_F), ctypes.c_int(self.n))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kssicp_kd_free(self._handle)
            self._handle = None

    def mean_nn(self, pts: np.ndarray) -> float:
        p = _as_f32(pts)
        return float(self._lib.kssicp_mean_nn(
            self._handle, p.ctypes.data_as(_F), ctypes.c_int(len(p))))


def rotation_scan(source: np.ndarray, tree: NativeKDTree, step: float
                  ) -> np.ndarray:
    """Native initRegistration_Rotation: returns the (n, n, n) error field
    (n = 9 at step 8 — the float-accumulation quirk, oracle.py:_scan)."""
    lib = _load()
    src = _as_f32(source)
    # Replicate the angle enumeration to size the output buffer.
    inc, n, a = 6.3 / step, 0, 0.0
    while a < 6.3:
        n += 1
        a += inc
    field = np.empty((n, n, n), np.float64)
    got = lib.kssicp_rotation_scan(
        src.ctypes.data_as(_F), ctypes.c_int(len(src)), tree._handle,
        ctypes.c_double(step), field.ctypes.data_as(_D))
    assert got == n, (got, n)
    return field


def icp_native(
    source: np.ndarray,
    tree: NativeKDTree,
    max_iterations: int = 1000,
    max_correspondence_distance: float = 1.0,
    transformation_epsilon: float = 1e-10,
    euclidean_fitness_epsilon: float = 0.001,
) -> Tuple[np.ndarray, float, int, bool]:
    """Native pcl_icp (oracle.py semantics). Returns
    (final 4x4, fitness, iterations, converged)."""
    lib = _load()
    src = _as_f32(source)
    final = np.empty((4, 4), np.float64)
    fit = ctypes.c_double()
    conv = ctypes.c_int()
    it = lib.kssicp_icp(
        src.ctypes.data_as(_F), ctypes.c_int(len(src)), tree._handle,
        ctypes.c_int(max_iterations),
        ctypes.c_double(max_correspondence_distance),
        ctypes.c_double(transformation_epsilon),
        ctypes.c_double(euclidean_fitness_epsilon),
        final.ctypes.data_as(_D), ctypes.byref(fit), ctypes.byref(conv))
    return final, float(fit.value), int(it), bool(conv.value)
