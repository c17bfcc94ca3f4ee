"""Native I/O runtime: ctypes bindings over fastio.cpp.

Compiled on first use with g++ (cached next to the source); every entry
point degrades gracefully to the pure-Python readers in io/formats.py if
the toolchain or the .so is unavailable, so the package never hard-depends
on the native path.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "fastio.cpp"
_SO = _HERE / "libkssicp_fastio.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
        str(_SRC), "-o", str(_SO),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
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
        lib.kssicp_parse_points.restype = ctypes.c_long
        lib.kssicp_parse_points.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.kssicp_free.restype = None
        lib.kssicp_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
        lib.kssicp_write_xyz.restype = ctypes.c_int
        lib.kssicp_write_xyz.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
        ]
        lib.kssicp_parse_batch.restype = ctypes.c_int
        lib.kssicp_parse_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_long,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def load_points_native(path) -> Optional[np.ndarray]:
    """(N, 3) float64 or None if the native path can't handle it."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_double)()
    cols = ctypes.c_long(0)
    n = lib.kssicp_parse_points(str(path).encode(), ctypes.byref(buf), ctypes.byref(cols))
    if n < 0:
        return None
    try:
        arr = np.ctypeslib.as_array(buf, shape=(n, cols.value)).copy()
    finally:
        lib.kssicp_free(buf)
    return np.ascontiguousarray(arr[:, :3])


def save_xyz_native(path, points: np.ndarray) -> bool:
    """Write a count-format .xyz via the native writer; False = fall back."""
    lib = _load()
    if lib is None or not hasattr(lib, "kssicp_write_xyz"):
        return False
    pts = np.ascontiguousarray(np.asarray(points, np.float64))
    if pts.ndim != 2 or pts.shape[1] != 3:
        return False
    rc = lib.kssicp_write_xyz(
        str(path).encode(),
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pts.shape[0],
    )
    return rc == 0


def load_points_batch(paths: Sequence) -> Optional[List[Optional[np.ndarray]]]:
    """Threaded batch load; None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    count = len(paths)
    c_paths = (ctypes.c_char_p * count)(*[str(p).encode() for p in paths])
    bufs = (ctypes.POINTER(ctypes.c_double) * count)()
    ns = (ctypes.c_long * count)()
    cols = (ctypes.c_long * count)()
    lib.kssicp_parse_batch(c_paths, count, bufs, ns, cols)
    out: List[Optional[np.ndarray]] = []
    for i in range(count):
        if ns[i] < 0:
            out.append(None)
            continue
        try:
            arr = np.ctypeslib.as_array(bufs[i], shape=(ns[i], cols[i])).copy()
        finally:
            lib.kssicp_free(bufs[i])
        out.append(np.ascontiguousarray(arr[:, :3]))
    return out
