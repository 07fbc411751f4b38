"""The host event library: ctypes bindings of ``csrc/host/cista_events.cpp``.

The source is the JAX package's event library, with the same C ABI
(``voxelize_events``, ``preprocess_std``, ``voxelize_triangular``). On
first use it is compiled with ``g++ -O3 -fPIC -shared -std=c++17
-march=native`` (the JAX package's flags: the same source under the same
flags gives the same voxels bit for bit) into
``build/host/libcista_events_torch-<hash>.so`` at the repo root, the hash
covering the source, the flags and this CPU's feature flags (a library
built for another CPU is not loaded). There is no fallback: a failed build
or load raises, with the compiler's error.

Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host" / "cista_events.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
COMPILER = "g++"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=native"]

_lib = None
_lock = threading.Lock()
_F8 = ctypes.POINTER(ctypes.c_double)
_F4 = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "voxelize_events": [_F8, _F8, _F8, _F8, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int, _F4],
    "preprocess_std": [_F4, ctypes.c_int64, ctypes.c_int, ctypes.c_int],
    "voxelize_triangular": [_F8, _F8, _F8, _F8, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, _F4],
}


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return line
    except OSError:
        pass
    return platform.processor()


def so_path() -> Path:
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(platform.machine().encode())
    h.update(_cpu_flags().encode())
    return BUILD_DIR / f"libcista_events_torch-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path. Raises
    with the compiler's output when the compiler fails or is missing."""
    out = so_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [COMPILER, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host event library: cannot run {COMPILER!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"host event library: {' '.join(cmd)} failed "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = None
            _lib = lib
    return _lib


def _columns(events: np.ndarray, order: str, height: int, width: int):
    """The events' columns as contiguous f64 arrays, after the checks that
    keep the library's writes inside its output: pixel coordinates in the
    frame (NaN fails them)."""
    e = np.ascontiguousarray(events, dtype=np.float64)
    c = {k: np.ascontiguousarray(e[:, i]) for i, k in enumerate(order)}
    for k, size in (("x", width), ("y", height)):
        if len(e) and not ((c[k] >= 0).all() and (c[k] < size).all()):
            raise ValueError(f"event {k} outside [0, {size})")
    return c


def _p8(a):
    return a.ctypes.data_as(_F8)


def voxelize_events(events: np.ndarray, num_bins: int, width: int, height: int,
                    is_reverse: bool = False) -> np.ndarray:
    """N x 4 ``[t, x, y, p]`` -> (num_bins, H, W) float32, bit for bit
    ``voxel.events_to_voxel_grid_numpy``. The times run from the first
    event's to the last's (numpy's order raises or wraps where they do not)."""
    lib = get_lib()
    c = _columns(events, "txyp", height, width)
    if len(events):
        t = c["t"]
        lo, hi = sorted((t[0], t[-1]))
        # every time between the window's first and last: its bins lie in [0, num_bins)
        if not ((t >= lo).all() and (t <= hi).all()):
            raise ValueError("event times outside the window's first and last time")
    out = np.zeros((num_bins, height, width), np.float32)
    lib.voxelize_events(_p8(c["t"]), _p8(c["x"]), _p8(c["y"]), _p8(c["p"]), len(events),
                        num_bins, height, width, int(is_reverse), out.ctypes.data_as(_F4))
    return out


def preprocess_std(voxel: np.ndarray, filter_hot_pixel: bool = False) -> None:
    """Mode 'std' of ``event_preprocess`` in place on a C-contiguous
    float32 voxel; its statistics accumulate in f64 (numpy sums pairwise
    in f32: the two differ by about an ulp of the statistics)."""
    if voxel.dtype != np.float32 or not voxel.flags.c_contiguous:
        raise ValueError("preprocess_std: needs a C-contiguous float32 voxel")
    get_lib().preprocess_std(voxel.ctypes.data_as(_F4), voxel.size, voxel.shape[0],
                             int(filter_hot_pixel))


def voxelize_triangular(events_xytp: np.ndarray, num_bins: int, height: int,
                        width: int) -> np.ndarray:
    """N x 4 ``[x, y, t, p]`` -> (num_bins, H, W) float32: each bin b adds
    p * max(0, 1 - |t_norm - b|) (MVSEC's voxel, ``mvsec_utils``)."""
    lib = get_lib()
    c = _columns(events_xytp, "xytp", height, width)
    out = np.zeros((num_bins, height, width), np.float32)
    lib.voxelize_triangular(_p8(c["t"]), _p8(c["x"]), _p8(c["y"]), _p8(c["p"]),
                            len(events_xytp), num_bins, height, width, out.ctypes.data_as(_F4))
    return out
