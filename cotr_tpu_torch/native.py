"""ctypes binding of the port's host-side C++ (``csrc/squads.cpp``).

The library is compiled with the host C++ compiler into ``build/`` at first
use, under a name that carries the source's hash, and loaded from there.
:func:`form_squads` builds or raises: nothing here falls back to numpy. The
caller that wants the numpy scan asks for it
(``inference.grouped.form_squads(..., impl="numpy")``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "csrc" / "squads.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build"

_lib = None
_lib_lock = threading.Lock()


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no C++ compiler (CXX, g++, c++, clang++) found; "
                       "csrc/squads.cpp cannot be built")


def build_library() -> Path:
    """Compile ``csrc/squads.cpp`` into ``build/`` unless a library built
    from the same source is already there. Returns its path."""
    digest = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:12]
    out = _BUILD_DIR / f"libcotr_squads_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_compiler(), "-O3", "-std=c++17", "-shared", "-fPIC", "-o",
           str(tmp), str(_SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            i64 = ctypes.c_int64
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.form_squads.restype = i64
            lib.form_squads.argtypes = [f64p, f64p, f64p, f64p, f64p, f64p,
                                        u8p, i64, ctypes.c_double,
                                        ctypes.c_double, i64p, i64, i64,
                                        i64p, i64p]
            _lib = lib
        return _lib


def form_squads(loc_from: np.ndarray, loc_to: np.ndarray,
                cf_x: np.ndarray, cf_y: np.ndarray,
                ct_x: np.ndarray, ct_y: np.ndarray,
                active: np.ndarray, half_f: float, half_t: float,
                order: np.ndarray, max_load: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Grid-bucketed greedy squad formation: the same result as
    ``inference.grouped._form_squads_numpy`` for the same ``order``.
    Returns (squad_of (T,), pilots (G,)). Raises RuntimeError when the
    library cannot be built."""
    lib = _library()
    t = len(loc_from)
    locs = [np.ascontiguousarray(a, np.float64) for a in (loc_from, loc_to)]
    centres = [np.ascontiguousarray(a, np.float64)
               for a in (cf_x, cf_y, ct_x, ct_y)]
    active = np.ascontiguousarray(active, np.uint8)
    order = np.ascontiguousarray(order, np.int64)
    # the library indexes by these without checking
    if any(a.shape != (t, 2) for a in locs) \
            or any(a.shape != (t,) for a in centres + [active]):
        raise ValueError(f"form_squads: arrays disagree on {t} tasks")
    if order.ndim != 1 or (len(order) and not (
            0 <= order.min() and order.max() < t)):
        raise ValueError(f"form_squads: order must hold task ids below {t}")
    squad_of = np.empty(t, np.int64)
    pilots = np.empty(max(t, 1), np.int64)
    g = lib.form_squads(*locs, *centres, active, t, float(half_f),
                        float(half_t), order, len(order), int(max_load),
                        squad_of, pilots)
    return squad_of, pilots[:g].copy()
