"""ctypes bindings of the port's host-side C++: ``csrc/squads.cpp`` (the
squad engine's squad formation) and ``csrc/depth.cpp`` (the MegaDepth data
path's correspondence synthesis, valid-depth count and images.txt parser);
and the build of its CUDA sources (``csrc/attention.cu``, bound in
``ops/attention.py``; ``csrc/adam.cu``, bound in ``training/optim.py``).

Each library is compiled into ``build/`` at first use, under a name that
carries its source's hash, and loaded from there: the host sources with the
host C++ compiler, the CUDA ones with ``nvcc`` for ``sm_90a``.
Every function here builds or raises: nothing falls back to numpy. The
caller that wants the numpy path asks for it
(``inference.grouped.form_squads(..., impl="numpy")``,
``data.dataset.compute_corrs(..., impl="numpy")``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_CSRC = Path(__file__).resolve().parent / "csrc"
#: library name -> its source
SOURCES = {"squads": _CSRC / "squads.cpp", "depth": _CSRC / "depth.cpp"}
#: CUDA library name -> its source
CUDA_SOURCES = {"attention": _CSRC / "attention.cu",
                "adam": _CSRC / "adam.cu"}
_BUILD_DIR = Path(__file__).resolve().parents[1] / "build"

_libs = {}
_lib_lock = threading.Lock()


def _compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no C++ compiler (CXX, g++, c++, clang++) found; "
                       "the sources in csrc/ cannot be built")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels cannot be built")


def build_library(name: str = "squads") -> Path:
    """Compile the source of library ``name`` (a key of :data:`SOURCES`)
    into ``build/`` unless a library built from the same source is already
    there. Returns its path."""
    return _build(name, SOURCES[name], lambda: [
        _compiler(), "-O3", "-std=c++17", "-shared", "-fPIC"])


def build_cuda_library(name: str) -> Path:
    """Compile the CUDA source of library ``name`` (a key of
    :data:`CUDA_SOURCES`) for sm_90a into ``build/`` unless a library built
    from the same source is already there. Returns its path."""
    return _build(name, CUDA_SOURCES[name], lambda: [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC"])


def _build(name: str, source: Path, compiler) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    out = _BUILD_DIR / f"libcotr_{name}_{digest}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = compiler() + ["-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(name: str, lib) -> None:
    i64 = ctypes.c_int64
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    if name == "squads":
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.form_squads.restype = i64
        lib.form_squads.argtypes = [f64p, f64p, f64p, f64p, f64p, f64p,
                                    u8p, i64, ctypes.c_double,
                                    ctypes.c_double, i64p, i64, i64,
                                    i64p, i64p]
    else:
        lib.synth_corrs.restype = i64
        lib.synth_corrs.argtypes = [f32p, i64, i64, f64p, f64p, f64p, f32p,
                                    i64, i64, f32p, i64]
        lib.count_valid_depth.restype = i64
        lib.count_valid_depth.argtypes = [f32p, i64, i64]
        lib.parse_images_txt.restype = i64
        lib.parse_images_txt.argtypes = [ctypes.c_char_p, i64, i64p, i64p,
                                         f64p, ctypes.c_char_p, i64]


def _library(name: str = "squads"):
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_library(name)))
            _bind(name, lib)
            _libs[name] = lib
        return _libs[name]


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
    lib = _library("squads")
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


def _depth_map(depth: np.ndarray) -> np.ndarray:
    depth = np.ascontiguousarray(depth, np.float32)
    if depth.ndim != 2:
        raise ValueError(f"a depth map is (h, w), got {depth.shape}")
    return depth


def count_valid_depth(depth: np.ndarray) -> int:
    """The number of pixels of an (h, w) depth map with depth > 0."""
    depth = _depth_map(depth)
    return int(_library("depth").count_valid_depth(depth, *depth.shape))


def synth_corrs(from_depth: np.ndarray, inv_k_from: np.ndarray,
                c2w_from: np.ndarray, p_to: np.ndarray, to_depth: np.ndarray,
                max_out: Optional[int] = None) -> np.ndarray:
    """Depth-consistent correspondences from one RGBD capture to another:
    (N, 4) float32 [x_from, y_from, x_to, y_to], the rows of
    ``data.dataset.compute_corrs(..., impl="numpy")`` in its order (at most
    ``max_out``; by default every valid pixel). ``inv_k_from`` (3, 3),
    ``c2w_from`` (4, 4), ``p_to`` (3, 4) = K_to @ world_to_camera[:3]."""
    from_depth, to_depth = _depth_map(from_depth), _depth_map(to_depth)
    mats = [np.ascontiguousarray(m, np.float64)
            for m in (inv_k_from, c2w_from, p_to)]
    if [m.shape for m in mats] != [(3, 3), (4, 4), (3, 4)]:
        raise ValueError(f"synth_corrs: matrices {[m.shape for m in mats]}, "
                         "want (3, 3), (4, 4), (3, 4)")
    lib = _library("depth")
    if max_out is None:
        max_out = int(lib.count_valid_depth(from_depth, *from_depth.shape))
    out = np.empty((max(max_out, 1), 4), np.float32)
    n = lib.synth_corrs(from_depth, *from_depth.shape, *mats, to_depth,
                        *to_depth.shape, out, max_out)
    return out[:n].copy()


def parse_images_txt(path: str, max_images: Optional[int] = None,
                     name_len: int = 512
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """The image lines of a COLMAP images.txt: (image_ids (n,), camera_ids
    (n,), qtvec (n, 7) [qw qx qy qz tx ty tz] float64, names), in the file's
    order; at most ``max_images`` (by default as many as the file has line
    pairs). Raises OSError when the file cannot be read."""
    lib = _library("depth")
    if max_images is None:
        with open(path, "rb") as f:
            max_images = f.read().count(b"\n") // 2 + 1
    image_ids = np.empty(max_images, np.int64)
    camera_ids = np.empty(max_images, np.int64)
    qtvec = np.empty((max_images, 7), np.float64)
    names_buf = ctypes.create_string_buffer(max_images * name_len)
    n = lib.parse_images_txt(os.fsencode(path), max_images, image_ids,
                             camera_ids, qtvec, names_buf, name_len)
    if n < 0:
        raise OSError(f"cannot read a COLMAP images.txt at {path}")
    raw = names_buf.raw
    names = [raw[i * name_len:(i + 1) * name_len].split(b"\0")[0].decode()
             for i in range(n)]
    return image_ids[:n].copy(), camera_ids[:n].copy(), qtvec[:n].copy(), \
        names
