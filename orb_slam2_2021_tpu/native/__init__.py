"""Native (C++) map-store kernels, loaded via ctypes.

The compute path of this engine is JAX/XLA; this module is the native
runtime piece for host-side bookkeeping the reference implements in C++
(KeyFrame/MapPoint member functions). `map_core.cpp` is compiled with g++ at
first import into `build/native/` at the checkout root (the build also runs
alone with `python -c "import orb_slam2_2021_tpu.native"`). The library's
name carries a hash of the source and the compiler flags, so an edited
source is rebuilt and a stale binary is never loaded. Everything degrades
gracefully to the numpy implementations when no compiler is available
(`HAVE_NATIVE` is False).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "map_core.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
CXXFLAGS = ("-O3", "-shared", "-fPIC")

_lib = None


def lib_path(src: str = SRC, build_dir: str = BUILD_DIR) -> str:
    """Where the library built from `src` lives: named by the hash of the
    source bytes and the flags."""
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXXFLAGS).encode())
    return os.path.join(build_dir, f"libmapcore-{h.hexdigest()[:16]}.so")


def build(src: str = SRC, build_dir: str = BUILD_DIR) -> str:
    """Compile `src` unless its hash-named library exists; return the path.

    g++ writes to a temporary name in the same directory and the result is
    moved into place with os.replace, so concurrent builds (test workers)
    never load a half-written file."""
    out = lib_path(src, build_dir)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=build_dir, suffix=".so.tmp")
    os.close(fd)
    try:
        subprocess.run(["g++", *CXXFLAGS, src, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(build())
    except (OSError, subprocess.CalledProcessError):
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")

    lib.batch_add_observations.restype = ctypes.c_int64
    lib.batch_add_observations.argtypes = [
        ctypes.c_int64, i64p, f32p, ctypes.c_int64,
        i64p, i32p, i32p, i32p, ctypes.c_int64,
    ]
    lib.update_point_stats.restype = None
    lib.update_point_stats.argtypes = [
        i64p, ctypes.c_int64,
        f32p, i64p, i32p, i32p, ctypes.c_int64,
        f32p, f32p, u32p, i32p, ctypes.c_int64,
        f32p, ctypes.c_int32,
        f32p, f32p, f32p, u32p,
    ]
    lib.covis_counts.restype = None
    lib.covis_counts.argtypes = [
        ctypes.c_int64, i64p, ctypes.c_int64,
        i64p, i32p, ctypes.c_int64, i32p,
    ]
    _lib = lib
    return lib


try:
    _load()
except Exception:
    _lib = None

HAVE_NATIVE = _lib is not None


def batch_add_observations(kf, mp_bind, kf_ur, mp_obs_kf, mp_obs_feat, mp_obs_n, mp_n_obs, obs_cap):
    return _lib.batch_add_observations(
        kf, np.ascontiguousarray(mp_bind), np.ascontiguousarray(kf_ur, np.float32),
        len(mp_bind), mp_obs_kf, mp_obs_feat, mp_obs_n, mp_n_obs, obs_cap,
    )


def update_point_stats(ids, mp_pos, mp_obs_kf, mp_obs_feat, mp_obs_n, obs_cap,
                       kf_R, kf_t, kf_desc, kf_octave, n_feats,
                       scale_factors, mp_normal, mp_min_dist, mp_max_dist, mp_desc):
    ids = np.ascontiguousarray(ids, np.int64)
    _lib.update_point_stats(
        ids, len(ids), mp_pos, mp_obs_kf, mp_obs_feat, mp_obs_n, obs_cap,
        kf_R, kf_t, kf_desc, kf_octave, n_feats,
        np.ascontiguousarray(scale_factors, np.float32), len(scale_factors),
        mp_normal, mp_min_dist, mp_max_dist, mp_desc,
    )


def covis_counts(kf, kf_mp, mp_obs_kf, mp_obs_n, obs_cap, counts):
    _lib.covis_counts(
        kf, np.ascontiguousarray(kf_mp, np.int64), len(kf_mp),
        mp_obs_kf, mp_obs_n, obs_cap, counts,
    )
