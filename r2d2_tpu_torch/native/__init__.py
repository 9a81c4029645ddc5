"""On-demand-built native (C) fast paths for host-side hot loops.

A copy of ``r2d2_tpu/native`` for the port: the prioritised-replay sum
tree's update/descent loops (replay/sum_tree.py), which run under the
replay-buffer lock on a host core shared with actor inference.  This is
host C code, not a device kernel.  The C implementations are exact ports
of the numpy arithmetic (bit-identical, see native/sumtree.c) and release
the GIL for the duration of the call, so the numpy fallback below gives
the same bits and hides no device.

Build model: ``cc -O2 -shared -fPIC`` at first use into a cache directory
(``$R2D2_TORCH_NATIVE_CACHE`` or ``~/.cache/r2d2_tpu_torch``, apart from
the JAX package's), keyed by a content hash of the source; loaded via
ctypes (no Python.h / pybind dependency).  Anything failing — no
compiler, read-only cache, load error — degrades to the numpy
implementations (``R2D2_NO_NATIVE=1`` forces that).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sumtree.c")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _cache_dir() -> str:
    return (os.environ.get("R2D2_TORCH_NATIVE_CACHE")
            or os.path.join(os.path.expanduser("~"), ".cache",
                            "r2d2_tpu_torch"))


def _build() -> Optional[str]:
    try:
        with open(_SRC, "rb") as f:
            import hashlib

            digest = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return None
    # content-keyed cache: mtimes collide across wheel builds
    # (SOURCE_DATE_EPOCH) and same-second edits, silently loading stale code
    # uid-scoped filename: users sharing a cache dir never collide, and a
    # pre-planted file under our exact name still fails the ownership
    # check below and is rebuilt over (never silently loaded)
    out = os.path.join(_cache_dir(), f"sumtree_torch_{digest}_u{os.getuid()}.so")
    if os.path.exists(out):
        # only trust a cached .so we own: a writable shared cache path must
        # not let a pre-planted file be ctypes-loaded into the process
        try:
            if os.stat(out).st_uid == os.getuid():
                return out
        except OSError:
            return None
        # foreign-owned file under our name: fall through and rebuild over
        # it (os.replace) instead of permanently disabling the fast path
    cc = os.environ.get("CC", "cc")
    try:
        os.makedirs(_cache_dir(), mode=0o700, exist_ok=True)
        tmp = out + f".tmp{os.getpid()}"
        subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=60)
        os.replace(tmp, out)  # atomic: concurrent builders race benignly
        return out
    except Exception:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("R2D2_NO_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        i64, f64p, i64p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
                           ctypes.POINTER(ctypes.c_int64))
        lib.st_update.argtypes = [f64p, i64, i64, i64p, f64p, i64]
        lib.st_update.restype = None
        lib.st_descend.argtypes = [f64p, i64, f64p, i64, i64p]
        lib.st_descend.restype = None
        lib.st_prefix_mass.argtypes = [f64p, i64, i64]
        lib.st_prefix_mass.restype = ctypes.c_double
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr_f64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ptr_i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def st_update(nodes: np.ndarray, num_levels: int, leaf_offset: int,
              idxes: np.ndarray, prios: np.ndarray) -> bool:
    """Native leaf-set + ancestor repair.  Returns False when the native
    library is unavailable (caller falls back to numpy).  ``idxes`` must
    be int64 and ``prios`` float64, both contiguous."""
    lib = _load()
    if lib is None:
        return False
    idxes = np.ascontiguousarray(idxes, dtype=np.int64)
    prios = np.ascontiguousarray(prios, dtype=np.float64)
    leaf_count = nodes.size - leaf_offset
    if idxes.size and (int(idxes.min()) < 0 or int(idxes.max()) >= leaf_count):
        # match the numpy path's IndexError instead of letting the C loop
        # write outside the nodes heap
        raise IndexError(
            f"sum-tree leaf index out of range [0, {leaf_count}): "
            f"[{int(idxes.min())}, {int(idxes.max())}]")
    lib.st_update(_ptr_f64(nodes), num_levels, leaf_offset,
                  _ptr_i64(idxes), _ptr_f64(prios), idxes.size)
    return True


def st_descend(nodes: np.ndarray, num_levels: int,
               targets: np.ndarray) -> Optional[np.ndarray]:
    """Native top-down descent; returns leaf node ids, or None when the
    native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    targets = np.ascontiguousarray(targets, dtype=np.float64)
    out = np.empty(targets.size, dtype=np.int64)
    lib.st_descend(_ptr_f64(nodes), num_levels, _ptr_f64(targets),
                   targets.size, _ptr_i64(out))
    return out


def st_prefix_mass(nodes: np.ndarray, leaf_offset: int,
                   leaf_idx: int) -> Optional[float]:
    lib = _load()
    if lib is None:
        return None
    if not 0 <= leaf_idx <= nodes.size - leaf_offset:
        raise IndexError(f"prefix_mass leaf index {leaf_idx} out of range "
                         f"[0, {nodes.size - leaf_offset}]")
    return float(lib.st_prefix_mass(_ptr_f64(nodes), leaf_offset, leaf_idx))
