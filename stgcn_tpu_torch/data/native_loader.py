"""ctypes bindings of the C++ batch loader (port of
``stgcn_tpu/data/native_loader.py``).

``collate_batch_native`` reads a whole batch of ``.npy`` skeleton files,
drops the OpenPose confidence channel and wrap-pads each sequence into one
float32 array with a C++ thread pool: the native counterpart of the numpy
``collate``.  The library is the repository's ``native/npy_loader.cc``,
compiled at first use by ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
into ``build/stgcn_tpu_torch/libstgcn_native-<sha256 of the source>.so``
(beside the kernel library, as ``kernels/_build.py`` names it), written
under a temporary name and renamed into place.  The JAX package's
``native/libstgcn_native.so`` is never loaded, written or rebuilt here.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from stgcn_tpu_torch.kernels._build import BUILD_DIR, REPO_ROOT

SOURCE = REPO_ROOT / "native" / "npy_loader.cc"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
BUILD_TIMEOUT_S = 300


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()
    return BUILD_DIR / f"libstgcn_native-{digest}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path.  A failed
    compile raises ``RuntimeError`` with g++'s output."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ did not run: {' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}"
                           f"\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process and declare the C API."""
    lib = ctypes.CDLL(str(build()))
    lib.stgcn_collate_batch.restype = ctypes.c_int
    lib.stgcn_collate_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.stgcn_npy_frames.restype = ctypes.c_int64
    lib.stgcn_npy_frames.argtypes = [ctypes.c_char_p]
    lib.stgcn_last_error.restype = ctypes.c_char_p
    lib.stgcn_last_error.argtypes = []
    return lib


def npy_frames(path: str) -> int:
    """Frame count of a ``.npy`` file, read from its header alone."""
    n = load_library().stgcn_npy_frames(os.fsencode(path))
    if n < 0:
        raise IOError(f"cannot read npy header: {path}")
    return int(n)


def collate_batch_native(paths: list[str], target_t: int, v: int = 25,
                         keep_c: int = 2, out: np.ndarray | None = None,
                         n_threads: int = 0) -> np.ndarray:
    """Load ``paths`` into a ``(len(paths), target_t, v, keep_c)`` float32
    batch, wrap-padding or cropping each sequence's time axis (reference
    semantics, src/data/util.py:12-47).  ``out``, if given, must be a
    C-contiguous float32 array of that shape; ``n_threads`` 0 lets the
    library choose.  A file that cannot be read raises ``IOError``."""
    lib = load_library()
    n = len(paths)
    shape = (n, target_t, v, keep_c)
    if out is None:
        out = np.empty(shape, np.float32)
    elif (out.shape != shape or out.dtype != np.float32
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"out must be C-contiguous float32 {shape}, got "
                         f"{out.dtype} {out.shape}")
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.stgcn_collate_batch(
        c_paths, n, target_t, v, keep_c,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if rc != 0:
        raise IOError(lib.stgcn_last_error().decode())
    return out
