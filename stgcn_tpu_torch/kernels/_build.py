"""Build the CUDA kernels with plain ``nvcc`` and load them with ``ctypes``.

At first use the sources under ``csrc/`` are compiled, in one ``nvcc`` call,
into ``build/stgcn_tpu_torch/libblock_eval-<sha256 of the sources>.so`` under
the repository root.  The name carries the sources' hash, so a library built
from other sources is never loaded, and the build writes to a temporary
name and renames it into place, so no lock file is needed.  To force a
rebuild, delete ``build/stgcn_tpu_torch/``.

The sources include no PyTorch header: the kernels have a plain C interface,
and the wrappers pass pointers from ``Tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream().cuda_stream``.  This keeps the build to
seconds where ``torch.utils.cpp_extension.load`` takes minutes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build" / "stgcn_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 300

_P, _I = ctypes.c_void_p, ctypes.c_int
# block_eval_launch(14 pointers, 17 ints, stream) -> cudaError_t
BLOCK_EVAL_ARGTYPES = [_P] * 14 + [_I] * 17 + [_P]


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libblock_eval-{digest.hexdigest()}.so"


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's default install location."""
    root = os.environ.get("CUDA_HOME")
    if root and (Path(root) / "bin" / "nvcc").exists():
        return str(Path(root) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def build() -> tuple[Path, float]:
    """Compile the library unless it exists; returns (path, seconds spent)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources())]
    start = time.perf_counter()
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=BUILD_TIMEOUT_S)
    except subprocess.CalledProcessError as err:
        raise RuntimeError(
            f"nvcc failed ({err.returncode}): {' '.join(cmd)}\n"
            f"{err.stderr}") from err
    finally:
        seconds = time.perf_counter() - start
    os.replace(tmp, lib)
    return lib, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C interface."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.block_eval_launch.argtypes = BLOCK_EVAL_ARGTYPES
    lib.block_eval_launch.restype = ctypes.c_int
    lib.block_eval_error_string.argtypes = [ctypes.c_int]
    lib.block_eval_error_string.restype = ctypes.c_char_p
    return lib
