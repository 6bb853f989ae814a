"""Build the CUDA kernels with plain ``nvcc`` and load them with ``ctypes``.

At first use each ``csrc/*.cu`` source is compiled by its own ``nvcc``
process, all started together, and one more ``nvcc`` call links the objects
into ``build/stgcn_tpu_torch/libstgcn_kernels-<sha256 of the sources>.so``
under the repository root.  The name carries the sources' hash, so a
library built from other sources is never loaded, and the build writes to
a temporary name and renames it into place, so no lock file is needed.  To force a
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
              "-O3", "-Xcompiler", "-fPIC")
BUILD_TIMEOUT_S = 300

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# block_eval_launch(14 pointers, 16 ints, stream) -> cudaError_t, float32
BLOCK_EVAL_ARGTYPES = [_P] * 14 + [_I] * 16 + [_P]
# block_eval_mma_launch(15 pointers, 23 ints, stream), bf16
BLOCK_EVAL_MMA_ARGTYPES = [_P] * 15 + [_I] * 23 + [_P]
# spatial_block_fwd_launch(7 pointers, 8 ints, stream), float32
SPATIAL_FWD_ARGTYPES = [_P] * 7 + [_I] * 8 + [_P]
# spatial_block_bwd_launch(11 pointers, 10 ints, stream), float32
SPATIAL_BWD_ARGTYPES = [_P] * 11 + [_I] * 10 + [_P]
# spatial_block_save_fwd_launch(8 pointers, 8 ints, stream), float32
SPATIAL_SAVE_FWD_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P]
# spatial_block_save_bwd_launch(11 pointers, 9 ints, stream), float32
SPATIAL_SAVE_BWD_ARGTYPES = [_P] * 11 + [_I] * 9 + [_P]
# temporal_block_fwd_launch(6 pointers, 11 ints, stream), float32
TEMPORAL_FWD_ARGTYPES = [_P] * 6 + [_I] * 11 + [_P]
# temporal_block_bwd_launch(8 pointers, 12 ints, stream), float32
TEMPORAL_BWD_ARGTYPES = [_P] * 8 + [_I] * 12 + [_P]
# spatial_conv_fwd_launch(5 pointers, 8 ints, stream), float32
SPATIAL_CONV_FWD_ARGTYPES = [_P] * 5 + [_I] * 8 + [_P]
# spatial_conv_bwd_launch(9 pointers, 10 ints, stream), float32
SPATIAL_CONV_BWD_ARGTYPES = [_P] * 9 + [_I] * 10 + [_P]
# temporal_conv_fwd_launch(4 pointers, 13 ints, stream), float32
TEMPORAL_CONV_FWD_ARGTYPES = [_P] * 4 + [_I] * 13 + [_P]
# temporal_conv_bwd_launch(6 pointers, 14 ints, stream), float32
TEMPORAL_CONV_BWD_ARGTYPES = [_P] * 6 + [_I] * 14 + [_P]
# temporal_mma_fwd_launch(6 pointers, 15 ints, stream), bf16, both ops
TEMPORAL_MMA_FWD_ARGTYPES = [_P] * 6 + [_I] * 15 + [_P]
# temporal_mma_bwd_launch(10 pointers, 20 ints, stream), bf16, both ops
TEMPORAL_MMA_BWD_ARGTYPES = [_P] * 10 + [_I] * 20 + [_P]
# spatial_mma_fwd_launch(8 pointers, 13 ints, stream), bf16, every op of
# spatial_block.cu
SPATIAL_MMA_FWD_ARGTYPES = [_P] * 8 + [_I] * 13 + [_P]
# spatial_mma_bwd_launch(16 pointers, 25 ints, stream), bf16
SPATIAL_MMA_BWD_ARGTYPES = [_P] * 16 + [_I] * 25 + [_P]
# phase_mark_launch(kind, stream): the empty marker kernel of a phase
PHASE_MARK_ARGTYPES = [_I, _P]
# bn_moments_fwd_launch(4 pointers, 5 ints, stream), any dtype it takes
BN_MOMENTS_FWD_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]
# bn_moments_bwd_launch(4 pointers, 5 ints, stream)
BN_MOMENTS_BWD_ARGTYPES = [_P] * 4 + [_I] * 5 + [_P]
# agcn_gemm_launch(4 pointers, 8 ints, stream), bf16
AGCN_GEMM_ARGTYPES = [_P] * 4 + [_I] * 8 + [_P]
# agcn_gram_launch(p, 3 ints, q, 8 ints, scale, softmax, splits, partial,
# out, stream)
AGCN_GRAM_ARGTYPES = ([_P] + [_I] * 3 + [_P] + [_I] * 8 + [_F, _I, _I]
                      + [_P] * 3)
# agcn_gram_bwd_launch(4 pointers, 6 ints, scale, splits, stream)
AGCN_GRAM_BWD_ARGTYPES = [_P] * 4 + [_I] * 6 + [_F, _I, _P]
# agcn_agg_launch(3 pointers, 6 ints, stream)
AGCN_AGG_ARGTYPES = [_P] * 3 + [_I] * 6 + [_P]
# affine_relu_fwd_launch(6 pointers, elements, 3 ints, stream)
AFFINE_RELU_FWD_ARGTYPES = [_P] * 6 + [_L] + [_I] * 3 + [_P]
# affine_relu_bwd_launch(10 pointers, rows, 3 ints, stream)
AFFINE_RELU_BWD_ARGTYPES = [_P] * 10 + [_L] + [_I] * 3 + [_P]
# unit_tail_fwd_launch(5 pointers, elements, dtype, draw kind, keep_below,
# scale, ctas, stream)
UNIT_TAIL_FWD_ARGTYPES = [_P] * 5 + [_L] + [_I] * 2 + [_F] * 2 + [_I, _P]
# unit_tail_bwd_launch(3 pointers, elements, dtype, scaled, scale, ctas,
# stream)
UNIT_TAIL_BWD_ARGTYPES = [_P] * 3 + [_L] + [_I] * 2 + [_F, _I, _P]
# every C entry point and its argument kinds; each returns a cudaError_t
ENTRY_POINTS = {
    "block_eval_launch": BLOCK_EVAL_ARGTYPES,
    "block_eval_mma_launch": BLOCK_EVAL_MMA_ARGTYPES,
    "spatial_block_fwd_launch": SPATIAL_FWD_ARGTYPES,
    "spatial_block_bwd_launch": SPATIAL_BWD_ARGTYPES,
    "spatial_block_save_fwd_launch": SPATIAL_SAVE_FWD_ARGTYPES,
    "spatial_block_save_bwd_launch": SPATIAL_SAVE_BWD_ARGTYPES,
    "temporal_block_fwd_launch": TEMPORAL_FWD_ARGTYPES,
    "temporal_block_bwd_launch": TEMPORAL_BWD_ARGTYPES,
    "spatial_conv_fwd_launch": SPATIAL_CONV_FWD_ARGTYPES,
    "spatial_conv_bwd_launch": SPATIAL_CONV_BWD_ARGTYPES,
    "temporal_conv_fwd_launch": TEMPORAL_CONV_FWD_ARGTYPES,
    "temporal_conv_bwd_launch": TEMPORAL_CONV_BWD_ARGTYPES,
    "temporal_mma_fwd_launch": TEMPORAL_MMA_FWD_ARGTYPES,
    "temporal_mma_bwd_launch": TEMPORAL_MMA_BWD_ARGTYPES,
    "spatial_mma_fwd_launch": SPATIAL_MMA_FWD_ARGTYPES,
    "spatial_mma_bwd_launch": SPATIAL_MMA_BWD_ARGTYPES,
    "phase_mark_launch": PHASE_MARK_ARGTYPES,
    "bn_moments_fwd_launch": BN_MOMENTS_FWD_ARGTYPES,
    "bn_moments_bwd_launch": BN_MOMENTS_BWD_ARGTYPES,
    "agcn_gemm_launch": AGCN_GEMM_ARGTYPES,
    "agcn_gram_launch": AGCN_GRAM_ARGTYPES,
    "agcn_gram_bwd_launch": AGCN_GRAM_BWD_ARGTYPES,
    "agcn_agg_launch": AGCN_AGG_ARGTYPES,
    "affine_relu_fwd_launch": AFFINE_RELU_FWD_ARGTYPES,
    "affine_relu_bwd_launch": AFFINE_RELU_BWD_ARGTYPES,
    "unit_tail_fwd_launch": UNIT_TAIL_FWD_ARGTYPES,
    "unit_tail_bwd_launch": UNIT_TAIL_BWD_ARGTYPES,
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """The library's path, named by the hash of every source and header."""
    digest = hashlib.sha256()
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libstgcn_kernels-{digest.hexdigest()}.so"


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


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the first failure's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        try:
            _, err = proc.communicate(timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            raise RuntimeError(f"nvcc passed {BUILD_TIMEOUT_S} s: "
                               f"{' '.join(cmd)}") from None
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}): "
                            f"{' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))


def build() -> tuple[Path, float]:
    """Compile the library unless it exists; returns (path, seconds spent).

    One ``nvcc -c`` per source, all at once, then one ``nvcc -shared`` link.
    """
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    nvcc = find_nvcc()
    start = time.perf_counter()
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(sources(), objs)])
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]])
    finally:
        seconds = time.perf_counter() - start
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, lib)
    return lib, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C interface."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.block_eval_error_string.argtypes = [ctypes.c_int]
    lib.block_eval_error_string.restype = ctypes.c_char_p
    return lib
