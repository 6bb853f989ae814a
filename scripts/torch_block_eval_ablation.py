#!/usr/bin/env python3
"""Where bf16 ``block_eval``'s spatial kernel spends its time, on one GPU.

    python3 scripts/torch_block_eval_ablation.py [--batch 64] [--reps 10]

Builds ``csrc/block_eval.cu`` five more times, each variant without one
piece of ``block_eval_spatial_kernel`` (its z stores, the aggregation, the
h producer's affine, the stage-1 wgmma products, or all four), loads each
build with ``ctypes`` and, for DEFAULT_PLAN's block shapes at T=304 (a
random full-width model, bf16), reports the spatial kernel's device ms a
call under every variant (``torch.profiler``).  A variant computes wrong
values: the point is the time each piece holds.  Prints one JSON line per
block, then the card's name and power limit.  Needs a CUDA device and
``nvcc``; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

V, T = 25, 304
# piece -> the source text it removes (each must occur once)
PIECES = {
    "zstore": """          *reinterpret_cast<uint4*>(p.z + ((size_t)v * M + m0 + f) * C_out +
                                    n0 + q * 8) =
              *reinterpret_cast<const uint4*>(zt + (f * V + v) * YP + q * 8);""",
    "aggregation": """          for (int kk = 0; kk < 2; ++kk)
            tap::mma_k16_frag<2, 2>(
                z[i], af[kk],
                tap::smem_u32(yk + (f * V + kk * 16 + (lane & 15)) * YP +
                              cg * 16 + col8));""",
    "affine": """    const float h =
        tap::affine(live ? __bfloat162float(v[q]) : 0.f, sc[q], sh[q]);
    v[q] = __float2bfloat16_rn(relu1 ? fmaxf(h, 0.f) : h);""",
    "stage1": """      if (kk < steps) wg::mma_rs<SN>(acc, a[kk], wg::desc_step(desc, kk));""",
}
VARIANTS = {"full": (), **{f"no_{k}": (k,) for k in PIECES},
            "no_math_no_stores": tuple(PIECES)}


def build(tmp: Path) -> dict:
    """One library per variant, built in parallel: ``{variant: CDLL}``."""
    from stgcn_tpu_torch.kernels import _build

    src = (_build.CSRC / "block_eval.cu").read_text()
    for name, text in PIECES.items():
        if src.count(text) != 1:
            raise RuntimeError(f"the {name} piece is not in block_eval.cu "
                               f"as this script expects")
        src = src.replace(text, f"#if !NO_{name.upper()}\n{text}\n#endif")
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, tmp)
    (tmp / "block_eval.cu").write_text(src)
    nvcc = _build.find_nvcc()
    procs = {}
    for variant, removed in VARIANTS.items():
        flags = [f"-DNO_{k.upper()}={int(k in removed)}" for k in PIECES]
        procs[variant] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o",
             str(tmp / f"lib_{variant}.so"), str(tmp / "block_eval.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for variant, proc in procs.items():
        _, err = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant}:\n{err}")
        lib = ctypes.CDLL(str(tmp / f"lib_{variant}.so"))
        for name, argtypes in _build.ENTRY_POINTS.items():
            if name.startswith("block_eval"):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        lib.block_eval_error_string.argtypes = [ctypes.c_int]
        lib.block_eval_error_string.restype = ctypes.c_char_p
        libs[variant] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_block_eval_ablation.py needs a CUDA device",
              file=sys.stderr)
        return 1
    from torch_block_eval_profile import kernel_ms

    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.kernels import _build
    from stgcn_tpu_torch.kernels import block_eval as be
    from stgcn_tpu_torch.models.fused import fused_block_args
    from stgcn_tpu_torch.models.stgcn import DEFAULT_PLAN, STGCN, STGCNConfig

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        load = _build.load_library
        dev = torch.device("cuda")
        cfg = STGCNConfig(plan=DEFAULT_PLAN, strategy=Strategy.DISTANCE, d=1,
                          residual=True, compute_dtype=torch.bfloat16)
        model = STGCN(cfg, seed=0).to(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(args.batch, T, V, 2, generator=gen,
                        device=dev).to(torch.bfloat16)
        h = x.permute(2, 0, 1, 3).contiguous()
        try:
            with torch.inference_mode():
                for i, blk in enumerate(model.conv):
                    bp, bs = blk.params_and_state()
                    kw = fused_block_args(bp, bs, model.adjacency,
                                          residual=True, stride=blk.stride)
                    spatial_ms = {}
                    for variant, lib in libs.items():
                        _build.load_library = lambda lib=lib: lib
                        ms = kernel_ms(lambda: be.block_eval(h, **kw),
                                       args.reps)
                        spatial_ms[variant] = sum(
                            v for k, v in ms.items() if "spatial" in k)
                    print(json.dumps({
                        "block": i, "c_in": h.shape[3],
                        "c_out": cfg.plan[i][0], "stride": blk.stride,
                        "t_in": h.shape[2], "spatial_ms": spatial_ms}),
                        flush=True)
                    _build.load_library = lambda: libs["full"]
                    h = be.block_eval(h, **kw)
        finally:
            _build.load_library = load
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
