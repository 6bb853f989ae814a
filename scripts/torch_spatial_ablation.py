#!/usr/bin/env python3
"""Where the bf16 spatial backward's t kernel spends its time, on one GPU.

    python3 scripts/torch_spatial_ablation.py [--batch 64] [--reps 5]

Builds ``csrc/spatial_block.cu`` once more for each variant without one
piece of ``spatial_wg_t_kernel`` (the producer's g staging, the h staging
of the y_k recompute, the t_k products, the t_k stores, the wgmma of the
recompute, the dA products) or without all of them, loads each build with
``ctypes`` and, for the spatial shapes of DEFAULT_PLAN at T=304 (random
inputs from a fixed seed, bf16, K=2), reports the t kernel's device ms a
call of ``spatial_conv``'s V-major backward and of ``spatial_block``'s
under every variant (``torch.profiler``).  A variant computes wrong
values: the point is the time each piece holds.  Prints one JSON line per
shape, then the card's name and power limit.  Needs a CUDA device and
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

V, T = 25, 304
# piece -> the source text it removes (each must occur once)
PIECES = {
    "gstage":
        """          stage_slab(gsl, p.g, C_out, s * SN, m0, fc, p, tid - 32, 96);""",
    "hstage":
        """          stage_h<AFF>(hs + b * BM * HP, HP, p, s1s, t1s, m0, fc, tid - 32,
                       96);""",
    "tmma": """          for (int kk = 0; kk < 2; ++kk)
            tap::mma_k16_frag<2, 2>(
                acc, af[kk],
                tap::smem_u32(gsl + (f * V + kk * 16 + (lane & 15)) * YP +
                              cg * 16 + col8));""",
    "tstore": """                if (wj < V && o < p.TP)
                  *reinterpret_cast<__nv_bfloat162*>(
                      tk + at(p.vmajor, V, M, wj, m0 + f, p.TP) + o) =
                      __floats2bfloat162_rn(acc[mi][nj][2 * h],
                                            acc[mi][nj][2 * h + 1]);""",
    "stage1": """    for (int kk = 0; kk < KC / 16; ++kk)
      if (kk < steps) wg::mma_rs<SN>(acc, a[kk], wg::desc_step(desc, kk));""",
    "da": """          for (int f = 0; f < fc; ++f)
            for (int kk = half; kk < steps; kk += 2)
              tap::mma_k16_nk(
                  dacc,
                  tap::smem_u32(gsl + (f * V + (sub >> 1) * 16 +
                                       tap::a_lane_row(lane)) * YP +
                                kk * 16 + col8),
                  tap::smem_u32(yk + (f * V + (sub & 1) * 16 +
                                      tap::at_lane_row(lane)) * YP +
                                kk * 16 + tap::at_lane_col(lane)));""",
}
VARIANTS = {"full": (), **{f"no_{k}": (k,) for k in PIECES},
            "none": tuple(PIECES)}


def build(tmp: Path) -> dict:
    """One library per variant, built in parallel: ``{variant: CDLL}``."""
    from stgcn_tpu_torch.kernels import _build

    src = (_build.CSRC / "spatial_block.cu").read_text()
    for name, text in PIECES.items():
        if src.count(text) != 1:
            raise RuntimeError(f"the {name} piece is not in spatial_block.cu "
                               f"as this script expects")
        src = src.replace(text, f"#if !NO_{name.upper()}\n{text}\n#endif")
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, tmp)
    (tmp / "spatial_block.cu").write_text(src)
    # the error strings come from block_eval.cu's launcher
    shutil.copy(_build.CSRC / "block_eval.cu", tmp)
    nvcc = _build.find_nvcc()
    procs = {}
    for variant, removed in VARIANTS.items():
        flags = [f"-DNO_{k.upper()}={int(k in removed)}" for k in PIECES]
        procs[variant] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, *flags, "-shared", "-o",
             str(tmp / f"lib_{variant}.so"), str(tmp / "spatial_block.cu"),
             str(tmp / "block_eval.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for variant, proc in procs.items():
        _, err = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {variant}:\n{err}")
        lib = ctypes.CDLL(str(tmp / f"lib_{variant}.so"))
        for name, argtypes in _build.ENTRY_POINTS.items():
            if name.startswith(("spatial", "block_eval")):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        lib.block_eval_error_string.argtypes = [ctypes.c_int]
        lib.block_eval_error_string.restype = ctypes.c_char_p
        libs[variant] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_spatial_ablation.py needs a CUDA device",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from stgcn_tpu_torch.kernels import _build
    from stgcn_tpu_torch.kernels import spatial_block as sb
    from stgcn_tpu_torch.kernels import spatial_conv as sc

    dev, bf, n = torch.device("cuda"), torch.bfloat16, args.batch
    gen = torch.Generator(device=dev).manual_seed(0)

    def r(*shape, scale=1.0, loc=0.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale + loc

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(Path(tmp))
        load = _build.load_library
        try:
            for ci, co, t in dict.fromkeys(
                    (ci, co, t) for ci, co, _, t in cs.plan_block_shapes()):
                x = r(V, n, t, ci).to(bf)
                g = r(V, n, t, co).to(bf)
                s1, t1 = r(ci, scale=0.3, loc=1.0), r(ci, scale=0.2)
                w = r(ci, 2, co, scale=ci ** -0.5).to(bf)
                b = r(2, co, scale=0.1).to(bf)
                a = (torch.rand(2, V, V, generator=gen, device=dev)
                     * 0.3).to(bf)
                ops = {
                    "spatial_conv.vntc": lambda: sc.spatial_conv_backward(
                        x.reshape(V, n * t, ci), g.reshape(V, n * t, co), w,
                        b, a, vmajor=True),
                    "spatial_block": lambda: sb.spatial_block_backward(
                        x, g, s1, t1, w, b, a, relu1=True)}
                t_ms = {}
                for name, fn in ops.items():
                    for variant, lib in libs.items():
                        _build.load_library = lambda lib=lib: lib
                        ms = cs.kernel_ms_by_name(fn, args.reps)
                        t_ms.setdefault(name, {})[variant] = sum(
                            v for k, v in ms.items() if "_t_kernel" in k)
                print(json.dumps({"c_in": ci, "c_out": co, "t_in": t,
                                  "t_kernel_ms": t_ms}), flush=True)
        finally:
            _build.load_library = load
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
