#!/usr/bin/env python3
"""Phase 21 of ``chip_smoke.py`` alone on one card: each captured step
against the eager one (bitwise state, launches a replay from the counters
and from a ``torch.profiler`` trace, step ms captured and eager in turns,
the host's ms to issue a step, the device's idle share), the captured
``Predictor`` against the eager one (bitwise, seq/s in alternating
rounds), the one-rank NCCL mesh step captured against the captured
unsharded step, and the mesh's remat step against the captured unsharded
remat step and the mesh step without remat.

    python3 scripts/torch_graph_profile.py [case ...]

Cases: fused, route_A, route_B, hybrid, ops, route_A_remat,
route_B_selective, fused_checked, serving, mesh, mesh_remat (all when none
is named).  Builds the kernel library first; prints ``chip_smoke.py``'s
JSON lines and exits non-zero on a failed check.  Imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main(argv: list[str]) -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("torch_graph_profile.py needs a CUDA device", file=sys.stderr)
        return 1
    from stgcn_tpu_torch.kernels import _build
    from stgcn_tpu_torch.parallel.mesh import make_mesh

    names = [name for name, _, _ in cs.GRAPH_CASES]
    extra = ["serving", "mesh", "mesh_remat"]
    wanted = argv or names + extra
    unknown = set(wanted) - set(names) - set(extra)
    if unknown:
        print(f"unknown cases {sorted(unknown)}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build()
    _build.load_library()
    dev = torch.device("cuda")
    cs.graph_phase(smi, dev, cases=[c for c in wanted if c in names],
                   serving="serving" in wanted)
    if "mesh" in wanted or "mesh_remat" in wanted:
        mesh = make_mesh(1, 1, 1)
        x, y = cs.parallel_batch(cs.bench_config(block_impl="fused"))
        if "mesh" in wanted:
            cs.graph_mesh_case(smi, dev, mesh, x, y)
        if "mesh_remat" in wanted:
            cs.graph_mesh_remat_case(smi, dev, mesh, x, y)
        dist.destroy_process_group()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
