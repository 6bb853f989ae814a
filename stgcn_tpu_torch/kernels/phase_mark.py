"""The phase marker kernel (``csrc/phase_mark.cu``): an empty kernel per
phase of the train step, launched ``<<<1, 1>>>`` on the current stream, so
that a captured step's phases show on the device timeline of a profiler
trace as ``void stgcn_phase_mark<stgcn_phase::<kind>>()``.  Placed by
:func:`stgcn_tpu_torch.utils.profiling.mark`, which runs it only while a
profiler records."""

from __future__ import annotations

import torch

# the kinds in the order of phase_mark_launch's switch
KINDS = ("input", "bn_stats", "spatial", "temporal", "tail", "head",
         "grad_sync", "optimizer", "adaptive")


def phase_mark(kind: str, device: torch.device) -> None:
    """Launch the marker of ``kind`` on ``device``'s current stream."""
    from stgcn_tpu_torch.kernels._build import load_library

    index = KINDS.index(kind)
    lib = load_library()
    with torch.cuda.device(device):
        err = lib.phase_mark_launch(
            index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.block_eval_error_string(err).decode()
        raise RuntimeError(f"phase mark {kind} launch failed: CUDA error "
                           f"{err} ({msg})")
