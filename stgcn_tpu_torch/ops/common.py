"""Linear head and global pooling (port of ``stgcn_tpu/ops/common.py:49-76``).

Counterparts of the reference's ``F.avg_pool2d`` global pool
(src/lightning_model.py:105) and ``nn.Linear`` classifier head
(src/lightning_model.py:88).  Dropout belongs to the training slice.
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.ops.batchnorm import stat_dtype


def global_avg_pool(x: torch.Tensor,
                    time_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean over (T, V): ``(N, T, V, C) -> (N, C)`` in at least float32.

    ``time_mask`` (``(N, T)`` booleans) averages the valid frames only.
    """
    acc = stat_dtype(x)
    if time_mask is None:
        return x.to(acc).mean(dim=(1, 2))
    m = time_mask[:, :, None, None].to(acc)
    total = (x.to(acc) * m).sum(dim=(1, 2))
    count = m.sum(dim=(1, 2)) * x.shape[2]
    return total / torch.clamp(count, min=1.0)


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with ``w`` of shape ``(C_in, C_out)``, accumulated in
    at least float32 and cast back to ``x``'s dtype."""
    acc = stat_dtype(x)
    out = x.to(acc) @ params["w"].to(x.dtype).to(acc)
    return (out + params["b"].to(x.dtype).to(acc)).to(x.dtype)
