"""Adam with optax's numerics (port of ``optax.adam`` as the JAX package
uses it, ``stgcn_tpu/training/optimizers.py``).

optax's Adam divides the bias-corrected first moment by the square root of
the bias-corrected second moment plus ``eps`` (outside the root), which is
what ``torch.optim.Adam`` computes.  The update runs as PyTorch's
multi-tensor (``foreach``) loop over the parameter leaves; its ``fused``
CUDA kernel is a library kernel and is not used.  Learning-rate schedules
(``make_schedule``) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(learning_rate, b1, b2, eps)``; call it on the parameter
    leaves to get the optimizer that updates them in place."""

    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __call__(self, leaves: list[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.Adam(leaves, lr=self.learning_rate,
                                betas=(self.b1, self.b2), eps=self.eps,
                                foreach=True)


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    return Adam(learning_rate, b1, b2, eps)
