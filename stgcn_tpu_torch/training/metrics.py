"""Classification metrics (port of ``stgcn_tpu/training/metrics.py:16-41``).

Cross-entropy with ``torch.nn.functional.cross_entropy`` semantics (mean over
the batch) computed in float32 whatever the logits' dtype, argmax accuracy,
the confusion matrix of the eval step and top-k accuracy.
"""

from __future__ import annotations

import torch


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy, in at least float32."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    logp = torch.log_softmax(logits.to(acc), dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0].mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of correct argmax predictions, as a float32 scalar."""
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()


def confusion_matrix(logits: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """``(C, C)`` counts, rows the true labels, columns the predictions."""
    pred = logits.argmax(dim=-1)
    cm = torch.zeros(num_classes * num_classes, dtype=torch.int64,
                     device=logits.device)
    cm.index_add_(0, labels.long() * num_classes + pred,
                  torch.ones_like(pred))
    return cm.view(num_classes, num_classes)


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                  k: int = 1) -> torch.Tensor:
    """Fraction of rows whose label is among the ``k`` largest logits, as
    a float32 scalar."""
    idx = logits.topk(k, dim=-1).indices
    return (idx == labels[:, None]).any(dim=-1).to(torch.float32).mean()
