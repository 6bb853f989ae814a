"""Dropout, linear head and global pooling (port of
``stgcn_tpu/ops/common.py:17-76``).

Counterparts of the reference's ``nn.Dropout`` (src/network/
st_graphconv.py:53-58), ``F.avg_pool2d`` global pool
(src/lightning_model.py:105) and ``nn.Linear`` classifier head
(src/lightning_model.py:88).
"""

from __future__ import annotations

import torch

from stgcn_tpu_torch.ops.batchnorm import stat_dtype


DROPOUT_IMPLS = ("exact", "bits8")


def dropout(x: torch.Tensor, rate: float, *, generator: torch.Generator,
            train: bool = True, impl: str = "exact") -> torch.Tensor:
    """Inverted dropout, torch's train-time scaling by ``1/(1-rate)``.

    The keep mask is drawn from ``generator``, which must live on ``x``'s
    device (:func:`dropout_draw`), and applied by :func:`apply_dropout`.
    ``impl="exact"`` keeps an element where a float32 uniform
    falls below ``1 - rate``.  ``impl="bits8"`` (port of the JAX
    ``impl="bits8"``) draws one random byte per element instead and keeps
    it below ``round(keep * 256)``: the keep probability quantizes to
    ``thresh / 256`` (exact for the reference's rate 0.5) and the rescale
    uses that effective probability, so the op stays unbiased at every
    rate; a threshold of 0 or 256 takes the exact path.  The two packages'
    random bits differ, so the masks agree in distribution only.
    """
    _check_impl(impl)
    if not train or rate == 0.0:
        return x
    return apply_dropout(x, *dropout_draw(x.shape, rate, generator=generator,
                                          device=x.device, impl=impl))


def _check_impl(impl: str) -> None:
    if impl not in DROPOUT_IMPLS:
        raise ValueError(f"dropout impl must be one of {DROPOUT_IMPLS}, got "
                         f"{impl!r}")


def dropout_draw(shape, rate: float, *, generator: torch.Generator, device,
                 impl: str = "exact") -> tuple[torch.Tensor, float, float]:
    """Dropout's draw for an output of ``shape`` at ``0 < rate < 1``:
    ``(draw, keep_below, scale)``, an element kept where ``draw <
    keep_below`` and then divided by ``scale``.  ``impl="exact"``: a
    float32 uniform an element, ``1 - rate`` twice; ``"bits8"``: a random
    byte an element, ``thresh`` and ``thresh / 256`` (see
    :func:`dropout`)."""
    _check_impl(impl)
    keep = 1.0 - rate
    if impl == "bits8":
        thresh = int(round(keep * 256))
        if 0 < thresh < 256:
            bits = torch.randint(0, 256, shape, generator=generator,
                                 dtype=torch.uint8, device=device)
            return bits, thresh, thresh / 256.0
    return torch.rand(shape, generator=generator, device=device), keep, keep


def apply_dropout(x: torch.Tensor, draw: torch.Tensor, keep_below,
                  scale: float) -> torch.Tensor:
    """``x / scale`` where ``draw < keep_below``, else 0, in ``x``'s dtype
    (the draw of :func:`dropout_draw`)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(draw < keep_below, x / scale, zero)


def global_avg_pool(x: torch.Tensor,
                    time_mask: torch.Tensor | None = None,
                    group=None) -> torch.Tensor:
    """Mean over (T, V): ``(N, T, V, C) -> (N, C)`` in at least float32.

    ``time_mask`` (``(N, T)`` booleans) averages the valid frames only.
    ``group``: the ranks whose equal shards of T (or V) make the whole;
    the sums are all-reduced over it, with their gradients.
    """
    acc = stat_dtype(x)
    if group is not None:
        from stgcn_tpu_torch.parallel.collectives import (
            all_reduce_sum,
            group_size,
            sum_over,
        )
    if time_mask is None:
        pooled = x.to(acc).mean(dim=(1, 2))
        if group is None:
            return pooled
        return all_reduce_sum(pooled * (1.0 / group_size(group)), group,
                              "pool")
    m = time_mask[:, :, None, None].to(acc)
    total = (x.to(acc) * m).sum(dim=(1, 2))
    count = m.sum(dim=(1, 2)) * x.shape[2]
    if group is not None:
        total = all_reduce_sum(total, group, "pool")
        count = sum_over(count, group, "pool")
    return total / torch.clamp(count, min=1.0)


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with ``w`` of shape ``(C_in, C_out)``, accumulated in
    at least float32 and cast back to ``x``'s dtype."""
    acc = stat_dtype(x)
    out = x.to(acc) @ params["w"].to(x.dtype).to(acc)
    return (out + params["b"].to(x.dtype).to(acc)).to(x.dtype)
