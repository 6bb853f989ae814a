"""Weights, BatchNorm statistics and inputs, made on the device from the
seed in a few large draws.

The parameter dictionaries have one entry a unit (the layout that the
program's ``train_state_from`` takes and the reference reads):
``spatial`` ``w`` ``(C_in, K, C_out)`` and ``b`` ``(K, C_out)``,
``temporal`` ``w`` ``(gamma, 1, C_in, C_out)`` and ``b``, ``bn1``/``bn2``
``scale``/``offset``, ``mask`` ``(K, V, V)`` (learned edge importance)
and, where a unit changes width or stride, ``residual_proj`` ``w``
``(C_in, C_out)`` and ``b``; then ``fc`` ``w`` ``(C, classes)`` and ``b``.
Convolution and linear weights are uniform in ``+-1/sqrt(fan_in)``, as
PyTorch's layers start.  ``trained=False`` gives the state a training job
starts from (BatchNorm scale 1, offset 0, statistics 0 and 1, mask 1);
``trained=True`` gives a served model's, whose BatchNorms, statistics and
masks have moved away from those values.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(plan, c_in, k, v, gamma, classes):
    """``(block or None, group, name, shape, fan_in)`` of every weight
    drawn uniformly."""
    out, c_prev = [], c_in
    for i, (c_out, stride) in enumerate(plan):
        out += [(i, "spatial", "w", (c_prev, k, c_out), c_prev),
                (i, "spatial", "b", (k, c_out), c_prev),
                (i, "temporal", "w", (gamma, 1, c_out, c_out),
                 gamma * c_out),
                (i, "temporal", "b", (c_out,), gamma * c_out)]
        if c_prev != c_out or stride != 1:
            out += [(i, "residual_proj", "w", (c_prev, c_out), c_prev),
                    (i, "residual_proj", "b", (c_out,), c_prev)]
        c_prev = c_out
    out += [(None, "fc", "w", (c_prev, classes), c_prev),
            (None, "fc", "b", (classes,), c_prev)]
    return out


def make_params(plan, *, c_in: int, k: int, v: int, gamma: int,
                classes: int, generator: torch.Generator,
                trained: bool = False, head_gain: float = 1.0
                ) -> tuple[dict, dict]:
    """``(params, state)`` of float32 tensors on the generator's device.
    ``head_gain`` widens the head's weights: with the starting scale the
    pooled features give logits within about 0.1 of each other, where a
    trained classifier's spread over a few units."""
    device = generator.device
    specs = _leaves(plan, c_in, k, v, gamma, classes)
    sizes = [int(np.prod(s)) for *_, s, _ in specs]
    draw = torch.rand(sum(sizes), generator=generator, device=device)
    draw = draw.mul_(2.0).sub_(1.0)
    blocks = [{} for _ in plan]
    fc = {}
    for (i, group, name, shape, fan_in), piece in zip(
            specs, torch.split(draw, sizes)):
        t = (piece * fan_in ** -0.5).reshape(shape)
        if i is None:
            t = t * head_gain
        target = fc if i is None else blocks[i].setdefault(group, {})
        target[name] = t
    widths = [(c_prev, c_out) for c_prev, (c_out, _) in
              zip([c_in] + [c for c, _ in plan[:-1]], plan)]
    # the BatchNorms' four vectors and the mask of every unit in one draw
    n_bn = sum(2 * (a + b) for a, b in widths)
    extra = torch.rand(n_bn + len(plan) * k * v * v, generator=generator,
                       device=device)
    bn_draw, mask_draw = extra[:n_bn], extra[n_bn:]
    states, off = [], 0
    for i, (a, b) in enumerate(widths):
        st = {}
        for key, c in (("bn1", a), ("bn2", b)):
            u = bn_draw[off:off + 2 * c].reshape(2, c)
            off += 2 * c
            if trained:
                blocks[i][key] = {"scale": 0.8 + 0.4 * u[0],
                                  "offset": 0.4 * u[1] - 0.2}
                st[key] = {"mean": 0.6 * u[1] - 0.3,
                           "var": 0.5 + 1.5 * u[0]}
            else:
                blocks[i][key] = {"scale": torch.ones(c, device=device),
                                  "offset": torch.zeros(c, device=device)}
                st[key] = {"mean": torch.zeros(c, device=device),
                           "var": torch.ones(c, device=device)}
        m = mask_draw[i * k * v * v:(i + 1) * k * v * v].reshape(k, v, v)
        blocks[i]["mask"] = (0.8 + 0.4 * m) if trained else \
            torch.ones_like(m)
        states.append(st)
    return {"blocks": blocks, "fc": fc}, {"blocks": states}


def skeleton_clips(n: int, t: int, v: int, c: int,
                   generator: torch.Generator) -> torch.Tensor:
    """``(n, t, v, c)`` float32 skeletons: each joint a fixed offset from
    the body's centre plus a slow random walk, the centre drifting, as
    pose estimates of a moving person look; one large draw."""
    device = generator.device
    noise = torch.randn(n, t + 2, v, c, generator=generator, device=device)
    pose = noise[:, 0:1] * 0.5
    drift = noise[:, 1:2, 0:1] * 0.02
    steps = torch.arange(t, device=device, dtype=torch.float32)
    walk = torch.cumsum(noise[:, 2:] * 0.03, dim=1)
    return pose + walk + drift * steps[None, :, None, None]


def labels(n: int, classes: int, generator: torch.Generator) -> torch.Tensor:
    return torch.randint(0, classes, (n,), generator=generator,
                         device=generator.device)
