"""A plain PyTorch ST-GCN: the yardstick that decides ``correct``.

Written from the model's description (Yan et al., AAAI 2018, and the
configuration files beside this package), in float32 by default, with no
kernel, no cache, no batching tricks and TF32 off.  It imports nothing of
the program under test and takes nothing the program made: the graph's
partitions and their normalization are built here from the configuration's
edge list and the distances that the benchmark hands both sides; the
weights are the benchmark's, copied.

Layout: activations are ``(N, C, T, V)``.  The parameters are one
dictionary a block, in the layout the benchmark makes them
(``stgcn_bench.weights``): ``spatial.w`` ``(C_in, K, C_out)``, ``spatial.b``
``(K, C_out)``, ``temporal.w`` ``(gamma, 1, C_in, C_out)``, ``temporal.b``,
``bn1``/``bn2`` ``scale``/``offset``, ``mask`` ``(K, V, V)`` (learned edge
importance, multiplied into the normalized adjacency) and, where a block
changes width or stride, ``residual_proj`` ``w`` ``(C_in, C_out)`` and ``b``.

The unit (full pre-activation residual order): BN, ReLU, the K-partition
graph conv ``out[v] = sum_k sum_w A_k[v, w] (x[w] W_k + b_k)``, BN, ReLU,
the gamma x 1 temporal conv (zero padding ``(gamma - 1) / 2``, stride), plus
the shortcut (identity, or the strided 1 x 1 projection), ReLU, dropout.
BatchNorm in training normalizes with the batch's biased variance (eps
1e-5) and moves its running statistics by 0.1 towards the batch mean and
unbiased variance.  Then the mean over frames and joints and a linear head.

``rounding`` rounds every tensor that a lower-precision program would hold
in its compute type (conv inputs and weights, the expanded partitions,
each block's outputs, the head): ``None`` keeps the reference's own
precision; :func:`fp8_rounding` is the control of the correctness check.
"""

from __future__ import annotations

import contextlib
import math
from collections import deque

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
NORM_ALPHA = 0.001


# ---- the graph ---------------------------------------------------------

def hop_rings(edges, num_joints: int, d: int) -> list[list[set]]:
    """``rings[i][h]``: the joints exactly ``h`` hops from ``i``, for
    ``h`` in ``0..d``."""
    nbrs = [set() for _ in range(num_joints)]
    for a, b in edges:
        nbrs[a].add(b)
        nbrs[b].add(a)
    rings = []
    for i in range(num_joints):
        seen, frontier, mine = {i}, {i}, [{i}]
        for _ in range(d):
            frontier = {w for u in frontier for w in nbrs[u]} - seen
            seen |= frontier
            mine.append(frontier)
        rings.append(mine)
    return rings


def partitions(edges, num_joints: int, strategy: str, d: int = 1,
               distances=None) -> np.ndarray:
    """The ``(K, V, V)`` 0/1 partition matrices of a labeling strategy.

    ``distance``: partition ``h`` holds the neighbours ``h`` hops away
    (``h = 0`` the joint itself), ``K = d + 1``.  ``spatial_configuration``
    (``K = 3``): of the neighbours within ``d`` hops, those as far from the
    gravity centre as the root (the root itself), nearer (centripetal) and
    farther (centrifugal), by ``distances``.
    """
    rings = hop_rings(edges, num_joints, d)
    if strategy == "distance":
        a = np.zeros((d + 1, num_joints, num_joints), np.float64)
        for i in range(num_joints):
            for h in range(d + 1):
                a[h, i, sorted(rings[i][h])] = 1.0
        return a
    if strategy == "spatial_configuration":
        dist = np.asarray(distances, np.float64).reshape(-1)
        a = np.zeros((3, num_joints, num_joints), np.float64)
        for i in range(num_joints):
            for j in set().union(*rings[i]):
                k = 0 if dist[j] == dist[i] else (1 if dist[j] < dist[i]
                                                  else 2)
                a[k, i, j] = 1.0
        return a
    raise ValueError(f"unknown strategy {strategy!r}")


def normalized_adjacency(edges, num_joints: int, strategy: str, d: int = 1,
                         distances=None) -> np.ndarray:
    """Each partition as ``(D + alpha)^-1/2 A (D + alpha)^-1/2``, ``D`` its
    row sums and ``alpha`` 0.001; float32 ``(K, V, V)``."""
    out = []
    for a in partitions(edges, num_joints, strategy, d, distances):
        s = (a.sum(axis=1) + NORM_ALPHA) ** -0.5
        out.append(s[:, None] * a * s[None, :])
    return np.stack(out).astype(np.float32)


def gravity_distances(xy: torch.Tensor) -> np.ndarray:
    """Mean distance of each joint to the frame's gravity centre (the mean
    of the joints' positions) over every frame of ``xy`` ``(..., V, 2)``,
    as the source computes them over its data set."""
    xy = xy.to(torch.float64)
    centre = xy.mean(dim=-2, keepdim=True)
    dist = (xy - centre).norm(dim=-1)
    return dist.reshape(-1, xy.shape[-2]).mean(dim=0).cpu().numpy()


# ---- rounding ----------------------------------------------------------

class _Round(torch.autograd.Function):
    """Rounds the values through ``fwd`` and their gradients through
    ``bwd``, each tensor scaled so that its largest magnitude lands on the
    type's largest value (the per-tensor scaling of 8-bit training)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _through(x, fwd)

    @staticmethod
    def backward(ctx, g):
        return _through(g, ctx.bwd), None, None


def _through(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x / scale).clamp(-top, top).to(dtype).to(x.dtype)) * scale


def fp8_rounding(x: torch.Tensor) -> torch.Tensor:
    """8-bit floats as fp8 training uses them: e4m3 values, e5m2
    gradients, each tensor scaled to its largest magnitude."""
    return _Round.apply(x, torch.float8_e4m3fn, torch.float8_e5m2)


def bf16_rounding(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x, torch.bfloat16, torch.bfloat16)


def _keep(x):
    return x


@contextlib.contextmanager
def no_tf32():
    """float32 matrix products and convolutions in float32, not TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---- the network -------------------------------------------------------

def _moments(h: torch.Tensor):
    mean = h.mean(dim=(0, 2, 3))
    var = (h - mean[None, :, None, None]).square().mean(dim=(0, 2, 3))
    return mean, var


def _bn(h, p, mean, var):
    inv = torch.rsqrt(var + BN_EPS) * p["scale"]
    return (h - mean[None, :, None, None]) * inv[None, :, None, None] \
        + p["offset"][None, :, None, None]


def _unit(bp: dict, bs: dict, x: torch.Tensor, a: torch.Tensor, *,
          stride: int, gamma: int, train: bool, keep_mask, keep: float, q):
    """One unit on ``(N, C, T, V)``; returns the output and the batch
    moments of its two BatchNorms (None outside training)."""
    moments = []

    def bn(key, h):
        if train:
            mean, var = _moments(h)
            moments.append((mean, var))
        else:
            mean, var = bs[key]["mean"], bs[key]["var"]
        return _bn(h, bp[key], mean, var)

    h = q(torch.relu(bn("bn1", x)))
    w, b = q(bp["spatial"]["w"]), q(bp["spatial"]["b"])
    y = q(torch.einsum("nctv,cko->nkotv", h, w)
          + b[None, :, :, None, None])
    z = q(torch.einsum("kvw,nkotw->notv", q(a), y))
    h = q(torch.relu(bn("bn2", z)))
    wt = q(bp["temporal"]["w"][:, 0]).permute(2, 1, 0)[..., None]
    u = q(F.conv2d(h, wt, bp["temporal"]["b"], stride=(stride, 1),
                   padding=((gamma - 1) // 2, 0)))
    if "residual_proj" in bp:
        rp = bp["residual_proj"]
        xs = x[:, :, ::stride]
        short = q(q(torch.einsum("nctv,co->notv", xs, q(rp["w"])))
                  + q(rp["b"])[None, :, None, None])
    else:
        short = x
    out = q(torch.relu(u + short))
    if keep_mask is not None:
        out = q(torch.where(keep_mask, out / keep, torch.zeros_like(out)))
    return (out, *[m for pair in moments for m in pair])


def forward(params: dict, state: dict, x: torch.Tensor, adjacency, plan,
            *, gamma: int = 9, train: bool = False, keep_masks=None,
            dropout: float = 0.0, rounding=None, remat: bool = False):
    """Logits of ``x`` ``(N, T, V, C)`` and the new running statistics
    (``state`` itself outside training).  ``keep_masks`` (training with
    dropout): one boolean ``(N, C, T, V)`` tensor a unit.  ``remat``
    recomputes each unit in the backward, so that large batches fit."""
    q = rounding or _keep
    h = q(x.permute(0, 3, 1, 2))
    new_blocks = []
    for i, (_, stride) in enumerate(plan):
        bp, bs = params["blocks"][i], state["blocks"][i]
        a = adjacency * bp["mask"] if "mask" in bp else adjacency
        km = keep_masks[i] if keep_masks is not None else None
        count = h.shape[0] * h.shape[2] * h.shape[3]

        def unit(h, bp=bp, bs=bs, a=a, stride=stride, km=km):
            return _unit(bp, bs, h, a, stride=stride, gamma=gamma,
                         train=train, keep_mask=km, keep=1.0 - dropout, q=q)

        if remat and train:
            h, *moments = checkpoint(unit, h, use_reentrant=False)
        else:
            h, *moments = unit(h)
        if train:
            new_blocks.append({
                key: _running(bs[key], mean, var, count)
                for key, mean, var in (("bn1", *moments[0:2]),
                                       ("bn2", *moments[2:4]))})
    pooled = h.mean(dim=(2, 3))
    fc = params["fc"]
    logits = q(q(pooled) @ q(fc["w"]) + q(fc["b"]))
    return logits, ({"blocks": new_blocks} if train else state)


def _running(bs: dict, mean, var, count: int) -> dict:
    """New running statistics from a batch's mean and biased variance
    over ``count`` values a channel."""
    m = BN_MOMENTUM
    return {"mean": (1 - m) * bs["mean"] + m * mean.detach(),
            "var": (1 - m) * bs["var"]
            + m * var.detach() * (count / (count - 1))}


def cross_entropy(logits, labels):
    """Mean cross-entropy, in at least float32."""
    acc = torch.promote_types(logits.dtype, torch.float32)
    return -torch.log_softmax(logits.to(acc), dim=-1).gather(
        -1, labels[:, None].long())[:, 0].mean()


# ---- training ----------------------------------------------------------

def leaves(tree, prefix=""):
    """``{path: tensor}`` of a nested dictionary and list tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        if torch.is_tensor(v):
            out[path] = v
        else:
            out.update(leaves(v, path))
    return out


class Optimizer:
    """``adam`` (bias-corrected moments, ``p -= lr mu^ / (sqrt(nu^) +
    eps)``) or ``momentum`` (``trace = g + m trace``, ``p -= lr trace``),
    in the parameters' own precision."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.t = 0
        self.slots: dict = {}

    @torch.no_grad()
    def update(self, params: dict, grads: dict) -> None:
        s = self.spec
        self.t += 1
        lr = s["lr"]
        for path, p in params.items():
            g = grads[path]
            if s["name"] == "adam":
                b1, b2, eps = s.get("b1", 0.9), s.get("b2", 0.999), \
                    s.get("eps", 1e-8)
                mu, nu = self.slots.setdefault(
                    path, (torch.zeros_like(p), torch.zeros_like(p)))
                mu.mul_(b1).add_(g, alpha=1 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1 - b2)
                mu_hat = mu / (1 - b1 ** self.t)
                nu_hat = nu / (1 - b2 ** self.t)
                p.sub_(lr * mu_hat / (nu_hat.sqrt() + eps))
            elif s["name"] == "momentum":
                (trace,) = self.slots.setdefault(path,
                                                 (torch.zeros_like(p),))
                trace.mul_(s["momentum"]).add_(g)
                p.sub_(lr * trace)
            else:
                raise ValueError(f"unknown optimizer {s['name']!r}")


def train(params: dict, state: dict, batches, adjacency, plan, optimizer,
          *, gamma: int = 9, dropout: float = 0.0, keep_masks=None,
          rounding=None, remat: bool = False,
          dtype: torch.dtype = torch.float32) -> dict:
    """Train steps on copies of ``params`` and ``state``, one a batch of
    ``batches`` (``(x, y)`` pairs), ``keep_masks(step)`` the units' keep
    masks of each.  Returns each step's loss, the first step's gradient
    (``{path: tensor}``), and the parameters and the running statistics
    after the last step."""
    params = _copy(params, dtype, requires_grad=True)
    state = _copy(state, dtype)
    adjacency = adjacency.to(dtype)
    flat = leaves(params)
    opt = Optimizer(optimizer)
    losses, first = [], None
    with no_tf32():
        for step, (x, y) in enumerate(batches):
            for p in flat.values():
                p.grad = None
            masks = keep_masks(step) if keep_masks is not None else None
            logits, state = forward(params, state, x.to(dtype), adjacency,
                                    plan,
                                    gamma=gamma, train=True,
                                    keep_masks=masks, dropout=dropout,
                                    rounding=rounding, remat=remat)
            loss = cross_entropy(logits, y)
            loss.backward()
            grads = {k: p.grad if p.grad is not None
                     else torch.zeros_like(p) for k, p in flat.items()}
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            opt.update(flat, grads)
            losses.append(float(loss.detach()))
            del logits, loss, masks, grads
    return {"losses": losses, "first_grads": first,
            "params": {k: p.detach() for k, p in flat.items()},
            "state": leaves(state)}


def _copy(tree, dtype: torch.dtype, requires_grad: bool = False):
    """Copies of a tree's tensors in ``dtype``, leaves of their own."""
    if torch.is_tensor(tree):
        return tree.detach().to(dtype, copy=True).requires_grad_(
            requires_grad)
    if isinstance(tree, dict):
        return {k: _copy(v, dtype, requires_grad) for k, v in tree.items()}
    return [_copy(v, dtype, requires_grad) for v in tree]


# ---- serving -----------------------------------------------------------

def bucket(t: int, buckets) -> int:
    """The smallest bucket that holds ``t`` frames (the largest if none
    does: the clip is cropped)."""
    return next((b for b in buckets if t <= b), buckets[-1])


def wrap_pad(clip: torch.Tensor, length: int) -> torch.Tensor:
    """``(T, V, C)`` repeated from its start up to ``length`` frames, or
    cropped to them."""
    reps = math.ceil(length / clip.shape[0])
    return clip.repeat(reps, 1, 1)[:length]


@torch.no_grad()
def predict(params: dict, state: dict, clips, adjacency, plan, buckets, *,
            gamma: int = 9, rounding=None, batch: int = 64,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Class probabilities ``(len(clips), classes)`` of clips ``(T_i, V,
    C)``: each padded to its bucket by repeating it from its start, run
    through the eval forward (running statistics) ``batch`` at a time."""
    params, state = _copy(params, dtype), _copy(state, dtype)
    adjacency = adjacency.to(dtype)
    by_len: dict = {}
    for i, clip in enumerate(clips):
        by_len.setdefault(bucket(clip.shape[0], buckets), []).append(i)
    out = [None] * len(clips)
    with no_tf32():
        for length, idx in by_len.items():
            todo = deque(idx)
            while todo:
                chunk = [todo.popleft() for _ in range(min(batch, len(todo)))]
                x = torch.stack([wrap_pad(clips[i].to(dtype), length)
                                 for i in chunk])
                logits, _ = forward(params, state, x, adjacency, plan,
                                    gamma=gamma, rounding=rounding)
                probs = torch.softmax(logits.to(torch.float32), dim=-1)
                for i, p in zip(chunk, probs):
                    out[i] = p
    return torch.stack(out)
