"""2s-AGCN, the joint stream (Shi, Zhang, Cheng and Lu, CVPR 2019,
arXiv:1805.07694; ``model/agcn.py`` of github.com/lshiwjx/2s-AGCN).

The network, for input ``(N, M, T, V, C)`` (M bodies a clip):

* ``data_bn``, a BatchNorm over the ``M V C`` channels with its statistics
  over N and T, then the bodies folded into ``N M`` samples;
* ten post-activation units (:data:`DEFAULT_PLAN`); unit ``i``::

      C_k[n] = softmax_i(theta_k(x)^T phi_k(x) / (Ce T))   (adaptive graph)
      g      = sum_k Wd_k (x ._V (A_k + B_k + C_k[n])) + bd_k
      h      = ReLU(BN_g(g) + down(x))    down: identity, or BN(1x1 conv)
      out    = ReLU(BN_t(conv_9x1, stride s (h)) + res(x))

  ``A_k`` the fixed identity/inward/outward subsets
  (:func:`stgcn_tpu_torch.graph.ntu.agcn_subsets`), ``B_k`` learned,
  ``Ce = C_out / coff_embedding``, ``res`` none in the first unit, the
  identity, or BN(strided 1x1 conv);
* the mean over T and V, then over the bodies, and ``fc``.

Activations run V-major, ``(V, N M, T, C)``, as the port's train ops take
them.  ``block_impl`` picks the path: "kernels" (the default) runs the
adaptive graph, the aggregation, the 9x1 conv and the tails on the ops of
:mod:`stgcn_tpu_torch.kernels.adaptive_graph`,
:func:`~stgcn_tpu_torch.kernels.temporal_block.temporal_block` and
:func:`~stgcn_tpu_torch.kernels.affine_relu.affine_add_relu`, whose
backwards are written out (their CUDA kernels on the card, bfloat16 only
for the adaptive graph's; their plain versions on the CPU).  "ops" is the
witness path: the same as plain PyTorch ops under autograd, in any dtype
on any device, which the CPU tests hold against the benchmark's plain
reference and which runs the model in float32 on the card.  Every train
BatchNorm takes its statistics from ``bn_moments``, and the 1x1 convs
(``Wd``, ``down``, ``res``) are matrix products on both paths.

Parameters (one dictionary a unit, float32; :meth:`AGCN.init_params`)::

    gcn: a_w (K, C_in, Ce), a_b (K, Ce)     theta_k
         b_w (K, C_in, Ce), b_b (K, Ce)     phi_k
         d_w (K, C_in, C_out), d_b (K, C_out), PA (K, V, V)   B_k
    bn_g; down {w (C_in, C_out), b}, bn_down  (where C_in != C_out)
    tcn {w (gamma, C_out, C_out), b}, bn_t
    res {w (C_in, C_out), b}, bn_res          (a projected shortcut)

with ``data_bn`` and ``fc`` (``w`` ``(C, classes)``, ``b``) beside the
``units``; each BatchNorm is ``{scale, offset}`` with running ``{mean,
var}`` in the state.  ``apply`` returns ``(logits, new_state)`` as
:meth:`stgcn_tpu_torch.models.stgcn.STGCN.apply` does, so
``make_train_step`` captures its step the same way.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from stgcn_tpu_torch.graph.ntu import agcn_subsets
from stgcn_tpu_torch.kernels.adaptive_graph import (
    adaptive_graph,
    adaptive_graph_forward_reference,
    sample_aggregate,
    sample_aggregate_forward_reference,
)
from stgcn_tpu_torch.kernels.affine_relu import affine_add_relu
from stgcn_tpu_torch.kernels.temporal_block import temporal_block
from stgcn_tpu_torch.models.fused import bn_affine_train
from stgcn_tpu_torch.ops.batchnorm import stat_dtype
from stgcn_tpu_torch.utils.profiling import boundary, mark

DEFAULT_PLAN: tuple[tuple[int, int], ...] = (
    (64, 1), (64, 1), (64, 1), (64, 1),
    (128, 2), (128, 1), (128, 1),
    (256, 2), (256, 1), (256, 1),
)
BLOCK_IMPLS = ("ops", "kernels")


@dataclasses.dataclass(frozen=True)
class AGCNConfig:
    """``compute_dtype`` (e.g. ``torch.bfloat16``) is what activations and
    weights are rounded to; without one they keep the input's dtype.  The
    statistics, the Gram, the softmax and the loss stay in at least
    float32.
    ``dropout_rate`` is 0: the network has none (the train step reads
    it)."""

    plan: tuple[tuple[int, int], ...] = DEFAULT_PLAN
    c_in: int = 3
    num_classes: int = 60
    num_persons: int = 2
    coff_embedding: int = 4
    gamma: int = 9
    compute_dtype: torch.dtype | None = None
    block_impl: str = "kernels"
    dropout_rate: float = 0.0

    def __post_init__(self):
        if self.block_impl not in BLOCK_IMPLS:
            raise ValueError(f"block_impl must be one of {BLOCK_IMPLS}, got "
                             f"{self.block_impl!r}")
        if self.gamma % 2 != 1:
            raise ValueError(f"gamma must be odd, got {self.gamma}")
        if self.dropout_rate:
            raise ValueError("2s-AGCN has no dropout")
        for c_out, _ in self.plan:
            if c_out % self.coff_embedding:
                raise ValueError(f"every width must divide by "
                                 f"coff_embedding={self.coff_embedding}, "
                                 f"got {c_out}")


def units(config: AGCNConfig) -> list[tuple[int, int, int, bool]]:
    """``(c_in, c_out, stride, residual)`` of every unit; the first has no
    shortcut, as published."""
    out, c_prev = [], config.c_in
    for i, (c_out, stride) in enumerate(config.plan):
        out.append((c_prev, c_out, stride, i > 0))
        c_prev = c_out
    return out


def _bn(c: int) -> tuple[dict, dict]:
    return ({"scale": torch.ones(c), "offset": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


def init_params(config: AGCNConfig, seed: int = 0,
                num_joints: int = 25) -> tuple[dict, dict]:
    """``(params, state)`` initialised as ``model/agcn.py`` does: Kaiming
    normal (fan out) convs with zero bias, ``Wd_k`` normal with std
    ``sqrt(2 / (C_out C_in K))``, BatchNorms at scale 1 (``BN_g`` at
    1e-6), ``B_k`` at 1e-6 and ``fc`` normal with std ``sqrt(2 /
    classes)``, drawn from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    k, v = 3, num_joints

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    ps, ss = [], []
    for c_in, c_out, stride, residual in units(config):
        ce = c_out // config.coff_embedding
        p = {"gcn": {
            "a_w": normal((k, c_in, ce), math.sqrt(2.0 / ce)),
            "a_b": torch.zeros(k, ce),
            "b_w": normal((k, c_in, ce), math.sqrt(2.0 / ce)),
            "b_b": torch.zeros(k, ce),
            "d_w": normal((k, c_in, c_out), math.sqrt(2.0 / (c_out * c_in * k))),
            "d_b": torch.zeros(k, c_out),
            "PA": torch.full((k, v, v), 1e-6)}}
        s = {}
        p["bn_g"], s["bn_g"] = _bn(c_out)
        p["bn_g"]["scale"].fill_(1e-6)
        if c_in != c_out:
            p["down"] = {"w": normal((c_in, c_out), math.sqrt(2.0 / c_out)),
                         "b": torch.zeros(c_out)}
            p["bn_down"], s["bn_down"] = _bn(c_out)
        g = config.gamma
        p["tcn"] = {"w": normal((g, c_out, c_out), math.sqrt(2.0 / (c_out * g))),
                    "b": torch.zeros(c_out)}
        p["bn_t"], s["bn_t"] = _bn(c_out)
        if residual and (c_in != c_out or stride != 1):
            p["res"] = {"w": normal((c_in, c_out), math.sqrt(2.0 / c_out)),
                        "b": torch.zeros(c_out)}
            p["bn_res"], s["bn_res"] = _bn(c_out)
        ps.append(p)
        ss.append(s)
    channels = config.num_persons * v * config.c_in
    data_p, data_s = _bn(channels)
    c_last = config.plan[-1][0]
    fc = {"w": normal((c_last, config.num_classes),
                      math.sqrt(2.0 / config.num_classes)),
          "b": torch.zeros(config.num_classes)}
    return ({"data_bn": data_p, "units": ps, "fc": fc},
            {"data_bn": data_s, "units": ss})


def _cast(t: torch.Tensor, cd) -> torch.Tensor:
    return t if cd is None else t.to(cd)


def _conv1x1(x, p: dict, cd, stride: int = 1):
    """A 1x1 conv on ``(V, NM, T, C)``, strided over T: ``x W + b`` in the
    activations' dtype."""
    if stride != 1:
        x = x[:, :, ::stride]
    return x @ _cast(p["w"], cd) + _cast(p["b"], cd)


def _temporal_ops(h, p: dict, cd, stride: int):
    """The 9x1 conv (same padding, ``stride``) as one ``conv2d``."""
    w = _cast(p["w"], cd)                       # (gamma, C, C_out)
    y = F.conv2d(h.permute(1, 3, 2, 0), w.permute(2, 1, 0)[..., None],
                 _cast(p["b"], cd), stride=(stride, 1),
                 padding=((w.shape[0] - 1) // 2, 0))
    return y.permute(3, 0, 2, 1)


def _affine(x, s, t):
    """``x s + t`` per channel in the statistics' dtype."""
    return x.to(s.dtype) * s + t


def _tail(impl: str, a, sa, ta, b, sb, tb):
    """``relu(a sa + ta + (b sb + tb | b | 0))`` in ``a``'s dtype: one
    ``affine_add_relu`` pass on the kernel path, plain ops otherwise."""
    if impl == "kernels":
        return affine_add_relu(a, sa, ta if tb is None else ta + tb, b, sb)
    v = _affine(a, sa, ta)
    if b is not None:
        v = v + (_affine(b, sb, tb) if sb is not None else b.to(v.dtype))
    return torch.relu(v).to(a.dtype)


def unit_train(p: dict, st: dict, x: torch.Tensor, subsets: torch.Tensor, *,
               stride: int, residual: bool, impl: str, cd
               ) -> tuple[torch.Tensor, dict]:
    """One train-mode unit on ``(V, NM, T, C_in)``: ``(out, new_state)``.

    While a profiler records, the tensors between the phases pass through
    :func:`~stgcn_tpu_torch.utils.profiling.boundary`: ``adaptive`` (the
    embeddings, the Gram and the softmax), ``spatial`` (the aggregation,
    ``Wd`` and ``down``'s conv), ``bn_stats``, ``tail`` (the add and the
    ReLU), ``temporal`` (the 9x1 conv and ``res``'s conv), ``bn_stats`` and
    ``tail``, and the same in reverse in the backward."""
    gp = p["gcn"]
    new = {}
    k, c_in, ce = gp["a_w"].shape
    x = boundary("adaptive", "tail", x)
    # theta's K blocks of Ce columns, then phi's
    w = torch.cat([torch.cat(list(gp["a_w"]), dim=1),
                   torch.cat(list(gp["b_w"]), dim=1)], dim=1)
    b = torch.cat([gp["a_b"].reshape(-1), gp["b_b"].reshape(-1)])
    if impl == "kernels":
        c = adaptive_graph(x, w, b, k)
    else:
        c = adaptive_graph_forward_reference(x, w, b, k)[0]
    c = boundary("spatial", "adaptive", c)
    a = c + (subsets + gp["PA"]).to(c.dtype)
    z = (sample_aggregate if impl == "kernels"
         else sample_aggregate_forward_reference)(x, a)
    g = z @ _cast(gp["d_w"], cd).reshape(k * c_in, -1) \
        + _cast(gp["d_b"].sum(dim=0), cd)
    d = _conv1x1(x, p["down"], cd) if "down" in p else x
    g, d = boundary("bn_stats", "spatial", g, d)
    sg, tg, new["bn_g"] = bn_affine_train(p["bn_g"], st["bn_g"], g)
    if "down" in p:
        sd, td, new["bn_down"] = bn_affine_train(p["bn_down"], st["bn_down"],
                                                 d)
    sg, tg = boundary("tail", "bn_stats", sg, tg)
    if "down" in p:
        h = _tail(impl, g, sg, tg, d, sd, td)
    else:
        h = _tail(impl, g, sg, tg, x, None, None)
    h = boundary("temporal", "tail", h)
    if impl == "kernels":
        c_out = h.shape[-1]
        ones = torch.ones(c_out, dtype=torch.float32, device=h.device)
        u = temporal_block(h, ones, torch.zeros_like(ones),
                           _cast(p["tcn"]["w"], cd),
                           p["tcn"]["b"].to(torch.float32), stride=stride,
                           relu2=False)
    else:
        u = _temporal_ops(h, p["tcn"], cd, stride)
    if "res" in p:
        r = _conv1x1(x, p["res"], cd, stride)
        u, r = boundary("bn_stats", "temporal", u, r)
        sr, tr, new["bn_res"] = bn_affine_train(p["bn_res"], st["bn_res"], r)
    else:
        u = boundary("bn_stats", "temporal", u)
    su, tu, new["bn_t"] = bn_affine_train(p["bn_t"], st["bn_t"], u)
    su, tu = boundary("tail", "bn_stats", su, tu)
    if "res" in p:
        out = _tail(impl, u, su, tu, r, sr, tr)
    else:
        out = _tail(impl, u, su, tu, x if residual else None, None, None)
    return out, new


class AGCN(nn.Module):
    """2s-AGCN (joint stream) with weights drawn from ``seed``
    (:func:`init_params`); the fixed subsets are the buffer
    ``subsets``."""

    def __init__(self, config: AGCNConfig, *, seed: int = 0):
        super().__init__()
        self.config = config
        a = torch.from_numpy(agcn_subsets())
        self.num_partitions, self.num_joints = a.shape[0], a.shape[1]
        self.register_buffer("subsets", a, persistent=False)
        self._params, self._state = init_params(config, seed,
                                                self.num_joints)

    def init_params(self, seed: int = 0) -> tuple[dict, dict]:
        """Fresh ``(params, state)`` dictionaries on the CPU."""
        return init_params(self.config, seed, self.num_joints)

    def params_and_state(self) -> tuple[dict, dict]:
        """The weights this module was built with."""
        return self._params, self._state

    def apply(self, params: dict, state: dict, x: torch.Tensor, *,
              train: bool = False, generator: torch.Generator | None = None,
              time_mask: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, dict]:
        """``(logits, new_state)`` of ``x`` ``(N, M, T, V, C)``.  Only the
        train forward exists (batch statistics; ``generator`` is unused,
        the network has no dropout)."""
        if not train:
            raise ValueError("AGCN.apply runs the train forward only")
        if time_mask is not None:
            raise ValueError("AGCN takes no time_mask")
        cfg = self.config
        cd = cfg.compute_dtype
        n, m, t, v, c = x.shape
        mark("input", x.device)
        h = _cast(x, cd).permute(0, 2, 1, 3, 4).reshape(n * t, m * v * c)
        s0, t0, data_state = bn_affine_train(params["data_bn"],
                                             state["data_bn"], h)
        h = _affine(h, s0, t0).to(h.dtype)
        h = h.reshape(n, t, m, v, c).permute(3, 0, 2, 1, 4).reshape(
            v, n * m, t, c).contiguous()
        new_units = []
        for (_, _, stride, residual), p, st in zip(
                units(cfg), params["units"], state["units"]):
            h, s = unit_train(p, st, h, self.subsets, stride=stride,
                              residual=residual, impl=cfg.block_impl, cd=cd)
            new_units.append(s)
        h = boundary("head", "tail", h)
        acc = stat_dtype(h)
        pooled = h.to(acc).mean(dim=(0, 2)).reshape(n, m, -1).mean(dim=1)
        fc = params["fc"]
        logits = pooled.to(h.dtype) @ _cast(fc["w"], cd) + _cast(fc["b"], cd)
        return logits, {"data_bn": data_state, "units": new_units}
