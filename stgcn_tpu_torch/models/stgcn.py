"""The ST-GCN network as ``nn.Module``s (port of ``models/stgcn.py``).

Ten spatial-temporal blocks, global average pool and a linear classifier,
with the channel/stride plan of the reference (src/lightning_model.py:65-88,
src/network/stgcn.py:40-53).  Parameter names and shapes are the
reference's state-dict names (``conv.{i}.spatialConv.W.weight``,
``conv.{i}.batch_n.*``, ``conv.{i}.batch_n_2.*``, ``conv.{i}.temporalConv.*``,
``conv.{i}.apply_residual.*``, ``Masks.{i}``, ``fc_layer.*``), so a
reference-format state dict, or one made by
:func:`stgcn_tpu_torch.models.convert.state_dict_from_jax`, loads with
``load_state_dict``.

``spatialConv.A`` holds each block's effective adjacency: the whole trained
adjacency in ``"reference"`` mode, ``A ⊙ M`` in ``"mask"`` mode (the
reference format folds the mask into ``A``), and the fixed normalized
adjacency, as a buffer, in ``"fixed"`` mode.

``forward`` is the eval forward on the op path (:mod:`stgcn_tpu_torch.ops`),
the oracle of the fused forward in :mod:`stgcn_tpu_torch.models.fused`.

Training works on parameter dictionaries in the JAX package's layout, as
its ``STGCN.init``/``apply`` do: :meth:`STGCN.init_params` draws them
(mask mode keeps ``mask`` apart from the fixed adjacency, since Adam walks
the mask), :meth:`STGCN.params_and_state` gives the module's own weights in
that layout, and :meth:`STGCN.apply` runs the train or eval forward on the
op path, the fused kernels or the hybrid (``block_impl``), returning
``(logits, new_state)``.
``stgcn_tpu_torch.models.convert.state_dict_from_params`` folds trained
dictionaries back into the reference-named state dict.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn
from torch.nn.utils import skip_init

from stgcn_tpu_torch.graph import adjacency as adj
from stgcn_tpu_torch.ops.batchnorm import stat_dtype
from stgcn_tpu_torch.ops.block import (
    ADJACENCY_MODES,
    block_forward,
    block_forward_train,
    block_forward_vm,
    checkpointed,
)
from stgcn_tpu_torch.ops.common import DROPOUT_IMPLS, global_avg_pool, linear
from stgcn_tpu_torch.ops.spatial_conv import SPATIAL_IMPLS
from stgcn_tpu_torch.ops.temporal_conv import TEMPORAL_IMPLS
from stgcn_tpu_torch.tree import tree_map
from stgcn_tpu_torch.utils.profiling import boundary, mark

# (c_out, temporal stride) per block.
DEFAULT_PLAN: tuple[tuple[int, int], ...] = (
    (64, 1), (64, 1), (64, 1), (64, 1),
    (128, 2), (128, 1), (128, 1),
    (256, 2), (256, 1), (256, 1),
)

# The 9-layer variant of the course report (stgcn.txt:39-49).
PLAN_9: tuple[tuple[int, int], ...] = (
    (64, 1), (64, 1), (64, 1),
    (128, 2), (128, 1), (128, 1),
    (256, 2), (256, 1), (256, 1),
)


@dataclasses.dataclass(frozen=True)
class STGCNConfig:
    """The fields of ``stgcn_tpu.models.stgcn.STGCNConfig`` the eval and
    train paths read.  ``dtype`` is the parameter and activation dtype;
    ``compute_dtype`` (e.g. ``torch.bfloat16``) the dtype activations and
    weights are rounded to, ``None`` meaning ``dtype``.

    Train fields: ``dropout_rate`` after each block's outer ReLU;
    ``dropout_impl`` "exact" (a float32 uniform an element) or "bits8" (a
    random byte an element, :func:`stgcn_tpu_torch.ops.common.dropout`);
    ``mask_jitter`` for the initial mask / trained adjacency;
    ``block_impl`` "ops" (op chain), "fused" (every block on the fused
    spatial and temporal ops) or "hybrid" (the blocks ``fused_blocks``, else
    ``[fused_from, n)``, fused, the rest on the op chain).

    Routes of the op chain: ``layout`` "ntvc" runs it on ``(N, T, V, C)``
    with each conv as ``spatial_impl`` ("einsum" or "pallas", the graph-conv
    kernel) and ``temporal_impl`` ("auto" and "conv" are ``F.conv2d``,
    "conv_vt", "shift_sum" and "block" the JAX package's other op
    formulations, "pallas" the temporal-conv kernel) say; "vntc" runs it
    V-major with both convs on the V-major kernels, train and eval.

    ``remat`` (the op chain's train forward only, as in the JAX package):
    ``False``; ``True`` or "full" recomputes each block's whole forward in
    the backward, keeping only its input; "selective" keeps the block's
    input and its four conv boundaries and recomputes BN, ReLU, the
    shortcut, dropout and each conv's intermediates
    (:func:`~stgcn_tpu_torch.ops.block.block_forward_train`).  The fused
    and hybrid paths recompute inside their ops and refuse it, and the
    V-major route, which has no boundaries to keep, refuses "selective".
    """

    c_in: int = 2
    num_classes: int = 6
    gamma: int = 9
    strategy: adj.Strategy = adj.Strategy.UNI_LABELING
    d: int = 1
    norm_mode: str = "symmetric"
    adjacency_mode: str = "mask"
    residual: bool = False
    final_softmax: bool = False
    plan: tuple[tuple[int, int], ...] = DEFAULT_PLAN
    dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype | None = None
    mask_jitter: float = 0.0
    dropout_rate: float = 0.0
    dropout_impl: str = "exact"
    block_impl: str = "ops"
    fused_from: int = 4
    fused_blocks: tuple[int, ...] | None = None
    layout: str = "ntvc"
    spatial_impl: str = "einsum"
    temporal_impl: str = "auto"
    remat: bool | str = False

    def __post_init__(self):
        if self.remat not in (False, True, "full", "selective"):
            raise ValueError(f"remat must be False/True/'full'/'selective', "
                             f"got {self.remat!r}")
        if self.layout not in ("ntvc", "vntc"):
            raise ValueError(f"layout must be 'ntvc' or 'vntc', got "
                             f"{self.layout!r}")
        if self.spatial_impl not in SPATIAL_IMPLS:
            raise ValueError(f"spatial_impl must be one of {SPATIAL_IMPLS}, "
                             f"got {self.spatial_impl!r}")
        if self.temporal_impl not in TEMPORAL_IMPLS:
            raise ValueError(f"temporal_impl must be one of "
                             f"{TEMPORAL_IMPLS}, got {self.temporal_impl!r}")
        if self.adjacency_mode not in ADJACENCY_MODES:
            raise ValueError(f"adjacency_mode must be one of "
                             f"{ADJACENCY_MODES}, got {self.adjacency_mode!r}")
        if self.gamma % 2 != 1:
            raise ValueError(f"gamma must be odd, got {self.gamma}")
        if self.dropout_impl not in DROPOUT_IMPLS:
            raise ValueError(f"dropout_impl must be 'exact' or 'bits8', got "
                             f"{self.dropout_impl!r}")
        if self.block_impl not in ("ops", "fused", "hybrid"):
            raise ValueError(f"block_impl must be 'ops', 'fused' or "
                             f"'hybrid', got {self.block_impl!r}")
        if self.block_impl != "ops" and self.layout != "ntvc":
            raise ValueError(
                f"block_impl={self.block_impl!r} is its own fused V-major "
                "path; use it with the default layout='ntvc' input "
                "convention")
        if self.block_impl != "ops" and self.remat:
            raise ValueError(
                f"block_impl={self.block_impl!r} has recompute built into "
                "its ops' backwards; remat must stay False")
        if (self.block_impl == "hybrid" and self.fused_blocks is None
                and not 0 <= self.fused_from <= len(self.plan)):
            raise ValueError(f"fused_from must be in [0, {len(self.plan)}], "
                             f"got {self.fused_from}")
        if self.fused_blocks is not None:
            fb = tuple(self.fused_blocks)
            if sorted(set(fb)) != list(fb) or any(
                    not 0 <= i < len(self.plan) for i in fb):
                raise ValueError(
                    f"fused_blocks must be sorted unique indices in "
                    f"[0, {len(self.plan)}), got {self.fused_blocks}")
            object.__setattr__(self, "fused_blocks", fb)
        if self.layout == "vntc" and self.remat == "selective":
            # the V-major kernels' blocks have no conv boundaries to keep,
            # so "selective" would quietly become full recompute
            raise ValueError(
                "remat='selective' is not available with layout='vntc' (the "
                "V-major kernel blocks have no checkpoint anchors; it would "
                "silently degrade to full recompute). Use remat=True for "
                "full recompute or layout='ntvc' for the selective policy.")


def _uniform_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """torch's default Conv/Linear init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn from ``gen`` (the layers are built with ``skip_init``, so the
    global generator is never drawn from)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=gen)


class BatchNorm(nn.Module):
    """BatchNorm2d's parameters and running statistics under its names
    (``weight``, ``bias``, ``running_mean``, ``running_var``)."""

    def __init__(self, c: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(c, dtype=dtype))
        self.register_buffer("running_mean", torch.zeros(c, dtype=dtype))
        self.register_buffer("running_var", torch.ones(c, dtype=dtype))

    def params(self) -> dict:
        return {"scale": self.weight, "offset": self.bias}

    def state(self) -> dict:
        return {"mean": self.running_mean, "var": self.running_var}


class SpatialConv(nn.Module):
    """The partition-expanding 1x1 conv ``W`` and the adjacency ``A``."""

    def __init__(self, c_in: int, c_out: int, a: torch.Tensor,
                 trainable_a: bool, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        k = a.shape[0]
        self.W = skip_init(nn.Conv2d, c_in, k * c_out, 1, dtype=dtype)
        _uniform_(self.W.weight, c_in, gen)
        _uniform_(self.W.bias, c_in, gen)
        a = a.to(dtype, copy=True)  # each block owns its adjacency
        if trainable_a:
            self.A = nn.Parameter(a)
        else:
            self.register_buffer("A", a)


class STGCNBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, a: torch.Tensor,
                 cfg: STGCNConfig, gen: torch.Generator):
        super().__init__()
        dt, g = cfg.dtype, cfg.gamma
        self.stride = stride
        self.residual = cfg.residual
        self.batch_n = BatchNorm(c_in, dt)
        self.spatialConv = SpatialConv(c_in, c_out, a,
                                       cfg.adjacency_mode != "fixed", dt, gen)
        self.batch_n_2 = BatchNorm(c_out, dt)
        self.temporalConv = skip_init(nn.Conv2d, c_out, c_out, (g, 1),
                                      stride=(stride, 1),
                                      padding=((g - 1) // 2, 0), dtype=dt)
        _uniform_(self.temporalConv.weight, c_out * g, gen)
        _uniform_(self.temporalConv.bias, c_out * g, gen)
        if cfg.residual and not (c_in == c_out and stride == 1):
            self.apply_residual = skip_init(nn.Conv2d, c_in, c_out, 1,
                                            stride=(stride, 1), dtype=dt)
            _uniform_(self.apply_residual.weight, c_in, gen)
            _uniform_(self.apply_residual.bias, c_in, gen)
        else:
            self.apply_residual = None

    def params_and_state(self, dtype: torch.dtype | None = None
                         ) -> tuple[dict, dict]:
        """This block's parameters in the JAX package's layout, cast to
        ``dtype`` if given, and its BN running statistics (never cast)."""
        w = self.spatialConv.W.weight            # (K*C_out, C_in, 1, 1)
        k = self.spatialConv.A.shape[0]
        c_in = w.shape[1]
        c_out = w.shape[0] // k
        tw = self.temporalConv.weight            # (C_out, C_in, gamma, 1)
        p = {
            "spatial": {
                "w": w.reshape(k, c_out, c_in).permute(2, 0, 1),
                "b": self.spatialConv.W.bias.reshape(k, c_out),
            },
            "temporal": {"w": tw.permute(2, 3, 1, 0),
                         "b": self.temporalConv.bias},
            "bn1": self.batch_n.params(),
            "bn2": self.batch_n_2.params(),
            "A": self.spatialConv.A,
        }
        if self.apply_residual is not None:
            p["residual_proj"] = {
                "w": self.apply_residual.weight[:, :, 0, 0].t(),
                "b": self.apply_residual.bias,
            }
        if dtype is not None:
            p = _cast_tree(p, dtype)
        return p, {"bn1": self.batch_n.state(), "bn2": self.batch_n_2.state()}


def _cast_tree(tree, dtype: torch.dtype):
    return tree_map(lambda t: t.to(dtype), tree)


def _detached(tree):
    """Contiguous copies of every tensor, outside any autograd graph."""
    return tree_map(lambda t: t.detach().contiguous().clone(), tree)


class STGCN(nn.Module):
    """ST-GCN with random weights drawn from ``seed``.

    ``distances``: per-joint gravity-center distances, needed by the
    spatial-configuration strategy.
    """

    def __init__(self, config: STGCNConfig,
                 distances: np.ndarray | None = None, *, seed: int = 0):
        super().__init__()
        self.config = config
        self.distances = distances
        a_np = adj.get_normalized_adjacency(
            config.strategy, config.d, mode=config.norm_mode,
            distances=distances)
        a = torch.from_numpy(a_np).to(config.dtype)
        self.num_partitions, self.num_joints = a.shape[0], a.shape[1]
        self.register_buffer("adjacency", a, persistent=False)
        gen = torch.Generator().manual_seed(seed)
        blocks = []
        c_prev = config.c_in
        for c_out, stride in config.plan:
            blocks.append(STGCNBlock(c_prev, c_out, stride, a, config, gen))
            c_prev = c_out
        self.conv = nn.ModuleList(blocks)
        # dead per-layer masks of the reference format, kept for its keys
        self.Masks = nn.ParameterList(
            nn.Parameter(torch.ones_like(a), requires_grad=False)
            for _ in config.plan)
        self.fc_layer = skip_init(nn.Linear, c_prev, config.num_classes,
                                  dtype=config.dtype)
        _uniform_(self.fc_layer.weight, c_prev, gen)
        _uniform_(self.fc_layer.bias, c_prev, gen)

    def params_and_state(self) -> tuple[dict, dict]:
        """The module's weights and BN statistics as parameter dictionaries
        (views, not copies; each block's ``A`` is its effective
        adjacency), for :meth:`apply` and the fused eval forward."""
        pairs = [block.params_and_state() for block in self.conv]
        return ({"blocks": [p for p, _ in pairs], "fc": self.head_params()},
                {"blocks": [s for _, s in pairs]})

    def head_params(self, dtype: torch.dtype | None = None) -> dict:
        p = {"w": self.fc_layer.weight.t(), "b": self.fc_layer.bias}
        return _cast_tree(p, dtype) if dtype is not None else p

    def forward(self, x: torch.Tensor,
                time_mask: torch.Tensor | None = None) -> torch.Tensor:
        """Eval logits on the op path.

        Args:
          x: ``(N, T, V, C_in)`` skeleton sequences.
          time_mask: optional ``(N, T)`` validity mask for bucketed batches;
            padded frames are zeroed before every block and the pool
            averages the valid frames only.
        """
        cfg = self.config
        cd = cfg.compute_dtype
        h = x.to(cd or cfg.dtype)
        if time_mask is not None:
            h = h * time_mask[:, :, None, None].to(h.dtype)
        for block in self.conv:
            p, s = block.params_and_state(cd)
            h = block_forward(p, s, h, self.adjacency, stride=block.stride,
                              residual=cfg.residual, compute_dtype=cd)
            if time_mask is not None:
                if block.stride != 1:
                    time_mask = time_mask[:, ::block.stride]
                h = h * time_mask[:, :, None, None].to(h.dtype)
        pooled = global_avg_pool(h, time_mask)
        logits = linear(self.head_params(cd), pooled)
        if cfg.final_softmax:
            logits = torch.softmax(logits, dim=-1)
        return logits

    def init_params(self, seed: int = 0) -> tuple[dict, dict]:
        """Fresh ``(params, state)`` dictionaries in the JAX package's layout
        (``{"blocks": [...], "fc": {...}}``), float tensors on the CPU.

        The weights are those of ``STGCN(self.config, seed=seed)``.  With
        ``j = 2*(randn - 0.5)*mask_jitter``, drawn from a generator of its
        own, mask mode's ``mask`` is ``1 + j`` and reference mode's ``A`` is
        ``adjacency * (1 + j)``, as at ``stgcn_tpu/ops/block.py:71-81``;
        fixed mode has neither.
        """
        cfg = self.config
        fresh = STGCN(cfg, self.distances, seed=seed)
        jit_gen = torch.Generator().manual_seed(
            int(np.random.SeedSequence([seed, 1]).generate_state(1)[0]))
        a = fresh.adjacency
        blocks_p, blocks_s = [], []
        for block in fresh.conv:
            p, s = block.params_and_state()
            p = _detached(p)
            del p["A"]
            jitter = 0.0
            if cfg.mask_jitter:
                jitter = 2.0 * (torch.randn(a.shape, generator=jit_gen,
                                            dtype=a.dtype) - 0.5
                                ) * cfg.mask_jitter
            if cfg.adjacency_mode == "reference":
                p["A"] = a * (1.0 + jitter)
            elif cfg.adjacency_mode == "mask":
                p["mask"] = torch.ones_like(a) + jitter
            blocks_p.append(p)
            blocks_s.append({k: {n: v.detach().to(torch.float32).clone()
                                 for n, v in d.items()}
                             for k, d in s.items()})
        fc = _detached(fresh.head_params())
        return {"blocks": blocks_p, "fc": fc}, {"blocks": blocks_s}

    def apply(self, params: dict, state: dict, x: torch.Tensor, *,
              train: bool = False, generator: torch.Generator | None = None,
              time_mask: torch.Tensor | None = None,
              bn_group=None, channel_group=None, pool_group=None,
              constrain=None, temporal_impl=None, spatial_impl=None
              ) -> tuple[torch.Tensor, dict]:
        """Forward of the parameter dictionaries: ``(logits, new_state)``.

        ``train=True`` uses batch statistics, returns new running
        statistics and applies dropout from ``generator`` (on ``x``'s
        device); ``train=False`` uses the running statistics and returns
        ``state`` unchanged.  As in the JAX package's ``apply``,
        ``block_impl`` picks the path in both modes: "ops" the op chain, on
        the route of ``layout``, ``spatial_impl`` and ``temporal_impl``;
        "fused" the fused train ops or, in eval, one ``block_eval`` kernel
        per block (:func:`~stgcn_tpu_torch.models.fused.fused_eval_forward`);
        "hybrid" the same for the blocks of ``hybrid_fused_set`` and the op
        chain for the rest.  ``time_mask`` works on the op chain and on the
        fused eval; elsewhere it raises ``ValueError``, as the JAX package
        does.

        The mesh hooks of :mod:`stgcn_tpu_torch.parallel` (the JAX
        ``bn_axis_names``, ``constrain`` and callable impls,
        ``stgcn_tpu/models/stgcn.py:227-257``): ``bn_group`` and
        ``channel_group`` as in :func:`~stgcn_tpu_torch.ops.block.
        block_forward_train`, ``pool_group`` the ranks whose shards of T
        (and V) the global pool sums over, ``constrain`` and the callable
        ``temporal_impl``/``spatial_impl`` (None: the config's).  They run
        on the op chain of ``layout="ntvc"`` only: the fused and hybrid
        paths (data parallel through ``parallel/fused_dp.py``) and the
        V-major route refuse them, as in the JAX package.
        """
        cfg = self.config
        hooked = (bn_group is not None or channel_group is not None
                  or pool_group is not None or constrain is not None
                  or callable(temporal_impl) or callable(spatial_impl))
        if temporal_impl is None:
            temporal_impl = cfg.temporal_impl
        if spatial_impl is None:
            spatial_impl = cfg.spatial_impl
        if cfg.block_impl != "ops" and hooked:
            raise ValueError(
                f"block_impl={cfg.block_impl!r} cannot compose with "
                "GSPMD sharding hooks, or time_mask outside fused EVAL; "
                "use block_impl='ops' for time/model-sharded or masked-"
                "train runs (data parallelism: parallel/fused_dp.py)")
        if cfg.block_impl != "ops":
            masked_eval_ok = cfg.block_impl == "fused" and not train
            if time_mask is not None and not masked_eval_ok:
                raise ValueError(
                    f"block_impl={cfg.block_impl!r} cannot take a time_mask "
                    "outside fused EVAL; use block_impl='ops' for masked-"
                    "train runs")
            from stgcn_tpu_torch.models import fused

            hybrid = cfg.block_impl == "hybrid"
            if train:
                forward = (fused.hybrid_train_forward if hybrid
                           else fused.fused_train_forward)
                return forward(self, params, state, x, generator=generator)
            if hybrid:
                return fused.hybrid_eval_forward(self, params, state,
                                                 x), state
            return fused.fused_eval_forward(self, params, state, x,
                                            time_mask=time_mask), state
        if train and cfg.dropout_rate > 0 and generator is None:
            raise ValueError("training with dropout needs a generator")
        if train:
            mark("input", x.device)
        cd = cfg.compute_dtype
        if cd is not None:
            params = _cast_tree(params, cd)
        h = x.to(cd or cfg.dtype)
        if time_mask is not None:
            h = h * time_mask[:, :, None, None].to(h.dtype)
        if cfg.layout == "vntc":
            if hooked:
                raise ValueError(
                    "layout='vntc' is the single-chip fused-kernel path and "
                    "cannot compose with mesh sharding hooks (bn_axis_names/"
                    "constrain/halo temporal conv); use layout='ntvc' for "
                    "sharded training")
            return self._apply_vm(params, state, h, train=train,
                                  generator=generator, time_mask=time_mask)
        impls = dict(spatial_impl=spatial_impl, temporal_impl=temporal_impl,
                     constrain=constrain, channel_group=channel_group)
        new_blocks = []
        for i, (_, stride) in enumerate(cfg.plan):
            bp, bs = params["blocks"][i], state["blocks"][i]
            if train:
                def run(h, bp=bp, bs=bs, stride=stride):
                    return block_forward_train(
                        bp, bs, h, self.adjacency, stride=stride,
                        residual=cfg.residual, compute_dtype=cd,
                        dropout_rate=cfg.dropout_rate, generator=generator,
                        dropout_impl=cfg.dropout_impl,
                        selective_remat=cfg.remat == "selective",
                        bn_group=bn_group, **impls)

                h, s = self._maybe_full_remat(run, h, generator)
                new_blocks.append(s)
            else:
                h = block_forward(bp, bs, h, self.adjacency, stride=stride,
                                  residual=cfg.residual, compute_dtype=cd,
                                  **impls)
            if time_mask is not None:
                if stride != 1:
                    time_mask = time_mask[:, ::stride]
                h = h * time_mask[:, :, None, None].to(h.dtype)
        if train:
            h = boundary("head", "tail", h)
        pooled = global_avg_pool(h, time_mask, group=pool_group)
        logits = linear(params["fc"], pooled)
        if cfg.final_softmax:
            logits = torch.softmax(logits, dim=-1)
        return logits, ({"blocks": new_blocks} if train else state)

    def _maybe_full_remat(self, run, h: torch.Tensor,
                          generator: torch.Generator | None):
        """``run(h)``, one train block, through
        :func:`~stgcn_tpu_torch.ops.block.checkpointed` when ``remat`` is
        ``True`` or "full" (port of ``stgcn_tpu/models/stgcn.py:348-356,
        396-401``): the backward keeps the block's input and runs the block
        again, the conv kernels' forwards included."""
        if self.config.remat in (True, "full"):
            return checkpointed(run, generator, h)
        return run(h)

    def _apply_vm(self, params: dict, state: dict, x: torch.Tensor, *,
                  train: bool, generator: torch.Generator | None,
                  time_mask: torch.Tensor | None
                  ) -> tuple[torch.Tensor, dict]:
        """The V-major route (port of ``_apply_vm``,
        ``stgcn_tpu/models/stgcn.py:371-426``): ``x``, already cast and
        masked, is transposed once to ``(V, N, T, C)`` and stays V-major
        through every block; the pool is a float32 mean over (V, T), or the
        masked sum over count * V, cast to the activations' dtype before
        the head."""
        cfg = self.config
        h = x.permute(2, 0, 1, 3).contiguous()          # (V, N, T, C)
        new_blocks = []
        for i, (_, stride) in enumerate(cfg.plan):
            def run(h, bp=params["blocks"][i], bs=state["blocks"][i],
                    stride=stride):
                return block_forward_vm(
                    bp, bs, h, self.adjacency, stride=stride,
                    residual=cfg.residual, train=train,
                    dropout_rate=cfg.dropout_rate, generator=generator,
                    dropout_impl=cfg.dropout_impl)

            h, s = (self._maybe_full_remat(run, h, generator) if train
                    else run(h))
            new_blocks.append(s)
            if time_mask is not None:
                if stride != 1:
                    time_mask = time_mask[:, ::stride]
                h = h * time_mask[None, :, :, None].to(h.dtype)
        if train:
            h = boundary("head", "tail", h)
        acc = stat_dtype(h)
        if time_mask is None:
            pooled = h.to(acc).mean(dim=(0, 2))
        else:
            m = time_mask[None, :, :, None].to(acc)
            total = (h.to(acc) * m).sum(dim=(0, 2))
            count = m.sum(dim=(0, 2)) * h.shape[0]
            pooled = total / torch.clamp(count, min=1.0)
        logits = linear(params["fc"], pooled.to(h.dtype))
        if cfg.final_softmax:
            logits = torch.softmax(logits, dim=-1)
        return logits, ({"blocks": new_blocks} if train else state)
