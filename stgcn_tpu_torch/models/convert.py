"""Carry weights between the JAX package's pytrees, the port's parameter
dictionaries and the reference's state dict.

The port's own copies of ``import_state_dict`` and ``export_state_dict``
(``stgcn_tpu/models/importer.py:27-155``).  :func:`params_from_state_dict`
reads a reference-named state dict into parameter dictionaries, each
block's ``spatialConv.A`` as its trained ``A`` (reference mode), for
``STGCN.apply``.  :func:`state_dict_from_jax`: JAX ``(params, state)`` pytrees,
given as numpy arrays, become a reference-named state dict of tensors.  In
mask mode ``A ⊙ M`` is folded into ``spatialConv.A``, which is exactly the
eval ``effective_adjacency``; in fixed mode ``spatialConv.A`` is the fixed
adjacency.  ``STGCN.load_state_dict(state_dict_from_jax(...))`` then makes
both packages compute the same function.

The train path keeps the JAX layout itself (``STGCN.init_params``), so
:func:`params_from_jax` only turns the pytrees' arrays into tensors (the
mask stays apart) and :func:`params_to_numpy` turns them back;
:func:`state_dict_from_params` folds trained dictionaries into the
reference-named state dict that ``Predictor`` serves.
"""

from __future__ import annotations

import numpy as np
import torch

from stgcn_tpu_torch.tree import tree_map


def _np(x) -> np.ndarray:
    return np.asarray(x)


def state_dict_from_jax(params: dict, state: dict, *, residual: bool,
                        adjacency: np.ndarray) -> dict[str, torch.Tensor]:
    """``(params, state)`` pytrees -> reference-named state dict.

    ``adjacency``: the model's constant normalized ``(K, V, V)`` adjacency,
    for the blocks whose parameters hold a mask or no graph weights.  The
    dead ``Masks.{i}`` entries of the reference format are ones.
    """
    out: dict[str, np.ndarray] = {}
    for i, (p, s) in enumerate(zip(params["blocks"], state["blocks"])):
        pre = f"conv.{i}."
        c_in, k, c_out = _np(p["spatial"]["w"]).shape
        out[pre + "spatialConv.W.weight"] = (
            np.transpose(_np(p["spatial"]["w"]), (1, 2, 0))
            .reshape(k * c_out, c_in, 1, 1))
        out[pre + "spatialConv.W.bias"] = _np(p["spatial"]["b"]).reshape(-1)
        out[pre + "temporalConv.weight"] = np.transpose(
            _np(p["temporal"]["w"]), (3, 2, 0, 1))
        out[pre + "temporalConv.bias"] = _np(p["temporal"]["b"])
        for name, key in (("batch_n", "bn1"), ("batch_n_2", "bn2")):
            out[f"{pre}{name}.weight"] = _np(p[key]["scale"])
            out[f"{pre}{name}.bias"] = _np(p[key]["offset"])
            out[f"{pre}{name}.running_mean"] = _np(s[key]["mean"])
            out[f"{pre}{name}.running_var"] = _np(s[key]["var"])
        if "A" in p:
            a_eff = _np(p["A"])
        elif "mask" in p:
            a_eff = _np(adjacency) * _np(p["mask"])
        else:
            a_eff = _np(adjacency)
        out[pre + "spatialConv.A"] = a_eff
        out[f"Masks.{i}"] = np.ones_like(a_eff)
        if residual and "residual_proj" in p:
            out[pre + "apply_residual.weight"] = (
                _np(p["residual_proj"]["w"]).T[:, :, None, None])
            out[pre + "apply_residual.bias"] = _np(p["residual_proj"]["b"])
    out["fc_layer.weight"] = _np(params["fc"]["w"]).T
    out["fc_layer.bias"] = _np(params["fc"]["b"])
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in out.items()}


def params_from_jax(params: dict, state: dict, *,
                    dtype: torch.dtype | None = None
                    ) -> tuple[dict, dict]:
    """JAX ``(params, state)`` pytrees of numpy arrays -> the port's train
    dictionaries of tensors (same keys, ``mask`` kept apart), cast to
    ``dtype`` if given."""
    def leaf(x):
        t = torch.from_numpy(np.array(x, copy=True))
        return t.to(dtype) if dtype is not None else t
    return tree_map(leaf, params), tree_map(leaf, state)


def params_to_numpy(tree):
    """The port's train dictionaries -> pytrees of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def state_dict_from_params(params: dict, state: dict, *, residual: bool,
                           adjacency: torch.Tensor
                           ) -> dict[str, torch.Tensor]:
    """Trained dictionaries -> the reference-named state dict for
    ``STGCN.load_state_dict`` (mask mode folds ``adjacency * mask``)."""
    return state_dict_from_jax(params_to_numpy(params),
                               params_to_numpy(state), residual=residual,
                               adjacency=params_to_numpy(adjacency))


def params_from_state_dict(state_dict: dict, num_blocks: int,
                           num_partitions: int, *, residual: bool = False
                           ) -> tuple[dict, dict]:
    """A reference-named state dict (tensors or numpy arrays) -> the port's
    ``(params, state)`` dictionaries of float tensors on the CPU.

    The inverse of :func:`state_dict_from_jax`: the spatial 1x1 conv
    ``(K*C_out, C_in, 1, 1)`` becomes ``(C_in, K, C_out)``, the temporal
    conv ``(C_out, C_in, gamma, 1)`` becomes ``(gamma, 1, C_in, C_out)``,
    each ``spatialConv.A`` the block's ``A``; the dead ``Masks.{i}`` and
    BatchNorm's ``num_batches_tracked`` are not read.
    """
    sd = {k: (v.detach().cpu() if torch.is_tensor(v)
              else torch.from_numpy(np.array(v)))
          for k, v in state_dict.items()}
    blocks_p, blocks_s = [], []
    for i in range(num_blocks):
        pre = f"conv.{i}."
        w = sd[pre + "spatialConv.W.weight"]       # (K*C_out, C_in, 1, 1)
        c_out = w.shape[0] // num_partitions
        p = {
            "spatial": {
                "w": w.reshape(num_partitions, c_out, w.shape[1])
                .permute(2, 0, 1),
                "b": sd[pre + "spatialConv.W.bias"].reshape(num_partitions,
                                                            c_out),
            },
            "temporal": {"w": sd[pre + "temporalConv.weight"]
                         .permute(2, 3, 1, 0),
                         "b": sd[pre + "temporalConv.bias"]},
        }
        s = {}
        for name, key in (("batch_n", "bn1"), ("batch_n_2", "bn2")):
            p[key] = {"scale": sd[f"{pre}{name}.weight"],
                      "offset": sd[f"{pre}{name}.bias"]}
            s[key] = {"mean": sd[f"{pre}{name}.running_mean"],
                      "var": sd[f"{pre}{name}.running_var"]}
        if pre + "spatialConv.A" in sd:
            p["A"] = sd[pre + "spatialConv.A"]
        if residual and pre + "apply_residual.weight" in sd:
            p["residual_proj"] = {
                "w": sd[pre + "apply_residual.weight"][:, :, 0, 0].t(),
                "b": sd[pre + "apply_residual.bias"]}
        blocks_p.append(p)
        blocks_s.append(s)
    params = {"blocks": blocks_p, "fc": {"w": sd["fc_layer.weight"].t(),
                                         "b": sd["fc_layer.bias"]}}
    copy = lambda t: t.contiguous().clone()  # noqa: E731
    return tree_map(copy, params), tree_map(copy, {"blocks": blocks_s})
