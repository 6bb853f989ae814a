"""Checkpoint save and restore (port of ``stgcn_tpu/training/checkpoint.py``).

One ``.npz`` of leaves keyed by their path in the tree, plus a JSON sidecar
of metadata (step, epoch, ...).  The keys are the JAX package's key paths,
so a checkpoint written by either package restores in the other for the
same config:

* ``params/blocks/<i>/spatial/w`` and the rest of the parameter
  dictionaries (:meth:`STGCN.init_params`'s layout, which is the JAX
  package's), ``model_state/blocks/<i>/bn1/mean`` for the BN statistics;
* ``opt_state/...`` in optax's layout for the optimizer (adam,
  flat_adam, adamw, sgd or momentum, with or without a schedule and
  clipping: :mod:`stgcn_tpu_torch.training.optimizers`);
* ``step``, an int32 scalar;
* ``rng#prngkey``: the JAX package stores its train PRNG key there as the
  raw ``uint32`` key data of a threefry key.  The port keeps an integer
  ``seed`` instead and writes it as the key data ``jax.random.key(seed)``
  would have, ``[seed >> 32, seed & 0xffffffff]``; it reads any such pair
  back as the integer ``hi << 32 | lo``.  A key the JAX package wrote (a
  split of its seed's key, not the seed) therefore becomes an integer seed
  of the port's per-step dropout generators: a resumed run draws other
  dropout masks than the JAX run would, which agree with them in
  distribution only, as every port run's masks do.

A :class:`TrainState` is saved as that whole tree and restored in place;
any other tree of tensors, numpy arrays or numbers is saved as it is and
restored as a new tree.  The ``.npz`` is written under a temporary name and
renamed into place, so a reader never sees half a file.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from stgcn_tpu_torch.training.optimizers import load_opt_state, opt_state_tree
from stgcn_tpu_torch.training.train_state import TrainState
from stgcn_tpu_torch.tree import tree_items

KEY_SUFFIX = "#prngkey"


def seed_to_key_data(seed: int) -> np.ndarray:
    """``seed`` as threefry key data, the ``rng#prngkey`` leaf."""
    return np.asarray([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                      np.uint32)


def key_data_to_seed(data) -> int:
    hi, lo = (int(v) for v in np.asarray(data, np.uint32).reshape(2))
    return hi << 32 | lo


def train_state_tree(ts: TrainState) -> dict:
    """The tree a train state is saved as, in the JAX package's key paths
    (``rng#prngkey`` included)."""
    return {"params": ts.params, "model_state": ts.model_state,
            "opt_state": opt_state_tree(ts.optimizer, ts.params),
            "step": np.asarray(ts.step, np.int32),
            "rng" + KEY_SUFFIX: seed_to_key_data(ts.seed)}


def _as_numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree, metadata: dict | None = None) -> str:
    """Write ``path.npz`` and ``path.json``; returns the ``.npz`` path.

    ``tree``: a :class:`TrainState` or a nested tree of leaves."""
    if isinstance(tree, TrainState):
        tree = train_state_tree(tree)
    arrays = {k: _as_numpy(v) for k, v in tree_items(tree).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path + ".npz")
    with open(path + ".json", "w") as f:
        json.dump(metadata or {}, f, indent=2, default=str)
    return path + ".npz"


def _restore_leaf(template, value, key: str, path: str):
    """``value`` in the template leaf's kind: a tensor of its dtype and
    device, or a numpy array."""
    if torch.is_tensor(template):
        if tuple(value.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint {path} leaf {key!r} has shape "
                             f"{tuple(value.shape)}, the target "
                             f"{tuple(template.shape)}")
        return torch.from_numpy(np.array(value)).to(
            dtype=template.dtype, device=template.device)
    return np.asarray(value)


def _restore_tree(template, stored: dict, path: str, skip, prefix=""):
    if isinstance(template, dict):
        return {k: _restore_tree(v, stored, path, skip,
                                 f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_restore_tree(v, stored, path, skip, f"{prefix}/{i}")
                for i, v in enumerate(template)]
    if any(prefix.startswith(pre) for pre in skip):
        return template
    if prefix in stored:
        return _restore_leaf(template, stored[prefix], prefix, path)
    raise KeyError(f"checkpoint {path} missing leaf {prefix!r}")


def restore_checkpoint(path: str, target, skip_prefixes: tuple[str, ...] = ()):
    """Load ``path.npz`` into the structure of ``target``.

    ``target``: a :class:`TrainState`, whose parameters (in place, so its
    optimizer keeps them), BN state, optimizer state, step and seed take
    the checkpoint's values and which is returned; or a tree, for which a
    new tree of the same structure is returned.  Leaves under a key-path
    prefix in ``skip_prefixes`` keep the target's values, e.g.
    ``("opt_state",)`` for a checkpoint of another optimizer.  Keys of the
    file that the target does not hold are not read.
    """
    with np.load(path + ".npz") as data:
        stored = {k: data[k] for k in data.files}
    if not isinstance(target, TrainState):
        return _restore_tree(target, stored, path, skip_prefixes)
    tree = _restore_tree(train_state_tree(target), stored, path,
                         skip_prefixes)
    with torch.no_grad():
        for name in ("params", "model_state"):
            for dst, src in zip(tree_items(getattr(target, name)).values(),
                                tree_items(tree[name]).values()):
                dst.copy_(src)
    if not any("opt_state".startswith(pre) for pre in skip_prefixes):
        load_opt_state(target.optimizer, target.params, tree["opt_state"])
    target.step = int(tree["step"])
    target.seed = key_data_to_seed(tree["rng" + KEY_SUFFIX])
    return target


def checkpoint_metadata(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)


def latest_checkpoint(directory: str, prefix: str = "ckpt") -> str | None:
    """Most recent ``{prefix}_{step}`` checkpoint basename in ``directory``."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for f in os.listdir(directory):
        if f.startswith(prefix + "_") and f.endswith(".npz"):
            try:
                steps.append(int(f[len(prefix) + 1:-4]))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(directory, f"{prefix}_{max(steps)}")
