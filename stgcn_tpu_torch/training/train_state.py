"""Train state: parameters, BN state, optimizer, step and seed (port of
``stgcn_tpu/training/train_state.py``).

The JAX package keeps an immutable pytree; here the parameter dictionaries
hold leaf tensors with ``requires_grad`` that the optimizer updates in
place, the train step writes the new BN statistics into ``model_state``'s
tensors in place (:func:`copy_state_`) and advances ``step``, so a
captured step (:mod:`stgcn_tpu_torch.training.graphs`) finds every tensor
where it left it.  Dropout draws from a generator seeded per step from
``(seed, step)`` (:func:`step_key`), which stands where the JAX step uses
``fold_in(rng, step)``; the two frameworks' random bits differ.  A checkpoint stores the seed under the JAX package's
``rng#prngkey`` key as threefry key data, and reads any such key data back
as an integer seed (:mod:`stgcn_tpu_torch.training.checkpoint`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stgcn_tpu_torch import resolve_device
from stgcn_tpu_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass
class TrainState:
    params: dict
    model_state: dict
    optimizer: torch.optim.Optimizer
    step: int
    seed: int

    def leaves(self) -> list[torch.Tensor]:
        return tree_leaves(self.params)

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor a train step reads or writes in place: the
        parameter leaves, the BN statistics and the optimizer's state."""
        return (self.leaves() + tree_leaves(self.model_state)
                + self.optimizer.state_tensors())


@torch.no_grad()
def copy_state_(dst: dict, src: dict) -> None:
    """Write the tree ``src`` into the tensors of the same tree ``dst``."""
    got, want = tree_leaves(dst), tree_leaves(src)
    if len(got) != len(want):
        raise ValueError(f"state trees differ: {len(got)} leaves against "
                         f"{len(want)}")
    for d, s in zip(got, want):
        if d is not s:
            d.copy_(s)


def create_train_state(model, optimizer, seed: int = 0, *,
                       device: str | torch.device | None = None
                       ) -> TrainState:
    """Fresh weights from ``model.init_params(seed)`` on ``device`` (CUDA
    unless ``"cpu"`` is asked for), and the optimizer over their leaves.

    ``optimizer`` is a factory such as
    :func:`stgcn_tpu_torch.training.optimizers.adam`.  The model's constant
    adjacency moves to the same device.
    """
    dev = resolve_device(device)
    model.to(dev)
    return train_state_from(*model.init_params(seed), optimizer, seed, dev)


def train_state_from(params: dict, state: dict, optimizer, seed: int,
                     device: torch.device) -> TrainState:
    """A train state over copies of given dictionaries (for instance JAX
    weights through ``convert.params_from_jax``), at step 0."""
    params = tree_map(lambda t: t.detach().to(device, copy=True), params)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    state = tree_map(lambda t: t.detach().to(device, copy=True), state)
    return TrainState(params=params, model_state=state,
                      optimizer=optimizer(tree_leaves(params)), step=0,
                      seed=seed)


def step_key(seed: int, step: int, shard: tuple[int, ...] = ()) -> int:
    """The dropout seed of one step; on a mesh, ``shard`` is the rank's
    coordinates on the axes its activations are sharded over, so shards
    draw their own masks (the JAX package folds the shard index into the
    step's key, ``stgcn_tpu/parallel/fused_dp.py:107``) and replicas draw
    the same."""
    return int(np.random.SeedSequence([seed, step, *shard]
                                      ).generate_state(1)[0])


def step_generator(seed: int, step: int, device: torch.device,
                   shard: tuple[int, ...] = ()) -> torch.Generator:
    """A new generator on ``device`` seeded with :func:`step_key`."""
    return torch.Generator(device=device).manual_seed(
        step_key(seed, step, shard))
