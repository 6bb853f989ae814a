"""Adam with optax's numerics (port of ``optax.adam`` and ``flat_adam`` as
the JAX package uses them, ``stgcn_tpu/training/optimizers.py``).

optax's Adam divides the bias-corrected first moment by the square root of
the bias-corrected second moment plus ``eps`` (outside the root), which is
what ``torch.optim.Adam`` computes.  The update runs as PyTorch's
multi-tensor (``foreach``) loop over the parameter leaves; its ``fused``
CUDA kernel is a library kernel and is not used.  ``flat_adam`` computes
the same update and differs only in how a checkpoint stores its moments.
Learning-rate schedules (``make_schedule``) are not ported yet.

Optimizer state in a checkpoint (:func:`opt_state_tree`,
:func:`load_opt_state`) takes the JAX package's layout, so a checkpoint
moves between the packages:

* ``adam``: optax's ``(ScaleByAdamState(count, mu, nu), EmptyState())``,
  keys ``opt_state/0/count``, ``opt_state/0/mu/<parameter path>`` and
  ``opt_state/0/nu/<parameter path>``;
* ``flat_adam``: ``FlatAdamState(count, flat_mu, flat_nu)``, keys
  ``opt_state/count``, ``opt_state/flat_mu`` and ``opt_state/flat_nu``, each
  moment one float32 vector of every parameter leaf raveled in the JAX
  package's leaf order (dictionary keys sorted, lists in order: the order
  of :func:`stgcn_tpu_torch.tree.tree_leaves`).

``mu`` and ``nu`` are ``torch.optim.Adam``'s ``exp_avg`` and ``exp_avg_sq``
of the same leaf, and ``count`` (int32) is its ``step``, so a restored run
takes the same next update.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from stgcn_tpu_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(learning_rate, b1, b2, eps)``, or with ``flat``
    ``flat_adam``; call it on the parameter leaves to get the optimizer that
    updates them in place."""

    learning_rate: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    flat: bool = False

    def __call__(self, leaves: list[torch.Tensor]) -> torch.optim.Optimizer:
        opt = torch.optim.Adam(leaves, lr=self.learning_rate,
                               betas=(self.b1, self.b2), eps=self.eps,
                               foreach=True)
        opt.flat_moments = self.flat      # the checkpoint layout
        return opt


def adam(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    return Adam(learning_rate, b1, b2, eps)


def flat_adam(learning_rate: float = 1e-3, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8) -> Adam:
    """Adam whose checkpoints store each moment as one flat vector."""
    return Adam(learning_rate, b1, b2, eps, flat=True)


def opt_state_tree(optimizer: torch.optim.Optimizer, params: dict):
    """The optimizer's state as the JAX package's ``opt_state`` tree of
    numpy arrays (zeros for a leaf not stepped yet)."""
    count = 0
    moments = {"mu": [], "nu": []}
    for p in tree_leaves(params):
        st = optimizer.state.get(p, {})
        if "step" in st:
            count = int(st["step"])
        for name, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            m = st.get(key)
            moments[name].append(
                np.zeros(tuple(p.shape), np.float32) if m is None
                else m.detach().to(torch.float32).cpu().numpy())
    count = np.asarray(count, np.int32)
    if getattr(optimizer, "flat_moments", False):
        return {"count": count, **{
            f"flat_{name}": np.concatenate([m.ravel() for m in ms])
            for name, ms in moments.items()}}
    index = {id(p): i for i, p in enumerate(tree_leaves(params))}
    return [{"count": count,
             **{name: tree_map(lambda p, ms=ms: ms[index[id(p)]], params)
                for name, ms in moments.items()}}]


def load_opt_state(optimizer: torch.optim.Optimizer, params: dict,
                   tree) -> None:
    """Set the optimizer's state from an ``opt_state`` tree in the layout
    :func:`opt_state_tree` gives (numpy arrays or tensors)."""
    leaves = tree_leaves(params)
    if getattr(optimizer, "flat_moments", False):
        count = tree["count"]
        sizes = [p.numel() for p in leaves]
        mus, nus = (np.split(np.asarray(tree[f"flat_{n}"]),
                             np.cumsum(sizes)[:-1]) for n in ("mu", "nu"))
    else:
        count = tree[0]["count"]
        mus, nus = (tree_leaves(tree[0][n]) for n in ("mu", "nu"))
    if not len(mus) == len(nus) == len(leaves):
        raise ValueError(f"opt_state holds {len(mus)} moments for "
                         f"{len(leaves)} parameter leaves")
    for p, mu, nu in zip(leaves, mus, nus):
        def moment(m):
            m = torch.as_tensor(np.asarray(m)).reshape(p.shape)
            return m.to(dtype=p.dtype, device=p.device).clone()
        optimizer.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": moment(mu), "exp_avg_sq": moment(nu)}
