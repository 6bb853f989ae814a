"""The port's schedules and optimizers against the JAX package's
``make_schedule`` / ``make_optimizer`` (optax).

Held here, on the CPU:

* each schedule, with and without warmup, at the counts where its formula
  changes (0, 1, the warmup, the decay horizon, past it), rtol 1e-12;
* every optimizer (adam, flat_adam, adamw, sgd, momentum), with and
  without global-norm clipping, under each schedule with and without
  warmup: five updates of a small parameter tree from numpy gradients,
  the parameters after each update at rtol 1e-5 in float32 and rtol 1e-10
  in float64.  Two float64 cases carry float32 roundings on the JAX side
  and are held at rtol 1e-10 plus atol 1e-7 (five updates of
  ``lr·|u| <= 0.3`` at float32's relative 6e-8): optax evaluates the
  warmup and the step schedule on its int32 count in float32, and
  ``flat_adam`` computes in float32 in both packages;
* the count quirks: optax's first update under warmup has lr 0, the JAX
  ``flat_adam``'s does not;
* the optimizer state as optax's tree: after three updates the port's
  ``opt_state_tree`` has the key paths, dtypes and values of the JAX
  ``opt_state`` (rtol 1e-10; float32 moments rtol 1e-5); loaded into a fresh port optimizer, the JAX state takes the JAX
  optimizer's next update, and the port's state loaded into optax's tree
  takes the port's.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from stgcn_tpu.training import checkpoint as jax_ckpt
from stgcn_tpu.training.config import TrainSection as JaxTrainSection
from stgcn_tpu.training.optimizers import make_optimizer as jax_make_optimizer
from stgcn_tpu.training.optimizers import make_schedule as jax_make_schedule
from stgcn_tpu_torch.training import optimizers as opt
from stgcn_tpu_torch.tree import tree_items, tree_leaves, tree_map

SHAPES = {"a": {"w": (3, 4), "b": (4,)}, "blocks": [{"k": (5,)},
                                                    {"k": (2, 2)}]}
UPDATES = 5
WARMUP, DECAY = 2, 4


def train_section(**kw):
    base = dict(lr=0.1, lr_warmup_steps=WARMUP, lr_decay_steps=DECAY,
                lr_step_factor=0.5, weight_decay=0.3, momentum=0.8)
    return JaxTrainSection(**{**base, **kw})


def init_tree(dtype):
    rng = np.random.default_rng(0)
    return tree_map(lambda s: rng.normal(0, 1, s).astype(dtype), SHAPES)


def grad_trees(dtype, n=UPDATES):
    rng = np.random.default_rng(1)
    return [tree_map(lambda s: rng.normal(0, 1, s).astype(dtype), SHAPES)
            for _ in range(n)]


class Pair:
    """The same optimizer in both packages over the same parameters."""

    def __init__(self, cfg, dtype):
        self.jopt = jax_make_optimizer(cfg)
        params = init_tree(dtype)
        self.jparams = tree_map(jnp.asarray, params)
        self.jstate = self.jopt.init(self.jparams)
        self.tparams = tree_map(
            lambda a: torch.tensor(a, requires_grad=True), params)
        self.topt = opt.make_optimizer(cfg)(tree_leaves(self.tparams))

    def update(self, grads):
        updates, self.jstate = self.jopt.update(
            tree_map(jnp.asarray, grads), self.jstate, self.jparams)
        self.jparams = optax.apply_updates(self.jparams, updates)
        for p, g in zip(tree_leaves(self.tparams), tree_leaves(grads)):
            p.grad = torch.from_numpy(g)
        self.topt.step()

    def close(self, rtol, what, atol=0.0):
        for got, want in zip(tree_leaves(self.tparams),
                             jax.tree.leaves(self.jparams)):
            np.testing.assert_allclose(got.detach().numpy(),
                                       np.asarray(want), rtol=rtol,
                                       atol=atol, err_msg=what)


@pytest.mark.parametrize("warmup", [0, WARMUP])
@pytest.mark.parametrize("schedule", ["constant", "cosine", "step"])
def test_schedule_values(schedule, warmup):
    cfg = train_section(lr_schedule=schedule, lr_warmup_steps=warmup)
    want, got = jax_make_schedule(cfg), opt.make_schedule(cfg)
    for c in sorted({0, 1, warmup, warmup + 1, DECAY - 1, DECAY, DECAY + 1,
                     warmup + DECAY, warmup + DECAY + 1, 3 * DECAY + 7}):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-12,
                                   atol=1e-15, err_msg=f"count {c}")
    assert got(0) == (0.0 if warmup else cfg.lr)


def test_schedule_errors_and_constants():
    with pytest.raises(ValueError, match="decay_steps"):
        opt.make_schedule(train_section(lr_schedule="cosine",
                                        lr_decay_steps=0))
    with pytest.raises(ValueError, match="lr_schedule"):
        opt.make_schedule(train_section(lr_schedule="linear"))
    # a non-positive interval or a zero rate makes optax's step schedule a
    # constant
    for kw in (dict(lr_decay_steps=0), dict(lr_step_factor=0.0)):
        sched = opt.make_schedule(train_section(
            lr_schedule="step", lr_warmup_steps=0, **kw))
        assert [sched(c) for c in (0, 5, 100)] == [0.1] * 3


SCHEDULES = [("constant", 0), ("cosine", 0), ("constant", WARMUP),
             ("cosine", WARMUP), ("step", WARMUP)]


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("schedule,warmup", SCHEDULES,
                         ids=[f"{s}-w{w}" for s, w in SCHEDULES])
@pytest.mark.parametrize("name", opt.OPTIMIZERS)
def test_updates_match_optax(name, schedule, warmup, clip, dtype):
    cfg = train_section(optimizer=name, lr_schedule=schedule,
                        lr_warmup_steps=warmup, grad_clip_norm=clip)
    pair = Pair(cfg, dtype)
    if dtype == np.float32:
        rtol, atol = 1e-5, 0.0
    else:
        f32_lr = warmup > 0 or schedule == "step"
        rtol, atol = 1e-10, 1e-7 if f32_lr or name == "flat_adam" else 0.0
    for i, grads in enumerate(grad_trees(dtype)):
        pair.update(grads)
        pair.close(rtol, f"{name} update {i}", atol)
    assert pair.topt.count == UPDATES


def test_clip_keeps_small_gradients():
    cfg = train_section(optimizer="sgd", lr_schedule="constant",
                        lr_warmup_steps=0, grad_clip_norm=100.0)
    pair = Pair(cfg, np.float64)
    grads = grad_trees(np.float64, 1)[0]
    before = [p.detach().clone() for p in tree_leaves(pair.tparams)]
    pair.update(grads)
    pair.close(1e-12, "sgd, clip inactive")
    for p, b, g in zip(tree_leaves(pair.tparams), before, tree_leaves(grads)):
        np.testing.assert_allclose(p.detach().numpy(), b.numpy() - 0.1 * g,
                                   rtol=1e-14)


def test_schedule_count_quirks():
    """Under warmup optax's adam takes lr(0) = 0 on its first update; the
    JAX flat_adam takes lr(1), and so does the port's."""
    for name, moves in (("adam", False), ("flat_adam", True),
                        ("momentum", False)):
        pair = Pair(train_section(optimizer=name, lr_schedule="constant"),
                    np.float64)
        before = [p.detach().clone() for p in tree_leaves(pair.tparams)]
        pair.update(grad_trees(np.float64, 1)[0])
        pair.close(1e-6, name)
        changed = any(not torch.equal(b, p.detach()) for b, p in
                      zip(before, tree_leaves(pair.tparams)))
        assert changed == moves, name


def test_adamw_decays_inside_the_scaled_update():
    """optax's -lr*(adam + wd*p) and torch.optim.AdamW's p*(1 - lr*wd) -
    lr*adam agree to float32 rounding."""
    cfg = train_section(optimizer="adamw", lr_schedule="constant",
                        lr_warmup_steps=0)
    pair = Pair(cfg, np.float32)
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(pair.tparams)]
    ref = torch.optim.AdamW(leaves, lr=cfg.lr, weight_decay=cfg.weight_decay,
                            eps=1e-8, foreach=True)
    for grads in grad_trees(np.float32):
        pair.update(grads)
        for p, g in zip(leaves, tree_leaves(grads)):
            p.grad = torch.from_numpy(g)
        ref.step()
    pair.close(1e-5, "adamw")
    for got, want in zip(tree_leaves(pair.tparams), leaves):
        torch.testing.assert_close(got.detach(), want.detach(), rtol=1e-5,
                                   atol=1e-6)


def jax_keyed(tree) -> dict:
    return {jax_ckpt._key_str(path): np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_keyed(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree_items(tree).items()}


CKPT_CASES = [(name, clip) for name in opt.OPTIMIZERS for clip in (0.0, 1.0)]


@pytest.mark.parametrize("name,clip", CKPT_CASES,
                         ids=[f"{n}-{'clip' if c else 'noclip'}"
                              for n, c in CKPT_CASES])
def test_opt_state_tree_is_optax_tree(name, clip):
    cfg = train_section(optimizer=name, lr_schedule="cosine",
                        grad_clip_norm=clip)
    grads = grad_trees(np.float64, 4)
    pair = Pair(cfg, np.float64)
    for g in grads[:3]:
        pair.update(g)
    want = jax_keyed(pair.jstate)
    got = port_keyed(opt.opt_state_tree(pair.topt, pair.tparams))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and (
            got[k].dtype == want[k].dtype), k
        # flat_adam's moments are float32 in both packages
        tol = (dict(rtol=1e-5, atol=1e-7) if want[k].dtype == np.float32
               else dict(rtol=1e-10, atol=0))
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)

    # the JAX state into a fresh port optimizer: the same next update
    fresh = Pair(cfg, np.float64)
    fresh.jparams, fresh.jstate = pair.jparams, pair.jstate
    with torch.no_grad():
        for p, v in zip(tree_leaves(fresh.tparams),
                        jax.tree.leaves(pair.jparams)):
            p.copy_(torch.from_numpy(np.array(v)))
    jax_tree = jax.tree.map(np.asarray, pair.jstate)
    opt.load_opt_state(fresh.topt, fresh.tparams, _as_port_tree(jax_tree))
    assert fresh.topt.count == 3
    fresh.update(grads[3])
    fresh.close(1e-10, f"{name}: JAX state resumed in the port", 1e-7)

    # the port's state into optax's tree: the same next update
    template = jax.tree.map(np.asarray, pair.jopt.init(pair.jparams))
    stored = got
    restored = jax.tree_util.tree_map_with_path(
        lambda path, leaf: stored[jax_ckpt._key_str(path)], template)
    back = Pair(cfg, np.float64)
    back.jparams, back.jstate = pair.jparams, restored
    with torch.no_grad():
        for p, q in zip(tree_leaves(back.tparams), tree_leaves(pair.tparams)):
            p.copy_(q)
    opt.load_opt_state(back.topt, back.tparams,
                       opt.opt_state_tree(pair.topt, pair.tparams))
    back.update(grads[3])
    back.close(1e-10, f"{name}: port state resumed in JAX", 1e-7)


def _as_port_tree(tree):
    """optax's state (NamedTuples, tuples) as the dict/list tree the port's
    checkpoint restore hands ``load_opt_state``."""
    if hasattr(tree, "_asdict"):
        return {k: _as_port_tree(v) for k, v in tree._asdict().items()}
    if isinstance(tree, (list, tuple)):
        return [_as_port_tree(v) for v in tree]
    if isinstance(tree, dict):
        return {k: _as_port_tree(v) for k, v in tree.items()}
    return tree


def test_spec_validates_and_keeps_constant_layout():
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.OptimizerSpec("lamb")
    # a constant learning rate has optax.adam(lr)'s layout: no schedule count
    leaves = [torch.zeros(3, requires_grad=True)]
    tree = opt.opt_state_tree(opt.adam(1e-3)(leaves), {"w": leaves[0]})
    assert sorted(port_keyed(tree)) == ["0/count", "0/mu/w", "0/nu/w"]
    spec = dataclasses.replace(opt.flat_adam(), learning_rate=lambda c: c)
    assert spec.lr(0) == 1 and opt.adam(lambda c: c).lr(0) == 0


# ---- momentum with Nesterov and weight decay, torch.optim.SGD's form -------

SGD_CASES = [(nesterov, wd) for nesterov in (False, True)
             for wd in (0.0, 1e-2)]


def _sgd_pair(nesterov, wd, dtype=torch.float64):
    params = tree_map(lambda a: torch.tensor(a, dtype=dtype,
                                             requires_grad=True),
                      init_tree(np.float64))
    spec = opt.OptimizerSpec("momentum", 0.1, momentum=0.8,
                             weight_decay=wd, nesterov=nesterov)
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_leaves(params)]
    ref = torch.optim.SGD(leaves, lr=0.1, momentum=0.8, nesterov=nesterov,
                          weight_decay=wd)
    return params, spec(tree_leaves(params)), leaves, ref


@pytest.mark.parametrize("nesterov,wd", SGD_CASES,
                         ids=[f"{'nesterov' if n else 'plain'}-wd{w}"
                              for n, w in SGD_CASES])
def test_momentum_matches_torch_sgd(nesterov, wd):
    """Five updates in float64 against torch.optim.SGD(momentum, nesterov,
    weight_decay), dampening 0: the parameters after each and the trace."""
    params, port, leaves, ref = _sgd_pair(nesterov, wd)
    for grads in grad_trees(np.float64):
        for p, q, g in zip(tree_leaves(params), leaves, tree_leaves(grads)):
            p.grad = torch.from_numpy(g.copy())
            q.grad = torch.from_numpy(g.copy())
        port.step()
        ref.step()
        for p, q in zip(tree_leaves(params), leaves):
            torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-12,
                                       atol=1e-14)
    for p, q in zip(tree_leaves(params), leaves):
        torch.testing.assert_close(port.state[p]["momentum_buffer"],
                                   ref.state[q]["momentum_buffer"],
                                   rtol=1e-12, atol=1e-14)


def test_nesterov_trace_round_trips_opt_state():
    """The trace of a Nesterov step with decay through opt_state_tree and
    load_opt_state: a fresh optimizer takes the same next update."""
    params, port, _, _ = _sgd_pair(True, 1e-2)
    grads = grad_trees(np.float64, 4)

    def update(optim, tree, g):
        for p, a in zip(tree_leaves(tree), tree_leaves(g)):
            p.grad = torch.from_numpy(a.copy())
        optim.step()

    for g in grads[:3]:
        update(port, params, g)
    saved = opt.opt_state_tree(port, params)
    assert sorted(port_keyed(saved)) == sorted(
        port_keyed(opt.opt_state_tree(port, params)))
    fresh = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                     params)
    again = port.spec(tree_leaves(fresh))
    opt.load_opt_state(again, fresh, saved)
    update(port, params, grads[3])
    update(again, fresh, grads[3])
    for p, q in zip(tree_leaves(params), tree_leaves(fresh)):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=0, atol=0)


def test_make_optimizer_decays_adamw_only():
    for name in ("momentum", "sgd", "adam"):
        assert opt.make_optimizer(train_section(optimizer=name)
                                  ).weight_decay == 0.0
    assert opt.make_optimizer(train_section(optimizer="adamw")
                              ).weight_decay == 0.3
    assert not opt.make_optimizer(train_section(optimizer="momentum")
                                  ).nesterov
