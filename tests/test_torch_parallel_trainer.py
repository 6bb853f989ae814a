"""The parallel paths behind the user's entry points: ``Trainer(mesh=...)``
with its checkpoints, and the training CLI on two ranks.

Two gloo ranks (``tests/torch_parallel_ranks.py``, started once for the
file) train a ``Trainer`` on a ``(1, 1, 2)`` mesh (channel tensor
parallelism: each rank holds half of every conv's channels) for two epochs
of two batches, float32, with a checkpoint an epoch written by rank 0
from the gathered leaves; then run ``cli.train`` with
``--parallel.data_axis 2`` on a 5-subject synthetic dataset whose splits
the axis divides.  Held here:

* the sharded run's epoch losses against an unsharded ``Trainer`` on the
  same batches from the same seed (rtol 1e-6);
* the last checkpoint restores into an unsharded ``Trainer``, whose eval
  logits equal bitwise those of the run's gathered state, and lie within
  1e-6 of the largest of the sharded eval's;
* the JAX package restores the same checkpoint into its own train state
  (the port's leaves bitwise) and its eval logits agree within 1e-6 of
  the largest;
* both CLI ranks exit 0 and print the JAX CLI's ``[dist]`` lines.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from stgcn_tpu.graph.adjacency import Strategy
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.training.checkpoint import restore_checkpoint as jax_restore
from stgcn_tpu.training.train_state import create_train_state as jax_state
from stgcn_tpu_torch.data import generate_dataset, random_batch
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.training.checkpoint import latest_checkpoint
from stgcn_tpu_torch.training.loop import Trainer
from stgcn_tpu_torch.training.optimizers import adam
from stgcn_tpu_torch.tree import tree_leaves

from torch_parallel_ranks import launch

PLAN = ((16, 1), (32, 2))
CONFIG = dict(plan=PLAN, strategy=Strategy.DISTANCE.value, d=1,
              residual=True, adjacency_mode="mask", mask_jitter=0.1,
              dtype="float32")
REL = 1e-6


def port_model():
    cfg = dict(CONFIG, strategy=Strategy(CONFIG["strategy"]),
               dtype=torch.float32)
    return tm.STGCN(tm.STGCNConfig(**cfg))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("trainer"))
    rng = np.random.default_rng(0)
    batches = [random_batch(rng, 8, 16) for _ in range(2)]
    eval_x, eval_y = random_batch(rng, 4, 16)
    data = os.path.join(tmp, "data")
    meta = generate_dataset(data, num_subjects=5, skip_one=False)
    cli_argv = ["--data.metadata_file", meta, "--data.dataset_dir", data,
                "--data.batch_size", "16", "--data.collate_mode", "fixed",
                "--data.fixed_len", "16", "--model.num_layers", "9",
                "--train.epochs", "1", "--train.device", "cpu",
                "--data.use_native_loader", "false",
                "--parallel.data_axis", "2"]
    inputs = dict(config=CONFIG, ckpt_dir=os.path.join(tmp, "ckpt"),
                  batches=batches, eval_x=eval_x.astype(np.float32),
                  eval_y=eval_y, tmp=tmp, cli_argv=cli_argv)
    return inputs, launch("trainer", 2, inputs, os.path.join(tmp, "ranks"))


def test_sharded_losses_match_unsharded_trainer(run):
    inp, out = run
    trainer = Trainer(port_model(), adam(1e-3), device="cpu")
    state = trainer.init_state()
    batches = [(x, y, None) for x, y in inp["batches"]]
    want = trainer.fit(state, lambda epoch: batches, epochs=2).history
    for res in out:
        assert res["step"] == 4
        for got, ref in zip(res["history"], want):
            assert got["train_loss"] == pytest.approx(ref["train_loss"],
                                                      rel=REL)


def test_checkpoint_restores_into_an_unsharded_trainer(run):
    inp, out = run
    base = latest_checkpoint(inp["ckpt_dir"])
    assert base.endswith("ckpt_4")
    model = port_model()
    trainer = Trainer(model, adam(1e-3), device="cpu",
                      checkpoint_dir=inp["ckpt_dir"])
    state, epoch = trainer.maybe_resume(trainer.init_state())
    assert epoch == 2 and state.step == 4
    with torch.no_grad():
        logits, _ = model.apply(state.params, state.model_state,
                                torch.from_numpy(inp["eval_x"]))
    np.testing.assert_array_equal(logits.numpy(), out[0]["whole_logits"])
    for res in out:
        scale = float(np.abs(res["sharded_logits"]).max())
        assert float(np.abs(logits.numpy() - res["sharded_logits"]).max()
                     ) <= REL * scale


def test_jax_reads_the_sharded_checkpoint(run):
    inp, out = run
    base = latest_checkpoint(inp["ckpt_dir"])
    jmodel = JaxSTGCN(JaxConfig(**dict(
        CONFIG, strategy=Strategy(CONFIG["strategy"]), dtype=jnp.float32)))
    ts = jax_restore(base, jax_state(jmodel, optax.adam(1e-3), seed=0))
    assert int(ts.step) == 4
    model = port_model()
    trainer = Trainer(model, adam(1e-3), device="cpu",
                      checkpoint_dir=inp["ckpt_dir"])
    state, _ = trainer.maybe_resume(trainer.init_state())
    for got, want in zip(jax.tree.leaves(ts.params),
                         tree_leaves(state.params)):
        np.testing.assert_array_equal(np.asarray(got), want.detach().numpy())
    logits, _ = jmodel.apply(ts.params, ts.model_state,
                             jnp.asarray(inp["eval_x"]), train=False)
    want = out[0]["whole_logits"]
    assert float(np.abs(np.asarray(logits) - want).max()) <= \
        REL * float(np.abs(want).max())


def test_cli_on_two_ranks_prints_the_dist_lines(run):
    _, out = run
    for r, res in enumerate(out):
        assert res["cli_rc"] == 0
        lines = res["cli_out"].splitlines()
        assert (f"[dist] {{'process_index': {r}, 'process_count': 2, "
                f"'local_devices': 1, 'global_devices': 2}}") in lines
        assert ("[dist] mesh data=2 time=1 model=1 shard_joints=False"
                in lines)
        assert any(line.startswith("[test] loss=") for line in lines)
