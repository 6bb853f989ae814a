"""The port's epoch driver, config and training CLI against the JAX
package's (``stgcn_tpu.training.loop.Trainer``, ``training.config``,
``cli.train``), on the CPU.

Held here:

* **Trainer.**  A tiny plan ``((16, 1), (32, 2))``, float32, dropout 0,
  mask mode, from the same weights (the JAX ``init_state``'s, carried
  across by ``models/convert.py``), the same numpy batches and
  ``make_optimizer`` of one config (adam, clipped, cosine with warmup): both
  ``Trainer.fit`` runs agree on ``epochs_run``, on the epoch where
  ``EarlyStopping`` stops, on the per-epoch ``train_loss`` / ``val_loss``
  (rtol 1e-4), on the checkpoint names and metadata and on
  ``maybe_resume``'s epoch.
* **Checkpoints across the packages.**  For adam with clipping, flat_adam
  and momentum (``make_optimizer``), a checkpoint the JAX ``Trainer``
  writes restores into the port's ``Trainer`` and takes the JAX state's
  next update, and the reverse: loss and parameters at rtol 1e-4, floor
  1e-5 of the largest value (the two sides sum in other orders).
* **Config.**  Both parsers give equal ``to_dict()`` for the README's
  command lines (and both refuse its ``--train.batch_size``), the port's
  ``STGCNConfig`` takes the JAX config's values, the mesh command line
  builds and a ``Trainer`` steps on a one-rank gloo mesh, ``apply_device``
  has no CPU fallback,
  and ``precision_scope`` restores the TF32 settings.
* **Checks.**  ``check_invariants`` trips on a bad label, a non-finite
  input and a non-finite gradient (as the JAX checkified step does on the
  first two) and leaves the state as it was; ``debug_nans`` raises on a
  NaN and switches anomaly detection off again; with a ``mesh`` the checked
  step is refused, as in the JAX package.
* **Profiling.**  ``ModelFlops`` and ``param_table`` equal to the JAX
  package's; ``trace`` writes a Chrome trace of a train step.
* **CLI.**  The synthetic smoke run of ``tests/test_training.py:214``
  (1 epoch, fixed_len 32, B=16) with ``--train.device cpu`` and, as on
  the GPU machine, no tensorboard; a second run
  on the spatial-configuration strategy, the stratified split,
  augmentation, flat_adam with warmup and the checked step, resumed for a
  second epoch; and the run with no ``--train.device`` raising where no
  GPU is present.
"""

import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental import checkify

from stgcn_tpu.graph.adjacency import Strategy
from stgcn_tpu.models.stgcn import STGCN as JaxSTGCN
from stgcn_tpu.models.stgcn import STGCNConfig as JaxConfig
from stgcn_tpu.training import config as jcfg
from stgcn_tpu.training.loop import EarlyStopping as JaxEarlyStopping
from stgcn_tpu.training.loop import Trainer as JaxTrainer
from stgcn_tpu.training.optimizers import make_optimizer as jax_make_optimizer
from stgcn_tpu_torch.cli.train import main as port_main
from stgcn_tpu_torch.data import random_batch
from stgcn_tpu_torch.models import stgcn as tm
from stgcn_tpu_torch.models.convert import params_from_jax
from stgcn_tpu_torch.training import config as tcfg
from stgcn_tpu_torch.training.checkpoint import (
    checkpoint_metadata,
    latest_checkpoint,
)
from stgcn_tpu_torch.training.checks import InvariantError
from stgcn_tpu_torch.training.loop import EarlyStopping, Trainer
from stgcn_tpu_torch.training.optimizers import make_optimizer
from stgcn_tpu_torch.training.train_state import train_state_from
from stgcn_tpu_torch.tree import tree_leaves

PLAN = ((16, 1), (32, 2))
# the tier-1 suite runs six workers on the machine's cores: more torch
# threads a worker than that leaves oversubscribe them
TORCH_THREADS = 2
N, T = 8, 16
RTOL, REL_ATOL = 1e-4, 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, TORCH_THREADS))
    yield
    torch.set_num_threads(threads)


def configs(**kw):
    common = dict(plan=PLAN, strategy=Strategy.DISTANCE, residual=True,
                  adjacency_mode="mask", mask_jitter=0.1, **kw)
    return JaxConfig(**common), tm.STGCNConfig(**common)


def train_section(**kw):
    base = dict(lr=3e-3, grad_clip_norm=1.0, lr_schedule="cosine",
                lr_warmup_steps=2, lr_decay_steps=20)
    return jcfg.TrainSection(**{**base, **kw})


def stream(seed, batches=3):
    rng = np.random.default_rng(seed)
    out = [random_batch(rng, N, T) for _ in range(batches)]
    return [(x, y, np.full(N, T, np.int32)) for x, y in out]


def train_stream(epoch):
    return stream(100 + epoch)


def val_stream():
    return stream(7, batches=2)


def trainers(section, jdir="", pdir="", **kw):
    """A JAX and a port Trainer over the same initial weights, and the two
    initial states."""
    jc, tc = configs()
    jt = JaxTrainer(JaxSTGCN(jc), optimizer=jax_make_optimizer(section),
                    checkpoint_dir=jdir, **kw)
    jstate = jt.init_state()
    pt = Trainer(tm.STGCN(tc), optimizer=make_optimizer(section),
                 checkpoint_dir=pdir, device="cpu", **kw)
    params, state = jax.tree.map(np.asarray, (jstate.params,
                                              jstate.model_state))
    pstate = train_state_from(*params_from_jax(params, state),
                              pt.optimizer, 0, CPU)
    return jt, jstate, pt, pstate


def close(got, want, what):
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=REL_ATOL * scale,
                                   err_msg=what)


def test_fit_matches_the_jax_trainer(tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt, jstate, pt, pstate = trainers(train_section(), jdir, pdir,
                                      checkpoint_every_epochs=1)
    kw = dict(epochs=6, min_epochs=2)
    jres = jt.fit(jstate, train_stream, val_stream,
                  early_stopping=JaxEarlyStopping(patience=1,
                                                  min_delta=10.0), **kw)
    pres = pt.fit(pstate, train_stream, val_stream,
                  early_stopping=EarlyStopping(patience=1, min_delta=10.0),
                  **kw)
    # min_epochs 2: epoch 1's val_loss is the first seen and the best;
    # patience 1 stops two epochs later
    assert pres.epochs_run == jres.epochs_run == 4
    for key in ("train_loss", "val_loss", "train_acc", "val_acc"):
        np.testing.assert_allclose([h[key] for h in pres.history],
                                   [h[key] for h in jres.history],
                                   rtol=RTOL, err_msg=key)
    assert [h["epoch"] for h in pres.history] == [0, 1, 2, 3]
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == sorted(
        f"ckpt_{s}.{ext}" for s in (3, 6, 9, 12) for ext in ("json", "npz"))
    for s in (3, 6, 9, 12):
        base = f"ckpt_{s}"
        assert checkpoint_metadata(os.path.join(pdir, base)) == \
            checkpoint_metadata(os.path.join(jdir, base))
    assert checkpoint_metadata(os.path.join(pdir, "ckpt_12")) == {
        "epoch": 4, "step": 12, "final": True}
    # maybe_resume: the newest checkpoint's epoch and state, in both
    jstate2, jepoch = jt.maybe_resume(jt.init_state())
    pstate2, pepoch = pt.maybe_resume(pt.init_state())
    assert pepoch == jepoch == 4 and pstate2.step == int(jstate2.step) == 12
    close([t.detach().numpy() for t in pstate2.leaves()],
          [np.asarray(v) for v in jax.tree.leaves(jstate2.params)],
          "resumed parameters")
    # eval through both trainers' evaluate
    pm = pt.evaluate(pstate2, val_stream())
    jm = jt.evaluate(jstate2, val_stream())
    assert pm["count"] == jm["count"] == 2 * N
    np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=RTOL)
    np.testing.assert_array_equal(pm["confusion_matrix"],
                                  jm["confusion_matrix"])


@pytest.mark.parametrize("section", [
    train_section(optimizer="adam"),
    train_section(optimizer="flat_adam", grad_clip_norm=0.0),
    train_section(optimizer="momentum", grad_clip_norm=0.0, momentum=0.8),
], ids=["adam-clip", "flat_adam", "momentum"])
def test_checkpoints_move_between_the_trainers(tmp_path, section):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt, jstate, pt, pstate = trainers(section, jdir, pdir,
                                      checkpoint_every_epochs=1)
    jres = jt.fit(jstate, train_stream, epochs=2)
    pres = pt.fit(pstate, train_stream, epochs=2)
    x, y, _ = stream(55, batches=1)[0]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)

    # the JAX checkpoint into the port's Trainer, one more step from each
    from_jax, epoch = Trainer(pt.model, optimizer=pt.optimizer,
                              checkpoint_dir=jdir, device="cpu").maybe_resume(
        pt.init_state())
    assert epoch == 2 and from_jax.step == int(jres.final_state.step) == 6
    from_port, epoch = JaxTrainer(jt.model, optimizer=jt.optimizer,
                                  checkpoint_dir=pdir).maybe_resume(
        jt.init_state())
    assert epoch == 2 and int(from_port.step) == pres.final_state.step == 6

    loss_p = float(pt.train_step(from_jax, xt, yt)["loss"])
    loss_pp = float(pt.train_step(pres.final_state, xt, yt)["loss"])
    from_port, mj2 = jt.train_step(from_port, jnp.asarray(x), jnp.asarray(y))
    jnext, mj = jt.train_step(jres.final_state, jnp.asarray(x),
                              jnp.asarray(y))
    np.testing.assert_allclose(loss_p, float(mj["loss"]), rtol=RTOL)
    np.testing.assert_allclose(float(mj2["loss"]), loss_pp, rtol=RTOL)
    close([t.detach().numpy() for t in from_jax.leaves()],
          [np.asarray(v) for v in jax.tree.leaves(jnext.params)],
          "JAX checkpoint resumed in the port")
    close([np.asarray(v) for v in jax.tree.leaves(from_port.params)],
          [t.detach().numpy() for t in pres.final_state.leaves()],
          "port checkpoint resumed in JAX")


README_ARGV = [
    ["--data.synthetic", "true", "--train.epochs", "5",
     "--data.collate_mode", "fixed", "--data.fixed_len", "128",
     "--train.checkpoint_dir", "runs/ckpt", "--train.log_dir", "runs/logs"],
    ["--model.partitioning", "2", "--model.residual", "true",
     "--model.dropout_rate", "0.5", "--model.use_edge_importance", "true",
     "--model.block_impl", "hybrid", "--model.fused_blocks",
     "0,1,2,3,4,5,6", "--parallel.precision", "bfloat16",
     "--data.batch_size", "64", "--data.val_scenarios", "d3,d4",
     "--train.lr", "1e-3", "--train.optimizer", "adamw",
     "--train.resume", "yes"],
    ["--parallel.data_axis", "2", "--parallel.time_axis", "2",
     "--parallel.model_axis", "2"],
]


@pytest.mark.parametrize("argv", README_ARGV, ids=["quick", "bench", "mesh"])
def test_parsers_agree(argv, tmp_path):
    got, want = tcfg.parse_config(argv), jcfg.parse_config(argv)
    assert got.to_dict() == want.to_dict()
    path = tmp_path / "cfg.json"
    path.write_text(want.to_json())
    assert tcfg.parse_config(["--config", str(path)]).to_dict() == \
        want.to_dict()
    assert tcfg.ExperimentConfig.from_dict(json.loads(got.to_json())) \
        .to_dict() == want.to_dict()


def test_both_parsers_refuse_unknown_flags():
    # README.md's real-data line passes --train.batch_size, which neither
    # package has (batch_size is a data setting)
    argv = ["--data.metadata_file", "KTH/metadata.csv",
            "--train.batch_size", "128"]
    for parse in (tcfg.parse_config, jcfg.parse_config):
        with pytest.raises(SystemExit):
            parse(argv)
    with pytest.raises(KeyError, match="unknown config key"):
        tcfg.ExperimentConfig.from_dict({"train": {"batch_size": 4}})


def test_model_config_takes_the_jax_values():
    cfg = tcfg.parse_config(README_ARGV[1])
    got = tcfg.model_config_from(cfg)
    want = jcfg.model_config_from(jcfg.parse_config(README_ARGV[1]))
    for f in dataclasses.fields(got):
        if f.name in ("dtype", "compute_dtype", "fused_from",
                      "dropout_impl"):
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.compute_dtype == torch.bfloat16
    assert got.adjacency_mode == "mask" and got.mask_jitter == 0.001
    plain = tcfg.model_config_from(tcfg.parse_config(["--model.num_layers",
                                                      "9"]))
    assert plain.adjacency_mode == "fixed" and plain.compute_dtype is None
    assert plain.plan == tm.PLAN_9
    with pytest.raises(ValueError, match="num_layers"):
        tcfg.model_config_from(tcfg.parse_config(["--model.num_layers",
                                                  "8"]))
    with pytest.raises(ValueError, match="precision"):
        tcfg.model_config_from(tcfg.parse_config(["--parallel.precision",
                                                  "fp8"]))


@pytest.fixture()
def one_rank_world():
    """A one-process gloo world for a ``(1, 1, 1)`` mesh, torn down after
    the test so no later test of this worker finds it."""
    import torch.distributed as dist

    from stgcn_tpu_torch.parallel.mesh import make_mesh

    yield lambda: make_mesh(1, 1, 1, device="cpu")
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_settings_build_and_step(one_rank_world):
    """The README's mesh command line gives the JAX package's model config
    (the port once refused it), and a ``Trainer`` on a one-rank gloo mesh
    builds the sharded steps and takes the unsharded step's loss."""
    got = tcfg.model_config_from(tcfg.parse_config(README_ARGV[2]))
    want = jcfg.model_config_from(jcfg.parse_config(README_ARGV[2]))
    assert got.plan == want.plan and got.block_impl == want.block_impl
    _, _, pt, pstate = trainers(train_section())
    mesh_trainer = Trainer(pt.model, optimizer=pt.optimizer,
                           mesh=one_rank_world())
    mstate = mesh_trainer.init_state()
    for leaf, src in zip(mstate.leaves(), pstate.leaves()):
        leaf.data.copy_(src.detach())
    x, y, _ = stream(3, batches=1)[0]
    got_m = mesh_trainer.train_step(mstate, *mesh_trainer._put_batch(x, y))
    want_m = pt.train_step(pstate, torch.from_numpy(x), torch.from_numpy(y))
    assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]),
                                                 rel=RTOL)
    assert mstate.step == 1
    sums = mesh_trainer.eval_step(mstate, *mesh_trainer._put_batch(x, y))
    assert int(sums["count"]) == len(y)


@pytest.mark.parametrize("argv", [
    ["--parallel.remat", "true"],
    ["--model.temporal_impl", "conv_vt"],
    ["--model.temporal_impl", "shift_sum"],
    ["--model.temporal_impl", "block"],
], ids=["remat", "conv_vt", "shift_sum", "block"])
def test_ported_settings_build_and_step(argv):
    """The settings the port once refused build the config the JAX package
    builds and take a train step on the CPU."""
    cfg = tcfg.parse_config(argv + ["--model.num_layers", "9",
                                    "--model.dropout_rate", "0.5"])
    got = tcfg.model_config_from(cfg)
    want = jcfg.model_config_from(jcfg.parse_config(
        argv + ["--model.num_layers", "9", "--model.dropout_rate", "0.5"]))
    assert (got.remat, got.temporal_impl) == (want.remat, want.temporal_impl)
    model = tm.STGCN(dataclasses.replace(got, plan=((8, 1), (16, 2))))
    trainer = Trainer(model, lr=1e-3, device="cpu")
    state = trainer.init_state()
    x, y = random_batch(np.random.default_rng(0), batch=2, t=16)
    metrics = trainer.train_step(state, torch.from_numpy(x),
                                 torch.from_numpy(y))
    assert np.isfinite(float(metrics["loss"])) and state.step == 1


def test_apply_device_and_precision_scope():
    assert tcfg.apply_device(tcfg.parse_config(
        ["--train.device", "cpu"])) == CPU
    for name in ("tpu", "gpu0"):
        with pytest.raises(SystemExit):
            tcfg.apply_device(tcfg.parse_config(["--train.device", name]))
    for name in ("auto", "cuda"):
        cfg = tcfg.parse_config(["--train.device", name])
        if torch.cuda.is_available():
            assert tcfg.apply_device(cfg).type == "cuda"
        else:       # no quiet CPU fallback
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tcfg.apply_device(cfg)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    with tcfg.precision_scope(tcfg.parse_config(
            ["--parallel.precision", "highest"])):
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.allow_tf32
    with tcfg.precision_scope(tcfg.parse_config([])):
        assert torch.backends.cudnn.allow_tf32
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def test_check_invariants_trip_and_leave_the_state():
    jt, jstate, pt, pstate = trainers(train_section(),
                                      check_invariants=True)
    x, y, _ = stream(3, batches=1)[0]
    bad_y = y.copy()
    bad_y[0] = 6
    nan_x = x.copy()
    nan_x[1, 2, 3, 0] = np.nan
    before = [t.detach().clone() for t in pstate.leaves()]
    for xb, yb, msg in ((x, bad_y, "label out of range"),
                        (nan_x, y, "non-finite loss")):
        with pytest.raises(InvariantError, match=msg):
            pt.train_step(pstate, torch.from_numpy(xb), torch.from_numpy(yb))
        with pytest.raises(checkify.JaxRuntimeError, match=msg):
            jt.train_step(jstate, jnp.asarray(xb), jnp.asarray(yb))
    handle = pstate.params["fc"]["b"].register_hook(
        lambda g: g * float("nan"))
    with pytest.raises(InvariantError, match="non-finite gradient"):
        pt.train_step(pstate, torch.from_numpy(x), torch.from_numpy(y))
    handle.remove()
    assert pstate.step == 0 and pstate.optimizer.count == 0
    assert all(torch.equal(a, b) for a, b in zip(before, pstate.leaves()))
    metrics = pt.train_step(pstate, torch.from_numpy(x), torch.from_numpy(y))
    assert pstate.step == 1 and bool(torch.isfinite(metrics["loss"]))


def test_debug_nans_and_mesh():
    _, _, pt, pstate = trainers(train_section(), debug_nans=True)
    x, y, lens = stream(3, batches=1)[0]
    x = x.copy()
    x[0, 0, 0, 0] = np.nan
    with pytest.raises(RuntimeError, match="nan"):
        pt.fit(pstate, lambda epoch: [(x, y, lens)])
    assert not torch.is_anomaly_enabled()
    # a mesh runs, but not the checked step: refused as in the JAX package
    msg = "check_invariants is only supported for single-device"
    with pytest.raises(ValueError, match=msg):
        Trainer(pt.model, mesh=object(), check_invariants=True)
    with pytest.raises(ValueError, match=msg):
        JaxTrainer(JaxSTGCN(configs()[0]), mesh=object(),
                   check_invariants=True)


@pytest.fixture()
def synth_tmpdir(tmp_path, monkeypatch):
    """TMPDIR (and so the synthetic dataset's directory) under tmp_path."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    tempfile.tempdir = None
    yield tmp_path
    tempfile.tempdir = None


def test_cli_synthetic_smoke(synth_tmpdir, monkeypatch):
    tmp_path = synth_tmpdir
    # as on the GPU machine, no tensorboard: TensorBoardLogger is a no-op
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = ["--data.synthetic", "true", "--train.epochs", "1",
            "--data.batch_size", "16", "--data.collate_mode", "fixed",
            "--data.fixed_len", "32",
            "--train.checkpoint_dir", str(tmp_path / "ckpt"),
            "--train.log_dir", str(tmp_path / "logs")]
    assert port_main(argv + ["--train.device", "cpu"]) == 0
    assert latest_checkpoint(str(tmp_path / "ckpt")) is not None
    assert os.path.exists(tmp_path / "logs" / "train_loss.csv")
    assert os.path.exists(tmp_path / "stgcn_synth" / "metadata.csv")
    if not torch.cuda.is_available():   # no CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_main(argv)


def test_cli_resumes_spatial_configuration_run(synth_tmpdir, capsys):
    tmp_path = synth_tmpdir
    argv = ["--data.synthetic", "true", "--data.batch_size", "64",
            "--data.collate_mode", "fixed", "--data.fixed_len", "12",
            "--data.data_split", "2",
            "--data.augment_data", "true", "--model.partitioning", "2",
            "--model.num_layers", "9", "--train.optimizer", "flat_adam",
            "--train.lr_warmup_steps", "3", "--train.check_invariants",
            "true", "--train.checkpoint_dir", str(tmp_path / "ckpt"),
            "--train.checkpoint_every_epochs", "1", "--train.device", "cpu",
            "--data.use_native_loader", "false"]
    assert port_main(argv + ["--train.epochs", "1"]) == 0
    first = capsys.readouterr().out
    assert "computing gravity-center distances" in first
    assert "native loader" not in first
    steps = int(latest_checkpoint(str(tmp_path / "ckpt")).rsplit("_", 1)[1])
    assert port_main(argv + ["--train.epochs", "2", "--train.resume",
                             "true"]) == 0
    second = capsys.readouterr().out
    assert "[ckpt] resumed from epoch 1" in second
    assert "[test] loss=" in second
    base = latest_checkpoint(str(tmp_path / "ckpt"))
    assert checkpoint_metadata(base) == {"epoch": 2, "step": 2 * steps,
                                         "final": True}
    state = tree_leaves(np.load(base + ".npz")["opt_state/count"])
    assert int(state[0]) == 2 * steps


def test_profiling_matches_the_jax_accounting(tmp_path):
    from stgcn_tpu.utils import profiling as jprof
    from stgcn_tpu_torch.utils import profiling as tprof

    for kw in (dict(), dict(strategy=Strategy.SPATIAL_CONFIGURATION)):
        distances = np.linspace(1.0, 3.0, 25) if kw else None
        jm = JaxSTGCN(JaxConfig(**{"residual": True, **kw}),
                      distances=distances)
        pm = tm.STGCN(tm.STGCNConfig(**{"residual": True, **kw}),
                      distances=distances)
        for train in (True, False):
            assert dataclasses.astuple(tprof.ModelFlops.of(
                pm, 64, 304, train)) == dataclasses.astuple(
                jprof.ModelFlops.of(jm, 64, 304, train))
    jt, jstate, pt, pstate = trainers(train_section())
    assert tprof.param_table(pstate.params) == \
        jprof.param_table(jstate.params)
    x, y, _ = stream(3, batches=1)[0]
    with tprof.trace(str(tmp_path / "prof")) as prof:
        pt.train_step(pstate, torch.from_numpy(x), torch.from_numpy(y))
    assert prof.key_averages()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
