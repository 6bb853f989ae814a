"""The launcher, the two-process fault drill and the multi-rank dry run
of ``stgcn_tpu_torch.parallel`` (the counterparts of
``tests/test_multiprocess.py`` and ``__graft_entry__.dryrun_multichip``).

* ``initialize_distributed`` with no world to join is a no-op with the
  JAX function's summary keys; ``heartbeat`` and ``is_primary`` of a
  single process are True.
* ``python -m stgcn_tpu_torch.parallel._worker`` on two processes: both
  pass the heartbeat and compute the same loss over a ``(2, 1, 1)`` mesh,
  process 0 writes a checkpoint, process 1 exits with 17 and process 0's
  heartbeat then returns False within its timeout.  The recovery: an
  unsharded ``Trainer`` resumes the checkpoint at step 3 and trains on.
* ``dryrun_multichip(4)`` runs one step of DEFAULT_PLAN on the ``(1, 2,
  2)`` mesh the JAX function factors 4 into, and one data-parallel fused
  step, on four gloo processes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from stgcn_tpu_torch.data import random_batch
from stgcn_tpu_torch.graph.adjacency import Strategy
from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig
from stgcn_tpu_torch.parallel import (
    heartbeat,
    initialize_distributed,
    is_primary,
)
from stgcn_tpu_torch.parallel.dryrun import dryrun_multichip, factor
from stgcn_tpu_torch.training.checkpoint import (
    checkpoint_metadata,
    latest_checkpoint,
)
from stgcn_tpu_torch.training.loop import Trainer
from stgcn_tpu_torch.training.optimizers import adam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
             "LOCAL_RANK")


def test_single_process_is_a_no_op(monkeypatch):
    for k in DIST_VARS:
        monkeypatch.delenv(k, raising=False)
    info = initialize_distributed()
    assert info == {"process_index": 0, "process_count": 1,
                    "local_devices": 1, "global_devices": 1}
    assert heartbeat(1.0) and is_primary()


@pytest.mark.parametrize("n,want", [(4, (1, 2, 2)), (8, (2, 2, 2)),
                                    (2, (2, 1, 1)), (6, (1, 2, 3))])
def test_factor_matches_the_jax_dryrun(n, want):
    assert factor(n) == want


def test_two_process_fault_drill_and_recovery(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS",) + DIST_VARS}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    init = "file://" + str(tmp_path / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "stgcn_tpu_torch.parallel._worker", init,
         str(pid), str(tmp_path)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    survivor, crasher = outs
    assert procs[1].returncode == 17, crasher
    assert "HEARTBEAT_OK" in crasher and "CRASHING" in crasher, crasher
    assert procs[0].returncode == 0, survivor
    for want in ("HEARTBEAT_OK", "CKPT_SAVED", "HEARTBEAT_AFTER_FAULT False"):
        assert want in survivor, survivor

    def loss_of(out):
        return float(next(line for line in out.splitlines()
                          if line.startswith("LOSS")).split()[1])

    assert loss_of(survivor) == loss_of(crasher)

    base = latest_checkpoint(str(tmp_path))
    assert base is not None and checkpoint_metadata(base)["writer"] == 0
    model = STGCN(STGCNConfig(plan=((8, 1), (16, 2)),
                              strategy=Strategy.DISTANCE, d=1))
    trainer = Trainer(model, adam(1e-3), device="cpu",
                      checkpoint_dir=str(tmp_path))
    state, _ = trainer.maybe_resume(trainer.init_state())
    assert state.step == 3
    x, y = random_batch(np.random.default_rng(0), 8, 16)
    result = trainer.fit(state, lambda epoch: [(x, y, None)], epochs=1)
    assert state.step == 4
    assert np.isfinite(result.history[-1]["train_loss"])


def test_dryrun_multichip_4():
    lines = dryrun_multichip(4)
    assert lines[0] == "[dryrun] mesh data=1 time=2 model=2 on 4 ranks"
    assert lines[1] == "[dryrun] plan: production 10-block"
    for prefix in ("[dryrun] one sharded train step done: loss=",
                   "[dryrun] data-parallel fused step done: loss="):
        line = next(x for x in lines if x.startswith(prefix))
        assert np.isfinite(float(line[len(prefix):].split()[0]))
