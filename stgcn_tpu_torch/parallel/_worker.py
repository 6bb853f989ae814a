"""One process of a two-process fault drill on the CPU (port of
``scripts/multiproc_worker.py``)::

    python -m stgcn_tpu_torch.parallel._worker INIT PROCESS_ID CKPT_DIR

``INIT`` is the rendezvous (``file://<path>`` or ``host:port``).  Both
processes join a gloo world, check liveness with the heartbeat, run three
data-parallel train steps over a ``(2, 1, 1)`` mesh whose collectives
cross the process boundary, and process 0 writes a checkpoint.  Then the
fault: process 1 exits hard with code 17, and process 0's next heartbeat
must return False within its timeout, the abort-and-restore signal of
``parallel/launcher.py``.  Restoring the checkpoint in a single process
and training on is the caller's part.

Exit codes: 0 the survivor saw the heartbeat fail; 17 the deliberate
crash; anything else a fault of the drill.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch


def main(init: str, pid: int, ckpt_dir: str) -> int:
    import torch.distributed as dist

    from stgcn_tpu_torch.data import random_batch
    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig
    from stgcn_tpu_torch.parallel.launcher import (
        heartbeat,
        initialize_distributed,
        is_primary,
    )
    from stgcn_tpu_torch.parallel.mesh import make_mesh
    from stgcn_tpu_torch.parallel.train import (
        create_sharded_train_state,
        gather_train_state,
        make_sharded_train_step,
        shard_batch,
    )
    from stgcn_tpu_torch.training.checkpoint import save_checkpoint
    from stgcn_tpu_torch.training.optimizers import adam

    torch.set_num_threads(1)
    info = initialize_distributed(init, 2, pid, backend="gloo")
    print(f"INIT {info}", flush=True)
    assert info["process_count"] == 2, info

    assert heartbeat(60.0), "initial heartbeat failed"
    print("HEARTBEAT_OK", flush=True)

    model = STGCN(STGCNConfig(plan=((8, 1), (16, 2)),
                              strategy=Strategy.DISTANCE, d=1))
    mesh = make_mesh(2, 1, 1, device="cpu")
    state, _ = create_sharded_train_state(model, adam(1e-3), mesh, seed=0)
    step = make_sharded_train_step(model, mesh)
    # the same global batch on both processes; each steps on its half
    x, y = random_batch(np.random.default_rng(0), 8, 16)
    for _ in range(3):
        m = step(state, *shard_batch(x, y, mesh))
    loss = float(m["loss"])     # the global batch's, on every process
    print(f"LOSS {loss:.6f}", flush=True)
    assert np.isfinite(loss)

    full = gather_train_state(state, mesh)
    if is_primary():
        save_checkpoint(os.path.join(ckpt_dir, "ckpt_3"), full,
                        {"step": 3, "writer": dist.get_rank()})
        print("CKPT_SAVED", flush=True)

    dist.barrier()
    if pid == 1:
        print("CRASHING", flush=True)
        os._exit(17)  # a host dying mid-run: no cleanup, no goodbye

    # survivor: give the peer a moment to die; the probe must then fail
    time.sleep(2.0)
    ok = heartbeat(10.0)
    print(f"HEARTBEAT_AFTER_FAULT {ok}", flush=True)
    # _exit: tearing the world down waits on the dead peer; the response
    # here is abort-and-restore anyway (the caller's part)
    os._exit(0 if not ok else 5)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2]), sys.argv[3]))
