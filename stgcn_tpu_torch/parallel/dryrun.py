"""One sharded train step over ``n`` ranks on the CPU (the port's
counterpart of ``__graft_entry__.dryrun_multichip``)::

    python -m stgcn_tpu_torch.parallel.dryrun 8

:func:`dryrun_multichip` factors ``n`` into ``(data, time, model)`` as the
JAX function does, starts ``n`` gloo processes and runs one step of the
full 10-block DEFAULT_PLAN where the model axis divides its 64 channels
(else a 2-block plan of ``8 * model`` and ``16 * model`` channels) at a
tiny batch and clip, then one data-parallel step of the fused path over
all ``n`` ranks.  It returns rank 0's printed lines.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np


def factor(n: int) -> tuple[int, int, int]:
    """``n`` as ``(data, time, model)``, preferring balanced meshes that
    use every axis kind (``__graft_entry__.py:45-58``)."""
    best = (n, 1, 1)
    for d in range(1, n + 1):
        if n % d:
            continue
        for t in range(1, n // d + 1):
            if (n // d) % t:
                continue
            cand = (d, t, n // (d * t))
            if sorted(cand, reverse=True) < sorted(best, reverse=True):
                best = cand
    return best


def _rank_main(rank: int, n: int, init: str, out_dir: str) -> None:
    import torch

    from stgcn_tpu_torch.data import random_batch
    from stgcn_tpu_torch.graph.adjacency import Strategy
    from stgcn_tpu_torch.models.stgcn import STGCN, STGCNConfig
    from stgcn_tpu_torch.parallel import (
        create_sharded_train_state,
        initialize_distributed,
        make_mesh,
        make_sharded_train_step,
        shard_batch,
        validate_time_sharding,
    )
    from stgcn_tpu_torch.training.optimizers import adam

    torch.set_num_threads(1)
    initialize_distributed(init, n, rank)
    lines = []

    def say(msg):
        lines.append(msg)

    dp, tp_time, tp_model = factor(n)
    mesh = make_mesh(dp, tp_time, tp_model, device="cpu")
    say(f"[dryrun] mesh data={dp} time={tp_time} model={tp_model} on {n} "
        f"ranks")
    cfg = dict(strategy=Strategy.DISTANCE, d=1, dropout_rate=0.1,
               residual=True)
    if 64 % tp_model == 0:
        kind = "production 10-block"
    else:
        c0 = 8 * tp_model
        cfg["plan"] = ((c0, 1), (2 * c0, 2))
        kind = f"toy 2-block (model axis {tp_model} does not divide 64)"
    say(f"[dryrun] plan: {kind}")
    model = STGCN(STGCNConfig(**cfg))
    batch, t = 4 * dp, 16 * tp_time
    validate_time_sharding(t, tp_time)
    state, _ = create_sharded_train_state(model, adam(1e-3), mesh, seed=0)
    step = make_sharded_train_step(model, mesh)
    x, y = random_batch(np.random.default_rng(0), batch, t)
    m = step(state, *shard_batch(x, y, mesh))
    say(f"[dryrun] one sharded train step done: loss={float(m['loss']):.4f} "
        f"acc={float(m['acc']):.4f}")

    dp_mesh = make_mesh(n, 1, 1, device="cpu")
    fmodel = STGCN(STGCNConfig(plan=((8, 1), (16, 2)),
                               strategy=Strategy.DISTANCE, d=1,
                               residual=True, block_impl="fused"))
    fstate, _ = create_sharded_train_state(fmodel, adam(1e-3), dp_mesh,
                                           seed=0)
    fstep = make_sharded_train_step(fmodel, dp_mesh)
    fx, fy = random_batch(np.random.default_rng(1), 2 * n, 24)
    fm = fstep(fstate, *shard_batch(fx, fy, dp_mesh))
    say(f"[dryrun] data-parallel fused step done: "
        f"loss={float(fm['loss']):.4f}")
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout_s: float = 600.0) -> list[str]:
    """Run the dry run over ``n_devices`` gloo processes on this machine
    and return rank 0's lines; raises ``RuntimeError`` if a rank fails."""
    import subprocess

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "stgcn_tpu_torch.parallel.dryrun",
             "--rank", str(r), str(n_devices), init, tmp], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        outs = [p.communicate(timeout=timeout_s)[0] for p in procs]
        bad = [(r, o) for r, (p, o) in enumerate(zip(procs, outs))
               if p.returncode]
        if bad:
            raise RuntimeError(f"dry-run rank {bad[0][0]} failed:\n"
                               f"{bad[0][1][-3000:]}")
        with open(os.path.join(tmp, "rank0.txt")) as f:
            return f.read().splitlines()


if __name__ == "__main__":
    if sys.argv[1] == "--rank":
        _rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
    else:
        print("\n".join(dryrun_multichip(int(sys.argv[1]))))
