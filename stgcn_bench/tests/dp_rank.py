"""One rank other than 0 of a small data-parallel cell on the CPU (gloo),
started by the tests in rank 0's place:

    python3 dp_rank.py WORKLOAD RENDEZVOUS RANK SEED SECONDS [FAULT]

``FAULT`` ``no_exchange`` leaves out the gradients' all-reduce,
``local_bn`` the BatchNorm statistics' (each rank normalizes by, and
keeps, its own rows' statistics)."""

import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def no_exchange():
    """Leave out the data-parallel step's all-reduce of the gradients and
    metrics (the program's ``parallel/fused_dp``), on every rank."""
    from stgcn_tpu_torch.parallel import fused_dp

    real = fused_dp.all_reduce_

    def skipped(tensors, group, what=None):
        if what == "gradients_and_metrics":
            return tensors
        return real(tensors, group, what)

    fused_dp.all_reduce_ = skipped


def local_bn():
    """BatchNorm over each rank's own rows: the program's fused training
    forward called without its group."""
    from stgcn_tpu_torch.models import fused

    real = fused.fused_train_forward

    def local(*args, bn_group=None, **kwargs):
        return real(*args, **kwargs)

    fused.fused_train_forward = local


FAULTS = {"no_exchange": no_exchange, "local_bn": local_bn}


def main(argv):
    import torch

    from stgcn_bench import harness

    workload, rdv, rank, seed, seconds = argv[:5]
    for fault in argv[5:]:
        FAULTS[fault]()
    torch.set_num_threads(1)
    cell = harness.load_cell(workload)
    env = {"device": torch.device("cpu"), "start": time.time(),
           "rank": int(rank), "rendezvous": rdv}
    harness.driver(cell).run(cell, int(seed), float(seconds), False, env)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
