"""Multi-process initialization and failure handling (port of
``stgcn_tpu/parallel/launcher.py``).

One process drives one GPU.  Each process calls
:func:`initialize_distributed`, which joins the ``torch.distributed``
world (its arguments default to the variables ``torchrun`` sets) and
selects ``cuda:LOCAL_RANK``; ``stgcn_tpu_torch.parallel.mesh.make_mesh``
then lays the ``(data, time, model)`` grid over the world's ranks.

Failure handling: :func:`heartbeat` runs a small all-reduce over a group
of its own on the gloo backend, in a watchdog thread.  An NCCL collective
with a dead peer hangs rather than raising, so liveness is never probed on
the NCCL communicators the steps use.  ``False`` means a peer is gone: the
caller aborts and restarts from the latest checkpoint
(``stgcn_tpu_torch.training.checkpoint``), the recovery that
``python -m stgcn_tpu_torch.parallel._worker`` drills.
"""

from __future__ import annotations

import os
import threading

import torch
import torch.distributed as dist

# the dedicated gloo group of heartbeat(), made with the world
_HEARTBEAT = {}


def _init_method(address: str) -> str:
    """``host:port`` as a TCP URL; a URL (``tcp://``, ``file://``) as
    given."""
    return address if "://" in address else f"tcp://{address}"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    local_rank: int | None = None,
) -> dict:
    """Join the ``torch.distributed`` world; a no-op for one process.

    ``coordinator_address`` is ``host:port`` or an init-method URL
    (``file://...`` for processes of one machine without a port); it
    defaults to ``MASTER_ADDR:MASTER_PORT``, ``num_processes`` to
    ``WORLD_SIZE``, ``process_id`` to ``RANK`` and ``local_rank`` to
    ``LOCAL_RANK``, as ``torchrun`` sets them.  With a GPU the process
    takes ``cuda:local_rank`` and the backend is NCCL, else gloo; a caller
    who wants gloo on CUDA tensors names ``backend="gloo"``.  A world that
    is already initialized is kept.  Returns the JAX function's summary:
    ``process_index``, ``process_count``, ``local_devices``,
    ``global_devices``.
    """
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", "0"))
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(local_rank)
    if (not dist.is_initialized() and num_processes
            and num_processes > 1):
        if coordinator_address is None or process_id is None:
            raise ValueError("a multi-process run needs the coordinator "
                             "address and this process's id")
        dist.init_process_group(
            backend or ("nccl" if cuda else "gloo"),
            init_method=_init_method(coordinator_address),
            world_size=num_processes, rank=process_id)
    if dist.is_initialized() and dist.get_world_size() > 1:
        _heartbeat_group()
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def _heartbeat_group():
    """The world's gloo group of :func:`heartbeat`, made once (every rank
    must make it, in the same order as its other groups)."""
    if "group" not in _HEARTBEAT:
        _HEARTBEAT["group"] = dist.new_group(backend="gloo")
    return _HEARTBEAT["group"]


def heartbeat(timeout_s: float = 60.0) -> bool:
    """Cross-process liveness: an all-reduce of ones over the heartbeat's
    gloo group must give the world size within ``timeout_s``.  True for a
    single process; False on a timeout or an error (a dead peer)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return True
    group = _heartbeat_group()
    done = threading.Event()
    ok = [False]

    def probe():
        try:
            t = torch.ones(1)
            dist.all_reduce(t, group=group)
            ok[0] = int(t.item()) == dist.get_world_size()
        except Exception:  # noqa: BLE001 - any failure means a dead peer
            ok[0] = False
        finally:
            done.set()

    threading.Thread(target=probe, daemon=True).start()
    done.wait(timeout_s)
    return ok[0] and done.is_set()


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
