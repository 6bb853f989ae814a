"""Host-side pipelined prefetch for training data streams (port of
``stgcn_tpu/data/prefetch.py``).

The reference overlaps data loading with compute via torch
``DataLoader(num_workers)`` subprocess prefetch (src/lightning_model.py:
181-194).  The port needs no worker processes: CUDA launches are already
asynchronous, so the serial host work left in the step loop is
*producing* the next batch (npy reads, wrap-pad collation, augmentation).
:func:`prefetch` moves that production onto a background thread with a
bounded queue, so batch ``i+1`` is collated while the device runs step
``i``.

A thread (not a process) is the right tool here: collation is numpy slicing
and ``np.load`` I/O, which release the GIL, and the arrays stay in the same
address space for the copy to the device.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterable, Iterator

_SENTINEL = object()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterator:
    """Iterate ``iterable`` through a ``depth``-deep background queue.

    Exceptions raised by the producer are re-raised at the consumer's next
    ``next()`` call, preserving the failure semantics of plain iteration.
    If the consumer abandons the iterator early, the producer thread is
    unblocked (the queue is drained) and exits at its next put.
    """
    if depth < 1:
        yield from iterable
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def produce() -> None:
        try:
            for item in iterable:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
            q.put(_SENTINEL)
        except BaseException as e:  # noqa: BLE001 - forwarded to consumer
            q.put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
