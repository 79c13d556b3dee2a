"""Host-side input prefetching.

The port's own copy of `ipercore_tpu/data/prefetch.py`: a daemon thread
drains the (synchronous, Python) dataset iterator into a bounded queue, so
PNG decode and resizing overlap with the device step.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class _Stop:
    pass


_STOP = _Stop()


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Wrap an iterator with a depth-bounded background-thread buffer.

    Exceptions in the producer are re-raised in the consumer; the thread is a
    daemon so abandoning the iterator does not hang interpreter exit.
    """
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))

    def producer():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — surface to consumer
            q.put(e)
            return
        q.put(_STOP)

    t = threading.Thread(target=producer, daemon=True, name="input-prefetch")
    t.start()

    while True:
        item = q.get()
        if item is _STOP:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
