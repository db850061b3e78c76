"""Background prefetch of batches (JAX package: data/prefetch.py).

The reference overlaps host data work with the device through
``DataLoader(num_workers=8)`` (text2vec/train.py:226, vec2wav/train.py:116).
Here the batch iterators stay plain Python, and ``PrefetchIterator`` pulls
one on a daemon thread into a bounded queue, so that the next batch is read
and padded while the card runs the current step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()
# items made ahead: one waits while the consumer runs on the one before
DEPTH = 2


class PrefetchIterator(Iterator[T]):
    """Items of ``it`` produced on a background thread into a queue of
    ``DEPTH``.  An exception of the producer is raised in the consumer;
    ``close`` stops the producer and joins it."""

    def __init__(self, it: Iterable[T]):
        self._q: "queue.Queue" = queue.Queue(maxsize=DEPTH)
        self._err = None
        self._stop = threading.Event()

        def put(item) -> bool:
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as e:  # noqa: BLE001 - handed to the consumer, which raises it
                self._err = e
            finally:
                put(_SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)


def prefetched(it: Iterable[T], enabled: bool = True):
    """``it`` through a ``PrefetchIterator`` (or as it is, when not
    ``enabled``), closed also when the consumer stops early."""
    if not enabled:
        yield from it
        return
    pf = PrefetchIterator(it)
    try:
        yield from pf
    finally:
        pf.close()
