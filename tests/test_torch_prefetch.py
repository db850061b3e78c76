"""The loops' batch prefetcher (``data/prefetch.py``): order, errors and
shutdown.  Items are compared exactly; no tolerance applies."""

import itertools
import threading
import time

import pytest

from wavthruvec_pytorch_tpu_torch.data.prefetch import DEPTH, PrefetchIterator, prefetched


def test_items_in_order_on_another_thread():
    threads = []

    def gen():
        for i in range(10):
            threads.append(threading.current_thread())
            yield i

    assert list(PrefetchIterator(gen())) == list(range(10))
    assert threads and all(t is not threading.current_thread() for t in threads)


def test_producer_error_raised_in_consumer():
    def gen():
        yield 1
        raise KeyError("bad item")

    it = PrefetchIterator(gen())
    assert next(it) == 1
    with pytest.raises(KeyError, match="bad item"):
        next(it)


def test_close_stops_an_endless_producer():
    made = []

    def gen():
        for i in itertools.count():
            made.append(i)
            yield i

    it = PrefetchIterator(gen())
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert not it._thread.is_alive()
    # the producer ran at most DEPTH items ahead, plus the one it held
    assert len(made) <= 3 + DEPTH + 1


@pytest.mark.parametrize("enabled", [True, False])
def test_prefetched_stops_on_early_exit(enabled):
    """Leaving the loop early stops the producer; without ``enabled`` the
    items come from the caller's own thread."""
    threads = []

    def gen():
        for i in itertools.count():
            threads.append(threading.current_thread())
            yield i

    batches = prefetched(gen(), enabled=enabled)
    assert [b for _, b in zip(range(4), batches)] == [0, 1, 2, 3]
    batches.close()
    made = len(threads)
    time.sleep(0.3)
    assert len(threads) == made <= 4 + DEPTH + 1
    assert all((t is threading.current_thread()) is not enabled for t in threads)
