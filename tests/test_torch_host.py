"""The torch package's host-thread combinators (parallel/host.py), the copy
of the JAX package's: the tests of ``tests/test_host_pipeline.py`` on the
port's functions.  Results keep source order, the earliest failing item's
exception surfaces first, and an abandoned iterator leaves no thread
blocked.  Every test body runs under a watchdog: a hang fails the test
within its timeout instead of stalling the suite.
"""

import threading
import time

import pytest

from multithreading_string_matching_tpu.parallel import host as jax_host
from multithreading_string_matching_tpu_torch.parallel.host import map_prefetch, prefetch_iter

TIMEOUT_S = 30.0


def bounded(fn, timeout_s: float = TIMEOUT_S):
    """Run ``fn`` on a daemon thread; fail if it has not finished within
    ``timeout_s``, re-raise what it raised, return what it returned."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # handed to the test thread below
            out["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    assert not t.is_alive(), f"test body still running after {timeout_s} s"
    if "exc" in out:
        raise out["exc"]
    return out.get("value")


def test_prefetch_iter_order_and_completeness():
    def body():
        assert list(prefetch_iter(iter(range(100)), depth=3)) == list(range(100))
        assert list(prefetch_iter(iter([]), depth=1)) == []
        with pytest.raises(ValueError, match="depth must be >= 1"):
            next(prefetch_iter(iter([1]), depth=0))

    bounded(body)


def test_prefetch_iter_source_exception_propagates():
    def bad():
        yield 1
        yield 2
        raise RuntimeError("source died")

    def body():
        it = prefetch_iter(bad(), depth=2)
        assert next(it) == 1
        assert next(it) == 2
        with pytest.raises(RuntimeError, match="source died"):
            next(it)

    bounded(body)


def test_prefetch_iter_early_close_stops_producer():
    produced = []
    done = threading.Event()

    def src():
        try:
            for i in range(10_000):
                produced.append(i)
                yield i
        finally:
            done.set()

    def body():
        it = prefetch_iter(src(), depth=2)
        assert next(it) == 0
        it.close()  # consumer leaves; producer must unblock and exit
        assert done.wait(timeout=5), "producer thread did not stop"
        assert len(produced) < 100  # bounded lookahead, not a full drain

    bounded(body)


def test_map_prefetch_ordered_results():
    def slow_square(x):
        time.sleep((9 - x) * 0.003)  # earlier items finish later
        return x * x

    got = bounded(lambda: list(map_prefetch(slow_square, iter(range(10)), workers=4)))
    assert got == [x * x for x in range(10)]


def test_map_prefetch_fn_exception_in_source_order():
    def fn(x):
        if x in (3, 6):
            time.sleep(0.05 if x == 3 else 0)  # item 6 fails first in time
            raise ValueError(f"item {x} bad")
        return x

    def body():
        it = map_prefetch(fn, iter(range(10)), workers=4)
        assert [next(it) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(ValueError, match="item 3 bad"):
            next(it)

    bounded(body)


def test_map_prefetch_source_exception_propagates():
    def bad():
        yield 1
        raise OSError("read failed")

    def body():
        it = map_prefetch(lambda x: x, bad(), workers=2)
        assert next(it) == 1
        with pytest.raises(OSError, match="read failed"):
            next(it)

    bounded(body)


def test_map_prefetch_early_close_no_hang():
    calls = []

    def fn(x):
        calls.append(x)
        return x

    def body():
        it = map_prefetch(fn, iter(range(10_000)), workers=2, depth=3)
        assert next(it) == 0
        it.close()
        time.sleep(0.2)  # let any stragglers run
        assert len(calls) < 200  # bounded in-flight work, not a full drain

    bounded(body)


def test_map_prefetch_bounded_inflight():
    submitted = []

    def fn(x):
        submitted.append(x)
        return x

    def body():
        it = map_prefetch(fn, iter(range(1000)), workers=2, depth=4)
        next(it)
        time.sleep(0.3)
        assert len(submitted) <= 16, len(submitted)
        it.close()

    bounded(body)


def _consume(gen, slow_first_s: float):
    """Consume ``gen``, sleeping ``slow_first_s`` after the first item;
    returns (items, exception)."""
    items = []
    try:
        for x in gen:
            items.append(x)
            if len(items) == 1:
                time.sleep(slow_first_s)
    except Exception as e:
        return items, e
    return items, None


def test_prefetch_iter_error_survives_slow_consumer():
    def bad():
        yield 1
        yield 2
        yield 3
        raise RuntimeError("late source error")

    items, exc = bounded(lambda: _consume(prefetch_iter(bad(), depth=1), 1.6))
    assert items == [1, 2, 3]
    assert isinstance(exc, RuntimeError) and "late source error" in str(exc)


def test_map_prefetch_source_error_survives_slow_consumer():
    def bad():
        yield 1
        yield 2
        raise OSError("late read failure")

    items, exc = bounded(lambda: _consume(map_prefetch(lambda x: x, bad(), workers=1, depth=1),
                                          1.6))
    assert items == [1, 2]
    assert isinstance(exc, OSError) and "late read failure" in str(exc)


def test_prefetch_iter_done_survives_slow_consumer():
    items, exc = bounded(lambda: _consume(prefetch_iter(iter(range(4)), depth=1), 1.6))
    assert items == [0, 1, 2, 3] and exc is None


def test_abandoned_iterators_leave_no_thread_blocked():
    """After early closes of both combinators, every thread they started
    exits."""
    def body():
        before = set(threading.enumerate())
        for _ in range(5):
            it = prefetch_iter(iter(range(10_000)), depth=1)
            next(it)
            it.close()
            it = map_prefetch(lambda x: x, iter(range(10_000)), workers=3, depth=3)
            next(it)
            it.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            extra = [t for t in set(threading.enumerate()) - before
                     if t.name.startswith("msm-") and t.is_alive()]
            if not extra:
                return
            time.sleep(0.05)
        raise AssertionError(f"threads still alive: {[t.name for t in extra]}")

    bounded(body)


@pytest.mark.parametrize("workers", [1, 2, 4])
def test_map_prefetch_equals_jax_copy(workers):
    """The same items through the port's and the JAX package's combinators
    come out the same, in the same order."""
    def fn(x):
        time.sleep(((x * 7) % 5) * 0.001)
        return (x, x * x)

    got = bounded(lambda: list(map_prefetch(fn, prefetch_iter(iter(range(60)), depth=2),
                                            workers=workers, depth=workers + 1)))
    want = bounded(lambda: list(jax_host.map_prefetch(
        fn, jax_host.prefetch_iter(iter(range(60)), depth=2), workers=workers,
        depth=workers + 1)))
    assert got == want == [(x, x * x) for x in range(60)]
    with pytest.raises(ValueError, match="workers must be >= 1"):
        next(map_prefetch(fn, iter([1]), workers=0))
