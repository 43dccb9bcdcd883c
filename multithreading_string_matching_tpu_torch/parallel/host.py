"""Host-side pipeline parallelism: threaded prefetch + ordered map.

Counterpart of ``multithreading_string_matching_tpu/parallel/host.py``, a
copy of it (importing the JAX module would import jax through its package's
``__init__``).  The reference's task program keeps one producer thread
reading packet batches while worker threads match them
(openmp_task.c:126-186).  Here the host stages (streaming ingest
``iter_pcap``, decode ``extract_payloads``) overlap through two
combinators; every CUDA call stays on the consumer's thread:

- :func:`prefetch_iter` runs a source iterator in a background thread,
  handing items through a bounded queue (classic double buffering).
- :func:`map_prefetch` is an ordered ``imap`` over a small thread pool with
  a bounded number of in-flight items: the source advances and ``fn`` runs
  concurrently with the consumer, results arrive in source order (order is
  load-bearing for attribution: packet numbering is cumulative).

Threads buy real concurrency here because the hot stages release the GIL:
file reads, the native record walk and decode (ctypes calls), and large
numpy copies all drop it.  Exceptions raised by the source or by ``fn``
propagate to the consumer at the point of consumption; abandoning the
iterator (``break`` / ``close()``) stops the workers promptly and never
leaves a thread blocked on a full queue.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_DONE = object()  # queue sentinel: source exhausted
_ERR = object()   # queue sentinel prefix: (sentinel, exception)


def _put_or_stop(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Blocking put that stays responsive to ``stop``.  EVERY producer put
    (items, _DONE, errors) must go through this: a one-shot timeout put
    would drop the terminal sentinel when the consumer is merely SLOW (a
    long device drain), and the consumer would then block on q.get()
    forever.  Returns False only if stop was set first (consumer left)."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def prefetch_iter(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield from ``it``, advancing it in a background thread up to
    ``depth`` items ahead.  The source is touched ONLY by that thread."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        try:
            for item in it:
                if not _put_or_stop(q, item, stop):
                    return
            _put_or_stop(q, _DONE, stop)
        except BaseException as e:  # propagate to the consumer
            _put_or_stop(q, (_ERR, e), stop)

    t = threading.Thread(target=worker, daemon=True, name="msm-prefetch")
    t.start()
    try:
        while True:
            got = q.get()
            if got is _DONE:
                return
            if isinstance(got, tuple) and len(got) == 2 and got[0] is _ERR:
                raise got[1]
            yield got
    finally:
        stop.set()
        # Unblock a producer waiting on a full queue so the thread exits.
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def map_prefetch(
    fn: Callable[[T], U],
    it: Iterable[T],
    workers: int = 2,
    depth: int = 4,
) -> Iterator[U]:
    """Ordered parallel map: ``fn`` runs over ``it`` on ``workers`` threads
    with at most ``depth`` results in flight; results yield in source order.

    The scheduler thread owns the source iterator; the consumer waits on
    futures in submission order, so downstream code sees exactly the
    sequential ``map`` semantics (including which exception it sees first:
    the earliest failing item's)."""
    if workers < 1:
        raise ValueError("workers must be >= 1")
    if depth < workers:
        depth = workers
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="msm-map")

    def guarded(item):
        if stop.is_set():  # consumer left: don't burn cycles on dead work
            raise _Cancelled()
        return fn(item)

    def scheduler():
        try:
            for item in it:
                fut = pool.submit(guarded, item)
                if not _put_or_stop(q, fut, stop):
                    fut.cancel()
                    return
            _put_or_stop(q, _DONE, stop)
        except BaseException as e:  # source raised: surface it in order
            f: Future = Future()
            f.set_exception(e)
            _put_or_stop(q, f, stop)

    t = threading.Thread(target=scheduler, daemon=True, name="msm-map-sched")
    t.start()
    try:
        while True:
            got = q.get()
            if got is _DONE:
                return
            yield got.result()
    finally:
        stop.set()
        try:
            while True:
                f = q.get_nowait()
                if f is not _DONE:
                    f.cancel()
        except queue.Empty:
            pass
        pool.shutdown(wait=False, cancel_futures=True)


class _Cancelled(Exception):
    """Internal: a pool item observed the consumer's departure."""
