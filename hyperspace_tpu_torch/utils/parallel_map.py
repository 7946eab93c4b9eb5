"""Order-preserving threaded map (counterpart of
hyperspace_tpu/utils/parallel_map.py).

pyarrow's readers release the GIL, so the per-bucket joins of a
bucket-aligned join overlap their file decoding instead of taking turns
on one core.  Fail-fast: the first exception stops submitting further
work and is raised once the tasks in flight have finished.

One shared pool serves every call, so a query does not create and tear
down threads per call.  A nested call runs inline in the calling worker
(the outer call already gives the parallelism, and nested submission
to a bounded shared pool could deadlock).  ``max_workers`` caps a call's
tasks in flight by throttled submission, so concurrent callers share the
pool.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, List, Optional, Sequence, TypeVar

T = TypeVar("T")
R = TypeVar("R")

_POOL = None
_POOL_PID: Optional[int] = None
_POOL_LOCK = threading.Lock()
_IN_WORKER = threading.local()


def _pool():
    global _POOL, _POOL_PID
    with _POOL_LOCK:
        # Fork guard: a child inherits the pool OBJECT but not its threads;
        # submitting to it would hang forever.
        if _POOL is None or _POOL_PID != os.getpid():
            from concurrent.futures import ThreadPoolExecutor

            _POOL = ThreadPoolExecutor(
                max_workers=min(32, (os.cpu_count() or 4) * 2),
                thread_name_prefix="hs-io")
            _POOL_PID = os.getpid()
        return _POOL


def parallel_map_ordered(fn: Callable[[T], R], items: Sequence[T],
                         max_workers: int = 16) -> List[R]:
    n = len(items)
    if n <= 1 or getattr(_IN_WORKER, "active", False):
        return [fn(x) for x in items]
    workers = min(n, os.cpu_count() or 4, max_workers)
    pool = _pool()
    results: List = [None] * n
    cond = threading.Condition()
    state = {"next": 0, "outstanding": 0, "error": None}

    def run(i: int) -> None:
        _IN_WORKER.active = True
        err = None
        try:
            results[i] = fn(items[i])
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller
            err = e
        finally:
            _IN_WORKER.active = False
        with cond:
            state["outstanding"] -= 1
            if err is not None and state["error"] is None:
                state["error"] = err
            cond.notify_all()

    with cond:
        while True:
            while (state["error"] is None and state["next"] < n
                   and state["outstanding"] < workers):
                i = state["next"]
                state["next"] += 1
                state["outstanding"] += 1
                pool.submit(run, i)
            if state["outstanding"] == 0 and (
                    state["error"] is not None or state["next"] >= n):
                break
            cond.wait()
    if state["error"] is not None:
        raise state["error"]
    return results
