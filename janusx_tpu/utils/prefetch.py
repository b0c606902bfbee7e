"""One-ahead background prefetch for streaming superblock scans.

The reference overlaps 2-bit decode with BLAS compute via double
buffering (/root/reference/src/stats/gblup.rs:27-28 mpsc channels,
fvlmm.rs:20). The device analog: while the device runs superblock k, a
background thread materializes superblock k+1 from the (possibly
disk-backed) genotype source — host IO/decode rides under device
compute instead of serializing with it.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator


def prefetch_one_ahead(items: Iterable, make: Callable) -> Iterator:
    """Yield ``make(item)`` for each item, materializing the NEXT item's
    result in a background thread while the caller consumes the current
    one. Exceptions from ``make`` surface at the corresponding yield (in
    order); at most two results are alive at once (double buffering)."""
    items = list(items)
    if not items:
        return
    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(make, items[0])
        for nxt in items[1:]:
            cur = fut.result()
            fut = ex.submit(make, nxt)
            yield cur
        yield fut.result()


_SENTINEL = object()


def prefetch_iter(it: Iterable) -> Iterator:
    """One-ahead prefetch over an arbitrary iterator: the NEXT element is
    pulled in a background thread while the caller consumes the current
    one. The source iterator is only ever advanced by the single worker
    (no concurrent access to its internals)."""
    it = iter(it)

    def pull():
        return next(it, _SENTINEL)

    with ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(pull)
        while True:
            cur = fut.result()
            if cur is _SENTINEL:
                return
            fut = ex.submit(pull)
            yield cur
