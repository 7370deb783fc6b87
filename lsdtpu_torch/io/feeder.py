"""Prefetching dataset feeder: parse the next datasets on the host while
the card works on the current one (the port's own copy of
lsdtpu/io/feeder.py; plain Python).

The reference's only concurrency runtime is a 30-thread pthread pool
fanning out match-scoring tasks (LSD/threadpool.c, LSD/myFA.cpp:22-62);
on the card that role is taken by the kernels, and the host concurrency
that remains useful is IO.  This feeder is a bounded worker pool with a
lookahead queue that parses datasets ahead of their consumption.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Iterable, Iterator, List, Sequence, TypeVar

from lsdtpu_torch.io.loaders import load_dataset

T = TypeVar("T")
U = TypeVar("U")


class PrefetchFeeder:
    """Map ``fn`` over ``items`` with a worker pool, yielding in order
    while keeping up to ``lookahead`` results in flight."""

    def __init__(self, fn: Callable[[T], U], items: Sequence[T],
                 workers: int = 4, lookahead: int = 2):
        self._fn = fn
        self._items = list(items)
        self._workers = workers
        self._lookahead = max(1, lookahead)

    def __iter__(self) -> Iterator[U]:
        with cf.ThreadPoolExecutor(max_workers=self._workers) as pool:
            pending: List[cf.Future] = []
            it = iter(self._items)
            exhausted = False
            while pending or not exhausted:
                while not exhausted and len(pending) < self._lookahead:
                    try:
                        pending.append(pool.submit(self._fn, next(it)))
                    except StopIteration:
                        exhausted = True
                if pending:
                    yield pending.pop(0).result()

    def __len__(self) -> int:
        return len(self._items)


def load_datasets_prefetched(paths: Iterable[str], workers: int = 4,
                             lookahead: int = 2):
    """Iterate Datasets for ``paths``, parsing ahead in the background."""
    return PrefetchFeeder(load_dataset, list(paths), workers=workers,
                          lookahead=lookahead)
