"""Threaded host data pipeline: parallel JPEG decode + bounded prefetch.

Port of `pf3plat_tpu/data/prefetch.py` (the port's own copy).

The reference overlaps host-side decode with device compute via multi-worker
DataLoaders (`src/dataset/data_module.py:90-110`, num_workers=16 with
persistent workers). Re-designed for one training process:

  * the iteration thread walks chunks and runs the RNG-consuming sample
    phase (`ChunkDataset._sample_example`) so sampling order and the random
    stream stay deterministic regardless of worker count;
  * a `ThreadPoolExecutor` runs the pure realize phase (JPEG decode via
    libjpeg releases the GIL, so threads scale without pickling overhead —
    the reason the reference needs worker *processes* under torch does not
    apply);
  * a bounded deque of in-flight futures provides backpressure and keeps
    results in submission order (deterministic batches).

`global_step` is read at submission time, so with a prefetch depth of k the
view-sampler schedule (warm-up gap widening) can lag up to k examples behind
the true step — the same staleness the reference's prefetching workers have.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterator, Optional

from .dataset import ChunkDataset
from .types import Example


class ExamplePipeline:
    """Iterator of Examples with background decode workers.

    Falls back to the synchronous `ChunkDataset.examples` path when
    `num_workers == 0`. Iteration stops after one pass for non-train stages
    (mirroring `ChunkDataset.examples`); for train, the caller re-creates
    the iterator per epoch (as `main.batch_iterator` does).
    """

    def __init__(
        self,
        dataset: ChunkDataset,
        get_step: Callable[[], int],
        num_workers: int = 4,
        prefetch: int = 16,
    ):
        self.dataset = dataset
        self.get_step = get_step
        self.num_workers = int(num_workers)
        self.prefetch = max(1, int(prefetch))
        self._pool: Optional[ThreadPoolExecutor] = None
        self._closed = threading.Event()

    def close(self) -> None:
        self._closed.set()
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def __enter__(self) -> "ExamplePipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator[Example]:
        if self.num_workers <= 0:
            yield from self.dataset.examples(global_step=self.get_step())
            return
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix="pf3plat-data",
            )
        ds = self.dataset
        pending: collections.deque[Future] = collections.deque()

        def drain_one() -> Optional[Example]:
            fut = pending.popleft()
            return fut.result()  # re-raises worker exceptions here

        try:
            for raw_ex, plan in ds.plans(self.get_step):
                if self._closed.is_set():
                    return
                pending.append(
                    self._pool.submit(ds._realize_example, raw_ex, plan)
                )
                while len(pending) >= self.prefetch:
                    out = drain_one()
                    if out is not None:
                        yield out
            while pending:
                out = drain_one()
                if out is not None:
                    yield out
        finally:
            for fut in pending:
                fut.cancel()
