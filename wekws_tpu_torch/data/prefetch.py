"""Background-thread batch prefetching.

Copy of wekws_tpu/data/prefetch.py.  The reference wekws overlaps data
loading with compute via torch DataLoader workers (train.py
num_workers); ``num_workers=0`` here has a daemon thread run the host
pipeline (wav IO, resample, augmentation, batching) ahead of the
device, bounded by ``buffer_size`` batches.
"""

import queue
import threading
from typing import Iterable, Iterator


_SENTINEL = object()


class Prefetcher:
    """Wrap an iterable so iteration overlaps with the consumer."""

    def __init__(self, iterable: Iterable, buffer_size: int = 4):
        self.iterable = iterable
        self.buffer_size = buffer_size

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.buffer_size)
        error = []

        def producer():
            try:
                for item in self.iterable:
                    q.put(item)
            except BaseException as e:  # surface in consumer
                error.append(e)
            finally:
                q.put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        thread.join()
        if error:
            raise error[0]
