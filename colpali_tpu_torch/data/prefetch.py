"""Host-side prefetching (counterpart of :mod:`colpali_tpu.data.prefetch`): a
daemon thread runs host work (image staging) ahead of the device."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_END = object()


def prefetch(iterable: Iterable[T], buffer_size: int = 2) -> Iterator[T]:
    """Iterate ``iterable`` on a daemon thread, keeping up to ``buffer_size``
    items ready. Exceptions in the producer re-raise at the consumer. When
    the consumer stops early (a ``break``, or the generator closed or
    collected), the queue is drained and the producer returns after its
    next item, letting go of ``iterable``: a thread left blocked on a full
    queue would hold it, and whatever it refers to
    (``ColModelTraining.batches`` holds the trainer, its model and its
    state), for the rest of the process."""
    if buffer_size < 1:
        yield from iterable
        return

    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()

    def producer(source: Iterator[T]) -> None:
        try:
            for item in source:
                q.put(item)
                if stop.is_set():  # the consumer has gone: after its drain this put found room
                    return
        except BaseException as exc:  # noqa: BLE001 — forwarded to the consumer
            q.put(exc)
            return
        q.put(_END)

    thread = threading.Thread(target=producer, args=(iter(iterable),), daemon=True)
    del iterable  # the producer's frame holds the only reference, released when it returns
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
