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
    items ready. Exceptions in the producer re-raise at the consumer."""
    if buffer_size < 1:
        yield from iterable
        return

    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)

    def producer() -> None:
        try:
            for item in iterable:
                q.put(item)
        except BaseException as exc:  # noqa: BLE001 — forwarded to the consumer
            q.put(exc)
            return
        q.put(_END)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
