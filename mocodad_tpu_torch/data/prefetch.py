"""Background batch prefetching.

Counterpart of `mocodad_tpu/data/prefetch.py:21-82`: batch assembly (the
NumPy gather and padding of `make_loader`) runs in a producer thread while
the card executes the previous batch, and `place` (for example the pinned
host-to-device copy) runs there too, so the copy is issued ahead of its
use.  The card waits on the host only when the host falls `depth` batches
behind.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`; on a CUDA device through
    pinned memory, with a copy that does not block the host."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != 'cuda':
        return t
    return t.pin_memory().to(device, non_blocking=True)


def prefetch(iterator: Iterator[Dict[str, Any]],
             place: Optional[Callable[[Dict], Any]] = None,
             depth: int = 2) -> Iterator[Any]:
    """Wrap a batch iterator with a background producer thread.

    `place`, when given, is applied to each batch in the producer thread.
    An error in the producer is raised to the consumer.  The producer stops
    promptly when the consumer abandons the iterator (close, garbage
    collection or an exception in the consuming loop): its queue puts poll
    a stop flag instead of blocking forever.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    err = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                if not put(place(batch) if place is not None else batch):
                    return
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            try:
                # bounded wait: a producer that died without enqueuing the
                # end marker surfaces as an error, not a hang
                item = q.get(timeout=5.0)
            except queue.Empty:
                if not t.is_alive() and q.empty():
                    if err:
                        raise err[0]
                    raise RuntimeError('prefetch producer died without '
                                       'signalling the end of its stream')
                continue
            if item is end:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
