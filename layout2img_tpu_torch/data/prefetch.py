"""Device prefetch (counterpart of ``layout2img_tpu/data/prefetch.py::device_prefetch``):
host batches go to the device in a background thread, ``size`` steps ahead of
the loop that consumes them.

On a CUDA device each numpy array is copied into pinned host memory and
then ``non_blocking`` to the device on a side stream of its own. The
consumer's stream waits on an event recorded after the copies, and every
tensor is marked with ``record_stream`` for the consumer's stream, so the
caching allocator does not hand the buffer out again while the consumer
still uses it. On the CPU the arrays only become tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch


def device_prefetch(iterable: Iterable[dict], device: torch.device | str, size: int = 2,
                    ) -> Iterator[dict[str, torch.Tensor]]:
    """Wrap an iterator of ``{name: numpy array}`` batches; yields
    ``{name: tensor on device}`` in order. An error of the host iterator or
    of a copy is raised in the consumer."""
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=size)
    end, stop = object(), threading.Event()
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch: dict[str, Any]):
        if side is None:
            return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, None
        with torch.cuda.stream(side):
            out = {k: torch.from_numpy(np.asarray(v)).pin_memory().to(device, non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def offer(item) -> bool:
        """Put ``item`` unless the consumer went away; False then."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for batch in iterable:
                if not offer(put(batch)):
                    return
        except BaseException as exc:  # noqa: BLE001 - raised again in the consumer
            offer(exc)
        else:
            offer(end)

    thread = threading.Thread(target=worker, name="device-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
            if ready is not None:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(ready)
                for t in batch.values():
                    t.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        thread.join()
