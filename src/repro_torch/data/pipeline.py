"""Host-side input pipeline: background prefetch and device placement (port
of ``repro/data/pipeline.py``).

The batch source is numpy (``SyntheticC4``), so one background thread hides
batch synthesis behind the device step. ``DevicePrefetcher`` also places the
batches on a device: on a card the worker copies each batch from pinned host
tensors with ``non_blocking=True`` on a side stream and records an event, and
the consumer's stream waits on that event before the batch is used, so the
host-to-device copy overlaps the previous step. With ``shardings`` (the
mesh's ``parallel.sharding.batch_shardings``) it places only this rank's
rows of each batch, as the JAX package's ``device_put`` with the batch
shardings leaves each device its shard; the train step takes such a batch
(``LocalRows``) as it is.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.sharding import LocalRows

__all__ = ["Prefetcher", "DevicePrefetcher"]


class Prefetcher:
    """Wrap a ``batch(step)`` source with an N-deep background queue."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self._source = source
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> tuple[dict, Any]:
        """(the batch as served, what the consumer waits on before using it)."""
        return batch, None

    def _ready(self, batch: dict, pending) -> dict:
        return batch

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch, pending = self._place(self._source.batch(step))
            while not self._stop.is_set():
                try:
                    self._queue.put((step, batch, pending), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        _, batch, pending = self._queue.get()
        return self._ready(batch, pending)

    def batch(self, step: int) -> dict:
        """Trainer-compatible access: serves from the queue when the step
        matches the stream position, synthesizes directly for a step the
        stream has passed (right after a restore to an earlier step), and
        drains stale entries."""
        while True:
            got_step, batch, pending = self._queue.get()
            if got_step == step:
                return self._ready(batch, pending)
            if got_step > step:
                return self._ready(*self._place(self._source.batch(step)))

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


class DevicePrefetcher(Prefetcher):
    """A ``Prefetcher`` that also places every batch on ``device`` (the card
    unless told otherwise); with ``shardings`` (a dict of
    ``BatchSharding`` by batch key) only this rank's rows."""

    def __init__(self, source, shardings: Any = None, device=None, **kw):
        self._shardings = shardings
        self._device = resolve_device(device)
        self._side = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        super().__init__(source, **kw)

    def _place(self, batch: dict) -> tuple[dict, Any]:
        n = next(iter(batch.values())).shape[0]
        if self._shardings is not None:
            batch = {k: self._shardings[k].take(v) for k, v in batch.items()}
        host = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
                for k, v in batch.items()}
        if self._side is None:
            return self._wrap({k: v.to(self._device) for k, v in host.items()}, n), None
        pinned = {k: v.pin_memory() for k, v in host.items()}
        with torch.cuda.stream(self._side):
            out = {k: v.to(self._device, non_blocking=True) for k, v in pinned.items()}
            done = torch.cuda.Event()
            done.record(self._side)
        # the pinned sources stay referenced until the copies are waited on
        return self._wrap(out, n), (done, pinned)

    def _wrap(self, batch: dict, n: int) -> dict:
        return batch if self._shardings is None else LocalRows(batch, n)

    def _ready(self, batch: dict, pending) -> dict:
        if pending is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(pending[0])
            for v in batch.values():
                # the allocator must not hand these blocks back to the side
                # stream while the consumer's stream still reads them
                v.record_stream(stream)
        return batch
