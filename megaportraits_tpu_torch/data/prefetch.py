"""Host-to-device prefetch: the next batches are copied to the card while the
current step runs (counterpart of ``megaportraits_tpu/data/prefetch.py``).

A producer thread walks `iterator` and, for each batch (a dict, list or
tuple of numpy arrays, nested as it likes):
  * turns every array into a tensor in pinned host memory;
  * copies it to the card with ``non_blocking=True`` on a side CUDA stream
    and records an event there;
  * keeps the pinned buffers until that event has completed, so that no
    pinned page is freed or reused while the copy reads it;
  * hands the batch to a queue of `size` batches.
The consumer makes its current stream wait on the batch's event before it
yields the batch (without the wait, the step could read a batch whose copy
has not landed, which shows only under load), and marks every tensor as used
on that stream (``record_stream``), so that the caching allocator does not
hand the memory back to the side stream while the step still reads it.

The JAX function's contract holds: batches come in order, an exception of
the producer is raised in the consumer, and the iteration ends when
`iterator` does. ``device="cpu"`` yields plain CPU tensors (for the tests).
Closing the generator (or dropping it) stops the producer.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Union

import numpy as np
import torch

from megaportraits_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device


def map_leaves(fn: Callable[[Any], Any], tree: Any) -> Any:
    """`fn` applied to every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v) for v in tree)
    return fn(tree)


def _host_tensor(leaf: Any) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(leaf))


def prefetch_to_device(iterator: Iterator[Any], size: int = 2,
                       device: Union[str, torch.device] = DEFAULT_DEVICE
                       ) -> Iterator[Any]:
    """The batches of `iterator`, as tensors on `device` (the card by
    default; raises if there is none and the caller did not ask for the
    CPU), copied up to `size` batches ahead."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    sentinel = object()

    def put(item) -> bool:
        """Queue `item` unless the consumer has stopped; whether it did."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def to_device(item, stream):
        with torch.cuda.stream(stream):
            pinned = map_leaves(lambda a: _host_tensor(a).pin_memory(), item)
            moved = map_leaves(lambda t: t.to(dev, non_blocking=True), pinned)
            event = torch.cuda.Event()
            event.record(stream)
        event.synchronize()  # the copies are done: `pinned` may go
        return moved, event

    def producer():
        try:
            stream = None
            if dev.type == "cuda":
                torch.cuda.set_device(dev)  # the thread's current card
                stream = torch.cuda.Stream(dev)
            for item in iterator:
                if stream is None:
                    payload = (map_leaves(_host_tensor, item), None)
                else:
                    payload = to_device(item, stream)
                if not put(payload):
                    return
            put(sentinel)
        except BaseException as e:  # propagate, never end silently
            put(e)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, BaseException):
                raise item
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(event)
                map_leaves(lambda t: t.record_stream(current), batch)
            yield batch
    finally:
        stop.set()
