"""Host <-> device streaming pipeline.

The reference overlaps host DMA with compute through depth-2 ObjectFIFOs
programmed by the shim-tile DMA sequence (reference src/aie2.py:28,331-337):
while the array computes iteration k, the DMAs fill k+1 and drain k-1. The
analog at the host boundary: `jax.device_put` is asynchronous, as
is dispatch, so a small in-flight queue gives the same 3-deep overlap —
upload(k+1) and compute(k) and download(k-1) run concurrently; only the
final `device_get` of the oldest entry blocks.

Use for bulk workloads whose data lives on host (files, sockets): the
transform pipeline stays busy while transfers ride the queue.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator


def stream_transform(fn: Callable, inputs: Iterable, *, prefetch: int = 2,
                     to_host: bool = True) -> Iterator:
    """Yield fn(batch) for each input batch, keeping `prefetch` batches in
    flight (device_put + dispatch happen before the previous result is
    drained).

    fn: a device callable (e.g. plan.make_batched(B)['fwd']).
    inputs: host arrays (or (hi, lo) tuples for the Goldilocks plan).
    to_host: fetch results back to NumPy (True) or yield device arrays.
    """
    import jax
    import numpy as np

    if prefetch < 1:
        raise ValueError("prefetch must be >= 1")

    def launch(x):
        if isinstance(x, tuple):
            x = tuple(jax.device_put(v) for v in x)
        else:
            x = jax.device_put(x)
        return fn(x)

    q: collections.deque = collections.deque()
    it = iter(inputs)
    for x in it:
        q.append(launch(x))
        if len(q) < prefetch:  # strictly <: at most `prefetch` in flight
            continue
        out = q.popleft()
        yield jax.tree_util.tree_map(np.asarray, out) if to_host else out
    while q:
        out = q.popleft()
        yield jax.tree_util.tree_map(np.asarray, out) if to_host else out
