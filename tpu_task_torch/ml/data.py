"""Host→device input pipeline: sharded batching with device prefetch — the
counterpart of ``tpu_task/ml/data.py``.

:func:`epoch_batches` is the JAX package's host-side batching (numpy
only), copied so that a restored task sees the same sequence of batches in
either package. :func:`prefetch_to_device` stages the next batches on the
card while the current step runs: each is copied into pinned host memory
and sent on a side stream, and the consuming stream waits on that copy's
event only when it takes the batch."""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from tpu_task_torch.device import process_count as _process_count
from tpu_task_torch.device import process_index as _process_index
from tpu_task_torch.device import resolve_device
from tpu_task_torch.ml.tree import tree_map


def epoch_batches(data: np.ndarray, labels: Optional[np.ndarray],
                  batch_size: int, *, seed: int = 0,
                  epochs: Optional[int] = None,
                  process_index: Optional[int] = None,
                  process_count: Optional[int] = None,
                  start_step: int = 0) -> Iterator:
    """Shuffled, drop-remainder batches; deterministic per (seed, epoch).

    Multi-process: ``batch_size`` is the GLOBAL batch; with
    ``process_count > 1`` each process yields only its contiguous slice of
    every global batch. The permutation depends only on (seed, epoch), so
    all processes agree on the global batch with zero communication
    (defaults: the ``torch.distributed`` rank and world size, else 0 of 1).

    Resume: ``start_step`` skips the first N GLOBAL steps, so a restored
    task continues the exact sequence it would have seen — pair it with the
    step restored from the checkpoint. Whole skipped epochs don't pay their
    permutation."""
    n = len(data)
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > dataset size {n}")
    if process_index is None:
        process_index = _process_index()
    if process_count is None:
        process_count = _process_count()
    if batch_size % process_count:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{process_count} processes")
    if not 0 <= process_index < process_count:
        raise ValueError(f"process_index {process_index} out of range for "
                         f"process_count {process_count}")
    local = batch_size // process_count
    steps_per_epoch = (n - batch_size) // batch_size + 1
    if start_step < 0:
        raise ValueError(f"start_step must be >= 0, got {start_step}")
    skip = start_step

    epoch_iter = range(epochs) if epochs is not None else itertools.count()
    for epoch in epoch_iter:
        if skip >= steps_per_epoch:
            skip -= steps_per_epoch
            continue
        order = np.random.default_rng(seed + epoch).permutation(n)
        for step, start in enumerate(
                range(0, n - batch_size + 1, batch_size)):
            if step < skip:
                continue
            base = start + process_index * local
            index = order[base:base + local]
            if labels is None:
                yield data[index]
            else:
                yield data[index], labels[index]
        skip = 0


def prefetch_to_device(iterable: Iterable, device=None, depth: int = 2):
    """Stage ``depth`` batches ahead on ``device`` (CUDA unless the caller
    passes ``device="cpu"``); a batch is an array or a tuple, list or dict
    of them.

    On CUDA each array is copied into pinned host memory and sent with
    ``non_blocking=True`` on a side stream, so the copies of the next
    batches run under the current step. A batch's tensors are handed out
    after the consuming stream is made to wait on their copy's event, and
    are recorded on that stream, so the caching allocator never reuses
    their memory while the consumer may still read it.

    JAX's ``sharding`` argument is a device here, or a mesh
    (:class:`~tpu_task_torch.ml.parallel.mesh.Mesh`), the counterpart of a
    batch sharded over its batch axes: each batch is then the global one,
    and this rank's rows of every array (``mesh.local_batch``) go to the
    mesh's device."""
    from tpu_task_torch.ml.parallel.mesh import Mesh, local_batch

    if depth < 1:
        raise ValueError("depth must be >= 1")
    rows = lambda a: a                              # noqa: E731
    if isinstance(device, Mesh):
        mesh = device
        device = mesh.device

        def rows(a):
            return local_batch(a, mesh)
    elif not isinstance(device, (type(None), str, int, torch.device)):
        raise NotImplementedError(
            f"prefetch_to_device places batches on a device or a mesh's "
            f"rank, not {type(device).__name__}")
    device = resolve_device(device)

    if device.type != "cuda":
        def place(batch):
            return tree_map(
                lambda a: torch.as_tensor(rows(a), device=device), batch)

        def hand_out(staged):
            return staged
    else:
        side = torch.cuda.Stream(device)

        def place(batch):
            with torch.cuda.stream(side):
                staged = tree_map(
                    lambda a: torch.as_tensor(rows(a)).pin_memory().to(
                        device, non_blocking=True), batch)
                event = torch.cuda.Event()
                event.record(side)
            return staged, event

        def hand_out(staged):
            batch, event = staged
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)

            def mark(tensor):
                tensor.record_stream(consumer)
                return tensor

            return tree_map(mark, batch)

    pending = collections.deque()
    iterator = iter(iterable)
    for batch in itertools.islice(iterator, depth):
        pending.append(place(batch))
    while pending:
        staged = pending.popleft()
        for batch in itertools.islice(iterator, 1):
            pending.append(place(batch))
        yield hand_out(staged)
