"""Checkpoint-to-workdir for the port's trees of tensors — the counterpart of
``tpu_task/ml/checkpoint.py``, on the same on-disk layout.

The orchestrator's recovery story: the task script checkpoints into its
workdir, the agent syncs the workdir to the bucket every 10 s, and a
respawned machine restores the workdir before restarting the script. This
module is the script's half of that for PyTorch state:

* the files are the JAX package's: ``ckpt-N.npz`` + ``LATEST``, and
  ``ckpt-N.shard-P.npz`` + ``ckpt-N.meta`` + ``LATEST_SHARDED``, with
  ``leaf_i`` and ``leaf_i|a:b,...`` keys, each published by a temp file and
  a rename, so a checkpoint of either package restores into the other;
* a tree flattens by JAX's rules: dict keys sorted, lists and tuples in
  order, a NamedTuple by field, ``None`` holding no leaf. The port's
  ``TrainState`` flattens to the JAX ``TrainState``'s leaves, and a Python
  int is written as the int32 0-d array ``jnp.asarray`` makes of it
  (int64 past int32's range);
* dtypes numpy lacks (bf16, the fp8 types) are written as raw ``|V<n>``
  bit patterns, as JAX writes its ml_dtypes arrays, and read back through
  ``Tensor.view``;
* restore puts each leaf on the template leaf's device with its dtype (a
  Python int comes back as an int);
* :class:`AsyncCheckpointer` — overlapped saves: a device-side snapshot on
  the caller's stream, then copy-out, serialization and publish (and an
  optional upload into the bucket) on a background writer.

A state sharded over a mesh of ranks (``train.shard_state``: each rank
holds its block of every leaf as a plain tensor) is saved and restored
with its layout: ``specs=`` (the spec tree, ``train.state_pspecs``) and
``mesh=``. Each rank then writes ``ckpt-N.shard-{rank}.npz`` with its
blocks keyed by their global index range, as JAX writes a sharded
``jax.Array``'s addressable shards; a block replicated over some axes is
written by the rank at index 0 along each of them alone (JAX's
``replica_id == 0``). Restore reads the ranges its blocks need from
whichever files hold them, assembling a range from the pieces that
cover it, so a save restores into another mesh, another rank count or
one process, and across packages in both directions.

Without a layout the process index and count come from
``torch.distributed`` when a group is initialized, else 0 of 1, and
process 0 writes every leaf whole. A DTensor, which the port never makes,
raises."""

from __future__ import annotations

import json
import os
import queue
import re
import tempfile
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Iterable, Optional

import numpy as np
import torch

from tpu_task_torch.device import process_count, process_index
from tpu_task_torch.ml.parallel.sharding import (
    global_shape,
    shard_slices,
    spec_leaves,
    writes_block,
)
from tpu_task_torch.ml.tree import leaves as tree_leaves, unflatten

_STEP_RE = re.compile(r"^ckpt-(\d+)\.npz$")
_SHARD_RE = re.compile(r"^ckpt-(\d+)\.shard-(\d+)\.npz$")

#: Signed integer dtypes by item size: the views raw leaves cross through.
_RAW_INT = {1: (np.uint8, torch.uint8), 2: (np.int16, torch.int16),
            4: (np.int32, torch.int32), 8: (np.int64, torch.int64)}
_INT32 = np.iinfo(np.int32)


def _refuse_dtensor(leaf: Any) -> None:
    if isinstance(leaf, torch.Tensor) and type(leaf).__name__ == "DTensor":
        raise NotImplementedError(
            "DTensor leaves are not ported (ROADMAP A14): a sharded state "
            "holds each rank's block as a plain tensor; save and restore it "
            "with specs= and mesh=")


# -- leaves ------------------------------------------------------------------

def _tensor_numpy(tensor: torch.Tensor) -> np.ndarray:
    """A CPU tensor as numpy, sharing its memory. A dtype numpy lacks
    crosses as its raw bits, ``|V<itemsize>``."""
    try:
        return tensor.numpy()
    except TypeError:
        np_int, torch_int = _RAW_INT[tensor.element_size()]
        return tensor.view(torch_int).numpy().view(
            f"V{tensor.element_size()}")


def _host(leaf: Any) -> np.ndarray:
    """One leaf as the numpy array the file holds. A CPU tensor's array
    shares its memory: serialize it before the tensor changes."""
    _refuse_dtensor(leaf)
    if isinstance(leaf, torch.Tensor):
        return _tensor_numpy(leaf.detach().cpu())
    if isinstance(leaf, int) and not isinstance(leaf, bool) and \
            _INT32.min <= leaf <= _INT32.max:
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _restore_leaf(array: np.ndarray, leaf: Any, name: str) -> Any:
    """``array`` as ``leaf``'s kind: a tensor on its device with its dtype,
    a Python scalar, or a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        _refuse_dtensor(leaf)
        if tuple(array.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: shape {tuple(array.shape)}, template "
                             f"wants {tuple(leaf.shape)}")
        raw = array.dtype.kind == "V" or (
            leaf.dtype == torch.bfloat16
            and array.dtype in (np.uint16, np.int16))
        if raw:
            if array.dtype.itemsize != leaf.element_size():
                raise ValueError(
                    f"{name}: {array.dtype.itemsize}-byte raw values for a "
                    f"{leaf.dtype} template")
            np_int, _ = _RAW_INT[array.dtype.itemsize]
            tensor = torch.from_numpy(array.view(np_int)).view(leaf.dtype)
        else:
            tensor = torch.from_numpy(np.ascontiguousarray(array))
        return tensor.to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(array)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return np.asarray(array).astype(leaf.dtype, copy=False)
    return array


def _write_npz_atomic(directory: Path, final_name: str, arrays: dict) -> Path:
    """Serialize ``arrays`` to ``directory/final_name`` via temp file +
    rename, so the sync loop (and a crash) never observes a torn file."""
    final = directory / final_name
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as handle:
            np.savez(handle, **arrays)
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return final


# -- the single-file format ------------------------------------------------------

def save_checkpoint(directory, step: int, tree: Any,
                    keep: Optional[int] = None) -> Path:
    """Write ``ckpt-{step}.npz`` atomically, then update LATEST.

    ``keep``: retain the newest N checkpoints plus, always, the one just
    written (an out-of-order re-save must never delete its own file and
    leave LATEST dangling)."""
    if keep is not None and keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    arrays = {f"leaf_{i}": _host(leaf)
              for i, leaf in enumerate(tree_leaves(tree))}
    final = _write_npz_atomic(directory, f"ckpt-{step}.npz", arrays)

    pointer = directory / "LATEST.tmp"
    pointer.write_text(json.dumps({"step": step, "file": final.name}))
    os.replace(pointer, directory / "LATEST")
    if keep is not None:
        steps = sorted(
            int(match.group(1)) for path in directory.iterdir()
            if (match := _STEP_RE.match(path.name)))
        retained = set(steps[-keep:]) | {step}
        for old in steps:
            if old not in retained:
                (directory / f"ckpt-{old}.npz").unlink(missing_ok=True)
    return final


def latest_step(directory) -> Optional[int]:
    """Highest complete checkpoint step in ``directory``, or None."""
    directory = Path(directory)
    pointer = directory / "LATEST"
    if pointer.exists():
        try:
            meta = json.loads(pointer.read_text())
            if (directory / meta["file"]).exists():
                return int(meta["step"])
        except (ValueError, KeyError):
            pass
    steps = [
        int(m.group(1))
        for p in (directory.iterdir() if directory.is_dir() else [])
        if (m := _STEP_RE.match(p.name))
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory, template: Any,
                       step: Optional[int] = None) -> Any:
    """Restore into ``template``'s structure, devices and dtypes."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    with np.load(directory / f"ckpt-{step}.npz") as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(data.files))]
    leaves = tree_leaves(template)
    if len(arrays) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, template has {len(leaves)}")
    return unflatten(template, iter([
        _restore_leaf(array, leaf, f"leaf_{i}")
        for i, (array, leaf) in enumerate(zip(arrays, leaves))]))


# -- process-sharded checkpoints -------------------------------------------------
#
# Each process writes ckpt-{step}.shard-{process}.npz with entries keyed by a
# leaf's GLOBAL index range, and restore reassembles from whichever files
# hold the ranges, so a respawned job restores even if its process numbering
# changed. Without a layout every leaf is a whole value, which process 0
# writes, as JAX's process 0 writes its plain host values; with one, each
# rank writes the blocks it is the first copy of.

def _range_key(leaf_index: int, index) -> str:
    """The key of a block: its global index range, dim by dim (JAX's
    ``_index_key``)."""
    return f"leaf_{leaf_index}|" + ",".join(f"{s.start}:{s.stop}"
                                           for s in index)


def _shape(leaf: Any) -> tuple:
    return (tuple(leaf.shape) if isinstance(leaf, torch.Tensor)
            else np.shape(leaf))


class _Layout:
    """Who writes what: this process's index and count, and each leaf's
    global index range on it — the whole leaf on process 0 without a
    mesh; under ``specs`` on ``mesh``, the rank's block, written by the
    first copy of it alone."""

    def __init__(self, tree: Any, specs=None, mesh=None):
        if (specs is None) != (mesh is None):
            raise ValueError("a sharded layout needs both specs= and mesh=")
        self.mesh = mesh
        self.leaves = tree_leaves(tree)
        self.specs = (spec_leaves(specs) if specs is not None
                      else [None] * len(self.leaves))
        if len(self.specs) != len(self.leaves):
            raise ValueError(f"{len(self.specs)} specs for "
                             f"{len(self.leaves)} leaves")
        if mesh is None:
            self.process, self.count = process_index(), process_count()
        else:
            self.process, self.count = mesh.rank, mesh.size

    def index(self, i: int) -> tuple:
        """Leaf ``i``'s global index range on this process."""
        shape = _shape(self.leaves[i])
        if self.mesh is None:
            return tuple(slice(0, dim) for dim in shape)
        spec = self.specs[i]
        return shard_slices(global_shape(shape, spec, self.mesh), spec,
                            self.mesh)

    def writes(self, i: int) -> bool:
        if self.mesh is None:
            return self.process == 0
        return writes_block(self.specs[i], self.mesh)

    def key(self, i: int) -> str:
        return _range_key(i, self.index(i))


def _snapshot_sharded(layout: _Layout) -> dict:
    """This process's entries: the blocks it writes, by their keys."""
    arrays = {}
    for leaf_index, leaf in enumerate(layout.leaves):
        _refuse_dtensor(leaf)
        if layout.writes(leaf_index):
            arrays[layout.key(leaf_index)] = _host(leaf)
    return arrays


def save_checkpoint_sharded(directory, step: int, tree: Any,
                            keep: Optional[int] = None, *, specs=None,
                            mesh=None) -> Path:
    """Write this process's shard of ``tree``; process 0 also writes the
    per-step manifest and the LATEST_SHARDED pointer naming the step and
    the shard-file count, which restore uses to reject partial sets.

    ``specs`` and ``mesh``: ``tree`` is this rank's blocks of a state
    sharded under the spec tree ``specs`` on ``mesh`` (every rank calls
    this); the rank's index and the mesh's size stand for the process
    index and count.

    ``keep``: retain the newest N steps (plus, always, the one just
    written); each process prunes its own old shard files, process 0 also
    the old manifests. Minimum 2: with keep=1 a worker deletes its previous
    shard the moment it writes the new one, and during the inter-worker
    sync-skew window no step would have a complete shard set."""
    _validate_sharded_keep(keep)
    layout = _Layout(tree, specs, mesh)
    arrays = _snapshot_sharded(layout)
    final, _pruned = _publish_sharded(
        Path(directory), step, arrays, layout.process, layout.count, keep)
    return final


def _validate_sharded_keep(keep: Optional[int]) -> None:
    if keep is not None and keep < 2:
        raise ValueError(
            f"sharded keep must be >= 2 (got {keep}): with 1 retained "
            "step, inter-worker sync skew leaves windows where no step "
            "has a complete shard set")


def _publish_sharded(directory: Path, step: int, arrays: dict, process: int,
                     process_count: int, keep: Optional[int],
                     protect: Iterable[int] = ()) -> tuple:
    """Serialize + atomically publish one process's shard of ``step``;
    shared by the sync and async paths, so both write the same files.
    ``protect``: steps that must survive pruning (the async writer's queued
    saves). Returns ``(final_path, pruned_paths)``."""
    directory.mkdir(parents=True, exist_ok=True)
    final = _write_npz_atomic(
        directory, f"ckpt-{step}.shard-{process}.npz", arrays)

    if process == 0:
        # A re-save of the same step after a topology shrink must not leave
        # higher-index shards that make the completeness check reject it.
        for stale in directory.glob(f"ckpt-{step}.shard-*.npz"):
            match = _SHARD_RE.match(stale.name)
            if match and int(match.group(2)) >= process_count:
                try:
                    stale.unlink()
                except OSError:
                    pass
        meta = directory / f"ckpt-{step}.meta.tmp"
        meta.write_text(json.dumps({
            "step": step, "process_count": process_count}))
        os.replace(meta, directory / f"ckpt-{step}.meta")
        pointer = directory / "LATEST_SHARDED.tmp"
        pointer.write_text(json.dumps({
            "step": step, "file": final.name,
            "process_count": process_count}))
        os.replace(pointer, directory / "LATEST_SHARDED")
    pruned = []
    if keep is not None:
        own = sorted(
            int(match.group(1)) for path in directory.iterdir()
            if (match := _SHARD_RE.match(path.name))
            and int(match.group(2)) == process)
        retained = set(own[-keep:]) | {step} | set(protect)
        for old in own:
            if old in retained:
                continue
            shard_path = directory / f"ckpt-{old}.shard-{process}.npz"
            shard_path.unlink(missing_ok=True)
            pruned.append(shard_path)
            if process == 0:
                meta_path = directory / f"ckpt-{old}.meta"
                meta_path.unlink(missing_ok=True)
                pruned.append(meta_path)
    return final, pruned


def restore_checkpoint_sharded(directory, template: Any,
                               step: Optional[int] = None, *, specs=None,
                               mesh=None) -> Any:
    """Reassemble a sharded checkpoint into ``template``'s devices and
    dtypes. With no explicit ``step``, tries steps newest to oldest and
    falls back past incomplete sets: a preemption can land mid-upload, and
    the last complete step must still restore. A step is complete when it
    holds the shard files of its own save-time topology: its manifest's
    process count, the pointer's for the pointer's step, else (a step
    saved before manifests existed) this job's.

    ``specs`` and ``mesh``: ``template`` is this rank's blocks under the
    spec tree ``specs`` on ``mesh``, and each block is read from the
    files that hold its global range, whatever mesh saved them."""
    directory = Path(directory)
    layout = _Layout(template, specs, mesh)
    if step is not None:
        return _restore_sharded_step(directory, template, step, layout)
    steps = sorted({int(m.group(1))
                    for p in (directory.iterdir()
                              if directory.is_dir() else [])
                    if (m := _SHARD_RE.match(p.name))}, reverse=True)
    if not steps:
        raise FileNotFoundError(f"no sharded checkpoint in {directory}")
    pointer = directory / "LATEST_SHARDED"
    pointer_step = pointer_count = None
    if pointer.exists():
        try:
            meta = json.loads(pointer.read_text())
            pointer_step = int(meta["step"])
            if meta.get("process_count"):
                pointer_count = int(meta["process_count"])
        except (ValueError, KeyError):
            pass
    last_error: Optional[Exception] = None
    for candidate in steps:
        indices = {int(m.group(2))
                   for p in directory.glob(f"ckpt-{candidate}.shard-*.npz")
                   if (m := _SHARD_RE.match(p.name))}
        expected = None
        manifest = directory / f"ckpt-{candidate}.meta"
        if manifest.exists():
            try:
                expected = int(json.loads(
                    manifest.read_text())["process_count"])
            except (ValueError, KeyError, TypeError):
                pass
        if expected is None and candidate == pointer_step:
            expected = pointer_count
        if expected is None:
            expected = layout.count
        if not indices or indices != set(range(expected)):
            last_error = FileNotFoundError(
                f"step {candidate}: shard indices {sorted(indices)} != "
                f"expected 0..{expected - 1}")
            continue
        try:
            return _restore_sharded_step(directory, template, candidate,
                                         layout)
        except Exception as error:  # torn file (BadZipFile), missing entry…
            last_error = error
    raise FileNotFoundError(
        f"no complete sharded checkpoint in {directory} "
        f"(tried steps {steps}): {last_error}")


def _parse_range(key: str) -> tuple:
    """A key's global index range as (start, stop) pairs."""
    ranges = key.split("|", 1)[1]
    return tuple(tuple(int(x) for x in part.split(":"))
                 for part in ranges.split(",") if part)


def _assemble(want: tuple, pieces: list, key: str, step: int):
    """The block at ``want`` (slices) cut and pasted from the ``pieces``
    ((ranges, loader)) that overlap it; every element must be covered."""
    shape = tuple(s.stop - s.start for s in want)
    out, covered = None, 0
    for ranges, load in pieces:
        if len(ranges) != len(want):
            raise ValueError(f"{key}: a {len(ranges)}-d piece of a "
                             f"{len(want)}-d leaf")
        cut = tuple((max(a, s.start), min(b, s.stop))
                    for (a, b), s in zip(ranges, want))
        if any(lo >= hi for lo, hi in cut):
            continue
        array = load()
        if out is None:
            out = np.empty(shape, dtype=array.dtype)
        out[tuple(slice(lo - s.start, hi - s.start)
                  for (lo, hi), s in zip(cut, want))] = array[tuple(
                      slice(lo - a, hi - a)
                      for (lo, hi), (a, _) in zip(cut, ranges))]
        covered += int(np.prod([hi - lo for lo, hi in cut]))
    if out is None or covered != int(np.prod(shape)):
        raise FileNotFoundError(
            f"shard {key} missing at step {step} — incomplete checkpoint "
            f"({covered} of {int(np.prod(shape))} elements present)")
    return out


def _restore_sharded_step(directory: Path, template: Any, step: int,
                          layout: _Layout) -> Any:
    paths = sorted(directory.glob(f"ckpt-{step}.shard-*.npz"))
    handles = []
    try:
        index: dict = {}
        pieces: dict = {}
        for path in paths:
            handle = np.load(path)
            handles.append(handle)
            for key in handle.files:
                index[key] = handle
                pieces.setdefault(key.split("|", 1)[0], []).append(
                    (_parse_range(key),
                     lambda key=key, handle=handle: handle[key]))
        if not index:
            raise FileNotFoundError(f"no shard files for step {step}")
        restored = []
        for leaf_index, leaf in enumerate(layout.leaves):
            _refuse_dtensor(leaf)
            key = layout.key(leaf_index)
            if key in index:
                array = index[key][key]
            else:
                array = _assemble(layout.index(leaf_index),
                                  pieces.get(f"leaf_{leaf_index}", []), key,
                                  step)
            restored.append(_restore_leaf(array, leaf, key))
        return unflatten(template, iter(restored))
    finally:
        for handle in handles:
            handle.close()


# -- async overlapped checkpointing ---------------------------------------------
#
# The train step updates its state IN PLACE (``p.add_``, ``mu.mul_``), where
# JAX's donates its buffers, so a snapshot must be taken before save()
# returns. save() clones every CUDA leaf on the caller's stream (one pass
# over HBM) and records an event; the writer thread makes its own copy
# stream wait on that event, copies the clones into one pinned staging
# buffer, waits for the copy, releases the clones and serializes from the
# staging buffer. The train loop pays the clones alone (and, once, the
# page-locking of the staging buffer, which stalls the card's other calls
# wherever it runs); the device-to-host copy, the npz write and the publish
# overlap its next steps. A device-to-host copy of the live tensors instead
# would block the loop for the copy, or need every in-place writer of the
# state to wait on it (PERF.md §6, PR 14). Each queued save holds
# its clones on the card until the writer takes it: with ``max_pending``
# the bound, at most ``max_pending + 1`` snapshots are live.


def _pinned_buffer(nbytes: int) -> torch.Tensor:
    """``nbytes`` of page-locked host memory: plain host memory registered
    with the driver, unregistered when the tensor is collected. The caching
    host allocator behind ``pin_memory=True`` rounds a request up to its
    next power of two (2.4 GB to 4.29 GB) and keeps it for the process."""
    buffer = torch.empty(nbytes, dtype=torch.uint8)
    cudart = torch.cuda.cudart()
    torch.cuda.check_error(cudart.cudaHostRegister(buffer.data_ptr(),
                                                   nbytes, 0))
    weakref.finalize(buffer, cudart.cudaHostUnregister, buffer.data_ptr())
    return buffer


class AsyncCheckpointError(RuntimeError):
    """A background save (write or bucket upload) failed. Raised on the next
    ``save()``/``wait()``/``close()`` after the failure — async errors are
    deferred, never dropped."""


class _Snapshot:
    """One save() for the writer: the host arrays of its CPU and Python
    leaves, the clones of its CUDA leaves and the event after them."""

    def __init__(self, step: int, process: int, process_count: int):
        self.step, self.process = step, process
        self.process_count = process_count
        self.arrays: dict = {}
        self.clones: list = []           # (key, device tensor, offset)
        self.event = None
        self.staging: Optional[torch.Tensor] = None


class AsyncCheckpointer:
    """Overlapped sharded checkpointing: snapshot → background write →
    optional upload into the bucket, publishing the files
    :func:`save_checkpoint_sharded` writes (restore with
    :func:`restore_checkpoint_sharded`). One writer thread is the barrier:
    saves queue FIFO and never interleave their writes.

    ``upload_remote``: a bucket prefix for this checkpoint directory (a
    local path), or ``"auto"`` for ``$TPU_TASK_DATA_REMOTE/<directory
    relative to the workdir>`` under the worker agent (no upload outside
    one). Each published step is copied there with its source mtimes, the
    pointer last. A connection string (``:scheme:...``, an object store) is
    ROADMAP A11c and raises here, at construction.

    Failures are stored and raised, wrapped in
    :class:`AsyncCheckpointError`, on the next ``save()``/``wait()``/
    ``close()``. ``keep`` prunes as the sync path does, and a queued or
    in-flight step is never pruned."""

    def __init__(self, directory, keep: Optional[int] = None,
                 upload_remote: Optional[str] = None,
                 upload_workers: int = 4, max_pending: int = 2):
        _validate_sharded_keep(keep)
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if upload_remote == "auto":
            upload_remote = resolve_upload_remote(directory)
        self._backend = None
        if upload_remote:
            from tpu_task_torch.storage.backends import open_backend

            self._backend = open_backend(upload_remote)
        self.directory = Path(directory)
        self.keep = keep
        self.upload_remote = upload_remote
        self.upload_workers = upload_workers
        #: Bytes of the pinned staging buffer (0 until a save of CUDA
        #: leaves needs it; page-locked by the first such save).
        self.pinned_bytes = 0
        self._staging: Optional[torch.Tensor] = None
        self._copy_stream = None
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._lock = threading.Lock()
        self._inflight: set = set()
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    # -- train-loop side -----------------------------------------------------
    def save(self, step: int, tree: Any, *, specs=None, mesh=None) -> Path:
        """Snapshot ``tree`` and schedule the write; returns the path the
        writer will publish. Blocks for the snapshot (CUDA leaves: device
        clones on the current stream; CPU and Python leaves: host copies)
        and, with ``max_pending`` saves queued, until the writer takes
        one. ``specs`` and ``mesh``: ``tree`` is this rank's blocks of a
        sharded state, as in :func:`save_checkpoint_sharded`."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointer is closed")
        self._raise_pending()
        layout = _Layout(tree, specs, mesh)
        process = layout.process
        snap = _Snapshot(step, process, layout.count)
        staged = 0                       # staging bytes, 64-byte aligned
        for leaf_index, leaf in enumerate(layout.leaves):
            _refuse_dtensor(leaf)
            if not layout.writes(leaf_index):
                continue
            key = layout.key(leaf_index)
            if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
                snap.clones.append((key, leaf.detach().clone(
                    memory_format=torch.contiguous_format), staged))
                staged += -(-leaf.numel() * leaf.element_size() // 64) * 64
                continue
            if isinstance(leaf, torch.Tensor):
                array = _tensor_numpy(leaf.detach().clone())
            else:
                array = np.array(_host(leaf), copy=True)
            snap.arrays[key] = array
        if snap.clones:
            snap.event = torch.cuda.Event()
            snap.event.record(torch.cuda.current_stream(
                snap.clones[0][1].device))
            if self._staging is None or self._staging.numel() < staged:
                self._staging = None                  # free the old first
                self._staging = _pinned_buffer(staged)
                self.pinned_bytes = staged
            # The writer is serial, so the snapshots share one buffer.
            snap.staging = self._staging
        with self._lock:
            self._inflight.add(step)
        self._ensure_writer()
        self._queue.put(snap)
        return self.directory / f"ckpt-{step}.shard-{process}.npz"

    def wait(self) -> None:
        """Block until every queued save is published (and uploaded);
        re-raise any background failure."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain the queue, stop the writer, surface any pending failure."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join()
        self._staging = None
        self._raise_pending()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def _raise_pending(self) -> None:
        with self._lock:
            error, self._error = self._error, None
        if error is not None:
            raise AsyncCheckpointError(
                f"background checkpoint save failed: {error}") from error

    # -- writer side ---------------------------------------------------------
    def _ensure_writer(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer, name="async-checkpoint-writer",
                daemon=True)
            self._thread.start()

    def _writer(self) -> None:
        while True:
            snap = self._queue.get()
            if snap is None:
                self._queue.task_done()
                return
            try:
                if snap.clones:
                    self._copy_out(snap)
                with self._lock:
                    protect = frozenset(self._inflight - {snap.step})
                final, pruned = _publish_sharded(
                    self.directory, snap.step, snap.arrays, snap.process,
                    snap.process_count, self.keep, protect=protect)
                if self._backend is not None:
                    self._upload_step(snap.step, final, snap.process, pruned)
            except BaseException as error:
                with self._lock:
                    if self._error is None:  # first failure wins
                        self._error = error
            finally:
                snap.clones.clear()
                with self._lock:
                    self._inflight.discard(snap.step)
                self._queue.task_done()

    def _copy_out(self, snap: _Snapshot) -> None:
        """The snapshot's clones into its staging buffer on the writer's
        copy stream, after the snapshot's event; their host arrays are
        views of the buffer, which the next snapshot reuses once this one
        is published."""
        device = snap.clones[0][1].device
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        stream = self._copy_stream
        views = []
        with torch.cuda.stream(stream):
            stream.wait_event(snap.event)
            for key, clone, start in snap.clones:
                nbytes = clone.numel() * clone.element_size()
                view = snap.staging[start:start + nbytes].view(
                    clone.dtype).view(clone.shape)
                view.copy_(clone, non_blocking=True)
                # The clone's memory may go back to the caching allocator
                # only after this stream's copy has read it.
                clone.record_stream(stream)
                views.append((key, view))
        stream.synchronize()
        snap.clones.clear()
        for key, view in views:
            snap.arrays[key] = _tensor_numpy(view)

    def _upload_step(self, step: int, final: Path, process: int,
                     pruned: list) -> None:
        """The step's shard file (+ manifest) into the bucket prefix, the
        pointer strictly LAST, so a remote reader never sees LATEST_SHARDED
        name a step whose files have not landed. Pruned steps are deleted
        remotely best-effort (the agent's mirror sync also reaps them)."""
        backend = self._backend

        def push(name: str) -> None:
            path = self.directory / name
            backend.write_from_file(name, str(path))
            # Preserved mtimes let the agent's size+mtime diff skip files
            # this pipeline already pushed.
            backend.set_mtime(name, os.path.getmtime(path))

        names = [final.name]
        if process == 0 and (self.directory / f"ckpt-{step}.meta").exists():
            names.append(f"ckpt-{step}.meta")
        workers = max(1, min(self.upload_workers, len(names)))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(push, names))
        if process == 0 and (self.directory / "LATEST_SHARDED").exists():
            push("LATEST_SHARDED")
        for path in pruned:
            try:
                backend.delete(path.name)
            except OSError:
                pass  # mirror sync reaps leftovers; never fail a save on this


def resolve_upload_remote(directory) -> Optional[str]:
    """Bucket prefix for direct upload under the worker agent:
    ``$TPU_TASK_DATA_REMOTE/<directory relative to the workdir>`` — the
    agent runs the task with cwd=workdir and mirrors the workdir to
    ``<remote>/data``, so the prefix is the mirror's relative path. None
    outside an agent, and None for directories outside the workdir (the
    mirror never ships those)."""
    root = os.environ.get("TPU_TASK_DATA_REMOTE", "")
    if not root:
        return None
    relative = os.path.relpath(os.path.abspath(directory), os.getcwd())
    if relative.split(os.sep, 1)[0] == os.pardir:
        return None
    return f"{root.rstrip('/')}/{relative.replace(os.sep, '/')}"
