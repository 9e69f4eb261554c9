"""The port's input pipeline (``tpu_task_torch.ml.data``) against the JAX
package's (``tpu_task/ml/data.py``): ``epoch_batches`` yields the same
batches for the same seed, process slice and ``start_step``;
``prefetch_to_device`` keeps order, handles short iterators and places a
mesh rank's rows of each global batch."""

import itertools

import numpy as np
import pytest
import torch

from tpu_task.ml import data as jdata
from tpu_task_torch.ml import data
from tpu_task_torch.ml.parallel.mesh import Mesh


@pytest.mark.parametrize("n,batch,procs", [(37, 8, 1), (64, 16, 4),
                                           (50, 12, 3), (16, 16, 2)])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("start_step", [0, 1, 5, 13])
def test_epoch_batches_match_jax(n, batch, procs, seed, start_step):
    indices = np.arange(n) * 10
    labels = np.arange(n)
    for rank in range(procs):
        kw = dict(seed=seed, epochs=4, process_index=rank,
                  process_count=procs, start_step=start_step)
        want = list(jdata.epoch_batches(indices, labels, batch, **kw))
        got = list(data.epoch_batches(indices, labels, batch, **kw))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    endless = data.epoch_batches(indices, None, batch, seed=seed,
                                 process_index=0, process_count=1,
                                 start_step=start_step)
    jendless = jdata.epoch_batches(indices, None, batch, seed=seed,
                                   process_index=0, process_count=1,
                                   start_step=start_step)
    for a, b in zip(itertools.islice(endless, 20),
                    itertools.islice(jendless, 20)):
        np.testing.assert_array_equal(a, b)


def test_epoch_batches_resume_continues_the_sequence():
    x = np.arange(40)
    full = list(data.epoch_batches(x, None, 8, seed=3, epochs=3,
                                   process_index=0, process_count=1))
    for start in range(len(full) + 1):
        tail = list(data.epoch_batches(x, None, 8, seed=3, epochs=3,
                                       process_index=0, process_count=1,
                                       start_step=start))
        assert [b.tolist() for b in tail] == [b.tolist() for b in full[start:]]


def test_epoch_batches_defaults_and_refusals():
    x = np.arange(20)
    # No process group: process 0 of 1, the whole global batch.
    (first,) = itertools.islice(data.epoch_batches(x, None, 4, seed=1), 1)
    assert len(first) == 4
    with pytest.raises(ValueError, match="dataset size"):
        next(data.epoch_batches(x, None, 21))
    with pytest.raises(ValueError, match="divisible"):
        next(data.epoch_batches(x, None, 5, process_index=0, process_count=2))
    with pytest.raises(ValueError, match="out of range"):
        next(data.epoch_batches(x, None, 4, process_index=2, process_count=2))
    with pytest.raises(ValueError, match="start_step"):
        next(data.epoch_batches(x, None, 4, start_step=-1))


@pytest.mark.parametrize("depth", [1, 2, 5])
@pytest.mark.parametrize("count", [0, 1, 3, 9])
def test_prefetch_to_device_keeps_order(depth, count):
    batches = [(np.full((2, 3), i, np.float32), np.arange(2) + i)
               for i in range(count)]
    got = list(data.prefetch_to_device(iter(batches), device="cpu",
                                       depth=depth))
    assert len(got) == count
    for i, (x, y) in enumerate(got):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((2, 3), float(i)))
        assert torch.equal(y, torch.arange(2) + i)


def test_prefetch_to_device_stays_depth_ahead():
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield {"x": np.array([i])}

    stream = data.prefetch_to_device(source(), device="cpu", depth=2)
    assert pulled == []                          # nothing before the first
    first = next(stream)
    assert first["x"].tolist() == [0] and pulled == [0, 1, 2]
    assert [b["x"].item() for b in stream] == [1, 2, 3, 4, 5]


def test_prefetch_to_device_refusals(monkeypatch):
    with pytest.raises(ValueError, match="depth"):
        next(data.prefetch_to_device(iter([np.zeros(1)]), device="cpu",
                                     depth=0))
    with pytest.raises(NotImplementedError, match="a device or a mesh"):
        next(data.prefetch_to_device(iter([np.zeros(1)]), device=object()))
    # The mesh counterpart of JAX's batch sharding: this rank's rows of
    # each global batch (the piece over the batch axes; tp shares it).
    batch = {"x": np.arange(8), "y": np.arange(16).reshape(8, 2)}
    for rank, rows in ((0, [0, 1]), (1, [0, 1]), (6, [6, 7])):
        mesh = Mesh((2, 2, 2), ("dp", "fsdp", "tp"), rank=rank)
        got = next(data.prefetch_to_device(iter([batch]), device=mesh))
        assert got["x"].tolist() == rows
        assert got["y"].tolist() == batch["y"][rows].tolist()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(data.prefetch_to_device(iter([np.zeros(1)])))

