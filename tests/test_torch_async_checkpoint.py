"""The port's overlapped checkpointing (``tpu_task_torch.ml.checkpoint.
AsyncCheckpointer``): the cases of ``tests/test_async_checkpoint.py`` on
the port — failure semantics, bit-identical parity with the sync path,
pruning under in-flight saves, direct upload into a bucket directory — and
the port's own: the snapshot survives the train step's in-place update, an
object-store ``upload_remote`` is refused at construction."""

import json
import threading

import numpy as np
import pytest
import torch

from tpu_task_torch.ml import checkpoint as ckpt
from tpu_task_torch.ml import train
from tpu_task_torch.ml.tree import leaves
from tpu_task_torch.ml.models import transformer


def small_tree(offset: float = 0.0):
    return {
        "w": torch.arange(16.0).reshape(4, 4) + offset,
        "b": torch.arange(4.0) + offset,
        "step_count": np.int64(7),
    }


def tree_equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(ckpt._host(x), ckpt._host(y))
        and ckpt._host(x).dtype == ckpt._host(y).dtype
        for x, y in zip(la, lb))


def test_async_save_returns_before_background_write(tmp_path, monkeypatch):
    gate = threading.Event()
    real_write = ckpt._write_npz_atomic

    def gated_write(directory, final_name, arrays):
        assert gate.wait(timeout=30), "test gate never opened"
        return real_write(directory, final_name, arrays)

    monkeypatch.setattr(ckpt, "_write_npz_atomic", gated_write)
    tree = small_tree()
    with ckpt.AsyncCheckpointer(tmp_path) as cp:
        final = cp.save(0, tree)
        assert not final.exists()
        assert not (tmp_path / "LATEST_SHARDED").exists()
        gate.set()
        cp.wait()
        assert final.exists()
    restored = ckpt.restore_checkpoint_sharded(tmp_path, small_tree(99.0))
    assert tree_equal(restored, tree)


def test_async_snapshot_decouples_from_source_mutation(tmp_path):
    host = np.arange(8.0)
    tensor = torch.arange(8.0)
    with ckpt.AsyncCheckpointer(tmp_path) as cp:
        cp.save(0, {"w": host, "t": tensor})
        host += 1000.0
        tensor += 1000.0
        cp.wait()
    restored = ckpt.restore_checkpoint_sharded(
        tmp_path, {"w": np.zeros(8), "t": torch.zeros(8)})
    assert np.array_equal(restored["w"], np.arange(8.0))
    assert torch.equal(restored["t"], torch.arange(8.0))


def test_snapshot_survives_the_in_place_train_step(tmp_path, monkeypatch):
    """The port's step updates params and moments in place; what lands on
    disk is the state at save(), while the next steps run under the
    writer."""
    cfg = transformer.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=1, n_heads=4, d_head=8, d_ff=64,
        dtype=torch.float32)
    state = train.init_state(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    step = train.make_train_step(cfg)
    tokens = torch.randint(0, 64, (2, 17),
                           generator=torch.Generator().manual_seed(1))
    state, _ = step(state, tokens)
    expected = [ckpt._host(leaf).copy() for leaf in leaves(state)]
    gate = threading.Event()
    real_write = ckpt._write_npz_atomic

    def gated_write(directory, final_name, arrays):
        assert gate.wait(timeout=30)
        return real_write(directory, final_name, arrays)

    monkeypatch.setattr(ckpt, "_write_npz_atomic", gated_write)
    with ckpt.AsyncCheckpointer(tmp_path) as cp:
        cp.save(state.step, state)
        for _ in range(2):
            state, _ = step(state, tokens)
        gate.set()
    template = train.init_state(torch.Generator().manual_seed(5), cfg,
                                device="cpu")
    restored = ckpt.restore_checkpoint_sharded(tmp_path, template)
    assert restored.step == 1 and state.step == 3
    for want, got in zip(expected, leaves(restored)):
        np.testing.assert_array_equal(ckpt._host(got), want)


def test_background_failure_surfaces_on_next_save_and_wait(tmp_path,
                                                           monkeypatch):
    calls = {"n": 0}
    real_write = ckpt._write_npz_atomic

    def failing_once(directory, final_name, arrays):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("disk full")
        return real_write(directory, final_name, arrays)

    monkeypatch.setattr(ckpt, "_write_npz_atomic", failing_once)
    cp = ckpt.AsyncCheckpointer(tmp_path)
    cp.save(0, small_tree())
    with pytest.raises(ckpt.AsyncCheckpointError, match="disk full"):
        cp.wait()
    cp.save(1, small_tree(1.0))
    cp.wait()
    cp.close()
    restored = ckpt.restore_checkpoint_sharded(tmp_path, small_tree())
    assert tree_equal(restored, small_tree(1.0))


def test_background_failure_surfaces_on_next_save_call(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(
        ckpt, "_write_npz_atomic",
        lambda *a, **k: (_ for _ in ()).throw(OSError("boom")))
    cp = ckpt.AsyncCheckpointer(tmp_path)
    cp.save(0, small_tree())
    cp._queue.join()
    with pytest.raises(ckpt.AsyncCheckpointError, match="boom"):
        cp.save(1, small_tree())


def test_close_surfaces_pending_failure(tmp_path, monkeypatch):
    monkeypatch.setattr(
        ckpt, "_write_npz_atomic",
        lambda *a, **k: (_ for _ in ()).throw(OSError("late")))
    cp = ckpt.AsyncCheckpointer(tmp_path)
    cp.save(0, small_tree())
    with pytest.raises(ckpt.AsyncCheckpointError, match="late"):
        cp.close()
    with pytest.raises(RuntimeError, match="closed"):
        cp.save(1, small_tree())


def test_interrupted_async_save_preserves_previous_step(tmp_path):
    good = small_tree()
    with ckpt.AsyncCheckpointer(tmp_path) as cp:
        cp.save(1, good)
    np.savez(tmp_path / "ckpt-2.shard-0.npz",
             **{"leaf_0|0:4": np.ones((4,))})
    (tmp_path / "ckpt-2.meta").write_text(
        json.dumps({"step": 2, "process_count": 2}))
    (tmp_path / "ckpt-3.shard-0.npz").write_bytes(b"torn-zip-garbage")
    restored = ckpt.restore_checkpoint_sharded(tmp_path, small_tree(50.0))
    assert tree_equal(restored, good)


def test_async_and_sync_saves_restore_bit_identically(tmp_path):
    tree = small_tree(3.0)
    sync_dir, async_dir = tmp_path / "sync", tmp_path / "async"
    ckpt.save_checkpoint_sharded(sync_dir, 5, tree)
    with ckpt.AsyncCheckpointer(async_dir) as cp:
        cp.save(5, tree)
    assert sorted(p.name for p in sync_dir.iterdir()) == \
        sorted(p.name for p in async_dir.iterdir())
    assert (json.loads((sync_dir / "LATEST_SHARDED").read_text())
            == json.loads((async_dir / "LATEST_SHARDED").read_text()))
    template = small_tree(77.0)
    from_sync = ckpt.restore_checkpoint_sharded(sync_dir, template)
    from_async = ckpt.restore_checkpoint_sharded(async_dir, template)
    assert tree_equal(from_sync, from_async)
    assert tree_equal(from_sync, tree)


def test_async_keep_pruning_with_in_flight_saves(tmp_path, monkeypatch):
    release = threading.Semaphore(0)
    real_write = ckpt._write_npz_atomic

    def slow_write(directory, final_name, arrays):
        assert release.acquire(timeout=30)
        return real_write(directory, final_name, arrays)

    monkeypatch.setattr(ckpt, "_write_npz_atomic", slow_write)
    with ckpt.AsyncCheckpointer(tmp_path, keep=2, max_pending=8) as cp:
        for step in range(4):
            cp.save(step, small_tree(float(step)))
        for _ in range(4):
            release.release()
        cp.wait()
    steps = sorted(int(m.group(1)) for p in tmp_path.iterdir()
                   if (m := ckpt._SHARD_RE.match(p.name)))
    assert steps == [2, 3]
    assert sorted(p.name for p in tmp_path.glob("ckpt-*.meta")) == \
        ["ckpt-2.meta", "ckpt-3.meta"]
    restored = ckpt.restore_checkpoint_sharded(tmp_path, small_tree())
    assert tree_equal(restored, small_tree(3.0))


def test_async_keep_and_pending_validation(tmp_path):
    with pytest.raises(ValueError, match="keep must be >= 2"):
        ckpt.AsyncCheckpointer(tmp_path, keep=1)
    with pytest.raises(ValueError, match="max_pending"):
        ckpt.AsyncCheckpointer(tmp_path, max_pending=0)


def test_direct_upload_streams_to_bucket(tmp_path):
    bucket = tmp_path / "bucket" / "data" / "checkpoints"
    local = tmp_path / "checkpoints"
    with ckpt.AsyncCheckpointer(local, keep=2,
                                upload_remote=str(bucket)) as cp:
        for step in range(3):
            cp.save(step, small_tree(float(step)))
        cp.wait()
        assert sorted(p.name for p in bucket.iterdir()) == [
            "LATEST_SHARDED", "ckpt-1.meta", "ckpt-1.shard-0.npz",
            "ckpt-2.meta", "ckpt-2.shard-0.npz"]
        assert ((bucket / "LATEST_SHARDED").read_text()
                == (local / "LATEST_SHARDED").read_text())
    restored = ckpt.restore_checkpoint_sharded(bucket, small_tree())
    assert tree_equal(restored, small_tree(2.0))


def test_direct_upload_preserves_mtimes_so_sync_diff_skips(tmp_path):
    """The JAX agent's incremental sync skips what the port's pipeline
    pushed: uploaded copies carry the source mtimes."""
    from tpu_task.storage.backends import LocalBackend
    from tpu_task.storage.sync import _changed_keys

    bucket = tmp_path / "bucket"
    local = tmp_path / "checkpoints"
    with ckpt.AsyncCheckpointer(local, upload_remote=str(bucket)) as cp:
        cp.save(0, small_tree())
    src_meta = LocalBackend(str(local)).list_meta()
    dst_meta = LocalBackend(str(bucket)).list_meta()
    assert sorted(src_meta) == sorted(dst_meta)
    assert _changed_keys(sorted(src_meta), src_meta, dst_meta,
                         mtimes_preserved=True) == []


def test_upload_failure_surfaces_like_write_failure(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("file in the way")
    cp = ckpt.AsyncCheckpointer(tmp_path / "ckpts",
                                upload_remote=str(blocker / "sub"))
    cp.save(0, small_tree())
    with pytest.raises(ckpt.AsyncCheckpointError):
        cp.wait()
    cp.close()


@pytest.mark.parametrize("remote", [":s3:bucket/task/data", ":gcs:b/x",
                                    "auto"])
def test_object_store_upload_is_a11c_at_construction(tmp_path, monkeypatch,
                                                     remote):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TPU_TASK_DATA_REMOTE", ":s3:bucket/task/data")
    with pytest.raises(NotImplementedError, match="A11c"):
        ckpt.AsyncCheckpointer("checkpoints", upload_remote=remote)
    # Outside an agent, "auto" uploads nothing, as in the JAX package.
    monkeypatch.delenv("TPU_TASK_DATA_REMOTE")
    cp = ckpt.AsyncCheckpointer("checkpoints", upload_remote="auto")
    assert cp.upload_remote is None
    cp.close()


def test_resolve_upload_remote_from_agent_env(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_TASK_DATA_REMOTE", raising=False)
    assert ckpt.resolve_upload_remote("checkpoints") is None
    monkeypatch.setenv("TPU_TASK_DATA_REMOTE", "/bucket/data")
    monkeypatch.chdir(tmp_path)
    assert (ckpt.resolve_upload_remote("checkpoints")
            == "/bucket/data/checkpoints")
    assert (ckpt.resolve_upload_remote("out/ckpts")
            == "/bucket/data/out/ckpts")
    assert (ckpt.resolve_upload_remote(tmp_path / "out" / "ckpts")
            == "/bucket/data/out/ckpts")
    assert ckpt.resolve_upload_remote("/somewhere/else/ckpts") is None
    monkeypatch.setenv("TPU_TASK_DATA_REMOTE", ":s3:bucket/task/data")
    assert (ckpt.resolve_upload_remote("checkpoints")
            == ":s3:bucket/task/data/checkpoints")


def test_save_backpressure_bounds_pending_snapshots(tmp_path, monkeypatch):
    release = threading.Semaphore(0)
    real_write = ckpt._write_npz_atomic

    def gated_write(directory, final_name, arrays):
        assert release.acquire(timeout=30)
        return real_write(directory, final_name, arrays)

    monkeypatch.setattr(ckpt, "_write_npz_atomic", gated_write)
    cp = ckpt.AsyncCheckpointer(tmp_path, max_pending=1)
    cp.save(0, small_tree())
    cp.save(1, small_tree())
    third_returned = threading.Event()

    def third_save():
        cp.save(2, small_tree(2.0))
        third_returned.set()

    thread = threading.Thread(target=third_save, daemon=True)
    thread.start()
    assert not third_returned.wait(timeout=0.3)
    for _ in range(3):
        release.release()
    assert third_returned.wait(timeout=30)
    thread.join(timeout=30)
    assert not thread.is_alive()
    cp.wait()
    cp.close()
    restored = ckpt.restore_checkpoint_sharded(tmp_path, small_tree())
    assert tree_equal(restored, small_tree(2.0))
