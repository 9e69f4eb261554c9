"""The port's checkpoints (``tpu_task_torch.ml.checkpoint``) against the JAX
package's (``tpu_task/ml/checkpoint.py``): the JAX package's own cases
(``tests/test_ml_models.py``, ``tests/test_ml_parallel.py``) on the port,
and checkpoints crossing between the packages.

The cross-package cases start from a JAX ``TrainState`` after three JAX
train steps (a tiny GQA config, attention through the Pallas kernels in
interpret mode, as ``test_torch_train.py`` runs them). Either package's
file, plain or sharded, restores into the other's state equal array for
array, dtype for dtype and position for position; two more steps on each
side then agree within 2e-5 (``test_torch_train.py``'s tolerance for
parameters after AdamW steps). A bf16 leaf crosses as its bit patterns.
JAX's own restore cannot cast a bf16 leaf back (numpy has no cast from
``|V2``), so the JAX side of that case reads the file's bits directly."""

import json
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml import checkpoint as jckpt
from tpu_task.ml import train as jtrain
from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.ops.attention import _pallas_attention
from tpu_task_torch.ml import checkpoint as ckpt
from tpu_task_torch.ml import train as ttrain
from tpu_task_torch.ml.tree import leaves
from tpu_task_torch.ml.models import transformer as ttf

PARAM_ATOL = 2e-5
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_head=16,
            d_ff=128, n_kv_heads=2)
JCFG = jtf.TransformerConfig(dtype=jnp.float32, **TINY)
CFG = ttf.TransformerConfig(dtype=torch.float32, **TINY)
CPU = torch.device("cpu")


def _jax_step():
    def attn(q, k, v):
        return _pallas_attention(q, jtf.expand_kv(k, JCFG.n_heads),
                                 jtf.expand_kv(v, JCFG.n_heads), True, True)
    return jtrain.make_train_step(JCFG, attn_fn=attn, donate=False)


def _tokens(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], size=(2, 65)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_run():
    """A JAX state after three steps, and the step function."""
    step = _jax_step()
    state = jtrain.init_state(jax.random.PRNGKey(0), JCFG)
    for i in range(3):
        state, _ = step(state, jnp.asarray(_tokens(i)))
    return state, step


def _port_template():
    return ttrain.init_state(torch.Generator().manual_seed(9), CFG,
                             device="cpu")


def _assert_same_leaves(port_state, jax_state):
    """Leaf for leaf in JAX's order: shape, dtype and bits."""
    got = leaves(port_state)
    want = jax.tree.leaves(jax_state)
    assert len(got) == len(want) == 2 + 3 * (3 + 9 * CFG.n_layers)
    for i, (a, b) in enumerate(zip(got, want)):
        a = ckpt._host(a)
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


def test_train_state_flattens_to_jax_leaves(jax_run):
    jstate, _ = jax_run
    state = ttrain.state_from_jax(jax.tree.map(np.asarray, jstate), CFG,
                                  device="cpu")
    assert state.step == 3 and state.opt_state["count"] == 3
    assert isinstance(state.step, int)
    _assert_same_leaves(state, jstate)
    back = jax.tree.unflatten(jax.tree.structure(jstate),
                              jax.tree.leaves(ttrain.state_to_numpy(state)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "sharded"])
def test_jax_checkpoint_restores_into_the_port(jax_run, tmp_path, sharded):
    jstate, jstep = jax_run
    if sharded:
        jckpt.save_checkpoint_sharded(tmp_path, 3, jstate)
        state = ckpt.restore_checkpoint_sharded(tmp_path, _port_template())
    else:
        jckpt.save_checkpoint(tmp_path, 3, jstate)
        state = ckpt.restore_checkpoint(tmp_path, _port_template())
    assert isinstance(state, ttrain.TrainState)
    assert type(state.step) is int and type(state.opt_state["count"]) is int
    _assert_same_leaves(state, jstate)
    # Two more steps on each side from the same restored state.
    step = ttrain.make_train_step(CFG)
    for i in (3, 4):
        jstate, jm = jstep(jstate, jnp.asarray(_tokens(i)))
        state, m = step(state, torch.tensor(_tokens(i)))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=0, atol=1e-5)
    assert state.step == int(jstate.step) == 5
    for a, b in zip(leaves(state), jax.tree.leaves(jstate)):
        np.testing.assert_allclose(ckpt._host(a), np.asarray(b), rtol=0,
                                   atol=PARAM_ATOL)


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "sharded"])
def test_port_checkpoint_restores_into_jax(jax_run, tmp_path, sharded):
    jstate, jstep = jax_run
    state = ttrain.state_from_jax(jax.tree.map(np.asarray, jstate), CFG,
                                  device="cpu")
    template = jtrain.init_state(jax.random.PRNGKey(7), JCFG)
    if sharded:
        ckpt.save_checkpoint_sharded(tmp_path, 3, state)
        restored = jckpt.restore_checkpoint_sharded(tmp_path, template)
    else:
        ckpt.save_checkpoint(tmp_path, 3, state)
        restored = jckpt.restore_checkpoint(tmp_path, template)
    assert jax.tree.structure(restored) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    step = ttrain.make_train_step(CFG)
    for i in (3, 4):
        jstate, _ = jstep(jstate, jnp.asarray(_tokens(i)))
        restored, _ = jstep(restored, jnp.asarray(_tokens(i)))
        state, _ = step(state, torch.tensor(_tokens(i)))
    for a, b, c in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate),
                       leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_allclose(ckpt._host(c), np.asarray(a), rtol=0,
                                   atol=PARAM_ATOL)


def _npy_member(path, name: str) -> bytes:
    with zipfile.ZipFile(path) as archive:
        return archive.read(name + ".npy")


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "sharded"])
def test_bf16_leaf_crosses_bit_for_bit(tmp_path, sharded):
    """Both packages write a bf16 leaf as the same 2-byte void npy member
    (the zip around it holds timestamps, so members are compared, not
    files); the port reads either back bit for bit."""
    bits = np.random.default_rng(0).integers(
        0, 1 << 16, size=(5, 7), dtype=np.uint16)
    bits[bits & 0x7F80 == 0x7F80] = 0              # no NaN or inf patterns
    jtree = {"w": jnp.asarray(bits.view(jnp.bfloat16)), "b": jnp.arange(3.0)}
    tree = {"w": torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
            "b": torch.arange(3.0)}
    if sharded:
        jsave, tsave = jckpt.save_checkpoint_sharded, ckpt.save_checkpoint_sharded
        restore, name = ckpt.restore_checkpoint_sharded, "leaf_1|0:5,0:7"
    else:
        jsave, tsave = jckpt.save_checkpoint, ckpt.save_checkpoint
        restore, name = ckpt.restore_checkpoint, "leaf_1"
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jpath, tpath = jsave(jdir, 1, jtree), tsave(tdir, 1, tree)
    # One byte of the npy header differs: ml_dtypes' bfloat16 describes
    # itself as '<V2', numpy's 2-byte void as '|V2'; both load as |V2.
    assert _npy_member(jpath, name).replace(b"'<V2'", b"'|V2'") == \
        _npy_member(tpath, name)
    # What JAX reads of the port's file: the member's bits as bfloat16.
    with np.load(tpath) as data:
        assert data[name].dtype == np.dtype("V2")
        assert np.array_equal(data[name].view(jnp.bfloat16).view(np.uint16),
                              bits)
    template = {"w": torch.zeros((5, 7), dtype=torch.bfloat16),
                "b": torch.zeros(3)}
    for directory in (jdir, tdir):
        got = restore(directory, template)
        assert got["w"].dtype == torch.bfloat16
        assert np.array_equal(got["w"].view(torch.int16).numpy(),
                              bits.view(np.int16))
    # Bit patterns stored as uint16 read back the same way.
    (tmp_path / "u16").mkdir()
    np.savez(tmp_path / "u16" / "ckpt-2.npz", leaf_0=bits)
    got = ckpt.restore_checkpoint(tmp_path / "u16",
                                  torch.zeros((5, 7), dtype=torch.bfloat16))
    assert np.array_equal(got.view(torch.int16).numpy(), bits.view(np.int16))


# -- the JAX package's own cases, on the port -----------------------------------

def test_checkpoint_roundtrip(tmp_path):
    state = _port_template()
    ckpt.save_checkpoint(tmp_path, 3, state)
    ckpt.save_checkpoint(tmp_path, 7, state)
    assert ckpt.latest_step(tmp_path) == 7
    template = ttrain.TrainState(
        step=0, params=ttf.map_params(torch.zeros_like, state.params),
        opt_state=ttrain.make_optimizer().init(state.params))
    restored = ckpt.restore_checkpoint(tmp_path, template)
    for a, b in zip(leaves(state), leaves(restored)):
        assert type(a) is type(b)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) and b.device == CPU
        else:
            assert a == b


def test_checkpoint_latest_survives_missing_pointer(tmp_path):
    ckpt.save_checkpoint(tmp_path, 5, {"w": torch.ones(3)})
    (tmp_path / "LATEST").unlink()
    assert ckpt.latest_step(tmp_path) == 5


def test_checkpoint_keep_retains_newest_n(tmp_path):
    state = {"w": torch.arange(4.0)}
    for step in (1, 2, 3, 4, 5):
        ckpt.save_checkpoint(tmp_path, step, {"w": torch.arange(4.0) + step},
                             keep=2)
    names = sorted(p.name for p in tmp_path.glob("ckpt-*.npz"))
    assert names == ["ckpt-4.npz", "ckpt-5.npz"]
    assert ckpt.latest_step(tmp_path) == 5
    restored = ckpt.restore_checkpoint(tmp_path, state)
    assert torch.equal(restored["w"], torch.arange(4.0) + 5)
    with pytest.raises(ValueError, match="keep"):
        ckpt.save_checkpoint(tmp_path, 6, state, keep=0)
    # An out-of-order re-save keeps its own file and LATEST points at it.
    ckpt.save_checkpoint(tmp_path, 3, {"w": torch.arange(4.0) + 3}, keep=2)
    assert (tmp_path / "ckpt-3.npz").exists()
    assert ckpt.latest_step(tmp_path) == 3
    rolled = ckpt.restore_checkpoint(tmp_path, state)
    assert torch.equal(rolled["w"], torch.arange(4.0) + 3)


def test_sharded_checkpoint_keep_prunes_own_shards_and_manifests(tmp_path):
    state = {"w": torch.arange(8.0)}
    for step in (10, 20, 30):
        ckpt.save_checkpoint_sharded(tmp_path, step, state, keep=2)
    shard_names = sorted(p.name for p in tmp_path.glob("ckpt-*.shard-*.npz"))
    assert shard_names == ["ckpt-20.shard-0.npz", "ckpt-30.shard-0.npz"]
    assert sorted(p.name for p in tmp_path.glob("ckpt-*.meta")) == \
        ["ckpt-20.meta", "ckpt-30.meta"]
    restored = ckpt.restore_checkpoint_sharded(tmp_path, state)
    assert torch.equal(restored["w"], torch.arange(8.0))
    with pytest.raises(ValueError, match="keep"):
        ckpt.save_checkpoint_sharded(tmp_path, 40, state, keep=1)


def test_sharded_checkpoint_roundtrip_keeps_devices_and_dtypes(tmp_path):
    """Values equal; each leaf comes back on the template's device with its
    dtype, a Python int as an int; keys are whole leaves' index ranges."""
    state = _port_template()
    ckpt.save_checkpoint_sharded(tmp_path, 7, state)
    (path,) = tmp_path.glob("ckpt-7.shard-*.npz")
    with np.load(path) as data:
        assert "leaf_0|" in data.files                        # the step
        assert f"leaf_1|0:{CFG.vocab_size},0:{CFG.d_model}" in data.files
        assert data["leaf_0|"].dtype == np.int32
    template = _port_template()
    template = template._replace(params=ttf.map_params(
        lambda t: t.to(torch.float64), template.params))
    restored = ckpt.restore_checkpoint_sharded(tmp_path, template)
    for a, b, t in zip(leaves(state), leaves(restored),
                       leaves(template)):
        if isinstance(a, torch.Tensor):
            assert b.dtype == t.dtype and b.device == t.device
            assert torch.equal(a.to(b.dtype), b)
        else:
            assert type(b) is int and a == b


def _halve(path):
    with np.load(path) as payload:
        kept = {k: payload[k] for k in payload.files[:len(payload.files) // 2]}
    path.unlink()
    np.savez(path, **kept)


def test_sharded_checkpoint_detects_missing_shards(tmp_path):
    state = _port_template()
    path = ckpt.save_checkpoint_sharded(tmp_path, 3, state)
    _halve(path)
    with pytest.raises(FileNotFoundError, match="shard"):
        ckpt.restore_checkpoint_sharded(tmp_path, state)


def test_sharded_restore_falls_back_past_partial_newest_step(tmp_path):
    state = _port_template()
    ckpt.save_checkpoint_sharded(tmp_path, 9, state)
    _halve(ckpt.save_checkpoint_sharded(tmp_path, 10, state))
    restored = ckpt.restore_checkpoint_sharded(tmp_path, _port_template())
    for a, b in zip(leaves(state), leaves(restored)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_sharded_restore_survives_topology_change(tmp_path):
    """An older complete step saved under another process count restores:
    each step is judged by its own save-time manifest."""
    state = _port_template()
    complete = ckpt.save_checkpoint_sharded(tmp_path, 5, state)
    shutil.copy(complete, tmp_path / "ckpt-6.shard-0.npz")
    (tmp_path / "ckpt-6.meta").write_text(
        json.dumps({"step": 6, "process_count": 2}))
    (tmp_path / "LATEST_SHARDED").write_text(
        json.dumps({"step": 6, "file": "ckpt-6.shard-0.npz",
                    "process_count": 2}))
    restored = ckpt.restore_checkpoint_sharded(tmp_path, _port_template())
    for a, b in zip(leaves(state), leaves(restored)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_resave_after_topology_shrink_reaps_stale_shards(tmp_path):
    state = {"w": torch.arange(6.0)}
    (tmp_path / "ckpt-6.shard-5.npz").write_bytes(b"stale")
    ckpt.save_checkpoint_sharded(tmp_path, 6, state)
    assert not (tmp_path / "ckpt-6.shard-5.npz").exists()
    restored = ckpt.restore_checkpoint_sharded(tmp_path, state)
    assert torch.equal(restored["w"], state["w"])


def test_sharded_restore_accepts_legacy_steps_without_manifest(tmp_path):
    state = {"w": torch.arange(6.0), "n": 4}
    ckpt.save_checkpoint_sharded(tmp_path, 2, state)
    (tmp_path / "ckpt-2.meta").unlink()
    (tmp_path / "LATEST_SHARDED").unlink()
    restored = ckpt.restore_checkpoint_sharded(tmp_path, {"w": torch.zeros(6),
                                                          "n": 0})
    assert torch.equal(restored["w"], state["w"]) and restored["n"] == 4


def test_restore_refuses_a_template_of_another_shape(tmp_path):
    ckpt.save_checkpoint(tmp_path, 1, {"w": torch.ones(3), "b": None})
    with pytest.raises(ValueError, match="1 leaves, template has 2"):
        ckpt.restore_checkpoint(tmp_path, {"w": torch.ones(3),
                                           "x": torch.ones(1)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(tmp_path, {"w": torch.ones(4)})
    assert torch.equal(ckpt.restore_checkpoint(
        tmp_path, {"w": torch.zeros(3), "b": None})["w"], torch.ones(3))


def test_sharded_tensors_are_a14():
    class DTensor(torch.Tensor):
        pass

    fake = torch.Tensor._make_subclass(DTensor, torch.zeros(2))
    with pytest.raises(NotImplementedError, match="A14"):
        ckpt.save_checkpoint_sharded("unused", 1, {"w": fake})
