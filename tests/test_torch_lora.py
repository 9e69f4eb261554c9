"""The port's LoRA helpers (``tpu_task_torch/ml/serving/lora.py``) against
the JAX package's (``tpu_task/ml/serving/lora.py``): packing, payload
bytes and content hashes equal byte for byte (a fleet bucket and a router
hold both packages to one hash), ``apply_lora`` within 1e-6 at fp32 with
scratch-block and scale-0 rows exactly 0.0, and the table helpers and
byte models equal. Also ``ServingConfig``'s LoRA knobs and messages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import lora as jlora
from tpu_task_torch.ml.serving import lora
from tpu_task_torch.ml.serving.cache import ServingConfig

D_MODEL, RANK, N_LAYERS = 32, 4, 2


def _layers(seed, rank=RANK, as_tuples=False):
    rng = np.random.default_rng(seed)
    layers = [{"a": rng.normal(size=(D_MODEL, rank)),
               "b": rng.normal(size=(rank, D_MODEL))}
              for _ in range(N_LAYERS)]
    return [(layer["a"], layer["b"]) for layer in layers] if as_tuples \
        else layers


@pytest.mark.parametrize("rank,as_tuples", [(4, False), (4, True),
                                            (2, False), (1, True)])
def test_pack_payload_and_hash_equal_jax(rank, as_tuples):
    layers = _layers(rank + 10 * as_tuples, rank, as_tuples)
    got = lora.pack_adapter(layers, RANK, D_MODEL)
    want = jlora.pack_adapter(layers, RANK, D_MODEL)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    # A smaller rank zero-pads to the pool rank.
    assert not got[:, :, rank:].any()
    for scale in (1.0, 0.5, 2.0):
        payload = lora.adapter_payload(got, scale)
        assert payload == jlora.adapter_payload(want, scale)
        assert lora.adapter_fingerprint(got, scale) == \
            jlora.adapter_fingerprint(want, scale)
        for split in (lora.split_adapter_payload,
                      jlora.split_adapter_payload):
            blocks, back = split(payload)
            assert back == scale and blocks.tobytes() == got.tobytes()
    # Scale and content are part of the identity.
    assert lora.adapter_fingerprint(got, 1.0) != \
        lora.adapter_fingerprint(got, 2.0)
    other = lora.pack_adapter(_layers(99, rank), RANK, D_MODEL)
    assert lora.adapter_fingerprint(got, 1.0) != \
        lora.adapter_fingerprint(other, 1.0)


@pytest.mark.parametrize("layers,match", [
    ([{"a": np.zeros((D_MODEL, 2)), "b": np.zeros((3, D_MODEL))}],
     "must be"),
    ([{"a": np.zeros((D_MODEL, 8)), "b": np.zeros((8, D_MODEL))}],
     "exceeds the pool rank"),
    ([{"a": np.zeros((16, 2)), "b": np.zeros((2, D_MODEL))}],
     "does not match d_model"),
    ([(np.zeros(D_MODEL), np.zeros((2, D_MODEL)))], "must be"),
])
def test_pack_adapter_errors_equal_jax(layers, match):
    messages = []
    for pack in (lora.pack_adapter, jlora.pack_adapter):
        with pytest.raises(ValueError, match=match) as info:
            pack(layers, RANK, D_MODEL)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("data", [b"", b"\x01\x00", None])
def test_split_payload_refuses_torn_bytes(data):
    if data is None:   # a payload cut short of its header's size
        data = lora.adapter_payload(
            lora.pack_adapter(_layers(3), RANK, D_MODEL), 1.0)[:-8]
    for split in (lora.split_adapter_payload, jlora.split_adapter_payload):
        with pytest.raises(ValueError):
            split(data)


@pytest.mark.parametrize("w", [1, 3])
def test_apply_lora_matches_jax(w):
    rng = np.random.default_rng(w)
    rows, n_blocks = 6, 7
    pool = rng.normal(size=(n_blocks, 2, RANK, D_MODEL)).astype(np.float32)
    pool[0] = 0.0                                    # the scratch block
    x = rng.normal(size=(rows, w, D_MODEL)).astype(np.float32)
    blocks = np.array([3, 0, 5, 1, 6, 0], np.int32)
    scales = np.array([1.5, 2.0, 0.0, 0.5, 1.0, 0.0], np.float32)
    got = lora.apply_lora(torch.from_numpy(x), torch.from_numpy(pool),
                          torch.from_numpy(blocks),
                          torch.from_numpy(scales)).numpy()
    want = np.asarray(jlora.apply_lora(jnp.asarray(x), jnp.asarray(pool),
                                       jnp.asarray(blocks),
                                       jnp.asarray(scales)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(
        want).max())
    # Scratch-block rows and scale-0 rows are exactly 0.0.
    for row in (1, 2, 5):
        assert np.array_equal(got[row], np.zeros_like(got[row]))
    # Row independence: each row alone gives its row of the batch.
    for row in range(rows):
        alone = lora.apply_lora(
            torch.from_numpy(x[row:row + 1]), torch.from_numpy(pool),
            torch.from_numpy(blocks[row:row + 1]),
            torch.from_numpy(scales[row:row + 1])).numpy()
        np.testing.assert_allclose(alone[0], got[row], rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_apply_lora_bf16_casts_the_scale_first():
    """The scale is cast to ``x.dtype`` before it multiplies the shrink:
    bf16 inputs give the bf16 products of the JAX order."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 2, D_MODEL))).to(torch.bfloat16)
    pool = torch.from_numpy(rng.normal(size=(4, 2, RANK, D_MODEL))).to(
        torch.bfloat16)
    pool[0] = 0
    blocks = torch.tensor([2, 0, 3])
    scales = torch.tensor([0.3, 1.0, 1.7])
    got = lora.apply_lora(x, pool, blocks, scales)
    ab = pool[blocks]
    shrink = torch.bmm(x, ab[:, 0].transpose(1, 2))
    want = torch.bmm(shrink * scales.to(torch.bfloat16)[:, None, None],
                     ab[:, 1])
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert not got[1].any()


def test_init_adapter_pool_equals_jax():
    got = lora.init_adapter_pool(5, RANK, D_MODEL, dtype=torch.bfloat16)
    want = jlora.init_adapter_pool(5, RANK, D_MODEL, jnp.bfloat16)
    assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16
    assert not got.any()


@pytest.mark.parametrize("n_layers,rank,d_model,itemsize", [
    (2, 4, 32, 4), (8, 16, 1024, 2), (8, 16, 1024, 4)])
def test_byte_models_equal_jax(n_layers, rank, d_model, itemsize):
    assert lora.adapter_bytes(n_layers, rank, d_model, itemsize) == \
        jlora.adapter_bytes(n_layers, rank, d_model, itemsize)
    assert lora.lora_pool_bytes(65, rank, d_model, itemsize) == \
        jlora.lora_pool_bytes(65, rank, d_model, itemsize)


def test_gather_and_validate_tables_equal_jax():
    slot_blocks = np.arange(12, dtype=np.int32).reshape(4, 3) + 1
    rows = [2, -1, 0, 0, 3, -1, 1]
    got = lora.gather_tables(slot_blocks, rows)
    assert got.dtype == np.int32
    assert np.array_equal(got, jlora.gather_tables(slot_blocks, rows))
    assert not got[1].any() and not got[5].any()
    for validate in (lora.validate_lora_tables, jlora.validate_lora_tables):
        validate(slot_blocks, 13)
        validate(np.zeros((0, 3), np.int32), 1)
        for bad in (13, -1):
            table = slot_blocks.copy()
            table[1, 2] = bad
            with pytest.raises(ValueError, match=r"out of range \[0, 13\)"):
                validate(table, 13)


@pytest.mark.parametrize("knobs", [
    dict(lora_rank=4, n_adapter_blocks=9),
    dict(lora_rank=16, n_adapter_blocks=2),
    dict(lora_rank=0, n_adapter_blocks=4),
])
def test_serving_config_accepts_lora_knobs(knobs):
    cfg = ServingConfig(**knobs)
    JaxServingConfig(**knobs)
    assert (cfg.lora_rank, cfg.n_adapter_blocks) == \
        (knobs["lora_rank"], knobs["n_adapter_blocks"])


@pytest.mark.parametrize("knobs", [
    dict(lora_rank=4, n_adapter_blocks=0),
    dict(lora_rank=4, n_adapter_blocks=1),
    dict(lora_rank=-1),
    dict(n_adapter_blocks=-2),
])
def test_serving_config_lora_errors_equal_jax(knobs):
    messages = []
    for config in (ServingConfig, JaxServingConfig):
        with pytest.raises(ValueError) as info:
            config(**knobs)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
