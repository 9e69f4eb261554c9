"""The port's host KV tier (``tpu_task_torch/ml/serving/offload.py``) and
its demotion and promotion codec (``cache.BlockStaging``,
``cache.write_block_payloads``) against the JAX package's, on the CPU.

``HostKvTier``: both packages' tiers run one seeded sequence of ``put``,
``get`` and ``chain_depth`` calls over a small budget, with no sink, a
recording sink and a sink that raises ``OSError``, and agree after every
call: the answer, the LRU order, the spilled batches and ``stats()``.

The codec: pools of the ``micro`` preset's geometry filled with seeded
values, fp32, bf16, int8 and int4 (and fp8 where this torch build has
it). A batched staging of several blocks gives, block for block, JAX's
``export_block_bytes`` of the same pool contents; the payloads go through
a tier and back into a fresh pool of either package byte for byte; and a
pool written after the staging does not change what it read."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import cache as jcache
from tpu_task.ml.serving.offload import HostKvTier as JaxHostKvTier
from tpu_task_torch.ml.serving import cache as tcache
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.offload import HostKvTier
from torch_port_util import CPU, jax_model, port_config

# -- HostKvTier ---------------------------------------------------------------


def _ops(seed: int, n: int = 120):
    """A seeded sequence of tier calls over 10 hashes."""
    rng = np.random.default_rng(seed)
    keys = [bytes([i]) * 4 for i in range(10)]
    out = []
    for _ in range(n):
        kind = rng.choice(["put", "put", "get", "depth"])
        if kind == "depth":
            out.append(("depth", [keys[int(i)] for i in
                                  rng.integers(0, 10, size=4)]))
        else:
            h = keys[int(rng.integers(0, 10))]
            out.append((kind, h, h + bytes([int(rng.integers(0, 256))])
                        * int(rng.integers(1, 6))))
    return out


class _Sink:
    """A spill sink recording each batch; ``fail`` raises OSError on every
    other call (the bucket's outage)."""

    def __init__(self, fail: bool):
        self.fail, self.calls, self.batches = fail, 0, []

    def __call__(self, batch):
        self.calls += 1
        if self.fail and self.calls % 2:
            raise OSError("bucket down")
        self.batches.append(list(batch))


@pytest.mark.parametrize("sink", ["none", "recording", "raising"])
@pytest.mark.parametrize("budget,seed", [(1, 0), (3, 1), (4, 2), (16, 3)])
def test_host_tier_matches_jax_after_every_call(sink, budget, seed):
    sinks = [None if sink == "none" else _Sink(sink == "raising")
             for _ in range(2)]
    port = HostKvTier(budget, spill=sinks[0])
    ref = JaxHostKvTier(budget, spill=sinks[1])
    for op in _ops(seed):
        if op[0] == "put":
            got = (port.put(op[1], op[2]), ref.put(op[1], op[2]))
        elif op[0] == "get":
            got = (port.get(op[1]), ref.get(op[1]))
        else:
            got = (port.chain_depth(op[1]), ref.chain_depth(op[1]))
        assert got[0] == got[1], op
        assert list(port._entries.items()) == list(ref._entries.items())
        assert port.stats() == ref.stats()
        assert len(port) == len(ref) <= budget
        assert port.resident_bytes == ref.resident_bytes
        if sinks[0] is not None:
            assert sinks[0].batches == sinks[1].batches
    stats = port.stats()
    if sink == "none" and budget < 10:
        assert stats["dropped_blocks"] > 0 == stats["spilled_blocks"]
    if sink == "recording" and budget < 10:
        assert stats["spilled_blocks"] > 0 == stats["dropped_blocks"]
    if sink == "raising" and budget < 10:
        assert stats["spilled_blocks"] > 0 and stats["dropped_blocks"] > 0
    assert stats["hits"] > 0 and stats["misses"] > 0


def test_host_tier_refuses_an_empty_budget_as_jax():
    messages = []
    for tier in (HostKvTier, JaxHostKvTier):
        with pytest.raises(ValueError) as info:
            tier(0)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_host_tier_get_touches_and_chain_depth_does_not():
    spilled = []
    tier = HostKvTier(2, spill=spilled.extend)
    tier.put(b"a", b"pa")
    tier.put(b"b", b"pb")
    assert tier.chain_depth([b"a", b"b", b"c"]) == 2    # no touch
    assert tier.get(b"a") == b"pa"                      # touch: b is LRU
    tier.put(b"c", b"pc")
    assert spilled == [(b"b", b"pb")] and b"b" not in tier
    assert tier.chain_depth([b"a", b"zz", b"c"]) == 1   # stops at a hole
    assert tier.get(b"a") == b"pa" and len(tier) == 2


# -- the codec: demote → tier → promote ---------------------------------------

DTYPES = [("fp32", None), ("bf16", None), ("int8", "int8"),
          ("int4", "int4"), ("fp8", "fp8")]
BLOCKS = [5, 1, 6, 3]
KNOBS = dict(slots=2, block_size=4, n_blocks=8, max_len=16)


def _jax_cfg(name: str):
    jcfg, _ = jax_model("micro")
    if name == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    return jcfg


def _filled(name: str, kv_dtype):
    """(JAX pools, port pools, port cfg, port scfg) of the micro geometry
    with seeded values in every block, equal byte for byte."""
    if kv_dtype == "fp8" and not (tcache.fp8_supported()
                                  and jcache.fp8_supported()):
        pytest.skip("this build stores no float8 e4m3")
    jpools = jcache.init_pools(_jax_cfg(name),
                               JaxServingConfig(**KNOBS, kv_dtype=kv_dtype))
    rng = np.random.default_rng(3)
    filled = []
    for layer in jpools:
        out = {}
        for leaf, arr in layer.items():
            vals = rng.standard_normal(arr.shape).astype(np.float32)
            if leaf.endswith("_scale"):
                vals = np.abs(vals) + 0.01
            elif kv_dtype in ("int8", "int4"):
                vals = vals * 40.0
            out[leaf] = jnp.asarray(vals).astype(arr.dtype)
        filled.append(out)
    cfg = port_config(_jax_cfg(name),
                      torch.bfloat16 if name == "bf16" else torch.float32)
    scfg = ServingConfig(**KNOBS, kv_dtype=kv_dtype)
    pools = tcache.init_pools(cfg, scfg, CPU)
    for jlayer, layer in zip(filled, pools):
        for leaf, arr in layer.items():
            raw = np.array(jlayer[leaf]).view(np.uint8)    # writable copy
            arr.view(torch.uint8).copy_(torch.from_numpy(
                raw.reshape(arr.view(torch.uint8).shape)))
    return filled, pools, cfg, scfg


@pytest.mark.parametrize("name,kv_dtype", DTYPES, ids=[d[0] for d in DTYPES])
def test_batched_staging_equals_jax_export(name, kv_dtype):
    jpools, pools, cfg, scfg = _filled(name, kv_dtype)
    staging = tcache.BlockStaging(pools, BLOCKS)
    # One gather a leaf, after the block ids' upload (no copy out on the
    # CPU).
    assert staging.launches == 1 + sum(len(layer) for layer in pools)
    for i, block in enumerate(BLOCKS):
        want = jcache.export_block_bytes(jpools, block)
        assert staging.payload(i) == want
        assert tcache.export_block_bytes(pools, block) == want
        assert len(want) == tcache.block_payload_nbytes(cfg, scfg)


@pytest.mark.parametrize("name,kv_dtype", DTYPES, ids=[d[0] for d in DTYPES])
def test_demote_tier_promote_is_byte_identical(name, kv_dtype):
    """Staged payloads through a tier into fresh pools of both packages:
    every promoted block exports JAX's bytes of the block it came from."""
    jpools, pools, cfg, scfg = _filled(name, kv_dtype)
    staging = tcache.BlockStaging(pools, BLOCKS)
    tier = HostKvTier(len(BLOCKS))
    for i, block in enumerate(BLOCKS):
        tier.put(bytes([block]), staging.payload(i))
    promoted = [tier.get(bytes([block])) for block in BLOCKS]
    dsts = [2, 7, 4, 1]
    fresh = tcache.init_pools(cfg, scfg, CPU)
    tcache.write_block_payloads(fresh, dsts, promoted)
    jcfg = _jax_cfg(name)
    jscfg = JaxServingConfig(**KNOBS, kv_dtype=kv_dtype)
    jfresh = jcache.init_pools(jcfg, jscfg)
    for dst, block, payload in zip(dsts, BLOCKS, promoted):
        want = jcache.export_block_bytes(jpools, block)
        assert payload == want
        assert tcache.export_block_bytes(fresh, dst) == want
        values = jcache.split_block_bytes(payload, jcfg, jscfg)
        jfresh = jcache.write_block(
            jfresh, jnp.int32(dst),
            [{leaf: jnp.asarray(v) for leaf, v in layer.items()}
             for layer in values])
        assert jcache.export_block_bytes(jfresh, dst) == want
    # A block no promotion wrote stays as a fresh pool's.
    assert tcache.export_block_bytes(fresh, 3) == \
        tcache.export_block_bytes(tcache.init_pools(cfg, scfg, CPU), 3)


@pytest.mark.parametrize("name,kv_dtype", [("fp32", None), ("int4", "int4")],
                         ids=["fp32", "int4"])
def test_staging_holds_the_pools_as_they_were_staged(name, kv_dtype):
    """A write into the pools after the staging (a recycled block's next
    owner) does not reach the staged bytes."""
    jpools, pools, _, _ = _filled(name, kv_dtype)
    staging = tcache.BlockStaging(pools, BLOCKS[:2])
    for layer in pools:
        for arr in layer.values():
            arr.view(torch.uint8)[BLOCKS[0]] = 0
    assert staging.payload(0) == jcache.export_block_bytes(jpools, BLOCKS[0])
    assert staging.payload(1) == jcache.export_block_bytes(jpools, BLOCKS[1])
    assert tcache.export_block_bytes(pools, BLOCKS[0]) != staging.payload(0)
