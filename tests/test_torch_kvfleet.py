"""The fleet KV seam of the port's serving engine against the JAX
package's, at fp32 on the CPU, on the ``micro`` and ``tiny`` presets (each
package builds the preset's weights itself; they are equal bit for bit).

The payload codec is held byte for byte: the same fingerprint and payload
length for every kv_dtype and block size, and, over the same pool
contents, the same payload bytes for every hot block. After the same wave
the two engines' pools themselves differ where the two frameworks' fp32
k/v projections round an ulp apart (``tests/test_torch_serving_micro.py``):
there the hot blocks and their order are equal, a code differs from
JAX's only where a value sits at a rounding boundary (and downstream of
it), by a step or two of the grid, and values and scales agree within the
stated tolerances.

An importing engine counts the ``kvfleet`` counters the chain predicts; a
torn, foreign or deleted object is a miss that prefills locally; a
prefetched chain warms the local cache. Blocks crossing between the two
packages' engines are in ``tests/test_torch_kvfleet_cross.py``."""

import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import cache as jcache
from tpu_task.serve.kvfleet import FleetKvClient as JaxFleetKvClient
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task.storage.backends import LocalBackend as JaxLocalBackend
from tpu_task_torch.ml.serving import cache as tcache
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.serve.kvfleet import FleetKvClient, FleetKvIndex
from tpu_task_torch.serve.replica import build_engine
from tpu_task_torch.storage.backends import LocalBackend, open_backend
from torch_kvfleet_util import (KV_DTYPES, fleet_counters, fleet_wave,
                                jax_fleet_engine, port_fleet_engine,
                                publish_all, run_wave)
from torch_port_util import CPU, port_config, serving_knobs

#: fp32 k/v values: the two frameworks' projections round an ulp apart.
POOL_ATOL = 1e-5
#: A scale is a block's amax, so it inherits that ulp.
SCALE_RTOL = 1e-6
#: Grid steps a dequantized value may stand from JAX's after the same
#: wave, in steps of the grid at the head's amax (int8 amax / 127, int4
#: amax / 7, fp8 amax / 14). A value at a rounding boundary falls on
#: either side of it by the two frameworks' ulp (one step); on fp8's 3-bit
#: mantissa such a flip in layer 0 moves later layers' values, and their
#: amax, further (found on tiny at block 4, whose first difference is one
#: fp8 code of layer 0's v at two scales an ulp apart).
MAX_STEPS = {"int8": 1, "int4": 1, "fp8": 2}
#: The share of code bytes that may differ from JAX's after the same wave
#: (tiny at block 4, fp8: 244 of 18,432, 1.3%).
MAX_OFF_GRID = {"int8": 0.01, "int4": 0.01, "fp8": 0.02}
TOP_STEP = {"int8": 1 / 127, "int4": 1 / 7, "fp8": 32 / 448}


def _to_torch(arr, dtype) -> torch.Tensor:
    """A JAX pool leaf as a torch tensor of ``dtype`` with the same bytes."""
    raw = np.ascontiguousarray(np.asarray(arr))
    return torch.from_numpy(raw.view(np.uint8).copy()).view(dtype).reshape(
        raw.shape)


# -- the payload codec ---------------------------------------------------------


@pytest.mark.parametrize("preset", ["micro", "tiny"])
@pytest.mark.parametrize("block_size", [4, 8])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_kvfleet_fingerprint_and_payload_length_equal_jax(preset, block_size,
                                                          kv_dtype):
    jb = jax_build_engine(preset)
    cfg = build_engine(preset, device="cpu").cfg
    knobs = serving_knobs(preset, block_size=block_size, kv_dtype=kv_dtype)
    jscfg, scfg = JaxServingConfig(**knobs), ServingConfig(**knobs)
    assert tcache.kv_fingerprint(cfg, scfg) == \
        jcache.kv_fingerprint(jb.cfg, jscfg)
    assert tcache.block_payload_nbytes(cfg, scfg) == \
        jcache.block_payload_nbytes(jb.cfg, jscfg)
    # Pool size, slots and chunking leave the fingerprint alone.
    other = ServingConfig(**{**knobs, "n_blocks": 17, "slots": 1,
                             "chunk_tokens": 3})
    assert tcache.kv_fingerprint(cfg, other) == \
        tcache.kv_fingerprint(cfg, scfg)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_kvfleet_fingerprint_names_the_model_dtype_as_jax(dtype):
    jcfg = jax_build_engine("micro").cfg
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": getattr(jnp, dtype)})
    cfg = port_config(jcfg, dtype=getattr(torch, dtype))
    knobs = serving_knobs("micro")
    assert tcache.kv_fingerprint(cfg, ServingConfig(**knobs)) == \
        jcache.kv_fingerprint(jcfg, JaxServingConfig(**knobs))
    assert tcache.block_payload_nbytes(cfg, ServingConfig(**knobs)) == \
        jcache.block_payload_nbytes(jcfg, JaxServingConfig(**knobs))


@pytest.mark.parametrize("preset", ["micro", "tiny"])
@pytest.mark.parametrize("block_size", [4, 8])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_kvfleet_payloads_after_the_same_wave_match_jax(preset, block_size,
                                                        kv_dtype):
    """The same greedy wave through a JAX and a port engine: the same hot
    blocks in the same order; over JAX's pool contents, the port's payload
    bytes equal JAX's for every hot block; and the port's own payloads
    hold JAX's values (fp32 within POOL_ATOL) and scales (within
    SCALE_RTOL), and codes equal to JAX's except where a value sits at a
    rounding boundary that the two frameworks' ulp apart values fall on
    either side of (and the codes that depend on it downstream): those
    stand at most MAX_STEPS steps of the grid apart and are a small share
    of the codes (MAX_OFF_GRID).
    Greedy requests only: a sampled token can part at such a tie (the
    cross-package test below meets one), and the blocks' hashes then part
    with it."""
    over = dict(block_size=block_size, kv_dtype=kv_dtype)
    jax_engine = jax_fleet_engine(preset, **over)
    port = port_fleet_engine(preset, **over)
    wave = fleet_wave(port.cfg.vocab_size, block_size, sampled=False)
    assert run_wave(port, wave) == run_wave(jax_engine, wave)
    hot = port._pcache.hot_entries()
    assert hot == jax_engine._pcache.hot_entries()
    assert len(hot) >= 6

    # The codec over the same contents: JAX's pools, read as torch.
    same = [{name: _to_torch(arr, port.pools[li][name].dtype)
             for name, arr in layer.items()}
            for li, layer in enumerate(jax_engine.pools)]
    nbytes = tcache.block_payload_nbytes(port.cfg, port.scfg)
    for _, block in hot:
        want = jcache.export_block_bytes(jax_engine.pools, block)
        assert tcache.export_block_bytes(same, block) == want
        assert len(want) == nbytes

    # After the wave: each engine's own payloads, layer by layer.
    off_grid = total = 0
    for h, block in hot:
        ours = tcache.split_block_bytes(
            tcache.export_block_bytes(port.pools, block), port.cfg,
            port.scfg)
        theirs = tcache.split_block_bytes(
            jcache.export_block_bytes(jax_engine.pools, block), port.cfg,
            port.scfg)
        for mine, ref in zip(ours, theirs):
            for name in ("k", "v"):
                if kv_dtype is None:
                    np.testing.assert_allclose(mine[name].numpy(),
                                               ref[name].numpy(), rtol=0,
                                               atol=POOL_ATOL)
                    continue
                a, b = (tcache.dequantize_blocks(
                    leaf[name][None], leaf[name + "_scale"][None])[0]
                    for leaf in (mine, ref))
                amax = torch.maximum(a.abs().amax(dim=(0, 2)),
                                     b.abs().amax(dim=(0, 2)))
                err = ((a - b).abs().amax(dim=(0, 2))
                       / (amax * TOP_STEP[kv_dtype])).max()
                assert float(err) <= MAX_STEPS[kv_dtype], (name, float(err))
                codes = [leaf[name].view(torch.uint8) for leaf in (mine, ref)]
                off_grid += int((codes[0] != codes[1]).sum())
                total += codes[0].numel()
    if kv_dtype is not None:
        assert off_grid <= total * MAX_OFF_GRID[kv_dtype]


@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
def test_kvfleet_split_and_write_round_trip(kv_dtype):
    """export → split → write into a fresh pool → export again is the same
    bytes, one block at a time, batched and straight from the payloads
    (the engine's path), and writes land in place (the
    pool tensors the micro-step graphs hold stay the same tensors). A
    payload of any other length is a miss, never an exception."""
    cfg = build_engine("micro", device="cpu").cfg
    scfg = ServingConfig(slots=2, block_size=4, n_blocks=8, max_len=16,
                         kv_dtype=kv_dtype)
    gen = torch.Generator().manual_seed(7)
    pools = tcache.init_pools(cfg, scfg, CPU)
    for layer in pools:
        for name, arr in layer.items():
            vals = torch.randn(arr.shape, generator=gen)
            layer[name].copy_(vals.abs() if name.endswith("_scale")
                              else vals.to(arr.dtype) if arr.dtype in (
                                  torch.float32, torch.float8_e4m3fn)
                              else (vals * 60).to(arr.dtype))
    payloads = {b: tcache.export_block_bytes(pools, b) for b in (3, 6)}
    fresh = tcache.init_pools(cfg, scfg, CPU)
    held = [dict(layer) for layer in fresh]
    values = tcache.split_block_bytes(payloads[3], cfg, scfg)
    tcache.write_block(fresh, 5, values)
    assert tcache.export_block_bytes(fresh, 5) == payloads[3]
    split = [tcache.split_block_bytes(payloads[b], cfg, scfg) for b in (3, 6)]
    tcache.write_blocks(fresh, [1, 2], [
        {name: torch.stack([s[li][name] for s in split]) for name in layer}
        for li, layer in enumerate(split[0])])
    assert tcache.export_block_bytes(fresh, 1) == payloads[3]
    assert tcache.export_block_bytes(fresh, 2) == payloads[6]
    # The engine's path: the payload bytes straight to the pools.
    tcache.write_block_payloads(fresh, [4, 7], [payloads[6], payloads[3]])
    assert tcache.export_block_bytes(fresh, 4) == payloads[6]
    assert tcache.export_block_bytes(fresh, 7) == payloads[3]
    assert all(fresh[li][n] is held[li][n] for li in range(len(fresh))
               for n in fresh[li])
    assert tcache.export_block_bytes(fresh, 3) == \
        tcache.export_block_bytes(tcache.init_pools(cfg, scfg, CPU), 3)
    assert tcache.split_block_bytes(payloads[3][:-1], cfg, scfg) is None
    assert tcache.split_block_bytes(payloads[3] + b"\0", cfg, scfg) is None
    # The staged copies do not follow a later write into the pool.
    staged = tcache.stage_block_arrays(fresh, 5)
    tcache.write_block(fresh, 5, split[1])
    assert tcache.staged_block_to_bytes(staged) == payloads[3]


def test_kvfleet_payload_bytes_of_a_bf16_pool_equal_jax():
    """bf16 pools, which numpy lacks: the port exports the stored bytes,
    which equal the JAX package's export of the same values."""
    jcfg = jax_build_engine("micro").cfg
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": jnp.bfloat16})
    cfg = port_config(jcfg, dtype=torch.bfloat16)
    knobs = dict(slots=2, block_size=4, n_blocks=6, max_len=16)
    jpools = jcache.init_pools(jcfg, JaxServingConfig(**knobs))
    rng = np.random.default_rng(2)
    jpools = [{name: arr.at[2].set(jnp.asarray(
        rng.standard_normal(arr.shape[1:]), jnp.bfloat16))
        for name, arr in layer.items()} for layer in jpools]
    pools = [{name: _to_torch(arr, torch.bfloat16)
              for name, arr in layer.items()} for layer in jpools]
    want = jcache.export_block_bytes(jpools, 2)
    assert tcache.export_block_bytes(pools, 2) == want
    assert len(want) == tcache.block_payload_nbytes(
        cfg, ServingConfig(**knobs))


# -- the bucket and the index --------------------------------------------------


def test_kvfleet_index_merges_shards_and_reads_conditionally(tmp_path):
    """JAX's index pin on the port's index and bucket: two publishers'
    shards merge, a chain stops at a hole, an unchanged shard is not
    re-read, a deleted shard drops out, and a stale entry (object gone)
    is a fetch miss."""
    backend = LocalBackend(str(tmp_path))
    index_a = FleetKvIndex(backend, namespace="kvfleet/x",
                           refresh_interval=0.0)
    index_a.publish("ra", {"aa": 3, "bb": 3})
    index_b = FleetKvIndex(backend, namespace="kvfleet/x",
                           refresh_interval=0.0)
    index_b.publish("rb", {"cc": 3})
    index_b.refresh(force=True)
    assert "aa" in index_b and "bb" in index_b and "cc" in index_b
    assert index_b.source_of("aa") == "ra"
    assert index_b.chain_depth(["aa", "bb", "cc"]) == 3
    assert index_b.chain_depth(["aa", "zz", "cc"]) == 1
    reads = []
    inner = backend.read_conditional

    def counted(key, validator=None):
        data, v = inner(key, validator)
        reads.append(isinstance(data, bytes))
        return data, v

    backend.read_conditional = counted
    index_b.refresh(force=True)
    assert reads == [False, False]        # both shards answered unchanged
    assert index_b.chain_depth(["aa", "bb", "cc"]) == 3
    backend.delete("kvfleet/x/index/ra.json")
    index_b.refresh(force=True)
    assert "aa" not in index_b and "cc" in index_b

    cfg = build_engine("micro", device="cpu").cfg
    client = FleetKvClient(backend, "rc", refresh_interval=0.0)
    client.bind(cfg, ServingConfig(slots=2, block_size=4, n_blocks=8,
                                   max_len=16))
    client.index.publish("rc", {"dd" * 16: 1})
    assert client.fetch(bytes.fromhex("dd" * 16)) is None
    assert client.fetch_misses == 1


def test_kvfleet_port_client_reads_through_the_jax_backend(tmp_path):
    """The port's client over the JAX package's ``LocalBackend``: its
    not-modified sentinel reads as unchanged and its missing-object error
    (not an OSError) as a miss."""
    jb = JaxLocalBackend(str(tmp_path))
    index = FleetKvIndex(jb, namespace="kvfleet/y", refresh_interval=0.0)
    FleetKvIndex(LocalBackend(str(tmp_path)), namespace="kvfleet/y",
                 refresh_interval=0.0).publish("ra", {"aa": 1})
    index.refresh(force=True)
    index.refresh(force=True)
    assert "aa" in index and len(index) == 1
    client = FleetKvClient(jb, "rb", refresh_interval=0.0)
    client.bind(build_engine("micro", device="cpu").cfg,
                ServingConfig(**serving_knobs("micro")))
    assert client.fetch(bytes(16)) is None and client.fetch_misses == 1


def test_kvfleet_backend_layout_and_refusals(tmp_path):
    backend = open_backend(str(tmp_path))
    assert backend.write_if_absent("a/b/c", b"1")
    assert not backend.write_if_absent("a/b/c", b"2")
    assert backend.read("a/b/c") == b"1"
    assert backend.list("a/") == ["a/b/c"]
    assert JaxLocalBackend(str(tmp_path)).read("a/b/c") == b"1"
    with pytest.raises(ValueError, match="escapes"):
        backend.read("../x")
    with pytest.raises(FileNotFoundError):
        backend.read("a/missing")
    with pytest.raises(NotImplementedError, match="A11c"):
        open_backend(":googlecloudstorage:bucket/kv")


def test_kvfleet_needs_the_prefix_cache():
    client = FleetKvClient(LocalBackend(tempfile.mkdtemp()), "r")
    with pytest.raises(ValueError, match="prefix_cache"):
        build_engine("micro", serving={"prefix_cache": False},
                     device="cpu", kv_client=client)
    with pytest.raises(RuntimeError, match="not bound"):
        client.lookup_chain([bytes(16)])


# -- engine to engine ----------------------------------------------------------


@pytest.mark.parametrize("kind", ["torn", "foreign", "deleted"])
def test_kvfleet_bad_objects_are_misses_that_prefill(kind):
    """A torn (short), foreign (another layout's length) or deleted block
    object stops the import there; the rest of the prompt prefills
    locally and the stream is unchanged."""
    tmp = tempfile.mkdtemp()
    backend = LocalBackend(tmp)
    pub = FleetKvClient(backend, "pub", refresh_interval=0.0)
    first = port_fleet_engine("micro", pub)
    prompt = np.arange(1, 23, dtype=np.int32)         # five full blocks
    want = run_wave(first, [(prompt, 8, {})])
    publish_all(pub, first)
    hashes = tcache.chain_block_hashes(prompt, 4)
    key = pub.index.block_key(hashes[2].hex())
    path = os.path.join(tmp, key)
    if kind == "deleted":
        backend.delete(key)
    else:
        data = backend.read(key)
        with open(path, "wb") as handle:
            handle.write(data[:-3] if kind == "torn" else data * 2)
    client = FleetKvClient(backend, "b", refresh_interval=0.0)
    engine = port_fleet_engine("micro", client)
    assert run_wave(engine, [(prompt, 8, {})]) == want
    assert fleet_counters(engine) == dict(
        hit_blocks=2, miss_blocks=3, import_requests=1, prefetch_blocks=0)
    assert client.fetch_misses == 1
    assert engine.stats()["prefix_cache"]["blocks_saved"] == 2


def test_kvfleet_prefetch_chain_warms_the_local_cache():
    """JAX's prefetch pin on the port: ``prefetch_chain`` of a published
    session imports ``len(hashes) - 1`` blocks (the last emitted token is
    never written back), leaves them at refcount 0, imports nothing the
    second time, and the next turn admits on local hits with the stream
    of an unshared engine."""
    tmp = tempfile.mkdtemp()
    pub = FleetKvClient(LocalBackend(tmp), "ra", refresh_interval=0.0)
    first = port_fleet_engine("micro", pub)
    prompt = np.arange(1, 17, dtype=np.int32)
    out = run_wave(first, [(prompt, 8, {})])[0]
    assert pub.publish(first) > 0
    session = np.concatenate([prompt, np.asarray(out, np.int32)])
    hashes = tcache.chain_block_hashes(session, 4)
    engine = port_fleet_engine("micro", FleetKvClient(
        LocalBackend(tmp), "rb", refresh_interval=0.0))
    imported = engine.prefetch_chain(hashes)
    assert imported == len(hashes) - 1
    assert engine.stats()["kvfleet"]["prefetch_blocks"] == imported
    assert engine.allocator.referenced == 0
    assert engine.prefetch_chain(hashes) == 0
    turn2 = np.concatenate([session, np.asarray([30, 31], np.int32)])
    got = run_wave(engine, [(turn2, 6, {})])
    assert engine.stats()["kvfleet"]["import_requests"] == 0
    assert engine.stats()["prefix_cache"]["blocks_saved"] >= imported
    assert got == run_wave(jax_fleet_engine("micro"), [(turn2, 6, {})])
    # JAX's engine prefetches the same chain from the same bucket.
    jax_engine = jax_fleet_engine("micro", JaxFleetKvClient(
        JaxLocalBackend(tmp), "rc", refresh_interval=0.0))
    assert jax_engine.prefetch_chain(hashes) == imported


def test_kvfleet_index_shard_body_is_jax_json(tmp_path):
    """The port's shard is the JSON object JAX writes (sorted keys, hash
    hex → payload bytes), under the same key, so each package's index
    reads the other's."""
    pub = FleetKvClient(LocalBackend(str(tmp_path)), "ra",
                        refresh_interval=0.0)
    first = port_fleet_engine("micro", pub)
    run_wave(first, [(np.arange(1, 11, dtype=np.int32), 4, {})])
    assert publish_all(pub, first) == 3
    key = f"{pub.index.namespace}/index/ra.json"
    body = (tmp_path / key).read_bytes()
    assert body == json.dumps(pub._published, sort_keys=True).encode()
    jax_client = JaxFleetKvClient(JaxLocalBackend(str(tmp_path)), "x",
                                  refresh_interval=0.0)
    jax_client.bind(jax_build_engine("micro").cfg,
                    JaxServingConfig(**serving_knobs("micro")))
    assert jax_client.index.namespace == pub.index.namespace
    assert jax_client.lookup_chain(
        [bytes.fromhex(h) for h in pub._published]) == 3
