"""Fleet KV blocks crossing between the packages' engines, at fp32 on
the CPU, on the ``micro`` and ``tiny`` presets (``tests/test_torch_kvfleet.py``
holds the payload codec and the bucket): blocks one package publishes
import into the other's engine with the streams the publisher's bytes
give, the unshared engine's of the publishing package, which are the JAX
engine's except where a sampled token parts at a rounding tie of the two
frameworks' values. Both importers count the same ``kvfleet`` counters,
also under K-token micro-steps and speculative rounds."""

import tempfile

import pytest

from tpu_task.serve.kvfleet import FleetKvClient as JaxFleetKvClient
from tpu_task.storage.backends import LocalBackend as JaxLocalBackend
from tpu_task_torch.ml.serving import cache as tcache
from tpu_task_torch.serve.kvfleet import FleetKvClient
from tpu_task_torch.storage.backends import LocalBackend
from torch_kvfleet_util import (KV_DTYPES, expected_imports, fleet_counters,
                                fleet_wave, jax_fleet_engine,
                                port_fleet_engine, publish_all, run_wave)


@pytest.fixture(scope="module")
def unshared():
    """Each package's streams of the cross test's wave on an engine with no
    fleet client, by (package, preset, kv_dtype): the two publisher cases
    of a (preset, kv_dtype) read the same two runs."""
    runs = {}

    def streams(package, preset, kv_dtype, wave):
        key = (package, preset, kv_dtype)
        if key not in runs:
            make = jax_fleet_engine if package == "jax" else port_fleet_engine
            runs[key] = run_wave(make(preset, kv_dtype=kv_dtype), wave)
        return runs[key]

    return streams


@pytest.mark.parametrize("preset", ["micro", "tiny"])
@pytest.mark.parametrize("kv_dtype", KV_DTYPES)
@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_kvfleet_blocks_cross_between_the_packages(unshared, preset,
                                                   kv_dtype, publisher):
    """One package's engine serves a wave and publishes every hot block;
    a fresh JAX engine and a fresh port engine each import the same wave
    from that bucket. Both importers' greedy and sampled streams equal the
    publishing package's unshared streams (an import reproduces the
    publisher's bytes), and their ``kvfleet`` counters are equal and as
    the chain predicts. The two packages' unshared streams are equal too,
    except where a sampled token parts at a rounding tie of the two
    frameworks' values (on tiny at int8 one request does: an int8 code of
    layer 1's v at two scales an ulp apart); there the port's importer of
    JAX's blocks follows JAX, and JAX's importer of the port's blocks
    follows the port."""
    if kv_dtype == "fp8" and not tcache.fp8_supported():
        pytest.skip("float8_e4m3fn is not supported here")
    tmp = tempfile.mkdtemp()
    over = {"kv_dtype": kv_dtype}
    if publisher == "jax":
        pub = JaxFleetKvClient(JaxLocalBackend(tmp), "pub",
                               refresh_interval=0.0)
        first = jax_fleet_engine(preset, pub, **over)
    else:
        pub = FleetKvClient(LocalBackend(tmp), "pub", refresh_interval=0.0)
        first = port_fleet_engine(preset, pub, **over)
    bs = first.scfg.block_size
    wave = fleet_wave(first.cfg.vocab_size, bs)
    reference = unshared(publisher, preset, kv_dtype, wave)
    assert run_wave(first, wave) == reference
    assert publish_all(pub, first) == len(first._pcache.hot_entries())
    port = port_fleet_engine(preset, FleetKvClient(
        LocalBackend(tmp), "port", refresh_interval=0.0), **over)
    jax_engine = jax_fleet_engine(preset, JaxFleetKvClient(
        JaxLocalBackend(tmp), "jax", refresh_interval=0.0), **over)
    assert run_wave(port, wave) == reference
    assert run_wave(jax_engine, wave) == reference
    assert fleet_counters(port) == fleet_counters(jax_engine) == \
        expected_imports(wave, bs)
    assert port.stats()["kvfleet"]["bytes_fetched"] == \
        jax_engine.stats()["kvfleet"]["bytes_fetched"] > 0
    assert port.allocator.referenced == 0
    other = unshared("port" if publisher == "jax" else "jax", preset,
                     kv_dtype, wave)
    parted = [i for i, (a, b) in enumerate(zip(reference, other)) if a != b]
    assert all("temperature" in wave[i][2] for i in parted)
    assert parted == ([1] if (preset, kv_dtype) == ("tiny", "int8") else [])


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8", "int4"])
@pytest.mark.parametrize("path", ["micro_k4", "spec_k2"])
def test_kvfleet_import_under_micro_steps_and_spec(kv_dtype, path):
    """An importing engine at ``micro_k`` 4, or ``spec_k`` 2 with the
    target as its own draft (whose pools are never imported into: its
    catch-up re-ingests the context): streams equal the JAX engine's of
    the same configuration without a fleet, and equal counters."""
    if kv_dtype == "fp8" and not tcache.fp8_supported():
        pytest.skip("float8_e4m3fn is not supported here")
    over = {"kv_dtype": kv_dtype,
            **({"micro_k": 4} if path == "micro_k4" else {"spec_k": 2})}
    tmp = tempfile.mkdtemp()
    pub = FleetKvClient(LocalBackend(tmp), "pub", refresh_interval=0.0)
    first = port_fleet_engine("micro", pub, **over)
    wave = fleet_wave(first.cfg.vocab_size, 4)
    want = run_wave(jax_fleet_engine("micro", **over), wave)
    assert run_wave(first, wave) == want
    publish_all(pub, first)
    port = port_fleet_engine("micro", FleetKvClient(
        LocalBackend(tmp), "b", refresh_interval=0.0), **over)
    jax_engine = jax_fleet_engine("micro", JaxFleetKvClient(
        JaxLocalBackend(tmp), "c", refresh_interval=0.0), **over)
    assert run_wave(port, wave) == want
    assert run_wave(jax_engine, wave) == want
    assert fleet_counters(port) == fleet_counters(jax_engine)
    assert fleet_counters(port)["hit_blocks"] > 0
    if path == "micro_k4":
        assert port.micro_steps > 0
    else:
        assert port.spec_rounds > 0
