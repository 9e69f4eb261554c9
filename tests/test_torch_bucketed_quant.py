"""Bucketed prefill over quantized KV pools: the port's engine against the
JAX package's bucketed engine, at fp32 on the CPU, on the ``tiny``,
``micro`` and ``moe`` presets with int8, int4 and fp8 pools. Each
admission quantizes its prompt's blocks in one ``quantized_append`` a
layer; the wave of ``tests/torch_bucketed_util.py`` gives equal streams
(greedy token for token, sampled key for key) and equal ``stats()``, the
quantized block writes among them."""

import pytest

from tpu_task.ml.serving import cache as jc
from tpu_task_torch.ml.serving import cache as tc
from torch_bucketed_util import PRESETS, check_against_jax, engines, \
    preset_models


@pytest.fixture(scope="module")
def models():
    return preset_models()


@pytest.mark.parametrize("kv_dtype", ["int8", "int4", "fp8"])
@pytest.mark.parametrize("preset", PRESETS)
def test_bucketed_quantized_engine_matches_jax(models, preset, kv_dtype):
    if kv_dtype == "fp8" and not (jc.fp8_supported() and tc.fp8_supported()):
        pytest.skip("float8_e4m3fn is not supported by both packages here")
    jax_engine, port = engines(models[preset], preset,
                               {"kv_dtype": kv_dtype})
    stats = check_against_jax(jax_engine, port)
    assert stats["kv_quant"]["quantized_block_writes"] > 0
    assert stats["kv_quant"]["kv_dtype"] == kv_dtype
