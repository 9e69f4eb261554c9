"""The port's serving engine with bucketed prefill (``ServingConfig(
prefill="bucketed")``) against the JAX package's bucketed engine, at fp32
on the CPU, from the same weights and base key.

One wave (``tests/torch_bucketed_util.py``) runs through both packages on
the ``tiny``, ``micro`` and ``moe`` presets: more requests than slots, so
admissions wait for a retirement, greedy and keyed-sampled streams,
prompts of one token, of a whole bucket and between, and a request whose
one new token finishes it at admission. Each at K 1 and 4, at ``spec_k`` 2
with the model as its own draft, and on a pool small enough that running
slots preempt each other (a preempted request is admitted again with its
prompt and tokens in one bucket). Greedy streams are equal token for
token, sampled ones key for key, and every value both ``stats()`` compute
is equal. Every slot decoded from its admission's first token: no chunk
step ran. The quantized pools are ``tests/test_torch_bucketed_quant.py``."""

import pytest

from torch_bucketed_util import PRESETS, check_against_jax, engines, \
    preset_models

ROUTES = {"k1": {}, "k4": {"micro_k": 4}, "spec2": {"spec_k": 2}}
#: The tight pool per preset: small enough that running slots preempt
#: each other in the wave.
TIGHT_BLOCKS = {"tiny": 22, "micro": 20, "moe": 20}


@pytest.fixture(scope="module")
def models():
    return preset_models()


@pytest.mark.parametrize("route", sorted(ROUTES) + ["tight_pool"])
@pytest.mark.parametrize("preset", PRESETS)
def test_bucketed_engine_matches_jax(models, preset, route):
    over = (dict(n_blocks=TIGHT_BLOCKS[preset]) if route == "tight_pool"
            else ROUTES[route])
    stats = check_against_jax(*engines(models[preset], preset, over))
    if route == "k4":
        assert stats["micro_steps"] > 0
    if route == "spec2":
        assert stats["spec"]["proposed"] > 0
    if route == "tight_pool":
        assert stats["recompute_preemptions"] > 0
