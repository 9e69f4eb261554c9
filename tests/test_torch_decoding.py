"""The port's dense-cache decoding (``tpu_task_torch.ml.models.decoding``)
against the JAX package's ``generate``, at fp32 on the CPU, from the same
weights and the same raw key.

Greedy streams are token-identical; sampled streams (temperature 0.8,
top_p 0.9) are too, because the port draws the same threefry bits from the
same key. ``forward_with_cache`` raises on overflow, and ``generate`` runs
on the CPU only when asked to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.models import decoding as jdec
from tpu_task_torch.ml.models import decoding as tdec
from torch_port_util import CPU, jax_model, port_model


@pytest.fixture(scope="module", params=["micro", "tiny"])
def models(request):
    jcfg, jparams = jax_model(request.param)
    cfg, params = port_model(jcfg, jparams)
    return jcfg, jparams, cfg, params


def _prompt(cfg, batch=2, length=7, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, length)).astype(np.int32)


def test_greedy_token_identical(models):
    jcfg, jparams, cfg, params = models
    prompt = _prompt(cfg)
    want = jdec.generate(jparams, jcfg, jnp.asarray(prompt), 12)
    got = tdec.generate(params, cfg, prompt, 12, device=CPU)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("eos", [None, 3])
def test_sampled_key_identical(models, eos):
    jcfg, jparams, cfg, params = models
    prompt = _prompt(cfg, seed=1)
    key = np.array([11, 2**31 + 5], np.uint32)
    want = jdec.generate(jparams, jcfg, jnp.asarray(prompt), 10,
                         temperature=0.8, top_p=0.9, eos_token=eos,
                         rng=jnp.asarray(key))
    got = tdec.generate(params, cfg, prompt, 10, temperature=0.8, top_p=0.9,
                        eos_token=eos, rng=key, device=CPU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_top_p_filter_matches():
    logits = np.random.default_rng(4).normal(size=(3, 50)).astype(
        np.float32) * 2
    top_p = np.array([0.1, 0.9, 1.0], np.float32)
    np.testing.assert_array_equal(
        tdec._top_p_filter(torch.tensor(logits), torch.tensor(top_p)).numpy(),
        np.asarray(jdec._top_p_filter(jnp.asarray(logits),
                                      jnp.asarray(top_p))))


def test_forward_with_cache_raises_on_overflow(models):
    _, _, cfg, params = models
    caches = tdec.init_cache(cfg, 1, 8, CPU)
    tokens = torch.zeros((1, 3), dtype=torch.int64)
    tdec.forward_with_cache(params, cfg, tokens, caches, 5)   # fills 5..7
    with pytest.raises(ValueError, match="cache overflow"):
        tdec.forward_with_cache(params, cfg, tokens, caches, 6)


def test_generate_argument_checks_and_device(models):
    _, _, cfg, params = models
    prompt = _prompt(cfg)
    with pytest.raises(ValueError, match="rng"):
        tdec.generate(params, cfg, prompt, 4, temperature=0.5, device=CPU)
    with pytest.raises(ValueError, match="max_len"):
        tdec.generate(params, cfg, prompt, 4, max_len=5, device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdec.generate(params, cfg, prompt, 4)


def test_init_cache_layout(models):
    jcfg, _, cfg, _ = models
    ours = tdec.init_cache(cfg, 3, 20, CPU)
    ref = jdec.init_cache(jcfg, 3, 20)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert tuple(a["k"].shape) == b["k"].shape
        assert a["k"].dtype == torch.float32 and not a["v"].any()
