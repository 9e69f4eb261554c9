"""The port's serving engine (``tpu_task_torch.ml.serving``) against the JAX
package's, at fp32 on the CPU, from the same weights.

Both engines take the same submissions; the JAX one runs its XLA gather
path (``decode_impl="xla"``), the port its plain paged attention. Greedy
streams must be token-identical and sampled streams key-identical (the
port draws the same threefry bits from the same raw keys), and the
scheduler must make the same decisions: equal prefix-cache counters,
equal preemption counts, equal step counts. The port's engine also equals
the port's own dense ``generate``."""

import numpy as np
import pytest
import torch

from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.models.decoding import generate
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import DrainTimeout, ServingEngine
from tpu_task_torch.ml.ops import paged_attention as tpa
from tpu_task_torch.serve.replica import build_engine
from torch_port_util import CPU, jax_model, port_model, serving_knobs, \
    share_jax_programs

#: Counters both engines keep that say what the scheduler decided.
SCHEDULE_KEYS = ("steps", "decode_steps", "chunk_steps", "prefills",
                 "prefill_chunks", "recompute_preemptions")
PREFIX_KEYS = ("miss_blocks", "hit_requests", "tokens_saved", "blocks_saved",
               "cow_copies", "cached_blocks", "evictions")


def _engines(preset, **over):
    knobs = serving_knobs(preset, **over)
    jax_engine = share_jax_programs(jax_build_engine(preset, serving={**knobs,
                                                   "decode_impl": "xla"}))
    jcfg, jparams = jax_model(preset)
    cfg, params = port_model(jcfg, jparams)
    port_engine = ServingEngine(params, cfg, ServingConfig(**knobs),
                                rng=R.PRNGKey(0), device=CPU)
    return jax_engine, port_engine


def _run_waves(engines, waves):
    """Submit each wave of (prompt, max_new, kwargs) to every engine and
    drain it; returns each engine's {rid: tokens}."""
    outs = []
    for engine in engines:
        for wave in waves:
            for prompt, max_new, kw in wave:
                engine.submit(prompt, max_new, **kw)
            result = engine.drain(max_steps=2000)
        outs.append(result)
    return outs


def _assert_same_schedule(jax_engine, port_engine):
    js, ps = jax_engine.stats(), port_engine.stats()
    assert {k: js[k] for k in SCHEDULE_KEYS} == \
        {k: ps[k] for k in SCHEDULE_KEYS}
    assert {k: js["prefix_cache"][k] for k in PREFIX_KEYS} == \
        {k: ps["prefix_cache"][k] for k in PREFIX_KEYS}
    return ps


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lengths]


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("preset", ["micro", "tiny"])
def test_mixed_prompts_greedy_and_sampled(preset, prefix_cache):
    """Mixed prompt lengths (some longer than one chunk), greedy and
    sampled requests in one batch, sampled ones with raw router-style keys
    and with the engine's own fold_in(base, rid) keys."""
    jax_engine, port_engine = _engines(preset, prefix_cache=prefix_cache)
    vocab = port_engine.cfg.vocab_size
    ps = _prompts(vocab, (3, 21, 9, 1, 14, 6))
    wave = [(ps[0], 9, {}), (ps[1], 6, {}), (ps[2], 8, {"eos_token": 5}),
            (ps[3], 7, {"temperature": 0.8, "top_p": 0.9,
                        "key": np.array([7, 2**32 - 3], np.uint32)}),
            (ps[4], 8, {"temperature": 1.1}),
            (ps[5], 10, {"temperature": 0.8, "top_p": 0.9,
                         "key": [123, 456]}),
            (ps[1], 5, {})]
    want, got = _run_waves([jax_engine, port_engine], [wave])
    assert got == want
    stats = _assert_same_schedule(jax_engine, port_engine)
    assert stats["chunk_steps"] > 0 and stats["decode_steps"] > 0
    assert stats["decode_impl"] == "reference"


@pytest.mark.parametrize("preset", ["micro", "tiny"])
def test_shared_prefix_hits_and_copy_on_write(preset):
    """A second request sharing a multi-block prefix maps the cached
    blocks; a whole-prompt hit recomputes its last token inside the final
    shared block (copy-on-write). Hit counters agree with JAX."""
    jax_engine, port_engine = _engines(preset)
    bs = port_engine.scfg.block_size
    base = _prompts(port_engine.cfg.vocab_size, (3 * bs + 2,), seed=3)[0]
    tail = _prompts(port_engine.cfg.vocab_size, (5,), seed=4)[0]
    waves = [[(base, 6, {})],
             [(np.concatenate([base[:2 * bs], tail]), 6, {})],
             [(base[:3 * bs], 4, {})]]
    want, got = _run_waves([jax_engine, port_engine], waves)
    assert got == want
    stats = _assert_same_schedule(jax_engine, port_engine)["prefix_cache"]
    assert stats["hit_requests"] == 2 and stats["cow_copies"] == 1


@pytest.mark.parametrize("preset,n_blocks", [("micro", 14), ("tiny", 12)])
def test_small_pool_preempts_identically(preset, n_blocks):
    """A pool too small for every slot at once: the youngest request is
    preempted and recomputed, the same number of times in both engines,
    and every stream still matches (sampled ones by their keys)."""
    jax_engine, port_engine = _engines(preset, n_blocks=n_blocks)
    bs = port_engine.scfg.block_size
    ps = _prompts(port_engine.cfg.vocab_size, (2 * bs + 1, bs, 3, bs + 3),
                  seed=5)
    max_new = min(5 * bs, port_engine.scfg.max_len - 2 * bs - 1)
    wave = [(ps[0], max_new, {}), (ps[1], max_new, {}),
            (ps[2], max_new, {"temperature": 0.7, "key": [1, 2]}),
            (ps[3], max_new, {})]
    want, got = _run_waves([jax_engine, port_engine], [wave])
    assert got == want
    stats = _assert_same_schedule(jax_engine, port_engine)
    assert stats["recompute_preemptions"] > 0


@pytest.mark.parametrize("preset", ["micro", "tiny"])
def test_engine_matches_port_generate(preset):
    """Greedy engine streams equal the port's dense-cache ``generate``
    (which is itself held to JAX's in ``test_torch_decoding``), and the
    step ran through the plain paged attention, never the kernel."""
    engine = build_engine(preset, device="cpu")
    ps = _prompts(engine.cfg.vocab_size, (4, 11, 7), seed=6)
    tpa.reset_launch_counts()
    rids = [engine.submit(p, 9) for p in ps]
    out = engine.drain()
    assert tpa.paged_decode_attention.launches == 0
    assert tpa.paged_reference_attention.launches == \
        engine.cfg.n_layers * (engine.chunk_steps + engine.decode_steps)
    for rid, p in zip(rids, ps):
        ref = generate(engine.params, engine.cfg, p[None], 9, device=CPU)
        assert out[rid] == ref[0].tolist()


def test_build_engine_is_deterministic_and_defaults_to_cuda():
    a = build_engine("micro", device="cpu")
    b = build_engine("micro", device=torch.device("cpu"))
    for x, y in zip(_leaves(a.params), _leaves(b.params)):
        assert torch.equal(x, y)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_engine("micro")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(a.params, a.cfg, a.scfg)


def _leaves(params):
    yield params["embed"]
    yield params["unembed"]
    for layer in params["layers"]:
        yield from layer.values()


BUCKETED = dict(prefill="bucketed", prefix_cache=False)


@pytest.mark.parametrize("knobs,match", [
    (dict(prefill="bucketed"), "prefix_cache needs prefill='chunked'"),
    (dict(BUCKETED, max_len=64), "largest prefill bucket 128 exceeds"),
    (dict(prefill="bucketed", max_len=64),
     "largest prefill bucket 128 exceeds"),
    (dict(BUCKETED, overlap=True), "overlap=True needs prefill='chunked'"),
    (dict(BUCKETED, max_len=48, prefill_buckets=(8, 16)), "submit")],
    ids=["default-prefix-cache", "bucket-past-max-len",
         "bucket-past-max-len-first", "overlap", "prompt-past-last-bucket"])
def test_bucketed_knobs_raise_as_jax(knobs, match):
    """Bucketed prefill (ROADMAP A2) is ported: the port's config and
    engine raise the JAX package's ValueError, word for word and in JAX's
    order (the bucket check before the prefill value, the prefix-cache
    check before spec_k, so bucketed at the default ``prefix_cache`` gets
    the prefix-cache message)."""
    from tpu_task.ml.serving import ServingConfig as JaxServingConfig

    messages = []
    for config, build in ((JaxServingConfig, jax_build_engine),
                          (ServingConfig, build_engine)):
        with pytest.raises(ValueError) as info:
            if match != "submit":
                config(**knobs)
            else:
                engine = (build("micro", serving=knobs)
                          if config is JaxServingConfig
                          else build("micro", serving=knobs, device="cpu"))
                engine.submit(np.arange(17) % 64, 4)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    if match == "submit":
        assert messages[1] == ("prompt of 17 tokens exceeds the largest "
                               "prefill bucket 16")
    else:
        assert match in messages[1]
    assert ServingConfig(**BUCKETED).bucket_for(17) == 32


@pytest.mark.parametrize("knobs,error", [
    (dict(host_offload_blocks=-1), "host_offload_blocks must be >= 0"),
    (dict(host_offload_blocks=8, prefix_cache=False), "needs prefix_cache"),
    (dict(host_offload_blocks=8), None)],
    ids=["negative", "no-prefix-cache", "accepted"])
def test_host_offload_knob_validates_as_jax(knobs, error):
    """The host tier (ROADMAP A9) is ported: its knob raises JAX's
    ValueError word for word, and is accepted with a prefix cache."""
    from tpu_task.ml.serving import ServingConfig as JaxServingConfig

    if error is None:
        for config in (ServingConfig, JaxServingConfig):
            assert config(**knobs).host_offload_blocks == 8
        return
    messages = []
    for config in (ServingConfig, JaxServingConfig):
        with pytest.raises(ValueError, match=error) as info:
            config(**knobs)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("knobs", [
    dict(lora_rank=4, n_adapter_blocks=1), dict(lora_rank=-4)])
def test_lora_knobs_validate_as_jax(knobs):
    """LoRA's knobs (ROADMAP A7) are ported: a bad value raises JAX's
    ValueError, word for word."""
    from tpu_task.ml.serving import ServingConfig as JaxServingConfig

    messages = []
    for config in (ServingConfig, JaxServingConfig):
        with pytest.raises(ValueError, match="lora_rank") as info:
            config(**knobs)
        messages.append(str(info.value))
    assert messages[0] == messages[1]


def test_submit_checks_drain_timeout_and_unported_calls():
    engine = build_engine("micro", device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        engine.submit([1, 2], 100)
    with pytest.raises(ValueError, match="top_p"):
        engine.submit([1, 2], 4, top_p=0.5)
    with pytest.raises(ValueError, match="uint32"):
        engine.submit([1, 2], 4, temperature=1.0, key=[1, 2, 3])
    rid = engine.submit([1, 2, 3], 20)
    with pytest.raises(DrainTimeout) as timeout:
        engine.drain(max_steps=3)
    assert timeout.value.unfinished == [rid]
    with pytest.raises(RuntimeError, match="not done"):
        engine.result(rid)
    engine.drain()
    assert len(engine.result(rid)) == 20
    assert engine.allocator.referenced == 0
    # Weight hot-swap is ported (tests/test_torch_hot_swap.py): a roll
    # with no stream in flight frees the old generation at once, and a
    # generation that does not grow is refused, as in the JAX engine.
    jax_engine = jax_build_engine("micro")
    jax_engine.submit([1, 2, 3], 20)
    jax_engine.drain()
    for eng in (engine, jax_engine):
        assert eng.adopt_params(eng.params) == 1
        assert eng.adopt_params(eng.params, generation=5) == 5
        assert set(eng._gen_params) == {5} and eng.generation == 5
        with pytest.raises(ValueError, match="monotonically: got 5, "
                                             "active is 5"):
            eng.adopt_params(eng.params, generation=5)
    assert engine.stats()["adapters"] == jax_engine.stats()["adapters"]
    with pytest.raises(ValueError, match="CUDA device"):
        ServingEngine(engine.params, engine.cfg,
                      ServingConfig(decode_impl="cuda"), device="cpu")
