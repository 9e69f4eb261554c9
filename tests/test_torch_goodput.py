"""The port's goodput meter (``tpu_task_torch.obs.goodput``) against the
JAX package's (``tpu_task.obs.goodput``), on the CPU.

The static FLOP model must give JAX's numbers on the ``tiny`` and
``micro`` presets. Over one workload the port's engine must charge what
the JAX engine (with an ``obs`` handle, which turns its meter on)
charges: the same dispatches, model FLOPs and token counts, at K = 1 and
at K = 4 and under preemption, under the same ``stats()["goodput"]``
keys; and K = 4 must take fewer dispatches per token than K = 1 for the
same FLOPs and tokens, as JAX's ``test_serving_micro.py`` pins. A
bucketed engine charges what JAX's bucketed engine charges."""

import jax
import numpy as np
import pytest
import torch

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.obs import Obs
from tpu_task.obs import goodput as jgoodput
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.obs import goodput as tgoodput
from torch_port_util import CPU, jax_model, port_model, serving_knobs


@pytest.mark.parametrize("preset", ["tiny", "micro"])
def test_flop_model_matches_jax(preset):
    jcfg, jparams = jax_model(preset)
    cfg, _ = port_model(jcfg, jparams)
    assert tgoodput.matmul_params(cfg) == jgoodput.matmul_params(jcfg)
    for kv_len in (0, 1, 17, 1000):
        assert tgoodput.token_flops(cfg, kv_len) == \
            jgoodput.token_flops(jcfg, kv_len)
    rng = np.random.default_rng(0)
    for positions in ([], [0], rng.integers(0, 128, size=(3, 5))):
        assert tgoodput.flops_for_positions(cfg, positions) == \
            jgoodput.flops_for_positions(jcfg, positions)


def _workload(vocab):
    """JAX ``test_serving_micro.py``'s workload shape: mixed prompt and
    output lengths with an eos, greedy and sampled."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(8):
        prompt = rng.integers(0, vocab, size=int(rng.integers(3, 12)))
        kw = {"temperature": 0.8, "top_p": 0.9} if i % 3 == 1 else {}
        out.append((prompt, int(rng.integers(3, 14)), kw))
    return out


def _run(engine, work):
    for prompt, max_new, kw in work:
        engine.submit(prompt, max_new, eos_token=7, **kw)
    return engine.drain(max_steps=3000), engine.stats()["goodput"]


def _port_engine(micro_k, n_blocks=None):
    jcfg, jparams = jax_model("micro")
    cfg, params = port_model(jcfg, jparams)
    knobs = serving_knobs("micro", micro_k=micro_k)
    if n_blocks:
        knobs["n_blocks"] = n_blocks
    return ServingEngine(params, cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(0), device=CPU)


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


@pytest.mark.parametrize("micro_k,n_blocks", [(1, None), (4, None),
                                              (2, 10)])
def test_charges_match_jax_meter(micro_k, n_blocks):
    port = _port_engine(micro_k, n_blocks)
    jcfg, jparams = jax_model("micro")
    knobs = serving_knobs("micro", micro_k=micro_k, decode_impl="xla")
    if n_blocks:
        knobs["n_blocks"] = n_blocks
    jax_engine = JaxServingEngine(
        jparams, jcfg, JaxServingConfig(**knobs), rng=jax.random.PRNGKey(0),
        obs=Obs.create(f"micro-{micro_k}"))
    work = _workload(port.cfg.vocab_size)
    want, jg = _run(jax_engine, work)
    got, pg = _run(port, work)
    assert got == want
    assert _key_tree(pg) == _key_tree(jg)
    assert pg["dispatches"] == jg["dispatches"]
    assert pg["tokens"] == jg["tokens"]
    assert pg["ratio"] == jg["ratio"]
    assert pg["model_flops"] == pytest.approx(jg["model_flops"], rel=1e-12)
    assert pg["dispatches_per_token"] == jg["dispatches_per_token"]
    if n_blocks:
        assert pg["tokens"]["preempted"] > 0 and pg["ratio"] < 1
    else:
        assert pg["ratio"] == 1.0
    assert 0 <= pg["host_gap_frac"] <= 1 and pg["program_s"] > 0
    assert pg["mfu"] > 0
    assert pg["peak_flops"] == tgoodput.NOMINAL_PEAK_FLOPS


@pytest.mark.parametrize("micro_k", [1, 4])
def test_bucketed_charges_match_jax_meter(micro_k):
    """Bucketed prefill: an admission is two dispatches (the prefill
    program and its sampler) and charges its whole prompt in closed form
    (``work_span``), as the JAX meter does."""
    jcfg, jparams = jax_model("micro")
    cfg, params = port_model(jcfg, jparams)
    knobs = serving_knobs("micro", micro_k=micro_k, prefill="bucketed",
                          prefix_cache=False, prefill_buckets=(8, 16, 32))
    port = ServingEngine(params, cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(0), device=CPU)
    jax_engine = JaxServingEngine(
        jparams, jcfg, JaxServingConfig(**knobs, decode_impl="xla"),
        rng=jax.random.PRNGKey(0), obs=Obs.create(f"bucketed-{micro_k}"))
    work = _workload(port.cfg.vocab_size)
    want, jg = _run(jax_engine, work)
    got, pg = _run(port, work)
    assert got == want
    for key in ("dispatches", "tokens", "ratio", "dispatches_per_token"):
        assert pg[key] == jg[key], key
    assert pg["model_flops"] == pytest.approx(jg["model_flops"], rel=1e-12)
    assert port.stats()["prefills"] == len(work)


def test_dispatches_per_token_fall_at_k4():
    """One dispatch a micro-step but K tokens of work: dispatches per
    token drop, and the FLOP model and emitted tokens, charged per valid
    token, stay the same."""
    work = _workload(64)
    out1, g1 = _run(_port_engine(1), work)
    out4, g4 = _run(_port_engine(4), work)
    assert out1 == out4
    assert g4["dispatches_per_token"] < g1["dispatches_per_token"]
    assert g4["model_flops"] == pytest.approx(g1["model_flops"])
    assert g4["tokens"]["emitted"] == g1["tokens"]["emitted"]


def test_peak_and_meter_arithmetic(monkeypatch):
    monkeypatch.delenv("TPU_TASK_PEAK_FLOPS", raising=False)
    assert tgoodput.peak_flops_per_s() == tgoodput.NOMINAL_PEAK_FLOPS
    assert tgoodput.peak_flops_per_s(CPU) == tgoodput.NOMINAL_PEAK_FLOPS
    assert tgoodput.peak_flops_per_s(torch.device("cuda")) == 989e12
    monkeypatch.setenv("TPU_TASK_PEAK_FLOPS", "2.5e14")
    assert tgoodput.peak_flops_per_s(torch.device("cuda")) == 2.5e14
    cfg, _ = port_model(*jax_model("micro"))
    meter = tgoodput.GoodputMeter(cfg, peak_flops=1e9)
    assert meter.snapshot()["ratio"] == 1.0
    meter.begin_step()
    meter.program(0.25)
    meter.work_counts(2, 5.0)
    meter.emitted(2)
    meter.end_step(1.0)
    meter.wasted_preempt(1)
    snap = meter.snapshot()
    assert snap["host_gap_frac"] == 0.75 and snap["dispatches"] == 1
    assert snap["ratio"] == 0.5 and snap["dispatches_per_token"] == 0.5
    want = 2 * 2.0 * tgoodput.matmul_params(cfg) \
        + 4.0 * cfg.n_layers * cfg.d_attn * 7.0
    assert snap["model_flops"] == want
    assert snap["mfu"] == pytest.approx(want / 1.0 / 1e9)
    meter.reset()
    assert meter.snapshot()["dispatches"] == 0


def test_spec_charges_match_jax_meter():
    """A speculative engine (the target as its own draft, spec_k 2) charges
    what JAX's does: every draft, scoring and uniform dispatch, the
    rejected proposals in ``tokens.spec_rejected`` and in ``ratio``'s
    denominator, and the scored positions' FLOPs."""
    jcfg, jparams = jax_model("micro")
    cfg, params = port_model(jcfg, jparams)
    knobs = serving_knobs("micro", spec_k=2)
    jax_engine = JaxServingEngine(
        jparams, jcfg, JaxServingConfig(**knobs, decode_impl="xla"),
        rng=jax.random.PRNGKey(0), obs=Obs.create("micro-spec"),
        draft_params=jparams, draft_cfg=jcfg)
    port = ServingEngine(params, cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(0), device=CPU, draft_params=params,
                         draft_cfg=cfg)
    work = _workload(port.cfg.vocab_size)
    want, jg = _run(jax_engine, work)
    got, pg = _run(port, work)
    assert got == want
    assert pg["tokens"] == jg["tokens"]
    assert pg["tokens"]["spec_rejected"] > 0 and pg["ratio"] < 1
    assert pg["ratio"] == jg["ratio"]
    assert pg["dispatches"] == jg["dispatches"]
    assert pg["model_flops"] == pytest.approx(jg["model_flops"], rel=1e-12)


def test_wasted_spec_joins_the_denominator():
    cfg, _ = port_model(*jax_model("micro"))
    meter = tgoodput.GoodputMeter(cfg, peak_flops=1e9)
    meter.emitted(6)
    meter.wasted_spec(2)
    meter.wasted_spec(-1)                 # nothing rejected: no charge
    meter.wasted_preempt(1)
    snap = meter.snapshot()
    assert snap["tokens"]["spec_rejected"] == 2
    assert snap["ratio"] == (6 - 1) / (6 + 2)
