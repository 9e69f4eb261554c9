"""The port's speculative decoding (``ServingConfig.spec_k``, with a draft
model) against the JAX package's, on the CPU, from the same weights.

The five multi-token functions (``_multitoken_features``,
``paged_multitoken_logits``, ``spec_score_greedy``, ``spec_score_probs``,
``chunked_step_greedy``) take the same numpy inputs as JAX's — widths 1 and
3, ragged ``valid`` rows, an inactive slot, fragmented tables — over fp32,
bf16, int8, fp8 and int4 pools, with JAX's attention through its XLA
reference and through its Pallas kernel in interpret mode. Tolerances:
features, logits, probabilities and model-dtype pools within 1e-5 at fp32;
tokens equal; quantized codes bit-identical and scales within 1e-6
relative (a scale is a block's amax over k/v values the two frameworks'
fp32 projections round apart by an ulp); at bf16, features and logits
within 2^-6 of the tensor's largest magnitude (a few bf16 ulps, the two
frameworks rounding their bf16 intermediates in different places), and
tokens equal wherever the reference's top-2 logit gap exceeds twice that
(a nearer tie may flip inside the tolerance). The
spec uniforms equal JAX's ``_spec_uniform_fn`` bit for bit.

The port's spec engine must give the JAX spec engine's streams (greedy
bit-identical, sampled key-identical), ``stats()["spec"]`` and schedule
counters, and its greedy streams must equal the port's ``spec_k = 0``
ones: with a weak and a self draft at ``spec_k`` 1 and 3, under
preemption, over quantized pools (codes bit-identical after the drain;
int4, whose 15-level grid turns an fp32 rounding tie between the two
frameworks into a one-step code flip that later requantizations inherit,
within one code step and its scales within 1%), with ``spec_enabled``
toggled mid-stream and with ``micro_k`` 4. The card side (the kernels at the scoring widths)
is ``tests/test_torch_cuda_kernels.py`` and ``chip_smoke.py``."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.ml.serving import cache as jc
from tpu_task.ml.serving import model as jmodel
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.serving import cache as tc
from tpu_task_torch.ml.serving import model as tmodel
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine, spec_uniforms
from torch_port_util import (CPU, jax_model, port_config, port_model,
                             serving_knobs, share_jax_programs)

ATOL = 1e-5
SCALE_RTOL = 1e-6
BF16_REL = 2.0 ** -6
SCHEDULE_KEYS = ("steps", "decode_steps", "micro_steps", "chunk_steps",
                 "prefills", "prefill_chunks", "recompute_preemptions")

#: (kv_dtype, JAX code dtype, port code dtype)
CODES = {"int8": (jnp.int8, torch.int8),
         "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
         "int4": (jnp.uint8, torch.uint8)}

#: The INT8_PIN geometry of ``tests/test_paged_attention.py``.
INT8_PIN = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=4,
                d_head=16, d_ff=256, n_kv_heads=2)


def _skip_fp8(kind):
    if kind == "fp8" and not (jc.fp8_supported() and tc.fp8_supported()):
        pytest.skip("float8_e4m3fn is not supported by both packages here")


# -- the multi-token functions -----------------------------------------------

def _fn_inputs(jcfg, knobs, w, seed):
    """Four slots at ragged depths with ragged valid spans (w, w - 1, 1
    and an inactive slot), fragmented tables, random pool values."""
    bs, n_blocks = knobs["block_size"], knobs["n_blocks"]
    m = -(-knobs["max_len"] // bs)
    rng = np.random.default_rng(seed)
    spread = rng.lognormal(0, 1, (n_blocks, 1, jcfg.n_kv_heads, 1))
    pools = [{name: (rng.standard_normal(
                  (n_blocks, bs, jcfg.n_kv_heads, jcfg.d_head)) * spread
              ).astype(np.float32) for name in ("k", "v")}
             for _ in range(jcfg.n_layers)]
    depths = [5, 2 * bs + 1, bs - 1, 0]
    spans = [w, max(1, w - 1), 1, 0]
    slots = len(depths)
    positions = np.zeros((slots, w), np.int32)
    valid = np.zeros((slots, w), bool)
    tables = np.zeros((slots, m), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    used = 0
    for i, (depth, span) in enumerate(zip(depths, spans)):
        if not span:
            continue
        positions[i] = depth + np.arange(w)
        valid[i, :span] = True
        need = (depth + w - 1) // bs + 1
        tables[i, :need] = perm[used:used + need]
        used += need
    positions = np.where(valid, positions, 0).astype(np.int32)
    return dict(
        tokens=rng.integers(0, jcfg.vocab_size, (slots, w)).astype(np.int32),
        positions=positions, valid=valid, tables=tables, pools=pools,
        last_idx=np.maximum(np.array(spans) - 1, 0).astype(np.int32),
        temps=np.array([0.0, 0.8, 1.1, 0.0], np.float32),
        tops=np.array([1.0, 0.9, 1.0, 1.0], np.float32))


def _quant_layout(bs, tables, positions, valid):
    """The engine's host-side write layout (``ServingEngine._quant_layout``)
    for one step."""
    host = types.SimpleNamespace(scfg=types.SimpleNamespace(block_size=bs),
                                 quantized_block_writes=0)
    return ServingEngine._quant_layout(host, tables, positions, valid)


def _pools_for(kind, pools):
    """The same pools for both packages: fp32 or bf16 values, or the JAX
    package's codes and scales (the port's codes are JAX's bytes)."""
    if kind in ("float32", "bfloat16"):
        jdt = jnp.float32 if kind == "float32" else jnp.bfloat16
        tdt = torch.float32 if kind == "float32" else torch.bfloat16
        return ([{k: jnp.asarray(v).astype(jdt) for k, v in layer.items()}
                 for layer in pools],
                lambda: [{k: torch.tensor(v).to(tdt)
                          for k, v in layer.items()} for layer in pools])
    jdt, tdt = CODES[kind]
    jpools, raw = [], []
    for layer in pools:
        jl = {}
        for name in ("k", "v"):
            codes, scale = jc.quantize_blocks(jnp.asarray(layer[name]), jdt)
            jl[name], jl[name + "_scale"] = codes, scale
        jpools.append(jl)
        raw.append({k: np.asarray(v) for k, v in jl.items()})

    def port():
        return [{k: (torch.tensor(v.view(np.uint8)).view(tdt)
                     if k in ("k", "v") else torch.tensor(v))
                 for k, v in layer.items()} for layer in raw]

    return jpools, port


def _pool_bytes(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = (arr.view(torch.uint8) if arr.element_size() == 1
               else arr.float()).numpy()
    arr = np.asarray(arr)
    if arr.dtype.itemsize == 1:
        return arr.view(np.uint8)
    return arr.astype(np.float32)


def _check_pools(kind, got, want, bf16_atol):
    """Pools after one call: blocks past the scratch block (masked writes
    of both land there, in an order neither defines)."""
    for gl, wl in zip(got, want):
        for name in ("k", "v"):
            g, w = _pool_bytes(gl[name])[1:], _pool_bytes(wl[name])[1:]
            if kind in CODES:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(
                    g, w, rtol=0,
                    atol=ATOL if kind == "float32" else bf16_atol)
        if kind in CODES:
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(gl[name].numpy()[1:],
                                           np.asarray(wl[name])[1:],
                                           rtol=SCALE_RTOL, atol=0)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(x, np.float32)


def _close(kind, got, want, mask):
    got, want = _f32(got)[mask], _f32(want)[mask]
    if kind == "bfloat16":
        atol = BF16_REL * float(np.abs(want).max())
    else:
        atol = ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _bf16_tokens_equal(got, logits, mask, atol):
    """bf16 argmax agreement where it is defined: every token whose
    reference top-2 logit gap exceeds twice the logits' tolerance (a
    nearer tie may flip within that tolerance)."""
    top2 = np.sort(_f32(logits), axis=-1)[..., -2:]
    clear = mask & (top2[..., 1] - top2[..., 0] > 2 * atol)
    assert clear.sum() >= mask.sum() // 2
    np.testing.assert_array_equal(np.asarray(got)[clear],
                                  np.argmax(_f32(logits), -1)[clear])


#: JAX's multi-token functions compiled, as its engine runs them (the
#: config and ``attn_impl`` static). XLA folds the quantizer's ``amax /
#: 127.0`` into a product with the float32 reciprocal, so an eager call's
#: scales sit an ulp from the engine's in about half the blocks, and an
#: int4 code at a rounding edge a step apart.
JAX_FNS = {name: jax.jit(getattr(jmodel, name), static_argnums=1,
                         static_argnames="attn_impl")
           for name in ("_multitoken_features", "paged_multitoken_logits",
                        "spec_score_greedy", "spec_score_probs",
                        "chunked_step_greedy")}


@pytest.mark.parametrize("jax_impl", ["xla", "interpret"])
@pytest.mark.parametrize("w", [1, 3])
@pytest.mark.parametrize("preset,kind", [
    ("micro", "float32"), ("tiny", "float32"), ("micro", "bfloat16"),
    ("micro", "int8"), ("micro", "fp8"), ("micro", "int4")])
def test_multitoken_functions_match_jax(preset, kind, w, jax_impl):
    _skip_fp8(kind)
    jcfg, jparams = jax_model(preset)
    knobs = serving_knobs(preset)
    dtype = torch.bfloat16 if kind == "bfloat16" else torch.float32
    cfg = port_config(jcfg, dtype)
    params = ttf.params_from_jax(jax.tree.map(np.asarray, jparams), cfg, CPU)
    if kind == "bfloat16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    x = _fn_inputs(jcfg, knobs, w, seed=w + 7 * len(kind))
    jpools, port_pools = _pools_for(kind, x["pools"])
    quantized = kind in CODES
    layout = (_quant_layout(knobs["block_size"], x["tables"], x["positions"],
                            x["valid"]) if quantized else None)
    jqa = tuple(jnp.asarray(a, jnp.int32) for a in layout) \
        if quantized else None
    tqa = tuple(torch.tensor(a, dtype=torch.int64) for a in layout) \
        if quantized else None
    jhead = (jparams, jcfg, jnp.asarray(x["tokens"]),
             jnp.asarray(x["positions"]), jnp.asarray(x["valid"]),
             jnp.asarray(x["tables"]))
    thead = (params, cfg, torch.tensor(x["tokens"]).long(),
             torch.tensor(x["positions"]), torch.tensor(x["valid"]),
             torch.tensor(x["tables"]))
    jkw = dict(attn_impl=jax_impl)
    valid = x["valid"]
    bf16_atol = 0.0

    with torch.no_grad():
        feats = JAX_FNS["_multitoken_features"](*jhead, jpools, jqa, **jkw)
        pools = port_pools()
        got = tmodel._multitoken_features(*thead, pools, tqa)
        got = got[0] if quantized else got
        _close(kind, got, feats[0], valid)
        bf16_atol = BF16_REL * float(max(
            np.abs(np.asarray(p[n], np.float32)).max()
            for p in x["pools"] for n in ("k", "v")))
        _check_pools(kind, pools, feats[1], bf16_atol)

        logits = JAX_FNS["paged_multitoken_logits"](*jhead, jpools, jqa, **jkw)
        got = tmodel.paged_multitoken_logits(*thead, port_pools(), tqa)
        got = got[0] if quantized else got
        assert got.shape == (4, w, jcfg.vocab_size)
        _close(kind, got, logits[0], valid)

        greedy = JAX_FNS["spec_score_greedy"](*jhead, jpools, jqa, **jkw)
        got = tmodel.spec_score_greedy(*thead, port_pools(), tqa)
        got = got[0] if quantized else got
        if kind == "bfloat16":
            _bf16_tokens_equal(
                got.numpy(), logits[0], valid,
                BF16_REL * float(np.abs(_f32(logits[0])[valid]).max()))
        else:
            np.testing.assert_array_equal(got.numpy()[valid],
                                          np.asarray(greedy[0])[valid])

        if kind != "bfloat16":
            probs = JAX_FNS["spec_score_probs"](
                *jhead, jnp.asarray(x["temps"]), jnp.asarray(x["tops"]),
                jpools, jqa, **jkw)
            got = tmodel.spec_score_probs(
                *thead, torch.tensor(x["temps"]), torch.tensor(x["tops"]),
                port_pools(), tqa)
            got = got[0] if quantized else got
            _close(kind, got, probs[0], valid)
            np.testing.assert_allclose(got.numpy()[valid].sum(-1), 1.0,
                                       atol=1e-5)

        chunk = JAX_FNS["chunked_step_greedy"](
            *jhead[:5], jnp.asarray(x["last_idx"]), jhead[5], jpools, jqa,
            **jkw)
        pools = port_pools()
        got = tmodel.chunked_step_greedy(
            *thead[:5], torch.tensor(x["last_idx"]), thead[5], pools, tqa)
        got = got[0] if quantized else got
        live = valid[np.arange(4), x["last_idx"]]
        assert got.shape == (4,) and live.tolist() == [True] * 3 + [False]
        if kind == "bfloat16":
            last = _f32(logits[0])[np.arange(4), x["last_idx"]]
            _bf16_tokens_equal(got.numpy(), last, live,
                               BF16_REL * float(np.abs(last[live]).max()))
        else:
            np.testing.assert_array_equal(got.numpy()[live],
                                          np.asarray(chunk[0])[live])
        _check_pools(kind, pools, chunk[1], bf16_atol)


def test_chunked_step_packs_every_valid_token():
    """A draft catch-up layout (slots x chunk_tokens, mostly invalid): the
    packed width-1 result equals JAX's (slots, w) one, and a wholly
    invalid slot leaves the pools' blocks alone."""
    jcfg, jparams = jax_model("micro")
    cfg, params = port_model(jcfg, jparams)
    knobs = serving_knobs("micro")
    x = _fn_inputs(jcfg, knobs, 16, seed=3)
    valid = np.zeros_like(x["valid"])
    valid[0, :16], valid[1, :2], valid[2, :1] = True, True, True
    positions = np.where(valid, x["positions"], 0).astype(np.int32)
    last_idx = np.array([15, 1, 0, 0], np.int32)
    jpools, port_pools = _pools_for("float32", x["pools"])
    want = jmodel.chunked_step_greedy(
        jparams, jcfg, jnp.asarray(x["tokens"]), jnp.asarray(positions),
        jnp.asarray(valid), jnp.asarray(last_idx), jnp.asarray(x["tables"]),
        jpools)
    pools = port_pools()
    with torch.no_grad():
        got = tmodel.chunked_step_greedy(
            params, cfg, torch.tensor(x["tokens"]).long(),
            torch.tensor(positions), torch.tensor(valid),
            torch.tensor(last_idx), torch.tensor(x["tables"]), pools)
    np.testing.assert_array_equal(got.numpy()[:3], np.asarray(want[0])[:3])
    _check_pools("float32", pools, want[1], 0.0)


def test_multitoken_quantized_needs_its_layout():
    cfg, params = port_model(*jax_model("micro"))
    engine = ServingEngine(params, cfg,
                           ServingConfig(**serving_knobs("micro"),
                                         kv_dtype="int8"), device=CPU)
    tokens = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="write layout"):
        tmodel.spec_score_greedy(
            engine.params, engine.cfg, tokens, tokens.to(torch.int32),
            torch.ones((1, 2), dtype=torch.bool),
            torch.zeros((1, 12), dtype=torch.int32), engine.pools)


# -- the spec uniforms ---------------------------------------------------------

def test_spec_uniforms_match_jax_bit_for_bit():
    jcfg, jparams = jax_model("micro")
    jax_engine = share_jax_programs(JaxServingEngine(
        jparams, jcfg, JaxServingConfig(**serving_knobs("micro"), spec_k=2,
                                        decode_impl="xla"),
        draft_params=jparams, draft_cfg=jcfg))
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2**32, size=(6, 2), dtype=np.uint64) \
        .astype(np.uint32)
    keys[0], keys[1] = [0, 0], [2**32 - 1, 2**32 - 1]
    positions = rng.integers(0, 2**31 - 1, size=(6, 5)).astype(np.int32)
    positions[0] = np.arange(5)
    want = np.asarray(jax_engine._spec_uniform_fn(jnp.asarray(keys),
                                                  jnp.asarray(positions)))
    got = spec_uniforms(R.as_key(keys), torch.tensor(positions).long())
    assert got.dtype == torch.float32 and got.shape == (6, 5, 2)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


# -- the spec engine against JAX's ---------------------------------------------

def _weak_draft(jcfg, seed=7):
    """A genuinely smaller draft of the same vocab (one layer, half the
    width), JAX weights and the port's copy."""
    dcfg = jtf.TransformerConfig(
        vocab_size=jcfg.vocab_size, d_model=jcfg.d_model // 2, n_layers=1,
        n_heads=2, d_head=jcfg.d_head, d_ff=jcfg.d_ff // 2,
        dtype=jnp.float32, n_kv_heads=2)
    return dcfg, jtf.init(jax.random.PRNGKey(seed), dcfg)


def _spec_engines(geometry, draft, knobs, slots_list=None):
    """The JAX spec engine and the port's, from the same target and draft
    weights, plus the port's engine at spec_k = 0."""
    if geometry == "int8_pin":
        jcfg = jtf.TransformerConfig(dtype=jnp.float32, **INT8_PIN)
        jparams = jtf.init(jax.random.PRNGKey(0), jcfg)
    else:
        jcfg, jparams = jax_model(geometry)
    cfg, params = port_model(jcfg, jparams)
    if draft == "self":
        jd = (jcfg, jparams)
    elif draft == "same_geometry":
        jd = (jcfg, jtf.init(jax.random.PRNGKey(1), jcfg))
    else:
        jd = _weak_draft(jcfg)
    dcfg, dparams = port_model(*jd)
    jax_engine = share_jax_programs(JaxServingEngine(
        jparams, jcfg, JaxServingConfig(**knobs, decode_impl="xla"),
        rng=jax.random.PRNGKey(0), draft_params=jd[1], draft_cfg=jd[0]))
    port = ServingEngine(params, cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(0), device=CPU, draft_params=dparams,
                         draft_cfg=dcfg)
    plain = ServingEngine(params, cfg,
                          ServingConfig(**{**knobs, "spec_k": 0,
                                           "micro_k": 1}),
                          rng=R.PRNGKey(0), device=CPU)
    return jax_engine, port, plain


def _waves(vocab, bs, small_pool=False):
    """Greedy requests (one with an eos) and sampled ones with raw keys,
    prompts longer than a chunk; with the full pool a second wave sharing
    a multi-block prefix (prefix cache, copy-on-write)."""
    rng = np.random.default_rng(11)
    ps = [rng.integers(0, vocab, size=n).astype(np.int32)
          for n in (3 * bs + 2, 9, 2, 2 * bs + 1, 5, bs)]
    if small_pool:
        max_new = 4 * bs
        return [[(ps[0], max_new, {}), (ps[1], max_new, {"eos_token": 3}),
                 (ps[2], max_new, {"temperature": 0.7, "key": [1, 2]}),
                 (ps[3], max_new, {})]]
    first = [(ps[0], 9, {"eos_token": 7}),
             (ps[1], 7, {"temperature": 0.9, "top_p": 0.9,
                         "key": [3, 2**32 - 5]}),
             (ps[2], 1, {}), (ps[3], 10, {"temperature": 1.1}),
             (ps[4], 12, {}), (ps[5], 5, {})]
    second = [(np.concatenate([ps[0][:2 * bs], ps[4]]), 6, {}),
              (ps[0][:3 * bs], 5, {"temperature": 0.7, "key": [9, 9]})]
    return [first, second]


def _drain(engine, waves, toggle=None):
    """Every wave's requests in, then the engine stepped dry; ``toggle``
    (step -> spec_enabled) flips the brownout knob at those steps."""
    steps = 0
    for wave in waves:
        for prompt, max_new, kw in wave:
            engine.submit(prompt, max_new, **kw)
        while engine.has_work:
            if toggle and steps in toggle:
                engine.spec_enabled = toggle[steps]
            engine.step()
            steps += 1
            assert steps < 3000
    return {rid: list(r.tokens) for rid, r in engine._requests.items()}


def _greedy(waves):
    return [rid for rid, (_, _, kw) in enumerate(
        r for wave in waves for r in wave) if "temperature" not in kw]


def _check_against_jax(jax_engine, port, plain, waves, **drain):
    want = _drain(jax_engine, waves)
    got = _drain(port, waves, **drain)
    assert got == want
    base = _drain(plain, waves)
    assert [got[r] for r in _greedy(waves)] == \
        [base[r] for r in _greedy(waves)]
    js, ps = jax_engine.stats(), port.stats()
    assert ps["spec"] == js["spec"]
    assert {k: ps[k] for k in SCHEDULE_KEYS} == \
        {k: js[k] for k in SCHEDULE_KEYS}
    assert ps["prefix_cache"]["hit_requests"] == \
        js["prefix_cache"]["hit_requests"]
    assert ps["draft_decode_impl"] == ps["decode_impl"] == "reference"
    assert port.allocator.referenced == 0
    return ps


@pytest.mark.parametrize("draft", ["weak", "self"])
@pytest.mark.parametrize("spec_k", [1, 3])
def test_spec_engine_matches_jax_and_spec_off(draft, spec_k):
    knobs = serving_knobs("micro", spec_k=spec_k)
    jax_engine, port, plain = _spec_engines("micro", draft, knobs)
    waves = _waves(port.cfg.vocab_size, port.scfg.block_size)
    s = _check_against_jax(jax_engine, port, plain, waves)
    assert s["spec"]["rounds"] > 0 and s["spec"]["proposed"] > 0
    assert s["prefix_cache"]["cow_copies"] > 0
    g = s["goodput"]
    assert g["tokens"]["spec_rejected"] == \
        s["spec"]["proposed"] - s["spec"]["accepted"]
    assert g["ratio"] == pytest.approx(
        g["tokens"]["emitted"]
        / (g["tokens"]["emitted"] + g["tokens"]["spec_rejected"]))
    if draft == "self":
        assert s["spec"]["accepted"] > s["spec"]["rounds"] / 2


def test_self_draft_greedy_accepts_nearly_everything():
    """With the target as its own draft and every request greedy, every
    proposal agrees (as JAX's ``test_speculative_greedy_identity``)."""
    knobs = serving_knobs("tiny", spec_k=3)
    jax_engine, port, plain = _spec_engines("tiny", "self", knobs)
    rng = np.random.default_rng(5)
    waves = [[(rng.integers(0, 256, size=n), new, {})
              for n, new in ((6, 10), (19, 7), (4, 12), (30, 9))]]
    s = _check_against_jax(jax_engine, port, plain, waves)
    assert s["spec"]["accept_rate"] > 0.9
    assert s["spec"]["accepted"] > s["spec"]["rounds"]


@pytest.mark.parametrize("draft", ["weak", "self"])
def test_spec_engine_under_preemption(draft):
    knobs = serving_knobs("micro", spec_k=2, n_blocks=14)
    jax_engine, port, plain = _spec_engines("micro", draft, knobs)
    waves = _waves(port.cfg.vocab_size, port.scfg.block_size,
                   small_pool=True)
    s = _check_against_jax(jax_engine, port, plain, waves)
    assert s["recompute_preemptions"] > 0


@pytest.mark.parametrize("geometry,kv_dtype,draft", [
    ("int8_pin", "int8", "same_geometry"), ("micro", "fp8", "weak"),
    ("micro", "int4", "self")])
def test_spec_engine_quantized_pools(geometry, kv_dtype, draft):
    _skip_fp8(kv_dtype)
    if geometry == "int8_pin":
        knobs = dict(slots=2, block_size=4, n_blocks=32, max_len=48,
                     chunk_tokens=6, kv_dtype=kv_dtype, spec_k=2)
    else:
        knobs = serving_knobs(geometry, kv_dtype=kv_dtype, spec_k=2)
    jax_engine, port, plain = _spec_engines(geometry, draft, knobs)
    # The spec-off reference is an engine of the same kv_dtype (a
    # quantized pool is a tolerance dtype: its streams are its own).
    plain = ServingEngine(plain.params, plain.cfg,
                          ServingConfig(**{**knobs, "spec_k": 0}),
                          rng=R.PRNGKey(0), device=CPU)
    waves = _waves(port.cfg.vocab_size, port.scfg.block_size)
    s = _check_against_jax(jax_engine, port, plain, waves)
    assert s["kv_quant"]["quantized_block_writes"] == \
        jax_engine.stats()["kv_quant"]["quantized_block_writes"]
    for jl, pl in zip(jax_engine.pools, port.pools):
        for name in ("k", "v"):
            got, want = _pool_bytes(pl[name]), _pool_bytes(jl[name])
            if kv_dtype != "int4":
                np.testing.assert_array_equal(got, want)
                continue
            # int4's 15-level grid: a value an fp32 ulp from a rounding
            # tie lands one code apart in the two frameworks, and later
            # requantizations of its block (and the next layer's k/v)
            # inherit the step. Under 1% of the codes may differ, the
            # scales within 1%; the streams above are still identical.
            codes = [tc.unpack_int4(torch.tensor(a)) for a in (got, want)]
            assert (codes[0] != codes[1]).float().mean() < 1e-2
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(
                pl[name].numpy(), np.asarray(jl[name]), atol=0,
                rtol=SCALE_RTOL if kv_dtype != "int4" else 1e-2)
    # The draft pools stay in the draft's own dtype.
    assert port._draft_pools[0]["k"].dtype == torch.float32
    assert "k_scale" not in port._draft_pools[0]


def test_sampled_streams_are_schedule_free():
    """Sampled spec streams draw from position-keyed uniforms: the same
    request gives the same tokens at slots 1 and 3, in the port and in
    JAX (as JAX's ``test_speculative_sampled_is_deterministic_and_
    schedule_free``)."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 64, size=6) for _ in range(3)]
    waves = [[(p, 8, {"temperature": 0.9, "top_p": 0.8, "key": [21, i]})
              for i, p in enumerate(prompts)]]
    outs = []
    for slots in (1, 3):
        knobs = serving_knobs("micro", slots=slots, spec_k=2,
                              prefix_cache=False)
        jax_engine, port, _ = _spec_engines("micro", "weak", knobs)
        got = _drain(port, waves)
        assert got == _drain(jax_engine, waves)
        assert port.stats()["spec"] == jax_engine.stats()["spec"]
        outs.append(got)
    assert outs[0] == outs[1]
    assert all(len(s) == 8 for s in outs[0].values())


def test_spec_enabled_toggle_keeps_the_streams():
    """The brownout knob off mid-stream proposes nothing and still scores
    every slot through the spec path: greedy streams stay those of spec
    off, and on again the draft's catch-up heals its cache. A sampled
    token drawn where no proposal was made comes from the bonus draw
    rather than the accept coin, so sampled streams follow the toggle
    schedule — the JAX engine's, toggled at the same steps."""
    knobs = serving_knobs("micro", spec_k=3)
    jax_engine, port, plain = _spec_engines("micro", "self", knobs)
    waves = _waves(port.cfg.vocab_size, port.scfg.block_size)
    toggle = {4: False, 9: True, 14: False, 20: True}
    want = _drain(jax_engine, waves, toggle=toggle)
    assert _drain(port, waves, toggle=toggle) == want
    assert port.stats()["spec"] == jax_engine.stats()["spec"]
    base = _drain(plain, waves)
    assert [want[r] for r in _greedy(waves)] == \
        [base[r] for r in _greedy(waves)]
    _, full, _ = _spec_engines("micro", "self", knobs)
    _drain(full, waves)
    assert 0 < port.stats()["spec"]["proposed"] \
        < full.stats()["spec"]["proposed"]


def test_micro_k_with_spec_takes_the_spec_path():
    """With spec on, rounds are the multi-token path: micro_k 4 gives the
    same streams and runs no micro-step (nor captures a graph)."""
    knobs = serving_knobs("micro", spec_k=2)
    jax_engine, port, plain = _spec_engines(
        "micro", "weak", {**knobs, "micro_k": 4})
    waves = _waves(port.cfg.vocab_size, port.scfg.block_size)
    s = _check_against_jax(jax_engine, port, plain, waves)
    _, at_k1, _ = _spec_engines("micro", "weak", knobs)
    assert _drain(at_k1, waves) == \
        {rid: list(r.tokens) for rid, r in port._requests.items()}
    assert s["micro_k"] == 4 and s["micro_steps"] == 0
    assert s["step_graph"]["captures"] == 0 and s["spec"]["rounds"] > 0


def test_spec_construction_errors():
    """As JAX's ``test_production_config_validation``."""
    jcfg, jparams = jax_model("micro")
    cfg, params = port_model(jcfg, jparams)
    with pytest.raises(ValueError, match="spec_k"):
        ServingConfig(spec_k=-1)
    with pytest.raises(ValueError, match="draft"):
        ServingEngine(params, cfg, ServingConfig(spec_k=2), device=CPU)
    big_vocab = ttf.TransformerConfig(
        vocab_size=128, d_model=16, n_layers=1, n_heads=2, d_head=8,
        d_ff=32, dtype=torch.float32, n_kv_heads=2)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(params, cfg, ServingConfig(spec_k=2), device=CPU,
                      draft_params=ttf.init(torch.Generator(), big_vocab),
                      draft_cfg=big_vocab)
    engine = ServingEngine(params, cfg, ServingConfig(spec_k=0), device=CPU)
    assert engine.stats()["spec"] == {"k": 0, "rounds": 0, "proposed": 0,
                                      "accepted": 0, "accept_rate": 0.0}
    assert engine.stats()["draft_decode_impl"] is None
