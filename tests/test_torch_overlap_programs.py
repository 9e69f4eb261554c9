"""The port's carry-threaded programs (the overlapped loop's, ROADMAP A5)
against the JAX package's, at fp32 on the CPU, from the same weights, and
``ServingConfig(overlap=True)``'s validation against JAX's.

``micro_carry_greedy``/``micro_carry_sample`` at K 1 and 4 take the same
numpy carry (absolute emitted counts and limits) as JAX's: a slot that
retires on its eos, one at its limit, one that runs the whole span and a
dead one. ``chunk_carry_greedy``/``chunk_carry_sample`` take a carry with
a decode row that retires on its eos and one at its limit, a prefill that
completes (its first token promoted into the carry) and one that stays
mid-prompt. Tokens and the four carry tensors must equal JAX's exactly,
the pools within 2e-5 (fp32 values, int8 scales) with equal int8 codes,
over fp32 and int8 pools."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import cache as jcache
from tpu_task.ml.serving import model as jmodel
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving import model as tmodel
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from torch_port_util import CPU, jax_model, port_model, serving_knobs

PRESET = "tiny"
ATOL = 2e-5
CARRY = ("tok", "pos", "alive", "emitted")


@pytest.fixture(scope="module")
def models():
    jcfg, jparams = jax_model(PRESET)
    cfg, params = port_model(jcfg, jparams)
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("knobs", [
    dict(overlap=True, prefill="bucketed", prefix_cache=False),
    dict(overlap=True, spec_k=2)], ids=["bucketed", "spec"])
def test_overlap_knobs_validate_as_jax(knobs):
    """overlap=True is ported: with bucketed prefill or a speculative
    round it raises JAX's ValueError, word for word."""
    messages = []
    for config in (ServingConfig, JaxServingConfig):
        with pytest.raises(ValueError, match="overlap") as info:
            config(**knobs)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert ServingConfig(overlap=True).overlap


def _pools(jcfg, n_blocks, bs, kv_dtype, rng):
    """Random per-layer pools as numpy leaves: fp32 values, or int8
    codes and scales quantized from them by JAX's own function."""
    pools = []
    for _ in range(jcfg.n_layers):
        layer = {}
        for name in ("k", "v"):
            x = rng.standard_normal(
                (n_blocks, bs, jcfg.n_kv_heads, jcfg.d_head)).astype(
                    np.float32)
            if kv_dtype is None:
                layer[name] = x
                continue
            codes, scales = jcache.quantize_blocks(jnp.asarray(x), jnp.int8)
            layer[name] = np.asarray(codes)
            layer[f"{name}_scale"] = np.asarray(scales)
        pools.append(layer)
    return pools


def _layout_engine(cfg, params, kv_dtype, micro_k, slots, chunk_tokens):
    """A port engine of the inputs' geometry, for its host write layouts
    (the JAX engine's ``_quant_layout``, line for line)."""
    knobs = serving_knobs(PRESET, slots=slots, micro_k=micro_k,
                          chunk_tokens=chunk_tokens, kv_dtype=kv_dtype)
    return ServingEngine(params, cfg, ServingConfig(**knobs), device=CPU)


def _assert_pools(got, want):
    for g, w in zip(got, want):
        for name, arr in w.items():
            value = g[name].numpy()
            if arr.dtype == np.int8:
                np.testing.assert_array_equal(value, arr)
            else:
                # Block 0 is the scratch block: masked rows of both write
                # it, in an order neither defines.
                np.testing.assert_allclose(value[1:], arr[1:], rtol=0,
                                           atol=ATOL)


def _micro_case(jcfg, micro_k, seed):
    knobs = serving_knobs(PRESET)
    slots, bs = knobs["slots"], knobs["block_size"]
    m = -(-knobs["max_len"] // bs)
    rng = np.random.default_rng(seed)
    pos = np.array([5, 2 * bs + 1, bs - 1, 0][:slots], np.int32)
    blocks = rng.permutation(np.arange(1, knobs["n_blocks"])).astype(np.int32)
    tables = np.zeros((slots, m), np.int32)
    used = 0
    for i in range(slots - 1):
        need = (pos[i] + micro_k) // bs + 1
        tables[i, :need] = blocks[used:used + need]
        used += need
    return dict(
        tok=rng.integers(0, jcfg.vocab_size, size=slots).astype(np.int32),
        pos=pos, alive=np.array([True, True, True, False]),
        emitted=np.array([3, 6, 1, 0], np.int32), tables=tables,
        temps=np.array([0.0, 0.8, 1.1, 0.0], np.float32),
        tops=np.array([1.0, 0.9, 1.0, 1.0], np.float32),
        keys=rng.integers(0, 2**32, size=(slots, 2),
                          dtype=np.uint64).astype(np.uint32),
        n_blocks=knobs["n_blocks"], bs=bs)


def _jax_micro(jcfg, jparams, x, pools, limits, eos, qa, micro_k, sampled):
    head = (jparams, jcfg, *(jnp.asarray(x[k]) for k in CARRY),
            jnp.asarray(x["tables"]), jnp.asarray(limits), jnp.asarray(eos))
    jpools = jax.tree.map(jnp.asarray, pools)
    jqa = None if qa is None else tuple(jnp.asarray(a) for a in qa)
    if sampled:
        out = jmodel.micro_carry_sample(
            *head, jnp.asarray(x["temps"]), jnp.asarray(x["tops"]),
            jnp.asarray(x["keys"]), jpools, jqa, micro_k=micro_k,
            attn_impl="xla")
    else:
        out = jmodel.micro_carry_greedy(*head, jpools, jqa, micro_k=micro_k,
                                        attn_impl="xla")
    toks, carry, new_pools = out[:3]
    return (np.asarray(toks), [np.asarray(c) for c in carry],
            jax.tree.map(np.asarray, new_pools))


def _port_micro(cfg, params, x, pools, limits, eos, qa, micro_k, sampled):
    tpools = [{k: torch.from_numpy(v.copy()) for k, v in layer.items()}
              for layer in pools]
    head = (params, cfg, torch.from_numpy(x["tok"]).long(),
            torch.from_numpy(x["pos"]), torch.from_numpy(x["alive"]),
            torch.from_numpy(x["emitted"]), torch.from_numpy(x["tables"]),
            torch.from_numpy(limits), torch.from_numpy(eos).long())
    tqa = None if qa is None else tuple(torch.from_numpy(a) for a in qa)
    with torch.no_grad():
        if sampled:
            out = tmodel.micro_carry_sample(
                *head, torch.from_numpy(x["temps"]),
                torch.from_numpy(x["tops"]), R.as_key(x["keys"]), tpools,
                tqa, micro_k=micro_k)
        else:
            out = tmodel.micro_carry_greedy(*head, tpools, tqa,
                                            micro_k=micro_k)
    return out[0].numpy(), [c.numpy() for c in out[1]], tpools


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("micro_k", [1, 4])
def test_micro_carry_matches_jax(models, micro_k, sampled, kv_dtype):
    """Slot 0 retires on its eos (found by a free run), slot 1 is one
    token from its absolute limit, slot 2 runs the span, slot 3 is dead:
    the tokens of the live slots and the whole carry equal JAX's."""
    jcfg, jparams, cfg, params = models
    x = _micro_case(jcfg, micro_k, seed=3 + micro_k + 2 * sampled)
    rng = np.random.default_rng(micro_k)
    pools = _pools(jcfg, x["n_blocks"], x["bs"], kv_dtype, rng)
    limits = np.array([50, 7, 50, 0], np.int32)
    eos = np.full(4, -1, np.int32)
    qa = None
    if kv_dtype:
        eng = _layout_engine(cfg, params, kv_dtype, micro_k, 4, 8)
        eng._tables = x["tables"]
        spans = np.minimum(micro_k, limits - x["emitted"]) * x["alive"]
        stacked = eng._micro_quant_layout(np.where(x["alive"], x["pos"], 0),
                                          spans)
        qa = tuple(stacked[k] for k in ("touched", "filled", "wt", "wo"))
    free, _, _ = _jax_micro(jcfg, jparams, x, pools, limits, eos, qa,
                            micro_k, sampled)
    eos[0] = free[min(1, micro_k - 1), 0]
    want, want_carry, want_pools = _jax_micro(
        jcfg, jparams, x, pools, limits, eos, qa, micro_k, sampled)
    got, got_carry, got_pools = _port_micro(
        cfg, params, x, pools, limits, eos.astype(np.int64), qa, micro_k,
        sampled)
    assert got.shape == (micro_k, 4)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    for name, g, w in zip(CARRY, got_carry, want_carry):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert not got_carry[2][0] and not got_carry[2][1]     # retired
    assert got_carry[3][1] == 7                             # at its limit
    _assert_pools(got_pools, want_pools)


def _chunk_case(jcfg, seed):
    """Four slots and eight chunk rows: slots 0 and 1 decode (live), slot
    2's last three prompt tokens complete its prefill in rows 0-2, slot
    3 ingests five mid-prompt tokens in rows 3-7."""
    knobs = serving_knobs(PRESET)
    n, bs, W = knobs["slots"], knobs["block_size"], 8
    m = -(-knobs["max_len"] // bs)
    rng = np.random.default_rng(seed)
    blocks = rng.permutation(np.arange(1, knobs["n_blocks"])).astype(np.int32)
    tables = np.zeros((n, m), np.int32)
    for i in range(n):
        tables[i, :4] = blocks[4 * i:4 * i + 4]
    pos = np.array([9, 2 * bs + 3, 0, 0], np.int32)
    ctoks = rng.integers(0, jcfg.vocab_size, size=W).astype(np.int32)
    cpos = np.array([10, 11, 12, 4, 5, 6, 7, 8], np.int32)
    big = np.zeros((n + W, m), np.int32)
    big[:n] = tables
    big[n:n + 3] = tables[2]
    big[n + 3:] = tables[3]
    return dict(
        tok=rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32),
        pos=pos, alive=np.array([True, True, False, False]),
        emitted=np.array([4, 5, 0, 0], np.int32), ctoks=ctoks, cpos=cpos,
        cvalid=np.ones(W, bool), tables=big,
        prow=np.array([-1, -1, 2, -1], np.int32),
        ppos=np.array([0, 0, 13, 0], np.int32),
        pngen=np.array([0, 0, 0, 0], np.int32),
        temps=np.array([0.0, 0.9] + [0.0, 0.0] + [0.7] * 3 + [0.0] * 5,
                       np.float32),
        tops=np.array([1.0, 0.9] + [1.0] * 2 + [0.8] * 3 + [1.0] * 5,
                      np.float32),
        keys=rng.integers(0, 2**32, size=(n + W, 2),
                          dtype=np.uint64).astype(np.uint32),
        cngen=np.zeros(W, np.int32), n_blocks=knobs["n_blocks"], bs=bs)


_CHUNK_IN = ("ctoks", "cpos", "cvalid", "tables")
_PROMOTE = ("prow", "ppos", "pngen")


def _jax_chunk(jcfg, jparams, x, pools, limits, eos, qa, sampled):
    head = (jparams, jcfg, *(jnp.asarray(x[k]) for k in CARRY),
            *(jnp.asarray(x[k]) for k in _CHUNK_IN), jnp.asarray(limits),
            jnp.asarray(eos), *(jnp.asarray(x[k]) for k in _PROMOTE))
    jpools = jax.tree.map(jnp.asarray, pools)
    jqa = None if qa is None else tuple(jnp.asarray(a) for a in qa)
    if sampled:
        out = jmodel.chunk_carry_sample(
            *head, jnp.asarray(x["temps"]), jnp.asarray(x["tops"]),
            jnp.asarray(x["keys"]), jnp.asarray(x["cngen"]), jpools, jqa,
            attn_impl="xla")
    else:
        out = jmodel.chunk_carry_greedy(*head, jpools, jqa, attn_impl="xla")
    toks, carry, new_pools = out[:3]
    return (np.asarray(toks), [np.asarray(c) for c in carry],
            jax.tree.map(np.asarray, new_pools))


def _port_chunk(cfg, params, x, pools, limits, eos, qa, sampled):
    tpools = [{k: torch.from_numpy(v.copy()) for k, v in layer.items()}
              for layer in pools]
    t = {k: torch.from_numpy(x[k]) for k in CARRY + _CHUNK_IN + _PROMOTE}
    head = (params, cfg, t["tok"].long(), t["pos"], t["alive"],
            t["emitted"], t["ctoks"].long(), t["cpos"], t["cvalid"],
            t["tables"], torch.from_numpy(limits),
            torch.from_numpy(eos).long(), t["prow"], t["ppos"], t["pngen"])
    tqa = None if qa is None else tuple(torch.from_numpy(a) for a in qa)
    with torch.no_grad():
        if sampled:
            out = tmodel.chunk_carry_sample(
                *head, torch.from_numpy(x["temps"]),
                torch.from_numpy(x["tops"]), R.as_key(x["keys"]),
                torch.from_numpy(x["cngen"]).long(), tpools, tqa)
        else:
            out = tmodel.chunk_carry_greedy(*head, tpools, tqa)
    return out[0].numpy(), [c.numpy() for c in out[1]], tpools


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp32", "int8"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_chunk_carry_matches_jax(models, sampled, kv_dtype):
    """Row 0 retires on its eos, row 1 reaches its absolute limit, slot 2
    completes its prefill and is promoted into the carry with its first
    token (alive, at its target, emitted 1), slot 3 stays mid-prompt and
    dead: the tokens of the live and chunk rows and the carry equal
    JAX's."""
    jcfg, jparams, cfg, params = models
    x = _chunk_case(jcfg, seed=11 + sampled)
    rng = np.random.default_rng(5)
    pools = _pools(jcfg, x["n_blocks"], x["bs"], kv_dtype, rng)
    limits = np.array([30, 6, 9, 9], np.int32)
    eos = np.full(4, -1, np.int32)
    qa = None
    if kv_dtype:
        eng = _layout_engine(cfg, params, kv_dtype, 1, 4, 8)
        rpos = np.concatenate([np.where(x["alive"], x["pos"], 0), x["cpos"]])
        rvalid = np.concatenate([x["alive"], x["cvalid"]])
        qa = eng._quant_layout(x["tables"], rpos[:, None], rvalid[:, None])
    free, _, _ = _jax_chunk(jcfg, jparams, x, pools, limits, eos, qa,
                            sampled)
    eos[0] = free[0]
    want, want_carry, want_pools = _jax_chunk(jcfg, jparams, x, pools,
                                              limits, eos, qa, sampled)
    got, got_carry, got_pools = _port_chunk(
        cfg, params, x, pools, limits, eos.astype(np.int64), qa, sampled)
    np.testing.assert_array_equal(got, want)
    for name, g, w in zip(CARRY, got_carry, want_carry):
        np.testing.assert_array_equal(g, w, err_msg=name)
    tok, pos, alive, emitted = got_carry
    assert alive.tolist() == [False, False, True, False]
    assert (tok[2], pos[2], emitted[2]) == (got[4 + 2], 13, 1)
    _assert_pools(got_pools, want_pools)
