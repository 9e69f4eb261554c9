"""The port's bucketed-prefill program (``model.paged_prefill``) against the
JAX package's on the same numpy inputs, on the CPU.

One request's prompt, right-padded to a bucket, through both packages'
``paged_prefill`` over the same pools and a fragmented block table: a
prompt that ends mid-block, one that fills its last block exactly, and one
whose row carries a LoRA adapter; on the ``micro`` and ``moe`` presets and
the INT8_PIN geometry; over fp32, bf16, int8, fp8 and int4 pools.
Tolerances: at fp32 the logits within 1e-5 and the pools within 2e-5 on
the prompt's rows; quantized codes bit-identical and scales within 1e-6
relative over every block the prompt wrote. At bf16 both packages round
their bf16 intermediates in different places, so the logits and pools are
held within 2^-6 of the tensor's largest magnitude, as the port's other
bf16 tests do (``tests/test_torch_serving_spec.py``). Every block the
table does not hold is left as it was, and the port writes its pools in
place: the same tensors, never rebound."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import cache as jc
from tpu_task.ml.serving import model as jmodel
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.serving import cache as tc
from tpu_task_torch.ml.serving import model as tmodel
from torch_port_util import jax_model, port_config

LOGIT_ATOL = 1e-5
POOL_ATOL = 2e-5
SCALE_RTOL = 1e-6
BF16_REL = 2.0 ** -6
BS = 4
MAX_BLOCKS = 12
N_BLOCKS = 40
RANK = 4

#: (kv_dtype, JAX code dtype, port code dtype)
CODES = {"int8": (jnp.int8, torch.int8),
         "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
         "int4": (jnp.uint8, torch.uint8)}

#: The INT8_PIN geometry of ``tests/test_paged_attention.py``.
INT8_PIN = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=4,
                d_head=16, d_ff=256, n_kv_heads=2)

#: (prompt length, bucket, LoRA row)
PROMPTS = {"mid_block": (2 * BS + 3, 16, False),
           "full_block": (3 * BS, 16, False),
           "lora": (BS + 1, 8, True)}


@pytest.fixture(scope="module")
def geometries():
    """name → (JAX cfg, JAX params at fp32)."""
    out = {name: jax_model(name) for name in ("micro", "moe")}
    cfg = jtf.TransformerConfig(dtype=jnp.float32, **INT8_PIN)
    out["int8_pin"] = (cfg, jtf.init(jax.random.PRNGKey(5), cfg))
    return out


def _models(geometry, kind):
    """(JAX cfg, JAX params, port cfg, port params) at the pools' model
    dtype: bf16 for ``kind == "bfloat16"``, else fp32."""
    jcfg, jparams = geometry
    bf16 = kind == "bfloat16"
    if bf16:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    cfg = port_config(jcfg, torch.bfloat16 if bf16 else torch.float32)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    return jcfg, jparams, cfg, ttf.params_from_jax(tree, cfg, "cpu")


def _inputs(jcfg, length, bucket, seed):
    rng = np.random.default_rng(seed)
    spread = rng.lognormal(0, 1, (N_BLOCKS, 1, jcfg.n_kv_heads, 1))
    pools = [{name: (rng.standard_normal(
                  (N_BLOCKS, BS, jcfg.n_kv_heads, jcfg.d_head)) * spread
              ).astype(np.float32) for name in ("k", "v")}
             for _ in range(jcfg.n_layers)]
    need = -(-length // BS)
    table = np.zeros((MAX_BLOCKS,), np.int32)
    table[:need] = rng.permutation(np.arange(1, N_BLOCKS))[:need]
    tokens = np.zeros((1, bucket), np.int32)
    tokens[0] = rng.integers(0, jcfg.vocab_size, bucket)   # pads too
    lora = rng.standard_normal((3, jcfg.n_layers, 2, RANK, jcfg.d_model))
    return tokens, table, pools, lora.astype(np.float32)


def _pools_for(kind, pools):
    """Both packages' pools from the same values: model-dtype values, or
    the JAX package's codes and scales (the port's codes are its bytes)."""
    if kind in ("float32", "bfloat16"):
        jdt = jnp.float32 if kind == "float32" else jnp.bfloat16
        tdt = torch.float32 if kind == "float32" else torch.bfloat16
        return ([{k: jnp.asarray(v).astype(jdt) for k, v in layer.items()}
                 for layer in pools],
                [{k: torch.tensor(v).to(tdt) for k, v in layer.items()}
                 for layer in pools])
    jdt, tdt = CODES[kind]
    jpools, tpools = [], []
    for layer in pools:
        jl = {}
        for name in ("k", "v"):
            jl[name], jl[name + "_scale"] = jc.quantize_blocks(
                jnp.asarray(layer[name]), jdt)
        jpools.append(jl)
        tpools.append({k: (torch.tensor(np.asarray(v).view(np.uint8))
                           .view(tdt) if k in ("k", "v")
                           else torch.tensor(np.asarray(v)))
                       for k, v in jl.items()})
    return jpools, tpools


def _lora(lora, n_layers, jdt, tdt):
    """The adapter pool (block 0 the zero scratch block, then one block a
    layer of one adapter) and the row's tables for both packages."""
    pool = np.zeros((1 + n_layers, 2, RANK, lora.shape[-1]), np.float32)
    pool[1:] = lora[0]
    blocks = np.arange(1, 1 + n_layers, dtype=np.int32)[None]
    scale = np.array([0.75], np.float32)
    return ((jnp.asarray(pool).astype(jdt), jnp.asarray(blocks),
             jnp.asarray(scale)),
            (torch.tensor(pool).to(tdt), torch.tensor(blocks).long(),
             torch.tensor(scale)))


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.view(torch.uint8) if x.element_size() == 1
                else x.float()).numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype.itemsize == 1 else x.astype(
        np.float32)


def _skip_fp8(kind):
    if kind == "fp8" and not (jc.fp8_supported() and tc.fp8_supported()):
        pytest.skip("float8_e4m3fn is not supported by both packages here")


@pytest.mark.parametrize("prompt", sorted(PROMPTS))
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "fp8",
                                  "int4"])
@pytest.mark.parametrize("geometry", ["micro", "moe", "int8_pin"])
def test_paged_prefill_matches_jax(geometries, geometry, kind, prompt):
    _skip_fp8(kind)
    length, bucket, with_lora = PROMPTS[prompt]
    jcfg, jparams, cfg, params = _models(geometries[geometry], kind)
    tokens, table, pools, lora = _inputs(jcfg, length, bucket, seed=length)
    jpools, tpools = _pools_for(kind, pools)
    if with_lora:
        jl, tl = _lora(lora, jcfg.n_layers, jcfg.dtype, cfg.dtype)
        jparams, params = {**jparams, "lora": jl}, {**params, "lora": tl}
    before = [{k: v.clone() for k, v in layer.items()} for layer in tpools]
    identity = [{k: (v, v.data_ptr()) for k, v in layer.items()}
                for layer in tpools]
    quantized = kind in CODES

    want = jax.jit(lambda p, t, n, tb, pl: jmodel.paged_prefill(
        p, jcfg, t, n, tb, pl, measure_qerr=True))(
        jparams, jnp.asarray(tokens), jnp.int32(length),
        jnp.asarray(table), jpools)
    got = tmodel.paged_prefill(params, cfg, torch.tensor(tokens).long(),
                               length, torch.tensor(table), tpools,
                               measure_qerr=True)
    if quantized:
        got_logits, got_err = got
        want_logits, want_pools, want_err = want
        assert float(got_err) > 0.0
        np.testing.assert_allclose(float(got_err), float(want_err),
                                   rtol=1e-4)
    else:
        got_logits, (want_logits, want_pools) = got, want
    assert got_logits.dtype == torch.float32
    assert got_logits.shape == (1, jcfg.vocab_size)
    want_logits = np.asarray(want_logits)
    bf16 = kind == "bfloat16"
    atol = (BF16_REL * float(np.abs(want_logits).max()) if bf16
            else LOGIT_ATOL)
    np.testing.assert_allclose(got_logits.numpy(), want_logits, rtol=0,
                               atol=atol)

    need = -(-length // BS)
    held = table[:need].astype(np.int64)
    untouched = np.setdiff1d(np.arange(1, N_BLOCKS), held)
    pos = np.arange(length)
    for layer, (gl, wl, bl, il) in enumerate(zip(tpools, want_pools, before,
                                                 identity)):
        for name, leaf in gl.items():
            # In place: the same tensor object and storage.
            assert leaf is il[name][0] and leaf.data_ptr() == il[name][1]
            np.testing.assert_array_equal(_as_f32(leaf)[untouched],
                                          _as_f32(bl[name])[untouched])
            g, w = _as_f32(leaf), _as_f32(wl[name])
            if name.endswith("_scale"):
                np.testing.assert_allclose(g[held], w[held],
                                           rtol=SCALE_RTOL, atol=0)
            elif quantized:
                np.testing.assert_array_equal(g[held], w[held])
            else:
                rows_g = g[table[pos // BS], pos % BS]
                rows_w = w[table[pos // BS], pos % BS]
                tol = (BF16_REL * float(np.abs(rows_w).max()) if bf16
                       else POOL_ATOL)
                np.testing.assert_allclose(rows_g, rows_w, rtol=0, atol=tol)


def test_paged_prefill_refuses_an_overflow(geometries):
    jcfg, _, cfg, params = _models(geometries["micro"], "float32")
    tokens, table, pools, _ = _inputs(jcfg, 4, 8, seed=0)
    _, tpools = _pools_for("float32", pools)
    with pytest.raises(ValueError, match="prefill overflow"):
        tmodel.paged_prefill(params, cfg, torch.zeros((1, 64)).long(),
                             MAX_BLOCKS * BS + 1, torch.tensor(table),
                             tpools)


def test_lora_scratch_row_is_exactly_base(geometries):
    """A row bound to the zero scratch block at scale 0 gives the base
    program's logits bit for bit (the rank-0 no-op)."""
    jcfg, _, cfg, params = _models(geometries["micro"], "float32")
    tokens, table, pools, lora = _inputs(jcfg, 7, 8, seed=3)
    _, (pool, _, _) = _lora(lora, jcfg.n_layers, jnp.float32, torch.float32)
    scratch = {**params, "lora": (pool, torch.zeros((1, cfg.n_layers),
                                                    dtype=torch.int64),
                                  torch.zeros((1,)))}
    outs = []
    for p in (params, scratch):
        _, tpools = _pools_for("float32", pools)
        outs.append(tmodel.paged_prefill(p, cfg, torch.tensor(tokens).long(),
                                         7, torch.tensor(table), tpools))
    assert torch.equal(outs[0], outs[1])
