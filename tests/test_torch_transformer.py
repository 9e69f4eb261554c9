"""The port's transformer (``tpu_task_torch.ml.models.transformer``) against
the JAX package's, at fp32 on the CPU, from the same weights.

The weight bridge round-trips bit for bit. Norm, rope, one block and the
whole forward agree within ATOL: the two frameworks sum matrix products
(and reductions) in different orders, which moves float32 results by a
few ulps of values of order one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.models import transformer as jtf
from tpu_task_torch.ml.models import transformer as ttf
from torch_port_util import jax_model, port_config, port_model

ATOL = 1e-5


@pytest.fixture(scope="module", params=["micro", "tiny"])
def models(request):
    jcfg, jparams = jax_model(request.param)
    cfg, params = port_model(jcfg, jparams)
    return jcfg, jparams, cfg, params


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


def test_params_round_trip_bit_exact(models):
    jcfg, jparams, cfg, params = models
    back = ttf.params_to_numpy(params)
    flat_j, tree_j = jax.tree.flatten(jax.tree.map(np.asarray, jparams))
    flat_p, tree_p = jax.tree.flatten(back)
    assert tree_j == tree_p
    for a, b in zip(flat_j, flat_p):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    again = ttf.params_to_numpy(ttf.params_from_jax(back, cfg))
    for a, b in zip(flat_p, jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_params_from_jax_checks_shapes(models):
    jcfg, jparams, cfg, _ = models
    wrong = ttf.TransformerConfig(**{**cfg.__dict__, "d_ff": cfg.d_ff * 2})
    with pytest.raises(ValueError, match="w_gate"):
        ttf.params_from_jax(jax.tree.map(np.asarray, jparams), wrong)


def test_init_shapes_and_moe_refused():
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                                n_heads=4, d_head=8, d_ff=64, n_kv_heads=2,
                                dtype=torch.float32)
    params = ttf.init(torch.Generator().manual_seed(0), cfg)
    ref = jtf.init(jax.random.PRNGKey(0), jtf.TransformerConfig(
        vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
        d_ff=64, n_kv_heads=2))
    assert [tuple(p.shape) for p in jax.tree.leaves(params)] == \
        [tuple(p.shape) for p in jax.tree.leaves(ref)]
    # Mixture-of-experts layers (ported): the same leaves and shapes, a
    # router, w_in and w_out in place of every second layer's dense FFN.
    moe = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_head=8,
               d_ff=64, n_kv_heads=2, moe_every=2, n_experts=4)
    params = ttf.init(torch.Generator().manual_seed(0),
                      ttf.TransformerConfig(dtype=torch.float32, **moe))
    ref = jtf.init(jax.random.PRNGKey(0), jtf.TransformerConfig(**moe))
    assert jax.tree.structure(params) == jax.tree.structure(ref)
    assert [tuple(p.shape) for p in jax.tree.leaves(params)] == \
        [tuple(p.shape) for p in jax.tree.leaves(ref)]
    assert tuple(params["layers"][1]["w_in"].shape) == (4, 32, 64)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32)
    _close(ttf._rmsnorm(torch.tensor(x), torch.tensor(scale)),
           jtf._rmsnorm(jnp.asarray(x), jnp.asarray(scale)))


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 6, 4, 16)).astype(np.float32)
    if per_row:                     # (b, s): every row at its own depth
        pos = rng.integers(0, 500, size=(3, 6)).astype(np.int32)
    else:                           # (s,): shared offsets
        pos = (np.arange(6) + 37).astype(np.int32)
    _close(ttf._rope(torch.tensor(x), 10000.0, torch.tensor(pos)),
           jtf._rope(jnp.asarray(x), 10000.0, jnp.asarray(pos)))
    _close(ttf._rope(torch.tensor(x), 10000.0),
           jtf._rope(jnp.asarray(x), 10000.0))


def test_block(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)

    def jattn(q, k, v):
        from tpu_task.ml.ops.attention import mha_reference
        return mha_reference(q, jtf.expand_kv(k, jcfg.n_heads),
                             jtf.expand_kv(v, jcfg.n_heads), True)

    ref, _ = jtf._block(jnp.asarray(x), jparams["layers"][0], jcfg, jattn)
    from tpu_task_torch.ml.ops.attention import expand_kv_heads, mha_reference

    def tattn(q, k, v):
        return mha_reference(q, expand_kv_heads(k, cfg.n_heads),
                             expand_kv_heads(v, cfg.n_heads), True)

    _close(ttf._block(torch.tensor(x), params["layers"][0], cfg, tattn)[0],
           ref)


def test_apply_logits(models):
    jcfg, jparams, cfg, params = models
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    ref = jtf.apply(jparams, jcfg, jnp.asarray(tokens))
    got = ttf.apply(params, cfg, torch.tensor(tokens, dtype=torch.int64))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    _close(got, ref)


def test_bf16_config_stores_weights_in_bf16(models):
    jcfg, jparams, _, _ = models
    cfg = port_config(jcfg, torch.bfloat16)
    params = ttf.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    assert all(p.dtype == torch.bfloat16 for p in jax.tree.leaves(params))
    # The stored value is exactly JAX's use-site cast.
    np.testing.assert_array_equal(
        params["layers"][0]["wq"].float().numpy(),
        np.asarray(jparams["layers"][0]["wq"].astype(jnp.bfloat16)
                   .astype(jnp.float32)))
