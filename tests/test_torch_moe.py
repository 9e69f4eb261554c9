"""The port's mixture-of-experts FFN (``tpu_task_torch.ml.models.moe``)
and the transformer's MoE layers against the JAX package's, on the CPU.

The router, the aux loss and the dense dispatch at top-1 and top-2 within
1e-5 at fp32 (expert choices equal); equal router columns, where both
packages give the tie to the lower expert index; bf16 activations over
fp32 weights, whose output type and values follow JAX's promotion; the
router jitter drawn from JAX's own normal; a MoE block, the features'
mean aux and the loss with its aux term; ``init_from_key`` of a MoE config
equal to JAX's ``init`` bit for bit and the param tree crossing both ways;
the MoE FLOP model; and ``serving_moe_fn``'s resolution."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.models import moe as jmoe
from tpu_task.ml.models import transformer as jtf
from tpu_task.obs import goodput as jgoodput
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.models import moe as tmoe
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.ops.attention import expand_kv_heads, mha_reference
from tpu_task_torch.ml.parallel.mesh import Mesh
from tpu_task_torch.ml.serving.model import serving_moe_fn
from tpu_task_torch.obs import goodput as tgoodput
from torch_port_util import port_config, port_model

TOL = 1e-5


def _moe_cfgs(top_k, n_experts=4, noise=0.0):
    kw = dict(d_model=16, d_ff=24, n_experts=n_experts, top_k=top_k,
              router_noise=noise)
    return jmoe.MoEConfig(**kw), tmoe.MoEConfig(**kw)


def _weights(n_experts=4, seed=0):
    """JAX ``moe.init`` weights as numpy (router scaled up so the routing
    is decided well above fp32 rounding)."""
    jcfg, _ = _moe_cfgs(1, n_experts)
    w = jax.tree.map(np.asarray,
                     jmoe.init(jax.random.PRNGKey(seed), jcfg))
    return {**w, "router": w["router"] * 4}


def _t(tree, dtype=None):
    return {k: torch.tensor(v) if dtype is None else
            torch.tensor(v).to(dtype) for k, v in tree.items()}


def _x(shape=(2, 9, 16), seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("top_k", [1, 2])
def test_route_and_aux_match_jax(top_k):
    jcfg, tcfg = _moe_cfgs(top_k)
    w = _weights()
    tokens = _x((40, 16))
    j_idx, j_gate, j_stats = jmoe._route(jnp.asarray(tokens),
                                         jnp.asarray(w["router"]), jcfg)
    t_idx, t_gate, t_stats = tmoe._route(torch.tensor(tokens),
                                         torch.tensor(w["router"]), tcfg)
    assert t_idx.shape == (40, top_k)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_gate.numpy(), np.asarray(j_gate), atol=TOL)
    for t, j in zip(t_stats, j_stats):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL)
    np.testing.assert_allclose(
        float(tmoe._aux_from_stats(t_stats, tcfg)),
        float(jmoe._aux_from_stats(j_stats, jcfg)), atol=TOL)


@pytest.mark.parametrize("n_experts", [4, 8])
@pytest.mark.parametrize("top_k", [1, 2])
def test_apply_dense_matches_jax(top_k, n_experts):
    jcfg, tcfg = _moe_cfgs(top_k, n_experts)
    w = _weights(n_experts, seed=top_k)
    x = _x(seed=n_experts)
    j_out, j_aux = jmoe.apply_dense(jax.tree.map(jnp.asarray, w), jcfg,
                                    jnp.asarray(x))
    t_out, t_aux = tmoe.apply_dense(_t(w), tcfg, torch.tensor(x))
    assert t_out.dtype == torch.float32 and t_out.shape == x.shape
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=TOL)
    assert t_aux.dtype == torch.float32 and t_aux.dim() == 0
    np.testing.assert_allclose(float(t_aux), float(j_aux), atol=TOL)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_ties_go_to_the_lower_expert_index(top_k):
    """Columns 1 and 2 of the router are equal and win every token;
    a zero router ties every expert. Both packages take the lower index
    first, and the outputs agree."""
    jcfg, tcfg = _moe_cfgs(top_k)
    w = _weights()
    x = np.abs(_x())
    tied = np.zeros_like(w["router"])
    tied[:, 1] = tied[:, 2] = 1.0
    for router, want in ((tied, [1, 2]), (np.zeros_like(tied), [0, 1])):
        case = {**w, "router": router}
        tokens = x.reshape(-1, 16)
        j_idx, _, _ = jmoe._route(jnp.asarray(tokens), jnp.asarray(router),
                                  jcfg)
        t_idx, t_gate, _ = tmoe._route(torch.tensor(tokens),
                                       torch.tensor(router), tcfg)
        np.testing.assert_array_equal(np.asarray(j_idx),
                                      np.tile(want[:top_k], (len(tokens), 1)))
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        if top_k == 2:       # two equal probabilities renormalize to halves
            assert torch.all(t_gate == 0.5)
        j_out, _ = jmoe.apply_dense(jax.tree.map(jnp.asarray, case), jcfg,
                                    jnp.asarray(x))
        t_out, _ = tmoe.apply_dense(_t(case), tcfg, torch.tensor(x))
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   atol=TOL)


def test_bf16_activations_over_fp32_weights_follow_jax_promotion():
    """The router and expert products promote to fp32 as JAX's do: the
    output is fp32 in both, within fp32 rounding of each other; bf16
    weights keep everything bf16."""
    jcfg, tcfg = _moe_cfgs(2)
    w = _weights()
    x = _x()
    xb_j = jnp.asarray(x).astype(jnp.bfloat16)
    xb_t = torch.tensor(x).to(torch.bfloat16)
    np.testing.assert_array_equal(
        np.asarray(xb_j.astype(jnp.float32)), xb_t.float().numpy())
    j_out, j_aux = jmoe.apply_dense(jax.tree.map(jnp.asarray, w), jcfg, xb_j)
    t_out, t_aux = tmoe.apply_dense(_t(w), tcfg, xb_t)
    assert j_out.dtype == jnp.float32 and t_out.dtype == torch.float32
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), atol=TOL)
    jw = jax.tree.map(lambda v: jnp.asarray(v).astype(jnp.bfloat16), w)
    j_out, _ = jmoe.apply_dense(jw, jcfg, xb_j)
    t_out, _ = tmoe.apply_dense(_t(w, torch.bfloat16), tcfg, xb_t)
    assert j_out.dtype == jnp.bfloat16 and t_out.dtype == torch.bfloat16
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out.astype(jnp.float32)),
                               atol=0.05, rtol=0.02)


@pytest.mark.parametrize("top_k", [1, 2])
def test_router_jitter_is_jax_draw(top_k):
    """With zero activations the logits are the jitter alone, so the
    expert choices are decided by the normal draw: the port's equal JAX's
    for the same key, and the dense outputs agree."""
    jcfg, tcfg = _moe_cfgs(top_k, n_experts=8, noise=1.0)
    w = _weights(8)
    tokens = np.zeros((64, 16), np.float32)
    for seed in (3, 11):
        j_idx, j_gate, _ = jmoe._route(
            jnp.asarray(tokens), jnp.asarray(w["router"]), jcfg,
            rng=jax.random.PRNGKey(seed))
        t_idx, t_gate, _ = tmoe._route(
            torch.tensor(tokens), torch.tensor(w["router"]), tcfg,
            rng=R.PRNGKey(seed))
        np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
        np.testing.assert_allclose(t_gate.numpy(), np.asarray(j_gate),
                                   atol=1e-6)
    x = _x()
    j_out, j_aux = jmoe.apply_dense(jax.tree.map(jnp.asarray, w), jcfg,
                                    jnp.asarray(x), rng=jax.random.PRNGKey(5))
    t_out, t_aux = tmoe.apply_dense(_t(w), tcfg, torch.tensor(x),
                                    rng=R.PRNGKey(5))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), atol=TOL)


def test_init_matches_jax_shapes_scales_and_dtype():
    jcfg, tcfg = _moe_cfgs(2, n_experts=8)
    want = jmoe.init(jax.random.PRNGKey(0), jcfg)
    got = tmoe.init(torch.Generator().manual_seed(0), tcfg)
    assert set(got) == set(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape
        assert got[name].dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(float(got[name].std()),
                                   float(jnp.std(w)), rtol=0.1)


# -- the transformer's MoE layers -------------------------------------------

#: Every second layer MoE: 4 experts, top-2 (``moe_every`` 2 of 4 layers).
JCFG = jtf.TransformerConfig(
    vocab_size=64, d_model=32, n_layers=4, n_heads=4, d_head=8, d_ff=48,
    n_kv_heads=2, dtype=jnp.float32, moe_every=2, n_experts=4, moe_top_k=2)


@pytest.fixture(scope="module")
def models():
    jparams = jtf.init(jax.random.PRNGKey(0), JCFG)
    cfg, params = port_model(JCFG, jparams)
    return jparams, cfg, params


def test_config_rules_match_jax():
    cfg = port_config(JCFG)
    assert [cfg.is_moe_layer(i) for i in range(6)] == \
        [JCFG.is_moe_layer(i) for i in range(6)] == [False, True] * 3
    assert cfg.moe_cfg.__dict__ == {**JCFG.moe_cfg.__dict__}
    bad = ttf.TransformerConfig(moe_every=2, n_experts=1)
    with pytest.raises(ValueError, match="n_experts >= 2"):
        bad.is_moe_layer(1)
    assert not ttf.TransformerConfig().is_moe_layer(1)


@pytest.mark.parametrize("seed", [0, 5])
def test_init_from_key_matches_jax_bit_for_bit(seed):
    want = jax.tree.map(np.asarray, jtf.init(jax.random.PRNGKey(seed), JCFG))
    got = ttf.init_from_key(R.PRNGKey(seed), port_config(JCFG))
    assert set(got["layers"][1]) == set(want["layers"][1]) >= {
        "router", "w_in", "w_out"}
    flat_g = jax.tree.leaves(ttf.params_to_numpy(got))
    flat_w = jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))


def test_params_cross_both_ways_and_shapes_are_checked(models):
    jparams, cfg, params = models
    back = ttf.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tree = jax.tree.map(np.asarray, jparams)
    dense = ttf.TransformerConfig(**{**cfg.__dict__, "moe_every": 0})
    with pytest.raises(ValueError, match="w_gate"):
        ttf.params_from_jax(tree, dense)
    wide = ttf.TransformerConfig(**{**cfg.__dict__, "n_experts": 8})
    with pytest.raises(ValueError, match="router"):
        ttf.params_from_jax(tree, wide)
    shapes = [tuple(p.shape) for p in jax.tree.leaves(
        ttf.init(torch.Generator().manual_seed(0), cfg))]
    assert shapes == [tuple(np.shape(p)) for p in jax.tree.leaves(jparams)]


def _attn_pair(n_heads):
    from tpu_task.ml.ops.attention import mha_reference as jmha

    def jattn(q, k, v):
        return jmha(q, jtf.expand_kv(k, n_heads), jtf.expand_kv(v, n_heads),
                    True)

    def tattn(q, k, v):
        return mha_reference(q, expand_kv_heads(k, n_heads),
                             expand_kv_heads(v, n_heads), True)

    return jattn, tattn


def test_moe_block_features_and_loss_match_jax(models):
    jparams, cfg, params = models
    jattn, tattn = _attn_pair(cfg.n_heads)
    x = _x((2, 7, 32), seed=4)
    for i in (0, 1):
        j_x, j_aux = jtf._block(jnp.asarray(x), jparams["layers"][i], JCFG,
                                jattn)
        t_x, t_aux = ttf._block(torch.tensor(x), params["layers"][i], cfg,
                                tattn)
        np.testing.assert_allclose(t_x.numpy(), np.asarray(j_x), atol=TOL)
        assert t_aux.dtype == torch.float32
        np.testing.assert_allclose(float(t_aux), float(j_aux), atol=TOL)
    assert float(t_aux) > 0 and float(j_aux) > 0
    tokens = np.random.default_rng(6).integers(0, 64, size=(2, 12))
    j_f, j_aux = jtf.apply_features_with_aux(jparams, JCFG,
                                             jnp.asarray(tokens),
                                             attn_fn=jattn)
    t_f, t_aux = ttf.apply_features_with_aux(params, cfg,
                                             torch.tensor(tokens),
                                             attn_fn=tattn)
    np.testing.assert_allclose(t_f.numpy(), np.asarray(j_f), atol=TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), atol=TOL)
    for fused in (True, False):
        j_loss = jtf.loss_fn(jparams, JCFG, jnp.asarray(tokens),
                             attn_fn=jattn, fused=fused)
        t_loss = ttf.loss_fn(params, cfg, torch.tensor(tokens),
                             attn_fn=tattn, fused=fused)
        np.testing.assert_allclose(float(t_loss), float(j_loss), atol=TOL)
    # The aux term is in it: weight 0 leaves the cross-entropy alone, and
    # the loss's aux is that of its inputs, tokens[:, :-1].
    flat = ttf.TransformerConfig(**{**cfg.__dict__, "moe_aux_weight": 0.0})
    xent = ttf.loss_fn(params, flat, torch.tensor(tokens), attn_fn=tattn)
    _, aux = ttf.apply_features_with_aux(
        params, cfg, torch.tensor(tokens[:, :-1]), attn_fn=tattn)
    np.testing.assert_allclose(float(t_loss) - float(xent),
                               cfg.moe_aux_weight * float(aux), atol=1e-6)


def test_moe_fn_replaces_the_dense_dispatch(models):
    _, cfg, params = models
    _, tattn = _attn_pair(cfg.n_heads)
    tokens = torch.tensor(np.random.default_rng(7).integers(0, 64, (1, 6)))
    seen = []

    def moe_fn(layer, h):
        seen.append(h.shape)
        return torch.zeros_like(h), torch.ones((), dtype=torch.float32)

    _, aux = ttf.apply_features_with_aux(params, cfg, tokens, attn_fn=tattn,
                                         moe_fn=moe_fn)
    assert seen == [(1, 6, 32)] * 2 and float(aux) == 1.0


@pytest.mark.parametrize("top_k", [1, 2])
def test_flop_model_counts_top_k_experts_as_jax(top_k):
    jcfg = jtf.TransformerConfig(**{**JCFG.__dict__, "moe_top_k": top_k})
    cfg = port_config(jcfg)
    assert tgoodput.matmul_params(cfg) == jgoodput.matmul_params(jcfg)
    dense = jtf.TransformerConfig(**{**JCFG.__dict__, "moe_every": 0})
    assert tgoodput.matmul_params(cfg) != jgoodput.matmul_params(dense)
    for kv_len in (0, 1, 17, 1000):
        assert tgoodput.token_flops(cfg, kv_len) == \
            jgoodput.token_flops(jcfg, kv_len)
    positions = np.random.default_rng(0).integers(0, 128, size=(3, 5))
    assert tgoodput.flops_for_positions(cfg, positions) == \
        jgoodput.flops_for_positions(jcfg, positions)


def test_serving_moe_fn_resolves_as_jax():
    cfg = port_config(JCFG)
    assert serving_moe_fn(cfg, None) is None
    assert serving_moe_fn(port_config(jtf.TransformerConfig()), object()) \
        is None
    # JAX's rule over a mesh: nothing to dispatch at ep 1 (the dense
    # dispatch, completed over tp), the expert-parallel one at ep > 1.
    assert serving_moe_fn(cfg, Mesh((2, 1), ("tp", "ep"))) is None
    assert callable(serving_moe_fn(cfg, Mesh((1, 2), ("tp", "ep"))))
    assert callable(serving_moe_fn(cfg, Mesh((2, 2), ("tp", "ep"))))
