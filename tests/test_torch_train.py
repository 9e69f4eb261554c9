"""The port's training path (``tpu_task_torch.ml.train`` and the loss in
``tpu_task_torch.ml.models.transformer``) against the JAX package's, at
fp32 on the CPU, from the same numpy weights and tokens.

The JAX step runs its attention through the Pallas kernel pair in
interpret mode; the port's runs through ``FlashAttention``, whose wrappers
take the plain versions on a CPU tensor. Tolerances, each for fp32 sums
taken in another order: the embedding gradient, the loss and the fused
cross-entropy gradients within 1e-5; after three AdamW steps, every
parameter within 2e-5 (the updates are lr-sized, 3e-4, and Adam divides
each gradient by its own magnitude, so the port's last-bit gradient
differences reach the weights only scaled by lr)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml import train as jtrain
from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.ops.attention import _pallas_attention
from tpu_task_torch.ml import train as ttrain
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.parallel.sharding import PartitionSpec

ATOL = 1e-5
PARAM_ATOL = 2e-5

TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_head=16,
            d_ff=128, n_kv_heads=2)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(
        port.detach().to(torch.float32).numpy(),
        np.asarray(ref, dtype=np.float32), rtol=0, atol=atol)


def _configs(**over):
    kw = {**TINY, **over}
    return (jtf.TransformerConfig(dtype=jnp.float32, **kw),
            ttf.TransformerConfig(dtype=torch.float32, **kw))


def _jax_attn(jcfg):
    """The JAX step's attention as its own tests run it: the Pallas
    kernel pair in interpret mode, over expanded kv heads."""
    def attn(q, k, v):
        return _pallas_attention(q, jtf.expand_kv(k, jcfg.n_heads),
                                 jtf.expand_kv(v, jcfg.n_heads), True, True)
    return attn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_matches_jax(dtype):
    """Gather forward; the table gradient sums repeated tokens in f32 and
    rounds once to the table's type, as JAX's one-hot contraction does."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    tokens = rng.integers(0, 50, size=(3, 40)).astype(np.int32)
    g = rng.normal(size=(3, 40, 16)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jt = jnp.asarray(table).astype(jdt)
    out, vjp = jax.vjp(lambda t: jtf.embed_lookup(t, jnp.asarray(tokens)), jt)
    (ref_grad,) = vjp(jnp.asarray(g).astype(jdt))
    tt = torch.tensor(table).to(tdt).requires_grad_(True)
    got = ttf.embed_lookup(tt, torch.tensor(tokens, dtype=torch.int64))
    got.backward(torch.tensor(g).to(tdt))
    assert tt.grad.dtype == tdt
    _close(got, out, 0.0)
    # bf16: each sum is rounded once from f32, so both sides agree to the
    # rounding of sums taken in another order.
    _close(tt.grad, ref_grad, ATOL if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("vocab,block", [(256, None), (300, 128),
                                         (4096 + 50, 4096)],
                         ids=["one-block", "three-padded", "two-padded"])
def test_fused_xent_matches_jax(vocab, block):
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(37, 32)).astype(np.float32)
    unembed = (rng.normal(size=(32, vocab)) * 0.2).astype(np.float32)
    targets = rng.integers(0, vocab, size=(37,)).astype(np.int32)
    targets[:3] = vocab - 1                      # the last, padded block

    def jloss(f, u):
        return jtf.fused_xent(f, u, jnp.asarray(targets), block=block)

    ref, (ref_df, ref_du) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(unembed))
    tf_ = torch.tensor(feats, requires_grad=True)
    tu = torch.tensor(unembed, requires_grad=True)
    loss = ttf.fused_xent(tf_, tu, torch.tensor(targets, dtype=torch.int64),
                          block=block)
    loss.backward()
    _close(loss, ref)
    _close(tf_.grad, ref_df)
    _close(tu.grad, ref_du)


def test_auto_xent_block_is_the_jax_packages():
    for n, vocab in [(8192, 32768), (8, 256), (32768, 32768), (1 << 20, 5000),
                     (100, 70000)]:
        assert ttf._auto_xent_block(n, vocab) == jtf._auto_xent_block(
            n, vocab)
    # The flagship's 8192 tokens take the whole vocab in one step.
    assert ttf._auto_xent_block(8 * 1024, 32768) == 32768


def test_loss_fn_matches_jax_fused_and_unfused():
    jcfg, cfg = _configs()
    jparams = jtf.init(jax.random.PRNGKey(3), jcfg)
    params = ttf.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 param_dtype=torch.float32)
    tokens = np.random.default_rng(3).integers(
        0, 256, size=(2, 129)).astype(np.int32)
    ref = jtf.loss_fn(jparams, jcfg, jnp.asarray(tokens),
                      attn_fn=_jax_attn(jcfg))
    fused = ttf.loss_fn(params, cfg, torch.tensor(tokens))
    unfused = ttf.loss_fn(params, cfg, torch.tensor(tokens), fused=False)
    _close(fused, ref)
    _close(unfused, ref)
    _close(fused, unfused.detach().numpy())


def _port_state(jstate, cfg):
    """JAX's state on the port: step, params, AdamW's count and both
    moments."""
    return ttrain.state_from_jax(jax.tree.map(np.asarray, jstate), cfg,
                                 device="cpu")


def test_three_train_steps_match_jax():
    """Loss, pre-clip grad norm and every parameter after each of three
    steps (the third clips: its grad norm exceeds 1)."""
    jcfg, cfg = _configs()
    jstate = jtrain.init_state(jax.random.PRNGKey(0), jcfg)
    optimizer = ttrain.make_optimizer()
    state = _port_state(jstate, cfg)
    jstep = jtrain.make_train_step(jcfg, attn_fn=_jax_attn(jcfg),
                                   donate=False)
    step = ttrain.make_train_step(cfg, optimizer)
    rng = np.random.default_rng(0)
    norms = []
    for i in range(3):
        tokens = rng.integers(0, 256, size=(2, 129)).astype(np.int32)
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        state, m = step(state, torch.tensor(tokens))
        assert state.step == i + 1
        _close(m["loss"], jm["loss"])
        _close(m["grad_norm"], jm["grad_norm"])
        norms.append(float(m["grad_norm"]))
        ref = jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))
        got = jax.tree.leaves(ttf.params_to_numpy(state.params))
        assert len(ref) == len(got)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    assert max(norms) > 1.0 > min(norms)       # clipped and unclipped steps


def test_accum_steps_equal_the_full_batch():
    jcfg, cfg = _configs()
    jstate = jtrain.init_state(jax.random.PRNGKey(1), jcfg)
    tokens = torch.tensor(np.random.default_rng(2).integers(
        0, 256, size=(4, 129)))
    runs = []
    for accum in (1, 2):
        optimizer = ttrain.make_optimizer()
        state = _port_state(jstate, cfg)
        step = ttrain.make_train_step(cfg, optimizer, accum_steps=accum)
        state, m = step(state, tokens)
        runs.append((m, ttf.params_to_numpy(state.params)))
    (m1, p1), (m2, p2) = runs
    _close(m2["loss"], m1["loss"].numpy())
    _close(m2["grad_norm"], m1["grad_norm"].numpy())
    for a, b in zip(jax.tree.leaves(p1), jax.tree.leaves(p2)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    with pytest.raises(ValueError, match="divisible"):
        ttrain.make_train_step(cfg, accum_steps=3)(state, tokens)


def test_master_weights_and_bf16_use_site_casts():
    """Training keeps float32 master weights; a bf16 config casts each one
    at its use, so its loss equals that of weights stored in bf16."""
    _, cfg = _configs()
    bf16 = ttf.TransformerConfig(**{**cfg.__dict__, "dtype": torch.bfloat16})
    state = ttrain.init_state(torch.Generator().manual_seed(0), bf16,
                              device="cpu")
    assert all(p.dtype == torch.float32
               for p in jax.tree.leaves(state.params))
    stored = jax.tree.map(lambda p: p.to(torch.bfloat16), state.params)
    tokens = torch.tensor(np.random.default_rng(4).integers(
        0, 256, size=(2, 129)))
    a = ttf.loss_fn(state.params, bf16, tokens)
    b = ttf.loss_fn(stored, bf16, tokens)
    assert torch.equal(a, b) and torch.isfinite(a)
    step = ttrain.make_train_step(bf16)
    state, m = step(state, tokens)
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert all(p.dtype == torch.float32
               for p in jax.tree.leaves(state.params))


def test_unported_training_paths_raise():
    """The pipeline step refuses what JAX's refuses, word for word: layers
    that do not split into the stages and a MoE config (the step itself is
    ``test_torch_pp_train.py``'s). An ``activation_spec`` that shards the
    sequence needs an attention that crosses the ranks' windows,
    ``make_sp_train_step``'s (``test_torch_sp_train*.py``); one on the
    model dim has no counterpart. The mesh step, a batch-axes
    ``activation_spec``, a ``moe_fn`` and ``token_shards`` are ported
    (``test_torch_train_mesh.py``)."""
    from tpu_task.ml.parallel import mesh as jmesh
    from tpu_task_torch.ml.parallel.mesh import Mesh

    _, cfg = _configs()
    jm = jmesh.make_mesh(4, axis_names=("pp",), axis_sizes=(4,))
    for over in (dict(n_layers=3), dict(n_layers=4, moe_every=2,
                                         n_experts=4)):
        jbad, bad = _configs(**over)
        with pytest.raises(ValueError) as jax_err:
            jtrain.make_pp_train_step(jbad, jm, 4)
        with pytest.raises(ValueError) as port_err:
            ttrain.make_pp_train_step(bad, Mesh((4,), ("pp",)), 4)
        assert str(port_err.value) == str(jax_err.value)
    seq = PartitionSpec(("dp",), "sp", None)
    with pytest.raises(ValueError, match="make_sp_train_step"):
        ttrain.make_train_step(cfg, activation_spec=seq)
    tokens = torch.zeros((2, 9), dtype=torch.int64)
    params = ttf.init(torch.Generator().manual_seed(0), cfg)
    assert torch.equal(ttf.loss_fn(params, cfg, tokens, activation_spec=seq),
                       ttf.loss_fn(params, cfg, tokens))
    with pytest.raises(NotImplementedError, match="model dim"):
        ttf.loss_fn(params, cfg, tokens,
                    activation_spec=PartitionSpec(None, None, "tp"))
    with pytest.raises(ValueError, match="fused loss path"):
        ttf.loss_fn(params, cfg, tokens, fused=False,
                    activation_spec=PartitionSpec(("dp",), None, None))
    assert callable(ttrain.make_train_step(cfg, moe_fn=lambda layer, h: h))
    assert callable(ttrain.make_train_step(
        cfg, activation_spec=PartitionSpec(("dp",), None, None)))
    # token_shards sizes the tile for one shard's tokens, as JAX's does;
    # the loss is the same.
    rng = np.random.default_rng(2)
    feats = torch.tensor(rng.normal(size=(16, 8)), dtype=torch.float32)
    unembed = torch.tensor(rng.normal(size=(8, 16)), dtype=torch.float32)
    targets = torch.tensor(rng.integers(0, 16, size=16))
    assert torch.equal(ttf.fused_xent(feats, unembed, targets),
                       ttf.fused_xent(feats, unembed, targets,
                                      token_shards=2))


def test_init_state_runs_on_cuda_unless_asked(monkeypatch):
    _, cfg = _configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.init_state(torch.Generator().manual_seed(0), cfg)
