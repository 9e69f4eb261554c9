"""The port's train step on a mixture-of-experts config against the JAX
package's ``make_train_step``, at fp32 on the CPU, and a MoE
``TrainState`` checkpoint crossing between the packages both ways.

The config is ``test_torch_train.py``'s tiny GQA one with its second layer
a 4-expert top-2 MoE layer. The JAX step's loss carries the router loss
at ``moe_aux_weight``; its attention runs through the Pallas kernel pair
in interpret mode, the port's through ``FlashAttention``'s plain
versions. Three steps, plain and at ``accum_steps`` 2, agree in loss and
pre-clip grad norm within 1e-5 and in every parameter within 2e-5
(``test_torch_train.py``'s tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml import checkpoint as jckpt
from tpu_task.ml import train as jtrain
from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.ops.attention import _pallas_attention
from tpu_task_torch.ml import checkpoint as ckpt
from tpu_task_torch.ml import train as ttrain
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.parallel.mesh import Mesh
from tpu_task_torch.ml.tree import leaves

ATOL = 1e-5
PARAM_ATOL = 2e-5
TINY = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_head=16,
            d_ff=128, n_kv_heads=2, moe_every=2, n_experts=4, moe_top_k=2)
JCFG = jtf.TransformerConfig(dtype=jnp.float32, **TINY)
CFG = ttf.TransformerConfig(dtype=torch.float32, **TINY)


def _jax_attn(q, k, v):
    return _pallas_attention(q, jtf.expand_kv(k, JCFG.n_heads),
                             jtf.expand_kv(v, JCFG.n_heads), True, True)


def _tokens(seed: int, batch: int = 2) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, TINY["vocab_size"], size=(batch, 65)).astype(np.int32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=atol)


def _port_state(jstate):
    return ttrain.state_from_jax(jax.tree.map(np.asarray, jstate), CFG,
                                 device="cpu")


@pytest.fixture(scope="module")
def jax_runs():
    """Per accum_steps: the JAX initial state and the (loss, grad norm,
    numpy state) after each of three JAX steps."""
    runs = {}
    for accum in (1, 2):
        state0 = jtrain.init_state(jax.random.PRNGKey(0), JCFG)
        step = jtrain.make_train_step(JCFG, attn_fn=_jax_attn, donate=False,
                                      accum_steps=accum)
        state, after = state0, []
        for i in range(3):
            state, m = step(state, jnp.asarray(_tokens(i, 4)))
            after.append((float(m["loss"]), float(m["grad_norm"]),
                          jax.tree.map(np.asarray, state)))
        runs[accum] = (state0, after, step)
    return runs


@pytest.mark.parametrize("accum", [1, 2], ids=["plain", "accum2"])
def test_three_moe_train_steps_match_jax(jax_runs, accum):
    state0, after, _ = jax_runs[accum]
    state = _port_state(state0)
    assert sorted(state.params["layers"][1]) == sorted(
        jax.tree.map(np.asarray, state0.params)["layers"][1])
    step = ttrain.make_train_step(CFG, accum_steps=accum)
    for i, (loss, norm, jstate) in enumerate(after):
        state, m = step(state, torch.tensor(_tokens(i, 4)))
        assert state.step == i + 1
        _close(m["loss"], loss)
        _close(m["grad_norm"], norm)
        got = jax.tree.leaves(ttf.params_to_numpy(state.params))
        want = jax.tree.leaves(jstate.params)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, PARAM_ATOL)
    # The router learned: its aux gradient reached it.
    np.testing.assert_raises(
        AssertionError, np.testing.assert_array_equal,
        ttf.params_to_numpy(state.params)["layers"][1]["router"],
        np.asarray(state0.params["layers"][1]["router"]))


def test_moe_loss_carries_the_router_loss():
    """The port's MoE loss minus its cross-entropy is moe_aux_weight times
    the mean router loss, and equals JAX's loss."""
    jparams = jtf.init(jax.random.PRNGKey(4), JCFG)
    params = ttf.params_from_jax(jax.tree.map(np.asarray, jparams), CFG)
    tokens = _tokens(9)
    loss = ttf.loss_fn(params, CFG, torch.tensor(tokens))
    _close(loss, jtf.loss_fn(jparams, JCFG, jnp.asarray(tokens),
                             attn_fn=_jax_attn))
    no_aux = ttf.TransformerConfig(**{**CFG.__dict__, "moe_aux_weight": 0.0})
    _, aux = ttf.apply_features_with_aux(params, CFG,
                                         torch.tensor(tokens[:, :-1]))
    _close(loss - ttf.loss_fn(params, no_aux, torch.tensor(tokens)),
           CFG.moe_aux_weight * float(aux), 1e-6)


def test_moe_fn_is_accepted_and_ep_step_names_a14():
    calls = []

    def moe_fn(layer, h):
        calls.append(tuple(h.shape))
        return torch.zeros_like(h), torch.zeros((), dtype=torch.float32)

    state = ttrain.init_state(torch.Generator().manual_seed(0), CFG,
                              device="cpu")
    state, m = ttrain.make_train_step(CFG, moe_fn=moe_fn)(
        state, torch.tensor(_tokens(1)))
    assert calls == [(2, 64, 64)] and torch.isfinite(m["loss"])
    # The expert-parallel step is ported (test_torch_train_moe_mesh.py):
    # on a one-position ep mesh it runs in this process.
    mesh = Mesh((1,), ("ep",))
    blocks, _ = ttrain.shard_state(state, CFG, mesh)
    blocks, m = ttrain.make_moe_train_step(CFG, mesh)(blocks)(
        blocks, torch.tensor(_tokens(1)))
    assert blocks.step == 2 and torch.isfinite(m["loss"])


@pytest.mark.parametrize("sharded", [False, True], ids=["plain", "sharded"])
def test_moe_checkpoint_crosses_both_ways(jax_runs, tmp_path, sharded):
    """A JAX MoE state after three steps restores into the port's state
    leaf for leaf (JAX's order), and the port's into JAX's template; one
    more step on each side agrees."""
    _, after, jstep = jax_runs[1]
    jstate = jax.tree.map(jnp.asarray, after[-1][2])
    template = ttrain.init_state(torch.Generator().manual_seed(3), CFG,
                                 device="cpu")
    save, restore = ((jckpt.save_checkpoint_sharded,
                      ckpt.restore_checkpoint_sharded) if sharded else
                     (jckpt.save_checkpoint, ckpt.restore_checkpoint))
    save(tmp_path / "jax", 3, jstate)
    state = restore(tmp_path / "jax", template)
    got, want = leaves(state), jax.tree.leaves(jstate)
    assert len(got) == len(want) == 2 + 3 * (3 + 2 * 9)
    for a, b in zip(got, want):
        a, b = ckpt._host(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    save, restore = ((ckpt.save_checkpoint_sharded,
                      jckpt.restore_checkpoint_sharded) if sharded else
                     (ckpt.save_checkpoint, jckpt.restore_checkpoint))
    save(tmp_path / "port", 3, state)
    back = restore(tmp_path / "port",
                   jtrain.init_state(jax.random.PRNGKey(7), JCFG))
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(back), want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tokens = _tokens(3, 4)
    jstate, jm = jstep(back, jnp.asarray(tokens))
    state, m = ttrain.make_train_step(CFG)(state, torch.tensor(tokens))
    _close(m["loss"], jm["loss"])
    for a, b in zip(leaves(state), jax.tree.leaves(jstate)):
        _close(ckpt._host(a), b, PARAM_ATOL)
