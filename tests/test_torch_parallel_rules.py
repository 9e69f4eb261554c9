"""The port's mesh and partition rules against the JAX package's, and the
mesh checks of the serving engine, with no process started.

``balanced_mesh_shape``, ``logical_to_mesh_axes``, ``match_partition_rules``
(scalars replicate, mesh axes the mesh lacks drop, an unmatched leaf
raises naming it), ``param_pspecs`` and ``pool_pspecs`` give JAX's specs
for the ``tiny``, ``micro`` and ``moe`` presets and a flagship-shaped
config on every serving mesh; ``device_put_tree`` cuts for each rank
exactly the block JAX places on the device at that mesh position, and
``kv_shard_bytes`` is JAX's. Every mesh ``ValueError`` of the engine
(kv heads, ep without MoE layers, ``n_experts % ep``, the draft's kv heads
and the five single-device gates) is JAX's, word for word, raised before
anything is placed: the port's checks need a mesh's layout only."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_task.ml.models import moe as jmoe
from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.parallel import mesh as jmesh
from tpu_task.ml.parallel import sharding as jsh
from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.ml.serving import cache as jc
from tpu_task_torch.ml import make_mesh as ml_make_mesh
from tpu_task_torch.ml.models import moe as tmoe
from tpu_task_torch.ml.models import transformer as ttf
from tpu_task_torch.ml.parallel import mesh as tmesh
from tpu_task_torch.ml.parallel import sharding as tsh
from tpu_task_torch.ml.serving import cache as tc
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.ml.serving.model import serving_moe_fn
from torch_port_util import CPU, jax_model, port_config, port_model

#: The flagship serving geometry (``chip_smoke.FLAGSHIP``) and its MoE
#: variant, at fp32.
FLAGSHIP = dict(vocab_size=32768, d_model=1024, n_layers=8, n_heads=8,
                d_head=128, d_ff=4096, n_kv_heads=2)
FLAGSHIP_MOE = dict(FLAGSHIP, moe_every=2, n_experts=8, moe_top_k=2)

#: (tp, ep) of every serving mesh the tests build.
MESHES = [(2, 1), (4, 1), (1, 2), (2, 2)]


def _jax_mesh(tp, ep):
    devices = np.asarray(jax.devices()[:tp * ep]).reshape(tp, ep)
    return jax.sharding.Mesh(devices, ("tp", "ep"))


def _config(name):
    if name in ("tiny", "micro", "moe"):
        return jax_model(name)[0]
    spec = FLAGSHIP if name == "flagship" else FLAGSHIP_MOE
    return jtf.TransformerConfig(dtype=jnp.float32, **spec)


@pytest.mark.parametrize("n,axes", [(1, 3), (8, 3), (12, 3), (7, 2),
                                    (16, 2), (6, 1), (4, 2)])
def test_balanced_mesh_shape_is_jax(n, axes):
    assert tmesh.balanced_mesh_shape(n, axes) == \
        jmesh.balanced_mesh_shape(n, axes)


def test_mesh_layout_and_env():
    mesh = tmesh.Mesh((2, 2), ("tp", "ep"), rank=3)
    assert dict(mesh.shape) == {"tp": 2, "ep": 2}
    assert mesh.coords() == {"tp": 1, "ep": 1}
    assert mesh.coords(2) == {"tp": 1, "ep": 0}
    np.testing.assert_array_equal(mesh.devices, [[0, 1], [2, 3]])
    assert ml_make_mesh(axis_names=("tp",)).size == 1
    with pytest.raises(ValueError, match="axis sizes"):
        tmesh.make_mesh(1, axis_names=("tp", "ep"), axis_sizes=(2, 1))
    assert tmesh.worker_env(1, 4, "h:1") == jmesh.worker_env(1, 4, "h:1")
    assert tmesh.distributed_init_from_env({}) is False
    assert tmesh.distributed_init_from_env(
        {"TPU_TASK_NUM_WORKERS": "1"}) is False


@pytest.mark.parametrize("tp,ep", MESHES + [(1, 1)])
def test_logical_rules_are_jax(tp, ep):
    ours, theirs = tmesh.Mesh((tp, ep), ("tp", "ep")), _jax_mesh(tp, ep)
    for axes in [("batch",), ("vocab", "embed"), ("embed", "heads"),
                 ("expert", "embed", "mlp"), ("embed", None), ("norm",),
                 ("batch", "seq", "heads", "head_dim")]:
        for mesh_pair in ((ours, theirs), (None, None)):
            assert tsh.logical_to_mesh_axes(axes, mesh=mesh_pair[0]) == \
                jsh.logical_to_mesh_axes(axes, mesh=mesh_pair[1])
    assert tsh.mesh_batch_axes(ours) == jsh.mesh_batch_axes(theirs)
    assert tsh.mesh_axis_size(ours, "tp") == jsh.mesh_axis_size(theirs,
                                                                 "tp")
    assert tsh.mesh_axis_size(None, "ep") == 1
    assert tsh.PartitionSpec(None, "tp") == \
        jax.sharding.PartitionSpec(None, "tp")


def test_match_partition_rules_is_jax():
    ours, theirs = tmesh.Mesh((2, 1), ("tp", "ep")), _jax_mesh(2, 1)
    tree = {"w": np.zeros((4, 8)), "count": np.zeros(()),
            "one": np.zeros((1, 1)), "layers": [{"k": np.zeros((3, 4)),
                                                 "x": np.zeros((2, 6))}]}
    rules = [(r"layers/\d+/k$", ("heads", None)),
             (r"^w$", ("embed", "mlp")),
             (r"x$", tsh.PartitionSpec("dp", "tp"))]
    jrules = [(p, t if not isinstance(t, tsh.PartitionSpec)
               else jax.sharding.PartitionSpec(*t)) for p, t in rules]
    got = tsh.match_partition_rules(rules, tree, mesh=ours)
    want = jsh.match_partition_rules(jrules, tree, mesh=theirs)
    assert got["count"] == want["count"] == ()
    assert got["one"] == want["one"] == ()
    assert got["w"] == want["w"] == (None, "tp")
    assert got["layers"][0]["k"] == want["layers"][0]["k"]
    # A raw spec keeps only the axes the mesh has.
    assert got["layers"][0]["x"] == want["layers"][0]["x"] == (None, "tp")
    # An annotation wins over a regex.
    axes = {"w": ("mlp", None), "count": None, "one": None,
            "layers": [{"k": None, "x": None}]}
    assert tsh.match_partition_rules(rules, tree, mesh=ours,
                                     logical_axes=axes)["w"] == ("tp", None)
    bad = {"w": np.zeros((4, 8)), "stray": np.zeros((2, 2))}
    with pytest.raises(ValueError) as ours_error:
        tsh.match_partition_rules(rules[1:2], bad, mesh=ours)
    with pytest.raises(ValueError) as jax_error:
        jsh.match_partition_rules(jrules[1:2], bad, mesh=theirs)
    assert str(ours_error.value) == str(jax_error.value)
    assert "'stray'" in str(ours_error.value)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


@pytest.mark.parametrize("tp,ep", MESHES)
@pytest.mark.parametrize("name", ["tiny", "micro", "moe", "flagship",
                                  "flagship_moe"])
def test_param_and_pool_pspecs_are_jax(name, tp, ep):
    jcfg = _config(name)
    cfg = port_config(jcfg)
    ours, theirs = tmesh.Mesh((tp, ep), ("tp", "ep")), _jax_mesh(tp, ep)
    got = ttf.param_pspecs(cfg, mesh=ours)
    want = jtf.param_pspecs(jcfg, mesh=theirs)
    assert sorted(p for p, _ in _paths(got)) == \
        sorted(p for p, _ in _paths(want))
    for path, spec in _paths(got):
        assert spec == _get(want, path), path
    assert ttf.param_logical_axes(cfg) == jtf.param_logical_axes(jcfg)
    for kv_dtype in (None, "int8", "int4"):
        scfg = ServingConfig(slots=2, block_size=4, n_blocks=8, max_len=16,
                             kv_dtype=kv_dtype)
        jscfg = JaxServingConfig(slots=2, block_size=4, n_blocks=8,
                                 max_len=16, kv_dtype=kv_dtype)
        pools = tc.init_pools(cfg, scfg, CPU)
        got = tc.pool_pspecs(pools, ours)
        want = jc.pool_pspecs(jc.init_pools(jcfg, jscfg), theirs)
        for path, spec in _paths(got):
            assert spec == _get(want, path), (kv_dtype, path)
        # Each rank allocates its own kv-head block (where they divide:
        # the engine refuses the others).
        for rank in range(tp * ep if cfg.kv_heads % tp == 0 else 0):
            mine = tc.init_pools(cfg, scfg, CPU,
                                 mesh=tmesh.Mesh((tp, ep), ("tp", "ep"),
                                                 rank=rank))
            for layer, whole in zip(mine, pools):
                for key, leaf in layer.items():
                    assert leaf.is_contiguous()
                    assert leaf.shape[2 if leaf.dim() == 4 else 1] * tp == \
                        whole[key].shape[2 if leaf.dim() == 4 else 1]
        for n in (8, 96):
            assert tc.kv_shard_bytes(cfg, scfg, n, tp) == \
                jc.kv_shard_bytes(jcfg, jscfg, n, tp)
    assert tmoe.param_logical_axes() == jmoe.param_logical_axes()


@pytest.mark.parametrize("preset,tp,ep", [
    ("micro", 2, 1), ("micro", 1, 2), ("micro", 2, 2), ("moe", 2, 1),
    ("moe", 4, 1), ("moe", 1, 2), ("moe", 2, 2)])
def test_each_rank_holds_jax_addressable_shard(preset, tp, ep):
    """``device_put_tree`` cut for rank r is the block JAX's
    ``device_put`` places on the device at mesh position r, value for
    value."""
    jcfg, jparams = jax_model(preset)
    cfg, params = port_model(jcfg, jparams)
    theirs = _jax_mesh(tp, ep)
    jspecs = jtf.param_pspecs(jcfg, mesh=theirs)
    placed = jsh.device_put_tree(jparams, jspecs, theirs)
    devices = list(theirs.devices.reshape(-1))
    for rank, device in enumerate(devices):
        ours = tmesh.Mesh((tp, ep), ("tp", "ep"), rank=rank)
        block = tsh.device_put_tree(
            params, ttf.param_pspecs(cfg, mesh=ours), ours)
        for path, leaf in _paths(block):
            shard = next(s for s in _get(placed, path).addressable_shards
                         if s.device == device)
            np.testing.assert_array_equal(leaf.numpy(),
                                          np.asarray(shard.data))
            assert leaf.is_contiguous()
        assert tsh.tree_nbytes(block) == sum(
            next(s for s in leaf.addressable_shards
                 if s.device == device).data.nbytes
            for _, leaf in _paths(placed))


def test_serving_moe_fn_resolves_by_jax_rule():
    jcfg = _config("moe")
    cfg = port_config(jcfg)
    for tp, ep in [(2, 1), (1, 2), (2, 2)]:
        ours, theirs = tmesh.Mesh((tp, ep), ("tp", "ep")), _jax_mesh(tp, ep)
        from tpu_task.ml.serving.model import serving_moe_fn as jfn

        assert (serving_moe_fn(cfg, ours) is None) == \
            (jfn(jcfg, theirs) is None) == (ep == 1)
    odd = dataclasses.replace(cfg, n_experts=3)
    with pytest.raises(ValueError) as ours_error:
        serving_moe_fn(odd, tmesh.Mesh((1, 2), ("tp", "ep")))
    with pytest.raises(ValueError) as jax_error:
        from tpu_task.ml.serving.model import serving_moe_fn as jfn

        jfn(dataclasses.replace(jcfg, n_experts=3), _jax_mesh(1, 2))
    assert str(ours_error.value) == str(jax_error.value)


# -- (d) the engine's mesh checks ---------------------------------------------

def _micro_draft():
    jcfg, jparams = jax_model("micro")
    return jcfg, jparams


CHECKS = {
    # name: (preset, (tp, ep), serving overrides, engine extras)
    "kv_heads": ("micro", (4, 1), {}, {}),
    "ep_without_moe": ("micro", (1, 2), {}, {}),
    "n_experts_over_ep": ("moe3", (1, 2), {}, {}),
    "kv_fleet": ("micro", (2, 1), {"prefix_cache": True}, {"fleet": True}),
    "host_tier": ("micro", (2, 1), {"host_offload_blocks": 8}, {}),
    "lora": ("micro", (2, 1), {"lora_rank": 2, "n_adapter_blocks": 4}, {}),
    "overlap": ("micro", (2, 1), {"overlap": True}, {}),
    "draft_kv_heads": ("tiny", (4, 1), {"spec_k": 2}, {"draft": "micro"}),
}


class _Fleet:
    """A fleet client that must never be bound: the mesh check refuses it
    first."""

    def bind(self, *args):
        raise AssertionError("bound before the mesh check")


def _check_models(preset):
    if preset == "moe3":
        jcfg, _ = jax_model("moe")
        jcfg = dataclasses.replace(jcfg, n_experts=3)
        return jcfg, jtf.init(jax.random.PRNGKey(0), jcfg)
    return jax_model(preset)


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_mesh_checks_are_jax_word_for_word(name):
    preset, (tp, ep), over, extra = CHECKS[name]
    jcfg, jparams = _check_models(preset)
    cfg, params = port_model(jcfg, jparams)
    knobs = dict(slots=2, block_size=4, n_blocks=16, max_len=32)
    knobs.update(over)
    jextra, textra = {}, {}
    if "draft" in extra:
        djcfg, djparams = jax_model(extra["draft"])
        dcfg, dparams = port_model(djcfg, djparams)
        jextra = dict(draft_params=djparams, draft_cfg=djcfg)
        textra = dict(draft_params=dparams, draft_cfg=dcfg)
    if "fleet" in extra:
        jextra["kv_fleet"] = textra["kv_fleet"] = _Fleet()
    with pytest.raises(ValueError) as jax_error:
        JaxServingEngine(jparams, jcfg, JaxServingConfig(**knobs),
                         mesh=_jax_mesh(tp, ep), **jextra)
    with pytest.raises(ValueError) as ours_error:
        ServingEngine(params, cfg, ServingConfig(**knobs),
                      mesh=tmesh.Mesh((tp, ep), ("tp", "ep")), **textra)
    assert str(ours_error.value) == str(jax_error.value)


def test_adopt_params_gate_is_jax_word_for_word():
    jcfg, jparams = jax_model("micro")
    cfg, params = port_model(jcfg, jparams)
    knobs = dict(slots=2, block_size=4, n_blocks=16, max_len=32)
    jengine = JaxServingEngine(jparams, jcfg, JaxServingConfig(**knobs),
                               mesh=_jax_mesh(2, 1))
    # A one-process layout mesh: the engine holds rank 0's block.
    engine = ServingEngine(params, cfg, ServingConfig(**knobs),
                           mesh=tmesh.Mesh((2, 1), ("tp", "ep")))
    assert engine.params["layers"][0]["wq"].shape == (32, 16)
    assert engine.pools[0]["k"].shape[2] == 1
    with pytest.raises(ValueError) as jax_error:
        jengine.adopt_params(jparams)
    with pytest.raises(ValueError) as ours_error:
        engine.adopt_params(params)
    assert str(ours_error.value) == str(jax_error.value)
    stats, jstats = engine.stats(), jengine.stats()
    for key in ("tp", "ep", "kv_pool_bytes", "kv_pool_bytes_per_shard"):
        assert stats[key] == jstats[key]
    assert torch.equal(engine.params["embed"],
                       params["embed"][:cfg.vocab_size // 2])
