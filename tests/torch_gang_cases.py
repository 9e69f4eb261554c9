"""The engine cases the gang test files share: a configuration served by
the port's engine over a gang's mesh, by JAX's engine over a mesh of the
same shape and by a single-device engine, from the same weights. Imported
by the test modules only (it imports JAX); what the gang's ranks run is in
``torch_gang_util``."""

import jax
import jax.numpy as jnp
import numpy as np

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.parallel.sharding import tree_nbytes
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from torch_gang_util import shared_stats, wave
from torch_port_util import CPU, port_model, share_jax_programs

BASE = dict(slots=3, block_size=4, n_blocks=40, max_len=32,
            prefill_buckets=(8, 16, 32), prefix_cache=True)


def models(spec: dict, seed: int):
    """((JAX cfg, params), (port cfg, params)) of one fp32 config."""
    jcfg = jtf.TransformerConfig(dtype=jnp.float32, **spec)
    jparams = jtf.init(jax.random.PRNGKey(seed), jcfg)
    return (jcfg, jparams), port_model(jcfg, jparams)


def jax_mesh(tp: int, ep: int):
    devices = np.asarray(jax.devices()[:tp * ep]).reshape(tp, ep)
    return jax.sharding.Mesh(devices, ("tp", "ep"))


def engines(mesh, target, over, *, draft=None, jax_single=True):
    """(a single-device engine: JAX's, or the port's when ``jax_single``
    is False; JAX's mesh engine; the port's gang engine) of ``target``
    (as :func:`models` gives it) under ``BASE`` + ``over``."""
    knobs = {**BASE, **over}
    (jcfg, jparams), (cfg, params) = target
    jextra, textra = {}, {}
    if knobs.get("spec_k", 0) > 0:
        (djcfg, djparams), (dcfg, dparams) = draft
        jextra = dict(draft_params=djparams, draft_cfg=djcfg)
        textra = dict(draft_params=dparams, draft_cfg=dcfg)
    jknobs = JaxServingConfig(**knobs, decode_impl="xla")
    if jax_single:
        single = share_jax_programs(JaxServingEngine(
            jparams, jcfg, jknobs, rng=jax.random.PRNGKey(0), **jextra))
    else:
        single = ServingEngine(params, cfg, ServingConfig(**knobs),
                               rng=R.PRNGKey(0), device=CPU, **textra)
    tp, ep = dict(mesh.shape)["tp"], dict(mesh.shape)["ep"]
    # Not shared: a mesh program's shardings are not in its closure, so
    # share_jax_programs would hand it to a single-device engine.
    on_mesh = JaxServingEngine(jparams, jcfg, jknobs,
                               rng=jax.random.PRNGKey(0),
                               mesh=jax_mesh(tp, ep), **jextra)
    port = ServingEngine(params, cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(0), mesh=mesh, **textra)
    return single, on_mesh, port


def check_case(single, on_mesh, port, sampled=True) -> dict:
    """The three engines' streams of one wave (greedy, and ``sampled``
    keyed-sampled requests) are equal and the gang's ``stats()`` are JAX's
    mesh engine's; returns the gang's stats."""
    want = wave(single, sampled=sampled)
    assert wave(on_mesh, sampled=sampled) == want
    assert wave(port, sampled=sampled) == want
    stats = port.stats()
    want_stats, got_stats = shared_stats(on_mesh.stats(), stats)
    assert got_stats == want_stats
    assert stats["step_graph"]["captures"] == 0
    return stats


def check_shard_bytes(gang, pairs, on_mesh) -> None:
    """Each rank's bytes of each (port tree, JAX tree) pair equal JAX's
    addressable shard at that mesh position."""
    devices = list(on_mesh.mesh.devices.reshape(-1))
    for ours, theirs in pairs:
        want = [sum(next(s for s in leaf.addressable_shards
                         if s.device == device).data.nbytes
                    for leaf in jax.tree.leaves(theirs))
                for device in devices]
        assert gang.query(tree_nbytes, ours) == want
