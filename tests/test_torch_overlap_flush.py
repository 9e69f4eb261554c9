"""The port's overlapped engine loop at its synchronous edges, against the
JAX package's, at fp32 on the CPU: ``export_inflight`` and
``adopt_params`` flush the in-flight program first, the goodput meter
splits an overlapped drain's wall as JAX's does, and ``stats()`` reports
the loop.

The workload is ``tests/test_serving_async.py``'s on the ``tiny`` preset
(``test_torch_overlap_engine.workload``); the roll is
``tests/test_torch_hot_swap.py``'s (two streams, the roll once each holds
three tokens, two more streams)."""

import jax
import numpy as np
import pytest

from tpu_task.ml.models import transformer as jtf
from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.obs import Obs
from test_torch_overlap_engine import BASE, drain, workload
from torch_port_util import CPU, jax_model, port_model, share_jax_programs

NEW_GENERATION = 7


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, JAX old and new params, port cfg, port old and new
    params) of the tiny preset; the new generation draws from another
    key."""
    jcfg, jold = jax_model("tiny")
    jnew = jtf.init(jax.random.PRNGKey(9), jcfg)
    cfg, old = port_model(jcfg, jold)
    _, new = port_model(jcfg, jnew)
    return jcfg, jold, jnew, cfg, old, new


def jax_engine(w, overlap, params=None, **over):
    return share_jax_programs(JaxServingEngine(
        w[1] if params is None else params, w[0],
        JaxServingConfig(**dict(BASE, overlap=overlap, **over),
                         decode_impl="xla"),
        rng=jax.random.PRNGKey(99)))


def port_engine(w, overlap, params=None, obs=None, **over):
    return ServingEngine(
        w[4] if params is None else params, w[3],
        ServingConfig(**dict(BASE, overlap=overlap, **over),
                      decode_impl="reference"),
        rng=R.PRNGKey(99), device=CPU, obs=obs)


def _export_after(engine, specs, steps: int):
    for spec in specs:
        engine.submit(spec["prompt"], spec["max_new"],
                      temperature=spec["temperature"], top_p=spec["top_p"],
                      eos_token=spec["eos_token"])
    for _ in range(steps):
        engine.step()
    records = engine.export_inflight()
    done = {rid: list(r.tokens) for rid, r in engine._requests.items()
            if r.status == "done"}
    return records, done


@pytest.mark.parametrize("micro_k", [1, 4])
def test_export_inflight_flushes_and_resumes_in_either_package(weights,
                                                               micro_k):
    """Four overlapped steps, then ``export_inflight``: nothing is left in
    flight, the records equal the JAX overlapped engine's at the same
    point, and they resume into either package's engine, overlapped or
    synchronous, to the streams of an uninterrupted run."""
    specs = workload(weights[0].vocab_size, seed=5, temps=True)
    want = drain(jax_engine(weights, False, micro_k=micro_k), specs)
    port = port_engine(weights, True, micro_k=micro_k)
    records, done = _export_after(port, specs, 4)
    assert port._inflight is None and port._carry is None
    assert any(r["tokens"] for r in records)
    jax_records, jax_done = _export_after(
        jax_engine(weights, True, micro_k=micro_k), specs, 4)
    assert records == jax_records and done == jax_done
    for importer in (port_engine(weights, True, micro_k=micro_k),
                     port_engine(weights, False, micro_k=micro_k),
                     jax_engine(weights, True, micro_k=micro_k),
                     jax_engine(weights, False, micro_k=micro_k)):
        mapping = importer.resume_inflight(records)
        out = importer.drain()
        got = dict(done)
        got.update({old: out[new] for old, new in mapping.items()})
        assert got == want


def _roll(engine, new_params):
    """``tests/test_torch_hot_swap.py``'s roll, with what each step ran:
    (generations in the slots before the step, a program left in flight
    after it)."""
    rng = np.random.default_rng(0)
    old, new = rng.integers(0, 256, size=6), rng.integers(0, 256, size=7)
    rids = [engine.submit(old, 12),
            engine.submit(old[:4], 10, temperature=0.9, key=[5, 6])]
    while min(len(engine.request(r).tokens) for r in rids) < 3:
        engine.step()
    engine.adopt_params(new_params, generation=NEW_GENERATION)
    flushed = engine._inflight is None
    rids += [engine.submit(new, 8),
             engine.submit(new[:5], 9, temperature=0.7, key=[7, 8])]
    steps = []
    while engine.has_work:
        gens = len({r.generation for r in engine._slots if r})
        engine.step()
        steps.append((gens, engine._inflight is not None))
    return [engine.request(r).tokens for r in rids], flushed, steps


@pytest.mark.parametrize("micro_k", [1, 4])
def test_adopt_params_flushes_then_returns_to_the_overlapped_loop(weights,
                                                                  micro_k):
    """The roll flushes the in-flight program, the steps that hold two
    generations run the partitioned synchronous body (nothing left in
    flight), the loop overlaps again once one generation is left, and the
    streams equal JAX's engines' across the same roll, overlapped and
    synchronous."""
    want, _, _ = _roll(jax_engine(weights, False, micro_k=micro_k),
                       weights[2])
    jax_got, _, _ = _roll(jax_engine(weights, True, micro_k=micro_k),
                          weights[2])
    port = port_engine(weights, True, micro_k=micro_k)
    got, flushed, steps = _roll(port, weights[5])
    assert got == jax_got == want
    assert [len(s) for s in got] == [12, 10, 8, 9]
    assert flushed
    assert all(not inflight for gens, inflight in steps if gens > 1)
    assert any(inflight for gens, inflight in steps if gens <= 1)
    assert set(port._gen_params) == {NEW_GENERATION}
    assert port.stats()["adapters"]["param_swaps"] == 1


def test_goodput_splits_an_overlapped_drain(weights):
    """JAX's attribution test on the port's always-on meter: host work
    under an in-flight program lands in ``overlapped_host_s``, the
    residual host gap is small, the fractions add up, and the registry's
    counter carries the same value."""
    engine = port_engine(weights, True, obs=Obs.create("port-overlap"))
    drain(engine, workload(weights[0].vocab_size))
    stats = engine.stats()
    gp = stats["goodput"]
    assert stats["overlap"] is True and stats["overlap_flushes"] == 0
    assert gp["overlapped_host_s"] > 0
    assert gp["host_gap_frac"] < 0.1
    assert gp["in_program_frac"] + gp["host_gap_frac"] <= 1.0 + 1e-9
    assert engine.goodput.busy_s == pytest.approx(
        engine.goodput.program_s + engine.goodput.host_s
        + engine.goodput.overlapped_host_s)
    assert stats["obs"]["goodput.overlapped_host_s"]["value"] == \
        pytest.approx(gp["overlapped_host_s"], abs=1e-6)
    sync = port_engine(weights, False)
    drain(sync, workload(weights[0].vocab_size))
    assert sync.stats()["goodput"]["overlapped_host_s"] == 0.0
    assert sync.stats()["overlap"] is False
