"""The port's obs plane (``tpu_task_torch/obs``) against the JAX package's
(``tpu_task/obs``) on the same inputs: the trace and SLA headers, the
histogram grid and quantiles, the Prometheus text byte for byte, snapshots
that merge across the packages, spans one package exports and the other
reads, and the two serving engines' phase spans, histogram counts and
registry names over the same wave (greedy, sampled, a preemption, a drain
export)."""

import numpy as np
import pytest

import tpu_task.obs as jobs
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task.storage.backends import LocalBackend as JaxLocalBackend
from tpu_task_torch import obs as tobs
from tpu_task_torch.serve.replica import build_engine
from tpu_task_torch.storage.backends import LocalBackend

SLA_CASES = [None, "", "premium", "premium;1500", "best_effort;12.5",
             ";250", "standard;", "standard;abc", " premium ;3",
             "gold;-40", "premium;1e3", "a;b;c", "premium;inf", ";"]


def test_obs_trace_header_round_trips_across_packages():
    ctx = tobs.TraceContext.mint()
    header = ctx.to_header()
    assert jobs.TraceContext.from_header(header).to_header() == header
    jctx = jobs.TraceContext.mint()
    assert tobs.TraceContext.from_header(jctx.to_header()) == \
        tobs.TraceContext(jctx.trace_id, jctx.span_id)
    assert tobs.TRACE_HEADER == jobs.TRACE_HEADER
    for bad in (None, "", "abc", ":x", "x:"):
        assert tobs.TraceContext.from_header(bad) is None
        assert jobs.TraceContext.from_header(bad) is None


@pytest.mark.parametrize("value", SLA_CASES)
def test_obs_sla_header_parses_as_jax(value):
    assert tobs.SLA_HEADER == jobs.SLA_HEADER
    assert tobs.parse_sla_header(value) == jobs.parse_sla_header(value)


@pytest.mark.parametrize("slo_class,ms", [("premium", None),
                                         ("standard", 0.0),
                                         ("best_effort", 1234.56)])
def test_obs_sla_header_formats_as_jax(slo_class, ms):
    text = tobs.format_sla_header(slo_class, ms)
    assert text == jobs.format_sla_header(slo_class, ms)
    assert tobs.parse_sla_header(text) == jobs.parse_sla_header(text)


def test_obs_span_json_round_trips_across_packages():
    tracer = tobs.Tracer(source="t")
    root = tracer.start("root", rid=3)
    tracer.error("boom", ValueError("bad"), parent=root)
    tracer.end(root, status="preempted", token_end=4)
    for span in tracer.finished():
        record = span.to_json()
        assert jobs.Span.from_json(record).to_json() == record
        assert tobs.Span.from_json(record).to_json() == record
    assert [s.status for s in tracer.drain()] == ["error", "preempted"]
    assert tracer.finished() == []


def _observations(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(-5, 2, size=500), [0.0, 1e-7, 1e-6,
                                                             1e-3, 2e5]])


@pytest.mark.parametrize("grid", [{}, {"lo": 1e-4, "hi": 10.0,
                                       "per_decade": 3}])
def test_obs_histogram_buckets_and_quantiles_equal_jax(grid):
    mine, theirs = tobs.Histogram("h", **grid), jobs.Histogram("h", **grid)
    for x in _observations(1):
        mine.observe(x)
        theirs.observe(x)
    assert mine.snapshot() == theirs.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert mine.quantile(q) == theirs.quantile(q)


def _registry(module, seed):
    registry = module.MetricsRegistry()
    registry.counter("c.total").inc(3)
    registry.gauge("g.level").set(0.25)
    registry.counter_fn("c.lazy", lambda: 7.0)
    registry.gauge_fn("g.lazy", lambda: 1.5)
    hist = registry.histogram("h.latency_s")
    for x in _observations(seed):
        hist.observe(x)
    return registry


def test_obs_prometheus_text_is_byte_equal_to_jax():
    snapshot = _registry(tobs, 2).snapshot()
    assert snapshot == _registry(jobs, 2).snapshot()
    text = tobs.prometheus_text(snapshot)
    assert text == jobs.prometheus_text(snapshot)
    assert tobs.prometheus_text({}) == jobs.prometheus_text({})


def test_obs_snapshots_merge_across_packages():
    mine, theirs = _registry(tobs, 3).snapshot(), _registry(jobs, 4).snapshot()
    merged = jobs.merge_snapshots([theirs, mine])
    assert merged == tobs.merge_snapshots([theirs, mine])
    assert merged["c.total"]["value"] == 6 and merged["c.lazy"]["value"] == 14
    hist = merged["h.latency_s"]
    assert hist["count"] == mine["h.latency_s"]["count"] \
        + theirs["h.latency_s"]["count"]
    for i in set(mine["h.latency_s"]["counts"]) \
            | set(theirs["h.latency_s"]["counts"]):
        assert hist["counts"][i] == mine["h.latency_s"]["counts"].get(i, 0) \
            + theirs["h.latency_s"]["counts"].get(i, 0)


def test_obs_jax_reads_what_the_port_exports(tmp_path):
    obs = tobs.Obs.create("replica:abc")
    for i in range(3):
        with obs.tracer.span("engine.queue", rid=i):
            pass
    spans = obs.tracer.drain()
    exporter = tobs.SpanExporter(LocalBackend(str(tmp_path)))
    key = exporter.export(spans, source="abc")
    assert key.startswith(jobs.SPAN_PREFIX) and key.endswith("-000000.json")
    snapshot = _registry(tobs, 5).snapshot()
    assert tobs.export_metrics(LocalBackend(str(tmp_path)), snapshot,
                               "abc") == f"{jobs.METRICS_PREFIX}abc.json"
    jax_backend = JaxLocalBackend(str(tmp_path))
    assert [s.to_json() for s in jobs.read_spans(jax_backend)] == \
        [s.to_json() for s in tobs.read_spans(LocalBackend(str(tmp_path)))]
    assert [s.to_json() for s in jobs.read_spans(jax_backend)] == \
        [s.to_json() for s in spans]
    assert jobs.read_metrics(jax_backend) == snapshot
    assert obs.metrics.snapshot()["obs.spans_dropped"]["value"] == 0


def _wave(engine, package):
    """Four requests into a pool too small for them all (a preemption),
    one of them sampled; an export part-way through closes the open
    spans "exported"; then the wave drains."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 64, size=n) for n in (9, 6, 10, 7)]
    key = [5, 9]
    if package == "jax":
        import jax.numpy as jnp

        key = jnp.asarray(np.asarray(key, np.uint32))
    rids = [engine.submit(p, 16, **({"temperature": 0.8, "top_p": 0.9,
                                     "key": key} if i == 1 else {}))
            for i, p in enumerate(prompts)]
    for _ in range(12):
        engine.step()
    records = engine.export_inflight()
    out = engine.drain(max_steps=2000)
    return [out[r] for r in rids], records


def _phase_spans(obs):
    by_rid = {}
    for span in obs.tracer.finished():
        by_rid.setdefault(span.attrs["rid"], []).append(
            (span.name, span.status, dict(span.attrs)))
    return by_rid


def test_obs_engine_spans_and_registry_equal_jax():
    serving = {"n_blocks": 12}
    jax_obs, port_obs = jobs.Obs.create("j"), tobs.Obs.create("p")
    jax_engine = jax_build_engine("micro", serving=serving, obs=jax_obs)
    port = build_engine("micro", serving=serving, device="cpu",
                        obs=port_obs)
    jax_streams, jax_records = _wave(jax_engine, "jax")
    port_streams, port_records = _wave(port, "port")
    assert port_streams == jax_streams
    assert port.preemption_count == jax_engine.preemption_count > 0
    assert len(port_records) == len(jax_records) > 0

    port_spans, jax_spans = _phase_spans(port_obs), _phase_spans(jax_obs)
    assert port_spans == jax_spans
    statuses = {status for spans in port_spans.values()
                for _, status, _ in spans}
    assert {"preempted", "exported", "ok"} <= statuses
    # Every span of a request shares the request's one minted trace.
    for rid in port_spans:
        traces = {s.trace_id for s in port_obs.tracer.finished()
                  if s.attrs["rid"] == rid}
        assert traces == {port.request(rid).trace.trace_id}

    port_snap = port.stats()["obs"]
    jax_snap = jax_engine.stats()["obs"]
    assert set(port_snap) == set(jax_snap)
    for name, entry in jax_snap.items():
        if entry["type"] == "histogram":
            assert port_snap[name]["count"] == entry["count"], name
        elif not name.startswith("goodput.") or name.startswith(
                "goodput.tokens_"):
            assert port_snap[name]["value"] == entry["value"], name


def test_obs_off_leaves_the_engines_stats_as_they_were():
    on = build_engine("micro", device="cpu", obs=tobs.Obs.create())
    off = build_engine("micro", device="cpu")
    assert off.obs is None
    for engine in (on, off):
        engine.submit([1, 2, 3, 4, 5], 6)
        engine.drain()
    on_stats, off_stats = on.stats(), off.stats()
    assert "obs" not in off_stats and set(on_stats) - set(off_stats) == \
        {"obs"}
    for key in ("steps", "decode_steps", "chunk_steps", "prefills",
                "prefix_cache", "kv_quant", "spec", "adapters"):
        assert on_stats[key] == off_stats[key]
    assert off._phase_spans == {}
