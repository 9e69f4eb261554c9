"""Drain and resume in the port's serving engine (ROADMAP A10), with the
SLA order its records carry, against the JAX package's engine at fp32 on
the CPU.

Both packages now build a preset's weights bit for bit alike
(``tests/test_torch_preset_weights.py``), so each side is built from the
preset itself. An export from one engine resumes in a fresh engine of
either package: streams must equal the uninterrupted JAX stream token for
token — greedy and sampled, fp32 and int8 pools, ``micro_k`` 1 and 4,
``spec_k`` 0 and 3. One exception is the JAX engine's own: a resumed spec
engine samples the token at ``len(tokens)`` through the chunk step's
``fold_in(key, index)`` draw, where the uninterrupted spec engine drew it
in a round, keyed by position; there the reference is the JAX engine's
own resume of the same records. A resumed request that is preempted rolls
back to its imported prefix, never through it. With SLA fields set,
admission order and preemption victims equal the JAX engine's."""

import json
from collections import deque
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from tpu_task.ml.serving import ServingConfig as JaxServingConfig
from tpu_task.ml.serving import ServingEngine as JaxServingEngine
from tpu_task.obs import Obs
from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task_torch.ml import random as R
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import DONE, ServingEngine
from tpu_task_torch.obs.sla import SLO_CLASSES, class_rank
from tpu_task_torch.serve.replica import build_engine
from torch_port_util import CPU, serving_knobs, share_jax_programs


def _pair(preset="micro", obs=None, **over):
    """(JAX engine, port engine) of one preset, from each package's own
    preset weights, with the same serving knobs and base key; a spec
    engine (``spec_k`` > 0) drafts with the target itself."""
    knobs = serving_knobs(preset, **over)
    jb = jax_build_engine(preset)
    pb = build_engine(preset, device="cpu")
    spec = knobs.get("spec_k", 0) > 0
    jax_engine = share_jax_programs(JaxServingEngine(
        jb.params, jb.cfg, JaxServingConfig(**{**knobs, "decode_impl": "xla"}),
        rng=jax.random.PRNGKey(0), obs=obs,
        draft_params=jb.params if spec else None,
        draft_cfg=jb.cfg if spec else None))
    port = ServingEngine(pb.params, pb.cfg, ServingConfig(**knobs),
                         rng=R.PRNGKey(0), device=CPU,
                         draft_params=pb.params if spec else None,
                         draft_cfg=pb.cfg if spec else None)
    return jax_engine, port


def _wave(vocab, seed=3):
    """Greedy and keyed-sampled requests of mixed lengths, one with eos."""
    rng = np.random.default_rng(seed)
    lengths = (5, 11, 3, 8, 14)
    out = []
    for i, n in enumerate(lengths):
        kw = ({"temperature": 0.9, "top_p": 0.85, "key": [11 + i, 7]}
              if i % 2 else {})
        if i == 4:
            kw["eos_token"] = 9
        out.append((rng.integers(0, vocab, size=n), 12 + i, kw))
    return out


def _submit(engine, wave):
    return [engine.submit(p, n, **kw) for p, n, kw in wave]


def _export_after(engine, wave, steps):
    rids = _submit(engine, wave)
    for _ in range(steps):
        engine.step()
    records = json.loads(json.dumps(engine.export_inflight()))
    finished = {rid: list(engine._requests[rid].tokens) for rid in rids
                if engine._requests[rid].status == DONE}
    return rids, records, finished


def _streams(engine, rids, max_steps=5000):
    out = engine.drain(max_steps=max_steps)
    return [out[r] for r in rids]


def _resumed_streams(engine, records, finished, rids):
    """Each original request's full stream: resumed, or done before the
    export."""
    mapping = engine.resume_inflight(records)
    out = engine.drain(max_steps=5000)
    return [out[mapping[r]] if r in mapping else finished[r] for r in rids]


class _Victims:
    """Records the rid of every preemption victim and each victim's
    tokens just after its rollback."""

    def __init__(self, engine):
        self.rids, self.kept = [], []
        inner = engine._preempt

        def preempt(slot):
            req = engine._slots[slot]
            inner(slot)
            self.rids.append(req.rid)
            self.kept.append((req.resume_from, list(req.tokens)))

        engine._preempt = preempt


@pytest.mark.parametrize("preset", ["micro", "tiny"])
def test_port_export_resumes_in_tight_port_engine(preset):
    """The JAX package's pin (``tests/test_serving_production.py:220``) on
    the port: export part-way, round-trip through json, resume in a fresh
    engine whose pool forces preemption; every stream equals the
    uninterrupted one, a resumed slot was preempted, and each preempted
    resumed request kept exactly its imported prefix."""
    knobs = dict(slots=3, block_size=4, n_blocks=64, max_len=32)
    tight = {"micro": 12, "tiny": 10}[preset]

    def mk(n_blocks=64):
        return build_engine(preset, serving={**knobs, "n_blocks": n_blocks,
                                             "block_size": 4},
                            rng_seed=5, device="cpu")

    vocab = mk().cfg.vocab_size
    rng = np.random.default_rng(23)
    wave = [(rng.integers(0, vocab, size=7), 14,
             {"temperature": 0.9, "top_p": 0.85}) for _ in range(3)]
    first = mk()
    rids, records, finished = _export_after(first, wave, 6)
    ref = _streams(first, rids)
    assert any(0 < len(r["tokens"]) < 14 for r in records)
    second = mk(tight)
    victims = _Victims(second)
    assert _resumed_streams(second, records, finished, rids) == ref
    resumed = [(floor, kept) for floor, kept in victims.kept if floor]
    assert resumed, "the tight pool never preempted a resumed slot"
    by_floor = {len(r["tokens"]): r["tokens"] for r in records}
    for floor, kept in resumed:
        assert kept == by_floor[floor]


#: (spec_k, micro_k) of the cross-package grid.
PATHS = [(0, 1), (0, 4), (3, 1), (3, 4)]


@pytest.mark.parametrize("spec_k,micro_k", PATHS)
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_resume_crosses_packages(kv_dtype, spec_k, micro_k):
    """The same wave, exported from each package's engine after the same
    steps: the records are equal, and the JAX records resume in the port,
    the port's in JAX, with the streams of the uninterrupted JAX engine
    (a spec engine's sampled streams: of the JAX engine's own resume)."""
    over = dict(kv_dtype=kv_dtype, spec_k=spec_k, micro_k=micro_k)
    wave = _wave(64)
    jax_first, port_first = _pair(**over)
    j_rids, j_records, j_done = _export_after(jax_first, wave, 4)
    p_rids, p_records, p_done = _export_after(port_first, wave, 4)
    assert p_records == j_records
    assert any(0 < len(r["tokens"]) for r in p_records)
    # An export leaves its engine untouched: draining it on gives the
    # uninterrupted streams.
    want = _streams(jax_first, j_rids)
    assert _streams(port_first, p_rids) == want
    jax_second, port_second = _pair(**over, n_blocks=18)
    from_jax = _resumed_streams(port_second, j_records, j_done, j_rids)
    from_port = _resumed_streams(jax_second, p_records, p_done, p_rids)
    assert from_jax == from_port
    sampled = [i for i, (_, _, kw) in enumerate(wave) if "temperature" in kw]
    for i, stream in enumerate(from_jax):
        if spec_k and i in sampled:
            continue                  # the reference is JAX's own resume
        assert stream == want[i], i
    assert port_second.stats()["goodput"]["tokens"]["reingested"] == \
        sum(len(r["tokens"]) for r in j_records)


def test_records_equal_jax_with_sla_fields():
    """The same submissions with SLA fields, stepped alike, export the
    same records key for key; ``deadline_s`` (remaining seconds) within
    0.05 s, since each engine reads its own clock."""
    jax_engine, port = _pair()
    wave = _wave(64)
    sla = [{"slo_class": "premium", "deadline_s": 30.0},
           {"slo_class": "best_effort"}, {"deadline_s": 10.0},
           {"slo_class": "premium"}, {"slo_class": "no-such-class",
                                      "deadline_s": 20.0}]
    for engine in (jax_engine, port):
        for (p, n, kw), extra in zip(wave, sla):
            engine.submit(p, n, **kw, **extra)
    for engine in (jax_engine, port):
        for _ in range(3):
            engine.step()
    want, got = jax_engine.export_inflight(), port.export_inflight()
    assert json.loads(json.dumps(got)) == got
    assert [set(r) for r in got] == [set(r) for r in want]
    for g, w in zip(got, want):
        assert g.pop("deadline_s", None) == pytest.approx(
            w.pop("deadline_s", None), abs=0.05)
    assert got == want
    for r in got:
        assert all(type(v) in (int, float, str, list, type(None))
                   for v in r.values())


def test_next_admit_index_is_class_then_edf_with_fifo_fallback():
    """``tests/test_sla.py:179``'s cases on the port's engine."""
    eng = object.__new__(ServingEngine)
    eng._queue = deque(SimpleNamespace(deadline=d)
                       for d in (None, 30.0, 10.0))
    assert ServingEngine._next_admit_index(eng) == 2
    eng._queue = deque(SimpleNamespace(deadline=None) for _ in range(3))
    assert ServingEngine._next_admit_index(eng) == 0
    eng._queue = deque([
        SimpleNamespace(deadline=10.0, slo_class="best_effort"),
        SimpleNamespace(deadline=30.0, slo_class="premium"),
        SimpleNamespace(deadline=20.0, slo_class="premium"),
    ])
    assert ServingEngine._next_admit_index(eng) == 2
    eng._queue = deque([SimpleNamespace(deadline=None, slo_class="standard"),
                        SimpleNamespace(deadline=None, slo_class="premium")])
    assert ServingEngine._next_admit_index(eng) == 1


@pytest.mark.parametrize("slots,admit_seq,want", [
    # all default: the youngest admission
    ([(None, None), (None, None), (None, None)], [3, 1, 2], 0),
    # the lowest class first, however old
    ([("premium", None), ("best_effort", 5.0), ("standard", None)],
     [3, 1, 2], 1),
    # same class: no deadline is infinite slack
    ([("standard", 5.0), ("standard", None), ("standard", 9.0)],
     [3, 1, 2], 1),
    # same class, deadlines: the most slack, then the youngest
    ([("standard", 5.0), ("standard", 9.0), ("standard", 9.0)],
     [3, 1, 2], 2),
    # an unknown class ranks as standard
    ([("premium", None), ("typo", None), (None, 1.0)], [1, 2, 3], 1),
])
def test_victim_is_least_protected_most_slack_youngest(slots, admit_seq,
                                                       want):
    eng = object.__new__(ServingEngine)
    eng._slots = [SimpleNamespace(slo_class=c or "standard", deadline=d)
                  for c, d in slots] + [None]
    eng._admit_seq = admit_seq + [9]
    assert ServingEngine._victim(eng) == want
    assert class_rank("typo") == class_rank("standard")
    assert SLO_CLASSES == ("premium", "standard", "best_effort")


def test_sla_wave_admission_victims_and_streams_equal_jax():
    """Mixed classes and deadlines into a pool that must preempt: each
    step admits the same requests, the same requests are preempted in
    the same order, and the streams are equal."""
    jax_engine, port = _pair(n_blocks=12)
    rng = np.random.default_rng(5)
    sla = [{"slo_class": "best_effort"}, {"slo_class": "premium",
                                          "deadline_s": 90.0},
           {"deadline_s": 30.0}, {"slo_class": "premium"},
           {"slo_class": "best_effort", "deadline_s": 5.0},
           {"deadline_s": 60.0}, {}, {"slo_class": "premium",
                                       "deadline_s": 45.0}]
    runs = []
    for engine in (jax_engine, port):
        victims = _Victims(engine)
        for i, extra in enumerate(sla):
            kw = {"temperature": 0.8, "key": [i, 3]} if i % 3 == 1 else {}
            engine.submit(rng.integers(0, 64, size=6 + i), 10, **kw,
                          **extra)
        admitted = []
        while engine.has_work:
            admitted.append(engine.step()["admitted"])
        runs.append((admitted, victims.rids, engine.drain()))
        rng = np.random.default_rng(5)
    assert runs[0][1], "the pool never preempted"
    assert runs[1] == runs[0]


RECORD = dict(rid=4, prompt=[1, 2, 3], tokens=[5, 6], key=[1, 2],
              max_new_tokens=6, temperature=0.0, top_p=1.0, eos_token=None,
              slo_class="standard", generation=0)


@pytest.mark.parametrize("change,match,jax_says", [
    ({"prompt": []}, "at least one token", "same"),
    ({"max_new_tokens": 0}, "max_new_tokens must be >= 1", "same"),
    ({"tokens": [1] * 7}, "carries 7 tokens", "same"),
    ({"prompt": [1] * 40, "max_new_tokens": 9}, "exceeds max_len", "same"),
    ({"prompt": [1] * 20, "max_new_tokens": 20}, "pool holds", "same"),
    ({"adapter_id": "tenant-a"}, "lora_rank 0", "same"),
    # Neither engine holds generation 1 nor has a param loader.
    ({"generation": 1}, "different weights", "same"),
    ({"key": [1, 2, 3]}, "uint32", "other"),
    # The port's own check: an out-of-vocab id would fault on the card.
    ({"tokens": [64]}, "must lie in", None),
])
def test_resume_refuses_bad_records(change, match, jax_says):
    """Every refusal of ``resume_inflight``, with the JAX engine's message
    where it has the same check; a refused record adds nothing."""
    jax_engine, port = _pair(n_blocks=10)
    record = {**RECORD, **change}
    with pytest.raises(ValueError, match=match):
        port.resume_inflight([record])
    assert port.queue_depth == 0 and not port._requests
    if jax_says:
        with pytest.raises(ValueError,
                           match=match if jax_says == "same" else None):
            jax_engine.resume_inflight([record])


def test_finished_record_imports_done_and_adapter_submit_raises():
    port = build_engine("micro", device="cpu")
    mapping = port.resume_inflight([{**RECORD, "tokens": [5] * 6,
                                     "generation": 3}])
    rid = mapping[4]
    assert port.request(rid).status == DONE and port.result(rid) == [5] * 6
    assert not port.has_work
    assert port.stats()["goodput"]["tokens"]["reingested"] == 0
    with pytest.raises(ValueError, match="lora_rank > 0"):
        port.submit([1, 2], 3, adapter_id="tenant-a")
    rid = port.submit([1, 2], 3, slo_class="premium", deadline_s=2.5)
    req = port.request(rid)
    assert req.slo_class == "premium" and req.generation == port.generation
    assert 0 < req.deadline - req.submit_t == pytest.approx(2.5)


def test_goodput_counts_reingest_and_preempt_discount_like_jax():
    """Resumed into a tight pool: the port's meter counts the re-ingested
    prefix and the rolled-back tokens (never the imported ones) as the
    JAX meter does."""
    _, port_first = _pair()
    wave = _wave(64)
    rids, records, done = _export_after(port_first, wave, 4)
    jax_engine, port = _pair(obs=Obs.create("resume-goodput"), n_blocks=12)
    outs, meters = [], []
    for engine in (jax_engine, port):
        victims = _Victims(engine)
        outs.append(_resumed_streams(engine, records, done, rids))
        meters.append(engine.stats()["goodput"])
        assert victims.rids
    assert outs[1] == outs[0]
    jg, pg = meters
    assert pg["tokens"] == jg["tokens"]
    assert pg["ratio"] == jg["ratio"] < 1
    assert pg["tokens"]["reingested"] == sum(len(r["tokens"])
                                             for r in records) > 0
    assert pg["tokens"]["preempted"] > 0


def test_micro_k_export_lands_on_token_boundaries():
    """``tests/test_serving_micro.py:176`` on the port: an export from a K
    = 4 engine, taken between steps, resumes token-identically at K = 1
    and 4, because a micro-step commits its tokens at the host sweep."""
    wave = [(p, n, {**kw, "eos_token": 7}) for p, n, kw in _wave(64, 8)]
    ref_engine = build_engine("micro", device="cpu")
    ref = _streams(ref_engine, _submit(ref_engine, wave))
    first = build_engine("micro", serving={"micro_k": 4}, device="cpu")
    rids = _submit(first, wave)
    while first.micro_steps < 2:
        first.step()
    records = json.loads(json.dumps(first.export_inflight()))
    done = {r: first.result(r) for r in rids
            if first.request(r).status == DONE}
    assert records
    for resume_k in (1, 4):
        sibling = build_engine("micro", serving={"micro_k": resume_k},
                               device="cpu")
        assert _resumed_streams(sibling, records, done, rids) == ref
