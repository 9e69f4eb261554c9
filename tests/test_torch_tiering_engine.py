"""The port's tiered serving engine (``ServingConfig(host_offload_blocks=
N)``, ROADMAP A9) against the JAX package's tiered engine, on the
``micro`` preset at fp32 on the CPU (both packages' ``build_engine``, so
the same weights bit for bit).

The workload is ``tests/test_kv_tiering.py``'s session soak: 10 sessions
of 3 turns each, every turn submitting the session's whole context, on a
pool of 18 blocks (about two sessions' worth) with a host tier of 256
blocks; and its preemption-while-demoted case (3 slots, 14 blocks, six
14-token prompts). After every drain the port's streams, its
``stats()["tiering"]`` (every key, ``host_*`` included), its ``kvfleet``
hit, miss and import counts and its preemptions equal the JAX engine's,
and its streams equal a pressure-free port engine's (256 blocks, no
tier): the tier moves KV, never a token. Cases cover the synchronous and
overlapped loops, ``micro_k`` 4, int8, int4 and fp8 pools, greedy and
keyed sampled requests."""

import numpy as np
import pytest

from tpu_task.ml.serving import cache as jcache
from tpu_task_torch.ml.serving import cache as tcache
from torch_tiering_util import (
    SOAK,
    assert_turns_equal,
    jax_engine,
    port_engine,
    run_sessions,
    sampled_odd,
    snapshot,
)

CASES = {
    "sync": dict(),
    "overlap": dict(overlap=True),
    "overlap-k4": dict(overlap=True, micro_k=4),
    "sync-k4-sampled": dict(micro_k=4, sampled=True),
    "overlap-sampled": dict(overlap=True, sampled=True),
    "sync-int8": dict(kv_dtype="int8"),
    "overlap-int8-sampled": dict(overlap=True, kv_dtype="int8",
                                 sampled=True),
    "overlap-int4-k4": dict(overlap=True, kv_dtype="int4", micro_k=4),
    "sync-fp8": dict(kv_dtype="fp8"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_session_soak_matches_jax_after_every_drain(case):
    over = dict(CASES[case])
    if over.get("kv_dtype") == "fp8" and not (tcache.fp8_supported()
                                              and jcache.fp8_supported()):
        pytest.skip("this build stores no float8 e4m3")
    kw = dict(kwargs=sampled_odd) if over.pop("sampled", False) else {}
    got = run_sessions(port_engine(**SOAK, **over), **kw)
    want = run_sessions(jax_engine(**SOAK, **over), **kw)
    free = run_sessions(port_engine(**dict(
        SOAK, n_blocks=256, host_offload_blocks=0), **over), **kw)
    assert_turns_equal(got, want, free)
    tiering = got[-1][1]["tiering"]
    assert tiering["enabled"] and tiering["demoted_blocks"] > 0
    assert tiering["promoted_blocks"] > 0
    assert tiering["host_hits"] == tiering["promoted_blocks"]
    # The capacity law of the JAX test: the pool holds at most two of the
    # ten sessions' final contexts.
    per_session = -(-(8 + 3 * 5) // SOAK["block_size"])
    assert 10 >= 5 * max(1, (SOAK["n_blocks"] - 1) // per_session)


PREEMPT = dict(slots=3, block_size=4, n_blocks=14, max_len=48,
               host_offload_blocks=128)


def run_preempting(engine):
    prompts = [(np.arange(14, dtype=np.int32) * (s + 2)) % 60 + 1
               for s in range(6)]
    rids = [engine.submit(p, max_new_tokens=10) for p in prompts]
    out = engine.drain()
    return [list(out[r]) for r in rids], snapshot(engine)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sync", "overlap"])
def test_preemption_while_demoted_matches_jax(overlap):
    """``tests/test_kv_tiering.py``'s preemption-while-demoted case: the
    running requests preempt each other while the prefix cache's tail
    sits demoted; streams, tier counters and preemptions equal JAX's, and
    the streams equal the pressure-free engine's."""
    got, snap = run_preempting(port_engine(**PREEMPT, overlap=overlap))
    want, jsnap = run_preempting(jax_engine(**PREEMPT, overlap=overlap))
    free, _ = run_preempting(port_engine(**dict(
        PREEMPT, n_blocks=256, host_offload_blocks=0)))
    assert got == want == free
    assert snap == jsnap
    assert snap["tiering"]["demoted_blocks"] > 0
    assert snap["preemptions"] > 0
