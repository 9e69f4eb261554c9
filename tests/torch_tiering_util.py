"""The host-tier tests' engines and session workload
(``tests/test_torch_tiering_engine.py``,
``tests/test_torch_tiering_paths.py``): each package's engine of the
``micro`` preset through its own ``build_engine`` (the same weights bit
for bit), ``tests/test_kv_tiering.py``'s multi-turn sessions, and what a
parity check reads after each drain."""

import numpy as np

from tpu_task.serve.replica import build_engine as jax_build_engine
from tpu_task_torch.serve.replica import build_engine
from torch_port_util import share_jax_programs

#: ``tests/test_kv_tiering.py``'s soak engine: a pool of about two
#: sessions' final contexts under a 256-block host tier.
SOAK = dict(slots=2, block_size=4, n_blocks=18, max_len=64,
            host_offload_blocks=256)
FLEET_KEYS = ("hit_blocks", "miss_blocks", "import_requests",
              "prefetch_blocks")


def jax_engine(kv_client=None, **knobs):
    return share_jax_programs(jax_build_engine(
        "micro", serving=dict(knobs, decode_impl="xla"),
        kv_client=kv_client))


def port_engine(kv_client=None, **knobs):
    return build_engine("micro", serving=knobs, device="cpu",
                        kv_client=kv_client)


def snapshot(engine) -> dict:
    stats = engine.stats()
    return dict(tiering=stats["tiering"],
                kvfleet={k: stats["kvfleet"][k] for k in FLEET_KEYS},
                preemptions=engine.preemption_count)


def session_context(s: int) -> list:
    return list(range(1 + s, 9 + s))


def run_sessions(engine, n_sessions=10, turns=3, max_new=4,
                 kwargs=lambda s, t: {}):
    """``tests/test_kv_tiering.py``'s ``_run_sessions``: every session
    resubmits its whole context each turn and idles in between, with
    ``kwargs(session, turn)`` as its submit keywords. Returns each turn's
    streams and the engine's :func:`snapshot` after its drain."""
    ctxs = [session_context(s) for s in range(n_sessions)]
    turns_out = []
    for t in range(turns):
        rids = {s: engine.submit(np.asarray(ctxs[s], np.int32),
                                 max_new_tokens=max_new, **kwargs(s, t))
                for s in range(n_sessions)}
        out = engine.drain()
        streams = [list(out[rids[s]]) for s in range(n_sessions)]
        turns_out.append((streams, snapshot(engine)))
        for s in range(n_sessions):
            ctxs[s] += streams[s] + [(3 * s + 7 * t) % 60 + 1]
    return turns_out


def sampled_odd(s: int, t: int) -> dict:
    """Keyed sampling on the odd sessions."""
    return ({"temperature": 0.8, "top_p": 0.9, "key": [s, 7 + t]}
            if s % 2 else {})


def assert_turns_equal(got, want, free=None):
    """Streams and snapshots equal JAX's after every drain, and the
    streams a pressure-free engine's."""
    for turn, ((streams, snap), (jstreams, jsnap)) in enumerate(
            zip(got, want)):
        assert streams == jstreams, f"turn {turn}: streams != JAX's"
        assert snap == jsnap, f"turn {turn}"
        if free is not None:
            assert streams == free[turn][0], f"turn {turn}: != pressure-free"
