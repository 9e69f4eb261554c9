"""Helpers of the ``test_torch_parallel_*``, ``test_torch_tp_*`` and
``test_torch_ep_*`` files that every rank of a gang runs: a follower
imports this module by name to run a query, so it imports neither JAX nor
the JAX package (the test modules do both)."""

from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from tpu_task_torch.ml.ops import paged_attention as tpa
from tpu_task_torch.ml.parallel import gang
from tpu_task_torch.ml.serving import cache as tc

#: Seconds a gang's collectives may wait in a test: long enough for the
#: slowest step of a loaded run, short enough that a failure ends fast.
TIMEOUT_S = 120.0


@contextmanager
def cpu_gang(tmp_path, tp: int, ep: int = 1):
    """A gang of ``tp × ep`` CPU ranks rendezvousing under ``tmp_path``,
    closed at the end; yields rank 0's mesh."""
    mesh = gang.start(tp, ep, device="cpu", workdir=tmp_path,
                      timeout_s=TIMEOUT_S)
    try:
        yield mesh
    finally:
        if mesh.gang is not None:
            mesh.gang.close()


def children(pid: int) -> list:
    """The pids whose parent is ``pid`` (read from /proc)."""
    out = []
    for entry in Path("/proc").iterdir():
        if not entry.name.isdigit():
            continue
        try:
            stat = (entry / "stat").read_text()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(entry.name))
    return out


def alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        state = Path(f"/proc/{pid}/stat").read_text().rsplit(")", 1)[1]
    except OSError:
        return False
    return state.split()[0] != "Z"


#: ``stats()`` values that name an implementation, and the port's own
#: keys: every other value of JAX's ``stats()`` is compared.
SKIP_KEYS = {"decode_impl", "draft_decode_impl", "device", "step_graph",
             "attention_launches", "goodput"}


def wave(engine, steps=None, sampled=True):
    """Greedy and (``sampled``) keyed-sampled requests, two sharing a
    two-block prefix; ``steps`` stops after that many steps (else
    drains)."""
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 64, size=8)
    prompts = [np.concatenate([shared, rng.integers(0, 64, size=3)]),
               rng.integers(0, 64, size=6), shared.copy(),
               rng.integers(0, 64, size=13), rng.integers(0, 64, size=3)]
    rids = [engine.submit(p, 7 + i, **({"temperature": 0.8, "top_p": 0.9,
                                        "key": [5, i]}
                                       if sampled and i % 2 else {}))
            for i, p in enumerate(prompts)]
    if steps is not None:
        for _ in range(steps):
            engine.step()
        return rids
    out = engine.drain(max_steps=5000)
    return [out[r] for r in rids]


def shared_stats(jax_stats, port_stats):
    keys = set(jax_stats) - SKIP_KEYS
    return ({k: jax_stats[k] for k in keys},
            {k: port_stats[k] for k in keys})


def paged_inputs(seed: int, kv_dtype=None, slots=4, w=1, h=8, kv=4, d=16,
                 n_blocks=24, bs=4, max_blocks=5):
    """Whole paged-attention inputs from a seed, as numpy: q, k/v pools
    (model-dtype float32, or the port's codes as raw bytes with their
    float32 scales), tables (fragmented, a shared first block, a fresh
    row at 0) and positions."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(slots, w, h, d)).astype(np.float32)
    spread = rng.lognormal(0, 1, (n_blocks, 1, kv, 1))
    kp = (rng.normal(size=(n_blocks, bs, kv, d)) * spread).astype(np.float32)
    vp = (rng.normal(size=(n_blocks, bs, kv, d)) * spread).astype(np.float32)
    tables = np.zeros((slots, max_blocks), np.int32)
    perm = rng.permutation(np.arange(1, n_blocks))
    pos = np.zeros((slots, w), np.int32)
    used = 0
    for s in range(slots):
        depth = int(rng.integers(1, max_blocks * bs - w))
        n_full = (depth + w - 1) // bs + 1
        tables[s, :n_full] = perm[used:used + n_full]
        used += n_full
        pos[s] = depth + np.arange(w)
    tables[1, 0] = tables[0, 0]
    pos[-1, :] = np.arange(w)
    scales = None
    if kv_dtype is not None:
        code = tc.kv_code_dtype(kv_dtype)
        (kc, ks), (vc, vs) = (tc.quantize_blocks(torch.tensor(a), code)
                              for a in (kp, vp))
        kp, vp = (c.view(torch.uint8).numpy() for c in (kc, vc))
        scales = (ks.numpy(), vs.numpy())
    return q, kp, vp, tables, pos, scales


def _torch_pool(raw: np.ndarray, kv_dtype) -> torch.Tensor:
    t = torch.tensor(raw)
    return t if kv_dtype is None else t.view(tc.kv_code_dtype(kv_dtype))


def rank_paged_attention(seed: int, kv_dtype, impl: str, mesh):
    """This rank's kv-head block of :func:`paged_inputs` through
    ``paged_attention(mesh=)`` (each block its own tensor), and the
    unsharded plain version over every head cut to the same block; both
    as numpy."""
    q, kp, vp, tables, pos, scales = paged_inputs(seed, kv_dtype)
    tp, i = dict(mesh.shape)["tp"], mesh.axis_index("tp")
    kv_l, h_l = kp.shape[2] // tp, q.shape[2] // tp
    heads = slice(i * h_l, (i + 1) * h_l)
    kvs = slice(i * kv_l, (i + 1) * kv_l)
    whole = [torch.tensor(q), _torch_pool(kp, kv_dtype),
             _torch_pool(vp, kv_dtype), torch.tensor(tables),
             torch.tensor(pos)]
    whole += ([] if scales is None else [torch.tensor(s) for s in scales])
    mine = [whole[0][:, :, heads].contiguous(),
            whole[1][:, :, kvs].contiguous(),
            whole[2][:, :, kvs].contiguous(), whole[3], whole[4]]
    mine += [s[:, kvs].contiguous() for s in whole[5:]]
    got = tpa.paged_attention(*mine, impl=impl, mesh=mesh)
    ref = tpa.paged_reference_attention(*whole)[:, :, heads]
    return got.numpy(), ref.numpy()


def rank_strided_shard_refused(mesh) -> str:
    """The error ``paged_attention(mesh=)`` gives a strided head view of
    a whole pool."""
    q, kp, vp, tables, pos, _ = paged_inputs(0)
    tp, i = dict(mesh.shape)["tp"], mesh.axis_index("tp")
    kv_l, h_l = kp.shape[2] // tp, q.shape[2] // tp
    try:
        tpa.paged_attention(
            torch.tensor(q)[:, :, i * h_l:(i + 1) * h_l].contiguous(),
            torch.tensor(kp)[:, :, i * kv_l:(i + 1) * kv_l],
            torch.tensor(vp)[:, :, i * kv_l:(i + 1) * kv_l],
            torch.tensor(tables), torch.tensor(pos), mesh=mesh)
    except ValueError as error:
        return str(error)
    return ""


def rank_gqa_tp(seed: int, mesh) -> np.ndarray:
    """``gqa_cached_attention_tp`` of seeded whole arrays, as numpy."""
    from tpu_task_torch.ml.ops.attention import gqa_cached_attention_tp

    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.normal(size=(2, 5, 8, 16)).astype(np.float32))
    k = torch.tensor(rng.normal(size=(2, 12, 4, 16)).astype(np.float32))
    v = torch.tensor(rng.normal(size=(2, 12, 4, 16)).astype(np.float32))
    positions = torch.tensor(rng.integers(0, 12, size=(2, 5)))
    return gqa_cached_attention_tp(q, k, v, positions, mesh).numpy()


def rank_collectives(mesh) -> dict:
    """Each collective on a rank-dependent tensor, as numpy: what the
    collectives' contracts say each rank gets."""
    r = float(mesh.rank)
    x = torch.arange(4, dtype=torch.float32) + 10 * r
    a2a = torch.stack([torch.full((3,), 10 * r + j)
                       for j in range(dict(mesh.shape)["tp"])])
    return {"sum": gang.all_reduce(mesh, x, "tp").numpy(),
            "max": gang.all_reduce(mesh, x, "tp", op="max").numpy(),
            "gather": gang.all_gather(mesh, x[None], "tp", dim=1).numpy(),
            "a2a": gang.all_to_all(mesh, a2a, "tp").numpy(),
            "coords": mesh.coords()}


def rank_raises(mesh, rank: int) -> int:
    """Raise on ``rank`` (a follower's failure, for rank 0 to report)."""
    if mesh.rank == rank:
        raise RuntimeError(f"planted failure on rank {rank}")
    return mesh.rank
