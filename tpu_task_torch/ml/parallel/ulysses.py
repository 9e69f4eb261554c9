"""All-to-all (Ulysses) context parallelism — the counterpart of
``tpu_task/ml/parallel/ulysses.py``.

The second context-parallel mode beside the ring
(:mod:`~tpu_task_torch.ml.parallel.ring_attention`): two all_to_alls
reshard the activations from sequence-sharded to head-sharded and back, so
each rank holds the whole sequence for its group of heads and attention
is the port's :func:`~tpu_task_torch.ml.ops.attention.dot_product_attention`
at full length (the flash kernels wherever its routing rule admits the
shape). The reshards are :func:`collectives.all_to_all`, whose backward is
the reverse exchange, so plain autograd differentiates the whole.

The parallel degree is capped by the head count (``heads % sp == 0``); the
ring has no such cap. Each rank takes its contiguous chunk of the
sequence, the layout JAX's ``activation_spec`` gives; the cut itself
(:func:`~tpu_task_torch.ml.parallel.mesh.sequence_piece`) raises JAX's
ValueError for a sequence the axis does not divide."""

from __future__ import annotations

from typing import List

import torch

from tpu_task_torch.ml.ops.attention import (
    dot_product_attention,
    expand_kv_heads,
)
from tpu_task_torch.ml.parallel import collectives
from tpu_task_torch.ml.parallel.sharding import mesh_axis_size


def _seq_to_heads(tensors, mesh, axis: str) -> List[torch.Tensor]:
    """Each (b, s/P, h, d) local → (b, s, h/P, d) local: split the heads,
    gather the sequence in rank order (``lax.all_to_all(split_axis=2,
    concat_axis=1, tiled=True)``). q, k and v share one all_to_all, their
    head groups side by side in each rank's piece."""
    n = mesh_axis_size(mesh, axis)
    b, s, _, d = tensors[0].shape
    widths = [t.shape[2] // n for t in tensors]
    pieces = torch.cat([t.reshape(b, s, n, w, d).permute(2, 0, 1, 3, 4)
                        for t, w in zip(tensors, widths)], dim=3)
    got = collectives.all_to_all(mesh, pieces.contiguous(), axis)
    return [g.permute(1, 0, 2, 3, 4).reshape(b, n * s, w, d)
            for g, w in zip(got.split(widths, dim=3), widths)]


def _heads_to_seq(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(b, s, h/P, d) local → (b, s/P, h, d) local: the inverse reshard."""
    n = mesh_axis_size(mesh, axis)
    b, s, h, d = x.shape
    pieces = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4)
    got = collectives.all_to_all(mesh, pieces.contiguous(), axis)
    return got.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


def ulysses_attention_shard(q, k, v, mesh, axis_name: str = "sp",
                            causal: bool = True):
    """Per-rank body on (b, s/P, heads, d) chunks. k/v may arrive at
    kv-head width (GQA): the all_to_all then moves narrow bytes and the
    expansion to the rank's query heads happens after the reshard, exact
    because q head j reads kv head j // group and each rank's contiguous
    query heads map onto its contiguous kv heads. Needs kv_heads % P == 0
    (:func:`ulysses_attention` widens before the shard otherwise)."""
    qh, kh, vh = _seq_to_heads((q, k, v), mesh, axis_name)
    heads = qh.shape[2]
    kh, vh = expand_kv_heads(kh, heads), expand_kv_heads(vh, heads)
    out = dot_product_attention(qh, kh, vh, causal)
    return _heads_to_seq(out, mesh, axis_name)


def ulysses_attention(q, k, v, mesh, axis_name: str = "sp",
                      causal: bool = True, batch_axes=None):
    """All-to-all context-parallel attention on this rank's contiguous
    chunk (b, s/P, heads, d), ``heads % sp == 0``. Narrow k/v cross the
    all_to_all narrow when ``kv_heads % sp == 0``, else they widen before
    the shard (the saving forfeited, the math exact). The batch dim is the
    rank's own rows already; ``batch_axes`` is kept for JAX's
    signature."""
    devices = mesh_axis_size(mesh, axis_name)
    heads = q.shape[2]
    if heads % devices:
        raise ValueError(
            f"ulysses needs heads ({heads}) divisible by {axis_name} "
            f"({devices}); use the ring for higher parallel degrees")
    kv_heads = k.shape[2]
    if kv_heads != heads and kv_heads % devices:
        k = expand_kv_heads(k, heads)
        v = expand_kv_heads(v, heads)
    return ulysses_attention_shard(q, k, v, mesh, axis_name, causal)


__all__ = ["ulysses_attention", "ulysses_attention_shard"]
