"""The collectives of a mesh's ranks, each with its gradient: the port's
counterpart of the ``psum``, ``all_gather``, ``all_to_all`` and
``ppermute`` that JAX's SPMD programs run and differentiate.

Every collective runs on the ``torch.distributed`` group of one mesh axis
(:meth:`Mesh.group`), is counted on the mesh by kind as ``[calls,
seconds, bytes]`` (:func:`collective_stats`; the bytes are the rank's
input to the call), and is its own input at an axis of one. :func:`all_reduce`, :func:`all_to_all` and the weight gather
:func:`gather_cast` are ``torch.autograd.Function``s (:func:`all_gather`
carries no gradient); each backward is another collective, counted the
same way. Which one depends on how the ranks of the axis use the result,
and the caller says so:

- **The ranks hold partial cotangents** (an axis the batch shards over:
  each rank back-propagates its own rows' loss): the backward is the
  conjugate. An all-reduce goes back as an all-reduce, an all-gather as a
  reduce-scatter, an all-to-all as the reverse all-to-all.
- **The ranks compute the same thing downstream** (``tp``, over which
  activations are replicated: each rank's cotangent is already the whole
  one): an all-reduce goes back as the identity and an all-gather as the
  rank's slice. :func:`sum_grads` is the other half of that pair, the
  identity forward and an all-reduce backward (Megatron-LM's ``f`` to the
  all-reduce's ``g``).

A reduce-scatter is an all-to-all of the rank's pieces and their sum
(half an all-reduce's bytes): gloo's reduce_scatter was never checked with
CUDA tensors. Only the collectives of :data:`GLOO_CUDA_COLLECTIVES` take a
CUDA tensor.

:func:`ppermute` (the ring's hop: send to the next position on the axis,
receive from the previous one) and :func:`exchange` (uneven pieces to
named positions: the zigzag ring's re-layout) are one call of
``dist.all_to_all_single`` with uneven split sizes, zero for every rank
but the ones that trade. On an H100 (torch 2.11, CUDA 12.8; ``chip_p2p.py``
at the repository's root) gloo took CUDA tensors that way, 2 and 4 ranks
on one card, and moved 8 MB of bf16 to the neighbour in 7.1-14.3 ms over
two runs, within the spread of a copy through pinned host memory and
gloo's send/recv (7.2-15.7 ms); gloo's send/recv itself refuses a CUDA
tensor (``writev ... Bad address``). So every hop takes that one path, on
either device, and moves only its own bytes (an even all_to_all with zero
rows would move the axis size times as many). :func:`pipeline_hop` (a
pipeline tick's forward to the next position and gradient to the previous
one, an open chain) is such a call too, counted as ``"pipeline_hop"``;
:func:`all_reduce_as` is an all-reduce counted under a kind of its own."""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_task_torch.ml.parallel.sharding import mesh_axis_size as axis_size

#: The collectives gloo was found to run on CUDA tensors itself (an H100,
#: torch 2.11): all_reduce, all_gather and all_to_all (even and uneven
#: split sizes), and ppermute, which is an uneven all_to_all; so none is
#: staged by hand. A collective outside this set (send/recv,
#: reduce_scatter) refuses a CUDA tensor (:func:`_counted`) until it is
#: checked on the card or staged through pinned host memory.
GLOO_CUDA_COLLECTIVES = frozenset({"all_reduce", "all_gather", "all_to_all",
                                   "ppermute"})


class CollectiveError(RuntimeError):
    """A collective that gloo is not known to run on a CUDA tensor."""


@contextlib.contextmanager
def _counted(mesh, kind: str, x: torch.Tensor, op: str = None):
    """Count one collective under ``kind``; ``op`` (default ``kind``) is
    the gloo collective it runs."""
    op = op or kind
    if x.is_cuda and op not in GLOO_CUDA_COLLECTIVES:
        raise CollectiveError(
            f"gloo's {op} is not known to take CUDA tensors")
    t0 = time.perf_counter()
    yield
    entry = mesh.collectives.setdefault(kind, [0, 0.0, 0])
    entry[0] += 1
    entry[1] += time.perf_counter() - t0
    entry[2] += x.numel() * x.element_size()


def collective_stats(mesh) -> Dict[str, Dict[str, float]]:
    """This process's collectives by kind: calls, host ms and the bytes
    this rank handed them."""
    return {kind: {"calls": n, "ms": s * 1e3, "bytes": b}
            for kind, (n, s, b) in sorted(mesh.collectives.items())}


# -- the plain collectives -----------------------------------------------------

def _reduce(mesh, x: torch.Tensor, axis: str, op: str = "sum",
            kind: str = "all_reduce"):
    out = x.contiguous().clone()
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    with _counted(mesh, kind, out, "all_reduce"):
        dist.all_reduce(out, op=red, group=mesh.group(axis))
    return out


def _gather(mesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    with _counted(mesh, "all_gather", x):
        dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts, dim=dim)


def _exchange(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    with _counted(mesh, "all_to_all", x):
        dist.all_to_all_single(out, x, group=mesh.group(axis))
    return out


def _route(mesh, flat: torch.Tensor, axis: str, send: Sequence[int],
           recv: Sequence[int], kind: str) -> torch.Tensor:
    """One uneven all_to_all of the 1-d ``flat``: its first ``send[0]``
    elements to axis position 0, the next ``send[1]`` to position 1, ...;
    returns what each position sent here, concatenated in position order
    (``recv[j]`` elements from position j)."""
    out = flat.new_empty(sum(recv))
    with _counted(mesh, kind, flat, "all_to_all"):
        dist.all_to_all_single(out, flat, output_split_sizes=list(recv),
                               input_split_sizes=list(send),
                               group=mesh.group(axis))
    return out


def _reduce_scatter(mesh, x: torch.Tensor, axis: str,
                    dim: int) -> torch.Tensor:
    """This rank's piece along ``dim`` of ``x`` summed over the axis: each
    rank sends piece i to rank i and sums the pieces it receives, in rank
    order."""
    n = axis_size(mesh, axis)
    pieces = torch.stack(x.chunk(n, dim=dim))
    return _exchange(mesh, pieces, axis).sum(dim=0)


def _slice(mesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """This rank's piece of ``x`` along ``dim``, cut into the axis's
    positions."""
    return x.chunk(axis_size(mesh, axis), dim=dim)[
        mesh.axis_index(axis)].contiguous()


# -- with gradients ------------------------------------------------------------

class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, op, conjugate):
        ctx.mesh, ctx.axis, ctx.conjugate = mesh, axis, conjugate
        return _reduce(mesh, x, axis, op)

    @staticmethod
    def backward(ctx, g):
        if ctx.conjugate:
            g = _reduce(ctx.mesh, g, ctx.axis)
        return g, None, None, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(ctx.mesh, g, ctx.axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(mesh, x, axis)

    @staticmethod
    def backward(ctx, g):
        # Row i of the output is row (this rank) of rank i's input, so the
        # cotangent goes back by the same exchange.
        return _exchange(ctx.mesh, g, ctx.axis), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, flat, mesh, axis, send, recv):
        ctx.mesh, ctx.axis, ctx.send, ctx.recv = mesh, axis, send, recv
        return _route(mesh, flat, axis, send, recv, "all_to_all")

    @staticmethod
    def backward(ctx, g):
        # Each piece's cotangent goes back to the position it came from.
        return (_route(ctx.mesh, g.contiguous(), ctx.axis, ctx.recv,
                       ctx.send, "all_to_all"), None, None, None, None)


class _Gather(torch.autograd.Function):
    """``x`` cast to ``dtype`` and all-gathered along each ``(axis, dim,
    conjugate)`` in turn. The backward takes the cotangent to float32,
    reduces it over each conjugate axis and slices it, in reverse order,
    and returns it in ``x``'s type: a float32 master weight gathered in
    bf16 gets its gradient summed in float32."""

    @staticmethod
    def forward(ctx, x, mesh, gathers, dtype):
        ctx.mesh, ctx.gathers, ctx.dtype = mesh, gathers, x.dtype
        out = x.to(dtype)
        for axis, dim, _ in gathers:
            out = _gather(mesh, out, axis, dim)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.to(torch.float32)
        for axis, dim, conjugate in reversed(ctx.gathers):
            g = (_reduce_scatter if conjugate else _slice)(ctx.mesh, g,
                                                           axis, dim)
        return g.to(ctx.dtype), None, None, None


def all_reduce(mesh, x: torch.Tensor, axis: str, op: str = "sum",
               conjugate: bool = False) -> torch.Tensor:
    """``x`` summed (or, ``op="max"``, maxed, without a gradient) over
    mesh axis ``axis``: a new tensor; ``x`` itself at an axis of one. The
    backward is the identity (the ranks of the axis hold the whole
    cotangent: the ``tp`` products' partial sums) or, with ``conjugate``,
    an all-reduce (each rank holds a part: statistics averaged over the
    batch's shards)."""
    if axis_size(mesh, axis) == 1:
        return x
    if op != "sum":
        return _reduce(mesh, x, axis, op)
    return _AllReduce.apply(x, mesh, axis, op, conjugate)


def all_reduce_as(mesh, x: torch.Tensor, axis: str,
                  kind: str) -> torch.Tensor:
    """``x`` summed over ``axis`` without a gradient, counted under
    ``kind`` rather than ``"all_reduce"`` (the pipeline's end reductions,
    each read on its own)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _reduce(mesh, x, axis, kind=kind)


def sum_grads(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``axis``: a replicated
    activation entering products that each rank of the axis runs on its own
    columns (the ``tp`` heads and hidden units)."""
    if axis_size(mesh, axis) == 1 or not torch.is_grad_enabled():
        return x
    return _SumGrads.apply(x, mesh, axis)


def all_gather(mesh, x: torch.Tensor, axis: str,
               dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axis``, concatenated on ``dim`` in axis
    order, without a gradient (serving's pieces and token ids; a training
    weight is gathered by :func:`gather_cast`)."""
    if axis_size(mesh, axis) == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("all_gather carries no gradient: use gather_cast")
    return _gather(mesh, x, axis, dim)


def gather_cast(mesh, x: torch.Tensor,
                gathers: Sequence[Tuple[str, int, bool]],
                dtype: torch.dtype) -> torch.Tensor:
    """``x`` cast to ``dtype`` and then all-gathered along each ``(axis,
    dim, conjugate)`` of ``gathers`` in order (an axis of one is skipped);
    the gradient comes back summed in float32 and in ``x``'s type
    (:class:`_Gather`). The cast comes first, so a bf16 use of a float32
    weight moves half the bytes."""
    gathers = tuple(g for g in gathers if axis_size(mesh, g[0]) > 1)
    if not gathers:
        return x.to(dtype)
    return _Gather.apply(x, mesh, gathers, dtype)


def all_to_all(mesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)``: ``x`` (n, ...) with n the axis size; row i of the
    result is row (this rank's index) of rank i's ``x``. Its backward is
    the same exchange of the cotangent."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis}={n} needs a leading "
                         f"dim of {n}, got {tuple(x.shape)}")
    return _AllToAll.apply(x, mesh, axis)


def exchange(mesh, pieces: Sequence[Tuple[int, torch.Tensor]], axis: str,
             incoming: Sequence[Tuple[int, Tuple[int, ...]]]
             ) -> list:
    """Uneven pieces to named positions of ``axis``, with a gradient: each
    ``(position, tensor)`` of ``pieces`` goes to that position, and this
    rank receives one tensor of each ``(position, shape)`` of
    ``incoming``, from that position. Pieces between one pair of positions
    arrive in the order they were listed, so every rank lists its pieces
    by destination and its incoming ones by source, each pair's in an
    order both sides know. One uneven all_to_all (counted as one), its
    backward the reverse exchange; the tensors share one type. Returns the
    received tensors in ``incoming``'s order."""
    n = axis_size(mesh, axis)
    order = sorted(range(len(pieces)), key=lambda j: pieces[j][0])
    send, recv = [0] * n, [0] * n
    for j in order:
        send[pieces[j][0]] += pieces[j][1].numel()
    sizes = [math.prod(shape) for _, shape in incoming]
    for (src, _), size in zip(incoming, sizes):
        recv[src] += size
    if [src for src, _ in incoming] != sorted(src for src, _ in incoming):
        raise ValueError("incoming pieces must be listed by source position")
    flat = torch.cat([pieces[j][1].reshape(-1) for j in order])
    out = _Exchange.apply(flat, mesh, axis, tuple(send), tuple(recv))
    return [part.view(shape) for part, (_, shape) in
            zip(out.split(sizes), incoming)]


def ppermute(mesh, x: torch.Tensor, axis: str,
             shift: int = 1) -> torch.Tensor:
    """``lax.ppermute(x, axis, [(i, (i + shift) % n)])``: ``x`` goes to the
    position ``shift`` further along ``axis`` and the result is what the
    position ``shift`` before sent, a tensor like ``x``. One uneven
    all_to_all, counted as ``"ppermute"``; no gradient (the rings that use
    it write their own backward)."""
    n = axis_size(mesh, axis)
    if n == 1 or shift % n == 0:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("ppermute carries no gradient")
    i = mesh.axis_index(axis)
    send, recv = [0] * n, [0] * n
    send[(i + shift) % n] = recv[(i - shift) % n] = x.numel()
    return _route(mesh, x.contiguous().reshape(-1), axis, send, recv,
                  "ppermute").view(x.shape)


def pipeline_hop(mesh, axis: str, like: torch.Tensor,
                 forward: Optional[torch.Tensor] = None,
                 backward: Optional[torch.Tensor] = None,
                 receive_forward: bool = False,
                 receive_backward: bool = False) -> tuple:
    """One tick's two hand-offs of a pipeline over ``axis``, an open chain
    (JAX's perms ``[(i, i + 1)]`` forward and ``[(i + 1, i)]`` backward):
    ``forward`` goes to the next position, ``backward`` to the previous
    one, and this rank receives the previous position's forward when
    ``receive_forward`` and the next one's backward when
    ``receive_backward``, each a tensor like ``like``. Which of the four
    happen on every rank follows from the schedule, so a piece that
    nobody sends is never waited for. One uneven all_to_all whose split
    sizes are zero wherever nothing moves, counted as ``"pipeline_hop"``
    (a bubble tick's call moves 0 bytes); no gradient. Returns (the
    received forward, the received backward), None where nothing came."""
    n = axis_size(mesh, axis)
    i = mesh.axis_index(axis)
    if (forward is not None or receive_backward) and i == n - 1:
        raise ValueError(f"position {i} is the last on {axis}: nothing "
                         "follows it")
    if (backward is not None or receive_forward) and i == 0:
        raise ValueError(f"position 0 is the first on {axis}: nothing "
                         "precedes it")
    pieces = [(i - 1, backward), (i + 1, forward)]   # by destination
    pieces = [(j, t) for j, t in pieces if t is not None]
    for _, t in pieces:
        if t.dtype != like.dtype or t.shape != like.shape:
            raise ValueError(f"a {t.dtype} {tuple(t.shape)} hand-off, the "
                             f"pipeline moves {like.dtype} "
                             f"{tuple(like.shape)}")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError("pipeline_hop carries no gradient")
    if n == 1:
        return None, None
    send, recv = [0] * n, [0] * n
    for j, t in pieces:
        send[j] = t.numel()
    if receive_forward:
        recv[i - 1] = like.numel()
    if receive_backward:
        recv[i + 1] = like.numel()
    flat = (torch.cat([t.reshape(-1) for _, t in pieces]) if pieces
            else like.new_empty(0))
    out = iter(_route(mesh, flat, axis, send, recv, "pipeline_hop").split(
        [like.numel()] * (int(receive_forward) + int(receive_backward))))
    got_forward = next(out).view(like.shape) if receive_forward else None
    got_backward = next(out).view(like.shape) if receive_backward else None
    return got_forward, got_backward


__all__ = ["CollectiveError", "GLOO_CUDA_COLLECTIVES", "all_gather",
           "all_reduce", "all_reduce_as", "all_to_all", "collective_stats",
           "exchange", "gather_cast", "pipeline_hop", "ppermute",
           "sum_grads"]
