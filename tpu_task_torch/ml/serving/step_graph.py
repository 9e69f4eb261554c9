"""The K-token micro-step as one CUDA graph.

The JAX package has no module like this one: there the engine wraps
``micro_decode_greedy``/``micro_decode_sample`` in ``compile_step``/
``jax.jit`` (``tpu_task/ml/serving/engine.py:783-830``) and XLA compiles
the ``lax.scan`` of K decode iterations into one program. The port runs
eagerly, so its counterpart of that one program is one CUDA graph of the
K-step loop (:func:`~tpu_task_torch.ml.serving.model._micro_scan`),
captured at first use and replayed once per micro-step. On the CPU, and
over a gang's mesh, the same loop runs eagerly.

There is one graph per program at the engine's K, keyed by (sampled,
lora): greedy or sampled, without or with the LoRA branch; and each has a
CARRY variant for the overlapped loop (``ServingConfig.overlap``), so a
runner holds at most eight. A LoRA variant is captured at the first
micro-step that carries an adapter; a step whose slots carry none replays
the LoRA-free graph (the engine's drop rule). The graph reads fixed input
buffers, so before each replay the host's inputs are copied into them
from a fresh pinned buffer (:func:`upload`; the host may then write the
next step's inputs while this step's copy is still queued): ``tok``,
``pos``, ``tables`` (slots, max_blocks), ``active``, ``limits``, ``eos``
and, for the sampled program, ``temps``, ``tops``, ``keys``, ``ngen``; a
quantized pool adds the stacked write layout, ``touched`` and ``filled``
(K, slots + 1), ``wt`` and ``wo`` (K, slots); the LoRA variant adds the
adapter tables ``lblocks`` (slots, n_layers) and scales ``lscales``
(slots,). The graph writes one (K, slots) token block (and a quantized
pool's largest write error), which the next replay overwrites. The
synchronous loop reads the block back before it sweeps. The overlapped
loop replays program N + 1 before it sweeps N, so each of its dispatches
enqueues its own copy of the block into fresh pinned memory right behind
the replay, with an event after it (:class:`Readback`), and its sweep
waits on that event alone.

The carry variant (:meth:`MicroStepGraphs.dispatch`, at every K, K = 1
included, as the JAX engine compiles its carry program at any K) runs
:func:`~tpu_task_torch.ml.serving.model.micro_carry_greedy` / ``_sample``
from the runner's carry tensors (:attr:`MicroStepGraphs.carry`: tok, pos,
alive, emitted) instead of ``tok``, ``pos``, ``active`` and ``ngen``,
with absolute ``limits``, and writes the new carry back into them in
place at the end of the graph, so the carry stays on the device from
program to program. The engine's eager chunk program updates the same
tensors, and its carry rebuild fills them with a non-blocking copy.

Capture never touches live state: the warm-up before it and the capture
run with every slot inactive, so their writes land in the scratch block
(under a quantized layout every row points at the pad entry, which is the
scratch block). The warm-up also loads the kernels' libraries, their
occupancy queries and the cuBLAS handles, none of which may happen
inside a capture.

A graph is bound to the addresses it captured: the engine's pools are
updated in place (the pools' ``index_copy_`` in
``model.paged_decode_step``, ``cache.quantized_append``'s indexed writes,
``cache.copy_block``, the adapter pool's ``index_copy_`` at an adapter's
load) and never rebound while a graph exists, so a graph reads the
adapters loaded after its capture, and one runner holds one param
generation's weights. Weight hot-swap therefore
gives each generation its own runner: the engine makes it at the
generation's first micro-step, which captures that generation's graphs,
and drops it between two steps once the generation's last stream has
retired, which frees its graphs and, with them, the last reference to its
weights.

A carry variant warms up on a dead carry of its own and is captured over
the live carry tensors: a capture records work without running it.

The paged-attention wrappers count their launches in Python, so under a
graph they count once, at capture. Each capture puts the counters back to
what they were before its warm-up, and its runner adds what the capture
counted at every replay: the counts then read as an eager run of the same
steps, however many runners capture. Nothing falls back: a capture or
replay that fails raises."""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_task_torch.ml.ops import paged_attention as pa
from tpu_task_torch.ml.serving.model import (
    micro_carry_greedy,
    micro_carry_sample,
    micro_decode_greedy,
    micro_decode_sample,
)

#: Every launch counter of the paged-attention wrappers.
_COUNTERS = ((pa.paged_decode_attention, "launches"),
             (pa.paged_decode_attention, "combine_launches"),
             (pa.paged_decode_pipelined_attention, "launches"),
             (pa.paged_decode_pipelined_attention, "combine_launches"),
             (pa.paged_reference_attention, "launches"))


_NUMPY = {torch.int64: np.int64, torch.int32: np.int32,
          torch.bool: np.bool_, torch.float32: np.float32,
          torch.uint8: np.uint8}

#: The loop carry of the overlapped engine's programs: (dtype, value of a
#: dead row), in the order the carry programs take and return it.
CARRY = {"tok": (torch.int64, 0), "pos": (torch.int32, 0),
         "alive": (torch.bool, False), "emitted": (torch.int32, 0)}


def upload(arrays: Dict[str, Tuple[np.ndarray, torch.dtype]],
           device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays on ``device`` without a blocking copy: ``arrays`` maps a
    name to (array, dtype). On a CUDA device the arrays are packed into one
    freshly pinned buffer, each at an 8-byte offset, sent in ONE
    non-blocking copy on the current stream, and returned as views of the
    device buffer. PyTorch's pinned-memory cache does not hand that buffer
    out again before the copy has run, so the caller may rewrite its arrays
    at once, and nothing here waits for work already on the stream. On the
    CPU each array is copied."""
    host = {name: np.ascontiguousarray(a, dtype=_NUMPY[dtype])
            for name, (a, dtype) in arrays.items()}
    if device.type != "cuda":
        return {name: torch.from_numpy(a.copy()) for name, a in host.items()}
    offsets, total = {}, 0
    for name, a in host.items():
        offsets[name] = total
        total += -(-a.nbytes // 8) * 8
    staging = torch.empty((total,), dtype=torch.uint8, pin_memory=True)
    raw = staging.numpy()
    for name, a in host.items():
        raw[offsets[name]:offsets[name] + a.nbytes] = \
            a.reshape(-1).view(np.uint8)
    flat = staging.to(device, non_blocking=True)
    return {name: flat[offsets[name]:offsets[name] + a.nbytes]
            .view(arrays[name][1]).view(a.shape)
            for name, a in host.items()}


class Readback:
    """A dispatched program's tokens (and, when asked, its largest
    quantization error) on their way to the host. On a CUDA device the
    constructor enqueues a copy into a fresh pinned buffer right behind the
    program and records an event after it; :meth:`wait` waits on that
    event alone, never on work enqueued after it, and the copy is the
    program's own, so a later replay that rewrites a graph's output
    buffer cannot change it. On the CPU the tensors are already there."""

    def __init__(self, toks: torch.Tensor,
                 qerr: Optional[torch.Tensor] = None):
        self.event = None
        if toks.device.type == "cuda":
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in (toks, qerr) if t is not None]
            for h, t in zip(host, (toks, qerr)):
                h.copy_(t, non_blocking=True)
            toks, qerr = host[0], (host[1] if qerr is not None else None)
            self.event = torch.cuda.Event()
            self.event.record()
        self._toks, self._qerr = toks, qerr
        self.qerr: Optional[float] = None

    def wait(self) -> np.ndarray:
        """The tokens as a host array (and :attr:`qerr`, when asked for, as
        a float): the consume edge's one wait."""
        if self.event is not None:
            self.event.synchronize()
        if self._qerr is not None:
            self.qerr = float(self._qerr)
        return self._toks.numpy()


def _read_counts() -> Tuple[int, ...]:
    return tuple(getattr(fn, name) for fn, name in _COUNTERS)


def _write_counts(counts) -> None:
    for (fn, name), value in zip(_COUNTERS, counts):
        setattr(fn, name, value)


def store_carry(carry: Dict[str, torch.Tensor], new) -> None:
    """Write a carry program's returned (tok, pos, alive, emitted) back
    into the carry tensors, in place."""
    for buf, value in zip(carry.values(), new):
        buf.copy_(value)


class _Captured:
    """One captured program: its graph, its input buffers, its outputs and
    the launches one replay makes."""

    def __init__(self, graph, bufs, toks, qerr, launches):
        self.graph, self.bufs = graph, bufs
        self.toks, self.qerr, self.launches = toks, qerr, launches


class MicroStepGraphs:
    """Runs an engine's K-token micro-steps: :meth:`run` takes one step's
    host inputs and returns its (K, slots) tokens; :meth:`dispatch` runs
    the overlapped loop's carry program from :attr:`carry` and returns its
    :class:`Readback` without waiting. On a CUDA device each program is a
    CUDA graph; on the CPU, and over a gang's ``mesh`` (whose gloo
    collectives a graph cannot hold), the loop runs eagerly."""

    def __init__(self, params, cfg, pools, *, slots: int, max_blocks: int,
                 micro_k: int, attn_impl: str, measure_qerr: bool,
                 device: torch.device,
                 lora_pool: Optional[torch.Tensor] = None, mesh=None):
        self.params, self.cfg, self.pools = params, cfg, pools
        self.lora_pool = lora_pool
        self.micro_k, self.device = micro_k, device
        self.measure_qerr = measure_qerr
        #: Whether the programs run as CUDA graphs.
        self.graphed = device.type == "cuda" and mesh is None
        self.kwargs = dict(micro_k=micro_k, attn_impl=attn_impl,
                           measure_qerr=measure_qerr, mesh=mesh)
        self.quantized = "k_scale" in pools[0]
        k, n = micro_k, slots
        #: name -> (shape, dtype, the value of an inactive slot)
        self.layout = {
            "tok": ((n,), torch.int64, 0),
            "pos": ((n,), torch.int32, 0),
            "tables": ((n, max_blocks), torch.int32, 0),
            "active": ((n,), torch.bool, False),
            "limits": ((n,), torch.int32, 0),
            "eos": ((n,), torch.int64, -1),
            "temps": ((n,), torch.float32, 0.0),
            "tops": ((n,), torch.float32, 1.0),
            "keys": ((n, 2), torch.int64, 0),
            "ngen": ((n,), torch.int64, 0),
            "touched": ((k, n + 1), torch.int64, 0),
            "filled": ((k, n + 1), torch.int64, 0),
            "wt": ((k, n), torch.int64, n),     # the pad entry: scratch
            "wo": ((k, n), torch.int64, 0),
            "lblocks": ((n, cfg.n_layers), torch.int64, 0),   # scratch
            "lscales": ((n,), torch.float32, 0.0),
        }
        #: The overlapped loop's (tok, pos, alive, emitted), one set for the
        #: runner's generation: the carry graphs read these tensors and
        #: write them back in place, as does the engine's chunk program.
        self.carry = self._dead_carry()
        #: The captured programs by (sampled, lora), and their carry
        #: variants by the same key.
        self._graphs: Dict[Tuple[bool, bool], _Captured] = {}
        self._carry_graphs: Dict[Tuple[bool, bool], _Captured] = {}
        self.captures = 0
        self.lora_captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def _dead_carry(self) -> Dict[str, torch.Tensor]:
        n = self.layout["tok"][0]
        return {name: torch.full(n, idle, dtype=dtype, device=self.device)
                for name, (dtype, idle) in CARRY.items()}

    def _names(self, sampled: bool, lora: bool, carried: bool):
        names = (["tables", "limits", "eos"] if carried else
                 ["tok", "pos", "tables", "active", "limits", "eos"])
        if sampled:
            names += ["temps", "tops", "keys"] + ([] if carried
                                                   else ["ngen"])
        if self.quantized:
            names += ["touched", "filled", "wt", "wo"]
        if lora:
            names += ["lblocks", "lscales"]
        return names

    def _program(self, sampled: bool, lora: bool,
                 t: Dict[str, torch.Tensor],
                 carry: Optional[Dict[str, torch.Tensor]] = None):
        """The K-step loop on the inputs ``t``; with ``carry``, the carry
        program from those tensors, which it then updates in place."""
        qa = ((t["touched"], t["filled"], t["wt"], t["wo"])
              if self.quantized else None)
        params = ({**self.params,
                   "lora": (self.lora_pool, t["lblocks"], t["lscales"])}
                  if lora else self.params)
        if carry is None:
            head = (params, self.cfg, t["tok"], t["pos"], t["tables"],
                    t["active"], t["limits"], t["eos"])
            if sampled:
                return micro_decode_sample(
                    *head, t["temps"], t["tops"], t["keys"], t["ngen"],
                    self.pools, qa, **self.kwargs)
            return micro_decode_greedy(*head, self.pools, qa, **self.kwargs)
        head = (params, self.cfg, *carry.values(), t["tables"], t["limits"],
                t["eos"])
        if sampled:
            out = micro_carry_sample(*head, t["temps"], t["tops"], t["keys"],
                                     self.pools, qa, **self.kwargs)
        else:
            out = micro_carry_greedy(*head, self.pools, qa, **self.kwargs)
        store_carry(carry, out[1])
        return (out[0], out[2]) if self.quantized else out[0]

    def run(self, sampled: bool, inputs: Dict[str, np.ndarray],
            lora: bool = False) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
        """One micro-step: ``inputs`` holds the arrays :attr:`layout` names
        for this program (``lora``: with the adapter tables, through the
        runner's ``lora_pool``). Returns the (K, slots) tokens, read back,
        and for a quantized pool its largest write error as a device
        scalar."""
        if not self.graphed:
            out = self._program(sampled, lora,
                                self._inputs(sampled, lora, False, inputs))
            toks, qerr = out if self.quantized else (out, None)
            return toks.cpu().numpy(), qerr
        cap = self._replay(sampled, lora, False, inputs)
        return cap.toks.cpu().numpy(), cap.qerr

    def dispatch(self, sampled: bool, inputs: Dict[str, np.ndarray],
                 lora: bool = False) -> Readback:
        """One carry micro-step of the overlapped loop, from :attr:`carry`
        (updated in place): ``inputs`` as for :meth:`run` without ``tok``,
        ``pos``, ``active`` and ``ngen``, which the carry holds, and with
        ABSOLUTE ``limits`` (max_new_tokens). Waits for nothing: returns
        the (K, slots) tokens' :class:`Readback` (with the largest write
        error when the runner measures it)."""
        if not self.graphed:
            out = self._program(sampled, lora,
                                self._inputs(sampled, lora, True, inputs),
                                self.carry)
            toks, qerr = out if self.quantized else (out, None)
        else:
            cap = self._replay(sampled, lora, True, inputs)
            toks, qerr = cap.toks, cap.qerr
        return Readback(toks, qerr if self.measure_qerr else None)

    def _inputs(self, sampled: bool, lora: bool, carried: bool,
                inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return upload({name: (inputs[name], self.layout[name][1])
                       for name in self._names(sampled, lora, carried)},
                      self.device)

    def _replay(self, sampled: bool, lora: bool, carried: bool,
                inputs: Dict[str, np.ndarray]) -> _Captured:
        """Copy ``inputs`` into the program's graph (captured at its first
        use) and replay it. The copies come from a fresh pinned buffer
        (:func:`upload`), so the host may write the next step's inputs
        while this one's are still queued."""
        graphs = self._carry_graphs if carried else self._graphs
        cap = graphs.get((sampled, lora))
        if cap is None:
            cap = graphs[sampled, lora] = self._capture(sampled, lora,
                                                        carried)
        for name, value in self._inputs(sampled, lora, carried,
                                        inputs).items():
            cap.bufs[name].copy_(value)
        cap.graph.replay()
        self.replays += 1
        _write_counts(a + b for a, b in zip(_read_counts(), cap.launches))
        return cap

    def _capture(self, sampled: bool, lora: bool, carried: bool
                 ) -> _Captured:
        """Warm up, then capture, with every slot inactive (and, for the
        LoRA variant, every row on the scratch block at scale 0); the
        launch counters end as they began. A carry program warms up on a
        dead carry of its own and is captured over :attr:`carry`: a
        capture records the work without running it, so the live carry is
        not touched."""
        t0 = time.perf_counter()
        before = _read_counts()
        bufs = {}
        for name in self._names(sampled, lora, carried):
            shape, dtype, idle = self.layout[name]
            bufs[name] = torch.full(shape, idle, dtype=dtype,
                                    device=self.device)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._program(sampled, lora, bufs,
                          self._dead_carry() if carried else None)
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        mark = _read_counts()
        graph = torch.cuda.CUDAGraph()
        # A dead engine's graphs freed by the cycle collector in the middle
        # of this capture would invalidate it (a graph's destruction is not
        # permitted while a stream captures): collect first, none during.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                out = self._program(sampled, lora, bufs,
                                    self.carry if carried else None)
        finally:
            if collecting:
                gc.enable()
        torch.cuda.synchronize(self.device)
        launches = tuple(b - a for a, b in zip(mark, _read_counts()))
        _write_counts(before)
        toks, qerr = out if self.quantized else (out, None)
        self.captures += 1
        self.lora_captures += lora
        self.capture_s += time.perf_counter() - t0
        return _Captured(graph, bufs, toks, qerr, launches)

    def stats(self) -> dict:
        return {"captures": self.captures,
                "lora_captures": self.lora_captures,
                "capture_ms": self.capture_s * 1e3,
                "replays": self.replays}
