"""The K-token micro-step as one CUDA graph.

The JAX package has no module like this one: there the engine wraps
``micro_decode_greedy``/``micro_decode_sample`` in ``compile_step``/
``jax.jit`` (``tpu_task/ml/serving/engine.py:783-830``) and XLA compiles
the ``lax.scan`` of K decode iterations into one program. The port runs
eagerly, so its counterpart of that one program is one CUDA graph of the
K-step loop (:func:`~tpu_task_torch.ml.serving.model._micro_scan`),
captured at first use and replayed once per micro-step. On the CPU the
same loop runs eagerly.

There is one graph per program at the engine's K, keyed by (sampled,
lora): greedy or sampled, without or with the LoRA branch, so a runner
holds at most four. A LoRA variant is captured at the first micro-step
that carries an adapter; a step whose slots carry none replays the
LoRA-free graph (the engine's drop rule). The graph reads fixed input
buffers, so before each replay the host's inputs are copied into them:
``tok``, ``pos``, ``tables`` (slots, max_blocks), ``active``,
``limits``, ``eos`` and, for the sampled program, ``temps``, ``tops``,
``keys``, ``ngen``; a quantized pool adds the stacked write layout,
``touched`` and ``filled`` (K, slots + 1), ``wt`` and ``wo`` (K, slots);
the LoRA variant adds the adapter tables ``lblocks`` (slots, n_layers)
and scales ``lscales`` (slots,). The graph writes one (K, slots) token
block (and a quantized pool's largest write error); the host copies the
block out before it sweeps, so the next replay cannot overwrite what it
reads.

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
          torch.bool: np.bool_, torch.float32: np.float32}


def _read_counts() -> Tuple[int, ...]:
    return tuple(getattr(fn, name) for fn, name in _COUNTERS)


def _write_counts(counts) -> None:
    for (fn, name), value in zip(_COUNTERS, counts):
        setattr(fn, name, value)


class _Captured:
    """One captured program: its graph, its input buffers (and their
    pinned host staging), its outputs and the launches one replay makes."""

    def __init__(self, graph, bufs, staging, toks, qerr, launches):
        self.graph, self.bufs, self.staging = graph, bufs, staging
        self.toks, self.qerr, self.launches = toks, qerr, launches


class MicroStepGraphs:
    """Runs an engine's K-token micro-steps: :meth:`run` takes one step's
    host inputs and returns its (K, slots) tokens. On a CUDA device each
    program is a CUDA graph; on the CPU the loop runs eagerly."""

    def __init__(self, params, cfg, pools, *, slots: int, max_blocks: int,
                 micro_k: int, attn_impl: str, measure_qerr: bool,
                 device: torch.device,
                 lora_pool: Optional[torch.Tensor] = None):
        self.params, self.cfg, self.pools = params, cfg, pools
        self.lora_pool = lora_pool
        self.micro_k, self.device = micro_k, device
        self.kwargs = dict(micro_k=micro_k, attn_impl=attn_impl,
                           measure_qerr=measure_qerr)
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
        self._graphs: Dict[Tuple[bool, bool], _Captured] = {}
        self.captures = 0
        self.lora_captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def _names(self, sampled: bool, lora: bool):
        names = ["tok", "pos", "tables", "active", "limits", "eos"]
        if sampled:
            names += ["temps", "tops", "keys", "ngen"]
        if self.quantized:
            names += ["touched", "filled", "wt", "wo"]
        if lora:
            names += ["lblocks", "lscales"]
        return names

    def _program(self, sampled: bool, lora: bool,
                 t: Dict[str, torch.Tensor]):
        qa = ((t["touched"], t["filled"], t["wt"], t["wo"])
              if self.quantized else None)
        params = ({**self.params,
                   "lora": (self.lora_pool, t["lblocks"], t["lscales"])}
                  if lora else self.params)
        head = (params, self.cfg, t["tok"], t["pos"], t["tables"],
                t["active"], t["limits"], t["eos"])
        if sampled:
            return micro_decode_sample(
                *head, t["temps"], t["tops"], t["keys"], t["ngen"],
                self.pools, qa, **self.kwargs)
        return micro_decode_greedy(*head, self.pools, qa, **self.kwargs)

    def run(self, sampled: bool, inputs: Dict[str, np.ndarray],
            lora: bool = False) -> Tuple[np.ndarray, Optional[torch.Tensor]]:
        """One micro-step: ``inputs`` holds the arrays :attr:`layout` names
        for this program (``lora``: with the adapter tables, through the
        runner's ``lora_pool``). Returns the (K, slots) tokens, read back,
        and for a quantized pool its largest write error as a device
        scalar."""
        if self.device.type != "cuda":
            t = {name: torch.from_numpy(np.asarray(
                     inputs[name], _NUMPY[self.layout[name][1]]))
                 for name in self._names(sampled, lora)}
            out = self._program(sampled, lora, t)
            toks, qerr = out if self.quantized else (out, None)
            return toks.numpy(), qerr
        cap = self._graphs.get((sampled, lora))
        if cap is None:
            cap = self._graphs[(sampled, lora)] = self._capture(sampled,
                                                                lora)
        for name, buf in cap.bufs.items():
            cap.staging[name].numpy()[...] = inputs[name]
            buf.copy_(cap.staging[name], non_blocking=True)
        cap.graph.replay()
        self.replays += 1
        _write_counts(a + b for a, b in zip(_read_counts(), cap.launches))
        return cap.toks.cpu().numpy(), cap.qerr

    def _capture(self, sampled: bool, lora: bool) -> _Captured:
        """Warm up, then capture, with every slot inactive (and, for the
        LoRA variant, every row on the scratch block at scale 0); the
        launch counters end as they began."""
        t0 = time.perf_counter()
        before = _read_counts()
        bufs, staging = {}, {}
        for name in self._names(sampled, lora):
            shape, dtype, idle = self.layout[name]
            bufs[name] = torch.full(shape, idle, dtype=dtype,
                                    device=self.device)
            staging[name] = torch.empty(shape, dtype=dtype, pin_memory=True)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._program(sampled, lora, bufs)
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
                out = self._program(sampled, lora, bufs)
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
        return _Captured(graph, bufs, staging, toks, qerr, launches)

    def stats(self) -> dict:
        return {"captures": self.captures,
                "lora_captures": self.lora_captures,
                "capture_ms": self.capture_s * 1e3,
                "replays": self.replays}
