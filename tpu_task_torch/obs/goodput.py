"""Goodput, MFU and dispatch-overhead accounting for the serving engine —
the counterpart of ``tpu_task/obs/goodput.py`` (``matmul_params``,
``token_flops``, ``flops_for_positions``, ``GoodputMeter``), kept as this
package's own copy.

The engine splits every step's wall into *in-program* time (each fused
dispatch, timed from handing its inputs to the device through reading its
tokens back, so the device's work is inside it) and *host-gap* time
(everything else: admission, the host sweep, numpy staging, Python).
``host_gap_frac`` is that split; ``dispatches_per_token`` falls as the
K-token micro-step (``ServingConfig.micro_k``) folds K decode iterations
into one dispatch. ``ratio`` discounts token-work that preemption threw
away, that the target scored and rejected (speculative decoding) or that
a resumed request re-ingests (an imported prefix another engine already
produced), and ``mfu`` divides the static FLOP model's count by busy wall
and the peak.

The overlapped loop (``ServingConfig.overlap``) splits a step's wall three
ways, as the JAX meter does: program time is each dispatch's enqueue plus
the consume edge's wait on the in-flight program's tokens
(:meth:`GoodputMeter.consume_wait`); host work done while a program was in
flight is ``overlapped_host_s`` (the device had work queued under it); and
only a step with no program in flight (the first dispatch, the drain's
last sweep, a flush that emptied the pipeline) charges its host time to
the gap (:meth:`GoodputMeter.end_step_overlapped`). The host tier's
migration is accounted the same way: the engine forces last step's
demotions and stages the next ones after the consume edge, inside the
step's wall, so with a program in flight its host time is overlapped
host time; a promotion's upload at admission is timed as a dispatch.

Where the JAX package differs: its meter lives on an ``obs`` registry and
exists only when the engine has one; here it is always on (two
``perf_counter`` calls per dispatch and a few integer sums per step) and
``stats()["goodput"]`` is its :meth:`GoodputMeter.snapshot` as a plain
dict. An engine with an ``obs`` handle also puts the JAX meter's
``goodput.*`` names on its registry (``registry=``), so a replica's
``/metrics`` carries them. The peak is ``TPU_TASK_PEAK_FLOPS`` when set,
else the H100 data sheet's dense bf16 989 TFLOP/s on a CUDA device and
the JAX package's nominal 1 TFLOP/s elsewhere.
``decode_step_cost_analysis_flops`` asks XLA's cost analysis and has no
counterpart here. A mixture-of-experts layer counts its router and
``moe_top_k`` experts' FFN weights, the routed work a token needs (the
dense dispatch computes every expert, ``n_experts / moe_top_k`` times
that), as the JAX model does."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

__all__ = [
    "CUDA_PEAK_FLOPS",
    "GoodputMeter",
    "NOMINAL_PEAK_FLOPS",
    "flops_for_positions",
    "matmul_params",
    "peak_flops_per_s",
    "token_flops",
]

#: Dense bf16 peak of one NVIDIA H100 SXM (NVIDIA's data sheet).
CUDA_PEAK_FLOPS = 989e12

#: Off the card: the JAX package's nominal 1 TFLOP/s, which makes ``mfu`` a
#: relative number (comparable run to run on one host only).
NOMINAL_PEAK_FLOPS = 1e12


def peak_flops_per_s(device=None) -> float:
    """``TPU_TASK_PEAK_FLOPS`` when set, else :data:`CUDA_PEAK_FLOPS` for a
    CUDA ``device`` and :data:`NOMINAL_PEAK_FLOPS` otherwise."""
    env = os.environ.get("TPU_TASK_PEAK_FLOPS", "")
    if env:
        return float(env)
    if device is not None and torch.device(device).type == "cuda":
        return CUDA_PEAK_FLOPS
    return NOMINAL_PEAK_FLOPS


def matmul_params(cfg) -> int:
    """Matmul parameters of one forward pass: the projections and FFN of
    every layer plus the unembed (the embedding is a gather). A MoE layer
    counts its router and ``moe_top_k`` experts' two FFN weights: the
    per-token compute, not the parameter storage."""
    attn = (cfg.d_model * cfg.d_attn                      # wq
            + 2 * cfg.d_model * cfg.kv_heads * cfg.d_head  # wk, wv
            + cfg.d_attn * cfg.d_model)                   # wo
    dense_ff = 3 * cfg.d_model * cfg.d_ff                 # gate, up, down
    moe_ff = (cfg.d_model * cfg.n_experts                 # router
              + cfg.moe_top_k * 2 * cfg.d_model * cfg.d_ff)  # w_in, w_out
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
    return (cfg.d_model * cfg.vocab_size + cfg.n_layers * attn
            + (cfg.n_layers - n_moe) * dense_ff + n_moe * moe_ff)


def token_flops(cfg, kv_len: int) -> float:
    """Forward FLOPs of ONE token attending ``kv_len`` cache entries: 2 per
    matmul parameter plus 2 · 2 · d_attn · kv_len of attention per
    layer."""
    return (2.0 * matmul_params(cfg)
            + 4.0 * cfg.n_layers * cfg.d_attn * kv_len)


def flops_for_positions(cfg, positions) -> float:
    """:func:`token_flops` summed over absolute positions (a token at
    position p attends p + 1 entries, itself included)."""
    pos = np.asarray(positions, np.float64).reshape(-1)
    if pos.size == 0:
        return 0.0
    return (pos.size * 2.0 * matmul_params(cfg)
            + 4.0 * cfg.n_layers * cfg.d_attn * float(np.sum(pos + 1.0)))


class GoodputMeter:
    """Per-engine accumulator. The engine calls :meth:`program` around
    every fused dispatch, :meth:`begin_step`/:meth:`end_step` around each
    scheduler iteration (:meth:`end_step_overlapped` in the overlapped
    loop, with :meth:`consume_wait` at its consume edge),
    :meth:`work_counts` (:meth:`work_span` for a bucketed admission) and
    :meth:`emitted` where it commits tokens, :meth:`wasted_preempt` where it preempts,
    :meth:`wasted_spec` where a speculative round rejects proposals and
    :meth:`wasted_reingest` where it imports a resumed request."""

    def __init__(self, cfg, peak_flops: Optional[float] = None, device=None,
                 registry=None):
        self.cfg = cfg
        self.peak_flops = float(peak_flops if peak_flops is not None
                                else peak_flops_per_s(device))
        self._base_flops = 2.0 * matmul_params(cfg)
        self._attn_flops = 4.0 * cfg.n_layers * cfg.d_attn
        self.reset()
        if registry is None:
            return
        # The JAX meter's registry names: totals as counters (they sum in a
        # fleet merge), the ratios as gauges.
        for stat in ("program_s", "host_s", "overlapped_host_s",
                     "dispatches", "model_flops",
                     "tokens_emitted", "tokens_preempted",
                     "tokens_spec_rejected", "tokens_reingested"):
            registry.counter_fn(f"goodput.{stat}",
                                lambda self=self, stat=stat:
                                float(getattr(self, stat)))
        registry.gauge_fn("goodput.ratio", lambda: self.ratio)
        registry.gauge_fn("goodput.mfu", lambda: self.mfu)
        registry.gauge_fn("goodput.host_gap_frac",
                          lambda: self.host_gap_frac)
        registry.gauge_fn("goodput.dispatches_per_token",
                          lambda: self.dispatches_per_token)
        registry.gauge_fn("goodput.peak_flops", lambda: self.peak_flops)

    def reset(self) -> None:
        """Zero the accumulators (after a warm-up, so capture and first-use
        seconds do not read as host gap)."""
        self.program_s = 0.0
        self.host_s = 0.0
        self.overlapped_host_s = 0.0
        self.dispatches = 0
        self.model_flops = 0.0
        self.tokens_emitted = 0
        self.tokens_preempted = 0
        self.tokens_spec_rejected = 0
        self.tokens_reingested = 0
        self._prog_mark = 0.0

    # -- time ------------------------------------------------------------------
    def program(self, dt: float) -> None:
        """One fused dispatch took ``dt`` seconds: readback included in the
        synchronous loop, the enqueue alone in the overlapped one."""
        self.program_s += dt
        self.dispatches += 1

    def begin_step(self) -> None:
        self._prog_mark = self.program_s

    def end_step(self, wall_s: float) -> None:
        """Whatever the step's wall spent outside its dispatches is host
        gap."""
        self.host_s += max(0.0, wall_s - (self.program_s - self._prog_mark))

    def consume_wait(self, dt: float) -> None:
        """Overlapped loop: the consume edge waited ``dt`` seconds for the
        in-flight program's tokens. The device was busy, so it is program
        time (no dispatch is counted)."""
        self.program_s += dt

    def end_step_overlapped(self, wall_s: float, covered: bool) -> None:
        """Close one overlapped step. ``covered``: a program was in flight
        across the step's host work (the previous one was unconsumed, or a
        new one was dispatched before the sweep), so its host time is
        overlapped; otherwise it is host gap."""
        gap = max(0.0, wall_s - (self.program_s - self._prog_mark))
        if covered:
            self.overlapped_host_s += gap
        else:
            self.host_s += gap

    # -- work and tokens -------------------------------------------------------
    def work_counts(self, count: int, pos_sum: float) -> None:
        """``count`` tokens whose positions sum to ``pos_sum`` went through
        a program (the attention term is ``pos_sum + count``)."""
        if count:
            self.model_flops += (count * self._base_flops
                                 + self._attn_flops * (pos_sum + count))

    def work_span(self, n: int) -> None:
        """A whole prompt at positions [0, n) went through one program:
        the attention term is the sum of p + 1, n(n+1)/2 in closed form
        (the bucketed-prefill charge)."""
        if n:
            self.model_flops += (n * self._base_flops
                                 + self._attn_flops * n * (n + 1) / 2.0)

    def emitted(self, n: int = 1) -> None:
        self.tokens_emitted += n

    def wasted_preempt(self, n: int) -> None:
        """A recompute preemption rolled back ``n`` committed tokens."""
        self.tokens_preempted += max(0, n)

    def wasted_spec(self, n: int) -> None:
        """``n`` draft proposals were scored by the target and rejected."""
        self.tokens_spec_rejected += max(0, n)

    def wasted_reingest(self, n: int) -> None:
        """``n`` already-emitted tokens re-ingested as context (a resumed
        prefix another engine already produced)."""
        self.tokens_reingested += max(0, n)

    # -- gauges ----------------------------------------------------------------
    @property
    def busy_s(self) -> float:
        # Overlapped host time is wall the device spent executing under the
        # sweep (0 in the synchronous loop).
        return self.program_s + self.host_s + self.overlapped_host_s

    @property
    def host_gap_frac(self) -> float:
        busy = self.busy_s
        return self.host_s / busy if busy > 0 else 0.0

    @property
    def ratio(self) -> float:
        """Useful tokens over token-work: preempted tokens were emitted and
        thrown away (they leave the numerator and stay in the denominator),
        rejected speculative proposals were scored and never emitted, and
        re-ingested tokens were emitted by another engine (both join the
        denominator)."""
        useful = max(0, self.tokens_emitted - self.tokens_preempted)
        total = (self.tokens_emitted + self.tokens_spec_rejected
                 + self.tokens_reingested)
        return useful / total if total > 0 else 1.0

    @property
    def mfu(self) -> float:
        busy = self.busy_s
        if busy <= 0 or self.peak_flops <= 0:
            return 0.0
        return self.model_flops / busy / self.peak_flops

    @property
    def dispatches_per_token(self) -> float:
        return self.dispatches / max(1, self.tokens_emitted)

    def snapshot(self) -> dict:
        """``stats()["goodput"]``: the JAX meter's snapshot keys."""
        return {
            "ratio": round(self.ratio, 6),
            "mfu": self.mfu,
            "host_gap_frac": round(self.host_gap_frac, 6),
            "in_program_frac": round(1.0 - self.host_gap_frac, 6),
            "program_s": round(self.program_s, 6),
            "host_s": round(self.host_s, 6),
            "overlapped_host_s": round(self.overlapped_host_s, 6),
            "dispatches": self.dispatches,
            "dispatches_per_token": round(self.dispatches_per_token, 4),
            "model_flops": self.model_flops,
            "peak_flops": self.peak_flops,
            "tokens": {
                "emitted": self.tokens_emitted,
                "preempted": self.tokens_preempted,
                "spec_rejected": self.tokens_spec_rejected,
                "reingested": self.tokens_reingested,
            },
        }
