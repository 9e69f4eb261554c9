"""Continuous-batching serving engine on one device — the counterpart of
``tpu_task/ml/serving/engine.py``'s synchronous loop.

The engine owns a fixed slot array and runs one scheduler iteration per
:meth:`ServingEngine.step`: admit queued requests into free slots, run ONE
fused step across all slots, retire the slots that finished (their blocks
return to the pool the same step). Its pieces, as in the JAX engine:

- **Prefix cache**: full KV blocks are content-hashed and registered when
  a slot releases them; an admission maps its longest cached prefix to the
  existing blocks (refcounted) and prefills only the tail. A slot that
  must write into a shared block copies it first (copy-on-write).
- **Chunked prefill**: prompt ingestion rides the fused step. A step with
  an admitting slot is TOKEN-PACKED: rows 0..slots-1 decode one token each
  and rows slots.. carry the admitting slots' next prompt chunk, one token
  per row, each row with its own slot's block table.
- **Recompute preemption**: when the pool runs dry mid-decode the engine
  evicts refcount-0 cached blocks, then preempts the youngest running
  request back to the queue head; keyed sampling reproduces its stream.

Every fused step runs :func:`~tpu_task_torch.ml.serving.model.
paged_decode_step` with the paged attention ``decode_impl`` resolves to:
the CUDA kernel on a CUDA device (or the pipelined kernel, when asked
for), the plain version on the CPU.

- **Quantized KV** (``kv_dtype`` int8/fp8/int4): before every fused step
  the host computes the step's write layout (:meth:`ServingEngine.
  _quant_layout`: the deduped blocks it writes, their filled counts, each
  token's block and offset), and the step requantizes those blocks in
  place. ``TPU_TASK_CHECKIFY=1`` turns on the debug mode, which reads back
  each step's largest quantization error (``stats()["kv_quant"]``).
- **K-token micro-steps** (``micro_k`` > 1): a pure-decode step runs
  ``micro_k`` decode iterations with eos/length retirement on the device
  (:func:`~tpu_task_torch.ml.serving.model.micro_decode_greedy` /
  ``_sample``) and the host sweeps the (K, slots) token block once. On a
  CUDA device the K-step loop is one CUDA graph, replayed once per
  micro-step (:mod:`~tpu_task_torch.ml.serving.step_graph`); there is no
  eager K-step path there. On the CPU the loop runs eagerly. Streams are
  those of K = 1: greedy bit-identical, sampled key-identical.
- **Goodput** (:class:`~tpu_task_torch.obs.goodput.GoodputMeter`, always
  on): every dispatch is timed through its readback, and
  ``stats()["goodput"]`` gives the host-gap share, dispatches per token,
  the preemption-discounted goodput ratio and MFU.

Not ported yet (each raises at :class:`ServingConfig` construction or
here, naming its ROADMAP item): bucketed prefill, speculative decoding,
the async loop, LoRA, the host tier, ``export_inflight``/
``resume_inflight``, ``adopt_params``, meshes. The SLA fields of
``submit`` and the obs registry and spans are left out too: with no SLA
field set the JAX engine's admission is FIFO and its preemption victim the
youngest slot, which is what this engine does."""

from __future__ import annotations

import collections
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_task_torch.device import resolve_device
from tpu_task_torch.ml import random as jrandom
from tpu_task_torch.ml.models.transformer import (
    Params,
    TransformerConfig,
    params_to,
)
from tpu_task_torch.ml.ops import paged_attention as pa
from tpu_task_torch.ml.serving.cache import (
    QUANT_DTYPES,
    SCRATCH_BLOCK,
    BlockAllocator,
    PrefixCache,
    ServingConfig,
    copy_block,
    fp8_supported,
    init_pools,
    kv_token_bytes,
    paged_cache_bytes,
)
from tpu_task_torch.ml.serving.model import (
    decode_and_sample,
    greedy_decode_step,
)
from tpu_task_torch.ml.serving.step_graph import MicroStepGraphs
from tpu_task_torch.obs.goodput import GoodputMeter

QUEUED, RUNNING, DONE = "queued", "running", "done"


def resolve_decode_impl(scfg: ServingConfig, device: torch.device) -> str:
    """The paged attention every fused step runs: ``"auto"`` is the CUDA
    kernel (``paged_decode.cu``) on a CUDA device and the plain version on
    the CPU the caller asked for; ``"reference"``, ``"cuda"`` and
    ``"pipelined"`` (``paged_decode_pipelined.cu``) can be forced, the two
    kernels on a CUDA device only. The kernels take every storage type and
    preset geometry the engine serves, so nothing is gated here; what they
    cannot take raises at the launch."""
    want = scfg.decode_impl
    if want == "auto":
        return "cuda" if device.type == "cuda" else "reference"
    if want in ("cuda", "pipelined") and device.type != "cuda":
        raise ValueError(
            f"decode_impl={want!r} needs a CUDA device, the engine runs on "
            f"{device}; use decode_impl='reference' or 'auto'")
    return want


def _check_key(key) -> np.ndarray:
    """A caller-supplied per-request key as two raw uint32 words, checked
    at submission rather than inside a fused step."""
    try:
        raw = np.asarray(key, np.uint32).reshape(-1)
    except (TypeError, ValueError) as error:
        raise ValueError(f"request key is not uint32 words: {error}")
    if raw.shape != (2,):
        raise ValueError(
            f"request key must be 2 uint32 words, got shape {raw.shape}")
    return raw


class DrainTimeout(RuntimeError):
    """:meth:`ServingEngine.drain` ran out of steps with work in flight;
    carries the ids of every request not yet done."""

    def __init__(self, max_steps: int, unfinished: List[int]):
        self.max_steps = max_steps
        self.unfinished = sorted(unfinished)
        super().__init__(
            f"drain exceeded {max_steps} steps with {len(self.unfinished)} "
            f"unfinished request(s): {self.unfinished}")


@dataclass
class Request:
    """One generation request and its lifecycle record."""

    rid: int
    prompt: np.ndarray                   # (prompt_len,) int32
    max_new_tokens: int
    temperature: float = 0.0
    top_p: float = 1.0                   # 1.0 = nucleus filter off
    eos_token: Optional[int] = None
    key: Optional[np.ndarray] = None     # (2,) uint32 per-request key
    status: str = QUEUED
    tokens: List[int] = field(default_factory=list)
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    preemptions: int = 0

    @property
    def finished(self) -> bool:
        if len(self.tokens) >= self.max_new_tokens:
            return True
        return bool(self.tokens) and self.eos_token is not None \
            and self.tokens[-1] == self.eos_token


class ServingEngine:
    """Front end: :meth:`submit` → request id, :meth:`poll` → status and
    tokens, :meth:`step` → one scheduler iteration, :meth:`drain` → run to
    empty. Runs on ``device`` — CUDA unless the caller passes
    ``device="cpu"``; params are moved there. ``rng`` is the raw (2,) base
    key a request's default key folds its id into."""

    def __init__(self, params: Params, cfg: TransformerConfig,
                 scfg: Optional[ServingConfig] = None,
                 rng: Optional[jrandom.KeyLike] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg = scfg or ServingConfig()
        self.params = params_to(params, self.device)
        self._quantized = scfg.kv_dtype in QUANT_DTYPES
        if scfg.kv_dtype == "fp8" and not fp8_supported():
            raise ValueError(
                "kv_dtype='fp8' needs float8_e4m3fn support in this torch "
                "build (cache.fp8_supported() is False) — use "
                "kv_dtype='int8' for the same byte density or None for "
                "model-dtype pools")
        #: Debug mode: read back every quantized step's largest write
        #: error (one scalar sync per step, so off by default).
        self.debug = os.environ.get("TPU_TASK_CHECKIFY", "") == "1"
        self.pools = init_pools(cfg, scfg, self.device)
        self.allocator = BlockAllocator(scfg.n_blocks)
        self._pcache = (PrefixCache(self.allocator, scfg.block_size)
                        if scfg.prefix_cache else None)
        #: Which paged attention the fused steps run, resolved once here
        #: and recorded in stats().
        self.decode_impl = resolve_decode_impl(scfg, self.device)
        n, m = scfg.slots, scfg.max_blocks_per_slot
        self._slots: List[Optional[Request]] = [None] * n
        self._admit_seq = [0] * n        # admission order: victim pick
        self._admit_counter = 0
        self._tables = np.zeros((n, m), np.int32)
        self._positions = np.zeros((n,), np.int32)
        # Prefill target per slot: the prompt length captured at admission;
        # a slot is prefilling while its position sits below it.
        self._prefill_target = np.zeros((n,), np.int32)
        self._last_token = np.zeros((n,), np.int32)
        self._slot_keys = np.zeros((n, 2), np.uint32)
        self._queue: collections.deque = collections.deque()
        self._requests: Dict[int, Request] = {}
        self._next_rid = 0
        self._base_key = (jrandom.PRNGKey(0) if rng is None
                          else jrandom.as_key(rng))
        self.steps = 0
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_chunks = 0
        self.chunk_steps = 0
        self.preemption_count = 0
        self.cow_copies = 0
        self.prefix_hit_blocks = 0
        self.prefix_miss_blocks = 0
        self.prefix_hit_requests = 0
        self.prefix_tokens_saved = 0
        self.quantized_block_writes = 0
        self.max_quant_error = 0.0       # debug mode only (readback cost)
        self.micro_steps = 0             # K-wide fused micro dispatches
        self.goodput = GoodputMeter(cfg, device=self.device)
        #: The K-step programs (a CUDA graph each on a CUDA device, captured
        #: at first use), bound to self.params and self.pools: neither is
        #: ever rebound.
        self._micro = MicroStepGraphs(
            self.params, cfg, self.pools, slots=n, max_blocks=m,
            micro_k=scfg.micro_k, attn_impl=self.decode_impl,
            measure_qerr=self.debug, device=self.device)

    # -- front end -------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, temperature: float = 0.0,
               top_p: Optional[float] = None,
               eos_token: Optional[int] = None, key=None) -> int:
        """Queue a generation request; returns its id. Temperature 0 is
        greedy; ``top_p`` needs temperature > 0. ``key`` (two raw uint32
        words) overrides the engine-derived ``fold_in(base, rid)`` — a
        router passes one so the same request draws the same sampled
        stream on any replica."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if top_p is not None and not 0 < top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_p is not None and temperature == 0:
            raise ValueError("top_p needs temperature > 0 (greedy ignores it)")
        if ((prompt < 0) | (prompt >= self.cfg.vocab_size)).any():
            raise ValueError(
                f"prompt token ids must lie in [0, {self.cfg.vocab_size})")
        total = len(prompt) + max_new_tokens
        if total > self.scfg.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds max_len {self.scfg.max_len}")
        if self.scfg.blocks_for(total) > self.scfg.n_blocks - 1:
            raise ValueError(
                f"request needs {self.scfg.blocks_for(total)} blocks but the "
                f"pool holds {self.scfg.n_blocks - 1}")
        rid = self._next_rid
        self._next_rid += 1
        key = (jrandom.key_to_numpy(jrandom.fold_in(self._base_key, rid))
               if key is None else _check_key(key))
        req = Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=1.0 if top_p is None else top_p,
            eos_token=eos_token, key=key, submit_t=time.monotonic())
        self._requests[rid] = req
        self._queue.append(req)
        return rid

    def poll(self, rid: int) -> dict:
        req = self._requests[rid]
        return {"status": req.status, "tokens": list(req.tokens)}

    def request(self, rid: int) -> Request:
        """The full lifecycle record (timestamps, preemptions)."""
        return self._requests[rid]

    def result(self, rid: int) -> List[int]:
        req = self._requests[rid]
        if req.status != DONE:
            raise RuntimeError(f"request {rid} is {req.status}, not done")
        return list(req.tokens)

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or self.n_active > 0

    def step(self) -> dict:
        """One scheduler iteration: admit → (chunk | decode) → retire.
        Returns the request ids admitted and finished. A pure-decode step
        at ``micro_k`` > 1 is one K-token micro-step."""
        t0 = time.perf_counter()
        self.goodput.begin_step()
        self.steps += 1
        admitted: List[int] = []
        finished: List[int] = []
        self._admit_chunked(admitted)
        with torch.no_grad():
            if any(self._prefilling(i) for i in range(self.scfg.slots)):
                self._chunk_step(finished)
            elif self.n_active:
                if self.scfg.micro_k > 1:
                    self._micro_decode(finished)
                else:
                    self._decode(finished)
        self.goodput.end_step(time.perf_counter() - t0)
        return {"admitted": admitted, "finished": finished,
                "active": self.n_active, "queued": len(self._queue)}

    def drain(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Step until queue and slots are empty; returns {rid: tokens} for
        every request ever submitted. Raises :class:`DrainTimeout` if
        ``max_steps`` runs out first."""
        steps = 0
        while self.has_work:
            if steps >= max_steps:
                raise DrainTimeout(
                    max_steps, [rid for rid, r in self._requests.items()
                                if r.status != DONE])
            self.step()
            steps += 1
        return {rid: list(r.tokens) for rid, r in self._requests.items()}

    def export_inflight(self):
        raise NotImplementedError(
            "export_inflight is not ported yet: ROADMAP A10")

    def resume_inflight(self, records, *args, **kwargs):
        raise NotImplementedError(
            "resume_inflight is not ported yet: ROADMAP A10")

    def adopt_params(self, params, generation=None):
        raise NotImplementedError(
            "adopt_params (weight hot-swap) is not ported yet: ROADMAP A8")

    # -- scheduling ------------------------------------------------------------

    def _prefilling(self, slot: int) -> bool:
        return self._slots[slot] is not None and \
            int(self._positions[slot]) < int(self._prefill_target[slot])

    def _context_ids(self, req: Request) -> np.ndarray:
        return np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])

    def _reserve(self, n: int, spare: int) -> Optional[List[int]]:
        """``n`` blocks with ``spare`` more left free, evicting refcount-0
        cached blocks (LRU) if the free list alone can't cover it; None
        (nothing taken) when even eviction can't."""
        shortfall = n + spare - self.allocator.available
        if shortfall > 0 and self._pcache is not None:
            self._pcache.evict(shortfall)
        if self.allocator.available < n + spare:
            return None
        return self.allocator.alloc(n)

    def _admit_chunked(self, admitted: list) -> None:
        """Assign free slots and blocks to queued requests (FIFO); prompt
        ingestion happens across the following steps' chunk rows. At most
        ``prefill_slots`` slots prefill at a time."""
        bs = self.scfg.block_size
        while self._queue:
            if sum(self._prefilling(i) for i in range(self.scfg.slots)) \
                    >= self.scfg.prefill_slots:
                return
            slot = next(
                (i for i, r in enumerate(self._slots) if r is None), None)
            if slot is None:
                return
            req = self._queue[0]
            ctx = self._context_ids(req)
            plen = len(ctx)
            cached = (self._pcache.lookup(ctx)              # increfs
                      if self._pcache is not None else [])
            # The last prompt token is ALWAYS recomputed (its logits seed
            # the first sample), so a whole-prompt hit caps at plen - 1 —
            # and that one write lands inside the final shared block, the
            # copy-on-write case.
            cached_len = min(len(cached) * bs, plen - 1)
            cow = 1 if cached_len < len(cached) * bs else 0
            need = self.scfg.blocks_for(plen) - len(cached)
            got = self._reserve(need + cow, 1 if self.n_active else 0)
            if got is None:
                for b in cached:
                    self.allocator.decref(b)
                return
            self._queue.popleft()
            table = np.zeros((self.scfg.max_blocks_per_slot,), np.int32)
            table[:len(cached)] = cached
            if need:
                table[len(cached):len(cached) + need] = got[:need]
            if cow:
                src = int(table[cached_len // bs])
                dst = got[need]
                copy_block(self.pools, src, dst)
                table[cached_len // bs] = dst
                self.allocator.decref(src)
                self.cow_copies += 1
            if cached:
                self.prefix_hit_requests += 1
            self.prefix_hit_blocks += len(cached)
            self.prefix_miss_blocks += plen // bs - len(cached)
            self.prefix_tokens_saved += cached_len
            req.status = RUNNING
            self._slots[slot] = req
            self._admit_counter += 1
            self._admit_seq[slot] = self._admit_counter
            self._slot_keys[slot] = req.key
            self._tables[slot] = table
            self._positions[slot] = cached_len
            self._prefill_target[slot] = plen
            self._last_token[slot] = 0
            admitted.append(req.rid)

    def _ensure_blocks(self, widths: Optional[np.ndarray] = None) -> None:
        """Every active slot gets blocks covering its next ``widths[i]``
        writes (default 1) — evicting refcount-0 cached blocks first, then
        preempting the youngest running request (requeued at the head,
        recompute) when the pool is truly dry."""
        bs = self.scfg.block_size
        for slot in sorted(range(self.scfg.slots),
                           key=lambda i: self._admit_seq[i]):
            if self._slots[slot] is None:
                continue
            w = int(widths[slot]) if widths is not None else 1
            if not w:
                continue
            pos = int(self._positions[slot])
            preempted_self = False
            for block_i in range(pos // bs, (pos + w - 1) // bs + 1):
                while self._tables[slot, block_i] == SCRATCH_BLOCK:
                    got = self._reserve(1, 0)
                    if got is not None:
                        self._tables[slot, block_i] = got[0]
                        break
                    victim = max(
                        (i for i, r in enumerate(self._slots) if r is not None),
                        key=lambda i: self._admit_seq[i])
                    self._preempt(victim)
                    if victim == slot:
                        preempted_self = True
                        break
                    if self.n_active <= 1 and self.allocator.available == 0 \
                            and (self._pcache is None
                                 or self._pcache.evict(1) == 0):
                        raise RuntimeError(
                            "KV pool too small for a single request — "
                            "raise n_blocks")
                if preempted_self:
                    break

    def _preempt(self, slot: int) -> None:
        req = self._slots[slot]
        req.preemptions += 1
        self.preemption_count += 1
        req.status = QUEUED
        # The rolled-back tokens were emitted work the recompute repeats.
        self.goodput.wasted_preempt(len(req.tokens))
        # Release BEFORE clearing tokens: _release registers full blocks
        # under the ids that produced their KV (prompt + tokens so far).
        self._release(slot)
        req.tokens.clear()
        req.first_token_t = None
        self._queue.appendleft(req)

    # -- fused steps -----------------------------------------------------------

    def _all_greedy(self) -> bool:
        return all(r is None or r.temperature == 0 for r in self._slots)

    def _quant_layout(self, tables: np.ndarray, positions: np.ndarray,
                      valid: np.ndarray):
        """Host half of a quantized step's write: the deduped physical
        blocks the step writes (``touched``), each one's valid-token count
        after the step (``filled``; rows past it are garbage the requantize
        zeroes), and every token's (touched index, in-block offset). Dedup
        matters: packed chunk rows share a slot's table, so several rows
        append into one block, and that block is staged once with all of
        them before it is requantized. Invalid tokens point at the trailing
        pad entry (the scratch block, ``filled`` 0). ``positions``/``valid``
        (rows, w); ``tables`` (rows, max_blocks). Vectorised: it runs
        before every quantized step. Returns host arrays."""
        bs = self.scfg.block_size
        rows, w = positions.shape
        n_touched = rows * w + 1
        pos = np.asarray(positions, np.int64).reshape(-1)
        val = np.asarray(valid, bool).reshape(-1)
        blocks = np.asarray(tables)[np.arange(rows).repeat(w), pos // bs]
        uniq, inv = np.unique(blocks[val], return_inverse=True)
        touched = np.zeros(n_touched, np.int64)
        touched[:len(uniq)] = uniq
        filled = np.zeros(n_touched, np.int64)
        np.maximum.at(filled, inv, pos[val] % bs + 1)
        wt = np.full(rows * w, n_touched - 1, np.int64)
        wt[val] = inv
        wo = np.zeros(rows * w, np.int64)
        wo[val] = pos[val] % bs
        self.quantized_block_writes += len(uniq)
        return touched, filled, wt, wo

    def _note_qerr(self, qerr: torch.Tensor) -> None:
        """Debug mode keeps the worst write-quantization error seen (a
        scalar readback per step); otherwise the value is never read."""
        if self.debug:
            self.max_quant_error = max(self.max_quant_error, float(qerr))

    def _run(self, tokens, positions, tables, active, temps=None, tops=None,
             keys=None, ngen=None) -> np.ndarray:
        """Dispatch one fused step (greedy program when every slot is
        greedy, else the keyed sampler) and read its tokens back; the
        goodput meter times it from its inputs' upload through the
        readback. ``positions`` are 0 at inactive rows."""
        dev = self.device

        def put(a, dtype):
            return torch.as_tensor(a, device=dev, dtype=dtype)

        layout = (self._quant_layout(tables, positions[:, None],
                                     active[:, None])
                  if self._quantized else None)
        t0 = time.perf_counter()
        qa = (tuple(put(a, torch.int64) for a in layout)
              if self._quantized else None)
        args = (self.params, self.cfg, put(tokens, torch.int64),
                put(positions, torch.int32), put(tables, torch.int32),
                put(active, torch.bool))
        kwargs = dict(attn_impl=self.decode_impl, measure_qerr=self.debug)
        if self._all_greedy():
            out = greedy_decode_step(*args, self.pools, qa, **kwargs)
        else:
            out = decode_and_sample(
                *args, put(temps, torch.float32), put(tops, torch.float32),
                jrandom.as_key(keys, dev), put(ngen, torch.int64),
                self.pools, qa, **kwargs)
        if self._quantized:
            out, qerr = out
            self._note_qerr(qerr)
        toks = out.cpu().numpy()
        self.goodput.program(time.perf_counter() - t0)
        return toks

    def _temps_tops(self):
        temps = np.array(
            [r.temperature if r else 0.0 for r in self._slots], np.float32)
        tops = np.array([r.top_p if r else 1.0 for r in self._slots],
                        np.float32)
        return temps, tops

    def _decode(self, finished: list) -> None:
        self._ensure_blocks()
        active = np.array([r is not None for r in self._slots])
        if not active.any():
            return
        positions = np.where(active, self._positions, 0)
        temps, tops = self._temps_tops()
        ngen = np.array([len(r.tokens) if r else 0 for r in self._slots],
                        np.int64)
        toks = self._run(self._last_token, positions, self._tables, active,
                         temps, tops, self._slot_keys, ngen)
        self.decode_steps += 1
        # positions is 0 at inactive rows, so its sum is the active rows'.
        n_act = int(active.sum())
        self.goodput.work_counts(n_act, float(positions.sum()))
        self.goodput.emitted(n_act)
        now = time.monotonic()
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            tok = int(toks[slot])
            req.tokens.append(tok)
            if req.first_token_t is None:
                req.first_token_t = now
            self._positions[slot] += 1
            self._last_token[slot] = tok
            if req.finished:
                self._retire(slot)
                finished.append(req.rid)

    def _chunk_step(self, finished: list) -> None:
        """ONE token-packed fused step at batch ``slots + chunk_tokens``:
        rows 0..slots-1 decode their slot's next token, rows slots.. carry
        the admitting slots' next prompt chunk (oldest admission first,
        under one shared ``chunk_tokens`` budget), each row with its own
        slot's block table. Every row scatters its k/v before any row
        attends, and the position mask gives each chunk token exactly its
        predecessors."""
        n, W = self.scfg.slots, self.scfg.chunk_tokens
        order = sorted(range(n), key=lambda j: self._admit_seq[j])

        def chunk_widths() -> np.ndarray:
            w = np.zeros((n,), np.int32)
            budget = W
            for i in order:
                if self._slots[i] is None:
                    continue
                pos, target = int(self._positions[i]), \
                    int(self._prefill_target[i])
                if pos < target:
                    w[i] = min(budget, target - pos)
                    budget -= w[i]
                else:
                    w[i] = 1
            return w

        self._ensure_blocks(chunk_widths())
        if not self.n_active:
            return
        widths = chunk_widths()           # preemption may have freed slots
        if not widths.max():
            return
        pres = [i for i in order if self._prefilling(i) and widths[i]]
        R = n + W
        tokens = np.zeros((R,), np.int32)
        positions = np.zeros((R,), np.int32)
        tables = np.zeros((R, self.scfg.max_blocks_per_slot), np.int32)
        active = np.zeros((R,), bool)
        temps = np.zeros((R,), np.float32)
        tops = np.ones((R,), np.float32)
        keys = np.zeros((R, 2), np.uint32)
        ngen = np.zeros((R,), np.int64)
        tables[:n] = self._tables
        temps[:n], tops[:n] = self._temps_tops()
        for i, req in enumerate(self._slots):
            if req is None or not widths[i] or i in pres:
                continue
            tokens[i] = self._last_token[i]
            positions[i] = self._positions[i]
            active[i] = True
            keys[i], ngen[i] = self._slot_keys[i], len(req.tokens)
        rows = {}                          # slot -> (row offset, c, pos)
        off = 0
        for i in pres:
            req = self._slots[i]
            pos, c = int(self._positions[i]), int(widths[i])
            ctx = self._context_ids(req)
            sl = slice(n + off, n + off + c)
            tokens[sl] = ctx[pos:pos + c]
            positions[sl] = np.arange(pos, pos + c)
            tables[sl] = self._tables[i]
            active[sl] = True
            temps[sl] = req.temperature
            tops[sl] = req.top_p
            keys[sl] = self._slot_keys[i]
            # The first token after prefill draws fold_in(key, 0), the
            # same draw every other path makes for a fresh request.
            ngen[sl] = len(req.tokens)
            rows[i] = (off, c, pos)
            off += c
        pos_masked = np.where(active, positions, 0)
        toks = self._run(tokens, pos_masked, tables, active, temps, tops,
                         keys, ngen)
        self.chunk_steps += 1
        self.goodput.work_counts(int(active.sum()), float(pos_masked.sum()))
        now = time.monotonic()
        for i, req in enumerate(self._slots):
            if req is None or not widths[i]:
                continue
            if i in rows:                             # prefill rows
                off, c, pos = rows[i]
                self._positions[i] = pos + c
                self.prefill_chunks += 1
                if pos + c < int(self._prefill_target[i]):
                    continue                          # mid-prompt: no token
                self.prefills += 1
                tok = int(toks[n + off + c - 1])      # last chunk row's sample
            else:                                     # decode row
                self._positions[i] = int(self._positions[i]) + 1
                tok = int(toks[i])
            req.tokens.append(tok)
            self.goodput.emitted(1)
            if req.first_token_t is None:
                req.first_token_t = now
            self._last_token[i] = tok
            if req.finished:
                self._retire(i)
                finished.append(req.rid)

    def _micro_spans(self) -> np.ndarray:
        """Each slot's token span in the next micro-step: min(micro_k,
        remaining max_new) for a running slot, 0 for an empty one — both
        the block-reservation widths and the retirement limits."""
        spans = np.zeros((self.scfg.slots,), np.int32)
        for i, req in enumerate(self._slots):
            if req is not None:
                spans[i] = min(self.scfg.micro_k,
                               req.max_new_tokens - len(req.tokens))
        return spans

    def _micro_quant_layout(self, positions: np.ndarray,
                            spans: np.ndarray) -> Dict[str, np.ndarray]:
        """Stacked write layouts of a quantized micro-step: iteration j's
        is the K = 1 step's at ``positions + j`` over the slots whose span
        covers j, as if each lives through its span. A slot that retires
        on eos mid-span writes its remaining rows only into its own
        blocks, past its last valid position, in a partial block that is
        never registered with the prefix cache and frees at the sweep."""
        parts = [self._quant_layout(self._tables, (positions + j)[:, None],
                                    (spans > j)[:, None])
                 for j in range(self.scfg.micro_k)]
        return {name: np.stack([p[i] for p in parts])
                for i, name in enumerate(("touched", "filled", "wt", "wo"))}

    def _micro_decode(self, finished: list) -> None:
        """One K-token micro-step: ``micro_k`` decode iterations with
        eos/length retirement on the device, one dispatch (a CUDA graph
        replay on a CUDA device), one (K, slots) readback, and one host
        sweep that commits each slot's valid prefix — stopping at its
        eos or limit, as K separate steps would."""
        self._ensure_blocks(self._micro_spans())
        if not self.n_active:
            return
        spans = self._micro_spans()       # preemption may have freed slots
        active = spans > 0
        positions = np.where(active, self._positions, 0)
        eos = np.array([r.eos_token if r is not None
                        and r.eos_token is not None else -1
                        for r in self._slots], np.int64)
        inputs = dict(tok=self._last_token, pos=positions,
                      tables=self._tables, active=active, limits=spans,
                      eos=eos)
        sampled = not self._all_greedy()
        if sampled:
            temps, tops = self._temps_tops()
            inputs.update(temps=temps, tops=tops, keys=self._slot_keys,
                          ngen=np.array([len(r.tokens) if r else 0
                                         for r in self._slots], np.int64))
        if self._quantized:
            inputs.update(self._micro_quant_layout(positions, spans))
        t0 = time.perf_counter()
        toks, qerr = self._micro.run(sampled, inputs)    # (micro_k, slots)
        self.goodput.program(time.perf_counter() - t0)
        if qerr is not None:
            self._note_qerr(qerr)
        self.decode_steps += 1
        self.micro_steps += 1
        now = time.monotonic()
        emitted_total, pos_sum = 0, 0.0
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            for j in range(int(spans[slot])):
                tok = int(toks[j, slot])
                req.tokens.append(tok)
                emitted_total += 1
                pos_sum += float(positions[slot]) + j
                self._positions[slot] += 1
                self._last_token[slot] = tok
                if req.first_token_t is None:
                    req.first_token_t = now
                if req.finished:
                    break
            if req.finished:
                self._retire(slot)
                finished.append(req.rid)
        # One dispatch did emitted_total tokens of work: the charge is per
        # valid token, so the FLOP model is the same at any K.
        self.goodput.work_counts(emitted_total, pos_sum)
        self.goodput.emitted(emitted_total)

    # -- release / retire ------------------------------------------------------

    def _release(self, slot: int) -> None:
        """Free the slot's blocks and clear its row. With the prefix cache
        on, every FULL block of valid KV is first offered to the cache, so
        the decref leaves shareable blocks cached instead of free."""
        req = self._slots[slot]
        live = self._tables[slot][self._tables[slot] != SCRATCH_BLOCK]
        if self._pcache is not None and req is not None:
            n_valid = int(self._positions[slot])
            n_full = n_valid // self.scfg.block_size
            if n_full:
                ids = self._context_ids(req)[:n_valid]
                self._pcache.register(
                    ids, [int(b) for b in self._tables[slot, :n_full]])
        for b in live:
            self.allocator.decref(int(b))
        self._tables[slot] = 0
        self._positions[slot] = 0
        self._prefill_target[slot] = 0
        self._last_token[slot] = 0
        self._slots[slot] = None

    def _retire(self, slot: int) -> None:
        req = self._slots[slot]
        req.status = DONE
        req.finish_t = time.monotonic()
        self._release(slot)

    def stats(self) -> dict:
        """Scheduler counters, the KV cost model, and the process-wide
        paged-attention launch counts (both kernels and the plain
        version)."""
        return {
            "decode_impl": self.decode_impl,
            "device": str(self.device),
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            # The configured K and the K-wide micro dispatches that ran.
            "micro_k": self.scfg.micro_k,
            "micro_steps": self.micro_steps,
            # Graph captures and replays of the K-step programs (CUDA).
            "step_graph": self._micro.stats(),
            "chunk_steps": self.chunk_steps,
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "recompute_preemptions": self.preemption_count,
            "kv_quant": {
                "kv_dtype": self.scfg.kv_dtype
                or str(self.cfg.dtype).replace("torch.", ""),
                "quantized_block_writes": self.quantized_block_writes,
                # Tracked only in debug mode (TPU_TASK_CHECKIFY=1: one
                # scalar readback per step), None otherwise.
                "max_quant_error_observed":
                    self.max_quant_error if self.debug else None,
            },
            "kv_bytes_per_token": kv_token_bytes(self.cfg, self.scfg),
            "kv_blocks_high_water": self.allocator.high_water,
            "kv_pool_bytes": paged_cache_bytes(self.cfg, self.scfg,
                                               self.scfg.n_blocks),
            "prefix_cache": {
                "enabled": self._pcache is not None,
                "miss_blocks": self.prefix_miss_blocks,
                "hit_requests": self.prefix_hit_requests,
                "tokens_saved": self.prefix_tokens_saved,
                "blocks_saved": self.prefix_hit_blocks,
                "cow_copies": self.cow_copies,
                "cached_blocks": len(self._pcache) if self._pcache else 0,
                "shared_blocks": (self._pcache.shared_blocks()
                                  if self._pcache else 0),
                "evictions": self._pcache.evictions if self._pcache else 0,
            },
            "attention_launches": {
                "cuda": pa.paged_decode_attention.launches,
                "pipelined": pa.paged_decode_pipelined_attention.launches,
                "reference": pa.paged_reference_attention.launches,
            },
            "goodput": self.goodput.snapshot(),
        }
