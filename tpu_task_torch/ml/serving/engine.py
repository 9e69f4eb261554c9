"""Continuous-batching serving engine on one device or over a mesh — the
counterpart of ``tpu_task/ml/serving/engine.py``'s synchronous and
overlapped loops.

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
- **Bucketed prefill** (``prefill="bucketed"``, no prefix cache): an
  admission runs its whole context, padded to the smallest prefill bucket
  that holds it, through ONE program
  (:func:`~tpu_task_torch.ml.serving.model.paged_prefill`: causal
  self-attention over the bucket, its k/v written into the pools in place)
  and samples its first token at once; the slot then decodes like any
  other. Greedy streams are chunked prefill's. A resumed context that has
  outgrown every bucket is recomputed from its prompt alone.
- **Recompute preemption**: when the pool runs dry mid-decode the engine
  evicts refcount-0 cached blocks, then preempts the least-protected
  running request with the most slack (the youngest among equals) back to
  the queue head; keyed sampling reproduces its stream.
- **SLA order**: ``submit(slo_class=, deadline_s=)`` sets a request's
  protection class and deadline. Admission takes the highest class first,
  then the earliest deadline (:meth:`ServingEngine._next_admit_index`);
  with no SLA field set both orders reduce to FIFO and youngest-first.
  Neither order touches a token's value: sampling is keyed by (key,
  index).
- **Drain and resume**: :meth:`ServingEngine.export_inflight` writes every
  unfinished request as a JSON-serializable record (the JAX engine's keys)
  and :meth:`ServingEngine.resume_inflight` imports such records, from
  either package, into a fresh engine. A resumed request re-ingests prompt
  plus tokens through the chunk steps and continues at token index
  ``len(tokens)``; a later preemption rolls it back to that prefix
  (``Request.resume_from``), never through it.

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
- **Speculative decoding** (``spec_k`` > 0, with ``draft_params``/
  ``draft_cfg``): after any chunk step, one round per scheduler step — the
  draft catches its own cache up (:func:`~tpu_task_torch.ml.serving.model.
  chunked_step_greedy`), proposes up to ``spec_k`` tokens per slot with
  greedy decode steps, ONE target step scores all ``spec_k + 1`` positions
  of every slot through the paged kernel (:func:`~tpu_task_torch.ml.
  serving.model.spec_score_greedy` / ``_probs``), and the host commits the
  longest agreeing prefix plus one token (greedy) or rejection-samples
  against uniforms keyed by (request key, absolute position)
  (:func:`spec_uniforms`). Greedy streams are those of ``spec_k = 0``,
  sampled ones the JAX spec engine's. The draft runs the target's paged
  attention; a draft (or scoring width) the kernel cannot take raises at
  construction — the JAX engine sends such a draft through XLA instead.
  ``spec_enabled`` is the brownout knob: off, a round proposes nothing and
  still scores every slot through the spec path.
- **Goodput** (:class:`~tpu_task_torch.obs.goodput.GoodputMeter`, always
  on): every dispatch is timed through its readback, and
  ``stats()["goodput"]`` gives the host-gap share, dispatches per token,
  the preemption- and rejection-discounted goodput ratio and MFU.
- **Fleet KV** (``kv_fleet=``, a duck-typed client such as
  :class:`~tpu_task_torch.serve.kvfleet.FleetKvClient`; needs the prefix
  cache): an admission imports the full blocks its local cache missed
  from blocks other replicas published, by content hash, and writes them
  into the pools in place (:meth:`ServingEngine._fleet_import`) instead of
  prefilling them; :meth:`ServingEngine.prefetch_chain` does the same
  ahead of any request, and :meth:`ServingEngine.stage_cached_blocks` /
  :meth:`ServingEngine.export_cached_blocks` give the hot blocks to
  publish. Payloads are the JAX package's bytes, so replicas of both
  packages share one bucket. The draft's pools are never imported into:
  its catch-up re-ingests the context from position 0, as after a local
  prefix hit.
- **Weight hot-swap** (:meth:`ServingEngine.adopt_params`): the params
  are held by GENERATION. Adopting a new generation leaves every
  in-flight stream on the weights it started with, new admissions take
  the new ones, and while slots hold more than one generation each step
  runs its fused programs once per generation, the other generations'
  slots masked like empty ones (their rows write only the scratch
  block). A generation's params, and its K-step graphs, are freed when
  its last stream retires. ``param_loader(generation)`` restores a
  generation a resumed record pins that the engine no longer holds.
- **Paged LoRA adapters** (``lora_rank`` > 0, :meth:`ServingEngine.
  register_adapter`, ``submit(adapter_id=)``): adapters page through a
  second :class:`~tpu_task_torch.ml.serving.cache.BlockAllocator` over one
  device pool of per-layer blocks (:mod:`~tpu_task_torch.ml.serving.
  lora`), written in place at a load and never rebound, so the K-step
  graphs read what a later load writes. A slot's (n_layers,) table row
  points at its adapter's blocks, or at the zero scratch block; every
  fused step gathers per row and adds the shrink/expand delta around each
  block. A step with no adapter row runs the LoRA-free program (the drop
  rule). Cold adapters evict LRU under pool pressure and reload from
  their host copy or, registered with ``host_copy=False``, from the fleet
  bucket by content hash. Adapter-bearing requests neither read nor seed
  the prefix cache: their KV depends on the adapter.

- **The host KV tier** (``host_offload_blocks`` > 0,
  :class:`~tpu_task_torch.ml.serving.offload.HostKvTier`): the middle
  rung of device pool → host RAM → fleet bucket. After each step (the
  synchronous loop) or at each consume edge (the overlapped one) a demote
  pass copies up to 8 of the prefix cache's coldest refcount-0 blocks
  toward host RAM (:class:`~tpu_task_torch.ml.serving.cache.BlockStaging`:
  one gather a pool leaf into a pinned buffer, behind the program just
  dispatched), and the next pass forces the bytes into the tier and marks
  the blocks demoted, eviction's first victims. Admission and
  :meth:`ServingEngine.prefetch_chain` import a missed chain from host RAM
  first, then from the fleet bucket; the tier's LRU tail spills into the
  bucket through the fleet client's ``ship_bytes``. Streams are those of
  an engine with no tier.

- **The overlapped loop** (``overlap=True``): each :meth:`ServingEngine.
  step` admits, dispatches program N+1 from program N's device carry
  (:func:`~tpu_task_torch.ml.serving.model.micro_carry_greedy` and the
  chunk carry programs), and only then waits for program N's tokens and
  sweeps them from its dispatch record, so the host's sweep and planning
  run while the device executes. Everything runs on one CUDA stream;
  uploads go through fresh pinned buffers and each program's tokens come
  back through its own pinned copy and event, so nothing in the dispatch
  region waits for the device. Pool pressure, :meth:`ServingEngine.
  export_inflight`, :meth:`ServingEngine.adopt_params` and a mid-roll
  step flush the pipeline to the synchronous edge first. Streams are the
  synchronous loop's.

- **Tensor- and expert-parallel serving** (``mesh=``, a gang's
  :class:`~tpu_task_torch.ml.parallel.mesh.Mesh` from
  :func:`tpu_task_torch.ml.parallel.gang.start`): this engine is rank 0
  and keeps every host structure; each rank holds its block of the
  weights (:func:`~tpu_task_torch.ml.models.transformer.param_pspecs`:
  heads, hidden columns and vocab over ``tp``, experts over ``ep``) and
  of the pools (:func:`~tpu_task_torch.ml.serving.cache.pool_pspecs`:
  kv heads over ``tp``, allocated at that width), and every fused step is
  a gang program each rank runs on its own block, the paged kernels on
  its kv heads. Paging is along the token axis, so block accounting,
  tables, the prefix cache and sampling are the one-device engine's at
  every tp×ep width. The K-step loop runs uncaptured under a mesh (a
  gloo collective cannot be captured in a CUDA graph). ``kv_fleet``, the
  host tier, LoRA, ``overlap`` and :meth:`ServingEngine.adopt_params`
  stay single-device, refused with the JAX engine's words.

- **Observability** (``obs=``, a :class:`~tpu_task_torch.obs.Obs`): one
  span per request phase (``engine.queue`` → ``engine.prefill`` →
  ``engine.decode``, with the JAX engine's names, statuses and
  attributes) under the request's trace (``submit(trace=)``, or one
  minted here), the ``engine.step_s``/``ttft_s``/``intertoken_s``/
  ``e2e_s`` histograms, the scheduler counters and the goodput names on
  the registry, and ``stats()["obs"]``. ``obs=None`` is the
  zero-overhead path: every recording site guards on it."""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_task_torch.device import resolve_device
from tpu_task_torch.ml import random as jrandom
from tpu_task_torch.ml.models.transformer import (
    Params,
    TransformerConfig,
    param_pspecs,
    params_to,
)
from tpu_task_torch.ml.ops import paged_attention as pa
from tpu_task_torch.ml.parallel.sharding import (
    device_put_tree,
    mesh_axis_size,
)
from tpu_task_torch.ml.serving.cache import (
    QUANT_DTYPES,
    SCRATCH_BLOCK,
    BlockAllocator,
    BlockStaging,
    PrefixCache,
    ServingConfig,
    block_payload_nbytes,
    chain_block_hashes,
    copy_block,
    dense_cache_bytes,
    fp8_supported,
    init_pools,
    kv_shard_bytes,
    kv_token_bytes,
    paged_cache_bytes,
    stage_block_arrays,
    staged_block_to_bytes,
    write_block_payloads,
)
from tpu_task_torch.ml.serving.lora import (
    adapter_fingerprint,
    adapter_payload,
    gather_tables,
    init_adapter_pool,
    pack_adapter,
    split_adapter_payload,
    validate_lora_tables,
)
from tpu_task_torch.ml.serving.offload import HostKvTier
from tpu_task_torch.ml.serving.model import (
    chunk_carry_greedy,
    chunk_carry_sample,
    chunked_step_greedy,
    decode_and_sample,
    greedy_decode_step,
    paged_prefill,
    sample_tokens,
    serving_moe_fn,
    spec_score_greedy,
    spec_score_probs,
)
from tpu_task_torch.ml.serving.step_graph import (
    MicroStepGraphs,
    Readback,
    store_carry,
    upload,
)
from tpu_task_torch.obs.goodput import GoodputMeter
from tpu_task_torch.obs.sla import DEFAULT_CLASS, class_rank
from tpu_task_torch.obs.trace import Span, TraceContext

QUEUED, RUNNING, DONE = "queued", "running", "done"

#: Salt folded into a request's key before deriving its per-position
#: rejection-sampling uniforms: keeps the speculative stream disjoint from
#: the ``fold_in(key, token_index)`` stream the plain sampler draws.
SPEC_SALT = 0x5BEC


def spec_uniforms(keys: torch.Tensor, positions: torch.Tensor
                  ) -> torch.Tensor:
    """Two uniforms per (request key, absolute position), one call for a
    whole round: ``uniform(fold_in(fold_in(key, SPEC_SALT), pos), (2,))``
    for ``keys`` (slots, 2) and ``positions`` (slots, w) — the JAX
    engine's ``_spec_uniform_fn``, bit for bit, on the keys' device.
    Returns (slots, w, 2) float32: the accept coin and the residual (or
    bonus) inverse-CDF draw."""
    salted = jrandom.fold_in(keys, SPEC_SALT)
    return jrandom.uniform(jrandom.fold_in(salted[:, None, :], positions),
                           (2,))


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
    #: Tokens that existed when this request entered THIS engine — nonzero
    #: only for :meth:`ServingEngine.resume_inflight` imports, whose prefix
    #: is context to re-ingest, never to regenerate. A recompute
    #: preemption rolls ``tokens`` back to this floor, not to 0.
    resume_from: int = 0
    #: SLA metadata: protection class and absolute deadline on THIS
    #: engine's ``time.monotonic()`` clock (None = no deadline). Consumed
    #: by admission and victim order, never by sampling.
    slo_class: str = DEFAULT_CLASS
    deadline: Optional[float] = None
    #: LoRA adapter the stream decodes under (None: the base model).
    adapter_id: Optional[str] = None
    #: Param generation the stream is pinned to: the active one at its
    #: submission, or the one its resume record names.
    generation: int = 0
    #: The trace the request's phase spans join (obs on only): the
    #: router's dispatch context, or one minted at the first span.
    trace: Optional[TraceContext] = None

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
    key a request's default key folds its id into. ``kv_fleet`` is a fleet
    KV client (duck-typed: ``bind``, ``lookup_chain``, ``fetch``), bound
    here to this engine's pool layout. ``obs`` an
    :class:`~tpu_task_torch.obs.Obs` whose tracer and registry the engine
    records into (None: nothing is recorded). ``param_loader(generation)``
    returns the params of a generation a resumed record pins (None when it
    cannot); a replica sets it to restore checkpoint steps. ``mesh`` (a
    :class:`~tpu_task_torch.ml.parallel.mesh.Mesh`, rank 0's of a gang)
    serves over its ``tp`` and ``ep`` axes on the mesh's device; the full
    ``params`` (and ``draft_params``) stay where they are and each rank
    receives only its block."""

    def __init__(self, params: Params, cfg: TransformerConfig,
                 scfg: Optional[ServingConfig] = None,
                 rng: Optional[jrandom.KeyLike] = None, device=None,
                 draft_params: Optional[Params] = None,
                 draft_cfg: Optional[TransformerConfig] = None,
                 kv_fleet=None, obs=None, param_loader=None, mesh=None):
        self.cfg = cfg
        self.scfg = scfg = scfg or ServingConfig()
        self.mesh = mesh
        self.tp = mesh_axis_size(mesh, "tp")
        self.ep = mesh_axis_size(mesh, "ep")
        if mesh is not None:
            self._check_mesh(kv_fleet, draft_params, draft_cfg)
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"device {mesh.device}")
            self.device = mesh.device
        else:
            self.device = resolve_device(device)
        #: The gang behind the mesh (None: one process), and the key
        #: prefix of this engine's blocks on its ranks.
        self._gang = getattr(mesh, "gang", None)
        self._ns = self._gang.namespace() if self._gang else None
        if self._gang is not None:
            weakref.finalize(self, self._gang.release, self._ns)
        #: The params of every generation a stream is pinned to, and of
        #: the active one (:attr:`params`): under a mesh, this rank's
        #: block of them.
        self._gen_params: Dict[int, Params] = {
            0: self._place(params, cfg, "params/0")}
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
        self.pools = self._make_pools(cfg, scfg, "pools")
        self.allocator = BlockAllocator(scfg.n_blocks)
        self._pcache = (PrefixCache(self.allocator, scfg.block_size)
                        if scfg.prefix_cache else None)
        self._fleet = kv_fleet
        if kv_fleet is not None:
            if not scfg.prefix_cache:
                raise ValueError(
                    "kv_fleet needs prefix_cache=True — imported blocks "
                    "are adopted INTO the local prefix cache")
            kv_fleet.bind(cfg, scfg)
        self.fleet_hit_blocks = 0
        self.fleet_miss_blocks = 0
        self.fleet_import_requests = 0
        self.fleet_prefetch_blocks = 0
        self._h_kv_import = None
        # The host-RAM tier: the middle rung of device pool → host RAM →
        # fleet bucket. Cold refcount-0 cached blocks (an idle session's
        # among them, parked there by _release) demote into it: staged
        # behind the program in flight (_demote_pass) and forced at the
        # next consume edge (_finalize_demotions). Admission imports and
        # prefetch hints try it before the fleet bucket; entries past the
        # budget spill to the bucket through the fleet client.
        self._host_tier: Optional[HostKvTier] = None
        if scfg.host_offload_blocks > 0:
            spill = (kv_fleet.ship_bytes
                     if kv_fleet is not None
                     and hasattr(kv_fleet, "ship_bytes") else None)
            self._host_tier = HostKvTier(
                scfg.host_offload_blocks, spill=spill)
        self.demoted_blocks = 0
        self.promoted_blocks = 0
        #: Demotions staged against an in-flight program, as (hash, block,
        #: its pass's BlockStaging, its row there): the bytes are forced
        #: one consume edge later, never in the dispatch region.
        self._pending_demotions: List[
            Tuple[bytes, int, BlockStaging, int]] = []
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
        #: The active param generation: new admissions take its weights.
        self.generation = 0
        #: Unfinished streams a generation (queued ones too): a
        #: generation other than the active one is freed when its count
        #: reaches 0.
        self._gen_streams: Dict[int, int] = {}
        #: The generation a mid-roll step is dispatching (None outside a
        #: step): the other generations' slots are masked out.
        self._gen_filter: Optional[int] = None
        self.param_swaps = 0
        self.param_loader = param_loader
        # The asynchronous loop (ServingConfig.overlap): the host sweep of
        # program N runs while the device executes program N+1, see
        # _step_overlapped.
        self._overlap = scfg.overlap
        #: The dispatched but unswept program's record (None when the
        #: pipeline is empty): its Readback and the plan its sweep replays.
        #: At most ONE program is in flight.
        self._inflight: Optional[dict] = None
        #: The device carry (tok, pos, alive, emitted) the next program
        #: continues from: the generation's runner's carry tensors, or None
        #: when it must be rebuilt from the host mirrors (engine start, or
        #: after a flush).
        self._carry: Optional[Dict[str, torch.Tensor]] = None
        #: Each slot's position and emitted count once every dispatched
        #: program has run, what planning and block reservation read while
        #: the mirrors lag one program behind (exact for live slots).
        self._planned_pos = np.zeros((scfg.slots,), np.int32)
        self._planned_emitted = np.zeros((scfg.slots,), np.int32)
        #: Retirements swept outside step() (a flush), reported in the next
        #: step's ``finished``.
        self._pending_finished: List[int] = []
        self.overlap_flushes = 0
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
        self._init_lora()
        #: The replica's tracer and registry, or None (zero overhead).
        self.obs = obs
        self._phase_spans: Dict[int, Span] = {}
        self.goodput = GoodputMeter(
            cfg, device=self.device,
            registry=None if obs is None else obs.metrics)
        self._init_spec(draft_params, draft_cfg)
        if obs is not None:
            self._init_obs(obs.metrics)
        #: The K-step programs of each generation (a CUDA graph each on a
        #: CUDA device, captured at the generation's first micro-step),
        #: bound to its params and to self.pools, never rebound; dropped
        #: between steps once the generation is freed.
        self._micro_graphs: Dict[int, MicroStepGraphs] = {}
        #: Captures, capture time and replays of dropped generations.
        self._dropped_graph_stats = {"captures": 0, "lora_captures": 0,
                                     "capture_ms": 0.0, "replays": 0}

    def _check_mesh(self, kv_fleet, draft_params, draft_cfg) -> None:
        """The JAX engine's mesh checks, in its order and words, before
        anything is placed."""
        cfg, scfg, mesh = self.cfg, self.scfg, self.mesh
        if cfg.kv_heads % self.tp:
            raise ValueError(
                f"kv_heads {cfg.kv_heads} not divisible by tp "
                f"{self.tp} (mesh axes {tuple(mesh.axis_names)}): the "
                "paged pools shard their kv-head axis over tp")
        if self.ep > 1 and cfg.moe_every <= 0:
            raise ValueError(
                f"mesh carries ep={self.ep} but the model has no MoE "
                "layers (moe_every=0): drop the ep axis or serve an "
                "MoE config")
        # Resolve the ep dispatch before any placement: an indivisible
        # expert count fails with its own error.
        serving_moe_fn(cfg, mesh)
        if kv_fleet is not None:
            raise ValueError(
                "kv_fleet is single-chip for now: block payloads are "
                "unsharded (attach it to a mesh=None engine)")
        if scfg.host_offload_blocks > 0:
            raise ValueError(
                "host_offload_blocks is single-chip for now: tier "
                "payloads are unsharded block bytes (attach the "
                "host tier to a mesh=None engine)")
        if scfg.lora_rank > 0:
            raise ValueError(
                "lora_rank > 0 is single-chip for now: the adapter pool "
                "is unsharded (attach adapters to a mesh=None engine)")
        if scfg.overlap:
            raise ValueError(
                "overlap=True is single-chip for now: run the overlapped "
                "loop on a mesh=None engine (the sharded gangs keep the "
                "synchronous loop)")
        if scfg.spec_k > 0 and (draft_params is None or draft_cfg is None):
            raise ValueError("spec_k > 0 needs draft_params and draft_cfg")
        if scfg.spec_k > 0 and draft_cfg.kv_heads % self.tp:
            raise ValueError(
                f"draft kv_heads {draft_cfg.kv_heads} not divisible by tp "
                f"{self.tp}: the draft pool shards its kv-head axis with "
                "the same rules as the target's")

    def _place(self, params: Params, cfg: TransformerConfig,
               key: str) -> Params:
        """``params`` on this engine's device: under a mesh, this rank's
        block (every other rank receives its own, kept under ``key``)."""
        if self.mesh is None:
            return params_to(params, self.device)
        specs = param_pspecs(cfg, mesh=self.mesh)
        if self._gang is None:
            return device_put_tree(params, specs, self.mesh)
        return self._gang.scatter(f"{self._ns}/{key}", params, specs)

    def _make_pools(self, cfg: TransformerConfig, scfg: ServingConfig,
                    key: str):
        """Zeroed pools on this engine's device: under a mesh, every rank
        allocates its own kv-head block (kept under ``key``)."""
        if self._gang is None:
            return init_pools(cfg, scfg, self.device, mesh=self.mesh)
        return self._gang.make(f"{self._ns}/{key}", init_pools, cfg, scfg,
                               self.device, mesh=self.mesh)

    def _init_lora(self) -> None:
        """The adapter registry, the second allocator over the adapter
        pool, the pool itself (on the device, in the model dtype, never
        rebound) and the per-slot gather tables: row i of
        ``_slot_lora_blocks`` is slot i's block a layer (0: the scratch
        block), ``_slot_lora_scale[i]`` its scale (0: no adapter)."""
        scfg, cfg = self.scfg, self.cfg
        self._lora_on = scfg.lora_rank > 0
        #: adapter_id -> {hash, scale, payload (host copy or None), blocks
        #: (resident pool blocks or None), last_use, refs (slotted
        #: requests decoding under it: the eviction pin)}.
        self._adapters: Dict[str, dict] = {}
        self._lora_alloc: Optional[BlockAllocator] = None
        self._lora_pool: Optional[torch.Tensor] = None
        if self._lora_on:
            self._lora_alloc = BlockAllocator(scfg.n_adapter_blocks)
            self._lora_pool = init_adapter_pool(
                scfg.n_adapter_blocks, scfg.lora_rank, cfg.d_model,
                dtype=cfg.dtype, device=self.device)
        self._slot_lora_blocks = np.zeros((scfg.slots, cfg.n_layers),
                                          np.int32)
        self._slot_lora_scale = np.zeros((scfg.slots,), np.float32)
        self.adapters_registered = 0
        self.adapter_loads = 0
        self.adapter_evictions = 0

    def _init_obs(self, metrics) -> None:
        """The JAX engine's registry names: the latency histograms, the
        scheduler's plain counters as lazy counters (they sum in a fleet
        merge), its instantaneous values as gauges, LoRA's ``adapters.*``
        group when ``lora_rank`` > 0, the fleet-KV group when a client is
        attached, and the host tier's ``tier.*`` group when it is on."""
        self._h_step = metrics.histogram("engine.step_s")
        self._h_ttft = metrics.histogram("engine.ttft_s")
        self._h_intertok = metrics.histogram("engine.intertoken_s")
        self._h_e2e = metrics.histogram("engine.e2e_s")
        for stat in ("steps", "decode_steps", "micro_steps", "chunk_steps",
                     "prefills", "prefill_chunks", "preemption_count",
                     "cow_copies", "prefix_hit_requests",
                     "prefix_tokens_saved", "spec_rounds", "spec_accepted"):
            metrics.counter_fn(f"engine.{stat}",
                               lambda self=self, stat=stat:
                               float(getattr(self, stat)))
        for stat in ("n_active", "queue_depth"):
            metrics.gauge_fn(f"engine.{stat}",
                             lambda self=self, stat=stat:
                             float(getattr(self, stat)))
        metrics.gauge_fn("engine.micro_k",
                         lambda scfg=self.scfg: float(scfg.micro_k))
        metrics.gauge_fn("engine.param_generation",
                         lambda self=self: float(self.generation))
        metrics.counter_fn("engine.param_swaps",
                           lambda self=self: float(self.param_swaps))
        metrics.gauge_fn("engine.stale_generation_streams",
                         lambda self=self:
                         float(self.stale_generation_streams))
        if self._lora_on:
            for stat, name in (("adapters_registered", "registered"),
                               ("adapter_loads", "loads"),
                               ("adapter_evictions", "evictions")):
                metrics.counter_fn(f"adapters.{name}",
                                   lambda self=self, stat=stat:
                                   float(getattr(self, stat)))
            metrics.gauge_fn("adapters.resident",
                             lambda self=self: float(self.adapters_resident))
            metrics.gauge_fn("adapters.pool_high_water",
                             lambda self=self:
                             float(self._lora_alloc.high_water))
        if self._fleet is not None:
            self._h_kv_import = metrics.histogram("kvfleet.import_s")
            for stat in ("fleet_hit_blocks", "fleet_miss_blocks",
                         "fleet_import_requests", "fleet_prefetch_blocks"):
                metrics.counter_fn(f"kvfleet.{stat.replace('fleet_', '')}",
                                   lambda self=self, stat=stat:
                                   float(getattr(self, stat)))
            for stat in ("bytes_shipped", "bytes_fetched",
                         "published_blocks"):
                metrics.counter_fn(f"kvfleet.{stat}",
                                   lambda fleet=self._fleet, stat=stat:
                                   float(getattr(fleet, stat, 0)))
        if self._host_tier is not None:
            # Migration between the device pool and host RAM, and the
            # tier's own hits and spill tail, beside kvfleet.* on the one
            # registry.
            tier = self._host_tier
            for stat in ("demoted_blocks", "promoted_blocks"):
                metrics.counter_fn(f"tier.{stat}",
                                   lambda self=self, stat=stat:
                                   float(getattr(self, stat)))
            for stat in ("hits", "misses", "spilled_blocks",
                         "dropped_blocks"):
                metrics.counter_fn(f"tier.host_{stat}",
                                   lambda tier=tier, stat=stat:
                                   float(getattr(tier, stat)))
            metrics.gauge_fn("tier.host_resident_blocks",
                             lambda tier=tier: float(len(tier)))

    def _init_spec(self, draft_params: Optional[Params],
                   draft_cfg: Optional[TransformerConfig]) -> None:
        """Speculative decoding's state: the draft triple validated
        together, the draft's own pools — always in the draft's dtype,
        ``slots × max_blocks + 1`` blocks with a FIXED identity layout
        (slot s owns blocks [1 + s·m, 1 + (s+1)·m), never allocated or
        freed) — and the round counters."""
        scfg, n = self.scfg, self.scfg.slots
        m = scfg.max_blocks_per_slot
        self._spec_on = scfg.spec_k > 0
        #: Brownout knob (the degrade ladder's no-spec rung): False caps
        #: the draft width at zero INSIDE the spec round, so every slot
        #: still scores through the spec path's position-keyed streams and
        #: toggling it mid-stream cannot change a token.
        self.spec_enabled = True
        if self._spec_on and (draft_params is None or draft_cfg is None):
            raise ValueError("spec_k > 0 needs draft_params and draft_cfg")
        if draft_cfg is not None and \
                draft_cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{self.cfg.vocab_size}")
        self.draft_cfg = draft_cfg
        self.draft_params = None
        self.draft_decode_impl: Optional[str] = None
        self._draft_pos = np.zeros((n,), np.int32)
        self.spec_rounds = 0
        self.spec_proposed = 0
        self.spec_accepted = 0
        if not self._spec_on:
            return
        # The draft runs the target's paged attention. The kernels take
        # any head dim, but not every width: check the scoring step's and
        # the draft's shapes now, not at a launch mid-stream.
        if self.decode_impl in ("cuda", "pipelined"):
            for what, c, pool_dtype, w in (
                    ("the target's scoring step", self.cfg,
                     self.pools[0]["k"].dtype, scfg.spec_k + 1),
                    ("the draft model", draft_cfg, draft_cfg.dtype, 1)):
                try:
                    pa.require_geometry(
                        c.dtype, pool_dtype, w, c.n_heads // self.tp,
                        c.kv_heads // self.tp, c.d_head, scfg.block_size,
                        pipelined=self.decode_impl == "pipelined")
                except ValueError as error:
                    raise ValueError(
                        f"spec_k={scfg.spec_k}: {what} cannot run through "
                        f"{self.decode_impl!r}: {error}") from None
        self.draft_decode_impl = self.decode_impl
        self.draft_params = self._place(draft_params, draft_cfg,
                                        "draft_params")
        self._draft_pools = self._make_pools(
            draft_cfg, dataclasses.replace(scfg, n_blocks=n * m + 1,
                                           kv_dtype=None), "draft_pools")
        self._draft_tables = torch.as_tensor(
            1 + np.arange(n * m, dtype=np.int32).reshape(n, m),
            device=self.device)

    # -- front end -------------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, temperature: float = 0.0,
               top_p: Optional[float] = None,
               eos_token: Optional[int] = None, key=None,
               slo_class: str = DEFAULT_CLASS,
               deadline_s: Optional[float] = None,
               adapter_id: Optional[str] = None,
               trace: Optional[TraceContext] = None) -> int:
        """Queue a generation request; returns its id. Temperature 0 is
        greedy; ``top_p`` needs temperature > 0. ``key`` (two raw uint32
        words) overrides the engine-derived ``fold_in(base, rid)`` — a
        router passes one so the same request draws the same sampled
        stream on any replica. ``slo_class`` and ``deadline_s`` (seconds
        from now) order admission and preemption; ``adapter_id`` names a
        registered adapter the stream decodes under (it needs ``lora_rank``
        > 0). ``trace`` is the parent of the request's phase spans (obs
        on)."""
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
        if adapter_id is not None:
            if not self._lora_on:
                raise ValueError(
                    "adapter_id needs lora_rank > 0 in the ServingConfig")
            if adapter_id not in self._adapters:
                raise ValueError(
                    f"unknown adapter {adapter_id!r} — register_adapter "
                    "first")
        if self.scfg.prefill == "bucketed":
            self.scfg.bucket_for(len(prompt))  # must fit a prefill bucket
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
        now = time.monotonic()
        req = Request(
            rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_p=1.0 if top_p is None else top_p,
            eos_token=eos_token, key=key, submit_t=now,
            slo_class=str(slo_class),
            deadline=None if deadline_s is None else now + float(deadline_s),
            adapter_id=adapter_id, generation=self.generation, trace=trace)
        self._requests[rid] = req
        self._gen_streams[req.generation] = \
            self._gen_streams.get(req.generation, 0) + 1
        self._queue.append(req)
        self._obs_queue(req)
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
        """Occupied slots; inside a mid-roll step, those of the generation
        being dispatched."""
        return sum(self._gen_ok(r) for r in self._slots)

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or self.n_active > 0 \
            or self._inflight is not None

    @property
    def params(self) -> Params:
        """The active generation's weights, which new admissions take."""
        return self._gen_params[self.generation]

    @property
    def stale_generation_streams(self) -> int:
        """Unfinished streams pinned to a generation other than the
        active one: 0 once a roll is complete."""
        return sum(c for g, c in self._gen_streams.items()
                   if g != self.generation)

    def step(self) -> dict:
        """One scheduler iteration: admit → (chunk | decode) → retire.
        Returns the request ids admitted and finished. A pure-decode step
        at ``micro_k`` > 1 is one K-token micro-step.

        The fused programs run once for each param generation the slots
        hold (one, except mid-roll after :meth:`adopt_params`), each under
        its own weights with the other generations' slots masked out like
        empty ones. Keyed sampling makes a stream independent of who
        shares its steps, so each stream's tokens are those of an engine
        that holds its generation alone.

        With ``overlap`` on, the step runs the asynchronous loop
        (:meth:`_step_overlapped`) whenever every slot and queued request
        holds the active generation: results lag one step. Mid-roll it
        flushes the in-flight program and runs this synchronous body."""
        if self._overlap:
            if all(r.generation == self.generation
                   for r in list(self._slots) + list(self._queue)
                   if r is not None):
                return self._step_overlapped()
            self.flush()
        t0 = time.perf_counter()
        self.goodput.begin_step()
        self.steps += 1
        admitted: List[int] = []
        finished: List[int] = self._pending_finished    # swept by a flush
        self._pending_finished = []
        self._admit(admitted, finished)
        gens = sorted({r.generation for r in self._slots if r is not None})
        with torch.no_grad():
            for gen in gens:
                self._gen_filter = gen
                try:
                    self._step_generation(finished)
                finally:
                    self._gen_filter = None
            # Synchronous demotion: stage and force back to back. The
            # device has just run the step's programs, so the force waits
            # for the demote copies alone.
            self._demote_pass()
            self._finalize_demotions()
        # Between steps: no K-step graph is being captured or replayed.
        self._drop_freed_graphs()
        wall = time.perf_counter() - t0
        self.goodput.end_step(wall)
        if self.obs is not None:
            self._h_step.observe(wall)
        return {"admitted": admitted, "finished": finished,
                "active": self.n_active, "queued": len(self._queue)}

    def _step_generation(self, finished: list) -> None:
        """The step's fused programs for the slots of the generation in
        ``_gen_filter``."""
        if not self.n_active:
            return      # a preemption of the partition before emptied it
        prefilling = any(self._prefilling(i) for i in range(self.scfg.slots))
        if prefilling:
            # With spec on, the chunk step advances only the ingesting
            # slots and the spec round below advances the decoders, so a
            # request's later tokens always come from the spec path.
            self._chunk_step(finished)
        if self._spec_on:
            self._spec_step(finished)
        elif not prefilling and self.n_active:
            # Spec rounds are the multi-token path when spec is on;
            # otherwise a pure-decode step is a K-token micro-step.
            if self.scfg.micro_k > 1:
                self._micro_decode(finished)
            else:
                self._decode(finished)

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

    # -- the asynchronous loop (ServingConfig.overlap) -------------------------
    #
    # One overlapped step, the JAX engine's contract:
    #
    #   admit        into slots free as of the LAST sweep; an admission rides
    #                the NEXT program's chunk rows
    #   dispatch N+1 planned from the worst-case device positions; the loop
    #                state comes from program N's device carry, never from
    #                the host
    #   consume N    the ONE wait: program N's token readback, and the sweep
    #                replayed from its dispatch record
    #
    # so the host sweep of program N runs while the device executes N+1. On
    # CUDA, correctness rests on two facts built by hand where XLA gives them
    # to the JAX engine. (a) One stream: every program, every pool write
    # (copy-on-write, a fleet import, an adapter load) and every readback is
    # enqueued on the current stream, so the device runs them in dispatch
    # order; a block freed by sweep N and handed to an admission is written
    # only by work enqueued after N+1. (b) Nothing in the dispatch region
    # waits for the device: uploads go through fresh pinned buffers
    # (step_graph.upload), and a program's tokens come back through its own
    # pinned copy and event (step_graph.Readback), read at the consume edge
    # only. Greedy and keyed sampled streams are schedule independent, so
    # they equal the synchronous loop's although admissions land one sweep
    # later; pool pressure the planner cannot cover flushes to the
    # synchronous edge first, so preemption happens where the synchronous
    # loop's would.

    def _step_overlapped(self) -> dict:
        t0 = time.perf_counter()
        self.goodput.begin_step()
        self.steps += 1
        admitted: List[int] = []
        finished: List[int] = self._pending_finished
        self._pending_finished = []
        self._admit_chunked(admitted)
        with torch.no_grad():
            rec = self._dispatch_next(finished)   # pool pressure may flush
        # Covered: a program spanned this step's host work, the previous
        # one still unconsumed or a new one just enqueued.
        covered = rec is not None or self._inflight is not None
        self._consume_one(self._inflight, finished)
        with torch.no_grad():
            # Tier migration in the covered window: last step's staging,
            # enqueued behind the program just consumed, is forced here,
            # and the next pass stages behind the program dispatched
            # above.
            self._finalize_demotions()
            self._demote_pass()
        self._inflight = rec
        wall = time.perf_counter() - t0
        self.goodput.end_step_overlapped(wall, covered)
        if self.obs is not None:
            self._h_step.observe(wall)
        return {"admitted": admitted, "finished": finished,
                "active": self.n_active, "queued": len(self._queue)}

    def flush(self) -> None:
        """Drain the overlap pipeline to the synchronous edge: consume and
        sweep the in-flight program, then drop the device carry (the next
        dispatch rebuilds it from the host mirrors, which after a full
        sweep ARE the device state: the carry is absolute). Preemption,
        :meth:`export_inflight` and :meth:`adopt_params` run behind a
        flush. Retirements swept here are reported in the next step's
        ``finished``. A no-op when nothing is in flight."""
        self._consume_one(self._inflight, self._pending_finished)
        self._inflight = None
        self._carry = None

    def _rebuild_carry(self) -> None:
        """Host mirrors to the device carry (engine start, or after a
        flush), with a non-blocking copy into the runner's carry tensors.
        Prefilling and empty slots enter dead: the chunk program's
        promotion is the only writer that turns a row live, so a dead
        row's stale tok and pos are never read."""
        alive = np.array(
            [req is not None and req.status == RUNNING
             and not self._prefilling(i)
             for i, req in enumerate(self._slots)])
        emitted = np.array([len(req.tokens) if req is not None else 0
                            for req in self._slots], np.int32)
        carry = self._micro_runner().carry
        values = upload({
            "tok": (self._last_token, torch.int64),
            "pos": (np.where(alive, self._positions, 0), torch.int32),
            "alive": (alive, torch.bool),
            "emitted": (emitted, torch.int32)}, self.device)
        store_carry(carry, values.values())
        self._carry = carry
        self._planned_pos = np.asarray(self._positions, np.int32).copy()
        self._planned_emitted = emitted.copy()

    # overlap: begin-dispatch-region
    # Nothing between this marker and its end may wait for the device (a
    # readback, a synchronize, a blocking upload, int/float/bool of a
    # tensor): this code runs while the previous program executes, and one
    # wait here serializes the loop. tests/test_torch_overlap_lint.py walks
    # the region and enforces it.

    def _plan_step(self):
        """What the next program runs, read off the planned device state
        (exact for live slots; an over-estimate only for a slot that
        retired on eos inside a still-unswept program, whose rows the
        device masks). Prefill rows split the one ``chunk_tokens`` budget
        oldest admission first. Returns (prefill rows as (slot, chunk,
        planned pos, completing), decode candidate slots, per-slot
        reservation widths), or None when there is nothing to run."""
        n, K, W = self.scfg.slots, self.scfg.micro_k, self.scfg.chunk_tokens
        prefill = []
        budget = W
        for i in sorted(range(n), key=lambda j: self._admit_seq[j]):
            req = self._slots[i]
            if req is None or req.status != RUNNING or not budget:
                continue
            pos = int(self._planned_pos[i])
            target = int(self._prefill_target[i])
            if pos < target:
                c = min(budget, target - pos)
                budget -= c
                prefill.append((i, c, pos, pos + c >= target))
        decode = [
            i for i, req in enumerate(self._slots)
            if req is not None and req.status == RUNNING
            and int(self._planned_pos[i]) >= int(self._prefill_target[i])
            and int(self._planned_emitted[i]) < req.max_new_tokens]
        if not prefill and not decode:
            return None
        widths = np.zeros((n,), np.int32)
        for i, c, _, _ in prefill:
            widths[i] = c
        for i in decode:
            widths[i] = 1 if prefill else min(
                K, self._slots[i].max_new_tokens
                - int(self._planned_emitted[i]))
        return prefill, decode, widths

    def _reserve_planned(self, widths: np.ndarray) -> bool:
        """The overlapped half of :meth:`_ensure_blocks`: cover each slot's
        next ``widths[i]`` writes FROM ITS PLANNED POSITION, evicting
        refcount-0 cached blocks but never preempting (the in-flight
        program is still advancing every running slot). False: the pool
        cannot cover it; what was allocated stays with its slot and the
        caller flushes, so that the synchronous path preempts on exact
        state."""
        bs = self.scfg.block_size
        for slot in sorted(range(self.scfg.slots),
                           key=lambda i: self._admit_seq[i]):
            w = int(widths[slot])
            if not w:
                continue
            pos = int(self._planned_pos[slot])
            for block_i in range(pos // bs, (pos + w - 1) // bs + 1):
                if self._tables[slot, block_i] != SCRATCH_BLOCK:
                    continue
                got = self._reserve(1, 0)
                if got is None:
                    return False
                self._tables[slot, block_i] = got[0]
        return True

    def _dispatch_next(self, finished: list) -> Optional[dict]:
        """Plan, reserve and enqueue the next program; returns its sweep
        record (installed as in flight AFTER the previous program is
        consumed), or None when there is nothing to run (the drain's
        consume-only tail)."""
        if self._carry is None:
            self._rebuild_carry()
        plan = self._plan_step()
        if plan is None:
            return None
        prefill, decode, widths = plan
        if not self._reserve_planned(widths):
            # Pool pressure beyond eviction: to the synchronous edge. After
            # the flush the mirrors are exact, so _ensure_blocks preempts
            # exactly where the synchronous loop would.
            self.overlap_flushes += 1
            self.flush()
            finished.extend(self._pending_finished)
            self._pending_finished = []
            self._rebuild_carry()
            plan = self._plan_step()
            if plan is None:
                return None
            prefill, decode, widths = plan
            before = self.preemption_count
            self._ensure_blocks(widths)
            if self.preemption_count != before:
                self._rebuild_carry()     # preempted slots left the carry
                plan = self._plan_step()
                if plan is None:
                    return None
                prefill, decode, widths = plan
        if prefill:
            return self._dispatch_chunk(prefill, decode)
        return self._dispatch_micro(decode, widths)

    def _req_limits_eos(self):
        """Each slot's ABSOLUTE limit (max_new_tokens; 0 empty) and eos
        (-1 none), the carry programs' retirement inputs."""
        limits = np.array([r.max_new_tokens if r is not None else 0
                           for r in self._slots], np.int32)
        eos = np.array([r.eos_token if r is not None
                        and r.eos_token is not None else -1
                        for r in self._slots], np.int64)
        return limits, eos

    def _dispatch_micro(self, decode: List[int], widths: np.ndarray) -> dict:
        """Pure-decode program: the K-token carry micro-step through the
        generation's runner (a CUDA graph replay at every K, K = 1 too),
        under the per-slot adapter tables. A quantized pool writes through
        the stacked layout of the candidates' PLANNED positions."""
        n = self.scfg.slots
        limits, eos = self._req_limits_eos()
        cand = np.zeros((n,), bool)
        cand[decode] = True
        inputs = dict(tables=self._tables, limits=limits, eos=eos)
        sampled = not self._all_greedy()
        if sampled:
            temps, tops = self._temps_tops()
            inputs.update(temps=temps, tops=tops, keys=self._slot_keys)
        if self._quantized:
            inputs.update(self._micro_quant_layout(
                np.where(cand, self._planned_pos, 0).astype(np.int32),
                widths))
        lora = self._lora_rows(np.arange(n))
        if lora is not None:
            inputs.update(lblocks=lora[0], lscales=lora[1])
        rec_pos = self._planned_pos.copy()
        t0 = time.perf_counter()
        out = self._micro_runner().dispatch(sampled, inputs,
                                            lora=lora is not None)
        self.goodput.program(time.perf_counter() - t0)
        self.decode_steps += 1
        if self.scfg.micro_k > 1:
            self.micro_steps += 1
        for i in decode:
            self._planned_pos[i] += int(widths[i])
            self._planned_emitted[i] += int(widths[i])
        return {"kind": "micro", "out": out, "reqs": list(self._slots),
                "cand": cand, "pos0": rec_pos}

    def _dispatch_chunk(self, prefill, decode: List[int]) -> dict:
        """Mixed program: every admitting slot's chunk rows packed beside
        the carry's decode rows (the overlapped :meth:`_chunk_step`), run
        eagerly from the runner's carry, which it updates in place. A
        completing prefill is PROMOTED in the program: its first token is
        sampled on the device and enters the carry; the host reads it at
        the sweep. Chunk rows take their owning slot's adapter rows."""
        n, W = self.scfg.slots, self.scfg.chunk_tokens
        m = self.scfg.max_blocks_per_slot
        limits, eos = self._req_limits_eos()
        ctoks = np.zeros((W,), np.int32)
        cpos = np.zeros((W,), np.int32)
        cvalid = np.zeros((W,), bool)
        tables = np.zeros((n + W, m), np.int32)
        tables[:n] = self._tables
        prow = np.full((n,), -1, np.int32)
        ppos = np.zeros((n,), np.int32)
        pngen = np.zeros((n,), np.int32)
        temps = np.zeros((n + W,), np.float32)
        tops = np.ones((n + W,), np.float32)
        rkeys = np.zeros((n + W, 2), np.uint32)
        cngen = np.zeros((W,), np.int64)
        owners = np.full((n + W,), -1, np.int64)   # each row's slot
        owners[:n] = np.arange(n)
        temps[:n], tops[:n] = self._temps_tops()
        rkeys[:n] = self._slot_keys
        rows = []                     # (slot, row offset, c, pos, completing)
        off = 0
        for i, c, pos, completing in prefill:
            req = self._slots[i]
            ctx = self._context_ids(req)
            rs = slice(off, off + c)
            ctoks[rs] = ctx[pos:pos + c]
            cpos[rs] = np.arange(pos, pos + c)
            cvalid[rs] = True
            rs = slice(n + off, n + off + c)
            tables[rs] = self._tables[i]
            temps[rs] = req.temperature
            tops[rs] = req.top_p
            rkeys[rs] = self._slot_keys[i]
            owners[rs] = i
            cngen[off:off + c] = len(req.tokens)
            if completing:
                prow[i] = off + c - 1
                ppos[i] = int(self._prefill_target[i])
                pngen[i] = len(req.tokens)
            rows.append((i, off, c, pos, completing))
            off += c
        host = {"ctoks": (ctoks, torch.int64), "cpos": (cpos, torch.int32),
                "cvalid": (cvalid, torch.bool),
                "tables": (tables, torch.int32),
                "limits": (limits, torch.int32), "eos": (eos, torch.int64),
                "prow": (prow, torch.int32), "ppos": (ppos, torch.int32),
                "pngen": (pngen, torch.int32)}
        sampled = not self._all_greedy()
        if sampled:
            host.update(temps=(temps, torch.float32),
                        tops=(tops, torch.float32),
                        rkeys=(rkeys, torch.int64),
                        cngen=(cngen, torch.int64))
        if self._quantized:
            rpos = np.zeros((n + W,), np.int32)
            rvalid = np.zeros((n + W,), bool)
            rpos[decode] = self._planned_pos[decode]
            rvalid[decode] = True
            rpos[n:], rvalid[n:] = cpos, cvalid
            layout = self._quant_layout(tables, rpos[:, None],
                                        rvalid[:, None])
            host.update({name: (a, torch.int64) for name, a in zip(
                ("touched", "filled", "wt", "wo"), layout)})
        lora = self._lora_rows(owners)
        if lora is not None:
            host.update(lblocks=(lora[0], torch.int64),
                        lscales=(lora[1], torch.float32))
        rec_pos = self._planned_pos.copy()
        work = (len(decode) + int(cvalid.sum()),
                float(sum(int(rec_pos[i]) for i in decode))
                + float(cpos[cvalid].sum()))
        runner = self._micro_runner()
        t0 = time.perf_counter()
        t = upload(host, self.device)
        qa = ((t["touched"], t["filled"], t["wt"], t["wo"])
              if self._quantized else None)
        head = (self._model_params(
                    None if lora is None else (t["lblocks"], t["lscales"])),
                self.cfg, *runner.carry.values(), t["ctoks"], t["cpos"],
                t["cvalid"], t["tables"], t["limits"], t["eos"], t["prow"],
                t["ppos"], t["pngen"])
        kwargs = dict(attn_impl=self.decode_impl, measure_qerr=self.debug,
                      mesh=self.mesh)
        if sampled:
            out = chunk_carry_sample(*head, t["temps"], t["tops"],
                                     t["rkeys"], t["cngen"], self.pools, qa,
                                     **kwargs)
        else:
            out = chunk_carry_greedy(*head, self.pools, qa, **kwargs)
        store_carry(runner.carry, out[1])
        readback = Readback(out[0], out[2] if self._quantized
                            and self.debug else None)
        self.goodput.program(time.perf_counter() - t0)
        self.chunk_steps += 1
        for i, c, pos, completing in prefill:
            if completing:
                self._planned_pos[i] = int(self._prefill_target[i])
                self._planned_emitted[i] += 1
            else:
                self._planned_pos[i] = pos + c
        for i in decode:
            self._planned_pos[i] += 1
            self._planned_emitted[i] += 1
        return {"kind": "chunk", "out": readback, "reqs": list(self._slots),
                "decode": list(decode), "rows": rows, "pos0": rec_pos,
                "work": work}

    # overlap: end-dispatch-region

    def _consume_one(self, rec: Optional[dict], finished: list) -> None:
        """The pipeline's ONE wait: the recorded program's tokens, and the
        sweep replayed strictly from its DISPATCH RECORD, never from the
        current slots. A row whose recorded request is no longer RUNNING
        (an earlier sweep retired it) is skipped: its slot may hold a
        newer admission. The replayed retirement rule is the device's (eos
        or emitted >= max_new), so host and carry agree."""
        if rec is None:
            return
        t0 = time.perf_counter()
        ys = rec["out"].wait()
        self.goodput.consume_wait(time.perf_counter() - t0)
        if rec["out"].qerr is not None:
            self._note_qerr(rec["out"].qerr)
        now = time.monotonic()
        n = self.scfg.slots
        emitted_total, pos_sum = 0, 0.0
        if rec["kind"] == "micro":
            for slot in range(n):
                req = rec["reqs"][slot]
                if not rec["cand"][slot] or req is None \
                        or req.status != RUNNING:
                    continue
                for j in range(ys.shape[0]):
                    tok = int(ys[j, slot])
                    req.tokens.append(tok)
                    emitted_total += 1
                    pos_sum += float(rec["pos0"][slot]) + j
                    self._positions[slot] += 1
                    self._last_token[slot] = tok
                    if req.first_token_t is None:
                        req.first_token_t = now
                        self._obs_first_token(req)
                    if req.finished:
                        break
                if req.finished:
                    self._retire(slot)
                    finished.append(req.rid)
            self.goodput.work_counts(emitted_total, pos_sum)
            self.goodput.emitted(emitted_total)
            return
        for slot in rec["decode"]:
            req = rec["reqs"][slot]
            if req is None or req.status != RUNNING:
                continue
            tok = int(ys[slot])
            req.tokens.append(tok)
            emitted_total += 1
            self._positions[slot] += 1
            self._last_token[slot] = tok
            if req.first_token_t is None:
                req.first_token_t = now
                self._obs_first_token(req)
            if req.finished:
                self._retire(slot)
                finished.append(req.rid)
        for slot, off, c, pos, completing in rec["rows"]:
            req = rec["reqs"][slot]
            if req is None or req.status != RUNNING:
                continue
            self._positions[slot] = pos + c
            self.prefill_chunks += 1
            if not completing:
                continue
            self.prefills += 1              # prompt complete: first token
            tok = int(ys[n + off + c - 1])
            req.tokens.append(tok)
            emitted_total += 1
            self._last_token[slot] = tok
            if req.first_token_t is None:
                req.first_token_t = now
                self._obs_first_token(req)
            if req.finished:
                self._retire(slot)
                finished.append(req.rid)
        self.goodput.work_counts(*rec["work"])
        self.goodput.emitted(emitted_total)

    def export_inflight(self) -> List[dict]:
        """Every not-yet-done request as a JSON-serializable record, key
        for key the JAX engine's: the prompt, the tokens emitted so far,
        the per-request key (raw uint32 words), the sampling parameters,
        ``slo_class``, ``generation``, and ``deadline_s`` (REMAINING
        seconds, clamped at 0: two processes share no clock) and
        ``adapter_id`` when set. Values are plain ints, floats, lists and
        None. Tokens are committed only at a step's host sweep, so a
        record between steps always ends on a token boundary, at any
        ``micro_k``. In overlap mode the in-flight program is swept first
        (:meth:`flush`): its tokens belong in the records. The engine is
        otherwise left untouched."""
        self.flush()
        records = []
        for req in self._requests.values():
            if req.status == DONE:
                continue
            record = {
                "rid": int(req.rid),
                "prompt": [int(t) for t in req.prompt],
                "tokens": [int(t) for t in req.tokens],
                "key": [int(w) for w in np.asarray(req.key, np.uint32)
                        .reshape(-1)],
                "max_new_tokens": int(req.max_new_tokens),
                "temperature": float(req.temperature),
                "top_p": float(req.top_p),
                "eos_token": (None if req.eos_token is None
                              else int(req.eos_token)),
                "slo_class": req.slo_class,
                "generation": int(req.generation),
            }
            if req.adapter_id is not None:
                record["adapter_id"] = req.adapter_id
            if req.deadline is not None:
                record["deadline_s"] = max(
                    0.0, req.deadline - time.monotonic())
            records.append(record)
            # The open phase span ends "exported": the drain is part of
            # the request's trace; the request itself is untouched.
            self._obs_interrupt(req, "exported")
        return records

    def resume_inflight(self, records: List[dict],
                        trace: Optional[TraceContext] = None
                        ) -> Dict[int, int]:
        """Import :meth:`export_inflight` records (from this package's
        engine or the JAX package's, possibly in another process); returns
        {exported rid: local rid}. A resumed request re-ingests prompt +
        emitted tokens as context through the chunk steps and continues at
        token index ``len(tokens)``: with the exported key, greedy streams
        and sampled ones (keyed by ``fold_in(key, index)``) continue token
        for token. A speculative round's sampled draws are keyed by
        absolute position instead, so the token a resumed spec engine
        samples at ``len(tokens)`` (the chunk step's) differs from the
        uninterrupted spec stream's there, as in the JAX engine. A record
        that already met its stopping condition imports as done. ``trace``
        is the parent of the imported requests' phase spans (obs on)."""
        mapping: Dict[int, int] = {}
        for record in records:
            prompt = np.asarray(record["prompt"], np.int32).reshape(-1)
            tokens = [int(t) for t in record.get("tokens", ())]
            max_new = int(record["max_new_tokens"])
            eos = record.get("eos_token")
            if len(prompt) < 1:
                raise ValueError("prompt must hold at least one token")
            if max_new < 1:
                raise ValueError(
                    f"max_new_tokens must be >= 1, got {max_new}")
            if len(tokens) > max_new:
                raise ValueError(
                    f"resume record carries {len(tokens)} tokens but "
                    f"max_new_tokens is {max_new}")
            total = len(prompt) + max_new
            if total > self.scfg.max_len:
                raise ValueError(
                    f"resumed context {len(prompt)} + max_new_tokens "
                    f"{max_new} exceeds max_len {self.scfg.max_len}")
            if self.scfg.blocks_for(total) > self.scfg.n_blocks - 1:
                raise ValueError(
                    f"resumed request needs {self.scfg.blocks_for(total)} "
                    f"blocks but the pool holds {self.scfg.n_blocks - 1}")
            if self.scfg.prefill == "bucketed" and tokens:
                # A bucketed admission ingests prompt + resumed prefix in
                # ONE padded program, so the context needs a bucket though
                # only the prompt did at submit. Past every bucket, it is
                # recomputed from the prompt alone: keyed sampling (and
                # greedy's purity) regenerates the same prefix, so a valid
                # in-flight request never becomes unresumable.
                try:
                    self.scfg.bucket_for(len(prompt) + len(tokens))
                except ValueError:
                    tokens = []
            ids = np.concatenate([prompt, np.asarray(tokens, np.int32)])
            if ((ids < 0) | (ids >= self.cfg.vocab_size)).any():
                raise ValueError(
                    f"resume record token ids must lie in "
                    f"[0, {self.cfg.vocab_size})")
            aid = record.get("adapter_id")
            if aid is not None:
                if not self._lora_on:
                    raise ValueError(
                        f"resume record pins adapter {aid!r} but this "
                        "engine has lora_rank 0")
                if aid not in self._adapters:
                    raise ValueError(
                        f"resume record pins adapter {aid!r} — "
                        "register_adapter on the importer first")
            key = _check_key(record["key"])
            deadline_s = record.get("deadline_s")
            gen = int(record.get("generation", self.generation))
            now = time.monotonic()
            req = Request(
                rid=self._next_rid, prompt=prompt, max_new_tokens=max_new,
                temperature=float(record.get("temperature", 0.0)),
                top_p=float(record.get("top_p", 1.0)),
                eos_token=None if eos is None else int(eos), key=key,
                submit_t=now, tokens=tokens, resume_from=len(tokens),
                slo_class=str(record.get("slo_class", DEFAULT_CLASS)),
                deadline=None if deadline_s is None
                else now + float(deadline_s),
                adapter_id=aid, generation=gen, trace=trace)
            if not req.finished and gen not in self._gen_params:
                self._restore_generation(gen)
            self._next_rid += 1
            self._requests[req.rid] = req
            if req.finished:
                req.status = DONE
                req.finish_t = now
            else:
                self._gen_streams[gen] = self._gen_streams.get(gen, 0) + 1
                # The imported prefix is context another engine already
                # produced: re-ingesting it is work the ratio discounts.
                self.goodput.wasted_reingest(len(tokens))
                self._queue.append(req)
                self._obs_queue(req)
            mapping[int(record.get("rid", req.rid))] = req.rid
        return mapping

    def _restore_generation(self, gen: int) -> None:
        """A resumed record pins generation ``gen``, which this engine
        does not hold: restore it through ``param_loader`` rather than
        decode the stream under different weights."""
        if self.param_loader is None:
            raise ValueError(
                f"resume record pins param generation {gen}, which is not "
                "resident and no param_loader could restore it — refusing "
                "to decode the stream under different weights")
        restored = self.param_loader(gen)
        if restored is None:
            raise ValueError(
                f"resume record pins param generation {gen} and the "
                "param_loader returned nothing — refusing to decode the "
                "stream under different weights")
        self._gen_params[gen] = self._place(restored, self.cfg,
                                            f"params/{gen}")

    def adopt_params(self, params: Params,
                     generation: Optional[int] = None) -> int:
        """Install a new weight generation without dropping a stream: new
        admissions take ``params`` at once, every in-flight stream keeps
        the generation it started on (:meth:`step` dispatches by
        generation until the old streams retire), and an old generation
        is freed with its last stream. ``generation`` defaults to the next
        integer (a replica passes the checkpoint step) and must grow.
        The params move to the engine's device. Returns the installed
        generation. In overlap mode the in-flight program, dispatched under
        the old generation, is swept first (:meth:`flush`). A sharded
        engine refuses, as the JAX engine does."""
        if self.mesh is not None:
            raise ValueError(
                "adopt_params is single-chip for now: sharded gangs "
                "re-shard new params by building a fresh engine")
        gen = self.generation + 1 if generation is None else int(generation)
        if gen <= self.generation:
            raise ValueError(
                f"param generation must grow monotonically: got {gen}, "
                f"active is {self.generation}")
        self.flush()
        self._gen_params[gen] = params_to(params, self.device)
        self.generation = gen
        self.param_swaps += 1
        # Free every other generation that no stream holds: a roll with
        # no old stream in flight frees the old weights here.
        for g in [g for g in self._gen_params
                  if g != gen and not self._gen_streams.get(g, 0)]:
            del self._gen_params[g]
        self._drop_freed_graphs()
        return gen

    def _gen_release(self, req: Request) -> None:
        """A stream retired: drop its generation's count, and free a
        generation other than the active one that just lost its last
        stream."""
        g = req.generation
        left = self._gen_streams.get(g, 0) - 1
        if left > 0:
            self._gen_streams[g] = left
            return
        self._gen_streams.pop(g, None)
        if g != self.generation:
            self._gen_params.pop(g, None)

    def _drop_freed_graphs(self) -> None:
        """Drop the K-step graphs of freed generations (between steps, so
        never while a graph is captured), keeping their counts. Nothing is
        in flight then: a generation is freed only outside the overlapped
        loop, which runs one generation and is flushed before a roll."""
        for g in [g for g in self._micro_graphs if g not in self._gen_params]:
            for key, value in self._micro_graphs.pop(g).stats().items():
                self._dropped_graph_stats[key] += value

    def _gen_ok(self, req: Optional[Request]) -> bool:
        """Does this slot take part in the program being built? Inside a
        mid-roll step only the dispatched generation's slots do."""
        return req is not None and (self._gen_filter is None
                                    or req.generation == self._gen_filter)

    def _dispatch_gen(self) -> int:
        """The generation whose weights the next program runs under."""
        return (self.generation if self._gen_filter is None
                else self._gen_filter)

    def _lora_rows(self, owners) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """A step's per-row adapter tables: ``owners[i]`` is the slot whose
        adapter row i runs under (-1: none, the scratch block at scale 0).
        None when LoRA is off or no row carries a nonzero scale: the step
        then runs the LoRA-free program (the JAX engine's drop rule; a
        scale-0 row adds an exact 0.0 either way)."""
        if not self._lora_on:
            return None
        owners = np.asarray(owners, np.int64)
        scales = np.where(owners >= 0,
                          self._slot_lora_scale[np.maximum(owners, 0)],
                          0.0).astype(np.float32)
        if not scales.any():
            return None
        blocks = gather_tables(self._slot_lora_blocks, owners.tolist())
        validate_lora_tables(blocks, self.scfg.n_adapter_blocks)
        return blocks, scales

    def _model_params(self, lora=None, gen: Optional[int] = None) -> Params:
        """Generation ``gen``'s weights (default: the dispatched one's),
        plus, for a step that carries an adapter (``lora``,
        :meth:`_lora_rows`), ``"lora"``: the one adapter pool and the
        step's tables on the device."""
        params = self._gen_params[self._dispatch_gen() if gen is None
                                  else gen]
        if lora is None:
            return params
        blocks, scales = lora
        return {**params, "lora": (
            self._lora_pool,
            torch.as_tensor(blocks, device=self.device, dtype=torch.int64),
            torch.as_tensor(scales, device=self.device,
                            dtype=torch.float32))}

    def _micro_runner(self) -> MicroStepGraphs:
        """The dispatched generation's K-step programs and overlap carry,
        made at its first micro-step (or overlapped dispatch)."""
        gen = self._dispatch_gen()
        runner = self._micro_graphs.get(gen)
        if runner is None:
            runner = self._micro_graphs[gen] = MicroStepGraphs(
                self._gen_params[gen], self.cfg, self.pools,
                slots=self.scfg.slots,
                max_blocks=self.scfg.max_blocks_per_slot,
                micro_k=self.scfg.micro_k, attn_impl=self.decode_impl,
                measure_qerr=self.debug, device=self.device,
                lora_pool=self._lora_pool, mesh=self.mesh)
        return runner

    def _graph_stats(self) -> dict:
        out = dict(self._dropped_graph_stats)
        for runner in self._micro_graphs.values():
            for key, value in runner.stats().items():
                out[key] += value
        return out

    # -- paged LoRA adapters ---------------------------------------------------

    def register_adapter(self, adapter_id: str, layers, scale: float = 1.0,
                         *, host_copy: bool = True) -> str:
        """Register a tenant's LoRA adapter under ``adapter_id``:
        ``layers`` is one (A (d, r), B (r, d)) pair a model layer (dicts
        ``{"a", "b"}`` or tuples, any r <= ``lora_rank``, zero-padded; see
        :func:`~tpu_task_torch.ml.serving.lora.pack_adapter`). The packed
        payload is content-hashed (the JAX package's bytes and hash) and
        shipped to the fleet bucket when a ``kv_fleet`` client with
        ``ship_adapter`` is attached. Residency is lazy: the pool blocks
        are claimed at the adapter's first use, and cold adapters evict LRU
        under pool pressure, reloading from the host copy or, with
        ``host_copy=False``, from the bucket. Re-registering the same
        content is a no-op; other content under an id that streams decode
        under raises. Returns the content hash."""
        if not self._lora_on:
            raise ValueError(
                "register_adapter needs lora_rank > 0 (and "
                "n_adapter_blocks) in the ServingConfig")
        payload = pack_adapter(layers, self.scfg.lora_rank,
                               self.cfg.d_model)
        if payload.shape[0] != self.cfg.n_layers:
            raise ValueError(
                f"adapter carries {payload.shape[0]} layers, the model "
                f"has {self.cfg.n_layers}")
        if self.cfg.n_layers > self.scfg.n_adapter_blocks - 1:
            raise ValueError(
                f"one adapter needs {self.cfg.n_layers} blocks but the "
                f"pool holds {self.scfg.n_adapter_blocks - 1} — raise "
                "n_adapter_blocks")
        h = adapter_fingerprint(payload, float(scale))
        existing = self._adapters.get(adapter_id)
        if existing is not None:
            if existing["hash"] == h:
                return h              # same content: keep its residency
            if existing["refs"]:
                raise ValueError(
                    f"adapter {adapter_id!r} re-registered with "
                    "different weights while streams decode under it — "
                    "retire them first (or register a new id)")
            if existing["blocks"] is not None:
                self._evict_adapter(adapter_id)
        can_ship = self._fleet is not None \
            and hasattr(self._fleet, "ship_adapter")
        if not host_copy and not can_ship:
            raise ValueError(
                "host_copy=False needs an attached kv_fleet client "
                "with ship_adapter: an evicted adapter must have "
                "somewhere to reload from")
        if can_ship:
            self._fleet.ship_adapter(
                h, adapter_payload(payload, float(scale)))
        self._adapters[adapter_id] = {
            "hash": h, "scale": float(scale),
            "payload": payload if host_copy else None,
            "blocks": None, "last_use": 0.0, "refs": 0,
        }
        self.adapters_registered += 1
        return h

    @property
    def adapters_resident(self) -> int:
        return sum(e["blocks"] is not None for e in self._adapters.values())

    def _evict_adapter(self, adapter_id: str) -> None:
        """Return a cold adapter's blocks to the pool; no table points at
        them, and the next load overwrites their bytes."""
        entry = self._adapters[adapter_id]
        for b in entry["blocks"]:
            self._lora_alloc.decref(int(b))
        entry["blocks"] = None
        self.adapter_evictions += 1

    def _ensure_adapter_resident(self, adapter_id: str) -> dict:
        """The adapter's registry entry with its blocks resident: on a
        miss, take the payload from the host copy or the fleet bucket,
        evict cold (unreferenced) adapters least recently used first until
        ``n_layers`` blocks are free, and load the payload into them. The load writes the one
        pool tensor in place (``index_copy_``), so the K-step graphs that
        captured its address read it. Any failure raises rather than
        decode under missing or foreign weights."""
        entry = self._adapters[adapter_id]
        entry["last_use"] = time.monotonic()
        if entry["blocks"] is not None:
            return entry
        n_layers = self.cfg.n_layers
        payload = entry["payload"]
        if payload is None:
            data = (self._fleet.fetch_adapter(entry["hash"])
                    if self._fleet is not None
                    and hasattr(self._fleet, "fetch_adapter") else None)
            if data is None:
                raise RuntimeError(
                    f"adapter {adapter_id!r} evicted and its payload "
                    f"({entry['hash']}) unavailable in the fleet bucket "
                    "— refusing to decode under missing weights")
            payload, _scale = split_adapter_payload(data)
            if payload.shape != (n_layers, 2, self.scfg.lora_rank,
                                 self.cfg.d_model):
                raise RuntimeError(
                    f"adapter {adapter_id!r} payload has foreign "
                    f"geometry {payload.shape}")
        while self._lora_alloc.available < n_layers:
            cold = [(aid, e) for aid, e in self._adapters.items()
                    if e["blocks"] is not None and not e["refs"]]
            if not cold:
                raise RuntimeError(
                    "adapter pool exhausted with every resident adapter "
                    "in use — raise n_adapter_blocks")
            self._evict_adapter(
                min(cold, key=lambda kv: kv[1]["last_use"])[0])
        blocks = self._lora_alloc.alloc(n_layers)
        self._lora_pool.index_copy_(
            0, torch.as_tensor(blocks, dtype=torch.int64, device=self.device),
            torch.as_tensor(payload).to(device=self.device,
                                        dtype=self._lora_pool.dtype))
        entry["blocks"] = [int(b) for b in blocks]
        self.adapter_loads += 1
        return entry

    def _bind_adapter(self, slot: int, req: Request) -> None:
        """Point the slot's table row at its adapter's blocks and pin the
        adapter against eviction while the slot holds the request. An
        adapter-less request keeps the row a release left: the scratch
        block at scale 0."""
        if req.adapter_id is None:
            return
        entry = self._ensure_adapter_resident(req.adapter_id)
        entry["refs"] += 1
        self._slot_lora_blocks[slot] = np.asarray(entry["blocks"], np.int32)
        self._slot_lora_scale[slot] = entry["scale"]

    # -- observability hooks (every one returns at once when obs is None) ------

    def _obs_queue(self, req: Request, requeued: bool = False) -> None:
        """Open the queue-phase span (a submit, a resume import, or a
        recompute preemption sending the request back to the head)."""
        if self.obs is None:
            return
        if req.trace is None:
            # No upstream context: one minted trace keeps the request's
            # three phases together.
            req.trace = TraceContext.mint()
        self._phase_spans[req.rid] = self.obs.tracer.start(
            "engine.queue", parent=req.trace, rid=req.rid,
            requeued=requeued)

    def _obs_admit(self, req: Request, cached_tokens: int = 0) -> None:
        if self.obs is None:
            return
        span = self._phase_spans.pop(req.rid, None)
        if span is not None:
            self.obs.tracer.end(span)
        prefill = self.obs.tracer.start(
            "engine.prefill", parent=req.trace, rid=req.rid,
            prompt_tokens=len(req.prompt) + len(req.tokens),
            cached_tokens=cached_tokens)
        # The span's `chunks` is this request's chunk count: a delta.
        prefill._chunk_base = self.prefill_chunks
        self._phase_spans[req.rid] = prefill

    def _obs_first_token(self, req: Request) -> None:
        """Called where ``first_token_t`` is stamped: close the prefill
        span (its duration is the engine-side TTFT) and open the decode
        span at the first token index this engine emitted
        (``token_start``; a resumed import starts past its prefix)."""
        if self.obs is None:
            return
        self._h_ttft.observe(req.first_token_t - req.submit_t)
        span = self._phase_spans.pop(req.rid, None)
        if span is not None:
            self.obs.tracer.end(
                span, chunks=self.prefill_chunks
                - getattr(span, "_chunk_base", self.prefill_chunks))
        self._phase_spans[req.rid] = self.obs.tracer.start(
            "engine.decode", parent=req.trace, rid=req.rid,
            token_start=len(req.tokens) - 1)

    def _obs_interrupt(self, req: Request, status: str) -> None:
        """A request leaving its slot unfinished (preemption, drain
        export): close its open phase span with ``status`` and the token
        range it covered."""
        if self.obs is None:
            return
        span = self._phase_spans.pop(req.rid, None)
        if span is not None:
            self.obs.tracer.end(span, status=status,
                                token_end=len(req.tokens))

    def _obs_retire(self, req: Request) -> None:
        if self.obs is None:
            return
        span = self._phase_spans.pop(req.rid, None)
        if span is not None:
            self.obs.tracer.end(span, token_end=len(req.tokens))
        self._h_e2e.observe(req.finish_t - req.submit_t)
        emitted = len(req.tokens) - req.resume_from
        if emitted > 1 and req.first_token_t is not None:
            self._h_intertok.observe(
                (req.finish_t - req.first_token_t) / (emitted - 1))

    # -- scheduling ------------------------------------------------------------

    def _prefilling(self, slot: int) -> bool:
        return self._gen_ok(self._slots[slot]) and \
            int(self._positions[slot]) < int(self._prefill_target[slot])

    def _prefilling_planned(self, slot: int) -> bool:
        """Prefilling as of the last dispatch (overlap mode): the program
        that completes the prompt may still be in flight, but no prefill
        work is left to plan."""
        return self._slots[slot] is not None and \
            int(self._planned_pos[slot]) < int(self._prefill_target[slot])

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

    def _next_admit_index(self) -> int:
        """The queue index to admit next (class-then-EDF): higher
        protection class first, then earliest deadline, deadline-less
        requests after every deadlined one of their class, FIFO among
        equals. Class outranks the deadline so that cheap best_effort work
        with the same deadline cannot win by arrival. With no SLA field in
        the queue every key ties and the pick is index 0, FIFO; a request
        preempted back to the head keeps winning ties there."""
        return min(range(len(self._queue)),
                   key=lambda i: (
                       -class_rank(getattr(
                           self._queue[i], "slo_class", DEFAULT_CLASS)),
                       self._queue[i].deadline is None,
                       self._queue[i].deadline or 0.0, i))

    def _admit(self, admitted: list, finished: list) -> None:
        if self.scfg.prefill == "chunked":
            self._admit_chunked(admitted)
        else:
            self._admit_bucketed(admitted, finished)

    def _admit_chunked(self, admitted: list) -> None:
        """Assign free slots and blocks to queued requests in
        :meth:`_next_admit_index` order; prompt ingestion (a resumed
        request's prompt and imported tokens) happens across the following
        steps' chunk rows. At most ``prefill_slots`` slots prefill at a
        time. While an overlapped carry is live the gate reads PLANNED
        positions: a completing chunk already dispatched counts as done,
        though its sweep lands a step later."""
        bs = self.scfg.block_size
        prefilling = (self._prefilling if self._carry is None
                      else self._prefilling_planned)
        while self._queue:
            if sum(prefilling(i) for i in range(self.scfg.slots)) \
                    >= self.scfg.prefill_slots:
                return
            slot = next(
                (i for i, r in enumerate(self._slots) if r is None), None)
            if slot is None:
                return
            pick = self._next_admit_index()
            req = self._queue[pick]
            ctx = self._context_ids(req)
            plen = len(ctx)
            # An adapter-bearing request neither reads nor (at release)
            # seeds the prefix cache or the fleet: its KV depends on the
            # adapter from layer 1 on.
            shared = req.adapter_id is None
            cached = (self._pcache.lookup(ctx)              # increfs
                      if self._pcache is not None and shared else [])
            if (self._fleet is not None or self._host_tier is not None) \
                    and shared:
                # The blocks the local cache missed may sit in host RAM
                # or in the fleet: import them by content hash instead of
                # prefilling them (each lands in the local cache too).
                cached += self._fleet_import(ctx, len(cached))
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
            del self._queue[pick]
            table = np.zeros((self.scfg.max_blocks_per_slot,), np.int32)
            table[:len(cached)] = cached
            if need:
                table[len(cached):len(cached) + need] = got[:need]
            if cow:
                src = int(table[cached_len // bs])
                dst = got[need]
                copy_block(self.pools, src, dst, mesh=self.mesh)
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
            self._draft_pos[slot] = 0
            self._bind_adapter(slot, req)
            if self._overlap:
                # The slot's planned state restarts with its new occupant:
                # an unswept program dispatched for the previous one runs
                # this row dead and its sweep skips it.
                self._planned_pos[slot] = cached_len
                self._planned_emitted[slot] = len(req.tokens)
            admitted.append(req.rid)
            self._obs_admit(req, cached_tokens=cached_len)

    def _admit_bucketed(self, admitted: list, finished: list) -> None:
        """Admit in :meth:`_next_admit_index` order while a slot and blocks
        are free: the whole context (prompt plus any resumed tokens)
        through one program padded to its bucket, under the request's
        generation's weights, and the first token sampled at once."""
        while self._queue:
            slot = next(
                (i for i, r in enumerate(self._slots) if r is None), None)
            if slot is None:
                return
            pick = self._next_admit_index()
            req = self._queue[pick]
            ctx = self._context_ids(req)
            need = self.scfg.blocks_for(len(ctx))
            # One spare lets the running set cross its next block boundary
            # without an instant preemption; an idle engine admits with
            # none (a solo request fits the pool its submit checked).
            blocks = self._reserve(need, 1 if self.n_active else 0)
            if blocks is None:
                return
            del self._queue[pick]
            self._obs_admit(req)
            bucket = self.scfg.bucket_for(len(ctx))
            table = np.zeros((self.scfg.max_blocks_per_slot,), np.int32)
            table[:need] = blocks
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :len(ctx)] = ctx
            self._bind_adapter(slot, req)
            dev = self.device
            t0 = time.perf_counter()
            with torch.no_grad():
                out = paged_prefill(
                    self._model_params(self._lora_rows([slot]),
                                       gen=req.generation),
                    self.cfg, torch.as_tensor(padded, device=dev,
                                              dtype=torch.int64),
                    len(ctx), torch.as_tensor(table, device=dev),
                    self.pools, measure_qerr=self.debug, mesh=self.mesh)
            if self._quantized:
                out, qerr = out
                self._note_qerr(qerr)
                self.quantized_block_writes += need
            self.goodput.program(time.perf_counter() - t0)
            self.goodput.work_span(len(ctx))
            self.goodput.emitted(1)
            self.prefills += 1
            first = self._sample_one(req, out)
            req.status = RUNNING
            req.tokens.append(first)
            if req.first_token_t is None:
                req.first_token_t = time.monotonic()
                self._obs_first_token(req)
            self._slots[slot] = req
            self._admit_counter += 1
            self._admit_seq[slot] = self._admit_counter
            self._slot_keys[slot] = req.key
            self._tables[slot] = table
            self._positions[slot] = len(ctx)
            self._prefill_target[slot] = len(ctx)
            self._last_token[slot] = first
            self._draft_pos[slot] = 0
            admitted.append(req.rid)
            if req.finished:
                self._retire(slot)
                finished.append(req.rid)

    def _sample_one(self, req: Request, logits: torch.Tensor) -> int:
        """A bucketed admission's first token: the sampler at
        ``fold_in(key, len(tokens))``, the draw every path makes for the
        token at that index; timed as a dispatch of its own, as the JAX
        engine's prefill sampler is."""
        dev = self.device
        t0 = time.perf_counter()
        with torch.no_grad():
            keys = jrandom.fold_in(
                jrandom.as_key(req.key[None], dev),
                torch.tensor([len(req.tokens)], device=dev))
            tok = int(sample_tokens(
                logits, torch.tensor([req.temperature], device=dev),
                torch.tensor([req.top_p], device=dev), keys)[0])
        self.goodput.program(time.perf_counter() - t0)
        return tok

    def _ensure_blocks(self, widths: Optional[np.ndarray] = None) -> None:
        """Every active slot gets blocks covering its next ``widths[i]``
        writes (default 1) — evicting refcount-0 cached blocks first, then
        preempting the least-protected, most-slack, youngest running
        request (requeued at the head, recompute) when the pool is truly
        dry."""
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
                    victim = self._victim()
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

    def _victim(self) -> int:
        """The running slot to preempt: lowest protection class first, then
        most slack (no deadline = infinite), then the youngest admission.
        All-default requests tie on the first two terms, so the pick is
        the youngest slot."""
        return max(
            (i for i, r in enumerate(self._slots) if r is not None),
            key=lambda i: (
                -class_rank(self._slots[i].slo_class),
                float("inf") if self._slots[i].deadline is None
                else self._slots[i].deadline,
                self._admit_seq[i]))

    def _preempt(self, slot: int) -> None:
        req = self._slots[slot]
        req.preemptions += 1
        self.preemption_count += 1
        req.status = QUEUED
        self._obs_interrupt(req, "preempted")
        # The rolled-back tokens were emitted work the recompute repeats.
        self.goodput.wasted_preempt(len(req.tokens) - req.resume_from)
        # Release BEFORE rolling back: _release registers full blocks under
        # the ids that produced their KV (prompt + tokens so far). A
        # resumed request rolls back only to its imported prefix.
        self._release(slot)
        del req.tokens[req.resume_from:]
        req.first_token_t = None
        self._queue.appendleft(req)
        self._obs_queue(req, requeued=True)

    # -- fused steps -----------------------------------------------------------

    def _all_greedy(self) -> bool:
        return all(not self._gen_ok(r) or r.temperature == 0
                   for r in self._slots)

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
        val = np.asarray(valid, bool).reshape(-1)
        # An invalid token may sit past its table (a micro-step's iteration
        # beyond a slot's span at max_len): only valid ones are looked up.
        pos = np.where(val, np.asarray(positions, np.int64).reshape(-1), 0)
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
             keys=None, ngen=None, owners=None) -> np.ndarray:
        """Dispatch one fused step (greedy program when every slot is
        greedy, else the keyed sampler) and read its tokens back; the
        goodput meter times it from its inputs' upload through the
        readback. ``positions`` are 0 at inactive rows; ``owners[i]`` is
        the slot whose adapter row i runs (:meth:`_lora_rows`)."""
        dev = self.device

        def put(a, dtype):
            return torch.as_tensor(a, device=dev, dtype=dtype)

        layout = (self._quant_layout(tables, positions[:, None],
                                     active[:, None])
                  if self._quantized else None)
        t0 = time.perf_counter()
        qa = (tuple(put(a, torch.int64) for a in layout)
              if self._quantized else None)
        lora = None if owners is None else self._lora_rows(owners)
        args = (self._model_params(lora), self.cfg,
                put(tokens, torch.int64), put(positions, torch.int32),
                put(tables, torch.int32), put(active, torch.bool))
        kwargs = dict(attn_impl=self.decode_impl, measure_qerr=self.debug,
                      mesh=self.mesh)
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
        active = np.array([self._gen_ok(r) for r in self._slots])
        if not active.any():
            return
        positions = np.where(active, self._positions, 0)
        temps, tops = self._temps_tops()
        ngen = np.array([len(r.tokens) if r else 0 for r in self._slots],
                        np.int64)
        toks = self._run(self._last_token, positions, self._tables, active,
                         temps, tops, self._slot_keys, ngen,
                         owners=np.where(active, np.arange(len(active)), -1))
        self.decode_steps += 1
        # positions is 0 at inactive rows, so its sum is the active rows'.
        n_act = int(active.sum())
        self.goodput.work_counts(n_act, float(positions.sum()))
        self.goodput.emitted(n_act)
        now = time.monotonic()
        for slot, req in enumerate(self._slots):
            if not self._gen_ok(req):
                continue
            tok = int(toks[slot])
            req.tokens.append(tok)
            if req.first_token_t is None:
                req.first_token_t = now
                self._obs_first_token(req)
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
        predecessors. With spec on, decode rows are HELD (width 0): the
        spec round of the same scheduler step advances them."""
        n, W = self.scfg.slots, self.scfg.chunk_tokens
        order = sorted(range(n), key=lambda j: self._admit_seq[j])

        def chunk_widths() -> np.ndarray:
            w = np.zeros((n,), np.int32)
            budget = W
            for i in order:
                if not self._gen_ok(self._slots[i]):
                    continue
                pos, target = int(self._positions[i]), \
                    int(self._prefill_target[i])
                if pos < target:
                    w[i] = min(budget, target - pos)
                    budget -= w[i]
                elif not self._spec_on:
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
        owners = np.full((R,), -1, np.int64)   # the slot of each row
        tables[:n] = self._tables
        temps[:n], tops[:n] = self._temps_tops()
        for i, req in enumerate(self._slots):
            if req is None or not widths[i] or i in pres:
                continue
            tokens[i] = self._last_token[i]
            positions[i] = self._positions[i]
            active[i] = True
            owners[i] = i
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
            owners[sl] = i
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
                         keys, ngen, owners=owners)
        self.chunk_steps += 1
        self.goodput.work_counts(int(active.sum()), float(pos_masked.sum()))
        now = time.monotonic()
        for i, req in enumerate(self._slots):
            if req is None or not widths[i]:          # empty or spec-held
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
                self._obs_first_token(req)
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
            if self._gen_ok(req):
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
        _, eos = self._req_limits_eos()
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
        lora = self._lora_rows(np.where(active, np.arange(len(active)), -1))
        if lora is not None:
            inputs.update(lblocks=lora[0], lscales=lora[1])
        t0 = time.perf_counter()
        toks, qerr = self._micro_runner().run(       # (K, slots)
            sampled, inputs, lora=lora is not None)
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
                    self._obs_first_token(req)
                if req.finished:
                    break
            if req.finished:
                self._retire(slot)
                finished.append(req.rid)
        # One dispatch did emitted_total tokens of work: the charge is per
        # valid token, so the FLOP model is the same at any K.
        self.goodput.work_counts(emitted_total, pos_sum)
        self.goodput.emitted(emitted_total)

    # -- speculative decoding --------------------------------------------------

    def _spec_step(self, finished: list) -> None:
        """One speculative round: the draft proposes up to ``spec_k``
        tokens per slot (greedy — its proposal distribution is a point
        mass, so rejection sampling reduces to accept-with-prob-p(d)), ONE
        fused target step scores all k+1 positions of every slot, and the
        host commits the accepted prefix plus one bonus or replacement
        token in place."""
        n, k = self.scfg.slots, self.scfg.spec_k
        if not self.spec_enabled:
            k = 0                         # brownout: score, propose nothing
        bs = self.scfg.block_size

        def live(i: int) -> bool:
            # Mid-prompt slots advance through the chunk step, never here;
            # mid-roll, another generation's slots wait for their turn.
            return self._gen_ok(self._slots[i]) and not self._prefilling(i)

        def eff() -> np.ndarray:
            ke = np.zeros((n,), np.int32)
            for i, req in enumerate(self._slots):
                if not live(i):
                    continue
                remaining = req.max_new_tokens - len(req.tokens)
                # Emitting ke + 1 tokens must stay within remaining, and the
                # last scored position inside the slot's table.
                cap = self.scfg.max_blocks_per_slot * bs - 1 \
                    - int(self._positions[i])
                ke[i] = max(0, min(k, remaining - 1, cap))
            return ke

        want = eff()
        self._ensure_blocks(np.asarray(
            [want[i] + 1 if live(i) else 0 for i in range(n)], np.int32))
        if not any(live(i) for i in range(n)):
            return
        k_eff = eff()                     # preemption may have freed slots
        # Even an all-zero k_eff round scores through the spec program, so
        # a sampled request's tokens always ride the position-keyed spec
        # streams, never a mix with the plain sampler's.
        if self.spec_enabled:
            self._draft_catchup()
            proposals = self._draft_propose(k_eff)
        else:
            # No draft passes at all: the catch-up heals on re-enable.
            proposals = np.zeros((n, 1), np.int32)
        tokens = np.zeros((n, k + 1), np.int32)
        positions = np.zeros((n, k + 1), np.int32)
        valid = np.zeros((n, k + 1), bool)
        for i in range(n):
            if not live(i):
                continue
            ke, pos = int(k_eff[i]), int(self._positions[i])
            tokens[i, 0] = self._last_token[i]
            tokens[i, 1:ke + 1] = proposals[i, :ke]
            positions[i, :ke + 1] = np.arange(pos, pos + ke + 1)
            valid[i, :ke + 1] = True
        layout = (self._quant_layout(self._tables, positions, valid)
                  if self._quantized else None)
        dev = self.device

        def put(a, dtype):
            return torch.as_tensor(a, device=dev, dtype=dtype)

        t0 = time.perf_counter()
        # The target scores under the dispatched generation's weights and
        # the live slots' adapters; the draft keeps its own weights and
        # runs no adapter, as in the JAX engine.
        lora = self._lora_rows([i if live(i) else -1 for i in range(n)])
        args = (self._model_params(lora), self.cfg, put(tokens, torch.int64),
                put(positions, torch.int32), put(valid, torch.bool),
                put(self._tables, torch.int32))
        qa = (tuple(put(a, torch.int64) for a in layout)
              if self._quantized else None)
        kwargs = dict(attn_impl=self.decode_impl, measure_qerr=self.debug,
                      mesh=self.mesh)
        sampled = not self._all_greedy()
        if sampled:
            temps, tops = self._temps_tops()
            out = spec_score_probs(*args, put(temps, torch.float32),
                                   put(tops, torch.float32), self.pools, qa,
                                   **kwargs)
        else:
            out = spec_score_greedy(*args, self.pools, qa, **kwargs)
        if self._quantized:
            out, qerr = out
            self._note_qerr(qerr)
        scored = out.cpu().numpy()
        self.goodput.program(time.perf_counter() - t0)
        if sampled:
            probs = scored
            t0 = time.perf_counter()
            uniforms = spec_uniforms(
                jrandom.as_key(self._slot_keys, dev),
                put(positions, torch.int64)).cpu().numpy()
            self.goodput.program(time.perf_counter() - t0)
        self.spec_rounds += 1
        # positions is 0 outside the valid mask, so its plain sum is the
        # valid entries' position sum.
        self.goodput.work_counts(int(valid.sum()), float(positions.sum()))
        now = time.monotonic()
        for i, req in enumerate(self._slots):
            if not live(i):
                continue
            ke, pos = int(k_eff[i]), int(self._positions[i])
            if not sampled or req.temperature == 0:
                row = probs[i].argmax(-1) if sampled else scored[i]
                a = 0
                while a < ke and proposals[i, a] == row[a]:
                    a += 1
                emitted = [int(t) for t in row[:a + 1]]
            else:
                emitted = self._spec_accept_sampled(
                    probs[i], proposals[i], ke, uniforms[i])
                a = len(emitted) - 1
            self.spec_proposed += ke
            self.spec_accepted += a
            # eos / max_new truncation: both mean the slot retires now.
            lim = req.max_new_tokens - len(req.tokens)
            emitted = emitted[:lim]
            if req.eos_token is not None and req.eos_token in emitted:
                emitted = emitted[:emitted.index(req.eos_token) + 1]
            m = len(emitted)
            req.tokens.extend(emitted)
            self.goodput.emitted(m)
            self.goodput.wasted_spec(ke - a)
            if req.first_token_t is None:
                req.first_token_t = now
                self._obs_first_token(req)
            self._positions[i] = pos + m
            self._last_token[i] = emitted[-1]
            # Draft KV is valid through pos + min(m, ke) - 1: a full accept
            # leaves the draft one token behind (it never fed its own last
            # proposal), which the next round's catch-up feeds.
            self._draft_pos[i] = pos + min(m, ke)
            if req.finished:
                self._retire(i)
                finished.append(req.rid)

    @staticmethod
    def _inv_cdf(p: np.ndarray, u: float) -> int:
        c = np.cumsum(p, dtype=np.float64)
        total = c[-1] if c[-1] > 0 else 1.0
        return int(min(np.searchsorted(c / total, u, side="right"),
                       len(p) - 1))

    def _spec_accept_sampled(self, probs: np.ndarray, proposals: np.ndarray,
                             ke: int, uniforms: np.ndarray) -> List[int]:
        """Rejection sampling against the target distribution ``probs[j]``
        (already tempered and top-p filtered on the device). The greedy
        draft's proposal is a point mass, so proposal ``d`` is accepted
        with probability p(d), and a rejection samples the residual (p
        without d, renormalized): the stream is distribution-exact against
        non-speculative sampling. ``uniforms[j]`` is the (accept coin,
        inverse-CDF draw) pair keyed by (request, absolute position), so a
        preempted and replayed request makes the same decisions under any
        schedule. Host-side numpy in float64, as in JAX."""
        emitted: List[int] = []
        for j in range(ke):
            d = int(proposals[j])
            u_accept, u_res = uniforms[j]
            if u_accept < probs[j, d]:
                emitted.append(d)
                continue
            residual = probs[j].astype(np.float64).copy()
            residual[d] = 0.0
            if residual.sum() <= 0:
                emitted.append(int(probs[j].argmax()))
            else:
                emitted.append(self._inv_cdf(residual, u_res))
            return emitted
        u_bonus = uniforms[ke, 0]
        emitted.append(self._inv_cdf(probs[ke].astype(np.float64), u_bonus))
        return emitted

    def _draft_catchup(self) -> None:
        """Feed the draft cache every context token it has not seen —
        prompt ingestion (``chunk_tokens`` per slot per call) and the one
        or two tokens a committed round leaves behind. Each call is timed
        through a readback of its tokens, which the round does not use."""
        n, W = self.scfg.slots, self.scfg.chunk_tokens
        while True:
            need = [i for i in range(n) if self._slots[i] is not None
                    and int(self._draft_pos[i]) < int(self._positions[i])]
            if not need:
                return
            tokens = np.zeros((n, W), np.int32)
            positions = np.zeros((n, W), np.int32)
            valid = np.zeros((n, W), bool)
            last_idx = np.zeros((n,), np.int32)
            for i in need:
                dp = int(self._draft_pos[i])
                c = min(W, int(self._positions[i]) - dp)
                ctx = self._context_ids(self._slots[i])
                tokens[i, :c] = ctx[dp:dp + c]
                positions[i, :c] = np.arange(dp, dp + c)
                valid[i, :c] = True
                last_idx[i] = c - 1
                self._draft_pos[i] = dp + c
            dev = self.device
            t0 = time.perf_counter()
            chunked_step_greedy(
                self.draft_params, self.draft_cfg,
                torch.as_tensor(tokens, device=dev, dtype=torch.int64),
                torch.as_tensor(positions, device=dev),
                torch.as_tensor(valid, device=dev),
                torch.as_tensor(last_idx, device=dev), self._draft_tables,
                self._draft_pools, attn_impl=self.draft_decode_impl,
                mesh=self.mesh).cpu()
            self.goodput.program(time.perf_counter() - t0)

    def _draft_propose(self, k_eff: np.ndarray) -> np.ndarray:
        """Greedy draft proposals: up to ``k_eff[i]`` sequential tokens per
        slot through the batched draft decode step (rows past their own
        ``k_eff`` go inactive and write only the scratch block)."""
        n, kmax = self.scfg.slots, int(k_eff.max())
        cur = self._last_token.copy()
        dpos = self._positions.copy()
        out = np.zeros((n, max(kmax, 1)), np.int32)
        dev = self.device
        for j in range(kmax):
            act = np.array([self._slots[i] is not None and k_eff[i] > j
                            for i in range(n)])
            t0 = time.perf_counter()
            toks = greedy_decode_step(
                self.draft_params, self.draft_cfg,
                torch.as_tensor(cur, device=dev, dtype=torch.int64),
                torch.as_tensor(np.where(act, dpos, 0), device=dev,
                                dtype=torch.int32),
                self._draft_tables, torch.as_tensor(act, device=dev),
                self._draft_pools, attn_impl=self.draft_decode_impl,
                mesh=self.mesh).cpu().numpy()
            self.goodput.program(time.perf_counter() - t0)
            out[act, j] = toks[act]
            cur[act] = toks[act]
            dpos[act] += 1
        return out

    # -- release / retire ------------------------------------------------------

    def _release(self, slot: int) -> None:
        """Free the slot's blocks and clear its row. With the prefix cache
        on, every FULL block of valid KV is first offered to the cache, so
        the decref leaves shareable blocks cached instead of free."""
        req = self._slots[slot]
        live = self._tables[slot][self._tables[slot] != SCRATCH_BLOCK]
        if req is not None and req.adapter_id is not None:
            self._adapters[req.adapter_id]["refs"] -= 1    # unpin it
        self._slot_lora_blocks[slot] = 0
        self._slot_lora_scale[slot] = 0.0
        # An adapter's KV never enters the prefix cache.
        if self._pcache is not None and req is not None \
                and req.adapter_id is None:
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
        self._draft_pos[slot] = 0
        self._slots[slot] = None

    def _retire(self, slot: int) -> None:
        req = self._slots[slot]
        req.status = DONE
        req.finish_t = time.monotonic()
        self._release(slot)
        self._gen_release(req)
        self._obs_retire(req)

    # -- fleet KV --------------------------------------------------------------

    def _fleet_import(self, ctx: np.ndarray, have: int) -> List[int]:
        """Import the consecutive full-block tail of ``ctx`` that the local
        prefix cache missed (``have`` = local hit depth in blocks) from the
        tiers below the device pool: host RAM first, then the fleet KV
        plane. Any failure (a tier or index hole, a missing or torn
        object, pool pressure) stops the import, and the rest of the tail
        prefills locally. Returns the imported blocks in chain order, each
        at the admitting slot's reference. ``fleet_hit_blocks`` counts the
        imports of either rung; ``promoted_blocks`` those from host RAM."""
        want = chain_block_hashes(ctx, self.scfg.block_size)[have:]
        if not want:
            return []
        t0 = time.perf_counter()
        imported = self._import_hash_chain(want)
        self.fleet_hit_blocks += len(imported)
        self.fleet_miss_blocks += len(want) - len(imported)
        if imported:
            self.fleet_import_requests += 1
            if self._h_kv_import is not None:
                self._h_kv_import.observe(time.perf_counter() - t0)
        return imported

    def _import_hash_chain(self, want: List[bytes]) -> List[int]:
        """Resolve ``want`` (consecutive chained hashes) down the
        hierarchy: the leading run resident in host RAM first, then the
        run the fleet index advertises for the rest of the chain. The
        payloads go to the device through one pinned buffer and into
        freshly allocated blocks, in place, with one index write per pool
        leaf (:func:`~tpu_task_torch.ml.serving.cache.
        write_block_payloads`), and each block is adopted under its hash.
        Returns the imported blocks (each at allocation refcount 1 and
        cache-retained). Chains clamp to ``max_blocks_per_slot``, as in
        the JAX engine."""
        want = want[:self.scfg.max_blocks_per_slot]
        if not want:
            return []
        nbytes = block_payload_nbytes(self.cfg, self.scfg)
        payloads: List[Tuple[bytes, bytes]] = []
        if self._host_tier is not None:
            # Promotion: the consecutive leading run whose bytes are in
            # host RAM. A miss mid-chain falls through to the fleet below,
            # so the chain stays consecutive either way.
            for h in want:
                data = self._host_tier.get(h)
                if data is None or len(data) != nbytes:
                    break         # miss or foreign payload → next rung
                payloads.append((h, data))
        n_promoted = len(payloads)
        rest = want[n_promoted:]
        if self._fleet is not None and rest:
            try:
                n_hit = self._fleet.lookup_chain(rest)
            except OSError:
                n_hit = 0
            for h in rest[:n_hit]:
                data = self._fleet.fetch(h)
                if data is None:
                    break         # stale index entry → local prefill
                if len(data) != nbytes:
                    break         # foreign or torn payload → local prefill
                payloads.append((h, data))
        imported: List[int] = []
        for _ in payloads:
            got = self._reserve(1, 0)
            if got is None:
                break             # pool pressure → prefill what is left
            imported.append(got[0])
        payloads = payloads[:len(imported)]
        if imported:
            t0 = time.perf_counter()
            write_block_payloads(self.pools, imported,
                                 [data for _, data in payloads])
            self.goodput.program(time.perf_counter() - t0)
            for (h, _), block in zip(payloads, imported):
                self._pcache.adopt(h, block)
        self.promoted_blocks += min(n_promoted, len(imported))
        return imported

    def prefetch_chain(self, hashes: List[bytes]) -> int:
        """Import a chain into the LOCAL prefix cache before any request
        needs it (a router's next-turn hint), from host RAM or from the
        fleet bucket, as an admission would. Leading hashes already cached
        are skipped; imported blocks stay cached at refcount 0, evictable
        like any other. Best effort: every failure gives a shorter
        (possibly empty) prefetch. Returns the blocks imported."""
        if (self._fleet is None and self._host_tier is None) \
                or self._pcache is None or not hashes:
            return 0
        have = 0
        for h in hashes:
            if not self._pcache.has(h):
                break
            have += 1
        imported = self._import_hash_chain(list(hashes[have:]))
        for block in imported:
            # adopt() retained it: dropping the allocation's reference
            # leaves it cached at refcount 0.
            self.allocator.decref(block)
        self.fleet_prefetch_blocks += len(imported)
        return len(imported)

    # tier: begin-migrate
    # The demote STAGING half: nothing between this marker and its end may
    # wait for the device (the dispatch region's rules). It runs with a
    # program in flight; the bytes are forced at the next consume edge
    # (_finalize_demotions), where the host waits anyway.
    # tests/test_torch_overlap_lint.py walks the region and enforces it.

    def _demote_pass(self, limit: int = 8) -> None:
        """The non-blocking half of demotion: up to ``limit`` of the prefix
        cache's coldest retained refcount-0 blocks (eviction's next
        victims; an idle session's blocks join them when its request
        releases) are staged toward the host tier in one
        :class:`~tpu_task_torch.ml.serving.cache.BlockStaging`, enqueued
        behind the program in flight. A block whose bytes are ALREADY in
        host RAM skips the copy and is marked demoted at once."""
        if self._host_tier is None or self._pcache is None:
            return
        budget = limit - len(self._pending_demotions)
        if budget <= 0:
            return
        stage: List[Tuple[bytes, int]] = []
        for h, block in self._pcache.cold_entries(budget):
            if h in self._host_tier:
                self.allocator.mark_demoted(block)
                self.demoted_blocks += 1
                continue
            stage.append((h, block))
        if stage:
            staging = BlockStaging(self.pools, [b for _, b in stage])
            self._pending_demotions += [
                (h, block, staging, row)
                for row, (h, block) in enumerate(stage)]

    # tier: end-migrate

    def _finalize_demotions(self) -> None:
        """The blocking half of demotion: force the staged bytes (a wait on
        each staging's event alone), hand each block's payload to the host
        tier (which spills its LRU tail past the budget into the fleet
        bucket) and mark the device copy demoted, eviction's first victim
        now that its bytes survive reclaim. A block that was resurrected
        (incref'd) or evicted and recycled since its staging is skipped:
        the ``cached_block`` identity check makes a wrong mark impossible,
        as content addressing makes a wrong payload impossible."""
        if not self._pending_demotions:
            return
        pending, self._pending_demotions = self._pending_demotions, []
        for h, block, staging, row in pending:
            if self._pcache.cached_block(h) != block \
                    or self.allocator.refcount(block) != 0:
                continue          # resurrected or recycled mid-flight
            self._host_tier.put(h, staging.payload(row))
            self.allocator.mark_demoted(block)
            self.demoted_blocks += 1

    def stage_cached_blocks(self, limit: int = 16,
                            skip=()) -> List[Tuple[str, List[torch.Tensor]]]:
        """The non-blocking half of a publish: up to ``limit`` hot
        refcount-0 cached blocks, hottest first and not in ``skip``, as
        (hash hex, device copies of the block). Such blocks are frozen, so
        the copies hold exact bytes; read them back with
        ``cache.staged_block_to_bytes``."""
        if self._pcache is None:
            return []
        out: List[Tuple[str, List[torch.Tensor]]] = []
        for h, block in self._pcache.hot_entries():
            if len(out) >= limit:
                break
            hash_hex = h.hex()
            if hash_hex in skip:
                continue
            out.append((hash_hex, stage_block_arrays(self.pools, block)))
        return out

    def export_cached_blocks(self, limit: int = 16,
                             skip=()) -> List[Tuple[str, bytes]]:
        """:meth:`stage_cached_blocks` read back: (hash hex, payload)."""
        return [(hash_hex, staged_block_to_bytes(staged))
                for hash_hex, staged in self.stage_cached_blocks(
                    limit=limit, skip=skip)]

    def stats(self) -> dict:
        """Scheduler counters, the KV cost model, and the process-wide
        paged-attention launch counts (both kernels and the plain
        version). Every key of the JAX engine's ``stats()`` is here, the
        mesh's widths and the per-rank pool bytes computed as it computes
        them."""
        n_blocks, high = self.scfg.n_blocks, self.allocator.high_water
        out = {
            "decode_impl": self.decode_impl,
            # The draft's paged attention: the target's, or None (spec off).
            "draft_decode_impl": self.draft_decode_impl,
            "device": str(self.device),
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            # The configured K and the K-wide micro dispatches that ran.
            "micro_k": self.scfg.micro_k,
            "micro_steps": self.micro_steps,
            # Graph captures and replays of the K-step programs (CUDA).
            "step_graph": self._graph_stats(),
            "chunk_steps": self.chunk_steps,
            # The asynchronous loop, and the times pool pressure flushed it
            # to the synchronous edge.
            "overlap": self._overlap,
            "prefill_slots": self.scfg.prefill_slots,
            "overlap_flushes": self.overlap_flushes,
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "recompute_preemptions": self.preemption_count,
            "tp": self.tp,
            "ep": self.ep,
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
            "kv_blocks_high_water": high,
            "kv_high_water_bytes": paged_cache_bytes(self.cfg, self.scfg,
                                                     high),
            "kv_pool_bytes": paged_cache_bytes(self.cfg, self.scfg,
                                               n_blocks),
            "kv_pool_bytes_per_shard": kv_shard_bytes(self.cfg, self.scfg,
                                                      n_blocks, self.tp),
            "kv_dense_worst_case_bytes": dense_cache_bytes(
                self.cfg, self.scfg.slots, self.scfg.max_len),
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
            # Device pool → host RAM → bucket: blocks copied down to the
            # host tier, blocks imported back from it (the fleet counters
            # below count both rungs), and the tier's own view, its spill
            # into the bucket included.
            "tiering": {
                "enabled": self._host_tier is not None,
                "host_offload_blocks": self.scfg.host_offload_blocks,
                "demoted_blocks": self.demoted_blocks,
                "promoted_blocks": self.promoted_blocks,
                "demoted_resident": self.allocator.demoted,
                "pending_demotions": len(self._pending_demotions),
                **({f"host_{k}": v
                    for k, v in self._host_tier.stats().items()}
                   if self._host_tier is not None else {}),
            },
            "kvfleet": {
                "enabled": self._fleet is not None,
                # Admission imports: blocks taken from (or missed in) the
                # fleet plane instead of a local prefill.
                "hit_blocks": self.fleet_hit_blocks,
                "miss_blocks": self.fleet_miss_blocks,
                "import_requests": self.fleet_import_requests,
                "prefetch_blocks": self.fleet_prefetch_blocks,
                # Publisher side, owned by the client.
                "published_blocks": getattr(
                    self._fleet, "published_blocks", 0),
                "bytes_shipped": getattr(self._fleet, "bytes_shipped", 0),
                "bytes_fetched": getattr(self._fleet, "bytes_fetched", 0),
            },
            "spec": {
                "k": self.scfg.spec_k,
                "rounds": self.spec_rounds,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "accept_rate": round(
                    self.spec_accepted / self.spec_proposed, 4)
                if self.spec_proposed else 0.0,
            },
            "generation": self.generation,
            # The adapter registry and pool; the param roll's counts share
            # the group, as in the JAX engine, and "generations" counts
            # the unfinished streams of each.
            "adapters": {
                "enabled": self._lora_on,
                "rank": self.scfg.lora_rank,
                "pool_blocks": self.scfg.n_adapter_blocks,
                "registered": self.adapters_registered,
                "resident": self.adapters_resident,
                "loads": self.adapter_loads,
                "evictions": self.adapter_evictions,
                "pool_high_water": (self._lora_alloc.high_water
                                    if self._lora_alloc else 0),
                "param_swaps": self.param_swaps,
                "stale_generation_streams": self.stale_generation_streams,
                "generations": {str(g): c for g, c in
                                sorted(self._gen_streams.items())},
            },
            "attention_launches": {
                "cuda": pa.paged_decode_attention.launches,
                "pipelined": pa.paged_decode_pipelined_attention.launches,
                "reference": pa.paged_reference_attention.launches,
            },
            "goodput": self.goodput.snapshot(),
        }
        if self.obs is not None:
            # The registry: the latency histograms and every counter above
            # under its registry name.
            out["obs"] = self.obs.metrics.snapshot()
        return out
