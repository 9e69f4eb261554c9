"""The paged-cache decode step and its samplers — the counterpart of
``tpu_task/ml/serving/model.py`` (``paged_decode_step``,
``greedy_decode_step``, ``decode_and_sample``, ``sample_tokens``).

The step runs the model's own ``_block`` with an attention closure over
the paged pools: scatter the new k/v into their flat pool slots (in place,
``index_copy_``), then attend through :func:`paged_attention` — the CUDA
kernel or its plain version, chosen by ``attn_impl``. Chunked prefill uses
this same step at a batch of ``slots + chunk_tokens`` rows (the engine's
token-packed chunk step).

A quantized pool (its layers carry ``k_scale``/``v_scale``,
:func:`pool_is_quantized`) writes through
:func:`~tpu_task_torch.ml.serving.cache.quantized_append` with the host's
write layout ``qa`` and attends with its scales; its steps return the
largest quantization error of their writes beside their result (an exact
0.0 unless ``measure_qerr``), as the JAX package's do.

:func:`micro_decode_greedy` and :func:`micro_decode_sample` run ``micro_k``
sequential decode iterations with the retirement bookkeeping between them
(``_micro_scan``, the JAX package's ``lax.scan`` written as a loop); on a
CUDA device the engine captures that loop as one CUDA graph
(:mod:`~tpu_task_torch.ml.serving.step_graph`). The overlapped loop's
programs thread the loop state through: :func:`micro_carry_greedy` /
``_sample`` (the same loop from an absolute carry) and
:func:`chunk_carry_greedy` / ``_sample`` (the packed chunk step, whose
completing prefills join the carry in the program).

A config with mixture-of-experts layers serves through every one of these
steps: ``_block`` runs their dense dispatch, or over a mesh with an ``ep``
axis the expert-parallel one (:func:`serving_moe_fn`), and the steps drop
the router loss.

Every step takes ``mesh=``: on a gang's mesh
(:mod:`~tpu_task_torch.ml.parallel.gang`) each is a gang program, sent to
every rank, which runs it on its own block of the params and pools (its
kv heads, its hidden columns, its vocab rows and experts) and meets the
others in the all-reduces of :func:`~tpu_task_torch.ml.models.
transformer._block`, the embedding's all-reduce and the logits'
all-gather. The logits, and so the sampled tokens, are whole and equal on
every rank.

Speculative decoding's steps (:func:`paged_multitoken_logits`,
:func:`spec_score_greedy`, :func:`spec_score_probs`) run the same forward
(:func:`_multitoken_features`) at query width ``spec_k + 1``;
:func:`chunked_step_greedy`, the draft's catch-up, keeps JAX's (slots, w)
signature but packs the valid tokens into width-1 rows.

Bucketed prefill (:func:`paged_prefill`) runs one admission's whole prompt,
padded to a bucket, as causal self-attention over the bucket: it writes the
prompt's k/v into the pools but attends its own activations, so it calls no
paged kernel; the decode steps that follow it do."""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from tpu_task_torch.ml import random as jrandom
from tpu_task_torch.ml.models.decoding import _top_p_filter
from tpu_task_torch.ml.models import moe
from tpu_task_torch.ml.models.transformer import (
    Params,
    TransformerConfig,
    _block,
    _rmsnorm,
    sharded_embed,
    sharded_logits,
)
from tpu_task_torch.ml.ops.attention import gqa_cached_attention
from tpu_task_torch.ml.ops.paged_attention import paged_attention
from tpu_task_torch.ml.parallel import gang
from tpu_task_torch.ml.parallel.sharding import mesh_axis_size
from tpu_task_torch.ml.serving.cache import flat_pool, quantized_append
from tpu_task_torch.ml.serving.lora import apply_lora

Pools = List[Dict[str, torch.Tensor]]
#: The host-computed write layout of a quantized step: (touched, filled,
#: wt, wo), see :func:`~tpu_task_torch.ml.serving.cache.quantized_append`.
QuantLayout = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def pool_is_quantized(pools: Pools) -> bool:
    """Whether the pools carry quantized codes: the scale sidecars say so
    (the code dtype, and for uint8 the int4 packing, is read off the
    pools)."""
    return "k_scale" in pools[0]


def serving_moe_fn(cfg: TransformerConfig, mesh):
    """The expert-parallel MoE dispatch of the fused serving steps — or
    None when there is nothing to dispatch over (no MoE layers, no mesh,
    or no ``ep`` axis wider than 1), and then ``_block`` runs the dense
    dispatch (:func:`~tpu_task_torch.ml.models.moe.apply_dense`, the
    exact single-device arithmetic every sharded stream is held to),
    completed over ``tp`` when the mesh has one.

    The dispatch is :func:`~tpu_task_torch.ml.models.moe.apply_sharded`,
    the JAX package's rule: a step's (rows, w, d) activations flatten to
    (rows·w, 1, d) token rows, padded with zero rows to an ep multiple;
    the capacity is the per-rank token count, so every row, pad and
    masked rows too, holds a capacity slot and none can evict another
    (dropless, hence the dense dispatch's tokens); with a ``tp`` axis the
    experts' hidden dim shards over tp too and one all-reduce completes
    it. The router loss is computed and dropped."""
    if mesh is None or cfg.moe_every <= 0:
        return None
    ep = mesh_axis_size(mesh, "ep")
    if ep == 1:
        return None
    if cfg.n_experts % ep:
        raise ValueError(
            f"n_experts {cfg.n_experts} not divisible by ep={ep} "
            f"(mesh axes {tuple(mesh.axis_names)}): expert weights shard "
            "one group per ep shard")
    mcfg = cfg.moe_cfg
    tp_axis = "tp" if mesh_axis_size(mesh, "tp") > 1 else None

    def fn(layer, h):
        b, s, d = h.shape
        rows = b * s
        pad = (-rows) % ep
        flat = h.reshape(rows, 1, d)
        if pad:
            flat = torch.cat([flat, flat.new_zeros((pad, 1, d))])
        out, aux = moe.apply_sharded(
            layer, mcfg, flat, mesh, batch_axes=("ep",), tp_axis=tp_axis,
            capacity=(rows + pad) // ep)
        return out[:rows].reshape(b, s, d), aux

    return fn


def _fold_qerr(qerrs: List[torch.Tensor], mesh=None) -> torch.Tensor:
    """Max write-quantization error across a step's layers (and, given a
    gang's ``mesh``, across its ``tp`` ranks' kv heads)."""
    return gang.all_reduce(mesh, functools.reduce(torch.maximum, qerrs),
                           "tp", op="max")


def _multitoken_features(params: Params, cfg: TransformerConfig,
                         tokens: torch.Tensor, positions: torch.Tensor,
                         valid: torch.Tensor, block_tables: torch.Tensor,
                         pools: Pools, qa: Optional[QuantLayout] = None, *,
                         attn_impl: str = "reference",
                         measure_qerr: bool = False, mesh=None):
    """The paged forward of every step, the width-``w`` generalization of
    :func:`paged_decode_step`: ``tokens`` (rows, w) at PER-TOKEN absolute
    ``positions`` (rows, w) int32 with a ``valid`` mask (rows, w). Each
    valid token's k/v is scattered into its pool slot through its row's
    table before any token attends; ragged rows (a speculative row shorter
    than ``k + 1``, an inactive slot) write only the scratch block and
    their outputs are garbage the host discards. The attention runs at
    query width ``w`` through ``attn_impl`` (the paged kernels take any
    width their shared memory holds). Returns the (rows, w, d_model)
    final-norm features, and for a quantized pool the max quantization
    error beside them.

    ``params["lora"]``, when the engine sets it, is ``(adapter pool, block
    tables (rows, n_layers), scales (rows,))``: each layer's output gains
    :func:`~tpu_task_torch.ml.serving.lora.apply_lora` of its input, so
    every step built on this forward (decode, the chunk step, the K-step
    loop, speculative scoring) runs the adapters."""
    block_size = pools[0]["k"].shape[1]
    quantized = pool_is_quantized(pools)
    if quantized and qa is None:
        raise ValueError(
            "quantized pools need the host-computed `qa` write layout "
            "(touched, filled, wt, wo) — see cache.quantized_append; "
            "ServingEngine derives it per step (_quant_layout)")
    qpos = torch.where(valid, positions, 0)
    write_idx = None
    if not quantized:
        block = (qpos // block_size).to(torch.int64)
        phys = torch.gather(block_tables.to(torch.int64), 1, block)
        write_idx = torch.where(valid, phys * block_size + qpos % block_size,
                                0).reshape(-1)
    x = sharded_embed(params["embed"], tokens, mesh)
    moe_fn = serving_moe_fn(cfg, mesh)
    lora = params.get("lora")
    if lora is not None:
        # The engine's adapter pool and this step's per-row tables: block
        # (rows, n_layers), scale (rows,), cast once for every layer.
        lpool, lblocks, lscales = lora
        lscales = lscales.to(x.dtype)
    qerrs: List[torch.Tensor] = []
    for layer_i, (layer, pool) in enumerate(zip(params["layers"], pools)):
        def attn_fn(q, k, v, pool=pool):
            # Scatter this step's k/v, THEN attend: a token attends itself,
            # and its in-step predecessors (a chunk's earlier rows, the
            # earlier columns of a speculative row).
            k, v = (t.reshape(-1, *t.shape[2:]) for t in (k, v))
            if quantized:
                qerrs.append(quantized_append(pool, k, v, *qa,
                                              measure_error=measure_qerr))
                return paged_attention(q, pool["k"], pool["v"],
                                       block_tables, qpos, pool["k_scale"],
                                       pool["v_scale"], impl=attn_impl,
                                       mesh=mesh)
            flat_pool(pool["k"]).index_copy_(0, write_idx, k)
            flat_pool(pool["v"]).index_copy_(0, write_idx, v)
            return paged_attention(q, pool["k"], pool["v"], block_tables,
                                   qpos, impl=attn_impl, mesh=mesh)

        x_in = x
        x, _aux = _block(x, layer, cfg, attn_fn, positions=qpos,
                         moe_fn=moe_fn, mesh=mesh)
        if lora is not None:
            # The adapter branch around the unchanged block, gathered per
            # row; a scratch-block or scale-0 row adds an exact 0.0.
            x = x + apply_lora(x_in, lpool, lblocks[:, layer_i], lscales)
    x = _rmsnorm(x, params["final_norm"])
    if quantized:
        return x, _fold_qerr(qerrs, mesh if measure_qerr else None)
    return x


@gang.program
def paged_prefill(params: Params, cfg: TransformerConfig,
                  tokens: torch.Tensor, length: int,
                  block_table: torch.Tensor, pools: Pools, *,
                  measure_qerr: bool = False, moe_fn=None, mesh=None):
    """One request's prompt through the model, writing its k/v into the
    paged pools in place: the bucketed admission's program. ``tokens``
    (1, bucket), right-padded to a prefill bucket; ``length`` the real
    prompt length; ``block_table`` (max_blocks,) int32 with the prompt's
    blocks allocated. Returns the logits at ``length - 1``, (1, vocab)
    float32, and for a quantized pool the largest write-quantization error
    beside them (an exact 0.0 unless ``measure_qerr``).

    A fresh slot attends only itself, so the attention is causal
    self-attention over the bucket (:func:`~tpu_task_torch.ml.ops.
    attention.gqa_cached_attention`, JAX's einsum): no gather and no paged
    kernel. Pad rows (p >= ``length``) compute garbage k/v, written either
    into the tail of the slot's last block (overwritten by the real token
    before any unmasked read: decode writes position p before attending
    it) or, past the allocated blocks, into the scratch block, where
    several rows share a slot and the last write is never read unmasked.
    Their attention rows are never read either.

    A quantized pool changes only the write: the prompt's blocks quantize
    in one :func:`~tpu_task_torch.ml.serving.cache.quantized_append` a
    layer over the whole table, with each block's filled count derived
    from ``length``, so the requantize zeroes the pad rows and they cannot
    inflate a block's scale; the prompt still attends its own exact
    activations.

    ``params["lora"]`` is ``(adapter pool, block table (1, n_layers),
    scale (1,))`` as in :func:`_multitoken_features`; ``moe_fn`` is
    ``_block``'s (None: :func:`serving_moe_fn` of the ``mesh``)."""
    _, s = tokens.shape
    block_size = pools[0]["k"].shape[1]
    max_blocks = block_table.shape[0]
    if not 0 < length <= max_blocks * block_size:
        raise ValueError(
            f"prefill overflow: length {length} exceeds the slot's "
            f"block-table capacity {max_blocks * block_size}")
    quantized = pool_is_quantized(pools)
    device = tokens.device
    positions = torch.arange(s, device=device)
    table = block_table.to(device=device, dtype=torch.int64)
    wt, wo = positions // block_size, positions % block_size
    if quantized:
        filled = (length - torch.arange(max_blocks, device=device)
                  * block_size).clamp(0, block_size)
    else:
        write_idx = table[wt] * block_size + wo
    if moe_fn is None:
        moe_fn = serving_moe_fn(cfg, mesh)
    x = sharded_embed(params["embed"], tokens, mesh)
    lora = params.get("lora")
    if lora is not None:
        lpool, lblocks, lscales = lora
        lscales = lscales.to(x.dtype)
    qerrs: List[torch.Tensor] = []
    for layer_i, (layer, pool) in enumerate(zip(params["layers"], pools)):
        def attn_fn(q, k, v, pool=pool):
            if quantized:
                qerrs.append(quantized_append(
                    pool, k[0], v[0], table, filled, wt, wo,
                    measure_error=measure_qerr))
            else:
                flat_pool(pool["k"]).index_copy_(0, write_idx, k[0])
                flat_pool(pool["v"]).index_copy_(0, write_idx, v[0])
            return gqa_cached_attention(q, k, v, positions)

        x_in = x
        x, _aux = _block(x, layer, cfg, attn_fn, positions=positions,
                         moe_fn=moe_fn, mesh=mesh)
        if lora is not None:
            x = x + apply_lora(x_in, lpool, lblocks[:, layer_i], lscales)
    x = _rmsnorm(x, params["final_norm"])
    logits = sharded_logits(x[:, length - 1], params["unembed"], mesh)
    if quantized:
        return logits, _fold_qerr(qerrs, mesh if measure_qerr else None)
    return logits


@gang.program
def paged_decode_step(params: Params, cfg: TransformerConfig,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      block_tables: torch.Tensor, active: torch.Tensor,
                      pools: Pools, qa: Optional[QuantLayout] = None, *,
                      attn_impl: str = "reference",
                      measure_qerr: bool = False, mesh=None):
    """ONE decode step across every row: each row's token in, its
    next-token logits (rows, vocab) float32 out. ``tokens`` (rows,);
    ``positions`` (rows,) int32, the absolute position each token takes;
    ``block_tables`` (rows, max_blocks) int32; ``active`` (rows,) bool —
    inactive rows still compute but write only the scratch block, and the
    host discards their outputs. Updates ``pools`` in place. A quantized
    pool needs ``qa`` and returns (logits, max quantization error)."""
    out = _multitoken_features(
        params, cfg, tokens[:, None], positions[:, None], active[:, None],
        block_tables, pools, qa, attn_impl=attn_impl,
        measure_qerr=measure_qerr, mesh=mesh)
    feats = out[0] if isinstance(out, tuple) else out
    logits = sharded_logits(feats[:, -1], params["unembed"], mesh)
    return (logits, out[1]) if isinstance(out, tuple) else logits


@gang.program
def greedy_decode_step(params: Params, cfg: TransformerConfig, tokens,
                       positions, block_tables, active, pools: Pools,
                       qa: Optional[QuantLayout] = None, *,
                       attn_impl: str = "reference",
                       measure_qerr: bool = False, mesh=None):
    """Decode step + argmax: (rows,) next tokens (and, for a quantized
    pool, the step's max quantization error beside them)."""
    out = paged_decode_step(params, cfg, tokens, positions, block_tables,
                            active, pools, qa, attn_impl=attn_impl,
                            measure_qerr=measure_qerr, mesh=mesh)
    if isinstance(out, tuple):
        return torch.argmax(out[0], dim=-1), out[1]
    return torch.argmax(out, dim=-1)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_p: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Per-row sampling with per-row params: row i is greedy when
    ``temperature[i] == 0``, else Gumbel-max sampled at its temperature
    through its nucleus (``top_p[i]``; 1.0 disables) with its own key
    ``keys[i]`` — so a stream depends only on its own key, never on the
    rows it shares a step with."""
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    filtered = _top_p_filter(logits / safe_t[:, None], top_p)
    sampled = jrandom.categorical(keys, filtered)
    return torch.where(temperature > 0, sampled, greedy)


@gang.program
def decode_and_sample(params: Params, cfg: TransformerConfig, tokens,
                      positions, block_tables, active, temperature, top_p,
                      slot_keys, n_generated, pools: Pools,
                      qa: Optional[QuantLayout] = None, *,
                      attn_impl: str = "reference",
                      measure_qerr: bool = False, mesh=None):
    """Decode step + sampler. Each row's key is ``fold_in(slot_keys[i],
    n_generated[i])``: a request's stream depends only on its key and the
    token's index. A quantized pool returns (tokens, max quantization
    error)."""
    out = paged_decode_step(params, cfg, tokens, positions, block_tables,
                            active, pools, qa, attn_impl=attn_impl,
                            measure_qerr=measure_qerr, mesh=mesh)
    logits = out[0] if isinstance(out, tuple) else out
    keys = jrandom.fold_in(slot_keys, n_generated)
    toks = sample_tokens(logits, temperature, top_p, keys)
    return (toks, out[1]) if isinstance(out, tuple) else toks


# -- K-token micro-steps (ROADMAP A4) -----------------------------------------

def _micro_scan(params: Params, cfg: TransformerConfig, tokens, positions,
                block_tables, active, limits, eos, pools: Pools,
                qa: Optional[QuantLayout], micro_k: int, sampler, *,
                attn_impl: str, measure_qerr: bool, emitted0=None,
                return_carry: bool = False, mesh=None):
    """``micro_k`` SEQUENTIAL decode iterations, the body of the JAX
    package's ``_micro_scan`` line for line: iteration j samples slot i's
    next token while the slot is ``alive`` (it entered active and has hit
    neither its eos, ``eos[i] >= 0``, nor ``limits[i]`` emitted tokens);
    a retired slot is masked exactly like an inactive one (position 0,
    writes to the scratch block, output unread), and positions advance by
    one per emitted token, so iteration j addresses what the j-th of
    ``micro_k`` separate steps would.

    ``sampler(logits, alive, emitted)`` gives the (rows,) next tokens.
    Quantized pools take a stacked ``qa`` (leading dim ``micro_k``) and
    iteration j writes through ``qa[j]``. Returns the (micro_k, rows)
    tokens, and for a quantized pool the max quantization error over the
    iterations beside them. Every operation stays on the device and none
    reads a value back, so a CUDA graph can capture the whole loop.

    The overlapped engine threads the loop state from program to program:
    ``emitted0`` seeds the emitted counter (the carry convention is then
    ABSOLUTE, ``emitted`` the request's total token count and ``limits``
    its ``max_new_tokens``, which emits the same tokens as relative
    limits), and ``return_carry=True`` also returns the final (tok, pos,
    alive, emitted) carry, after the tokens."""
    quantized = pool_is_quantized(pools)
    if quantized and qa is None:
        raise ValueError(
            "quantized pools need the host-computed stacked `qa` write "
            "layouts (one per micro iteration) — see "
            "ServingEngine._micro_quant_layout")
    tok, pos, alive = tokens, positions, active
    emitted = torch.zeros_like(positions) if emitted0 is None else emitted0
    ys, qerrs = [], []
    for j in range(micro_k):
        out = paged_decode_step(
            params, cfg, tok, torch.where(alive, pos, 0), block_tables,
            alive, pools, tuple(a[j] for a in qa) if quantized else None,
            attn_impl=attn_impl, measure_qerr=measure_qerr, mesh=mesh)
        logits = out[0] if quantized else out
        nxt = sampler(logits, alive, emitted)
        emitted = emitted + alive.to(emitted.dtype)
        done = alive & (((eos >= 0) & (nxt == eos)) | (emitted >= limits))
        tok = torch.where(alive, nxt, tok)
        pos = pos + alive.to(pos.dtype)
        alive = alive & ~done
        ys.append(nxt)
        if quantized:
            qerrs.append(out[1])
    toks = torch.stack(ys)
    out = (toks, (tok, pos, alive, emitted)) if return_carry else (toks,)
    if quantized:
        return out + (functools.reduce(torch.maximum, qerrs),)
    return out if return_carry else toks


@gang.program
def micro_decode_greedy(params: Params, cfg: TransformerConfig, tokens,
                        positions, block_tables, active, limits, eos,
                        pools: Pools, qa: Optional[QuantLayout] = None, *,
                        micro_k: int, attn_impl: str = "reference",
                        measure_qerr: bool = False, mesh=None):
    """Greedy K-token micro-step: ``micro_k`` decode + argmax iterations,
    tokens bit-identical to ``micro_k`` separate
    :func:`greedy_decode_step` calls."""
    def sampler(logits, alive, emitted):
        return torch.argmax(logits, dim=-1)

    return _micro_scan(params, cfg, tokens, positions, block_tables, active,
                       limits, eos, pools, qa, micro_k, sampler,
                       attn_impl=attn_impl, measure_qerr=measure_qerr,
                       mesh=mesh)


@gang.program
def micro_decode_sample(params: Params, cfg: TransformerConfig, tokens,
                        positions, block_tables, active, limits, eos,
                        temperature, top_p, slot_keys, n_generated,
                        pools: Pools, qa: Optional[QuantLayout] = None, *,
                        micro_k: int, attn_impl: str = "reference",
                        measure_qerr: bool = False, mesh=None):
    """Sampled K-token micro-step: iteration j's keys are
    ``fold_in(slot_keys[i], n_generated[i] + emitted[i])``, the same key
    stream :func:`decode_and_sample` draws one token at a time, so a
    request's sampled stream is the same at any K."""
    def sampler(logits, alive, emitted):
        keys = jrandom.fold_in(slot_keys, n_generated + emitted)
        return sample_tokens(logits, temperature, top_p, keys)

    return _micro_scan(params, cfg, tokens, positions, block_tables, active,
                       limits, eos, pools, qa, micro_k, sampler,
                       attn_impl=attn_impl, measure_qerr=measure_qerr,
                       mesh=mesh)


# -- carry-threaded programs: the overlapped loop (A5) ------------------------
#
# The overlapped engine never reads the loop state back between dispatches:
# each program takes the previous one's (tok, pos, alive, emitted) carry as
# device tensors and returns the next, so the only host edge is the token
# readback it sweeps while the device runs the program dispatched after
# it. The carry is ABSOLUTE (``emitted`` is the request's total token count,
# ``limits`` its max_new_tokens), so after a full sweep the host's mirrors
# rebuild it exactly. The engine keeps one set of carry tensors and writes
# each program's returned carry back into them in place.


@gang.program
def micro_carry_greedy(params: Params, cfg: TransformerConfig, tok, pos,
                       alive, emitted, block_tables, limits, eos,
                       pools: Pools, qa: Optional[QuantLayout] = None, *,
                       micro_k: int, attn_impl: str = "reference",
                       measure_qerr: bool = False, mesh=None):
    """Greedy K-token micro-step with the carry threaded in and out: the
    tokens of :func:`micro_decode_greedy` at absolute limits. Returns the
    (micro_k, rows) tokens and the final carry (and the max quantization
    error, quantized pools)."""
    def sampler(logits, alive_, emitted_):
        return torch.argmax(logits, dim=-1)

    return _micro_scan(params, cfg, tok, pos, block_tables, alive, limits,
                       eos, pools, qa, micro_k, sampler, attn_impl=attn_impl,
                       measure_qerr=measure_qerr, emitted0=emitted,
                       return_carry=True, mesh=mesh)


@gang.program
def micro_carry_sample(params: Params, cfg: TransformerConfig, tok, pos,
                       alive, emitted, block_tables, limits, eos,
                       temperature, top_p, slot_keys, pools: Pools,
                       qa: Optional[QuantLayout] = None, *, micro_k: int,
                       attn_impl: str = "reference",
                       measure_qerr: bool = False, mesh=None):
    """Sampled K-token micro-step with the carry threaded through. The
    carry's absolute ``emitted`` is each slot's token index, so iteration
    j's key is ``fold_in(slot_keys[i], emitted[i])`` straight from the
    carry: the key stream every other sampler draws."""
    def sampler(logits, alive_, emitted_):
        keys = jrandom.fold_in(slot_keys, emitted_)
        return sample_tokens(logits, temperature, top_p, keys)

    return _micro_scan(params, cfg, tok, pos, block_tables, alive, limits,
                       eos, pools, qa, micro_k, sampler, attn_impl=attn_impl,
                       measure_qerr=measure_qerr, emitted0=emitted,
                       return_carry=True, mesh=mesh)


def _chunk_carry(params: Params, cfg: TransformerConfig, tok, pos, alive,
                 emitted, ctoks, cpos, cvalid, block_tables, limits, eos,
                 promote_row, promote_pos, promote_ngen, pools: Pools,
                 qa: Optional[QuantLayout], sampler, *, attn_impl: str,
                 measure_qerr: bool, mesh=None):
    """The carry-threaded token-packed chunk step: ONE pass at
    ``slots + chunk_tokens`` rows, where rows 0..slots-1 advance the carry
    (the K = 1 micro body: decode with in-program retirement) and rows
    slots.. ingest prompt chunks (``ctoks`` at ``cpos``, valid where
    ``cvalid``), each under its own slot's table row of ``block_tables``
    (slots + chunk_tokens, max_blocks). ``promote_row[i] >= 0`` marks slot
    i as completing its prefill here: that chunk row's sampled token
    enters the carry as the slot's first generated token, at position
    ``promote_pos[i]`` with emitted count ``promote_ngen[i] + 1``, under
    the same eos and limit check a decode row gets, so the admitted request
    decodes in the next program without the host touching this one.
    Returns the (slots + chunk_tokens,) sampled tokens and the new carry
    (and the max quantization error, quantized pools)."""
    n, W = tok.shape[0], ctoks.shape[0]
    tokens = tok.new_zeros((n + W,))
    tokens[:n] = tok
    tokens[n:] = ctoks
    positions = pos.new_zeros((n + W,))
    positions[:n] = torch.where(alive, pos, 0)
    positions[n:] = torch.where(cvalid, cpos, 0)
    active = alive.new_zeros((n + W,))
    active[:n] = alive
    active[n:] = cvalid
    out = paged_decode_step(params, cfg, tokens, positions, block_tables,
                            active, pools, qa, attn_impl=attn_impl,
                            measure_qerr=measure_qerr, mesh=mesh)
    logits = out[0] if isinstance(out, tuple) else out
    nxt = sampler(logits, emitted)
    # Decode rows: the micro-step body at K = 1.
    new_tok = torch.where(alive, nxt[:n], tok)
    new_emitted = emitted + alive.to(emitted.dtype)
    done = alive & (((eos >= 0) & (new_tok == eos)) | (new_emitted >= limits))
    new_pos = pos + alive.to(pos.dtype)
    new_alive = alive & ~done
    # Promotion: a completing prefill enters the carry with its first
    # token, under the retirement check every first token gets (max_new 1,
    # or the token is its eos).
    promoting = promote_row >= 0
    ptok = nxt[n + promote_row.clamp(0, W - 1).to(torch.int64)]
    p_emitted = promote_ngen + 1
    p_alive = ~(((eos >= 0) & (ptok == eos)) | (p_emitted >= limits))
    carry = (torch.where(promoting, ptok, new_tok),
             torch.where(promoting, promote_pos, new_pos),
             torch.where(promoting, p_alive, new_alive),
             torch.where(promoting, p_emitted, new_emitted))
    if isinstance(out, tuple):
        return nxt, carry, out[1]
    return nxt, carry


@gang.program
def chunk_carry_greedy(params: Params, cfg: TransformerConfig, tok, pos,
                       alive, emitted, ctoks, cpos, cvalid, block_tables,
                       limits, eos, promote_row, promote_pos, promote_ngen,
                       pools: Pools, qa: Optional[QuantLayout] = None, *,
                       attn_impl: str = "reference",
                       measure_qerr: bool = False, mesh=None):
    """Greedy carry chunk step: argmax over every packed row."""
    def sampler(logits, emitted_):
        return torch.argmax(logits, dim=-1)

    return _chunk_carry(params, cfg, tok, pos, alive, emitted, ctoks, cpos,
                        cvalid, block_tables, limits, eos, promote_row,
                        promote_pos, promote_ngen, pools, qa, sampler,
                        attn_impl=attn_impl, measure_qerr=measure_qerr,
                       mesh=mesh)


@gang.program
def chunk_carry_sample(params: Params, cfg: TransformerConfig, tok, pos,
                       alive, emitted, ctoks, cpos, cvalid, block_tables,
                       limits, eos, promote_row, promote_pos, promote_ngen,
                       temperature, top_p, row_keys, chunk_ngen,
                       pools: Pools, qa: Optional[QuantLayout] = None, *,
                       attn_impl: str = "reference",
                       measure_qerr: bool = False, mesh=None):
    """Sampled carry chunk step: per-row (temperature, top_p, key) from
    the host; a decode row's token index is the carry's emitted count, a
    chunk row's the admission-time count ``chunk_ngen`` (constant through
    a prefill, so the completing row draws ``fold_in(key,
    len(req.tokens))``, the first-token draw of every other path)."""
    n = tok.shape[0]

    def sampler(logits, emitted_):
        ngen = torch.zeros((logits.shape[0],), dtype=torch.int64,
                           device=logits.device)
        ngen[:n] = emitted_
        ngen[n:] = chunk_ngen
        return sample_tokens(logits, temperature, top_p,
                             jrandom.fold_in(row_keys, ngen))

    return _chunk_carry(params, cfg, tok, pos, alive, emitted, ctoks, cpos,
                        cvalid, block_tables, limits, eos, promote_row,
                        promote_pos, promote_ngen, pools, qa, sampler,
                        attn_impl=attn_impl, measure_qerr=measure_qerr,
                       mesh=mesh)


# -- multi-token steps: speculative scoring and the draft catch-up (A3) ------

@gang.program
def paged_multitoken_logits(params: Params, cfg: TransformerConfig, tokens,
                            positions, valid, block_tables, pools: Pools,
                            qa: Optional[QuantLayout] = None, *,
                            attn_impl: str = "reference",
                            measure_qerr: bool = False, mesh=None):
    """Full-width logits (slots, w, vocab) float32 — the speculative
    scoring step: ONE fused target pass scores all k+1 positions of every
    slot's [last_token, draft_1..draft_k] row against the paged cache."""
    out = _multitoken_features(params, cfg, tokens, positions, valid,
                               block_tables, pools, qa, attn_impl=attn_impl,
                               measure_qerr=measure_qerr, mesh=mesh)
    feats = out[0] if isinstance(out, tuple) else out
    logits = sharded_logits(feats, params["unembed"], mesh)
    return (logits, out[1]) if isinstance(out, tuple) else logits


@gang.program
def spec_score_greedy(params: Params, cfg: TransformerConfig, tokens,
                      positions, valid, block_tables, pools: Pools,
                      qa: Optional[QuantLayout] = None, *,
                      attn_impl: str = "reference",
                      measure_qerr: bool = False, mesh=None):
    """Speculative scoring + argmax: the (slots, w) target tokens the
    host's greedy accept rule (longest agreeing prefix + one bonus token)
    runs on, bit-identical to non-speculative greedy decoding."""
    out = paged_multitoken_logits(params, cfg, tokens, positions, valid,
                                  block_tables, pools, qa,
                                  attn_impl=attn_impl,
                                  measure_qerr=measure_qerr, mesh=mesh)
    if isinstance(out, tuple):
        return torch.argmax(out[0], dim=-1), out[1]
    return torch.argmax(out, dim=-1)


@gang.program
def spec_score_probs(params: Params, cfg: TransformerConfig, tokens,
                     positions, valid, block_tables, temperature, top_p,
                     pools: Pools, qa: Optional[QuantLayout] = None, *,
                     attn_impl: str = "reference",
                     measure_qerr: bool = False, mesh=None):
    """Speculative scoring for sampled requests: per-position target
    probabilities (slots, w, vocab) float32 after the SAME
    temper-then-``_top_p_filter`` order :func:`sample_tokens` applies, so
    the host's rejection sampling targets exactly the distribution
    non-speculative decoding samples from. Greedy rows (temperature 0) run
    at temperature 1; the host takes argmax(probs), which is
    argmax(logits)."""
    out = paged_multitoken_logits(params, cfg, tokens, positions, valid,
                                  block_tables, pools, qa,
                                  attn_impl=attn_impl,
                                  measure_qerr=measure_qerr, mesh=mesh)
    logits = out[0] if isinstance(out, tuple) else out
    slots, w, vocab = logits.shape
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    filtered = _top_p_filter(
        (logits / safe_t[:, None, None]).reshape(-1, vocab),
        top_p.repeat_interleave(w))
    probs = torch.softmax(filtered, dim=-1).reshape(slots, w, vocab)
    return (probs, out[1]) if isinstance(out, tuple) else probs


@gang.program
def chunked_step_greedy(params: Params, cfg: TransformerConfig, tokens,
                        positions, valid, last_idx, block_tables,
                        pools: Pools, qa: Optional[QuantLayout] = None, *,
                        attn_impl: str = "reference",
                        measure_qerr: bool = False, mesh=None):
    """Multi-row chunk ingestion, the draft cache's catch-up: every slot
    of ``tokens`` (slots, w) advances by its own ``valid`` span and emits
    the argmax at ``last_idx`` (slots,); a slot whose ``last_idx`` token
    is not valid gets an unspecified token the host discards. Returns
    (slots,) tokens (and the max quantization error, quantized pools).

    JAX's signature and result, computed another way: the valid tokens
    are PACKED into width-1 rows, each with its slot's table and its own
    position — the layout of the engine's token-packed chunk step — so
    the paged kernel runs at query width 1 whatever ``w`` is (its shared
    memory grows with the width: 128 columns would not fit a CTA). All
    rows scatter their k/v before any row attends and the position mask
    gives each token exactly its predecessors, so the result is the
    (slots, w) layout's. Packing reads the valid count back (one small
    device-to-host copy)."""
    slots, w = tokens.shape
    flat_valid = valid.reshape(-1)
    idx = torch.nonzero(flat_valid).reshape(-1)
    row_slot = idx // w
    packed_qa = qa
    if qa is not None:
        touched, filled, wt, wo = qa
        packed_qa = (touched, filled, wt.reshape(-1)[idx],
                     wo.reshape(-1)[idx])
    out = _multitoken_features(
        params, cfg, tokens.reshape(-1)[idx][:, None],
        positions.reshape(-1)[idx][:, None],
        torch.ones((idx.numel(), 1), dtype=torch.bool, device=idx.device),
        block_tables[row_slot], pools, packed_qa, attn_impl=attn_impl,
        measure_qerr=measure_qerr, mesh=mesh)
    feats = out[0] if isinstance(out, tuple) else out
    # Each slot's last_idx token's packed row; a slot whose token is not
    # valid reads the zero row appended past the packed ones.
    rank = torch.cumsum(flat_valid.to(torch.int64), 0) - 1
    last = torch.arange(slots, device=idx.device) * w + last_idx.to(
        torch.int64)
    row = torch.where(flat_valid[last], rank[last], idx.numel())
    feats = torch.cat([feats[:, 0], feats.new_zeros((1, feats.shape[-1]))])
    logits = sharded_logits(feats[row], params["unembed"], mesh)
    toks = torch.argmax(logits, dim=-1)
    return (toks, out[1]) if isinstance(out, tuple) else toks
