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
(:mod:`~tpu_task_torch.ml.serving.step_graph`)."""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch

from tpu_task_torch.ml import random as jrandom
from tpu_task_torch.ml.models.decoding import _top_p_filter
from tpu_task_torch.ml.models.transformer import (
    Params,
    TransformerConfig,
    _block,
    _rmsnorm,
    embed_lookup,
)
from tpu_task_torch.ml.ops.paged_attention import paged_attention
from tpu_task_torch.ml.serving.cache import (
    flat_pool,
    quantized_append,
    token_slots,
)

Pools = List[Dict[str, torch.Tensor]]
#: The host-computed write layout of a quantized step: (touched, filled,
#: wt, wo), see :func:`~tpu_task_torch.ml.serving.cache.quantized_append`.
QuantLayout = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def pool_is_quantized(pools: Pools) -> bool:
    """Whether the pools carry quantized codes: the scale sidecars say so
    (the code dtype, and for uint8 the int4 packing, is read off the
    pools)."""
    return "k_scale" in pools[0]


def _fold_qerr(qerrs: List[torch.Tensor]) -> torch.Tensor:
    """Max write-quantization error across a step's layers."""
    return functools.reduce(torch.maximum, qerrs)


def paged_decode_step(params: Params, cfg: TransformerConfig,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      block_tables: torch.Tensor, active: torch.Tensor,
                      pools: Pools, qa: Optional[QuantLayout] = None, *,
                      attn_impl: str = "reference",
                      measure_qerr: bool = False):
    """ONE decode step across every row: each row's token in, its
    next-token logits (rows, vocab) float32 out. ``tokens`` (rows,);
    ``positions`` (rows,) int32, the absolute position each token takes;
    ``block_tables`` (rows, max_blocks) int32; ``active`` (rows,) bool —
    inactive rows still compute but write only the scratch block, and the
    host discards their outputs. Updates ``pools`` in place. A quantized
    pool needs ``qa`` and returns (logits, max quantization error)."""
    block_size = pools[0]["k"].shape[1]
    quantized = pool_is_quantized(pools)
    if quantized and qa is None:
        raise ValueError(
            "quantized pools need the host-computed `qa` write layout "
            "(touched, filled, wt, wo) — see cache.quantized_append; "
            "ServingEngine derives it per step (_quant_layout)")
    write_idx = None if quantized else torch.where(
        active, token_slots(block_tables, positions, block_size), 0)
    pos2d = positions[:, None]
    x = embed_lookup(params["embed"], tokens[:, None])
    qerrs: List[torch.Tensor] = []
    for layer, pool in zip(params["layers"], pools):
        def attn_fn(q, k, v, pool=pool):
            # Scatter this step's k/v, THEN attend: the new token attends
            # itself, and a chunk's rows attend their in-chunk predecessors.
            if quantized:
                qerrs.append(quantized_append(pool, k[:, 0], v[:, 0], *qa,
                                              measure_error=measure_qerr))
                return paged_attention(q, pool["k"], pool["v"],
                                       block_tables, pos2d, pool["k_scale"],
                                       pool["v_scale"], impl=attn_impl)
            flat_pool(pool["k"]).index_copy_(0, write_idx, k[:, 0])
            flat_pool(pool["v"]).index_copy_(0, write_idx, v[:, 0])
            return paged_attention(q, pool["k"], pool["v"], block_tables,
                                   pos2d, impl=attn_impl)

        x = _block(x, layer, cfg, attn_fn, positions=pos2d)
    x = _rmsnorm(x, params["final_norm"])
    logits = (x[:, -1] @ params["unembed"]).to(torch.float32)
    if quantized:
        return logits, _fold_qerr(qerrs)
    return logits


def greedy_decode_step(params: Params, cfg: TransformerConfig, tokens,
                       positions, block_tables, active, pools: Pools,
                       qa: Optional[QuantLayout] = None, *,
                       attn_impl: str = "reference",
                       measure_qerr: bool = False):
    """Decode step + argmax: (rows,) next tokens (and, for a quantized
    pool, the step's max quantization error beside them)."""
    out = paged_decode_step(params, cfg, tokens, positions, block_tables,
                            active, pools, qa, attn_impl=attn_impl,
                            measure_qerr=measure_qerr)
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


def decode_and_sample(params: Params, cfg: TransformerConfig, tokens,
                      positions, block_tables, active, temperature, top_p,
                      slot_keys, n_generated, pools: Pools,
                      qa: Optional[QuantLayout] = None, *,
                      attn_impl: str = "reference",
                      measure_qerr: bool = False):
    """Decode step + sampler. Each row's key is ``fold_in(slot_keys[i],
    n_generated[i])``: a request's stream depends only on its key and the
    token's index. A quantized pool returns (tokens, max quantization
    error)."""
    out = paged_decode_step(params, cfg, tokens, positions, block_tables,
                            active, pools, qa, attn_impl=attn_impl,
                            measure_qerr=measure_qerr)
    logits = out[0] if isinstance(out, tuple) else out
    keys = jrandom.fold_in(slot_keys, n_generated)
    toks = sample_tokens(logits, temperature, top_p, keys)
    return (toks, out[1]) if isinstance(out, tuple) else toks


# -- K-token micro-steps (ROADMAP A4) -----------------------------------------

def _micro_scan(params: Params, cfg: TransformerConfig, tokens, positions,
                block_tables, active, limits, eos, pools: Pools,
                qa: Optional[QuantLayout], micro_k: int, sampler, *,
                attn_impl: str, measure_qerr: bool):
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
    reads a value back, so a CUDA graph can capture the whole loop."""
    quantized = pool_is_quantized(pools)
    if quantized and qa is None:
        raise ValueError(
            "quantized pools need the host-computed stacked `qa` write "
            "layouts (one per micro iteration) — see "
            "ServingEngine._micro_quant_layout")
    tok, pos, alive = tokens, positions, active
    emitted = torch.zeros_like(positions)
    ys, qerrs = [], []
    for j in range(micro_k):
        out = paged_decode_step(
            params, cfg, tok, torch.where(alive, pos, 0), block_tables,
            alive, pools, tuple(a[j] for a in qa) if quantized else None,
            attn_impl=attn_impl, measure_qerr=measure_qerr)
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
    if quantized:
        return toks, _fold_qerr(qerrs)
    return toks


def micro_decode_greedy(params: Params, cfg: TransformerConfig, tokens,
                        positions, block_tables, active, limits, eos,
                        pools: Pools, qa: Optional[QuantLayout] = None, *,
                        micro_k: int, attn_impl: str = "reference",
                        measure_qerr: bool = False):
    """Greedy K-token micro-step: ``micro_k`` decode + argmax iterations,
    tokens bit-identical to ``micro_k`` separate
    :func:`greedy_decode_step` calls."""
    def sampler(logits, alive, emitted):
        return torch.argmax(logits, dim=-1)

    return _micro_scan(params, cfg, tokens, positions, block_tables, active,
                       limits, eos, pools, qa, micro_k, sampler,
                       attn_impl=attn_impl, measure_qerr=measure_qerr)


def micro_decode_sample(params: Params, cfg: TransformerConfig, tokens,
                        positions, block_tables, active, limits, eos,
                        temperature, top_p, slot_keys, n_generated,
                        pools: Pools, qa: Optional[QuantLayout] = None, *,
                        micro_k: int, attn_impl: str = "reference",
                        measure_qerr: bool = False):
    """Sampled K-token micro-step: iteration j's keys are
    ``fold_in(slot_keys[i], n_generated[i] + emitted[i])``, the same key
    stream :func:`decode_and_sample` draws one token at a time, so a
    request's sampled stream is the same at any K."""
    def sampler(logits, alive, emitted):
        keys = jrandom.fold_in(slot_keys, n_generated + emitted)
        return sample_tokens(logits, temperature, top_p, keys)

    return _micro_scan(params, cfg, tokens, positions, block_tables, active,
                       limits, eos, pools, qa, micro_k, sampler,
                       attn_impl=attn_impl, measure_qerr=measure_qerr)
