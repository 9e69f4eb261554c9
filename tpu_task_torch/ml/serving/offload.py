"""Host-RAM KV tier: the middle rung of the block hierarchy — this
package's copy of ``tpu_task/ml/serving/offload.py`` (which the port does
not import, though it imports no JAX).

The block payload codec (``cache.export_block_bytes`` /
``split_block_bytes`` / ``write_block_payloads``) serializes any physical
block byte for byte; the fleet KV plane ships those payloads between
replicas. This module keeps the same payloads as a MEMORY tier: a
budgeted, content-addressed store of block bytes in host RAM, between the
paged device pools and the bucket.

    device pool  ──demote──▶  HostKvTier  ──spill──▶  kvfleet bucket
         ▲                       │                        │
         └──────promote──────────┴───────fetch────────────┘

* **Demote** — the engine copies cold retained refcount-0 cached blocks
  (the prefix cache's LRU tail: the blocks eviction would reclaim next)
  into the tier. A demote pass gathers its blocks on the device and
  copies them into pinned host memory behind the program in flight
  (``cache.BlockStaging``); the bytes are forced one consume edge later,
  when that program has run.
* **Promote** — admission's hash-chain import tries this tier BEFORE the
  fleet bucket: a hit hands back the exact exported payload, which the
  engine uploads through one pinned buffer into a fresh block and
  re-registers in its prefix cache. ``prefetch_chain`` takes the same
  path, so a router's next-turn hint warms the device pool from host RAM.
* **Spill** — entries past the block budget leave LRU-first through a
  caller-provided sink (the engine wires ``FleetKvClient.ship_bytes``
  when a fleet client is attached); with no sink, or a sink that raises
  ``OSError``, they drop, and a later miss recomputes from the prefix.

The tier is deliberately dumb: a dict of immutable ``bytes`` payloads
keyed by the chained content hash, LRU-ordered by dict insertion order.
Content addressing is the whole correctness story: a payload is only
ever adopted under the hash naming its exact token prefix, so a stale or
dropped entry can never corrupt a stream, only cost a recompute. Pinned
memory belongs where the bytes cross the bus (``cache.BlockStaging`` and
``cache.write_block_payloads``), not here: a spill hands the entries to
the bucket as they are."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["HostKvTier"]


class HostKvTier:
    """Budgeted LRU store: chained block hash → exported block payload.

    ``budget_blocks`` bounds resident entries (one entry is one physical
    block's payload, ``cache.block_payload_nbytes`` bytes). ``spill`` is
    called with the evicted ``[(hash, payload), ...]`` batch whenever an
    insert pushes the tier over budget; an ``OSError`` from the sink is
    counted as dropped blocks (a failed spill loses only cache: the
    recompute path covers it)."""

    def __init__(self, budget_blocks: int,
                 spill: Optional[Callable[[List[Tuple[bytes, bytes]]],
                                          None]] = None):
        if budget_blocks < 1:
            raise ValueError(
                f"budget_blocks must be >= 1, got {budget_blocks}")
        self.budget_blocks = budget_blocks
        self._spill = spill
        self._entries: Dict[bytes, bytes] = {}   # insertion order = LRU
        self.hits = 0
        self.misses = 0
        self.spilled_blocks = 0
        self.dropped_blocks = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, h: bytes) -> bool:
        return h in self._entries

    @property
    def resident_bytes(self) -> int:
        return sum(len(p) for p in self._entries.values())

    def put(self, h: bytes, payload: bytes) -> None:
        """Insert (or LRU-refresh) one block payload; evicts the LRU tail
        past the budget into the spill sink."""
        self._entries.pop(h, None)
        self._entries[h] = payload
        over = len(self._entries) - self.budget_blocks
        if over <= 0:
            return
        victims = []
        for old in list(self._entries):
            if len(victims) >= over:
                break
            victims.append((old, self._entries.pop(old)))
        if self._spill is not None:
            try:
                self._spill(victims)
                self.spilled_blocks += len(victims)
                return
            except OSError:
                pass                    # dropped below: cache, not truth
        self.dropped_blocks += len(victims)

    def get(self, h: bytes) -> Optional[bytes]:
        """One payload by hash (an LRU touch), or None. The entry STAYS
        resident: a promoted block may be evicted from the device pool
        again before the tier's LRU would drop it, and the bytes are
        immutable, so keeping them costs nothing extra."""
        payload = self._entries.pop(h, None)
        if payload is None:
            self.misses += 1
            return None
        self._entries[h] = payload      # re-insert = LRU touch
        self.hits += 1
        return payload

    def chain_depth(self, hashes) -> int:
        """Consecutive leading hits of a hash chain (the
        ``FleetKvIndex.chain_depth`` contract: a chain stops at its first
        hole, since blocks past it would leave a KV gap no import can
        fill). Membership only; no LRU touch."""
        depth = 0
        for h in hashes:
            if h not in self._entries:
                break
            depth += 1
        return depth

    def stats(self) -> dict:
        return {
            "resident_blocks": len(self._entries),
            "budget_blocks": self.budget_blocks,
            "resident_bytes": self.resident_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "spilled_blocks": self.spilled_blocks,
            "dropped_blocks": self.dropped_blocks,
        }
