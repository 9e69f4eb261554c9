"""The replica half of the fleet KV plane — this package's copy of
``tpu_task/serve/kvfleet.py``'s :class:`FleetKvIndex` and
:class:`FleetKvClient`, bound through the port's own
:func:`~tpu_task_torch.ml.serving.cache.kv_fingerprint` and
:func:`~tpu_task_torch.ml.serving.cache.block_payload_nbytes`.

A replica publishes its hot refcount-0 prefix-cache blocks into a bucket
under ``<ns>/<fingerprint>/blocks/<hash hex>`` (content-addressed,
``write_if_absent``) and advertises them in its own index shard
``<ns>/<fingerprint>/index/<source>.json`` (a JSON object, hash hex →
payload bytes). Another replica's admission looks the chained hashes its
local cache missed up in the merged shards, fetches the payloads and
writes them into its pool instead of prefilling them
(``ServingEngine._fleet_import``). The layout, the shard body and the
payload bytes are the JAX package's, so replicas of both packages share
one bucket.

The index is advisory: a stale entry (object gone, torn, foreign) is a
fetch miss, and the request prefills that tail locally. The backend is
duck-typed (``list``, ``read``, ``read_conditional``, ``write``,
``write_if_absent``): the port's
:class:`~tpu_task_torch.storage.backends.LocalBackend` or the JAX
package's. Neither package's sentinels are imported here: a
``read_conditional`` answer that is not bytes means "not modified", and
any failure to read an object is a miss.

LoRA adapter payloads ride the same bucket under
``<ns>/<fingerprint>/adapters/<content hash>`` (``write_if_absent``, no
index and no length gate: the importing engine checks the payload's
geometry), the JAX client's key and bytes, so one bucket serves adapters
to replicas of both packages."""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, Optional, Sequence

from tpu_task_torch.ml.serving.cache import (
    block_payload_nbytes,
    kv_fingerprint,
    staged_block_to_bytes,
)

__all__ = ["FleetKvClient", "FleetKvIndex"]

#: Index shards drop their oldest entries past this many hashes: a bound
#: on a shard's JSON, not on the bucket.
MAX_SHARD_ENTRIES = 4096

_BYTES = (bytes, bytearray, memoryview)


class FleetKvIndex:
    """Bucket-backed map of block hash (hex) → publisher, merged from one
    shard per publisher. Refreshes are throttled to ``refresh_interval``
    and re-read only the shards whose validator changed."""

    def __init__(self, backend, namespace: str = "kvfleet",
                 refresh_interval: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        self._backend = backend
        self.namespace = namespace.rstrip("/")
        self.refresh_interval = refresh_interval
        self._clock = clock
        self._by_hash: Dict[str, str] = {}           # hash hex -> source
        self._shards: Dict[str, Dict[str, int]] = {}  # shard key -> entries
        self._validators: Dict[str, object] = {}
        self._last_refresh: Optional[float] = None

    def __len__(self) -> int:
        return len(self._by_hash)

    def __contains__(self, hash_hex: str) -> bool:
        return hash_hex in self._by_hash

    def _shard_key(self, source: str) -> str:
        return f"{self.namespace}/index/{source}.json"

    def block_key(self, hash_hex: str) -> str:
        return f"{self.namespace}/blocks/{hash_hex}"

    def source_of(self, hash_hex: str) -> Optional[str]:
        return self._by_hash.get(hash_hex)

    def publish(self, source: str, entries: Dict[str, int]) -> None:
        """Replace ``source``'s shard with ``entries`` (hash hex → payload
        bytes); they join this process's view at once."""
        if len(entries) > MAX_SHARD_ENTRIES:
            entries = dict(list(entries.items())[-MAX_SHARD_ENTRIES:])
        key = self._shard_key(source)
        self._backend.write(
            key, json.dumps(entries, sort_keys=True).encode())
        self._shards[key] = dict(entries)
        self._validators.pop(key, None)
        self._rebuild()

    def refresh(self, force: bool = False) -> None:
        """Merge every publisher's shard, re-reading only changed ones.
        A shard that fails to list, read or parse keeps its last view."""
        now = self._clock()
        if not force and self._last_refresh is not None \
                and now - self._last_refresh < self.refresh_interval:
            return
        self._last_refresh = now
        try:
            keys = set(self._backend.list(f"{self.namespace}/index/"))
        except OSError:
            return
        gone = set(self._shards) - keys
        for key in gone:
            self._shards.pop(key, None)
            self._validators.pop(key, None)
        changed = bool(gone)
        for key in sorted(keys):
            try:
                data, validator = self._backend.read_conditional(
                    key, self._validators.get(key))
            except Exception:             # missing or unreadable: skip it
                continue
            self._validators[key] = validator
            if not isinstance(data, _BYTES):
                continue                  # not modified
            try:
                entries = json.loads(bytes(data))
            except ValueError:
                continue
            if isinstance(entries, dict):
                self._shards[key] = {str(h): int(n)
                                     for h, n in entries.items()}
                changed = True
        if changed:
            self._rebuild()

    def _rebuild(self) -> None:
        merged: Dict[str, str] = {}
        for key in sorted(self._shards):
            source = key.rsplit("/", 1)[-1][:-len(".json")]
            for h in self._shards[key]:
                merged.setdefault(h, source)
        self._by_hash = merged

    def chain_depth(self, hashes: Sequence[str]) -> int:
        """How many LEADING entries of ``hashes`` the index advertises: a
        chain stops at its first hole."""
        depth = 0
        for h in hashes:
            if h not in self._by_hash:
                break
            depth += 1
        return depth


class FleetKvClient:
    """One replica's handle on the fleet KV plane. An engine given one
    (``ServingEngine(kv_fleet=)``) binds it to its pool layout, imports
    through :meth:`lookup_chain` and :meth:`fetch`, and is published from
    by :meth:`publish` (or :meth:`stage` then :meth:`ship`)."""

    def __init__(self, backend, source: str, namespace: str = "kvfleet",
                 refresh_interval: float = 0.25,
                 clock: Callable[[], float] = time.monotonic):
        self._backend = backend
        self.source = source
        self._root = namespace.rstrip("/")
        self._refresh_interval = refresh_interval
        self._clock = clock
        self.index: Optional[FleetKvIndex] = None
        self._payload_nbytes: Optional[int] = None
        #: everything this client published: hash hex -> payload bytes
        #: (its shard body, and the skip set of the next publish).
        self._published: Dict[str, int] = {}
        self.bytes_shipped = 0
        self.bytes_fetched = 0
        self.published_blocks = 0
        self.fetch_misses = 0

    def bind(self, cfg, scfg) -> None:
        """Pin the client to one pool layout: the fingerprint names the
        bucket namespace, the payload length gates every fetch."""
        namespace = f"{self._root}/{kv_fingerprint(cfg, scfg)}"
        if self.index is not None and self.index.namespace == namespace:
            return
        self.index = FleetKvIndex(
            self._backend, namespace=namespace,
            refresh_interval=self._refresh_interval, clock=self._clock)
        self._payload_nbytes = block_payload_nbytes(cfg, scfg)

    def _require_bound(self) -> FleetKvIndex:
        if self.index is None:
            raise RuntimeError(
                "FleetKvClient is not bound to a pool layout — attach it "
                "to a ServingEngine (kv_fleet=) or call bind(cfg, scfg)")
        return self.index

    def stage(self, engine, limit: int = 16) -> list:
        """Up to ``limit`` unpublished hot blocks as (hash hex, device
        copies), without a readback."""
        self._require_bound()
        return engine.stage_cached_blocks(limit=limit, skip=self._published)

    def ship(self, staged: list) -> int:
        """Read :meth:`stage`'s copies back and upload them."""
        if not staged:
            return 0
        return self.ship_bytes(
            [(hh, staged_block_to_bytes(s)) for hh, s in staged])

    def ship_bytes(self, entries: list) -> int:
        """Upload ``(hash, payload)`` entries (raw digests or hex) under
        ``write_if_absent`` and re-publish this client's shard. Bytes move
        only for hashes the bucket lacks; a failed write is not
        advertised. Returns how many entries were handed in."""
        index = self._require_bound()
        if not entries:
            return 0
        for hh, payload in entries:
            hash_hex = hh if isinstance(hh, str) else hh.hex()
            try:
                if self._backend.write_if_absent(
                        index.block_key(hash_hex), payload):
                    self.bytes_shipped += len(payload)
            except OSError:
                continue
            self._published[hash_hex] = len(payload)
            self.published_blocks += 1
        if len(self._published) > MAX_SHARD_ENTRIES:
            self._published = dict(
                list(self._published.items())[-MAX_SHARD_ENTRIES:])
        try:
            index.publish(self.source, self._published)
        except OSError:
            pass                          # re-advertised on the next pass
        return len(entries)

    def publish(self, engine, limit: int = 16) -> int:
        """Stage and ship in one synchronous call."""
        return self.ship(self.stage(engine, limit=limit))

    def lookup_chain(self, hashes: Sequence[bytes]) -> int:
        """Leading-hit depth of ``hashes`` (raw digests) in the index after
        a throttled refresh; a depth of 0 forces one unthrottled retry."""
        index = self._require_bound()
        index.refresh()
        want = [h.hex() for h in hashes]
        depth = index.chain_depth(want)
        if depth == 0:
            index.refresh(force=True)
            depth = index.chain_depth(want)
        return depth

    def fetch(self, h: bytes) -> Optional[bytes]:
        """One payload by hash, or None on ANY failure (missing object,
        unreadable, wrong length): the importer then prefills that tail."""
        index = self._require_bound()
        try:
            data = bytes(self._backend.read(index.block_key(h.hex())))
        except Exception:
            self.fetch_misses += 1
            return None
        if self._payload_nbytes is not None \
                and len(data) != self._payload_nbytes:
            self.fetch_misses += 1
            return None
        self.bytes_fetched += len(data)
        return data

    # -- adapters --------------------------------------------------------------

    def _adapter_key(self, hash_hex: str) -> str:
        return f"{self._require_bound().namespace}/adapters/{hash_hex}"

    def ship_adapter(self, hash_hex: str, payload: bytes) -> bool:
        """Upload one packed adapter under its content hash
        (``write_if_absent``: a known adapter ships nothing). Returns
        whether bytes moved."""
        try:
            if self._backend.write_if_absent(self._adapter_key(hash_hex),
                                             payload):
                self.bytes_shipped += len(payload)
                return True
        except OSError:
            pass
        return False

    def fetch_adapter(self, hash_hex: str) -> Optional[bytes]:
        """One adapter payload by content hash, or None on any failure (the
        engine then refuses to decode under the missing weights)."""
        try:
            data = bytes(self._backend.read(self._adapter_key(hash_hex)))
        except Exception:
            self.fetch_misses += 1
            return None
        self.bytes_fetched += len(data)
        return data

    def stats(self) -> dict:
        return {
            "source": self.source,
            "namespace": self.index.namespace if self.index else self._root,
            "published_blocks": self.published_blocks,
            "bytes_shipped": self.bytes_shipped,
            "bytes_fetched": self.bytes_fetched,
            "fetch_misses": self.fetch_misses,
            "index_entries": len(self.index) if self.index else 0,
        }
