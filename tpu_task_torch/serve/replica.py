"""One serving replica of the port: a :class:`~tpu_task_torch.ml.serving.
engine.ServingEngine` behind the JAX replica's HTTP front end
(``tpu_task/serve/replica.py``), runnable as ``python -m
tpu_task_torch.serve.replica``. The JAX package's ``Router`` and
``ServeFleet`` drive it as they drive a JAX replica: the same endpoints,
status codes, JSON bodies, trace and SLA headers, ``endpoint.json`` and
drain file.

The front end speaks plain JSON over HTTP/1.1 keep-alive:

* ``POST /submit`` — ``{prompt, max_new_tokens, temperature?, top_p?,
  eos_token?, key?, tokens?}``. ``key`` is the raw uint32 per-request
  sampling key the router derives, so the same request draws the same
  sampled stream on any replica of either package; ``tokens`` is an
  already-emitted prefix (a re-dispatch after a sibling's preemption),
  re-ingested through ``ServingEngine.resume_inflight``. A draining or
  overloaded replica answers 429 + ``Retry-After: 0``. The
  :data:`~tpu_task_torch.obs.SLA_HEADER` (class and remaining-ms deadline)
  and :data:`~tpu_task_torch.obs.TRACE_HEADER` ride into the engine.
* ``GET /stream?rid=&offset=&wait_ms=`` — long-poll (``wait_ms`` capped at
  2000) for tokens past ``offset``: ``{tokens, offset, status,
  draining}``. Offset-based delivery makes a router's retry and
  re-dispatch exactly-once.
* ``GET /poll`` · ``/stats`` · ``/healthz`` · ``/export`` · ``/obs`` ·
  ``/metrics`` (Prometheus text) · ``/profile?ms=`` (a ``torch.profiler``
  capture, :mod:`tpu_task_torch.ml.profiling`); ``POST /drain`` ·
  ``/degrade`` (``{"spec": bool}``) · ``/prefetch`` (a published chain
  into the local prefix cache) · ``/adapter`` (``{adapter_id, layers,
  scale?}``: registers a LoRA adapter and answers its content hash, the
  JAX replica's body; 400 on an engine with ``lora_rank`` 0). A
  ``/submit`` body's ``adapter_id`` decodes its stream under that
  adapter.

Graceful drain (SIGTERM, the preemption notice): stop admitting, finish
the step in flight, export every unfinished request to ``--drain-file``
(tmp + ``os.replace``), and keep answering ``/stream`` with ``draining:
true`` so the router re-dispatches mid-stream requests to a sibling with
no token lost.

Weight roll (``--ckpt-dir``): the step loop polls the directory's
published step (``latest_step``) every ``ckpt_poll_s``, outside the
has-work gate, and rolls each step published after boot into the engine
with ``ServingEngine.adopt_params``: in-flight streams finish under the
weights they started with, new admissions take the new ones, nothing
drains. A reader thread loads the checkpoint into host memory off the
lock; the step loop then copies it to the device and adopts it under the
lock, so the streams stall for the copy, not for the file read. A torn or
unreadable checkpoint is a skipped beat (``replica.errors``), retried at
the next poll. The engine's ``param_loader`` restores a checkpoint step
that a resumed record pins and the engine no longer holds. ``/healthz``
and ``endpoint.json`` carry the active generation.

The step loop, the HTTP handler threads, the ship thread and the SIGTERM
path share the engine under one lock, as in the JAX replica, but one that
hands itself to its waiters in arrival order (:class:`FairLock`): with
CPython 3.12's ``threading.Lock`` the step loop takes the lock straight
back after every step, so a busy replica's ``/stream`` polls, ``/drain``
and SIGTERM wait until its queue is empty. On a CUDA device the order of
their device work is explicit: the step loop and ``/prefetch`` run on one
stream (the engine's, taken at construction), and each staged publish
batch carries an event that the ship thread waits on before it reads the
copies back.

``--tp N --ep M`` make the replica a gang of ``N × M`` ranks sharing one
engine (:mod:`tpu_task_torch.ml.parallel.gang`): this process is rank 0,
owns the engine and the HTTP front end, and starts the ``N × M − 1``
follower processes itself, on the same device; they exit when the
replica stops or is killed. The ``moe`` preset serves on one device
through the dense expert dispatch and at ``--ep`` > 1 through the
expert-parallel one. Not ported, refused at argv time and naming its
item: object-store ``--kv-bucket`` strings (A11c).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import queue
import signal
import sys
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlsplit

import torch

from tpu_task_torch.device import resolve_device
from tpu_task_torch.ml import random as jrandom
from tpu_task_torch.ml.checkpoint import latest_step, restore_checkpoint
from tpu_task_torch.ml.models import transformer
from tpu_task_torch.ml.parallel import gang
from tpu_task_torch.ml.serving.cache import ServingConfig
from tpu_task_torch.ml.serving.engine import ServingEngine
from tpu_task_torch.obs import (
    SLA_HEADER,
    TRACE_HEADER,
    Obs,
    TraceContext,
    parse_sla_header,
)

__all__ = ["MODEL_PRESETS", "SERVING_PRESETS", "FairLock", "ReplicaServer",
           "build_engine", "main"]

#: (TransformerConfig kwargs, init seed) per preset name — the JAX
#: package's presets, so the same name serves the same geometry.
MODEL_PRESETS: Dict[str, dict] = {
    "tiny": dict(seed=0, vocab_size=256, d_model=128, n_layers=2, n_heads=8,
                 d_head=16, d_ff=256, n_kv_heads=4),
    "micro": dict(seed=0, vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                  d_head=8, d_ff=64, n_kv_heads=2),
    # Mixture-of-experts: 4 experts, top-1, on every second layer.
    "moe": dict(seed=0, vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                d_head=8, d_ff=64, n_kv_heads=4, moe_every=2, n_experts=4),
}

#: ServingConfig defaults per preset — overridable via ``serving=``.
SERVING_PRESETS: Dict[str, dict] = {
    "tiny": dict(slots=4, block_size=8, n_blocks=96, max_len=128),
    "micro": dict(slots=4, block_size=4, n_blocks=64, max_len=48),
    "moe": dict(slots=4, block_size=4, n_blocks=64, max_len=48),
}


def build_engine(preset: str = "tiny", serving: Optional[dict] = None,
                 rng_seed: int = 0, device=None, obs: Optional[Obs] = None,
                 kv_client=None, tp: int = 1, ep: int = 1) -> ServingEngine:
    """A ServingEngine from a preset name: same name → same weights, same
    config, same streams, in any process and in either package. Weights
    are the JAX package's, bit for bit: ``init_from_key`` draws them at
    fp32 from ``PRNGKey(seed)`` of the preset's seed on the CPU (so they
    are the same on every device) and the engine moves them to ``device``
    — CUDA unless the caller passes ``device="cpu"``. ``obs`` the
    replica's tracer and registry (None = nothing recorded); ``kv_client``
    a :class:`~tpu_task_torch.serve.kvfleet.FleetKvClient` for fleet-wide
    prefix-cache sharing (None = replica-local cache only). ``tp``/``ep``
    > 1 make the engine rank 0 of a gang of ``tp × ep`` ranks over a
    ``("tp", "ep")`` mesh (:func:`tpu_task_torch.ml.parallel.gang.start`,
    the other ranks new processes on the same device); the engine's
    ``mesh.gang`` is the handle that stops them."""
    if preset not in MODEL_PRESETS:
        raise ValueError(
            f"unknown model preset {preset!r}; have {sorted(MODEL_PRESETS)}")
    spec = dict(MODEL_PRESETS[preset])
    device = resolve_device(device)
    seed = spec.pop("seed")
    cfg = transformer.TransformerConfig(dtype=torch.float32, **spec)
    params = transformer.init_from_key(jrandom.PRNGKey(seed), cfg)
    knobs = dict(SERVING_PRESETS[preset])
    knobs.update(serving or {})
    scfg = ServingConfig(**knobs)
    if tp * ep == 1:
        return ServingEngine(params, cfg, scfg,
                             rng=jrandom.PRNGKey(rng_seed), device=device,
                             kv_fleet=kv_client, obs=obs)
    mesh = gang.start(tp, ep, device=device)
    try:
        return ServingEngine(params, cfg, scfg,
                             rng=jrandom.PRNGKey(rng_seed),
                             kv_fleet=kv_client, obs=obs, mesh=mesh)
    except BaseException:
        mesh.gang.close()
        raise


class FairLock:
    """A mutual-exclusion lock that a release hands to the longest waiter.

    CPython 3.12's ``threading.Lock`` wakes a waiter on release but lets
    the releasing thread take the lock again first, and the replica's step
    loop does so between every two steps: a handler (or the SIGTERM path)
    can wait for the whole backlog. Here a contended acquire queues its own
    gate, and a release opens the oldest gate instead of freeing the
    lock."""

    def __init__(self):
        self._mutex = threading.Lock()
        self._held = False
        self._gates: collections.deque = collections.deque()

    def acquire(self) -> None:
        with self._mutex:
            if not self._held:
                self._held = True
                return
            gate = threading.Lock()
            gate.acquire()
            self._gates.append(gate)
        gate.acquire()                # opened by the release that hands over

    def release(self) -> None:
        with self._mutex:
            if not self._held:
                raise RuntimeError("release of an unheld FairLock")
            if self._gates:
                self._gates.popleft().release()   # stays held: handed over
            else:
                self._held = False

    def __enter__(self) -> "FairLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class _JSONHandler(BaseHTTPRequestHandler):
    """Keep-alive JSON endpoints over the replica's engine."""

    protocol_version = "HTTP/1.1"
    # Nagle + delayed ACK cost ~40 ms a request on kept-alive sockets;
    # token streaming would feel every one.
    disable_nagle_algorithm = True
    server: "_Server"

    def log_message(self, *args) -> None:  # keep test output clean
        pass

    def _reply(self, payload: dict, status: int = 200,
               headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        try:
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            # The client (or this server, mid-teardown) dropped the socket
            # during a long-poll: offset-based pulls make a lost response
            # free to lose.
            self.close_connection = True

    def _reply_text(self, body: str, status: int = 200) -> None:
        raw = body.encode()
        try:
            self.send_response(status)
            # The Prometheus text-exposition content type.
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)
        except OSError:
            self.close_connection = True

    def _query(self) -> dict:
        return {k: v[-1] for k, v in
                parse_qs(urlsplit(self.path).query).items()}

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        replica = self.server.replica
        path = urlsplit(self.path).path
        try:
            if path == "/healthz":
                self._reply(replica.health())
            elif path == "/metrics":
                self._reply_text(replica.metrics_text())
            elif path == "/profile":
                result = replica.profile(
                    int(self._query().get("ms", 500)))
                if result is None:
                    self._reply({"error": "a profiler capture is already "
                                          "running"}, 409)
                else:
                    self._reply(result)
            elif path == "/stats":
                self._reply(replica.stats())
            elif path == "/poll":
                self._reply(replica.poll(int(self._query()["rid"])))
            elif path == "/export":
                self._reply({"inflight": replica.exported()})
            elif path == "/obs":
                self._reply(replica.obs_snapshot(
                    drain=self._query().get("drain") == "1"))
            elif path == "/stream":
                query = self._query()
                self._reply(replica.stream(
                    int(query["rid"]), int(query.get("offset", 0)),
                    wait_ms=min(int(query.get("wait_ms", 0)), 2000)))
            else:
                self._reply({"error": f"no such path {path!r}"}, 404)
        except KeyError as error:
            self._reply({"error": f"unknown rid {error}"}, 404)
        except Exception as error:  # surface, never hang the socket
            replica.note_error(path, error)
            self._reply({"error": repr(error)}, 500)

    def do_POST(self) -> None:  # noqa: N802
        replica = self.server.replica
        path = urlsplit(self.path).path
        length = int(self.headers.get("Content-Length") or 0)
        # The router's dispatch-span context: the parent of every engine
        # span this request produces here.
        trace = TraceContext.from_header(self.headers.get(TRACE_HEADER))
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
            if path == "/submit":
                if replica.draining:
                    # 429 + Retry-After: 0: the transport's one paced
                    # retry fires at once, then the router reads the
                    # draining body and picks a sibling without
                    # quarantining a healthy server.
                    self._reply({"error": "draining", "draining": True},
                                429, headers={"Retry-After": "0"})
                    return
                if replica.overloaded():
                    # Healthy and full: the router tries siblings (or
                    # sheds an expired deadline); being busy is no fault.
                    self._reply({"error": "overloaded",
                                 "overloaded": True},
                                429, headers={"Retry-After": "0"})
                    return
                raw_sla = self.headers.get(SLA_HEADER)
                sla = None if raw_sla is None else parse_sla_header(raw_sla)
                self._reply({"rid": replica.submit(payload, trace=trace,
                                                   sla=sla)})
            elif path == "/drain":
                replica.begin_drain()
                self._reply({"ok": True, "draining": True})
            elif path == "/degrade":
                self._reply(replica.degrade(payload))
            elif path == "/prefetch":
                self._reply({"imported": replica.prefetch(
                    payload.get("hashes") or [])})
            elif path == "/adapter":
                self._reply(replica.register_adapter(payload))
            else:
                self._reply({"error": f"no such path {path!r}"}, 404)
        except (KeyError, ValueError, TypeError) as error:
            # A malformed request (missing field, bad value) is the
            # client's error: 400, never a replica fault that would
            # quarantine a healthy server.
            self._reply({"error": repr(error)}, 400)
        except Exception as error:
            # A replica fault: an error span on the request's trace and
            # the replica.errors counter, besides the 500.
            replica.note_error(path, error, trace=trace)
            self._reply({"error": repr(error)}, 500)


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # socketserver's default listen backlog of 5 resets connections when
    # more clients connect at once than the accept thread takes in (16 on
    # the card, while the step loop holds the interpreter).
    request_queue_size = 128
    replica: "ReplicaServer"


class ReplicaServer:
    """Engine + step loop + HTTP front end, one lock around the engine.

    The engine's scheduler state is single-threaded by design: every
    front-end operation and every step-loop iteration runs under
    ``_lock``, a :class:`FairLock`. ``engine`` serves as given (its
    ``obs``, when it has one, becomes the replica's, so front end and
    engine share one registry); otherwise :func:`build_engine` makes one
    from ``preset`` on ``device`` — CUDA unless the caller passes
    ``device="cpu"``. ``ckpt_dir`` turns on the weight roll (the module
    docstring), polled every ``ckpt_poll_s`` seconds (at least 0.05)."""

    def __init__(self, engine=None, *, preset: str = "tiny",
                 serving: Optional[dict] = None, host: str = "127.0.0.1",
                 port: int = 0, drain_file: Optional[str] = None,
                 obs_enabled: bool = True, profile_dir: str = "profiles",
                 kv_client=None, kv_publish_every: int = 20,
                 tp: int = 1, ep: int = 1,
                 max_queue: Optional[int] = None, device=None,
                 ckpt_dir: Optional[str] = None, ckpt_poll_s: float = 0.5):
        self.boot_id = uuid.uuid4().hex[:12]
        self.obs = None
        if obs_enabled:
            self.obs = (getattr(engine, "obs", None)
                        or Obs.create(f"replica:{self.boot_id[:6]}"))
        #: Fleet KV plane handle: the step loop stages this engine's hot
        #: cached blocks after any step that retired a request and every
        #: ``kv_publish_every`` steps besides; the ship thread reads them
        #: back and uploads them.
        self.kv_client = kv_client
        self.kv_publish_every = max(1, kv_publish_every)
        self._steps_since_publish = 0
        #: Bounded: a full queue DROPS the batch (publish is best effort;
        #: unshipped blocks re-offer on a later beat), so a slow bucket
        #: never holds back the step loop.
        self._ship_queue: "queue.Queue[tuple]" = queue.Queue(maxsize=8)
        self.ship_drops = 0
        self._ship_thread: Optional[threading.Thread] = None
        # "max_queue" may ride the serving dict: a front-end knob, not a
        # ServingConfig field.
        serving = dict(serving or {})
        if max_queue is None:
            max_queue = serving.pop("max_queue", None)
        else:
            serving.pop("max_queue", None)
        self.engine = engine if engine is not None else build_engine(
            preset, serving, device=device, obs=self.obs,
            kv_client=kv_client, tp=tp, ep=ep)
        #: The stream the step loop and /prefetch run on (the engine's
        #: device work stays in one order); None on the CPU.
        self._stream = (torch.cuda.current_stream(self.engine.device)
                        if self.engine.device.type == "cuda" else None)
        #: The weight roll: the step published at boot is the baseline
        #: (the engine's own weights are generation 0); each later one
        #: rolls in. ``rolls`` records each roll's step and generation,
        #: its read off the lock and its adopt under the lock in seconds,
        #: and its ``time.monotonic()``.
        self.ckpt_dir = ckpt_dir
        self.ckpt_poll_s = max(0.05, float(ckpt_poll_s))
        self._ckpt_next_poll = 0.0
        self._ckpt_step: Optional[int] = None
        self._ckpt_read: Optional[dict] = None
        self.rolls: list = []
        if ckpt_dir is not None:
            self._ckpt_step = latest_step(ckpt_dir)
            self.engine.param_loader = self._load_generation
        self.draining = False
        #: With this many requests waiting in the engine's queue, /submit
        #: answers 429 (None = unbounded).
        self.max_queue = max_queue
        self.drain_file = drain_file
        self.profile_dir = profile_dir
        #: The traceback of the exception that ended the step loop, if
        #: one did (it drains the replica instead of wedging it).
        self.step_error: Optional[str] = None
        self._profile_thread: Optional[threading.Thread] = None
        #: Set by a profiler capture: the step loop hands itself to a new
        #: thread at its next step boundary and sets the event.
        self._handover: Optional[threading.Event] = None
        self._lock = FairLock()
        self._stop = threading.Event()
        self._exported: Optional[list] = None
        self._server = _Server((host, port), _JSONHandler)
        self._server.replica = self
        self.port = self._server.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._step_thread = threading.Thread(target=self._step_loop,
                                             daemon=True)
        self._threads = [
            threading.Thread(target=self._server.serve_forever,
                             kwargs={"poll_interval": 0.05}, daemon=True),
            self._step_thread,
        ]
        if kv_client is not None:
            self._ship_thread = threading.Thread(
                target=self._ship_loop, daemon=True)
            self._threads.append(self._ship_thread)
            if self.obs is not None:
                self.obs.metrics.gauge_fn(
                    "kvfleet.ship_queue_depth",
                    lambda q=self._ship_queue: float(q.qsize()))
                self.obs.metrics.counter_fn(
                    "kvfleet.ship_drops",
                    lambda self=self: float(self.ship_drops))
        self._started = False

    # -- lifecycle -------------------------------------------------------------
    def start(self) -> "ReplicaServer":
        if not self._started:
            self._started = True
            for thread in self._threads:
                thread.start()
        return self

    def stop(self) -> None:
        """Tear the replica down (hard unless :meth:`begin_drain` ran
        first). A client's keep-alive pool that may hold sockets to this
        port is the client's to purge."""
        self._stop.set()
        if self._ship_thread is not None and self._ship_thread.is_alive():
            # The uploader empties its queue after the stop flag: staged
            # batches that made it in are shipped, not dropped.
            self._ship_thread.join(timeout=5.0)
        if self._started:
            # shutdown() waits for serve_forever, which only start() runs.
            self._server.shutdown()
        self._server.server_close()
        # A gang's followers stop with the replica.
        gang_handle = getattr(getattr(self.engine, "mesh", None), "gang",
                              None)
        if gang_handle is not None:
            gang_handle.close()

    def _on_engine_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _step_loop(self, started: Optional[threading.Event] = None) -> None:
        """Step the engine while it has work; ``started`` is set once this
        thread runs (a hand-over, :meth:`_hand_over_step_loop`)."""
        with self._on_engine_stream():
            if started is not None:
                started.set()
            while not self._stop.is_set():
                stepped = False
                staged = None
                try:
                    with self._lock:
                        if self._handover is not None:
                            # A capture wants the launching thread to
                            # start inside it: hand over at this boundary.
                            self._step_thread = threading.Thread(
                                target=self._step_loop,
                                args=(self._handover,), daemon=True)
                            self._handover = None
                            self._step_thread.start()
                            return
                        if self.ckpt_dir is not None:
                            # The roll's beat, outside the has-work gate:
                            # an idle replica rolls too.
                            self._poll_checkpoint()
                        if not self.draining and self.engine.has_work:
                            result = self.engine.step()
                            stepped = True
                            if self.kv_client is not None:
                                self._steps_since_publish += 1
                                if result["finished"] or \
                                        self._steps_since_publish \
                                        >= self.kv_publish_every:
                                    self._steps_since_publish = 0
                                    staged = self._stage()
                    if staged:
                        try:
                            self._ship_queue.put_nowait(staged)
                        except queue.Full:
                            self.ship_drops += 1
                except Exception as error:
                    # A dying step loop must never wedge the replica
                    # silently (healthz green, streams empty forever):
                    # drain instead, so the router fails the open streams
                    # over to a sibling. The request records the export
                    # reads are host state, intact even when a device step
                    # blew up.
                    self.step_error = traceback.format_exc()
                    print(self.step_error, file=sys.stderr, flush=True)
                    self.note_error("step_loop", error)
                    self.begin_drain()
                    return
                if not stepped:
                    time.sleep(0.002)

    def _hand_over_step_loop(self) -> None:
        """Called by a profiler capture once it records: the running step
        loop exits at its next step boundary and a new thread, started
        inside the capture, takes over with the same stream (graphs
        captured on the old thread replay from the new one). torch's
        profiler can drop every kernel record of a capture whose kernels
        come from a thread that launched before it started. Returns once
        the new thread runs, or at once when no step loop runs."""
        if not self._started or self._stop.is_set() \
                or not self._step_thread.is_alive():
            return
        started = threading.Event()
        self._handover = started
        started.wait(5.0)

    # -- the weight roll -------------------------------------------------------
    def _poll_checkpoint(self) -> None:
        """One beat of the roll (the step loop, under the lock): adopt a
        checkpoint the reader thread has loaded, or, every
        ``ckpt_poll_s``, start reading a step published since the last
        roll."""
        read = self._ckpt_read
        if read is not None:
            if read["done"].is_set():
                self._ckpt_read = None
                if read["params"] is not None:
                    self._adopt_checkpoint(read)
            return
        now = time.monotonic()
        if now < self._ckpt_next_poll:
            return
        self._ckpt_next_poll = now + self.ckpt_poll_s
        try:
            step = latest_step(self.ckpt_dir)
        except OSError:
            return
        if step is None or (self._ckpt_step is not None
                            and step <= self._ckpt_step):
            return
        # Host tensors of the params' shapes and dtypes: the template the
        # reader restores into, which no device copy follows.
        template = transformer.map_params(
            lambda v: torch.empty((), dtype=v.dtype).expand(v.shape),
            self.engine.params)
        read = {"step": step, "params": None, "done": threading.Event()}
        self._ckpt_read = read
        threading.Thread(target=self._read_checkpoint, args=(read, template),
                         daemon=True).start()

    def _read_checkpoint(self, read: dict, template) -> None:
        """The reader thread: one published step into host memory. A
        failure is a skipped beat with a ``replica.errors`` record."""
        t0 = time.perf_counter()
        try:
            read["params"] = restore_checkpoint(self.ckpt_dir, template,
                                                step=read["step"])
        except Exception as error:   # a torn or foreign file: retry later
            self.note_error("ckpt_poll", error)
        finally:
            read["read_s"] = time.perf_counter() - t0
            read["done"].set()

    def _adopt_checkpoint(self, read: dict) -> None:
        """Copy a loaded step to the device and adopt it (the step loop,
        under the lock): the generation is the step when it grows."""
        t0 = time.perf_counter()
        step = read["step"]
        generation = self.engine.adopt_params(
            read["params"],
            generation=step if step > self.engine.generation else None)
        if self._stream is not None:
            self._stream.synchronize()
        self._ckpt_step = step
        self.rolls.append({"step": step, "generation": generation,
                           "read_s": read["read_s"],
                           "adopt_s": time.perf_counter() - t0,
                           "at": time.monotonic()})
        if self.obs is not None:
            self.obs.metrics.counter("replica.param_rolls").inc()

    def _load_generation(self, generation: int):
        """The engine's ``param_loader``: the checkpoint step a resumed
        record pins, restored onto the engine's device, or None when it
        cannot be read (the engine then refuses the record)."""
        try:
            with self._on_engine_stream():
                return restore_checkpoint(self.ckpt_dir, self.engine.params,
                                          step=int(generation))
        except (OSError, ValueError, KeyError):
            return None

    def _stage(self) -> Optional[tuple]:
        """The publish beat's non-blocking half (caller holds the lock):
        device copies of the unpublished hot blocks and, on a CUDA
        device, an event recorded behind them for the ship thread."""
        staged = self.kv_client.stage(self.engine)
        if not staged:
            return None
        event = None
        if self._stream is not None:
            event = torch.cuda.Event()
            event.record(self._stream)
        return staged, event

    def _ship_loop(self) -> None:
        """The uploader: pulls staged batches off the bounded queue, waits
        for their copies, reads them back and uploads them. Runs until
        the stop flag is set and the queue is empty; a failed upload is
        dropped (the blocks re-offer on a later beat)."""
        while True:
            try:
                staged, event = self._ship_queue.get(timeout=0.05)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if event is not None:
                event.synchronize()
            try:
                self.kv_client.ship(staged)
            except OSError:
                pass

    # -- observability ---------------------------------------------------------
    def note_error(self, where: str, error: Exception,
                   trace: Optional[TraceContext] = None) -> None:
        """An ``status=error`` span on the request's trace (or a fresh
        one) and the ``replica.errors`` counters."""
        if self.obs is None:
            return
        self.obs.metrics.counter("replica.errors").inc()
        self.obs.metrics.counter(f"replica.errors.{where.strip('/')}").inc()
        self.obs.tracer.error("replica.error", error, parent=trace,
                              path=where, boot_id=self.boot_id)

    def health(self) -> dict:
        """``/healthz``: the process answers, whether it drains, and the
        open-work depth."""
        with self._lock:
            return {"ok": True, "boot_id": self.boot_id,
                    "draining": self.draining,
                    "queue_depth": self.engine.queue_depth
                    + self.engine.n_active,
                    "generation": getattr(self.engine, "generation", 0)}

    def metrics_text(self) -> str:
        """``GET /metrics``: the replica's registry (front end and engine
        share one) in Prometheus text exposition."""
        if self.obs is None:
            return "# obs disabled (--no-obs)\n"
        from tpu_task_torch.obs import prometheus_text

        return prometheus_text(self.obs.metrics.snapshot())

    def profile(self, ms: int) -> Optional[dict]:
        """Start a ``ms``-millisecond profiler capture on a worker thread
        (the step loop never waits); its Chrome trace lands under
        ``profile_dir``. The profiler starts and stops under the engine
        lock, between two steps; once it records, the step loop moves to a
        new thread (:meth:`_hand_over_step_loop`), and the ``ms`` window
        starts after that. None when a capture is already running
        (409)."""
        from tpu_task_torch.ml import profiling

        # The reservation is taken here, on the handler thread: of two
        # racing requests exactly one wins.
        if not profiling.acquire_capture():
            return None
        ms = max(10, min(int(ms), 60_000))
        out_dir = os.path.abspath(os.path.join(
            self.profile_dir, f"capture-{int(time.time() * 1000)}"))

        def run() -> None:
            try:
                profiling.capture_reserved(
                    out_dir, ms / 1000.0, self.engine.device,
                    on_start=self._hand_over_step_loop, hold=self._lock)
            except Exception as error:   # no CUDA tracing in this build
                self.note_error("/profile", error)

        self._profile_thread = threading.Thread(target=run, daemon=True)
        self._profile_thread.start()
        return {"ok": True, "dir": out_dir, "ms": ms}

    def obs_snapshot(self, drain: bool = False) -> dict:
        """``/obs``: finished spans (``drain=1`` clears the ring) and the
        registry snapshot; empty when obs is off."""
        if self.obs is None:
            return {"spans": [], "metrics": {}, "source": self.boot_id}
        spans = self.obs.tracer.drain() if drain \
            else self.obs.tracer.finished()
        return {"spans": [span.to_json() for span in spans],
                "metrics": self.obs.metrics.snapshot(),
                "source": self.boot_id}

    # -- front-end operations (handler-called, self-locking) -------------------
    def overloaded(self) -> bool:
        """The engine's wait queue at or over ``max_queue``."""
        if self.max_queue is None:
            return False
        with self._lock:
            return self.engine.queue_depth >= self.max_queue

    def degrade(self, payload: dict) -> dict:
        """``POST /degrade``: the router's brownout knob, ``{"spec":
        bool}``, toggling speculative decoding engine-wide."""
        with self._lock:
            if "spec" in payload:
                self.engine.spec_enabled = bool(payload["spec"])
            return {"ok": True, "spec": bool(self.engine.spec_enabled)}

    def register_adapter(self, payload: dict) -> dict:
        """``POST /adapter``: register a tenant's LoRA adapter,
        ``{"adapter_id": ..., "layers": [{"a": [[...]], "b": [[...]]}, ...],
        "scale": ...}``, and answer its content hash, as a JAX replica
        does, so a router can check that every replica holds the same
        bytes. An engine with ``lora_rank`` 0 raises ValueError: 400."""
        adapter_id = str(payload["adapter_id"])
        layers = payload["layers"]
        with self._lock:
            content = self.engine.register_adapter(
                adapter_id, layers, scale=float(payload.get("scale", 1.0)))
        if self.obs is not None:
            self.obs.metrics.counter("replica.adapters_registered").inc()
        return {"ok": True, "adapter_id": adapter_id, "hash": content}

    def submit(self, payload: dict,
               trace: Optional[TraceContext] = None, sla=None) -> int:
        prompt = [int(t) for t in payload["prompt"]]
        slo_class, remaining_ms = sla if sla is not None else (None, None)
        deadline_s = None if remaining_ms is None else remaining_ms / 1000.0
        kwargs = dict(
            temperature=float(payload.get("temperature", 0.0)),
            top_p=payload.get("top_p"),
            eos_token=payload.get("eos_token"))
        if kwargs["top_p"] is not None:
            kwargs["top_p"] = float(kwargs["top_p"])
        if kwargs["eos_token"] is not None:
            kwargs["eos_token"] = int(kwargs["eos_token"])
        key = payload.get("key")
        adapter_id = payload.get("adapter_id")
        tokens = [int(t) for t in payload.get("tokens") or ()]
        with self._lock:
            if tokens:
                # A re-dispatch after a sibling's preemption: the emitted
                # prefix is context to re-ingest, and the ORIGINAL key
                # keeps the continuation token-identical.
                if key is None:
                    raise ValueError("a resumed dispatch (tokens) needs "
                                     "its original sampling key")
                record = {
                    "prompt": prompt, "tokens": tokens, "key": list(key),
                    "max_new_tokens": int(payload["max_new_tokens"]),
                    "temperature": kwargs["temperature"],
                    "top_p": 1.0 if kwargs["top_p"] is None
                    else kwargs["top_p"],
                    "eos_token": kwargs["eos_token"],
                }
                if slo_class is not None:
                    record["slo_class"] = slo_class
                if deadline_s is not None:
                    record["deadline_s"] = deadline_s
                if adapter_id is not None:
                    record["adapter_id"] = str(adapter_id)
                if payload.get("generation") is not None:
                    record["generation"] = int(payload["generation"])
                return next(iter(self.engine.resume_inflight(
                    [record], trace=trace).values()))
            # A fresh dispatch goes through submit and all its argument
            # checks (the key's shape too): a malformed request must 400,
            # never fail later inside the step loop.
            if key is not None:
                kwargs["key"] = key
            if slo_class is not None:
                kwargs["slo_class"] = slo_class
            if deadline_s is not None:
                kwargs["deadline_s"] = deadline_s
            if adapter_id is not None:
                kwargs["adapter_id"] = str(adapter_id)
            return self.engine.submit(
                prompt, int(payload["max_new_tokens"]), trace=trace,
                **kwargs)

    def poll(self, rid: int) -> dict:
        with self._lock:
            out = self.engine.poll(rid)
        out["draining"] = self.draining
        return out

    def stream(self, rid: int, offset: int, wait_ms: int = 0) -> dict:
        """Tokens past ``offset``, long-polling up to ``wait_ms`` for the
        first new one; whatever is there once draining starts."""
        deadline = time.monotonic() + wait_ms / 1000.0
        while True:
            with self._lock:
                out = self.engine.poll(rid)
            if len(out["tokens"]) > offset or out["status"] == "done" \
                    or self.draining or time.monotonic() >= deadline:
                return {"tokens": out["tokens"][offset:],
                        "offset": offset, "status": out["status"],
                        "draining": self.draining}
            time.sleep(0.002)

    def prefetch(self, hashes) -> int:
        """``POST /prefetch``: pull a chain (hex hashes,
        leading-consecutive) into the local prefix cache before the next
        turn arrives: from the engine's host tier first (``--serving
        '{"host_offload_blocks": N}'``, which warms the pool from host RAM
        with no ``--kv-bucket``), then from the fleet bucket. Best effort:
        malformed hashes, and engines with neither a host tier nor a fleet
        client, import 0, never an error."""
        try:
            chain = [bytes.fromhex(str(h)) for h in hashes]
        except ValueError:
            return 0
        with self._lock, self._on_engine_stream():
            return self.engine.prefetch_chain(chain)

    def stats(self) -> dict:
        with self._lock:
            stats = self.engine.stats()
            stats.update({
                "slots": self.engine.scfg.slots,
                "active": self.engine.n_active,
                "queued": self.engine.queue_depth,
                "draining": self.draining,
                "spec_enabled": bool(
                    getattr(self.engine, "spec_enabled", True)),
                "boot_id": self.boot_id,
            })
        return stats

    # -- graceful drain --------------------------------------------------------
    def begin_drain(self) -> list:
        """Stop admitting, let the step in flight finish (the step loop
        checks ``draining`` under the lock), export every unfinished
        request, and write the export to ``drain_file``. Idempotent: the
        export is frozen on the first call."""
        with self._lock:
            if self._exported is None:
                self.draining = True
                self._exported = self.engine.export_inflight()
                if self.drain_file:
                    tmp = f"{self.drain_file}.tmp"
                    with open(tmp, "w") as handle:
                        json.dump({"boot_id": self.boot_id,
                                   "inflight": self._exported}, handle)
                    os.replace(tmp, self.drain_file)
            return list(self._exported)

    def exported(self) -> list:
        with self._lock:
            return list(self._exported or [])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--preset", default="tiny",
                        choices=sorted(MODEL_PRESETS))
    parser.add_argument("--serving", default="{}",
                        help="JSON ServingConfig overrides")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--endpoint-file", default="endpoint.json",
                        help="where to announce {url, boot_id} (relative "
                             "to the working directory)")
    parser.add_argument("--drain-file", default="inflight.json",
                        help="graceful-drain export destination")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel width of this replica's mesh "
                             "(the gang's tp*ep ranks share ONE engine)")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel width (MoE presets: expert "
                             "weights shard one group per ep shard)")
    parser.add_argument("--no-obs", action="store_true",
                        help="disable tracing and metrics")
    parser.add_argument("--kv-bucket", default="",
                        help="shared local directory of the fleet KV plane "
                             "(object-store strings are ROADMAP A11c)")
    parser.add_argument("--ckpt-dir", default="",
                        help="checkpoint directory to poll: each step "
                             "published after boot rolls into the engine "
                             "without a drain (in-flight streams finish "
                             "under their generation)")
    parser.add_argument("--device", default="cuda",
                        help="torch device the engine runs on (the card "
                             "unless 'cpu')")
    args = parser.parse_args(argv)

    from tpu_task_torch.storage.backends import open_backend

    try:
        kv_client = None
        if args.kv_bucket:
            from tpu_task_torch.serve.kvfleet import FleetKvClient

            kv_client = FleetKvClient(open_backend(args.kv_bucket),
                                      source=uuid.uuid4().hex[:12])
        replica = ReplicaServer(
            preset=args.preset, serving=json.loads(args.serving),
            host=args.host, port=args.port,
            drain_file=os.path.abspath(args.drain_file),
            obs_enabled=not args.no_obs, kv_client=kv_client,
            tp=args.tp, ep=args.ep, device=args.device,
            ckpt_dir=args.ckpt_dir or None)
    except NotImplementedError as error:
        parser.error(str(error))
    replica.start()

    # Durable observability export: spans and metrics land under obs/ in
    # the working directory.
    exporter = obs_backend = None
    if replica.obs is not None:
        from tpu_task_torch.obs import SpanExporter, export_metrics

        obs_backend = open_backend(os.getcwd())
        exporter = SpanExporter(obs_backend)
    pending: list = []                    # drained-but-unwritten spans

    def flush_obs() -> None:
        if exporter is None:
            return
        # Drain into a local batch before writing: a failed write keeps
        # the spans for the next beat.
        pending.extend(replica.obs.tracer.drain())
        try:
            if pending:
                exporter.export(list(pending), source=replica.boot_id)
                pending.clear()
            export_metrics(obs_backend, replica.obs.metrics.snapshot(),
                           source=replica.boot_id)
        except OSError:
            pass

    done = threading.Event()

    def on_sigterm(_signum, _frame):
        # The preemption notice: drain and export, then exit 0.
        replica.begin_drain()
        done.set()

    signal.signal(signal.SIGTERM, on_sigterm)
    signal.signal(signal.SIGINT, on_sigterm)

    def write_endpoint() -> int:
        # The active generation rides the announcement; the beat below
        # rewrites it when a published checkpoint rolls in.
        generation = replica.engine.generation
        with open(args.endpoint_file + ".tmp", "w") as handle:
            json.dump({"url": replica.url, "boot_id": replica.boot_id,
                       "preset": args.preset, "pid": os.getpid(),
                       "generation": generation}, handle)
        os.replace(args.endpoint_file + ".tmp", args.endpoint_file)
        return generation

    announced = write_endpoint()
    print(f"replica serving on {replica.url} (boot {replica.boot_id})",
          flush=True)

    parent = os.getppid()
    beats = 0
    while not done.wait(0.2):
        # Orphaned (the supervising process died): drain and exit rather
        # than serve forever as a leak.
        if os.getppid() != parent:
            replica.begin_drain()
            break
        beats += 1
        if replica.engine.generation != announced:
            announced = write_endpoint()
        if beats % 10 == 0:               # ~every 2 s
            flush_obs()
    # A brief linger so the router can fetch the draining suffix and the
    # export before the socket disappears.
    time.sleep(float(os.environ.get("TPU_TASK_SERVE_LINGER", "1.0")))
    flush_obs()                           # drain/export spans included
    replica.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
