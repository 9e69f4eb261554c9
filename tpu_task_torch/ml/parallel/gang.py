"""A gang of ranks serving one engine: start and join the followers,
broadcast each program call, the collectives on each mesh axis, and
teardown — the port's counterpart of ``sharding.compile_step``'s sharded
modes.

JAX's multi-chip engine is one controller over many devices: the
scheduler, tables, prefix cache and sampling live in one process and only
the fused programs run SPMD. The port keeps that shape with one process a
mesh position:

- **Rank 0 is the engine.** It owns every host structure, exactly as on
  one device, and its :class:`Gang` handle starts the other ranks
  (:func:`start`).
- **Ranks 1..N-1 are followers** (:func:`follower_main`). Each holds only
  its shard of the params and pools. A function marked :func:`program`
  and called on rank 0 with the gang's mesh is sent to every follower
  first, by module and name with its arguments (tensors as host copies,
  rank 0's shard objects as :class:`Ref` keys); each rank then runs it on
  its own shard and they meet in its collectives.
- **Logits are whole on every rank** after the vocab all-gather, so every
  rank samples the same tokens; rank 0's are the ones the scheduler
  reads.

Control messages go over one local socket a follower (pickled, in
order); a follower that raises sends its traceback there and exits, and
rank 0 raises :class:`GangError` with it. A follower whose socket closes
(rank 0 stopped or was killed) exits. The collectives run on
``torch.distributed`` gloo groups, one a mesh axis (the mesh's
``DeviceMesh``), with a timeout, so a rank that dies cannot hang the
others for longer than that.

**The backend is gloo**, also on the card: NCCL does not put two ranks of
one communicator on one device, and a gang on one H100 runs every rank on
``cuda:0``, each in its own process and CUDA context. Gloo took each of
the three collectives used here (all-reduce, all-gather, all-to-all) as
CUDA tensors, float32 and bfloat16, on an H100 with torch 2.11 (cu128):
:data:`GLOO_CUDA_COLLECTIVES`; they live in
:mod:`~tpu_task_torch.ml.parallel.collectives`, with their gradients,
which the sharded train step shares. Gloo moves a CUDA tensor through host
memory itself, so the kernels run on the card on every rank and only the
ring between ranks goes through the host. A gang on one shared card
measures the gang's overhead, not tensor parallelism's speed."""

from __future__ import annotations

import contextlib
import datetime
import functools
import importlib
import json
from importlib import util as importlib_util
import os
import pickle
import secrets
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from multiprocessing.connection import Client, Listener
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from tpu_task_torch.ml.parallel.collectives import (  # noqa: F401
    GLOO_CUDA_COLLECTIVES,
    all_gather,
    all_reduce,
    all_to_all,
    collective_stats,
)
from tpu_task_torch.ml.parallel.mesh import Mesh, make_mesh

#: A gang's mesh axes: the engine, the model, the MoE layer and the pools
#: look each one up by this name.
AXES = ("tp", "ep")

#: Seconds a collective (and the process-group rendezvous) may wait.
DEFAULT_TIMEOUT_S = 300.0


class GangError(RuntimeError):
    """A follower failed (its traceback is in the message), or the gang
    is closed."""


# -- the program broadcast -----------------------------------------------------

@dataclass(frozen=True)
class Ref:
    """Stands in a message for an object each rank holds its own shard of
    (params, pools), by the key the gang stored it under."""

    key: str


class _Tensor:
    """A tensor in a message: its host copy, placed on the receiving
    rank's device."""

    def __init__(self, t: torch.Tensor):
        self.t = t.detach().cpu()


class _MeshMark:
    """The sending rank's mesh in a message: the receiver's own mesh."""


class _DeviceMark:
    """A ``torch.device`` in a message: the receiver's device."""


def program(fn: Callable) -> Callable:
    """Mark ``fn`` (which takes a ``mesh=`` keyword) as a gang program:
    called with a mesh that leads a gang, it runs on every follower too,
    each on its own shard. A program called from inside another runs
    locally only (the outer call was sent)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        mesh = kwargs.get("mesh")
        gang = getattr(mesh, "gang", None)
        if gang is None or gang.depth:
            return fn(*args, **kwargs)
        return gang.call(wrapper, args, kwargs)

    return wrapper


def _name(fn: Callable):
    """A function's address in a message: its module and qualified name;
    a script's function (module ``__main__``) by the script's path."""
    module = fn.__module__
    if module == "__main__":
        module = "file:" + os.path.abspath(sys.modules["__main__"].__file__)
    return module, fn.__qualname__


def _resolve(name: Sequence[str]) -> Callable:
    module, qualname = name
    if module.startswith("file:"):
        obj: Any = sys.modules.get(module)
        if obj is None:
            spec = importlib_util.spec_from_file_location(
                "__gang_main__", module[len("file:"):])
            obj = importlib_util.module_from_spec(spec)
            spec.loader.exec_module(obj)
            sys.modules[module] = obj
    else:
        obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


class Gang:
    """Rank 0's handle on a gang: the followers' processes and control
    sockets, and the registry of rank 0's shard objects by key."""

    def __init__(self, mesh: Mesh, procs: List[subprocess.Popen],
                 conns: list, workdir: Path, owns_workdir: bool):
        self.mesh = mesh
        self.procs, self.conns = procs, conns
        self.workdir, self._owns_workdir = workdir, owns_workdir
        self.depth = 0
        self.closed = False
        self._objs: Dict[str, Any] = {}
        self._ids: Dict[int, str] = {}
        self._pending_drops: List[str] = []
        self._namespaces = 0
        #: Messages sent by kind.
        self.sent: Dict[str, int] = {}

    # -- shard objects --------------------------------------------------------

    def namespace(self) -> str:
        """A fresh key prefix (one an engine)."""
        self._namespaces += 1
        return f"e{self._namespaces}"

    def share(self, key: str, obj):
        """Register rank 0's ``obj`` under ``key``: messages carry it as
        :class:`Ref` ``key``, which each follower reads as its own."""
        self._objs[key] = obj
        self._ids[id(obj)] = key
        return obj

    def release(self, prefix: str) -> None:
        """Forget every object under ``prefix`` on every rank, with the
        next message (safe to call from a finalizer)."""
        self._pending_drops.append(prefix)

    def _flush_drops(self) -> None:
        while self._pending_drops:
            prefix = self._pending_drops.pop()
            for key in [k for k in self._objs if k.startswith(prefix + "/")]:
                self._ids.pop(id(self._objs.pop(key)), None)
            self._send(("drop", prefix))

    # -- encoding -------------------------------------------------------------

    def _encode(self, value):
        key = self._ids.get(id(value))
        if key is not None:
            return Ref(key)
        if isinstance(value, torch.Tensor):
            return _Tensor(value)
        if value is self.mesh:
            return _MeshMark()
        if isinstance(value, torch.device):
            return _DeviceMark()
        if isinstance(value, dict):
            return {k: self._encode(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)) and not hasattr(value, "_fields"):
            return type(value)(self._encode(v) for v in value)
        return value

    # -- messages -------------------------------------------------------------

    def _check(self) -> None:
        """Raise a follower's reported failure, or a closed gang."""
        if self.closed:
            raise GangError("the gang is closed")
        for rank, conn in enumerate(self.conns, start=1):
            if conn.poll():
                self._fail(None, self._read(rank, conn))

    def _read(self, rank: int, conn):
        try:
            return pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            code = self.procs[rank - 1].poll()
            return ("error", rank, f"follower rank {rank} hung up "
                                   f"(exit code {code})")

    def _send(self, msg) -> None:
        data = pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)
        self.sent[msg[0]] = self.sent.get(msg[0], 0) + 1
        for conn in self.conns:
            conn.send_bytes(data)

    def _fail(self, error: Optional[BaseException], report=None):
        """Close the gang after a failure and raise: a follower's
        traceback when one reported (waiting briefly for it), else
        ``error``."""
        deadline = time.monotonic() + 5.0
        while report is None and time.monotonic() < deadline:
            for rank, conn in enumerate(self.conns, start=1):
                if conn.poll(0.05):
                    report = self._read(rank, conn)
                    break
            if report is None and all(p.poll() is not None
                                      for p in self.procs):
                break
        self.close(force=True)
        if report is not None and report[0] == "error":
            raise GangError(
                f"gang follower rank {report[1]} failed:\n{report[2]}"
            ) from error
        if error is not None:
            raise error
        raise GangError(f"unexpected gang message {report!r}")

    def _run(self, op: str, local: Callable, *payload):
        self._check()
        self._flush_drops()
        self._send((op, *payload))
        self.depth += 1
        try:
            return local()
        except GangError:
            raise
        except BaseException as error:      # noqa: BLE001 — re-raised
            self._fail(error)
        finally:
            self.depth -= 1

    def call(self, fn: Callable, args: tuple, kwargs: dict):
        """Run the program ``fn`` on every rank; rank 0's result."""
        name = _name(fn)
        return self._run("call", lambda: fn(*args, **kwargs), name,
                         self._encode(args), self._encode(kwargs))

    def make(self, key: str, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` on every rank (the gang's mesh and
        device read as each rank's own), each rank keeping its result
        under ``key``; rank 0's result, registered."""
        name = _name(fn)
        out = self._run("make", lambda: fn(*args, **kwargs), key, name,
                        self._encode(args), self._encode(kwargs))
        return self.share(key, out)

    def scatter(self, key: str, tree, pspec_tree):
        """Each rank's block of the full host ``tree`` under
        ``pspec_tree``, kept under ``key``: a follower's block is cut here
        and shipped, rank 0's placed on its device and registered."""
        from tpu_task_torch.ml.parallel.sharding import device_put_tree

        self._check()
        self._flush_drops()
        cpu = torch.device("cpu")
        for rank, conn in enumerate(self.conns, start=1):
            block = device_put_tree(tree, pspec_tree, self.mesh, rank=rank,
                                    device=cpu)
            conn.send_bytes(pickle.dumps(("put", key, block),
                                         protocol=pickle.HIGHEST_PROTOCOL))
        self.sent["put"] = self.sent.get("put", 0) + 1
        return self.share(key, device_put_tree(tree, pspec_tree, self.mesh))

    def query(self, fn: Callable, *args, **kwargs) -> list:
        """``fn(*args, **kwargs)`` on every rank: the results in rank
        order (they must pickle)."""
        name = _name(fn)
        mine = self._run("query", lambda: fn(*args, **kwargs), name,
                         self._encode(args), self._encode(kwargs))
        out = [mine]
        for rank, conn in enumerate(self.conns, start=1):
            reply = self._read(rank, conn)
            if reply[0] != "result":
                self._fail(None, reply)
            out.append(reply[1])
        return out

    def close(self, force: bool = False) -> None:
        """Stop the followers (``force``: at once) and leave the process
        group. Idempotent."""
        if self.closed:
            return
        self.closed = True
        if not force:
            with contextlib.suppress(OSError):
                self._send(("close",))
        for conn in self.conns:
            with contextlib.suppress(OSError):
                conn.close()
        for proc in self.procs:
            if force:
                proc.kill()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if dist.is_initialized():
            with contextlib.suppress(Exception):
                dist.destroy_process_group()
        self._objs.clear()
        self._ids.clear()
        if self._owns_workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)


def _repo_root() -> str:
    return str(Path(__file__).resolve().parents[3])


def _init_group(rank: int, world: int, init_method: str,
                timeout_s: float) -> None:
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))


def start(tp: int = 1, ep: int = 1, *, device=None, workdir=None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Start a gang of ``tp × ep`` ranks over a :data:`AXES` mesh on
    ``device`` — the card (``cuda:0``) unless the caller passes
    ``device="cpu"`` — and return rank 0's :class:`Mesh`, whose ``gang``
    is the handle. The followers (ranks 1..) are ``python -m
    tpu_task_torch.ml.parallel.follower`` processes of one torch thread
    each. The rendezvous is a file under ``workdir`` (a fresh temporary
    directory by default); the control sockets listen on localhost at a
    port the system picks. On the card, the paged kernels' libraries are
    built here before any follower starts. ``timeout_s`` bounds the
    rendezvous and every collective. A one-rank gang is a plain mesh with
    no process group. A process is rank 0 of one gang at a time."""
    from tpu_task_torch.device import resolve_device

    device = resolve_device(device)
    if tp * ep == 1:
        return Mesh((tp, ep), AXES, device=device)
    if dist.is_initialized():
        raise GangError("this process already holds a gang (a process "
                        "group): close it before starting another")
    if device.type == "cuda":
        device = torch.device("cuda", 0)
        from tpu_task_torch.ml.ops import _build

        _build.load("paged_decode")
        _build.load("paged_decode_pipelined")
    world = tp * ep
    owns = workdir is None
    workdir = Path(tempfile.mkdtemp(prefix="tt-gang-") if owns else workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    rendezvous = workdir / "rendezvous"
    rendezvous.unlink(missing_ok=True)
    authkey = secrets.token_bytes(16)
    listener = Listener(("127.0.0.1", 0), authkey=authkey)
    spec = {"world": world, "axis_sizes": [tp, ep], "device": str(device),
            "init_method": f"file://{rendezvous}",
            "control": list(listener.address), "authkey": authkey.hex(),
            "timeout_s": timeout_s}
    # A follower imports what this process imports: the port from its
    # checkout, and any module a program or query names from this
    # process's path.
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(
        [_repo_root()] + [p for p in sys.path if p and os.path.isdir(p)]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_task_torch.ml.parallel.follower",
         json.dumps({**spec, "rank": rank})], env=env)
        for rank in range(1, world)]
    try:
        _init_group(0, world, spec["init_method"], timeout_s)
        mesh = make_mesh(axis_names=AXES, axis_sizes=(tp, ep), device=device)
        conns: list = [None] * (world - 1)
        for _ in range(world - 1):
            conn = listener.accept()
            rank = pickle.loads(conn.recv_bytes())
            conns[rank - 1] = conn
    except BaseException:
        for proc in procs:
            proc.kill()
            proc.wait()
        raise
    finally:
        listener.close()
    mesh.gang = Gang(mesh, procs, conns, workdir, owns)
    return mesh


# -- the follower side ---------------------------------------------------------

def _decode(value, mesh: Mesh, state: Dict[str, Any]):
    if isinstance(value, Ref):
        return state[value.key]
    if isinstance(value, _Tensor):
        return value.t.to(mesh.device)
    if isinstance(value, _MeshMark):
        return mesh
    if isinstance(value, _DeviceMark):
        return mesh.device
    if isinstance(value, dict):
        return {k: _decode(v, mesh, state) for k, v in value.items()}
    if isinstance(value, (list, tuple)) and not hasattr(value, "_fields"):
        return type(value)(_decode(v, mesh, state) for v in value)
    return value


def _on_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_device(v, device) for v in tree)
    return tree


def serve(mesh: Mesh, conn) -> None:
    """A follower's loop: run each message from rank 0 until ``close`` or
    a closed socket; on an exception, report it and return."""
    state: Dict[str, Any] = {}
    while True:
        try:
            msg = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            return
        op = msg[0]
        try:
            if op == "close":
                return
            if op == "drop":
                for key in [k for k in state
                            if k.startswith(msg[1] + "/")]:
                    del state[key]
            elif op == "put":
                state[msg[1]] = _on_device(msg[2], mesh.device)
            else:
                if op == "make":
                    key, name, args, kwargs = msg[1:]
                else:
                    name, args, kwargs = msg[1:]
                out = _resolve(name)(*_decode(args, mesh, state),
                                     **_decode(kwargs, mesh, state))
                if op == "make":
                    state[key] = out
                elif op == "query":
                    conn.send_bytes(pickle.dumps(("result", out)))
                del out
        except BaseException:               # noqa: BLE001 — reported
            with contextlib.suppress(OSError):
                conn.send_bytes(pickle.dumps(
                    ("error", mesh.rank, traceback.format_exc())))
            raise


def follower_main(spec: dict) -> int:
    """Entry of a follower process (``spec`` as :func:`start` writes it):
    join the process group and the mesh, connect to rank 0's control
    socket, then :func:`serve`. Exits 0 after ``close`` or when rank 0 is
    gone, 1 after a failure."""
    torch.set_num_threads(1)
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _init_group(spec["rank"], spec["world"], spec["init_method"],
                spec["timeout_s"])
    mesh = make_mesh(axis_names=AXES, axis_sizes=spec["axis_sizes"],
                     device=device)
    conn = Client(tuple(spec["control"]),
                  authkey=bytes.fromhex(spec["authkey"]))
    conn.send_bytes(pickle.dumps(spec["rank"]))
    # Every program the engine sends is importable by name; importing the
    # serving model up front keeps that cost out of the first step.
    importlib.import_module("tpu_task_torch.ml.serving.model")
    try:
        serve(mesh, conn)
    except BaseException:                   # noqa: BLE001 — reported
        return 1
    finally:
        with contextlib.suppress(OSError):
            conn.close()
    return 0


__all__ = ["AXES", "GLOO_CUDA_COLLECTIVES", "Gang", "GangError", "Ref",
           "all_gather", "all_reduce", "all_to_all", "collective_stats",
           "follower_main", "program", "serve", "start"]
