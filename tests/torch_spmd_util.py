"""An SPMD launcher for the port's sharded-training tests: ``world`` CPU
processes, each a rank of one gloo group started from the orchestrator's
variables (``worker_env`` + ``distributed_init_from_env``), as a trainer's
workers start. The test process is no rank: it sends each case (a
function of a rank-side helper module, by module and name, with its
arguments) to every rank and collects their results in rank order, so
one group serves every case of a test module.

Ranks import this module and the case modules by name, so none of them
imports JAX or the JAX package.

    python tests/torch_spmd_util.py '<json spec>'   # one rank
"""

from __future__ import annotations

import importlib
import json
import os
import pickle
import secrets
import subprocess
import sys
import threading
import time
import traceback
from multiprocessing.connection import Client, Listener, wait
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

#: Seconds a case may take on every rank before the group is torn down.
CASE_TIMEOUT_S = 240.0


class SpmdGroup:
    """``world`` rank processes rendezvousing under ``workdir``."""

    def __init__(self, world: int, workdir):
        self.world = world
        workdir = Path(workdir)
        workdir.mkdir(parents=True, exist_ok=True)
        key = secrets.token_bytes(16)
        self.listener = Listener(("localhost", 0), authkey=key)
        spec = {"world": world, "address": list(self.listener.address),
                "authkey": key.hex(),
                "coordinator": f"file://{workdir / 'rendezvous'}"}
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(REPO), str(HERE)]
            + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        env["OMP_NUM_THREADS"] = "1"
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__)),
             json.dumps({**spec, "rank": rank})], env=env)
            for rank in range(world)]
        self.conns = [None] * world
        # Accept on a thread so that a rank that never starts (an import
        # error) fails the group in time instead of blocking the test.
        accepted = []
        thread = threading.Thread(target=lambda: accepted.extend(
            self.listener.accept() for _ in range(world)), daemon=True)
        thread.start()
        thread.join(CASE_TIMEOUT_S)
        if thread.is_alive():
            self.close()
            raise TimeoutError(f"{world - len(accepted)} of {world} ranks "
                               "never connected")
        for conn in accepted:
            self.conns[conn.recv()] = conn

    def run(self, fn, **kwargs) -> list:
        """``fn(**kwargs)`` on every rank (``fn`` a function of a module
        the ranks import by name); the results in rank order. A rank's
        exception fails the case with its traceback and ends the group."""
        message = pickle.dumps((fn.__module__, fn.__qualname__, kwargs))
        for conn in self.conns:
            conn.send_bytes(message)
        results = [None] * self.world
        pending = {conn: rank for rank, conn in enumerate(self.conns)}
        deadline = time.monotonic() + CASE_TIMEOUT_S
        while pending:
            ready = wait(list(pending), timeout=max(
                0.0, deadline - time.monotonic()))
            if not ready:
                self.close()
                raise TimeoutError(f"{fn.__name__}: ranks "
                                   f"{sorted(pending.values())} timed out")
            for conn in ready:
                rank = pending.pop(conn)
                try:
                    status, value = pickle.loads(conn.recv_bytes())
                except EOFError:
                    self.close()
                    raise RuntimeError(f"{fn.__name__}: rank {rank} died")
                if status != "ok":
                    self.close()
                    raise RuntimeError(f"{fn.__name__} on rank {rank}:\n"
                                       f"{value}")
                results[rank] = value
        return results

    def close(self) -> None:
        for conn in self.conns:
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        self.listener.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- the rank side ---------------------------------------------------------------

_MESHES: dict = {}


class _Lines:
    """A sub-mesh's process groups by axis name: ``Mesh.group``'s
    ``device_mesh.get_group`` for a mesh over the first ranks of a larger
    world."""

    def __init__(self, groups: dict):
        self.groups = groups

    def get_group(self, name: str):
        return self.groups[name]


def case_mesh(axis_names, axis_sizes, device="cpu"):
    """This rank's Mesh of ``axis_names`` x ``axis_sizes`` over the first
    ``prod(axis_sizes)`` ranks of the group, or None for a rank outside
    it. The whole world builds the mesh through ``make_mesh``; a smaller
    one creates each line's group on every rank (``new_group`` is
    collective). Cached, so each layout's groups are made once."""
    import numpy as np
    import torch.distributed as dist

    from tpu_task_torch.ml.parallel.mesh import Mesh, make_mesh

    key = (tuple(axis_names), tuple(axis_sizes), str(device))
    if key in _MESHES:
        return _MESHES[key]
    n = int(np.prod(axis_sizes))
    world, rank = dist.get_world_size(), dist.get_rank()
    if n == world:
        mesh = make_mesh(axis_names=axis_names, axis_sizes=axis_sizes,
                         device=device)
    else:
        layout = np.arange(n).reshape(tuple(axis_sizes))
        groups = {}
        for dim, name in enumerate(axis_names):
            lines = np.moveaxis(layout, dim, -1).reshape(-1, axis_sizes[dim])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = group
        mesh = (Mesh(axis_sizes, axis_names, rank=rank, device=device,
                     device_mesh=_Lines(groups)) if rank < n else None)
    _MESHES[key] = mesh
    return mesh


def _serve(spec: dict) -> int:
    sys.path[:0] = [str(REPO), str(HERE)]
    import torch

    torch.set_num_threads(1)
    from tpu_task_torch.ml.parallel.mesh import (distributed_init_from_env,
                                                 worker_env)

    conn = Client(tuple(spec["address"]),
                  authkey=bytes.fromhex(spec["authkey"]))
    conn.send(spec["rank"])
    distributed_init_from_env(worker_env(spec["rank"], spec["world"],
                                         spec["coordinator"]))
    while True:
        try:
            module, name, kwargs = pickle.loads(conn.recv_bytes())
        except (EOFError, OSError):
            return 0
        try:
            fn = importlib.import_module(module)
            for part in name.split("."):
                fn = getattr(fn, part)
            reply = ("ok", fn(**kwargs))
        except BaseException:                # noqa: BLE001 — reported
            reply = ("err", traceback.format_exc())
        conn.send_bytes(pickle.dumps(reply))


if __name__ == "__main__":
    sys.exit(_serve(json.loads(sys.argv[1])))
