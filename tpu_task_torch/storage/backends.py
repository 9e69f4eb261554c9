"""A local-filesystem bucket for the port's fleet KV client, the
replica's obs export and the checkpointer's upload — this package's copy of
the JAX package's ``LocalBackend`` (``tpu_task/storage/backends.py``),
trimmed to the calls they make: ``list``, ``read``, ``read_conditional``,
``write``, ``write_from_file``, ``write_if_absent``, ``set_mtime`` and
``delete``. Keys are '/'-separated paths under the root, and a key
that would leave the root is refused.

The layout on disk is the JAX package's, so a JAX replica and a port
replica pointed at one directory share it. Object-store buckets (GCS, S3,
Azure) are ROADMAP A11c."""

from __future__ import annotations

import os
import shutil
from typing import List, Tuple


class _NotModified:
    """What :meth:`LocalBackend.read_conditional` returns in place of the
    bytes when the object still matches the caller's validator."""

    def __repr__(self) -> str:
        return "NOT_MODIFIED"


NOT_MODIFIED = _NotModified()


def contained_path(root: str, key: str) -> str:
    """Resolve ``key`` under ``root``, refusing escapes. The separator is
    required, so a sibling directory sharing the root as a string prefix
    ("/x/data" vs "/x/data2") cannot be reached through "../"."""
    root = os.path.abspath(root)
    path = os.path.normpath(os.path.join(root, key))
    if path != root and not path.startswith(root + os.sep):
        raise ValueError(f"key escapes backend root: {key!r}")
    return path


class LocalBackend:
    """A bucket in a local directory. A missing object raises
    ``FileNotFoundError``."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)

    def _abs(self, key: str) -> str:
        return contained_path(self.root, key)

    def list(self, prefix: str = "") -> List[str]:
        base = self._abs(prefix) if prefix else self.root
        if not os.path.isdir(base):
            return []
        keys = []
        for dirpath, _dirnames, filenames in os.walk(base):
            for name in filenames:
                full = os.path.join(dirpath, name)
                keys.append(os.path.relpath(full, self.root).replace(
                    os.sep, "/"))
        return sorted(keys)

    def read(self, key: str) -> bytes:
        path = self._abs(key)
        if not os.path.isfile(path):
            raise FileNotFoundError(key)
        with open(path, "rb") as handle:
            return handle.read()

    def read_conditional(self, key: str, validator=None) -> Tuple[object,
                                                                  object]:
        """``(bytes or NOT_MODIFIED, validator)``. The validator is
        ``(mtime_ns, size)`` of the open file, so an unchanged object costs
        one stat and no read."""
        path = self._abs(key)
        try:
            handle = open(path, "rb")
        except IsADirectoryError:
            raise FileNotFoundError(key) from None
        with handle:
            stat = os.fstat(handle.fileno())
            current = (stat.st_mtime_ns, stat.st_size)
            if validator is not None and validator == current:
                return NOT_MODIFIED, validator
            return handle.read(), current

    def write(self, key: str, data: bytes) -> None:
        path = self._abs(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as handle:
            handle.write(data)

    def write_from_file(self, key: str, path: str) -> None:
        destination = self._abs(key)
        os.makedirs(os.path.dirname(destination), exist_ok=True)
        shutil.copyfile(path, destination)

    def set_mtime(self, key: str, mtime: float) -> None:
        try:
            os.utime(self._abs(key), (mtime, mtime))
        except OSError:
            pass

    def write_if_absent(self, key: str, data: bytes) -> bool:
        """Write ``data`` unless ``key`` exists; whether it wrote. The key
        of a block is its content hash, so concurrent publishers of one
        block race harmlessly."""
        path = self._abs(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL)
        except FileExistsError:
            return False
        with os.fdopen(fd, "wb") as handle:
            handle.write(data)
        return True

    def delete(self, key: str) -> None:
        path = self._abs(key)
        if os.path.isfile(path):
            os.remove(path)


def open_backend(remote: str) -> LocalBackend:
    """The bucket a ``--kv-bucket`` string names: a plain path is a local
    directory; a connection string (``:scheme...:container``) names an
    object store, which the port does not have yet."""
    if remote.startswith(":"):
        raise NotImplementedError(
            f"object-store buckets are not ported to tpu_task_torch yet "
            f"({remote.split(':')[1].split(',')[0]!r}): ROADMAP A11c")
    return LocalBackend(remote or ".")
