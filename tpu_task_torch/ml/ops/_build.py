"""Build and bind the port's CUDA kernels: nvcc into a shared library with
a plain C interface, loaded with ctypes.

Each source under ``tpu_task_torch/csrc/`` compiles on first use, for
``sm_90a``, into ``build/tpu_task_torch/`` at the repository root. The
library's file name carries a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one is reused. A failed build raises with
the compiler's output; nothing falls back."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

_PACKAGE = Path(__file__).resolve().parents[2]
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE.parent / "build" / "tpu_task_torch"

#: ``-Xptxas -v`` makes ptxas report registers, shared memory and spills.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int

#: C entry points of each library: name -> (restype, argtypes).
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "paged_decode": {
        # q_type, kv_type, q, k_pool, v_pool, k_scale, v_scale, tables,
        # positions, out, partials, rows, w, heads, kv_heads, d, bs,
        # max_blocks, splits, split_blocks, stream
        "tt_paged_decode": (_I, [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
        # q_type, partials, out, n_rows, splits, d, stream
        "tt_paged_decode_combine": (_I, [_I, _P, _P, _I, _I, _I, _P]),
        # q_type, kv_type, smem_bytes, int* ctas
        "tt_paged_decode_ctas_per_sm": (_I, [_I, _I, _I, _P]),
        "tt_paged_decode_smem_bytes": (_I, [_I, _I, _I, _I, _I]),
        "tt_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "paged_decode_pipelined": {
        # those of tt_paged_decode
        "tt_paged_decode_pipelined": (_I, [_I, _I, _P, _P, _P, _P, _P, _P,
                                           _P, _P, _P, _I, _I, _I, _I, _I,
                                           _I, _I, _I, _I, _P]),
        # those of tt_paged_decode_combine
        "tt_paged_decode_pipelined_combine": (_I, [_I, _P, _P, _I, _I, _I,
                                                   _P]),
        # q_type, kv_type, w, heads, kv_heads, d, bs, int* ctas
        "tt_paged_decode_pipelined_ctas_per_sm": (_I, [_I, _I, _I, _I, _I,
                                                       _I, _I, _P]),
        # q_type, kv_type, w, heads, kv_heads, d, bs
        "tt_paged_decode_pipelined_smem_bytes": (_I, [_I, _I, _I, _I, _I,
                                                      _I, _I]),
        # q_type, w, heads, kv_heads, d
        "tt_paged_decode_pipelined_uses_mma": (_I, [_I, _I, _I, _I, _I]),
        "tt_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "flash_attention": {
        # dtype, q, k, v, o, lse, batch, sq, sk, heads, d, causal,
        # q_offset, stream
        "tt_flash_fwd": (_I, [_I, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _P]),
        # dtype, q, k, v, do, lse, delta, dq, batch, ..., q_offset, stream
        "tt_flash_bwd_dq": (_I, [_I, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _P]),
        # dtype, q, k, v, do, lse, delta, dk, dv, batch, ..., stream
        "tt_flash_bwd_dkv": (_I, [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _P]),
        "tt_flash_tensor_cores": (_I, [_I, _I]),
        # which (0 = forward, 1 = dq, 2 = dk/dv), d, int* ctas
        "tt_flash_ctas_per_sm": (_I, [_I, _I, _P]),
        # which, d
        "tt_flash_smem_bytes": (_I, [_I, _I]),
        "tt_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
#: The compiler's output for each library this process loaded (kept
#: beside the library, for one built by an earlier process).
compiler_output: Dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "port's CUDA kernels build on first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    source += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _build(name: str, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    done = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if done.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name}: nvcc exited "
                           f"{done.returncode}\n{done.stdout}")
    target.with_suffix(".log").write_text(done.stdout)
    os.replace(tmp, target)
    compiler_output[name] = done.stdout


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built if needed, with every entry point's
    ``argtypes``/``restype`` declared."""
    lib = _loaded.get(name)
    if lib is None:
        target = library_path(name)
        if not target.exists():
            _build(name, target)
        elif name not in compiler_output:
            log = target.with_suffix(".log")
            compiler_output[name] = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(target))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib
