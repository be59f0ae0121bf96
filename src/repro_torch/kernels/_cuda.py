"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

The sources have a plain C interface.  At first use each one is compiled
with ``nvcc`` for ``sm_90a`` (all sources at once, one process each) and the
objects are linked into one shared library under ``<repo>/build/``, named by
a hash of the sources and flags, then loaded with ``ctypes``.  A library
whose hash matches is reused; nothing is built when the module is imported.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.  There is no fallback: a build or launch that fails raises
(a build or load failure as :class:`KernelBuildError`).  A bf16 pointer
goes to a ``const __nv_bfloat16*`` parameter, as a ``c_void_p`` like every
other pointer.

Each wrapper counts its launches in its ``launches`` attribute; a wrapper
with bf16 entries counts those apart, in ``wrapper.bf16``
(:class:`LaunchCount`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

__all__ = ["library", "build", "check", "stream_of", "empty_launch", "BUILD_DIR", "SOURCES",
           "KernelBuildError", "LaunchCount"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES: Tuple[str, ...] = ("gemm.cu", "rmsnorm.cu", "flash_decode.cu",
                            "flash_attention.cu", "ssd.cu")
HEADERS: Tuple[str, ...] = ("common.cuh", "wgmma.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# Limits the attention kernels share (csrc/common.cuh kMaxSmemBytes): shared
# memory one H100 block may use, and the widest head they take.
MAX_SMEM_BYTES = 232448
MAX_HEAD_DIM = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES: Dict[str, tuple] = {
    # a, b, c; M, N, K
    "gemm_f32_skinny": (_P, _P, _P, _I, _I, _I, _P),
    # a, b, c; M, N, K, bm, bn
    "gemm_f32_tiled": (_P, _P, _P, *[_I] * 5, _P),
    # bf16 a, b, c; M, N, K and the plan bm, bn (the tensor-core body)
    "gemm_bf16": (_P, _P, _P, *[_I] * 5, _P),
    # a, b, c; E, M, N, K, bm, bn
    "batched_gemm_f32": (_P, _P, _P, *[_I] * 6, _P),
    "batched_gemm_bf16": (_P, _P, _P, *[_I] * 6, _P),
    "rmsnorm_f32": (_P, _P, _P, _P, _I, _I, _F, _P),
    "rmsnorm_bf16": (_P, _P, _P, _P, _I, _I, _F, _P),
    # q, k, v, lengths, acc, m, l (the shards' partials), o; B, Hq, Hk, S,
    # D, Dv, shard
    "flash_decode_f32": (*[_P] * 8, *[_I] * 7, _F, _P),
    # the same with bf16 q, k, v, o (fp32 partials)
    "flash_decode_bf16": (*[_P] * 8, *[_I] * 7, _F, _P),
    # q, k, v, lengths, acc, m, l; B, Hq, Hk, S, D, Dv, n_splits
    "flash_decode_partial_f32": (*[_P] * 7, *[_I] * 7, _F, _P),
    # the same with bf16 q, k, v and acc (m and l fp32)
    "flash_decode_partial_bf16": (*[_P] * 7, *[_I] * 7, _F, _P),
    # acc, m, l, out; NS, R, Dv
    "combine_partials_f32": (*[_P] * 4, *[_I] * 3, _P),
    "combine_partials_bf16": (*[_P] * 4, *[_I] * 3, _P),
    # q, k, v, start, acc, m, l (the shards' partials), o; B, T, Hq, Hk, S,
    # D, Dv, shard
    "flash_chunk_attention_f32": (*[_P] * 8, *[_I] * 8, _F, _P),
    # q, pages_k, pages_v, tables, lengths, acc, m, l, o; B, Hq, Hk, N, P,
    # MP, D, Dv, shard
    "flash_paged_decode_f32": (*[_P] * 9, *[_I] * 9, _F, _P),
    # q, pages_k, k_scales, pages_v, v_scales, tables, lengths, acc, m, l,
    # o; as above
    "flash_paged_decode_i8": (*[_P] * 11, *[_I] * 9, _F, _P),
    # q, pages_k, pages_v, tables, start, acc, m, l, o; B, T, Hq, Hk, N, P,
    # MP, D, Dv, shard
    "flash_paged_chunk_attention_f32": (*[_P] * 9, *[_I] * 10, _F, _P),
    # q, pages_k, k_scales, pages_v, v_scales, tables, start, acc, m, l, o;
    # as above
    "flash_paged_chunk_attention_i8": (*[_P] * 11, *[_I] * 10, _F, _P),
    # q, k, v, acc, m, l, o; B, T, Hq, Hk, Skv, D, Dv, causal, window, shard
    "flash_attention_f32": (*[_P] * 7, *[_I] * 10, _F, _P),
    # the same with bf16 q, k, v, o (fp32 partials) on the tensor-core body;
    # shard from attention_shard_cols_bf16
    "flash_attention_bf16": (*[_P] * 7, *[_I] * 10, _F, _P),
    # x, dt, A, D, B, C, y, state, st, sc, cs (the scratch); B, S, H, P, G,
    # N, Q
    "ssd_scan_f32": (*[_P] * 11, *[_I] * 7, _P),
    # the same with bf16 x, B, C and y (dt, A, D, the state and scratch fp32)
    "ssd_scan_bf16": (*[_P] * 11, *[_I] * 7, _P),
    # stream: one empty kernel (the launch path's floor)
    "empty_launch": (_P,),
}

_lib: Optional[ctypes.CDLL] = None


class KernelBuildError(RuntimeError):
    """The kernel library could not be built or loaded."""


class LaunchCount:
    """The launches of a wrapper's bf16 entries, counted apart from its
    fp32 ones (``wrapper.launches``): ``wrapper.bf16.launches``, named
    ``<wrapper>_bf16`` in launch records."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libreprotorch_{_source_key()}.so"


def build() -> Tuple[Path, float, str]:
    """Compile every source in parallel and link one ``.so``.

    Returns ``(path, seconds, log)``; ``log`` is nvcc's output, with
    ``-Xptxas -v``'s registers, shared memory and spills per kernel (empty
    when an existing library was reused)."""
    so = library_path()
    if so.exists():
        return so, 0.0, ""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise KernelBuildError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_so), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise KernelBuildError("linking the kernel library failed:\n" + "\n".join(logs))
        os.replace(tmp_so, so)
    log = "\n".join(logs)
    (BUILD_DIR / (so.stem + ".log")).write_text(log)
    return so, time.perf_counter() - t0, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildError(f"cannot load {path}: {e}") from e
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def stream_of(tensor) -> int:
    """Handle of PyTorch's current stream on ``tensor``'s device (the raw
    handle, without building a ``torch.cuda.Stream`` object on every
    launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(tensor.get_device())


def empty_launch(tensor) -> None:
    """Launch an empty kernel on the current stream of ``tensor``'s device
    through the path every wrapper takes (``stream_of``, the ctypes call,
    :func:`check`): the floor under the time of a short kernel's call."""
    check(library().empty_launch(stream_of(tensor)), "empty_launch")
