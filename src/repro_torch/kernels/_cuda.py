"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

The sources have a plain C interface.  At first use each one is compiled
with ``nvcc`` for ``sm_90a`` (all sources at once, one process each) and the
objects are linked into one shared library under ``<repo>/build/``, named by
a hash of the sources and flags, then loaded with ``ctypes``.  A library
whose hash matches is reused; nothing is built when the module is imported.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.  There is no fallback: a build or launch that fails raises.
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

__all__ = ["library", "build", "check", "stream_of", "BUILD_DIR", "SOURCES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES: Tuple[str, ...] = ("gemm.cu", "rmsnorm.cu", "flash_decode.cu",
                            "flash_attention.cu")
HEADERS: Tuple[str, ...] = ("common.cuh",)
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# Limits the attention kernels share (csrc/common.cuh kMaxSmemBytes): shared
# memory one H100 block may use, and the widest head they take.
MAX_SMEM_BYTES = 232448
MAX_HEAD_DIM = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES: Dict[str, tuple] = {
    "gemm_f32": (_P, _P, _P, _I, _I, _I, _P),
    "rmsnorm_f32": (_P, _P, _P, _P, _I, _I, _F, _P),
    "flash_decode_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "flash_chunk_attention_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _F, _P),
    # q, pages_k, pages_v, tables, lengths, o; B, Hq, Hk, N, P, MP, D, Dv
    "flash_paged_decode_f32": (*[_P] * 6, *[_I] * 8, _F, _P),
    # q, pages_k, k_scales, pages_v, v_scales, tables, lengths, o; as above
    "flash_paged_decode_i8": (*[_P] * 8, *[_I] * 8, _F, _P),
    # q, pages_k, pages_v, tables, start, o; B, T, Hq, Hk, N, P, MP, D, Dv
    "flash_paged_chunk_attention_f32": (*[_P] * 6, *[_I] * 9, _F, _P),
    "flash_paged_chunk_attention_i8": (*[_P] * 8, *[_I] * 9, _F, _P),
    # q, k, v, o; B, T, Hq, Hk, Skv, D, Dv, causal, window
    "flash_attention_f32": (*[_P] * 4, *[_I] * 9, _F, _P),
}

_lib: Optional[ctypes.CDLL] = None


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
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


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
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_so), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernel library failed:\n" + "\n".join(logs))
        os.replace(tmp_so, so)
    log = "\n".join(logs)
    (BUILD_DIR / (so.stem + ".log")).write_text(log)
    return so, time.perf_counter() - t0, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
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
    """Handle of PyTorch's current stream on ``tensor``'s device."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
