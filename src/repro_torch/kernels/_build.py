"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into one shared library with a plain C
interface, and loaded with ``ctypes``. The library lands in
``<checkout>/build/repro_torch_kernels/`` under a name keyed by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads in
milliseconds. Nothing here runs at import time: the first kernel launch
builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "build", "library", "launch", "dtype_code", "table_dtype_code",
           "check_cuda", "check_int32"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: name -> argument types (every one returns cudaError_t as int)
SIGNATURES = {
    # x, counts, rows, vals, y, T, n, m, JB, MAXB, bs, bt, dtype, wdtype, stream
    "bsr_matmul_launch": [_P] * 5 + [_I] * 9 + [_P],
    # pool, src, dst, n_pairs, n_layers, n_pages, page_bytes, stream
    "page_copy_launch": [_P] * 3 + [_I] * 3 + [_L, _P],
    # q, k, v, out, B, Hq, Hkv, T, S, D, causal, scale, dtype, stream
    "flash_attention_launch": [_P] * 4 + [_I] * 7 + [_F, _I, _P],
    # x, p, vt, counts, rows, vals, y, T, K, M, r, layer, L, JB, MAXB, bs, bt, nseg, kseg,
    # loops, ypn, dtype, stream
    "slr_matmul_stacked_launch": [_P] * 7 + [_I] * 15 + [_P],
    # x, p, vt, counts, rows, vals, ids, y, B, T, K, M, r, layers, layer, N, JB, MAXB, bs,
    # bt, nseg, kseg, loops, ypn, dtype, stream
    "slr_matmul_multi_launch": [_P] * 8 + [_I] * 17 + [_P],
    # dtype, bs, bt, smem, out (int*): clusters of the fused body the card holds at once
    "slr_fused_resident": [_I] * 4 + [_P],
    # x, p, vt, y, T, K, M, r, bt, dtype, wdtype, stream
    "lowrank_matmul_launch": [_P] * 4 + [_I] * 7 + [_P],
    # x, p, vt, counts, rows, vals, t, y, T, K, M, r, rp, JB, MAXB, bs, bt, nseg, kseg,
    # dtype, wdtype, stream
    "slr_matmul_launch": [_P] * 8 + [_I] * 13 + [_P],
    # q, k, v, table, lengths, out, B, Hq, Hkv, D, N, bs, nb, dtype, stream
    "paged_attention_launch": [_P] * 6 + [_I] * 8 + [_P],
    # q, k, v, table, lengths, out, B, Hq, Hkv, kq, D, N, bs, nb, dtype, stream
    "paged_attention_kquery_launch": [_P] * 6 + [_I] * 9 + [_P],
    # x, tau, out, nb, per, dtype, stream
    "soft_threshold_launch": [_P] * 3 + [_I, _L, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels build only where the CUDA toolkit is installed")


def build() -> Path:
    """Compile and link the kernels if this source set has no library yet;
    returns the library's path. The compiler's output (``-Xptxas -v``:
    registers, shared memory and spills per kernel) is kept beside it."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode() + f.read_bytes())
    key = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"libsalaad_kernels_{key}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # per-process object names: two processes may build the same source set at once
    objs = [BUILD_DIR / f"{src.stem}_{key}.{os.getpid()}.o" for src in sources]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objs)
    ]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(src.name)
    log = "\n".join(logs)
    (BUILD_DIR / f"nvcc_{key}.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    for obj in objs:
        obj.unlink()
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.salaad_error_string.argtypes = [ctypes.c_int]
    lib.salaad_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry ``name`` on PyTorch's current stream of ``device``; raise
    if the launch was refused (the kernel then never ran)."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, name)(*args, stream)
    if err:
        msg = lib.salaad_error_string(err).decode()
        raise RuntimeError(f"{name} failed to launch: {msg} (cudaError {err})")


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype: torch.dtype) -> int:
    try:
        return _DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {dtype}") from None


def table_dtype_code(name: str, x_dtype: torch.dtype, *tables: torch.Tensor) -> int:
    """The code of the tables' one dtype, which is x's, or float32 under
    bfloat16 activations (a bf16 model deployed from an f32 SLR state)."""
    dtypes = {t.dtype for t in tables}
    if len(dtypes) != 1:
        raise TypeError(f"{name}: the tables must share one dtype, got "
                        f"{sorted(map(str, dtypes))}")
    (w,) = dtypes
    if w != x_dtype and not (x_dtype == torch.bfloat16 and w == torch.float32):
        raise TypeError(f"{name}: tables of {w} under activations of {x_dtype}; the kernel "
                        "takes one dtype, or bfloat16 activations over float32 tables")
    return dtype_code(w)


def check_int32(name: str, **tensors: torch.Tensor) -> None:
    for arg, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")


def check_cuda(name: str, **tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device and contiguous; returns the device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got {dev}")
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev
