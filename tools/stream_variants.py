#!/usr/bin/env python3
"""Variants of the stream kernel's block-CSC instances, built side by side
and timed on one card.

    python3 tools/stream_variants.py

Each variant is a copy of ``src/repro_torch/kernels/csrc`` under
``build/stream_variants/<name>/`` with a text patch of ``stream_matmul.cuh``,
compiled with ``bsr_matmul.cu`` into a library of its own (all variants in
parallel). For salaad_llama_60m's gate S (512 x 1376, bs 32, every tile
live) and q S (512 x 512, bs 128) it prints each variant's device time per
call (20 calls replayed from one CUDA graph) at T = 512, walked and split,
and at T = 8, with its registers per thread. "no products" and "no loads"
compute wrong outputs on purpose: they time the load path and the product
path alone.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bsr_matmul import bsr_from_dense, bsr_plan  # noqa: E402
from repro_torch.kernels.stream import card_sms  # noqa: E402

EIGHT_WARPS = [("return rows == 8 ? 32 * (bnb / 16) : bnb == 64 ? 256 : 128;",
                "return rows == 8 ? 32 * (bnb / 16) : 256;"),
               ("return rows == 8 ? 1 : bnb == 64 ? 2 : 3;", "return rows == 8 ? 1 : 2;")]
VARIANTS = {
    "as built": [],
    "8 warps at 64 rows": EIGHT_WARPS,
    "ring of 3": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "ring of 6": [("constexpr int kStages = 4;", "constexpr int kStages = 6;")],
    "8 warps, no products": EIGHT_WARPS + [
        ("    stage_mma<NR, RW, KS, LDW, LDX>(", "    if (a.bs < 0) stage_mma<NR, RW, KS, LDW, LDX>(")],
    "8 warps, no loads": EIGHT_WARPS + [
        ("    if (nx < cnt) {\n      issue_w(nx);", "    if (nx < cnt && a.bs < 0) {\n      issue_w(nx);")],
}


def event_ms(fn, iters=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, calls=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return event_ms(graph.replay) / calls


def main():
    if not torch.cuda.is_available():
        sys.exit("stream_variants: needs a CUDA card")
    out_dir = ROOT / "build" / "stream_variants"
    shutil.rmtree(out_dir, ignore_errors=True)
    procs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        d = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, d)
        header = d / "stream_matmul.cuh"
        text = header.read_text()
        for old, new in patches:
            if old not in text:
                sys.exit(f"stream_variants: patch of {name!r} no longer applies: {old!r}")
            text = text.replace(old, new)
        header.write_text(text)
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "bsr_matmul.cu"), str(d / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, regs = {}, {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"stream_variants: {name!r} failed to build:\n{log[-3000:]}")
        regs[name] = sorted({int(line.split("Used ")[1].split()[0])
                             for line in log.splitlines() if "Used " in line})
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.bsr_matmul_launch.argtypes = _build.SIGNATURES["bsr_matmul_launch"]
        lib.bsr_matmul_launch.restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    sms = card_sms(dev.index or 0)
    mats = {}
    for site, (n, m, bs) in (("gate", (512, 1376, 32)), ("q", (512, 512, 128))):
        s = rng.standard_normal((n, m)).astype(np.float32)
        mats[site] = bsr_from_dense(s, bs, device=dev)

    def call(lib, x, mat, xrows, split):
        t_dim, n = x.shape
        m, bs = mat.shape[1], mat.block_size
        jb, maxb = mat.rows.shape
        plan = bsr_plan(n, m, bs, maxb, 4, 4, sms)
        y = torch.empty((t_dim, m), device=dev)
        err = lib.bsr_matmul_launch(x.data_ptr(), mat.counts.data_ptr(), mat.rows.data_ptr(),
                                    mat.vals.data_ptr(), y.data_ptr(), t_dim, n, m, jb, maxb, bs,
                                    plan.nseg, xrows, split, 0, 0,
                                    torch.cuda.current_stream().cuda_stream)
        if err:
            sys.exit(f"stream_variants: launch failed, cudaError {err}")
        return y

    x512, x8 = torch.randn(512, 512, device=dev), torch.randn(8, 512, device=dev)
    for name, lib in libs.items():
        row = {"registers": regs[name]}
        for site, mat in mats.items():
            for split in (0, 1):
                row[f"{site} T=512 {'split' if split else 'walk'}"] = round(
                    graph_ms(lambda: call(lib, x512, mat, 64, split)), 4)
            row[f"{site} T=8"] = round(graph_ms(lambda: call(lib, x8, mat, 8, 1)), 4)
        print(f"{name}: {json.dumps(row)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
