#!/usr/bin/env python3
"""Variants of the paged attention kernel, built side by side and timed on
one card, each at several cuts of the key axis and the rows.

    python3 tools/paged_variants.py

Each variant is a copy of ``src/repro_torch/kernels/csrc`` under
``build/paged_variants/<n>/`` with text patches of ``paged_attention.cu`` (or
of the header a patch names), compiled alone into a library of its own (all
variants in parallel). At ``chip_smoke.py`` 3d/3e's shapes (8 slots, 8 heads
of 64, 32 pages of 16 per slot, lengths 20-430; numpy seed 0) it prints each
variant's device time per call (20 calls replayed from one CUDA graph), f32
and bf16: decode with the key axis in 1, 2, 4 or 8 segments, and k-query (64
queries per slot) in 1, 2 or 4. "no products", "no loads" and "no work"
compute wrong outputs on purpose: they time the load path and the product
path alone, and a launch of blocks that leave at once.
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

ROWS = "constexpr int kRowWarps = 1;"
VARIANTS = {
    "as built": [],
    "32-row tiles (2 warps along rows, 2 along keys)": [(ROWS, "constexpr int kRowWarps = 2;")],
    "64-row tiles (4 warps along rows)": [(ROWS, "constexpr int kRowWarps = 4;")],
    "f32 chunks of 32": [
        ("  return sizeof(T) == 4 && dp > 128 ? 32 : 64;", "  return sizeof(T) == 4 ? 32 : 64;")],
    "3xTF32 score corrections in the scores' chain": [
        ("attention_tile.cuh", "  constexpr bool split = BC / 8 < 4;",
         "  constexpr bool split = false;")],
    "block-table offsets carried a chunk in a register": [
        ("  if (tid < BC) koff[BC + tid] = key_off(1);\n"
         "  for (int c = 0; c < n_chunks; ++c) {\n    cp_async_wait<0>();",
         "  int64_t next = tid < BC ? key_off(1) : -1;\n"
         "  for (int c = 0; c < n_chunks; ++c) {\n"
         "    if (tid < BC) koff[((c + 1) & 1) * BC + tid] = next;\n    cp_async_wait<0>();"),
        ("    if (c + 2 < n_chunks && tid < BC) koff[(c & 1) * BC + tid] = key_off(c + 2);",
         "    if (c + 2 < n_chunks && tid < BC) next = key_off(c + 2);")],
    "no work (every block leaves at once)": [
        ("  cg::cluster_group cluster = cg::this_cluster();\n",
         "  if (a.bs > 0) return;\n  cg::cluster_group cluster = cg::this_cluster();\n")],
    "no products": [
        ("    qk<DP, BCW, LD>(qs + wrow * LD, ks, sc);",
         "    if (a.bs < 0) qk<DP, BCW, LD>(qs + wrow * LD, ks, sc);"),
        ("    pv<DP, BCW, LD>(sc, ks + BC * LD, o);",
         "    if (a.bs < 0) pv<DP, BCW, LD>(sc, ks + BC * LD, o);")],
    "no loads": [
        ("        const bool live = i < n_live && col < a.d;\n        cp_async16(ks",
         "        const bool live = i < n_live && col < a.d && a.bs < 0;\n        cp_async16(ks")],
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
        sys.exit("paged_variants: needs a CUDA card")
    out_dir = ROOT / "build" / "paged_variants"
    shutil.rmtree(out_dir, ignore_errors=True)
    sources = {}
    for name, patches in VARIANTS.items():   # every patch applies before any build starts
        texts = {}
        for patch in patches:
            fname, old, new = patch if len(patch) == 3 else ("paged_attention.cu", *patch)
            text = texts.get(fname, (_build.CSRC / fname).read_text())
            if old not in text:
                sys.exit(f"paged_variants: patch of {name!r} no longer applies: {old!r}")
            texts[fname] = text.replace(old, new)
        sources[name] = texts
    procs = {}
    for i, (name, texts) in enumerate(sources.items()):
        d = out_dir / f"v{i}"
        shutil.copytree(_build.CSRC, d)
        for fname, text in texts.items():
            (d / fname).write_text(text)
        src = d / "paged_attention.cu"
        procs[name] = (d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(src), str(d / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"paged_variants: {name!r} failed to build:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for entry in ("paged_attention_launch", "paged_attention_kquery_launch"):
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    slots, hq, hkv, d, bs, nb, kq = 8, 8, 8, 64, 16, 32, 64
    n_pages = slots * nb
    kp32 = torch.from_numpy(rng.standard_normal((n_pages, hkv, bs, d), dtype=np.float32)).to(dev)
    vp32 = torch.from_numpy(rng.standard_normal((n_pages, hkv, bs, d), dtype=np.float32)).to(dev)
    table = torch.from_numpy(rng.permutation(n_pages).reshape(slots, nb).astype(np.int32)).to(dev)
    lens = rng.integers(20, 430, slots).astype(np.int32)
    lens[0] = 79
    lens_d = torch.from_numpy(lens).to(dev)
    lens_k = torch.from_numpy(np.minimum(lens, nb * bs - kq)).to(dev)
    q32 = torch.from_numpy(rng.standard_normal((slots, hq, kq, d), dtype=np.float32)).to(dev)

    def call(lib, q, kp, vp, lengths, seg_keys, code):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        if q.dim() == 3:
            err = lib.paged_attention_launch(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), slots, hq, hkv, d, n_pages, bs, nb, seg_keys, code, stream)
        else:
            err = lib.paged_attention_kquery_launch(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(), lengths.data_ptr(),
                out.data_ptr(), slots, hq, hkv, q.shape[2], d, n_pages, bs, nb, seg_keys, code,
                stream)
        if err:
            sys.exit(f"paged_variants: launch failed, cudaError {err}")
        return out

    chunks = nb * bs // 64                 # of 64 keys: 8, the chunk of every variant at D 64

    def times(lib):
        row = {}
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            kp, vp, qk = kp32.to(dt), vp32.to(dt), q32.to(dt)
            qd = qk[:, :, 0].contiguous()
            tag = "f32" if code == 0 else "bf16"
            for what, q_, lens, cuts in (("decode", qd, lens_d, (1, 2, 4, 8)),
                                         ("kquery", qk, lens_k, (1, 2, 4))):
                for nseg in cuts:
                    seg = 64 * (chunks // nseg)
                    row[f"{what} {tag} nseg={nseg}"] = round(graph_ms(
                        lambda q_=q_, kp=kp, vp=vp, lens=lens, seg=seg: call(
                            lib, q_, kp, vp, lens, seg, code)), 4)
        return row

    for name, lib in libs.items():
        print(f"{name}: {json.dumps(times(lib))}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
