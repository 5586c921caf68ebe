#!/usr/bin/env python3
"""Every launch cut of the block-CSC and low-rank kernels on one card.

    python3 tools/stream_cuts.py

For salaad_llama_60m's gate, q and down shapes (random tables, seed 0) at
T = 512, 128 and 37, it calls the kernels' C entries directly with each cut
the stream kernel takes (8 or 64 rows per block; each product split over a
cluster or walked by one block), holds every cut's output bit for bit
against the others, and prints each cut's device time per call (20 calls
replayed from one CUDA graph) with the card's name and power limit. The
wrappers' own cut (``StreamPlan.cut``) should pick the fastest or near it.
"""
import itertools
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels._build import launch  # noqa: E402
from repro_torch.kernels.bsr_matmul import bsr_from_dense, bsr_plan  # noqa: E402
from repro_torch.kernels.lowrank_matmul import lowrank_plan  # noqa: E402
from repro_torch.kernels.stream import card_sms  # noqa: E402


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
    """Device time per call: ``calls`` calls captured in one CUDA graph."""
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
        sys.exit("stream_cuts: needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    sms = card_sms(dev.index or 0)

    def lowrank(x, p, vt, xrows, split_p, split_v):
        t_dim, k = x.shape
        r, m = vt.shape
        plan = lowrank_plan(k, r, m, 4, 4, sms)
        t = torch.empty((t_dim, plan.rp), device=dev)
        y = torch.empty((t_dim, m), device=dev)
        launch("lowrank_matmul_launch", dev, x.data_ptr(), p.data_ptr(), vt.data_ptr(), None,
               t.data_ptr(), y.data_ptr(), 1, t_dim, k, m, r, plan.rp, 1, 0, 1, plan.xp.nseg,
               plan.tv.nseg, xrows, split_p, split_v, 0, 0)
        return y

    def bsr(x, mat, xrows, split):
        t_dim, n = x.shape
        m, bs = mat.shape[1], mat.block_size
        jb, maxb = mat.rows.shape
        plan = bsr_plan(n, m, bs, maxb, 4, 4, sms)
        y = torch.empty((t_dim, m), device=dev)
        launch("bsr_matmul_launch", dev, x.data_ptr(), mat.counts.data_ptr(), mat.rows.data_ptr(),
               mat.vals.data_ptr(), y.data_ptr(), t_dim, n, m, jb, maxb, bs, plan.nseg, xrows,
               split, 0, 0)
        return y

    for (k, r, m), t in itertools.product(((512, 128, 1376), (512, 128, 512), (1376, 128, 512)),
                                          (512, 128, 37)):
        x = torch.randn(t, k, device=dev)
        p, vt = torch.randn(k, r, device=dev) / 8, torch.randn(r, m, device=dev) / 8
        first = lowrank(x, p, vt, 64, 1, 1)
        row = {}
        for xr, sp, sv in itertools.product((8, 64), (0, 1), (0, 1)):
            if not torch.equal(lowrank(x, p, vt, xr, sp, sv), first):
                sys.exit(f"stream_cuts: lowrank cut rows={xr} split={sp},{sv} changed the bits")
            name = f"rows {xr}, x@P {'split' if sp else 'walk'}, t@Vt {'split' if sv else 'walk'}"
            row[name] = round(graph_ms(lambda: lowrank(x, p, vt, xr, sp, sv)), 4)
        print(f"lowrank_matmul K={k} r={r} M={m} T={t}: {json.dumps(row)}")

    for name, (n, m, bs) in (("gate", (512, 1376, 32)), ("q", (512, 512, 128)),
                             ("down", (1376, 512, 32))):
        ib, jb = -(-n // bs), -(-m // bs)
        s = rng.standard_normal((ib * bs, jb * bs)).astype(np.float32)
        mat = bsr_from_dense(s[:n, :m], bs, device=dev)
        for t in (512, 128, 37):
            x = torch.randn(t, n, device=dev)
            first = bsr(x, mat, 64, 1)
            row = {}
            for xr, sp in itertools.product((8, 64), (0, 1)):
                if not torch.equal(bsr(x, mat, xr, sp), first):
                    sys.exit(f"stream_cuts: bsr cut rows={xr} split={sp} changed the bits")
                row[f"rows {xr}, {'split' if sp else 'walk'}"] = round(
                    graph_ms(lambda: bsr(x, mat, xr, sp)), 4)
            print(f"bsr_matmul {name} S ({n}x{m}, bs={bs}, every tile live) T={t}: "
                  f"{json.dumps(row)}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
