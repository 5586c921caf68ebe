#!/usr/bin/env python3
"""Host time per call of the low-rank wrapper, with and without the
allocation of its f32 ``t = x @ P`` buffer, and of the paged attention,
soft-threshold and page-copy wrappers, part by part, on one card.

    python3 tools/wrapper_host_time.py                  # every wrapper
    python3 tools/wrapper_host_time.py --copy           # soft-threshold and page copy
    python3 tools/wrapper_host_time.py --copy --src build/parent/src   # another tree

``--src`` times the ``repro_torch`` of another tree (a ``git archive`` of a
parent commit under the git-ignored ``build/``), which builds its kernels
into its own ``build/``; run it in turns with this tree's to compare.

For salaad_llama_60m's gate (512 -> 1376) and q (512 -> 512) factors at
r = 128 (random, seed 0), f32, T = 1 and 8, it times on the host clock
(no synchronisation inside the loop; the card takes less time per call than
the host, so no launch waits on the queue):
  - ``lowrank_matmul``: the wrapper as a model layer calls it;
  - ``lowrank_launch``: its launch path alone (plan, cut, ``t`` allocated,
    the C entry), into a preallocated y;
  - ``cached t``: the same launch path with one ``t`` reused for every call;
  - ``torch.empty(t)``: the allocation alone;
  - ``bsr_matmul`` on the gate S (bs 32, every tile live), for scale.
It holds the cached-t output bit for bit against the wrapper's. For paged
decode (8 slots x 8 heads of 64, f32, 32 pages of 16 per slot:
``chip_smoke.py`` 3d's shape) and paged k-query (the same with 64 queries per
slot, 3e's) it times the wrapper, then its parts alone: ``_check`` (the
argument checks), ``paged_plan``, ``torch.empty_like`` (the output) and the
launch through ``_build.launch`` into a preallocated output, and holds that
launch's output bit for bit against the wrapper's. For soft-threshold at
``chip_smoke.py`` 3i's gate stack (8, 512, 1376) f32 and page copy at 3g's
shape (8 pairs of 8-layer 32 KB f32 pages, a pool of 128) it times the
wrapper, ``check_cuda`` (page copy: with ``check_int32``),
``torch.empty_like(x)`` (soft-threshold), ``page_copy_plan`` (where the
tree has one) and the launch through ``_build.launch`` alone, with the
arguments the tree's C entry takes, holding its output against the
wrapper's.
Each line is the median of 5 repeats of 400 calls per form, in microseconds;
the card's name and power limit come last.
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

PARSER = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
PARSER.add_argument("--src", default=str(Path(__file__).resolve().parents[1] / "src"),
                    help="the tree whose repro_torch is timed (default: this one)")
PARSER.add_argument("--copy", action="store_true",
                    help="time only the soft-threshold and page-copy wrappers")
ARGS = PARSER.parse_args()
sys.path.insert(0, str(Path(ARGS.src).resolve()))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import page_copy as pcm  # noqa: E402
from repro_torch.kernels._build import check_cuda, check_int32, dtype_code, launch  # noqa: E402
from repro_torch.kernels.bsr_matmul import bsr_from_dense, bsr_matmul  # noqa: E402
from repro_torch.kernels.lowrank_matmul import (lowrank_launch, lowrank_matmul,  # noqa: E402
                                                lowrank_plan)
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.stream import card_sms  # noqa: E402


def host_us(fn, calls=400, repeats=5):
    """Median host time per call, in microseconds."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return round(statistics.median(times), 2)


def copy_rows(dev, rand):
    """Soft-threshold at the gate stack and page copy at 3g's shape."""
    x = rand(8, 512, 1376)
    tau = torch.rand(8, device=dev) * 0.5
    out = torch.empty_like(x)
    per, numel = 512 * 1376, x.numel()
    # the first design's C entry takes (nb, per), the flat one (per, numel)
    dims = (8, per) if _build.SIGNATURES["soft_threshold_launch"][3] is ctypes.c_int else (
        per, numel)

    def soft_launch():
        launch("soft_threshold_launch", dev, x.data_ptr(), tau.data_ptr(), out.data_ptr(), *dims,
               dtype_code(x.dtype))

    want = ops.soft_threshold(x, tau)
    soft_launch()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        sys.exit("wrapper_host_time: the bare soft_threshold launch changed the output")
    row = {
        "soft_threshold": host_us(lambda: ops.soft_threshold(x, tau)),
        "check_cuda": host_us(lambda: check_cuda("soft_threshold", x=x, tau=tau)),
        "torch.empty_like(x)": host_us(lambda: torch.empty_like(x)),
        "launch": host_us(soft_launch),
    }
    print(f"soft_threshold (8, 512, 1376) f32, host us per call: {json.dumps(row)}")

    pool = rand(8, 128, 8, 16, 64)
    src = torch.arange(0, 16, 2, dtype=torch.int32, device=dev)
    dst = torch.arange(64, 80, 2, dtype=torch.int32, device=dev)
    page_bytes = 8 * 16 * 64 * 4
    row = {}
    cut = ()
    if hasattr(pcm, "page_copy_plan"):
        sms, resident = card_sms(dev.index or 0), pcm.card_resident(dev.index or 0)

        def plan():
            return pcm.page_copy_plan(8, 8, page_bytes, sms, resident)

        cut = (plan().chunk, plan().grid)

    def copy_launch():
        launch("page_copy_launch", dev, pool.data_ptr(), src.data_ptr(), dst.data_ptr(), 8, 8,
               128, page_bytes, *cut)

    def checks():
        check_cuda("page_copy", pool=pool, src=src, dst=dst)
        check_int32("page_copy", src=src, dst=dst)

    want = ref.page_copy_ref(pool.clone(), src, dst)
    copy_launch()
    torch.cuda.synchronize()
    if not torch.equal(pool, want):
        sys.exit("wrapper_host_time: the bare page_copy launch did not copy the pages")
    row["page_copy"] = host_us(lambda: ops.page_copy(pool, src, dst))
    row["check_cuda, check_int32"] = host_us(checks)
    if cut:
        row["page_copy_plan"] = host_us(plan)
    row["launch"] = host_us(copy_launch)
    print(f"page_copy 8 pairs x 8 layers, 32 KB f32 pages, host us per call: {json.dumps(row)}")


def main():
    if not torch.cuda.is_available():
        sys.exit("wrapper_host_time: needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    print(f"repro_torch from {Path(ops.__file__).resolve().parents[2]}")
    if ARGS.copy:
        copy_rows(dev, rand)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True
                             ).stdout.strip())
        return
    for site, (k, m) in (("gate", (512, 1376)), ("q", (512, 512))):
        r = 128
        p, vt = rand(k, r) / 8, rand(r, m) / 8
        plan = lowrank_plan(k, r, m, 4, 4, card_sms(dev.index or 0))
        for t_dim in (1, 8):
            x = rand(t_dim, k)
            x3 = x[None]
            y = torch.empty((t_dim, m), device=dev)
            t_cached = torch.empty((t_dim, plan.rp), dtype=torch.float32, device=dev)

            def cached():
                xrows, split_p = plan.xp.cut(t_dim, 1)
                _, split_v = plan.tv.cut(t_dim, 1)
                launch("lowrank_matmul_launch", dev, x.data_ptr(), p.data_ptr(), vt.data_ptr(),
                       None, t_cached.data_ptr(), y.data_ptr(), 1, t_dim, k, m, r, plan.rp, 1,
                       0, 1, plan.xp.nseg, plan.tv.nseg, xrows, split_p, split_v,
                       dtype_code(x.dtype), dtype_code(p.dtype))

            want = lowrank_matmul(x, p, vt)
            cached()
            torch.cuda.synchronize()
            if not torch.equal(y, want):
                sys.exit(f"wrapper_host_time: cached t changed the output ({site}, T={t_dim})")
            row = {
                "lowrank_matmul": host_us(lambda: lowrank_matmul(x, p, vt)),
                "lowrank_launch": host_us(lambda: lowrank_launch(x3, p, vt, y)),
                "cached t": host_us(cached),
                "torch.empty(t)": host_us(lambda: torch.empty(
                    (t_dim, plan.rp), dtype=torch.float32, device=dev)),
            }
            print(f"lowrank {site} K={k} r={r} M={m} T={t_dim}, host us per call: "
                  f"{json.dumps(row)}")

    n, m, bs = 512, 1376, 32
    mat = bsr_from_dense(rng.standard_normal((n, m)).astype(np.float32), bs, device=dev)
    for t_dim in (1, 8):
        x = rand(t_dim, n)
        print(f"bsr gate n={n} m={m} bs={bs} T={t_dim}, host us per call: "
              f"{json.dumps({'bsr_matmul': host_us(lambda: bsr_matmul(x, mat))})}")
    slots, hq, hkv, d, bs, nb = 8, 8, 8, 64, 16, 32
    kp, vp = rand(slots * nb, hkv, bs, d), rand(slots * nb, hkv, bs, d)
    table = torch.from_numpy(rng.permutation(slots * nb).reshape(slots, nb).astype(np.int32)
                             ).to(dev)
    lengths = torch.from_numpy(rng.integers(20, 430, slots).astype(np.int32)).to(dev)
    for name, kq in (("paged_attention", 1), ("paged_attention_kquery", 64)):
        q = rand(slots, hq, d) if kq == 1 else rand(slots, hq, kq, d)
        wrapper = getattr(ops, name)
        out = torch.empty_like(q)
        plan = pa.paged_plan(nb, bs, d, 4, max_segments=pa.MAX_SEGMENTS if kq == 1 else 1)
        shape = (slots, hq, hkv) + (() if kq == 1 else (kq,)) + (d, slots * nb, bs, nb)

        def launch_only():
            launch(f"{name}_launch", dev, q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                   table.data_ptr(), lengths.data_ptr(), out.data_ptr(), *shape,
                   plan.seg_keys, dtype_code(q.dtype))

        want = wrapper(q, kp, vp, table, lengths)
        launch_only()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            sys.exit(f"wrapper_host_time: the bare launch changed the output ({name})")
        row = {
            name: host_us(lambda: wrapper(q, kp, vp, table, lengths)),
            "_check": host_us(lambda: pa._check(name, q, kp, vp, table, lengths, kq)),
            "paged_plan": host_us(lambda: pa.paged_plan(nb, bs, d, 4)),
            "torch.empty_like(q)": host_us(lambda: torch.empty_like(q)),
            "launch": host_us(launch_only),
        }
        print(f"{name} {slots} slots x {hq} heads x kq={kq} x D={d}, f32, host us per call: "
              f"{json.dumps(row)}")
    copy_rows(dev, rand)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
