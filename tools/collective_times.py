#!/usr/bin/env python3
"""Time one collective on gloo ranks that share one card, as
``chip_smoke.py`` 4r's ranks do: a 16 KB f32 tensor (8 rows of 512, a
decode step's activations on salaad_llama_60m) all-reduced on the host,
all-reduced from the card through host memory, all-gathered on the host,
the copy to the host alone, and each after 40 small matmuls on the card.

    python3 tools/collective_times.py

Prints one JSON line per world size (2 and 4 ranks, started once each with
``launch/mesh.py::RankPool``): rank 0's mean ms per call over 300 calls
after 10 warm-up calls, then ``{"ok": true}``. Needs the card.
"""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def bench(rank, world, n_iter):
    import torch
    import torch.distributed as dist
    out = {}
    dev = torch.device("cuda")
    x_cpu = torch.randn(8 * 512)
    x_gpu = torch.randn(8 * 512, device=dev)
    w = torch.randn(512, 512, device=dev)
    a = torch.randn(8, 512, device=dev)

    def t(name, fn):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(n_iter):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / n_iter * 1e3

    t("allreduce_cpu", lambda: dist.all_reduce(x_cpu))
    t("allreduce_staged", lambda: dist.all_reduce(y := x_gpu.cpu()) or y.to(dev))
    t("sync_copy_only", lambda: x_gpu.cpu())
    t("matmul40_then_copy", lambda: [a @ w for _ in range(40)] and x_gpu.cpu())
    t("matmul40_then_staged", lambda: [a @ w for _ in range(40)] and
      (dist.all_reduce(y := x_gpu.cpu()) or y.to(dev)))
    t("matmul40_only", lambda: [a @ w for _ in range(40)])
    parts = [torch.empty_like(x_cpu) for _ in range(world)]
    t("allgather_cpu", lambda: dist.all_gather(parts, x_cpu))
    return out


if __name__ == "__main__":
    from repro_torch.launch.mesh import RankPool

    for world in (2, 4):
        with RankPool(world, "cuda") as pool:
            res = pool.run(bench, world, 300, timeout=300)
        print(json.dumps({"world": world, "backend": pool.backend,
                          "ms": {k: round(v, 4) for k, v in res[0].items()}}))
    print(json.dumps({"ok": True}))
