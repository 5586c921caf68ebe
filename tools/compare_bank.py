#!/usr/bin/env python3
"""A serving bank of ``chip_smoke.py``'s main path served from two source
trees on one card, in turns: other, this, this, other.

    git archive <commit> | tar -x -C build/other     # build/ is git-ignored
    python3 tools/compare_bank.py build/other/src [--bank bsr|fused ...]

``--bank`` takes one bank or several (default: both, bsr first); each bank
runs its four turns before the next. Each turn is a process of its own:
salaad_llama_60m at full width (seed 0, three exact-SVD ADMM sweeps), the
keep 1.0 / 0.6 / 0.3 bank, tiers round-robin, 32 new tokens per request, on
``PagedServingEngine`` (8 slots, 16-token pages, max_len 512):
  - ``bsr`` (phase 4b's path): the ``bsr`` format, 8 requests of 20-300
    tokens (seed 7);
  - ``fused`` (phase 4a's path): the ``fused`` format, 4a's 24 prompts
    (``chip_smoke.bank_prompts``: a shared two-page system prompt, three
    exact repeats), the prefix cache and the ``pressure`` tier policy on a
    128-page pool.
It serves once to warm up, three times timed (tok/s, median TTFT, launch
counts), and once under torch.profiler: device busy time, idle share, and
the device time and share of the paged attention kernel (decode and k-query
share one kernel), the block-CSC and low-rank kernels and the fused SLR
kernel. Both trees build first, in parallel.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[1]
THIS_SRC = ROOT / "src"
FAMILIES = {"paged": "paged_attention", "bsr": "bsr_matmul", "lowrank": "lowrank_",
            "fused": "slr_fused"}


def serve(src: str, bank_name: str) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(0, str(ROOT))
    import dataclasses

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import bank_prompts
    from repro_torch.configs import get_arch
    from repro_torch.core.admm import SalaadConfig, admm_update, init_slr_state
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import model as model_lib
    from repro_torch.serving.elastic import ModelBank
    from repro_torch.serving.engine import EngineConfig, PagedServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("salaad_llama_60m"), kernel_impl="pallas")
    params = model_lib.init_params(cfg, seed=0)
    scfg = SalaadConfig(exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    for step in range(3):
        state, _ = admm_update(params, state, blocks, scfg, step)
    bank = ModelBank.build(cfg, params, state, blocks, (1.0, 0.6, 0.3), kappa=0.7,
                           fmt=bank_name)
    if bank_name == "bsr":
        rng = np.random.default_rng(7)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                   for n in rng.integers(20, 301, 8)]
        ecfg = EngineConfig(max_slots=8, max_len=512, block_size=16)
        kernels = ("bsr_matmul", "lowrank_matmul", "paged_attention", "paged_attention_kquery")
    else:
        prompts = bank_prompts(np.random.default_rng(0), cfg.vocab_size, 16)
        ecfg = EngineConfig(max_slots=8, max_len=512, block_size=16, num_blocks=128,
                            prefix_cache=True, tier_policy="pressure")
        kernels = ("slr_matmul_stacked", "paged_attention", "paged_attention_kquery")

    def run():
        engine = PagedServingEngine(bank, ecfg)
        return serve_batch(engine, cfg.vocab_size, len(prompts), 32, 0, tiers=(0, 1, 2),
                           prompts=prompts)

    run()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    stats = [run() for _ in range(3)]
    counts = ops.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    kernel_ms = dict.fromkeys(FAMILIES, 0.0)
    for e in device:
        for family, tag in FAMILIES.items():
            if "salaad" in e.key and tag in e.key:
                kernel_ms[family] += e.self_device_time_total / 1e3
    return {"src": src, "bank": bank_name, "tok_per_s": [s["tok_per_s"] for s in stats],
            "ttft_p50_ms": [s["ttft_p50_ms"] for s in stats],
            "launches": {k: counts[k] for k in kernels},
            "profile": {"wall_ms": round(wall_ms, 1), "busy_ms": round(busy, 1),
                        "idle": round(1 - busy / wall_ms, 3),
                        **{f"{k}_ms": round(v, 1) for k, v in kernel_ms.items() if v},
                        **{f"{k}_share": round(v / busy, 3) for k, v in kernel_ms.items()
                           if v}}}


def main():
    if sys.argv[1:2] == ["--build"]:
        sys.path.insert(0, sys.argv[2])
        from repro_torch.kernels import _build
        _build.library()
        return
    if sys.argv[1:2] == ["--serve"]:
        print(json.dumps(serve(sys.argv[2], sys.argv[3])))
        return
    args = sys.argv[1:]
    banks = ["bsr", "fused"]
    if "--bank" in args:
        i = args.index("--bank")
        banks, args = args[i + 1:], args[:i]
    other = str(Path(args[0]).resolve())
    this = str(THIS_SRC)
    builds = [subprocess.Popen([sys.executable, str(HERE), "--build", s]) for s in (other, this)]
    if any(p.wait() for p in builds):
        sys.exit("compare_bank: a build failed")
    for bank_name in banks:
        for src in (other, this, this, other):
            out = subprocess.run([sys.executable, str(HERE), "--serve", src, bank_name],
                                 capture_output=True, text=True, check=True).stdout
            print(out.strip().splitlines()[-1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
