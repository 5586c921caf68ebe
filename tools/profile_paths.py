#!/usr/bin/env python3
"""Where the time goes on ``chip_smoke.py``'s serving and training paths:
each path run once under torch.profiler on the card.

    python3 tools/profile_paths.py [--paths 4a 4b 4f 4g 4i]

Paths (the default is all of them, in this order):
  - ``4a``: salaad_llama_60m at full width (seed 0, three exact-SVD ADMM
    sweeps), the keep 1.0 / 0.6 / 0.3 ``fused`` bank serving
    ``chip_smoke.bank_prompts``' 24 prompts on ``PagedServingEngine`` (8
    slots, 16-token pages, a 128-page pool, the prefix cache, the
    ``pressure`` tier policy), 32 new tokens each;
  - ``4b``: the same bank in ``bsr`` format, 8 requests of 20-300 tokens;
  - ``4f``: the ``AdapterBank`` of four tenants (HPA keeps 1.0 / 0.8 / 0.6 /
    0.4, three pool rows) in ``batched`` mode over 4a's prompts;
  - ``4g``: one train step and one ADMM step of ``Trainer`` on
    salaad_llama_60m (f32, seq 256, batch 8, K = 5), after 5 warm steps;
  - ``4i``: zamba2_2p7b at full width (54 layers, bf16, one randomized-SVD
    sweep, keep 1.0 / 0.5 fused tiers) serving one request of 8 prompt
    tokens and 16 new ones on ``ReferenceEngine``.
Each path is served once to warm up (4i excepted: its build dominates) and
then once under the profiler. Per path it prints the wall time under the
profiler, the device busy time and idle share, the ten longest device
kernels, and each CUDA kernel of the port (namespace ``salaad``) with its
share of device time and its launches. The profiler's teardown takes
minutes on the longer paths, which is why ``chip_smoke.py`` runs none.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PATHS = ("4a", "4b", "4f", "4g", "4i")


def profiled(torch, label: str, run) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    device_events = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device_events) / 1e3
    if busy_ms <= 0:
        print(f"profile {label}: the profiler recorded no device time (not measured)")
        return
    print(f"profile {label}: wall {wall_prof * 1e3:.1f} ms under the profiler, device "
          f"busy {busy_ms:.1f} ms, idle share {1 - busy_ms / (wall_prof * 1e3):.3f}")
    for e in sorted(device_events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} calls  "
              f"{e.key[:90]}")
    shares: dict[str, list] = {}
    for e in device_events:
        found = re.search(r"salaad::(?:\(anonymous namespace\)::)?(\w+)", e.key)
        if found:
            row = shares.setdefault(found.group(1), [0.0, 0])
            row[0] += e.self_device_time_total / 1e3
            row[1] += e.count
    for base, (ms_, calls) in sorted(shares.items(), key=lambda kv: -kv[1][0]):
        print(f"  share {base}: {ms_:.1f} ms of {busy_ms:.1f} device ms = "
              f"{ms_ / busy_ms:.3f} ({calls} launches)")
    pair = [shares[b] for b in ("lowrank_xp_kernel", "lowrank_tv_kernel") if b in shares]
    if pair:
        ms_ = sum(ms for ms, _ in pair)
        print(f"  share lowrank_matmul (both kernels): {ms_:.1f} ms of {busy_ms:.1f} device "
              f"ms = {ms_ / busy_ms:.3f}")


def llama_paths(torch, paths) -> None:
    import numpy as np

    from chip_smoke import ADAPTER_KEEPS, ADAPTER_ROWS, BUDGETS, MAX_NEW, bank_prompts
    from repro_torch.configs import get_arch
    from repro_torch.core.admm import SalaadConfig, admm_update, init_slr_state
    from repro_torch.core.hpa import hpa_keep_ratio
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import model as model_lib
    from repro_torch.serving.adapters import AdapterBank, adapterize
    from repro_torch.serving.deployed import DeployedModel
    from repro_torch.serving.elastic import ModelBank
    from repro_torch.serving.engine import EngineConfig, PagedServingEngine

    cfg = dataclasses.replace(get_arch("salaad_llama_60m"), kernel_impl="pallas")
    params = model_lib.init_params(cfg, seed=0)
    scfg = SalaadConfig(exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    for step in range(3):
        state, _ = admm_update(params, state, blocks, scfg, step)
    prompts = bank_prompts(np.random.default_rng(0), cfg.vocab_size, 16)
    tiers = tuple(range(len(BUDGETS)))
    if "4a" in paths or "4b" in paths:
        for fmt, label in (("fused", "4a"), ("bsr", "4b")):
            if label not in paths:
                continue
            bank = ModelBank.build(cfg, params, state, blocks, BUDGETS, kappa=0.7, fmt=fmt)
            if fmt == "fused":
                ecfg = EngineConfig(max_slots=8, max_len=512, block_size=16, num_blocks=128,
                                    prefix_cache=True, tier_policy="pressure")
                ps = prompts
            else:
                ecfg = EngineConfig(max_slots=8, max_len=512, block_size=16)
                rng = np.random.default_rng(7)
                ps = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                      for n in rng.integers(20, 301, 8)]

            def run():
                serve_batch(PagedServingEngine(bank, ecfg), cfg.vocab_size, len(ps), MAX_NEW,
                            0, tiers=tiers, prompts=ps)

            run()
            profiled(torch, label, run)
            del bank
    if "4f" in paths:
        models = [DeployedModel.build(cfg, params, hpa_keep_ratio(state, blocks, k, 0.7)[0],
                                      blocks, fmt="fused") for k in ADAPTER_KEEPS]
        bank = AdapterBank(models[0], [adapterize(models[0], m) for m in models],
                           max_resident=ADAPTER_ROWS).materialize()

        def adapter_run():
            engine = PagedServingEngine(bank, EngineConfig(
                max_slots=8, max_len=512, block_size=16, prefix_cache=True, adapters=True,
                max_resident_adapters=ADAPTER_ROWS))
            for i, p in enumerate(prompts):
                engine.submit(p, max_new_tokens=MAX_NEW, adapter=i % len(ADAPTER_KEEPS))
            engine.run()

        adapter_run()
        profiled(torch, "4f batched", adapter_run)


def train_path(torch) -> None:
    from chip_smoke import TRAIN_BATCH, TRAIN_K, TRAIN_LR, TRAIN_SEQ
    from repro_torch.configs import get_arch
    from repro_torch.core.admm import SalaadConfig
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.data.synthetic import DataConfig, SyntheticC4
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    arch = get_arch("salaad_llama_60m")
    trainer = Trainer(arch, TrainerConfig(
        total_steps=TRAIN_K, log_every=1,
        salaad=SalaadConfig(selection=SelectionConfig(min_dim=16), update_every=TRAIN_K),
        adam=AdamConfig(lr=TRAIN_LR)), device=torch.device("cuda"))
    data = SyntheticC4(DataConfig(arch.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0))
    state = trainer.fit(trainer.init(seed=0), data)
    profiled(torch, "4g one train step", lambda: trainer._train_step(state, data.batch(TRAIN_K)))
    profiled(torch, "4g one ADMM step", lambda: trainer._admm_step(state))


def hybrid_path(torch) -> None:
    import numpy as np

    from chip_smoke import HYBRID, HYBRID_BUDGETS, HYBRID_MAX_NEW
    from repro_torch.configs import get_arch
    from repro_torch.core.admm import SalaadConfig, admm_update, block_sketches, init_slr_state
    from repro_torch.core.hpa import hpa_keep_ratio
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import model as model_lib
    from repro_torch.serving.deployed import DeployedModel
    from repro_torch.serving.elastic import ModelBank
    from repro_torch.serving.engine import EngineConfig, ReferenceEngine

    dev = torch.device("cuda")
    zcfg = get_arch(HYBRID)
    zscfg = SalaadConfig(selection=SelectionConfig(min_dim=16))
    zparams = model_lib.init_params(zcfg, seed=0)
    zstate, zblocks = init_slr_state(zparams, zscfg)
    torch.backends.cuda.matmul.allow_tf32 = True
    for i, info in enumerate(zblocks):
        r_i = zstate[info.name].p.shape[-1]
        new, _ = admm_update(zparams, {info.name: zstate[info.name]}, [info], zscfg, 0,
                             sketches={info.name: block_sketches(0, i, info, r_i, 1, dev)})
        zstate[info.name] = new[info.name]
    models = [DeployedModel.build(zcfg, zparams, hpa_keep_ratio(zstate, zblocks, k, 0.7)[0],
                                  zblocks, fmt="fused") for k in HYBRID_BUDGETS]
    torch.backends.cuda.matmul.allow_tf32 = False
    del zstate
    bank = ModelBank(zcfg, models, keeps=HYBRID_BUDGETS)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, zcfg.vocab_size, 8).tolist()
    engine = ReferenceEngine(bank, EngineConfig(max_slots=4, max_len=128))
    profiled(torch, "4i (1 request)", lambda: serve_batch(
        engine, zcfg.vocab_size, 1, HYBRID_MAX_NEW, 0, prompts=[prompt]))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", nargs="+", choices=PATHS, default=list(PATHS))
    args = ap.parse_args(argv)
    import subprocess

    import torch

    if not torch.cuda.is_available():
        sys.exit("profile_paths: needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    _build.library()
    if {"4a", "4b", "4f"} & set(args.paths):
        llama_paths(torch, args.paths)
    if "4g" in args.paths:
        train_path(torch)
    if "4i" in args.paths:
        hybrid_path(torch)


if __name__ == "__main__":
    main()
