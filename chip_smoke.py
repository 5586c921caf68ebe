#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) on any
error:

1. build: compile every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a, one process per source) and load it;
2. model: salaad_llama_60m at full width (8 layers, d_model 512, f32,
   ``kernel_impl='pallas'``), random weights from a numpy seed, a non-trivial
   SLR state from ``init_slr_state`` + exact-SVD ``admm_update`` steps,
   deployed in the ``fused`` format, and the HPA spectrum
   ``ModelBank.build(budgets=(1.0, 0.6, 0.3), kappa=0.7)`` in the ``fused``
   and ``bsr`` formats over the same base parameters, and an ``AdapterBank``
   of four tenants (HPA keeps 1.0 / 0.8 / 0.6 / 0.4 of the same state, each
   adapterized onto the keep-1.0 base) with three device pool rows;
3. kernels: each of the ten kernels against its plain PyTorch version on
   the card, at the main path's shapes (f32 and bf16) and at ragged shapes
   (3a and 3h also hold the fused SLR kernels' rows bit for bit across calls
   of other T and B, and 3h times their six target shapes on the device
   alone, replayed from a CUDA graph; 3b and 3c hold the low-rank and
   block-CSC kernels' rows bit for bit across T, and two calls bit for bit,
   at every site, the block-CSC kernel at every block size with bf16
   activations over f32 tiles, and time the gate site at T = 512 and 8 and
   the q site at T = 8 with events and on the device alone beside their
   one-call yardsticks; 3h holds the per-slot empty-S corner's slots across
   B and against the low-rank kernel, bit for bit),
   then timed with CUDA events beside its plain version, a one-call PyTorch
   yardstick and its bound (bytes over 3.35 TB/s or operations over the
   peak of the kernel's route, whichever is larger, for this run's data:
   f32 at 67 TFLOP/s, 3xTF32 (the fused SLR body, flash attention in f32)
   at 495 / 3 TFLOP/s, bf16 at 989 TFLOP/s);
   3d/3e also hold paged decode and k-query bit for bit across two calls,
   each slot alone (B = 1) against its rows in the batch of 8, and with the
   other slots' lengths changed, f32 and bf16, kq = 1, 21, 64 and 70, and
   f32 queries over bf16 pages (the speculative engine's draft pools), kq =
   1, 4, 21 and 64, within 1e-4 of the output's largest value, at the
   engine's table and at a table of 2048 positions (decode in eight
   segments), and time both kernels in f32, bf16 and f32 over bf16 pages on
   the device alone beside SDPA on the gathered KV and beside the gather
   with SDPA, each target printed met or missed;
   3f also holds flash attention at head dims 80 (Zamba2) and 128, f32 and
   bf16, and times the main shape in bf16 and on the device alone beside
   SDPA; 3g and 3i also time page copy and soft-threshold on the device
   alone beside their library calls, print each target met or missed
   (page copy at most 2x its bound, an HBM bound for a pool that sits in
   L2, so also read against the launch floor of the same plan with
   identity pairs; soft-threshold at the embedding leaf at or
   below ``F.softshrink`` and at most 1.12x its bound) and time
   soft-threshold at 4i's largest sweep chunk (10, 2560, 10448) too;
   3g also holds int8 pages of 105 bytes and skips identity pairs and pairs
   outside the pool;
   3i holds the ADMM S-update's soft_threshold at the embedding and
   layer-stack shapes and at 70000 slices of 3 with NaN, +-inf, a zero and
   an above-max threshold;
   3j holds the unstacked fused SLR kernel (the hybrid's shared block) at
   zamba2's q, gate and down shapes and a ragged one, f32, bf16 and bf16
   activations over f32 tables, bs 128 and 32, T = 1, 8 and 37; at q, gate
   and down, T = 1 and 8, two calls must be bit-identical, and it times them
   with events and on the device alone beside torch.matmul on the dense
   bf16 W and on the dense f32 W in f32; a gate call must run at most two
   kernels and allocate only y and the (T, r) buffer of x @ P;
4. main path, with every launch count set to 0 just before each run and read
   just after:
   a. the fused bank serves 24 greedy requests through ``serve_batch``
      (tiers round-robin, a shared two-page system prompt, suffixes of
      20-300 tokens, three exact repeats of page-aligned prompts, 32 new
      tokens each) with one-shot prefill, the prefix cache and the pressure
      tier policy on a 128-page pool; flash attention, page copy, paged
      decode, paged k-query and the fused SLR kernel must each launch, and
      the run must show prefix hits, copy-on-write copies and downshifts;
      then the same run with ``telemetry=False`` and again with it on,
      whose streams must equal the first run's bit for bit (the three tok/s
      printed: the first run also pays first-use costs);
   b. the bsr bank serves 8 requests; the block-CSC and low-rank kernels must
      launch;
   c. the single fused model of the first slice serves 16 requests with
      chunked prefill of 64;
   d. the serve launcher's entry point (``repro_torch.launch.serve.main``,
      in this process) runs as a bank, with ``--adapters 3
      --max-resident-adapters 2``, with ``--engine speculative --spec-k 4``,
      with ``--kv-dtype int8`` and with ``--engine batched --trace-out
      --trace-events --metrics-port 0 --metrics-out`` (the files must pass
      the port's validators), and prints its lines;
   e. run (a) and (b) again under torch.profiler: device busy time, idle
      share and each kernel's share of device time;
   f. the adapter bank serves 24 greedy requests round-robin over its four
      tenants (the prompts of (a), one-shot prefill, the prefix cache, 8
      slots) in ``batched`` mode: the per-slot SLR kernel must launch, and
      the run must show LRU swaps and prefix hits; every stream must equal
      the same request served alone through a plain ModelBank of its tenant,
      and a ``grouped``-mode run of the same bank must give the same streams;
   g. SALAAD training at full width: ``Trainer.fit`` of salaad_llama_60m
      (f32, seq 256, batch 8, lr 1e-3, K = 5, 20 steps = 4 ADMM steps on
      the randomized SVD); soft_threshold must launch 8 times per ADMM step,
      every loss and statistic must be finite and the loss must fall; then
      one train step and one ADMM step under torch.profiler;
   h. 4g's state saved with ``train/checkpoint.py`` and served by
      ``python -m repro_torch.launch.serve --ckpt-dir`` (in process, so the
      launch counts are read): ``slr_params > 0`` and the stacked SLR and
      paged kernels launch;
   i. the hybrid at full width: zamba2_2p7b (54 layers, d_model 2560, bf16)
      from a numpy seed, one randomized-SVD ADMM sweep on the card (leaf by
      leaf, with the sketches one ``admm_update`` call draws; its matmuls
      and the tiers' dense products in TF32), HPA tiers keep 1.0 / 0.5 in
      the ``fused`` format as one ModelBank, 6 greedy requests (prompts of
      8-40 tokens, 16 new tokens, tiers round-robin) on ``ReferenceEngine``
      (4 slots, max_len 128): the unstacked SLR kernel must launch for every
      tier, 63 times per decode call when every shared-block site has both
      parts live; then one short request under torch.profiler;
   j. ``python -m repro_torch.launch.serve --arch zamba2_2p7b`` (the
      fallback note, then the reference engine) and ``--engine reference``
      on salaad_llama_60m;
   k. (run after f, while the banks are held) ``SpeculativeEngine`` on the
      fused bank, tier 0 verifying and tier 2 (keep 0.3) drafting into bf16
      pools, 8 slots, the first 16 of (a)'s prompts, 32 new tokens each:
      greedy under the parallel schedule with k = 4, whose streams must
      equal a static ``PagedServingEngine`` run at tier 0, then sampled
      (T = 0.8) under the sequential schedule with k = 4, where every
      request must emit 32 tokens; the paged decode and k-query, stacked SLR
      and flash kernels must launch; tok/s, acceptance rate and decode calls;
   l. (a)'s run with ``kv_dtype='int8'``: the paged kernels stay idle (the
      dequantizing gather), page copy copies payload and scale pools; the
      pools' bytes against (a)'s;
   m. (run after l) the slot-padded ``ServingEngine`` on the fused bank: 8
      slots, max_len 512, an f32 contiguous cache, (a)'s 24 prompts
      round-robin over the tiers, 32 new tokens each, greedy, static
      policy, telemetry and tracing on: flash attention and the fused SLR
      kernel must launch and the paged kernels must not; the registry must
      count 24 x 32 emitted tokens, 24 TTFTs and 24 x 31 ITLs; a second
      drive of the warm engine must leave ``jit_retraces`` at 0; the Chrome
      trace and one scrape of ``start_metrics_server(port=0)`` must pass
      their validators; tok/s, TTFT and ITL percentiles, the program-time
      histogram per (program, tier), peak memory, and the count of streams
      equal to a static ``PagedServingEngine`` run of the same bank;
5. parity: the first one-shot prefill's, the first chunk's and the first
   decode tick's logits on the card against the same model on the CPU, and
   one prefill and two decode steps over the per-slot contiguous cache (a
   row at max_len, whose writes drop, and one at max_len - 1); then
   (5b) five train steps and one ADMM step from one full-width state on the
   card and on the CPU, the same batches and CPU-drawn sketches; (5c) one
   fused tier of the hybrid at full width and one group (6 layers, f32) on
   the card and on the CPU: ReferenceEngine streams token-identical, decode
   logits within 1e-3, and on the card prefill(15) + one decode step against
   the no-cache forward (JAX's ``test_decode_consistency``); (5d) the first
   decode tick over int8 pages (a chunk quantized once, on the CPU), card
   against CPU, logits within 1e-3, with each side quantizing its own chunk
   printed beside it, and the sampler's keyed uniforms equal bit for bit.

Output: the card's name and power limit, build time, per-phase lines, then
one ``{"kernels": [...]}`` line and, last, the device line the harness reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import tempfile
import sys
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
N_REQUESTS = 16                  # the first slice's chunked path
N_BANK = 24                      # the fused bank's run
N_REPEAT = 3                     # exact repeats of page-aligned prompts
N_BSR = 8                        # the bsr bank's run
MAX_NEW = 32
BUDGETS = (1.0, 0.6, 0.3)
BANK_PAGES = 128                 # of the 256 a full pool of 8 x 512 tokens holds
ADAPTER_KEEPS = (1.0, 0.8, 0.6, 0.4)   # the adapter bank's tenants
ADAPTER_ROWS = 3                       # device pool rows: fewer than tenants, so LRU swaps
TRAIN_STEPS, TRAIN_K = 20, 5     # 4g: 4 ADMM steps
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 256, 8, 1e-3
PARITY_BATCH = 4                 # 5b: card vs CPU training
HYBRID = "zamba2_2p7b"
HYBRID_BUDGETS = (1.0, 0.5)
N_HYBRID, HYBRID_MAX_NEW = 6, 16  # 4i: requests, new tokens each
N_HYBRID_CPU = 4                 # 5c: requests, MAX_NEW_CPU new tokens each
MAX_NEW_CPU = 8
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
PEAK_3XTF32_FLOPS = 495e12 / 3   # H100 SXM dense TF32, three TF32 products per f32 product
PEAK_2XTF32_FLOPS = 495e12 / 2   # two TF32 products: f32 queries over bf16 pages
PEAK_BF16_FLOPS = 989e12         # H100 SXM dense bf16 on the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # relative to the output's max |value|
LOGIT_TOL = 1e-3                            # card vs CPU, relative to max |logit|
# int8 pages each side quantized for itself, card vs CPU, relative to max |logit|:
# rounding flips of int8 quanta cascade over the layers. The card read 2.4e-3
# (1.168e-2 at max |logit| 4.85), as far as the CPU from itself with its
# embedding scaled by 1 + 1e-6 N(0, 1) (5d prints that witness): 4x that reading
INT8_OWN_TOL = 1e-2


T_START = time.perf_counter()


def phase(name: str):
    print(f"[{time.perf_counter() - T_START:.1f} s] phase {name}")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, calls: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph and replayed, so no host work sits between the launches."""
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
    return time_ms(torch, graph.replay, iters=10, warmup=2) / calls


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """The least time for the work: its bytes over the memory rate, or its
    operations over ``peak``, the rate of the route the kernel takes
    (``PEAK_3XTF32_FLOPS`` for the fused SLR body's 3xTF32 products)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def bank_prompts(rng, vocab: int, block: int) -> list[list[int]]:
    """N_BANK prompts: a shared two-page system prompt + 20-300 suffix tokens;
    the first N_REPEAT are page-aligned and come back as exact repeats after
    the first wave of admissions (the copy-on-write case)."""
    lens = rng.integers(20, 301, N_BANK - N_REPEAT)    # drawn first: the same for any vocab
    lens[:N_REPEAT] = -(-lens[:N_REPEAT] // block) * block
    system = rng.integers(0, vocab, 2 * block).tolist()
    out = [system + rng.integers(0, vocab, int(n)).tolist() for n in lens]
    for i in range(N_REPEAT):
        out.insert(8 + 2 * i, out[i])
    return out


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").exists():
        fail("src/repro_torch is missing: run chip_smoke.py from a checkout of the repo")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_arch
    from repro_torch.core.admm import SalaadConfig, admm_update, init_slr_state
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.bsr_matmul import bsr_from_dense, bsr_to_dense
    from repro_torch.launch.serve import serve_batch
    from repro_torch.core.hpa import hpa_keep_ratio
    from repro_torch.models import model as model_lib
    from repro_torch.serving.adapters import AdapterBank, adapterize
    from repro_torch.serving.deployed import DeployedModel
    from repro_torch.serving.elastic import ModelBank
    from repro_torch.serving import kv_quant
    from repro_torch.serving.engine import EngineConfig, PagedServingEngine, ReferenceEngine
    from repro_torch.serving.engine import ServingEngine, keyed_uniform
    from repro_torch.serving.telemetry import start_metrics_server, validate_prometheus_text
    from repro_torch.serving.trace import validate_chrome_trace
    from repro_torch.serving.speculative import SpeculativeEngine
    from repro_torch.serving.slr_params import deployment_report
    from repro_torch.core.admm import block_sketches
    from repro_torch.tree import tree_map
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.data.synthetic import DataConfig, SyntheticC4
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train import checkpoint
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.core.selection import select_blocks
    from repro_torch.core.sparse import to_dense as sparse_dense
    from repro_torch.tree import leaf_by_path

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase("1")
    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s ({_build.build().name})")

    phase("2")
    # ---- 2. model -------------------------------------------------------------
    cfg = dataclasses.replace(get_arch("salaad_llama_60m"), kernel_impl="pallas")
    t0 = time.perf_counter()
    params = model_lib.init_params(cfg, seed=SEED)
    scfg = SalaadConfig(exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    for step in range(3):
        state, stats = admm_update(params, state, blocks, scfg, step)
    dm = DeployedModel.build(cfg, params, state, blocks, fmt="fused")
    torch.cuda.synchronize()
    layers = dm.params["layers"]
    sites = {k: v for k, v in layers.items() if getattr(v, "fuse", False)}
    if sorted(sites) != ["down", "gate", "k", "o", "q", "up", "v"]:
        fail(f"expected 7 fused sites per layer, got {sorted(sites)}")
    print(f"model: {cfg.name} layers={cfg.num_layers} d_model={cfg.d_model} "
          f"built in {time.perf_counter() - t0:.3f} s; mean recon err "
          f"{float(stats['_mean_recon_err']):.6g}")
    for name, lin in sorted(sites.items()):
        st = lin.s_stack
        live = int(st.counts.sum())
        print(f"  site {name}: shape {lin.shape} r={lin.p.shape[-1]} bs={st.block_size} "
              f"maxb={st.rows.shape[-1]} live tiles {live} "
              f"({live / st.counts.numel() / st.rows.shape[-1]:.3f} of slots)")
    t0 = time.perf_counter()
    banks = {fmt: ModelBank.build(cfg, params, state, blocks, BUDGETS, kappa=0.7, fmt=fmt)
             for fmt in ("fused", "bsr")}
    torch.cuda.synchronize()
    for fmt, bank in banks.items():
        print(f"bank {fmt} (built with the other in {time.perf_counter() - t0:.3f} s): "
              f"{json.dumps(bank.report())}")
        if bank.shared_base_bytes() <= 0:
            fail(f"the {fmt} bank's tiers share no base leaves")
    t0 = time.perf_counter()
    tenant_models = [DeployedModel.build(cfg, params, hpa_keep_ratio(state, blocks, k, 0.7)[0],
                                         blocks, fmt="fused") for k in ADAPTER_KEEPS]
    tenants = [adapterize(tenant_models[0], m) for m in tenant_models]
    adapter_bank = AdapterBank(tenant_models[0], tenants,
                               names=[f"keep={k:g}" for k in ADAPTER_KEEPS],
                               max_resident=ADAPTER_ROWS).materialize()
    torch.cuda.synchronize()
    print(f"adapter bank (built in {time.perf_counter() - t0:.3f} s): "
          f"{json.dumps(adapter_bank.adapter_report())}")

    phase("3")
    # ---- 3. kernels against their plain versions, then timed ----------------
    rng = np.random.default_rng(SEED)

    def rand(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    def check(name, got, want, dtype, floor: float = 1.0) -> float:
        """``got`` against the plain version's ``want``: max |error| within the
        dtype's tolerance of max(|want|, ``floor``)."""
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name}: non-finite output")
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), floor)
        tol = TOL[str(dtype).split(".")[-1]]
        status = "ok" if err <= tol * scale else "MISMATCH"
        print(f"  check {name} [{str(dtype).split('.')[-1]}]: max_abs_err {err:.3e} "
              f"(tol {tol:g} x {scale:.3g}) {status}")
        if status != "ok":
            fail(f"{name} disagrees with its plain version")
        return err

    results = {}
    gate = sites["gate"]
    lay = cfg.num_layers // 2          # the layer every kernel check uses

    # 3a. fused SLR matmul: every site at a decode tick (T=8) and a chunk tick
    # (T=512 = 8 slots x 64), bf16 copies, ragged T
    slr_err = 0.0
    for name, lin in sorted(sites.items()):
        for t_dim in (8, 512, 37):
            x = rand(t_dim, lin.shape[0])
            want = ref.slr_matmul_stacked_ref(x, lin.p, lin.vt, lin.s_stack, lay)
            err = check(f"slr_matmul_stacked {name} T={t_dim}",
                        ops.slr_matmul_stacked(x, lin.p, lin.vt, lin.s_stack, lay),
                        want, torch.float32)
            slr_err = max(slr_err, err)
    # row invariance: a row of y does not depend on the call that carries it
    # (inputs from a generator of their own: later phases draw as before)
    inv_rng = np.random.default_rng(SEED + 1)

    def inv_rand(*shape):
        return torch.from_numpy(inv_rng.standard_normal(shape, dtype=np.float32)).to(dev)

    for name, lin in sorted(sites.items()):
        for t_dim in (8, 37, 512):
            x = inv_rand(t_dim, lin.shape[0])
            y = ops.slr_matmul_stacked(x, lin.p, lin.vt, lin.s_stack, lay)
            for t in (1, 3, 8):
                if not torch.equal(ops.slr_matmul_stacked(x[:t].contiguous(), lin.p, lin.vt,
                                                          lin.s_stack, lay), y[:t]):
                    fail(f"slr_matmul_stacked {name}: x[:{t}] differs from the first {t} rows "
                         f"of the call on T={t_dim}")
    print("  check slr_matmul_stacked: x[:t] gives the first t rows of the call on x, bit for "
          "bit, t in (1, 3, 8), T in (8, 37, 512), every site")
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    g_bf = dataclasses.replace(gate.s_stack, vals=bf(gate.s_stack.vals))
    x = bf(rand(512, cfg.d_model))
    check("slr_matmul_stacked gate T=512", ops.slr_matmul_stacked(
        x, bf(gate.p), bf(gate.vt), g_bf, lay), ref.slr_matmul_stacked_ref(
        x, bf(gate.p), bf(gate.vt), g_bf, lay), torch.bfloat16)
    x = rand(512, cfg.d_model)
    s_gate = gate.s_stack.at_layer(lay)
    s_dense = bsr_to_dense(s_gate).contiguous()
    w_dense = (gate.p[lay] @ gate.vt[lay] + s_dense).contiguous()
    live = int(gate.s_stack.counts[lay].sum())
    (k_dim, m_dim), r = gate.shape, gate.p.shape[-1]
    bs = gate.s_stack.block_size
    nbytes = 4 * (512 * k_dim + k_dim * r + r * m_dim + 512 * m_dim + live * bs * bs) \
        + 4 * (gate.s_stack.counts.shape[1] + live)
    flops = 2 * 512 * (k_dim * r + r * m_dim + live * bs * bs)
    results["slr_matmul_stacked"] = dict(
        shape=f"gate site, T=512 (chunk tick), K={k_dim} M={m_dim} r={r} bs={bs} "
              f"live tiles {live}",
        max_abs_err=slr_err,
        ms=time_ms(torch, lambda: ops.slr_matmul_stacked(x, gate.p, gate.vt, gate.s_stack, lay)),
        plain_ms=time_ms(torch, lambda: ref.slr_matmul_stacked_ref(
            x, gate.p, gate.vt, gate.s_stack, lay)),
        library_ms=time_ms(torch, lambda: torch.matmul(x, w_dense)),
        bound=bound_ms(nbytes, flops, PEAK_3XTF32_FLOPS),
    )
    decode_rows = {}           # decode-width (T=8) timings of the SLR kernels
    x8 = rand(8, k_dim)
    nbytes8 = 4 * (8 * k_dim + k_dim * r + r * m_dim + 8 * m_dim + live * bs * bs) \
        + 4 * (gate.s_stack.counts.shape[1] + live)
    decode_rows["slr_matmul_stacked gate T=8"] = (
        time_ms(torch, lambda: ops.slr_matmul_stacked(x8, gate.p, gate.vt, gate.s_stack, lay)),
        time_ms(torch, lambda: ref.slr_matmul_stacked_ref(x8, gate.p, gate.vt, gate.s_stack,
                                                          lay)),
        time_ms(torch, lambda: torch.matmul(x8, w_dense)),
        bound_ms(nbytes8, 2 * 8 * (k_dim * r + r * m_dim + live * bs * bs), PEAK_3XTF32_FLOPS))
    q_site = sites["q"]
    q_live = int(q_site.s_stack.counts[lay].sum())
    q_bs = q_site.s_stack.block_size
    q_dense = (q_site.p[lay] @ q_site.vt[lay]
               + bsr_to_dense(q_site.s_stack.at_layer(lay))).contiguous()
    decode_rows["slr_matmul_stacked q T=8 (bs=128)"] = (
        time_ms(torch, lambda: ops.slr_matmul_stacked(x8, q_site.p, q_site.vt,
                                                      q_site.s_stack, lay)),
        time_ms(torch, lambda: ref.slr_matmul_stacked_ref(x8, q_site.p, q_site.vt,
                                                          q_site.s_stack, lay)),
        time_ms(torch, lambda: torch.matmul(x8, q_dense)),
        bound_ms(4 * (8 * k_dim * 2 + k_dim * r * 2 + q_live * q_bs * q_bs)
                 + 4 * (q_site.s_stack.counts.shape[1] + q_live),
                 2 * 8 * (k_dim * r * 2 + q_live * q_bs * q_bs), PEAK_3XTF32_FLOPS))

    # 3b. low-rank matmul (the empty-S corner, and the bsr format's L part) on
    # the gate site's factors: f32, bf16 and bf16 activations over f32
    # factors; then, at every site, rows bit for bit across T and two calls
    # bit-identical (inputs from a generator of their own: later phases draw
    # as before)
    lr_err = 0.0
    for t_dim in (8, 512, 37):
        x = rand(t_dim, k_dim)
        lr_err = max(lr_err, check(f"lowrank_matmul gate T={t_dim}", ops.lowrank_matmul(
            x, gate.p[lay], gate.vt[lay]), ref.lowrank_matmul_ref(x, gate.p[lay], gate.vt[lay]),
            torch.float32))
    x = bf(rand(512, k_dim))
    check("lowrank_matmul gate T=512", ops.lowrank_matmul(
        x, bf(gate.p[lay]), bf(gate.vt[lay])), ref.lowrank_matmul_ref(
        x, bf(gate.p[lay]), bf(gate.vt[lay])), torch.bfloat16)
    st_rng = np.random.default_rng(SEED + 2)

    def st_rand(*shape):
        return torch.from_numpy(st_rng.standard_normal(shape, dtype=np.float32)).to(dev)

    for t_dim in (8, 37):
        x = bf(st_rand(t_dim, k_dim))
        check(f"lowrank_matmul gate T={t_dim} [float32 factors]", ops.lowrank_matmul(
            x, gate.p[lay], gate.vt[lay]), ref.lowrank_matmul_ref(x, gate.p[lay], gate.vt[lay]),
            torch.bfloat16)

    def rows_hold(name, call, n_in):
        """A row of y is bit for bit the same in a call of any T, and two
        calls on the same inputs agree bit for bit."""
        x = st_rand(512, n_in)
        y = call(x)
        if not torch.equal(call(x), y):
            fail(f"{name}: two calls on the same inputs differ")
        for t in (1, 8, 37):
            if not torch.equal(call(x[:t].contiguous()), y[:t]):
                fail(f"{name}: x[:{t}] differs from the first {t} rows of the call on T=512")

    for name, lin in sorted(sites.items()):
        rows_hold(f"lowrank_matmul {name}", lambda x, lin=lin: ops.lowrank_matmul(
            x, lin.p[lay], lin.vt[lay]), lin.shape[0])
    print("  check lowrank_matmul: x[:t] gives the first t rows of the call on x, bit for bit, "
          "t in (1, 8, 37), T = 512, and two calls agree bit for bit, every site")

    def stream_row(call, plain_call, lib_call, nbytes, flops):
        """Event and device-alone (CUDA graph) times of a kernel call and of
        its one-call PyTorch yardstick, the plain version's time, the bound
        at the kernel's route (3xTF32 products, 495 / 3 TFLOP/s)."""
        return dict(ms=time_ms(torch, call), graph_ms=graph_ms(torch, call),
                    plain_ms=time_ms(torch, plain_call), library_ms=time_ms(torch, lib_call),
                    library_graph_ms=graph_ms(torch, lib_call),
                    bound=bound_ms(nbytes, flops, PEAK_3XTF32_FLOPS))

    # timed rows: the T = 512 input draws from rng as the phase always did,
    # the decode rows' from st_rng
    stream_rows = {}           # the low-rank and block-CSC rows, timed both ways
    for name, lin, t_dim in (("gate", gate, 512), ("gate", gate, 8), ("q", q_site, 8)):
        p_l, vt_l = lin.p[lay], lin.vt[lay]
        (k_l, m_l), r_l = lin.shape, p_l.shape[-1]
        x = rand(t_dim, k_l) if t_dim == 512 else st_rand(t_dim, k_l)
        stream_rows[f"lowrank_matmul {name} T={t_dim}"] = stream_row(
            lambda x=x, p_l=p_l, vt_l=vt_l: ops.lowrank_matmul(x, p_l, vt_l),
            lambda x=x, p_l=p_l, vt_l=vt_l: ref.lowrank_matmul_ref(x, p_l, vt_l),
            lambda x=x, p_l=p_l, vt_l=vt_l: torch.linalg.multi_dot([x, p_l, vt_l]),
            4 * (t_dim * k_l + k_l * r_l + r_l * m_l + t_dim * m_l),
            2 * t_dim * (k_l * r_l + r_l * m_l))
    results["lowrank_matmul"] = dict(
        shape=f"gate factors, T=512, K={k_dim} M={m_dim} r={r}", max_abs_err=lr_err,
        **stream_rows["lowrank_matmul gate T=512"])

    # 3c. block-CSC matmul: every site's S at the bsr format's widths, bf16 and
    # bf16 activations over f32 tiles, ragged T / n / m with per-column counts
    # below MAXB at every block size; rows bit for bit across T and two calls
    # bit-identical at every site
    bsr_err = 0.0
    for name, lin in sorted(sites.items()):
        mat = lin.s_stack.at_layer(lay)
        for t_dim in (8, 512, 37):
            x = rand(t_dim, lin.shape[0])
            bsr_err = max(bsr_err, check(f"bsr_matmul {name} T={t_dim}",
                                         ops.bsr_matmul(x, mat), ref.bsr_matmul_ref(x, mat),
                                         torch.float32))
    x = bf(rand(512, k_dim))
    g_bf_mat = dataclasses.replace(s_gate, vals=bf(s_gate.vals))
    check("bsr_matmul gate T=512", ops.bsr_matmul(x, g_bf_mat),
          ref.bsr_matmul_ref(x, g_bf_mat), torch.bfloat16)
    for bs_r, n_r, m_r in ((8, 40, 36), (64, 200, 130), (128, 300, 260)):
        ib, jb = -(-n_r // bs_r), -(-m_r // bs_r)
        tiles = rng.random((ib, jb)) < 0.5
        s_np = rng.standard_normal((ib * bs_r, jb * bs_r)).astype(np.float32)
        s_np *= np.repeat(np.repeat(tiles, bs_r, 0), bs_r, 1)
        mat = bsr_from_dense(s_np[:n_r, :m_r], bs_r, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            mat_d = dataclasses.replace(mat, vals=mat.vals.to(dt))
            x = rand(21, n_r).to(dt)
            err = check(f"bsr_matmul ragged bs={bs_r} n={n_r} m={m_r} T=21",
                        ops.bsr_matmul(x, mat_d), ref.bsr_matmul_ref(x, mat_d), dt)
            if dt == torch.float32:
                bsr_err = max(bsr_err, err)
    for bs_r, n_r, m_r in ((8, 40, 36), (16, 72, 50), (32, 100, 70), (64, 200, 130),
                           (128, 300, 260)):
        ib, jb = -(-n_r // bs_r), -(-m_r // bs_r)
        live_r = st_rng.random((ib, jb)) < 0.5
        s_np = st_rng.standard_normal((ib * bs_r, jb * bs_r)).astype(np.float32)
        s_np *= np.repeat(np.repeat(live_r, bs_r, 0), bs_r, 1)
        mat = bsr_from_dense(s_np[:n_r, :m_r], bs_r, device=dev)
        x = bf(st_rand(21, n_r))
        check(f"bsr_matmul ragged bs={bs_r} n={n_r} m={m_r} T=21 [float32 tiles]",
              ops.bsr_matmul(x, mat), ref.bsr_matmul_ref(x, mat), torch.bfloat16)
        rows_hold(f"bsr_matmul ragged bs={bs_r}", lambda x, mat=mat: ops.bsr_matmul(x, mat), n_r)
    for name, lin in sorted(sites.items()):
        rows_hold(f"bsr_matmul {name}", lambda x, mat=lin.s_stack.at_layer(lay): ops.bsr_matmul(
            x, mat), lin.shape[0])
    print("  check bsr_matmul: x[:t] gives the first t rows of the call on x, bit for bit, "
          "t in (1, 8, 37), T = 512, and two calls agree bit for bit, every site and block size")
    s_q = q_site.s_stack.at_layer(lay)
    for name, mat, t_dim in (("gate", s_gate, 512), ("gate", s_gate, 8), ("q", s_q, 8)):
        n_l, m_l = mat.shape
        live_l, bs_l = int(mat.counts.sum()), mat.block_size
        dense_l = bsr_to_dense(mat).contiguous()
        x = rand(t_dim, n_l) if t_dim == 512 else st_rand(t_dim, n_l)
        stream_rows[f"bsr_matmul {name} T={t_dim} (bs={bs_l})"] = stream_row(
            lambda x=x, mat=mat: ops.bsr_matmul(x, mat),
            lambda x=x, mat=mat: ref.bsr_matmul_ref(x, mat),
            lambda x=x, d=dense_l: torch.matmul(x, d),
            4 * (t_dim * n_l + t_dim * m_l + live_l * bs_l * bs_l) + 4 * (mat.counts.numel()
                                                                         + live_l),
            2 * t_dim * live_l * bs_l * bs_l)
    results["bsr_matmul"] = dict(
        shape=f"gate site S, T=512, n={k_dim} m={m_dim} bs={bs} live tiles {live}",
        max_abs_err=bsr_err, **stream_rows[f"bsr_matmul gate T=512 (bs={bs})"])

    # 3d/3e. paged attention at the engine's pool shapes: 8 slots, 8 heads,
    # head_dim 64, 16-token pages, 32 pages per slot (max_len 512)
    slots, hq, hkv, d, pbs, nb = 8, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 16, 32
    n_pages = slots * nb
    kp, vp = rand(n_pages, hkv, pbs, d), rand(n_pages, hkv, pbs, d)
    table = torch.from_numpy(rng.permutation(n_pages).reshape(slots, nb).astype(np.int32)).to(dev)
    lengths_np = rng.integers(20, 430, slots).astype(np.int32)
    lengths_np[0] = pbs * 5 - 1                       # a page edge
    lengths = torch.from_numpy(lengths_np).to(dev)
    seq = nb * pbs
    k_g = kp[table.long()].permute(0, 2, 1, 3, 4).reshape(slots, hkv, seq, d)
    v_g = vp[table.long()].permute(0, 2, 1, 3, 4).reshape(slots, hkv, seq, d)
    pos = torch.arange(seq, device=dev)

    q = rand(slots, hq, d)
    pa_err = check("paged_attention", ops.paged_attention(q, kp, vp, table, lengths),
                   ref.paged_attention_ref(q, kp, vp, table, lengths), torch.float32)
    check("paged_attention", ops.paged_attention(bf(q), bf(kp), bf(vp), table, lengths),
          ref.paged_attention_ref(bf(q), bf(kp), bf(vp), table, lengths), torch.bfloat16)
    # f32 queries over bf16 pages (the speculative engine's draft pools under
    # the f32 model): within 1e-4 of the output's largest value
    mixed_err = {"paged_attention": check(
        "paged_attention f32 q over bf16 pages", ops.paged_attention(q, bf(kp), bf(vp), table,
                                                                     lengths),
        ref.paged_attention_ref(q, bf(kp), bf(vp), table, lengths), torch.float32, floor=0.0)}
    ragged = torch.tensor([0, 15, 16, 17, 200, 511, 1, 63], dtype=torch.int32, device=dev)
    pa_err = max(pa_err, check("paged_attention ragged lengths", ops.paged_attention(
        q, kp, vp, table, ragged), ref.paged_attention_ref(q, kp, vp, table, ragged),
        torch.float32))
    keys = np.minimum(lengths_np + 1, seq)
    dec_mask = (pos[None, :] <= lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None]

    def paged_bound(itemsize, n_q, n_keys, n_pairs, n_pages_read, kv_itemsize=None):
        """q and out once, each visible K/V row once, the lengths and the
        table entries read; 4 D flops per (query row, visible key) pair, at
        the route's rate (3xTF32 for f32, bf16 on the tensor cores, two TF32
        products for f32 queries over bf16 pages)."""
        kv_itemsize = itemsize if kv_itemsize is None else kv_itemsize
        peak = PEAK_3XTF32_FLOPS if itemsize == kv_itemsize == 4 else (
            PEAK_BF16_FLOPS if itemsize == 2 else PEAK_2XTF32_FLOPS)
        return bound_ms(itemsize * 2 * n_q * d + kv_itemsize * 2 * hkv * d * n_keys
                        + 4 * (slots + n_pages_read), 4 * hq * d * n_pairs, peak)

    results["paged_attention"] = dict(
        shape=f"decode tick: {slots} slots, {hq} heads, head_dim {d}, pages of {pbs}, "
              f"lengths {int(lengths_np.min())}-{int(lengths_np.max())}",
        max_abs_err=pa_err,
        ms=time_ms(torch, lambda: ops.paged_attention(q, kp, vp, table, lengths)),
        plain_ms=time_ms(torch, lambda: ref.paged_attention_ref(q, kp, vp, table, lengths)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k_g, v_g, attn_mask=dec_mask)),
        bound=paged_bound(4, slots * hq, int(keys.sum()), int(keys.sum()),
                          int(np.ceil(keys / pbs).sum())),
    )

    kq = 64
    lengths_kq = torch.from_numpy(np.minimum(lengths_np, seq - kq)).to(dev)
    qk = rand(slots, hq, kq, d)
    kq_err = check("paged_attention_kquery", ops.paged_attention_kquery(
        qk, kp, vp, table, lengths_kq), ref.paged_attention_kquery_ref(
        qk, kp, vp, table, lengths_kq), torch.float32)
    check("paged_attention_kquery", ops.paged_attention_kquery(
        bf(qk), bf(kp), bf(vp), table, lengths_kq), ref.paged_attention_kquery_ref(
        bf(qk), bf(kp), bf(vp), table, lengths_kq), torch.bfloat16)
    mixed_err["paged_attention_kquery"] = check(
        "paged_attention_kquery f32 q over bf16 pages", ops.paged_attention_kquery(
            qk, bf(kp), bf(vp), table, lengths_kq), ref.paged_attention_kquery_ref(
            qk, bf(kp), bf(vp), table, lengths_kq), torch.float32, floor=0.0)
    q_rag = rand(3, hq, 21, d)
    kq_err = max(kq_err, check("paged_attention_kquery kq=21", ops.paged_attention_kquery(
        q_rag, kp, vp, table[:3], lengths_kq[:3]), ref.paged_attention_kquery_ref(
        q_rag, kp, vp, table[:3], lengths_kq[:3]), torch.float32))
    lk = lengths_kq.cpu().numpy().astype(np.int64)
    pairs = int(sum(np.minimum(lk[b] + np.arange(kq) + 1, seq).sum() for b in range(slots)))
    kq_keys = np.minimum(lk + kq, seq)
    kq_mask = (pos[None, None, :] <= (lengths_kq[:, None] + torch.arange(kq, device=dev))[
        :, :, None])[:, None]
    results["paged_attention_kquery"] = dict(
        shape=f"chunk tick: {slots} slots x {kq} queries, {hq} heads, head_dim {d}",
        max_abs_err=kq_err,
        ms=time_ms(torch, lambda: ops.paged_attention_kquery(qk, kp, vp, table, lengths_kq)),
        plain_ms=time_ms(torch, lambda: ref.paged_attention_kquery_ref(
            qk, kp, vp, table, lengths_kq)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qk, k_g, v_g, attn_mask=kq_mask)),
        bound=paged_bound(4, slots * hq * kq, int(kq_keys.sum()), pairs,
                          int(np.ceil(kq_keys / pbs).sum())),
    )

    # device alone (20 calls replayed from one CUDA graph), f32 and bf16: each
    # kernel beside SDPA on K/V gathered beforehand and SDPA with the page
    # gather (the engine's path without the kernel); each target met or missed
    def gathered(pages):
        return pages[table.long()].permute(0, 2, 1, 3, 4).reshape(slots, hkv, seq, d)

    paged_rows = {}
    # (q and output, pages): f32, bf16, and f32 queries over bf16 pages, whose
    # SDPA yardstick runs in f32 on the pages widened
    for dt, kv_dt, label in ((torch.float32, torch.float32, "float32"),
                             (torch.bfloat16, torch.bfloat16, "bfloat16"),
                             (torch.float32, torch.bfloat16, "float32 over bfloat16")):
        kp_, vp_ = kp.to(kv_dt), vp.to(kv_dt)
        kg_, vg_ = gathered(kp_).to(dt), gathered(vp_).to(dt)
        size = torch.empty((), dtype=dt).element_size()
        kv_size = torch.empty((), dtype=kv_dt).element_size()
        for name, q_, lens_, mask_, bnd in (
                ("paged_attention", q.to(dt), lengths, dec_mask, paged_bound(
                    size, slots * hq, int(keys.sum()), int(keys.sum()),
                    int(np.ceil(keys / pbs).sum()), kv_size)),
                ("paged_attention_kquery", qk.to(dt), lengths_kq, kq_mask, paged_bound(
                    size, slots * hq * kq, int(kq_keys.sum()), pairs,
                    int(np.ceil(kq_keys / pbs).sum()), kv_size))):
            q4_ = q_[:, :, None] if q_.dim() == 3 else q_
            call = lambda name=name, q_=q_, kp_=kp_, vp_=vp_, lens_=lens_: (  # noqa: E731
                getattr(ops, name)(q_, kp_, vp_, table, lens_))
            paged_rows[(name, label)] = dict(
                ms=time_ms(torch, call), graph_ms=graph_ms(torch, call),
                sdpa_ms=time_ms(torch, lambda q4_=q4_, kg_=kg_, vg_=vg_, mask_=mask_:
                                F.scaled_dot_product_attention(q4_, kg_, vg_, attn_mask=mask_)),
                sdpa_graph_ms=graph_ms(torch, lambda q4_=q4_, kg_=kg_, vg_=vg_, mask_=mask_:
                                       F.scaled_dot_product_attention(q4_, kg_, vg_,
                                                                      attn_mask=mask_)),
                gather_sdpa_graph_ms=graph_ms(
                    torch, lambda q4_=q4_, kp_=kp_, vp_=vp_, mask_=mask_, dt=dt:
                    F.scaled_dot_product_attention(q4_, gathered(kp_).to(dt),
                                                   gathered(vp_).to(dt), attn_mask=mask_)),
                bound=bnd)
    for (name, dt), r_ in paged_rows.items():
        target = r_["sdpa_graph_ms"]
        also = ""
        if dt == "float32":
            cap = 0.010 if name == "paged_attention" else 4 * r_["bound"][0]
            target, also = min(target, cap), f" and {cap:.4f} ms"
        print(f"  time {name} [{dt}]: kernel {r_['ms']:.4f} ms (device alone "
              f"{r_['graph_ms']:.4f}), SDPA on gathered KV {r_['sdpa_ms']:.4f} ms (device alone "
              f"{r_['sdpa_graph_ms']:.4f}), gather + SDPA device alone "
              f"{r_['gather_sdpa_graph_ms']:.4f} ms, bound {r_['bound'][0]:.4f} ms "
              f"({r_['bound'][1]}); target: device alone <= SDPA's{also}: "
              f"{'met' if r_['graph_ms'] <= target else 'missed'}")

    # bit for bit: two calls agree; each slot alone (B = 1) equals its rows in
    # the batch of 8, and so do its rows with the other slots' lengths
    # changed; at 3d/3e's table and at a long one (128 pages, 2048 positions:
    # decode in eight segments of 256); inputs from a generator of their own,
    # so later phases draw as before
    pg_rng = np.random.default_rng(SEED + 3)
    long_nb = 128
    long_kp = torch.from_numpy(pg_rng.standard_normal((slots * long_nb, hkv, pbs, d),
                                                      dtype=np.float32)).to(dev)
    long_vp = torch.from_numpy(pg_rng.standard_normal((slots * long_nb, hkv, pbs, d),
                                                      dtype=np.float32)).to(dev)
    long_table = torch.from_numpy(pg_rng.permutation(slots * long_nb).reshape(
        slots, long_nb).astype(np.int32)).to(dev)
    for dt, kv_dt, widths in ((torch.float32, torch.float32, (1, 21, 64, 70)),
                              (torch.bfloat16, torch.bfloat16, (1, 21, 64, 70)),
                              (torch.float32, torch.bfloat16, (1, 4, 21, 64))):
        for tab_, kp_, vp_ in ((table, kp, vp), (long_table, long_kp, long_vp)):
            kp_, vp_ = kp_.to(kv_dt), vp_.to(kv_dt)
            n_pos = tab_.shape[1] * pbs
            for kq_ in widths:
                top = n_pos - kq_
                lens_np = pg_rng.integers(0, top + 1, slots).astype(np.int32)
                lens_np[:3] = (0, pbs - 1, top)
                q_ = torch.from_numpy(pg_rng.standard_normal(
                    (slots, hq, kq_, d), dtype=np.float32)).to(dev, dt)
                mixed = dt != kv_dt
                what = (f"paged_attention{'' if kq_ == 1 else '_kquery'} [{str(dt)[6:]}"
                        f"{' over bf16 pages' if mixed else ''}] table of {n_pos} kq={kq_}")

                def call(q_, lens_np, tab_=tab_, kp_=kp_, vp_=vp_, kq_=kq_):
                    lens_ = torch.from_numpy(np.ascontiguousarray(lens_np)).to(dev)
                    if kq_ == 1:
                        return ops.paged_attention(q_[:, :, 0].contiguous(), kp_, vp_,
                                                   tab_.contiguous(), lens_)
                    return ops.paged_attention_kquery(q_.contiguous(), kp_, vp_,
                                                      tab_.contiguous(), lens_)

                y = call(q_, lens_np)
                if n_pos > seq or kq_ == 70 or (mixed and kq_ == 4):
                    err = check(what, y, ref.paged_attention_kquery_ref(
                        q_, kp_, vp_, tab_, torch.from_numpy(lens_np).to(dev)).reshape(y.shape),
                        dt, floor=0.0 if mixed else 1.0)
                    if mixed:
                        name_ = "paged_attention" if kq_ == 1 else "paged_attention_kquery"
                        mixed_err[name_] = max(mixed_err[name_], err)
                    elif dt == torch.float32:
                        if kq_ == 1:
                            pa_err = max(pa_err, err)
                        else:
                            kq_err = max(kq_err, err)
                if not torch.equal(call(q_, lens_np), y):
                    fail(f"{what}: two calls on the same inputs differ")
                other = pg_rng.integers(0, top + 1, slots).astype(np.int32)
                for i in range(slots):
                    moved = other.copy()
                    moved[i] = lens_np[i]
                    if not torch.equal(call(q_[i:i + 1], lens_np[i:i + 1], tab_=tab_[i:i + 1]),
                                       y[i:i + 1]):
                        fail(f"{what}: slot {i} alone differs from its rows in the batch")
                    if not torch.equal(call(q_, moved)[i], y[i]):
                        fail(f"{what}: slot {i} differs when the other slots' lengths change")
    print("  check paged_attention, paged_attention_kquery: two calls agree, each slot alone "
          "equals its rows in the batch of 8, also with the other slots' lengths changed, bit "
          "for bit, f32 and bf16, kq in (1, 21, 64, 70), and f32 queries over bf16 pages, kq "
          "in (1, 4, 21, 64), tables of 512 and 2048 positions")
    print(f"  f32 queries over bf16 pages: max_abs_err decode {mixed_err['paged_attention']:.3e}"
          f", k-query {mixed_err['paged_attention_kquery']:.3e} (tol 1e-4 x the output's "
          "largest |value|)")
    results["paged_attention"]["max_abs_err"] = pa_err
    results["paged_attention_kquery"]["max_abs_err"] = kq_err
    long_lens = torch.from_numpy(pg_rng.integers(300, 1980, slots).astype(np.int32)).to(dev)
    long_q = torch.from_numpy(pg_rng.standard_normal((slots, hq, kq, d),
                                                     dtype=np.float32)).to(dev)
    long_pos = torch.arange(long_nb * pbs, device=dev)
    long_g = [p_[long_table.long()].permute(0, 2, 1, 3, 4).reshape(slots, hkv, -1, d)
              for p_ in (long_kp, long_vp)]
    for name, q_, width in (("paged_attention", long_q[:, :, 0].contiguous(), 1),
                            ("paged_attention_kquery", long_q, kq)):
        lens_ = torch.clamp(long_lens, max=long_nb * pbs - width)
        mask_ = (long_pos[None, None, :] <= (lens_[:, None] + torch.arange(width, device=dev))[
            :, :, None])[:, None]
        q4_ = q_[:, :, None] if width == 1 else q_
        kernel_ms = graph_ms(torch, lambda: getattr(ops, name)(q_, long_kp, long_vp, long_table,
                                                              lens_))
        sdpa_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(q4_, *long_g,
                                                                         attn_mask=mask_))
        print(f"  device-only {name} (table of {long_nb * pbs} positions, lengths "
              f"{int(lens_.min())}-{int(lens_.max())}, f32): kernel {kernel_ms:.4f} ms, SDPA on "
              f"gathered KV {sdpa_ms:.4f} ms per call (CUDA graph of 20 calls)")
    del long_kp, long_vp, long_g

    # 3f. flash attention at one-shot prefill shapes: 8 rows, 8 heads, head_dim
    # 64, causal, T = S = a prompt bucket; GQA, non-causal, T != S, bf16; then
    # Zamba2's 32 heads of 80 and head dim 128 (GQA, non-causal), f32 and bf16
    fa_err = 0.0
    for b_, hq_, hkv_, t_, s_, causal in ((8, hq, hkv, 512, 512, True),
                                          (8, hq, hkv, 16, 16, True),
                                          (8, hq, hkv, 128, 128, True),
                                          (4, hq, hkv // 2, 256, 256, True),
                                          (2, hq, hkv, 256, 256, False),
                                          (2, hq, hkv // 2, 128, 256, True),
                                          (3, 4, 2, 48, 48, True)):
        qf, kf, vf = rand(b_, hq_, t_, d), rand(b_, hkv_, s_, d), rand(b_, hkv_, s_, d)
        fa_err = max(fa_err, check(
            f"flash_attention B={b_} Hq={hq_} Hkv={hkv_} T={t_} S={s_} causal={causal}",
            ops.flash_attention(qf, kf, vf, causal=causal),
            ref.attention_ref(qf, kf, vf, causal=causal, offset=0), torch.float32))
    for b_, hq_, hkv_, t_, s_, d_, causal in ((2, 32, 32, 512, 512, 80, True),
                                              (2, 8, 4, 256, 256, 80, False),
                                              (2, 8, 4, 256, 256, 128, True),
                                              (2, 8, 8, 128, 256, 128, False)):
        qf, kf, vf = rand(b_, hq_, t_, d_), rand(b_, hkv_, s_, d_), rand(b_, hkv_, s_, d_)
        what = f"flash_attention B={b_} Hq={hq_} Hkv={hkv_} T={t_} S={s_} D={d_} causal={causal}"
        fa_err = max(fa_err, check(what, ops.flash_attention(qf, kf, vf, causal=causal),
                                   ref.attention_ref(qf, kf, vf, causal=causal, offset=0),
                                   torch.float32))
        check(what, ops.flash_attention(bf(qf), bf(kf), bf(vf), causal=causal),
              ref.attention_ref(bf(qf), bf(kf), bf(vf), causal=causal, offset=0),
              torch.bfloat16)
    qf, kf, vf = rand(8, hq, 512, d), rand(8, hkv, 512, d), rand(8, hkv, 512, d)
    qb, kb, vb = bf(qf), bf(kf), bf(vf)
    check("flash_attention T=512", ops.flash_attention(qb, kb, vb),
          ref.attention_ref(qb, kb, vb, offset=0), torch.bfloat16)
    t_ = 512
    causal_pairs = 8 * hq * t_ * (t_ + 1) // 2
    fa_bytes = 2 * 8 * hq * t_ * d + 2 * 8 * hkv * t_ * d     # elements of q, out, k, v
    results["flash_attention"] = dict(
        shape=f"one-shot prefill: 8 rows x {hq} heads, T=S={t_}, head_dim {d}, causal",
        max_abs_err=fa_err,
        ms=time_ms(torch, lambda: ops.flash_attention(qf, kf, vf)),
        plain_ms=time_ms(torch, lambda: ref.attention_ref(qf, kf, vf, offset=0)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qf, kf, vf, is_causal=True)),
        bound=bound_ms(4 * fa_bytes, 4 * d * causal_pairs, PEAK_3XTF32_FLOPS),
    )
    fa_bf16 = (time_ms(torch, lambda: ops.flash_attention(qb, kb, vb)),
               time_ms(torch, lambda: ref.attention_ref(qb, kb, vb, offset=0)),
               time_ms(torch, lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True)),
               bound_ms(2 * fa_bytes, 4 * d * causal_pairs, PEAK_BF16_FLOPS))
    print(f"  time flash_attention (same shape, bf16): kernel {fa_bf16[0]:.4f} ms, plain "
          f"{fa_bf16[1]:.4f} ms, library {fa_bf16[2]:.4f} ms (SDPA, is_causal), bound "
          f"{fa_bf16[3][0]:.4f} ms ({fa_bf16[3][1]})")
    for what, args in (("f32", (qf, kf, vf)), ("bf16", (qb, kb, vb))):
        print(f"  device-only flash_attention {what} (main shape): kernel "
              f"{graph_ms(torch, lambda: ops.flash_attention(*args)):.4f} ms, SDPA "
              f"{graph_ms(torch, lambda: F.scaled_dot_product_attention(*args, is_causal=True)):.4f}"
              f" ms per call (CUDA graph of 20 calls)")

    # 3g. page copy on the engine's pool: (layers, pages, heads, 16, 64) payload
    # pools in f32, bf16 and int8 and the (..., 1) scale pool; a copy into page
    # 0 beside (0, 0) pads, and 8 distinct pairs for the timing
    pc_err = 0.0
    src_np = np.array([5, 9, 13, 40, 77, 0, 0, 0], np.int32)
    dst_np = np.array([0, 30, 17, 41, 100, 0, 0, 0], np.int32)
    src, dst = (torch.from_numpy(a).to(dev) for a in (src_np, dst_np))
    for dt, tail in ((torch.float32, d), (torch.bfloat16, d), (torch.int8, d),
                     (torch.float32, 1)):
        pool = (rand(cfg.num_layers, BANK_PAGES, hkv, pbs, tail, scale=50.0)).to(dt)
        want = ref.page_copy_ref(pool.clone(), src, dst)
        got = ops.page_copy(pool, src, dst)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        print(f"  check page_copy [{str(dt).split('.')[-1]} x {tail}]: max_abs_err {err:.3e} "
              f"(exact copy required) {'ok' if err == 0 else 'MISMATCH'}")
        if err != 0 or got.data_ptr() != pool.data_ptr():
            fail("page_copy disagrees with its plain version or did not copy in place")
        pc_err = max(pc_err, err)
    # int8 pages of 3 x 5 x 7 bytes (no multiple of 16: the byte path), and
    # pairs outside the pool and identity pairs beside real ones, skipped
    # (inputs from a generator of their own: later phases draw as before)
    pc_gen = torch.Generator(device=dev)
    pc_gen.manual_seed(SEED)
    pool = (torch.randn((cfg.num_layers, 40, 3, 5, 7), generator=pc_gen, device=dev) * 50).to(
        torch.int8)
    src_r = torch.tensor([5, 9, 13, 50, 7, 3, 0, 0], dtype=torch.int32, device=dev)
    dst_r = torch.tensor([0, 30, 17, 2, -3, 3, 0, 0], dtype=torch.int32, device=dev)
    want = ref.page_copy_ref(pool.clone(), src_r[:3], dst_r[:3])
    got = ops.page_copy(pool, src_r, dst_r)
    torch.cuda.synchronize()
    ok = torch.equal(got, want) and got.data_ptr() == pool.data_ptr()
    print(f"  check page_copy [int8 pages of 105 bytes, pairs outside the pool and identity "
          f"pairs skipped]: {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("page_copy disagrees with its plain version on ragged pages or skipped pairs")
    pool = rand(cfg.num_layers, BANK_PAGES, hkv, pbs, d)
    src8 = torch.arange(0, 16, 2, dtype=torch.int32, device=dev)
    dst8 = torch.arange(64, 80, 2, dtype=torch.int32, device=dev)
    page_bytes = hkv * pbs * d * 4
    results["page_copy"] = dict(
        shape=f"8 pairs x {cfg.num_layers} layers, pages of {hkv}x{pbs}x{d} f32 "
              f"({page_bytes} B), pool of {BANK_PAGES} pages",
        max_abs_err=pc_err,
        ms=time_ms(torch, lambda: ops.page_copy(pool, src8, dst8)),
        plain_ms=time_ms(torch, lambda: ref.page_copy_ref(pool, src8, dst8)),
        library_ms=time_ms(torch, lambda: pool.__setitem__(
            (slice(None), dst8.long()), pool[:, src8.long()])),
        bound=bound_ms(2 * 8 * cfg.num_layers * page_bytes + 2 * 8 * 4, 0),
    )
    kernel_ms = graph_ms(torch, lambda: ops.page_copy(pool, src8, dst8))
    library_ms = graph_ms(torch, lambda: pool.__setitem__((slice(None), dst8.long()),
                                                          pool[:, src8.long()]))
    # the same plan's launch with identity pairs only: every block leaves at once
    floor_ms = graph_ms(torch, lambda: ops.page_copy(pool, src8, src8))
    pc_bound = results["page_copy"]["bound"][0]
    print(f"  device-only page_copy (same pairs): kernel {kernel_ms:.4f} ms, library "
          f"{library_ms:.4f} ms, launch floor {floor_ms:.4f} ms (identity pairs) per call "
          f"(CUDA graph of 20 calls); {1e3 * (kernel_ms - floor_ms):.2f} us above the floor; "
          f"target at most 2x the bound, {2 * pc_bound:.4f} ms (an HBM bound: the pool sits in "
          f"L2, so the time is mostly the launch): "
          f"{'met' if kernel_ms <= 2 * pc_bound else 'missed'}")
    # 3h. per-slot SLR matmul over every site's pooled tables (3 rows of
    # (adapter, layer) tables): 8 slots with repeated and permuted pool rows,
    # T = 1, 8, 37, 64 per slot, f32 and bf16, the r = 0 and empty-S corners,
    # and each slot bit for bit against the stacked kernel on its own rows
    from repro_torch.serving.adapters import AdapterizedLinear
    pooled = {k: v for k, v in adapter_bank.params(0)["layers"].items()
              if isinstance(v, AdapterizedLinear)}
    if sorted(pooled) != sorted(sites):
        fail(f"expected 7 pooled sites, got {sorted(pooled)}")
    ids_np = np.array([2, 0, 1, 1, 0, 2, 2, 0], np.int32)
    ids = torch.from_numpy(ids_np).to(dev)
    nl = cfg.num_layers
    multi_err = 0.0
    for name, lin in sorted(pooled.items()):
        k_s = lin.shape[0]
        for t_dim in (1, 8, 37, 64):
            x = rand(8, t_dim, k_s)
            multi_err = max(multi_err, check(
                f"slr_matmul_multi {name} T={t_dim}",
                ops.slr_matmul_multi(x, lin.p, lin.vt, lin.s_stack, ids, nl, lay),
                ref.slr_matmul_multi_ref(x, lin.p, lin.vt, lin.s_stack, ids, nl, lay),
                torch.float32))
        x = rand(8, 37, k_s)
        s_bf = dataclasses.replace(lin.s_stack, vals=bf(lin.s_stack.vals))
        check(f"slr_matmul_multi {name} T=37", ops.slr_matmul_multi(
            bf(x), bf(lin.p), bf(lin.vt), s_bf, ids, nl, lay), ref.slr_matmul_multi_ref(
            bf(x), bf(lin.p), bf(lin.vt), s_bf, ids, nl, lay), torch.bfloat16)
        zp = torch.zeros_like(lin.p[..., :1])
        zvt = torch.zeros_like(lin.vt[:, :1])
        multi_err = max(multi_err, check(
            f"slr_matmul_multi {name} T=8 r=0 corner",
            ops.slr_matmul_multi(x[:, :8].contiguous(), None, None, lin.s_stack, ids, nl, lay),
            ref.slr_matmul_multi_ref(x[:, :8], zp, zvt, lin.s_stack, ids, nl, lay),
            torch.float32))
        multi_err = max(multi_err, check(
            f"slr_matmul_multi {name} T=8 empty-S corner",
            ops.slr_matmul_multi(x[:, :8].contiguous(), lin.p, lin.vt, None, ids, nl, lay),
            ref.slr_matmul_multi_ref(x[:, :8], lin.p, lin.vt, None, ids, nl, lay),
            torch.float32))
        y = ops.slr_matmul_multi(x, lin.p, lin.vt, lin.s_stack, ids, nl, lay)
        for b in range(8):
            if not torch.equal(y[b], ops.slr_matmul_stacked(
                    x[b].contiguous(), lin.p, lin.vt, lin.s_stack, int(ids_np[b]) * nl + lay)):
                fail(f"slr_matmul_multi {name}: slot {b} differs from the stacked kernel")
    print("  check slr_matmul_multi: every slot equals the stacked kernel on its rows, "
          "bit for bit")
    # row invariance across B: slots 0..b-1 of an 8-slot call equal a b-slot call,
    # for the fused form and the empty-S corner (the low-rank kernel's per-slot
    # form, whose slots also equal lowrank_matmul on their rows and agree bit
    # for bit across two calls)
    for name, lin in sorted(pooled.items()):
        for t_dim in (1, 8):
            x = inv_rand(8, t_dim, lin.shape[0])
            for stack in (lin.s_stack, None):
                what = "empty-S corner" if stack is None else "fused"
                y = ops.slr_matmul_multi(x, lin.p, lin.vt, stack, ids, nl, lay)
                for b in (1, 3):
                    if not torch.equal(ops.slr_matmul_multi(x[:b].contiguous(), lin.p, lin.vt,
                                                            stack, ids[:b].contiguous(), nl,
                                                            lay), y[:b]):
                        fail(f"slr_matmul_multi {name} ({what}): a {b}-slot call differs from "
                             f"slots 0..{b - 1} of the 8-slot call (T={t_dim})")
            if not torch.equal(ops.slr_matmul_multi(x, lin.p, lin.vt, None, ids, nl, lay), y):
                fail(f"slr_matmul_multi {name} (empty-S corner): two calls differ")
            for b in range(8):
                row = int(ids_np[b]) * nl + lay
                if not torch.equal(y[b], ops.lowrank_matmul(x[b].contiguous(), lin.p[row],
                                                            lin.vt[row])):
                    fail(f"slr_matmul_multi {name} (empty-S corner): slot {b} differs from "
                         f"lowrank_matmul on its row (T={t_dim})")
    print("  check slr_matmul_multi: slots 0..b-1 of an 8-slot call equal a b-slot call, bit "
          "for bit, b in (1, 3), T in (1, 8), every site, fused and empty-S corner; every "
          "empty-S slot equals lowrank_matmul on its row, and two calls agree, bit for bit")

    def multi_timing(name, t_dim):
        """(ms, plain ms, library ms, bound) of one per-slot call on site
        ``name`` with 8 slots of ``t_dim`` rows over 3 distinct pool rows.
        Bound: x and y once, and each distinct row's P, Vt, live S tiles,
        counts and rows once; operations per slot for its row's live tiles.
        Library: torch.bmm over the slots' dense W, gathered beforehand."""
        lin = pooled[name]
        k_s, m_s = lin.shape
        r_s, bs_s = lin.p.shape[-1], lin.s_stack.block_size
        x = rand(8, t_dim, k_s)
        tabs = ids_np.astype(np.int64) * nl + lay
        live = {int(t): int(lin.s_stack.counts[t].sum()) for t in set(tabs.tolist())}
        w_rows = {t: (lin.p[t] @ lin.vt[t] + bsr_to_dense(lin.s_stack.at_layer(t))).contiguous()
                  for t in live}
        w_g = torch.stack([w_rows[int(t)] for t in tabs]).contiguous()
        jb_s = lin.s_stack.counts.shape[1]
        nbytes = 4 * (8 * t_dim * (k_s + m_s) + 8) + sum(
            4 * (k_s * r_s + r_s * m_s + n * bs_s * bs_s + jb_s + n) for n in live.values())
        flops = sum(2 * t_dim * (k_s * r_s + r_s * m_s + live[int(t)] * bs_s * bs_s)
                    for t in tabs)
        return (time_ms(torch, lambda: ops.slr_matmul_multi(x, lin.p, lin.vt, lin.s_stack,
                                                            ids, nl, lay)),
                time_ms(torch, lambda: ref.slr_matmul_multi_ref(x, lin.p, lin.vt, lin.s_stack,
                                                                ids, nl, lay), iters=10),
                time_ms(torch, lambda: torch.bmm(x, w_g)),
                bound_ms(nbytes, flops, PEAK_3XTF32_FLOPS))

    multi_rows = {f"slr_matmul_multi {n} 8 slots x T={t}": multi_timing(n, t)
                  for n, t in (("q", 1), ("gate", 1), ("gate", 64))}
    ms_, plain_, lib_, bnd_ = multi_rows["slr_matmul_multi gate 8 slots x T=1"]
    results["slr_matmul_multi"] = dict(
        shape=f"gate site, decode tick: 8 slots x T=1 over 3 pool rows, r="
              f"{pooled['gate'].p.shape[-1]} bs={pooled['gate'].s_stack.block_size}",
        max_abs_err=multi_err, ms=ms_, plain_ms=plain_, library_ms=lib_, bound=bnd_)
    for name, (ms_, plain_, lib_, bnd_) in multi_rows.items():
        print(f"  time {name}: kernel {ms_:.4f} ms, plain {plain_:.4f} ms, library "
              f"{lib_:.4f} ms (torch.bmm, gathered dense W), bound {bnd_[0]:.4f} ms "
              f"({bnd_[1]})")
    # the fused SLR kernels' device time alone at the six shapes above: the
    # event times of back-to-back decode-width calls include the wrappers'
    # host time
    x8 = inv_rand(8, k_dim)
    x512 = inv_rand(512, k_dim)
    g_rows = {
        "slr_matmul_stacked gate T=8": lambda: ops.slr_matmul_stacked(
            x8, gate.p, gate.vt, gate.s_stack, lay),
        "slr_matmul_stacked q T=8 (bs=128)": lambda: ops.slr_matmul_stacked(
            x8, q_site.p, q_site.vt, q_site.s_stack, lay),
        "slr_matmul_stacked gate T=512": lambda: ops.slr_matmul_stacked(
            x512, gate.p, gate.vt, gate.s_stack, lay),
    }
    for name, t_dim in (("q", 1), ("gate", 1), ("gate", 64)):
        lin, xs = pooled[name], inv_rand(8, t_dim, pooled[name].shape[0])
        g_rows[f"slr_matmul_multi {name} 8 slots x T={t_dim}"] = (
            lambda lin=lin, xs=xs: ops.slr_matmul_multi(xs, lin.p, lin.vt, lin.s_stack, ids, nl,
                                                        lay))
    for name, fn in g_rows.items():
        print(f"  device-only {name}: {graph_ms(torch, fn):.4f} ms per call (CUDA graph of "
              f"20 calls)")

    # 3i. soft_threshold, the ADMM S-update: x (nb, n, m) with one threshold
    # per slice, at the embedding leaf and the layer stacks, and ragged
    def soft_check(shape, dt, draw) -> float:
        nb = shape[0]
        x = draw(*shape, scale=3.0).to(dt)
        flat = x.view(nb, -1)
        flat[:, 0] = float("nan")
        flat[:, 1] = float("inf")
        flat[:, -1] = -float("inf")
        tau = (torch.rand(nb, device=dev) if draw is rand
               else torch.rand(nb, generator=st_gen, device=dev)) * 2
        if nb > 1:
            tau[0], tau[-1] = 0.0, 100.0            # identity; above max |x|
        got = ops.soft_threshold(x, tau).float()
        want = ref.soft_threshold_ref(x, tau).float()
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            fail(f"soft_threshold {shape}: NaN positions differ from the plain version")
        keep = ~torch.isnan(want)
        diff = (got[keep] - want[keep]).nan_to_num(posinf=1e30, neginf=-1e30).abs()
        err = float(diff.max())
        # exact in both dtypes: each side computes |x| - tau in f32 from the
        # same operands (tau rounded to x's dtype first) and rounds once to
        # x's dtype; abs, the clamp at 0 and the sign are exact
        tol = 0.0
        ident = nb == 1 or torch.equal(got[0][~torch.isnan(got[0])],
                                       x[0].float()[~torch.isnan(got[0])])
        # the slice above max |x| keeps only its NaN and infinities
        zeros = nb == 1 or int(torch.count_nonzero(
            got[-1].nan_to_num(nan=0.0, posinf=0.0, neginf=0.0))) == 0
        status = "ok" if err <= tol and ident and zeros else "MISMATCH"
        print(f"  check soft_threshold {shape} [{str(dt).split('.')[-1]}]: max_abs_err "
              f"{err:.3e} (tol {tol:g}), tau=0 slice identical {ident}, tau>max slice "
              f"zero {zeros}, NaN and inf written through: {status}")
        if status != "ok":
            fail(f"soft_threshold {shape} disagrees with its plain version")
        return err

    # 70000 slices of 3 (nb above a grid dimension's 65535, every slice
    # boundary inside a vector) and 4i's row below draw from a generator of
    # their own: later phases draw as before
    st_gen = torch.Generator(device=dev)
    st_gen.manual_seed(SEED)

    def st_draw(*shape, scale=1.0):
        return torch.randn(shape, generator=st_gen, device=dev) * scale

    st_err = 0.0
    for shape in ((1, 32000, 512), (8, 512, 1376), (8, 1376, 512), (3, 37, 61),
                  (70000, 1, 3)):
        for dt in (torch.float32, torch.bfloat16):
            err = soft_check(shape, dt, st_draw if shape[0] == 70000 else rand)
            st_err = max(st_err, err) if dt == torch.float32 else st_err
    soft_rows = {}
    # the largest x of 4i's sweep: 10 of zamba2's in_proj slices (SWEEP_ELEMS
    # // (2560 x 10448)), 2.14 GB in f32, far past L2
    for shape, what in (((1, 32000, 512), "the embedding leaf"),
                        ((8, 512, 1376), "the gate stack"),
                        ((10, 2560, 10448), "4i's largest sweep chunk")):
        if shape[0] == 10:
            x = st_draw(*shape)
            tau = torch.rand(shape[0], generator=st_gen, device=dev) * 0.5
        else:
            x = rand(*shape)
            tau = torch.rand(shape[0], device=dev) * 0.5
        lam = float(tau[0])
        soft_rows[shape] = dict(
            shape=f"{shape} f32, {what}",
            max_abs_err=st_err,
            ms=time_ms(torch, lambda: ops.soft_threshold(x, tau)),
            plain_ms=time_ms(torch, lambda: ref.soft_threshold_ref(x, tau)),
            library_ms=time_ms(torch, lambda: F.softshrink(x, lam)),
            graph_ms=graph_ms(torch, lambda: ops.soft_threshold(x, tau)),
            library_graph_ms=graph_ms(torch, lambda: F.softshrink(x, lam)),
            bound=bound_ms(2 * 4 * x.numel() + 4 * shape[0], 0))
    results["soft_threshold"] = soft_rows[(1, 32000, 512)]
    r_ = soft_rows[(8, 512, 1376)]
    print(f"  time soft_threshold ({r_['shape']}): kernel {r_['ms']:.4f} ms, plain "
          f"{r_['plain_ms']:.4f} ms, library {r_['library_ms']:.4f} ms (F.softshrink, one "
          f"scalar tau), bound {r_['bound'][0]:.4f} ms ({r_['bound'][1]})")
    for r_ in soft_rows.values():
        print(f"  device-only soft_threshold ({r_['shape']}): kernel {r_['graph_ms']:.4f} ms, "
              f"F.softshrink {r_['library_graph_ms']:.4f} ms per call (CUDA graph of 20 "
              f"calls), bound {r_['bound'][0]:.4f} ms ({r_['bound'][1]}), "
              f"{r_['graph_ms'] / r_['bound'][0]:.3f}x the bound")
    r_ = soft_rows[(1, 32000, 512)]
    met = (r_["graph_ms"] <= r_["library_graph_ms"]
           and r_["graph_ms"] <= 1.12 * r_["bound"][0])
    print(f"  target soft_threshold (the embedding leaf, device alone): at or below "
          f"F.softshrink and at most 1.12x the bound ({1.12 * r_['bound'][0]:.4f} ms): "
          f"{'met' if met else 'missed'}")
    del soft_rows[(10, 2560, 10448)], x

    phase("3j")
    # 3j. the unstacked fused SLR kernel (the hybrid's shared block) at
    # zamba2's q (2560 -> 2560), gate (2560 -> 10240) and down (10240 -> 2560)
    # shapes with r 640 and a full S at bs 128 (4i's tables: a 15%-dense S
    # leaves no 128 x 128 block empty), a bs 32 S and a ragged K/M; f32, bf16
    # and bf16 activations over f32 tables (4i's dtypes)
    f32, b16 = torch.float32, torch.bfloat16
    un_shapes = {"q": (2560, 2560, 640, 128, 1.0), "gate": (2560, 10240, 640, 128, 1.0),
                 "down": (10240, 2560, 640, 128, 1.0),
                 "gate bs=32": (2560, 10240, 320, 32, 0.3), "ragged": (300, 260, 130, 32, 0.5)}
    un_err, un_tabs = 0.0, {}
    for name, (k_u, m_u, r_u, bs_u, occ) in un_shapes.items():
        ib, jb_u = -(-k_u // bs_u), -(-m_u // bs_u)
        live_u = rng.random((ib, jb_u)) < occ
        s_np = rng.standard_normal((ib * bs_u, jb_u * bs_u)).astype(np.float32) * 0.05
        s_np *= np.repeat(np.repeat(live_u, bs_u, 0), bs_u, 1)
        mat = bsr_from_dense(s_np[:k_u, :m_u], bs_u, device=dev)
        p_u, vt_u = rand(k_u, r_u, scale=0.05), rand(r_u, m_u, scale=0.05)
        for xdt, wdt in ((f32, f32), (b16, b16), (b16, f32)):
            tabs = (p_u.to(wdt), vt_u.to(wdt), dataclasses.replace(mat, vals=mat.vals.to(wdt)))
            for t_dim in (1, 8, 37):
                x = rand(t_dim, k_u).to(xdt)
                err = check(f"slr_matmul {name} T={t_dim} [{str(wdt)[6:]} tables]",
                            ops.slr_matmul(x, *tabs), ref.slr_matmul_ref(x, *tabs), xdt)
                if xdt == f32:
                    un_err = max(un_err, err)
        un_tabs[name] = (p_u, vt_u, mat)
    # timed at the decode rows (bf16 x over f32 tables, 4i's dtypes): event
    # and device-alone (CUDA graph) times beside two yardsticks, torch.matmul
    # on the dense bf16 W (52 MB at the gate site) and on the dense f32 W in
    # f32 (the same precision as the tables); two calls must agree bit for
    # bit, and a call must run at most two kernels and allocate only y and
    # the (T, r) buffer of x @ P
    from torch.profiler import ProfilerActivity, profile
    un_rows = {}
    for name in ("q", "gate", "down"):
        p_u, vt_u, mat = un_tabs[name]
        k_u, m_u, r_u, bs_u, _ = un_shapes[name]
        live_u = int(mat.counts.sum())
        w32 = (p_u @ vt_u + bsr_to_dense(mat)).contiguous()
        w_u = w32.to(b16)
        for t_dim in (1, 8):
            x = rand(t_dim, k_u).to(b16)
            xf = x.float()
            call = lambda: ops.slr_matmul(x, p_u, vt_u, mat)   # noqa: E731
            first, second = call(), call()
            torch.cuda.synchronize()
            if not torch.equal(first, second):
                fail(f"slr_matmul {name} T={t_dim}: two calls on the same inputs differ")
            un_rows[f"{name} T={t_dim}"] = dict(
                ms=time_ms(torch, call), graph_ms=graph_ms(torch, call),
                plain_ms=time_ms(torch, lambda: ref.slr_matmul_ref(x, p_u, vt_u, mat), iters=10),
                library_ms=time_ms(torch, lambda: torch.matmul(x, w_u)),
                library_graph_ms=graph_ms(torch, lambda: torch.matmul(x, w_u)),
                f32_ms=time_ms(torch, lambda: torch.matmul(xf, w32)),
                f32_graph_ms=graph_ms(torch, lambda: torch.matmul(xf, w32)),
                bound=bound_ms(2 * t_dim * (k_u + m_u) + 4 * (k_u * r_u + r_u * m_u
                                                              + live_u * bs_u * bs_u)
                               + 4 * (mat.counts.numel() + live_u),
                               2 * t_dim * (k_u * r_u + r_u * m_u + live_u * bs_u * bs_u)))
        del w32, w_u
    print("  check slr_matmul: two calls give bit-identical output at q, gate and down, T = 1 "
          "and 8")
    p_u, vt_u, mat = un_tabs["gate"]
    x = rand(1, 2560).to(b16)
    ops.slr_matmul(x, p_u, vt_u, mat)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocated_bytes.all.allocated"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.slr_matmul(x, p_u, vt_u, mat)
        torch.cuda.synchronize()
    allocated = torch.cuda.memory_stats()["allocated_bytes.all.allocated"] - before
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and "salaad" in e.name]
    y_t_bytes = 2 * 10240 + 4 * 640      # y (1, M) bf16 and t (1, rp) f32, each in 512-byte units
    print(f"  check slr_matmul gate T=1: {len(kernels)} kernels per call "
          f"({', '.join(sorted({re.sub(r'<.*', '', k_) for k_ in kernels}))}), {allocated} bytes "
          f"allocated (y and t: {y_t_bytes})")
    if len(kernels) > 2 or allocated > y_t_bytes + 1024:
        fail("slr_matmul: a call runs more than two kernels or allocates more than y and t")
    if not kernels:
        print("  the profiler recorded no device kernel: the kernel count is not measured")
    r_ = un_rows["gate T=1"]
    results["slr_matmul"] = dict(
        shape="gate site, decode tick: T=1, K=2560 M=10240 r=640, full S at bs=128, bf16 x "
              "over f32 tables", max_abs_err=un_err, ms=r_["ms"], plain_ms=r_["plain_ms"],
        library_ms=r_["library_ms"], bound=r_["bound"])
    for name, r_ in un_rows.items():
        print(f"  time slr_matmul {name} (bf16 x, f32 tables, full S at bs=128): kernel "
              f"{r_['ms']:.4f} ms (device alone {r_['graph_ms']:.4f}), plain "
              f"{r_['plain_ms']:.4f} ms, library {r_['library_ms']:.4f} ms (device alone "
              f"{r_['library_graph_ms']:.4f}; torch.matmul, dense bf16 W), f32 library "
              f"{r_['f32_ms']:.4f} ms (device alone {r_['f32_graph_ms']:.4f}; torch.matmul, "
              f"f32 x and dense f32 W), bound {r_['bound'][0]:.4f} ms ({r_['bound'][1]})")
    del un_tabs

    for name, r_ in results.items():
        print(f"  time {name} ({r_['shape']}): kernel {r_['ms']:.4f} ms, plain "
              f"{r_['plain_ms']:.4f} ms, library {r_['library_ms']:.4f} ms, bound "
              f"{r_['bound'][0]:.4f} ms ({r_['bound'][1]})")
    for name, r_ in stream_rows.items():
        lib = "torch.linalg.multi_dot" if name.startswith("lowrank") else "torch.matmul, dense S"
        print(f"  time {name}: kernel {r_['ms']:.4f} ms (device alone {r_['graph_ms']:.4f}), "
              f"plain {r_['plain_ms']:.4f} ms, library {r_['library_ms']:.4f} ms (device alone "
              f"{r_['library_graph_ms']:.4f}; {lib}), bound {r_['bound'][0]:.4f} ms "
              f"({r_['bound'][1]})")
    for name, (ms, plain, lib, (b_ms, b_by)) in decode_rows.items():
        print(f"  time {name} (decode tick): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib:.4f} ms (torch.matmul, dense W), bound {b_ms:.4f} ms ({b_by})")

    phase("4a")
    # ---- 4. main path -------------------------------------------------------------
    def serve(label: str, engine, prompts, tiers,
              need: tuple[str, ...]) -> tuple[dict, dict, dict]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        finished = []                # the run's requests, for their streams
        run = engine.run
        engine.run = lambda: finished.extend(run()) or finished
        try:
            stats = serve_batch(engine, cfg.vocab_size, len(prompts), MAX_NEW, SEED,
                                tiers=tiers, prompts=prompts)
        finally:
            del engine.run
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        if stats["requests"] != len(prompts) or stats["tokens"] != len(prompts) * MAX_NEW:
            fail(f"{label}: finished {stats['requests']} of {len(prompts)} requests")
        if not all(0 <= t < cfg.vocab_size for t in stats["sample"]):
            fail(f"{label}: generated token outside the vocabulary")
        for name in need:
            if counts[name] < 1:
                fail(f"{label} never launched {name}: {counts}")
        stats.pop("sample")
        print(f"main path {label}: {len(prompts)} requests, prompts "
              f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
              f"{stats['tokens']} tokens generated = {stats['tok_per_s']} tok/s; median "
              f"TTFT {stats['ttft_p50_ms']} ms; peak memory {peak:.1f} MiB; ticks "
              f"{engine._steps}, prefill calls {engine.prefill_calls}, chunk calls "
              f"{getattr(engine, 'chunk_calls', 0)}, decode calls {engine.decode_calls}")
        print(f"  stats: {json.dumps(stats)}")
        print(f"  launch counts: {json.dumps(counts)}")
        return stats, counts, {r.uid: r.out_tokens for r in finished}

    bank_ecfg = EngineConfig(max_slots=8, max_len=512, block_size=16, num_blocks=BANK_PAGES,
                             prefix_cache=True, tier_policy="pressure")
    prompts = bank_prompts(np.random.default_rng(SEED), cfg.vocab_size, bank_ecfg.block_size)
    engine = PagedServingEngine(banks["fused"], bank_ecfg)
    fused_need = ("flash_attention", "page_copy", "paged_attention", "paged_attention_kquery",
                  "slr_matmul_stacked")
    fused_stats, fused_counts, fused_streams = serve(
        "4a fused bank", engine, prompts, tuple(range(len(BUDGETS))), fused_need)
    pc = fused_stats["prefix_cache"]
    if pc["hits"] < 1 or pc["cow_copies"] < 1 or fused_stats["downshift_ticks"] < 1:
        fail(f"the fused bank run needs prefix hits, copy-on-write copies and downshifts: "
             f"{pc}, downshift_ticks {fused_stats['downshift_ticks']}")
    # the same run with the registry's hooks off, then on again (the first
    # run also pays the process's first-use costs): not one token may move
    rates = [fused_stats["tok_per_s"]]
    for label, telemetry in (("off", False), ("on again", True)):
        again_stats, _, again_streams = serve(
            f"4a fused bank, telemetry {label}",
            PagedServingEngine(banks["fused"], dataclasses.replace(bank_ecfg,
                                                                   telemetry=telemetry)),
            prompts, tuple(range(len(BUDGETS))), fused_need)
        if again_streams != fused_streams:
            differ = [u for u in fused_streams if again_streams.get(u) != fused_streams[u]]
            fail(f"4a: telemetry {label} changed the streams of requests {differ}")
        rates.append(again_stats["tok_per_s"])
    print(f"  4a telemetry on {rates[0]} tok/s, off {rates[1]} tok/s, on again {rates[2]} "
          f"tok/s (off / on again {rates[1] / rates[2]:.4f}); streams equal bit for bit")

    bsr_prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                   for n in rng.integers(20, 301, N_BSR)]
    engine = PagedServingEngine(banks["bsr"], EngineConfig(max_slots=8, max_len=512,
                                                           block_size=16))
    _, bsr_counts, _ = serve("4b bsr bank", engine, bsr_prompts, tuple(range(len(BUDGETS))),
                          ("bsr_matmul", "lowrank_matmul", "flash_attention",
                           "paged_attention"))

    chunk_prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                     for n in rng.integers(20, 401, N_REQUESTS)]
    engine = PagedServingEngine(dm, EngineConfig(max_slots=8, max_len=512, block_size=16,
                                                 prefill_chunk=64))
    serve("4c fused model, chunked prefill", engine, chunk_prompts, (None,),
          ("slr_matmul_stacked", "paged_attention", "paged_attention_kquery"))

    cli = ["--arch", "salaad_llama_60m", "--fmt", "fused"]
    obs_dir = tempfile.mkdtemp()          # the observability run's files
    obs = {name: os.path.join(obs_dir, name) for name in ("t.json", "e.jsonl", "m.txt")}
    for extra in (["--keep-ratios", ",".join(map(str, BUDGETS)), "--prefix-cache",
                   "--tier-policy", "pressure"],
                  ["--adapters", "3", "--max-resident-adapters", "2"],
                  ["--keep-ratios", "1.0,0.3", "--spec-budget", "0.3", "--engine",
                   "speculative", "--spec-k", "4"],
                  ["--keep-ratios", "1.0,0.6", "--kv-dtype", "int8", "--prefix-cache"],
                  ["--keep-ratios", ",".join(map(str, BUDGETS)), "--engine", "batched",
                   "--trace-out", obs["t.json"], "--trace-events", obs["e.jsonl"],
                   "--metrics-port", "0", "--metrics-out", obs["m.txt"]]):
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve_main(cli + extra)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        if line["requests"] != 4 or line["tokens"] != 32 or "jit_retraces" not in line:
            fail(f"the serve launcher's line is off: {line}")
        if "--trace-out" in extra:
            try:
                with open(obs["t.json"]) as f:
                    trace_rep = validate_chrome_trace(json.load(f))
                with open(obs["m.txt"]) as f:
                    prom_rep = validate_prometheus_text(f.read())
                with open(obs["e.jsonl"]) as f:
                    n_events = sum(1 for ln in f if json.loads(ln)["kind"])
            except (OSError, ValueError, KeyError) as e:
                fail(f"4d: the batched launcher's trace, event log or scrape is off: {e!r}")
            print(f"  4d batched files: trace {json.dumps(trace_rep)}, {n_events} events "
                  f"logged, scrape {json.dumps(prom_rep)}")
        if "--adapters" in extra and (line["adapters"]["swaps"] < 1
                                      or sorted(line["tokens_by_adapter"]) != ["0", "1", "2"]):
            fail(f"the adapter launcher's line is off: {line}")
        if ("speculative" in extra) != ("acceptance_rate" in line):
            fail(f"the speculative launcher's line is off: {line}")
        print(f"main path 4d launcher {' '.join(extra)} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(line)}")
    shutil.rmtree(obs_dir, ignore_errors=True)

    # 4e. where the time goes: runs under torch.profiler (here 4a and 4b; 4f's
    # batched run below)

    def profiled(label: str, run) -> None:
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
        # each CUDA kernel of the port (namespace salaad, all its template
        # instances) and its share of device time
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
        # the low-rank kernel's two products, one call of lowrank_matmul
        pair = [shares[b] for b in ("lowrank_xp_kernel", "lowrank_tv_kernel") if b in shares]
        if pair:
            ms_ = sum(ms for ms, _ in pair)
            print(f"  share lowrank_matmul (both kernels): {ms_:.1f} ms of {busy_ms:.1f} device ms "
                  f"= {ms_ / busy_ms:.3f}")

    engine = PagedServingEngine(banks["fused"], bank_ecfg)
    profiled("4a", lambda: serve_batch(engine, cfg.vocab_size, len(prompts), MAX_NEW, SEED,
                                       tiers=tuple(range(len(BUDGETS))), prompts=prompts))
    engine = PagedServingEngine(banks["bsr"], EngineConfig(max_slots=8, max_len=512,
                                                           block_size=16))
    profiled("4b", lambda: serve_batch(engine, cfg.vocab_size, len(bsr_prompts), MAX_NEW, SEED,
                                       tiers=tuple(range(len(BUDGETS))), prompts=bsr_prompts))

    phase("4f")
    # 4f. multi-tenant adapters: the adapter bank in batched mode (one decode
    # call per tick over slots of different tenants), then the same bank's
    # tenants each served alone through a plain ModelBank, then grouped mode
    n_ten = len(ADAPTER_KEEPS)
    ad_ecfg = dict(max_slots=8, max_len=512, block_size=16, prefix_cache=True)

    def serve_adapters(label, bank) -> tuple[dict, dict, dict]:
        engine = PagedServingEngine(bank, EngineConfig(**ad_ecfg, adapters=True,
                                                       max_resident_adapters=ADAPTER_ROWS))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        swaps0 = bank.swaps
        ops.reset_launch_counts()
        t0 = time.monotonic()
        uids = [engine.submit(p, max_new_tokens=MAX_NEW, adapter=i % n_ten)
                for i, p in enumerate(prompts)]
        done = engine.run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        streams = {r.uid: list(r.out_tokens) for r in done}
        if sorted(streams) != uids or any(len(v) != MAX_NEW for v in streams.values()):
            fail(f"{label}: finished {len(streams)} of {len(uids)} requests")
        if not all(0 <= t < cfg.vocab_size for v in streams.values() for t in v):
            fail(f"{label}: generated token outside the vocabulary")
        ttft = [r.first_token_at - r.submitted_at for r in done]
        stats = {"tok_per_s": round(len(done) * MAX_NEW / wall, 2),
                 "ttft_p50_ms": round(float(np.percentile(ttft, 50)) * 1e3, 1),
                 "peak_mib": round(peak, 1), "swaps": bank.swaps - swaps0,
                 "prefix_hits": engine.prefix_hits, "prefix_hit_tokens":
                 engine.prefix_hit_tokens, "tokens_by_adapter": engine.adapter_tokens,
                 "ticks": engine._steps, "prefill_calls": engine.prefill_calls,
                 "chunk_calls": engine.chunk_calls, "decode_calls": engine.decode_calls,
                 "pool_bytes": bank.adapter_report()["pool_bytes"]}
        print(f"main path {label}: {len(done)} requests over {n_ten} tenants, "
              f"{len(done) * MAX_NEW} tokens = {stats['tok_per_s']} tok/s; median TTFT "
              f"{stats['ttft_p50_ms']} ms; peak memory {peak:.1f} MiB; pool "
              f"{stats['pool_bytes']} B")
        print(f"  stats: {json.dumps(stats)}")
        print(f"  launch counts: {json.dumps(counts)}")
        return streams, stats, counts

    ad_streams, ad_stats, adapter_counts = serve_adapters("4f adapter bank, batched",
                                                          adapter_bank)
    if adapter_counts["slr_matmul_multi"] < 1 or ad_stats["swaps"] < 1 \
            or ad_stats["prefix_hits"] < 1:
        fail(f"the adapter run needs per-slot kernel launches, swaps and prefix hits: "
             f"{ad_stats}, {adapter_counts}")
    alone: dict[int, list[int]] = {}
    t0 = time.perf_counter()
    for a in range(n_ten):
        engine = PagedServingEngine(ModelBank.single(cfg, tenants[a]),
                                    EngineConfig(**{**ad_ecfg, "prefix_cache": False}))
        for i in range(a, len(prompts), n_ten):
            engine.submit(prompts[i], max_new_tokens=MAX_NEW)
            (req,) = engine.run()
            alone[i + 1] = req.out_tokens       # uid of request i in the adapter runs
    torch.cuda.synchronize()
    differ = [u for u in ad_streams if ad_streams[u] != alone[u]]
    print(f"  streams vs each request alone through its tenant's ModelBank "
          f"({time.perf_counter() - t0:.1f} s): {len(ad_streams) - len(differ)} of "
          f"{len(ad_streams)} token-identical")
    if differ:
        fail(f"adapter streams differ from their single-tenant runs for requests {differ}")
    grouped_bank = AdapterBank(tenant_models[0], tenants, max_resident=ADAPTER_ROWS,
                               mode="grouped")
    g_streams, _, g_counts = serve_adapters("4f adapter bank, grouped", grouped_bank)
    if g_streams != ad_streams:
        fail("the grouped-mode streams differ from the batched-mode streams")
    if g_counts["slr_matmul_stacked"] < 1 or g_counts["slr_matmul_multi"]:
        fail(f"grouped mode runs the stacked kernel per adapter: {g_counts}")
    print("  grouped-mode streams equal the batched-mode streams")
    del grouped_bank
    engine = PagedServingEngine(adapter_bank, EngineConfig(
        **ad_ecfg, adapters=True, max_resident_adapters=ADAPTER_ROWS))

    def adapter_run():
        for i, p in enumerate(prompts):
            engine.submit(p, max_new_tokens=MAX_NEW, adapter=i % n_ten)
        engine.run()

    profiled("4f batched", adapter_run)

    phase("4k")
    # 4k. elastic self-speculative decoding on the fused bank: tier 0 verifies,
    # tier 2 (keep 0.3) drafts into bf16 pools (f32 queries over bf16 pages in
    # the paged kernels), 8 slots, the first 16 of 4a's prompts, 32 new tokens
    # each: (i) greedy, parallel schedule, k = 4, streams equal to a static
    # paged run at tier 0; (iii) the same greedy runs with tier 0 drafting
    # for itself, both schedules, acceptance above 0.5; (ii) sampled
    # (T = 0.8), sequential schedule, k = 4
    spec_prompts = prompts[:16]
    spec_ecfg = dict(max_slots=8, max_len=512, block_size=16)

    def spec_run(label, engine, need):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for p in spec_prompts:
            engine.submit(p, max_new_tokens=MAX_NEW, tier=0)
        t0 = time.perf_counter()
        done = engine.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        streams = {r.uid: r.out_tokens for r in done}
        tokens = sum(map(len, streams.values()))
        if len(done) != len(spec_prompts) or any(len(t) != MAX_NEW for t in streams.values()):
            fail(f"{label}: {len(done)} requests, lengths "
                 f"{sorted({len(t) for t in streams.values()})}; each must emit {MAX_NEW}")
        if not all(0 <= t < cfg.vocab_size for t_ in streams.values() for t in t_):
            fail(f"{label}: generated token outside the vocabulary")
        for name in need:
            if counts[name] < 1:
                fail(f"{label} never launched {name}: {counts}")
        rate = getattr(engine, "acceptance_rate", None)
        print(f"main path {label}: {len(done)} requests, {tokens} tokens in {secs:.3f} s = "
              f"{tokens / secs:.2f} tok/s; decode calls {engine.decode_calls}"
              + ("" if rate is None else f", acceptance rate {rate:.4f} "
                 f"({engine.accepted_tokens} of {engine.drafted_tokens} drafted)"))
        print(f"  launch counts: {json.dumps(counts)}")
        return streams, counts

    static_engine = PagedServingEngine(banks["fused"], EngineConfig(**spec_ecfg))
    static_streams, _ = spec_run("4k static tier 0", static_engine,
                                 ("paged_attention", "slr_matmul_stacked"))
    spec_engine = SpeculativeEngine(banks["fused"], EngineConfig(
        **spec_ecfg, spec_k=4, spec_target_tier=0, spec_draft_tier=2))
    if spec_engine._dpools[0].dtype != torch.bfloat16 or not spec_engine._parallel:
        fail("4k(i): expected bf16 draft pools and the parallel schedule")
    par_streams, spec_par_counts = spec_run(
        "4k(i) speculative greedy parallel k=4", spec_engine,
        ("paged_attention_kquery", "slr_matmul_stacked", "flash_attention"))
    if par_streams != static_streams:
        differ = [u for u in static_streams if par_streams.get(u) != static_streams[u]]
        fail(f"4k(i): greedy speculative streams differ from the static tier-0 run for "
             f"requests {differ}")
    print("  4k(i) streams equal the static tier-0 run's, token for token")
    # the tier-2 draft confirms no guess on these random weights, so the
    # multi-token ticks (m > 1 length resets, the realigned guesses, the used
    # draft window) run with tier 0 drafting for itself into bf16 pools.
    # Sequential accepts nearly every draft. Parallel guesses come from the
    # previous tick's draft chain past the m tokens it emitted, so after a
    # tick of m = k the next has no guess left: at k = 4 ticks alternate
    # between 0 and 3 confirmed guesses, a rate of at most ~0.5; it is held
    # to fewer decode calls than the static run's instead
    for mode in ("parallel", "sequential"):
        label = f"4k(iii) speculative greedy {mode} k=4, identical draft"
        spec_engine = SpeculativeEngine(banks["fused"], EngineConfig(
            **spec_ecfg, spec_k=4, spec_target_tier=0, spec_draft_tier=0,
            spec_draft_mode=mode))
        same_streams, _ = spec_run(label, spec_engine, ("paged_attention_kquery",
                                                        "slr_matmul_stacked"))
        if mode == "sequential" and spec_engine.acceptance_rate <= 0.5:
            fail(f"{label}: acceptance rate {spec_engine.acceptance_rate:.4f}, want > 0.5")
        if spec_engine.accepted_tokens < 1 or \
                spec_engine.decode_calls >= static_engine.decode_calls:
            fail(f"{label}: {spec_engine.accepted_tokens} guesses confirmed in "
                 f"{spec_engine.decode_calls} decode calls against the static run's "
                 f"{static_engine.decode_calls}: no tick emitted more than one token")
        if same_streams != static_streams:
            differ = [u for u in static_streams if same_streams.get(u) != static_streams[u]]
            fail(f"{label}: streams differ from the static tier-0 run for requests {differ}")
        print(f"  {label}: streams equal the static tier-0 run's, token for token")
    spec_engine = SpeculativeEngine(banks["fused"], EngineConfig(
        **spec_ecfg, spec_k=4, spec_target_tier=0, spec_draft_tier=2, greedy=False,
        temperature=0.8))
    if spec_engine._parallel:
        fail("4k(ii): expected the sequential schedule")
    _, spec_seq_counts = spec_run(
        "4k(ii) speculative sampled sequential k=4 T=0.8", spec_engine,
        ("paged_attention", "paged_attention_kquery", "slr_matmul_stacked", "flash_attention"))
    del spec_engine

    phase("4l")
    # 4l. 4a's run with int8 pages (prefix cache and pressure tiers on): the
    # paged kernels give way to the dequantizing gather, page copy copies the
    # payload and both scale pools; the pools' bytes against 4a's
    int8_engine = PagedServingEngine(banks["fused"], dataclasses.replace(bank_ecfg,
                                                                         kv_dtype="int8"))
    int8_stats, int8_counts, _ = serve("4l fused bank, int8 pages", int8_engine, prompts,
                                    tuple(range(len(BUDGETS))),
                                    ("flash_attention", "page_copy", "slr_matmul_stacked"))
    if int8_counts["paged_attention"] or int8_counts["paged_attention_kquery"]:
        fail(f"4l: int8 pages must take the gather path: {int8_counts}")
    if int8_stats["prefix_cache"]["cow_copies"] < 1 or int8_counts["page_copy"] % 4:
        fail(f"4l: copy-on-write must copy four pools per call: {int8_stats['prefix_cache']}, "
             f"{int8_counts['page_copy']} page-copy launches")
    f32_bytes = kv_quant.cache_bytes(PagedServingEngine(banks["fused"], bank_ecfg).cache)
    i8_bytes = kv_quant.cache_bytes(int8_engine.cache)
    print(f"  4l KV pool bytes: int8 pages + f32 scales {i8_bytes} against 4a's f32 pages "
          f"{f32_bytes} ({i8_bytes / f32_bytes:.4f}); page-copy launches "
          f"{int8_counts['page_copy']} (4 pools per copy-on-write call)")
    del int8_engine

    phase("4m")
    # 4m. the slot-padded ServingEngine on the fused bank: a contiguous f32
    # cache of 8 slots x 512 positions, one-shot flash prefill per tier
    # group, per-slot decode by masked einsum (no paged kernel), telemetry
    # and tracing on; the registry's counts, a warm second drive with no
    # retrace, the trace and a scrape against their validators
    tiers3 = tuple(range(len(BUDGETS)))
    m_engine = ServingEngine(banks["fused"], EngineConfig(max_slots=8, max_len=512,
                                                          trace=True))
    m_stats, batched_counts, m_streams = serve("4m fused bank, batched engine", m_engine,
                                               prompts, tiers3,
                                               ("flash_attention", "slr_matmul_stacked"))
    if batched_counts["paged_attention"] or batched_counts["paged_attention_kquery"]:
        fail(f"4m: the batched engine launched a paged kernel: {batched_counts}")
    tel = m_engine.metrics
    emitted = tel.counter_value(tel.tokens, "emitted")
    n_ttft, n_itl = tel.ttft.count(tel.engine), tel.itl.count(tel.engine)
    if (emitted, n_ttft, n_itl) != (N_BANK * MAX_NEW, N_BANK, N_BANK * (MAX_NEW - 1)):
        fail(f"4m: the registry counts {emitted} emitted tokens, {n_ttft} TTFTs and {n_itl} "
             f"ITLs; want {N_BANK * MAX_NEW}, {N_BANK}, {N_BANK * (MAX_NEW - 1)}")
    print(f"  4m registry: {m_stats['tok_per_s']} tok/s; TTFT p50 "
          f"{tel.ttft.percentile(50, tel.engine) * 1e3:.3f} ms, p99 "
          f"{tel.ttft.percentile(99, tel.engine) * 1e3:.3f} ms; ITL p50 "
          f"{tel.itl.percentile(50, tel.engine) * 1e3:.3f} ms, p99 "
          f"{tel.itl.percentile(99, tel.engine) * 1e3:.3f} ms; KV cache "
          f"{sum(tel.kv_pool_device_bytes.snapshot().values()) / 2**20:.1f} MiB")
    for label, row in tel.program.snapshot().items():
        print(f"  4m program {label}: {row['count']} calls, {row['sum'] * 1e3:.3f} ms in all, "
              f"p50 {row['p50'] * 1e3:.3f} ms, p99 {row['p99'] * 1e3:.3f} ms")
    with tempfile.TemporaryDirectory() as trace_dir:
        trace_path = os.path.join(trace_dir, "trace.json")
        m_engine.tracer.save_chrome(trace_path)
        with open(trace_path) as f:
            trace_rep = validate_chrome_trace(json.load(f))
    server = start_metrics_server(tel.registry, port=0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.server_address[1]}/metrics", timeout=30) as resp:
            prom_rep = validate_prometheus_text(resp.read().decode())
    finally:
        server.shutdown()
        server.server_close()
    print(f"  4m trace {json.dumps(trace_rep)}; scrape {json.dumps(prom_rep)}")
    m_again, _, m_streams2 = serve("4m fused bank, batched engine, second drive", m_engine,
                                   prompts, tiers3, ("flash_attention", "slr_matmul_stacked"))
    snap = m_engine.stats_snapshot()
    compiles = int(tel.jit_compiles.total())
    if snap["jit_retraces"] != 0 or m_again["jit_retraces"] != 0:
        fail(f"4m: the warm engine rebuilt launch plans: jit_retraces {snap['jit_retraces']}, "
             f"{json.dumps(snap['metrics']['serve_jit_retraces_total'])}")
    print(f"  4m second drive: {m_again['tok_per_s']} tok/s, jit_retraces 0, launch-plan "
          f"builds {compiles} (all in first calls); streams equal to the first drive's: "
          f"{sum(m_streams2[u + N_BANK] == t for u, t in m_streams.items())} of {N_BANK}")
    del m_engine
    p_engine = PagedServingEngine(banks["fused"], EngineConfig(max_slots=8, max_len=512,
                                                               block_size=16))
    _, _, p_streams = serve("4m fused bank, paged engine (static, no prefix cache)",
                            p_engine, prompts, tiers3, ("paged_attention",))
    del p_engine
    same = sum(p_streams[u] == t for u, t in m_streams.items())
    print(f"  4m streams equal to the paged engine's: {same} of {N_BANK} (decode sums in "
          "another order: a near-tie may fork them; phase 5 gates the logits)")
    # free the serving phases' banks, so 4g's peak memory is training's own
    del engine, adapter_bank, tenants, tenant_models, banks
    torch.cuda.empty_cache()

    phase("4g")
    # 4g. SALAAD training at full width (Algorithm 1: K Adam steps on the
    # coupled loss, then one ADMM prox sweep on the randomized SVD)
    tcfg_arch = get_arch("salaad_llama_60m")           # kernel_impl blockwise: flash_vjp
    train_scfg = SalaadConfig(selection=SelectionConfig(min_dim=16), update_every=TRAIN_K)
    trainer = Trainer(tcfg_arch, TrainerConfig(
        total_steps=TRAIN_STEPS, log_every=1, salaad=train_scfg,
        adam=AdamConfig(lr=TRAIN_LR)), device=dev)
    t_state = trainer.init(seed=SEED)
    init_cpu = tree_map(lambda t: t.cpu(), t_state.params)     # for 5b
    data = SyntheticC4(DataConfig(tcfg_arch.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED))
    admm_ms, admm_stats, admm_end = [], [], []
    inner_admm = trainer._admm_step

    def timed_admm(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_admm(state)
        torch.cuda.synchronize()
        admm_end.append(time.perf_counter())
        admm_ms.append((admm_end[-1] - t0) * 1e3)
        admm_stats.append(out[1])
        return out

    trainer._admm_step = timed_admm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    t_state = trainer.fit(t_state, data)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_counts = ops.launch_counts()
    train_peak = torch.cuda.max_memory_allocated() / 2**20
    trainer._admm_step = inner_admm
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    step_ms = [m["sec"] * 1e3 for m in trainer.metrics_log if "loss" in m]
    recon = [m["admm_recon_err"] for m in trainer.metrics_log if "admm_recon_err" in m]
    n_admm = TRAIN_STEPS // TRAIN_K
    med_step = float(np.median(step_ms[2:]))
    # training tokens/s on the wall clock over whole phases of Algorithm 1
    # (K train steps, the ADMM sweep, batch generation and the host between),
    # from the end of the first sweep to the end of the last, so the first
    # phase's warm-up stays out; beside it the whole run's rate
    phase_tok = (n_admm - 1) * TRAIN_K * TRAIN_SEQ * TRAIN_BATCH
    tok_s = phase_tok / (admm_end[-1] - admm_end[0]) if n_admm > 1 else float("nan")
    run_tok_s = TRAIN_STEPS * TRAIN_SEQ * TRAIN_BATCH / train_wall
    admm_list = ", ".join(f"{t:.3f}" for t in admm_ms)
    print(f"main path 4g training: {tcfg_arch.name} f32, seq {TRAIN_SEQ} x batch "
          f"{TRAIN_BATCH}, lr {TRAIN_LR:g}, K={TRAIN_K}, {TRAIN_STEPS} steps in "
          f"{train_wall:.3f} s; {tok_s:.1f} training tokens/s over phases 2-{n_admm} "
          f"(wall clock, ADMM sweeps included), {run_tok_s:.1f} over the whole run "
          f"(first phase's warm-up included); median train step {med_step:.3f} ms "
          f"(steps 2-{TRAIN_STEPS - 1}; host clock around a step that ends in a sync); "
          f"ADMM steps {admm_list} ms (median {float(np.median(admm_ms)):.3f}); peak "
          f"memory {train_peak:.1f} MiB")
    print(f"  losses per step: {json.dumps([round(x, 5) for x in losses])}")
    print(f"  ADMM mean recon err per phase: {json.dumps([round(x, 6) for x in recon])}")
    for i, st in enumerate(admm_stats):
        row = {name: {k: [round(float(v), 6) for v in st[name][k].float().reshape(-1)[:2].cpu()]
                      for k in ("rank_ratio", "density", "alpha", "beta")}
               for name in ("embed/embedding", "layers/gate")}
        print(f"  ADMM phase {i} (first slices): {json.dumps(row)}")
    print(f"  launch counts: {json.dumps(train_counts)}")
    finite = all(math.isfinite(x) for x in losses + recon) and all(
        bool(torch.isfinite(v).all()) for st in admm_stats for blk in st.values()
        for v in (blk.values() if isinstance(blk, dict) else [blk]))
    if len(admm_ms) != n_admm or train_counts["soft_threshold"] != 8 * n_admm:
        fail(f"4g: expected {n_admm} ADMM steps with 8 soft_threshold launches each, got "
             f"{len(admm_ms)} and {train_counts['soft_threshold']}")
    if not finite:
        fail("4g: a loss or an ADMM statistic is not finite")
    if not np.mean(losses[-5:]) < np.mean(losses[:5]):
        fail(f"4g: the loss did not fall: {losses}")
    profiled("4g one train step", lambda: trainer._train_step(t_state, data.batch(TRAIN_STEPS)))
    profiled("4g one ADMM step", lambda: trainer._admm_step(t_state))

    phase("4h")
    # 4h. train -> checkpoint -> serve: 4g's state served by the launcher
    with tempfile.TemporaryDirectory() as ckpt_dir:
        checkpoint.save(ckpt_dir, t_state.step, t_state)
        out = io.StringIO()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            serve_main(["--arch", "salaad_llama_60m", "--ckpt-dir", ckpt_dir, "--fmt",
                        "fused", "--keep-ratios", "1.0,0.6", "--requests", "8"])
        torch.cuda.synchronize()
        ckpt_counts = ops.launch_counts()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"main path 4h serve --ckpt-dir ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(line)}")
    print(f"  launch counts: {json.dumps(ckpt_counts)}")
    if line["requests"] != 8 or not all(t["slr_params"] > 0 for t in line["tiers"]):
        fail(f"4h: the trained checkpoint served no SLR parameters: {line}")
    for name in ("slr_matmul_stacked", "paged_attention"):
        if ckpt_counts[name] < 1:
            fail(f"4h never launched {name}: {ckpt_counts}")
    del trainer, t_state

    phase("4i")
    # 4i. the hybrid at full width: zamba2_2p7b, 54 layers, bf16
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zcfg = get_arch(HYBRID)
    zscfg = SalaadConfig(selection=SelectionConfig(min_dim=16))
    t0 = time.perf_counter()
    zparams = model_lib.init_params(zcfg, seed=SEED)
    zstate, zblocks = init_slr_state(zparams, zscfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    # one rSVD sweep, leaf by leaf so that a leaf's old state is freed once its
    # new one exists; each leaf gets the sketches one admm_update call at step
    # 0 draws for it. TF32 products (the sweep's and the tiers' dense
    # L + S): about 23 TFLOP that f32 on the CUDA cores would take minutes for
    torch.backends.cuda.matmul.allow_tf32 = True
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    recon = []
    for i, info in enumerate(zblocks):
        r_i = zstate[info.name].p.shape[-1]
        new, st = admm_update(zparams, {info.name: zstate[info.name]}, [info], zscfg, 0,
                              sketches={info.name: block_sketches(0, i, info, r_i, 1, dev)})
        zstate[info.name] = new[info.name]
        recon.append(float(st[info.name]["recon_err"].mean()))
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    sweep_counts = ops.launch_counts()
    sweep_peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"main path 4i build: {zcfg.name} {zcfg.num_layers} layers d_model {zcfg.d_model} "
          f"{str(zcfg.param_dtype)[6:]}, init {t_init:.1f} s; one rSVD sweep over {len(zblocks)} leaves "
          f"({sum(b.num_blocks for b in zblocks)} blocks) in {t_sweep:.1f} s, mean recon err "
          f"{float(np.mean(recon)):.6g}, soft_threshold launches "
          f"{sweep_counts['soft_threshold']}; peak memory {sweep_peak:.2f} GiB")
    print(f"  selected: {json.dumps({b.name: list(b.stack_dims) for b in zblocks})}")
    zmodels, ztier_rows = [], []
    t0 = time.perf_counter()
    for keep in HYBRID_BUDGETS:
        slr_k, rep = hpa_keep_ratio(zstate, zblocks, keep, 0.7)
        zmodels.append(DeployedModel.build(zcfg, zparams, slr_k, zblocks, fmt="fused"))
        dep = deployment_report(zparams, slr_k, zblocks)
        ztier_rows.append({"keep": keep, "slr_params": rep["params_after"],
                           "slr_total_bytes": dep["slr_total_bytes"],
                           "dense_total_bytes": dep["dense_total_bytes"],
                           "compression": round(dep["compression"], 3)})
        del slr_k
    torch.backends.cuda.matmul.allow_tf32 = False
    del zstate, new, st                         # the bank holds what it serves
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zbank = ModelBank(zcfg, zmodels, keeps=HYBRID_BUDGETS)
    print(f"  tiers (HPA + fused deployment in {time.perf_counter() - t0:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held after the SLR state is freed): "
          f"{json.dumps(ztier_rows)}")
    print(f"  bank: {json.dumps(zbank.report())}")
    corners = {}
    for tier in zbank:
        shared = tier.params["shared_attn"]
        row = {}
        for site in ("q", "k", "v", "o", "gate", "up", "down"):
            lin = shared[site]
            r_s = 0 if lin.p is None else lin.p.shape[-1]
            mat = lin.s_bsr
            live_s = 0 if mat is None or mat.empty else int(mat.counts.sum())
            row[site] = {"shape": list(lin.shape), "r": r_s,
                         "bs": None if mat is None else mat.block_size,
                         "live_tiles": live_s,
                         "of": None if mat is None else mat.rows.numel()}
            if r_s == 0 or live_s == 0:
                corners.setdefault(tier.name, []).append(site)
        print(f"  tier {tier.name} shared-block sites: {json.dumps(row)}")
    print(f"  corner sites (one part empty): {json.dumps(corners) if corners else 'none'}")

    zrng = np.random.default_rng(SEED + 1)
    zprompts = [zrng.integers(0, zcfg.vocab_size, int(n)).tolist()
                for n in zrng.integers(8, 41, N_HYBRID)]
    zeng = ReferenceEngine(zbank, EngineConfig(max_slots=4, max_len=128))
    tier_launches = {t.index: 0 for t in zbank}
    tier_calls = {t.index: 0 for t in zbank}
    inner_step = zeng._step_slot

    def counted_step(slot, token):
        tier = zeng._active[slot].tier
        before = ops.KERNELS["slr_matmul"].launches
        out = inner_step(slot, token)
        tier_launches[tier] += ops.KERNELS["slr_matmul"].launches - before
        tier_calls[tier] += 1
        return out

    zeng._step_slot = counted_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    zstats = serve_batch(zeng, zcfg.vocab_size, N_HYBRID, HYBRID_MAX_NEW, SEED,
                         tiers=tuple(range(len(zbank))), prompts=zprompts)
    torch.cuda.synchronize()
    hybrid_counts = ops.launch_counts()
    zpeak = torch.cuda.max_memory_allocated() / 2**30
    if zstats["requests"] != N_HYBRID or zstats["tokens"] != N_HYBRID * HYBRID_MAX_NEW:
        fail(f"4i: finished {zstats['requests']} of {N_HYBRID} requests: {zstats}")
    if not all(0 <= t < zcfg.vocab_size for t in zstats["sample"]):
        fail("4i: generated token outside the vocabulary")
    groups = zcfg.num_layers // zcfg.attn_every
    for tier in zbank:
        n_corner = len(corners.get(tier.name, []))
        want = (7 - n_corner) * groups * tier_calls[tier.index]
        if tier_launches[tier.index] < 1 or tier_launches[tier.index] != want:
            fail(f"4i tier {tier.name}: {tier_launches[tier.index]} slr_matmul launches over "
                 f"{tier_calls[tier.index]} decode calls, expected {want}")
    print(f"main path 4i hybrid bank on ReferenceEngine: {N_HYBRID} requests, prompts "
          f"{min(map(len, zprompts))}-{max(map(len, zprompts))} tokens, {zstats['tokens']} "
          f"tokens generated = {zstats['tok_per_s']} tok/s; median TTFT {zstats['ttft_p50_ms']} "
          f"ms; decode calls {zeng.decode_calls}; slr_matmul launches per tier "
          f"{json.dumps({str(k): v for k, v in tier_launches.items()})} over decode calls "
          f"{json.dumps({str(k): v for k, v in tier_calls.items()})} "
          f"({7 * groups} per call with every site live); peak memory {zpeak:.2f} GiB")
    print(f"  stats: {json.dumps({k: v for k, v in zstats.items() if k != 'sample'})}")
    print(f"  launch counts: {json.dumps(hybrid_counts)}")
    # a short steady window: one request of 8 prompt tokens (23 decode calls;
    # the profiler's event processing grows with the ~3000 ops of each call)
    zeng2 = ReferenceEngine(zbank, EngineConfig(max_slots=4, max_len=128))
    profiled("4i (1 request)", lambda: serve_batch(
        zeng2, zcfg.vocab_size, 1, HYBRID_MAX_NEW, SEED, prompts=[zprompts[0][:8]]))
    del zeng, zeng2, zbank, zmodels, zparams
    torch.cuda.empty_cache()

    phase("4j")
    # 4j. the launcher: the hybrid falls back to the reference engine after the
    # note line; --engine reference serves the Llama (all-zero SLR states)
    bank_keys = {"fmt", "bank", "tier_policy", "requests", "tokens", "tok_per_s", "sample",
                 "steps", "jit_retraces", "tokens_by_tier", "ttft_p50_ms", "ttft_p99_ms",
                 "tiers"}
    for args_j in (["--arch", HYBRID, "--keep-ratios", "1.0,0.5"],
                   ["--arch", "salaad_llama_60m", "--engine", "reference",
                    "--keep-ratios", "1.0,0.6"]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args_j,
                               "--fmt", "fused", "--requests", "4", "--max-new", "8"],
                              capture_output=True, text=True, timeout=600, cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": str(SRC)})
        if proc.returncode:
            fail(f"4j: the serve launcher failed:\n{proc.stderr[-3000:]}")
        lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
        line = lines[-1]
        if set(line) != bank_keys or line["requests"] != 4 or line["tokens"] != 32:
            fail(f"4j: the serve launcher's line is off: {line}")
        if HYBRID in args_j:
            note = lines[0] if len(lines) == 2 else {}
            if "falling back to the reference engine" not in note.get("note", "") \
                    or note["capabilities"]["engine"] != "ReferenceEngine":
                fail(f"4j: the hybrid launcher printed no fallback note: {lines}")
            print(f"main path 4j launcher note: {json.dumps(note)}")
        elif len(lines) != 1:
            fail(f"4j: --engine reference printed more than its line: {lines}")
        print(f"main path 4j launcher {' '.join(args_j)} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(line)}")

    phase("5")
    # ---- 5. first one-shot prefill, chunk and decode tick: card vs CPU -----------
    cpu_params, cpu_state = tree_map(lambda t: t.cpu(), (params, state))
    cpu_dm = DeployedModel.build(cfg, cpu_params, cpu_state, blocks, fmt="fused")

    def compare(what, got, want):
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        print(f"parity {what}: max_abs_err {err:.3e} (tol {LOGIT_TOL:g} x {scale:.3g}), "
              f"argmax agreement {agree:.4f}")
        if not bool(torch.isfinite(got).all()) or err > LOGIT_TOL * scale:
            fail(f"{what} logits on the card disagree with the CPU")

    oneshot = np.zeros((4, 128), np.int32)
    lens_np = np.array([128, 77, 33, 100])
    for b in range(4):
        oneshot[b, : lens_np[b]] = prompts[b][: lens_np[b]]
    mask = torch.arange(128)[None, :] < torch.from_numpy(lens_np)[:, None]
    logits = [model_lib._forward(m.params, {"tokens": torch.from_numpy(oneshot).to(d_)}, cfg,
                                 collect_kv=True)[0].float().cpu()
              for m, d_ in ((dm, dev), (cpu_dm, torch.device("cpu")))]
    compare("first one-shot prefill", logits[0][mask], logits[1][mask])

    counts_np = np.array([64, 64, 20, 64, 37, 64, 64, 51], np.int32)
    chunk = rng.integers(0, cfg.vocab_size, (8, 64)).astype(np.int32)
    chunk[np.arange(64)[None, :] >= counts_np[:, None]] = 0
    runs = {}
    for name, model, d_ in (("card", dm, dev), ("cpu", cpu_dm, torch.device("cpu"))):
        cache = model_lib.init_paged_cache(cfg, 8, 8 * 8, 16, 8, device=d_)
        cache = cache._replace(block_table=torch.arange(64, dtype=torch.int32,
                                                        device=d_).reshape(8, 8))
        c_logits, cache = model_lib.chunk_prefill_step(
            model.params, torch.from_numpy(chunk).to(d_),
            torch.from_numpy(counts_np).to(d_), cache, cfg)
        runs[name] = (model, d_, cache, c_logits.float().cpu())
    # both sides decode the CPU's greedy tokens, so a near-tie cannot fork them
    last = runs["cpu"][3][torch.arange(8), torch.from_numpy(counts_np - 1).long()]
    nxt = last.argmax(-1)[:, None].int()
    logits = {}
    for name, (model, d_, cache, c_logits) in runs.items():
        d_logits, _ = model_lib.decode_step(model.params, nxt.to(d_), cache, cfg)
        logits[name] = (c_logits, d_logits.float().cpu())
    mask = torch.arange(64)[None, :] < torch.from_numpy(counts_np)[:, None]
    compare("first chunk", logits["card"][0][mask], logits["cpu"][0][mask])
    compare("first decode tick", logits["card"][1], logits["cpu"][1])

    # the batched engine's cache: one prefill into a per-slot contiguous
    # cache of 512 positions (row 0 at max_len: both decode writes drop; row
    # 1 at max_len - 1: the second drops), then two decode steps, both sides
    # decoding the CPU's greedy tokens
    slot_lens = np.array([512, 511, 77, 200])
    slot_toks = np.random.default_rng(SEED + 5).integers(0, cfg.vocab_size, (4, 512)).astype(
        np.int32)
    slot_logits = {}
    for name, model, d_ in (("card", dm, dev), ("cpu", cpu_dm, torch.device("cpu"))):
        p_logits, pcache = model_lib.prefill(model.params,
                                             {"tokens": torch.from_numpy(slot_toks).to(d_)},
                                             cfg, max_len=512, cache_dtype=torch.float32)
        slot_cache = model_lib.init_cache(cfg, 4, 512, dtype=torch.float32, device=d_,
                                          per_slot=True)
        slot_cache.k.copy_(pcache.k)
        slot_cache.v.copy_(pcache.v)
        slot_cache.length.copy_(torch.from_numpy(slot_lens).int())
        slot_logits[name] = [p_logits.float().cpu(), slot_cache]
    rows4 = torch.arange(4)
    tok = slot_logits["cpu"][0][rows4, torch.from_numpy(slot_lens - 1)].argmax(-1)[:, None]
    for step_i in range(2):
        for name, model, d_ in (("card", dm, dev), ("cpu", cpu_dm, torch.device("cpu"))):
            d_logits, slot_logits[name][1] = model_lib.decode_step(
                model.params, tok.to(d_), slot_logits[name][1], cfg)
            slot_logits[name].append(d_logits.float().cpu())
        tok = slot_logits["cpu"][-1][:, -1].argmax(-1)[:, None]
    pmask = torch.arange(512)[None, :] < torch.from_numpy(slot_lens)[:, None]
    compare("per-slot prefill", slot_logits["card"][0][pmask], slot_logits["cpu"][0][pmask])
    for step_i in range(2):
        compare(f"per-slot decode step {step_i + 1}", slot_logits["card"][2 + step_i],
                slot_logits["cpu"][2 + step_i])
    got_len = slot_logits["card"][1].length.cpu().tolist()
    if got_len != (slot_lens + 2).tolist():
        fail(f"per-slot decode lengths {got_len}, want {(slot_lens + 2).tolist()}")
    del slot_logits

    phase("5d")
    # 5d. int8 pages, card against CPU. The chunk is quantized once, on the
    # CPU, and both sides decode the first tick from those pages (the CPU's
    # greedy tokens): the card's dequantizing gather and decode against the
    # CPU's, within 1e-3. Each side quantizing its own chunk is held to
    # INT8_OWN_TOL: K/V rows that differ by float rounding land on either
    # side of an int8 rounding boundary, one quantum (1/127 of the row's
    # largest value) apart, and the flips grow layer by layer. The witness
    # beside it is the CPU against itself with the embedding scaled by
    # 1 + r * N(0, 1), r = 1e-7, 1e-6, 1e-5: its flips per layer and its
    # logit gap. Then the sampler's keyed uniforms, bit for bit.
    def int8_chunk(p_, d_):
        cache = model_lib.init_paged_cache(cfg, 8, 8 * 8, 16, 8, device=d_, quantized=True)
        cache = cache._replace(block_table=torch.arange(64, dtype=torch.int32,
                                                        device=d_).reshape(8, 8))
        c_logits, cache = model_lib.chunk_prefill_step(
            p_, torch.from_numpy(chunk).to(d_), torch.from_numpy(counts_np).to(d_), cache, cfg)
        return c_logits.float().cpu(), cache

    cpu = torch.device("cpu")
    c_cpu, cache_cpu = int8_chunk(cpu_dm.params, cpu)
    nxt8 = c_cpu[torch.arange(8), torch.from_numpy(counts_np - 1).long()].argmax(-1)[:, None]
    nxt8 = nxt8.int()
    shared = cache_cpu._replace(**{f: getattr(cache_cpu, f).to(dev)
                                   for f in cache_cpu._fields})       # copied before decoding
    _, cache_own = int8_chunk(dm.params, dev)
    emb = cpu_dm.params["embed"]["embedding"]
    noise = torch.from_numpy(np.random.default_rng(SEED + 5).standard_normal(
        tuple(emb.shape), dtype=np.float32))
    runs8 = [("cpu", cpu_dm.params, cpu, cache_cpu), ("card", dm.params, dev, shared),
             ("card own", dm.params, dev, cache_own)]
    for rel in (1e-7, 1e-6, 1e-5):
        p_ = dict(cpu_dm.params, embed=dict(cpu_dm.params["embed"],
                                            embedding=emb * (1 + rel * noise)))
        runs8.append((f"cpu perturbed {rel:g}", p_, cpu, int8_chunk(p_, cpu)[1]))
    i8_logits = {}
    for name, p_, d_, cache in runs8:
        d_logits, _ = model_lib.decode_step(p_, nxt8.to(d_), cache, cfg)
        i8_logits[name] = d_logits.float().cpu()
    compare("first decode tick over int8 pages (the CPU's pages)", i8_logits["card"],
            i8_logits["cpu"])

    def flips(cache):   # int8 payload elements unlike the CPU's, per layer
        return [int((cache.k[i].cpu() != cache_cpu.k[i]).sum()
                    + (cache.v[i].cpu() != cache_cpu.v[i]).sum()) for i in range(cfg.num_layers)]

    written = int(counts_np.sum()) * cfg.num_kv_heads * cfg.head_dim * 2
    scale8 = float(i8_logits["cpu"].abs().max())
    own_err = float((i8_logits["card own"] - i8_logits["cpu"]).abs().max())
    print(f"parity 5d each side quantizing its own chunk: max_abs_err {own_err:.3e} (tol "
          f"{INT8_OWN_TOL:g} x {scale8:.3g}); int8 payload flips per layer "
          f"{flips(cache_own)} of {written} written")
    for name, _, _, cache in runs8[3:]:
        err = float((i8_logits[name] - i8_logits["cpu"]).abs().max())
        print(f"  witness, the CPU against itself with the embedding scaled by 1 + "
              f"{name.split()[-1]} N(0,1): max_abs_err {err:.3e}; flips per layer {flips(cache)}")
    if not bool(torch.isfinite(i8_logits["card own"]).all()) or own_err > INT8_OWN_TOL * scale8:
        fail("5d: int8 decode from the card's own pages is further from the CPU's than "
             "int8 rounding flips explain")
    slots_u = torch.tensor([0, 3, 7, 2, 1000], dtype=torch.int64)
    u_cpu = keyed_uniform((SEED, 17, 2), slots_u, cfg.vocab_size)
    u_card = keyed_uniform((SEED, 17, 2), slots_u.to(dev), cfg.vocab_size).cpu()
    if not torch.equal(u_cpu, u_card):
        fail("5d: the sampler's keyed uniforms differ between the card and the CPU")
    print(f"parity 5d keyed uniforms (seed {SEED}, step 17, salt 2, 5 slots x "
          f"{cfg.vocab_size}): equal on the card and the CPU, bit for bit")

    phase("5b")
    # 5b. training, card against CPU: K = 5 train steps and one ADMM step from
    # 4g's initial state, the same batches, the same CPU-drawn sketches
    runs = {}
    for name, d_ in (("card", dev), ("cpu", torch.device("cpu"))):
        tr = Trainer(tcfg_arch, TrainerConfig(
            total_steps=TRAIN_K, log_every=1, salaad=train_scfg,
            adam=AdamConfig(lr=TRAIN_LR)), device=d_)
        st0 = tr.init(params=tree_map(lambda t: t.to(d_), init_cpu))
        t0 = time.perf_counter()
        st = tr.fit(st0, SyntheticC4(DataConfig(tcfg_arch.vocab_size, TRAIN_SEQ, PARITY_BATCH,
                                                seed=SEED)))
        runs[name] = (tree_map(lambda t: t.cpu(), st),
                      [m["loss"] for m in tr.metrics_log if "loss" in m])
        print(f"parity 5b training on the {name}: {TRAIN_K} steps + 1 ADMM step in "
              f"{time.perf_counter() - t0:.1f} s")
    (g_st, g_loss), (c_st, c_loss) = runs["card"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(g_loss, c_loss))
    print(f"parity 5b losses: card {json.dumps([round(x, 6) for x in g_loss])} cpu "
          f"{json.dumps([round(x, 6) for x in c_loss])}: max relative error {loss_err:.3e} "
          f"(tol 1e-4)")
    if loss_err > 1e-4:
        fail("5b: the card's training losses disagree with the CPU's")
    # ADMM state, through products (the SVD factors' signs are free):
    #   L = p @ vt and Z: 1e-4 of the tensor's largest value (Z away from
    #   positions where S swapped);
    #   S dense: 1e-4 of its largest value, except for swaps at the COO cap's
    #   boundary (the cap keeps the top 15% by magnitude, and two entries
    #   within rounding of the cap-th magnitude may trade places): at most
    #   1 in 10^5 of the positions, each zero on one side;
    #   Y = Y + rho (X - L - S) is rho times rounding after the first sweep
    #   (beta = 0 makes S the whole residual): 1e-5 of rho * max |X|;
    #   alpha, beta: the controller reads an integer rank count and a live
    #   count, so one count apart is allowed: rho * dalpha / min(n, m) and
    #   rho * dbeta / (n m), plus 1e-5 relative.
    worst = {}
    ccfg = train_scfg.controller
    for info in select_blocks(c_st.params, train_scfg.selection):
        g, c = g_st.slr[info.name], c_st.slr[info.name]
        x = leaf_by_path(c_st.params, info.path).float()
        nb = info.num_blocks
        rel = lambda a, b: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)  # noqa: E731
        lg, lc = g.p @ g.vt, c.p @ c.vt
        sg = sparse_dense(g.s_coo).reshape(nb, -1)
        sc = sparse_dense(c.s_coo).reshape(nb, -1)
        s_scale = float(sc.abs().max())
        swapped = (sg - sc).abs() > 1e-4 * s_scale
        n_swap = int(swapped.sum())
        if n_swap > max(2, sg.numel() // 10**5) or bool(((sg != 0) & (sc != 0) & swapped).any()):
            fail(f"5b {info.name}: S differs beyond cap-boundary swaps ({n_swap} positions)")
        keep = ~swapped.reshape(g.z.shape)
        z_err = float((g.z - c.z)[keep].abs().max()) / float(c.z.abs().max())
        y_err = float((g.y - c.y).abs().max()) / (c.rho * float(x.abs().max()))
        a_tol = c.rho * ccfg.dalpha / min(info.n, info.m) + 1e-5 * float(c.alpha.abs().max())
        b_tol = c.rho * ccfg.dbeta / (info.n * info.m) + 1e-5 * float(c.beta.abs().max())
        a_err = float((g.alpha - c.alpha).abs().max())
        b_err = float((g.beta - c.beta).abs().max())
        worst[info.name] = dict(L=rel(lg, lc), S_swaps=n_swap, Z=z_err, Y=y_err,
                                alpha=a_err, beta=b_err)
        if worst[info.name]["L"] > 1e-4 or z_err > 1e-4 or y_err > 1e-5 or a_err > a_tol \
                or b_err > b_tol:
            fail(f"5b {info.name}: the card's ADMM state disagrees with the CPU's: "
                 f"{worst[info.name]} (alpha tol {a_tol:.3g}, beta tol {b_tol:.3g})")
    print(f"parity 5b ADMM state (relative errors; S positions swapped at the cap): "
          f"{json.dumps(worst)}")

    phase("5c")
    # 5c. the hybrid, card against CPU: full width at one group (6 layers),
    # f32, TF32 off; one fused tier (keep 0.5) built on the card and copied
    ccfg = dataclasses.replace(get_arch(HYBRID), num_layers=6, param_dtype=torch.float32)
    t0 = time.perf_counter()
    cparams = model_lib.init_params(ccfg, seed=SEED)
    cstate, cblocks = init_slr_state(cparams, zscfg)
    torch.backends.cuda.matmul.allow_tf32 = True        # the build only
    cstate, _ = admm_update(cparams, cstate, cblocks, zscfg, 0)
    slr_c, _ = hpa_keep_ratio(cstate, cblocks, 0.5, 0.7)
    card_dm = DeployedModel.build(ccfg, cparams, slr_c, cblocks, fmt="fused")
    torch.backends.cuda.matmul.allow_tf32 = False
    del cstate, slr_c
    host_dm = DeployedModel(ccfg, tree_map(lambda t: t.cpu(), card_dm.params), "fused")
    print(f"parity 5c build: {ccfg.name} at {ccfg.num_layers} layers, f32, keep 0.5 fused "
          f"tier in {time.perf_counter() - t0:.1f} s")
    crng = np.random.default_rng(SEED + 2)
    cprompts = [crng.integers(0, ccfg.vocab_size, int(n)).tolist()
                for n in crng.integers(4, 9, N_HYBRID_CPU)]
    streams = {}
    for name, model in (("card", card_dm), ("cpu", host_dm)):
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        eng = ReferenceEngine(model, EngineConfig(max_slots=2, max_len=32))
        for pr in cprompts:
            eng.submit(pr, max_new_tokens=MAX_NEW_CPU)
        streams[name] = {r.uid: r.out_tokens for r in eng.run()}
        launched = ops.launch_counts()["slr_matmul"]
        print(f"parity 5c streams on the {name}: {eng.decode_calls} decode calls in "
              f"{time.perf_counter() - t0:.1f} s, slr_matmul launches {launched}")
        if (name == "card") != (launched > 0):
            fail(f"5c: the unstacked kernel launched {launched} times on the {name}")
    same = sum(streams["card"][u] == streams["cpu"][u] for u in streams["cpu"])
    print(f"parity 5c streams: {same} of {len(streams['cpu'])} token-identical "
          f"({N_HYBRID_CPU} requests x {MAX_NEW_CPU} tokens)")
    if streams["card"] != streams["cpu"]:
        fail(f"5c: the card's hybrid streams differ from the CPU's: {streams}")
    logit_runs = {}
    for name, model, d_ in (("card", card_dm, dev), ("cpu", host_dm, torch.device("cpu"))):
        cache = model_lib.init_cache(ccfg, 1, 32, dtype=torch.float32, device=d_)
        steps = []
        for tok in cprompts[0]:
            lg, cache = model_lib.decode_step(model.params, torch.tensor([[tok]], device=d_),
                                              cache, ccfg)
            steps.append(lg[0, -1].float().cpu())
        logit_runs[name] = torch.stack(steps)
    compare("5c hybrid decode steps", logit_runs["card"], logit_runs["cpu"])
    toks = torch.from_numpy(crng.integers(0, ccfg.vocab_size, (2, 16))).to(dev)
    full, _ = model_lib._forward(card_dm.params, {"tokens": toks}, ccfg)
    _, pcache = model_lib.prefill(card_dm.params, {"tokens": toks[:, :15]}, ccfg, max_len=32)
    pcache = pcache._replace(**{f: getattr(pcache, f).float()
                                for f in ("ssm_state", "conv", "k", "v")})
    step, _ = model_lib.decode_step(card_dm.params, toks[:, 15:], pcache, ccfg)
    d_err = float((step[:, 0].float() - full[:, -1].float()).abs().max())
    d_scale = float(full[:, -1].float().abs().max())
    print(f"parity 5c prefill(15) + decode vs the no-cache forward on the card: max_abs_err "
          f"{d_err:.3e} (tol 5e-2 x (1 + |logit|), as JAX's test_decode_consistency; max "
          f"|logit| {d_scale:.3g})")
    if not torch.allclose(step[:, 0].float(), full[:, -1].float(), atol=5e-2, rtol=5e-2):
        fail("5c: prefill + decode disagrees with the no-cache forward on the card")
    del card_dm, host_dm, cparams

    phase("end")
    # ---- result lines -------------------------------------------------------------
    meta = {
        "slr_matmul": ("src/repro_torch/kernels/csrc/slr_matmul.cu",
                       "src/repro/kernels/slr_matmul.py:196"),
        "slr_matmul_stacked": ("src/repro_torch/kernels/csrc/slr_matmul.cu",
                               "src/repro/kernels/slr_matmul.py:316"),
        "slr_matmul_multi": ("src/repro_torch/kernels/csrc/slr_matmul.cu",
                             "src/repro/kernels/slr_matmul.py:448"),
        "lowrank_matmul": ("src/repro_torch/kernels/csrc/lowrank_matmul.cu",
                           "src/repro/kernels/lowrank_matmul.py:55"),
        "bsr_matmul": ("src/repro_torch/kernels/csrc/bsr_matmul.cu",
                       "src/repro/kernels/bsr_matmul.py:158"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:90"),
        "paged_attention_kquery": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:204"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:75"),
        "page_copy": ("src/repro_torch/kernels/csrc/page_copy.cu",
                      "src/repro/kernels/page_copy.py:38"),
        "soft_threshold": ("src/repro_torch/kernels/csrc/soft_threshold.cu",
                           "src/repro/kernels/soft_threshold.py:26"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r_ = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": (fused_counts[name] + bsr_counts[name] + adapter_counts[name]
                         + spec_par_counts[name] + spec_seq_counts[name] + int8_counts[name]
                         + batched_counts[name] + train_counts[name] + sweep_counts[name]
                         + hybrid_counts[name]),
            "max_abs_err": r_["max_abs_err"], "ms": r_["ms"],
            "plain_ms": r_["plain_ms"], "bound_ms": r_["bound"][0],
            "bound_by": r_["bound"][1], "library_ms": r_["library_ms"],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
