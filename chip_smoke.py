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
   alone, replayed from a CUDA graph),
   then timed with CUDA events beside its plain version, a one-call PyTorch
   yardstick and its bound (bytes over 3.35 TB/s or operations over the
   peak of the kernel's route, whichever is larger, for this run's data:
   f32 at 67 TFLOP/s, 3xTF32 (the fused SLR body, flash attention in f32)
   at 495 / 3 TFLOP/s, bf16 at 989 TFLOP/s);
   3f also holds flash attention at head dims 80 (Zamba2) and 128, f32 and
   bf16, and times the main shape in bf16 and on the device alone beside
   SDPA;
   3i holds the ADMM S-update's soft_threshold at the embedding and
   layer-stack shapes with NaN, +-inf, a zero and an above-max threshold;
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
   b. the bsr bank serves 8 requests; the block-CSC and low-rank kernels must
      launch;
   c. the single fused model of the first slice serves 16 requests with
      chunked prefill of 64;
   d. ``python -m repro_torch.launch.serve`` runs once as a bank and once
      with ``--adapters 3 --max-resident-adapters 2``, and prints its lines;
   e. run (a) again under torch.profiler: device busy time, idle share and
      each kernel's share of device time;
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
5. parity: the first one-shot prefill's, the first chunk's and the first
   decode tick's logits on the card against the same model on the CPU; then
   (5b) five train steps and one ADMM step from one full-width state on the
   card and on the CPU, the same batches and CPU-drawn sketches; (5c) one
   fused tier of the hybrid at full width and one group (6 layers, f32) on
   the card and on the CPU: ReferenceEngine streams token-identical, decode
   logits within 1e-3, and on the card prefill(15) + one decode step against
   the no-cache forward (JAX's ``test_decode_consistency``).

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
import subprocess
import tempfile
import sys
import time
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
PEAK_BF16_FLOPS = 989e12         # H100 SXM dense bf16 on the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # relative to the output's max |value|
LOGIT_TOL = 1e-3                            # card vs CPU, relative to max |logit|


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
    from repro_torch.serving.engine import EngineConfig, PagedServingEngine, ReferenceEngine
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

    def check(name, got, want, dtype) -> float:
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            fail(f"{name}: non-finite output")
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1.0)
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
    # the gate site's factors
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
    x = rand(512, k_dim)
    p_l, vt_l = gate.p[lay], gate.vt[lay]
    results["lowrank_matmul"] = dict(
        shape=f"gate factors, T=512, K={k_dim} M={m_dim} r={r}",
        max_abs_err=lr_err,
        ms=time_ms(torch, lambda: ops.lowrank_matmul(x, p_l, vt_l)),
        plain_ms=time_ms(torch, lambda: ref.lowrank_matmul_ref(x, p_l, vt_l)),
        library_ms=time_ms(torch, lambda: torch.linalg.multi_dot([x, p_l, vt_l])),
        bound=bound_ms(4 * (512 * k_dim + k_dim * r + r * m_dim + 512 * m_dim),
                       2 * 512 * (k_dim * r + r * m_dim)),
    )

    # 3c. block-CSC matmul: every site's S at the bsr format's widths, bf16,
    # ragged T / n / m with per-column counts below MAXB
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
    x = rand(512, k_dim)
    results["bsr_matmul"] = dict(
        shape=f"gate site S, T=512, n={k_dim} m={m_dim} bs={bs} live tiles {live}",
        max_abs_err=bsr_err,
        ms=time_ms(torch, lambda: ops.bsr_matmul(x, s_gate)),
        plain_ms=time_ms(torch, lambda: ref.bsr_matmul_ref(x, s_gate)),
        library_ms=time_ms(torch, lambda: torch.matmul(x, s_dense)),
        bound=bound_ms(4 * (512 * k_dim + 512 * m_dim + live * bs * bs)
                       + 4 * (s_gate.counts.shape[0] + live), 2 * 512 * live * bs * bs),
    )
    decode_rows["bsr_matmul gate T=8"] = (
        time_ms(torch, lambda: ops.bsr_matmul(x8, s_gate)),
        time_ms(torch, lambda: ref.bsr_matmul_ref(x8, s_gate)),
        time_ms(torch, lambda: torch.matmul(x8, s_dense)),
        bound_ms(4 * (8 * k_dim + 8 * m_dim + live * bs * bs)
                 + 4 * (s_gate.counts.shape[0] + live), 2 * 8 * live * bs * bs))

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
    ragged = torch.tensor([0, 15, 16, 17, 200, 511, 1, 63], dtype=torch.int32, device=dev)
    pa_err = max(pa_err, check("paged_attention ragged lengths", ops.paged_attention(
        q, kp, vp, table, ragged), ref.paged_attention_ref(q, kp, vp, table, ragged),
        torch.float32))
    keys = np.minimum(lengths_np + 1, seq)
    dec_mask = (pos[None, :] <= lengths[:, None])[:, None, None, :]
    q4 = q[:, :, None]
    results["paged_attention"] = dict(
        shape=f"decode tick: {slots} slots, {hq} heads, head_dim {d}, pages of {pbs}, "
              f"lengths {int(lengths_np.min())}-{int(lengths_np.max())}",
        max_abs_err=pa_err,
        ms=time_ms(torch, lambda: ops.paged_attention(q, kp, vp, table, lengths)),
        plain_ms=time_ms(torch, lambda: ref.paged_attention_ref(q, kp, vp, table, lengths)),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k_g, v_g, attn_mask=dec_mask)),
        bound=bound_ms(4 * (2 * slots * hq * d + 2 * hkv * d * int(keys.sum()) + slots * 4
                            + int(np.ceil(keys / pbs).sum())),
                       4 * hq * d * int(keys.sum())),
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
    q_rag = rand(3, hq, 21, d)
    kq_err = max(kq_err, check("paged_attention_kquery kq=21", ops.paged_attention_kquery(
        q_rag, kp, vp, table[:3], lengths_kq[:3]), ref.paged_attention_kquery_ref(
        q_rag, kp, vp, table[:3], lengths_kq[:3]), torch.float32))
    lk = lengths_kq.cpu().numpy().astype(np.int64)
    pairs = int(sum(np.minimum(lk[b] + np.arange(kq) + 1, seq).sum() for b in range(slots)))
    kq_keys = int(np.minimum(lk + kq, seq).sum())
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
        bound=bound_ms(4 * (2 * slots * hq * kq * d + 2 * hkv * d * kq_keys + slots * 4
                            + int(np.ceil(np.minimum(lk + kq, seq) / pbs).sum())),
                       4 * hq * d * pairs),
    )

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
    # row invariance across B: slots 0..b-1 of an 8-slot call equal a b-slot call
    for name, lin in sorted(pooled.items()):
        for t_dim in (1, 8):
            x = inv_rand(8, t_dim, lin.shape[0])
            y = ops.slr_matmul_multi(x, lin.p, lin.vt, lin.s_stack, ids, nl, lay)
            for b in (1, 3):
                if not torch.equal(ops.slr_matmul_multi(x[:b].contiguous(), lin.p, lin.vt,
                                                        lin.s_stack, ids[:b].contiguous(), nl,
                                                        lay), y[:b]):
                    fail(f"slr_matmul_multi {name}: a {b}-slot call differs from slots "
                         f"0..{b - 1} of the 8-slot call (T={t_dim})")
    print("  check slr_matmul_multi: slots 0..b-1 of an 8-slot call equal a b-slot call, bit "
          "for bit, b in (1, 3), T in (1, 8), every site")

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
    def soft_check(shape, dt) -> float:
        nb = shape[0]
        x = rand(*shape, scale=3.0).to(dt)
        flat = x.view(nb, -1)
        flat[:, 0] = float("nan")
        flat[:, 1] = float("inf")
        flat[:, -1] = -float("inf")
        tau = torch.rand(nb, device=dev) * 2
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

    st_err = 0.0
    for shape in ((1, 32000, 512), (8, 512, 1376), (8, 1376, 512), (3, 37, 61)):
        for dt in (torch.float32, torch.bfloat16):
            err = soft_check(shape, dt)
            st_err = max(st_err, err) if dt == torch.float32 else st_err
    soft_rows = {}
    for shape, what in (((1, 32000, 512), "the embedding leaf"),
                        ((8, 512, 1376), "the gate stack")):
        x = rand(*shape)
        tau = torch.rand(shape[0], device=dev) * 0.5
        lam = float(tau[0])
        soft_rows[shape] = dict(
            shape=f"{shape} f32, {what}",
            max_abs_err=st_err,
            ms=time_ms(torch, lambda: ops.soft_threshold(x, tau)),
            plain_ms=time_ms(torch, lambda: ref.soft_threshold_ref(x, tau)),
            library_ms=time_ms(torch, lambda: F.softshrink(x, lam)),
            bound=bound_ms(2 * 4 * x.numel() + 4 * shape[0], 0))
    results["soft_threshold"] = soft_rows[(1, 32000, 512)]
    r_ = soft_rows[(8, 512, 1376)]
    print(f"  time soft_threshold ({r_['shape']}): kernel {r_['ms']:.4f} ms, plain "
          f"{r_['plain_ms']:.4f} ms, library {r_['library_ms']:.4f} ms (F.softshrink, one "
          f"scalar tau), bound {r_['bound'][0]:.4f} ms ({r_['bound'][1]})")

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
    for name, (ms, plain, lib, (b_ms, b_by)) in decode_rows.items():
        print(f"  time {name} (decode tick): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"library {lib:.4f} ms (torch.matmul, dense W), bound {b_ms:.4f} ms ({b_by})")

    phase("4a")
    # ---- 4. main path -------------------------------------------------------------
    def serve(label: str, engine, prompts, tiers, need: tuple[str, ...]) -> tuple[dict, dict]:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        stats = serve_batch(engine, cfg.vocab_size, len(prompts), MAX_NEW, SEED,
                            tiers=tiers, prompts=prompts)
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
              f"{engine.chunk_calls}, decode calls {engine.decode_calls}")
        print(f"  stats: {json.dumps(stats)}")
        print(f"  launch counts: {json.dumps(counts)}")
        return stats, counts

    bank_ecfg = EngineConfig(max_slots=8, max_len=512, block_size=16, num_blocks=BANK_PAGES,
                             prefix_cache=True, tier_policy="pressure")
    prompts = bank_prompts(np.random.default_rng(SEED), cfg.vocab_size, bank_ecfg.block_size)
    engine = PagedServingEngine(banks["fused"], bank_ecfg)
    fused_stats, fused_counts = serve(
        "4a fused bank", engine, prompts, tuple(range(len(BUDGETS))),
        ("flash_attention", "page_copy", "paged_attention", "paged_attention_kquery",
         "slr_matmul_stacked"))
    pc = fused_stats["prefix_cache"]
    if pc["hits"] < 1 or pc["cow_copies"] < 1 or fused_stats["downshift_ticks"] < 1:
        fail(f"the fused bank run needs prefix hits, copy-on-write copies and downshifts: "
             f"{pc}, downshift_ticks {fused_stats['downshift_ticks']}")

    bsr_prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                   for n in rng.integers(20, 301, N_BSR)]
    engine = PagedServingEngine(banks["bsr"], EngineConfig(max_slots=8, max_len=512,
                                                           block_size=16))
    _, bsr_counts = serve("4b bsr bank", engine, bsr_prompts, tuple(range(len(BUDGETS))),
                          ("bsr_matmul", "lowrank_matmul", "flash_attention",
                           "paged_attention"))

    chunk_prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                     for n in rng.integers(20, 401, N_REQUESTS)]
    engine = PagedServingEngine(dm, EngineConfig(max_slots=8, max_len=512, block_size=16,
                                                 prefill_chunk=64))
    serve("4c fused model, chunked prefill", engine, chunk_prompts, (None,),
          ("slr_matmul_stacked", "paged_attention", "paged_attention_kquery"))

    cli = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "salaad_llama_60m",
           "--fmt", "fused"]
    for extra in (["--keep-ratios", ",".join(map(str, BUDGETS)), "--prefix-cache",
                   "--tier-policy", "pressure"],
                  ["--adapters", "3", "--max-resident-adapters", "2"]):
        t0 = time.perf_counter()
        proc = subprocess.run(cli + extra, capture_output=True, text=True, timeout=600,
                              cwd=ROOT, env={**os.environ, "PYTHONPATH": str(SRC)})
        if proc.returncode:
            fail(f"the serve launcher failed:\n{proc.stderr[-3000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        if line["requests"] != 4 or line["tokens"] != 32 or "jit_retraces" in line:
            fail(f"the serve launcher's line is off: {line}")
        if "--adapters" in extra and (line["adapters"]["swaps"] < 1
                                      or sorted(line["tokens_by_adapter"]) != ["0", "1", "2"]):
            fail(f"the adapter launcher's line is off: {line}")
        print(f"main path 4d launcher {' '.join(extra)} ({time.perf_counter() - t0:.1f} s): "
              f"{json.dumps(line)}")

    # 4e. where the time goes: a run under torch.profiler (here 4a; 4f's
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

    engine = PagedServingEngine(banks["fused"], bank_ecfg)
    profiled("4a", lambda: serve_batch(engine, cfg.vocab_size, len(prompts), MAX_NEW, SEED,
                                       tiers=tuple(range(len(BUDGETS))), prompts=prompts))

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
                 "steps", "tokens_by_tier", "ttft_p50_ms", "ttft_p99_ms", "tiers"}
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
        "lowrank_matmul": ("src/repro_torch/kernels/csrc/slr_matmul.cu",
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
                         + train_counts[name] + sweep_counts[name] + hybrid_counts[name]),
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
