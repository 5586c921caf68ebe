#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) on any
error:

1. build: compile every CUDA kernel of the main path from
   ``src/repro_torch/kernels/csrc`` (nvcc, sm_90a) and load it;
2. model: salaad_llama_60m at full width (8 layers, d_model 512, f32,
   ``kernel_impl='pallas'``), random weights from a numpy seed, a non-trivial
   SLR state from ``init_slr_state`` + exact-SVD ``admm_update`` steps,
   deployed in the ``fused`` format;
3. kernels: each of the four kernels against its plain PyTorch version on
   the card, at the main path's shapes (f32 and bf16) and at ragged shapes,
   then timed with CUDA events beside its plain version, a one-call PyTorch
   yardstick and its bound (bytes over 3.35 TB/s or f32 operations over
   67 TFLOP/s, whichever is larger);
4. main path: the paged engine serves 16 greedy requests (prompts of 20-400
   tokens, chunked prefill of 64, 32 new tokens each) with every launch
   count set to 0 just before; the fused SLR, paged decode and paged
   k-query kernels must each have launched;
5. parity: the first chunk's and first decode tick's logits on the card
   against the same model on the CPU (plain versions).

Output: the card's name and power limit, build time, per-phase lines, then
one ``{"kernels": [...]}`` line and, last, the device line the harness reads.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
N_REQUESTS = 16
MAX_NEW = 32
PEAK_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12           # H100 SXM f32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # relative to the output's max |value|
LOGIT_TOL = 1e-3                            # card vs CPU, relative to max |logit|


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


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
    from repro_torch.kernels.bsr_matmul import bsr_to_dense
    from repro_torch.models import model as model_lib
    from repro_torch.serving.deployed import DeployedModel
    from repro_torch.serving.engine import EngineConfig, PagedServingEngine
    from repro_torch.tree import tree_map

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s ({_build.build().name})")

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
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    g_bf = dataclasses.replace(gate.s_stack, vals=bf(gate.s_stack.vals))
    x = bf(rand(512, 512))
    check("slr_matmul_stacked gate T=512", ops.slr_matmul_stacked(
        x, bf(gate.p), bf(gate.vt), g_bf, lay), ref.slr_matmul_stacked_ref(
        x, bf(gate.p), bf(gate.vt), g_bf, lay), torch.bfloat16)
    x = rand(512, 512)
    w_dense = (gate.p[lay] @ gate.vt[lay] + bsr_to_dense(gate.s_stack.at_layer(lay))).contiguous()
    live = int(gate.s_stack.counts[lay].sum())
    k_dim, m_dim, r = 512, gate.shape[1], gate.p.shape[-1]
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
        bound=bound_ms(nbytes, flops),
    )
    x8 = rand(8, 512)
    nbytes8 = 4 * (8 * k_dim + k_dim * r + r * m_dim + 8 * m_dim + live * bs * bs) \
        + 4 * (gate.s_stack.counts.shape[1] + live)
    decode_ms = time_ms(torch, lambda: ops.slr_matmul_stacked(
        x8, gate.p, gate.vt, gate.s_stack, lay))
    b8, by8 = bound_ms(nbytes8, 2 * 8 * (k_dim * r + r * m_dim + live * bs * bs))
    print(f"  time slr_matmul_stacked gate T=8 (decode tick): {decode_ms:.4f} ms, "
          f"bound {b8:.4f} ms ({by8})")

    # 3b. low-rank matmul (the empty-S corner) on the gate site's factors
    lr_err = 0.0
    for t_dim in (8, 512, 37):
        x = rand(t_dim, 512)
        lr_err = max(lr_err, check(f"lowrank_matmul gate T={t_dim}", ops.lowrank_matmul(
            x, gate.p[lay], gate.vt[lay]), ref.lowrank_matmul_ref(x, gate.p[lay], gate.vt[lay]),
            torch.float32))
    x = bf(rand(512, 512))
    check("lowrank_matmul gate T=512", ops.lowrank_matmul(
        x, bf(gate.p[lay]), bf(gate.vt[lay])), ref.lowrank_matmul_ref(
        x, bf(gate.p[lay]), bf(gate.vt[lay])), torch.bfloat16)
    x = rand(512, 512)
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

    # 3c/3d. paged attention at the engine's pool shapes: 8 slots, 8 heads,
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
    for name, r_ in results.items():
        print(f"  time {name} ({r_['shape']}): kernel {r_['ms']:.4f} ms, plain "
              f"{r_['plain_ms']:.4f} ms, library {r_['library_ms']:.4f} ms, bound "
              f"{r_['bound'][0]:.4f} ms ({r_['bound'][1]})")

    # ---- 4. main path -------------------------------------------------------------
    prompt_lens = rng.integers(20, 401, N_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in prompt_lens]
    ecfg = EngineConfig(max_slots=8, max_len=512, block_size=16, prefill_chunk=64)
    engine = PagedServingEngine(dm, ecfg)
    for p in prompts:
        engine.submit(p, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    if len(done) != N_REQUESTS or any(len(r.out_tokens) != MAX_NEW for r in done):
        fail(f"main path finished {len(done)} of {N_REQUESTS} requests")
    toks = [t for r in done for t in r.out_tokens]
    if not all(0 <= t < cfg.vocab_size for t in toks):
        fail("generated token outside the vocabulary")
    for name in ("slr_matmul_stacked", "paged_attention", "paged_attention_kquery"):
        if counts[name] < 1:
            fail(f"the main path never launched {name}: {counts}")
    ttft = sorted(r.first_token_at - r.submitted_at for r in done)
    print(f"main path: {N_REQUESTS} requests, prompts {int(prompt_lens.min())}-"
          f"{int(prompt_lens.max())} tokens ({int(prompt_lens.sum())} total), "
          f"{len(toks)} tokens generated in {wall:.3f} s = {len(toks) / wall:.1f} tok/s "
          f"({(len(toks) + int(prompt_lens.sum())) / wall:.1f} tok/s incl. prompts); "
          f"ticks {engine._steps}, chunk calls {engine.chunk_calls}, decode calls "
          f"{engine.decode_calls}, evictions {engine.evictions}; median TTFT "
          f"{ttft[len(ttft) // 2]:.3f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"launch counts: {json.dumps(counts)}")

    # ---- 4b. where the time goes: the same workload under torch.profiler -------
    from torch.profiler import ProfilerActivity, profile

    engine = PagedServingEngine(dm, ecfg)
    for p in prompts:
        engine.submit(p, max_new_tokens=MAX_NEW)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    device_events = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device_events) / 1e3
    if busy_ms > 0:
        print(f"profile: wall {wall_prof * 1e3:.1f} ms under the profiler, device busy "
              f"{busy_ms:.1f} ms, idle share {1 - busy_ms / (wall_prof * 1e3):.3f}")
        for e in sorted(device_events, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  device {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} calls  "
                  f"{e.key[:90]}")
    else:
        print("profile: the profiler recorded no device time (not measured)")

    # ---- 5. first chunk and first decode tick: card vs CPU ------------------------
    cpu_params, cpu_state = tree_map(lambda t: t.cpu(), (params, state))
    cpu_dm = DeployedModel.build(cfg, cpu_params, cpu_state, blocks, fmt="fused")
    chunk = np.zeros((8, 64), np.int32)
    counts_np = np.array([64, 64, 20, 64, 37, 64, 64, 51], np.int32)
    for b in range(8):
        chunk[b, : counts_np[b]] = prompts[b % len(prompts)][: counts_np[b]]
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
    for i, what in enumerate(("first chunk", "first decode tick")):
        got, want = logits["card"][i], logits["cpu"][i]
        if what == "first chunk":
            mask = torch.arange(64)[None, :] < torch.from_numpy(counts_np)[:, None]
            got, want = got[mask], want[mask]
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        print(f"parity {what}: max_abs_err {err:.3e} (tol {LOGIT_TOL:g} x {scale:.3g}), "
              f"argmax agreement {agree:.4f}")
        if not bool(torch.isfinite(got).all()) or err > LOGIT_TOL * scale:
            fail(f"{what} logits on the card disagree with the CPU")

    # ---- result lines -------------------------------------------------------------
    meta = {
        "slr_matmul_stacked": ("src/repro_torch/kernels/csrc/slr_matmul.cu",
                               "src/repro/kernels/slr_matmul.py:316"),
        "lowrank_matmul": ("src/repro_torch/kernels/csrc/slr_matmul.cu",
                           "src/repro/kernels/lowrank_matmul.py:55"),
        "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention.py:90"),
        "paged_attention_kquery": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:204"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        r_ = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r_["max_abs_err"], "ms": r_["ms"],
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
