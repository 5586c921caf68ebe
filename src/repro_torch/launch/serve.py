"""Serving launcher: materialize the HPA budget spectrum of one SLR state as
ONE ModelBank and serve a batch of requests through one engine (port of
``repro/launch/serve.py``: ``--engine paged``, ``batched``, ``speculative``
and ``reference``).

``--keep-ratios`` names the bank's budget tiers (tier 0 = largest). Requests
spread round-robin across the tiers (pin them all with ``--tier``); the
engine runs one decode per active tier over the shared paged KV, and
``--tier-policy pressure`` downshifts the serving tier under page pressure
before evicting. ``--engine batched`` serves through the slot-padded
``ServingEngine`` (a contiguous cache of ``--max-len`` positions per slot;
the paged-only switches raise in its constructor). ``--ckpt-dir`` serves the parameters and SLR state of the
latest training checkpoint there (the JAX package's format, written by
either package's trainer); without one the SLR state is the fresh all-zero
one, so every SLR site takes the zero corner, as in the JAX launcher.

``--engine speculative`` (or any ``--spec-k`` > 0, which implies it; k is 4
by default) serves the largest keep as the verifying target and drafts with
the tier at ``--spec-budget`` (the other ``--keep-ratios`` are not built, and
a note line says so); ``--spec-adaptive`` adapts k to the acceptance rate,
which the JSON line reports with ``tokens_per_step``. ``--kv-dtype int8``
stores quantized KV pages. As in the JAX launcher there is no temperature
switch: the launcher serves greedy.

``--adapters N`` serves N tenants instead: HPA views of the state at keeps
``linspace(1.0, 0.4, N)``, each adapterized onto the keep-1.0 base, as ONE
``AdapterBank`` (``--max-resident-adapters`` rows on the device; fewer than
N turns on LRU swaps), requests round-robin over the tenants.

``--arch`` takes every id of ``configs.ARCH_IDS``. A family without per-slot
cache lengths (the ssm ``mamba2_370m``, the hybrid ``zamba2_2p7b``, the
encdec ``whisper_small``) serves through ``ReferenceEngine`` whatever
``--engine`` says, after a
``{"note": ..., "capabilities": ...}`` line, as the JAX launcher does;
``--engine reference`` picks that engine for any family.

It prints one JSON line with the JAX launcher's keys. ``jit_retraces``
counts the kernels' launch-plan builds on a (program, tier) that had already
run (``serving/telemetry.py``; 0 on the CPU, where no plan is built). TTFT
percentiles come from the engine's registry (from the requests' timestamps
when telemetry is off). ``--trace-out`` writes a Chrome trace of the run and
``--trace-events`` its JSONL event log; ``--metrics-port`` serves the
registry's Prometheus text on 127.0.0.1 during the run, and
``--metrics-out`` writes one scrape (over HTTP when the port is set).

  python -m repro_torch.launch.serve --arch salaad_llama_60m \\
      --keep-ratios 1.0,0.6,0.3 --fmt fused --prefix-cache --tier-policy pressure
  python -m repro_torch.launch.serve --arch salaad_llama_60m --fmt fused \\
      --adapters 3 --max-resident-adapters 2
  python -m repro_torch.launch.serve --arch salaad_llama_60m --fmt fused \\
      --keep-ratios 1.0,0.3 --engine speculative --spec-k 4 --spec-budget 0.3
  python -m repro_torch.launch.serve --arch salaad_llama_60m --engine batched \\
      --keep-ratios 1.0,0.6,0.3 --fmt fused --trace-out t.json --metrics-out m.txt
  python -m repro_torch.launch.serve --arch zamba2_2p7b --keep-ratios 1.0,0.5 --fmt fused
  python -m repro_torch.launch.serve --arch qwen3_moe_30b_a3b --keep-ratios 1.0,0.5 \
      --fmt fused --prefill-chunk 128 --prefix-cache
  python -m repro_torch.launch.serve --arch whisper_small --keep-ratios 1.0,0.5 --fmt bsr

``--mesh model=N[,data=M]`` serves tensor- and data-parallel
(``parallel/sharding.py``): the launcher checks the spec against the
architecture, then starts N x M rank processes (``launch/mesh.py::run_ranks``:
NCCL when each rank gets a card of its own, gloo when they share one card or
run on the CPU) that each build the same bank and serve the same requests;
rank 0 prints a note line naming the backend and the collectives' path, then
the usual line. Started inside an initialised group (``torchrun`` sets
``WORLD_SIZE``), it joins that group instead. Every rank holds ``1/N`` of the
heads, so the streams are the unsharded ones.

  python -m repro_torch.launch.serve --arch salaad_llama_60m --reduced --device cpu \
      --keep-ratios 1.0,0.6,0.3 --mesh model=2,data=2

Tensors live on the card unless ``--device cpu`` is given (with
``--reduced``, for a run of the plain versions on the CPU). On the card the
paged engines run the CUDA attention kernels (``kernel_impl='pallas'``:
flash prefill, paged decode and k-query) over pages in the model's dtype or
bf16 pages under an f32 model; int8 pages take the flash prefill and the
dequantizing page gather; the batched engine takes the flash prefill (its
decode is a masked einsum, as in the JAX package); the reference engine and
the CPU keep the config's attention path.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import urllib.request

import numpy as np
import torch
import torch.distributed as dist

from ..configs import get_arch
from ..core.admm import SalaadConfig, init_slr_state
from ..core.hpa import hpa_keep_ratio
from ..core.selection import SelectionConfig
from ..device import resolve_device
from ..models import model as model_lib
from ..serving.adapters import AdapterBank, adapterize
from ..serving.deployed import DeployedModel
from ..kernels.paged_attention import takes_pages
from ..serving.elastic import ModelBank, format_capability_table
from ..serving.engine import (
    BATCHED_FAMILIES,
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
    ServingEngine,
    check_mesh,
    decode_emitted_tokens,
)
from ..parallel.sharding import ServingMesh
from .mesh import init_distributed, run_ranks
from ..serving.slr_params import deployment_report
from ..serving.speculative import SpeculativeEngine
from ..serving.telemetry import start_metrics_server
from ..train import checkpoint

ENGINES = {"paged": PagedServingEngine, "batched": ServingEngine,
           "reference": ReferenceEngine, "speculative": SpeculativeEngine}


def serve_batch(engine, vocab: int, requests: int, max_new: int, seed: int,
                slo_ms: float | None = None, tiers=(None,), adapters=(None,),
                prompts: list[list[int]] | None = None) -> dict:
    """Drive one engine over a random trace (or over ``prompts``), requests
    spread round-robin over ``tiers`` and, on an AdapterBank engine, over
    ``adapters``; per-tier and per-adapter token counts ride in the stats.
    With the shared prefix cache on, every random prompt opens with the same
    two-page "system prompt"."""
    rng = np.random.RandomState(seed)
    if prompts is None:
        shared: list[int] = []
        if getattr(engine, "_prefix", None) is not None:
            shared = rng.randint(0, vocab, size=2 * engine.ecfg.block_size).tolist()
        prompts = [shared + rng.randint(0, vocab, size=rng.randint(2, 8)).tolist()
                   for _ in range(requests)]
    submitted = time.time()          # deadlines are a wall-clock contract
    for i, prompt in enumerate(prompts):
        engine.submit(prompt, max_new_tokens=max_new,
                      deadline=None if slo_ms is None else submitted + slo_ms / 1e3,
                      tier=tiers[i % len(tiers)], adapter=adapters[i % len(adapters)])
    t0 = time.monotonic()
    done = engine.run()
    dt = time.monotonic() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    snap = engine.stats_snapshot()
    stats = {
        "requests": len(done),
        "tokens": total_tokens,
        "tok_per_s": round(total_tokens / max(dt, 1e-9), 2),
        "sample": done[0].out_tokens if done else [],
        "steps": snap["steps"],
        "jit_retraces": snap["jit_retraces"],
    }
    by_tier: dict[int, int] = {}
    for r in done:
        by_tier[r.tier] = by_tier.get(r.tier, 0) + len(r.out_tokens)
    if len(by_tier) > 1 or (by_tier and next(iter(by_tier)) != 0):
        stats["tokens_by_tier"] = {str(k): v for k, v in sorted(by_tier.items())}
    by_adapter: dict[int, int] = {}
    for r in done:
        if r.adapter is not None:
            by_adapter[r.adapter] = by_adapter.get(r.adapter, 0) + len(r.out_tokens)
    if by_adapter:
        stats["tokens_by_adapter"] = {str(k): v for k, v in sorted(by_adapter.items())}
    # TTFT on the submitted_at basis; the percentiles are the registry's
    # histogram's when telemetry is on
    ttft = [r.first_token_at - r.submitted_at for r in done if r.first_token_at]
    tel = engine.metrics
    if tel.ttft.count(tel.engine):
        stats["ttft_p50_ms"] = round(tel.ttft.percentile(50, tel.engine) * 1e3, 1)
        stats["ttft_p99_ms"] = round(tel.ttft.percentile(99, tel.engine) * 1e3, 1)
    elif ttft:
        stats["ttft_p50_ms"] = round(float(np.percentile(ttft, 50)) * 1e3, 1)
        stats["ttft_p99_ms"] = round(float(np.percentile(ttft, 99)) * 1e3, 1)
    if slo_ms is not None and ttft:
        stats["slo_ms"] = slo_ms
        stats["slo_attainment"] = round(sum(t * 1e3 <= slo_ms for t in ttft) / len(ttft), 3)
    if hasattr(engine, "evictions"):
        stats["evictions"] = engine.evictions
    if getattr(engine, "_prefix", None) is not None:
        stats["prefix_cache"] = {
            "lookups": engine.prefix_lookups,
            "hits": engine.prefix_hits,
            "hit_tokens": engine.prefix_hit_tokens,
            "cow_copies": engine.cow_copies,
            "reattached_pages": engine.reattached_pages,
            "cached_pages": engine._prefix.pages,
        }
    if getattr(engine, "tier_controller", None) is not None:
        stats["downshift_ticks"] = engine.downshift_ticks
        stats["tier_switches"] = engine.tier_switches
    if hasattr(engine, "acceptance_rate"):
        stats["acceptance_rate"] = round(engine.acceptance_rate, 3)
        stats["tokens_per_step"] = round(
            decode_emitted_tokens(done) / max(engine.decode_calls, 1), 2)
    return stats


def serve_with_observability(engine, args, vocab: int, tiers=(None,),
                             adapters=(None,)) -> dict:
    """``serve_batch`` with the requested exports attached: a request tracer
    under ``--trace-out``/``--trace-events``, a live Prometheus endpoint
    under ``--metrics-port`` (``--metrics-out`` then scrapes it over HTTP, so
    the file is what the endpoint served)."""
    tracer = engine.start_trace() if args.trace_out or args.trace_events else None
    server = None
    if args.metrics_port is not None:
        server = start_metrics_server(engine.metrics.registry, port=args.metrics_port)
    try:
        stats = serve_batch(engine, vocab, args.requests, args.max_new, args.seed,
                            args.slo_ms, tiers=tiers, adapters=adapters)
        if server is not None:
            port = server.server_address[1]
            stats["metrics_port"] = port
            if args.metrics_out:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics") as resp:
                    text = resp.read().decode()
                with open(args.metrics_out, "w") as f:
                    f.write(text)
                stats["metrics_out"] = args.metrics_out
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
    if server is None and args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(engine.metrics.registry.prometheus_text())
        stats["metrics_out"] = args.metrics_out
    if tracer is not None:
        if args.trace_out:
            tracer.save_chrome(args.trace_out)
            stats["trace_out"] = args.trace_out
        if args.trace_events:
            tracer.save_jsonl(args.trace_events)
            stats["trace_events"] = args.trace_events
    return stats


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="engine capabilities (serving.elastic.Engine protocol):\n\n"
        + format_capability_table(ENGINES),
    )
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device for weights and KV (default: the card; 'cpu' "
                         "runs the kernels' plain versions)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the latest training checkpoint in this directory")
    ap.add_argument("--keep-ratios", default=None,
                    help="comma-separated HPA budgets materialized as ONE ModelBank's "
                         "tiers, largest first, e.g. 1.0,0.6,0.3 (omit: serve dense init)")
    ap.add_argument("--fmt", "--format", dest="fmt", default="factored",
                    choices=("dense", "factored", "bsr", "fused"),
                    help="deployment format: 'fused' runs one kernel per linear site "
                         "with layer-stacked tables, 'bsr' the low-rank and block-CSC "
                         "kernels per layer")
    ap.add_argument("--engine", default="paged", choices=tuple(ENGINES))
    ap.add_argument("--kappa", type=float, default=0.7)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV page size in tokens")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV page pool size; None = max_slots * max_len worth")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill in block-aligned chunks of this many tokens "
                         "(None = one-shot prefill)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prompt cache: share KV pages across requests with a "
                         "common prompt prefix; copy-on-write on first divergent write")
    ap.add_argument("--prefix-min-hit", type=int, default=1,
                    help="minimum matched pages before a prefix-cache hit is attached")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="TTFT SLO; reports attainment and sets request deadlines")
    ap.add_argument("--kv-dtype", default="float32", choices=("float32", "bfloat16", "int8"),
                    help="KV page dtype; int8 pages are quantized per (position, head)")
    ap.add_argument("--tier", type=int, default=None,
                    help="pin every request to this bank tier (default: round-robin)")
    ap.add_argument("--tier-policy", default="static", choices=("static", "pressure"),
                    help="pressure: downshift the serving tier under page pressure "
                         "before evicting")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="draft tokens per tick; > 0 implies --engine speculative "
                         "(which defaults to 4)")
    ap.add_argument("--spec-budget", type=float, default=0.4,
                    help="HPA keep of the speculative engine's draft tier")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="adapt the draft window k to the observed acceptance rate")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the run here (one track per "
                         "slot, one per program; open in Perfetto)")
    ap.add_argument("--trace-events", default=None,
                    help="write the structured JSONL event log here (the same events as "
                         "--trace-out, one dict per line)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the Prometheus text exposition on 127.0.0.1:PORT/metrics "
                         "during the run (0 = ephemeral; the bound port rides in the line)")
    ap.add_argument("--metrics-out", default=None,
                    help="write one Prometheus scrape to this file after the run (over "
                         "HTTP when --metrics-port is set)")
    ap.add_argument("--mesh", default=None,
                    help="tensor/data-parallel serving mesh, e.g. model=2 or "
                         "model=2,data=2: starts that many rank processes")
    ap.add_argument("--adapters", type=int, default=0,
                    help="multi-tenant mode: register N SLR adapters (HPA views at spread "
                         "budgets) over ONE shared base and serve them through one "
                         "AdapterBank engine, requests round-robin across tenants")
    ap.add_argument("--max-resident-adapters", type=int, default=None,
                    help="device adapter-pool rows; fewer than --adapters turns on LRU "
                         "swapping (None = all resident)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def _serve_rank(rank: int, argv: list[str]):
    """One rank of a ``--mesh`` run (``run_ranks``)."""
    main(argv)


def _join_mesh(args, argv, cfg, device) -> ServingMesh | None:
    """The ``--mesh`` run's grid on this rank: checks the spec, then starts
    the rank processes (returning None here: they serve) unless a group is
    initialised already or ``torchrun`` set one up."""
    sizes = check_mesh(args.mesh, cfg, [args.fmt])
    need = sizes["data"] * sizes["model"]
    if need > 1 and not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            run_ranks(_serve_rank, need, device, sys.argv[1:] if argv is None else argv)
            return None
        init_distributed(device)
    return ServingMesh.from_spec(args.mesh)


def attention_impl(cfg, device, kv_dtype: str, engine=PagedServingEngine) -> str:
    """The attention path the launcher serves ``cfg`` with: the CUDA kernels
    on the card under the paged engines when their kernels take the pages
    (the model's dtype, bf16 under f32, or int8 pages, which take the flash
    prefill and the dequantizing gather), the flash prefill under the
    slot-padded engine (its decode is a masked einsum whatever the path),
    else the config's."""
    if not (issubclass(engine, ServingEngine) and device.type == "cuda"):
        return cfg.kernel_impl
    if not issubclass(engine, PagedServingEngine):
        return "pallas"
    if kv_dtype == "int8" or takes_pages(cfg.param_dtype, getattr(torch, kv_dtype)):
        return "pallas"
    return cfg.kernel_impl


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    emit = print
    if args.mesh is not None:
        smesh = _join_mesh(args, argv, cfg, device)
        if smesh is None or not smesh.member:
            return
        if smesh.rank != 0:
            # rank 0 reports; the others serve the same requests silently
            emit = _silent
            args.trace_out = args.trace_events = args.metrics_out = None
            args.metrics_port = None
        emit(json.dumps({"note": f"serving mesh {args.mesh}", "mesh": smesh.describe(),
                         "collectives": smesh.collectives}))
    engine_cls = ENGINES[args.engine]
    spec_k = args.spec_k
    if engine_cls is SpeculativeEngine and spec_k == 0:
        spec_k = 4
    if spec_k > 0 and engine_cls is PagedServingEngine:
        engine_cls = SpeculativeEngine            # --spec-k implies speculation
    if engine_cls is not ReferenceEngine and cfg.family not in BATCHED_FAMILIES:
        # the capability line a constructor-time error would carry; features
        # the reference engine lacks then fail loudly in its constructor
        emit(json.dumps({
            "note": f"family {cfg.family!r} has no per-slot-length cache yet; falling "
                    "back to the reference engine",
            "capabilities": ReferenceEngine.capabilities(),
        }))
        engine_cls = ReferenceEngine
    cfg = dataclasses.replace(cfg, kernel_impl=attention_impl(cfg, device, args.kv_dtype,
                                                              engine_cls))
    params = model_lib.init_params(cfg, seed=args.seed, device=device)
    scfg = SalaadConfig(selection=SelectionConfig(min_dim=16))
    slr, blocks = init_slr_state(params, scfg)
    if args.ckpt_dir:
        # serving reads only these two parts of the saved TrainState
        restored = checkpoint.restore(args.ckpt_dir, {"params": params, "slr": slr})
        params, slr = restored["params"], restored["slr"]
    ecfg = EngineConfig(
        max_slots=args.max_slots, max_len=args.max_len, block_size=args.block_size,
        num_blocks=args.num_blocks, kv_dtype=args.kv_dtype,
        prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
        prefix_min_hit_pages=args.prefix_min_hit, tier_policy=args.tier_policy,
        spec_k=spec_k, spec_adaptive=args.spec_adaptive,
        adapters=args.adapters > 0, max_resident_adapters=args.max_resident_adapters,
        mesh=args.mesh,
    )

    if args.adapters:
        # N tenants as HPA views at spread budgets over ONE shared base, each
        # adapterized onto it: only the SLR sites differ per tenant
        slr_c, _ = hpa_keep_ratio(slr, blocks, 1.0, args.kappa)
        base = DeployedModel.build(cfg, params, slr_c, blocks, fmt=args.fmt)
        tenants = []
        for keep in np.linspace(1.0, 0.4, args.adapters):
            slr_k, _ = hpa_keep_ratio(slr, blocks, float(keep), args.kappa)
            tenants.append(adapterize(base, DeployedModel.build(cfg, params, slr_k, blocks,
                                                                fmt=args.fmt)))
        bank = AdapterBank(base, tenants, names=[f"tenant{i}" for i in range(args.adapters)])
        engine = engine_cls(bank, ecfg)
        stats = serve_with_observability(engine, args, cfg.vocab_size,
                                         adapters=tuple(range(args.adapters)))
        emit(json.dumps({"fmt": args.fmt, "adapters": bank.adapter_report(), **stats}))
        return

    if args.keep_ratios is None:
        engine = engine_cls(ModelBank.single(cfg, params), ecfg)
        stats = serve_with_observability(engine, args, cfg.vocab_size)
        emit(json.dumps({"budget": None, "fmt": "dense-init", **stats}))
        return

    keeps = sorted({float(k) for k in args.keep_ratios.split(",")}, reverse=True)
    if engine_cls is SpeculativeEngine:
        # ONE target tier verifies, the --spec-budget tier drafts
        target_keep = keeps[0]
        draft_keep = min(args.spec_budget, target_keep)
        dropped = [k for k in keeps[1:] if k != draft_keep]
        if dropped:
            emit(json.dumps({
                "note": "speculative mode serves ONE target tier: "
                        f"keep={target_keep} verifies, keep={draft_keep} (--spec-budget) "
                        f"drafts; --keep-ratios {dropped} not materialized",
            }))
        keeps = [target_keep] + ([draft_keep] if draft_keep < target_keep else [])
        ecfg.spec_draft_tier = -1                 # the cheapest tier drafts

    # ONE HPA truncation + deployment per budget: the bank serves these views
    # and the same pass yields the per-tier accounting
    models, tier_rows = [], []
    for keep in keeps:
        slr_c, rep = hpa_keep_ratio(slr, blocks, keep, args.kappa)
        models.append(DeployedModel.build(cfg, params, slr_c, blocks, fmt=args.fmt))
        dep = deployment_report(params, slr_c, blocks)
        tier_rows.append({
            "slr_params": rep["params_after"],
            "slr_total_bytes": dep["slr_total_bytes"],
            "compression": round(dep["compression"], 3),
        })
    bank = ModelBank(cfg, models, keeps=keeps)
    for tier, row in zip(bank, tier_rows):
        row.update(tier=tier.index, name=tier.name, served_bytes=tier.param_bytes)

    engine = engine_cls(bank, ecfg)
    tiers: tuple = (args.tier,)
    if args.tier is None:
        # the speculative engine pins every slot to its target tier
        tiers = (None,) if engine_cls is SpeculativeEngine else tuple(range(len(bank)))
    stats = serve_with_observability(engine, args, cfg.vocab_size, tiers=tiers)
    emit(json.dumps({
        "fmt": args.fmt,
        "bank": bank.report(),
        "tier_policy": args.tier_policy,
        **stats,
        "tiers": tier_rows,
    }))


def _silent(*_args, **_kw):
    pass


if __name__ == "__main__":
    main()
