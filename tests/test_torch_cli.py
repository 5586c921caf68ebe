"""``python -m repro_torch.launch.serve`` against ``python -m
repro.launch.serve`` at ``--reduced``: the same JSON keys and the same
request, token, tier, adapter, prefix-cache and byte counts (and
``jit_retraces``: 0 on both sides), through the paged, batched, speculative
and reference engines, for the dense Llama, the hybrid, and one architecture
of each other family (the ssm, hybrid and encdec lines follow the JAX
launcher's fallback note). The observability switches write
files both packages' validators accept. Both launchers serve a fresh all-zero SLR
state, so every SLR site takes the zero corner and the streams agree exactly;
only the timings differ.

``python -m repro_torch.launch.train`` writes checkpoints that the serve
launcher's ``--ckpt-dir`` serves, and a checkpoint the JAX package's trainer
wrote serves through both launchers with the same line.
"""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro_torch.configs import get_arch
from repro_torch.launch import serve, train

TIMED = {"tok_per_s", "ttft_p50_ms", "ttft_p99_ms", "slo_attainment"}
BOUND = {"metrics_port"}     # an ephemeral port: each run binds its own

FLAG_SETS = {
    "fused_prefix_pressure": ["--keep-ratios", "1.0,0.6,0.3", "--fmt", "fused",
                              "--prefix-cache", "--tier-policy", "pressure",
                              "--requests", "5"],
    "bsr_chunked_pinned": ["--keep-ratios", "1.0,0.5", "--fmt", "bsr",
                           "--prefill-chunk", "16", "--tier", "1", "--slo-ms", "60000",
                           "--kv-dtype", "bfloat16", "--requests", "3", "--max-new", "5"],
    "adapters_lru": ["--adapters", "3", "--max-resident-adapters", "2", "--fmt", "fused",
                     "--requests", "5"],
    "adapters_factored_prefix": ["--adapters", "2", "--fmt", "factored", "--prefix-cache",
                                 "--requests", "4", "--max-new", "4"],
    "reference_engine": ["--engine", "reference", "--keep-ratios", "1.0,0.6", "--fmt", "fused",
                         "--requests", "3", "--max-new", "4"],
}


def run_cli(main, argv, monkeypatch, capsys) -> dict:
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("flags", list(FLAG_SETS), ids=list(FLAG_SETS))
def test_cli_matches_jax(flags, monkeypatch, capsys):
    argv = ["--arch", "salaad_llama_60m", "--reduced", *FLAG_SETS[flags]]
    got = run_cli(serve.main, argv + ["--device", "cpu"], monkeypatch, capsys)
    want = run_cli(jax_serve.main, argv, monkeypatch, capsys)
    assert set(got) == set(want)
    for key in set(got) - TIMED:
        assert got[key] == want[key], key
    n = int(argv[argv.index("--requests") + 1])
    assert got["requests"] == n and got["tokens"] > 0
    if "--adapters" in argv:
        tenants = int(argv[argv.index("--adapters") + 1])
        assert got["adapters"]["registered"] == tenants
        assert set(got["tokens_by_adapter"]) == {str(a) for a in range(tenants)}
        assert sum(got["tokens_by_adapter"].values()) == got["tokens"]


MOE_MESH = ["--arch", "qwen3_moe_30b_a3b", "--reduced", "--device", "cpu", "--fmt", "factored",
            "--keep-ratios", "1.0,0.5", "--requests", "3", "--max-new", "4"]


def test_moe_serves_under_a_mesh(monkeypatch, capsys):
    """``--mesh model=2`` serves the MoE expert-parallel: the launcher
    starts two rank processes, rank 0 prints the note line and then the
    unsharded run's line (the same requests, tokens, sample and tiers)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(__file__), "..", "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *MOE_MESH,
                           "--mesh", "model=2"], capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    note, got = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert note["mesh"]["shape"] == {"data": 1, "model": 2}
    want = run_cli(serve.main, MOE_MESH, monkeypatch, capsys)
    assert set(got) == set(want)
    for key in ("requests", "tokens", "sample", "jit_retraces", "tiers"):
        assert got[key] == want[key], key


PORTED_SWITCHES = {
    "engine_speculative": ["--engine", "speculative", "--keep-ratios", "1.0,0.6,0.3",
                           "--spec-budget", "0.3"],
    "spec_k_adaptive": ["--spec-k", "2", "--keep-ratios", "1.0,0.5", "--spec-budget", "0.5",
                        "--spec-adaptive", "--prefill-chunk", "16"],
    "kv_int8": ["--kv-dtype", "int8", "--keep-ratios", "1.0,0.6", "--prefix-cache"],
    "engine_batched": ["--engine", "batched", "--keep-ratios", "1.0,0.6,0.3"],
    "trace_out": ["--engine", "batched", "--keep-ratios", "1.0,0.6", "--trace-out",
                  "{tmp}/t.json", "--trace-events", "{tmp}/e.jsonl"],
    "metrics_port": ["--keep-ratios", "1.0,0.6", "--prefix-cache", "--metrics-port", "0",
                     "--metrics-out", "{tmp}/m.txt"],
}


@pytest.mark.parametrize("flags", list(PORTED_SWITCHES), ids=list(PORTED_SWITCHES))
def test_speculative_and_int8_switches_match_jax(flags, monkeypatch, capsys, tmp_path):
    """``--engine speculative``, ``--spec-k`` (which implies it),
    ``--kv-dtype int8``, ``--engine batched`` and the observability switches
    (``--trace-out``/``--trace-events`` on the batched engine,
    ``--metrics-port``/``--metrics-out`` on the paged one) serve at the
    reduced size and print the JAX launcher's lines: the note on the
    keep-ratios a speculative run does not build, then the same keys and the
    same counts, greedy sample, ``jit_retraces`` and ``acceptance_rate``. The
    port's trace, event log and scrape pass both packages' validators."""
    from repro.serving.telemetry import validate_prometheus_text as jax_validate_prom
    from repro.serving.trace import validate_chrome_trace as jax_validate_trace
    from repro_torch.serving.telemetry import validate_prometheus_text
    from repro_torch.serving.trace import validate_chrome_trace

    flags_ = [f.format(tmp=tmp_path) for f in PORTED_SWITCHES[flags]]
    argv = ["--arch", "salaad_llama_60m", "--reduced", "--fmt", "fused", "--requests", "4",
            "--max-new", "6", *flags_]
    got = run_lines(serve.main, argv + ["--device", "cpu"], monkeypatch, capsys)
    if flags == "trace_out":
        doc = json.loads((tmp_path / "t.json").read_text())
        assert validate_chrome_trace(doc) == jax_validate_trace(doc)
        events = [json.loads(x) for x in (tmp_path / "e.jsonl").read_text().splitlines()]
        assert {e["kind"] for e in events} == {"span", "instant", "program"}
    if flags == "metrics_port":
        text = (tmp_path / "m.txt").read_text()
        assert validate_prometheus_text(text) == jax_validate_prom(text)
        assert 'serve_tokens_total{engine="PagedServingEngine",kind="emitted"} 24' in text
    want = run_lines(jax_serve.main, argv, monkeypatch, capsys)
    assert len(got) == len(want) == (2 if flags == "engine_speculative" else 1)
    assert got[:-1] == want[:-1]
    got, want = got[-1], want[-1]
    assert set(got) == set(want)
    for key in set(got) - TIMED - BOUND:
        assert got[key] == want[key], key
    assert got["requests"] == 4 and got["tokens"] == 24
    if "speculative" in flags or "spec_k" in flags:
        assert 0.0 <= got["acceptance_rate"] <= 1.0 and got["tokens_per_step"] >= 1.0
    else:
        assert "acceptance_rate" not in got


def run_lines(main, argv, monkeypatch, capsys) -> list[dict]:
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    main()
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


@pytest.mark.parametrize("engine", [[], ["--engine", "reference"]], ids=["paged", "reference"])
def test_hybrid_serves_through_the_reference_engine(engine, monkeypatch, capsys):
    """The hybrid has no per-slot-length cache: asked for the paged engine,
    both launchers print the fallback note and serve on ReferenceEngine;
    asked for it, they serve without a note. The served line equals JAX's
    (less the timings); the note's capabilities name
    the families each package serves."""
    argv = ["--arch", "zamba2_2p7b", "--reduced", "--keep-ratios", "1.0,0.5", "--fmt",
            "fused", "--requests", "3", "--max-new", "4", *engine]
    got = run_lines(serve.main, argv + ["--device", "cpu"], monkeypatch, capsys)
    want = run_lines(jax_serve.main, argv, monkeypatch, capsys)
    assert len(got) == len(want) == (2 if not engine else 1)
    if not engine:
        assert got[0]["note"] == want[0]["note"]
        assert got[0]["capabilities"]["engine"] == "ReferenceEngine"
        assert got[0]["capabilities"] == want[0]["capabilities"]
    assert set(got[-1]) == set(want[-1])
    for key in set(got[-1]) - TIMED:
        assert got[-1][key] == want[-1][key], key
    assert got[-1]["requests"] == 3 and got[-1]["tokens"] == 12


NEW_FAMILIES = {
    "qwen3_moe_30b_a3b": ["--fmt", "fused", "--prefix-cache"],
    "internvl2_76b": ["--fmt", "fused", "--engine", "batched"],
    "gemma_7b": ["--fmt", "fused"],
    "mamba2_370m": ["--fmt", "fused"],
    "whisper_small": ["--fmt", "bsr"],
}


@pytest.mark.parametrize("arch", list(NEW_FAMILIES))
def test_new_families_serve_like_jax(arch, monkeypatch, capsys):
    """One architecture of each family the launchers gained (moe, vlm, a
    dense variant, ssm, encdec), reduced on the CPU, in its first serving
    format: the same lines as the JAX launcher, the ssm and encdec ones
    after the same fallback note to ReferenceEngine. Every SLR site of the
    fresh all-zero state serves zeros, so the streams agree where only those
    sites and the deterministic norms reach the head; the encoder-decoder's
    sinusoidal positions reach its LM head, which is no SLR block and is
    drawn by each package's own generator, so its greedy sample differs."""
    argv = ["--arch", arch, "--reduced", "--keep-ratios", "1.0,0.5", "--requests", "3",
            "--max-new", "4", *NEW_FAMILIES[arch]]
    got = run_lines(serve.main, argv + ["--device", "cpu"], monkeypatch, capsys)
    want = run_lines(jax_serve.main, argv, monkeypatch, capsys)
    fallback = get_arch(arch).family in ("ssm", "encdec")
    assert len(got) == len(want) == (2 if fallback else 1)
    assert got[:-1] == want[:-1]
    if fallback:
        assert got[0]["note"].startswith(f"family '{get_arch(arch).family}' has no per-slot")
    assert set(got[-1]) == set(want[-1])
    own_head = {"sample"} if arch == "whisper_small" else set()
    for key in set(got[-1]) - TIMED - own_head:
        assert got[-1][key] == want[-1][key], key
    assert got[-1]["requests"] == 3 and got[-1]["tokens"] == 12


def test_hybrid_paged_features_raise_in_the_reference_engine():
    from repro_torch.serving.engine import EngineCapabilityError

    with pytest.raises(EngineCapabilityError, match="prefix_cache"):
        serve.main(["--arch", "zamba2_2p7b", "--reduced", "--device", "cpu", "--fmt", "fused",
                    "--prefix-cache"])


TRAIN = ["--arch", "salaad_llama_60m", "--reduced", "--steps", "10", "--update-every", "5",
         "--ckpt-every", "10", "--seq-len", "16", "--batch", "4"]
SERVE = ["--arch", "salaad_llama_60m", "--reduced", "--keep-ratios", "1.0,0.6", "--fmt",
         "fused", "--requests", "4", "--max-new", "4"]


def test_train_then_serve_checkpoint(tmp_path, monkeypatch, capsys):
    """Ten reduced steps (two ADMM phases) on the CPU write a checkpoint at
    step 10; the serve launcher serves its parameters and SLR state."""
    ckpt = str(tmp_path)
    train.main(TRAIN + ["--device", "cpu", "--ckpt-dir", ckpt])
    out = json.loads(capsys.readouterr().out)
    assert [m["step"] for m in out["metrics"] if "admm_recon_err" in m] == [4, 9]
    assert sorted(os.listdir(ckpt)) == ["manifest.json", "step_0000000010"]
    got = run_cli(serve.main, SERVE + ["--device", "cpu", "--ckpt-dir", ckpt], monkeypatch,
                  capsys)
    assert got["requests"] == 4 and got["tokens"] == 16
    assert all(t["slr_params"] > 0 for t in got["tiers"])
    assert got["tiers"][1]["slr_params"] < got["tiers"][0]["slr_params"]


def test_serve_jax_checkpoint_matches_jax(tmp_path, monkeypatch, capsys):
    """The JAX package's trainer writes the checkpoint; both serve launchers
    serve it with the same keys and the same counts, bytes and greedy
    sample."""
    ckpt = str(tmp_path)
    monkeypatch.setattr(sys, "argv", ["train", *TRAIN, "--ckpt-dir", ckpt])
    jax_train.main()
    capsys.readouterr()
    argv = SERVE + ["--ckpt-dir", ckpt]
    got = run_cli(serve.main, argv + ["--device", "cpu"], monkeypatch, capsys)
    want = run_cli(jax_serve.main, argv, monkeypatch, capsys)
    assert set(got) == set(want)
    for key in set(got) - TIMED:
        assert got[key] == want[key], key
    assert got["tiers"][0]["slr_params"] > 0


def test_attention_impl_on_card_needs_model_dtype_pages():
    """On the card the paged engines take the CUDA attention kernels for KV
    pages the paged kernels read (the model's dtype, bf16 under the f32
    model) and for int8 pages (flash prefill, the dequantizing gather); the
    slot-padded engine takes the flash prefill whatever its cache's dtype;
    f32 pages under a bf16 model, the reference engine and the CPU keep the
    config's attention path."""
    import dataclasses

    from repro_torch.serving.engine import ReferenceEngine, ServingEngine
    from repro_torch.serving.speculative import SpeculativeEngine

    cfg = get_arch("salaad_llama_60m")
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert cfg.param_dtype == torch.float32 and cfg.kernel_impl != "pallas"
    for kv in ("float32", "bfloat16", "int8"):
        assert serve.attention_impl(cfg, card, kv) == "pallas"
        assert serve.attention_impl(cfg, card, kv, SpeculativeEngine) == "pallas"
        assert serve.attention_impl(cfg, card, kv, ReferenceEngine) == cfg.kernel_impl
    for kv in ("float32", "bfloat16"):
        assert serve.attention_impl(cfg, card, kv, ServingEngine) == "pallas"
        assert serve.attention_impl(cfg, cpu, kv, ServingEngine) == cfg.kernel_impl
    assert serve.attention_impl(cfg, cpu, "float32") == cfg.kernel_impl
    bf16 = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    assert serve.attention_impl(bf16, card, "float32") == cfg.kernel_impl
    assert serve.attention_impl(bf16, card, "float32", ServingEngine) == "pallas"


def test_train_launcher_distributed_joins_env_group(monkeypatch, capsys):
    """``--distributed`` joins the group ``torchrun``'s variables describe
    (``env://``; here a group of one rank on a port the system picks) and
    trains data-parallel over it: the one-process run's line."""
    argv = ["--arch", "salaad_llama_60m", "--reduced", "--device", "cpu", "--steps", "2",
            "--update-every", "2", "--seq-len", "16", "--batch", "2"]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, val in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                     "LOCAL_WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                     "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(key, val)
    try:
        train.main(argv + ["--distributed"])
        assert torch.distributed.is_initialized() and torch.distributed.get_world_size() == 1
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    got = json.loads(capsys.readouterr().out)
    train.main(argv)
    want = json.loads(capsys.readouterr().out)
    assert [{k: v for k, v in m.items() if k != "sec"} for m in got["metrics"]] == \
        [{k: v for k, v in m.items() if k != "sec"} for m in want["metrics"]]
