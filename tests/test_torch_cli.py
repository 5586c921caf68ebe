"""``python -m repro_torch.launch.serve`` against ``python -m
repro.launch.serve`` at ``--reduced``: the same JSON keys (less the JAX
launcher's ``jit_retraces``) and the same request, token, tier, adapter,
prefix-cache and byte counts. Both launchers serve a fresh all-zero SLR
state, so every SLR site takes the zero corner and the streams agree exactly;
only the timings differ.
"""
import json
import sys

import pytest

from repro.launch import serve as jax_serve
from repro_torch.launch import serve

TIMED = {"tok_per_s", "ttft_p50_ms", "ttft_p99_ms", "slo_attainment"}

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
    assert set(got) == set(want) - {"jit_retraces"}
    for key in set(got) - TIMED:
        assert got[key] == want[key], key
    n = int(argv[argv.index("--requests") + 1])
    assert got["requests"] == n and got["tokens"] > 0
    if "--adapters" in argv:
        tenants = int(argv[argv.index("--adapters") + 1])
        assert got["adapters"]["registered"] == tenants
        assert set(got["tokens_by_adapter"]) == {str(a) for a in range(tenants)}
        assert sum(got["tokens_by_adapter"].values()) == got["tokens"]


@pytest.mark.parametrize("flag", [["--ckpt-dir", "ckpt"], ["--engine", "speculative"],
                                  ["--spec-k", "2"], ["--mesh", "model=2"],
                                  ["--kv-dtype", "int8"], ["--trace-out", "t.json"],
                                  ["--metrics-port", "0"]])
def test_later_slice_switches_raise(flag):
    with pytest.raises(ValueError, match="not ported yet"):
        serve.main(["--arch", "salaad_llama_60m", "--reduced", "--device", "cpu", *flag])
