"""Tensor- and data-parallel serving in the port against the JAX package's
unsharded engines, on four gloo ranks on the CPU.

The JAX side (this process) builds the widened fixture of the JAX package's
``tests/test_sharded_serving.py`` (the reduced Llama-60m with 4 query over 4
KV heads, and a GQA variant with 4 over 2), its SLR state from exact-SVD ADMM
sweeps (two, and one for the variant) and two-tier factored banks, and drives its unsharded engines over
every entry of ``PARITY_CONFIGS``. The port's ranks (``launch/mesh.py::
RankPool``, started once for the file, one torch thread each) get the same
weights through ``repro_torch.bridge`` and serve them at ``model=2``,
``model=4``, ``data=2`` and ``model=2,data=2`` while the JAX side runs; the
tests then read what both sides recorded.

Tolerances: the streams must be equal token for token; logits within
``atol=rtol=2e-5`` (the row-parallel all-reduce sums in another order, as
the JAX package's psums do).

The functions the ranks run live at module level and import no JAX: a
spawned rank imports this module by name.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = [[1, 2, 3, 4], [5, 6, 7], [2, 4, 6, 8, 10], [1, 2, 3, 9]]
PARITY_CONFIGS = {     # the JAX package's, tests/test_sharded_serving.py:124-131
    "paged": {},
    "int8_kv": dict(kv_dtype="int8"),
    "chunked_prefill": dict(prefill_chunk=8),
    "prefix_cache": dict(prefix_cache=True),
    "pressure_tiers": dict(tier_policy="pressure", num_blocks=10),
    "speculative": dict(spec_k=3),
}
MESHES = ("model=2", "model=4", "data=2", "model=2,data=2")
LOGIT_TOKENS = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
TOL = dict(atol=2e-5, rtol=2e-5)
LAUNCH = ["--arch", "salaad_llama_60m", "--reduced", "--device", "cpu",
          "--keep-ratios", "1.0,0.5", "--requests", "3", "--max-new", "4"]


def drive(engine, tiers=True, max_new=6):
    """Submit the fixed prompt set (alternating tiers) and run to drain."""
    for i, p in enumerate(PROMPTS):
        engine.submit(p, max_new_tokens=max_new, tier=(i % 2) if tiers else None)
    done = engine.run()
    return {tuple(r.prompt): r.out_tokens for r in done}


def export(params, state) -> dict:
    """JAX params and SLR state as numpy, in plain containers a rank can
    unpickle without JAX."""
    def coo(c):
        return SimpleNamespace(values=np.asarray(c.values), idx=np.asarray(c.idx),
                               shape=tuple(c.shape))

    def tree(t):
        return {k: tree(v) for k, v in t.items()} if isinstance(t, dict) else np.asarray(t)

    return {"params": tree(params), "state": {
        name: SimpleNamespace(p=np.asarray(b.p), vt=np.asarray(b.vt),
                              s_vals=np.asarray(b.s_vals), s_coo=coo(b.s_coo),
                              y=np.asarray(b.y), z=np.asarray(b.z),
                              alpha=np.asarray(b.alpha), beta=np.asarray(b.beta),
                              rho=float(b.rho))
        for name, b in state.items()}}


# ------------------------------------------------------------ rank side ---


def _port_bank(kv_heads: int, weights: dict, fmt="factored", budgets=(1.0, 0.5), **replace):
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    from repro_torch.core.admm import SalaadConfig, init_slr_state
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.serving.elastic import ModelBank

    cfg = dataclasses.replace(get_arch("salaad_llama_60m").reduced(), num_heads=4,
                              num_kv_heads=kv_heads, **replace)
    params = bridge.params_from_numpy(weights["params"], "cpu")
    _, blocks = init_slr_state(params, SalaadConfig(selection=SelectionConfig(min_dim=16),
                                                    exact_svd=True))
    state = bridge.slr_state_from_numpy(weights["state"], "cpu")
    assert sorted(state) == sorted(b.name for b in blocks)
    return ModelBank.build(cfg, params, state, blocks, budgets=budgets, fmt=fmt, bsr_block=32)


def _ecfg(**kw):
    from repro_torch.serving.engine import EngineConfig

    return EngineConfig(max_slots=4, max_len=32, block_size=8, **kw)


def _mesh(spec: str):
    from repro_torch.parallel.sharding import ServingMesh

    return ServingMesh.from_spec(spec)


def _serve(bank, cls, spec, tiers=True, **kw):
    """Streams and plan rebuilds of one drive on this rank (None off the
    grid: the rank only takes part in making the mesh's groups)."""
    if spec is not None and not _mesh(spec).member:
        return None
    eng = cls(bank, _ecfg(mesh=spec, **kw))
    return {"streams": drive(eng, tiers), "retraces": eng.stats_snapshot()["jit_retraces"]}


def _rank_serve_all(rank, weights, gqa_weights):
    """Everything the tests read from the ranks, in one task."""
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import (
        EngineCapabilityError,
        EngineConfig,
        PagedServingEngine,
        ReferenceEngine,
        ServingEngine,
        _kv_pool_device_bytes,
    )
    from repro_torch.serving.elastic import shared_base_bytes
    from repro_torch.serving.speculative import SpeculativeEngine
    from repro_torch.serving.telemetry import engine_provenance

    bank = _port_bank(4, weights)
    out = {"parity": {}, "pallas": {}, "slot_padded": {}, "logits": {}}
    for name, kw in PARITY_CONFIGS.items():
        cls = SpeculativeEngine if name == "speculative" else PagedServingEngine
        for spec in MESHES:
            out["parity"][name, spec] = _serve(bank, cls, spec, name != "speculative", **kw)
    pallas = _port_bank(4, weights, kernel_impl="pallas")
    for spec in ("model=2", "model=4"):
        for kw in ({}, dict(prefill_chunk=8)):
            out["pallas"][spec, bool(kw)] = _serve(pallas, PagedServingEngine, spec, **kw)
    for spec in ("model=2", "model=2,data=2"):
        out["slot_padded"][spec] = None
        if _mesh(spec).member:
            eng = ServingEngine(bank, EngineConfig(max_slots=4, max_len=32, mesh=spec))
            out["slot_padded"][spec] = {"streams": drive(eng),
                                        "retraces": eng.stats_snapshot()["jit_retraces"]}
    gqa = _port_bank(2, gqa_weights)
    out["gqa"] = _serve(gqa, PagedServingEngine, "model=2")
    try:
        PagedServingEngine(gqa, _ecfg(mesh="model=4"))
    except ValueError as e:
        out["gqa_model4"] = str(e)

    # logits of the whole forward under each placement
    cfg = bank.cfg
    tier0 = next(iter(bank)).params
    for spec in ("model=2", "model=4", "model=2,data=2"):
        mesh = _mesh(spec)
        if not mesh.member:
            continue
        with mesh:
            logits = model_lib._forward(mesh.local_tree(tier0),
                                        {"tokens": torch.from_numpy(LOGIT_TOKENS)},
                                        mesh.local_cfg(cfg))[0]
        out["logits"][spec] = logits.numpy()

    # pools, tables, bytes and the tiers' shared pieces
    out["pools"] = {}
    flat = PagedServingEngine(bank, _ecfg())
    for spec in ("model=2", "model=4", "data=2"):
        if not _mesh(spec).member:
            continue
        eng = PagedServingEngine(bank, _ecfg(mesh=spec))
        before = eng.cache.block_table.clone()
        drive(eng)
        out["pools"][spec] = {
            "k": tuple(eng.cache.k.shape), "scales": eng.cache.k_scale,
            "table": tuple(eng.cache.block_table.shape), "table0": before.numpy(),
            "table_after": eng.cache.block_table.numpy(),
            "specs": eng.mesh.cache_shardings(flat.cache),
            "bytes": _kv_pool_device_bytes(eng.cache, eng.mesh),
            "shared": shared_base_bytes(eng._tier_params),
            "same_norm": all(t["final_norm"]["norm_scale"] is eng._tier_params[0]["final_norm"]
                             ["norm_scale"] for t in eng._tier_params),
        }
    out["flat_k"] = tuple(flat.cache.k.shape)
    out["bank_shared"] = bank.shared_base_bytes()

    def hits_and_free(spec):
        eng = PagedServingEngine(bank, _ecfg(mesh=spec, prefix_cache=True))
        shared = list(range(1, 17))     # two full pages at block_size=8
        for _ in range(2):              # the second round re-walks the published prefix
            eng.submit(shared + [21], max_new_tokens=4, tier=0)
            eng.submit(shared + [22], max_new_tokens=4, tier=0)
            eng.run()
        return eng.prefix_hits, eng.allocator.free_blocks

    out["hits"] = {spec: hits_and_free(spec) for spec in (None, "model=2,data=2")}
    prov = engine_provenance(PagedServingEngine(bank, _ecfg(mesh="model=2,data=2")))
    out["provenance"] = (prov["mesh"], prov["telemetry"]["serve_kv_pool_device_bytes"])
    out["flat_provenance"] = engine_provenance(flat)["mesh"]

    # validation inside a group of four
    errors = {}
    for name, build in {
        "model=8": lambda: PagedServingEngine(bank, _ecfg(mesh="model=8")),
        "model=4,data=4": lambda: PagedServingEngine(bank, _ecfg(mesh="model=4,data=4")),
        "reference": lambda: ReferenceEngine(bank, EngineConfig(max_slots=1,
                                                                mesh="model=2")),
        "bsr": lambda: PagedServingEngine(_port_bank(4, weights, "bsr", (1.0,)),
                                          _ecfg(mesh="model=2")),
    }.items():
        try:
            build()
        except (ValueError, EngineCapabilityError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    out["errors"] = errors

    # the launcher inside the group: ranks 0 and 1 serve, 2 and 3 stay out
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main([*LAUNCH, "--mesh", "model=2"])
    out["launcher"] = buf.getvalue().splitlines()
    return out


# ------------------------------------------------------------- JAX side ---


def _jax_fixture(kv_heads: int, steps: int):
    import jax

    from repro.configs.base import get_arch
    from repro.core.admm import SalaadConfig, admm_update, init_slr_state
    from repro.core.selection import SelectionConfig
    from repro.models import model as model_lib
    from repro.serving.elastic import ModelBank

    cfg = dataclasses.replace(get_arch("salaad_llama_60m").reduced(), num_heads=4,
                              num_kv_heads=kv_heads)
    params = model_lib.init_params(cfg, jax.random.PRNGKey(0))
    scfg = SalaadConfig(selection=SelectionConfig(min_dim=16), rho_constant=5.0,
                        exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    sweep = jax.jit(lambda p, s, step: admm_update(p, s, blocks, scfg, step))
    for step in range(steps):
        state, _ = sweep(params, state, step)
    bank = ModelBank.build(cfg, params, state, blocks, budgets=(1.0, 0.5), fmt="factored")
    return bank, export(params, state)


@pytest.fixture(scope="module")
def runs():
    from repro.serving.engine import EngineConfig as JaxEngineConfig
    from repro.serving.engine import PagedServingEngine as JaxPaged
    from repro.serving.engine import ServingEngine as JaxServingEngine
    from repro.serving.speculative import SpeculativeEngine as JaxSpeculative
    from repro_torch.launch.mesh import RankPool

    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    spawned = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH[:-4],
                                "--requests", "1", "--max-new", "2", "--mesh", "model=2"],
                               cwd=ROOT, env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    pool = RankPool(4, "cpu", threads=1)
    try:
        jbank, weights = _jax_fixture(4, 2)
        gbank, gqa_weights = _jax_fixture(2, 1)
        pool.submit(_rank_serve_all, weights, gqa_weights)

        def jecfg(**kw):
            return JaxEngineConfig(max_slots=4, max_len=32, block_size=8, **kw)

        jax_streams = {}
        for name, kw in PARITY_CONFIGS.items():
            cls = JaxSpeculative if name == "speculative" else JaxPaged
            jax_streams[name] = drive(cls(jbank, jecfg(**kw)), name != "speculative")
        jax_slot = drive(JaxServingEngine(jbank, JaxEngineConfig(max_slots=4, max_len=32)))
        jax_gqa = drive(JaxPaged(gbank, jecfg()))
        jax_logits = np.asarray(next(iter(jbank)).model.forward(LOGIT_TOKENS))
        ranks = pool.collect(timeout=300)
    finally:
        pool.close()
    out, err = spawned.communicate(timeout=300)
    return SimpleNamespace(jax=jax_streams, jax_slot=jax_slot, jax_gqa=jax_gqa,
                           jax_logits=jax_logits, ranks=ranks,
                           spawned=(spawned.returncode, out, err))


def members(runs, section, key):
    """The records of the ranks inside the key's grid (the others hold None)."""
    got = [r[section][key] for r in runs.ranks if r[section][key] is not None]
    assert got, (section, key)
    return got


# ------------------------------------------------------------------ tests ---


@pytest.mark.parametrize("name", sorted(PARITY_CONFIGS))
def test_greedy_streams_match_jax(runs, name):
    """Every rank of every mesh streams the JAX package's unsharded tokens,
    with no launch plan rebuilt."""
    for spec in MESHES:
        for rec in members(runs, "parity", (name, spec)):
            assert rec["streams"] == runs.jax[name], (name, spec)
            assert rec["retraces"] == 0, (name, spec)


def test_member_ranks_per_mesh(runs):
    """model=2 and data=2 use ranks 0-1 of the four; the 4-rank meshes all."""
    for spec, n in zip(MESHES, (2, 4, 2, 4)):
        assert len(members(runs, "parity", ("paged", spec))) == n, spec


def test_paged_kernel_dispatch_paths(runs):
    """``kernel_impl='pallas'`` routes decode and chunks through the paged
    kernels' wrappers (their plain versions on the CPU) on each head shard."""
    for (spec, chunked), _ in runs.ranks[0]["pallas"].items():
        want = runs.jax["chunked_prefill" if chunked else "paged"]
        for rec in members(runs, "pallas", (spec, chunked)):
            assert rec["streams"] == want and rec["retraces"] == 0, (spec, chunked)


@pytest.mark.parametrize("spec", ["model=2", "model=2,data=2"])
def test_slot_padded_engine(runs, spec):
    for rec in members(runs, "slot_padded", spec):
        assert rec["streams"] == runs.jax_slot and rec["retraces"] == 0


def test_gqa_groups_stay_whole(runs):
    """4 query heads over 2 KV heads: model=2 keeps one whole group per rank
    and streams JAX's tokens; model=4 cannot split 2 KV heads."""
    recs = [r["gqa"] for r in runs.ranks if r["gqa"] is not None]
    assert len(recs) == 2
    for rec in recs:
        assert rec["streams"] == runs.jax_gqa and rec["retraces"] == 0
    for r in runs.ranks:
        assert "model axis size 4 must divide num_kv_heads=2" in r["gqa_model4"]


@pytest.mark.parametrize("spec", ["model=2", "model=4", "model=2,data=2"])
def test_logits_allclose(runs, spec):
    got = [r["logits"][spec] for r in runs.ranks if spec in r["logits"]]
    assert len(got) == (2 if spec == "model=2" else 4)
    for logits in got:
        np.testing.assert_allclose(logits, runs.jax_logits, **TOL)


def test_pools_split_by_head_tables_replicated(runs):
    """Each rank's pools hold 1/model of the KV heads (spec on the head
    axis), per-rank bytes halve from model=2 to model=4 and double again
    under data=2 (the pools stay whole over data); block tables keep the
    unsharded shape and agree on every rank after the drive."""
    flat = runs.ranks[0]["flat_k"]
    per_rank = {}
    for spec, m in (("model=2", 2), ("model=4", 4), ("data=2", 1)):
        recs = [r["pools"][spec] for r in runs.ranks if spec in r["pools"]]
        for rec in recs:
            assert rec["k"] == flat[:2] + (flat[2] // m,) + flat[3:]
            assert rec["scales"] is None
            assert rec["specs"]["k"] == ((None, None, "model", None, None) if m > 1 else ())
            assert rec["specs"]["block_table"] == () and rec["specs"]["length"] == ()
            assert len(rec["bytes"]) == (m if m > 1 else 2)
            assert len(set(rec["bytes"].values())) == 1
        per_rank[spec] = next(iter(recs[0]["bytes"].values()))
        tables = [rec["table_after"] for rec in recs if rec["table"] == recs[0]["table"]]
        assert len(tables) == len(recs)
        for t in tables:
            np.testing.assert_array_equal(t, tables[0])
    assert per_rank["model=4"] * 2 == per_rank["model=2"]
    assert per_rank["data=2"] == 2 * per_rank["model=2"]


def test_tiers_share_one_base_per_rank(runs):
    """The leaves the bank's tiers share are placed once per rank: the same
    pieces appear in every tier's local tree."""
    for r in runs.ranks:
        for spec, rec in r["pools"].items():
            assert rec["same_norm"], spec
            assert 0 < rec["shared"] <= r["bank_shared"], spec


def test_prefix_cache_hits_and_free_pages_unchanged(runs):
    for r in runs.ranks:
        assert r["hits"]["model=2,data=2"] == r["hits"][None]
        assert r["hits"][None][0] > 0


def test_provenance_and_gauge(runs):
    for r in runs.ranks:
        mesh, gauge = r["provenance"]
        assert mesh == {"axis_names": ["data", "model"], "shape": {"data": 2, "model": 2},
                        "num_devices": 4}
        assert len(gauge) == 4 and all(v > 0 for v in gauge.values())
        assert r["flat_provenance"] is None


def test_validation_inside_a_group(runs):
    """The JAX package's errors, in a group of four ranks."""
    for r in runs.ranks:
        err = r["errors"]
        assert "exceeds the 4 available" in err["model=8"]
        assert "exceeds the 4 available" in err["model=4,data=4"]
        assert err["reference"].startswith("EngineCapabilityError") and \
            "mesh='model=2'" in err["reference"]
        assert "'bsr'" in err["bsr"]


def test_launcher_mesh_line(runs):
    """``--mesh model=2`` in an initialised group: rank 0 prints the note
    and the JAX launcher's line, streams equal to the unsharded run's; the
    other ranks print nothing."""
    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(LAUNCH)
    (want,) = [json.loads(x) for x in buf.getvalue().splitlines()]
    note, line = [json.loads(x) for x in runs.ranks[0]["launcher"]]
    assert note["mesh"]["shape"] == {"data": 1, "model": 2}
    assert note["collectives"].startswith("gloo")
    assert set(line) == set(want) and line["sample"] == want["sample"]
    assert line["tokens"] == want["tokens"] and line["jit_retraces"] == 0
    assert all(not r["launcher"] for r in runs.ranks[1:])


def test_launcher_spawns_ranks(runs):
    """``python -m repro_torch.launch.serve --mesh model=2`` outside a group
    starts two gloo ranks itself."""
    rc, out, err = runs.spawned
    assert rc == 0, err
    note, line = [json.loads(x) for x in out.splitlines()]
    assert note["mesh"]["num_devices"] == 2 and line["requests"] == 1
