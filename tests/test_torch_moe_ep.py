"""The port's MoE FFN under a mesh (``models/moe.py``: the expert-parallel
branch and the data axis of the single-rank branch) against the JAX
package's single-rank ``moe_ffn``, on four gloo ranks on the CPU.

The JAX package's own expert-parallel path (``shard_map``) and its
multi-device GSPMD runs are not oracles: their tests are red on this
container. So each case holds the port against JAX's single-rank function
applied as the JAX branch's semantics say:

* ``model=2`` / ``model=4`` at ``data=1``: one JAX call on the whole batch
  (capacity over every row), and bit for bit the port's unsharded call;
* ``model=2,data=2``: one JAX call per data shard's rows (capacity per
  shard), the aux loss the mean of the shards';
* ``data=2`` alone, and ``model=2,data=2`` on a batch of 3 rows that the
  data axis does not divide: one JAX call on the whole batch (global
  capacity and aux; the ``RowSplit``'s repeated row neither routes nor
  takes capacity);
* ``model=4`` over 6 experts (``E % m != 0``): every rank holds every
  expert, held against the port's unsharded call.

At capacity factors 1.25 and 0.5 (drops forced); dropped pairs summed over
the ranks equal those JAX's routing drops. Tolerances: outputs within 1e-5
of the largest |value| (f32), aux within 1e-6. Then greedy streams of the
paged engine on a reduced ``qwen3_moe_30b_a3b`` two-tier factored bank
under ``EngineConfig(mesh="model=2")`` (capacity factor 1.25, so the
capacity drops pairs) and ``"model=2,data=2"`` (the reduced config's
dropless capacity) equal the unsharded port's, with ``moe_drops`` summed
over the ranks equal to the unsharded count.

The ranks (``launch/mesh.py::RankPool``, started once for the file, one
torch thread each) run functions of this module that import no JAX.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

D, F_DIM, K = 16, 24, 2
FACTORS = (1.25, 0.5)
# (name, mesh spec, experts, rows) -> the JAX oracle's semantics
CASES = {
    "model2": ("model=2", 8, 4, "whole"),
    "model4": ("model=4", 8, 4, "whole"),
    "model2_data2": ("model=2,data=2", 8, 4, "per_shard"),
    "data2": ("data=2", 8, 4, "whole"),
    "data2_ragged": ("data=2", 8, 3, "whole"),
    "model2_data2_ragged": ("model=2,data=2", 8, 3, "whole"),
    "model4_e6": ("model=4", 6, 4, "port"),
}
PROMPTS = [[5, 7, 11, 2, 9], list(range(2, 9)), [3, 1, 4], [8, 8, 2, 9, 1, 4],
           [1, 2, 3, 4, 5, 6, 7, 8, 9], [9, 4]]


def weights(num_experts: int) -> dict:
    rng = np.random.default_rng(num_experts)
    e = num_experts
    return {"router": rng.standard_normal((D, e)).astype(np.float32),
            "experts": {"gate": rng.standard_normal((e, D, F_DIM)).astype(np.float32) * 0.2,
                        "up": rng.standard_normal((e, D, F_DIM)).astype(np.float32) * 0.2,
                        "down": rng.standard_normal((e, F_DIM, D)).astype(np.float32) * 0.2}}


def inputs(rows: int) -> np.ndarray:
    return np.random.default_rng(100 + rows).standard_normal((rows, 24, D)).astype(np.float32)


def as_torch(tree):
    if isinstance(tree, dict):
        return {k: as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


# ------------------------------------------------------------ rank side ---


def _rank_moe(rank, cases):
    """Every case on this rank: (output gathered over the data column, aux,
    drop counts), None where the rank lies outside the case's grid."""
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import ServingMesh

    out = {}
    for name, (spec, ne, rows, _) in cases.items():
        mesh = ServingMesh.from_spec(spec)
        for cf in FACTORS:
            if not mesh.member:
                out[name, cf] = None
                continue
            local = mesh.local_tree({"moe": as_torch(weights(ne))})["moe"]
            x = torch.from_numpy(inputs(rows))
            split = mesh.row_split(rows)
            drops = moe.DropCounter()
            with mesh:
                y, aux = moe.moe_ffn(local, split.take(x) if split else x, num_experts=ne,
                                     top_k=K, capacity_factor=cf, drops=drops, rows=split)
            y = split.gather(y) if split else y
            out[name, cf] = {"y": y.numpy(), "aux": float(aux), "drops": drops.read(),
                             "experts": tuple(local["experts"]["gate"].shape)}
    return out


def _moe_cfg(capacity_factor=None):
    from repro_torch.configs import get_arch

    cfg = get_arch("qwen3_moe_30b_a3b").reduced()
    return cfg if capacity_factor is None else dataclasses.replace(
        cfg, capacity_factor=capacity_factor)


def _bank(cfg):
    from repro_torch.core.admm import SalaadConfig, admm_update, init_slr_state
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.models import model as model_lib
    from repro_torch.serving.elastic import ModelBank

    params = model_lib.init_params(cfg, seed=0, device="cpu")
    scfg = SalaadConfig(selection=SelectionConfig(min_dim=16), exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    state, _ = admm_update(params, state, blocks, scfg, 0)
    return ModelBank.build(cfg, params, state, blocks, budgets=(1.0, 0.5), fmt="factored")


def _drive(bank, mesh=None):
    from repro_torch.models import moe
    from repro_torch.serving.engine import EngineConfig, PagedServingEngine

    eng = PagedServingEngine(bank, EngineConfig(max_slots=4, max_len=48, block_size=8,
                                                prefill_chunk=8, mesh=mesh))
    eng.moe_drops = moe.DropCounter()
    for i, p in enumerate(PROMPTS):
        eng.submit(p, max_new_tokens=6, tier=i % 2)
    streams = {tuple(r.prompt): r.out_tokens for r in eng.run()}
    experts = sum(t.numel() * t.element_size()
                  for t in {id(t["layers"]["moe"]["experts"][w]): t["layers"]["moe"]["experts"][w]
                            for t in eng._tier_params for w in ("gate", "up", "down")}.values())
    return {"streams": streams, "drops": eng.moe_drops.read(), "expert_bytes": experts}


def _rank_streams(rank):
    """Unsharded and sharded greedy streams of the paged engine: at
    ``model=2`` with capacity factor 1.25, at ``model=2,data=2`` dropless."""
    from repro_torch.parallel.sharding import ServingMesh

    out = {}
    for spec, cf in (("model=2", 1.25), ("model=2,data=2", None)):
        bank = _bank(_moe_cfg(cf))
        member = ServingMesh.from_spec(spec).member
        out[spec] = {"flat": _drive(bank) if rank == 0 else None,
                     "mesh": _drive(bank, spec) if member else None}
    return out


# ------------------------------------------------------------- JAX side ---


FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=None)
def jax_moe(ne: int, cf: float):
    import jax

    from repro.models import moe as jmoe

    return jax.jit(functools.partial(jmoe.moe_ffn, num_experts=ne, top_k=K,
                                     capacity_factor=cf), compiler_options=FAST_COMPILE)


def jax_dropped(x: np.ndarray, ne: int, cf: float) -> int:
    """The pairs JAX's routing of the rows x drops at its capacity."""
    import jax.numpy as jnp

    from repro.models import moe as jmoe

    b, t, _ = x.shape
    _, ids, _ = jmoe._route(jnp.asarray(x.reshape(b * t, D)), jnp.asarray(weights(ne)["router"]),
                            ne, K)
    cap = max(int(np.ceil(b * t * K / ne * cf)), K)
    counts = np.bincount(np.asarray(ids).reshape(-1), minlength=ne)
    return int(np.maximum(counts - cap, 0).sum())


def jax_oracle(ne: int, rows: int, cf: float, semantics: str):
    """(output, aux, dropped pairs) of JAX's single-rank FFN applied as the
    case says: on the whole batch, or per data shard of 2."""
    import jax.numpy as jnp

    x = inputs(rows)
    params = {"router": jnp.asarray(weights(ne)["router"]),
              "experts": {k: jnp.asarray(v) for k, v in weights(ne)["experts"].items()}}
    shards = [x] if semantics == "whole" else np.split(x, 2)
    outs = [jax_moe(ne, cf)(params, jnp.asarray(s)) for s in shards]
    y = np.concatenate([np.asarray(o) for o, _ in outs])
    aux = float(np.mean([float(a) for _, a in outs]))
    return y, aux, sum(jax_dropped(s, ne, cf) for s in shards)


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import RankPool
    from repro_torch.models import moe

    pool = RankPool(4, "cpu", threads=1)
    try:
        pool.submit(_rank_moe, CASES)
        oracle = {(name, cf): jax_oracle(ne, rows, cf, sem)
                  for name, (_, ne, rows, sem) in CASES.items() if sem != "port"
                  for cf in FACTORS}
        flat = {}
        for name, (_, ne, rows, _) in CASES.items():
            for cf in FACTORS:
                drops = moe.DropCounter()
                y, aux = moe.moe_ffn(as_torch(weights(ne)), torch.from_numpy(inputs(rows)),
                                     num_experts=ne, top_k=K, capacity_factor=cf, drops=drops)
                flat[name, cf] = (y.numpy(), float(aux), drops.read())
        ranks = pool.collect(timeout=300)
        pool.submit(_rank_streams)
        streams = pool.collect(timeout=300)
    finally:
        pool.close()
    return SimpleNamespace(ranks=ranks, oracle=oracle, flat=flat, streams=streams)


def members(records, key):
    got = [(rank, r[key]) for rank, r in enumerate(records) if r[key] is not None]
    assert got, key
    return got


# ------------------------------------------------------------------ tests ---


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[3] != "port"])
def test_moe_ffn_matches_jax_single_rank(runs, name, cf):
    """Every member rank's gathered output within 1e-5 of the largest
    |value| of JAX's, the aux loss within 1e-6, and the dropped pairs
    summed over the ranks equal to those of JAX's routing."""
    spec, ne, rows, sem = CASES[name]
    want, want_aux, want_drops = runs.oracle[name, cf]
    recs = members(runs.ranks, (name, cf))
    tol = 1e-5 * float(np.abs(want).max())
    for rank, rec in recs:
        np.testing.assert_allclose(rec["y"], want, atol=tol, rtol=0, err_msg=f"rank {rank}")
        assert abs(rec["aux"] - want_aux) <= 1e-6, (rank, rec["aux"], want_aux)
    # each rank counts its own experts' pairs of the rows it serves
    model = int(spec.split("model=")[1].split(",")[0]) if "model=" in spec else 1
    data = int(spec.split("data=")[1]) if "data=" in spec else 1
    assert len(recs) == model * data
    assert sum(r["drops"]["dropped"] for _, r in recs) == want_drops
    assert sum(r["drops"]["routed"] for _, r in recs) == rows * 24 * K
    if cf == 0.5:
        assert want_drops > 0


@pytest.mark.parametrize("cf", FACTORS)
@pytest.mark.parametrize("name", ["model2", "model4"])
def test_expert_parallel_is_the_unsharded_call_bit_for_bit(runs, name, cf):
    """At ``data=1`` the per-pair sum over the model row adds exact zeros,
    so every rank holds the unsharded call's bits; each holds E/m experts."""
    spec, ne, _, _ = CASES[name]
    y, aux, drops = runs.flat[name, cf]
    m = int(spec.split("=")[1])
    for rank, rec in members(runs.ranks, (name, cf)):
        assert np.array_equal(rec["y"], y), rank
        assert rec["experts"][0] == ne // m
    assert sum(r["drops"]["dropped"] for _, r in members(runs.ranks, (name, cf))) \
        == drops["dropped"]


@pytest.mark.parametrize("cf", FACTORS)
def test_experts_that_do_not_divide_stay_whole(runs, cf):
    """6 experts over ``model=4``: every rank holds all 6 and computes the
    unsharded call."""
    y, aux, drops = runs.flat["model4_e6", cf]
    recs = members(runs.ranks, ("model4_e6", cf))
    assert len(recs) == 4
    for rank, rec in recs:
        assert rec["experts"][0] == 6
        np.testing.assert_allclose(rec["y"], y, atol=1e-6 * float(np.abs(y).max()), rtol=0)
        assert abs(rec["aux"] - aux) <= 1e-6
        assert rec["drops"] == drops


@pytest.mark.parametrize("spec", ["model=2", "model=2,data=2"])
def test_engine_streams_match_unsharded(runs, spec):
    """Greedy streams of the paged engine on a two-tier factored bank under
    the mesh equal the unsharded port's on every member rank; the dropped
    pairs summed over the ranks equal the unsharded count (and are not zero
    at capacity factor 1.25); each rank holds 1/model of the expert bytes."""
    flat = runs.streams[0][spec]["flat"]
    recs = [(rank, r[spec]["mesh"]) for rank, r in enumerate(runs.streams)
            if r[spec]["mesh"] is not None]
    assert len(recs) == (2 if spec == "model=2" else 4)
    for rank, rec in recs:
        assert rec["streams"] == flat["streams"], rank
        assert rec["expert_bytes"] * 2 == flat["expert_bytes"], rank
    dropped = sum(rec["drops"]["dropped"] for _, rec in recs)
    routed = sum(rec["drops"]["routed"] for _, rec in recs)
    if spec == "model=2":
        assert dropped == flat["drops"]["dropped"] > 0
        assert routed == flat["drops"]["routed"]
        assert sum(rec["drops"]["real_dropped"] for _, rec in recs) \
            == flat["drops"]["real_dropped"]
    else:
        assert dropped == flat["drops"]["dropped"] == 0
