"""The port's sharding rules, mesh specs and mesh validation against the JAX
package's, in one process (no process group: the multi-rank runs are in
``tests/test_torch_sharded_serving.py``).

The rules are compared leaf by leaf on two banks deployed from one SLR state
(a port ADMM sweep handed to the JAX package as its own ``BlockSLR``): the
port's ``serving_param_spec`` / ``param_spec`` against the JAX package's,
called with a stand-in carrying the mesh's ``axis_names`` and ``shape`` (the
rules read nothing else), at meshes of 2, 4 and 2 x 2. A rank's pieces
(``ServingMesh.local_tree``) are checked on the rank views of a ``model=2``
grid, which need no group to slice.
"""
import contextlib
import dataclasses
import io
import json
from types import SimpleNamespace

import pytest
import torch

from repro.configs.base import get_arch as jax_get_arch
from repro.core import sparse as jax_sparse
from repro.core.admm import BlockSLR as JaxBlockSLR
from repro.core.selection import SelectionConfig as JaxSelectionConfig
from repro.core.selection import path_str
from repro.core.selection import select_blocks as jax_select_blocks
from repro.parallel import sharding as jax_sharding
from repro.parallel.sharding import ServingMesh as JaxServingMesh
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ReferenceEngine as JaxReferenceEngine
from repro_torch.configs import get_arch
from repro_torch.core.admm import SalaadConfig, admm_update, init_slr_state
from repro_torch.core.selection import SelectionConfig
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh, make_serving_mesh
from repro_torch.models import model as model_lib
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import (
    ColumnGather,
    RowParallel,
    ServingMesh,
    ShardedEmbedding,
    parse_mesh_spec,
    serving_leaves,
)
from repro_torch.serving.adapters import AdapterBank, adapterize
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.elastic import ModelBank
from repro_torch.serving.engine import (
    EngineCapabilityError,
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
    ServingEngine,
    check_mesh,
)
from repro_torch.serving.speculative import SpeculativeEngine

SHAPES = [(1, 2), (1, 4), (2, 2)]     # (data, model)


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


@pytest.fixture(scope="module")
def banks():
    """The port's and the JAX package's factored (two tiers) and dense banks
    from one SLR state, on the widened fixture (4 query and 4 KV heads)."""
    import jax.numpy as jnp

    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_arch("salaad_llama_60m").reduced(), num_heads=4,
                              num_kv_heads=4)
    jcfg = dataclasses.replace(jax_get_arch("salaad_llama_60m").reduced(), num_heads=4,
                               num_kv_heads=4)
    params = model_lib.init_params(cfg, 0, "cpu")
    scfg = SalaadConfig(selection=SelectionConfig(min_dim=16), rho_constant=5.0,
                        exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    state, _ = admm_update(params, state, blocks, scfg, 0)

    def j(t):
        return jnp.asarray(t.numpy())

    jstate = {name: JaxBlockSLR(
        p=j(b.p), vt=j(b.vt), s_vals=j(b.s_vals),
        s_coo=jax_sparse.CooMatrix(j(b.s_coo.values), j(b.s_coo.idx), b.s_coo.shape),
        y=j(b.y), z=j(b.z), alpha=j(b.alpha), beta=j(b.beta), rho=b.rho)
        for name, b in state.items()}
    jparams = _map(j, params)
    jblocks = jax_select_blocks(jparams, JaxSelectionConfig(min_dim=16))
    out = {}
    for fmt, budgets in (("factored", (1.0, 0.5)), ("dense", (1.0,))):
        out[fmt] = (ModelBank.build(cfg, params, state, blocks, budgets=budgets, fmt=fmt),
                    JaxModelBank.build(jcfg, jparams, jstate, jblocks, budgets=budgets,
                                       fmt=fmt))
    return SimpleNamespace(cfg=cfg, params=params, state=state, blocks=blocks, **out)


def standin(data: int, model: int):
    return SimpleNamespace(axis_names=("data", "model"), shape={"data": data, "model": model})


def jax_leaves(tree) -> dict:
    import jax

    return {path_str(p): tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


# ------------------------------------------------------------------ specs ---


@pytest.mark.parametrize("spec", ["", "model=2", "model=4,data=2", " data=2 , model=2 ",
                                  "tp=2", "model", "model=0", "model=-1", "model=x",
                                  "model:2"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jax_sharding.parse_mesh_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(spec)
        assert str(got.value) == str(e)
        return
    assert parse_mesh_spec(spec) == want


@pytest.mark.parametrize("fmt", ["factored", "dense"])
@pytest.mark.parametrize("data,model", SHAPES)
def test_param_specs_match_jax(banks, fmt, data, model):
    """Every leaf of every tier: the same names and shapes as the JAX bank's
    tree, and the same serving and training specs."""
    port, jbank = getattr(banks, fmt)
    mesh, sizes = standin(data, model), {"data": data, "model": model}
    for tier, jtier in zip(port, jbank):
        leaves = {name: tuple(t.shape) for name, t in serving_leaves(tier.params)}
        assert leaves == jax_leaves(jtier.params)
        for name, shape in leaves.items():
            want = jax_sharding.serving_param_spec(name, shape, mesh)
            assert sharding.serving_param_spec(name, shape, sizes) == tuple(want), name
            want = jax_sharding.param_spec(name, shape, mesh)
            assert sharding.param_spec(name, shape, sizes) == tuple(want), name


@pytest.mark.parametrize("data,model", SHAPES + [(1, 1)])
def test_batch_axes_match_jax(data, model):
    """``dp_axes`` and ``dp_size`` against the JAX package's (the port's
    meshes have no pod axis), and ``batch_shardings``' rule: the leading dim
    over data where the data size divides it, else whole."""
    mesh, sizes = standin(data, model), {"data": data, "model": model}
    assert sharding.dp_axes(sizes) == jax_sharding.dp_axes(mesh)
    assert sharding.dp_size(sizes) == jax_sharding.dp_size(mesh)
    batch = {"tokens": torch.zeros(4, 8), "labels": torch.zeros(4, 8),
             "odd": torch.zeros(3, 8, 2)}
    got = sharding.batch_shardings(batch, ServingMesh(data, model))
    assert got["tokens"].spec == ("data", None) and got["labels"].spec == ("data", None)
    assert got["odd"].spec == (("data" if data == 1 else None), None, None)


def test_kv_cache_spec_splits_the_head_axis():
    """The JAX package's ``kv_cache_shardings`` rule: 5-D pools split dim 2
    over the model axis when it divides; tables and lengths are whole."""
    sizes = {"data": 1, "model": 2}
    assert sharding.kv_cache_spec((2, 16, 4, 8, 32), sizes) == (None, None, "model", None,
                                                                 None)
    assert sharding.kv_cache_spec((2, 16, 3, 8, 32), sizes) == ()
    assert sharding.kv_cache_spec((4, 4), sizes) == ()
    assert sharding.kv_cache_spec((2, 16, 4, 8, 32), {"data": 2, "model": 1}) == ()


def rank_view(model: int, index: int) -> ServingMesh:
    """Rank ``index`` of a 1 x ``model`` grid, for slicing only (no group)."""
    mesh = ServingMesh(1, model)
    mesh.model_index = index
    return mesh


def test_local_pieces_follow_the_specs(banks):
    """A rank's pieces: the split dim of each leaf is the spec's, the
    row-parallel sites wrapped for the all-reduce, the head gathered, the
    embedding's columns gathered; the norms stay whole and shared across
    tiers."""
    port, _ = banks.factored
    trees = [t.params for t in port]
    mesh = rank_view(2, 1)
    local = mesh.place_tiers(trees)
    lp, full = local[0]["layers"], trees[0]["layers"]
    assert isinstance(lp["o"], RowParallel) and isinstance(lp["down"], RowParallel)
    assert lp["o"].w.p.shape[-2] == full["o"].p.shape[-2] // 2
    assert lp["o"].w.block == (full["o"].shape[0] // 2, full["o"].shape[0], 0,
                               full["o"].shape[1])
    assert lp["q"].vt.shape[-1] == full["q"].vt.shape[-1] // 2
    assert lp["q"].p is full["q"].p
    assert isinstance(local[0]["lm_head"]["w"], ColumnGather)
    emb = local[0]["embed"]["embedding"]
    assert isinstance(emb, ShardedEmbedding) and (emb.lo, emb.hi) == (32, 64)
    for tier in local:
        assert tier["final_norm"]["norm_scale"] is local[0]["final_norm"]["norm_scale"]
        assert tier["layers"]["pre_attn"]["norm_scale"] is full["pre_attn"]["norm_scale"]
    assert mesh.local_cfg(banks.cfg).num_kv_heads == 2


@pytest.mark.parametrize("site", ["q", "o", "gate", "down"])
def test_pieces_apply_their_block_of_s(banks, site):
    """Column pieces give their columns of ``x @ (L + S)``, row pieces give
    partials over their rows that sum to it: each rank applies only the
    entries of the replicated COO S in its block."""
    port, _ = banks.factored
    lin = port.params(0)["layers"][site].at_layer(1)
    assert lin.s_coo is not None and lin.p is not None
    x = torch.randn((3, 5, lin.shape[0]), generator=torch.Generator().manual_seed(0))
    want = lin.apply(x)
    pieces = [rank_view(2, i)._local_leaf(f"layers/{site}", port.params(0)["layers"][site])
              for i in range(2)]
    if site in ("o", "down"):
        half = lin.shape[0] // 2
        parts = [pc.w.at_layer(1).apply(x[..., i * half:(i + 1) * half])
                 for i, pc in enumerate(pieces)]
        torch.testing.assert_close(parts[0] + parts[1], want, atol=1e-5, rtol=1e-5)
    else:
        got = torch.cat([pc.at_layer(1).apply(x) for pc in pieces], dim=-1)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_tied_head_partials_sum_to_the_head(banks):
    """Under tied embeddings the head is the embedding's transpose: each
    rank's d_model columns give a partial of the logits, summed over the
    model row (the sum stands in for the all-reduce here)."""
    table = banks.params["embed"]["embedding"]
    x = torch.randn((2, 3, table.shape[1]), generator=torch.Generator().manual_seed(1))
    parts = []
    for i in range(2):
        mesh = rank_view(2, i)
        mesh.all_reduce_model = lambda t: t
        emb = mesh._local_leaf("embed/embedding", table)
        parts.append(emb.T.apply(x))
    torch.testing.assert_close(parts[0] + parts[1], x @ table.T, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- validation ---


def test_engine_config_takes_the_spec_string():
    with pytest.raises(ValueError, match="mesh="):
        EngineConfig(mesh="tp=2")
    with pytest.raises(ValueError, match="mesh="):
        EngineConfig(mesh=2)
    cfg = EngineConfig(mesh="model=2")
    assert json.loads(json.dumps(dataclasses.asdict(cfg)))["mesh"] == "model=2"


def test_capabilities_report_tensor_parallel():
    for eng in (ServingEngine, PagedServingEngine, SpeculativeEngine):
        assert eng.capabilities()["features"]["tensor_parallel"] is True
    assert ReferenceEngine.capabilities()["features"]["tensor_parallel"] is False


@pytest.mark.parametrize("spec,fmt,match", [
    ("model=8", "factored", "model axis size 8 must divide num_heads=4"),
    ("model=2", "bsr", "deployment format 'bsr' cannot shard"),
    ("model=2", "fused", "deployment format 'fused' cannot shard"),
    ("data=2", "fused", None),
])
def test_check_mesh(banks, spec, fmt, match):
    if match is None:
        assert check_mesh(spec, banks.cfg, [fmt]) == {"data": 2, "model": 1}
        return
    with pytest.raises(ValueError, match=match):
        check_mesh(spec, banks.cfg, [fmt])


@pytest.mark.parametrize("spec,want", [("data=2", {"data": 2, "model": 1}),
                                       ("model=2", {"data": 1, "model": 2}),
                                       ("model=2,data=2", {"data": 2, "model": 2})])
def test_moe_under_a_mesh(spec, want):
    """An MoE passes the mesh checks (the head counts still bind: model=4
    does not divide the reduced config's 2 KV heads), its experts split on
    their E axis only, by the JAX package's rule with data dropped, and the
    router stays whole: the experts' role keeps them out of the
    row-parallel wrapper their ``down`` name would otherwise take."""
    moe = get_arch("qwen3_moe_30b_a3b").reduced()
    assert check_mesh(spec, moe, ["factored", "dense"]) == want
    with pytest.raises(ValueError, match="model axis size 4 must divide num_kv_heads=2"):
        check_mesh("model=4", moe, ["factored"])
    mesh = ServingMesh(want["data"], want["model"])
    params = model_lib.init_params(moe, 0, "cpu")
    local = mesh.local_tree(params)["layers"]["moe"]
    m = want["model"]
    for w in ("gate", "up", "down"):
        name = f"layers/moe/experts/{w}"
        full = params["layers"]["moe"]["experts"][w]
        assert sharding._role(name) == "experts"
        assert mesh.params_shardings(params)[name] == (None, "model", None, None)
        assert type(local["experts"][w]) is torch.Tensor
        assert torch.equal(local["experts"][w], full[:, :moe.num_experts // m])
    assert local["router"] is params["layers"]["moe"]["router"]


def test_mesh_larger_than_the_group(banks):
    """One process and no group: one rank. The JAX package's message on its
    one CPU device, with the port's devices named."""
    port, jbank = banks.factored
    with pytest.raises(ValueError) as want:
        JaxServingMesh.from_spec("model=2")
    with pytest.raises(ValueError) as got:
        PagedServingEngine(port, EngineConfig(max_slots=4, max_len=32, mesh="model=2"))
    assert str(got.value).startswith(str(want.value))


def test_adapters_with_a_mesh_are_refused(banks):
    base = DeployedModel.build(banks.cfg, banks.params, banks.state, banks.blocks,
                               fmt="factored")
    bank = AdapterBank(base, [adapterize(base, base)])
    with pytest.raises(ValueError, match="adapters is unsupported"):
        PagedServingEngine(bank, EngineConfig(adapters=True, mesh="model=2"))


def test_reference_engine_lists_the_mesh(banks):
    port, jbank = banks.factored
    with pytest.raises(EngineCapabilityError) as got:
        ReferenceEngine(port, EngineConfig(max_slots=1, mesh="model=2"))
    with pytest.raises(ValueError) as want:
        JaxReferenceEngine(jbank, ecfg=JaxEngineConfig(max_slots=1, mesh="model=2"))
    head = str(got.value).split("Engine capabilities:")[0]
    assert head == str(want.value).split("Engine capabilities:")[0]


def test_one_rank_meshes():
    """Without a group a 1 x 1 grid is the one process; the topology record
    has the JAX package's keys."""
    mesh = make_serving_mesh("model=1")
    assert mesh is make_host_mesh() and mesh.member and mesh.row_split(4) is None
    assert mesh.describe() == {"axis_names": ["data", "model"],
                               "shape": {"data": 1, "model": 1}, "num_devices": 1}


def test_launcher_mesh_line():
    """``--mesh`` at one rank serves in process: the note line, then the
    JAX launcher's line with the unsharded run's streams."""
    argv = ["--arch", "salaad_llama_60m", "--reduced", "--device", "cpu",
            "--keep-ratios", "1.0,0.5", "--requests", "3", "--max-new", "4"]
    lines = {}
    for extra in ([], ["--mesh", "model=1"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve.main(argv + extra)
        lines[bool(extra)] = [json.loads(x) for x in buf.getvalue().splitlines()]
    (want,), (note, got) = lines[False], lines[True]
    assert note["mesh"]["num_devices"] == 1 and note["collectives"] == "none (one rank)"
    assert set(got) == set(want)
    for key in ("requests", "tokens", "sample", "jit_retraces", "tiers", "bank"):
        assert got[key] == want[key], key
