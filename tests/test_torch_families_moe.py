"""The port's MoE family (``dbrx_132b``, ``qwen3_moe_30b_a3b``) against the
JAX package at ``.reduced()``: the expert FFN alone (with and without
drops), the forward with its load-balance aux loss, gradients, decode
consistency, chunked prefill, the SLR block list (stacked (L, E) expert
slices), the deployment formats of the JAX support matrix, and greedy
streams on the paged and slot-padded engines with ``capacity_factor=1.25``,
where the capacity drops tokens (the reduced configs are dropless; the
dropped pairs are the case that can fork a stream). DBRX (16 experts top-4,
reduced like Qwen3's to 4 experts top-2) runs every check but the streams,
which run on Qwen3 (the CPU suite's time is a budget).

The JAX side is built from ``PRNGKey(0)`` with one exact-SVD ADMM sweep and
carried over through ``repro_torch.bridge``; TF32 is off. Logits within
1e-5 of max |logit| (f32); token streams equal exactly.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.core.admm import SalaadConfig as JaxSalaadConfig
from repro.core.admm import admm_update as jax_admm_update
from repro.core.admm import init_slr_state as jax_init_slr_state
from repro.core.selection import SelectionConfig as JaxSelectionConfig
from repro.models import model as jax_model
from repro.models import moe as jax_moe
from repro.serving.deployed import DeployedModel as JaxDeployedModel
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedServingEngine as JaxPagedServingEngine
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.core.selection import SelectionConfig, select_blocks
from repro_torch.models import model as model_lib
from repro_torch.models import moe
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.elastic import ModelBank
from repro_torch.serving.engine import EngineConfig, PagedServingEngine, ServingEngine

ARCHS = ["qwen3_moe_30b_a3b", "dbrx_132b"]
PROMPTS = [[5, 7, 11, 2, 9], list(range(2, 9)), [3, 1, 4], [8, 8, 2, 9, 1, 4]]


# the JAX side's calls run once or twice each on tiny shapes, so compiling
# them is most of their time: XLA's CPU optimizations stay off
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn, **kw):
    return jax.jit(fn, compiler_options=FAST_COMPILE, **kw)


@functools.lru_cache(maxsize=None)
def jitted(fn, cfg, **static):
    """``fn(*args, cfg=cfg, **static)`` compiled once per config (called
    eagerly, the JAX side compiles its layer scans again at every call)."""
    return fast_jit(lambda *args: fn(*args, cfg=cfg, **static))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_logits(got: torch.Tensor, want, msg=""):
    want = np.asarray(want)
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0, err_msg=msg)


@pytest.fixture(scope="module", autouse=True)
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev
    build.cache_clear()


@functools.lru_cache(maxsize=None)
def build(arch: str, **over):
    cfg = dataclasses.replace(jax_base.get_arch(arch).reduced(), **over)
    tcfg = dataclasses.replace(base.get_arch(arch).reduced(), **over)
    params = fast_jit(jax_model.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    scfg = JaxSalaadConfig(selection=JaxSelectionConfig(min_dim=16), exact_svd=True)
    state, blocks = jax_init_slr_state(params, scfg)
    state, _ = fast_jit(lambda p, s: jax_admm_update(p, s, blocks, scfg, 0))(params, state)
    tparams = bridge.params_from_numpy(to_numpy(params), "cpu")
    return SimpleNamespace(
        arch=arch, cfg=cfg, tcfg=tcfg, params=params, state=state, blocks=blocks,
        tparams=tparams, tstate=bridge.slr_state_from_numpy(to_numpy(state), "cpu"),
        tblocks=select_blocks(tparams, SelectionConfig(min_dim=16)))


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return build(request.param)


def tokens(seed: int, b=2, t=16):
    return np.random.default_rng(seed).integers(0, 256, (b, t)).astype(np.int32)


# ---------------------------------------------------------- the expert FFN ---


@pytest.mark.parametrize("capacity_factor", [2.0, 1.0, 0.5])
def test_moe_ffn_matches_jax(capacity_factor):
    """The single-rank FFN on 96 tokens over 8 experts, top-2: the output
    and the aux loss; below capacity factor 2 some pairs are dropped, in
    JAX's order (stable sort by expert, position in expert)."""
    rng = np.random.default_rng(7)
    d, f, e = 16, 24, 8
    x = rng.standard_normal((3, 32, d)).astype(np.float32)
    params = {"router": rng.standard_normal((d, e)).astype(np.float32),
              "experts": {"gate": rng.standard_normal((e, d, f)).astype(np.float32) * 0.2,
                          "up": rng.standard_normal((e, d, f)).astype(np.float32) * 0.2,
                          "down": rng.standard_normal((e, f, d)).astype(np.float32) * 0.2}}
    kw = dict(num_experts=e, top_k=2, capacity_factor=capacity_factor)
    drops = moe.DropCounter()
    real = torch.arange(32)[None, :] < torch.tensor([32, 20, 0])[:, None]
    drops.real = real
    got, aux = moe.moe_ffn(bridge.params_from_numpy(params, "cpu"), torch.from_numpy(x),
                           drops=drops, **kw)
    want, jaux = fast_jit(functools.partial(jax_moe.moe_ffn, **kw))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    n = drops.read()
    assert (n["dropped"] > 0) == (capacity_factor < 2.0) and n["routed"] == 96 * 2
    assert n["real_routed"] == 52 * 2 and n["real_dropped"] <= n["dropped"]
    # the rows marked real drop what their pairs drop in the unmasked count
    unmasked = moe.DropCounter()
    moe.moe_ffn(bridge.params_from_numpy(params, "cpu"), torch.from_numpy(x), drops=unmasked,
                **kw)
    assert unmasked.read()["real_dropped"] == n["dropped"]
    assert moe.capacity(96, e, 2, capacity_factor) == \
        max(int(np.ceil(96 * 2 / e * capacity_factor)), 2)


# ---------------------------------------------------------------- models ---


def test_forward_aux_and_gradients_match_jax(fam):
    toks, labels = tokens(1), tokens(2)
    got, _ = model_lib._forward(fam.tparams, {"tokens": torch.from_numpy(toks)}, fam.tcfg)
    want, _, jaux = jitted(jax_model._forward, fam.cfg)(fam.params, {"tokens": jnp.asarray(toks)})
    assert_logits(got, want)
    tparams = bridge.params_from_numpy(to_numpy(fam.params), "cpu")
    leaves = []

    def grad_on(tree):
        for v in tree.values():
            if isinstance(v, dict):
                grad_on(v)
            else:
                leaves.append(v.requires_grad_(True))

    grad_on(tparams)
    batch = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long()}
    loss, metrics = model_lib.loss_fn(tparams, batch, fam.tcfg)
    jloss, jmetrics = jitted(jax_model.loss_fn, fam.cfg)(
        fam.params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    assert float(metrics["aux"].detach()) > 0
    for g, w in ((loss, jloss), (metrics["ce"], jmetrics["ce"]),
                 (metrics["aux"], jmetrics["aux"])):
        np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5)
    loss.backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in leaves)
    assert leaves[0].grad.abs().sum() > 0


@pytest.mark.parametrize("fam", ["qwen3_moe_30b_a3b", "dbrx_132b"], indirect=True)
def test_prefill_then_decode_matches_forward(fam):
    toks = torch.from_numpy(tokens(3)).long()
    full, _ = model_lib._forward(fam.tparams, {"tokens": toks}, fam.tcfg)
    _, cache = model_lib.prefill(fam.tparams, {"tokens": toks[:, :15]}, fam.tcfg, max_len=32,
                                 cache_dtype=torch.float32)
    step, _ = model_lib.decode_step(fam.tparams, toks[:, 15:], cache, fam.tcfg)
    assert_logits(step[:, 0], full[:, -1].numpy())


@pytest.mark.parametrize("fam", ["qwen3_moe_30b_a3b", "dbrx_132b"], indirect=True)
def test_chunked_prefill_matches_jax(fam):
    slots, bs, nb = 3, 4, 6
    table = np.arange(slots * nb, dtype=np.int32).reshape(slots, nb)
    toks = tokens(4, slots, 8)
    tcache = model_lib.init_paged_cache(fam.tcfg, slots, slots * nb, bs, nb, device="cpu")
    tcache = tcache._replace(block_table=torch.from_numpy(table))
    jcache = jax_model.init_paged_cache(fam.cfg, slots, slots * nb, bs, nb, dtype=jnp.float32)
    jcache = jcache._replace(block_table=jnp.asarray(table))
    for counts in ([8, 5, 3], [8, 8, 0]):
        counts = np.array(counts, np.int32)
        got, tcache = model_lib.chunk_prefill_step(fam.tparams, torch.from_numpy(toks),
                                                   torch.from_numpy(counts), tcache, fam.tcfg)
        want, jcache = jitted(jax_model.chunk_prefill_step, fam.cfg)(
            fam.params, jnp.asarray(toks), jnp.asarray(counts), jcache)
        for b, c in enumerate(counts):
            if c:
                assert_logits(got[b, :c], want[b, :c])


def test_blocks_match_jax(fam):
    got = [(b.name, b.shape, b.stack_dims, b.is_embedding) for b in fam.tblocks]
    want = [(b.name, tuple(b.shape), tuple(b.stack_dims), b.is_embedding) for b in fam.blocks]
    assert got == want
    stacks = {b.name: b.stack_dims for b in fam.tblocks}
    assert stacks["layers/moe/experts/gate"] == (fam.cfg.num_layers, fam.cfg.num_experts)


@pytest.mark.parametrize("fam", ["qwen3_moe_30b_a3b", "dbrx_132b"], indirect=True)
@pytest.mark.parametrize("fmt", ["fused", "bsr"])
def test_deployed_formats_match_jax(fam, fmt):
    """The JAX support matrix's formats for the MoE (fused and bsr serve);
    the experts are served dense-materialized in both packages."""
    got = DeployedModel.build(fam.tcfg, fam.tparams, fam.tstate, fam.tblocks, fmt=fmt,
                              bsr_block=32)
    want = JaxDeployedModel.build(fam.cfg, fam.params, fam.state, fam.blocks, fmt=fmt,
                                  bsr_block=32)
    assert got.param_bytes() == want.param_bytes()
    experts = (got.params["layers"][0] if fmt == "bsr" else got.params["layers"])["moe"]
    assert all(isinstance(w, torch.Tensor) for w in experts["experts"].values())
    toks = tokens(5, t=8)
    assert_logits(got.forward(torch.from_numpy(toks)), fast_jit(want.forward)(jnp.asarray(toks)),
                  fmt)


# --------------------------------------------------------------- serving ---


def serve(engine, max_new=4):
    uids = [engine.submit(p, max_new_tokens=max_new, tier=i % 2) for i, p in enumerate(PROMPTS)]
    by_uid = {r.uid: list(r.out_tokens) for r in engine.run()}
    return [by_uid[u] for u in uids]


def streams(fam, engine: str):
    tbank = ModelBank.build(fam.tcfg, fam.tparams, fam.tstate, fam.tblocks, (1.0, 0.5),
                            fmt="factored")
    jbank = JaxModelBank.build(fam.cfg, fam.params, fam.state, fam.blocks, (1.0, 0.5),
                               fmt="factored")
    kw = dict(max_slots=3, max_len=32)
    if engine == "paged":
        kw.update(block_size=4, prefill_chunk=8)
        pair = (PagedServingEngine, JaxPagedServingEngine)
    else:
        pair = (ServingEngine, JaxServingEngine)
    engine = pair[0](tbank, EngineConfig(**kw))
    engine.moe_drops = moe.DropCounter()
    got = serve(engine)
    want = serve(pair[1](jbank, JaxEngineConfig(**kw)))
    assert got == want and all(len(s) == 4 for s in got)
    n = engine.moe_drops.read()
    # the ticks route padded rows too: real rows are a part of the routed
    assert 0 < n["real_routed"] < n["routed"] and n["real_dropped"] <= n["dropped"]
    return n["dropped"]


@pytest.fixture(scope="module")
def dropping():
    return build("qwen3_moe_30b_a3b", capacity_factor=1.25)


def test_forward_with_drops_matches_jax(dropping):
    toks = tokens(6, 4, 16)
    drops = moe.DropCounter()
    got, _ = model_lib._forward(dropping.tparams, {"tokens": torch.from_numpy(toks)},
                                dropping.tcfg, drops=drops)
    want, _, _ = jitted(jax_model._forward, dropping.cfg)(dropping.params,
                                                          {"tokens": jnp.asarray(toks)})
    assert drops.read()["dropped"] > 0
    assert_logits(got, want)


@pytest.mark.parametrize("engine", ["paged", "batched"])
def test_streams_with_drops_match_jax(dropping, engine):
    """capacity_factor 1.25: the chunks and prefills drop (token, expert)
    pairs, and the streams still equal JAX's token for token."""
    assert streams(dropping, engine) > 0
