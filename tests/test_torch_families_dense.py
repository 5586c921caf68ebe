"""The port's dense variants (``olmo_1b``, ``gemma_7b``, ``qwen1p5_4b``,
``phi3_medium_14b``) and the VLM backbone (``internvl2_76b``) against the
JAX package at ``.reduced()``, and every architecture's config.

Each architecture is built on the JAX side from ``PRNGKey(0)`` (its norm
scales, norm biases and q/k/v biases perturbed, so those leaves matter),
given one exact-SVD ADMM sweep, and carried over through
``repro_torch.bridge``. TF32 is off. What is held: the configs, ``SHAPES``,
``runnable_cells()`` and ``input_specs`` field by field; the forward's
logits and ``loss_fn`` within 1e-5 of max |logit| (f32); finite gradients;
prefill(T-1) plus one decode step against the full forward; chunked
prefill over pages; the SLR block list; the fused deployment's logits; and
greedy streams of a two-tier bank through the paged and the
slot-padded engines, token for token.
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
from repro.serving.deployed import DeployedModel as JaxDeployedModel
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import PagedServingEngine as JaxPagedServingEngine
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.core.selection import SelectionConfig, select_blocks
from repro_torch.models import model as model_lib
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.elastic import ModelBank
from repro_torch.serving.engine import EngineConfig, PagedServingEngine, ServingEngine

ARCHS = ["olmo_1b", "gemma_7b", "qwen1p5_4b", "phi3_medium_14b", "internvl2_76b"]
PROMPTS = [[5, 7, 11, 2, 9], list(range(2, 9)), [3, 1, 4], [8, 8, 2, 9, 1, 4]]
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def assert_logits(got: torch.Tensor, want, msg=""):
    want = np.asarray(want)
    tol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0, err_msg=msg)


def perturb(params, seed: int):
    """Random values in every norm and bias leaf (zeros or ones at init)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "bias" in name:
            return x + jnp.asarray(rng.standard_normal(x.shape, np.float32) * 0.1, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def make_batch(cfg, seed: int, b=2, t=16) -> dict:
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model),
                                               np.float32) * 0.1
    return batch


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


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.fixture(scope="module", autouse=True)
def no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev
    build.cache_clear()


@functools.lru_cache(maxsize=None)
def build(arch: str):
    """One architecture on both sides, built once per module: tests that
    narrow ``fam``'s parameters re-enter the fixture with the same arch."""
    cfg = jax_base.get_arch(arch).reduced()
    params = perturb(fast_jit(jax_model.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0)), 1)
    scfg = JaxSalaadConfig(selection=JaxSelectionConfig(min_dim=16), exact_svd=True)
    state, blocks = jax_init_slr_state(params, scfg)
    state, _ = fast_jit(lambda p, s: jax_admm_update(p, s, blocks, scfg, 0))(params, state)
    tparams = bridge.params_from_numpy(to_numpy(params), "cpu")
    return SimpleNamespace(
        arch=arch, cfg=cfg, tcfg=base.get_arch(arch).reduced(), params=params, state=state,
        blocks=blocks, tparams=tparams,
        tstate=bridge.slr_state_from_numpy(to_numpy(state), "cpu"),
        tblocks=select_blocks(tparams, SelectionConfig(min_dim=16)))


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return build(request.param)


# --------------------------------------------------------------- configs ---


def _fields_equal(got, want):
    for f in dataclasses.fields(want):
        w = getattr(want, f.name)
        g = getattr(got, f.name)
        if f.name == "param_dtype":
            assert g == DTYPES[w], f.name
        else:
            assert g == w and type(g) is type(w), f.name


@pytest.mark.parametrize("arch", jax_base.ARCH_IDS)
def test_config_and_reduced_match_jax(arch):
    """Every field, full and reduced (MoE dropless there), and no field the
    JAX config lacks."""
    got, want = base.get_arch(arch), jax_base.get_arch(arch)
    assert {f.name for f in dataclasses.fields(got)} == \
        {f.name for f in dataclasses.fields(want)}
    _fields_equal(got, want)
    _fields_equal(got.reduced(), want.reduced())
    assert got.sub_quadratic == want.sub_quadratic


def test_registry_shapes_and_cells_match_jax():
    from test_arch_smoke import EXPECTED_DIMS

    assert base.ARCH_IDS == jax_base.ARCH_IDS
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jax_base.SHAPES.items()}
    assert base.runnable_cells() == jax_base.runnable_cells()
    for arch, dims in EXPECTED_DIMS.items():
        cfg = base.get_arch(arch)
        assert {k: getattr(cfg, k) for k in dims} == dims, arch
    assert base.get_arch("qwen1.5-4b") is base.get_arch("qwen1p5_4b")
    assert set(model_lib.FAMILIES) == {"dense", "moe", "ssm", "hybrid", "encdec", "vlm"}
    with pytest.raises(ValueError, match="unknown architecture"):
        base.get_arch("llama_7b")


@pytest.mark.parametrize("arch", jax_base.ARCH_IDS)
def test_input_specs_match_jax(arch):
    cfg, jcfg = base.get_arch(arch), jax_base.get_arch(arch)
    for shape in base.SHAPES.values():
        got = model_lib.input_specs(cfg, shape, per_host=4)
        want = jax_model.input_specs(jcfg, jax_base.SHAPES[shape.name], per_host=4)
        assert list(got) == list(want)
        for k, spec in got.items():
            assert spec.shape == tuple(want[k].shape), (shape.name, k)
            assert spec.dtype == {jnp.int32: torch.int32, **DTYPES}[want[k].dtype.type]


# ---------------------------------------------------------------- models ---


def test_forward_loss_and_gradients_match_jax(fam):
    batch = make_batch(fam.cfg, 1)
    got, _ = model_lib._forward(fam.tparams, torch_batch(batch), fam.tcfg)
    want, _, _ = jitted(jax_model._forward, fam.cfg)(fam.params, jax_batch(batch))
    exp_t = 16 + (fam.cfg.num_patches if fam.cfg.family == "vlm" else 0)
    assert got.shape == (2, exp_t, fam.cfg.vocab_size)
    assert_logits(got, want)

    tparams = bridge.params_from_numpy(to_numpy(fam.params), "cpu")
    leaves = []

    def grad_on(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                grad_on(v)
            else:
                v.requires_grad_(True)
                leaves.append(v)

    grad_on(tparams)
    loss, metrics = model_lib.loss_fn(tparams, torch_batch(batch), fam.tcfg)
    jloss, jmetrics = jitted(jax_model.loss_fn, fam.cfg)(fam.params, jax_batch(batch))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmetrics["ce"]), rtol=1e-5)
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0
    loss.backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in leaves)


def test_prefill_then_decode_matches_forward(fam):
    """JAX's ``test_decode_consistency`` on the port, with an f32 cache: the
    decode step's logits equal the full forward's last row, and JAX's."""
    batch = make_batch(fam.cfg, 2)
    full, _ = model_lib._forward(fam.tparams, torch_batch(batch), fam.tcfg)
    head = {**batch, "tokens": batch["tokens"][:, :15]}
    _, cache = model_lib.prefill(fam.tparams, torch_batch(head), fam.tcfg, max_len=32,
                                 cache_dtype=torch.float32)
    step, _ = model_lib.decode_step(fam.tparams, torch.from_numpy(batch["tokens"][:, 15:]),
                                    cache, fam.tcfg)
    assert_logits(step[:, 0], full[:, -1].numpy())
    _, jcache = jitted(jax_model.prefill, fam.cfg, max_len=32, cache_dtype=jnp.float32)(
        fam.params, jax_batch(head))
    jstep, _ = jitted(jax_model.decode_step, fam.cfg)(
        fam.params, jnp.asarray(batch["tokens"][:, 15:]), jcache)
    assert_logits(step, jstep)


def test_blocks_match_jax(fam):
    got = [(b.name, b.shape, b.stack_dims, b.is_embedding) for b in fam.tblocks]
    want = [(b.name, tuple(b.shape), tuple(b.stack_dims), b.is_embedding) for b in fam.blocks]
    assert got == want
    assert not any("lm_head" in b.name for b in fam.tblocks)


def test_deployed_fused_matches_jax(fam):
    """The format the JAX package's support matrix serves these families in
    (fused on the paged engine)."""
    fmt = "fused"
    got = DeployedModel.build(fam.tcfg, fam.tparams, fam.tstate, fam.tblocks, fmt=fmt,
                              bsr_block=32)
    want = JaxDeployedModel.build(fam.cfg, fam.params, fam.state, fam.blocks, fmt=fmt,
                                  bsr_block=32)
    assert got.param_bytes() == want.param_bytes()
    toks = make_batch(fam.cfg, 3, t=8)["tokens"]
    assert_logits(got.forward(torch.from_numpy(toks)), fast_jit(want.forward)(jnp.asarray(toks)),
                  fmt)


def test_tied_head_matches_jax():
    """Tied embeddings: no ``lm_head`` leaf, the head is embedding.T."""
    cfg = dataclasses.replace(jax_base.get_arch("olmo_1b").reduced(), tie_embeddings=True)
    tcfg = dataclasses.replace(base.get_arch("olmo_1b").reduced(), tie_embeddings=True)
    params = fast_jit(jax_model.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(4))
    assert "lm_head" not in params
    assert "lm_head" not in model_lib.init_params(tcfg, 0, "cpu")
    toks = make_batch(cfg, 4)["tokens"]
    got, _ = model_lib._forward(bridge.params_from_numpy(to_numpy(params), "cpu"),
                                {"tokens": torch.from_numpy(toks)}, tcfg)
    want, _, _ = jitted(jax_model._forward, cfg)(params, {"tokens": jnp.asarray(toks)})
    assert_logits(got, want)


@pytest.mark.parametrize("fam", ["olmo_1b", "internvl2_76b"], indirect=True)
def test_chunked_prefill_matches_jax(fam):
    """Ragged chunks (a row of none among them) then a decode step over a
    paged cache, for OLMo and the VLM (which serves text through the
    engines, as in the JAX package)."""
    slots, bs, nb = 3, 4, 6
    table = np.arange(slots * nb, dtype=np.int32).reshape(slots, nb)
    toks = np.random.default_rng(5).integers(0, 256, (slots, 8)).astype(np.int32)
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
    got, _ = model_lib.decode_step(fam.tparams, torch.tensor([[7], [9], [11]]), tcache,
                                   fam.tcfg)
    want, _ = jitted(jax_model.decode_step, fam.cfg)(fam.params, jnp.asarray([[7], [9], [11]]),
                                                     jcache)
    assert_logits(got, want)


# --------------------------------------------------------------- serving ---


def serve(engine, max_new=4):
    uids = [engine.submit(p, max_new_tokens=max_new, tier=i % 2) for i, p in enumerate(PROMPTS)]
    by_uid = {r.uid: list(r.out_tokens) for r in engine.run()}
    return [by_uid[u] for u in uids]


def _streams(fam, engine: str):
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
    got = serve(pair[0](tbank, EngineConfig(**kw)))
    want = serve(pair[1](jbank, JaxEngineConfig(**kw)))
    assert got == want and all(len(s) == 4 for s in got)


@pytest.mark.parametrize("fam", ["olmo_1b", "gemma_7b", "internvl2_76b"], indirect=True)
def test_paged_streams_match_jax(fam):
    """A two-tier factored bank (keeps 1.0 and 0.5), tiers round-robin, on
    the paged engine with chunked prefill: OLMo (the reference suite's
    model), Gemma (GeGLU, the widest heads) and the VLM (Qwen1.5's biases
    and Phi-3's GQA ratio change no engine code; the CPU suite's time is a
    budget)."""
    _streams(fam, "paged")


@pytest.mark.parametrize("fam", ["olmo_1b", "internvl2_76b"], indirect=True)
def test_slot_padded_streams_match_jax(fam):
    """The same bank on the slot-padded engine, for the VLM and the
    Llama-shaped OLMo (the other variants run the same engine code; the CPU
    suite's time is a budget)."""
    _streams(fam, "batched")
