"""The port's Mamba2 LM (``mamba2_370m``, family ssm) and Whisper-style
encoder-decoder (``whisper_small``, family encdec) against the JAX package at
``.reduced()``: the forward, loss and gradients, prefill plus decode steps
against JAX's caches, the SLR block list, the JAX support matrix's formats
(and its two failing cells, which raise), and greedy streams of a two-tier
bank on ``ReferenceEngine``, the engine both families serve through.

The JAX side is built from ``PRNGKey(0)`` (norm leaves perturbed so they
matter) with one exact-SVD ADMM sweep and carried over through
``repro_torch.bridge``; TF32 is off. Logits within 1e-5 of max |logit|
(f32); token streams equal exactly.
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
from repro.models import encdec as jax_encdec
from repro.models import model as jax_model
from repro.serving.deployed import DeployedModel as JaxDeployedModel
from repro.serving.elastic import ModelBank as JaxModelBank
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.engine import ReferenceEngine as JaxReferenceEngine
from repro_torch import bridge
from repro_torch.configs import base
from repro_torch.core.selection import SelectionConfig, select_blocks
from repro_torch.models import encdec
from repro_torch.models import model as model_lib
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.elastic import ModelBank
from repro_torch.serving.engine import (
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
    ServingEngine,
)

ARCHS = ["mamba2_370m", "whisper_small"]
# the JAX support matrix: formats that serve, and the one that raises
SERVES = {"mamba2_370m": ("fused", "dense", "factored"),
          "whisper_small": ("bsr", "dense", "factored")}
RAISES = {"mamba2_370m": "bsr", "whisper_small": "fused"}
PROMPTS = [[5, 7, 11], [3, 1, 4, 1, 5], [9, 2]]


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


def perturb(params, seed: int):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "norm" in name or "bias" in name:
            return x + jnp.asarray(rng.standard_normal(x.shape, np.float32) * 0.1, x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


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
    rng = np.random.default_rng(2)
    return SimpleNamespace(
        arch=arch, cfg=cfg, tcfg=base.get_arch(arch).reduced(), params=params, state=state,
        blocks=blocks, tparams=tparams,
        tstate=bridge.slr_state_from_numpy(to_numpy(state), "cpu"),
        tblocks=select_blocks(tparams, SelectionConfig(min_dim=16)),
        tokens=rng.integers(0, 256, (2, 16)).astype(np.int32),
        labels=rng.integers(0, 256, (2, 16)).astype(np.int32),
        frames=(rng.standard_normal((2, cfg.encoder_seq, cfg.d_model), np.float32) * 0.1
                if cfg.family == "encdec" else None))


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    return build(request.param)


def batches(fam, t=16):
    jb = {"tokens": jnp.asarray(fam.tokens[:, :t]), "labels": jnp.asarray(fam.labels[:, :t])}
    tb = {"tokens": torch.from_numpy(fam.tokens[:, :t]).long(),
          "labels": torch.from_numpy(fam.labels[:, :t]).long()}
    if fam.frames is not None:
        jb["frames"], tb["frames"] = jnp.asarray(fam.frames), torch.from_numpy(fam.frames)
    return jb, tb


# ---------------------------------------------------------------- models ---


def test_forward_loss_and_gradients_match_jax(fam):
    jb, tb = batches(fam)
    got, _ = model_lib._forward(fam.tparams, tb, fam.tcfg)
    want, _, _ = jitted(jax_model._forward, fam.cfg)(fam.params, jb)
    assert got.shape == (2, 16, 256)
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
    loss, metrics = model_lib.loss_fn(tparams, tb, fam.tcfg)
    jloss, _ = jitted(jax_model.loss_fn, fam.cfg)(fam.params, jb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    assert float(metrics["aux"]) == 0.0
    loss.backward()
    assert all(v.grad is not None and torch.isfinite(v.grad).all() for v in leaves)


def prefill_f32(fam, jb, tb):
    """Prefill into f32 caches on both sides. The encoder-decoder's
    ``model.prefill`` builds a bf16 cache whatever ``cache_dtype`` says (in
    both packages, held below), so its f32 cache is built from the module's
    parts, as ``model.prefill`` composes them."""
    if fam.cfg.family != "encdec":
        got, tc = model_lib.prefill(fam.tparams, tb, fam.tcfg, max_len=24,
                                    cache_dtype=torch.float32)
        want, jc = jitted(jax_model.prefill, fam.cfg, max_len=24, cache_dtype=jnp.float32)(
            fam.params, jb)
        return got, tc, want, jc
    enc = encdec.encode(fam.tparams, tb["frames"], fam.tcfg)
    tc = encdec.init_encdec_cache(fam.tparams, fam.tcfg, 2, 24, enc_out=enc,
                                  dtype=torch.float32)
    got, tc = encdec.decode_stack(fam.tparams, tb["tokens"], None, fam.tcfg, cache=tc)

    def jax_prefill(params, jb, cfg):
        enc = jax_encdec.encode(params, jb["frames"], cfg)
        jc = jax_encdec.init_encdec_cache(params, cfg, 2, 24, enc_out=enc, dtype=jnp.float32)
        return jax_encdec.decode_stack(params, jb["tokens"], None, cfg, cache=jc)

    want, jc = jitted(jax_prefill, fam.cfg)(fam.params, jb)
    return got, tc, want, jc


def test_prefill_and_decode_match_jax(fam):
    """Prefill 12 tokens into an f32 cache, then four decode steps: every
    step's logits and the final caches equal JAX's, and the last step equals
    the full forward's row (JAX's ``test_decode_consistency``)."""
    jb, tb = batches(fam, 12)
    got, tc, want, jc = prefill_f32(fam, jb, tb)
    assert_logits(got, want)
    for i in range(12, 16):
        got, tc = model_lib.decode_step(fam.tparams, torch.from_numpy(fam.tokens[:, i:i + 1]),
                                        tc, fam.tcfg)
        want, jc = jitted(jax_model.decode_step, fam.cfg)(
            fam.params, jnp.asarray(fam.tokens[:, i:i + 1]), jc)
        assert_logits(got, want)
    for f in tc._fields:
        if f != "length":
            np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                       atol=1e-5, rtol=1e-5, err_msg=f)
    assert tc.length == int(jc.length) == 16
    _, tb = batches(fam)
    full, _ = model_lib._forward(fam.tparams, tb, fam.tcfg)
    assert_logits(got[:, 0], full[:, -1].numpy())


def test_encdec_prefill_cache_is_bf16_as_in_jax():
    """``model.prefill`` of the encoder-decoder: a bf16 cache in both
    packages whatever ``cache_dtype`` says; its logits agree to bf16 (a
    cross head within one bf16 rounding of the other side's moves a logit by
    up to ~1e-4)."""
    cfg = jax_base.get_arch("whisper_small").reduced()
    tcfg = base.get_arch("whisper_small").reduced()
    params = fast_jit(jax_model.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (2, 12)).astype(np.int32)
    frames = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model), np.float32) * 0.1
    got, tc = model_lib.prefill(bridge.params_from_numpy(to_numpy(params), "cpu"),
                                {"tokens": torch.from_numpy(toks).long(),
                                 "frames": torch.from_numpy(frames)}, tcfg, max_len=24,
                                cache_dtype=torch.float32)
    want, jc = jitted(jax_model.prefill, cfg, max_len=24, cache_dtype=jnp.float32)(
        params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    assert tc.cross_k.dtype == torch.bfloat16 and jc.cross_k.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-3)


def test_cache_layouts_match_jax(fam):
    """The reference engine's cache (the encdec one with zero cross heads,
    as the JAX package builds it without frames); the transformer-only
    entries raise."""
    got = model_lib.init_cache(fam.tcfg, 3, 20, dtype=torch.float32, device="cpu")
    want = jax_model.init_cache(fam.cfg, 3, 20, dtype=jnp.float32)
    assert got._fields == want._fields
    for f in got._fields:
        if f != "length":
            assert tuple(getattr(got, f).shape) == tuple(getattr(want, f).shape), f
            assert not getattr(got, f).any()
    with pytest.raises(ValueError, match="KV-cache family"):
        model_lib.init_paged_cache(fam.tcfg, 2, 8, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="KV-cache family"):
        model_lib.init_cache(fam.tcfg, 2, 8, device="cpu", per_slot=True)


def test_sinusoids_match_jax():
    """The encoder's interleaved table and the decoder's concatenated one."""
    from repro.models import layers as jax_layers
    from repro_torch.models import layers

    np.testing.assert_array_equal(layers.sinusoidal_positions(20, 16, 3).numpy(),
                                  np.asarray(jax_layers.sinusoidal_positions(20, 16, 3)))
    cfg = jax_base.get_arch("whisper_small").reduced()
    params = fast_jit(jax_model.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(3))
    zero = jax.tree_util.tree_map(jnp.zeros_like, params)
    toks = np.zeros((1, 5), np.int32)
    enc = np.zeros((1, cfg.encoder_seq, cfg.d_model), np.float32)
    # with every weight zero, the logits are the final norm of the positions
    want, _ = jitted(jax_encdec.decode_stack, cfg, position_offset=7)(
        zero, jnp.asarray(toks), jnp.asarray(enc))
    got, _ = encdec.decode_stack(bridge.params_from_numpy(to_numpy(zero), "cpu"),
                                 torch.from_numpy(toks).long(), torch.from_numpy(enc),
                                 base.get_arch("whisper_small").reduced(), position_offset=7)
    assert_logits(got, want)


def test_blocks_match_jax(fam):
    got = [(b.name, b.shape, b.stack_dims, b.is_embedding) for b in fam.tblocks]
    want = [(b.name, tuple(b.shape), tuple(b.stack_dims), b.is_embedding) for b in fam.blocks]
    assert got == want
    assert not any("lm_head" in b.name for b in fam.tblocks)


# ------------------------------------------------------------ deployment ---


def jax_forward(jdm, fam):
    jb, _ = batches(fam, 8)
    jb.pop("labels")
    return jitted(jax_model._forward, fam.cfg)(jdm.params, jb)[0]


def test_deployed_formats_match_jax(fam):
    """Every format the JAX package serves these families in: logits, and
    byte reports except for the encoder-decoder's bsr, whose stacked sites
    the port holds as per-layer block-CSC weights, so they take the
    block-CSC and low-rank kernels (JAX keeps them stacked in factored COO
    form, so the stored bytes differ)."""
    _, tb = batches(fam, 8)
    tb.pop("labels")
    for fmt in SERVES[fam.arch]:
        got = DeployedModel.build(fam.tcfg, fam.tparams, fam.tstate, fam.tblocks, fmt=fmt,
                                  bsr_block=32)
        want = JaxDeployedModel.build(fam.cfg, fam.params, fam.state, fam.blocks, fmt=fmt,
                                      bsr_block=32)
        if (fam.arch, fmt) != ("whisper_small", "bsr"):
            assert got.param_bytes() == want.param_bytes(), fmt
        assert_logits(got.forward(**tb), jax_forward(want, fam), fmt)
    if fam.arch == "whisper_small":
        dm = DeployedModel.build(fam.tcfg, fam.tparams, fam.tstate, fam.tblocks, fmt="bsr",
                                 bsr_block=32)
        q = dm.params["decoder"]["cross"]["q"]
        assert isinstance(q, list) and len(q) == 4 and q[0].s_bsr is not None
        assert len(dm.params["encoder"]["self"]["o"]) == 2


def test_the_failing_cells_raise(fam):
    """The support matrix's failing cell fails in both packages: the port's
    build says why."""
    fmt = RAISES[fam.arch]
    with pytest.raises(ValueError, match=f"fmt='{fmt}' cannot serve the {fam.cfg.family}"):
        DeployedModel.build(fam.tcfg, fam.tparams, fam.tstate, fam.tblocks, fmt=fmt,
                            bsr_block=32)
    with pytest.raises(Exception):
        jdm = JaxDeployedModel.build(fam.cfg, fam.params, fam.state, fam.blocks, fmt=fmt,
                                     bsr_block=32)
        jax_forward(jdm, fam)


# --------------------------------------------------------------- serving ---


def serve(engine, max_new=4):
    uids = [engine.submit(p, max_new_tokens=max_new, tier=i % 2) for i, p in enumerate(PROMPTS)]
    by_uid = {r.uid: list(r.out_tokens) for r in engine.run()}
    return [by_uid[u] for u in uids], engine.decode_calls


def test_reference_engine_streams_match_jax(fam):
    """A two-tier bank (keeps 1.0 and 0.5) in the family's first serving
    format, tiers round-robin on two slots."""
    fmt = SERVES[fam.arch][0]
    tbank = ModelBank.build(fam.tcfg, fam.tparams, fam.tstate, fam.tblocks, (1.0, 0.5),
                            fmt=fmt, bsr_block=32)
    jbank = JaxModelBank.build(fam.cfg, fam.params, fam.state, fam.blocks, (1.0, 0.5),
                               fmt=fmt, bsr_block=32)
    got = serve(ReferenceEngine(tbank, EngineConfig(max_slots=2, max_len=16)))
    want = serve(JaxReferenceEngine(jbank, JaxEngineConfig(max_slots=2, max_len=16)))
    assert got == want
    assert got[1] == sum(len(p) - 1 + 4 for p in PROMPTS)


@pytest.mark.parametrize("cls", [PagedServingEngine, ServingEngine])
def test_batched_engines_refuse(fam, cls):
    bank = ModelBank.single(fam.tcfg, fam.tparams)
    with pytest.raises(ValueError, match="use ReferenceEngine for ssm/hybrid/encdec"):
        cls(bank, EngineConfig())
    assert fam.cfg.family in ReferenceEngine.capabilities()["families"]


def test_whisper_reference_cache_has_zero_cross_heads():
    cfg = dataclasses.replace(base.get_arch("whisper_small").reduced())
    cache = model_lib.init_cache(cfg, 2, 8, device="cpu")
    assert cache.cross_k.shape == (4, 2, 2, 16, 32) and not cache.cross_k.any()
