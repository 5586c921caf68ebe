"""The balanced causal scheme in the port (``models/flash_balanced.py``)
against the JAX package's ``balanced_causal_fwd``: the output and the
log-sum-exp in JAX's layout, for even and odd numbers of q chunks, GQA and a
causal offset; gradients under ``causal_scheme='balanced'`` equal the full
scheme's, through ``flash_attention_vjp`` and through a model's loss; and
the config accepts only the two schemes.

Inputs come from numpy seeds; f32 throughout. Tolerance: 1e-5 absolute and
relative against JAX (both sum each chunk's kv blocks in the same order),
1e-5 between the schemes (the balanced forward skips the blocks above the
diagonal that the full scheme also skips, so only rounding separates them).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash_balanced import balanced_causal_fwd as jax_balanced
from repro_torch.configs import base, get_arch
from repro_torch.models import model as model_lib
from repro_torch.models.flash_balanced import balanced_causal_fwd
from repro_torch.models.flash_vjp import flash_attention_vjp

FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tensors are tiny, and under a loaded suite
    more threads only contend with the other workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

CASES = [  # b, hq, hkv, t, q_block, causal_offset
    (2, 2, 2, 32, 8, 0),     # nq = 4 (even)
    (1, 4, 2, 24, 8, 0),     # nq = 3 (odd: the middle chunk is its own partner), GQA 2
    (2, 6, 2, 40, 8, 5),     # nq = 5, GQA 3, a causal offset
    (1, 2, 1, 16, 32, 0),    # q_block above T: one chunk
]


def qkv(b, hq, hkv, t, d=8, seed=0):
    rng = np.random.default_rng(seed + t)
    return (rng.standard_normal((b, hq, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32))


@pytest.mark.parametrize("b,hq,hkv,t,q_block,offset", CASES)
def test_balanced_forward_matches_jax(b, hq, hkv, t, q_block, offset):
    q, k, v = qkv(b, hq, hkv, t)
    fwd = jax.jit(lambda q_, k_, v_: jax_balanced(q_, k_, v_, q_block, offset),
                  compiler_options=FAST_COMPILE)
    want_out, want_lse = fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = balanced_causal_fwd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), q_block, offset)
    assert out.shape == (b, hq, t, 8) and lse.shape == want_lse.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **TOL)


@pytest.mark.parametrize("b,hq,hkv,t,q_block,offset", [c for c in CASES if c[5] == 0])
def test_balanced_gradients_equal_full(b, hq, hkv, t, q_block, offset):
    """Output and the q/k/v gradients of a random linear functional of it:
    the balanced forward saves the full scheme's residuals, so the backward
    is the same."""
    q, k, v = qkv(b, hq, hkv, t, seed=3)
    w = torch.from_numpy(np.random.default_rng(4).standard_normal((b, hq, t, 8))
                         .astype(np.float32))
    runs = {}
    for scheme in ("full", "balanced"):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        out = flash_attention_vjp(tq, tk, tv, True, q_block, q_block, scheme=scheme)
        (out * w).sum().backward()
        runs[scheme] = (out.detach(), tq.grad, tk.grad, tv.grad)
    for got, want in zip(runs["balanced"], runs["full"]):
        torch.testing.assert_close(got, want, **TOL)


def test_balanced_falls_back_where_it_does_not_apply():
    """Ragged T (not a multiple of the q block) and non-causal attention take
    the full scheme's forward, as in JAX: the numbers equal it exactly."""
    q, k, v = (torch.from_numpy(a) for a in qkv(1, 2, 2, 20))
    for causal in (True, False):
        torch.testing.assert_close(
            flash_attention_vjp(q, k, v, causal, 8, 8, scheme="balanced"),
            flash_attention_vjp(q, k, v, causal, 8, 8), rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["salaad_llama_60m", "zamba2_2p7b"])
def test_model_loss_and_grads_equal_full(arch):
    """The transformer and the hybrid pass ``cfg.causal_scheme`` down: the
    loss and its gradient with respect to the q projection agree between the
    schemes (T = 32 in chunks of 8)."""
    full = dataclasses.replace(get_arch(arch).reduced(), attn_q_block=8, attn_kv_block=8,
                               param_dtype=torch.float32)
    params = model_lib.init_params(full, seed=0, device="cpu")
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, full.vocab_size, (2, 32)))
             for k in ("tokens", "labels")}
    q_leaf = params["shared_attn"]["q"] if arch.startswith("zamba") else params["layers"]["q"]
    runs = []
    for scheme in ("full", "balanced"):
        cfg = dataclasses.replace(full, causal_scheme=scheme)
        q = q_leaf.clone().requires_grad_(True)
        if arch.startswith("zamba"):
            p = {**params, "shared_attn": {**params["shared_attn"], "q": q}}
        else:
            p = {**params, "layers": {**params["layers"], "q": q}}
        loss, _ = model_lib.loss_fn(p, batch, cfg)
        loss.backward()
        runs.append((loss.detach(), q.grad))
    torch.testing.assert_close(runs[1][0], runs[0][0], **TOL)
    torch.testing.assert_close(runs[1][1], runs[0][1], **TOL)


def test_config_accepts_only_the_two_schemes():
    cfg = get_arch("salaad_llama_60m")
    assert dataclasses.replace(cfg, causal_scheme="balanced").causal_scheme == "balanced"
    with pytest.raises(ValueError, match="bogus"):
        base.ArchConfig(name="x", family="dense", num_layers=2, d_model=64,
                        causal_scheme="bogus")
