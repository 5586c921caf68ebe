"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
This file imports no JAX, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances: f32 1e-4 (the kernel and the plain version sum in different
orders); bf16 3e-2 relative to the output scale (inputs rounded to bf16,
products summed in f32, one rounding of the output).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.admm import SalaadConfig, admm_update, init_slr_state
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bsr_matmul import bsr_from_dense
from repro_torch.kernels.slr_matmul import stack_bsr
from repro_torch.models import model as model_lib
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.engine import EngineConfig, PagedServingEngine
from repro_torch.tree import tree_map

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_close(got, want, dtype):
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= TOL[dtype] * scale, (err, scale)


def make_stack(rng, num_l, k, m, bs, occupancy, device, dtype):
    """Layer-stacked block-CSC S with a different live-tile pattern per layer
    (ragged counts < MAXB), ragged K/M allowed."""
    mats = []
    for layer in range(num_l):
        ib, jb = -(-k // bs), -(-m // bs)
        live = rng.random((ib, jb)) < occupancy * (layer + 1) / num_l
        dense = rng.standard_normal((ib * bs, jb * bs)).astype(np.float32)
        dense *= np.repeat(np.repeat(live, bs, 0), bs, 1)
        mats.append(bsr_from_dense(dense[:k, :m], bs))
    st = stack_bsr(mats)
    return dataclasses.replace(st, counts=st.counts.to(device), rows=st.rows.to(device),
                               vals=st.vals.to(device, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,t,k,m,r", [
    (8, 1, 40, 36, 5), (16, 8, 64, 48, 16), (32, 33, 512, 1376, 128),
    (64, 100, 200, 130, 17), (128, 512, 512, 512, 128), (32, 7, 96, 64, 200),
])
def test_slr_matmul_stacked_matches_plain(cuda, dtype, bs, t, k, m, r):
    rng = np.random.default_rng(bs + t)
    num_l = 3
    x = torch.from_numpy(rng.standard_normal((t, k), dtype=np.float32)).to(cuda, dtype)
    p = torch.from_numpy(rng.standard_normal((num_l, k, r), dtype=np.float32) / 8).to(cuda, dtype)
    vt = torch.from_numpy(rng.standard_normal((num_l, r, m), dtype=np.float32) / 8).to(cuda, dtype)
    stack = make_stack(rng, num_l, k, m, bs, 0.6, cuda, dtype)
    for layer in range(num_l):
        before = ops.launch_counts()["slr_matmul_stacked"]
        got = ops.slr_matmul_stacked(x, p, vt, stack, layer)
        torch.cuda.synchronize()
        assert ops.launch_counts()["slr_matmul_stacked"] == before + 1
        assert_close(got, ref.slr_matmul_stacked_ref(x, p, vt, stack, layer), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slr_matmul_corners(cuda, dtype):
    """Empty S runs the low-rank kernel; r == 0 runs the fused kernel with
    rank-1 zero factors."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((9, 64), dtype=np.float32)).to(cuda, dtype)
    p = torch.from_numpy(rng.standard_normal((2, 64, 12), dtype=np.float32)).to(cuda, dtype)
    vt = torch.from_numpy(rng.standard_normal((2, 12, 40), dtype=np.float32)).to(cuda, dtype)
    stack = make_stack(rng, 2, 64, 40, 8, 0.5, cuda, dtype)
    empty = make_stack(rng, 2, 64, 40, 8, 0.0, cuda, dtype)
    assert empty.empty
    ops.reset_launch_counts()
    got = ops.slr_matmul_stacked(x, p, vt, empty, 1)
    assert ops.launch_counts()["lowrank_matmul"] == 1
    assert_close(got, ref.lowrank_matmul_ref(x, p[1], vt[1]), dtype)
    got = ops.slr_matmul_stacked(x, None, None, stack, 0)
    assert ops.launch_counts()["slr_matmul_stacked"] == 1
    assert_close(got, ref.slr_matmul_stacked_ref(x, None, None, stack, 0), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,k,m,r", [(1, 512, 512, 128), (512, 512, 1376, 128), (37, 70, 90, 130)])
def test_lowrank_matmul_matches_plain(cuda, dtype, t, k, m, r):
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((t, k), dtype=np.float32)).to(cuda, dtype)
    p = torch.from_numpy(rng.standard_normal((k, r), dtype=np.float32) / 8).to(cuda, dtype)
    vt = torch.from_numpy(rng.standard_normal((r, m), dtype=np.float32) / 8).to(cuda, dtype)
    assert_close(ops.lowrank_matmul(x, p, vt), ref.lowrank_matmul_ref(x, p, vt), dtype)


def make_pool(rng, b, hq, hkv, d, bs, nb, n, device, dtype):
    k_pages = torch.from_numpy(rng.standard_normal((n, hkv, bs, d), dtype=np.float32))
    v_pages = torch.from_numpy(rng.standard_normal((n, hkv, bs, d), dtype=np.float32))
    table = np.full((b, nb), n, np.int32)
    perm = rng.permutation(n)
    lengths = np.zeros(b, np.int32)
    used = 0
    for i in range(b):
        # lengths at page edges, mid-page and 0; tails unmapped
        length = [0, bs - 1, bs, 2 * bs + 3, nb * bs - 1][i % 5] if nb * bs > 2 * bs + 3 \
            else i % (nb * bs)
        pages = min(length // bs + 1, nb, n - used)
        table[i, :pages] = perm[used:used + pages]
        used += pages
        lengths[i] = length
    return (k_pages.to(device, dtype), v_pages.to(device, dtype),
            torch.from_numpy(table).to(device), torch.from_numpy(lengths).to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,d,bs,nb", [(5, 4, 2, 32, 4, 6), (8, 8, 8, 64, 16, 32),
                                               (3, 32, 2, 128, 8, 5)])
def test_paged_attention_matches_plain(cuda, dtype, b, hq, hkv, d, bs, nb):
    rng = np.random.default_rng(b * d)
    n = b * nb + 2
    kp, vp, table, lengths = make_pool(rng, b, hq, hkv, d, bs, nb, n, cuda, dtype)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), dtype=np.float32)).to(cuda, dtype)
    assert_close(ops.paged_attention(q, kp, vp, table, lengths),
                 ref.paged_attention_ref(q, kp, vp, table, lengths), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,kq,d,bs,nb", [(4, 4, 2, 3, 32, 4, 8), (8, 8, 8, 64, 64, 16, 32),
                                                  (2, 6, 2, 21, 16, 8, 9)])
def test_paged_attention_kquery_matches_plain(cuda, dtype, b, hq, hkv, kq, d, bs, nb):
    rng = np.random.default_rng(kq)
    n = b * nb + 1
    kp, vp, table, lengths = make_pool(rng, b, hq, hkv, d, bs, nb, n, cuda, dtype)
    # keep the window inside the table so every query has mapped history
    lengths = torch.clamp(lengths, max=nb * bs - kq)
    q = torch.from_numpy(rng.standard_normal((b, hq, kq, d), dtype=np.float32)).to(cuda, dtype)
    assert_close(ops.paged_attention_kquery(q, kp, vp, table, lengths),
                 ref.paged_attention_kquery_ref(q, kp, vp, table, lengths), dtype)


def test_wrappers_reject_bad_inputs(cuda):
    x = torch.zeros((4, 8), device=cuda)
    p = torch.zeros((8, 2), device=cuda)
    vt = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError):
        ops.lowrank_matmul(x.t(), p, vt)             # not contiguous
    with pytest.raises(TypeError):
        ops.lowrank_matmul(x, p.double(), vt)        # dtype mismatch
    with pytest.raises(ValueError):
        ops.lowrank_matmul(x, p.cpu(), vt)           # mixed devices


def test_engine_streams_on_card_match_cpu(cuda):
    """Reduced Llama, fused format, Pallas-path kernels, chunked prefill and a
    pool tight enough to evict: the card's greedy streams equal the plain
    versions' on the CPU."""
    cfg = dataclasses.replace(get_arch("salaad_llama_60m").reduced(), kernel_impl="pallas")
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    scfg = SalaadConfig(rho_constant=5.0, exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    for step in range(3):
        state, _ = admm_update(params, state, blocks, scfg, step)
    prompts = [[5, 7, 11], [3, 1], list(range(2, 40)), [8, 8, 2], [1, 2, 3, 4, 5, 6]]
    streams = {}
    for dev in ("cpu", "cuda"):
        moved = tree_map(lambda t: t.to(dev), (params, state))
        dm = DeployedModel.build(cfg, *moved, blocks, fmt="fused", bsr_block=32)
        for name, ecfg in {
            "roomy": EngineConfig(max_slots=3, max_len=64, block_size=8, prefill_chunk=16),
            "tight": EngineConfig(max_slots=2, max_len=48, block_size=4, num_blocks=12,
                                  decode_reserve=1, prefill_chunk=8),
        }.items():
            ops.reset_launch_counts()
            eng = PagedServingEngine(dm, ecfg)
            for pr in prompts:
                eng.submit(pr, max_new_tokens=6)
            streams[dev, name] = {r.uid: r.out_tokens for r in eng.run()}
            counts = ops.launch_counts()
            if dev == "cuda":
                assert counts["slr_matmul_stacked"] > 0
                assert counts["paged_attention"] > 0 and counts["paged_attention_kquery"] > 0
                if name == "tight":
                    assert eng.evictions >= 1
            else:
                assert not any(counts.values())
    assert streams["cuda", "roomy"] == streams["cpu", "roomy"]
    assert streams["cuda", "tight"] == streams["cpu", "tight"]
