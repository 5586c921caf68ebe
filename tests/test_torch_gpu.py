"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device.
This file imports no JAX, so it also runs where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q \
        -o "markers=gpu: needs a CUDA card"

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
from repro_torch.core.hpa import hpa_keep_ratio
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bsr_matmul import bsr_from_dense
from repro_torch.kernels.slr_matmul import BLOCK_SIZES, stack_bsr
from repro_torch.models import model as model_lib
from repro_torch.serving.adapters import AdapterBank, adapterize
from repro_torch.serving.deployed import DeployedModel
from repro_torch.serving.elastic import ModelBank
from repro_torch.core.selection import SelectionConfig
from repro_torch.serving.engine import EngineConfig, PagedServingEngine, ReferenceEngine
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


def make_bsr(rng, k, m, bs, occupancy, device, dtype):
    ib, jb = -(-k // bs), -(-m // bs)
    live = rng.random((ib, jb)) < occupancy
    dense = rng.standard_normal((ib * bs, jb * bs)).astype(np.float32)
    dense *= np.repeat(np.repeat(live, bs, 0), bs, 1)
    mat = bsr_from_dense(dense[:k, :m], bs, device=device)
    return dataclasses.replace(mat, vals=mat.vals.to(dtype))


DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("xdt,wdt", DTYPE_PAIRS, ids=["f32", "bf16", "bf16-f32"])
@pytest.mark.parametrize("bs,t,k,m,r,occ", [
    (8, 1, 40, 36, 5, 0.5), (16, 8, 64, 48, 16, 1.0), (32, 37, 300, 260, 130, 0.5),
    (64, 9, 200, 130, 17, 0.7), (128, 1, 2560, 2560, 640, 1.0), (128, 8, 10240, 300, 200, 0.3),
])
def test_slr_matmul_unstacked_matches_plain(cuda, xdt, wdt, bs, t, k, m, r, occ):
    """The unstacked fused SLR kernel (the hybrid's shared block) with both
    parts live, ragged T/K/M, per-column counts below MAXB and more than one
    split of K, tables in x's dtype or f32 under bf16 x."""
    rng = np.random.default_rng(bs + t + k)
    x = torch.from_numpy(rng.standard_normal((t, k), dtype=np.float32)).to(cuda, xdt)
    p = torch.from_numpy(rng.standard_normal((k, r), dtype=np.float32) / 8).to(cuda, wdt)
    vt = torch.from_numpy(rng.standard_normal((r, m), dtype=np.float32) / 8).to(cuda, wdt)
    mat = make_bsr(rng, k, m, bs, occ, cuda, wdt)
    ops.reset_launch_counts()
    got = ops.slr_matmul(x, p, vt, mat)
    assert ops.launch_counts()["slr_matmul"] == 1 and got.dtype == xdt
    assert_close(got, ref.slr_matmul_ref(x, p, vt, mat), xdt)


@pytest.mark.parametrize("xdt,wdt", DTYPE_PAIRS, ids=["f32", "bf16", "bf16-f32"])
def test_slr_matmul_unstacked_corners(cuda, xdt, wdt):
    """Empty S runs the low-rank kernel, r == 0 the block-CSC kernel, in every
    dtype pair the hybrid's deployment gives them."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((9, 64), dtype=np.float32)).to(cuda, xdt)
    p = torch.from_numpy(rng.standard_normal((64, 12), dtype=np.float32)).to(cuda, wdt)
    vt = torch.from_numpy(rng.standard_normal((12, 40), dtype=np.float32)).to(cuda, wdt)
    mat = make_bsr(rng, 64, 40, 8, 0.5, cuda, wdt)
    empty = make_bsr(rng, 64, 40, 8, 0.0, cuda, wdt)
    ops.reset_launch_counts()
    assert_close(ops.slr_matmul(x, p, vt, empty), ref.lowrank_matmul_ref(x, p, vt), xdt)
    assert_close(ops.slr_matmul(x, None, None, mat), ref.bsr_matmul_ref(x, mat), xdt)
    counts = ops.launch_counts()
    assert counts["lowrank_matmul"] == 1 and counts["bsr_matmul"] == 1
    assert counts["slr_matmul"] == 0


@pytest.mark.parametrize("xdt,wdt", DTYPE_PAIRS, ids=["f32", "bf16", "bf16-f32"])
@pytest.mark.parametrize("k,m,r,bs,occ", [
    (2560, 10240, 640, 128, 1.0),   # Zamba2's gate site, full S
    (300, 260, 130, 32, 0.5),       # ragged K, M and r
])
def test_slr_matmul_unstacked_is_deterministic(cuda, xdt, wdt, k, m, r, bs, occ):
    """Two calls on the same inputs give bit-identical output (every split
    sum runs in a fixed order), and the wrapper counts one launch per call
    whatever kernels it runs, so 4i's launches-per-decode-call check keeps
    its meaning."""
    rng = np.random.default_rng(k + r)
    p = torch.from_numpy(rng.standard_normal((k, r), dtype=np.float32) / 16).to(cuda, wdt)
    vt = torch.from_numpy(rng.standard_normal((r, m), dtype=np.float32) / 16).to(cuda, wdt)
    mat = make_bsr(rng, k, m, bs, occ, cuda, wdt)
    for t in (1, 8, 37):
        x = torch.from_numpy(rng.standard_normal((t, k), dtype=np.float32)).to(cuda, xdt)
        before = ops.launch_counts()["slr_matmul"]
        first = ops.slr_matmul(x, p, vt, mat)
        second = ops.slr_matmul(x, p, vt, mat)
        torch.cuda.synchronize()
        assert ops.launch_counts()["slr_matmul"] == before + 2
        assert torch.equal(first, second)
        assert_close(first, ref.slr_matmul_ref(x, p, vt, mat), xdt)


def test_slr_matmul_unstacked_rejects_bad_dtypes(cuda):
    x = torch.zeros((2, 16), device=cuda)
    p, vt = torch.zeros((16, 2), device=cuda, dtype=torch.bfloat16), torch.zeros((2, 8), device=cuda)
    mat = make_bsr(np.random.default_rng(0), 16, 8, 8, 1.0, cuda, torch.float32)
    with pytest.raises(TypeError, match="share one dtype"):
        ops.slr_matmul(x, p, vt, mat)
    with pytest.raises(TypeError, match="bfloat16 activations over float32"):
        ops.slr_matmul(x, p.float().to(torch.bfloat16), vt.to(torch.bfloat16),
                       dataclasses.replace(mat, vals=mat.vals.to(torch.bfloat16)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,t,k,m,r,layers", [
    (8, 1, 40, 36, 5, 2), (16, 8, 64, 48, 16, 1), (32, 37, 512, 1376, 128, 8),
    (64, 3, 200, 130, 17, 2), (128, 64, 512, 512, 130, 8), (128, 1, 512, 512, 128, 8),
])
def test_slr_matmul_multi_matches_plain(cuda, dtype, bs, t, k, m, r, layers):
    """Eight slots over three pooled adapters (repeated and permuted ids),
    every layer of the rows, ragged T / K / M; each slot equals the stacked
    kernel on its own rows bit for bit."""
    rng = np.random.default_rng(bs * 3 + t)
    n_tab = 3 * layers
    x = torch.from_numpy(rng.standard_normal((8, t, k), dtype=np.float32)).to(cuda, dtype)
    p = torch.from_numpy(rng.standard_normal((n_tab, k, r), dtype=np.float32) / 8).to(cuda, dtype)
    vt = torch.from_numpy(rng.standard_normal((n_tab, r, m), dtype=np.float32) / 8).to(cuda, dtype)
    stack = make_stack(rng, n_tab, k, m, bs, 0.6, cuda, dtype)
    ids = torch.tensor([2, 0, 1, 1, 0, 2, 2, 0], dtype=torch.int32, device=cuda)
    for layer in range(layers):
        before = ops.launch_counts()["slr_matmul_multi"]
        got = ops.slr_matmul_multi(x, p, vt, stack, ids, layers, layer)
        torch.cuda.synchronize()
        assert ops.launch_counts()["slr_matmul_multi"] == before + 1
        assert_close(got, ref.slr_matmul_multi_ref(x, p, vt, stack, ids, layers, layer), dtype)
        for b in range(8):
            row = int(ids[b]) * layers + layer
            assert torch.equal(got[b], ops.slr_matmul_stacked(x[b].contiguous(), p, vt, stack,
                                                               row))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_fused_rows_ignore_t_and_b(cuda, dtype, bs):
    """A row of y is bit for bit the same whatever call carries it: the
    stacked kernel on x[:t] gives the first t rows of its call on x (T = 70
    spans row tiles of 8 and 32), and slots 0..b-1 of an 8-slot per-slot
    call equal a b-slot call and a call on fewer rows per slot."""
    rng = np.random.default_rng(bs + 7)
    k, m, r, layers = 300, 5 * bs - 3, 40, 2
    n_tab = 3 * layers
    p = torch.from_numpy(rng.standard_normal((n_tab, k, r), dtype=np.float32) / 8).to(cuda, dtype)
    vt = torch.from_numpy(rng.standard_normal((n_tab, r, m), dtype=np.float32) / 8).to(cuda, dtype)
    stack = make_stack(rng, n_tab, k, m, bs, 0.6, cuda, dtype)
    x = torch.from_numpy(rng.standard_normal((70, k), dtype=np.float32)).to(cuda, dtype)
    full = ops.slr_matmul_stacked(x, p, vt, stack, 3)
    for t in (1, 3, 8, 9, 37, 64):
        assert torch.equal(ops.slr_matmul_stacked(x[:t].contiguous(), p, vt, stack, 3), full[:t])
    ids = torch.tensor([2, 0, 1, 1, 0, 2, 2, 0], dtype=torch.int32, device=cuda)
    xs = torch.from_numpy(rng.standard_normal((8, 9, k), dtype=np.float32)).to(cuda, dtype)
    full = ops.slr_matmul_multi(xs, p, vt, stack, ids, layers, 1)
    for b in (1, 3, 5):
        got = ops.slr_matmul_multi(xs[:b].contiguous(), p, vt, stack, ids[:b].contiguous(),
                                   layers, 1)
        assert torch.equal(got, full[:b])
    for t in (1, 4):
        got = ops.slr_matmul_multi(xs[:, :t].contiguous(), p, vt, stack, ids, layers, 1)
        assert torch.equal(got, full[:, :t])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_slr_matmul_multi_corners(cuda, dtype):
    """Empty S: one launch of the low-rank instance, each slot equal to the
    low-rank kernel bit for bit; r == 0: zero factors; a row outside the
    pool gives NaN rows, never a read past it."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 9, 64), dtype=np.float32)).to(cuda, dtype)
    p = torch.from_numpy(rng.standard_normal((6, 64, 12), dtype=np.float32)).to(cuda, dtype)
    vt = torch.from_numpy(rng.standard_normal((6, 12, 40), dtype=np.float32)).to(cuda, dtype)
    stack = make_stack(rng, 6, 64, 40, 8, 0.5, cuda, dtype)
    empty = make_stack(rng, 6, 64, 40, 8, 0.0, cuda, dtype)
    ids = torch.tensor([5, 0, 5, 2], dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    got = ops.slr_matmul_multi(x, p, vt, empty, ids)
    assert ops.launch_counts()["slr_matmul_multi"] == 1
    for b, i in enumerate(ids.tolist()):
        assert torch.equal(got[b], ops.lowrank_matmul(x[b].contiguous(), p[i], vt[i]))
    got = ops.slr_matmul_multi(x, None, None, stack, ids)
    assert_close(got, ref.slr_matmul_multi_ref(x, torch.zeros_like(p[..., :1]),
                                               torch.zeros_like(vt[:, :1]), stack, ids), dtype)
    bad = ops.slr_matmul_multi(x, p, vt, stack, torch.tensor([0, 6, 1, 2], dtype=torch.int32,
                                                             device=cuda))
    torch.cuda.synchronize()
    assert bool(torch.isnan(bad[1]).all()) and bool(torch.isfinite(bad[[0, 2, 3]]).all())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,t,n,m,occ", [
    (8, 1, 40, 36, 0.5), (16, 8, 64, 48, 0.7), (32, 33, 512, 1376, 0.4),
    (32, 512, 1376, 512, 1.0), (64, 100, 200, 130, 0.6), (128, 512, 512, 512, 1.0),
    (128, 3, 512, 512, 0.3),
])
def test_bsr_matmul_matches_plain(cuda, dtype, bs, t, n, m, occ):
    """Every deployed block size, ragged T / n / m and per-column counts below
    MAXB."""
    rng = np.random.default_rng(bs * 7 + t)
    mat = make_stack(rng, 1, n, m, bs, occ, cuda, dtype).at_layer(0)
    x = torch.from_numpy(rng.standard_normal((t, n), dtype=np.float32)).to(cuda, dtype)
    before = ops.launch_counts()["bsr_matmul"]
    got = ops.bsr_matmul(x, mat)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bsr_matmul"] == before + 1
    assert_close(got, ref.bsr_matmul_ref(x, mat), dtype)


def test_bsr_matmul_empty_s_launches_nothing(cuda):
    rng = np.random.default_rng(0)
    mat = make_stack(rng, 1, 64, 40, 8, 0.0, cuda, torch.float32).at_layer(0)
    assert mat.empty
    ops.reset_launch_counts()
    got = ops.bsr_matmul(torch.ones((5, 64), device=cuda), mat)
    assert ops.launch_counts()["bsr_matmul"] == 0 and not bool(got.any())


@pytest.mark.parametrize("dtype,tail", [(torch.float32, 64), (torch.bfloat16, 64),
                                         (torch.int8, 64), (torch.float32, 1)])
def test_page_copy_matches_plain(cuda, dtype, tail):
    """Payload pools of each type and the (..., 1) scale pools; page 0 is a
    real destination while (0, 0) pads ride along."""
    rng = np.random.default_rng(tail)
    pool = torch.from_numpy(rng.standard_normal((8, 40, 8, 16, tail), dtype=np.float32) * 50)
    pool = pool.to(cuda, dtype)
    src = torch.tensor([5, 9, 13, 0, 0, 0, 0, 0], dtype=torch.int32, device=cuda)
    dst = torch.tensor([0, 30, 17, 0, 0, 0, 0, 0], dtype=torch.int32, device=cuda)
    want = ref.page_copy_ref(pool.clone(), src, dst)
    ops.reset_launch_counts()
    got = ops.page_copy(pool, src, dst)
    torch.cuda.synchronize()
    assert got.data_ptr() == pool.data_ptr()                 # in place
    assert ops.launch_counts()["page_copy"] == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,t,s,d,causal", [
    (2, 4, 2, 16, 16, 32, True), (8, 8, 8, 128, 128, 64, True), (1, 4, 2, 256, 256, 64, False),
    (8, 8, 8, 512, 512, 64, True), (2, 4, 2, 128, 256, 64, True), (1, 2, 1, 48, 48, 256, True),
    (3, 6, 3, 100, 100, 128, False),
    # Zamba2's 32 heads of 80, GQA at D = 80, ragged D (zero-padded to the
    # kernel's head-dim bucket), T != S
    (2, 32, 32, 128, 128, 80, True), (2, 8, 4, 100, 100, 80, False), (2, 8, 4, 256, 256, 80, True),
    (2, 4, 2, 37, 37, 50, True), (2, 4, 2, 256, 256, 20, False), (2, 4, 4, 256, 128, 96, True),
])
def test_flash_attention_matches_plain(cuda, dtype, b, hq, hkv, t, s, d, causal):
    rng = np.random.default_rng(t + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
               for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert_close(got, ref.attention_ref(q, k, v, causal=causal, offset=0), dtype)


def test_flash_attention_rejects_unpadded_lengths(cuda):
    q = torch.zeros((1, 2, 200, 16), device=cuda)
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, q, q)


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


COUNTERS = ("evictions", "tier_switches", "downshift_ticks", "prefix_hits",
            "prefix_hit_tokens", "cow_copies", "reattached_pages")


def test_bank_streams_on_card_match_cpu(cuda):
    """A three-tier bank of the reduced Llama: fused with one-shot prefill on
    the flash kernel, the prefix cache (a copy-on-write repeat) and the
    pressure policy on a tight pool; then the bsr format with chunked
    prefill. Streams and counters on the card equal the CPU's."""
    cfg = dataclasses.replace(get_arch("salaad_llama_60m").reduced(), kernel_impl="pallas")
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    scfg = SalaadConfig(rho_constant=5.0, exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    for step in range(3):
        state, _ = admm_update(params, state, blocks, scfg, step)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 256, 16).tolist()
    prompts = [shared + rng.integers(0, 256, n).tolist() for n in (12, 16, 2, 30, 7)]
    prompts.append(prompts[1])                       # page-aligned repeat: CoW
    runs = {
        "fused": ("fused", EngineConfig(max_slots=3, max_len=64, block_size=8, num_blocks=16,
                                        prefix_cache=True, tier_policy="pressure")),
        "bsr": ("bsr", EngineConfig(max_slots=3, max_len=64, block_size=8,
                                    prefill_chunk=16)),
    }
    want = {"fused": ("flash_attention", "page_copy", "paged_attention",
                      "paged_attention_kquery", "slr_matmul_stacked"),
            "bsr": ("bsr_matmul", "lowrank_matmul", "paged_attention",
                    "paged_attention_kquery")}
    got = {}
    for dev in ("cpu", "cuda"):
        moved = tree_map(lambda t: t.to(dev), (params, state))
        for name, (fmt, ecfg) in runs.items():
            bank = ModelBank.build(cfg, *moved, blocks, (1.0, 0.6, 0.3), fmt=fmt,
                                   bsr_block=32)
            ops.reset_launch_counts()
            eng = PagedServingEngine(bank, ecfg)
            for i, pr in enumerate(prompts):
                eng.submit(pr, max_new_tokens=10, tier=i % 3)
            streams = {r.uid: r.out_tokens for r in eng.run()}
            got[dev, name] = (streams, {c: getattr(eng, c) for c in COUNTERS})
            counts = ops.launch_counts()
            if dev == "cuda":
                assert all(counts[k] > 0 for k in want[name]), counts
            else:
                assert not any(counts.values())
    for name in runs:
        assert got["cuda", name] == got["cpu", name]
    assert got["cuda", "fused"][1]["cow_copies"] > 0


def test_hybrid_bank_streams_on_card_match_cpu(cuda):
    """A two-tier fused bank of the reduced hybrid served by ReferenceEngine:
    the card's streams and decode calls equal the CPU's, and every tier ran
    the unstacked SLR kernel on the card (seven shared-block sites per
    application)."""
    cfg = get_arch("zamba2_2p7b").reduced()
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    scfg = SalaadConfig(selection=SelectionConfig(min_dim=16), exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    for step in range(2):
        state, _ = admm_update(params, state, blocks, scfg, step)
    prompts = [[5, 7, 11], [3, 1], list(range(2, 20)), [8, 8, 2]]
    got = {}
    for dev in ("cpu", "cuda"):
        moved = tree_map(lambda t: t.to(dev), (params, state))
        bank = ModelBank.build(cfg, *moved, blocks, (1.0, 0.5), fmt="fused")
        ops.reset_launch_counts()
        eng = ReferenceEngine(bank, EngineConfig(max_slots=2, max_len=32))
        for i, pr in enumerate(prompts):
            eng.submit(pr, max_new_tokens=6, tier=i % 2)
        got[dev] = ({r.uid: r.out_tokens for r in eng.run()}, eng.decode_calls)
        counts = ops.launch_counts()
        groups = cfg.num_layers // cfg.attn_every
        if dev == "cuda":
            assert counts["slr_matmul"] == 7 * groups * eng.decode_calls, counts
        else:
            assert not any(counts.values())
    assert got["cuda"] == got["cpu"]


def test_adapter_streams_on_card_match_cpu(cuda):
    """Three adapters of the reduced Llama (fused, HPA views of one state)
    over two pool rows with the prefix cache on, in batched and grouped mode:
    the card's streams and counters equal the CPU's, batched mode launches
    the per-slot kernel and grouped mode the stacked one."""
    cfg = dataclasses.replace(get_arch("salaad_llama_60m").reduced(), kernel_impl="pallas")
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    scfg = SalaadConfig(rho_constant=5.0, exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    for step in range(3):
        state, _ = admm_update(params, state, blocks, scfg, step)
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 256, 16).tolist()
    prompts = [shared + rng.integers(0, 256, n).tolist() for n in (12, 16, 2, 30, 7, 9)]
    got = {}
    for dev in ("cpu", "cuda"):
        p_, s_ = tree_map(lambda t: t.to(dev), (params, state))
        models = [DeployedModel.build(cfg, p_, s_, blocks, fmt="fused", bsr_block=32)]
        for keep in (0.7, 0.4):
            models.append(DeployedModel.build(cfg, p_, hpa_keep_ratio(s_, blocks, keep, 0.7)[0],
                                              blocks, fmt="fused", bsr_block=32))
        tenants = [adapterize(models[0], m) for m in models]
        for mode in ("batched", "grouped"):
            eng = PagedServingEngine(AdapterBank(models[0], tenants, mode=mode), EngineConfig(
                max_slots=3, max_len=64, block_size=8, prefix_cache=True, adapters=True,
                max_resident_adapters=2))
            ops.reset_launch_counts()
            for i, pr in enumerate(prompts):
                eng.submit(pr, max_new_tokens=8, adapter=i % 3)
            streams = {r.uid: r.out_tokens for r in eng.run()}
            got[dev, mode] = (streams, eng.bank.swaps, eng.prefix_hits, eng.adapter_tokens)
            counts = ops.launch_counts()
            if dev == "cuda":
                kernel = "slr_matmul_multi" if mode == "batched" else "slr_matmul_stacked"
                assert counts[kernel] > 0 and counts["flash_attention"] > 0, counts
            else:
                assert not any(counts.values())
    for mode in ("batched", "grouped"):
        assert got["cuda", mode] == got["cpu", mode]
    assert got["cuda", "batched"][0] == got["cuda", "grouped"][0]
    assert got["cuda", "batched"][1] >= 1 and got["cuda", "batched"][2] >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 32000, 512), (8, 512, 1376), (8, 1376, 512),
                                   (3, 37, 61), (2, 1, 3), (5, 7, 9)])
def test_soft_threshold_matches_plain(cuda, dtype, shape):
    """Per-slice thresholds with one slice at 0 (the identity, exactly) and
    one above max |x| (all zeros), NaN and +-inf written through; slices
    whose length is no multiple of the vector width start unaligned and run
    the scalar path. Exact in both dtypes: each side computes |x| - tau in
    f32 from the same operands and rounds once to x's dtype."""
    rng = np.random.default_rng(sum(shape))
    nb = shape[0]
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 3)
    flat = x.view(nb, -1)
    flat[:, 0] = float("nan")
    flat[:, -1] = float("inf")
    flat[0, min(1, flat.shape[1] - 1)] = -float("inf")
    tau = torch.from_numpy(rng.random(nb).astype(np.float32) * 2)
    tau[0] = 0.0
    if nb > 1:
        tau[-1] = 100.0
    x, tau = x.to(cuda, dtype), tau.to(cuda)
    ops.reset_launch_counts()
    got = ops.soft_threshold(x, tau)
    torch.cuda.synchronize()
    assert ops.launch_counts()["soft_threshold"] == 1
    want = ref.soft_threshold_ref(x, tau)
    assert got.dtype == dtype and got.shape == x.shape
    g, w = got.float(), want.float()
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    fin = ~torch.isnan(w)
    assert torch.equal(g[fin], w[fin])
    assert torch.equal(g[0][~torch.isnan(g[0])], x[0].float()[~torch.isnan(g[0])])
    if nb > 1:
        assert int(torch.count_nonzero(g[-1].nan_to_num(nan=0.0, posinf=0.0))) == 0


def test_train_steps_on_card_match_cpu(cuda):
    """Five train steps and one ADMM step (rSVD, sketches drawn on the CPU)
    of the reduced Llama on the card against the same on the CPU, from one
    state on the same batches: losses at 1e-4 relative; L = p @ vt within
    1e-3 of its scale; the ADMM step launched soft_threshold once per
    selected leaf."""
    from repro_torch.core.selection import SelectionConfig
    from repro_torch.data.synthetic import DataConfig, SyntheticC4
    from repro_torch.optim.adam import AdamConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_arch("salaad_llama_60m").reduced(), kernel_impl="blockwise")
    data = SyntheticC4(DataConfig(cfg.vocab_size, 32, 4, seed=0))
    runs = {}
    for dev in ("cpu", "cuda"):
        trainer = Trainer(cfg, TrainerConfig(
            total_steps=5, log_every=1, adam=AdamConfig(lr=1e-2),
            salaad=SalaadConfig(update_every=5, selection=SelectionConfig(min_dim=16))),
            device=dev)
        state = trainer.init(params=model_lib.init_params(cfg, seed=0, device=dev))
        ops.reset_launch_counts()
        state = trainer.fit(state, data)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert ops.launch_counts()["soft_threshold"] == len(trainer.blocks)
        runs[dev] = (state, [m["loss"] for m in trainer.metrics_log if "loss" in m])
    (cs, cl), (gs, gl) = runs["cpu"], runs["cuda"]
    np.testing.assert_allclose(gl, cl, rtol=1e-4)
    for name, blk in gs.slr.items():
        want = cs.slr[name]
        lw = (want.p @ want.vt)
        assert float(((blk.p @ blk.vt).cpu() - lw).abs().max()) <= 1e-3 * float(lw.abs().max())


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_serve_launcher_on_card_serves_checkpoint(cuda, kv_dtype, tmp_path, capsys):
    """The serve launcher on the card serves a checkpoint written by the train
    launcher: pages in the model's dtype (f32) go through the CUDA paged
    kernels, bf16 pages through the gather path, and both finish every
    request with SLR parameters in every tier."""
    import json

    from repro_torch.launch import serve, train

    arch = ["--arch", "salaad_llama_60m", "--reduced"]
    train.main(arch + ["--device", "cpu", "--steps", "10", "--update-every", "5",
                       "--ckpt-every", "10", "--seq-len", "16", "--batch", "4",
                       "--ckpt-dir", str(tmp_path)])
    capsys.readouterr()
    ops.reset_launch_counts()
    serve.main(arch + ["--ckpt-dir", str(tmp_path), "--keep-ratios", "1.0,0.6", "--fmt",
                       "fused", "--kv-dtype", kv_dtype, "--requests", "4", "--max-new", "4"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["requests"] == 4 and line["tokens"] == 16
    assert all(t["slr_params"] > 0 for t in line["tiers"])
    assert counts["slr_matmul_stacked"] >= 1
    paged = counts["paged_attention"] + counts["paged_attention_kquery"]
    assert (paged >= 1) if kv_dtype == "float32" else (paged == 0)
