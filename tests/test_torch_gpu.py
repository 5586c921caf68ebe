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
from repro_torch.models.attention import KVCache, contiguous_insert
from repro_torch.serving.engine import (
    EngineConfig,
    PagedServingEngine,
    ReferenceEngine,
    ServingEngine,
)
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


# (b, hq, hkv, d, bs, nb): head dims 32-256 (each bucket of the kernel), GQA
# groups 1, 2, 4 and 16, pages of 4, 8, 16 and 32, tables of one to eight
# segments; make_pool's lengths run 0, a page's last and first position,
# mid-page and the table's end, the tails unmapped
PAGED_DECODE = [(5, 4, 2, 32, 4, 6), (8, 8, 8, 64, 16, 32), (3, 32, 2, 128, 8, 5),
                (5, 8, 8, 80, 16, 20), (5, 16, 4, 256, 32, 12), (5, 8, 4, 64, 4, 600),
                (5, 16, 1, 128, 32, 80), (5, 8, 2, 256, 16, 160)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,d,bs,nb", PAGED_DECODE)
def test_paged_attention_matches_plain(cuda, dtype, b, hq, hkv, d, bs, nb):
    rng = np.random.default_rng(b * d)
    n = b * nb + 2
    kp, vp, table, lengths = make_pool(rng, b, hq, hkv, d, bs, nb, n, cuda, dtype)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), dtype=np.float32)).to(cuda, dtype)
    assert_close(ops.paged_attention(q, kp, vp, table, lengths),
                 ref.paged_attention_ref(q, kp, vp, table, lengths), dtype)


# (b, hq, hkv, kq, d, bs, nb): kq 1, 3, 21, 64 and 130 (row tiles of 16, 32
# and 64 rows, several tiles per KV head), the same heads, groups, pages and
# tables as above
PAGED_KQUERY = [(4, 4, 2, 3, 32, 4, 8), (8, 8, 8, 64, 64, 16, 32), (2, 6, 2, 21, 16, 8, 9),
                (5, 8, 8, 1, 64, 16, 32), (5, 16, 8, 21, 80, 16, 24),
                (5, 16, 4, 64, 128, 32, 16), (5, 8, 8, 130, 64, 16, 160),
                (3, 16, 1, 130, 64, 4, 100), (3, 32, 2, 21, 256, 16, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,kq,d,bs,nb", PAGED_KQUERY)
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
@pytest.mark.parametrize("kq,d,hq,hkv,nb", [(1, 64, 8, 8, 32), (1, 128, 16, 4, 160),
                                             (21, 64, 8, 8, 32), (64, 64, 8, 8, 32),
                                             (70, 80, 8, 4, 160)])
def test_paged_attention_rows_ignore_batch(cuda, dtype, kq, d, hq, hkv, nb):
    """A slot's output is bit for bit the same in two calls, alone (B = 1)
    and inside a batch of 8, and with the other slots' lengths changed: the
    segments and row tiles come from the table shape, kq and the group,
    never from B or the lengths (the row-invariance rule of the SLR kernels;
    the engine's batched streams rely on it). At nb = 160 decode walks eight
    segments of 320 positions."""
    rng = np.random.default_rng(kq * d + nb)
    b, bs = 8, 16
    n = b * nb
    kp = torch.from_numpy(rng.standard_normal((n, hkv, bs, d), dtype=np.float32)).to(cuda, dtype)
    vp = torch.from_numpy(rng.standard_normal((n, hkv, bs, d), dtype=np.float32)).to(cuda, dtype)
    table = torch.from_numpy(rng.permutation(n).reshape(b, nb).astype(np.int32)).to(cuda)
    top = nb * bs - kq
    lens = rng.integers(0, top + 1, b).astype(np.int32)
    lens[:3] = (0, bs - 1, top)
    q = torch.from_numpy(rng.standard_normal((b, hq, kq, d), dtype=np.float32)).to(cuda, dtype)

    def call(q_, table_, lens_):
        lens_ = torch.from_numpy(np.ascontiguousarray(lens_)).to(cuda)
        if kq == 1:
            return ops.paged_attention(q_[:, :, 0].contiguous(), kp, vp, table_, lens_)
        return ops.paged_attention_kquery(q_.contiguous(), kp, vp, table_, lens_)

    y = call(q, table, lens)
    assert torch.equal(call(q, table, lens), y)
    other = rng.integers(0, top + 1, b).astype(np.int32)
    for i in range(b):
        assert torch.equal(call(q[i:i + 1], table[i:i + 1].contiguous(), lens[i:i + 1]),
                           y[i:i + 1]), f"slot {i} alone"
        moved = other.copy()
        moved[i] = lens[i]
        assert torch.equal(call(q, table, moved)[i], y[i]), f"slot {i}, other lengths"
    assert_close(y, ref.paged_attention_kquery_ref(q, kp, vp, table, torch.from_numpy(lens).to(
        cuda)).reshape(y.shape), dtype)


@pytest.mark.parametrize("b,hq,hkv,d,bs,nb", PAGED_DECODE)
def test_paged_attention_f32_over_bf16_matches_plain(cuda, b, hq, hkv, d, bs, nb):
    """f32 queries over bf16 pages (a bf16 pool under an f32 model): the
    kernel widens each K and V element exactly and returns f32, within the
    f32 tolerance of the plain version on the same bf16 pools."""
    rng = np.random.default_rng(b * d + 1)
    n = b * nb + 2
    kp, vp, table, lengths = make_pool(rng, b, hq, hkv, d, bs, nb, n, cuda, torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((b, hq, d), dtype=np.float32)).to(cuda)
    got = ops.paged_attention(q, kp, vp, table, lengths)
    assert got.dtype == torch.float32
    assert_close(got, ref.paged_attention_ref(q, kp, vp, table, lengths), torch.float32)


@pytest.mark.parametrize("b,hq,hkv,kq,d,bs,nb", PAGED_KQUERY)
def test_paged_attention_kquery_f32_over_bf16_matches_plain(cuda, b, hq, hkv, kq, d, bs, nb):
    rng = np.random.default_rng(kq + 1)
    n = b * nb + 1
    kp, vp, table, lengths = make_pool(rng, b, hq, hkv, d, bs, nb, n, cuda, torch.bfloat16)
    lengths = torch.clamp(lengths, max=nb * bs - kq)
    q = torch.from_numpy(rng.standard_normal((b, hq, kq, d), dtype=np.float32)).to(cuda)
    got = ops.paged_attention_kquery(q, kp, vp, table, lengths)
    assert got.dtype == torch.float32
    assert_close(got, ref.paged_attention_kquery_ref(q, kp, vp, table, lengths), torch.float32)


@pytest.mark.parametrize("kq,d,hq,hkv,nb", [(1, 64, 8, 8, 32), (1, 128, 16, 4, 160),
                                             (4, 64, 8, 8, 32), (21, 64, 8, 8, 32),
                                             (64, 64, 8, 8, 32), (70, 80, 8, 4, 160)])
def test_paged_attention_f32_over_bf16_rows_ignore_batch(cuda, kq, d, hq, hkv, nb):
    """The f32-over-bf16 instance keeps the row-invariance rule: two calls,
    each slot alone and with the other slots' lengths changed agree bit for
    bit (its plan is the bf16 pool's)."""
    rng = np.random.default_rng(kq * d + nb + 1)
    b, bs = 8, 16
    n = b * nb
    kp, vp = (torch.from_numpy(rng.standard_normal((n, hkv, bs, d), dtype=np.float32)).to(
        cuda, torch.bfloat16) for _ in range(2))
    table = torch.from_numpy(rng.permutation(n).reshape(b, nb).astype(np.int32)).to(cuda)
    top = nb * bs - kq
    lens = rng.integers(0, top + 1, b).astype(np.int32)
    lens[:3] = (0, bs - 1, top)
    q = torch.from_numpy(rng.standard_normal((b, hq, kq, d), dtype=np.float32)).to(cuda)

    def call(q_, table_, lens_):
        lens_ = torch.from_numpy(np.ascontiguousarray(lens_)).to(cuda)
        if kq == 1:
            return ops.paged_attention(q_[:, :, 0].contiguous(), kp, vp, table_, lens_)
        return ops.paged_attention_kquery(q_.contiguous(), kp, vp, table_, lens_)

    y = call(q, table, lens)
    assert torch.equal(call(q, table, lens), y)
    other = rng.integers(0, top + 1, b).astype(np.int32)
    for i in range(b):
        assert torch.equal(call(q[i:i + 1], table[i:i + 1].contiguous(), lens[i:i + 1]),
                           y[i:i + 1]), f"slot {i} alone"
        moved = other.copy()
        moved[i] = lens[i]
        assert torch.equal(call(q, table, moved)[i], y[i]), f"slot {i}, other lengths"
    assert_close(y, ref.paged_attention_kquery_ref(q, kp, vp, table, torch.from_numpy(lens).to(
        cuda)).reshape(y.shape), torch.float32)


def test_paged_attention_refuses_other_dtype_pairs(cuda):
    """Only f32/f32, bf16/bf16 and f32 q over bf16 pools reach the kernel."""
    kp = torch.zeros((4, 2, 8, 64), device=cuda)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    lens = torch.zeros((1,), dtype=torch.int32, device=cuda)
    q = torch.zeros((1, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="bfloat16 pools"):
        ops.paged_attention(q.bfloat16(), kp, kp, table, lens)         # bf16 q over f32
    with pytest.raises(TypeError, match="bfloat16 pools"):
        ops.paged_attention(q, kp.bfloat16(), kp, table, lens)         # k and v differ
    with pytest.raises(TypeError, match="bfloat16 pools"):
        ops.paged_attention_kquery(q[:, :, None], kp.to(torch.int8), kp.to(torch.int8),
                                   table, lens)


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


# (x, tables) dtypes of the block-CSC and low-rank kernels: one dtype, or
# bf16 activations over f32 tables
DTYPE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
               (torch.bfloat16, torch.float32)]


@pytest.mark.parametrize("bs,n,m", [(8, 40, 36), (16, 72, 50), (32, 100, 70), (64, 200, 130),
                                    (128, 300, 260)])
@pytest.mark.parametrize("t", [1, 8, 37])
def test_bsr_matmul_bf16_over_f32_tiles(cuda, bs, n, m, t):
    """bf16 activations over f32 tiles at every block size, ragged T, n and m
    (a bf16 model deployed from an f32 SLR state)."""
    rng = np.random.default_rng(bs + n + t)
    mat = make_stack(rng, 1, n, m, bs, 0.6, cuda, torch.float32).at_layer(0)
    x = torch.from_numpy(rng.standard_normal((t, n), dtype=np.float32)).to(cuda, torch.bfloat16)
    assert_close(ops.bsr_matmul(x, mat), ref.bsr_matmul_ref(x, mat), torch.bfloat16)


@pytest.mark.parametrize("xdt,wdt", DTYPE_PAIRS)
@pytest.mark.parametrize("bs,n,m", [(8, 40, 36), (32, 512, 1376), (64, 200, 130),
                                    (128, 512, 512)])
def test_bsr_matmul_rows_ignore_t(cuda, xdt, wdt, bs, n, m):
    """A row of y is bit for bit the same in a call of any T (decode rows of
    8 and prefill rows of 64 per block, split or walked), and two calls agree
    bit for bit."""
    rng = np.random.default_rng(bs * 3 + n)
    mat = make_stack(rng, 1, n, m, bs, 0.7, cuda, wdt).at_layer(0)
    x = torch.from_numpy(rng.standard_normal((512, n), dtype=np.float32)).to(cuda, xdt)
    full = ops.bsr_matmul(x, mat)
    assert torch.equal(ops.bsr_matmul(x, mat), full)
    for t in (1, 3, 8, 37, 100):
        assert torch.equal(ops.bsr_matmul(x[:t].contiguous(), mat), full[:t])


@pytest.mark.parametrize("xdt,wdt", DTYPE_PAIRS)
@pytest.mark.parametrize("k,m,r", [(512, 1376, 128), (1376, 512, 128), (70, 90, 130), (40, 36, 5)])
def test_lowrank_matmul_rows_ignore_t(cuda, xdt, wdt, k, m, r):
    """Within tolerance of the plain version; a row of y is bit for bit the
    same in a call of any T, and two calls agree bit for bit."""
    rng = np.random.default_rng(k + r)
    x = torch.from_numpy(rng.standard_normal((512, k), dtype=np.float32)).to(cuda, xdt)
    p = torch.from_numpy(rng.standard_normal((k, r), dtype=np.float32) / 8).to(cuda, wdt)
    vt = torch.from_numpy(rng.standard_normal((r, m), dtype=np.float32) / 8).to(cuda, wdt)
    ops.reset_launch_counts()
    full = ops.lowrank_matmul(x, p, vt)
    assert ops.launch_counts()["lowrank_matmul"] == 1      # two kernels, one call counted
    assert_close(full, ref.lowrank_matmul_ref(x, p, vt), xdt)
    assert torch.equal(ops.lowrank_matmul(x, p, vt), full)
    for t in (1, 3, 8, 37, 100):
        assert torch.equal(ops.lowrank_matmul(x[:t].contiguous(), p, vt), full[:t])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [1, 8, 37])
def test_lowrank_multi_rows_ignore_b(cuda, dtype, t):
    """The per-slot empty-S corner: slots 0..b-1 of an 8-slot call equal a
    b-slot call, every slot equals lowrank_matmul on its table row, and two
    calls agree, bit for bit."""
    rng = np.random.default_rng(t)
    layers, k, m, r = 2, 512, 1376, 128
    x = torch.from_numpy(rng.standard_normal((8, t, k), dtype=np.float32)).to(cuda, dtype)
    p = torch.from_numpy(rng.standard_normal((6, k, r), dtype=np.float32) / 8).to(cuda, dtype)
    vt = torch.from_numpy(rng.standard_normal((6, r, m), dtype=np.float32) / 8).to(cuda, dtype)
    ids = torch.tensor([2, 0, 1, 1, 0, 2, 2, 0], dtype=torch.int32, device=cuda)
    full = ops.slr_matmul_multi(x, p, vt, None, ids, layers, 1)
    assert torch.equal(ops.slr_matmul_multi(x, p, vt, None, ids, layers, 1), full)
    for b in (1, 3):
        got = ops.slr_matmul_multi(x[:b].contiguous(), p, vt, None, ids[:b].contiguous(),
                                   layers, 1)
        assert torch.equal(got, full[:b])
    for b, i in enumerate(ids.tolist()):
        row = i * layers + 1
        assert torch.equal(full[b], ops.lowrank_matmul(x[b].contiguous(), p[row], vt[row]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lowrank_multi_outside_pool_writes_nan(cuda, dtype):
    """A table row outside [0, N) (a negative id, or an id past the pool)
    writes NaN rows for its slot and reads nothing past the pool; the other
    slots keep their values."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((5, 9, 64), dtype=np.float32)).to(cuda, dtype)
    p = torch.from_numpy(rng.standard_normal((4, 64, 12), dtype=np.float32)).to(cuda, dtype)
    vt = torch.from_numpy(rng.standard_normal((4, 12, 40), dtype=np.float32)).to(cuda, dtype)
    ids = torch.tensor([0, -1, 1, 2, 1], dtype=torch.int32, device=cuda)
    got = ops.slr_matmul_multi(x, p, vt, None, ids, 2, 1)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[[1, 3]]).all())
    for b, i in ((0, 0), (2, 1), (4, 1)):
        assert torch.equal(got[b], ops.lowrank_matmul(x[b].contiguous(), p[i * 2 + 1],
                                                      vt[i * 2 + 1]))


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


def test_page_copy_many_pairs(cuda):
    """64 pairs x 8 layers of 32 KB f32 pages, every dst a fresh page: more
    units than the card has SMs, walked by a grid of the card's size."""
    rng = np.random.default_rng(64)
    pool = torch.from_numpy(rng.standard_normal((8, 160, 8, 16, 64), dtype=np.float32)).to(cuda)
    perm = rng.permutation(160).astype(np.int32)
    src = torch.from_numpy(perm[:64]).to(cuda)
    dst = torch.from_numpy(perm[64:128]).to(cuda)
    want = ref.page_copy_ref(pool.clone(), src, dst)
    got = ops.page_copy(pool, src, dst)
    torch.cuda.synchronize()
    assert got.data_ptr() == pool.data_ptr() and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_page_copy_ragged_pages(cuda, dtype):
    """Pages of 3 x 5 x 7 elements (105 bytes int8, 210 bf16): no multiple of
    16 bytes, so the byte path inside the kernel copies them."""
    rng = np.random.default_rng(105)
    pool = torch.from_numpy(rng.standard_normal((4, 30, 3, 5, 7), dtype=np.float32) * 50)
    pool = pool.to(cuda, dtype)
    src = torch.tensor([3, 8, 21, 0], dtype=torch.int32, device=cuda)
    dst = torch.tensor([4, 0, 29, 0], dtype=torch.int32, device=cuda)
    want = ref.page_copy_ref(pool.clone(), src, dst)
    got = ops.page_copy(pool, src, dst)
    torch.cuda.synchronize()
    assert got.data_ptr() == pool.data_ptr() and torch.equal(got, want)


def test_page_copy_skips_identity_and_outside_pairs(cuda):
    """The (..., 1) f32 scale pool: pairs naming a page outside [0, N) and
    identity pairs beside real ones are skipped; nothing else moves."""
    rng = np.random.default_rng(1)
    pool = torch.from_numpy(rng.standard_normal((8, 40, 8, 16, 1), dtype=np.float32)).to(cuda)
    src = torch.tensor([5, 9, 13, 0, 50, 7, 0, 3], dtype=torch.int32, device=cuda)
    dst = torch.tensor([0, 30, 17, 0, 2, -3, 0, 3], dtype=torch.int32, device=cuda)
    want = ref.page_copy_ref(pool.clone(), src[:3], dst[:3])
    ops.reset_launch_counts()
    got = ops.page_copy(pool, src, dst)
    torch.cuda.synchronize()
    assert ops.launch_counts()["page_copy"] == 1
    assert got.data_ptr() == pool.data_ptr() and torch.equal(got, want)


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


@pytest.mark.parametrize("t", [1, 3])
def test_contiguous_insert_drops_on_card(cuda, t):
    """The per-slot contiguous insert on the card: rows at 0, S - 2, S - 1
    and S (all their writes past the buffer) take the CPU's result bit for
    bit, with no device-side assert for the dropped positions and no host
    sync (sync debug mode raises on one)."""
    rng = np.random.default_rng(t)
    k = torch.from_numpy(rng.standard_normal((4, 2, 8, 16), dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((4, 2, 8, 16), dtype=np.float32))
    new = torch.from_numpy(rng.standard_normal((4, 2, t, 16), dtype=np.float32))
    lens = torch.tensor([0, 6, 7, 8], dtype=torch.int32)
    want = contiguous_insert(KVCache(k.clone(), v.clone(), lens), new, -new)
    gk, gv, glen = k.to(cuda), v.to(cuda), lens.to(cuda)
    gnew = new.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = contiguous_insert(KVCache(gk, gv, glen), gnew, -gnew)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got.k.cpu(), want.k) and torch.equal(got.v.cpu(), want.v)
    assert got.length.cpu().tolist() == want.length.tolist() == [x + t for x in (0, 6, 7, 8)]
    assert torch.equal(got.k.cpu()[3], k[3])


def test_batched_engine_streams_on_card_match_cpu(cuda):
    """The slot-padded ServingEngine on a three-tier reduced fused bank
    (flash prefill, the fused SLR kernel at every linear site, per-slot
    decode by masked einsum): prefill groups padded below max_slots, slots
    reused; the card's greedy streams equal the CPU's, and the paged
    kernels never run."""
    banks = _reduced_bank((1.0, 0.6, 0.3))
    prompts = [[5, 7, 11], [3, 1], list(range(2, 40)), [8, 8, 2], [1, 2, 3, 4, 5, 6],
               [9, 9], list(range(60, 75))]
    streams = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launch_counts()
        eng = ServingEngine(banks[dev], EngineConfig(max_slots=3, max_len=64))
        for i, pr in enumerate(prompts):
            eng.submit(pr, max_new_tokens=8, tier=i % 3)
        streams[dev] = {r.uid: r.out_tokens for r in eng.run()}
        counts = ops.launch_counts()
        if dev == "cuda":
            assert counts["flash_attention"] > 0 and counts["slr_matmul_stacked"] > 0
            assert counts["paged_attention"] == counts["paged_attention_kquery"] == 0
            assert eng.stats_snapshot()["jit_retraces"] == 0
        else:
            assert not any(counts.values())
    assert streams["cuda"] == streams["cpu"]


def _reduced_bank(keeps):
    cfg = dataclasses.replace(get_arch("salaad_llama_60m").reduced(), kernel_impl="pallas")
    params = model_lib.init_params(cfg, seed=0, device="cpu")
    scfg = SalaadConfig(rho_constant=5.0, exact_svd=True)
    state, blocks = init_slr_state(params, scfg)
    for step in range(3):
        state, _ = admm_update(params, state, blocks, scfg, step)
    return {dev: ModelBank.build(cfg, *tree_map(lambda t: t.to(dev), (params, state)), blocks,
                                 keeps, kappa=0.7, fmt="fused")
            for dev in ("cpu", "cuda")}


def test_speculative_streams_on_card_match_cpu(cuda):
    """The speculative engine on a two-tier fused bank (keep 1.0 verifies,
    keep 0.3 drafts into bf16 pools, or tier 0 drafts for itself): greedy
    under both schedules with the prefix cache and chunked prefill, card
    streams equal the CPU's and the paged engine's at tier 0; the identical
    draft confirms guesses, so multi-token ticks (the length reset past m > 1
    and the realigned guesses) run; the paged decode kernel (f32 queries
    over the bf16 draft pages) and the k-query kernel launch."""
    from repro_torch.serving.speculative import SpeculativeEngine

    banks = _reduced_bank((1.0, 0.3))
    prompts = [[5, 7, 11], [3, 1], list(range(2, 40)), [8, 8, 2], [1, 2, 3, 4, 5, 6],
               list(range(2, 18))]
    kw = dict(max_slots=3, max_len=64, block_size=8, prefill_chunk=16, prefix_cache=True)
    modes = [(mode, draft) for mode in ("parallel", "sequential") for draft in (-1, 0)]
    got = {}
    for dev in ("cpu", "cuda"):
        for mode, draft in modes:
            ops.reset_launch_counts()
            eng = SpeculativeEngine(banks[dev], EngineConfig(
                **kw, spec_k=4, spec_draft_mode=mode, spec_draft_tier=draft))
            for p in prompts:
                eng.submit(p, max_new_tokens=8)
            got[dev, mode, draft] = {r.uid: r.out_tokens for r in eng.run()}
            counts = ops.launch_counts()
            if draft == 0:
                assert eng.accepted_tokens > 0, (dev, mode)
            if dev == "cuda":
                assert counts["paged_attention_kquery"] > 0 and counts["slr_matmul_stacked"] > 0
                assert (counts["paged_attention"] > 0) == (mode == "sequential")
        eng = PagedServingEngine(banks[dev], EngineConfig(**kw))
        for p in prompts:
            eng.submit(p, max_new_tokens=8, tier=0)
        got[dev, "paged"] = {r.uid: r.out_tokens for r in eng.run()}
    for run in modes + ["paged"]:
        key = run if isinstance(run, tuple) else (run,)
        assert got[("cuda",) + key] == got[("cpu",) + key], run
        assert got[("cuda",) + key] == got["cuda", "paged"], run


def test_int8_engine_streams_on_card_match_cpu(cuda):
    """Int8 pages on the card (flash prefill, the dequantizing gather, page
    copy of payload and scale pools under the prefix cache): streams equal
    the CPU's; the paged kernels stay idle."""
    banks = _reduced_bank((1.0, 0.6))
    prompts = [[5, 7, 11], list(range(2, 18)), [3, 1], list(range(2, 18)), [8, 8, 2]]
    got = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launch_counts()
        eng = PagedServingEngine(banks[dev], EngineConfig(max_slots=2, max_len=48, block_size=8,
                                                          kv_dtype="int8", prefix_cache=True))
        for i, p in enumerate(prompts):
            eng.submit(p, max_new_tokens=6, tier=i % 2)
        got[dev] = {r.uid: r.out_tokens for r in eng.run()}
        counts = ops.launch_counts()
        if dev == "cuda":
            assert eng.cow_copies >= 1 and counts["page_copy"] % 4 == 0
            assert counts["page_copy"] > 0 and counts["flash_attention"] > 0
            assert counts["paged_attention"] == counts["paged_attention_kquery"] == 0
    assert got["cuda"] == got["cpu"]


def test_keyed_uniforms_equal_on_card_and_cpu(cuda):
    from repro_torch.serving.engine import keyed_uniform

    slots = torch.tensor([0, 5, 2, 9999], dtype=torch.int64)
    for key in ((0, 1, 0), (7, 123456, 6), (2**31 + 5, 3, 1)):
        assert torch.equal(keyed_uniform(key, slots, 1000),
                           keyed_uniform(key, slots.to(cuda), 1000).cpu())


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
    whose length is no multiple of the vector width put slice boundaries
    inside 16-byte vectors. Exact in both dtypes: each side computes |x| -
    tau in f32 from the same operands and rounds once to x's dtype."""
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


def soft_exact(got, want):
    g, w = got.float(), want.float()
    return torch.equal(torch.isnan(g), torch.isnan(w)) and torch.equal(g.nan_to_num(0.0),
                                                                       w.nan_to_num(0.0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(7, 3), (6, 37, 61), (9, 1375), (70000, 1, 3), (3, 4097),
                                   (2, 300001)])
def test_soft_threshold_slice_edges(cuda, dtype, shape):
    """Slice boundaries inside a 16-byte vector (per = 3, 37 x 61, 1375) and
    inside a tile (per = 4097, 300001), and nb above 65535 (70000 x 3): one
    launch, exact against the plain version, each slice with its own tau."""
    rng = np.random.default_rng(shape[-1])
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * 2).to(cuda, dtype)
    tau = torch.from_numpy(rng.random(shape[0]).astype(np.float32) * 2).to(cuda)
    ops.reset_launch_counts()
    got = ops.soft_threshold(x, tau)
    torch.cuda.synchronize()
    assert ops.launch_counts()["soft_threshold"] == 1
    assert got.shape == x.shape and soft_exact(got, ref.soft_threshold_ref(x, tau))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skew", [1, 3])
def test_soft_threshold_unaligned_input(cuda, dtype, skew):
    """x starting ``skew`` elements past a 16-byte boundary (a view): its
    output is aligned, so the kernel runs scalar throughout; exact."""
    rng = np.random.default_rng(skew)
    base = torch.from_numpy(rng.standard_normal(4 * 5000 + skew, dtype=np.float32)).to(cuda)
    x = base.to(dtype)[skew:].view(4, 5000)
    tau = torch.tensor([0.0, 0.3, 1.0, 9.0], device=cuda)
    got = ops.soft_threshold(x, tau)
    torch.cuda.synchronize()
    assert soft_exact(got, ref.soft_threshold_ref(x, tau))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_soft_threshold_special_values(cuda, dtype):
    """NaN, +-inf, +-0 and the extremes of the dtype in every slice, under
    tau = 0, a shrink, tau above max |x|, an infinite and a NaN tau: NaN
    positions and every other value as the plain version gives them."""
    info = torch.finfo(dtype)
    specials = [float("nan"), float("inf"), -float("inf"), 0.0, -0.0, info.tiny, -info.tiny,
                info.max, -info.max, 1.0, -1.0, 0.5]
    per = 4 * len(specials) + 1
    x = torch.tensor((specials * 5)[:per], device=cuda).repeat(5, 1).to(dtype)
    x[:, -1] = 2.0
    tau = torch.tensor([0.0, 0.7, 1e30, float("inf"), float("nan")], device=cuda)
    got = ops.soft_threshold(x, tau)
    torch.cuda.synchronize()
    assert soft_exact(got, ref.soft_threshold_ref(x, tau))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skew", [1, 3])
def test_soft_threshold_scalar_head(cuda, dtype, skew):
    """x and out both ``skew`` elements past a 16-byte boundary (views of
    larger buffers, through the C entry: the wrapper's own out is aligned):
    a scalar head up to the boundary, then vectors with slice boundaries
    inside them and inside tiles, then a scalar tail; exact."""
    from repro_torch.kernels import _build

    rng = np.random.default_rng(skew)
    nb, per = 5, 140001
    base = torch.from_numpy(rng.standard_normal(nb * per + skew, dtype=np.float32) * 3)
    x = base.to(cuda, dtype)[skew:].view(nb, per)
    x[:, 7] = float("nan")
    tau = torch.tensor([0.0, 0.5, 1.0, 2.0, 100.0], device=cuda)
    out = torch.empty(nb * per + skew, dtype=dtype, device=cuda)[skew:].view(nb, per)
    assert x.data_ptr() % 16 and (x.data_ptr() - out.data_ptr()) % 16 == 0
    _build.launch("soft_threshold_launch", cuda, x.data_ptr(), tau.data_ptr(), out.data_ptr(),
                  per, x.numel(), _build.dtype_code(dtype))
    torch.cuda.synchronize()
    assert soft_exact(out, ref.soft_threshold_ref(x, tau))


def test_page_copy_walks_units(cuda):
    """64 pairs x 54 layers of 32 KB f32 pages: 3456 units, more than the
    card holds at once, so each block walks several; identity pairs and a
    page outside the pool among them are skipped; exact and in place."""
    rng = np.random.default_rng(54)
    pool = torch.from_numpy(rng.standard_normal((54, 130, 8, 16, 64), dtype=np.float32)).to(cuda)
    perm = rng.permutation(130).astype(np.int32)
    src_np, dst_np = perm[:64].copy(), perm[64:128].copy()
    src_np[[3, 17]] = dst_np[[3, 17]]                      # identity pairs
    src_np[25] = 130                                       # outside the pool
    keep = [i for i in range(64) if i not in (3, 17, 25)]
    src, dst = torch.from_numpy(src_np).to(cuda), torch.from_numpy(dst_np).to(cuda)
    want = ref.page_copy_ref(pool.clone(), src[keep], dst[keep])
    got = ops.page_copy(pool, src, dst)
    torch.cuda.synchronize()
    assert got.data_ptr() == pool.data_ptr() and torch.equal(got, want)
    del pool, want, got


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


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
def test_serve_launcher_on_card_serves_checkpoint(cuda, kv_dtype, tmp_path, capsys):
    """The serve launcher on the card serves a checkpoint written by the train
    launcher: f32 pages and bf16 pages (f32 queries over bf16 pages) go
    through the CUDA paged kernels, int8 pages through the dequantizing
    gather, and each finishes every request with SLR parameters in every
    tier."""
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
    assert (paged >= 1) if kv_dtype != "int8" else (paged == 0)
