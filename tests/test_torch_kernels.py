"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper of the port runs its plain PyTorch version; the JAX
side runs the Pallas kernels in interpret mode, as the JAX package's own
kernel tests do. Inputs come from numpy seeds and reach both sides as the
same arrays. Tolerance: f32 atol/rtol 1e-4 (the two sides sum in different
orders). The block-CSC tables are built by numpy on both sides and must be
equal exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.bsr_matmul import bsr_from_dense as jax_bsr_from_dense
from repro.kernels.bsr_matmul import bsr_to_dense as jax_bsr_to_dense
from repro.kernels.slr_matmul import slr_matmul_pallas as jslr_matmul_pallas
from repro.kernels.slr_matmul import stack_bsr as jax_stack_bsr
from repro_torch.configs import get_arch
from repro_torch.kernels import lowrank_matmul as lowrank_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bsr_matmul import bsr_from_dense, bsr_plan, bsr_to_dense
from repro_torch.kernels.lowrank_matmul import lowrank_launch, lowrank_plan
from repro_torch.kernels.stream import MAX_SMEM, stream_segments, stream_smem_bytes
from repro_torch.kernels.slr_matmul import (FUSED_MAX_SMEM, fused_plan, fused_smem_bytes, row_tile,
                                           stack_bsr, unstacked_plan, unstacked_segments,
                                           unstacked_smem_bytes, unstacked_stage_rows)

TOL = dict(atol=1e-4, rtol=1e-4)


def block_sparse(rng, k, m, bs, occupancy):
    ib, jb = -(-k // bs), -(-m // bs)
    live = rng.random((ib, jb)) < occupancy
    dense = rng.standard_normal((ib * bs, jb * bs)).astype(np.float32)
    return (dense * np.repeat(np.repeat(live, bs, 0), bs, 1))[:k, :m]


def both_stacks(rng, num_l, k, m, bs, occupancy):
    """The same per-layer S as a port BsrStack and a JAX BsrStack; layer l
    gets occupancy * (l + 1) / num_l, so counts are ragged below MAXB."""
    dense = [block_sparse(rng, k, m, bs, occupancy * (l + 1) / num_l) for l in range(num_l)]
    return (stack_bsr([bsr_from_dense(d, bs) for d in dense]),
            jax_stack_bsr([jax_bsr_from_dense(d, bs) for d in dense]))


@pytest.mark.parametrize("bs,k,m", [(8, 40, 36), (32, 96, 64)])
def test_bsr_tables_equal_jax(bs, k, m):
    rng = np.random.default_rng(bs)
    s = block_sparse(rng, k, m, bs, 0.4)
    got, want = bsr_from_dense(s, bs), jax_bsr_from_dense(s, bs)
    for name in ("counts", "rows", "vals"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.empty == want.empty and got.padded_shape == want.padded_shape
    np.testing.assert_array_equal(bsr_to_dense(got).numpy(), np.asarray(jax_bsr_to_dense(want)))
    np.testing.assert_array_equal(bsr_to_dense(got).numpy(), s)


@pytest.mark.parametrize("bs,t,k,m,r", [(8, 3, 40, 36, 5), (32, 17, 96, 64, 12)])
def test_slr_matmul_stacked_matches_pallas(bs, t, k, m, r):
    """Ragged T, K and M, ragged per-layer counts, every layer of the stack."""
    rng = np.random.default_rng(t)
    num_l = 3
    x = rng.standard_normal((t, k), dtype=np.float32)
    p = rng.standard_normal((num_l, k, r), dtype=np.float32) / 4
    vt = rng.standard_normal((num_l, r, m), dtype=np.float32) / 4
    stack, jstack = both_stacks(rng, num_l, k, m, bs, 0.6)
    assert int(stack.counts.min()) < stack.rows.shape[-1]
    for layer in range(num_l):
        got = ops.slr_matmul_stacked(torch.from_numpy(x), torch.from_numpy(p),
                                     torch.from_numpy(vt), stack, layer)
        want = jops.slr_matmul_stacked(jnp.asarray(x), jnp.asarray(p), jnp.asarray(vt),
                                       jstack, jnp.int32(layer), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("corner", ["empty_s", "rank_0"])
def test_slr_matmul_corners_match_pallas(corner):
    """The dispatch corners of ops.slr_matmul_stacked: empty S goes to the
    low-rank kernel, r == 0 to the fused kernel with rank-1 zero factors."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 40), dtype=np.float32)
    p = rng.standard_normal((2, 40, 6), dtype=np.float32)
    vt = rng.standard_normal((2, 6, 24), dtype=np.float32)
    stack, jstack = both_stacks(rng, 2, 40, 24, 8, 0.0 if corner == "empty_s" else 0.5)
    if corner == "rank_0":
        p, vt = None, None
    tp = None if p is None else torch.from_numpy(p)
    tvt = None if vt is None else torch.from_numpy(vt)
    jp = None if p is None else jnp.asarray(p)
    jvt = None if vt is None else jnp.asarray(vt)
    got = ops.slr_matmul_stacked(torch.from_numpy(x), tp, tvt, stack, 1)
    want = jops.slr_matmul_stacked(jnp.asarray(x), jp, jvt, jstack, jnp.int32(1),
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_lowrank_matmul_matches_pallas():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((9, 70), dtype=np.float32)
    p = rng.standard_normal((70, 13), dtype=np.float32)
    vt = rng.standard_normal((13, 50), dtype=np.float32)
    got = ops.lowrank_matmul(torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(vt))
    want = jops.lowrank_matmul(jnp.asarray(x), jnp.asarray(p), jnp.asarray(vt),
                               interpret=True, bm=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def paged_pool(rng, b, hkv, d, bs, nb):
    """Pools plus a block table with unmapped tails and lengths at a page
    start, a page end, mid-page and 0."""
    n = b * nb
    kp = rng.standard_normal((n, hkv, bs, d), dtype=np.float32)
    vp = rng.standard_normal((n, hkv, bs, d), dtype=np.float32)
    table = np.full((b, nb), n, np.int32)
    lengths = np.array([0, bs - 1, bs, 2 * bs + 1][:b], np.int32)
    perm = rng.permutation(n)
    used = 0
    for i, length in enumerate(lengths):
        pages = length // bs + 1
        table[i, :pages] = perm[used:used + pages]
        used += pages
    return kp, vp, table, lengths


def test_paged_attention_matches_pallas():
    rng = np.random.default_rng(3)
    kp, vp, table, lengths = paged_pool(rng, 4, 2, 16, 4, 4)
    q = rng.standard_normal((4, 4, 16), dtype=np.float32)      # GQA group 2
    got = ops.paged_attention(*map(torch.from_numpy, (q, kp, vp, table, lengths)))
    want = jops.paged_attention(*map(jnp.asarray, (q, kp, vp, table, lengths)), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kq", [3, 70])
def test_paged_attention_kquery_matches_pallas(kq):
    """kq = 70 with GQA group 2 is wider than one Pallas query tile (64)."""
    rng = np.random.default_rng(kq)
    bs, nb = 8, 12
    kp, vp, table, lengths = paged_pool(rng, 3, 2, 8, bs, nb)
    lengths = np.minimum(lengths, nb * bs - kq).astype(np.int32)
    for i, length in enumerate(lengths):          # map every page the window writes
        pages = (length + kq - 1) // bs + 1
        table[i, :pages] = np.arange(i * nb, i * nb + pages)
    q = rng.standard_normal((3, 4, kq, 8), dtype=np.float32)
    got = ops.paged_attention_kquery(*map(torch.from_numpy, (q, kp, vp, table, lengths)))
    want = jops.paged_attention_kquery(*map(jnp.asarray, (q, kp, vp, table, lengths)),
                                       interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bs,t,k,m,occ", [
    (8, 3, 40, 36, 0.5), (32, 17, 96, 70, 0.6), (128, 9, 256, 200, 0.7), (32, 5, 64, 64, 0.0),
])
def test_bsr_matmul_matches_pallas(bs, t, k, m, occ):
    """Block sizes 8, 32 and 128, ragged T / n / m, ragged counts, and an
    empty S (the dispatcher's zero fast path on both sides)."""
    rng = np.random.default_rng(bs + t)
    s = block_sparse(rng, k, m, bs, occ)
    mat, jmat = bsr_from_dense(s, bs), jax_bsr_from_dense(s, bs)
    assert mat.empty == (occ == 0.0)
    if not mat.empty:
        assert int(mat.counts.min()) < mat.rows.shape[1]
    x = rng.standard_normal((t, k), dtype=np.float32)
    got = ops.bsr_matmul(torch.from_numpy(x), mat)
    want = jops.bsr_matmul(jnp.asarray(x), jmat, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8", "scale"])
def test_page_copy_matches_pallas(dtype):
    """Payload pools of each type and the (..., 1) f32 scale pools, with
    (0, 0) pads; the port copies in place."""
    rng = np.random.default_rng(4)
    tail = 1 if dtype == "scale" else 8
    base = rng.standard_normal((2, 10, 2, 4, tail)).astype(np.float32) * 50
    np_dt = {"int8": np.int8}.get(dtype, np.float32)
    pool_np = base.astype(np_dt)
    src = np.array([3, 7, 0, 0], np.int32)
    dst = np.array([9, 1, 0, 0], np.int32)
    jpool = jnp.asarray(pool_np)
    pool = torch.from_numpy(pool_np.copy())
    if dtype == "bfloat16":
        jpool, pool = jpool.astype(jnp.bfloat16), pool.to(torch.bfloat16)
    want = jops.page_copy(jpool, jnp.asarray(src), jnp.asarray(dst), interpret=True)
    got = ops.page_copy(pool, torch.from_numpy(src), torch.from_numpy(dst))
    assert got is pool
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("t,s,causal", [(16, 16, True), (16, 16, False), (128, 128, True),
                                        (256, 256, True), (256, 256, False), (128, 256, True)])
def test_flash_attention_matches_pallas(t, s, causal):
    """GQA group 2; T != S keeps the Pallas kernel's causal alignment."""
    rng = np.random.default_rng(t + s)
    q = rng.standard_normal((2, 4, t, 16), dtype=np.float32)
    k = rng.standard_normal((2, 2, s, 16), dtype=np.float32)
    v = rng.standard_normal((2, 2, s, 16), dtype=np.float32)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_attention_rejects_what_pallas_rejects():
    q = torch.zeros((1, 2, 200, 16))
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.flash_attention(q, q, q)


def test_unstacked_fused_weight_needs_the_hybrid_slice():
    """Unstacked slr_matmul with both parts live (the hybrid's shared block)
    against JAX's slr_matmul_pallas in interpret mode; the corners dispatch
    to the block-CSC and low-rank kernels."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 16), dtype=np.float32)
    dense = block_sparse(rng, 16, 24, 8, 1.0)
    mat, jmat = bsr_from_dense(dense, 8), jax_bsr_from_dense(dense, 8)
    p = rng.standard_normal((16, 2), dtype=np.float32)
    vt = rng.standard_normal((2, 24), dtype=np.float32)
    tx, tp, tvt = map(torch.from_numpy, (x, p, vt))
    torch.testing.assert_close(ops.slr_matmul(tx, None, None, mat), ref.bsr_matmul_ref(tx, mat))
    torch.testing.assert_close(ops.slr_matmul(tx, tp, tvt, None), ref.lowrank_matmul_ref(tx, tp, tvt))
    want = jops.slr_matmul(jnp.asarray(x), jnp.asarray(p), jnp.asarray(vt), jmat,
                           interpret=True)
    np.testing.assert_allclose(ops.slr_matmul(tx, tp, tvt, mat).numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bs,t,k,m,r,occ", [
    (8, 1, 40, 36, 5, 0.5), (8, 37, 40, 36, 5, 1.0), (16, 8, 70, 50, 9, 0.4),
    (16, 3, 64, 48, 16, 0.7), (32, 17, 96, 64, 12, 0.6), (32, 9, 300, 260, 33, 0.3),
])
def test_slr_matmul_matches_pallas(bs, t, k, m, r, occ):
    """Both parts live, ragged T, K and M, counts below MAXB: the port's
    unstacked fused SLR matmul against ``slr_matmul_pallas``."""
    rng = np.random.default_rng(bs * 100 + t)
    x = rng.standard_normal((t, k), dtype=np.float32)
    p = rng.standard_normal((k, r), dtype=np.float32) / 4
    vt = rng.standard_normal((r, m), dtype=np.float32) / 4
    dense = block_sparse(rng, k, m, bs, occ)
    mat, jmat = bsr_from_dense(dense, bs), jax_bsr_from_dense(dense, bs)
    assert not mat.empty
    got = ops.slr_matmul(*map(torch.from_numpy, (x, p, vt)), mat)
    want = jslr_matmul_pallas(jnp.asarray(x), jnp.asarray(p), jnp.asarray(vt), jmat,
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("corner", ["empty_s", "rank_0", "both_empty", "no_s"])
def test_unstacked_corners_match_jax_dispatcher(corner):
    """Every corner of ops.slr_matmul against JAX's dispatcher: an empty S
    (static ``empty``) or no S runs the low-rank kernel, r == 0 the block-CSC
    kernel, neither part gives zeros."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((6, 40), dtype=np.float32)
    p = rng.standard_normal((40, 6), dtype=np.float32)
    vt = rng.standard_normal((6, 24), dtype=np.float32)
    dense = block_sparse(rng, 40, 24, 8, 0.0 if corner in ("empty_s", "both_empty") else 0.5)
    mat, jmat = bsr_from_dense(dense, 8), jax_bsr_from_dense(dense, 8)
    if corner == "no_s":
        mat = jmat = None
    if corner in ("rank_0", "both_empty"):
        p = vt = None
    targs = [None if a is None else torch.from_numpy(a) for a in (p, vt)]
    jargs = [None if a is None else jnp.asarray(a) for a in (p, vt)]
    ops.reset_launch_counts()
    got = ops.slr_matmul(torch.from_numpy(x), *targs, mat)
    want = jops.slr_matmul(jnp.asarray(x), *jargs, jmat, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert got.shape == (6, 24) and not any(ops.launch_counts().values())


def test_cpu_wrappers_take_plain_versions_and_count_nothing():
    """A CPU tensor runs the plain version without launching; a tensor on any
    other non-CUDA device is refused, never silently computed."""
    ops.reset_launch_counts()
    x = torch.ones((2, 4))
    p, vt = torch.ones((4, 2)), torch.ones((2, 3))
    torch.testing.assert_close(ops.lowrank_matmul(x, p, vt), ref.lowrank_matmul_ref(x, p, vt))
    assert not any(ops.launch_counts().values())
    with pytest.raises(ValueError, match="CUDA"):
        ops.lowrank_matmul(x.to("meta"), p.to("meta"), vt.to("meta"))


def test_row_tile_matches_jax():
    from repro.kernels.slr_matmul import row_tile as jax_row_tile

    for t in (1, 8, 9, 100, 300):
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            assert row_tile(t, tdt) == jax_row_tile(t, jdt)
            assert row_tile(t, tdt, cap=32) == jax_row_tile(t, jdt, cap=32)


def pooled_tables(rng, n_tab, k, m, r, bs, occupancy):
    """Pooled (adapter, layer) tables of both sides: p, vt and a block-CSC
    stack over ``n_tab`` rows, each row with its own ragged live pattern."""
    p = rng.standard_normal((n_tab, k, r), dtype=np.float32) / 4
    vt = rng.standard_normal((n_tab, r, m), dtype=np.float32) / 4
    stack, jstack = both_stacks(rng, n_tab, k, m, bs, occupancy)
    return p, vt, stack, jstack


@pytest.mark.parametrize("bs,t,k,m,r,layers,ids", [
    (8, 3, 40, 36, 5, 2, [2, 0, 1]),
    (32, 1, 96, 70, 12, 1, [1, 1, 0, 2]),
    (128, 5, 256, 200, 9, 1, [0, 2]),
])
def test_slr_matmul_multi_matches_pallas(bs, t, k, m, r, layers, ids):
    """The port's per-slot product against the Pallas multi kernel in
    interpret mode, at a pool of three adapters: ragged T, K and M, ragged
    counts, repeated and permuted slot ids, every layer of the rows."""
    rng = np.random.default_rng(bs + t)
    n_tab = 3 * layers
    p, vt, stack, jstack = pooled_tables(rng, n_tab, k, m, r, bs, 0.6)
    x = rng.standard_normal((len(ids), t, k), dtype=np.float32)
    ids_np = np.asarray(ids, np.int32)
    for layer in range(layers):
        got = ops.slr_matmul_multi(torch.from_numpy(x), torch.from_numpy(p),
                                   torch.from_numpy(vt), stack, torch.from_numpy(ids_np),
                                   layers, layer)
        want = jops.slr_matmul_multi(jnp.asarray(x), jnp.asarray(p), jnp.asarray(vt), jstack,
                                     jnp.asarray(ids_np * layers + layer), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("corner", ["fused", "empty_s", "rank_0", "both_empty"])
def test_slr_matmul_multi_corners_match_reference(corner):
    """The dispatcher's corners against the JAX dispatcher (its reference
    off the TPU) at a pool of eight rows, slots permuted: an empty S is the
    low-rank product per slot, r == 0 the fused product with zero factors,
    neither part gives zeros."""
    rng = np.random.default_rng(7)
    n_tab, k, m, r = 8, 48, 40, 6
    p, vt, stack, jstack = pooled_tables(rng, n_tab, k, m, r, 8,
                                         0.0 if corner in ("empty_s", "both_empty") else 0.5)
    x = rng.standard_normal((5, 9, k), dtype=np.float32)
    ids = np.array([7, 3, 0, 3, 5], np.int32)
    tp, tvt, jp, jvt = torch.from_numpy(p), torch.from_numpy(vt), jnp.asarray(p), jnp.asarray(vt)
    if corner in ("rank_0", "both_empty"):
        tp = tvt = jp = jvt = None
        if corner == "both_empty":
            tvt, jvt = torch.zeros((n_tab, 0, m)), jnp.zeros((n_tab, 0, m))
    got = ops.slr_matmul_multi(torch.from_numpy(x), tp, tvt, stack, torch.from_numpy(ids))
    want = jops.slr_matmul_multi(jnp.asarray(x), jp, jvt, jstack, jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if corner == "empty_s":
        for b, i in enumerate(ids):
            torch.testing.assert_close(got[b], ref.lowrank_matmul_ref(
                torch.from_numpy(x[b]), tp[i], tvt[i]), rtol=0, atol=0)


def test_slr_matmul_multi_slot_permutation():
    """Permuting the slots permutes the output; a one-row pool equals the
    stacked product on the flattened rows, bit for bit on the CPU."""
    rng = np.random.default_rng(11)
    n_tab, k, m, r = 4, 64, 48, 7
    p, vt, stack, _ = pooled_tables(rng, n_tab, k, m, r, 16, 0.5)
    x = torch.from_numpy(rng.standard_normal((6, 4, k), dtype=np.float32))
    ids = torch.tensor([3, 1, 1, 0, 2, 3], dtype=torch.int32)
    perm = torch.tensor([4, 0, 5, 2, 1, 3])
    tp, tvt = torch.from_numpy(p), torch.from_numpy(vt)
    y = ops.slr_matmul_multi(x, tp, tvt, stack, ids)
    torch.testing.assert_close(ops.slr_matmul_multi(x[perm], tp, tvt, stack, ids[perm]),
                               y[perm], rtol=0, atol=0)
    same = torch.full((6,), 2, dtype=torch.int32)
    torch.testing.assert_close(
        ops.slr_matmul_multi(x, tp, tvt, stack, same).reshape(-1, m),
        ops.slr_matmul_stacked(x.reshape(-1, k), tp, tvt, stack, 2), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_soft_threshold_matches_pallas(dtype):
    """A batch of three ragged (37, 61) blocks with a threshold each: 0 (the
    identity), a shrink, and one above max |x| (all zeros); NaN stays NaN and
    +-inf stays +-inf. The Pallas kernel shrinks one block by one scalar, so
    it runs per block; tau is cast to x's dtype on both sides, and the two
    agree exactly (the one rounding is that of |x| - tau)."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 37, 61)) * 2).astype(np.float32)
    x[0, 0, :4] = [np.nan, np.inf, -np.inf, 0.0]
    x[1, 3, 5:8] = [np.nan, np.inf, -np.inf]
    x[2, 36, 60] = np.nan
    tau = np.array([0.0, 0.7, 100.0], np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tx = torch.from_numpy(x).to(tdt)
    got = ops.soft_threshold(tx, torch.from_numpy(tau)).float().numpy()
    want = np.stack([np.asarray(jops.soft_threshold(jnp.asarray(x[b], jdt), float(tau[b]),
                                                    interpret=True), np.float32)
                     for b in range(3)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], tx[0].float().numpy())      # tau = 0
    assert np.isnan(got[2, 36, 60]) and np.count_nonzero(np.nan_to_num(got[2])) == 0
    assert got[1, 3, 6] == np.inf and got[1, 3, 7] == -np.inf and np.isnan(got[1, 3, 5])
    assert ops.soft_threshold.launches == 0          # the CPU runs the plain version


# The fused body's launch plan: (K, r, M, bs) of the main path's seven sites
# (salaad_llama_60m at full width) and the ragged shapes above, f32 and bf16.
PLAN_SHAPES = [
    (512, 128, 512, 128), (512, 128, 1376, 32), (1376, 128, 512, 32),
    (40, 5, 36, 8), (96, 12, 64, 32), (96, 12, 70, 32), (256, 9, 200, 128),
]


@pytest.mark.parametrize("k,r,m,bs", PLAN_SHAPES)
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("clusters", [15, 30])
def test_fused_plan_partition_ignores_rows(k, r, m, bs, itemsize, clusters):
    """The reduction partition of every output element (K splits for x @ P,
    segments of each column block's axis) is the same for T in {1, 8, 37,
    512} and B in {1, 8}: a row of y cannot depend on the call that carries
    it. Only the row tile and the column groups per cluster follow the rows,
    and every plan fits the shared memory and covers K. The card's residency
    is a fixed count of resident clusters (on the card the wrappers ask
    ``cudaOccupancyMaxActiveClusters``)."""
    def resident(bt, smem):
        return clusters

    plans = {(t, b): fused_plan(k, r, m, bs, -(-k // bs), itemsize, t * b, resident)
             for t in (1, 8, 37, 512) for b in (1, 8)}
    assert len({pl.partition for pl in plans.values()}) == 1
    for (t, b), pl in plans.items():
        assert pl.cluster * pl.kseg >= k and pl.kseg % 16 == 0
        assert pl.cluster % pl.nseg == 0 and pl.loops >= 1
        assert pl.bt in (8, 32) and (pl.bt == 8) == (t * b <= 8)
        assert 1 <= pl.ypn <= pl.loops
        nbytes = fused_smem_bytes(pl.bt, bs, r, itemsize, pl.nseg, pl.loops, pl.ypn, -(-k // bs))
        assert nbytes <= 232448
    # a decode call's clusters fit in one wave of the card's resident
    # clusters, with as many segments per column block as fit
    jb = -(-m // bs)
    decode = plans[(8, 1)]
    assert decode.loops == 1
    assert -(-jb // (decode.cluster // decode.nseg)) <= clusters or decode.nseg == 1
    if decode.nseg < decode.cluster:
        assert -(-jb // (decode.cluster // (2 * decode.nseg))) > clusters


# The unstacked entry's launch plan: (K, M, r, bs) of Zamba2's shared block
# (q, gate, down at r = 640 and bs = 128; gate at bs = 32) and ragged shapes.
UNSTACKED_SHAPES = [
    (2560, 2560, 640, 128), (2560, 10240, 640, 128), (10240, 2560, 640, 128),
    (2560, 10240, 320, 32), (300, 260, 130, 32), (40, 36, 5, 8), (200, 130, 17, 64),
]


@pytest.mark.parametrize("k,m,r,bs", UNSTACKED_SHAPES)
@pytest.mark.parametrize("itemsize", [4, 2])
def test_unstacked_plan_ignores_rows_within_a_class(k, m, r, bs, itemsize):
    """The unstacked kernel's splits (column parts and segments per column
    block, K per x @ P block) come from the table shape only: one plan for
    every T of a row-tile class (T = 1: one-row tiles; 2 <= T <= 8: 8; T > 8:
    32), the same splits in every class, and shared memory within the card's
    227 KB."""
    maxb = -(-k // bs)
    classes = [{unstacked_plan(k, r, bs, maxb, itemsize, t) for t in ts}
               for ts in ((1,), range(2, 9), (9, 37, 64, 512))]
    assert [len(c) for c in classes] == [1, 1, 1]
    plans = [c.pop() for c in classes]
    assert [pl.bt for pl in plans] == [1, 8, 32]
    assert len({(pl.nseg, pl.cs, pl.kseg, pl.rp) for pl in plans}) == 1
    pl = plans[0]
    # eight streaming blocks per column block: two 64-wide parts of 4
    # segments at bs = 128, else 8 segments of the whole block
    assert (pl.cs, pl.nseg) == ((2, 4) if bs == 128 else (1, 8))
    assert 8 * pl.kseg >= k > 8 * (pl.kseg - 1)
    assert pl.rp % 32 == 0 and r <= pl.rp < r + 32
    for pl in plans:
        assert pl.smem == unstacked_smem_bytes(pl.bt, bs, itemsize, maxb)
        assert max(pl.smem, pl.xp_smem) <= FUSED_MAX_SMEM


@pytest.mark.parametrize("k,m,r,bs", UNSTACKED_SHAPES)
def test_unstacked_segments_cover_each_stage_once(k, m, r, bs):
    """Every stage of every column block (its live tiles' stages, then its
    rank stages) is summed by exactly one segment, whatever the column
    block's count of live tiles, at the plan's segment count."""
    rng = np.random.default_rng(k + m)
    ks = unstacked_stage_rows(bs)
    maxb = -(-k // bs)
    nseg = unstacked_plan(k, r, bs, maxb, 4, 1).nseg
    n_rank = -(-r // ks)
    for count in sorted({0, 1, maxb, *rng.integers(0, maxb + 1, 8).tolist()}):
        n_tile = count * (bs // ks)
        segs = unstacked_segments(n_tile, n_rank, nseg)
        assert len(segs) == nseg
        tiles = [i for t_range, _ in segs for i in t_range]
        ranks = [i for _, r_range in segs for i in r_range]
        assert tiles == list(range(n_tile)) and ranks == list(range(n_rank))


def test_unstacked_plan_refuses_what_does_not_fit():
    """A K whose x @ P block would hold more than 227 KB of x rows (8 rows
    of a decode call) raises; one row of the same K fits."""
    with pytest.raises(ValueError, match="shared memory"):
        unstacked_plan(60000, 64, 128, 469, 4, 8)
    assert unstacked_plan(60000, 64, 128, 469, 4, 1).bt == 1


# The stream kernel's plans (block-CSC and low-rank): every linear site of the
# four salaad_llama_* configs and of zamba2_2p7b's shared block, at the block
# size deployment gives it (128 halved until it divides both dims, floor 8).
def _deployed_bs(n, m, bs=128):
    while (n % bs or m % bs) and bs > 8:
        bs //= 2
    return bs


def _sites():
    out = set()
    for arch in ("salaad_llama_60m", "salaad_llama_130m", "salaad_llama_350m",
                 "salaad_llama_1b", "zamba2_2p7b"):
        c = get_arch(arch)
        attn, kv = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
        for n, m in ((c.d_model, attn), (c.d_model, kv), (attn, c.d_model),
                     (c.d_model, c.d_ff), (c.d_ff, c.d_model)):
            out.add((n, m, _deployed_bs(n, m)))
    return sorted(out)


STREAM_SITES = _sites() + [(40, 36, 8), (64, 48, 16), (200, 130, 64), (70, 90, 32)]
ITEMSIZES = [(4, 4), (2, 2), (2, 4)]     # (x, tables): f32, bf16, bf16 x over f32 tables


@pytest.mark.parametrize("n,m,bs", STREAM_SITES)
@pytest.mark.parametrize("x_size,w_size", ITEMSIZES)
def test_stream_plans_fit_every_site(n, m, bs, x_size, w_size):
    """Every cut of every plan (8 or 64 rows per block, split or walk) fits
    the card's 227 KB of shared memory at full MAXB and full rank."""
    maxb = -(-n // bs)
    plans = [bsr_plan(n, m, bs, maxb, x_size, w_size, 132)]
    for r in sorted({min(n, m), 128, 5}):
        lp = lowrank_plan(n, r, m, x_size, w_size, 132)
        plans += [lp.xp, lp.tv]
        assert lp.rp % 4 == 0 and r <= lp.rp < r + 4
    for pl in plans:
        for xrows in (8, 64):
            for split in (False, True):
                assert pl.smem(xrows, split) <= MAX_SMEM
        assert pl.smem(64, True) == stream_smem_bytes(pl.bnb, pl.ks, 64, pl.x_size, pl.w_size,
                                                      pl.nseg > 1, pl.ncols)
        assert pl.nseg in (1, 2, 4, 8) and pl.bnb in (16, 32, 64) and pl.ks % 8 == 0


@pytest.mark.parametrize("n,m,bs", STREAM_SITES)
@pytest.mark.parametrize("x_size,w_size", ITEMSIZES)
def test_stream_plans_ignore_rows(n, m, bs, x_size, w_size, monkeypatch):
    """The sums' partition (columns per block, stage rows, segments) comes
    from the table's shape: the low-rank wrapper launches the same partition
    for T in {1, 8, 37, 512} and B in {1, 8}, one table row or per slot;
    only the rows per block (8 at T <= 8, else 64) and split or walk follow
    the call, and every cut fits the shared memory."""
    launched = []
    monkeypatch.setattr(lowrank_mod, "launch", lambda name, dev, *args: launched.append(args))
    monkeypatch.setattr(lowrank_mod, "card_sms", lambda device: 132)
    maxb = -(-n // bs)
    r = min(n, m, 128)
    pl = bsr_plan(n, m, bs, maxb, x_size, w_size, 132)
    dt = {2: torch.bfloat16, 4: torch.float32}
    p, vt = torch.zeros((2, n, r), dtype=dt[w_size]), torch.zeros((2, r, m), dtype=dt[w_size])
    cuts = {}
    for t in (1, 8, 37, 512):
        for b in (1, 8):
            xrows, split = pl.cut(t, b)
            assert xrows == (8 if t <= 8 else 64)
            assert pl.smem(xrows, bool(split)) <= MAX_SMEM
            x = torch.zeros((b, t, n), dtype=dt[x_size])
            y = torch.empty((b, t, m), dtype=x.dtype)
            if b == 1:
                lowrank_launch(x, p[0], vt[0], y)
            if x_size == w_size:
                lowrank_launch(x, p, vt, y, torch.zeros(b, dtype=torch.int32), 2, 1)
            cuts[(t, b)] = xrows, split
    # (x, p, vt, ids, t, y, B, T, K, M, r, rp, layers, layer, N, nseg_p, nseg_v, xrows,
    #  split_p, split_v, dtype, wdtype)
    assert len({a[9:12] + a[15:17] for a in launched}) == 1
    assert {a[17] for a in launched} == {8, 64}
    assert len({xr for xr, _ in cuts.values()}) == 2


@pytest.mark.parametrize("n,m,bs", STREAM_SITES)
def test_bsr_segments_cover_each_stage_once(n, m, bs):
    """Every stage of every column block is summed by exactly one segment,
    in order, whatever the column block's count of live tiles; and the walk
    (one block folding its chain into the running sum at each segment's
    end, as the kernel's loop does) folds the same segments in the same
    order as the cluster (one block per segment, partials summed in
    segment order)."""
    rng = np.random.default_rng(n + m)
    maxb = -(-n // bs)
    pl = bsr_plan(n, m, bs, maxb, 4, 4, 132)
    for count in sorted({0, 1, maxb, *rng.integers(0, maxb + 1, 8).tolist()}):
        n_st = count * (bs // pl.ks)
        segs = stream_segments(n_st, pl.nseg)
        assert len(segs) == pl.nseg
        assert [i for seg in segs for i in seg] == list(range(n_st))
        # the walk's folds: after stage i, fold each segment that ends at i + 1
        folds, chain, sg = [], [], 0
        seg_end = n_st // pl.nseg
        while sg < pl.nseg and seg_end == 0:
            folds.append(chain); chain = []; sg += 1; seg_end = n_st * (sg + 1) // pl.nseg
        for i in range(n_st):
            chain.append(i)
            while sg < pl.nseg and seg_end == i + 1:
                folds.append(chain); chain = []; sg += 1; seg_end = n_st * (sg + 1) // pl.nseg
        assert folds == [list(seg) for seg in segs]


def test_stream_plans_refuse_what_does_not_fit():
    """A block-CSC table whose live-tile rows would not fit a block's shared
    memory raises, as does a block size the kernel has no instance for."""
    with pytest.raises(ValueError, match="shared memory"):
        bsr_plan(8 * 60000, 64, 8, 60000, 4, 4, 132)
    with pytest.raises(ValueError, match="block size"):
        bsr_plan(96, 96, 24, 4, 4, 4, 132)
    assert bsr_plan(8 * 4000, 64, 8, 4000, 4, 4, 132).nseg == 8
