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
from repro.kernels.slr_matmul import stack_bsr as jax_stack_bsr
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bsr_matmul import bsr_from_dense, bsr_to_dense
from repro_torch.kernels.slr_matmul import row_tile, stack_bsr

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
