"""The port's int8 gradient all-reduce (``parallel/compression.py``) against
the JAX package's ``repro/parallel/compression.py``.

* ``quantize_int8`` / ``dequantize_int8`` bit for bit against JAX's on the
  same arrays (ties at half a step round to even on both sides).
* One rank: ``compressed_psum_tree`` (with and without residuals) bit for
  bit against JAX's under a 1-device ``shard_map``, as the JAX package's
  ``tests/test_runtime.py`` runs it.
* 2 and 4 gloo ranks on the CPU (``launch/mesh.py::RankPool``, started once
  for the file, one torch thread each): every rank's mean is bit for bit
  the formula built from JAX's ``quantize_int8`` of each rank's gradient
  (int32 sum of the payloads, times the largest scale, over the ranks), and
  the error-feedback residuals are each rank's own quantization error.
* The counterpart of ``test_error_feedback_reduces_bias``, and
  ``make_compressed_grad_fn`` on 2 ranks against the same formula over each
  rank's rows of the batch, with the bytes a rank sends.

The rank functions import no JAX.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

SHAPES = {"w": (64, 48), "b": (48,), "e": (3, 5, 7)}


def grads_of(rank: int) -> dict:
    rng = np.random.default_rng(10 + rank)
    return {k: (rng.standard_normal(s) * (1 + rank)).astype(np.float32)
            for k, s in SHAPES.items()}


def residuals_of(rank: int) -> dict:
    rng = np.random.default_rng(50 + rank)
    return {k: (rng.standard_normal(s) * 0.01).astype(np.float32) for k, s in SHAPES.items()}


def as_torch(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def as_numpy(tree: dict) -> dict:
    return {k: v.detach().numpy() for k, v in tree.items()}


# ------------------------------------------------------------ rank side ---


def _loss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return ((pred - batch["y"]) ** 2).mean()


def _batch() -> dict:
    rng = np.random.default_rng(3)
    return {"x": torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)),
            "y": torch.from_numpy(rng.standard_normal((8, 48)).astype(np.float32))}


def _params() -> dict:
    rng = np.random.default_rng(4)
    return {"w": torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32) * 0.1),
            "b": torch.zeros(48)}


def _rank_compress(rank):
    from repro_torch.parallel.compression import (
        compressed_psum_tree,
        make_compressed_grad_fn,
        wire_bytes,
    )
    from repro_torch.parallel.sharding import ServingMesh

    out = {}
    for data in (2, 4):
        mesh = ServingMesh.create(data=data)
        if not mesh.member:
            out[data] = None
            continue
        g = as_torch(grads_of(rank))
        mean = compressed_psum_tree(g, mesh)
        ef_mean, new_r = compressed_psum_tree(g, mesh, as_torch(residuals_of(rank)))
        out[data] = {"mean": as_numpy(mean), "ef_mean": as_numpy(ef_mean),
                     "new_r": as_numpy(new_r)}
    mesh = ServingMesh.create(data=2)
    if mesh.member:
        params = _params()
        fn = make_compressed_grad_fn(_loss, mesh)
        got = fn(params, _batch())
        rows = slice(4 * mesh.data_index, 4 * mesh.data_index + 4)
        local = {"x": _batch()["x"][rows], "y": _batch()["y"][rows]}
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        exact = torch.autograd.grad(_loss(leaves, local), list(leaves.values()))
        out["grad_fn"] = {"got": as_numpy(got), "local": [g.numpy() for g in exact],
                          "bytes": wire_bytes(params)}
    return out


# ------------------------------------------------------------- JAX side ---


def jax_formula(grads: list[dict], residuals: list[dict] | None = None):
    """The reduction the JAX package's psums make, from JAX's
    ``quantize_int8`` of each rank's (error-fed) gradient: int32 sum of the
    payloads, times the largest scale, over the number of ranks."""
    import jax.numpy as jnp

    from repro.parallel.compression import quantize_int8

    out = {}
    for k in grads[0]:
        g32 = [jnp.asarray(g[k]) + (jnp.asarray(residuals[i][k]) if residuals else 0)
               for i, g in enumerate(grads)]
        qs = [quantize_int8(g) for g in g32]
        acc = functools.reduce(jnp.add, [q.astype(jnp.int32) for q, _ in qs])
        scale = functools.reduce(jnp.maximum, [s for _, s in qs])
        n = jnp.asarray(float(len(grads)), jnp.float32)
        out[k] = np.asarray((acc.astype(jnp.float32) * scale / n).astype(jnp.float32))
    return out


@pytest.fixture(scope="module")
def runs():
    from repro_torch.launch.mesh import RankPool

    pool = RankPool(4, "cpu", threads=1)
    try:
        ranks = pool.run(_rank_compress, timeout=300)
    finally:
        pool.close()
    return SimpleNamespace(ranks=ranks)


# ------------------------------------------------------------------ tests ---


ARRAYS = {
    "normal": np.random.default_rng(0).standard_normal(1000).astype(np.float32),
    "halves": (np.arange(-40, 41, dtype=np.float32) + 0.5) / 40 * 127 / 127,
    "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 63.5, 0.0], np.float32),
    "zeros": np.zeros(16, np.float32),
    "wide": np.random.default_rng(1).standard_normal((8, 9)).astype(np.float32) * 1e4,
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_quantize_int8_bit_equal_to_jax(name):
    import jax.numpy as jnp

    from repro.parallel.compression import dequantize_int8 as jdequant
    from repro.parallel.compression import quantize_int8 as jquant
    from repro_torch.parallel.compression import dequantize_int8, quantize_int8

    a = ARRAYS[name]
    q, s = quantize_int8(torch.from_numpy(a))
    jq, js = jquant(jnp.asarray(a))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    assert np.array_equal(dequantize_int8(q, s).numpy(), np.asarray(jdequant(jq, js)))


@pytest.mark.parametrize("residual", [False, True])
def test_one_rank_bit_equal_to_jax_shard_map(residual):
    """A group of one rank against JAX's ``compressed_psum_tree`` inside a
    1-device ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.parallel.compression import compressed_psum_tree as jax_cpt
    from repro_torch.parallel.compression import compressed_psum_tree
    from repro_torch.parallel.sharding import ServingMesh

    g, r = grads_of(0), residuals_of(0)
    mesh = jax.make_mesh((1,), ("data",))
    spec = {k: P("data") for k in g}
    if residual:
        fn = shard_map(lambda a, b: jax_cpt(jax.tree.map(lambda x: x[0], a), "data",
                                            jax.tree.map(lambda x: x[0], b)),
                       mesh=mesh, in_specs=(spec, spec), out_specs=P(), check_rep=False)
        want, want_r = fn({k: jnp.asarray(v)[None] for k, v in g.items()},
                          {k: jnp.asarray(v)[None] for k, v in r.items()})
        got, got_r = compressed_psum_tree(as_torch(g), ServingMesh(1, 1), as_torch(r))
        for k in g:
            assert np.array_equal(got_r[k].numpy(), np.asarray(want_r[k])), k
    else:
        fn = shard_map(lambda a: jax_cpt(jax.tree.map(lambda x: x[0], a), "data"),
                       mesh=mesh, in_specs=(spec,), out_specs=P(), check_rep=False)
        want = fn({k: jnp.asarray(v)[None] for k, v in g.items()})
        got = compressed_psum_tree(as_torch(g), ServingMesh(1, 1))
    for k in g:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k


@pytest.mark.parametrize("data", [2, 4])
def test_ranks_match_the_exact_int_formula(runs, data):
    recs = [(rank, r[data]) for rank, r in enumerate(runs.ranks) if r[data] is not None]
    assert len(recs) == data
    grads = [grads_of(rank) for rank, _ in recs]
    res = [residuals_of(rank) for rank, _ in recs]
    want, want_ef = jax_formula(grads), jax_formula(grads, res)
    for rank, rec in recs:
        for k in SHAPES:
            assert np.array_equal(rec["mean"][k], want[k]), (rank, k)
            assert np.array_equal(rec["ef_mean"][k], want_ef[k]), (rank, k)
            # the residual is this rank's own quantization error
            g32 = grads[rank][k] + res[rank][k]
            scale = np.abs(g32).max() / np.float32(127.0) + np.float32(1e-12)
            assert np.abs(rec["new_r"][k]).max() <= 0.5 * scale * (1 + 1e-6), (rank, k)


def test_error_feedback_reduces_bias():
    """A small constant gradient survives ten hard-quantized steps with error
    feedback (the JAX package's check, on one rank)."""
    from repro_torch.parallel.compression import compressed_psum_tree

    g = {"w": torch.full((64,), 0.003)}
    r = {"w": torch.zeros(64)}
    total = torch.zeros(64)
    for _ in range(10):
        out, r = compressed_psum_tree(g, None, r)
        total = total + out["w"]
    np.testing.assert_allclose(total.numpy(), 0.03 * np.ones(64), rtol=0.2)


def test_compressed_grad_fn_on_two_ranks(runs):
    """Each rank differentiates the loss on its 4 of the 8 rows; both get
    the formula over their exact local gradients, bit for bit."""
    recs = [r["grad_fn"] for r in runs.ranks if "grad_fn" in r]
    assert len(recs) == 2
    local = [dict(zip(("w", "b"), r["local"])) for r in recs]
    want = jax_formula(local)
    for rec in recs:
        for k in ("w", "b"):
            assert np.array_equal(rec["got"][k], want[k]), k
        assert rec["bytes"] == 64 * 48 + 48 + 2 * 4
