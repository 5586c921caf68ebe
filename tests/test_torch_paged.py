"""The paged attention kernels' launch plan, on the CPU.

``paged_plan`` cuts the key axis of a (slot, KV head, row tile) into
segments, one block of a thread-block cluster each, from the table shape,
the head dim, the dtype and the card's cluster limit (decode; k-query takes
one segment). It never reads B or a slot's length, so a slot's output is
the same bit for bit alone or in any batch, which
``tests/test_torch_gpu.py::test_paged_attention_rows_ignore_batch`` holds on
the card. Here: every key position falls in exactly one segment, the limit
holds, and the wrappers launch one plan whatever the batch and lengths
(through meta tensors, which reach the launch without a card).
"""
import inspect
from types import SimpleNamespace

import pytest
import torch

from repro_torch.kernels import paged_attention as pa
from repro_torch.serving.engine import page_pools

TABLES = [(1, 1), (6, 4), (5, 8), (9, 8), (8, 4), (32, 16), (20, 16), (12, 32), (600, 4),
          (80, 32), (160, 16), (128, 16), (2048, 16), (1, 256), (3, 100)]
HEADS = [(64, 4), (64, 2), (80, 4), (128, 4), (129, 4), (256, 4), (256, 2), (16, 2)]


@pytest.mark.parametrize("nb,bs", TABLES)
@pytest.mark.parametrize("d,itemsize", HEADS)
@pytest.mark.parametrize("limit", [1, 2, 8])
def test_paged_plan_covers_each_key_once(nb, bs, d, itemsize, limit):
    """The segments cover positions 0 .. nb bs - 1 once each, in order, none
    empty; a segment is whole chunks (64 keys, 32 for f32 above D 128, as
    ``chunk_keys`` in the source), at least MIN_SEGMENT_CHUNKS and as few
    more as keep nseg within the limit."""
    plan = pa.paged_plan(nb, bs, d, itemsize, max_segments=limit)
    n_keys = nb * bs
    segs = [range(i * plan.seg_keys, min((i + 1) * plan.seg_keys, n_keys))
            for i in range(plan.nseg)]      # what the kernel's block of rank i walks
    assert [k for seg in segs for k in seg] == list(range(n_keys))
    assert all(len(seg) > 0 for seg in segs)
    assert 1 <= plan.nseg <= limit <= pa.MAX_SEGMENTS
    assert plan.chunk == (32 if itemsize == 4 and d > 128 else 64)
    assert plan.seg_keys % plan.chunk == 0
    chunks = -(-n_keys // plan.chunk)
    assert plan.seg_keys // plan.chunk == max(pa.MIN_SEGMENT_CHUNKS, -(-chunks // limit))


def test_paged_plan_reads_the_table_shape_only():
    """The plan's inputs are the table shape, D, the itemsize and the
    cluster limit: no batch, no lengths, no query count."""
    assert list(inspect.signature(pa.paged_plan).parameters) == [
        "nb", "bs", "d", "itemsize", "max_segments"]
    assert pa.paged_plan(32, 16, 64, 4) == pa.PagedPlan(64, 128, 4)      # the engine's table
    assert pa.paged_plan(128, 16, 64, 4) == pa.PagedPlan(64, 256, 8)
    assert pa.paged_plan(6, 4, 32, 4) == pa.PagedPlan(64, 128, 1)
    assert pa.paged_plan(32, 16, 64, 4, max_segments=1) == pa.PagedPlan(64, 512, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kq,hq,hkv,d,bs,nb", [(1, 8, 8, 64, 16, 32), (1, 32, 2, 128, 8, 5),
                                                (64, 8, 8, 64, 16, 32), (21, 16, 4, 256, 16, 160)])
def test_wrappers_launch_one_plan_for_any_batch(monkeypatch, dtype, kq, hq, hkv, d, bs, nb):
    """The decode and k-query wrappers pass the same segment length for B in
    1, 3 and 8 (decode: paged_plan's; k-query: one segment); only B itself
    differs. The lengths are meta tensors: the host side never reads them."""
    launched = []
    monkeypatch.setattr(pa, "check_cuda", lambda name, **tensors: torch.device("meta"))
    monkeypatch.setattr(pa, "launch", lambda name, dev, *args: launched.append((name, args)))
    for wrapper in (pa.paged_attention, pa.paged_attention_kquery):
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)   # restored afterwards
    pool = torch.empty((nb * 8, hkv, bs, d), dtype=dtype, device="meta")
    for b in (1, 3, 8):
        table = torch.empty((b, nb), dtype=torch.int32, device="meta")
        lengths = torch.empty((b,), dtype=torch.int32, device="meta")
        if kq == 1:
            pa.paged_attention(torch.empty((b, hq, d), dtype=dtype, device="meta"), pool, pool,
                               table, lengths)
        else:
            pa.paged_attention_kquery(torch.empty((b, hq, kq, d), dtype=dtype, device="meta"),
                                      pool, pool, table, lengths)
    names = {name for name, _ in launched}
    assert names == {"paged_attention_launch" if kq == 1 else "paged_attention_kquery_launch"}
    # (q, k, v, table, lengths, out, B, Hq, Hkv, [kq,] D, N, bs, nb, seg_keys, dtype)
    tails = {args[7:] for _, args in launched}
    assert len(tails) == 1
    (tail,) = tails
    plan = pa.paged_plan(nb, bs, d, torch.empty((), dtype=dtype).element_size(),
                         max_segments=pa.MAX_SEGMENTS if kq == 1 else 1)
    assert tail[-2] == plan.seg_keys
    assert [args[6] for _, args in launched] == [1, 3, 8]


@pytest.mark.parametrize("kq,d", [(1, 64), (4, 64), (21, 256), (1, 256)])
def test_f32_over_bf16_takes_the_mixed_instance(monkeypatch, kq, d):
    """f32 queries over bf16 pools launch dtype code 2 (``F32_OVER_BF16``)
    with the bf16 pool's plan (64-key chunks, also at D > 128 where an f32
    pool takes 32) and an f32 output."""
    launched = []
    monkeypatch.setattr(pa, "check_cuda", lambda name, **tensors: torch.device("meta"))
    monkeypatch.setattr(pa, "launch", lambda name, dev, *args: launched.append(args))
    for wrapper in (pa.paged_attention, pa.paged_attention_kquery):
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    nb, bs, hkv = 20, 16, 2
    pool = torch.empty((nb * 3, hkv, bs, d), dtype=torch.bfloat16, device="meta")
    table = torch.empty((3, nb), dtype=torch.int32, device="meta")
    lengths = torch.empty((3,), dtype=torch.int32, device="meta")
    shape = (3, 4, d) if kq == 1 else (3, 4, kq, d)
    q = torch.empty(shape, dtype=torch.float32, device="meta")
    fn = pa.paged_attention if kq == 1 else pa.paged_attention_kquery
    out = fn(q, pool, pool, table, lengths)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    (args,) = launched
    assert args[-1] == pa.F32_OVER_BF16 == 2
    plan = pa.paged_plan(nb, bs, d, 2, max_segments=pa.MAX_SEGMENTS if kq == 1 else 1)
    assert args[-2] == plan.seg_keys and plan.chunk == 64


def test_dtype_route_names_the_pairs():
    f32, bf16 = torch.float32, torch.bfloat16
    assert pa.dtype_route("x", f32, f32, f32) == 0
    assert pa.dtype_route("x", bf16, bf16, bf16) == 1
    assert pa.dtype_route("x", f32, bf16, bf16) == pa.F32_OVER_BF16
    for pair in ((bf16, f32, f32), (f32, bf16, f32), (f32, torch.int8, torch.int8),
                 (torch.float16, torch.float16, torch.float16)):
        with pytest.raises(TypeError, match="float32 q over bfloat16 pools"):
            pa.dtype_route("x", *pair)


@pytest.mark.parametrize("q_dtype,kv_dtype,taken", [
    (torch.float32, torch.float32, True), (torch.bfloat16, torch.bfloat16, True),
    (torch.float32, torch.bfloat16, True), (torch.bfloat16, torch.float32, False),
    (torch.float32, torch.int8, False), (torch.bfloat16, torch.int8, False),
])
def test_takes_pages_decides_kernel_or_gather(q_dtype, kv_dtype, taken):
    """The one predicate of which pages reach the paged kernels: int8 pages
    never (the dequantizing gather), and the engines refuse float pages it
    does not take under kernel_impl='pallas', naming the field."""
    assert pa.takes_pages(q_dtype, kv_dtype) is taken
    if kv_dtype == torch.int8:
        return
    cfg = SimpleNamespace(kernel_impl="pallas", param_dtype=q_dtype)
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[kv_dtype]
    if taken:
        assert page_pools(cfg, name, "kv_dtype") == (kv_dtype, False)
    else:
        with pytest.raises(TypeError, match=f"kv_dtype='{name}'"):
            page_pools(cfg, name, "kv_dtype")


@pytest.mark.parametrize("kq", [1, 5])
def test_plain_version_widens_bf16_pools(kq):
    """The plain versions take f32 queries over bf16 pools as they are:
    bit for bit the same as over the pools widened to f32 beforehand."""
    from repro_torch.kernels import ref

    g = torch.Generator().manual_seed(kq)
    kp, vp = (torch.randn((12, 2, 4, 16), generator=g).bfloat16() for _ in range(2))
    table = torch.tensor([[0, 1, 2, 12], [5, 6, 7, 8], [3, 4, 9, 10]], dtype=torch.int32)
    lengths = torch.tensor([9, 16 - kq, 0], dtype=torch.int32)
    q = torch.randn((3, 4, kq, 16), generator=g)
    got = ref.paged_attention_kquery_ref(q, kp, vp, table, lengths)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.paged_attention_kquery_ref(q, kp.float(), vp.float(), table,
                                                           lengths))
