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

import pytest
import torch

from repro_torch.kernels import paged_attention as pa

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
