"""The page-copy kernel's launch plan and the soft-threshold and page-copy
wrappers' launches, on the CPU.

``page_copy_plan`` cuts each (pair, layer) page into units of a chunk and
sizes the grid from the SM count and the blocks per SM it is given. Here:
every byte is covered once, units are 16-byte aligned multiples of 16 bytes,
the grid follows the SM count, and the wrappers pass their cut to the C
entry points (through meta tensors, which reach the launch without a card).
``soft_threshold``'s C entry cuts its call itself, from x's and out's
addresses. ``tests/test_torch_gpu.py`` holds both kernels against
``kernels/ref.py`` on the card.
"""
import pytest
import torch

from repro_torch.kernels import page_copy as pc
from repro_torch.kernels import soft_threshold as st

SMS = [132, 114, 16, 1]


def resident(chunk: int) -> int:
    """Blocks per SM as the occupancy API gives them for 256 threads."""
    return 8


PAGES = [(8, 8, 32768), (64, 8, 32768), (1, 1, 105), (3, 2, 8064), (8, 54, 512),
         (8, 8, 4096 * 3 + 16), (2, 4, 210), (16, 8, 131072), (1, 2, 16)]


@pytest.mark.parametrize("n_pairs,n_layers,page_bytes", PAGES)
@pytest.mark.parametrize("sms", SMS)
def test_copy_plan_covers_each_byte_once(n_pairs, n_layers, page_bytes, sms):
    """Each (pair, layer) page's units tile its bytes 0 .. page_bytes - 1
    once, in order; every unit starts on a 16-byte offset and is a multiple
    of 16 bytes but for the last of a page whose size is not; the chunk is
    the largest whose units cover every SM (or the smallest); the grid is
    the card's resident blocks or the units, whichever is fewer."""
    plan = pc.page_copy_plan(n_pairs, n_layers, page_bytes, sms, resident)
    seen = {}
    for u in range(plan.units):
        pair, layer, first, nbytes = plan.unit(u)
        seen.setdefault((pair, layer), []).append((first, first + nbytes))
        assert first % 16 == 0 and nbytes > 0
        assert nbytes % 16 == 0 or first + nbytes == page_bytes
    assert sorted(seen) == [(p, l) for p in range(n_pairs) for l in range(n_layers)]
    for ranges in seen.values():
        assert ranges[0][0] == 0 and ranges[-1][1] == page_bytes
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    covering = [c for c in pc.CHUNKS if n_pairs * n_layers * -(-page_bytes // c) >= sms]
    assert plan.chunk == (covering[0] if covering else pc.CHUNKS[-1])
    assert plan.grid == max(1, min(plan.units, sms * resident(plan.chunk)))


def test_copy_plan_at_the_engine_shape():
    """The engine's copy-on-write call (8 pairs of 8-layer 32 KB pages) takes
    256 units of 8 KB on 132 SMs: more units than SMs, one a block, all in
    flight at once."""
    plan = pc.page_copy_plan(8, 8, 32768, 132, resident)
    assert (plan.chunk, plan.chunks, plan.units, plan.grid) == (8192, 4, 256, 256)


def test_wrappers_launch_their_plans(monkeypatch):
    """The wrappers pass their cut to the C entry points and count one
    launch per call: soft-threshold the slice length, the element count and
    the dtype (nb above 65535 is a plain call), page copy its plan's chunk
    and grid."""
    launched = []
    for mod in (st, pc):
        monkeypatch.setattr(mod, "check_cuda", lambda name, **tensors: torch.device("meta"))
        monkeypatch.setattr(mod, "launch", lambda name, dev, *args: launched.append((name, args)))
    monkeypatch.setattr(pc, "card_sms", lambda device: 132)
    monkeypatch.setattr(pc, "card_resident", lambda device: resident)
    for wrapper in (st.soft_threshold, pc.page_copy):
        monkeypatch.setattr(wrapper, "launches", 0)
    soft = [((70000, 1, 3), torch.float32, 0), ((8, 512, 1376), torch.bfloat16, 1),
            ((3, 37, 61), torch.float32, 0)]
    for shape, dtype, code in soft:
        x = torch.empty(shape, dtype=dtype, device="meta")
        st.soft_threshold(x, torch.empty((shape[0],), device="meta"))
        name, args = launched.pop()
        numel = x.numel()
        # (x, tau, out, per, numel, dtype)
        assert name == "soft_threshold_launch" and args[3:] == (numel // shape[0], numel, code)
    ids = torch.empty((8,), dtype=torch.int32, device="meta")
    pools = [(8, 128, 8, 16, 64), (3, 40, 3, 5, 7), (54, 130, 8, 16, 64)]
    for shape in pools:
        pool = torch.empty(shape, device="meta")
        pc.page_copy(pool, ids, ids)
        name, args = launched.pop()
        page_bytes = pool[0, 0].numel() * 4
        plan = pc.page_copy_plan(8, shape[0], page_bytes, 132, resident)
        # (pool, src, dst, n_pairs, n_layers, n_pages, page_bytes, chunk, grid)
        assert name == "page_copy_launch"
        assert args[3:] == (8, shape[0], shape[1], page_bytes, plan.chunk, plan.grid)
    assert st.soft_threshold.launches == len(soft) and pc.page_copy.launches == len(pools)
