"""Fused SLR matmul  y = x @ P @ Vt + x @ S  for one weight and over
layer-stacked tables (port of ``slr_matmul_pallas``,
``slr_matmul_stacked_pallas`` and the host side of
``repro/kernels/slr_matmul.py``).

``BsrStack`` is the layer-stacked block-CSC layout:
    counts  (L, JB)                int32
    rows    (L, JB, MAXB)          int32
    vals    (L, JB, MAXB, bs, bs)  float
``shape`` is the per-layer original dense (n, m); ``empty`` means no layer
holds a live block.

``slr_matmul`` (one unstacked weight, the hybrid's shared block),
``slr_matmul_stacked`` and ``slr_matmul_multi`` (per-slot tables, the port of
``slr_matmul_multi_pallas``) run the plain version for CPU tensors and the
CUDA kernel ``csrc/slr_matmul.cu`` for CUDA tensors; each counts its own
launches. The stacked and per-slot entries share one fused body, cut by
``fused_plan``: its ``partition`` fixes every output element's sums from the
table shape and the card alone, so a row of y never depends on T, B or the
slot that carries it. The unstacked entry's two kernels are cut by
``unstacked_plan`` from the table shape and T's row-tile class.
"""
from __future__ import annotations

import ctypes
import functools
from collections.abc import Callable
from dataclasses import dataclass

import torch

from . import ref
from ._build import check_cuda, check_int32, dtype_code, launch, library, table_dtype_code
from .bsr_matmul import BLOCK_SIZES, BsrMatrix, row_tile
from .lowrank_matmul import lowrank_launch

__all__ = ["BsrStack", "stack_bsr", "row_tile", "slr_matmul", "slr_matmul_stacked",
           "slr_matmul_multi", "BLOCK_SIZES", "FusedPlan", "fused_plan",
           "fused_smem_bytes", "UnstackedPlan", "unstacked_plan", "unstacked_smem_bytes",
           "unstacked_segments", "unstacked_parts", "unstacked_stage_rows"]

# the fused body's constants (kCluster, kStep, kPass, kStages, kMaxSmem in the source)
FUSED_CLUSTER = 8
FUSED_STEP = 32
FUSED_PASS = {8: 128, 32: 64}    # rank columns per pass of x @ P, by row tile
FUSED_STAGES = 3
FUSED_MAX_SMEM = 232448
# the most dynamic shared memory per block at which two blocks share one
# Hopper SM (228 KB per SM, 1 KB of it reserved per block)
FUSED_PAIR_SMEM = 233472 // 2 - 1024


@dataclass(frozen=True)
class FusedPlan:
    """How one call of the fused body is cut.

    ``partition`` = (cluster, nseg, kseg) fixes every output element's sums:
    t = x @ P over ``cluster`` splits of ``kseg`` rows of K (one per block of
    a cluster), each column block's reduction axis (rank chunks, then live
    tiles) over ``nseg`` segments, each split or segment one chain of
    products, the partials summed in rank order. ``bt`` (rows of x per
    block), ``loops`` (column groups a cluster walks in turn) and ``ypn``
    (column groups whose partial tiles are summed at one cluster barrier)
    follow the call's rows and move no sum."""
    cluster: int
    nseg: int
    kseg: int
    bt: int
    loops: int
    ypn: int

    @property
    def partition(self) -> tuple[int, int, int]:
        return self.cluster, self.nseg, self.kseg


def fused_smem_bytes(bt: int, bs: int, r: int, itemsize: int, nseg: int, loops: int,
                     ypn: int, maxb: int) -> int:
    """Dynamic shared memory of one block (``fused_smem`` in the source)."""
    rp = -(-r // FUSED_STEP) * FUSED_STEP + 4
    ldw = max(FUSED_PASS[bt], bs, 16) + 8
    ring = FUSED_STAGES * (bt * (FUSED_STEP + 16 // itemsize) + FUSED_STEP * ldw)
    yp = min(loops, 2 * ypn) if nseg > 1 else 0
    return (4 * 2 * bt * rp + 4 * yp * bt * (bs + 4) + ring * itemsize + 4 * bt
            + 4 * loops * (maxb + 1))


@functools.lru_cache(maxsize=4096)
def fused_plan(k_dim: int, r: int, m_dim: int, bs: int, maxb: int, itemsize: int, rows: int,
               resident: Callable[[int, int], int], keys: int = 1) -> FusedPlan:
    """The launch plan of a fused call over tables of shape (K, r, M, bs)
    with MAXB tile slots per column block in a dtype of ``itemsize`` bytes,
    ``rows`` rows of x (T, or B * T per slot) gathered under at most
    ``keys`` table rows (1 stacked; per slot, the pool rows the slots may
    select). ``resident(bt, smem)`` is the number of clusters of the
    instance with ``bt`` rows per block and ``smem`` bytes of shared memory
    per block that the card holds at once (``card_residency``).

    The partition depends on the shape and the card only: nseg is the most
    segments (1, 2, 4 or 8) whose decode-width call (bt = 8) still fits in
    one wave of clusters. bt is 8 rows for a decode call and 32 otherwise;
    loops is the fewest column groups per cluster that keep every cluster of
    the call resident at once (x @ P once per cluster); ypn the most column
    groups per cluster barrier that keep two blocks on an SM."""
    jb = -(-m_dim // bs)
    c = FUSED_CLUSTER
    kseg = -(-k_dim // (16 * c)) * 16

    def smem(bt, nseg, loops, ypn):
        return fused_smem_bytes(bt, bs, r, itemsize, nseg, loops, ypn, maxb)

    if smem(8, 1, 1, 1) > FUSED_MAX_SMEM:
        raise ValueError(f"fused SLR kernel: rank {r} and {maxb} tile slots exceed "
                         f"{FUSED_MAX_SMEM} bytes of shared memory")
    res8 = resident(8, smem(8, 8, 1, 1))
    nseg = max([n for n in (1, 2, 4, 8) if -(-jb // (c // n)) <= res8] or [1])
    bt = 32 if rows > 8 and smem(32, nseg, 1, 1) <= FUSED_MAX_SMEM else 8
    tiles = -(-rows // bt) + keys - 1     # each key may end in a partial tile
    groups = -(-jb // (c // nseg))
    for loops in range(1, groups + 1):
        ypn = 1
        while ypn < loops and smem(bt, nseg, loops, ypn + 1) <= FUSED_PAIR_SMEM:
            ypn += 1
        nbytes = smem(bt, nseg, loops, ypn)
        if nbytes > FUSED_MAX_SMEM:
            loops = max(1, loops - 1)
            break
        if tiles * -(-groups // loops) <= resident(bt, nbytes):
            break
    ypn = 1
    while ypn < loops and smem(bt, nseg, loops, ypn + 1) <= max(FUSED_PAIR_SMEM,
                                                               smem(bt, nseg, loops, 1)):
        ypn += 1
    return FusedPlan(c, nseg, kseg, bt, loops, ypn)


# the unstacked entry's constants (kUStages, kXPCluster, kXPRows, kXPCols in
# the source)
UNSTACKED_STAGES = 4
XP_CLUSTER = 8
XP_ROWS = 8
XP_COLS = 16
STREAM_BLOCKS = 8    # streaming blocks per column block: nseg x cs


@dataclass(frozen=True)
class UnstackedPlan:
    """How one call of the unstacked entry is cut.

    The x @ P kernel runs clusters of ``XP_CLUSTER`` blocks, block c taking
    rows [c kseg, (c+1) kseg) of K, into t of row stride ``rp`` (r rounded
    up to 32). The streaming kernel runs ``nseg`` blocks (one cluster) per
    (column part, row tile of ``bt`` rows of x), a column block of bs
    columns cut into ``cs`` parts; each block sums one segment of the
    column block's reduction axis (``unstacked_segments``); ``smem`` and
    ``xp_smem`` are the two kernels' dynamic shared memory per block."""
    bt: int
    nseg: int
    kseg: int
    rp: int
    cs: int
    smem: int
    xp_smem: int


def unstacked_parts(bs: int) -> int:
    """Column parts of one column block (CS in the source): a 128-wide
    block streams as two 64-wide parts, each stage a (64, 64) tile."""
    return 2 if bs == 128 else 1


def unstacked_stage_rows(bs: int) -> int:
    """Reduction rows per stage (``stream_rows`` in the source)."""
    return min(bs, unstacked_parts(bs) * FUSED_STEP)


def unstacked_smem_bytes(bt: int, bs: int, itemsize: int, maxb: int) -> int:
    """Dynamic shared memory of one streaming block over one column part
    (``unstacked_smem`` in the source): the ring (or the k-group partials),
    the partial tile, the row indices and the column block's live-tile
    rows."""
    ks, bnb = unstacked_stage_rows(bs), bs // unstacked_parts(bs)
    ring = UNSTACKED_STAGES * (ks * bnb * itemsize + bt * ks * 4)
    red = 16 * 256 * min(bt, 8)          # the k groups' partial tiles
    return max(ring, red) + 4 * bt * bnb + 4 * bt + 4 * maxb


def unstacked_segments(n_tile: int, n_rank: int, nseg: int) -> list[tuple[range, range]]:
    """The stages of one column block that each segment sums, in the
    kernel's order: segment s takes live-tile stages [n_tile s / nseg,
    n_tile (s+1) / nseg) and then rank stages [n_rank s / nseg, n_rank (s+1)
    / nseg) (``n_tile`` = counts[j] x bs / KS, ``n_rank`` = ceil(r / KS),
    KS = ``unstacked_stage_rows(bs)``)."""
    return [(range(n_tile * s // nseg, n_tile * (s + 1) // nseg),
             range(n_rank * s // nseg, n_rank * (s + 1) // nseg)) for s in range(nseg)]


@functools.lru_cache(maxsize=4096)
def unstacked_plan(k_dim: int, r: int, bs: int, maxb: int, itemsize: int,
                   rows: int) -> UnstackedPlan:
    """The launch plan of an unstacked call over tables of shape (K, r, bs)
    with MAXB tile slots per column block, in a dtype of ``itemsize`` bytes,
    for ``rows`` rows of x.

    Every column block streams through ``STREAM_BLOCKS`` blocks: cs parts
    (2 at bs = 128) of nseg segments each. On the card that beat the other
    counts at Zamba2's q, gate and down sites alike (20 to 80 column blocks;
    PERF.md), so the split depends on bs alone, never on T, x or the counts;
    bt is 1 row for a one-row call, 8 for a decode call (T <= 8) and 32
    otherwise. Raises where a block's shared memory would exceed the card's
    227 KB."""
    cs = unstacked_parts(bs)
    nseg = STREAM_BLOCKS // cs
    bt = 1 if rows == 1 else 8 if rows <= 8 else 32
    xp_rows = 1 if bt == 1 else XP_ROWS
    kseg = -(-k_dim // XP_CLUSTER)
    smem = unstacked_smem_bytes(bt, bs, itemsize, maxb)
    xp_smem = 4 * (kseg * xp_rows + 9 * xp_rows * XP_COLS)
    if max(smem, xp_smem) > FUSED_MAX_SMEM:
        raise ValueError(f"unstacked SLR kernel: K={k_dim}, bs={bs} and {maxb} tile slots "
                         f"need {max(smem, xp_smem)} bytes of shared memory per block, more "
                         f"than {FUSED_MAX_SMEM}")
    return UnstackedPlan(bt, nseg, kseg, -(-r // 32) * 32, cs, smem, xp_smem)


@functools.cache
def card_residency(device: int, dtype: torch.dtype, bs: int) -> Callable[[int, int], int]:
    """``fused_plan``'s ``resident`` on CUDA device ``device`` for the fused
    instance of (dtype, bs): the card's own count
    (``cudaOccupancyMaxActiveClusters``), asked once per (bt, smem)."""
    code = dtype_code(dtype)

    @functools.cache
    def resident(bt: int, smem: int) -> int:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = library().slr_fused_resident(code, bs, bt, smem, ctypes.byref(out))
        if err:
            raise RuntimeError(f"slr_fused_resident failed: cudaError {err} on cuda:{device}")
        return max(1, out.value)

    return resident


@dataclass(frozen=True)
class BsrStack:
    counts: torch.Tensor
    rows: torch.Tensor
    vals: torch.Tensor
    shape: tuple[int, int]
    block_size: int
    empty: bool = False

    @property
    def num_layers(self) -> int:
        return self.counts.shape[0]

    def at_layer(self, layer: int) -> BsrMatrix:
        return BsrMatrix(self.counts[layer], self.rows[layer], self.vals[layer],
                         self.shape, self.block_size, empty=self.empty)


def stack_bsr(mats: list[BsrMatrix]) -> BsrStack:
    """Stack per-layer tables, padding every layer to the largest MAXB with
    row-0 / zero-tile slots (dead under ``slot < counts``)."""
    if not mats:
        raise ValueError("stack_bsr needs at least one layer")
    shape, bs = mats[0].shape, mats[0].block_size
    if any(m.shape != shape or m.block_size != bs for m in mats):
        raise ValueError(f"layers disagree on shape/block size: "
                         f"{[(m.shape, m.block_size) for m in mats]}")
    maxb = max(m.rows.shape[1] for m in mats)

    def pad_slots(a):
        pad = maxb - a.shape[1]
        if not pad:
            return a
        return torch.cat([a, a.new_zeros((a.shape[0], pad, *a.shape[2:]))], dim=1)

    return BsrStack(
        torch.stack([m.counts for m in mats]),
        torch.stack([pad_slots(m.rows) for m in mats]),
        torch.stack([pad_slots(m.vals) for m in mats]),
        shape, bs, empty=all(m.empty for m in mats),
    )


def slr_matmul(x: torch.Tensor, p: torch.Tensor, vt: torch.Tensor,
               bsr: BsrMatrix) -> torch.Tensor:
    """One unstacked weight with both parts live: x (T, K), p (K, r),
    vt (r, M), ``bsr`` block-CSC S of shape (K, M) -> y (T, M) in x.dtype.
    The tables share x's dtype, or are float32 under bfloat16 x.

    Two kernels (``unstacked_plan``): t = x @ P into a (T, rp) f32 buffer,
    then the column blocks' live tiles and t @ Vt streamed and summed on
    chip; the second starts on the live tiles while the first runs. The
    launch counter counts the call once."""
    if x.device.type == "cpu":
        return ref.slr_matmul_ref(x, p, vt, bsr)
    name = "slr_matmul"
    dev = check_cuda(name, x=x, p=p, vt=vt, counts=bsr.counts, rows=bsr.rows,
                     vals=bsr.vals)
    code = dtype_code(x.dtype)
    wcode = table_dtype_code(name, x.dtype, p, vt, bsr.vals)
    check_int32(name, counts=bsr.counts, rows=bsr.rows)
    if x.dim() != 2 or p.dim() != 2 or vt.dim() != 2:
        raise ValueError(f"{name}: expected 2-D x, p, vt, got {x.dim()}, {p.dim()}, {vt.dim()}")
    t_dim, k_dim = x.shape
    r, m_dim = vt.shape
    bs = bsr.block_size
    jb, maxb = bsr.rows.shape
    expect = {
        "p": (tuple(p.shape), (k_dim, r)),
        "bsr.shape": (tuple(bsr.shape), (k_dim, m_dim)),
        "counts": (tuple(bsr.counts.shape), (-(-m_dim // bs),)),
        "vals": (tuple(bsr.vals.shape), (jb, maxb, bs, bs)),
    }
    for arg, (got, want) in expect.items():
        if got != want:
            raise ValueError(f"{name}: {arg} has shape {got}, expected {want}")
    if r < 1:
        raise ValueError(f"{name}: rank 0 goes through ops.slr_matmul")
    if bs not in BLOCK_SIZES:
        raise ValueError(f"{name}: block size {bs} not in {BLOCK_SIZES}")
    y = torch.empty((t_dim, m_dim), dtype=x.dtype, device=dev)
    if t_dim == 0:
        return y
    plan = unstacked_plan(k_dim, r, bs, maxb, p.element_size(), t_dim)
    t = torch.empty((t_dim, plan.rp), dtype=torch.float32, device=dev)
    launch("slr_matmul_launch", dev, x.data_ptr(), p.data_ptr(), vt.data_ptr(),
           bsr.counts.data_ptr(), bsr.rows.data_ptr(), bsr.vals.data_ptr(), t.data_ptr(),
           y.data_ptr(), t_dim, k_dim, m_dim, r, plan.rp, jb, maxb, bs, plan.bt, plan.nseg,
           plan.kseg, code, wcode)
    slr_matmul.launches += 1
    return y


slr_matmul.launches = 0


def slr_matmul_stacked(x: torch.Tensor, p: torch.Tensor, vt: torch.Tensor,
                       stack: BsrStack, layer: int) -> torch.Tensor:
    """Layer ``layer`` of the fused SLR matmul. x (T, K), p (L, K, r),
    vt (L, r, M), ``stack`` of shape (K, M) -> y (T, M) in x.dtype.

    bf16 activations over f32 tables (a bf16 model's deployment: the SLR
    state is f32) widen x to f32, which is exact, run the f32 instance and
    round y to bf16: the Pallas kernel's own ``x.astype(f32)`` products and
    output cast."""
    if x.device.type == "cpu":
        return ref.slr_matmul_stacked_ref(x, p, vt, stack, layer)
    if x.dtype == torch.bfloat16 and stack.vals.dtype == torch.float32:
        return slr_matmul_stacked(x.float(), p.float(), vt.float(), stack,
                                  layer).to(torch.bfloat16)
    name = "slr_matmul_stacked"
    dev = check_cuda(name, x=x, p=p, vt=vt, counts=stack.counts, rows=stack.rows,
                     vals=stack.vals)
    code = dtype_code(x.dtype)
    if p.dtype != x.dtype or vt.dtype != x.dtype or stack.vals.dtype != x.dtype:
        raise TypeError(f"{name}: x, p, vt and vals must share one dtype, got "
                        f"{x.dtype}, {p.dtype}, {vt.dtype}, {stack.vals.dtype}")
    if stack.counts.dtype != torch.int32 or stack.rows.dtype != torch.int32:
        raise TypeError(f"{name}: counts and rows must be int32")
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (T, K), got {tuple(x.shape)}")
    t_dim, k_dim = x.shape
    num_l, _, r = p.shape
    m_dim = stack.shape[1]
    bs = stack.block_size
    jb = -(-m_dim // bs)
    maxb = stack.rows.shape[-1]
    expect = {
        "p": (tuple(p.shape), (num_l, k_dim, r)),
        "vt": (tuple(vt.shape), (num_l, r, m_dim)),
        "stack.shape": (tuple(stack.shape), (k_dim, m_dim)),
        "counts": (tuple(stack.counts.shape), (num_l, jb)),
        "rows": (tuple(stack.rows.shape), (num_l, jb, maxb)),
        "vals": (tuple(stack.vals.shape), (num_l, jb, maxb, bs, bs)),
    }
    for arg, (got, want) in expect.items():
        if got != want:
            raise ValueError(f"{name}: {arg} has shape {got}, expected {want}")
    if r < 1:
        raise ValueError(f"{name}: rank 0 goes through ops.slr_matmul_stacked")
    if bs not in BLOCK_SIZES:
        raise ValueError(f"{name}: block size {bs} not in {BLOCK_SIZES}")
    if not 0 <= layer < num_l:
        raise IndexError(f"{name}: layer {layer} outside [0, {num_l})")
    y = torch.empty((t_dim, m_dim), dtype=x.dtype, device=dev)
    if t_dim == 0:
        return y
    plan = fused_plan(k_dim, r, m_dim, bs, maxb, x.element_size(), t_dim,
                      card_residency(dev.index, x.dtype, bs))
    launch("slr_matmul_stacked_launch", dev, x.data_ptr(), p.data_ptr(), vt.data_ptr(),
           stack.counts.data_ptr(), stack.rows.data_ptr(), stack.vals.data_ptr(),
           y.data_ptr(), t_dim, k_dim, m_dim, r, layer, num_l, jb, maxb, bs, plan.bt,
           plan.nseg, plan.kseg, plan.loops, plan.ypn, code)
    slr_matmul_stacked.launches += 1
    return y


slr_matmul_stacked.launches = 0


def slr_matmul_multi(x: torch.Tensor, p: torch.Tensor, vt: torch.Tensor,
                     stack: BsrStack | None, ids: torch.Tensor, layers: int = 1,
                     layer: int = 0) -> torch.Tensor:
    """Per-slot fused SLR matmul: slot ``b`` of x (B, T, K) runs table row
    ``ids[b] * layers + layer`` of p (N, K, r), vt (N, r, M) and ``stack``
    (leading N) -> y (B, T, M) in x.dtype. ``stack=None`` runs the low-rank
    kernel's per-slot form (the empty-S corner: each slot bit for bit what
    ``lowrank_matmul`` gives on its row). ``ids`` (B,) int32 stays on
    the device: the kernel reads it, so no slot assignment costs a host sync.
    ``layers``/``layer`` select a layer inside pooled (adapter, layer) rows
    as launch scalars. The fused body gathers the rows of every slot that
    selects one pool row into one block's tile, so each selected row's tables
    are read once per call."""
    if x.device.type == "cpu":
        return ref.slr_matmul_multi_ref(x, p, vt, stack, ids, layers, layer)
    name = "slr_matmul_multi"
    tabs = {} if stack is None else dict(counts=stack.counts, rows=stack.rows,
                                         vals=stack.vals)
    dev = check_cuda(name, x=x, p=p, vt=vt, ids=ids, **tabs)
    code = dtype_code(x.dtype)
    dtypes = {x.dtype, p.dtype, vt.dtype} | ({stack.vals.dtype} if stack is not None else set())
    if len(dtypes) != 1:
        raise TypeError(f"{name}: x, p, vt and vals must share one dtype, got "
                        f"{sorted(map(str, dtypes))}")
    if ids.dtype != torch.int32 or (stack is not None and (
            stack.counts.dtype != torch.int32 or stack.rows.dtype != torch.int32)):
        raise TypeError(f"{name}: ids, counts and rows must be int32")
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, T, K), got {tuple(x.shape)}")
    b_dim, t_dim, k_dim = x.shape
    n_tab, _, r = p.shape
    m_dim = vt.shape[-1]
    expect = {"p": (tuple(p.shape), (n_tab, k_dim, r)),
              "vt": (tuple(vt.shape), (n_tab, r, m_dim)),
              "ids": (tuple(ids.shape), (b_dim,))}
    bs = jb = maxb = 0
    if stack is not None:
        bs = stack.block_size
        jb, maxb = -(-m_dim // bs), stack.rows.shape[-1]
        expect.update({
            "stack.shape": (tuple(stack.shape), (k_dim, m_dim)),
            "counts": (tuple(stack.counts.shape), (n_tab, jb)),
            "rows": (tuple(stack.rows.shape), (n_tab, jb, maxb)),
            "vals": (tuple(stack.vals.shape), (n_tab, jb, maxb, bs, bs)),
        })
        if bs not in BLOCK_SIZES:
            raise ValueError(f"{name}: block size {bs} not in {BLOCK_SIZES}")
    for arg, (got, want) in expect.items():
        if got != want:
            raise ValueError(f"{name}: {arg} has shape {got}, expected {want}")
    if r < 1:
        raise ValueError(f"{name}: rank 0 goes through ops.slr_matmul_multi")
    if layers < 1 or not 0 <= layer < layers or n_tab % layers:
        raise ValueError(f"{name}: layer {layer} of {layers} does not index {n_tab} table rows")
    y = torch.empty((b_dim, t_dim, m_dim), dtype=x.dtype, device=dev)
    if b_dim == 0 or t_dim == 0:
        return y
    if stack is None:
        lowrank_launch(x, p, vt, y, ids, layers, layer)
        slr_matmul_multi.launches += 1
        return y
    plan = fused_plan(k_dim, r, m_dim, bs, maxb, x.element_size(), b_dim * t_dim,
                      card_residency(dev.index, x.dtype, bs), min(b_dim, n_tab // layers + 1))
    launch("slr_matmul_multi_launch", dev, x.data_ptr(), p.data_ptr(), vt.data_ptr(),
           stack.counts.data_ptr(), stack.rows.data_ptr(), stack.vals.data_ptr(),
           ids.data_ptr(), y.data_ptr(), b_dim, t_dim, k_dim, m_dim, r, layers, layer, n_tab,
           jb, maxb, bs, plan.bt, plan.nseg, plan.kseg, plan.loops, plan.ypn, code)
    slr_matmul_multi.launches += 1
    return y


slr_matmul_multi.launches = 0
