#!/usr/bin/env python3
"""Load paths of the soft-threshold and page-copy kernels, built side by
side and timed on one card, device alone.

    python3 tools/bulk_variants.py                     # this tree
    git archive <commit> | tar -x -C build/parent      # build/ is git-ignored
    python3 tools/bulk_variants.py build/parent/src    # and the parent's design

The kernels' other designs live in sources of this tool's own,
``tools/bulk_variants_soft.cu`` and ``tools/bulk_variants_copy.cu``, which
include the kernels' sources from ``src/repro_torch/kernels/csrc``; each
build compiles them with its own flags into a library under
``build/bulk_variants/<n>/`` (all builds in parallel, each printing its
kernels' registers a thread), so no switch reaches the main path. The
kernels themselves are called through their own C entry points.

Soft-threshold, f32 (a CUDA generator seeded 0, tau per slice in [0,
0.5)): the embedding leaf (1, 32000, 512) and the gate stack (8, 512, 1376)
of ``chip_smoke.py`` 3i, and the largest x of 4i's sweep, a chunk of 10
in_proj slices (10, 2560, 10448) of zamba2_2p7b (``core/admm.py``:
``SWEEP_ELEMS`` // (n m) slices). Variants: the kernel (1 load a thread,
a block per tile); the register path at 2, 4 and 8 loads in flight per
thread on a block per tile, at 1-8 on the blocks the card holds at once
and at 1 and 2 on 2-16 blocks per SM, with evict-first (.cs) loads and
stores, capped at 32 registers a thread, and with one tau for the whole
call (no slice lookup per tile: exact only for nb = 1, so not checked,
timed to price the lookup); the TMA ring at 2, 3 and 4 stages of 8, 16 and
32 KB on the blocks the card holds; the parent's design where a parent
tree is given; ``F.softshrink`` with one scalar tau.

Page copy, at ``chip_smoke.py`` 3g's shape (8 pairs of 8-layer f32 pages of
8 x 16 x 64, a pool of 128 pages, 32 MB, which fits in L2): the kernel
with chunks of 4, 8, 16 and 32 KB (its plan takes 8) and the bulk ring at
1, 2 and 4 stages of the same chunks, on the blocks the card holds or one
a unit, whichever is fewer; the parent's design, the plan's launch with
identity pairs only (every block reads its pair and leaves: the launch
floor) and ``pool[:, dst] = pool[:, src]``.

Every variant but the one-tau one is first checked exact against
``kernels/ref.py``, also in bf16 and at ragged shapes with NaN and
infinities (soft-threshold; x and out an element past a 16-byte boundary
too) and on int8 pages of 105 bytes (page copy). Each time is ms per call,
20 calls replayed from one CUDA graph; the kernels' own launches are then
timed in turns with the parent (parent, this, this, parent). The card's
name and power limit come last.
"""
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import page_copy as pc  # noqa: E402
from repro_torch.kernels.stream import card_sms  # noqa: E402

TOOLS = ROOT / "tools"
VARIANT_SOURCES = (TOOLS / "bulk_variants_soft.cu", TOOLS / "bulk_variants_copy.cu")
PARENT_SOURCES = ("soft_threshold.cu", "page_copy.cu")
BUILDS = {"as built": [], "evict-first": ["-DSALAAD_EVICT_FIRST"],
          "at most 32 registers": ["-DSALAAD_MIN_BLOCKS=8"], "one tau": ["-DSALAAD_ONE_TAU"]}
SOFT_SHAPES = {"embedding": (1, 32000, 512), "gate stack": (8, 512, 1376),
               "4i sweep chunk": (10, 2560, 10448)}
RAGGED = [(3, 37, 61), (5, 7, 9), (2, 1375, 3), (70000, 1, 3)]
THREADS = 256
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
VARIANT_SIGNATURES = {"variant_soft_launch": [_P] * 3 + [_L] * 4 + [_I] * 4 + [_P],
                      "variant_soft_resident": [_I] * 3 + [_P],
                      "variant_copy_launch": [_P] * 3 + [_I] * 3 + [_L] + [_I] * 3 + [_P],
                      "variant_copy_resident": [_I] * 2 + [_P]}
PARENT_SIGNATURES = {"soft_threshold_launch": [_P] * 3 + [_I, _L, _I, _P],
                     "page_copy_launch": [_P] * 3 + [_I] * 3 + [_L, _P]}


def event_ms(fn, iters=10):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, calls=20):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return round(event_ms(graph.replay) / calls, 4)


def build_all(parent: Path | None) -> dict:
    out_dir = ROOT / "build" / "bulk_variants"
    shutil.rmtree(out_dir, ignore_errors=True)
    jobs = {}
    for i, (name, flags) in enumerate(BUILDS.items()):
        d = out_dir / f"v{i}"
        d.mkdir(parents=True)
        jobs[name] = (d, [*flags, "-I", str(_build.CSRC), *map(str, VARIANT_SOURCES)])
    if parent is not None:
        d = out_dir / "parent"
        shutil.copytree(parent / "repro_torch" / "kernels" / "csrc", d)
        jobs["parent"] = (d, [str(d / f) for f in PARENT_SOURCES])
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), *args],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (d, args) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"bulk_variants: {name!r} failed to build:\n{log[-3000:]}")
        kernels = re.findall(r"Compiling entry function '_Z\w*?(\d+soft_threshold\w+|"
                             r"\d+page_copy\w+)' for '\w+'\n.*\n.*\n.*Used (\d+) registers", log)
        print(f"{name}: registers {json.dumps({k: int(r) for k, r in kernels})}", flush=True)
        lib = ctypes.CDLL(str(jobs[name][0] / "lib.so"))
        sigs = PARENT_SIGNATURES if name == "parent" else {
            **VARIANT_SIGNATURES, **{k: _build.SIGNATURES[k] for k in (
                "soft_threshold_launch", "page_copy_launch", "page_copy_resident")}}
        for entry, argtypes in sigs.items():
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = lib
    return libs


def call(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        sys.exit(f"bulk_variants: {fn.__name__} refused the launch, cudaError {err}")


def resident(lib, entry, *head):
    def ask(*args):
        out = ctypes.c_int(0)
        err = getattr(lib, entry)(*head, *args, ctypes.byref(out))
        if err:
            sys.exit(f"bulk_variants: {entry} failed, cudaError {err}")
        return max(1, out.value)
    return ask


def soft_cut(numel: int, itemsize: int, x_addr: int, out_addr: int) -> tuple[int, int]:
    """(head, nvec) as the kernel's C entry cuts a call: vectors where x and
    out lie on one 16-byte phase, from x's first 16-byte boundary."""
    if (x_addr - out_addr) % 16:
        return numel, 0
    head = min(numel, (-x_addr % 16) // itemsize)
    return head, (numel - head) // (16 // itemsize)


def kernel_soft_call(lib, x, tau, out):
    """The kernel, through its own C entry (it cuts the call itself)."""
    args = (x.data_ptr(), tau.data_ptr(), out.data_ptr(), x.numel() // x.shape[0], x.numel(),
            _build.dtype_code(x.dtype))
    return lambda: call(lib.soft_threshold_launch, *args)


def soft_call(lib, x, tau, out, per_sm=None, loads=1, stages=0, stage_bytes=0):
    """One launch of a variant: tiles of ``loads`` vectors a thread, or the
    ring's ``stages`` of ``stage_bytes``; ``per_sm`` None for a block per
    tile, "resident" for the occupancy API's blocks per SM on every SM,
    else that many blocks per SM. A grid smaller than the tiles walks them
    in as few rounds as it allows, every block the same number of tiles
    give or take one."""
    code = _build.dtype_code(x.dtype)
    tile_vecs = stage_bytes // 16 if stages else THREADS * loads
    head, nvec = soft_cut(x.numel(), x.element_size(), x.data_ptr(), out.data_ptr())
    work = max(1, -(-nvec // tile_vecs) or -(-x.numel() // THREADS))
    cap = work
    if per_sm == "resident":
        cap = card_sms(x.device.index) * resident(lib, "variant_soft_resident", code)(
            tile_vecs, stages)
    elif per_sm is not None:
        cap = card_sms(x.device.index) * per_sm
    rounds = -(-work // cap)
    args = (x.data_ptr(), tau.data_ptr(), out.data_ptr(), x.numel() // x.shape[0], x.numel(),
            head, nvec, tile_vecs, stages, -(-work // rounds), code)
    return lambda: call(lib.variant_soft_launch, *args)


def parent_soft_call(lib, x, tau, out):
    args = (x.data_ptr(), tau.data_ptr(), out.data_ptr(), x.shape[0], x.numel() // x.shape[0],
            _build.dtype_code(x.dtype))
    return lambda: call(lib.soft_threshold_launch, *args)


def copy_call(lib, pool, src, dst, chunk=None, stages=0):
    """The kernel through its own C entry, on its plan (``chunk`` None) or
    on units of ``chunk``; ``stages`` > 0: the bulk ring instead. The grid
    is the card's resident blocks or the units, whichever is fewer."""
    page_bytes = pool[0, 0].numel() * pool.element_size()
    sms = card_sms(pool.device.index)
    if chunk is None:
        plan = pc.page_copy_plan(src.shape[0], pool.shape[0], page_bytes, sms,
                                 resident(lib, "page_copy_resident"))
        chunk, grid = plan.chunk, plan.grid
    else:
        if stages:
            chunk = min(chunk, -(-page_bytes // 16) * 16)
            per_sm = resident(lib, "variant_copy_resident")(chunk, stages)
        else:
            per_sm = resident(lib, "page_copy_resident")(chunk)
        units = src.shape[0] * pool.shape[0] * -(-page_bytes // chunk)
        grid = max(1, min(units, sms * per_sm))
    args = (pool.data_ptr(), src.data_ptr(), dst.data_ptr(), src.shape[0], pool.shape[0],
            pool.shape[1], page_bytes, chunk, *((stages,) if stages else ()), grid)
    return lambda: call(lib.variant_copy_launch if stages else lib.page_copy_launch, *args)


def parent_copy_call(lib, pool, src, dst):
    args = (pool.data_ptr(), src.data_ptr(), dst.data_ptr(), src.shape[0], pool.shape[0],
            pool.shape[1], pool[0, 0].numel() * pool.element_size())
    return lambda: call(lib.page_copy_launch, *args)


def soft_variants(libs):
    """name -> a function (x, tau, out) -> one launch."""
    this = libs["as built"]
    out = {"kernel": lambda x, tau, o: kernel_soft_call(this, x, tau, o)}

    def variant(lib, per_sm=None, **kw):
        return lambda x, tau, o: soft_call(lib, x, tau, o, per_sm, **kw)

    for loads in (2, 4, 8):
        out[f"registers x{loads}"] = variant(this, loads=loads)
    for loads in (1, 2, 4, 8):
        out[f"registers x{loads}, on the resident blocks"] = variant(this, "resident",
                                                                     loads=loads)
    for loads in (1, 2):
        for per_sm in (2, 4, 8, 16):
            out[f"registers x{loads}, {per_sm} blocks per SM"] = variant(this, per_sm,
                                                                         loads=loads)
    for loads in (1, 2, 4):
        out[f"registers x{loads}, evict-first"] = variant(libs["evict-first"], loads=loads)
        out[f"registers x{loads}, at most 32 registers"] = variant(
            libs["at most 32 registers"], loads=loads)
    out["registers x1, one tau (unchecked)"] = variant(libs["one tau"])
    for stages in (2, 3, 4):
        for kb in (8, 16, 32):
            out[f"ring {stages} x {kb} KB"] = variant(this, "resident", stages=stages,
                                                      stage_bytes=kb * 1024)
    return out


def copy_variants(libs):
    """name -> a function (pool, src, dst) -> one launch."""
    this = libs["as built"]
    out = {"kernel": lambda p, s, d: copy_call(this, p, s, d)}
    for kb in (4, 8, 16, 32):
        out[f"registers, {kb} KB"] = (
            lambda p, s, d, kb=kb: copy_call(this, p, s, d, chunk=kb * 1024))
        for stages in (1, 2, 4):
            out[f"bulk {stages} stages, {kb} KB"] = (
                lambda p, s, d, kb=kb, stages=stages: copy_call(this, p, s, d, chunk=kb * 1024,
                                                                stages=stages))
    return out


def same(got, want):
    g, w = got.float(), want.float()
    return torch.equal(torch.isnan(g), torch.isnan(w)) and torch.equal(
        g.nan_to_num(0.0), w.nan_to_num(0.0))


def check_soft(name, fn_of, dev, gen):
    for shape in RAGGED + [SOFT_SHAPES["embedding"]]:
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=gen, device=dev) * 3).to(dt)
            flat = x.view(shape[0], -1)
            flat[:, 0], flat[:, -1] = float("nan"), float("inf")
            tau = torch.rand(shape[0], generator=gen, device=dev) * 2
            tau[0] = 0.0
            tau[-1] = 100.0 if shape[0] > 1 else tau[-1]
            # as is; one slice starting an element in, out aligned (all scalar) or
            # one element in too (a scalar head, then vectors)
            skew = x.view(-1)[1:].view(1, -1)
            o_skew = torch.empty(x.numel(), dtype=dt, device=dev)[1:].view(1, -1)
            for x_, tau_, o in ((x, tau, torch.empty_like(x)),
                                (skew, tau[:1], torch.empty_like(skew)),
                                (skew, tau[:1], o_skew)):
                fn_of(x_, tau_, o)()
                if not same(o, ref.soft_threshold_ref(x_, tau_)):
                    sys.exit(f"bulk_variants: soft-threshold {name!r} disagrees at {shape} {dt}")


def check_copy(name, fn_of, dev, gen):
    for dt, tail in ((torch.float32, 64), (torch.int8, 64), (torch.int8, 105)):
        shape = (8, 40, 8, 16, 64) if tail == 64 else (3, 40, 1, 1, 105)
        pool = (torch.randn(shape, generator=gen, device=dev) * 50).to(dt)
        src = torch.tensor([5, 9, 13, 0, 0, 44, 7, 0], dtype=torch.int32, device=dev)
        dst = torch.tensor([0, 30, 17, 0, 0, 2, -1, 0], dtype=torch.int32, device=dev)
        keep = torch.tensor([0, 1, 2], device=dev)
        want = ref.page_copy_ref(pool.clone(), src[keep], dst[keep])
        fn_of(pool, src, dst)()
        if not torch.equal(pool, want):
            sys.exit(f"bulk_variants: page copy {name!r} disagrees on {dt} pages of {tail}")


def main():
    if not torch.cuda.is_available():
        sys.exit("bulk_variants: needs a CUDA card")
    parent = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    libs = build_all(parent)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    svars = soft_variants(libs)
    for name, fn_of in svars.items():
        if "unchecked" not in name:
            check_soft(name, fn_of, dev, gen)
    if parent is not None:       # at most 65535 slices: checked at the timed shapes only
        svars["parent"] = lambda x, tau, o: parent_soft_call(libs["parent"], x, tau, o)
    for shape_name, shape in SOFT_SHAPES.items():
        x = torch.randn(shape, generator=gen, device=dev)
        tau = torch.rand(shape[0], generator=gen, device=dev) * 0.5
        want = ref.soft_threshold_ref(x, tau)
        o = torch.empty_like(x)
        row = {"bound": round(2 * x.numel() * 4 / 3.35e12 * 1e3, 4)}
        fns = {name: fn_of(x, tau, o) for name, fn_of in svars.items()}
        for name, fn in fns.items():    # every check first: no timing follows its own check
            o.zero_()
            fn()
            if "unchecked" not in name and not torch.equal(o, want):
                sys.exit(f"bulk_variants: soft-threshold {name!r} disagrees at {shape}")
        for name, fn in fns.items():
            row[name] = graph_ms(fn)
        lam = float(tau[0])
        row["F.softshrink"] = graph_ms(lambda: F.softshrink(x, lam))
        if parent is not None:
            kernel, par = fns["kernel"], fns["parent"]
            row["turns (parent, this, this, parent)"] = [
                graph_ms(f) for f in (par, kernel, kernel, par)]
        print(f"soft_threshold {shape_name} {shape} f32: {json.dumps(row)}", flush=True)
        del x, want, o, fns

    cvars = copy_variants(libs)
    if parent is not None:
        cvars["parent"] = lambda p, s, d: parent_copy_call(libs["parent"], p, s, d)
    for name, fn_of in cvars.items():
        check_copy(name, fn_of, dev, gen)
    pool = torch.randn((8, 128, 8, 16, 64), generator=gen, device=dev)
    src8 = torch.arange(0, 16, 2, dtype=torch.int32, device=dev)
    dst8 = torch.arange(64, 80, 2, dtype=torch.int32, device=dev)
    page_bytes = 8 * 16 * 64 * 4
    row = {"bound": round(2 * 8 * 8 * page_bytes / 3.35e12 * 1e3, 4)}
    fns = {name: fn_of(pool, src8, dst8) for name, fn_of in cvars.items()}
    fns["launch floor (identity pairs)"] = cvars["kernel"](pool, src8, src8)
    for name, fn in fns.items():
        row[name] = graph_ms(fn)
    row["library"] = graph_ms(lambda: pool.__setitem__((slice(None), dst8.long()),
                                                       pool[:, src8.long()]))
    if parent is not None:
        kernel, par = fns["kernel"], fns["parent"]
        row["turns (parent, this, this, parent)"] = [
            graph_ms(f) for f in (par, kernel, kernel, par)]
    print(f"page_copy 8 pairs x 8 layers, 32 KB f32 pages: {json.dumps(row)}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
