#!/usr/bin/env python3
"""Device-alone times of the paged attention kernels, their yardsticks and
flash attention, from one or more source trees on one card, in turns.

    python3 tools/paged_times.py                      # this tree
    git archive <commit> | tar -x -C build/other      # build/ is git-ignored
    python3 tools/paged_times.py build/other/src      # other, this, this, other

Every tree builds first, all in parallel. Each turn is a process of its own
that prints one JSON line. Inputs come from numpy seed 0, at
``chip_smoke.py`` 3d/3e's shapes: 8 slots, 8 heads of 64 (salaad_llama_60m),
16-token pages, 32 pages per slot (max_len 512), lengths 20-430 with one at
a page edge; decode (one query per slot) and k-query (64 queries per slot,
the chunked-prefill chunk), f32 and bf16; and a long table, 128 pages of 16
(2048 positions), lengths 300-1980. For each it gives, in ms per call:
  - ``event``: the kernel's wrapper, back-to-back calls timed with CUDA
    events (includes the wrapper's host time at this width);
  - ``graph``: the same call, 20 calls replayed from one CUDA graph (the
    device alone);
  - ``sdpa``: ``F.scaled_dot_product_attention`` on K/V gathered through
    the table beforehand, with the length mask (device alone);
  - ``gather_sdpa``: the page gather and SDPA together, the engine's path
    without the kernel (device alone).
Then ``page_copy`` (8 pairs of 8-layer f32 pages) and ``soft_threshold``
(the embedding leaf and the gate stack) beside their library calls, and
flash attention at 3f's main shape (8 x 8 heads, T = S = 512, causal), all
device alone. On a tree whose wrappers take a plan (``paged_plan``), it also
times the kernels' other cuts of the key axis at 3d/3e's f32 shapes, device
alone: decode in 1, 2, 4 or 8 segments, k-query in 1, 2 or 4. The card's
name and power limit come last.
"""
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
THIS_SRC = HERE.parents[1] / "src"


def measure(src: str) -> dict:
    sys.path.insert(0, src)
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def rand(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    def event_ms(fn, iters=50):
        for _ in range(5):
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
        return event_ms(graph.replay, iters=10) / calls

    def r4(x):
        return round(x, 4)

    out = {"src": src}
    slots, hq, hkv, d, bs = 8, 8, 8, 64, 16
    for label, nb, lo, hi in (("", 32, 20, 430), ("long ", 128, 300, 1980)):
        n_pages = slots * nb
        kp, vp = rand(n_pages, hkv, bs, d), rand(n_pages, hkv, bs, d)
        table = torch.from_numpy(rng.permutation(n_pages).reshape(slots, nb)
                                 .astype(np.int32)).to(dev)
        lengths_np = rng.integers(lo, hi, slots).astype(np.int32)
        lengths_np[0] = bs * 5 - 1
        seq = nb * bs
        kq = 64
        pos = torch.arange(seq, device=dev)
        cases = {"decode": (rand(slots, hq, 1, d), torch.from_numpy(lengths_np).to(dev)),
                 "kquery": (rand(slots, hq, kq, d), torch.from_numpy(
                     np.minimum(lengths_np, seq - kq)).to(dev))}
        for dt in ((torch.float32, torch.bfloat16) if not label else (torch.float32,)):
            k_, v_ = kp.to(dt), vp.to(dt)
            for what, (q4, lens) in cases.items():
                q4 = q4.to(dt)
                width = q4.shape[2]
                q_pos = lens[:, None] + torch.arange(width, device=dev)
                mask = (pos[None, None, :] <= q_pos[:, :, None])[:, None]
                if what == "decode":
                    q3 = q4[:, :, 0].contiguous()
                    call = lambda q3=q3, k_=k_, v_=v_, lens=lens: ops.paged_attention(  # noqa: E731
                        q3, k_, v_, table, lens)
                else:
                    call = lambda q4=q4, k_=k_, v_=v_, lens=lens: ops.paged_attention_kquery(  # noqa: E731
                        q4, k_, v_, table, lens)

                def gathered(k_=k_, v_=v_):
                    g = lambda p: p[table.long()].permute(0, 2, 1, 3, 4).reshape(  # noqa: E731
                        slots, hkv, seq, d)
                    return g(k_), g(v_)

                kg, vg = gathered()
                key = f"{label}{what} {str(dt)[6:]}"
                out[key] = {
                    "event": r4(event_ms(call)), "graph": r4(graph_ms(call)),
                    "sdpa": r4(graph_ms(lambda q4=q4, kg=kg, vg=vg, mask=mask:
                                        F.scaled_dot_product_attention(q4, kg, vg,
                                                                       attn_mask=mask))),
                    "gather_sdpa": r4(graph_ms(lambda q4=q4, gathered=gathered, mask=mask:
                                               F.scaled_dot_product_attention(
                                                   q4, *gathered(), attn_mask=mask)))}

        if label or not hasattr(pa, "paged_plan"):
            continue
        # other cuts of the same calls (f32), through the C entries
        q3 = cases["decode"][0][:, :, 0].contiguous()
        for what, q_, lens, cuts in (("decode", q3, cases["decode"][1], (1, 2, 4, 8)),
                                     ("kquery", cases["kquery"][0], cases["kquery"][1],
                                      (1, 2, 4))):
            for nseg in cuts:
                seg_keys = 64 * (nb * bs // 64 // nseg)
                o_ = torch.empty_like(q_)
                width = () if what == "decode" else (kq,)
                args = (f"paged_attention{'' if what == 'decode' else '_kquery'}_launch", dev,
                        q_.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
                        lens.data_ptr(), o_.data_ptr(), slots, hq, hkv, *width, d, n_pages, bs,
                        nb, seg_keys, 0)
                out[f"cut {what} f32 nseg={nseg}"] = r4(graph_ms(
                    lambda args=args: _build.launch(*args)))

    pool = rand(8, 128, hkv, bs, d)
    src8 = torch.arange(0, 16, 2, dtype=torch.int32, device=dev)
    dst8 = torch.arange(64, 80, 2, dtype=torch.int32, device=dev)
    out["page_copy"] = {"graph": r4(graph_ms(lambda: ops.page_copy(pool, src8, dst8))),
                        "library": r4(graph_ms(lambda: pool.__setitem__(
                            (slice(None), dst8.long()), pool[:, src8.long()])))}
    for name, shape in (("embedding", (1, 32000, 512)), ("gate stack", (8, 512, 1376))):
        x = rand(*shape)
        tau = torch.rand(shape[0], device=dev) * 0.5
        lam = float(tau[0])
        out[f"soft_threshold {name}"] = {
            "graph": r4(graph_ms(lambda x=x, tau=tau: ops.soft_threshold(x, tau))),
            "library": r4(graph_ms(lambda x=x, lam=lam: F.softshrink(x, lam)))}
    qf, kf, vf = rand(8, hq, 512, d), rand(8, hkv, 512, d), rand(8, hkv, 512, d)
    for dt in (torch.float32, torch.bfloat16):
        args = (qf.to(dt), kf.to(dt), vf.to(dt))
        out[f"flash {str(dt)[6:]}"] = {
            "graph": r4(graph_ms(lambda args=args: ops.flash_attention(*args))),
            "sdpa": r4(graph_ms(lambda args=args: F.scaled_dot_product_attention(
                *args, is_causal=True)))}
    return out


def main():
    if sys.argv[1:2] == ["--build"]:
        sys.path.insert(0, sys.argv[2])
        from repro_torch.kernels import _build
        _build.library()
        return
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure(sys.argv[2])))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("paged_times: needs a CUDA card")
    this = str(THIS_SRC)
    others = [str(Path(p).resolve()) for p in sys.argv[1:]]
    trees = [this] + others
    builds = [subprocess.Popen([sys.executable, str(HERE), "--build", s]) for s in trees]
    if any(p.wait() for p in builds):
        sys.exit("paged_times: a build failed")
    turns = [this] if not others else others + [this, this] + others[::-1]
    for src in turns:
        proc = subprocess.run([sys.executable, str(HERE), "--measure", src],
                              capture_output=True, text=True)
        if proc.returncode:
            sys.exit(f"paged_times: the turn on {src} failed:\n{proc.stderr[-3000:]}")
        print(proc.stdout.strip().splitlines()[-1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
