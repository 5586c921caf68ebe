"""Serve an HPA-compressed SLR model with the batched engine, and run the
SLR kernels (the low-rank and block-CSC kernels; their plain versions on the
CPU) on a deployed block (port of ``examples/serve_slr.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_slr [--device cpu]
"""
import time
from types import SimpleNamespace

import torch

from ..configs import get_arch
from ..core.admm import SalaadConfig
from ..core.hpa import hpa_keep_ratio
from ..core.selection import SelectionConfig
from ..data.synthetic import DataConfig, SyntheticC4
from ..optim.adam import AdamConfig
from ..serving.deployed import DeployedModel
from ..serving.elastic import ModelBank
from ..serving.engine import EngineConfig, ServingEngine
from ..serving.slr_params import SLRLinear, build_slr_linears, coo_to_bsr
from ..serving.speculative import SpeculativeEngine
from ..train.trainer import Trainer, TrainerConfig
from . import parse_device


def main(argv=None, steps: int = 120):
    _, device = parse_device(argv, __doc__.splitlines()[0])
    cfg = get_arch("salaad_llama_60m").reduced()
    salaad = SalaadConfig(
        selection=SelectionConfig(min_dim=16), rho_constant=0.5,
        update_every=5, exact_svd=True,
    )
    trainer = Trainer(cfg, TrainerConfig(total_steps=steps, salaad=salaad,
                                         adam=AdamConfig(lr=1e-3)), device=device)
    state = trainer.init(0)
    data = SyntheticC4(DataConfig(cfg.vocab_size, 32, 8))
    state = trainer.fit(state, data)

    # compress + deploy WITHOUT dense materialization: the engine consumes
    # the factored (p, vt) + COO S representation directly
    slr_c, rep = hpa_keep_ratio(state.slr, trainer.blocks, keep_ratio=0.7, kappa=0.7)
    deployed = DeployedModel.build(cfg, state.params, slr_c, trainer.blocks, fmt="factored")
    print(f"deployed at keep=0.7: slr_params={rep['params_after']} "
          f"served_bytes={deployed.param_bytes()['total_bytes']}")

    # batched serving straight off the SLR weights (single-tier bank)
    engine = ServingEngine(ModelBank.single(cfg, deployed), EngineConfig(max_slots=2,
                                                                         max_len=48))
    for i in range(4):
        engine.submit([1 + i, 2, 3], max_new_tokens=6)
    t0 = time.time()
    done = engine.run()
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {toks} tokens, {toks / (time.time() - t0):.1f} tok/s")
    print("sample:", done[0].out_tokens)

    # elastic self-speculation: the SAME SLR state at an aggressive budget
    # drafts for the full-budget target (one k-wide verify per tick)
    slr_d, _ = hpa_keep_ratio(state.slr, trainer.blocks, keep_ratio=0.4, kappa=0.7)
    draft = DeployedModel.build(cfg, state.params, slr_d, trainer.blocks, fmt="dense")
    target = DeployedModel.build(cfg, state.params, slr_c, trainer.blocks, fmt="dense")
    # the draft/target pair is two tiers of one bank: tier 0 verifies, the
    # cheapest tier (spec_draft_tier=-1, the default) drafts
    spec = SpeculativeEngine(
        ModelBank(cfg, [target, draft], keeps=[0.7, 0.4]),
        EngineConfig(max_slots=2, max_len=48, block_size=8, spec_k=4,
                     spec_draft_mode="sequential"))   # short demo: no lookahead warmup
    for i in range(4):
        spec.submit([1 + i, 2, 3], max_new_tokens=6)
    spec_done = spec.run()
    print(f"speculative: {sum(len(r.out_tokens) for r in spec_done)} tokens in "
          f"{spec.decode_calls} verify steps, acceptance {spec.acceptance_rate:.2f}")

    # the kernel path on one deployed block outside the layer stack, against
    # the plain product
    linears = build_slr_linears(slr_c, trainer.blocks)
    name, lin = next((k, v) for k, v in linears.items() if v.p is not None and v.p.dim() == 2)
    bsr = coo_to_bsr(lin.s_coo, 32) if lin.s_coo is not None else None
    kernel = SLRLinear(p=lin.p, vt=lin.vt, s_coo=None, shape=lin.shape, s_bsr=bsr,
                       use_kernel=True)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((16, lin.shape[0]), generator=gen).to(lin.p.device, lin.p.dtype)
    err = float((kernel.apply(x) - lin.apply(x)).abs().max())
    occ = float("nan")
    if bsr is not None:
        n_pad, m_pad = bsr.padded_shape
        occ = int(bsr.counts.sum()) / ((n_pad // bsr.block_size) * (m_pad // bsr.block_size))
    print(f"kernel path on '{name}': max|diff| vs plain path = {err:.2e}, "
          f"BSR occupancy {occ:.2f}")
    return SimpleNamespace(done=done, spec_done=spec_done, kernel_err=err, block=name)


if __name__ == "__main__":
    main()
