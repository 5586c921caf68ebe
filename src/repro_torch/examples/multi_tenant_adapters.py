"""Multi-tenant adapter serving: one shared base, many SLR tenants, one
engine (port of ``examples/multi_tenant_adapters.py``).

SALAAD's factored form is a LoRA-style ``(P, Vt, S)`` delta over a dense
base, so one pool of serving hardware hosts many fine-tuned tenants at the
cost of one base plus their small adapter tables. This demo trains once,
registers 6 tenant adapters (HPA views at spread budgets) over one shared
fused-format base, and serves a mixed-tenant batch through a single paged
engine: every decode tick runs ONE per-slot kernel call per site even though
the slots carry different adapters, a 3-row device pool LRU-swaps the
tenants that do not fit, and no launch plan is rebuilt across the switches.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_adapters [--device cpu]
"""
from types import SimpleNamespace

import numpy as np

from ..configs import get_arch
from ..core.admm import SalaadConfig
from ..core.hpa import hpa_keep_ratio
from ..core.selection import SelectionConfig
from ..data.synthetic import DataConfig, SyntheticC4
from ..optim.adam import AdamConfig
from ..serving.adapters import AdapterBank, adapterize
from ..serving.deployed import DeployedModel
from ..serving.engine import EngineConfig, PagedServingEngine
from ..train.trainer import Trainer, TrainerConfig
from . import parse_device

N_TENANTS = 6
POOL_ROWS = 3          # device pool smaller than the tenant count: LRU swaps


def main(argv=None, steps: int = 40):
    _, device = parse_device(argv, __doc__.splitlines()[0])
    cfg = get_arch("salaad_llama_60m").reduced()
    salaad = SalaadConfig(
        selection=SelectionConfig(min_dim=16), rho_constant=0.5,
        update_every=5, exact_svd=True,
    )
    trainer = Trainer(cfg, TrainerConfig(total_steps=steps, salaad=salaad,
                                         adam=AdamConfig(lr=1e-3)), device=device)
    state = trainer.init(0)
    state = trainer.fit(state, SyntheticC4(DataConfig(cfg.vocab_size, 32, 8)))

    # one shared base + N tenants: HPA views at spread keep budgets, each
    # adapterized onto the base so only the SLR site tables differ
    slr_c, _ = hpa_keep_ratio(state.slr, trainer.blocks, 1.0, kappa=0.7)
    base = DeployedModel.build(cfg, state.params, slr_c, trainer.blocks, fmt="fused",
                               bsr_block=32)
    tenants = []
    for keep in np.linspace(1.0, 0.4, N_TENANTS):
        slr_k, _ = hpa_keep_ratio(state.slr, trainer.blocks, float(keep), 0.7)
        tenants.append(adapterize(base, DeployedModel.build(
            cfg, state.params, slr_k, trainer.blocks, fmt="fused", bsr_block=32)))

    bank = AdapterBank(base, tenants, names=[f"tenant{i}" for i in range(N_TENANTS)])
    engine = PagedServingEngine(bank, EngineConfig(
        adapters=True, max_resident_adapters=POOL_ROWS, max_slots=4, max_len=48,
        block_size=8,
    ))
    rep = bank.adapter_report()
    print(f"{rep['registered']} tenants registered over one {rep['fmt']} base; device "
          f"pool = {rep['capacity']} rows (mode={rep['mode']})")

    # two mixed-tenant waves: the first covers tenants 0-3 (one swap-in already
    # needed), the second rotates to 2-5: LRU swaps and row-map rebinds only
    waves = []
    for wave, aids in enumerate(([0, 1, 2, 3], [2, 3, 4, 5])):
        for aid in aids:
            engine.submit([1 + aid, 5, 9], max_new_tokens=6, adapter=aid)
        done = engine.run()
        waves.append({r.adapter: r.out_tokens for r in done})
        for r in sorted(done, key=lambda r: r.adapter):
            print(f"wave {wave} tenant {r.adapter} (row-resident) decoded: {r.out_tokens}")
    rep = bank.adapter_report()
    print(f"resident now: {rep['resident']} of {rep['registered']}; "
          f"LRU swap-ins: {rep['swaps']}")
    print(f"launch-plan rebuilds across every adapter switch: {engine.metrics.retraces()} "
          "(data-only rebinds)")
    return SimpleNamespace(bank=bank, engine=engine, waves=waves, report=rep)


if __name__ == "__main__":
    main()
