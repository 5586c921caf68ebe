"""Elastic deployment, Fig. 3 in miniature (port of
``examples/elastic_deploy.py``): one SALAAD checkpoint, a sweep of parameter
budgets, no retraining; the sweep is served too: one ModelBank holds the
budget spectrum as tiers and a single paged engine decodes all of them
concurrently over one shared paged KV.

    PYTHONPATH=src python -m repro_torch.examples.elastic_deploy [--device cpu]
"""
from types import SimpleNamespace

from ..configs import get_arch
from ..core.admm import SalaadConfig, surrogate_params
from ..core.hpa import hpa_keep_ratio, removable_params
from ..core.selection import SelectionConfig
from ..data.synthetic import DataConfig, SyntheticC4
from ..optim.adam import AdamConfig
from ..serving.elastic import ModelBank
from ..serving.engine import EngineConfig, PagedServingEngine
from ..serving.slr_params import deployment_report
from ..train.trainer import Trainer, TrainerConfig
from . import parse_device
from .quickstart import eval_loss

BUDGETS = (1.0, 0.7, 0.4)


def main(argv=None, steps: int = 50):
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

    c_l, c_s = removable_params(state.slr, trainer.blocks)
    print(f"trained once; removable SLR params: L={c_l} S={c_s}")
    print(f"{'keep':>6} {'slr_params':>10} {'loss':>8}   (single checkpoint, no retraining)")
    sweep = {}
    for keep in (1.0, 0.85, 0.7, 0.55, 0.4, 0.25):
        slr_c, rep = hpa_keep_ratio(state.slr, trainer.blocks, keep, kappa=0.7)
        params_c = surrogate_params(state.params, slr_c, trainer.blocks)
        sweep[keep] = (rep["params_after"], eval_loss(params_c, data, cfg, device))
        print(f"{keep:>6.2f} {sweep[keep][0]:>10} {sweep[keep][1]:>8.3f}")

    rep = deployment_report(state.params, state.slr, trainer.blocks)
    print(f"\ndeployment bytes: dense={rep['dense_total_bytes']/1e6:.2f}MB "
          f"slr={rep['slr_total_bytes']/1e6:.2f}MB (compression x{rep['compression']:.2f})")

    # --- serve the spectrum: one bank, one engine, three tiers ------------
    bank = ModelBank.build(cfg, state.params, state.slr, trainer.blocks,
                           budgets=BUDGETS, kappa=0.7, fmt="factored")
    for t in bank:
        print(f"tier {t.index} ({t.name}): served_bytes={t.param_bytes}")
    print(f"shared base across tiers: {bank.shared_base_bytes()} bytes")

    engine = PagedServingEngine(bank, EngineConfig(max_slots=len(bank), max_len=48,
                                                   block_size=8))
    for i in range(len(bank)):
        engine.submit([1 + i, 2, 3], max_new_tokens=6, tier=i)
    done = engine.run()
    for r in sorted(done, key=lambda r: r.tier):
        print(f"tier {r.tier} decoded concurrently: {r.out_tokens}")
    print(f"one engine, {len(bank)} budgets in flight: "
          f"{engine.stats_snapshot()['jit_retraces']} launch-plan rebuilds, "
          f"{engine.decode_calls} device calls")
    return SimpleNamespace(state=state, sweep=sweep, bank=bank, engine=engine, done=done)


if __name__ == "__main__":
    main()
