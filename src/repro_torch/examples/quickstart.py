"""Quickstart: SALAAD end to end (port of ``examples/quickstart.py``).

Trains a tiny LLaMA-family model with Algorithm 1, shows the structured
surrogate, compresses it to 60% params with HPA, and evaluates all three
model variants (X, L+S, compressed): the paper's Table 1 row in miniature.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from types import SimpleNamespace

import torch

from ..configs import get_arch
from ..core.admm import SalaadConfig, slr_param_count, surrogate_params
from ..core.hpa import hpa_keep_ratio
from ..core.selection import SelectionConfig
from ..data.synthetic import DataConfig, SyntheticC4
from ..models import model as model_lib
from ..optim.adam import AdamConfig
from ..train.trainer import Trainer, TrainerConfig
from . import parse_device


def eval_loss(params, data, cfg, device) -> float:
    """The model's loss on held-out batch 9999."""
    batch = {k: torch.as_tensor(v).to(device) for k, v in data.batch(9999).items()}
    with torch.no_grad():
        return float(model_lib.loss_fn(params, batch, cfg)[0])


def main(argv=None, steps: int = 40):
    _, device = parse_device(argv, __doc__.splitlines()[0])
    cfg = get_arch("salaad_llama_60m").reduced()
    salaad = SalaadConfig(
        selection=SelectionConfig(min_dim=16),
        rho_constant=0.5,
        update_every=5,
        exact_svd=True,  # tiny matrices: exact SVD is fine (rSVD at scale)
    )
    trainer = Trainer(cfg, TrainerConfig(total_steps=steps, salaad=salaad,
                                         adam=AdamConfig(lr=1e-3)), device=device)
    state = trainer.init(0)
    data = SyntheticC4(DataConfig(cfg.vocab_size, 32, 8))

    print("== stage 1+2 training (Algorithm 1) ==")
    state = trainer.fit(state, data)
    for m in trainer.metrics_log:
        if "loss" in m:
            print(f"  step {m['step']:>3}  loss {m['loss']:.3f}")

    print("\n== deployment variants ==")
    losses = {"dense": eval_loss(state.params, data, cfg, device)}
    print(f"  X     (dense)      loss {losses['dense']:.3f}")
    surr = trainer.surrogate(state)
    n_slr = slr_param_count(state.slr, trainer.blocks)["_total"]
    losses["surrogate"] = eval_loss(surr, data, cfg, device)
    print(f"  L+S   (surrogate)  loss {losses['surrogate']:.3f}   slr_params {n_slr}")

    slr_c, report = hpa_keep_ratio(state.slr, trainer.blocks, keep_ratio=0.6, kappa=0.7)
    comp = surrogate_params(state.params, slr_c, trainer.blocks)
    losses["hpa60"] = eval_loss(comp, data, cfg, device)
    print(f"  HPA60 (compressed) loss {losses['hpa60']:.3f}   "
          f"slr_params {report['params_after']}  (phi_L={report['phi_L']:.2f}, "
          f"phi_S={report['phi_S']:.2f})")
    return SimpleNamespace(trainer=trainer, state=state, losses=losses, hpa=report)


if __name__ == "__main__":
    main()
