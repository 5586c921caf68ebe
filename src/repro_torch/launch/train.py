"""Training launcher: SALAAD (Algorithm 1) on one card, or data-parallel over
the ranks of a process group (port of ``repro/launch/train.py``).

  python -m repro_torch.launch.train --arch salaad_llama_60m --steps 20 \\
      --update-every 5 --seq-len 256 --batch 8

K Adam steps on the coupled loss, then one ADMM prox sweep (randomized SVD,
I-controller), repeated for ``--steps``, for any ``--arch`` of
``configs.ARCH_IDS``; ``--ckpt-dir`` writes checkpoints in
the JAX package's format every ``--ckpt-every`` steps and resumes from the
latest one there. Prints ``{"metrics": [...], "events": [...]}`` as the JAX
launcher does. Runs on the card unless ``--device cpu`` is given (with
``--reduced``, a run of the plain versions on the CPU). ``--distributed``
joins the process group ``torchrun`` describes (``env://``; or the group that
exists already) and trains data-parallel over every rank, as the JAX
launcher's ``jax.distributed.initialize()`` makes the same script run SPMD:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch salaad_llama_60m --reduced --device cpu --distributed --steps 3

Each rank takes its rows of every global batch and the gradients are
averaged over the ranks; rank 0 alone prints the JSON line and writes
checkpoints.
"""
from __future__ import annotations

import argparse
import json

from ..configs import get_arch
from ..core.admm import SalaadConfig
from ..core.selection import SelectionConfig
from ..data.synthetic import DataConfig, SyntheticC4
from .mesh import init_distributed, make_host_mesh
from ..optim.adam import AdamConfig
from ..train.trainer import Trainer, TrainerConfig


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true", help="smoke-scale config")
    ap.add_argument("--no-salaad", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--update-every", type=int, default=20, help="K (Alg. 1)")
    ap.add_argument("--rho-constant", type=float, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the kernels' "
                         "plain versions)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, mesh = args.device, None
    if args.distributed:
        device = init_distributed(args.device)
        mesh = make_host_mesh()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    salaad = None
    if not args.no_salaad:
        kw = dict(selection=SelectionConfig(min_dim=16), update_every=args.update_every)
        if args.rho_constant is not None:
            kw["rho_constant"] = args.rho_constant
        salaad = SalaadConfig(**kw)

    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, salaad=salaad,
                         adam=AdamConfig(lr=args.lr))
    trainer = Trainer(cfg, tcfg, mesh=mesh, device=device)
    state = trainer.init(args.seed)
    state = trainer.maybe_restore(state)
    data = SyntheticC4(DataConfig(cfg.vocab_size, args.seq_len, args.batch, seed=args.seed))
    trainer.fit(state, data)
    if mesh is None or mesh.rank == 0:
        print(json.dumps({"metrics": trainer.metrics_log[-5:], "events": trainer.events},
                         indent=1))


if __name__ == "__main__":
    main()
