"""End to end: train a ~100M-class SALAAD model with checkpointing
and a restart (port of ``examples/train_100m_e2e.py``).

The paper's 130M config with its real block shapes; ``--tiny`` shrinks
width, steps and batch while keeping the exact pipeline.

    PYTHONPATH=src python -m repro_torch.examples.train_100m_e2e --tiny --device cpu
    PYTHONPATH=src python -m repro_torch.examples.train_100m_e2e --steps 300   # real run
"""
import tempfile
from types import SimpleNamespace

from ..configs import get_arch
from ..core.admm import SalaadConfig
from ..core.selection import SelectionConfig
from ..data.synthetic import DataConfig, SyntheticC4
from ..optim.adam import AdamConfig
from ..train import checkpoint
from ..train.trainer import Trainer, TrainerConfig
from . import parse_device


def _switches(ap):
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)


def main(argv=None, steps: int | None = None, ckpt_every: int | None = None):
    """``steps`` (default 300, 30 with ``--tiny``; ``--steps`` sets it too)
    train steps, a checkpoint every ``ckpt_every`` (default ``max(steps //
    3, 10)``), then a fresh trainer restores the latest checkpoint. Returns
    both trainers' states and the data, so the restored run can be carried
    on."""
    args, device = parse_device(argv, __doc__.splitlines()[0], _switches)
    cfg = get_arch("salaad_llama_130m")
    n, seq, batch = 300, 256, 16
    if args.tiny:
        cfg, n, seq, batch = cfg.reduced(), 30, 32, 8
    steps = steps or args.steps or n
    ckpt_every = ckpt_every or max(steps // 3, 10)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="salaad_ckpt_")
    salaad = SalaadConfig(selection=SelectionConfig(min_dim=16), update_every=20,
                          exact_svd=args.tiny)
    tcfg = TrainerConfig(
        total_steps=steps,
        ckpt_dir=ckpt_dir,
        ckpt_every=ckpt_every,
        salaad=salaad,
        adam=AdamConfig(lr=3e-4 if not args.tiny else 1e-3),
        log_every=max(steps // 10, 1),
    )
    trainer = Trainer(cfg, tcfg, device=device)
    state = trainer.init(0)
    state = trainer.maybe_restore(state)  # resume-after-crash path
    data = SyntheticC4(DataConfig(cfg.vocab_size, seq, batch))

    print(f"training {cfg.name}: {steps} steps, ckpt -> {ckpt_dir}")
    state = trainer.fit(state, data)
    for m in trainer.metrics_log:
        print(" ", m)
    print("events:", trainer.events)
    print("checkpoints:", checkpoint.all_steps(ckpt_dir))

    # simulate a preemption + restart: a fresh trainer resumes from disk
    trainer2 = Trainer(cfg, tcfg, device=device)
    state2 = trainer2.maybe_restore(trainer2.init(0))
    print(f"restart resumes at step {int(state2.step)} (of {steps})")
    return SimpleNamespace(trainer=trainer, state=state, trainer2=trainer2, state2=state2,
                           data=data, ckpt_dir=ckpt_dir)


if __name__ == "__main__":
    main()
