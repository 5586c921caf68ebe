"""The JAX package's five examples on the port, each runnable with
``python -m repro_torch.examples.<name>`` (on the card unless ``--device
cpu``). Each ``main`` takes its step counts as keyword arguments, defaulting
to the JAX example's, and returns what it built so a caller can check it."""
import argparse

from ..device import resolve_device


def parse_device(argv, description: str, extra=None):
    """``--device`` as the launchers have it (default: the card), plus the
    example's own switches (``extra(parser)``); returns (args, device)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    return args, resolve_device(args.device)
