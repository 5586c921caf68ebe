"""PyTorch/CUDA port of the SALAAD serving stack.

Mirrors the layout of the JAX package ``repro`` (``configs``, ``core``,
``kernels``, ``models``, ``serving``) so every module has a counterpart of the
same name. The port imports ``torch`` and numpy only; ``repro_torch.bridge``
turns the JAX package's parameters and SLR state, handed over as numpy
arrays, into the port's.

Entry points place their tensors on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`). On the CPU
every kernel wrapper runs its plain PyTorch version; on a CUDA tensor it
launches the hand-written Hopper kernel from ``kernels/csrc`` or raises.
"""
