"""SALAAD training: state, steps, checkpoints, fault tolerance and the trainer (port of ``repro/train``)."""
