"""Parallel serving: the sharding rules and the ``torch.distributed`` mesh."""
