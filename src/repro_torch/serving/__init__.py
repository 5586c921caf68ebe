"""Serving: deployed SLR weights and the paged engine."""
