"""Serving: the batched decode engine with a scrutinizable state."""

from repro_torch.serve.engine import Engine

__all__ = ["Engine"]
