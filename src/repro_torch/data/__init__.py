"""Inputs of the port's models: the stub frontends' batches."""
from repro_torch.data.pipeline import batch_for

__all__ = ["batch_for"]
