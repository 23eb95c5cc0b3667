"""Inputs of the port's models: the training streams and the stub
frontends' batches."""
from repro_torch.data.pipeline import ByteCorpus, SyntheticLM, batch_for

__all__ = ["ByteCorpus", "SyntheticLM", "batch_for"]
