from repro_torch.checkpoint.store import (CheckpointManager,
                                          atomic_save_arrays, flatten_tree,
                                          latest_step,
                                          load_arrays, load_checkpoint,
                                          save_checkpoint, unflatten_into)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "CheckpointManager", "atomic_save_arrays", "load_arrays",
           "flatten_tree", "unflatten_into"]
