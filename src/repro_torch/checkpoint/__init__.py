from repro_torch.checkpoint.store import (atomic_save_arrays, flatten_cache,
                                          load_arrays)

__all__ = ["atomic_save_arrays", "flatten_cache", "load_arrays"]
