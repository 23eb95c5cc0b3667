"""The port's optimizers: plain functions over the nested parameter dict,
with the reference's state trees."""
from repro_torch.optim.adafactor import (AdafactorConfig, adafactor_init,
                                         adafactor_update)
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "AdafactorConfig",
           "adafactor_init", "adafactor_update", "cosine_schedule",
           "linear_warmup_cosine"]
