from repro_torch.train import compression
from repro_torch.train.step import (TrainStepConfig, loss_and_grads,
                                    make_train_step)

__all__ = ["TrainStepConfig", "make_train_step", "loss_and_grads",
           "compression"]
