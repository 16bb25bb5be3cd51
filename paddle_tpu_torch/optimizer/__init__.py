"""Optimizers of the port (counterpart of ``paddle_tpu/optimizer``)."""
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.adam import Adam, Adamax, AdamW, Lamb
from paddle_tpu_torch.optimizer.gradient_merge import GradientMergeOptimizer
from paddle_tpu_torch.optimizer.optimizer import Optimizer
from paddle_tpu_torch.optimizer.rmsprop import Adadelta, Adagrad, RMSProp
from paddle_tpu_torch.optimizer.sgd import (SGD, LarsMomentum,
                                            LarsMomentumOptimizer, Momentum)

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "AdamW",
           "GradientMergeOptimizer", "Lamb", "LarsMomentum",
           "LarsMomentumOptimizer", "Momentum", "Optimizer", "RMSProp", "SGD",
           "lr"]
