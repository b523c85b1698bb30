"""On-device integer training (fork parity: gradients, optimizer, losses)."""

from . import gradients, losses, optimizer
from .trainer import TrainableModel, compile_tflite_train, grads_from_numpy, grads_to_numpy

__all__ = ["TrainableModel", "compile_tflite_train", "gradients", "grads_from_numpy",
           "grads_to_numpy", "losses", "optimizer"]
