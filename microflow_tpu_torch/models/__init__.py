"""Model zoo: one-line access to the bundled reference models
(reference ``models/*.tflite``; golden outputs from ``tests/*.rs``)."""

from __future__ import annotations

import os

import numpy as np

from ..compiler.builder import CompiledModel, compile_tflite
from ..train.trainer import TrainableModel, compile_tflite_train

_MODELS_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "models")
)


def model_path(name: str) -> str:
    return os.path.join(_MODELS_DIR, f"{name}.tflite")


def sine(backend: str | None = None, device=None) -> CompiledModel:
    """3x FullyConnected sine approximator (in [B,1] f32, out [B,1]).
    Golden: predict([[0.5]]) == [[0.41348344]]."""
    return compile_tflite(model_path("sine"), name="sine", backend=backend, device=device)


def speech(backend: str | None = None, device=None) -> CompiledModel:
    """TinyConv keyword spotter (in [B,1960] f32 spectrogram features,
    out [B,4] probabilities: silence/unknown/yes/no)."""
    return compile_tflite(model_path("speech"), name="speech", backend=backend, device=device)


def person_detect(backend: str | None = None, device=None) -> CompiledModel:
    """MobileNet-v1 0.25x person detector (in [B,96,96,1] f32, out [B,2]:
    person / no-person)."""
    return compile_tflite(model_path("person_detect"), name="person_detect", backend=backend,
                          device=device)


def sine_trainable(backend: str | None = None, gradient_mode: str = "quantized",
                   device=None) -> TrainableModel:
    """Reference ``examples/sine_train.rs`` configuration."""
    return compile_tflite_train(model_path("sine"), 1, "mse", False, name="sine",
                                backend=backend, gradient_mode=gradient_mode, device=device)


def speech_trainable(backend: str | None = None, gradient_mode: str = "quantized",
                     device=None) -> TrainableModel:
    """Reference ``examples/speech_train.rs`` configuration."""
    return compile_tflite_train(model_path("speech"), 2, "crossentropy", True, name="speech",
                                backend=backend, gradient_mode=gradient_mode, device=device)


def person_detect_trainable(num_train_layers: int = 10, backend: str | None = None,
                            device=None) -> TrainableModel:
    """Reference ``examples/person_detect_train.rs`` configuration."""
    return compile_tflite_train(model_path("person_detect"), num_train_layers, "crossentropy",
                                True, name="person_detect", backend=backend, device=device)


GOLDENS = {
    "sine": (np.array([[0.5]], np.float32), np.array([[0.41348344]], np.float32)),
    "speech": (
        np.full((1, 1960), 0.5, np.float32),
        np.array([[0.15625, 0.2734375, 0.2734375, 0.296875]], np.float32),
    ),
    "person_detect": (
        np.full((1, 96, 96, 1), 0.5, np.float32),
        np.array([[0.8046875, 0.1953125]], np.float32),
    ),
}
