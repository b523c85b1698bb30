"""Real-sample inputs (reference ``samples/`` directory): the port's copy of
``microflow_tpu.samples``.

The reference demonstrates real classification on ``yes.wav`` /
``no.wav`` (speech) and ``person.bmp`` / ``no_person.bmp`` (person
detection), shipping precomputed int8 feature tensors as Rust constants
(``samples/features/speech.rs``, ``person_detect.rs``).  Those constants
live as data in the repository's ``samples/features.npz``, which this
module reads and never writes.  The int8 image feature is the 8-bit
grayscale pixel reinterpreted as int8.
"""

from __future__ import annotations

import os
import struct

import numpy as np

# label orders from the reference examples (examples/speech.rs and
# examples/person_detect.rs, print_prediction)
SPEECH_LABELS = ("silence", "unknown", "yes", "no")
PERSON_DETECT_LABELS = ("no person", "person")

_DEFAULT = os.path.normpath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "samples", "features.npz")
)


def load_features(path: str | None = None) -> dict[str, np.ndarray]:
    """Load the real-sample int8 feature tensors.

    Keys: ``speech_yes`` / ``speech_no`` -> (1, 1960) int8;
    ``person_detect_person`` / ``person_detect_no_person``
    -> (1, 96, 96, 1) int8.
    """
    with np.load(path or _DEFAULT) as z:
        return {k: z[k] for k in z.files}


def decode_bmp_gray8(path: str) -> np.ndarray:
    """Minimal 8bpp uncompressed BMP decoder (top-left origin output)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"BM":
        raise ValueError(f"{path}: not a BMP file")
    (off,) = struct.unpack("<I", data[10:14])
    (hdrsz,) = struct.unpack("<I", data[14:18])
    w, h, _planes, bpp, comp = struct.unpack("<iiHHI", data[18:34])
    if hdrsz < 40 or bpp != 8 or comp != 0:
        raise ValueError(f"{path}: need 8bpp uncompressed BMP, got bpp={bpp} comp={comp}")
    stride = (w + 3) & ~3  # rows padded to 4 bytes
    flip = h > 0  # positive height = bottom-up storage
    h = abs(h)
    rows = [np.frombuffer(data[off + r * stride : off + r * stride + w], np.uint8) for r in range(h)]
    return np.stack(rows[::-1] if flip else rows)


def image_to_features(img_gray8: np.ndarray) -> np.ndarray:
    """Grayscale uint8 image -> the model's int8 input (wrapping
    reinterpret cast, the uint8-era int8 convention of person_detect)."""
    return np.asarray(img_gray8, np.uint8).astype(np.int8).reshape(1, *img_gray8.shape, 1)
