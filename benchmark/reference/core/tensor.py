"""Static window/padding geometry and patch extraction.

The same geometry as ``microflow_tpu.core.tensor``.  SAME padding follows
the reference exactly: the window shift is ``((K-1)/2, (K-1)/2)`` (floor),
NOT TensorFlow's balanced padding -- for stride-2 3x3 convs these differ
(the reference pads top/left, TF pads bottom/right).

The identity every conv path relies on: the reference's per-pixel
SAME-padding correction terms (``src/ops/conv_2d.rs:100-127``) collapse to

    sum_over_valid (in - in_zp) * (w - w_zp)

which equals a *full-window* sum if the input is padded with ``in_zp``
(padded positions contribute ``(in_zp - in_zp) * (w - w_zp) = 0``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


class ViewPadding(enum.Enum):
    """Reference ``TensorViewPadding`` (``src/tensor.rs:8-15``)."""

    SAME = "same"
    VALID = "valid"


def same_shift(k: int) -> int:
    """Reference shift ``(K - 1) / 2`` (``src/tensor.rs:193``)."""
    return (k - 1) // 2


@dataclass(frozen=True)
class ViewGeometry:
    """Static geometry of a windowed op (conv / dwconv / avgpool)."""

    in_rows: int
    in_cols: int
    k_rows: int
    k_cols: int
    out_rows: int
    out_cols: int
    stride_rows: int
    stride_cols: int
    padding: ViewPadding

    def pad_amounts(self) -> tuple[int, int, int, int]:
        """(top, bottom, left, right) padding so that every window of
        every output pixel is in bounds of the padded array."""
        if self.padding is ViewPadding.VALID:
            return (0, 0, 0, 0)
        top = same_shift(self.k_rows)
        left = same_shift(self.k_cols)
        bottom = max(
            0, self.stride_rows * (self.out_rows - 1) + self.k_rows - 1 - top - (self.in_rows - 1)
        )
        right = max(
            0, self.stride_cols * (self.out_cols - 1) + self.k_cols - 1 - left - (self.in_cols - 1)
        )
        return (top, bottom, left, right)

    def origin(self, i: int, j: int) -> tuple[int, int]:
        """Top-left input coordinate of window (i, j) -- negative for SAME
        padding at the top/left edge (reference ``get_input_index``,
        ``src/update_layer.rs:347-364``)."""
        if self.padding is ViewPadding.SAME:
            return (
                self.stride_rows * i - same_shift(self.k_rows),
                self.stride_cols * j - same_shift(self.k_cols),
            )
        return (self.stride_rows * i, self.stride_cols * j)

    def valid_mask_plane(self) -> np.ndarray:
        """Boolean [out_rows, out_cols, k_rows, k_cols]: which window
        positions are in bounds (reference ``TensorView.mask``)."""
        r0 = np.array([self.origin(i, 0)[0] for i in range(self.out_rows)])
        c0 = np.array([self.origin(0, j)[1] for j in range(self.out_cols)])
        rows = r0[:, None] + np.arange(self.k_rows)  # [OH, KH]
        cols = c0[:, None] + np.arange(self.k_cols)  # [OW, KW]
        ok_r = (rows >= 0) & (rows < self.in_rows)
        ok_c = (cols >= 0) & (cols < self.in_cols)
        return ok_r[:, None, :, None] & ok_c[None, :, None, :]

    def len_plane(self) -> np.ndarray:
        """int32 [out_rows, out_cols]: count of in-bounds window positions
        (reference ``TensorView.len``)."""
        return self.valid_mask_plane().sum(axis=(2, 3)).astype(np.int32)

    def is_pointwise(self) -> bool:
        """A 1x1 stride-1 window with no padding: im2col is a reshape."""
        return (self.k_rows, self.k_cols, self.stride_rows, self.stride_cols) == (1, 1, 1, 1) and (
            self.pad_amounts() == (0, 0, 0, 0)
        )


def pad_nhwc(x: torch.Tensor, geom: ViewGeometry, pad_value: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, H+top+bottom, W+left+right, C], filled with
    ``pad_value``."""
    top, bottom, left, right = geom.pad_amounts()
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (0, 0, left, right, top, bottom), value=int(pad_value))


def extract_patches(x: torch.Tensor, geom: ViewGeometry, pad_value: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, OH, OW, KH, KW, C] patches via static slicing.

    ``pad_value`` is ``in_zp`` for convs and 0 for average pooling (the
    reference zero-fills views, ``src/tensor.rs:202``).
    """
    xp = pad_nhwc(x, geom, pad_value)
    rows = []
    for m in range(geom.k_rows):
        cols = []
        for n in range(geom.k_cols):
            cols.append(
                xp[
                    :,
                    m : m + geom.stride_rows * (geom.out_rows - 1) + 1 : geom.stride_rows,
                    n : n + geom.stride_cols * (geom.out_cols - 1) + 1 : geom.stride_cols,
                    :,
                ]
            )
        rows.append(torch.stack(cols, dim=3))  # [B, OH, OW, KW, C]
    return torch.stack(rows, dim=3)  # [B, OH, OW, KH, KW, C]


def reshape_2d(x: torch.Tensor) -> torch.Tensor:
    """Tensor4D -> Tensor2D row-major NHWC flatten (reference ``From``
    impl, ``src/tensor.rs:95-115``); any batch, 0 included."""
    return x.reshape(x.shape[0], int(np.prod(x.shape[1:])))


def reshape_4d(x: torch.Tensor, rows: int, cols: int, chans: int) -> torch.Tensor:
    """Tensor2D -> Tensor4D row-major NHWC unflatten (reference ``From``
    impl, ``src/tensor.rs:117-141``)."""
    return x.reshape(x.shape[0], rows, cols, chans)
