"""Image pyramid as a fixed-shape padded level batch with reflect halos
(port of ``vo_slam_test_tpu/ops/pyramid.py``).

Every level reproduces cv::resize's 8-bit INTER_LINEAR output bit-exactly
(11-bit fixed-point taps, OpenCV's u8 vertical cast in int32 ``>>``
arithmetic). Levels sit in one canvas batch ``[L, CH, CW]`` at
``[HALO:HALO+h, HALO:HALO+w]`` with a BORDER_REFLECT_101 halo of the raw level
and zeros beyond; ``canvas_hw`` keeps the JAX package's widened width so the
two packages' canvases convert one to one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .gaussian import gaussian_blur_7x7_u8, reflect_index

HALO = 19  # EDGE_THRESHOLD


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """Static pyramid geometry (hashable)."""

    width: int
    height: int
    n_levels: int = 8
    scale_factor: float = 1.2

    @functools.cached_property
    def sizes(self) -> Tuple[Tuple[int, int], ...]:
        """((h, w) per level), using the reference's cvRound chaining."""
        out = [(self.height, self.width)]
        for lvl in range(1, self.n_levels):
            inv = 1.0 / (self.scale_factor**lvl)
            out.append((int(np.rint(self.height * inv)), int(np.rint(self.width * inv))))
        return tuple(out)

    @property
    def canvas_hw(self) -> Tuple[int, int]:
        # same widened width as the JAX package (its TPU kernel's aligned
        # patch reads), so canvases compare and convert one to one
        h = self.height + 2 * HALO
        w = self.width + 2 * HALO
        max_x0a = ((self.width - 16) // 128) * 128
        return (h, max(w, max_x0a + 256))

    @functools.cached_property
    def scales(self) -> np.ndarray:
        return np.array([self.scale_factor**l for l in range(self.n_levels)], np.float32)

    @functools.cached_property
    def level_sigma2(self) -> np.ndarray:
        return (self.scales**2).astype(np.float32)

    @functools.cached_property
    def inv_level_sigma2(self) -> np.ndarray:
        return (1.0 / self.level_sigma2).astype(np.float32)

    def budget(self, num_features: int) -> Tuple[int, ...]:
        """Per-level target counts: geometric split of num_features."""
        q = 1.0 / self.scale_factor
        val = num_features * (1 - q) / (1 - q**self.n_levels)
        counts = []
        for _ in range(self.n_levels - 1):
            counts.append(int(round(val)))
            val *= q
        counts.append(max(num_features - sum(counts), 0))
        return tuple(counts)


class Pyramid(NamedTuple):
    """Raw + blurred canvases; levels live at [HALO:HALO+h, HALO:HALO+w]."""

    raw: torch.Tensor   # [L, CH, CW] f32 (halo: reflect of raw)
    blur: torch.Tensor  # same, interior blurred, halo still raw-reflect


@functools.lru_cache(maxsize=None)
def _u8_coeffs(n_in: int, n_out: int, device: torch.device):
    """cv::resize 8U INTER_LINEAR fixed-point taps for one axis, kept on
    ``device``: (src, src + 1 as i64[n_out], a0, a1 as i32), src clamped so
    src + 1 is in range."""
    scale = 1.0 / (float(n_out) / float(n_in))
    dx = np.arange(n_out, dtype=np.float64)
    f32 = ((dx + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(f32).astype(np.int64)
    fx = f32 - sx.astype(np.float32)
    low = sx < 0
    sx[low] = 0
    fx[low] = 0.0
    hi = sx >= n_in - 1
    sx[hi] = n_in - 2
    fx[hi] = 1.0
    a1 = np.rint(fx * np.float32(2048.0)).astype(np.int32)
    a0 = np.rint((np.float32(1.0) - fx) * np.float32(2048.0)).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device) for a in (sx, sx + 1, a0, a1))


def _resize_u8_exact(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bit-exact cv::resize INTER_LINEAR for 8-bit values (any dtype in,
    f32 integral values out); all intermediates fit int32."""
    h_in, w_in = img.shape
    sx, sx1, ax0, ax1 = _u8_coeffs(w_in, out_hw[1], img.device)
    sy, sy1, by0, by1 = _u8_coeffs(h_in, out_hw[0], img.device)
    I = img.to(torch.int32)
    rows = I[:, sx] * ax0[None, :] + I[:, sx1] * ax1[None, :]
    s0 = rows[sy] >> 4
    s1 = rows[sy1] >> 4
    out = (((by0[:, None] * s0) >> 16) + ((by1[:, None] * s1) >> 16) + 2) >> 2
    return out.to(torch.float32)


def _reflect_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """BORDER_REFLECT_101 (edge pixel not repeated) on both axes."""
    h, w = img.shape
    return img[reflect_index(h, pad, img.device)][:, reflect_index(w, pad, img.device)]


def build_pyramid(gray_u8: torch.Tensor, spec: PyramidSpec) -> Pyramid:
    """u8/f32 (H, W) image -> haloed raw + blurred canvases."""
    levels = [gray_u8.to(torch.float32)]
    for lvl in range(1, spec.n_levels):
        levels.append(_resize_u8_exact(levels[-1], spec.sizes[lvl]))

    CH, CW = spec.canvas_hw
    raw = torch.zeros((spec.n_levels, CH, CW), dtype=torch.float32, device=gray_u8.device)
    blur = torch.zeros_like(raw)
    for lvl, lv in enumerate(levels):
        h, w = lv.shape
        haloed = _reflect_pad(lv, HALO)
        raw[lvl, : h + 2 * HALO, : w + 2 * HALO] = haloed
        # blur only the interior (the reference's view-scoped GaussianBlur);
        # the halo of the blurred canvas stays the raw reflect
        blur[lvl, : h + 2 * HALO, : w + 2 * HALO] = haloed
        blur[lvl, HALO : HALO + h, HALO : HALO + w] = gaussian_blur_7x7_u8(lv)
    return Pyramid(raw=raw, blur=blur)


def interior(canvas: torch.Tensor, spec: PyramidSpec) -> torch.Tensor:
    """[L, CH, CW] canvas -> [L, H, W] view of the level-0 extent."""
    return canvas[:, HALO : HALO + spec.height, HALO : HALO + spec.width]
