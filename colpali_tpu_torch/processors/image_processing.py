"""Fixed-resolution image staging and decoding (counterpart of
:mod:`colpali_tpu.processors.image_processing`).

Host side, numpy and PIL, byte for byte the JAX package's code: resize with
PIL bicubic, then either RGB, BT.601 YUV420 (half the RGB bytes) or luma
only, and the packing of a group of pages into one upload buffer. Device
side, torch on the tensors' own device: unpack the buffer, YUV420 -> RGB,
and the ``(x / 255 - mean) / std`` normalization, in fp32.

Not ported yet: the device-resize path (``preprocess_images_fixed`` without
``host_resize``), which resizes with ``jax.image.resize`` bicubic and
antialias (Keys kernel a = -0.5); ``F.interpolate`` uses a = -0.75, so a
faithful port needs ``jax.image.scale_and_translate``'s weight matrices.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

ImageLike = Union[np.ndarray, "PIL.Image.Image"]  # noqa: F821


def to_rgb_array(image: ImageLike) -> np.ndarray:
    """PIL image or array -> (H, W, 3) uint8 numpy array."""
    if hasattr(image, "convert"):  # PIL
        image = np.asarray(image.convert("RGB"))
    image = np.asarray(image)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    if image.shape[-1] == 4:
        image = image[..., :3]
    return image.astype(np.uint8)


def _host_resize_pil(image: ImageLike, size: Tuple[int, int], reducing_gap=None):
    """PIL bicubic resize to ``size`` (h, w); palette modes are converted to
    RGB first. ``reducing_gap`` is PIL's box-reduce-then-resample shortcut
    (None: exact single-pass bicubic)."""
    from PIL import Image

    if not hasattr(image, "convert"):
        image = Image.fromarray(to_rgb_array(image))
    if image.mode not in ("RGB", "L", "RGBA"):
        image = image.convert("RGB")
    if image.size != (size[1], size[0]):
        image = image.resize((size[1], size[0]), Image.Resampling.BICUBIC, reducing_gap=reducing_gap)
    return image


def host_resize_rgb(image: ImageLike, size: Tuple[int, int], reducing_gap=None) -> np.ndarray:
    """PIL bicubic resize to ``size`` -> (h, w, 3) uint8; the RGB convert
    happens at the target size."""
    image = _host_resize_pil(image, size, reducing_gap)
    if image.mode != "RGB":
        image = image.convert("RGB")
    return np.asarray(image)


def stage_yuv420(image: ImageLike, size: Tuple[int, int], reducing_gap=None) -> Tuple[np.ndarray, np.ndarray]:
    """Resize -> PIL's fixed-point BT.601 ``YCbCr`` -> ``(y (h, w), uv (h/2,
    w/2, 2))`` uint8, the chroma planes 2x BOX-downscaled."""
    from PIL import Image

    image = _host_resize_pil(image, size, reducing_gap)
    y, cb, cr = image.convert("YCbCr").split()
    half = (size[1] // 2, size[0] // 2)  # PIL size = (w, h)
    cb = cb.resize(half, Image.Resampling.BOX)
    cr = cr.resize(half, Image.Resampling.BOX)
    uv = np.stack([np.asarray(cb), np.asarray(cr)], axis=-1)
    return np.asarray(y), uv


def stage_gray(image: ImageLike, size: Tuple[int, int], reducing_gap=None) -> np.ndarray:
    """Resize -> PIL's ITU-R 601-2 luma, (h, w) uint8. A third of the RGB
    bytes, but colour is lost: use it only for achromatic corpora."""
    return np.asarray(_host_resize_pil(image, size, reducing_gap).convert("L"))


def pack_yuv420_group(planes, out: np.ndarray, size: int) -> np.ndarray:
    """Pack per-page ``(y, uv)`` plane pairs into the uint8 buffer ``out``
    of shape ``(..., size*size*3//2)``, pages in order of the flattened
    leading dims: one upload per group."""
    n = size * size
    flat = out.reshape(-1, out.shape[-1])
    for j, (y, uv) in enumerate(planes):
        flat[j, :n] = y.ravel()
        flat[j, n:] = uv.ravel()
    return out


# BT.601 full-range (JFIF) RGB -> YUV
_YUV_FWD = np.array(
    [[0.299, 0.587, 0.114],
     [-0.168736, -0.331264, 0.5],
     [0.5, -0.418688, -0.081312]], np.float32
)


def rgb_to_yuv420(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(H, W, 3) uint8 RGB -> ``(y (H, W), uv (H/2, W/2, 2))`` uint8 with a
    2x2 box average of the chroma; H and W must be even."""
    h, w, _ = arr.shape
    if h % 2 or w % 2:
        raise ValueError(f"YUV420 needs even dims, got {(h, w)}")
    x = arr.astype(np.float32)
    y = x @ _YUV_FWD[0]
    u = x @ _YUV_FWD[1] + 128.0
    v = x @ _YUV_FWD[2] + 128.0
    uv = np.stack([u, v], axis=-1).reshape(h // 2, 2, w // 2, 2, 2).mean(axis=(1, 3))
    return (
        np.clip(np.rint(y), 0, 255).astype(np.uint8),
        np.clip(np.rint(uv), 0, 255).astype(np.uint8),
    )


def unpack_yuv420(buf: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_yuv420_group` on the buffer's device: ``y (...,
    H, W)`` and ``uv (..., H/2, W/2, 2)`` views of the uint8 buffer."""
    n = size * size
    lead = buf.shape[:-1]
    return buf[..., :n].reshape(*lead, size, size), buf[..., n:].reshape(*lead, size // 2, size // 2, 2)


def yuv420_to_rgb(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """``(B, H, W)`` + ``(B, H/2, W/2, 2)`` uint8 -> ``(B, H, W, 3)`` float32 in
    0..255, chroma upsampled by nearest neighbour."""
    yf = y.float()
    uvf = uv.float() - 128.0
    uvf = uvf.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # (B, H, W, 2)
    u, v = uvf[..., 0], uvf[..., 1]
    r = yf + 1.402 * v
    g = yf - 0.344136 * u - 0.714136 * v
    b = yf + 1.772 * u
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def normalize_pixels(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """0..255 floats -> ``(x / 255 - mean) / std`` with fp32 constants."""
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x / 255.0 - m) / s


def preprocess_images_fixed(
    images: Sequence[ImageLike],
    size: Tuple[int, int] = (448, 448),
    mean: Sequence[float] = (0.5, 0.5, 0.5),
    std: Sequence[float] = (0.5, 0.5, 0.5),
) -> np.ndarray:
    """Resize on the host (PIL bicubic) and normalize -> ``(B, h, w, 3)``
    float32 NHWC numpy: the JAX package's ``host_resize=True`` path."""
    rgb = np.stack([host_resize_rgb(im, size) for im in images])
    return normalize_pixels(torch.from_numpy(rgb).float(), mean, std).numpy()
