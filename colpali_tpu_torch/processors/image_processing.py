"""Fixed-resolution image staging and decoding (counterpart of
:mod:`colpali_tpu.processors.image_processing`).

Host side, numpy and PIL, byte for byte the JAX package's code: resize with
PIL bicubic, then either RGB, BT.601 YUV420 (half the RGB bytes) or luma
only, and the packing of a group of pages into one upload buffer. Device
side, torch on the tensors' own device: unpack the buffer, YUV420 -> RGB,
and the ``(x / 255 - mean) / std`` normalization, in fp32.

The device resize (:func:`preprocess_images_fixed` without ``host_resize``,
the default) is ``jax.image.resize``: half-pixel centres, the Keys cubic
kernel with a = -0.5 (``F.interpolate`` has a = -0.75), widened by the
scale on a downscale when ``antialias``, each output's weights normalized
to sum to 1. The per-axis weight matrices are built in numpy as
``jax.image.scale_and_translate`` builds them (``compute_weight_mat``, fp32)
and applied as two fp32 products on the pixels' device.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple, Union

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


def restore_group_order(parts: List[torch.Tensor], idx_groups: List[List[int]]) -> torch.Tensor:
    """Concatenate per-group results and restore the original item order
    (grouping by shape scrambles it); no gather when the groups already
    cover the indices in order."""
    stacked = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    order = np.argsort(np.concatenate([np.asarray(g) for g in idx_groups]))
    if not np.array_equal(order, np.arange(order.size)):
        stacked = stacked[torch.from_numpy(order).to(stacked.device)]
    return stacked


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x)).astype(np.float32)


def _lanczos(radius: float):
    def kernel(x: np.ndarray) -> np.ndarray:
        r = np.float32(radius)
        y = r * np.sin(np.float32(np.pi) * x) * np.sin(np.float32(np.pi) * x / r)
        den = np.where(x != 0, np.float32(np.pi**2) * x * x, np.float32(1.0))
        out = np.where(x > np.float32(1e-3), y / den, np.float32(1.0))
        return np.where(x > r, np.float32(0.0), out).astype(np.float32)
    return kernel


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "trilinear": _triangle, "triangle": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic, "tricubic": _keys_cubic,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int, method: str = "bicubic", antialias: bool = True) -> np.ndarray:
    """``(in_size, out_size)`` fp32 weights of a 1-D resize, as
    ``jax.image.scale_and_translate``'s ``compute_weight_mat`` makes them."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}; one of {sorted(_KERNELS)} or 'nearest'")
    scale = np.float32(out_size / in_size)
    inv_scale = np.float32(1.0) / scale
    kernel_scale = np.maximum(inv_scale, np.float32(1.0)) if antialias else np.float32(1.0)
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = _KERNELS[method](x.astype(np.float32))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= np.float32(in_size) - np.float32(0.5))
    return np.where(inside[None, :], weights, np.float32(0.0)).astype(np.float32)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    offsets = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * np.float32(in_size) / np.float32(out_size)
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def _resize_normalize(
    images_u8: torch.Tensor,
    mean: Sequence[float],
    std: Sequence[float],
    height: int,
    width: int,
    method: str = "bicubic",
    antialias: bool = True,
) -> torch.Tensor:
    """``(B, H0, W0, 3)`` uint8 -> ``(B, height, width, 3)`` fp32 on the
    images' device: resize on 0..255 floats (:func:`resize_float`), then
    ``x / 255``, then ``(x - mean) / std``, the HF image processors' order."""
    return normalize_pixels(resize_float(images_u8.float(), height, width, method, antialias), mean, std)


def resize_float(x: torch.Tensor, height: int, width: int, method: str = "bicubic",
                 antialias: bool = True) -> torch.Tensor:
    """``jax.image.resize`` of fp32 ``(B, H0, W0, C)`` to ``(B, height,
    width, C)`` on x's device: two fp32 products with the per-axis weights
    (:func:`resize_weights`; an axis already at its size is left alone), a
    gather for ``"nearest"``."""
    h0, w0 = x.shape[1:3]
    dev = x.device
    if method == "nearest":
        if h0 != height:
            x = x[:, torch.from_numpy(_nearest_index(h0, height)).to(dev)]
        if w0 != width:
            x = x[:, :, torch.from_numpy(_nearest_index(w0, width)).to(dev)]
    else:
        if h0 != height:
            wh = torch.from_numpy(resize_weights(h0, height, method, antialias)).to(dev)
            x = torch.einsum("hi,bhwc->biwc", wh, x)
        if w0 != width:
            ww = torch.from_numpy(resize_weights(w0, width, method, antialias)).to(dev)
            x = torch.einsum("wj,biwc->bijc", ww, x)
    return x


def preprocess_images_fixed(
    images: Sequence[ImageLike],
    size: Tuple[int, int] = (448, 448),
    mean: Sequence[float] = (0.5, 0.5, 0.5),
    std: Sequence[float] = (0.5, 0.5, 0.5),
    method: str = "bicubic",
    device: Union[bool, str, torch.device] = False,
    host_resize: bool = False,
) -> Union[np.ndarray, torch.Tensor]:
    """Images -> ``(B, h, w, 3)`` fp32 normalized NHWC pixels.

    By default each image is uploaded at its own size and resized on the
    device (:func:`_resize_normalize`), images of one source shape as one
    batch. ``host_resize=True`` resizes with PIL bicubic first, so only
    target-size pixels cross to the device. ``device``: ``False`` computes
    on the CPU and returns numpy; ``True`` computes on ``"cuda"`` and
    ``str`` or ``torch.device`` computes there, both returning the tensor
    where it lies."""
    if device is False:
        where = torch.device("cpu")
    else:
        where = torch.device("cuda" if device is True else device)
    arrays = [host_resize_rgb(im, size) if host_resize else to_rgb_array(im) for im in images]
    h, w = size
    by_shape: dict = {}
    for i, a in enumerate(arrays):
        by_shape.setdefault(a.shape[:2], []).append(i)
    parts, idx_groups = [], []
    for indices in by_shape.values():
        batch = torch.from_numpy(np.stack([arrays[i] for i in indices])).to(where)
        parts.append(_resize_normalize(batch, mean, std, h, w, method=method))
        idx_groups.append(indices)
    pixels = restore_group_order(parts, idx_groups)
    return pixels.numpy() if device is False else pixels
