"""Fused page ingestion (counterpart of :mod:`colpali_tpu.retrieval.ingest`).

Pages become ColPali page embeddings through one pipeline:

- host staging on a prefetch thread: PIL resize plus the wire format
  (``rgb-u8``, ``yuv420`` at half the RGB bytes, or luma-only ``gray`` at a
  third), packed into one uint8 buffer per group of ``batch_size * chunk``
  pages, in pinned memory when the model is on the card;
- one upload per group (``non_blocking=True``);
- on the device: unpack, YUV420 -> RGB, normalize, the model forward, for
  each of the group's ``chunk`` batches; :func:`embed_pages_fused`
  downloads the group's embeddings once, :func:`fused_page_batches` hands
  each batch over where it lies.

All pages share one prompt, so the token ids are uploaded once.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from colpali_tpu_torch.data.prefetch import prefetch
from colpali_tpu_torch.processors.image_processing import (
    host_resize_rgb,
    normalize_pixels,
    pack_yuv420_group,
    stage_gray,
    stage_yuv420,
    unpack_yuv420,
    yuv420_to_rgb,
)

TRANSPORTS = ("rgb-u8", "yuv420", "gray")


def fused_page_batches(
    model: torch.nn.Module,
    processor: Any,
    pages: Sequence[Any],
    *,
    transport: str = "yuv420",
    batch_size: int = 8,
    chunk: int = 1,
    reducing_gap: Optional[float] = None,
    prompt: Optional[str] = None,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """The pipeline of :func:`embed_pages_fused`, a forward batch at a time:
    ``(embeddings (n, S, D), attention_mask (n, S))`` where the model lies,
    the final group's padding rows dropped. A consumer on the device (a
    ``DeviceIndexBuilder``) takes the embeddings without a host round trip."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, got {transport!r}")
    if not pages:
        return
    device = next(model.parameters()).device
    size = int(processor.image_size)
    mean, std = processor.image_mean, processor.image_std

    tok = processor._tokenize([processor._expand_image_prompt(prompt or processor.visual_prompt_prefix)] * batch_size)
    ids = torch.from_numpy(np.asarray(tok["input_ids"])).to(device)
    att = torch.from_numpy(np.asarray(tok["attention_mask"])).to(device)

    group_pages = batch_size * chunk
    n_pages = len(pages)
    n_groups = -(-n_pages // group_pages)
    per_page = {"yuv420": (size * size * 3 // 2,), "gray": (size, size), "rgb-u8": (size, size, 3)}[transport]

    def stage(g: int) -> torch.Tensor:
        group = list(pages[g * group_pages : (g + 1) * group_pages])
        while len(group) < group_pages:  # pad the final group; rows dropped below
            group.append(group[-1])
        host = torch.empty((chunk, batch_size, *per_page), dtype=torch.uint8, pin_memory=device.type == "cuda")
        buf = host.numpy()
        if transport == "yuv420":
            pack_yuv420_group([stage_yuv420(p, (size, size), reducing_gap=reducing_gap) for p in group], buf, size)
        elif transport == "gray":
            np.stack([stage_gray(p, (size, size), reducing_gap=reducing_gap) for p in group],
                     out=buf.reshape(group_pages, *per_page))
        else:
            np.stack([host_resize_rgb(p, (size, size), reducing_gap=reducing_gap) for p in group],
                     out=buf.reshape(group_pages, *per_page))
        return host

    def decode(pix: torch.Tensor) -> torch.Tensor:
        if transport == "yuv420":
            x = yuv420_to_rgb(*unpack_yuv420(pix, size))
        elif transport == "gray":
            x = pix.float()[..., None].expand(*pix.shape, 3)
        else:
            x = pix.float()
        return normalize_pixels(x, mean, std)

    done = 0
    for host in prefetch((stage(g) for g in range(n_groups)), buffer_size=2):
        pix = host.to(device, non_blocking=True)
        for c in range(chunk):
            n = min(batch_size, n_pages - done)
            if n <= 0:
                break
            with torch.inference_mode():  # not across the yield: the consumer runs in its own mode
                emb = model(input_ids=ids, attention_mask=att, pixel_values=decode(pix[c]))
            done += n
            yield emb[:n], att[:n]


def embed_pages_fused(
    model: torch.nn.Module,
    processor: Any,
    pages: Sequence[Any],
    *,
    transport: str = "yuv420",
    batch_size: int = 8,
    chunk: int = 1,
    reducing_gap: Optional[float] = None,
    prompt: Optional[str] = None,
) -> List[np.ndarray]:
    """Embed ``pages`` (PIL images or uint8 arrays) with ``model`` (a
    ColPali on its parameters' device) -> per-page ``(n_tokens, dim)`` float32
    embeddings of the prompt's valid tokens.

    ``processor`` is a fixed-resolution ColPali processor (``image_size``,
    ``image_mean``/``image_std``, ``visual_prompt_prefix``,
    ``_expand_image_prompt``, ``_tokenize``). ``chunk``: forward batches per
    upload and download. ``reducing_gap``: PIL's box pre-reduce for the host resize
    (None: exact single-pass bicubic). ``prompt``: the text around the image
    tokens (the processor's ``visual_prompt_prefix`` when None), as
    ``process_images(context_prompts=[prompt])`` takes it."""
    out: List[np.ndarray] = []
    group: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def download() -> None:  # the group's forwards are queued before the one synchronising copy
        emb = torch.cat([e for e, _ in group]).float().cpu().numpy()
        valid = torch.cat([a for _, a in group]).bool().cpu().numpy()
        out.extend(row[keep] for row, keep in zip(emb, valid))
        group.clear()

    for batch in fused_page_batches(model, processor, pages, transport=transport, batch_size=batch_size,
                                    chunk=chunk, reducing_gap=reducing_gap, prompt=prompt):
        group.append(batch)
        if len(group) == chunk:
            download()
    if group:
        download()
    return out
