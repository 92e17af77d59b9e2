"""Embed a directory of page images into multi-vector embeddings (PyTorch
counterpart of ``scripts/embed_corpus.py``; the same arguments and outputs).

The offline half of serving: a checkpoint and images -> ragged per-page
embeddings in ``OUTPUT`` (``emb_<i>`` arrays, the file names in
``OUTPUT.files.json``), optionally token-pooled, and with ``--save-index``
a packed :class:`~colpali_tpu_torch.retrieval.CorpusIndex` built on the
device, which ``python -m colpali_tpu_torch.serve INDEX.npz`` boots from
(either package reads both files).

Run: ``python -m colpali_tpu_torch.embed_corpus colpali CKPT_DIR IMAGE_DIR
out.npz [--pool-factor 3 --pooler ward] [--save-index idx.npz
--index-prefilter --index-coarse-pool 2] [--quantize] [--transport yuv420]
[--device cuda]``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _families():
    from colpali_tpu_torch.auto import _FAMILIES

    return sorted(_FAMILIES) + ["auto"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("family", choices=_families(), help="model family, or 'auto' to detect from config.json")
    parser.add_argument("checkpoint_dir")
    parser.add_argument("image_dir")
    parser.add_argument("output", help="output .npz (keys emb_<i> + files.json alongside)")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--pool-factor", type=int, default=1,
                        help="token pooling factor (3 = the reference's ~3x storage compression; 1 = no pooling)")
    parser.add_argument("--pooler", choices=["ward", "kmeans"], default="ward",
                        help="ward = the reference's scipy hierarchical pooling (host); kmeans = batched spherical "
                             "k-means on the device")
    parser.add_argument("--save-index", metavar="PATH.npz",
                        help="also build a packed CorpusIndex on the device (DeviceIndexBuilder) and save it: "
                             "serve.py boots from it")
    parser.add_argument("--index-doc-tokens", type=int, default=None,
                        help="token budget per doc for --save-index (default: the longest pooled doc, rounded up)")
    parser.add_argument("--index-prefilter", action="store_true",
                        help="include the binary sign-sketch prefilter in --save-index")
    parser.add_argument("--index-coarse-pool", type=int, default=1,
                        help="sketch-only token pooling factor for the prefilter (the rerank stays exact)")
    parser.add_argument("--quantize", action="store_true",
                        help="serve stored-int8 weights (kernels Q1a and Q1b) in place of the checkpoint's bf16")
    parser.add_argument("--transport", choices=["rgb-u8", "yuv420", "gray"],
                        help="fused low-byte ingestion (embed_pages_fused; the ColPali family only): uint8 pixels "
                             "on the wire, decoded and normalized on the device")
    parser.add_argument("--chunk", type=int, default=1, help="with --transport: forward batches per upload")
    parser.add_argument("--reducing-gap", type=float, default=None,
                        help="with --transport: PIL's box pre-reduce for the host resize")
    parser.add_argument("--modality", choices=["image", "audio", "video"], default="image",
                        help="audio / video documents need an audio- or video-capable family (ColQwen-Omni)")
    parser.add_argument("--device", default="cuda", help="where the model runs and the index is built")
    args = parser.parse_args(argv)

    from PIL import Image

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.evaluation.evaluator import embed_dataset

    model, processor = load_retriever(args.checkpoint_dir, family=None if args.family == "auto" else args.family,
                                      quantize=args.quantize, device=args.device)

    if args.modality == "audio" and not hasattr(processor, "process_audios"):
        parser.error(f"--modality audio requires an audio-capable family (ColQwen-Omni); "
                     f"{type(processor).__name__} has no process_audios")
    if args.modality == "video" and not hasattr(processor, "process_videos"):
        parser.error(f"--modality video requires a video-capable family (ColQwen-Omni); "
                     f"{type(processor).__name__} has no process_videos")
    if args.modality != "image":  # no ported processor embeds audio or video (ROADMAP.md Queue 1 item 8)
        raise NotImplementedError(f"--modality {args.modality} waits for the Qwen-Omni family")

    files = sorted(f for f in os.listdir(args.image_dir) if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
    images = [Image.open(os.path.join(args.image_dir, f)) for f in files]
    if args.transport:
        from colpali_tpu_torch.retrieval import embed_pages_fused

        if not hasattr(processor, "image_size") or not hasattr(processor, "visual_prompt_prefix"):
            parser.error("--transport requires a fixed-resolution processor (the ColPali/PaliGemma family)")
        embeddings = embed_pages_fused(model, processor, images, transport=args.transport,
                                       batch_size=args.batch_size, chunk=args.chunk, reducing_gap=args.reducing_gap)
    else:
        embeddings = embed_dataset(model, processor, images, batch_size=args.batch_size, is_images=True)
    del model
    write_outputs(args, files, embeddings)


def write_outputs(args, files, embeddings) -> None:
    """Pool (optionally), save the ragged ``.npz`` and ``files.json``, and
    build ``--save-index``."""
    if args.pool_factor > 1:
        from colpali_tpu_torch.compression.token_pooling import HierarchicalTokenPooler, KMeansTokenPooler

        pooler = KMeansTokenPooler(device=args.device) if args.pooler == "kmeans" else \
            HierarchicalTokenPooler(device=args.device)
        before = sum(e.shape[0] for e in embeddings)
        # documents pool independently: scipy's linkage runs on a thread a document, os.cpu_count() at once
        embeddings = pooler.pool_embeddings(embeddings, pool_factor=args.pool_factor, num_workers=os.cpu_count())
        after = sum(e.shape[0] for e in embeddings)
        print(f"Pooled {before} -> {after} tokens (factor {args.pool_factor}, {args.pooler})")

    np.savez(args.output, **{f"emb_{i}": e for i, e in enumerate(embeddings)})
    with open(args.output + ".files.json", "w") as f:
        json.dump(files, f)
    print(f"Embedded {len(files)} pages -> {args.output}")

    if args.save_index:
        import torch

        from colpali_tpu_torch.retrieval import DeviceIndexBuilder
        from colpali_tpu_torch.utils.tensor_utils import pad_sequences

        doc_tokens = args.index_doc_tokens or max(e.shape[0] for e in embeddings)
        builder = DeviceIndexBuilder(doc_tokens=doc_tokens, dim=embeddings[0].shape[-1], dtype="int8",
                                     prefilter="binary" if args.index_prefilter else None,
                                     coarse_pool=args.index_coarse_pool)
        for i in range(0, len(embeddings), 256):
            builder.add(torch.from_numpy(pad_sequences(embeddings[i : i + 256], pad_to=doc_tokens)).to(args.device))
        index = builder.build()
        index.save(args.save_index)
        with open(args.save_index + ".files.json", "w") as f:
            json.dump(files, f)
        print(f"Packed index ({index.nbytes / 2**20:.1f} MiB) saved to {args.save_index}")


if __name__ == "__main__":
    main()
