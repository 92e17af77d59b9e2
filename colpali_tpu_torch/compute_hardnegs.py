"""Offline hard-negative mining over embeddings saved as ``.npz`` (PyTorch
counterpart of ``scripts/compute_hardnegs.py``; the same arguments and
``.jsonl``).

Run: ``python -m colpali_tpu_torch.compute_hardnegs queries.npz docs.npz
gold.json out.jsonl [--k 100] [--multi-vector] [--via-index] [--device
cuda]``. An ``.npz`` holds ``embeddings`` (dense, ``(n, D)``) or ragged
``emb_<i>`` arrays, as ``python -m colpali_tpu_torch.embed_corpus`` writes
them; ``gold.json`` maps each query to its gold doc index. ``--via-index``
mines through a :class:`~colpali_tpu_torch.retrieval.CorpusIndex` (int8,
with the binary prefilter from 100,000 docs) on ``--device`` in place of the
full ``(Q, C)`` score matrix.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def load_embeddings(path: str):
    """``embeddings`` of an ``.npz``, else its ``emb_<i>`` arrays in index order."""
    data = np.load(path)
    if "embeddings" in data:
        return data["embeddings"]
    return [data[k] for k in sorted(data.files, key=lambda s: int(s.split("_")[1]))]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("query_embeddings", help=".npz with query embeddings")
    parser.add_argument("doc_embeddings", help=".npz with corpus embeddings")
    parser.add_argument("gold_indices", help=".json list mapping query -> gold doc index")
    parser.add_argument("output", help="output .jsonl with negative_passages / gold_in_top_100")
    parser.add_argument("--k", type=int, default=100)
    parser.add_argument("--multi-vector", action="store_true", help="MaxSim scoring instead of dot product")
    parser.add_argument("--via-index", action="store_true",
                        help="mine through a CorpusIndex (int8 + binary prefilter) instead of the full (Q, C) "
                             "score matrix; required at 100k+ doc scale")
    parser.add_argument("--device", default="cuda", help="where --via-index builds and searches its index")
    args = parser.parse_args(argv)

    from colpali_tpu_torch.retrieval.hardneg import mine_hard_negatives

    qs = load_embeddings(args.query_embeddings)
    ds = load_embeddings(args.doc_embeddings)
    with open(args.gold_indices) as f:
        gold = json.load(f)

    if args.via_index:
        from colpali_tpu_torch.retrieval import CorpusIndex

        docs = [np.asarray(d)[None, :] if np.asarray(d).ndim == 1 else np.asarray(d) for d in ds]
        index = CorpusIndex(docs, dtype="int8", prefilter="binary" if len(docs) >= 100_000 else None,
                            device=args.device)
        results = mine_hard_negatives(qs, None, gold, k=args.k, multi_vector=args.multi_vector, index=index)
    else:
        results = mine_hard_negatives(qs, ds, gold, k=args.k, multi_vector=args.multi_vector)
    with open(args.output, "w") as f:
        for row in results:
            f.write(json.dumps(row) + "\n")
    in_top = sum(r["gold_in_top_100"] for r in results)
    print(f"Mined {len(results)} queries; gold_in_top_100 for {in_top}/{len(results)}")


if __name__ == "__main__":
    main()
