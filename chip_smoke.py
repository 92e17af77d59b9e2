#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, page-embedding and training paths once on one GPU.

The serving path runs for ColPali-3B (phases 3, 4, 7 and 18, the last
with token pooling, the corpus tools and similarity maps), for the
Qwen2-VL family, ColQwen2.5-3B and ColQwen2-2B (phase 8), for the
Idefics3/SmolVLM family, colSmol-256M, with the single-vector Bi models
(phase 10), for the Gemma3 family, Gemma3-4B (phase 12), for the Qwen3-VL
family, Qwen3-VL-4B (phase 14), for the ModernVBert family,
ModernVBERT-base (phase 16), and for the Qwen3.5 family at the JAX
package's default config (phase 19); training for ColPali-3B (phase 5), the
Qwen2-VL family (phase 9), the Idefics3 family with the Bi models (phase
11), the Gemma3 family (phase 13), the Qwen3-VL family (phase 15), the
ModernVBert family (phase 17) and the Qwen3.5 family (phase 20).

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (a few lines of output each, then two JSON lines):

1. device: the card's name and power limit (``nvidia-smi``), the build
   of the CUDA kernels from ``colpali_tpu_torch/csrc`` (``build/kernels/``),
   and ``tools/b1_probe.py``'s rates on this card (single-bit and int8
   tensor-core products, CUDA-core popcounts): K1's bound is the larger of
   its bytes and its products at the fastest single-bit rate, printed
   beside the int8 proxy (the same products at the int8 peak) and the
   CUDA-core popcount floor;
2. kernels: K1 (sign-sketch coarse pass), K2 (candidate gather + rerank),
   K3 (full-int8 exact sweep) and K4 (int8 store, bf16 queries) against
   their plain PyTorch versions on a 999,936-doc x 64-token x 128-dim int8
   corpus generated on the card from a seeded ``torch.Generator``, and K5
   (bf16 store) on a bf16 copy of its first 262,144 docs; each is timed
   with CUDA events, kernel and plain version alike (K3, K4 and K5 at B=1,
   and at B=8 with Nq=32 and the served Nq=64, K4 and K5 each bit-equal on a
   second call; K2's bound is the larger of its bytes
   and its products as three bf16 passes, the fp32 CUDA-core figure beside
   it); then ``CorpusIndex.search`` on a two-tier index over that corpus,
   timed stage by stage at B=1 (a CUDA event as each stage's function
   returns: the queries' copy to the card, binarize_words, K1, the mask,
   top_k over the corpus, K2, top_k over the candidates, then the copy to
   the host);
3. text slice: ColPali-3B at full width (SigLIP-So400m 27 x 1152, projector
   1152 -> 2048, Gemma-2B 18 x 2048 with MQA 8/1 x 256 and vocab 257,216;
   seeded random bf16 weights), a whitespace tokenizer, a 65,536-doc
   two-tier int8 index saved to ``.npz`` and loaded back, and
   ``colpali_tpu_torch.serve.make_handler`` on a local HTTP server answering
   /healthz, /search_text (tiered and exact routes), /search and /tune;
4. page slice: K6 (flash attention) against its plain version and timed
   beside ``F.scaled_dot_product_attention`` at the shapes the path gives it
   (SigLIP over 8 pages, Gemma over 8 pages' prompts, Gemma over the 8 text
   queries as ``QueryEncoder`` pads them); one batch of 8 pages and the 8
   text queries embedded through the K6 route and the plain route; 32 seeded 1275 x 1650 pages through
   ``embed_pages_fused(transport="yuv420")``, an 8,192-doc x 1,040-token
   two-tier int8 index of them and seeded filler docs behind ``make_handler``,
   each of 8 pages found at rank 1 by its own first 32 token vectors on the
   tiered and the exact route; then K1, K2 and K3 against their plain
   versions on that index (K1 and K2 timed at B=1 and B=4),
   ``CorpusIndex.search`` timed by stage at B=1 and B=4, and a
   ``torch.profiler`` breakdown of one batch;
5. training slice: K6's backward kernels against autograd through the plain
   version, beside SDPA's backward, at the shapes training gives them;
   ``ColModelTraining`` taking 4 LoRA steps (rank 32, dropout 0.1, remat,
   pairwise CE, batch 8) over 32 seeded pages with every adapter moving and
   the base bit-equal; one step's loss and adapter gradient through the
   kernels against the plain route; ``evaluate()`` over 128 held-out pages
   through a bf16 index built on the card and searched by K5 (and an int8
   index of the same pages with bf16 queries by K4), each at that shape
   (one tile, B=128 Nq=16 Np=1,040: its doc tokens split over the SMs)
   bit-equal with the split off or forced elsewhere; the merged export as
   ``model.safetensors`` in the HF layout, read back by ``load_colpali_params``
   into a fresh ColPali-3B whose query and page embeddings must equal those of
   a model holding the merged weights in memory bit for bit, and whose
   ``QueryEncoder`` answers ``/search_text`` behind ``make_handler``; a
   run resumed from the step-2 checkpoint repeating step 3's loss; 6 steps
   on one repeated batch at the recipe's rate lowering the loss; and a train step timed with and
   without remat (forward, backward, optimizer by CUDA events, peak memory);
6. ops entry points (run between phases 2 and 3): K8, K9 and K10 (token-major
   MaxSim) over token-major copies of phase 2's corpora at B=1 and B=8, Nq=32
   (K10 also at the served Nq=64), against their plain versions and bit-equal
   to K5, K4 and K3, and
   ``maxsim_topk_tm(k=100)``; K11 (seq-major flash) at the seq-major probe's
   shapes (ColQwen2 vision and text, SigLIP, a padded validation case, causal
   GQA) against its plain version and beside SDPA. Phase 4 also builds a bf16
   two-tier index of its pages (K1 and K2 over a bf16 store) and finds each
   planted page at rank 1;
7. stored int8 (after phase 5): Q1a (the int8 row quantizer) and Q1b (the
   int8 GEMM with its epilogue) bit-equal to their plain versions at every
   (K, N) of ColPali-3B's quantized projections for M of 1 to 8,232, with
   and without bias, bf16 and fp32 out, and Q1a on edge rows; each timed
   at M 32, 256 and 8,232 beside its bound, its plain version,
   ``torch._int_mm`` with the epilogue and bf16 ``F.linear``; the seeded
   model written as an HF checkpoint and read back by
   ``load_retriever(quantize=True)`` (253 stored-int8 layers, the weight
   bytes on the card), Q1a on the model's own inputs, Q1a/Q1b launches of
   one query and one page forward (72/90 and 181/253), ``/search_text``
   through ``make_handler`` with the stored-int8 encoder finding planted
   docs at rank 1 on the tiered, exact and Q1 plain routes, 32 pages
   embedded, per-token cosine against the bf16 model and the plain route,
   and encode x1/x8, one forward and pages/min for stored int8 and bf16 in
   turns;
8. the Qwen2-VL family (after phase 7): Q1a/Q1b bit-equal to their plain
   versions at every (K, N) of ColQwen2.5-3B's and ColQwen2-2B's quantized
   projections (K 1,176 and 3,420 among them, in rows padded to 16 bytes)
   and timed; ColQwen2.5-3B at full width cut in depth (vision 8 x 1,280
   of 32 with 112 px windows and block 7 full, text 9 x 2,048 of 36, 16/2
   heads; seeded random bf16 parameters) written as an HF checkpoint with a word-level tokenizer at
   Qwen2's special ids and read back by ``load_retriever(family=
   "colqwen2_5")`` in bf16 and with ``quantize=True``; K6 against its plain
   version at the family's shapes (the vision tower full and windowed, the
   causal decoder with left padding at GQA 16/2 and 12/2, the queries) beside
   SDPA; 16 seeded 1,275 x 1,650 pages (744 merged tokens each) through
   ``embed_dataset`` on both models, a 4,112-doc two-tier int8 index behind
   ``make_handler`` for each finding the 4 pages planted with a query's
   tokens at rank 1 on the tiered and the exact routes of ``/search_text``,
   and ``serve.py --checkpoint --family colqwen2_5`` answering one; the K6
   route against the plain route and stored int8 against bf16 per token;
   one forward of 8 pages (CUDA events) and encode x1/x8 in turns, a
   profile of each; then ColQwen2-2B at full width cut to 8 + 7 layers
   through ``load_retriever(family="colqwen2")`` and its route check;
9. Qwen training (after phase 8, on its ColQwen2.5-3B checkpoint): K6's
   backward at D=128 (the decoders over the pages' prompts, causal GQA
   16/2 and 12/2 with left padding, and over the collated queries) and at
   D=80 (the vision tower, full and windowed) against its plain version
   per query row, bit-equal on a second call, timed beside SDPA's backward
   and its bound; ColQwen2.5-3B read by ``load_retriever(remat=True,
   mask_non_image_embeddings=True)`` (with page tokens kept its recipe loss
   reads ln 8: the maxima fall on the causal template that opens every
   page), the first batch's recipe loss over the image tokens at least 0.05
   from ln 8, taking 4 LoRA steps through ``ColModelTraining`` (``ColbertLoss(
   temperature=0.02)``, rank 32, alpha 32, dropout 0.1, batch 8 over 32
   pages) with every adapter moving, the base bit-equal and that loss
   moved, 18 backward launches a step (2 x 9 layers) all at D=128, one
   step's loss (not ln 8 on both routes) and adapter gradient against the
   plain route, ``evaluate()`` over 16 held-out pages (bf16
   index, K5), the merged export read back by ``load_retriever(family=
   "colqwen2_5")`` (embeddings bit-equal to the merged weights in memory)
   and served through ``/search_text``, a run resumed from step 2
   repeating step 3's loss, a step timed with and without remat; the same
   model over a stored-int8 frozen vision tower (``quantize_frozen_base``:
   2 steps, 59 Q1b launches a step, no gradient through it, the export
   holding ``q * scale``, a step timed); ColQwen2-2B's 2 LoRA steps and its
   route check; one full fine-tuning step of ColQwen2.5 at full width cut
   to 4 vision blocks and 2 text layers (batch 8), through the D=80
   backward, its gradient against the plain route, the recipe loss over
   the pages' image tokens at least 0.05 from ln 8 (with page tokens kept
   it reads ln 8: every maximum on the shared causal template) and moved
   by the step.

10. the Idefics3/SmolVLM family (after phase 9): colSmol-256M at its
   published widths (SigLIP-B/16-512 12 x 768, pixel shuffle by 4, a
   12,288 -> 576 connector, SmolLM2-135M 30 x 576 with GQA 9/3 x 64; 0.256 B
   seeded random bf16 parameters) written as an HF checkpoint with a
   word-level tokenizer holding Idefics3's special tokens and read back by
   ``load_retriever(family="colidefics3")`` in bf16 and with
   ``quantize=True`` (223 stored-int8 layers); K6 at D=64 against its plain
   version at the path's shapes (the vision tower over 8 pages' 104 tiles,
   the causal decoder over the pages' prompts with rows right-padded under
   the key-padding mask, the queries), bit-equal on a second call, beside
   SDPA; Q1a/Q1b bit-equal to their plain versions at the (M, K, N) of a page
   forward and the query forwards (K 576, 768, 1,536, 3,072 and 12,288) and
   timed; 16 seeded 1,275 x 1,650 pages (13 tiles each) through
   ``embed_dataset`` on both models, a two-tier int8 index behind
   ``make_handler`` for each finding the 4 planted pages at rank 1 on the
   tiered and the exact route of ``/search_text``, ``serve.py --checkpoint
   --family colidefics3`` answering one, every K6 launch at D=64 and none
   through its plain version; K1-K3 against plain on both indexes; the K6
   route against the plain route and stored int8 against bf16 per token;
   split-image similarity maps of 8 pages (``get_local_image_mask``)
   against a float64 einsum; forward and encode timings and two profiles;
   then BiIdefics3 at full
   width (on the checkpoint's backbone), BiPaliProj and BiQwen2_5 at full
   width cut to 2 + 2 layers: each vector through the K6 route against the
   plain route, and the Bi processor's ``score`` finding planted pages.
11. colSmol training (after phase 10): K6's backward at D=64 against its
   plain version (and the exact gradient) at the path's shapes: the causal
   decoder over 8 pages' prompts with queries id 1 and the keys the
   validity mask (every query row read), the collated queries, and the
   vision tower over 104 tiles (full fine-tuning only; against the exact
   gradient, beside the same draw at D=80), bit-equal on a second call, timed beside SDPA's backward and its bound; colSmol-256M
   at full width written as an HF checkpoint, read by
   ``load_retriever(family="colidefics3", remat=True)`` and trained
   through ``ColModelTraining`` from ``configs/train_colidefics3.yaml``
   (its loss and LoRA through ``configs.instantiate``; batch 8, 4 steps over 32
   pages of 13 tiles): 60 K6 backward launches a step, all at D=64, none
   through the plain version; one step against the plain route,
   ``evaluate()`` over 32 pages (bf16 index, K5), the merged export read
   back by ``load_retriever`` and served through ``/search_text``, a run
   resumed from step 2 repeating step 3's loss, a step at the recipe's
   batch of 32 with and without remat, a profile of one at 8, and one
   step over a stored-int8 frozen vision tower (72 layers); BiIdefics3
   from ``train_biidefics3.yaml`` (2 steps, queries of unequal lengths so
   that ``last`` reads pad rows, against the plain route in bf16 and in
   fp32, a step at its recipe's batch of 64); BiPaliProj and BiQwen2_5 at
   full width cut to 2 + 2 layers, one LoRA step each through
   ``ColModelTraining`` against the plain route.
12. the Gemma3 family (after phase 11): Gemma3-4B at its published widths
   cut in depth (SigLIP-So400m at 896 px, 9 x 1,152 of 27, 16 heads of 72,
   4,096 patches pooled 4 x 4 to 256 soft tokens; the text decoder 12 x
   2,560 of 34, 8/4 heads of 256, MLP 10,240, vocab 262,208, a window of
   1,024 on 5 layers of 6; seeded random bf16 parameters) written by
   ``utils.testing.write_gemma3_checkpoint`` with a word-level tokenizer
   holding Gemma3's special tokens and read back by
   ``load_retriever(family="colgemma3")`` in bf16 and with
   ``quantize=True`` (138 stored-int8 layers); K6 at the tower's shape (B=8,
   S=4,096, H=16, D=72) against its plain version, bit-equal on a second
   call, beside SDPA masked and unmasked; the biased text attention (no
   kernel, as in JAX) timed beside SDPA; Q1a/Q1b bit-equal to their plain
   versions at the (M, K, N) of a page forward and the query forwards and
   timed; 9 K6 launches a page forward and none a query forward; 16 seeded
   pages through ``embed_dataset`` on both models, a 4,096-doc two-tier int8
   index at the pages' token count behind ``make_handler`` for each, the 4
   planted pages at rank 1 on the tiered and the exact route of
   ``/search_text``, ``serve.py --checkpoint --family colgemma3`` answering
   one, every K6 launch at D=72 and none through its plain version; K1-K3
   against plain on both indexes; the K6 route against the plain route and
   stored int8 against bf16 per token; an 8-page forward and encode x1/x8
   timed in turns, two profiles; BiGemma3 at full width with
   ``embedding_dim=768`` through both routes and its processor's ``score``.
13. Gemma3 training (after phase 12, on its checkpoint): Gemma3-4B read by
   ``load_retriever(family="colgemma3", remat=True)`` and trained through
   ``ColModelTraining`` from ``configs/train_colgemma3.yaml`` (its
   ``ColbertLoss(temperature=0.02)`` and LoRA through
   ``configs.instantiate``; batch 8, 4 steps over 32 pages): 9 K6 forward
   launches a step (the frozen tower) and no backward (the text attention
   is biased), none through the plain version; one step against the plain
   route, ``evaluate()`` over 16 pages (bf16 index, K5), the merged export
   read back by ``load_retriever`` and served, a step with and without
   remat and a profile of one, one step over a stored-int8 frozen vision
   tower (54 layers); BiGemma3 from ``train_bigemma3.yaml``, 2 steps.
14. the Qwen3-VL family (after phase 13): Qwen3-VL-4B at its published
   widths (vision 27 x 1,152, 16 heads of 72, 16 px patches, a 48 x 48
   learned position table read by four bilinear taps a patch, deepstack
   mergers after blocks 8, 16 and 24; text 2,560 wide, 32/8 heads of 128,
   MLP 9,728, interleaved M-RoPE, cut to 9 of its 36 layers since phase 19
   came; a 320-wide head; seeded random bf16 parameters) written by
   ``utils.testing.write_qwen3_checkpoint`` and read back by
   ``load_retriever(family="colqwen3")`` in bf16 and with ``quantize=True``
   (234 stored-int8 layers); K6 at the path's shapes (the
   tower over 8 pages, B=8 S=2,976 D=72 with the patch mask; the decoder,
   causal GQA 32/8 at D=128 with left padding; the queries) against its
   plain version, bit-equal on a second call, beside SDPA masked and
   unmasked; Q1a/Q1b bit-equal to their plain versions at the (M, K, N) of a
   page forward and the query forwards and timed; 27 + 9 K6 launches a page
   forward, 9 a query forward; 16 seeded pages (744 merged tokens each)
   through ``embed_dataset`` on both models, a 4,112-doc two-tier int8 index
   320 wide behind ``make_handler`` for each, the 4 planted pages at rank 1
   on the tiered and the exact route of ``/search_text``, ``serve.py
   --checkpoint --family colqwen3`` answering one, no K6 launch through its
   plain version; K1-K3 against plain on both indexes; K3 and K10 at D=320
   (the served sweep, B=8 Nq=64 over the int8 page index, and B=1 Nq=32 over
   a 262,144-doc x 64-token corpus) against K3's plain version, bit-equal on
   a second call and to each other, timed beside their bound; the K6 route
   against the plain route and stored int8 against bf16 per token; an 8-page
   forward and encode x1/x8 timed in turns, two profiles; BiQwen3 at full
   width through both routes, its processor's ``score`` and against fp32.
15. Qwen3-VL training (after phase 14, on its checkpoint): K6's backward at
   the decoder's shapes (causal GQA 32/8 at D=128 over the pages' prompts
   with left padding and over the collated queries) against its plain
   version per query row, bit-equal on a second call, beside SDPA's
   backward; Qwen3-VL-4B read by ``load_retriever(family="colqwen3",
   remat=True)`` and trained through ``ColModelTraining`` from
   ``configs/train_colqwen3.yaml`` (its ``ColbertLoss(temperature=0.02)`` and
   LoRA r32 through ``configs.instantiate``; batch 8, 4 steps over 32 pages):
   18 K6 backward launches a step, all at D=128, none through the plain
   version, step 1's loss at least 0.05 from ln 8; one step against the
   plain route, ``evaluate()`` over 16 pages (a 320-wide bf16 index, K5),
   the merged export read back by ``load_retriever`` and served, a run
   resumed from step 2 repeating step 3's loss, a step with and without
   remat and a profile of one, one step over a stored-int8 frozen vision
   tower (171 layers, the deepstack mergers among them); one BiQwen3 LoRA
   step at full width cut to 2 + 2 layers.
16. the ModernVBert family (after phase 15): ModernVBERT-base at its
   published widths and depth (SigLIP-B/16-512 12 x 768, 12 heads of 64,
   pixel shuffle by 4, a 12,288 -> 768 connector; a bidirectional ModernBERT
   encoder 22 x 768, 12 heads of 64, GeGLU 2 x 1,152, global attention on
   every third layer and a window of 128 on the others; vocab 50,368 with
   128 additional ids holding the tile tokens; 0.244 B seeded random bf16
   parameters) written by ``utils.testing.write_modernvbert_checkpoint`` and
   read back by ``load_retriever(family="colmodernvbert")`` in bf16 and with
   ``quantize=True`` (205 stored-int8 layers); the encoder's biased
   attention (no kernel, as in JAX) at B=8 S=866 H=12 D=64, global and
   local, beside SDPA on the same boolean mask; Q1a/Q1b bit-equal to their
   plain versions at the (M, K, N) of a page forward and the query forwards
   and timed; 12 K6 launches a page forward (D=64, every tile of the padded
   batch; K6 at this shape is held and timed in phase 10) and none a query
   forward, 22 biased attention calls a forward (8 global, 14 local); 16
   seeded pages (13 tiles, 866 tokens each) through ``embed_dataset`` on both
   models, a two-tier int8 index behind ``make_handler`` for each, the 4
   planted pages at rank 1 on the tiered and the exact route of
   ``/search_text``, ``serve.py --checkpoint --family colmodernvbert``
   answering one, no K6 launch through its plain version; K1-K3 against
   plain on both indexes; the K6 route against the plain route, stored int8
   against bf16 and a query alone against the same query in a bucketed
   batch, per token; an 8-page forward and encode x1/x8 timed in turns, two
   profiles; BiModernVBert at full width through both routes, its
   processor's ``score`` and against fp32.
17. ModernVBert training (after phase 16, on its checkpoint):
   ModernVBERT-base read by ``load_retriever(family="colmodernvbert",
   remat=True)`` and trained through ``ColModelTraining`` from
   ``configs/train_colmodernvbert.yaml`` (its ``ColbertLoss(temperature=
   0.02)`` and LoRA r32 over JAX's 133 kernels; batch 8, 4 steps over 32
   pages): the frozen tower's 12 K6 forward launches a step, no backward
   (the encoder's attention is biased), step 1's loss at least 0.05 from ln
   8; one step against the plain route, ``evaluate()`` over 16 pages (bf16
   index, K5), the merged export read back by ``load_retriever`` and
   served, a run resumed from step 2 repeating step 3's loss, a step with
   and without remat and a profile of one, one step over a stored-int8
   frozen vision tower (72 layers; the connector stays bf16), one
   BiModernVBert LoRA step at full width and depth.
18. pooled ingestion and the offline corpus tools (right after phase 7, on
   ColPali-3B and phase 7's HF checkpoint of it): 32 seeded pages (16
   through ``prompt=``) through ``retrieval.ingest.fused_page_batches``
   (``embed_pages_fused``'s pipeline), their device embeddings and seeded
   unit filler docs of 1,029 tokens pooled by 3 inside two
   ``DeviceIndexBuilder``s (Ward and k-means) into 1,024-doc two-tier int8
   indexes at Np = 352 (sketch pooled by 2), each planted page at rank 1 on
   their tiered and exact routes, K1-K3 against their plain versions and
   timed at that length, the MaxSim retention of each planted query; the
   device Ward against scipy's Ward (partition-identical on random unit
   docs of 24-48 tokens at dims 16 and 128; the share of identical
   partitions at page scale, with each first differing merge's gap);
   pooling of one 8-page batch timed beside the forward; ``embed_corpus``
   (scipy Ward on the host, stored int8, the yuv420 wire, a packed index)
   over 16 PNG pages, ``serve.py`` booted from that index answering
   ``/search_text`` and finding the planted pages through ``/search``;
   ``compute_hardnegs`` (MaxSim, and through an int8 index; dense vectors
   through the 1-token index: K3 at Np = 16), every gold page in the top
   100 and none among the negatives; similarity maps of 4 pages against a
   float64 einsum; ``VisualRetrieverCollator(device_pixels=True)``.
19. the Qwen3.5 family: ColQwen3_5 at the JAX package's default
   config at full width and depth (Qwen3-VL-4B's tower, its merger writing
   the decoder's 2,048; the hybrid decoder 48 x 2,048: 36 GatedDeltaNet
   layers, 16/32 heads of 128 and a conv of 4, and 12 gated attention
   layers, 16/2 heads of 256 with rotary over 64, on the biased route, as in
   JAX; MLP 5,120; a 128-wide head; seeded random bf16 parameters) written
   by ``utils.testing.write_qwen35_checkpoint`` and read back by
   ``load_retriever(family="colqwen3_5")`` in bf16 and with
   ``quantize=True`` (435 stored-int8 layers); Q2 (the chunked gated delta
   rule) against its plain version at the page shape (B=8, the pages'
   prompts) and the query shape, on fp32 inputs within 1e-4 of the output's
   RMS and on bf16 inputs by K6's forward rule, bit-equal on a second call,
   and a draw of 2.0 log-decay a token finite, timed beside its bound; Q1a/Q1b
   bit-equal to their plain versions at the path's (M, K, N) and timed at
   the decoder's; 27 K6 and 36 Q2 launches a page forward, 36 Q2 a query
   forward; 32 seeded pages through ``embed_dataset`` on both models, a
   two-tier int8 index behind ``make_handler`` with the 4 planted pages at
   rank 1 on the tiered and the exact route of ``/search_text``, ``serve.py
   --checkpoint --family colqwen3_5`` finding two, no launch through a plain
   version; K1-K3 against plain on the index; both bf16 routes (kernels,
   plain versions) against the plain route in fp32, the kernel route no
   farther from it than 1.5 times the plain route (at this depth on random
   weights bf16 alone moves the tokens), and stored int8 against bf16 layer
   by layer (each decoder layer and the tower on the bf16 model's own
   inputs; end to end read, not held); an 8-page forward and encode x1/x8
   timed in turns, two profiles with Q2's share of the kernel time;
   BiQwen3_5 at full width on the same fp32 witness, its processor's
   ``score`` finding planted pages.
20. Qwen3.5 training (last): Q2's backward (``csrc/gated_delta_rule_bwd.cu``)
   against its plain backward at the page shape (B=8, the pages' prompts,
   q/k/v strided views of the conv's output) and the query shape, in fp32
   and bf16, each of the five gradients within 1e-3 of its RMS (a bf16 ulp
   more for bf16 outputs), bit-equal on a second call, and a draw of 2.0
   log-decay a token finite, timed beside its bound and its plain
   backward; ColQwen3_5 at the default config's widths with the decoder cut
   to ``QWEN35_TRAIN_DEPTH`` (12 of 48 layers: 9 GatedDeltaNet, 3 gated
   attention; the tower at its 27 blocks) written by
   ``write_qwen35_checkpoint``, read by ``load_retriever(family=
   "colqwen3_5", remat=True, mask_non_image_embeddings=True)``; the routes
   on fresh adapters against the plain route in fp32 (``hold_routes(
   fp32_model=)``, and the in-batch scores and tokens, which concentrate
   where a single loss value does not: ``route_scores_check``); 4 LoRA steps through ``ColModelTraining`` from
   ``configs/train_colqwen3_5.yaml``'s loss and LoRA (r32, a32; batch 8
   over 32 pages of four sizes, ``mixed_size_dataset``), step 1's loss at
   least 0.05 from ln 8 and step 1's batch's loss moved 5% or more, Q2's backward on every GatedDeltaNet
   layer behind the first adapter (16 launches a step) and no plain
   version; ``evaluate()`` over 16 pages (bf16 index, K5); the merged export
   read back by ``load_retriever`` and served; a run resumed from step 2
   repeating step 3's loss; a step with and without remat and a profile of
   one (Q2's backward its own class); one step over a stored-int8 frozen
   tower; one BiQwen3_5 LoRA step at the same widths and depth.
   Each phase from 8 on logs the GiB held on the card as it starts (past 1
   GiB, with the chain of referrers that holds the largest module trees);
   every phase's seconds are logged as it ends and listed in the JSON line,
   and the script's total before it.

Every K6 and K11 case prints, beside its time by CUDA events, TFLOP/s,
the share of its bound, and SDPA with a boolean mask and, where the
segments are all one, without one (its flash backend); each forward case
also the kernel's device time from ``torch.profiler`` (at small shapes
back-to-back launches measure the host). The backward is read by events
only: its dq kernel may run on a side stream beside dkv.

Each check of phases 8 and 9 also prints its reading as a share of its limit.
It exits non-zero, printing no result, when no CUDA device is visible or
any check fails. The line before the last lists each kernel with its
launches on its slice's path; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import re
import tempfile
import subprocess
import sys
import time
import zlib
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from colpali_tpu_torch.ops import _cuda
from colpali_tpu_torch.ops import flash_attention as fa
from colpali_tpu_torch.ops import maxsim_token_major as tm
from colpali_tpu_torch.ops.flash_seqmajor import FLASH_SEQMAJOR, flash_seqmajor, flash_seqmajor_plain
from colpali_tpu_torch.ops.maxsim_binary import (
    BINARY_MAXSIM,
    binary_maxsim_tiled,
    binary_maxsim_tiled_plain,
)
from colpali_tpu_torch.ops.maxsim_tiled import (
    DOC_TILE,
    GATHER_RERANK,
    GATHER_RERANK_BF16,
    MAXSIM_BF16,
    MAXSIM_INT8,
    MAXSIM_INT8_BF16,
    _maxsim_bf16_cuda,
    gather_rerank_plain,
    gather_rerank_tiled,
    maxsim_bf16_plan,
    maxsim_int8_tiled,
    maxsim_int8_tiled_plain,
    maxsim_int8mxu_tiled,
    maxsim_int8mxu_tiled_plain,
    maxsim_tiled,
    maxsim_tiled_plain,
)
from colpali_tpu_torch.ops import gated_delta_rule as gdr
from colpali_tpu_torch.ops import quant_dense as qd
from colpali_tpu_torch.ops.quant import binarize_words, quantize_per_token
from colpali_tpu_torch.utils.tensor_utils import top_k

SEED = 0
CORPUS_DOCS = 999_936  # 7,812 tiles of 128 docs
DOC_TOKENS = 64
DIM = 128
COARSE_POOL = 4
QUERY_TOKENS = 32  # bench.py's query length
SERVED_TOKENS = 64  # MicroBatcher.query_token_pad: every served sweep pads queries to it
CANDIDATES = 1024
CHECK_TILES = 64  # tiles at each end of the corpus compared with the plain version
BF16_DOCS = 262_144  # K5's corpus: a bf16 copy of the first 2,048 tiles (4.3 GB)
RTOL, ATOL = 1e-5, 1e-4  # K2-K5 vs plain: fp32 sums in another order
KERNELS = {
    "binary_maxsim": dict(counter=BINARY_MAXSIM, route="cuda",
                          source="colpali_tpu_torch/csrc/binary_maxsim.cu",
                          replaces="colpali_tpu/ops/maxsim_binary.py:117"),
    "gather_rerank": dict(counter=GATHER_RERANK, route="cuda",
                          source="colpali_tpu_torch/csrc/gather_rerank.cu",
                          replaces="colpali_tpu/ops/maxsim_pallas.py:512"),
    "maxsim_int8": dict(counter=MAXSIM_INT8, route="cuda",
                        source="colpali_tpu_torch/csrc/maxsim_int8.cu",
                        replaces="colpali_tpu/ops/maxsim_pallas.py:465"),
    "maxsim_int8_bf16": dict(counter=MAXSIM_INT8_BF16, route="cuda",
                             source="colpali_tpu_torch/csrc/maxsim_bf16.cu",
                             replaces="colpali_tpu/ops/maxsim_pallas.py:418"),
    "maxsim_bf16": dict(counter=MAXSIM_BF16, route="cuda",
                        source="colpali_tpu_torch/csrc/maxsim_bf16.cu",
                        replaces="colpali_tpu/ops/maxsim_pallas.py:364"),
    "flash_attention": dict(counter=fa.FLASH_ATTENTION, route="cuda",
                            source="colpali_tpu_torch/csrc/flash_attention.cu",
                            replaces="colpali_tpu/models/layers.py:389"),
    "flash_attention_bwd": dict(counter=fa.FLASH_ATTENTION_BWD, route="cuda",
                                source="colpali_tpu_torch/csrc/flash_attention_bwd.cu",
                                replaces="colpali_tpu/models/layers.py:380"),
    "maxsim_pallas_tm": dict(counter=tm.MAXSIM_BF16_TM, route="cuda",
                             source="colpali_tpu_torch/csrc/maxsim_bf16.cu",
                             replaces="colpali_tpu/ops/maxsim_pallas.py:146"),
    "maxsim_pallas_int8_tm": dict(counter=tm.MAXSIM_INT8_BF16_TM, route="cuda",
                                  source="colpali_tpu_torch/csrc/maxsim_bf16.cu",
                                  replaces="colpali_tpu/ops/maxsim_pallas.py:209"),
    "maxsim_pallas_int8mxu_tm": dict(counter=tm.MAXSIM_INT8_TM, route="cuda",
                                     source="colpali_tpu_torch/csrc/maxsim_int8.cu",
                                     replaces="colpali_tpu/ops/maxsim_pallas.py:296"),
    "flash_seqmajor": dict(counter=FLASH_SEQMAJOR, route="cuda",
                           source="colpali_tpu_torch/csrc/flash_attention.cu",
                           replaces="colpali_tpu/ops/flash_seqmajor.py:168"),
    "gather_rerank_bf16": dict(counter=GATHER_RERANK_BF16, route="cuda",
                               source="colpali_tpu_torch/csrc/gather_rerank.cu",
                               replaces="colpali_tpu/ops/maxsim_pallas.py:512"),
    "quantize_rows": dict(counter=qd.QUANTIZE_ROWS, route="cuda", source="colpali_tpu_torch/csrc/quant_dense.cu",
                          replaces="colpali_tpu/ops/quant_dense.py:54"),
    "int8_gemm": dict(counter=qd.INT8_GEMM, route="cuda", source="colpali_tpu_torch/csrc/quant_dense.cu",
                      replaces="colpali_tpu/ops/quant_dense.py:113"),
    "gated_delta_rule": dict(counter=gdr.GATED_DELTA_RULE, route="cuda",
                             source="colpali_tpu_torch/csrc/gated_delta_rule.cu",
                             replaces="colpali_tpu/models/qwen3_5.py:161"),
    "gated_delta_rule_bwd": dict(counter=gdr.GATED_DELTA_RULE_BWD, route="cuda",
                                 source="colpali_tpu_torch/csrc/gated_delta_rule_bwd.cu",
                                 replaces="colpali_tpu/models/qwen3_5.py:161"),
}
SERVING_KERNELS = ("binary_maxsim", "gather_rerank", "maxsim_int8", "flash_attention")  # the paths of phases 3-4
TRAINING_KERNELS = ("maxsim_bf16", "flash_attention", "flash_attention_bwd")  # phase 5's: the steps and the eval
OPS_KERNELS = ("maxsim_pallas_tm", "maxsim_pallas_int8_tm", "maxsim_pallas_int8mxu_tm", "flash_seqmajor")  # phase 6's
BF16_INDEX_KERNELS = ("binary_maxsim", "gather_rerank_bf16")  # the bf16 two-tier index's searches in phase 4
QUANT_KERNELS = ("quantize_rows", "int8_gemm")  # phase 7's: load_retriever(quantize=True) serving and embedding
# K4 (maxsim_int8_bf16) is on no training path: evaluate() builds a bf16 index. Its path is CorpusIndex.search on
# an int8 index with quantize_queries=False, driven and counted on its own in phase 5
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
# rates measured on this card in phase 1 by tools/b1_probe.py: single-bit products (b1_wgmma, b1_k256,
# b1_k128), int8 mma.sync (s8_k32) and 32-bit popcounts on the CUDA cores (popc_xor)
RATES: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def free_memory(phase: str) -> float:
    """Collect what an earlier phase left in reference cycles before the next
    phase allocates, and log (and return) the GiB still allocated on the
    card; past 1 GiB, also what holds it (:func:`memory_holders`). Servers
    are closed with ``RetrievalServer.server_close``, which stops the
    batcher threads that hold their indexes and models."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30
    log(f"{phase}: {held:.2f} GiB held on the card as it starts")
    if held > 1.0:
        for line in memory_holders():
            log(f"  held: {line}")
    return held


def _describe(obj) -> str:
    """A short name of a referrer: a frame or generator by its function, a
    thread by its name, a dict by the object whose ``__dict__`` it is."""
    import types

    if isinstance(obj, types.FrameType):
        return f"frame {obj.f_code.co_name} ({obj.f_code.co_filename.rsplit('/', 1)[-1]}:{obj.f_lineno})"
    if isinstance(obj, types.GeneratorType):
        return f"generator {obj.gi_code.co_qualname}"
    if isinstance(obj, dict):
        owners = [o for o in gc.get_referrers(obj) if getattr(o, "__dict__", None) is obj]
        return f"{type(owners[0]).__name__}.__dict__" if owners else f"dict ({len(obj)} keys)"
    return type(obj).__name__


def memory_holders(top: int = 4, depth: int = 8) -> list:
    """What keeps the largest module trees on the card alive: for each
    top-level ``nn.Module`` holding over 0.1 GiB of CUDA parameters and
    buffers, a chain of referrers up from it, ``depth`` steps (frames and
    generators followed first, then objects' ``__dict__``), which ends
    where nothing more refers: a running thread's frame, a module global."""
    import sys
    import types

    here = sys._getframe()
    modules = [o for o in gc.get_objects() if isinstance(o, torch.nn.Module)]
    children = {id(c) for m in modules for c in m.children()}
    sized = []
    for m in modules:
        if id(m) in children:
            continue
        gib = sum(t.numel() * t.element_size() for t in (*m.parameters(), *m.buffers()) if t.is_cuda) / 2**30
        if gib > 0.1:
            sized.append((gib, m))
    mine = {id(here), id(modules), id(sized), *(id(gm) for gm in sized)}
    lines = []
    for gib, m in sorted(sized, key=lambda gm: -gm[0])[:top]:
        chain, obj = [], m
        for _ in range(depth):
            refs = [r for r in gc.get_referrers(obj) if id(r) not in mine]
            if not refs:
                break
            refs.sort(key=lambda r: (not isinstance(r, (types.FrameType, types.GeneratorType)),
                                     not isinstance(r, dict)))
            mine.add(id(refs))
            chain.append(" | ".join(_describe(r) for r in refs[:3]))
            obj = refs[0]
        lines.append(f"{type(m).__name__} ({gib:.2f} GiB on the card) <- " + " <- ".join(chain))
        del chain, obj, refs
    return lines


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the HBM rate and
    the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def k1_bound(b: int, nq: int, c: int, npc: int, w: int) -> dict:
    """K1's bound at one shape: the larger of its bytes (the sketch read
    once, whatever the batch, the query words and validity, the scores
    written) and its products (D bits of every query token x doc token
    pair, an AND and an add each) at this card's fastest measured
    single-bit tensor-core rate (the data sheet gives none; ``bound_ms_b1``).
    Beside it: the same products at the int8 peak (``bound_ms_int8_proxy``,
    the bound of PR 6's rows) and the CUDA-core popcount floor (a popcount
    per word of every pair)."""
    pairs = b * nq * c * npc
    nbytes = c * w * npc * 4 + b * nq * (w + 1) * 4 + b * c * 4
    ops = 2 * pairs * 32 * w
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_b1 = ops / max(RATES[k] for k in ("b1_wgmma", "b1_k256", "b1_k128")) * 1e3
    return dict(bound_ms=max(t_bytes, t_b1), bound_by="bytes" if t_bytes >= t_b1 else "operations",
                bound_ms_b1=t_b1, bound_ms_int8_proxy=bound(nbytes, ops, "int8")["bound_ms"],
                popcount_floor_ms=pairs * w / RATES["popc_xor"] * 1e3)


def k2_bound(b: int, nq: int, c: int, np_: int, d: int, value_bytes: int) -> dict:
    """K2's bound: the candidates' bytes (values, and the int8 store's
    scales) against its products as three bf16 passes at the bf16 peak, the
    work done at the accuracy the port holds K2 to; ``bound_ms_fp32``, the
    same products once at the CUDA cores' fp32 peak, is kept beside it."""
    nbytes = b * c * np_ * (d * value_bytes + (4 if value_bytes == 1 else 0)) + b * nq * d * 4 + b * c * 8
    ops = 2 * b * nq * c * np_ * d
    return dict(**bound(nbytes, 3 * ops, "bf16"), bound_ms_fp32=bound(nbytes, ops, "fp32")["bound_ms"])


def reset_launches() -> None:
    for spec in KERNELS.values():
        spec["counter"].reset()
    for by_dim in (fa.FORWARD_LAUNCHES_BY_HEAD_DIM, fa.BACKWARD_LAUNCHES_BY_HEAD_DIM):
        for d in by_dim:
            by_dim[d] = 0


def read_launches(phase: str, names=SERVING_KERNELS) -> dict:
    """The launches of the kernels ``names`` since :func:`reset_launches`;
    every kernel of the path must have run."""
    launches = {name: KERNELS[name]["counter"].launches for name in names}
    if not all(launches.values()):
        raise AssertionError(f"{phase}: a kernel of the path was not launched: {launches}")
    return launches


def device_ms(fn, calls: int = 5):
    """Device time of ``fn`` per call from ``torch.profiler``, summed over
    the kernels it launches: their own time, where back-to-back launches of
    a small kernel measure the host's launch rate instead. None when the
    profiler records no device time (it drops kernels late in a long run)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls
    return total or None


def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean time of ``fn`` replayed from a CUDA graph (captured once after a
    warm-up), by CUDA events: the card's time for the call without the
    host's launches, which back-to-back calls of a short kernel measure
    instead (the profiler's sums dropped kernels in long runs here)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):  # the entry points may set a kernel's attributes
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# the stages of CorpusIndex._search_tiered, each ending where the function named returns; "to host" is the rest
TIERED_STAGES = ("queries to the card", "binarize_words", "K1", "mask", "top_k over C", "K2", "top_k over c",
                 "to host")


def index_over(store, scales, bwords, num_docs: int) -> "CorpusIndex":
    """A two-tier int8 ``CorpusIndex`` around tile-major tensors already on
    the card (no copy), put together as ``CorpusIndex.load`` puts one."""
    from colpali_tpu_torch.retrieval.store import CorpusIndex

    index = object.__new__(CorpusIndex)
    index._init_common("int8", store.device, True, prefilter="binary", coarse_pool=COARSE_POOL)
    index.num_docs, index.doc_tokens, index.dim = num_docs, store.shape[1], store.shape[-1]
    index.padded_docs = store.shape[0] * DOC_TILE
    index._put_store(store, scales, bwords)
    return index


def tiered_stages(label: str, index, queries: np.ndarray, k: int = 10, c: int = CANDIDATES, reps: int = 10) -> dict:
    """Mean ms of each stage of ``index.search`` on its tiered route, over
    ``reps`` searches after one warm-up, and the median host ms of a whole
    search; logged as one line. The search runs as served, its stages'
    functions wrapped to record a CUDA event as each returns (a stage whose
    kernels wait for the host counts that wait)."""
    from colpali_tpu_torch.retrieval import store as store_mod

    pending = []  # this search's events still to record, in stage order

    def marked(fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            if not pending:
                raise AssertionError("the search ran more stages than the tiered route has")
            pending.pop(0).record()
            return out
        return call

    cls = store_mod.CorpusIndex
    patches = [mock.patch.object(cls, name, marked(getattr(cls, name))) for name in ("_prep_queries", "_mask_fake")]
    patches += [mock.patch.object(store_mod, name, marked(getattr(store_mod, name)))
                for name in ("binarize_words", "binary_maxsim_tiled", "top_k", "gather_rerank")]
    for p in patches:
        p.start()
    try:
        ms = np.zeros(len(TIERED_STAGES))
        host = []
        for rep in range(reps + 1):  # the first is the warm-up
            events = [torch.cuda.Event(enable_timing=True) for _ in range(len(TIERED_STAGES) + 1)]
            torch.cuda.synchronize()
            pending[:] = events[1:-1]
            t0 = time.perf_counter()
            events[0].record()
            index.search(queries, k=k, candidates=c)
            events[-1].record()
            t_host = (time.perf_counter() - t0) * 1e3
            if pending:
                raise AssertionError(f"the search skipped {len(pending)} of its tiered stages")
            torch.cuda.synchronize()
            if rep:
                host.append(t_host)
                ms += [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    finally:
        for p in patches:
            p.stop()
    r = dict(zip(TIERED_STAGES, (ms / reps).tolist()), search_host_ms=float(np.median(host)))
    log(f"  tiered search stages, {label}: " + ", ".join(f"{name} {r[name]:.4f}" for name in TIERED_STAGES)
        + f" ms; a search {r['search_host_ms']:.3f} ms (host clock)")
    return r


# -- phase 1 -------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _cuda.build()
    _cuda.library()
    build_s = time.perf_counter() - t0
    ptxas = lib.with_suffix(".log").read_text()
    log(f"phase device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}, allow_tf32=False, "
        f"kernels built in {build_s:.1f} s -> {lib.name}")
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")
    from tools.b1_probe import measure_rates

    RATES.update(measure_rates(report=lambda line: log(f"  rate probe: {line}")))
    return smi


# -- phase 2 -------------------------------------------------------------------


def make_corpus(gen: torch.Generator, num_docs: int, device: torch.device):
    """Random int8 tile-major corpus, per-token scales and the pooled sign
    sketch, generated on the card a chunk of tiles at a time."""
    n_tiles = num_docs // DOC_TILE
    store = torch.empty((n_tiles, DOC_TOKENS, DOC_TILE, DIM), dtype=torch.int8, device=device)
    scales = torch.empty((n_tiles, DOC_TOKENS, DOC_TILE), dtype=torch.float32, device=device)
    npc = DOC_TOKENS // COARSE_POOL
    bwords = torch.empty((n_tiles, DIM // 32, npc, DOC_TILE), dtype=torch.int32, device=device)
    step = 256
    for s in range(0, n_tiles, step):
        k = min(step, n_tiles - s)
        store[s : s + k] = torch.randint(-127, 128, (k, DOC_TOKENS, DOC_TILE, DIM), generator=gen,
                                         device=device, dtype=torch.int8)
        scales[s : s + k] = (0.5 + torch.rand((k, DOC_TOKENS, DOC_TILE), generator=gen, device=device)) / (
            127.0 * DIM**0.5)
        deq = store[s : s + k].float() * scales[s : s + k, ..., None]
        pooled = deq.reshape(k, npc, COARSE_POOL, DOC_TILE, DIM).sum(dim=2)  # (k, Npc, T, D)
        words, _ = binarize_words(pooled)  # (k, Npc, T, W)
        bwords[s : s + k] = words.permute(0, 3, 1, 2)
    return store, scales, bwords


def phase_kernels(device: torch.device) -> tuple:
    """Each kernel against its plain version on both ends of the corpus (the
    last tiles sit past 2^31 bytes) at the bench shape (Nq=32) and at the
    shapes the served path gives it (queries padded to SERVED_TOKENS, up to
    4 queries tiered, up to 64 exact); timed over the whole corpus."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    store, scales, bwords = make_corpus(gen, CORPUS_DOCS, device)
    torch.cuda.synchronize()
    n_tiles = store.shape[0]
    log(f"phase kernels: corpus {CORPUS_DOCS} docs x {DOC_TOKENS} x {DIM} int8 "
        f"({store.numel() / 2**30:.2f} GiB, sketch pool {COARSE_POOL}) made in {time.perf_counter() - t0:.1f} s")
    ends = [slice(0, CHECK_TILES), slice(n_tiles - CHECK_TILES, n_tiles)]
    errs = {name: 0.0 for name in ("binary_maxsim", "gather_rerank", "maxsim_int8", "maxsim_int8_bf16",
                                   "maxsim_bf16")}

    def queries(b, nq):
        q = torch.randn((b, nq, DIM), generator=gen, device=device)
        q[:, -3:] = 0.0  # padded query tokens
        return q / q.norm(dim=-1, keepdim=True).clamp_min(1e-6)

    def check(name, got, want):
        err = (got - want).abs().max().item()
        if name == "binary_maxsim" and err != 0.0:
            raise AssertionError(f"K1 differs from its plain version: max abs err {err}")
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        errs[name] = max(errs[name], err)

    def cols(sl):
        return slice(sl.start * DOC_TILE, sl.stop * DOC_TILE)

    q = {shape: queries(*shape) for shape in [(1, QUERY_TOKENS), (8, QUERY_TOKENS), (1, SERVED_TOKENS),
                                              (4, SERVED_TOKENS), (8, SERVED_TOKENS), (64, SERVED_TOKENS)]}
    words = {shape: binarize_words(x) for shape, x in q.items()}
    quant = {shape: quantize_per_token(x) for shape, x in q.items()}
    cand = torch.randint(0, CORPUS_DOCS, (4, CANDIDATES), generator=gen, device=device, dtype=torch.int32)
    cand[:, 0], cand[:, 1] = 0, CORPUS_DOCS - 1

    for shape in [(1, QUERY_TOKENS), (4, SERVED_TOKENS)]:
        qw, qv = words[shape]
        full = binary_maxsim_tiled(qw, qv, bwords, DIM)
        for sl in ends:
            check("binary_maxsim", full[:, cols(sl)], binary_maxsim_tiled_plain(qw, qv, bwords[sl], DIM))
        c = cand[: shape[0]].contiguous()
        check("gather_rerank", gather_rerank_tiled(q[shape], store, scales, c),
              gather_rerank_plain(q[shape], store, scales, c))
    for shape in [(1, QUERY_TOKENS), (8, QUERY_TOKENS), (64, SERVED_TOKENS)]:
        qi, qs = quant[shape]
        full = maxsim_int8mxu_tiled(qi, qs, store, scales)
        for sl in ends:
            check("maxsim_int8", full[:, cols(sl)], maxsim_int8mxu_tiled_plain(qi, qs, store[sl], scales[sl]))

    def same_twice(name, full, again):  # two calls give the same bits
        if not torch.equal(full, again):
            raise AssertionError(f"{name}: two calls differ, max abs diff {(full - again).abs().max().item()}")

    for shape in [(1, QUERY_TOKENS), (8, QUERY_TOKENS), (8, SERVED_TOKENS)]:  # K4 on the int8 corpus
        full = maxsim_int8_tiled(q[shape], store, scales)
        same_twice(f"K4 {shape}", full, maxsim_int8_tiled(q[shape], store, scales))
        for sl in ends:
            check("maxsim_int8_bf16", full[:, cols(sl)], maxsim_int8_tiled_plain(q[shape], store[sl], scales[sl]))
    # K5 on a bf16 copy (the dequantized values rounded to bf16) of the corpus's head
    bf16_tiles = BF16_DOCS // DOC_TILE
    bstore = torch.empty((bf16_tiles, DOC_TOKENS, DOC_TILE, DIM), dtype=torch.bfloat16, device=device)
    for s0 in range(0, bf16_tiles, 256):
        bstore[s0 : s0 + 256] = (store[s0 : s0 + 256].float() * scales[s0 : s0 + 256, ..., None]).to(torch.bfloat16)
    bends = [slice(0, CHECK_TILES), slice(bf16_tiles - CHECK_TILES, bf16_tiles)]
    for shape in [(1, QUERY_TOKENS), (8, QUERY_TOKENS), (8, SERVED_TOKENS)]:
        full = maxsim_tiled(q[shape], bstore)
        same_twice(f"K5 {shape}", full, maxsim_tiled(q[shape], bstore))
        for sl in bends:
            check("maxsim_bf16", full[:, cols(sl)], maxsim_tiled_plain(q[shape], bstore[sl]))

    def k4(shape, plain=False):
        fn = maxsim_int8_tiled_plain if plain else maxsim_int8_tiled
        return lambda: fn(q[shape], store, scales)

    def k5(shape, plain=False):
        fn = maxsim_tiled_plain if plain else maxsim_tiled
        return lambda: fn(q[shape], bstore)

    def k1(shape, plain=False):
        fn = binary_maxsim_tiled_plain if plain else binary_maxsim_tiled
        return lambda: fn(*words[shape], bwords, DIM)

    def k2(shape, plain=False):
        fn = gather_rerank_plain if plain else gather_rerank_tiled
        return lambda: fn(q[shape], store, scales, cand[: shape[0]].contiguous())

    def k3(shape, plain=False):
        fn = maxsim_int8mxu_tiled_plain if plain else maxsim_int8mxu_tiled
        return lambda: fn(*quant[shape], store, scales)

    b1, b8, s1, s8 = (1, QUERY_TOKENS), (8, QUERY_TOKENS), (1, SERVED_TOKENS), (8, SERVED_TOKENS)
    results = {
        "binary_maxsim": dict(ms=time_ms(k1(b1)), plain_ms=time_ms(k1(b1, True), reps=2),
                              ms_served=time_ms(k1(s1)), ms_graph=graph_ms(k1(b1)),
                              ms_served_graph=graph_ms(k1(s1)),
                              shape=f"B=1 Nq={QUERY_TOKENS} (served: Nq={SERVED_TOKENS}) W=4 Npc=16 C={CORPUS_DOCS}"),
        "gather_rerank": dict(ms=time_ms(k2(b1)), plain_ms=time_ms(k2(b1, True)), ms_served=time_ms(k2(s1)),
                              ms_graph=graph_ms(k2(b1)), ms_served_graph=graph_ms(k2(s1)),
                              shape=f"B=1 Nq={QUERY_TOKENS} (served: Nq={SERVED_TOKENS}) c={CANDIDATES} Np={DOC_TOKENS}"),
        "maxsim_int8": dict(ms=time_ms(k3(b1)), plain_ms=time_ms(k3(b1, True), reps=2),
                            ms_b8=time_ms(k3(b8)), plain_ms_b8=time_ms(k3(b8, True), reps=2),
                            ms_served=time_ms(k3(s8)), plain_ms_served=time_ms(k3(s8, True), reps=2),
                            shape=f"B=1 and B=8 Nq={QUERY_TOKENS} (served: B=8 Nq={SERVED_TOKENS}) "
                                  f"Np={DOC_TOKENS} C={CORPUS_DOCS}"),
        "maxsim_int8_bf16": dict(ms=time_ms(k4(b1), reps=3), plain_ms=time_ms(k4(b1, True), reps=2),
                                 ms_b8=time_ms(k4(b8), reps=3), plain_ms_b8=time_ms(k4(b8, True), reps=2),
                                 ms_served=time_ms(k4(s8), reps=3), plain_ms_served=time_ms(k4(s8, True), reps=2),
                                 shape=f"B=1 and B=8 Nq={QUERY_TOKENS} (served: B=8 Nq={SERVED_TOKENS}) "
                                       f"Np={DOC_TOKENS} C={CORPUS_DOCS}"),
        "maxsim_bf16": dict(ms=time_ms(k5(b1), reps=3), plain_ms=time_ms(k5(b1, True), reps=2),
                            ms_b8=time_ms(k5(b8), reps=3), plain_ms_b8=time_ms(k5(b8, True), reps=2),
                            ms_served=time_ms(k5(s8), reps=3), plain_ms_served=time_ms(k5(s8, True), reps=2),
                            shape=f"B=1 and B=8 Nq={QUERY_TOKENS} (served: B=8 Nq={SERVED_TOKENS}) "
                                  f"Np={DOC_TOKENS} C={BF16_DOCS} bf16"),
    }
    w, npc, nq, c = DIM // 32, DOC_TOKENS // COARSE_POOL, QUERY_TOKENS, CORPUS_DOCS
    results["binary_maxsim"].update(k1_bound(1, nq, c, npc, w))
    served_k1 = k1_bound(1, SERVED_TOKENS, c, npc, w)
    results["binary_maxsim"].update(bound_ms_served=served_k1["bound_ms"], bound_by_served=served_k1["bound_by"],
                                    popcount_floor_ms_served=served_k1["popcount_floor_ms"],
                                    bound_ms_b1_served=served_k1["bound_ms_b1"])
    results["gather_rerank"].update(k2_bound(1, nq, CANDIDATES, DOC_TOKENS, DIM, 1))
    results["gather_rerank"]["bound_ms_served"] = k2_bound(1, SERVED_TOKENS, CANDIDATES, DOC_TOKENS, DIM, 1)["bound_ms"]
    results["maxsim_int8"].update(bound(c * DOC_TOKENS * (DIM + 4) + nq * (DIM + 4) + c * 4,
                                        2 * nq * c * DOC_TOKENS * DIM, "int8"))
    for key, (b, nq_k) in (("b8", b8), ("served", s8)):  # K3 at B=8: Nq=32, and the served Nq=64
        kb = bound(c * DOC_TOKENS * (DIM + 4) + b * nq_k * (DIM + 4) + b * c * 4, 2 * b * nq_k * c * DOC_TOKENS * DIM,
                   "int8")
        results["maxsim_int8"].update({f"bound_ms_{key}": kb["bound_ms"], f"bound_by_{key}": kb["bound_by"]})
    # K4 and K5 at B=1: the store's bytes against bf16 operations; their B=8 bounds ride along
    for name, docs, per_token in (("maxsim_int8_bf16", c, DIM + 4), ("maxsim_bf16", BF16_DOCS, 2 * DIM)):
        results[name].update(bound(docs * DOC_TOKENS * per_token + nq * DIM * 2 + docs * 4,
                                   2 * nq * docs * DOC_TOKENS * DIM, "bf16"))
        b8_bound = bound(docs * DOC_TOKENS * per_token + 8 * nq * DIM * 2 + 8 * docs * 4,
                         2 * 8 * nq * docs * DOC_TOKENS * DIM, "bf16")
        results[name].update(bound_ms_b8=b8_bound["bound_ms"], bound_by_b8=b8_bound["bound_by"])
        served_bound = bound(docs * DOC_TOKENS * per_token + 8 * SERVED_TOKENS * DIM * 2 + 8 * docs * 4,
                             2 * 8 * SERVED_TOKENS * docs * DOC_TOKENS * DIM, "bf16")
        results[name].update(bound_ms_served=served_bound["bound_ms"], bound_by_served=served_bound["bound_by"])
    for name, r in results.items():
        r["max_abs_err"] = errs[name]
        r["library_ms"] = None  # no single PyTorch call computes these
        extra = f", B=8 kernel {r['ms_b8']:.3f} ms, plain {r['plain_ms_b8']:.3f} ms" if "ms_b8" in r else ""
        if "bound_ms_b8" in r:
            extra += f", B=8 bound {r['bound_ms_b8']:.4f} ms ({r['bound_by_b8']})"
        served = f"served shape {r['ms_served']:.3f} ms, " if "ms_served" in r else ""
        if "ms_graph" in r:
            served += f"from a CUDA graph {r['ms_graph']:.4f} ms (served {r['ms_served_graph']:.4f}), "
        if "popcount_floor_ms" in r:
            extra += (f", served bound {r['bound_ms_served']:.4f} ms ({r['bound_by_served']}), int8 proxy "
                      f"{r['bound_ms_int8_proxy']:.4f} ms, CUDA-core popcount floor {r['popcount_floor_ms']:.4f} ms "
                      f"(served {r['popcount_floor_ms_served']:.4f}), single-bit products {r['bound_ms_b1']:.4f} ms "
                      f"(served {r['bound_ms_b1_served']:.4f})")
        if "bound_ms_fp32" in r:
            extra += f", fp32 CUDA-core bound {r['bound_ms_fp32']:.4f} ms, served bound {r['bound_ms_served']:.4f} ms"
        if "plain_ms_served" in r:
            served += (f"plain {r['plain_ms_served']:.3f} ms, bound {r['bound_ms_served']:.4f} ms "
                       f"({r['bound_by_served']}), ")
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{extra}, "
            f"{served}bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}")
    corpus_index = index_over(store, scales, bwords, CORPUS_DOCS)
    results["binary_maxsim"]["tiered_stages"] = tiered_stages(
        f"{CORPUS_DOCS} docs x {DOC_TOKENS} tokens, B=1 Nq={SERVED_TOKENS}", corpus_index, q[s1].cpu().numpy())
    del bwords, corpus_index
    torch.cuda.empty_cache()
    return results, (store, scales, bstore)  # phase 6 makes token-major copies of them


# -- phase 6: the ops entry points (run after phase 2) ------------------------------

# perf/flash_seq_probe.py's shapes, (B, S, H, Hkv, D, causal, pad): the last `pad` tokens of row 0 take a pad segment
K11_SHAPES = {
    "colqwen2_vision": (8, 2464, 16, 16, 80, False, 0),
    "siglip": (8, 1024, 16, 16, 72, False, 0),
    "colqwen2_text_gqa": (8, 768, 12, 2, 128, False, 0),
    "colqwen2_text_gqa_causal": (8, 768, 12, 2, 128, True, 0),
    "validate": (2, 1024, 16, 16, 80, False, 31),
}


def token_major(tiled: torch.Tensor) -> torch.Tensor:
    """A token-major ``(Np, C, ...)`` copy of a tile-major ``(nt, Np, 128,
    ...)`` tensor, made a chunk of tiles at a time."""
    nt, np_, rest = tiled.shape[0], tiled.shape[1], tiled.shape[3:]
    out = torch.empty((np_, nt * DOC_TILE, *rest), dtype=tiled.dtype, device=tiled.device)
    for s0 in range(0, nt, 256):
        k = min(256, nt - s0)
        out[:, s0 * DOC_TILE : (s0 + k) * DOC_TILE] = tiled[s0 : s0 + k].transpose(0, 1).reshape(np_, k * DOC_TILE,
                                                                                                  *rest)
    return out


def k11_case(q, k, v, seg, causal: bool, got: torch.Tensor) -> dict:
    """K11's output ``got`` against its plain version on the valid rows, by
    K6's rule with the RMS per query row (the first rows under a causal mask
    have a few keys and outputs of order 1); where no causal mask makes rows
    unlike, also by K6's rule with one RMS. Timed beside SDPA with the masks
    this case needs."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    scale = d**-0.5
    rows = seg.bool()
    want = flash_seqmajor_plain(q, k, v, seg, scale, causal)[rows].float()
    g = got[rows].float()
    err = (g - want).abs()
    share = (err / (K6_ATOL_RMS * want.pow(2).mean(dim=(1, 2), keepdim=True).sqrt() + K6_RTOL * want.abs())).max().item()
    share_global = (err / (K6_ATOL_RMS * want.pow(2).mean().sqrt() + K6_RTOL * want.abs())).max().item()
    if not (share <= 1.0 and (causal or share_global <= 1.0)):
        raise AssertionError(f"K11 B={b} S={s} H={h}/{hkv} D={d} causal={causal} vs plain: {share:.2f} of the "
                             f"tolerance by row RMS, {share_global:.2f} by one RMS")
    max_abs_err = err.max().item()
    del want, g, err
    allowed = seg[:, :, None] == seg[:, None, :]
    if causal:
        allowed = allowed & torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    padded = not bool(seg.all())
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed[:, None] if padded else None,
                                              is_causal=causal and not padded, scale=scale, enable_gqa=h != hkv)

    pairs = allowed.sum().item()  # (query, key) pairs that this data attends
    r = dict(ms=time_ms(lambda: flash_seqmajor(q, k, v, seg, scale, causal)),
             device_ms=device_ms(lambda: flash_seqmajor(q, k, v, seg, scale, causal)),
             plain_ms=time_ms(lambda: flash_seqmajor_plain(q, k, v, seg, scale, causal), reps=2),
             library_ms=time_ms(sdpa), max_abs_err=max_abs_err, limit_share=share, limit_share_one_rms=share_global,
             **bound(2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * seg.numel(), 4 * pairs * h * d, "bf16"),
             shape=f"B={b} S={s} H={h} Hkv={hkv} D={d}" + (" causal" if causal else "")
                   + (f" last {s - int(seg[0].sum())} tokens of row 0 padded" if padded else ""))
    if not padded and not causal:  # K6's yardstick beside it: SDPA with the segments as a boolean mask
        r["library_masked_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allowed[:, None], scale=scale, enable_gqa=h != hkv))
    return dict(r, **rates(4 * pairs * h * d, r))


def phase_ops(device: torch.device, store: torch.Tensor, scales: torch.Tensor, bstore: torch.Tensor) -> tuple:
    """Drive the ops entry points of K8-K11 at full width: token-major MaxSim
    over copies of phase 2's corpora, and seq-major flash attention at the
    probe's shapes. Returns the launches over those calls and the timings."""
    gen = torch.Generator(device=device).manual_seed(SEED + 8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    docs_tm, scales_tm, bdocs_tm = token_major(store), token_major(scales), token_major(bstore)
    torch.cuda.synchronize()
    n_tiles, bf16_tiles = store.shape[0], bstore.shape[0]
    log(f"phase ops: token-major copies {tuple(docs_tm.shape)} int8 + {tuple(scales_tm.shape)} scales and "
        f"{tuple(bdocs_tm.shape)} bf16 made in {time.perf_counter() - t0:.1f} s")

    def queries(b):
        q = torch.randn((b, QUERY_TOKENS, DIM), generator=gen, device=device)
        q[:, -3:] = 0.0  # padded query tokens
        return q / q.norm(dim=-1, keepdim=True).clamp_min(1e-6)

    q = {b: queries(b) for b in (1, 8)}
    quant = {b: quantize_per_token(x) for b, x in q.items()}

    def queries_served():  # K10 at B=8 and the served query length (timed, not counted)
        x = torch.randn((8, SERVED_TOKENS, DIM), generator=gen, device=device)
        return quantize_per_token(x / x.norm(dim=-1, keepdim=True))

    flash_in = {}
    for case, (b, s, h, hkv, d, causal, pad) in K11_SHAPES.items():
        qkv = [torch.randn((b, s, n, d), generator=gen, device=device).to(torch.bfloat16) for n in (h, hkv, hkv)]
        seg = torch.ones((b, s), dtype=torch.int32, device=device)
        if pad:
            seg[0, s - pad :] = 0
        flash_in[case] = (*qkv, seg, causal)

    # the entry points, counted
    reset_launches()
    out = {}
    for b in q:
        out["k8", b] = tm.maxsim_pallas_tm(q[b], bdocs_tm)
        out["k9", b] = tm.maxsim_pallas_int8_tm(q[b], docs_tm, scales_tm)
        out["k10", b] = tm.maxsim_pallas_int8mxu_tm(*quant[b], docs_tm, scales_tm)
    top_scores, top_ids = tm.maxsim_topk_tm(q[8], bdocs_tm, k=100)
    flash_out = {case: flash_seqmajor(qq, kk, vv, seg, qq.shape[3] ** -0.5, causal)
                 for case, (qq, kk, vv, seg, causal) in flash_in.items()}
    torch.cuda.synchronize()
    launches = read_launches("ops entry points", OPS_KERNELS)
    peak = torch.cuda.max_memory_allocated() / 2**30

    # K8-K10: against the plain versions at both ends, and bit for bit against K5, K4 and K3 in tile-major layout
    errs = {name: 0.0 for name in OPS_KERNELS}

    def check(name, got, want):
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        errs[name] = max(errs[name], (got - want).abs().max().item())

    for b in q:
        for sl in (slice(0, CHECK_TILES), slice(n_tiles - CHECK_TILES, n_tiles)):
            cols = slice(sl.start * DOC_TILE, sl.stop * DOC_TILE)
            check("maxsim_pallas_int8_tm", out["k9", b][:, cols],
                  tm.maxsim_pallas_int8_tm_plain(q[b], docs_tm[:, cols], scales_tm[:, cols]))
            check("maxsim_pallas_int8mxu_tm", out["k10", b][:, cols],
                  tm.maxsim_pallas_int8mxu_tm_plain(*quant[b], docs_tm[:, cols], scales_tm[:, cols]))
        for sl in (slice(0, CHECK_TILES), slice(bf16_tiles - CHECK_TILES, bf16_tiles)):
            cols = slice(sl.start * DOC_TILE, sl.stop * DOC_TILE)
            check("maxsim_pallas_tm", out["k8", b][:, cols], tm.maxsim_pallas_tm_plain(q[b], bdocs_tm[:, cols]))
        for name, got, tile_major in (("K8 vs K5", out["k8", b], maxsim_tiled(q[b], bstore)),
                                      ("K9 vs K4", out["k9", b], maxsim_int8_tiled(q[b], store, scales)),
                                      ("K10 vs K3", out["k10", b], maxsim_int8mxu_tiled(*quant[b], store, scales))):
            if not torch.equal(got, tile_major):
                raise AssertionError(f"{name} at B={b}: not bit-equal, max abs diff "
                                     f"{(got - tile_major).abs().max().item()}")
    k5_scores, k5_ids = top_k(maxsim_tiled(q[8], bstore), 100)
    if not (torch.equal(top_ids, k5_ids) and torch.equal(top_scores, k5_scores)):
        raise AssertionError("maxsim_topk_tm(k=100) does not return the top-100 of K5's scores")
    log(f"  K8, K9 and K10 over {n_tiles * DOC_TILE} (K8: {bf16_tiles * DOC_TILE}) docs at B=1 and B=8: within rtol "
        f"{RTOL} atol {ATOL} of their plain versions on {CHECK_TILES} tiles at each end, bit-equal to K5, K4 and K3 "
        f"in tile-major layout; maxsim_topk_tm(k=100) = K5's top-100; peak device memory {peak:.2f} GiB")

    def k8(b, plain=False):
        fn = tm.maxsim_pallas_tm_plain if plain else tm.maxsim_pallas_tm
        return lambda: fn(q[b], bdocs_tm)

    def k9(b, plain=False):
        fn = tm.maxsim_pallas_int8_tm_plain if plain else tm.maxsim_pallas_int8_tm
        return lambda: fn(q[b], docs_tm, scales_tm)

    def k10(b, plain=False):
        fn = tm.maxsim_pallas_int8mxu_tm_plain if plain else tm.maxsim_pallas_int8mxu_tm
        return lambda: fn(*quant[b], docs_tm, scales_tm)

    results = {}
    c, nq = n_tiles * DOC_TILE, QUERY_TOKENS
    for name, fn, docs, per_token, kind, tile_major in (
            ("maxsim_pallas_tm", k8, bf16_tiles * DOC_TILE, 2 * DIM, "bf16", "K5"),
            ("maxsim_pallas_int8_tm", k9, c, DIM + 4, "bf16", "K4"),
            ("maxsim_pallas_int8mxu_tm", k10, c, DIM + 4, "int8", "K3")):
        q_bytes = DIM * (1 if kind == "int8" else 2) + (4 if kind == "int8" else 0)
        r = results[name] = dict(ms=time_ms(fn(1), reps=3), plain_ms=time_ms(fn(1, True), reps=2),
                                 ms_b8=time_ms(fn(8), reps=3), plain_ms_b8=time_ms(fn(8, True), reps=2),
                                 max_abs_err=errs[name], library_ms=None,
                                 **bound(docs * DOC_TOKENS * per_token + nq * q_bytes + docs * 4,
                                         2 * nq * docs * DOC_TOKENS * DIM, kind),
                                 shape=f"B=1 and B=8 Nq={nq} Np={DOC_TOKENS} C={docs} token-major")
        b8 = bound(docs * DOC_TOKENS * per_token + 8 * nq * q_bytes + 8 * docs * 4, 2 * 8 * nq * docs * DOC_TOKENS * DIM,
                   kind)
        r.update(bound_ms_b8=b8["bound_ms"], bound_by_b8=b8["bound_by"], bit_equal_to=tile_major)
        if name == "maxsim_pallas_int8mxu_tm":  # K10 also at the served Nq=64, against K3 on the same queries
            served = queries_served()
            got = tm.maxsim_pallas_int8mxu_tm(*served, docs_tm, scales_tm)
            if not torch.equal(got, maxsim_int8mxu_tiled(*served, store, scales)):
                raise AssertionError("K10 vs K3 at B=8 Nq=64: not bit-equal")
            for sl in (slice(0, CHECK_TILES), slice(n_tiles - CHECK_TILES, n_tiles)):
                cols = slice(sl.start * DOC_TILE, sl.stop * DOC_TILE)
                check(name, got[:, cols], tm.maxsim_pallas_int8mxu_tm_plain(*served, docs_tm[:, cols], scales_tm[:, cols]))
            del got
            sb = bound(docs * DOC_TOKENS * per_token + 8 * SERVED_TOKENS * q_bytes + 8 * docs * 4,
                       2 * 8 * SERVED_TOKENS * docs * DOC_TOKENS * DIM, kind)
            r.update(ms_served=time_ms(lambda: tm.maxsim_pallas_int8mxu_tm(*served, docs_tm, scales_tm), reps=3),
                     plain_ms_served=time_ms(lambda: tm.maxsim_pallas_int8mxu_tm_plain(*served, docs_tm, scales_tm),
                                             reps=2),
                     bound_ms_served=sb["bound_ms"], bound_by_served=sb["bound_by"], max_abs_err=errs[name])
            log(f"  {name} at the served shape B=8 Nq={SERVED_TOKENS}: kernel {r['ms_served']:.3f} ms, plain "
                f"{r['plain_ms_served']:.3f} ms, bound {r['bound_ms_served']:.4f} ms ({r['bound_by_served']}), "
                f"bit-equal to K3")
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, B=8 kernel "
            f"{r['ms_b8']:.3f} ms, plain {r['plain_ms_b8']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"B=8 bound {r['bound_ms_b8']:.4f} ms ({r['bound_by_b8']}), max_abs_err {r['max_abs_err']:.3g}")
    del docs_tm, scales_tm, bdocs_tm, out
    torch.cuda.empty_cache()

    k11 = {case: k11_case(qq, kk, vv, seg, causal, flash_out[case])
           for case, (qq, kk, vv, seg, causal) in flash_in.items()}
    for case, r in k11.items():
        log(f"  K11 {case} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"{library_note(r)}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3g} ({r['limit_share']:.0%} of the tolerance by row RMS, "
            f"{r['limit_share_one_rms']:.0%} by one RMS)")
    results["flash_seqmajor"] = dict(k11["colqwen2_vision"], max_abs_err=max(r["max_abs_err"] for r in k11.values()),
                                     **{case: r for case, r in k11.items() if case != "colqwen2_vision"})
    del flash_in, flash_out
    torch.cuda.empty_cache()
    log(f"  launches over the entry-point calls {launches}")
    return launches, results


# -- phase 3 -------------------------------------------------------------------

INDEX_DOCS = 65_536
QUERIES = [
    "quarterly revenue report for the northern region",
    "organisational chart of the engineering division",
    "safety instructions for the chemical laboratory",
    "annual rainfall measured at coastal weather stations",
    "patent claims describing a folding bicycle frame",
    "menu prices of the downtown italian restaurant",
    "timetable of regional trains on weekend mornings",
    "clinical trial results for the new vaccine dose",
]
PLANTED = [int(i) for i in np.linspace(100, INDEX_DOCS - 100, len(QUERIES))]
SERVE_RTOL = 1e-3  # /search_text vs encode + /search: same bf16 batch, sums in another order


class WordTokenizer:
    """Whitespace tokenizer with PaliGemma's pinned special tokens; other
    words hash (crc32) into the ids below the image token. It offers what
    ``ColPaliProcessor`` calls on a tokenizer."""

    pad_token, eos_token, bos_token = "<pad>", "<eos>", "<bos>"

    def __init__(self, image_token_id: int):
        self.image_token_id = image_token_id
        self.special = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "<image>": image_token_id}
        self._split = re.compile("(" + "|".join(re.escape(t) for t in self.special) + ")")

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self.special:
            return self.special[token]
        return 3 + zlib.crc32(token.encode()) % (self.image_token_id - 3)

    def _ids(self, text: str) -> list:
        out = []
        for part in self._split.split(text):
            if part in self.special:
                out.append(self.special[part])
            else:
                out.extend(self.convert_tokens_to_ids(w) for w in part.split())
        return out

    def __call__(self, texts, padding="longest", padding_side="right", add_special_tokens=False,
                 return_tensors="np"):
        if (padding, padding_side, add_special_tokens, return_tensors) != ("longest", "right", False, "np"):
            raise ValueError("WordTokenizer only pads right to the longest text, adds no special "
                             "tokens and returns numpy")
        rows = [self._ids(t) for t in texts]
        width = max(len(r) for r in rows)
        ids = np.zeros((len(rows), width), np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _http(url: str, path: str, payload=None) -> dict:
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise AssertionError(f"{path}: HTTP {resp.status}")
        return json.loads(resp.read())


def _check_ranked(name: str, out: dict, n: int) -> None:
    scores = np.asarray(out["scores"], np.float64)
    if scores.shape[0] != n or not np.isfinite(scores).all():
        raise AssertionError(f"{name}: expected {n} rows of finite scores, got {scores.shape}")
    if (np.diff(scores, axis=1) > 0).any():
        raise AssertionError(f"{name}: scores are not in descending order")


def build_model(device: torch.device):
    """ColPali-3B at full width with seeded random bf16 weights on the card,
    its processor (448 px pages, 1,024 image tokens) and a warmed query
    encoder."""
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.configs import PaliGemmaConfig
    from colpali_tpu_torch.models.paligemma import ColPali
    from colpali_tpu_torch.processors.colpali import ColPaliProcessor
    from colpali_tpu_torch.retrieval.serving import QueryEncoder

    cfg = PaliGemmaConfig()
    t0 = time.perf_counter()
    model = ColPali(cfg, dim=DIM, device=device, dtype=torch.bfloat16)
    hf_init_(model, torch.Generator(device=device).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    processor = ColPaliProcessor(WordTokenizer(cfg.image_token_index))
    encoder = QueryEncoder(model, processor)
    encoder.warmup()
    t, v = cfg.text, cfg.vision
    log(f"model: ColPali-3B, SigLIP {v.num_hidden_layers} x {v.hidden_size} (MLP {v.intermediate_size}, heads "
        f"{v.num_attention_heads} x {v.head_dim}, {v.num_patches} patches), projector {v.hidden_size} -> "
        f"{cfg.projection_dim}, Gemma {t.num_hidden_layers} x {t.hidden_size} (MLP {t.intermediate_size}, heads "
        f"{t.num_attention_heads}/{t.num_key_value_heads} x {t.head_dim}, vocab {t.vocab_size}): "
        f"{n_params / 1e9:.3f} B params bf16, built + query encoder warmed in {time.perf_counter() - t0:.1f} s")
    return model, processor, encoder


def phase_slice(device: torch.device, encoder) -> dict:
    """Drive the text-in served path through its entry points; returns each
    kernel's launch count over the requests."""
    import tempfile
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.retrieval.store import CorpusIndex

    planted_q = encoder.encode(QUERIES)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    docs = torch.randn((INDEX_DOCS, DOC_TOKENS, DIM), generator=gen, device=device)
    docs = (docs / docs.norm(dim=-1, keepdim=True)).cpu().numpy()
    for q, doc_id in zip(planted_q, PLANTED):
        docs[doc_id] = 0.0
        docs[doc_id, : q.shape[0]] = q
    t0 = time.perf_counter()
    built = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
    t_build = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/index.npz"
        built.save(path)
        del built
        index = CorpusIndex.load(path, device=device)
    del docs
    log(f"phase slice (text in): index {index.num_docs} docs x {index.doc_tokens} x {index.dim} int8 + sketch pool "
        f"{index.coarse_pool}, built in {t_build:.1f} s, saved + loaded, nbytes {index.nbytes}")

    files = [f"doc_{i}" for i in range(index.num_docs)]
    httpd = serve.RetrievalServer(("127.0.0.1", 0), serve.make_handler(index, files, encoder=encoder))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        reset_launches()
        health = _http(url, "/healthz")
        if health != {"status": "ok", "num_docs": INDEX_DOCS, "text_in": True}:
            raise AssertionError(f"/healthz: {health}")

        t0 = time.perf_counter()
        one = _http(url, "/search_text", {"queries": QUERIES[:1], "k": 10})  # tiered route
        ms_text_1 = (time.perf_counter() - t0) * 1e3
        _check_ranked("/search_text x1", one, 1)
        if one["doc_ids"][0][0] != PLANTED[0]:
            raise AssertionError(f"tiered: top-1 {one['doc_ids'][0][0]} != planted {PLANTED[0]}")

        t0 = time.perf_counter()
        text = _http(url, "/search_text", {"queries": QUERIES, "k": 10})  # exact route (8 > 4)
        ms_text_8 = (time.perf_counter() - t0) * 1e3
        _check_ranked("/search_text x8", text, len(QUERIES))
        top1 = [row[0] for row in text["doc_ids"]]
        if top1 != PLANTED:
            raise AssertionError(f"exact: top-1 {top1} != planted {PLANTED}")

        t0 = time.perf_counter()
        embs = encoder.encode(QUERIES)
        ms_encode = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        emb = _http(url, "/search", {"embeddings": [e.tolist() for e in embs], "k": 10, "mode": "exact"})
        ms_search_8 = (time.perf_counter() - t0) * 1e3
        _check_ranked("/search", emb, len(QUERIES))
        if emb["doc_ids"] != text["doc_ids"]:
            raise AssertionError("/search_text and encode + /search return different ids")
        np.testing.assert_allclose(text["scores"], emb["scores"], rtol=SERVE_RTOL)

        tune = _http(url, "/tune", {"embeddings": [e.tolist() for e in embs], "k": 10})
        if not (0.0 <= tune["recall"] <= 1.0 and tune["candidates"] >= 64):
            raise AssertionError(f"/tune: {tune}")
        metrics = _http(url, "/metrics")
        launches = read_launches("text slice")
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"  served: /search_text x1 (tiered) {ms_text_1:.1f} ms, x8 (exact) {ms_text_8:.1f} ms; "
        f"encode x8 {ms_encode:.1f} ms; /search x8 (exact) {ms_search_8:.1f} ms; "
        f"/tune -> {tune}; metrics p50 {metrics.get('search_ms_p50')} ms; launches {launches}")
    return launches


# -- phase 4 -------------------------------------------------------------------

PAGES = 32  # four batches of 8
PAGE_HW = (1650, 1275)  # a US-letter page at 150 dpi, height x width
PAGE_BATCH = 8
PAGE_INDEX_DOCS = 8_192
PAGE_DOC_TOKENS = 1_040  # 1,024 image tokens + the prompt's 5, rounded up to 16
PLANTED_PAGES = 8
PAGE_QUERY_TOKENS = 32
# K6 vs plain, element by element on valid rows: rtol is two bf16 ulps (both round the output; the kernel
# rounds unnormalized probabilities, the plain version normalized ones); atol is 2% of the plain output's
# RMS, which random q, k and v put near sqrt(e / S): 0.05 at S = 1,024, far below 1
K6_RTOL, K6_ATOL_RMS = 1.6e-2, 2e-2
# K6 route vs plain route through 45 bf16 layers of random weights, per token: about 3x the gaps measured on
# the H100 (mean cos 0.99935, min cos 0.99856, max abs 0.0173 over a batch of 8 pages)
FORWARD_COS_MEAN, FORWARD_COS_MIN, FORWARD_ATOL = 0.998, 0.995, 0.05
PAGE_SERVE_RTOL = 1e-3


def k6_shapes(model, processor, encoder) -> dict:
    """K6's shapes on the path, ``(B, S, H, Hkv, D, lengths)``: SigLIP over
    a batch of pages, Gemma over the pages' prompts, and Gemma over QUERIES
    as the query encoder pads them (``lengths`` right-pads each row)."""
    v, t = model.config.vision, model.config.text
    page = processor._tokenize([processor._expand_image_prompt(processor.visual_prompt_prefix)])
    feed, _ = encoder._pad_static(processor.process_queries(QUERIES))
    lengths = [int(n) for n in feed["attention_mask"].sum(axis=1)]
    gemma = (t.num_attention_heads, t.num_key_value_heads, t.head_dim)
    return {"siglip": (PAGE_BATCH, v.num_patches, v.num_attention_heads, v.num_attention_heads, v.head_dim, None),
            "gemma_page": (PAGE_BATCH, page["input_ids"].shape[1], *gemma, None),
            "gemma_query": (len(lengths), feed["input_ids"].shape[1], *gemma, lengths)}


def k6_case(gen: torch.Generator, device: torch.device, b: int, s: int, h: int, hkv: int, d: int,
            lengths, seg: torch.Tensor = None, causal: bool = False, label: str = "",
            kv_seg: torch.Tensor = None) -> dict:
    """K6 against its plain version (valid rows) and beside SDPA with a
    boolean mask, at one shape; ``lengths`` right-pads each row, or ``seg``
    gives the segment ids (valid rows: ids >= 1 where ids are 0/1, >= 0 where
    pad is -1, as Qwen2.5's window ids), and ``kv_seg`` the keys' own ids
    (the key-padding mask: every row is held). A second call must give the
    same bits."""
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=device).to(torch.bfloat16) for n in (h, hkv, hkv))
    if seg is None:
        seg = torch.ones((b, s), dtype=torch.int32, device=device)
        if lengths is not None:
            seg = (torch.arange(s, device=device)[None] < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
    scale = d**-0.5
    keys = {} if kv_seg is None else {"kv_segments": kv_seg}
    rows = seg >= 0 if bool((seg < 0).any()) else seg.bool()
    out = fa.flash_attention(q, k, v, seg, scale, causal, **keys)
    if not torch.equal(out, fa.flash_attention(q, k, v, seg, scale, causal, **keys)):
        raise AssertionError(f"K6 B={b} S={s} H={h}/{hkv} D={d}{label}: two calls differ")
    got = out[rows].float()
    want = fa.flash_attention_plain(q, k, v, seg, scale, causal, **keys)[rows].float()
    atol = K6_ATOL_RMS * want.pow(2).mean().sqrt().item()
    err = (got - want).abs()
    if causal:  # K11's rule: the RMS per query row (the first rows under a causal mask see few keys)
        atol_rows = K6_ATOL_RMS * want.pow(2).mean(dim=(1, 2), keepdim=True).sqrt()
        limit_share = (err / (atol_rows + K6_RTOL * want.abs())).max().item()
        if limit_share > 1.0:
            raise AssertionError(f"K6 causal B={b} S={s} H={h}/{hkv} D={d}{label} vs plain: {limit_share:.2f} of the "
                                 "tolerance by row RMS")
    else:
        torch.testing.assert_close(got, want, rtol=K6_RTOL, atol=atol)
        limit_share = (err / (atol + K6_RTOL * want.abs())).max().item()  # of the tolerance, at the worst element
    allowed = seg[:, :, None] == (seg if kv_seg is None else kv_seg)[:, None, :]
    if causal:
        allowed &= torch.ones((s, s), dtype=torch.bool, device=device).tril()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa(mask):
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=h != hkv)

    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * seg.numel() * (1 if kv_seg is None else 2)
    pairs = allowed.sum().item()  # (query, key) pairs that this data attends
    r = dict(ms=time_ms(lambda: fa.flash_attention(q, k, v, seg, scale, causal, **keys)),
             device_ms=device_ms(lambda: fa.flash_attention(q, k, v, seg, scale, causal, **keys)),
             graph_ms=graph_ms(lambda: fa.flash_attention(q, k, v, seg, scale, causal, **keys)),
             plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, seg, scale, causal, **keys), reps=2),
             library_ms=time_ms(sdpa(allowed[:, None])), max_abs_err=err.max().item(), atol=atol,
             limit_share=limit_share, **bound(nbytes, 4 * pairs * h * d, "bf16"),
             shape=f"B={b} S={s} H={h} Hkv={hkv} D={d}" + ("" if lengths is None else " key padding") + label)
    if lengths is None and kv_seg is None and not causal and bool((seg == seg[0, 0]).all()):
        r["library_unmasked_ms"] = time_ms(sdpa(None))  # one segment: SDPA without a mask (its flash backend)
    if pairs < b * s * s:  # masked work: the bound over every pair, which the kernel's tiles still visit
        r["bound_ms_all_pairs"] = bound(nbytes, 4 * b * s * s * h * d, "bf16")["bound_ms"]
    return dict(r, **rates(4 * pairs * h * d, r))


def rates(ops: float, r: dict) -> dict:
    """Operations a second and the share of the bound that the kernel's
    time ``r['ms']`` reaches."""
    return dict(tflops=ops / r["ms"] / 1e9, bound_share=r["bound_ms"] / r["ms"])


def library_note(r: dict) -> str:
    """The yardsticks and rates of one K6/K11 case, for its log line."""
    unmasked = f", SDPA without a mask {r['library_unmasked_ms']:.3f} ms" if "library_unmasked_ms" in r else ""
    masked = f", SDPA with a boolean mask {r['library_masked_ms']:.3f} ms" if "library_masked_ms" in r else ""
    device = "" if "device_ms" not in r else "device not measured (profiler), " if r["device_ms"] is None else \
        f"device {r['device_ms']:.4f} ms (profiler), "
    device += f"from a CUDA graph {r['graph_ms']:.4f} ms, " if "graph_ms" in r else ""
    return (f"{device}SDPA {r['library_ms']:.3f} ms{unmasked}{masked}, "
            f"{r['tflops']:.0f} TFLOP/s, {r['bound_share']:.1%} of the bound")


def make_pages(n: int, seed: int) -> list:
    """Seeded uint8 RGB pages of noise at a scanned page's size: every patch
    differs, so every page token does."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(*PAGE_HW, 3), dtype=np.uint8) for _ in range(n)]


@contextlib.contextmanager
def plain_route():
    """The model kernels' plain versions patched in for a comparison (their
    launches are not counted): K6's and Q2's."""
    with mock.patch.object(fa, "flash_attention", fa.flash_attention_plain), \
            mock.patch.object(gdr, "chunk_gated_delta_rule", gdr.chunk_gated_delta_rule_plain):
        yield


def forward_check(name: str, embed) -> dict:
    """``embed()`` through the kernel route and through the plain route
    (:func:`plain_route`, for the comparison only), token by token."""
    kernel = embed()
    with plain_route():
        plain = embed()
    a, b = np.concatenate(kernel), np.concatenate(plain)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    out = dict(tokens=len(a), mean_cos=float(cos.mean()), min_cos=float(cos.min()), max_abs=float(np.abs(a - b).max()))
    if not (np.isfinite(a).all() and out["mean_cos"] >= FORWARD_COS_MEAN and out["min_cos"] >= FORWARD_COS_MIN
            and out["max_abs"] <= FORWARD_ATOL):
        raise AssertionError(f"{name}: K6 route vs plain route {out}, limits mean cos >= {FORWARD_COS_MEAN}, "
                             f"min cos >= {FORWARD_COS_MIN}, max abs <= {FORWARD_ATOL}")
    log(f"  {name}, K6 route vs plain route, {out['tokens']} tokens: mean cos {out['mean_cos']:.6f}, min cos "
        f"{out['min_cos']:.6f}, max abs {out['max_abs']:.4g} (limits {FORWARD_COS_MEAN}, {FORWARD_COS_MIN}, "
        f"{FORWARD_ATOL})")
    return out


def kernel_breakdown(label: str, fn) -> dict:
    """``torch.profiler`` over one call of ``fn`` (after one warm-up call):
    device time by kernel class, K6's forward and backward apart, and the
    device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
    total = sum(kernels.values())
    if total == 0.0:
        log(f"  profile: {label} {wall_ms:.1f} ms wall; the profiler saw no device time")
        return dict(wall_ms=wall_ms)
    classes = {"K6 forward": 0.0, "K6 backward": 0.0, "Q2": 0.0, "Q2 backward": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        if "flash_fwd_kernel" in name:
            classes["K6 forward"] += ms
        elif "gated_delta_rule_bwd" in name:
            classes["Q2 backward"] += ms
        elif "gated_delta_rule" in name:
            classes["Q2"] += ms
        elif "flash_bwd" in name or "delta_kernel" in name:
            classes["K6 backward"] += ms
        elif any(t in name.lower() for t in ("gemm", "cutlass", "nvjet", "xmma", "matmul")):
            classes["matmul"] += ms
        else:
            classes["other"] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    log(f"  profile: {label} {wall_ms:.1f} ms wall, {total:.1f} ms of kernels "
        f"(device idle {max(0.0, 1 - total / wall_ms):.1%}); "
        + ", ".join(f"{k} {v:.1f} ms ({v / total:.1%})" for k, v in classes.items()))
    for name, ms in top:
        log(f"    {ms:8.2f} ms  {name[:110]}")
    return dict(wall_ms=wall_ms, kernels_ms=total, **{k: v for k, v in classes.items()})


def profile_page_forward(model, processor, device: torch.device) -> dict:
    """:func:`kernel_breakdown` of one forward of a batch of pages."""
    tok = processor._tokenize([processor._expand_image_prompt(processor.visual_prompt_prefix)] * PAGE_BATCH)
    ids = torch.from_numpy(tok["input_ids"]).to(device)
    att = torch.from_numpy(tok["attention_mask"]).to(device)
    size = processor.image_size
    pixels = torch.rand((PAGE_BATCH, size, size, 3), generator=torch.Generator(device=device).manual_seed(SEED),
                        device=device) * 2 - 1
    with torch.inference_mode():
        return kernel_breakdown(f"one forward of {PAGE_BATCH} pages", lambda: model(ids, att, pixels))


def bf16_index_check(device: torch.device, docs: list, planted: list, queries: list, q: torch.Tensor) -> tuple:
    """The default dtype on the two-tier route: a bf16 index of the page
    index's docs with the sign-sketch prefilter, searched by K1 and K2 over
    a bf16 store; each planted page at rank 1, one query per search. Then
    K2 over bf16 against its plain version at the served shape (``q``: 4
    queries padded to SERVED_TOKENS) and timed. Returns the launches over
    the searches and the timing."""
    from colpali_tpu_torch.retrieval.store import CorpusIndex

    t0 = time.perf_counter()
    index = CorpusIndex(docs, dtype="bf16", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
    t_build = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    top = [int(index.search([e], k=10)[1][0, 0]) for e in queries]
    search_ms = (time.perf_counter() - t0) * 1e3 / len(queries)
    launches = read_launches("bf16 two-tier index", BF16_INDEX_KERNELS)
    if top != planted:
        raise AssertionError(f"bf16 index, tiered route: rank 1 {top}, planted {planted}")
    qw, qv = binarize_words(q)
    _, cand = top_k(binary_maxsim_tiled(qw, qv, index._bwords, DIM)[:, : index.num_docs], CANDIDATES)
    got = gather_rerank_tiled(q, index._store, None, cand)
    want = gather_rerank_plain(q, index._store, None, cand)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    q1, cand1 = q[:1], cand[:1].contiguous()
    nq = q.shape[1]
    r = dict(ms=time_ms(lambda: gather_rerank_tiled(q1, index._store, None, cand1)),
             plain_ms=time_ms(lambda: gather_rerank_plain(q1, index._store, None, cand1), 2),
             max_abs_err=(got - want).abs().max().item(), library_ms=None,
             **k2_bound(1, nq, CANDIDATES, PAGE_DOC_TOKENS, DIM, 2),
             ms_b4=time_ms(lambda: gather_rerank_tiled(q, index._store, None, cand)),
             ms_graph=graph_ms(lambda: gather_rerank_tiled(q1, index._store, None, cand1)),
             ms_b4_graph=graph_ms(lambda: gather_rerank_tiled(q, index._store, None, cand)),
             bound_ms_b4=k2_bound(4, nq, CANDIDATES, PAGE_DOC_TOKENS, DIM, 2)["bound_ms"],
             shape=f"B=1 (and B=4) Nq={nq} c={CANDIDATES} Np={PAGE_DOC_TOKENS} bf16 store")
    log(f"  bf16 index: {index.num_docs} docs x {index.doc_tokens} x {index.dim} bf16 + sketch pool "
        f"{index.coarse_pool} ({index.nbytes} bytes), built on the host in {t_build:.1f} s; each of "
        f"{len(planted)} pages at rank 1 on the tiered route ({search_ms:.1f} ms a search); launches {launches}")
    log(f"  gather_rerank_bf16 [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), fp32 CUDA-core bound {r['bound_ms_fp32']:.4f} ms, from a CUDA "
        f"graph {r['ms_graph']:.4f} ms, B=4 kernel {r['ms_b4']:.3f} ms (graph {r['ms_b4_graph']:.4f}), "
        f"bound {r['bound_ms_b4']:.4f} ms, max_abs_err {r['max_abs_err']:.3g}")
    del index
    torch.cuda.empty_cache()
    return launches, r


def served_queries(embs: list, device: torch.device) -> torch.Tensor:
    """Query embeddings as a served sweep takes them: (B, SERVED_TOKENS, D) fp32, zero-padded."""
    q = torch.zeros((len(embs), SERVED_TOKENS, embs[0].shape[1]), device=device)
    for i, e in enumerate(embs):
        q[i, : e.shape[0]] = torch.from_numpy(e)
    return q


def hold_k123(index, q: torch.Tensor) -> dict:
    """K1 (bit for bit), K2 and K3 (at RTOL/ATOL) against their plain
    versions on ``index``'s tensors: the coarse pass over queries ``q``, the
    rerank of its top CANDIDATES, and the exact int8 sweep over ``q`` twice
    (B = 2 len(q)). Returns each kernel's max abs error and the operands."""
    qw, qv = binarize_words(q)
    d = q.shape[-1]
    coarse = binary_maxsim_tiled(qw, qv, index._bwords, d)
    k1_err = (coarse - binary_maxsim_tiled_plain(qw, qv, index._bwords, d)).abs().max().item()
    if k1_err != 0.0:
        raise AssertionError(f"K1 differs from its plain version at Np={index.doc_tokens}: {k1_err}")
    _, cand = top_k(coarse[:, : index.num_docs], CANDIDATES)
    got = gather_rerank_tiled(q, index._store, index._scales, cand)
    want = gather_rerank_plain(q, index._store, index._scales, cand)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    k2_err = (got - want).abs().max().item()
    qi, qsc = quantize_per_token(q.repeat(2, 1, 1))
    got = maxsim_int8mxu_tiled(qi, qsc, index._store, index._scales)
    want = maxsim_int8mxu_tiled_plain(qi, qsc, index._store, index._scales)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    return dict(k1_err=k1_err, k2_err=k2_err, k3_err=(got - want).abs().max().item(), qw=qw, qv=qv, cand=cand,
                qi=qi, qsc=qsc)


def phase_pages(device: torch.device, model, processor, encoder) -> tuple:
    """Drive the page-embedding path: pages -> embeddings -> a served
    two-tier index. Returns the launches over the path, K6's timings, K1-K3's
    timings at full-page length, and pages/min with the forward check."""
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.retrieval.ingest import embed_pages_fused
    from colpali_tpu_torch.retrieval.store import CorpusIndex

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    k6 = {case: k6_case(gen, device, *shape) for case, shape in k6_shapes(model, processor, encoder).items()}
    for case, r in k6.items():
        log(f"phase pages: K6 {case} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"{library_note(r)}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"max_abs_err {r['max_abs_err']:.3g} (atol {r['atol']:.3g}, {r['limit_share']:.0%} of the tolerance)")

    pages = make_pages(PAGES, SEED + 2)
    fwd = dict(pages=forward_check(f"page forward ({PAGE_BATCH} pages)", lambda: embed_pages_fused(
                   model, processor, pages[:PAGE_BATCH], transport="yuv420", batch_size=PAGE_BATCH)),
               queries=forward_check(f"query forward ({len(QUERIES)} queries)", lambda: encoder.encode(QUERIES)))

    reset_launches()
    t0 = time.perf_counter()
    embs = embed_pages_fused(model, processor, pages, transport="yuv420", batch_size=PAGE_BATCH)
    t_embed = time.perf_counter() - t0
    n_tok = embs[0].shape[0]
    for e in embs:
        norms = np.linalg.norm(e, axis=-1)
        if e.shape != (n_tok, DIM) or not np.isfinite(e).all() or np.abs(norms - 1).max() > 1e-2:
            raise AssertionError(f"page embedding {e.shape}, norms {norms.min()}..{norms.max()}")
    log(f"  embedded {PAGES} pages of {PAGE_HW[1]} x {PAGE_HW[0]} (yuv420, batch {PAGE_BATCH}) in {t_embed:.2f} s: "
        f"{PAGES / t_embed * 60:.0f} pages/min, {n_tok} tokens each")

    t0 = time.perf_counter()
    n_fill = PAGE_INDEX_DOCS - PAGES
    fill = np.empty((n_fill, PAGE_DOC_TOKENS, DIM), np.float32)
    for s0 in range(0, n_fill, 1024):
        x = torch.randn((min(1024, n_fill - s0), PAGE_DOC_TOKENS, DIM), generator=gen, device=device)
        fill[s0 : s0 + x.shape[0]] = (x / x.norm(dim=-1, keepdim=True)).cpu().numpy()
    page_ids = [int(i) for i in np.linspace(37, PAGE_INDEX_DOCS - 37, PAGES)]
    docs, rows = [], iter(fill)
    for doc_id in range(PAGE_INDEX_DOCS):
        docs.append(embs[page_ids.index(doc_id)] if doc_id in page_ids else next(rows))
    t_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
    t_build = time.perf_counter() - t0
    del fill, rows  # docs stays for the bf16 index below
    if index.doc_tokens != PAGE_DOC_TOKENS:
        raise AssertionError(f"doc_tokens {index.doc_tokens} != {PAGE_DOC_TOKENS}")
    log(f"  index: {index.num_docs} docs x {index.doc_tokens} x {index.dim} int8 + sketch pool {index.coarse_pool} "
        f"({index.nbytes} bytes), filler made in {t_fill:.1f} s, built on the host in {t_build:.1f} s")

    planted = page_ids[:: PAGES // PLANTED_PAGES][:PLANTED_PAGES]
    queries = [embs[page_ids.index(i)][:PAGE_QUERY_TOKENS] for i in planted]
    files = [f"page_{i}" for i in range(index.num_docs)]
    httpd = serve.RetrievalServer(("127.0.0.1", 0), serve.make_handler(index, files, encoder=encoder))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        tiered_ms = []
        tiered = []
        for q in queries:  # one query per request: the two-tier route
            t0 = time.perf_counter()
            out = _http(url, "/search", {"embeddings": [q.tolist()], "k": 10})
            tiered_ms.append((time.perf_counter() - t0) * 1e3)
            _check_ranked("/search x1", out, 1)
            tiered.append(out)
        t0 = time.perf_counter()
        exact = _http(url, "/search", {"embeddings": [q.tolist() for q in queries], "k": 10})  # 8 > 4: exact
        exact_ms = (time.perf_counter() - t0) * 1e3
        _check_ranked("/search x8", exact, len(queries))
        top_tiered = [out["doc_ids"][0][0] for out in tiered]
        top_exact = [row[0] for row in exact["doc_ids"]]
        if top_tiered != planted or top_exact != planted:
            raise AssertionError(f"pages at rank 1: tiered {top_tiered}, exact {top_exact}, planted {planted}")
        for i, out in enumerate(tiered):
            np.testing.assert_allclose(out["scores"][0][0], exact["scores"][i][0], rtol=PAGE_SERVE_RTOL)
        text = _http(url, "/search_text", {"queries": QUERIES[:2], "k": 5})
        _check_ranked("/search_text x2", text, 2)
        launches = read_launches("page slice")
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"  served: each of {PLANTED_PAGES} pages at rank 1 on the tiered route (/search x1, median "
        f"{np.median(tiered_ms):.1f} ms) and the exact route (/search x8, {exact_ms:.1f} ms); /search_text "
        f"answered; launches {launches}")

    # K1, K2 and K3 against their plain versions at Np = 1,040 on the page index
    q = served_queries(queries[:4], device)
    held = hold_k123(index, q)
    qw, qv, cand, qi, qsc = (held[k] for k in ("qw", "qv", "cand", "qi", "qsc"))
    k1_err, k2_err, k3_err = (held[k] for k in ("k1_err", "k2_err", "k3_err"))

    c, nq, npc, w = index.padded_docs, SERVED_TOKENS, PAGE_DOC_TOKENS // COARSE_POOL, DIM // 32
    q1, qw1, qv1, cand1 = q[:1], qw[:1].contiguous(), qv[:1].contiguous(), cand[:1].contiguous()
    k1_b4 = k1_bound(4, nq, c, npc, w)
    page = {
        "binary_maxsim": dict(ms=time_ms(lambda: binary_maxsim_tiled(qw1, qv1, index._bwords, DIM)),
                              plain_ms=time_ms(lambda: binary_maxsim_tiled_plain(qw1, qv1, index._bwords, DIM), 2),
                              max_abs_err=k1_err,
                              **k1_bound(1, nq, c, npc, w),
                              ms_b4=time_ms(lambda: binary_maxsim_tiled(qw, qv, index._bwords, DIM)),
                              ms_graph=graph_ms(lambda: binary_maxsim_tiled(qw1, qv1, index._bwords, DIM)),
                              ms_b4_graph=graph_ms(lambda: binary_maxsim_tiled(qw, qv, index._bwords, DIM)),
                              bound_ms_b4=k1_b4["bound_ms"], bound_by_b4=k1_b4["bound_by"],
                              bound_ms_b4_int8_proxy=k1_b4["bound_ms_int8_proxy"]),
        "gather_rerank": dict(ms=time_ms(lambda: gather_rerank_tiled(q1, index._store, index._scales, cand1)),
                              plain_ms=time_ms(lambda: gather_rerank_plain(q1, index._store, index._scales, cand1), 2),
                              max_abs_err=k2_err,
                              **k2_bound(1, nq, CANDIDATES, PAGE_DOC_TOKENS, DIM, 1),
                              ms_b4=time_ms(lambda: gather_rerank_tiled(q, index._store, index._scales, cand)),
                              ms_graph=graph_ms(lambda: gather_rerank_tiled(q1, index._store, index._scales, cand1)),
                              ms_b4_graph=graph_ms(lambda: gather_rerank_tiled(q, index._store, index._scales, cand)),
                              bound_ms_b4=k2_bound(4, nq, CANDIDATES, PAGE_DOC_TOKENS, DIM, 1)["bound_ms"]),
        "maxsim_int8": dict(ms=time_ms(lambda: maxsim_int8mxu_tiled(qi, qsc, index._store, index._scales)),
                            plain_ms=time_ms(lambda: maxsim_int8mxu_tiled_plain(qi, qsc, index._store,
                                                                                index._scales), 2),
                            max_abs_err=k3_err,
                            **bound(c * PAGE_DOC_TOKENS * (DIM + 4) + 8 * nq * (DIM + 4) + 8 * c * 4,
                                    2 * 8 * nq * c * PAGE_DOC_TOKENS * DIM, "int8")),
    }
    shapes = {"binary_maxsim": f"B=1 Nq={nq} W={w} Npc={npc} C={c}",
              "gather_rerank": f"B=1 Nq={nq} c={CANDIDATES} Np={PAGE_DOC_TOKENS}",
              "maxsim_int8": f"B=8 Nq={nq} Np={PAGE_DOC_TOKENS} C={c}"}
    for name, r in page.items():
        extra = (f", from a CUDA graph {r['ms_graph']:.4f} ms, B=4 kernel {r['ms_b4']:.3f} ms (graph "
                 f"{r['ms_b4_graph']:.4f}), bound {r['bound_ms_b4']:.4f} ms" if "ms_b4" in r else "")
        if "popcount_floor_ms" in r:
            extra += (f" ({r['bound_by_b4']}), int8 proxy {r['bound_ms_int8_proxy']:.4f} ms (B=4 "
                      f"{r['bound_ms_b4_int8_proxy']:.4f}), CUDA-core popcount floor {r['popcount_floor_ms']:.4f} ms, "
                      f"single-bit products {r['bound_ms_b1']:.4f} ms")
        if "bound_ms_fp32" in r:
            extra += f", fp32 CUDA-core bound {r['bound_ms_fp32']:.4f} ms"
        log(f"  {name} at Np={PAGE_DOC_TOKENS} [{shapes[name]}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}, max_abs_err {r['max_abs_err']:.3g}")
    page["binary_maxsim"]["tiered_stages"] = {
        f"B={b}": tiered_stages(f"{index.num_docs} docs x {PAGE_DOC_TOKENS} tokens, B={b} Nq={nq}", index,
                                q[:b].cpu().numpy()) for b in (1, 4)}
    del index
    torch.cuda.empty_cache()
    bf16 = bf16_index_check(device, docs, planted, queries, q)
    del docs
    profile = profile_page_forward(model, processor, device)
    return launches, k6, page, dict(pages_per_min=PAGES / t_embed * 60, forward_check=fwd, page_profile=profile), bf16


# -- phase 5 -------------------------------------------------------------------

TRAIN_PAGES = 32
EVAL_PAGES = 128
TRAIN_BATCH = 8
TRAIN_STEPS = 4
RESUME_AT = 2
# six steps on one repeated batch at the recipe's rate. At lr 1e-3 Adam's first, sign-like updates move all
# 39 M adapter weights by 1e-3 at once and overshoot on this model (0.716 -> 0.753 -> 0.737 -> 0.721 ... on the
# H100); at 5e-5 the loss fell at every step (0.7158 -> 0.6995)
DIRECTION_STEPS, DIRECTION_LR = 6, 5e-5
# K6 backward, element by element by the forward's rule, against autograd through the plain version on the
# inputs upcast to fp32 (the exact gradient of the same bf16 q, k, v and dO). The plain version in bf16 rounds
# the probabilities and dP to bf16 itself and sits at 40-80% of this tolerance from the fp32 gradient, so the
# kernel against it (two independent roundings) ranged 0.6-1.4 over seeds on the H100; its share is printed.
# The kernels are also held, by the same rule, to flash_attention_backward_plain: the same roundings (Delta from
# the forward's bf16 output, P and dS to bf16) written out in plain PyTorch, which differs only in sum order
K6_BWD_RTOL, K6_BWD_ATOL_RMS = K6_RTOL, K6_ATOL_RMS
# one train step through the kernels vs through the plain route (K6 swapped for its plain version), from the
# same state, batch and dropout masks: the loss relative, and the cosine of the flattened adapter gradients.
# The recipe's loss picks the hardest negative page and, per query token, the best page token. Where the two
# routes pick differently the gradient flows through other tokens and turns, so on the recipe loss only the
# value is held; the picks that differ are counted and the cosine printed. The gradient is held on the same
# loss with the picks frozen to the plain route's (the function the recipe loss is around that point), and on
# a smooth probe (InfoNCE over the smooth max, no argmax anywhere): both carry the backward through all 18
# layers. Limits at about 3x the gaps of the first run on the H100 (loss 3.6e-4 and 3.5e-3 relative; 1 - cosine
# 1.3e-3 with frozen picks, where each query token's gradient reaches one page token, and 1.2e-4 on the smooth
# probe, which averages over all of them). In that run the routes picked another hardest negative for 1 of 8
# queries and another best page token for 28 of 224 query tokens, and the recipe loss's cosine was 0.896
PLAIN_ROUTE_LOSS_RTOL, PLAIN_ROUTE_FROZEN_GRAD_COS, PLAIN_ROUTE_SMOOTH_GRAD_COS = 1e-2, 0.996, 0.9996
# K6's backward against the exact gradient at a model's shapes, per query row (phase 11's text case): the card-only
# tests' rule for the kernels against autograd through the plain version in fp32 (tests/test_torch_cuda.py)
K6_BWD_ORACLE_ATOL_RMS = 6e-2
RESUME_LOSS_RTOL = 1e-5  # a resumed run repeats the loss of step 3: every kernel sums in a fixed order


def k6_bwd_case(gen: torch.Generator, device: torch.device, b: int, s: int, h: int, hkv: int, d: int,
                lengths, alone: bool = False) -> dict:
    """K6's backward kernels against autograd through the plain version on
    the inputs upcast to fp32, with the same dO (valid rows), timed beside
    the plain version's backward in bf16 and the backward of SDPA with the
    equivalent mask. ``alone`` puts token 3 of row 0 in a segment of its
    own: its only key is itself, so its probability is 1 and its dq zero."""
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=device).to(torch.bfloat16).requires_grad_()
               for n in (h, hkv, hkv))
    d_out = torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16)
    seg = torch.ones((b, s), dtype=torch.int32, device=device)
    if lengths is not None:
        seg = (torch.arange(s, device=device)[None] < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
    if alone:
        seg[0, 3] = 7
    d_out = d_out * (seg != 0)[:, :, None, None].to(d_out.dtype)  # pad rows are masked downstream: no gradient
    scale = d**-0.5
    before = fa.FLASH_ATTENTION_BWD.launches
    out = fa.flash_attention(q, k, v, seg, scale)
    got = torch.autograd.grad(out, (q, k, v), d_out)
    if fa.FLASH_ATTENTION_BWD.launches != before + 1:
        raise AssertionError("autograd did not reach the backward kernels")
    plain_out = fa.flash_attention_plain(q, k, v, seg, scale)
    plain = torch.autograd.grad(plain_out, (q, k, v), d_out, retain_graph=True)
    q32, k32, v32 = (x.detach().float().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(fa.flash_attention_plain(q32, k32, v32, seg, scale), (q32, k32, v32), d_out.float())
    del q32, k32, v32
    with torch.no_grad():  # the backward in plain PyTorch with the kernels' roundings, from the forward kernel's output
        fwd_out, lse = fa._forward_cuda(q, k, v, seg, scale, False, True)
        rounded = fa.flash_attention_backward_plain(q, k, v, seg, d_out, scale, out=fwd_out, lse=lse)
    rows = seg != 0

    def share(x, w, atol):  # of the tolerance, at the worst element
        return ((x - w).abs() / (atol + K6_BWD_RTOL * w.abs())).max().item()

    shares, plain_shares, rounded_shares, errs = {}, {}, {}, {}
    for name, g, p, r, w in zip(("dq", "dk", "dv"), got, plain, rounded, want):
        g, p, r, w = g[rows].float(), p[rows].float(), r[rows].float(), w[rows]
        if not torch.isfinite(g).all():
            raise AssertionError(f"K6 backward: {name} has non-finite values")
        atol = K6_BWD_ATOL_RMS * w.pow(2).mean().sqrt().item()
        shares[name], plain_shares[name], rounded_shares[name] = share(g, w, atol), share(p, w, atol), share(g, r, atol)
        errs[name] = (g - w).abs().max().item()
        torch.testing.assert_close(g, r, rtol=K6_BWD_RTOL, atol=atol,
                                   msg=lambda m: f"K6 backward {name} vs the same roundings in plain PyTorch: {m}")
        torch.testing.assert_close(g, w, rtol=K6_BWD_RTOL, atol=atol, msg=lambda m: f"K6 backward {name}: {m}")
        if alone and name == "dq" and got[0][0, 3].float().abs().max().item() > atol:
            raise AssertionError("K6 backward: a token alone in its segment must get dq = 0")
    del want, plain, rounded
    r = k6_bwd_timing(q, k, v, seg, d_out, fwd_out, lse, scale, False, plain_out)
    return dict(r, max_abs_err=max(errs.values()), limit_share=max(shares.values()), shares=shares,
                plain_shares=plain_shares, rounded_shares=rounded_shares,
                shape=f"B={b} S={s} H={h} Hkv={hkv} D={d}" + (" key padding" if lengths is not None else "")
                      + (" + a token alone in its segment" if alone else ""))


def k6_bwd_timing(q, k, v, seg, d_out, fwd_out, lse, scale: float, causal: bool, plain_out,
                  kv_seg: torch.Tensor = None) -> dict:
    """K6's backward kernels timed by CUDA events beside the plain version's
    backward (autograd through ``plain_out``), SDPA's backward with the
    equivalent boolean mask (and without one where the segments are all
    one) and the bound: the larger of the bytes and 2.5x the forward's
    products over the pairs this data attends. ``kv_seg``: the keys' own
    ids."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    with torch.no_grad():
        ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, seg, fwd_out, lse, d_out, scale, causal,
                                                         kv_segments=kv_seg))
    plain_ms = time_ms(lambda: torch.autograd.grad(plain_out, (q, k, v), d_out, retain_graph=True), reps=2)
    allowed = seg[:, :, None] == (seg if kv_seg is None else kv_seg)[:, None, :]
    if causal:
        allowed &= torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    d_out_t = d_out.transpose(1, 2)

    def sdpa_backward(mask):
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=h != hkv)
        return time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), d_out_t, retain_graph=True))

    pairs = allowed.sum().item()
    # q, o, dO, dq; k, v, dk, dv; the ids; the row log-sum-exp
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * seg.numel() * (1 if kv_seg is None else 2) + 4 * b * h * s
    r = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_backward(allowed[:, None]),
             **bound(nbytes, 2.5 * 4 * pairs * h * d, "bf16"))
    if kv_seg is None and not causal and bool((seg == seg[0, 0]).all()):  # one segment: SDPA without a mask
        r["library_unmasked_ms"] = sdpa_backward(None)
    return dict(r, **rates(3.5 * 4 * pairs * h * d, r))  # the kernels' seven products, 3.5x the forward's


def page_dataset(n: int, seed: int, first: int = 0):
    """``n`` seeded noise pages with the queries "synthetic query i"."""
    from colpali_tpu_torch.data.dataset import ColPaliEngineDataset

    pages = make_pages(n, seed)
    return ColPaliEngineDataset([{"query": f"synthetic query {first + i}", "pos_target": page}
                                 for i, page in enumerate(pages)])


def adapter_gradient(state, batch, loss_fn, peft, seed: int):
    """Loss and flattened adapter gradient of one batch at the state's step
    (masks drawn from ``(seed, step)``), without an update."""
    from colpali_tpu_torch.training import trainer

    trainer.begin_step(state, peft, seed)
    loss, q, d = trainer.compute_loss(state.model, batch, loss_fn, False)
    loss.backward()
    flat = torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad).flatten().float() for p in state.params])
    state.optimizer.zero_grad(set_to_none=True)
    return loss.item(), flat, q.detach().float(), d.detach().float()


def route_gap(state, batch, loss_fn, peft) -> tuple:
    """:func:`adapter_gradient` (loss, flattened gradient of what ``state``
    trains, embeddings) through the kernels and through the plain route (K6
    and Q2 and their backwards replaced by their plain versions), from the
    same state, batch and masks, and their gaps."""
    kernel = adapter_gradient(state, batch, loss_fn, peft, SEED)
    with plain_route():
        plain = adapter_gradient(state, batch, loss_fn, peft, SEED)
    a, b = kernel[1].double(), plain[1].double()  # fp64: a cosine over 10^8-10^9 entries
    return kernel, plain, dict(loss_relative=abs(kernel[0] - plain[0]) / abs(plain[0]),
                               grad_cos=(a @ b / (a.norm() * b.norm())).item(),
                               grad_norm_ratio=(a.norm() / b.norm()).item())


def recipe_picks(q: torch.Tensor, d: torch.Tensor):
    """What the gradient of ``ColbertPairwiseCELoss`` flows through, from
    ``q (B, Nq, D)`` and ``d (B, S, D)``: per query its hardest negative page
    ``(B,)``, and per query token the best token of the positive page and of
    that negative ``(B, 2, Nq)``; and which query tokens are not padding."""
    best, tok = torch.einsum("bnd,csd->bcns", q, d).max(dim=3)  # (B, C, Nq)
    valid = q[:, :, 0] != 0
    scores = (best * valid[:, None]).sum(dim=-1)
    rows = torch.arange(q.shape[0], device=q.device)
    scores[rows, rows] = float("-inf")
    neg = scores.argmax(dim=1)
    return neg, torch.stack([tok[rows, rows], tok[rows, neg]], dim=1), valid


def frozen_pairwise_loss(neg: torch.Tensor, tok: torch.Tensor):
    """``ColbertPairwiseCELoss`` with its picks fixed to ``neg`` and ``tok``
    (as :func:`recipe_picks` returns them): no max is taken, so two routes
    differentiate the same smooth function."""
    def loss_fn(q, d):
        q, d = q.float(), d.float()
        rows = torch.arange(q.shape[0], device=q.device)
        lengths = (q[:, :, 0] != 0).sum(dim=1)
        pos = (q * d[rows[:, None], tok[:, 0]]).sum(dim=(1, 2)) / lengths
        hardest = (q * d[neg[:, None], tok[:, 1]]).sum(dim=(1, 2)) / lengths
        return F.softplus(hardest - pos).mean()

    return loss_fn


def timed_steps(state, batch, loss_fn, peft, seed: int, steps: int) -> dict:
    """``steps`` train steps on one batch with CUDA events between forward,
    backward and optimizer (after one step of warm-up); means in ms."""
    from colpali_tpu_torch.training import trainer

    sums = dict(forward=0.0, backward=0.0, optimizer=0.0, wall=0.0)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30  # what earlier phases and the model hold
    for i in range(steps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.begin_step(state, peft, seed)
        ev[0].record()
        loss, _, _ = trainer.compute_loss(state.model, batch, loss_fn, False)
        ev[1].record()
        loss.backward()
        ev[2].record()
        state.apply_gradients()
        ev[3].record()
        torch.cuda.synchronize()
        if i:  # the first step warms up
            sums["wall"] += (time.perf_counter() - t0) * 1e3
            for key, (e0, e1) in zip(("forward", "backward", "optimizer"), zip(ev, ev[1:])):
                sums[key] += e0.elapsed_time(e1)
    out = {k: v / steps for k, v in sums.items()}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["allocated_before_gib"] = before
    return out


def checkpoint_readback(device: torch.device, model, in_memory: dict, loaded: dict, processor) -> dict:
    """The merged export read back: a fresh ColPali-3B built from the same
    config holds ``loaded`` (``load_colpali_params`` of the written
    ``model.safetensors``), another holds the merged state dict as it was
    in memory; their query and page embeddings must be bit-equal. Then a
    ``QueryEncoder`` of the loaded model answers ``/search_text`` behind
    ``make_handler``, each query finding its own embedding at rank 1."""
    import threading

    from colpali_tpu_torch.models.paligemma import ColPali
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.retrieval.store import CorpusIndex
    from colpali_tpu_torch.serve import RetrievalServer, make_handler

    t0 = time.perf_counter()
    models = {}
    for key, state in (("loaded", loaded), ("in_memory", in_memory)):
        m = ColPali(model.config, dim=DIM, device=device, dtype=torch.bfloat16).eval()
        m.load_state_dict(state)
        models[key] = m
    del in_memory, state
    texts = processor.process_queries(QUERIES)
    pages = processor.process_images(make_pages(2, SEED + 11))  # the device resize, on the card
    emb = {}
    with torch.no_grad():
        for key, m in models.items():
            emb[key] = [m(**{k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()})
                        for batch in (texts, pages)]
    for what, a, b in zip(("queries", "pages"), emb["loaded"], emb["in_memory"]):
        if not torch.equal(a, b) or not torch.isfinite(a.float()).all():
            raise AssertionError(f"checkpoint read back: {what} embeddings differ from the in-memory model's by up to "
                                 f"{(a.float() - b.float()).abs().max().item()}")
    del models["in_memory"]
    encoder = QueryEncoder(models["loaded"], processor)
    docs = encoder.encode(QUERIES)
    httpd = RetrievalServer(("127.0.0.1", 0), make_handler(CorpusIndex(docs, device=device), list(QUERIES),
                                                               encoder=encoder))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        out = _http(f"http://127.0.0.1:{httpd.server_address[1]}", "/search_text", {"queries": QUERIES, "k": 1})
    finally:
        httpd.shutdown()
        httpd.server_close()
    _check_ranked("/search_text (read-back checkpoint)", out, len(QUERIES))
    if [row[0] for row in out["doc_ids"]] != list(range(len(QUERIES))):
        raise AssertionError(f"/search_text over the read-back checkpoint: top-1 {out['doc_ids']}")
    r = dict(seconds=time.perf_counter() - t0, query_shape=list(emb["loaded"][0].shape),
             page_shape=list(emb["loaded"][1].shape))
    log(f"  checkpoint read back into a fresh ColPali-3B on the card: query {tuple(emb['loaded'][0].shape)} and page "
        f"{tuple(emb['loaded'][1].shape)} embeddings bit-equal to the model holding the merged weights in memory; "
        f"its QueryEncoder behind make_handler found each of {len(QUERIES)} queries at rank 1 through /search_text "
        f"({r['seconds']:.1f} s)")
    del models, encoder, emb
    torch.cuda.empty_cache()
    return r


def eval_splits(name: str, kernel, queries, store, scales, got) -> dict:
    """The eval-shape call (one tile, B=128 Nq=16 Np=1,040: the doc tokens
    split over the SMs, maxima through scratch) again with the split forced
    off, over 37 CTAs and one CTA a block, and once more as planned: every
    run must give ``got``'s bits (the max is exact, the sums run in one
    order). Returns the plan and the CTAs of each run."""
    nt, np_ = store.shape[0], store.shape[1]
    plan = maxsim_bf16_plan(queries.shape[0], queries.shape[1], np_, DIM, nt,
                            torch.cuda.get_device_properties(0).multi_processor_count)
    runs = {"as planned, again": None, "not split": 0, "37 CTAs": 37, "one CTA a block": nt * np_}
    for label, split_ctas in runs.items():
        other = _maxsim_bf16_cuda(kernel, queries, store, scales, np_, nt, split_ctas=split_ctas)
        if not torch.equal(other, got):
            raise AssertionError(f"{name} at the eval shape, {label}: not bit-equal to the planned run, max abs diff "
                                 f"{(other - got).abs().max().item()}")
    log(f"  {name} at the eval shape: planned {plan.ctas} CTAs (split {plan.split}, {plan.k_max} scratch slots, "
        f"{plan.scratch_bytes / 2**20:.1f} MiB); bit-equal with the split off, over 37 CTAs, over one CTA a block "
        f"and on a second call")
    return dict(planned_ctas=plan.ctas, split=plan.split, k_max=plan.k_max, scratch_bytes=plan.scratch_bytes,
                bit_equal_under=list(runs))


def phase_training(device: torch.device, model, processor, smi: str) -> tuple:
    """Drive the training path: ``ColModelTraining`` steps, eval, save and
    resume at full width. Returns the launches over the path, the timings
    of K6's backward and of K4/K5 on the eval index, and the step metrics."""
    import tempfile

    from colpali_tpu_torch.core.hf_loader import load_colpali_params
    from colpali_tpu_torch.losses import ColbertPairwiseCELoss
    from colpali_tpu_torch.retrieval.store import DeviceIndexBuilder
    from colpali_tpu_torch.training import trainer
    from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec
    from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig

    v, t = model.config.vision, model.config.text
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    collated = processor.process_queries([f"synthetic query {i}" for i in range(TRAIN_BATCH)])
    page = processor._tokenize([processor._expand_image_prompt(processor.visual_prompt_prefix)])
    gemma = (t.num_attention_heads, t.num_key_value_heads, t.head_dim)
    q_len = collated["input_ids"].shape[1]
    cases = {
        "gemma_page": (TRAIN_BATCH, page["input_ids"].shape[1], *gemma, None, False),
        "gemma_query": (TRAIN_BATCH, q_len, *gemma, [int(n) for n in collated["attention_mask"].sum(axis=1)], False),
        "gemma_query_padded": (TRAIN_BATCH, 32, *gemma, [32, 19, 32, 7, 25, 32, 11, 30], True),
        "siglip": (TRAIN_BATCH, v.num_patches, v.num_attention_heads, v.num_attention_heads, v.head_dim, None, False),
    }
    k6_bwd = {name: k6_bwd_case(gen, device, *shape) for name, shape in cases.items()}
    for name, r in k6_bwd.items():
        log(f"phase training: K6 backward {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"backward: {library_note(r)} (7 products), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err "
            f"{r['max_abs_err']:.3g}, share of the tolerance dq {r['shares']['dq']:.0%} dk {r['shares']['dk']:.0%} "
            f"dv {r['shares']['dv']:.0%} (the bf16 plain version's own: {r['plain_shares']['dq']:.0%} "
            f"{r['plain_shares']['dk']:.0%} {r['plain_shares']['dv']:.0%}; the kernels from the same roundings in plain "
            f"PyTorch: {r['rounded_shares']['dq']:.0%} {r['rounded_shares']['dk']:.0%} {r['rounded_shares']['dv']:.0%})")
    torch.cuda.empty_cache()

    peft = LoraSpec(rank=32, alpha=32, dropout=0.1)
    loss_fn = ColbertPairwiseCELoss()
    train_config = trainer.TrainConfig(learning_rate=5e-5, warmup_steps=0, total_steps=2500)
    train_set = page_dataset(TRAIN_PAGES, SEED + 6)
    eval_set = page_dataset(EVAL_PAGES, SEED + 7, first=TRAIN_PAGES)
    model.set_remat(True)
    sampled = ["model.language_model.layers.0.self_attn.q_proj.weight",
               f"model.language_model.layers.{t.num_hidden_layers - 1}.mlp.down_proj.weight",
               f"model.vision_tower.layers.{v.num_hidden_layers // 2}.mlp.fc1.weight", "head.custom_text_proj.weight"]
    base_before = {k: model.state_dict()[k].clone() for k in sampled}

    with tempfile.TemporaryDirectory() as tmp:
        def make_app(out, **kw):
            return ColModelTraining(ColModelTrainingConfig(
                model=model, loss_func=loss_fn, train_datasets=[train_set], processor=processor,
                eval_dataset=eval_set, eval_batch_size=TRAIN_BATCH, output_dir=out, global_batch_size=TRAIN_BATCH,
                log_steps=1, save_steps=RESUME_AT, save_total_limit=TRAIN_STEPS, peft=peft, train=train_config,
                seed=SEED, device=device, **kw))

        # -- the trainer takes steps ---------------------------------------
        app = make_app(f"{tmp}/run", max_steps=TRAIN_STEPS)
        n_adapters = len(app.state.adapters.paths)
        n_trainable = sum(p.numel() for p in app.state.params)
        seen, moved_after_one = [], []

        def on_step(step, metrics):
            seen.append((step, float(metrics["loss"]), float(metrics["grad_norm"])))
            if step == 1:
                moved_after_one.extend(bool(b.detach().abs().max() > 0) for b in app.state.adapters.b)

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        summary = app.train(on_step=on_step)
        torch.cuda.synchronize()
        train_launches = {name: KERNELS[name]["counter"].launches for name in ("flash_attention", "flash_attention_bwd")}
        by_dim = dict(fa.BACKWARD_LAUNCHES_BY_HEAD_DIM)
        peak_train = torch.cuda.max_memory_allocated() / 2**30
        if [s for s, _, _ in seen] != list(range(1, TRAIN_STEPS + 1)):
            raise AssertionError(f"steps taken: {seen}")
        if not all(np.isfinite(l) and l > 0 and np.isfinite(g) and g > 0 for _, l, g in seen):
            raise AssertionError(f"loss or grad_norm not finite and positive: {seen}")
        if len(moved_after_one) != n_adapters or not all(moved_after_one):
            raise AssertionError(f"{moved_after_one.count(False)} of {n_adapters} adapters did not move in step 1")
        if not all(torch.equal(model.state_dict()[k], w) for k, w in base_before.items()):
            raise AssertionError("a frozen base weight changed")
        passes = TRAIN_STEPS * 2  # a query and a doc forward per step need a gradient
        if train_launches["flash_attention_bwd"] < passes * t.num_hidden_layers or by_dim[v.head_dim] != 0 \
                or by_dim[t.head_dim] != train_launches["flash_attention_bwd"]:
            raise AssertionError(f"K6 launches over {TRAIN_STEPS} steps: {train_launches}, backward by head dim {by_dim}")
        log(f"  trained: {n_adapters} adapted layers, {n_trainable / 1e6:.1f} M trainable parameters; "
            + ", ".join(f"step {s} loss {l:.4f} grad_norm {g:.4f}" for s, l, g in seen)
            + f"; {summary['train_samples_per_second']:.2f} examples/s with collation and checkpoints ({smi}); "
            f"launches K6 forward {train_launches['flash_attention']}, backward {train_launches['flash_attention_bwd']} "
            f"(by head dim {by_dim}); peak memory {peak_train:.2f} GiB")

        # -- one step through the kernels against the plain route -------------
        batch = trainer.to_device(next(iter(app.batches(0))), device)
        from colpali_tpu_torch.losses import ColbertLoss

        kernel, plain, recipe = route_gap(app.state, batch, loss_fn, peft)
        (neg_k, tok_k, valid), (neg_p, tok_p, _) = recipe_picks(*kernel[2:]), recipe_picks(*plain[2:])
        recipe.update(negatives_picked_differently=int((neg_k != neg_p).sum()), queries=len(neg_p),
                      tokens_picked_differently=int(((tok_k != tok_p) & valid[:, None]).sum()),
                      token_picks=2 * int(valid.sum()))
        log(f"  kernel route vs plain route, recipe loss, one step from the same state: loss {kernel[0]:.6f} vs "
            f"{plain[0]:.6f} (relative {recipe['loss_relative']:.2e}, limit {PLAIN_ROUTE_LOSS_RTOL}); the routes pick "
            f"another hardest negative for {recipe['negatives_picked_differently']} of {recipe['queries']} queries and "
            f"another best page token for {recipe['tokens_picked_differently']} of {recipe['token_picks']} query "
            f"tokens, adapter gradient cosine {recipe['grad_cos']:.6f} (not held: it follows the picks)")
        if not recipe["loss_relative"] <= PLAIN_ROUTE_LOSS_RTOL:
            raise AssertionError(f"kernel route vs plain route, recipe loss: {kernel[0]} vs {plain[0]}")
        route = {"recipe loss": recipe}
        recipe_plain_loss = plain[0]
        del kernel, plain
        for name, fn, limit in (("recipe loss with the plain route's picks", frozen_pairwise_loss(neg_p, tok_p),
                                 PLAIN_ROUTE_FROZEN_GRAD_COS),
                                ("smooth probe", ColbertLoss(use_smooth_max=True), PLAIN_ROUTE_SMOOTH_GRAD_COS)):
            kernel, plain, r = route_gap(app.state, batch, fn, peft)
            route[name] = r
            log(f"  kernel route vs plain route, {name}: loss {kernel[0]:.6f} vs {plain[0]:.6f} (relative "
                f"{r['loss_relative']:.2e}, limit {PLAIN_ROUTE_LOSS_RTOL}), adapter gradient cosine {r['grad_cos']:.6f} "
                f"(limit {limit}), norm ratio {r['grad_norm_ratio']:.4f}")
            if not (r["loss_relative"] <= PLAIN_ROUTE_LOSS_RTOL and r["grad_cos"] >= limit):
                raise AssertionError(f"kernel route vs plain route, {name}: loss {kernel[0]} vs {plain[0]}, "
                                     f"gradient cosine {r['grad_cos']}")
            if name.startswith("recipe") and abs(plain[0] - recipe_plain_loss) > 1e-4 * recipe_plain_loss:
                raise AssertionError(f"the loss with frozen picks is {plain[0]} on the plain route, the recipe loss "
                                     f"{recipe_plain_loss}")
            del kernel, plain

        # -- eval: a bf16 index built on the card, searched by K5 --------------
        reset_launches()  # the comparison above launched K6 too: it does not count
        t0 = time.perf_counter()
        metrics = app.evaluate()
        t_eval = time.perf_counter() - t0
        slice_launches = {"maxsim_bf16": MAXSIM_BF16.launches, "flash_attention_bwd": train_launches["flash_attention_bwd"],
                          "flash_attention": train_launches["flash_attention"] + fa.FLASH_ATTENTION.launches}
        index = app.eval_index
        wanted = {"eval_loss", "eval_ndcg@1", "eval_ndcg@5"}
        if not wanted <= set(metrics) or not all(np.isfinite(metrics[k]) for k in metrics):
            raise AssertionError(f"evaluate(): {metrics}")
        if (index.dtype, index.num_docs, index.doc_tokens, index._store.device.type) != \
                ("bf16", EVAL_PAGES, PAGE_DOC_TOKENS, device.type):
            raise AssertionError(f"eval index: {index.dtype} {index.num_docs} x {index.doc_tokens} on {index._store.device}")
        queries = index._prep_queries(app.eval_queries)
        got, want = maxsim_tiled(queries, index._store), maxsim_tiled_plain(queries, index._store)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        k5_eval = dict(max_abs_err=(got - want).abs().max().item(),
                       ms=time_ms(lambda: maxsim_tiled(queries, index._store)),
                       plain_ms=time_ms(lambda: maxsim_tiled_plain(queries, index._store), reps=2),
                       **bound(index._store.numel() * 2 + queries.numel() * 2 + got.numel() * 4,
                               2 * queries.shape[0] * queries.shape[1] * index.padded_docs * index.doc_tokens * DIM,
                               "bf16"),
                       shape=f"B={queries.shape[0]} Nq={queries.shape[1]} Np={index.doc_tokens} C={index.padded_docs}")
        if not all(slice_launches[name] for name in TRAINING_KERNELS):
            raise AssertionError(f"training slice: a kernel of the path was not launched: {slice_launches}")
        k5_eval["splits"] = eval_splits("K5", MAXSIM_BF16, queries, index._store, None, got)
        # K4's own path, not part of the training slice: the same pages as an int8 index with unquantized
        # queries, searched through CorpusIndex.search; its count is set to 0 before and read after that search
        index_builder = DeviceIndexBuilder(doc_tokens=index.doc_tokens, dim=DIM, dtype="int8", quantize_queries=False)
        index_builder.add(index._store.float().permute(0, 2, 1, 3).reshape(-1, index.doc_tokens, DIM)[:EVAL_PAGES])
        int8_index = index_builder.build()
        _, ids_bf16 = index.search(app.eval_queries, k=1)
        MAXSIM_INT8_BF16.reset()
        _, ids_int8 = int8_index.search(app.eval_queries, k=1)
        int8_search_launches = MAXSIM_INT8_BF16.launches
        if not int8_search_launches:
            raise AssertionError("the search of an int8 index with quantize_queries=False did not launch K4")
        agree = float((ids_bf16 == ids_int8).mean())
        got4 = maxsim_int8_tiled(queries, int8_index._store, int8_index._scales)
        want4 = maxsim_int8_tiled_plain(queries, int8_index._store, int8_index._scales)
        torch.testing.assert_close(got4, want4, rtol=RTOL, atol=ATOL)
        splits4 = eval_splits("K4", MAXSIM_INT8_BF16, queries, int8_index._store, int8_index._scales, got4)
        k4_eval = dict(splits=splits4, max_abs_err=(got4 - want4).abs().max().item(),
                       ms=time_ms(lambda: maxsim_int8_tiled(queries, int8_index._store, int8_index._scales)),
                       plain_ms=time_ms(lambda: maxsim_int8_tiled_plain(queries, int8_index._store,
                                                                        int8_index._scales), reps=2),
                       **bound(int8_index._store.numel() + int8_index._scales.numel() * 4 + queries.numel() * 2
                               + got4.numel() * 4,
                               2 * queries.shape[0] * queries.shape[1] * index.padded_docs * index.doc_tokens * DIM,
                               "bf16"), shape=k5_eval["shape"])
        if agree < 0.9:
            raise AssertionError(f"int8 (K4) and bf16 (K5) eval indexes agree on {agree:.0%} of the top-1 pages")
        log(f"  evaluate(): {EVAL_PAGES} held-out pages in {t_eval:.1f} s, bf16 index {index.num_docs} x "
            f"{index.doc_tokens} x {index.dim} built on the card, "
            + ", ".join(f"{k} {metrics[k]:.4f}" for k in sorted(wanted)) + f"; launches over the steps and the eval "
            f"{slice_launches}. Apart from that slice, CorpusIndex.search on the same pages as an int8 index with "
            f"unquantized queries launched K4 {int8_search_launches} time(s) and agrees on {agree:.0%} of the top-1 pages")
        for name, r in (("K5 maxsim_bf16", k5_eval), ("K4 maxsim_int8_bf16", k4_eval)):
            log(f"  {name} on the eval index [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}")
        del int8_index, index_builder

        # -- save: the merged export, model.safetensors in the HF layout ---------
        t0 = time.perf_counter()
        app.save()
        t_save = time.perf_counter() - t0
        adapters = app.state.adapters
        i = adapters.module_names.index(f"model.language_model.layers.{t.num_hidden_layers // 2}.mlp.up_proj")
        name = f"{adapters.module_names[i]}.weight"
        t0 = time.perf_counter()
        merged = load_colpali_params(f"{tmp}/run")
        t_read = time.perf_counter() - t0
        base_w = model.state_dict()[name]
        expect = base_w + ((adapters.a[i] @ adapters.b[i]).T * (peft.alpha / peft.rank)).to(base_w.dtype)
        if set(merged) != set(model.state_dict()) or not torch.equal(merged[name].to(device), expect):
            raise AssertionError(f"save(): {name} is not W + (alpha/r) A @ B")
        log(f"  save(): merged weights written as model.safetensors (HF layout) in {t_save:.1f} s, {len(merged)} "
            f"tensors read back by load_colpali_params in {t_read:.1f} s; {name} equals W + (alpha/r) A @ B")
        del expect
        readback = checkpoint_readback(device, model, adapters.merged_state_dict(model), merged, processor)
        del merged
        app.close()
        app.close()

        # -- resume from the step-2 checkpoint ---------------------------------
        import os
        import shutil

        os.makedirs(f"{tmp}/resumed/checkpoints")
        shutil.copy(f"{tmp}/run/checkpoints/step_{RESUME_AT}.pt", f"{tmp}/resumed/checkpoints/")
        resumed = make_app(f"{tmp}/resumed", max_steps=RESUME_AT + 1, resume_from_checkpoint=True)
        if resumed.state.step != RESUME_AT:
            raise AssertionError(f"resumed at step {resumed.state.step}, expected {RESUME_AT}")
        tail = []
        resumed.train(on_step=lambda step, m: tail.append((step, float(m["loss"]))))
        resumed.close()
        first_loss = seen[RESUME_AT][1]
        if [s for s, _ in tail] != [RESUME_AT + 1] or abs(tail[0][1] - first_loss) > RESUME_LOSS_RTOL * abs(first_loss):
            raise AssertionError(f"resumed run: {tail}, the first run's step {RESUME_AT + 1} loss {first_loss}")
        log(f"  resumed from step {RESUME_AT}: step {RESUME_AT + 1} loss {tail[0][1]:.8f} vs {first_loss:.8f} in the "
            f"first run (limit {RESUME_LOSS_RTOL} relative)")

    # -- gradient direction: one repeated batch, fresh adapters --------------------
    adapters = LoraAdapters(model, peft, seed=SEED + 1)
    state = trainer.create_train_state(
        model, trainer.TrainConfig(learning_rate=DIRECTION_LR, warmup_steps=0, total_steps=1000), adapters)
    step = trainer.make_train_step(loss_fn, peft=peft, seed=SEED)
    losses = [step(state, batch)["loss"].item() for _ in range(DIRECTION_STEPS)]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{DIRECTION_STEPS} steps on one batch at lr {DIRECTION_LR} did not lower the loss: {losses}")
    log(f"  {DIRECTION_STEPS} steps on one repeated batch at lr {DIRECTION_LR}: loss "
        + " -> ".join(f"{l:.4f}" for l in losses))

    # -- where a step's time goes, with and without remat ------------------------
    steps = {}
    for remat in (True, False):
        model.set_remat(remat)
        steps["remat" if remat else "no_remat"] = r = timed_steps(state, batch, loss_fn, peft, SEED, steps=3)
        log(f"  train step, batch {TRAIN_BATCH}, remat {'on' if remat else 'off'} ({smi}): {r['wall']:.1f} ms/step "
            f"({TRAIN_BATCH / r['wall'] * 1e3:.2f} examples/s without collation), forward {r['forward']:.1f} ms, "
            f"backward {r['backward']:.1f} ms, optimizer {r['optimizer']:.1f} ms, host and idle "
            f"{r['wall'] - r['forward'] - r['backward'] - r['optimizer']:.1f} ms, peak memory {r['peak_gib']:.2f} GiB")
    log(f"  recompute under remat: backward {steps['remat']['backward'] - steps['no_remat']['backward']:.1f} ms longer "
        f"than without")
    model.set_remat(True)
    steps["remat_profile"] = kernel_breakdown(f"one train step, batch {TRAIN_BATCH}, remat on",
                                              lambda: step(state, batch)["loss"].item())
    adapters.detach()
    model.set_remat(False)
    model.eval()
    extra = dict(losses=[l for _, l, _ in seen], grad_norms=[g for _, _, g in seen], eval=metrics,
                 examples_per_s_end_to_end=summary["train_samples_per_second"], step_ms=steps,
                 plain_route=route, peak_train_gib=peak_train,
                 launches_per_train_step={k: n // TRAIN_STEPS for k, n in train_launches.items()},
                 int8_search_launches=int8_search_launches, checkpoint_readback=readback)
    return slice_launches, train_launches, k6_bwd, dict(maxsim_bf16=k5_eval, maxsim_int8_bf16=k4_eval), extra


# -- phase 7: stored-int8 weights (run after phase 5) ----------------------------------

# (K, N) of ColPali-3B's quantized projections: SigLIP q/k/v/o, fc1, fc2; the projector; Gemma q/o, gate/up, down
QUANT_SHAPES = ((1152, 1152), (1152, 4304), (4304, 1152), (1152, 2048), (2048, 2048), (2048, 16384), (16384, 2048))
QUANT_ROWS = (1, 17, 32, 256, 8232)  # 32 and 256: QueryEncoder's buckets x1 and x8 (32 tokens); 8,232: 8 pages in Gemma
QUANT_TIMED_ROWS = (32, 256, 8232)
QUANT_LAYERS = 253  # 27 x 6 SigLIP + the projector + 18 x 5 Gemma (its k/v, 2048 -> 256, stay bf16)
# Q1b and Q1a launches of one forward: Q1a quantizes an input once for the layers that share it (q/k/v, gate/up)
Q1_QUERY_FORWARD = {"quantize_rows": 18 * 4, "int8_gemm": 18 * 5}
Q1_PAGE_FORWARD = {"quantize_rows": 27 * 4 + 1 + 18 * 4, "int8_gemm": 27 * 6 + 1 + 18 * 5}
QUANT_INDEX_DOCS = 4_096
Q1A_HEADLINE, Q1B_HEADLINE = (8232, 16384), (8232, 2048, 16384)  # down_proj's input, gate/up: 8 pages in Gemma
# stored int8 against bf16 through 45 layers of random weights, per token: about 3x the gaps measured on the
# H100 (pages mean cos 0.990087, min 0.978436; queries 0.994057, 0.990090; the same in two runs). Kernel route
# against plain route: Q1a/Q1b are bit-equal to their plain versions, and the two routes gave equal bits
INT8_COS_MEAN, INT8_COS_MIN = 0.97, 0.93
ROUTE_COS_MIN = 0.9999


def q1_operands(gen: torch.Generator, device: torch.device, m: int, k: int, n: int) -> tuple:
    """bf16 activations (m, k), a bf16 weight (n, k) at hf_init_'s scale,
    its int8 copy as quantize_params makes it, and a bf16 bias."""
    x = (torch.randn((m, k), generator=gen, device=device) * 3).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device=device) * 0.02).to(torch.bfloat16)
    qw, sw = qd.quantize_rows_eager(w)
    qw = qd.int8_rows(qw.shape, device, fill=qw)  # rows on 16 bytes, as QDense.store_int8 keeps them
    bias = torch.randn((n,), generator=gen, device=device).to(torch.bfloat16)
    return x, w, qw, sw.reshape(-1), bias


def q1_edge_rows(device: torch.device, k: int) -> torch.Tensor:
    """A zero row, rows of exact .5 ties under the forward's scale (absmax
    254: values on multiples of 254 * fp32(1/127) plus a half) and a row
    holding one large value."""
    s = 254.0 * qd._INV_127
    ties = ((torch.arange(k, device=device) % 21) - 9.5) * s
    x = torch.zeros((4, k), device=device)
    x[1], x[2] = ties, -ties
    x[1:3, 0] = 127.0 * s
    x[3] = torch.linspace(-1.0, 1.0, k, device=device)
    x[3, k // 2] = 1e4
    return x


def product(shapes, ms) -> list:
    """(M, K, N) for every (K, N) of ``shapes`` and every M of ``ms``."""
    return [(m, k, n) for k, n in shapes for m in ms]


def q1_checks(device: torch.device, mkn: list, edge_ks=(4304, 16384)) -> dict:
    """Q1a and Q1b bit-equal to their plain versions at every (M, K, N) of
    ``mkn``, with and without bias, bf16 and fp32 out; Q1a also on edge rows
    at each K of ``edge_ks``."""
    gen = torch.Generator(device=device).manual_seed(SEED + 20)
    cases = 0
    for m, k, n in mkn:
        x, _, qw, sw, bias = q1_operands(gen, device, m, k, n)
        qa, sa = qd.quantize_rows(x)
        pa, ps = qd.quantize_rows_plain(x)
        if not (torch.equal(qa, pa) and torch.equal(sa, ps)):
            raise AssertionError(f"Q1a at M={m} K={k}: not bit-equal to its plain version")
        for out_dtype in (torch.bfloat16, torch.float32):
            for b in (None, bias):
                got = qd.int8_gemm(qa, sa, qw, sw, b, out_dtype)
                want = qd.int8_gemm_plain(qa, sa, qw, sw, b, out_dtype)
                if not torch.equal(got, want):
                    raise AssertionError(f"Q1b at M={m} K={k} N={n} {out_dtype} bias {b is not None}: max abs "
                                         f"diff {(got.float() - want.float()).abs().max().item()}")
                cases += 1
        del x, qw, sw, bias, qa, sa, pa, ps, got, want
    for k in edge_ks:
        for dtype in (torch.bfloat16, torch.float32):
            x = q1_edge_rows(device, k).to(dtype)
            (qa, sa), (pa, ps) = qd.quantize_rows(x), qd.quantize_rows_plain(x)
            if not (torch.equal(qa, pa) and torch.equal(sa, ps)) or sa[0].item() != 1.0:
                raise AssertionError(f"Q1a on edge rows at K={k} {dtype}: not bit-equal to its plain version")
    torch.cuda.empty_cache()
    return dict(q1b_cases=cases, q1a_edge_cases=2 * len(edge_ks))


def q1_timing(device: torch.device, mkn: list) -> tuple:
    """Q1a and Q1b at every (M, K, N) of ``mkn`` by CUDA events (and from a
    CUDA graph at M <= 256) beside their bounds, their plain versions and
    the library yardsticks: ``torch._int_mm`` with the epilogue as PyTorch
    ops (K and N zero-padded to multiples of 8 where they are not, which
    ``_int_mm`` needs: zero columns add nothing, zero rows are sliced off),
    and ``F.linear`` in bf16 on the unquantized weight."""
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    rows, gemms = [], []
    for m, k, n in mkn:
        x, w, qw, sw, _ = q1_operands(gen, device, m, k, n)
        qa, sa = qd.quantize_rows(x)
        short = m <= 256
        if not any(r["m"] == m and r["k"] == k for r in rows):  # Q1a once per distinct input shape
            rows.append(dict(m=m, k=k, ms=time_ms(lambda: qd.quantize_rows(x)),
                             graph_ms=graph_ms(lambda: qd.quantize_rows(x)) if short else None,
                             plain_ms=time_ms(lambda: qd.quantize_rows_plain(x), reps=2),
                             **bound(m * k * 2 + m * k + m * 4, 0, "int8")))

        # contiguous copies for the library call, K and N zero-padded to multiples of 8
        la, lw = F.pad(qa, (0, (-k) % 8)), F.pad(qw, (0, (-k) % 8, 0, (-n) % 8))

        def int_mm():
            return (torch._int_mm(la, lw.t())[:, :n].float() * sa * sw).to(torch.bfloat16)

        try:  # the yardstick only: the port never calls it
            library_equal = torch.equal(int_mm(), qd.int8_gemm(qa, sa, qw, sw))
            library_ms, library_note = time_ms(int_mm), None
        except RuntimeError as exc:
            library_ms, library_note, library_equal = None, str(exc).splitlines()[0][:160], None
        gemms.append(dict(m=m, k=k, n=n, ms=time_ms(lambda: qd.int8_gemm(qa, sa, qw, sw)),
                          graph_ms=graph_ms(lambda: qd.int8_gemm(qa, sa, qw, sw)) if short else None,
                          plain_ms=time_ms(lambda: qd.int8_gemm_plain(qa, sa, qw, sw), reps=2),
                          library_ms=library_ms, library_note=library_note, library_bit_equal=library_equal,
                          bf16_linear_ms=time_ms(lambda: F.linear(x, w)),
                          **bound(m * k + n * k + 4 * m + 4 * n + 2 * m * n, 2 * m * n * k, "int8")))
        del x, w, qw, sw, qa, sa, la, lw
    torch.cuda.empty_cache()
    for r in rows:
        graph = f", graph {r['graph_ms']:.4f}" if r["graph_ms"] is not None else ""
        log(f"  Q1a M={r['m']} K={r['k']}: kernel {r['ms']:.4f} ms{graph}, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    for r in gemms:
        graph = f", graph {r['graph_ms']:.4f}" if r["graph_ms"] is not None else ""
        lib = f"{r['library_ms']:.4f}" if r["library_ms"] is not None else f"n/a ({r['library_note']})"
        log(f"  Q1b M={r['m']} K={r['k']} N={r['n']}: kernel {r['ms']:.4f} ms{graph}, plain {r['plain_ms']:.3f} ms, "
            f"_int_mm + epilogue {lib} ms, bf16 F.linear {r['bf16_linear_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {2 * r['m'] * r['n'] * r['k'] / r['ms'] / 1e9:.0f} TOP/s")
    return rows, gemms


def hf_checkpoint(model, directory: str) -> None:
    """The model's weights as an HF-format ColPali checkpoint that
    ``load_retriever`` reads: ``model.safetensors``, ``config.json``,
    ``preprocessor_config.json`` (448 px, mean and std 0.5) and a word-level
    tokenizer over the prompts' and QUERIES' words with PaliGemma's special
    ids (``python -m colpali_tpu_torch.embed_corpus`` and ``serve.py
    --checkpoint`` load it from the directory)."""
    import dataclasses

    from colpali_tpu_torch.training.checkpointing import save_pretrained
    from colpali_tpu_torch.utils.testing import paligemma_word_tokenizer

    cfg = model.config
    save_pretrained(directory, model.state_dict())
    with open(f"{directory}/config.json", "w") as f:
        json.dump({"model_type": "paligemma", "architectures": ["ColPali"],
                   "vision_config": {**dataclasses.asdict(cfg.vision), "projection_dim": cfg.projection_dim},
                   "text_config": dataclasses.asdict(cfg.text), "image_token_index": cfg.image_token_index}, f)
    with open(f"{directory}/preprocessor_config.json", "w") as f:
        json.dump({"size": {"height": cfg.vision.image_size, "width": cfg.vision.image_size},
                   "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]}, f)
    words = {*"Describe the image. Query:".split(), *POOL_PROMPT.split(">")[-1].split(), *" ".join(QUERIES).split()}
    paligemma_word_tokenizer(sorted(words), cfg.image_token_index).save_pretrained(directory)


def per_token(name: str, got: list, want: list, cos_mean: float, cos_min: float) -> dict:
    """Per-token cosine and max abs of two lists of (tokens, dim) arrays."""
    a, b = np.concatenate(got), np.concatenate(want)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    out = dict(tokens=len(a), mean_cos=float(cos.mean()), min_cos=float(cos.min()), max_abs=float(np.abs(a - b).max()),
               bit_equal=bool(np.array_equal(a, b)))
    if not (np.isfinite(a).all() and out["mean_cos"] >= cos_mean and out["min_cos"] >= cos_min):
        raise AssertionError(f"{name}: {out}, limits mean cos >= {cos_mean}, min cos >= {cos_min}")
    log(f"  {name}, {out['tokens']} tokens: mean cos {out['mean_cos']:.6f}, min cos {out['min_cos']:.6f}, max abs "
        f"{out['max_abs']:.4g}{' (bit-equal)' if out['bit_equal'] else ''} (limits {cos_mean}, {cos_min})")
    return out


def q1_plain_route():
    """Q1a and Q1b's plain versions patched in for a comparison (their
    launches are not counted)."""
    import contextlib

    from colpali_tpu_torch.models import layers as layers_mod

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(qd, "quantize_rows", qd.quantize_rows_plain))
    stack.enter_context(mock.patch.object(layers_mod, "quantize_rows", qd.quantize_rows_plain))
    stack.enter_context(mock.patch.object(qd, "int8_gemm", qd.int8_gemm_plain))
    return stack


def forward_ms(model, feed: dict) -> float:
    """Device ms of one forward of ``feed`` (CUDA events, after a warm-up)."""
    with torch.inference_mode():
        return time_ms(lambda: model(**feed), reps=5)


def phase_stored_int8(device: torch.device, model, processor, smi: str, ckpt: str) -> tuple:
    """Drive the stored-int8 serving path: the seeded ColPali-3B written as an
    HF checkpoint in ``ckpt`` (kept for phase 18), read back through
    ``load_retriever(quantize=True)``, serving ``/search_text`` and embedding
    pages, beside the bf16 model. Returns the launches over that path,
    Q1a/Q1b's timings and the rest."""
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.retrieval.ingest import embed_pages_fused
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.retrieval.store import CorpusIndex

    checks = q1_checks(device, product(QUANT_SHAPES, QUANT_ROWS))
    log(f"phase stored int8: Q1a and Q1b bit-equal to their plain versions in {checks['q1b_cases']} Q1b cases "
        f"({len(QUANT_SHAPES)} (K, N) x M {QUANT_ROWS} x bias or none x bf16 or fp32 out) and on Q1a's edge rows at "
        f"K 4,304 and 16,384")
    rows, gemms = q1_timing(device, product(QUANT_SHAPES, QUANT_TIMED_ROWS))

    cfg = model.config
    t0 = time.perf_counter()
    hf_checkpoint(model, ckpt)
    t_save = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qmodel, qproc = load_retriever(ckpt, quantize=True, device=device,
                                   processor_kwargs={"tokenizer": WordTokenizer(cfg.image_token_index)})
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    load_peak = (torch.cuda.max_memory_allocated() - before) / 2**30
    held = (torch.cuda.memory_allocated() - before) / 2**30

    def weight_bytes(m) -> int:
        return sum(t.numel() * t.element_size() for t in m.state_dict().values())

    stored = [name for name, m in qmodel.named_modules() if isinstance(m, QDense) and m.stored]
    lm = qmodel.model.language_model
    exact = {"patch embedding": qmodel.model.vision_tower.patch_embedding.weight,
             "Gemma k_proj": lm.layers[0].self_attn.k_proj.weight, "Gemma v_proj": lm.layers[0].self_attn.v_proj.weight,
             "token embedding": lm.embed_tokens.weight, "head": qmodel.head.custom_text_proj.weight}
    if len(stored) != QUANT_LAYERS or any(w.dtype != torch.bfloat16 for w in exact.values()):
        raise AssertionError(f"load_retriever(quantize=True): {len(stored)} stored-int8 layers, expected "
                             f"{QUANT_LAYERS}; {({k: w.dtype for k, w in exact.items()})}")
    bytes_int8, bytes_bf16 = weight_bytes(qmodel), weight_bytes(model)
    log(f"  load_retriever(quantize=True): HF checkpoint written in {t_save:.1f} s, read and quantized in {t_load:.1f} "
        f"s; {len(stored)} stored-int8 layers; weights on the card {bytes_int8 / 1e9:.3f} GB against "
        f"{bytes_bf16 / 1e9:.3f} GB in bf16 ({bytes_int8 / bytes_bf16:.1%}); allocated {held:.2f} GiB after the "
        f"load, peak {load_peak:.2f} GiB during it")

    # Q1a on the model's own activations (inputs of four layers during a page forward)
    vt = qmodel.model.vision_tower
    taps = {"SigLIP fc2": vt.layers[len(vt.layers) // 2].mlp.fc2, "projector": qmodel.model.multi_modal_projector,
            "Gemma q_proj": lm.layers[len(lm.layers) // 2].self_attn.q_proj,
            "Gemma down_proj": lm.layers[len(lm.layers) // 2].mlp.down_proj}
    seen = {}
    handles = [m.register_forward_pre_hook(lambda mod, args, name=name: seen.setdefault(name, args[0].detach()))
               for name, m in taps.items()]
    pages = make_pages(PAGES, SEED + 12)
    try:
        embed_pages_fused(qmodel, qproc, pages[:PAGE_BATCH], transport="yuv420", batch_size=PAGE_BATCH)
    finally:
        for h in handles:
            h.remove()
    for name, x in seen.items():
        x2 = x.reshape(-1, x.shape[-1])
        (qa, sa), (pa, ps) = qd.quantize_rows(x2), qd.quantize_rows_plain(x2)
        if not (torch.equal(qa, pa) and torch.equal(sa, ps)):
            raise AssertionError(f"Q1a on the model's own {name} input: not bit-equal to its plain version")
    log(f"  Q1a bit-equal to its plain version on the model's own inputs: "
        + ", ".join(f"{name} {tuple(x.shape)}" for name, x in seen.items()))
    del seen

    qenc = QueryEncoder(qmodel, qproc)
    qenc.warmup()
    benc = QueryEncoder(model, processor)
    per_forward = {}
    for what, run, want in (("query forward", lambda: qenc.encode(QUERIES[:1]), Q1_QUERY_FORWARD),
                            ("page forward", lambda: embed_pages_fused(qmodel, qproc, pages[:PAGE_BATCH],
                                                                       transport="yuv420", batch_size=PAGE_BATCH),
                             Q1_PAGE_FORWARD)):
        reset_launches()
        run()
        per_forward[what] = {name: KERNELS[name]["counter"].launches for name in QUANT_KERNELS}
        if per_forward[what] != want:
            raise AssertionError(f"launches of one {what}: {per_forward[what]}, expected {want}")
    log(f"  launches of one forward: {per_forward}")

    # the served path: /search_text through the stored-int8 encoder, and page ingestion
    reset_launches()
    planted_q = qenc.encode(QUERIES)
    gen = torch.Generator(device=device).manual_seed(SEED + 13)
    docs = torch.randn((QUANT_INDEX_DOCS, DOC_TOKENS, DIM), generator=gen, device=device)
    docs = (docs / docs.norm(dim=-1, keepdim=True)).cpu().numpy()
    planted = [int(i) for i in np.linspace(50, QUANT_INDEX_DOCS - 50, len(QUERIES))]
    for q, doc_id in zip(planted_q, planted):
        docs[doc_id] = 0.0
        docs[doc_id, : q.shape[0]] = q
    index = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
    del docs
    httpd = serve.RetrievalServer(("127.0.0.1", 0), serve.make_handler(
        index, [f"doc_{i}" for i in range(index.num_docs)], encoder=qenc))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        tiered = [_http(url, "/search_text", {"queries": [q], "k": 10}) for q in QUERIES]  # one a request: tiered
        exact = _http(url, "/search_text", {"queries": QUERIES, "k": 10})  # 8 > 4: exact
        for out in (*tiered, exact):
            _check_ranked("/search_text (stored int8)", out, len(out["doc_ids"]))
        top_tiered, top_exact = [out["doc_ids"][0][0] for out in tiered], [row[0] for row in exact["doc_ids"]]
        if top_tiered != planted or top_exact != planted:
            raise AssertionError(f"stored int8 /search_text at rank 1: tiered {top_tiered}, exact {top_exact}, "
                                 f"planted {planted}")
        t0 = time.perf_counter()
        embs = embed_pages_fused(qmodel, qproc, pages, transport="yuv420", batch_size=PAGE_BATCH)
        t_embed = time.perf_counter() - t0
        launches = read_launches("stored int8", QUANT_KERNELS)
        with q1_plain_route():
            plain_top = [row[0] for row in _http(url, "/search_text", {"queries": QUERIES, "k": 10})["doc_ids"]]
        if plain_top != planted:
            raise AssertionError(f"stored int8 /search_text on the plain route: rank 1 {plain_top}, planted {planted}")
    finally:
        httpd.shutdown()
        httpd.server_close()
    del index
    log(f"  served: /search_text through the stored-int8 encoder found each of {len(QUERIES)} planted docs at rank 1 "
        f"on the tiered route (one query a request), the exact route (8 at once) and the Q1 plain route; "
        f"{PAGES} pages embedded ({PAGES / t_embed * 60:.0f} pages/min); launches {launches}")
    for e in embs:
        if not np.isfinite(e).all() or np.abs(np.linalg.norm(e, axis=-1) - 1).max() > 1e-2:
            raise AssertionError("stored int8 page embeddings: not finite or not unit norm")

    # accuracy: stored int8 against bf16, and Q1's kernel route against its plain route
    batch = pages[:PAGE_BATCH]
    q_pages = embed_pages_fused(qmodel, qproc, batch, transport="yuv420", batch_size=PAGE_BATCH)
    b_pages = embed_pages_fused(model, processor, batch, transport="yuv420", batch_size=PAGE_BATCH)
    q_queries, b_queries = qenc.encode(QUERIES), benc.encode(QUERIES)
    with q1_plain_route():
        p_pages = embed_pages_fused(qmodel, qproc, batch, transport="yuv420", batch_size=PAGE_BATCH)
        p_queries = qenc.encode(QUERIES)
    accuracy = {
        "pages vs bf16": per_token(f"{PAGE_BATCH} pages, stored int8 vs bf16", q_pages, b_pages, INT8_COS_MEAN,
                                   INT8_COS_MIN),
        "queries vs bf16": per_token(f"{len(QUERIES)} queries, stored int8 vs bf16", q_queries, b_queries,
                                     INT8_COS_MEAN, INT8_COS_MIN),
        "pages vs plain route": per_token(f"{PAGE_BATCH} pages, Q1 kernel route vs plain route", q_pages, p_pages,
                                          ROUTE_COS_MIN, ROUTE_COS_MIN),
        "queries vs plain route": per_token(f"{len(QUERIES)} queries, Q1 kernel route vs plain route", q_queries,
                                            p_queries, ROUTE_COS_MIN, ROUTE_COS_MIN)}

    # end to end, stored int8 against bf16 in turns: encode (host clock, median of 10), one forward (CUDA events),
    # pages/min through embed_pages_fused
    feeds = {}
    for b_, texts in (("x1", QUERIES[:1]), ("x8", QUERIES)):
        feed, _ = qenc._pad_static(qproc.process_queries(texts))
        feeds[b_] = {k: torch.from_numpy(v).to(device) for k, v in feed.items()}
    tok = qproc._tokenize([qproc._expand_image_prompt(qproc.visual_prompt_prefix)] * PAGE_BATCH)
    feeds["pages"] = dict(input_ids=torch.from_numpy(tok["input_ids"]).to(device),
                          attention_mask=torch.from_numpy(tok["attention_mask"]).to(device),
                          pixel_values=torch.rand((PAGE_BATCH, qproc.image_size, qproc.image_size, 3), generator=gen,
                                                  device=device) * 2 - 1)
    e2e = {}
    for label, enc, m, proc in (("bf16", benc, model, processor), ("int8", qenc, qmodel, qproc),
                                ("int8 again", qenc, qmodel, qproc), ("bf16 again", benc, model, processor)):
        r = {}
        for b_, texts in (("x1", QUERIES[:1]), ("x8", QUERIES)):
            enc.encode(texts)
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                enc.encode(texts)
                walls.append((time.perf_counter() - t0) * 1e3)
            r[f"encode_{b_}_ms"] = float(np.median(walls))
            r[f"forward_{b_}_ms"] = forward_ms(m, feeds[b_])
        r["page_forward_ms"] = forward_ms(m, feeds["pages"])
        t0 = time.perf_counter()
        embed_pages_fused(m, proc, pages, transport="yuv420", batch_size=PAGE_BATCH)
        r["pages_per_min"] = PAGES / (time.perf_counter() - t0) * 60
        e2e[label] = r
        log(f"  {label} ({smi}): encode x1 {r['encode_x1_ms']:.2f} ms (forward {r['forward_x1_ms']:.2f}), x8 "
            f"{r['encode_x8_ms']:.2f} ms (forward {r['forward_x8_ms']:.2f}); forward of {PAGE_BATCH} pages "
            f"{r['page_forward_ms']:.1f} ms; {r['pages_per_min']:.0f} pages/min")
    with torch.inference_mode():
        profile = kernel_breakdown(f"one stored-int8 forward of {PAGE_BATCH} pages",
                                   lambda: qmodel(**feeds["pages"]))
    del qenc, benc, qmodel, feeds
    torch.cuda.empty_cache()

    down_in = next(r for r in rows if (r["m"], r["k"]) == Q1A_HEADLINE)
    gate = next(r for r in gemms if (r["m"], r["k"], r["n"]) == Q1B_HEADLINE)
    timings = {
        "quantize_rows": dict(max_abs_err=0.0, library_ms=None, shape="M={} K={} bf16 (down_proj's input, 8 pages)"
                              .format(*Q1A_HEADLINE), **{k: down_in[k] for k in ("ms", "plain_ms", "bound_ms",
                                                                               "bound_by")},
                              shapes=rows, launches_query_forward=per_forward["query forward"]["quantize_rows"],
                              launches_page_forward=per_forward["page forward"]["quantize_rows"]),
        "int8_gemm": dict(max_abs_err=0.0, shape="M={} K={} N={} bf16 out (gate/up, 8 pages)".format(*Q1B_HEADLINE),
                          **{k: gate[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                                  "bf16_linear_ms")},
                          library="torch._int_mm + the epilogue as PyTorch ops", shapes=gemms,
                          launches_query_forward=per_forward["query forward"]["int8_gemm"],
                          launches_page_forward=per_forward["page forward"]["int8_gemm"]),
    }
    extra = dict(layers=len(stored), weight_bytes_int8=bytes_int8, weight_bytes_bf16=bytes_bf16,
                 load_seconds=t_load, load_peak_gib=load_peak, held_gib=held, accuracy=accuracy, end_to_end=e2e,
                 page_profile=profile, q1_checks=checks, pages_per_min_served=PAGES / t_embed * 60)
    return launches, timings, extra


# -- phase 18: pooled ingestion and the offline corpus tools (run right after phase 7) -----------------------

POOL_PAGES = 32  # four batches of 8; the last two embed through prompt=
POOL_PROMPT = "<image><bos>Describe the chart."  # as long as the default prompt: 1,029 tokens a page
POOL_TOKENS = 1_029  # a page's tokens (1,024 image tokens and the prompt's 5), and each filler doc's
POOL_FACTOR = 3
POOL_DOC_TOKENS = 352  # 1,029 // 3 = 343 pooled tokens, rounded up to 16
POOL_COARSE = 2  # the sketch pools 2 pooled tokens: 176 groups of 4 words
POOL_INDEX_DOCS = 1_024  # the pages and seeded filler docs of 1,029 unit tokens, pooled alike
POOL_FILLER_FIRST = 496  # filler docs added before the pages (the rest after them), each in one add()
POOL_PLANTED = (1, 5, 9, 13, 17, 21, 25, 29)  # pages found by their own first PAGE_QUERY_TOKENS tokens
WARD_REGIME = ((24, 37, 48), (2, 3), (16, 128), 3)  # JAX's tests/compression/test_device_ward.py: lengths,
# pool factors, dims (theirs 16), draws
WARD_PAGE_DOCS = 8  # random unit docs of 1,029 x 128, beside the 32 pages
CORPUS_PAGES = 16  # the pages embed_corpus reads as PNG files
CORPUS_PLANTED = tuple(range(0, CORPUS_PAGES, 2))
DENSE_DOCS = 1_024  # dense vectors mined through the index of 1-token docs
POOL_KERNELS = ("binary_maxsim", "gather_rerank", "maxsim_int8", "flash_attention", "quantize_rows", "int8_gemm")


def unit_docs(rng, lens, dim: int) -> list:
    docs = [rng.normal(size=(n, dim)).astype(np.float32) for n in lens]
    return [d / np.linalg.norm(d, axis=-1, keepdims=True) for d in docs]


def partitions(maps: list) -> list:
    """Each doc's clusters as a set of frozensets of token indices."""
    return [{frozenset(v[0].tolist()) for v in m.values() if len(v[0])} for m in maps]


def first_differing_merge(x: np.ndarray, device_pairs: np.ndarray, z: np.ndarray) -> dict:
    """Where the device's Ward on one document (``x (T, D)`` fp32, its merges
    ``(n_merges, 2)`` as recorded) and scipy's (its linkage ``z``, float64
    from the fp32 similarities) first merge different clusters: both
    candidates' Ward distances in float64 from the observations ``1 - sim``,
    their relative gap, and whether a token of either pair has an exact
    duplicate in the document."""
    t = x.shape[0]
    obs = 1.0 - (x.astype(np.float64) @ x.astype(np.float64).T)
    dev = {i: frozenset([i]) for i in range(t)}
    sci = {i: frozenset([i]) for i in range(t)}
    for step, (i, j) in enumerate(device_pairs.tolist()):
        a, b = int(z[step, 0]), int(z[step, 1])
        pair_dev, pair_sci = {dev[i], dev[j]}, {sci[a], sci[b]}
        if pair_dev != pair_sci:
            def ward(p, q):
                p, q = sorted(p), sorted(q)
                gap = obs[p].mean(axis=0) - obs[q].mean(axis=0)
                return float(np.sqrt(2 * len(p) * len(q) / (len(p) + len(q))) * np.linalg.norm(gap))

            w_dev, w_sci = ward(*pair_dev), ward(*pair_sci)
            same_rows = {}
            for tok in range(t):
                same_rows.setdefault(x[tok].tobytes(), []).append(tok)
            duplicated = {tok for group in same_rows.values() if len(group) > 1 for tok in group}
            return dict(step=step, device=w_dev, scipy=w_sci, relative_gap=abs(w_dev - w_sci) / max(w_sci, 1e-30),
                        duplicate_tokens=bool(duplicated & set().union(*pair_dev, *pair_sci)))
        dev[i] = dev[i] | dev.pop(j)
        sci[t + step] = sci.pop(a) | sci.pop(b)
    return dict(step=None)


def ward_at_page_scale(device: torch.device, docs: list, label: str) -> dict:
    """The device Ward (fp32, its merges recorded) against scipy's on
    ``docs`` (``HierarchicalTokenPooler``'s similarity products, linkage and
    maxclust cut, 8 documents at a time): the share of identical partitions
    and, for each doc that differs, :func:`first_differing_merge`. Not held:
    at T = 1,029 the fp32 Gram of ~530,000 pairs can err by more than the
    gap between the two nearest pairs."""
    from concurrent.futures import ThreadPoolExecutor

    from scipy.cluster.hierarchy import fcluster, linkage

    from colpali_tpu_torch.compression import HierarchicalTokenPooler
    from colpali_tpu_torch.compression import token_pooling as tp

    t = max(len(d) for d in docs)
    k = max(t // POOL_FACTOR, 1)
    x = torch.zeros((len(docs), t, docs[0].shape[1]), device=device)
    m = torch.zeros((len(docs), t), device=device)
    for i, d in enumerate(docs):
        x[i, : len(d)], m[i, : len(d)] = torch.from_numpy(d), 1
    record = torch.zeros((t - k, len(docs), 2), dtype=torch.long, device=device)
    with tp.exact_fp32_products():
        labels = tp._ward_merges(x, m, POOL_FACTOR, record).cpu().numpy()
    record = record.cpu().numpy()

    def scipy_ward(args):
        doc, sim = args
        z = linkage(1 - sim, metric="euclidean", method="ward")
        return z, fcluster(z, t=max(len(doc) // POOL_FACTOR, 1), criterion="maxclust")

    sims = HierarchicalTokenPooler(device="cpu")._batched_similarities(docs)
    with ThreadPoolExecutor(8) as ex:
        ref = list(ex.map(scipy_ward, zip(docs, sims)))

    def groups(row, n):
        out = {}
        for tok in range(n):
            out.setdefault(int(row[tok]), set()).add(tok)
        return {frozenset(g) for g in out.values()}

    same, differ = 0, []
    for i, (d, (z, cut)) in enumerate(zip(docs, ref)):
        n = len(d)
        if groups(labels[i], n) == groups(cut, n):
            same += 1
        else:
            differ.append(dict(doc=i, **first_differing_merge(d, record[: n - max(n // POOL_FACTOR, 1), i], z)))
    out = dict(docs=len(docs), identical=same, share=same / len(docs), differing=differ)
    log(f"  device Ward vs scipy at page scale, {label}: {same} of {len(docs)} partitions identical "
        f"({out['share']:.1%})" + "".join(
            f"; doc {r['doc']}: first differing merge at step {r['step']}, Ward distances {r['device']:.9g} "
            f"(device's pair) and {r['scipy']:.9g} (scipy's), relative gap {r['relative_gap']:.3g}, "
            f"{'a duplicate token in the pairs' if r['duplicate_tokens'] else 'no duplicate token'}"
            for r in differ if r.get("step") is not None))
    return out


def k123_at(index, q: torch.Tensor, held: dict, nq: int, label: str) -> dict:
    """K1-K3 timed on ``index`` beside their plain versions and bounds
    (``held``: :func:`hold_k123`'s errors and operands on the same index)."""
    np_, c, d = index.doc_tokens, index.padded_docs, index.dim
    npc, w = np_ // index.coarse_pool, d // 32
    qw, qv, cand, qi, qsc = (held[k] for k in ("qw", "qv", "cand", "qi", "qsc"))
    q1, qw1, qv1, cand1 = q[:1], qw[:1].contiguous(), qv[:1].contiguous(), cand[:1].contiguous()
    rows = {
        "binary_maxsim": dict(ms=time_ms(lambda: binary_maxsim_tiled(qw1, qv1, index._bwords, d)),
                              plain_ms=time_ms(lambda: binary_maxsim_tiled_plain(qw1, qv1, index._bwords, d), 2),
                              max_abs_err=held["k1_err"], **k1_bound(1, nq, c, npc, w),
                              ms_graph=graph_ms(lambda: binary_maxsim_tiled(qw1, qv1, index._bwords, d)),
                              shape=f"B=1 Nq={nq} W={w} Npc={npc} C={c} ({label})"),
        "gather_rerank": dict(ms=time_ms(lambda: gather_rerank_tiled(q1, index._store, index._scales, cand1)),
                              plain_ms=time_ms(lambda: gather_rerank_plain(q1, index._store, index._scales, cand1),
                                               2),
                              max_abs_err=held["k2_err"], **k2_bound(1, nq, cand.shape[1], np_, d, 1),
                              ms_graph=graph_ms(lambda: gather_rerank_tiled(q1, index._store, index._scales, cand1)),
                              shape=f"B=1 Nq={nq} c={cand.shape[1]} Np={np_} ({label})"),
        "maxsim_int8": dict(ms=time_ms(lambda: maxsim_int8mxu_tiled(qi, qsc, index._store, index._scales)),
                            plain_ms=time_ms(lambda: maxsim_int8mxu_tiled_plain(qi, qsc, index._store, index._scales),
                                             2),
                            max_abs_err=held["k3_err"],
                            **bound(c * np_ * (d + 4) + qi.shape[0] * nq * (d + 4) + qi.shape[0] * c * 4,
                                    2 * qi.shape[0] * nq * c * np_ * d, "int8"),
                            shape=f"B={qi.shape[0]} Nq={nq} Np={np_} C={c} ({label})"),
    }
    for name, r in rows.items():
        graph = f", from a CUDA graph {r['ms_graph']:.4f} ms" if "ms_graph" in r else ""
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.4f} ms{graph}, plain {r['plain_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}")
    return rows


def phase_pooling(device: torch.device, model, processor, smi: str, ckpt: str) -> tuple:
    """Drive pooled ingestion and the offline corpus tools on phase 3's
    ColPali-3B (bf16) and phase 7's checkpoint of it in ``ckpt``: (a) 32
    pages through the fused page pipeline (16 with ``prompt=``), their device
    embeddings pooled by 3 inside two ``DeviceIndexBuilder``s (Ward and
    k-means) with seeded filler to 1,024 docs each, two-tier int8 indexes at
    Np = 352 whose tiered and exact routes find each planted page at rank 1,
    K1-K3 held against their plain versions at that length and the MaxSim
    retention of each planted query; (b) the device Ward against scipy's,
    partition-identical in JAX's test regime and the share at page scale;
    (c) pooling timed beside the page forward; (d) ``embed_corpus`` (Ward on
    the host, a packed index, stored int8, the yuv420 wire) -> ``serve.py``
    booted from the index -> ``/search_text`` and ``/search``, then
    ``compute_hardnegs`` on its embeddings (MaxSim, and through the index:
    K3 at Np = 352) and on 1,024 dense vectors through the 1-token index (K3
    at Np = 16); (e) similarity maps of 4 pages against a float64 einsum;
    (f) the collator's ``device_pixels``. Returns the launches over the
    path, K1-K3's rows and the rest."""
    import os
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from colpali_tpu_torch import compute_hardnegs, embed_corpus, serve
    from colpali_tpu_torch.compression import (DeviceWardTokenPooler, HierarchicalTokenPooler, kmeans_pool_padded,
                                               ward_pool_padded)
    from colpali_tpu_torch.compression import token_pooling as tp
    from colpali_tpu_torch.data.collator import VisualRetrieverCollator
    from colpali_tpu_torch.interpretability import get_similarity_maps_from_embeddings, normalize_similarity_map
    from colpali_tpu_torch.retrieval.ingest import fused_page_batches
    from colpali_tpu_torch.retrieval.store import CorpusIndex, DeviceIndexBuilder
    from colpali_tpu_torch.training.trainer import to_device

    t_phase = time.perf_counter()
    extra = {}
    path = dict.fromkeys(POOL_KERNELS, 0)

    def counted(fn, *args):
        """``fn(*args)`` on the path: its launches are added to the path's count."""
        reset_launches()
        out = fn(*args)
        torch.cuda.synchronize()
        for name in POOL_KERNELS:
            path[name] += KERNELS[name]["counter"].launches
        return out

    # -- (a) embed -> pool -> index on the card, Ward and k-means ------------------------------------------
    pages = make_pages(POOL_PAGES, SEED + 180)
    gen = torch.Generator(device=device).manual_seed(SEED + 181)
    builders = {method: DeviceIndexBuilder(doc_tokens=POOL_DOC_TOKENS, dim=DIM, dtype="int8", prefilter="binary",
                                           coarse_pool=POOL_COARSE, pool_factor=POOL_FACTOR, pool_method=method)
                for method in ("ward", "kmeans")}
    batches, page_ids = [], []

    def ingest():
        def add(emb, mask=None):
            for builder in builders.values():
                builder.add(emb, mask)

        def filler(n):
            x = torch.randn((n, POOL_TOKENS, DIM), generator=gen, device=device)
            add(x / x.norm(dim=-1, keepdim=True))
            return n

        n_docs = filler(POOL_FILLER_FIRST)
        half = POOL_PAGES // 2
        for prompt, chunk in ((None, pages[:half]), (POOL_PROMPT, pages[half:])):
            for emb, att in fused_page_batches(model, processor, chunk, transport="yuv420", batch_size=PAGE_BATCH,
                                               prompt=prompt):
                add(emb, att)  # the forward's device tensors, pooled inside the builders
                page_ids.extend(range(n_docs, n_docs + emb.shape[0]))
                n_docs += emb.shape[0]
                batches.append((emb, att))
        filler(POOL_INDEX_DOCS - n_docs)
        return {method: builder.build() for method, builder in builders.items()}

    t0 = time.perf_counter()
    indexes = counted(ingest)
    t_ingest = time.perf_counter() - t0
    rows = [e[a.bool()].float().cpu().numpy() for emb, att in batches for e, a in zip(emb, att)]
    if len(rows) != POOL_PAGES or any(r.shape != (POOL_TOKENS, DIM) or not np.isfinite(r).all() for r in rows):
        raise AssertionError(f"page embeddings: {[r.shape for r in rows]}")
    queries = [rows[p][:PAGE_QUERY_TOKENS] for p in POOL_PLANTED]
    planted = [page_ids[p] for p in POOL_PLANTED]

    def search_all():
        found = {}
        for method, index in indexes.items():
            tiered = [int(index.search([q], k=10)[1][0, 0]) for q in queries]  # one query a search
            scores, ids = index.exact_search(queries, k=10)
            found[method] = dict(tiered=tiered, exact=ids[:, 0].tolist(), exact_scores=scores[:, 0])
        return found

    found = counted(search_all)
    for method, index in indexes.items():
        if index.doc_tokens != POOL_DOC_TOKENS or index.num_docs != POOL_INDEX_DOCS:
            raise AssertionError(f"{method} index: {index.num_docs} docs x {index.doc_tokens}, expected "
                                 f"{POOL_INDEX_DOCS} x {POOL_DOC_TOKENS}")
        if found[method]["tiered"] != planted or found[method]["exact"] != planted:
            raise AssertionError(f"{method} pooled index, rank 1: tiered {found[method]['tiered']}, exact "
                                 f"{found[method]['exact']}, planted {planted}")
    unpooled_bytes = indexes["ward"].nbytes * PAGE_DOC_TOKENS // POOL_DOC_TOKENS  # every array is linear in Np
    log(f"phase pooling: {POOL_PAGES} pages of {PAGE_HW[1]} x {PAGE_HW[0]} ({rows[0].shape[0]} tokens; {POOL_PAGES // 2} "
        f"with prompt={POOL_PROMPT!r}) through the fused page pipeline, their device embeddings and "
        f"{POOL_INDEX_DOCS - POOL_PAGES} seeded unit filler docs pooled by {POOL_FACTOR} inside DeviceIndexBuilder "
        f"(Ward and k-means) in {t_ingest:.1f} s; two-tier int8 indexes of {POOL_INDEX_DOCS} docs x {POOL_DOC_TOKENS} "
        f"(sketch pooled by {POOL_COARSE}): {indexes['ward'].nbytes} bytes each, {unpooled_bytes} unpooled at "
        f"Np={PAGE_DOC_TOKENS}; each of {len(planted)} planted pages at rank 1 on the tiered and the exact route of "
        "both")

    # K1-K3 against their plain versions at Np = 352 (not counted)
    q = served_queries(queries[:4], device)
    held = {method: hold_k123(index, q) for method, index in indexes.items()}
    timings = k123_at(indexes["ward"], q, held["ward"], SERVED_TOKENS, f"the Ward-pooled page index")

    # the MaxSim retention of each planted query: its score on the pooled page over its score on the page
    retention = {}
    x = torch.from_numpy(np.stack([rows[p] for p in POOL_PLANTED])).to(device)
    qx = torch.from_numpy(np.stack(queries)).to(device)
    for method, fn in (("ward", ward_pool_padded), ("kmeans", kmeans_pool_padded)):
        pooled = fn(x, torch.ones(x.shape[:2], device=device), POOL_FACTOR)[0]
        with tp.exact_fp32_products():
            ratios = (torch.bmm(qx, pooled.transpose(1, 2)).amax(2).sum(1) /
                      torch.bmm(qx, x.transpose(1, 2)).amax(2).sum(1)).tolist()
        retention[method] = ratios
        log(f"  MaxSim retention, {method}: " + ", ".join(f"{r:.4f}" for r in ratios)
            + f" (mean {np.mean(ratios):.4f}); the index's exact score of the planted page "
            + ", ".join(f"{s:.2f}" for s in found[method]["exact_scores"]) + f" of {PAGE_QUERY_TOKENS}")
    extra.update(ingest_s=t_ingest, index_bytes=indexes["ward"].nbytes, index_bytes_unpooled=unpooled_bytes,
                 retention=retention, k123_errors={m: {k: h[k] for k in ("k1_err", "k2_err", "k3_err")}
                                                   for m, h in held.items()})
    del indexes, held, builders
    torch.cuda.empty_cache()

    # -- (b) the device Ward against scipy's ----------------------------------------------------------------
    lens, factors, dims, draws = WARD_REGIME
    rng = np.random.default_rng(SEED + 182)
    regime = 0
    for dim in dims:
        for pool_factor in factors:
            for _ in range(draws):
                docs = unit_docs(rng, lens, dim)
                got = DeviceWardTokenPooler(device=device).pool_embeddings(docs, pool_factor=pool_factor,
                                                                           return_dict=True)
                want = HierarchicalTokenPooler(device="cpu").pool_embeddings(docs, pool_factor=pool_factor,
                                                                             return_dict=True)
                if partitions(got.cluster_id_to_indices) != partitions(want.cluster_id_to_indices):
                    raise AssertionError(f"device Ward vs scipy, docs of {lens} tokens at dim {dim}, pool factor "
                                         f"{pool_factor}: the partitions differ")
                regime += len(docs)
    log(f"  device Ward vs scipy's HierarchicalTokenPooler: {regime} random unit docs of {lens} tokens at dims "
        f"{dims} and pool factors {factors}, every partition identical")
    extra["ward_vs_scipy"] = dict(
        regime_docs=regime,
        random=ward_at_page_scale(device, unit_docs(rng, [POOL_TOKENS] * WARD_PAGE_DOCS, DIM),
                                  f"{WARD_PAGE_DOCS} random unit docs"),
        pages=ward_at_page_scale(device, rows, f"the {POOL_PAGES} pages"))

    # -- (c) pooling timed beside the page forward ----------------------------------------------------------
    emb, att = batches[0]
    tok = processor._tokenize([processor._expand_image_prompt(processor.visual_prompt_prefix)] * PAGE_BATCH)
    feed = dict(input_ids=torch.from_numpy(tok["input_ids"]).to(device),
                attention_mask=torch.from_numpy(tok["attention_mask"]).to(device),
                pixel_values=torch.rand((PAGE_BATCH, processor.image_size, processor.image_size, 3), generator=gen,
                                        device=device) * 2 - 1)
    t = dict(forward_ms=forward_ms(model, feed),
             ward_ms=time_ms(lambda: ward_pool_padded(emb, att, POOL_FACTOR), reps=1),
             kmeans_ms=time_ms(lambda: kmeans_pool_padded(emb, att, POOL_FACTOR), reps=2))
    t.update(pages_per_min_ward=PAGE_BATCH / (t["forward_ms"] + t["ward_ms"]) * 6e4,
             pages_per_min_kmeans=PAGE_BATCH / (t["forward_ms"] + t["kmeans_ms"]) * 6e4,
             pages_per_min_unpooled=PAGE_BATCH / t["forward_ms"] * 6e4)
    log(f"  pooling one batch of {PAGE_BATCH} pages ({smi}): Ward {t['ward_ms']:.1f} ms, k-means {t['kmeans_ms']:.1f} "
        f"ms, the bf16 forward {t['forward_ms']:.1f} ms; forward and pooling {t['pages_per_min_ward']:.0f} pages/min "
        f"(Ward), {t['pages_per_min_kmeans']:.0f} (k-means), {t['pages_per_min_unpooled']:.0f} unpooled, from the "
        "pieces' times")

    def ingest_rate(factor: int, method: str = "ward") -> float:
        """Pages/min of the loop a user runs: the fused page pipeline (host staging on its prefetch thread, the
        upload, the forward) feeding a builder's add() (pooling, quantizing, packing), wall time to the last add."""
        builder = DeviceIndexBuilder(doc_tokens=POOL_DOC_TOKENS if factor > 1 else PAGE_DOC_TOKENS, dim=DIM,
                                     dtype="int8", prefilter="binary", coarse_pool=POOL_COARSE, pool_factor=factor,
                                     pool_method=method)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for emb, att in fused_page_batches(model, processor, pages, transport="yuv420", batch_size=PAGE_BATCH):
            builder.add(emb, att)
        torch.cuda.synchronize()
        return len(pages) / (time.perf_counter() - t0) * 60

    t.update(ingest_pages_per_min_ward=ingest_rate(POOL_FACTOR), ingest_pages_per_min_kmeans=ingest_rate(
        POOL_FACTOR, "kmeans"), ingest_pages_per_min_unpooled=ingest_rate(1))
    log(f"  the fused page pipeline feeding DeviceIndexBuilder.add() end to end over {POOL_PAGES} pages ({smi}): "
        f"{t['ingest_pages_per_min_ward']:.0f} pages/min pooled by Ward, {t['ingest_pages_per_min_kmeans']:.0f} by "
        f"k-means, {t['ingest_pages_per_min_unpooled']:.0f} unpooled")
    extra["timing"] = t
    del feed

    # -- (d) the entry points: embed_corpus -> packed index -> serve.py; compute_hardnegs --------------------
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(f"{tmp}/pages")
        with ThreadPoolExecutor(8) as ex:  # PIL's encoder lets go of the interpreter
            list(ex.map(lambda i: Image.fromarray(pages[i]).save(f"{tmp}/pages/page_{i:02d}.png", compress_level=0),
                        range(CORPUS_PAGES)))
        out, idx = f"{tmp}/corpus.npz", f"{tmp}/index.npz"
        t0 = time.perf_counter()
        counted(embed_corpus.main, ["colpali", ckpt, f"{tmp}/pages", out, "--pool-factor", str(POOL_FACTOR),
                                    "--pooler", "ward", "--save-index", idx, "--index-prefilter",
                                    "--index-coarse-pool", str(POOL_COARSE), "--quantize", "--transport", "yuv420",
                                    "--device", str(device)])
        t_corpus = time.perf_counter() - t0
        pooled = compute_hardnegs.load_embeddings(out)
        if len(pooled) != CORPUS_PAGES or any(len(e) > POOL_DOC_TOKENS or not np.isfinite(e).all() for e in pooled):
            raise AssertionError(f"embed_corpus: {[e.shape for e in pooled]}")
        corpus_q = [pooled[i][:PAGE_QUERY_TOKENS] for i in CORPUS_PLANTED]
        t0 = time.perf_counter()
        httpd = counted(serve.make_server, [idx, "--port", "0", "--checkpoint", ckpt, "--family", "colpali",
                                            "--device", str(device)])
        t_serve = time.perf_counter() - t0
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_port}"

        def requests():
            text = _http(url, "/search_text", {"queries": QUERIES[:2], "k": 5})
            tiered = [_http(url, "/search", {"embeddings": [q.tolist()], "k": 5}) for q in corpus_q[:4]]
            exact = _http(url, "/search", {"embeddings": [q.tolist() for q in corpus_q], "k": 5})  # 8 > 4: exact
            return text, tiered, exact

        try:
            text, tiered, exact = counted(requests)
        finally:
            httpd.shutdown()
            httpd.server_close()
        _check_ranked("/search_text (the packed index)", text, 2)
        top = ([r["doc_ids"][0][0] for r in tiered], [row[0] for row in exact["doc_ids"]])
        if top[0] != list(CORPUS_PLANTED[:4]) or top[1] != list(CORPUS_PLANTED):
            raise AssertionError(f"serve.py on embed_corpus's index, rank 1: tiered {top[0]}, exact {top[1]}, "
                                 f"planted {list(CORPUS_PLANTED)}")
        log(f"  embed_corpus (Ward on the host, stored int8, yuv420) over {CORPUS_PAGES} PNG pages in {t_corpus:.1f} "
            f"s: {sum(len(e) for e in pooled)} pooled tokens; serve.py booted from its packed index with "
            f"--checkpoint in {t_serve:.1f} s answered /search_text and found each planted page at rank 1 through "
            "/search (tiered and exact)")

        np.savez(f"{tmp}/queries.npz", **{f"emb_{i}": q_ for i, q_ in enumerate(corpus_q)})
        with open(f"{tmp}/gold.json", "w") as f:
            json.dump(list(CORPUS_PLANTED), f)
        drng = np.random.default_rng(SEED + 183)
        dense = drng.normal(size=(DENSE_DOCS, DIM)).astype(np.float32)
        dense /= np.linalg.norm(dense, axis=-1, keepdims=True)
        dense_gold = [int(g) for g in drng.choice(DENSE_DOCS, 64, replace=False)]
        dense_q = dense[dense_gold] + 0.3 * drng.normal(size=(64, DIM)).astype(np.float32) / np.sqrt(DIM)
        np.savez(f"{tmp}/dense_docs.npz", embeddings=dense)
        np.savez(f"{tmp}/dense_queries.npz", embeddings=dense_q)
        with open(f"{tmp}/dense_gold.json", "w") as f:
            json.dump(dense_gold, f)
        mined = {}
        for name, args in (("maxsim", [f"{tmp}/queries.npz", out, f"{tmp}/gold.json", "--multi-vector"]),
                           ("maxsim via index", [f"{tmp}/queries.npz", out, f"{tmp}/gold.json", "--multi-vector",
                                                 "--via-index"]),
                           ("dense", [f"{tmp}/dense_queries.npz", f"{tmp}/dense_docs.npz", f"{tmp}/dense_gold.json"]),
                           ("dense via index", [f"{tmp}/dense_queries.npz", f"{tmp}/dense_docs.npz",
                                                f"{tmp}/dense_gold.json", "--via-index"])):
            jsonl = f"{tmp}/{name.replace(' ', '_')}.jsonl"
            counted(compute_hardnegs.main, [*args[:3], jsonl, *args[3:], "--device", str(device)])
            with open(jsonl) as f:
                mined[name] = [json.loads(line) for line in f]
        for name, res in mined.items():
            gold = CORPUS_PLANTED if name.startswith("maxsim") else dense_gold
            if not all(r["gold_in_top_100"] for r in res) or any(g in r["negative_passages"] for g, r in zip(gold, res)):
                raise AssertionError(f"compute_hardnegs ({name}): a gold doc missed the top 100 or is a negative")
        overlap = {kind: float(np.mean([len(set(a["negative_passages"][:10]) & set(b["negative_passages"][:10])) / 10
                                        for a, b in zip(mined[kind], mined[f"{kind} via index"])]))
                   for kind in ("maxsim", "dense")}
        log(f"  compute_hardnegs: every gold page in the top 100 and no gold id among the negatives, MaxSim over the "
            f"{CORPUS_PAGES} pooled pages ({len(CORPUS_PLANTED)} queries) and {DENSE_DOCS} dense vectors (64 queries), "
            f"each on the score matrix and through an int8 index (K3 at Np={POOL_DOC_TOKENS} and, 1-token docs, "
            f"Np=16); top-10 negatives shared by the two routes {overlap['maxsim']:.1%} (MaxSim) and "
            f"{overlap['dense']:.1%} (dense)")
        extra.update(embed_corpus_s=t_corpus, serve_start_s=t_serve, hardneg_top10_overlap=overlap)
        # K3 at Np = 16 (dense vectors as 1-token docs), timed apart
        index16 = CorpusIndex(list(dense[:, None]), dtype="int8", device=device)
        qi, qsc = quantize_per_token(torch.from_numpy(dense_q[:8, None]).to(device))
        got16 = maxsim_int8mxu_tiled(qi, qsc, index16._store, index16._scales)
        want16 = maxsim_int8mxu_tiled_plain(qi, qsc, index16._store, index16._scales)
        torch.testing.assert_close(got16, want16, rtol=RTOL, atol=ATOL)
        c16 = index16.padded_docs
        timings["maxsim_int8"]["one_token_docs"] = r16 = dict(
            ms=time_ms(lambda: maxsim_int8mxu_tiled(qi, qsc, index16._store, index16._scales)),
            ms_graph=graph_ms(lambda: maxsim_int8mxu_tiled(qi, qsc, index16._store, index16._scales)),
            plain_ms=time_ms(lambda: maxsim_int8mxu_tiled_plain(qi, qsc, index16._store, index16._scales), 2),
            max_abs_err=(got16 - want16).abs().max().item(),
            **bound(c16 * 16 * (DIM + 4) + 8 * (DIM + 4) + 8 * c16 * 4, 2 * 8 * 1 * c16 * 16 * DIM, "int8"),
            shape=f"B=8 Nq=1 Np=16 C={c16} (dense vectors as 1-token docs)")
        log(f"  maxsim_int8 [{r16['shape']}]: kernel {r16['ms']:.4f} ms, from a CUDA graph {r16['ms_graph']:.4f} ms, "
            f"plain {r16['plain_ms']:.3f} ms, bound {r16['bound_ms']:.5f} ms ({r16['bound_by']}), max_abs_err "
            f"{r16['max_abs_err']:.3g}")
        del index16

    launches = {name: n for name, n in path.items()}
    if not all(launches.values()):
        raise AssertionError(f"pooling phase: a kernel of the path was not launched: {launches}")

    # -- (e) similarity maps of 4 pages --------------------------------------------------------------------
    image = batches[0][0][:4].float().cpu().numpy()
    mask = processor.get_image_mask({"input_ids": tok["input_ids"][:4]})
    qmaps = np.stack([rows[p][:PAGE_QUERY_TOKENS] for p in range(4)])
    n_patches = processor.get_n_patches(PAGE_HW)
    maps = get_similarity_maps_from_embeddings(image, qmaps, n_patches, mask)
    err = 0.0
    for i, m in enumerate(maps):
        grid = image[i][mask[i]].astype(np.float64).reshape(n_patches[1], n_patches[0], -1)  # (y, x, dim)
        want = np.einsum("nd,yxd->nxy", qmaps[i].astype(np.float64), grid)
        err = max(err, float(np.abs(m - want).max()))
    norm = normalize_similarity_map(maps[0])
    side = processor.image_size // 14  # SigLIP's 14 px patches: 32 a side at 448 px
    if n_patches != (side, side) or maps[0].shape != (qmaps.shape[1], side, side) or err > 1e-5 or \
            not (norm.min() >= 0.0 and 0.999 <= norm.max() <= 1.0):
        raise AssertionError(f"similarity maps: n_patches {n_patches}, {maps[0].shape}, error {err} against a float64 "
                             f"einsum, normalized range {norm.min()}..{norm.max()}")
    log(f"  similarity maps of 4 pages ({n_patches[0]} x {n_patches[1]} patches, {PAGE_QUERY_TOKENS} query tokens): "
        f"within {err:.3g} of a float64 einsum (limit 1e-5); normalized to {norm.min():.3g}..{norm.max():.6f}")

    # -- (f) the collator's device pixels ------------------------------------------------------------------
    examples = [{"query": QUERIES[i], "pos_target": pages[i]} for i in range(PAGE_BATCH)]
    batch = VisualRetrieverCollator(processor, device_pixels=True)(examples)
    pix = batch["doc_pixel_values"]
    ref = processor.process_images(pages[:PAGE_BATCH], host_resize=True)["pixel_values"]
    pix_err = float(np.abs(pix.cpu().numpy() - ref).max()) if isinstance(pix, torch.Tensor) else None
    fed = to_device(batch, device)
    with torch.inference_mode():
        out_ = model(input_ids=fed["doc_input_ids"], attention_mask=fed["doc_attention_mask"],
                     pixel_values=fed["doc_pixel_values"])
    if not isinstance(pix, torch.Tensor) or pix.device.type != device.type or pix_err > 1e-6 or \
            fed["doc_pixel_values"] is not pix or not torch.isfinite(out_).all():
        raise AssertionError(f"collator device_pixels: {type(pix)} on {getattr(pix, 'device', None)}, error {pix_err}")
    log(f"  VisualRetrieverCollator(device_pixels=True): {PAGE_BATCH} pages' pixel_values a tensor on {pix.device} within "
        f"{pix_err:.3g} of the processor's host-resize pixels (limit 1e-6), taken by to_device as it is; one forward "
        f"{tuple(out_.shape)}")
    log(f"  path launches {launches}; phase {time.perf_counter() - t_phase:.1f} s")
    del batches, batch, fed, out_
    torch.cuda.empty_cache()
    return launches, timings, extra


# -- phase 8: the Qwen2-VL family (run after phase 7) ----------------------------------

# Published widths: Qwen2.5-VL-3B (Qwen/Qwen2.5-VL-3B-Instruct config.json: vision 32 x 1,280, 16 heads, MLP 3,420,
# 112 px windows, full attention in blocks 7/15/23/31, out 2,048; text 36 x 2,048, 16/2 heads x 128, MLP 11,008) and
# Qwen2-VL-2B (Qwen/Qwen2-VL-2B-Instruct: vision 32 x 1,280, quick_gelu MLP 5,120, out 1,536; text 28 x 1,536,
# 12/2 heads x 128, MLP 8,960); vocab 151,936. Weights are random, from SEED. Phases 8-9 run them cut in depth, to
# keep the script's time with phases 14-15: ColQwen2.5-3B to 8 vision blocks (block 7 full
# attention, the published one in 8) and 9 text layers, ColQwen2-2B to 8 and 7
QWEN25_DEPTHS, QWEN2_DEPTHS = (8, 9), (8, 7)  # (vision blocks, text layers); published (32, 36) and (32, 28)
QWEN_PAGES = 16  # two batches of 8
QWEN_PLANTED = (1, 6, 10, 13)  # pages whose docs also hold QUERIES[i]'s tokens, i = 0..3
QWEN_FILLER_DOCS = 4_096
QWEN_PAGE_TOKENS = 744  # merged tokens of a 1,275 x 1,650 page at the 768-token budget: 868 x 672 px, 62 x 48 patches
Q1_QWEN25_SHAPES = ((1176, 1280), (1280, 1280), (1280, 3420), (3420, 1280), (5120, 5120), (5120, 2048),
                    (2048, 2048), (2048, 11008), (11008, 2048))  # patch embed, q/k/v/o, gate/up, down, merger; text
Q1_QWEN2_SHAPES = ((1280, 5120), (5120, 1280), (5120, 1536), (1536, 1536), (1536, 8960), (8960, 1536))
Q1_QWEN2_ROWS = (1, 17, 256)  # ColQwen2-2B runs in bf16 in phase 8: its other (K, N) are held at these M


def q1_path_shapes(model, run) -> list:
    """The distinct (M, K, N) of ``model``'s stored-int8 layers' calls while
    ``run()`` runs, in the order they first come."""
    from colpali_tpu_torch.models.layers import QDense

    seen = {}

    def record(layer, args, out):
        x = args[0]
        seen.setdefault((x.numel() // x.shape[-1], x.shape[-1], out.shape[-1]), None)

    hooks = [m.register_forward_hook(record) for m in model.modules() if isinstance(m, QDense) and m.stored]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return list(seen)


def qwen_configs():
    """ColQwen2.5-3B and ColQwen2-2B at their published widths, cut to :data:`QWEN25_DEPTHS` and
    :data:`QWEN2_DEPTHS`."""
    from colpali_tpu_torch.models.qwen2_5_vl import Qwen25VLConfig, Qwen25VLVisionConfig
    from colpali_tpu_torch.models.qwen2_vl import Qwen2TextConfig, Qwen2VLConfig, Qwen2VLVisionConfig

    (v25, t25), (v2, t2) = QWEN25_DEPTHS, QWEN2_DEPTHS
    qwen25 = Qwen25VLConfig(vision=Qwen25VLVisionConfig(depth=v25, fullatt_block_indexes=(v25 - 1,)),
                            text=Qwen2TextConfig(hidden_size=2048, intermediate_size=11008, num_hidden_layers=t25,
                                                 num_attention_heads=16, num_key_value_heads=2))
    return qwen25, Qwen2VLConfig(vision=Qwen2VLVisionConfig(depth=v2), text=Qwen2TextConfig(num_hidden_layers=t2))


def qwen25_stored_layers(cfg) -> int:
    """ColQwen2.5's stored-int8 layers: the patch embedding, 7 a vision block, the merger's 2, 5 a text layer (its
    k/v, 2,048 -> 256, and the 128-d head stay bf16)."""
    return 1 + cfg.vision.depth * 7 + 2 + cfg.text.num_hidden_layers * 5


def qwen_tokenizer():
    """A word-level tokenizer over the prompts' and QUERIES' words with Qwen2's special tokens at their ids."""
    from colpali_tpu_torch.processors.qwen2_vl import ColQwen2Processor
    from colpali_tpu_torch.utils.testing import qwen_word_tokenizer

    words = ColQwen2Processor.visual_prompt_prefix.replace("\n", " ").split() + " ".join(QUERIES).split()
    return qwen_word_tokenizer([w for w in words if "<|" not in w])


def share(gap: float, limit: float) -> str:
    """A check's reading as a share of its limit, both as gaps (1 - cosine, or an error)."""
    return f"{gap / limit:.1%} of its limit" if limit > 0 else "n/a"


def cos_check(name: str, got: list, want: list, cos_mean: float, cos_min: float, max_abs=None) -> dict:
    """:func:`per_token`, with each reading's share of its limit printed."""
    out = per_token(name, got, want, cos_mean, cos_min)
    if max_abs is not None and out["max_abs"] > max_abs:
        raise AssertionError(f"{name}: max abs {out['max_abs']} > {max_abs}")
    log(f"    shares of the limits: mean cos {share(1 - out['mean_cos'], 1 - cos_mean)}, min cos "
        f"{share(1 - out['min_cos'], 1 - cos_min)}" + (f", max abs {share(out['max_abs'], max_abs)}"
                                                       if max_abs is not None else ""))
    return out


def qwen_k6_cases(device: torch.device, batch: dict, cfg25, cfg2, encoder_feed: dict) -> dict:
    """K6 against its plain version at the Qwen family's shapes: the vision
    tower over 8 pages (full attention, and Qwen2.5's 64-patch windows
    interleaved in merge order), the decoder over the pages' prompts (causal,
    with left padding cut into the rows), GQA 16/2 (Qwen2.5-3B) and 12/2
    (Qwen2-2B), and the queries as the query encoder pads them."""
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    v, t25, t2 = cfg25.vision, cfg25.text, cfg2.text
    mask = torch.as_tensor(batch["patch_mask"], device=device)
    b, s = mask.shape
    window = torch.as_tensor(batch["window_id"], device=device).to(torch.int32).contiguous()
    full = torch.where(mask, 1, -1).to(torch.int32).contiguous()
    s_text = batch["input_ids"].shape[1]
    left = (torch.arange(s_text, device=device)[None] >= 8 * torch.arange(b, device=device)[:, None]).to(torch.int32)
    q_seg = torch.as_tensor(encoder_feed["attention_mask"], device=device).to(torch.int32).contiguous()
    cases = {
        "vision_full": (b, s, v.num_heads, v.num_heads, v.head_dim, None, full, False, " (Qwen2.5 full blocks)"),
        "vision_window": (b, s, v.num_heads, v.num_heads, v.head_dim, None, window, False,
                          f" ({int(window.max()) + 1} windows of 64 patches a page)"),
        "text_16_2": (b, s_text, t25.num_attention_heads, t25.num_key_value_heads, t25.head_dim, None, left, True,
                      " causal, rows left-padded by 0-56 (Qwen2.5-3B)"),
        "text_12_2": (b, s_text, t2.num_attention_heads, t2.num_key_value_heads, t2.head_dim, None, left, True,
                      " causal, rows left-padded by 0-56 (Qwen2-2B)"),
        "queries": (*q_seg.shape, t25.num_attention_heads, t25.num_key_value_heads, t25.head_dim, None, q_seg, True,
                    " causal, the query encoder's padding"),
    }
    out = {}
    for name, (bb, ss, h, hkv, d, lengths, seg, causal, label) in cases.items():
        r = k6_case(gen, device, bb, ss, h, hkv, d, lengths, seg=seg, causal=causal, label=label)
        extra = f", bound over all pairs {r['bound_ms_all_pairs']:.4f} ms" if "bound_ms_all_pairs" in r else ""
        log(f"phase qwen: K6 {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"{library_note(r)}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}, max_abs_err "
            f"{r['max_abs_err']:.3g} (atol {r['atol']:.3g}, {r['limit_share']:.0%} of the tolerance)")
        out[name] = r
    torch.cuda.empty_cache()
    return out


def build_qwen(cls, config, device: torch.device, directory: str, seed: int) -> int:
    """A seeded random bf16 model at full width, written as an HF checkpoint
    (the port's exporter and a word-level tokenizer) and freed. Returns its
    parameter count."""
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.utils.testing import write_qwen_checkpoint

    model = cls(config, dim=DIM, device=device, dtype=torch.bfloat16)
    hf_init_(model, torch.Generator(device=device).manual_seed(seed))
    n = sum(p.numel() for p in model.parameters())
    write_qwen_checkpoint(directory, model, qwen_tokenizer())
    del model
    torch.cuda.empty_cache()
    return n


def phase_qwen(device: torch.device, smi: str, ckpt: str) -> tuple:
    """Drive the Qwen2-VL family's serving path: ColQwen2.5-3B written as an
    HF checkpoint in ``ckpt`` (kept for phase 9) and read back by ``load_retriever`` in bf16 and stored int8,
    pages through ``embed_dataset``, ``/search_text`` through ``make_handler``
    and ``serve.py --checkpoint --family colqwen2_5``; then ColQwen2-2B's route
    check. Returns the launches over the path, the new kernel rows and the
    rest."""
    import tempfile
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.evaluation.evaluator import embed_dataset
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.models.qwen2_5_vl import ColQwen2_5
    from colpali_tpu_torch.models.qwen2_vl import ColQwen2
    from colpali_tpu_torch.processors.qwen2_5_vl import ColQwen2_5Processor
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.retrieval.store import CorpusIndex

    cfg25, cfg2 = qwen_configs()
    pages = make_pages(QWEN_PAGES, SEED + 31)
    proc = ColQwen2_5Processor(qwen_tokenizer(), max_num_visual_tokens=768, device=device)
    shape_batch = proc.process_images(pages[:PAGE_BATCH])
    n_merged = int((shape_batch["input_ids"] == proc.image_token_id).sum(1).max())
    if n_merged != QWEN_PAGE_TOKENS or shape_batch["patch_mask"].shape[1] != 4 * QWEN_PAGE_TOKENS:
        raise AssertionError(f"a {PAGE_HW[1]} x {PAGE_HW[0]} page: {n_merged} merged tokens, "
                             f"{shape_batch['patch_mask'].shape[1]} patches; expected {QWEN_PAGE_TOKENS}")
    extra = {}
    with contextlib.nullcontext(ckpt) as tmp:
        t0 = time.perf_counter()
        n_params = build_qwen(ColQwen2_5, cfg25, device, tmp, SEED + 32)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        model, processor = load_retriever(tmp, family="colqwen2_5", device=device)
        torch.cuda.synchronize()
        t_bf16 = time.perf_counter() - t0
        t0 = time.perf_counter()
        qmodel, qproc = load_retriever(tmp, family="colqwen2_5", device=device, quantize=True)
        torch.cuda.synchronize()
        t_int8 = time.perf_counter() - t0
        stored = sum(isinstance(m, QDense) and m.stored for m in qmodel.modules())
        bytes_int8, bytes_bf16 = (sum(t.numel() * t.element_size() for t in m.state_dict().values())
                                  for m in (qmodel, model))
        log(f"phase qwen: ColQwen2.5-3B, vision {cfg25.vision.depth} x {cfg25.vision.hidden_size} (MLP "
            f"{cfg25.vision.intermediate_size}, {cfg25.vision.num_heads} heads x {cfg25.vision.head_dim}, windows of "
            f"{cfg25.vision.window_size} px, full blocks {cfg25.vision.fullatt_block_indexes}, out "
            f"{cfg25.vision.out_hidden_size}), text {cfg25.text.num_hidden_layers} x {cfg25.text.hidden_size} (MLP "
            f"{cfg25.text.intermediate_size}, heads {cfg25.text.num_attention_heads}/{cfg25.text.num_key_value_heads} "
            f"x {cfg25.text.head_dim}, vocab {cfg25.text.vocab_size}): {n_params / 1e9:.3f} B params; HF checkpoint "
            f"written in {t_write:.1f} s, load_retriever {t_bf16:.1f} s (bf16), {t_int8:.1f} s (quantize=True: "
            f"{stored} stored-int8 layers, {bytes_int8 / 1e9:.3f} GB against {bytes_bf16 / 1e9:.3f} GB)")
        if stored != qwen25_stored_layers(cfg25):
            raise AssertionError(f"load_retriever(quantize=True): {stored} stored-int8 layers, expected "
                                 f"{qwen25_stored_layers(cfg25)}")
        encoders = {"bf16": QueryEncoder(model, processor), "int8": QueryEncoder(qmodel, qproc)}
        for enc in encoders.values():
            enc.warmup()
        k6 = qwen_k6_cases(device, shape_batch, cfg25, cfg2,
                           encoders["bf16"]._pad_static(processor.process_queries(QUERIES))[0])

        # Q1a/Q1b at the (M, K, N) that one page forward and the query forwards (x8, x1) of the stored-int8 model
        # give them, recorded by hooks; the bf16 model's first page forward too, so the path below runs warm
        batch = pages[:PAGE_BATCH]
        feed = {k: torch.as_tensor(v).to(device) for k, v in processor.process_images(batch, device_pixels=True).items()
                if k != "image_grid_thw"}
        with torch.inference_mode():
            page_mkn = q1_path_shapes(qmodel, lambda: qmodel(**feed))
            model(**feed)
        query_mkn = q1_path_shapes(qmodel, lambda: (encoders["int8"].encode(QUERIES),
                                                    encoders["int8"].encode(QUERIES[:1])))
        if sorted({(k, n) for _, k, n in page_mkn}) != sorted(Q1_QWEN25_SHAPES):
            raise AssertionError(f"stored-int8 page forward: (M, K, N) {page_mkn}, expected the (K, N) "
                                 f"{Q1_QWEN25_SHAPES}")
        checks = q1_checks(device, page_mkn + query_mkn + product(Q1_QWEN2_SHAPES, Q1_QWEN2_ROWS),
                           edge_ks=(1176, 3420))
        log(f"phase qwen: Q1a and Q1b bit-equal to their plain versions in {checks['q1b_cases']} Q1b cases (with and "
            f"without bias, bf16 and fp32 out): ColQwen2.5-3B's page forward at (M, K, N) {page_mkn}, its query "
            f"forwards at {query_mkn}, ColQwen2-2B's {len(Q1_QWEN2_SHAPES)} other (K, N) at M {Q1_QWEN2_ROWS}; and "
            f"on Q1a's edge rows at K 1,176 and 3,420")
        q1_rows, q1_gemms = q1_timing(device, page_mkn + query_mkn)
        extra["q1_checks"] = dict(checks, page_forward_mkn=page_mkn, query_forward_mkn=query_mkn)

        # the path, counted: pages embedded, /search_text through make_handler on each model, serve.py
        reset_launches()
        t0 = time.perf_counter()
        embs = {"bf16": embed_dataset(model, processor, pages, batch_size=PAGE_BATCH)}
        t_embed_bf16 = time.perf_counter() - t0
        t0 = time.perf_counter()
        embs["int8"] = embed_dataset(qmodel, qproc, pages, batch_size=PAGE_BATCH)
        t_embed_int8 = time.perf_counter() - t0
        for label, es in embs.items():
            for e in es:
                if e.shape[0] < QWEN_PAGE_TOKENS or not np.isfinite(e).all() or \
                        np.abs(np.linalg.norm(e, axis=-1) - 1).max() > 1e-2:
                    raise AssertionError(f"{label} page embedding {e.shape}: not finite or not unit norm")
        gen = torch.Generator(device=device).manual_seed(SEED + 33)
        filler = torch.randn((QWEN_FILLER_DOCS, DOC_TOKENS, DIM), generator=gen, device=device)
        filler = (filler / filler.norm(dim=-1, keepdim=True)).cpu().numpy()
        served, corpora = {}, {}
        for label, enc in encoders.items():
            planted_q = enc.encode(QUERIES[: len(QWEN_PLANTED)])
            docs = [np.concatenate([e, planted_q[QWEN_PLANTED.index(i)]]) if i in QWEN_PLANTED else e
                    for i, e in enumerate(embs[label])] + list(filler)
            corpora[label] = docs
            index = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
            httpd = serve.RetrievalServer(("127.0.0.1", 0), serve.make_handler(
                index, [f"doc_{i}" for i in range(index.num_docs)], encoder=enc))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_port}"
            try:
                tiered = [_http(url, "/search_text", {"queries": [q], "k": 10})
                          for q in QUERIES[: len(QWEN_PLANTED)]]  # one a request: the tiered route
                exact = _http(url, "/search_text", {"queries": QUERIES, "k": 10})  # 8 > 4: the exact route
            finally:
                httpd.shutdown()
                httpd.server_close()
            for out in (*tiered, exact):
                _check_ranked(f"/search_text ({label})", out, len(out["doc_ids"]))
            top = ([out["doc_ids"][0][0] for out in tiered], exact["doc_ids"][: len(QWEN_PLANTED)])
            if top[0] != list(QWEN_PLANTED) or [row[0] for row in top[1]] != list(QWEN_PLANTED):
                raise AssertionError(f"{label} /search_text at rank 1: tiered {top[0]}, exact "
                                     f"{[row[0] for row in top[1]]}, planted {list(QWEN_PLANTED)}")
            served[label] = (index, planted_q)
        npz = f"{tmp}/corpus.npz"
        np.savez(npz, **{f"emb_{i}": d for i, d in enumerate(corpora["int8"])})
        t0 = time.perf_counter()
        httpd = serve.make_server([npz, "--port", "0", "--device", str(device), "--prefilter", "--checkpoint", tmp,
                                   "--family", "colqwen2_5"])
        t_serve = time.perf_counter() - t0
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            cli = _http(f"http://127.0.0.1:{httpd.server_port}", "/search_text", {"queries": [QUERIES[0]], "k": 10})
        finally:
            httpd.shutdown()
            httpd.server_close()
        if cli["doc_ids"][0][0] != QWEN_PLANTED[0]:
            raise AssertionError(f"serve.py --family colqwen2_5: rank 1 {cli['doc_ids'][0][0]}, planted "
                                 f"{QWEN_PLANTED[0]}")
        launches = read_launches("Qwen2-VL family", ("flash_attention", "quantize_rows", "int8_gemm", "binary_maxsim",
                                                     "gather_rerank", "maxsim_int8"))
        log(f"  path: {QWEN_PAGES} pages through embed_dataset, each model warm (bf16 "
            f"{QWEN_PAGES / t_embed_bf16 * 60:.0f} pages/min, stored int8 {QWEN_PAGES / t_embed_int8 * 60:.0f}); a "
            f"{served['int8'][0].num_docs}-doc two-tier int8 index behind "
            f"make_handler for each model: each of {len(QWEN_PLANTED)} planted pages at rank 1 on the tiered and the "
            f"exact route of /search_text; serve.py --checkpoint --family colqwen2_5 (stored int8) started in "
            f"{t_serve:.1f} s and found it too; launches {launches}")
        del corpora, filler

        # K1, K2 and K3 against their plain versions on each served index (not counted)
        k123 = {}
        for label, (index, planted_q) in served.items():
            held = hold_k123(index, served_queries(planted_q, device))
            k123[label] = {k: held[k] for k in ("k1_err", "k2_err", "k3_err")}
            log(f"phase qwen: K1, K2 and K3 against their plain versions on the {label} index ({index.num_docs} docs "
                f"x Np={index.doc_tokens}, the {len(planted_q)} planted queries at Nq={SERVED_TOKENS}): max abs err "
                f"K1 {held['k1_err']:.3g} (bit for bit), K2 {held['k2_err']:.3g}, K3 {held['k3_err']:.3g} (rtol "
                f"{RTOL}, atol {ATOL})")
        del served, index, held
        torch.cuda.empty_cache()

        # checks beside the path (not counted): K6 route vs plain route, stored int8 vs bf16
        route = dict(
            pages=forward_check(f"ColQwen2.5-3B page forward ({PAGE_BATCH} pages)",
                                lambda: embed_dataset(model, processor, batch, batch_size=PAGE_BATCH)),
            queries=forward_check(f"ColQwen2.5-3B query forward ({len(QUERIES)} queries)",
                                  lambda: encoders["bf16"].encode(QUERIES)))
        for name, r in route.items():
            log(f"    shares of the limits: mean cos {share(1 - r['mean_cos'], 1 - FORWARD_COS_MEAN)}, min cos "
                f"{share(1 - r['min_cos'], 1 - FORWARD_COS_MIN)}, max abs {share(r['max_abs'], FORWARD_ATOL)}")
        accuracy = {
            "pages": cos_check(f"{PAGE_BATCH} pages, stored int8 vs bf16", embs["int8"][:PAGE_BATCH],
                               embs["bf16"][:PAGE_BATCH], INT8_COS_MEAN, INT8_COS_MIN),
            "queries": cos_check(f"{len(QUERIES)} queries, stored int8 vs bf16", encoders["int8"].encode(QUERIES),
                                 encoders["bf16"].encode(QUERIES), INT8_COS_MEAN, INT8_COS_MIN)}

        # end to end, bf16 and stored int8 in turns: one forward of 8 pages (CUDA events), encode x1 / x8
        e2e = {}
        for label in ("bf16", "int8", "int8 again", "bf16 again"):
            m, enc = (model, encoders["bf16"]) if label.startswith("bf16") else (qmodel, encoders["int8"])
            r = dict(page_forward_ms=forward_ms(m, feed))
            for b_, texts in (("x1", QUERIES[:1]), ("x8", QUERIES)):
                enc.encode(texts)
                walls = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    enc.encode(texts)
                    walls.append((time.perf_counter() - t0) * 1e3)
                r[f"encode_{b_}_ms"] = float(np.median(walls))
            r["pages_per_min_forward"] = PAGE_BATCH / r["page_forward_ms"] * 6e4
            e2e[label] = r
            log(f"  {label} ({smi}): forward of {PAGE_BATCH} pages {r['page_forward_ms']:.1f} ms "
                f"({r['pages_per_min_forward']:.0f} pages/min of forward alone), encode x1 {r['encode_x1_ms']:.2f} ms, "
                f"x8 {r['encode_x8_ms']:.2f} ms")
        with torch.inference_mode():
            profiles = {label: kernel_breakdown(f"one {label} ColQwen2.5-3B forward of {PAGE_BATCH} pages",
                                                lambda m=m: m(**feed)) for label, m in (("bf16", model),
                                                                                       ("stored-int8", qmodel))}
        del feed, encoders, model, qmodel, embs
        torch.cuda.empty_cache()
    extra.update(k6=k6, k123=k123, params=n_params, stored_int8_layers=stored, weight_bytes_int8=bytes_int8, weight_bytes_bf16=bytes_bf16,
                 route_check=route, int8_vs_bf16=accuracy, end_to_end=e2e, page_profile=profiles,
                 pages_per_min=dict(bf16=QWEN_PAGES / t_embed_bf16 * 60, int8=QWEN_PAGES / t_embed_int8 * 60))

    # ColQwen2-2B: the same path's K6 route against the plain route on one batch
    with tempfile.TemporaryDirectory() as tmp:
        n2 = build_qwen(ColQwen2, cfg2, device, tmp, SEED + 34)
        model2, proc2 = load_retriever(tmp, family="colqwen2", device=device)
    log(f"phase qwen: ColQwen2-2B, vision {cfg2.vision.depth} x {cfg2.vision.embed_dim} ({cfg2.vision.hidden_act}, MLP "
        f"{int(cfg2.vision.embed_dim * cfg2.vision.mlp_ratio)}, out {cfg2.vision.hidden_size}), text "
        f"{cfg2.text.num_hidden_layers} x {cfg2.text.hidden_size} (heads {cfg2.text.num_attention_heads}/"
        f"{cfg2.text.num_key_value_heads}, MLP {cfg2.text.intermediate_size}): {n2 / 1e9:.3f} B params")
    enc2 = QueryEncoder(model2, proc2)
    extra["colqwen2_route_check"] = dict(
        pages=forward_check(f"ColQwen2-2B page forward ({PAGE_BATCH} pages)",
                            lambda: embed_dataset(model2, proc2, pages[:PAGE_BATCH], batch_size=PAGE_BATCH)),
        queries=forward_check(f"ColQwen2-2B query forward ({len(QUERIES)} queries)", lambda: enc2.encode(QUERIES)))
    del model2, enc2
    torch.cuda.empty_cache()

    timings = {"flash_attention": k6,
               "quantize_rows": dict(shapes=q1_rows), "int8_gemm": dict(shapes=q1_gemms)}
    return launches, timings, extra


# -- phase 9: Qwen training (run after phase 8) --------------------------------------------

QWEN_TRAIN_PAGES = 32
QWEN_EVAL_PAGES = 16
QWEN_TRAIN_STEPS = 4
QWEN_RESUME_AT = 2
QWEN_QUANT_STEPS = 2
QWEN_LR = 5e-5  # phase 5's: the recipe's 2e-4 without its 100 warm-up steps overshoots on random weights
# full fine-tuning at full width, cut in depth: 4 vision blocks (the last one full attention) and 2 text layers
FULL_FT_VISION_DEPTH, FULL_FT_TEXT_LAYERS = 4, 2
FULL_FT_BATCH = 8  # the recipe's batch: it fits since the served handlers' batcher threads are stopped
# kernel route vs plain route, one step from the same state, batch and dropout masks (phase 5's rule): the
# recipe loss by value (its max over page tokens makes the routes' gradients flow through other tokens where
# their picks differ), the adapter gradient by cosine on the smooth probe (no max anywhere); the full
# fine-tuning gradient over every parameter likewise. The first run on the H100 read loss gaps of 2.5e-3 to
# 3.6e-3 relative and smooth-probe cosines of 0.99915 (ColQwen2.5-3B, 36 layers) and 0.99705 (ColQwen2-2B,
# 28 layers), where ColPali's 18 layers read 0.9999: bf16 roundings of two routes through random weights. The
# gradient limit is at about 3x the larger gap (the limit written before any run, 0.999, was a guess)
QWEN_ROUTE_LOSS_RTOL, QWEN_ROUTE_GRAD_COS = 1e-2, 0.99
# ColbertLoss's least distance from ln B, where every page of a batch scores alike and a step carries no
# ranking (phases 9, 13, 15 and 17). On random weights the full fine-tuning batch reads the recipe loss as ln 8 exactly
# with page tokens kept (every query token's maximum on the causal template that opens every page), so 9 (e)
# holds the recipe loss over the pages' image tokens, as mask_non_image_embeddings scores them
TIED_MARGIN = 0.05
# phase 9 (b)'s route check runs on fresh adapters, where the recipe loss over the image tokens sits 0.30 off ln 8
# (after the 4 steps it sits 0.03 off, inside TIED_MARGIN). There the two bf16 routes read 2.378733 and 2.324554 on
# the H100, 2.33e-2 apart, and the plain route in fp32 2.360210: the kernel route 7.85e-3 from it, the bf16 plain
# route 1.51e-2. So the recipe loss is held against the fp32 route: the kernel route within QWEN_ROUTE_LOSS_RTOL of
# it, and no farther from it than ROUTE_FP32_RATIO times the bf16 plain route (the ratio hold_bi_routes holds)
ROUTE_FP32_RATIO = 1.5
# phase 9 (b)'s 4 steps move the first batch's recipe loss by this share of it or more: twice the widest gap between
# two bf16 routes of one state (2.33e-2); the H100 read 2.378733 -> 2.112838 (11.2%)
STEP_MOVE_RTOL = 0.05


def launch_counts() -> dict:
    """The launches since :func:`reset_launches` that the training phases read."""
    return dict(flash_attention=fa.FLASH_ATTENTION.launches, flash_attention_bwd=fa.FLASH_ATTENTION_BWD.launches,
                bwd_by_head_dim=dict(fa.BACKWARD_LAUNCHES_BY_HEAD_DIM), maxsim_bf16=MAXSIM_BF16.launches,
                quantize_rows=qd.QUANTIZE_ROWS.launches, int8_gemm=qd.INT8_GEMM.launches,
                gated_delta_rule=gdr.GATED_DELTA_RULE.launches, gated_delta_rule_bwd=gdr.GATED_DELTA_RULE_BWD.launches)


def k6_bwd_row_case(gen: torch.Generator, device: torch.device, b: int, s: int, h: int, hkv: int, d: int,
                    seg: torch.Tensor, rows: torch.Tensor, causal: bool, label: str, kv_seg: torch.Tensor = None,
                    held: tuple = ("rounded",)) -> dict:
    """K6's backward at one of a family's shapes against
    ``flash_attention_backward_plain`` (the kernels' roundings in plain
    PyTorch, from the forward kernel's output and log-sum-exp) by the
    forward's rule with the RMS per query row (key row for dk and dv), two
    batch rows at a time; a query row whose only key is itself has dq = 0
    up to the rounding of rowsum(dO * o) and is held at 1e-4 absolutely.
    A second call must give the same bits; then :func:`k6_bwd_timing`.
    ``rows``: the query rows whose output is read (dO is zero elsewhere).
    ``kv_seg``: the keys' own ids; the key rows held are then those whose
    id is not 0, and the others must take no gradient at all. ``held``:
    the oracles whose rule must hold, "rounded" (the plain version above,
    whose shares are always returned) and "exact" (autograd through the
    plain version on the inputs upcast to fp32, at K6_BWD_ORACLE_ATOL_RMS of
    the row's RMS). With "exact", also returned: its shares
    (``exact_shares``), those of the rounded plain version itself against it
    (``rounded_to_exact_shares``), and at the worst element by the 2% rule
    the kernel's value and both oracles' (``worst``)."""
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=device).to(torch.bfloat16).requires_grad_()
               for n in (h, hkv, hkv))
    d_out = torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16) * rows[:, :, None, None]
    scale = d**-0.5
    keys = {} if kv_seg is None else {"kv_segments": kv_seg}
    key_rows = rows if kv_seg is None else kv_seg != 0
    before = fa.FLASH_ATTENTION_BWD.launches
    got = torch.autograd.grad(fa.flash_attention(q, k, v, seg, scale, causal, **keys), (q, k, v), d_out)
    again = torch.autograd.grad(fa.flash_attention(q, k, v, seg, scale, causal, **keys), (q, k, v), d_out)
    if fa.FLASH_ATTENTION_BWD.launches != before + 2:
        raise AssertionError(f"K6 backward{label}: autograd did not reach the backward kernels")
    for name, a, a2 in zip(("dq", "dk", "dv"), got, again):
        if not torch.equal(a, a2) or not torch.isfinite(a).all():
            raise AssertionError(f"K6 backward{label}: {name} not finite or not bit-equal on a second call")
        if name != "dq" and a[~key_rows].any():
            raise AssertionError(f"K6 backward{label}: {name} of a key that no query attends is not zero")
    allowed = seg[:, :, None] == (seg if kv_seg is None else kv_seg)[:, None, :]
    if causal:
        allowed &= torch.ones((s, s), dtype=torch.bool, device=device).tril()
    alone = rows & (allowed.sum(-1) == 1)
    rules = dict(rounded=K6_ATOL_RMS, **({"exact": K6_BWD_ORACLE_ATOL_RMS} if "exact" in held else {}))
    shares = {oracle: dict(dq=0.0, dk=0.0, dv=0.0) for oracle in (*rules, "rounded_to_exact")}
    worst = {}
    with torch.no_grad():
        fwd_out, lse = fa._forward_cuda(q, k, v, seg, scale, causal, True, **keys)
    errs, alone_max = dict(dq=0.0, dk=0.0, dv=0.0), 0.0
    for i in range(0, b, 2):
        sl = slice(i, i + 2)
        sub = {} if kv_seg is None else {"kv_segments": kv_seg[sl]}
        wants = {}
        with torch.no_grad():
            wants["rounded"] = fa.flash_attention_backward_plain(q[sl], k[sl], v[sl], seg[sl], d_out[sl], scale,
                                                                 causal, out=fwd_out[sl], lse=lse[sl], **sub)
        if "exact" in rules:
            q32, k32, v32 = (t[sl].detach().float().requires_grad_() for t in (q, k, v))
            wants["exact"] = torch.autograd.grad(fa.flash_attention_plain(q32, k32, v32, seg[sl], scale, causal,
                                                                          **sub), (q32, k32, v32), d_out[sl].float())
            del q32, k32, v32
        for j, name in enumerate(("dq", "dk", "dv")):
            keep = rows[sl] & ~alone[sl] if name == "dq" else key_rows[sl]
            g, w = got[j][sl][keep].float(), {oracle: want[j][keep].float() for oracle, want in wants.items()}
            pairs = {oracle: (g, w[oracle]) for oracle in rules}
            if "exact" in w:  # the rounded plain version's own distance from the exact gradient, by the exact rule
                pairs["rounded_to_exact"] = (w["rounded"], w["exact"])
            for pair, (x, y) in pairs.items():
                atol = rules.get(pair, K6_BWD_ORACLE_ATOL_RMS) * y.pow(2).mean(dim=(1, 2), keepdim=True).sqrt()
                ratio = ((x - y).abs() / (atol + K6_RTOL * y.abs())).flatten()
                at = ratio.argmax()
                if ratio[at].item() > shares[pair][name]:
                    shares[pair][name] = ratio[at].item()
                    if pair == "rounded" and "exact" in w:  # the worst element by the 2% rule, kernel and oracles
                        worst[name] = dict(kernel=g.flatten()[at].item(),
                                           **{oracle: v.flatten()[at].item() for oracle, v in w.items()})
            errs[name] = max(errs[name], (g - w["rounded"]).abs().max().item())
        if alone[sl].any():
            alone_max = max(alone_max, got[0][sl][alone[sl]].float().abs().max().item())
        del wants
    if max(max(shares[oracle].values()) for oracle in held) > 1.0 or alone_max > 1e-4:
        raise AssertionError(f"K6 backward{label} vs the plain version: shares of the per-row tolerance {shares} "
                             f"(held: {held}), dq of a row alone with itself {alone_max}")
    r = k6_bwd_timing(q, k, v, seg, d_out, fwd_out, lse, scale, causal,
                      fa.flash_attention_plain(q, k, v, seg, scale, causal, kv_seg), kv_seg=kv_seg)
    out = dict(r, max_abs_err=max(errs.values()), limit_share=max(max(shares[oracle].values()) for oracle in held),
               shares=shares["rounded"], alone_dq_max=alone_max, shape=f"B={b} S={s} H={h} Hkv={hkv} D={d}{label}")
    if "exact" in rules:
        out.update(exact_shares=shares["exact"], rounded_to_exact_shares=shares["rounded_to_exact"], worst=worst)
    return out


def qwen_bwd_cases(device: torch.device, batch: dict, cfg25, cfg2) -> dict:
    """K6's backward where the Qwen family's training puts it: the decoders
    over the pages' prompts (causal, rows left-padded by 0-56, GQA 16/2 and
    12/2), the decoder over the collated queries (causal, their own
    padding), and the vision tower over the pages (full blocks and windowed
    blocks), which full fine-tuning backpropagates through."""
    gen = torch.Generator(device=device).manual_seed(SEED + 40)
    v, t25, t2 = cfg25.vision, cfg25.text, cfg2.text
    b, s_text = batch["doc_input_ids"].shape
    left = (torch.arange(s_text, device=device)[None] >= 8 * torch.arange(b, device=device)[:, None]).to(torch.int32)
    q_seg = batch["query_attention_mask"].to(torch.int32).contiguous()
    mask = batch["doc_patch_mask"]
    window = batch["doc_window_id"].to(torch.int32).contiguous()
    full = torch.where(mask.bool(), 1, -1).to(torch.int32).contiguous()
    valid = mask.bool()
    cases = {
        "text_16_2": (b, s_text, t25.num_attention_heads, t25.num_key_value_heads, t25.head_dim, left, left.bool(),
                      True, " causal, rows left-padded by 0-56 (Qwen2.5-3B)"),
        "text_12_2": (b, s_text, t2.num_attention_heads, t2.num_key_value_heads, t2.head_dim, left, left.bool(), True,
                      " causal, rows left-padded by 0-56 (Qwen2-2B)"),
        "queries": (*q_seg.shape, t25.num_attention_heads, t25.num_key_value_heads, t25.head_dim, q_seg,
                    q_seg.bool(), True, " causal, the collated queries"),
        "vision_full": (*mask.shape, v.num_heads, v.num_heads, v.head_dim, full, valid, False,
                        " (Qwen2.5 full blocks)"),
        "vision_window": (*mask.shape, v.num_heads, v.num_heads, v.head_dim, window, valid, False,
                          f" ({int(window.max()) + 1} windows a page)"),
    }
    out = {}
    for name, (bb, ss, h, hkv, d, seg, rows, causal, label) in cases.items():
        r = out[name] = k6_bwd_row_case(gen, device, bb, ss, h, hkv, d, seg, rows, causal, label)
        log(f"phase qwen training: K6 backward {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, backward: {library_note(r)} (7 products), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}, share of the per-row tolerance dq "
            f"{r['shares']['dq']:.0%} dk {r['shares']['dk']:.0%} dv {r['shares']['dv']:.0%}; bit-equal on a second call")
        torch.cuda.empty_cache()
    return out


def fp32_route(state, batch, loss_fn, peft, fp32_model):
    """:func:`adapter_gradient` through the plain route in fp32:
    ``fp32_model`` (the model of ``state`` built in fp32) takes its bf16
    weights and adapters at its step, so the same dropout masks."""
    from colpali_tpu_torch.training import trainer
    from colpali_tpu_torch.training.lora import LoraAdapters

    fp32_model.load_state_dict(state.model.state_dict())
    adapters = LoraAdapters(fp32_model, peft)
    adapters.load_tree(state.adapters.tree())
    state32 = trainer.create_train_state(fp32_model, state.config, adapters)
    state32.step = state.step
    with plain_route():
        out = adapter_gradient(state32, batch, loss_fn, peft, SEED)
    adapters.detach()
    return out


def hold_routes(name: str, state, batch, recipe_loss, peft, probe=None, tied=None, fp32_model=None) -> dict:
    """:func:`route_gap` on the recipe loss (its value held) and on the
    smooth probe (its value and gradient cosine held): by default InfoNCE
    over the smooth max of the late-interaction scores; a single-vector
    model passes its own. Given ``fp32_model``, the recipe loss is held
    against the plain route in fp32 (:func:`fp32_route`) instead of the bf16
    plain route: the kernel route within :data:`QWEN_ROUTE_LOSS_RTOL` of
    it and no farther from it than :data:`ROUTE_FP32_RATIO` times the plain
    route. Given ``tied`` (ln B for ColbertLoss), a recipe loss within
    :data:`TIED_MARGIN` of it on any route fails: the pages score alike
    there, and the routes would agree whatever K6 did."""
    from colpali_tpu_torch.losses import ColbertLoss

    out = {}
    for what, fn in (("recipe loss", recipe_loss), ("smooth probe", probe or ColbertLoss(use_smooth_max=True))):
        (k, *_), (p, *_), r = route_gap(state, batch, fn, peft)
        out[what] = r
        held = what == "smooth probe"
        against_fp32 = fp32_model is not None and not held
        if against_fp32:
            e = fp32_route(state, batch, fn, peft, fp32_model)[0]
            r.update(loss_fp32=e, kernel_fp32_relative=abs(k - e) / abs(e), plain_fp32_relative=abs(p - e) / abs(e))
            log(f"  {name}, {what} on the kernel route {k:.6f}, the plain route {p:.6f} (relative "
                f"{r['loss_relative']:.2e}, not held), the plain route in fp32 {e:.6f}: kernel to fp32 "
                f"{r['kernel_fp32_relative']:.2e} (limit {QWEN_ROUTE_LOSS_RTOL}, "
                f"{share(r['kernel_fp32_relative'], QWEN_ROUTE_LOSS_RTOL)}), plain to fp32 "
                f"{r['plain_fp32_relative']:.2e} (the kernel route's limit {ROUTE_FP32_RATIO}x that), gradient cosine "
                f"kernel to plain {r['grad_cos']:.6f} (not held: the smooth probe's is)")
        else:
            log(f"  {name}, kernel route vs plain route, {what}: loss {k:.6f} vs {p:.6f} (relative "
                f"{r['loss_relative']:.2e}, limit {QWEN_ROUTE_LOSS_RTOL}, "
                f"{share(r['loss_relative'], QWEN_ROUTE_LOSS_RTOL)}), gradient cosine {r['grad_cos']:.6f}"
                + (f" (limit {QWEN_ROUTE_GRAD_COS}, {share(1 - r['grad_cos'], 1 - QWEN_ROUTE_GRAD_COS)})"
                   if held else " (not held: the smooth probe's is)") + f", norm ratio {r['grad_norm_ratio']:.4f}")
        if tied is not None and not held and \
                min(abs(x - tied) for x in (k, p, r.get("loss_fp32", p))) < TIED_MARGIN:
            raise AssertionError(f"{name}, kernel route vs plain route: the recipe loss {r} lies within {TIED_MARGIN} "
                                 f"of ln B = {tied:.6f}: the pages score alike, a comparison that cannot fail")
        if against_fp32:
            if r["kernel_fp32_relative"] > QWEN_ROUTE_LOSS_RTOL or \
                    r["kernel_fp32_relative"] > ROUTE_FP32_RATIO * r["plain_fp32_relative"]:
                raise AssertionError(f"{name}, kernel route vs the plain route in fp32, {what}: {r}")
        elif r["loss_relative"] > QWEN_ROUTE_LOSS_RTOL or (held and r["grad_cos"] < QWEN_ROUTE_GRAD_COS):
            raise AssertionError(f"{name}, kernel route vs plain route, {what}: {r}")
    return out


def export_readback(device: torch.device, export_dir: str, merged: dict, config, cls, family: str, name: str,
                    dim: int = DIM) -> dict:
    """The merged export read back by ``load_retriever(family=family)``:
    its query and page embeddings equal those of a fresh ``cls`` holding the
    merged weights as they were in memory, bit for bit; its
    ``QueryEncoder`` behind ``make_handler`` finds a page planted with a
    query's tokens at rank 1."""
    import threading

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.evaluation.evaluator import embed_dataset
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.retrieval.store import CorpusIndex
    from colpali_tpu_torch.serve import RetrievalServer, make_handler

    t0 = time.perf_counter()
    back, proc = load_retriever(export_dir, family=family, device=device)
    in_memory = cls(config, dim=dim, device=device, dtype=torch.bfloat16).eval()
    in_memory.load_state_dict(merged)
    del merged
    t_load = time.perf_counter() - t0
    pages = make_pages(4, SEED + 43)
    emb = {}
    with torch.no_grad():
        for key, m in (("loaded", back), ("in_memory", in_memory)):
            emb[key] = [m(**{k: torch.as_tensor(v).to(device) for k, v in feed.items() if k != "image_grid_thw"})
                        for feed in (proc.process_queries(QUERIES), proc.process_images(pages[:2]))]
    for what, a, b in zip(("queries", "pages"), emb["loaded"], emb["in_memory"]):
        if not torch.equal(a, b) or not torch.isfinite(a.float()).all():
            raise AssertionError(f"{name} export read back: {what} embeddings differ from the in-memory model's by up "
                                 f"to {(a.float() - b.float()).abs().max().item()}")
    del in_memory
    encoder = QueryEncoder(back, proc)
    docs = embed_dataset(back, proc, pages, batch_size=len(pages))
    planted = 2
    docs[planted] = np.concatenate([docs[planted], encoder.encode(QUERIES[:1])[0]])
    httpd = RetrievalServer(("127.0.0.1", 0), make_handler(CorpusIndex(docs, device=device),
                                                               [f"page_{i}" for i in range(len(docs))],
                                                               encoder=encoder))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        out = _http(f"http://127.0.0.1:{httpd.server_address[1]}", "/search_text", {"queries": QUERIES[:1], "k": 4})
    finally:
        httpd.shutdown()
        httpd.server_close()
    _check_ranked(f"/search_text (the {name} export read back)", out, 1)
    if out["doc_ids"][0][0] != planted:
        raise AssertionError(f"/search_text over the read-back {name} export: top-4 {out['doc_ids'][0]}, planted "
                             f"{planted}")
    r = dict(seconds=time.perf_counter() - t0, load_seconds=t_load, query_shape=list(emb["loaded"][0].shape),
             page_shape=list(emb["loaded"][1].shape))
    log(f"  export read back by load_retriever(family=\"{family}\") into a fresh {name}: query "
        f"{tuple(emb['loaded'][0].shape)} and page {tuple(emb['loaded'][1].shape)} embeddings bit-equal to a model "
        f"holding the merged weights in memory; its QueryEncoder behind make_handler found the planted page at rank 1 "
        f"through /search_text ({r['seconds']:.1f} s)")
    del back, encoder, emb
    torch.cuda.empty_cache()
    return r


def phase_qwen_training(device: torch.device, smi: str, ckpt: str) -> tuple:
    """Drive the Qwen2-VL family's training path: K6's backward at the
    family's shapes (a), ColQwen2.5-3B through ``ColModelTraining`` with the
    recipe's loss and LoRA, eval, the merged export read back and served,
    resume (b), the same over a stored-int8 frozen vision tower (c),
    ColQwen2-2B's LoRA steps (d) and a full fine-tuning step at cut depth
    through the D=80 backward (e). ``ckpt`` is phase 8's ColQwen2.5-3B
    checkpoint. Returns the launches over the path, K6's backward timings
    and the rest."""
    import dataclasses
    import math
    import os
    import shutil

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.core.hf_loader import load_colqwen25_params
    from colpali_tpu_torch.data.collator import VisualRetrieverCollator
    from colpali_tpu_torch.losses import ColbertLoss
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.models.qwen2_5_vl import ColQwen2_5
    from colpali_tpu_torch.models.qwen2_vl import ColQwen2
    from colpali_tpu_torch.processors.qwen2_vl import ColQwen2Processor
    from colpali_tpu_torch.training import trainer
    from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec
    from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig

    cfg25, cfg2 = qwen_configs()
    t25, v25 = cfg25.text, cfg25.vision
    peft = LoraSpec(rank=32, alpha=32, dropout=0.1)
    loss_fn = ColbertLoss(temperature=0.02)
    train_config = trainer.TrainConfig(learning_rate=QWEN_LR, warmup_steps=0, total_steps=2500)
    t0 = time.perf_counter()
    model, processor = load_retriever(ckpt, family="colqwen2_5", device=device, remat=True,
                                      mask_non_image_embeddings=True)
    torch.cuda.synchronize()
    log(f"phase qwen training: ColQwen2.5-3B read by load_retriever(remat=True, mask_non_image_embeddings=True) in "
        f"{time.perf_counter() - t0:.1f} s")
    train_set = page_dataset(QWEN_TRAIN_PAGES, SEED + 41)
    eval_set = page_dataset(QWEN_EVAL_PAGES, SEED + 42, first=QWEN_TRAIN_PAGES)
    batch = trainer.to_device(VisualRetrieverCollator(processor)([train_set[i] for i in range(TRAIN_BATCH)]), device)
    k6_bwd = qwen_bwd_cases(device, batch, cfg25, cfg2)
    tied = math.log(TRAIN_BATCH)
    spread = page_score_spread(model, batch, cfg25.image_token_id, loss_fn)
    margin = abs(spread["masked"]["loss"] - tied)
    log(f"  ColQwen2.5-3B, the first batch's in-batch scores: page tokens kept, the recipe loss "
        f"{spread['unmasked']['loss']:.6f} (ln {TRAIN_BATCH} = {tied:.6f}), {spread['unmasked']['on_template']:.1%} of "
        f"the query tokens' maxima outside the image tokens, least spread {spread['unmasked']['min_spread']:.5f}; "
        f"non-image tokens masked (as trained here) {spread['masked']['loss']:.6f} ({margin:.4f} from ln {TRAIN_BATCH}, "
        f"limit {TIED_MARGIN}), {spread['masked']['on_template']:.1%}, least spread "
        f"{spread['masked']['min_spread']:.5f}")
    if margin < TIED_MARGIN:
        raise AssertionError(f"ColQwen2.5-3B LoRA: the recipe loss over the image tokens {spread['masked']['loss']:.6f} "
                             f"lies within {TIED_MARGIN} of ln {TRAIN_BATCH}: the pages score alike")
    extra = dict(score_spread=spread)
    # the kernel route against the plain routes on fresh adapters, where the loss sits TIED_MARGIN or more off ln 8
    adapters = LoraAdapters(model, peft, seed=SEED + 1)
    fp32 = ColQwen2_5(cfg25, mask_non_image_embeddings=True, device=device, dtype=torch.float32, remat=True)
    extra["route_lora_25"] = hold_routes("ColQwen2.5-3B LoRA (fresh adapters, non-image tokens masked)",
                                         trainer.create_train_state(model, train_config, adapters), batch, loss_fn,
                                         peft, tied=tied, fp32_model=fp32)
    adapters.detach()
    del adapters, fp32
    torch.cuda.empty_cache()

    sampled = ["model.language_model.layers.0.self_attn.q_proj.weight",
               f"model.language_model.layers.{t25.num_hidden_layers - 1}.mlp.down_proj.weight",
               f"model.visual.blocks.{v25.depth // 2}.mlp.up_proj.weight", "head.custom_text_proj.weight"]
    base_before = {k: model.state_dict()[k].clone() for k in sampled}
    with tempfile.TemporaryDirectory() as tmp:
        def make_app(out, **kw):
            return ColModelTraining(ColModelTrainingConfig(
                model=model, loss_func=loss_fn, train_datasets=[train_set], processor=processor,
                eval_dataset=eval_set, eval_batch_size=TRAIN_BATCH, output_dir=out, global_batch_size=TRAIN_BATCH,
                log_steps=1, save_steps=QWEN_RESUME_AT, save_total_limit=QWEN_TRAIN_STEPS, peft=peft,
                train=train_config, seed=SEED, device=device, **kw))

        # -- (b) the recipe loop: 4 steps, eval, save, read back, serve, resume ------------
        app = make_app(f"{tmp}/run", max_steps=QWEN_TRAIN_STEPS)
        n_adapters, n_trainable = len(app.state.adapters.paths), sum(p.numel() for p in app.state.params)
        seen, moved_after_one = [], []

        def on_step(step, metrics):
            seen.append((step, float(metrics["loss"]), float(metrics["grad_norm"])))
            if step == 1:
                moved_after_one.extend(bool(b.detach().abs().max() > 0) for b in app.state.adapters.b)

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        summary = app.train(on_step=on_step)
        torch.cuda.synchronize()
        train_launches = launch_counts()
        peak_train = torch.cuda.max_memory_allocated() / 2**30
        by_dim = train_launches["bwd_by_head_dim"]
        passes = QWEN_TRAIN_STEPS * 2  # a query and a page forward a step need a gradient
        app.state.adapters.clear_masks()
        with torch.no_grad():
            trained = trainer.compute_loss(model.eval(), batch, loss_fn, False)[0].item()
        moved = abs(trained - spread["masked"]["loss"]) / spread["masked"]["loss"]
        if not moved >= STEP_MOVE_RTOL:
            raise AssertionError(f"ColQwen2.5-3B LoRA: {QWEN_TRAIN_STEPS} steps left the recipe loss over the image tokens "
                                 f"at {trained} (before them {spread['masked']['loss']}): moved {moved:.2e}, less than "
                                 f"{STEP_MOVE_RTOL} of it")
        if [s for s, _, _ in seen] != list(range(1, QWEN_TRAIN_STEPS + 1)) or \
                not all(np.isfinite(l) and l > 0 and np.isfinite(g) and g > 0 for _, l, g in seen):
            raise AssertionError(f"ColQwen2.5-3B steps: {seen}")
        if len(moved_after_one) != n_adapters or not all(moved_after_one):
            raise AssertionError(f"{moved_after_one.count(False)} of {n_adapters} adapters did not move in step 1")
        if not all(torch.equal(model.state_dict()[k], w) for k, w in base_before.items()):
            raise AssertionError("a frozen base weight changed")
        if by_dim[t25.head_dim] != passes * t25.num_hidden_layers or by_dim[v25.head_dim] != 0 or \
                train_launches["flash_attention_bwd"] != by_dim[t25.head_dim]:
            raise AssertionError(f"K6 backward over {QWEN_TRAIN_STEPS} LoRA steps: {train_launches}; expected "
                                 f"{passes} x {t25.num_hidden_layers} at D={t25.head_dim} and none at D={v25.head_dim}")
        log(f"  ColQwen2.5-3B, ColModelTraining ({smi}): {n_adapters} adapted layers, {n_trainable / 1e6:.1f} M trainable "
            f"parameters, ColbertLoss(temperature=0.02), LoRA r32 a32 dropout 0.1, remat, batch {TRAIN_BATCH}; "
            + ", ".join(f"step {s} loss {l:.4f} grad_norm {g:.4f}" for s, l, g in seen)
            + f"; {summary['train_samples_per_second']:.2f} examples/s with collation and checkpoints; K6 forward "
            f"{train_launches['flash_attention']}, backward {train_launches['flash_attention_bwd']} (by head dim "
            f"{by_dim}); peak memory {peak_train:.2f} GiB; the recipe loss over the image tokens on the first batch "
            f"{spread['masked']['loss']:.6f} before the steps, {trained:.6f} after (moved {moved:.1%}, limit "
            f"{STEP_MOVE_RTOL:.0%})")
        extra["trained_loss"] = trained

        reset_launches()  # the loss read after the steps launched K6 too: it does not count
        t0 = time.perf_counter()
        metrics = app.evaluate()
        t_eval = time.perf_counter() - t0
        eval_launches = launch_counts()
        index = app.eval_index
        if not {"eval_loss", "eval_ndcg@1", "eval_ndcg@5"} <= set(metrics) or \
                not all(np.isfinite(x) for x in metrics.values()) or not eval_launches["maxsim_bf16"] or \
                (index.dtype, index.num_docs, index._store.device.type) != ("bf16", QWEN_EVAL_PAGES, device.type):
            raise AssertionError(f"evaluate(): {metrics}, index {index.dtype} {index.num_docs}, {eval_launches}")
        log(f"  evaluate(): {QWEN_EVAL_PAGES} held-out pages in {t_eval:.1f} s, bf16 index {index.num_docs} x "
            f"{index.doc_tokens} built on the card and searched by K5 ({eval_launches['maxsim_bf16']} launch(es)); "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())))
        t0 = time.perf_counter()
        app.save()
        t_save = time.perf_counter() - t0
        merged = app.state.adapters.merged_state_dict(model)
        log(f"  save(): merged weights as model.safetensors (HF layout) in {t_save:.1f} s")
        readback = export_readback(device, f"{tmp}/run", merged, cfg25, ColQwen2_5, "colqwen2_5", "ColQwen2.5-3B")
        del merged
        app.close()
        os.remove(f"{tmp}/run/model.safetensors")

        os.makedirs(f"{tmp}/resumed/checkpoints")
        shutil.copy(f"{tmp}/run/checkpoints/step_{QWEN_RESUME_AT}.pt", f"{tmp}/resumed/checkpoints/")
        resumed = make_app(f"{tmp}/resumed", max_steps=QWEN_RESUME_AT + 1, resume_from_checkpoint=True)
        tail = []
        resumed.train(on_step=lambda step, m: tail.append((step, float(m["loss"]))))
        resumed.close()
        first = seen[QWEN_RESUME_AT][1]
        if resumed.state.step != QWEN_RESUME_AT + 1 or [s for s, _ in tail] != [QWEN_RESUME_AT + 1] or \
                abs(tail[0][1] - first) > RESUME_LOSS_RTOL * abs(first):
            raise AssertionError(f"resumed run: {tail}, the first run's step {QWEN_RESUME_AT + 1} loss {first}")
        log(f"  resumed from step {QWEN_RESUME_AT}: step {QWEN_RESUME_AT + 1} loss {tail[0][1]:.8f} vs {first:.8f} in the "
            f"first run (limit {RESUME_LOSS_RTOL} relative)")

        adapters = LoraAdapters(model, peft, seed=SEED + 1)
        state = trainer.create_train_state(model, train_config, adapters)
        steps = {}
        for remat in (True, False):
            model.set_remat(remat)
            steps["remat" if remat else "no_remat"] = r = timed_steps(state, batch, loss_fn, peft, SEED, steps=2)
            log(f"  ColQwen2.5-3B LoRA step, batch {TRAIN_BATCH}, remat {'on' if remat else 'off'} ({smi}): "
                f"{r['wall']:.1f} ms/step ({TRAIN_BATCH / r['wall'] * 1e3:.2f} examples/s without collation), forward "
                f"{r['forward']:.1f} ms, backward {r['backward']:.1f} ms, optimizer {r['optimizer']:.1f} ms, host and "
                f"idle {r['wall'] - r['forward'] - r['backward'] - r['optimizer']:.1f} ms, peak memory "
                f"{r['peak_gib']:.2f} GiB ({r['allocated_before_gib']:.2f} GiB held before the step)")
        model.set_remat(True)
        step_fn = trainer.make_train_step(loss_fn, peft=peft, seed=SEED)
        steps["remat_profile"] = kernel_breakdown(f"one ColQwen2.5-3B LoRA step, batch {TRAIN_BATCH}, remat on",
                                                  lambda: step_fn(state, batch)["loss"].item())
        adapters.detach()
        extra.update(losses=[l for _, l, _ in seen], grad_norms=[g for _, _, g in seen], eval=metrics,
                     examples_per_s_end_to_end=summary["train_samples_per_second"], peak_train_gib=peak_train,
                     step_ms=steps, checkpoint_readback=readback, resumed_loss=tail[0][1],
                     launches_per_step={"flash_attention_bwd": train_launches["flash_attention_bwd"] // QWEN_TRAIN_STEPS})

        # -- (c) the same model over a stored-int8 frozen vision tower ---------------------
        qapp = ColModelTraining(ColModelTrainingConfig(
            model=model, loss_func=loss_fn, train_datasets=[train_set], processor=processor,
            output_dir=f"{tmp}/quant", global_batch_size=TRAIN_BATCH, log_steps=1, save_steps=100, peft=peft,
            train=train_config, seed=SEED, device=device, max_steps=QWEN_QUANT_STEPS, quantize_frozen_base=True))
        stored = [name for name, m in model.named_modules() if isinstance(m, QDense) and m.stored]
        vision_stored = 1 + v25.depth * 7 + 2  # the patch embedding, q/k/v/o/gate/up/down a block, the merger's 2
        if len(stored) != vision_stored or not all(name.startswith("model.visual.") for name in stored):
            raise AssertionError(f"quantize_frozen_base stored {len(stored)} layers, expected the {vision_stored} of the "
                                 "vision tower")
        reset_launches()
        qseen = []
        qapp.train(on_step=lambda step, m: qseen.append((step, float(m["loss"]), float(m["grad_norm"]))))
        torch.cuda.synchronize()
        quant_launches = launch_counts()
        if quant_launches["int8_gemm"] != QWEN_QUANT_STEPS * vision_stored or not quant_launches["quantize_rows"] or \
                len(qseen) != QWEN_QUANT_STEPS or not all(np.isfinite(l) for _, l, _ in qseen):
            raise AssertionError(f"quantize_frozen_base steps {qseen}, launches {quant_launches}; expected "
                                 f"{QWEN_QUANT_STEPS} x {vision_stored} Q1b launches")
        with torch.enable_grad():
            feats = model.model.visual(*(batch[f"doc_{k}"] for k in ("pixel_values", "vision_hpos", "vision_wpos",
                                                                    "patch_mask", "window_id")))
        if feats.requires_grad or any(m.weight.grad is not None for m in model.modules()
                                      if isinstance(m, QDense) and m.stored):
            raise AssertionError("a gradient was recorded through the stored-int8 tower")
        del feats
        qapp.save()
        exported = load_colqwen25_params(f"{tmp}/quant")
        for name in stored:
            m = model.get_submodule(name)
            if not torch.equal(exported[f"{name}.weight"].to(device), qd.dequantized(m.weight, m.weight_scale,
                                                                                     torch.bfloat16)):
                raise AssertionError(f"the export's {name}.weight is not q * scale")
        del exported
        shutil.rmtree(f"{tmp}/quant")
        qapp.close()
        qadapters = LoraAdapters(model, peft, seed=SEED + 1)
        qstate = trainer.create_train_state(model, train_config, qadapters)
        quant_step = timed_steps(qstate, batch, loss_fn, peft, SEED, steps=2)
        qadapters.detach()
        log(f"  quantize_frozen_base: {len(stored)} stored-int8 vision layers; steps "
            + ", ".join(f"{s} loss {l:.4f} grad_norm {g:.4f}" for s, l, g in qseen)
            + f"; Q1a {quant_launches['quantize_rows']} and Q1b {quant_launches['int8_gemm']} launches over "
            f"{QWEN_QUANT_STEPS} steps; no gradient through the int8 tower; the export's {len(stored)} vision weights "
            f"equal q * scale. Step ({smi}, remat on): {quant_step['wall']:.1f} ms (bf16 base "
            f"{steps['remat']['wall']:.1f} ms), forward {quant_step['forward']:.1f} ms, peak memory "
            f"{quant_step['peak_gib']:.2f} GiB, {quant_step['allocated_before_gib']:.2f} GiB held before the step "
            f"(bf16 base {steps['remat']['peak_gib']:.2f} and {steps['remat']['allocated_before_gib']:.2f} GiB)")
        extra["quantize_frozen_base"] = dict(stored_layers=len(stored), losses=[l for _, l, _ in qseen],
                                             launches=quant_launches, step_ms=quant_step)
    del model, qadapters, qstate, state, adapters, app, qapp, resumed
    torch.cuda.empty_cache()

    # -- (d) ColQwen2-2B at full width: 2 LoRA steps ------------------------------------------
    reset_launches()
    model2 = ColQwen2(cfg2, dim=DIM, device=device, dtype=torch.bfloat16, remat=True)
    hf_init_(model2, torch.Generator(device=device).manual_seed(SEED + 44))
    proc2 = ColQwen2Processor(qwen_tokenizer(), max_num_visual_tokens=768, device=device)
    batch2 = trainer.to_device(VisualRetrieverCollator(proc2)([train_set[i] for i in range(TRAIN_BATCH)]), device)
    adapters2 = LoraAdapters(model2, peft, seed=SEED + 1)
    state2 = trainer.create_train_state(model2, train_config, adapters2)
    extra["route_lora_2"] = hold_routes("ColQwen2-2B LoRA", state2, batch2, loss_fn, peft)
    reset_launches()
    step2 = trainer.make_train_step(loss_fn, peft=peft, seed=SEED)
    losses2 = [step2(state2, batch2)["loss"].item() for _ in range(2)]
    d_launches = launch_counts()
    if not np.isfinite(losses2).all() or not all(bool(b.detach().abs().max() > 0) for b in adapters2.b) or \
            d_launches["bwd_by_head_dim"][cfg2.text.head_dim] != 2 * 2 * cfg2.text.num_hidden_layers:
        raise AssertionError(f"ColQwen2-2B LoRA steps: losses {losses2}, launches {d_launches}")
    log(f"  ColQwen2-2B, 2 LoRA steps (GQA {cfg2.text.num_attention_heads}/{cfg2.text.num_key_value_heads}): losses "
        + ", ".join(f"{l:.4f}" for l in losses2) + f"; K6 backward {d_launches['bwd_by_head_dim']}")
    extra["colqwen2_lora"] = dict(losses=losses2, launches=d_launches)
    adapters2.detach()
    del model2, state2, adapters2, batch2
    torch.cuda.empty_cache()

    # -- (e) full fine-tuning at full width and cut depth: the D=80 backward ------------------------
    cut = dataclasses.replace(cfg25, vision=dataclasses.replace(v25, depth=FULL_FT_VISION_DEPTH,
                                                                fullatt_block_indexes=(FULL_FT_VISION_DEPTH - 1,)),
                              text=dataclasses.replace(t25, num_hidden_layers=FULL_FT_TEXT_LAYERS))
    full = ColQwen2_5(cut, dim=DIM, device=device, dtype=torch.bfloat16).train()
    gen = torch.Generator(device=device).manual_seed(SEED + 45)
    hf_init_(full, gen)
    with torch.no_grad():  # biases and norms off their initial values, so that each takes its own gradient path
        for p in full.parameters():
            if p.ndim == 1:
                p.add_(torch.randn(p.shape, generator=gen, device=device).to(p.dtype) * 0.02)
    # lr 1e-2: Adam's first update is about lr an element, which must pass half a bf16 ulp of a norm weight near 1
    fstate = trainer.create_train_state(full, trainer.TrainConfig(learning_rate=1e-2, warmup_steps=0,
                                                                  total_steps=100, weight_decay=0.0))
    # the plain route keeps each vision block's fp32 logits for its backward (4.5 GB a block at batch 8)
    batch = {k: v[:, :FULL_FT_BATCH] if k.endswith("position_ids") else v[:FULL_FT_BATCH] for k, v in batch.items()}
    image = (batch["doc_input_ids"] == cut.image_token_id)[..., None]

    def image_only(q, d):  # the recipe loss over the pages' image tokens (mask_non_image_embeddings' scores)
        return loss_fn(q, d * image.to(d.dtype))

    tied = math.log(FULL_FT_BATCH)
    spread = page_score_spread(full, batch, cut.image_token_id, loss_fn)
    margin = abs(spread["masked"]["loss"] - tied)
    log(f"  full fine-tuning batch, in-batch scores: page tokens kept, the recipe loss {spread['unmasked']['loss']:.6f} "
        f"(ln {FULL_FT_BATCH} = {tied:.6f}), {spread['unmasked']['on_template']:.1%} of the query tokens' maxima "
        f"outside the image tokens, least spread {spread['unmasked']['min_spread']:.5f}; over the image tokens alone "
        f"{spread['masked']['loss']:.6f} ({margin:.4f} from ln {FULL_FT_BATCH}, limit {TIED_MARGIN}), least spread "
        f"{spread['masked']['min_spread']:.5f}")
    if margin < TIED_MARGIN:
        raise AssertionError(f"full fine-tuning: the recipe loss over the image tokens {spread['masked']['loss']:.6f} "
                             f"lies within {TIED_MARGIN} of ln {FULL_FT_BATCH}: the pages score alike")
    with torch.no_grad():
        before_step = trainer.compute_loss(full, batch, image_only, False)[0].item()
    reset_launches()
    route_full = hold_routes(f"full fine-tuning ({FULL_FT_VISION_DEPTH} vision blocks, {FULL_FT_TEXT_LAYERS} text "
                             f"layers, batch {FULL_FT_BATCH}; recipe loss over the image tokens)", fstate, batch,
                             image_only, None)
    e_launches = launch_counts()  # both losses' kernel routes: one page forward each
    # the step on the smooth probe: the recipe loss's max over page tokens can leave the whole tower without a
    # gradient where no image token is picked, as on random weights
    before = {n: p.detach().clone() for n, p in full.named_parameters()}
    trainer.begin_step(fstate, None, SEED)
    loss, _, _ = trainer.compute_loss(full, batch, ColbertLoss(use_smooth_max=True), False)
    loss.backward()
    no_grad = [n for n, p in full.named_parameters() if p.grad is None or not bool(p.grad.abs().max() > 0)]
    fstate.apply_gradients()
    unmoved = [n for n, p in full.named_parameters() if torch.equal(p.detach(), before[n])]
    with torch.no_grad():
        after = trainer.compute_loss(full, batch, image_only, False)[0].item()
    expect80 = 2 * FULL_FT_VISION_DEPTH  # a page forward a loss, each block's attention once
    if no_grad or unmoved or e_launches["bwd_by_head_dim"][v25.head_dim] != expect80 or \
            after == before_step or not np.isfinite(after):
        raise AssertionError(f"full fine-tuning: parameters without a gradient {no_grad[:4]}, not moved {unmoved[:4]}; "
                             f"launches {e_launches}, expected {expect80} at D={v25.head_dim}; the recipe loss over "
                             f"the image tokens {before_step} before the step, {after} after")
    n_full = sum(p.numel() for p in full.parameters())
    log(f"  full fine-tuning, ColQwen2.5 at full width cut to {FULL_FT_VISION_DEPTH} vision blocks (block "
        f"{FULL_FT_VISION_DEPTH - 1} full attention) and {FULL_FT_TEXT_LAYERS} text layers ({n_full / 1e9:.3f} B "
        f"parameters, batch {FULL_FT_BATCH}): every parameter took a gradient and moved in one step on the smooth "
        f"probe (loss {loss.item():.6f}); the recipe loss over the image tokens {before_step:.6f} before it, "
        f"{after:.6f} after; K6 backward by head dim over the two route checks' kernel routes "
        f"{e_launches['bwd_by_head_dim']}")
    extra["full_fine_tuning"] = dict(params=n_full, route=route_full, launches=e_launches, score_spread=spread,
                                     image_loss=[before_step, after])
    fstate.model.zero_grad(set_to_none=True)
    del full, fstate, before, batch
    torch.cuda.empty_cache()

    launches = dict(flash_attention_bwd=train_launches["flash_attention_bwd"],
                    flash_attention=train_launches["flash_attention"] + eval_launches["flash_attention"],
                    maxsim_bf16=eval_launches["maxsim_bf16"], quantize_rows=quant_launches["quantize_rows"],
                    int8_gemm=quant_launches["int8_gemm"])
    extra["launches_by_head_dim"] = {str(d): n for d, n in by_dim.items()}
    return launches, k6_bwd, extra


# -- phase 10: the Idefics3/SmolVLM family, ColSmol (run after phase 9) -------------------------------

SMOL_PAGES = 16  # two batches of 8
SMOL_PLANTED = (1, 6, 10, 13)  # pages whose docs also hold QUERIES[i]'s tokens, i = 0..3
SMOL_FILLER_DOCS = 4_096
SMOL_TILES = 13  # a 1,275 x 1,650 page within the longest edge of 2,048: 4 x 3 tiles of 512 px and the global view
# colSmol-256M's stored-int8 layers: 12 x 6 in the vision tower (q/k/v/o, fc1, fc2), the 12,288 -> 576 connector,
# 30 x 5 in the text layers (their k/v, 576 -> 192, the patch embedding and the 128-d head stay bf16)
SMOL_STORED_LAYERS = 12 * 6 + 1 + 30 * 5
BI_COS_MIN = 0.999  # a Bi vector through the K6 route against the plain route
BI_PLANTED = (1, 3, 4, 6)  # of a batch of 8 pages: each takes query i's vector, i = 0..3


def smol_config():
    """colSmol-256M at its published widths (``scripts/validate_checkpoint.py::make_synth_colsmol``): the
    SigLIP-B/16-512 vision tower (12 x 768, 12 heads), pixel shuffle by 4, the SmolLM2-135M text decoder
    (30 x 576, 9/3 heads of 64, MLP 1,536, vocab 49,280)."""
    from colpali_tpu_torch.models.idefics3 import Idefics3Config, Idefics3VisionConfig
    from colpali_tpu_torch.models.qwen2_vl import Qwen2TextConfig

    return Idefics3Config(vision=Idefics3VisionConfig(),
                          text=Qwen2TextConfig(vocab_size=49280, hidden_size=576, intermediate_size=1536,
                                               num_hidden_layers=30, num_attention_heads=9, num_key_value_heads=3,
                                               head_dim=64, rope_theta=100000.0, rms_norm_eps=1e-5,
                                               mrope_section=(32,), attention_bias=False),
                          scale_factor=4, image_token_id=49190)


def smol_tokenizer():
    """A word-level tokenizer over the prompt's and QUERIES' words with Idefics3's special tokens."""
    from colpali_tpu_torch.utils.testing import idefics3_word_tokenizer

    return idefics3_word_tokenizer("User: Describe the image. Assistant:".split() + " ".join(QUERIES).split())


def smol_k6_cases(device: torch.device, batch: dict, cfg, encoder_feed: dict) -> dict:
    """K6 at D=64 against its plain version at the path's shapes: the vision
    tower over a batch's tiles (no mask), the decoder over the pages' prompts
    (causal GQA 9/3, rows right-padded by 0-56 tokens under the key-padding
    mask) and over the queries as the query encoder pads them."""
    gen = torch.Generator(device=device).manual_seed(SEED + 50)
    v, t = cfg.vision, cfg.text
    n_tiles = int(np.asarray(batch["tile_mask"]).size)
    b, s_text = batch["input_ids"].shape
    right = (torch.arange(s_text, device=device)[None] < s_text - 8 * torch.arange(b, device=device)[:, None])
    q_mask = torch.as_tensor(encoder_feed["attention_mask"], device=device).to(torch.int32).contiguous()
    heads = (t.num_attention_heads, t.num_key_value_heads, t.head_dim)
    cases = {
        "vision": (n_tiles, v.num_patches, v.num_attention_heads, v.num_attention_heads, v.head_dim, None, None,
                   False, f" ({n_tiles // b} tiles a page)", None),
        "text": (b, s_text, *heads, None, None, True, " causal, rows right-padded by 0-56 (key-padding mask)",
                 right.to(torch.int32).contiguous()),
        "queries": (*q_mask.shape, *heads, None, None, True, " causal, the query encoder's padding (key-padding mask)",
                    q_mask),
    }
    out = {}
    for name, (bb, ss, h, hkv, d, lengths, seg, causal, label, kv_seg) in cases.items():
        if kv_seg is not None:
            seg = torch.ones_like(kv_seg)
        r = k6_case(gen, device, bb, ss, h, hkv, d, lengths, seg=seg, causal=causal, label=label, kv_seg=kv_seg)
        extra = f", bound over all pairs {r['bound_ms_all_pairs']:.4f} ms" if "bound_ms_all_pairs" in r else ""
        log(f"phase colsmol: K6 {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"{library_note(r)}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}, max_abs_err "
            f"{r['max_abs_err']:.3g} (atol {r['atol']:.3g}, {r['limit_share']:.0%} of the tolerance), bit-equal on "
            "a second call")
        out[name] = r
    torch.cuda.empty_cache()
    return out


def bi_check(name: str, model, feeds: list, device: torch.device, score, planted: tuple) -> dict:
    """A Bi model's single vectors of each feed (pages, then queries) through
    the K6 route and the plain route (cosine per vector >= BI_COS_MIN), and
    its processor's ``score`` finding each planted page at rank 1: page
    ``planted[i]``'s vector replaced by query i's."""
    def run():
        with torch.inference_mode():
            return [model(**{k: torch.as_tensor(v).to(device) for k, v in f.items() if k != "image_grid_thw"})
                    .float().cpu().numpy() for f in feeds]

    kernel = run()
    with plain_route():
        plain = run()
    a, b = np.concatenate(kernel), np.concatenate(plain)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    pages, queries = kernel[0].copy(), kernel[-1]
    for i, p in enumerate(planted):
        pages[p] = queries[i]
    top = score(list(queries[: len(planted)]), list(pages)).argmax(axis=1).tolist()
    out = dict(vectors=len(a), dim=a.shape[1], min_cos=float(cos.min()), mean_cos=float(cos.mean()), top=top)
    if not (np.isfinite(a).all() and out["min_cos"] >= BI_COS_MIN and top == list(planted)):
        raise AssertionError(f"{name}: {out}, limits min cos >= {BI_COS_MIN}, planted {list(planted)}")
    log(f"  {name}: {len(a)} vectors of {a.shape[1]}, K6 route vs plain route mean cos {out['mean_cos']:.6f}, min "
        f"cos {out['min_cos']:.6f} (limit {BI_COS_MIN}, {share(1 - out['min_cos'], 1 - BI_COS_MIN)}); score finds "
        f"each planted page at rank 1 {top}")
    return out


def bi_pali_config():
    """BiPaliProj's config in phases 10 and 11: ColPali-3B's widths cut to 2 + 2 layers."""
    from colpali_tpu_torch.models.configs import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig

    return PaliGemmaConfig(vision=SiglipVisionConfig(num_hidden_layers=2), text=GemmaConfig(num_hidden_layers=2))


@contextlib.contextmanager
def counted_plain(module=fa, name: str = "flash_attention_plain"):
    """A kernel's plain version, ``module.name`` (K6's by default), counted
    while the block runs (``calls[0]``); on the card a path must never
    reach it."""
    calls, plain = [0], getattr(module, name)

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    with mock.patch.object(module, name, counted):
        yield calls



def split_map_check(processor, feed: dict, model, queries: list) -> dict:
    """``interpretability.get_split_image_similarity_maps`` on a batch of
    split pages (``feed``, embedded by ``model``) with the processor's
    ``get_local_image_mask``, held at 1e-5 against a float64 einsum over
    the tiles' tokens laid out on the page's grid here (tile rows, then
    each tile's token rows)."""
    from colpali_tpu_torch.interpretability import get_split_image_similarity_maps

    with torch.inference_mode():
        image = model(**feed).float().cpu().numpy()
    local = processor.get_local_image_mask({k: v.cpu().numpy() for k, v in feed.items() if k != "pixel_values"})
    n_patches = processor.get_n_patches(PAGE_HW)
    q = np.zeros((len(queries), max(len(x) for x in queries), image.shape[-1]), np.float32)
    for i, x in enumerate(queries):
        q[i, : len(x)] = x
    maps = get_split_image_similarity_maps(image, q, n_patches, local, processor.image_seq_len)
    side = int(round(processor.image_seq_len ** 0.5))
    err = 0.0
    for i, got in enumerate(maps):
        grid = np.zeros((*n_patches, image.shape[-1]))
        for pos, token in enumerate(image[i][local[i]].astype(np.float64)):
            tile, inner = divmod(pos, side * side)
            (ty, tx), (py, px) = divmod(tile, n_patches[0] // side), divmod(inner, side)
            grid[tx * side + px, ty * side + py] = token
        err = max(err, float(np.abs(got - np.einsum("nd,xyd->nxy", q[i].astype(np.float64), grid)).max()))
    if len(maps) != len(queries) or maps[0].shape != (q.shape[1], *n_patches) or err > 1e-5:
        raise AssertionError(f"split-image similarity maps: {len(maps)} of {maps[0].shape}, error {err} against a "
                             "float64 einsum (limit 1e-5)")
    log(f"  split-image similarity maps of {len(maps)} pages ({n_patches[0]} x {n_patches[1]} patches from the local "
        f"tiles): within {err:.3g} of a float64 einsum (limit 1e-5)")
    return dict(n_patches=list(n_patches), max_abs_err=err)


def phase_colsmol(device: torch.device, smi: str) -> tuple:
    """Drive the Idefics3/SmolVLM family's serving path: colSmol-256M written
    as an HF checkpoint and read back by ``load_retriever(family=
    "colidefics3")`` in bf16 and stored int8, pages through
    ``embed_dataset``, ``/search_text`` through ``make_handler`` and
    ``serve.py --checkpoint --family colidefics3``; K6 at D=64 at the path's
    shapes; then the Bi models (BiIdefics3 at full width, BiPaliProj and
    BiQwen2_5 at cut depth). Returns the launches over the path, the kernel
    rows and the rest."""
    import dataclasses
    import tempfile
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.evaluation.evaluator import embed_dataset
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.idefics3 import BiIdefics3, ColIdefics3
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.models.paligemma import BiPaliProj
    from colpali_tpu_torch.models.qwen2_5_vl import BiQwen2_5
    from colpali_tpu_torch.processors.bi import BiIdefics3Processor, BiPaliProcessor, BiQwen2_5_Processor
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.retrieval.store import CorpusIndex
    from colpali_tpu_torch.serve import RetrievalServer
    from colpali_tpu_torch.utils.testing import write_idefics3_checkpoint

    held = free_memory("phase colsmol")
    cfg = smol_config()
    pages = make_pages(SMOL_PAGES, SEED + 51)
    extra = dict(held_gib_at_start=held)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        model = ColIdefics3(cfg, dim=DIM, device=device, dtype=torch.bfloat16)
        hf_init_(model, torch.Generator(device=device).manual_seed(SEED + 52))
        n_params = sum(p.numel() for p in model.parameters())
        write_idefics3_checkpoint(tmp, model, smol_tokenizer())
        backbone = {k: v for k, v in model.state_dict().items() if k.startswith("model.")}  # BiIdefics3's, below
        del model
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        model, processor = load_retriever(tmp, family="colidefics3", device=device)
        torch.cuda.synchronize()
        t_bf16 = time.perf_counter() - t0
        t0 = time.perf_counter()
        qmodel, qproc = load_retriever(tmp, family="colidefics3", device=device, quantize=True)
        torch.cuda.synchronize()
        t_int8 = time.perf_counter() - t0
        stored = sum(isinstance(m, QDense) and m.stored for m in qmodel.modules())
        bytes_int8, bytes_bf16 = (sum(t.numel() * t.element_size() for t in m.state_dict().values())
                                  for m in (qmodel, model))
        v, t = cfg.vision, cfg.text
        log(f"phase colsmol: colSmol-256M, vision {v.num_hidden_layers} x {v.hidden_size} (MLP {v.intermediate_size}, "
            f"{v.num_attention_heads} heads x {v.head_dim}, {v.image_size} px tiles of {v.num_patches} patches), pixel "
            f"shuffle {cfg.scale_factor} ({cfg.image_seq_len} tokens a tile, connector "
            f"{v.hidden_size * cfg.scale_factor**2} -> {t.hidden_size}), text {t.num_hidden_layers} x {t.hidden_size} "
            f"(MLP {t.intermediate_size}, heads {t.num_attention_heads}/{t.num_key_value_heads} x {t.head_dim}, vocab "
            f"{t.vocab_size}): {n_params / 1e9:.3f} B params; HF checkpoint written in {t_write:.1f} s, "
            f"load_retriever {t_bf16:.1f} s (bf16), {t_int8:.1f} s (quantize=True: {stored} stored-int8 layers, "
            f"{bytes_int8 / 1e9:.3f} GB against {bytes_bf16 / 1e9:.3f} GB)")
        if stored != SMOL_STORED_LAYERS:
            raise AssertionError(f"load_retriever(quantize=True): {stored} stored-int8 layers, expected "
                                 f"{SMOL_STORED_LAYERS}")
        batch = pages[:PAGE_BATCH]
        feed = {k: torch.as_tensor(v).to(device)
                for k, v in processor.process_images(batch, device_pixels=True).items()}
        n_tiles = int(feed["tile_mask"].sum(1).max())
        n_image = int((feed["input_ids"] == cfg.image_token_id).sum(1).max())
        page_tokens = feed["input_ids"].shape[1]
        if n_tiles != SMOL_TILES or n_image != SMOL_TILES * cfg.image_seq_len:
            raise AssertionError(f"a {PAGE_HW[1]} x {PAGE_HW[0]} page: {n_tiles} tiles, {n_image} image tokens; "
                                 f"expected {SMOL_TILES}")
        encoders = {"bf16": QueryEncoder(model, processor), "int8": QueryEncoder(qmodel, qproc)}
        for enc in encoders.values():
            enc.warmup()
        k6 = smol_k6_cases(device, {k: v.cpu().numpy() for k, v in feed.items() if k != "pixel_values"}, cfg,
                           encoders["bf16"]._pad_static(processor.process_queries(QUERIES))[0])

        # Q1a/Q1b at the (M, K, N) of one stored-int8 page forward and the query forwards (x8, x1), by hooks
        with torch.inference_mode():
            page_mkn = q1_path_shapes(qmodel, lambda: qmodel(**feed))
            model(**feed)
        query_mkn = q1_path_shapes(qmodel, lambda: (encoders["int8"].encode(QUERIES),
                                                    encoders["int8"].encode(QUERIES[:1])))
        checks = q1_checks(device, page_mkn + query_mkn, edge_ks=(576, 12288))
        log(f"phase colsmol: Q1a and Q1b bit-equal to their plain versions in {checks['q1b_cases']} Q1b cases at the "
            f"page forward's (M, K, N) {page_mkn} and the query forwards' {query_mkn}; Q1a on edge rows at K 576 "
            "and 12,288")
        q1_rows, q1_gemms = q1_timing(device, page_mkn + query_mkn)
        extra["q1_checks"] = dict(checks, page_forward_mkn=page_mkn, query_forward_mkn=query_mkn)

        # the path, counted: pages embedded, /search_text through make_handler on each model, serve.py; K6's
        # plain version counted apart, which the path must never reach on the card
        reset_launches()
        with counted_plain() as plain_calls:
            t0 = time.perf_counter()
            embs = {"bf16": embed_dataset(model, processor, pages, batch_size=PAGE_BATCH)}
            t_embed_bf16 = time.perf_counter() - t0
            t0 = time.perf_counter()
            embs["int8"] = embed_dataset(qmodel, qproc, pages, batch_size=PAGE_BATCH)
            t_embed_int8 = time.perf_counter() - t0
            for label, es in embs.items():
                for e in es:
                    if e.shape[0] != page_tokens or not np.isfinite(e).all() or \
                            np.abs(np.linalg.norm(e, axis=-1) - 1).max() > 1e-2:
                        raise AssertionError(f"{label} page embedding {e.shape}: not {page_tokens} finite unit rows")
            gen = torch.Generator(device=device).manual_seed(SEED + 53)
            filler = torch.randn((SMOL_FILLER_DOCS, DOC_TOKENS, DIM), generator=gen, device=device)
            filler = (filler / filler.norm(dim=-1, keepdim=True)).cpu().numpy()
            served, corpora = {}, {}
            for label, enc in encoders.items():
                planted_q = enc.encode(QUERIES[: len(SMOL_PLANTED)])
                docs = [np.concatenate([e, planted_q[SMOL_PLANTED.index(i)]]) if i in SMOL_PLANTED else e
                        for i, e in enumerate(embs[label])] + list(filler)
                corpora[label] = docs
                index = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
                httpd = RetrievalServer(("127.0.0.1", 0), serve.make_handler(
                    index, [f"doc_{i}" for i in range(index.num_docs)], encoder=enc))
                threading.Thread(target=httpd.serve_forever, daemon=True).start()
                url = f"http://127.0.0.1:{httpd.server_port}"
                try:
                    tiered = [_http(url, "/search_text", {"queries": [q], "k": 10})
                              for q in QUERIES[: len(SMOL_PLANTED)]]  # one a request: the tiered route
                    exact = _http(url, "/search_text", {"queries": QUERIES, "k": 10})  # 8 > 4: the exact route
                finally:
                    httpd.shutdown()
                    httpd.server_close()
                for out in (*tiered, exact):
                    _check_ranked(f"/search_text ({label})", out, len(out["doc_ids"]))
                top = ([out["doc_ids"][0][0] for out in tiered],
                       [row[0] for row in exact["doc_ids"][: len(SMOL_PLANTED)]])
                if top[0] != list(SMOL_PLANTED) or top[1] != list(SMOL_PLANTED):
                    raise AssertionError(f"{label} /search_text at rank 1: tiered {top[0]}, exact {top[1]}, planted "
                                         f"{list(SMOL_PLANTED)}")
                served[label] = (index, planted_q)
            npz = f"{tmp}/corpus.npz"
            np.savez(npz, **{f"emb_{i}": d for i, d in enumerate(corpora["int8"])})
            t0 = time.perf_counter()
            httpd = serve.make_server([npz, "--port", "0", "--device", str(device), "--prefilter", "--checkpoint", tmp,
                                       "--family", "colidefics3"])
            t_serve = time.perf_counter() - t0
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            try:
                cli = _http(f"http://127.0.0.1:{httpd.server_port}", "/search_text",
                            {"queries": [QUERIES[0]], "k": 10})
            finally:
                httpd.shutdown()
                httpd.server_close()
            if cli["doc_ids"][0][0] != SMOL_PLANTED[0]:
                raise AssertionError(f"serve.py --family colidefics3: rank 1 {cli['doc_ids'][0][0]}, planted "
                                     f"{SMOL_PLANTED[0]}")
        launches = read_launches("colSmol", ("flash_attention", "quantize_rows", "int8_gemm", "binary_maxsim",
                                             "gather_rerank", "maxsim_int8"))
        by_dim = {d: n for d, n in fa.FORWARD_LAUNCHES_BY_HEAD_DIM.items() if n}
        if plain_calls[0] or set(by_dim) != {64}:
            raise AssertionError(f"colSmol path: K6 launches by head dim {by_dim}, {plain_calls[0]} calls of K6's "
                                 "plain version; expected D=64 alone on the kernel")
        log(f"  path: {SMOL_PAGES} pages ({page_tokens} tokens, {SMOL_TILES} tiles each) through embed_dataset, each "
            f"model warm (bf16 {SMOL_PAGES / t_embed_bf16 * 60:.0f} pages/min, stored int8 "
            f"{SMOL_PAGES / t_embed_int8 * 60:.0f}); a {served['int8'][0].num_docs}-doc x "
            f"{served['int8'][0].doc_tokens}-token two-tier int8 index behind make_handler for each model: each of "
            f"{len(SMOL_PLANTED)} planted pages at rank 1 on the tiered and the exact route of /search_text; serve.py "
            f"--checkpoint --family colidefics3 (stored int8) started in {t_serve:.1f} s and found it too; launches "
            f"{launches}, K6 by head dim {by_dim}, K6's plain version called {plain_calls[0]} times")
        del corpora, filler

        # K1, K2 and K3 against their plain versions on each served index (not counted)
        k123 = {}
        for label, (index, planted_q) in served.items():
            held_k = hold_k123(index, served_queries(planted_q, device))
            k123[label] = {k: held_k[k] for k in ("k1_err", "k2_err", "k3_err")}
            log(f"phase colsmol: K1, K2 and K3 against their plain versions on the {label} index ({index.num_docs} "
                f"docs x Np={index.doc_tokens}, the {len(planted_q)} planted queries at Nq={SERVED_TOKENS}): max abs "
                f"err K1 {held_k['k1_err']:.3g} (bit for bit), K2 {held_k['k2_err']:.3g}, K3 {held_k['k3_err']:.3g} "
                f"(rtol {RTOL}, atol {ATOL})")
        del served, index, held_k
        torch.cuda.empty_cache()

        # checks beside the path (not counted): K6 route vs plain route, stored int8 vs bf16
        route = dict(
            pages=forward_check(f"colSmol-256M page forward ({PAGE_BATCH} pages)",
                                lambda: embed_dataset(model, processor, batch, batch_size=PAGE_BATCH)),
            queries=forward_check(f"colSmol-256M query forward ({len(QUERIES)} queries)",
                                  lambda: encoders["bf16"].encode(QUERIES)))
        for name, r in route.items():
            log(f"    shares of the limits: mean cos {share(1 - r['mean_cos'], 1 - FORWARD_COS_MEAN)}, min cos "
                f"{share(1 - r['min_cos'], 1 - FORWARD_COS_MIN)}, max abs {share(r['max_abs'], FORWARD_ATOL)}")
        accuracy = {
            "pages": cos_check(f"{PAGE_BATCH} pages, stored int8 vs bf16", embs["int8"][:PAGE_BATCH],
                               embs["bf16"][:PAGE_BATCH], INT8_COS_MEAN, INT8_COS_MIN),
            "queries": cos_check(f"{len(QUERIES)} queries, stored int8 vs bf16", encoders["int8"].encode(QUERIES),
                                 encoders["bf16"].encode(QUERIES), INT8_COS_MEAN, INT8_COS_MIN)}

        extra["split_maps"] = split_map_check(processor, feed, model, encoders["bf16"].encode(QUERIES))

        # end to end, bf16 and stored int8 in turns: one forward of 8 pages (CUDA events), encode x1 / x8
        e2e = {}
        for label in ("bf16", "int8", "int8 again", "bf16 again"):
            m, enc = (model, encoders["bf16"]) if label.startswith("bf16") else (qmodel, encoders["int8"])
            r = dict(page_forward_ms=forward_ms(m, feed))
            for b_, texts in (("x1", QUERIES[:1]), ("x8", QUERIES)):
                enc.encode(texts)
                walls = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    enc.encode(texts)
                    walls.append((time.perf_counter() - t0) * 1e3)
                r[f"encode_{b_}_ms"] = float(np.median(walls))
            r["pages_per_min_forward"] = PAGE_BATCH / r["page_forward_ms"] * 6e4
            e2e[label] = r
            log(f"  {label} ({smi}): forward of {PAGE_BATCH} pages {r['page_forward_ms']:.1f} ms "
                f"({r['pages_per_min_forward']:.0f} pages/min of forward alone), encode x1 {r['encode_x1_ms']:.2f} ms, "
                f"x8 {r['encode_x8_ms']:.2f} ms")
        with torch.inference_mode():
            profiles = {label: kernel_breakdown(f"one {label} colSmol-256M forward of {PAGE_BATCH} pages",
                                                lambda m=m: m(**feed)) for label, m in (("bf16", model),
                                                                                       ("stored-int8", qmodel))}
        query_feed = {k: torch.as_tensor(v).to(device) for k, v in processor.process_queries(QUERIES).items()}
        del encoders, qmodel, embs
        torch.cuda.empty_cache()

        # the Bi models: BiIdefics3 at full width on the checkpoint's backbone, then BiPaliProj and BiQwen2_5 at
        # full width cut in depth (their backbones run at full depth in phases 4 and 8)
        bi = {}
        bmodel = BiIdefics3(cfg, device=device, dtype=torch.bfloat16).eval()
        bmodel.load_state_dict(backbone)
        bproc = BiIdefics3Processor.from_pretrained(tmp, device=device)
        bi["BiIdefics3"] = bi_check("BiIdefics3 (colSmol-256M, last pooling)", bmodel, [feed, query_feed], device,
                                    bproc.score, BI_PLANTED)
        del bmodel, backbone, feed, query_feed, model
        torch.cuda.empty_cache()
    pali_cfg = bi_pali_config()
    pmodel = BiPaliProj(pali_cfg, device=device, dtype=torch.bfloat16).eval()
    hf_init_(pmodel, torch.Generator(device=device).manual_seed(SEED + 54))
    pproc = BiPaliProcessor(WordTokenizer(pali_cfg.image_token_index), device=device)
    bi["BiPaliProj"] = bi_check("BiPaliProj (ColPali-3B widths, 2 + 2 layers, mean pooling, 1,024-d projection)",
                                pmodel, [pproc.process_images(pages[:PAGE_BATCH]), pproc.process_queries(QUERIES)],
                                device, pproc.score, BI_PLANTED)
    del pmodel
    cfg25 = qwen_configs()[0]
    cfg25 = dataclasses.replace(cfg25, vision=dataclasses.replace(cfg25.vision, depth=2, fullatt_block_indexes=(1,)),
                                text=dataclasses.replace(cfg25.text, num_hidden_layers=2))
    qwmodel = BiQwen2_5(cfg25, device=device, dtype=torch.bfloat16).eval()
    hf_init_(qwmodel, torch.Generator(device=device).manual_seed(SEED + 55))
    qwproc = BiQwen2_5_Processor(qwen_tokenizer(), max_num_visual_tokens=768, device=device)
    bi["BiQwen2_5"] = bi_check("BiQwen2_5 (ColQwen2.5-3B widths, 2 + 2 layers, last pooling)", qwmodel,
                               [qwproc.process_images(pages[:PAGE_BATCH], device_pixels=True),
                                qwproc.process_queries(QUERIES)], device, qwproc.score, BI_PLANTED)
    del qwmodel
    torch.cuda.empty_cache()
    extra.update(k6=k6, k123=k123, params=n_params, stored_int8_layers=stored, weight_bytes_int8=bytes_int8,
                 weight_bytes_bf16=bytes_bf16, page_tokens=page_tokens, tiles=SMOL_TILES, route_check=route,
                 int8_vs_bf16=accuracy, end_to_end=e2e, page_profile=profiles, bi=bi,
                 launches_by_head_dim={str(d): n for d, n in by_dim.items()},
                 pages_per_min=dict(bf16=SMOL_PAGES / t_embed_bf16 * 60, int8=SMOL_PAGES / t_embed_int8 * 60))
    timings = {"flash_attention": k6, "quantize_rows": dict(shapes=q1_rows), "int8_gemm": dict(shapes=q1_gemms)}
    return launches, timings, extra


# -- phase 11: colSmol training (run after phase 10) -------------------------------------------------------------

SMOL_TRAIN_PAGES = 32  # four batches of 8
SMOL_EVAL_PAGES = 32
SMOL_TRAIN_STEPS, SMOL_RESUME_AT, BI_TRAIN_STEPS = 4, 2, 2
SMOL_RECIPE_BATCH, BI_RECIPE_BATCH = 32, 64  # global_batch_size of train_colidefics3.yaml and train_biidefics3.yaml
SMOL_VISION_STORED = 12 * 6  # quantize_frozen_base: q/k/v/o, fc1 and fc2 of each SigLIP layer; the connector stays bf16
SMOL_QUANT_MIN_DIM = 512  # ColModelTrainingConfig's default quant_min_dim
# a single-vector model's smooth probe for the plain-route check: in-batch InfoNCE over the dot products at
# temperature 1 (the recipes' 0.02 scales the routes' gaps in the vectors by 50 in the logits)
BI_PROBE_TEMPERATURE = 1.0


def smol_dataset(n: int, seed: int, first: int = 0):
    """``n`` seeded 1,275 x 1,650 pages (13 tiles each) with QUERIES in turn:
    queries of unequal lengths, which the Idefics3 processors pad on the
    right."""
    from colpali_tpu_torch.data.dataset import ColPaliEngineDataset

    return ColPaliEngineDataset([{"query": QUERIES[(first + i) % len(QUERIES)], "pos_target": page}
                                 for i, page in enumerate(make_pages(n, seed))])


def recipe_config(name: str, out: str, model, processor, train_set, train_config, device: torch.device,
                  **overrides) -> dict:
    """``configs/<name>``'s ``config`` tree built by the port, with the nodes
    that name files absent here (checkpoint, processor, datasets) and the
    run's size replaced: ``ColModelTrainingConfig``'s arguments."""
    import os

    import yaml

    from colpali_tpu_torch.configs import instantiate

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", name)) as f:
        node = yaml.safe_load(f)["config"]
    node.update(model=model, processor=processor, params=None, train_datasets=[train_set], output_dir=out,
                global_batch_size=TRAIN_BATCH, log_steps=1, train=train_config, seed=SEED, device=device, **overrides)
    return instantiate(node)


def smol_bwd_cases(device: torch.device, batch: dict, cfg) -> dict:
    """K6's backward at D=64 where colSmol's training puts it: the decoder
    over the pages' prompts (causal GQA 9/3, rows right-padded by 0-56,
    queries id 1 and the keys the validity mask, every query row read), over
    the collated queries (the same ids), and the vision tower over a batch's
    tiles, which only full fine-tuning backpropagates through. The text and
    query cases are held by the forward's rule against the rounded plain
    version (2% of the row RMS); the text case also against the exact
    gradient (K6_BWD_ORACLE_ATOL_RMS). The vision case, no mask and 82 M
    elements a gradient, is held against the exact gradient alone: at 2%
    the rounded plain version's own noise (fp32 sums in another order, bf16
    outputs that round the other way) reaches the limit at some element.
    Its 2% share is printed, and beside it that of the same shape at D=80
    (the Qwen2.5 vision tower's head dim) drawn from the same generator
    state: the yardstick of how far the 2% rule reads at this size."""
    gen = torch.Generator(device=device).manual_seed(SEED + 61)
    v, t = cfg.vision, cfg.text
    b, s_text = batch["doc_input_ids"].shape
    right = (torch.arange(s_text, device=device)[None] < s_text - 8 * torch.arange(b, device=device)[:, None])
    right = right.to(torch.int32).contiguous()
    q_mask = batch["query_attention_mask"].to(torch.int32).contiguous()
    tiles = int(batch["doc_tile_mask"].numel())
    heads = (t.num_attention_heads, t.num_key_value_heads, t.head_dim)
    vision = (tiles, v.num_patches, v.num_attention_heads, v.num_attention_heads)
    full_ft = f" ({tiles // b} tiles a page, full fine-tuning only)"
    cases = {
        "text": (b, s_text, *heads, right, True, " causal, rows right-padded by 0-56 under the key-padding mask",
                 ("rounded", "exact")),
        "queries": (*q_mask.shape, *heads, q_mask, True, " causal, the collated queries (key-padding mask)",
                    ("rounded",)),
        "vision": (*vision, v.head_dim, None, False, full_ft, ("exact",)),
        "vision_d80": (*vision, 80, None, False, " (the vision shape at D=80, the same draw as the vision case)",
                       ("exact",)),
    }
    out = {}
    for name, (bb, ss, h, hkv, d, kv_seg, causal, label, held) in cases.items():
        if name == "vision":
            vision_draw = gen.get_state()
        elif name == "vision_d80":
            gen.set_state(vision_draw)
        seg = torch.ones((bb, ss), dtype=torch.int32, device=device)
        r = out[name] = k6_bwd_row_case(gen, device, bb, ss, h, hkv, d, seg, seg.bool(), causal, label,
                                        kv_seg=kv_seg, held=held)
        rounded = "held" if "rounded" in held else "not held"
        exact = "" if "exact_shares" not in r else (
            ", against the exact gradient ({rule:.0%} of the row RMS, held) dq {dq:.0%} dk {dk:.0%} dv {dv:.0%}"
            .format(rule=K6_BWD_ORACLE_ATOL_RMS, **r["exact_shares"]) +
            " (the rounded plain version's own: dq {dq:.0%} dk {dk:.0%} dv {dv:.0%})"
            .format(**r["rounded_to_exact_shares"]) +
            "; at the worst element by the 2% rule, kernel / rounded / exact: " + ", ".join(
                f"{n} {w['kernel']:.6g} / {w['rounded']:.6g} / {w['exact']:.6g}" for n, w in r["worst"].items()))
        log(f"phase colsmol training: K6 backward {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, backward: {library_note(r)} (7 products), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}, share of the tolerance against the rounded "
            f"plain version ({K6_ATOL_RMS:.0%} of the row RMS, {rounded}) dq {r['shares']['dq']:.1%} dk "
            f"{r['shares']['dk']:.1%} dv {r['shares']['dv']:.1%}{exact}; bit-equal on a second call")
        torch.cuda.empty_cache()
    return out


def hold_bi_routes(name: str, state, batch, recipe_loss, peft, probe, fp32_model) -> dict:
    """A single-vector model's train step against the plain route, and both
    against the plain route in fp32 (``fp32_model``: the same model built
    in fp32; it takes the bf16 weights and the adapters, and the same
    dropout masks). The recipe loss's value and the smooth probe's are held
    against the plain route (relative 1e-2); the probe's gradient through
    the kernels is held against the fp32 gradient (cosine >= 0.99) and must
    stand no farther from it than :data:`ROUTE_FP32_RATIO` times the plain route's own distance. The
    cosine between the two bf16 routes is printed, not held: with one
    vector a row the gradient reaches the adapters through one position,
    and the first H100 run read 0.98925 between them for BiIdefics3 at 30
    layers, each route 0.9916-0.9917 from the fp32 gradient."""
    (rk, *_), (rp, *_), rr = route_gap(state, batch, recipe_loss, peft)
    log(f"  {name}, kernel route vs plain route, recipe loss: loss {rk:.6f} vs {rp:.6f} (relative "
        f"{rr['loss_relative']:.2e}, limit {QWEN_ROUTE_LOSS_RTOL}, {share(rr['loss_relative'], QWEN_ROUTE_LOSS_RTOL)}), "
        f"gradient cosine {rr['grad_cos']:.6f} (not held)")
    if rr["loss_relative"] > QWEN_ROUTE_LOSS_RTOL:
        raise AssertionError(f"{name}, kernel route vs plain route, recipe loss: {rr}")
    out = dict(recipe_loss=rr)
    (k, kg, *_), (p, pg, *_), r = route_gap(state, batch, probe, peft)
    e, eg, *_ = fp32_route(state, batch, probe, peft, fp32_model)
    kg, pg, eg = kg.double(), pg.double(), eg.double()

    def cos(a, b):
        return (a @ b / (a.norm() * b.norm())).item()

    r.update(loss_fp32=e, grad_cos_fp32=cos(kg, eg), plain_grad_cos_fp32=cos(pg, eg))
    log(f"  {name}, smooth probe against the plain route in bf16 and in fp32: loss kernel {k:.6f}, plain {p:.6f} "
        f"(relative {r['loss_relative']:.2e}, limit {QWEN_ROUTE_LOSS_RTOL}), fp32 {e:.6f}; gradient cosine to fp32 {r['grad_cos_fp32']:.6f} (limit {QWEN_ROUTE_GRAD_COS}, "
        f"{share(1 - r['grad_cos_fp32'], 1 - QWEN_ROUTE_GRAD_COS)}; the plain route's {r['plain_grad_cos_fp32']:.6f}), "
        f"kernel to plain {r['grad_cos']:.6f} (not held)")
    if r["loss_relative"] > QWEN_ROUTE_LOSS_RTOL or r["grad_cos_fp32"] < QWEN_ROUTE_GRAD_COS or \
            1 - r["grad_cos_fp32"] > ROUTE_FP32_RATIO * (1 - r["plain_grad_cos_fp32"]):
        raise AssertionError(f"{name}, kernel route vs plain route and fp32: {r}")
    out["smooth_probe"] = r
    return out


def repeat_batch(batch: dict, times: int) -> dict:
    """A collated batch ``times`` over along the batch axis (a timed step at
    a recipe's batch size, without collating as many pages)."""
    return {k: torch.cat([v] * times) for k, v in batch.items()}


def phase_smol_training(device: torch.device, smi: str) -> tuple:
    """Drive the Idefics3 family's training path: K6's backward at D=64 at
    the path's shapes (a); colSmol-256M written as an HF checkpoint, read by
    ``load_retriever(family="colidefics3", remat=True)`` and trained through
    ``ColModelTraining`` from ``configs/train_colidefics3.yaml``'s loss and
    LoRA: 4 steps, the plain route, eval, resume, the merged export read
    back and served, steps timed at the recipe's batch and one step over a
    stored-int8 frozen vision tower (b); BiIdefics3 from
    ``train_biidefics3.yaml`` (c); BiPaliProj and BiQwen2_5 at cut depth,
    one step each (d). Returns the launches over the path, the backward's
    cases and the rest."""
    import dataclasses
    import os
    import shutil

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.data.collator import VisualRetrieverCollator
    from colpali_tpu_torch.losses import BiEncoderLoss, BiPairwiseCELoss
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.idefics3 import BiIdefics3, ColIdefics3
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.models.paligemma import BiPaliProj
    from colpali_tpu_torch.models.qwen2_5_vl import BiQwen2_5
    from colpali_tpu_torch.processors.bi import BiIdefics3Processor, BiPaliProcessor, BiQwen2_5_Processor
    from colpali_tpu_torch.training import trainer
    from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec
    from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig
    from colpali_tpu_torch.utils.testing import write_idefics3_checkpoint

    held = free_memory("phase colsmol training")
    bi_probe = BiEncoderLoss(temperature=BI_PROBE_TEMPERATURE)
    t_phase = time.perf_counter()
    cfg = smol_config()
    t = cfg.text
    train_config = trainer.TrainConfig(learning_rate=QWEN_LR, warmup_steps=0, total_steps=2500)
    train_set = smol_dataset(SMOL_TRAIN_PAGES, SEED + 62)
    eval_set = smol_dataset(SMOL_EVAL_PAGES, SEED + 63, first=SMOL_TRAIN_PAGES)
    extra = dict(held_gib_at_start=held)
    with tempfile.TemporaryDirectory() as tmp:
        model = ColIdefics3(cfg, dim=DIM, device=device, dtype=torch.bfloat16)
        hf_init_(model, torch.Generator(device=device).manual_seed(SEED + 60))
        write_idefics3_checkpoint(f"{tmp}/ckpt", model, smol_tokenizer())
        backbone = {k: v for k, v in model.state_dict().items() if k.startswith("model.")}  # BiIdefics3's, in (c)
        del model
        model, processor = load_retriever(f"{tmp}/ckpt", family="colidefics3", device=device, remat=True)
        batch = trainer.to_device(VisualRetrieverCollator(processor)([train_set[i] for i in range(TRAIN_BATCH)]),
                                  device)
        k6_bwd = smol_bwd_cases(device, batch, cfg)

        # -- (b) colSmol-256M through ColModelTraining from the recipe ----------------------------------------
        recipe = functools.partial(recipe_config, train_set=train_set, train_config=train_config, device=device)

        def make_app(out, **kw):
            return ColModelTraining(ColModelTrainingConfig(**recipe(
                "train_colidefics3.yaml", out, model, processor, eval_dataset=eval_set, eval_batch_size=TRAIN_BATCH,
                save_steps=SMOL_RESUME_AT, save_total_limit=SMOL_TRAIN_STEPS, **kw)))

        app = make_app(f"{tmp}/run", max_steps=SMOL_TRAIN_STEPS)
        peft, loss_fn = app.config.peft, app.config.loss_func
        n_adapters, n_trainable = len(app.state.adapters.paths), sum(p.numel() for p in app.state.params)
        seen, moved = [], []

        def on_step(step, metrics):
            seen.append((step, float(metrics["loss"]), float(metrics["grad_norm"])))
            if step == 1:
                moved.extend(bool(b.detach().abs().max() > 0) for b in app.state.adapters.b)

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with counted_plain() as plain_calls:
            summary = app.train(on_step=on_step)
        torch.cuda.synchronize()
        train_launches = launch_counts()
        peak_train = torch.cuda.max_memory_allocated() / 2**30
        by_dim = train_launches["bwd_by_head_dim"]
        per_step = 2 * t.num_hidden_layers  # a query and a page forward a step need a gradient: 60
        if [s for s, _, _ in seen] != list(range(1, SMOL_TRAIN_STEPS + 1)) or \
                not all(np.isfinite(l) and l > 0 and np.isfinite(g) and g > 0 for _, l, g in seen):
            raise AssertionError(f"colSmol-256M steps: {seen}")
        if len(moved) != n_adapters or not all(moved):
            raise AssertionError(f"{moved.count(False)} of {n_adapters} adapters did not move in step 1")
        if by_dim[t.head_dim] != SMOL_TRAIN_STEPS * per_step or sum(by_dim.values()) != by_dim[t.head_dim] or \
                train_launches["flash_attention_bwd"] != by_dim[t.head_dim] or plain_calls[0]:
            raise AssertionError(f"K6 backward over {SMOL_TRAIN_STEPS} colSmol LoRA steps: {train_launches}, "
                                 f"{plain_calls[0]} calls of the plain version; expected {per_step} a step at "
                                 f"D={t.head_dim} alone")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] colSmol-256M, ColModelTraining from train_colidefics3.yaml ({smi}): {n_adapters} adapted layers, "
            f"{n_trainable / 1e6:.2f} M trainable parameters, {type(loss_fn).__name__}, LoRA r{peft.rank} "
            f"a{peft.alpha:g} dropout {peft.dropout}, remat, batch {TRAIN_BATCH}; "
            + ", ".join(f"step {s} loss {l:.4f} grad_norm {g:.4f}" for s, l, g in seen)
            + f"; {summary['train_samples_per_second']:.2f} examples/s with collation and checkpoints; K6 forward "
            f"{train_launches['flash_attention']}, backward {train_launches['flash_attention_bwd']} "
            f"({train_launches['flash_attention_bwd'] // SMOL_TRAIN_STEPS} a step, by head dim {by_dim}), K6's plain "
            f"version called {plain_calls[0]} times; peak memory {peak_train:.2f} GiB")
        extra["route_colsmol"] = hold_routes("colSmol-256M LoRA", app.state, batch, loss_fn, peft)

        reset_launches()
        t0 = time.perf_counter()
        metrics = app.evaluate()
        t_eval = time.perf_counter() - t0
        eval_launches = launch_counts()
        index = app.eval_index
        if not {"eval_loss", "eval_ndcg@1", "eval_ndcg@5"} <= set(metrics) or \
                not all(np.isfinite(x) for x in metrics.values()) or not eval_launches["maxsim_bf16"] or \
                (index.dtype, index.num_docs, index._store.device.type) != ("bf16", SMOL_EVAL_PAGES, device.type):
            raise AssertionError(f"evaluate(): {metrics}, index {index.dtype} {index.num_docs}, {eval_launches}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] evaluate(): {SMOL_EVAL_PAGES} held-out pages in {t_eval:.1f} s, bf16 index {index.num_docs} x "
            f"{index.doc_tokens} built on the card and searched by K5 ({eval_launches['maxsim_bf16']} launch(es)); "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items())))
        app.save()
        merged = app.state.adapters.merged_state_dict(model)
        readback = export_readback(device, f"{tmp}/run", merged, cfg, ColIdefics3, "colidefics3", "colSmol-256M")
        del merged
        app.close()

        os.makedirs(f"{tmp}/resumed/checkpoints")
        shutil.copy(f"{tmp}/run/checkpoints/step_{SMOL_RESUME_AT}.pt", f"{tmp}/resumed/checkpoints/")
        shutil.rmtree(f"{tmp}/run")
        resumed = make_app(f"{tmp}/resumed", max_steps=SMOL_RESUME_AT + 1, resume_from_checkpoint=True)
        tail = []
        resumed.train(on_step=lambda step, m: tail.append((step, float(m["loss"]))))
        resumed.close()
        first = seen[SMOL_RESUME_AT][1]
        if [s for s, _ in tail] != [SMOL_RESUME_AT + 1] or abs(tail[0][1] - first) > RESUME_LOSS_RTOL * abs(first):
            raise AssertionError(f"resumed run: {tail}, the first run's step {SMOL_RESUME_AT + 1} loss {first}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] resumed from step {SMOL_RESUME_AT}: step {SMOL_RESUME_AT + 1} loss {tail[0][1]:.8f} vs {first:.8f} in "
            f"the first run (limit {RESUME_LOSS_RTOL} relative)")

        # the recipe's batch of 32, remat on and off (batch 8 four times over: the shapes count, not the pages)
        big = repeat_batch(batch, SMOL_RECIPE_BATCH // TRAIN_BATCH)
        adapters = LoraAdapters(model, peft, seed=SEED + 1)
        state = trainer.create_train_state(model, train_config, adapters)
        steps = {}
        for remat in (True, False):
            model.set_remat(remat)
            steps["remat" if remat else "no_remat"] = r = timed_steps(state, big, loss_fn, peft, SEED, steps=2)
            log(f"  colSmol-256M LoRA step, batch {SMOL_RECIPE_BATCH} (the recipe's), remat {'on' if remat else 'off'} "
                f"({smi}): {r['wall']:.1f} ms/step ({SMOL_RECIPE_BATCH / r['wall'] * 1e3:.1f} examples/s without "
                f"collation), forward {r['forward']:.1f} ms, backward {r['backward']:.1f} ms, optimizer "
                f"{r['optimizer']:.1f} ms, host and idle {r['wall'] - r['forward'] - r['backward'] - r['optimizer']:.1f} "
                f"ms, peak memory {r['peak_gib']:.2f} GiB ({r['allocated_before_gib']:.2f} GiB held before the step)")
        model.set_remat(True)
        step_fn = trainer.make_train_step(loss_fn, peft=peft, seed=SEED)
        steps["batch8_ms"] = timed_steps(state, batch, loss_fn, peft, SEED, steps=2)
        steps["batch8_profile"] = kernel_breakdown(f"one colSmol-256M LoRA step, batch {TRAIN_BATCH}, remat on",
                                                   lambda: step_fn(state, batch)["loss"].item())
        adapters.detach()
        del big, state, adapters
        extra.update(losses=[l for _, l, _ in seen], grad_norms=[g for _, _, g in seen], eval=metrics,
                     examples_per_s_end_to_end=summary["train_samples_per_second"], peak_train_gib=peak_train,
                     step_ms=steps, checkpoint_readback=readback, resumed_loss=tail[0][1], trainable=n_trainable,
                     launches_per_step={"flash_attention_bwd": train_launches["flash_attention_bwd"] // SMOL_TRAIN_STEPS})

        # one step over a stored-int8 frozen vision tower (the model's tower stays int8 from here on)
        qapp = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colidefics3.yaml", f"{tmp}/quant", model, processor, max_steps=1, save_steps=100,
            quantize_frozen_base=True, quant_min_dim=SMOL_QUANT_MIN_DIM)))
        stored = [name for name, m in model.named_modules() if isinstance(m, QDense) and m.stored]
        if len(stored) != SMOL_VISION_STORED or not all(n.startswith("model.vision_model.") for n in stored):
            raise AssertionError(f"quantize_frozen_base stored {len(stored)} layers, expected the vision tower's "
                                 f"{SMOL_VISION_STORED}")
        reset_launches()
        qseen = []
        qapp.train(on_step=lambda step, m: qseen.append(float(m["loss"])))
        torch.cuda.synchronize()
        quant_launches = launch_counts()
        qapp.close()
        if quant_launches["int8_gemm"] != SMOL_VISION_STORED or not quant_launches["quantize_rows"] or \
                len(qseen) != 1 or not np.isfinite(qseen[0]) or \
                quant_launches["bwd_by_head_dim"][t.head_dim] != per_step:
            raise AssertionError(f"quantize_frozen_base step {qseen}, launches {quant_launches}; expected "
                                 f"{SMOL_VISION_STORED} Q1b launches and {per_step} K6 backward launches")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] quantize_frozen_base: {len(stored)} stored-int8 vision layers (the connector stays bf16); one step, "
            f"loss {qseen[0]:.4f}; Q1a {quant_launches['quantize_rows']} and Q1b {quant_launches['int8_gemm']} "
            f"launches, K6 backward {quant_launches['bwd_by_head_dim'][t.head_dim]}")
        extra["quantize_frozen_base"] = dict(stored_layers=len(stored), loss=qseen[0], launches=quant_launches)
        del model, app, qapp, resumed
        torch.cuda.empty_cache()

        # -- (c) BiIdefics3 from train_biidefics3.yaml: queries of unequal lengths, `last` on pad rows ------------
        bmodel = BiIdefics3(cfg, device=device, dtype=torch.bfloat16, remat=True)
        bmodel.load_state_dict(backbone)
        del backbone
        bproc = BiIdefics3Processor.from_pretrained(f"{tmp}/ckpt", device=device)
        bapp = ColModelTraining(ColModelTrainingConfig(**recipe("train_biidefics3.yaml", f"{tmp}/bi", bmodel, bproc,
                                                                max_steps=BI_TRAIN_STEPS, save_steps=100)))
        bpeft, bloss = bapp.config.peft, bapp.config.loss_func
        bbatch = trainer.to_device(VisualRetrieverCollator(bproc)([train_set[i] for i in range(TRAIN_BATCH)]), device)
        pad_rows = int((bbatch["query_attention_mask"][:, -1] == 0).sum())
        if not pad_rows or not isinstance(bloss, BiEncoderLoss):
            raise AssertionError(f"BiIdefics3: {pad_rows} right-padded queries, loss {type(bloss).__name__}")
        reset_launches()
        bseen = []
        with counted_plain() as plain_calls:
            bapp.train(on_step=lambda step, m: bseen.append((float(m["loss"]), float(m["grad_norm"]))))
        torch.cuda.synchronize()
        bi_launches = launch_counts()
        if len(bseen) != BI_TRAIN_STEPS or not np.isfinite(bseen).all() or plain_calls[0] or \
                bi_launches["bwd_by_head_dim"][t.head_dim] != BI_TRAIN_STEPS * per_step:
            raise AssertionError(f"BiIdefics3 steps {bseen}, launches {bi_launches}, plain calls {plain_calls[0]}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] BiIdefics3 (colSmol-256M's backbone, last pooling), ColModelTraining from train_biidefics3.yaml: "
            f"{BiEncoderLoss.__name__}, batch {TRAIN_BATCH} with {pad_rows} right-padded queries (`last` reads a pad "
            "row); " + ", ".join(f"step {i + 1} loss {l:.4f} grad_norm {g:.4f}" for i, (l, g) in enumerate(bseen))
            + f"; K6 backward {bi_launches['flash_attention_bwd']} (by head dim {bi_launches['bwd_by_head_dim']})")
        extra["route_biidefics3"] = hold_bi_routes("BiIdefics3 LoRA", bapp.state, bbatch, bloss, bpeft, bi_probe,
                                                   BiIdefics3(cfg, device=device, dtype=torch.float32, remat=True))
        torch.cuda.empty_cache()
        bapp.close()
        badapters = LoraAdapters(bmodel, bpeft, seed=SEED + 1)
        bstate = trainer.create_train_state(bmodel, train_config, badapters)
        huge = repeat_batch(bbatch, BI_RECIPE_BATCH // TRAIN_BATCH)
        bi_step = timed_steps(bstate, huge, bloss, bpeft, SEED, steps=1)
        log(f"  [{time.perf_counter() - t_phase:.0f} s] BiIdefics3 LoRA step, batch {BI_RECIPE_BATCH} (the recipe's), remat on ({smi}): {bi_step['wall']:.1f} "
            f"ms/step ({BI_RECIPE_BATCH / bi_step['wall'] * 1e3:.1f} examples/s without collation), forward "
            f"{bi_step['forward']:.1f} ms, backward {bi_step['backward']:.1f} ms, optimizer {bi_step['optimizer']:.1f} "
            f"ms, peak memory {bi_step['peak_gib']:.2f} GiB")
        bi_step["batch8_profile"] = kernel_breakdown(
            f"one BiIdefics3 LoRA step, batch {TRAIN_BATCH}, remat on",
            lambda: trainer.make_train_step(bloss, peft=bpeft, seed=SEED)(bstate, bbatch)["loss"].item())
        badapters.detach()
        extra["biidefics3"] = dict(losses=[l for l, _ in bseen], launches=bi_launches, step_ms=bi_step,
                                   right_padded_queries=pad_rows)
        del bmodel, bapp, bstate, badapters, huge, bbatch
        torch.cuda.empty_cache()

    # -- (d) BiPaliProj and BiQwen2_5 at full width cut to 2 + 2 layers: one LoRA step each, the recipes' losses
    # (train_bipali.yaml's, train_biqwen2.yaml's) ------------------------------------------------------------------
    pali_cfg = bi_pali_config()
    cfg25 = qwen_configs()[0]
    cfg25 = dataclasses.replace(cfg25, vision=dataclasses.replace(cfg25.vision, depth=2, fullatt_block_indexes=(1,)),
                                text=dataclasses.replace(cfg25.text, num_hidden_layers=2))
    others = {
        "BiPaliProj": (lambda: BiPaliProj(pali_cfg, device=device, dtype=torch.bfloat16, remat=True),
                       lambda: BiPaliProcessor(WordTokenizer(pali_cfg.image_token_index), device=device),
                       BiPairwiseCELoss(), pali_cfg.text.head_dim, SEED + 64),
        "BiQwen2_5": (lambda: BiQwen2_5(cfg25, device=device, dtype=torch.bfloat16, remat=True),
                      lambda: BiQwen2_5_Processor(qwen_tokenizer(), max_num_visual_tokens=768, device=device),
                      BiEncoderLoss(), cfg25.text.head_dim, SEED + 65),
    }
    small_set = smol_dataset(TRAIN_BATCH, SEED + 66)
    other_out = {}
    for name, (build, make_proc, other_loss, head_dim, seed) in others.items():
        m = build()
        hf_init_(m, torch.Generator(device=device).manual_seed(seed))
        proc = make_proc()
        with tempfile.TemporaryDirectory() as out:
            oapp = ColModelTraining(ColModelTrainingConfig(
                model=m, processor=proc, loss_func=other_loss, train_datasets=[small_set], output_dir=out,
                global_batch_size=TRAIN_BATCH, log_steps=1, save_steps=100, peft=LoraSpec(rank=32, alpha=32,
                                                                                            dropout=0.1),
                train=train_config, seed=SEED, device=device, max_steps=1))
            reset_launches()
            oloss = []
            with counted_plain() as plain_calls:
                oapp.train(on_step=lambda step, mt: oloss.append(float(mt["loss"])))
            torch.cuda.synchronize()
            o_launches = launch_counts()
            obatch = trainer.to_device(VisualRetrieverCollator(proc)([small_set[i] for i in range(TRAIN_BATCH)]),
                                       device)
            expect = 2 * 2  # a query and a page forward, 2 text layers; the frozen tower takes none
            if len(oloss) != 1 or not np.isfinite(oloss[0]) or plain_calls[0] or \
                    o_launches["bwd_by_head_dim"][head_dim] != expect or \
                    sum(o_launches["bwd_by_head_dim"].values()) != expect:
                raise AssertionError(f"{name} LoRA step: loss {oloss}, launches {o_launches}, plain calls "
                                     f"{plain_calls[0]}; expected {expect} backward launches at D={head_dim}")
            log(f"  [{time.perf_counter() - t_phase:.0f} s] {name} at full width, 2 + 2 layers, one LoRA step through ColModelTraining "
                f"({type(other_loss).__name__}): loss {oloss[0]:.4f}; K6 backward by head dim "
                f"{ {d: n for d, n in o_launches['bwd_by_head_dim'].items() if n} }")
            other_out[name] = dict(loss=oloss[0], launches=o_launches,
                                   route=hold_routes(f"{name} LoRA", oapp.state, obatch, other_loss, oapp.config.peft,
                                                     bi_probe))
            oapp.close()
        del m, oapp, obatch
        torch.cuda.empty_cache()
    extra["other_bi"] = other_out
    extra["seconds"] = time.perf_counter() - t_phase
    log(f"phase colsmol training: {extra['seconds']:.1f} s")
    launches = dict(flash_attention_bwd=train_launches["flash_attention_bwd"],
                    flash_attention=train_launches["flash_attention"] + eval_launches["flash_attention"],
                    maxsim_bf16=eval_launches["maxsim_bf16"], quantize_rows=quant_launches["quantize_rows"],
                    int8_gemm=quant_launches["int8_gemm"])
    extra["launches_by_head_dim"] = {str(d): n for d, n in by_dim.items()}
    return launches, k6_bwd, extra


# -- phase 12: the Gemma3 family (ColGemma3, BiGemma3) at Gemma3-4B's widths ------------------------------------

GEMMA_PAGES = 16  # two batches of 8
GEMMA_PLANTED = (1, 6, 10, 13)  # pages whose docs also hold QUERIES[i]'s tokens, i = 0..3
GEMMA_INDEX_DOCS = 4_096  # the pages and seeded filler docs at the pages' token count
GEMMA_BI_DIM = 768  # BiGemma3's smallest Matryoshka cut
# phases 12-13 run Gemma3-4B cut in depth, to keep the script's time with phases 14-15: 9 SigLIP layers
# of 27 and 12 text layers of 34 (two of them global, as every 6th of the published 34)
GEMMA_DEPTHS = (9, 12)


def gemma3_config():
    """Gemma3-4B (``google/gemma-3-4b-it``'s widths, the JAX package's defaults): SigLIP-So400m at 896 px
    (27 x 1,152, 16 heads of 72, 64 x 64 patches pooled to 256 soft tokens), the text decoder 34 x 2,560 (8/4
    heads of 256, MLP 10,240, vocab 262,208, window 1,024, every 6th layer global); cut to :data:`GEMMA_DEPTHS`."""
    import dataclasses

    from colpali_tpu_torch.models.gemma3 import Gemma3Config

    cfg = Gemma3Config()
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, num_hidden_layers=GEMMA_DEPTHS[0]),
                               text=dataclasses.replace(cfg.text, num_hidden_layers=GEMMA_DEPTHS[1]))


def gemma3_stored_layers(cfg, vision_only: bool = False) -> int:
    """Gemma3's stored-int8 layers (JAX's quantize_params over the same tree, tests/test_torch_gemma3.py): 6 a
    SigLIP layer and 7 a text layer (k/v 2,560 -> 1,024 included); the patch embedding, the raw
    mm_input_projection, the embeddings and the 128-d head stay bf16."""
    return cfg.vision.num_hidden_layers * 6 + (0 if vision_only else cfg.text.num_hidden_layers * 7)


def biased_attention_case(gen: torch.Generator, device: torch.device, feed: dict, cfg) -> dict:
    """The text attention's biased path (no kernel: XLA's einsum route in
    JAX) at a page batch's shape, under Gemma3's sliding-window bias with
    its image blocks: CUDA events beside SDPA with the same mask as a
    boolean (every row of a page batch sees a key), its bound over the
    attended pairs, and its gap to SDPA."""
    from colpali_tpu_torch.models.gemma3 import gemma3_attention_bias
    from colpali_tpu_torch.models.layers import biased_attention

    t = cfg.text
    ids, mask = feed["input_ids"], feed["attention_mask"]
    b, s = ids.shape
    h, hkv, d = t.num_attention_heads, t.num_key_value_heads, t.head_dim
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=device).to(torch.bfloat16) for n in (h, hkv, hkv))
    bias = gemma3_attention_bias(mask, ids == cfg.image_token_index, t.sliding_window)
    scale = t.query_pre_attn_scalar**-0.5
    allowed = bias == 0  # (B, 1, S, S)
    out = biased_attention(q, k, v, bias, scale)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed, scale=scale, enable_gqa=True)

    gap = (out.float() - sdpa().transpose(1, 2).float()).abs().max().item()
    pairs = allowed.sum().item()
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * bias.numel()
    r = dict(ms=time_ms(lambda: biased_attention(q, k, v, bias, scale)), library_ms=time_ms(sdpa), max_abs_vs_sdpa=gap,
             **bound(nbytes, 4 * pairs * h * d, "bf16"), shape=f"B={b} S={s} H={h} Hkv={hkv} D={d}, sliding window "
             f"{t.sliding_window} and image blocks")
    return dict(r, **rates(4 * pairs * h * d, r))


def phase_gemma3(device: torch.device, smi: str, ckpt: str) -> tuple:
    """Drive the Gemma3 family's serving path: Gemma3-4B written by
    ``write_gemma3_checkpoint`` into ``ckpt`` and read back by
    ``load_retriever(family="colgemma3")`` in bf16 and stored int8; K6 at
    the vision tower's shape (D=72, S=4,096) and the biased text attention
    timed; Q1a/Q1b at the path's (M, K, N); pages through
    ``embed_dataset``, ``/search_text`` through ``make_handler`` and
    ``serve.py --checkpoint --family colgemma3``; the K6 route against the
    plain route, stored int8 against bf16; forward and encode timings and
    profiles; then BiGemma3 at full width. Returns the launches over the
    path, the kernel rows and the rest."""
    import os
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.core.hf_loader import load_colgemma3_params
    from colpali_tpu_torch.evaluation.evaluator import embed_dataset
    from colpali_tpu_torch.models.gemma3 import BiGemma3
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.processors.gemma3 import BiGemma3Processor
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.retrieval.store import CorpusIndex
    from colpali_tpu_torch.serve import RetrievalServer
    from colpali_tpu_torch.utils.testing import write_gemma3_checkpoint

    held = free_memory("phase gemma3")
    t_phase = time.perf_counter()
    cfg = gemma3_config()
    v, t = cfg.vision, cfg.text
    pages = make_pages(GEMMA_PAGES, SEED + 70)
    extra = dict(held_gib_at_start=held)
    t0 = time.perf_counter()
    write_gemma3_checkpoint(ckpt, cfg, seed=SEED + 71, words=" ".join(QUERIES).split(), device=device)
    torch.cuda.empty_cache()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, processor = load_retriever(ckpt, family="colgemma3", device=device)
    torch.cuda.synchronize()
    t_bf16 = time.perf_counter() - t0
    t0 = time.perf_counter()
    qmodel, qproc = load_retriever(ckpt, family="colgemma3", device=device, quantize=True)
    torch.cuda.synchronize()
    t_int8 = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    stored = sum(isinstance(m, QDense) and m.stored for m in qmodel.modules())
    bytes_int8, bytes_bf16 = (sum(x.numel() * x.element_size() for x in m.state_dict().values())
                              for m in (qmodel, model))
    log(f"phase gemma3: Gemma3-4B, vision {v.num_hidden_layers} x {v.hidden_size} (MLP {v.intermediate_size}, "
        f"{v.num_attention_heads} heads x {v.head_dim}, {v.image_size} px, {v.num_patches} patches pooled to "
        f"{cfg.mm_tokens_per_image} soft tokens), text {t.num_hidden_layers} x {t.hidden_size} (MLP "
        f"{t.intermediate_size}, heads {t.num_attention_heads}/{t.num_key_value_heads} x {t.head_dim}, vocab "
        f"{t.vocab_size}, window {t.sliding_window}, one layer in {t.sliding_window_pattern} global): "
        f"{n_params / 1e9:.3f} B params; HF checkpoint written in {t_write:.1f} s, load_retriever {t_bf16:.1f} s "
        f"(bf16), {t_int8:.1f} s (quantize=True: {stored} stored-int8 layers, {bytes_int8 / 1e9:.3f} GB against "
        f"{bytes_bf16 / 1e9:.3f} GB)")
    if stored != gemma3_stored_layers(cfg):
        raise AssertionError(f"load_retriever(quantize=True): {stored} stored-int8 layers, expected "
                             f"{gemma3_stored_layers(cfg)}")
    batch = pages[:PAGE_BATCH]
    feed = {k: torch.as_tensor(x).to(device) for k, x in processor.process_images(batch, device_pixels=True).items()}
    page_tokens = feed["input_ids"].shape[1]
    n_image = (feed["input_ids"] == cfg.image_token_index).sum(1)
    if not bool((n_image == cfg.mm_tokens_per_image).all()) or tuple(feed["pixel_values"].shape[1:3]) != \
            (v.image_size, v.image_size):
        raise AssertionError(f"a page: {n_image.tolist()} image tokens, pixels {tuple(feed['pixel_values'].shape)}")
    encoders = {"bf16": QueryEncoder(model, processor), "int8": QueryEncoder(qmodel, qproc)}
    for enc in encoders.values():
        enc.warmup()

    # K6 at the vision tower's shape, and the biased text attention (no kernel), each timed
    gen = torch.Generator(device=device).manual_seed(SEED + 72)
    k6 = k6_case(gen, device, PAGE_BATCH, v.num_patches, v.num_attention_heads, v.num_attention_heads, v.head_dim,
                 None, label=" (SigLIP-So400m at 896 px, 8 pages)")
    log(f"phase gemma3: K6 vision [{k6['shape']}]: kernel {k6['ms']:.3f} ms, plain {k6['plain_ms']:.3f} ms, "
        f"{library_note(k6)}, bound {k6['bound_ms']:.4f} ms ({k6['bound_by']}), max_abs_err {k6['max_abs_err']:.3g} "
        f"(atol {k6['atol']:.3g}, {k6['limit_share']:.0%} of the tolerance), bit-equal on a second call")
    torch.cuda.empty_cache()
    biased = biased_attention_case(gen, device, feed, cfg)
    log(f"phase gemma3: biased text attention [{biased['shape']}] (no kernel): {biased['ms']:.3f} ms, SDPA with the "
        f"mask as booleans {biased['library_ms']:.3f} ms (max abs gap {biased['max_abs_vs_sdpa']:.3g}), bound "
        f"{biased['bound_ms']:.4f} ms ({biased['bound_by']}), {biased['bound_share']:.1%} of it; "
        f"{t.num_hidden_layers} a page forward and a query forward")

    # Q1a/Q1b at the (M, K, N) of one stored-int8 page forward and the query forwards (x8, x1), by hooks
    with torch.inference_mode():
        page_mkn = q1_path_shapes(qmodel, lambda: qmodel(**feed))
    query_mkn = q1_path_shapes(qmodel, lambda: (encoders["int8"].encode(QUERIES),
                                                encoders["int8"].encode(QUERIES[:1])))
    checks = q1_checks(device, page_mkn + query_mkn, edge_ks=(1152, 10240))
    log(f"phase gemma3: Q1a and Q1b bit-equal to their plain versions in {checks['q1b_cases']} Q1b cases at the page "
        f"forward's (M, K, N) {page_mkn} and the query forwards' {query_mkn}; Q1a on edge rows at K 1,152 and 10,240")
    q1_rows, q1_gemms = q1_timing(device, page_mkn + query_mkn)
    extra["q1_checks"] = dict(checks, page_forward_mkn=page_mkn, query_forward_mkn=query_mkn)

    # K6 launches of one page forward and one query forward
    reset_launches()
    with torch.inference_mode():
        model(**feed)
    per_page_forward = dict(fa.FORWARD_LAUNCHES_BY_HEAD_DIM)
    reset_launches()
    encoders["bf16"].encode(QUERIES)
    per_query_forward = fa.FLASH_ATTENTION.launches
    if {d: n for d, n in per_page_forward.items() if n} != {v.head_dim: v.num_hidden_layers} or per_query_forward:
        raise AssertionError(f"K6 launches: a page forward {per_page_forward}, a query forward {per_query_forward}; "
                             f"expected {v.num_hidden_layers} at D={v.head_dim} and none")

    # the path, counted: pages embedded, /search_text through make_handler on each model, serve.py
    reset_launches()
    with counted_plain() as plain_calls:
        t0 = time.perf_counter()
        embs = {"bf16": embed_dataset(model, processor, pages, batch_size=PAGE_BATCH)}
        t_embed_bf16 = time.perf_counter() - t0
        t0 = time.perf_counter()
        embs["int8"] = embed_dataset(qmodel, qproc, pages, batch_size=PAGE_BATCH)
        t_embed_int8 = time.perf_counter() - t0
        for label, es in embs.items():
            for e in es:
                if e.shape[0] != page_tokens or not np.isfinite(e).all() or \
                        np.abs(np.linalg.norm(e, axis=-1) - 1).max() > 1e-2:
                    raise AssertionError(f"{label} page embedding {e.shape}: not {page_tokens} finite unit rows")
        gen = torch.Generator(device=device).manual_seed(SEED + 73)
        filler = torch.randn((GEMMA_INDEX_DOCS - GEMMA_PAGES, page_tokens, DIM), generator=gen, device=device)
        filler = (filler / filler.norm(dim=-1, keepdim=True)).cpu().numpy()
        served, corpora = {}, {}
        for label, enc in encoders.items():
            planted_q = enc.encode(QUERIES[: len(GEMMA_PLANTED)])
            docs = [np.concatenate([e, planted_q[GEMMA_PLANTED.index(i)]]) if i in GEMMA_PLANTED else e
                    for i, e in enumerate(embs[label])] + list(filler)
            corpora[label] = docs
            index = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
            httpd = RetrievalServer(("127.0.0.1", 0), serve.make_handler(
                index, [f"doc_{i}" for i in range(index.num_docs)], encoder=enc))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_port}"
            try:
                tiered = [_http(url, "/search_text", {"queries": [q], "k": 10})
                          for q in QUERIES[: len(GEMMA_PLANTED)]]  # one a request: the tiered route
                exact = _http(url, "/search_text", {"queries": QUERIES, "k": 10})  # 8 > 4: the exact route
            finally:
                httpd.shutdown()
                httpd.server_close()
            for out in (*tiered, exact):
                _check_ranked(f"/search_text ({label})", out, len(out["doc_ids"]))
            top = ([out["doc_ids"][0][0] for out in tiered], [row[0] for row in exact["doc_ids"][: len(GEMMA_PLANTED)]])
            if top[0] != list(GEMMA_PLANTED) or top[1] != list(GEMMA_PLANTED):
                raise AssertionError(f"{label} /search_text at rank 1: tiered {top[0]}, exact {top[1]}, planted "
                                     f"{list(GEMMA_PLANTED)}")
            served[label] = (index, planted_q)
        npz = f"{ckpt}/corpus.npz"
        np.savez(npz, **{f"emb_{i}": d for i, d in enumerate(corpora["int8"])})
        t0 = time.perf_counter()
        httpd = serve.make_server([npz, "--port", "0", "--device", str(device), "--prefilter", "--checkpoint", ckpt,
                                   "--family", "colgemma3"])
        t_serve = time.perf_counter() - t0
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            cli = _http(f"http://127.0.0.1:{httpd.server_port}", "/search_text", {"queries": [QUERIES[0]], "k": 10})
        finally:
            httpd.shutdown()
            httpd.server_close()
        os.remove(npz)
        if cli["doc_ids"][0][0] != GEMMA_PLANTED[0]:
            raise AssertionError(f"serve.py --family colgemma3: rank 1 {cli['doc_ids'][0][0]}, planted "
                                 f"{GEMMA_PLANTED[0]}")
    launches = read_launches("Gemma3", ("flash_attention", "quantize_rows", "int8_gemm", "binary_maxsim",
                                        "gather_rerank", "maxsim_int8"))
    by_dim = {d: n for d, n in fa.FORWARD_LAUNCHES_BY_HEAD_DIM.items() if n}
    page_forwards = 2 * (GEMMA_PAGES // PAGE_BATCH)  # embed_dataset on each model; the queries launch none
    if plain_calls[0] or by_dim != {v.head_dim: page_forwards * v.num_hidden_layers}:
        raise AssertionError(f"Gemma3 path: K6 launches by head dim {by_dim}, {plain_calls[0]} calls of K6's plain "
                             f"version; expected {v.num_hidden_layers} at D={v.head_dim} a page forward, "
                             f"{page_forwards} page forwards")
    log(f"  [{time.perf_counter() - t_phase:.0f} s] path: {GEMMA_PAGES} pages ({page_tokens} tokens) through "
        f"embed_dataset, each model warm (bf16 {GEMMA_PAGES / t_embed_bf16 * 60:.0f} pages/min, stored int8 "
        f"{GEMMA_PAGES / t_embed_int8 * 60:.0f}); a {served['int8'][0].num_docs}-doc x {served['int8'][0].doc_tokens}"
        f"-token two-tier int8 index behind make_handler for each model: each of {len(GEMMA_PLANTED)} planted pages "
        f"at rank 1 on the tiered and the exact route of /search_text; serve.py --checkpoint --family colgemma3 "
        f"(stored int8) started in {t_serve:.1f} s and found it too; launches {launches}, K6 by head dim {by_dim} "
        f"({v.num_hidden_layers} a page forward, none a query forward), K6's plain version called {plain_calls[0]} "
        "times")
    del corpora, filler

    k123 = {}
    for label, (index, planted_q) in served.items():
        held_k = hold_k123(index, served_queries(planted_q, device))
        k123[label] = {k: held_k[k] for k in ("k1_err", "k2_err", "k3_err")}
        log(f"phase gemma3: K1, K2 and K3 against their plain versions on the {label} index ({index.num_docs} docs x "
            f"Np={index.doc_tokens}): max abs err K1 {held_k['k1_err']:.3g} (bit for bit), K2 {held_k['k2_err']:.3g}, "
            f"K3 {held_k['k3_err']:.3g} (rtol {RTOL}, atol {ATOL})")
    del served, index, held_k
    torch.cuda.empty_cache()

    # checks beside the path (not counted): K6 route vs plain route, stored int8 vs bf16
    route = dict(
        pages=forward_check(f"Gemma3-4B page forward ({PAGE_BATCH} pages)",
                            lambda: embed_dataset(model, processor, batch, batch_size=PAGE_BATCH)),
        queries=forward_check(f"Gemma3-4B query forward ({len(QUERIES)} queries)",
                              lambda: encoders["bf16"].encode(QUERIES)))
    for name, r in route.items():
        log(f"    shares of the limits: mean cos {share(1 - r['mean_cos'], 1 - FORWARD_COS_MEAN)}, min cos "
            f"{share(1 - r['min_cos'], 1 - FORWARD_COS_MIN)}, max abs {share(r['max_abs'], FORWARD_ATOL)}")
    torch.cuda.empty_cache()
    accuracy = {
        "pages": cos_check(f"{PAGE_BATCH} pages, stored int8 vs bf16", embs["int8"][:PAGE_BATCH],
                           embs["bf16"][:PAGE_BATCH], INT8_COS_MEAN, INT8_COS_MIN),
        "queries": cos_check(f"{len(QUERIES)} queries, stored int8 vs bf16", encoders["int8"].encode(QUERIES),
                             encoders["bf16"].encode(QUERIES), INT8_COS_MEAN, INT8_COS_MIN)}

    # end to end, bf16 and stored int8 in turns: one forward of 8 pages (CUDA events), encode x1 / x8
    e2e = {}
    for label in ("bf16", "int8", "int8 again", "bf16 again"):
        m, enc = (model, encoders["bf16"]) if label.startswith("bf16") else (qmodel, encoders["int8"])
        r = dict(page_forward_ms=forward_ms(m, feed))
        for b_, texts in (("x1", QUERIES[:1]), ("x8", QUERIES)):
            enc.encode(texts)
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                enc.encode(texts)
                walls.append((time.perf_counter() - t0) * 1e3)
            r[f"encode_{b_}_ms"] = float(np.median(walls))
        r["pages_per_min_forward"] = PAGE_BATCH / r["page_forward_ms"] * 6e4
        e2e[label] = r
        log(f"  {label} ({smi}): forward of {PAGE_BATCH} pages {r['page_forward_ms']:.1f} ms "
            f"({r['pages_per_min_forward']:.0f} pages/min of forward alone), encode x1 {r['encode_x1_ms']:.2f} ms, "
            f"x8 {r['encode_x8_ms']:.2f} ms")
    with torch.inference_mode():
        profiles = {label: kernel_breakdown(f"one {label} Gemma3-4B forward of {PAGE_BATCH} pages",
                                            lambda m=m: m(**feed)) for label, m in (("bf16", model),
                                                                                   ("stored-int8", qmodel))}
    query_feed = {k: torch.as_tensor(x).to(device) for k, x in processor.process_queries(QUERIES).items()}
    del encoders, qmodel, embs
    torch.cuda.empty_cache()

    # BiGemma3 at full width on the checkpoint's backbone, its first 768 dims
    bmodel = BiGemma3(cfg, embedding_dim=GEMMA_BI_DIM, device=device, dtype=torch.bfloat16).eval()
    del model
    torch.cuda.empty_cache()
    bmodel.load_state_dict({k: x for k, x in load_colgemma3_params(ckpt).items() if k.startswith("model.")})
    bproc = BiGemma3Processor.from_pretrained(ckpt, device=device)
    bi = bi_check(f"BiGemma3 (Gemma3-4B, mean pooling, embedding_dim {GEMMA_BI_DIM})", bmodel, [feed, query_feed],
                  device, bproc.score, BI_PLANTED)
    del bmodel, feed, query_feed
    torch.cuda.empty_cache()
    extra.update(k6_vision=k6, biased_attention=biased, k123=k123, params=n_params, stored_int8_layers=stored,
                 weight_bytes_int8=bytes_int8, weight_bytes_bf16=bytes_bf16, page_tokens=page_tokens,
                 route_check=route, int8_vs_bf16=accuracy, end_to_end=e2e, page_profile=profiles, bigemma3=bi,
                 k6_per_page_forward=per_page_forward[v.head_dim], k6_per_query_forward=per_query_forward,
                 launches_by_head_dim={str(d): n for d, n in by_dim.items()},
                 pages_per_min=dict(bf16=GEMMA_PAGES / t_embed_bf16 * 60, int8=GEMMA_PAGES / t_embed_int8 * 60),
                 write_load_seconds=dict(write=t_write, bf16=t_bf16, int8=t_int8))
    extra["seconds"] = time.perf_counter() - t_phase
    log(f"phase gemma3: {extra['seconds']:.1f} s")
    timings = {"flash_attention": k6, "quantize_rows": dict(shapes=q1_rows), "int8_gemm": dict(shapes=q1_gemms)}
    return launches, timings, extra


# -- phase 13: Gemma3 training (run after phase 12, on its checkpoint) -----------------------------------------------

GEMMA_TRAIN_PAGES = 32  # four batches of 8
GEMMA_EVAL_PAGES = 16
GEMMA_TRAIN_STEPS, GEMMA_BI_STEPS = 4, 2
# TIED_MARGIN holds the ColbertLoss off ln B. On seeded random weights every query token's hard max falls on the 4
# template tokens that open every Gemma3 page (<bos><start_of_turn>user\n; causal, so the same in all pages), and the
# loss reads ln 8 exactly; phase 13 trains with mask_non_image_embeddings, which scores a page by its 256 image tokens


def page_score_spread(model, batch: dict, image_token: int, loss_fn=None) -> dict:
    """The in-batch MaxSim scores (normalized by the query's length) of a
    collated batch under ``model``, with the page's non-image tokens kept
    and masked (zeroed, as ``mask_non_image_embeddings`` does, on any
    model): the least spread of a query's scores across the pages, the
    share of query tokens whose best page token lies outside the image
    tokens (the template, the same in every page), and given ``loss_fn``
    its value on the batch."""
    from colpali_tpu_torch.training.trainer import forward_prefixed

    out = {}
    valid = batch["query_attention_mask"].bool()
    image = batch["doc_input_ids"] == image_token
    masking = getattr(model, "mask_non_image_embeddings", False)
    if masking:
        model.mask_non_image_embeddings = False
    try:
        with torch.no_grad():
            q = forward_prefixed(model, batch, "query_").float()
            d_kept = forward_prefixed(model, batch, "doc_").float()
    finally:
        if masking:
            model.mask_non_image_embeddings = True
    with torch.no_grad():
        for masked in (False, True):
            d = d_kept * image[..., None] if masked else d_kept
            best, at = torch.einsum("bnd,csd->bcns", q, d).max(-1)
            scores = best.sum(-1) / valid.sum(1, keepdim=True)
            on_template = ~torch.gather(image[None, :, None, :].expand(q.shape[0], -1, q.shape[1], -1), 3,
                                        at[..., None])[..., 0]
            out["masked" if masked else "unmasked"] = dict(
                min_spread=(scores.max(1).values - scores.min(1).values).min().item(),
                on_template=on_template[valid[:, None].expand_as(at)].float().mean().item(),
                **({} if loss_fn is None else {"loss": loss_fn(q, d).item()}))
    return out


def phase_gemma3_training(device: torch.device, smi: str, ckpt: str) -> tuple:
    """Drive the Gemma3 family's training path on phase 12's checkpoint:
    Gemma3-4B read by ``load_retriever(family="colgemma3", remat=True)`` and
    trained through ``ColModelTraining`` from ``configs/train_colgemma3.yaml``'s
    loss and LoRA (4 steps at batch 8 over 32 pages; the text attention is
    biased, so no K6 backward runs: the tower is frozen and K6 runs its
    forward), the plain route, ``evaluate()`` (K5), the merged export read
    back and served, a step timed with and without remat and profiled, one
    step over a stored-int8 frozen vision tower; then BiGemma3 from
    ``train_bigemma3.yaml`` (2 steps). ColGemma3 trains with
    ``mask_non_image_embeddings`` (:data:`TIED_MARGIN`): the
    ColbertLoss of the first step and of the stored-int8 step, each taken
    with fresh adapters, must lie that far from ln 8 (the eval's, after 4
    steps that flatten the scores, need not). Returns the launches over the
    path and the rest."""
    import math

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.core.hf_loader import load_colgemma3_params
    from colpali_tpu_torch.data.collator import VisualRetrieverCollator
    from colpali_tpu_torch.losses import BiEncoderLoss, ColbertLoss
    from colpali_tpu_torch.models.gemma3 import BiGemma3, ColGemma3
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.processors.gemma3 import BiGemma3Processor
    from colpali_tpu_torch.training import trainer
    from colpali_tpu_torch.training.lora import LoraAdapters
    from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig

    held = free_memory("phase gemma3 training")
    t_phase = time.perf_counter()
    cfg = gemma3_config()
    v = cfg.vision
    train_config = trainer.TrainConfig(learning_rate=QWEN_LR, warmup_steps=0, total_steps=2500)
    train_set = smol_dataset(GEMMA_TRAIN_PAGES, SEED + 74)
    eval_set = smol_dataset(GEMMA_EVAL_PAGES, SEED + 75, first=GEMMA_TRAIN_PAGES)
    extra = dict(held_gib_at_start=held)
    model, processor = load_retriever(ckpt, family="colgemma3", device=device, remat=True,
                                      mask_non_image_embeddings=True)
    batch = trainer.to_device(VisualRetrieverCollator(processor)([train_set[i] for i in range(TRAIN_BATCH)]), device)
    tied = math.log(TRAIN_BATCH)
    spread = page_score_spread(model, batch, cfg.image_token_index)
    log(f"  Gemma3-4B, the first batch's in-batch scores: page tokens kept, {spread['unmasked']['on_template']:.1%} "
        f"of the query tokens' maxima on the template that opens every page, least spread of a query's scores "
        f"across the pages {spread['unmasked']['min_spread']:.5f}; non-image tokens masked (as trained here), "
        f"{spread['masked']['on_template']:.1%} and {spread['masked']['min_spread']:.5f}")
    if not spread["masked"]["min_spread"] > 0:
        raise AssertionError(f"Gemma3-4B: a query scores every page of the batch alike under "
                             f"mask_non_image_embeddings: {spread}")
    extra["score_spread"] = spread

    recipe = functools.partial(recipe_config, train_set=train_set, train_config=train_config, device=device)

    with tempfile.TemporaryDirectory() as tmp:
        app = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colgemma3.yaml", f"{tmp}/run", model, processor, eval_dataset=eval_set,
            eval_batch_size=TRAIN_BATCH, max_steps=GEMMA_TRAIN_STEPS, save_steps=100)))
        peft, loss_fn = app.config.peft, app.config.loss_func
        if not isinstance(loss_fn, ColbertLoss) or loss_fn.temperature != 0.02:
            raise AssertionError(f"train_colgemma3.yaml's loss: {loss_fn}")
        n_adapters, n_trainable = len(app.state.adapters.paths), sum(p.numel() for p in app.state.params)
        seen, moved = [], []

        def on_step(step, metrics):
            seen.append((step, float(metrics["loss"]), float(metrics["grad_norm"])))
            if step == 1:
                moved.extend(bool(b.detach().abs().max() > 0) for b in app.state.adapters.b)

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with counted_plain() as plain_calls:
            summary = app.train(on_step=on_step)
        torch.cuda.synchronize()
        train_launches = launch_counts()
        peak_train = torch.cuda.max_memory_allocated() / 2**30
        per_step = v.num_hidden_layers  # one page forward a step through the frozen tower; the queries take none
        if [s for s, _, _ in seen] != list(range(1, GEMMA_TRAIN_STEPS + 1)) or \
                not all(np.isfinite(l) and l > 0 and np.isfinite(g) and g > 0 for _, l, g in seen):
            raise AssertionError(f"Gemma3-4B steps: {seen}")
        if len(moved) != n_adapters or not all(moved):
            raise AssertionError(f"{moved.count(False)} of {n_adapters} adapters did not move in step 1")
        if abs(seen[0][1] - tied) < TIED_MARGIN:
            raise AssertionError(f"Gemma3-4B step 1: ColbertLoss {seen[0][1]:.6f}, within {TIED_MARGIN} of "
                                 f"ln {TRAIN_BATCH} = {tied:.6f}: the pages score alike")
        if train_launches["flash_attention"] != GEMMA_TRAIN_STEPS * per_step or \
                train_launches["flash_attention_bwd"] or plain_calls[0]:
            raise AssertionError(f"K6 over {GEMMA_TRAIN_STEPS} Gemma3 LoRA steps: {train_launches}, {plain_calls[0]} "
                                 f"calls of the plain version; expected {per_step} forward launches a step and no "
                                 "backward (the tower is frozen, the text attention biased)")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] Gemma3-4B, ColModelTraining from train_colgemma3.yaml "
            f"({smi}): {n_adapters} adapted layers, {n_trainable / 1e6:.2f} M trainable parameters, "
            f"{type(loss_fn).__name__}(temperature {loss_fn.temperature}), LoRA r{peft.rank} a{peft.alpha:g} dropout "
            f"{peft.dropout}, remat, batch {TRAIN_BATCH}; "
            + ", ".join(f"step {s} loss {l:.4f} grad_norm {g:.4f}" for s, l, g in seen)
            + f"; {summary['train_samples_per_second']:.2f} examples/s with collation and checkpoints; K6 forward "
            f"{train_launches['flash_attention']} ({per_step} a step, D={v.head_dim}), backward "
            f"{train_launches['flash_attention_bwd']}, K6's plain version called {plain_calls[0]} times; peak memory "
            f"{peak_train:.2f} GiB")
        extra["route"] = hold_routes("Gemma3-4B LoRA", app.state, batch, loss_fn, peft)

        reset_launches()
        t0 = time.perf_counter()
        metrics = app.evaluate()
        t_eval = time.perf_counter() - t0
        eval_launches = launch_counts()
        index = app.eval_index
        if not {"eval_loss", "eval_ndcg@1", "eval_ndcg@5"} <= set(metrics) or \
                not all(np.isfinite(x) for x in metrics.values()) or not eval_launches["maxsim_bf16"] or \
                (index.dtype, index.num_docs, index._store.device.type) != ("bf16", GEMMA_EVAL_PAGES, device.type):
            raise AssertionError(f"evaluate(): {metrics}, index {index.dtype} {index.num_docs}, {eval_launches}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] evaluate(): {GEMMA_EVAL_PAGES} held-out pages in {t_eval:.1f} "
            f"s, bf16 index {index.num_docs} x {index.doc_tokens} built on the card and searched by K5 "
            f"({eval_launches['maxsim_bf16']} launch(es)); " + ", ".join(f"{k} {x:.4f}" for k, x in sorted(metrics.items())))
        app.save()
        merged = app.state.adapters.merged_state_dict(model)
        app.close()
        readback = export_readback(device, f"{tmp}/run", merged, cfg, ColGemma3, "colgemma3", "Gemma3-4B")
        del merged

        # a step at batch 8 with and without remat, and a profile of one
        adapters = LoraAdapters(model, peft, seed=SEED + 1)
        state = trainer.create_train_state(model, train_config, adapters)
        steps = {}
        for remat in (True, False):
            model.set_remat(remat)
            steps["remat" if remat else "no_remat"] = r = timed_steps(state, batch, loss_fn, peft, SEED, steps=2)
            log(f"  Gemma3-4B LoRA step, batch {TRAIN_BATCH}, remat {'on' if remat else 'off'} ({smi}): "
                f"{r['wall']:.1f} ms/step ({TRAIN_BATCH / r['wall'] * 1e3:.1f} examples/s without collation), forward "
                f"{r['forward']:.1f} ms, backward {r['backward']:.1f} ms, optimizer {r['optimizer']:.1f} ms, host and "
                f"idle {r['wall'] - r['forward'] - r['backward'] - r['optimizer']:.1f} ms, peak memory "
                f"{r['peak_gib']:.2f} GiB ({r['allocated_before_gib']:.2f} GiB held before the step)")
        model.set_remat(True)
        step_fn = trainer.make_train_step(loss_fn, peft=peft, seed=SEED)
        steps["profile"] = kernel_breakdown(f"one Gemma3-4B LoRA step, batch {TRAIN_BATCH}, remat on",
                                            lambda: step_fn(state, batch)["loss"].item())
        adapters.detach()
        del state, adapters
        extra.update(losses=[l for _, l, _ in seen], grad_norms=[g for _, _, g in seen], eval=metrics,
                     examples_per_s_end_to_end=summary["train_samples_per_second"], peak_train_gib=peak_train,
                     step_ms=steps, checkpoint_readback=readback, trainable=n_trainable,
                     launches_per_step={"flash_attention": per_step, "flash_attention_bwd": 0})

        # one step over a stored-int8 frozen vision tower (the model's tower stays int8 from here on)
        qapp = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colgemma3.yaml", f"{tmp}/quant", model, processor, max_steps=1, save_steps=100,
            quantize_frozen_base=True)))
        stored = [name for name, m in model.named_modules() if isinstance(m, QDense) and m.stored]
        vision_stored = gemma3_stored_layers(cfg, vision_only=True)  # q/k/v/o, fc1 and fc2 of each SigLIP layer
        if len(stored) != vision_stored or not all(n.startswith("model.vision_tower.") for n in stored):
            raise AssertionError(f"quantize_frozen_base stored {len(stored)} layers, expected the vision tower's "
                                 f"{vision_stored}")
        reset_launches()
        qseen = []
        qapp.train(on_step=lambda step, m: qseen.append(float(m["loss"])))
        torch.cuda.synchronize()
        quant_launches = launch_counts()
        qapp.close()
        if quant_launches["int8_gemm"] != vision_stored or not quant_launches["quantize_rows"] or \
                len(qseen) != 1 or not np.isfinite(qseen[0]) or abs(qseen[0] - tied) < TIED_MARGIN or \
                quant_launches["flash_attention"] != per_step:
            raise AssertionError(f"quantize_frozen_base step {qseen}, launches {quant_launches}; expected "
                                 f"{vision_stored} Q1b launches and {per_step} K6 launches")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] quantize_frozen_base: {len(stored)} stored-int8 vision layers "
            f"(mm_input_projection stays bf16); one step, loss {qseen[0]:.4f}; Q1a {quant_launches['quantize_rows']} "
            f"and Q1b {quant_launches['int8_gemm']} launches, K6 {quant_launches['flash_attention']}")
        extra["quantize_frozen_base"] = dict(stored_layers=len(stored), loss=qseen[0], launches=quant_launches)
        del model, app, qapp
        torch.cuda.empty_cache()

        # BiGemma3 from train_bigemma3.yaml on the checkpoint's backbone: 2 steps
        bmodel = BiGemma3(cfg, device=device, dtype=torch.bfloat16, remat=True)
        bmodel.load_state_dict({k: x for k, x in load_colgemma3_params(ckpt).items() if k.startswith("model.")})
        bproc = BiGemma3Processor.from_pretrained(ckpt, device=device)
        bapp = ColModelTraining(ColModelTrainingConfig(**recipe("train_bigemma3.yaml", f"{tmp}/bi", bmodel, bproc,
                                                                max_steps=GEMMA_BI_STEPS, save_steps=100)))
        bloss = bapp.config.loss_func
        if not isinstance(bloss, BiEncoderLoss):
            raise AssertionError(f"train_bigemma3.yaml's loss: {bloss}")
        reset_launches()
        bseen = []
        with counted_plain() as plain_calls:
            bapp.train(on_step=lambda step, m: bseen.append((float(m["loss"]), float(m["grad_norm"]))))
        torch.cuda.synchronize()
        bi_launches = launch_counts()
        bapp.close()
        if len(bseen) != GEMMA_BI_STEPS or not np.isfinite(bseen).all() or plain_calls[0] or \
                bi_launches["flash_attention"] != GEMMA_BI_STEPS * per_step or bi_launches["flash_attention_bwd"]:
            raise AssertionError(f"BiGemma3 steps {bseen}, launches {bi_launches}, plain calls {plain_calls[0]}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] BiGemma3 (Gemma3-4B's backbone, mean pooling), ColModelTraining "
            f"from train_bigemma3.yaml: {BiEncoderLoss.__name__}, batch {TRAIN_BATCH}; "
            + ", ".join(f"step {i + 1} loss {l:.4f} grad_norm {g:.4f}" for i, (l, g) in enumerate(bseen))
            + f"; K6 forward {bi_launches['flash_attention']}, backward {bi_launches['flash_attention_bwd']}")
        extra["bigemma3"] = dict(losses=[l for l, _ in bseen], launches=bi_launches)
        del bmodel, bapp
        torch.cuda.empty_cache()
    extra["seconds"] = time.perf_counter() - t_phase
    log(f"phase gemma3 training: {extra['seconds']:.1f} s")
    launches = dict(flash_attention=train_launches["flash_attention"] + eval_launches["flash_attention"],
                    maxsim_bf16=eval_launches["maxsim_bf16"], quantize_rows=quant_launches["quantize_rows"],
                    int8_gemm=quant_launches["int8_gemm"])
    return launches, extra


# -- phase 14: the Qwen3-VL family, ColQwen3 at Qwen3-VL-4B (run after phase 13) ------------------------------------

QWEN3_PAGES = 16  # two batches of 8
QWEN3_PLANTED = (1, 6, 10, 13)  # pages whose docs also hold QUERIES[i]'s tokens, i = 0..3
QWEN3_FILLER_DOCS = 2_048  # seeded filler docs of DOC_TOKENS tokens beside the pages (at least CANDIDATES)
QWEN3_DIM = 320  # ColQwen3's head (reference modeling_colqwen3.py:49)
# merged tokens of a 1,275 x 1,650 page at the 768-token budget and 32 px merged patches: 992 x 768 px, 62 x 48
# patches of 16 px (2,976 a page)
QWEN3_PAGE_TOKENS = 744
# Qwen3-VL-4B's stored-int8 layers (JAX's quantize_params over the same tree, tests/test_torch_qwen3_vl.py): the
# patch embedding (1,536 -> 1,152), 27 x 6 in the vision blocks, the merger's 2 and each of the 3 deepstack
# mergers' 2, 7 in each text layer (k/v 2,560 -> 1,024 included); the 320-d head and embeddings stay bf16
QWEN3_VISION_STORED = 1 + 27 * 6 + 2 * 4
# the text decoder's depth in phases 14-15 since phase 19 came: 9 of Qwen3-VL-4B's 36 layers (every width, and so
# every kernel shape, the published one; the tower at its full 27 blocks)
QWEN3_TEXT_DEPTH = 9
QWEN3_STORED_LAYERS = QWEN3_VISION_STORED + QWEN3_TEXT_DEPTH * 7
QWEN3_SWEEP_DOCS = 262_144  # K3/K10 at D=320 over 2,048 tiles x 64 tokens x 320 (5.4 GB int8)


def qwen3_config():
    """Qwen3-VL-4B (``Qwen/Qwen3-VL-4B-Instruct``'s widths, the JAX package's defaults,
    ``colpali_tpu/models/qwen3_vl.py:49-107``): vision 27 x 1,152 (16 heads of 72, MLP 4,304, 16 px patches, a
    48 x 48 position table, deepstack after blocks 8, 16 and 24, out 2,560), text 2,560 wide (32/8 heads of 128,
    MLP 9,728, vocab 151,936, interleaved M-RoPE (24, 20, 20)), cut to :data:`QWEN3_TEXT_DEPTH` of its 36 layers."""
    from colpali_tpu_torch.models.qwen3_vl import Qwen3TextConfig, Qwen3VLConfig

    return Qwen3VLConfig(text=Qwen3TextConfig(num_hidden_layers=QWEN3_TEXT_DEPTH))


def k3_k10_case(name: str, qi, qs, store, scales, check_tiles=None) -> dict:
    """K3 at one shape against its plain version (over ``check_tiles`` tiles
    at each end, or all), bit-equal on a second call, and K10 over the
    token-major copy bit-equal to it; both timed beside the plain version and
    the bound (the store and its scales read once, int8 operations)."""
    full = maxsim_int8mxu_tiled(qi, qs, store, scales)
    if not torch.equal(full, maxsim_int8mxu_tiled(qi, qs, store, scales)):
        raise AssertionError(f"K3 {name}: two calls differ")
    nt, np_, _, d = store.shape
    ends = [slice(0, nt)] if check_tiles is None else [slice(0, check_tiles), slice(nt - check_tiles, nt)]
    err = 0.0
    for sl in ends:
        want = maxsim_int8mxu_tiled_plain(qi, qs, store[sl], scales[sl])
        got = full[:, sl.start * DOC_TILE: sl.stop * DOC_TILE]
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        err = max(err, (got - want).abs().max().item())
    docs_tm = store.permute(1, 0, 2, 3).reshape(np_, nt * DOC_TILE, d).contiguous()
    scales_tm = scales.permute(1, 0, 2).reshape(np_, nt * DOC_TILE).contiguous()
    if not torch.equal(tm.maxsim_pallas_int8mxu_tm(qi, qs, docs_tm, scales_tm), full):
        raise AssertionError(f"K10 {name}: not bit-equal to K3")
    b, nq, _ = qi.shape
    c = nt * DOC_TILE
    r = dict(ms=time_ms(lambda: maxsim_int8mxu_tiled(qi, qs, store, scales)),
             tm_ms=time_ms(lambda: tm.maxsim_pallas_int8mxu_tm(qi, qs, docs_tm, scales_tm)),
             plain_ms=time_ms(lambda: maxsim_int8mxu_tiled_plain(qi, qs, store, scales), reps=2), max_abs_err=err,
             **bound(c * np_ * (d + 4) + b * nq * (d + 4) + b * c * 4, 2 * b * nq * c * np_ * d, "int8"),
             shape=f"B={b} Nq={nq} Np={np_} D={d} C={c}{name}")
    del docs_tm, scales_tm
    torch.cuda.empty_cache()
    log(f"phase qwen3: K3 [{r['shape']}]: kernel {r['ms']:.3f} ms, K10 (token-major, bit-equal) {r['tm_ms']:.3f} ms, "
        f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} "
        f"of it; max_abs_err {err:.3g} (rtol {RTOL}, atol {ATOL}), bit-equal on a second call")
    return r


def d320_sweep_corpus(device: torch.device):
    """A random int8 tile-major corpus of QWEN3_SWEEP_DOCS docs x DOC_TOKENS x 320 and its scales, on the card."""
    gen = torch.Generator(device=device).manual_seed(SEED + 80)
    n_tiles = QWEN3_SWEEP_DOCS // DOC_TILE
    store = torch.empty((n_tiles, DOC_TOKENS, DOC_TILE, QWEN3_DIM), dtype=torch.int8, device=device)
    for s0 in range(0, n_tiles, 256):
        store[s0: s0 + 256] = torch.randint(-127, 128, (min(256, n_tiles - s0), DOC_TOKENS, DOC_TILE, QWEN3_DIM),
                                            generator=gen, device=device, dtype=torch.int8)
    scales = (0.5 + torch.rand((n_tiles, DOC_TOKENS, DOC_TILE), generator=gen, device=device)) / (
        127.0 * QWEN3_DIM**0.5)
    q = torch.randn((1, QUERY_TOKENS, QWEN3_DIM), generator=gen, device=device)
    q[:, -3:] = 0.0  # padded query tokens
    return store, scales, q / q.norm(dim=-1, keepdim=True).clamp_min(1e-6)


def qwen3_k6_cases(device: torch.device, feed: dict, cfg, encoder_feed: dict) -> dict:
    """K6 against its plain version at Qwen3-VL-4B's shapes: the vision tower
    over 8 pages (D=72, the patch mask as the segments), the decoder over the
    pages' prompts (causal, GQA 32/8, D=128, with left padding cut into the
    rows) and the queries as the query encoder pads them."""
    gen = torch.Generator(device=device).manual_seed(SEED + 81)
    v, t = cfg.vision, cfg.text
    mask = feed["patch_mask"].to(torch.int32).contiguous()
    b, s_text = feed["input_ids"].shape
    left = (torch.arange(s_text, device=device)[None] >= 8 * torch.arange(b, device=device)[:, None]).to(torch.int32)
    q_seg = torch.as_tensor(encoder_feed["attention_mask"], device=device).to(torch.int32).contiguous()
    cases = {
        "vision": (*mask.shape, v.num_heads, v.num_heads, v.head_dim, None, mask, False, " (the patch mask)"),
        "text": (b, s_text, t.num_attention_heads, t.num_key_value_heads, t.head_dim, None, left, True,
                 " causal, rows left-padded by 0-56"),
        "queries": (*q_seg.shape, t.num_attention_heads, t.num_key_value_heads, t.head_dim, None, q_seg, True,
                    " causal, the query encoder's padding"),
    }
    out = {}
    for name, (bb, ss, h, hkv, d, lengths, seg, causal, label) in cases.items():
        r = out[name] = k6_case(gen, device, bb, ss, h, hkv, d, lengths, seg=seg, causal=causal, label=label)
        extra = f", bound over all pairs {r['bound_ms_all_pairs']:.4f} ms" if "bound_ms_all_pairs" in r else ""
        log(f"phase qwen3: K6 {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"{library_note(r)}, bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}, max_abs_err "
            f"{r['max_abs_err']:.3g} (atol {r['atol']:.3g}, {r['limit_share']:.0%} of the tolerance), bit-equal on a "
            "second call")
    torch.cuda.empty_cache()
    return out


def bi_fp32_check(name: str, model, fp32_model, feeds: list, device: torch.device) -> dict:
    """A Bi model's vectors of each feed through the kernels in bf16 against
    the same weights in fp32 on the plain route: cosine per vector >=
    BI_COS_MIN."""
    def run(m):
        with torch.inference_mode():
            return np.concatenate([m(**{k: torch.as_tensor(x).to(device) for k, x in f.items()
                                        if k != "image_grid_thw"}).float().cpu().numpy() for f in feeds])

    a = run(model)
    with plain_route():
        b = run(fp32_model)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    out = dict(vectors=len(a), min_cos=float(cos.min()), mean_cos=float(cos.mean()))
    if not (np.isfinite(a).all() and out["min_cos"] >= BI_COS_MIN):
        raise AssertionError(f"{name} against fp32: {out}, limit min cos >= {BI_COS_MIN}")
    log(f"  {name}, kernels in bf16 against the plain route in fp32: {len(a)} vectors, mean cos "
        f"{out['mean_cos']:.6f}, min cos {out['min_cos']:.6f} (limit {BI_COS_MIN}, "
        f"{share(1 - out['min_cos'], 1 - BI_COS_MIN)})")
    return out


def phase_qwen3(device: torch.device, smi: str, ckpt: str) -> tuple:
    """Drive the Qwen3-VL family's serving path: Qwen3-VL-4B written by
    ``write_qwen3_checkpoint`` into ``ckpt`` (kept for phase 15) and read
    back by ``load_retriever(family="colqwen3")`` in bf16 and stored int8;
    K6 at the vision tower's and the decoder's shapes; Q1a/Q1b at the path's
    (M, K, N); pages through ``embed_dataset``, ``/search_text`` through
    ``make_handler`` over a 320-wide two-tier int8 index and ``serve.py
    --checkpoint --family colqwen3``; K1-K3 held on both indexes; K3 and K10
    at D=320 on a 262,144-doc corpus and at the served shape; the K6 route
    against the plain route, stored int8 against bf16; forward and encode
    timings and profiles; then BiQwen3 at full width. Returns the launches
    over the path, the kernel rows and the rest."""
    import os
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.evaluation.evaluator import embed_dataset
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.models.qwen3_vl import BiQwen3
    from colpali_tpu_torch.processors.bi import BiQwen3Processor
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.retrieval.store import CorpusIndex
    from colpali_tpu_torch.serve import RetrievalServer
    from colpali_tpu_torch.utils.testing import write_qwen3_checkpoint

    held = free_memory("phase qwen3")
    t_phase = time.perf_counter()
    cfg = qwen3_config()
    v, t = cfg.vision, cfg.text
    pages = make_pages(QWEN3_PAGES, SEED + 82)
    extra = dict(held_gib_at_start=held)
    t0 = time.perf_counter()
    write_qwen3_checkpoint(ckpt, cfg, seed=SEED + 83, words=" ".join(QUERIES).split(), device=device)
    torch.cuda.empty_cache()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, processor = load_retriever(ckpt, family="colqwen3", device=device)
    torch.cuda.synchronize()
    t_bf16 = time.perf_counter() - t0
    t0 = time.perf_counter()
    qmodel, qproc = load_retriever(ckpt, family="colqwen3", device=device, quantize=True)
    torch.cuda.synchronize()
    t_int8 = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    stored = sum(isinstance(m, QDense) and m.stored for m in qmodel.modules())
    bytes_int8, bytes_bf16 = (sum(x.numel() * x.element_size() for x in m.state_dict().values())
                              for m in (qmodel, model))
    log(f"phase qwen3: Qwen3-VL-4B, vision {v.depth} x {v.hidden_size} (MLP {v.intermediate_size}, {v.num_heads} heads "
        f"x {v.head_dim}, {v.patch_size} px patches, a {v.num_grid_per_side} x {v.num_grid_per_side} position table, "
        f"deepstack after blocks {v.deepstack_visual_indexes}, out {v.out_hidden_size}), text {t.num_hidden_layers} x "
        f"{t.hidden_size} (MLP {t.intermediate_size}, heads {t.num_attention_heads}/{t.num_key_value_heads} x "
        f"{t.head_dim}, vocab {t.vocab_size}, interleaved M-RoPE {t.mrope_section}), head {QWEN3_DIM}: "
        f"{n_params / 1e9:.3f} B params; HF checkpoint written in {t_write:.1f} s, load_retriever {t_bf16:.1f} s "
        f"(bf16), {t_int8:.1f} s (quantize=True: {stored} stored-int8 layers, {bytes_int8 / 1e9:.3f} GB against "
        f"{bytes_bf16 / 1e9:.3f} GB)")
    if stored != QWEN3_STORED_LAYERS or model.head.custom_text_proj.out_features != QWEN3_DIM:
        raise AssertionError(f"load_retriever(quantize=True): {stored} stored-int8 layers, expected "
                             f"{QWEN3_STORED_LAYERS}; head {model.head.custom_text_proj.out_features} wide")
    batch = pages[:PAGE_BATCH]
    feed = {k: torch.as_tensor(x).to(device) for k, x in processor.process_images(batch, device_pixels=True).items()
            if k != "image_grid_thw"}
    n_image = (feed["input_ids"] == cfg.image_token_id).sum(1)
    if not bool((n_image == QWEN3_PAGE_TOKENS).all()) or feed["patch_mask"].shape[1] != 4 * QWEN3_PAGE_TOKENS:
        raise AssertionError(f"a {PAGE_HW[1]} x {PAGE_HW[0]} page: {n_image.tolist()} merged tokens, "
                             f"{feed['patch_mask'].shape[1]} patches; expected {QWEN3_PAGE_TOKENS}")
    encoders = {"bf16": QueryEncoder(model, processor), "int8": QueryEncoder(qmodel, qproc)}
    for enc in encoders.values():
        enc.warmup()
    k6 = qwen3_k6_cases(device, feed, cfg, encoders["bf16"]._pad_static(processor.process_queries(QUERIES))[0])

    # Q1a/Q1b at the (M, K, N) of one stored-int8 page forward and the query forwards (x8, x1), by hooks
    with torch.inference_mode():
        page_mkn = q1_path_shapes(qmodel, lambda: qmodel(**feed))
        model(**feed)  # the bf16 model's first page forward, so that the path below runs warm
    query_mkn = q1_path_shapes(qmodel, lambda: (encoders["int8"].encode(QUERIES),
                                                encoders["int8"].encode(QUERIES[:1])))
    if any(k % 16 or n % 16 for _, k, n in page_mkn + query_mkn):
        raise AssertionError(f"a Qwen3-VL-4B width that is not a multiple of 16: {page_mkn + query_mkn}")
    checks = q1_checks(device, page_mkn + query_mkn, edge_ks=(1536, 4304))
    log(f"phase qwen3: Q1a and Q1b bit-equal to their plain versions in {checks['q1b_cases']} Q1b cases at the page "
        f"forward's (M, K, N) {page_mkn} and the query forwards' {query_mkn} (every K and N a multiple of 16); Q1a on "
        "edge rows at K 1,536 and 4,304")
    q1_rows, q1_gemms = q1_timing(device, page_mkn + query_mkn)
    extra["q1_checks"] = dict(checks, page_forward_mkn=page_mkn, query_forward_mkn=query_mkn)

    # K6 launches of one page forward and one query forward
    reset_launches()
    with torch.inference_mode():
        model(**feed)
    per_page_forward = {d: n for d, n in fa.FORWARD_LAUNCHES_BY_HEAD_DIM.items() if n}
    reset_launches()
    encoders["bf16"].encode(QUERIES)
    per_query_forward = {d: n for d, n in fa.FORWARD_LAUNCHES_BY_HEAD_DIM.items() if n}
    want_page = {v.head_dim: v.depth, t.head_dim: t.num_hidden_layers}
    if per_page_forward != want_page or per_query_forward != {t.head_dim: t.num_hidden_layers}:
        raise AssertionError(f"K6 launches: a page forward {per_page_forward}, a query forward {per_query_forward}; "
                             f"expected {want_page} and {{{t.head_dim}: {t.num_hidden_layers}}}")

    # the path, counted: pages embedded, /search_text through make_handler on each model, serve.py
    reset_launches()
    with counted_plain() as plain_calls:
        t0 = time.perf_counter()
        embs = {"bf16": embed_dataset(model, processor, pages, batch_size=PAGE_BATCH)}
        t_embed_bf16 = time.perf_counter() - t0
        t0 = time.perf_counter()
        embs["int8"] = embed_dataset(qmodel, qproc, pages, batch_size=PAGE_BATCH)
        t_embed_int8 = time.perf_counter() - t0
        page_tokens = feed["input_ids"].shape[1]
        for label, es in embs.items():
            for e in es:
                if e.shape != (page_tokens, QWEN3_DIM) or not np.isfinite(e).all() or \
                        np.abs(np.linalg.norm(e, axis=-1) - 1).max() > 1e-2:
                    raise AssertionError(f"{label} page embedding {e.shape}: not {page_tokens} finite unit rows of "
                                         f"{QWEN3_DIM}")
        gen = torch.Generator(device=device).manual_seed(SEED + 84)
        filler = torch.randn((QWEN3_FILLER_DOCS, DOC_TOKENS, QWEN3_DIM), generator=gen, device=device)
        filler = (filler / filler.norm(dim=-1, keepdim=True)).cpu().numpy()
        served, corpora = {}, {}
        for label, enc in encoders.items():
            planted_q = enc.encode(QUERIES[: len(QWEN3_PLANTED)])
            docs = [np.concatenate([e, planted_q[QWEN3_PLANTED.index(i)]]) if i in QWEN3_PLANTED else e
                    for i, e in enumerate(embs[label])] + list(filler)
            corpora[label] = docs
            index = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
            httpd = RetrievalServer(("127.0.0.1", 0), serve.make_handler(
                index, [f"doc_{i}" for i in range(index.num_docs)], encoder=enc))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_port}"
            try:
                tiered = [_http(url, "/search_text", {"queries": [q], "k": 10})
                          for q in QUERIES[: len(QWEN3_PLANTED)]]  # one a request: the tiered route
                exact = _http(url, "/search_text", {"queries": QUERIES, "k": 10})  # 8 > 4: the exact route
            finally:
                httpd.shutdown()
                httpd.server_close()
            for out in (*tiered, exact):
                _check_ranked(f"/search_text ({label})", out, len(out["doc_ids"]))
            top = ([out["doc_ids"][0][0] for out in tiered], [row[0] for row in exact["doc_ids"][: len(QWEN3_PLANTED)]])
            if top[0] != list(QWEN3_PLANTED) or top[1] != list(QWEN3_PLANTED):
                raise AssertionError(f"{label} /search_text at rank 1: tiered {top[0]}, exact {top[1]}, planted "
                                     f"{list(QWEN3_PLANTED)}")
            served[label] = (index, planted_q)
        npz = f"{ckpt}/corpus.npz"
        np.savez(npz, **{f"emb_{i}": d for i, d in enumerate(corpora["int8"])})
        t0 = time.perf_counter()
        httpd = serve.make_server([npz, "--port", "0", "--device", str(device), "--prefilter", "--checkpoint", ckpt,
                                   "--family", "colqwen3"])
        t_serve = time.perf_counter() - t0
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            cli = _http(f"http://127.0.0.1:{httpd.server_port}", "/search_text", {"queries": [QUERIES[0]], "k": 10})
        finally:
            httpd.shutdown()
            httpd.server_close()
        os.remove(npz)
        if cli["doc_ids"][0][0] != QWEN3_PLANTED[0]:
            raise AssertionError(f"serve.py --family colqwen3: rank 1 {cli['doc_ids'][0][0]}, planted "
                                 f"{QWEN3_PLANTED[0]}")
    launches = read_launches("Qwen3-VL family", ("flash_attention", "quantize_rows", "int8_gemm", "binary_maxsim",
                                                 "gather_rerank", "maxsim_int8"))
    by_dim = {d: n for d, n in fa.FORWARD_LAUNCHES_BY_HEAD_DIM.items() if n}
    page_forwards = 2 * (QWEN3_PAGES // PAGE_BATCH)  # embed_dataset on each model
    if plain_calls[0] or set(by_dim) != {v.head_dim, t.head_dim} or by_dim[v.head_dim] != page_forwards * v.depth \
            or by_dim[t.head_dim] < page_forwards * t.num_hidden_layers:
        raise AssertionError(f"Qwen3-VL path: K6 launches by head dim {by_dim}, {plain_calls[0]} calls of K6's plain "
                             f"version; expected {v.depth} at D={v.head_dim} and {t.num_hidden_layers} at "
                             f"D={t.head_dim} a page forward, {page_forwards} page forwards, and the queries' at D=128")
    log(f"  [{time.perf_counter() - t_phase:.0f} s] path: {QWEN3_PAGES} pages ({page_tokens} tokens) through "
        f"embed_dataset, each model warm (bf16 {QWEN3_PAGES / t_embed_bf16 * 60:.0f} pages/min, stored int8 "
        f"{QWEN3_PAGES / t_embed_int8 * 60:.0f}); a {served['int8'][0].num_docs}-doc x {served['int8'][0].doc_tokens}"
        f"-token x {QWEN3_DIM} two-tier int8 index behind make_handler for each model: each of {len(QWEN3_PLANTED)} "
        f"planted pages at rank 1 on the tiered and the exact route of /search_text; serve.py --checkpoint --family "
        f"colqwen3 (stored int8) started in {t_serve:.1f} s and found it too; launches {launches}, K6 by head dim "
        f"{by_dim}, K6's plain version called {plain_calls[0]} times")
    del corpora, filler

    # K1, K2 and K3 against their plain versions on each served index, then K3/K10 at D=320 (not counted)
    k123 = {}
    for label, (index, planted_q) in served.items():
        held_k = hold_k123(index, served_queries(planted_q, device))
        k123[label] = {k: held_k[k] for k in ("k1_err", "k2_err", "k3_err")}
        log(f"phase qwen3: K1, K2 and K3 against their plain versions on the {label} index ({index.num_docs} docs x "
            f"Np={index.doc_tokens} x {QWEN3_DIM}): max abs err K1 {held_k['k1_err']:.3g} (bit for bit), K2 "
            f"{held_k['k2_err']:.3g}, K3 {held_k['k3_err']:.3g} (rtol {RTOL}, atol {ATOL})")
    index = served["int8"][0]
    qi, qsc = quantize_per_token(served_queries(encoders["int8"].encode(QUERIES), device))
    sweep = {"served": k3_k10_case(", the served sweep over the page index", qi, qsc, index._store, index._scales)}
    del served, index, held_k, qi, qsc
    torch.cuda.empty_cache()
    store, scales, q = d320_sweep_corpus(device)
    qi, qsc = quantize_per_token(q)
    sweep["corpus"] = k3_k10_case(f", {QWEN3_SWEEP_DOCS}-doc corpus", qi, qsc, store, scales, check_tiles=CHECK_TILES)
    del store, scales, q, qi, qsc
    torch.cuda.empty_cache()

    # checks beside the path (not counted): K6 route vs plain route, stored int8 vs bf16
    route = dict(
        pages=forward_check(f"Qwen3-VL-4B page forward ({PAGE_BATCH} pages)",
                            lambda: embed_dataset(model, processor, batch, batch_size=PAGE_BATCH)),
        queries=forward_check(f"Qwen3-VL-4B query forward ({len(QUERIES)} queries)",
                              lambda: encoders["bf16"].encode(QUERIES)))
    for name, r in route.items():
        log(f"    shares of the limits: mean cos {share(1 - r['mean_cos'], 1 - FORWARD_COS_MEAN)}, min cos "
            f"{share(1 - r['min_cos'], 1 - FORWARD_COS_MIN)}, max abs {share(r['max_abs'], FORWARD_ATOL)}")
    torch.cuda.empty_cache()
    accuracy = {
        "pages": cos_check(f"{PAGE_BATCH} pages, stored int8 vs bf16", embs["int8"][:PAGE_BATCH],
                           embs["bf16"][:PAGE_BATCH], INT8_COS_MEAN, INT8_COS_MIN),
        "queries": cos_check(f"{len(QUERIES)} queries, stored int8 vs bf16", encoders["int8"].encode(QUERIES),
                             encoders["bf16"].encode(QUERIES), INT8_COS_MEAN, INT8_COS_MIN)}

    # end to end, bf16 and stored int8 in turns: one forward of 8 pages (CUDA events), encode x1 / x8
    e2e = {}
    for label in ("bf16", "int8", "int8 again", "bf16 again"):
        m, enc = (model, encoders["bf16"]) if label.startswith("bf16") else (qmodel, encoders["int8"])
        r = dict(page_forward_ms=forward_ms(m, feed))
        for b_, texts in (("x1", QUERIES[:1]), ("x8", QUERIES)):
            enc.encode(texts)
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                enc.encode(texts)
                walls.append((time.perf_counter() - t0) * 1e3)
            r[f"encode_{b_}_ms"] = float(np.median(walls))
        r["pages_per_min_forward"] = PAGE_BATCH / r["page_forward_ms"] * 6e4
        e2e[label] = r
        log(f"  {label} ({smi}): forward of {PAGE_BATCH} pages {r['page_forward_ms']:.1f} ms "
            f"({r['pages_per_min_forward']:.0f} pages/min of forward alone), encode x1 {r['encode_x1_ms']:.2f} ms, "
            f"x8 {r['encode_x8_ms']:.2f} ms")
    with torch.inference_mode():
        profiles = {label: kernel_breakdown(f"one {label} Qwen3-VL-4B forward of {PAGE_BATCH} pages",
                                            lambda m=m: m(**feed)) for label, m in (("bf16", model),
                                                                                   ("stored-int8", qmodel))}
    query_feed = processor.process_queries(QUERIES)
    del encoders, qmodel, embs
    torch.cuda.empty_cache()

    # BiQwen3 at full width on the checkpoint's backbone: the K6 route against the plain route and against fp32
    bmodel = BiQwen3(cfg, device=device, dtype=torch.bfloat16).eval()
    bmodel.load_state_dict({k: x for k, x in model.state_dict().items() if k.startswith("model.")})
    del model
    torch.cuda.empty_cache()
    bproc = BiQwen3Processor.from_pretrained(ckpt, device=device, max_num_visual_tokens=768)
    bi_feeds = [feed, query_feed]
    bi = bi_check("BiQwen3 (Qwen3-VL-4B, last pooling)", bmodel, bi_feeds, device, bproc.score, BI_PLANTED)
    fp32 = BiQwen3(cfg, device=device, dtype=torch.float32).eval()
    fp32.load_state_dict(bmodel.state_dict())
    bi["fp32"] = bi_fp32_check("BiQwen3 (Qwen3-VL-4B)", bmodel, fp32, bi_feeds, device)
    del bmodel, fp32, feed, query_feed, bi_feeds
    torch.cuda.empty_cache()
    extra.update(k6=k6, k123=k123, k3_k10_d320=sweep, params=n_params, stored_int8_layers=stored,
                 weight_bytes_int8=bytes_int8, weight_bytes_bf16=bytes_bf16, page_tokens=page_tokens,
                 route_check=route, int8_vs_bf16=accuracy, end_to_end=e2e, page_profile=profiles, biqwen3=bi,
                 k6_per_page_forward={str(d): n for d, n in per_page_forward.items()},
                 k6_per_query_forward={str(d): n for d, n in per_query_forward.items()},
                 launches_by_head_dim={str(d): n for d, n in by_dim.items()},
                 pages_per_min=dict(bf16=QWEN3_PAGES / t_embed_bf16 * 60, int8=QWEN3_PAGES / t_embed_int8 * 60),
                 write_load_seconds=dict(write=t_write, bf16=t_bf16, int8=t_int8))
    extra["seconds"] = time.perf_counter() - t_phase
    log(f"phase qwen3: {extra['seconds']:.1f} s")
    timings = {"flash_attention": k6, "quantize_rows": dict(shapes=q1_rows), "int8_gemm": dict(shapes=q1_gemms),
               "maxsim_int8": sweep, "maxsim_pallas_int8mxu_tm": {k: dict(ms=r["tm_ms"], k3_ms=r["ms"],
                                                                            plain_ms=r["plain_ms"],
                                                                            bound_ms=r["bound_ms"], shape=r["shape"])
                                                               for k, r in sweep.items()}}
    return launches, timings, extra


# -- phase 15: Qwen3-VL training (run after phase 14, on its checkpoint) ----------------------------------------------

QWEN3_TRAIN_PAGES = 32  # four batches of 8
QWEN3_EVAL_PAGES = 16
QWEN3_TRAIN_STEPS, QWEN3_RESUME_AT = 4, 2
# TIED_MARGIN holds the first step's loss and the int8 step's. The first H100 run, page tokens kept, read 2.1266 at
# step 1 (0.047 from ln 8; 7.0% of the query tokens' maxima on the template that opens every page, a query's least
# score spread 0.0114): phase 15 trains with mask_non_image_embeddings, as phase 13 does


def qwen3_bwd_cases(device: torch.device, batch: dict, cfg) -> dict:
    """K6's backward where LoRA over Qwen3-VL-4B puts it: the decoder over
    the pages' prompts (causal, GQA 32/8, D=128, rows left-padded by 0-56)
    and over the collated queries (their own padding)."""
    gen = torch.Generator(device=device).manual_seed(SEED + 87)
    t = cfg.text
    b, s_text = batch["doc_input_ids"].shape
    left = (torch.arange(s_text, device=device)[None] >= 8 * torch.arange(b, device=device)[:, None]).to(torch.int32)
    q_seg = batch["query_attention_mask"].to(torch.int32).contiguous()
    heads = (t.num_attention_heads, t.num_key_value_heads, t.head_dim)
    cases = {"text": (b, s_text, *heads, left, left.bool(), " causal, rows left-padded by 0-56 (Qwen3-VL-4B)"),
             "queries": (*q_seg.shape, *heads, q_seg, q_seg.bool(), " causal, the collated queries")}
    out = {}
    for name, (bb, ss, h, hkv, d, seg, rows, label) in cases.items():
        r = out[name] = k6_bwd_row_case(gen, device, bb, ss, h, hkv, d, seg, rows, True, label)
        log(f"phase qwen3 training: K6 backward {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain "
            f"{r['plain_ms']:.3f} ms, backward: {library_note(r)} (7 products), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}, share of the per-row tolerance dq "
            f"{r['shares']['dq']:.0%} dk {r['shares']['dk']:.0%} dv {r['shares']['dv']:.0%}; bit-equal on a second call")
        torch.cuda.empty_cache()
    return out


def phase_qwen3_training(device: torch.device, smi: str, ckpt: str) -> tuple:
    """Drive the Qwen3-VL family's training path on phase 14's checkpoint:
    K6's backward at the decoder's shapes; Qwen3-VL-4B read by
    ``load_retriever(family="colqwen3", remat=True)`` and trained through
    ``ColModelTraining`` from ``configs/train_colqwen3.yaml``'s loss and LoRA
    (4 steps at batch 8 over 32 pages: 72 K6 backward launches a step, all
    at D=128), the plain route, ``evaluate()`` (a 320-wide bf16 index, K5),
    the merged export read back and served, a run resumed from step 2, a
    step timed with and without remat and profiled, one step over a
    stored-int8 frozen vision tower (its deepstack mergers included); then
    one BiQwen3 step at full width cut to 2 + 2 layers. ColQwen3 trains with
    ``mask_non_image_embeddings`` (:data:`TIED_MARGIN`): the
    ColbertLoss of the first step and of the int8 step, each with fresh
    adapters, must lie that far from ln 8. Returns the launches over the path, K6's
    backward rows and the rest."""
    import dataclasses
    import math
    import os
    import shutil

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.data.collator import VisualRetrieverCollator
    from colpali_tpu_torch.losses import BiEncoderLoss, ColbertLoss
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.models.qwen3_vl import BiQwen3, ColQwen3
    from colpali_tpu_torch.processors.bi import BiQwen3Processor
    from colpali_tpu_torch.training import trainer
    from colpali_tpu_torch.training.lora import LoraAdapters
    from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig

    held = free_memory("phase qwen3 training")
    t_phase = time.perf_counter()
    cfg = qwen3_config()
    v, t = cfg.vision, cfg.text
    train_config = trainer.TrainConfig(learning_rate=QWEN_LR, warmup_steps=0, total_steps=2500)
    train_set = smol_dataset(QWEN3_TRAIN_PAGES, SEED + 85)
    eval_set = smol_dataset(QWEN3_EVAL_PAGES, SEED + 86, first=QWEN3_TRAIN_PAGES)
    extra = dict(held_gib_at_start=held)
    model, processor = load_retriever(ckpt, family="colqwen3", device=device, remat=True,
                                      mask_non_image_embeddings=True)
    batch = trainer.to_device(VisualRetrieverCollator(processor)([train_set[i] for i in range(TRAIN_BATCH)]), device)
    k6_bwd = qwen3_bwd_cases(device, batch, cfg)
    tied = math.log(TRAIN_BATCH)
    spread = page_score_spread(model, batch, cfg.image_token_id, ColbertLoss(temperature=0.02))
    log(f"  Qwen3-VL-4B, the first batch's in-batch scores: page tokens kept, {spread['unmasked']['on_template']:.1%} "
        f"of the query tokens' maxima on the template that opens every page, least spread of a query's scores across "
        f"the pages {spread['unmasked']['min_spread']:.5f}, the recipe's ColbertLoss {spread['unmasked']['loss']:.4f}; "
        f"non-image tokens masked (as trained here), {spread['masked']['on_template']:.1%}, "
        f"{spread['masked']['min_spread']:.5f} and {spread['masked']['loss']:.4f} (ln {TRAIN_BATCH} = {tied:.4f})")
    extra["score_spread"] = spread
    sampled = ["model.language_model.layers.0.self_attn.q_proj.weight",
               f"model.language_model.layers.{t.num_hidden_layers - 1}.mlp.down_proj.weight",
               "model.visual.deepstack_merger_2.linear_fc1.weight", "head.custom_text_proj.weight"]
    base_before = {k: model.state_dict()[k].clone() for k in sampled}

    recipe = functools.partial(recipe_config, train_set=train_set, train_config=train_config, device=device)

    with tempfile.TemporaryDirectory() as tmp:
        app = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colqwen3.yaml", f"{tmp}/run", model, processor, eval_dataset=eval_set,
            eval_batch_size=TRAIN_BATCH, max_steps=QWEN3_TRAIN_STEPS, save_steps=QWEN3_RESUME_AT,
            save_total_limit=QWEN3_TRAIN_STEPS)))
        peft, loss_fn = app.config.peft, app.config.loss_func
        if not isinstance(loss_fn, ColbertLoss) or loss_fn.temperature != 0.02 or peft.rank != 32:
            raise AssertionError(f"train_colqwen3.yaml's loss and LoRA: {loss_fn}, {peft}")
        n_adapters, n_trainable = len(app.state.adapters.paths), sum(p.numel() for p in app.state.params)
        seen, moved = [], []

        def on_step(step, metrics):
            seen.append((step, float(metrics["loss"]), float(metrics["grad_norm"])))
            if step == 1:
                moved.extend(bool(b.detach().abs().max() > 0) for b in app.state.adapters.b)

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with counted_plain() as plain_calls:
            summary = app.train(on_step=on_step)
        torch.cuda.synchronize()
        train_launches = launch_counts()
        peak_train = torch.cuda.max_memory_allocated() / 2**30
        by_dim = {d: n for d, n in train_launches["bwd_by_head_dim"].items() if n}
        per_step = 2 * t.num_hidden_layers  # a query and a page forward a step need a gradient, through the text
        if [s for s, _, _ in seen] != list(range(1, QWEN3_TRAIN_STEPS + 1)) or \
                not all(np.isfinite(l) and l > 0 and np.isfinite(g) and g > 0 for _, l, g in seen):
            raise AssertionError(f"Qwen3-VL-4B steps: {seen}")
        if len(moved) != n_adapters or not all(moved):
            raise AssertionError(f"{moved.count(False)} of {n_adapters} adapters did not move in step 1")
        if not all(torch.equal(model.state_dict()[k], w) for k, w in base_before.items()):
            raise AssertionError("a frozen base weight changed")
        if abs(seen[0][1] - tied) < TIED_MARGIN:
            raise AssertionError(f"Qwen3-VL-4B step 1: ColbertLoss {seen[0][1]:.6f}, within {TIED_MARGIN} of "
                                 f"ln {TRAIN_BATCH} = {tied:.6f}: the pages score alike")
        if by_dim != {t.head_dim: QWEN3_TRAIN_STEPS * per_step} or plain_calls[0]:
            raise AssertionError(f"K6 backward over {QWEN3_TRAIN_STEPS} LoRA steps: {by_dim}, {plain_calls[0]} calls of "
                                 f"the plain version; expected {per_step} a step at D={t.head_dim}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] Qwen3-VL-4B, ColModelTraining from train_colqwen3.yaml "
            f"({smi}): {n_adapters} adapted layers, {n_trainable / 1e6:.2f} M trainable parameters, "
            f"{type(loss_fn).__name__}(temperature {loss_fn.temperature}), LoRA r{peft.rank} a{peft.alpha:g} dropout "
            f"{peft.dropout}, remat, batch {TRAIN_BATCH}; "
            + ", ".join(f"step {s} loss {l:.4f} grad_norm {g:.4f}" for s, l, g in seen)
            + f" (step 1 {abs(seen[0][1] - tied):.4f} from ln {TRAIN_BATCH}, limit {TIED_MARGIN})"
            + f"; {summary['train_samples_per_second']:.2f} examples/s with collation and checkpoints; K6 forward "
            f"{train_launches['flash_attention']}, backward {train_launches['flash_attention_bwd']} ({per_step} a "
            f"step, by head dim {by_dim}), K6's plain version called {plain_calls[0]} times; peak memory "
            f"{peak_train:.2f} GiB")
        extra["route"] = hold_routes("Qwen3-VL-4B LoRA", app.state, batch, loss_fn, peft)

        reset_launches()  # the comparison launched K6 too: it does not count
        t0 = time.perf_counter()
        metrics = app.evaluate()
        t_eval = time.perf_counter() - t0
        eval_launches = launch_counts()
        index = app.eval_index
        if not {"eval_loss", "eval_ndcg@1", "eval_ndcg@5"} <= set(metrics) or \
                not all(np.isfinite(x) for x in metrics.values()) or not eval_launches["maxsim_bf16"] or \
                (index.dtype, index.num_docs, index.dim, index._store.device.type) != \
                ("bf16", QWEN3_EVAL_PAGES, QWEN3_DIM, device.type):
            raise AssertionError(f"evaluate(): {metrics}, index {index.dtype} {index.num_docs} x {index.dim}, "
                                 f"{eval_launches}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] evaluate(): {QWEN3_EVAL_PAGES} held-out pages in {t_eval:.1f} "
            f"s, bf16 index {index.num_docs} x {index.doc_tokens} x {index.dim} built on the card and searched by K5 "
            f"({eval_launches['maxsim_bf16']} launch(es)); " + ", ".join(f"{k} {x:.4f}" for k, x in sorted(metrics.items())))
        app.save()
        merged = app.state.adapters.merged_state_dict(model)
        app.close()
        readback = export_readback(device, f"{tmp}/run", merged, cfg, ColQwen3, "colqwen3", "Qwen3-VL-4B",
                                   dim=QWEN3_DIM)
        del merged
        os.remove(f"{tmp}/run/model.safetensors")

        os.makedirs(f"{tmp}/resumed/checkpoints")
        shutil.copy(f"{tmp}/run/checkpoints/step_{QWEN3_RESUME_AT}.pt", f"{tmp}/resumed/checkpoints/")
        resumed = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colqwen3.yaml", f"{tmp}/resumed", model, processor, max_steps=QWEN3_RESUME_AT + 1,
            save_steps=100, resume_from_checkpoint=True)))
        tail = []
        resumed.train(on_step=lambda step, m: tail.append((step, float(m["loss"]))))
        resumed.close()
        first = seen[QWEN3_RESUME_AT][1]
        if resumed.state.step != QWEN3_RESUME_AT + 1 or [s for s, _ in tail] != [QWEN3_RESUME_AT + 1] or \
                abs(tail[0][1] - first) > RESUME_LOSS_RTOL * abs(first):
            raise AssertionError(f"resumed run: {tail}, the first run's step {QWEN3_RESUME_AT + 1} loss {first}")
        log(f"  resumed from step {QWEN3_RESUME_AT}: step {QWEN3_RESUME_AT + 1} loss {tail[0][1]:.8f} vs {first:.8f} in "
            f"the first run (limit {RESUME_LOSS_RTOL} relative)")

        # a step at batch 8 with and without remat, and a profile of one
        adapters = LoraAdapters(model, peft, seed=SEED + 1)
        state = trainer.create_train_state(model, train_config, adapters)
        steps = {}
        for remat in (True, False):
            model.set_remat(remat)
            steps["remat" if remat else "no_remat"] = r = timed_steps(state, batch, loss_fn, peft, SEED, steps=2)
            log(f"  Qwen3-VL-4B LoRA step, batch {TRAIN_BATCH}, remat {'on' if remat else 'off'} ({smi}): "
                f"{r['wall']:.1f} ms/step ({TRAIN_BATCH / r['wall'] * 1e3:.2f} examples/s without collation), forward "
                f"{r['forward']:.1f} ms, backward {r['backward']:.1f} ms, optimizer {r['optimizer']:.1f} ms, host and "
                f"idle {r['wall'] - r['forward'] - r['backward'] - r['optimizer']:.1f} ms, peak memory "
                f"{r['peak_gib']:.2f} GiB ({r['allocated_before_gib']:.2f} GiB held before the step)")
        model.set_remat(True)
        step_fn = trainer.make_train_step(loss_fn, peft=peft, seed=SEED)
        steps["profile"] = kernel_breakdown(f"one Qwen3-VL-4B LoRA step, batch {TRAIN_BATCH}, remat on",
                                            lambda: step_fn(state, batch)["loss"].item())
        adapters.detach()
        del state, adapters
        extra.update(losses=[l for _, l, _ in seen], grad_norms=[g for _, _, g in seen], eval=metrics,
                     examples_per_s_end_to_end=summary["train_samples_per_second"], peak_train_gib=peak_train,
                     step_ms=steps, checkpoint_readback=readback, resumed_loss=tail[0][1], trainable=n_trainable,
                     launches_per_step={"flash_attention_bwd": per_step})

        # one step over a stored-int8 frozen vision tower, deepstack mergers included (it stays int8 from here on)
        qapp = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colqwen3.yaml", f"{tmp}/quant", model, processor, max_steps=1, save_steps=100,
            quantize_frozen_base=True)))
        stored = [name for name, m in model.named_modules() if isinstance(m, QDense) and m.stored]
        if len(stored) != QWEN3_VISION_STORED or not all(n.startswith("model.visual.") for n in stored) or \
                not any(".deepstack_merger_2." in n for n in stored):
            raise AssertionError(f"quantize_frozen_base stored {len(stored)} layers, expected the vision tower's "
                                 f"{QWEN3_VISION_STORED} with its deepstack mergers")
        reset_launches()
        qseen = []
        qapp.train(on_step=lambda step, m: qseen.append(float(m["loss"])))
        torch.cuda.synchronize()
        quant_launches = launch_counts()
        qapp.close()
        if quant_launches["int8_gemm"] != QWEN3_VISION_STORED or not quant_launches["quantize_rows"] or \
                len(qseen) != 1 or not np.isfinite(qseen[0]) or abs(qseen[0] - tied) < TIED_MARGIN or \
                quant_launches["bwd_by_head_dim"][t.head_dim] != per_step:
            raise AssertionError(f"quantize_frozen_base step {qseen}, launches {quant_launches}; expected "
                                 f"{QWEN3_VISION_STORED} Q1b launches, {per_step} K6 backward launches and a loss "
                                 f"{TIED_MARGIN} from ln {TRAIN_BATCH}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] quantize_frozen_base: {len(stored)} stored-int8 vision layers "
            f"(3 deepstack mergers among them); one step, loss {qseen[0]:.4f}; Q1a {quant_launches['quantize_rows']} "
            f"and Q1b {quant_launches['int8_gemm']} launches, K6 backward {quant_launches['flash_attention_bwd']}")
        extra["quantize_frozen_base"] = dict(stored_layers=len(stored), loss=qseen[0], launches=quant_launches)
        del model, app, qapp, resumed
        torch.cuda.empty_cache()

    # one BiQwen3 LoRA step at full width cut to 2 vision blocks (both tapped) + 2 text layers, its recipe's loss
    cut = dataclasses.replace(cfg, vision=dataclasses.replace(v, depth=2, deepstack_visual_indexes=(0, 1)),
                              text=dataclasses.replace(t, num_hidden_layers=2))
    bmodel = BiQwen3(cut, device=device, dtype=torch.bfloat16, remat=True)
    hf_init_(bmodel, torch.Generator(device=device).manual_seed(SEED + 88))
    bproc = BiQwen3Processor(processor.tokenizer, num_grid_per_side=v.num_grid_per_side, max_num_visual_tokens=768,
                             device=device)
    with tempfile.TemporaryDirectory() as out:
        bapp = ColModelTraining(ColModelTrainingConfig(
            model=bmodel, processor=bproc, loss_func=BiEncoderLoss(), train_datasets=[train_set], output_dir=out,
            global_batch_size=TRAIN_BATCH, log_steps=1, save_steps=100, peft=peft, train=train_config, seed=SEED,
            device=device, max_steps=1))
        reset_launches()
        bseen = []
        with counted_plain() as plain_calls:
            bapp.train(on_step=lambda step, m: bseen.append(float(m["loss"])))
        torch.cuda.synchronize()
        bi_launches = launch_counts()
        bapp.close()
    expect = {t.head_dim: 2 * 2}  # a query and a page forward, 2 text layers; the frozen tower takes none
    if len(bseen) != 1 or not np.isfinite(bseen[0]) or plain_calls[0] or \
            {d: n for d, n in bi_launches["bwd_by_head_dim"].items() if n} != expect:
        raise AssertionError(f"BiQwen3 LoRA step: loss {bseen}, launches {bi_launches}, plain calls {plain_calls[0]}; "
                             f"expected K6 backward {expect}")
    log(f"  [{time.perf_counter() - t_phase:.0f} s] BiQwen3 at full width, 2 + 2 layers (deepstack after both vision "
        f"blocks), one LoRA step through ColModelTraining (BiEncoderLoss): loss {bseen[0]:.4f}; K6 backward {expect}")
    extra["biqwen3"] = dict(loss=bseen[0], launches=bi_launches)
    del bmodel, bapp
    torch.cuda.empty_cache()
    extra["seconds"] = time.perf_counter() - t_phase
    log(f"phase qwen3 training: {extra['seconds']:.1f} s")
    launches = dict(flash_attention_bwd=train_launches["flash_attention_bwd"],
                    flash_attention=train_launches["flash_attention"] + eval_launches["flash_attention"],
                    maxsim_bf16=eval_launches["maxsim_bf16"], quantize_rows=quant_launches["quantize_rows"],
                    int8_gemm=quant_launches["int8_gemm"])
    extra["launches_by_head_dim"] = {str(d): n for d, n in by_dim.items()}
    return launches, k6_bwd, extra


# -- phase 16: the ModernVBert family, ColModernVBert at ModernVBERT-base (run after phase 15) ----------------------

MVB_PAGES = 16  # two batches of 8
MVB_PLANTED = (1, 6, 10, 13)  # pages whose docs also hold QUERIES[i]'s tokens, i = 0..3
MVB_FILLER_DOCS = 2_048  # seeded filler docs of DOC_TOKENS tokens beside the pages (at least CANDIDATES)
MVB_TILES = 13  # a 1,275 x 1,650 page within the longest edge of 2,048: 4 x 3 tiles of 512 px and the global view


def modernvbert_config():
    """ModernVBERT-base (``ModernVBERT/colmodernvbert``: SigLIP2-base-patch16-512 and ettin-encoder-150m, the
    JAX package's defaults, ``colpali_tpu/models/modernvbert.py:50-151``): vision 12 x 768 (12 heads of 64, MLP
    3,072, 512 px tiles of 16 px patches), pixel shuffle by 4 (64 tokens a tile, a 12,288 -> 768 connector), a
    ModernBERT encoder 22 x 768 (12 heads of 64, GeGLU 2 x 1,152, global attention on every third layer at rope
    theta 160,000, the others within 64 tokens at 10,000), vocab 50,368 and 128 additional ids."""
    from colpali_tpu_torch.models.modernvbert import ModernVBertConfig

    return ModernVBertConfig()


def modernvbert_stored_layers(cfg, vision_only: bool = False) -> int:
    """ModernVBert's stored-int8 layers (JAX's quantize_params over the same tree, tests/test_torch_modernvbert.py:
    205 at ModernVBERT-base): 6 a SigLIP layer (q/k/v/o, fc1, fc2), the connector, 6 an encoder layer (q/k/v/o, Wi,
    Wo); the patch embedding, the two embedding tables and the 128-d head stay bf16. ``quantize_frozen_base``
    stores the tower's alone."""
    return cfg.vision.num_hidden_layers * 6 + (0 if vision_only else 1 + cfg.text.num_hidden_layers * 6)


@contextlib.contextmanager
def counted_biased_attention():
    """The encoder's biased attention calls while the block runs, global
    (a ``(B, 1, 1, S)`` key bias) and local (``(B, 1, S, S)``) apart."""
    from colpali_tpu_torch.models import layers

    calls, biased = {"global": 0, "local": 0}, layers.biased_attention

    def counted(q, k, v, attn_bias, *args, **kwargs):
        calls["global" if attn_bias.shape[-2] == 1 else "local"] += 1
        return biased(q, k, v, attn_bias, *args, **kwargs)

    with mock.patch.object(layers, "biased_attention", counted):
        yield calls


def modernbert_attention_cases(gen: torch.Generator, device: torch.device, feed: dict, cfg) -> dict:
    """The encoder's biased attention (no kernel: XLA's einsum route in JAX)
    at a page batch's shape, under its global and its local bias, each
    beside SDPA with the same mask as booleans: CUDA events, the bound over
    the attended pairs, the gap to SDPA."""
    from colpali_tpu_torch.models.layers import biased_attention
    from colpali_tpu_torch.models.modernvbert import modernbert_attention_biases

    t = cfg.text
    mask = feed["attention_mask"]
    b, s = mask.shape
    h, d = t.num_attention_heads, t.head_dim
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device).to(torch.bfloat16) for _ in range(3))
    scale = d**-0.5
    out = {}
    for name, bias in zip(("global", "local"), modernbert_attention_biases(mask, t.local_attention)):
        allowed = bias == 0
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        def sdpa(allowed=allowed):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed, scale=scale)

        gap = (biased_attention(q, k, v, bias, scale).float() - sdpa().transpose(1, 2).float()).abs().max().item()
        pairs = allowed.expand(b, 1, s, s).sum().item()
        nbytes = 2 * 4 * q.numel() + 4 * bias.numel()
        r = dict(ms=time_ms(lambda bias=bias: biased_attention(q, k, v, bias, scale)), library_ms=time_ms(sdpa),
                 max_abs_vs_sdpa=gap, **bound(nbytes, 4 * pairs * h * d, "bf16"),
                 shape=f"B={b} S={s} H={h} D={d}, {name}" + (f" (|q - k| <= {t.local_attention // 2})"
                                                            if name == "local" else ""))
        out[name] = r = dict(r, **rates(4 * pairs * h * d, r))
        log(f"phase modernvbert: biased attention, {r['shape']}: {r['ms']:.3f} ms (no kernel, as in JAX), SDPA on "
            f"the same boolean mask {r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max abs "
            f"vs SDPA {gap:.3g}")
    return out


def phase_modernvbert(device: torch.device, smi: str, ckpt: str) -> tuple:
    """Drive the ModernVBert family's serving path: ModernVBERT-base written
    by ``write_modernvbert_checkpoint`` into ``ckpt`` (kept for phase 17) and
    read back by ``load_retriever(family="colmodernvbert")`` in bf16 and
    stored int8; Q1a/Q1b at the path's (M, K, N); the encoder's biased
    attention timed; pages through ``embed_dataset``, ``/search_text``
    through ``make_handler`` over a two-tier int8 index and ``serve.py
    --checkpoint --family colmodernvbert``; K1-K3 held on both indexes; the
    K6 route against the plain route, stored int8 against bf16, a query
    alone against the same query in a bucketed batch; forward and encode
    timings and profiles; then BiModernVBert at full width. K6 at this
    tower's shape (B=104 S=1,024 H=12 D=64) is held and timed in phase 10:
    counted here. Returns the launches over the path, the kernel rows and
    the rest."""
    import os
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.evaluation.evaluator import embed_dataset
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.models.modernvbert import BiModernVBert
    from colpali_tpu_torch.processors.modernvbert import BiModernVBertProcessor
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.retrieval.store import CorpusIndex
    from colpali_tpu_torch.serve import RetrievalServer
    from colpali_tpu_torch.utils.testing import write_modernvbert_checkpoint

    held = free_memory("phase modernvbert")
    t_phase = time.perf_counter()
    cfg = modernvbert_config()
    v, t = cfg.vision, cfg.text
    pages = make_pages(MVB_PAGES, SEED + 90)
    extra = dict(held_gib_at_start=held)
    t0 = time.perf_counter()
    write_modernvbert_checkpoint(ckpt, cfg, seed=SEED + 91, words=" ".join(QUERIES).split(), device=device)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, processor = load_retriever(ckpt, family="colmodernvbert", device=device)
    torch.cuda.synchronize()
    t_bf16 = time.perf_counter() - t0
    t0 = time.perf_counter()
    qmodel, qproc = load_retriever(ckpt, family="colmodernvbert", device=device, quantize=True)
    torch.cuda.synchronize()
    t_int8 = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    stored = sum(isinstance(m, QDense) and m.stored for m in qmodel.modules())
    bytes_int8, bytes_bf16 = (sum(x.numel() * x.element_size() for x in m.state_dict().values())
                              for m in (qmodel, model))
    log(f"phase modernvbert: ModernVBERT-base, vision {v.num_hidden_layers} x {v.hidden_size} (MLP "
        f"{v.intermediate_size}, {v.num_attention_heads} heads x {v.head_dim}, {v.image_size} px tiles of "
        f"{v.num_patches} patches), pixel shuffle {cfg.pixel_shuffle_factor} ({cfg.image_seq_len} tokens a tile, "
        f"connector {v.hidden_size * cfg.pixel_shuffle_factor**2} -> {t.hidden_size}), ModernBERT {t.num_hidden_layers} "
        f"x {t.hidden_size} ({t.num_attention_heads} heads x {t.head_dim}, GeGLU 2 x {t.intermediate_size}, global "
        f"every {t.global_attn_every_n_layers} layers, window {t.local_attention}), vocab {t.vocab_size} + "
        f"{cfg.additional_vocab_size}: {n_params / 1e9:.3f} B params; HF checkpoint written in {t_write:.1f} s, "
        f"load_retriever {t_bf16:.1f} s (bf16), {t_int8:.1f} s (quantize=True: {stored} stored-int8 layers, "
        f"{bytes_int8 / 1e9:.3f} GB against {bytes_bf16 / 1e9:.3f} GB)")
    if stored != modernvbert_stored_layers(cfg):
        raise AssertionError(f"load_retriever(quantize=True): {stored} stored-int8 layers, expected "
                             f"{modernvbert_stored_layers(cfg)}")
    batch = pages[:PAGE_BATCH]
    feed = {k: torch.as_tensor(x).to(device) for k, x in processor.process_images(batch, device_pixels=True).items()}
    n_tiles = int(feed["tile_mask"].sum(1).max())
    n_image = (feed["input_ids"] == cfg.image_token_id).sum(1)
    page_tokens = feed["input_ids"].shape[1]
    if n_tiles != MVB_TILES or not bool((n_image == MVB_TILES * cfg.image_seq_len).all()) or \
            not bool((feed["input_ids"] >= t.vocab_size).any()):
        raise AssertionError(f"a {PAGE_HW[1]} x {PAGE_HW[0]} page: {n_tiles} tiles, {n_image.tolist()} image tokens; "
                             f"expected {MVB_TILES} tiles and ids past the base vocabulary")
    encoders = {"bf16": QueryEncoder(model, processor), "int8": QueryEncoder(qmodel, qproc)}
    for enc in encoders.values():
        enc.warmup()
    attention = modernbert_attention_cases(torch.Generator(device=device).manual_seed(SEED + 92), device, feed, cfg)

    # Q1a/Q1b at the (M, K, N) of one stored-int8 page forward and the query forwards (x8, x1), by hooks
    with torch.inference_mode():
        page_mkn = q1_path_shapes(qmodel, lambda: qmodel(**feed))
        model(**feed)  # the bf16 model's first page forward, so that the path below runs warm
    query_mkn = q1_path_shapes(qmodel, lambda: (encoders["int8"].encode(QUERIES),
                                                encoders["int8"].encode(QUERIES[:1])))
    if any(k % 16 or n % 16 for _, k, n in page_mkn + query_mkn):
        raise AssertionError(f"a ModernVBERT-base width that is not a multiple of 16: {page_mkn + query_mkn}")
    checks = q1_checks(device, page_mkn + query_mkn, edge_ks=(1152, 12288))
    log(f"phase modernvbert: Q1a and Q1b bit-equal to their plain versions in {checks['q1b_cases']} Q1b cases at the "
        f"page forward's (M, K, N) {page_mkn} and the query forwards' {query_mkn} (every K and N a multiple of 16); "
        "Q1a on edge rows at K 1,152 and 12,288")
    q1_rows, q1_gemms = q1_timing(device, page_mkn + query_mkn)
    extra["q1_checks"] = dict(checks, page_forward_mkn=page_mkn, query_forward_mkn=query_mkn)

    # K6 and the biased route, one page forward and one query forward
    per_forward = {}
    for name, run in (("page", lambda: model(**feed)), ("query", lambda: encoders["bf16"].encode(QUERIES))):
        reset_launches()
        with torch.inference_mode(), counted_biased_attention() as biased:
            run()
        per_forward[name] = dict(k6={d: n for d, n in fa.FORWARD_LAUNCHES_BY_HEAD_DIM.items() if n}, biased=biased)
    n_global = sum(t.is_global(i) for i in range(t.num_hidden_layers))
    want_biased = {"global": n_global, "local": t.num_hidden_layers - n_global}
    if per_forward["page"]["k6"] != {v.head_dim: v.num_hidden_layers} or per_forward["query"]["k6"] or \
            any(f["biased"] != want_biased for f in per_forward.values()):
        raise AssertionError(f"a page and a query forward: {per_forward}; expected K6 {v.num_hidden_layers} at "
                             f"D={v.head_dim} a page forward and none a query forward, the biased route {want_biased}")
    log(f"phase modernvbert: a page forward launches K6 {per_forward['page']['k6']} (every tile of the batch, "
        f"{int(feed['tile_mask'].numel())}, through the tower), a query forward {per_forward['query']['k6']}; the "
        f"biased route {want_biased} a forward")

    # the path, counted: pages embedded, /search_text through make_handler on each model, serve.py
    reset_launches()
    with counted_plain() as plain_calls:
        t0 = time.perf_counter()
        embs = {"bf16": embed_dataset(model, processor, pages, batch_size=PAGE_BATCH)}
        t_embed_bf16 = time.perf_counter() - t0
        t0 = time.perf_counter()
        embs["int8"] = embed_dataset(qmodel, qproc, pages, batch_size=PAGE_BATCH)
        t_embed_int8 = time.perf_counter() - t0
        for label, es in embs.items():
            for e in es:
                if e.shape != (page_tokens, DIM) or not np.isfinite(e).all() or \
                        np.abs(np.linalg.norm(e, axis=-1) - 1).max() > 1e-2:
                    raise AssertionError(f"{label} page embedding {e.shape}: not {page_tokens} finite unit rows")
        gen = torch.Generator(device=device).manual_seed(SEED + 93)
        filler = torch.randn((MVB_FILLER_DOCS, DOC_TOKENS, DIM), generator=gen, device=device)
        filler = (filler / filler.norm(dim=-1, keepdim=True)).cpu().numpy()
        served, corpora = {}, {}
        for label, enc in encoders.items():
            planted_q = enc.encode(QUERIES[: len(MVB_PLANTED)])
            docs = [np.concatenate([e, planted_q[MVB_PLANTED.index(i)]]) if i in MVB_PLANTED else e
                    for i, e in enumerate(embs[label])] + list(filler)
            corpora[label] = docs
            index = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
            httpd = RetrievalServer(("127.0.0.1", 0), serve.make_handler(
                index, [f"doc_{i}" for i in range(index.num_docs)], encoder=enc))
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{httpd.server_port}"
            try:
                tiered = [_http(url, "/search_text", {"queries": [q], "k": 10})
                          for q in QUERIES[: len(MVB_PLANTED)]]  # one a request: the tiered route
                exact = _http(url, "/search_text", {"queries": QUERIES, "k": 10})  # 8 > 4: the exact route
            finally:
                httpd.shutdown()
                httpd.server_close()
            for out in (*tiered, exact):
                _check_ranked(f"/search_text ({label})", out, len(out["doc_ids"]))
            top = ([out["doc_ids"][0][0] for out in tiered], [row[0] for row in exact["doc_ids"][: len(MVB_PLANTED)]])
            if top[0] != list(MVB_PLANTED) or top[1] != list(MVB_PLANTED):
                raise AssertionError(f"{label} /search_text at rank 1: tiered {top[0]}, exact {top[1]}, planted "
                                     f"{list(MVB_PLANTED)}")
            served[label] = (index, planted_q)
        npz = f"{ckpt}/corpus.npz"
        np.savez(npz, **{f"emb_{i}": d for i, d in enumerate(corpora["int8"])})
        t0 = time.perf_counter()
        httpd = serve.make_server([npz, "--port", "0", "--device", str(device), "--prefilter", "--checkpoint", ckpt,
                                   "--family", "colmodernvbert"])
        t_serve = time.perf_counter() - t0
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            cli = _http(f"http://127.0.0.1:{httpd.server_port}", "/search_text", {"queries": [QUERIES[0]], "k": 10})
        finally:
            httpd.shutdown()
            httpd.server_close()
        os.remove(npz)
        if cli["doc_ids"][0][0] != MVB_PLANTED[0]:
            raise AssertionError(f"serve.py --family colmodernvbert: rank 1 {cli['doc_ids'][0][0]}, planted "
                                 f"{MVB_PLANTED[0]}")
    launches = read_launches("ModernVBert family", ("flash_attention", "quantize_rows", "int8_gemm", "binary_maxsim",
                                                    "gather_rerank", "maxsim_int8"))
    by_dim = {d: n for d, n in fa.FORWARD_LAUNCHES_BY_HEAD_DIM.items() if n}
    page_forwards = 2 * (MVB_PAGES // PAGE_BATCH)  # embed_dataset on each model
    if plain_calls[0] or by_dim != {v.head_dim: page_forwards * v.num_hidden_layers}:
        raise AssertionError(f"ModernVBert path: K6 launches by head dim {by_dim}, {plain_calls[0]} calls of K6's "
                             f"plain version; expected {v.num_hidden_layers} at D={v.head_dim} a page forward, "
                             f"{page_forwards} page forwards, none a query forward")
    log(f"  [{time.perf_counter() - t_phase:.0f} s] path: {MVB_PAGES} pages ({page_tokens} tokens, {MVB_TILES} tiles "
        f"each) through embed_dataset, each model warm (bf16 {MVB_PAGES / t_embed_bf16 * 60:.0f} pages/min, stored "
        f"int8 {MVB_PAGES / t_embed_int8 * 60:.0f}); a {served['int8'][0].num_docs}-doc x "
        f"{served['int8'][0].doc_tokens}-token two-tier int8 index behind make_handler for each model: each of "
        f"{len(MVB_PLANTED)} planted pages at rank 1 on the tiered and the exact route of /search_text; serve.py "
        f"--checkpoint --family colmodernvbert (stored int8) started in {t_serve:.1f} s and found it too; launches "
        f"{launches}, K6 by head dim {by_dim}, K6's plain version called {plain_calls[0]} times")
    del corpora, filler

    # K1, K2 and K3 against their plain versions on each served index (not counted)
    k123 = {}
    for label, (index, planted_q) in served.items():
        held_k = hold_k123(index, served_queries(planted_q, device))
        k123[label] = {k: held_k[k] for k in ("k1_err", "k2_err", "k3_err")}
        log(f"phase modernvbert: K1, K2 and K3 against their plain versions on the {label} index ({index.num_docs} "
            f"docs x Np={index.doc_tokens}, the {len(planted_q)} planted queries at Nq={SERVED_TOKENS}): max abs err "
            f"K1 {held_k['k1_err']:.3g} (bit for bit), K2 {held_k['k2_err']:.3g}, K3 {held_k['k3_err']:.3g} (rtol "
            f"{RTOL}, atol {ATOL})")
    del served, index, held_k
    torch.cuda.empty_cache()

    # checks beside the path (not counted): K6 route vs plain route, stored int8 vs bf16, a query alone vs batched
    route = dict(
        pages=forward_check(f"ModernVBERT-base page forward ({PAGE_BATCH} pages)",
                            lambda: embed_dataset(model, processor, batch, batch_size=PAGE_BATCH)),
        queries=forward_check(f"ModernVBERT-base query forward ({len(QUERIES)} queries)",
                              lambda: encoders["bf16"].encode(QUERIES)))
    for name, r in route.items():
        log(f"    shares of the limits: mean cos {share(1 - r['mean_cos'], 1 - FORWARD_COS_MEAN)}, min cos "
            f"{share(1 - r['min_cos'], 1 - FORWARD_COS_MIN)}, max abs {share(r['max_abs'], FORWARD_ATOL)}")
    accuracy = {
        "pages": cos_check(f"{PAGE_BATCH} pages, stored int8 vs bf16", embs["int8"][:PAGE_BATCH],
                           embs["bf16"][:PAGE_BATCH], INT8_COS_MEAN, INT8_COS_MIN),
        "queries": cos_check(f"{len(QUERIES)} queries, stored int8 vs bf16", encoders["int8"].encode(QUERIES),
                             encoders["bf16"].encode(QUERIES), INT8_COS_MEAN, INT8_COS_MIN),
        "alone": cos_check(f"{len(QUERIES)} queries each encoded alone vs in one bucketed batch (left pads, then "
                           "right pads)", [encoders["bf16"].encode([q])[0] for q in QUERIES],
                           encoders["bf16"].encode(QUERIES), FORWARD_COS_MEAN, FORWARD_COS_MIN)}

    # end to end, bf16 and stored int8 in turns: one forward of 8 pages (CUDA events), encode x1 / x8
    e2e = {}
    for label in ("bf16", "int8", "int8 again", "bf16 again"):
        m, enc = (model, encoders["bf16"]) if label.startswith("bf16") else (qmodel, encoders["int8"])
        r = dict(page_forward_ms=forward_ms(m, feed))
        for b_, texts in (("x1", QUERIES[:1]), ("x8", QUERIES)):
            enc.encode(texts)
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                enc.encode(texts)
                walls.append((time.perf_counter() - t0) * 1e3)
            r[f"encode_{b_}_ms"] = float(np.median(walls))
        r["pages_per_min_forward"] = PAGE_BATCH / r["page_forward_ms"] * 6e4
        e2e[label] = r
        log(f"  {label} ({smi}): forward of {PAGE_BATCH} pages {r['page_forward_ms']:.1f} ms "
            f"({r['pages_per_min_forward']:.0f} pages/min of forward alone), encode x1 {r['encode_x1_ms']:.2f} ms, "
            f"x8 {r['encode_x8_ms']:.2f} ms")
    with torch.inference_mode():
        profiles = {label: kernel_breakdown(f"one {label} ModernVBERT-base forward of {PAGE_BATCH} pages",
                                            lambda m=m: m(**feed)) for label, m in (("bf16", model),
                                                                                   ("stored-int8", qmodel))}
    query_feed = {k: torch.as_tensor(x).to(device) for k, x in processor.process_queries(QUERIES).items()}
    del encoders, qmodel, embs
    torch.cuda.empty_cache()

    # BiModernVBert at full width on the checkpoint's backbone: the K6 route against the plain route and against fp32
    bmodel = BiModernVBert(cfg, device=device, dtype=torch.bfloat16).eval()
    bmodel.load_state_dict({k: x for k, x in model.state_dict().items() if k.startswith("model.")})
    del model
    torch.cuda.empty_cache()
    bproc = BiModernVBertProcessor.from_pretrained(ckpt, device=device)
    bi_feeds = [feed, query_feed]
    bi = bi_check("BiModernVBert (ModernVBERT-base, mean pooling)", bmodel, bi_feeds, device, bproc.score,
                  BI_PLANTED)
    fp32 = BiModernVBert(cfg, device=device, dtype=torch.float32).eval()
    fp32.load_state_dict(bmodel.state_dict())
    bi["fp32"] = bi_fp32_check("BiModernVBert (ModernVBERT-base)", bmodel, fp32, bi_feeds, device)
    del bmodel, fp32, feed, query_feed, bi_feeds
    torch.cuda.empty_cache()
    extra.update(biased_attention=attention, k123=k123, params=n_params, stored_int8_layers=stored,
                 weight_bytes_int8=bytes_int8, weight_bytes_bf16=bytes_bf16, page_tokens=page_tokens, tiles=MVB_TILES,
                 route_check=route, int8_vs_bf16=accuracy, end_to_end=e2e, page_profile=profiles, bimodernvbert=bi,
                 per_forward={name: dict(k6={str(d): n for d, n in f["k6"].items()}, biased=f["biased"])
                              for name, f in per_forward.items()},
                 launches_by_head_dim={str(d): n for d, n in by_dim.items()},
                 pages_per_min=dict(bf16=MVB_PAGES / t_embed_bf16 * 60, int8=MVB_PAGES / t_embed_int8 * 60),
                 write_load_seconds=dict(write=t_write, bf16=t_bf16, int8=t_int8))
    extra["seconds"] = time.perf_counter() - t_phase
    log(f"phase modernvbert: {extra['seconds']:.1f} s")
    timings = {"quantize_rows": dict(shapes=q1_rows), "int8_gemm": dict(shapes=q1_gemms)}
    return launches, timings, extra


# -- phase 17: ModernVBert training (run after phase 16, on its checkpoint) ------------------------------------------

MVB_TRAIN_PAGES = 32  # four batches of 8
MVB_EVAL_PAGES = 16
MVB_TRAIN_STEPS, MVB_RESUME_AT = 4, 2
# train with the pages' non-image tokens kept: the encoder is bidirectional, so the template that opens every page
# sees that page's image tokens (phases 13 and 15 mask them: their causal templates score alike)
MVB_MASK_NON_IMAGE = False


def phase_modernvbert_training(device: torch.device, smi: str, ckpt: str) -> tuple:
    """Drive the ModernVBert family's training path on phase 16's checkpoint:
    ModernVBERT-base read by ``load_retriever(family="colmodernvbert",
    remat=True)`` and trained through ``ColModelTraining`` from
    ``configs/train_colmodernvbert.yaml``'s loss and LoRA (4 steps at batch 8
    over 32 pages: the frozen tower's K6 forward, 12 launches a step, and no
    K6 backward, the encoder's attention being biased), the plain route,
    ``evaluate()`` (K5), the merged export read back and served, a run
    resumed from step 2, a step timed with and without remat and profiled,
    one step over a stored-int8 frozen vision tower, one BiModernVBert step.
    The ColbertLoss of the first step and of the int8 step, each with fresh
    adapters, must lie :data:`TIED_MARGIN` from ln 8. Returns the launches
    over the path and the rest."""
    import math
    import os
    import shutil

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.data.collator import VisualRetrieverCollator
    from colpali_tpu_torch.losses import BiEncoderLoss, ColbertLoss
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.models.modernvbert import BiModernVBert, ColModernVBert
    from colpali_tpu_torch.processors.modernvbert import BiModernVBertProcessor
    from colpali_tpu_torch.training import trainer
    from colpali_tpu_torch.training.lora import LoraAdapters
    from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig

    held = free_memory("phase modernvbert training")
    t_phase = time.perf_counter()
    cfg = modernvbert_config()
    v = cfg.vision
    train_config = trainer.TrainConfig(learning_rate=QWEN_LR, warmup_steps=0, total_steps=2500)
    train_set = smol_dataset(MVB_TRAIN_PAGES, SEED + 94)
    eval_set = smol_dataset(MVB_EVAL_PAGES, SEED + 95, first=MVB_TRAIN_PAGES)
    extra = dict(held_gib_at_start=held)
    model, processor = load_retriever(ckpt, family="colmodernvbert", device=device, remat=True,
                                      mask_non_image_embeddings=MVB_MASK_NON_IMAGE)
    batch = trainer.to_device(VisualRetrieverCollator(processor)([train_set[i] for i in range(TRAIN_BATCH)]), device)
    tied = math.log(TRAIN_BATCH)
    spread = page_score_spread(model, batch, cfg.image_token_id, ColbertLoss(temperature=0.02))
    log(f"  ModernVBERT-base, the first batch's in-batch scores: page tokens kept, "
        f"{spread['unmasked']['on_template']:.1%} of the query tokens' maxima outside the image tokens, least spread "
        f"of a query's scores across the pages {spread['unmasked']['min_spread']:.5f}, the recipe's ColbertLoss "
        f"{spread['unmasked']['loss']:.4f}; non-image tokens masked, {spread['masked']['on_template']:.1%}, "
        f"{spread['masked']['min_spread']:.5f} and {spread['masked']['loss']:.4f} (ln {TRAIN_BATCH} = {tied:.4f}); "
        f"trained with them {'masked' if MVB_MASK_NON_IMAGE else 'kept'}")
    extra["score_spread"] = spread
    sampled = ["model.text_model.layers.0.attn.q_proj.weight", f"model.text_model.layers.{cfg.text.num_hidden_layers - 1}.Wo.weight",
               "model.embeddings.additional_embedding.weight", "head.custom_text_proj.weight"]
    base_before = {k: model.state_dict()[k].clone() for k in sampled}
    recipe = functools.partial(recipe_config, train_set=train_set, train_config=train_config, device=device)

    with tempfile.TemporaryDirectory() as tmp:
        app = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colmodernvbert.yaml", f"{tmp}/run", model, processor, eval_dataset=eval_set,
            eval_batch_size=TRAIN_BATCH, max_steps=MVB_TRAIN_STEPS, save_steps=MVB_RESUME_AT,
            save_total_limit=MVB_TRAIN_STEPS)))
        peft, loss_fn = app.config.peft, app.config.loss_func
        if not isinstance(loss_fn, ColbertLoss) or loss_fn.temperature != 0.02 or peft.rank != 32:
            raise AssertionError(f"train_colmodernvbert.yaml's loss and LoRA: {loss_fn}, {peft}")
        n_adapters, n_trainable = len(app.state.adapters.paths), sum(p.numel() for p in app.state.params)
        lora_layers = 6 * cfg.text.num_hidden_layers + 1  # q/k/v/o, Wi, Wo a layer and the head: JAX's 133 kernels
        if n_adapters != lora_layers or any("vision" in p for p in app.state.adapters.paths):
            raise AssertionError(f"{n_adapters} adapted kernels, expected JAX's {lora_layers} and none in the tower")
        seen, moved = [], []

        def on_step(step, metrics):
            seen.append((step, float(metrics["loss"]), float(metrics["grad_norm"])))
            if step == 1:
                moved.extend(bool(b.detach().abs().max() > 0) for b in app.state.adapters.b)

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with counted_plain() as plain_calls, counted_biased_attention() as biased:
            summary = app.train(on_step=on_step)
        torch.cuda.synchronize()
        train_launches = launch_counts()
        peak_train = torch.cuda.max_memory_allocated() / 2**30
        per_step = v.num_hidden_layers  # one page forward a step through the frozen tower; the queries take none
        if [s for s, _, _ in seen] != list(range(1, MVB_TRAIN_STEPS + 1)) or \
                not all(np.isfinite(l) and l > 0 and np.isfinite(g) and g > 0 for _, l, g in seen):
            raise AssertionError(f"ModernVBERT-base steps: {seen}")
        if len(moved) != n_adapters or not all(moved):
            raise AssertionError(f"{moved.count(False)} of {n_adapters} adapters did not move in step 1")
        if not all(torch.equal(model.state_dict()[k], w) for k, w in base_before.items()):
            raise AssertionError("a frozen base weight changed")
        if abs(seen[0][1] - tied) < TIED_MARGIN:
            raise AssertionError(f"ModernVBERT-base step 1: ColbertLoss {seen[0][1]:.6f}, within {TIED_MARGIN} of "
                                 f"ln {TRAIN_BATCH} = {tied:.6f}: the pages score alike")
        if train_launches["flash_attention"] != MVB_TRAIN_STEPS * per_step or train_launches["flash_attention_bwd"] \
                or plain_calls[0]:
            raise AssertionError(f"K6 over {MVB_TRAIN_STEPS} ModernVBERT-base LoRA steps: {train_launches}, "
                                 f"{plain_calls[0]} calls of the plain version; expected {per_step} forward launches "
                                 "a step and no backward (the tower is frozen, the encoder's attention biased)")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] ModernVBERT-base, ColModelTraining from "
            f"train_colmodernvbert.yaml ({smi}): {n_adapters} adapted layers, {n_trainable / 1e6:.2f} M trainable "
            f"parameters, {type(loss_fn).__name__}(temperature {loss_fn.temperature}), LoRA r{peft.rank} "
            f"a{peft.alpha:g} dropout {peft.dropout}, remat, batch {TRAIN_BATCH}; "
            + ", ".join(f"step {s} loss {l:.4f} grad_norm {g:.4f}" for s, l, g in seen)
            + f" (step 1 {abs(seen[0][1] - tied):.4f} from ln {TRAIN_BATCH}, limit {TIED_MARGIN}); "
            f"{summary['train_samples_per_second']:.2f} examples/s with collation and checkpoints; K6 forward "
            f"{train_launches['flash_attention']} ({per_step} a step, D={v.head_dim}), backward "
            f"{train_launches['flash_attention_bwd']}, K6's plain version called {plain_calls[0]} times; the biased "
            f"route {biased} (the recompute under remat included); peak memory {peak_train:.2f} GiB")
        extra["route"] = hold_routes("ModernVBERT-base LoRA", app.state, batch, loss_fn, peft)

        reset_launches()
        t0 = time.perf_counter()
        metrics = app.evaluate()
        t_eval = time.perf_counter() - t0
        eval_launches = launch_counts()
        index = app.eval_index
        if not {"eval_loss", "eval_ndcg@1", "eval_ndcg@5"} <= set(metrics) or \
                not all(np.isfinite(x) for x in metrics.values()) or not eval_launches["maxsim_bf16"] or \
                (index.dtype, index.num_docs, index._store.device.type) != ("bf16", MVB_EVAL_PAGES, device.type):
            raise AssertionError(f"evaluate(): {metrics}, index {index.dtype} {index.num_docs}, {eval_launches}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] evaluate(): {MVB_EVAL_PAGES} held-out pages in {t_eval:.1f} s, "
            f"bf16 index {index.num_docs} x {index.doc_tokens} built on the card and searched by K5 "
            f"({eval_launches['maxsim_bf16']} launch(es)); " + ", ".join(f"{k} {x:.4f}" for k, x in sorted(metrics.items())))
        app.save()
        merged = app.state.adapters.merged_state_dict(model)
        app.close()
        readback = export_readback(device, f"{tmp}/run", merged, cfg, ColModernVBert, "colmodernvbert",
                                   "ModernVBERT-base")
        del merged

        os.makedirs(f"{tmp}/resumed/checkpoints")
        shutil.copy(f"{tmp}/run/checkpoints/step_{MVB_RESUME_AT}.pt", f"{tmp}/resumed/checkpoints/")
        resumed = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colmodernvbert.yaml", f"{tmp}/resumed", model, processor, max_steps=MVB_RESUME_AT + 1,
            save_steps=100, resume_from_checkpoint=True)))
        tail = []
        resumed.train(on_step=lambda step, m: tail.append((step, float(m["loss"]))))
        resumed.close()
        first = seen[MVB_RESUME_AT][1]
        if resumed.state.step != MVB_RESUME_AT + 1 or [s for s, _ in tail] != [MVB_RESUME_AT + 1] or \
                abs(tail[0][1] - first) > RESUME_LOSS_RTOL * abs(first):
            raise AssertionError(f"resumed run: {tail}, the first run's step {MVB_RESUME_AT + 1} loss {first}")
        log(f"  resumed from step {MVB_RESUME_AT}: step {MVB_RESUME_AT + 1} loss {tail[0][1]:.8f} vs {first:.8f} in "
            f"the first run (limit {RESUME_LOSS_RTOL} relative)")

        # a step at batch 8 with and without remat, and a profile of one
        adapters = LoraAdapters(model, peft, seed=SEED + 1)
        state = trainer.create_train_state(model, train_config, adapters)
        steps = {}
        for remat in (True, False):
            model.set_remat(remat)
            steps["remat" if remat else "no_remat"] = r = timed_steps(state, batch, loss_fn, peft, SEED, steps=2)
            log(f"  ModernVBERT-base LoRA step, batch {TRAIN_BATCH}, remat {'on' if remat else 'off'} ({smi}): "
                f"{r['wall']:.1f} ms/step ({TRAIN_BATCH / r['wall'] * 1e3:.2f} examples/s without collation), forward "
                f"{r['forward']:.1f} ms, backward {r['backward']:.1f} ms, optimizer {r['optimizer']:.1f} ms, host and "
                f"idle {r['wall'] - r['forward'] - r['backward'] - r['optimizer']:.1f} ms, peak memory "
                f"{r['peak_gib']:.2f} GiB ({r['allocated_before_gib']:.2f} GiB held before the step)")
        model.set_remat(True)
        step_fn = trainer.make_train_step(loss_fn, peft=peft, seed=SEED)
        steps["profile"] = kernel_breakdown(f"one ModernVBERT-base LoRA step, batch {TRAIN_BATCH}, remat on",
                                            lambda: step_fn(state, batch)["loss"].item())
        adapters.detach()
        del state, adapters
        extra.update(losses=[l for _, l, _ in seen], grad_norms=[g for _, _, g in seen], eval=metrics,
                     examples_per_s_end_to_end=summary["train_samples_per_second"], peak_train_gib=peak_train,
                     step_ms=steps, checkpoint_readback=readback, resumed_loss=tail[0][1], trainable=n_trainable,
                     biased_calls=biased, launches_per_step={"flash_attention": per_step, "flash_attention_bwd": 0})

        # one step over a stored-int8 frozen vision tower (the model's tower stays int8 from here on)
        qapp = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colmodernvbert.yaml", f"{tmp}/quant", model, processor, max_steps=1, save_steps=100,
            quantize_frozen_base=True)))
        stored = [name for name, m in model.named_modules() if isinstance(m, QDense) and m.stored]
        vision_stored = modernvbert_stored_layers(cfg, vision_only=True)
        if len(stored) != vision_stored or not all(n.startswith("model.vision_model.") for n in stored) or \
                model.model.modality_projection.stored:
            raise AssertionError(f"quantize_frozen_base stored {len(stored)} layers, expected the vision tower's "
                                 f"{vision_stored} (the connector stays bf16)")
        reset_launches()
        qseen = []
        qapp.train(on_step=lambda step, m: qseen.append(float(m["loss"])))
        torch.cuda.synchronize()
        quant_launches = launch_counts()
        qapp.close()
        if quant_launches["int8_gemm"] != vision_stored or not quant_launches["quantize_rows"] or \
                len(qseen) != 1 or not np.isfinite(qseen[0]) or abs(qseen[0] - tied) < TIED_MARGIN or \
                quant_launches["flash_attention"] != per_step:
            raise AssertionError(f"quantize_frozen_base step {qseen}, launches {quant_launches}; expected "
                                 f"{vision_stored} Q1b launches, {per_step} K6 launches and a loss {TIED_MARGIN} "
                                 f"from ln {TRAIN_BATCH}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] quantize_frozen_base: {len(stored)} stored-int8 vision layers "
            f"(modality_projection stays bf16); one step, loss {qseen[0]:.4f}; Q1a {quant_launches['quantize_rows']} "
            f"and Q1b {quant_launches['int8_gemm']} launches, K6 {quant_launches['flash_attention']}")
        extra["quantize_frozen_base"] = dict(stored_layers=len(stored), loss=qseen[0], launches=quant_launches)
        del model, app, qapp, resumed
        torch.cuda.empty_cache()

        # one BiModernVBert LoRA step at full width and depth, on the checkpoint's backbone
        bmodel, _ = load_retriever(ckpt, family="colmodernvbert", device=device)
        backbone = {k: x for k, x in bmodel.state_dict().items() if k.startswith("model.")}
        bmodel = BiModernVBert(cfg, device=device, dtype=torch.bfloat16, remat=True)
        bmodel.load_state_dict(backbone)
        del backbone
        bproc = BiModernVBertProcessor.from_pretrained(ckpt, device=device)
        bapp = ColModelTraining(ColModelTrainingConfig(
            model=bmodel, processor=bproc, loss_func=BiEncoderLoss(), train_datasets=[train_set],
            output_dir=f"{tmp}/bi", global_batch_size=TRAIN_BATCH, log_steps=1, save_steps=100, peft=peft,
            train=train_config, seed=SEED, device=device, max_steps=1))
        reset_launches()
        bseen = []
        with counted_plain() as plain_calls:
            bapp.train(on_step=lambda step, m: bseen.append(float(m["loss"])))
        torch.cuda.synchronize()
        bi_launches = launch_counts()
        bapp.close()
    if len(bseen) != 1 or not np.isfinite(bseen[0]) or plain_calls[0] or bi_launches["flash_attention"] != per_step \
            or bi_launches["flash_attention_bwd"]:
        raise AssertionError(f"BiModernVBert LoRA step: loss {bseen}, launches {bi_launches}, plain calls "
                             f"{plain_calls[0]}")
    log(f"  [{time.perf_counter() - t_phase:.0f} s] BiModernVBert (ModernVBERT-base, mean pooling), one LoRA step "
        f"through ColModelTraining (BiEncoderLoss): loss {bseen[0]:.4f}; K6 forward {bi_launches['flash_attention']}, "
        f"backward {bi_launches['flash_attention_bwd']}")
    extra["bimodernvbert"] = dict(loss=bseen[0], launches=bi_launches)
    del bmodel, bapp
    torch.cuda.empty_cache()
    extra["seconds"] = time.perf_counter() - t_phase
    log(f"phase modernvbert training: {extra['seconds']:.1f} s")
    launches = dict(flash_attention=train_launches["flash_attention"] + eval_launches["flash_attention"],
                    maxsim_bf16=eval_launches["maxsim_bf16"], quantize_rows=quant_launches["quantize_rows"],
                    int8_gemm=quant_launches["int8_gemm"])
    return launches, extra


# -- phase 19: the Qwen3.5 family, ColQwen3_5 at the JAX package's default config (run last) ------------------------

QWEN35_PAGES = 32  # four batches of 8
QWEN35_PLANTED = (1, 9, 18, 27)  # pages whose docs also hold QUERIES[i]'s tokens, i = 0..3
QWEN35_FILLER_DOCS = 2_048  # seeded filler docs of DOC_TOKENS tokens beside the pages (at least CANDIDATES)
# the default config's stored-int8 layers (JAX's quantize_params over the same tree, tests/test_torch_qwen3_5.py):
# Qwen3-VL-4B's tower (1 + 27 x 6 + 2 x 4), in_proj_qkvz and out_proj of each of the 36 GatedDeltaNet layers
# (in_proj_ba, 2,048 -> 64, stays bf16), q/k/v/o of each of the 12 attention layers, gate/up/down everywhere
QWEN35_STORED_LAYERS = QWEN3_VISION_STORED + 36 * (2 + 3) + 12 * (4 + 3)
Q2_FP32_ATOL_RMS = 1e-4  # Q2 on fp32 inputs against its plain version: fp32 sums in another order
Q2_LARGE_DECAY = 2.0  # log-decay per token of the draw that must stay finite (a chunk sums ~128, past exp's 88)
# fp32_witness_check passes a kernel route whose 1 - cos against fp32 is within this, whatever the plain route reads
WITNESS_FLOOR = 1e-4


def qwen35_config():
    """The JAX package's default ``Qwen35VLConfig`` (``colpali_tpu/models/qwen3_5.py:52-154``, what
    ``configs/train_colqwen3_5.yaml`` builds): Qwen3-VL-4B's tower (27 x 1,152, 16 heads of 72, 16 px patches) and
    the hybrid decoder 48 x 2,048 (36 GatedDeltaNet layers, 16/32 heads of 128, a conv of 4; 12 gated attention
    layers, 16/2 heads of 256, rotary over 64; MLP 5,120, no experts; vocab 151,936), a 128-wide head. The default
    tower's merger writes Qwen3-VL-4B's 2,560 wide where the decoder takes 2,048, so no page forward runs as it
    stands: its output is set to the decoder's width, as in Qwen3.5's checkpoints."""
    import dataclasses

    from colpali_tpu_torch.models.qwen3_5 import Qwen35VLConfig

    cfg = Qwen35VLConfig()
    return dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, out_hidden_size=cfg.text.hidden_size))


def qwen35_cut_config():
    """:func:`qwen35_config` with the decoder cut to QWEN35_TRAIN_DEPTH layers (phase 20)."""
    import dataclasses

    cfg = qwen35_config()
    return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=QWEN35_TRAIN_DEPTH))


def q2_flops(b: int, s: int, hv: int, dk: int, dv: int) -> float:
    """Q2's operations at one shape, over whole chunks of 64: the strict lower triangle of k k^T and the lower of
    q k^T (C^2 Dk each), k S and q S (2 C Dk Dv each), the substitution and P Vnew (C^2 Dv each, triangular), the
    state update (2 C Dk Dv), a multiply-add counted as 2."""
    c, n = gdr.CHUNK, -(-s // gdr.CHUNK)
    return b * hv * n * (2 * c * c * dk + 2 * c * c * dv + 6 * c * dk * dv)


def q2_case(gen: torch.Generator, device: torch.device, b: int, s: int, cfg, dtype, log_decay: float,
            timed: bool) -> dict:
    """Q2 against its plain version on seeded inputs at one shape, q/k/v laid out as GatedDeltaNet's conv output
    (strided views of one row a token): fp32 within Q2_FP32_ATOL_RMS of the plain output's RMS, bf16 by K6's
    forward rule; bit-equal on a second call; finite. ``timed``: the kernel and the plain version by CUDA events
    beside the bound."""
    hk, hv, dk, dv = cfg.linear_num_key_heads, cfg.linear_num_value_heads, cfg.linear_key_head_dim, \
        cfg.linear_value_head_dim
    mixed = torch.randn((b, s, 2 * hk * dk + hv * dv), generator=gen, device=device).to(dtype)
    q = mixed[..., :hk * dk].view(b, s, hk, dk)
    k = mixed[..., hk * dk:2 * hk * dk].view(b, s, hk, dk)
    v = mixed[..., 2 * hk * dk:].view(b, s, hv, dv)
    g = -log_decay * (0.5 + torch.rand((b, s, hv), generator=gen, device=device))
    beta = torch.rand((b, s, hv), generator=gen, device=device).to(dtype)
    got = gdr.chunk_gated_delta_rule(q, k, v, g, beta)
    want = gdr.chunk_gated_delta_rule_plain(q, k, v, g, beta)
    torch.cuda.synchronize()
    if not torch.equal(got, gdr.chunk_gated_delta_rule(q, k, v, g, beta)):
        raise AssertionError(f"Q2 B={b} S={s} {dtype}: two calls differ")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise AssertionError(f"Q2 B={b} S={s} {dtype} log-decay {log_decay}: not finite")
    rms = want.float().square().mean().sqrt().item()
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        limit = Q2_FP32_ATOL_RMS * rms
        ok = err.max().item() <= limit
    else:
        limit = K6_ATOL_RMS * rms
        ok = bool((err <= limit + K6_RTOL * want.float().abs()).all())
    r = dict(shape=f"B={b} S={s} Hk={hk} Hv={hv} Dk={dk} Dv={dv} {str(dtype)[6:]} log-decay {log_decay}",
             max_abs_err=err.max().item(), atol=limit, out_rms=rms)
    if not ok:
        raise AssertionError(f"Q2 [{r['shape']}] against its plain version: {r}")
    if timed:
        nbytes = (2 * b * s * hk * dk + 2 * b * s * hv * dv + b * s * hv) * got.element_size() + b * s * hv * 4
        r.update(ms=time_ms(lambda: gdr.chunk_gated_delta_rule(q, k, v, g, beta)),
                 graph_ms=graph_ms(lambda: gdr.chunk_gated_delta_rule(q, k, v, g, beta)),
                 plain_ms=time_ms(lambda: gdr.chunk_gated_delta_rule_plain(q, k, v, g, beta), reps=2),
                 library_ms=None, **bound(nbytes, q2_flops(b, s, hv, dk, dv), "fp32"))
    del mixed, q, k, v, g, beta, got, want, err
    return r


def q2_cases(device: torch.device, page_s: int, query_s: int, cfg) -> dict:
    """Q2 at the page shape (8 pages' prompts) and the query shape (8 queries as QueryEncoder pads them), each in
    fp32 and bf16, and a bf16 draw at Q2_LARGE_DECAY at the page shape; the bf16 cases timed."""
    gen = torch.Generator(device=device).manual_seed(SEED + 90)
    out = {}
    for name, s in (("page", page_s), ("query", query_s)):
        for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            r = out[f"{name}_{label}"] = q2_case(gen, device, PAGE_BATCH, s, cfg, dtype, 0.3, timed=label == "bf16")
            timing = (f": kernel {r['ms']:.3f} ms (graph {r['graph_ms']:.3f}), plain {r['plain_ms']:.3f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of it") if "ms" in r \
                else ""
            log(f"phase qwen3.5: Q2 [{r['shape']}] max_abs_err {r['max_abs_err']:.3g} (limit {r['atol']:.3g}, "
                f"{r['max_abs_err'] / r['atol']:.0%}), bit-equal on a second call{timing}")
    r = out["page_large_decay"] = q2_case(gen, device, PAGE_BATCH, page_s, cfg, torch.bfloat16, Q2_LARGE_DECAY,
                                          timed=False)
    log(f"phase qwen3.5: Q2 [{r['shape']}] finite, max_abs_err {r['max_abs_err']:.3g} (limit {r['atol']:.3g})")
    torch.cuda.empty_cache()
    return out


def _cos(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def fp32_witness_check(name: str, embed, embed_fp32) -> dict:
    """``embed()`` (a bf16 model, a list of (tokens, dim) arrays or of
    vectors) through the kernel route and through the plain route, each
    against ``embed_fp32()`` (the same weights in fp32 on the plain route),
    token by token. At Qwen3.5's depth on random weights bf16 rounding alone
    moves the tokens (every GatedDeltaNet head is divided by its own RMS), so
    the two bf16 routes are held to the fp32 witness and not to each other:
    the kernel route must stand no farther from it than
    :data:`ROUTE_FP32_RATIO` times the plain route does, by 1 - mean cosine
    and by 1 - min cosine (or within WITNESS_FLOOR of 1)."""
    kernel = np.concatenate(embed())
    with plain_route():
        plain = np.concatenate(embed())
        ref = np.concatenate(embed_fp32())
    ck, cp, ckp = _cos(kernel, ref), _cos(plain, ref), _cos(kernel, plain)
    out = dict(tokens=len(kernel), kernel_fp32_mean=float(ck.mean()), kernel_fp32_min=float(ck.min()),
               plain_fp32_mean=float(cp.mean()), plain_fp32_min=float(cp.min()),
               kernel_plain_mean=float(ckp.mean()), kernel_plain_min=float(ckp.min()))
    limits = {k: max(ROUTE_FP32_RATIO * (1 - out[f"plain_fp32_{k}"]), WITNESS_FLOOR) for k in ("mean", "min")}
    if not (np.isfinite(kernel).all() and all(1 - out[f"kernel_fp32_{k}"] <= limits[k] for k in limits)):
        raise AssertionError(f"{name}: {out}; the kernel route's 1 - cos against fp32 must be <= {limits}")
    log(f"  {name}, {out['tokens']} rows against the plain route in fp32: kernel route mean cos "
        f"{out['kernel_fp32_mean']:.6f}, min {out['kernel_fp32_min']:.6f}; plain route mean "
        f"{out['plain_fp32_mean']:.6f}, min {out['plain_fp32_min']:.6f} (the kernel route's gaps "
        f"{share(1 - out['kernel_fp32_mean'], limits['mean'])} and {share(1 - out['kernel_fp32_min'], limits['min'])}); "
        f"kernel vs plain route mean {out['kernel_plain_mean']:.6f}, min {out['kernel_plain_min']:.6f}")
    return out


def layerwise_int8_check(model, qmodel, feed: dict) -> dict:
    """Stored int8 against bf16 where quantization acts: each decoder layer
    of ``qmodel`` on the inputs that layer gets in ``model``'s forward of
    ``feed``, its branch (output less input) per valid token against the bf16
    layer's by cosine, and the tower's merged features likewise; each at
    INT8_COS_MEAN / INT8_COS_MIN. On a whole forward the two models part
    further than any layer does: where a GatedDeltaNet head's state is
    dominated by its own token, its output is near ``sign(q.k) v`` after the
    per-head RMSNorm, so a small error in ``q.k`` can flip a head, and the
    flips compound over 48 layers (bf16 against fp32 shows the same)."""
    inputs = []
    hooks = [layer.register_forward_pre_hook(lambda m, args: inputs.append(args))
             for layer in model.model.language_model.layers]
    try:
        with torch.inference_mode():
            model(**feed)
    finally:
        for h in hooks:
            h.remove()
    valid = feed["attention_mask"].bool()
    rows = []
    with torch.inference_mode():
        vision = [m.model.visual(*(feed[k] for k in ("pixel_values", "vision_hpos", "vision_wpos", "patch_mask",
                                                     "pos_idx", "pos_weight")), deepstack=False)[0].float()
                  for m in (model, qmodel)]
        cos = F.cosine_similarity(vision[0].flatten(0, 1), vision[1].flatten(0, 1), dim=-1)
        tower = dict(mean_cos=cos.mean().item(), min_cos=cos.min().item())
        for i, (lb, lq, args) in enumerate(zip(model.model.language_model.layers, qmodel.model.language_model.layers,
                                               inputs)):
            x = args[0]
            cos = F.cosine_similarity((lb(*args) - x)[valid].float(), (lq(*args) - x)[valid].float(), dim=-1)
            rows.append(dict(layer=i, kind="linear" if lb.linear else "full", mean_cos=cos.mean().item(),
                             min_cos=cos.min().item()))
    del inputs, vision
    worst_mean, worst_min = min(r["mean_cos"] for r in rows), min(r["min_cos"] for r in rows)
    out = dict(tower=tower, layers=rows, worst_layer_mean_cos=worst_mean, worst_layer_min_cos=worst_min)
    if not (min(tower["mean_cos"], worst_mean) >= INT8_COS_MEAN and min(tower["min_cos"], worst_min) >= INT8_COS_MIN):
        raise AssertionError(f"stored int8 against bf16 layer by layer: tower {tower}, worst layer mean cos "
                             f"{worst_mean}, min cos {worst_min}; limits {INT8_COS_MEAN}, {INT8_COS_MIN}: {rows}")
    log(f"  stored int8 vs bf16 layer by layer ({int(valid.sum())} tokens): tower mean cos {tower['mean_cos']:.6f}, "
        f"min {tower['min_cos']:.6f}; the decoder's {len(rows)} layers' branches, worst mean cos {worst_mean:.6f}, "
        f"worst min {worst_min:.6f} (limits {INT8_COS_MEAN}, {INT8_COS_MIN}; shares "
        f"{share(1 - worst_mean, 1 - INT8_COS_MEAN)}, {share(1 - worst_min, 1 - INT8_COS_MIN)})")
    return out


def phase_qwen35(device: torch.device, smi: str, ckpt: str) -> tuple:
    """Drive the Qwen3.5 family's serving path: ColQwen3_5 at the default config's full width and depth written by
    ``write_qwen35_checkpoint`` into ``ckpt`` and read back by ``load_retriever(family="colqwen3_5")`` in bf16 and
    stored int8; Q2 against its plain version at the page and query shapes; Q1a/Q1b at the decoder's (M, K, N);
    pages through ``embed_dataset``, ``/search_text`` through ``make_handler`` over a two-tier int8 index and
    ``serve.py --checkpoint --family colqwen3_5``; K1-K3 held on the index; both bf16 routes against the plain
    route in fp32 (:func:`fp32_witness_check`), stored int8 against bf16 layer by layer
    (:func:`layerwise_int8_check`); forward and encode timings, Q2's share of the forward's kernels; BiQwen3_5 at
    full width. Returns the launches over the path, the kernel rows and the rest."""
    import os
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.evaluation.evaluator import embed_dataset
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.models.qwen3_5 import BiQwen3_5
    from colpali_tpu_torch.processors.bi import BiQwen3_5Processor
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.retrieval.store import CorpusIndex
    from colpali_tpu_torch.serve import RetrievalServer
    from colpali_tpu_torch.utils.testing import write_qwen35_checkpoint

    held = free_memory("phase qwen3.5")
    t_phase = time.perf_counter()
    cfg = qwen35_config()
    v, t = cfg.vision, cfg.text
    n_linear = sum(t.layer_type(i) == "linear_attention" for i in range(t.num_hidden_layers))
    pages = make_pages(QWEN35_PAGES, SEED + 91)
    extra = dict(held_gib_at_start=held)
    t0 = time.perf_counter()
    write_qwen35_checkpoint(ckpt, cfg, seed=SEED + 92, words=" ".join(QUERIES).split(), device=device)
    torch.cuda.empty_cache()
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, processor = load_retriever(ckpt, family="colqwen3_5", device=device)
    torch.cuda.synchronize()
    t_bf16 = time.perf_counter() - t0
    t0 = time.perf_counter()
    qmodel, qproc = load_retriever(ckpt, family="colqwen3_5", device=device, quantize=True)
    torch.cuda.synchronize()
    t_int8 = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    stored = sum(isinstance(m, QDense) and m.stored for m in qmodel.modules())
    bytes_int8, bytes_bf16 = (sum(x.numel() * x.element_size() for x in m.state_dict().values())
                              for m in (qmodel, model))
    log(f"phase qwen3.5: ColQwen3_5 at the default config, vision {v.depth} x {v.hidden_size} ({v.num_heads} heads x "
        f"{v.head_dim}, {v.patch_size} px patches, out {v.out_hidden_size}), text {t.num_hidden_layers} x "
        f"{t.hidden_size} ({n_linear} GatedDeltaNet layers, {t.linear_num_key_heads}/{t.linear_num_value_heads} heads "
        f"of {t.linear_key_head_dim}, conv {t.linear_conv_kernel_dim}; {t.num_hidden_layers - n_linear} gated "
        f"attention layers, {t.num_attention_heads}/{t.num_key_value_heads} heads of {t.head_dim}, rotary "
        f"{t.rotary_dim}; MLP {t.intermediate_size}, vocab {t.vocab_size}), head {cfg.dim}: {n_params / 1e9:.3f} B "
        f"params; HF checkpoint written in {t_write:.1f} s, load_retriever {t_bf16:.1f} s (bf16), {t_int8:.1f} s "
        f"(quantize=True: {stored} stored-int8 layers, {bytes_int8 / 1e9:.3f} GB against {bytes_bf16 / 1e9:.3f} GB)")
    if stored != QWEN35_STORED_LAYERS or model.head.custom_text_proj.out_features != cfg.dim:
        raise AssertionError(f"load_retriever(quantize=True): {stored} stored-int8 layers, expected "
                             f"{QWEN35_STORED_LAYERS}; head {model.head.custom_text_proj.out_features} wide")
    batch = pages[:PAGE_BATCH]
    feed = {k: torch.as_tensor(x).to(device) for k, x in processor.process_images(batch, device_pixels=True).items()
            if k != "image_grid_thw"}
    n_image = (feed["input_ids"] == cfg.image_token_id).sum(1)
    if not bool((n_image == QWEN3_PAGE_TOKENS).all()):
        raise AssertionError(f"a {PAGE_HW[1]} x {PAGE_HW[0]} page: {n_image.tolist()} merged tokens; expected "
                             f"{QWEN3_PAGE_TOKENS}")
    page_tokens = feed["input_ids"].shape[1]
    encoders = {"bf16": QueryEncoder(model, processor), "int8": QueryEncoder(qmodel, qproc)}
    for enc in encoders.values():
        enc.warmup()
    query_tokens = encoders["bf16"]._pad_static(processor.process_queries(QUERIES))[0]["input_ids"].shape[1]
    q2 = q2_cases(device, page_tokens, query_tokens, t)

    # Q1a/Q1b at the (M, K, N) of one stored-int8 page forward and the query forwards (x8, x1), by hooks; the
    # tower's are phase 14's, the decoder's are new
    with torch.inference_mode():
        page_mkn = q1_path_shapes(qmodel, lambda: qmodel(**feed))
        model(**feed)  # the bf16 model's first page forward, so that the path below runs warm
    query_mkn = q1_path_shapes(qmodel, lambda: (encoders["int8"].encode(QUERIES),
                                                encoders["int8"].encode(QUERIES[:1])))
    text_mkn = [mkn for mkn in page_mkn if mkn[0] == PAGE_BATCH * page_tokens] + query_mkn
    if any(k % 16 or n % 16 for _, k, n in page_mkn + query_mkn):
        raise AssertionError(f"a width that is not a multiple of 16: {page_mkn + query_mkn}")
    checks = q1_checks(device, page_mkn + query_mkn, edge_ks=(2048, 4096))
    log(f"phase qwen3.5: Q1a and Q1b bit-equal to their plain versions in {checks['q1b_cases']} Q1b cases at the page "
        f"forward's (M, K, N) {page_mkn} and the query forwards' {query_mkn}; timed at the decoder's {text_mkn}")
    q1_rows, q1_gemms = q1_timing(device, text_mkn)
    extra["q1_checks"] = dict(checks, page_forward_mkn=page_mkn, query_forward_mkn=query_mkn)

    # K6 and Q2 launches of one page forward and one query forward
    reset_launches()
    with torch.inference_mode():
        model(**feed)
    per_page = ({d: n for d, n in fa.FORWARD_LAUNCHES_BY_HEAD_DIM.items() if n}, gdr.GATED_DELTA_RULE.launches)
    reset_launches()
    encoders["bf16"].encode(QUERIES)
    per_query = ({d: n for d, n in fa.FORWARD_LAUNCHES_BY_HEAD_DIM.items() if n}, gdr.GATED_DELTA_RULE.launches)
    if per_page != ({v.head_dim: v.depth}, n_linear) or per_query != ({}, n_linear):
        raise AssertionError(f"launches (K6 by head dim, Q2): a page forward {per_page}, a query forward "
                             f"{per_query}; expected ({{{v.head_dim}: {v.depth}}}, {n_linear}) and ({{}}, {n_linear})")

    # the path, counted: pages embedded, /search_text through make_handler on each model, serve.py
    reset_launches()
    with counted_plain() as plain_k6, counted_plain(gdr, "chunk_gated_delta_rule_plain") as plain_q2:
        t0 = time.perf_counter()
        embs = {"bf16": embed_dataset(model, processor, pages, batch_size=PAGE_BATCH)}
        t_embed_bf16 = time.perf_counter() - t0
        t0 = time.perf_counter()
        embs["int8"] = embed_dataset(qmodel, qproc, pages, batch_size=PAGE_BATCH)
        t_embed_int8 = time.perf_counter() - t0
        for label, es in embs.items():
            for e in es:
                if e.shape != (page_tokens, cfg.dim) or not np.isfinite(e).all() or \
                        np.abs(np.linalg.norm(e, axis=-1) - 1).max() > 1e-2:
                    raise AssertionError(f"{label} page embedding {e.shape}: not {page_tokens} finite unit rows of "
                                         f"{cfg.dim}")
        gen = torch.Generator(device=device).manual_seed(SEED + 93)
        filler = torch.randn((QWEN35_FILLER_DOCS, DOC_TOKENS, cfg.dim), generator=gen, device=device)
        filler = list((filler / filler.norm(dim=-1, keepdim=True)).cpu().numpy())
        planted_q = encoders["int8"].encode(QUERIES[: len(QWEN35_PLANTED)])
        docs = [np.concatenate([e, planted_q[QWEN35_PLANTED.index(i)]]) if i in QWEN35_PLANTED else e
                for i, e in enumerate(embs["int8"])] + filler
        index = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
        httpd = RetrievalServer(("127.0.0.1", 0), serve.make_handler(
            index, [f"doc_{i}" for i in range(index.num_docs)], encoder=encoders["int8"]))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_port}"
        try:
            tiered = [_http(url, "/search_text", {"queries": [q], "k": 10}) for q in QUERIES[: len(QWEN35_PLANTED)]]
            exact = _http(url, "/search_text", {"queries": QUERIES, "k": 10})  # 8 > 4: the exact route
        finally:
            httpd.shutdown()
            httpd.server_close()
        for out in (*tiered, exact):
            _check_ranked("/search_text (stored int8)", out, len(out["doc_ids"]))
        top = ([out["doc_ids"][0][0] for out in tiered], [row[0] for row in exact["doc_ids"][: len(QWEN35_PLANTED)]])
        if top[0] != list(QWEN35_PLANTED) or top[1] != list(QWEN35_PLANTED):
            raise AssertionError(f"/search_text at rank 1: tiered {top[0]}, exact {top[1]}, planted "
                                 f"{list(QWEN35_PLANTED)}")
        npz = f"{ckpt}/corpus.npz"
        np.savez(npz, **{f"emb_{i}": d for i, d in enumerate(docs)})
        t0 = time.perf_counter()
        httpd = serve.make_server([npz, "--port", "0", "--device", str(device), "--prefilter", "--checkpoint", ckpt,
                                   "--family", "colqwen3_5"])
        t_serve = time.perf_counter() - t0
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            cli = [_http(f"http://127.0.0.1:{httpd.server_port}", "/search_text", {"queries": [q], "k": 10})
                   for q in QUERIES[:2]]
        finally:
            httpd.shutdown()
            httpd.server_close()
        os.remove(npz)
        if [out["doc_ids"][0][0] for out in cli] != list(QWEN35_PLANTED[:2]):
            raise AssertionError(f"serve.py --family colqwen3_5: rank 1 {[out['doc_ids'][0][0] for out in cli]}, "
                                 f"planted {list(QWEN35_PLANTED[:2])}")
    launches = read_launches("Qwen3.5 family", ("flash_attention", "gated_delta_rule", "quantize_rows", "int8_gemm",
                                                "binary_maxsim", "gather_rerank", "maxsim_int8"))
    by_dim = {d: n for d, n in fa.FORWARD_LAUNCHES_BY_HEAD_DIM.items() if n}
    page_forwards = 2 * (QWEN35_PAGES // PAGE_BATCH)  # embed_dataset on each model
    if plain_k6[0] or plain_q2[0] or by_dim != {v.head_dim: page_forwards * v.depth} or \
            launches["gated_delta_rule"] < page_forwards * n_linear:
        raise AssertionError(f"Qwen3.5 path: K6 by head dim {by_dim}, Q2 {launches['gated_delta_rule']}; plain "
                             f"versions called K6 {plain_k6[0]}, Q2 {plain_q2[0]} times; expected {v.depth} K6 at "
                             f"D={v.head_dim} and {n_linear} Q2 a page forward over {page_forwards}, and Q2 on queries")
    log(f"  [{time.perf_counter() - t_phase:.0f} s] path: {QWEN35_PAGES} pages ({page_tokens} tokens) through "
        f"embed_dataset, each model warm (bf16 {QWEN35_PAGES / t_embed_bf16 * 60:.0f} pages/min, stored int8 "
        f"{QWEN35_PAGES / t_embed_int8 * 60:.0f}); a {index.num_docs}-doc x {index.doc_tokens}-token two-tier int8 "
        f"index behind make_handler: each of {len(QWEN35_PLANTED)} planted pages at rank 1 on the tiered and the exact "
        f"route of /search_text; serve.py --checkpoint --family colqwen3_5 (stored int8) started in {t_serve:.1f} s "
        f"and found two; launches {launches}, K6 by head dim {by_dim}, the plain versions called K6 {plain_k6[0]}, "
        f"Q2 {plain_q2[0]} times")
    held_k = hold_k123(index, served_queries(planted_q, device))
    k123 = {k: held_k[k] for k in ("k1_err", "k2_err", "k3_err")}
    log(f"phase qwen3.5: K1, K2 and K3 against their plain versions on the index ({index.num_docs} docs x "
        f"Np={index.doc_tokens}): max abs err K1 {k123['k1_err']:.3g} (bit for bit), K2 {k123['k2_err']:.3g}, K3 "
        f"{k123['k3_err']:.3g} (rtol {RTOL}, atol {ATOL})")
    del index, held_k, docs, filler
    torch.cuda.empty_cache()

    # checks beside the path (not counted): both bf16 routes against the plain route in fp32, stored int8 vs bf16
    from colpali_tpu_torch.models.qwen3_5 import ColQwen3_5

    fp32 = ColQwen3_5(cfg, device=device, dtype=torch.float32).eval()
    fp32.load_state_dict(model.state_dict())
    enc32 = QueryEncoder(fp32, processor)
    route = dict(
        pages=fp32_witness_check(f"ColQwen3_5 page forward ({PAGE_BATCH} pages)",
                                 lambda: embed_dataset(model, processor, batch, batch_size=PAGE_BATCH),
                                 lambda: embed_dataset(fp32, processor, batch, batch_size=PAGE_BATCH)),
        queries=fp32_witness_check(f"ColQwen3_5 query forward ({len(QUERIES)} queries)",
                                   lambda: encoders["bf16"].encode(QUERIES), lambda: enc32.encode(QUERIES)))
    del fp32, enc32
    torch.cuda.empty_cache()
    accuracy = dict(layerwise=layerwise_int8_check(model, qmodel, feed))
    for label, got, want in (("pages", embs["int8"][:PAGE_BATCH], embs["bf16"][:PAGE_BATCH]),
                             ("queries", encoders["int8"].encode(QUERIES), encoders["bf16"].encode(QUERIES))):
        cos = _cos(np.concatenate(got), np.concatenate(want))
        accuracy[label] = dict(tokens=len(cos), mean_cos=float(cos.mean()), min_cos=float(cos.min()))
        log(f"  {label}, stored int8 vs bf16 end to end (read, not held: see layerwise_int8_check): {len(cos)} tokens, "
            f"mean cos {cos.mean():.6f}, min {cos.min():.6f}")

    # end to end, bf16 and stored int8 in turns: one forward of 8 pages (CUDA events), encode x1 / x8
    e2e = {}
    for label in ("bf16", "int8", "int8 again", "bf16 again"):
        m, enc = (model, encoders["bf16"]) if label.startswith("bf16") else (qmodel, encoders["int8"])
        r = dict(page_forward_ms=forward_ms(m, feed))
        for b_, texts in (("x1", QUERIES[:1]), ("x8", QUERIES)):
            enc.encode(texts)
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                enc.encode(texts)
                walls.append((time.perf_counter() - t0) * 1e3)
            r[f"encode_{b_}_ms"] = float(np.median(walls))
        r["pages_per_min_forward"] = PAGE_BATCH / r["page_forward_ms"] * 6e4
        e2e[label] = r
        log(f"  {label} ({smi}): forward of {PAGE_BATCH} pages {r['page_forward_ms']:.1f} ms "
            f"({r['pages_per_min_forward']:.0f} pages/min of forward alone), encode x1 {r['encode_x1_ms']:.2f} ms, "
            f"x8 {r['encode_x8_ms']:.2f} ms")
    with torch.inference_mode():
        profiles = {label: kernel_breakdown(f"one {label} ColQwen3_5 forward of {PAGE_BATCH} pages",
                                            lambda m=m: m(**feed)) for label, m in (("bf16", model),
                                                                                   ("stored-int8", qmodel))}
    for label, prof in profiles.items():
        if prof.get("kernels_ms"):
            prof["q2_share"] = prof["Q2"] / prof["kernels_ms"]
            log(f"  Q2's share of the {label} forward's kernel time: {prof['q2_share']:.1%} ({prof['Q2']:.1f} ms of "
                f"{prof['kernels_ms']:.1f} ms, {n_linear} launches)")
    query_feed = processor.process_queries(QUERIES)
    del encoders, qmodel, embs
    torch.cuda.empty_cache()

    # BiQwen3_5 at full width on the checkpoint's backbone: the kernel route against the plain route and fp32
    bmodel = BiQwen3_5(cfg, device=device, dtype=torch.bfloat16).eval()
    bmodel.load_state_dict({k: x for k, x in model.state_dict().items() if k.startswith("model.")})
    del model
    torch.cuda.empty_cache()
    bproc = BiQwen3_5Processor.from_pretrained(ckpt, device=device, max_num_visual_tokens=768)
    fp32 = BiQwen3_5(cfg, device=device, dtype=torch.float32).eval()
    fp32.load_state_dict(bmodel.state_dict())

    def vectors(m):
        with torch.inference_mode():
            return [m(**{k: torch.as_tensor(x).to(device) for k, x in f.items() if k != "image_grid_thw"})
                    .float().cpu().numpy() for f in (feed, query_feed)]

    bi = fp32_witness_check("BiQwen3_5 (default config, last pooling)", lambda: vectors(bmodel), lambda: vectors(fp32))
    page_vecs, query_vecs = vectors(bmodel)
    for i, p in enumerate(BI_PLANTED):  # page p's vector replaced by query i's: the score finds it at rank 1
        page_vecs[p] = query_vecs[i]
    bi["top"] = bproc.score(list(query_vecs[: len(BI_PLANTED)]), list(page_vecs)).argmax(axis=1).tolist()
    if bi["top"] != list(BI_PLANTED) or page_vecs.shape[1] != t.hidden_size:
        raise AssertionError(f"BiQwen3_5: score's rank 1 {bi['top']}, planted {list(BI_PLANTED)}; vectors of "
                             f"{page_vecs.shape[1]}")
    log(f"  BiQwen3_5: {len(page_vecs)} page and {len(query_vecs)} query vectors of {page_vecs.shape[1]}; its "
        f"processor's score finds each planted page at rank 1 {bi['top']}")
    del bmodel, fp32, feed, query_feed
    torch.cuda.empty_cache()
    extra.update(q2=q2, k123=k123, params=n_params, stored_int8_layers=stored, weight_bytes_int8=bytes_int8,
                 weight_bytes_bf16=bytes_bf16, page_tokens=page_tokens, query_tokens=query_tokens, route_check=route,
                 int8_vs_bf16=accuracy, end_to_end=e2e, page_profile=profiles, biqwen3_5=bi,
                 per_page_forward=dict(k6_by_head_dim={str(d): n for d, n in per_page[0].items()}, q2=per_page[1]),
                 per_query_forward=dict(k6_by_head_dim={}, q2=per_query[1]),
                 launches_by_head_dim={str(d): n for d, n in by_dim.items()},
                 pages_per_min=dict(bf16=QWEN35_PAGES / t_embed_bf16 * 60, int8=QWEN35_PAGES / t_embed_int8 * 60),
                 write_load_seconds=dict(write=t_write, bf16=t_bf16, int8=t_int8))
    extra["seconds"] = time.perf_counter() - t_phase
    log(f"phase qwen3.5: {extra['seconds']:.1f} s")
    timings = {"gated_delta_rule": dict(q2["page_bf16"], query=q2["query_bf16"]),
               "quantize_rows": dict(shapes=q1_rows), "int8_gemm": dict(shapes=q1_gemms)}
    return launches, timings, extra


# -- phase 20: Qwen3.5 training (run after phase 19) ------------------------------------------------------------------

# the decoder cut to 12 of the default config's 48 layers: three hybrid periods, 9 GatedDeltaNet and 3 gated attention
# layers (the tower keeps its 27 blocks), so that the script stays near its time budget
QWEN35_TRAIN_DEPTH = 12
QWEN35_TRAIN_PAGES = 32  # four batches of 8
QWEN35_PAGE_SCALES = (1.0, 0.5, 0.35, 0.25)  # page sides as shares of PAGE_HW (mixed_size_dataset)
QWEN35_EVAL_PAGES = 16
QWEN35_TRAIN_STEPS, QWEN35_RESUME_AT = 4, 2
QWEN35_VISION_STORED = QWEN3_VISION_STORED  # quantize_frozen_base: Qwen3-VL-4B's tower, its deepstack mergers included
# Q2's backward against its plain backward: each gradient within 1e-3 of its own RMS (fp32 sums in another order over
# the reverse scan), with bf16 inputs one bf16 ulp of the value more (the kernel writes dq, dk, dv and dbeta in bf16)
Q2_BWD_ATOL_RMS = 1e-3


def q2_bwd_flops(b: int, s: int, hv: int, dk: int, dv: int) -> float:
    """Q2's backward's operations at one shape, over whole chunks of 64, counted as :func:`q2_flops` counts the
    forward's (triangles as half squares, a multiply-add as 2). What the saved states do not give is recomputed:
    k k^T and q k^T (C^2 Dk each), k S and q S (2 C Dk Dv each), the forward substitution (C^2 Dv). Then the
    backward: Kd dS' (2 C Dk Dv), P^T dO and the back substitution (C^2 Dv each), dP and dT (C^2 Dv each), the
    triangles' products into dq and dk (4 C^2 Dk), e^G dO S^T, Kd-side dS'^T and dKS S^T (6 C Dk Dv), and dS
    (4 C Dk Dv)."""
    c, n = gdr.CHUNK, -(-s // gdr.CHUNK)
    return b * hv * n * (6 * c * c * dk + 5 * c * c * dv + 16 * c * dk * dv)


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def q2_bwd_case(gen: torch.Generator, device: torch.device, b: int, s: int, cfg, dtype, log_decay: float,
                timed: bool) -> dict:
    """Q2's backward kernel against its plain backward on seeded inputs at one shape, q/k/v laid out as
    GatedDeltaNet's conv output (strided views of one row a token), the chunks' states from the forward kernel:
    each of the five gradients within Q2_BWD_ATOL_RMS of its RMS (and a bf16 ulp for bf16 outputs), bit-equal on a
    second call, finite. ``timed``: the kernel and the plain backward by CUDA events beside the bound."""
    hk, hv, dk, dv = cfg.linear_num_key_heads, cfg.linear_num_value_heads, cfg.linear_key_head_dim, \
        cfg.linear_value_head_dim
    mixed = torch.randn((b, s, 2 * hk * dk + hv * dv), generator=gen, device=device).to(dtype)
    q = mixed[..., :hk * dk].view(b, s, hk, dk)
    k = mixed[..., hk * dk:2 * hk * dk].view(b, s, hk, dk)
    v = mixed[..., 2 * hk * dk:].view(b, s, hv, dv)
    g = -log_decay * (0.5 + torch.rand((b, s, hv), generator=gen, device=device))
    beta = torch.rand((b, s, hv), generator=gen, device=device).to(dtype)
    d_out = torch.randn((b, s, hv, dv), generator=gen, device=device).to(dtype)
    states = torch.empty((b, hv, -(-s // gdr.CHUNK), dk, dv), dtype=torch.float32, device=device)
    gdr._forward_cuda(q, k, v, g, beta, states)

    def kernel():
        return gdr.chunk_gated_delta_rule_backward(q, k, v, g, beta, states, d_out)

    got = kernel()
    want = gdr.chunk_gated_delta_rule_backward_plain(q, k, v, g, beta, d_out)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, kernel())):
        raise AssertionError(f"Q2 backward B={b} S={s} {dtype}: two calls differ")
    shares, errs = {}, {}
    for name, x, w in zip(("dq", "dk", "dv", "dg", "dbeta"), got, want):
        if not (torch.isfinite(x).all() and torch.isfinite(w).all()):
            raise AssertionError(f"Q2 backward B={b} S={s} {dtype} log-decay {log_decay}: {name} not finite")
        rms = w.square().mean().sqrt().item()
        limit = Q2_BWD_ATOL_RMS * rms + (_bf16_ulp(w) if x.dtype == torch.bfloat16 else 0.0)
        err = (x.float() - w).abs()
        errs[name] = err.max().item()
        shares[name] = (err / limit).max().item()
    r = dict(shape=f"B={b} S={s} Hk={hk} Hv={hv} Dk={dk} Dv={dv} {str(dtype)[6:]} log-decay {log_decay}",
             max_abs_err=max(errs.values()), max_abs_err_by_grad=errs, share_of_limit=shares)
    if max(shares.values()) > 1.0:
        raise AssertionError(f"Q2 backward [{r['shape']}] against its plain backward: {r}")
    if timed:
        esize = q.element_size()
        nbytes = ((2 * b * s * hk * dk + 2 * b * s * hv * dv + b * s * hv) * esize * 2 + 2 * b * s * hv * 4
                  + states.numel() * 4)
        r.update(ms=time_ms(kernel), plain_ms=time_ms(
            lambda: gdr.chunk_gated_delta_rule_backward_plain(q, k, v, g, beta, d_out), reps=2),
                 library_ms=None, **bound(nbytes, q2_bwd_flops(b, s, hv, dk, dv), "fp32"))
    del mixed, q, k, v, g, beta, d_out, states, got, want
    return r


def q2_bwd_cases(device: torch.device, page_s: int, query_s: int, cfg) -> dict:
    """Q2's backward at the page shape (8 pages' prompts) and the query shape (8 collated queries), each in fp32
    and bf16, the bf16 cases timed, and a bf16 draw at Q2_LARGE_DECAY at the page shape."""
    gen = torch.Generator(device=device).manual_seed(SEED + 96)
    out = {}
    for name, s in (("page", page_s), ("query", query_s)):
        for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            r = out[f"{name}_{label}"] = q2_bwd_case(gen, device, PAGE_BATCH, s, cfg, dtype, 0.3,
                                                     timed=label == "bf16")
            timing = (f": kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
                      f"({r['bound_by']}), {r['bound_ms'] / r['ms']:.1%} of it") if "ms" in r else ""
            log(f"phase qwen3.5 training: Q2 backward [{r['shape']}] max_abs_err "
                + ", ".join(f"{k} {e:.3g}" for k, e in r["max_abs_err_by_grad"].items())
                + " (share of the limit " + ", ".join(f"{k} {x:.0%}" for k, x in r["share_of_limit"].items())
                + f"), bit-equal on a second call{timing}")
    r = out["page_large_decay"] = q2_bwd_case(gen, device, PAGE_BATCH, page_s, cfg, torch.bfloat16, Q2_LARGE_DECAY,
                                              timed=False)
    log(f"phase qwen3.5 training: Q2 backward [{r['shape']}] finite, largest share of the limit "
        f"{max(r['share_of_limit'].values()):.0%}")
    torch.cuda.empty_cache()
    return out


def route_scores_check(name: str, model, fp32_model, batch: dict) -> dict:
    """The first batch's query and page embeddings and in-batch MaxSim scores (the recipe loss's inputs) through
    ``model``'s kernel route and its plain route, each against the plain route in fp32 (``fp32_model`` given
    ``model``'s weights): the kernel route's mean |score - fp32 score| and its 1 - mean cosine per token (the
    queries' valid tokens and the pages' image tokens) no more than ROUTE_FP32_RATIO times the plain route's (or
    within WITNESS_FLOOR of 1 for the cosine). On a model that bf16 alone moves (Qwen3.5) a single loss value
    sits on either side of its fp32 value at random, route by route; these means over many scores and tokens
    do not."""
    from colpali_tpu_torch.training.trainer import forward_prefixed

    fp32_model.load_state_dict(model.state_dict())
    valid = torch.cat([batch["query_attention_mask"].bool().flatten(),
                       (batch["doc_input_ids"] == model.config.image_token_id).flatten()])

    def embed(m):
        with torch.no_grad():
            q, d = (forward_prefixed(m, batch, p).float() for p in ("query_", "doc_"))
        scores = torch.einsum("bnd,csd->bcns", q, d).max(-1).values.sum(-1)
        return scores, torch.cat([q.flatten(0, 1), d.flatten(0, 1)])[valid]

    sk, ek = embed(model)
    with plain_route():
        sp, ep = embed(model)
        sf, ef = embed(fp32_model)
    out = dict(score_gap_kernel=(sk - sf).abs().mean().item(), score_gap_plain=(sp - sf).abs().mean().item(),
               score_scale=sf.abs().mean().item(),
               cos_kernel=F.cosine_similarity(ek, ef, dim=-1).mean().item(),
               cos_plain=F.cosine_similarity(ep, ef, dim=-1).mean().item(), tokens=int(valid.sum()))
    cos_limit = max(ROUTE_FP32_RATIO * (1 - out["cos_plain"]), WITNESS_FLOOR)
    if not (out["score_gap_kernel"] <= ROUTE_FP32_RATIO * out["score_gap_plain"] and 1 - out["cos_kernel"] <= cos_limit):
        raise AssertionError(f"{name}: the kernel route against the plain route in fp32 {out}; limits "
                             f"{ROUTE_FP32_RATIO} x the plain route's score gap and {cos_limit} on 1 - cos")
    log(f"  {name}, against the plain route in fp32: in-batch scores (mean |score| {out['score_scale']:.3f}) off by "
        f"{out['score_gap_kernel']:.4e} on the kernel route, {out['score_gap_plain']:.4e} on the plain route "
        f"({share(out['score_gap_kernel'], ROUTE_FP32_RATIO * out['score_gap_plain'])}); {out['tokens']} tokens' mean "
        f"cos {out['cos_kernel']:.6f} and {out['cos_plain']:.6f} ({share(1 - out['cos_kernel'], cos_limit)})")
    return out


def mixed_size_dataset(n: int, seed: int, first: int = 0):
    """``n`` seeded noise pages whose sides cycle through QWEN35_PAGE_SCALES of PAGE_HW (744, ~510, ~250 and ~125
    merged tokens at Qwen3.5's 768-token budget), with QUERIES in turn. Pages of one size look alike to Qwen3.5 on
    random weights: a query's MaxSim scores over 8 of them lie within 0.012-0.017 of each other, so the recipe loss
    (temperature 0.02) lands on either side of ln 8 by the draw's luck (PR 19: -0.184 to +0.172 over eight
    checkpoint seeds, the fp32 route of one 0.043 off, inside TIED_MARGIN). A page's best match over more tokens
    scores higher for every query; scores that differ by page put the loss above ln 8 by their logsumexp less
    their mean, whatever the draw. Real corpora mix page sizes too."""
    from colpali_tpu_torch.data.dataset import ColPaliEngineDataset

    rng = np.random.default_rng(seed)
    pages = []
    for i in range(n):
        scale = QWEN35_PAGE_SCALES[(first + i) % len(QWEN35_PAGE_SCALES)]
        hw = (round(PAGE_HW[0] * scale), round(PAGE_HW[1] * scale))
        pages.append(rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8))
    return ColPaliEngineDataset([{"query": QUERIES[(first + i) % len(QUERIES)], "pos_target": page}
                                 for i, page in enumerate(pages)])


def phase_qwen35_training(device: torch.device, smi: str, ckpt: str) -> tuple:
    """Drive the Qwen3.5 family's training path: Q2's backward against its plain backward at the page and query
    shapes; ColQwen3_5 at the default config's full width with the decoder cut to QWEN35_TRAIN_DEPTH layers,
    written by ``write_qwen35_checkpoint`` into ``ckpt``, read by ``load_retriever(family="colqwen3_5",
    remat=True, mask_non_image_embeddings=True)`` and trained through ``ColModelTraining`` from
    ``configs/train_colqwen3_5.yaml``'s loss and LoRA (4 steps at batch 8 over 32 pages: Q2's backward kernel on
    every GatedDeltaNet layer behind the first adapter, never a plain version); the routes held against the plain
    route in fp32 on fresh adapters; ``evaluate()`` (bf16 index, K5); the merged export read back and served; a run
    resumed from step 2; a step timed with and without remat and profiled; one step over a stored-int8 frozen
    tower; one BiQwen3_5 step. Returns the launches over the path, Q2's backward rows and the rest."""
    import math
    import os
    import shutil

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.losses import BiEncoderLoss, ColbertLoss
    from colpali_tpu_torch.models.layers import QDense
    from colpali_tpu_torch.models.qwen3_5 import BiQwen3_5, ColQwen3_5
    from colpali_tpu_torch.processors.bi import BiQwen3_5Processor
    from colpali_tpu_torch.training import trainer
    from colpali_tpu_torch.training.lora import LoraAdapters
    from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig
    from colpali_tpu_torch.utils.testing import write_qwen35_checkpoint

    held = free_memory("phase qwen3.5 training")
    t_phase = time.perf_counter()
    full, cfg = qwen35_config(), qwen35_cut_config()
    v, t = cfg.vision, cfg.text
    linear = [i for i in range(t.num_hidden_layers) if t.layer_type(i) == "linear_attention"]
    # a GatedDeltaNet layer takes a gradient once an adapter lies before it: every one but a first layer's
    per_step = 2 * sum(i > 0 for i in linear)  # a query and a page forward a step
    extra = dict(held_gib_at_start=held, depth=QWEN35_TRAIN_DEPTH)
    write_qwen35_checkpoint(ckpt, cfg, seed=SEED + 97, words=" ".join(QUERIES).split(), device=device)
    torch.cuda.empty_cache()
    train_config = trainer.TrainConfig(learning_rate=QWEN_LR, warmup_steps=0, total_steps=2500)
    train_set = mixed_size_dataset(QWEN35_TRAIN_PAGES, SEED + 98)
    eval_set = mixed_size_dataset(QWEN35_EVAL_PAGES, SEED + 99, first=QWEN35_TRAIN_PAGES)
    model, processor = load_retriever(ckpt, family="colqwen3_5", device=device, remat=True,
                                      mask_non_image_embeddings=True)
    tied = math.log(TRAIN_BATCH)
    recipe = functools.partial(recipe_config, train_set=train_set, train_config=train_config, device=device)
    sampled = ["model.language_model.layers.1.linear_attn.in_proj_qkvz.weight",
               f"model.language_model.layers.{t.num_hidden_layers - 1}.mlp.down_proj.weight",
               f"model.visual.blocks.{v.depth // 2}.linear_fc1.weight", "head.custom_text_proj.weight"]
    base_before = {k: model.state_dict()[k].clone() for k in sampled}
    with tempfile.TemporaryDirectory() as tmp:
        app = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colqwen3_5.yaml", f"{tmp}/run", model, processor, eval_dataset=eval_set,
            eval_batch_size=TRAIN_BATCH, max_steps=QWEN35_TRAIN_STEPS, save_steps=QWEN35_RESUME_AT,
            save_total_limit=QWEN35_TRAIN_STEPS)))
        peft, loss_fn = app.config.peft, app.config.loss_func
        if not isinstance(loss_fn, ColbertLoss) or loss_fn.temperature != 0.02 or \
                (peft.rank, peft.alpha) != (32, 32):
            raise AssertionError(f"train_colqwen3_5.yaml's loss and LoRA: {loss_fn}, {peft}")
        batch = trainer.to_device(next(iter(app.batches(0))), device)  # step 1's batch
        page_s, query_s = batch["doc_input_ids"].shape[1], batch["query_input_ids"].shape[1]
        q2_bwd = q2_bwd_cases(device, page_s, query_s, t)
        log(f"  [{time.perf_counter() - t_phase:.0f} s] ColQwen3_5 at the default config's widths, the decoder cut to "
            f"{t.num_hidden_layers} of {full.text.num_hidden_layers} layers ({len(linear)} GatedDeltaNet, "
            f"{t.num_hidden_layers - len(linear)} gated attention), the tower's {v.depth} blocks: "
            f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params; pages of {page_s} tokens, queries of "
            f"{query_s}")
        spread = page_score_spread(model, batch, cfg.image_token_id, loss_fn)
        margin = abs(spread["masked"]["loss"] - tied)
        log(f"  step 1's batch's in-batch scores: page tokens kept, the recipe loss {spread['unmasked']['loss']:.6f}, "
            f"{spread['unmasked']['on_template']:.1%} of the query tokens' maxima outside the image tokens; non-image "
            f"tokens masked (as trained here) {spread['masked']['loss']:.6f} ({margin:.4f} from ln {TRAIN_BATCH}, "
            f"limit {TIED_MARGIN}), least spread {spread['masked']['min_spread']:.5f}")
        if margin < TIED_MARGIN:
            raise AssertionError(f"ColQwen3_5 LoRA: the recipe loss over the image tokens "
                                 f"{spread['masked']['loss']:.6f} lies within {TIED_MARGIN} of ln {TRAIN_BATCH}: the "
                                 f"pages score alike")
        extra["score_spread"] = spread
        # the kernel route against the plain routes on the run's fresh adapters and step 1's dropout masks, held to
        # the plain route in fp32 (phase 9's rule: bf16 alone moves this model's tokens, phase 19)
        fp32 = ColQwen3_5(cfg, mask_non_image_embeddings=True, device=device, dtype=torch.float32, remat=True)
        extra["route_scores"] = route_scores_check("ColQwen3_5 (the base, non-image tokens masked)", model, fp32,
                                                   batch)
        reset_launches()
        extra["route"] = hold_routes("ColQwen3_5 LoRA (fresh adapters, non-image tokens masked)", app.state, batch,
                                     loss_fn, peft, tied=tied, fp32_model=fp32)
        if gdr.GATED_DELTA_RULE_BWD.launches != 2 * per_step:  # the recipe loss and the smooth probe's kernel routes
            raise AssertionError(f"route check: {gdr.GATED_DELTA_RULE_BWD.launches} Q2 backward launches, expected "
                                 f"{2 * per_step}")
        del fp32
        torch.cuda.empty_cache()
        n_adapters, n_trainable = len(app.state.adapters.paths), sum(p.numel() for p in app.state.params)
        seen, moved = [], []

        def on_step(step, metrics):
            seen.append((step, float(metrics["loss"]), float(metrics["grad_norm"])))
            if step == 1:
                moved.extend(bool(b.detach().abs().max() > 0) for b in app.state.adapters.b)

        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with counted_plain(gdr, "chunk_gated_delta_rule_plain") as plain_fwd, \
                counted_plain(gdr, "chunk_gated_delta_rule_backward_plain") as plain_bwd, \
                counted_plain() as plain_k6:
            summary = app.train(on_step=on_step)
        torch.cuda.synchronize()
        train_launches = launch_counts()
        peak_train = torch.cuda.max_memory_allocated() / 2**30
        app.state.adapters.clear_masks()
        with torch.no_grad():
            trained = trainer.compute_loss(model.eval(), batch, loss_fn, False)[0].item()
        model.train()
        step_move = abs(trained - spread["masked"]["loss"]) / spread["masked"]["loss"]
        if [s for s, _, _ in seen] != list(range(1, QWEN35_TRAIN_STEPS + 1)) or \
                not all(np.isfinite(l) and l > 0 and np.isfinite(g) and g > 0 for _, l, g in seen):
            raise AssertionError(f"ColQwen3_5 steps: {seen}")
        if len(moved) != n_adapters or not all(moved):
            raise AssertionError(f"{moved.count(False)} of {n_adapters} adapters did not move in step 1")
        if not all(torch.equal(model.state_dict()[k], w) for k, w in base_before.items()):
            raise AssertionError("a frozen base weight changed")
        if abs(seen[0][1] - tied) < TIED_MARGIN or not step_move >= STEP_MOVE_RTOL:
            raise AssertionError(f"ColQwen3_5: step 1's loss {seen[0][1]:.6f} (ln {TRAIN_BATCH} = {tied:.6f}, margin "
                                 f"{TIED_MARGIN}); the first batch's recipe loss {spread['masked']['loss']:.6f} -> "
                                 f"{trained:.6f} after the steps ({step_move:.1%}, at least {STEP_MOVE_RTOL:.0%})")
        if train_launches["gated_delta_rule_bwd"] != QWEN35_TRAIN_STEPS * per_step or \
                plain_fwd[0] or plain_bwd[0] or plain_k6[0] or train_launches["flash_attention_bwd"]:
            raise AssertionError(f"Q2 over {QWEN35_TRAIN_STEPS} LoRA steps: {train_launches}; plain calls: Q2 "
                                 f"{plain_fwd[0]}, its backward {plain_bwd[0]}, K6 {plain_k6[0]}; expected {per_step} "
                                 f"Q2 backward launches a step and no K6 backward (the tower is frozen)")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] ColQwen3_5, ColModelTraining from train_colqwen3_5.yaml "
            f"({smi}): {n_adapters} adapted layers, {n_trainable / 1e6:.2f} M trainable parameters, "
            f"{type(loss_fn).__name__}(temperature {loss_fn.temperature}), LoRA r{peft.rank} a{peft.alpha:g} dropout "
            f"{peft.dropout}, remat, non-image tokens masked, batch {TRAIN_BATCH}; "
            + ", ".join(f"step {s} loss {l:.4f} grad_norm {g:.4f}" for s, l, g in seen)
            + f" (step 1 {abs(seen[0][1] - tied):.4f} from ln {TRAIN_BATCH}, limit {TIED_MARGIN}); the first batch's "
            f"recipe loss {spread['masked']['loss']:.6f} -> {trained:.6f} ({step_move:.1%}, limit "
            f"{STEP_MOVE_RTOL:.0%}); {summary['train_samples_per_second']:.2f} examples/s with collation and "
            f"checkpoints; Q2 {train_launches['gated_delta_rule']} launches, its backward "
            f"{train_launches['gated_delta_rule_bwd']} ({per_step} a step), K6 {train_launches['flash_attention']} "
            f"(the frozen tower), no plain version called; peak memory {peak_train:.2f} GiB")

        reset_launches()
        t0 = time.perf_counter()
        metrics = app.evaluate()
        t_eval = time.perf_counter() - t0
        eval_launches = launch_counts()
        index = app.eval_index
        if not {"eval_loss", "eval_ndcg@1", "eval_ndcg@5"} <= set(metrics) or \
                not all(np.isfinite(x) for x in metrics.values()) or not eval_launches["maxsim_bf16"] or \
                (index.dtype, index.num_docs, index.dim, index._store.device.type) != \
                ("bf16", QWEN35_EVAL_PAGES, DIM, device.type):
            raise AssertionError(f"evaluate(): {metrics}, index {index.dtype} {index.num_docs} x {index.dim}, "
                                 f"{eval_launches}")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] evaluate(): {QWEN35_EVAL_PAGES} held-out pages in "
            f"{t_eval:.1f} s, bf16 index {index.num_docs} x {index.doc_tokens} x {index.dim} searched by K5 "
            f"({eval_launches['maxsim_bf16']} launch(es)); " + ", ".join(f"{k} {x:.4f}" for k, x in sorted(metrics.items())))
        app.save()
        merged = app.state.adapters.merged_state_dict(model)
        app.close()
        readback = export_readback(device, f"{tmp}/run", merged, cfg, ColQwen3_5, "colqwen3_5", "ColQwen3_5")
        del merged
        os.remove(f"{tmp}/run/model.safetensors")

        os.makedirs(f"{tmp}/resumed/checkpoints")
        shutil.copy(f"{tmp}/run/checkpoints/step_{QWEN35_RESUME_AT}.pt", f"{tmp}/resumed/checkpoints/")
        resumed = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colqwen3_5.yaml", f"{tmp}/resumed", model, processor, max_steps=QWEN35_RESUME_AT + 1,
            save_steps=100, resume_from_checkpoint=True)))
        tail = []
        resumed.train(on_step=lambda step, m: tail.append((step, float(m["loss"]))))
        resumed.close()
        first = seen[QWEN35_RESUME_AT][1]
        if resumed.state.step != QWEN35_RESUME_AT + 1 or [s for s, _ in tail] != [QWEN35_RESUME_AT + 1] or \
                abs(tail[0][1] - first) > RESUME_LOSS_RTOL * abs(first):
            raise AssertionError(f"resumed run: {tail}, the first run's step {QWEN35_RESUME_AT + 1} loss {first}")
        log(f"  resumed from step {QWEN35_RESUME_AT}: step {QWEN35_RESUME_AT + 1} loss {tail[0][1]:.8f} vs "
            f"{first:.8f} in the first run (limit {RESUME_LOSS_RTOL} relative)")

        # a step at batch 8 with and without remat, and a profile of one
        adapters = LoraAdapters(model, peft, seed=SEED + 1)
        state = trainer.create_train_state(model, train_config, adapters)
        steps = {}
        for remat in (True, False):
            model.set_remat(remat)
            steps["remat" if remat else "no_remat"] = r = timed_steps(state, batch, loss_fn, peft, SEED, steps=2)
            log(f"  ColQwen3_5 LoRA step, batch {TRAIN_BATCH}, remat {'on' if remat else 'off'} ({smi}): "
                f"{r['wall']:.1f} ms/step ({TRAIN_BATCH / r['wall'] * 1e3:.2f} examples/s without collation), forward "
                f"{r['forward']:.1f} ms, backward {r['backward']:.1f} ms, optimizer {r['optimizer']:.1f} ms, host and "
                f"idle {r['wall'] - r['forward'] - r['backward'] - r['optimizer']:.1f} ms, peak memory "
                f"{r['peak_gib']:.2f} GiB ({r['allocated_before_gib']:.2f} GiB held before the step)")
        model.set_remat(True)
        step_fn = trainer.make_train_step(loss_fn, peft=peft, seed=SEED)
        steps["profile"] = kernel_breakdown(f"one ColQwen3_5 LoRA step, batch {TRAIN_BATCH}, remat on",
                                            lambda: step_fn(state, batch)["loss"].item())
        adapters.detach()
        del state, adapters
        extra.update(losses=[l for _, l, _ in seen], grad_norms=[g for _, _, g in seen], eval=metrics,
                     loss_after_steps=trained, step_move=step_move,
                     examples_per_s_end_to_end=summary["train_samples_per_second"], peak_train_gib=peak_train,
                     step_ms=steps, checkpoint_readback=readback, resumed_loss=tail[0][1], trainable=n_trainable,
                     adapted_layers=n_adapters, launches_per_step={"gated_delta_rule_bwd": per_step})

        # one step over a stored-int8 frozen vision tower (it stays int8 from here on; BiQwen3_5 takes the bf16 one)
        col_state = {k: x for k, x in model.state_dict().items() if k.startswith("model.")}
        qapp = ColModelTraining(ColModelTrainingConfig(**recipe(
            "train_colqwen3_5.yaml", f"{tmp}/quant", model, processor, max_steps=1, save_steps=100,
            quantize_frozen_base=True)))
        stored = [name for name, m in model.named_modules() if isinstance(m, QDense) and m.stored]
        if len(stored) != QWEN35_VISION_STORED or not all(n.startswith("model.visual.") for n in stored):
            raise AssertionError(f"quantize_frozen_base stored {len(stored)} layers, expected the vision tower's "
                                 f"{QWEN35_VISION_STORED}")
        reset_launches()
        qseen = []
        qapp.train(on_step=lambda step, m: qseen.append(float(m["loss"])))
        torch.cuda.synchronize()
        quant_launches = launch_counts()
        qapp.close()
        if not quant_launches["int8_gemm"] or not quant_launches["quantize_rows"] or len(qseen) != 1 or \
                not np.isfinite(qseen[0]) or quant_launches["gated_delta_rule_bwd"] != per_step:
            raise AssertionError(f"quantize_frozen_base step {qseen}, launches {quant_launches}; expected Q1b "
                                 f"launches and {per_step} Q2 backward launches")
        log(f"  [{time.perf_counter() - t_phase:.0f} s] quantize_frozen_base: {len(stored)} stored-int8 vision layers; "
            f"one step, loss {qseen[0]:.4f}; Q1a {quant_launches['quantize_rows']} and Q1b "
            f"{quant_launches['int8_gemm']} launches, Q2 backward {quant_launches['gated_delta_rule_bwd']}")
        extra["quantize_frozen_base"] = dict(stored_layers=len(stored), loss=qseen[0], launches=quant_launches)
        del model, app, qapp, resumed
        torch.cuda.empty_cache()

    # one BiQwen3_5 LoRA step at the same widths and depth, on the checkpoint's backbone
    bmodel = BiQwen3_5(cfg, device=device, dtype=torch.bfloat16, remat=True)
    bmodel.load_state_dict(col_state)
    del col_state
    bproc = BiQwen3_5Processor(processor.tokenizer, num_grid_per_side=v.num_grid_per_side, max_num_visual_tokens=768,
                               device=device)
    with tempfile.TemporaryDirectory() as out:
        bapp = ColModelTraining(ColModelTrainingConfig(
            model=bmodel, processor=bproc, loss_func=BiEncoderLoss(), train_datasets=[train_set], output_dir=out,
            global_batch_size=TRAIN_BATCH, log_steps=1, save_steps=100, peft=peft, train=train_config, seed=SEED,
            device=device, max_steps=1))
        reset_launches()
        bseen = []
        with counted_plain(gdr, "chunk_gated_delta_rule_backward_plain") as plain_calls:
            bapp.train(on_step=lambda step, m: bseen.append(float(m["loss"])))
        torch.cuda.synchronize()
        bi_launches = launch_counts()
        bapp.close()
    if len(bseen) != 1 or not np.isfinite(bseen[0]) or plain_calls[0] or \
            bi_launches["gated_delta_rule_bwd"] != per_step:
        raise AssertionError(f"BiQwen3_5 LoRA step: loss {bseen}, launches {bi_launches}, plain calls {plain_calls[0]}; "
                             f"expected {per_step} Q2 backward launches")
    log(f"  [{time.perf_counter() - t_phase:.0f} s] BiQwen3_5 at the same widths and depth, one LoRA step through "
        f"ColModelTraining (BiEncoderLoss): loss {bseen[0]:.4f}; Q2 backward {bi_launches['gated_delta_rule_bwd']}")
    extra["biqwen3_5"] = dict(loss=bseen[0], launches=bi_launches)
    del bmodel, bapp
    torch.cuda.empty_cache()
    extra["seconds"] = time.perf_counter() - t_phase
    log(f"phase qwen3.5 training: {extra['seconds']:.1f} s")
    launches = dict(gated_delta_rule_bwd=train_launches["gated_delta_rule_bwd"],
                    gated_delta_rule=train_launches["gated_delta_rule"],
                    flash_attention=train_launches["flash_attention"] + eval_launches["flash_attention"],
                    maxsim_bf16=eval_launches["maxsim_bf16"], quantize_rows=quant_launches["quantize_rows"],
                    int8_gemm=quant_launches["int8_gemm"])
    return launches, q2_bwd, extra


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script only runs on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    seconds = {}
    t_start = time.perf_counter()

    def timed(name: str, fn, *args):
        """``fn(*args)``, its seconds logged and kept under ``name``."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"[{name}: {seconds[name]:.1f} s, {time.perf_counter() - t_start:.1f} s since the start]")
        return out

    smi = timed("1 device", phase_device)
    timings, corpora = timed("2 kernels", phase_kernels, device)
    ops_launches, ops = timed("6 ops entry points", phase_ops, device, *corpora)
    del corpora
    torch.cuda.empty_cache()
    timings.update(ops)
    model, processor, encoder = timed("3 build ColPali-3B", build_model, device)
    text_launches = timed("3 text slice", phase_slice, device, encoder)
    launches, k6, page, extra, (bf16_launches, timings["gather_rerank_bf16"]) = timed(
        "4 page slice", phase_pages, device, model, processor, encoder)
    del encoder
    train_slice, train_steps, k6_bwd, eval_index, train_extra = timed("5 training", phase_training, device, model,
                                                                      processor, smi)
    with tempfile.TemporaryDirectory() as colpali_dir:  # phase 7's ColPali-3B checkpoint, which phase 18 reads
        quant_launches, quant_timings, quant_extra = timed("7 stored int8", phase_stored_int8, device, model,
                                                           processor, smi, colpali_dir)
        pool_launches, pool_timings, pool_extra = timed("18 pooled ingestion", phase_pooling, device, model,
                                                        processor, smi, colpali_dir)
    timings.update(quant_timings)
    del model, processor
    free_memory("phase qwen")
    with tempfile.TemporaryDirectory() as qwen_dir:  # phase 8's ColQwen2.5-3B checkpoint, which phase 9 trains
        qwen_launches, qwen_timings, qwen_extra = timed("8 Qwen2-VL family", phase_qwen, device, smi, qwen_dir)
        free_memory("phase qwen training")
        qt_launches, qt_bwd, qt_extra = timed("9 Qwen training", phase_qwen_training, device, smi, qwen_dir)
    smol_launches, smol_timings, smol_extra = timed("10 colSmol", phase_colsmol, device, smi)
    st_launches, st_bwd, st_extra = timed("11 colSmol training", phase_smol_training, device, smi)
    with tempfile.TemporaryDirectory() as gemma_dir:  # phase 12's Gemma3-4B checkpoint, which phase 13 trains
        gemma_launches, gemma_timings, gemma_extra = timed("12 Gemma3 family", phase_gemma3, device, smi, gemma_dir)
        gt_launches, gt_extra = timed("13 Gemma3 training", phase_gemma3_training, device, smi, gemma_dir)
    with tempfile.TemporaryDirectory() as qwen3_dir:  # phase 14's Qwen3-VL-4B checkpoint, which phase 15 trains
        qwen3_launches, qwen3_timings, qwen3_extra = timed("14 Qwen3-VL family", phase_qwen3, device, smi, qwen3_dir)
        q3t_launches, q3t_bwd, q3t_extra = timed("15 Qwen3-VL training", phase_qwen3_training, device, smi, qwen3_dir)
    with tempfile.TemporaryDirectory() as mvb_dir:  # phase 16's ModernVBERT-base checkpoint, which phase 17 trains
        mvb_launches, mvb_timings, mvb_extra = timed("16 ModernVBert family", phase_modernvbert, device, smi, mvb_dir)
        mt_launches, mt_extra = timed("17 ModernVBert training", phase_modernvbert_training, device, smi, mvb_dir)
    free_memory("phase qwen3.5")
    with tempfile.TemporaryDirectory() as q35_dir:  # phase 19's checkpoint
        q35_launches, q35_timings, q35_extra = timed("19 Qwen3.5 family", phase_qwen35, device, smi, q35_dir)
    free_memory("phase qwen3.5 training")
    with tempfile.TemporaryDirectory() as q35t_dir:  # phase 20's checkpoint, the decoder cut to QWEN35_TRAIN_DEPTH
        q35t_launches, q2_bwd, q35t_extra = timed("20 Qwen3.5 training", phase_qwen35_training, device, smi,
                                                  q35t_dir)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    timings["flash_attention"] = dict(k6["siglip"], gemma_page=k6["gemma_page"], gemma_query=k6["gemma_query"])
    timings["flash_attention_bwd"] = dict(k6_bwd["gemma_page"], gemma_query=k6_bwd["gemma_query"],
                                          gemma_query_padded=k6_bwd["gemma_query_padded"], siglip=k6_bwd["siglip"])
    for name, r in page.items():
        timings[name]["full_page"] = dict(r, shape=f"Np={PAGE_DOC_TOKENS}")
    for name, r in eval_index.items():
        timings[name]["eval_index"] = r
    kernels = []
    for name, spec in KERNELS.items():
        entry = dict(name=name, route=spec["route"], source=spec["source"], replaces=spec["replaces"])
        if name in SERVING_KERNELS:  # its launches over the page slice, and over the text slice
            entry.update(launches=launches[name], launches_text_slice=text_launches[name])
        if name in TRAINING_KERNELS:  # over the training slice: the 4 steps and the eval (comparisons not counted)
            entry["launches_training_slice"] = train_slice[name]
            entry.setdefault("launches", train_slice[name])
        if name == "maxsim_int8_bf16":  # on no slice's path: counted over its own search of an int8 index (phase 5)
            entry.update(launches=train_extra["int8_search_launches"], launches_training_slice=0,
                         launches_over="CorpusIndex.search, int8 index with quantize_queries=False, apart from the "
                                       "training slice")
        if name in OPS_KERNELS:  # over phase 6's calls of the ops entry points
            entry.update(launches=ops_launches[name], launches_over="the ops entry points, phase 6")
        if name == "gather_rerank_bf16":  # over the bf16 page index's searches, phase 4
            entry.update(launches=bf16_launches[name], launches_over="CorpusIndex.search on a bf16 two-tier index of "
                                                                     "the pages, one query a search")
        if name in QUANT_KERNELS:  # over phase 7's path: /search_text and 32 pages through the stored-int8 model
            entry.update(launches=quant_launches[name], launches_over="load_retriever(quantize=True): /search_text "
                                                                      "through make_handler and 32 pages embedded")
        if name in train_steps:
            entry["launches_train_steps"] = train_steps[name]
        if name in qwen_launches:  # over phase 8's path: ColQwen2.5-3B's pages, /search_text and serve.py
            entry["launches_qwen_slice"] = qwen_launches[name]
        if name in qwen_timings:
            entry["qwen"] = qwen_timings[name]
        if name in qt_launches:  # over phase 9's path: ColQwen2.5-3B's LoRA steps, eval and quantized-base steps
            entry["launches_qwen_training"] = qt_launches[name]
        if name == "flash_attention_bwd":  # phase 9: by head dim over the LoRA steps, and at the family's shapes
            entry.update(launches_qwen_training_by_head_dim=qt_extra["launches_by_head_dim"], qwen_training=qt_bwd)
        if name in smol_launches:  # over phase 10's path: colSmol-256M's pages, /search_text and serve.py
            entry["launches_colsmol_slice"] = smol_launches[name]
        if name == "flash_attention":  # phase 10's K6 launches by head dim (D=64 alone) and its D=64 cases
            entry.update(launches_colsmol_by_head_dim=smol_extra["launches_by_head_dim"],
                         colsmol_d64=smol_timings["flash_attention"])
        elif name in smol_timings:
            entry["colsmol"] = smol_timings[name]
        if name in st_launches:  # over phase 11's path: colSmol-256M's LoRA steps, eval and quantized-base step
            entry["launches_colsmol_training"] = st_launches[name]
        if name == "flash_attention_bwd":  # phase 11: by head dim over the LoRA steps (D=64), and its D=64 cases
            entry.update(launches_colsmol_training_by_head_dim=st_extra["launches_by_head_dim"],
                         colsmol_training_d64=st_bwd)
        if name in gemma_launches:  # over phase 12's path: Gemma3-4B's pages, /search_text and serve.py
            entry["launches_gemma3_slice"] = gemma_launches[name]
        if name == "flash_attention":  # phase 12's K6 launches by head dim (D=72 alone) and its vision case
            entry.update(launches_gemma3_by_head_dim=gemma_extra["launches_by_head_dim"],
                         gemma3_vision=gemma_timings["flash_attention"])
        elif name in gemma_timings:
            entry["gemma3"] = gemma_timings[name]
        if name in gt_launches:  # over phase 13's path: Gemma3-4B's LoRA steps, eval and quantized-base step
            entry["launches_gemma3_training"] = gt_launches[name]
        if name in qwen3_launches:  # over phase 14's path: Qwen3-VL-4B's pages, /search_text and serve.py
            entry["launches_qwen3_slice"] = qwen3_launches[name]
        if name == "flash_attention":  # phase 14's K6 launches by head dim (D=72 and D=128) and its cases
            entry.update(launches_qwen3_by_head_dim=qwen3_extra["launches_by_head_dim"],
                         qwen3=qwen3_timings["flash_attention"])
        elif name in qwen3_timings:  # Q1a/Q1b at its widths; K3 and K10 at D=320
            entry["qwen3"] = qwen3_timings[name]
        if name in q3t_launches:  # over phase 15's path: Qwen3-VL-4B's LoRA steps, eval and quantized-base step
            entry["launches_qwen3_training"] = q3t_launches[name]
        if name == "flash_attention_bwd":  # phase 15: by head dim over the LoRA steps (D=128), and its cases
            entry.update(launches_qwen3_training_by_head_dim=q3t_extra["launches_by_head_dim"], qwen3_training=q3t_bwd)
        if name in mvb_launches:  # over phase 16's path: ModernVBERT-base's pages, /search_text and serve.py
            entry["launches_modernvbert_slice"] = mvb_launches[name]
        if name == "flash_attention":  # phase 16's K6 launches by head dim (D=64 alone; timed at this shape in phase 10)
            entry["launches_modernvbert_by_head_dim"] = mvb_extra["launches_by_head_dim"]
        elif name in mvb_timings:  # Q1a/Q1b at its widths
            entry["modernvbert"] = mvb_timings[name]
        if name in mt_launches:  # over phase 17's path: ModernVBERT-base's LoRA steps, eval and quantized-base step
            entry["launches_modernvbert_training"] = mt_launches[name]
        if name in pool_launches:  # over phase 18's path: pooled ingestion, embed_corpus, serve.py, compute_hardnegs
            entry["launches_pooling_slice"] = pool_launches[name]
        if name in pool_timings:  # K1-K3 at the pooled page length (Np = 352), K3 also over 1-token docs (Np = 16)
            entry["pooled"] = pool_timings[name]
        if name == "gated_delta_rule":  # Q2: over phase 19's path, and over phase 20's LoRA steps apart
            entry.update(launches=q35_launches[name], launches_over="phase 19: 64 pages embedded by the bf16 and the "
                                                                    "stored-int8 models, /search_text and serve.py")
            timings[name] = q35_timings[name]
        elif name == "gated_delta_rule_bwd":  # Q2's backward: over phase 20's LoRA steps alone
            entry.update(launches=q35t_launches[name], launches_over=f"phase 20: {QWEN35_TRAIN_STEPS} LoRA steps of "
                                                                     "ColQwen3_5 through ColModelTraining")
            timings[name] = dict(q2_bwd["page_bf16"], query=q2_bwd["query_bf16"])
        elif name in q35_launches:  # over phase 19's path: ColQwen3_5's pages, /search_text and serve.py
            entry["launches_qwen35_slice"] = q35_launches[name]
        if name in q35t_launches and name != "gated_delta_rule_bwd":  # over phase 20's LoRA steps, eval, int8 step
            entry["launches_qwen35_training"] = q35t_launches[name]
        if name == "flash_attention":  # phase 19's K6 launches by head dim (the Qwen3-VL-4B tower, D=72 alone)
            entry["launches_qwen35_by_head_dim"] = q35_extra["launches_by_head_dim"]
        elif name in ("quantize_rows", "int8_gemm"):  # Q1a/Q1b at the decoder's (M, K, N)
            entry["qwen35"] = q35_timings[name]
        kernels.append(dict(entry, **timings[name]))
    print(json.dumps({"kernels": kernels, "pages_per_min": extra["pages_per_min"],
                      "forward_check": extra["forward_check"], "page_profile": extra["page_profile"],
                      "training": train_extra, "stored_int8": quant_extra, "qwen": qwen_extra,
                      "qwen_training": qt_extra, "colsmol": smol_extra, "colsmol_training": st_extra,
                      "gemma3": gemma_extra, "gemma3_training": gt_extra, "qwen3": qwen3_extra,
                      "qwen3_training": q3t_extra, "modernvbert": mvb_extra, "modernvbert_training": mt_extra,
                      "pooling": pool_extra, "qwen3_5": q35_extra, "qwen3_5_training": q35t_extra,
                      "phase_seconds": seconds, "seconds": time.perf_counter() - t_start}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
