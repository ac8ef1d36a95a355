#!/usr/bin/env python3
"""On-card smoke run of vq_tpu_torch, the PyTorch / CUDA port of vq_tpu.

    python3 chip_smoke.py        # from the repo root, on a machine with one NVIDIA GPU

Phases, one line each (any failure exits non-zero with no result line):

1. device — the card's ``nvidia-smi`` name and power limit, TF32 off;
2. build — nvcc builds ``vq_tpu_torch/csrc`` for sm_90a under ``build/``;
3. kernels — K3, K4 and K5 each held to its plain PyTorch version on the
   card at the main path's shapes (1M x 128 corpus, 8x256x16 codebooks,
   128-query batches; K3 at 100k and 200k rows, sums, counts and inertia
   bit for bit and on a second run, its scan's minimum scores equal to
   the plain smin; K4 bit for bit with f32 and bf16 input; K5 at
   fetch 1, 10, 100 and 128 and on tie-heavy codes, bit for bit and on a
   second run);
4. main path — ``ProductQuantizer`` trained on 100k rows, ``PQIndex.add``
   of the 1M corpus, ``search(k=10)`` and ``search(k=10, rerank=100)``
   through the public entry points, with the launch counters of all three
   kernels checked, results held to the plain route on the same card and
   recall@10 against exact brute force;
5. ivf kernels — K1 (assign) at 1M x 1024 x 128 in f32 and bf16, held to
   its plain version on the card, and K2 (Lloyd accumulate) at 200k x
   1024 x 128 (IVF) and 200k x 256 x 128 (an RQ stage), held bit for bit
   to its plain version and to a second run;
6. ivf path — ``IVFPQIndex.train`` (IVF1024, PQ 8x256 on residuals) on
   200k rows, ``add`` of the 1M corpus, ``search(k=10)`` at nprobe 8 and
   64 with rerank 0 and 500, through the public entry points: launch
   counts of K1, K2, K3, K4 and K7 read from that run, lists, codes and
   search results held to the plain route (every kernel wrapper swapped
   for its plain version) on the same card, recall@10 against the exact
   ground truth; then K7 held to its plain version over the built
   index's probed chains at nprobe 8 and 64;
7. ivf-flat path — ``IVFFlatIndex.train`` (IVF1024) and
   ``IVFSQIndex.train`` (IVF1024, residual SQ8) on 200k rows, ``add`` of
   the 1M corpus to an f32, a bf16 and an SQ index (and a ``metric="dot"``
   f32 one), ``search(k=10)`` at nprobe 8 and 64 (the dot index at 8),
   the width of ``benchmarks/serving_bench.py``: launch counts of K1, K2
   and K6 read from that run, every search held to the plain route on
   the same card, recall@10 against the exact ground truth; then K6 held
   to its plain version on the operands each search gave it (f32, bf16
   and u8 payloads at nprobe 8 and 64), and its work list (which
   (pair, chain slot) entries read each chunk) to the plain version's;
8. lowp kernels — K4-bf16 and K4-bf16x3 (tensor cores) held to their
   plain versions at 1M x 128 against 8x256x16 with f32 and bf16 input by
   the near-tie rule (``cuda_kernels.encode_parity``: >= 0.9999 of the
   codes equal, every other one a float64 near tie), and bit for bit on
   small-integer operands at the same shapes;
9. pq precision — on the main phase's quantizer, ``PQIndex.add(corpus,
   precision="high")`` and ``(..., "default")`` and
   ``ProductQuantizer.adc_distances`` at [128, 1M]: launch counts of
   K4-bf16x3, K4-bf16 and K8 read from that run, codes held to the plain
   route by the near-tie rule, distances and each search (over the
   index's own codes) held to it bit for bit, code-match rates against the exact encode and
   recall@10 beside the exact index's; then K8 held to its plain version
   on those operands;
10. rq path — the width of ``benchmarks/serving_bench.py:186-204,
   327-351``: ``ResidualQuantizer`` 8x256 trained on 200k rows, ``RQIndex``
   ``add`` of 1M and ``search(k=10)`` (K5 l2), ``rerank=500`` (K8 over 4
   chunks), a ``metric="cosine"`` (K8) and a ``metric="dot"`` (K5 dot)
   index; ``IVFRQIndex.train`` (IVF1024, RQ 8x256, 200k rows), ``add`` of
   1M, ``search(k=10)`` at nprobe 8 and 64 (K7): launch counts of K1, K2,
   K5, K7 and K8 read from that run, codes and searches held to the plain
   route, recall@10 against the exact ground truth; then K8 held to its
   plain version on one RQ chunk (262,144 rows);
11. timings — CUDA events, kernel beside plain version (and, for K8, the
   one PyTorch call that computes the same function,
   ``embedding_bag``), each line stamped with the card's name and power
   limit, with K1's floor under its exact contract and a cuBLAS fp32
   product of its shape beside it; K3 at 100k and 200k rows and K4 at 1M
   with their floors under the same contract; K5 at fetch 1 to 128 and on
   tie-heavy codes, with its shared-memory lookup floor; K6 on each
   search's operands, with a ``[bound]`` line (the rows of the chunks its
   probe table names, read once, plus the output) and a
   ``torch.profiler`` line of its launches (memset, entry pass, scan,
   cursor, scatter, matvec); K2 at both
   shapes, with a
   ``torch.profiler`` line a shape of the device time of each of its
   stages, and its sums stage beside ``index_add_`` (one PyTorch call
   with float atomics, a yardstick the port never calls) and its bytes
   bound; K3 at 100k and 200k rows with a ``torch.profiler`` line of the
   device time of each of its launches (K4's scan, the labels and
   inertia partials, K2's sums stage, the inertia sum), and its sums
   stage beside its bytes bound and ``index_add_``; K7 at nprobe 8 and 64,
   each with its bound; K8 at [128, 1M] and on one RQ chunk beside
   ``embedding_bag``, and on codes that cost one shared-memory wavefront
   a phase, with its bytes bound at both shapes, its 4-byte lookup floor
   and its 16-byte design's floor counted on this run's codes
   (:func:`k8_wavefronts`); then a
   ``torch.profiler`` line a call of the PQ and IVF-PQ trainers,
   ``PQIndex.add``, the IVF adds, ``PQIndex.search``, the IVF-Flat,
   IVF-SQ and IVF-PQ searches (nprobe 8 and 64), and the precision and
   RQ paths (wall, device time, busy share, top kernels, K7's launches
   by stage, K8's share);
12. bench kernels — the benchmark twins' kernels on seeded uniform data
   made on the card (x [1M, 128], codebooks 8x256x16 through
   ``build_w``, tables [128, 8, 256], u8 codes [1M, 8] and their
   transpose): B1 ``"highest"`` on 100k rows bit-identical to its plain
   version, and on all 1M rows to K4; B1 ``"default"`` with f32 and
   bf16-resident operands held to its plain version by
   ``mpacked_encode.kernel_parity`` (>= 0.9999 of the codes equal, the
   rest float64 near ties), and its match against K4-bf16; B2 and B3 bit
   for bit against their plain versions and K8, B4 against its plain
   version; K2 with seeded weights at both of its shapes twice and
   against its weighted plain version, bit for bit. Then the twins' ``main()``
   (``vq_tpu_torch.benchmarks.mpacked_encode`` and ``.adc_vmem_bench``)
   run at their default sizes, the slice's main path: launch counts read
   from that run, every ``parity`` field true. Then timings: B1's three
   variants beside K4, K4-bf16 and K4-bf16x3 at 1M, and B2, B3, B4 beside
   K8 and ``embedding_bag`` at [128, 1M] (B3 also beside phase 11's K8 on
   codes that cost one wavefront a phase), with B2's design floor and the
   table bytes it reads a call, B3's shared-memory floor by its wavefront
   model (``adc_vmem_bench.gather_wavefronts``) beside K8's 16-byte
   design on the same codes, and B1's bounds, its "highest" floor
   under the no-FMA rule, its "default" plan (R, slots, ring) and the W
   bytes each body reads a call;
13. eval path — the four eval harnesses' ``main()``
   (``vq_tpu_torch.cli.eval_{bq,sq,pq,tsvq}``) at the reference grid's
   width, ``--sizes 1000000 --dim 384 --recall`` with every other flag
   at its default (seed 66, BQ threshold 0.5, SQ 256 levels, PQ 16x256
   with 10 iterations, TSVQ depth 5, euclidean): every row parsed, its
   ``mse`` and ``recall_at_k`` finite, K3's and K4's launch counts read
   from ``eval_pq``'s run (no kernel in the other three); K4 on all 1M
   rows and K3 on 100k of them, with ``eval_pq``'s own codebooks
   (16x256x24), bit for bit against their plain versions; BQ codes,
   uint32 words and a [128, 1M] Hamming block equal to the same functions
   on the CPU copies; TSVQ leaf ids of 100k rows on the card equal to the
   CPU run's except float near ties (printed and counted); the TSVQ
   device build at 200k x 384, depth 5, bit-identical to the same build
   on the CPU, and to the host recursion's tree except splits at float
   near ties (each printed with its two summed deviations). Then K3 and
   K4 timed at that shape beside their plain versions and floors, and a
   ``torch.profiler`` line a harness (one more ``main()`` each: wall,
   device time, busy share, top kernels);
14. flat serving path — on the phase-4 mixture: ``FlatIndex`` f32, bf16
   and f16 (squared L2, k=10) with recall@10 against the ground truth and
   the f32 ids equal to its own at separated ranks (values within
   ``FLAT_ATOL`` of its float64 distances); all five metrics at f32 over
   the 1M rows (Manhattan at its 8,192-row chunk) held to the same index
   searched on the CPU for ``FLAT_CPU_QUERIES`` queries; ``range_search``
   at the median 10th distance (hits within it, the prefix of search,
   counts bracketed by the CPU's at the radius +- the tolerance);
   ``range_search`` of PQ (phase 4's codes) and RQ (phase 10's indexes),
   squared L2 and cosine, K8's launches read from that run and every
   result bit for bit the plain route's, and ``_search_core``'s ``fn``
   equal to ``search``; ``SQIndex`` SQ8 (k=10, rerank 100 from the kept
   corpus, dot) and ``BinaryIndex`` (k=10, rerank 500) with recall@10 and
   CPU checks (the [8, 1M] Hamming counts bit for bit); ``knn_graph`` over
   the first 100k rows (k=10, query_batch 1024), 256 sampled rows held to
   ``FlatIndex.search(k=11)`` less the self-match; CUDA-event times of
   each search and a ``torch.profiler`` line for the f32 ``FlatIndex``,
   ``SQIndex`` and ``BinaryIndex`` searches and ``knn_graph`` (with the
   share of the top-k merges' sort kernels).
15. mips and opq path — on the phase-4 mixture, the exact dot top-10 of
   ``FlatIndex(metric="dot")`` as the ground truth: ``AnisotropicProductQuantizer``
   8x256 on the first 100k rows (score threshold 0.2, five refine
   rounds), ``encode`` of the 1M rows and ``mips_search(k=10)`` (K5 in
   mode ``"dot"``); ``IVFPQIndex.train(metric="dot")`` (IVF1024,
   anisotropic PQ on the raw rows) on 200k rows, ``add`` of 1M,
   ``search`` at nprobe 8 / 64 and rerank 0 / 500 (K7 over negated dot
   tables), and one ``by_residual=True`` dot index at nprobe 8 (K7, then
   the ``q.c`` offset); ``OPQQuantizer`` 8x256 on 200k rows (6 rounds x 3
   Lloyd iterations, the width of ``docs/performance.md:35``) with its MSE
   beside plain PQ's, ``encode`` of 1M and ``adc_search(k=10)`` (K5
   ``"sum"``). Launch counts of K1, K2, K3, K4, K5 and K7 read from that
   run; training, codes and searches held to the plain route bit for bit
   (lists by the float64 near-tie rule); K5 ``"dot"`` and K7 held to
   their plain versions on the searches' operands; the refine the same
   bits twice; recall@10; CUDA-event times beside the plain route and a
   ``torch.profiler`` line for the refine, the 1M encode,
   ``mips_search``, the dot IVF searches and ``opq_train``.
16. maintenance — IVF-Flat and IVF-PQ at IVF1024 rebalanced, edited by
   ``remove_ids`` / ``merge_from`` and ranged, and ``IVFBinaryIndex``
   (:func:`phase_maintenance`).
17. the layer around the indexes — ``Kmeans`` (k 1024, 20 iterations, 2
   restarts on a 262,144-row sample of the 1M rows), the faiss
   ``PCA64,IVF1024,PQ8`` as a ``TransformedIndex``, ``RefineIndex`` with
   the flat, SQ8 and residual PQ 8x256 refiners over IVF1024 / PQ 8x256,
   ``itq_train`` ahead of a 64-bit ``BinaryIndex``, ``BatchPipeline`` /
   ``pipelined_search`` over IVF-Flat (K6), a refine index (K7) and the
   ``PQIndex`` (K5) on 8 batches of 128 further queries of the mixture,
   ``load_index`` round trips, and a stale pipeline raising after
   ``rebalance()``: launch counts of K1-K7 from that run, every result held
   to the plain route bit for bit (:func:`phase_transforms_refine_serving`).
18. the last single-device modules — ``GraphIndex.build`` of the 1M rows
   at its defaults (IVF-assisted candidates: K1, K2, K6; each stage by CUDA
   events, the regime warning if it fires), ``search(k=10)`` at beam 16 /
   32 / 64 against the CPU's search of the same graph, the same build at
   50k rows on the plain route bit for bit and K6 on the sweep's
   operands, ``add`` / ``remove_ids`` of 10k rows; ``lloyd_stepped`` (k
   1024, 200k rows, 20 iterations) resumed from its checkpoint at 10 bit
   for bit; ``lloyd_minibatch`` (K2) and ``pq_minibatch_update`` (K3)
   over one epoch of the 1M rows, against the plain route; seven
   ``index_factory`` pipelines and ``tune`` over two
   (:func:`phase_last_modules`);
19. sharded — ``vq_tpu_torch.parallel`` in a world of one on NCCL:
   ``sharded_pq_train`` 8x256 on the 1M rows, ``sharded_lloyd`` k 1024
   on 200k, ``sharded_pq_encode`` of 1M, ``sharded_pq_minibatch_update``
   over one epoch of 8192-row batches, ``sharded_opq_train`` on 200k and
   ``sharded_flat_search`` over the 1M ``PQIndex``, ``RQIndex``,
   ``FlatIndex`` and ``SQIndex``: launch counts of K2-K5 from that run,
   each result held to its single-device counterpart bit for bit
   (``overlap=False``) or within 1e-5 (the overlap's steps); the 2-rank
   gloo dry run on this card (with the serving checks of the dry run)
   held to the world of one; CUDA-event times of a sharded Lloyd step,
   its ``all_reduce`` and the sharded search (:func:`phase_sharded`);
20. sharded serving — in the same world of one: ``sharded_ivf_search``
   over the 1M IVF-PQ (K7) and ``sharded_ivf_scan_search`` over the 1M
   IVF-Flat f32 / bf16 and IVF-SQ (K6), IVF-RQ (K7) and a 1M
   ``IVFBinaryIndex`` at nprobe 8 / 64, ``sharded_graph_search`` over
   phase 18's graph at beam 16 / 64, ``sharded_refine_search`` over a
   sharded IVF-PQ base with sq8 codes (its ``BatchPipeline.from_core``
   over 8 batches) and over a flat ``PQIndex`` base (K5), and the
   IVF-Flat searched again after a ``remove_ids`` of 1,000 rows: launch
   counts of K5-K7 from that run, every result bit for bit its
   single-device search, CUDA-event times beside the single-device ones
   (:func:`phase_sharded_serving`).

Before the last line it prints a JSON line of per-kernel results (each
with its launches on its path, its error against the plain version, its
time, the plain version's, the least time the card could take for the
same work at its shapes — bytes over 3.35 TB/s or operations over the
67 TFLOP/s fp32 / 989 TFLOP/s bf16 peak, whichever is larger — and a
library call's time where one exists) and the ``nvidia-smi`` line; the last line is the run's verdict,
``{"ok": true, "device": {...}}``. The data is a seeded Gaussian mixture
made on the card; the weights are trained from it. Every kernel row with
more than one path carries ``launches_by_path``: each path's launches in its
own phase's run.
"""

from __future__ import annotations

import contextlib
import importlib
import io
import json
import subprocess
import sys
import time

from vq_tpu_torch.benchmarks import cuda_ms  # CUDA-event ms a call, after one warm-up

N_CORPUS, DIM, N_QUERY = 1_000_000, 128, 128
N_TRAIN, M, K = 100_000, 8, 256
N_CLUSTERS, LATENT, SEED = 1024, 24, 0
# K3 (K4's scan, then K2's sums stage over the [n*m, s] view: one
# segmented order shared with the plain version): bit-identical.
# K1's distances where its codes agree: within 1e-5 of the largest.
K1_DIST_RTOL = 1e-5
# K1, B1 "default", K4-bf16 and K4-bf16x3: a code may differ from the
# plain version's only where the two candidates' scores, recomputed in
# float64, are near ties (``mpacked_encode.near_ties``,
# ``cuda_kernels.encode_near_ties``: TIE_RTOL relative gap). K4 (the
# register-tiled scan of csrc/pq_encode.cu, the plain version's order, no
# FMA) is held bit for bit; its floor, like K1's, is 2 n m k s FP32
# instructions over the card's instruction rate.
# IVF path, the width of the repo's IVF benchmark (benchmarks/ivf_bench.py).
NLIST, N_IVF_TRAIN, NPROBES, RERANKS = 1024, 200_000, (8, 64), (0, 500)
# K1 (csrc/assign.cu: 8 x 8 register tiles, x resident in shared memory,
# a cp.async ring of centroid slices) sums each dot in the plain version's
# order with no FMA, so it is bit-identical by design: the phase counts the
# codes and distances that differ (0 expected) and still holds any code to
# a float64-verified near tie, the distance to 1e-5 where codes agree. Its
# floor under that contract is 2 n k d FP32 instructions over the card's
# instruction rate (SMs x 128 lanes x max SM clock), not the FMA-counted bound.
# K2 (kernel and plain version share one segmented summation order), K6
# and K7: bit-identical.
# IVF-Flat / IVF-SQ searches, the width of benchmarks/serving_bench.py.
FLAT_KINDS, FLAT_MIN_RECALL = ("flat_f32", "flat_bf16", "sq"), 0.9
# RQ path, the width of benchmarks/serving_bench.py:186-204 (RQIndex 8x256
# greedy over 1M x 128) and :327-351 (IVF-RQ); K8's chunk of the RQ scan.
RQ_STAGES, RQ_ITERS, RQ_RERANK, RQ_CHUNK = 8, 8, 500, 262_144
# The benchmark twins' kernels: B1 held to its plain version on the
# scripts' 100k parity rows (``mpacked_encode.kernel_parity``).
B1_ROWS = 100_000
# Phase 13, the eval harnesses at the reference grid's width: 1M x 384
# rows; K3 held on 100k of them; 128 Hamming queries; TSVQ's builds on 200k
# rows and its encode on 100k; a TSVQ near tie is a float64 gap within
# 1e-5 of the larger distance (or summed deviation).
EVAL_ROWS, EVAL_DIM, EVAL_K3_ROWS, EVAL_QUERIES = 1_000_000, 384, 100_000, 128
EVAL_TSVQ_ROWS, EVAL_TSVQ_ENCODE, TSVQ_TIE_RTOL = 200_000, 100_000, 1e-5
PQ_EVAL = (16, 256, 24)  # eval_pq's default codebooks on dim 384
# Phase 14, the flat serving layer on the phase-4 mixture. The card's
# searches are held to the same indexes searched on the CPU for
# FLAT_CPU_QUERIES queries: values within FLAT_RTOL relative plus the
# metric's FLAT_ATOL (the two devices' products and sums add in their own
# f32 orders; squared distances, Manhattan sums and scores run to ~10^3
# here), ids equal at every rank whose value is farther than that from
# every other value of its row. The f32 FlatIndex is held the same way to
# the exact float64 distances of the ground truth's ids.
FLAT_STORAGES, FLAT_CPU_QUERIES, FLAT_MIN_RECALL_EXACT = ("float32", "bfloat16", "float16"), 8, 0.999
FLAT_METRICS = ("squared_euclidean", "euclidean", "cosine", "dot", "manhattan")
FLAT_RTOL = 1e-5
FLAT_ATOL = {"squared_euclidean": 2e-2, "euclidean": 1e-3, "cosine": 1e-5, "dot": 2e-2,
             "manhattan": 5e-3}
SQ_RERANK, BQ_RERANK = 100, 500
KNN_ROWS, KNN_K, KNN_BATCH, KNN_SAMPLE = 100_000, 10, 1024, 256
# Phase 15, score-aware PQ (the JAX package's default threshold and
# refine rounds) and OPQ at the width of docs/performance.md:35.
ANISO_THRESHOLD, ANISO_REFINE = 0.2, 5
OPQ_ROWS, OPQ_ITERS, OPQ_PQ_ITERS = 200_000, 6, 3
# Phase 17, the layer around the indexes: Kmeans (faiss's defaults but
# k, niter and nredo: 256 points a centroid, so a 262,144-row sample),
# PCA64 ahead of IVF1024 / PQ 8x256 (the faiss spec "PCA64,IVF1024,PQ8"),
# RefineIndex at k_factor 4 over IVF1024 / PQ 8x256, ITQ to 64 bits, and
# pipelined serving of 8 batches of 128 queries.
KM_K, KM_ITERS, KM_REDO, PCA_OUT, ITQ_BITS, K_FACTOR = 1024, 20, 2, 64, 64, 4
N_PIPE_QUERIES, PIPE_BATCH = 1024, 128
# Phase 18, the last single-device modules. GraphIndex over the 1M rows at
# its defaults (degree 32, alpha 1.2, exact_threshold 200,000: the
# IVF-assisted candidates), searched at three beams and against the CPU
# for GRAPH_CPU_QUERIES queries; its build on the plain route at
# GRAPH_PLAIN_ROWS rows above GRAPH_PLAIN_THRESHOLD; an add and a remove of
# GRAPH_EDIT rows. lloyd_stepped at k 1024 on the 200k training rows for
# KS_ITERS iterations, resumed from a checkpoint at KS_CHECKPOINT;
# lloyd_minibatch and pq_minibatch_update (k 1024; 8x256x16) over one
# epoch of the 1M rows in batches of MB_BATCH; index_factory pipelines
# (trained on the 200k rows, 1M added; HNSW32 builds over the 1M rows,
# since adding 1M rows to a graph is 1M beam searches); tune to
# TUNE_TARGET over two of them.
GRAPH_DEGREE, GRAPH_EXACT_THRESHOLD = 32, 200_000  # GraphIndex.build's defaults
GRAPH_BEAMS, GRAPH_CPU_QUERIES = (16, 32, 64), 8
GRAPH_PLAIN_ROWS, GRAPH_PLAIN_THRESHOLD, GRAPH_EDIT = 50_000, 20_000, 10_000
KS_ITERS, KS_CHECKPOINT, MB_K, MB_BATCH = 20, 10, 1024, 8192
FACTORY_SPECS = ("IVF1024,Flat", "IVF1024,PQ8", "OPQ8,PQ8", "HNSW32", "LSH64", "BIVF1024",
                 "IVF1024,PQ8,RFlat")
FACTORY_PLAIN = ("IVF1024,PQ8,RFlat",)  # also built on the plain route (K1-K4, K7)
TUNE_SPECS, TUNE_TARGET = ("IVF1024,Flat", "HNSW32"), 0.95
# tune's grid for the IVF index: the default less nprobe = nlist, a full
# scan whose [128, 1M x width] sort this phase need not hold.
TUNE_IVF_GRID = {"nprobe": [1, 2, 4, 8, 16, 32, 64, 128]}
SORT_KERNELS = ("Sort", "sort")  # the stable sorts of the top-k merges, by kernel name
# The H100's published peaks (SXM, 700 W): HBM bytes/s, fp32 on the CUDA
# cores and bf16 on the tensor cores, FLOP/s.
HBM_BPS, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# K2's kernels (csrc/lloyd.cu) by stage, as the profiler names them.
K2_STAGES = (("assign", "assign_kernel"), ("memset", "Memset"), ("histogram", "chunk_hist_kernel"),
             ("totals", "cluster_totals_kernel"), ("scan", "cluster_scan_kernel"),
             ("cursor", "chunk_cursor_kernel"), ("scatter", "chunk_scatter_kernel"),
             ("table", "segment_table_kernel"), ("sums", "segment_sum_kernel"),
             ("combine", "segment_combine_kernel"), ("inertia", "inertia_kernel"))
# K3's launches (csrc/pq_lloyd.cu), as the profiler names them: K4's scan,
# the labels and inertia partials, then K2's sums stage (lloyd.cu).
K3_STAGES = (("pq scan", "pq_scan_"), ("terms", "pq_terms_kernel")) + K2_STAGES[1:]
# K6's launches (csrc/ivf_matvec.cu): the work-list pass and the matvec.
K6_STAGES = (("memset", "Memset"), ("entry pass", "entry_pass_kernel"), ("scan", "bin_scan_kernel"),
             ("cursor", "bin_cursor_kernel"), ("scatter", "entry_scatter_kernel"),
             ("matvec", "chunk_matvec_kernel"))
# K7's launches (csrc/ivf_probe.cu): the pairs' bins, K6's work list over
# them (the quads), then the sums.
K7_STAGES = (("keys", "pair_key_kernel"),) + K6_STAGES[:-1] + (("sums", "ivf_probe_kernel"),)
# Every kernel wrapper the paths call, and the modules that call it.
KERNEL_CALLERS = (
    ("vq_tpu_torch.ops.kmeans", ("assign_fused", "lloyd_accumulate_fused",
                                 "pq_lloyd_accumulate_fused")),
    ("vq_tpu_torch.ops.kmeans_stepped", ("assign_fused", "lloyd_accumulate_fused")),
    ("vq_tpu_torch.ops.kmeans_stream", ("assign_fused", "lloyd_accumulate_fused",
                                        "pq_lloyd_accumulate_fused")),
    ("vq_tpu_torch.models.pq", ("pq_encode_fused", "adc_scan_topk_fused", "adc_lookup_fused")),
    ("vq_tpu_torch.models.rq", ("assign_fused",)),
    ("vq_tpu_torch.search", ("adc_scan_topk_fused",)),
    ("vq_tpu_torch.models.pq_anisotropic", ("adc_scan_topk_fused",)),
    ("vq_tpu_torch.ivf", ("ivf_probe_adc_fused",)),
    ("vq_tpu_torch.parallel.kmeans", ("lloyd_accumulate_fused", "pq_lloyd_accumulate_fused")),
    ("vq_tpu_torch.ivf_flat", ("ivf_probe_matvec_fused", "ivf_probe_adc_fused")),
    ("vq_tpu_torch.benchmarks.mpacked_encode", ("pq_encode_fused",)),
    ("vq_tpu_torch.benchmarks.adc_vmem_bench", ("adc_lookup_fused",)),
)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_once(fn):
    """``(result, ms)`` of one call by CUDA events (no warm-up)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def clocked(fn):
    """``(fn(), note)``: fn runs while ``nvidia-smi`` samples the SM clock,
    power draw and active clock-event reasons every 20 ms; the note gives
    their range over fn's run, so that a time taken below the card's
    maximum clock says so."""
    import datetime

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw,clocks_event_reasons.active",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)  # nvidia-smi's start-up
        t0 = datetime.datetime.now()
        out = fn()
        t1 = datetime.datetime.now()
    finally:
        proc.terminate()
        lines = proc.communicate(timeout=60)[0].splitlines()
    rows = []
    for line in lines:
        f = [s.strip() for s in line.split(",")]
        try:
            rows.append((datetime.datetime.strptime(f[0], "%Y/%m/%d %H:%M:%S.%f"),
                         float(f[1]), float(f[2]), f[3]))
        except (ValueError, IndexError):
            continue
    inside = [r for r in rows if t0 <= r[0] <= t1]
    if not inside:
        return out, "no clock sample inside the window"
    mhz = [r[1] for r in inside]
    return out, (f"SM clock {min(mhz):.0f}-{max(mhz):.0f} MHz, power up to "
                 f"{max(r[2] for r in inside):.0f} W, clock-event reasons "
                 f"{sorted({r[3] for r in inside})} ({len(inside)} samples)")


def all_kernels():
    from vq_tpu_torch.benchmarks import adc_vmem_bench as av
    from vq_tpu_torch.benchmarks import mpacked_encode as mp
    from vq_tpu_torch.ops import cuda_kernels as ck

    return (ck.assign_fused, ck.lloyd_accumulate_fused, ck.pq_lloyd_accumulate_fused,
            ck.pq_encode_fused, ck.adc_scan_topk_fused, ck.ivf_probe_adc_fused,
            ck.ivf_probe_matvec_fused, ck.adc_lookup_fused, mp.mpacked_encode, av.adc_kt,
            av.adc_gather, av.adc_floor)


def reset_counts():
    """Every launch count to 0 (K4's and B1's counts a precision too)."""
    from vq_tpu_torch.benchmarks import mpacked_encode as mp
    from vq_tpu_torch.ops import cuda_kernels as ck

    for fn in all_kernels():
        fn.launches = 0
    ck.pq_encode_fused.launches_by = dict.fromkeys(ck.ENCODE_PRECISIONS, 0)
    mp.mpacked_encode.launches_by = dict.fromkeys(mp.PRECISIONS, 0)


def read_counts():
    """The launch counts by wrapper, K4 and B1 split by precision."""
    from vq_tpu_torch.benchmarks import mpacked_encode as mp
    from vq_tpu_torch.ops import cuda_kernels as ck

    out = {fn.__name__: fn.launches for fn in all_kernels()}
    out.update({f"pq_encode_fused[{p}]": n for p, n in ck.pq_encode_fused.launches_by.items()})
    out.update({f"mpacked_encode[{p}]": n for p, n in mp.mpacked_encode.launches_by.items()})
    return out


def stage_times(events, table=None, calls: int = 1):
    """``{stage: (ms a call, launches a call)}`` of the kernels of ``table``
    (K2's stages by default) among the profiler's device events, over
    ``calls`` calls."""
    out = {}
    for e in events:
        for stage, key in table or K2_STAGES:
            if key in e.key:
                ms, n = out.get(stage, (0.0, 0))
                out[stage] = (ms + e.self_device_time_total / 1e3 / calls, n + e.count / calls)
    return out


def k2_shapes(kres):
    """K2's two shapes: ``{tag: centroids}`` for the 200k training rows."""
    return {f"{N_IVF_TRAIN} x {NLIST} x {DIM}": kres["cents"],
            f"{N_IVF_TRAIN} x {K} x {DIM}": kres["cents_rq"]}


def sm_rate():
    """``(SMs, max SM clock in MHz)`` of card 0, for the floors of K1 and K5."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count, mhz


def bound(nbytes: float, flops: float, peak: float):
    """``(ms, "bytes" or "operations")``: the least time the card could
    take, the larger of bytes over HBM bandwidth and operations over
    ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def plain_route():
    """The paths with every kernel wrapper swapped for its plain version
    (on the same card), for holding the paths' results to them; checks
    that no kernel launched meanwhile."""
    from vq_tpu_torch.ops import cuda_kernels as ck

    before = read_counts()
    saved = []
    for mod_name, names in KERNEL_CALLERS:
        mod = importlib.import_module(mod_name)
        for name in names:
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, getattr(ck, name.replace("_fused", "_plain")))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    assert read_counts() == before, "a kernel ran on the plain route"


@contextlib.contextmanager
def recording(mod_name: str, name: str):
    """Yields a list that gathers ``(args, kwargs)`` of every call of
    ``mod_name.name`` meanwhile (the call itself goes through)."""
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, name)
    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(mod, name, record)
    try:
        yield calls
    finally:
        setattr(mod, name, fn)


def make_data(device):
    """Seeded Gaussian mixture on the card -> (corpus, queries, generator,
    phase 17's ``N_PIPE_QUERIES`` queries).

    Each component's covariance is low-rank (rank LATENT) plus a small
    isotropic part, as embeddings tend to be; with isotropic components
    in 128-d, points of a cluster are all about equally far apart and
    nearest neighbours are noise."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED)
    n = N_CORPUS + N_QUERY
    centres = torch.randn(N_CLUSTERS, DIM, generator=g, device=device) * 4.0
    lab = torch.randint(0, N_CLUSTERS, (n,), generator=g, device=device)
    basis = torch.randn(LATENT, DIM, generator=g, device=device) * (2.0 / LATENT ** 0.5)
    pts = (centres[lab]
           + torch.randn(n, LATENT, generator=g, device=device) @ basis
           + 0.1 * torch.randn(n, DIM, generator=g, device=device))
    # Phase 17's query batches: the same mixture, drawn from a generator of
    # their own so that the draws of every earlier phase stay as they were.
    gp = torch.Generator(device=device).manual_seed(SEED + 1)
    lab = torch.randint(0, N_CLUSTERS, (N_PIPE_QUERIES,), generator=gp, device=device)
    pipe = (centres[lab]
            + torch.randn(N_PIPE_QUERIES, LATENT, generator=gp, device=device) @ basis
            + 0.1 * torch.randn(N_PIPE_QUERIES, DIM, generator=gp, device=device))
    return pts[:N_CORPUS].contiguous(), pts[N_CORPUS:].contiguous(), g, pipe.contiguous()


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0].strip()
    import vq_tpu_torch  # noqa: F401  (sets TF32 off)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", f"{smi} | torch.cuda: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    backend = vq_tpu_torch.get_backend()
    log("device", f"vq_tpu_torch.get_backend(): {backend}")
    assert backend == f"CUDA ({torch.cuda.get_device_name(0)})", backend
    # The native C++ oracle (g++ on first use) against the port's CPU route.
    from vq_tpu_torch import native

    g = torch.Generator().manual_seed(SEED)
    x, cb = torch.randn(10_000, DIM, generator=g), torch.randn(M, K, DIM // M, generator=g)
    t0 = time.perf_counter()
    codes = native.pq_encode(x.numpy(), cb.numpy())
    secs = time.perf_counter() - t0
    assert (codes == vq_tpu_torch.pq_encode(x, cb, "squared_euclidean").numpy()).all(), \
        "native pq_encode differs from the port's CPU route"
    log("device", f"vq_tpu_torch.native ({native.get_native_backend()}): pq_encode of 10,000 x "
        f"{DIM} rows ({M}x{K}x{DIM // M}) equals the port's CPU route, {secs:.2f} s with its build")
    return smi


def phase_build():
    from vq_tpu_torch.ops._build import LIBRARY

    t0 = time.perf_counter()
    LIBRARY.get()
    secs = time.perf_counter() - t0
    for line in LIBRARY.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("build", "ptxas: " + line.strip())
    log("build", f"{secs:.2f} s (library {LIBRARY.path})")
    return secs


def _near_ties(x, cents, got, want):
    """``(rows, max gap)``: the rows where two assignments differ and their
    largest float64 score gap; fails unless every one is a near tie (one
    block of ``k`` columns, ``W = -2 c^T``)."""
    from vq_tpu_torch.benchmarks.mpacked_encode import near_ties

    cd = cents.double()
    flips, gap, ties = near_ties(x, -2.0 * cents.float().T, (cd * cd).sum(-1), got[:, None],
                                 want[:, None], "highest")
    assert ties, f"{flips} differing codes are not near ties"
    return flips, gap


def _k4_check(x, cb, tag):
    """K4 against its plain version, bit for bit."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    got = ck.pq_encode_fused(x, cb)
    torch.cuda.synchronize()
    want = ck.pq_encode_plain(x, cb)
    assert torch.equal(got, want), (
        f"K4 {tag}: {int((got != want).sum())} codes differ from the plain version")
    plan = ck.pq_scan_plan(x.shape[0], *cb.shape)
    log("kernels", f"K4 pq_encode {tag} {tuple(x.shape)} vs 8x256x16: {got.numel()} codes "
        f"bit-identical to the plain version (scan plan {plan})")
    return got


def phase_kernels(corpus, queries, g):
    import torch

    from vq_tpu_torch.models.pq import _adc_tables
    from vq_tpu_torch.ops import cuda_kernels as ck
    from vq_tpu_torch.ops.distance import Metric
    from vq_tpu_torch.ops.packing import pack_codes

    dev = corpus.device
    s = DIM // M
    pick = torch.randperm(N_CORPUS, generator=g, device=dev)[:K]
    cb = corpus[pick].reshape(K, M, s).permute(1, 0, 2).contiguous()  # [m, k, s]
    res = {"cb": cb}

    codes = _k4_check(corpus, cb, "f32")
    _k4_check(corpus.to(torch.bfloat16), cb, "bf16")
    res["k4_err"] = 0.0

    for n3 in (N_TRAIN, N_IVF_TRAIN):
        x3 = corpus[:n3]
        got = ck.pq_lloyd_accumulate_fused(x3, cb)
        again = ck.pq_lloyd_accumulate_fused(x3, cb)
        minval = ck._pq_lloyd_card(x3, cb)[3]
        torch.cuda.synchronize()
        want = ck.pq_lloyd_accumulate_plain(x3, cb)
        diffs = [int((a != b).sum()) for a, b in zip(got, want)]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (
            f"K3 {n3}: {diffs} sums / counts / inertia differ from the plain version")
        assert all(torch.equal(a, b) for a, b in zip(got, again)), (
            f"K3 {n3} is not deterministic from run to run")
        assert int(got[1].sum()) == n3 * M
        smin = ck._pq_scan_plain(x3, cb)[1]
        assert torch.equal(minval.view(torch.int32), smin.view(torch.int32)), (
            f"K3 {n3}: the scan's minimum scores differ from the plain smin")
        log("kernels", f"K3 pq_lloyd_accumulate {tuple(x3.shape)} vs {M}x{K}x{s}: sums, counts and "
            f"inertia ({float(got[2]):.9g}) bit-identical to the plain version and on a second run, "
            f"minimum scores equal to the plain smin (codewords: largest {int(got[1].max())} rows, "
            f"empty {int((got[1] == 0).sum())})")
    res["k3_err"] = 0.0

    codes_t = codes.to(torch.uint8).T.contiguous()
    tables = _adc_tables(queries, cb, Metric.SQUARED_EUCLIDEAN)
    cb16 = cb[:, :16].contiguous()
    codes16 = pack_codes(ck.pq_encode_fused(corpus, cb16), 4).T.contiguous()
    tables16 = _adc_tables(queries, cb16, Metric.SQUARED_EUCLIDEAN)
    # Tie-heavy: codes from 4 values a subspace and integer tables in
    # [0, 3), so a tile's 2048 sums take at most 17 values.
    tied_t = torch.randint(0, 4, (M, N_CORPUS), generator=g, device=dev, dtype=torch.uint8)
    tied_tab = torch.randint(0, 3, (N_QUERY, M, K), generator=g, device=dev).float()
    cases = [
        ("u8 8x256 fetch=10", tables, codes_t, 10, {}),
        ("u8 8x256 fetch=100", tables, codes_t, 100, {}),
        ("u8 8x256 fetch=1", tables, codes_t, 1, {}),
        ("u8 8x256 fetch=128", tables, codes_t, 128, {}),
        ("tie-heavy u8 8x256 fetch=10", tied_tab, tied_t, 10, {}),
        ("tie-heavy u8 8x256 fetch=100", tied_tab, tied_t, 100, {}),
        ("4-bit 8x16 fetch=10", tables16, codes16, 10, {"pack_bits": 4}),
    ]
    small = min(50_000, N_CORPUS)
    qn2 = (queries[:16] * queries[:16]).sum(-1)
    off = torch.rand(small, generator=g, device=dev) * 10
    cases += [
        ("l2 mode small", tables[:16], codes_t[:, :small], 10,
         {"mode": "l2", "qn2": qn2, "offsets": off}),
        ("dot mode small", tables[:16], codes_t[:, :small], 10, {"mode": "dot"}),
    ]
    err5 = 0.0
    for name, tab, ct, fetch, kw in cases:
        v, i = ck.adc_scan_topk_fused(tab, ct, fetch, **kw)
        v2, i2 = ck.adc_scan_topk_fused(tab, ct, fetch, **kw)
        torch.cuda.synchronize()
        pv, pidx = ck.adc_scan_topk_plain(tab, ct, fetch, **kw)
        fin = torch.isfinite(pv)
        err5 = max(err5, float(torch.where(fin, (v - pv).abs(), 0.0).max()))
        assert torch.equal(i, pidx), f"K5 {name}: ids differ"
        assert torch.equal(v, pv), f"K5 {name}: values differ"
        assert torch.equal(i2, i) and torch.equal(v2, v), f"K5 {name}: a second run differs"
        hits = int((pidx >= 0).sum())
        log("kernels", f"K5 adc_scan_topk {name} Q={tab.shape[0]} n={ct.shape[1]}: "
            f"values and ids bit-identical ({hits} candidates), and on a second run")
    res.update(codes_t=codes_t, tables=tables, k5_err=err5, k5_tied=(tied_tab, tied_t))
    return res


def _recall(ids, gt):
    hits = (ids[:, :, None] == gt[:, None, :]).any(-1).float().sum(-1)
    return float((hits / gt.shape[1]).mean())


def _ground_truth(corpus, queries, k=10, chunk=100_000):
    import torch

    best_d = best_i = None
    qq = (queries * queries).sum(-1, keepdim=True)
    for c0 in range(0, corpus.shape[0], chunk):
        x = corpus[c0:c0 + chunk]
        d = qq + (x * x).sum(-1)[None] - 2.0 * torch.matmul(queries, x.T)
        i = torch.arange(c0, c0 + x.shape[0], device=x.device).expand_as(d)
        if best_d is not None:
            d, i = torch.cat([best_d, d], 1), torch.cat([best_i, i], 1)
        best_d, pos = torch.topk(d, k, dim=1, largest=False)
        best_i = torch.gather(i, 1, pos)
    return best_i


def _parity(got, want, name):
    import torch

    gi, gd = got
    wi, wd = want
    assert torch.equal(gd, wd), f"{name}: distances differ from the plain route"
    unique = (wd[:, :, None] == wd[:, None, :]).sum(-1) == 1
    assert torch.equal(torch.where(unique, gi.long(), -1), torch.where(unique, wi.long(), -1)), (
        f"{name}: ids differ from the plain route at unique distances")


def phase_main_path(corpus, queries):
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.models.pq import _merge_candidates
    from vq_tpu_torch.ops import cuda_kernels as ck

    kernels = (ck.pq_lloyd_accumulate_fused, ck.pq_encode_fused, ck.adc_scan_topk_fused)
    for fn in kernels:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pq = vq_tpu_torch.ProductQuantizer(corpus[:N_TRAIN], M, K, max_iters=10,
                                     device=corpus.device)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    index = vq_tpu_torch.PQIndex(pq, keep_corpus=True)
    t0 = time.perf_counter()
    index.add(corpus)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    ids, dist = index.search(queries, k=10)
    ids_r, dist_r = index.search(queries, k=10, rerank=100)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in kernels}
    log("main", f"launches in the main path: {launches}")
    assert all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}"

    for name, (i, d) in (("search", (ids, dist)), ("search rerank=100", (ids_r, dist_r))):
        assert tuple(i.shape) == (N_QUERY, 10) and tuple(d.shape) == (N_QUERY, 10), name
        assert bool(torch.isfinite(d).all()), f"{name}: non-finite distances"
        assert bool(((i >= 0) & (i < N_CORPUS)).all()), f"{name}: ids out of range"
        assert bool((d[:, 1:] >= d[:, :-1]).all()), f"{name}: not ascending"

    codes_plain = ck.pq_encode_plain(corpus, pq.codebooks).to(torch.uint8)
    n_diff = int((codes_plain != index._codes).sum())
    assert n_diff == 0, f"{n_diff} codes of PQIndex.add differ from the plain encode"
    codes_t = index._codes.T.contiguous()
    tables = pq.adc_tables(queries)
    want = _merge_candidates(*ck.adc_scan_topk_plain(tables, codes_t, 10), 10, True)
    _parity((ids, dist), want, "search")
    short = _merge_candidates(*ck.adc_scan_topk_plain(tables, codes_t, 100), 100, True)[0]
    want_r = pq._rerank(queries, short, corpus, 10)
    _parity((ids_r, dist_r), want_r, "search rerank=100")

    gt = _ground_truth(corpus, queries)
    r_adc, r_rr = _recall(ids, gt), _recall(ids_r, gt)
    assert r_rr >= r_adc, (r_rr, r_adc)
    mse = float(((pq.decode(index._codes) - corpus) ** 2).mean())
    assert mse == mse and mse < float((corpus - corpus.mean(0)).square().mean()), mse
    log("main", f"trained {pq!r} in {t_train:.3f} s; add 1M in {t_add:.3f} s "
        f"(codes equal the plain encode); search and rerank=100 equal "
        f"the plain route; recall@10 ADC {r_adc:.4f}, rerank=100 {r_rr:.4f}; "
        f"reconstruction MSE of the 1M rows {mse:.9g} an element")
    return dict(pq=pq, index=index, t_train=t_train, t_add=t_add, launches=launches,
                recall=(r_adc, r_rr), gt=gt)


def phase_ivf_kernels(corpus, g):
    """K1 and K2 held to their plain versions at the IVF path's shapes."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    cents = corpus[torch.randperm(N_CORPUS, generator=g, device=corpus.device)[:NLIST]]
    res = {"cents": cents, "k1_err": 0.0}
    for tag, x in (("f32", corpus), ("bf16", corpus.to(torch.bfloat16))):
        codes, dists = ck.assign_fused(x, cents)
        torch.cuda.synchronize()
        pc, pd = ck.assign_plain(x, cents)
        flips, gap = _near_ties(x.float(), cents, codes, pc)
        same = codes == pc
        err = float((dists - pd).abs()[same].max())
        assert err <= K1_DIST_RTOL * float(pd.abs().max()), f"K1 {tag}: distances off by {err}"
        res["k1_err"] = max(res["k1_err"], err)
        n_dist = int((dists.view(torch.int32) != pd.view(torch.int32)).sum())
        log("kernels", f"K1 assign {tag} {tuple(x.shape)} vs {NLIST} centroids: "
            f"{flips} of {codes.numel()} codes differ from the plain version, all float64 near "
            f"ties (max score gap {gap:.3g}); {n_dist} distances differ in their bits, max abs "
            f"err {err:.3g} where codes agree")
    x2 = corpus[:N_IVF_TRAIN]
    res["cents_rq"] = cents[:K]  # an RQ stage's k
    for tag, c in k2_shapes(res).items():
        got = ck.lloyd_accumulate_fused(x2, c)
        again = ck.lloyd_accumulate_fused(x2, c)
        torch.cuda.synchronize()
        want = ck.lloyd_accumulate_plain(x2, c)
        diffs = [int((a != b).sum()) for a, b in zip(got, want)]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (
            f"K2 {tag}: {diffs} sums / counts / inertia differ from the plain version")
        assert all(torch.equal(a, b) for a, b in zip(got, again)), (
            f"K2 {tag} is not deterministic from run to run")
        assert int(got[1].sum()) == x2.shape[0]
        log("kernels", f"K2 lloyd_accumulate {tag}: sums, counts and inertia bit-identical to the "
            f"plain version and on a second run (clusters: largest {int(got[1].max())} rows, mean "
            f"{float(got[1].mean()):.1f}, empty {int((got[1] == 0).sum())})")
    res["k2_err"] = 0.0
    return res


def _check_search(name, ids, dist, descending=False):
    import torch

    assert tuple(ids.shape) == (N_QUERY, 10) and tuple(dist.shape) == (N_QUERY, 10), name
    assert bool(torch.isfinite(dist).all()), f"{name}: non-finite distances"
    assert bool(((ids >= 0) & (ids < N_CORPUS)).all()), f"{name}: ids out of range"
    lo, hi = (dist[:, 1:], dist[:, :-1]) if descending else (dist[:, :-1], dist[:, 1:])
    assert bool((hi >= lo).all()), f"{name}: not in order"


def phase_ivf_path(corpus, queries, gt):
    """IVFPQIndex train -> add -> search through the public entry points."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    reset_counts()
    index, t_train = cuda_once(lambda: vq_tpu_torch.IVFPQIndex.train(
        corpus[:N_IVF_TRAIN], NLIST, M, K, max_iters=10, keep_corpus=True))
    _, t_add = cuda_once(lambda: index.add(corpus))
    out, k7_by_nprobe = {}, {}
    for p in NPROBES:
        before = ck.ivf_probe_adc_fused.launches
        for r in RERANKS:
            out[(p, r)] = index.search(queries, k=10, nprobe=p, rerank=r)
        k7_by_nprobe[p] = ck.ivf_probe_adc_fused.launches - before
    torch.cuda.synchronize()
    launches = read_counts()
    log("ivf", f"launches in the ivf path: {launches}")
    on_path = ("assign_fused", "lloyd_accumulate_fused", "pq_lloyd_accumulate_fused",
               "pq_encode_fused", "ivf_probe_adc_fused")
    assert all(launches[n] > 0 for n in on_path), f"a kernel was not launched: {launches}"
    stats = index.bucket_stats()
    log("ivf", f"trained {index!r} in {t_train / 1e3:.4f} s, added {N_CORPUS} in {t_add / 1e3:.4f} s; "
        f"lists: min {stats['min']} mean {stats['mean']:.1f} max {stats['max']}, cap "
        f"{stats['cap']}, empty {stats['empty_lists']}")

    with plain_route():
        lists_p, _ = vq_tpu_torch.assign(corpus, index.coarse)
        lists = index._flat_lists
        flips, gap = _near_ties(corpus, index.coarse, lists, lists_p)
        enc_in = corpus - index.coarse[lists.long()]
        codes_p = index.pq.encode(enc_in)
        want = {key: index.search(queries, k=10, nprobe=key[0], rerank=key[1]) for key in out}
    codes = index._pool.to_flat()["codes"]
    n_codes = int((codes != codes_p).sum())
    assert n_codes == 0, f"{n_codes} residual codes differ from the plain encode"
    recall = {}
    for (p, r), (ids, dist) in out.items():
        name = f"ivf search nprobe={p} rerank={r}"
        _check_search(name, ids, dist)
        _parity((ids, dist), want[(p, r)], name)
        recall[(p, r)] = _recall(ids, gt)
    mse = float(((index.reconstruct(torch.arange(N_CORPUS, device=corpus.device)) - corpus) ** 2).mean())
    log("ivf", f"add: {flips} of {N_CORPUS} lists differ from the plain assign, all "
        f"float64 near ties (max gap {gap:.3g}); residual codes equal the plain encode; all "
        "searches equal the plain route; recall@10 " + ", ".join(
            f"nprobe={p} rerank={r}: {v:.4f}" for (p, r), v in recall.items())
        + f"; reconstruction MSE of the 1M rows {mse:.9g} an element")
    assert recall[(64, 500)] >= recall[(8, 0)], recall
    return dict(index=index, t_train=t_train, t_add=t_add, launches=launches, recall=recall,
                k7_by_nprobe=k7_by_nprobe)


def phase_k7(queries, ivf):
    """K7 held to its plain version over the built index's probed chains."""
    import torch

    from vq_tpu_torch.ivf import _probe_tables
    from vq_tpu_torch.ops import cuda_kernels as ck

    index = ivf["index"]
    pool = index._pool
    chains_s = pool.chains_search()
    cases = {}
    for p in NPROBES:
        probe, tables, _ = _probe_tables(queries, index.coarse, index.pq.codebooks, p, True)
        args = (tables.reshape(N_QUERY * p, M, K), chains_s[probe].reshape(N_QUERY * p, -1),
                pool.data["codes"])
        got = ck.ivf_probe_adc_fused(*args, cap=pool.cap)
        torch.cuda.synchronize()
        want = ck.ivf_probe_adc_plain(*args, cap=pool.cap)
        assert torch.equal(got, want), f"K7 nprobe={p}: values differ from the plain version"
        cases[p] = args
        log("kernels", f"K7 ivf_probe_adc nprobe={p}: {args[0].shape[0]} (query, list) pairs x "
            f"{args[1].shape[1]} chunks of {pool.ch} rows (cap {pool.cap}): bit-identical")
    return cases


def phase_ivf_timings(smi, corpus, queries, kres, ivf, k7_cases):
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    cents, index = kres["cents"], ivf["index"]
    x2 = corpus[:N_IVF_TRAIN]
    t = {}
    k1_ms, k1_clock = clocked(lambda: cuda_ms(lambda: ck.assign_fused(corpus, cents), 5))
    t["K1"] = (k1_ms, cuda_ms(lambda: ck.assign_plain(corpus, cents), 1))
    xb = corpus.to(torch.bfloat16)
    k1b_ms, k1b_clock = clocked(lambda: cuda_ms(lambda: ck.assign_fused(xb, cents), 5))
    t["K1_bf16"] = (k1b_ms, None)
    log("time", f"K1 f32 timed at {k1_clock}; bf16 at {k1b_clock} | {smi}")
    for name, c in (("K2", cents), ("K2_rq_shape", kres["cents_rq"])):
        t[name] = (cuda_ms(lambda: ck.lloyd_accumulate_fused(x2, c), 10),
                   cuda_ms(lambda: ck.lloyd_accumulate_plain(x2, c), 2))
    cap = index._pool.cap
    for p, args in k7_cases.items():
        t[f"K7_nprobe{p}"] = (cuda_ms(lambda: ck.ivf_probe_adc_fused(*args, cap=cap), 20),
                              cuda_ms(lambda: ck.ivf_probe_adc_plain(*args, cap=cap), 3))
    for name, (ms, pms) in t.items():
        plain = "not measured" if pms is None else f"{pms:.4f} ms"
        log("time", f"{name}: kernel {ms:.4f} ms, plain {plain} | {smi}")
    sms, mhz = sm_rate()
    floor = 2.0 * N_CORPUS * NLIST * DIM / (sms * 128 * mhz * 1e6) * 1e3
    log("bound", f"K1's floor under its exact contract (a rounded multiply and a rounded add a "
        f"term, no FMA): 2 n k d = {2.0 * N_CORPUS * NLIST * DIM:.4g} FP32 instructions over "
        f"{sms} SMs x 128 lanes x {mhz:.0f} MHz = {floor:.4f} ms; K1 f32 at {floor / t['K1'][0]:.3f} "
        f"of it, bf16 at {floor / t['K1_bf16'][0]:.3f} | {smi}")
    mm = cuda_ms(lambda: corpus @ cents.T, 5)
    log("time", f"cuBLAS fp32 corpus @ cents.T [{N_CORPUS}, {DIM}] x [{DIM}, {NLIST}], TF32 off "
        f"(allow_tf32={torch.backends.cuda.matmul.allow_tf32}): the product alone, with FMA, no "
        f"argmin; a yardstick for a tensor-core K1, not K1's library call: {mm:.4f} ms | {smi}")

    def add_fresh():
        fresh = vq_tpu_torch.IVFPQIndex(index.coarse, index.pq, keep_corpus=True)
        fresh.add(corpus)
        return fresh

    add_ms = cuda_once(add_fresh)[1]
    with plain_route():
        train_plain_ms = cuda_once(lambda: vq_tpu_torch.IVFPQIndex.train(
            corpus[:N_IVF_TRAIN], NLIST, M, K, max_iters=10, keep_corpus=True))[1]
        add_plain_ms = cuda_once(add_fresh)[1]
    log("time", f"IVF train 200k x 128, IVF{NLIST} + PQ 8x256, 10 iterations: "
        f"{ivf['t_train'] / 1e3:.4f} s (first call), plain route {train_plain_ms / 1e3:.4f} s | {smi}")
    log("time", f"IVF add 1M: {N_CORPUS / ivf['t_add'] * 1e3:.6g} vectors/s first call, "
        f"{N_CORPUS / add_ms * 1e3:.6g} vectors/s again; plain route "
        f"{N_CORPUS / add_plain_ms * 1e3:.6g} vectors/s | {smi}")
    search = {}
    for p in NPROBES:
        for r in RERANKS:
            ms = cuda_ms(lambda: index.search(queries, k=10, nprobe=p, rerank=r), 10)
            with plain_route():
                pms = cuda_ms(lambda: index.search(queries, k=10, nprobe=p, rerank=r), 3)
            search[(p, r)] = (ms, pms)
            log("time", f"IVF search 128 queries, nprobe={p} rerank={r}: {ms:.4f} ms per batch, "
                f"{N_QUERY / ms * 1e3:.6g} QPS; plain route {pms:.4f} ms, "
                f"{N_QUERY / pms * 1e3:.6g} QPS; recall@10 {ivf['recall'][(p, r)]:.4f} | {smi}")
    return t


def phase_k2_stages(smi, corpus, kres):
    """K2's stages at both of its shapes: a ``torch.profiler`` line of the
    device time a call of each kernel of ``vq_lloyd``, and the sums stage
    (the segment sums and their combine) beside its bytes bound and
    ``index_add_``: one PyTorch call that sums the rows by cluster, with
    float atomics whose order changes from run to run, a yardstick the
    port never calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vq_tpu_torch.ops import cuda_kernels as ck

    x2, reps = corpus[:N_IVF_TRAIN], 5
    cuda = torch.autograd.DeviceType.CUDA
    for tag, c in k2_shapes(kres).items():
        k, d = c.shape
        ck.lloyd_accumulate_fused(x2, c)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                ck.lloyd_accumulate_fused(x2, c)
            torch.cuda.synchronize()
        # (the vq_tpu_torch.* spans of utils.metrics.trace are ranges, not kernels)
        evts = [e for e in prof.key_averages()
                if e.device_type == cuda and not e.key.startswith("vq_tpu_torch.")]
        stages = stage_times(evts, calls=reps)
        total = sum(e.self_device_time_total for e in evts) / 1e3 / reps
        log("profile", f"K2 {tag}, device ms a call by stage: " + ", ".join(
            f"{s} {ms:.4f}" + (f" x{n:g}" if n != 1 else "") for s, (ms, n) in stages.items())
            + f"; all device activity {total:.4f} ms | {smi}")
        idx = ck.assign_fused(x2, c)[0].long()
        lib = cuda_ms(lambda: torch.zeros(k, d, device=x2.device).index_add_(0, idx, x2), 20)
        b_ms, b_by = bound(x2.numel() * 4 + x2.shape[0] * 4 + k * d * 4, 1.0 * x2.numel(), PEAK_F32)
        if "sums" in stages and "combine" in stages:
            sums_ms = stages["sums"][0] + stages["combine"][0]
            stage = f"segment sums + combine {sums_ms:.4f} ms, {b_ms / sums_ms:.3f} of it"
        else:  # the profiler dropped the call's kernels
            stage = "segment sums + combine not measured"
        log("bound", f"K2 sums stage {tag}: x read once, the row ids read and the sums written "
            f"once, {b_ms:.4f} ms ({b_by}); {stage}; index_add_ (float atomics, the yardstick) "
            f"{lib:.4f} ms | {smi}")


def phase_k3_stages(smi, corpus, res):
    """K3 at 100k (PQ training) and 200k rows (IVF-PQ training) against
    the 8x256x16 codebooks: a ``torch.profiler`` line a shape of the device
    time a call of each of its launches (K4's scan, the labels and inertia
    partials, K2's sums stage, the inertia sum), and its sums stage (all
    but the scan) beside its bytes bound and ``index_add_`` of the same
    entries by the same labels (float atomics, a yardstick the port never
    calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vq_tpu_torch.ops import cuda_kernels as ck

    cb, reps = res["cb"], 5
    s = DIM // M
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for n in (N_TRAIN, N_IVF_TRAIN):
        x = corpus[:n]
        ck.pq_lloyd_accumulate_fused(x, cb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                ck.pq_lloyd_accumulate_fused(x, cb)
            torch.cuda.synchronize()
        # (the vq_tpu_torch.* spans of utils.metrics.trace are ranges, not kernels)
        evts = [e for e in prof.key_averages()
                if e.device_type == cuda and not e.key.startswith("vq_tpu_torch.")]
        stages = stage_times(evts, K3_STAGES, reps)
        total = sum(e.self_device_time_total for e in evts) / 1e3 / reps
        log("profile", f"K3 {n} x {DIM} vs {M}x{K}x{s}, device ms a call by launch: " + ", ".join(
            f"{st} {ms:.4f}" + (f" x{c:g}" if c != 1 else "") for st, (ms, c) in stages.items())
            + f"; all device activity {total:.4f} ms | {smi}")
        labels = (ck.pq_encode_fused(x, cb).long() + torch.arange(M, device=x.device) * K).reshape(-1)
        xe = x.reshape(-1, s)
        lib = cuda_ms(lambda: torch.zeros(M * K, s, device=x.device).index_add_(0, labels, xe), 20)
        b_ms, b_by = bound(xe.numel() * 4 + 2 * labels.numel() * 4 + M * K * (s + 1) * 4 + 4,
                           2.0 * xe.numel(), PEAK_F32)
        if "pq scan" in stages and len(stages) > 2:
            stage_ms = sum(ms for st, (ms, _) in stages.items() if st != "pq scan")
            stage = f"sums stage (all but the scan) {stage_ms:.4f} ms, {b_ms / stage_ms:.3f} of it"
        else:  # the profiler dropped the call's kernels
            stage_ms, stage = None, "sums stage not measured"
        log("bound", f"K3 sums stage {n} x {M}x{K}x{s}: x, the codes and the minimum scores read "
            f"once, the sums, counts and inertia written once, {b_ms:.4f} ms ({b_by}); {stage}; "
            f"index_add_ of the {xe.shape[0]} entries by label (float atomics, the yardstick) "
            f"{lib:.4f} ms | {smi}")
        out[n] = dict(stage_ms=stage_ms, bound_ms=b_ms, index_add_ms=lib)
    return out


def phase_flat_path(corpus, queries, gt):
    """IVF-Flat and IVF-SQ train -> add -> search through the public entry
    points, with K6's operands recorded from each search."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    reset_counts()
    train = corpus[:N_IVF_TRAIN]
    flat, t_train = cuda_once(lambda: vq_tpu_torch.IVFFlatIndex.train(train, NLIST, max_iters=10))
    sq, t_train_sq = cuda_once(lambda: vq_tpu_torch.IVFSQIndex.train(train, NLIST, max_iters=10))
    trained = read_counts()
    assert trained["assign_fused"] > 0 and trained["lloyd_accumulate_fused"] > 0, trained
    indexes = {"flat_f32": flat, "sq": sq,
               "flat_bf16": vq_tpu_torch.IVFFlatIndex(flat.coarse, store_dtype="bfloat16"),
               "flat_dot": vq_tpu_torch.IVFFlatIndex(flat.coarse, metric="dot")}
    t_add = {}
    for name, idx in indexes.items():
        before = ck.assign_fused.launches
        t_add[name] = cuda_once(lambda: idx.add(corpus))[1]
        assert ck.assign_fused.launches > before, f"{name}: add launched no K1"
    searches = [(name, p) for name in FLAT_KINDS for p in NPROBES] + [("flat_dot", NPROBES[0])]
    out, operands = {}, {}
    for key in searches:
        before = ck.ivf_probe_matvec_fused.launches
        with recording("vq_tpu_torch.ivf_flat", "ivf_probe_matvec_fused") as calls:
            out[key] = indexes[key[0]].search(queries, k=10, nprobe=key[1])
        assert ck.ivf_probe_matvec_fused.launches == before + 1, f"{key}: K6 did not launch"
        operands[key] = calls[0]
    torch.cuda.synchronize()
    launches = read_counts()
    log("flat", f"launches in the ivf-flat path: {launches} (training alone: K1 "
        f"{trained['assign_fused']}, K2 {trained['lloyd_accumulate_fused']})")
    for name, idx in indexes.items():
        st = idx.bucket_stats()
        log("flat", f"{idx!r}: add 1M {t_add[name] / 1e3:.4f} s; lists min {st['min']} mean "
            f"{st['mean']:.1f} max {st['max']}, cap {st['cap']}")

    with plain_route():
        want = {key: indexes[key[0]].search(queries, k=10, nprobe=key[1]) for key in searches}
    recall = {}
    for key, (ids, dist) in out.items():
        name = f"{key[0]} search nprobe={key[1]}"
        _check_search(name, ids, dist, descending=key[0] == "flat_dot")
        _parity((ids, dist), want[key], name)
        recall[key] = _recall(ids, gt)
    log("flat", f"trained IVF-Flat in {t_train / 1e3:.4f} s and IVF-SQ in {t_train_sq / 1e3:.4f} s; "
        "every search equals the plain route; recall@10 " + ", ".join(
            f"{n} nprobe={p}: {v:.4f}" for (n, p), v in recall.items()))
    assert recall[("flat_f32", NPROBES[-1])] >= FLAT_MIN_RECALL, recall
    return dict(indexes=indexes, operands=operands, launches=launches, recall=recall,
                t_train=t_train, t_train_sq=t_train_sq, t_add=t_add, searches=searches)


def k6_bound(args, kw):
    """``(ms, by, note, instructions)``: K6's bound on one call's
    operands. Bytes: the rows of each chunk the probe table names (once,
    however many pairs probe it), the output, the left vectors and the
    table; operations: a multiply and an add a live (pair, row,
    dimension), over the fp32 peak. The last is that count of FP32
    instructions, K6's floor under its no-FMA contract."""
    import torch

    lhs, chains, payload = args
    (n_chunks, ch, d), cap = payload.shape, kw["cap"]
    width = chains.shape[1] * ch
    valid = chains[(chains >= 0) & (chains < n_chunks)]
    chunks = torch.unique(valid).numel()
    pos = torch.arange(width, device=chains.device)
    live = int((((chains >= 0) & (chains < n_chunks)).repeat_interleave(ch, dim=1) & (pos < cap)).sum())
    rows = chunks * ch * d * payload.element_size()
    out = lhs.shape[0] * width * 4
    ms, by = bound(rows + out + lhs.numel() * 4 + chains.numel() * 4, 2.0 * live * d, PEAK_F32)
    return ms, by, (f"{chunks} chunks x {ch} rows x {d} x {payload.element_size()} B "
                    f"= {rows / 1e6:.1f} MB read once, {out / 1e6:.1f} MB written, {live} live "
                    f"positions"), 2.0 * live * d


def phase_k6(flat):
    """K6 held to its plain version on the operands each of the seven
    searches gave it, with its work list held to the plain version's."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    cases, err = {}, 0.0
    for key in flat["searches"]:
        args, kw = flat["operands"][key]
        got = ck.ivf_probe_matvec_fused(*args, **kw)
        torch.cuda.synchronize()
        want = ck.ivf_probe_matvec_plain(*args, **kw)
        err = max(err, float((got - want).abs().max()))
        assert torch.equal(got, want), f"K6 {key}: values differ from the plain version"
        lhs, chains, payload = args
        plan = ck.ivf_matvec_work_list(chains, payload.shape[0], payload.shape[1], kw["cap"])
        plain = ck.ivf_matvec_work_list_plain(chains, payload.shape[0], payload.shape[1], kw["cap"])
        assert all(torch.equal(a, b) for a, b in zip(plan, plain)), f"K6 {key}: work list differs"
        cases[key] = (args, kw, k6_bound(args, kw))
        per = (plan[0][1:] - plan[0][:-1]).long()
        per = per[per > 0]
        log("kernels", f"K6 ivf_probe_matvec {str(payload.dtype)[6:]} ({key[0]}) nprobe={key[1]}: "
            f"{lhs.shape[0]} (query, list) pairs x {chains.shape[1]} chunks of {payload.shape[1]} "
            f"rows x d {lhs.shape[1]} (cap {kw['cap']}), {plan[1].numel()} live (pair, chunk) "
            f"entries over {per.numel()} chunks (median {int(per.median())}, most "
            f"{int(per.max())} a chunk; {int(((per + 31) // 32).sum())} tasks of <= 32); "
            f"{cases[key][2][2]}: bit-identical, work list as the plain version's")
    return cases, err


def phase_flat_timings(smi, queries, flat, k6_cases):
    from vq_tpu_torch.ops import cuda_kernels as ck

    import torch
    from torch.profiler import ProfilerActivity, profile

    t, reps = {}, 5
    cuda = torch.autograd.DeviceType.CUDA
    sms, mhz = sm_rate()
    for (name, p), (args, kw, (b_ms, b_by, note, instr)) in k6_cases.items():
        tag = f"K6 {str(args[2].dtype)[6:]} ({name}) nprobe={p}"
        ms = cuda_ms(lambda: ck.ivf_probe_matvec_fused(*args, **kw), 20)
        pms = cuda_ms(lambda: ck.ivf_probe_matvec_plain(*args, **kw), 2)
        t[f"K6_{name}_nprobe{p}"] = (ms, pms)
        log("time", f"{tag}: kernel {ms:.4f} ms, plain {pms:.4f} ms | {smi}")
        floor = instr / (sms * 128 * mhz * 1e6) * 1e3
        log("bound", f"{tag}: {ms:.4f} ms against a bound of {b_ms:.4f} ms ({b_by}: {note}), "
            f"{b_ms / ms:.3f} of it; floor under its no-FMA contract {instr:.4g} FP32 instructions "
            f"over {sms} SMs x 128 lanes x {mhz:.0f} MHz = {floor:.4f} ms, {floor / ms:.3f} of it "
            f"| {smi}")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                ck.ivf_probe_matvec_fused(*args, **kw)
            torch.cuda.synchronize()
        # (the vq_tpu_torch.* spans of utils.metrics.trace are ranges, not kernels)
        evts = [e for e in prof.key_averages()
                if e.device_type == cuda and not e.key.startswith("vq_tpu_torch.")]
        stages = stage_times(evts, K6_STAGES, reps)
        kernels = [e.time_range for e in prof.events() if e.device_type == cuda]
        busy = sum(e.self_device_time_total for e in evts) / 1e3 / reps
        span = (max(r.end for r in kernels) - min(r.start for r in kernels)) / 1e3 / reps
        # The host's side: the wrapper's calls queued back to back, then the
        # wait for the card; a queueing time above the device's busy time
        # means the host, not the kernels, sets the pace.
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(20):
            ck.ivf_probe_matvec_fused(*args, **kw)
        h1 = time.perf_counter()
        torch.cuda.synchronize()
        h2 = time.perf_counter()
        log("profile", f"{tag}, device ms a call by launch: " + ", ".join(
            f"{s} {v:.4f}" for s, (v, c) in stages.items())
            + f"; all device activity {busy:.4f}, first start to last end {span:.4f} ms a call; "
            f"host: {(h1 - h0) * 50:.4f} ms a call to queue, {(h2 - h0) * 50:.4f} to finish, "
            f"CUDA events again {cuda_ms(lambda: ck.ivf_probe_matvec_fused(*args, **kw), 20):.4f} "
            f"| {smi}")
    log("time", f"IVF-Flat train 200k x 128, IVF{NLIST}, 10 iterations: {flat['t_train'] / 1e3:.4f} s; "
        f"IVF-SQ train {flat['t_train_sq'] / 1e3:.4f} s (first calls) | {smi}")
    for name, ms in flat["t_add"].items():
        log("time", f"{name} add 1M: {N_CORPUS / ms * 1e3:.6g} vectors/s (first call) | {smi}")
    for name, p in flat["searches"]:
        idx = flat["indexes"][name]
        ms = cuda_ms(lambda: idx.search(queries, k=10, nprobe=p), 10)
        with plain_route():
            pms = cuda_ms(lambda: idx.search(queries, k=10, nprobe=p), 2)
        log("time", f"{name} search 128 queries, nprobe={p}: {ms:.4f} ms per batch, "
            f"{N_QUERY / ms * 1e3:.6g} QPS; plain route {pms:.4f} ms, "
            f"{N_QUERY / pms * 1e3:.6g} QPS; recall@10 {flat['recall'][(name, p)]:.4f} | {smi}")
    return t


def phase_timings(smi, corpus, queries, res, main):
    import torch

    from vq_tpu_torch.models.pq import _merge_candidates
    from vq_tpu_torch.ops import cuda_kernels as ck

    cb, pq, index = res["cb"], main["pq"], main["index"]
    x3 = corpus[:N_TRAIN]
    t = {}
    t["K3"] = (cuda_ms(lambda: ck.pq_lloyd_accumulate_fused(x3, cb), 10),
               cuda_ms(lambda: ck.pq_lloyd_accumulate_plain(x3, cb), 3))
    x3_ivf = corpus[:N_IVF_TRAIN]  # IVFPQIndex.train's K3 rows
    t["K3_200k"] = (cuda_ms(lambda: ck.pq_lloyd_accumulate_fused(x3_ivf, cb), 10),
                    cuda_ms(lambda: ck.pq_lloyd_accumulate_plain(x3_ivf, cb), 2))
    t["K4"] = (cuda_ms(lambda: ck.pq_encode_fused(corpus, cb), 5),
               cuda_ms(lambda: ck.pq_encode_plain(corpus, cb), 2))
    tab, ct = res["tables"], res["codes_t"]
    t["K5"] = (cuda_ms(lambda: ck.adc_scan_topk_fused(tab, ct, 10), 10),
               cuda_ms(lambda: ck.adc_scan_topk_plain(tab, ct, 10), 3))
    t["K5_fetch100"] = (cuda_ms(lambda: ck.adc_scan_topk_fused(tab, ct, 100), 10),
                        cuda_ms(lambda: ck.adc_scan_topk_plain(tab, ct, 100), 3))
    codes_t = index._codes.T.contiguous()
    search_ms = cuda_ms(lambda: index.search(queries, k=10), 10)
    search_plain_ms = cuda_ms(lambda: _merge_candidates(
        *ck.adc_scan_topk_plain(pq.adc_tables(queries), codes_t, 10), 10, True), 3)
    rerank_ms = cuda_ms(lambda: index.search(queries, k=10, rerank=100), 10)
    for name, (ms, pms) in t.items():
        log("time", f"{name}: kernel {ms:.4f} ms, plain {pms:.4f} ms | {smi}")
    # K5 keeps F = 32, 64 or 128 words a warp (the power of two >= fetch,
    # at least 32): its time at each width's edges, and on tie-heavy data.
    widths = {f: cuda_ms(lambda: ck.adc_scan_topk_fused(tab, ct, f), 10) for f in (1, 32, 33, 64, 65, 128)}
    tied = {f: cuda_ms(lambda: ck.adc_scan_topk_fused(*res["k5_tied"], f), 10) for f in (10, 100)}
    log("time", "K5 by fetch: " + ", ".join(f"{f} {ms:.4f} ms" for f, ms in widths.items())
        + "; tie-heavy " + ", ".join(f"{f} {ms:.4f} ms" for f, ms in tied.items()) + f" | {smi}")
    sms, mhz = sm_rate()
    lookups = float(tab.shape[0]) * ct.shape[1] * ct.shape[0]
    floor = lookups / (sms * 32 * mhz * 1e6) * 1e3
    log("bound", f"K5's shared-memory lookup floor: Q n m = {lookups:.4g} 4-byte table lookups at "
        f"32 a clock an SM, {sms} SMs x {mhz:.0f} MHz = {floor:.4f} ms; K5 at "
        f"{floor / t['K5'][0]:.3f} of it (fetch 10), {floor / t['K5_fetch100'][0]:.3f} (fetch 100) "
        f"| {smi}")
    s = DIM // M
    for name, n in (("K4", N_CORPUS), ("K3", N_TRAIN), ("K3_200k", N_IVF_TRAIN)):
        instr = 2.0 * n * M * K * s
        floor = instr / (sms * 128 * mhz * 1e6) * 1e3
        log("bound", f"{name}'s floor under its exact contract (a rounded multiply and a rounded "
            f"add a term, no FMA): 2 n m k s = {instr:.4g} FP32 instructions at n = {n} over {sms} "
            f"SMs x 128 lanes x {mhz:.0f} MHz = {floor:.4f} ms; {name} at {floor / t[name][0]:.3f} "
            f"of it | {smi}")
    log("time", f"PQ train 100k x 128, 8x256, 10 iterations: {main['t_train']:.4f} s, "
        f"{main['t_train'] / 10:.5f} s per Lloyd iteration (host clock) | {smi}")
    log("time", f"encode 1M x 128: kernel {N_CORPUS / t['K4'][0] * 1e3:.6g} vectors/s, plain "
        f"{N_CORPUS / t['K4'][1] * 1e3:.6g} vectors/s; PQIndex.add 1M {main['t_add']:.4f} s "
        f"(host clock, first call) | {smi}")
    log("time", f"search 128 queries over 1M, k=10: {search_ms:.4f} ms per batch, "
        f"{N_QUERY / search_ms * 1e3:.6g} QPS; plain route {search_plain_ms:.4f} ms, "
        f"{N_QUERY / search_plain_ms * 1e3:.6g} QPS; rerank=100 {rerank_ms:.4f} ms | {smi}")
    return t


def phase_lowp_kernels(corpus, res):
    """K4-bf16 and K4-bf16x3 (bf16 products on the tensor cores) held to
    their plain versions by the near-tie rule (``cuda_kernels.
    encode_parity``: at least MIN_MATCH of the codes equal, every other one
    a float64 near tie) at the main path's shapes with f32 and bf16 input,
    and bit for bit on small-integer operands (every partial sum exact) at
    the same shapes. Returns the largest float64 score gap a precision."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    cb, exact = res["cb"], res["codes_t"].T
    gaps = {}
    for precision in ("bf16_fast", "bf16x3"):
        for tag, x in (("f32", corpus), ("bf16", corpus.to(torch.bfloat16))):
            got = ck.pq_encode_fused(x, cb, precision=precision)
            torch.cuda.synchronize()
            par = ck.encode_parity(x, cb, got, precision)
            assert par.ok, (
                f"K4 {precision} {tag}: {par.match} of the codes equal the plain version's (at least "
                f"{ck.MIN_MATCH}); {par.flips} differ, max float64 gap {par.max_gap}")
            gaps[precision] = max(gaps.get(precision, 0.0), par.max_gap)
            match = float((got.to(torch.uint8) == exact).float().mean())
            log("kernels", f"K4 pq_encode precision={precision} {tag} {tuple(x.shape)} vs 8x256x16: "
                f"{par.match:.7f} of the codes equal the plain version's, {par.flips} differ, all "
                f"float64 near ties (max gap {par.max_gap:.3g}); {match:.6f} equal the exact f32 "
                "encode's")
    g = torch.Generator(device=corpus.device).manual_seed(SEED)
    xi = torch.randint(-4, 5, tuple(corpus.shape), generator=g, device=corpus.device).float()
    cbi = torch.randint(-4, 5, tuple(cb.shape), generator=g, device=corpus.device).float()
    for precision in ("bf16_fast", "bf16x3"):
        for tag, x in (("f32", xi), ("bf16", xi.to(torch.bfloat16))):
            got = ck.pq_encode_fused(x, cbi, precision=precision)
            torch.cuda.synchronize()
            want = ck.pq_encode_plain(x, cbi, precision)
            assert torch.equal(got, want), (
                f"K4 {precision} {tag} on integers: {int((got != want).sum())} codes differ")
    log("kernels", f"K4-bf16 and K4-bf16x3 on integer operands in [-4, 4] {tuple(xi.shape)} vs "
        "8x256x16, f32 and bf16 x: bit-identical to their plain versions")
    return gaps


def phase_precision(corpus, queries, main):
    """The encode precision ladder and ADC distances through the public
    entry points, on the main phase's quantizer."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    pq, exact = main["pq"], main["index"]
    reset_counts()
    indexes, t_add = {}, {}
    for precision in ("high", "default"):
        indexes[precision] = vq_tpu_torch.PQIndex(pq)
        t_add[precision] = cuda_once(lambda: indexes[precision].add(corpus, precision=precision))[1]
    with recording("vq_tpu_torch.models.pq", "adc_lookup_fused") as k8_calls:
        dists, t_dist = cuda_once(lambda: pq.adc_distances(queries, exact._codes))
    out = {p: idx.search(queries, k=10) for p, idx in indexes.items()}
    torch.cuda.synchronize()
    launches = read_counts()
    log("precision", f"launches in the precision path: {launches}")
    assert launches["pq_encode_fused[bf16x3]"] == 1 and launches["pq_encode_fused[bf16_fast]"] == 1, launches
    assert launches["adc_lookup_fused"] >= 1, launches
    assert tuple(dists.shape) == (N_QUERY, N_CORPUS) and bool(torch.isfinite(dists).all())

    with plain_route():
        codes_p = {p: pq.encode(corpus, precision=p) for p in indexes}
        dists_p = pq.adc_distances(queries, exact._codes)
        want = {p: idx.search(queries, k=10) for p, idx in indexes.items()}
    assert torch.equal(dists, dists_p), "adc_distances differ from the plain route"
    recall = {"highest": main["recall"][0]}
    for p, idx in indexes.items():
        kernel = {"high": "bf16x3", "default": "bf16_fast"}[p]
        par = ck.encode_parity(corpus, pq.codebooks, idx._codes, kernel, want=codes_p[p])
        assert par.ok, f"precision={p}: codes against the plain route: {par}"
        log("precision", f"PQIndex.add(precision={p!r}) codes: {par.match:.7f} equal the plain "
            f"route's, {par.flips} differ, all float64 near ties (max gap {par.max_gap:.3g}); the "
            "search below runs on the index's own codes in both routes")
        _check_search(f"precision={p} search", *out[p])
        _parity(out[p], want[p], f"precision={p} search")
        recall[p] = _recall(out[p][0], main["gt"])
        match = float((idx._codes == exact._codes).float().mean())
        log("precision", f"PQIndex.add(precision={p!r}) of 1M: {t_add[p]:.4f} ms, search equal "
            f"to the plain route's; {match:.6f} of the codes equal the exact encode's; "
            f"recall@10 {recall[p]:.4f} (exact index {recall['highest']:.4f})")
    args, _ = k8_calls[0]
    got = ck.adc_lookup_fused(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.adc_lookup_plain(*args)), "K8: values differ from the plain version"
    log("kernels", f"K8 adc_lookup tables {tuple(args[0].shape)} x codes {tuple(args[1].shape)} "
        f"{str(args[1].dtype)[6:]} (adc_distances' operands): bit-identical")
    log("precision", f"ProductQuantizer.adc_distances [128, 1M]: {t_dist:.4f} ms (first call), "
        "equal to the plain route")
    return dict(launches=launches, t_add=t_add, t_dist=t_dist, recall=recall, k8_args=args,
                indexes=indexes, pq=pq, codes=exact._codes)


def _rq_near_ties(x, cbs, got, want):
    """Rows whose stage codes differ must be float64 near ties at the first
    stage they differ: the two prefixes' squared residuals within
    ``TIE_RTOL`` of ``||x||^2 + 1``. Returns ``(rows, max gap)``."""
    import torch

    from vq_tpu_torch.benchmarks.mpacked_encode import TIE_RTOL

    rows = torch.nonzero((got != want).any(1))[:, 0]
    if rows.numel() == 0:
        return 0, 0.0
    g, w = got[rows].long(), want[rows].long()
    first = (g != w).int().argmax(1)
    stage = torch.arange(cbs.shape[0], device=x.device)
    upto = (stage[None, :] <= first[:, None]).double()[..., None]
    xd, cd = x[rows].double(), cbs.double()
    cost_g = ((xd - (cd[stage[None, :], g] * upto).sum(1)) ** 2).sum(-1)
    cost_w = ((xd - (cd[stage[None, :], w] * upto).sum(1)) ** 2).sum(-1)
    gap = (cost_g - cost_w).abs()
    ties = gap <= TIE_RTOL * ((xd * xd).sum(-1) + 1.0)
    assert bool(ties.all()), f"{int((~ties).sum())} differing RQ codes are not near ties"
    return rows.numel(), float(gap.max())


def phase_rq_path(corpus, queries, gt):
    """ResidualQuantizer, RQIndex and IVFRQIndex train -> add -> search
    through the public entry points."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops import cuda_kernels as ck

    reset_counts()
    train = corpus[:N_IVF_TRAIN]
    rq, t_train = cuda_once(lambda: vq_tpu_torch.ResidualQuantizer(
        train, RQ_STAGES, K, max_iters=RQ_ITERS, seed=1))
    trained = read_counts()
    indexes = {"l2": vq_tpu_torch.RQIndex(rq, keep_corpus=True),
               "cosine": vq_tpu_torch.RQIndex(rq, metric="cosine"),
               "dot": vq_tpu_torch.RQIndex(rq, metric="dot")}
    t_add = {name: cuda_once(lambda: idx.add(corpus))[1] for name, idx in indexes.items()}
    ivf, t_ivf_train = cuda_once(lambda: vq_tpu_torch.IVFRQIndex.train(
        train, NLIST, RQ_STAGES, K, max_iters=RQ_ITERS))
    t_ivf_add = cuda_once(lambda: ivf.add(corpus))[1]
    searches = {"rq": (indexes["l2"], dict(k=10)),
                f"rq rerank={RQ_RERANK}": (indexes["l2"], dict(k=10, rerank=RQ_RERANK)),
                "rq cosine": (indexes["cosine"], dict(k=10)), "rq dot": (indexes["dot"], dict(k=10))}
    searches.update({f"ivfrq nprobe={p}": (ivf, dict(k=10, nprobe=p)) for p in NPROBES})
    out, per_search = {}, {}
    with recording("vq_tpu_torch.models.pq", "adc_lookup_fused") as k8_calls:
        for name, (idx, kw) in searches.items():
            before = read_counts()
            out[name] = idx.search(queries, **kw)
            after = read_counts()
            per_search[name] = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    torch.cuda.synchronize()
    launches = read_counts()
    log("rq", f"launches in the rq path: {launches} (training alone: K1 {trained['assign_fused']}, "
        f"K2 {trained['lloyd_accumulate_fused']}); by search: {per_search}")
    on_path = ("assign_fused", "lloyd_accumulate_fused", "adc_scan_topk_fused",
               "ivf_probe_adc_fused", "adc_lookup_fused")
    assert all(launches[n] > 0 for n in on_path), f"a kernel was not launched: {launches}"
    assert per_search[f"rq rerank={RQ_RERANK}"].get("adc_lookup_fused") == -(-N_CORPUS // RQ_CHUNK)
    assert per_search["rq"].get("adc_scan_topk_fused") == 1 and per_search["rq dot"].get(
        "adc_scan_topk_fused") == 1, per_search

    with plain_route():
        codes_p = rq.encode(corpus)
        lists_p, _ = vq_tpu_torch.assign(corpus, ivf.coarse)
        want = {name: idx.search(queries, **kw) for name, (idx, kw) in searches.items()}
    n_codes, gap_codes = _rq_near_ties(corpus, rq.codebooks, indexes["l2"]._codes, codes_p)
    lists = ivf._flat_lists
    flips, gap_lists = _near_ties(corpus, ivf.coarse, lists, lists_p)
    recall = {}
    for name, (ids, dist) in out.items():
        _check_search(name, ids, dist, descending=name == "rq dot")
        _parity((ids, dist), want[name], name)
        recall[name] = _recall(ids, gt)
    log("rq", f"trained {rq!r} in {t_train / 1e3:.4f} s; RQIndex add 1M {t_add['l2']:.4f} ms; "
        f"{n_codes} of {N_CORPUS} rows' codes differ from the plain encode, all float64 near ties "
        f"(max gap {gap_codes:.3g}); IVF-RQ trained in {t_ivf_train / 1e3:.4f} s, add 1M "
        f"{t_ivf_add:.4f} ms, {flips} lists differ from the plain assign, all near ties "
        f"(max gap {gap_lists:.3g}); every search equals the plain route; recall@10 " + ", ".join(
            f"{n}: {v:.4f}" for n, v in recall.items()))
    assert recall[f"rq rerank={RQ_RERANK}"] >= recall["rq"], recall
    assert recall[f"ivfrq nprobe={NPROBES[-1]}"] >= recall[f"ivfrq nprobe={NPROBES[0]}"] - 0.01, recall

    args, _ = k8_calls[0]
    got = ck.adc_lookup_fused(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, ck.adc_lookup_plain(*args)), "K8 (RQ chunk): values differ"
    log("kernels", f"K8 adc_lookup tables {tuple(args[0].shape)} x codes {tuple(args[1].shape)} "
        f"{str(args[1].dtype)[6:]} (one chunk of the RQ scan): bit-identical")
    return dict(rq=rq, indexes=indexes, ivf=ivf, searches=searches, launches=launches,
                recall=recall, t_train=t_train, t_add=t_add, t_ivf_train=t_ivf_train,
                t_ivf_add=t_ivf_add, k8_args=args)


def phase_new_timings(smi, corpus, queries, res, prec, rqres):
    """K4-bf16, K4-bf16x3 and K8 (with the library call) timed, and the
    precision and RQ paths' searches beside their plain routes."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    cb, t = res["cb"], {}
    xb = corpus.to(torch.bfloat16)
    for p, name in (("bf16_fast", "K4_bf16"), ("bf16x3", "K4_bf16x3")):
        t[name] = (cuda_ms(lambda: ck.pq_encode_fused(corpus, cb, precision=p), 5),
                   cuda_ms(lambda: ck.pq_encode_plain(corpus, cb, p), 1), None)
    t["K4_bf16_bf16in"] = (cuda_ms(lambda: ck.pq_encode_fused(xb, cb, precision="bf16_fast"), 5),
                           None, None)
    for name, (tables, codes) in (("K8", prec["k8_args"]), ("K8_rq_chunk", rqres["k8_args"])):
        q, m, k = tables.shape
        weight = tables.permute(1, 2, 0).reshape(m * k, q).contiguous()
        index = (codes.long() + torch.arange(m, device=codes.device) * k).contiguous()
        lib = torch.nn.functional.embedding_bag(index, weight, mode="sum")
        err = float((lib.T - ck.adc_lookup_fused(tables, codes)).abs().max())
        t[name] = (cuda_ms(lambda: ck.adc_lookup_fused(tables, codes), 20),
                   cuda_ms(lambda: ck.adc_lookup_plain(tables, codes), 3),
                   cuda_ms(lambda: torch.nn.functional.embedding_bag(index, weight, mode="sum"), 20))
        log("time", f"{name}: embedding_bag (the library yardstick, [n, Q]) differs from K8 by at "
            f"most {err:.3g} (summation order) | {smi}")
    for name, (ms, pms, lms) in t.items():
        plain = "not measured" if pms is None else f"{pms:.4f} ms"
        lib = "" if lms is None else f", library call {lms:.4f} ms"
        log("time", f"{name}: kernel {ms:.4f} ms, plain {plain}{lib} | {smi}")
    k8 = {name: k8_floors(smi, name, *args, t[name][0])
          for name, args in (("K8", prec["k8_args"]), ("K8_rq_chunk", rqres["k8_args"]))}
    pq, codes = prec["pq"], prec["codes"]
    ms = cuda_ms(lambda: pq.adc_distances(queries, codes), 10)
    with plain_route():
        pms = cuda_ms(lambda: pq.adc_distances(queries, codes), 2)
    log("time", f"ProductQuantizer.adc_distances [128, 1M]: {ms:.4f} ms, plain route {pms:.4f} ms "
        f"| {smi}")
    for p, ms in prec["t_add"].items():
        log("time", f"PQIndex.add(precision={p!r}) 1M: {N_CORPUS / ms * 1e3:.6g} vectors/s "
            f"(first call) | {smi}")
    log("time", f"RQ train 200k x 128, 8x256, {RQ_ITERS} iterations a stage: "
        f"{rqres['t_train'] / 1e3:.4f} s; IVF-RQ train (IVF{NLIST} + RQ 8x256) "
        f"{rqres['t_ivf_train'] / 1e3:.4f} s (first calls) | {smi}")
    log("time", f"RQIndex add 1M: {N_CORPUS / rqres['t_add']['l2'] * 1e3:.6g} vectors/s; IVF-RQ add "
        f"1M: {N_CORPUS / rqres['t_ivf_add'] * 1e3:.6g} vectors/s (first calls) | {smi}")
    for name, (idx, kw) in rqres["searches"].items():
        ms = cuda_ms(lambda: idx.search(queries, **kw), 5)
        with plain_route():
            pms = cuda_ms(lambda: idx.search(queries, **kw), 2)
        log("time", f"{name} search 128 queries: {ms:.4f} ms per batch, {N_QUERY / ms * 1e3:.6g} QPS; "
            f"plain route {pms:.4f} ms; recall@10 {rqres['recall'][name]:.4f} | {smi}")
    return t, k8


def k8_wavefronts(codes, k: int) -> float:
    """Shared-memory wavefronts a quad's lookups take in K8 on ``codes
    [n, m]`` (16-byte entries, 4 rows a thread): a 16-byte load of a
    warp runs as 4 phases of 8 lanes, and a phase takes as many
    wavefronts as the most distinct entries that share one of the 8
    16-byte slots of a 128-byte row of banks (one entry read by several
    lanes is broadcast). Counted over this run's codes, whole warps of 128
    rows."""
    import torch

    n, m = codes.shape
    c = codes[:n // 128 * 128].long().view(-1, 4, 8, 4, m)  # warp, phase, lane, row, subspace
    c = c.permute(0, 1, 3, 4, 2).reshape(-1, 8)  # the 8 codes of one phase
    kp = k if codes.dtype == torch.uint8 and k >= 256 else k + 1  # csrc/adc_lookup.cu's kp
    sub = torch.arange(m, device=c.device).repeat(c.shape[0] // m)[:, None]
    entry = (c + sub * kp).sort(1).values
    distinct = torch.ones_like(entry)
    distinct[:, 1:] = (entry[:, 1:] != entry[:, :-1]).long()
    per_slot = torch.zeros_like(entry).scatter_add_(1, entry % 8, distinct)
    return float(per_slot.amax(1).sum()) * n / (n // 128 * 128)


def k8_floors(smi, name, tables, codes, ms):
    """K8 on codes that cost one shared-memory wavefront a phase, beside
    its 4-byte lookup floor (Q n m lookups at 32 a clock an SM) and the
    floor of its 16-byte design on this run's codes, on the same tables."""
    import torch

    from vq_tpu_torch.ops import cuda_kernels as ck

    q, m, k = tables.shape
    n = codes.shape[0]
    # The same tables over codes that cost one wavefront a phase: 8 lanes'
    # codes in 8 distinct slots, or all one code (broadcast).
    g = torch.Generator(device=codes.device).manual_seed(SEED)
    lanes = (torch.arange(n, device=codes.device) // 4 % 8)[:, None]
    spread = (lanes + 8 * torch.randint(0, k // 8, (n, m), generator=g, device=codes.device))
    calm = {"no bank conflicts": spread.to(codes.dtype), "one code": torch.zeros_like(codes)}
    calm_ms = {c: cuda_ms(lambda: ck.adc_lookup_fused(tables, v), 20) for c, v in calm.items()}
    log("time", f"{name} on codes that take one wavefront a phase: " + ", ".join(
        f"{c} {v:.4f} ms" for c, v in calm_ms.items()) + f"; on this run's codes {ms:.4f} ms | {smi}")
    sms, mhz = sm_rate()
    lookups = float(q) * n * m
    floor4 = lookups / (sms * 32 * mhz * 1e6) * 1e3
    waves = k8_wavefronts(codes, k) * -(-q // 4)
    floor16 = waves / (sms * mhz * 1e6) * 1e3
    log("bound", f"{name}'s shared-memory lookup floor: Q n m = {lookups:.4g} 4-byte table lookups "
        f"at 32 a clock an SM, {sms} SMs x {mhz:.0f} MHz = {floor4:.4f} ms; K8 at "
        f"{floor4 / ms:.3f} of it. Its 16-byte design on this run's codes: {waves:.4g} "
        f"wavefronts ({waves / (lookups / 32):.3f} a 32-lookup warp load) at one a clock an SM = "
        f"{floor16:.4f} ms; K8 at {floor16 / ms:.3f} of it | {smi}")
    return calm_ms


def profile_paths(smi, corpus, queries, main, prec, rqres, ivfpq, flat):
    """Each call of the precision, PQ search and RQ paths, the IVF
    trainers and adds that K1 dominates, and the IVF-Flat / IVF-SQ and
    IVF-PQ searches, once warm,
    then once under ``torch.profiler`` (up to three times, where it
    recorded no device activity): wall time (host clock to a
    synchronize), device time (the device activities' own time summed),
    busy share (device over wall, the profiler's host cost included), the
    three kernels that took most of it, K7's launches by stage and K8's
    time and share where they ran."""
    import vq_tpu_torch

    rq, ivf, pq, codes = rqres["rq"], rqres["ivf"], prec["pq"], prec["codes"]
    pqi, fl, sq = ivfpq["index"], flat["indexes"]["flat_f32"], flat["indexes"]["sq"]
    calls = {
        "ProductQuantizer train 100k, 10 iterations": lambda: vq_tpu_torch.ProductQuantizer(
            corpus[:N_TRAIN], M, K, max_iters=10, device=corpus.device),
        "PQIndex.add 1M (exact)": lambda: vq_tpu_torch.PQIndex(pq).add(corpus),
        "IVFPQIndex.train 200k": lambda: vq_tpu_torch.IVFPQIndex.train(
            corpus[:N_IVF_TRAIN], NLIST, M, K, max_iters=10, keep_corpus=True),
        "IVFPQIndex.add 1M (fresh index)": lambda: vq_tpu_torch.IVFPQIndex(
            pqi.coarse, pqi.pq, keep_corpus=True).add(corpus),
        "IVFFlatIndex.add 1M f32 (fresh index)": lambda: vq_tpu_torch.IVFFlatIndex(fl.coarse).add(corpus),
        "IVFFlatIndex.add 1M bf16 (fresh index)": lambda: vq_tpu_torch.IVFFlatIndex(
            fl.coarse, store_dtype="bfloat16").add(corpus),
        "IVFSQIndex.add 1M (fresh index)": lambda: vq_tpu_torch.IVFSQIndex(sq.coarse, sq.sq).add(corpus),
        "RQ train 200k, 8x256": lambda: vq_tpu_torch.ResidualQuantizer(
            corpus[:N_IVF_TRAIN], RQ_STAGES, K, max_iters=RQ_ITERS, seed=1),
        "RQIndex.add 1M (fresh index)": lambda: vq_tpu_torch.RQIndex(rq).add(corpus),
        "IVFRQIndex.add 1M (fresh index)": lambda: vq_tpu_torch.IVFRQIndex(ivf.coarse, rq).add(corpus),
        "PQIndex.add precision=high 1M": lambda: vq_tpu_torch.PQIndex(pq).add(corpus, precision="high"),
        "PQIndex.add precision=default 1M": lambda: vq_tpu_torch.PQIndex(pq).add(
            corpus, precision="default"),
        "adc_distances [128, 1M]": lambda: pq.adc_distances(queries, codes),
        "PQIndex.search k=10": lambda: main["index"].search(queries, k=10),
        "PQIndex.search k=10 rerank=100": lambda: main["index"].search(queries, k=10, rerank=100),
    }
    for name, (idx, kw) in rqres["searches"].items():
        calls[f"{name} search"] = lambda idx=idx, kw=kw: idx.search(queries, **kw)
    for name, p in flat["searches"]:
        idx = flat["indexes"][name]
        calls[f"{name} search nprobe={p}"] = lambda idx=idx, p=p: idx.search(queries, k=10, nprobe=p)
    for p in NPROBES:
        calls[f"IVFPQIndex.search nprobe={p}"] = lambda p=p: pqi.search(queries, k=10, nprobe=p)
    for name, fn in calls.items():
        profile_line(smi, name, fn)


def profile_line(smi, name, fn, sort_keys=(), warm=True):
    """One call of ``fn`` once warm (``warm=False``: no warm-up call), then
    once under ``torch.profiler`` (up
    to three times, where it recorded no device activity): one
    ``[profile]`` line of wall time, device time, busy share, the three
    kernels that took most of it, K2's sums stage, K7's launches by stage
    and K8's time and share where they ran, and the share of the kernels
    whose names hold one of ``sort_keys``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    if warm:
        fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then records no device activity: again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # (the vq_tpu_torch.* spans of utils.metrics.trace are ranges, not kernels)
        evts = [e for e in prof.key_averages()
                if e.device_type == cuda and not e.key.startswith("vq_tpu_torch.")]
        if evts:
            break
    dev = sum(e.self_device_time_total for e in evts) / 1e3
    top = sorted(evts, key=lambda e: -e.self_device_time_total)[:3]
    stages = stage_times(evts)
    k2 = ("; K2's sums stage: " + ", ".join(
        f"{s} {stages[s][0]:.3f} ms x{stages[s][1]:g}" for s in ("sums", "combine") if s in stages)
        if "sums" in stages else "")
    k8 = [e for e in evts if "adc_lookup_kernel" in e.key]
    k8_ms = sum(e.self_device_time_total for e in k8) / 1e3
    k8 = (f"; K8 {k8_ms:.3f} ms x{sum(e.count for e in k8)}, {k8_ms / dev:.2f} of the device time"
          if k8 else "")
    k7 = (stage_times(evts, K7_STAGES) if any("ivf_probe_kernel" in e.key for e in evts)
          else {})
    k7 = ("; K7: " + ", ".join(f"{s} {ms:.4f} ms x{n:g}" for s, (ms, n) in k7.items())
          if k7 else "")
    sorts = [e for e in evts if any(key in e.key for key in sort_keys)]
    sort_ms = sum(e.self_device_time_total for e in sorts) / 1e3
    sorts = (f"; sort kernels {sort_ms:.3f} ms x{sum(e.count for e in sorts)}, "
             f"{sort_ms / dev if dev else 0.0:.2f} of the device time" if sort_keys else "")
    log("profile", f"{name}: wall {wall:.3f} ms, device {dev:.3f} ms, busy {dev / wall:.2f}; "
        + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top)
        + k2 + k7 + k8 + sorts + f" | {smi}")


def host_line(smi, name, fn, top: int = 8):
    """One warm call of ``fn`` under ``torch.profiler`` on the host: one
    ``[host]`` line of its wall and the operators that took most of the
    host's time (self CPU time, with their call counts)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    log("host", f"{name}: wall {wall:.3f} ms; " + ", ".join(
        f"{e.key[:40]} {e.self_cpu_time_total / 1e3:.3f} ms x{e.count}" for e in ops) + f" | {smi}")


def make_bench_data(device):
    """The benchmark twins' operands, seeded uniform data on the card."""
    import torch

    from vq_tpu_torch.benchmarks.mpacked_encode import build_w

    g = torch.Generator(device=device).manual_seed(SEED)
    x = torch.rand(N_CORPUS, DIM, generator=g, device=device)
    cb = torch.rand(M, K, DIM // M, generator=g, device=device)
    w, cc = build_w(cb)
    tables = torch.rand(N_QUERY, M, K, generator=g, device=device)
    codes = torch.randint(0, K, (N_CORPUS, M), generator=g, device=device,
                          dtype=torch.int32).to(torch.uint8)
    return dict(x=x, cb=cb, w=w, cc=cc, tables=tables, codes=codes, codes_t=codes.T.contiguous(),
                weights=torch.rand(N_IVF_TRAIN, generator=g, device=device) * 1.5 + 0.25)


def phase_bench_kernels(bd, corpus, kres):
    """B1-B4 held to their plain versions (and B1 to K4, B2 and B3 to K8)
    on the card; K2 with weights at both of its shapes twice and against
    its plain version, bit for bit."""
    import torch

    from vq_tpu_torch.benchmarks import adc_vmem_bench as av
    from vq_tpu_torch.benchmarks import mpacked_encode as mp
    from vq_tpu_torch.ops import cuda_kernels as ck

    cb, w, cc = bd["cb"], bd["w"], bd["cc"]
    x = bd["x"][:B1_ROWS]
    par = mp.kernel_parity(x, w, cc, mp.mpacked_encode(x, w, cc, "highest"), "highest")
    assert par.ok, f"B1 highest: {par.flips} codes differ from the plain version"
    # On build_w's operands the products are K4's times the exact -2, in
    # K4's order, and the zero entries add exactly: K4's codes, at the
    # main path's 1M rows.
    full, k4 = mp.mpacked_encode(bd["x"], w, cc, "highest"), ck.pq_encode_fused(bd["x"], cb)
    assert torch.equal(full, k4), f"B1 highest: {int((full != k4).sum())} codes differ from K4's"
    log("kernels", f"B1 mpacked_encode highest {tuple(x.shape)} x W {tuple(w.shape)}: bit-identical "
        f"to the plain version; at {tuple(bd['x'].shape)} bit-identical to K4")
    errs = {"highest": par.max_gap}
    del full, k4
    for tag, xx, ww in (("f32", x, w), ("bf16-resident", x.to(torch.bfloat16), w.to(torch.bfloat16))):
        got = mp.mpacked_encode(xx, ww, cc, "default")
        par = mp.kernel_parity(xx, ww, cc, got, "default")
        assert par.ok, (
            f"B1 default {tag}: {par.match} of the codes equal the plain version's (at least "
            f"{mp.MIN_MATCH}); {par.flips} differ, max float64 gap {par.max_gap}")
        errs["default"] = max(errs.get("default", 0.0), par.max_gap)
        k4b = ck.pq_encode_fused(xx, cb, precision="bf16_fast")
        log("kernels", f"B1 mpacked_encode default {tag} {tuple(xx.shape)}: {par.match:.6f} of the "
            f"codes equal the plain version's, {par.flips} differ, all float64 near ties (max gap "
            f"{par.max_gap:.3g}); {float((got == k4b).float().mean()):.6f} equal K4-bf16's")

    tables, codes, codes_t = bd["tables"], bd["codes"], bd["codes_t"]
    k8 = ck.adc_lookup_fused(tables, codes)
    outs = {"adc_kt": av.adc_kt(tables, codes_t), "adc_gather": av.adc_gather(tables, codes_t),
            "adc_floor": av.adc_floor(tables, codes_t),
            "adc_gather(only=1)": av.adc_gather(tables, codes_t, only=1)}
    torch.cuda.synchronize()
    plains = {"adc_kt": av.adc_kt_plain(tables, codes_t),
              "adc_gather": av.adc_gather_plain(tables, codes_t),
              "adc_floor": av.adc_floor_plain(tables, codes_t),
              "adc_gather(only=1)": av.adc_gather_plain(tables, codes_t, only=1)}
    for name, out in outs.items():
        assert torch.equal(out, plains[name]), f"{name}: values differ from the plain version"
    for name in ("adc_kt", "adc_gather"):
        assert torch.equal(outs[name], k8), f"{name}: values differ from K8's"
    log("kernels", f"B2 adc_kt, B3 adc_gather (all subspaces and only=1), B4 adc_floor: tables "
        f"{tuple(tables.shape)} x codes_t {tuple(codes_t.shape)} u8: bit-identical to their plain "
        "versions; B2 and B3 bit-identical to K8 on the same codes")
    del outs, plains, k8

    x2, wt = corpus[:N_IVF_TRAIN], bd["weights"]
    for tag, cents in k2_shapes(kres).items():
        first = ck.lloyd_accumulate_fused(x2, cents, wt)
        again = ck.lloyd_accumulate_fused(x2, cents, wt)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, again)), (
            f"weighted K2 {tag} is not deterministic")
        want = ck.lloyd_accumulate_plain(x2, cents, wt)
        diffs = [int((a != b).sum()) for a, b in zip(first, want)]
        assert all(torch.equal(a, b) for a, b in zip(first, want)), (
            f"weighted K2 {tag}: {diffs} sums / counts / inertia differ from the plain version")
        log("kernels", f"K2 lloyd_accumulate with weights {tag}: bit-identical to the weighted plain "
            "version and on a second run")
    return errs


def phase_bench_path():
    """The twins' ``main()`` at their default sizes, in this process: the
    slice's main path. Returns the launch counts of that run."""
    from vq_tpu_torch.benchmarks import adc_vmem_bench as av
    from vq_tpu_torch.benchmarks import mpacked_encode as mp

    reset_counts()
    lines = []
    for name, mod in (("mpacked_encode", mp), ("adc_vmem_bench", av)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert mod.main([]) == 0, name
        for text in buf.getvalue().splitlines():
            rec = json.loads(text)
            log("bench", f"{name}: {text}")
            assert rec.get("parity", True) is True, f"{name}: parity failed in {text}"
            lines.append(rec)
    launches = read_counts()
    on_path = ("mpacked_encode[highest]", "mpacked_encode[default]", "adc_kt", "adc_gather", "adc_floor")
    log("bench", f"launches in the twins' run: {launches}")
    assert all(launches[n] > 0 for n in on_path), f"a kernel was not launched: {launches}"
    return launches


def phase_bench_timings(smi, bd, k8_calm):
    """B1 beside K4 / K4-bf16 / K4-bf16x3 at 1M; B2, B3, B4 beside K8 and
    ``embedding_bag`` at [128, 1M], B3 also beside ``k8_calm`` (K8 on
    codes that cost one wavefront a phase, :func:`k8_floors`); plain
    versions at their checks' sizes."""
    import torch

    from vq_tpu_torch.benchmarks import adc_vmem_bench as av
    from vq_tpu_torch.benchmarks import mpacked_encode as mp
    from vq_tpu_torch.ops import cuda_kernels as ck

    x, cb, w, cc = bd["x"], bd["cb"], bd["w"], bd["cc"]
    xh, wh, xs = x.to(torch.bfloat16), w.to(torch.bfloat16), x[:B1_ROWS]
    t = {
        "B1_highest": (cuda_ms(lambda: mp.mpacked_encode(x, w, cc, "highest"), 3),
                       cuda_ms(lambda: mp.mpacked_encode_plain(xs, w, cc, "highest"), 1)),
        "B1_default": (cuda_ms(lambda: mp.mpacked_encode(x, w, cc, "default"), 10),
                       cuda_ms(lambda: mp.mpacked_encode_plain(xs, w, cc, "default"), 1)),
        "B1_bf16resident": (cuda_ms(lambda: mp.mpacked_encode(xh, wh, cc, "default"), 10), None),
        "K4@bench": (cuda_ms(lambda: ck.pq_encode_fused(x, cb), 5), None),
        "K4_bf16@bench": (cuda_ms(lambda: ck.pq_encode_fused(x, cb, precision="bf16_fast"), 5), None),
        "K4_bf16x3@bench": (cuda_ms(lambda: ck.pq_encode_fused(x, cb, precision="bf16x3"), 3), None),
    }
    for name, (ms, pms) in t.items():
        plain = "" if pms is None else f", plain {pms:.4f} ms on {B1_ROWS} rows"
        log("time", f"{name} {N_CORPUS} x {DIM} vs {M}x{K}: kernel {ms:.4f} ms{plain} | {smi}")
    tables, codes, codes_t = bd["tables"], bd["codes"], bd["codes_t"]
    q, m, k = tables.shape
    weight = tables.permute(1, 2, 0).reshape(m * k, q).contiguous()
    index = (codes.long() + torch.arange(m, device=codes.device) * k).contiguous()
    lib = cuda_ms(lambda: torch.nn.functional.embedding_bag(index, weight, mode="sum"), 20)
    adc = {
        "K8@bench": (lambda: ck.adc_lookup_fused(tables, codes), lambda: ck.adc_lookup_plain(tables, codes)),
        "B2_adc_kt": (lambda: av.adc_kt(tables, codes_t), lambda: av.adc_kt_plain(tables, codes_t)),
        "B3_adc_gather": (lambda: av.adc_gather(tables, codes_t),
                          lambda: av.adc_gather_plain(tables, codes_t)),
        "B4_adc_floor": (lambda: av.adc_floor(tables, codes_t),
                         lambda: av.adc_floor_plain(tables, codes_t)),
    }
    for name, (fn, plain_fn) in adc.items():
        t[name] = (cuda_ms(fn, 20), cuda_ms(plain_fn, 2), lib)
        log("time", f"{name} [{q}, {N_CORPUS}] from {m}x{k} tables: kernel {t[name][0]:.4f} ms, plain "
            f"{t[name][1]:.4f} ms, embedding_bag {lib:.4f} ms | {smi}")
    t["B3_only1"] = (cuda_ms(lambda: av.adc_gather(tables, codes_t, only=1), 20), None)
    calm = ", ".join(f"{c} {v:.4f} ms" for c, v in k8_calm.items())
    log("time", f"B3_adc_gather [{q}, {N_CORPUS}]: {t['B3_adc_gather'][0]:.4f} ms (only=1 "
        f"{t['B3_only1'][0]:.4f} ms) beside K8 {t['K8@bench'][0]:.4f} ms on the same operands, K8 on "
        f"codes that cost one wavefront a phase ({calm}; phase 11's tables) and embedding_bag "
        f"{lib:.4f} ms | {smi}")
    return t


def gather_floor(smi, bd, ms):
    """B3's shared-memory floor at the twin's shape: the wavefronts its
    lane map takes on this run's codes (:func:`adc_vmem_bench.gather_wavefronts`,
    one block's schedule over all rows, a query group's lookups) times the
    query groups, at one a clock an SM; beside K8's 16-byte design on the
    same codes by the same count. Returns the floor in ms."""
    import torch

    from vq_tpu_torch.benchmarks import adc_vmem_bench as av

    tables, codes_t = bd["tables"], bd["codes_t"]
    q, m, k = tables.shape
    plan = av.gather_plan(q, m, k, codes_t.shape[1])
    waves = av.gather_wavefronts(codes_t, plan)
    k8 = av.gather_wavefronts(codes_t, plan, lane_map="k8")
    sms, mhz = sm_rate()
    total = float(waves.sum()) * plan["groups"]
    total8 = float(k8.sum()) * -(-q // 4)
    floor, floor8 = total / (sms * mhz * 1e6) * 1e3, total8 / (sms * mhz * 1e6) * 1e3
    log("bound", f"adc_gather's shared-memory floor by its wavefront model: {plan['groups']} query "
        f"groups of {plan['queries']} x {waves.numel()} phases, {float(waves.double().mean()):.4f} "
        f"wavefronts a phase (most {int(waves.max())}), {total:.6g} wavefronts at one a clock an SM, "
        f"{sms} SMs x {mhz:.0f} MHz = {floor:.4f} ms, B3 at {floor / ms:.3f} of it; K8's lane map on "
        f"the same codes {float(k8.double().mean()):.4f} a phase, {total8:.6g} wavefronts = "
        f"{floor8:.4f} ms | {smi}")
    del waves, k8
    torch.cuda.empty_cache()
    return floor


EVAL_CLIS = ("bq", "sq", "pq", "tsvq")


def _eval_rows(mod, argv):
    """``(rows, wall s)`` of one harness ``main(argv)``, its stdout parsed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines()], time.perf_counter() - t0


def phase_eval_path(smi):
    """The four harnesses' ``main()`` at the reference grid's width (1M x
    384, every other flag at its default, plus ``--recall``): rows parsed
    and finite, K3's and K4's launches read from ``eval_pq``'s run, and
    their operands there recorded."""
    import importlib as il
    import math

    argv = ["--sizes", str(EVAL_ROWS), "--dim", str(EVAL_DIM), "--recall"]
    out = {"rows": {}, "wall": {}, "launches": {}}
    reset_counts()
    with recording("vq_tpu_torch.ops.kmeans", "pq_lloyd_accumulate_fused") as k3_calls, \
            recording("vq_tpu_torch.models.pq", "pq_encode_fused") as k4_calls:
        for name in EVAL_CLIS:
            before = read_counts()
            (rec,), wall = _eval_rows(il.import_module(f"vq_tpu_torch.cli.eval_{name}"), argv)
            log("eval", f"eval_{name}: {json.dumps(rec)}")
            assert rec["num_samples"] == EVAL_ROWS and rec["dim"] == EVAL_DIM, rec
            assert math.isfinite(rec["mse"]) and math.isfinite(rec["recall_at_k"]), rec
            out["rows"][name], out["wall"][name] = rec, wall
            out["launches"][name] = {k: v - before[k] for k, v in read_counts().items() if v != before[k]}
            log("time", f"eval_{name} {EVAL_ROWS} x {EVAL_DIM}: main() {wall:.3f} s, train "
                f"{rec['train_ms']:.3f} ms, encode {rec['encode_ms']:.3f} ms, encode by CUDA events "
                f"{rec.get('encode_ms_device')} ms, mse {rec['mse']:.9g}, recall@10 "
                f"{rec['recall_at_k']:.4f}; launches {out['launches'][name]} | {smi}")
        out["k3_args"], out["k4_args"] = k3_calls[-1][0], k4_calls[-1][0]
    on_path = out["launches"]["pq"]
    assert on_path.get("pq_lloyd_accumulate_fused", 0) > 0, on_path
    assert on_path.get("pq_encode_fused[highest]", 0) > 0, on_path
    assert not any(out["launches"][n] for n in ("bq", "sq", "tsvq")), out["launches"]
    return out


def phase_eval_checks(smi, ev):
    """K3 (on 100k of the eval rows) and K4 (on all 1M) at the eval's
    16x256x24 against their plain versions, bit for bit; BQ codes, words
    and a [128, 1M] Hamming block against the CPU copies; TSVQ leaf ids of
    100k rows against the CPU run (near ties counted), and the device
    build against the CPU's (bit for bit) and the host recursion's (every
    differing split a float near tie)."""
    import numpy as np
    import torch

    from vq_tpu_torch.cli.common import generate_synthetic_data
    from vq_tpu_torch.models import bq as tbq
    from vq_tpu_torch.models import tsvq as tt
    from vq_tpu_torch.ops import cuda_kernels as ck

    x, cb = ev["k4_args"][:2]
    k4 = ck.pq_encode_fused(x, cb)
    torch.cuda.synchronize()
    assert torch.equal(k4, ck.pq_encode_plain(x, cb)), "K4 at the eval shape differs from its plain version"
    x3, cb3 = ev["k3_args"][0][:EVAL_K3_ROWS], ev["k3_args"][1]
    got = ck.pq_lloyd_accumulate_fused(x3, cb3)
    torch.cuda.synchronize()
    want = ck.pq_lloyd_accumulate_plain(x3, cb3)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "K3 at the eval shape differs"
    m, k, s = cb.shape
    log("kernels", f"K4 {tuple(x.shape)} x {m}x{k}x{s} (eval_pq's codebooks) and K3 on {EVAL_K3_ROWS} of "
        "its rows: bit-identical to their plain versions")
    out = {"k3": (x3, cb3), "k4": (x, cb)}
    del k4, got, want

    data = generate_synthetic_data(EVAL_ROWS, EVAL_DIM, 66)  # eval_bq's corpus
    q = tbq.BinaryQuantizer(0.5)
    host = data.cpu()
    codes, packed = q.quantize(data), q.quantize_packed(data)
    assert torch.equal(codes.cpu(), q.quantize(host)), "BQ codes differ from the CPU's"
    assert torch.equal(packed.cpu(), q.quantize_packed(host)), "BQ words differ from the CPU's"
    ham, ham_ms = cuda_once(lambda: tbq.hamming_distance(packed[:EVAL_QUERIES], packed))
    t0 = time.perf_counter()
    ham_cpu = tbq.hamming_distance(packed[:EVAL_QUERIES].cpu(), packed.cpu())
    cpu_s = time.perf_counter() - t0
    assert torch.equal(ham.cpu(), ham_cpu), "the Hamming block differs from the CPU's"
    log("eval", f"BQ {tuple(data.shape)}: codes, uint32 words {tuple(packed.shape)} and the Hamming "
        f"block {tuple(ham.shape)} equal the CPU's bit for bit; Hamming block {ham_ms:.3f} ms on the "
        f"card (first call), {cpu_s:.2f} s on the CPU | {smi}")
    del data, host, codes, packed, ham, ham_cpu

    rows = generate_synthetic_data(EVAL_TSVQ_ROWS, EVAL_DIM, 66, device=False)
    t0 = time.perf_counter()
    host_tree = tt.tsvq_build(rows, 5, device="cpu")
    host_s = time.perf_counter() - t0
    card = ev["k4_args"][0].device
    rows_card = torch.from_numpy(rows).to(card)
    dev_tree, dev_ms = cuda_once(lambda: tt.tsvq_build_batched(rows_card, 5))
    t0 = time.perf_counter()
    cpu_tree = tt.tsvq_build_batched(rows, 5, device="cpu")
    cpu_s = time.perf_counter() - t0
    same = (torch.equal(dev_tree.left.cpu(), cpu_tree.left) and torch.equal(dev_tree.right.cpu(), cpu_tree.right)
            and torch.equal(dev_tree.centroids.cpu(), cpu_tree.centroids))
    assert same, "the card's device build differs from the same build on the CPU"
    diffs = tt.split_differences(rows, host_tree, dev_tree)
    for node, da, db, va, vb in diffs:
        log("eval", f"TSVQ split of host node {node}: dim {da} (summed deviation {va:.9g}) against "
            f"dim {db} ({vb:.9g}), relative gap {abs(va - vb) / max(va, vb):.3g}")
        assert abs(va - vb) <= TSVQ_TIE_RTOL * max(va, vb), "a differing split that is no near tie"
    topo = (torch.equal(dev_tree.left.cpu(), host_tree.left)
            and torch.equal(dev_tree.right.cpu(), host_tree.right))
    cgap = (float((dev_tree.centroids.cpu() - host_tree.centroids).abs().max()) if topo else None)
    log("eval", f"TSVQ device build {tuple(rows.shape)} depth 5: {dev_tree.num_nodes} nodes, bit-identical to "
        f"the same build on the CPU; against the host recursion {len(diffs)} differing splits, topology "
        f"{'equal' if topo else 'differs'}, centroids within {cgap}")
    log("time", f"TSVQ build {tuple(rows.shape)} depth 5: device build {dev_ms:.3f} ms on the card (CUDA "
        f"events, first call), {cpu_s:.3f} s on the CPU; host recursion {host_s:.3f} s | {smi}")
    xe = generate_synthetic_data(EVAL_TSVQ_ENCODE, EVAL_DIM, 67)
    card_q = tt.TSVQ(tree=host_tree.to(card))
    leaves = card_q.encode(xe).cpu()
    want = tt.TSVQ(tree=host_tree).encode(xe.cpu())
    gaps = tt.descent_gaps(host_tree, xe.cpu(), leaves, want)
    for gap in gaps:
        log("eval", f"TSVQ leaf differs from the CPU's at a relative distance gap of {gap:.3g}")
    assert (gaps <= TSVQ_TIE_RTOL).all(), f"TSVQ leaves differ beyond a near tie: {gaps}"
    log("eval", f"TSVQ encode {tuple(xe.shape)} on the card: {int(gaps.size)} of {xe.shape[0]} leaf ids "
        f"differ from the CPU run's, all float near ties (max gap {float(gaps.max(initial=0.0)):.3g})")
    out["tsvq_build_ms"], out["tsvq_host_s"] = dev_ms, host_s
    return out


def phase_eval_timings(smi, checks):
    """K3 and K4 at the eval's 16x256x24 beside their plain versions, with
    their floors; then a ``torch.profiler`` line a harness (one more
    ``main()`` each)."""
    import importlib as il

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vq_tpu_torch.ops import cuda_kernels as ck

    (x3, cb3), (x4, cb4) = checks["k3"], checks["k4"]
    t = {"K3_eval": (cuda_ms(lambda: ck.pq_lloyd_accumulate_fused(x3, cb3), 10),
                     cuda_ms(lambda: ck.pq_lloyd_accumulate_plain(x3, cb3), 2)),
         "K4_eval": (cuda_ms(lambda: ck.pq_encode_fused(x4, cb4), 5),
                     cuda_ms(lambda: ck.pq_encode_plain(x4, cb4), 1))}
    m, k, s = cb4.shape
    sms, mhz = sm_rate()
    for name, n in (("K3_eval", x3.shape[0]), ("K4_eval", x4.shape[0])):
        floor = 2.0 * n * m * k * s / (sms * 128 * mhz * 1e6) * 1e3
        log("time", f"{name} {n} x {m}x{k}x{s}: kernel {t[name][0]:.4f} ms, plain {t[name][1]:.4f} ms; "
            f"floor under its exact contract {floor:.4f} ms, {floor / t[name][0]:.3f} of it | {smi}")
    argv = ["--sizes", str(EVAL_ROWS), "--dim", str(EVAL_DIM), "--recall"]
    cuda = torch.autograd.DeviceType.CUDA
    for name in EVAL_CLIS:
        mod = il.import_module(f"vq_tpu_torch.cli.eval_{name}")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = _eval_rows(mod, argv)
            torch.cuda.synchronize()
        # (the vq_tpu_torch.* spans of utils.metrics.trace are ranges, not kernels)
        evts = [e for e in prof.key_averages()
                if e.device_type == cuda and not e.key.startswith("vq_tpu_torch.")]
        dev = sum(e.self_device_time_total for e in evts) / 1e3
        top = sorted(evts, key=lambda e: -e.self_device_time_total)[:3]
        log("profile", f"eval_{name} main() {EVAL_ROWS} x {EVAL_DIM} --recall: wall {wall * 1e3:.1f} ms, "
            f"device {dev:.3f} ms, busy {dev / (wall * 1e3):.3f}; "
            + ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top)
            + f" | {smi}")
    return t


def _apart_parity(got, want, atol, name, rtol=FLAT_RTOL):
    """``got`` ``(ids, values)`` against ``want`` (as wide or wider): values
    within ``rtol`` / ``atol``, ids equal at every rank whose value lies
    farther than that from every other value of ``want``'s row. Returns
    the number of ranks held by id."""
    import torch

    gi, gd = (t.cpu() for t in got)
    wi, wd = (t.cpu() for t in want)
    k = gi.shape[1]
    gd, wd = gd.double(), wd.double()
    err = float(torch.where(torch.isfinite(wd[:, :k]), (gd - wd[:, :k]).abs(), 0.0).max())
    assert bool(torch.isclose(gd, wd[:, :k], rtol=rtol, atol=atol).all()), (
        f"{name}: values differ by up to {err:.3g}")
    fin = torch.where(torch.isfinite(wd), wd, 1e30)
    close = (fin[:, :, None] - fin[:, None, :]).abs() <= atol + rtol * fin[:, None, :].abs()
    apart = (close.sum(-1) == 1)[:, :k]
    bad = int((apart & (gi.long() != wi[:, :k].long())).sum())
    assert bad == 0, f"{name}: {bad} ids differ at separated ranks"
    return int(apart.sum())


def phase_flat_serving(smi, corpus, queries, main, rqres):
    """Phase 14, the flat serving layer through the public entry points at
    1M x 128: ``FlatIndex`` at three storage widths and five metrics with
    ``range_search``, ``range_search`` and ``_search_core`` of the phase-4
    PQ and phase-10 RQ indexes (K8's launches read from that run, held bit
    for bit to the plain route), ``SQIndex`` (SQ8, rerank, dot),
    ``BinaryIndex`` (Hamming, rerank) and ``knn_graph``; CPU checks on
    FLAT_CPU_QUERIES queries, CUDA-event times and four profiler lines."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.convert import from_state, state_of
    from vq_tpu_torch.models.bq import hamming_distance

    t, recall = {}, {}
    q8, q8c, corpus_cpu = queries[:FLAT_CPU_QUERIES], queries[:FLAT_CPU_QUERIES].cpu(), corpus.cpu()
    gt11 = _ground_truth(corpus, queries, k=11)
    gt_d = ((corpus[gt11].double() - queries[:, None].double()) ** 2).sum(-1)

    # FlatIndex, squared L2 at f32 / bf16 / f16: recall@10 against the
    # ground truth; f32 held to its float64 distances.
    flat = {}
    for storage in FLAT_STORAGES:
        idx = vq_tpu_torch.FlatIndex.from_data(corpus, storage=storage)
        ids, d = idx.search(queries, k=10)
        _check_search(f"FlatIndex {storage}", ids, d)
        recall[f"flat {storage}"] = _recall(ids, gt11[:, :10])
        t[f"FlatIndex {storage} search"] = cuda_ms(lambda: idx.search(queries, k=10), 3)
        if storage == "float32":
            held = _apart_parity((ids, d), (gt11, gt_d), FLAT_ATOL["squared_euclidean"],
                                 "FlatIndex f32 against the ground truth")
            flat["squared_euclidean"] = (idx, ids, d)
        del idx
    assert recall["flat float32"] >= FLAT_MIN_RECALL_EXACT, recall
    log("flat", f"FlatIndex f32 / bf16 / f16 (squared L2, k=10): recall@10 " + ", ".join(
        f"{recall[f'flat {s}']:.4f}" for s in FLAT_STORAGES) + f"; f32 ids equal the ground "
        f"truth's at {held} of {N_QUERY * 10} ranks (the separated ones), values within "
        f"{FLAT_ATOL['squared_euclidean']} of its float64 distances")

    # Five metrics at f32, each held to the same index on the CPU.
    cpu_flat = {}
    for metric in FLAT_METRICS:
        if metric not in flat:
            idx = vq_tpu_torch.FlatIndex.from_data(corpus, metric=metric)
            ids, d = idx.search(queries, k=10)
            _check_search(f"FlatIndex {metric}", ids, d, descending=metric == "dot")
            flat[metric] = (idx, ids, d)
            t[f"FlatIndex {metric} search"] = cuda_ms(lambda: idx.search(queries, k=10), 1)
        idx, ids, d = flat[metric]
        cpu = vq_tpu_torch.FlatIndex.from_data(corpus_cpu, metric=metric)
        cpu_flat[metric] = cpu
        held = _apart_parity((ids[:FLAT_CPU_QUERIES], d[:FLAT_CPU_QUERIES]),
                             cpu.search(q8c, k=10), FLAT_ATOL[metric], f"FlatIndex {metric}")
        log("flat", f"FlatIndex {metric} (chunk {idx._default_chunk(None)}): {FLAT_CPU_QUERIES} "
            f"queries equal the CPU's at {held} of {FLAT_CPU_QUERIES * 10} ranks (the separated "
            f"ones), values within {FLAT_ATOL[metric]}")
    dot_ids = flat["dot"][1]

    # range_search with a radius from the 10th distances: hits within it,
    # the matching prefix of search, counts equal to the CPU's.
    idx, ids, d = flat["squared_euclidean"]
    radius = float(d[:, 9].median())
    rids, rvals, counts = idx.range_search(queries, radius, max_results=10)
    hit = rids >= 0
    assert bool((rvals[hit] <= radius).all()), "range_search: a hit beyond the radius"
    assert torch.equal(rids, torch.where(hit, ids, -1)), "range_search: not the prefix of search"
    assert torch.equal(torch.where(hit, rvals, 0.0), torch.where(hit, d, 0.0))
    assert torch.equal(hit.sum(1), counts.clamp_max(10)), "range_search: hits and counts disagree"
    cpu_counts = cpu_flat["squared_euclidean"].range_search(q8c, radius, max_results=10)[2]
    tol = FLAT_ATOL["squared_euclidean"] + FLAT_RTOL * radius
    lo, hi = (cpu_flat["squared_euclidean"].range_search(q8c, radius + s, max_results=1)[2]
              for s in (-tol, tol))
    card = counts[:FLAT_CPU_QUERIES].cpu()
    assert bool(((card >= lo) & (card <= hi)).all()), (card, cpu_counts, lo, hi)
    n_equal = int((card == cpu_counts).sum())
    t["FlatIndex f32 range_search"] = cuda_ms(
        lambda: idx.range_search(queries, radius, max_results=10), 3)
    log("flat", f"range_search radius {radius:.6g} (the median 10th distance), max_results 10: "
        f"hits within the radius and equal to the prefix of search; counts {counts.min().item()}"
        f"-{counts.max().item()}; the CPU's counts for {FLAT_CPU_QUERIES} queries equal the "
        f"card's at {n_equal} ({int((hi - lo).sum())} values within {tol:.3g} of the radius)")
    del cpu_flat

    # PQ and RQ range_search, squared L2 and cosine: K8 a chunk.
    pq = main["pq"]
    pq_idx = {}
    for metric in ("squared_euclidean", "cosine"):
        i = vq_tpu_torch.PQIndex(vq_tpu_torch.ProductQuantizer(
            codebooks=pq.codebooks, distance=metric, device=corpus.device))
        i._codes = main["index"]._codes  # the phase-4 codes, searched under this metric
        pq_idx[f"pq {metric}"] = i
    pq_idx["rq squared_euclidean"] = rqres["indexes"]["l2"]
    pq_idx["rq cosine"] = rqres["indexes"]["cosine"]
    radii = {name: float(i.search(queries, k=10)[1][:, 9].median()) for name, i in pq_idx.items()}
    reset_counts()
    ranged = {name: i.range_search(queries, radii[name], max_results=10)
              for name, i in pq_idx.items()}
    torch.cuda.synchronize()
    k8_range = read_counts()["adc_lookup_fused"]
    chunks = -(-N_CORPUS // RQ_CHUNK)
    assert k8_range == chunks * 5, f"K8 ran {k8_range} times in the range searches"
    with plain_route():
        plain = {name: i.range_search(queries, radii[name], max_results=10)
                 for name, i in pq_idx.items()}
    for name, got in ranged.items():
        for a, b in zip(got, plain[name]):
            assert torch.equal(a, b), f"{name} range_search differs from the plain route"
        # at the median 10th distance, half the queries or more have 10 hits
        assert int((got[2] >= 10).sum()) >= N_QUERY // 2, name
        assert bool((got[1][got[0] >= 0] <= radii[name]).all()), name
        t[f"{name} range_search"] = cuda_ms(
            lambda i=pq_idx[name], r=radii[name]: i.range_search(queries, r, max_results=10), 3)
    cores = {"pq": (main["index"], dict()), "pq rerank": (main["index"], dict(rerank=100)),
             "rq": (rqres["indexes"]["l2"], dict()),
             "rq rerank": (rqres["indexes"]["l2"], dict(rerank=RQ_RERANK))}
    for name, (i, kw) in cores.items():
        fn, arrays = i._search_core(10, **kw)
        got, want = fn(queries, *arrays), i.search(queries, k=10, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), name
    log("flat", f"PQ (phase 4's codes) and RQ (phase 10) range_search, squared L2 and cosine, "
        f"radius the median 10th distance: K8 launched {k8_range} times ({chunks} chunks a scan, "
        f"twice for PQ cosine's norms), every result equal to the plain route's; "
        f"_search_core's fn equals search for " + ", ".join(cores) + " (torch.equal)")

    # SQIndex, SQ8 per dimension: k=10, rerank from the kept corpus, dot.
    sq = vq_tpu_torch.SQIndex.from_data(corpus, keep_corpus=True)
    sq_dot = vq_tpu_torch.SQIndex(sq.sq, metric="dot")
    sq_dot._codes, sq_dot._row_sqn = sq._codes, sq._row_sqn  # the same codes
    sq_calls = {"SQIndex k=10": (sq, dict(k=10)), f"SQIndex rerank={SQ_RERANK}": (
        sq, dict(k=10, rerank=SQ_RERANK)), "SQIndex dot": (sq_dot, dict(k=10))}
    sq_cpu = {"SQIndex dot": from_state(*state_of(sq_dot), device="cpu")}
    sq_cpu["SQIndex k=10"] = sq_cpu[f"SQIndex rerank={SQ_RERANK}"] = from_state(
        *state_of(sq), device="cpu")
    n_diff = int((sq_cpu["SQIndex k=10"].sq.quantize(corpus_cpu) != sq._codes.cpu()).sum())
    assert n_diff == 0, f"{n_diff} SQ8 codes of the card differ from the CPU's quantize"
    del corpus_cpu
    for name, (i, kw) in sq_calls.items():
        ids, d = i.search(queries, **kw)
        dot = "dot" in name
        _check_search(name, ids, d, descending=dot)
        recall[name] = _recall(ids, dot_ids if dot else gt11[:, :10])
        atol = FLAT_ATOL["dot" if dot else "squared_euclidean"]
        held = _apart_parity((ids[:FLAT_CPU_QUERIES], d[:FLAT_CPU_QUERIES]),
                             sq_cpu[name].search(q8c, **kw), atol, name)
        t[name] = cuda_ms(lambda i=i, kw=kw: i.search(queries, **kw), 3)
        log("flat", f"{name}: codes equal the CPU's quantize of the 1M rows; recall@10 "
            f"{recall[name]:.4f} (dot: against the exact dot top-10); "
            f"{FLAT_CPU_QUERIES} queries equal the CPU's at {held} of {FLAT_CPU_QUERIES * 10} "
            f"ranks, values within {atol}")
    del sq_cpu

    # BinaryIndex: Hamming counts bit for bit against the CPU's.
    bi = vq_tpu_torch.BinaryIndex(DIM, keep_corpus=True)
    bi.add(corpus)
    ham = hamming_distance(bi.bq.quantize_packed(q8), bi._packed)
    ham_cpu = hamming_distance(bi.bq.quantize_packed(q8c), bi._packed.cpu())
    assert torch.equal(ham.cpu(), ham_cpu), "BinaryIndex: Hamming counts differ from the CPU's"
    for name, kw in (("BinaryIndex k=10", dict(k=10)),
                     (f"BinaryIndex rerank={BQ_RERANK}", dict(k=10, rerank=BQ_RERANK))):
        ids, d = bi.search(queries, **kw)
        _check_search(name, ids, d)
        recall[name] = _recall(ids, gt11[:, :10])
        t[name] = cuda_ms(lambda kw=kw: bi.search(queries, **kw), 3)
    log("flat", f"BinaryIndex ({bi._packed.shape[1]} words a row): the [{FLAT_CPU_QUERIES}, "
        f"{N_CORPUS}] Hamming counts equal the CPU's bit for bit; recall@10 " + ", ".join(
            f"{n}: {recall[n]:.4f}" for n in recall if n.startswith("BinaryIndex")))

    # knn_graph over the first KNN_ROWS rows, held to FlatIndex.search(k + 1)
    # less the self-match on sampled rows.
    sub = corpus[:KNN_ROWS]
    (g_ids, g_vals), t_knn = cuda_once(lambda: vq_tpu_torch.knn_graph(
        sub, k=KNN_K, query_batch=KNN_BATCH))
    assert tuple(g_ids.shape) == (KNN_ROWS, KNN_K) and bool(torch.isfinite(g_vals).all())
    rows = torch.randperm(KNN_ROWS, generator=torch.Generator().manual_seed(SEED))[:KNN_SAMPLE]
    rows = rows.to(corpus.device)
    s_ids, s_vals = vq_tpu_torch.FlatIndex.from_data(sub).search(sub[rows], k=KNN_K + 1)
    keep = s_ids != rows[:, None].to(torch.int32)
    assert bool((keep.sum(1) == KNN_K).all()), "a sampled row's self-match is not in its top 11"
    want = (s_ids[keep].view(KNN_SAMPLE, KNN_K), s_vals[keep].view(KNN_SAMPLE, KNN_K))
    held = _apart_parity((g_ids[rows], g_vals[rows]), want, FLAT_ATOL["squared_euclidean"],
                         "knn_graph")
    same = int((g_ids[rows] == want[0]).all(1).sum())
    t["knn_graph"] = cuda_ms(lambda: vq_tpu_torch.knn_graph(sub, k=KNN_K, query_batch=KNN_BATCH), 1)
    log("flat", f"knn_graph {KNN_ROWS} x {DIM}, k={KNN_K}, query_batch {KNN_BATCH}: first call "
        f"{t_knn:.1f} ms; {KNN_SAMPLE} sampled rows equal FlatIndex.search(k={KNN_K + 1}) less the "
        f"self-match at {held} of {KNN_SAMPLE * KNN_K} ranks (separated), {same} rows whole")

    for name, ms in t.items():
        log("time", f"{name} {N_QUERY} queries: {ms:.4f} ms, {N_QUERY / ms * 1e3:.6g} QPS | {smi}"
            if name != "knn_graph" else f"knn_graph {KNN_ROWS} rows: {ms:.4f} ms, "
            f"{KNN_ROWS / ms * 1e3:.6g} rows/s | {smi}")
    f32 = flat["squared_euclidean"][0]
    for name, fn in (("FlatIndex f32 search k=10", lambda: f32.search(queries, k=10)),
                     ("SQIndex search k=10", lambda: sq.search(queries, k=10)),
                     ("BinaryIndex search k=10", lambda: bi.search(queries, k=10)),
                     (f"knn_graph {KNN_ROWS} rows", lambda: vq_tpu_torch.knn_graph(
                         sub, k=KNN_K, query_batch=KNN_BATCH))):
        profile_line(smi, name, fn, SORT_KERNELS)
    return k8_range


def phase_mips_opq(smi, corpus, queries):
    """Phase 15, score-aware quantization and OPQ through the public entry
    points on the phase-4 mixture: ``AnisotropicProductQuantizer`` 8x256
    (K3, the refine, K4 and the sweeps) with ``encode`` of 1M and
    ``mips_search`` (K5 ``"dot"``); ``IVFPQIndex.train(metric="dot")``
    with anisotropic codes (IVF1024: K1, K2, K3, K4, then K7 over negated
    dot tables) at nprobe 8 / 64 and rerank 0 / 500, and one residual dot
    index (K7 with the ``q.c`` offset); ``OPQQuantizer`` 8x256 (K3, K4,
    then K5 ``"sum"``). Launch counts read from the run, every result held
    to the plain route on the same card, recall@10 against the exact dot
    top-10 (``FlatIndex(metric="dot")``) or the L2 ground truth (OPQ);
    K5 ``"dot"`` and K7 held to their plain versions on the operands the
    searches gave them; CUDA-event times and profiler lines."""
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.models.pq_anisotropic import pq_refine_anisotropic
    from vq_tpu_torch.ops import cuda_kernels as ck

    dot_gt = vq_tpu_torch.FlatIndex.from_data(corpus, metric="dot").search(queries, k=10)[0]
    gt = _ground_truth(corpus, queries)
    train, opq_rows = corpus[:N_TRAIN], corpus[:OPQ_ROWS]
    by_path, recall, t = {}, {}, {}

    def counted(name, fn):
        before = read_counts()
        out, ms = cuda_once(fn)
        after = read_counts()
        by_path[name] = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        return out, ms

    reset_counts()
    apq, t["aniso train"] = counted("aniso train", lambda: vq_tpu_torch.AnisotropicProductQuantizer(
        train, M, K, max_iters=10, threshold=ANISO_THRESHOLD, refine_iters=ANISO_REFINE,
        device=corpus.device))
    codes, t["aniso encode"] = counted("aniso encode", lambda: apq.encode(corpus))
    with recording("vq_tpu_torch.models.pq_anisotropic", "adc_scan_topk_fused") as k5_calls:
        mips, t["mips_search"] = counted("mips_search", lambda: apq.mips_search(queries, codes, k=10))
    ivf, t["ivf dot train"] = counted("ivf dot train", lambda: vq_tpu_torch.IVFPQIndex.train(
        corpus[:N_IVF_TRAIN], NLIST, M, K, max_iters=10, metric="dot",
        anisotropic_threshold=ANISO_THRESHOLD, refine_iters=ANISO_REFINE, keep_corpus=True))
    _, t["ivf dot add"] = counted("ivf dot add", lambda: ivf.add(corpus))
    res, t["ivf dot residual train"] = counted("ivf dot residual train", lambda:
                                               vq_tpu_torch.IVFPQIndex.train(
        corpus[:N_IVF_TRAIN], NLIST, M, K, max_iters=10, metric="dot", by_residual=True))
    _, t["ivf dot residual add"] = counted("ivf dot residual add", lambda: res.add(corpus))
    searches = {f"ivf dot nprobe={p} rerank={r}": (ivf, dict(k=10, nprobe=p, rerank=r))
                for p in NPROBES for r in RERANKS}
    searches[f"ivf dot residual nprobe={NPROBES[0]}"] = (res, dict(k=10, nprobe=NPROBES[0]))
    out = {}
    with recording("vq_tpu_torch.ivf", "ivf_probe_adc_fused") as k7_calls:
        for name, (idx, kw) in searches.items():
            out[name], _ = counted(name, lambda idx=idx, kw=kw: idx.search(queries, **kw))
    opq, t["opq train"] = counted("opq train", lambda: vq_tpu_torch.OPQQuantizer(
        opq_rows, M, K, opq_iters=OPQ_ITERS, pq_iters=OPQ_PQ_ITERS, device=corpus.device))
    opq_codes, t["opq encode"] = counted("opq encode", lambda: opq.encode(corpus))
    opq_out, t["opq adc_search"] = counted("opq adc_search",
                                           lambda: opq.adc_search(queries, opq_codes, k=10))
    plain_pq = vq_tpu_torch.ProductQuantizer(opq_rows, M, K, max_iters=10, device=corpus.device)
    torch.cuda.synchronize()
    launches = read_counts()
    log("mips", f"launches in the mips / opq path: {launches}; by call: {by_path}")
    for name, need in (("aniso train", "pq_lloyd_accumulate_fused"), ("aniso encode", "pq_encode_fused"),
                       ("mips_search", "adc_scan_topk_fused"), ("ivf dot train", "assign_fused"),
                       ("ivf dot train", "lloyd_accumulate_fused"),
                       ("ivf dot train", "pq_lloyd_accumulate_fused"), ("ivf dot add", "assign_fused"),
                       ("ivf dot add", "pq_encode_fused"), ("opq train", "pq_lloyd_accumulate_fused"),
                       ("opq train", "pq_encode_fused"), ("opq adc_search", "adc_scan_topk_fused")):
        assert by_path[name].get(need, 0) > 0, f"{name}: {need} was not launched: {by_path[name]}"
    for name in searches:
        assert by_path[name].get("ivf_probe_adc_fused") == 1, (name, by_path[name])

    # The plain route on the same card: training, codes and searches.
    with plain_route():
        apq_p = vq_tpu_torch.AnisotropicProductQuantizer(
            train, M, K, max_iters=10, threshold=ANISO_THRESHOLD, refine_iters=ANISO_REFINE,
            device=corpus.device)
        codes_p = apq.encode(corpus)
        mips_p = apq.mips_search(queries, codes, k=10)
        lists_p, _ = vq_tpu_torch.assign(corpus, ivf.coarse)
        ivf_codes_p = ivf.pq.encode(corpus)
        res_lists_p, _ = vq_tpu_torch.assign(corpus, res.coarse)
        want = {name: idx.search(queries, **kw) for name, (idx, kw) in searches.items()}
        opq_p = vq_tpu_torch.OPQQuantizer(opq_rows, M, K, opq_iters=OPQ_ITERS,
                                          pq_iters=OPQ_PQ_ITERS, device=corpus.device)
        opq_codes_p = opq.encode(corpus)
        opq_want = opq.adc_search(queries, opq_codes, k=10)
    assert torch.equal(apq_p.codebooks, apq.codebooks), "anisotropic training differs from the plain route"
    assert torch.equal(codes_p, codes), "anisotropic codes differ from the plain route"
    _check_search("mips_search", *mips, descending=True)
    _parity(mips, mips_p, "mips_search")
    flips, gap = _near_ties(corpus, ivf.coarse, ivf._flat_lists, lists_p)
    assert flips == 0 and torch.equal(ivf._pool.to_flat()["codes"], ivf_codes_p), (
        "dot IVF-PQ codes differ from the plain route")
    assert torch.equal(res._flat_lists, res_lists_p), "residual dot IVF-PQ lists differ"
    for name, (ids, scores) in out.items():
        _check_search(name, ids, scores, descending=True)
        _parity((ids, scores), want[name], name)
        recall[name] = _recall(ids, dot_gt)
    assert torch.equal(opq_p.rotation, opq.rotation) and torch.equal(
        opq_p.codebooks, opq.codebooks), "OPQ training differs from the plain route"
    assert torch.equal(opq_codes_p, opq_codes), "OPQ codes differ from the plain route"
    _check_search("opq adc_search", *opq_out)
    _parity(opq_out, opq_want, "opq adc_search")
    recall["mips_search"] = _recall(mips[0], dot_gt)
    recall["opq adc_search"] = _recall(opq_out[0], gt)
    mse_opq = float(((opq.decode(opq_codes) - corpus) ** 2).mean())
    mse_pq = float(((plain_pq.decode(plain_pq.encode(corpus)) - corpus) ** 2).mean())
    orth = float((opq.rotation.T @ opq.rotation - torch.eye(DIM, device=corpus.device)).abs().max())
    assert orth < 1e-4, orth
    p_lo, p_hi = NPROBES
    assert recall[f"ivf dot nprobe={p_hi} rerank={RERANKS[-1]}"] >= recall[
        f"ivf dot nprobe={p_lo} rerank=0"], recall
    log("mips", f"trained {apq!r} in {t['aniso train'] / 1e3:.4f} s, encoded 1M in "
        f"{t['aniso encode']:.4f} ms; training, codes and mips_search equal the plain route's; "
        f"dot IVF-PQ {ivf!r} trained in {t['ivf dot train'] / 1e3:.4f} s, added 1M in "
        f"{t['ivf dot add']:.4f} ms, lists, codes and every search equal the plain route's; "
        f"{opq!r} trained ({OPQ_ITERS} rounds x {OPQ_PQ_ITERS} Lloyd iterations on {OPQ_ROWS} rows) "
        f"in {t['opq train'] / 1e3:.4f} s, rotation orthogonal to {orth:.3g}, training, codes and "
        f"adc_search equal the plain route's; reconstruction MSE of the 1M rows: OPQ {mse_opq:.9g}, "
        f"plain PQ (same rows, 10 iterations) {mse_pq:.9g}; recall@10 (dot: against the exact dot "
        f"top-10; OPQ: the L2 ground truth) " + ", ".join(f"{n}: {v:.4f}" for n, v in recall.items()))

    # K5 "dot" and K7 over dot tables against their plain versions.
    args, kw = k5_calls[0]
    got, again = ck.adc_scan_topk_fused(*args, **kw), ck.adc_scan_topk_fused(*args, **kw)
    torch.cuda.synchronize()
    want5 = ck.adc_scan_topk_plain(*args, **kw)
    assert kw.get("mode") == "dot" and all(torch.equal(a, b) for a, b in zip(got, want5)) and all(
        torch.equal(a, b) for a, b in zip(got, again)), "K5 dot: differs from its plain version"
    log("kernels", f"K5 adc_scan_topk mode='dot' tables {tuple(args[0].shape)} x codes "
        f"{tuple(args[1].shape)} fetch {args[2]} (mips_search's operands): bit-identical, twice")
    k7 = {}
    for (a7, kw7), name in zip(k7_calls, searches):
        if "rerank=500" in name:
            continue
        got7 = ck.ivf_probe_adc_fused(*a7, **kw7)
        torch.cuda.synchronize()
        assert torch.equal(got7, ck.ivf_probe_adc_plain(*a7, **kw7)), f"K7 {name}: values differ"
        assert bool((a7[0] <= 0).any() & (a7[0] >= 0).any()), "K7: tables are not signed dots"
        k7[name] = (a7, kw7)
        log("kernels", f"K7 ivf_probe_adc over negated dot tables ({name}): {a7[0].shape[0]} pairs x "
            f"{a7[1].shape[1]} chunks: bit-identical")

    # Times: kernel route beside the plain route, by CUDA events.
    cb0 = vq_tpu_torch.pq_train(train, M, K, max_iters=10)
    refine = lambda: pq_refine_anisotropic(train, cb0, threshold=ANISO_THRESHOLD, iters=ANISO_REFINE)
    r1, r2 = refine(), refine()
    assert all(torch.equal(a, b) for a, b in zip(r1, r2)), "the refine is not the same bits twice"
    assert torch.equal(r1[0], apq.codebooks), "the refine differs from the quantizer's"
    timed = {"refine 100k, 5 rounds": refine,
             "encode 1M": lambda: apq.encode(corpus),
             "mips_search k=10": lambda: apq.mips_search(queries, codes, k=10),
             "opq_train 200k, 6 x 3": lambda: vq_tpu_torch.opq_train(
                 opq_rows, M, K, opq_iters=OPQ_ITERS, pq_iters=OPQ_PQ_ITERS)}
    timed.update({f"{n} search": (lambda idx=idx, kw=kw: idx.search(queries, **kw))
                  for n, (idx, kw) in searches.items()})
    for name, fn in timed.items():
        reps = 1 if name.startswith(("refine", "opq")) else 5
        ms = cuda_ms(fn, reps)
        with plain_route():
            pms = cuda_ms(fn, 1)
        t[name] = (ms, pms)
        rec = next((f"; recall@10 {v:.4f}" for n, v in recall.items() if name.startswith(n)), "")
        log("time", f"{name}: {ms:.4f} ms, plain route {pms:.4f} ms{rec} | {smi}")
    for name, fn in timed.items():
        profile_line(smi, name, fn)
    return dict(launches=launches, by_path=by_path, recall=recall, t=t, k7=k7,
                mse=(mse_opq, mse_pq))

def _widths(idx, queries):
    """The padded width of an IVF index's probe: list sizes (max / mean),
    ``cap``, the chunks a probed pair reads (the chain width every pair is
    cut to) against its live ones at the top nprobe, and the bytes of the
    probe's ``[P, nc * ch]`` f32 output (K6's or K7's) at nprobe 64."""
    from vq_tpu_torch.ivf_flat import _coarse_probe

    st = idx.bucket_stats()
    pool = idx._pool
    chains = pool.chains_search()
    probe, _ = _coarse_probe(queries, idx.coarse, NPROBES[-1], idx.metric)
    live = float((chains[probe] >= 0).sum(-1).float().mean())
    return {"max": st["max"], "mean": st["mean"], "max/mean": st["max"] / st["mean"],
            "cap": st["cap"], "nlist": st["nlist"], "chunks a pair": int(chains.shape[1]),
            "live chunks a pair": live,
            "out bytes nprobe64": N_QUERY * NPROBES[-1] * chains.shape[1] * pool.ch * 4}


def _same_pool(a, b, name):
    """Two indexes' lists, centroids and pools, bit for bit."""
    import torch

    pa, pb = a._pool, b._pool
    assert torch.equal(a.coarse, b.coarse), f"{name}: centroids differ"
    assert torch.equal(a._flat_lists, b._flat_lists), f"{name}: lists differ"
    assert (pa._chains_h == pb._chains_h).all() and (pa.lens_h == pb.lens_h).all(), f"{name}: chains"
    assert torch.equal(pa.slot_ids, pb.slot_ids) and torch.equal(
        pa.pos[:pa.n_rows], pb.pos[:pb.n_rows]), f"{name}: slots differ"
    for n in pa.specs:
        assert torch.equal(pa.data[n].view(torch.int32) if pa.data[n].dtype == torch.uint32 else pa.data[n],
                           pb.data[n].view(torch.int32) if pb.data[n].dtype == torch.uint32 else pb.data[n]), (
            f"{name}: payload {n} differs")


def phase_maintenance(smi, corpus, queries, gt):
    """Phase 16, IVF maintenance and IVF-Binary through the public entry
    points on the phase-4 mixture at IVF1024, on indexes of its own:
    ``rebalance`` (default target) of IVF-Flat f32 and IVF-PQ with the
    padded widths, search times and recall@10 at nprobe 8 / 64 before and
    after; ``remove_ids`` of every 10th row and ``merge_from`` of two 500k
    halves of IVF-Flat, each bit for bit the index built from the same rows
    directly; ``range_search`` of both rebalanced indexes at nprobe 8 at the
    median 10th-NN distance; ``IVFBinaryIndex`` (IVF1024 on 200k rows, 1M
    added with its corpus) at nprobe 8 / 64 and rerank 0 / 100, its
    ``range_search`` and ``rebalance``. Launch counts of K1, K2, K4, K6 and
    K7 read from that run; every rebalance, search and range held bit for
    bit to the plain route on the card (the binary searches, plain PyTorch
    everywhere, to the CPU on FLAT_CPU_QUERIES queries); CUDA-event times
    and two profiler lines."""
    import copy

    import torch

    import vq_tpu_torch
    from vq_tpu_torch.convert import from_state, state_of

    train = corpus[:N_IVF_TRAIN]
    by_path, t, recall, widths, out, info, wall = {}, {}, {}, {}, {}, {}, {}

    def counted(name, fn):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall[name] = (time.perf_counter() - t0) * 1e3
        after = read_counts()
        by_path[name] = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        return res

    reset_counts()
    idx = {"ivf-flat": counted("ivf-flat train", lambda: vq_tpu_torch.IVFFlatIndex.train(
               train, NLIST, max_iters=10)),
           "ivf-pq": counted("ivf-pq train", lambda: vq_tpu_torch.IVFPQIndex.train(
               train, NLIST, M, K, max_iters=10))}
    for n, i in idx.items():
        counted(f"{n} add", lambda i=i: i.add(corpus))
    pre = {n: copy.deepcopy(i) for n, i in idx.items()}  # the plain route's copies
    before = {n: copy.deepcopy(i) for n, i in idx.items()}  # the timings' copies
    coarse0 = idx["ivf-flat"].coarse.clone()
    for phase in ("before", "after"):
        for n, i in idx.items():
            if phase == "after":
                info[n] = counted(f"{n} rebalance", i.rebalance)
            widths[(n, phase)] = _widths(i, queries)
            for p in NPROBES:
                out[(n, phase, p)] = counted(f"{n} {phase} nprobe={p}",
                                             lambda i=i, p=p: i.search(queries, k=10, nprobe=p))
    d10 = float(((queries - corpus[gt[:, 9]]) ** 2).sum(-1).median())
    rng = {n: counted(f"{n} range", lambda i=i: i.range_search(queries, d10, nprobe=NPROBES[0]))
           for n, i in idx.items()}

    # remove_ids / merge_from on IVF-Flat against direct builds.
    rem = vq_tpu_torch.IVFFlatIndex(coarse0)
    counted("remove add", lambda: rem.add(corpus))
    gone = torch.arange(0, N_CORPUS, 10, device=corpus.device)
    n_gone = counted("ivf-flat remove_ids", lambda: rem.remove_ids(gone))
    half = N_CORPUS // 2
    merged, other = vq_tpu_torch.IVFFlatIndex(coarse0), vq_tpu_torch.IVFFlatIndex(coarse0)
    counted("merge adds", lambda: (merged.add(corpus[:half]), other.add(corpus[half:])))
    n_moved = counted("ivf-flat merge_from", lambda: merged.merge_from(other))
    edited = {n: {p: counted(f"{n} search nprobe={p}", lambda i=i, p=p: i.search(queries, k=10, nprobe=p))
                  for p in NPROBES} for n, i in (("removed", rem), ("merged", merged))}

    # IVFBinaryIndex.
    b = counted("ivf-binary train", lambda: vq_tpu_torch.IVFBinaryIndex.train(
        train, NLIST, max_iters=10, keep_corpus=True))
    counted("ivf-binary add", lambda: b.add(corpus))
    b_pre = copy.deepcopy(b)
    bout = {(p, r): counted(f"ivf-binary nprobe={p} rerank={r}",
                            lambda p=p, r=r: b.search(queries, k=10, nprobe=p, rerank=r))
            for p in NPROBES for r in (0, SQ_RERANK)}
    ham10 = float(bout[(NPROBES[0], 0)][1][:, 9].median())
    brng = counted("ivf-binary range", lambda: b.range_search(queries, ham10, nprobe=NPROBES[0]))
    widths[("ivf-binary", "before")] = _widths(b, queries)
    info["ivf-binary"] = counted("ivf-binary rebalance", b.rebalance)
    widths[("ivf-binary", "after")] = _widths(b, queries)
    bafter = counted("ivf-binary after nprobe=8", lambda: b.search(queries, k=10, nprobe=NPROBES[0]))
    torch.cuda.synchronize()
    launches = read_counts()
    log("maint", f"launches in the maintenance path: {launches}; by call: {by_path}")
    for name, need in (("ivf-flat rebalance", "assign_fused"), ("ivf-flat rebalance", "lloyd_accumulate_fused"),
                       ("ivf-pq rebalance", "assign_fused"), ("ivf-pq rebalance", "lloyd_accumulate_fused"),
                       ("ivf-pq rebalance", "pq_encode_fused"), ("ivf-binary rebalance", "assign_fused"),
                       ("ivf-binary rebalance", "lloyd_accumulate_fused"), ("ivf-binary add", "assign_fused"),
                       ("ivf-binary train", "lloyd_accumulate_fused"), ("ivf-flat range", "ivf_probe_matvec_fused"),
                       ("ivf-pq range", "ivf_probe_adc_fused"), ("removed search nprobe=8", "ivf_probe_matvec_fused")):
        assert by_path[name].get(need, 0) > 0, f"{name}: {need} was not launched: {by_path[name]}"
    for n in idx:
        for p in NPROBES:
            kernel = "ivf_probe_matvec_fused" if n == "ivf-flat" else "ivf_probe_adc_fused"
            assert by_path[f"{n} after nprobe={p}"].get(kernel) == 1, (n, p, by_path)
    assert n_gone == len(gone) and n_moved == N_CORPUS - half, (n_gone, n_moved)

    # The plain route on the same card: each rebalance from the same start,
    # the searches and ranges, and the direct builds.
    with plain_route():
        for n in idx:
            assert pre[n].rebalance() == info[n], n
        want = {k: (idx if k[1] == "after" else before)[k[0]].search(queries, k=10, nprobe=k[2])
                for k in out}
        want_rng = {n: idx[n].range_search(queries, d10, nprobe=NPROBES[0]) for n in idx}
        b_plain = copy.deepcopy(b_pre)
        lists_p, _ = vq_tpu_torch.assign(corpus, b_pre.coarse)
        assert b_plain.rebalance() == info["ivf-binary"]
    direct = vq_tpu_torch.IVFFlatIndex(coarse0)
    keep = torch.ones(N_CORPUS, dtype=torch.bool, device=corpus.device)
    keep[gone] = False
    direct.add(corpus[keep])
    whole = vq_tpu_torch.IVFFlatIndex(coarse0)
    whole.add(corpus[:half])
    whole.add(corpus[half:])
    for n in idx:
        _same_pool(idx[n], pre[n], f"{n} rebalance against the plain route")
    _same_pool(b, b_plain, "ivf-binary rebalance against the plain route")
    flips, gap = _near_ties(corpus, b_pre.coarse, b_pre._flat_lists, lists_p)
    assert flips == 0, f"ivf-binary: {flips} lists differ from the plain assign (gap {gap:.3g})"
    for key, (ids, dist) in out.items():
        name = f"{key[0]} {key[1]} rebalance nprobe={key[2]}"
        _check_search(name, ids, dist)
        _parity((ids, dist), want[key], name)
        recall[name] = _recall(ids, gt)
    for n in idx:
        assert all(torch.equal(a, c) for a, c in zip(rng[n], want_rng[n])), f"{n} range differs"
    for n, built in (("removed", direct), ("merged", whole)):
        target = rem if n == "removed" else merged
        assert torch.equal(target._flat_lists, built._flat_lists), f"{n}: lists differ"
        assert torch.equal(target._pool.to_flat()["rows"], built._pool.to_flat()["rows"]), n
        for p in NPROBES:
            got, ref = edited[n][p], built.search(queries, k=10, nprobe=p)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), (n, p)
    _same_pool(merged, whole, "merge_from against the same two adds")  # chunk for chunk

    # IVF-Binary: the card's Hamming searches against the CPU's.
    b_cpu = from_state(*state_of(b_pre), device="cpu")
    q8 = queries[:FLAT_CPU_QUERIES]
    for (p, r), (ids, dist) in bout.items():
        name = f"ivf-binary nprobe={p} rerank={r}"
        assert tuple(ids.shape) == (N_QUERY, 10) and bool((ids >= 0).all()), name
        recall[name] = _recall(ids, gt)
        if r == 0:
            cids, cd = b_cpu.search(q8.cpu(), k=10, nprobe=p)
            assert torch.equal(ids[:FLAT_CPU_QUERIES].cpu(), cids) and torch.equal(
                dist[:FLAT_CPU_QUERIES].cpu(), cd), f"{name}: differs from the CPU"
    crng = b_cpu.range_search(q8.cpu(), ham10, nprobe=NPROBES[0])
    assert all(torch.equal(a[:FLAT_CPU_QUERIES].cpu(), c) for a, c in zip(brng, crng)), "binary range"
    recall["ivf-binary after rebalance nprobe=8"] = _recall(bafter[0], gt)
    del b_cpu

    for key, w in widths.items():
        log("maint", f"{key[0]} {key[1]} rebalance: lists max {w['max']} / mean {w['mean']:.1f} = "
            f"{w['max/mean']:.3f}, nlist {w['nlist']}, cap {w['cap']}, {w['chunks a pair']} chunks a "
            f"probed pair ({w['live chunks a pair']:.2f} live at nprobe {NPROBES[-1]}), the probe's "
            f"[P, nc * ch] f32 output (K6's / K7's for IVF-Flat / IVF-PQ) at nprobe {NPROBES[-1]}: "
            f"{w['out bytes nprobe64']} bytes | {smi}")
    for n, i in list(idx.items()) + [("ivf-binary", b)]:
        log("maint", f"{n} rebalance: {info[n]} in {wall[f'{n} rebalance']:.1f} ms wall, launches "
            f"{by_path[f'{n} rebalance']}; {i!r} | {smi}")
    log("maint", f"remove_ids of every 10th row: {n_gone} removed in {wall['ivf-flat remove_ids']:.1f} ms; "
        f"merge_from of the second half: {n_moved} moved in {wall['ivf-flat merge_from']:.1f} ms; both "
        "equal, bit for bit, the index built from the same rows directly (lists, rows, searches at "
        "nprobe 8 and 64; the merge chunk for chunk)")
    log("maint", f"range_search at nprobe {NPROBES[0]}, radius {d10:.6g} (the median 10th-NN squared "
        f"distance): " + ", ".join(f"{n} counts sum {int(r[2].sum())}, median {float(r[2].float().median()):g}, "
                                   f"max {int(r[2].max())}" for n, r in rng.items())
        + f"; ivf-binary at Hamming radius {ham10:g}: counts sum {int(brng[2].sum())}; every "
        "rebalance, search and range equals the plain route, the binary searches the CPU's")
    log("maint", "recall@10 " + ", ".join(f"{n}: {v:.4f}" for n, v in recall.items()))

    # Times by CUDA events: searches before (on the copies) and after the
    # rebalance, the ranges and the binary searches; the plain route beside
    # the after-rebalance searches and the ranges.
    del pre, b_plain, rem, direct, merged, whole
    timed = {}
    for n in idx:
        for p in NPROBES:
            for phase, i in (("before", before[n]), ("after", idx[n])):
                timed[f"{n} {phase} rebalance nprobe={p}"] = (
                    lambda i=i, p=p: i.search(queries, k=10, nprobe=p))
        timed[f"{n} range nprobe={NPROBES[0]}"] = (lambda i=idx[n]: i.range_search(queries, d10, nprobe=NPROBES[0]))
    for (p, r) in bout:
        timed[f"ivf-binary nprobe={p} rerank={r}"] = (lambda p=p, r=r: b.search(queries, k=10, nprobe=p, rerank=r))
    for name, fn in timed.items():
        ms = cuda_ms(fn, 5)
        pms = None
        if "after" in name or "range" in name:
            with plain_route():
                pms = cuda_ms(fn, 1)
        t[name] = (ms, pms)
        rec = recall.get(name)
        log("time", f"{name}: {ms:.4f} ms" + ("" if pms is None else f", plain route {pms:.4f} ms")
            + ("" if rec is None else f"; recall@10 {rec:.4f}") + f" | {smi}")
    copies = [copy.deepcopy(before["ivf-pq"]) for _ in range(4)]  # profile_line calls fn 2-4 times
    profile_line(smi, "ivf-pq rebalance (default target)", lambda: copies.pop().rebalance())
    profile_line(smi, f"ivf-binary search nprobe={NPROBES[0]}",
                 lambda: b.search(queries, k=10, nprobe=NPROBES[0]), SORT_KERNELS)
    return dict(launches=launches, by_path=by_path, recall=recall, widths=widths, t=t, info=info,
                wall=wall)


def _bin_error(v, r):
    """ITQ's binarization error a row, ``||sign(vR) - vR||^2 / n``."""
    import torch

    z = v @ r
    return float(((torch.where(z >= 0, 1.0, -1.0) - z) ** 2).sum() / v.shape[0])


def _transformed(train):
    """The faiss spec ``PCA64,IVF1024,PQ8``: PCA fitted on the training
    rows, then IVF-PQ trained on their projection."""
    import vq_tpu_torch

    pca = vq_tpu_torch.PCATransform(DIM, PCA_OUT).fit(train)
    base = vq_tpu_torch.IVFPQIndex.train(pca.apply(train), NLIST, M, K, max_iters=10)
    return vq_tpu_torch.TransformedIndex([pca], base)


def _counter(by_path, wall):
    """``counted(name, fn)``: ``fn()``, its host wall (to a synchronize)
    into ``wall[name]`` and the kernel launches it made into
    ``by_path[name]``."""
    import torch

    def counted(name, fn):
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall[name] = (time.perf_counter() - t0) * 1e3
        after = read_counts()
        by_path[name] = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        return res

    return counted


def phase_transforms_refine_serving(smi, corpus, queries, pipe_q, gt, main, ivf, flat):
    """Phase 17, the layer around the indexes, through the public entry
    points on the phase-4 mixture: ``Kmeans`` (k 1024, 20 iterations, 2
    restarts, a 262,144-row sample: K2, then K1) with ``assign`` of the 1M
    rows against ``ops.kmeans.assign`` and ``index.search(x, 1)``; the
    faiss ``PCA64,IVF1024,PQ8`` as a ``TransformedIndex`` (train 200k, add
    1M, nprobe 8 / 64: K1-K4, K7); ``RefineIndex`` over phase 6's
    IVF1024 / PQ 8x256 with the ``"flat"`` f32, ``"sq8"`` and residual PQ
    8x256 refiners (``train_pq``: K1, K4, K3) at k_factor 4, nprobe 8 /
    64; ``itq_train`` to 64 bits ahead of a ``BinaryIndex`` beside a
    random rotation's; ``BatchPipeline`` / ``pipelined_search`` of 8
    batches of 128 queries over phase 7's IVF-Flat (K6), the sq8 refine
    index (K7) and phase 4's ``PQIndex`` (K5) against the per-batch loop,
    and a stale pipeline after ``rebalance()``; ``load_index`` (and
    ``Kmeans.load``) round trips of every new kind under ``build/``.
    Launch counts read from the run; training, codes and searches held bit
    for bit to the plain route on the card; recall@10 against the exact
    ground truth; CUDA-event times and profiler lines."""
    import os
    import shutil

    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops.kmeans import assign as kmeans_assign

    train = corpus[:N_IVF_TRAIN]
    by_path, wall, t, recall = {}, {}, {}, {}
    counted = _counter(by_path, wall)
    reset_counts()
    # Kmeans, and its first restart alone (what the plain route replays).
    km = vq_tpu_torch.Kmeans(DIM, KM_K, niter=KM_ITERS, nredo=KM_REDO, seed=SEED)
    counted("kmeans train", lambda: km.train(corpus))
    km0 = vq_tpu_torch.Kmeans(DIM, KM_K, niter=KM_ITERS, nredo=1, seed=SEED)
    km0.train(corpus)
    dists, labels = counted("kmeans assign", lambda: km.assign(corpus))
    cent = km.index
    nn = counted("kmeans index search", lambda: torch.cat(
        [cent.search(corpus[c:c + 131_072], 1)[0][:, 0] for c in range(0, N_CORPUS, 131_072)]))

    # PCA64,IVF1024,PQ8.
    tr = counted("pca64 train", lambda: _transformed(train))
    counted("pca64 add", lambda: tr.add(corpus))
    tr_out = {p: counted(f"pca64 nprobe={p}", lambda p=p: tr.search(queries, k=10, nprobe=p))
              for p in NPROBES}

    # RefineIndex over phase 6's trained IVF1024 / PQ 8x256.
    base_ivf = ivf["index"]

    def fresh_base():
        return vq_tpu_torch.IVFPQIndex(base_ivf.coarse, base_ivf.pq)

    refs = {"flat": vq_tpu_torch.RefineIndex(fresh_base(), "flat"),
            "sq8": vq_tpu_torch.RefineIndex(fresh_base(), "sq8"),
            "pq": counted("refine train_pq", lambda: vq_tpu_torch.RefineIndex.train_pq(
                fresh_base(), train, M, K, max_iters=10, seed=SEED))}
    for n, r in refs.items():
        counted(f"refine {n} add", lambda r=r: r.add(corpus))
    ref_out = {(n, p): counted(f"refine {n} nprobe={p}", lambda r=r, p=p: r.search(
        queries, k=10, k_factor=K_FACTOR, nprobe=p)) for n, r in refs.items() for p in NPROBES}

    # ITQ to 64 bits against a random rotation, each ahead of a BinaryIndex.
    chain = counted("itq train", lambda: vq_tpu_torch.itq_train(corpus, ITQ_BITS, seed=SEED))
    binaries = {"itq": vq_tpu_torch.TransformedIndex(chain, vq_tpu_torch.BinaryIndex(ITQ_BITS)),
                "random rotation": vq_tpu_torch.TransformedIndex(
                    [vq_tpu_torch.RotationTransform.random(DIM, seed=SEED, d_out=ITQ_BITS,
                                                           device=corpus.device)],
                    vq_tpu_torch.BinaryIndex(ITQ_BITS))}
    bin_out = {}
    for n, b in binaries.items():
        counted(f"{n} binary add", lambda b=b: b.add(corpus))
        bin_out[n] = counted(f"{n} binary search", lambda b=b: b.search(queries, k=10))

    # Pipelines: 8 batches of 128 queries, against the per-batch loop.
    qs = pipe_q.reshape(-1, PIPE_BATCH, DIM)
    served = {"ivf-flat": (flat["indexes"]["flat_f32"], dict(nprobe=NPROBES[0])),
              "refine sq8": (refs["sq8"], dict(nprobe=NPROBES[0], k_factor=K_FACTOR)),
              "pq": (main["index"], {})}
    pipes, pipe_out, loop_out, flat_out = {}, {}, {}, {}
    for n, (idx, kw) in served.items():
        pipes[n] = vq_tpu_torch.BatchPipeline(idx, k=10, **kw)
        pipe_out[n] = counted(f"pipeline {n}", lambda n=n: pipes[n].search(qs))
        loop_out[n] = counted(f"loop {n}", lambda idx=idx, kw=kw: [
            idx.search(qs[b], 10, **kw) for b in range(qs.shape[0])])
        flat_out[n] = counted(f"pipelined_search {n}", lambda idx=idx, n=n: vq_tpu_torch.pipelined_search(
            idx, pipe_q, k=10, batch=PIPE_BATCH, pipeline=pipes[n]))

    # Round trips of every new kind through load_index (Kmeans.load).
    idm = vq_tpu_torch.IdMapIndex(vq_tpu_torch.PQIndex(main["pq"]))
    off = 10 ** 12
    counted("idmap add", lambda: idm.add_with_ids(corpus, torch.arange(N_CORPUS) + off))
    idm_out = counted("idmap search", lambda: idm.search(queries, k=10))
    log("layer", f"launches by call: {by_path}")
    need = [("kmeans train", "lloyd_accumulate_fused"), ("kmeans train", "assign_fused"),
            ("kmeans assign", "assign_fused"), ("pca64 train", "assign_fused"),
            ("pca64 train", "lloyd_accumulate_fused"), ("pca64 train", "pq_lloyd_accumulate_fused"),
            ("pca64 add", "assign_fused"), ("pca64 add", "pq_encode_fused"),
            ("refine train_pq", "assign_fused"), ("refine train_pq", "pq_encode_fused"),
            ("refine train_pq", "pq_lloyd_accumulate_fused"), ("refine flat add", "assign_fused"),
            ("refine flat add", "pq_encode_fused"), ("idmap add", "pq_encode_fused")]
    for name, kernel in need:
        assert by_path[name].get(kernel, 0) > 0, f"{name}: {kernel} was not launched: {by_path[name]}"
    assert by_path["refine pq add"].get("pq_encode_fused", 0) >= 2, by_path["refine pq add"]
    for p in NPROBES:
        assert by_path[f"pca64 nprobe={p}"].get("ivf_probe_adc_fused") == 1, by_path
        for n in refs:
            assert by_path[f"refine {n} nprobe={p}"].get("ivf_probe_adc_fused") == 1, (n, p, by_path)
    nb = qs.shape[0]
    for n, kernel in (("ivf-flat", "ivf_probe_matvec_fused"), ("refine sq8", "ivf_probe_adc_fused"),
                      ("pq", "adc_scan_topk_fused")):
        assert by_path[f"pipeline {n}"].get(kernel) == nb, (n, by_path[f"pipeline {n}"])
    assert by_path["idmap search"].get("adc_scan_topk_fused") == 1, by_path["idmap search"]

    # Checks on the card.
    lab2, d2 = kmeans_assign(corpus, km.centroids)
    assert torch.equal(lab2, labels) and torch.equal(d2, dists), "Kmeans.assign differs from assign"
    flips, gap = _near_ties(corpus, km.centroids, nn, labels)
    assert km0.obj == km.all_objs[0], (km0.obj, km.all_objs)
    assert km.obj == min(km.all_objs) and len(km.all_objs) == KM_REDO
    assert km.result.assignments.shape[0] == KM_K * 256, km.result.assignments.shape
    for p, (ids, dist) in tr_out.items():
        _check_search(f"pca64 nprobe={p}", ids, dist)
        recall[f"PCA64,IVF1024,PQ8 nprobe={p}"] = _recall(ids, gt)
    for (n, p), (ids, dist) in ref_out.items():
        _check_search(f"refine {n} nprobe={p}", ids, dist)
        recall[f"refine {n} nprobe={p}"] = _recall(ids, gt)
    for p in NPROBES:
        recall[f"base IVF1024,PQ8 nprobe={p}"] = ivf["recall"][(p, 0)]
    for n, (ids, dist) in bin_out.items():
        recall[f"{n} binary {ITQ_BITS} bits"] = _recall(ids, gt)
    pca, rot = chain
    v = pca.apply(corpus)
    r0 = vq_tpu_torch.RotationTransform.random(ITQ_BITS, seed=SEED, device=corpus.device).matrix
    err_itq, err_r0 = _bin_error(v, rot.matrix), _bin_error(v, r0)
    assert err_itq < err_r0, (err_itq, err_r0)
    assert torch.allclose(rot.matrix.T @ rot.matrix, torch.eye(ITQ_BITS, device=corpus.device),
                          atol=1e-4)
    for n in served:
        ids, vals = pipe_out[n]
        li = torch.stack([o[0] for o in loop_out[n]])
        lv = torch.stack([o[1] for o in loop_out[n]])
        assert torch.equal(ids, li) and torch.equal(vals, lv), f"pipeline {n} differs from the loop"
        assert torch.equal(flat_out[n][0], ids.reshape(-1, 10)), f"pipelined_search {n}"
    pos = main["index"].search(queries, k=10)[0]
    assert torch.equal(idm_out[0], torch.where(pos >= 0, pos.long() + off, -1)), "idmap ids"

    # The plain route on the same card.
    with plain_route():
        km_p = vq_tpu_torch.Kmeans(DIM, KM_K, niter=KM_ITERS, nredo=1, seed=SEED)
        km_p.train(corpus)
        tr_p = _transformed(train)
        tr_p.add(corpus)
        want_tr = {p: tr.search(queries, k=10, nprobe=p) for p in NPROBES}
        base_p = fresh_base()
        base_p.add(corpus)
        ref_p = vq_tpu_torch.RefineIndex.train_pq(fresh_base(), train, M, K, max_iters=10,
                                                  seed=SEED)
        res_codes_p = ref_p.refine_pq.encode(
            corpus - base_p.reconstruct(torch.arange(N_CORPUS, device=corpus.device)))
        want_ref = {key: refs[key[0]].search(queries, k=10, k_factor=K_FACTOR, nprobe=key[1])
                    for key in ref_out}
        want_pipe = {n: pipes[n].search(qs) for n in served}
    assert km_p.obj == km0.obj and torch.equal(km_p.centroids, km0.centroids), "Kmeans plain route"
    assert torch.equal(tr_p.transforms[0]._components, tr.transforms[0]._components), "PCA"
    _same_pool(tr.base, tr_p.base, "PCA64,IVF1024,PQ8 against the plain route")
    assert torch.equal(tr_p.base.pq.codebooks, tr.base.pq.codebooks), "PCA64 PQ codebooks"
    for p in NPROBES:
        _parity(tr_out[p], want_tr[p], f"pca64 nprobe={p}")
    for n, r in refs.items():
        _same_pool(r.base, base_p, f"refine {n} base against the plain route")
    assert torch.equal(ref_p.refine_pq.codebooks, refs["pq"].refine_pq.codebooks), "train_pq"
    assert torch.equal(res_codes_p, refs["pq"]._codes), "residual refine codes"
    for key, got in ref_out.items():
        _parity(got, want_ref[key], f"refine {key[0]} nprobe={key[1]}")
    for n in served:
        _parity((pipe_out[n][0].reshape(-1, 10), pipe_out[n][1].reshape(-1, 10)),
                (want_pipe[n][0].reshape(-1, 10), want_pipe[n][1].reshape(-1, 10)), f"pipeline {n}")
    del km_p, tr_p, base_p, ref_p, res_codes_p

    # load_index / Kmeans.load round trips, under build/.
    ckdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke_phase17")
    os.makedirs(ckdir, exist_ok=True)
    try:
        back = vq_tpu_torch.Kmeans.load(km.save(os.path.join(ckdir, "kmeans")))
        assert torch.equal(back.centroids, km.centroids) and back.all_objs == km.all_objs
        for n, idx, kw in (("transformed", tr, dict(nprobe=NPROBES[0])),
                           ("refine", refs["pq"], dict(nprobe=NPROBES[0], k_factor=K_FACTOR)),
                           ("idmap", idm, {})):
            loaded = vq_tpu_torch.load_index(idx.save(os.path.join(ckdir, n)))
            assert type(loaded) is type(idx), n
            got, want = loaded.search(queries, 10, **kw), idx.search(queries, 10, **kw)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), f"{n} round trip"
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    log("layer", f"Kmeans(k={KM_K}, niter={KM_ITERS}, nredo={KM_REDO}) on a {KM_K * 256}-row "
        f"sample of 1M: objective by restart {km.all_objs}, kept {km.obj!r}, train "
        f"{wall['kmeans train']:.1f} ms wall; assign of 1M {wall['kmeans assign']:.1f} ms equals "
        f"ops.kmeans.assign; index.search(x, 1) of 1M equals the labels but {flips} float64 near "
        f"ties (max gap {gap:.3g}); restart 0 equals the plain route bit for bit | {smi}")
    log("layer", f"PCA64,IVF1024,PQ8 ({tr!r}): train {wall['pca64 train']:.1f} ms, add 1M "
        f"{wall['pca64 add']:.1f} ms wall; PCA, lists, codes and searches equal the plain route")
    log("layer", "RefineIndex over IVF1024,PQ8 (phase 6's trained parts), k_factor "
        f"{K_FACTOR}: train_pq {wall['refine train_pq']:.1f} ms, adds "
        + ", ".join(f"{n} {wall[f'refine {n} add']:.1f} ms" for n in refs)
        + " wall; bases, residual codebooks and codes, and searches equal the plain route")
    log("layer", f"ITQ to {ITQ_BITS} bits on 1M rows: {wall['itq train']:.1f} ms wall, binarization "
        f"error a row {err_itq:.6g} against its start rotation's {err_r0:.6g}; binary searches "
        + ", ".join(f"{n} {wall[f'{n} binary search']:.1f} ms" for n in binaries))
    log("layer", "pipelines over 8 batches of 128 queries equal the per-batch loop and "
        "pipelined_search bit for bit, and the plain route; idmap ids are the PQ search's plus "
        f"{off}; load_index round trips of transformed_index, refine_index and idmap_index and "
        "Kmeans.load search the same bits")
    log("layer", "recall@10 " + ", ".join(f"{n}: {v:.4f}" for n, v in recall.items()))

    # Times by CUDA events.
    _, t["kmeans train"] = cuda_once(lambda: vq_tpu_torch.Kmeans(
        DIM, KM_K, niter=KM_ITERS, nredo=KM_REDO, seed=SEED).train(corpus))
    log("time", f"Kmeans(k={KM_K}, niter={KM_ITERS}, nredo={KM_REDO}) train: "
        f"{t['kmeans train']:.4f} ms | {smi}")
    timed = {f"PCA64,IVF1024,PQ8 nprobe={p}": (lambda p=p: tr.search(queries, k=10, nprobe=p))
             for p in NPROBES}
    timed.update({f"refine {n} nprobe={p}": (lambda r=r, p=p: r.search(
        queries, k=10, k_factor=K_FACTOR, nprobe=p)) for n, r in refs.items() for p in NPROBES})
    timed.update({f"{n} binary search": (lambda b=b: b.search(queries, k=10))
                  for n, b in binaries.items()})
    for name, fn in timed.items():
        t[name] = cuda_ms(fn, 5)
        rec = recall.get(name) or recall.get(name.replace("search", f"{ITQ_BITS} bits"))
        log("time", f"{name}: {t[name]:.4f} ms" + ("" if rec is None else f"; recall@10 {rec:.4f}")
            + f" | {smi}")
    nq = pipe_q.shape[0]
    for n, (idx, kw) in served.items():
        ms_pipe = cuda_ms(lambda n=n: pipes[n].search(qs), 5)
        ms_loop = cuda_ms(lambda idx=idx, kw=kw: [idx.search(qs[b], 10, **kw) for b in range(nb)], 5)
        t[f"pipeline {n}"], t[f"loop {n}"] = ms_pipe, ms_loop
        log("time", f"{n}: pipeline of {nb} x {PIPE_BATCH} queries {ms_pipe:.4f} ms "
            f"({nq / ms_pipe * 1e3:.0f} QPS), per-batch loop {ms_loop:.4f} ms "
            f"({nq / ms_loop * 1e3:.0f} QPS) | {smi}")
        profile_line(smi, f"pipeline {n} ({nb} x {PIPE_BATCH} queries)", lambda n=n: pipes[n].search(qs),
                     SORT_KERNELS)
        profile_line(smi, f"per-batch loop {n} ({nb} x {PIPE_BATCH} queries)",
                     lambda idx=idx, kw=kw: [idx.search(qs[b], 10, **kw) for b in range(nb)],
                     SORT_KERNELS)
    profile_line(smi, f"Kmeans(k={KM_K}) train", lambda: vq_tpu_torch.Kmeans(
        DIM, KM_K, niter=KM_ITERS, nredo=KM_REDO, seed=SEED).train(corpus))
    profile_line(smi, f"refine flat search nprobe={NPROBES[0]}", lambda: refs["flat"].search(
        queries, k=10, k_factor=K_FACTOR, nprobe=NPROBES[0]), SORT_KERNELS)
    profile_line(smi, f"itq_train to {ITQ_BITS} bits, 1M rows",
                 lambda: vq_tpu_torch.itq_train(corpus, ITQ_BITS, seed=SEED))

    # A stale pipeline after rebalance() (phase 7's IVF-Flat; phase 20 serves it rebalanced).
    stale = pipes["ivf-flat"]
    info = counted("ivf-flat rebalance", served["ivf-flat"][0].rebalance)
    try:
        stale.search(qs)
    except vq_tpu_torch.InvalidData:
        log("layer", f"after rebalance() ({info}) the IVF-Flat pipeline raised InvalidData, as "
            "it must: the pool changed in place")
    else:
        raise AssertionError("a stale pipeline served after rebalance()")
    # The path's launches: the counted calls above, not the comparisons'.
    launches = {}
    for calls in by_path.values():
        for kernel, n in calls.items():
            launches[kernel] = launches.get(kernel, 0) + n
    log("layer", f"launches in phase 17: {launches}")
    return dict(launches=launches, by_path=by_path, recall=recall, t=t, wall=wall,
                objs=km.all_objs, bin_error=(err_itq, err_r0))


def _graph_phase(smi, corpus, queries, gt, counted, recall, t):
    """Phase 18's graph: the 1M build (stages by CUDA events), searches,
    the CPU check, the plain-route build, add and remove."""
    import warnings

    import torch

    import vq_tpu_torch
    import vq_tpu_torch.graph as graph_mod
    from vq_tpu_torch.convert import from_state, state_of
    from vq_tpu_torch.ops import cuda_kernels as ck

    dev = corpus.device
    stages = {}

    def staged(name, fn):
        def run(*a, **kw):
            out, ms = cuda_once(lambda: fn(*a, **kw))
            stages[name] = stages.get(name, 0.0) + ms
            return out
        return run

    saved = {n: getattr(graph_mod, n) for n in ("_candidates", "_prune_all", "_reverse_edges")}
    for n, fn in saved.items():
        setattr(graph_mod, n, staged(n.strip("_"), fn))
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", RuntimeWarning)
            g = counted("graph build", lambda: vq_tpu_torch.GraphIndex.build(
                corpus, degree=GRAPH_DEGREE, exact_threshold=GRAPH_EXACT_THRESHOLD))
    finally:
        for n, fn in saved.items():
            setattr(graph_mod, n, fn)
    assert tuple(g.graph.shape) == (N_CORPUS, 2 * GRAPH_DEGREE)
    assert g.sample.shape[0] == min(4096, N_CORPUS)
    assert bool(((g.graph >= -1) & (g.graph < N_CORPUS)).all())
    rows = torch.arange(N_CORPUS, device=dev)[:, None]
    assert not bool((g.graph[:, :GRAPH_DEGREE] == rows).any()), "a self loop among the forward edges"
    warned = [str(w.message) for w in caught if "cluster concentration" in str(w.message)]
    log("graph", f"GraphIndex.build of {N_CORPUS} x {DIM} (degree {GRAPH_DEGREE}, alpha 1.2, "
        f"exact_threshold {GRAPH_EXACT_THRESHOLD}: IVF-assisted candidates): {t['wall']['graph build']:.1f} ms host wall; stages by CUDA events "
        + ", ".join(f"{n} {ms:.1f} ms" for n, ms in stages.items())
        + f"; regime warning: {warned[0] if warned else 'none'} | {smi}")
    out = {}
    for beam in GRAPH_BEAMS:
        out[beam] = counted(f"graph search beam={beam}",
                            lambda beam=beam: g.search(queries, k=10, beam=beam))
        _check_search(f"graph search beam={beam}", *out[beam])
        recall[f"graph beam={beam}"] = _recall(out[beam][0], gt)
        t[f"graph beam={beam}"] = cuda_ms(lambda beam=beam: g.search(queries, k=10, beam=beam), 3)
    log("graph", "search k=10 of 128 queries: " + ", ".join(
        f"beam {b} recall@10 {recall[f'graph beam={b}']:.4f} in {t[f'graph beam={b}']:.3f} ms"
        for b in GRAPH_BEAMS) + f" (CUDA events) | {smi}")

    # The same graph searched on the CPU.
    kind, config, arrays = state_of(g)
    cpu = from_state(kind, config, arrays, device="cpu")
    qn = queries[:GRAPH_CPU_QUERIES]
    beam = GRAPH_BEAMS[-1]
    held = _apart_parity((out[beam][0][:GRAPH_CPU_QUERIES], out[beam][1][:GRAPH_CPU_QUERIES]),
                         cpu.search(qn.cpu(), k=10, beam=beam), FLAT_ATOL["squared_euclidean"],
                         "graph search against the CPU")
    del cpu, arrays
    log("graph", f"search k=10 at beam {beam} on the card equals the same graph searched on the "
        f"CPU for {GRAPH_CPU_QUERIES} queries ({held} ranks held by id, values within "
        f"{FLAT_ATOL['squared_euclidean']})")

    # The plain route: a build above its exact_threshold, kernel and plain.
    sub = corpus[:GRAPH_PLAIN_ROWS]
    with recording("vq_tpu_torch.ivf_flat", "ivf_probe_matvec_fused") as k6_calls:
        g_k = vq_tpu_torch.GraphIndex.build(sub, exact_threshold=GRAPH_PLAIN_THRESHOLD)
    with plain_route():
        g_p, plain_ms = cuda_once(lambda: vq_tpu_torch.GraphIndex.build(
            sub, exact_threshold=GRAPH_PLAIN_THRESHOLD))
    profile_line(smi, f"GraphIndex.build {GRAPH_PLAIN_ROWS} x {DIM} (IVF-assisted, "
                 f"exact_threshold {GRAPH_PLAIN_THRESHOLD})", lambda: vq_tpu_torch.GraphIndex.build(
                     sub, exact_threshold=GRAPH_PLAIN_THRESHOLD), SORT_KERNELS, warm=False)
    for name in ("graph", "entry", "sample"):
        assert torch.equal(getattr(g_k, name), getattr(g_p, name)), f"the plain route's {name} differs"
    assert torch.equal(g_k._rows, g_p._rows)
    k6_batches = k6_calls[:3]
    for args, kw in k6_batches:
        assert torch.equal(ck.ivf_probe_matvec_fused(*args, **kw), ck.ivf_probe_matvec_plain(*args, **kw))
    log("graph", f"GraphIndex.build of {GRAPH_PLAIN_ROWS} rows (exact_threshold "
        f"{GRAPH_PLAIN_THRESHOLD}) on the plain route ({plain_ms:.1f} ms) equals the kernel route's "
        f"adjacency, entries and sample bit for bit; K6 equals its plain version on the operands of "
        f"{len(k6_batches)} of the sweep's {len(k6_calls)} batches")
    del g_k, g_p, k6_calls, k6_batches

    # add, then remove_ids, of GRAPH_EDIT rows, recall after each.
    gn = torch.Generator(device=dev).manual_seed(SEED + 2)
    new = (corpus[torch.randint(0, N_CORPUS, (GRAPH_EDIT,), generator=gn, device=dev)]
           + 0.1 * torch.randn(GRAPH_EDIT, DIM, generator=gn, device=dev))
    counted("graph add", lambda: g.add(new))
    union = torch.cat([corpus, new])
    ids, dist = g.search(queries, k=10, beam=beam)
    recall["graph after add"] = _recall(ids, _ground_truth(union, queries))
    drop = torch.arange(0, N_CORPUS, N_CORPUS // GRAPH_EDIT, device=dev)
    assert counted("graph remove_ids", lambda: g.remove_ids(drop)) == GRAPH_EDIT
    keep = torch.ones(union.shape[0], dtype=torch.bool, device=dev)
    keep[drop] = False
    assert g.ntotal == N_CORPUS and torch.equal(g.reconstruct(torch.arange(4, device=dev)),
                                                union[keep][:4])
    ids, dist = g.search(queries, k=10, beam=beam)
    _check_search("graph search after remove_ids", ids, dist)
    recall["graph after remove"] = _recall(ids, _ground_truth(union[keep], queries))
    log("graph", f"add of {GRAPH_EDIT} rows {t['wall']['graph add']:.1f} ms, remove_ids of "
        f"{GRAPH_EDIT} {t['wall']['graph remove_ids']:.1f} ms host wall | {smi}")
    return g


def _log_tune(smi, spec, best, front):
    log("tune", f"{spec}: tune(target_recall={TUNE_TARGET}) -> {best.params}, recall "
        f"{best.recall:.4f}, {best.time_ms:.3f} ms a batch, {best.qps:.0f} QPS; the Pareto frontier "
        "of the points it measured " + ", ".join(
            f"{p.params} {p.recall:.4f} @ {p.time_ms:.3f} ms" for p in front)
        + f" (host clock to the ids' copy) | {smi}")


def phase_last_modules(smi, corpus, queries, gt, main):
    """Phase 18, the last single-device modules, through the public entry
    points on the phase-4 mixture: ``GraphIndex`` (:func:`_graph_phase`),
    ``lloyd_stepped`` with a checkpoint and a resume, ``lloyd_minibatch``
    and ``pq_minibatch_update`` over one epoch, ``index_factory``
    pipelines and ``tune``. Launches read from the run by call and by path
    (``graph``, ``kmeans_stream``, ``factory``); the mini-batch steps, the
    graph build and two factory pipelines held to the plain route bit for
    bit; recall@10 against the exact ground truth; CUDA-event times and
    ``[profile]`` lines."""
    import math
    import os
    import shutil

    import numpy as np
    import torch

    import vq_tpu_torch
    from vq_tpu_torch.ops.kmeans import kmeans_plusplus_init_device
    from vq_tpu_torch.ops.kmeans_stream import pq_minibatch_update
    from vq_tpu_torch.utils.metrics import MetricsLogger
    from vq_tpu_torch.utils.serialize import load_kmeans_state

    by_path, wall, recall = {}, {}, {}
    t = {"wall": wall}
    counted = _counter(by_path, wall)
    reset_counts()
    g = _graph_phase(smi, corpus, queries, gt, counted, recall, t)
    profile_line(smi, "GraphIndex.search 128 q over 1M, k=10, beam=64",
                 lambda: g.search(queries, k=10, beam=64), SORT_KERNELS)

    # lloyd_stepped: 20 iterations, and 10 + a resume from the checkpoint at 10.
    train = corpus[:N_IVF_TRAIN]
    ck_dir = os.path.join("build", "chip_smoke_phase18")
    os.makedirs(ck_dir, exist_ok=True)
    ckp = os.path.join(ck_dir, "lloyd.npz")
    events = []
    full = counted("lloyd_stepped", lambda: vq_tpu_torch.lloyd_stepped(
        train, MB_K, max_iters=KS_ITERS, seed=SEED, logger=MetricsLogger(events.append)))
    counted("lloyd_stepped to the checkpoint", lambda: vq_tpu_torch.lloyd_stepped(
        train, MB_K, max_iters=KS_CHECKPOINT, seed=SEED, checkpoint_path=ckp,
        checkpoint_every=KS_CHECKPOINT))
    assert load_kmeans_state(ckp).iteration == KS_CHECKPOINT
    resumed = counted("lloyd_stepped resumed", lambda: vq_tpu_torch.lloyd_stepped(
        train, MB_K, max_iters=KS_ITERS, seed=SEED, resume_from=ckp))
    shutil.rmtree(ck_dir)
    assert int(full.iterations) == int(resumed.iterations) == len(events)
    assert torch.equal(full.centroids, resumed.centroids), "the resumed run differs"
    assert by_path["lloyd_stepped"]["lloyd_accumulate_fused"] == int(full.iterations)
    log("kmeans", f"lloyd_stepped k {MB_K} on {N_IVF_TRAIN} rows: {int(full.iterations)} "
        f"iterations in {wall['lloyd_stepped']:.1f} ms (inertia {events[0]['inertia']:.6g} -> "
        f"{float(full.inertia):.6g}, the last step's largest move {events[-1]['max_movement']:.4g}); "
        f"resumed from the checkpoint at {KS_CHECKPOINT}: the same centroids bit for bit | {smi}")

    # lloyd_minibatch and pq_minibatch_update over one epoch, against the plain route.
    init = kmeans_plusplus_init_device(corpus, MB_K, seed=SEED)
    steps = math.ceil(N_CORPUS / MB_BATCH)

    def minibatch():
        return vq_tpu_torch.lloyd_minibatch(corpus, MB_K, batch_size=MB_BATCH, seed=SEED, init=init)

    order = torch.from_numpy(np.random.default_rng(SEED).permutation(N_CORPUS)).to(corpus.device)

    def pq_epoch():
        cb = main["pq"].codebooks.clone()
        counts = torch.zeros(M, K, device=corpus.device)
        inertia = torch.zeros(M, device=corpus.device)
        for lo in range(0, N_CORPUS, MB_BATCH):
            cb, counts, part = pq_minibatch_update(cb, counts, corpus[order[lo:lo + MB_BATCH]])
            inertia = inertia + part
        return cb, counts, inertia

    mb = counted("lloyd_minibatch", minibatch)
    pq_out = counted("pq_minibatch_update epoch", pq_epoch)
    assert by_path["lloyd_minibatch"]["lloyd_accumulate_fused"] == steps, by_path["lloyd_minibatch"]
    assert by_path["pq_minibatch_update epoch"]["pq_lloyd_accumulate_fused"] == steps
    full_l = vq_tpu_torch.lloyd(corpus, MB_K, max_iters=10, seed=SEED, init_centroids=init)
    with plain_route():
        mb_p, pq_p = minibatch(), pq_epoch()
    for a, b in zip((mb.centroids, mb.assignments, mb.inertia) + pq_out,
                    (mb_p.centroids, mb_p.assignments, mb_p.inertia) + pq_p):
        assert torch.equal(a, b), "a mini-batch step differs from the plain route"
    t["lloyd_minibatch"] = wall["lloyd_minibatch"]
    log("kmeans", f"lloyd_minibatch k {MB_K}, batch {MB_BATCH}, one epoch of {N_CORPUS}: "
        f"{steps} K2 launches, {wall['lloyd_minibatch']:.1f} ms host wall, inertia "
        f"{float(mb.inertia):.6g} against lloyd's {float(full_l.inertia):.6g} ({int(full_l.iterations)} "
        f"iterations from the same k-means++ seeds); pq_minibatch_update {M}x{K}x{DIM // M} over the "
        f"same batches: {steps} K3 launches, {wall['pq_minibatch_update epoch']:.1f} ms, inertia by "
        f"subspace summed over the epoch {float(pq_out[2].sum()):.6g}; both equal the plain route "
        f"bit for bit | {smi}")
    profile_line(smi, f"lloyd_minibatch k {MB_K}, batch {MB_BATCH}, one epoch of 1M", minibatch)
    del mb, mb_p, pq_out, pq_p, full_l
    torch.cuda.empty_cache()

    # index_factory pipelines: train 200k, add 1M (HNSW32 builds over the 1M rows).
    fac, fac_out = {}, {}
    kws = {"IVF": {"nprobe": NPROBES[0]}, "BIVF": {"nprobe": NPROBES[0]}, "HNSW": {"beam": 64}}

    def kw_of(spec):
        return next((v for key, v in kws.items() if spec.startswith(key)), {})

    def build(spec):
        f = vq_tpu_torch.index_factory(DIM, spec)
        if spec.startswith("HNSW"):
            f.train(corpus)
            return f
        if not f.is_trained:
            f.train(train)
        f.add(corpus)
        return f

    for spec in FACTORY_SPECS:
        fac[spec] = counted(f"factory {spec} build", lambda spec=spec: build(spec))
        kw = kw_of(spec)
        fac_out[spec] = counted(f"factory {spec} search",
                                lambda spec=spec, kw=kw: fac[spec].search(queries, 10, **kw))
        _check_search(f"factory {spec}", *fac_out[spec])
        recall[f"factory {spec}"] = _recall(fac_out[spec][0], gt)
        t[f"factory {spec}"] = cuda_ms(lambda spec=spec, kw=kw: fac[spec].search(queries, 10, **kw), 3)
    for spec in FACTORY_PLAIN:
        with plain_route():
            f_p = build(spec)
            got = f_p.search(queries, 10, **kw_of(spec))
        assert torch.equal(got[0], fac_out[spec][0]) and torch.equal(got[1], fac_out[spec][1]), spec
        del f_p
    log("factory", "index_factory on the card, recall@10 / search ms (CUDA events) / build ms "
        "(host wall): " + "; ".join(
            f"{s} {recall[f'factory {s}']:.4f} / {t[f'factory {s}']:.3f} / "
            f"{wall[f'factory {s} build']:.0f}" for s in FACTORY_SPECS)
        + f"; {', '.join(FACTORY_PLAIN)} equal the plain route bit for bit | {smi}")
    profile_line(smi, f"index_factory {FACTORY_SPECS[-1]} search 128 q, nprobe {NPROBES[0]}",
                 lambda: fac[FACTORY_SPECS[-1]].search(queries, 10, nprobe=NPROBES[0]), SORT_KERNELS)

    # tune over two of them.
    gt_np = gt.cpu().numpy()
    tune_mod = importlib.import_module("vq_tpu_torch.tune")
    sweep, swept = tune_mod.sweep, []  # the points tune chose from
    tune_mod.sweep = lambda *a, **kw: swept.append(sweep(*a, **kw)) or swept[-1]
    try:
        for spec in TUNE_SPECS:
            grid = TUNE_IVF_GRID if spec.startswith("IVF") else None
            best = counted(f"factory tune {spec}", lambda spec=spec, grid=grid: vq_tpu_torch.tune(
                fac[spec], queries, gt_np, target_recall=TUNE_TARGET, grid=grid))
            _log_tune(smi, spec, best, vq_tpu_torch.pareto(swept[-1]))
    finally:
        tune_mod.sweep = sweep
    del fac, fac_out
    torch.cuda.empty_cache()


    log("last", "recall@10 " + ", ".join(f"{n}: {v:.4f}" for n, v in recall.items()))
    log("last", f"launches by call: {by_path}")
    need = [("graph build", k) for k in ("assign_fused", "lloyd_accumulate_fused",
                                         "ivf_probe_matvec_fused")]
    ivf_flat, ivf_pq, opq, refine = (FACTORY_SPECS[i] for i in (0, 1, 2, -1))
    need += [(f"factory {ivf_flat} search", "ivf_probe_matvec_fused"),
             (f"factory {ivf_pq} search", "ivf_probe_adc_fused"),
             (f"factory {opq} search", "adc_scan_topk_fused"),
             (f"factory {refine} build", "pq_encode_fused")]
    for name, kernel in need:
        assert by_path[name].get(kernel, 0) > 0, f"{name}: {kernel} was not launched: {by_path[name]}"
    groups = {"graph": ("graph",), "kmeans_stream": ("lloyd_", "pq_minibatch"),
              "factory": ("factory",)}
    paths = {}
    for path, prefixes in groups.items():
        paths[path] = {}
        for name, calls in by_path.items():
            if name.startswith(prefixes):
                for kernel, n in calls.items():
                    paths[path][kernel] = paths[path].get(kernel, 0) + n
    log("last", f"launches in phase 18 by path: {paths}")
    return dict(paths=paths, by_path=by_path, recall=recall, t=t, graph=g)  # phase 20 serves g


def phase_sharded(smi, corpus, queries, main, rqres):
    """Phase 19, the sharded layer (``vq_tpu_torch.parallel``) on the
    phase-4 mixture in a world of one on NCCL, where every collective is a
    real call: ``sharded_pq_train`` 8x256 on the 1M rows, ``sharded_lloyd``
    k 1024 on the 200k training rows, ``sharded_pq_encode`` of 1M,
    ``sharded_pq_minibatch_update`` over one epoch of 8192-row batches,
    ``sharded_opq_train`` on the 200k rows and ``sharded_flat_search`` of
    the 128 queries over the 1M ``PQIndex``, ``RQIndex``, ``FlatIndex``
    and ``SQIndex``. Launches read from that run (K2, K3, K4, K5 each at
    least once); each result held to its single-device counterpart bit for
    bit with ``overlap=False`` and within 1e-5 with the overlap (one
    warm-started step). Then ``python -m vq_tpu_torch.parallel.dryrun``
    as a 2-rank gloo world on this card, held to the same run in this
    world of one, and CUDA-event times: one sharded Lloyd step beside
    K3's single-device pass, its ``all_reduce`` alone, and the sharded flat
    search beside ``PQIndex.search``."""
    import os
    import shutil

    import numpy as np
    import torch

    import vq_tpu_torch
    from vq_tpu_torch import parallel as P
    from vq_tpu_torch.ops import cuda_kernels as ck
    from vq_tpu_torch.ops.kmeans import lloyd, lloyd_batched
    from vq_tpu_torch.ops.kmeans_stream import pq_minibatch_update
    from vq_tpu_torch.parallel import dryrun
    from vq_tpu_torch.parallel.kmeans import global_accumulate
    from vq_tpu_torch.parallel.mesh import all_reduce_sum

    import torch.distributed as dist

    P.init_distributed(device_type="cuda")
    mesh = P.make_mesh(device_type="cuda")
    group = mesh.get_group(P.DATA_AXIS)
    # NCCL makes its communicator at a group's first collective: once here,
    # outside the path's walls.
    probe = torch.zeros(1, device=corpus.device)
    _, t_setup = cuda_once(lambda: (dist.all_reduce(probe, group=group),
                                    dist.all_gather([torch.empty_like(probe)], probe, group=group)))
    log("sharded", f"world of one on {dist.get_backend()}: {mesh}; the first collectives "
        f"{t_setup:.1f} ms (communicator set-up)")
    by_path, wall = {}, {}
    counted = _counter(by_path, wall)
    train_rows = corpus[:N_IVF_TRAIN]
    pq_index, rq_index = main["index"], rqres["indexes"]["l2"]
    flat = vq_tpu_torch.FlatIndex.from_data(corpus)
    sq = vq_tpu_torch.SQIndex.from_data(corpus)
    indexes = {"pq": pq_index, "rq": rq_index, "flat": flat, "sq": sq}
    batches = [corpus[i:i + MB_BATCH] for i in range(0, N_CORPUS, MB_BATCH)]
    torch.cuda.synchronize()
    reset_counts()  # the sharded main path from here to read_counts()
    before = read_counts()
    out = {}
    out["pq"] = counted("sharded_pq_train", lambda: P.sharded_pq_train(
        corpus, M, K, 10, seed=0, mesh=mesh, overlap=False))
    cb = out["pq"].centroids.to_local()
    out["pq_step"] = counted("sharded_pq_train overlap step", lambda: P.sharded_pq_train(
        corpus, M, K, 1, mesh=mesh, init_codebooks=cb))
    out["lloyd"] = counted("sharded_lloyd", lambda: P.sharded_lloyd(
        train_rows, NLIST, 10, seed=0, mesh=mesh, overlap=False))
    out["lloyd_step"] = counted("sharded_lloyd overlap step", lambda: P.sharded_lloyd(
        train_rows, NLIST, 1, seed=0, mesh=mesh))
    out["codes"] = counted("sharded_pq_encode", lambda: P.sharded_pq_encode(corpus, cb, mesh=mesh))

    def stream(overlap):
        c, n = cb, torch.zeros((M, K), device=corpus.device)
        for b in batches:
            c, n, i = (t.to_local() for t in P.sharded_pq_minibatch_update(c, n, b, mesh=mesh,
                                                                         overlap=overlap))
        return c, n, i

    out["stream"] = counted("sharded_pq_minibatch_update", lambda: stream(False))
    zero = torch.zeros((M, K), device=corpus.device)
    out["stream_step"] = counted("sharded_pq_minibatch_update overlap step", lambda: [
        t.to_local() for t in P.sharded_pq_minibatch_update(cb, zero, batches[0], mesh=mesh)])
    out["opq"] = counted("sharded_opq_train", lambda: P.sharded_opq_train(
        train_rows, M, K, opq_iters=OPQ_ITERS, pq_iters=OPQ_PQ_ITERS, mesh=mesh, overlap=False))
    for kind, idx in indexes.items():
        out[f"search {kind}"] = counted(f"sharded_flat_search {kind}", lambda idx=idx: (
            P.sharded_flat_search(idx, queries, 10, mesh=mesh)))
    after = read_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    log("sharded", f"launches of the sharded path: {launches}")
    log("sharded", "host wall by call (ms): " + ", ".join(f"{n} {v:.1f}" for n, v in wall.items()))
    for kernel in ("lloyd_accumulate_fused", "pq_lloyd_accumulate_fused", "pq_encode_fused",
                   "adc_scan_topk_fused"):
        assert launches.get(kernel, 0) > 0, f"sharded path: {kernel} was not launched: {launches}"

    # The single-device counterparts, on the same card.
    xb = corpus.view(N_CORPUS, M, DIM // M).permute(1, 0, 2)
    want_cb, want_it, _ = lloyd_batched(xb, K, 10, 0)
    r = out["pq"]
    assert torch.equal(cb, want_cb), "sharded_pq_train (overlap=False) != lloyd_batched"
    assert torch.equal(r.iterations.to_local(), want_it)
    want_inertia = ck.pq_lloyd_accumulate_fused(corpus, want_cb)[2]
    assert torch.equal(r.inertia.to_local(), want_inertia), "sharded_pq_train inertia"
    step_want, _, _ = lloyd_batched(xb, K, 1, 0, init_centroids=cb)
    step_got = out["pq_step"].centroids.to_local()
    err = {"pq overlap step": float((step_got - step_want).abs().max())}
    torch.testing.assert_close(step_got, step_want, rtol=1e-5, atol=1e-5)
    # sharded_lloyd(seed=s) draws as lloyd(seed=s * 1_000_003): at seed 0, the same stream.
    ref = lloyd(train_rows, NLIST, 10, seed=0)
    lr = out["lloyd"]
    assert torch.equal(lr.centroids.to_local(), ref.centroids), "sharded_lloyd != lloyd"
    assert int(lr.iterations.to_local()) == int(ref.iterations)
    torch.testing.assert_close(lr.inertia.to_local(), ref.inertia, rtol=1e-5, atol=0.0)
    one = lloyd(train_rows, NLIST, 1, seed=0).centroids
    err["lloyd overlap step"] = float((out["lloyd_step"].centroids.to_local() - one).abs().max())
    torch.testing.assert_close(out["lloyd_step"].centroids.to_local(), one, rtol=1e-5, atol=1e-5)
    want_codes = ck.pq_encode_fused(corpus, cb)
    assert torch.equal(out["codes"].to_local(), want_codes), "sharded_pq_encode != K4"
    c, n = cb, zero
    for b in batches:
        c, n, i = pq_minibatch_update(c, n, b)
    assert all(torch.equal(a, w) for a, w in zip(out["stream"], (c, n, i))), \
        "sharded_pq_minibatch_update (overlap=False) != pq_minibatch_update"
    sw = pq_minibatch_update(cb, zero, batches[0])
    assert torch.equal(out["stream_step"][1], sw[1])
    err["stream overlap step"] = float((out["stream_step"][0] - sw[0]).abs().max())
    torch.testing.assert_close(out["stream_step"][0], sw[0], rtol=1e-5, atol=1e-5)
    rot1, cb1 = vq_tpu_torch.opq_train(train_rows, M, K, opq_iters=OPQ_ITERS, pq_iters=OPQ_PQ_ITERS)
    rot, ocb = (t.to_local() for t in out["opq"])
    assert torch.equal(rot, rot1) and torch.equal(ocb, cb1), "sharded_opq_train != opq_train"
    for kind, idx in indexes.items():
        want = idx.search(queries, 10)
        got = out[f"search {kind}"]
        assert all(torch.equal(a, w) for a, w in zip(got, want)), f"sharded_flat_search {kind}"
    log("sharded", "world of one on NCCL: sharded_pq_train, sharded_lloyd, sharded_pq_encode, "
        "the minibatch epoch, sharded_opq_train and the four flat searches equal their "
        f"single-device counterparts bit for bit; the overlap steps' largest gaps {err}")

    # The 2-rank gloo world on this card, held to the same checks in this world of one.
    work = os.path.join("build", "chip_smoke_phase19")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vq_tpu_torch.parallel.dryrun", "--ranks", "2", "--device", "cuda",
         "--backend", "gloo", "--out", os.path.join(work, "run2.npz")],
        capture_output=True, text=True, timeout=300)
    t_spawn = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit("chip_smoke: the 2-rank dry run failed:\n"
                         f"{proc.stdout}\n{proc.stderr[-4000:]}")
    with np.load(os.path.join(work, "run2.npz")) as f:
        run2 = {k: f[k] for k in f.files}
    shutil.rmtree(work)
    inputs = dryrun.make_inputs()
    small = dryrun.build_indexes(inputs, torch.device("cuda"))
    run1 = dryrun.run_checks("cuda", small, inputs)
    n1 = dryrun.check_single_device(run1, inputs, small, torch.device("cuda"))
    n2 = dryrun.compare_runs(run2, run1)
    log("sharded", f"{proc.stdout.strip()} ({t_spawn:.1f} s with its spawn); world of one: {n1} "
        f"results held to the single-device functions; the 2-rank run's {n2} results held to it")

    # CUDA-event times: one Lloyd step (the global accumulate), its all_reduce, the flat search.
    # On one rank the step is one sweep whatever the overlap asks (its halves
    # would hide nothing); ``dryrun --full`` times the halves across cards.
    def step():
        return global_accumulate(corpus, None, cb, N_CORPUS // 2, False, group)

    sums, counts, inertia = ck.pq_lloyd_accumulate_fused(corpus, cb)
    t = {
        "K3 single-device pass": cuda_ms(lambda: ck.pq_lloyd_accumulate_fused(corpus, cb), 5),
        "sharded step": cuda_ms(step, 5),
        "its all_reduce alone": cuda_ms(lambda: all_reduce_sum([sums, counts, inertia], group), 20),
        "PQIndex.search": cuda_ms(lambda: pq_index.search(queries, 10), 5),
        "sharded_flat_search PQIndex": cuda_ms(
            lambda: P.sharded_flat_search(pq_index, queries, 10, mesh=mesh), 5),
        "opq_train 200k, 6 x 3": cuda_ms(lambda: vq_tpu_torch.opq_train(
            train_rows, M, K, opq_iters=OPQ_ITERS, pq_iters=OPQ_PQ_ITERS), 1),
        "sharded_opq_train 200k, 6 x 3": cuda_ms(lambda: P.sharded_opq_train(
            train_rows, M, K, opq_iters=OPQ_ITERS, pq_iters=OPQ_PQ_ITERS, mesh=mesh), 1),
    }
    log("sharded", "CUDA-event ms (1M x 128, 8x256x16; 128 queries, k 10): "
        + ", ".join(f"{n} {v:.4f}" for n, v in t.items()) + f" | {smi}")
    opq_args = dict(opq_iters=OPQ_ITERS, pq_iters=OPQ_PQ_ITERS)
    profiled = {
        "sharded Lloyd step, 1M": step,
        "sharded_opq_train 200k, 6 x 3": lambda: P.sharded_opq_train(train_rows, M, K, mesh=mesh,
                                                                     **opq_args),
        "opq_train 200k, 6 x 3": lambda: vq_tpu_torch.opq_train(train_rows, M, K, **opq_args),
        "sharded_flat_search PQIndex": lambda: P.sharded_flat_search(pq_index, queries, 10,
                                                                     mesh=mesh),
    }
    for name, fn in profiled.items():
        profile_line(smi, name, fn)
    host_line(smi, "sharded_opq_train 200k, 6 x 3", profiled["sharded_opq_train 200k, 6 x 3"])
    host_line(smi, "opq_train 200k, 6 x 3", profiled["opq_train 200k, 6 x 3"])
    del flat, sq, out
    torch.cuda.empty_cache()  # the world of one stays up for phase 20
    return dict(launches=launches, by_path=by_path, t=t, err=err, dryrun=(n1, n2))


def phase_sharded_serving(smi, corpus, queries, pipe_q, main, ivf, flat, rqres, graph):
    """Phase 20, the sharded serving layer in phase 19's world of one on
    NCCL, at full width over the indexes earlier phases hold: the 1M
    IVF-PQ (phase 6), IVF-Flat f32 (rebalanced by phase 17) / bf16 and
    IVF-SQ (phase 7), IVF-RQ (phase 10), a 1M ``IVFBinaryIndex`` on the
    IVF-Flat coarse centroids and phase 18's 1M graph.
    ``sharded_ivf_search`` / ``sharded_ivf_scan_search`` at nprobe 8 and
    64, ``sharded_graph_search`` at beam 16 and 64, ``sharded_refine_search``
    over a sharded IVF-PQ base with sq8 codes and over a flat ``PQIndex``
    base with f32 codes, the sq8 one's ``BatchPipeline.from_core`` over
    the 8 x 128 pipeline queries, and a ``remove_ids`` of 1,000 rows of the
    IVF-Flat f32 followed by its sharded search (the blocks must follow the
    pool: R3). Launches read from that run (K5, K6 and K7 each at least
    once); every result held bit for bit to the single-device search (a
    world of one must be exact); CUDA-event times of the sharded IVF-PQ /
    IVF-Flat searches beside the single-device ones; each block's bytes."""
    import torch
    import torch.distributed as dist

    import vq_tpu_torch
    from vq_tpu_torch import parallel as P
    from vq_tpu_torch.parallel.ivf_scan import _shard_lists

    mesh = P.make_mesh(device_type="cuda")  # the world of one that phase 19 started
    flats = flat["indexes"]
    train = corpus[:N_IVF_TRAIN]
    # Set-up, outside the path: the binary index and the two refine indexes.
    binary = vq_tpu_torch.IVFBinaryIndex(flats["flat_bf16"].coarse)
    binary.add(corpus)
    ivfpq = ivf["index"]
    refs = {"sq8 over IVF-PQ": (vq_tpu_torch.RefineIndex(
                vq_tpu_torch.IVFPQIndex(ivfpq.coarse, ivfpq.pq), "sq8", sq_train_data=train),
                dict(nprobe=NPROBES[0])),
            "flat over PQIndex": (vq_tpu_torch.RefineIndex(
                vq_tpu_torch.PQIndex(main["pq"]), "flat"), {})}
    for ref, _ in refs.values():
        ref.add(corpus)
    indexes = {"ivfpq": (ivfpq, P.sharded_ivf_search),
               "ivfflat_f32": (flats["flat_f32"], P.sharded_ivf_scan_search),
               "ivfflat_bf16": (flats["flat_bf16"], P.sharded_ivf_scan_search),
               "ivfsq": (flats["sq"], P.sharded_ivf_scan_search),
               "ivfrq": (rqres["ivf"], P.sharded_ivf_scan_search),
               "ivfbinary": (binary, P.sharded_ivf_scan_search)}
    by_path, wall = {}, {}
    counted = _counter(by_path, wall)
    gone = torch.arange(0, N_CORPUS, N_CORPUS // 1000, device=corpus.device)[:1000]
    pipe_batches = pipe_q.reshape(-1, PIPE_BATCH, DIM)
    f32 = flats["flat_f32"]
    want_f32 = {p: f32.search(queries, 10, nprobe=p) for p in NPROBES}  # before the removal
    torch.cuda.synchronize()
    reset_counts()  # the sharded serving path from here to read_counts()
    before = read_counts()
    out = {}
    for name, (idx, fn) in indexes.items():
        for p in NPROBES:
            out[(name, p)] = counted(f"{name} nprobe={p}", lambda idx=idx, fn=fn, p=p: fn(
                idx, queries, 10, nprobe=p, mesh=mesh))
    for beam in (GRAPH_BEAMS[0], GRAPH_BEAMS[-1]):
        out[("graph", beam)] = counted(f"graph beam={beam}", lambda beam=beam: (
            P.sharded_graph_search(graph, queries, 10, beam=beam, mesh=mesh)))
    for name, (ref, kw) in refs.items():
        out[name] = counted(f"refine {name}", lambda ref=ref, kw=kw: P.sharded_refine_search(
            ref, queries, 10, k_factor=K_FACTOR, mesh=mesh, **kw))
    ref_sq8, kw_sq8 = refs["sq8 over IVF-PQ"]
    core, arrays = P.sharded_refine_search_core(ref_sq8, 10, k_factor=K_FACTOR, mesh=mesh, **kw_sq8)
    pipe = vq_tpu_torch.BatchPipeline.from_core(core, arrays, dim=DIM)
    out["pipeline"] = counted("refine pipeline", lambda: pipe.search(pipe_batches))
    version = f32._pool.version
    assert counted("ivfflat_f32 remove_ids", lambda: f32.remove_ids(gone)) == gone.numel()
    out["after remove"] = counted("ivfflat_f32 after remove_ids nprobe=8", lambda: (
        P.sharded_ivf_scan_search(f32, queries, 10, nprobe=NPROBES[0], mesh=mesh)))
    after = read_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    log("serving", f"launches of the sharded serving path: {launches}")
    log("serving", "host wall by call (ms): " + ", ".join(f"{n} {v:.1f}" for n, v in wall.items()))
    for kernel in ("ivf_probe_matvec_fused", "ivf_probe_adc_fused", "adc_scan_topk_fused"):
        assert launches.get(kernel, 0) > 0, f"sharded serving: {kernel} was not launched: {launches}"
    assert f32._pool.version != version and f32._shard_cache[2] == f32._pool.version

    # The single-device searches on the same indexes, bit for bit.
    def same(got, want, name):
        assert all(torch.equal(a, b) for a, b in zip(got, want)), f"sharded {name} != single device"

    for name, (idx, _) in indexes.items():
        for p in NPROBES:
            want = want_f32[p] if name == "ivfflat_f32" else idx.search(queries, 10, nprobe=p)
            same(out[(name, p)], want, f"{name} nprobe={p}")
    for beam in (GRAPH_BEAMS[0], GRAPH_BEAMS[-1]):
        same(out[("graph", beam)], graph.search(queries, 10, beam=beam), f"graph beam={beam}")
    for name, (ref, kw) in refs.items():
        same(out[name], ref.search(queries, 10, k_factor=K_FACTOR, **kw), f"refine {name}")
    for b in range(pipe_batches.shape[0]):
        same((out["pipeline"][0][b], out["pipeline"][1][b]),
             ref_sq8.search(pipe_batches[b], 10, k_factor=K_FACTOR, **kw_sq8), f"pipeline batch {b}")
    same(out["after remove"], f32.search(queries, 10, nprobe=NPROBES[0]), "ivfflat_f32 after remove")
    log("serving", "world of one on NCCL: the sharded IVF-PQ, IVF-Flat f32 / bf16, IVF-SQ, IVF-RQ "
        f"and IVF-Binary searches at nprobe {NPROBES}, the graph at beam "
        f"{(GRAPH_BEAMS[0], GRAPH_BEAMS[-1])}, both refines and the {pipe_batches.shape[0]}-batch "
        "pipeline equal their single-device searches bit for bit; after remove_ids of "
        f"{gone.numel()} rows the IVF-Flat blocks were rebuilt (pool version {version} -> "
        f"{f32._pool.version}) and the sharded search equals the single-device one")

    # CUDA-event times beside the single-device searches, and each block's bytes.
    t, blocks = {}, {}
    for name in ("ivfpq", "ivfflat_f32"):
        idx, fn = indexes[name]
        b = _shard_lists(mesh, idx, tuple(getattr(idx, "_scan_payloads", ("codes",))))
        blocks[name] = sum(a.numel() * a.element_size() for a in [b.ids, *b.payloads.values()])
        for p in NPROBES:
            core_fn, core_arrays = (P.sharded_ivf_search_core if name == "ivfpq"
                                    else P.sharded_scan_search_core)(idx, 10, nprobe=p, mesh=mesh)
            t[f"{name} sharded nprobe={p}"] = cuda_ms(lambda: core_fn(queries, *core_arrays), 10)
            t[f"{name} single nprobe={p}"] = cuda_ms(lambda: idx.search(queries, 10, nprobe=p), 10)
    t["graph sharded beam=64"] = cuda_ms(lambda: P.sharded_graph_search(
        graph, queries, 10, beam=64, mesh=mesh), 3)
    t["graph single beam=64"] = cuda_ms(lambda: graph.search(queries, 10, beam=64), 3)
    t["refine sq8 sharded"] = cuda_ms(lambda: core(queries, *arrays), 5)
    t["refine sq8 single"] = cuda_ms(lambda: ref_sq8.search(queries, 10, k_factor=K_FACTOR,
                                                            **kw_sq8), 5)
    log("serving", "CUDA-event ms (128 queries, k 10): " + ", ".join(
        f"{n} {v:.4f}" for n, v in t.items()) + f"; block bytes {blocks} | {smi}")
    profile_line(smi, f"sharded_ivf_search IVF-PQ nprobe={NPROBES[0]}", lambda: P.sharded_ivf_search(
        ivfpq, queries, 10, nprobe=NPROBES[0], mesh=mesh), SORT_KERNELS)
    del binary, refs, out, pipe, core, arrays
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    return dict(launches=launches, by_path=by_path, t=t, blocks=blocks)


def eval_fields(key, t_eval, bounds, rows):
    """Extra fields of the K3 / K4 rows: their time, plain time and bound
    at the eval harness's shape."""
    return {"eval_shape": f"{rows} x {EVAL_DIM}, {'x'.join(map(str, PQ_EVAL))}",
            "ms_eval": t_eval[key][0], "plain_ms_eval": t_eval[key][1],
            "bound_ms_eval": bounds[key][0], "bound_by_eval": bounds[key][1]}


def bench_bounds():
    """``{kernel: (bound ms, "bytes" or "operations")}`` of B1-B4 at the
    twins' shapes, as :func:`kernel_bounds` reckons them, and B2's own
    design floor (its one-hot products at the bf16 peak)."""
    x_bytes, codes_out = N_CORPUS * DIM * 4, N_CORPUS * M * 4
    w_bytes = DIM * M * K * 4 + M * K * 4
    ops = 2.0 * N_CORPUS * DIM * M * K
    out_bytes = N_QUERY * N_CORPUS * 4
    lookup = bound(out_bytes + N_CORPUS * M + N_QUERY * M * K * 4, 1.0 * N_QUERY * N_CORPUS * M, PEAK_F32)
    return {
        "B1_highest": bound(x_bytes + w_bytes + codes_out, ops, PEAK_F32),
        "B1_default": bound(x_bytes + w_bytes + codes_out, ops, PEAK_BF16),
        "B2": lookup,
        "B3": lookup,
        "B4": bound(out_bytes + N_CORPUS + 4, 1.0 * N_QUERY * N_CORPUS, PEAK_F32),
        "B2_design_floor": 3 * 2.0 * N_QUERY * K * N_CORPUS * M / PEAK_BF16 * 1e3,
    }


def kernel_bounds(res, kres, ivf, k7_cases, k6_cases, prec, rqres):
    """``{kernel: (bound ms, "bytes" or "operations")}`` at the shapes this
    run gave each kernel: each input read once, each output written once,
    the operations over the fp32 (CUDA cores) or bf16 (tensor cores) peak."""
    import torch

    d, s = DIM, DIM // M
    pq_ops = 2.0 * N_CORPUS * M * K * s
    x_bytes = N_CORPUS * d * 4
    out = {
        "K1": bound(x_bytes + NLIST * d * 4 + N_CORPUS * 8, 2.0 * N_CORPUS * NLIST * d, PEAK_F32),
        "K2": bound(N_IVF_TRAIN * d * 4 + 2 * NLIST * d * 4 + NLIST * 8,
                    2.0 * N_IVF_TRAIN * NLIST * d, PEAK_F32),
        "K3": bound(N_TRAIN * d * 4 + 2 * M * K * s * 4 + M * K * 4, 2.0 * N_TRAIN * M * K * s, PEAK_F32),
        "K4": bound(x_bytes + M * K * s * 4 + N_CORPUS * M * 4, pq_ops, PEAK_F32),
        "K4_bf16": bound(x_bytes + M * K * s * 4 + N_CORPUS * M * 4, pq_ops, PEAK_BF16),
        "K4_bf16x3": bound(x_bytes + 2 * M * K * s * 4 + N_CORPUS * M * 4, 3 * pq_ops, PEAK_BF16),
    }
    tiles = -(-N_CORPUS // 2048)
    out["K5"] = bound(N_CORPUS * M + N_QUERY * M * K * 4 + N_QUERY * tiles * 128 * 8,
                      1.0 * N_QUERY * N_CORPUS * M, PEAK_F32)
    # K7 and K6 read the rows of the chunks probed (each chunk once, however
    # many pairs probe it) and do their arithmetic on every live position.
    for p in NPROBES:
        tables, chains, codes = k7_cases[p]
        pairs, m, kk = tables.shape
        ch, cap = codes.shape[1], ivf["index"]._pool.cap
        pos = torch.arange(chains.shape[1] * ch, device=chains.device)
        live = int(((chains >= 0).repeat_interleave(ch, dim=1) & (pos < cap)).sum())
        chunks = torch.unique(chains[chains >= 0]).numel()
        out["K7" if p == NPROBES[0] else f"K7_nprobe{p}"] = bound(
            chunks * ch * m + pairs * m * kk * 4 + pairs * pos.numel() * 4 + chains.numel() * 4,
            1.0 * live * m, PEAK_F32)
    out["K6"] = k6_cases[("flat_f32", NPROBES[0])][2][:2]
    for name, (tables8, codes8) in (("K8", prec["k8_args"]), ("K8_rq_chunk", rqres["k8_args"])):
        q8, m8, k8 = tables8.shape
        n8 = codes8.shape[0]
        out[name] = bound(q8 * n8 * 4 + n8 * m8 * codes8.element_size() + q8 * m8 * k8 * 4,
                          1.0 * q8 * n8 * m8, PEAK_F32)
    return out


def main() -> None:
    import torch

    walls = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    smi = timed("phase_device", phase_device)
    build_s = timed("phase_build", phase_build)
    corpus, queries, g, pipe_q = timed("make_data", make_data, "cuda")
    log("data", f"Gaussian mixture on the card: corpus {tuple(corpus.shape)}, "
        f"queries {tuple(queries.shape)}, {N_CLUSTERS} clusters of rank-{LATENT} "
        f"covariance, seed {SEED}")
    res = timed("phase_kernels", phase_kernels, corpus, queries, g)
    lowp_gap = timed("phase_lowp_kernels", phase_lowp_kernels, corpus, res)
    kres = timed("phase_ivf_kernels", phase_ivf_kernels, corpus, g)
    main_res = timed("phase_main_path", phase_main_path, corpus, queries)
    ivf = timed("phase_ivf_path", phase_ivf_path, corpus, queries, main_res["gt"])
    k7_cases = timed("phase_k7", phase_k7, queries, ivf)
    t = timed("phase_timings", phase_timings, smi, corpus, queries, res, main_res)
    t.update(timed("phase_ivf_timings", phase_ivf_timings, smi, corpus, queries, kres, ivf,
                   k7_cases))
    timed("phase_k2_stages", phase_k2_stages, smi, corpus, kres)
    k3_stages = timed("phase_k3_stages", phase_k3_stages, smi, corpus, res)
    flat = timed("phase_flat_path", phase_flat_path, corpus, queries, main_res["gt"])
    k6_cases, k6_err = timed("phase_k6", phase_k6, flat)
    t.update(timed("phase_flat_timings", phase_flat_timings, smi, queries, flat, k6_cases))
    prec = timed("phase_precision", phase_precision, corpus, queries, main_res)
    rqres = timed("phase_rq_path", phase_rq_path, corpus, queries, main_res["gt"])
    t_new, k8 = timed("phase_new_timings", phase_new_timings, smi, corpus, queries, res, prec, rqres)
    timed("profile_paths", profile_paths, smi, corpus, queries, main_res, prec, rqres, ivf, flat)
    bd = timed("make_bench_data", make_bench_data, "cuda")
    b_err = timed("phase_bench_kernels", phase_bench_kernels, bd, corpus, kres)
    bl = timed("phase_bench_path", phase_bench_path)
    t_bench = timed("phase_bench_timings", phase_bench_timings, smi, bd, k8["K8"])
    b3_floor = timed("gather_floor", gather_floor, smi, bd, t_bench["B3_adc_gather"][0])
    del bd
    ev = timed("phase_eval_path", phase_eval_path, smi)
    ev_checks = timed("phase_eval_checks", phase_eval_checks, smi, ev)
    t_eval = timed("phase_eval_timings", phase_eval_timings, smi, ev_checks)
    del ev_checks
    k8_range = timed("phase_flat_serving", phase_flat_serving, smi, corpus, queries, main_res, rqres)
    mo = timed("phase_mips_opq", phase_mips_opq, smi, corpus, queries)
    mt = timed("phase_maintenance", phase_maintenance, smi, corpus, queries, main_res["gt"])
    torch.cuda.empty_cache()
    lr = timed("phase_transforms_refine_serving", phase_transforms_refine_serving, smi, corpus,
               queries, pipe_q, main_res["gt"], main_res, ivf, flat)
    ll = lr["launches"]  # phase 17's run
    del lr
    torch.cuda.empty_cache()
    last = timed("phase_last_modules", phase_last_modules, smi, corpus, queries, main_res["gt"],
                 main_res)
    torch.cuda.empty_cache()
    sh = timed("phase_sharded", phase_sharded, smi, corpus, queries, main_res, rqres)
    sv = timed("phase_sharded_serving", phase_sharded_serving, smi, corpus, queries, pipe_q,
               main_res, ivf, flat, rqres, last.pop("graph"))
    log("time", f"kernel build {build_s:.2f} s | {smi}")
    log("time", "each phase's host wall: " + ", ".join(f"{n} {v:.1f} s" for n, v in walls.items()))

    launches = dict(main_res["launches"])
    for name in ("assign_fused", "lloyd_accumulate_fused", "ivf_probe_adc_fused"):
        launches[name] = ivf["launches"][name]
    launches["ivf_probe_matvec_fused"] = flat["launches"]["ivf_probe_matvec_fused"]
    pl, rl = prec["launches"], rqres["launches"]
    def mips_opq(kernel):  # phase 15's launches of a kernel, by path
        paths = {"aniso_pq": ("aniso", "mips_search"), "ivf_dot": ("ivf dot",), "opq": ("opq",)}
        return {path: sum(v.get(kernel, 0) for n, v in mo["by_path"].items() if n.startswith(pre))
                for path, pre in paths.items()}

    k3_paths = {"pq": launches["pq_lloyd_accumulate_fused"],
                "ivf_pq": ivf["launches"]["pq_lloyd_accumulate_fused"],
                "eval_pq": ev["launches"]["pq"]["pq_lloyd_accumulate_fused"],
                **mips_opq("pq_lloyd_accumulate_fused")}
    k4_paths = {"pq": launches["pq_encode_fused"], "ivf_pq": ivf["launches"]["pq_encode_fused[highest]"],
                "eval_pq": ev["launches"]["pq"]["pq_encode_fused[highest]"],
                **mips_opq("pq_encode_fused[highest]")}
    k5_paths = {"pq": launches["adc_scan_topk_fused"], "rq": rl["adc_scan_topk_fused"],
                **mips_opq("adc_scan_topk_fused")}
    k7_paths = {"ivf_pq": launches["ivf_probe_adc_fused"], "ivf_rq": rl["ivf_probe_adc_fused"],
                **mips_opq("ivf_probe_adc_fused")}
    ml = mt["launches"]  # phase 16's run
    k4_paths["maintenance"] = ml["pq_encode_fused[highest]"]
    k7_paths["maintenance"] = ml["ivf_probe_adc_fused"]
    fl = flat["launches"]
    k1_paths = {"ivf_pq": launches["assign_fused"], "ivf_flat": fl["assign_fused"],
                "rq": rl["assign_fused"], **mips_opq("assign_fused"), "maintenance": ml["assign_fused"]}
    k2_paths = {"ivf_pq": launches["lloyd_accumulate_fused"], "ivf_flat": fl["lloyd_accumulate_fused"],
                "rq": rl["lloyd_accumulate_fused"], **mips_opq("lloyd_accumulate_fused"),
                "maintenance": ml["lloyd_accumulate_fused"]}
    k6_paths = {"ivf_flat": fl["ivf_probe_matvec_fused"], "maintenance": ml["ivf_probe_matvec_fused"]}
    layer = "transforms_refine_serving"
    k8_paths = {"precision": pl["adc_lookup_fused"], "rq": rl["adc_lookup_fused"], "range": k8_range}
    for paths, kernel in ((k1_paths, "assign_fused"), (k2_paths, "lloyd_accumulate_fused"),
                          (k3_paths, "pq_lloyd_accumulate_fused"),
                          (k4_paths, "pq_encode_fused[highest]"), (k5_paths, "adc_scan_topk_fused"),
                          (k6_paths, "ivf_probe_matvec_fused"), (k7_paths, "ivf_probe_adc_fused"),
                          (k8_paths, "adc_lookup_fused")):
        if kernel != "adc_lookup_fused":
            paths[layer] = ll.get(kernel, 0)
        for path, counts in last["paths"].items():  # phase 18's paths
            if counts.get(kernel):
                paths[path] = counts[kernel]
        if sh["launches"].get(kernel):  # phase 19's run
            paths["sharded"] = sh["launches"][kernel]
        if sv["launches"].get(kernel):  # phase 20's run
            paths["sharded_serving"] = sv["launches"][kernel]
    bounds = kernel_bounds(res, kres, ivf, k7_cases, k6_cases, prec, rqres)
    e_m, e_k, e_s = PQ_EVAL
    e_ops = 2.0 * e_m * e_k * e_s
    bounds["K3_eval"] = bound(EVAL_K3_ROWS * EVAL_DIM * 4 + 2 * e_m * e_k * e_s * 4 + e_m * e_k * 4,
                              e_ops * EVAL_K3_ROWS, PEAK_F32)
    bounds["K4_eval"] = bound(EVAL_ROWS * EVAL_DIM * 4 + e_m * e_k * e_s * 4 + EVAL_ROWS * e_m * 4,
                              e_ops * EVAL_ROWS, PEAK_F32)
    bbounds = bench_bounds()
    bounds.update({k: v for k, v in bbounds.items() if k != "B2_design_floor"})
    src = "vq_tpu_torch/csrc/"
    tpu = "vq_tpu/ops/pallas_kernels.py:"

    def row(name, source, replaces, n, err, key, times, extra=None):
        ms, pms = times[:2]
        b_ms, b_by = bounds[key]
        entry = {"name": name, "route": "cuda", "source": src + source,
                 "replaces": replaces if ":" in replaces else tpu + replaces,
                 "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": times[2] if len(times) > 2 else None}
        entry.update(extra or {})
        return entry

    kernels = [
        row("pq_lloyd_accumulate_fused", "pq_lloyd.cu", "569", sum(k3_paths.values()),
            res["k3_err"], "K3", t["K3"], {
                "launches_by_path": k3_paths, "ms_200k": t["K3_200k"][0],
                "plain_ms_200k": t["K3_200k"][1],
                "sums_stage_by_rows": {str(n): v for n, v in k3_stages.items()},
                **eval_fields("K3_eval", t_eval, bounds, EVAL_K3_ROWS)}),
        row("pq_encode_fused", "pq_encode.cu", "379", sum(k4_paths.values()), res["k4_err"],
            "K4", t["K4"], {"launches_by_path": k4_paths,
                            **eval_fields("K4_eval", t_eval, bounds, EVAL_ROWS)}),
        row("adc_scan_topk_fused", "adc_topk.cu", "802", sum(k5_paths.values()),
            res["k5_err"], "K5", t["K5"], {"launches_by_path": k5_paths}),
        row("assign_fused", "assign.cu", "137", sum(k1_paths.values()), kres["k1_err"], "K1", t["K1"],
            {"bf16_ms": t["K1_bf16"][0], "launches_by_path": k1_paths}),
        row("lloyd_accumulate_fused", "lloyd.cu", "1473", sum(k2_paths.values()),
            kres["k2_err"], "K2", t["K2"], {"rq_shape_ms": t["K2_rq_shape"][0],
                                            "launches_by_path": k2_paths}),
        row("ivf_probe_adc_fused", "ivf_probe.cu", "1189", sum(k7_paths.values()), 0.0,
            "K7", t["K7_nprobe8"], {"launches_by_path": k7_paths,
                "also_replaces": tpu + "1147", "ms_nprobe64": t["K7_nprobe64"][0],
                "plain_ms_nprobe64": t["K7_nprobe64"][1], "bound_ms_nprobe64": bounds["K7_nprobe64"][0],
                "bound_by_nprobe64": bounds["K7_nprobe64"][1],
                "launches_by_nprobe": ivf["k7_by_nprobe"]}),
        row("ivf_probe_matvec_fused", "ivf_matvec.cu", "1356", sum(k6_paths.values()),
            k6_err, "K6", t["K6_flat_f32_nprobe8"], {"launches_by_path": k6_paths,
                "ms_by_case": {f"{n} nprobe={p}": t[f"K6_{n}_nprobe{p}"][0] for n, p in k6_cases},
                "bound_ms_by_case": {f"{n} nprobe={p}": c[2][0] for (n, p), c in k6_cases.items()}}),
        row("pq_encode_fused[bf16_fast]", "pq_encode.cu", "404", pl["pq_encode_fused[bf16_fast]"],
            lowp_gap["bf16_fast"], "K4_bf16", t_new["K4_bf16"],
            {"bf16_x_ms": t_new["K4_bf16_bf16in"][0]}),
        row("pq_encode_fused[bf16x3]", "pq_encode.cu", "420", pl["pq_encode_fused[bf16x3]"],
            lowp_gap["bf16x3"], "K4_bf16x3", t_new["K4_bf16x3"]),
        row("adc_lookup_fused", "adc_lookup.cu", "727", sum(k8_paths.values()),
            0.0, "K8", t_new["K8"], {
                "launches_by_path": k8_paths,
                "ms_rq_chunk": t_new["K8_rq_chunk"][0], "plain_ms_rq_chunk": t_new["K8_rq_chunk"][1],
                "library_ms_rq_chunk": t_new["K8_rq_chunk"][2],
                "bound_ms_rq_chunk": bounds["K8_rq_chunk"][0], "bound_by_rq_chunk": bounds["K8_rq_chunk"][1],
                "calm_ms": k8["K8"], "calm_ms_rq_chunk": k8["K8_rq_chunk"]}),
        row("mpacked_encode[highest]", "mpacked_encode.cu", "benchmarks/mpacked_encode.py:46",
            bl["mpacked_encode[highest]"], b_err["highest"], "B1_highest", t_bench["B1_highest"]),
        row("mpacked_encode[default]", "mpacked_encode.cu", "benchmarks/mpacked_encode.py:46",
            bl["mpacked_encode[default]"], b_err["default"], "B1_default", t_bench["B1_default"],
            {"bf16_resident_ms": t_bench["B1_bf16resident"][0]}),
        row("adc_kt", "adc_variants.cu", "benchmarks/adc_vmem_bench.py:55", bl["adc_kt"], 0.0, "B2",
            t_bench["B2_adc_kt"]),
        row("adc_gather", "adc_variants.cu", "benchmarks/adc_vmem_bench.py:99", bl["adc_gather"], 0.0,
            "B3", t_bench["B3_adc_gather"], {"only1_ms": t_bench["B3_only1"][0],
                                            "lookup_floor_ms": b3_floor}),
        row("adc_floor", "adc_variants.cu", "benchmarks/adc_vmem_bench.py:156", bl["adc_floor"], 0.0,
            "B4", t_bench["B4_adc_floor"][:2]),
    ]
    for k in kernels:
        log("bound", f"{k['name']}: {k['ms']:.4f} ms against a bound of {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}), {k['bound_ms'] / k['ms']:.3f} of it | {smi}")
    b8, ms8 = bounds["K8_rq_chunk"], t_new["K8_rq_chunk"][0]
    log("bound", f"adc_lookup_fused on one RQ chunk {tuple(rqres['k8_args'][1].shape)}: {ms8:.4f} ms "
        f"against a bound of {b8[0]:.4f} ms ({b8[1]}), {b8[0] / ms8:.3f} of it | {smi}")
    from vq_tpu_torch.benchmarks.mpacked_encode import mpacked_plan

    mplan, (sms, mhz) = mpacked_plan(N_CORPUS, DIM, M), sm_rate()
    hi_ms, lo_ms = t_bench["B1_highest"][0], t_bench["B1_default"][0]
    hi_floor = 2.0 * N_CORPUS * DIM * M * K / (sms * 128 * mhz * 1e6) * 1e3
    log("bound", f"mpacked_encode highest: {hi_ms:.4f} ms against a bound of "
        f"{bbounds['B1_highest'][0]:.4f} ms (operations, FMAs at the fp32 peak) and a floor of "
        f"{hi_floor:.4f} ms under its no-FMA contract ({sms} SMs x 128 lanes x {mhz:.0f} MHz), "
        f"{hi_floor / hi_ms:.3f} of the floor; W transposed read a call {mplan['hi_w_bytes']} B "
        f"({mplan['hi_tiles']} tiles of 128 rows) | {smi}")
    log("bound", f"mpacked_encode default: {lo_ms:.4f} ms against a bound of "
        f"{bbounds['B1_default'][0]:.4f} ms (operations, bf16), "
        f"{bbounds['B1_default'][0] / lo_ms:.3f} of it; R {mplan['rows']} rows "
        f"({'streamed' if mplan['streamed'] else 'resident'} x, {mplan['x_slots']} x slots, a ring "
        f"of {mplan['stages']} W boxes), {mplan['units']} units x {M} subspaces x "
        f"{mplan['boxes']} boxes of 32768 B: W image read a call {mplan['w_bytes']} B, "
        f"{mplan['w_bytes'] / lo_ms / 1e6:.1f} GB/s over its time | {smi}")
    floor, kt_ms = bbounds["B2_design_floor"], t_bench["B2_adc_kt"][0]
    log("bound", f"adc_kt's own design floor, its three one-hot bf16 products at the tensor-core "
        f"peak: {floor:.4f} ms, {floor / kt_ms:.3f} of its time | {smi}")
    from vq_tpu_torch.benchmarks.adc_vmem_bench import kt_plan

    plan = kt_plan(N_QUERY, M, K, N_CORPUS)
    log("bound", f"adc_kt's table parts read from device memory a call: {plan['table_bytes']} B "
        f"({plan['units']} units x {M} slabs of {plan['slab_bytes']} B, each slab once a unit), "
        f"{plan['table_bytes'] / kt_ms / 1e6:.1f} GB/s over its time | {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
