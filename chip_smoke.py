"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — requires CUDA; prints the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``).
2. build   — compiles every kernel of ``albedo_tpu_torch/kernels/csrc`` with
   ``nvcc`` (all at once) and prints the build seconds.
3. kernels — holds each kernel (K1 als_partials, K2 solve_corrected, K3
   bucket_cg, K5 topk_scores) against its plain PyTorch version on the card,
   on edge-case inputs made from a numpy seed: rel 1e-4 for K1-K3 (float32,
   another summation order), exact indices and scores for K5, ties included.
   Then the ranker kernels (K8 segment_dot, K9 sgns_step, adam_dense) on
   their edge cases: K8 with empty segments, one segment spanning every
   entry, a zero-count vocab tail and a null ``val`` (and K8 also within
   its merge-path order's float32 bound against float64, the same bits on a
   second call, one counted launch a call); K9 with B = 1,
   duplicate centers and negatives, d = 8 and 200; Adam at step 1 and 1000.
   Each is held against its plain version relative to the scale of what it
   compares (below), with no floor, so small gradients are held as tightly
   as large ones. Then the candidate-generator kernels: K5 at ranks 1 and 64
   (its narrow path) and 65, 200 and 3010 (its wide path, K14), with
   exclusions, exact ties, a row of ties and fewer admissible items than k;
   K11's spmm_rows with empty rows, 1089- and 6690-entry rows (split into
   chunks by its plan), rows at the chunk's edge, one row spanning every
   column, B = 1, 7, 256 and 300, the same bits twice; K11's masked_topk with ties, a strided block,
   a row whose every column is starred and k > n; K10's bpr_step at B = 1
   and 8192 with duplicate users and items, negatives equal to the positive
   and side features of width 2. Then the serving kernels, exactly: K5 at
   k = 129, 256, 512 (and fewer admissible items than k), and on the edge
   cases of its split design (``topk_bench.k5_edge_cases``: ties across
   every 32-item boundary, a row of zeros, cancelling, NaN and +-inf
   scores, odd exclusion rows, a row excluding every item, fewer admissible
   items than k, one row and 500, ranks 1 to 3010, k 1 to 512; each call
   also the same bits as a second one); K6 gather_topk at
   buckets 1/8/64 x k 32/512 in each exclusion mode, each row also equal to
   K5 on that user alone; K7 bank_query for user rows (plain, excluded,
   remapped) and item means at d 16, 50, 200, 3010 with an empty query row.
   Then the repaired refusals (``repair_kernels``): K6, K7, the select path
   (k 600) and K11's masked_topk (with and without a column norm) on K5's
   edge cases, NaN and +-inf scores included, exactly in ``lax.top_k``'s
   order (+NaN first, NaNs by index, -NaN and -inf never); masked_topk at
   k 129, 512, 513 and 1200 and with a 40 000-wide starred row (its select
   path), exactly; K9 at d 513 and 1024 (B 1, 300, 4096) and K10 at rank
   129 and 200 and side width 33 (their wide paths), to 5e-5 of each
   gradient element's mass.
   Then the any-size paths: K1-K3 at ranks 65, 100, 128 and 256 on
   bench-shaped buckets with a power-law row (7624 entries), K3 at rank
   1500 and K1 at rank 600 (their tiled paths above rank 512, the global
   workspaces included), rel 1e-4, K1's and K3's tiled paths also timed at
   rank 600 (K3's in the kernels line as ``bucket_cg_tiled``); K5 at
   k = 513, 600, 2048 and the whole catalogue, fewer admissible items than k,
   the wide rank (the select path), an exclusion row of 40 000 (K5's own
   path since its bitmask takes any width), and 500 rows in 16 passes of 32
   (its workspace budget cut to nothing), K6 at
   buckets 1/8/64 x those k in each exclusion mode and with 40 000-wide
   device rows (each row equal to K5 on that user alone), K7 for user rows
   and item means at k 600 and 2048, all exactly. Then K8c gather_sum
   (forward exactly, its K8 backward to 1e-5 of each entry's mass, 3 and 40
   terms) and K12 factor_health on the bench tables' shapes, finite and with
   NaN and +-inf planted (count and max exact, rms 1e-6, the same bits twice).
4. job     — runs ``albedo_tpu_torch.cli.main(["train_als"])`` at the job's
   full size (rank 50, 26 iterations, Cholesky) and again with
   ``--solver cg``, with the launch counts set to 0 just before each run and
   read just after; every kernel of each run must have launched, and the
   factors must be finite. Then, on the inputs that run gives its kernels
   (the job's own bucket groups, its seeded fit rebuilt from the same
   arguments, its 250 test users with no exclusion list), holds each kernel
   the run launched against its plain version, as in phase 3.
5. ranker  — runs ``train_word2vec --w2v-full`` and then ``train_lr
   --w2v-full`` (the default synthetic tables, Word2Vec dim 200 x 30 epochs,
   LR 300 iterations at reg 0.7), counts set to 0 before each run and read
   after: every kernel of the run must have launched. Holds the job's AUC
   and NDCG@30 against the JAX package's CPU values over seeds (constants
   below). Then runs ``train_lr --w2v-full`` once more with the weights
   shared with the JAX reference (ALS from a numpy init, numpy Word2Vec
   vectors: ``jax_reference_ndcg.py ranker --shared``) and holds AUC and
   NDCG@30 to the JAX values of that mode at float32 round-off. Then, on the
   inputs the seeded run gave its kernels (the LR fit's feature batch and
   fitted coefficients, the Word2Vec pairs and final optimizer state), holds
   K8 (every call of one forward and backward; also its order's bound, the
   same bits twice and one launch a call), K9 and Adam against their
   plain versions, and times each with its plain version, a library call and
   its bound (K8 also call by call beside cuSPARSE, and the card's kernel
   time of the 20 calls); K9 and Adam also at a realistic vocabulary
   (100 000 words, synthetic tables and pairs from a numpy seed).
6. candidates — runs ``popularity``, ``curation``, ``item_cf``, ``user_cf``,
   ``ranking_mf``, ``tfidf_content``, ``content --w2v-full`` and ``content``
   with the Word2Vec vectors shared with JAX, counts set to 0 before each
   run and read after: every kernel of the run must have launched. Holds
   each NDCG@30 (``tfidf_content``: its similar-repo list) against the JAX
   package's CPU values (constants below), then each new kernel against its
   plain version on the inputs that run gave it (recorded on the way), then
   times each with its plain version, a library call and its bound. Then
   (``wide_options``) the repaired paths through their entry points, with
   the counts set to 0 before and read after: item-CF at ``top_k=200`` and
   user-CF at 600 on the ``train_als`` job's matrix, Word2Vec at dim 1024
   with per-pair negatives, the ranking factorization at rank 129 with 33
   item side features; each result finite, each path launched, each
   recorded call held against its plain version and timed.
7. bench   — the JAX package's bench protocol at its scale (30000 x 20000,
   mean 60 stars, 10% held out per user): fits rank 50 x 26 iterations with
   both solvers from one pinned numpy init, and holds the held-out NDCG@30
   against the JAX package's CPU result for that same init (constants
   below). Then times each kernel, its plain version and one PyTorch library
   call at the shapes of that fit, and computes each kernel's bound, with
   K1-K3's kernel time group by group (``torch.profiler`` sums: the five
   slowest groups and ``narrow_share``, the share in groups with fewer rows
   than the card has SMs; K1-bf16's and K3-bf16's likewise in
   ``bench_bf16``), K2, K3 and K3-bf16 held group by group (``held``: each
   group's rel error over its rows that are not padding, the same bits on
   a second call, non-finite values in padding rows only); and
   K11 (one block of 256 users through both CFs) and K10 (B = 8192) on that
   train split.

8. serve   — the port's ``RecommendationService`` + ``serve()`` on
   127.0.0.1 over the ``train_als`` job's tables and an ALS fit from a
   pinned numpy init (rank 50): with the counts set to 0 just before and
   read just after, 256 concurrent requests (mixed users, k in 3/7/30/500,
   exclusion on and off) and the 250 test users' top-30 lists; every
   batched answer must equal the direct path byte for byte, the served
   NDCG@30 the offline evaluation exactly and the JAX value within
   SERVE_TOL, and K6 must have launched and match its plain version at
   every recorded batch. Then ``python -m albedo_tpu_torch.cli serve`` as a
   subprocess: ready, three answers, a clean exit on SIGTERM. Then the bank
   (``build_default_bank`` over the ALS, content --w2v-full, tf-idf and
   user-similarity sources): the test users' candidates against the host
   paths, K7 held at every recorded launch. Then timings: K6 at buckets
   1/8/64 x k 32/512 at the job and bench scales, K7 per source at batch
   64, K5 at k = 512 and on one user with that user's history excluded (the
   direct path's call), K4 and K12 (plain torch), each with its bound; and the
   service's requests/s and p50/p99 at closed-loop concurrency 1, 8 and 64
   from a client process (and 64 again with ``http.server``'s default
   listen backlog of 5), with the card's busy share.
9. wide_rank — with the counts set to 0, ``ImplicitALS(rank=100)`` on the
   ``train_als`` tables from the shared numpy init (26 iterations, Cholesky;
   then 26 with 3-step CG) and the test users' top 600 with seen items
   excluded: each fit's NDCG@30 in its JAX band, every wide and select path
   launched, each held at this run's inputs and timed; K1 wide, K2 wide
   (at the Cholesky fit's tables) and K3 wide (at the CG fit's) also group
   by group (each of the 54 groups at rel 1e-4 over its rows that are not
   padding, the same bits on a second call, K1's corrections exactly
   symmetric) with each group's kernel ms (profiler sums) beside the events
   ms.
10. two_stage — ``serve --two-stage`` at full width on the shared inputs of
   ``ranker --shared``: with the counts set to 0 before the fits (ALS, the
   in-process ranker) and read after the drive, 256 concurrent requests
   through the batched service, each equal to the direct path's answer, the
   re-ranked NDCG@30 in the JAX band (``jax_reference_ndcg.py two_stage
   --shared``), ``serving.source.curation`` forced to fail (degraded answers,
   the breaker open), and ``serve --two-stage`` as a subprocess. Then K8c at
   the ranker fit's real batch and K12 on the bench tables, each against its
   plain version and timed (K12 also against the reductions it replaced),
   and the two-stage service under closed-loop load at 1, 8 and 64 with the
   per-stage split from the /metrics stage gauges.

11. cv — first (``cv_kernels``, after phase 5) K8g segment_dot_grid and K8c-g
   gather_sum_grid at G = 1, 5 and 7 on skewed segments, chained gathers
   and the ranker fit's batch (K8g against float64 within the float32
   summation bound of its first order, (len/32 + 6) 2^-24 of each segment's
   mass, and of its merge-path order, the same bits twice, one launch a
   call; K8c-g exactly; each row equal to K8 or K8c on that row bit for
   bit), and K4's
   land_rows and scatter_rows exactly at ranks 8-256 with -1 padding slots
   and rows in no bucket. Then, each with the counts
   set to 0 before and read after: ``cv_als`` as the CLI runs it (each grid
   point's mean NDCG@30 in the JAX seed band), the real grid (rank 50/100)
   through ``cross_validate`` from the shared numpy inits, by Cholesky and
   again by 3-step CG (per-fold NDCG@30 within 1e-3 of JAX, the same best
   params; the CG grid must launch K3's wide path), ``cv_lr --w2v-full``
   seeded (AUC per column in the JAX seed band) and on the shared weights
   (AUC per column within 1e-4 of JAX, in JAX's order), with the L-BFGS
   steps per grid row. Then ``fit_many`` against five sequential fits and
   its idle share, K8g and K8c-g per call at the fit's batch against their
   bounds and against G launches of K8 and K8c, and K4 at the bench fit's
   landings.

12. trainers — first (``trainer_kernels``, after phase 3's kernels) K1-bf16
   and K3-bf16 (the bf16 gathers) at ranks 8, 50, 64, 65, 100 and 256 on
   bench-shaped buckets with all-padding slots and the 7624-entry power-law
   row, K1-bf16 at rel 1e-4 (its products are exact in float32, only the
   sums' order differs) and K3-bf16 row by row to the effects of the bf16
   roundings its float32 round-off could flip plus that round-off, at least
   rel 5e-4 (its rounded iterates can flip one bf16 rounding between two
   summation orders: ``bf16_rel``, ``ops.als.bucket_cg_bf16_limits``), and
   K3-bf16's wide path group by group at the rank-100 fit's 54 groups
   (F9's row limits, the same bits; timed with its plain version and
   bound for the kernels line as ``bucket_cg_bf16_wide``), and
   K9s (the shared negative pool)
   at B 1, 7, 65536 x K 1, 32, 512 x d 8, 200 and on pools of one word,
   with repeated centers and a pool word that is also a context, against
   its plain version in float64, element by element, to ten standard
   deviations of the round-off of its own summation order and logits
   (``ops.sgns.sgns_shared_limits``, at most 5e-5 x max(1, B / 4096) of
   ``ops.sgns.sgns_shared_grad_mass`` and of |loss|), the same bits on a
   second call. Then, each with the
   counts set to 0 before and read after: phase 7's bench protocol at
   ``gather_dtype="bfloat16"`` (``bench_bf16``: both solvers, NDCG@30 in the
   float32 bands of the JAX bf16 values, the JAX test's criteria against
   the float32 fit, only the bf16 entries of K1/K3 launched, then K1-bf16
   and K3-bf16 timed at the fit's calls); the JAX bench's refscale Word2Vec
   record (``w2v_refscale``: 10 M tokens, dim 200, batch 65536, 512 shared
   negatives, 30 epochs unless the first projects them past 240 s; wall-
   clock, tokens/s, per-epoch loss, K9s and Adam at its final state, K9s
   against its plain version in float64 over ten calls of the same bits);
   the
   cluster test with 32 shared negatives and the ``train_word2vec`` job's
   corpus with 512 in the JAX seed band (``w2v_quality``); and ``train_lr
   --w2v-full`` on the shared weights with the LR fitted by Adam
   (``lr_adam``: the 300-step fit in the float32 band of the JAX value, a
   10-step fit within rel 1e-4, seconds beside L-BFGS).

13. fused_fit — (after ``bench_bf16``) K16, the fused fit: every ALS fit on
   the card runs iteration 0 eagerly, then replays one captured iteration
   as a CUDA graph (``ops.als.fit_loop``). The bench fits by Cholesky and
   3-step CG and the rank-100 fits by both solvers, 26 iterations each,
   five times by the eager loop (``fit_loop_reference``) and five times
   by the graph, in turns: every graph fit equal to the eager fit bit for
   bit and launching what it launches (a replay counts the captured
   launches). Emitted: ``device_s`` and ``compile_s`` (capture and
   instantiation) of the graph fits beside the eager ``device_s``, their
   medians, and the card's busy share over one graph fit's replays from a
   ``torch.profiler`` trace. The other phases' fits run as graphs too, and
   report ``compile_s`` beside ``device_s``.

14. fused_loops — (after ``fused_fit``) K17 and K18, the whole-loop
   programs of Word2Vec and BPR: each fit runs epoch 0 eagerly, then
   replays one captured epoch (``Word2Vec.train``,
   ``RankingFactorization.fit``) against the eager loops
   (``train_reference``, ``fit_reference``), LOOP_RUNS times each in turns:
   the ``train_word2vec --w2v-full`` fit (K9), the same corpus with 512
   shared negatives (K9s), and the full ``ranking_mf`` fit with a drawn
   and with an injected schedule. Each graph fit launches what the eager
   fit launches and leaves its generator where the eager fit does (the
   next draw equal). K9s sums in a fixed order, so its graph fits equal
   the eager fits bit for bit in tables, moments and per-epoch losses; K9
   and K10 add with atomics in an order that changes from run to run (the
   card tests hold their graphs bit for bit at a batch of one pair), so
   their graph fits are held to the eager fits' own spread. Emitted:
   ``device_s`` and ``compile_s`` of the graph fits, the eager
   ``device_s``, the card's busy share over one graph fit's replays, and
   K17's and K18's records (ms a fit, the bound of its step kernels over
   the fit's own inputs, launches a fit). The other phases' Word2Vec and
   BPR fits run as graphs too and report ``compile_s``.

The kernels line (``{"kernels": [...]}``), the card line, and
``{"ok": true, "device": {...}}`` as the last line close the run.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# Held-out NDCG@30 of the JAX package (CPU, resident fit) on the bench split
# from the pinned numpy init of phase 7, and the bands the port must land in.
# CG's band is wider: unconverged 3-step CG carries round-off from sweep to
# sweep, so two correct implementations drift apart.
JAX_NDCG = {"cholesky": 0.29399, "cg": 0.29473}
NDCG_TOL = {"cholesky": 2e-3, "cg": 5e-3}
REL_TOL = 1e-4  # K1-K3 against their plain versions

# The seeded ranker job (train_lr --w2v-full --now 1600000000): the mean of the JAX
# package's CPU values over ALS/Word2Vec seeds 42, 1, 2, 3
# (``jax_reference_ndcg.py ranker --seeds 42,1,2,3``: AUC 0.96840, 0.96758,
# 0.96799, 0.96716; NDCG@30 0.41712, 0.42915, 0.44232, 0.42329). The card
# draws its own random stream, so a seeded port run is another seed: the
# bands are about twice (NDCG@30) and five times (AUC) the widest seed
# deviation seen over those runs and the port's CPU runs at the same seeds
# (``--port``: NDCG@30 0.4209 to 0.4488, AUC 0.96691 to 0.96835).
JAX_RANKER = {"auc": 0.96778, "ndcg": 0.42797}
RANKER_TOL = {"auc": 4e-3, "ndcg": 4e-2}
# The ranker job with shared weights (``jax_reference_ndcg.py ranker
# --shared``): the JAX package's CPU values, and bands at float32 round-off.
# The port on the CPU in that mode gives AUC 0.96731596 and NDCG@30
# 0.43035197 (gaps 1.1e-7 and 2.4e-5); the bands are those of the CPU
# parity test at --small (tests/test_torch_jobs.py), room for the card's
# own summation orders, and twenty times tighter than the seeded bands.
JAX_RANKER_SHARED = {"auc": 0.96731585, "ndcg": 0.43037593}
RANKER_SHARED_TOL = {"auc": 1e-4, "ndcg": 1e-3}
SHARED_SEED, SHARED_W2V_SCALE = 1, 0.3  # as in jax_reference_ndcg.py
# The ranker kernels against their plain versions. K8 and K9 sum float32
# terms in another order than their plain versions (a warp's order, K9's
# atomics in an order that changes from run to run, index_add_'s), so each
# element is held relative to the L1 mass of its terms, with no floor:
# K8 1e-5 of sum |x[idx] val| over its segment (a 70 000-entry segment
# differs by ~3e-7 of it); K9 5e-5 of ``ops.sgns.sgns_grad_mass`` and of
# |loss| (measured noise up to 4e-6 of max |plain| on the card; a 4096-term
# sum rounds to 1e-5 of its mass in float32 against float64 on the CPU;
# a grad_out slot scaled by 1.001 errs by 2e-4 of it). Elements of mass 0
# must be exactly 0. Adam, elementwise: 1e-6 of max |plain| of each table
# (measured 9e-8).
RANKER_REL = {"segment_dot": 1e-5, "sgns_step": 5e-5, "adam_dense": 1e-6}
W2V_VOCAB = 100_000  # the realistic vocabulary K9 and Adam are also timed at

# The candidate-generator kernels against their plain versions. spmm_rows
# and its plain version both sum in float64 and round once to float32, so
# they differ by at most a rounding or two: 1e-6 of each element's L1 mass.
# (Summed in float32, the two drifted apart by up to 4.4e-5 of the mass on
# the bench scale's 6690-entry rows on an H100, each order drifting its own
# way.)
# bpr_step adds duplicate rows with atomics in an order that changes from
# run to run: 5e-5 of ``ops.bpr.bpr_grad_mass`` and of |loss| (as K9).
# masked_topk (IEEE division, no sum) and K5 on both paths (the plain
# version's rounding, in index order, at every rank) are exact, ties
# included.
CAND_REL = {"topk_scores": 0.0, "topk_scores_wide": 0.0, "spmm_rows": 1e-6, "masked_topk": 0.0,
            "bpr_step": 5e-5}
# The candidate jobs' NDCG@30 from the JAX package on the CPU at full size
# (``jax_reference_ndcg.py candidates --seeds 42,1,2,3``: data policy off,
# --now 1600000000). popularity, curation, item_cf, user_cf and content on
# the Word2Vec vectors of ``ranker --shared`` (dim 16) are deterministic:
# the port on the CPU (``--port``) is within 4e-9 of each, so the bands are
# room for the card's own summation orders only (a swap of two near-equal
# CF scores at the cut moves NDCG@30 by up to ~1e-4). ranking_mf and content
# --w2v-full draw their own random streams (factor init, permutations,
# negatives; Word2Vec): the values are the mean of the JAX runs over seeds
# 42, 1, 2, 3 (ranking_mf 0.36441, 0.35309, 0.36211, 0.33777; content
# 0.012627, 0.013200, 0.016705, 0.011893), and the bands about twice the
# widest deviation of those runs and the port's CPU runs at the same seeds
# (ranking_mf 0.35276, 0.35401, 0.35243, 0.34987; content 0.013277,
# 0.016176, 0.012526, 0.013665).
JAX_CANDIDATES = {"popularity": 0.1294248402118683, "curation": 0.005175718106329441,
                  "item_cf": 0.06175846606492996, "user_cf": 0.25327855348587036,
                  "ranking_mf": 0.35434559, "content --w2v-full": 0.01360636,
                  "content shared": 0.008757498115301132}
CANDIDATE_TOL = {"popularity": 1e-6, "curation": 1e-6, "item_cf": 1e-3, "user_cf": 1e-3,
                 "ranking_mf": 3.5e-2, "content --w2v-full": 6.5e-3, "content shared": 1e-4}
# tfidf_content's printed list (the JAX run above; the port's CPU list is equal).
JAX_TFIDF_TOP = [
    ["0.3663", "user1004898/repo-5002504"], ["0.3102", "user1002853/repo-5002495"],
    ["0.2536", "user1002899/repo-5001016"], ["0.2437", "user1003771/repo-5002034"],
    ["0.2432", "user1001191/repo-5000906"], ["0.2355", "user1001432/repo-5001606"],
    ["0.2313", "user1002711/repo-5002751"], ["0.2307", "user1001141/repo-5002262"],
    ["0.2182", "user1002203/repo-5002205"], ["0.2174", "user1000851/repo-5000732"],
]

# Published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM bytes/s and
# FP32 FLOP/s outside the tensor cores. The kernels here run on CUDA cores.
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12

KERNELS = {
    "als_partials": ("albedo_tpu_torch/kernels/csrc/als_partials.cu", "albedo_tpu/ops/als.py:108"),
    "solve_corrected": ("albedo_tpu_torch/kernels/csrc/solve_corrected.cu", "albedo_tpu/ops/als.py:138"),
    "bucket_cg": ("albedo_tpu_torch/kernels/csrc/bucket_cg.cu", "albedo_tpu/ops/als.py:154"),
    "topk_scores": ("albedo_tpu_torch/kernels/csrc/topk_scores.cu", "albedo_tpu/ops/topk.py:28"),
    "segment_dot": ("albedo_tpu_torch/kernels/csrc/segment_dot.cu", "albedo_tpu/ops/sparse_linear.py:217"),
    "sgns_step": ("albedo_tpu_torch/kernels/csrc/sgns_step.cu", "albedo_tpu/models/word2vec.py:241"),
    "adam_dense": ("albedo_tpu_torch/kernels/csrc/adam_dense.cu", "albedo_tpu/models/word2vec.py:303"),
    "topk_scores_wide": ("albedo_tpu_torch/kernels/csrc/topk_scores.cu", "albedo_tpu/recommenders/content.py:81"),
    "spmm_rows": ("albedo_tpu_torch/kernels/csrc/spmm_rows.cu", "albedo_tpu/recommenders/cf.py:74"),
    "masked_topk": ("albedo_tpu_torch/kernels/csrc/masked_topk.cu", "albedo_tpu/recommenders/cf.py:216"),
    "bpr_step": ("albedo_tpu_torch/kernels/csrc/bpr_step.cu", "albedo_tpu/models/ranking_factorization.py:152"),
    "gather_topk": ("albedo_tpu_torch/kernels/csrc/gather_topk.cu", "albedo_tpu/serving/batcher.py:118"),
    "bank_query": ("albedo_tpu_torch/kernels/csrc/bank_query.cu", "albedo_tpu/retrieval/bank.py:187"),
    "als_partials_wide": ("albedo_tpu_torch/kernels/csrc/als_partials.cu", "albedo_tpu/ops/als.py:108"),
    "solve_corrected_wide": ("albedo_tpu_torch/kernels/csrc/solve_corrected.cu", "albedo_tpu/ops/als.py:138"),
    "bucket_cg_wide": ("albedo_tpu_torch/kernels/csrc/bucket_cg.cu", "albedo_tpu/ops/als.py:154"),
    "topk_select": ("albedo_tpu_torch/kernels/csrc/topk_select.cu", "albedo_tpu/ops/topk.py:27"),
    "gather_sum": ("albedo_tpu_torch/kernels/csrc/gather_sum.cu", "albedo_tpu/ops/sparse_linear.py:338"),
    "factor_health": ("albedo_tpu_torch/kernels/csrc/factor_health.cu", "albedo_tpu/utils/watchdog.py:55"),
    "segment_dot_grid": ("albedo_tpu_torch/kernels/csrc/segment_dot.cu",
                         "albedo_tpu/models/logistic_regression.py:381"),
    "gather_sum_grid": ("albedo_tpu_torch/kernels/csrc/gather_sum.cu", "albedo_tpu/models/logistic_regression.py:381"),
    "land_rows": ("albedo_tpu_torch/kernels/csrc/land_rows.cu", "albedo_tpu/ops/als.py:368"),
    "als_partials_bf16": ("albedo_tpu_torch/kernels/csrc/als_partials.cu", "albedo_tpu/ops/als.py:108"),
    "bucket_cg_bf16": ("albedo_tpu_torch/kernels/csrc/bucket_cg.cu", "albedo_tpu/ops/als.py:154"),
    "sgns_shared": ("albedo_tpu_torch/kernels/csrc/sgns_shared.cu", "albedo_tpu/models/word2vec.py:243"),
    "masked_topk_select": ("albedo_tpu_torch/kernels/csrc/topk_select.cu", "albedo_tpu/recommenders/cf.py:218"),
    "sgns_step_wide": ("albedo_tpu_torch/kernels/csrc/sgns_step.cu", "albedo_tpu/models/word2vec.py:241"),
    "bpr_step_wide": ("albedo_tpu_torch/kernels/csrc/bpr_step.cu", "albedo_tpu/models/ranking_factorization.py:152"),
    "bucket_cg_bf16_wide": ("albedo_tpu_torch/kernels/csrc/bucket_cg.cu", "albedo_tpu/ops/als.py:154"),
    "bucket_cg_tiled": ("albedo_tpu_torch/kernels/csrc/bucket_cg.cu", "albedo_tpu/ops/als.py:154"),
    # The whole-loop programs: CUDA graphs of the kernels above, an epoch captured and replayed.
    "w2v_epoch": ("albedo_tpu_torch/models/word2vec.py", "albedo_tpu/models/word2vec.py:339"),
    "bpr_fit": ("albedo_tpu_torch/models/ranking_factorization.py", "albedo_tpu/models/ranking_factorization.py:201"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` runs after one
    warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    if want.numel() == 0:
        return 0.0, 0.0
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    return diff, diff / max(scale, 1e-30)


# ------------------------------------------------------------------ phase 1


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU", file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return card


# ------------------------------------------------------------------ phase 2


def phase_build() -> None:
    from albedo_tpu_torch.kernels.build import build

    t0 = time.perf_counter()
    seconds = build(verbose=True)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_kernel_s": {k: round(v, 3) for k, v in seconds.items()}})


# ------------------------------------------------------------------ phase 3


def _bucket(rng, n_source: int, b: int, length: int, n_pad: int, dev):
    """A padded bucket like ``datasets.ragged`` builds: front-packed entries,
    idx 0 and val 0 off the mask, the last ``n_pad`` slots all padding."""
    lens = rng.integers(1, length + 1, size=b)
    lens[b - n_pad:] = 0
    lens[0] = length
    mask = np.arange(length)[None, :] < lens[:, None]
    idx = np.where(mask, rng.integers(0, n_source, size=(b, length)), 0).astype(np.int32)
    val = np.where(mask, rng.uniform(0.5, 1.5, size=(b, length)), 0.0).astype(np.float32)
    return (torch.as_tensor(idx, device=dev), torch.as_tensor(val, device=dev),
            torch.as_tensor(mask, device=dev))


def phase_kernels() -> dict:
    from albedo_tpu_torch.ops import als as ops_als

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    worst = {name: 0.0 for name in KERNELS}
    cases = []
    for k in (16, 50):
        n_source = 300
        src = torch.as_tensor((rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32), device=dev)
        yty = ops_als.gramian(src)
        for length in (1, 37, 200):
            idx, val, mask = _bucket(rng, n_source, 64, length, 8, dev)
            corr, b_vec = ops_als.bucket_partial_terms(src, idx, val, mask, 40.0)
            corr_p, b_p = ops_als.bucket_partial_terms_reference(src, idx, val, mask, 40.0)
            e1 = max(rel_err(corr, corr_p)[1], rel_err(b_vec, b_p)[1])
            n_b = mask.sum(dim=1, dtype=torch.float32)
            x = ops_als.solve_corrected(yty, corr_p, b_p, n_b, 0.5)
            x_p = ops_als.solve_corrected_reference(yty, corr_p, b_p, n_b, 0.5)
            e2 = rel_err(x, x_p)[1]
            x0 = torch.as_tensor((rng.standard_normal((64, k)) * 0.1).astype(np.float32), device=dev)
            y = ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3)
            y_p = ops_als.bucket_cg_reference(src, yty, idx, val, mask, x0, 0.5, 40.0, 3)
            e3 = rel_err(y, y_p)[1]
            torch.cuda.synchronize()
            for name, e in (("als_partials", e1), ("solve_corrected", e2), ("bucket_cg", e3)):
                worst[name] = max(worst[name], e)
            cases.append({"k": k, "L": length, "rel": [e1, e2, e3]})

    # K5: I not a multiple of any tile, duplicated item rows (exact ties),
    # -1-padded exclusion lists with duplicates, no exclusion list, then
    # fewer admissible items than k.
    n_users, n_items, r, top = 500, 19991, 50, 30
    uf = (rng.standard_normal((n_users, r)) / np.sqrt(r)).astype(np.float32)
    vf = (rng.standard_normal((n_items, r)) / np.sqrt(r)).astype(np.float32)
    vf[5000:5400] = vf[:400]
    vf[19990] = vf[3]
    excl = np.full((n_users, 80), -1, dtype=np.int32)
    excl[:, :60] = rng.integers(0, n_items, size=(n_users, 60))
    excl[:, 60] = excl[:, 0]
    k5_exact = True
    for u, v, ex in (
        (uf, vf, excl),
        (uf, vf, None),
        (uf[:20], vf[:40], np.tile(np.arange(25, dtype=np.int32), (20, 1))),
    ):
        u_t, v_t = (torch.as_tensor(a, device=dev) for a in (u, v))
        ex_t = None if ex is None else torch.as_tensor(ex, device=dev)
        k5_exact &= _hold_topk(u_t, v_t, top, ex_t)[1] == 0.0
    worst["topk_scores"] = 0.0 if k5_exact else float("inf")
    ok = all(worst[n] <= REL_TOL for n in ("als_partials", "solve_corrected", "bucket_cg")) and k5_exact
    emit({"phase": "kernels", "ok": ok, "rel_tol": REL_TOL, "worst_rel": worst,
          "topk_exact": k5_exact, "cases": cases})
    if not ok:
        raise SystemExit("chip_smoke: a kernel disagrees with its plain version")
    return worst


def mass_err(got: torch.Tensor, want: torch.Tensor, mass: torch.Tensor) -> tuple[float, float]:
    """(max |got - want|, max over elements of that over the element's L1
    mass, the sum of the absolute values of the terms summed into it), and
    inf if an element of mass 0 (no terms) is not exactly ``want``."""
    if want.numel() == 0:
        return 0.0, 0.0
    diff = (got - want).abs()
    if bool((diff[mass == 0] != 0).any()):
        return float("inf"), float("inf")
    return float(diff.max()), float((diff / mass.clamp_min(torch.finfo(torch.float32).tiny)).max())


def _k8_err(x, idx, val, indptr, got, want) -> tuple[float, float]:
    """K8's error against the L1 mass of each segment, sum |x[idx] val|."""
    from albedo_tpu_torch.ops import sparse_linear as sl

    return mass_err(got, want, sl.segment_dot_reference(x.abs(), idx, None if val is None else val.abs(), indptr))


def _k9_err(in_t, out_t, c, o, neg, got, want) -> tuple[float, float]:
    """K9's error on (grad_in, grad_out, loss) against their plain values:
    the gradients against each element's L1 mass, the loss against |loss|."""
    from albedo_tpu_torch.ops import sgns

    errs = [mass_err(a, e, m) for a, e, m in zip(got, want, sgns.sgns_grad_mass(in_t, out_t, c, o, neg))]
    errs.append(rel_err(got[2], want[2]))
    return max(e[0] for e in errs), max(e[1] for e in errs)


def _k8_orders(x, idx, val, ip, got) -> dict:
    """K8's (or K8g's) error against its plain version computed in float64,
    over the round-off bound of two summation orders, each as the worst
    error over the bound (at most 1 when it holds): ``bound_ratio``, the
    order K8 had before its merge-path partition (a warp per segment:
    (ceil(L / 32) + 6) 2^-24 of each segment's L1 mass), and
    ``bound_ratio_merge``, its own (``segment_dot.cu``: (min(L, 2) + 9 +
    [C > 1] (ceil((C - 1) / 32) + 6)) 2^-24 of the mass, C the CTAs whose
    merge steps the segment spans); with ``err``, (max |got - exact|, max of
    that over the mass)."""
    from albedo_tpu_torch.ops import sparse_linear as sl

    v64 = None if val is None else val.double()
    want64 = sl.segment_dot_reference(x.double(), idx, v64, ip)
    mass64 = sl.segment_dot_reference(x.double().abs(), idx, None if v64 is None else v64.abs(), ip)
    lens = (ip[1:] - ip[:-1]).double()
    seg = torch.arange(lens.numel(), device=ip.device, dtype=torch.float64)
    steps = sl.SEGMENT_DOT_STEPS
    ctas = torch.floor((seg + ip[1:].double()) / steps) - torch.floor((seg + ip[:-1].double()) / steps) + 1
    merge = torch.clamp(lens, max=sl.SEGMENT_DOT_IPT) + 9 + (ctas > 1) * (torch.ceil((ctas - 1) / 32) + 6)
    diff = (got.double() - want64).abs()
    tiny = torch.finfo(torch.float64).tiny

    def ratio(depth):
        return float((diff / (depth * 2.0**-24 * mass64).clamp_min(tiny)).max()) if diff.numel() else 0.0

    return {"err": mass_err(got.double(), want64, mass64), "bound_ratio": ratio(torch.ceil(lens / 32) + 6),
            "bound_ratio_merge": ratio(merge)}


def _k8_run(x, idx, val, ip) -> tuple[torch.Tensor, dict]:
    """One K8 (K8g for a 2-D ``x``) call, and whether it counted exactly one
    launch and a second call gave the same bits."""
    from albedo_tpu_torch.kernels import launch_counts
    from albedo_tpu_torch.ops import sparse_linear as sl

    before = launch_counts()
    got = sl.segment_dot(x, idx, val, ip)
    after = launch_counts()
    name, other = ("segment_dot_grid", "segment_dot") if x.dim() == 2 else ("segment_dot", "segment_dot_grid")
    one = after[name] - before[name] == 1 and after[other] == before[other]
    return got, {"one_launch": one, "repeat_equal": bool(torch.equal(got, sl.segment_dot(x, idx, val, ip)))}


def _k8_new_checks_ok(c: dict) -> bool:
    """The checks K8's merge-path partition added: its own order's bound,
    the same bits twice, one counted launch a call."""
    return c["bound_ratio_merge"] <= 1.0 and c["repeat_equal"] and c["one_launch"]


def _k8_case(rng, counts, n_x: int, with_val: bool, dev) -> dict:
    from albedo_tpu_torch.ops import sparse_linear as sl

    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nnz = int(indptr[-1])
    x = torch.as_tensor(rng.normal(size=n_x).astype(np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, n_x, size=nnz).astype(np.int32), device=dev)
    val = torch.as_tensor(rng.normal(size=nnz).astype(np.float32), device=dev) if with_val else None
    ip = torch.as_tensor(indptr, device=dev)
    got, run = _k8_run(x, idx, val, ip)
    orders = _k8_orders(x, idx, val, ip, got)
    return dict(run, err=_k8_err(x, idx, val, ip, got, sl.segment_dot_reference(x, idx, val, ip)),
                bound_ratio=orders["bound_ratio"], bound_ratio_merge=orders["bound_ratio_merge"])


def _k9_case(rng, b: int, d: int, v: int, k: int, dev) -> tuple[float, float]:
    from albedo_tpu_torch.ops import sgns

    in_t = torch.as_tensor(rng.uniform(-0.5 / d, 0.5 / d, size=(v, d)).astype(np.float32), device=dev)
    out_t = torch.as_tensor(rng.normal(scale=0.1, size=(v, d)).astype(np.float32), device=dev)
    c = rng.integers(0, v, size=b).astype(np.int32)
    c[: max(1, b // 3)] = 1  # duplicate centers
    neg = rng.integers(0, v, size=(b, k)).astype(np.int32)
    neg[:, 0] = 0            # duplicate negatives
    o = rng.integers(0, v, size=b).astype(np.int32)
    args = [torch.as_tensor(a, device=dev) for a in (c, o, neg)]
    res = []
    for fn in (sgns.sgns_step, sgns.sgns_step_reference):
        gi, go, loss = torch.zeros_like(in_t), torch.zeros_like(out_t), torch.zeros(1, device=dev)
        fn(in_t, out_t, *args, gi, go, loss)
        res.append((gi, go, loss))
    return _k9_err(in_t, out_t, *args, *res)


def _adam_case(rng, shape, count: int, dev) -> tuple[float, float]:
    from albedo_tpu_torch.ops import sgns

    base = [rng.normal(size=shape).astype(np.float32) for _ in range(3)]
    base.append((np.abs(rng.normal(size=shape)) * 1e-3).astype(np.float32))
    res = []
    for fn in (sgns.adam_dense, sgns.adam_dense_reference):
        p, g, m, v = (torch.as_tensor(a.copy(), device=dev) for a in base)
        fn(p, g, m, v, count, 0.025)
        res.append((p, g, m, v))
    errs = [rel_err(a, e) for a, e in zip(*res)]
    return max(e[0] for e in errs), max(e[1] for e in errs)


def phase_ranker_kernels() -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    worst = {name: 0.0 for name in RANKER_REL}
    cases = []

    def note(name, label, err, **more):
        worst[name] = max(worst[name], err[1])
        cases.append(dict({"kernel": name, "case": label, "abs": err[0], "rel": err[1]}, **more))

    heavy = rng.integers(0, 30, size=2000)
    heavy[::5] = 0
    heavy[[0, -1]] = 0
    heavy[3] = 50000  # a power-law head segment
    tail = np.concatenate([rng.integers(1, 60, size=300), np.zeros(200, np.int64)])
    k8_new_ok = True
    for label, counts, n_x in (
        ("empty segments", heavy, 700),
        ("one segment spans all entries", np.array([70000]), 900),
        ("zero-count vocab tail", tail, 5000),
        ("no entries", np.zeros(64, np.int64), 10),
    ):
        for with_val in (True, False):
            c = _k8_case(rng, counts, n_x, with_val, dev)
            note("segment_dot", f"{label}, val {'f32' if with_val else 'null'}", c.pop("err"), **c)
            k8_new_ok = k8_new_ok and _k8_new_checks_ok(c)
    for b, d in ((1, 8), (1, 200), (4096, 8), (4096, 200)):
        note("sgns_step", f"B={b} d={d} duplicates", _k9_case(rng, b, d, 146, 5, dev))
    for count in (1, 1000):
        for d in (8, 200):
            note("adam_dense", f"count={count} d={d}", _adam_case(rng, (2, 146, d), count, dev))
    torch.cuda.synchronize()
    ok = all(worst[n] <= RANKER_REL[n] for n in RANKER_REL) and k8_new_ok
    emit({"phase": "ranker_kernels", "ok": ok, "rel_tol": RANKER_REL, "worst_rel": worst,
          "segment_dot_merge_checks": k8_new_ok, "cases": cases})
    if not ok:
        raise SystemExit("chip_smoke: a ranker kernel disagrees with its plain version (or K8 with its "
                         "order's bound, itself, or its one launch)")
    return worst


def _hold_spmm(w, x) -> tuple[float, float]:
    """K11's spmm_rows against its plain version, relative to each output
    element's L1 mass; inf if a second call does not give the same bits."""
    from albedo_tpu_torch.ops import spmm

    got = spmm.spmm_rows(w, x)
    if not _same_bits(got, spmm.spmm_rows(w, x)):
        return float("inf"), float("inf")
    return mass_err(got, spmm.spmm_rows_reference(w, x), spmm.spmm_rows_mass(w, x))


def _hold_masked(scores, starred, k, norm) -> tuple[float, float]:
    """K11's masked_topk against its plain version, exactly (:func:`_exact`)."""
    from albedo_tpu_torch.ops import spmm

    return _exact(spmm.masked_topk(scores, starred, k, norm), spmm.masked_topk_reference(scores, starred, k, norm))


def _hold_bpr(params, g, users, pos, neg, reg) -> tuple[float, float]:
    """K10 against its plain version on one minibatch: each gradient element
    against its L1 mass (``ops.bpr.bpr_grad_mass``), the loss against
    |loss|."""
    from albedo_tpu_torch.ops import bpr

    res = []
    for fn in (bpr.bpr_step, bpr.bpr_step_reference):
        grads = [torch.zeros_like(t) for t in params]
        loss = torch.zeros(1, device=params[0].device)
        fn(*params, g, users, pos, neg, *grads, loss, reg)
        res.append((*grads, loss))
    mass = bpr.bpr_grad_mass(*params, g, users, pos, neg, reg)
    errs = [mass_err(a, e, m) for a, e, m in zip(res[0][:4], res[1][:4], mass)]
    errs.append(rel_err(res[0][4], res[1][4]))
    return max(e[0] for e in errs), max(e[1] for e in errs)


def _csr(rng, counts, n_cols: int, with_val: bool, dev):
    from albedo_tpu_torch.ops.spmm import CSR

    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nnz = int(indptr[-1])
    idx = rng.integers(0, n_cols, size=nnz).astype(np.int32)
    val = rng.uniform(0.1, 1.0, size=nnz).astype(np.float32) if with_val else None
    return CSR.from_host(indptr, idx, val, n_cols, dev)


def _bpr_params(rng, n_users: int, n_items: int, r: int, d: int, dev):
    """(x, y, bias, w) and g, as after some training, from a numpy seed."""
    arrays = [rng.normal(scale=0.1, size=(n_users, r)), rng.normal(scale=0.1, size=(n_items, r)),
              rng.normal(scale=0.1, size=n_items), rng.normal(size=d), rng.normal(size=(n_items, d))]
    t = [torch.as_tensor(a.astype(np.float32), device=dev) for a in arrays]
    return t[:4], t[4]


def phase_candidate_kernels() -> dict:
    """K5 at any rank (both paths), K11's spmm_rows and masked_topk, and K10
    on edge cases, each against its plain version."""
    from albedo_tpu_torch.ops.spmm import CSR

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    worst = {name: 0.0 for name in CAND_REL}
    cases = []

    def note(name, label, err):
        worst[name] = max(worst[name], err[1])
        cases.append({"kernel": name, "case": label, "abs": err[0], "rel": err[1]})

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    # K5: ranks 1 and 64 (narrow), 65, 200 and 3010 (wide; 65 and 3010 are
    # multiples of neither 4 nor 32); I = 1500, not a multiple of any tile;
    # duplicated item rows (exact ties), a query row of zeros (every score
    # ties), -1-padded exclusion rows with duplicates; then fewer admissible
    # items than k.
    for r in (1, 64, 65, 200, 3010):
        name = "topk_scores" if r <= 64 else "topk_scores_wide"
        uf = (rng.standard_normal((37, r)) / np.sqrt(r)).astype(np.float32)
        vf = (rng.standard_normal((1500, r)) / np.sqrt(r)).astype(np.float32)
        vf[700:760] = vf[:60]
        uf[0] = 0.0
        excl = np.full((37, 50), -1, dtype=np.int32)
        excl[:, :40] = rng.integers(0, 1500, size=(37, 40))
        excl[:, 40] = excl[:, 0]
        note(name, f"r={r}, exclusions, ties, a row of ties", _hold_topk(t(uf), t(vf), 30, t(excl)))
        note(name, f"r={r}, no exclusion list", _hold_topk(t(uf), t(vf), 30, None))
        note(name, f"r={r}, k > admissible", _hold_topk(
            t(uf[:5]), t(vf[:20]), 15, t(np.tile(np.arange(12, dtype=np.int32), (5, 1)))))

    # spmm_rows: empty rows and power-law head rows (the job's 1089 and the
    # bench's 6690 entries, split into chunks by its plan), rows of one
    # chunk and of one chunk and an entry, one row spanning every column, no
    # rows with entries at all; B = 1, 7 (no 16-byte loads), 256 and 300
    # (two passes of 256 columns); binary and weighted; the same bits twice.
    from albedo_tpu_torch.ops.spmm import SPMM_CHUNK

    heavy = rng.integers(0, 40, size=3000)
    heavy[::6] = 0
    heavy[7] = 1089
    heavy[8] = 6690
    heavy[9], heavy[10] = SPMM_CHUNK, SPMM_CHUNK + 1
    n_cols = 2936
    span = CSR.from_host(np.array([0, 5, 5 + n_cols, 5 + n_cols + 3], np.int32),
                         np.concatenate([rng.integers(0, n_cols, 5), rng.permutation(n_cols),
                                         rng.integers(0, n_cols, 3)]).astype(np.int32),
                         rng.uniform(0.1, 1.0, 8 + n_cols).astype(np.float32), n_cols, dev)
    for b in (1, 7, 256, 300):
        x = t(rng.uniform(0.0, 1.0, size=(n_cols, b)).astype(np.float32))
        for with_val in (True, False):
            kind = "weighted" if with_val else "binary"
            note("spmm_rows", f"B={b}, {kind}, empty rows + 1089- and 6690-entry rows",
                 _hold_spmm(_csr(rng, heavy, n_cols, with_val, dev), x))
            note("spmm_rows", f"B={b}, {kind}, no entries", _hold_spmm(_csr(rng, np.zeros(50, np.int64), n_cols, with_val, dev), x))
        note("spmm_rows", f"B={b}, one row spans every column", _hold_spmm(span, x))

    # masked_topk: duplicated columns (ties), a row of equal scores, a norm
    # with zeros (clamped to 1e-12), a transposed (strided) block, a row whose
    # every column is starred, and k > n.
    scores = rng.normal(size=(64, 2500)).astype(np.float32)
    scores[:, 1200:1300] = scores[:, :100]
    scores[3] = 0.5
    starred = np.full((64, 40), -1, dtype=np.int32)
    starred[:, :30] = rng.integers(0, 2500, size=(64, 30))
    starred[:, 30] = starred[:, 0]
    norm = rng.uniform(0.0, 3.0, size=2500).astype(np.float32)
    norm[::7] = 0.0
    for label, norm_t in (("norm", t(norm)), ("no norm", None)):
        note("masked_topk", f"ties, a row of ties, {label}", _hold_masked(t(scores), t(starred), 30, norm_t))
        note("masked_topk", f"strided block, {label}", _hold_masked(t(scores.T.copy()).t(), t(starred), 30, norm_t))
    small = rng.normal(size=(4, 20)).astype(np.float32)
    all_starred = np.tile(np.arange(20, dtype=np.int32), (4, 1))
    all_starred[1:, 10:] = -1
    note("masked_topk", "a row all starred, k > n", _hold_masked(t(small), t(all_starred), 30, None))
    note("masked_topk", "no starred list", _hold_masked(t(scores), None, 30, t(norm)))

    # bpr_step: B = 1 with the positive among its negatives and a repeated
    # negative; B = 8192 with hot users and items, negatives equal to the
    # positive; side features of width 2; the job's reg and a large one.
    params, g = _bpr_params(rng, 200, 150, 32, 2, dev)
    one = (t(np.array([3], np.int32)), t(np.array([5], np.int32)), t(np.array([[5, 7, 7, 9]], np.int32)))
    users = rng.integers(0, 200, size=8192).astype(np.int32)
    users[:3000] = 4
    pos = rng.integers(0, 150, size=8192).astype(np.int32)
    pos[::5] = 11
    neg = rng.integers(0, 150, size=(8192, 4)).astype(np.int32)
    neg[::3, 0] = pos[::3]
    batch = (t(users), t(pos), t(neg))
    for reg in (1e-4, 0.1):
        note("bpr_step", f"B=1, negatives = positive and repeated, reg {reg}", _hold_bpr(params, g, *one, reg))
        note("bpr_step", f"B=8192, duplicates, reg {reg}", _hold_bpr(params, g, *batch, reg))
    params16, g1 = _bpr_params(rng, 200, 150, 16, 1, dev)
    note("bpr_step", "r=16, d=1 (no side features)", _hold_bpr(params16, g1, *batch, 1e-4))
    torch.cuda.synchronize()
    ok = all(worst[n] <= CAND_REL[n] for n in CAND_REL)
    emit({"phase": "candidate_kernels", "ok": ok, "rel_tol": CAND_REL, "worst_rel": worst, "cases": cases})
    if not ok:
        raise SystemExit("chip_smoke: a candidate-generator kernel disagrees with its plain version")
    return worst


def phase_serving_kernels() -> dict:
    """K5 at k > 128 and on its split design's edge cases, K6 gather_topk and
    K7 bank_query on edge cases, each against its plain version, exactly
    (ties, NaN and -inf slots included)."""
    from albedo_tpu_torch.kernels.topk_bench import k5_edge_cases
    from albedo_tpu_torch.ops import topk as ops_topk

    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    worst = {name: 0.0 for name in ("topk_scores", "topk_scores_wide", "gather_topk", "bank_query")}
    cases = []

    def note(name, label, err):
        worst[name] = max(worst[name], err[1])
        cases.append({"kernel": name, "case": label, "abs": err[0], "rel": err[1]})

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def factors(n, r):
        return (rng.standard_normal((n, r)) / np.sqrt(r)).astype(np.float32)

    # K5 at k = 129, 256, 512 over the job's catalogue width (2936 items),
    # ties from duplicated rows, -1-padded exclusions with duplicates; and
    # a catalogue of 600 with 200 excluded, fewer admissible items than k.
    vf = factors(2936, 50)
    vf[1500:1600] = vf[:100]
    uf = factors(37, 50)
    excl = np.full((37, 300), -1, dtype=np.int32)
    excl[:, :250] = rng.integers(0, 2936, size=(37, 250))
    excl[:, 250] = excl[:, 0]
    for k in (129, 256, 512):
        note("topk_scores", f"k={k}, exclusions, ties", _hold_topk(t(uf), t(vf), k, t(excl)))
    small_excl = np.tile(np.arange(200, dtype=np.int32), (37, 1))
    note("topk_scores", "k=512, 400 admissible of 600", _hold_topk(t(uf), t(vf[:600]), 512, t(small_excl)))
    wide_v, wide_u = factors(1500, 200), factors(9, 200)
    note("topk_scores_wide", "r=200, k=512", _hold_topk(t(wide_u), t(wide_v), 512, t(excl[:9])))
    # K5's split design (topk_bench.k5_edge_cases): ties across every 32-item
    # boundary, a row of zeros, cancelling, NaN and +-inf scores, exclusion
    # rows with -1, out-of-range entries and duplicates, a row excluding
    # every item, fewer admissible items than k, one row and 500 rows, ranks
    # 1 to 3010, k 1 to 512; each call also bit-identical to a second one.
    for label, u, v, k, ex in k5_edge_cases():
        q_t, v_t, ex_t = t(u), t(v), None if ex is None else t(ex)
        first = ops_topk.topk_scores(q_t, v_t, k, ex_t)
        again = _exact(first, ops_topk.topk_scores(q_t, v_t, k, ex_t))
        err = _exact(first, ops_topk.topk_scores_reference(q_t, v_t, k, ex_t))
        note("topk_scores" if u.shape[1] <= 64 else "topk_scores_wide", f"split design: {label}",
             (err[0], max(err[1], again[1])))

    # K6 at buckets 1, 8 and 64, k = 32 and 512, in each exclusion mode: the
    # device table of every user's history (width = the longest), the
    # batch's own rows, none. Each row must also equal K5 on that user alone.
    n_users = 500
    uf_all = t(factors(n_users, 50))
    items = t(vf)
    table = np.full((n_users, 700), -1, dtype=np.int32)
    for u in range(n_users):
        n = int(rng.integers(0, 700))
        table[u, :n] = rng.choice(2936, size=n, replace=False)
    table_t = t(table)
    for bucket in (1, 8, 64):
        ui = rng.integers(0, n_users, size=bucket).astype(np.int32)
        ui[-1] = ui[0]  # a user twice in one batch
        ui_t = t(ui)
        for k in (32, 512):
            for mode in ("device", "host", "none"):
                kw = ({"exclude_table": table_t} if mode == "device"
                      else {"exclude": t(table[ui])} if mode == "host" else {})
                got = ops_topk.gather_topk(uf_all, items, ui_t, k, **kw)
                err = _exact(got, ops_topk.gather_topk_reference(uf_all, items, ui_t, k, **kw))
                ex_one = t(table[ui[:1]]) if mode != "none" else None
                alone = ops_topk.topk_scores(uf_all[ui_t[:1].long()].contiguous(), items, k, ex_one)
                same = _exact(tuple(x[:1] for x in got), alone)
                note("gather_topk", f"bucket {bucket}, k={k}, {mode} exclusion",
                     (max(err[0], same[0]), max(err[1], same[1])))

    # K7: user_rows without and with exclusion, and with a remapped exclusion
    # (a source whose rows are a shuffled subset of the matrix items); then
    # item_mean at d = 16, 50, 200 and 3010, with a row with no query, rows
    # with one and with 30 examples, and duplicated example rows.
    perm = rng.permutation(2936)[:2500]
    excl_map = np.full(2936, -1, dtype=np.int32)
    excl_map[perm] = np.arange(2500, dtype=np.int32)
    sub = t(vf[perm])
    ui = t(rng.integers(0, n_users, size=64).astype(np.int32))
    for k in (32, 512):
        for label, kw in (("user_rows", {}), ("user_rows, exclusion", {"exclude_table": table_t}),
                          ("user_rows, remapped exclusion", {"exclude_table": table_t, "excl_map": t(excl_map)})):
            items_k = sub if "remapped" in label else items
            got = ops_topk.bank_query(items_k, k, users=uf_all, user_idx=ui, **kw)
            note("bank_query", f"{label}, k={k}", _exact(got, ops_topk.bank_query_reference(
                items_k, k, users=uf_all, user_idx=ui, **kw)))
    for d in (16, 50, 200, 3010):
        table_d = np.abs(factors(2936, d)) if d == 3010 else factors(2936, d)
        q = np.full((64, 32), -1, dtype=np.int32)
        for b in range(1, 64):
            n = 1 if b % 5 == 0 else int(rng.integers(1, 31))
            q[b, :n] = rng.integers(0, 2936, size=n)
        q[3, 1] = q[3, 0]
        for k in (32, 512):
            got = ops_topk.bank_query(t(table_d), k, q_idx=t(q))
            note("bank_query", f"item_mean d={d}, k={k}, an empty row",
                 _exact(got, ops_topk.bank_query_reference(t(table_d), k, q_idx=t(q))))
    torch.cuda.synchronize()
    ok = all(v == 0.0 for v in worst.values())
    emit({"phase": "serving_kernels", "ok": ok, "worst_rel": worst, "cases": cases})
    if not ok:
        raise SystemExit("chip_smoke: a serving kernel disagrees with its plain version")
    return worst


def phase_repair_kernels() -> dict:
    """The three repaired refusals, each against its plain version: lax.top_k's
    NaN order in K6, K7, the select path (k 600) and K11's masked_topk (with
    and without a column norm) on K5's edge cases (``topk_bench.k5_edge_cases``:
    NaN and +-inf scores, zeros that cancel, ties across tiles), exactly;
    masked_topk at k 129, 512, 513 and 1200 and with a 40 000-wide starred row
    (its select path), exactly; K9 at d 513 and 1024 and K10 at rank 129 and
    200 and side width 33 (their wide paths), to K9's and K10's tolerances."""
    from albedo_tpu_torch.kernels.topk_bench import k5_edge_cases
    from albedo_tpu_torch.ops import spmm
    from albedo_tpu_torch.ops import topk as ops_topk

    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    tol = {"gather_topk": 0.0, "bank_query": 0.0, "gather_topk_select": 0.0, "masked_topk": 0.0,
           "masked_topk_select": 0.0, "sgns_step_wide": RANKER_REL["sgns_step"],
           "bpr_step_wide": CAND_REL["bpr_step"]}
    worst = dict.fromkeys(tol, 0.0)
    cases = []

    def note(name, label, err):
        worst[name] = max(worst[name], err[1])
        cases.append({"kernel": name, "case": label, "abs": err[0], "rel": err[1]})

    def t(a):
        return None if a is None else torch.as_tensor(np.ascontiguousarray(a), device=dev)

    for label, u, v, k, ex in k5_edge_cases():
        q, items, excl = t(u), t(v), t(ex)
        rows = torch.arange(q.shape[0], dtype=torch.int32, device=dev)
        note("gather_topk", label, _exact(ops_topk.gather_topk(q, items, rows, k, exclude=excl),
                                          ops_topk.gather_topk_reference(q, items, rows, k, exclude=excl)))
        note("bank_query", label, _exact(
            ops_topk.bank_query(items, k, users=q, user_idx=rows, exclude_table=excl),
            ops_topk.bank_query_reference(items, k, users=q, user_idx=rows, exclude_table=excl)))
        note("gather_topk_select", f"k=600, {label}",
             _exact(ops_topk.gather_topk(q, items, rows, 600, exclude=excl),
                    ops_topk.gather_topk_reference(q, items, rows, 600, exclude=excl)))
        scores = ops_topk._scores(q, items)
        norm = torch.linspace(0.5, 2.0, items.shape[0], device=dev)
        for kk in (k, 600):
            name = "masked_topk" if kk <= spmm.KMAX_STREAM else "masked_topk_select"
            for n in (None, norm):
                note(name, f"k={kk}, norm={n is not None}, {label}", _hold_masked(scores, excl, kk, n))

    block = rng.normal(size=(2936, 40)).astype(np.float32)
    block[1500:1600] = block[:100]
    block[:, 2] = 0.25
    block[7, 5], block[8, 5], block[9, 6] = np.nan, -np.nan, np.inf
    starred = np.full((40, 64), -1, np.int32)
    starred[:, :50] = rng.integers(0, 2936, size=(40, 50))
    scores = t(block).t()                               # a strided (B, n) view, as K11's callers pass it
    norm = t(rng.uniform(0.0, 3.0, size=2936).astype(np.float32))
    for k in (129, 512, 513, 1200):
        for n in (None, norm):
            note("masked_topk_select", f"k={k}, norm={n is not None}", _hold_masked(scores, t(starred), k, n))
    wide = t(rng.normal(size=(3, 60000)).astype(np.float32))
    long_star = t(np.stack([rng.choice(60000, size=40000, replace=False) for _ in range(3)]).astype(np.int32))
    for k in (30, 600):
        note("masked_topk_select", f"40000 starred, k={k}", _hold_masked(wide, long_star, k, None))

    for d in (513, 1024):
        for b in (1, 300, 4096):
            note("sgns_step_wide", f"B={b}, d={d}", _k9_case(rng, b, d, 146, 5, dev))
    for r, d in ((129, 2), (200, 2), (32, 33), (129, 33)):
        params, g = _bpr_params(rng, 300, 200, r, d, dev)
        users = rng.integers(0, 300, size=8192).astype(np.int32)
        users[:2730] = 7
        pos = rng.integers(0, 200, size=8192).astype(np.int32)
        neg = rng.integers(0, 200, size=(8192, 4)).astype(np.int32)
        neg[::2, 1] = pos[::2]
        note("bpr_step_wide", f"r={r}, d={d}", _hold_bpr(params, g, t(users), t(pos), t(neg), 1e-4))
    torch.cuda.synchronize()
    ok = all(worst[n] <= tol[n] for n in tol)
    emit({"phase": "repair_kernels", "ok": ok, "tol": tol, "worst_rel": worst, "cases": len(cases),
          "failing": [c for c in cases if c["rel"] > tol[c["kernel"]]]})
    if not ok:
        raise SystemExit("chip_smoke: a repaired kernel path disagrees with its plain version")
    return worst


# The select path of K5-K7 (k > 512, or an exclusion row the streaming body
# cannot sort) is exact against the plain version, as the streaming body is.
# K12: the count and the max are exact; the rms is the float32 rounding of a
# float64 sum taken in another order than the plain version's, so it may
# differ by one rounding: 1e-6 relative.
HEALTH_RMS_REL = 1e-6


def _als_case(rng, k: int, n_source: int, b: int, length: int, n_pad: int, dev,
              names=("als_partials", "solve_corrected", "bucket_cg"), gather_dtype=None) -> dict:
    """K1-K3 at rank k on one padded bucket, each against its plain version
    (rel error); K2 takes K1's plain output. ``gather_dtype="bfloat16"``
    holds K1-bf16 and K3-bf16 (the entries the bf16 gathers launch); K3-bf16
    row by row against ``ops.als.bucket_cg_bf16_limits``, its worst row's
    share of its limit reported times the base 5e-4."""
    from albedo_tpu_torch.ops import als as ops_als

    src = torch.as_tensor((rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32), device=dev)
    yty = ops_als.gramian(src)
    idx, val, mask = _bucket(rng, n_source, b, length, n_pad, dev)
    out = {}
    corr_p, b_p = ops_als.bucket_partial_terms_reference(src, idx, val, mask, 40.0, gather_dtype)
    if "als_partials" in names:
        corr, b_vec = ops_als.bucket_partial_terms(src, idx, val, mask, 40.0, gather_dtype)
        out["als_partials"] = max(rel_err(corr, corr_p)[1], rel_err(b_vec, b_p)[1])
    if "solve_corrected" in names:
        n_b = mask.sum(dim=1, dtype=torch.float32)
        live = n_b > 0  # padding slots solve YtY alone; the landing drops them
        x = ops_als.solve_corrected(yty, corr_p, b_p, n_b, 0.5)
        out["solve_corrected"] = rel_err(x[live], ops_als.solve_corrected_reference(yty, corr_p, b_p, n_b, 0.5)[live])[1]
    if "bucket_cg" in names:
        x0 = torch.as_tensor((rng.standard_normal((b, k)) * 0.1).astype(np.float32), device=dev)
        y = ops_als.bucket_cg_body(src, yty, idx, val, mask, x0, 0.5, 40.0, 3, gather_dtype=gather_dtype)
        want = ops_als.bucket_cg_reference(src, yty, idx, val, mask, x0, 0.5, 40.0, 3, gather_dtype)
        if gather_dtype is None:
            out["bucket_cg"] = rel_err(y, want)[1]
        else:  # F9: each row against its limit, reported as a share of it times the base 5e-4
            lim = ops_als.bucket_cg_bf16_limits(src, yty, idx, val, mask, x0, 0.5, 40.0, 3)
            out["bucket_cg"] = bf16_rel()["bucket_cg_bf16"] * float(ops_als.bucket_cg_bf16_over(y, want, lim).max())
    torch.cuda.synchronize()
    return out


def phase_any_size_kernels() -> dict:
    """K1-K3 above rank 64 (their wide paths, the global-workspace branches
    included) and K5-K7 above k = 512 and with exclusion rows longer than
    the streaming body sorts (the select path), each against its plain
    version: K1-K3 at rel 1e-4, K5-K7 exactly."""
    from albedo_tpu_torch.kernels import launch_counts, reset_launches
    from albedo_tpu_torch.ops import topk as ops_topk

    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    worst: dict[str, float] = {}
    cases = []

    def note(name, label, err):
        worst[name] = max(worst.get(name, 0.0), err)
        cases.append({"kernel": name, "case": label, "err": err})

    reset_launches()
    # Bench-shaped buckets (the bench catalogue of 19991 items as the source):
    # a full bucket of short rows, one of mid-length rows with padding slots,
    # and the power-law tail (the bench's longest row holds 7624 entries).
    for k in (65, 100, 128, 256):
        for b, length, n_pad in ((64, 37, 8), (48, 400, 4), (3, 7624, 0)):
            for name, e in _als_case(rng, k, 19991, b, length, n_pad, dev).items():
                note(name, f"rank {k}, B {b}, L {length}", e)
    # K3 above the shared-memory limit (rank 1500: its global workspace), K1
    # above its split design (rank 600: the tiled kernel, also timed).
    for name, e in _als_case(rng, 1500, 3000, 8, 64, 1, dev, names=("bucket_cg",)).items():
        note(name, "rank 1500, B 8, L 64", e)
    tiled = _time_k1_tiled(rng, dev)
    k3_tiled = _time_k3_tiled(rng, dev)
    als_counts = launch_counts()

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    def factors(n, r):
        return (rng.standard_normal((n, r)) / np.sqrt(r)).astype(np.float32)

    def exact(name, label, got, want):
        note(name, label, _exact(got, want)[1])

    # K5: k = 513, 600, 2048 and k = the catalogue, with ties from duplicated
    # rows and -1-padded exclusions with duplicates; fewer admissible items
    # than k; the wide rank; an exclusion row of 40 000 over 60 000 items.
    vf = factors(2936, 50)
    vf[1500:1600] = vf[:100]
    uf = factors(37, 50)
    excl = np.full((37, 300), -1, dtype=np.int32)
    excl[:, :250] = rng.integers(0, 2936, size=(37, 250))
    excl[:, 250] = excl[:, 0]
    for k in (513, 600, 2048, 2936):
        exact("topk_scores", f"k={k}, exclusions, ties", ops_topk.topk_scores(t(uf), t(vf), k, t(excl)),
              ops_topk.topk_scores_reference(t(uf), t(vf), k, t(excl)))
    exact("topk_scores", "k=600, no exclusion", ops_topk.topk_scores(t(uf), t(vf), 600),
          ops_topk.topk_scores_reference(t(uf), t(vf), 600))
    small_excl = np.tile(np.arange(200, dtype=np.int32), (37, 1))
    exact("topk_scores", "k=2048, 400 admissible of 600",
          ops_topk.topk_scores(t(uf), t(vf[:600]), 2048, t(small_excl)),
          ops_topk.topk_scores_reference(t(uf), t(vf[:600]), 2048, t(small_excl)))
    wide_v, wide_u = factors(1500, 200), factors(9, 200)
    exact("topk_scores", "r=200, k=600", ops_topk.topk_scores(t(wide_u), t(wide_v), 600, t(excl[:9])),
          ops_topk.topk_scores_reference(t(wide_u), t(wide_v), 600, t(excl[:9])))
    big_v, big_u = factors(60000, 50), factors(4, 50)
    long_excl = np.full((4, 40000), -1, dtype=np.int32)
    for u in range(4):
        n = 40000 - 7 * u
        long_excl[u, :n] = rng.choice(60000, size=n, replace=False)
    for k in (30, 600):
        exact("topk_scores", f"exclusion row of 40000, k={k}",
              ops_topk.topk_scores(t(big_u), t(big_v), k, t(long_excl)),
              ops_topk.topk_scores_reference(t(big_u), t(big_v), k, t(long_excl)))

    # K5 with its workspace budget cut so that 500 rows take 16 passes of 32.
    budget = ops_topk.K5_WORKSPACE
    ops_topk.K5_WORKSPACE = 1
    try:
        pass_u, pass_v = factors(500, 50), factors(19991, 50)
        pass_ex = rng.integers(-1, 19991, size=(500, 700)).astype(np.int32)
        for k in (30, 512):
            exact("topk_scores", f"500 rows in passes of 32, k={k}",
                  ops_topk.topk_scores(t(pass_u), t(pass_v), k, t(pass_ex)),
                  ops_topk.topk_scores_reference(t(pass_u), t(pass_v), k, t(pass_ex)))
    finally:
        ops_topk.K5_WORKSPACE = budget

    # K6 at buckets 1/8/64 x k 513/600/2048 in each exclusion mode, each row
    # also equal to K5 on that user alone; and a device table of 40 000-wide
    # rows (the streaming body would have to sort each in shared memory).
    n_users = 500
    uf_all = t(factors(n_users, 50))
    items = t(vf)
    table = np.full((n_users, 700), -1, dtype=np.int32)
    for u in range(n_users):
        n = int(rng.integers(0, 700))
        table[u, :n] = rng.choice(2936, size=n, replace=False)
    table_t = t(table)
    for bucket in (1, 8, 64):
        ui = rng.integers(0, n_users, size=bucket).astype(np.int32)
        ui[-1] = ui[0]
        ui_t = t(ui)
        for k in (513, 600, 2048):
            for mode in ("device", "host", "none"):
                kw = ({"exclude_table": table_t} if mode == "device"
                      else {"exclude": t(table[ui])} if mode == "host" else {})
                got = ops_topk.gather_topk(uf_all, items, ui_t, k, **kw)
                exact("gather_topk", f"bucket {bucket}, k={k}, {mode}", got,
                      ops_topk.gather_topk_reference(uf_all, items, ui_t, k, **kw))
                ex_one = t(table[ui[:1]]) if mode != "none" else None
                alone = ops_topk.topk_scores(uf_all[ui_t[:1].long()].contiguous(), items, k, ex_one)
                exact("gather_topk", f"bucket {bucket}, k={k}, {mode}: row = K5 alone",
                      tuple(x[:1] for x in got), alone)
    big_uf = t(factors(6, 50))
    big_table = t(long_excl[[0, 1, 2, 3, 0, 1]])
    ui_t = t(np.array([3, 0, 5, 1], dtype=np.int32))
    got = ops_topk.gather_topk(big_uf, t(big_v), ui_t, 30, exclude_table=big_table)
    exact("gather_topk", "device rows of 40000, k=30", got,
          ops_topk.gather_topk_reference(big_uf, t(big_v), ui_t, 30, exclude_table=big_table))
    for b in range(4):
        alone = ops_topk.topk_scores(big_uf[ui_t[b:b + 1].long()].contiguous(), t(big_v), 30,
                                     big_table[ui_t[b:b + 1].long()].contiguous())
        exact("gather_topk", f"device rows of 40000: row {b} = K5 alone", tuple(x[b:b + 1] for x in got), alone)

    # K7: user rows (plain, excluded, remapped) and item means (d 50, 3010,
    # an empty row) at k = 600 and 2048.
    perm = rng.permutation(2936)[:2500]
    excl_map = np.full(2936, -1, dtype=np.int32)
    excl_map[perm] = np.arange(2500, dtype=np.int32)
    sub = t(vf[perm])
    ui = t(rng.integers(0, n_users, size=64).astype(np.int32))
    for k in (600, 2048):
        for label, kw in (("user_rows", {}), ("user_rows, exclusion", {"exclude_table": table_t}),
                          ("user_rows, remapped exclusion", {"exclude_table": table_t, "excl_map": t(excl_map)})):
            items_k = sub if "remapped" in label else items
            exact("bank_query", f"{label}, k={k}", ops_topk.bank_query(items_k, k, users=uf_all, user_idx=ui, **kw),
                  ops_topk.bank_query_reference(items_k, k, users=uf_all, user_idx=ui, **kw))
        for d in (50, 3010):
            table_d = t(np.abs(factors(2936, d)) if d == 3010 else factors(2936, d))
            q = np.full((64, 32), -1, dtype=np.int32)
            for b in range(1, 64):
                n = 1 if b % 5 == 0 else int(rng.integers(1, 31))
                q[b, :n] = rng.integers(0, 2936, size=n)
            exact("bank_query", f"item_mean d={d}, k={k}, an empty row",
                  ops_topk.bank_query(table_d, k, q_idx=t(q)), ops_topk.bank_query_reference(table_d, k, q_idx=t(q)))
    torch.cuda.synchronize()
    counts = {n: c for n, c in launch_counts().items() if c}
    paths = ("als_partials_wide", "als_partials_tiled", "solve_corrected_wide", "bucket_cg_wide", "bucket_cg_tiled",
             "topk_scores_select", "gather_topk_select", "bank_query_select")
    ok = (all(worst[n] <= REL_TOL for n in ("als_partials", "solve_corrected", "bucket_cg"))
          and tiled["rel_err"] <= REL_TOL and k3_tiled["rel_err"] <= REL_TOL and k3_tiled["same_bits"]
          and all(worst[n] == 0.0 for n in ("topk_scores", "gather_topk", "bank_query"))
          and all(counts.get(p, 0) > 0 for p in paths))
    emit({"phase": "any_size_kernels", "ok": ok, "rel_tol": REL_TOL, "worst": worst,
          "als_launches": {n: c for n, c in als_counts.items() if c}, "launches": counts, "cases": cases,
          "timed": {"als_partials_tiled": tiled, "bucket_cg_tiled": k3_tiled}})
    if not ok:
        raise SystemExit("chip_smoke: a wide or select path disagrees with its plain version (or never ran)")
    return {"bucket_cg_tiled": k3_tiled}


def _time_k1_tiled(rng, dev) -> dict:
    """K1's tiled path (rank 600, above its split design) on a bucket of 64
    rows of up to 400 entries: held against its plain version and timed
    with it, the library yardstick and its bound."""
    from albedo_tpu_torch.ops import als as ops_als

    k, n_source = 600, 19991
    src = torch.as_tensor((rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32), device=dev)
    idx, val, mask = _bucket(rng, n_source, 64, 400, 4, dev)
    got = ops_als.bucket_partial_terms(src, idx, val, mask, ALPHA)
    want = ops_als.bucket_partial_terms_reference(src, idx, val, mask, ALPHA)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    rows, entries = idx.shape[0], int(mask.sum())
    return _timed(dict(
        err=(max(e[0] for e in errs), max(e[1] for e in errs)),
        ms=cuda_ms(lambda: ops_als.bucket_partial_terms(src, idx, val, mask, ALPHA)),
        plain_ms=cuda_ms(lambda: ops_als.bucket_partial_terms_reference(src, idx, val, mask, ALPHA)),
        library_ms=cuda_ms(lambda: _k1_library(src, idx, val, mask, ALPHA)),
        bytes=9 * idx.numel() + 4 * k * int(torch.unique(idx[mask]).numel()) + 4 * rows * (k * k + k),
        flops=entries * (k * (k + 1) + 2 * k), shape=[rows, idx.shape[1], k]))


def _time_k3_tiled(rng, dev) -> dict:
    """K3's tiled path (rank 600, above its split design) on a bucket of 64
    rows of up to 400 entries: held against its plain version (rel error,
    the same bits on a second call) and timed with it and its bound (the
    table's bytes: the rows the bucket gathers, as K1's tiled path)."""
    from albedo_tpu_torch.ops import als as ops_als

    k, n_source, b = 600, 19991, 64
    src = torch.as_tensor((rng.standard_normal((n_source, k)) / np.sqrt(k)).astype(np.float32), device=dev)
    idx, val, mask = _bucket(rng, n_source, b, 400, 4, dev)
    x0 = torch.as_tensor((rng.standard_normal((b, k)) * 0.1).astype(np.float32), device=dev)
    call = (src, ops_als.gramian(src), idx, val, mask, x0, mask.any(dim=1), mask.sum(dim=1, dtype=torch.float32))
    got, again = (ops_als.bucket_cg_body(*call[:6], REG, ALPHA, CG_STEPS) for _ in range(2))
    want = ops_als.bucket_cg_reference(*call[:6], REG, ALPHA, CG_STEPS)
    return _timed(dict(
        err=rel_err(got, want), ms=cuda_ms(lambda: ops_als.bucket_cg_body(*call[:6], REG, ALPHA, CG_STEPS)),
        plain_ms=cuda_ms(lambda: ops_als.bucket_cg_reference(*call[:6], REG, ALPHA, CG_STEPS)), library_ms=None,
        same_bits=_same_bits(got, again), shape=[b, idx.shape[1], k], **_k3_work([call], distinct=True)))


def _gather_sum_err(base, tables, idxs, got, want) -> tuple[float, float]:
    """K8c's forward error against the L1 mass of each row's terms."""
    from albedo_tpu_torch.ops import sparse_linear as sl

    mass = sl.gather_sum_reference(base.abs(), [x.abs() for x in tables], idxs)
    return mass_err(got, want, mass)


def _hold_gather_sum(base, tables, idxs, layouts, g) -> dict:
    """K8c forward (against the plain sum, per row relative to its terms'
    mass) and its backward (each table's gradient against the plain version's
    autograd gradient, per entry relative to the mass of the terms summed
    into it, sum |g| over the rows that read it)."""
    from albedo_tpu_torch.ops import sparse_linear as sl

    got = sl.gather_sum(base, tables, idxs)
    want = sl.gather_sum_reference(base, tables, idxs)
    fwd = _gather_sum_err(base, tables, idxs, got, want)
    ts = [x.detach().clone().requires_grad_(True) for x in tables]
    orders = [lay[0] for lay in layouts]
    indptrs = [lay[1] for lay in layouts]
    sl._GatherSum.apply(base, (idxs, orders, indptrs), *ts).backward(g)
    ps = [x.detach().clone().requires_grad_(True) for x in tables]
    sl.gather_sum_reference(base, ps, idxs).backward(g)
    bwd = [0.0, 0.0]
    for tk, tp, idx in zip(ts, ps, idxs):
        mass = torch.zeros_like(tp).index_add_(0, idx.long(), g.abs())
        e = mass_err(tk.grad, tp.grad, mass)
        bwd = [max(bwd[0], e[0]), max(bwd[1], e[1])]
    torch.cuda.synchronize()
    return {"forward": fwd, "backward": tuple(bwd)}


def phase_two_stage_kernels() -> dict:
    """K8c gather_sum (forward and its K8 backward) on a synthetic batch
    with a field of one category, empty categories and 40 terms (two chained
    launches), and K12 factor_health on the bench tables' shapes, finite and
    with NaN and +-inf planted."""
    from albedo_tpu_torch.ops import sparse_linear as sl
    from albedo_tpu_torch.utils import watchdog

    dev = torch.device("cuda")
    rng = np.random.default_rng(29)
    n = 100_000
    res = {}
    for n_terms in (3, 40):
        sizes = [1, 7, 300, 5000] * 10
        sizes = sizes[:n_terms]
        tables = [torch.as_tensor(rng.normal(size=s).astype(np.float32), device=dev) for s in sizes]
        idxs = [torch.as_tensor(rng.integers(0, max(1, s // 2 + 1), size=n).astype(np.int32), device=dev)
                for s in sizes]
        layouts = [sl._sorted_layout(i, s) for i, s in zip(idxs, sizes)]
        base = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
        g = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=dev)
        res[f"{n_terms} terms"] = _hold_gather_sum(base, tables, idxs, layouts, g)
    gather_ok = all(v["forward"][1] <= RANKER_REL["segment_dot"] and v["backward"][1] <= RANKER_REL["segment_dot"]
                    for v in res.values())

    health = {}
    for label, plant in (("finite", None), ("nan", float("nan")), ("+inf", float("inf")), ("-inf", float("-inf"))):
        uf = torch.as_tensor(rng.standard_normal((30000, 50)).astype(np.float32), device=dev)
        vf = torch.as_tensor((rng.standard_normal((19991, 50)) * 3).astype(np.float32), device=dev)
        if plant is not None:
            uf.view(-1)[rng.integers(0, uf.numel(), size=17)] = plant
            vf.view(-1)[rng.integers(0, vf.numel(), size=5)] = plant
            vf[0, 0] = 1e30  # a finite outlier that must stay the max
        got = watchdog.factor_health(uf, vf).cpu()
        want = watchdog.factor_health_reference(uf, vf).cpu()
        again = watchdog.factor_health(uf, vf).cpu()
        health[label] = {"got": got.tolist(), "want": want.tolist(),
                         "count_max_exact": bool(torch.equal(got[:2], want[:2])),
                         "rms_rel": abs(float(got[2]) - float(want[2])) / max(abs(float(want[2])), 1e-30),
                         "repeat_bitwise": bool(torch.equal(got, again))}
    health_ok = all(h["count_max_exact"] and h["rms_rel"] <= HEALTH_RMS_REL and h["repeat_bitwise"]
                    for h in health.values())
    ok = gather_ok and health_ok
    emit({"phase": "two_stage_kernels", "ok": ok, "gather_sum": res, "factor_health": health,
          "tol": {"gather_sum": RANKER_REL["segment_dot"], "factor_health_rms": HEALTH_RMS_REL}})
    if not ok:
        raise SystemExit("chip_smoke: K8c or K12 disagrees with its plain version")
    return res


# ------------------------------------------------------------------ phase 4


def _run_cli(argv: list[str]) -> tuple[dict, str]:
    """Run one job through the CLI with every launch count set to 0 just
    before and read just after; returns (report, the job's output)."""
    from albedo_tpu_torch import cli, kernels

    out = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    text = out.getvalue()
    print(text, end="", flush=True)
    if rc != 0:
        raise SystemExit(f"chip_smoke: {argv} exited {rc}")
    return {"argv": argv, "seconds": round(seconds, 3), "launches": launches}, text


def _run_job(argv: list[str]) -> dict:
    report, text = _run_cli(argv)
    ndcg = float(re.search(r"NDCG@30 = (\S+)", text).group(1))
    health = re.search(r"fit health = (\{.*\})", text).group(1)
    nonfinite = int(re.search(r"'nonfinite': (\d+)", health).group(1))
    return dict(report, ndcg=ndcg, nonfinite=nonfinite)


def _hold_at_job(argv: list[str], needed: tuple[str, ...]) -> None:
    """Hold each kernel in ``needed`` against its plain version on the
    inputs the job run ``argv`` gives it: the same arguments rebuild the
    same tables, matrix, bucket groups and seeded fit; K1-K3 take every
    group of one iteration at the fitted tables, K5 the job's test users
    with no exclusion list (``ALSRecommender(exclude_seen=False)``)."""
    from albedo_tpu_torch import cli
    from albedo_tpu_torch.builders.jobs import TOP_K, JobContext

    ctx = JobContext(cli.parse_args(argv))
    model = ctx.als_model()
    est = ctx.als_estimator()
    if (est.alpha, est.reg_param, est.cg_steps) != (ALPHA, REG, CG_STEPS):
        raise SystemExit(f"chip_smoke: the job's alpha, reg and CG steps are not {ALPHA, REG, CG_STEPS}")
    calls = _sweep_calls(est, ctx.matrix(), model)
    errs = _hold_sweeps(calls, [n for n in needed if n != "topk_scores"])
    rows = torch.as_tensor(ctx.test_user_dense(), dtype=torch.int64, device=model.device)
    errs["topk_scores"] = _hold_topk(model.user_table[rows].contiguous(), model.item_table, TOP_K, None)
    ok = _within_tol(errs)
    emit({"phase": "job_kernels", "argv": argv, "ok": ok, "groups": len(calls),
          "users": int(rows.numel()), "rel_tol": REL_TOL, "err": errs})
    if not ok:
        raise SystemExit(f"chip_smoke: a kernel disagrees with its plain version at the inputs of {argv}")


def phase_job() -> dict:
    launches = {}
    for argv, needed in (
        (["train_als"], ("als_partials", "solve_corrected", "land_rows", "topk_scores")),
        (["train_als", "--solver", "cg"], ("bucket_cg", "land_rows", "topk_scores")),
    ):
        report = _run_job(argv)
        counts = report["launches"]
        ok = all(counts[n] > 0 for n in needed) and report["nonfinite"] == 0 and bool(np.isfinite(report["ndcg"]))
        emit(dict(report, phase="job", ok=ok))
        if not ok:
            raise SystemExit(f"chip_smoke: {argv} did not launch {needed} or produced non-finite factors")
        for n in needed:
            launches[n] = max(launches.get(n, 0), counts[n])
        _hold_at_job(argv, needed)
    return launches


# ------------------------------------------------------------------ phase 5

RANKER_NEEDS = {
    "train_word2vec": ("sgns_step", "adam_dense"),
    "train_lr": ("als_partials", "solve_corrected", "land_rows", "topk_scores", "segment_dot", "gather_sum",
                 "sgns_step", "adam_dense", "factor_health"),
}


def phase_ranker_job() -> tuple[dict, dict]:
    """The ranker jobs at full width, with the inputs their kernels saw
    recorded on the way (the LR fit's arguments and model, the Word2Vec
    plan and final optimizer state)."""
    from albedo_tpu_torch.models import logistic_regression as lr_mod
    from albedo_tpu_torch.models import word2vec as w2v_mod

    inputs: dict = {}
    fit, train = lr_mod.LogisticRegression.fit, w2v_mod.Word2Vec.train

    def recording_fit(self, fm, labels, sample_weight=None, _damped_retry=False):
        model = fit(self, fm, labels, sample_weight, _damped_retry)
        inputs["lr"] = (self, fm, labels, sample_weight, model)
        return model

    def recording_train(self, plan, dev, **kw):
        state, report = train(self, plan, dev, **kw)
        inputs["w2v"] = (self, plan, state)
        return state, report

    value_and_grad = lr_mod._value_and_grad
    inputs["lr_evals"] = 0

    def counting_value_and_grad(loss_fn, theta):
        inputs["lr_evals"] += 1
        return value_and_grad(loss_fn, theta)

    launches = {}
    lr_mod.LogisticRegression.fit, w2v_mod.Word2Vec.train = recording_fit, recording_train
    lr_mod._value_and_grad = counting_value_and_grad
    try:
        for job in ("train_word2vec", "train_lr"):
            report, text = _run_cli([job, "--w2v-full", "--now", "1600000000"])
            counts = report["launches"]
            ok = all(counts[n] > 0 for n in RANKER_NEEDS[job])
            if job == "train_lr":
                auc = float(re.search(r"areaUnderROC = (\S+)", text).group(1))
                ndcg = float(re.search(r"NDCG@30 = (\S+)", text).group(1))
                it = re.search(r"lbfgs iterations = (\d+), final loss = (\S+)", text)
                stages = json.loads(re.search(r"stages = (\{.*\})", text).group(1))
                report.update(auc=auc, ndcg=ndcg, lbfgs_iterations=int(it.group(1)),
                              final_loss=float(it.group(2)), stages=stages,
                              jax=JAX_RANKER, tol=RANKER_TOL)
                ok = (ok and bool(np.isfinite([auc, ndcg, float(it.group(2))]).all()) and auc > 0.5
                      and abs(auc - JAX_RANKER["auc"]) <= RANKER_TOL["auc"]
                      and abs(ndcg - JAX_RANKER["ndcg"]) <= RANKER_TOL["ndcg"])
                launches = {n: counts[n] for n in ("segment_dot", "sgns_step", "adam_dense")}
            else:
                w2v = re.search(r"pairs = (\d+), steps = (\d+), final epoch loss = (\S+), compile = (\S+)s", text)
                report.update(pairs=int(w2v.group(1)), steps=int(w2v.group(2)),
                              final_epoch_loss=float(w2v.group(3)), compile_s=float(w2v.group(4)))
                ok = ok and bool(np.isfinite(report["final_epoch_loss"]))
            emit(dict(report, phase="ranker_job", ok=ok))
            if not ok:
                raise SystemExit(f"chip_smoke: {job} did not launch {RANKER_NEEDS[job]}, "
                                 "gave a non-finite result or left the JAX band")
    finally:
        lr_mod.LogisticRegression.fit, w2v_mod.Word2Vec.train = fit, train
        lr_mod._value_and_grad = value_and_grad
    _ranker_job_shared()
    return launches, inputs


@contextlib.contextmanager
def _shared_weights():
    """Within the block, every ALS fit starts from the numpy init and every
    Word2Vec fit returns the numpy vectors of ``jax_reference_ndcg.py ranker
    --shared``."""
    from albedo_tpu_torch.models import als as als_mod
    from albedo_tpu_torch.models import word2vec as w2v_mod

    als_fit, fit_corpus = als_mod.ImplicitALS.fit, w2v_mod.Word2Vec.fit_corpus

    def shared_als_fit(self, matrix, *a, **k):
        self.init_factors = _shared_init(matrix.n_users, matrix.n_items, self.rank)
        return als_fit(self, matrix, *a, **k)

    def shared_fit_corpus(self, sentences):
        vocab = self.plan(sentences).vocab
        rng = np.random.default_rng(SHARED_SEED)
        vectors = rng.normal(scale=SHARED_W2V_SCALE, size=(len(vocab), self.dim)).astype(np.float32)
        return w2v_mod.Word2VecModel(vocab, vectors, self.input_col, self.output_col or f"{self.input_col}__w2v")

    als_mod.ImplicitALS.fit, w2v_mod.Word2Vec.fit_corpus = shared_als_fit, shared_fit_corpus
    try:
        yield
    finally:
        als_mod.ImplicitALS.fit, w2v_mod.Word2Vec.fit_corpus = als_fit, fit_corpus


def _ranker_job_shared() -> None:
    """``train_lr --w2v-full`` with the weights ``jax_reference_ndcg.py
    ranker --shared`` gives both packages (every ALS fit from one numpy
    init, numpy Word2Vec vectors over the job's vocabulary), held to the JAX
    package's values in that mode at float32 round-off."""
    with _shared_weights():
        report, text = _run_cli(["train_lr", "--w2v-full", "--now", "1600000000"])
    got = {"auc": float(re.search(r"areaUnderROC = (\S+)", text).group(1)),
           "ndcg": float(re.search(r"NDCG@30 = (\S+)", text).group(1))}
    gap = {n: got[n] - JAX_RANKER_SHARED[n] for n in got}
    ok = all(abs(gap[n]) <= RANKER_SHARED_TOL[n] for n in got)
    emit(dict(report, phase="ranker_job_shared", ok=ok, **got, jax=JAX_RANKER_SHARED, gap=gap,
              tol=RANKER_SHARED_TOL))
    if not ok:
        raise SystemExit("chip_smoke: train_lr with shared weights left the JAX band")


def _lr_fit_profile(lr_inputs, iters: int = 5) -> dict:
    """A short re-fit at the job's LR inputs under ``torch.profiler``: wall
    seconds, the device's busy share (kernel time over wall), and the ops
    with the most host and device time."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    est, fm, labels, weights, _ = lr_inputs
    short = dataclasses.replace(est, max_iter=iters)
    short.fit(fm, labels, weights)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = short.fit(fm, labels, weights)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return dict({"iterations": model.n_iter_run}, **_device_summary(prof, wall))


def _device_ms(fn) -> float | None:
    """Milliseconds the card spends in kernels and copies during one run of
    ``fn`` (``torch.profiler``, after a warm-up run): the device's share of
    a time that CUDA events measure together with the host's launches. A
    window with no device record (seen once on an H100 for a run that
    launched 20 kernels) is profiled again, twice at most; None if all
    three came back empty."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        busy = _device_summary(prof, 1.0)["device_busy_s"]
        if busy > 0:
            return 1e3 * busy
    return None


def _device_summary(prof, wall: float) -> dict:
    """From a ``torch.profiler`` run of ``wall`` seconds: the device's busy
    seconds (kernel and copy time) and idle share, and the ops with the most
    host and device time."""
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # Kernels and copies only: an operator's entry repeats its kernels' time.
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(device_us(e) for e in on_device) / 1e6
    top = sorted(events, key=lambda e: -e.self_cpu_time_total)[:6]
    top_dev = sorted(on_device, key=lambda e: -device_us(e))[:6]
    return {
        "wall_s": wall, "device_busy_s": busy, "idle_share": max(0.0, 1.0 - busy / wall),
        "top_host_ms": [[e.key, e.count, e.self_cpu_time_total / 1e3] for e in top],
        "top_device_ms": [[e.key, e.count, device_us(e) / 1e3] for e in top_dev],
    }


def _k8_calls(lr_inputs) -> list[tuple]:
    """The K8 calls of one forward and one backward of the LR objective at
    the job's feature batch and fitted coefficients, recorded as they are
    made: (x, idx, val, indptr)."""
    from albedo_tpu_torch.models import logistic_regression as lr_mod
    from albedo_tpu_torch.ops import sparse_linear as sl

    est, fm, labels, weights, model = lr_inputs
    dev = torch.device("cuda")
    batch = sl.feature_batch(fm, dev, grad_layout=True)
    scales = lr_mod._to_device(model.scales, dev)
    params = {k: v.requires_grad_(True) for k, v in lr_mod._to_device(model.params, dev).items()}
    center = None if model.center is None else torch.as_tensor(model.center).to(dev)
    y = torch.as_tensor(np.asarray(labels, np.float32)).to(dev)
    w = torch.as_tensor(np.asarray(weights, np.float32)).to(dev)
    calls = []
    orig = sl.segment_dot

    def recording(x, idx, val, indptr):
        calls.append((x.detach().clone(), idx, val, indptr))
        return orig(x, idx, val, indptr)

    sl.segment_dot = recording
    try:
        loss = sl.weighted_logloss(params, scales, batch, y, w, est.reg_param, center=center)
        loss.backward()
    finally:
        sl.segment_dot = orig
    return calls


def _w2v_at_vocab(v: int, d: int, b: int, k: int, seed: int = 11):
    """One K9 + Adam step's inputs at a vocabulary of ``v`` words, made from
    a numpy seed: Zipf word counts; centers and contexts drawn from the
    subsampled (1e-3) unigram distribution; negatives by inverse CDF over
    unigram^0.75, as the fit draws them; tables at the fit's initial scale
    ("out" as after some training); moments of a warm state at step 1000.
    Returns (tables (2, v, d), (m, v), centers, contexts, negatives, step)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    freq = 1.0 / np.arange(1, v + 1)
    f = freq / freq.sum()
    p = f * np.minimum(1.0, np.sqrt(1e-3 / f) + 1e-3 / f)
    p /= p.sum()
    c, o = (rng.choice(v, size=b, p=p).astype(np.int32) for _ in range(2))
    cdf = np.cumsum(freq**0.75 / (freq**0.75).sum()).astype(np.float32)
    neg = np.minimum(np.searchsorted(cdf, rng.random((b, k)).astype(np.float32)), v - 1).astype(np.int32)
    tables = np.stack([rng.uniform(-0.5 / d, 0.5 / d, size=(v, d)), rng.normal(scale=0.1, size=(v, d))])
    m = rng.normal(scale=1e-4, size=tables.shape)
    moments = (m, m * m + np.abs(rng.normal(scale=1e-8, size=tables.shape)))
    def to(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return (to(tables), tuple(to(x) for x in moments), to(c, torch.int32), to(o, torch.int32),
            to(neg, torch.int32), 1000)


def _k9_adam_at(tables, moments, c, o, neg, count: int, lr: float) -> dict:
    """K9 and Adam at one batch and optimizer state: each held against its
    plain version on the same inputs (Adam on K9's plain gradient), then
    timed with its plain version and a library call, with the bytes and
    operations of its bound."""
    from albedo_tpu_torch.ops import sgns

    k9, plain_grads = _time_k9(tables[0], tables[1], c, o, neg)
    return {"sgns_step": k9, "adam_dense": _adam_at(tables, torch.stack(plain_grads), moments, count, lr)}


def _time_k9(in_t, out_t, c, o, neg) -> tuple[dict, tuple]:
    """K9 (either path) at one batch: held against its plain version, timed
    with it, with the bytes and operations of its bound; and the plain
    version's (grad_in, grad_out)."""
    from albedo_tpu_torch.ops import sgns

    dev = in_t.device
    v_size, d = in_t.shape
    bs, k = neg.shape
    res = []
    for fn in (sgns.sgns_step, sgns.sgns_step_reference):
        gi, go, loss = torch.zeros_like(in_t), torch.zeros_like(out_t), torch.zeros(1, device=dev)
        fn(in_t, out_t, c, o, neg, gi, go, loss)
        res.append((gi, go, loss))
    k9_err = _k9_err(in_t, out_t, c, o, neg, *res)
    gi, go, loss = torch.zeros_like(in_t), torch.zeros_like(out_t), torch.zeros(1, device=dev)
    k9_plain_ms = cuda_ms(lambda: sgns.sgns_step_reference(in_t, out_t, c, o, neg, gi, go, loss))
    # The rows the batch touches: each "in" and "out" row read once, each of
    # their gradient rows read and written once (K9 adds into them).
    rows = int(torch.unique(c).numel()) + int(torch.unique(torch.cat([o, neg.reshape(-1)])).numel())
    return dict(
        err=k9_err,
        ms=cuda_ms(lambda: sgns.sgns_step(in_t, out_t, c, o, neg, gi, go, loss)),
        # The library yardstick is the plain autograd step itself (gather,
        # einsum, binary_cross_entropy_with_logits, autograd's scatter-add).
        plain_ms=k9_plain_ms, library_ms=k9_plain_ms,
        bytes=4 * d * 3 * rows + 4 * bs * (2 + k) + 8, flops=bs * (1 + k) * (6 * d + 20),
        shape={"B": bs, "d": int(d), "V": int(v_size), "K": k, "rows_touched": rows},
    ), res[1][:2]


def _adam_at(tables, grad, moments, count: int, lr: float) -> dict:
    """Adam (``adam_dense``) at one optimizer state and gradient: held
    against its plain version, then timed with it and with torch's fused
    Adam, with the bytes and operations of its bound."""
    from albedo_tpu_torch.ops import sgns

    dev = tables.device
    v_size, d = tables.shape[1:]

    def state():
        return [tables.clone(), grad.clone(), moments[0].clone(), moments[1].clone()]

    step = torch.tensor(float(count), device=dev)

    def fused_adam(p, g, m, v):
        # torch.optim.Adam(fused=True)'s kernel on the same state, then the
        # gradient zeroing that adam_dense fuses. It differs from optax only
        # in rounding sqrt(v) / sqrt(bc2) where optax takes sqrt(v / bc2).
        torch._fused_adam_([p], [g], [m], [v], [], [step], lr=lr, beta1=0.9, beta2=0.999,
                           weight_decay=0.0, eps=1e-8, amsgrad=False, maximize=False)
        g.zero_()

    adam_res = []
    for fn in (lambda *a: sgns.adam_dense(*a, count, lr), lambda *a: sgns.adam_dense_reference(*a, count, lr),
               fused_adam):
        st = state()
        fn(*st)
        adam_res.append(st)
    adam_errs = [rel_err(a, e) for a, e in zip(adam_res[0], adam_res[1])]
    bufs = state()
    return dict(
        err=(max(e[0] for e in adam_errs), max(e[1] for e in adam_errs)),
        ms=cuda_ms(lambda: sgns.adam_dense(*bufs, count, lr)),
        plain_ms=cuda_ms(lambda: sgns.adam_dense_reference(*bufs, count, lr)),
        library_ms=cuda_ms(lambda: fused_adam(*bufs)),
        library_rel_err=max(rel_err(a, e)[1] for a, e in zip(adam_res[2], adam_res[1])),
        bytes=32 * tables.numel(), flops=12 * tables.numel(),
        shape={"tables": 2, "V": int(v_size), "d": int(d)},
    )


def _timed(r: dict) -> dict:
    """A kernel's record for the kernels line: its errors and times, and
    its bound from the bytes and operations of the work."""
    t_bytes, t_ops = r["bytes"] / PEAK_BYTES * 1e3, r["flops"] / PEAK_FP32 * 1e3
    bound_ms, bound_by = _bound_ms(r)
    out = {
        "max_abs_err": r["err"][0], "rel_err": r["err"][1], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "library_ms": r["library_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
        "bytes": r["bytes"], "flops": r["flops"], "shape": r.get("shape"),
        "library_rel_err": r.get("library_rel_err"),
    }
    if r.get("no_fma"):  # K5/K14: a multiply and an add a term, half the FP32 peak
        out["bound_no_fma_ms"] = max(t_bytes, 2 * t_ops)
    out.update({key: r[key] for key in ("tol", "tol_cap", "over", "faults", "same_bits", "same_bits_calls", "mm_ms",
                                        "kernel_ms")
                if key in r})
    return out


def phase_ranker_timing(inputs: dict) -> dict:
    """K8, K9 and Adam against their plain versions at the ranker job's own
    inputs, then timed with a library call and their bound; K9 and Adam
    also at a realistic vocabulary."""
    from albedo_tpu_torch.ops import sparse_linear as sl

    out = {}
    # K8: every call of one forward + backward of the LR objective.
    calls = _k8_calls(inputs["lr"])
    runs = [_k8_run(*c) for c in calls]
    k8_errs = [_k8_err(*c, got, sl.segment_dot_reference(*c)) for c, (got, _) in zip(calls, runs)]
    orders = [_k8_orders(*c, got) for c, (got, _) in zip(calls, runs)]
    merge_checks = {"bound_ratio": max(o["bound_ratio"] for o in orders),
                    "bound_ratio_merge": max(o["bound_ratio_merge"] for o in orders),
                    "repeat_equal": all(r["repeat_equal"] for _, r in runs),
                    "one_launch": all(r["one_launch"] for _, r in runs)}
    # The library yardstick: each call as a CSR matrix times x (cuSPARSE
    # SpMV). Rows may repeat a column (a bag row counting one token twice),
    # which torch's invariant check refuses and SpMV sums, so the check is
    # off and the SpMV is held against the plain version instead.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        csr = [
            torch.sparse_csr_tensor(ip, idx, val if val is not None else torch.ones_like(idx, dtype=torch.float32),
                                    size=(ip.shape[0] - 1, x.shape[0]), check_invariants=False)
            for x, idx, val, ip in calls
        ]
        library_err = max(_k8_err(*c, m @ c[0], sl.segment_dot_reference(*c))[1] for m, c in zip(csr, calls))
    k8_bytes = sum(4 * (idx.numel() * (2 if val is not None else 1) + ip.numel() + x.numel() + ip.numel() - 1)
                   for x, idx, val, ip in calls)
    k8_ops = sum(idx.numel() * (2 if val is not None else 1) for _, idx, val, _ in calls)
    out["segment_dot"] = dict(
        err=(max(e[0] for e in k8_errs), max(e[1] for e in k8_errs)),
        ms=cuda_ms(lambda: [sl.segment_dot(*c) for c in calls]),
        plain_ms=cuda_ms(lambda: [sl.segment_dot_reference(*c) for c in calls]),
        library_ms=cuda_ms(lambda: [m @ c[0] for m, c in zip(csr, calls)]),
        library_rel_err=library_err,
        bytes=k8_bytes, flops=k8_ops,
        shape={"calls": len(calls), "nnz": [int(c[1].numel()) for c in calls],
               "segments": [int(c[3].numel() - 1) for c in calls],
               "longest": [int((c[3][1:] - c[3][:-1]).max()) if c[3].numel() > 1 else 0 for c in calls]},
    )
    # Which calls set the time: each call alone (the kernel's wrapper and
    # the SpMV, each 20 times), and the card's kernel time of the 20 calls
    # (torch.profiler) beside the events' time, which includes the host's.
    per_call = [{"nnz": int(c[1].numel()), "segments": int(c[3].numel() - 1),
                 "longest": int((c[3][1:] - c[3][:-1]).max()) if c[3].numel() > 1 else 0,
                 "val": c[2] is not None,
                 "ms": cuda_ms(lambda c=c: sl.segment_dot(*c), reps=20),
                 "library_ms": cuda_ms(lambda m=m, x=c[0]: m @ x, reps=20)} for m, c in zip(csr, calls)]
    k8_device = {"ms": _device_ms(lambda: [sl.segment_dot(*c) for c in calls]),
                 "library_ms": _device_ms(lambda: [m @ c[0] for m, c in zip(csr, calls)])}

    # K9 and Adam: a batch of the job's pairs at its final optimizer state.
    est, plan, state = inputs["w2v"]
    tables = state["tables"]
    dev = tables.device
    v_size = tables.shape[1]
    bs, k = min(est.batch_size, len(plan.centers)), est.negatives
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    u = torch.rand((bs, k), generator=gen, device=dev)
    neg = torch.searchsorted(state["noise_cdf"], u).clamp_max_(v_size - 1).to(torch.int32)
    c = torch.as_tensor(plan.centers[:bs].astype(np.int32), device=dev)
    o = torch.as_tensor(plan.contexts[:bs].astype(np.int32), device=dev)
    out.update(_k9_adam_at(tables, state["moments"], c, o, neg, state["count"] + 1, est.learning_rate))
    # And at a realistic vocabulary, where Adam's pass over (2, V, 200) and
    # K9's contention on the frequent rows behave otherwise.
    at_vocab = _k9_adam_at(*_w2v_at_vocab(W2V_VOCAB, est.dim, est.batch_size, k), est.learning_rate)
    torch.cuda.synchronize()
    timed = {name: _timed(r) for name, r in out.items()}
    at_vocab = {name: _timed(r) for name, r in at_vocab.items()}
    ok = (all(max(timed[n]["rel_err"], at_vocab.get(n, timed[n])["rel_err"]) <= RANKER_REL[n] for n in RANKER_REL)
          and _k8_new_checks_ok(merge_checks))
    emit({"phase": "ranker_job_kernels", "ok": ok, "rel_tol": RANKER_REL, "timed": timed,
          "segment_dot_merge_checks": merge_checks, "segment_dot_per_call": per_call,
          "segment_dot_device": k8_device, "at_vocab": at_vocab, "lr_evals_in_job": inputs["lr_evals"],
          "lr_fit_profile": _lr_fit_profile(inputs["lr"])})
    if not ok:
        raise SystemExit("chip_smoke: a ranker kernel disagrees with its plain version at the job's inputs "
                         "(or K8 with its order's bound, itself, or its one launch)")
    return timed


# ------------------------------------------------------------------ phase 6

NOW = ["--now", "1600000000"]
# (label, argv, kernels the run must launch). ``content`` without
# ``--w2v-full`` runs on the Word2Vec vectors shared with JAX (dim 16).
CANDIDATE_RUNS = [
    ("popularity", ["popularity"], ()),
    ("curation", ["curation"], ()),
    ("item_cf", ["item_cf"], ("spmm_rows", "masked_topk")),
    ("user_cf", ["user_cf"], ("spmm_rows", "masked_topk")),
    ("ranking_mf", ["ranking_mf"], ("bpr_step", "adam_dense", "topk_scores")),
    ("tfidf_content", ["tfidf_content"], ("topk_scores_wide",)),
    ("content --w2v-full", ["content", "--w2v-full"], ("sgns_step", "adam_dense", "topk_scores_wide")),
    ("content shared", ["content"], ("topk_scores",)),
]


@contextlib.contextmanager
def _recording(calls: list):
    """Record the calls the candidate jobs make to the new kernels' wrappers
    (and K5's) as (kernel, args), by the names the calling modules bound;
    K10's parameter tables are cloned (Adam updates them in place after the
    step), and only its last call is kept."""
    from albedo_tpu_torch.models import ranking_factorization as rf
    from albedo_tpu_torch.ops import bpr, spmm, topk
    from albedo_tpu_torch.recommenders import cf, tfidf

    def spmm_rows(w, x):
        calls.append(("spmm_rows", (w, x)))
        return spmm.spmm_rows(w, x)

    def masked_topk(scores, starred, k, col_norm=None):
        calls.append(("masked_topk", (scores, starred, k, col_norm)))
        return spmm.masked_topk(scores, starred, k, col_norm)

    def topk_scores(q, items, k, exclude_idx=None, item_block=4096):
        calls.append(("topk_scores" if q.shape[1] <= topk.RMAX else "topk_scores_wide", (q, items, k, exclude_idx)))
        return topk.topk_scores(q, items, k, exclude_idx, item_block)

    def bpr_step(x, y, bias, w, g, users, pos, neg, gx, gy, gbias, gw, loss_acc, reg):
        saved = ((x.clone(), y.clone(), bias.clone(), w.clone()), g, users, pos, neg, reg)
        if calls and calls[-1][0] == "bpr_step":
            calls[-1] = ("bpr_step", saved)
        else:
            calls.append(("bpr_step", saved))
        return bpr.bpr_step(x, y, bias, w, g, users, pos, neg, gx, gy, gbias, gw, loss_acc, reg)

    patches = [(cf, "spmm_rows", spmm_rows), (cf, "masked_topk", masked_topk), (tfidf, "topk_scores", topk_scores),
               (rf, "topk_scores", topk_scores), (rf, "bpr_step", bpr_step)]
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, fn in patches:
        setattr(m, name, fn)
    try:
        yield calls
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


@contextlib.contextmanager
def _shared_w2v_vectors():
    """Word2Vec fits return the numpy vectors of ``jax_reference_ndcg.py
    ranker --shared`` over the job's vocabulary (``default_rng(1)``, normal,
    scale 0.3), as ``jax_reference_ndcg.py candidates`` gives the JAX job."""
    from albedo_tpu_torch.models import word2vec as w2v_mod

    fit_corpus = w2v_mod.Word2Vec.fit_corpus

    def shared(self, sentences):
        vocab = self.plan(sentences).vocab
        rng = np.random.default_rng(SHARED_SEED)
        vectors = rng.normal(scale=SHARED_W2V_SCALE, size=(len(vocab), self.dim)).astype(np.float32)
        return w2v_mod.Word2VecModel(vocab, vectors, self.input_col, self.output_col or f"{self.input_col}__w2v")

    w2v_mod.Word2Vec.fit_corpus = shared
    try:
        yield
    finally:
        w2v_mod.Word2Vec.fit_corpus = fit_corpus


def _hold_call(kernel: str, args) -> tuple[float, float]:
    """One recorded call's kernel against its plain version."""
    if kernel == "spmm_rows":
        return _hold_spmm(*args)
    if kernel == "masked_topk":
        return _hold_masked(*args)
    if kernel == "bpr_step":
        return _hold_bpr(*args)
    return _hold_topk(*args)


def _tfidf_list_ok(got: list, want: list) -> bool:
    """The printed similar-repo list ([score, repo] pairs) against JAX's:
    the same printed scores position by position, within one unit of the
    4th decimal; where the repos differ, the port's repo must hold a JAX
    score within that unit of the JAX score at that position (two near-tied
    repos swapped), or, if JAX did not list it, that position must tie the
    10th score (a near-tie at the cut)."""
    if len(got) != len(want) or len({n for _, n in got}) != len(got):
        return False
    want_score = {n: float(s) for s, n in want}
    cut = float(want[-1][0])
    for (s, n), (ws, wn) in zip(got, want):
        if abs(float(s) - float(ws)) > 1.5e-4:
            return False
        if n != wn and abs(want_score.get(n, cut) - float(ws)) > 1.5e-4:
            return False
    return True


def phase_candidates() -> tuple[dict, dict]:
    """The candidate jobs at full width, each with the launch counts set to
    0 before and read after, held to the JAX package's CPU values; then each
    new kernel against its plain version on the inputs the job gave it."""
    launches, calls_by_run = {}, {}
    from torch.profiler import ProfilerActivity, profile

    for label, argv, needed in CANDIDATE_RUNS:
        calls: list = []
        with _recording(calls), (_shared_w2v_vectors() if label == "content shared" else contextlib.nullcontext()):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                report, text = _run_cli(argv + NOW)
        report["profile"] = _device_summary(prof, report["seconds"])
        counts = report["launches"]
        ok = all(counts[n] > 0 for n in needed)
        if label == "tfidf_content":
            got = re.findall(r"\[tfidf_content\] (\d\.\d{4}) (\S+)", text)
            ok = ok and _tfidf_list_ok(got, JAX_TFIDF_TOP)
            report.update(similar=got, jax=JAX_TFIDF_TOP)
        else:
            ndcg = float(re.search(r"NDCG@30 = (\S+)", text).group(1))
            ok = ok and bool(np.isfinite(ndcg)) and abs(ndcg - JAX_CANDIDATES[label]) <= CANDIDATE_TOL[label]
            report.update(ndcg=ndcg, jax=JAX_CANDIDATES[label], tol=CANDIDATE_TOL[label])
            fit = re.search(r"steps = (\d+), final epoch loss = (\S+), fit = (\S+)s, compile = (\S+)s", text)
            if fit:
                report.update(steps=int(fit.group(1)), final_epoch_loss=float(fit.group(2)),
                              fit_s=float(fit.group(3)), compile_s=float(fit.group(4)))
        errs: dict = {}
        for kernel, args in calls:
            e = _hold_call(kernel, args)
            errs[kernel] = max(errs.get(kernel, (0.0, 0.0)), e, key=lambda t: t[1])
        torch.cuda.synchronize()
        held = all(rel <= CAND_REL[k] for k, (_, rel) in errs.items())
        emit(dict(report, phase="candidates", job=label, ok=ok and held, held_at_job=errs,
                  calls={k: sum(c[0] == k for c in calls) for k in errs}))
        if not (ok and held):
            raise SystemExit(f"chip_smoke: {label} did not launch {needed}, left the JAX band, "
                             "or a kernel disagreed with its plain version at its inputs")
        for n in needed:
            launches[n] = max(launches.get(n, 0), counts[n])
        calls_by_run[label] = calls
    return launches, calls_by_run


def _csr_library(w):
    """``w`` as a torch CSR tensor (for the cuSPARSE SpMM yardstick)."""
    val = w.val if w.val is not None else torch.ones_like(w.idx, dtype=torch.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # torch's beta-state notice for sparse CSR
        return torch.sparse_csr_tensor(w.indptr, w.idx, val, size=(w.n_rows, w.n_cols),
                                       check_invariants=False)


def _spmm_work(w, x) -> tuple[int, int]:
    nnz, b = int(w.idx.numel()), int(x.shape[1])
    return (4 * (w.n_rows + 1 + nnz * (1 if w.val is None else 2) + x.numel() + w.n_rows * b), 2 * nnz * b)


def _time_spmm(calls) -> dict:
    """spmm_rows over ``calls`` [(w, x)]: error, times, library (cuSPARSE
    SpMM through ``torch.sparse.mm`` on a CSR tensor) and work."""
    from albedo_tpu_torch.ops import spmm

    csr = [_csr_library(w) for w, _ in calls]
    lib_err = max(mass_err(torch.sparse.mm(m, x), spmm.spmm_rows_reference(w, x), spmm.spmm_rows_mass(w, x))[1]
                  for m, (w, x) in zip(csr, calls))
    work = [_spmm_work(w, x) for w, x in calls]
    errs = [_hold_spmm(w, x) for w, x in calls]
    return dict(
        err=(max(e[0] for e in errs), max(e[1] for e in errs)),
        ms=cuda_ms(lambda: [spmm.spmm_rows(w, x) for w, x in calls]),
        plain_ms=cuda_ms(lambda: [spmm.spmm_rows_reference(w, x) for w, x in calls]),
        library_ms=cuda_ms(lambda: [torch.sparse.mm(m, x) for m, (_, x) in zip(csr, calls)]),
        library_rel_err=lib_err, bytes=sum(b for b, _ in work), flops=sum(f for _, f in work),
        shape={"calls": [[w.n_rows, w.n_cols, int(w.idx.numel()), int(x.shape[1]),
                          int((w.indptr[1:] - w.indptr[:-1]).max())] for w, x in calls]},
    )


def _time_masked(calls) -> dict:
    """masked_topk over ``calls`` [(scores, starred, k, norm)]; the library
    yardstick is ``torch.topk`` on the block already normalized and masked
    (the masking has no single library call)."""
    from albedo_tpu_torch.ops import spmm

    masked = []
    for scores, starred, k, norm in calls:
        s = scores / torch.clamp_min(norm, 1e-12)[None, :] if norm is not None else scores.contiguous()
        ex = torch.where(starred < 0, s.shape[1], starred.long())
        hit = torch.zeros((s.shape[0], s.shape[1] + 1), dtype=torch.bool, device=s.device).scatter_(1, ex, True)
        masked.append((s.masked_fill(hit[:, :-1], float("-inf")), k))
    errs = [_hold_masked(*c) for c in calls]
    return dict(
        err=(max(e[0] for e in errs), max(e[1] for e in errs)),
        ms=cuda_ms(lambda: [spmm.masked_topk(*c) for c in calls]),
        plain_ms=cuda_ms(lambda: [spmm.masked_topk_reference(*c) for c in calls]),
        library_ms=cuda_ms(lambda: [torch.topk(s, k, dim=1) for s, k in masked]),
        bytes=sum(4 * (s.numel() + st.numel() + (0 if n is None else n.numel())) + 8 * s.shape[0] * k
                  for s, st, k, n in calls),
        flops=sum(s.numel() * (2 if n is not None else 1) for s, _, _, n in calls),
        shape={"calls": [[int(s.shape[0]), int(s.shape[1]), int(st.shape[1]), k] for s, st, k, _ in calls]},
    )


def _time_bpr(params, g, users, pos, neg, reg) -> dict:
    """bpr_step at one minibatch; no single library call computes it."""
    from albedo_tpu_torch.ops import bpr

    grads = [torch.zeros_like(p) for p in params]
    loss = torch.zeros(1, device=g.device)
    b, n = neg.shape
    r, d = params[0].shape[1], g.shape[1]
    rows_x = int(torch.unique(users).numel())
    rows_y = int(torch.unique(torch.cat([pos, neg.reshape(-1)])).numel())
    return dict(
        err=_hold_bpr(params, g, users, pos, neg, reg),
        ms=cuda_ms(lambda: bpr.bpr_step(*params, g, users, pos, neg, *grads, loss, reg)),
        plain_ms=cuda_ms(lambda: bpr.bpr_step_reference(*params, g, users, pos, neg, *grads, loss, reg)),
        library_ms=None,
        # each touched row of x and y (and its bias and side row) read once,
        # each of their gradient rows read and written once; the ids.
        bytes=4 * (3 * r * (rows_x + rows_y) + (3 + d) * rows_y + b * (2 + n)),
        flops=b * (1 + n) * (2 * r + 2 * d) + b * n * (6 * r + 2 * d + 20),
        shape={"B": b, "N": n, "r": r, "d": d, "rows_x": rows_x, "rows_y": rows_y},
    )


def _time_topk(calls) -> dict:
    """K5 over ``calls`` [(q, items, k, ex)]; the library yardstick is
    ``torch.topk`` of the masked ``Q @ V^T``."""
    from albedo_tpu_torch.ops import topk

    def library(q, items, k, ex):
        scores = q @ items.T
        if ex is not None:
            ex_l = torch.where(ex < 0, items.shape[0], ex.long())
            hit = torch.zeros((q.shape[0], items.shape[0] + 1), dtype=torch.bool, device=q.device)
            hit.scatter_(1, ex_l, True)
            scores = scores.masked_fill(hit[:, :-1], float("-inf"))
        return torch.topk(scores, k, dim=1)

    errs = [_hold_topk(*c) for c in calls]
    return dict(
        err=(max(e[0] for e in errs), max(e[1] for e in errs)),
        ms=cuda_ms(lambda: [topk.topk_scores(*c) for c in calls]),
        plain_ms=cuda_ms(lambda: [topk.topk_scores_reference(*c) for c in calls]),
        library_ms=cuda_ms(lambda: [library(*c) for c in calls]),
        bytes=sum(4 * (q.numel() + v.numel() + (0 if ex is None else ex.numel())) + 8 * q.shape[0] * k
                  for q, v, k, ex in calls),
        flops=sum(2 * q.shape[0] * v.shape[0] * q.shape[1] for q, v, _, _ in calls),
        shape={"calls": [[int(q.shape[0]), int(v.shape[0]), int(q.shape[1]), k] for q, v, k, _ in calls]},
        no_fma=True,
    )


def phase_candidate_timing(calls_by_run: dict) -> dict:
    """The new kernels timed at the candidate jobs' own inputs, with their
    plain versions, a library call and their bound: K11 at the item-CF and
    user-CF score blocks (both passes of each, then both masked top-ks), K10
    at ranking_mf's last step, K5's wide path at the content job's query
    (d = 200) and at tfidf_content's (one row of r = 3010)."""
    def of(run, kernel, min_b=2):
        return [a for k, a in calls_by_run[run] if k == kernel and (kernel != "spmm_rows" or a[1].shape[1] >= min_b)]

    out = {
        "spmm_rows": _time_spmm(of("item_cf", "spmm_rows") + of("user_cf", "spmm_rows")),
        "masked_topk": _time_masked(of("item_cf", "masked_topk") + of("user_cf", "masked_topk")),
        "bpr_step": _time_bpr(*of("ranking_mf", "bpr_step")[-1]),
        "topk_scores_wide": _time_topk(of("content --w2v-full", "topk_scores_wide")),
    }
    extra = {
        "spmm_rows item_cf": _time_spmm(of("item_cf", "spmm_rows")),
        "spmm_rows user_cf": _time_spmm(of("user_cf", "spmm_rows")),
        "topk_scores_wide tfidf": _time_topk(of("tfidf_content", "topk_scores_wide")),
        "topk_scores ranking_mf": _time_topk(of("ranking_mf", "topk_scores")),
    }
    torch.cuda.synchronize()
    timed = {name: _timed(r) for name, r in out.items()}
    more = {name: _timed(r) for name, r in extra.items()}
    ok = all(v["rel_err"] <= CAND_REL[name.split()[0]] for name, v in {**timed, **more}.items())
    emit({"phase": "candidate_job_kernels", "ok": ok, "rel_tol": CAND_REL, "timed": timed, "more": more})
    if not ok:
        raise SystemExit("chip_smoke: a candidate kernel disagrees with its plain version at the job's inputs")
    return timed


def phase_candidate_bench(train) -> None:
    """K11 and K10 at bench scale (phase 7's 30000 x 20000, mean-60 train
    split): one block of 256 users through both CFs' passes and masked
    top-k, and one bpr_step at B = 8192, rank 32, two side features, each
    held against its plain version and timed."""
    from albedo_tpu_torch.datasets import sample_test_users
    from albedo_tpu_torch.datasets.ragged import padded_rows
    from albedo_tpu_torch.recommenders import cf

    dev = torch.device("cuda")
    indptr, cols, _ = train.csr()
    users = sample_test_users(train, n=256, seed=42)
    star_idx = torch.as_tensor(padded_rows(indptr, cols, users), device=dev)
    out = {}
    for cls in (cf.ItemCFRecommender, cf.UserCFRecommender):
        calls: list = []
        rec = cls(train, top_k=30, device=dev)
        with _recording(calls):
            rec._score_block(star_idx, 30)
        out[f"spmm_rows {rec.source}"] = _time_spmm([a for k, a in calls if k == "spmm_rows"])
        out[f"masked_topk {rec.source}"] = _time_masked([a for k, a in calls if k == "masked_topk"])
    rng = np.random.default_rng(5)
    params, g = _bpr_params(rng, train.n_users, train.n_items, 32, 2, dev)
    pick = rng.choice(train.nnz, size=8192, replace=False)
    batch = [torch.as_tensor(a, device=dev) for a in (
        train.rows[pick].astype(np.int32), train.cols[pick].astype(np.int32),
        rng.integers(0, train.n_items, size=(8192, 4)).astype(np.int32))]
    out["bpr_step"] = _time_bpr(params, g, *batch, 1e-4)
    torch.cuda.synchronize()
    timed = {name: _timed(r) for name, r in out.items()}
    ok = all(v["rel_err"] <= CAND_REL[name.split()[0]] for name, v in timed.items())
    emit({"phase": "candidate_bench_kernels", "ok": ok, "users": 256, "star_width": int(star_idx.shape[1]),
          "timed": timed})
    if not ok:
        raise SystemExit("chip_smoke: a candidate kernel disagrees with its plain version at bench scale")


# ------------------------------------------------------ shared by 4 and 7

ALPHA, REG, CG_STEPS = 40.0, 0.5, 3  # the fits' alpha, reg and CG steps


def _sweep_calls(est, matrix, model) -> list[tuple]:
    """The per-group kernel inputs of one fit iteration at ``model``'s
    tables, both half-sweeps (items first), formed as ``ops.als.half_sweep``
    forms them: (source, yty, idx, val, mask, x0, rows that are not padding,
    entries per row)."""
    from albedo_tpu_torch.ops import als as ops_als

    ug, ig, _, _ = est.device_groups(matrix)
    uf, vf = model.user_table, model.item_table
    calls = []
    for source, target, groups in ((uf, vf, ig), (vf, uf, ug)):
        yty = ops_als.gramian(source)
        for g in groups:
            n, b, length = g.idx.shape
            idx, val, mask = (t.reshape(n * b, length) for t in (g.idx, g.val, g.mask))
            x0 = target[g.row_ids.reshape(-1).clamp(min=0).long()]
            valid = g.row_ids.reshape(-1) >= 0
            calls.append((source, yty, idx, val, mask, x0, valid, mask.sum(dim=1, dtype=torch.float32)))
    return calls


def _k1(fn, calls):
    return [fn(c[0], c[2], c[3], c[4], ALPHA) for c in calls]


def _k2(fn, calls, partials):
    return [fn(c[1], p[0], p[1], c[7], REG) for c, p in zip(calls, partials)]


def _k3(fn, calls):
    return [fn(*c[:6], REG, ALPHA, CG_STEPS) for c in calls]


def _worst(calls, got, want) -> tuple[float, float]:
    """(max abs, max rel) error of ``got`` against ``want`` over every call,
    leaving out the padding slots (the landing drops them)."""
    errs = []
    for c, g, w in zip(calls, got, want):
        g = g if isinstance(g, tuple) else (g,)
        w = w if isinstance(w, tuple) else (w,)
        for a, b in zip(g, w):
            if a.dim() >= 2 and a.shape[0] == c[6].shape[0]:
                a, b = a[c[6]], b[c[6]]
            errs.append(rel_err(a, b))
    return max(e[0] for e in errs), max(e[1] for e in errs)


def _hold_sweeps(calls, names) -> dict:
    """Each of the named kernels among K1-K3 against its plain version over
    ``calls``; K2 takes K1's plain output, so each is held on its own."""
    from albedo_tpu_torch.ops import als as ops_als

    out = {}
    partials = _k1(ops_als.bucket_partial_terms_reference, calls)
    if "als_partials" in names:
        out["als_partials"] = _worst(calls, _k1(ops_als.bucket_partial_terms, calls), partials)
    if "solve_corrected" in names:
        out["solve_corrected"] = _worst(calls, _k2(ops_als.solve_corrected, calls, partials),
                                        _k2(ops_als.solve_corrected_reference, calls, partials))
    if "bucket_cg" in names:
        out["bucket_cg"] = _worst(calls, _k3(ops_als.bucket_cg_body, calls),
                                  _k3(ops_als.bucket_cg_reference, calls))
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit where finite, NaN where NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _hold_groups(calls, run, plain, limits=None) -> dict:
    """A solve kernel (K2, K3, K3-bf16) over every bucket group of ``calls``:
    ``run()`` twice and ``plain()`` once, each a list of (B, k) results.
    Each group's (max abs, max rel) error over its rows that are not padding
    (the landing drops those), whether the two runs gave the same bits, and
    whether every non-finite value lies in a padding row (K2 gives NaN there
    where YtY is not positive definite; at the bench it is, so none). With
    ``limits(call)`` (K3-bf16: ``ops.als.bucket_cg_bf16_limits``, each row's
    limit), also the worst row's error over its limit
    (``over_limit``) and the rows whose limit the flips its round-off could
    make raised past rel 5e-4 (``raised_rows``)."""
    from albedo_tpu_torch.ops import als as ops_als

    got, again, want = run(), run(), plain()
    per = [rel_err(g[c[6]], w[c[6]]) for c, g, w in zip(calls, got, want)]
    out = {"max_abs_err": max(e[0] for e in per), "rel_err": max(e[1] for e in per),
           "rel_by_group": [e[1] for e in per],
           "same_bits": all(_same_bits(a, b) for a, b in zip(got, again)),
           "nan_only_padding": all(not (~g.isfinite()).any(dim=1)[c[6]].any() for c, g in zip(calls, got)),
           "nonfinite_rows": sum(int((~g.isfinite()).any(dim=1).sum()) for g in got)}
    if limits is not None:
        over, raised = [], 0
        for c, g, w in zip(calls, got, want):
            lim = limits(c)[c[6]]
            over.append(float(ops_als.bucket_cg_bf16_over(g[c[6]], w[c[6]], lim).max()) if lim.numel() else 0.0)
            raised += int((lim > bf16_rel()["bucket_cg_bf16"] * float(w[c[6]].abs().max())).sum()) if lim.numel() else 0
        out.update(over_limit=max(over), over_by_group=over, raised_rows=raised)
    return out


def _held_ok(h: dict, tol: float) -> bool:
    """The held groups within ``tol`` (or within each row's limit, where
    :func:`_hold_groups` had limits), the same bits, NaN only in padding
    (K1: none at all, and every correction symmetric)."""
    within = h["over_limit"] <= 1.0 if "over_limit" in h else h["rel_err"] <= tol
    return within and h["same_bits"] and h["nan_only_padding"] and h.get("symmetric", True)


def _hold_k1_groups(calls) -> dict:
    """K1 over every bucket group of ``calls`` as :func:`_hold_groups` holds
    a solve kernel: each group's (max abs, max rel) error of its correction
    and b-vector over the rows that are not padding, whether a second call
    gave the same bits, and whether every correction is exactly symmetric."""
    from albedo_tpu_torch.ops import als as ops_als

    got, again = _k1(ops_als.bucket_partial_terms, calls), _k1(ops_als.bucket_partial_terms, calls)
    want = _k1(ops_als.bucket_partial_terms_reference, calls)
    per = [max((rel_err(a[c[6]], b[c[6]]) for a, b in zip(g, w)), key=lambda e: e[1])
           for c, g, w in zip(calls, got, want)]
    return {"max_abs_err": max(e[0] for e in per), "rel_err": max(e[1] for e in per),
            "rel_by_group": [e[1] for e in per],
            "same_bits": all(torch.equal(a, b) for g, h in zip(got, again) for a, b in zip(g, h)),
            "symmetric": all(torch.equal(g[0], g[0].transpose(1, 2)) for g in got),
            "nan_only_padding": all(bool(g[0].isfinite().all() and g[1].isfinite().all()) for g in got)}


def _exact(got, want) -> tuple[float, float]:
    """A top-k kernel's (scores, indices) against its plain version's: (max
    abs score error, 0.0 when indices and scores are all equal, ties and
    -inf slots included, NaN where NaN, else inf)."""
    from albedo_tpu_torch.kernels.topk_bench import same

    (s, _), (s_p, _) = got, want
    diff = torch.where((s == s_p) | (s.isnan() & s_p.isnan()), torch.zeros_like(s), (s - s_p).abs())
    return float(diff.max()) if diff.numel() else 0.0, 0.0 if same(torch, got, want) else float("inf")


def _hold_topk(q, items, k, ex) -> tuple[float, float]:
    """K5 against its plain version, exactly (:func:`_exact`)."""
    from albedo_tpu_torch.ops import topk as ops_topk

    return _exact(ops_topk.topk_scores(q, items, k, ex), ops_topk.topk_scores_reference(q, items, k, ex))


def _within_tol(errs: dict) -> bool:
    """rel 1e-4 for K1-K3; K5 exact."""
    return all(rel <= (0.0 if name == "topk_scores" else REL_TOL) for name, (_, rel) in errs.items())


# ----------------------------------------------------------------- phase 6b


@contextlib.contextmanager
def _recording_sgns(calls: list):
    """Keep the last K9 call a Word2Vec fit makes (its tables cloned: Adam
    updates them in place after the step)."""
    from albedo_tpu_torch.models import word2vec as w2v_mod

    step = w2v_mod.sgns_step

    def sgns_step(in_t, out_t, c, o, neg, grad_in, grad_out, loss_acc):
        calls[:] = [(in_t.clone(), out_t.clone(), c, o, neg)]
        return step(in_t, out_t, c, o, neg, grad_in, grad_out, loss_acc)

    w2v_mod.sgns_step = sgns_step
    try:
        yield calls
    finally:
        w2v_mod.sgns_step = step


def phase_wide_options() -> dict:
    """The repaired refusals on their paths, through the entry points a user
    calls, with the launch counts set to 0 just before and read just after:
    item-CF at ``top_k=200`` and user-CF at 600 on the ``train_als`` job's
    matrix (K11's masked_topk above k 128: its select path), Word2Vec at
    dim 1024 with per-pair negatives (K9's wide path) and the ranking
    factorization at rank 129 with 33 item side features (K10's wide path).
    Each result finite and of its shape, each path launched, each recorded
    call held against its plain version and timed with its bound."""
    from albedo_tpu_torch.kernels import launch_counts, reset_launches
    from albedo_tpu_torch.models.ranking_factorization import RankingFactorization
    from albedo_tpu_torch.models.word2vec import Word2Vec
    from albedo_tpu_torch.recommenders.cf import ItemCFRecommender, UserCFRecommender

    matrix = _job_matrix()
    rng = np.random.default_rng(29)
    users = matrix.user_ids[rng.choice(matrix.n_users, size=256, replace=False)]
    words = [f"w{i}" for i in range(2000)]
    p = 1.0 / np.arange(1, 2001)
    corpus = [[words[j] for j in rng.choice(2000, size=15, p=p / p.sum())] for _ in range(3000)]
    side = rng.normal(size=(matrix.n_items, 33)).astype(np.float32)

    t0 = time.perf_counter()
    cand_calls, w2v_calls = [], []
    reset_launches()
    with _recording(cand_calls), _recording_sgns(w2v_calls):
        frames = {name: cls(matrix, top_k=k, device="cuda").recommend_for_users(users)
                  for name, cls, k in (("item_cf", ItemCFRecommender, 200), ("user_cf", UserCFRecommender, 600))}
        w2v = Word2Vec(dim=1024, min_count=1, max_iter=1, device="cuda").fit_corpus(corpus)
        mf = RankingFactorization(rank=129, epochs=1, device="cuda").fit(matrix, item_side=side)
    torch.cuda.synchronize()
    counts = {n: c for n, c in launch_counts().items() if c}
    drive_s = time.perf_counter() - t0
    needed = ("masked_topk_select", "sgns_step_wide", "bpr_step_wide")
    finite = (all(np.isfinite(f["score"].to_numpy()).all() and len(f) > 0 for f in frames.values())
              and np.isfinite(w2v.vectors).all() and w2v.vectors.shape[1] == 1024
              and np.isfinite(mf.user_factors).all() and mf.user_factors.shape[1] == 129)
    shapes = {name: len(f) <= k * len(users) for (name, f), k in zip(frames.items(), (200, 600))}
    masked = [args for name, args in cand_calls if name == "masked_topk" and args[2] > 128]
    bpr = [args for name, args in cand_calls if name == "bpr_step"]
    timed = {
        "masked_topk_select": _timed(_time_masked(masked)),
        "sgns_step_wide": _timed(_time_k9(*w2v_calls[0])[0]),
        "bpr_step_wide": _timed(_time_bpr(*bpr[-1])),
    }
    tol = {"masked_topk_select": 0.0, "sgns_step_wide": RANKER_REL["sgns_step"], "bpr_step_wide": CAND_REL["bpr_step"]}
    held = all(timed[n]["rel_err"] <= tol[n] for n in tol)
    launched = all(counts.get(n, 0) > 0 for n in needed)
    ok = finite and all(shapes.values()) and launched and held
    emit({"phase": "wide_options", "ok": ok, "drive_s": drive_s, "launches": counts, "finite": finite,
          "rows": {n: len(f) for n, f in frames.items()}, "recorded": {"masked_topk": len(masked)},
          "tol": tol, "timed": timed})
    if not ok:
        raise SystemExit("chip_smoke: a repaired path failed on its entry point (launches, finiteness or its "
                         "kernel against the plain version)")
    return {"launches": {n: counts.get(n, 0) for n in needed}, "timed": timed}


# ------------------------------------------------------------------ phase 7


def phase_bench() -> dict:
    from albedo_tpu_torch.datasets import random_split_by_user, sample_test_users
    from albedo_tpu_torch.datasets.ragged import padded_rows
    from albedo_tpu_torch.datasets.synthetic import synthetic_stars
    from albedo_tpu_torch.evaluators import RankingEvaluator, UserItems, user_actual_items
    from albedo_tpu_torch.models.als import ImplicitALS

    t0 = time.perf_counter()
    matrix = synthetic_stars(30000, 20000, rank=24, mean_stars=60, seed=42)
    train, test = random_split_by_user(matrix, test_ratio=0.1, seed=42)
    rng = np.random.default_rng(42)
    s = np.float32(1 / np.sqrt(50))
    u0 = (rng.standard_normal((train.n_users, 50)) * s).astype(np.float32)
    v0 = (rng.standard_normal((train.n_items, 50)) * s).astype(np.float32)
    users = sample_test_users(train, n=500, seed=42)
    indptr, cols, _ = train.csr()
    excl = padded_rows(indptr, cols, users)
    actual = user_actual_items(test, k=30)
    data_s = time.perf_counter() - t0

    models = {}
    for solver in ("cholesky", "cg"):
        est = ImplicitALS(rank=50, reg_param=REG, alpha=ALPHA, max_iter=26, seed=42,
                          solver=solver, cg_steps=CG_STEPS, init_factors=(u0, v0), device="cuda")
        model = est.fit(train)
        _, idx = model.recommend(users, k=30, exclude_idx=excl)
        ndcg = RankingEvaluator(metric_name="ndcg@k", k=30).evaluate(
            UserItems(users=users, items=idx.astype(np.int32)), actual
        )
        ok = abs(ndcg - JAX_NDCG[solver]) <= NDCG_TOL[solver] and est.last_fit_report["health"]["nonfinite"] == 0
        emit({"phase": "bench", "solver": solver, "ndcg": ndcg, "jax_ndcg": JAX_NDCG[solver],
              "tol": NDCG_TOL[solver], "ok": ok, "fit_s": est.last_fit_report["device_s"],
              "compile_s": est.last_fit_report["compile_s"], "prep_s": est.last_fit_report["prep_s"], "data_s": round(data_s, 3),
              "train_nnz": train.nnz, "health": est.last_fit_report["health"]})
        if not ok:
            raise SystemExit(f"chip_smoke: bench NDCG@30 ({solver}) {ndcg} is off {JAX_NDCG[solver]}")
        models[solver] = (est, model)
    est, model = models["cholesky"]
    state = {"train": train, "init": (u0, v0), "users": users, "excl": excl, "actual": actual, "models": models}
    return _time_kernels(est, model, train, users, excl), train, model, state


def _per_group(calls, per_call_fns) -> dict:
    """Each bucket group's own kernel time (``torch.profiler`` sums over 5
    calls; CUDA events around one call where the profiler misses a call,
    which then include the host's launch path), summarized as
    ``als_partials_bench.summarize`` does (the five slowest groups, the
    share in groups with fewer rows than the card has SMs)."""
    from albedo_tpu_torch.kernels.als_partials_bench import kernel_ms_each, summarize

    ms, timer = kernel_ms_each(torch, per_call_fns), "profiler"
    if not all(ms):
        torch.cuda.synchronize()
        events = []
        for fn in per_call_fns:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            fn()
            ev[1].record()
            events.append(ev)
        torch.cuda.synchronize()
        ms, timer = [a.elapsed_time(b) for a, b in events], "events"
    shapes = [tuple(c[2].shape) for c in calls]
    return {"timer": timer, **summarize(shapes, ms, torch.cuda.get_device_properties(0).multi_processor_count)}


def _time_kernels(est, model, train, users, excl) -> dict:
    """Each kernel against its plain version and a library call, at the
    shapes of the bench fit: K1-K3 over all bucket groups of one iteration
    (both half-sweeps), K5 over the 500 evaluation users."""
    from albedo_tpu_torch.ops import als as ops_als
    from albedo_tpu_torch.ops import topk as ops_topk

    uf, vf = model.user_table, model.item_table
    k = uf.shape[1]
    calls = _sweep_calls(est, train, model)
    errs = _hold_sweeps(calls, ("als_partials",))
    partials = _k1(ops_als.bucket_partial_terms_reference, calls)
    held = {
        "solve_corrected": _hold_groups(calls, lambda: _k2(ops_als.solve_corrected, calls, partials),
                                        lambda: _k2(ops_als.solve_corrected_reference, calls, partials)),
        "bucket_cg": _hold_groups(calls, lambda: _k3(ops_als.bucket_cg_body, calls),
                                  lambda: _k3(ops_als.bucket_cg_reference, calls)),
    }
    errs.update({name: (h["max_abs_err"], h["rel_err"]) for name, h in held.items()})

    def k1_library(src, idx, val, mask, a):
        gathered = src[idx.long()]
        c1 = a * val
        corr = torch.bmm((gathered * c1[..., None]).transpose(1, 2), gathered)
        w = torch.where(mask, 1.0 + c1, torch.zeros_like(c1))
        return corr, torch.bmm(w[:, None, :], gathered)[:, 0]

    groups_ms = {
        "als_partials": _per_group(calls, [
            (lambda c=c: ops_als.bucket_partial_terms(c[0], c[2], c[3], c[4], ALPHA)) for c in calls]),
        "solve_corrected": _per_group(calls, [
            (lambda c=c, p=p: ops_als.solve_corrected(c[1], p[0], p[1], c[7], REG))
            for c, p in zip(calls, partials)]),
        "bucket_cg": _per_group(calls, [
            (lambda c=c: ops_als.bucket_cg_body(*c[:6], REG, ALPHA, CG_STEPS)) for c in calls]),
    }
    # K2's plain version is the library call (``cholesky_ex`` +
    # ``cholesky_solve``), so it is timed once and reported as both.
    k2_plain_ms = cuda_ms(lambda: _k2(ops_als.solve_corrected_reference, calls, partials))
    res = {
        "als_partials": errs["als_partials"] + (
            cuda_ms(lambda: _k1(ops_als.bucket_partial_terms, calls)),
            cuda_ms(lambda: _k1(ops_als.bucket_partial_terms_reference, calls)),
            cuda_ms(lambda: _k1(k1_library, calls)),
        ),
        "solve_corrected": errs["solve_corrected"] + (
            cuda_ms(lambda: _k2(ops_als.solve_corrected, calls, partials)), k2_plain_ms, k2_plain_ms,
        ),
        "bucket_cg": errs["bucket_cg"] + (
            cuda_ms(lambda: _k3(ops_als.bucket_cg_body, calls)),
            cuda_ms(lambda: _k3(ops_als.bucket_cg_reference, calls)),
            None,
        ),
    }

    q = uf[torch.as_tensor(users, dtype=torch.int64, device=uf.device)].contiguous()
    ex = torch.as_tensor(excl, device=uf.device)

    def k5_library():
        scores = q @ vf.T
        ex_l = torch.where(ex < 0, vf.shape[0], ex.long())
        hit = torch.zeros((q.shape[0], vf.shape[0] + 1), dtype=torch.bool, device=q.device)
        hit.scatter_(1, ex_l, True)
        return torch.topk(scores.masked_fill(hit[:, :-1], float("-inf")), 30, dim=1)

    res["topk_scores"] = _hold_topk(q, vf, 30, ex) + (
        cuda_ms(lambda: ops_topk.topk_scores(q, vf, 30, ex)),
        cuda_ms(lambda: ops_topk.topk_scores_reference(q, vf, 30, ex)),
        cuda_ms(k5_library),
    )

    # Least time for the same work: each input byte read once, each output
    # written once, over HBM bandwidth; the operations these inputs need
    # over FP32 peak. K1 counts the symmetric k(k+1) + 2k FLOP per
    # masked-in entry; K2 k^3/3 + 2k^2 per system on one triangle of its
    # symmetric correction and of YtY (the factorization reads no other);
    # K3 its b/diag pass and steps + 1 matvecs over the masked-in entries
    # plus the YtY products.
    slots = sum(c[2].numel() for c in calls)
    entries = sum(int(c[4].sum()) for c in calls)
    rows = sum(c[2].shape[0] for c in calls)
    work = {
        "als_partials": tuple(_k1_work(calls).values()),
        "solve_corrected": (4 * rows * (k * (k + 1) // 2 + 2 * k + 1) + 4 * k * (k + 1) // 2,
                            rows * (k ** 3 / 3 + 2 * k * k)),
        "bucket_cg": tuple(_k3_work(calls).values()),
        "topk_scores": (4 * (q.numel() + vf.numel() + ex.numel()) + 8 * q.shape[0] * 30,
                        2 * q.shape[0] * vf.shape[0] * k),
    }
    out = {
        name: _timed(dict(err=(abs_err, rel), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bytes=work[name][0], flops=work[name][1], no_fma=name == "topk_scores"))
        for name, (abs_err, rel, ms, plain_ms, lib_ms) in res.items()
    }
    ok = (_within_tol({name: (v["max_abs_err"], v["rel_err"]) for name, v in out.items()})
          and all(_held_ok(h, REL_TOL) for h in held.values()))
    emit({"phase": "bench_kernels", "ok": ok, "groups": len(calls), "slots": slots,
          "per_group": groups_ms, "held": held,
          "entries": entries, "rows": rows, "timed": out})
    if not ok:
        raise SystemExit("chip_smoke: a kernel disagrees with its plain version at the bench shapes, changes "
                         "its bits between calls or leaves NaN outside the padding rows")
    return out


# ------------------------------------------------------------------ phase 8

# The served NDCG@30 of the ``serve`` phase's model (the ``train_als`` job's
# tables, rank 50 x 26 iterations, Cholesky, from the numpy init of
# ``jax_reference_ndcg.py ranker --shared``) for the job's 250 test users at
# k = 30, seen items kept: the JAX package's value on the CPU
# (``jax_reference_ndcg.py serve``; its offline evaluation is the same
# number, and so is the port's on the CPU, ``serve --port``). SERVE_TOL is
# room for the card's own summation orders: a swap of two near-tied items at
# an early rank of one user's list moves NDCG@30 over 250 users by ~1e-4.
JAX_SERVE_NDCG = 0.6975445747375488
SERVE_TOL = 2e-4
SERVE_KS = (3, 7, 30, 500)
HTTP_TIMEOUT = 120.0


def _http(url: str) -> tuple[int, dict]:
    """(status, JSON body) of one GET."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def _recording_calls(module, name: str, calls: list):
    """Record every call ``module`` makes to its ``name`` (a kernel
    wrapper) as (args, kwargs), and pass it on."""
    real = getattr(module, name)

    def rec(*args, **kwargs):
        calls.append((args, {k: v for k, v in kwargs.items() if k != "out"}))
        return real(*args, **kwargs)

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def _shared_als_init():
    """ALS fits start from the numpy init of ``jax_reference_ndcg.py ranker
    --shared`` (``default_rng(1)`` Gaussian factors scaled by 1/sqrt(rank))."""
    from albedo_tpu_torch.models import als as als_mod

    als_fit = als_mod.ImplicitALS.fit

    def shared_als_fit(self, matrix, *a, **k):
        self.init_factors = _shared_init(matrix.n_users, matrix.n_items, self.rank)
        return als_fit(self, matrix, *a, **k)

    als_mod.ImplicitALS.fit = shared_als_fit
    try:
        yield
    finally:
        als_mod.ImplicitALS.fit = als_fit


def _pool_get(urls: list[str], workers: int) -> list[tuple[int, dict]]:
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(_http, urls))


def phase_serve() -> dict:
    """The serving path: ``RecommendationService`` + ``serve()`` on
    127.0.0.1 over the ``train_als`` job's tables and an ALS fit from a
    pinned numpy init (rank 50). With the launch counts set to 0, 256
    concurrent requests (mixed users, k in SERVE_KS, exclusion on and off)
    and the 250 test users' top-30 lists; then every batched answer against
    the direct path (byte-identical), the served NDCG@30 against the offline
    evaluation (equal) and the JAX value (SERVE_TOL), K6 held exactly at
    every recorded batch, and ``python -m albedo_tpu_torch.cli serve`` run
    once as a subprocess."""
    import pandas as pd

    from albedo_tpu_torch import cli, kernels
    from albedo_tpu_torch.builders.jobs import TOP_K, JobContext
    from albedo_tpu_torch.ops import topk as ops_topk
    from albedo_tpu_torch.recommenders import ALSRecommender
    from albedo_tpu_torch.serving import RecommendationService, serve
    from albedo_tpu_torch.serving import batcher as batcher_mod

    ctx = JobContext(cli.parse_args(["serve", "--w2v-full"] + NOW))
    with _shared_als_init():
        model = ctx.als_model()
    matrix, tables = ctx.matrix(), ctx.tables()
    t0 = time.perf_counter()
    service = RecommendationService(model, matrix, repo_info=tables.repo_info, user_info=tables.user_info,
                                    warm=True)
    warm_s = time.perf_counter() - t0
    rng = np.random.default_rng(21)
    mixed = [(int(u), int(rng.choice(SERVE_KS)), int(rng.integers(0, 2)))
             for u in rng.choice(matrix.user_ids, size=256)]
    test_users = matrix.user_ids[ctx.test_user_dense()]
    calls: list = []
    with serve(service, port=0) as handle:
        url = f"http://127.0.0.1:{handle.server_address[1]}"
        with _recording_calls(batcher_mod, "gather_topk", calls):
            kernels.reset_launches()
            t0 = time.perf_counter()
            answers = _pool_get([f"{url}/recommend/{u}?k={k}&exclude_seen={e}" for u, k, e in mixed], 64)
            served = _pool_get([f"{url}/recommend/{u}?k={TOP_K}&exclude_seen=0" for u in test_users], 64)
            drive_s = time.perf_counter() - t0
            launches = kernels.launch_counts()
        ready = _http(f"{url}/healthz/ready")
    statuses = sorted({st for st, _ in answers + served})
    mismatch = sum(body["items"] != service.recommend(u, k=k, exclude_seen=bool(e))["items"]
                   for (u, k, e), (_, body) in zip(mixed, answers))
    mismatch += sum(body["items"] != service.recommend(int(u), k=TOP_K, exclude_seen=False)["items"]
                    for u, (_, body) in zip(test_users, served))
    frame = pd.DataFrame([(int(u), it["repo_id"], it["score"]) for u, (_, body) in zip(test_users, served)
                          for it in body.get("items", [])], columns=["user_id", "repo_id", "score"])
    served_ndcg = ctx.evaluate_topk(frame)
    offline_ndcg = ctx.evaluate_topk(ALSRecommender(model, matrix, top_k=TOP_K).recommend_for_users(test_users))
    held = max((_exact(ops_topk.gather_topk(*a, **kw), ops_topk.gather_topk_reference(*a, **kw))
                for a, kw in calls), key=lambda e: e[1])
    batches = [(int(a[2].shape[0]), int(a[3]), "device" if kw.get("exclude_table") is not None
                else "host" if kw.get("exclude") is not None else "none") for a, kw in calls]
    torch.cuda.synchronize()
    cli_report = _serve_cli(int(matrix.user_ids[5]))
    ok = (statuses == [200] and mismatch == 0 and served_ndcg == offline_ndcg
          and abs(served_ndcg - JAX_SERVE_NDCG) <= SERVE_TOL and held[1] == 0.0
          and launches["gather_topk"] > 0 and ready[0] == 200 and cli_report["ok"])
    emit({"phase": "serve", "ok": ok, "requests": len(mixed) + len(served), "statuses": statuses,
          "drive_s": drive_s, "warm_s": warm_s, "mismatch_vs_direct": mismatch,
          "served_ndcg": served_ndcg, "offline_ndcg": offline_ndcg, "jax_ndcg": JAX_SERVE_NDCG,
          "tol": SERVE_TOL, "launches": launches, "k6_held": held, "batches": len(calls),
          "mean_batch": float(np.mean([b for b, _, _ in batches])),
          "batch_shapes": sorted({f"{b}x{k}:{m}" for b, k, m in batches}),
          "excl_width": service.batcher.excl_width, "ready": ready[1], "cli": cli_report})
    if not ok:
        raise SystemExit("chip_smoke: the serve phase failed (statuses, parity with the direct path, "
                         "NDCG@30, K6 against its plain version, launches or the serve CLI)")
    return {"ctx": ctx, "model": model, "service": service, "launches": launches["gather_topk"],
            "calls": calls}


def _serve_cli(uid: int, flags: tuple = (), ks: tuple = (3, 30, 500)) -> dict:
    """``python -m albedo_tpu_torch.cli serve --port 0`` (with ``flags``) as a
    subprocess: wait for its listening line, GET /healthz/ready and one
    /recommend per k of ``ks``, then SIGTERM, which must drain it to exit 0."""
    import queue as queue_mod
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "albedo_tpu_torch.cli", "serve", "--port", "0",
                             "--duration", "600", *flags], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: "queue_mod.Queue[str]" = queue_mod.Queue()
    reader = threading.Thread(target=lambda: [lines.put(line) for line in proc.stdout], daemon=True)
    reader.start()
    out, url, codes, rc = [], None, [], None
    try:
        deadline = time.monotonic() + 300
        while url is None and time.monotonic() < deadline and proc.poll() is None:
            try:
                line = lines.get(timeout=1.0)
            except queue_mod.Empty:
                continue
            out.append(line.rstrip())
            m = re.search(r"listening on (http://\S+?)/ ", line)
            if m:
                url = m.group(1)
        start_s = time.perf_counter() - t0
        if url is not None:
            codes.append(_http(f"{url}/healthz/ready")[0])
            for k in ks:
                st, body = _http(f"{url}/recommend/{uid}?k={k}")
                codes.append(st if len(body.get("items", [])) == k else -st)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=10)
    while not lines.empty():
        out.append(lines.get().rstrip())
    return {"ok": url is not None and codes == [200] * (1 + len(ks)) and rc == 0, "codes": codes, "rc": rc,
            "start_s": start_s, "output": out[-5:]}


def phase_bank(serve_state: dict) -> dict:
    """``build_default_bank`` over the job's ALS (the serve phase's model),
    content (Word2Vec --w2v-full) and tf-idf sources, with the launch counts
    set to 0: the 250 test users' candidates per source against the host
    paths (scores within 1e-5 of the largest, lists equal up to near-ties,
    as the JAX package's ``test_bank_matches_host_paths_per_source``), and
    K7 held exactly at every recorded launch."""
    from albedo_tpu_torch import kernels
    from albedo_tpu_torch.builders.jobs import TOP_K
    from albedo_tpu_torch.ops import topk as ops_topk
    from albedo_tpu_torch.recommenders import (
        ALSRecommender,
        ContentRecommender,
        EmbeddingSearchBackend,
        TfidfRecommender,
        TfidfSimilaritySearch,
    )
    from albedo_tpu_torch.retrieval import bank as bank_mod
    from albedo_tpu_torch.retrieval import build_default_bank, candidate_parity

    ctx, model, service = serve_state["ctx"], serve_state["model"], serve_state["service"]
    matrix, tables = ctx.matrix(), ctx.tables()
    backend = EmbeddingSearchBackend(tables.repo_info, ctx.word2vec(), device=ctx.device)
    search = TfidfSimilaritySearch(min_df=2, device=ctx.device).fit(tables.repo_info)
    dense = ctx.test_user_dense()
    raw = matrix.user_ids[dense]
    calls: list = []
    with _recording_calls(bank_mod, "bank_query", calls):
        kernels.reset_launches()
        t0 = time.perf_counter()
        bank = build_default_bank(model, matrix, starring_df=tables.starring, content_backend=backend,
                                  tfidf_search=search, with_user_sim=True, exclude_table=service.exclude_table,
                                  device=ctx.device)
        got = bank.query(dense, TOP_K, raw_user_ids=raw, exclude_seen=True)
        torch.cuda.synchronize()
        query_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    hosts = {
        "als": ALSRecommender(model, matrix, exclude_seen=True, top_k=TOP_K),
        "content": ContentRecommender(backend, tables.starring, top_k=TOP_K),
        "tfidf": TfidfRecommender(search, tables.starring, top_k=TOP_K),
    }
    parity = {}
    for name, rec in hosts.items():
        frame = rec.recommend_for_users(raw)
        vals, idx = got[name]
        worst, bad = 0.0, 0
        for b, u in enumerate(raw):
            rows = frame[frame["user_id"] == int(u)]
            host = rows["repo_id"].to_numpy(np.int64), rows["score"].to_numpy(np.float64)
            ok_b = (idx[b] >= 0) & np.isfinite(vals[b])
            mine = bank.specs[name].item_ids[idx[b][ok_b]], vals[b][ok_b].astype(np.float64)
            scale = max(1.0, float(np.abs(host[1]).max()) if host[1].size else 1.0)
            rep = candidate_parity(host, mine, atol=1e-5 * scale)
            bad += not rep["ok"]
            worst = max(worst, rep.get("max_score_err", 0.0))
        parity[name] = {"users_off": bad, "max_score_err": worst}
    held = max((_exact(ops_topk.bank_query(*a, **kw), ops_topk.bank_query_reference(*a, **kw))
                for a, kw in calls), key=lambda e: e[1])
    torch.cuda.synchronize()
    ok = (all(v["users_off"] == 0 for v in parity.values()) and held[1] == 0.0
          and launches["bank_query"] > 0)
    emit({"phase": "bank", "ok": ok, "users": int(dense.size), "build_and_query_s": query_s,
          "launches": launches, "parity_vs_host": parity, "k7_held": held, "k7_calls": len(calls),
          "manifest": {n: {k: v for k, v in s.items() if k != "calibration"} | {"scale": s["calibration"]["scale"]}
                       for n, s in bank.manifest()["sources"].items()}})
    if not ok:
        raise SystemExit("chip_smoke: the bank phase failed (host-path parity, K7 against its plain "
                         "version, or launches)")
    return {"launches": launches["bank_query"], "calls": calls, "bank": bank}


def _k6_work(uf, vf, b: int, k: int, width: int) -> tuple[int, int]:
    """Bytes (each user row, the item table, each exclusion row and the
    indices read once, the (B, k) answer written once) and FP32 operations
    of one K6 launch."""
    r = uf.shape[1]
    return 4 * (b * r + vf.numel() + b * width + b) + 8 * b * k, 2 * b * vf.shape[0] * r


def _time_k6(uf, vf, table, rng, b: int, k: int) -> dict:
    """K6 at one bucket and k with device exclusion: kernel, plain version,
    and ``torch.topk`` of the masked ``uf[idx] @ vf.T``."""
    from albedo_tpu_torch.ops import topk as ops_topk

    ui = torch.as_tensor(rng.integers(0, uf.shape[0], size=b).astype(np.int32), device=uf.device)

    def library():
        rows = ui.long()
        scores = uf[rows] @ vf.T
        ex = table[rows].long()
        hit = torch.zeros((b, vf.shape[0] + 1), dtype=torch.bool, device=uf.device)
        hit.scatter_(1, torch.where(ex < 0, vf.shape[0], ex), True)
        return torch.topk(scores.masked_fill(hit[:, :-1], float("-inf")), min(k, vf.shape[0]), dim=1)

    got = ops_topk.gather_topk(uf, vf, ui, k, exclude_table=table)
    want = ops_topk.gather_topk_reference(uf, vf, ui, k, exclude_table=table)
    nbytes, flops = _k6_work(uf, vf, b, k, table.shape[1])
    return dict(err=_exact(got, want),
                ms=cuda_ms(lambda: ops_topk.gather_topk(uf, vf, ui, k, exclude_table=table), reps=10),
                plain_ms=cuda_ms(lambda: ops_topk.gather_topk_reference(uf, vf, ui, k, exclude_table=table)),
                library_ms=cuda_ms(library, reps=10), bytes=nbytes, flops=flops,
                shape={"B": b, "k": k, "users": uf.shape[0], "items": vf.shape[0], "r": uf.shape[1],
                       "excl_width": int(table.shape[1])})


def _time_k7(args, kw) -> dict:
    """K7 at one recorded (source, batch) launch: kernel, plain version and
    ``torch.topk`` of the masked product of the same queries (an item-mean
    query assembled by torch ops first)."""
    from albedo_tpu_torch.ops import topk as ops_topk

    vf, k = args[0], args[1]
    q_idx = kw.get("q_idx")
    if q_idx is not None:
        b, width = q_idx.shape
        qv_rows, excl = None, q_idx
    else:
        b, width = kw["user_idx"].shape[0], 0 if kw.get("exclude_table") is None else kw["exclude_table"].shape[1]
        qv_rows, excl = kw["users"], None

    def library():
        if q_idx is not None:
            valid = q_idx >= 0
            rows = vf[q_idx.clamp(min=0).long()] * valid[..., None]
            qv = rows.sum(1) / valid.sum(1, keepdim=True).clamp_min(1)
            qv = qv / qv.norm(dim=1, keepdim=True).clamp_min(1e-9)
            ex = q_idx
        else:
            qv = qv_rows[kw["user_idx"].long()]
            ex = None if kw.get("exclude_table") is None else kw["exclude_table"][kw["user_idx"].long()]
            if ex is not None and kw.get("excl_map") is not None:
                ex = torch.where(ex < 0, -1, kw["excl_map"][ex.clamp(min=0).long()])
        scores = qv @ vf.T
        if ex is not None:
            hit = torch.zeros((b, vf.shape[0] + 1), dtype=torch.bool, device=vf.device)
            hit.scatter_(1, torch.where(ex < 0, vf.shape[0], ex.long()), True)
            scores = scores.masked_fill(hit[:, :-1], float("-inf"))
        return torch.topk(scores, min(k, vf.shape[0]), dim=1)

    d = vf.shape[1]
    extra = b * width * d if q_idx is not None else 0  # the mean's adds
    nbytes = 4 * (vf.numel() + b * width + b * (d if q_idx is None else 0) + b) + 8 * b * k
    return dict(err=_exact(ops_topk.bank_query(*args, **kw), ops_topk.bank_query_reference(*args, **kw)),
                ms=cuda_ms(lambda: ops_topk.bank_query(*args, **kw), reps=10),
                plain_ms=cuda_ms(lambda: ops_topk.bank_query_reference(*args, **kw)),
                library_ms=cuda_ms(library, reps=10), bytes=nbytes, flops=2 * b * vf.shape[0] * d + extra,
                shape={"B": b, "k": k, "rows": vf.shape[0], "d": d, "q_or_excl_width": width})


# The load generator of ``_load``: a process of its own, so its clients do
# not share the server's interpreter lock. argv: url, concurrency, seconds;
# stdin: the JSON list of user ids; prints the latencies and status counts.
LOAD_CLIENT = r"""
import json, random, sys, threading, time, urllib.error, urllib.request
url, concurrency, seconds = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
users = json.loads(sys.stdin.read())
lat, codes, lock = [], {}, threading.Lock()
def client(seed):
    rng = random.Random(seed)
    while time.monotonic() < stop:
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(f"{url}/recommend/{rng.choice(users)}?k=30", timeout=120) as r:
                r.read()
                status = r.status
        except urllib.error.HTTPError as e:
            status = e.code
        dt = time.perf_counter() - t0
        with lock:
            lat.append(dt)
            codes[status] = codes.get(status, 0) + 1
stop = time.monotonic() + seconds
t0 = time.perf_counter()
threads = [threading.Thread(target=client, args=(i,)) for i in range(concurrency)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"lat": lat, "codes": codes, "elapsed": time.perf_counter() - t0}))
"""


def _load(url: str, users, concurrency: int, seconds: float) -> dict:
    """Closed-loop load from another process: ``concurrency`` clients, each
    sending its next request (random user, k = 30, seen items excluded)
    when the last one answers, for ``seconds``; requests/s, p50/p99
    latency, and the device's busy share over the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        proc = subprocess.run([sys.executable, "-c", LOAD_CLIENT, url, str(concurrency), str(seconds)],
                              input=json.dumps([int(u) for u in users]), capture_output=True, text=True,
                              timeout=seconds + 2 * HTTP_TIMEOUT, check=True)
    out = json.loads(proc.stdout)
    lat, wall = np.asarray(out["lat"]), out["elapsed"]
    summary = _device_summary(prof, wall)
    return {"concurrency": concurrency, "requests": int(lat.size), "codes": out["codes"],
            "rps": lat.size / wall, "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3, "max_ms": float(lat.max()) * 1e3,
            "device_busy_share": summary["device_busy_s"] / wall, "top_device_ms": summary.get("top_device_ms")}


def phase_serving_timing(serve_state: dict, bank_state: dict, bench_model, bench_train) -> dict:
    """K6 per batch at buckets 1/8/64 and k 32/512 at the job scale and the
    bench scale (30000 x 20000, the train split's exclusion table), K7 per
    source at batch 64, K5 at k = 512 and on one job user (the direct
    path's call: 1 x 2936 x 50, k 30, the user's history excluded), K4 and
    K12 (plain torch) at bench scale, each against its bound; then the
    serve path's requests/s and p50/p99 latency at closed-loop concurrency
    1, 8 and 64 (10 s each, the result cache off so every request reaches
    the card) with the device's busy share."""
    from albedo_tpu_torch.datasets.ragged import padded_rows
    from albedo_tpu_torch.ops import als as ops_als
    from albedo_tpu_torch.ops import topk as ops_topk
    from albedo_tpu_torch.serving import RecommendationService, serve
    from albedo_tpu_torch.serving import http as http_mod

    rng = np.random.default_rng(31)
    service = serve_state["service"]
    uf, vf = service.model.device_factors()
    job_table = torch.as_tensor(service.exclude_table, device=uf.device)
    buf, bvf = bench_model.device_factors()
    indptr, cols, _ = bench_train.csr()
    bench_table = torch.as_tensor(padded_rows(indptr, cols, np.arange(bench_train.n_users)), device=buf.device)
    k6 = {}
    for scale, (u, v, table) in (("job", (uf, vf, job_table)), ("bench", (buf, bvf, bench_table))):
        for b in (1, 8, 64):
            for k in (32, 512):
                k6[f"{scale} B={b} k={k}"] = _timed(_time_k6(u, v, table, rng, b, k))
    k7 = {}
    for args, kw in bank_state["calls"]:
        name = next(n for n, t in bank_state["bank"]._vf.items() if t is args[0])
        b = (kw["q_idx"] if "q_idx" in kw else kw["user_idx"]).shape[0]
        if b == 64 and name not in k7:
            k7[name] = _timed(_time_k7(args, kw))
    users = torch.as_tensor(rng.integers(0, buf.shape[0], size=500), device=buf.device)
    q = buf[users].contiguous()
    ex = bench_table[users].contiguous()
    k5 = _timed(dict(err=_hold_topk(q, bvf, 512, ex),
                     ms=cuda_ms(lambda: ops_topk.topk_scores(q, bvf, 512, ex)),
                     plain_ms=cuda_ms(lambda: ops_topk.topk_scores_reference(q, bvf, 512, ex)),
                     library_ms=cuda_ms(lambda: _topk_library(q, bvf, 512, ex)),
                     bytes=4 * (q.numel() + bvf.numel() + ex.numel()) + 8 * 500 * 512,
                     flops=2 * 500 * bvf.shape[0] * bvf.shape[1], no_fma=True))
    # K5 on one user of the job's model with that user's history excluded:
    # the direct path's call (serve --no-batch, ALSModel.recommend of one user).
    one = int(rng.integers(0, uf.shape[0]))
    q1, ex1 = uf[one:one + 1].contiguous(), job_table[one:one + 1].contiguous()
    k5_one = _timed(dict(err=_hold_topk(q1, vf, 30, ex1),
                         ms=cuda_ms(lambda: ops_topk.topk_scores(q1, vf, 30, ex1), reps=20),
                         plain_ms=cuda_ms(lambda: ops_topk.topk_scores_reference(q1, vf, 30, ex1)),
                         library_ms=cuda_ms(lambda: _topk_library(q1, vf, 30, ex1), reps=20),
                         bytes=4 * (q1.numel() + vf.numel() + ex1.numel()) + 8 * 30,
                         flops=2 * vf.shape[0] * vf.shape[1], no_fma=True,
                         shape={"calls": [[1, int(vf.shape[0]), int(vf.shape[1]), 30]]}))
    # K4 (plain torch): the Gramian of each table and one half-sweep's landing
    # gather. (K12 is a kernel now, timed in phase 10.)
    land = torch.randperm(buf.shape[0], device=buf.device)
    slots = torch.zeros((buf.shape[0], buf.shape[1]), device=buf.device)
    r = buf.shape[1]
    n_rows = buf.shape[0] + bvf.shape[0]
    plain = {
        "gramian": dict(err=(0.0, 0.0), ms=cuda_ms(lambda: (ops_als.gramian(buf), ops_als.gramian(bvf)), reps=10),
                        plain_ms=None, library_ms=None, bytes=4 * (n_rows * r + 2 * r * r), flops=2 * n_rows * r * r),
        "landing": dict(err=(0.0, 0.0), ms=cuda_ms(lambda: torch.cat([slots, buf])[land], reps=10), plain_ms=None,
                        library_ms=None, bytes=8 * buf.numel() + 8 * buf.shape[0], flops=0),
    }
    timed_plain = {n: _timed(v) for n, v in plain.items()}
    load, mean_batch = [], {}
    matrix = serve_state["ctx"].matrix()
    # The port's server, then (the last run) the listen backlog of 5 that
    # http.server gives by default and the JAX server keeps.
    backlog = http_mod._Server.request_queue_size
    for label, levels in ((backlog, (1, 8, 64)), (5, (64,))):
        http_mod._Server.request_queue_size = label
        try:
            svc = RecommendationService(service.model, matrix, warm=True)
            with serve(svc, port=0) as handle:
                url = f"http://127.0.0.1:{handle.server_address[1]}"
                for c in levels:
                    load.append(dict(_load(url, matrix.user_ids, c, 10.0), backlog=label))
                mean_batch[f"backlog {label}"] = svc.batcher.mean_batch_size
        finally:
            http_mod._Server.request_queue_size = backlog
    torch.cuda.synchronize()
    ok = (all(v["rel_err"] == 0.0 for v in [*k6.values(), *k7.values(), k5, k5_one])
          and all(set(r_["codes"]) == {"200"} for r_ in load))
    emit({"phase": "serving_timing", "ok": ok, "k6": k6, "k7": k7, "k5_k512": k5, "k5_one_row": k5_one,
          "plain_torch": timed_plain,
          "load": load, "mean_batch": mean_batch})
    if not ok:
        raise SystemExit("chip_smoke: a serving kernel disagrees at its timed inputs, or a load run saw non-200")
    k7_sum = {key: sum(v[key] for v in k7.values()) for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    return {
        "gather_topk": k6["job B=64 k=32"],
        "bank_query": dict(next(iter(k7.values())), **k7_sum,
                           max_abs_err=max(v["max_abs_err"] for v in k7.values()),
                           bound_by=max(k7.values(), key=lambda v: v["bound_ms"])["bound_by"]),
    }


# ------------------------------------------------------------------ phase 9

# ImplicitALS(rank=100) on the ``train_als`` job's tables from the numpy init
# of ``--shared`` (26 iterations, Cholesky), the job's evaluation: the JAX
# package's value on the CPU (``jax_reference_ndcg.py wide_rank``; the port
# on the CPU gives 0.7735340595, 1.2e-7 away). The band is room for the
# card's own summation orders in K1-K3's wide paths (as the bench fit's
# Cholesky band, 2e-3 at NDCG 0.29).
JAX_WIDE_RANK_NDCG = 0.7735341787338257
WIDE_RANK_TOL = 1e-3
# The same fit with 3-step CG (``jax_reference_ndcg.py wide_rank --solver
# cg``; K3's wide path). The port on the CPU gives 0.7740768, and with the
# live entries of every row of every bucket group permuted (``--port
# --permute-seeds 1,2,3,4``: only the float32 summation order changes)
# 0.7740742, 0.7740034, 0.7740048 and 0.7739874: 7.8e-5 from JAX at the
# widest. The band is twice that, at least 1e-3.
JAX_WIDE_RANK_CG_NDCG = 0.773999035358429
WIDE_RANK_CG_TOL = 1e-3
WIDE_RANK, SELECT_K = 100, 600


def _shared_init(n_users: int, n_items: int, rank: int):
    from albedo_tpu_torch.builders.jobs import shared_als_init

    return shared_als_init(n_users, n_items, rank, SHARED_SEED)


def _k1_library(src, idx, val, mask, a):
    """K1's yardstick: the gather, then two batched matrix products."""
    gathered = src[idx.long()]
    c1 = a * val
    corr = torch.bmm((gathered * c1[..., None]).transpose(1, 2), gathered)
    w = torch.where(mask, 1.0 + c1, torch.zeros_like(c1))
    return corr, torch.bmm(w[:, None, :], gathered)[:, 0]


def _topk_library(q, items, k, ex):
    """K5's yardstick: the masked score matrix, then ``torch.topk``."""
    scores = q @ items.T
    ex_l = torch.where(ex < 0, items.shape[0], ex.long())
    hit = torch.zeros((q.shape[0], items.shape[0] + 1), dtype=torch.bool, device=q.device)
    hit.scatter_(1, ex_l, True)
    return torch.topk(scores.masked_fill(hit[:, :-1], float("-inf")), k, dim=1)


def _sweep_counts(calls, distinct: bool = False) -> tuple[int, int, int, int, int, int]:
    """(k, fixed-side tables, slots, masked-in entries, rows, the tables'
    bytes as they are read: float32 or bf16) of ``calls`` (``_sweep_calls``,
    or ``_bf16_calls``): every row of each table, or with ``distinct`` only
    the rows that the masked-in entries gather (a single bucket's work)."""
    tables = {id(c[0]): c[0] for c in calls}
    if distinct:
        gathered = {t: torch.unique(torch.cat([c[2][c[4]] for c in calls if id(c[0]) == t])).numel() for t in tables}
        table_bytes = sum(int(n) * tables[t].shape[1] * tables[t].element_size() for t, n in gathered.items())
    else:
        table_bytes = sum(t.numel() * t.element_size() for t in tables.values())
    return (calls[0][1].shape[0], len(tables), sum(c[2].numel() for c in calls), sum(int(c[4].sum()) for c in calls),
            sum(c[2].shape[0] for c in calls), table_bytes)


def _k1_work(calls) -> dict:
    """K1's bytes and operations over ``calls``: each slot's index, value
    and mask, the tables, each row's correction and b-vector written; the
    symmetric k(k + 1) + 2k FLOP of each masked-in entry."""
    k, _, slots, entries, rows, table_bytes = _sweep_counts(calls)
    return {"bytes": 9 * slots + table_bytes + 4 * rows * (k * k + k), "flops": entries * (k * (k + 1) + 2 * k)}


def _bound_ms(work: dict) -> tuple[float, str]:
    """The least time for ``work`` (bytes over the HBM rate, FLOP over the
    FP32 peak, the larger) and which of the two bounds it."""
    t_bytes, t_ops = work["bytes"] / PEAK_BYTES * 1e3, work["flops"] / PEAK_FP32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _k3_work(calls, distinct: bool = False) -> dict:
    """K3's bytes and operations over ``calls``: each slot's index, value
    and mask, the tables (with ``distinct``, only their gathered rows), x0
    and x, each table's YtY; an entry's 4 k FLOP in the b/diag pass and in
    each of the cg_steps + 1 matvecs, each row's YtY products and its CG
    updates."""
    k, n_tables, slots, entries, rows, table_bytes = _sweep_counts(calls, distinct)
    return {"bytes": 9 * slots + table_bytes + 4 * rows * 2 * k + 4 * k * k * n_tables,
            "flops": entries * 4 * k * (CG_STEPS + 2) + rows * ((CG_STEPS + 1) * 2 * k * k + CG_STEPS * 10 * k)}


def phase_wide_rank() -> dict:
    """K1-K3's wide paths and K5's select path on a main path: with the
    launch counts set to 0, ``ImplicitALS(rank=100)`` fitted on the
    ``train_als`` job's tables (26 iterations, Cholesky; then 26 with 3-step
    CG), each NDCG@30 held to its JAX value, and the 250 test users' top 600
    with their seen items excluded; every wide and select path must have
    launched. Then each is held against its plain version at this run's
    inputs (K1 and K2 wide at the Cholesky fit's tables, K3 wide at the CG
    fit's, each also group by group) and timed with its plain version, a
    library yardstick and its bound."""
    from albedo_tpu_torch import cli, kernels
    from albedo_tpu_torch.builders.jobs import ALS_ALPHA, ALS_REG, TOP_K, JobContext
    from albedo_tpu_torch.datasets.ragged import padded_rows
    from albedo_tpu_torch.models.als import ImplicitALS
    from albedo_tpu_torch.ops import als as ops_als
    from albedo_tpu_torch.ops import topk as ops_topk
    from albedo_tpu_torch.recommenders import ALSRecommender

    ctx = JobContext(cli.parse_args(["train_als"] + NOW))
    matrix = ctx.matrix()
    init = _shared_init(matrix.n_users, matrix.n_items, WIDE_RANK)
    dense = ctx.test_user_dense()
    indptr, cols, _ = matrix.csr()
    excl = padded_rows(indptr, cols, dense)
    kernels.reset_launches()
    t0 = time.perf_counter()
    est = ImplicitALS(rank=WIDE_RANK, reg_param=ALS_REG, alpha=ALS_ALPHA, max_iter=26, init_factors=init,
                      device=ctx.device)
    model = est.fit(matrix)
    fit_s = time.perf_counter() - t0
    ndcg = ctx.evaluate_topk(ALSRecommender(model, matrix, top_k=TOP_K).recommend_for_users(matrix.user_ids[dense]))
    vals, idx = model.recommend(dense, k=SELECT_K, exclude_idx=excl)
    cg_est = ImplicitALS(rank=WIDE_RANK, reg_param=ALS_REG, alpha=ALS_ALPHA, max_iter=26, solver="cg",
                         init_factors=init, device=ctx.device)
    t0 = time.perf_counter()
    cg_model = cg_est.fit(matrix)
    cg_fit_s = time.perf_counter() - t0
    cg_ndcg = ctx.evaluate_topk(ALSRecommender(cg_model, matrix, top_k=TOP_K).recommend_for_users(
        matrix.user_ids[dense]))
    torch.cuda.synchronize()
    launches = {n: c for n, c in kernels.launch_counts().items() if c}

    calls = _sweep_calls(est, matrix, model)
    cg_calls = _sweep_calls(cg_est, matrix, cg_model)
    errs = dict(_hold_sweeps(calls, ("als_partials", "solve_corrected")), **_hold_sweeps(cg_calls, ("bucket_cg",)))
    partials = _k1(ops_als.bucket_partial_terms_reference, calls)
    held = {"als_partials_wide": _hold_k1_groups(calls),
            "solve_corrected_wide": _hold_groups(calls, lambda: _k2(ops_als.solve_corrected, calls, partials),
                                                 lambda: _k2(ops_als.solve_corrected_reference, calls, partials)),
            "bucket_cg_wide": _hold_groups(cg_calls, lambda: _k3(ops_als.bucket_cg_body, cg_calls),
                                           lambda: _k3(ops_als.bucket_cg_reference, cg_calls))}
    per_group = {
        "als_partials_wide": _per_group(calls, [
            (lambda c=c: ops_als.bucket_partial_terms(c[0], c[2], c[3], c[4], ALPHA)) for c in calls]),
        "solve_corrected_wide": _per_group(calls, [
            (lambda c=c, p=p: ops_als.solve_corrected(c[1], p[0], p[1], c[7], REG)) for c, p in zip(calls, partials)]),
        "bucket_cg_wide": _per_group(cg_calls, [
            (lambda c=c: ops_als.bucket_cg_body(*c[:6], REG, ALPHA, CG_STEPS)) for c in cg_calls]),
    }
    uf, vf = model.user_table, model.item_table
    q = uf[torch.as_tensor(dense, dtype=torch.int64, device=uf.device)].contiguous()
    ex = torch.as_tensor(excl, device=uf.device)
    select_err = _hold_topk(q, vf, SELECT_K, ex)
    k2_plain_ms = cuda_ms(lambda: _k2(ops_als.solve_corrected_reference, calls, partials))
    k = WIDE_RANK
    rows = sum(c[2].shape[0] for c in calls)
    timed = {
        "als_partials_wide": _timed(dict(
            err=errs["als_partials"], ms=cuda_ms(lambda: _k1(ops_als.bucket_partial_terms, calls)),
            plain_ms=cuda_ms(lambda: _k1(ops_als.bucket_partial_terms_reference, calls)),
            library_ms=cuda_ms(lambda: _k1(_k1_library, calls)),
            **_k1_work(calls))),
        "solve_corrected_wide": _timed(dict(
            err=errs["solve_corrected"], ms=cuda_ms(lambda: _k2(ops_als.solve_corrected, calls, partials)),
            plain_ms=k2_plain_ms, library_ms=k2_plain_ms,
            bytes=4 * rows * (k * (k + 1) // 2 + 2 * k + 1) + 4 * k * (k + 1) // 2,
            flops=rows * (k ** 3 / 3 + 2 * k * k))),
        "bucket_cg_wide": _timed(dict(
            err=errs["bucket_cg"], ms=cuda_ms(lambda: _k3(ops_als.bucket_cg_body, cg_calls)),
            plain_ms=cuda_ms(lambda: _k3(ops_als.bucket_cg_reference, cg_calls)), library_ms=None,
            **_k3_work(cg_calls))),
        "topk_select": _timed(dict(
            err=select_err, ms=cuda_ms(lambda: ops_topk.topk_scores(q, vf, SELECT_K, ex)),
            plain_ms=cuda_ms(lambda: ops_topk.topk_scores_reference(q, vf, SELECT_K, ex)),
            library_ms=cuda_ms(lambda: _topk_library(q, vf, SELECT_K, ex)),
            bytes=4 * (q.numel() + vf.numel() + ex.numel()) + 8 * q.shape[0] * SELECT_K,
            flops=2 * q.shape[0] * vf.shape[0] * k)),
    }
    launches["topk_select"] = sum(launches.get(f"{n}_select", 0) for n in ("topk_scores", "gather_topk", "bank_query"))
    needed = ("als_partials_wide", "solve_corrected_wide", "bucket_cg_wide", "topk_select")
    ok = (abs(ndcg - JAX_WIDE_RANK_NDCG) <= WIDE_RANK_TOL and abs(cg_ndcg - JAX_WIDE_RANK_CG_NDCG) <= WIDE_RANK_CG_TOL
          and all(launches.get(n, 0) > 0 for n in needed)
          and _within_tol({n: errs[n] for n in errs}) and select_err[1] == 0.0
          and all(_held_ok(h, REL_TOL) for h in held.values())
          and bool(torch.isfinite(uf).all()) and tuple(idx.shape) == (len(dense), SELECT_K))
    emit({"phase": "wide_rank", "ok": ok, "rank": WIDE_RANK, "fit_s": fit_s, "ndcg": ndcg,
          "jax_ndcg": JAX_WIDE_RANK_NDCG, "tol": WIDE_RANK_TOL, "cg_fit_s": cg_fit_s,
          "device_s": est.last_fit_report["device_s"], "compile_s": est.last_fit_report["compile_s"],
          "cg_device_s": cg_est.last_fit_report["device_s"], "cg_compile_s": cg_est.last_fit_report["compile_s"],
          "cg_ndcg": cg_ndcg, "cg_jax_ndcg": JAX_WIDE_RANK_CG_NDCG,
          "cg_tol": WIDE_RANK_CG_TOL, "select_k": SELECT_K,
          "launches": launches, "groups": len(calls), "held": held, "per_group": per_group, "timed": timed})
    if not ok:
        raise SystemExit("chip_smoke: a rank-100 fit or the k = 600 top-k failed (band, launches, or "
                         "a kernel against its plain version, group by group)")
    return {"timed": timed, "launches": {n: launches[n] for n in needed}}


# ------------------------------------------------------------------ phase 10

# ``serve --two-stage`` with the shared inputs of ``ranker --shared``: the
# re-ranked NDCG@30 of the 250 test users (k 30, seen items excluded) from
# the JAX package on the CPU (``jax_reference_ndcg.py two_stage --shared``,
# the service's direct path; the port on the CPU gives 0.0060611484, 1e-9
# away). It is small because the job's relevant items are each user's most
# recent stars, which the excluded seen items hold. The band is room for the
# card's summation orders in the LR fit (K8, K8c), which can swap near-tied
# probabilities: one swap at an early rank moves the mean over 250 users by
# under 5e-5.
JAX_TWO_STAGE_NDCG = 0.006061149295419455
TWO_STAGE_TOL = 2e-4
TWO_STAGE_NEEDS = ("als_partials", "solve_corrected", "factor_health", "segment_dot", "gather_sum", "gather_topk")


@contextlib.contextmanager
def _shared_weights():
    """ALS fits from the numpy init and Word2Vec returning the numpy vectors
    of ``jax_reference_ndcg.py ranker --shared``; the LR fit's inputs and
    model are recorded on the way (``recorded["lr"]``)."""
    from albedo_tpu_torch.models import logistic_regression as lr_mod
    from albedo_tpu_torch.models import word2vec as w2v_mod

    recorded: dict = {}
    fit_corpus, lr_fit = w2v_mod.Word2Vec.fit_corpus, lr_mod.LogisticRegression.fit

    def shared_fit_corpus(self, sentences):
        vocab = self.plan(sentences).vocab
        rng = np.random.default_rng(SHARED_SEED)
        vectors = rng.normal(scale=SHARED_W2V_SCALE, size=(len(vocab), self.dim)).astype(np.float32)
        return w2v_mod.Word2VecModel(vocab, vectors, self.input_col, self.output_col or f"{self.input_col}__w2v")

    def recording_fit(self, fm, labels, sample_weight=None, _damped_retry=False):
        model = lr_fit(self, fm, labels, sample_weight, _damped_retry)
        recorded["lr"] = (self, fm, labels, sample_weight, model)
        return model

    w2v_mod.Word2Vec.fit_corpus, lr_mod.LogisticRegression.fit = shared_fit_corpus, recording_fit
    try:
        with _shared_als_init():
            yield recorded
    finally:
        w2v_mod.Word2Vec.fit_corpus, lr_mod.LogisticRegression.fit = fit_corpus, lr_fit


def _two_stage_service(ctx, model, ranker, **kw):
    from albedo_tpu_torch.builders.jobs import TOP_K
    from albedo_tpu_torch.datasets.tables import popular_repos
    from albedo_tpu_torch.recommenders import CurationRecommender, PopularityRecommender
    from albedo_tpu_torch.serving import RecommendationService

    lo, hi = ctx.star_range()
    recommenders = {
        "popularity": PopularityRecommender(popular_repos(ctx.tables().repo_info, lo, hi), top_k=TOP_K),
        "curation": CurationRecommender(ctx.tables().starring, curator_ids=ctx.curators(), top_k=TOP_K),
    }
    return RecommendationService(model, ctx.matrix(), repo_info=ctx.tables().repo_info,
                                 user_info=ctx.tables().user_info, recommenders=recommenders,
                                 ranker=ranker, **kw)


def phase_two_stage() -> dict:
    """``serve --two-stage`` at full width: the ``serve`` job's context with
    the weights shared with JAX, the ALS fit (K1, K2, K12) and the ranker
    trained in process (K8, K8c in its fit), served by the batched service
    (ALS candidates through K6, the re-rank through K8 and K8c). With the
    launch counts set to 0 before the fits and read after the drive, 256
    concurrent requests (the 250 test users and 6 more, k 30, seen items
    excluded) must all be 200 and each equal the direct path's sequential
    answer; the re-ranked NDCG@30 must lie in the JAX band; a source forced
    to fail (``serving.source.curation``) must degrade each answer and open
    its breaker; then ``python -m albedo_tpu_torch.cli serve --two-stage`` as
    a subprocess: ready, three answers, exit 0 on SIGTERM."""
    import pandas as pd

    from albedo_tpu_torch import cli, kernels
    from albedo_tpu_torch.builders.jobs import TOP_K, JobContext
    from albedo_tpu_torch.serving import BreakerConfig, StageDeadlines, serve
    from albedo_tpu_torch.utils import faults
    from albedo_tpu_torch.utils.retry import RetryPolicy

    ctx = JobContext(cli.parse_args(["serve", "--w2v-full"] + NOW))
    kernels.reset_launches()
    t0 = time.perf_counter()
    with _shared_weights() as recorded:
        model = ctx.als_model()
        ranker = ctx.ranker_model()
    train_s = time.perf_counter() - t0
    matrix = ctx.matrix()
    # The breakers reopen after 60 s here, so the drill reads "open" however
    # slow the requests around it are.
    # Every answer at full quality, so each can be held to the direct path:
    # stage deadlines long enough that none degrades while 64 requests queue
    # for the ranker's pool (the default 0.5 s is a production budget), and
    # no overload control (its brownout tiers skip the re-rank under this
    # load). Both are the degrade matrix's, held on the CPU against JAX.
    breakers = BreakerConfig(failure_threshold=3, reopen=RetryPolicy(base_s=60.0, max_delay_s=60.0, jitter=False))
    deadlines = StageDeadlines(candidates_s=30.0, ranker_s=30.0)
    service = _two_stage_service(ctx, model, ranker, warm=True, breaker_config=breakers, deadlines=deadlines,
                                 overload_enabled=False)
    direct = _two_stage_service(ctx, model, ranker, batching=False, deadlines=deadlines)
    test_users = matrix.user_ids[ctx.test_user_dense()]
    rng = np.random.default_rng(41)
    uids = [int(u) for u in test_users] + [int(u) for u in rng.choice(matrix.user_ids, size=6)]
    with serve(service, port=0) as handle:
        url = f"http://127.0.0.1:{handle.server_address[1]}"
        t0 = time.perf_counter()
        answers = _pool_get([f"{url}/recommend/{u}?k={TOP_K}" for u in uids], 64)
        drive_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        drill_user = uids[0]
        faults.arm("serving.source.curation", kind="error", at=1, times=0)
        try:
            drill = [_http(f"{url}/recommend/{drill_user}?k={TOP_K}") for _ in range(4)]
        finally:
            faults.reset()
        ready = _http(f"{url}/healthz/ready")
        metrics_text = _http_text(f"{url}/metrics")
    service.pipeline.breakers["curation"].reset()
    statuses = sorted({st for st, _ in answers})
    keys = ("stage", "degraded", "items")
    mismatch = []
    for u, (_, body) in zip(uids, answers):
        want = direct.handle_recommend(u, k=TOP_K)[1]
        if {k: body.get(k) for k in keys} != {k: want.get(k) for k in keys}:
            mismatch.append({"user": u, "got": {k: body.get(k) for k in ("stage", "degraded", "error")},
                             "want": {k: want.get(k) for k in ("stage", "degraded", "error")}})
    direct.close()
    frame = pd.DataFrame([(u, it["repo_id"], it["score"]) for u, (_, body) in zip(uids[:len(test_users)], answers)
                          for it in body.get("items", [])], columns=["user_id", "repo_id", "score"])
    ndcg = ctx.evaluate_topk(frame)
    stages = sorted({str(body.get("stage")) for _, body in answers})
    tags = [body.get("degraded", []) for _, body in drill]
    drill_ok = (all(st == 200 for st, _ in drill) and all("candidate_error_curation" in t for t in tags[:3])
                and "breaker_open_curation" in tags[3] and ready[1]["breakers"]["curation"]["state"] == "open"
                and 'albedo_breaker_state{source="curation"} 2' in metrics_text)
    cli_report = _serve_cli(int(matrix.user_ids[5]), ("--two-stage",), ks=(3, 10, 30))
    ok = (statuses == [200] and not mismatch and abs(ndcg - JAX_TWO_STAGE_NDCG) <= TWO_STAGE_TOL
          and all(launches.get(n, 0) > 0 for n in TWO_STAGE_NEEDS) and drill_ok and cli_report["ok"]
          and "two_stage" in stages)
    emit({"phase": "two_stage", "ok": ok, "requests": len(uids), "statuses": statuses, "train_s": train_s,
          "drive_s": drive_s, "mismatch_vs_direct": len(mismatch), "mismatch_examples": mismatch[:5],
          "stages": stages, "degraded_answers": sum(bool(body.get("degraded")) for _, body in answers),
          "ndcg": ndcg, "jax_ndcg": JAX_TWO_STAGE_NDCG, "tol": TWO_STAGE_TOL,
          "ranker_auc": ctx._cache.get("ranker_auc"), "launches": {n: c for n, c in launches.items() if c},
          "drill": {"tags": tags, "breaker": ready[1]["breakers"].get("curation")},
          "mean_batch": service.batcher.mean_batch_size, "cli": cli_report})
    if not ok:
        raise SystemExit("chip_smoke: the two-stage phase failed (statuses, parity with the direct path, "
                         "NDCG@30, launches, the degrade drill or the serve --two-stage CLI)")
    return {"ctx": ctx, "model": model, "ranker": ranker, "service_kw": {
        "breaker_config": breakers, "deadlines": deadlines, "overload_enabled": False},
        "lr": recorded["lr"], "launches": {n: launches[n] for n in ("gather_sum", "factor_health")}}


def _http_text(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
        return r.read().decode()


def _gauges(text: str) -> dict:
    """The stage gauges and the request-latency totals of a /metrics page."""
    out = {"seconds": {}, "calls": {}}
    for kind, name, value in re.findall(r'^albedo_stage_(seconds|calls)\{stage="([^"]+)"\} (\S+)$', text, re.M):
        out[kind][name] = float(value)
    out["latency_sum"] = float(re.search(r"^albedo_request_latency_seconds_sum (\S+)$", text, re.M).group(1))
    out["latency_count"] = float(re.search(r"^albedo_request_latency_seconds_count (\S+)$", text, re.M).group(1))
    return out


def _degraded_total(text: str) -> float:
    return sum(float(v) for v in re.findall(r"^albedo_degraded_total\{[^}]*\} (\S+)$", text, re.M))


def _stage_split(before: dict, after: dict) -> dict:
    """Mean milliseconds per request of each stage between two /metrics
    pages, and the rest of the request's server time (HTTP, JSON, the
    service's own Python): the request latency less the candidates, fusion
    and re-rank stages."""
    n = after["calls"].get("stage1_candidates", 0) - before["calls"].get("stage1_candidates", 0)
    if n <= 0:
        return {}
    per = {name: (after["seconds"][name] - before["seconds"].get(name, 0.0)) / n * 1e3 for name in after["seconds"]}
    requests = after["latency_count"] - before["latency_count"]
    latency = (after["latency_sum"] - before["latency_sum"]) / max(requests, 1) * 1e3
    per["request"] = latency
    per["http_and_rest"] = latency - sum(per.get(s, 0.0) for s in ("stage1_candidates", "fuse", "stage2_rank"))
    return per


def _old_factor_health(user_f, item_f):
    """K12 as the port computed it before its kernel: a dozen small torch
    reductions, the baseline of ``PERF.md``'s kernel table."""
    def stats(x):
        finite = torch.isfinite(x)
        safe = torch.where(finite, x, torch.zeros_like(x))
        return (x.numel() - finite.sum()).to(torch.float32), safe.abs().max(), torch.sqrt(torch.mean(safe * safe))

    un, ua, ur = stats(user_f)
    vn, va, vr = stats(item_f)
    return torch.stack([un + vn, torch.maximum(ua, va), torch.maximum(ur, vr)])


def _k8c_at_fit(lr_inputs) -> dict:
    """K8c at the ranker fit's real batch and fitted coefficients: its
    forward held per row against the L1 mass of the row's terms, each
    table's gradient (K8 over the category-sorted rows) per entry against
    the mass summed into it, and both timed with their plain versions (the
    backward's yardstick: ``index_add_`` per table, the plain version)."""
    from albedo_tpu_torch.models import logistic_regression as lr_mod
    from albedo_tpu_torch.ops import sparse_linear as sl

    est, fm, labels, weights, model = lr_inputs
    dev = torch.device("cuda")
    batch = sl.feature_batch(fm, dev, grad_layout=True)
    scales = lr_mod._to_device(model.scales, dev)
    params = {k: v.requires_grad_(True) for k, v in lr_mod._to_device(model.params, dev).items()}
    center = None if model.center is None else torch.as_tensor(model.center).to(dev)
    y = torch.as_tensor(np.asarray(labels, np.float32)).to(dev)
    w = torch.as_tensor(np.asarray(weights, np.float32)).to(dev)
    captured: dict = {}
    apply = sl._GatherSum.apply

    def recording(base, layout, *tables):
        out = apply(base, layout, *tables)
        captured.update(base=base.detach(), layout=layout, tables=[t.detach() for t in tables])
        out.register_hook(lambda g: captured.__setitem__("g", g.detach().clone()))
        return out

    sl._GatherSum.apply = recording
    try:
        sl.weighted_logloss(params, scales, batch, y, w, est.reg_param, center=center).backward()
    finally:
        sl._GatherSum.apply = apply
    base, tables, g = captured["base"], captured["tables"], captured["g"]
    idxs, orders, indptrs = captured["layout"]
    fwd = sl.gather_sum(base, tables, idxs)
    fwd_err = _gather_sum_err(base, tables, idxs, fwd, sl.gather_sum_reference(base, tables, idxs))

    def backward_kernel():
        return [sl.segment_dot(g, o, None, ip) for o, ip in zip(orders, indptrs)]

    def backward_plain():
        return [torch.zeros(t.shape[0], device=dev).index_add_(0, i.long(), g) for t, i in zip(tables, idxs)]

    bwd_err = (0.0, 0.0)
    for got, want, idx in zip(backward_kernel(), backward_plain(), idxs):
        e = mass_err(got, want, torch.zeros_like(want).index_add_(0, idx.long(), g.abs()))
        bwd_err = (max(bwd_err[0], e[0]), max(bwd_err[1], e[1]))
    n = base.shape[0]
    table_entries = sum(t.shape[0] for t in tables)
    return {
        "rows": n, "terms": len(tables), "table_entries": table_entries, "forward_err": fwd_err,
        "backward_err": bwd_err,
        "forward": _timed(dict(err=fwd_err, ms=cuda_ms(lambda: sl.gather_sum(base, tables, idxs), reps=20),
                               plain_ms=cuda_ms(lambda: sl.gather_sum_reference(base, tables, idxs), reps=20),
                               library_ms=None, bytes=4 * (n * (len(tables) + 2) + table_entries),
                               flops=n * len(tables))),
        "backward": _timed(dict(err=bwd_err, ms=cuda_ms(backward_kernel, reps=20),
                                plain_ms=cuda_ms(backward_plain, reps=20), library_ms=cuda_ms(backward_plain, reps=20),
                                bytes=4 * (n + len(tables) * 2 * n + table_entries + len(tables)),
                                flops=n * len(tables))),
    }


def phase_two_stage_timing(state: dict, bench_model) -> dict:
    """K8c at the ranker fit's batch, K12 on the bench model's tables (30000
    + 19991 rows x 50) against its plain version and the reductions it
    replaced, and the two-stage service's requests/s, p50/p99 and the
    device's busy share at closed-loop concurrency 1, 8 and 64 (10 s each,
    from another process; the parity phase's full-quality service, every
    answer re-ranked), with the per-stage split of each level from the
    /metrics stage gauges and the answers that degraded."""
    from albedo_tpu_torch.serving import serve
    from albedo_tpu_torch.utils import watchdog

    k8c = _k8c_at_fit(state["lr"])
    buf, bvf = bench_model.device_factors()
    n_floats = buf.numel() + bvf.numel()
    health_err = rel_err(watchdog.factor_health(buf, bvf), watchdog.factor_health_reference(buf, bvf))
    k12 = _timed(dict(err=health_err, ms=cuda_ms(lambda: watchdog.factor_health(buf, bvf), reps=20),
                      plain_ms=cuda_ms(lambda: watchdog.factor_health_reference(buf, bvf), reps=20),
                      library_ms=None, bytes=4 * n_floats + 12, flops=4 * n_floats))
    k12["replaced_reductions_ms"] = cuda_ms(lambda: _old_factor_health(buf, bvf), reps=20)
    # The parity phase's configuration (its service closed with its server).
    service = _two_stage_service(state["ctx"], state["model"], state["ranker"], warm=True, **state["service_kw"])
    matrix = state["ctx"].matrix()
    load = []
    with serve(service, port=0) as handle:
        url = f"http://127.0.0.1:{handle.server_address[1]}"
        for c in (1, 8, 64):
            before = _http_text(f"{url}/metrics")
            run = _load(url, matrix.user_ids, c, 10.0)
            after = _http_text(f"{url}/metrics")
            run["stage_ms"] = _stage_split(_gauges(before), _gauges(after))
            run["degraded"] = _degraded_total(after) - _degraded_total(before)
            load.append(run)
    ok = (all(set(r_["codes"]) == {"200"} for r_ in load)
          and k8c["forward_err"][1] <= RANKER_REL["segment_dot"] and k8c["backward_err"][1] <= RANKER_REL["segment_dot"]
          and health_err[1] <= HEALTH_RMS_REL)
    emit({"phase": "two_stage_timing", "ok": ok, "k8c": k8c, "k12": k12, "load": load,
          "mean_batch": service.batcher.mean_batch_size})
    if not ok:
        raise SystemExit("chip_smoke: K8c or K12 disagrees at its timed inputs, or a two-stage load run saw non-200")
    return {"gather_sum": k8c["forward"], "factor_health": k12}


# ----------------------------------------------------------------- phase 11

# The cv_als job at full size (the grid the JAX job takes without --tables:
# rank [8, 16] x regParam [0.1, 0.5] x alpha [1, 40], 13 iterations, 2
# folds): each grid point's mean NDCG@30 from the JAX package over ALS seeds
# (``jax_reference_ndcg.py cv_als --seeds 42,1,2,3``). The card draws its own
# random stream, so a seeded port run is another seed: the band is twice the
# widest deviation from these means over the JAX runs and the port's CPU
# runs at the same seeds (``--port``; 0.0121, at rank 16, reg 0.1, alpha 40).
JAX_CV_ALS = {
    "{'rank': 8, 'reg_param': 0.1, 'alpha': 1.0}": 0.24389475,
    "{'rank': 8, 'reg_param': 0.1, 'alpha': 40.0}": 0.313625,
    "{'rank': 8, 'reg_param': 0.5, 'alpha': 1.0}": 0.116998,
    "{'rank': 8, 'reg_param': 0.5, 'alpha': 40.0}": 0.3231,
    "{'rank': 16, 'reg_param': 0.1, 'alpha': 1.0}": 0.28667425,
    "{'rank': 16, 'reg_param': 0.1, 'alpha': 40.0}": 0.3281915,
    "{'rank': 16, 'reg_param': 0.5, 'alpha': 1.0}": 0.2282225,
    "{'rank': 16, 'reg_param': 0.5, 'alpha': 40.0}": 0.3325985,
}
CV_ALS_TOL = 0.025
# The real grid (rank [50, 100] x regParam [0.01, 0.5] x alpha [0.01, 40], 13
# iterations, 2 folds) through cross_validate on the train_als tables, every
# fit from the numpy init of ``--shared`` (``jax_reference_ndcg.py cv_als
# --shared``): per-fold NDCG@30 of the JAX package on the CPU, held at 1e-3
# (a near-tie in a top-30 list may swap two items), best params equal. The
# grid is ``builders.jobs.CV_ALS_TABLES_GRID``.
JAX_CV_ALS_FULL = {
    "{'rank': 100, 'reg_param': 0.5, 'alpha': 0.01}": [0.310787171125412, 0.33668819069862366],
    "{'rank': 50, 'reg_param': 0.5, 'alpha': 40.0}": [0.2542586624622345, 0.27342769503593445],
    "{'rank': 50, 'reg_param': 0.01, 'alpha': 40.0}": [0.24517332017421722, 0.2640920579433441],
    "{'rank': 50, 'reg_param': 0.5, 'alpha': 0.01}": [0.24887055158615112, 0.2509066164493561],
    "{'rank': 50, 'reg_param': 0.01, 'alpha': 0.01}": [0.23123088479042053, 0.2544117867946625],
    "{'rank': 100, 'reg_param': 0.5, 'alpha': 40.0}": [0.19963288307189941, 0.22215579450130463],
    "{'rank': 100, 'reg_param': 0.01, 'alpha': 40.0}": [0.18348649144172668, 0.2071085274219513],
    "{'rank': 100, 'reg_param': 0.01, 'alpha': 0.01}": [0.17332850396633148, 0.1856805831193924],
}
JAX_CV_ALS_FULL_BEST = {'rank': 100, 'reg_param': 0.5, 'alpha': 0.01}
CV_ALS_FULL_TOL = 1e-3
# The same grid with every fit by 3-step CG, as ``cv_als --solver cg`` fits
# it (``jax_reference_ndcg.py cv_als --shared --solver cg``; its rank-100
# points run K3's wide path), held as the Cholesky grid.
JAX_CV_ALS_FULL_CG = {
    "{'rank': 100, 'reg_param': 0.5, 'alpha': 0.01}": [0.310800701379776, 0.33632412552833557],
    "{'rank': 50, 'reg_param': 0.5, 'alpha': 40.0}": [0.2556176781654358, 0.2719286382198334],
    "{'rank': 50, 'reg_param': 0.01, 'alpha': 40.0}": [0.24500547349452972, 0.2639934718608856],
    "{'rank': 50, 'reg_param': 0.5, 'alpha': 0.01}": [0.24662651121616364, 0.24842219054698944],
    "{'rank': 50, 'reg_param': 0.01, 'alpha': 0.01}": [0.22895395755767822, 0.24994738399982452],
    "{'rank': 100, 'reg_param': 0.5, 'alpha': 40.0}": [0.1996975690126419, 0.22139383852481842],
    "{'rank': 100, 'reg_param': 0.01, 'alpha': 40.0}": [0.18062444031238556, 0.19831156730651855],
    "{'rank': 100, 'reg_param': 0.01, 'alpha': 0.01}": [0.17769543826580048, 0.18555432558059692],
}
JAX_CV_ALS_FULL_CG_BEST = {'rank': 100, 'reg_param': 0.5, 'alpha': 0.01}
# cv_lr --w2v-full (300 L-BFGS iterations, the five weight columns in one
# batched solve): with the weights of ``ranker --shared``, each column's AUC
# from the JAX package (``jax_reference_ndcg.py cv_lr --shared``) in its
# order, held at 1e-4 (float32 round-off of the solve; the port on the CPU
# is within 2e-5), the order up to columns whose JAX values tie within it
# (``_same_order``); seeded, the mean of the JAX values over seeds 42, 1, 2,
# 3 and, per column, twice the widest deviation from it over those runs and
# the port's CPU runs at the same seeds (``--port``). The heavy weights of
# positive_created_week_weight (the repo's creation week, ~2600, on the
# positives) make its AUC the most seed-sensitive: 0.848 to 0.879.
JAX_CV_LR_SHARED = [["positive_starred_weight", 0.967316], ["positive_created_weight", 0.967316],
                    ["default_weight", 0.967316], ["positive_weight", 0.946539],
                    ["positive_created_week_weight", 0.880868]]
CV_LR_SHARED_TOL = 1e-4
JAX_CV_LR = {"default_weight": 0.96778275, "positive_weight": 0.9460105, "positive_starred_weight": 0.9677845,
             "positive_created_weight": 0.9677845, "positive_created_week_weight": 0.855371}
CV_LR_TOL = {"default_weight": 1.8e-3, "positive_weight": 4.6e-3, "positive_starred_weight": 1.8e-3,
             "positive_created_weight": 1.8e-3, "positive_created_week_weight": 4.8e-2}
CV_NEEDS = {
    "cv_als": ("als_partials", "solve_corrected", "land_rows", "topk_scores", "factor_health"),
    "cv_als real grid": ("als_partials", "als_partials_wide", "solve_corrected", "solve_corrected_wide",
                         "land_rows", "topk_scores", "factor_health"),
    "cv_als real grid, cg": ("bucket_cg", "bucket_cg_wide", "land_rows", "topk_scores", "factor_health"),
    "cv_lr": ("segment_dot_grid", "gather_sum_grid", "segment_dot", "gather_sum", "land_rows",
              "als_partials", "solve_corrected", "sgns_step", "adam_dense", "factor_health"),
    # The shared weights replace the Word2Vec fit (no K9, no Adam).
    "cv_lr shared": ("segment_dot_grid", "gather_sum_grid", "segment_dot", "gather_sum", "land_rows",
                     "als_partials", "solve_corrected", "factor_health"),
}
GRID_SIZES = (1, 5, 7)


def _k8g_case(x, idx, val, ip) -> dict:
    """K8g at (G, n) ``x``: each row against K8 on that row bit for bit, and
    against the plain version computed in float64 within the float32
    summation bound of two orders (``_k8_orders``): ``bound_ratio``, that of
    the one-warp-per-segment order K8g had first, (ceil(len / 32) + 6) u of
    each segment's L1 mass (u = 2^-24), held since K8g's first port, and
    ``bound_ratio_merge``, its merge-path order's own; each at most 1. Also
    one counted launch and the same bits on a second call. The float32 plain
    version adds with atomics in another order; on the fit's 200 000-row
    category segments it strays up to 3e-4 of the mass from float64 on an
    H100 (cuSPARSE 2e-5), so its distance is reported (``err_f32_plain``)
    and not held."""
    from albedo_tpu_torch.ops import sparse_linear as sl

    got, run = _k8_run(x, idx, val, ip)
    err_f32 = _k8_err(x, idx, val, ip, got, sl.segment_dot_reference(x, idx, val, ip))
    rows_equal = all(torch.equal(got[g], sl.segment_dot(x[g].contiguous(), idx, val, ip)) for g in range(x.shape[0]))
    return dict(_k8_orders(x, idx, val, ip, got), **run, err_f32_plain=err_f32, rows_equal_k8=rows_equal)


def _k8cg_case(base, tables, idxs) -> dict:
    """K8c-g: exactly its plain version, and each row K8c on that row."""
    from albedo_tpu_torch.ops import sparse_linear as sl

    got = sl.gather_sum(base, tables, idxs)
    exact = bool(torch.equal(got, sl.gather_sum_reference(base, tables, idxs)))
    rows_equal = all(torch.equal(got[g], sl.gather_sum(base[g].contiguous(), [t[g].contiguous() for t in tables], idxs))
                     for g in range(base.shape[0]))
    return {"exact": exact, "rows_equal_k8c": rows_equal}


def _k4_case(rng, n_target: int, sizes, k: int, dev) -> dict:
    """K4 on a pool of blocks of ``sizes`` slots: 20% -1 padding slots, the
    rows no slot names kept; land_rows and scatter_rows against their plain
    versions and each other, exactly."""
    from albedo_tpu_torch.ops import als as ops_als

    n_slots = int(np.sum(sizes))
    row_ids = np.full(n_slots, -1, np.int32)
    live = rng.random(n_slots) < 0.8
    n_live = min(int(live.sum()), n_target)
    live[np.flatnonzero(live)[n_live:]] = False
    row_ids[live] = rng.permutation(n_target)[:n_live]
    landing = np.arange(n_slots, n_slots + n_target, dtype=np.int64)
    landing[row_ids[live]] = np.flatnonzero(live)
    target = torch.as_tensor(rng.normal(size=(n_target, k)).astype(np.float32), device=dev)
    flat = torch.as_tensor(rng.normal(size=(n_slots, k)).astype(np.float32), device=dev)
    land = torch.as_tensor(landing, device=dev)
    ids = torch.as_tensor(row_ids, device=dev)
    got = ops_als.land_rows(target, flat, land)
    sc = ops_als.scatter_solved(target, ids, flat)
    torch.cuda.synchronize()
    return {"k": k, "blocks": len(sizes), "slots": n_slots, "kept_rows": n_target - n_live,
            "land_exact": bool(torch.equal(got, ops_als.land_rows_reference(target, flat, land))),
            "scatter_exact": bool(torch.equal(sc, ops_als.scatter_solved_reference(target, ids, flat))),
            "agree": bool(torch.equal(got, sc))}


def _grid_params(models, dev) -> dict:
    """The grid models' coefficients stacked on a leading G axis."""
    return {k: torch.as_tensor(np.stack([np.asarray(m.params[k], np.float32) for m in models])).to(dev)
            for k in models[0].params}


def phase_cv_kernels(lr_inputs) -> dict:
    """K8g and K8c-g at G = 1, 5 and 7 on skewed segments (empty ones, a
    20 000-entry head, a null ``val``), on gathers with a one-entry table
    and 40 terms (two chained launches), and on the ranker fit's batch (the
    fitted coefficients, perturbed per grid row): against their plain
    versions (K8g in float64, within its order's float32 summation bound;
    K8c-g exactly) and each row against K8 or K8c on that row bit for bit. K4's land_rows and
    scatter_rows exactly, at ranks 8, 50, 100 and 256, with -1 padding
    slots and rows in no bucket."""
    from albedo_tpu_torch.models import logistic_regression as lr_mod
    from albedo_tpu_torch.ops import sparse_linear as sl

    dev = torch.device("cuda")
    rng = np.random.default_rng(37)
    k8g, k8cg = {}, {}
    counts = rng.integers(0, 40, size=3000)
    counts[::7] = 0
    counts[5] = 20000
    indptr = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32), device=dev)
    nnz = int(indptr[-1])
    idx = torch.as_tensor(rng.integers(0, 500, size=nnz).astype(np.int32), device=dev)
    val = torch.as_tensor(rng.normal(size=nnz).astype(np.float32), device=dev)
    n = 100_000
    sizes = ([1, 7, 300, 5000] * 10)[:40]
    idxs = [torch.as_tensor(rng.integers(0, max(1, s // 2 + 1), size=n).astype(np.int32), device=dev) for s in sizes]
    for g in GRID_SIZES:
        x = torch.as_tensor(rng.normal(size=(g, 500)).astype(np.float32), device=dev)
        for v in (val, None):
            k8g[f"skewed G={g} val={'null' if v is None else 'f32'}"] = _k8g_case(x, idx, v, indptr)
        base = torch.as_tensor(rng.normal(size=(g, n)).astype(np.float32), device=dev)
        tables = [torch.as_tensor(rng.normal(size=(g, s)).astype(np.float32), device=dev) for s in sizes]
        for j in (3, 40):
            k8cg[f"synthetic G={g} terms={j}"] = _k8cg_case(base, tables[:j], idxs[:j])
    # The ranker fit's batch: every K8g call of one forward and backward of
    # the grid objective, and the K8c-g forward, at the fitted coefficients
    # with each grid row perturbed.
    est, fm, labels, weights, model = lr_inputs
    for g in GRID_SIZES:
        pert = np.random.default_rng(g)
        models = [lr_mod.LogisticRegressionModel(
            params={k: (np.asarray(v, np.float32) * np.float32(1 + 0.1 * pert.standard_normal())).astype(np.float32)
                    for k, v in model.params.items()},
            scales=model.scales, train_loss=0.0, center=model.center) for _ in range(g)]
        ws = np.stack([np.asarray(weights, np.float32) * np.float32(1 + 0.5 * i) for i in range(g)])
        calls, gs = _grid_calls(est, fm, labels, ws, models)
        k8g[f"ranker fit G={g}"] = _worst_k8g([_k8g_case(*c) for c in calls])
        k8cg[f"ranker fit G={g}"] = _k8cg_case(gs["base"], gs["tables"], gs["layout"][0])
    k4 = {}
    for k in (8, 50, 100, 256):
        k4[f"k={k}"] = _k4_case(rng, 5000, rng.integers(1, 60, size=70), k, dev)
    torch.cuda.synchronize()
    ok = (all(c["bound_ratio"] <= 1.0 and c["rows_equal_k8"] and _k8_new_checks_ok(c) for c in k8g.values())
          and all(c["exact"] and c["rows_equal_k8c"] for c in k8cg.values())
          and all(c["land_exact"] and c["scatter_exact"] and c["agree"] for c in k4.values()))
    emit({"phase": "cv_kernels", "ok": ok, "segment_dot_grid": k8g, "gather_sum_grid": k8cg, "land_rows": k4,
          "tol": {"segment_dot_grid": "(len/32 + 6) 2^-24 of the mass; merge order (min(len, 2) + 9 + "
                                      "[C > 1](ceil((C - 1)/32) + 6)) 2^-24", "gather_sum_grid": 0.0,
                  "land_rows": 0.0}})
    if not ok:
        raise SystemExit("chip_smoke: K8g, K8c-g or K4 disagrees with its plain version, its one-row kernel, "
                         "its order's bound, itself, or its one launch")
    return {"segment_dot_grid": k8g, "gather_sum_grid": k8cg, "land_rows": k4}


def _worst_k8g(cases: list[dict]) -> dict:
    return {"calls": len(cases), "err": (max(c["err"][0] for c in cases), max(c["err"][1] for c in cases)),
            "bound_ratio": max(c["bound_ratio"] for c in cases),
            "bound_ratio_merge": max(c["bound_ratio_merge"] for c in cases),
            "err_f32_plain": max(c["err_f32_plain"][1] for c in cases),
            "rows_equal_k8": all(c["rows_equal_k8"] for c in cases),
            "repeat_equal": all(c["repeat_equal"] for c in cases), "one_launch": all(c["one_launch"] for c in cases)}


def _grid_calls(est, fm, labels, ws, models) -> tuple[list, dict]:
    """The K8g calls (x, idx, val, indptr) of one forward and backward of
    the grid objective at ``models``' coefficients under weight rows ``ws``,
    and the K8c-g forward's inputs with its cotangent, recorded as made."""
    from albedo_tpu_torch.models import logistic_regression as lr_mod
    from albedo_tpu_torch.ops import sparse_linear as sl

    dev = torch.device("cuda")
    batch = sl.feature_batch(fm, dev, grad_layout=True)
    scales = lr_mod._to_device(models[0].scales, dev)
    params = {k: v.requires_grad_(True) for k, v in _grid_params(models, dev).items()}
    center = None if models[0].center is None else torch.as_tensor(models[0].center).to(dev)
    y = torch.as_tensor(np.asarray(labels, np.float32)).to(dev)
    w = torch.as_tensor(np.asarray(ws, np.float32)).to(dev)
    calls, captured = [], {}
    orig, apply = sl.segment_dot, sl._GatherSum.apply

    def recording(x, idx, val, indptr):
        calls.append((x.detach().clone(), idx, val, indptr))
        return orig(x, idx, val, indptr)

    def recording_apply(base, layout, *tables):
        out = apply(base, layout, *tables)
        captured.update(base=base.detach().contiguous(), layout=layout,
                        tables=[t.detach().contiguous() for t in tables])
        out.register_hook(lambda g: captured.__setitem__("g", g.detach().clone()))
        return out

    sl.segment_dot, sl._GatherSum.apply = recording, recording_apply
    try:
        sl.weighted_logloss(params, scales, batch, y, w, est.reg_param, center=center).sum().backward()
    finally:
        sl.segment_dot, sl._GatherSum.apply = orig, apply
    return calls, captured


def _shared_fits():
    """Every ALS fit from the numpy init of ``--shared`` and every Word2Vec
    fit returning its numpy vectors, as ``_ranker_job_shared`` sets them;
    returns the function that restores both."""
    from albedo_tpu_torch.models import als as als_mod
    from albedo_tpu_torch.models import word2vec as w2v_mod

    als_fit, fit_corpus = als_mod.ImplicitALS.fit, w2v_mod.Word2Vec.fit_corpus

    def shared_als_fit(self, matrix, *a, **k):
        self.init_factors = _shared_init(matrix.n_users, matrix.n_items, self.rank)
        return als_fit(self, matrix, *a, **k)

    def shared_fit_corpus(self, sentences):
        vocab = self.plan(sentences).vocab
        rng = np.random.default_rng(SHARED_SEED)
        vectors = rng.normal(scale=SHARED_W2V_SCALE, size=(len(vocab), self.dim)).astype(np.float32)
        return w2v_mod.Word2VecModel(vocab, vectors, self.input_col, self.output_col or f"{self.input_col}__w2v")

    als_mod.ImplicitALS.fit, w2v_mod.Word2Vec.fit_corpus = shared_als_fit, shared_fit_corpus

    def restore():
        als_mod.ImplicitALS.fit, w2v_mod.Word2Vec.fit_corpus = als_fit, fit_corpus

    return restore


def _cv_lr_run(shared: bool) -> tuple[dict, tuple]:
    """``cv_lr --w2v-full`` through the CLI (counts set to 0 before, read
    after), seeded or on the shared weights, with the batched fit's inputs
    and models recorded: the per-column AUC, the grid order, each row's
    L-BFGS steps, and the job's wall-clock split (its timer's sections:
    the ALS and Word2Vec fits, the ranker's stages)."""
    from albedo_tpu_torch.builders import jobs as jobs_mod
    from albedo_tpu_torch.models import logistic_regression as lr_mod

    recorded = {}
    fit_many, train_ranker = lr_mod.LogisticRegression.fit_many, jobs_mod.train_ranker

    def recording_fit_many(self, fm, labels, sample_weights, grid_mesh=None):
        models = fit_many(self, fm, labels, sample_weights, grid_mesh)
        recorded["fit"] = (self, fm, labels, np.asarray(sample_weights, np.float32), models)
        return models

    def recording_train_ranker(*args, **kwargs):
        recorded["timer"] = kwargs["timer"]
        return train_ranker(*args, **kwargs)

    restore = _shared_fits() if shared else (lambda: None)
    lr_mod.LogisticRegression.fit_many, jobs_mod.train_ranker = recording_fit_many, recording_train_ranker
    try:
        report, text = _run_cli(["cv_lr", "--w2v-full", "--now", "1600000000"])
    finally:
        lr_mod.LogisticRegression.fit_many, jobs_mod.train_ranker = fit_many, train_ranker
        restore()
    grid = [[c, float(a)] for c, a in re.findall(r"\[cv_lr\] (\S+) -> AUC (\S+)", text)]
    models = recorded["fit"][4]
    report.update(grid=grid, lbfgs_steps=[m.n_iter_run for m in models],
                  train_loss=[m.train_loss for m in models], run_s=models[0].run_s, prep_s=models[0].prep_s,
                  stages={k: round(v, 4) for k, v in recorded["timer"].totals.items()})
    return report, recorded["fit"]


def _same_order(got: list, want: list, tol: float) -> bool:
    """``got`` ranks its columns as ``want`` does, except columns whose
    ``want`` values lie within ``tol`` of each other: on the synthetic
    tables three weight columns are constant, so their objectives are one
    objective up to a scale and their order is float32 round-off."""
    pos = {c: i for i, (c, _) in enumerate(got)}
    return all(pos[a] < pos[b] for i, (a, va) in enumerate(want) for b, vb in want[i + 1:] if va - vb > tol)


def _cv_als_real_grid(solver: str = "cholesky") -> dict:
    """The real grid through ``cross_validate`` on the train_als tables,
    every fit from the shared numpy init by ``solver``, each fold scored as
    the job scores it; counts set to 0 before and read after."""
    from albedo_tpu_torch import cli, kernels
    from albedo_tpu_torch.builders.jobs import CV_ALS_TABLES_GRID, JobContext, cv_als_evaluate
    from albedo_tpu_torch.cv import cross_validate, param_grid
    from albedo_tpu_torch.models.als import ImplicitALS

    matrix = JobContext(cli.parse_args(["train_als"])).matrix()

    compile_s = []

    def fit(params, train):
        est = ImplicitALS(max_iter=13, init_factors=_shared_init(train.n_users, train.n_items, params["rank"]),
                          solver=solver, **params)
        model = est.fit(train)
        compile_s.append(est.last_fit_report["compile_s"])
        return model

    kernels.reset_launches()
    t0 = time.perf_counter()
    results = cross_validate(fit, cv_als_evaluate, matrix, param_grid(**CV_ALS_TABLES_GRID), n_folds=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    folds = {str(r.params): r.fold_metrics for r in results}
    jax, jax_best, needs = ((JAX_CV_ALS_FULL, JAX_CV_ALS_FULL_BEST, CV_NEEDS["cv_als real grid"]) if solver == "cholesky"
                            else (JAX_CV_ALS_FULL_CG, JAX_CV_ALS_FULL_CG_BEST, CV_NEEDS["cv_als real grid, cg"]))
    gap = max((abs(a - b) for key, want in jax.items()
               for a, b in zip(folds.get(key, [float("inf")] * len(want)), want)), default=float("inf"))
    return {"solver": solver, "seconds": seconds, "compile_s": compile_s, "launches": launches, "fold_ndcg": folds,
            "jax": jax,
            "max_gap": gap, "best": results[0].params, "jax_best": jax_best,
            "ok": (gap <= CV_ALS_FULL_TOL and results[0].params == jax_best
                   and all(launches[n] > 0 for n in needs))}


def _landing_calls(est, matrix) -> list[tuple]:
    """One iteration's two landings of an ALS fit of ``est`` on ``matrix``
    (the item side, then the user side): the old table, a solved pool of the
    sweep's slots (random values: a landing moves rows, whatever they hold)
    and the landing permutation."""
    dev = torch.device("cuda")
    ug, ig, u_land, i_land = est.device_groups(matrix)
    gen = torch.Generator(device=dev).manual_seed(5)
    calls = []
    for groups, landing, n_rows in ((ig, i_land, matrix.n_items), (ug, u_land, matrix.n_users)):
        target = torch.randn((n_rows, est.rank), generator=gen, device=dev)
        pool = torch.randn((sum(g.row_ids.numel() for g in groups), est.rank), generator=gen, device=dev)
        calls.append((target, pool, landing))
    return calls


def _time_landing(calls) -> dict:
    from albedo_tpu_torch.ops import als as ops_als

    exact = all(torch.equal(ops_als.land_rows(*c), ops_als.land_rows_reference(*c)) for c in calls)
    n_bytes = sum(8 * t.shape[0] + 2 * 4 * t.numel() for t, _, _ in calls)
    return dict(err=(0.0, 0.0) if exact else (float("inf"), float("inf")),
                ms=cuda_ms(lambda: [ops_als.land_rows(*c) for c in calls], reps=20),
                plain_ms=cuda_ms(lambda: [ops_als.land_rows_reference(*c) for c in calls], reps=20),
                library_ms=None, bytes=n_bytes, flops=0,
                shape={"rows": [int(t.shape[0]) for t, _, _ in calls], "k": int(calls[0][0].shape[1]),
                       "slots": [int(p.shape[0]) for _, p, _ in calls]})


def _time_scatter(calls) -> dict:
    """scatter_rows at the same landings: the slots' row ids rebuilt from
    the landing permutation."""
    from albedo_tpu_torch.ops import als as ops_als

    args = []
    for target, flat, landing in calls:
        n_slots = flat.shape[0]
        ids = torch.full((n_slots,), -1, dtype=torch.int32, device=flat.device)
        keep = landing < n_slots
        ids[landing[keep]] = torch.arange(target.shape[0], device=flat.device, dtype=torch.int32)[keep]
        args.append((target, ids, flat))
    exact = all(torch.equal(ops_als.scatter_solved(*a), ops_als.scatter_solved_reference(*a)) for a in args)
    return _timed(dict(err=(0.0, 0.0) if exact else (float("inf"), float("inf")),
                       ms=cuda_ms(lambda: [ops_als.scatter_solved(*a) for a in args], reps=20),
                       plain_ms=cuda_ms(lambda: [ops_als.scatter_solved_reference(*a) for a in args], reps=20),
                       library_ms=None,
                       bytes=sum(4 * i.numel() + 4 * f.numel() + 2 * 4 * t.numel() for t, i, f in args), flops=0))


def _time_grid_kernels(fit) -> dict:
    """K8g and K8c-g at the batched fit's batch and fitted coefficients:
    held (as in ``cv_kernels``) and timed per call of one forward and
    backward, with their plain versions, G launches of the one-row kernel
    on the rows, a library call (K8g: cuSPARSE SpMM, CSR times the (n, G)
    x; K8c-g: none) and the bound."""
    from albedo_tpu_torch.ops import sparse_linear as sl

    est, fm, labels, ws, models = fit
    calls, gs = _grid_calls(est, fm, labels, ws, models)
    n_grid = ws.shape[0]
    cases = [_k8g_case(*c) for c in calls]
    rows = [[x[g].contiguous() for g in range(n_grid)] for x, _, _, _ in calls]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        csr = [torch.sparse_csr_tensor(ip, idx, val if val is not None else torch.ones_like(idx, dtype=torch.float32),
                                       size=(ip.shape[0] - 1, x.shape[1]), check_invariants=False)
               for x, idx, val, ip in calls]
        xt = [x.T.contiguous() for x, _, _, _ in calls]
        library_err = max(mass_err((m @ t).T.double(), sl.segment_dot_reference(
            x.double(), idx, None if val is None else val.double(), ip), sl.segment_dot_reference(
            x.double().abs(), idx, None if val is None else val.double().abs(), ip))[1]
            for m, t, (x, idx, val, ip) in zip(csr, xt, calls))
    k8g = dict(
        err=(max(c["err"][0] for c in cases), max(c["err"][1] for c in cases)),
        ms=cuda_ms(lambda: [sl.segment_dot(*c) for c in calls], reps=10),
        plain_ms=cuda_ms(lambda: [sl.segment_dot_reference(*c) for c in calls], reps=10),
        library_ms=cuda_ms(lambda: [m @ t for m, t in zip(csr, xt)], reps=10), library_rel_err=library_err,
        bytes=sum(4 * (idx.numel() * (2 if val is not None else 1) + ip.numel() + x.numel() + n_grid * (ip.numel() - 1))
                  for x, idx, val, ip in calls),
        flops=sum(n_grid * idx.numel() * (2 if val is not None else 1) for _, idx, val, _ in calls),
        shape={"G": n_grid, "calls": len(calls), "nnz": [int(c[1].numel()) for c in calls],
               "segments": [int(c[3].numel() - 1) for c in calls],
               "longest_share": [float((c[3][1:] - c[3][:-1]).max()) / max(1, int(c[1].numel())) for c in calls]},
    )
    k8_rows_ms = cuda_ms(lambda: [sl.segment_dot(r, *c[1:]) for rs, c in zip(rows, calls) for r in rs], reps=10)
    base, tables, idxs = gs["base"], gs["tables"], gs["layout"][0]
    k8cg_case = _k8cg_case(base, tables, idxs)
    base_rows = [base[g].contiguous() for g in range(n_grid)]
    table_rows = [[t[g].contiguous() for t in tables] for g in range(n_grid)]
    n = base.shape[1]
    entries = sum(t.shape[1] for t in tables)
    k8cg = dict(
        err=(0.0, 0.0) if k8cg_case["exact"] else (float("inf"), float("inf")),
        ms=cuda_ms(lambda: sl.gather_sum(base, tables, idxs), reps=20),
        plain_ms=cuda_ms(lambda: sl.gather_sum_reference(base, tables, idxs), reps=20),
        library_ms=None,
        bytes=4 * (len(tables) * n + 2 * n_grid * n + n_grid * entries), flops=n_grid * n * len(tables),
        shape={"G": n_grid, "rows": n, "terms": len(tables), "table_entries": entries},
    )
    k8c_rows_ms = cuda_ms(lambda: [sl.gather_sum(b, t, idxs) for b, t in zip(base_rows, table_rows)], reps=20)
    worst = _worst_k8g(cases)
    device = {"ms": _device_ms(lambda: [sl.segment_dot(*c) for c in calls]),
              "library_ms": _device_ms(lambda: [m @ t for m, t in zip(csr, xt)]),
              "k8_rows_ms": _device_ms(lambda: [sl.segment_dot(r, *c[1:]) for rs, c in zip(rows, calls) for r in rs])}
    return {"segment_dot_grid": dict(_timed(k8g), k8_rows_ms=k8_rows_ms, device=device,
                                     **{k: worst[k] for k in ("rows_equal_k8", "bound_ratio", "bound_ratio_merge",
                                                              "err_f32_plain", "repeat_equal", "one_launch")}),
            "gather_sum_grid": dict(_timed(k8cg), k8c_rows_ms=k8c_rows_ms, rows_equal_k8c=k8cg_case["rows_equal_k8c"])}


def _fit_many_profile(fit, iters: int = 5) -> dict:
    """fit_many against five sequential fit calls at the cv_lr job's inputs
    (host wall clock; both end in a device read), and a short fit_many
    under ``torch.profiler`` for the device's idle share."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    est, fm, labels, ws, _ = fit
    t0 = time.perf_counter()
    many = est.fit_many(fm, labels, ws)
    many_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    seq = [est.fit(fm, labels, w) for w in ws]
    seq_s = time.perf_counter() - t0
    short = dataclasses.replace(est, max_iter=iters)
    short.fit_many(fm, labels, ws)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        short.fit_many(fm, labels, ws)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return {"fit_many_s": many_s, "fit_many_run_s": many[0].run_s, "sequential_fit_s": seq_s,
            "sequential_run_s": sum(m.run_s for m in seq),
            "steps_many": [m.n_iter_run for m in many], "steps_sequential": [m.n_iter_run for m in seq],
            "loss_rel_gap": max(abs(a.train_loss - b.train_loss) / abs(b.train_loss) for a, b in zip(many, seq)),
            "profile": dict({"iterations": iters}, **_device_summary(prof, wall))}


def phase_cv(bench_train) -> dict:
    """The model-selection paths at full width: ``cv_als`` as the CLI runs
    it (seeded; each grid point's mean NDCG@30 in the JAX seed band), the
    real grid through ``cross_validate`` from the shared numpy inits, by
    Cholesky and by 3-step CG (per-fold NDCG@30 against JAX, the best
    params; K3's wide path launched by the CG grid), ``cv_lr --w2v-full``
    seeded (each column's AUC in the JAX seed band) and on the shared
    weights (each column's AUC within 1e-4 of JAX, in JAX's order); each
    with its launch counts. Then fit_many against five sequential fits and
    its idle share, K8g and K8c-g at the fit's batch against their bounds
    and against G launches of K8 and K8c, and K4 at the bench fit's landings
    (rank 50) and the cv fits' (rank 100)."""
    from albedo_tpu_torch.models.als import ImplicitALS

    launches = {}
    report, text = _run_cli(["cv_als", "--now", "1600000000"])
    means = {p: float(v) for p, v in re.findall(r"^(\{.*\}) -> (\S+)$", text, flags=re.M)}
    gaps = {p: means[p] - JAX_CV_ALS[p] for p in JAX_CV_ALS}
    ok = (len(means) == 8 and all(abs(g) <= CV_ALS_TOL for g in gaps.values())
          and all(report["launches"][n] > 0 for n in CV_NEEDS["cv_als"]))
    emit(dict(report, phase="cv", run="cv_als", ok=ok, mean_ndcg=means, jax=JAX_CV_ALS, gap=gaps, tol=CV_ALS_TOL,
              best=re.search(r"\[cv_als\] best params = (.*)", text).group(1)))
    if not ok:
        raise SystemExit("chip_smoke: cv_als left the JAX seed band or did not launch its kernels")
    launches["land_rows"] = report["launches"]["land_rows"]

    for solver in ("cholesky", "cg"):
        real = _cv_als_real_grid(solver)
        emit(dict(real, phase="cv", run=f"cv_als real grid, shared inits, {solver}", tol=CV_ALS_FULL_TOL))
        if not real["ok"]:
            raise SystemExit(f"chip_smoke: the real cv_als grid ({solver}) left the JAX values or picked other "
                             "params, or did not launch its kernels")

    seeded, fit = _cv_lr_run(shared=False)
    gaps = {c: a - JAX_CV_LR[c] for c, a in seeded["grid"]}
    ok = (len(seeded["grid"]) == 5 and all(abs(g) <= CV_LR_TOL[c] for c, g in gaps.items())
          and all(seeded["launches"][n] > 0 for n in CV_NEEDS["cv_lr"]))
    emit(dict(seeded, phase="cv", run="cv_lr seeded", ok=ok, jax=JAX_CV_LR, gap=gaps, tol=CV_LR_TOL))
    if not ok:
        raise SystemExit("chip_smoke: cv_lr left the JAX seed band or did not launch its kernels")
    launches.update({n: seeded["launches"][n] for n in ("segment_dot_grid", "gather_sum_grid")})
    shared, _ = _cv_lr_run(shared=True)
    got, want = dict(shared["grid"]), dict(JAX_CV_LR_SHARED)
    gaps = {c: got[c] - want[c] for c in want if c in got}
    ok = (len(gaps) == len(got) == 5 and all(abs(g) <= CV_LR_SHARED_TOL for g in gaps.values())
          and _same_order(shared["grid"], JAX_CV_LR_SHARED, CV_LR_SHARED_TOL)
          and all(shared["launches"][n] > 0 for n in CV_NEEDS["cv_lr shared"]))
    emit(dict(shared, phase="cv", run="cv_lr shared", ok=ok, jax=JAX_CV_LR_SHARED, gap=gaps, tol=CV_LR_SHARED_TOL,
              exact_order=[c for c, _ in shared["grid"]] == [c for c, _ in JAX_CV_LR_SHARED]))
    if not ok:
        raise SystemExit("chip_smoke: cv_lr on the shared weights left the JAX values or order")

    grid_timed = _time_grid_kernels(fit)
    profile = _fit_many_profile(fit)
    bench_est = ImplicitALS(rank=50, max_iter=1)
    landing = _landing_calls(bench_est, bench_train)
    land = _timed(_time_landing(landing))
    wide = _timed(_time_landing(_landing_calls(ImplicitALS(rank=100, max_iter=1),
                                               _job_matrix())))
    scatter = _time_scatter(landing)
    ok = (grid_timed["segment_dot_grid"]["bound_ratio"] <= 1.0
          and grid_timed["segment_dot_grid"]["rows_equal_k8"] and _k8_new_checks_ok(grid_timed["segment_dot_grid"])
          and grid_timed["gather_sum_grid"]["rel_err"] == 0.0 and grid_timed["gather_sum_grid"]["rows_equal_k8c"]
          and land["rel_err"] == 0.0 and wide["rel_err"] == 0.0 and scatter["rel_err"] == 0.0
          and profile["loss_rel_gap"] <= 1e-5)
    emit({"phase": "cv_timing", "ok": ok, "fit_many": profile, "grid_kernels": grid_timed,
          "land_rows": {"bench r50": land, "train_als tables r100": wide}, "scatter_rows bench r50": scatter})
    if not ok:
        raise SystemExit("chip_smoke: a grid or landing kernel disagrees at its timed inputs, "
                         "or fit_many left the sequential fits")
    return {"launches": launches, "timed": dict(grid_timed, land_rows=land)}


# ------------------------------------------------------------------ phase 12

# The bench protocol at bf16 gathers (``ImplicitALS(gather_dtype="bfloat16")``):
# the JAX package's CPU NDCG@30 from the same pinned init
# (``jax_reference_ndcg.py cholesky cg --gather-dtype bfloat16``), held in
# the float32 bands (NDCG_TOL). Against the port's float32 fit of phase 7,
# the JAX test's own criteria for bf16 gathers (tests/test_als.py:223-244):
# the objective within 1% and a prediction correlation above 0.995.
JAX_NDCG_BF16 = {"cholesky": 0.29414722323417664, "cg": 0.29420164227485657}
BF16_LOSS_RATIO, BF16_CORR = 1.01, 0.995
# Word2Vec with a shared pool of 512 negatives on the ``train_word2vec``
# job's corpus (dim 200, 30 epochs, batch 4096; 146 words, 199 938 pairs):
# the JAX package's final-epoch mean loss on the CPU over seeds 42, 1, 2, 3
# (``jax_reference_ndcg.py w2v_shared --seeds 42,1,2,3``). The card draws
# its own stream, so a port fit is another seed: its loss must lie within
# twice the JAX seeds' spread (max - min) of their mean.
JAX_W2V_SHARED_LOSS = (1.7945425510406494, 1.7886279821395874, 1.791600227355957, 1.7941198348999023)
# The LR ranker with ``solver="adam"`` (learning rate 0.05) on the shared
# weights of ``ranker --shared``: the JAX package's CPU values
# (``jax_reference_ndcg.py ranker --shared --lr-solver adam [--lr-max-iter
# 10]``). No draws are involved, but Adam at this rate oscillates without
# converging in the job's 300 steps (the loss swings by ~4e-3 from step to
# step), so float32 round-off moves the reported last-step loss: under row
# permutations of the training set (``--permute-seeds 1,2,3``, only the
# summation order changes) the JAX package's 300-step fits span train_loss
# 0.50360-0.50498 and AUC 0.96481-0.96634, the port's on the CPU
# 0.50719-0.50987 and 0.95666-0.96232 (a float64 run of the port lands at
# 0.50503). After 10 steps the trajectories still agree (the port on the CPU
# is 1.3e-5 from JAX in loss, 1.9e-6 in AUC): the 10-step loss is held to
# rel 1e-4; the 300-step fit's loss and AUC to twice the widest distance of
# those float32 runs from the JAX value.
JAX_LR_ADAM = {"auc": 0.9653705866784998, "train_loss": 0.504708468914032}
JAX_LR_ADAM_10_LOSS = 3.1398122310638428
LR_ADAM_REL = 1e-4
LR_ADAM_RUNS = {"train_loss": (0.5042344331741333, 0.5049780607223511, 0.5035973191261292, 0.5081034898757935,
                               0.5071924924850464, 0.5075550675392151, 0.5098674893379211),
                "auc": (0.9658613924038039, 0.964808388215533, 0.9663410437047812, 0.962319602889228,
                        0.960399903247253, 0.9603733271956362, 0.9566641992063003)}
LR_ADAM_BAND = {n: 2 * max(abs(x - JAX_LR_ADAM[n]) for x in runs) for n, runs in LR_ADAM_RUNS.items()}
# The refscale Word2Vec record of the JAX bench (bench.py:740-776): 10 M
# tokens, Zipf 1.05 over 60 000 words, sentences of 15, numpy seed 42;
# dim 200, window 5, min count 10, 30 epochs, batch 65536, 512 shared
# negatives. Epochs are cut (never widths) when the first one projects the
# 30 past this many seconds.
W2V_REFSCALE_BUDGET_S = 240.0
BF16_ENTRIES = {"cholesky": ("als_partials_bf16",), "cg": ("bucket_cg_bf16",)}
# K1-bf16 and K3-bf16 against their plain versions. K1-bf16 rounds no
# computed value (its products are exact in float32): rel 1e-4, as K1. K3-bf16
# rounds the computed iterate p and t = c1 q to bf16 at each matvec, and a
# float32 round-off in another summation order can flip one such rounding
# (one bf16 step, 2^-8): reversing each row's entry order moves the plain
# version by up to 1.0e-4 of max |x| on these buckets (CPU), the kernel sat
# up to 1.9e-4 from it on an H100, while leaving out any one
# rounding site moves it by 8.4e-4 to 1.4e-3 (tests/test_torch_ops_als.py
# ``test_k3_bf16_tolerance_separates_round_off_from_a_missing_site``). On
# long rows a reordering alone moves the plain version past 5e-4 (7.6e-4 on
# als_partials_bench's tables), so each row of K3-bf16 is held to the
# effects of the roundings its float32 round-off could flip plus that
# round-off, at least rel 5e-4 of its group's max |x|
# (``ops.als.bucket_cg_bf16_limits``).
def bf16_rel() -> dict:
    """K1-bf16's rel limit, and K3-bf16's floor of the row limits
    (``ops.als.K3_BF16_REL``)."""
    from albedo_tpu_torch.ops import als as ops_als

    return {"als_partials_bf16": 1e-4, "bucket_cg_bf16": ops_als.K3_BF16_REL}


def _hold_k9s(in_t, out_t, c, o, pool, scale, ws=None, calls: int = 1) -> dict:
    """K9s ``calls`` times from zeroed gradients, held against its plain
    version on float64 copies of the tables (the exact gradients of its
    float32 inputs), element by element and the loss, to
    ``ops.sgns.sgns_shared_limits`` (F8: lambda = 10 standard deviations
    of the round-off of the kernel's own summation order and of its
    logits, never above ``sgns_shared_cap``, the fixed 5e-5 x max(1, B /
    4096) of each element's mass it replaced): ``over``, the worst error
    over its limit (the check holds at most 1); ``err``, the worst error
    and its share of the element's mass (a reading); whether every call
    gave the same bits."""
    from albedo_tpu_torch.ops import sgns

    runs = []
    for _ in range(calls):
        g = (torch.zeros_like(in_t), torch.zeros_like(out_t), torch.zeros(1, device=in_t.device))
        sgns.sgns_shared_step(in_t, out_t, c, o, pool, *g, scale, ws)
        runs.append(g)
    dd = [t.double() for t in (in_t, out_t)]
    want = (torch.zeros_like(dd[0]), torch.zeros_like(dd[1]), torch.zeros(1, dtype=torch.float64, device=in_t.device))
    sgns.sgns_shared_step_reference(*dd, c, o, pool, *want, scale)
    errs = [mass_err(a.double(), e, m) for a, e, m in
            zip(runs[0], want, sgns.sgns_shared_grad_mass(*dd, c, o, pool, scale))]
    errs.append(rel_err(runs[0][2].double(), want[2]))
    plan = sgns.k9s_plan(c.shape[0], in_t.shape[1], pool.shape[0])
    limits = sgns.sgns_shared_limits(in_t, out_t, c, o, pool, scale, plan)
    return {"err": (max(e[0] for e in errs), max(e[1] for e in errs)),
            "over": sgns.sgns_shared_over(runs[0], want, limits), "tol_cap": sgns.sgns_shared_cap(c.shape[0]),
            "calls": calls,
            "same_bits": all(_same_bits(a, b) for r in runs[1:] for a, b in zip(runs[0], r)),
            "got": runs[0], "want": want, "limits": limits, "plan": plan}


F32_ALS = ("als_partials", "als_partials_wide", "bucket_cg", "bucket_cg_wide")


def _k9s_case(rng, b: int, d: int, k: int, v: int, dev, one_word: bool = False) -> float:
    """K9s against its plain version in float64 on one batch (:func:`_hold_k9s`,
    two calls): repeated centers, a pool with repeated slots (or of one word)
    and a pool word that is also a context. Returns the worst error over its
    limit; inf where two calls differ in a bit."""
    in_t = torch.as_tensor(rng.uniform(-0.5 / d, 0.5 / d, size=(v, d)).astype(np.float32), device=dev)
    out_t = torch.as_tensor(rng.normal(scale=0.1, size=(v, d)).astype(np.float32), device=dev)
    c = rng.integers(0, v, size=b).astype(np.int32)
    c[: b // 3] = 1
    o = rng.integers(0, v, size=b).astype(np.int32)
    pool = np.full(k, 5, dtype=np.int32) if one_word else rng.integers(0, v, size=k).astype(np.int32)
    if not one_word:
        pool[: k // 2] = 3
        pool[-1] = o[0]
    args = [torch.as_tensor(a, device=dev) for a in (c, o, pool)]
    h = _hold_k9s(in_t, out_t, *args, 5 / k, calls=2)
    return h["over"] if h["same_bits"] else float("inf")


def phase_trainer_kernels() -> dict:
    """K1-bf16 and K3-bf16 at ranks 8-256 on bench-shaped buckets (all-padding
    slots, the 7624-entry power-law row), K1-bf16 rel 1e-4 as K1, K3-bf16 row
    by row (F9's limits); K9s at B 1, 7, 65536 x K 1, 32, 512 x d 8, 200,
    and pools of one word, against its plain version in float64 to
    ``ops.sgns.sgns_shared_limits`` element by element and on the loss (its
    cases' ``err`` is the worst error over the limit, ``tol`` 1), the same
    bits on a second call."""
    from albedo_tpu_torch.kernels import launch_counts, reset_launches

    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    worst: dict[str, float] = {}
    cases = []

    def note(name, label, err, tol):
        worst[name] = max(worst.get(name, 0.0), err / tol)
        cases.append({"kernel": name, "case": label, "err": err, "tol": tol})

    reset_launches()
    for k in (8, 50, 64, 65, 100, 256):
        for b, length, n_pad in ((64, 37, 8), (48, 400, 4), (3, 7624, 0)):
            for name, e in _als_case(rng, k, 19991, b, length, n_pad, dev, names=("als_partials", "bucket_cg"),
                                     gather_dtype="bfloat16").items():
                note(f"{name}_bf16", f"rank {k}, B {b}, L {length}", e, bf16_rel()[f"{name}_bf16"])
    for b in (1, 7, 65536):
        for k in (1, 32, 512):
            for d in (8, 200):
                v = 56182 if b == 65536 else 997  # the refscale vocabulary at the refscale batch
                note("sgns_shared", f"B {b}, K {k}, d {d}, V {v}", _k9s_case(rng, b, d, k, v, dev), 1.0)
    for b, k in ((7, 32), (65536, 512)):
        note("sgns_shared", f"B {b}, K {k}, d 200, a pool of one word", _k9s_case(rng, b, 200, k, 56182, dev, True),
             1.0)
    wide = _k3_bf16_wide_groups()
    note("bucket_cg_bf16_wide", "the rank-100 fit's groups (F9's row limits)", wide["held"]["over_limit"], 1.0)
    torch.cuda.synchronize()
    counts = {n: c for n, c in launch_counts().items() if c}
    ok = (all(w <= 1.0 for w in worst.values()) and _held_ok(wide["held"], REL_TOL)
          and all(counts.get(n, 0) > 0 for n in ("als_partials_bf16", "als_partials_bf16_wide", "bucket_cg_bf16",
                                                 "bucket_cg_bf16_wide", "sgns_shared"))
          and not any(counts.get(n, 0) for n in F32_ALS))
    emit({"phase": "trainer_kernels", "ok": ok, "worst_over_tol": worst, "launches": counts, "cases": cases,
          "bucket_cg_bf16_wide": wide})
    if not ok:
        raise SystemExit("chip_smoke: K1-bf16, K3-bf16 or K9s disagrees with its plain version (or never ran)")
    return {"bucket_cg_bf16_wide": wide["timed"]}


def _k3_bf16_wide_groups() -> dict:
    """K3-bf16's wide path at the rank-100 fit's 54 bucket groups (the
    ``train_als`` tables' groups at rank 100, tables from the shared numpy
    init: ``als_partials_bench.wide_data``), as ``_sweep_calls`` forms them
    with the fixed sides cast to bf16: each group row by row to F9's limits
    (``held``, :func:`_hold_groups`), each group's kernel ms (profiler
    sums), and the iteration's calls timed with the plain version and the
    bound; with K1-bf16 wide's bound at the same calls."""
    from albedo_tpu_torch.kernels.als_partials_bench import wide_data
    from albedo_tpu_torch.ops import als as ops_als

    data = wide_data(torch, torch.device("cuda"))
    other = {"users": "items", "items": "users"}
    yty = {side: ops_als.gramian(data[side]) for side in other}
    tables = {side: data[side].to(torch.bfloat16) for side in other}
    calls = [(tables[side], yty[side], idx, val, mask, data[other[side]][rows.clamp(min=0).long()].contiguous(),
              rows >= 0, mask.sum(dim=1, dtype=torch.float32)) for side, idx, val, mask, rows in data["calls"]]

    def run():
        return [ops_als.bucket_cg_body(*c[:6], REG, ALPHA, CG_STEPS, gather_dtype="bfloat16") for c in calls]

    def plain():
        return [ops_als.bucket_cg_reference(*c[:6], REG, ALPHA, CG_STEPS, "bfloat16") for c in calls]

    held = _hold_groups(calls, run, plain,
                        limits=lambda c: ops_als.bucket_cg_bf16_limits(*c[:6], REG, ALPHA, CG_STEPS, rows=c[6]))
    per_group = _per_group(calls, [(lambda c=c: ops_als.bucket_cg_body(*c[:6], REG, ALPHA, CG_STEPS,
                                                                       gather_dtype="bfloat16")) for c in calls])
    timed = _timed(dict(err=(held["max_abs_err"], held["rel_err"]), ms=cuda_ms(run), plain_ms=cuda_ms(plain),
                        library_ms=None, over=held["over_limit"], kernel_ms=per_group["kernel_ms"], **_k3_work(calls)))
    return {"held": {n: v for n, v in held.items() if n not in ("rel_by_group", "over_by_group")},
            "per_group": per_group, "timed": timed,
            "als_partials_bf16_wide_bound": _bound_ms(_k1_work(calls))}


def _bf16_calls(calls) -> list[tuple]:
    """``_sweep_calls`` with each half-sweep's source table cast to bf16
    once, as ``ops.als.half_sweep`` casts it."""
    tables = {}
    return [(tables.setdefault(id(c[0]), c[0].to(torch.bfloat16)), *c[1:]) for c in calls]


def _k1_bf16_library(src, idx, val, mask, a):
    """K1-bf16's yardstick: K1's (the gather, two batched products) on the
    bf16 rows widened to float32, with c1 rounded as the kernel rounds it."""
    gathered = src[idx.long()].float()
    c1 = a * val
    c1_b = c1.to(torch.bfloat16).float()
    corr = torch.bmm((gathered * c1_b[..., None]).transpose(1, 2), gathered)
    w = torch.where(mask, 1.0 + c1, torch.zeros_like(c1))
    return corr, torch.bmm(w[:, None, :], gathered)[:, 0]


def _implicit_loss_and_corr(model, ref, train) -> tuple[float, float, float]:
    """(objective of ``model``, of ``ref``, the correlation of their
    predictions over the training entries), on the card."""
    from albedo_tpu_torch.ops.als import implicit_loss

    dev = model.user_table.device
    rows, cols, vals = (torch.as_tensor(a, device=dev) for a in (train.rows, train.cols, train.vals))
    losses = [float(implicit_loss(m.user_table, m.item_table, rows, cols, vals, REG, ALPHA)) for m in (model, ref)]
    preds = [(m.user_table[rows.long()] * m.item_table[cols.long()]).sum(dim=1).double() for m in (model, ref)]
    corr = float(torch.corrcoef(torch.stack(preds))[0, 1])
    return losses[0], losses[1], corr


def phase_bench_bf16(bench: dict) -> dict:
    """Phase 7's bench protocol at bf16 gathers, both solvers: NDCG@30 in the
    JAX bf16 band, the JAX test's criteria against the float32 fit, the fit
    seconds beside float32, the launch counts (bf16 entries only), then
    K1-bf16 and K3-bf16 per iteration's calls against their plain versions,
    a library call and their bound."""
    from albedo_tpu_torch.evaluators import RankingEvaluator, UserItems
    from albedo_tpu_torch.kernels import launch_counts, reset_launches
    from albedo_tpu_torch.models.als import ImplicitALS
    from albedo_tpu_torch.ops import als as ops_als

    train, users, excl, actual = bench["train"], bench["users"], bench["excl"], bench["actual"]
    fits = {}
    for solver in ("cholesky", "cg"):
        est = ImplicitALS(rank=50, reg_param=REG, alpha=ALPHA, max_iter=26, seed=42, solver=solver,
                          cg_steps=CG_STEPS, init_factors=bench["init"], gather_dtype="bfloat16", device="cuda")
        reset_launches()
        model = est.fit(train)
        torch.cuda.synchronize()
        counts = {n: c for n, c in launch_counts().items() if c}
        _, idx = model.recommend(users, k=30, exclude_idx=excl)
        ndcg = RankingEvaluator(metric_name="ndcg@k", k=30).evaluate(
            UserItems(users=users, items=idx.astype(np.int32)), actual
        )
        f32_est, f32_model = bench["models"][solver]
        loss, loss_f32, corr = _implicit_loss_and_corr(model, f32_model, train)
        launched = (all(counts.get(n, 0) > 0 for n in BF16_ENTRIES[solver])
                    and not any(counts.get(n, 0) for n in F32_ALS))
        ok = (abs(ndcg - JAX_NDCG_BF16[solver]) <= NDCG_TOL[solver] and loss <= loss_f32 * BF16_LOSS_RATIO
              and corr > BF16_CORR and launched and est.last_fit_report["health"]["nonfinite"] == 0)
        emit({"phase": "bench_bf16", "solver": solver, "ok": ok, "ndcg": ndcg, "jax_ndcg": JAX_NDCG_BF16[solver],
              "tol": NDCG_TOL[solver], "fit_s": est.last_fit_report["device_s"],
              "compile_s": est.last_fit_report["compile_s"], "fit_s_f32": f32_est.last_fit_report["device_s"], "loss": loss, "loss_f32": loss_f32,
              "loss_ratio": loss / loss_f32, "max_loss_ratio": BF16_LOSS_RATIO, "corr": corr, "min_corr": BF16_CORR,
              "launches": counts, "gather_dtype": est.last_fit_report["gather_dtype"]})
        if not ok:
            raise SystemExit(f"chip_smoke: the bf16 bench fit ({solver}) left its band, failed the JAX "
                             "criteria or launched a float32 K1/K3")
        fits[solver] = (est, model, counts)

    est, model, _ = fits["cholesky"]
    calls = _bf16_calls(_sweep_calls(est, train, model))

    def k1(fn):
        return [fn(c[0], c[2], c[3], c[4], ALPHA, "bfloat16") for c in calls]

    def k3(fn):
        return [fn(*c[:6], REG, ALPHA, CG_STEPS, gather_dtype="bfloat16") for c in calls]

    def k3_plain(fn):
        return [fn(*c[:6], REG, ALPHA, CG_STEPS, "bfloat16") for c in calls]

    held = _hold_groups(calls, lambda: k3(ops_als.bucket_cg_body), lambda: k3_plain(ops_als.bucket_cg_reference),
                        limits=lambda c: ops_als.bucket_cg_bf16_limits(*c[:6], REG, ALPHA, CG_STEPS, rows=c[6]))
    res = {
        "als_partials_bf16": _worst(calls, k1(ops_als.bucket_partial_terms),
                                    k1(ops_als.bucket_partial_terms_reference)) + (
            cuda_ms(lambda: k1(ops_als.bucket_partial_terms)),
            cuda_ms(lambda: k1(ops_als.bucket_partial_terms_reference)),
            cuda_ms(lambda: [_k1_bf16_library(c[0], c[2], c[3], c[4], ALPHA) for c in calls]),
        ),
        "bucket_cg_bf16": (held["max_abs_err"], held["rel_err"]) + (
            cuda_ms(lambda: k3(ops_als.bucket_cg_body)),
            cuda_ms(lambda: k3_plain(ops_als.bucket_cg_reference)),
            None,
        ),
    }
    # The f32 bounds of phase 7 with 2 bytes per table element read.
    entries = sum(int(c[4].sum()) for c in calls)
    rows = sum(c[2].shape[0] for c in calls)
    work = {
        "als_partials_bf16": tuple(_k1_work(calls).values()),
        "bucket_cg_bf16": tuple(_k3_work(calls).values()),
    }
    out = {
        name: _timed(dict(err=(abs_err, rel), ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bytes=work[name][0], flops=work[name][1]))
        for name, (abs_err, rel, ms, plain_ms, lib_ms) in res.items()
    }
    # K3-bf16 row by row against its limit (F9), not against a fixed 5e-4.
    ok = (out["als_partials_bf16"]["rel_err"] <= bf16_rel()["als_partials_bf16"]
          and _held_ok(held, bf16_rel()["bucket_cg_bf16"]))
    per_group = {
        "als_partials_bf16": _per_group(calls, [
            (lambda c=c: ops_als.bucket_partial_terms(c[0], c[2], c[3], c[4], ALPHA, "bfloat16")) for c in calls]),
        "bucket_cg_bf16": _per_group(calls, [
            (lambda c=c: ops_als.bucket_cg_body(*c[:6], REG, ALPHA, CG_STEPS, gather_dtype="bfloat16"))
            for c in calls]),
    }
    emit({"phase": "bench_bf16_kernels", "ok": ok, "rel_tol": bf16_rel(), "groups": len(calls), "entries": entries, "rows": rows,
          "per_group": per_group, "held": {"bucket_cg_bf16": held}, "timed": out})
    if not ok:
        raise SystemExit("chip_smoke: K1-bf16 or K3-bf16 disagrees with its plain version at the bench shapes, or "
                         "K3-bf16 changes its bits between calls or leaves NaN outside the padding rows")
    launches = {"als_partials_bf16": fits["cholesky"][2].get("als_partials_bf16", 0),
                "bucket_cg_bf16": fits["cg"][2].get("bucket_cg_bf16", 0)}
    return {"timed": out, "launches": launches}


# ------------------------------------------------------------------ phase 13

FUSED_RUNS = 5  # fits of each kind per configuration, eager and graph in turns
FUSED_SPAN = "fit_loop.replays"  # ops.als.fit_loop's profiler span around its replays


@contextlib.contextmanager
def _eager_fits():
    """``ImplicitALS.fit`` through ``ops.als.fit_loop_reference``, the loop
    enqueued from Python, for the block."""
    from albedo_tpu_torch.models import als as models_als
    from albedo_tpu_torch.ops import als as ops_als

    graph = models_als.fit_loop

    def eager(*args, report=None, **kw):
        report.update(compile_s=0.0, compile_source=None)
        return ops_als.fit_loop_reference(*args, **kw)

    models_als.fit_loop = eager
    try:
        yield
    finally:
        models_als.fit_loop = graph


def _replay_busy(prof, span: str = FUSED_SPAN) -> dict:
    """The card's busy share over a graph fit's replays, from a
    ``torch.profiler`` trace: the union of the kernels' and copies'
    intervals that start after ``span`` opens on the host, over the
    window from the first one's start to the last one's end, and the eight
    largest sums of their time by name (``replay_top_ms``)."""
    events = prof.events()
    spans = [e.time_range.start for e in events if e.name == span and e.device_type != torch.autograd.DeviceType.CUDA]
    if not spans:
        return {"busy_share": None, "device_events": 0}
    work = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.name != span
                  and e.time_range.start >= spans[0])
    if not work:
        return {"busy_share": None, "device_events": 0}
    by_name: dict[str, float] = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name != span and e.time_range.start >= spans[0]:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    busy, end = 0.0, work[0][0]
    for a, b in work:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = end - work[0][0]
    return {"busy_share": busy / window if window > 0 else None, "window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "device_events": len(work), "replay_top_ms": [[name[:120], ms] for name, ms in top]}


def _fused_bound(est, matrix, model, solver: str) -> dict:
    """The least time of each part of one iteration's body at this fit's
    shapes (``_bound_ms``): K1 + K2 or K3 over both half-sweeps' groups, CG's
    warm-start gathers, K4's landings and the Gramians."""
    calls = _sweep_calls(est, matrix, model)
    k, rows, n = model.rank, sum(c[2].shape[0] for c in calls), matrix.n_users + matrix.n_items
    parts = {}
    if solver == "cg":
        parts["bucket_cg"] = _bound_ms(_k3_work(calls))[0]
        parts["warm_starts"] = _bound_ms({"bytes": rows * (4 + 8 * k), "flops": 0})[0]
    else:
        parts["als_partials"] = _bound_ms(_k1_work(calls))[0]
        parts["solve_corrected"] = _bound_ms({"bytes": 4 * rows * (k * (k + 1) // 2 + 2 * k + 1) + 4 * k * (k + 1) // 2,
                                              "flops": rows * (k ** 3 / 3 + 2 * k * k)})[0]
    parts["land_rows"] = _bound_ms({"bytes": n * (8 + 8 * k), "flops": 0})[0]
    parts["gramian"] = _bound_ms({"bytes": 4 * n * k + 8 * k * k, "flops": 2 * n * k * k})[0]
    return parts


def phase_fused_fit(bench: dict) -> dict:
    """K16, the fused fit (``ops.als.fit_loop``: an iteration captured as a
    CUDA graph and replayed) against the eager loop (``fit_loop_reference``)
    in one process: the bench fits by Cholesky and 3-step CG (rank 50, from
    phase 7's pinned init) and the rank-100 fits by both solvers (the
    ``train_als`` job's tables, the shared init), 26 iterations each, each
    fitted FUSED_RUNS times by each loop in turns through ``ImplicitALS.fit``.
    Each graph fit must equal the eager fit bit for bit and launch what it
    launches; emitted: ``device_s`` and ``compile_s`` of both, their medians,
    the card's busy share over the replays of one more graph fit
    (``torch.profiler``), and K16's record (ms a fit, the bound of its body
    times the iterations, launches a fit)."""
    from torch.profiler import ProfilerActivity, profile

    from albedo_tpu_torch import cli
    from albedo_tpu_torch.builders.jobs import ALS_ALPHA, ALS_REG, JobContext
    from albedo_tpu_torch.kernels import launch_counts, reset_launches
    from albedo_tpu_torch.models.als import ImplicitALS

    job = JobContext(cli.parse_args(["train_als"] + NOW)).matrix()
    wide = dict(rank=WIDE_RANK, reg_param=ALS_REG, alpha=ALS_ALPHA,
                init_factors=_shared_init(job.n_users, job.n_items, WIDE_RANK))
    bench_kw = dict(rank=50, reg_param=REG, alpha=ALPHA, cg_steps=CG_STEPS, init_factors=bench["init"])
    configs = (("bench cholesky", bench["train"], dict(bench_kw, solver="cholesky")),
               ("bench cg", bench["train"], dict(bench_kw, solver="cg")),
               ("rank-100 cholesky", job, dict(wide, solver="cholesky")),
               ("rank-100 cg", job, dict(wide, solver="cg")))
    records, ok = {}, True
    for name, matrix, kw in configs:
        est = ImplicitALS(max_iter=26, device="cuda", **kw)
        est.fit(matrix)  # the layout uploaded and every kernel warm before the timed fits
        runs = {"eager": [], "graph": []}
        same_bits, same_counts, counts = True, True, {}
        for _ in range(FUSED_RUNS):
            tables = {}
            for kind in ("eager", "graph"):
                reset_launches()
                with _eager_fits() if kind == "eager" else contextlib.nullcontext():
                    model = est.fit(matrix)
                torch.cuda.synchronize()
                counts[kind] = {n: c for n, c in launch_counts().items() if c}
                report = est.last_fit_report
                runs[kind].append((report["device_s"], report["compile_s"]))
                tables[kind] = (model.user_table, model.item_table)
            same_bits &= all(_same_bits(g, e) for g, e in zip(tables["graph"], tables["eager"]))
            same_counts &= counts["graph"] == counts["eager"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model = est.fit(matrix)
            torch.cuda.synchronize()
        busy = _replay_busy(prof)
        eager_s = [d for d, _ in runs["eager"]]
        graph_s = [d for d, _ in runs["graph"]]
        compile_s = [c for _, c in runs["graph"]]
        total_s = [d + c for d, c in runs["graph"]]
        parts = _fused_bound(est, matrix, model, kw["solver"])
        launches = sum(counts["graph"].values())
        rec = {"phase": "fused_fit", "config": name, "rank": kw["rank"], "solver": kw["solver"], "iterations": 26,
               "same_bits": same_bits, "same_launches": same_counts, "launches": counts["graph"],
               "device_s": graph_s, "compile_s": compile_s, "device_plus_compile_s": total_s,
               "eager_device_s": eager_s, "median_device_s": float(np.median(graph_s)),
               "median_compile_s": float(np.median(compile_s)), "median_total_s": float(np.median(total_s)),
               "median_eager_device_s": float(np.median(eager_s)),
               "total_within_eager": bool(np.median(total_s) <= np.median(eager_s)), **busy,
               "k16": {"ms": 1e3 * float(np.median(graph_s)), "plain_ms": 1e3 * float(np.median(eager_s)),
                       "bound_ms": 26 * sum(parts.values()), "bound_parts_ms": parts, "launches": launches}}
        rec["ok"] = same_bits and same_counts and launches > 0
        emit(rec)
        records[name] = rec
        ok &= rec["ok"]
    if not ok:
        raise SystemExit("chip_smoke: a graph fit differs from the eager loop in its bits or its launches")
    return records


# ------------------------------------------------------------------ phase 14

LOOP_RUNS = 3  # fits of each kind per configuration, eager and graph in turns
# K9's and K10's graph fits against the eager fits, where the kernels' atomics
# add in an order that changes from run to run: no graph fit may differ from
# an eager fit by more than LOOP_SPREAD times the most two eager fits differ
# by (tables, moments and per-epoch losses, each as its largest element's
# difference over that of the eager fit), and by nothing where the eager fits
# agree bit for bit. On an H100 the eager fits differ by 3.5e-6 to 3.6e-5
# and the graph fits by 0.85 to 1.9 times that; a graph that replays the
# first replay's Adam corrections, or its schedule, differs by 0.27 to 1.0,
# over 8000 times that (PERF.md, the fused loops' findings).
LOOP_SPREAD = 10.0


def _loop_fits() -> list[tuple[str, str, object]]:
    """The fused loops' configurations, each (name, kernel, run) where
    ``run(graph)`` fits once by the graph (``graph``) or the eager loop and
    returns its final tables, moments, per-epoch losses, report and
    generator: the ``train_word2vec --w2v-full`` fit (K9), the same corpus
    with 512 shared negatives (K9s), and the full ``ranking_mf`` fit (K10)
    with a drawn schedule and with one drawn here with numpy."""
    import dataclasses

    from albedo_tpu_torch import cli
    from albedo_tpu_torch.builders.jobs import JobContext, item_side_features
    from albedo_tpu_torch.datasets import random_split_by_user
    from albedo_tpu_torch.models.ranking_factorization import RankingFactorization

    dev = torch.device("cuda")
    ctx = JobContext(cli.parse_args(["train_word2vec", "--w2v-full"] + NOW))
    k9 = ctx.word2vec_estimator()
    plan = k9.plan(ctx.word2vec_corpus())

    def w2v(est):
        def run(graph: bool) -> dict:
            state, report = (est.train if graph else est.train_reference)(plan, dev)
            return {"tables": [state["tables"], *state["moments"]], "loss": report["epoch_loss"], "report": report,
                    "generator": state["generator"]}
        return run

    bctx = JobContext(cli.parse_args(["ranking_mf"] + NOW))
    matrix = bctx.matrix()
    train, _ = random_split_by_user(matrix, test_ratio=0.2, seed=42)
    side = item_side_features(bctx, matrix)
    mf = RankingFactorization(rank=32, epochs=10, batch_size=8192, device="cuda")  # ranking_mf_job's full size
    rng = np.random.default_rng(7)
    n_batches = max(1, train.nnz // mf.batch_size)
    injected = [(rng.permutation(train.nnz), rng.integers(0, train.n_items, size=(n_batches, mf.batch_size,
                                                                                  mf.negatives), dtype=np.int32))
                for _ in range(mf.epochs)]

    def bpr(schedule):
        def run(graph: bool) -> dict:
            model = (mf.fit if graph else mf.fit_reference)(train, item_side=side, schedule=schedule)
            st = mf.last_fit_state
            return {"tables": [st["params"], *st["moments"]], "loss": mf.last_fit_report["epoch_loss"],
                    "report": dict(mf.last_fit_report), "generator": st["generator"], "model": model}
        return run

    return [("train_word2vec --w2v-full", "K9", w2v(k9)),
            ("train_word2vec --w2v-full, 512 shared negatives", "K9s",
             w2v(dataclasses.replace(k9, shared_negatives=512))),
            ("ranking_mf, drawn schedule", "K10", bpr(None)),
            ("ranking_mf, injected schedule", "K10", bpr(injected))]


def _loop_bound(run, kernel: str) -> dict:
    """The least time of a fit's step kernels on its own inputs: one more
    eager fit with the step kernels' wrappers counting, call by call, the
    bytes and operations of K9 (K9s, K10) as ``_time_k9`` (``_k9s_at_state``,
    ``_time_bpr``) count them and Adam's (each element's p, g, m and v read
    and written), summed over the calls' bounds (``_bound_ms``)."""
    from albedo_tpu_torch.models import ranking_factorization as rf_mod
    from albedo_tpu_torch.models import word2vec as w2v_mod

    parts = {"step": [0.0, 0], "adam_dense": [0.0, 0]}
    by = {"bytes": 0.0, "operations": 0.0}  # the bound's ms by what bounds each call

    def add(part, work):
        ms, bound_by = _bound_ms(work)
        parts[part][0] += ms
        parts[part][1] += 1
        by[bound_by] += ms

    def k9(in_t, out_t, c, o, neg, *rest):
        d, (bs, k) = in_t.shape[1], neg.shape
        rows = int(torch.unique(c).numel()) + int(torch.unique(torch.cat([o, neg.reshape(-1)])).numel())
        add("step", {"bytes": 4 * d * 3 * rows + 4 * bs * (2 + k) + 8, "flops": bs * (1 + k) * (6 * d + 20)})
        return sgns_step(in_t, out_t, c, o, neg, *rest)

    def k9s(in_t, out_t, c, o, pool, *rest):
        d, bs, k = in_t.shape[1], c.shape[0], pool.shape[0]
        rows = int(torch.unique(c).numel()) + int(torch.unique(torch.cat([o, pool])).numel())
        add("step", {"bytes": 4 * d * 3 * rows + 4 * (2 * bs + k) + 8, "flops": bs * (1 + k) * (6 * d + 20)})
        return sgns_shared_step(in_t, out_t, c, o, pool, *rest)

    def k10(x, y, bias, w, g, users, pos, neg, *rest):
        (b, n), r, d = neg.shape, x.shape[1], g.shape[1]
        rows_x = int(torch.unique(users).numel())
        rows_y = int(torch.unique(torch.cat([pos, neg.reshape(-1)])).numel())
        add("step", {"bytes": 4 * (3 * r * (rows_x + rows_y) + (3 + d) * rows_y + b * (2 + n)),
                     "flops": b * (1 + n) * (2 * r + 2 * d) + b * n * (6 * r + 2 * d + 20)})
        return bpr_step(x, y, bias, w, g, users, pos, neg, *rest)

    def adam(p, *rest):
        add("adam_dense", {"bytes": 32 * p.numel(), "flops": 12 * p.numel()})
        return adam_dense(p, *rest)

    sgns_step, sgns_shared_step, bpr_step = w2v_mod.sgns_step, w2v_mod.sgns_shared_step, rf_mod.bpr_step
    adam_dense = w2v_mod.adam_dense
    names = [(w2v_mod, "sgns_step", k9), (w2v_mod, "sgns_shared_step", k9s), (rf_mod, "bpr_step", k10),
             (w2v_mod, "adam_dense", adam), (rf_mod, "adam_dense", adam)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in names]
    for mod, name, fn in names:
        setattr(mod, name, fn)
    try:
        run(False)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return {"bound_ms": parts["step"][0] + parts["adam_dense"][0],
            "bound_by": max(by, key=by.get), "bound_parts_ms": {f"{kernel} ({parts['step'][1]} calls)": parts["step"][0],
                                                               f"adam_dense ({parts['adam_dense'][1]} calls)":
                                                                   parts["adam_dense"][0]}}


def _loop_gap(a: dict, b: dict) -> float:
    """The largest difference of two fits' tables, moments and per-epoch
    losses, each over its largest element (0.0 where they agree bit for
    bit; inf where one is NaN and the other not)."""
    gap = 0.0
    for x, y in zip(a["tables"], b["tables"]):
        if not _same_bits(x, y):
            gap = max(gap, float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30))
    la, lb = np.asarray(a["loss"]), np.asarray(b["loss"])
    if not np.array_equal(la, lb):
        gap = max(gap, float(np.abs(la - lb).max() / max(np.abs(lb).max(), 1e-30)))
    return gap if np.isfinite(gap) else float("inf")


def phase_fused_loops() -> dict:
    """K17 and K18, the whole-loop programs (an epoch captured as a CUDA
    graph and replayed, ``utils.graphs.replay_loop``) against the eager
    loops in one process: each configuration of :func:`_loop_fits` fitted
    LOOP_RUNS times by each loop in turns after one warm-up fit of each,
    with the launch counts set to 0 before each fit and read after it. Each
    graph fit must launch what the eager fit launches and leave its
    generator where the eager fit leaves it (the next 8 draws equal); K9s's
    graph fits must equal its eager fits bit for bit, K9's and K10's differ
    from them by at most LOOP_SPREAD times the eager fits' own spread.
    Emitted: ``device_s`` and ``compile_s`` of both loops, their medians,
    the card's busy share over one more graph fit's replays
    (``torch.profiler``), and the records of K17 (the K9 fit) and K18 (the
    drawn ``ranking_mf`` fit): ms a fit (``device_s + compile_s``), the
    bound of its step kernels, launches a fit."""
    from torch.profiler import ProfilerActivity, profile

    from albedo_tpu_torch.kernels import launch_counts, reset_launches

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    records, ok = {}, True
    for name, kernel, run in _loop_fits():
        for graph in (False, True):
            run(graph)  # the kernels built, the data uploaded, every path warm
        fits = {"eager": [], "graph": []}
        counts, draws = {"eager": [], "graph": []}, {"eager": [], "graph": []}
        for _ in range(LOOP_RUNS):
            for kind in ("eager", "graph"):
                reset_launches()
                fit = run(kind == "graph")
                torch.cuda.synchronize()
                counts[kind].append({n: c for n, c in launch_counts().items() if c})
                draws[kind].append(torch.rand(8, generator=fit["generator"], device="cuda"))
                fits[kind].append(fit)
        eager_spread = max((_loop_gap(a, b) for i, a in enumerate(fits["eager"]) for b in fits["eager"][i + 1:]),
                           default=0.0)
        graph_gap = max(_loop_gap(g, e) for g in fits["graph"] for e in fits["eager"])
        same_bits = graph_gap == 0.0
        same_counts = all(c == counts["eager"][0] for c in counts["eager"] + counts["graph"])
        same_draws = all(torch.equal(d, draws["eager"][0]) for d in draws["eager"] + draws["graph"])
        finite = all(np.isfinite(f["loss"]).all() for f in fits["eager"] + fits["graph"])
        held = same_bits if kernel == "K9s" else graph_gap <= LOOP_SPREAD * eager_spread
        span = "word2vec.replays" if kernel.startswith("K9") else "bpr.replays"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(True)
            torch.cuda.synchronize()
        busy = _replay_busy(prof, span)
        eager_s = [f["report"]["device_s"] for f in fits["eager"]]
        graph_s = [f["report"]["device_s"] for f in fits["graph"]]
        compile_s = [f["report"]["compile_s"] for f in fits["graph"]]
        total_s = [d + c for d, c in zip(graph_s, compile_s)]
        bound = _loop_bound(run, kernel)
        launches = sum(counts["graph"][0].values())
        max_abs = max(float((g["tables"][0] - e["tables"][0]).abs().max())
                      for g, e in zip(fits["graph"], fits["eager"]))
        rec = {"phase": "fused_loops", "config": name, "kernel": kernel, "card": card,
               "epochs": len(fits["graph"][0]["loss"]), "steps": fits["graph"][0]["report"]["steps"],
               "same_bits": same_bits, "graph_gap": graph_gap, "eager_spread": eager_spread, "held": held,
               "same_launches": same_counts, "same_next_draw": same_draws, "finite": finite,
               "launches": counts["graph"][0], "device_s": graph_s, "compile_s": compile_s,
               "device_plus_compile_s": total_s, "eager_device_s": eager_s,
               "median_device_s": float(np.median(graph_s)), "median_compile_s": float(np.median(compile_s)),
               "median_total_s": float(np.median(total_s)), "median_eager_device_s": float(np.median(eager_s)),
               "epoch_loss": fits["graph"][0]["loss"], **busy,
               "record": {"ms": 1e3 * float(np.median(total_s)), "plain_ms": 1e3 * float(np.median(eager_s)),
                          "max_abs_err": max_abs, "library_ms": None, "launches": launches, **bound}}
        rec["ok"] = held and same_counts and same_draws and finite and launches > 0
        emit(rec)
        records[name] = rec
        ok &= rec["ok"]
        del fits
    if not ok:
        raise SystemExit("chip_smoke: a graph loop differs from the eager loop in its results, its launches "
                         "or its generator")
    return {"w2v_epoch": records["train_word2vec --w2v-full"]["record"],
            "bpr_fit": records["ranking_mf, drawn schedule"]["record"]}


def _refscale_corpus() -> list[list[str]]:
    """bench.py:740-751's Word2Vec corpus: 10 M tokens drawn Zipf(1.05) over
    60 000 words with numpy seed 42, cut into sentences of 15."""
    n_tok, vocab_size = 10_000_000, 60_000
    rng = np.random.default_rng(42)
    freq = 1.0 / np.arange(1, vocab_size + 1) ** 1.05
    freq /= freq.sum()
    toks = rng.choice(vocab_size, size=n_tok, p=freq)
    words = np.char.add("w", toks.astype(str))
    return [list(words[i:i + 15]) for i in range(0, n_tok, 15)]


def _k9s_at_state(est, plan, state) -> dict:
    """K9s at a batch of the fit's pairs and its final tables, held against
    its plain version in float64 over ten calls that must give the same
    bits (F8, :func:`_hold_k9s`), and timed with its plain version (the
    plain autograd step is also the library yardstick: gathers, cuBLAS
    products, autograd's scatter-adds) and with cuBLAS's ``torch.mm`` of the
    three products on rows gathered beforehand (a partial yardstick:
    ``mm_ms``), with the bytes and operations of its bound; and the check
    against faults planted in the kernel's result there
    (``kernels.spmm_sgns_bench.k9s_faults``: each must read above 1, so
    that the check refuses it)."""
    from albedo_tpu_torch.kernels.spmm_sgns_bench import k9s_faults
    from albedo_tpu_torch.ops import sgns

    tables = state["tables"]
    dev = tables.device
    v_size, d = tables.shape[1:]
    bs, k = min(est.batch_size, len(plan.centers)), est.shared_negatives
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    pool = torch.searchsorted(state["noise_cdf"], torch.rand((k,), generator=gen, device=dev))
    pool = pool.clamp_max_(v_size - 1).to(torch.int32)
    c = torch.as_tensor(plan.centers[:bs].astype(np.int32), device=dev)
    o = torch.as_tensor(plan.contexts[:bs].astype(np.int32), device=dev)
    scale = est.negatives / k
    ws = sgns.sgns_shared_workspace(bs, d, k, dev)
    held = _hold_k9s(tables[0], tables[1], c, o, pool, scale, ws, calls=10)
    faults = k9s_faults(tables[0], tables[1], c, o, pool, scale, held["got"], held["want"], held["limits"],
                        held["plan"])
    plain_grads = [w.float() for w in held["want"][:2]]
    del held["got"], held["want"], held["limits"]
    g, loss = torch.zeros_like(tables), torch.zeros(1, device=dev)
    plain_ms = cuda_ms(lambda: sgns.sgns_shared_step_reference(tables[0], tables[1], c, o, pool, g[0], g[1], loss,
                                                               scale))
    vc, vn = tables[0][c.long()], tables[1][pool.long()]
    gmat = torch.rand((bs, k), device=dev)
    mm_ms = cuda_ms(lambda: (torch.mm(vc, vn.T), torch.mm(gmat, vn), torch.mm(gmat.T, vc)))
    # Each row the batch touches read once ("in" rows of the centers, "out"
    # rows of the contexts and the pool), each of their gradient rows read
    # and written once; the three products' 2 B K d FLOP each, and the
    # positive term's, as K9 counts them (6 d + 20 a logit).
    rows = int(torch.unique(c).numel()) + int(torch.unique(torch.cat([o, pool])).numel())
    return {
        "sgns_shared": dict(
            err=held["err"], over=held["over"], faults=faults, tol_cap=held["tol_cap"], same_bits_calls=held["calls"],
            same_bits=held["same_bits"],
            ms=cuda_ms(lambda: sgns.sgns_shared_step(tables[0], tables[1], c, o, pool, g[0], g[1], loss, scale, ws)),
            plain_ms=plain_ms, library_ms=plain_ms, mm_ms=mm_ms,
            bytes=4 * d * 3 * rows + 4 * (2 * bs + k) + 8, flops=bs * (1 + k) * (6 * d + 20),
            shape={"B": bs, "d": int(d), "V": int(v_size), "K": k, "rows_touched": rows},
        ),
        "adam_dense": _adam_at(tables, torch.stack(plain_grads), state["moments"], state["count"] + 1,
                               est.learning_rate),
    }


def phase_w2v_refscale() -> dict:
    """The JAX bench's refscale Word2Vec record on the card: the corpus and
    estimator of bench.py:740-776 (shared negatives, K9s), a probe epoch to
    project the 30, then the fit with the counts set to 0 before and read
    after; wall-clock, epoch tokens/s, per-epoch loss (finite, falling),
    K9s and Adam at the fit's final state against their plain versions and
    bounds."""
    import dataclasses

    from albedo_tpu_torch.kernels import launch_counts, reset_launches
    from albedo_tpu_torch.models.word2vec import Word2Vec

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    sentences = _refscale_corpus()
    corpus_s = time.perf_counter() - t0
    est = Word2Vec(dim=200, window=5, min_count=10, max_iter=30, seed=42, batch_size=65536,
                   shared_negatives=512, device="cuda")
    t0 = time.perf_counter()
    plan = est.plan(sentences)
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dataclasses.replace(est, max_iter=1).train(plan, dev)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    epochs = est.max_iter if est.max_iter * probe_s <= W2V_REFSCALE_BUDGET_S else max(
        1, int(W2V_REFSCALE_BUDGET_S // probe_s))
    fit = dataclasses.replace(est, max_iter=epochs)
    reset_launches()
    t0 = time.perf_counter()
    state, report = fit.train(plan, dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = {n: c for n, c in launch_counts().items() if c}
    losses = report["epoch_loss"]
    n_tok = sum(len(s) for s in sentences)
    timed = {name: _timed(r) for name, r in _k9s_at_state(fit, plan, state).items()}
    falling = losses[min(2, len(losses) - 1)] < losses[0] if len(losses) > 1 else True
    ok = (bool(np.isfinite(losses).all()) and falling and counts.get("sgns_shared", 0) == report["steps"]
          and counts.get("adam_dense", 0) == report["steps"] and not counts.get("sgns_step", 0)
          and timed["sgns_shared"]["over"] <= 1.0 and timed["sgns_shared"]["same_bits"]
          and all(timed["sgns_shared"]["faults"][f] > 1.0 for f in ("dropped pair", "split left out", "tf32 operands"))
          and timed["adam_dense"]["rel_err"] <= RANKER_REL["adam_dense"])
    emit({"phase": "w2v_refscale", "ok": ok, "corpus_tokens": n_tok, "corpus_s": corpus_s, "plan_s": plan_s,
          "vocab": len(plan.vocab), "pairs": report["pairs"], "batch": report["batch"],
          "steps_per_epoch": report["steps"] // epochs, "probe_epoch_s": probe_s,
          "projected_30_epochs_s": est.max_iter * probe_s, "epochs": epochs, "epochs_cut": epochs < est.max_iter,
          "train_s": train_s, "fit_s": plan_s + train_s, "epoch_tokens_per_s": n_tok * epochs / (plan_s + train_s),
          "epoch_tokens_per_s_device_loop": n_tok * epochs / train_s, "ms_per_step": 1e3 * train_s / report["steps"],
          "epoch_loss": losses, "compile_s": report["compile_s"], "device_s": report["device_s"],
          "launches": counts, "timed": timed})
    if not ok:
        raise SystemExit("chip_smoke: the refscale Word2Vec fit was not finite or falling, skipped K9s, "
                         "a kernel disagrees with its plain version at its state, or F8's check passed a fault")
    return {"timed": timed, "launches": {"sgns_shared": counts.get("sgns_shared", 0)}}


def phase_w2v_quality() -> dict:
    """Shared-negative Word2Vec quality on the card: the JAX package's
    cluster test (tests/test_models.py:471, ``shared_negatives=32``) and the
    ``train_word2vec`` job's corpus with 512 shared negatives, whose
    final-epoch loss must lie in the JAX seed band."""
    from albedo_tpu_torch import cli
    from albedo_tpu_torch.builders.jobs import JobContext
    from albedo_tpu_torch.kernels import launch_counts, reset_launches
    from albedo_tpu_torch.models.word2vec import Word2Vec

    rng = np.random.default_rng(0)
    a = ["apple", "banana", "cherry", "grape"]
    b = ["python", "jax", "compiler", "kernel"]
    sentences = []
    for _ in range(500):
        pool = a if rng.random() < 0.5 else b
        sentences.append([pool[i] for i in rng.integers(0, 4, size=6)])
    reset_launches()
    model = Word2Vec(dim=16, window=3, min_count=1, max_iter=25, batch_size=512, subsample=0.0, seed=1,
                     shared_negatives=32, device="cuda").fit_corpus(sentences)
    cluster_launches = launch_counts()["sgns_shared"]
    v = model.vectors / (np.linalg.norm(model.vectors, axis=1, keepdims=True) + 1e-9)
    idx = {w: i for i, w in enumerate(model.vocab)}
    within = float(np.mean([v[idx[x]] @ v[idx[y]] for x in a for y in a if x != y]))
    across = float(np.mean([v[idx[x]] @ v[idx[y]] for x in a for y in b]))

    ctx = JobContext(cli.parse_args(["train_word2vec", "--w2v-full", "--now", "1600000000"]))
    est = ctx.word2vec_estimator()
    est.seed, est.shared_negatives = 42, 512
    reset_launches()
    t0 = time.perf_counter()
    est.fit_corpus(ctx.word2vec_corpus())
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    job_launches = launch_counts()["sgns_shared"]
    final = est.last_fit_report["epoch_loss"][-1]
    jax_mean = float(np.mean(JAX_W2V_SHARED_LOSS))
    band = 2 * (max(JAX_W2V_SHARED_LOSS) - min(JAX_W2V_SHARED_LOSS))
    ok = (within > 0.8 and across < 0.5 and cluster_launches > 0 and job_launches > 0
          and abs(final - jax_mean) <= band)
    emit({"phase": "w2v_quality", "ok": ok, "clusters": {"within": within, "across": across, "min_within": 0.8,
                                                         "max_across": 0.5, "launches": cluster_launches},
          "job_corpus": {"final_epoch_loss": final, "jax_mean": jax_mean, "band": band, "fit_s": fit_s,
                         "pairs": est.last_fit_report["pairs"], "epoch_loss": est.last_fit_report["epoch_loss"],
                         "compile_s": est.last_fit_report["compile_s"],
                         "device_s": est.last_fit_report["device_s"], "launches": job_launches}})
    if not ok:
        raise SystemExit("chip_smoke: shared-negative Word2Vec left the cluster test's or the JAX loss band")
    return {"sgns_shared": cluster_launches + job_launches}


def phase_lr_adam() -> dict:
    """``train_lr --w2v-full`` on the shared weights with the LR fitted by
    ``solver="adam"`` (300 steps, learning rate 0.05), the counts set to 0
    before and read after: its ``train_loss`` and AUC in the float32 band of
    the JAX value, a 10-step Adam fit of the same inputs within rel 1e-4 of
    JAX's, and the Adam fit's seconds and ms per step beside an L-BFGS fit
    of the same inputs."""
    import dataclasses

    from albedo_tpu_torch.models import logistic_regression as lr_mod

    fit = lr_mod.LogisticRegression.fit
    fitted = {}

    def adam_fit(self, fm, labels, sample_weight=None, _damped_retry=False):
        adam = dataclasses.replace(self, solver="adam", learning_rate=0.05)
        fitted["adam"] = fit(adam, fm, labels, sample_weight, _damped_retry)
        fitted["adam_10"] = fit(dataclasses.replace(adam, max_iter=10), fm, labels, sample_weight)
        fitted["lbfgs"] = fit(dataclasses.replace(self, solver="lbfgs"), fm, labels, sample_weight)
        return fitted["adam"]

    lr_mod.LogisticRegression.fit = adam_fit
    try:
        with _shared_weights():
            report, text = _run_cli(["train_lr", "--w2v-full", "--now", "1600000000"])
    finally:
        lr_mod.LogisticRegression.fit = fit
    adam, lbfgs = fitted["adam"], fitted["lbfgs"]
    got = {"auc": float(re.search(r"areaUnderROC = (\S+)", text).group(1)), "train_loss": adam.train_loss}
    gap = {n: got[n] - JAX_LR_ADAM[n] for n in got}
    rel_10 = abs(fitted["adam_10"].train_loss / JAX_LR_ADAM_10_LOSS - 1.0)
    counts = report["launches"]
    ok = (all(abs(gap[n]) <= LR_ADAM_BAND[n] for n in got) and rel_10 <= LR_ADAM_REL and adam.n_iter_run is None
          and all(counts[n] > 0 for n in ("segment_dot", "gather_sum", "adam_dense")))
    emit(dict(report, phase="lr_adam", ok=ok, **got, jax=JAX_LR_ADAM, gap=gap, band=LR_ADAM_BAND,
              loss_10_steps=fitted["adam_10"].train_loss, jax_loss_10_steps=JAX_LR_ADAM_10_LOSS,
              rel_10_steps=rel_10, tol_10_steps=LR_ADAM_REL,
              adam={"run_s": adam.run_s, "steps": 300, "ms_per_step": 1e3 * adam.run_s / 300},
              lbfgs={"run_s": lbfgs.run_s, "iterations": lbfgs.n_iter_run, "train_loss": lbfgs.train_loss,
                     "ms_per_iteration": 1e3 * lbfgs.run_s / max(lbfgs.n_iter_run, 1)}))
    if not ok:
        raise SystemExit("chip_smoke: the Adam-fitted ranker left the JAX band or skipped its kernels")
    return {"adam_dense": counts["adam_dense"]}


def _job_matrix():
    from albedo_tpu_torch import cli
    from albedo_tpu_torch.builders.jobs import JobContext

    return JobContext(cli.parse_args(["train_als"])).matrix()


def main() -> int:
    card = phase_device()
    phase_build()
    phase_kernels()
    phase_ranker_kernels()
    phase_candidate_kernels()
    phase_serving_kernels()
    phase_repair_kernels()
    any_size_timed = phase_any_size_kernels()
    phase_two_stage_kernels()
    trainer_timed = phase_trainer_kernels()
    launches = phase_job()
    ranker_launches, inputs = phase_ranker_job()
    ranker_timed = phase_ranker_timing(inputs)
    phase_cv_kernels(inputs["lr"])
    launches.update(ranker_launches)
    cand_launches, cand_calls = phase_candidates()
    cand_timed = phase_candidate_timing(cand_calls)
    launches.update({n: cand_launches[n] for n in cand_timed})
    options = phase_wide_options()
    launches.update(options["launches"])
    bench_timed, train, bench_model, bench_state = phase_bench()
    phase_candidate_bench(train)
    serve_state = phase_serve()
    bank_state = phase_bank(serve_state)
    serving_timed = phase_serving_timing(serve_state, bank_state, bench_model, train)
    launches.update(gather_topk=serve_state["launches"], bank_query=bank_state["launches"])
    wide = phase_wide_rank()
    two_stage = phase_two_stage()
    two_stage_timed = phase_two_stage_timing(two_stage, bench_model)
    cv = phase_cv(train)
    bf16 = phase_bench_bf16(bench_state)
    phase_fused_fit(bench_state)
    loops = phase_fused_loops()
    w2v = phase_w2v_refscale()
    phase_w2v_quality()
    phase_lr_adam()
    launches.update(**wide["launches"], **two_stage["launches"], **cv["launches"], **bf16["launches"],
                    **w2v["launches"])
    timed = dict(bench_timed, **ranker_timed, **cand_timed, **serving_timed, **wide["timed"], **two_stage_timed,
                 **cv["timed"], **bf16["timed"], **options["timed"], **any_size_timed, **trainer_timed,
                 sgns_shared=w2v["timed"]["sgns_shared"], **loops)
    launches.update({name: rec["launches"] for name, rec in loops.items()})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches.get(name, 0), "max_abs_err": timed[name]["max_abs_err"],
         "ms": timed[name]["ms"], "plain_ms": timed[name]["plain_ms"],
         "bound_ms": timed[name]["bound_ms"], "bound_by": timed[name]["bound_by"],
         "library_ms": timed[name]["library_ms"]}
        for name, (src, rep) in KERNELS.items()
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
