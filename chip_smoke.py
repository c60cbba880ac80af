"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `leann_tpu_torch`'s main paths through the entry points a user
calls (Vamana build -> fused graph search at D % 128 == 0; Vamana build
-> PQ graph search at 96-d; IVF build -> bf16 bucket search; the
residual-int8 IVF serving tier and the IVF-PQ tier at 10M x 96; the
row-gather roofline; the BERT encoder at bert-base widths and `entry()`;
pruned recompute, BASELINE config 3 at 100k passages; sharded search
over four shards of one card; the library surface, `Index` /
`open_index`, RAG ask and the ReAct agent; the CLI, `python -m
leann_tpu_torch`, and the HTTP and MCP servers; the native BM25 build
behind every index build; hybrid and filtered search through the HTTP
server over a flat index, BASELINE config 4 at 100k chunks), builds
the CUDA kernels from `leann_tpu_torch/csrc/` (one nvcc per source, all
started together, and g++ on `csrc/leann_native.cpp` beside them), and
holds each against its plain PyTorch version. Phases, one JSON line each
on stdout:

  env      torch / CUDA / nvcc versions, the card's name and power limit
  build    nvcc build of the kernel libraries and, in a thread beside
           it, g++ build of the native BM25 library (seconds of each)
  kernels  fused_beam_search (CUDA) vs fused_beam_search_plain on the
           card, exactly (ids, scores, visited log, and the counts of
           hops merged by the bitonic network because scores tied):
           N=4096, D=128, R=48, L=64, E in {1, 2}, l2 and ip, an odd
           batch with `exclude`, track_visited in {0, 160}; each row
           with the slow-merge share and CTAs per SM;
           pq_beam_search vs pq_beam_search_plain: N=4096, R=48, L=64,
           B=1023 with `exclude`, ksub 16 and 256, l2 and ip, E 1 and
           2, visited log 0 and 256, m=16 at D=96, m=64 at D=768, and a
           residual case (coarse_m=2, m=12, l2 norm columns); each row
           with CTAs per SM and the settle pass's queries and empty
           merges;
           ivf_bucket_dots and ivf8_bucket_scores vs their plain versions
           on small grids: D of 96, 128, 768 (16-byte copies) and 24 / 20
           (single elements), caps not multiples of 32, odd batches,
           empty (-1) slots, a probe list that repeats one bucket; l2
           and ip for ivf8; each row with a repeat (equal bits), the
           reuse (distinct buckets, queries per bucket), the work items
           and CTAs per SM;
           gather_score vs gather_score_plain: D of 96, 128, 64 (the
           staged kernel), 100 (4-byte) and 50 (single bytes: the per-row
           kernel), R of 48, 128, 7 and 200, odd batches, duplicate ids
           and the rows 0 and N-1, and row offsets past 2^31 bytes (17M x
           128 made on the card, B=64, R=48, ids N-1, 0 and rows above
           2^24); each row with the path taken and the launch plan
  rag      StreamingIndexBuilder over 20,000 fake-embedded 768-d
           passages (backend hnsw, R=32, L=64, ip), then
           IndexSearcher.search on 256 passage texts at complexity 64
           and 1024: self-hit@1 and recall@10 against the exact engine;
           StreamingIndexBuilder's BM25 build must take the native path
  native   the native host runtime, no kernel: Bm25Scorer.build (native)
           against the Python build on the rag phase's 20,000 texts and
           on recompute's 100,000 (arrays equal exactly, the two
           `.bm25.npz` files byte-equal, seconds of each build and save);
           IndexSearcher's in-memory build on a copy of the rag index
           without its sidecar (native, equal to the sidecar);
           scan_line_offsets on the rag passages JSONL equal to the
           sorted offsets of its offsets file
  sift     a 128-d l2 mixture corpus (1024 clusters, seed 0), Vamana
           R=48 L=80 alpha 1.2 wave 8192, graph saved and reloaded,
           FusedBeamEngine at beam 64: recall@10 on 1024 queries and
           device QPS at batch 2048 timed with CUDA events
  bench    `leann_tpu_torch.bench.run` (`python -m leann_tpu_torch.bench`,
           the root bench.py's counterpart) for flat, ivf, ivfpq, vamana
           and pq at bench.py's full shapes (1M x 128, B=2048, 1024
           recall queries, 2000 clusters, nprobe 8, R=48, L=80, beam 64)
           on the sift phase's pool and graph, 3 windows of 4 batches
           each: the JSON line of each (bench.py's four keys, unit qps,
           a positive value), a profile of one batch, recall@10 (flat
           1.000; ivf >= 0.95; vamana: the sift phase's ids, so its
           recall against the sift oracle; ivfpq and pq at their first
           card run less 0.02), B1 launched by vamana and B3
           by pq, flat_topk by every backend's two-stage oracle and by
           flat (never its PyTorch path), B4 and ivf_topc by ivf alone,
           no other kernel by any; then
           the pool and the graph
           written to the bench's artifact paths (where absent) and one
           `python -m leann_tpu_torch.bench` subprocess with no
           BENCH_BACKEND, which must pick vamana and print a line that
           parses
  deep     BASELINE config 2 (DEEP, 96-d l2) cut to 1M: a corpus of 16-d
           latent clusters plus 0.05 ambient noise (1024 clusters, seed
           0), Vamana R=48 L=80 alpha 1.2 wave 8192, graph saved and
           reloaded; GraphSearcher must pick PqBeamEngine by itself
           (m=16, ksub=256, bf16 rescore) and save the `.pq.npz`
           sidecar, which a second GraphSearcher loads without
           retraining; recall@10 on 1024 queries at beam 64 and
           DEEP_BEAM, beside the same graph's recall on exact f32
           scores; device QPS at batch 2048 and a torch.profiler
           breakdown of one batch at both beams
  ivf      BASELINE config 1 / bench.py's IVF config: the sift mixture
           at 1M x 128 l2, IvfEngine(n_clusters=2000), nprobe 8:
           recall@10 on 1024 queries of `search` (the device picks its
           path: `ivf_search` takes kernel B4, ivf_bucket_dots, then
           kernel ivf_topc), launching both kernels and counted once on
           `ivf_search.paths["kernel"]`; device QPS at batch 2048 by CUDA
           events, a profile of one window
  ivf8     BASELINE config 2 at its full scale: the same mixture at
           10M x 96 l2, k-means (two runs of its first iteration on a 1M
           slice must give the same bits), IvfInt8Engine(n_clusters=6324),
           nprobe 8: recall@10 on 1024 queries of `search` (on the card
           kernel ivf8_bucket_scores, which must launch) beside the
           torch scan `ivf8_search` (ShardedIvf8Index's, which must not
           launch it) on the engine's tables, device QPS of `search` at
           batches 512 and 2048, a profile of one window,
           calibrate_nprobe(0.95)
  gather   `evals.gather_roofline.run` at the reference's default shape:
           a 10M x 128 int8 corpus made on the card, B=2048, R=48, 50
           calls per window on distinct ids; the plain gather + product
           and kernel gather_score: rows/s, effective GB/s, the
           traversal-QPS ceiling, by the queued CUDA-event window and by
           the CUDA-graph timer; each held against the plain version on
           the window's first call; the staged kernel must be the one
           launched
  ivfpq    `evals/ivfpq_device_check.py`'s configuration on the ivf8
           phase's corpus, centers and assignment: IvfPqEngine(m=16,
           ksub=256, rescore="int8") at 10M x 96 l2, nprobe 16,
           rescore_factor 16: build seconds by step, bytes of codes, norms
           and the int8 corpus, recall@10 on 1024 queries, device QPS at
           batch 2048, a profile of one window, calibrate_nprobe(0.95);
           then IvfSearcher under LEANN_IVF_ENGINE=pq over the ivf phase's
           1M x 128 corpus and centers (it must pick IvfPqEngine with the
           f32 rescore): recall@10 at nprobe 8 beside the ivf phase's. No
           kernel may launch (the scan is plain PyTorch, as the
           reference's is XLA)
  rag_ivf  the rag phase's 20,000 passages built with backend "ivf" (ip)
           through StreamingIndexBuilder: the meta's calibrated nprobe,
           then IndexSearcher.search on 256 passage texts: self-hit@1 and
           recall@10 against exact at that nprobe; B4 and ivf_topc
           launch (IvfSearcher's scan on the card), no other kernel
  encode   BertEncoder(BertConfig()) at the published bert-base widths
           (768 hidden, 12 layers, 12 heads, 3072, vocab 30522) with
           seeded random weights and the hash tokenizer: the rag phase's
           20,000 texts through LocalEmbedding at batch 128 (texts/s, ms
           per batch by CUDA events), the bf16 run against the float32
           run on 256 texts, the bf16 product with a float32 result
           against the widened float32 product; the rag index built from
           these vectors (backend hnsw) and searched with 256 encoded
           passage texts: self-hit@1 and recall@10 beside the fake
           embedder's; then `entry()` on the card against its CPU run
  recompute
           BASELINE config 3 at `evals/recompute_scale.py`'s size:
           100,000 passages of its template embedded by bert-base
           (random weights, T=48) through LocalEmbedding at batch 512;
           StreamingIndexBuilder (hnsw, ip, R=32, L=48, two passes,
           is_recompute: the token sidecar) with build s split into
           graph / tokens / BM25 (beside the Python build's 3.9 s; native
           BM25 only);
           the stored-vector search (B1) on 256
           stored rows at beams 32 and 64; prune; GraphRecomputeSearcher
           at the same beams: recall@10 against the exact oracle on the
           stored vectors, wall s, device ms, QPS, hops, encoder rows per
           query, dedup hit rate, the encoder's device ms by CUDA events
           around each forward, a profile of one batch; dedup on / off
           and 8-hop segments / one pass on 16 queries; RecomputeSearcher
           (brute force) under a one-facet filter (~2.7k passages); bytes
           of the stored vectors against tokens + graph; peak memory. No
           kernel but B1 may launch
  sharded  `leann_tpu_torch.parallel` over SHARDS=4 shards of the sift
           phase's corpus (1M x 128 l2, its oracle) on a (1, 4) mesh of
           cuda:0: ShardedFlatIndex (recall@10, and a (2, 2) mesh's ids
           equal), ShardedGraphIndex with the auto engine, which must be
           `fused` (R=48 L=80 alpha 1.2 wave 8192 per shard: build and
           pack s, B1 launches in the builds and the search, recall@10
           at beam 64, device QPS per batch of 2048 by CUDA events beside
           the sift phase's, a profile), B3 on the same subgraphs,
           ShardedIvfIndex (500 clusters per shard) and ShardedIvf8Index
           at nprobe 8; then `load_searcher(sharded=True)` twice on the
           rag phase's index (one shard): the first load builds and
           writes `.shards.npz`, the second reuses it (no B1 launch, the
           same mtime) with ids and scores equal; self-hit@1; peak
           memory. B1 and B3 must launch, and B4 and ivf_topc in
           ShardedIvfIndex's search (its per-shard `ivf_search`), no
           other kernel
  api      the library surface on the rag phase's index:
           open_index(dir, device) (the fake 768-d provider rebuilt from
           the meta; the first search's seconds apart), Index.search one
           passage text per call (self-hit@1, host ms p50 / p99),
           Index.search_vectors on the 256 query vectors (recall@10 within
           0.002 of the rag phase's at complexity 64; ms per batch by
           CUDA events, through the library call and the engine alone), a
           filter (n<10000), auto hybrid on a word pair that only one
           passage holds (it ranks first), expansion (on_expand fires),
           AskSession on 8 passage texts (the passage is the first
           source) and ReActAgent (it finishes, its observation lists
           hit ids) with the simulated LLM; then 2,000 passages embedded
           by `local-tiny`, built (hnsw ip R=32 L=48, token sidecar),
           pruned and opened: Index.search must pick
           GraphRecomputeSearcher, self-hit@1 on 64 stored texts; per
           step seconds and peak memory. B1 must launch, no other kernel
  cli      the CLI and the servers on the rag phase's index, through
           `leann_tpu_torch.cli.main.main(argv)` with `--device cuda:0`
           in a temporary working directory and HOME: `build` of the
           rag texts written one per file (fake 768-d, default backend
           hnsw -> vamana, B1 in its waves; seconds beside the rag
           phase's), `search --format json` top-10 at complexity 64 one
           text per call on 32 texts against the CLI index (self-hit@1 on
           the text's own file) and against the rag index by its
           directory (ids equal to `Index.search`'s), host ms p50 / p99;
           one `python -m leann_tpu_torch --device cuda:0 search`
           subprocess (exit 0, ids equal to the in-process call's, the
           kernels' `_build/` unchanged: loaded, not rebuilt; wall s);
           `ask` (the first source is the asked passage) and `react`
           (its observation lists IndexSearcher's hits for the agent's
           query) with `--llm simulated`; `update` with 200 new files (16
           return their own passage first), `reindex --backend-name ivf
           --rebuild-bm25` (16 of 16; build, update and reindex each
           build BM25 once, natively), `prune -y` and 4 searches
           through the recompute path (4 of 4), `list`, `remove -y`,
           `config path`; then
           `ServerState` over `IndexSearcher.load(rag, device)` with
           max_batch 64 and a 2 ms window, as `serve_cmd.run` builds it:
           `warm()` (7), 256 `POST /search` of one rag text each from 32
           client threads of a client process (self-hit@1, flushes < 256,
           B1 launches <= flush groups; request ms p50 / p99, the flush
           sizes), one `queries` batch of 64 (ids equal to
           `IndexSearcher.search` on the same 64 vectors), GET /health
           /info /metrics; `McpServer(rag dir, device).handle` initialize,
           tools/list and a search (the passage first). B1 must launch,
           and B4 and ivf_topc (the reindexed ivf index), no other kernel
  hybrid   BASELINE config 4 (`evals/hybrid_latency.py`) through
           `leann_tpu_torch.evals.hybrid_latency` at 100,000 zipf-text
           chunks (cut from 1M): first the flat engine's stage-1 product
           on the card (`check_stage1`: bf16 operands into a float32
           result, the path taken, its top-c ids against the fp32
           product of the same operands on 20,000 x 128); then
           `build_index` (flat ip, fake 128-d; seconds by step),
           `IndexSearcher` (an ExactEngine on the card) and
           `serve_windows` at windows 0 / 2 / 8 ms: 32 client threads,
           a 1 s warm drive and a 3 s timed drive each (cut from 20 s),
           the reference's rows and the flush counts; no error, every mix
           served; 16 requests of each mix posted one at a time equal to
           in-process `IndexSearcher.search`, every filtered hit's source
           ends in .py, self-hit@1 on 64 passage texts. The flat path
           launches flat_topk (the stage-1 top-c) and no other kernel,
           and no flat_topk call takes its PyTorch path; the drive's
           flat_topk calls counted by (rows, c)
  kernels_main
           each kernel vs its plain version at every shape the main
           paths launched it with: fused_beam_search at rag build (D=768,
           R=32, ip, L=64, visited log 128), rag search at L=64 and
           L=1024, `api search B1 L64` (one rag query padded with qb-1
           zero rows, as search_device pads the api phase's one-query
           calls), `serve flush B<n> L64` (the flush size the cli
           phase's HTTP traffic produced most often, its rag queries
           padded with zero rows to a multiple of qb, as search_device
           pads a flush), sift build (1M, L=80, visited log 160), sift search
           (1M, B=2048), the recompute cases and `sharded search shard 0`
           (250k nodes, B=2048, L=64); pq_beam_search at deep search (1M,
           B=2048, beam 64 and DEEP_BEAM), `sharded pq search shard 0`
           and `bench pq search L64` (the bench's pq engine: 1M x 128,
           m=16, ksub=256, its probe batch of 2048); ivf_bucket_dots at the
           ivf phase's search
           (B=2048, nprobe 8) and ivf8_bucket_scores at the ivf8 phase's
           (B=512 and 2048, and a hot case: B=2048 with every query
           probing the 8 most-probed buckets); gather_score at the
           gather phase's (10M x 128, B=2048, R=48, distinct ids per
           call; its row also carries what `gather_timers` took right
           after the gather phase, outside any phase's count: the kernel
           by the graph timer, its own time by torch.profiler, the
           queued window traced into kernel time and idle gap per call,
           the SM and memory clocks around them);
           flat_topk at the flat benchmark cell's query chunk (256 x
           1,048,576 stage-1 dots of the sift corpus, l2, c = 80) and at
           the hybrid phase's serving flushes (the drive's own operands,
           ip over 131,072 columns, at its most frequent call of more
           than one row and its most frequent one-row call), each held
           to `topk_stable`'s ids
           exactly, beside the PyTorch path (scale, bias, torch.topk)
           and its admitted keys a row; ivf_topc at the IVF benchmark
           cell's batch (the ivf phase's engine and a batch of 2048, B4's
           dots at nprobe 8, cap 650, C = 40), ids and score bits equal
           to its plain version, beside the plain version's time and
           `topk_stable` alone over the [2048, 5200] scores (`library_ms`);
           each timed beside
           its bound, the bucket kernels also beside torch.bmm over
           buckets gathered beforehand, gather_score beside `corpus[ids]`
           + torch.bmm in bf16, both inside the timed window

The counts of kernel launches are set to 0 just before each main-path
phase (rag, native, sift, bench, deep, ivf, ivf8, gather, ivfpq, rag_ivf,
encode, recompute, sharded, api, cli, hybrid) and read just after it. Any failure exits
non-zero with no `ok` line. The last lines are the kernel table, the
card's `nvidia-smi` name and power limit, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores

# Fake embeddings are i.i.d. uniform on the 768-d sphere: no text is
# nearer any other than chance, the hardest case for a graph index. At
# the CLI's default complexity 64 recall@10 is ~0.68 (the JAX reference
# reaches the same on this corpus); the phase holds that operating point
# to 0.66 and searches again at 1024, the smallest power of two that
# clears 0.95 on this corpus.
RAG_COMPLEXITY = 1024
RAG_MIN_RECALL_64 = 0.66
RAG_N = 20_000        # BASELINE config 0: a 20k-chunk 768-d corpus
SIFT_N = 1_000_000    # bench.py / BASELINE config 1: SIFT-1M scale
# the bench phase's windows: BENCH_M=4 batches a window, BENCH_REPS=3
BENCH_ENV = {"BENCH_M": "4", "BENCH_REPS": "3"}
# the first card run's recall@10 less 0.02 (PERF.md §2): ivfpq (the ADC
# top-C at nprobe 8) and pq (the PQ kernel's bf16 score ties, ROADMAP
# Queue C) at bench.py's 1M x 128
BENCH_IVFPQ_MIN_RECALL = 0.853   # 0.8738 on the first card run
BENCH_PQ_MIN_RECALL = 0.162      # 0.1829
# BASELINE config 2 is DEEP-10M (96-d); cut to 1M for the build's time
DEEP_N = 1_000_000
# No beam of 96 / 128 / 192 / 256 cleared recall@10 0.95 on the deep
# corpus on the first card run (0.6918 / 0.7482 / 0.8450 / 0.8899; 0.5636
# at 64). The phase searches at the largest and holds both beams to the
# measured values less 0.02 (PERF.md, ROADMAP Queue C).
DEEP_BEAM = 256
DEEP_MIN_RECALL = 0.87
DEEP_MIN_RECALL_64 = 0.54
IVF_N = 1_000_000     # BASELINE config 1 / bench.py's IVF config
IVF_CLUSTERS = 2000
IVF8_N = 10_000_000   # BASELINE config 2 at full scale: DEEP-10M, 96-d
IVF8_CLUSTERS = 6324  # 2 * sqrt(N), the engine's default
NPROBE = 8
IVF_MIN_RECALL = 0.95
IVF8_MIN_RECALL = 0.924  # the first card run (0.9444) less 0.02
RAG_IVF_MIN_RECALL = 0.9
GATHER_N = 10_000_000  # the roofline's default corpus: 10M x 128 int8
GATHER_BIG_N = 17_000_000  # x 128 bytes: row offsets past 2^31
IVFPQ_NPROBE = 16      # evals/ivfpq_device_check.py's defaults
IVFPQ_RESCORE_FACTOR = 16
# the first card run's recall@10 less 0.02: 0.8720 at 10M x 96 (nprobe 16,
# the ADC top-160 is the loss) and 0.8810 through IvfSearcher at 1M x 128
IVFPQ_MIN_RECALL = 0.852
IVFPQ_1M_MIN_RECALL = 0.861
# the rag index on the encoder's vectors: the first card run gave self-hit@1
# 1.0 and recall@10 0.9992 at complexity 1024
ENCODE_MIN_HIT1 = 0.99
ENCODE_MIN_RECALL = 0.979
# BASELINE config 3 (pruned recompute) at its eval's default size
# (`evals/recompute_scale.py:31-58`): 100k passages (1M cut for the
# smoke's time), bert-base at T=48, R=32, L=48, two passes, 256 queries,
# beams 32 and 64, visited pool 128. Config 3's bar is recall@10 0.95;
# the first card run gave 0.8926 / 0.9266 at beams 32 / 64, with the
# stored-vector search on the same graph at 0.9176 / 0.9309: the graph
# and the random encoder's nearly tied neighbourhoods set the level, not
# the recompute. The phase holds the better beam to that run less 0.02.
RECOMPUTE_N = 100_000
RECOMPUTE_T = 48
RECOMPUTE_BEAMS = (32, 64)
RECOMPUTE_MIN_RECALL = 0.906
# the largest |recompute score - <q, stored vector>| over the ids that
# the timed searches return: the traversal re-embeds at T=48 what was
# stored at its length bucket (16). The first card run of the check gave
# 4.8e-7 (4 float32 ulps at 1.0, PERF.md); the limit is 4x that
RECOMPUTE_SCORE_TOL = 2e-6
# the build's `build.bm25` span when BM25 was built in Python (the build
# and the compressed save; PERF.md §5, one H100 at 700 W): the native
# build's yardstick
RECOMPUTE_BM25_S_PYTHON = 3.9

# sharded search (`parallel/sharded.py`): the sift phase's corpus over a
# (1, 4) mesh of one card, the sift graph settings per shard, IVF with the
# ivf phase's 2,000 clusters split over the shards. The first card run
# gave recall@10 0.9999 (fused), 0.4740 (pq on the same subgraphs: the
# PQ kernel's bf16 score ties, ROADMAP Queue C), 0.9341 (ivf: each shard
# keeps only its bf16 top-k, with no overfetch before the f32 rescore, as
# the reference does; a 10x overfetch gives 0.998 on a CPU analogue) and
# 0.9418 (ivf8). pq and ivf are held to that run less 0.02 (PERF.md §2).
SHARDS = 4
SHARDED_N = SIFT_N
SHARDED_FLAT_MIN_RECALL = 0.999   # ties only
SHARDED_MIN_RECALL = 0.95         # fused graph: the sift limit
SHARDED_IVF_MIN_RECALL = 0.914
SHARDED_IVF8_MIN_RECALL = IVF8_MIN_RECALL
SHARDED_PQ_MIN_RECALL = 0.454

FUSED = dict(
    name="fused_beam_search",
    route="cuda",
    source="leann_tpu_torch/csrc/fused_beam.cu",
    replaces="leann_tpu/ops/fused_beam.py:269",
)
PQ = dict(
    name="pq_beam_search",
    route="cuda",
    source="leann_tpu_torch/csrc/pq_beam.cu",
    replaces="leann_tpu/ops/pq_beam.py:180",
)
DOTS = dict(
    name="ivf_bucket_dots",
    route="cuda",
    source="leann_tpu_torch/csrc/ivf_bucket_dots.cu",
    replaces="leann_tpu/ops/pallas_kernels.py:92",
)
IVF8 = dict(
    name="ivf8_bucket_scores",
    route="cuda",
    source="leann_tpu_torch/csrc/ivf8_scan.cu",
    replaces="leann_tpu/ops/pallas_kernels.py:167",
)
GATHER = dict(
    name="gather_score",
    route="cuda",
    source="leann_tpu_torch/csrc/gather_score.cu",
    replaces="leann_tpu/ops/gather_score.py:48",
)
FLAT = dict(
    name="flat_topk",
    route="cuda",
    source="leann_tpu_torch/csrc/flat_topk.cu",
    replaces="none (jax.lax.approx_max_k in leann_tpu/ops/distance.py:244)",
)
TOPC = dict(
    name="ivf_topc",
    route="cuda",
    source="leann_tpu_torch/csrc/ivf_topc.cu",
    replaces="none (jax.lax.top_k in leann_tpu/ops/pallas_kernels.py:299 "
             "and leann_tpu/ops/ivf.py:457)",
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_lowdim(rng, rows, d, k, clusters, ambient=0.05):
    """Clusters + unit within-cluster noise confined to a random K-dim
    subspace of R^d, plus small full-rank ambient noise (the generator of
    evals/pq_lowdim_sim.py: descriptor corpora such as DEEP sit near
    low-dimensional manifolds, which is what lets 8-bit PQ navigate)."""
    basis, _ = np.linalg.qr(rng.standard_normal((d, k)))
    centers = 4.0 * rng.standard_normal((clusters, k))
    assign = rng.integers(0, clusters, rows)
    lat = centers[assign] + rng.standard_normal((rows, k))
    x = lat @ basis.T + ambient * rng.standard_normal((rows, d))
    return np.ascontiguousarray(x, dtype=np.float32)


def make_corpus(rng, n, d, clusters=1024):
    """bench.py's mixture (`leann_tpu_torch/evals/corpus_cache.py`)."""
    from leann_tpu_torch.evals.corpus_cache import make_corpus

    return make_corpus(rng, n, d, clusters)


def noisy_rows(corpus, shape, seed):
    """[*shape, D] device-ready queries: corpus rows plus unit noise."""
    g = np.random.default_rng(seed)
    m = int(np.prod(shape))
    x = corpus[g.integers(0, len(corpus), m)] + g.standard_normal(
        (m, corpus.shape[1])).astype(np.float32)
    return x.reshape(*shape, corpus.shape[1])


class env_var:
    """Set one environment variable inside a with-block (None unsets)."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.pop(self.name, None)
        if self.value is not None:
            os.environ[self.name] = self.value

    def __exit__(self, *exc):
        os.environ.pop(self.name, None)
        if self.old is not None:
            os.environ[self.name] = self.old


def recall_at(idx, oracle, k=10):
    return float(np.mean([
        len(set(a[:k].tolist()) & set(b[:k].tolist())) / k
        for a, b in zip(np.asarray(idx), np.asarray(oracle))
    ]))


def cuda_ms(fn, reps):
    """(mean device milliseconds of fn() over reps by CUDA events, the
    last call's result)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


# substrings of the cuBLAS / CUTLASS matrix-product kernels' names
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")


def profile(torch, fn, top=6, cpu=True):
    """Device time of one fn() by torch.profiler: busy ms (the sum of
    the kernels' own device time), wall ms of the profiled call ending in
    a synchronize (profiling adds host overhead, so the idle share is an
    upper bound), the matrix products' ms (`GEMM_NAMES`) and the `top`
    kernels by device ms. `cpu=False` records the device's activity
    alone: for a call of ~10^5 host ops, summing the host events takes
    tens of seconds and none of them is read here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:   # kernels and copies
            key = ev.key[:60]
            ms[key] = ms.get(key, 0.0) + ev.device_time_total / 1e3
    busy = sum(ms.values())
    gemm = sum(v for k, v in ms.items()
               if any(w in k.lower() for w in GEMM_NAMES))
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy / wall_ms), "gemm_ms": gemm,
            "kernels_ms": dict(sorted(ms.items(), key=lambda kv: -kv[1])[:top])}


def bm25_builds():
    """(native, python): the BM25 builds counted so far in METRICS by
    `Bm25Scorer.build`."""
    from leann_tpu_torch.utils import METRICS

    snap = METRICS.snapshot()
    return tuple(int(snap.get(f"bm25.build.{k}", {}).get("value", 0))
                 for k in ("native", "python"))


def bm25_since(before):
    """{"native": n, "python": p}: the BM25 builds since `before` (what
    `bm25_builds()` returned then)."""
    return dict(zip(("native", "python"),
                    (a - b for a, b in zip(bm25_builds(), before))))


def bm25_equal(a, b):
    """{array: equal exactly, dtype included} for two Bm25Scorers."""
    return {k: bool(getattr(a, k).dtype == getattr(b, k).dtype
                    and np.array_equal(getattr(a, k), getattr(b, k)))
            for k in ("vocab", "offsets", "post_docs", "post_tfs",
                      "doc_lengths")}


def check_bm25(phase, builds):
    """Raise unless the phase built BM25 and every build was native."""
    if builds["native"] <= 0 or builds["python"] != 0:
        raise AssertionError(f"{phase}: BM25 builds {builds}, not all "
                             "native")


def smi(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------- kernel vs plain version


def kernel_bound(kw):
    """(bound ms, "bytes" or "operations", active expansions) of one
    fused_beam_search call. Counts what this call's data needs: each
    expanded record's R live lanes read once (R*D int8 + ids, scales and
    |v|^2, 3*R*4 bytes), queries, seeds and exclude read once, beam ids +
    scores and the visited log written once; 2*R*D fp32 operations per
    expansion. The expansions are counted by rerunning the kernel with a
    visited log long enough for every hop."""
    from leann_tpu_torch.ops import fused_beam as fb

    e = kw["expansions"]
    vlog = fb.fused_beam_search(
        **dict(kw, track_visited=kw["max_iters"] * e))[2]
    expansions = int((vlog != kw["blocks_i8"].shape[0] - 1).sum())
    b, d = kw["queries"].shape
    r, s = kw["r"], kw["seed_ids"].shape[1]
    vt = -(-kw["track_visited"] // 128) * 128
    bytes_ = (expansions * (r * d + 3 * r * 4) + b * (d * 4 + s * 8 + 4)
              + b * (kw["beam_width"] * 8 + vt * 4))
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = 2 * expansions * r * d / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", expansions)


def check_case(torch, label, kw, reps):
    """One kernel-vs-plain comparison on the card, with the kernel's and
    the plain version's device ms (the plain version counting its slow
    merges) and the bound. Raises unless ids, scores and the visited log
    are equal exactly
    and the kernel's slow merges (hops merged by the bitonic network
    because scores tied) and active hops equal the plain version's
    counts."""
    from leann_tpu_torch.ops import fused_beam as fb

    got = fb.fused_beam_search(**kw, merge_stats=True)
    plain_ms, ref = cuda_ms(
        lambda: fb.fused_beam_search_plain(**kw, merge_stats=True), 1)
    equal = len(got) == len(ref) and all(
        bool(torch.equal(a, r)) for a, r in zip(got, ref))
    same = got[0] == ref[0]
    both = same & torch.isfinite(ref[1])
    err = float((got[1] - ref[1]).abs()[both].max()) if bool(both.any()) else 0.0
    vlog_eq = (float((got[2] == ref[2]).float().mean())
               if kw["track_visited"] else 1.0)
    slow, hops = (int(t.sum()) for t in got[-2:])
    ms, _ = cuda_ms(lambda: fb.fused_beam_search(**kw), reps)
    bound_ms, bound_by, expansions = kernel_bound(kw)
    b, d = kw["queries"].shape
    row = {"case": label, "b": b, "d": d, "r": kw["r"],
           "l": kw["beam_width"], "e": kw["expansions"],
           "metric": kw["metric"], "track_visited": kw["track_visited"],
           "n": kw["blocks_i8"].shape[0] - 1,
           "ids_equal": float(same.float().mean()), "all_equal": equal,
           "max_abs_err": err, "vlog_equal": vlog_eq, "ms": ms,
           "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "expansions": expansions, "hops": hops, "slow_merges": slow,
           "slow_merge_share": slow / max(1, hops),
           "ctas_per_sm": fb.ctas_per_sm(
               d, kw["r"], kw["beam_width"], kw["expansions"],
               kw.get("ring_size", 1024), kw["track_visited"])}
    if not equal:
        raise AssertionError(f"fused_beam_search disagrees with its plain "
                             f"version: {json.dumps(row)}")
    return row


def pq_bound(kw):
    """(bound ms, "bytes" or "operations", expansions, active hops per
    query) of one pq_beam_search call. Counts what this call's data
    needs: each expanded record's R id lanes and its m*lps code words read
    once (4 bytes each), the LUTs, seeds and exclude read once, beam ids +
    scores and the visited log written once; R*m fp32 adds per expansion.
    The expansions are counted by rerunning the kernel with a visited log
    long enough for every hop (it then never wraps); a hop is active when
    its first slot holds a node."""
    from leann_tpu_torch.ops import pq_beam as pb

    e = kw["expansions"]
    vlog = pb.pq_beam_search(
        **dict(kw, track_visited=kw["max_iters"] * e))[2]
    expansions = int((vlog != kw["records"].shape[0] - 1).sum())
    hops = (vlog[:, : kw["max_iters"] * e : e]
            != kw["records"].shape[0] - 1).sum(1)
    b, mk = kw["luts"].shape
    r, m, s = kw["r"], kw["m"], kw["seed_ids"].shape[1]
    lps = r // (32 // kw["bits"])
    vt = -(-kw["track_visited"] // 128) * 128
    bytes_ = (expansions * (r + m * lps) * 4 + b * (mk * 4 + s * 8 + 4)
              + b * (kw["beam_width"] * 8 + vt * 4))
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = expansions * r * m / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", expansions, hops)


def check_case_pq(torch, label, kw, reps):
    """pq_beam_search vs pq_beam_search_plain on the card: ids, scores
    and visited log equal exactly (the plain version reproduces the
    kernel's roundings and query groups), with both device ms, the bound,
    CTAs per SM and the settle pass's work (queries whose group stayed
    active after they converged and whose beam holds a tie, and the empty
    merges they take). Raises on any difference of the kernel."""
    from leann_tpu_torch.ops import pq_beam as pb

    got = pb.pq_beam_search(**kw)
    plain_ms, ref = cuda_ms(lambda: pb.pq_beam_search_plain(**kw), 1)
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
    same = got[0] == ref[0]
    both = same & torch.isfinite(ref[1])
    err = float((got[1] - ref[1]).abs()[both].max()) if bool(both.any()) else 0.0
    ms, _ = cuda_ms(lambda: pb.pq_beam_search(**kw), reps)
    bound_ms, bound_by, expansions, hops = pq_bound(kw)
    b, mk = kw["luts"].shape
    sc = got[1]
    live = torch.isfinite(sc[:, 1:]) & torch.isfinite(sc[:, :-1])
    ties = (sc[:, 1:] == sc[:, :-1]) & live
    tie_share = float(ties.sum() / max(1, int(live.sum())))
    qb = kw["qb"]
    group = torch.cat([hops, hops.new_zeros(-b % qb)]).reshape(-1, qb)
    idle = group.amax(1).repeat_interleave(qb)[:b] - hops
    settled = (idle > 0) & ties.any(1)
    row = {"case": label, "b": b, "r": kw["r"], "m": kw["m"],
           "ksub": kw["ksub"], "l": kw["beam_width"], "e": kw["expansions"],
           "track_visited": kw["track_visited"], "qb": kw["qb"],
           "n": kw["records"].shape[0] - 1,
           "ids_equal": float(same.float().mean()), "all_equal": all(equal),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "expansions": expansions, "beam_tie_share": tie_share,
           "settle_queries": int(settled.sum()),
           "settle_empty_merges": int(idle[settled].sum()),
           "ctas_per_sm": pb.ctas_per_sm(
               kw["m"], kw["ksub"], kw["records"].shape[1],
               kw["beam_width"], kw["expansions"], kw["ring_size"],
               kw["track_visited"])}
    if not all(equal) or len(got) != len(ref):
        raise AssertionError(f"pq_beam_search disagrees with its plain "
                             f"version: {json.dumps(row)}")
    return row


def max_row_norm(kind, tables, chunk=256):
    """Largest row norm of a bucket table, in bucket chunks: the bf16 row
    (dots) or |centroid| + scale * |r8| (ivf8), the magnitude each
    score's float32 sum is taken over."""
    out = 0.0
    if kind == "dots":
        (vecs,) = tables
        for s in range(0, vecs.shape[0], chunk):
            out = max(out, float(vecs[s : s + chunk].float().norm(dim=2).max()))
        return out
    pay, scale, cent = tables
    for s in range(0, pay.shape[0], chunk):
        r = (cent[s : s + chunk].norm(dim=1)[:, None]
             + scale[s : s + chunk] * pay[s : s + chunk].float().norm(dim=2))
        out = max(out, float(r.max()))
    return out


def bucket_bound(kind, probe, cap, d):
    """(bound ms, "bytes" or "operations") of one bucket-kernel call on
    this call's probes: each probed bucket read once (dots: cap*D bf16;
    ivf8: cap*D int8 + scale, nsq and ids, 12*cap, + the centroid, 4*D),
    queries and probes read once, the [B, P, cap] f32 output written
    once; 2*cap*D fp32 operations per (query, probe)."""
    import torch

    b, p = probe.shape
    uniq = int(torch.unique(probe).numel())
    per = cap * d * 2 if kind == "dots" else cap * d + 12 * cap + 4 * d
    bytes_ = uniq * per + b * d * 4 + b * p * 4 + b * p * cap * 4
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = 2 * b * p * cap * d / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bucket_reuse(torch, probe, n_buckets, d):
    """How the probes share buckets: distinct buckets, pairs per probed
    bucket (mean, max), and the work items the bucket-major kernels run
    (items with pairs)."""
    from leann_tpu_torch.ops import bucket_kernels as bk

    flat = probe.reshape(-1).long()
    counts = torch.bincount(flat[(flat >= 0) & (flat < n_buckets)],
                            minlength=n_buckets)
    distinct = int((counts > 0).sum())
    items = bk.bucket_worklist(probe, n_buckets, bk._qmax(d))[1]
    return {"distinct_buckets": distinct,
            "queries_per_bucket_mean": int(counts.sum()) / max(1, distinct),
            "queries_per_bucket_max": int(counts.max()),
            "work_items": int((items[:, 2] > 0).sum()),
            "grid": items.shape[0]}


def check_case_bucket(torch, label, kind, args, metric, reps, library=False):
    """A bucket kernel vs its plain version on the card: -inf positions
    equal exactly, no NaN, finite scores within 1e-5 x |q| x (largest row
    norm), l2 twice that (the plain version adds the same exact products
    in another order); a repeat gives the same bits. With `library`, also
    torch.bmm in bf16 over the probed buckets gathered beforehand (the
    gather not timed), a yardstick the port never calls. Raises on
    disagreement."""
    from leann_tpu_torch.ops import bucket_kernels as bk

    q, probe, table = args[:3]
    cap, d = table.shape[1:]
    if kind == "dots":
        fn = lambda: bk.ivf_bucket_dots(*args)
        plain = lambda: bk.ivf_bucket_dots_plain(*args)
        row = max_row_norm(kind, (table,))
    else:
        fn = lambda: bk.ivf8_bucket_scores(*args, metric)
        plain = lambda: bk.ivf8_bucket_scores_plain(*args, metric)
        row = max_row_norm(kind, (table, args[3], args[6]))
    got = fn()
    repeat_equal = bool(torch.equal(got, fn()))
    plain_ms, ref = cuda_ms(plain, 1)
    live = torch.isfinite(ref)
    tol = 1e-5 * float(q.norm(dim=1).max()) * row * (
        2 if metric == "l2" else 1)
    neg_equal = bool(torch.equal(torch.isneginf(got), torch.isneginf(ref)))
    nan = bool(torch.isnan(got).any())
    err = (float((got - ref).abs()[live].max()) if bool(live.any())
           else 0.0)
    ms, _ = cuda_ms(fn, reps)
    bound_ms, bound_by = bucket_bound(kind, probe, cap, d)
    lib_ms = None
    if library:
        b, p = probe.shape
        gathered = table[probe.long()].to(torch.bfloat16).reshape(
            b, p * cap, d)
        qb = q.to(torch.bfloat16)[:, :, None]
        lib_ms, _ = cuda_ms(lambda: torch.bmm(gathered, qb), reps)
        del gathered
    ctas = (bk.ivf_bucket_dots_ctas_per_sm if kind == "dots"
            else bk.ivf8_bucket_scores_ctas_per_sm)(d)
    out = {"case": label, "b": q.shape[0], "p": probe.shape[1], "cap": cap,
           "d": d, "metric": metric, "buckets": table.shape[0],
           "neg_inf_equal": neg_equal, "exact": bool(torch.equal(got, ref)),
           "repeat_equal": repeat_equal, "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": lib_ms, "ctas_per_sm": ctas,
           **bucket_reuse(torch, probe, table.shape[0], d)}
    if not neg_equal or nan or err > tol or not repeat_equal:
        raise AssertionError(f"{kind} kernel disagrees with its plain "
                             f"version: {json.dumps(out)}")
    return out


def gather_timers(torch, corpus, ids, q):
    """The roofline shape's other timers: per call by the graph timer
    (`graph_window_ms`, the window captured once), the kernel's own time
    by torch.profiler over one unqueued pass
    (`kernel_device_ms`, over the `kernel_events` it recorded of the M
    calls), and the queued window traced (`window_trace`: kernel time and
    idle gap per call) between two readings of the SM and memory clocks.
    Run right after the gather phase, whose corpus and ids it takes, and
    outside any phase's launch count: later in the run the profiler
    records none of this kernel's launches."""
    from leann_tpu_torch.evals.gather_roofline import (
        graph_window_ms, window_trace,
    )
    from leann_tpu_torch.ops import gather_score as gs

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    m = ids.shape[0]
    current = lambda i: gs.gather_score(corpus, i, q)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for i in ids:
            current(i)
        torch.cuda.synchronize()
    # per recorded kernel, not per call: a long run's profiler records only
    # some of the calls' kernels
    evs = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and "gather_score" in e.key]
    events = sum(e.count for e in evs)
    out = {"clocks_sm_mem": [smi("clocks.sm,clocks.mem")]}
    out.update({
        "ms_graph": float(np.mean(graph_window_ms(
            current, [ids], q.device, 10))) / m,
        "kernel_device_ms": (sum(e.device_time_total for e in evs) / 1e3
                             / events if events else None),
        "kernel_events": events,
        "trace": window_trace(current, ids, q.device, "gather_score"),
    })
    out["clocks_sm_mem"].append(smi("clocks.sm,clocks.mem"))
    return out


def gather_bound(b, r, d):
    """(bound ms, "bytes" or "operations") of one gather_score call: the
    B*R gathered rows (D bytes each), the ids, the queries and the output,
    each once; 2*D fp32 operations per row."""
    bytes_ = b * r * d + b * r * 4 + b * d * 4 + b * r * 4
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = 2 * b * r * d / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_case_gather(torch, label, corpus, ids, q, library=False):
    """gather_score vs gather_score_plain on the card, on the first
    [B, R] block of the id window `ids` [M, B, R]: within 1e-5 x |q| x
    (largest gathered row norm), no NaN, since both add the same exact
    products in another order. The kernel must take the path its shape
    names: staged where D % 16 == 0 and the corpus is 16-byte aligned,
    else per-row. Times are per call over three passes of the M blocks of the
    window after a warm pass, by the roofline's `window_ms` (distinct
    ids per call, so a call does not find its rows in L2 from the call
    before; each pass queued behind other device work, since a launch
    costs the host more than the card at these sizes). With `library`,
    also `corpus[ids]` widened to bf16 then torch.bmm, both inside the
    timed window, a yardstick the port never calls. Raises on
    disagreement."""
    from leann_tpu_torch.evals.gather_roofline import window_ms
    from leann_tpu_torch.ops import gather_score as gs

    m, b, r = ids.shape
    n, d = corpus.shape
    paths = dict(gs.gather_score.paths)
    got = gs.gather_score(corpus, ids[0], q)
    path = next(k for k, v in gs.gather_score.paths.items()
                if v != paths[k])
    plan = gs.launch_plan(b, r, d, gs._sm_count(q.device.index or 0),
                          corpus.data_ptr() % 16 == 0)
    want_path = ("staged" if d % 16 == 0 and corpus.data_ptr() % 16 == 0
                 else "rowwise")
    ref = gs.gather_score_plain(corpus, ids[0], q)
    err = float((got - ref).abs().max())
    nan = bool(torch.isnan(got).any())
    tol = 1e-5 * float(q.norm(dim=1).max()) * float(
        corpus[ids[0].long()].float().norm(dim=2).max())

    def per_call(fn):
        window_ms(fn, ids, q.device)                            # warm
        return float(np.mean([window_ms(fn, ids, q.device)
                              for _ in range(3)])) / m

    ms = per_call(lambda i: gs.gather_score(corpus, i, q))
    plain_ms = per_call(lambda i: gs.gather_score_plain(corpus, i, q))
    bound_ms, bound_by = gather_bound(b, r, d)
    lib_ms = None
    if library:
        qb = q.to(torch.bfloat16)[:, :, None]
        lib_ms = per_call(lambda i: torch.bmm(
            corpus[i.long()].to(torch.bfloat16), qb))
    out = {"case": label, "n": n, "b": b, "r": r, "d": d,
           "calls": m, "path": path, "exact": bool(torch.equal(got, ref)),
           "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": lib_ms,
           **{k: plan[k] for k in ("qpc", "rps", "chunks", "grid",
                                   "ctas_per_sm", "smem_bytes")}}
    if (nan or not err <= tol or path != want_path
            or plan["path"] != want_path):
        raise AssertionError(f"gather_score disagrees with its plain "
                             f"version or took the wrong path: "
                             f"{json.dumps(out)}")
    return out


FLAT_C = 80        # the flat benchmark cell's top-c: k = 10, rescore x 8
FLAT_CHUNK = 256   # ExactEngine's query chunk (`_two_stage`'s qc)


def check_case_flat(torch, label, dots, bias, scale, c, reps=10):
    """flat_topk vs `topk_stable(scale * dots + bias, c)` on the card:
    the ids equal exactly, in order. Times by CUDA events over `reps`
    calls, the kernel and the PyTorch path (`library_ms`: scale, bias,
    torch.topk, the select before the kernel) in turns (torch, kernel,
    kernel, torch), beside the plain `topk_stable` (a full stable sort)
    and the bound:
    the dots read once at H100_BYTES_PER_S. Also the keys the threshold
    filter admitted a row, from one call while a profiler session
    records. Raises on disagreement."""
    from leann_tpu_torch.ops.distance import topk_stable
    from leann_tpu_torch.ops.flat_topk import flat_topk, launch_plan

    rows, n = dots.shape
    got = flat_topk(dots, bias, scale, c)
    want = topk_stable(scale * dots + bias[None, :], c)[1]
    differ = int((got != want).any(dim=1).sum())
    turns = {"kernel": [], "torch": []}
    for which in ("torch", "kernel", "kernel", "torch"):
        fn = (lambda: flat_topk(dots, bias, scale, c)) if which == "kernel" \
            else (lambda: torch.topk(scale * dots + bias[None, :], c,
                                     dim=1).indices)
        turns[which].append(cuda_ms(fn, reps)[0])
    plain_ms = cuda_ms(lambda: topk_stable(scale * dots + bias[None, :], c),
                       3)[0]
    flat_topk.admitted = flat_topk.traced_rows = 0
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU]):
        flat_topk(dots, bias, scale, c)
        torch.cuda.synchronize()
    admitted = int(flat_topk.admitted) / max(1, flat_topk.traced_rows)
    bound_ms = rows * n * 4 / H100_BYTES_PER_S * 1e3
    out = {"case": label, "rows": rows, "n": n, "c": c, "scale": scale,
           "rows_differing": differ, "max_abs_err": float(differ),
           "ms": float(np.mean(turns["kernel"])), "ms_turns": turns["kernel"],
           "library_ms": float(np.mean(turns["torch"])),
           "library_turns": turns["torch"], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "roofline_pct": 100 * bound_ms / float(np.mean(turns["kernel"])),
           "admitted_per_row": admitted,
           "admitted_share": admitted / n,
           "plan": launch_plan(rows, n, c, torch.cuda.get_device_properties(
               dots.device).multi_processor_count)}
    if differ:
        raise AssertionError(f"flat_topk disagrees with topk_stable: "
                             f"{json.dumps(out)}")
    return out


def check_case_topc(torch, label, q, probe, eng, c, reps=10):
    """ivf_topc vs its plain version on B4's own dots on the card: ids and
    score bits equal exactly. Times by CUDA events over `reps` calls: the
    kernel, the plain version (fold, mask, `topk_stable` over [B, P*cap]:
    the select before the kernel, as the reference's Pallas path runs it)
    and `library_ms`, `topk_stable` alone over the folded and masked
    [B, P*cap] scores, made beforehand; the bound: the dots read once,
    the probed buckets' |v|^2 and ids once, the probes, and the [B, c]
    scores and ids written once, at H100_BYTES_PER_S. Raises on
    disagreement."""
    from leann_tpu_torch.ops.bucket_kernels import ivf_bucket_dots
    from leann_tpu_torch.ops.distance import topk_stable
    from leann_tpu_torch.ops.ivf_topc import ivf_topc, ivf_topc_plain

    args = (ivf_bucket_dots(q, probe, eng.bucket_vecs_bf16), probe,
            eng.bucket_sq, eng.bucket_ids, c, eng.metric, eng.n)
    got = ivf_topc(*args)
    want = ivf_topc_plain(*args)
    differ = int((got[1] != want[1]).any(dim=1).sum()) + int(
        (got[0].view(torch.int32) != want[0].view(torch.int32)).any(
            dim=1).sum())
    turns = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = ivf_topc if which == "kernel" else ivf_topc_plain
        turns[which].append(cuda_ms(lambda: fn(*args), reps)[0])
    dots = args[0]
    p, b, cap = dots.shape
    scores = dots.transpose(0, 1)
    if eng.metric == "l2":
        scores = 2.0 * scores - eng.bucket_sq[probe.long()]
    scores = scores.reshape(b, p * cap)
    scores = torch.where(eng.bucket_ids[probe.long()].reshape(b, p * cap)
                         == eng.n, float("-inf"), scores)
    lib_ms = cuda_ms(lambda: topk_stable(scores, c), reps)[0]
    del scores
    uniq = int(torch.unique(probe).numel())
    bytes_ = (p * b * cap * 4 + uniq * cap * (4 + 4) + b * p * 4
              + b * c * (4 + 8))
    bound_ms = bytes_ / H100_BYTES_PER_S * 1e3
    ms = float(np.mean(turns["kernel"]))
    out = {"case": label, "b": b, "p": p, "cap": cap, "c": c,
           "metric": eng.metric, "rows_differing": differ,
           "max_abs_err": float(differ), "ms": ms,
           "ms_turns": turns["kernel"],
           "plain_ms": float(np.mean(turns["plain"])),
           "plain_turns": turns["plain"], "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": "bytes",
           "roofline_pct": 100 * bound_ms / ms, "distinct_buckets": uniq}
    if differ:
        raise AssertionError(f"ivf_topc disagrees with its plain version: "
                             f"{json.dumps(out)}")
    return out


# ------------------------------------------------------------------ phases


def phase_env(torch):
    nvcc = subprocess.run(
        [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", "--version"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[-1]
    # the rescore paths must be full fp32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on; the fp32 rescore needs it off")
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "gpu": smi(),
          "device_count": torch.cuda.device_count()})


def phase_build():
    """The kernels' libraries, one nvcc per source, and the native BM25
    library (g++ on `csrc/leann_native.cpp`) in a thread beside them, all
    started together."""
    import threading

    from leann_tpu_torch import native
    from leann_tpu_torch.ops import _cuda

    libs = ("fused_beam", "pq_beam", "ivf_bucket_dots", "ivf8_scan",
            "gather_score", "flat_topk", "ivf_topc")
    gpp = {}

    def build_native():
        t = time.perf_counter()
        gpp["lib"] = native._load_lib()
        gpp["s"] = time.perf_counter() - t

    t0 = time.perf_counter()
    thread = threading.Thread(target=build_native)
    thread.start()
    _cuda.build(libs)
    for name in libs:
        _cuda.load(name)
    thread.join()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "native_s": gpp["s"], "native_lib": native._compiled_lib_path(),
          "sources": [k["source"]
                      for k in (FUSED, PQ, DOTS, IVF8, GATHER, FLAT, TOPC)]
          + ["leann_tpu_torch/csrc/leann_native.cpp"]})
    if gpp["lib"] is None:
        raise AssertionError("build: g++ could not build the native BM25 "
                             "library (leann_tpu_torch/csrc/leann_native.cpp)")


def phase_kernels(torch, dev):
    from leann_tpu_torch.ops import fused_beam as fb
    from leann_tpu_torch.ops.beam import _seed_entries
    from leann_tpu_torch.ops.vamana import build_vamana

    n, d, r, b = 4096, 128, 48, 1023
    rng = np.random.default_rng(7)
    x = make_corpus(rng, n, d, clusters=64)
    adj, medoid = build_vamana(x, graph_degree=r, complexity=64,
                               metric="l2", wave_size=4096, device=dev)
    eng = fb.FusedBeamEngine(x, adj, medoid, metric="l2", device=dev)
    q = torch.from_numpy(
        x[rng.integers(0, n, b)]
        + rng.standard_normal((b, d)).astype(np.float32) * 0.5).to(dev)
    exclude = torch.from_numpy(
        np.where(rng.random(b) < 0.5, rng.integers(0, n, b), -1)
        .astype(np.int32)).to(dev)
    rows = []
    for metric, e, tv in (("l2", 2, 160), ("l2", 1, 0), ("ip", 2, 0),
                          ("ip", 1, 160), ("l2", 2, 0), ("ip", 2, 160)):
        sc, ids = _seed_entries(q.to(torch.bfloat16).float(), eng.seed_vecs,
                                eng.seed_ids, eng.sq_norms, metric, 16)
        kw = dict(queries=q, blocks_i8=eng.blocks, meta_i32=eng.meta,
                  seed_ids=ids.to(torch.int32), seed_scores=sc.contiguous(),
                  exclude=exclude, r=eng.r, beam_width=64,
                  max_iters=(4 * 64) // e + 32, metric=metric,
                  expansions=e, qb=16, ring_size=1024, track_visited=tv)
        rows.append(check_case(torch, f"{metric}/E{e}/tv{tv}", kw, 10))
    emit({"phase": "kernels", "kernel": FUSED["name"], "cases": rows,
          "library_ms": None})
    return rows


def phase_kernels_pq(torch, dev):
    """pq_beam_search vs its plain version on N=4096 graphs built here,
    with the engine's own LUTs and ADC seeds at beam 64 and B=1023 (a
    short last query group), half the queries excluding a node."""
    from leann_tpu_torch.ops.pq_beam import PqBeamEngine
    from leann_tpu_torch.ops.vamana import build_vamana

    n, r, b = 4096, 48, 1023
    rows = []
    for d, cases in (
            (96, [("l2", 256, 2, 256, 0), ("ip", 256, 1, 0, 0),
                  ("l2", 16, 1, 256, 0), ("ip", 16, 2, 256, 0),
                  ("l2", 16, 2, 0, 0), ("ip", 256, 2, 256, 0),
                  ("l2", 256, 2, 256, 2)]),
            (768, [("l2", 256, 2, 256, 0)])):
        rng = np.random.default_rng(d)
        x = make_lowdim(rng, n, d, 16, 64)
        adj, medoid = build_vamana(x, graph_degree=r, complexity=64,
                                   metric="l2", wave_size=4096, device=dev)
        q = torch.from_numpy(x[rng.integers(0, n, b)] + 0.05 * rng.standard_normal(
            (b, d)).astype(np.float32)).to(dev)
        exclude = torch.from_numpy(
            np.where(rng.random(b) < 0.5, rng.integers(0, n, b), -1)
            .astype(np.int32)).to(dev)
        for metric, ksub, e, vt, coarse in cases:
            m = 64 if d == 768 else (12 if coarse else 16)
            eng = PqBeamEngine(x, adj, medoid, metric=metric, m=m, ksub=ksub,
                               coarse_m=coarse, kmeans_iters=6, device=dev)
            kw = dict(eng.kernel_args(q, exclude, 64), expansions=e,
                      track_visited=vt, max_iters=(4 * 64) // e + 32)
            label = (f"D{d}/m{eng.mt}/ksub{ksub}/{metric}/E{e}/tv{vt}"
                     + (f"/residual{coarse}" if coarse else ""))
            rows.append(check_case_pq(torch, label, kw, 10))
    emit({"phase": "kernels", "kernel": PQ["name"], "cases": rows,
          "library_ms": None})
    return rows


def phase_kernels_ivf(torch, dev):
    """ivf_bucket_dots and ivf8_bucket_scores vs their plain versions on
    random tables: caps that are not multiples of 32, D with 16-byte loads
    (96, 128, 768) and without (24, 20), odd batches whose first query
    probes one bucket P times, ~20% empty (-1) slots plus three at each
    bucket's end."""
    g = torch.Generator().manual_seed(5)
    dots, ivf8 = [], []
    for k, cap, d, b, p in ((12, 50, 96, 13, 8), (9, 77, 128, 31, 5),
                            (5, 40, 768, 7, 4), (6, 33, 24, 9, 3),
                            (4, 20, 20, 5, 2)):
        pay = torch.randint(-127, 128, (k, cap, d), generator=g,
                            dtype=torch.int8)
        scale = torch.rand((k, cap), generator=g) * 0.05
        cent = torch.randn((k, d), generator=g) * 3
        nsq = torch.rand((k, cap), generator=g) * 100
        ids = torch.arange(k * cap, dtype=torch.int32).reshape(k, cap)
        ids[torch.rand((k, cap), generator=g) < 0.2] = -1
        ids[:, cap - 3:] = -1
        vecs = (torch.randn((k, cap, d), generator=g) * 2).to(torch.bfloat16)
        q = torch.randn((b, d), generator=g) * 2
        probe = torch.randint(0, k, (b, p), generator=g, dtype=torch.int32)
        probe[0] = probe[0, 0]
        q, probe, pay, scale, cent, nsq, ids, vecs = (
            t.to(dev) for t in (q, probe, pay, scale, cent, nsq, ids, vecs))
        label = f"K{k}/cap{cap}/D{d}/B{b}/P{p}"
        dots.append(check_case_bucket(torch, label, "dots",
                                      (q, probe, vecs), "ip", 10))
        for metric in ("l2", "ip"):
            ivf8.append(check_case_bucket(
                torch, f"{label}/{metric}", "ivf8",
                (q, probe, pay, scale, nsq, ids, cent), metric, 10))
    for info, rows in ((DOTS, dots), (IVF8, ivf8)):
        emit({"phase": "kernels", "kernel": info["name"], "cases": rows,
              "library_ms": None})
    return dots, ivf8


def phase_kernels_gather(torch, dev):
    """gather_score vs its plain version on random corpora: D % 16 == 0
    (96, 128, 64: the staged kernel), 4-byte loads (100) and single bytes
    (50: the per-row kernel), R from 7 to 200, odd batches; every query's
    first two ids are the rows N-1 and 0 and one query's ids are all the
    same row. Then row offsets past 2^31 bytes: a 17M x 128 corpus made
    on the card, B=64, R=48, every query's ids holding N-1, 0 and eight
    rows above 2^24."""
    from leann_tpu_torch.evals.gather_roofline import make_corpus

    g = torch.Generator().manual_seed(9)
    rows = []
    for n, b, d, r in ((5000, 17, 96, 48), (5000, 31, 128, 128),
                       (3000, 9, 64, 7), (2000, 5, 50, 200),
                       (4000, 33, 100, 48), (4000, 1, 128, 48)):
        corpus = torch.randint(-128, 128, (n, d), generator=g,
                               dtype=torch.int8)
        ids = torch.randint(0, n, (4, b, r), generator=g, dtype=torch.int32)
        ids[:, :, 0], ids[:, :, 1] = n - 1, 0
        ids[:, b // 2, :] = 7
        q = torch.randn((b, d), generator=g) * 2
        rows.append(check_case_gather(
            torch, f"N{n}/B{b}/D{d}/R{r}", corpus.to(dev), ids.to(dev),
            q.to(dev)))
    n, b, d, r = GATHER_BIG_N, 64, 128, 48
    gen = torch.Generator(device=dev).manual_seed(10)
    corpus = make_corpus(n, d, gen, dev)
    ids = torch.randint(0, n, (4, b, r), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[:, :, 0], ids[:, :, 1] = n - 1, 0
    ids[:, :, 2:10] = torch.randint(1 << 24, n, (4, b, 8), generator=gen,
                                    device=dev, dtype=torch.int32)
    q = torch.randn((b, d), generator=gen, device=dev) * 2
    rows.append(check_case_gather(torch, f"N{n}/B{b}/D{d}/R{r} past 2^31",
                                  corpus, ids, q))
    del corpus
    emit({"phase": "kernels", "kernel": GATHER["name"], "cases": rows,
          "bit_equal_cases": sum(c["exact"] for c in rows),
          "library_ms": None})
    return rows


def rag_texts(n_docs):
    rng = np.random.default_rng(11)
    # an array, not a list: `choice` would convert a list on every draw
    # (the same draws either way, 30x slower)
    words = np.array([f"w{i}" for i in range(5000)])
    return rng, [f"passage {i}: " + " ".join(rng.choice(words, 24))
                 for i in range(n_docs)]


def rag_build_search(torch, dev, name, texts, vecs, q, pick, counter,
                     root=None):
    """The rag path on given embeddings: StreamingIndexBuilder (backend
    hnsw, R=32, L=64, ip) over `texts` / `vecs`, then IndexSearcher.search
    of the query vectors `q` (the embeddings of texts[pick]) at
    complexity 64 and RAG_COMPLEXITY. The index lives under `root` when
    given (kept), else in a temporary directory. Returns (engine,
    metrics)."""
    import contextlib

    from leann_tpu_torch.index import (
        IndexSearcher, SearchOptions, StreamingIndexBuilder,
    )
    from leann_tpu_torch.ops.distance import ExactEngine
    from leann_tpu_torch.store.passages import Passage

    with (contextlib.nullcontext(root) if root is not None
          else tempfile.TemporaryDirectory()) as tmp:
        base = os.path.join(tmp, "indexes", name, "documents.leann")
        index = StreamingIndexBuilder(base, dim=vecs.shape[1],
                                      backend="hnsw", metric="ip",
                                      device=dev)
        for i, (t, v) in enumerate(zip(texts, vecs)):
            index.add_passage(Passage(id=f"p{i}", text=t,
                                      metadata={"n": i}), v)
        c0, b0 = counter(), bm25_builds()
        t0 = time.perf_counter()
        index.build(graph_degree=32, complexity=64, alpha=1.2)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_launches = counter() - c0
        bm25 = bm25_since(b0)

        searcher = IndexSearcher.load(base, device=dev)
        oracle = ExactEngine(vecs, metric="ip", device=dev).search(
            q, k=10, exact_scan=True)[0]
        c0 = counter()
        out = {}
        for complexity in (64, RAG_COMPLEXITY):
            t0 = time.perf_counter()
            res = searcher.search(q, SearchOptions(top_k=10,
                                                   complexity=complexity))
            secs = time.perf_counter() - t0
            got = [[int(h.id[1:]) for h in r] for r in res]
            out[complexity] = (res, secs, recall_at(
                [g + [-1] * (10 - len(g)) for g in got], oracle))
        search_launches = counter() - c0
        engine = searcher.backend.engine

    res, search_s, rec = out[RAG_COMPLEXITY]
    hit1 = float(np.mean([bool(r) and r[0].id == f"p{i}"
                          for r, i in zip(res, pick)]))
    return engine, {
        "n": len(texts), "dim": vecs.shape[1], "build_s": build_s,
        "queries": len(pick), "engine": type(engine).__name__,
        "complexity": RAG_COMPLEXITY, "search_s": search_s,
        "self_hit1": hit1, "recall10": rec,
        "recall10_at_complexity_64": out[64][2],
        "search_s_at_complexity_64": out[64][1],
        "launches_build": build_launches,
        "launches_search": search_launches, "bm25_builds": bm25}


def phase_rag(torch, dev, n_docs, counter, root):
    """The rag path with the fake embedder; the index stays under `root`
    (the sharded phase loads it again)."""
    from leann_tpu_torch.embed.fake import FakeEmbedding

    rng, texts = rag_texts(n_docs)
    emb = FakeEmbedding(768)
    t0 = time.perf_counter()
    vecs = emb.embed(texts)
    embed_s = time.perf_counter() - t0
    pick = rng.choice(n_docs, 256, replace=False)
    q = emb.embed([texts[i] for i in pick])
    engine, row = rag_build_search(torch, dev, "rag", texts, vecs, q, pick,
                                   counter, root=root)
    emit({"phase": "rag", "embed_s": embed_s, **row})
    hit1, rec, rec64 = (row["self_hit1"], row["recall10"],
                        row["recall10_at_complexity_64"])
    if hit1 < 0.99 or rec < 0.95 or rec64 < RAG_MIN_RECALL_64:
        raise AssertionError(f"rag: self-hit@1 {hit1}, recall@10 {rec} at "
                             f"complexity {RAG_COMPLEXITY}, {rec64} at 64")
    check_bm25("rag", row["bm25_builds"])
    if row["launches_build"] <= 0 or row["launches_search"] <= 0:
        raise AssertionError("rag: the fused kernel was not launched "
                             f"(build {row['launches_build']}, search "
                             f"{row['launches_search']})")
    return (engine, torch.from_numpy(np.asarray(q, np.float32)).to(dev),
            pick, row, os.path.join(root, "indexes", "rag", "documents.leann"))


def native_build_pair(texts, tmp, label):
    """Bm25Scorer.build (which must take the native path) against the
    Python build on `texts`: seconds of each build and save, arrays equal,
    the saved files byte-equal."""
    from leann_tpu_torch.index.bm25 import Bm25Scorer

    b0 = bm25_builds()
    t0 = time.perf_counter()
    mine = Bm25Scorer.build(texts)
    native_s = time.perf_counter() - t0
    builds = bm25_since(b0)
    t0 = time.perf_counter()
    oracle = Bm25Scorer._build_python(texts)
    python_s = time.perf_counter() - t0
    paths, save_s, data = {}, {}, {}
    for name, scorer in (("native", mine), ("python", oracle)):
        paths[name] = os.path.join(tmp, f"{label}.{name}.bm25.npz")
        t0 = time.perf_counter()
        scorer.save(paths[name])
        save_s[name] = time.perf_counter() - t0
        with open(paths[name], "rb") as f:
            data[name] = f.read()
    return {"texts": len(texts), "native_s": native_s, "python_s": python_s,
            "native_save_s": save_s["native"],
            "python_save_s": save_s["python"],
            "vocab": int(mine.vocab.shape[0]),
            "postings": int(mine.post_docs.shape[0]),
            "bytes": len(data["native"]),
            "arrays_equal": bm25_equal(mine, oracle),
            "files_byte_equal": data["native"] == data["python"],
            "bm25_builds": builds}


def phase_native(torch, dev, n_docs, counter, rag_base):
    """The native host runtime (`leann_tpu_torch/native/`), no kernel: on
    the rag phase's texts and on `recompute_texts(RECOMPUTE_N)`, the
    native BM25 build against the Python build (arrays equal exactly,
    `.bm25.npz` files byte-equal, seconds of each build and save);
    IndexSearcher's in-memory build on a copy of the rag index without
    its sidecar (native, equal to the sidecar); `scan_line_offsets` on
    the rag index's passages JSONL against its offsets file."""
    import ctypes

    from leann_tpu_torch import native
    from leann_tpu_torch.index import IndexSearcher
    from leann_tpu_torch.index.bm25 import Bm25Scorer, bm25_path
    from leann_tpu_torch.store.passages import offsets_path, passages_path

    t_phase = time.perf_counter()
    row, bad = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for label, texts in (("rag", rag_texts(n_docs)[1]),
                             ("recompute", recompute_texts(RECOMPUTE_N))):
            r = row[label] = native_build_pair(texts, tmp, label)
            if not (all(r["arrays_equal"].values()) and r["files_byte_equal"]
                    and r["bm25_builds"] == {"native": 1, "python": 0}):
                bad.append(label)

        # IndexSearcher.bm25() builds in memory when the sidecar is missing
        src_dir = os.path.dirname(rag_base)
        copy_dir = os.path.join(tmp, "indexes", "rag")
        shutil.copytree(src_dir, copy_dir,
                        ignore=shutil.ignore_patterns("*.bm25.npz"))
        searcher = IndexSearcher.load(
            os.path.join(copy_dir, os.path.basename(rag_base)), device=dev)
        b0 = bm25_builds()
        t0 = time.perf_counter()
        scorer = searcher.bm25()
        row["searcher_build_s"] = time.perf_counter() - t0
        row["searcher_bm25_builds"] = bm25_since(b0)
        row["searcher_equal_sidecar"] = all(bm25_equal(
            scorer, Bm25Scorer.load(bm25_path(rag_base))).values())
        del searcher
        if not (row["searcher_equal_sidecar"] and row["searcher_bm25_builds"]
                == {"native": 1, "python": 0}):
            bad.append("searcher")

    # the C ABI's JSONL scan against the passage store's offsets
    lib = native._load_lib()
    with open(passages_path(rag_base), "rb") as f:
        buf = f.read()
    with open(offsets_path(rag_base), "r", encoding="utf-8") as f:
        want = np.sort(np.fromiter(json.load(f).values(), np.int64))
    out = np.zeros(buf.count(b"\n") + 1, np.int64)
    t0 = time.perf_counter()
    got = lib.scan_line_offsets(
        buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(out))
    row["scan_s"] = time.perf_counter() - t0
    row["scan_bytes"], row["scan_lines"] = len(buf), int(got)
    row["scan_equal_offsets"] = bool(np.array_equal(out[:got], want))
    if not row["scan_equal_offsets"]:
        bad.append("scan_line_offsets")
    row["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "native", **row})
    if bad:
        raise AssertionError(f"native: {bad} failed their gates")


def phase_sift(torch, dev, n, counter):
    from leann_tpu_torch.ops import fused_beam as fb
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.ops.vamana import build_vamana
    from leann_tpu_torch.store.graphfile import GraphFile, graph_path

    d, r, build_l, beam, batch, nq = 128, 48, 80, 64, 2048, 1024
    t0 = time.perf_counter()
    pool = make_corpus(np.random.default_rng(0), n + 1024 + 2048, d, 1024)
    corpus, queries = pool[:n], pool[n : n + nq]
    gen_s = time.perf_counter() - t0

    c0 = counter()
    t0 = time.perf_counter()
    adj, medoid = build_vamana(corpus, graph_degree=r, complexity=build_l,
                               alpha=1.2, metric="l2", wave_size=8192,
                               device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = counter() - c0
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "sift.leann")
        GraphFile(adj, medoid, "l2").save(graph_path(base))
        graph = GraphFile.load(graph_path(base))

    t0 = time.perf_counter()
    eng = fb.FusedBeamEngine(corpus, graph.adjacency, graph.medoid,
                             metric="l2", expansions=2, qb=16, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    c1 = counter()
    idx, _ = eng.search(queries, k=10, beam_width=beam)
    search_launches = counter() - c1
    _, oracle = exact_topk(queries, corpus, 10, metric="l2", device=dev)
    rec = recall_at(idx, oracle)

    # device QPS: M batches of 2048 per window, CUDA events, 3 windows
    def draw(m, seed):
        g = np.random.default_rng(seed)
        base_ = corpus[g.integers(0, n, m * batch)]
        noise = g.standard_normal((m * batch, d)).astype(np.float32)
        return torch.from_numpy((base_ + noise).reshape(m, batch, d)).to(dev)

    m = 4
    windows = [draw(m, 1000 + w) for w in range(3)]
    eng.search_many_device(windows[0], k=10, beam_width=beam)   # warm
    torch.cuda.synchronize()
    per_batch = [cuda_ms(lambda w=w: eng.search_many_device(
        w, k=10, beam_width=beam), 1)[0] / m for w in windows]
    qps = [batch / (t / 1e3) for t in per_batch]

    emit({"phase": "sift", "n": n, "d": d, "r": r, "build_l": build_l,
          "beam": beam, "gen_s": gen_s, "build_s": build_s,
          "pack_s": pack_s, "recall10": rec, "queries": nq,
          "qps_windows": qps, "qps_mean": float(np.mean(qps)),
          "ms_per_batch": per_batch, "batch": batch,
          "launches_build": build_launches,
          "launches_search": search_launches})
    if rec < 0.95:
        raise AssertionError(f"sift: recall@10 {rec} < 0.95")
    if build_launches <= 0 or search_launches <= 0:
        raise AssertionError("sift: the fused kernel was not launched")
    data = {"corpus": corpus, "queries": queries, "oracle": oracle,
            "qps_mean": float(np.mean(qps)), "pool": pool,
            "graph": (graph.adjacency, graph.medoid), "recall10": rec,
            "ids": idx}
    return eng, windows[0][0], build_l, data


def bench_line_ok(line, backend):
    """bench.py's four keys, unit qps, a positive value, the device rate
    of `backend`."""
    return (set(line) == {"metric", "value", "unit", "vs_baseline"}
            and line["unit"] == "qps" and line["value"] > 0
            and line["metric"].startswith(
                f"{backend}_device_qps_per_chip@recall10="))


def phase_bench(torch, dev, n, counter, sift):
    """`python -m leann_tpu_torch.bench` at bench.py's full shapes: each
    backend through `bench.run` on the sift phase's pool and graph, then
    the program itself once in a subprocess, as users run it. No call of
    flat_topk may take its PyTorch path. Returns the pq backend's engine
    and its probe batch (kernels_main's `bench pq search L64`)."""
    from leann_tpu_torch import bench
    from leann_tpu_torch.evals import corpus_cache
    from leann_tpu_torch.ops.flat_topk import flat_topk

    torch_calls = flat_topk.paths["torch"]
    cfg = bench.Config(n=n, m_batches=int(BENCH_ENV["BENCH_M"]),
                       reps=int(BENCH_ENV["BENCH_REPS"]))
    if (cfg.d, cfg.batch, cfg.recall_q, cfg.r, cfg.build_l, cfg.search_l,
            cfg.n_clusters, cfg.n_probe) != (128, 2048, 1024, 48, 80, 64,
                                             2000, 8):
        raise AssertionError(f"bench: not bench.py's shapes: {cfg}")
    rows, failures, pq = [], [], None
    for backend in bench.BACKENDS:
        t0 = time.perf_counter()
        k0 = (counter(DOTS["name"]), counter(TOPC["name"]))
        out = bench.run(backend, cfg, pool=sift["pool"], graph=sift["graph"],
                        device=dev)
        rec, launches = out["recall"], out["launches"]
        launches.update({DOTS["name"]: counter(DOTS["name"]) - k0[0],
                         TOPC["name"]: counter(TOPC["name"]) - k0[1]})
        row = {"backend": backend, "line": out["line"], "recall10": rec,
               "qps": out["qps"], "qps_std": out["qps_std"],
               "ms_per_batch": out["ms_per_batch"],
               "build_s": out["build_s"], "launches": launches,
               "wall_s": time.perf_counter() - t0,
               "profile": profile(torch, lambda: out["call"](
                   out["probe"][None]))}
        want = {"vamana": (True, False), "pq": (False, True)}.get(
            backend, (False, False))
        if not bench_line_ok(out["line"], backend):
            failures.append(f"{backend}: line {out['line']}")
        if (launches[FUSED["name"]] > 0, launches[PQ["name"]] > 0) != want \
                or {launches[DOTS["name"]] > 0, launches[TOPC["name"]] > 0} \
                != {backend == "ivf"}:
            failures.append(f"{backend}: launches {launches}")
        if backend == "vamana":
            # the sift phase's engine on the same pool, graph and
            # queries: the same ids, so the same recall against the sift
            # phase's oracle (the full f32 scan; the bench's own is
            # bench.py's two-stage oracle, which may rank a near tie at
            # the 10th place otherwise)
            vamana_line = out["line"]["metric"]
            row["ids_equal_sift"] = bool(np.array_equal(out["ids"],
                                                        sift["ids"]))
            row["recall10_sift_oracle"] = recall_at(out["ids"],
                                                    sift["oracle"])
            row["oracle_overlap"] = recall_at(out["oracle"], sift["oracle"])
            if not row["ids_equal_sift"] or \
                    row["recall10_sift_oracle"] != sift["recall10"]:
                failures.append(f"vamana: ids or recall@10 "
                                f"{row['recall10_sift_oracle']} differ from "
                                f"the sift phase's {sift['recall10']}")
        limit = {"flat": 1.0, "ivf": IVF_MIN_RECALL,
                 "ivfpq": BENCH_IVFPQ_MIN_RECALL,
                 "pq": BENCH_PQ_MIN_RECALL}.get(backend)
        if limit is not None and rec < limit:
            failures.append(f"{backend}: recall@10 {rec} < {limit}")
        if backend == "pq":
            pq = (out["engine"], out["probe"])
        rows.append(row)
        del out
    if flat_topk.paths["torch"] != torch_calls:
        failures.append("flat_topk took its PyTorch path on the card")

    # as users run it: the graph and the pool at the bench's artifact
    # paths (each written here only where absent, and removed after), no
    # BENCH_BACKEND, the phase's windows
    pool_path = corpus_cache.pool_path(n, cfg.d)
    wrote = [p for p in (cfg.graph_path(), pool_path)
             if not os.path.exists(p)]
    try:
        if cfg.graph_path() in wrote:
            bench.save_graph(cfg.graph_path(), *sift["graph"])
        if pool_path in wrote:
            np.save(pool_path, sift["pool"])
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("BENCH_") and k != "LEANN_PQ_RESCORE"}
        env.update(BENCH_ENV, LEANN_TORCH_DEVICE=str(dev))
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "leann_tpu_torch.bench"],
                           capture_output=True, text=True, env=env,
                           timeout=300, cwd=os.path.dirname(
                               os.path.abspath(__file__)))
        sub = {"rc": p.returncode, "wall_s": time.perf_counter() - t0,
               "stderr_tail": p.stderr.strip().splitlines()[-6:]}
    finally:
        for path in wrote:
            if os.path.exists(path):
                os.remove(path)
    try:
        sub["line"] = json.loads(p.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        sub["line"] = None
    if p.returncode != 0 or not sub["line"] or not bench_line_ok(
            sub["line"], "vamana"):
        failures.append(f"subprocess: rc {p.returncode}, line {sub['line']}, "
                        f"stderr {p.stderr[-2000:]}")
    elif cfg.graph_path() in wrote:
        # the sift graph and pool: the in-process vamana line's recall
        sub["recall_equal"] = (sub["line"]["metric"].split(" ")[0]
                               == vamana_line.split(" ")[0])
        if not sub["recall_equal"]:
            failures.append(f"subprocess: {sub['line']['metric']} vs "
                            f"{vamana_line}")
    emit({"phase": "bench", "n": n, "d": cfg.d, "batch": cfg.batch,
          "env": BENCH_ENV, "card": smi(), "backends": rows,
          "subprocess": sub, "failures": failures})
    if failures:
        raise AssertionError(f"bench: {failures}")
    return pq


def phase_deep(torch, dev, n, counter, beams=(64, DEEP_BEAM)):
    """BASELINE config 2 through the user's entry points: Vamana build,
    graph file round trip, GraphSearcher's own engine choice (it must be
    PqBeamEngine at D=96), the `.pq.npz` sidecar reloaded without
    retraining, recall@10 and device QPS at each beam of `beams`."""
    from leann_tpu_torch.backend import GraphSearcher
    from leann_tpu_torch.ops import pq_beam as pb
    from leann_tpu_torch.ops.beam import BeamSearchEngine
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.ops.vamana import build_vamana
    from leann_tpu_torch.store.graphfile import GraphFile, graph_path

    d, r, build_l, batch, nq, m = 96, 48, 80, 2048, 1024, 4
    if os.environ.get("LEANN_GRAPH_ENGINE"):
        raise AssertionError("deep: LEANN_GRAPH_ENGINE must be unset")
    t0 = time.perf_counter()
    pool = make_lowdim(np.random.default_rng(0), n + nq + 3 * m * batch, d,
                       16, 1024)
    corpus, queries = pool[:n], pool[n : n + nq]
    windows = [torch.from_numpy(w).to(dev) for w in
               pool[n + nq :].reshape(3, m, batch, d)]
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    adj, medoid = build_vamana(corpus, graph_degree=r, complexity=build_l,
                               alpha=1.2, metric="l2", wave_size=8192,
                               device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "deep.leann")
        GraphFile(adj, medoid, "l2").save(graph_path(base))
        graph = GraphFile.load(graph_path(base))
        t0 = time.perf_counter()
        searcher = GraphSearcher(corpus, graph, metric="l2", base=base,
                                 device=dev)
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
        eng = searcher.engine
        if type(eng).__name__ != "PqBeamEngine":
            raise AssertionError(f"deep: GraphSearcher chose "
                                 f"{type(eng).__name__}, not PqBeamEngine")

        # the sidecar: a second searcher must load it, not train again
        def no_training(*a, **k):
            raise AssertionError("deep: PQ retrained despite the sidecar")

        trained = pb.train_pq
        pb.train_pq = no_training
        try:
            t0 = time.perf_counter()
            again = GraphSearcher(corpus, graph, metric="l2", base=base,
                                  device=dev)
            torch.cuda.synchronize()
            reload_s = time.perf_counter() - t0
        finally:
            pb.train_pq = trained
        if not np.array_equal(again.engine.codes, eng.codes):
            raise AssertionError("deep: the sidecar's codes differ")
        del again

    t0 = time.perf_counter()
    pb.pack_pq_records(np.concatenate([graph.adjacency, np.full(
        (1, r), n, np.int32)]), np.concatenate(
            [eng.codes, np.zeros((1, eng.mt), np.uint8)]), eng.bits,
        device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0

    _, oracle = exact_topk(queries, corpus, 10, metric="l2", device=dev)
    # the graph's own ceiling: the same graph traversed on exact f32
    # scores (row-gather engine), against which the PQ navigation reads
    exact_eng = BeamSearchEngine(corpus, graph.adjacency, graph.medoid,
                                 metric="l2", block_mode="none", device=dev)
    ceiling = {beam: recall_at(exact_eng.search(queries, k=10,
                                                beam_width=beam)[0], oracle)
               for beam in beams}
    del exact_eng
    out = {}
    for beam in beams:
        c0 = counter()
        t0 = time.perf_counter()
        idx, _ = searcher.search(queries, k=10, complexity=beam)
        search_s = time.perf_counter() - t0
        if counter() <= c0:
            raise AssertionError("deep: the PQ kernel was not launched")
        eng.search_many_device(windows[0], k=10, beam_width=beam)   # warm
        torch.cuda.synchronize()
        per_batch = [cuda_ms(lambda w=w: eng.search_many_device(
            w, k=10, beam_width=beam), 1)[0] / m for w in windows]
        qps = [batch / (t / 1e3) for t in per_batch]
        out[beam] = {"recall10": recall_at(idx, oracle),
                     "exact_graph_recall10": ceiling[beam],
                     "search_s": search_s, "qps_windows": qps,
                     "qps_mean": float(np.mean(qps)),
                     "ms_per_batch": per_batch,
                     "profile": profile(torch, lambda: eng.search_many_device(
                         windows[1], k=10, beam_width=beam))}

    emit({"phase": "deep", "n": n, "d": d, "r": r, "build_l": build_l,
          "gen_s": gen_s, "build_s": build_s, "engine": type(eng).__name__,
          "pq_m": eng.mt, "pq_ksub": eng.ksub,
          "engine_s": engine_s, "engine_from_sidecar_s": reload_s,
          "pack_s": pack_s, "queries": nq, "batch": batch,
          "beams": {str(k): v for k, v in out.items()}})
    rec64, rec = out[beams[0]]["recall10"], out[beams[-1]]["recall10"]
    if rec < DEEP_MIN_RECALL or rec64 < DEEP_MIN_RECALL_64:
        raise AssertionError(f"deep: recall@10 {rec} at beam {beams[-1]}, "
                             f"{rec64} at {beams[0]}")
    return eng, windows[0][0]


def qps_windows(torch, fn, windows):
    """(per-batch device ms of fn(batch) over each [M, B, D] window, by
    CUDA events, after one warm window; the QPS of each)."""
    m, b = windows[0].shape[:2]
    for q in windows[0]:
        fn(q)
    torch.cuda.synchronize()
    per_batch = [cuda_ms(lambda w=w: [fn(q) for q in w], 1)[0] / m
                 for w in windows]
    return per_batch, [b / (t / 1e3) for t in per_batch]


IVF_CALL_BATCHES = 8    # the IVF benchmark cell's batches a call


def ivf_graphs(torch, dev, eng, corpus, batch):
    """`IvfEngine.search_many_device` at the IVF cell's shape (8 batches
    of `batch` a call): the first call eager, the second captures the
    shape's CUDA graphs, later calls replay. Whether the replayed answers
    equal the eager call's and `search_device`'s batch by batch, bit for
    bit; the wall ms a batch of the graph path and of `search_device`
    (the eager path) over the same three calls, each ended by a sync;
    the calls' paths."""
    from leann_tpu_torch.ops.ivf import IvfEngine

    many = IvfEngine.search_many_device
    paths0 = dict(many.paths)
    calls = [torch.from_numpy(noisy_rows(
        corpus, (IVF_CALL_BATCHES, batch), 2100 + w)).to(dev)
        for w in range(3)]
    kw = {"k": 10, "nprobe": NPROBE}
    eager = eng.search_many_device(calls[0], **kw)
    eng.search_many_device(calls[0], **kw)
    replay = eng.search_many_device(calls[0], **kw)
    one = [eng.search_device(q, **kw) for q in calls[0]]

    def same(a, b):
        return bool(torch.equal(a[0], b[0]) and torch.equal(
            a[1].view(torch.int32), b[1].view(torch.int32)))

    equal = same(eager, replay) and same(replay, (
        torch.stack([o[0] for o in one]), torch.stack([o[1] for o in one])))

    def wall_ms(fn):
        out = []
        for w in calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(w)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3 / IVF_CALL_BATCHES)
        return out

    graph_ms = wall_ms(lambda w: eng.search_many_device(w, **kw))
    eager_ms = wall_ms(lambda w: [eng.search_device(q, **kw) for q in w])
    return {"equal": equal, "graph_wall_ms_per_batch": graph_ms,
            "eager_wall_ms_per_batch": eager_ms,
            "paths": {k: v - paths0[k] for k, v in many.paths.items()}}


def phase_ivf(torch, dev, n, counter):
    """BASELINE config 1 / bench.py's IVF config through IvfEngine at
    nprobe 8: `search`, what IvfSearcher serves (on the card kernel B4
    scores the probed buckets, kernel ivf_topc keeps the top-C)."""
    from leann_tpu_torch.ops.bucket_kernels import ivf_bucket_dots
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.ops.ivf import IvfEngine, ivf_search
    from leann_tpu_torch.ops.ivf_topc import ivf_topc

    d, batch, nq, m = 128, 2048, 1024, 4
    t0 = time.perf_counter()
    pool = make_corpus(np.random.default_rng(0), n + nq, d, 1024)
    corpus, queries = pool[:n], pool[n:]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = IvfEngine(corpus, n_clusters=IVF_CLUSTERS, metric="l2", device=dev)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    _, oracle = exact_topk(queries, corpus, 10, metric="l2", device=dev)

    def kernels():
        return (ivf_bucket_dots.launches, ivf_topc.launches)

    c0, paths0 = kernels(), dict(ivf_search.paths)
    rec = recall_at(eng.search(queries, k=10, nprobe=NPROBE)[0], oracle)
    launches = [b - a for a, b in zip(c0, kernels())]
    paths = {k: v - paths0[k] for k, v in ivf_search.paths.items()}

    windows = [torch.from_numpy(noisy_rows(corpus, (m, batch), 2000 + w)).to(dev)
               for w in range(3)]
    fn = lambda q: eng.search_device(q, k=10, nprobe=NPROBE)
    per_batch, qps = qps_windows(torch, fn, windows)
    graphs = ivf_graphs(torch, dev, eng, corpus, batch)
    emit({"phase": "ivf", "n": n, "d": d, "n_clusters": IVF_CLUSTERS,
          "buckets": eng.bucket_cent.shape[0], "cap": eng.cap,
          "nprobe": NPROBE, "gen_s": gen_s, "engine_s": engine_s,
          "queries": nq, "batch": batch, "recall10": rec,
          "launches": launches, "paths": paths, "ms_per_batch": per_batch,
          "qps_windows": qps, "qps_mean": float(np.mean(qps)),
          "graphs": graphs,
          "profile": profile(torch, lambda: [fn(q) for q in windows[1]])})
    if rec < IVF_MIN_RECALL:
        raise AssertionError(f"ivf: recall@10 {rec}")
    if min(launches) <= 0 or paths != {"kernel": 1, "torch": 0}:
        raise AssertionError("ivf: search must launch ivf_bucket_dots and "
                             "ivf_topc, once through ivf_search's kernel "
                             f"path: {launches}, {paths}")
    if not graphs["equal"] or graphs["paths"] != {
            "eager": IVF_CALL_BATCHES, "capture": 1,
            "replay": IVF_CALL_BATCHES * 5 - 1}:
        raise AssertionError(f"ivf: the graph path: {graphs}")
    data = {"corpus": corpus, "queries": queries, "oracle": oracle,
            "centers": eng.centers, "assign": eng.assign, "recall10": rec}
    return eng, windows[0][0], data


def phase_ivf8(torch, dev, n, counter):
    """BASELINE config 2 at full scale through IvfInt8Engine at nprobe 8:
    `search` (on the card kernel ivf8_bucket_scores) beside the torch
    scan `ivf8_search` (ShardedIvf8Index's) on the engine's tables,
    device QPS of `search` at the reference's A/B batch (512) and at
    2048, and the calibrated nprobe for recall 0.95."""
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.ops.ivf import kmeans, search_sizes
    from leann_tpu_torch.ops.ivf_int8 import IvfInt8Engine, ivf8_search

    d, nq, m = 96, 1024, 4
    t0 = time.perf_counter()
    pool = make_corpus(np.random.default_rng(0), n + nq, d, 1024)
    corpus, queries = pool[:n], pool[n:]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    centers, assign = kmeans(corpus, IVF8_CLUSTERS, metric="l2", device=dev)
    kmeans_s = time.perf_counter() - t0
    # k-means sums in a fixed order: two runs of its first iteration on a
    # 1M slice must give the same bits
    runs = [kmeans(corpus[:1_000_000], IVF8_CLUSTERS, iters=1, metric="l2",
                   device=dev) for _ in range(2)]
    kmeans_repeat_equal = all(
        a.tobytes() == b.tobytes() for a, b in zip(*runs))
    del runs
    t0 = time.perf_counter()
    eng = IvfInt8Engine(corpus, metric="l2", centers=centers, assign=assign,
                        device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    _, oracle = exact_topk(queries, corpus, 10, metric="l2", device=dev)

    rec, launches = {}, {}
    c0 = counter()
    rec["kernel"] = recall_at(eng.search(queries, k=10, nprobe=NPROBE)[0],
                              oracle)
    launches["kernel"] = counter() - c0
    c0 = counter()
    k, nprobe, c = search_sizes(eng, 10, NPROBE, 4)
    scan_ids, _ = ivf8_search(
        torch.as_tensor(queries, dtype=torch.float32, device=dev),
        eng.bucket_cent, eng.bucket_ids, eng.payload, eng.scale, eng.nsq,
        k=k, c=c, nprobe=nprobe, metric=eng.metric, sentinel=eng.n)
    rec["torch"] = recall_at(scan_ids.cpu().numpy(), oracle)
    launches["torch"] = counter() - c0
    timing = {}
    batches = {}
    fn = lambda q: eng.search_device(q, k=10, nprobe=NPROBE)
    for batch in (512, 2048):
        windows = [torch.from_numpy(noisy_rows(
            corpus, (m, batch), 3000 + 10 * batch + w)).to(dev)
            for w in range(3)]
        batches[batch] = windows[0][0]
        per_batch, qps = qps_windows(torch, fn, windows)
        row = {"ms_per_batch": per_batch, "qps_windows": qps,
               "qps_mean": float(np.mean(qps))}
        if batch == 2048:
            row["profile"] = profile(
                torch, lambda: [fn(q) for q in windows[1]])
        timing[f"kernel_b{batch}"] = row
    t0 = time.perf_counter()
    cal_nprobe, cal_rec = eng.calibrate_nprobe(0.95)
    calibrate_s = time.perf_counter() - t0
    emit({"phase": "ivf8", "n": n, "d": d, "n_clusters": IVF8_CLUSTERS,
          "buckets": eng.bucket_cent.shape[0], "cap": eng.cap,
          "payload_gb": eng.payload.numel() / 1e9, "nprobe": NPROBE,
          "gen_s": gen_s, "kmeans_s": kmeans_s,
          "kmeans_repeat_equal": kmeans_repeat_equal, "pack_s": pack_s,
          "queries": nq, "recall10_kernel": rec["kernel"],
          "recall10_torch": rec["torch"], "launches_kernel": launches["kernel"],
          "launches_torch": launches["torch"],
          "calibrated_nprobe": cal_nprobe, "calibrated_recall10": cal_rec,
          "calibrate_s": calibrate_s, **timing})
    if rec["kernel"] < IVF8_MIN_RECALL or \
            abs(rec["kernel"] - rec["torch"]) > 0.002:
        raise AssertionError(f"ivf8: recall@10 {rec['kernel']} (kernel) vs "
                             f"{rec['torch']} (torch)")
    if launches["torch"] or launches["kernel"] <= 0:
        raise AssertionError("ivf8: search must launch ivf8_bucket_scores "
                             "on the card and the torch scan must not")
    if not kmeans_repeat_equal:
        raise AssertionError("ivf8: two k-means runs gave different bits")
    data = {"corpus": corpus, "queries": queries, "oracle": oracle,
            "centers": centers, "assign": assign, "recall10": rec["kernel"]}
    return eng, batches, data


def phase_rag_ivf(torch, dev, n_docs, counter):
    """The rag corpus through the `ivf` backend's entry points: build
    (k-means + the calibrated nprobe in the meta, whose oracle probes
    every bucket), IndexSearcher.search on 256 passage texts. IvfSearcher
    serves kernels B4 and ivf_topc (`drive` checks that both launch)."""
    from leann_tpu_torch.embed.fake import FakeEmbedding
    from leann_tpu_torch.index import (
        IndexSearcher, SearchOptions, StreamingIndexBuilder,
    )
    from leann_tpu_torch.ops.distance import ExactEngine
    from leann_tpu_torch.store.passages import Passage

    rng, texts = rag_texts(n_docs)
    emb = FakeEmbedding(768)
    vecs = emb.embed(texts)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "indexes", "rag_ivf", "documents.leann")
        builder = StreamingIndexBuilder(base, dim=768, backend="ivf",
                                        metric="ip", device=dev)
        for i, (t, v) in enumerate(zip(texts, vecs)):
            builder.add_passage(Passage(id=f"p{i}", text=t,
                                        metadata={"n": i}), v)
        t0 = time.perf_counter()
        meta = builder.build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        kw = meta.backend_kwargs or {}
        if "nprobe" not in kw:
            raise AssertionError(f"rag_ivf: no calibrated nprobe in {kw}")
        nprobe = int(kw["nprobe"])
        searcher = IndexSearcher.load(base, device=dev)
        pick = rng.choice(n_docs, 256, replace=False)
        q = emb.embed([texts[i] for i in pick])
        oracle = ExactEngine(vecs, metric="ip", device=dev).search(
            q, k=10, exact_scan=True)[0]
        out = {}
        for complexity in (2 * nprobe, 64):
            t0 = time.perf_counter()
            res = searcher.search(q, SearchOptions(top_k=10,
                                                   complexity=complexity))
            secs = time.perf_counter() - t0
            got = [[int(h.id[1:]) for h in r] for r in res]
            hit1 = float(np.mean([bool(r) and r[0].id == f"p{i}"
                                  for r, i in zip(res, pick)]))
            out[complexity] = {"search_s": secs, "self_hit1": hit1,
                               "recall10": recall_at(
                                   [g + [-1] * (10 - len(g)) for g in got],
                                   oracle)}
    cal = out[2 * nprobe]
    emit({"phase": "rag_ivf", "n": n_docs, "dim": 768, "build_s": build_s,
          "backend_kwargs": kw, "queries": 256,
          "engine": type(searcher.backend.engine).__name__,
          "at_calibrated_nprobe": cal, "at_complexity_64": out[64]})
    if cal["self_hit1"] < 0.99 or cal["recall10"] < RAG_IVF_MIN_RECALL:
        raise AssertionError(f"rag_ivf: {cal} at nprobe {nprobe}")


def phase_gather(torch, dev, n, counter):
    """The row-gather roofline through its entry point
    (`leann_tpu_torch.evals.gather_roofline.run`) at the reference's
    default shape: both engines, rows/s and effective GB/s; `run` holds
    each engine against the plain version on the window's first call."""
    from leann_tpu_torch.evals import gather_roofline
    from leann_tpu_torch.ops.gather_score import gather_score

    b, r, d = 2048, 48, 128
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = gather_roofline.make_corpus(n, d, gen, dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    paths = dict(gather_score.paths)
    rows = gather_roofline.run(n=n, b=b, r=r, m_scan=50, reps=10, d=d,
                               device=dev, corpus=corpus)
    paths = {k: v - paths[k] for k, v in gather_score.paths.items()}
    by = {row["engine"]: row for row in rows}
    emit({"phase": "gather", "n": n, "d": d, "b": b, "r": r,
          "corpus_gb": n * d / 1e9, "gen_s": gen_s, "rows": rows,
          "kernel_over_torch": (by["gather-cuda"]["rows_per_s"]
                                / by["gather-torch"]["rows_per_s"]),
          "launches": counter(), "paths": paths})
    if paths["rowwise"] or not paths["staged"]:
        raise AssertionError(f"gather: the roofline shape must launch the "
                             f"staged kernel only: {paths}")
    ids = torch.randint(0, n, (20, b, r), generator=gen, device=dev,
                        dtype=torch.int32)
    q = torch.randn((b, d), generator=gen, device=dev)
    return corpus, ids, q


def phase_ivfpq(torch, dev, n, counter, big, small):
    """IVF-PQ at `evals/ivfpq_device_check.py`'s configuration on the ivf8
    phase's corpus, centers and assignment (`big`), then IvfSearcher
    under LEANN_IVF_ENGINE=pq over the ivf phase's (`small`). The scan is
    plain PyTorch: no kernel may launch."""
    from types import SimpleNamespace

    from leann_tpu_torch.backend import IvfSearcher
    from leann_tpu_torch.ops.ivf_pq import IvfPqEngine

    corpus, queries, oracle = big["corpus"], big["queries"], big["oracle"]
    d, batch, m = corpus.shape[1], 2048, 4
    pq_m = next(mm for mm in (16, 12, 8) if d % mm == 0)
    t0 = time.perf_counter()
    eng = IvfPqEngine(corpus, metric="l2", m=pq_m, rescore="int8",
                      centers=big["centers"], assign=big["assign"],
                      device=dev)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    kw = dict(k=10, nprobe=IVFPQ_NPROBE, rescore_factor=IVFPQ_RESCORE_FACTOR)
    t0 = time.perf_counter()
    rec = recall_at(eng.search(queries, **kw)[0], oracle)
    search_s = time.perf_counter() - t0
    windows = [torch.from_numpy(noisy_rows(corpus, (m, batch), 4000 + w)).to(dev)
               for w in range(3)]
    fn = lambda q: eng.search_device(q, **kw)
    per_batch, qps = qps_windows(torch, fn, windows)
    prof = profile(torch, lambda: [fn(q) for q in windows[1]])
    many = eng.search_many_device(windows[0][:1], **kw)
    one = eng.search_device(windows[0][0], **kw)
    if not (torch.equal(many[0][0], one[0]) and torch.equal(many[1][0], one[1])):
        raise AssertionError("ivfpq: search_many_device differs from "
                             "search_device on the same batch")
    t0 = time.perf_counter()
    cal_nprobe, cal_rec = eng.calibrate_nprobe(0.95)
    calibrate_s = time.perf_counter() - t0

    with env_var("LEANN_IVF_ENGINE", "pq"):
        t0 = time.perf_counter()
        searcher = IvfSearcher(
            small["corpus"], SimpleNamespace(centers=small["centers"],
                                             assign=small["assign"]),
            metric="l2", device=dev)
        torch.cuda.synchronize()
        searcher_s = time.perf_counter() - t0
    small_eng = searcher.engine
    rec_1m = recall_at(searcher.search(small["queries"], k=10,
                                       complexity=2 * NPROBE)[0],
                       small["oracle"])
    emit({"phase": "ivfpq", "n": n, "d": d, "m": pq_m, "ksub": eng.ksub,
          "rescore": eng.rescore, "nprobe": IVFPQ_NPROBE,
          "rescore_factor": IVFPQ_RESCORE_FACTOR,
          "buckets": eng.bucket_cent.shape[0], "cap": eng.cap,
          "engine_s": engine_s, "engine_steps_s": eng.build_seconds,
          "codes_bytes": eng.bucket_codes.numel(),
          "norms_bytes": eng.bucket_nsq.numel() * 4,
          "ids_bytes": eng.bucket_ids.numel() * 4,
          "rescore_corpus_bytes": eng.corpus.numel(),
          "bf16_engine_bytes": n * d * 6,
          "queries": len(queries), "recall10": rec,
          "recall10_ivf8_nprobe8": big["recall10"], "search_s": search_s,
          "batch": batch, "ms_per_batch": per_batch, "qps_windows": qps,
          "qps_mean": float(np.mean(qps)), "profile": prof,
          "calibrated_nprobe": cal_nprobe, "calibrated_recall10": cal_rec,
          "calibrate_s": calibrate_s,
          "searcher_1m": {
              "n": small_eng.n, "d": small_eng.d,
              "engine": type(small_eng).__name__,
              "rescore": getattr(small_eng, "rescore", None),
              "m": getattr(small_eng, "m", None), "engine_s": searcher_s,
              "nprobe": NPROBE, "recall10": rec_1m,
              "recall10_ivf_engine": small["recall10"]}})
    if type(small_eng).__name__ != "IvfPqEngine" or small_eng.rescore != "f32":
        raise AssertionError(
            f"ivfpq: IvfSearcher chose {type(small_eng).__name__} with "
            f"rescore {getattr(small_eng, 'rescore', None)}, not "
            "IvfPqEngine with f32")
    if rec < IVFPQ_MIN_RECALL or rec_1m < IVFPQ_1M_MIN_RECALL:
        raise AssertionError(f"ivfpq: recall@10 {rec} at 10M, {rec_1m} "
                             "through IvfSearcher at 1M")
    if counter():
        raise AssertionError("ivfpq: a kernel launched; the IVF-PQ scan is "
                             "plain PyTorch")


def phase_encode(torch, dev, n_docs, counter, fake_row):
    """The BERT encoder at the published bert-base widths (seeded random
    weights, hash tokenizer) through LocalEmbedding, the rag index built
    and searched on its vectors, and `entry()` on the card against its
    CPU run."""
    from leann_tpu_torch.embed import LocalEmbedding
    from leann_tpu_torch.entry import entry
    from leann_tpu_torch.models import bert

    rng, texts = rag_texts(n_docs)
    t0 = time.perf_counter()
    enc = bert.BertEncoder(bert.BertConfig(), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = enc.config
    emb = LocalEmbedding(encoder=enc, batch_size=128)
    emb.embed(texts[:256])                                      # warm
    t0 = time.perf_counter()
    embed_ms, vecs = cuda_ms(lambda: emb.embed(texts), 1)
    embed_s = time.perf_counter() - t0
    batches = -(-n_docs // 128)
    tok, mask = enc.tokenizer.encode_batch(texts[:128])
    tlen = bert._bucket_len(tok.shape[1], cap=enc.max_length)
    ids_pad = np.zeros((128, tlen), np.int32)
    mask_pad = np.zeros((128, tlen), np.int32)
    ids_pad[:, :tok.shape[1]], mask_pad[:, :tok.shape[1]] = tok, mask
    ids_dev = torch.from_numpy(ids_pad).to(dev)
    mask_dev = torch.from_numpy(mask_pad).to(dev)

    def forward(config):
        with torch.no_grad():
            return bert.bert_forward(enc.params, ids_dev, mask_dev, config)

    import dataclasses

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    forward(cfg), forward(cfg32)
    forward_ms = cuda_ms(lambda: forward(cfg), 10)[0]
    forward_f32_ms = cuda_ms(lambda: forward(cfg32), 3)[0]
    forward_profile = profile(torch, lambda: forward(cfg))

    # the bf16 product with a float32 result against the widened product
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn((1, 128 * tlen, cfg.hidden_size), generator=g, device=dev)
    w = torch.randn((1, cfg.hidden_size, cfg.intermediate_size), generator=g,
                    device=dev) / np.sqrt(cfg.hidden_size)
    widened = lambda: torch.bmm(a.to(torch.bfloat16).float(),
                                w.to(torch.bfloat16).float())
    want = widened()
    got = bert._mm(a, w, True)
    product = {"bf16_operands": bert._bf16_operands(dev),
               "max_abs_err": float((got - want).abs().max()),
               "ms": cuda_ms(lambda: bert._mm(a, w, True), 10)[0],
               "widened_f32_ms": cuda_ms(widened, 3)[0]}

    # bf16 against float32 through the encoder on 256 texts
    pick = rng.choice(n_docs, 256, replace=False)
    picked = [texts[i] for i in pick]
    q = emb.embed(picked)
    enc32 = bert.BertEncoder(cfg, compute_dtype="float32", device=dev)
    q32 = enc32.embed(picked, batch_size=128)
    del enc32
    cos = (q * q32).sum(1)
    self_err = float(np.abs(q - vecs[pick]).max())

    engine, row = rag_build_search(torch, dev, "rag_bert", texts, vecs, q,
                                   pick, counter)
    # how close the corpus vectors sit: random weights pool every text
    # near one direction, which is what the search has to separate
    sample = vecs[rng.choice(n_docs, 512, replace=False)]
    off = (sample @ sample.T)[~np.eye(512, dtype=bool)]

    # entry() on the card against its run on the CPU
    fn, args = entry(device=dev)
    ids, sc = fn(*args)
    torch.cuda.synchronize()
    cfn, cargs = entry(device="cpu")
    cids, csc = cfn(*cargs)
    with torch.no_grad():
        cq = bert.bert_forward(cargs[0], cargs[1], cargs[2],
                               bert.BertConfig.tiny())
    top = torch.sort(cq @ cargs[3][:-1].T, dim=1, descending=True)[0][:, :11]
    clear = ((top[:, 9] - top[:, 10]) > 1e-3).numpy()
    ids_np, cids_np = ids.cpu().numpy(), cids.numpy()
    same_sets = np.array([set(a.tolist()) == set(b.tolist())
                          for a, b in zip(ids_np, cids_np)])
    entry_row = {"shape": list(ids.shape), "rows_clear": int(clear.sum()),
                 "rows_equal_as_sets": int(same_sets.sum()),
                 "positions_equal": float((ids_np == cids_np).mean()),
                 "max_score_diff": float((sc.cpu() - csc).abs().max()),
                 "finite": bool(torch.isfinite(sc).all())}

    emit({"phase": "encode", "config": dataclasses.asdict(cfg),
          "tokens_per_text": int(mask.sum(1).max()), "padded_length": tlen,
          "init_s": init_s, "embed_s": embed_s,
          "texts_per_s": n_docs / (embed_ms / 1e3),
          "ms_per_batch": embed_ms / batches, "batch": 128,
          "forward_ms": forward_ms, "forward_f32_ms": forward_f32_ms,
          "forward_profile": forward_profile,
          "bf16_product": product,
          "bf16_vs_f32_cos_min": float(cos.min()),
          "query_vs_corpus_max_abs": self_err,
          "corpus_cos_mean": float(off.mean()),
          "corpus_cos_max": float(off.max()),
          "rag": row, "rag_fake": {k: fake_row[k] for k in (
              "self_hit1", "recall10", "recall10_at_complexity_64")},
          "entry": entry_row})
    if not np.isfinite(vecs).all() or vecs.shape != (n_docs, cfg.hidden_size):
        raise AssertionError("encode: embeddings not finite or misshapen")
    if float(cos.min()) < 0.999:
        raise AssertionError(f"encode: bf16 vs float32 cosine {cos.min()}")
    if product["max_abs_err"] > 1e-3:
        raise AssertionError(f"encode: bf16 product {product}")
    if row["self_hit1"] < ENCODE_MIN_HIT1 or row["recall10"] < ENCODE_MIN_RECALL:
        raise AssertionError(f"encode: rag on encoder vectors {row}")
    if row["launches_build"] <= 0 or row["launches_search"] <= 0:
        raise AssertionError("encode: the fused kernel was not launched")
    if (list(ids.shape) != [16, 10] or not entry_row["finite"]
            or not same_sets[clear].all() or clear.sum() < 4):
        raise AssertionError(f"encode: entry() {entry_row}")


def recompute_texts(n):
    """`evals/recompute_scale.py:76-80`'s passages."""
    return [f"passage {i} about subject {i % 911} topic {i % 101} "
            f"facet {i % 37} keyword{i % 7} detail {i}" for i in range(n)]


class TemplateProvider:
    """What `RecomputeSearcher` asks of a provider, over LocalEmbedding
    (no document template)."""

    def __init__(self, emb):
        self.emb = emb

    def embed_with_template(self, texts, template):
        if template is not None:
            raise ValueError("no document template in this phase")
        return self.emb.embed(texts)


def encoder_split(torch, engine, q, beam):
    """One search with CUDA events around each encoder forward: (device
    ms of the forwards, device ms of the whole search, forwards)."""
    from leann_tpu_torch.ops import beam as beam_mod

    forward, marks = beam_mod.bert_forward, []

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = forward(*args)
        end.record()
        marks.append((start, end))
        return out

    beam_mod.bert_forward = timed
    try:
        total, _ = cuda_ms(lambda: engine.search(q, k=10, beam_width=beam), 1)
    finally:
        beam_mod.bert_forward = forward
    return sum(a.elapsed_time(b) for a, b in marks), total, len(marks)


def agreement(a, b):
    """Two (ids, scores): rows with equal ids, and the largest score
    difference."""
    (ia, sa), (ib, sb) = a, b
    return {"rows": len(ia),
            "rows_ids_equal": int(np.all(ia == ib, axis=1).sum()),
            "max_score_diff": float(np.abs(sa - sb).max())}


def phase_recompute(torch, dev, n, counter):
    """BASELINE config 3: a pruned index searched by re-embedding the
    frontier with the encoder inside the traversal. bert-base widths
    (seeded random weights, hash tokenizer) at T=48 through
    LocalEmbedding; StreamingIndexBuilder with is_recompute (B1 runs the
    Vamana build at D=768) writes the token sidecar; the stored-vector
    search on the same graph (IndexSearcher -> FusedBeamEngine, B1);
    prune; GraphRecomputeSearcher on 256 stored rows at beams 32 and 64
    against the exact oracle on the stored vectors, each returned score
    against the stored vector's; dedup on / off and segments / one pass
    on 16 queries; RecomputeSearcher (brute force) under a one-facet
    filter. Returns (the stored search's FusedBeamEngine, the queries on
    the card, their ids) for `kernels_main`."""
    from leann_tpu_torch.embed import LocalEmbedding
    from leann_tpu_torch.index import (
        GraphRecomputeSearcher, IndexSearcher, MetadataFilter,
        RecomputeSearcher, SearchOptions, StreamingIndexBuilder,
    )
    from leann_tpu_torch.models.bert import BertConfig, BertEncoder
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.store.embeddings import embeddings_path, prune_embeddings
    from leann_tpu_torch.store.graphfile import graph_path
    from leann_tpu_torch.store.meta import IndexMeta, meta_path
    from leann_tpu_torch.store.passages import Passage
    from leann_tpu_torch.store.tokens import tokens_path
    from leann_tpu_torch.utils import METRICS

    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    texts = recompute_texts(n)
    enc = BertEncoder(BertConfig(), max_length=RECOMPUTE_T, seed=0, device=dev)
    t0 = time.perf_counter()
    vecs = LocalEmbedding(encoder=enc, batch_size=512).embed(texts)
    embed_s = time.perf_counter() - t0
    q_ids = np.random.default_rng(7).integers(0, n, 256)
    queries = vecs[q_ids]
    oracle_sc, oracle = exact_topk(queries, vecs, 11, metric="ip",
                                   device=dev)
    gap = oracle_sc[:, 9] - oracle_sc[:, 10]      # 10th less 11th score
    sample = vecs[np.random.default_rng(8).choice(n, 512, replace=False)]
    off = (sample @ sample.T)[~np.eye(512, dtype=bool)]

    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "indexes", "recompute", "documents.leann")
        builder = StreamingIndexBuilder(
            base, dim=enc.dimensions, backend="hnsw", metric="ip",
            embedding_model="bert-base (random weights, seed 0)",
            embedding_mode="local", is_recompute=True,
            tokenizer_encoder=enc, device=dev)
        for i, (t, v) in enumerate(zip(texts, vecs)):
            builder.add_passage(Passage(id=f"p{i}", text=t,
                                        metadata={"facet": i % 37}), v)
        METRICS.reset()
        c0, b0 = counter(), bm25_builds()
        t0 = time.perf_counter()
        builder.build(graph_degree=32, complexity=48)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        launches_build = counter() - c0
        bm25 = bm25_since(b0)
        spans = METRICS.snapshot()
        split = {k: spans[f"span.build.{k}.seconds"]["sum"]
                 for k in ("vamana", "tokens", "bm25")}

        # the stored-vector search on the same graph, before the prune
        searcher = IndexSearcher.load(base, device=dev)
        stored_engine = type(searcher.backend.engine).__name__
        c0 = counter()
        stored = {}
        for beam in RECOMPUTE_BEAMS:
            res = searcher.search(queries, SearchOptions(top_k=10,
                                                         complexity=beam))
            got = np.array([[int(h.id[1:]) for h in r] + [-1] * (10 - len(r))
                            for r in res])
            stored[beam] = (recall_at(got, oracle),
                            float(np.mean(got[:, 0] == q_ids)))
        launches_search = counter() - c0
        stored_eng = searcher.backend.engine
        del searcher

        n_tok = n * RECOMPUTE_T * 4 + n * 4          # token ids + lengths
        n_graph = n * 32 * 4
        sizes = {"stored_f32": os.path.getsize(embeddings_path(base)),
                 "tokens_and_lengths": n_tok, "graph": n_graph,
                 "tokens_file": os.path.getsize(tokens_path(base)),
                 "graph_file": os.path.getsize(graph_path(base))}
        sizes["stored_over_pruned"] = sizes["stored_f32"] / (n_tok + n_graph)
        freed = prune_embeddings(base)
        meta = IndexMeta.load(meta_path(base))
        meta.is_pruned = True
        meta.save(meta_path(base))

        t0 = time.perf_counter()
        graph = GraphRecomputeSearcher(base, enc, device=dev)
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
        engine = graph.engine
        top = graph.search(queries[0], top_k=10, complexity=RECOMPUTE_BEAMS[0])
        api_self_hit = bool(top) and top[0].id == f"p{q_ids[0]}"

        # dedup off / on and segments / one pass on the first 16 queries
        q16 = queries[:16]
        runs, rows_per_query = {}, {}
        for label, modes in (("dedup_off", dict(dedup=False)),
                             ("dedup_on", dict(dedup=True)),
                             ("segment_8", dict(segment_iters=8))):
            runs[label] = engine.search(q16, k=11,
                                        beam_width=RECOMPUTE_BEAMS[0], **modes)
            rows_per_query[label] = engine.last_stats["encoded_rows"] / 16
        dedup_ab = agreement(runs["dedup_on"], runs["dedup_off"])
        segment_ab = agreement(runs["dedup_on"], runs["segment_8"])
        dedup_ab["encoder_rows_per_query"] = rows_per_query

        rows = {}
        for beam in RECOMPUTE_BEAMS:
            t0 = time.perf_counter()
            ms, (idx, sc) = cuda_ms(
                lambda: engine.search(queries, k=10, beam_width=beam), 1)
            wall = time.perf_counter() - t0
            st = engine.last_stats
            live = idx >= 0
            want = np.einsum("bkd,bd->bk", vecs[np.where(live, idx, 0)],
                             queries)
            rows[beam] = {
                "recall10": recall_at(idx, oracle),
                "stored_recall10": stored[beam][0],
                "max_score_err": float(np.abs(sc - want)[live].max()),
                "returned": int(live.sum()), "wall_s": wall,
                "device_ms": ms, "qps": len(queries) / wall,
                "hops": st["hops"],
                "encoder_rows_per_query": st["encoded_rows"] / len(queries),
                "misses_per_query": st["misses"] / len(queries),
                "dedup_hit_rate": 1.0 - st["misses"] / st["slots"],
                "self_hit1": float(np.mean(idx[:, 0] == q_ids)),
                "stored_self_hit1": stored[beam][1]}
        enc_ms, search_ms, forwards = encoder_split(
            torch, engine, queries, RECOMPUTE_BEAMS[0])
        prof = profile(torch, lambda: engine.search(
            queries, k=10, beam_width=RECOMPUTE_BEAMS[0]), top=8, cpu=False)

        # brute force under a one-facet filter; the query is a kept
        # passage's own stored vector
        facet = int(q_ids[0] % 37)
        brute = RecomputeSearcher(base, TemplateProvider(
            LocalEmbedding(encoder=enc)), device=dev)
        t0 = time.perf_counter()
        res = brute.search(vecs[q_ids[0]], top_k=10,
                           filter=MetadataFilter.parse(f"facet={facet}"))
        brute_s = time.perf_counter() - t0
        brute_row = {"facet": facet, "kept": len(range(facet, n, 37)),
                     "seconds": brute_s,
                     "self_hit": bool(res) and res[0].id == f"p{q_ids[0]}",
                     "all_in_facet": all(r.metadata["facet"] == facet
                                         for r in res)}

    best = max(r["recall10"] for r in rows.values())
    score_err = max(r["max_score_err"] for r in rows.values())
    emit({"phase": "recompute", "n": n, "t": RECOMPUTE_T,
          "encoder": {"hidden": enc.config.hidden_size,
                      "layers": enc.config.num_layers,
                      "heads": enc.config.num_heads,
                      "intermediate": enc.config.intermediate_size,
                      "vocab": enc.config.vocab_size},
          "graph": {"r": 32, "l": 48, "passes": 2},
          "embed_s": embed_s, "texts_per_s": n / embed_s,
          "build_s": build_s, "build_split_s": split,
          "bm25_s_python_build": RECOMPUTE_BM25_S_PYTHON,
          "bm25_builds": bm25,
          "launches_build": launches_build,
          "stored_engine": stored_engine,
          "launches_stored_search": launches_search,
          "bytes": sizes, "embeddings_freed": freed,
          "engine_init_s": engine_s,
          "seed_pool": int(engine.seed_ids.numel()),
          "api_self_hit": api_self_hit, "beams": rows,
          "oracle_gap_10_11": {"median": float(np.median(gap)),
                               "share_below_1e-3": float(np.mean(gap < 1e-3))},
          "corpus_cos_mean": float(off.mean()),
          "corpus_cos_max": float(off.max()),
          "encoder_split_beam32": {"encoder_ms": enc_ms,
                                   "search_ms": search_ms,
                                   "forwards": forwards,
                                   "traversal_ms": search_ms - enc_ms},
          "profile_beam32": prof, "dedup_ab": dedup_ab,
          "segment_ab": segment_ab, "brute_force": brute_row,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "phase_s": time.perf_counter() - t_phase, "gpu": smi()})
    if not np.isfinite(vecs).all() or vecs.shape != (n, enc.dimensions):
        raise AssertionError("recompute: embeddings not finite or misshapen")
    check_bm25("recompute", bm25)
    if best < RECOMPUTE_MIN_RECALL:
        raise AssertionError(f"recompute: recall@10 {best} at the better beam")
    if not score_err <= RECOMPUTE_SCORE_TOL:
        raise AssertionError(f"recompute: a returned score is {score_err} "
                             "from its stored vector's")
    # dedup on / off encode each row in batches of other sizes; the first
    # card runs gave equal ids and scores, as segments must by construction
    for label, ab in (("dedup", dedup_ab), ("segment", segment_ab)):
        if ab["rows_ids_equal"] != ab["rows"] or ab["max_score_diff"] != 0.0:
            raise AssertionError(f"recompute: {label} on / off {ab}")
    if not (brute_row["self_hit"] and brute_row["all_in_facet"]):
        raise AssertionError(f"recompute: brute-force self-hit {brute_row}")
    if launches_build <= 0 or launches_search <= 0:
        raise AssertionError("recompute: the fused kernel was not launched "
                             f"(build {launches_build}, stored search "
                             f"{launches_search})")
    return (stored_eng, torch.from_numpy(np.ascontiguousarray(
        queries, np.float32)).to(dev), torch.from_numpy(q_ids).to(dev))


def phase_sharded(torch, dev, n, counter, sift, rag_base, rag_q, pick):
    """Sharded search (`leann_tpu_torch.parallel`) over SHARDS shards of
    the sift phase's corpus on one card: ShardedFlatIndex against the
    exact oracle, also on a (2, 2) mesh; ShardedGraphIndex with the auto
    engine (B1 in the per-shard builds and the search) and with B3 on the
    same subgraphs; ShardedIvfIndex and ShardedIvf8Index at nprobe 8;
    then `load_searcher(sharded=True)` twice on the rag phase's index
    (the second load reuses `.shards.npz`). Returns (the fused index, the
    B3 index, a batch of 2048 queries on the card)."""
    from leann_tpu_torch.backend import load_searcher
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.parallel import (
        ShardedFlatIndex, ShardedGraphIndex, ShardedIvf8Index,
        ShardedIvfIndex, make_mesh,
    )
    from leann_tpu_torch.store import shardfile
    from leann_tpu_torch.store.meta import IndexMeta, meta_path

    t_phase = time.perf_counter()
    fb, pb = FUSED["name"], PQ["name"]
    corpus, queries = sift["corpus"][:n], sift["queries"]
    oracle = sift["oracle"] if n == len(sift["corpus"]) else exact_topk(
        queries, corpus, 10, metric="l2", device=dev)[1]
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh((1, SHARDS), devices=[dev] * SHARDS)
    r, build_l, beam, batch, m = 48, 80, 64, 2048, 4
    rows = {}

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def launches(fn, *names):
        c0 = {k: counter(k) for k in names}
        out = fn()
        torch.cuda.synchronize()
        return out, {k: counter(k) - c0[k] for k in names}

    flat, init_s = timed(lambda: ShardedFlatIndex(corpus, mesh, "l2"))
    (fi, _), search_s = timed(lambda: flat.search(queries, k=10))
    mesh22 = make_mesh((2, 2), devices=[dev] * SHARDS)
    fi22, _ = ShardedFlatIndex(corpus, mesh22, "l2").search(queries, k=10)
    rows["flat"] = {"init_s": init_s, "search_s": search_s,
                    "recall10": recall_at(fi, oracle),
                    "ids_equal_2x2": bool(np.array_equal(fi, fi22))}
    del flat

    (graph, t_graph), got = launches(lambda: timed(lambda: ShardedGraphIndex(
        corpus, mesh, "l2", graph_degree=r, complexity=build_l, alpha=1.2,
        build_wave_size=8192)), fb, pb)
    # pack alone: a second auto index on the saved subgraphs
    again, pack_s = timed(lambda: ShardedGraphIndex(
        corpus, mesh, "l2", graph_degree=r,
        adjacency_shards=graph.adjacency_shards, medoids=graph.medoids_host))
    del again
    (gi, _), got_s = launches(lambda: graph.search(queries, k=10,
                                                   beam_width=beam), fb, pb)
    windows = [torch.from_numpy(noisy_rows(corpus, (m, batch), 1000 + w)).to(dev)
               for w in range(3)]
    per_batch, qps = qps_windows(torch, lambda q: graph.search_device(
        q, k=10, beam_width=beam), windows)
    rows["graph"] = {
        "engine": graph.engine, "build_s": t_graph - pack_s,
        "pack_s": pack_s, "recall10": recall_at(gi, oracle),
        "launches_build": got[fb], "launches_search": got_s[fb],
        "launches_pq": got[pb] + got_s[pb], "beam": beam, "batch": batch,
        "ms_per_batch": per_batch, "qps_windows": qps,
        "qps_mean": float(np.mean(qps)),
        "sift_one_device_qps_mean": sift["qps_mean"],
        "profile": profile(torch, lambda: [graph.search_device(
            q, k=10, beam_width=beam) for q in windows[1]])}

    (pq, pq_s), got = launches(lambda: timed(lambda: ShardedGraphIndex(
        corpus, mesh, "l2", graph_degree=r, engine="pq",
        adjacency_shards=graph.adjacency_shards,
        medoids=graph.medoids_host)), fb, pb)
    (pi, _), got_s = launches(lambda: pq.search(queries, k=10,
                                                beam_width=beam), fb, pb)
    rows["pq"] = {"engine": pq.engine, "init_s": pq_s, "m": pq.pq_m,
                  "recall10": recall_at(pi, oracle),
                  "launches_init": got[fb] + got[pb],
                  "launches_search": got_s[pb],
                  "launches_fused": got_s[fb]}

    for name, make, kw in (
            ("ivf", lambda: ShardedIvfIndex(
                corpus, mesh, "l2", n_clusters=IVF_CLUSTERS // SHARDS), {}),
            ("ivf8", lambda: ShardedIvf8Index(corpus, mesh, "l2"), {})):
        (index, init_s), got = launches(lambda: timed(make), fb, pb)
        ((ii, _), search_s), got_s = launches(lambda: timed(
            lambda: index.search(queries, k=10, nprobe=NPROBE, **kw)),
            DOTS["name"], TOPC["name"])
        rows[name] = {"init_s": init_s, "search_s": search_s,
                      "buckets": index.n_buckets, "nprobe": NPROBE,
                      "recall10": recall_at(ii, oracle),
                      "launches": sum(got.values()),
                      "launches_search": got_s}
        del index

    meta = IndexMeta.load(meta_path(rag_base))
    rag_qh = rag_q.cpu().numpy()
    loads = []
    for _ in range(2):
        (s_, load_s), got = launches(lambda: timed(lambda: load_searcher(
            rag_base, meta, sharded=True, device=dev)), fb, pb)
        (idx, sc), search_s = timed(lambda: s_.search(rag_qh, k=10))
        loads.append({"load_s": load_s, "search_s": search_s,
                      "launches_load": got[fb], "n_shards": s_.n_shards,
                      "engine": s_.index.engine, "ids": idx, "scores": sc,
                      "mtime": os.path.getmtime(shardfile.shards_path(
                          rag_base))})
        del s_
    hit1 = float(np.mean(loads[0]["ids"][:, 0] == pick))
    rows["rag"] = {
        "self_hit1": hit1,
        "reload_equal": bool(
            np.array_equal(loads[0]["ids"], loads[1]["ids"])
            and np.array_equal(loads[0]["scores"], loads[1]["scores"])),
        "sidecar_reused": loads[0]["mtime"] == loads[1]["mtime"]
        and loads[1]["launches_load"] == 0,
        **{f"load{i}_{k}": v for i, ld in enumerate(loads)
           for k, v in ld.items() if k not in ("ids", "scores", "mtime")}}
    emit({"phase": "sharded", "n": n, "d": corpus.shape[1],
          "shards": SHARDS, "mesh": mesh.shape, "r": r, "build_l": build_l,
          "queries": len(queries), **rows,
          "peak_bytes": torch.cuda.max_memory_allocated(dev),
          "bytes_before": base_bytes,
          "phase_s": time.perf_counter() - t_phase})

    bad = []
    if rows["flat"]["recall10"] < SHARDED_FLAT_MIN_RECALL or \
            not rows["flat"]["ids_equal_2x2"]:
        bad.append("flat")
    g = rows["graph"]
    if g["engine"] != "fused" or g["recall10"] < SHARDED_MIN_RECALL or \
            g["launches_build"] <= 0 or g["launches_search"] <= 0 or \
            g["launches_pq"]:
        bad.append("graph")
    if rows["pq"]["recall10"] < SHARDED_PQ_MIN_RECALL or \
            rows["pq"]["launches_search"] <= 0 or rows["pq"]["launches_fused"]:
        bad.append("pq")
    if rows["ivf"]["recall10"] < SHARDED_IVF_MIN_RECALL or \
            rows["ivf"]["launches"] or \
            min(rows["ivf"]["launches_search"].values()) <= 0:
        bad.append("ivf")
    if rows["ivf8"]["recall10"] < SHARDED_IVF8_MIN_RECALL or \
            rows["ivf8"]["launches"] or \
            max(rows["ivf8"]["launches_search"].values()):
        bad.append("ivf8")
    if hit1 < 0.99 or not rows["rag"]["reload_equal"] or \
            not rows["rag"]["sidecar_reused"] or loads[0]["n_shards"] != 1:
        bad.append("rag")
    if bad:
        raise AssertionError(f"sharded: {bad} failed their gates")
    return graph, pq, windows[0][0]


def unique_pair(texts, j):
    """Two words of texts[j] that occur together in no other passage (the
    rag corpus: random words of a 5,000-word vocabulary)."""
    post = defaultdict(set)
    for i, t in enumerate(texts):
        for w in t.split()[2:]:
            post[w].add(i)
    words = [w for w in dict.fromkeys(texts[j].split()[2:])
             if texts[j].split().count(w) == 1]
    for a in range(len(words)):
        for b in range(a + 1, len(words)):
            if post[words[a]] & post[words[b]] == {j}:
                return words[a], words[b]
    raise AssertionError(f"api: passage {j} holds no unique word pair")


def phase_api(torch, dev, n_docs, counter, base, q, pick, rag_row):
    """The library surface on the rag phase's index (BASELINE config 0),
    through the calls a user makes: `open_index(dir, device=dev)` (the
    provider rebuilt from the meta), `Index.search` one text per call,
    `Index.search_vectors` on the batch, a filter, auto hybrid and
    expansion, `AskSession` and `ReActAgent` with the simulated LLM; then
    a pruned `local-tiny` index, which `Index.search` must serve through
    `GraphRecomputeSearcher`. B1 serves every stored-vector search."""
    from leann_tpu_torch import open_index
    from leann_tpu_torch.agent.react import ReActAgent, parse_action
    from leann_tpu_torch.embed import EmbeddingProvider
    from leann_tpu_torch.index import IndexSearcher, StreamingIndexBuilder
    from leann_tpu_torch.index.recompute import GraphRecomputeSearcher
    from leann_tpu_torch.llm import LlmProvider
    from leann_tpu_torch.ops.distance import ExactEngine
    from leann_tpu_torch.rag.ask import AskSession
    from leann_tpu_torch.store.embeddings import EmbeddingsStore, prune_embeddings
    from leann_tpu_torch.store.meta import IndexMeta, meta_path
    from leann_tpu_torch.store.passages import Passage

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev)   # what earlier phases hold
    row, bad, steps_s = {}, [], {}
    t_step = [t_phase]

    def lap(name):
        now = time.perf_counter()
        steps_s[name] = now - t_step[0]
        t_step[0] = now

    _, texts = rag_texts(n_docs)
    lap("texts")

    # 1. open by directory; the first search loads and packs the engine
    idx = open_index(os.path.dirname(base), device=dev)
    row["provider"] = [idx.provider.mode, idx.provider.dimensions]
    if row["provider"] != ["fake", q.shape[1]]:
        bad.append("provider from the meta")
    c0 = counter()
    t0 = time.perf_counter()
    idx.search(texts[pick[0]], top_k=10, hybrid=False, expand=False)
    row["first_search_s"] = time.perf_counter() - t0
    row["engine"] = type(idx._stored_searcher().backend.engine).__name__

    # 2. one text per call
    wall, hits = [], []
    for i in pick:
        t0 = time.perf_counter()
        res = idx.search(texts[i], top_k=10, hybrid=False, expand=False)
        wall.append((time.perf_counter() - t0) * 1e3)
        hits.append(bool(res) and res[0].id == f"p{i}")
    row["text_self_hit1"] = float(np.mean(hits))
    row["text_ms_p50"], row["text_ms_p99"] = (
        float(np.percentile(wall, 50)), float(np.percentile(wall, 99)))
    row["launches_text"] = counter() - c0
    if row["text_self_hit1"] < 0.99:
        bad.append("text self-hit@1")
    lap("open_and_text")

    # 3. the batch of vectors: the rag phase's engine and batch
    qh = q.cpu().numpy()
    vecs = np.asarray(EmbeddingsStore(base, qh.shape[1]).all())
    oracle = ExactEngine(vecs, metric="ip", device=dev).search(
        qh, k=10, exact_scan=True)[0]
    c0 = counter()
    res = idx.search_vectors(qh, top_k=10, complexity=64)
    got = [[int(h.id[1:]) for h in r] + [-1] * (10 - len(r)) for r in res]
    row["vectors_recall10"] = recall_at(got, oracle)
    row["rag_recall10_at_64"] = rag_row["recall10_at_complexity_64"]
    if abs(row["vectors_recall10"] - row["rag_recall10_at_64"]) > 0.002:
        bad.append("search_vectors recall")
    windows = [np.stack([qh, qh]) for _ in range(3)]
    ms, qps = qps_windows(
        torch, lambda x: idx.search_vectors(x, top_k=10, complexity=64),
        windows)
    row["vectors_ms_per_batch"], row["vectors_qps"] = ms, qps
    engine = idx._stored_searcher().backend
    ms, qps = qps_windows(
        torch, lambda x: engine.search(x, k=50, complexity=64), windows)
    row["engine_ms_per_batch"], row["engine_qps"] = ms, qps
    row["launches_vectors"] = counter() - c0
    lap("vectors")

    # 4. a filter, auto hybrid on two words, expansion
    c0 = counter()
    ok, n_hits = True, []
    for i in pick[:32]:
        res = idx.search(texts[i], top_k=10, filter="n<10000", hybrid=False,
                         expand=False)
        n_hits.append(len(res))
        ok &= bool(res) and all(h.metadata["n"] < 10000 for h in res)
    row["filter_ok"], row["filter_hits_mean"] = ok, float(np.mean(n_hits))
    if not ok:
        bad.append("filter")
    j = int(pick[1])
    pair = " ".join(unique_pair(texts, j))
    res = idx.search(pair, top_k=10, expand=False, hybrid_alpha=0.2)
    row["hybrid_query"], row["hybrid_top"] = pair, res[0].id if res else None
    if row["hybrid_top"] != f"p{j}":
        bad.append("hybrid")
    fired = []
    idx.search(pair, top_k=10, on_expand=fired.append)
    row["expanded"] = fired
    if fired != [idx._stored_searcher().expand_query(pair)]:
        bad.append("expand")
    row["launches_filter_hybrid"] = counter() - c0
    lap("filter_hybrid_expand")

    # 5. RAG and the agent over a searcher of their own
    c0 = counter()
    searcher = IndexSearcher.load(base, device=dev)
    llm = LlmProvider("simulated")
    session = AskSession(searcher, idx.provider, llm)
    asked = [session.ask(texts[i]) for i in pick[:8]]
    row["ask_first_source_ok"] = sum(
        a.sources[0].id == f"p{i}" for a, i in zip(asked, pick[:8]))
    if row["ask_first_source_ok"] != 8:
        bad.append("ask")
    agent = ReActAgent(searcher, idx.provider, llm, max_steps=4)
    answer, steps = agent.run(f"which passage mentions {pair}?")
    last = parse_action(steps[-1].thought_action)
    row["agent_steps"] = len(steps)
    row["agent_observation"] = (steps[0].observation or "")[:80]
    if not (len(steps) <= agent.max_steps and last is not None
            and last.kind == "finish" and last.arg == answer
            and "(p" in (steps[0].observation or "")):
        bad.append("agent")
    row["launches_rag_agent"] = counter() - c0
    del searcher, idx, engine
    lap("rag_agent")

    # 6. a pruned local-tiny index: Index picks the graph recompute path
    with tempfile.TemporaryDirectory() as tmp:
        pbase = os.path.join(tmp, "indexes", "pruned", "documents.leann")
        ptexts = recompute_texts(2000)
        prov = EmbeddingProvider(mode="local", model="local-tiny", device=dev)
        builder = StreamingIndexBuilder(
            pbase, dim=prov.dimensions, backend="hnsw", metric="ip",
            embedding_model="local-tiny", embedding_mode="local",
            is_recompute=True, tokenizer_encoder=prov._impl.encoder,
            device=dev)
        for i, (t, v) in enumerate(zip(ptexts, prov.embed(ptexts))):
            builder.add_passage(Passage(id=f"p{i}", text=t,
                                        metadata={"facet": i % 37}), v)
        c0 = counter()
        t0 = time.perf_counter()
        builder.build(graph_degree=32, complexity=48)
        row["pruned_build_s"] = time.perf_counter() - t0
        row["launches_pruned_build"] = counter() - c0
        prune_embeddings(pbase)
        meta = IndexMeta.load(meta_path(pbase))
        meta.is_pruned = True
        meta.save(meta_path(pbase))
        pidx = open_index(os.path.dirname(pbase), device=dev)
        sel = np.random.default_rng(3).choice(len(ptexts), 64, replace=False)
        lap("pruned_build")
        res, wall = [], []
        for i in sel:
            t0 = time.perf_counter()
            res.append(pidx.search(ptexts[i], top_k=10))
            wall.append((time.perf_counter() - t0) * 1e3)
        row["pruned_first_ms"] = wall[0]
        row["pruned_ms_p50"], row["pruned_ms_p99"] = (
            float(np.percentile(wall, 50)), float(np.percentile(wall, 99)))
        row["pruned_last_stats"] = dict(
            pidx._recompute_searcher().engine.last_stats)
        row["pruned_searcher"] = type(pidx._recompute_searcher()).__name__
        row["pruned_self_hit1"] = float(np.mean(
            [bool(r) and r[0].id == f"p{i}" for r, i in zip(res, sel)]))
        if not isinstance(pidx._recompute_searcher(), GraphRecomputeSearcher):
            bad.append("pruned searcher")
        if row["pruned_self_hit1"] < 0.99:
            bad.append("pruned self-hit@1")
        del pidx, prov, builder
    lap("pruned_search")

    emit({"phase": "api", "n": n_docs, "queries": len(pick), **row,
          "steps_s": steps_s,
          "peak_bytes": torch.cuda.max_memory_allocated(dev),
          "bytes_before": base_bytes,
          "phase_s": time.perf_counter() - t_phase})
    if bad:
        raise AssertionError(f"api: {bad} failed their gates")
    return row


CLI_SEARCHES = 32      # texts per `search` pass (CLI index, rag index)
CLI_PRUNED_SEARCHES = 4  # searches through the recompute path after prune
CLI_UPDATE_FILES = 200
CLI_HTTP_REQUESTS = 256
CLI_HTTP_CLIENTS = 32


def cli_ok(argv):
    """The port's CLI in process, `main(argv)`: its stdout; raises unless
    the command exits 0."""
    import contextlib
    import io

    from leann_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"cli: {argv[:4]} exited {rc}: "
                             f"{buf.getvalue()[-500:]}")
    return buf.getvalue()


def cli_search(dev, text, index, **kw):
    """`search` as JSON, top-10 at complexity 64, no expansion, no auto
    hybrid: (ids, host ms)."""
    argv = ["--device", str(dev), "search", text, "-i", index,
            "--format", "json", "--top-k", "10", "--complexity", "64",
            "--no-expand", "--no-auto-hybrid"]
    t0 = time.perf_counter()
    out = cli_ok(argv)
    ms = (time.perf_counter() - t0) * 1e3
    return [r["id"] for r in json.loads(out)], ms


def build_listing():
    """(name, size, mtime) of every file in the kernels' build directory."""
    from leann_tpu_torch.ops import _cuda

    if not os.path.isdir(_cuda.BUILD_DIR):
        return []
    return sorted((f, os.stat(os.path.join(_cuda.BUILD_DIR, f)).st_size,
                   os.stat(os.path.join(_cuda.BUILD_DIR, f)).st_mtime_ns)
                  for f in os.listdir(_cuda.BUILD_DIR))


# The HTTP clients run in a process of their own, so that their threads do
# not share the server's interpreter lock: argv host, port, clients; the
# JSON bodies on stdin; out, one JSON object: the replies in order, the
# wall ms of each request and of the whole burst.
HTTP_CLIENT = r"""
import http.client, json, sys, threading, time
from concurrent.futures import ThreadPoolExecutor

host, port, clients = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
bodies = json.load(sys.stdin)
local = threading.local()


def post(body):
    conn = getattr(local, "conn", None)
    if conn is None:
        conn = local.conn = http.client.HTTPConnection(host, port, timeout=60)
    data = json.dumps(body).encode()
    t0 = time.perf_counter()
    conn.request("POST", "/search", body=data,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    reply = json.loads(resp.read())
    return resp.status, reply, (time.perf_counter() - t0) * 1e3


t0 = time.perf_counter()
with ThreadPoolExecutor(clients) as pool:
    out = list(pool.map(post, bodies))
wall = (time.perf_counter() - t0) * 1e3
json.dump({"status": [o[0] for o in out], "replies": [o[1] for o in out],
           "ms": [o[2] for o in out], "wall_ms": wall}, sys.stdout)
"""


def http_burst(url, bodies, clients):
    """POST each body to url/search from `clients` threads of a client
    process, each thread on its own keep-alive connection: (replies in
    order, wall ms per request, wall s of the burst)."""
    from urllib.parse import urlparse

    u = urlparse(url)
    proc = subprocess.run(
        [sys.executable, "-c", HTTP_CLIENT, u.hostname, str(u.port),
         str(clients)], input=json.dumps(bodies), capture_output=True,
        text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"cli: HTTP client failed: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout)
    if any(st != 200 for st in out["status"]):
        raise AssertionError(f"cli: POST /search statuses {set(out['status'])}")
    return out["replies"], out["ms"], out["wall_ms"] / 1e3


def phase_cli(torch, dev, n_docs, counter, rag_base, pick, rag_row):
    """The CLI and the servers on BASELINE config 0, through
    `leann_tpu_torch.cli.main.main(argv)` with `--device <dev>`, in a
    temporary working directory and HOME: `build` of the rag phase's
    20,000 texts written one per file (fake 768-d, hnsw -> vamana: B1
    serves the build's waves), `search` one text per call on the CLI index
    (self-hit@1 on the text's own file) and on the rag index by its
    directory (ids equal to `Index.search`'s), one `python -m
    leann_tpu_torch search` subprocess (ids equal, kernels loaded from
    `_build/`, not rebuilt), `ask` / `react` with the simulated LLM,
    `update` with 200 files, `reindex --backend-name ivf`, `prune`, `list`,
    `remove`, `config path`; then `serve`'s `ServerState` over the rag
    index (warm, 256 requests from 32 clients coalesced by the
    MicroBatcher, a batch of 64, /health /info /metrics) and `mcp`'s
    `McpServer.handle`. B1 must launch, and B4 and ivf_topc (the ivf
    index's calibration and searches after `reindex`), no other kernel.
    Returns the row, with the flush size the HTTP traffic produced most
    often."""
    import collections
    import threading

    from leann_tpu_torch import open_index
    from leann_tpu_torch.cli.common import (
        provider_from_meta, resolve_query_template,
    )
    from leann_tpu_torch.index import IndexSearcher, SearchOptions
    from leann_tpu_torch.server.http import ServerState, serve
    from leann_tpu_torch.server.mcp import McpServer
    from leann_tpu_torch.store.meta import IndexMeta, meta_path
    from leann_tpu_torch.utils import METRICS

    t_phase = time.perf_counter()
    b0 = bm25_builds()
    row, bad, steps_s, launches = {}, [], {}, {}
    t_step = [t_phase]
    c_step = [counter()]

    def lap(name):
        now = time.perf_counter()
        steps_s[name] = now - t_step[0]
        launches[name] = counter() - c_step[0]
        t_step[0], c_step[0] = now, counter()

    def p(q):
        return float(np.percentile(q, 50)), float(np.percentile(q, 99))

    d = str(dev)
    rag_dir = os.path.dirname(rag_base)
    _, texts = rag_texts(n_docs)
    sel = [int(i) for i in pick[:CLI_SEARCHES]]
    saved_cwd = os.getcwd()
    saved_env = {k: os.environ.get(k) for k in ("HOME", "XDG_CONFIG_HOME")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        os.chdir(tmp)
        os.environ["HOME"] = os.path.join(tmp, "home")
        os.environ["XDG_CONFIG_HOME"] = os.path.join(tmp, "home", ".config")
        os.makedirs("docs")
        for i, t in enumerate(texts):
            with open(os.path.join("docs", f"p{i}.txt"), "w") as f:
                f.write(t)
        lap("write_files")

        # 1. build: config 0 through the CLI
        t0 = time.perf_counter()
        cli_ok(["--device", d, "build", "cli", "--docs", "docs",
                "--embedding-mode", "fake", "--embedding-dimensions", "768"])
        row["build_s"] = time.perf_counter() - t0
        row["rag_build_s"] = rag_row["build_s"]
        meta = IndexMeta.load(meta_path(os.path.join(
            ".leann", "indexes", "cli", "documents.leann")))
        row["build_meta"] = [meta.backend_name, meta.passage_count,
                             meta.dimensions, meta.backend_kwargs]
        if meta.passage_count != n_docs or meta.backend_name != "vamana":
            bad.append("build meta")
        lap("build")

        # 2. search one text per call: the CLI index, then the rag index
        hits, wall = [], []
        for i in sel:
            ids, ms = cli_search(dev, texts[i], "cli")
            hits.append(bool(ids) and ids[0] == f"docs/p{i}.txt#0")
            wall.append(ms)
        row["search_self_hit1"] = float(np.mean(hits))
        row["search_ms_p50"], row["search_ms_p99"] = p(wall)
        if row["search_self_hit1"] < 0.99:
            bad.append("search self-hit@1")
        lap("search_cli_index")
        idx = open_index(rag_dir, device=dev)
        same, wall = 0, []
        for i in sel:
            ids, ms = cli_search(dev, texts[i], rag_dir)
            want = [h.id for h in idx.search(texts[i], top_k=10,
                                             complexity=64, hybrid=False,
                                             expand=False)]
            same += ids == want
            wall.append(ms)
        row["rag_ids_equal_index"] = same
        row["rag_search_ms_p50"], row["rag_search_ms_p99"] = p(wall)
        if same != len(sel):
            bad.append("search ids against Index.search")
        lap("search_rag_index")

        # 3. one subprocess: a fresh interpreter loads the built kernels
        j = sel[0]
        argv = ["--device", d, "search", texts[j], "-i", rag_dir,
                "--format", "json", "--top-k", "10"]
        want = [r["id"] for r in json.loads(cli_ok(argv))]
        listing = build_listing()
        env = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "leann_tpu_torch"]
                              + argv, capture_output=True, text=True,
                              env=env, timeout=300)
        row["subprocess_s"] = time.perf_counter() - t0
        row["subprocess_rc"] = proc.returncode
        got = ([r["id"] for r in json.loads(proc.stdout)]
               if proc.returncode == 0 else None)
        row["subprocess_ids_equal"] = got == want
        row["subprocess_build_dir_unchanged"] = build_listing() == listing
        if proc.returncode != 0:
            log(proc.stderr[-2000:])
        if not (proc.returncode == 0 and got == want
                and row["subprocess_build_dir_unchanged"]):
            bad.append("subprocess")
        lap("subprocess")

        # 4. ask and react with the simulated LLM on the rag index
        out = cli_ok(["--device", d, "ask", texts[j], "-i", rag_dir,
                      "--llm", "simulated", "--show-sources"])
        first = out.split("Sources:")[-1].split()
        row["ask_first_source"] = first[1] if len(first) > 1 else None
        if row["ask_first_source"] != f"p{j}":
            bad.append("ask")
        out = cli_ok(["--device", d, "react", texts[j], "-i", rag_dir,
                      "--llm", "simulated", "--show-steps"])
        # the simulated agent searches its own canned query once, then
        # finishes: its observation must list IndexSearcher's hits for it
        obs = [ln.split("(")[1].split(")")[0] for ln in out.splitlines()
               if ln.startswith(("Observation: [", "[")) and "(" in ln]
        searcher = IndexSearcher.load(rag_base, device=dev)
        agent_q = idx.embed(["simulated query"])
        want = [h.id for h in searcher.search(
            agent_q, SearchOptions(top_k=3, complexity=64))[0]]
        row["react_hits"] = obs
        if obs != want or "--- answer ---" not in out:
            bad.append("react")
        lap("ask_react")

        # 5. update, reindex to ivf, prune; list, remove, config path
        rng = np.random.default_rng(12)
        words = np.array([f"w{i}" for i in range(5000)])
        new = [f"update {i}: " + " ".join(rng.choice(words, 24))
               for i in range(CLI_UPDATE_FILES)]
        for i, t in enumerate(new):
            with open(os.path.join("docs", f"u{i}.txt"), "w") as f:
                f.write(t)
        t0 = time.perf_counter()
        out = cli_ok(["--device", d, "update", "cli", "--docs", "docs"])
        row["update_s"] = time.perf_counter() - t0
        row["update_out"] = out.strip().splitlines()[-1]
        got = sum(cli_search(dev, new[i], "cli")[0][:1] == [f"docs/u{i}.txt#0"]
                  for i in range(16))
        row["update_self_hit"] = got
        if got != 16:
            bad.append("update")
        lap("update")
        t0 = time.perf_counter()
        out = cli_ok(["--device", d, "reindex", "cli", "--backend-name",
                      "ivf", "--rebuild-bm25"])
        row["reindex_ivf_s"] = time.perf_counter() - t0
        row["reindex_out"] = out.strip().splitlines()[1:]
        got = sum(cli_search(dev, texts[i], "cli")[0][:1]
                  == [f"docs/p{i}.txt#0"] for i in sel[:16])
        row["ivf_self_hit"] = got
        if got != 16:
            bad.append("reindex ivf")
        lap("reindex_ivf")
        row["prune_out"] = cli_ok(["prune", "cli", "-y"]).strip()
        wall = []
        got = 0
        for i in sel[:CLI_PRUNED_SEARCHES]:
            ids, ms = cli_search(dev, texts[i], "cli")
            got += ids[:1] == [f"docs/p{i}.txt#0"]
            wall.append(ms)
        row["pruned_self_hit"], row["pruned_ms_mean"] = got, float(
            np.mean(wall))
        if got != CLI_PRUNED_SEARCHES:
            bad.append("prune")
        lap("prune")
        listed = cli_ok(["list"])
        removed = cli_ok(["remove", "cli", "-y"])
        cfg = cli_ok(["config", "path"])
        row["list_remove_config"] = [listed.split()[0], removed.strip(),
                                     cfg.strip().endswith("config.toml")]
        lap("list_remove_config")
        # build, update and reindex --rebuild-bm25 each build BM25 once;
        # counted before the serve step resets METRICS
        row["bm25_builds"] = bm25_since(b0)
        if row["bm25_builds"] != {"native": 3, "python": 0}:
            bad.append("bm25 builds")

        # 6. serve: ServerState as serve_cmd.run builds it
        meta = IndexMeta.load(meta_path(rag_base))
        provider = provider_from_meta(meta, device=dev)
        template = resolve_query_template(None, meta)
        state = ServerState(IndexSearcher.load(rag_base, device=dev),
                            provider, template, "rag", max_batch=64,
                            batch_window_ms=2)
        server = None
        try:
            t0 = time.perf_counter()
            row["warm_searches"] = state.warm()
            row["warm_s"] = time.perf_counter() - t0
            if row["warm_searches"] != 7:
                bad.append("warm")
            server = serve(state, port=0)
            threading.Thread(target=server.serve_forever,
                             daemon=True).start()
            url = f"http://127.0.0.1:{server.server_address[1]}"
            order = [int(i) for i in pick[:CLI_HTTP_REQUESTS]]
            METRICS.reset()
            c0 = counter()
            replies, wall, row["http_s"] = http_burst(url, [
                {"query": texts[i], "top_k": 10, "hybrid": False}
                for i in order], CLI_HTTP_CLIENTS)
            row["http_qps"] = len(order) / row["http_s"]
            row["http_launches"] = counter() - c0
            snap = METRICS.snapshot()
            sizes = collections.Counter(
                int(s) for s in METRICS.samples("batch.flush_size"))
            groups = int(snap["batch.groups_per_flush"]["sum"])
            row["http_self_hit1"] = float(np.mean([
                bool(r["results"]) and r["results"][0]["id"] == f"p{i}"
                for r, i in zip(replies, order)]))
            row["http_ms_p50"], row["http_ms_p99"] = p(wall)
            row["flushes"] = int(snap["batch.flushes"]["value"])
            row["flush_groups"] = groups
            row["flush_size_mean"] = snap["batch.flush_size"]["avg"]
            row["flush_sizes"] = dict(sorted(sizes.items()))
            row["flush_size_mode"] = max(sizes, key=lambda s: (sizes[s], s))
            row["embed_ms_mean"] = snap["batch.embed_ms"]["avg"]
            row["group_ms_mean"] = snap["batch.group_ms"]["avg"]
            if row["http_self_hit1"] < 0.99:
                bad.append("http self-hit@1")
            if not row["flushes"] < CLI_HTTP_REQUESTS:
                bad.append("http flushes")
            if not 0 < row["http_launches"] <= groups:
                bad.append("http launches")
            batch = [texts[i] for i in order[:64]]
            reply, _, _ = http_burst(url, [{"queries": batch, "top_k": 10,
                                            "hybrid": False}], 1)
            vecs = provider.embed_with_template(batch, template)
            want = [[h.id for h in r] for r in state.searcher.search(
                vecs, SearchOptions(top_k=10, complexity=64))]
            got = [[h["id"] for h in r]
                   for r in reply[0]["results_per_query"]]
            row["http_batch64_ids_equal"] = got == want
            if got != want:
                bad.append("http batch of 64")
            import urllib.request

            for path in ("/health", "/info", "/metrics"):
                with urllib.request.urlopen(url + path, timeout=30) as r:
                    body = r.read().decode()
                    if r.status != 200:
                        bad.append(f"GET {path}")
            row["metrics_has_search_requests"] = "search_requests" in body
            if not row["metrics_has_search_requests"]:
                bad.append("/metrics")
        finally:
            if server is not None:
                server.shutdown()
                server.server_close()
            state.batcher.close()
        lap("serve")

        # 7. mcp
        mcp = McpServer(default_index=rag_dir, device=dev)
        init = mcp.handle({"jsonrpc": "2.0", "id": 1, "method": "initialize",
                           "params": {}})
        tools = mcp.handle({"jsonrpc": "2.0", "id": 2,
                            "method": "tools/list"})
        k = sel[1]
        reply = mcp.handle({"jsonrpc": "2.0", "id": 3, "method": "tools/call",
                            "params": {"name": "search", "arguments": {
                                "query": texts[k], "top_k": 3}}})
        text = reply["result"]["content"][0]["text"]
        row["mcp_first"] = text.split("**[1]** `")[1].split("`")[0]
        if not (init["result"]["serverInfo"]["name"] == "leann-tpu"
                and len(tools["result"]["tools"]) == 2
                and not reply["result"]["isError"]
                and row["mcp_first"] == f"p{k}"):
            bad.append("mcp")
        lap("mcp")
    finally:
        os.chdir(saved_cwd)
        for key, val in saved_env.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
        shutil.rmtree(tmp, ignore_errors=True)

    row["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "cli", "n": n_docs, **row, "steps_s": steps_s,
          "launches_by_step": launches})
    if bad:
        raise AssertionError(f"cli: {bad} failed their gates")
    return row


# BASELINE config 4 (`evals/hybrid_latency.py:175-183`) cut from 1M
# chunks to 100k and from 20 s drives to 3 s for the smoke's time; the
# full size runs as `python -m leann_tpu_torch.evals.hybrid_latency`
HYBRID_N = 100_000
HYBRID_D = 128
HYBRID_CLIENTS = 32
HYBRID_WINDOWS = (0.0, 2.0, 8.0)
HYBRID_WARM_S = 1.0
HYBRID_DRIVE_S = 3.0
HYBRID_CHECKS = 16       # requests of each mix posted again after the drives
HYBRID_SELF_HITS = 64
STAGE1_N = 20_000        # rows of the stage-1 product check
STAGE1_C = 400           # its top-c: the searcher's 5 x 10 overfetch x 8
STAGE1_TOL = 1e-3        # |dot| ~ 11 here; a bf16-rounded dot errs >= 0.03


def check_stage1(torch, dev):
    """The flat engine's stage-1 product on the card
    (`ops/distance.py:stage1_dots`): bf16 operands into a float32 result
    with no bf16 rounding of it, against the fp32 product of the same
    bf16 operands (TF32 off) on a STAGE1_N x 128 gaussian corpus and 64
    queries: dots within STAGE1_TOL, and each row's top-c id set equal
    but for ids whose fp32 score lies within STAGE1_TOL of the row's c-th
    (a tie at the cut). Returns the row, with the path taken."""
    from leann_tpu_torch.ops import distance as dist

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("stage1: TF32 is on; the fp32 yardstick "
                             "would not be fp32")
    rng = np.random.default_rng(16)
    xb = torch.from_numpy(rng.standard_normal(
        (STAGE1_N, 128), dtype=np.float32)).to(dev).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((64, 128), dtype=np.float32)
                         ).to(dev)
    path = dist.stage1_path(dev)
    dots = dist.stage1_dots(q, dist.stage1_operand(xb))
    want = q.to(torch.bfloat16).float() @ xb.float().T
    row = {"path": path, "dtype": str(dots.dtype).replace("torch.", ""),
           "n": STAGE1_N, "queries": 64, "c": STAGE1_C}
    row["max_abs_err"] = float((dots - want).abs().max())
    row["bf16_exact_share"] = float(
        (dots.to(torch.bfloat16).float() == dots).float().mean())
    got_ids = torch.topk(dots, STAGE1_C, dim=1).indices.cpu().numpy()
    want_top = torch.topk(want, STAGE1_C, dim=1)
    cut = want_top.values[:, -1].cpu().numpy()
    want_ids = want_top.indices.cpu().numpy()
    want_np = want.cpu().numpy()
    differ = ties = 0
    for r in range(64):
        diff = set(got_ids[r]) ^ set(want_ids[r])
        if diff:
            differ += 1
            ties += all(abs(want_np[r, i] - cut[r]) <= STAGE1_TOL
                        for i in diff)
    row["rows_differing"], row["rows_tied_at_cut"] = differ, ties
    emit({"stage1": row})
    if not (dots.dtype == torch.float32
            and row["max_abs_err"] <= STAGE1_TOL
            and row["bf16_exact_share"] < 0.5 and differ == ties):
        raise AssertionError(f"stage1: {row}")
    return row


def phase_hybrid(torch, dev, n, counter):
    """BASELINE config 4 through `leann_tpu_torch.evals.hybrid_latency`
    at HYBRID_N: first `check_stage1`; then `build_index` (the zipf texts,
    flat ip, fake 128-d, seconds by step), `IndexSearcher` (its engine
    must be an ExactEngine on the card) and `serve_windows` at windows 0
    / 2 / 8 ms with 32 client threads, a 1 s warm drive and a 3 s timed
    drive each (the rows, the flush counts). Gates: no error (a failed
    request or a filtered reply with a hit outside `source$py`) and every
    mix served in every window; HYBRID_CHECKS requests of each mix from
    the drive's client 0 posted one at a time return the ids of
    `IndexSearcher.search` called in process (scores within 1e-5), every
    filtered hit's source ends in .py; self-hit@1 >= 0.99 on 64 passage
    texts posted plain. The flat path launches flat_topk, its stage-1
    top-c: no call may take its PyTorch path, and `drive` holds the phase
    to no other kernel. Returns (the row, the flat_topk operands of the
    drive's most frequent call of more than one row and of its most
    frequent one-row call, as (label, dots, bias, scale, c):
    kernels_main's `hybrid flush` cases)."""
    import http.client
    import threading
    from collections import Counter

    from leann_tpu_torch.embed import EmbeddingProvider
    from leann_tpu_torch.evals import hybrid_latency as hl
    from leann_tpu_torch.index import IndexSearcher
    from leann_tpu_torch.ops import distance as dist
    from leann_tpu_torch.ops.distance import ExactEngine
    from leann_tpu_torch.ops.flat_topk import flat_topk
    from leann_tpu_torch.server.http import ServerState, serve

    t_phase = time.perf_counter()
    paths = dict(flat_topk.paths)
    row = {"n": n, "d": HYBRID_D, "clients": HYBRID_CLIENTS,
           "stage1": check_stage1(torch, dev)}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "hybrid", "documents.leann")
        row["build_s"] = hl.build_index(base, n, HYBRID_D, device=dev)
        if not row["build_s"]["bm25_native"]:
            bad.append("native BM25 build")
        t0 = time.perf_counter()
        provider = EmbeddingProvider(mode="fake", dimensions=HYBRID_D)
        searcher = IndexSearcher(base, device=dev)
        searcher.search(provider.embed(["w00001 w00002"])[0])
        row["load_s"] = time.perf_counter() - t0
        eng = searcher.backend.engine
        row["engine"] = f"{type(eng).__name__} on {eng.device}"
        if not (isinstance(eng, ExactEngine) and eng.device.type == "cuda"):
            bad.append("engine")
        # the drive's flat_topk calls by (rows, c), and the first
        # operands of each shape, held by kernels_main to topk_stable
        calls, operands, lock = Counter(), {}, threading.Lock()

        def recording(dots, bias, scale, c, out=None):
            with lock:
                calls[dots.shape[0], c] += 1
                if (dots.shape[0], c) not in operands:
                    operands[dots.shape[0], c] = (dots.clone(), bias, scale)
            return flat_topk(dots, bias, scale, c, out=out)

        t0 = time.perf_counter()
        dist.flat_topk = recording
        try:
            rows, row["flush_stats"] = hl.serve_windows(
                searcher, provider, HYBRID_WINDOWS, 0, HYBRID_CLIENTS,
                HYBRID_DRIVE_S, n, dev, warm_s=HYBRID_WARM_S)
        finally:
            dist.flat_topk = flat_topk
        row["serve_s"] = time.perf_counter() - t0
        row["flat_topk_calls"] = {f"{r}x{c}": k
                                  for (r, c), k in calls.most_common()}
        picks = [next((key for key, _ in calls.most_common()
                       if (key[0] == 1) == one), None)
                 for one in (False, True)]
        flat_cases = [(f"hybrid flush {r} x {operands[r, c][0].shape[1]}"
                       f" c{c}", *operands[r, c], c)
                      for r, c in filter(None, picks)]
        del operands
        for w in HYBRID_WINDOWS:
            total = next(r for r in rows if r["window_ms"] == w
                         and r["metric"] == "hybrid_latency_total")
            mixes = {r["mix"] for r in rows if r["window_ms"] == w
                     and r["metric"] == "hybrid_latency"}
            if total["errors"] or mixes != set(hl.MIXES):
                bad.append(f"window {w}: errors {total['errors']}, "
                           f"mixes {sorted(mixes)}")

        # served against in process, one request at a time
        t0 = time.perf_counter()
        state = ServerState(searcher, provider, None, "hybrid_bench",
                            max_batch=64, batch_window_ms=2)
        server = serve(state, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        conn = http.client.HTTPConnection(
            "127.0.0.1", server.server_address[1], timeout=60)

        def post(body):
            conn.request("POST", "/search", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            if resp.status != 200:
                raise AssertionError(f"hybrid: POST {body}: {data[:200]}")
            return json.loads(data)["results"]

        try:
            count = dict.fromkeys(hl.MIXES, 0)
            equal = err = 0
            outside = 0
            short = dict.fromkeys(hl.MIXES, 0)
            for mix, body in hl.client_requests(0, 0):
                if count[mix] == HYBRID_CHECKS:
                    if min(count.values()) == HYBRID_CHECKS:
                        break
                    continue
                count[mix] += 1
                got = post(body)
                want = searcher.search(provider.embed([body["query"]]),
                                       hl.options_of(body))[0]
                same = [h["id"] for h in got] == [h.id for h in want]
                equal += same
                if same and want:
                    err = max(err, max(abs(h["score"] - w.score)
                                       for h, w in zip(got, want)))
                short[mix] += len(got) < 10
                if mix == "hybrid_filter":
                    outside += sum(not h["metadata"]["source"].endswith(
                        ".py") for h in got)
            row["served_equal"] = f"{equal}/{3 * HYBRID_CHECKS}"
            row["served_max_score_err"] = err
            row["filter_hits_outside"] = outside
            row["short_replies"] = short
            if equal != 3 * HYBRID_CHECKS or err > 1e-5:
                bad.append("served vs in process")
            if outside:
                bad.append("filter")
            texts = hl.make_texts(n)
            pick = np.random.default_rng(4).choice(
                n, HYBRID_SELF_HITS, replace=False)
            hits = [post({"query": texts[i], "top_k": 10})[:1]
                    for i in pick]
            row["self_hit1"] = float(np.mean(
                [bool(h) and h[0]["id"] == f"c{i}"
                 for h, i in zip(hits, pick)]))
            if row["self_hit1"] < 0.99:
                bad.append("self-hit@1")
        finally:
            conn.close()
            server.shutdown()
            server.server_close()
            state.batcher.close()
        row["checks_s"] = time.perf_counter() - t0
    row["flat_topk_paths"] = {k: v - paths[k]
                              for k, v in flat_topk.paths.items()}
    if row["flat_topk_paths"]["torch"]:
        bad.append("flat_topk took its PyTorch path on the card")
    if len(flat_cases) < 2:
        bad.append(f"flat_topk served no call of one row, or none of "
                   f"more: {calls}")
    row["phase_s"] = time.perf_counter() - t_phase
    emit({"phase": "hybrid", **row})
    if bad:
        raise AssertionError(f"hybrid: {bad} failed their gates")
    return row, flat_cases


def build_args(eng, q, ids, beam):
    """B1's arguments in the builder's final pass at complexity `beam`
    (max_iters 2L+16, visited log 2L, two expansions) on eng's graph."""
    from leann_tpu_torch.ops.fused_beam import wave_kernel_args

    return wave_kernel_args(
        q, eng.vectors, eng.sq_norms, eng.blocks, eng.meta, eng.medoid,
        ids, eng.r, beam, 2 * beam + 16, eng.metric, expansions=2,
        track_visited=2 * beam)


def phase_kernels_main(torch, rag, sift, deep, ivf, ivf8, gather, recompute,
                       sharded, cli, bench, hybrid):
    """Each kernel against its plain version at the shapes the main paths
    launched it with. The build cases take the builder's final-pass
    arguments (L = complexity, max_iters 2L+16, visited log 2L, medoid
    seed, the point itself excluded) on the finished graph; the search
    cases take the engines' own arguments; the bucket kernels take the
    engines' tables and the probes of their centroid top-8; gather_score
    takes the roofline's corpus and a window of distinct ids."""
    from leann_tpu_torch.ops.distance import pairwise_scores, topk_stable

    rag_eng, rag_q, pick = rag[:3]
    sift_eng, sift_q, sift_l = sift
    dev = rag_q.device

    def none(q):
        return torch.full((q.shape[0],), -1, dtype=torch.int32, device=dev)

    wave = torch.from_numpy(np.random.default_rng(5).choice(
        sift_eng.n, sift_q.shape[0], replace=False)).to(dev)
    rc_eng, rc_q, rc_ids = recompute
    # the api phase's one-query calls: search_device pads one real query
    # with qb-1 zero rows (all their scores tie) to one group of qb
    q1 = torch.cat([rag_q[:1], rag_q.new_zeros(rag_eng.qb - 1,
                                               rag_q.shape[1])])
    # the serve flush the cli phase's HTTP traffic produced most often:
    # its m real rows padded with zero rows to a multiple of qb
    m = cli["flush_size_mode"]
    bb = -(-m // rag_eng.qb) * rag_eng.qb
    qf = torch.cat([rag_q[:m], rag_q.new_zeros(bb - m, rag_q.shape[1])])
    cases = [
        ("rag build", build_args(
            rag_eng, rag_q, torch.from_numpy(pick).to(dev), 64), 10),
        ("rag search L64", rag_eng.kernel_args(rag_q, none(rag_q), 64), 10),
        ("api search B1 L64", rag_eng.kernel_args(q1, none(q1), 64), 10),
        (f"serve flush B{bb} L64", rag_eng.kernel_args(qf, none(qf), 64),
         10),
        ("rag search L1024", rag_eng.kernel_args(
            rag_q, none(rag_q), RAG_COMPLEXITY), 3),
        ("sift build", build_args(
            sift_eng, sift_eng.vectors[wave], wave, sift_l), 5),
        ("sift search", sift_eng.kernel_args(sift_q, none(sift_q), 64), 5),
        ("recompute build L48", build_args(rc_eng, rc_q, rc_ids, 48), 10),
    ] + [(f"recompute search L{beam}", rc_eng.kernel_args(
        rc_q, none(rc_q), beam), 10) for beam in RECOMPUTE_BEAMS]
    sh_graph, sh_pq, sh_q = sharded
    cases.append(("sharded search shard 0",
                  sh_graph.kernel_args(sh_q, 64, shard=0), 5))
    rows = [check_case(torch, label, kw, reps) for label, kw, reps in cases]
    next(r for r in rows if r["case"].startswith("serve flush"))[
        "real_rows"] = m
    emit({"phase": "kernels_main", "kernel": FUSED["name"], "cases": rows,
          "library_ms": None})

    deep_eng, deep_q = deep
    pq_rows = [check_case_pq(torch, f"deep search L{beam}", deep_eng.kernel_args(
        deep_q, none(deep_q), beam), 5) for beam in (64, DEEP_BEAM)]
    pq_rows.append(check_case_pq(torch, "sharded pq search shard 0",
                                 sh_pq.kernel_args(sh_q, 64, shard=0), 5))
    bench_pq, bench_q = bench
    pq_rows.append(check_case_pq(torch, "bench pq search L64",
                                 bench_pq.kernel_args(
                                     bench_q, none(bench_q), 64), 5))
    emit({"phase": "kernels_main", "kernel": PQ["name"], "cases": pq_rows,
          "library_ms": None})

    def probes(eng, q):
        sc = pairwise_scores(q, eng.bucket_cent, eng.metric)
        return topk_stable(sc, NPROBE)[1].to(torch.int32)

    ivf_eng, ivf_q = ivf
    dots_rows = [check_case_bucket(
        torch, "ivf search", "dots",
        (ivf_q, probes(ivf_eng, ivf_q), ivf_eng.bucket_vecs_bf16), "l2", 10,
        library=True)]
    emit({"phase": "kernels_main", "kernel": DOTS["name"], "cases": dots_rows,
          "library_ms": dots_rows[-1]["library_ms"]})
    ivf8_eng, ivf8_q = ivf8
    pay, sc, ns, ids, cent, _, _ = ivf8_eng._pallas_tables()
    ivf8_rows = [check_case_bucket(
        torch, f"ivf8 search B{b}", "ivf8",
        (q, probes(ivf8_eng, q), pay, sc, ns, ids, cent), "l2", 10,
        library=True) for b, q in sorted(ivf8_q.items())]
    # the hot case: all 2048 queries probe the 8 buckets that the batch's
    # own probes hit most
    q = ivf8_q[2048]
    hits = torch.bincount(probes(ivf8_eng, q).reshape(-1).long(),
                          minlength=pay.shape[0])
    hot = torch.topk(hits, NPROBE).indices.to(torch.int32)
    ivf8_rows.append(check_case_bucket(
        torch, "ivf8 hot B2048", "ivf8",
        (q, hot.expand(q.shape[0], NPROBE), pay, sc, ns, ids, cent), "l2",
        10))
    emit({"phase": "kernels_main", "kernel": IVF8["name"], "cases": ivf8_rows,
          "library_ms": ivf8_rows[-2]["library_ms"]})
    g_corpus, g_ids, g_q, g_timers = gather
    gather_rows = [check_case_gather(torch, "gather roofline", g_corpus,
                                     g_ids, g_q, library=True)]
    gather_rows[-1].update(g_timers)
    emit({"phase": "kernels_main", "kernel": GATHER["name"],
          "cases": gather_rows,
          "library_ms": gather_rows[-1]["library_ms"]})

    # the flat benchmark cell's query chunk: ExactEngine's operands on the
    # sift corpus (padded to 1,048,576 rows, l2) and 256 sift queries
    from leann_tpu_torch.ops import distance as dist

    n = sift_eng.vectors.shape[0]
    n_pad = -(-n // 65536) * 65536
    v = torch.cat([sift_eng.vectors.float(), sift_eng.vectors.new_zeros(
        (n_pad - n, sift_eng.vectors.shape[1]))])
    bias = dist.make_bias(n, n_pad, "l2", v)
    dots = dist.stage1_dots(sift_q[:FLAT_CHUNK],
                            dist.stage1_operand(v.to(torch.bfloat16)))
    del v
    flat_rows = [check_case_flat(torch, f"flat select {FLAT_CHUNK} x {n_pad}",
                                 dots, bias, 2.0, FLAT_C)]
    del dots
    # the hybrid phase's serving flushes: the drive's own operands at its
    # most frequent call of more than one row and its most frequent
    # one-row call
    flat_rows += [check_case_flat(torch, *case) for case in hybrid[1]]
    emit({"phase": "kernels_main", "kernel": FLAT["name"],
          "cases": flat_rows, "library_ms": flat_rows[-1]["library_ms"]})

    # the IVF benchmark cell's batch: the ivf phase's engine and queries,
    # C = 40 (k = 10, rescore factor 4)
    topc_rows = [check_case_topc(torch, "ivf search", ivf_q,
                                 probes(ivf_eng, ivf_q), ivf_eng, 40)]
    emit({"phase": "kernels_main", "kernel": TOPC["name"],
          "cases": topc_rows, "library_ms": topc_rows[0]["library_ms"]})
    return (rows, pq_rows, dots_rows, ivf8_rows, gather_rows, flat_rows,
            topc_rows)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; no GPU here")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from leann_tpu_torch.ops.bucket_kernels import (
        ivf8_bucket_scores, ivf_bucket_dots,
    )
    from leann_tpu_torch.ops.fused_beam import fused_beam_search
    from leann_tpu_torch.ops.flat_topk import flat_topk
    from leann_tpu_torch.ops.gather_score import gather_score
    from leann_tpu_torch.ops.ivf_topc import ivf_topc
    from leann_tpu_torch.ops.pq_beam import pq_beam_search

    wrappers = {FUSED["name"]: fused_beam_search, PQ["name"]: pq_beam_search,
                DOTS["name"]: ivf_bucket_dots, IVF8["name"]: ivf8_bucket_scores,
                GATHER["name"]: gather_score, FLAT["name"]: flat_topk,
                TOPC["name"]: ivf_topc}
    ivf_kernels = [DOTS["name"], TOPC["name"]]
    launches = dict.fromkeys(wrappers, 0)

    def drive(phase, kernels, n, *extra):
        """One main-path phase, every count set to 0 just before it and
        read just after; each kernel named in `kernels` must have
        launched and no other kernel may (with none named, no kernel may
        launch). The phase gets counter(*names): the launches so far of
        the named kernels (default: its own, or every kernel when it has
        none). `extra` goes to the phase."""
        kernels = tuple(kernels)
        for w in wrappers.values():
            w.launches = 0

        def count(*names):
            return sum(wrappers[k].launches
                       for k in (names or kernels or wrappers))

        t0 = time.perf_counter()
        out = phase(torch, dev, n, count, *extra)
        got = {k: w.launches for k, w in wrappers.items()}
        emit({"phase": phase.__name__[len("phase_"):], "launches": got,
              "seconds": time.perf_counter() - t0})
        for k in kernels:
            if got[k] <= 0:
                raise AssertionError(f"{phase.__name__}: {k} never launched")
        if any(v for k, v in got.items() if k not in kernels):
            raise AssertionError(f"{phase.__name__}: a kernel other than "
                                 f"{kernels} launched")
        for k in got:
            launches[k] += got[k]
        return out

    dev = torch.device("cuda:0")
    t_all = time.perf_counter()
    phase_env(torch)
    phase_build()
    t0 = time.perf_counter()
    rows = phase_kernels(torch, dev)
    pq_grid = phase_kernels_pq(torch, dev)
    dots_grid, ivf8_grid = phase_kernels_ivf(torch, dev)
    gather_grid = phase_kernels_gather(torch, dev)
    log(f"chip_smoke: kernel grids {time.perf_counter() - t0:.1f}s")

    rag_root = tempfile.mkdtemp(prefix="chip_smoke_rag_")
    try:
        rag = drive(phase_rag, [FUSED["name"]], RAG_N, rag_root)
        drive(phase_native, (), RAG_N, rag[4])
        *sift, sift_data = drive(phase_sift, [FUSED["name"]], SIFT_N)
        bench = drive(phase_bench, [FUSED["name"], PQ["name"], FLAT["name"]]
                      + ivf_kernels, SIFT_N, sift_data)
        deep = drive(phase_deep, [PQ["name"]], DEEP_N)
        *ivf, ivf_data = drive(phase_ivf, ivf_kernels, IVF_N)
        *ivf8, ivf8_data = drive(phase_ivf8, [IVF8["name"]], IVF8_N)
        gather = drive(phase_gather, [GATHER["name"]], GATHER_N)
        gather += (gather_timers(torch, *gather),)
        drive(phase_ivfpq, (), IVF8_N, ivf8_data, ivf_data)
        del ivf_data, ivf8_data
        drive(phase_rag_ivf, ivf_kernels, RAG_N)
        drive(phase_encode, [FUSED["name"]], RAG_N, rag[3])
        recompute = drive(phase_recompute, [FUSED["name"]], RECOMPUTE_N)
        sharded = drive(phase_sharded, [FUSED["name"], PQ["name"]]
                        + ivf_kernels, SHARDED_N, sift_data, rag[4], rag[1],
                        rag[2])
        drive(phase_api, [FUSED["name"]], RAG_N, rag[4], rag[1], rag[2],
              rag[3])
        cli = drive(phase_cli, [FUSED["name"]] + ivf_kernels, RAG_N, rag[4],
                    rag[2], rag[3])
        hybrid = drive(phase_hybrid, [FLAT["name"]], HYBRID_N)
    finally:
        shutil.rmtree(rag_root, ignore_errors=True)
    del sift_data
    t0 = time.perf_counter()
    (main_rows, pq_main, dots_main, ivf8_main, gather_main,
     flat_main, topc_main) = phase_kernels_main(
        torch, rag, sift, deep, ivf, ivf8, gather, recompute, sharded, cli,
        bench, hybrid)
    log(f"chip_smoke: kernels_main {time.perf_counter() - t0:.1f}s")

    # the table rows: times at each kernel's serving shape (sift search,
    # 1M, B=2048; deep search, 1M, B=2048, beam DEEP_BEAM; ivf search,
    # 1M, B=2048; ivf8 search, 10M, B=2048; the gather roofline, 10M x
    # 128, B=2048, R=48), the worst error over every comparison
    kernels = []
    for info, serve, all_rows in (
            (FUSED, next(c for c in main_rows if c["case"] == "sift search"),
             rows + main_rows),
            (PQ, next(c for c in pq_main
                      if c["case"] == f"deep search L{DEEP_BEAM}"),
             pq_grid + pq_main),
            (DOTS, dots_main[-1], dots_grid + dots_main),
            (IVF8, next(c for c in ivf8_main
                        if c["case"] == "ivf8 search B2048"),
             ivf8_grid + ivf8_main),
            (GATHER, gather_main[-1], gather_grid + gather_main),
            (FLAT, flat_main[0], flat_main),
            (TOPC, topc_main[0], topc_main)):
        kernels.append({
            **info, "launches": launches[info["name"]],
            "max_abs_err": max(c["max_abs_err"] for c in all_rows),
            "ms": serve["ms"], "plain_ms": serve["plain_ms"],
            "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
            "library_ms": serve.get("library_ms")})
    log(f"chip_smoke: {time.perf_counter() - t_all:.1f}s")
    emit({"kernels": kernels})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
