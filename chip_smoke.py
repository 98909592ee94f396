#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (one nvcc
each, in parallel) and holds each against its plain PyTorch version (the
f32 and the int8 gather distance, batched on the tiled schedule and as
one-lane launches on the spread one, the two schedules against each other
bit for bit, and both timed on cold rows beside an empty kernel's launch
floor; the all-pairs f32 distance on both its paths, streaming for b <= 16
and on the tensor cores above, at a 1M-candidate retrieval, b = 16, a
serve batch and GIST width; the int8 all-pairs distance on both its paths,
streaming at a 1M-row scan and on the tensor cores at GIST width, also
against float64, with a sweep of batch sizes across both paths; the CSR
segment sum on the ogb_products graph and on a power-law graph of its
size, hub rows against float64),
answers 8 recsys retrieval requests of BST at full width (1M candidates
out of a 5M-item table, through the all-pairs kernel, each answer held
against the plain path, one of them profiled), serves and trains the
recsys ranking models BST and DIEN at full width (``[rank]``: 20
serve_p99 requests and one serve_bulk request through the serve step,
which equals ``recsys_forward`` bit for bit; logits, loss and every
gradient against a CPU copy; 3 AdamW steps through ``make_train_step``,
BST at train_batch's 65,536 rows and DIEN at 32,768, one step profiled; no
kernel of the port launched, since the ranking path has none), serves
gemma2-9b's full config (42 layers, bf16, 9.24 B parameters) through
``greedy_generate`` (``[lm]``: 8 prompts of 512 tokens and 2 of 8,192,
32 new tokens each; the last decode step against a prefill of the whole
sequence, a decode step under CUDA's sync debug mode, one profiled; the
full-width model cut to 2 layers in f32 against its CPU copy; no kernel
of the port launched, since the LM path has none), trains gemma2-9b's
full config through ``make_train_step`` with Adafactor and remat
(``[train_lm]``: 1 x 4,096 random tokens, a warm-up and 3 timed steps,
one profiled; the loss on the batch falls; the full width cut to 2
layers in f32, one step against its CPU copy; no kernel of the port
launched), serves and trains granite-moe-3b-a800m's full config
(``[moe]``: 32 layers, bf16, 40 experts top-8; 8 prompts of 512 tokens
and one of 8,192, then 4 x 4,096 tokens through ``make_train_step`` with
AdamW; decode against prefill with every routed pair kept; the 2-layer
f32 model's routing tables, logits, tokens and AdamW step against its CPU
copy; kimi-k2 SMOKE with Adafactor against its CPU copy; AdamW's peak on
the expert leaf), dry-runs six cells (``[dryrun]``: in two subprocesses
started before the index build, both train steps on the 256-rank
production mesh and on one card at their batches, DIEN's and gemma-7b's
train cells on 16x16, each record ``ok``, the one-card rooflines printed
beside the measured steps, ``[moe]``'s peak within 10% of its
estimate), trains
MeshGraphNet's full
config on Reddit-regime minibatch blocks sampled from a power-law graph
through the port's checkpointed training loop, kernel 7 aggregating every
block's messages (``[gnn]``: each kernel-7 call of a forward against its
plain version, the segment sum's backward bit for bit, kernel 7 on a
block timed in turns with ``torch.segment_reduce``, the f32 model on the
card against its CPU copy, the reloaded checkpoint bit for bit, one step
resumed and one profiled), trains the same config owner-computes
(``[gnn_part]``: ``models/gnn_partitioned.py`` over 4 partitions of a
mesh-like grid graph held on the card, each at ogb_products' per-chip shape
on 256 chips, the halo exchange a transpose and each block's aggregate
one kernel-7 call; each kernel-7 call of a forward against its plain
version, the loss and every gradient against ``gnn_loss`` on the whole
graph, the loss falling over AdamW steps, the step beside the whole
graph's, one step profiled), runs the hillclimb
(``python -m repro_torch.launch.hillclimb``) in a subprocess started with
``[dryrun]``'s (``[hillclimb]``: four records ``ok``, the halo step's
all-to-all bytes a chip, its collectives below the baseline's), builds a
GIST1M-shaped index
on the card (n = 1,000,000 x d = 960, l2, the paper's index settings),
answers filtered batched queries at the paper's selectivities through
``NavixIndex.search_many``, makes the index int8-resident with
``quantize_resident()`` and answers the same queries through
``search_quantized_many`` (int8 beam loop on the card, exact re-rank on
the host), and checks the answers: each batched engine against the port's
single-query search, bit for bit, and against the same search run on CPU
copies through the plain versions; the single-query searches are timed
one by one and two of them profiled (``[single]``). Then it lays the Wiki
graph's schema (``make_wiki_like``, the paper's Figure 7a) over the same 1M
rows as table ``Chunk``, registers the f32 index and its int8 sibling in one
``NavixDB`` and runs the paper's query as the paper poses it, through
``NavixDB.execute``: uncorrelated, person-chunk (positively and negatively
correlated) and two-hop plans, each checked against an oracle mask, the
unregistered handle's ``search_many``, the program cache's counts, the vmap
engine, a mixed-plan batch and the int8 entry (``[db]``); and the Section
5.7 postfilter baseline against its CPU copy (``[postfilter]``). Over the
same database it serves requests of mixed plans and beam widths through the
serving tier (``[serve]``): ``SearchEngine``'s continuous scheduler against
its grouped one, bit for bit per request, and ``db.serve()``'s live service
with client threads and expired deadlines, on the f32 and the int8 entry.
Last, it shards the first 65,535 rows over a grid of 4 shards on the one
card (``[shard]``): a ``ShardedNavix`` searched per lane, with a shared
mask, under a quorum and on a data = 2 grid, each bit for bit against the
on-card oracle ``per_shard_reference`` or the data = 1 answer, then through
``NavixDB.execute(alive=...)``, the continuous scheduler (each request
against the one-shot search of its group) and a live service whose last
shard's heartbeats stop mid-drain; then it saves that sharded index
through the checkpoint store, loads it back onto the card and holds one
pass against the pass before the save, bit for bit (``[ckpt]``). The
runtime guards watch phases that already run (``[guards]``): one
``CompileCounter`` over the run (no nvcc after the kernel builds, no
program entry in ``[db]``'s and ``[serve]``'s steady traffic),
``[serve]`` under the in-flight guard of ``LaneBatch``, and both live
services under the lock-order monitor.
The host's data (the 1M mixture, ``[gnn]``'s and ``[gnn_part]``'s
graphs) is made on two worker threads while the kernels build and the kernel phases run. Each
phase prints one line or two; a failed
phase raises, so the script exits non-zero and prints no ``ok`` line. The
last three lines are the card's name and power limit, a JSON line of
per-kernel numbers, and ``{"ok": true, "device": ...}``.

It needs one CUDA device and exits non-zero without one. It imports
nothing of the JAX package.
"""

from __future__ import annotations

import atexit
import ctypes
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the port itself: without the repository around this file these imports
# fail, before anything is printed
from repro_torch.analysis.runtime import (CompileCounter,  # noqa: E402
                                          guard_donation, instrument_locks)
from repro_torch.api import NavixDB  # noqa: E402
from repro_torch.checkpoint import store  # noqa: E402
from repro_torch.common.hardware import TARGET, bound_s  # noqa: E402
from repro_torch.common.util import (tree_bytes,  # noqa: E402
                                     tree_flatten_with_path, tree_leaves,
                                     tree_unflatten)
from repro_torch.configs.navix_paper import (PAPER_INDEX,  # noqa: E402
                                             SELECTIVITIES)
from repro_torch.core.distances import brute_force_topk  # noqa: E402
from repro_torch.core.distributed import (ShardedNavix,  # noqa: E402
                                          make_mesh, per_shard_reference,
                                          reference_merge, shard_searches)
from repro_torch.core.graph import check_symmetric_fraction  # noqa: E402
from repro_torch.core.navix import NavixConfig, NavixIndex  # noqa: E402
from repro_torch.core.quantize import QuantizedStore, quantize  # noqa: E402
from repro_torch.data.graph_sampler import (NeighborSampler,  # noqa: E402
                                             random_power_law_graph)
from repro_torch.data.synthetic import (WikiLike,  # noqa: E402
                                        correlation_ratio, gaussian_mixture,
                                        make_queries, person_chunk_plan,
                                        two_hop_plan, uncorrelated_plan)
from repro_torch.query.operators import (Filter, KnnSearch,  # noqa: E402
                                         NodeScan)
from repro_torch.serving import HeartbeatMonitor, SearchEngine  # noqa: E402
from repro_torch.storage.columnar import ExactTier, GraphStore  # noqa: E402
from repro_torch.config.base import get_arch  # noqa: E402
from repro_torch.core import build as build_module  # noqa: E402
from repro_torch.kernels import (_build, distance_matrix,  # noqa: E402
                                 gather_distance, ops, quantized,
                                 quantized_gather_distance, ref, segment_sum)
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import gnn, recsys  # noqa: E402
from repro_torch.models.gnn_partitioned import (  # noqa: E402
    partitioned_input_specs, partitioned_loss)
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving import greedy_generate  # noqa: E402
from repro_torch.training import loop as train_loop  # noqa: E402
from repro_torch.training.optimizer import (SPLIT_BYTES,  # noqa: E402
                                            make_optimizer)
from repro_torch.launch.dryrun import MESHES  # noqa: E402

# GIST1M (TEXMEX; the paper's Table 2): 1M vectors of width 960, l2
N_GIST = 1_000_000
N = N_GIST                   # vectors indexed (cut only to fit the time limit)
DIM = 960
N_CLUSTERS = 1000
N_QUERIES = 1024
K = 100
EFS = 200
BUILD_MORSEL = 2048          # the paper's morsel size
# per sigma and per arm (f32, int8); cut from 8 to 4 to make room for
# [gnn], to 2 for [rank], and to 1 for [train_lm]
PARITY_LANES = 1
PARITY_SIGMAS = (1.0, 0.1, 0.01)
# kernel vs plain version: a different f32 summation order
RTOL, ATOL = 1e-5, 1e-4
# f32-accurate tensor-core routes of the all-pairs kernels: (products a
# product, their rate; the card's data-sheet rates, TARGET). f32 rows split
# 3xTF32 (kernel 5); int8 codes are exact in TF32 and in BF16, so only Q
# splits: in three BF16 pieces (kernel 6's route, the cheapest) or in two
# TF32 pieces (the route it did not keep)
ROUTES = {"tf32x3": (3, TARGET.peak_tf32_flops),
          "tf32x2": (2, TARGET.peak_tf32_flops),
          "bf16x3": (3, TARGET.peak_bf16_flops)}
CHEAPEST_ROUTE = {4: "tf32x3", 1: "bf16x3"}
# the reference's tolerances for the all-pairs kernels (tests/test_kernels.py)
# and the segment sum's (summed in another order than index_add_'s atomics)
MATRIX_TOL = 1e-4
QUANT_TOL = 1e-3
SEGMENT_TOL = 1e-5
# kernel 5 at the retrieval step's shape and b = 16 (its streaming path),
# a serve_p99 batch and GIST width (its tensor-core path)
MATRIX_SHAPES = ((1, 1_000_000, 32), (16, 1_000_000, 32),
                 (512, 1_000_000, 32), (1024, 65_536, 960))
# kernel 6: an int8 brute-force scan (its streaming path), and GIST width
# (its tensor-core path)
QUANT_SHAPES = ((8, 1_000_000, 960), (1024, 65_536, 960))
# ... both paths timed at (n, d) = (1M, 960) across these batch sizes: the
# sweep that sets quantized.STREAM_MAX_BATCH
QUANT_SWEEP_BATCHES = (1, 2, 4, 8, 12, 16, 24, 32, 64, 128)
# each path's max abs error against float64 may be at most this many times
# the plain version's
F64_ERR_RATIO = 4.0
# kernel 7: meshgraphnet's ogb_products graph (configs/meshgraphnet.py) at its
# d_hidden, edges padded to a multiple of 512
OGB_NODES, OGB_EDGES, OGB_D = 2_449_029, 61_859_140, 128
# ... and on ogb_products_powerlaw, the same sizes with destinations drawn by
# random_power_law_graph's law (data/graph_sampler.py, alpha 1.5)
OGB_POWERLAW_ALPHA = 1.5
# kernel 7 and torch.segment_reduce timed in turns: rounds, calls a round
# (3 rounds of 1 call where one segment_reduce call takes over SEGMENT_SLOW_MS)
SEGMENT_ROUNDS = 7
SEGMENT_REPS = 3
SEGMENT_SLOW_MS = 100.0
# on the skewed graph, nodes of more edges than this (the hub rows) are held
# against float64: two f32 orders of their long sums differ beyond
# SEGMENT_TOL
SEGMENT_HUB_DEGREE = 64
RETRIEVAL_ARCH = "bst"
RETRIEVAL_REQUESTS = 8
RETRIEVAL_K = 100
# one-lane launches: the single-query search's K (seeds, the upper descent's
# M_U, the expansions' M_L), timed on both schedules
ONE_LANE_KS = (1, PAPER_INDEX.m_u, 2 * PAPER_INDEX.m_u)
# ... checked against lanes of a B = N_QUERIES batch at these K (72 = M_L +
# the build's new-edge cap: a second, partial tile) and lanes (lane 0 of
# the batch is fully retired)
ONE_LANE_CHECK_KS = (*ONE_LANE_KS, 2 * PAPER_INDEX.m_u
                     + PAPER_INDEX.build_params().new_edge_cap)
ONE_LANE_LANES = (1, 517, N_QUERIES - 1)
# batch sizes at which both schedules are timed at K = M_L (beside every
# (B, K) of the main path)
SCHEDULE_BATCHES = (1, 8, 32, 64, 128, 256, 1024)
SCHEDULES = ("tiled", "spread")
# timed launches per one-lane timing (cold: each on its own id list; L2-hot:
# one id list throughout) and per timing of a batch (cold)
ONE_LANE_REPS = 50
TABLE_REPS = 20
# device cycles of spin queued per timed call: covers the host's time to
# launch one call (tens of microseconds) at the card's clock
SPIN_CYCLES_PER_CALL = 400_000
# a 4-byte scale at a random address costs one 32-byte sector
SECTOR_BYTES = 32
# the Wiki graph's schema (make_wiki_like, the paper's Figure 7a) laid over
# the index's rows: rows of the first PERSON_CLUSTERS mixture clusters (about
# 10%) are person chunks, owned 6 a person; the rest resource chunks, owned 3
# a resource; each person has 4 WikiLinks to resources
PERSON_CLUSTERS = 100
CHUNKS_PER_PERSON, CHUNKS_PER_RESOURCE, LINKS_PER_PERSON = 6, 3, 4
BIRTH_DAYS = 36500
WIKI_SEED = 3
# the [db] plans: uncorrelated_plan at these sigma, person_chunk_plan at these
# person-sigma (with person and with nonperson queries), two_hop_plan at one
DB_SIGMAS = (0.5, 0.1, 0.01)
DB_PERSON_SIGMAS = (0.5, 0.1)
DB_TWO_HOP_SIGMA = 0.1
CE_QUERIES = 64             # queries a plan's correlation ratio is taken on
VMAP_LANES = 4
BUCKET_BATCHES = (17, 19, 23)   # one power-of-two bucket (32)
# [postfilter]: this many queries at each sigma of the uncorrelated plans
POSTFILTER_SIGMAS = (0.5, 0.1)
POSTFILTER_QUERIES = 2
# [serve]: the [db] plans the f32 requests cycle through (None: unfiltered),
# each at both (k, efs); the serving engine's lanes and chunk
SERVE_PLANS = ("uncorrelated 0.1", f"person_chunk {DB_PERSON_SIGMAS[0]} person",
               f"two_hop {DB_TWO_HOP_SIGMA}", None)
SERVE_SHAPES = ((K, EFS), (10, 100))
SERVE_REQUESTS = 2048
SERVE_MAX_BATCH = 1024
SERVE_STEP_ITERS = 32
# the live service: two client threads, of whose requests this many carry a
# deadline already past; its lanes
SERVICE_REQUESTS = 512
SERVICE_EXPIRED = 64
SERVICE_CLIENTS = 2
SERVICE_MAX_BATCH = 512
SERVICE_WAIT_S = 300.0
# the int8 entry: requests over the first two plans of SERVE_PLANS
SERVE_INT8_REQUESTS = 1024
# [shard]: a ShardedNavix of 4 shards on the one card over the first rows of
# the 1M data (n_local 16,384, one padded row): the whole 1M rows would add
# about 380 s of build to a run that must end inside 1200 s (cut from
# 131,071 rows to make room for [gnn])
SHARD_ROWS = 65_535
SHARD_COUNT = 4
SHARD_SIGMAS = (1.0, 0.4, 0.1, 0.0, 0.03, 0.7)   # the lanes' mask cycle
SHARD_SHARED_SIGMA = 0.1
SHARD_ALIVE = (True, True, False, True)
SHARD_QUORUM = 3
SHARD_BUCKETS = 10          # a "bucket" column in [0, 10): the plans' filter
SHARD_SELECTIONS = {"bucket == 1": ("==", 1), "bucket < 5": ("<", 5)}
# request counts trimmed (1024 -> 512, 256 -> 128) after a 1152.3 s run on
# a slow host; the checks are unchanged
SHARD_SERVE_REQUESTS = 512
SHARD_SERVICE_REQUESTS = 128
SHARD_SERVICE_LANES = 64
# the (2, 4) grid's pass: its first lanes only (all six sigmas in each of
# its two blocks); it checks the layout, not the throughput
SHARD_GRID_LANES = 256
# [gnn]: meshgraphnet's full CONFIG trained on minibatch_lg blocks (the
# Reddit regime: 1024 seeds, fanouts 15 and 10, d_feat 602) sampled from a
# power-law graph of the shape's 232,965 nodes, at an average degree cut
# from the shape's 492 to GNN_AVG_DEGREE for host time (~10x less
# generation); every block keeps its shape and a node's out-degree stays far
# above the fanout
GNN_ARCH = "meshgraphnet"
GNN_SHAPE = "minibatch_lg"
GNN_AVG_DEGREE = 49
GNN_STEPS = 6               # AdamW steps through training.loop.train ...
GNN_CKPT_EVERY = 3          # ... checkpointed every 3, then one resumed step
# the block of the f32 card-vs-CPU model check (5,312 node rows, unpadded:
# the CPU copy of a full block takes over a minute)
GNN_CHECK_SEEDS = 32
# that check's tolerance: each leaf's max abs difference over its largest
# value. f32 on both sides, but other summation orders (cuBLAS against CPU
# BLAS; the gathers' backward scatter-adds atomically on the card) through
# 15 blocks and their LayerNorms. Permuting a block's edges alone moves
# CPU gradients by up to 6.3e-4 of a leaf's largest value (median 9e-5);
# the card's first run differed by 1.3e-3 at most (median ~1.5e-4); a
# wrong index or dtype is O(1)
GNN_REL_TOL = 5e-3
# [gnn_part]: meshgraphnet's full CONFIG, owner-computes
# (models/gnn_partitioned.py, mesh=None) over GNN_PARTS partitions held on
# the one card, each at the reference's per-chip shape of ogb_products on
# GNN_PART_CHIPS chips (9,568 node and 241,638 edge slots, d_feat 100). The
# graph is mesh-like, as the partitioned layout assumes: nodes on a grid of
# GNN_PART_GRID (rows, columns), GNN_PARTS strips of whole columns (the
# 184 x 208 grid gives 4 strips of 184 x 52 = 9,568 nodes), an edge from
# every node within sqrt(GNN_PART_RADIUS2) grid steps: 24 in-edges inside
# the grid, ogb_products' average is 25.3 (61,859,140 / 2,449,029)
GNN_PART_SHAPE = "ogb_products"
GNN_PART_CHIPS = 256
GNN_PARTS = 4
GNN_PART_GRID = (184, 208)
GNN_PART_RADIUS2 = 8
GNN_PART_STEPS = 3          # timed AdamW steps of each form, after a warm-up
GNN_PART_LOSS_RTOL = 1e-4   # the partitioned loss against the whole graph's
# [rank]: the ranking path of BST and DIEN at full CONFIG width
RANK_ARCHS = ("bst", "dien")
RANK_REQUESTS = 20          # serve_p99 requests a model
RANK_STEPS = 3              # AdamW steps through make_train_step
# train rows a model: train_batch's 65,536, but DIEN's are cut to the
# largest power of two whose step peaks under ~60 GB: autograd keeps the
# two 100-step scans' tensors, and on the H100 a step peaked at 34.1 GB at
# 32,768 rows and 62.5 GB at 65,536
RANK_TRAIN_ROWS = {"bst": 65_536, "dien": 32_768}
RANK_CHECK_ROWS = 256       # rows of the card-vs-CPU-copy check
# that check's limits: logits and loss at rtol 1e-4 / atol 1e-5 (TF32 off;
# other summation orders); each gradient leaf within GNN_REL_TOL of its
# largest value (the card's table[ids] backward scatter-adds atomically)
RANK_RTOL, RANK_ATOL = 1e-4, 1e-5
# [lm]: gemma2-9b's full CONFIG (42 layers, bf16) served through
# greedy_generate: (B, prompt tokens) of each request shape; (a) takes
# prefill's one-pass attention, (b) its chunked_mha (from 8192 tokens),
# where every even layer's 4096-token window bites
LM_ARCH = "gemma2-9b"
LM_REQUESTS = {"a": (8, 512), "b": (2, 8192)}
LM_NEW = 32                 # greedy tokens a request
# decode against prefill at full depth: the last decode step's logits
# (bf16 throughout; the final soft cap keeps them within +-30) against a
# prefill of the prompt and all 32 new tokens. A wrong position, cache
# slot or window is O(1)
LM_DECODE_TOL = 0.5
# the card against its CPU copy, f32 and TF32 off: full width and the
# 256,000-token vocabulary, depth and window cut only for the CPU copy's
# time (2 layers, a window of 64 that bites inside 128-token prompts)
LM_CHECK = dict(n_layers=2, local_window=64, param_dtype="float32",
                compute_dtype="float32")
LM_CHECK_SHAPE = (2, 128)
LM_CHECK_NEW = 4
LM_CHECK_TOL = dict(rtol=1e-4, atol=1e-4)
LM_MEM_SLACK = 64 << 20     # bytes the phase may leave allocated
# [train_lm]: gemma2-9b's full CONFIG (42 layers, bf16, remat) trained
# through make_train_step with Adafactor, the CONFIG's optimizer, on random
# tokens at train_4k's sequence length; the batch cut from train_4k's 256
# sequences to the one a card holds
TRAIN_LM_SHAPE = "train_4k"
TRAIN_LM_BATCH = 1
TRAIN_LM_STEPS = 3          # timed, after one warm-up step; then one
                            # profiled
# Adafactor's learning rate: its default, an absolute 1e-2 a step on
# weights of RMS ~1/sqrt(3584) = 0.017, raised the loss on the batch in 4
# steps (13.178 -> 15.633); 1e-4, 1e-3 and 3e-3 each lowered it
TRAIN_LM_LR = 1e-3
# the card against its CPU copy: full width cut to 2 layers in f32 (depth
# for the CPU copy's time), one train step on TRAIN_LM_CHECK_SHAPE tokens;
# each leaf's new value within TRAIN_LM_REL_TOL of the leaf's largest
# update (the embedding's backward scatter-adds atomically on the card)
TRAIN_LM_CHECK = dict(n_layers=2, param_dtype="float32",
                      compute_dtype="float32")
TRAIN_LM_CHECK_SHAPE = (1, 128)
TRAIN_LM_REL_TOL = 5e-3
TRAIN_LM_LOSS_TOL = dict(rtol=1e-4, atol=1e-4)
# [moe]: granite-moe-3b-a800m's full CONFIG (32 layers, bf16, 40 experts
# top-8, 3.30 B parameters) served through greedy_generate at [lm]'s (a)
# and at one 8,192-token prompt (b: chunked_mha; cut from prefill_32k's 32
# sequences of 32,768 tokens for the clock), then trained through
# make_train_step with AdamW, the CONFIG's optimizer, at its default lr on
# MOE_TRAIN_BATCH x train_4k's 4,096 random tokens: the largest batch of
# {1, 2, 4, 8} whose one-card dry run stays under 70 GB (4: 54,179,694,384
# B; 8: 75,367,499,344 B), cut from train_4k's 256 sequences
MOE_ARCH = "granite-moe-3b-a800m"
MOE_REQUESTS = {"a": (8, 512), "b": (1, 8192)}
MOE_TRAIN_SHAPE = "train_4k"
MOE_TRAIN_BATCH = 4
MOE_TRAIN_STEPS = 3         # timed, after one warm-up step; then one
                            # profiled
# check 1 (decode against prefill) generates with a capacity factor of
# n_experts / top_k: every expert then has a slot for every token, so the
# prefill keeps every routed pair as a decode step of <= 8 tokens does (8
# slots an expert). At the CONFIG's 1.25 a prefill drops the pairs beyond
# an expert's capacity, the last tokens first, and the two differ by O(1)
MOE_CHECK = dict(n_layers=2, param_dtype="float32", compute_dtype="float32")
MOE_CHECK_SHAPE = (2, 128)
MOE_PEAK_TOL = 0.10         # the training peak against the dry run's
# AdamW's first update is lr g / (|g| + eps), eps 1e-8: its slope in g is
# lr eps / (|g| + eps)^2, so below |g| ~ 1e-7 the card's and the CPU's
# last-bit gradient differences move an entry by up to ~lr (on an H100,
# held everywhere: 0.65 of wq's largest update). The step is held to
# TRAIN_LM_REL_TOL of each leaf's largest update where |g| >=
# MOE_NEAR_ZERO (there a difference of 1e-9 moves it < 1e-5 lr), and the
# gradient itself, the new first moment (1 - b1) g, everywhere
MOE_NEAR_ZERO = 1e-6
# kimi-k2 SMOKE on the card against its CPU copy: forward, loss and one
# Adafactor step (its CONFIG's optimizer), for the shared expert
MOE_SMOKE_ARCH = "kimi-k2-1t-a32b"
MOE_SMOKE_SHAPE = (2, 64)
# AdamW on granite's expert leaf wi: its first 8 layers (2.01 GB in f32,
# past SPLIT_BYTES: still updated a layer at a time) are where the
# whole-leaf arithmetic fits beside them, and the two are compared bit
# for bit
ADAMW_BIT_LAYERS = 8
# [dryrun]: dry runs on the production mesh (16x16) and on one card, in
# DRYRUN_LANES subprocesses that run their cells one after another (the
# fake process group never enters this process), started before [build]
# and collected at the end: [train_lm]'s and [moe]'s train cells on both
# meshes, DIEN's and gemma-7b's on 16x16; (arch, shape, mesh, batch)
DRYRUN_CELLS = (
    (LM_ARCH, TRAIN_LM_SHAPE, "single", None),
    (LM_ARCH, TRAIN_LM_SHAPE, "one", TRAIN_LM_BATCH),
    (MOE_ARCH, MOE_TRAIN_SHAPE, "single", None),
    (MOE_ARCH, MOE_TRAIN_SHAPE, "one", MOE_TRAIN_BATCH),
    ("dien", "train_batch", "single", None),
    ("gemma-7b", "train_4k", "single", None),
)
DRYRUN_LANES = 2
DRYRUN_TIMEOUT_S = 900
# [hillclimb]: ``python -m repro_torch.launch.hillclimb`` in a subprocess
# started with [dryrun]'s: the halo-partitioned GNN train step must move
# HILLCLIMB_HALO_A2A bytes of all-to-all a chip (45 exchanges: 15 blocks
# forward, 15 in remat's recompute, 15 backward, of 256 partitions x 16
# halo slots x d_hidden 128 in f32), fewer collective bytes than its
# baseline
HILLCLIMB_WHICH = "gnn,retrieval"
HILLCLIMB_HALO_A2A = 45 * 256 * 16 * 128 * 4
HILLCLIMB_HALO = "gnn/ogb_products HALO-PARTITIONED"
HILLCLIMB_GNN_BASE = "gnn/ogb_products BASELINE"
F32_SOURCE = "src/repro_torch/kernels/csrc/gather_distance.cu"
INT8_SOURCE = "src/repro_torch/kernels/csrc/quantized_gather_distance.cu"
TPU_KERNELS = "src/repro/kernels/gather_distance.py"
CSRC = "src/repro_torch/kernels/csrc"
#: name -> (CUDA source, TPU kernel it replaces); the single-query forms are
#: one-lane launches of the batched kernels
KERNELS = {
    "gather_distance_batch": (F32_SOURCE, f"{TPU_KERNELS}:125"),
    "quantized_gather_distance_batch": (INT8_SOURCE, f"{TPU_KERNELS}:173"),
    "gather_distance": (F32_SOURCE, f"{TPU_KERNELS}:39"),
    "quantized_gather_distance": (INT8_SOURCE, f"{TPU_KERNELS}:91"),
    "distance_matrix": (f"{CSRC}/distance_matrix_stream.cu",
                        "src/repro/kernels/distance_matrix.py:59"),
    "distance_matrix_wgmma": (f"{CSRC}/distance_matrix_wgmma.cu",
                              "src/repro/kernels/distance_matrix.py:59"),
    "quantized_distance_matrix": (f"{CSRC}/quantized_distance_stream.cu",
                                  "src/repro/kernels/quantized.py:61"),
    "quantized_distance_matrix_wgmma": (f"{CSRC}/quantized_distance_wgmma.cu",
                                        "src/repro/kernels/quantized.py:61"),
    "csr_segment_sum": (f"{CSRC}/segment_sum.cu",
                        "src/repro/kernels/segment_sum.py:59"),
}
#: the sources ``_build`` compiles, one nvcc each: the kernels' (the
#: all-pairs f32 and int8 distances in two paths each) and the CUDA error
#: message every wrapper raises with
SOURCES = ("gather_distance", "quantized_gather_distance",
           "distance_matrix_stream", "distance_matrix_wgmma",
           "quantized_distance_stream", "quantized_distance_wgmma",
           "segment_sum", "cuda_error")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events,
    after one warm-up call). A spin kernel holds the stream while the host
    queues the calls, so they run back to back and a call faster than its
    launch from Python is timed on the device, not at the host's launch
    rate."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def cuda_ms_each(fn, inputs: list) -> float:
    """:func:`cuda_ms` of ``fn(x)``, each call on its own input: the
    warm-up on ``inputs[0]``, then one timed call on each of the rest."""
    it = iter(inputs)
    return cuda_ms(lambda: fn(next(it)), len(inputs) - 1)


def in_turns(time_one, names=("tiled", "spread")) -> dict[str, float]:
    """``time_one(name)`` for each name in turns (a, b, b, a), averaged
    per name, so a drift of the card's clock hits both alike."""
    out = {name: 0.0 for name in names}
    for name in (*names, *reversed(names)):
        out[name] += time_one(name) / 2
    return out


class Stages:
    """Wall seconds of a phase's stages, each ending in a synchronize."""

    def __init__(self):
        self.start = self.last = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def lap(self, name: str) -> None:
        """Seconds since the previous stage, as stage ``name``."""
        sync()
        now = time.perf_counter()
        self.seconds[name] = now - self.last
        self.last = now

    def line(self) -> str:
        return (f"{time.perf_counter() - self.start:.1f}s (stages: "
                + ", ".join(f"{k} {v:.1f}" for k, v in self.seconds.items())
                + ")")


class ColdIds:
    """Id lists for cold-row timing: consecutive stretches of random
    permutations of the n rows, 20% of each list then set to -1 padding,
    so no row comes back before all n rows have been handed out (3.84 GB
    at n = 1M, d = 960: many times the 50 MB L2)."""

    def __init__(self, gen: torch.Generator, n: int):
        self.gen, self.n = gen, n
        self.perm, self.pos = None, n

    def take(self, bsz: int, k: int) -> torch.Tensor:
        dev = self.gen.device
        parts, m = [], bsz * k
        while m > 0:
            if self.pos == self.n:
                self.perm = torch.randperm(self.n, generator=self.gen,
                                           device=dev, dtype=torch.int32)
                self.pos = 0
            step = min(m, self.n - self.pos)
            parts.append(self.perm[self.pos:self.pos + step])
            self.pos += step
            m -= step
        ids = torch.cat(parts).view(bsz, k)
        r = torch.rand((bsz, k), generator=self.gen, device=dev)
        return torch.where(r < 0.2, -1, ids).contiguous()


def launch_counts() -> dict[str, int]:
    """Each kernel wrapper's launch count, by kernel name."""
    return {"gather_distance_batch": gather_distance.LAUNCHES,
            "gather_distance": gather_distance.ONE_LANE_LAUNCHES,
            "quantized_gather_distance_batch":
                quantized_gather_distance.LAUNCHES,
            "quantized_gather_distance":
                quantized_gather_distance.ONE_LANE_LAUNCHES,
            "distance_matrix": distance_matrix.PATH_LAUNCHES["stream"],
            "distance_matrix_wgmma": distance_matrix.PATH_LAUNCHES["wgmma"],
            "quantized_distance_matrix": quantized.PATH_LAUNCHES["stream"],
            "quantized_distance_matrix_wgmma":
                quantized.PATH_LAUNCHES["wgmma"],
            "csr_segment_sum": segment_sum.LAUNCHES}


def reset_counts() -> None:
    gather_distance.LAUNCHES = gather_distance.ONE_LANE_LAUNCHES = 0
    quantized_gather_distance.LAUNCHES = 0
    quantized_gather_distance.ONE_LANE_LAUNCHES = 0
    distance_matrix.LAUNCHES = quantized.LAUNCHES = segment_sum.LAUNCHES = 0
    for mod in (distance_matrix, gather_distance, quantized_gather_distance,
                quantized):
        for path in mod.PATH_LAUNCHES:
            mod.PATH_LAUNCHES[path] = 0


def gather_bound_ms(Q: torch.Tensor, ids: torch.Tensor,
                    row_bytes: int) -> float:
    """Least time for one gather-distance call on these inputs: each valid
    candidate row read once (``row_bytes``: 4d for f32 rows; d code bytes
    and the 32-byte sector of the scale for int8 rows), each id, each query
    row and each output moved once, at the card's memory rate."""
    bsz, k = ids.shape
    d = Q.shape[1]
    rows = int(torch.unique(ids[ids >= 0]).numel())
    nbytes = rows * row_bytes + 4 * bsz * k + 4 * bsz * d + 4 * bsz * k
    return nbytes / TARGET.hbm_bandwidth * 1e3


def kernel_entry(name: str, max_abs: float, timing: tuple,
                 bound_by: str = "bytes",
                 library_ms: float | None = None) -> dict:
    """One entry of the ``kernels`` JSON line (launches are filled in from
    the main path's run)."""
    source, replaces = KERNELS[name]
    ms, plain_ms, bound_ms = timing
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def device_ops(prof) -> list[tuple[str, float, int]]:
    """(name, device ms, count) of each device op (kernel, copy, fill) of
    a torch.profiler run, summed from its raw events (``key_averages()``
    builds an object an event: on a step of ~55,000 launches that costs
    ~14 s of host time). Only device events are read: a CPU op's own
    device time repeats that of the kernels it launched."""
    from torch.autograd import DeviceType

    acc: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            tc = acc.setdefault(e.name(), [0.0, 0])
            tc[0] += e.duration_ns() / 1e6
            tc[1] += 1
    return [(k, t, c) for k, (t, c) in acc.items()]


def print_ptxas(name: str) -> None:
    for ln in _build.build_info.get(name, {}).get("log", "").splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"[kernel] {name} ptxas: {ln.strip()}", flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0]
    props = torch.cuda.get_device_properties(0)
    print(f"[device] {line} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {props.name}: {props.multi_processor_count}"
          f" SMs, {props.total_memory:,} B of device memory | TARGET "
          f"{TARGET.name}: {TARGET.sm_count} SMs, {TARGET.hbm_bytes:,} B at "
          f"{TARGET.hbm_bandwidth:.3e} B/s, dense bf16 "
          f"{TARGET.peak_bf16_flops:.3e} / TF32 {TARGET.peak_tf32_flops:.3e} "
          f"/ int8 {TARGET.peak_int8_ops:.3e} / f32 {TARGET.peak_f32_flops:.3e}"
          f" op/s, {TARGET.smem_bytes:,} B shared memory a block", flush=True)
    return line


def _padded_ids(gen: torch.Generator, bsz: int, k: int, n: int,
                retire: bool = True) -> torch.Tensor:
    """Random ids in [0, n) with 20% -1 padding and out-of-range ids (>= n);
    lane 0 fully retired unless ``retire`` is False."""
    ids = torch.randint(0, n, (bsz, k), generator=gen, device=gen.device,
                        dtype=torch.int32)
    r = torch.rand((bsz, k), generator=gen, device=gen.device)
    ids = torch.where(r < 0.2, -1, ids)
    ids = torch.where((r >= 0.2) & (r < 0.25), n + 7, ids)
    if retire:
        ids[0] = -1                                 # a fully retired lane
    return ids


def _kernel_shapes() -> list[tuple[int, int]]:
    """(B, K) of every launch on the main path at this run's settings."""
    m_u = PAPER_INDEX.m_u
    m_l = 2 * m_u
    p_cap = PAPER_INDEX.build_params().new_edge_cap
    return [
        (N_QUERIES, 1),                # search: entry and seed distances
        (N_QUERIES, m_u),              # search: upper-descent steps
        (N_QUERIES, m_l),              # search: beam iterations
        (BUILD_MORSEL, 1),             # build: seeds of a morsel's searches
        (BUILD_MORSEL, m_l),           # build: insert-search iterations
        (BUILD_MORSEL, m_u + p_cap),   # build: upper-level edge merge
        (BUILD_MORSEL, m_l + p_cap),   # build: lower-level edge merge, over
        (BUILD_MORSEL * m_u, m_l + p_cap),  # up to morsel x m_u targets
    ]


def _compare(got: torch.Tensor, want: torch.Tensor,
             where: str) -> tuple[float, float]:
    """Kernel output vs plain version: identical +inf placement, rtol /
    atol elsewhere; returns (max abs, max rel) error."""
    sync()
    check(torch.equal(torch.isinf(got), torch.isinf(want)),
          f"kernel places +inf differently ({where})")
    fin = torch.isfinite(want)
    if not bool(fin.any()):
        return 0.0, 0.0
    err = (got[fin] - want[fin]).abs()
    check(bool((err <= ATOL + RTOL * want[fin].abs()).all()),
          f"kernel disagrees with its plain version ({where}): max abs err "
          f"{float(err.max())}")
    return (float(err.max()),
            float((err / want[fin].abs().clamp(min=1e-30)).max()))


def _both_schedules(launch, where: str) -> torch.Tensor:
    """``launch(schedule)`` on the tiled and the spread schedule, which
    must agree bit for bit; returns the output."""
    tiled, spread = launch("tiled"), launch("spread")
    sync()
    check(torch.equal(tiled, spread),
          f"the spread schedule != the tiled one, bit for bit ({where})")
    return tiled


def _check_kernel(vecs: torch.Tensor, qs: torch.Tensor, ids: torch.Tensor,
                  metric: str) -> tuple[float, float]:
    """f32 kernel (the schedule ``plan`` picks) vs plain version on the
    same inputs, and the two schedules against each other, bit for bit.
    The plain version runs in slices of lanes to bound its [b, K, d]
    gather."""
    where = (f"f32 {metric}, B={ids.shape[0]}, K={ids.shape[1]}, "
             f"d={qs.shape[1]}")
    got = gather_distance.gather_distance_batch(qs, vecs, ids, metric)
    check(torch.equal(got, _both_schedules(
        lambda s: gather_distance._launch(qs, vecs, ids, metric, s)[0],
        where)), f"the planned launch differs from its schedule ({where})")
    want = torch.cat([ref.gather_distance_batch(qs[i:i + 4096], vecs,
                                                ids[i:i + 4096], metric)
                      for i in range(0, qs.shape[0], 4096)])
    return _compare(got, want, where)


def _check_one_lane(one_lane, batched, plain, Q: torch.Tensor,
                    ids: torch.Tensor, where: str) -> float:
    """One-lane launches (the spread schedule) at lanes ``ONE_LANE_LANES``
    of a B = N_QUERIES batch (the tiled schedule): equal to the batch's
    lane bit for bit, and to the plain version within tolerance; max abs
    err. ``one_lane(q, ids)``, ``batched(Q, ids)`` and ``plain(q, ids)``
    are the entries under test."""
    mods = (gather_distance, quantized_gather_distance)
    before = [dict(m.PATH_LAUNCHES) for m in mods]
    batch = batched(Q, ids)
    err = 0.0
    for i in ONE_LANE_LANES:
        one = one_lane(Q[i], ids[i])
        sync()
        check(torch.equal(one, batch[i]),
              f"one-lane launch != lane {i} of the batch ({where})")
        err = max(err, _compare(one, plain(Q[i], ids[i]),
                                f"one lane {i}, {where}")[0])
    grew = {s: sum(m.PATH_LAUNCHES[s] - b[s] for m, b in zip(mods, before))
            for s in SCHEDULES}
    check(grew == {"tiled": 1, "spread": len(ONE_LANE_LANES)},
          f"the batch and the one-lane launches ran on {grew} ({where})")
    return err


def _time_schedules(launch, plain, Q: torch.Tensor, n: int,
                    row_bytes: int, gen: torch.Generator) -> tuple:
    """Both schedules of one gather kernel, timed in turns on cold rows
    (every launch on its own id list, see :class:`ColdIds`) and, for one
    lane, also L2-hot (one id list for all launches).
    ``launch(Q, ids, schedule)``, ``plain(Q, ids)``. Returns
    (one_lane, table): one_lane[K] = {(schedule, "cold" | "hot"): ms,
    "bound": ms, and at K = M_L "plain": ms (cold)}; table[B, K] =
    {schedule: ms, "bound": ms}, cold, at K = M_L for each B of
    ``SCHEDULE_BATCHES`` and at every (B, K) of the main path
    (:func:`_kernel_shapes`). A bound is the mean over the cold id lists
    its row was timed on."""
    cold = ColdIds(gen, n)

    def cold_ms(Qb, k, reps, call, used):
        """``call(ids)`` timed on ``reps`` fresh id lists, kept in
        ``used``."""
        lists = [cold.take(Qb.shape[0], k) for _ in range(reps + 1)]
        used += lists
        return cuda_ms_each(call, lists)

    def mean_bound(Qb, used):
        return float(np.mean([gather_bound_ms(Qb, ids, row_bytes)
                              for ids in used]))

    q = Q[:1]
    one_lane = {}
    for k in ONE_LANE_KS:
        used = []
        row = {(s, "cold"): ms for s, ms in in_turns(lambda s: cold_ms(
            q, k, ONE_LANE_REPS, lambda ids: launch(q, ids, s), used)).items()}
        hot = _padded_ids(gen, 1, k, n, retire=False)
        row.update({(s, "hot"): ms for s, ms in in_turns(lambda s: cuda_ms(
            lambda: launch(q, hot, s), ONE_LANE_REPS)).items()})
        row["bound"] = mean_bound(q, used)
        if k == ONE_LANE_KS[-1]:
            row["plain"] = cold_ms(q, k, 10, lambda ids: plain(q, ids), [])
        one_lane[k] = row
    shapes = sorted({(b, ONE_LANE_KS[-1]) for b in SCHEDULE_BATCHES}
                    | set(_kernel_shapes()))
    Qm = torch.randn((max(b for b, _ in shapes), Q.shape[1]), generator=gen,
                     device=gen.device)
    table = {}
    for bsz, k in shapes:
        Qb, used = Qm[:bsz], []
        table[bsz, k] = in_turns(lambda s: cold_ms(
            Qb, k, TABLE_REPS, lambda ids: launch(Qb, ids, s), used))
        table[bsz, k]["bound"] = mean_bound(Qb, used)
    return one_lane, table


def _schedule_lines(name: str, one_lane: dict, table: dict) -> str:
    """The ``[kernel]`` lines of :func:`_time_schedules`' numbers."""
    parts = []
    for k, r in one_lane.items():
        parts.append(
            f"K={k}: cold tiled {r['tiled', 'cold']:.4f}, spread "
            f"{r['spread', 'cold']:.4f} ({r['tiled', 'cold'] / r['spread', 'cold']:.2f}x); "
            f"L2-hot tiled {r['tiled', 'hot']:.4f}, spread "
            f"{r['spread', 'hot']:.4f}; bound {r['bound']:.6f} (bytes)"
            + (f"; plain (cold) {r['plain']:.4f}" if "plain" in r else ""))
    rows = [f"({b}, {k}): tiled {r['tiled']:.4f}, spread "
            f"{r['spread']:.4f} ({r['tiled'] / r['spread']:.2f}x), bound "
            f"{r['bound']:.4f}" for (b, k), r in table.items()]
    return (f"[kernel] {name} one lane (B=1, d={DIM}, l2, 20% ids -1), ms "
            f"per launch: " + "; ".join(parts)
            + f"\n[kernel] {name} schedules at (B, K), d={DIM}, cold rows, "
            f"ms per launch: " + "; ".join(rows))


def phase_launch_floor() -> dict[str, float]:
    """Per-launch device time of an empty kernel, launched as the kernels
    are (ctypes, the current stream, queued behind the spin kernel) on a
    one-lane launch's grid of each schedule at K = M_L: the floor beside
    a one-lane launch's bytes bound, which says nothing there."""
    fn = _build.bind("cuda_error", "navix_empty_kernel", [ctypes.c_int] * 3)
    dev = torch.device("cuda")
    k = ONE_LANE_KS[-1]
    grids = {"tiled": ((1, -(-k // _build.TILE_K)), 256),
             "spread": ((1, -(-k // 4)), 128)}
    floor = in_turns(lambda s: cuda_ms(
        lambda: _build.launch("empty_kernel", fn, dev, *grids[s][0],
                              grids[s][1]), reps=200))
    print("[kernel] launch floor (an empty kernel, ms per launch): "
          + ", ".join(f"{s} grid {grids[s][0]} x {grids[s][1]} threads "
                      f"{ms:.4f}" for s, ms in floor.items()), flush=True)
    return floor


def phase_kernel() -> list[dict]:
    t0 = time.perf_counter()
    _build.load("gather_distance")
    info = _build.build_info.get("gather_distance", {})
    build_s = time.perf_counter() - t0
    print_ptxas("gather_distance")

    gen = torch.Generator(device="cuda").manual_seed(0)
    vectors = torch.randn((N, DIM), generator=gen, device="cuda")
    shapes = _kernel_shapes()
    sms = _build.sm_count(vectors.device)
    check(all(gather_distance.plan(b, k, DIM, sms)[0] == "tiled"
              for b, k in shapes),
          "a launch of the main path's batched search or full morsels is "
          "not planned on the tiled schedule")
    max_abs = max_rel = 0.0
    for bsz, k in shapes:
        qs = torch.randn((bsz, DIM), generator=gen, device="cuda")
        ids = _padded_ids(gen, bsz, k, N)
        for metric in ("l2", "cos", "dot"):
            a, r = _check_kernel(vectors, qs, ids, metric)
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
    del qs, ids
    # an odd width exercises the kernel's unaligned (4-byte load) path
    v_odd = torch.randn((4096, 33), generator=gen, device="cuda")
    for bsz, k in ((64, 64), (64, 72)):
        q_odd = torch.randn((bsz, 33), generator=gen, device="cuda")
        ids = _padded_ids(gen, bsz, k, v_odd.shape[0])
        for metric in ("l2", "cos", "dot"):
            a, r = _check_kernel(v_odd, q_odd, ids, metric)
            max_abs, max_rel = max(max_abs, a), max(max_rel, r)
    # one-lane launches (the single-query search's) against lanes of a
    # tiled batch
    one_abs = 0.0
    for k in ONE_LANE_CHECK_KS:
        for vecs, d in ((vectors, DIM), (v_odd, 33)):
            Q1 = torch.randn((N_QUERIES, d), generator=gen, device="cuda")
            ids = _padded_ids(gen, N_QUERIES, k, vecs.shape[0])
            for metric in ("l2", "cos", "dot"):
                one_abs = max(one_abs, _check_one_lane(
                    lambda q, i: gather_distance.gather_distance(
                        q, vecs, i, metric),
                    lambda Q, i: gather_distance.gather_distance_batch(
                        Q, vecs, i, metric),
                    lambda q, i: ref.gather_distance(q, vecs, i, metric),
                    Q1, ids, f"f32 {metric}, K={k}, d={d}"))
    print(f"[kernel] f32: kernel == plain version at every (B, K) of the "
          f"main path (all planned tiled), d={DIM}, l2/cos/dot: "
          + ", ".join(f"({b}, {k})" for b, k in shapes)
          + "; and d=33 at (64, 64), (64, 72); the spread schedule equals "
          "the tiled one bit for bit at each; one-lane launches (spread) at "
          f"K={', '.join(map(str, ONE_LANE_CHECK_KS))}, d={DIM} and 33, "
          f"equal lanes {ONE_LANE_LANES} of a B={N_QUERIES} batch (tiled) "
          "bit for bit", flush=True)

    Q = torch.randn((N_QUERIES, DIM), generator=gen, device="cuda")
    timings = {}
    for k in (64, 32):      # beam iterations use K = M_L, the descent M_U
        ids = _padded_ids(gen, N_QUERIES, k, N)
        timings[k] = (
            cuda_ms(lambda: gather_distance.gather_distance_batch(
                Q, vectors, ids, "l2"), reps=50),
            cuda_ms(lambda: ref.gather_distance_batch(
                Q, vectors, ids, "l2"), reps=10),
            gather_bound_ms(Q, ids, 4 * DIM))
    one_lane, table = _time_schedules(
        lambda Qb, ids, s: gather_distance._launch(Qb, vectors, ids, "l2",
                                                   s)[0],
        lambda Qb, ids: ref.gather_distance_batch(Qb, vectors, ids, "l2"),
        Q, N, 4 * DIM, gen)
    shown = "; ".join(
        f"K={k}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, bound "
        f"{t[2]:.4f} ms (bytes)" for k, t in timings.items())
    print(f"[kernel] gather_distance_batch built in {build_s:.3f}s "
          f"(nvcc {info.get('seconds', 0.0):.3f}s); max abs err {max_abs:.3e}"
          f", max rel err {max_rel:.3e} (rtol {RTOL}, atol {ATOL}); B="
          f"{N_QUERIES} d={DIM} l2, 20% ids -1: {shown}; one lane: max abs "
          f"err {one_abs:.3e}", flush=True)
    print(_schedule_lines("gather_distance", one_lane, table), flush=True)
    m_l = one_lane[ONE_LANE_KS[-1]]
    return [kernel_entry("gather_distance_batch", max_abs, timings[64]),
            kernel_entry("gather_distance", one_abs,
                         (m_l["spread", "cold"], m_l["plain"],
                          m_l["bound"]))]


def phase_kernel_int8() -> list[dict]:
    t0 = time.perf_counter()
    _build.load("quantized_gather_distance")
    info = _build.build_info.get("quantized_gather_distance", {})
    build_s = time.perf_counter() - t0
    print_ptxas("quantized_gather_distance")

    gen = torch.Generator(device="cuda").manual_seed(1)
    stores = {}
    for n, d in ((N, DIM), (4096, 33)):
        X = torch.randn((n, d), generator=gen, device="cuda")
        X[3] = 0.0                                   # scale 1, codes 0
        stores[d] = quantize(X)
        del X
        check(float(stores[d].scale[3]) == 1.0, "all-zero row: scale != 1")
    max_abs = {"batch": 0.0, "one": 0.0}
    for d, store in stores.items():
        c, sc = store.codes, store.scale
        for k in ONE_LANE_CHECK_KS:
            qs = torch.randn((N_QUERIES, d), generator=gen, device="cuda")
            ids = _padded_ids(gen, N_QUERIES, k, store.n)
            ids[-1, 0] = 3                           # the all-zero row
            for metric in ("l2", "cos", "dot"):
                where = f"int8 {metric}, B={N_QUERIES}, K={k}, d={d}"
                got = quantized_gather_distance.quantized_gather_distance_batch(
                    qs, c, sc, ids, metric)
                check(torch.equal(got, _both_schedules(
                    lambda s: quantized_gather_distance._launch(
                        qs, c, sc, ids, metric, s)[0], where)),
                      f"the planned launch differs from its schedule "
                      f"({where})")
                max_abs["batch"] = max(max_abs["batch"], _compare(
                    got, ref.quantized_gather_distance_batch(
                        qs, c, sc, ids, metric), where)[0])
                max_abs["one"] = max(max_abs["one"], _check_one_lane(
                    lambda q, i: quantized_gather_distance
                    .quantized_gather_distance(q, c, sc, i, metric),
                    lambda Q, i: quantized_gather_distance
                    .quantized_gather_distance_batch(Q, c, sc, i, metric),
                    lambda q, i: ref.quantized_gather_distance(q, c, sc, i,
                                                               metric),
                    qs, ids, where))
    print(f"[kernel] int8: kernel == plain version at (B, K) = "
          + ", ".join(f"({N_QUERIES}, {k})" for k in ONE_LANE_CHECK_KS)
          + f" (tiled), d={DIM} and d=33, l2/cos/dot, codes from quantize() "
          "with an all-zero row, 20% ids -1, ids >= n, a fully retired lane;"
          " the spread schedule equals the tiled one bit for bit; one-lane "
          f"launches (spread) equal lanes {ONE_LANE_LANES} of the batch bit "
          "for bit", flush=True)

    store = stores[DIM]
    Q = torch.randn((N_QUERIES, DIM), generator=gen, device="cuda")
    c, sc = store.codes, store.scale
    timings = {}
    for k in (64, 32):
        ids = _padded_ids(gen, N_QUERIES, k, N)
        timings[k] = (
            cuda_ms(lambda: quantized_gather_distance
                    .quantized_gather_distance_batch(Q, c, sc, ids, "l2"),
                    reps=50),
            cuda_ms(lambda: ref.quantized_gather_distance_batch(
                Q, c, sc, ids, "l2"), reps=10),
            gather_bound_ms(Q, ids, DIM + SECTOR_BYTES))
    one_lane, table = _time_schedules(
        lambda Qb, ids, s: quantized_gather_distance._launch(
            Qb, c, sc, ids, "l2", s)[0],
        lambda Qb, ids: ref.quantized_gather_distance_batch(Qb, c, sc, ids,
                                                            "l2"),
        Q, N, DIM + SECTOR_BYTES, gen)
    shown = "; ".join(
        f"K={k}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, bound "
        f"{t[2]:.4f} ms (bytes, {100 * t[2] / t[0]:.1f}% of it reached)"
        for k, t in timings.items())
    print(f"[kernel] quantized_gather_distance_batch built in {build_s:.3f}s "
          f"(nvcc {info.get('seconds', 0.0):.3f}s); max abs err "
          f"{max_abs['batch']:.3e} (rtol {RTOL}, atol {ATOL}); B="
          f"{N_QUERIES} d={DIM} l2, 20% ids -1: {shown}; one lane: max abs "
          f"err {max_abs['one']:.3e}", flush=True)
    print(_schedule_lines("quantized_gather_distance", one_lane, table),
          flush=True)
    m_l = one_lane[ONE_LANE_KS[-1]]
    return [kernel_entry("quantized_gather_distance_batch",
                         max_abs["batch"], timings[64]),
            kernel_entry("quantized_gather_distance", max_abs["one"],
                         (m_l["spread", "cold"], m_l["plain"],
                          m_l["bound"]))]


def phase_build_kernels() -> None:
    """Build every kernel source at once (one nvcc each, in parallel)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(_build.load, SOURCES))
    nvcc_s = {n: _build.build_info.get(n, {}).get("seconds", 0.0)
              for n in SOURCES}
    for name in SOURCES:
        print_ptxas(name)
    print(f"[kernel] built {len(SOURCES)} sources in parallel in "
          f"{time.perf_counter() - t0:.3f}s (nvcc: "
          + ", ".join(f"{n} {s:.3f}s" for n, s in nvcc_s.items()) + ")",
          flush=True)


def _check_close(got: torch.Tensor, want: torch.Tensor, tol: float,
                 where: str) -> float:
    """Kernel vs plain version within rtol = atol = ``tol``, all finite;
    returns the max abs error."""
    sync()
    check(bool(torch.isfinite(got).all()),
          f"non-finite kernel output ({where})")
    err = (got - want).abs()
    check(bool((err <= tol + tol * want.abs()).all()),
          f"kernel disagrees with its plain version ({where}): max abs err "
          f"{float(err.max())}")
    return float(err.max())


def _matrix_bound(b: int, n: int, d: int, code_bytes: int, metric: str,
                  route: str | None = None) -> tuple[float, str]:
    """Least time of one all-pairs call: Q, X (4 or 1 bytes a value, and a
    4-byte scale a row for int8 codes) and D moved once; the 2bnd flops of
    the products as tensor-core operations on ``route`` (a key of
    ``ROUTES``; by default the cheapest f32-accurate one for the operand,
    ``CHEAPEST_ROUTE``), and the norms' 2(b + n)d f32 flops for l2.
    ``route="f32"``: every flop at the f32 rate outside the tensor cores
    (the bound of the earlier, CUDA-core kernels). In milliseconds, from
    ``repro_torch.common.hardware.bound_s``."""
    nbytes = 4 * b * d + code_bytes * n * d + 4 * b * n
    if code_bytes == 1:
        nbytes += 4 * n
    products = 2 * b * n * d
    norms = 2 * (b + n) * d if metric == "l2" else 0
    if route == "f32":
        b_s, by = bound_s(nbytes, products + norms)
    else:
        k, rate = ROUTES[route or CHEAPEST_ROUTE[code_bytes]]
        b_s, by = bound_s(nbytes, norms, k * products, rate)
    return b_s * 1e3, by


def _timing_line(name: str, rows: dict, library: str | None,
                 axes: str = "(b, n, d)",
                 other: tuple[str, dict] | None = None) -> str:
    """One line of kernel, plain and library times against the bound, per
    shape; ``other``: (label, per shape another bound), shown beside."""
    parts = []
    for shape, (ms, plain_ms, (b_ms, by), lib_ms) in rows.items():
        lib = (f", {library} {lib_ms:.4f} ms ({100 * b_ms / lib_ms:.1f}%)"
               if lib_ms is not None else "")
        was = ""
        if other is not None:
            o_ms, o_by = other[1][shape]
            was = (f"; {other[0]} {o_ms:.4f} ms ({o_by}), "
                   f"{100 * o_ms / ms:.1f}% of it")
        parts.append(f"{shape}: kernel {ms:.4f} ms ({100 * b_ms / ms:.1f}% "
                     f"of the bound), plain {plain_ms:.4f} ms "
                     f"({100 * b_ms / plain_ms:.1f}%){lib}, bound "
                     f"{b_ms:.4f} ms ({by}){was}")
    return f"[kernel] {name} {axes}: " + "; ".join(parts)


def phase_kernel_matrix() -> list[dict]:
    """Kernel 5 on both paths against its plain version at every metric
    and shape, each path's bitwise claim (a lone row equals its row in a
    streaming batch; the last 64 rows alone equal the same rows of a
    tensor-core batch), then timed (dot, the retrieval's metric) beside
    ``torch.matmul(Q, X.T)``. The tensor-core path, which no user path
    reaches yet, is driven once through its ops entry (its whole path) at
    the serve batch's shape."""
    for path in distance_matrix.PATH_LAUNCHES:
        info = _build.build_info.get(f"distance_matrix_{path}", {})
        regs = sorted({ln.split("Used")[1].split(",")[0].strip()
                       for ln in info.get("log", "").splitlines()
                       if "Used" in ln})
        spills = sorted({ln.split(",")[1].strip()
                         for ln in info.get("log", "").splitlines()
                         if "spill stores" in ln})
        print(f"[kernel] distance_matrix path {path} "
              f"(csrc/distance_matrix_{path}.cu): ptxas {', '.join(regs)}; "
              f"{', '.join(spills)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    max_abs = {"stream": 0.0, "wgmma": 0.0}
    rows, old, paths, launches = {}, {}, {}, 0
    for b, n, d in MATRIX_SHAPES:
        Q = torch.randn((b, d), generator=gen, device="cuda")
        X = torch.randn((n, d), generator=gen, device="cuda")
        path = distance_matrix.plan(Q, X)[0]
        paths[(b, n, d)] = path
        for metric in ("l2", "cos", "dot"):
            got = distance_matrix.distance_matrix(Q, X, metric)
            max_abs[path] = max(max_abs[path], _check_close(
                got, ref.distance_matrix(Q, X, metric), MATRIX_TOL,
                f"distance_matrix {metric} ({b}, {n}, {d}), {path} path"))
            part = Q[-1:] if path == "stream" else Q[-64:]
            alone = distance_matrix.distance_matrix(part, X, metric)
            sync()
            check(torch.equal(alone, got[-part.shape[0]:]),
                  f"distance_matrix {metric} ({b}, {n}, {d}): the last "
                  f"{part.shape[0]} rows alone differ from the batch's")
            del got, alone
        rows[(b, n, d)] = (
            cuda_ms(lambda: distance_matrix.distance_matrix(Q, X, "dot"),
                    reps=20),
            cuda_ms(lambda: ref.distance_matrix(Q, X, "dot"), reps=10),
            _matrix_bound(b, n, d, 4, "dot"),
            cuda_ms(lambda: torch.matmul(Q, X.T), reps=20))
        old[(b, n, d)] = _matrix_bound(b, n, d, 4, "dot", route="f32")
        if (b, n, d) == MATRIX_SHAPES[2]:
            reset_counts()                   # the wgmma path: its ops entry
            ops.distance_matrix(Q, X, "dot")
            sync()
            launches = distance_matrix.PATH_LAUNCHES["wgmma"]
        del Q, X
        torch.cuda.empty_cache()
    print("[kernel] distance_matrix == plain version, l2/cos/dot, at "
          + ", ".join(f"{s} ({p})" for s, p in paths.items())
          + f": max abs err stream {max_abs['stream']:.3e}, wgmma "
          f"{max_abs['wgmma']:.3e} (rtol = atol = {MATRIX_TOL}); a lone row "
          "equals its row of a streaming batch, the last 64 rows alone equal "
          "the same rows of a tensor-core batch, bit for bit", flush=True)
    print(_timing_line("distance_matrix, dot", rows,
                       "torch.matmul(Q, X.T) (TF32 off)",
                       other=("f32-only bound", old))
          + "; bound: bytes at 3.35 TB/s or 3 TF32 products a product at "
          "495 TFLOP/s", flush=True)
    entries = []
    for name, shape in (("distance_matrix", MATRIX_SHAPES[0]),
                        ("distance_matrix_wgmma", MATRIX_SHAPES[2])):
        ms, plain_ms, (b_ms, by), lib_ms = rows[shape]
        entries.append(kernel_entry(name, max_abs[paths[shape]],
                                    (ms, plain_ms, b_ms), by, lib_ms))
    entries[1]["launches"] = launches
    return entries


def _f64_error(got: torch.Tensor, plain: torch.Tensor, Q: torch.Tensor,
               codes: torch.Tensor, scale: torch.Tensor,
               metric: str) -> tuple[float, float]:
    """(max abs error of ``got``, of ``plain``) against the kernel's form in
    float64 from the same Q, codes and scale: l2 ||q||^2 + s^2 (c.c) -
    2 s (q.c), cos 1 - s (q.c), dot -s (q.c); in slices of codes to bound
    the float64 copies."""
    Q64 = Q.double()
    qq = (Q64 * Q64).sum(1)[:, None]
    err = [0.0, 0.0]
    for i in range(0, codes.shape[0], 1 << 17):
        c64 = codes[i:i + (1 << 17)].double()
        s64 = scale[i:i + (1 << 17)].double()[None, :]
        sdot = (Q64 @ c64.T) * s64
        if metric == "l2":
            exact = qq + (s64 * s64) * (c64 * c64).sum(1)[None, :] - 2 * sdot
        elif metric == "cos":
            exact = 1 - sdot
        else:
            exact = -sdot
        for j, t in enumerate((got, plain)):
            err[j] = max(err[j], float(
                (t[:, i:i + (1 << 17)].double() - exact).abs().max()))
        del c64, sdot, exact
    return err[0], err[1]


def _quant_inputs(gen: torch.Generator, b: int, n: int, d: int) -> tuple:
    """Q f32[b, d] normal, codes int8[n, d] uniform in -127 .. 127, scale
    f32[n] in [1e-3, 0.021) with every 1000th scale 0 (all-zero rows)."""
    Q = torch.randn((b, d), generator=gen, device="cuda")
    codes = torch.randint(-127, 128, (n, d), generator=gen, device="cuda",
                          dtype=torch.int8)
    scale = torch.rand((n,), generator=gen, device="cuda") * 0.02 + 1e-3
    scale[::1000] = 0.0
    return Q, codes, scale


def _check_quant(Q, codes, scale, metric: str, where: str) -> dict:
    """Kernel 6 through its wrapper (the path ``plan`` picks) against the
    plain version (rtol = atol = ``QUANT_TOL``) and against float64 (at
    most ``F64_ERR_RATIO`` times the plain version's error), and the path's
    bitwise claim: the last row (streaming) or the last 64 rows (tensor
    cores) computed alone, on the same path, equal the batch's. Returns
    {"path", "err" (vs plain), "f64", "plain_f64"}."""
    path = quantized.plan(Q, codes)[0]
    before = dict(quantized.PATH_LAUNCHES)
    got = quantized.quantized_distance_matrix(Q, codes, scale, metric)
    sync()
    check(quantized.PATH_LAUNCHES[path] == before[path] + 1,
          f"quantized_distance {where}: not launched on its {path} path")
    plain = ref.quantized_distance_matrix(Q, codes, scale, metric)
    err = _check_close(got, plain, QUANT_TOL,
                       f"quantized_distance {metric} {where}, {path} path")
    f64, plain_f64 = _f64_error(got, plain, Q, codes, scale, metric)
    check(f64 <= F64_ERR_RATIO * plain_f64,
          f"quantized_distance {metric} {where}, {path} path: max abs err "
          f"{f64:.3e} against float64, over {F64_ERR_RATIO} x the plain "
          f"version's {plain_f64:.3e}")
    part = Q[-1:] if path == "stream" else Q[-64:]
    alone = quantized._launch(part, codes, scale, metric, path)[0]
    sync()
    check(torch.equal(alone, got[-part.shape[0]:]),
          f"quantized_distance {metric} {where}, {path} path: the last "
          f"{part.shape[0]} rows alone differ from the batch's")
    return {"path": path, "err": err, "f64": f64, "plain_f64": plain_f64}


def phase_kernel_quantized() -> list[dict]:
    """Kernel 6 on both paths against its plain version and float64 at
    every metric and shape (with zero-scale rows), each path's bitwise
    claim, the same at b on both sides of ``STREAM_MAX_BATCH``; timed (l2)
    beside the composite a user would write (dequantize, then
    ``torch.matmul`` with TF32 off); both paths timed in turns across
    ``QUANT_SWEEP_BATCHES`` at (1M, 960); each path driven once through
    the ops entry (its whole path) at its shape."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    errs = {"stream": [0.0, 0.0, 0.0], "wgmma": [0.0, 0.0, 0.0]}
    rows, tf32x2, launches, paths = {}, {}, {}, {}
    sweep, t_max = {}, quantized.STREAM_MAX_BATCH
    for b, n, d in QUANT_SHAPES:
        Q, codes, scale = _quant_inputs(gen, b, n, d)
        for metric in ("l2", "cos", "dot"):
            r = _check_quant(Q, codes, scale, metric, f"({b}, {n}, {d})")
            paths[(b, n, d)] = r["path"]
            e = errs[r["path"]]
            errs[r["path"]] = [max(e[0], r["err"]), max(e[1], r["f64"]),
                               max(e[2], r["plain_f64"])]
        rows[(b, n, d)] = (
            cuda_ms(lambda: quantized.quantized_distance_matrix(
                Q, codes, scale, "l2"), reps=10),
            cuda_ms(lambda: ref.quantized_distance_matrix(
                Q, codes, scale, "l2"), reps=5),
            _matrix_bound(b, n, d, 1, "l2"),
            cuda_ms(lambda: torch.matmul(
                Q, (codes.to(torch.float32) * scale[:, None]).T), reps=5))
        tf32x2[(b, n, d)] = _matrix_bound(b, n, d, 1, "l2", route="tf32x2")
        reset_counts()                   # its path: the ops entry
        ops.quantized_distance_matrix(Q, codes, scale, "l2")
        sync()
        launches[paths[(b, n, d)]] = \
            quantized.PATH_LAUNCHES[paths[(b, n, d)]]
        if (b, n, d) == QUANT_SHAPES[0]:
            # b on both sides of the threshold, then the sweep, on the
            # scan's codes
            for bt in (t_max, t_max + 1):
                Qt = torch.randn((bt, d), generator=gen, device="cuda")
                for metric in ("l2", "cos", "dot"):
                    r = _check_quant(Qt, codes, scale, metric,
                                     f"({bt}, {n}, {d})")
                    check(r["path"] == ("stream" if bt == t_max
                                        else "wgmma"),
                          f"b={bt} planned on the {r['path']} path")
            Qs = torch.randn((max(QUANT_SWEEP_BATCHES), d), generator=gen,
                             device="cuda")
            for bs in QUANT_SWEEP_BATCHES:
                Qb = Qs[:bs]
                sweep[bs] = in_turns(lambda p: cuda_ms(
                    lambda: quantized._launch(Qb, codes, scale, "l2", p),
                    reps=5), names=("stream", "wgmma"))
                sweep[bs]["bound"] = _matrix_bound(bs, n, d, 1, "l2")[0]
            del Qs, Qb, Qt
        del Q, codes, scale
        torch.cuda.empty_cache()
    print("[kernel] quantized_distance == plain version, l2/cos/dot, at "
          + ", ".join(f"{s} ({p})" for s, p in paths.items())
          + f" and b = {t_max} (stream), {t_max + 1} (wgmma) against the "
          f"scan's codes, every 1000th scale 0: max abs err "
          + ", ".join(f"{p} {e[0]:.3e}" for p, e in errs.items())
          + f" (rtol = atol = {QUANT_TOL}); against float64: "
          + ", ".join(f"{p} {e[1]:.3e} (plain {e[2]:.3e}, "
                      f"{e[1] / e[2]:.2f}x)" for p, e in errs.items())
          + f" (at most {F64_ERR_RATIO}x the plain version's); the last row "
          "alone equals its row of a streaming batch, the last 64 rows alone "
          "the same rows of a tensor-core batch, bit for bit", flush=True)
    print(_timing_line("quantized_distance, l2", rows,
                       "dequantize + torch.matmul (two calls, TF32 off)",
                       other=("2xTF32 bound", tf32x2))
          + "; bound: bytes at 3.35 TB/s or 3 BF16 products a product at "
          "989 TFLOP/s (int8 codes are exact in BF16; Q in three pieces)",
          flush=True)
    wins = [bs for bs, t in sweep.items() if t["stream"] <= t["wgmma"]]
    print(f"[kernel] quantized_distance paths at (b, {QUANT_SHAPES[0][1]}, "
          f"{QUANT_SHAPES[0][2]}), l2, ms (stream / wgmma, bound): "
          + "; ".join(f"b={bs}: {t['stream']:.4f} / {t['wgmma']:.4f}, "
                      f"{t['bound']:.4f}" for bs, t in sweep.items())
          + f"; stream faster at b = {wins}; STREAM_MAX_BATCH = {t_max}",
          flush=True)
    entries = []
    for name, shape in (("quantized_distance_matrix", QUANT_SHAPES[0]),
                        ("quantized_distance_matrix_wgmma", QUANT_SHAPES[1])):
        ms, plain_ms, (b_ms, by), _ = rows[shape]
        # library: none; the composite above is two calls (dequantize, then
        # matmul) and leaves out the metric's epilogue
        entry = kernel_entry(name, errs[paths[shape]][0],
                             (ms, plain_ms, b_ms), by)
        entry["launches"] = launches.get(paths[shape], 0)
        entries.append(entry)
    return entries


def _segment_inputs(gen: torch.Generator, dst: torch.Tensor, d: int):
    """(messages, dst with sentinel padding, dst with -1 padding) for sorted
    destinations ``dst``: E padded to a multiple of 512, messages made on
    the card."""
    e = dst.numel()
    e_pad = -(-e // 512) * 512
    pad = torch.full((e_pad - e,), segment_sum.PAD_SENTINEL,
                     dtype=torch.int32, device="cuda")
    dst_sent = torch.cat([dst, pad])
    dst_minus = torch.cat([dst, torch.full_like(pad, -1)])
    msgs = torch.randn((e_pad, d), generator=gen, device="cuda")
    return msgs, dst_sent, dst_minus


def _powerlaw_dst(gen: torch.Generator, n: int, e: int) -> torch.Tensor:
    """int32[e] sorted destinations drawn on the card by the law of
    ``random_power_law_graph``: node r (its rank - 1, so the hub is node 0)
    with weight (r + 1)^-(OGB_POWERLAW_ALPHA / 2), by inverse CDF."""
    w = torch.arange(1, n + 1, dtype=torch.float64, device="cuda")
    cdf = torch.cumsum(w.pow_(-OGB_POWERLAW_ALPHA / 2), 0)
    cdf /= cdf[-1].clone()
    u = torch.rand((e,), generator=gen, dtype=torch.float64, device="cuda")
    ids = torch.searchsorted(cdf, u).clamp_(max=n - 1).to(torch.int32)
    del w, cdf, u
    return torch.sort(ids).values


def _library_lengths(dst_sent: torch.Tensor, n: int) -> torch.Tensor:
    """int64[n + 1]: ``torch.segment_reduce``'s lengths of the n nodes and
    the padding, from the sorted destinations."""
    row_ptr = torch.searchsorted(
        dst_sent, torch.arange(n + 1, dtype=torch.int32, device="cuda"))
    return torch.cat([row_ptr.diff(), dst_sent.numel() - row_ptr[-1:]])


def _in_turns_rounds(calls: dict, rounds: int, reps: int) -> dict:
    """Per call name the list of ``rounds`` times (ms, the mean of ``reps``
    calls each), the calls timed in turns (a, b, c, c, b, a, ...), so a
    drift of the card's clock hits all alike."""
    out = {name: [] for name in calls}
    for r in range(rounds):
        for name in (calls if r % 2 == 0 else reversed(calls)):
            out[name].append(cuda_ms(calls[name], reps=reps))
    return out


def _rounds_line(what: str, rounds: dict, labels: dict,
                 tag: str = "[kernel]") -> str:
    med = {k: float(np.median(v)) for k, v in rounds.items()}
    parts = [f"{labels[k]} median {med[k]:.4f} ms (range {min(v):.4f}-"
             f"{max(v):.4f}; per round {[round(x, 4) for x in v]})"
             for k, v in rounds.items()]
    first = next(iter(rounds))
    ratios = ", ".join(f"{first} / {k} {med[first] / med[k]:.4f}"
                       for k in list(rounds)[1:])
    return f"{tag} csr_segment_sum {what}: " + "; ".join(parts) + \
        f"; {ratios}"


def _segment_check_powerlaw(msgs, dst_sent, got, n: int, deg: torch.Tensor,
                            where: str) -> float:
    """The kernel on a skewed graph: nodes of at most SEGMENT_HUB_DEGREE
    edges against the plain version at SEGMENT_TOL; the hub rows above it,
    whose f32 sums differ in order over up to ~400k adds, against a float64
    sum, at most F64_ERR_RATIO times the plain version's error there.
    Returns the max abs error against the plain version on the checked
    nodes."""
    plain = ref.csr_segment_sum(msgs, dst_sent, n)
    low = deg <= SEGMENT_HUB_DEGREE
    max_abs = _check_close(got[low], plain[low], SEGMENT_TOL,
                           f"{where}, nodes of <= {SEGMENT_HUB_DEGREE} edges")
    hub = torch.nonzero(~low).squeeze(1)
    exact = torch.zeros((n + 1, msgs.shape[1]), dtype=torch.float64,
                        device="cuda")
    safe = torch.where(dst_sent < n, dst_sent, n).long()
    step = 1 << 22
    for r in range(0, msgs.shape[0], step):
        exact.index_add_(0, safe[r:r + step], msgs[r:r + step].double())
    exact = exact[hub]
    err_k = float((got[hub].double() - exact).abs().max())
    err_p = float((plain[hub].double() - exact).abs().max())
    check(bool(torch.isfinite(got).all()) and err_k <= F64_ERR_RATIO * err_p,
          f"csr_segment_sum ({where}): hub rows' max abs error against "
          f"float64 {err_k} > {F64_ERR_RATIO} x the plain version's {err_p}")
    print(f"[kernel] csr_segment_sum == plain version on {where}: max abs "
          f"err {max_abs:.3e} on the {int(low.sum()):,} nodes of <= "
          f"{SEGMENT_HUB_DEGREE} edges (rtol = atol = {SEGMENT_TOL}); on the "
          f"{hub.numel():,} hub nodes against float64: kernel {err_k:.3e}, "
          f"plain version {err_p:.3e} (at most {F64_ERR_RATIO}x it)",
          flush=True)
    return max_abs


def phase_kernel_segment() -> dict:
    """Kernel 7 at meshgraphnet's ogb_products size (n, E, d = 128) on two
    graphs, messages made on the card, destinations sorted, padding at the
    end. Uniform destinations: the kernel against its plain version
    (``index_add_``), two calls bit for bit, driven once through its ops
    entry (its whole path) with -1 padding, then timed in turns beside
    ``torch.segment_reduce`` given its lengths and making them from the
    destinations. ``ogb_products_powerlaw`` (destinations by
    ``random_power_law_graph``'s law, a hub of ~400k edges): against the
    plain version and, on the hub rows, float64, then timed in turns beside
    ``torch.segment_reduce``."""
    n, e, d = OGB_NODES, OGB_EDGES, OGB_D
    gen = torch.Generator(device="cuda").manual_seed(7)
    dst = torch.sort(torch.randint(0, n, (e,), generator=gen, device="cuda",
                                   dtype=torch.int32)).values
    msgs, dst_sent, dst_minus = _segment_inputs(gen, dst, d)
    e_pad = msgs.shape[0]
    del dst
    got = segment_sum.csr_segment_sum(msgs, dst_sent, n)
    max_abs = _check_close(got, ref.csr_segment_sum(msgs, dst_sent, n),
                           SEGMENT_TOL, f"csr_segment_sum n={n} E={e} d={d}")
    check(torch.equal(segment_sum.csr_segment_sum(msgs, dst_sent, n), got),
          "csr_segment_sum: two calls differ (ogb_products)")
    reset_counts()                                   # its path: the ops entry
    via_ops = ops.csr_segment_sum(msgs, dst_minus, n)
    sync()
    launches = segment_sum.LAUNCHES
    check(torch.equal(via_ops, got),
          "the ops entry on -1 padding != the kernel on sentinel padding")
    del got, via_ops, dst_minus
    lengths = _library_lengths(dst_sent, n)
    b_s, by = bound_s(4 * e * d + 4 * e_pad + 4 * n * d, e * d)
    b_ms = b_s * 1e3
    # (a) the wrapper's whole call from dst_sorted; (b) the library call
    # given its lengths; (c) the library call making them from dst_sorted
    calls = {"kernel": lambda: segment_sum.csr_segment_sum(msgs, dst_sent, n),
             "library": lambda: torch.segment_reduce(
                 msgs, "sum", lengths=lengths, axis=0, unsafe=True),
             "library_from_dst": lambda: torch.segment_reduce(
                 msgs, "sum", lengths=_library_lengths(dst_sent, n), axis=0,
                 unsafe=True)}
    rounds = _in_turns_rounds(calls, SEGMENT_ROUNDS, SEGMENT_REPS)
    med = {name: float(np.median(v)) for name, v in rounds.items()}
    t = (med["kernel"],
         cuda_ms(lambda: ref.csr_segment_sum(msgs, dst_sent, n), reps=3),
         (b_ms, by), med["library"])
    rows, spans = segment_sum.plan(e_pad, d)
    print(f"[kernel] csr_segment_sum == plain version (index_add_) on "
          f"ogb_products, n={n:,} E={e:,} (padded to {e_pad:,}) d={d}: max "
          f"abs err {max_abs:.3e} (rtol = atol = {SEGMENT_TOL}); two calls "
          f"equal bit for bit; the ops entry on -1 padding equals the kernel "
          f"on sentinel padding ({launches} launches: {spans:,} spans of "
          f"{rows} rows, then the fix-up)", flush=True)
    print(_timing_line("csr_segment_sum", {(n, e, d): t},
                       "torch.segment_reduce(sum, lengths)", "(n, E, d)"),
          flush=True)
    print(_rounds_line(
        f"on ogb_products in turns, {SEGMENT_ROUNDS} rounds of "
        f"{SEGMENT_REPS} calls", rounds,
        {"kernel": "(a) kernel, the whole call from dst_sorted",
         "library": "(b) torch.segment_reduce given lengths",
         "library_from_dst": "(c) torch.segment_reduce with searchsorted + "
                             "diff making its lengths from dst_sorted"}),
          flush=True)
    del msgs, dst_sent, lengths
    torch.cuda.empty_cache()

    # ogb_products_powerlaw: the same n, E and d, skewed destinations
    dst = _powerlaw_dst(gen, n, e)
    deg = torch.bincount(dst, minlength=n)
    top = torch.topk(deg, 10).values
    msgs, dst_sent, _ = _segment_inputs(gen, dst, d)
    del dst
    got = segment_sum.csr_segment_sum(msgs, dst_sent, n)
    where = f"ogb_products_powerlaw (alpha {OGB_POWERLAW_ALPHA})"
    pl_abs = _segment_check_powerlaw(msgs, dst_sent, got, n, deg, where)
    check(torch.equal(segment_sum.csr_segment_sum(msgs, dst_sent, n), got),
          f"csr_segment_sum: two calls differ ({where})")
    del got
    lengths = _library_lengths(dst_sent, n)
    calls = {"kernel": lambda: segment_sum.csr_segment_sum(msgs, dst_sent, n),
             "library": lambda: torch.segment_reduce(
                 msgs, "sum", lengths=lengths, axis=0, unsafe=True)}
    one = cuda_ms(calls["library"], reps=1)
    pl_rounds, pl_reps = ((SEGMENT_ROUNDS, SEGMENT_REPS)
                          if one <= SEGMENT_SLOW_MS else (3, 1))
    rounds = _in_turns_rounds(calls, pl_rounds, pl_reps)
    print(f"[kernel] {where}: n={n:,} E={e:,} d={d}, largest degree "
          f"{int(top[0]):,}, {int(top.sum()):,} edges in the top 10 nodes, "
          f"{int((deg > segment_sum.plan(e, d)[0]).sum()):,} nodes longer "
          f"than a span; two calls equal bit for bit", flush=True)
    print(_rounds_line(
        f"on {where} in turns, {pl_rounds} rounds of {pl_reps} calls"
        + ("" if pl_rounds == SEGMENT_ROUNDS else
           f" (one segment_reduce call took {one:.1f} ms > "
           f"{SEGMENT_SLOW_MS:.0f})"), rounds,
        {"kernel": "kernel", "library": "torch.segment_reduce given lengths"}),
          flush=True)
    pl_med = float(np.median(rounds["kernel"]))
    print(f"[kernel] csr_segment_sum ogb_products_powerlaw / ogb_products: "
          f"{pl_med / t[0]:.4f} (max abs err {pl_abs:.3e} there)", flush=True)
    del msgs, dst_sent, lengths, deg
    torch.cuda.empty_cache()
    entry = kernel_entry("csr_segment_sum", max_abs, (t[0], t[1], b_ms), by,
                         t[3])
    entry["launches"] = launches
    return entry


def _gnn_block(sampler: NeighborSampler, feats: np.ndarray,
               targets: np.ndarray, rng: np.random.Generator, n_seeds: int,
               d_edge: int, rows: tuple[int, int], device) -> dict:
    """One sampled block (``n_seeds`` distinct seeds), its node and edge
    rows padded to ``rows`` (-1 edges, zero features, masked nodes), as
    tensors on ``device``."""
    seeds = rng.choice(len(feats), size=n_seeds, replace=False)
    b = sampler.block_batch(seeds, feats, targets, d_edge=d_edge)
    for k, v in b.items():
        pad = rows[k.startswith("edge_")] - len(v)
        check(pad >= 0, f"[gnn] a block's {k} has {len(v)} rows > {rows}")
        fill = -1 if k in ("edge_src", "edge_dst") else 0
        b[k] = np.concatenate([v, np.full((pad,) + v.shape[1:], fill,
                                          v.dtype)])
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def gnn_graph():
    """[gnn]'s host graph: ``random_power_law_graph`` at the shape's
    nodes and feature width, GNN_AVG_DEGREE edges a node, seed 0."""
    shape = get_arch(GNN_ARCH).shape(GNN_SHAPE)
    return random_power_law_graph(shape["n_nodes"], GNN_AVG_DEGREE,
                                  shape["d_feat"], seed=0)


def _to_cpu(tree):
    paths, treedef = tree_flatten_with_path(tree)
    return tree_unflatten(treedef, [t.cpu() for _, t in paths])


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want| (both on the CPU, as f32)."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def phase_gnn(smi: str, graph) -> int:
    """MeshGraphNet's full CONFIG (15 blocks, d_hidden 128, bf16 compute,
    remat) trained on minibatch_lg blocks through the port's loop, kernel 7
    aggregating every block's messages. Checks: every kernel-7 call of a
    forward against its plain version on the same inputs; the segment
    sum's backward against autograd through the plain version, bit for
    bit; at f32 compute, one forward and every parameter gradient on the
    card against a CPU copy of the same block and parameters; GNN_STEPS
    AdamW steps through ``training.loop.train`` with checkpoints, every loss
    finite, the last checkpoint reloaded equal to the trained tree bit for
    bit, and one more step resumed from it; kernel 7's launches on that path
    = steps x blocks x 2 (remat) x its launches a call, and no other
    kernel's. Then one step profiled: kernel 7's device ms and share beside
    its bound. Kernel 7 is also timed on the first block's first aggregate
    in turns with ``torch.segment_reduce`` given its lengths. ``graph`` is
    ``_timed_call(gnn_graph)``'s result. Returns the path's kernel-7
    launches."""
    lap = (stages := Stages()).lap

    arch = get_arch(GNN_ARCH)
    shape = arch.shape(GNN_SHAPE)
    cfg = model_api.resolve_config(arch.config, shape)
    n_pad, e_pad = model_api._gnn_block_sizes(shape)
    fanouts = (shape["fanout1"], shape["fanout2"])
    (csr, feats), graph_s = graph
    rng = np.random.default_rng(1)
    targets = rng.normal(size=(len(feats), cfg.out_dim)).astype(np.float32)
    sampler = NeighborSampler(csr, fanouts=fanouts, seed=0)
    lap("targets")
    sample_s = []

    def block(n_seeds=shape["batch_nodes"]):
        """A block of ``n_seeds`` seeds: padded to the shape's rows for
        the batch size, to its own rows for a smaller one."""
        t0 = time.perf_counter()
        rows = ((n_pad, e_pad) if n_seeds == shape["batch_nodes"]
                else sampler.block_sizes(n_seeds))
        b = _gnn_block(sampler, feats, targets, rng, n_seeds,
                       cfg.in_edge_dim, rows, "cuda")
        sample_s.append(time.perf_counter() - t0)
        return b

    first = block()
    specs = model_api.input_specs(cfg, shape)
    check(all((tuple(first[k].shape), first[k].dtype) == specs[k]
              for k in specs) and first.keys() == specs.keys(),
          f"[gnn] a block's tensors differ from input_specs {specs}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = gnn.init_gnn(cfg, gen, "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    lap("block+init")

    # 1. every kernel-7 call of a forward against its plain version
    calls = []
    real = ops._segment_sum

    def spy(messages, dst_sorted, n):
        out = real(messages, dst_sorted, n)
        calls.append((messages.detach(), dst_sorted, n, out))
        return out

    with torch.no_grad(), mock.patch.object(ops, "_segment_sum", spy):
        pred = gnn.gnn_forward(cfg, params, first)
    sync()
    check(len(calls) == cfg.n_layers and tuple(pred.shape) == (n_pad, 3)
          and bool(torch.isfinite(pred).all()),
          f"[gnn] a forward made {len(calls)} segment sums, predictions "
          f"{tuple(pred.shape)}")
    k7_err = max(_check_close(out, ref.csr_segment_sum(m, d, n), SEGMENT_TOL,
                              f"[gnn] block {i}'s aggregate")
                 for i, (m, d, n, out) in enumerate(calls))
    msgs, dst, n, out0 = calls[0]
    calls.clear()
    # 2. the Function's backward against autograd through the plain version
    gout = torch.randn((n, msgs.shape[1]), generator=gen, device="cuda")
    a = msgs.clone().requires_grad_(True)
    ops.csr_segment_sum(a, dst, n).backward(gout)
    b = msgs.clone().requires_grad_(True)
    ref.csr_segment_sum(b, dst, n).backward(gout)
    check(torch.equal(a.grad, b.grad),
          "[gnn] the segment sum's backward differs from autograd through "
          "its plain version")
    del a, b, gout
    # 3. kernel 7 on this block's first aggregate in turns with the library
    # call given its lengths (the wrapper's own f32 cast and sentinel map
    # done once, outside the timing)
    m32 = msgs.to(torch.float32).contiguous()
    dst_sent = torch.where(dst < 0, segment_sum.PAD_SENTINEL,
                           dst).to(torch.int32).contiguous()
    lengths = _library_lengths(dst_sent, n)
    lib_calls = {
        "kernel": lambda: segment_sum.csr_segment_sum(m32, dst_sent, n),
        "library": lambda: torch.segment_reduce(
            m32, "sum", lengths=lengths, axis=0, unsafe=True)}
    lib_err = _check_close(lib_calls["library"]()[:n], out0, SEGMENT_TOL,
                           "[gnn] torch.segment_reduce on a block")
    block_rounds = _in_turns_rounds(lib_calls, SEGMENT_ROUNDS, SEGMENT_REPS)
    del msgs, m32, dst_sent, lengths, lib_calls, out0
    lap("kernel-7 checks")
    fwd_ms = []
    with torch.no_grad():
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            gnn.gnn_forward(cfg, params, first)
            sync()
            fwd_ms.append((time.perf_counter() - t0) * 1e3)

    lap("forward timing")
    # 4. the whole model at f32 on the card against a CPU copy
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    small = block(GNN_CHECK_SEEDS)
    loss_fn = model_api.model_api(cfg32).loss
    lap("check block")
    loss_c, _, grads_c = model_api.value_and_grad(loss_fn, params, small)
    pred_c = gnn.gnn_forward(cfg32, params, small)
    lap("f32 check, card")
    params_h, small_h = _to_cpu(params), _to_cpu(small)
    loss_h, _, grads_h = model_api.value_and_grad(loss_fn, params_h, small_h)
    pred_h = gnn.gnn_forward(cfg32, params_h, small_h)
    lap("f32 check, CPU copy")
    errs = {"predictions": _rel_err(pred_c, pred_h),
            "loss": _rel_err(loss_c, loss_h)}
    for (path, g), h in zip(tree_flatten_with_path(grads_c)[0],
                            tree_leaves(grads_h)):
        errs["grad " + ".".join(path)] = _rel_err(g, h)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= GNN_REL_TOL,
          f"[gnn] f32 model on the card vs its CPU copy: relative errors "
          f"{errs} (limit {GNN_REL_TOL})")
    del grads_c, grads_h, params_h, small_h

    # 5. the main path: train, checkpoint, reload, resume
    blocks = iter([first])

    def data():
        while True:
            yield next(blocks, None) or block()

    per_call = segment_sum.launches(e_pad, cfg.d_hidden)
    per_step = cfg.n_layers * (2 if cfg.remat else 1) * per_call
    with tempfile.TemporaryDirectory(prefix="gnn_", dir=ROOT) as tmp:
        lc = train_loop.LoopConfig(total_steps=GNN_STEPS,
                                   checkpoint_every=GNN_CKPT_EVERY,
                                   checkpoint_dir=tmp)
        it = data()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        st = train_loop.train(cfg, it, lc, init_gen=torch.Generator(
            device="cuda").manual_seed(0), device="cuda")
        latest = store.latest_complete(tmp)
        like = model_api.abstract_params(cfg)
        back = store.load(latest, {"params": like, "opt":
                                   model_api.abstract_opt_state(cfg, like)},
                          device="cuda")
        check(latest.name == f"step_{GNN_STEPS:08d}" and all(
            torch.equal(x, y) for x, y in zip(
                tree_leaves(back),
                tree_leaves({"params": st.params, "opt": st.opt_state}))),
              "[gnn] the reloaded checkpoint differs from the trained tree")
        resumed = train_loop.train(cfg, it, dataclasses.replace(
            lc, total_steps=GNN_STEPS + 1), device="cuda")
        launched = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        kept = sorted(p.name for p in pathlib.Path(tmp).iterdir())
    losses = [m["loss"] for m in st.metrics_history + resumed.metrics_history]
    check(len(losses) == GNN_STEPS + 1 and resumed.step == GNN_STEPS + 1
          and all(np.isfinite(losses)),
          f"[gnn] losses {losses}, resumed at step {resumed.step}")
    launches = launched["csr_segment_sum"]
    check(launches == (GNN_STEPS + 1) * per_step
          and all(v == 0 for k, v in launched.items()
                  if k != "csr_segment_sum"),
          f"[gnn] launches {launched}; expected csr_segment_sum "
          f"{(GNN_STEPS + 1) * per_step} and nothing else")

    lap("train + resume")
    # 6. one step profiled
    from torch.profiler import ProfilerActivity, profile
    step_fn, _ = train_loop.make_compressed_train_step(cfg, lc)
    comp = train_loop.init_state(resumed.params)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        step_fn(resumed.params, resumed.opt_state, comp, first)
        sync()
        prof_ms = (time.perf_counter() - t0) * 1e3
    lap("profiled step")
    ops_ms = device_ops(prof)
    busy = sum(t for _, t, _ in ops_ms)
    k7_ms = sum(t for k, t, _ in ops_ms if "segment_span_kernel" in k
                or "segment_fixup_kernel" in k)
    check(busy > 0 and k7_ms > 0,
          f"[gnn] the profiler saw {busy} ms of device time, kernel 7 "
          f"{k7_ms}")
    d = cfg.d_hidden
    b_s, by = bound_s(4 * e_pad * d + 4 * e_pad + 4 * n_pad * d, e_pad * d)
    calls_per_step = per_step // per_call
    bound_ms = b_s * 1e3 * calls_per_step
    top = sorted(ops_ms, key=lambda o: -o[1])[:5]
    step_ms = [t * 1e3 for t in st.step_seconds + resumed.step_seconds]
    print(f"[gnn] {arch.arch_id} CONFIG ({cfg.n_layers} blocks, d_hidden "
          f"{d}, compute {cfg.compute_dtype}, params {cfg.param_dtype}, "
          f"remat {cfg.remat}; {n_params:,} parameters) on {GNN_SHAPE} "
          f"blocks: {shape['batch_nodes']} seeds, fanouts {fanouts}, "
          f"{n_pad:,} node rows, {e_pad:,} edge rows, d_feat "
          f"{cfg.in_node_dim}; graph random_power_law_graph("
          f"{shape['n_nodes']:,}, {GNN_AVG_DEGREE}, {shape['d_feat']}) "
          f"{csr.n_edges:,} edges {graph_s:.1f}s on a host worker thread, a block "
          f"sampled in {np.median(sample_s):.2f}s (median of "
          f"{len(sample_s)})", flush=True)
    print(f"[gnn] checks: {cfg.n_layers} kernel-7 calls of a forward == "
          f"plain version (max abs err {k7_err:.3e}, rtol = atol = "
          f"{SEGMENT_TOL}); backward == autograd through the plain version "
          f"bit for bit; f32 model on the card vs its CPU copy "
          f"({GNN_CHECK_SEEDS}-seed block): relative error "
          f"{errs['predictions']:.3e} in the predictions, "
          f"{errs['loss']:.3e} in the loss, at most {errs[worst]:.3e} "
          f"({worst}) over them and {len(errs) - 2} gradient leaves (median "
          f"{np.median(list(errs.values())):.3e}; limit {GNN_REL_TOL}); "
          f"checkpoint {latest.name} reloaded == the trained tree bit for "
          f"bit, kept {kept}", flush=True)
    print(f"[gnn] {GNN_STEPS} AdamW steps + 1 resumed, losses "
          + ", ".join(f"{x:.5f}" for x in losses)
          + f"; step ms " + ", ".join(f"{t:.1f}" for t in step_ms)
          + f" (median after the first {np.median(step_ms[1:]):.2f}); "
          f"forward (no grad) {np.median(fwd_ms):.2f} ms; peak memory "
          f"{peak:,} B; "
          f"csr_segment_sum {launches} launches = {GNN_STEPS + 1} steps x "
          f"{per_step} ({cfg.n_layers} blocks x 2 (remat recompute) x "
          f"{per_call} a call), no other kernel", flush=True)
    print(f"[gnn] one step profiled: wall {prof_ms:.2f} ms, device busy "
          f"{busy:.3f} ms; kernel 7 {k7_ms:.3f} ms ({100 * k7_ms / busy:.1f}%"
          f" of device time) for {calls_per_step} calls, bound "
          f"{bound_ms:.3f} ms ({by}; {100 * bound_ms / k7_ms:.1f}% of it); "
          "top: " + "; ".join(f"{k[:50]} {t:.3f} ms x{c}"
                              for k, t, c in top)
          + f"; {smi}; phase {stages.line()}", flush=True)
    print(_rounds_line(
        f"on [gnn]'s first block, its first aggregate (E {e_pad:,}, n "
        f"{n_pad:,}, d {d}), in turns, {SEGMENT_ROUNDS} rounds of "
        f"{SEGMENT_REPS} calls (bound {b_s * 1e3:.4f} ms, {by}; the library "
        f"call's first n rows == the kernel's, max abs err {lib_err:.3e}, "
        f"rtol = atol = {SEGMENT_TOL})", block_rounds,
        {"kernel": "kernel", "library": "torch.segment_reduce given lengths"},
        tag="[gnn]"), flush=True)
    return launches


def grid_graph(rows: int, cols: int, radius2: int, d_feat: int, d_edge: int,
               out_dim: int, seed: int) -> dict:
    """A mesh-like graph as numpy arrays (``gnn_forward``'s batch): node
    (r, c) of a rows x cols grid is node c * rows + r (column-major, so a
    strip of whole columns is a range of ids), with an edge into it from
    every node within sqrt(``radius2``) grid steps. The edges come in an
    order shuffled from ``seed``; node features, targets and each edge's
    last feature are N(0, 1) draws from it, its first three the
    displacement (dx, dy) and the distance. Every node is unmasked."""
    rng = np.random.default_rng(seed)
    r, c = np.divmod(np.arange(rows * cols), cols)
    r, c = r.reshape(rows, cols), c.reshape(rows, cols)
    src, dst, feat = [], [], []
    reach = int(np.sqrt(radius2))
    for dy in range(-reach, reach + 1):
        for dx in range(-reach, reach + 1):
            if not 0 < dx * dx + dy * dy <= radius2:
                continue
            ok = ((r + dy >= 0) & (r + dy < rows) & (c + dx >= 0)
                  & (c + dx < cols))
            rr, cc = r[ok], c[ok]
            dst.append(cc * rows + rr)
            src.append((cc + dx) * rows + rr + dy)
            feat.append(np.broadcast_to(
                [dx, dy, np.sqrt(dx * dx + dy * dy)], (len(rr), 3)))
    order = rng.permutation(sum(len(x) for x in src))
    n = rows * cols
    ef = np.concatenate(feat).astype(np.float32)[order]
    ef = np.concatenate([ef, rng.normal(size=(len(ef), d_edge - 3))],
                        axis=1).astype(np.float32)
    return {"node_feats": rng.normal(size=(n, d_feat)).astype(np.float32),
            "edge_src": np.concatenate(src).astype(np.int32)[order],
            "edge_dst": np.concatenate(dst).astype(np.int32)[order],
            "edge_feats": ef,
            "node_targets": rng.normal(size=(n, out_dim)).astype(np.float32),
            "node_mask": np.ones(n, bool)}


def strip_partition(graph: dict, n_parts: int, nl: int,
                    el: int) -> tuple[dict, int]:
    """``(batch, S)``: a graph whose partitions are ranges of node ids
    (``grid_graph``'s strips of whole columns: n / ``n_parts`` nodes each)
    laid out as ``models.gnn_partitioned`` takes it, stacked [P, ...]:
    ``nl`` node and ``el`` edge slots a partition (the rest padded: masked
    nodes, -1 edges). Partition p owns its nodes and every edge into them;
    an edge from a node q owns is read from the halo: the S slots of the
    pair (q, p) hold the distinct such sources in id order, S the largest
    any pair needs, so ``send_idx[q, p, s]`` is a node of q and the edge's
    source is ``nl + q * S + s``."""
    n = len(graph["node_feats"])
    own = n // n_parts
    if own * n_parts != n or own > nl:
        raise ValueError(f"{n} nodes do not split into {n_parts} parts of "
                         f"at most {nl}")
    src, dst = graph["edge_src"], graph["edge_dst"]
    p_dst, l_dst = np.divmod(dst, own)
    p_src, l_src = np.divmod(src, own)
    halo = p_src != p_dst
    key = (p_dst[halo].astype(np.int64) * n_parts + p_src[halo]) * own \
        + l_src[halo]
    uniq, inv = np.unique(key, return_inverse=True)
    pair, l_send = np.divmod(uniq, own)
    first = np.searchsorted(pair, pair, side="left")
    slot = np.arange(len(uniq)) - first
    s = int(slot.max()) + 1 if len(uniq) else 1
    send_idx = np.full((n_parts, n_parts, s), -1, np.int32)
    recv, sender = np.divmod(pair, n_parts)
    send_idx[sender, recv, slot] = l_send
    es = l_src.astype(np.int32)
    es[halo] = nl + p_src[halo] * s + slot[inv]

    order = np.argsort(p_dst, kind="stable")
    counts = np.bincount(p_dst, minlength=n_parts)
    if counts.max() > el:
        raise ValueError(f"a partition has {counts.max()} edges > {el}")
    pos = np.arange(len(dst)) - np.repeat(np.cumsum(counts) - counts, counts)
    out = {"edge_src": np.full((n_parts, el), -1, np.int32),
           "edge_dst": np.full((n_parts, el), -1, np.int32),
           "edge_feats": np.zeros((n_parts, el,
                                   graph["edge_feats"].shape[1]), np.float32)}
    rows = (p_dst[order], pos)
    out["edge_src"][rows] = es[order]
    out["edge_dst"][rows] = l_dst[order]
    out["edge_feats"][rows] = graph["edge_feats"][order]
    for k in ("node_feats", "node_targets", "node_mask"):
        v = graph[k].reshape((n_parts, own) + graph[k].shape[1:])
        out[k] = np.zeros((n_parts, nl) + v.shape[2:], v.dtype)
        out[k][:, :own] = v
    out["send_idx"] = send_idx
    return out, s


def gnn_part_graph() -> dict:
    """[gnn_part]'s host graph (``grid_graph`` at GNN_PART_GRID, seed 2)
    and its GNN_PARTS strips (``strip_partition`` at the per-chip slots of
    GNN_PART_SHAPE on GNN_PART_CHIPS chips)."""
    arch = get_arch(GNN_ARCH)
    shape = arch.shape(GNN_PART_SHAPE)
    cfg = model_api.resolve_config(arch.config, shape)
    specs = partitioned_input_specs(cfg, shape, GNN_PART_CHIPS)
    nl, el = specs["node_feats"][0][1], specs["edge_src"][0][1]
    whole = grid_graph(*GNN_PART_GRID, GNN_PART_RADIUS2,
                       shape["d_feat"], cfg.in_edge_dim, cfg.out_dim, seed=2)
    parts, s = strip_partition(whole, GNN_PARTS, nl, el)
    return {"whole": whole, "parts": parts, "halo": s, "nl": nl, "el": el}


def _train_steps(loss_fn, opt, params, batch, steps: int) -> tuple:
    """A warm-up AdamW step, then ``steps`` timed ones (wall ms, synced):
    ``(params, losses, ms)``, the losses before each update."""
    state = opt.init(params)
    losses, ms = [], []
    for i in range(steps + 1):
        sync()
        t0 = time.perf_counter()
        loss, _, grads = model_api.value_and_grad(loss_fn, params, batch)
        params, state = opt.update(grads, state, params)
        sync()
        losses.append(float(loss))
        if i:
            ms.append((time.perf_counter() - t0) * 1e3)
    return params, losses, ms


def phase_gnn_part(smi: str, made) -> int:
    """MeshGraphNet's full CONFIG (15 blocks, d_hidden 128, bf16 compute,
    remat, AdamW) trained owner-computes on GNN_PARTS partitions held on
    the card (``partitioned_loss(cfg)``, mesh=None: the halo exchange a
    transpose, each block's aggregate one kernel-7 call over all the
    partitions' edges). Checks: every kernel-7 call of a forward against
    its plain version; the partitioned loss and every gradient against
    ``gnn.gnn_loss`` on the same graph unpartitioned, same parameters
    (loss at GNN_PART_LOSS_RTOL, each leaf within GNN_REL_TOL of its
    largest value: the gathers' backward adds atomically); the loss falls
    over the steps; kernel 7's launches = steps x blocks x 2 (remat) x its
    launches a call, and no other kernel's. Timed: each form's step
    (median of GNN_PART_STEPS after a warm-up); one partitioned step
    profiled. ``made`` is ``_timed_call(gnn_part_graph)``'s result.
    Returns the partitioned path's kernel-7 launches."""
    lap = (stages := Stages()).lap
    arch = get_arch(GNN_ARCH)
    shape = arch.shape(GNN_PART_SHAPE)
    cfg = model_api.resolve_config(arch.config, shape)
    g, made_s = made
    nl, el, s, n_parts = g["nl"], g["el"], g["halo"], GNN_PARTS
    batch = {k: torch.from_numpy(v).cuda() for k, v in g["parts"].items()}
    whole = {k: torch.from_numpy(v).cuda() for k, v in g["whole"].items()}
    n_real = int(whole["node_mask"].sum())
    e_real = int((batch["edge_dst"] >= 0).sum())
    params = gnn.init_gnn(cfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda")
    loss_fn = partitioned_loss(cfg)
    whole_fn = model_api.model_api(cfg).loss
    lap("to the card")

    # 1. every kernel-7 call of a forward against its plain version
    calls = []
    real = ops._segment_sum

    def spy(messages, dst_sorted, n):
        out = real(messages, dst_sorted, n)
        calls.append((messages.detach(), dst_sorted, n, out))
        return out

    with torch.no_grad(), mock.patch.object(ops, "_segment_sum", spy):
        loss_fn(params, batch)
    check(len(calls) == cfg.n_layers
          and all(c[2] == n_parts * nl for c in calls),
          f"[gnn_part] a forward made {len(calls)} segment sums")
    k7_err = max(_check_close(out, ref.csr_segment_sum(m, d, n), SEGMENT_TOL,
                              f"[gnn_part] block {i}'s aggregate")
                 for i, (m, d, n, out) in enumerate(calls))
    calls.clear()
    lap("kernel-7 checks")
    # 2. the partitioned loss and gradients against the whole graph's
    loss_p, _, grads_p = model_api.value_and_grad(loss_fn, params, batch)
    loss_w, _, grads_w = model_api.value_and_grad(whole_fn, params, whole)
    loss_err = abs(float(loss_p) - float(loss_w)) / abs(float(loss_w))
    errs = {".".join(path): _rel_err(a, b) for (path, a), b in zip(
        tree_flatten_with_path(grads_p)[0], tree_leaves(grads_w))}
    worst = max(errs, key=errs.get)
    check(loss_err <= GNN_PART_LOSS_RTOL and errs[worst] <= GNN_REL_TOL,
          f"[gnn_part] partitioned vs whole graph: loss {float(loss_p)} vs "
          f"{float(loss_w)} (rtol {GNN_PART_LOSS_RTOL}), gradients {errs} "
          f"(limit {GNN_REL_TOL})")
    del grads_p, grads_w
    lap("vs the whole graph")
    # 3. the main path: AdamW steps of the partitioned loss, counted
    opt = make_optimizer(cfg.optimizer)
    per_call = segment_sum.launches(n_parts * el, cfg.d_hidden)
    per_step = cfg.n_layers * (2 if cfg.remat else 1) * per_call
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trained, losses, part_ms = _train_steps(loss_fn, opt, params, batch,
                                            GNN_PART_STEPS)
    launched = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    launches = launched["csr_segment_sum"]
    check(launches == (GNN_PART_STEPS + 1) * per_step
          and all(v == 0 for k, v in launched.items()
                  if k != "csr_segment_sum"),
          f"[gnn_part] launches {launched}; expected csr_segment_sum "
          f"{(GNN_PART_STEPS + 1) * per_step} and nothing else")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"[gnn_part] the loss did not fall: {losses}")
    lap("partitioned steps")
    _, whole_losses, whole_ms = _train_steps(whole_fn, opt, params, whole,
                                             GNN_PART_STEPS)
    lap("whole-graph steps")
    # 4. one partitioned step profiled
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _train_steps(loss_fn, opt, trained, batch, 0)
    ops_ms = device_ops(prof)
    busy = sum(t for _, t, _ in ops_ms)
    k7_ms = sum(t for k, t, _ in ops_ms if "segment_span_kernel" in k
                or "segment_fixup_kernel" in k)
    check(busy > 0 and k7_ms > 0,
          f"[gnn_part] the profiler saw {busy} ms of device time, kernel 7 "
          f"{k7_ms}")
    lap("profiled step")
    e_all, n_all, d = n_parts * el, n_parts * nl, cfg.d_hidden
    b_s, by = bound_s(4 * e_all * d + 4 * e_all + 4 * n_all * d, e_all * d)
    calls_per_step = per_step // per_call
    top = sorted(ops_ms, key=lambda o: -o[1])[:4]
    print(f"[gnn_part] {arch.arch_id} CONFIG ({cfg.n_layers} blocks, "
          f"d_hidden {d}, compute {cfg.compute_dtype}, remat {cfg.remat}, "
          f"{cfg.optimizer}) owner-computes, mesh=None: {n_parts} partitions "
          f"on one card at {GNN_PART_SHAPE}'s per-chip shape on "
          f"{GNN_PART_CHIPS} chips ({nl:,} node and {el:,} edge slots, "
          f"d_feat {cfg.in_node_dim}); grid {GNN_PART_GRID[0]} x "
          f"{GNN_PART_GRID[1]}, radius^2 {GNN_PART_RADIUS2}: {n_real:,} "
          f"nodes, {e_real:,} edges ({e_real / n_real:.2f} a node), "
          f"{n_parts} strips, halo S = {s} slots a pair (P * S = "
          f"{n_parts * s:,} received rows a partition); made in "
          f"{made_s:.1f}s on a host worker thread", flush=True)
    print(f"[gnn_part] checks: {cfg.n_layers} kernel-7 calls of a forward "
          f"(E {e_all:,}, n {n_all:,}) == plain version (max abs err "
          f"{k7_err:.3e}, rtol = atol = {SEGMENT_TOL}); partitioned vs the "
          f"whole graph through gnn_loss: loss {float(loss_p):.6f} vs "
          f"{float(loss_w):.6f} (rel {loss_err:.3e}, limit "
          f"{GNN_PART_LOSS_RTOL}), gradients at most {errs[worst]:.3e} "
          f"({worst}; median {np.median(list(errs.values())):.3e}; limit "
          f"{GNN_REL_TOL}); losses "
          + ", ".join(f"{x:.5f}" for x in losses) + " (falling)", flush=True)
    print(f"[gnn_part] step ms partitioned "
          + ", ".join(f"{t:.1f}" for t in part_ms)
          + f" (median {np.median(part_ms):.2f}) vs whole graph "
          + ", ".join(f"{t:.1f}" for t in whole_ms)
          + f" (median {np.median(whole_ms):.2f}; ratio "
          f"{np.median(part_ms) / np.median(whole_ms):.3f}); peak "
          f"{peak:,} B; csr_segment_sum {launches} launches = "
          f"{GNN_PART_STEPS + 1} steps x {per_step} ({cfg.n_layers} blocks x "
          f"2 (remat) x {per_call} a call), no other kernel; one step "
          f"profiled: device busy {busy:.3f} ms, kernel 7 {k7_ms:.3f} ms "
          f"({100 * k7_ms / busy:.1f}%) for {calls_per_step} calls, bound "
          f"{b_s * 1e3 * calls_per_step:.3f} ms ({by}); top: "
          + "; ".join(f"{k[:40]} {t:.3f} ms x{c}" for k, t, c in top)
          + f"; {smi}; phase {stages.line()}", flush=True)
    return launches


def phase_recsys() -> tuple[int, dict]:
    """The recsys retrieval step of BST at full width: its parameters made
    on the card, then RETRIEVAL_REQUESTS requests at ``retrieval_cand``,
    each timed on the host clock and its kernel under CUDA events, each
    answer checked against the same step through the plain version on the
    card. Returns the kernel's launches in the requests and ``{arch:
    parameter tree}``, which ``[rank]`` reuses."""
    arch = get_arch(RETRIEVAL_ARCH)
    cfg, shape = arch.config, arch.shape("retrieval_cand")
    sync()
    t0 = time.perf_counter()
    params = model_api.model_api(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    sync()
    init_s = time.perf_counter() - t0
    check(all(t.device.type == "cuda" for t in tree_leaves(params)),
          "a parameter is not on the card")
    nbytes = tree_bytes(params)
    step = model_api.make_retrieval_step(cfg, k=RETRIEVAL_K)
    batches = [model_api.make_batch(
        cfg, shape, torch.Generator(device="cuda").manual_seed(100 + r),
        "cuda") for r in range(RETRIEVAL_REQUESTS)]
    print(f"[recsys] {arch.arch_id} ({arch.source}) at full width: "
          f"init_recsys on the card {init_s:.3f}s, {nbytes:,} parameter "
          f"bytes ({cfg.total_rows():,} embedding rows x {cfg.embed_dim}); "
          f"{RETRIEVAL_REQUESTS} requests at {shape.name} "
          f"{dict(shape.params)}, k={RETRIEVAL_K}", flush=True)

    events = []
    kernel = distance_matrix.distance_matrix

    def kernel_with_events(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = kernel(*args)
        end.record()
        events.append((start, end))
        return out

    step(params, batches[0])                          # warm-up
    sync()
    reset_counts()                                    # the main path
    wall_ms, kernel_ms, answers = [], [], []
    with mock.patch.object(distance_matrix, "distance_matrix",
                           kernel_with_events):
        for batch in batches:
            events.clear()
            sync()
            t0 = time.perf_counter()
            answers.append(step(params, batch))
            sync()
            wall_ms.append((time.perf_counter() - t0) * 1e3)
            check(len(events) == 1,
                  f"a request called the kernel {len(events)} times")
            kernel_ms.append(events[0][0].elapsed_time(events[0][1]))
    launches = distance_matrix.LAUNCHES
    check(launches == RETRIEVAL_REQUESTS
          and distance_matrix.PATH_LAUNCHES["stream"] == launches,
          f"distance_matrix launched {launches} times in "
          f"{RETRIEVAL_REQUESTS} requests, "
          f"{distance_matrix.PATH_LAUNCHES['stream']} on its streaming path")
    with mock.patch.object(distance_matrix, "distance_matrix",
                           ref.distance_matrix):
        for r, (batch, (vals, ids)) in enumerate(zip(batches, answers)):
            check(tuple(ids.shape) == (1, RETRIEVAL_K)
                  and bool(torch.isfinite(vals).all()),
                  f"request {r}: malformed answer")
            plain_vals, plain_ids = step(params, batch)
            check(torch.equal(ids, plain_ids),
                  f"request {r}: ids differ from the plain path's")
            check(torch.allclose(vals, plain_vals, rtol=1e-5, atol=1e-6),
                  f"request {r}: scores differ from the plain path's")
    check(distance_matrix.LAUNCHES == launches,
          "the plain path launched the kernel")
    share = np.mean([k / w for k, w in zip(kernel_ms, wall_ms)])
    print(f"[recsys] {RETRIEVAL_REQUESTS} requests, wall ms "
          + ", ".join(f"{w:.3f}" for w in wall_ms)
          + f" (mean {np.mean(wall_ms):.3f}, p50 {np.median(wall_ms):.3f}); "
          "distance_matrix kernel ms (CUDA events) "
          + ", ".join(f"{k:.4f}" for k in kernel_ms)
          + f" ({100 * share:.1f}% of a request on average); "
          f"{launches} launches, one per request; every answer's ids equal "
          "the plain path's, its scores within rtol 1e-5", flush=True)
    _profile_request(step, params, batches[0])
    return launches, {RETRIEVAL_ARCH: params}


def _profile_request(step, params, batch) -> None:
    """One more retrieval request under torch.profiler: its device-busy
    share and the device ops that take its time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, batch)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops_ms = device_ops(prof)
    busy_ms = sum(t for _, t, _ in ops_ms)
    check(busy_ms > 0, "the profiler saw no device time in a request")
    top = sorted(ops_ms, key=lambda o: -o[1])[:6]
    kernel_ms = sum(t for k, t, _ in ops_ms if "distance_stream_kernel" in k)
    print(f"[recsys] one request under torch.profiler: wall {wall_ms:.3f} "
          f"ms, device busy {busy_ms:.4f} ms ({100 * busy_ms / wall_ms:.1f}% "
          f"of wall), {sum(c for _, _, c in ops_ms)} device ops, the "
          f"distance_matrix kernel {kernel_ms:.4f} ms of them; top: "
          + "; ".join(f"{k[:60]} {t:.4f} ms x{c}" for k, t, c in top),
          flush=True)


def _rank_model(arch_id: str, reuse: dict, smi: str) -> dict:
    """One ranking model at full CONFIG on the card (its tree popped from
    ``reuse``, so that this frame holds the only reference and the first
    train step frees it; else made from seed 0): RANK_REQUESTS serve
    requests at serve_p99 and one at serve_bulk through
    ``make_serve_step`` (each answer finite, shape [B]; the serve step ==
    ``recsys_forward`` bit for bit on one batch); logits, loss and every
    gradient leaf against a CPU copy on RANK_CHECK_ROWS rows; RANK_STEPS
    AdamW steps through ``make_train_step`` at RANK_TRAIN_ROWS rows, then
    one more profiled. Prints four lines; returns the phase's numbers for
    its summary."""
    lap = (stages := Stages()).lap

    arch = get_arch(arch_id)
    cfg = arch.config
    params = reuse.pop(arch_id, None)
    reused = params is not None
    if not reused:
        params = model_api.model_api(cfg).init(
            torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    nbytes = tree_bytes(params)
    gen = torch.Generator(device="cuda").manual_seed(200)
    p99, bulk = arch.shape("serve_p99"), arch.shape("serve_bulk")
    rows = RANK_TRAIN_ROWS[arch_id]
    train_shape = dataclasses.replace(arch.shape("train_batch"),
                                      params={"batch": rows})
    reqs = [model_api.make_batch(cfg, p99, gen, "cuda")
            for _ in range(RANK_REQUESTS)]
    train = [model_api.make_batch(cfg, train_shape, gen, "cuda")
             for _ in range(RANK_STEPS)]
    lap("init+batches")

    # 1. serve: the step == the forward bit for bit, then timed requests
    serve = model_api.make_serve_step(cfg)
    first = serve(params, reqs[0])
    check(torch.equal(first, recsys.recsys_forward(cfg, params, reqs[0])),
          f"[rank] {arch_id}: make_serve_step differs from recsys_forward")
    wall = []
    for r, batch in enumerate(reqs):
        sync()
        t0 = time.perf_counter()
        out = serve(params, batch)
        sync()
        wall.append((time.perf_counter() - t0) * 1e3)
        check(tuple(out.shape) == (p99["batch"],)
              and bool(torch.isfinite(out).all()),
              f"[rank] {arch_id}: request {r} answered {tuple(out.shape)}, "
              f"finite {bool(torch.isfinite(out).all())}")
    bulk_batch = model_api.make_batch(cfg, bulk, gen, "cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    out = serve(params, bulk_batch)
    sync()
    bulk_ms = (time.perf_counter() - t0) * 1e3
    bulk_peak = torch.cuda.max_memory_allocated()
    check(tuple(out.shape) == (bulk["batch"],)
          and bool(torch.isfinite(out).all()),
          f"[rank] {arch_id}: the serve_bulk request answered "
          f"{tuple(out.shape)}")
    del bulk_batch, out
    torch.cuda.empty_cache()
    lap("serve")

    # 2. the card against a CPU copy: logits, loss, every gradient leaf
    small = {k: v[:RANK_CHECK_ROWS] for k, v in train[0].items()}
    loss_fn = model_api.model_api(cfg).loss
    logits_c = recsys.recsys_forward(cfg, params, small).detach()
    loss_c, _, grads_c = model_api.value_and_grad(loss_fn, params, small)
    lap("check, card")
    params_h, small_h = _to_cpu(params), _to_cpu(small)
    logits_h = recsys.recsys_forward(cfg, params_h, small_h).detach()
    loss_h, _, grads_h = model_api.value_and_grad(loss_fn, params_h, small_h)
    del params_h
    lap("check, CPU copy")
    for what, got, want in (("logits", logits_c, logits_h),
                            ("loss", loss_c, loss_h)):
        check(torch.allclose(got.cpu(), want, rtol=RANK_RTOL,
                             atol=RANK_ATOL),
              f"[rank] {arch_id}: {what} on the card vs its CPU copy: max "
              f"abs err {float((got.cpu() - want).abs().max())}")
    errs = {}
    for (path, g), h in zip(tree_flatten_with_path(grads_c)[0],
                            tree_leaves(grads_h)):
        h = h.to("cuda")
        errs[".".join(path)] = float((g - h).abs().max()
                                     / h.abs().max().clamp(min=1e-30))
    del grads_c, grads_h, h
    worst = max(errs, key=errs.get)
    check(errs[worst] <= GNN_REL_TOL,
          f"[rank] {arch_id}: gradients on the card vs its CPU copy: "
          f"relative errors {errs} (limit {GNN_REL_TOL})")
    logit_err = float((logits_c.cpu() - logits_h).abs().max())
    loss_err = float((loss_c.cpu() - loss_h).abs())
    torch.cuda.empty_cache()
    lap("check, compare")

    # 3. train: RANK_STEPS AdamW steps, then one profiled
    step, opt = model_api.make_train_step(cfg)
    opt_state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for batch in train:
        sync()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"[rank] {arch_id}: losses {losses}")
    lap("train")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        params, opt_state, _ = step(params, opt_state, train[0])
        sync()
        prof_ms = (time.perf_counter() - t0) * 1e3
    del params, opt_state, train
    torch.cuda.empty_cache()
    ops_ms = device_ops(prof)
    busy = sum(t for _, t, _ in ops_ms)
    check(busy > 0, f"[rank] {arch_id}: the profiler saw no device time")
    top = sorted(ops_ms, key=lambda o: -o[1])[:5]
    lap("profiled step")

    cut = ("" if rows == arch.shape("train_batch")["batch"] else
           f", cut from train_batch's {arch.shape('train_batch')['batch']:,}"
           f" (the scans' saved activations)")
    print(f"[rank] {arch_id} CONFIG ({arch.source}; embed {cfg.embed_dim}, "
          f"seq {cfg.seq_len}, MLP {'-'.join(map(str, cfg.mlp_dims))}"
          + (f", GRU {cfg.gru_dim}" if cfg.gru_dim else "")
          + (f", {cfg.n_blocks} block, {cfg.n_heads} heads"
             if cfg.n_blocks else "")
          + f"): {n_params:,} parameters, {nbytes:,} B, "
          f"{cfg.total_rows():,} embedding rows, "
          f"{'reused from [recsys]' if reused else 'made on the card'}; "
          f"serve: {RANK_REQUESTS} requests at {p99.name} ({p99['batch']} "
          f"rows) wall ms p50 {np.median(wall):.3f}, p99 "
          f"{np.percentile(wall, 99):.3f} (min {min(wall):.3f}, max "
          f"{max(wall):.3f}); one at {bulk.name} ({bulk['batch']:,} rows) "
          f"{bulk_ms:.1f} ms, peak memory {bulk_peak:,} B; every answer "
          f"finite and [B]; make_serve_step == recsys_forward bit for bit",
          flush=True)
    print(f"[rank] {arch_id} train: {RANK_STEPS} AdamW steps through "
          f"make_train_step at {rows:,} rows{cut}: losses "
          + ", ".join(f"{x:.5f}" for x in losses)
          + "; step ms " + ", ".join(f"{t:.1f}" for t in step_ms)
          + f" (median after the first {np.median(step_ms[1:]):.2f}); peak "
          f"memory {peak:,} B", flush=True)
    print(f"[rank] {arch_id} checks: card vs its CPU copy on "
          f"{RANK_CHECK_ROWS} rows: logits max abs err {logit_err:.3e}, "
          f"loss {loss_err:.3e} (rtol {RANK_RTOL}, atol {RANK_ATOL}); "
          f"gradients at most {errs[worst]:.3e} of a leaf's largest value "
          f"({worst}; median {np.median(list(errs.values())):.3e} over "
          f"{len(errs)} leaves; limit {GNN_REL_TOL})", flush=True)
    print(f"[rank] {arch_id} one step profiled: wall {prof_ms:.2f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / prof_ms:.1f}%), "
          f"{sum(c for _, _, c in ops_ms)} device ops; top: "
          + "; ".join(f"{k[:50]} {t:.3f} ms x{c}" for k, t, c in top)
          + f"; {smi}; {stages.line()}", flush=True)
    return {"serve_p50": float(np.median(wall)),
            "step_ms": float(np.median(step_ms[1:])), "peak": peak}


def phase_rank(smi: str, reuse: dict) -> None:
    """The recsys ranking path (``recsys_forward`` / ``recsys_loss``
    through the serve and train steps) of each of RANK_ARCHS at full
    CONFIG, one model at a time on the card; ``reuse`` holds trees made by
    an earlier phase, each popped by its model. The
    launch counters are set to 0 before and read after: the path calls no
    kernel of the port, so every count stays 0."""
    t_phase = time.perf_counter()
    reset_counts()
    done = {}
    for arch_id in RANK_ARCHS:
        done[arch_id] = _rank_model(arch_id, reuse, smi)
        torch.cuda.empty_cache()
    launched = launch_counts()
    check(all(v == 0 for v in launched.values()),
          f"[rank] the ranking path launched a kernel: {launched}")
    print(f"[rank] phase {time.perf_counter() - t_phase:.1f}s; serve p50 "
          + ", ".join(f"{a} {d['serve_p50']:.3f} ms" for a, d in done.items())
          + "; step " + ", ".join(f"{a} {d['step_ms']:.1f} ms"
                                  for a, d in done.items())
          + "; no kernel of the port launched (every count 0)", flush=True)


def _lm_request(cfg, params, name: str, b: int, s: int, smi: str,
                tag: str = "[lm]", check_cfg=None) -> dict:
    """One request shape of ``[lm]`` (or of ``tag``'s phase): a warm-up,
    then ``greedy_generate`` of LM_NEW tokens timed on the stream (CUDA
    events at its steps), then check 1 (the last decode step against a
    prefill of the prompt and the new tokens; where ``check_cfg`` is
    given, both of a generation under that config), a decode step under
    CUDA's sync debug mode "error" (it reads nothing back to the host) and
    one decode step profiled."""
    from torch.profiler import ProfilerActivity, profile

    lap = (stages := Stages()).lap
    prompt = np.random.default_rng(300 + b).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    max_len = s + LM_NEW
    greedy_generate(cfg, params, prompt, 2, max_len=max_len)     # warm-up
    lap("warm-up")
    events = []

    def mark():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)

    sync()
    t0 = time.perf_counter()
    tokens, last = greedy_generate(cfg, params, prompt, LM_NEW,
                                   return_logits=True, on_step=mark)
    sync()
    wall_s = time.perf_counter() - t0
    prefill_ms = events[0].elapsed_time(events[1])
    decode_ms = [events[i].elapsed_time(events[i + 1])
                 for i in range(1, len(events) - 1)]
    check(tokens.shape == (b, LM_NEW) and len(decode_ms) == LM_NEW,
          f"{tag} ({name}) tokens {tokens.shape}, {len(decode_ms)} steps")
    check(bool(torch.isfinite(last).all()),
          f"{tag} ({name}) non-finite decode logits")
    lap("generate")
    if check_cfg is not None:
        tokens, last = greedy_generate(check_cfg, params, prompt, LM_NEW,
                                       return_logits=True)
        lap("generate for check 1")
    ccfg = check_cfg or cfg

    # check 1: a prefill of the prompt and every new token, whose last
    # position is the last decode step's (which fed the 32nd token)
    full = torch.from_numpy(np.concatenate([prompt, tokens], axis=1)
                            ).to("cuda")
    with torch.no_grad():      # room for the decode steps below
        cache, ref_logits = transformer.prefill(ccfg, params, full,
                                                max_len=s + LM_NEW + 3)
    check(bool(torch.isfinite(ref_logits).all()),
          f"{tag} ({name}) non-finite prefill logits")
    diff = (last - ref_logits).abs()
    max_d = float(diff.max())
    top2 = torch.topk(ref_logits, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * diff.max(dim=-1).values
    same = last.argmax(-1) == ref_logits.argmax(-1)
    check(max_d <= LM_DECODE_TOL and bool(same[decided].all()),
          f"{tag} ({name}) decode vs prefill: max |d| {max_d} (limit "
          f"{LM_DECODE_TOL}), argmax equal {same.tolist()} where decided "
          f"{decided.tolist()}")
    lap("check prefill")

    # no host read in a decode step; then one decode step profiled
    tok = ref_logits.argmax(-1).to(torch.int32)
    with torch.no_grad():
        sync()
        torch.cuda.set_sync_debug_mode("error")
        try:
            cache, _ = transformer.decode_step(ccfg, params, cache, tok)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            cache, _ = transformer.decode_step(ccfg, params, cache, tok)
            sync()
            prof_ms = (time.perf_counter() - t0) * 1e3
        if cfg.moe:       # one more step, its routing tables kept
            _, tables = _routed(transformer.decode_step, ccfg, params,
                                cache, tok)
    del cache, full, ref_logits, last
    ops_ms = device_ops(prof)
    busy = sum(t for _, t, _ in ops_ms)
    check(busy > 0, f"{tag} ({name}) the profiler saw no device time")
    top = sorted(ops_ms, key=lambda o: -o[1])[:4]
    lap("decode checks, profile")
    # a decode step reads every parameter (the tied head reads the whole
    # embedding) but the experts its tokens' routed pairs do not reach,
    # counted in each layer from a decode step's routing tables, and the
    # whole cache of max_len positions, K and V; it multiplies by the
    # active parameters
    n_params = (cfg.n_active_params() if cfg.moe else
                sum(t.numel() for t in tree_leaves(params)))
    cache_bytes = (2 * cfg.n_layers * b * max_len * cfg.n_kv_heads
                   * cfg.head_dim * torch.finfo(getattr(
                       torch, cfg.compute_dtype)).bits // 8)
    step_bytes = tree_bytes(params) + cache_bytes
    reach = ""
    if cfg.moe:
        check(len(tables) == cfg.n_layers,
              f"{tag} ({name}) {len(tables)} routing tables in a decode "
              f"step of {cfg.n_layers} layers")
        reached = sum(int((t >= 0).any(dim=2).any(dim=0).sum())
                      for t in tables)
        mlp = params["blocks"]["mlp"]
        per = sum(mlp[k][0, 0].numel() * mlp[k].element_size()
                  for k in ("wi", "wo"))
        total = cfg.n_layers * cfg.moe.n_experts
        step_bytes -= (total - reached) * per
        reach = (f", the experts of {reached} of {total} (layer, expert) "
                 f"pairs that a decode step's routed pairs reached")
    bound, by = bound_s(step_bytes, 0.0, 2.0 * n_params * b,
                        TARGET.peak_bf16_flops)
    p50, p99 = np.percentile(decode_ms, 50), np.percentile(decode_ms, 99)
    print(f"{tag} ({name}) B = {b}, {s:,}-token prompts, {LM_NEW} new "
          f"tokens, {'chunked_mha' if s >= 8192 else 'one-pass mha'} "
          f"prefill: greedy_generate wall {wall_s * 1e3:.1f} ms; prefill "
          f"{prefill_ms:.2f} ms; decode a token p50 {p50:.3f} / p99 "
          f"{p99:.3f} ms (min {min(decode_ms):.3f}, max {max(decode_ms):.3f})"
          f" vs bound {bound * 1e3:.3f} ms ({by}: {step_bytes:,} B of "
          f"parameters{reach} and a {max_len:,}-position cache at "
          f"{TARGET.hbm_bandwidth:.3e} B/s); decode vs prefill of the "
          f"{s + LM_NEW:,} tokens"
          + (" (every routed pair kept)" if check_cfg is not None else "")
          + f": max |d| {max_d:.4f} (limit "
          f"{LM_DECODE_TOL}), argmax equal in {int(same.sum())} of {b} rows"
          f" ({int(decided.sum())} decided); no host sync in a decode step; "
          f"one decode step profiled: wall {prof_ms:.2f} ms, device busy "
          f"{busy:.3f} ms ({100 * busy / prof_ms:.1f}%), "
          f"{sum(c for _, _, c in ops_ms)} device ops; top: "
          + "; ".join(f"{k[:40]} {t:.3f} ms x{c}" for k, t, c in top)
          + f"; {smi}; {stages.line()}", flush=True)
    return {"prefill_ms": prefill_ms, "p50": p50, "p99": p99,
            "bound_ms": bound * 1e3, "max_d": max_d}


def phase_lm(smi: str) -> None:
    """The LM serving path: gemma2-9b's full CONFIG (42 layers, bf16
    parameters and compute, drawn on the card through ``model_api``)
    serves LM_REQUESTS through ``greedy_generate`` (:func:`_lm_request`),
    then check 2: the full-width model cut to 2 layers in f32 on the card
    against its CPU copy. Check 3: no kernel of the port launches (the LM
    path has none: the launch counters before and after are equal). Frees
    the model and checks the allocator returns within LM_MEM_SLACK."""
    t_phase = time.perf_counter()
    lap = (stages := Stages()).lap
    before = launch_counts()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    arch = get_arch(LM_ARCH)
    cfg = arch.config
    t0 = time.perf_counter()
    params = model_api.model_api(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    sync()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    nbytes = tree_bytes(params)
    lap("init")
    done = {}
    for name, (b, s) in LM_REQUESTS.items():
        done[name] = _lm_request(cfg, params, name, b, s, smi)
        torch.cuda.empty_cache()
        lap(f"request ({name})")
    del params
    torch.cuda.empty_cache()

    # check 2: full width, cut depth, f32, the card against its CPU copy
    small = dataclasses.replace(cfg, **LM_CHECK)
    params = model_api.model_api(small).init(
        torch.Generator(device="cuda").manual_seed(1), "cuda")
    prompt = np.random.default_rng(301).integers(
        0, cfg.vocab_size, size=LM_CHECK_SHAPE).astype(np.int32)
    toks_c, logits_c = greedy_generate(small, params, prompt, LM_CHECK_NEW,
                                       return_logits=True)
    lap("check, card")
    params_h = _to_cpu(params)
    del params
    toks_h, logits_h = greedy_generate(small, params_h, prompt, LM_CHECK_NEW,
                                       return_logits=True)
    del params_h
    lap("check, CPU copy")
    err = float((logits_c.cpu() - logits_h).abs().max())
    check(np.array_equal(toks_c, toks_h)
          and torch.allclose(logits_c.cpu(), logits_h, **LM_CHECK_TOL),
          f"[lm] the card vs its CPU copy: tokens {toks_c.tolist()} vs "
          f"{toks_h.tolist()}, logits max abs err {err}")
    del logits_c, logits_h
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - mem0
    check(left <= LM_MEM_SLACK,
          f"[lm] {left:,} B still allocated after the phase")
    launched = launch_counts()
    check(launched == before,
          f"[lm] the LM path launched a kernel: {before} -> {launched}")
    flags = (f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
             f"{torch.backends.cudnn.allow_tf32}, bf16 reduced-precision "
             f"reduction "
             f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    print(f"[lm] {LM_ARCH} CONFIG ({arch.source}; {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV, "
          f"head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size:,}, window {cfg.local_window} on even layers, "
          f"{cfg.param_dtype}): {n_params:,} parameters "
          f"(LMConfig.n_params {cfg.n_params():,} leaves out the post "
          f"norms), {nbytes:,} B, drawn on the card in {init_s:.2f} s; "
          f"checks: the card vs its CPU copy (2 layers, window 64, f32, "
          f"TF32 off; depth and window cut for the CPU copy's time) on "
          f"{LM_CHECK_SHAPE[0]} x {LM_CHECK_SHAPE[1]} tokens, "
          f"{LM_CHECK_NEW} new: tokens equal, logits max abs err "
          f"{err:.3e} (rtol/atol {LM_CHECK_TOL['rtol']}); every logit "
          f"finite; no kernel of the port launched (every count as "
          f"before); peak memory {peak:,} B, {left:,} B left after; flags: "
          f"{flags}; {smi}", flush=True)
    print(f"[lm] phase {time.perf_counter() - t_phase:.1f}s; "
          + "; ".join(f"({n}) prefill {d['prefill_ms']:.1f} ms, decode p50 "
                      f"{d['p50']:.2f} / p99 {d['p99']:.2f} ms vs bound "
                      f"{d['bound_ms']:.2f}" for n, d in done.items())
          + f"; {stages.line()}", flush=True)


def _profiled_step(step, params, opt_state, batch) -> tuple:
    """One more train step under torch.profiler, the device's activity
    only (a full-width LM step runs ~133,000 host ops, whose events would
    cost the profiler tens of seconds): ``(params, opt_state, metrics,
    wall ms, the profiler)``."""
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        sync()
        prof_ms = (time.perf_counter() - t0) * 1e3
    return params, opt_state, m, prof_ms, prof


def phase_train_lm(smi: str) -> dict:
    """LM training at full width: gemma2-9b's CONFIG (9.24 B parameters,
    bf16, remat) through ``make_train_step`` with Adafactor on one batch of
    random tokens, TRAIN_LM_BATCH x train_4k's 4,096: a warm-up step,
    then TRAIN_LM_STEPS timed, then one profiled (a steady-state step:
    the warm-up's first-step costs read ~6 points less busy). Checks:
    every loss finite; the loss on the batch after the steps below the
    first step's; the full
    width cut to 2 layers in f32, one step on the card against its CPU
    copy (every leaf within TRAIN_LM_REL_TOL of its largest update); no
    kernel of the port launched; the allocator back within LM_MEM_SLACK.
    Returns the measured numbers, which [dryrun] holds its roofline
    against."""
    t_phase = time.perf_counter()
    lap = (stages := Stages()).lap
    before = launch_counts()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    arch = get_arch(LM_ARCH)
    cfg = arch.config
    shape = arch.shape(TRAIN_LM_SHAPE)
    b, s = TRAIN_LM_BATCH, shape["seq_len"]
    params = model_api.model_api(cfg).init(
        torch.Generator(device="cuda").manual_seed(0), "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(400)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    step, opt = model_api.make_train_step(cfg, lr=TRAIN_LM_LR)
    opt_state = opt.init(params)
    sync()
    torch.cuda.reset_peak_memory_stats()
    lap("init")

    params, opt_state, m = step(params, opt_state, batch)
    losses = [float(m["loss"])]
    lap("warm-up")
    step_ms = []
    for _ in range(TRAIN_LM_STEPS):
        sync()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    lap("steps")
    params, opt_state, m, prof_ms, prof = _profiled_step(
        step, params, opt_state, batch)
    losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    after = float(model_api.make_eval_step(cfg)(params, batch)["loss"])
    del params, opt_state, m
    torch.cuda.empty_cache()
    lap("profiled step")

    # the card against its CPU copy: full width, 2 layers, f32
    small = dataclasses.replace(cfg, **TRAIN_LM_CHECK)
    params_c = model_api.model_api(small).init(
        torch.Generator(device="cuda").manual_seed(1), "cuda")
    params_h = _to_cpu(params_c)
    tok = {"tokens": torch.randint(0, cfg.vocab_size, TRAIN_LM_CHECK_SHAPE,
                                   generator=gen, device="cuda",
                                   dtype=torch.int32)}
    step_s, opt_s = model_api.make_train_step(small)
    new_c, _, m_c = step_s(params_c, opt_s.init(params_c), tok)
    del params_c
    lap("check, card")
    # the CPU copy's step runs on a worker thread while this one reads the
    # profile: its ops release the interpreter lock, the reading is Python
    with ThreadPoolExecutor(1) as pool:
        cpu_step = pool.submit(step_s, params_h, opt_s.init(params_h),
                               {"tokens": tok["tokens"].cpu()})
        ops_ms = device_ops(prof)
        new_h, _, m_h = cpu_step.result()
    busy = sum(t for _, t, _ in ops_ms)
    check(busy > 0, "[train_lm] the profiler saw no device time")
    top = sorted(ops_ms, key=lambda o: -o[1])[:4]
    lap("check, CPU copy, with the profile read")
    errs = {}                   # compared on the card, a leaf at a time
    for (path, got), want, old in zip(tree_flatten_with_path(new_c)[0],
                                      tree_leaves(new_h),
                                      tree_leaves(params_h)):
        want, old = want.to("cuda"), old.to("cuda")
        upd = (want - old).abs().max().clamp(min=1e-30)
        errs[".".join(path)] = float((got - want).abs().max() / upd)
        del want, old
    loss_c, loss_h = float(m_c["loss"]), float(m_h["loss"])
    del new_c, new_h, params_h, m_c, m_h, tok, batch, gen
    worst = max(errs, key=errs.get)
    loss_err = abs(loss_c - loss_h)
    # the backward runs on the autograd engine's thread, whose cuBLAS
    # handle has a workspace of its own: the allocator's, not the phase's
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - mem0
    launched = launch_counts()
    lap("check, compare")

    med = float(np.median(step_ms))
    model_flops = 6.0 * cfg.n_active_params() * b * s
    mfu = model_flops / (med / 1e3) / TARGET.peak_bf16_flops
    print(f"[train_lm] {LM_ARCH} CONFIG ({arch.source}; {cfg.n_layers} "
          f"layers, d {cfg.d_model}, {cfg.param_dtype}, remat "
          f"{cfg.remat}): {n_params:,} parameters; make_train_step with "
          f"{opt.name} (lr {TRAIN_LM_LR}) on one batch of random tokens, "
          f"{b} x {s:,} "
          f"({TRAIN_LM_SHAPE}'s sequence length; its batch cut from "
          f"{shape['global_batch']} to the one a card holds): losses "
          + ", ".join(f"{x:.5f}" for x in losses)
          + f", after the steps {after:.5f}; step ms "
          + ", ".join(f"{t:.1f}" for t in step_ms)
          + f" (median {med:.2f}); peak memory {peak:,} B; model FLOPs "
          f"6 N D = {model_flops:.4e}, MFU {100 * mfu:.2f}% of the "
          f"{TARGET.peak_bf16_flops:.3e} bf16 peak; a step after them "
          f"profiled: wall "
          f"{prof_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / prof_ms:.1f}%), "
          f"{sum(c for _, _, c in ops_ms)} device ops; top: "
          + "; ".join(f"{k[:40]} {t:.1f} ms x{c}" for k, t, c in top)
          + f"; {smi}", flush=True)
    print(f"[train_lm] checks: every loss finite, the loss after the steps "
          f"below the first; the card vs its CPU copy (2 layers, f32, "
          f"{TRAIN_LM_CHECK_SHAPE[0]} x {TRAIN_LM_CHECK_SHAPE[1]} tokens, one "
          f"step): at most {errs[worst]:.3e} of a leaf's largest update "
          f"({worst}; median {np.median(list(errs.values())):.3e} over "
          f"{len(errs)} leaves; limit {TRAIN_LM_REL_TOL}), loss |d| "
          f"{loss_err:.3e}; no kernel of the port launched; {left:,} B left "
          f"after; phase {time.perf_counter() - t_phase:.1f}s; "
          f"{stages.line()}", flush=True)
    check(all(np.isfinite(losses + [after])),
          f"[train_lm] losses {losses}, after {after}")
    check(after < losses[0],
          f"[train_lm] the loss on the batch after {len(losses)} steps, "
          f"{after}, is not below the first step's {losses[0]}")
    check(errs[worst] <= TRAIN_LM_REL_TOL,
          f"[train_lm] the 2-layer f32 step on the card vs its CPU copy: "
          f"{errs} of each leaf's largest update (limit {TRAIN_LM_REL_TOL})")
    check(np.isclose(loss_c, loss_h, **TRAIN_LM_LOSS_TOL),
          f"[train_lm] the 2-layer f32 loss on the card {loss_c} vs its CPU "
          f"copy {loss_h}")
    check(left <= LM_MEM_SLACK,
          f"[train_lm] {left:,} B still allocated after the phase")
    check(launched == before,
          f"[train_lm] the training path launched a kernel: {before} -> "
          f"{launched}")
    return {"step_ms": med, "peak": peak, "busy_share": busy / prof_ms,
            "model_flops": model_flops, "mfu": mfu, "batch": b, "seq": s}


_ROUTES = threading.local()
_DISPATCH = transformer.moe_dispatch


def _routing_spy(router, xg, moe):
    """``moe_dispatch``, which also keeps each call's token table on the
    host where the calling thread collects them (:func:`_routed`)."""
    slot_tok, slot_gate = _DISPATCH(router, xg, moe)
    tables = getattr(_ROUTES, "tables", None)
    if tables is not None:
        tables.append(slot_tok.cpu())
    return slot_tok, slot_gate


def _routed(fn, *args, **kwargs) -> tuple:
    """``(fn(...), the routing tables of its moe_dispatch calls)`` on this
    thread (under :func:`_routing_spy`)."""
    _ROUTES.tables = []
    try:
        return fn(*args, **kwargs), _ROUTES.tables
    finally:
        _ROUTES.tables = None


def _moe_check_run(cfg, params, prompt: np.ndarray, train_tokens) -> dict:
    """[moe]'s check model on one device: the prefill's logits, a greedy
    generation (tokens, the last decode step's logits) with the routing
    tables of both, and one step of ``make_train_step`` (its new
    parameters and loss). ``params`` is left as it was."""
    dev = params["embed"].device
    tokens = torch.from_numpy(prompt).to(dev)
    with torch.no_grad():
        (_, pre), routes = _routed(transformer.prefill, cfg, params, tokens)
    (toks, last), more = _routed(greedy_generate, cfg, params, prompt,
                                 LM_CHECK_NEW, return_logits=True)
    step, opt = model_api.make_train_step(cfg)
    new, state, m = step(params, opt.init(params),
                         {"tokens": train_tokens.to(dev)})
    return {"prefill": pre, "tokens": toks, "last": last,
            "routes": routes + more, "new": new, "moment": state["m"],
            "loss": float(m["loss"])}


def _leaf_errs(new_c, new_h, old_h) -> dict[str, float]:
    """Each leaf's largest |card - CPU| over its largest update on the CPU,
    compared on the card a leaf at a time."""
    errs = {}
    for (path, got), want, old in zip(tree_flatten_with_path(new_c)[0],
                                      tree_leaves(new_h), tree_leaves(old_h)):
        want, old = want.to(got.device), old.to(got.device)
        upd = (want - old).abs().max().clamp(min=1e-30)
        errs[".".join(path)] = float((got - want).abs().max() / upd)
    return errs


def _adamw_errs(card: dict, host: dict, old_h) -> tuple[dict, int]:
    """AdamW's first step on the card against its CPU copy: for each leaf
    the larger of its gradient's error (the new first moment's, over its
    largest) and its step's (over its largest update, where the gradient
    is at least MOE_NEAR_ZERO); and how many entries are below that."""
    errs, n_small = {}, 0
    moments = tree_leaves(host["moment"])
    for (path, mc), mh, got, want, old in zip(
            tree_flatten_with_path(card["moment"])[0], moments,
            tree_leaves(card["new"]), tree_leaves(host["new"]),
            tree_leaves(old_h)):
        mh, want, old = (t.to(mc.device) for t in (mh, want, old))
        g_err = (mc - mh).abs().max() / mh.abs().max().clamp(min=1e-30)
        big = mh.abs() >= (1 - 0.9) * MOE_NEAR_ZERO
        upd = (want - old).abs().max().clamp(min=1e-30)
        p_err = ((got - want).abs() * big).max() / upd
        errs[".".join(path)] = float(max(g_err, p_err))
        n_small += int((~big).sum())
    return errs, n_small


def _same_routes(card: list, cpu: list, what: str) -> None:
    differ = [i for i, (a, b) in enumerate(zip(card, cpu))
              if not torch.equal(a, b)]
    check(len(card) == len(cpu) > 0 and not differ,
          f"[moe] {what}: the routing tables of the card and of its CPU "
          f"copy differ in calls {differ} of {len(card)} (vs {len(cpu)})")


def _moe_smoke_kimi() -> str:
    """kimi-k2 SMOKE (a shared expert beside 8 routed, top-2) on the card
    against its CPU copy: the forward's logits and routing tables, the
    loss, one Adafactor step (kimi's CONFIG optimizer) of
    ``make_train_step``. Returns its report."""
    cfg = dataclasses.replace(get_arch(MOE_SMOKE_ARCH).smoke_config,
                              optimizer="adafactor")
    params_c = model_api.model_api(cfg).init(
        torch.Generator(device="cuda").manual_seed(2), "cuda")
    params_h = _to_cpu(params_c)
    tok = torch.from_numpy(np.random.default_rng(303).integers(
        0, cfg.vocab_size, size=MOE_SMOKE_SHAPE).astype(np.int32))
    out = {}
    for dev, params in (("cuda", params_c), ("cpu", params_h)):
        with torch.no_grad():
            logits, routes = _routed(transformer.lm_forward, cfg, params,
                                     tok.to(dev))
        step, opt = model_api.make_train_step(cfg)
        new, _, m = step(params, opt.init(params), {"tokens": tok.to(dev)})
        out[dev] = (logits, routes, new, float(m["loss"]))
    (lc, rc, nc, loss_c), (lh, rh, nh, loss_h) = out["cuda"], out["cpu"]
    _same_routes(rc, rh, f"{MOE_SMOKE_ARCH} SMOKE forward")
    err = float((lc.cpu() - lh).abs().max())
    check(torch.allclose(lc.cpu(), lh, **LM_CHECK_TOL)
          and np.isclose(loss_c, loss_h, **TRAIN_LM_LOSS_TOL),
          f"[moe] {MOE_SMOKE_ARCH} SMOKE: logits max abs err {err}, loss "
          f"{loss_c} vs {loss_h}")
    errs = _leaf_errs(nc, nh, params_h)
    worst = max(errs, key=errs.get)
    check(errs[worst] <= TRAIN_LM_REL_TOL,
          f"[moe] {MOE_SMOKE_ARCH} SMOKE: one Adafactor step, card vs CPU "
          f"copy: {errs} of each leaf's largest update")
    return (f"{MOE_SMOKE_ARCH} SMOKE ({cfg.n_layers} layers, "
            f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} + "
            f"{cfg.moe.n_shared_experts} shared, f32) on "
            f"{MOE_SMOKE_SHAPE[0]} x {MOE_SMOKE_SHAPE[1]} tokens: routing "
            f"tables equal ({len(rc)} calls), logits max abs err {err:.3e}, "
            f"loss |d| {abs(loss_c - loss_h):.3e}, one Adafactor step at "
            f"most {errs[worst]:.3e} of a leaf's largest update ({worst})")


def _adamw_peak(shape, layers: int | None = None):
    """AdamW's update of a stacked bf16 leaf of ``shape`` (f32 moments, its
    first ``layers`` layers if given) on the card, twice: by the
    whole-leaf arithmetic and by ``training.optimizer``. Returns (the
    whole-leaf peak above the leaf, its gradient and moments, or None where
    it ran out of memory; the optimizer's; whether the new leaves are
    equal bit for bit)."""
    lr, b1, b2, eps, wd = 1e-3, 0.9, 0.999, 1e-8, 0.01
    if layers is not None:
        shape = (layers,) + tuple(shape[1:])
    gen = torch.Generator(device="cuda").manual_seed(5)
    p = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    g = (torch.randn(shape, generator=gen, device="cuda") * 1e-3
         ).to(torch.bfloat16)
    m = torch.zeros(shape, device="cuda")
    v = torch.zeros(shape, device="cuda")
    cf = torch.ones((), device="cuda")
    torch.cuda.empty_cache()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    def whole_leaf():                # its temporaries die with its frame
        g32 = g.to(torch.float32)
        m1 = b1 * m + (1 - b1) * g32
        v1 = b2 * v + (1 - b2) * g32 * g32
        mhat = m1 / (1 - b1 ** cf)
        vhat = v1 / (1 - b2 ** cf)
        step = lr * (mhat / (torch.sqrt(vhat) + eps)
                     + wd * p.to(torch.float32))
        return (p.to(torch.float32) - step).to(p.dtype)

    try:
        want = whole_leaf()
        sync()
        old = torch.cuda.max_memory_allocated() - base
    except torch.cuda.OutOfMemoryError:
        want, old = None, None
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got, _ = make_optimizer("adamw", lr).update(
        {"w": g}, {"m": {"w": m}, "v": {"w": v},
                   "count": torch.zeros((), dtype=torch.int32,
                                        device="cuda")}, {"w": p})
    sync()
    new = torch.cuda.max_memory_allocated() - base
    same = want is not None and torch.equal(got["w"], want)
    del p, g, m, v, got, want
    torch.cuda.empty_cache()
    return old, new, same


def _adamw_leaf_peaks(shape) -> str:
    """AdamW's update of granite's stacked expert leaf ``wi`` (``shape``)
    on the card: the peak the whole-leaf arithmetic and the layer-at-a-time
    update (``training.optimizer``) each add above the leaf, its gradient
    and moments; and on its first ADAMW_BIT_LAYERS layers, which the
    optimizer still updates a layer at a time and where the whole-leaf
    arithmetic fits, the new leaves equal bit for bit. Returns its
    report."""
    old, new, _ = _adamw_peak(shape)
    part = (ADAMW_BIT_LAYERS,) + tuple(shape[1:])
    check(4 * int(np.prod(part)) > SPLIT_BYTES,
          f"[moe] a {list(part)} leaf is updated whole, not a layer at a "
          f"time")
    old_p, new_p, same = _adamw_peak(shape, ADAMW_BIT_LAYERS)
    check(same, f"[moe] AdamW a layer at a time on a {list(part)} leaf "
          f"differs from the whole-leaf arithmetic on the card")
    return (f"AdamW on a {list(shape)} bf16 leaf (granite's expert wi): "
            f"the whole-leaf arithmetic adds "
            + (f"{old:,} B" if old is not None else "out of memory")
            + f" at its peak, a layer at a time {new:,} B (the new leaf "
            f"among them); on its first {ADAMW_BIT_LAYERS} layers "
            f"{old_p:,} B vs {new_p:,} B, the new leaves bit for bit the "
            f"same")


def phase_moe(smi: str) -> dict:
    """The MoE family on the card: granite-moe-3b-a800m's full CONFIG
    (32 layers, bf16, 40 experts top-8, drawn on the card through
    ``model_api``) serves MOE_REQUESTS through ``greedy_generate``
    (:func:`_lm_request`; check 1 with every routed pair kept), then
    trains through ``make_train_step`` with AdamW at MOE_TRAIN_BATCH x
    4,096 tokens: a warm-up step, then MOE_TRAIN_STEPS timed, then one
    profiled. Check 2: the full width cut to 2 layers in f32 on the card
    against its CPU copy (which runs on a worker thread while the card
    trains): the routing tables equal, the prefill's and the last decode
    step's logits and the greedy tokens, one AdamW step (each leaf within
    TRAIN_LM_REL_TOL of its largest gradient and update, the update where
    the gradient passes MOE_NEAR_ZERO). Check 3: the loss on the
    batch falls. Check 4: no kernel of the port launches. Check 5: the
    allocator returns within LM_MEM_SLACK. kimi-k2 SMOKE against its CPU
    copy (:func:`_moe_smoke_kimi`). Returns the training numbers, which
    [dryrun] holds against its one-card estimate (check 6)."""
    t_phase = time.perf_counter()
    lap = (stages := Stages()).lap
    before = launch_counts()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    arch = get_arch(MOE_ARCH)
    cfg = arch.config
    moe = cfg.moe
    with mock.patch.object(transformer, "moe_dispatch", _routing_spy), \
            ThreadPoolExecutor(2) as pool:
        # check 2's model: the card's run, then its CPU copy's on a worker
        # thread while the card trains (device-bound; serving is host-bound,
        # and its decode times would read the contention)
        small = dataclasses.replace(cfg, **MOE_CHECK)
        params_c = model_api.model_api(small).init(
            torch.Generator(device="cuda").manual_seed(1), "cuda")
        params_h = _to_cpu(params_c)
        prompt = np.random.default_rng(302).integers(
            0, cfg.vocab_size, size=MOE_CHECK_SHAPE).astype(np.int32)
        train_tok = torch.from_numpy(np.random.default_rng(304).integers(
            0, cfg.vocab_size, size=TRAIN_LM_CHECK_SHAPE).astype(np.int32))
        card = _moe_check_run(small, params_c, prompt, train_tok)
        del params_c
        lap("check, card")

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model_api.model_api(cfg).init(
            torch.Generator(device="cuda").manual_seed(0), "cuda")
        sync()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(params))
        nbytes = tree_bytes(params)
        lap("init")
        keep_all = dataclasses.replace(cfg, moe=dataclasses.replace(
            moe, capacity_factor=moe.n_experts / moe.top_k))
        done = {}
        for name, (b, s) in MOE_REQUESTS.items():
            done[name] = _lm_request(cfg, params, name, b, s, smi,
                                     tag="[moe]", check_cfg=keep_all)
            torch.cuda.empty_cache()
            lap(f"request ({name})")
        serve_peak = torch.cuda.max_memory_allocated()
        cpu_run = pool.submit(_moe_check_run, small, params_h, prompt,
                              train_tok)

        # training: AdamW, the CONFIG's optimizer, at its default lr
        shape = arch.shape(MOE_TRAIN_SHAPE)
        b, s = MOE_TRAIN_BATCH, shape["seq_len"]
        gen = torch.Generator(device="cuda").manual_seed(401)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device="cuda",
                                         dtype=torch.int32)}
        step, opt = model_api.make_train_step(cfg)
        opt_state = opt.init(params)
        sync()
        torch.cuda.reset_peak_memory_stats()
        params, opt_state, m = step(params, opt_state, batch)
        losses = [float(m["loss"])]
        lap("train warm-up")
        step_ms = []
        for _ in range(MOE_TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        lap("train steps")
        params, opt_state, m, prof_ms, prof = _profiled_step(
            step, params, opt_state, batch)
        losses.append(float(m["loss"]))
        ops_ms = device_ops(prof)
        peak = torch.cuda.max_memory_allocated()
        after = float(model_api.make_eval_step(cfg)(params, batch)["loss"])
        del params, opt_state, m, batch
        torch.cuda.empty_cache()
        lap("train profiled step")
        adamw_peaks = _adamw_leaf_peaks(
            model_api.abstract_params(cfg)["blocks"]["mlp"]["wi"].shape)
        lap("AdamW's peaks")
        host = cpu_run.result()
        lap("check, CPU copy waited for")
        kimi = _moe_smoke_kimi()
        lap("kimi-k2 SMOKE")

    # check 2: the card against its CPU copy
    _same_routes(card["routes"], host["routes"], "the 2-layer f32 model")
    n_routes = len(card["routes"])
    pre_err = float((card["prefill"].cpu() - host["prefill"]).abs().max())
    last_err = float((card["last"].cpu() - host["last"]).abs().max())
    check(np.array_equal(card["tokens"], host["tokens"])
          and torch.allclose(card["prefill"].cpu(), host["prefill"],
                             **LM_CHECK_TOL)
          and torch.allclose(card["last"].cpu(), host["last"],
                             **LM_CHECK_TOL),
          f"[moe] the card vs its CPU copy: tokens {card['tokens'].tolist()}"
          f" vs {host['tokens'].tolist()}, prefill logits max abs err "
          f"{pre_err}, last decode step's {last_err}")
    errs, n_small = _adamw_errs(card, host, params_h)
    worst = max(errs, key=errs.get)
    loss_err = abs(card["loss"] - host["loss"])
    del card, host, params_h
    busy = sum(t for _, t, _ in ops_ms)
    top = sorted(ops_ms, key=lambda o: -o[1])[:4]
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - mem0
    launched = launch_counts()
    lap("check, compare")

    med = float(np.median(step_ms))
    model_flops = 6.0 * cfg.n_active_params() * b * s
    mfu = model_flops / (med / 1e3) / TARGET.peak_bf16_flops
    print(f"[moe] {MOE_ARCH} CONFIG ({arch.source}; {cfg.n_layers} layers, "
          f"d {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV, "
          f"head_dim {cfg.head_dim}, {moe.n_experts} experts top-"
          f"{moe.top_k} of d_ff {moe.d_ff_expert}, capacity factor "
          f"{moe.capacity_factor}, vocab {cfg.vocab_size:,}, "
          f"{cfg.param_dtype}): {n_params:,} parameters "
          f"({cfg.n_active_params():,} active), {nbytes:,} B, drawn on the "
          f"card in {init_s:.2f} s; serving peak {serve_peak:,} B; "
          f"make_train_step with {opt.name} on one batch of random tokens, "
          f"{b} x {s:,} ({MOE_TRAIN_SHAPE}'s sequence length; its batch cut "
          f"from {shape['global_batch']} to the largest of 1, 2, 4, 8 that "
          f"the one-card dry run puts under 70 GB): losses "
          + ", ".join(f"{x:.5f}" for x in losses)
          + f", after the steps {after:.5f}; step ms "
          + ", ".join(f"{t:.1f}" for t in step_ms)
          + f" (median {med:.2f}); peak memory {peak:,} B; model FLOPs 6 N D "
          f"= {model_flops:.4e} (N active), MFU {100 * mfu:.2f}% of the "
          f"{TARGET.peak_bf16_flops:.3e} bf16 peak; a step after them "
          f"profiled: wall {prof_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / prof_ms:.1f}%), {sum(c for _, _, c in ops_ms)} "
          f"device ops; top: "
          + "; ".join(f"{k[:40]} {t:.1f} ms x{c}" for k, t, c in top)
          + f"; {smi}", flush=True)
    print(f"[moe] checks: decode vs prefill (every routed pair kept) in "
          f"both requests; the card vs its CPU copy (2 layers, f32, TF32 "
          f"off): routing tables equal ({n_routes} calls: the prefill's "
          f"and a generation's), {MOE_CHECK_SHAPE[0]} x "
          f"{MOE_CHECK_SHAPE[1]} tokens, {LM_CHECK_NEW} new: tokens equal, "
          f"prefill logits max abs err {pre_err:.3e}, last decode step's "
          f"{last_err:.3e} (rtol/atol {LM_CHECK_TOL['rtol']}); one AdamW step "
          f"on {TRAIN_LM_CHECK_SHAPE[0]} x {TRAIN_LM_CHECK_SHAPE[1]} tokens: "
          f"each leaf's gradient (its first moment) and its step (where "
          f"|g| >= {MOE_NEAR_ZERO}; {n_small:,} entries below) at most "
          f"{errs[worst]:.3e} of their largest ({worst}; median "
          f"{np.median(list(errs.values())):.3e} over {len(errs)} leaves; "
          f"limit {TRAIN_LM_REL_TOL}), loss |d| {loss_err:.3e}; "
          f"{kimi}; {adamw_peaks}; no kernel of the port launched; "
          f"{left:,} B left after; "
          f"phase {time.perf_counter() - t_phase:.1f}s; {stages.line()}",
          flush=True)
    print(f"[moe] phase {time.perf_counter() - t_phase:.1f}s; "
          + "; ".join(f"({n}) prefill {d['prefill_ms']:.1f} ms, decode p50 "
                      f"{d['p50']:.2f} / p99 {d['p99']:.2f} ms vs bound "
                      f"{d['bound_ms']:.2f}" for n, d in done.items())
          + f"; train step {med:.1f} ms, MFU {100 * mfu:.2f}%, peak "
          f"{peak:,} B, busy {100 * busy / prof_ms:.1f}%", flush=True)
    check(all(np.isfinite(losses + [after])),
          f"[moe] losses {losses}, after {after}")
    check(after < losses[0],
          f"[moe] the loss on the batch after {len(losses)} steps, {after}, "
          f"is not below the first step's {losses[0]}")
    check(busy > 0, "[moe] the profiler saw no device time")
    check(errs[worst] <= TRAIN_LM_REL_TOL,
          f"[moe] the 2-layer f32 AdamW step on the card vs its CPU copy: "
          f"{errs} of each leaf's largest gradient or update (limit "
          f"{TRAIN_LM_REL_TOL})")
    check(left <= LM_MEM_SLACK,
          f"[moe] {left:,} B still allocated after the phase")
    check(launched == before,
          f"[moe] the MoE path launched a kernel: {before} -> {launched}")
    return {"step_ms": med, "peak": peak, "busy_share": busy / prof_ms,
            "model_flops": model_flops, "mfu": mfu, "batch": b, "seq": s}


#: one lane of [dryrun]: its cells through the dry run's CLI, one after
#: another; the exit code is nonzero if any cell failed
DRYRUN_LANE = r"""
import json, sys
from repro_torch.launch import dryrun
rc = 0
for arch, shape, mesh, batch in json.loads(sys.argv[1]):
    args = ["--arch", arch, "--shape", shape, "--mesh", mesh, "--out",
            sys.argv[2], "--force"]
    rc |= dryrun.main(args + ([] if batch is None else ["--batch", str(batch)]))
sys.exit(rc)
"""


class DryRun:
    """``[dryrun]``: the dry runs of DRYRUN_CELLS (through ``python -m
    repro_torch.launch.dryrun``'s ``main``) in DRYRUN_LANES subprocesses,
    writing their records into a temporary directory of the checkout; the
    fake process group lives in those processes only. :meth:`collect`
    waits for them (at most DRYRUN_TIMEOUT_S from the start), checks every
    record ``ok``, prints them and holds the one-card rooflines against
    [train_lm]'s and [moe]'s measured steps (their peaks against the
    estimates); :meth:`stop` ends any still running and removes the
    directory."""

    def __init__(self):
        self.dir = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_", dir=ROOT))
        self.t0 = time.perf_counter()
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        self.procs = []
        for lane in range(DRYRUN_LANES):
            cells = DRYRUN_CELLS[lane::DRYRUN_LANES]
            log = open(self.dir / f"lane{lane}.log", "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, "-c", DRYRUN_LANE, json.dumps(cells),
                 str(self.dir)], stdout=log, stderr=subprocess.STDOUT,
                env=env, cwd=ROOT), log))
        # the hillclimb's four records, written to hillclimb.json
        self.hill_json = self.dir / "hillclimb.json"
        log = open(self.dir / "hillclimb.log", "w")
        self.hill = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.hillclimb", "--which",
             HILLCLIMB_WHICH, "--out", str(self.hill_json)], stdout=log,
            stderr=subprocess.STDOUT, env=env, cwd=ROOT), log)

    def stop(self) -> None:
        for proc, log in (*self.procs, self.hill):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)

    def _against(self, what: str, rec: dict, measured: dict,
                 smi: str) -> float:
        """Prints a phase's measured step against its one-card record;
        returns the measured peak over the estimated."""
        one = rec["roofline"]
        est = rec["memory_analysis"]["peak_size_in_bytes"]
        step_s = measured["step_ms"] / 1e3
        print(f"[dryrun] {what}'s step on the card against the one-card "
              f"roofline ({measured['batch']} x {measured['seq']:,}): step "
              f"{measured['step_ms']:.1f} ms vs bound "
              f"{one['bound_s'] * 1e3:.1f} ms ({one['bottleneck']}; roofline "
              f"share {100 * one['bound_s'] / step_s:.1f}%); counted FLOPs "
              f"{one['flops_per_chip']:.4e} vs 6 N D "
              f"{measured['model_flops']:.4e} (ratio "
              f"{one['flops_per_chip'] / measured['model_flops']:.3f}); "
              f"achieved {one['flops_per_chip'] / step_s:.4e} FLOP/s, MFU "
              f"{100 * measured['mfu']:.2f}%; device busy "
              f"{100 * measured['busy_share']:.1f}%; peak measured "
              f"{measured['peak']:,} B vs estimated {est:,} B (ratio "
              f"{measured['peak'] / est:.3f}); [dryrun] "
              f"{time.perf_counter() - self.t0:.1f} s from its start; {smi}",
              flush=True)
        return measured["peak"] / est

    def collect(self, measured: dict, moe: dict, smi: str) -> None:
        rcs = []
        for lane, (proc, log) in enumerate(self.procs):
            left = DRYRUN_TIMEOUT_S - (time.perf_counter() - self.t0)
            try:
                rcs.append(proc.wait(timeout=max(left, 1.0)))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"[dryrun] lane {lane} passed "
                                   f"{DRYRUN_TIMEOUT_S} s") from None
            log.close()
        recs = {}
        for arch, shape, mesh, batch in DRYRUN_CELLS:
            suffix = "" if batch is None else f"__b{batch}"
            path = (self.dir
                    / f"{arch}__{shape}__{MESHES[mesh][0]}{suffix}.json")
            tails = " | ".join(p.read_text()[-800:]
                               for p in self.dir.glob("lane*.log"))
            check(path.exists(),
                  f"[dryrun] no record {path.name} (rcs {rcs}); the lanes' "
                  f"output ends: {tails}")
            rec = json.loads(path.read_text())
            check(rec["status"] == "ok",
                  f"[dryrun] {rec['cell']}: {rec['status']} {rec.get('op')}:"
                  f" {rec.get('error', '')[:1500]}\n{rec.get('trace', '')}")
            recs[arch, mesh] = rec
        check(rcs == [0] * DRYRUN_LANES, f"[dryrun] the lanes' rcs {rcs}")
        for rec in recs.values():
            r, mem = rec["roofline"], rec["memory_analysis"]
            coll = ", ".join(f"{k} {v:.3e}"
                             for k, v in r["coll_breakdown"].items() if v)
            print(f"[dryrun] {rec['cell']} ({rec['shape']}): ok in "
                  f"{rec['run_s']:.1f} s of its process, {r['chips']} "
                  f"chips; a chip: {r['flops_per_chip']:.4e} FLOPs, "
                  f"{r['bytes_per_chip']:.4e} B, collectives "
                  f"{r['coll_bytes_per_chip']:.4e} B ({coll}), peak "
                  f"{mem['peak_size_in_bytes']:,} B (arguments "
                  f"{mem['argument_size_in_bytes']:,}); terms compute "
                  f"{r['t_compute_s']:.4f} / memory {r['t_memory_s']:.4f} / "
                  f"collective {r['t_collective_s']:.4f} s over {r['link']}; "
                  f"bound {r['bound_s']:.4f} s ({r['bottleneck']}); model "
                  f"FLOPs {r['model_flops']:.4e}, useful "
                  f"{r['useful_flops_fraction']:.3f}; "
                  f"{r['counter']['n_ops']:,} local ops; comm "
                  f"{rec['comm_counts']}; torch {torch.__version__}",
                  flush=True)
        self._against("[train_lm]", recs[LM_ARCH, "one"], measured, smi)
        ratio = self._against("[moe]", recs[MOE_ARCH, "one"], moe, smi)
        check(abs(ratio - 1) <= MOE_PEAK_TOL,
              f"[moe] the training peak {moe['peak']:,} B is {ratio:.3f} of "
              f"the one-card dry run's estimate (limit 1 +- {MOE_PEAK_TOL})")

    def collect_hillclimb(self, smi: str) -> None:
        """``[hillclimb]``: waits for the hillclimb's process, checks its
        rc and four records ``ok``, the halo step's all-to-all bytes a chip
        (HILLCLIMB_HALO_A2A) and its collectives below the baseline's, and
        prints each variant's line."""
        from repro_torch.launch.hillclimb import _line

        proc, log = self.hill
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - self.t0)
        try:
            rc = proc.wait(timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"[hillclimb] its run passed "
                               f"{DRYRUN_TIMEOUT_S} s") from None
        log.close()
        out = (self.dir / "hillclimb.log").read_text()
        tail = out[-3000:]
        took = "; ".join(ln.strip("[]") for ln in out.splitlines()
                         if " done in " in ln)
        check(rc == 0 and self.hill_json.exists(),
              f"[hillclimb] rc {rc}; its output ends: {tail}")
        recs = {r["cell"]: r for r in json.loads(self.hill_json.read_text())}
        bad = {k: (r.get("op"), r.get("error", "")[:500])
               for k, r in recs.items() if r["status"] != "ok"}
        check(len(recs) == 4 and not bad,
              f"[hillclimb] records {list(recs)}, failed {bad}; {tail}")
        halo = recs[HILLCLIMB_HALO]["roofline"]
        base = recs[HILLCLIMB_GNN_BASE]["roofline"]
        a2a = halo["coll_breakdown"]["all-to-all"]
        check(a2a == HILLCLIMB_HALO_A2A
              and halo["coll_bytes_per_chip"] < base["coll_bytes_per_chip"],
              f"[hillclimb] halo all-to-all {a2a} B a chip (want "
              f"{HILLCLIMB_HALO_A2A}), collectives "
              f"{halo['coll_bytes_per_chip']} vs the baseline's "
              f"{base['coll_bytes_per_chip']}")
        for rec in recs.values():
            r = rec["roofline"]
            coll = ", ".join(f"{k} {v:,}" for k, v in
                             r["coll_breakdown"].items() if v)
            print(f"[hillclimb] {_line(rec)}; a chip {r['flops_per_chip']:.4e}"
                  f" FLOPs, {r['bytes_per_chip']:.4e} B, collectives {coll}",
                  flush=True)
        print(f"[hillclimb] checks: 4 records ok; halo all-to-all {a2a:,} B a "
              f"chip == 45 x 256 x 16 x 128 x 4; collectives a chip "
              f"{halo['coll_bytes_per_chip']:.4e} B vs the baseline's "
              f"{base['coll_bytes_per_chip']:.4e} B (ratio "
              f"{halo['coll_bytes_per_chip'] / base['coll_bytes_per_chip']:.2e});"
              f" in its process: {took}; collected "
              f"{time.perf_counter() - self.t0:.1f} s from its start; {smi}",
              flush=True)


def _timed_call(fn, *args) -> tuple:
    """(fn(*args), its wall seconds)."""
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def make_data(n: int):
    """The mixture's rows, cluster labels and centers, and the run's
    uncorrelated queries."""
    X, labels, centers = gaussian_mixture(n, DIM, N_CLUSTERS, seed=0)
    rng = np.random.default_rng(1)
    base = centers[rng.integers(0, len(centers), size=N_QUERIES)]
    Q = (base + 0.3 * rng.normal(size=base.shape)).astype(np.float32)
    return X, labels, centers, Q


def phase_build(X: np.ndarray):
    """The build on the card (launch counts set to 0 just before). Each
    morsel's insert notes its nodes and the f32 kernel's spread launches
    since the last morsel's (its upper descent, then its insert): the
    spread schedule may run only in morsels below a level's full size (its
    doubling warm-up and a short last one)."""
    cfg = PAPER_INDEX._replace(batch_size=BUILD_MORSEL)
    morsels: dict[int, list] = {}   # level (its rows) -> [(nodes, spread)]
    insert = build_module._insert_batch
    noted = 0                       # spread launches up to the last morsel

    def noted_insert(adj, deg, vectors, batch_ids, *args, **kwargs):
        nonlocal noted
        out = insert(adj, deg, vectors, batch_ids, *args, **kwargs)
        now = gather_distance.PATH_LAUNCHES["spread"]
        morsels.setdefault(adj.shape[0], []).append(
            (batch_ids.shape[0], now - noted))
        noted = now
        return out

    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(build_module, "_insert_batch", noted_insert):
        idx, stats = NavixIndex.create(X, cfg)        # on the card
    peak = torch.cuda.max_memory_allocated()
    spread = [(b, n) for ms in morsels.values() for b, n in ms if n]
    full = {}                       # a level's full size -> its spread
    for ms in morsels.values():
        size = max(b for b, _ in ms)
        full[size] = sum(n for b, n in ms if b == size)
    check(not any(full.values()),
          f"full morsels ran spread ({full}: nodes -> spread launches)")
    check(sum(n for _, n in spread)
          == gather_distance.PATH_LAUNCHES["spread"],
          "the build launched spread after its last morsel")
    g = idx.graph
    check(g.device.type == "cuda", "index was not built on the card")
    mean_deg = float(g.lower_deg.float().mean())
    sym = check_symmetric_fraction(g)
    check(mean_deg > 0 and int(g.lower_deg.max()) <= g.m_l,
          f"degenerate lower graph (mean degree {mean_deg})")
    cut = "" if g.n == N_GIST else f" (n cut from {N_GIST:,} to {g.n:,})"
    print(f"[build] n={g.n:,}{cut} d={g.dim} l2 m_u={cfg.m_u} M_L={g.m_l} "
          f"efc={cfg.ef_construction} morsel={cfg.batch_size}: "
          f"{stats.seconds:.3f}s, n_upper={g.n_upper}, mean lower degree "
          f"{mean_deg:.3f}, symmetric fraction {sym:.4f}, "
          f"search_dc={stats.search_dc}, peak device memory "
          f"{peak / 2**30:.3f} GiB (index {g.nbytes() / 2**30:.3f} GiB)",
          flush=True)
    print(f"[build] schedules: tiled {gather_distance.PATH_LAUNCHES['tiled']}"
          f" launches, spread {sum(n for _, n in spread)} in {len(spread)} "
          f"morsels below their level's full size (nodes: "
          + ", ".join(str(b) for b, _ in spread)
          + f"); full morsels ({', '.join(map(str, full))} nodes by level) "
          "all tiled", flush=True)
    return idx


def make_masks(n: int, sigmas) -> dict[float, np.ndarray]:
    rng = np.random.default_rng(2)
    return {s: rng.random(n) < s for s in sigmas}


def phase_search(idx, Q: np.ndarray, masks) -> dict[float, tuple]:
    """The f32 sweep. Returns {sigma: (result, brute-force ids, recall)}."""
    results = {}
    for sigma, mask in masks.items():
        idx.search_many(Q, k=K, efs=EFS, semimask=mask)       # warm-up
        sync()
        before = gather_distance.LAUNCHES
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = idx.search_many(Q, k=K, efs=EFS, semimask=mask)
        sync()
        dt = time.perf_counter() - t0
        work = torch.cuda.max_memory_allocated() - base
        launches = gather_distance.LAUNCHES - before
        check(launches > 0, f"sigma={sigma}: the search launched no kernel")
        check(tuple(res.ids.shape) == (len(Q), K)
              and bool(torch.isfinite(res.dists[res.ids >= 0]).all()),
              f"sigma={sigma}: malformed result")
        true_ids = torch.cat([idx.brute_force(Q[i:i + 256], k=K,
                                              semimask=mask)[1]
                              for i in range(0, len(Q), 256)])
        rec = idx.recall(res.ids, true_ids)
        st = res.stats
        picks = (st.picks.float().mean(dim=0)).tolist()
        print(f"[search] sigma={sigma}: QPS {len(Q) / dt:.1f} ({dt:.3f}s for "
              f"B={len(Q)}), recall@{K} {rec:.4f}, mean t_dc "
              f"{float(st.t_dc.float().mean()):.1f}, mean s_dc "
              f"{float(st.s_dc.float().mean()):.1f}, mean picks "
              f"[onehop-s {picks[0]:.1f}, directed {picks[1]:.1f}, blind "
              f"{picks[2]:.1f}], iters max {int(st.iters.max())} mean "
              f"{float(st.iters.float().mean()):.1f}, kernel launches "
              f"{launches}, pass working set {work / 2**30:.3f} GiB",
              flush=True)
        results[sigma] = (res, true_ids, rec)
    return results


def phase_quantize(idx):
    """Make the index int8-resident: codes + scales on the card, the f32
    rows copied once to the host's exact tier."""
    sync()
    t0 = time.perf_counter()
    qidx = idx.quantize_resident()
    sync()
    dt = time.perf_counter() - t0
    store = qidx.graph.vectors
    check(isinstance(store, QuantizedStore)
          and store.codes.device.type == "cuda",
          "quantize_resident() left no int8 store on the card")
    f32_b, q_b = idx.graph.vector_nbytes(), qidx.graph.vector_nbytes()
    want = (DIM + 4) / (4 * DIM)
    check(q_b * 4 * DIM == f32_b * (DIM + 4),
          f"int8 bytes {q_b} are not (d + 4)/(4d) of f32 bytes {f32_b}")
    print(f"[quantize] quantize_resident() {dt:.3f}s: vector_nbytes f32 "
          f"{f32_b:,} B, int8 {q_b:,} B, ratio {q_b / f32_b:.4f} "
          f"((d + 4)/(4d) = {want:.4f}); exact tier {qidx.exact.nbytes():,} "
          f"B on the host ({'memmap' if qidx.exact.is_mmapped else 'memory'})",
          flush=True)
    return qidx


@dataclasses.dataclass
class _TimedTier(ExactTier):
    """The index's exact tier, noting when the re-rank of a pass starts
    (the beam loop has ended and its ids are on the host) and how long it
    takes, so one pass splits into its two stages."""

    started: float = 0.0
    seconds: float = 0.0

    def rerank_many(self, Q, ids, k):
        self.started = time.perf_counter()
        out = super().rerank_many(Q, ids, k)
        self.seconds = time.perf_counter() - self.started
        return out


def phase_search_int8(qidx, Q: np.ndarray, masks, f32) -> dict:
    """The int8 sweep through ``search_quantized_many``: a warm-up pass,
    then a timed pass whose beam loop (on the card, up to the ids' copy
    to the host) and host re-rank are timed apart. Returns {sigma:
    result}."""
    f32_store = N * DIM * 4
    results = {}
    tier = _TimedTier(vectors=qidx.exact.vectors, metric=qidx.exact.metric)
    timed_idx = dataclasses.replace(qidx, exact=tier)
    for sigma, mask in masks.items():
        timed_idx.search_quantized_many(Q, k=K, efs=EFS, semimask=mask)
        sync()
        before = launch_counts()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = timed_idx.search_quantized_many(Q, k=K, efs=EFS, semimask=mask)
        sync()
        dt = time.perf_counter() - t0
        beam_s, rerank_s = tier.started - t0, tier.seconds
        work = torch.cuda.max_memory_allocated() - base
        after = launch_counts()
        launched = {n: after[n] - before[n] for n in after}
        check(launched["quantized_gather_distance_batch"] > 0,
              f"sigma={sigma}: the int8 pass launched no int8 kernel")
        check(launched["gather_distance_batch"] == 0
              and launched["gather_distance"] == 0,
              f"sigma={sigma}: the int8 pass launched an f32 gather kernel")
        check(work < f32_store,
              f"sigma={sigma}: the int8 pass allocated {work} B, as much as "
              f"an f32 store ({f32_store} B)")
        check(tuple(res.ids.shape) == (len(Q), K)
              and res.ids.device.type == "cuda"
              and bool(torch.isfinite(res.dists[res.ids >= 0]).all()),
              f"sigma={sigma}: malformed result")
        _, true_ids, rec_f32 = f32[sigma]
        rec = qidx.recall(res.ids, true_ids)
        st = res.stats
        results[sigma] = res
        print(f"[int8] sigma={sigma}: QPS {len(Q) / dt:.1f} ({dt:.3f}s for "
              f"B={len(Q)}): beam loop {beam_s:.3f}s (QPS "
              f"{len(Q) / beam_s:.1f}), host re-rank {rerank_s:.3f}s "
              f"({100 * rerank_s / dt:.1f}% of the pass); recall@{K} "
              f"{rec:.4f} (f32 arm {rec_f32:.4f}, diff {rec - rec_f32:+.4f}); "
              f"mean t_dc {float(st.t_dc.float().mean()):.1f}, iters max "
              f"{int(st.iters.max())} mean {float(st.iters.float().mean()):.1f}"
              f"; int8 kernel launches "
              f"{launched['quantized_gather_distance_batch']}, f32 0; pass "
              f"working set {work / 2**30:.3f} GiB (an f32 store is "
              f"{f32_store / 2**30:.3f} GiB)", flush=True)
    return results


def _gather_kernel_ms(ops_ms, int8: bool) -> float:
    """Device ms of the f32 (or the int8) gather-distance kernel, both
    schedules, among :func:`device_ops`' entries."""
    return sum(t for k, t, _ in ops_ms if "gather_distance_" in k
               and ("quantized" in k) == int8)


def phase_profile(idx, Q: np.ndarray, mask) -> None:
    """One search pass under torch.profiler: where its time goes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idx.search_many(Q, k=K, efs=EFS, semimask=mask)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops_ms = device_ops(prof)
    device_ms = sum(t for _, t, _ in ops_ms)
    kernel_ms = _gather_kernel_ms(ops_ms, int8=False)
    launches = sum(e.name() == "cudaLaunchKernel"
                   for e in prof.profiler.kineto_results.events())
    check(device_ms > 0, "the profiler saw no device time")
    print(f"[profile] sigma=0.1, one pass of B={len(Q)} under torch.profiler:"
          f" wall {wall_ms:.1f} ms, device busy {device_ms:.1f} ms "
          f"({100 * device_ms / wall_ms:.1f}% of wall), gather_distance "
          f"kernel {kernel_ms:.1f} ms ({100 * kernel_ms / device_ms:.1f}% of "
          f"device time), {launches} kernel launches from the host",
          flush=True)


def _same_result(one, many, i: int) -> bool:
    """Single-query result ``one`` equals lane ``i`` of ``many``, bitwise."""
    return (torch.equal(one.ids, many.ids[i])
            and torch.equal(one.dists, many.dists[i])
            and all(torch.equal(getattr(one.stats, f),
                                getattr(many.stats, f)[i])
                    for f in one.stats._fields))


def _parity_arm(name: str, kernel, search_one, search_many, cpu_many, Q,
                masks, sweep: dict) -> dict:
    """Batched == single-query on the card, bit for bit: against the
    parity batch and, at each sigma the sweep ran, against the same lane
    of the sweep's B = N_QUERIES batch (whose launches were tiled); then
    the card against the plain path on CPU copies. ``kernel`` is the
    gather kernel's wrapper module: every one-lane launch of the
    single-query searches must run on the spread schedule. Each search is
    timed on the host clock, ending in a synchronize, and the plain path
    apart; ``first_ms`` keeps query 0's own wall ms per sigma."""
    identical = total = crossed = 0
    wall_ms, first_ms, per_search, cpu_s = {}, {}, {}, 0.0
    for sigma in PARITY_SIGMAS:
        mask = masks[sigma]
        many = search_many(Q, k=K, efs=EFS, semimask=mask)
        lanes0, paths0 = kernel.ONE_LANE_LAUNCHES, dict(kernel.PATH_LAUNCHES)
        walls = []
        for i in range(len(Q)):
            sync()
            t0 = time.perf_counter()
            one = search_one(Q[i], k=K, efs=EFS, semimask=mask)
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
            check(_same_result(one, many, i),
                  f"{name} sigma={sigma} lane {i}: batched engine != "
                  f"single-query search on the card")
            if sigma in sweep:
                check(_same_result(one, sweep[sigma], i),
                      f"{name} sigma={sigma} lane {i}: the sweep's B="
                      f"{N_QUERIES} batch != single-query search")
                crossed += 1
        lanes = kernel.ONE_LANE_LAUNCHES - lanes0
        grew = {s: kernel.PATH_LAUNCHES[s] - paths0[s] for s in SCHEDULES}
        check(lanes > 0 and grew == {"tiled": 0, "spread": lanes},
              f"{name} sigma={sigma}: {lanes} one-lane launches, by "
              f"schedule {grew}")
        wall_ms[sigma] = float(np.mean(walls))
        first_ms[sigma] = walls[0]
        per_search[sigma] = lanes / len(Q)
        t0 = time.perf_counter()
        plain = cpu_many(Q, k=K, efs=EFS, semimask=mask)
        cpu_s += time.perf_counter() - t0
        gpu_ids, gpu_d = many.ids.cpu(), many.dists.cpu()
        for i in range(len(Q)):
            total += 1
            if torch.equal(plain.ids[i], gpu_ids[i]):
                identical += 1
                continue
            # the lanes may differ only by the order of near-tied distances
            check(torch.allclose(plain.dists[i], gpu_d[i], rtol=1e-5,
                                 atol=0.0),
                  f"{name} sigma={sigma} lane {i}: kernel path and plain "
                  f"path differ beyond a distance tie")
    check(identical >= 0.99 * total,
          f"{name}: only {identical}/{total} lanes identical to the plain "
          f"path")
    return {"identical": identical, "total": total, "crossed": crossed,
            "wall_ms": wall_ms, "first_ms": first_ms,
            "per_search": per_search, "cpu_s": cpu_s}


def _profile_single(search_one, q, mask, int8: bool) -> tuple:
    """One single-query search under torch.profiler: (wall ms, device busy
    ms, the gather kernel's ms, device ops). Device activity only: what is
    read here are device events, and the host's events of a search's
    ~53,000 device ops would triple the profiler's own seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        search_one(q, k=K, efs=EFS, semimask=mask)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops_ms = device_ops(prof)
    busy_ms = sum(t for _, t, _ in ops_ms)
    check(busy_ms > 0, "the profiler saw no device time in a search")
    return (wall_ms, busy_ms, _gather_kernel_ms(ops_ms, int8),
            sum(c for _, _, c in ops_ms))


def phase_parity(idx, qidx, Q: np.ndarray, masks, f32_sweep: dict,
                 int8_sweep: dict):
    """Returns the f32 index's CPU copy (the [postfilter] phase reuses
    it)."""
    t_phase = time.perf_counter()
    Qp = Q[:PARITY_LANES]
    cpu = torch.device("cpu")
    cpu_idx = NavixIndex.from_graph(idx.graph, idx.config, device="cpu")
    arms = {"f32": _parity_arm(
        "f32", gather_distance, idx.search, idx.search_many,
        cpu_idx.search_many, Qp, masks,
        {s: r[0] for s, r in f32_sweep.items()})}
    # the CPU copy keeps the host exact tier; only the graph moves
    cpu_q = dataclasses.replace(qidx, graph=qidx.graph.to(cpu),
                                quantized=None)
    arms["int8"] = _parity_arm(
        "int8", quantized_gather_distance, qidx.search_quantized,
        qidx.search_quantized_many, cpu_q.search_quantized_many, Qp, masks,
        int8_sweep)
    lanes = len(PARITY_SIGMAS) * PARITY_LANES
    f32, int8 = arms["f32"], arms["int8"]
    print(f"[parity] batched == single-query on the card, bit for bit: f32 "
          f"{lanes}/{lanes}, int8 {lanes}/{lanes} lanes (sigma "
          f"{PARITY_SIGMAS}; of them f32 {f32['crossed']} and int8 "
          f"{int8['crossed']} also equal the same lane of the sweep's B="
          f"{N_QUERIES} batch, launched tiled); kernel path vs plain path on "
          f"CPU copies: f32 {f32['identical']}/{f32['total']}, int8 "
          f"{int8['identical']}/{int8['total']} lanes with identical ids, "
          f"the rest differ only at ties within 1e-5 relative", flush=True)
    t_prof = time.perf_counter()
    profiled = {
        "f32": _profile_single(idx.search, Qp[0], masks[0.1], int8=False),
        "int8": _profile_single(qidx.search_quantized, Qp[0], masks[0.1],
                                int8=True)}
    phase_s = time.perf_counter() - t_phase
    prof_s = time.perf_counter() - t_prof
    cpu_s = f32["cpu_s"] + int8["cpu_s"]
    parts = []
    for name, arm in arms.items():
        wall, busy, kern, n_ops = profiled[name]
        parts.append(
            f"{name}: mean wall ms per search "
            + ", ".join(f"sigma={s} {ms:.3f}" for s, ms in
                        arm["wall_ms"].items())
            + "; one-lane launches per search "
            + ", ".join(f"{s} {n:.1f}" for s, n in arm["per_search"].items())
            + f"; one search at sigma=0.1 under torch.profiler: wall "
            f"{wall:.3f} ms, device busy {busy:.4f} ms in {n_ops} device ops "
            f"({100 * busy / arm['first_ms'][0.1]:.1f}% of the same query's "
            f"unprofiled wall, {arm['first_ms'][0.1]:.3f} ms), the gather "
            f"kernel {kern:.4f} ms "
            f"({100 * kern / busy:.1f}% of device busy)")
    print("[single] " + " | ".join(parts)
          + f" | plain path on CPU copies {cpu_s:.3f}s of the phase's "
          f"{phase_s:.3f}s ({100 * cpu_s / phase_s:.1f}%), the two "
          f"profiled searches {prof_s:.3f}s", flush=True)
    return cpu_idx


class _RowsOnCard:
    """The index's f32 rows on the card, read the way ``make_queries`` reads
    ``WikiLike.embeddings`` (its shape; the rows at some ids, copied to the
    host), so no second host copy of the 1M rows is made."""

    def __init__(self, vectors: torch.Tensor):
        self.vectors = vectors

    @property
    def shape(self) -> tuple:
        return tuple(self.vectors.shape)

    def __getitem__(self, ids) -> np.ndarray:
        rows = torch.as_tensor(ids, device=self.vectors.device)
        return self.vectors[rows].cpu().numpy()


def make_wiki(idx, labels: np.ndarray, centers: np.ndarray):
    """The Wiki graph's schema laid over the index's rows as table
    ``Chunk`` (numpy, from ``WIKI_SEED``). Returns the ``WikiLike`` (its
    embeddings read from the card) and the generator's own arrays, from
    which :func:`oracle_mask` computes each plan's selection."""
    rng = np.random.default_rng(WIKI_SEED)
    n = len(labels)
    is_person = labels < PERSON_CLUSTERS
    p_rows = rng.permutation(np.flatnonzero(is_person))
    r_rows = rng.permutation(np.flatnonzero(~is_person))
    p_owner = np.arange(len(p_rows)) // CHUNKS_PER_PERSON
    r_owner = np.arange(len(r_rows)) // CHUNKS_PER_RESOURCE
    n_person, n_resource = int(p_owner[-1]) + 1, int(r_owner[-1]) + 1
    arrays = {"cid": rng.permutation(n),
              "birth": rng.integers(0, BIRTH_DAYS, size=n_person),
              "person_of": np.full(n, -1), "resource_of": np.full(n, -1),
              "wl_src": np.repeat(np.arange(n_person), LINKS_PER_PERSON)}
    arrays["person_of"][p_rows] = p_owner
    arrays["resource_of"][r_rows] = r_owner
    arrays["wl_dst"] = rng.integers(0, n_resource, size=n_person
                                    * LINKS_PER_PERSON)
    store = GraphStore()
    store.add_node_table("Person", n_person, {
        "pID": np.arange(n_person), "birth_date": arrays["birth"]})
    store.add_node_table("Resource", n_resource,
                         {"rID": np.arange(n_resource)})
    store.add_node_table("Chunk", n, {"cID": arrays["cid"],
                                      "is_person": is_person})
    store.add_rel_table("PersonChunk", "Person", "Chunk", p_owner, p_rows)
    store.add_rel_table("ResourceChunk", "Resource", "Chunk", r_owner,
                        r_rows)
    store.add_rel_table("WikiLink", "Person", "Resource", arrays["wl_src"],
                        arrays["wl_dst"])
    wiki = WikiLike(store=store, embeddings=_RowsOnCard(idx.graph.vectors),
                    chunk_is_person=is_person,
                    person_centers=centers[:PERSON_CLUSTERS],
                    resource_centers=centers[PERSON_CLUSTERS:],
                    seed=WIKI_SEED)
    return wiki, arrays


def oracle_mask(kind: str, sigma: float, a: dict) -> np.ndarray:
    """A plan's selected chunks from the generator's arrays, without the
    store's CSR or the plan operators."""
    if kind == "uncorrelated":
        return a["cid"] < int(len(a["cid"]) * sigma)
    persons = np.flatnonzero(a["birth"] < int(BIRTH_DAYS * sigma))
    if kind == "person":
        return np.isin(a["person_of"], persons)
    linked = np.unique(a["wl_dst"][np.isin(a["wl_src"], persons)])
    return np.isin(a["resource_of"], linked)


#: the kernels on the db and postfilter paths (1-4)
GATHER_KERNELS = ("gather_distance_batch", "gather_distance",
                  "quantized_gather_distance_batch",
                  "quantized_gather_distance")


def counted(fn, *args, **kwargs):
    """``fn(...)`` and the launches it made of each kernel of the db path
    (the other kernels' launches must not grow)."""
    before = launch_counts()
    out = fn(*args, **kwargs)
    after = launch_counts()
    check(all(after[k] == before[k] for k in after if k not in
              GATHER_KERNELS), f"{fn.__name__} launched an all-pairs or "
          f"segment-sum kernel")
    return out, {k: after[k] - before[k] for k in GATHER_KERNELS}


def _add(total: dict, launched: dict) -> None:
    for k, v in launched.items():
        total[k] = total.get(k, 0) + v


def _same_rs(a, b, what: str, a_lanes=..., b_lanes=...) -> None:
    """Lanes ``a_lanes`` of result ``a`` equal lanes ``b_lanes`` of ``b``
    (a ResultSet or a SearchResult each): ids, dists and every stat, bit
    for bit."""
    def lanes(res, field, sel):
        x = getattr(res.stats, field) if field in res.stats._fields \
            else getattr(res, field)
        return (x.cpu().numpy() if isinstance(x, torch.Tensor) else x)[sel]
    fields = ("ids", "dists", *a.stats._fields)
    check(all(np.array_equal(lanes(a, f, a_lanes), lanes(b, f, b_lanes))
              for f in fields), f"{what}: results differ")


def _true_ids(idx, Q: np.ndarray, mask: np.ndarray) -> torch.Tensor:
    return torch.cat([idx.brute_force(Q[i:i + 256], k=K, semimask=mask)[1]
                      for i in range(0, len(Q), 256)])


def phase_db(idx, qidx, labels: np.ndarray, centers: np.ndarray,
             Q: np.ndarray, cc: CompileCounter) -> dict:
    """The paper's query through ``NavixDB.execute`` over the Wiki-shaped
    store. Returns each plan's mask and brute-force ids by name, and the
    launches each entry's executes made. The timed traffic after the
    warm-up (the re-execute, and the bucket's batches after its first)
    runs in ``cc``'s phase ``db_steady`` and must make no program entry."""
    t_phase = time.perf_counter()
    wiki, arrays = make_wiki(idx, labels, centers)
    n = len(labels)
    queries = {"uncorrelated": Q,
               "person": make_queries(wiki, N_QUERIES, "person", seed=11),
               "nonperson": make_queries(wiki, N_QUERIES, "nonperson",
                                         seed=12)}
    db = NavixDB(wiki.store)
    db.register_index("gist", idx, table="Chunk")
    db.register_index("gist_int8", qidx, table="Chunk")
    plain = NavixIndex(graph=idx.graph, config=idx.config)   # unregistered
    plans = [(f"uncorrelated {s}", "uncorrelated", s, "uncorrelated",
              uncorrelated_plan(s, n)) for s in DB_SIGMAS]
    plans += [(f"person_chunk {s} {mode}", "person", s, mode,
               person_chunk_plan(wiki.store, s))
              for s in DB_PERSON_SIGMAS for mode in ("person", "nonperson")]
    plans.append((f"two_hop {DB_TWO_HOP_SIGMA}", "two_hop", DB_TWO_HOP_SIGMA,
                  "uncorrelated", two_hop_plan(wiki.store, DB_TWO_HOP_SIGMA)))
    launched = {"gist": {}, "gist_int8": {}}
    out, lines = {}, []
    for name, kind, sigma, mode, sel in plans:
        mask = db.prefilter(sel).mask
        check(np.array_equal(mask, oracle_mask(kind, sigma, arrays)),
              f"[db] {name}: prefilter mask != the generator's oracle")
        knn = KnnSearch(child=sel, k=K, efs=EFS, index="gist")
        Qp = queries[mode]
        t0 = time.perf_counter()
        rs, made = counted(db.execute, knn, query=Qp)
        wall = time.perf_counter() - t0
        _add(launched["gist"], made)
        check(np.array_equal(rs.mask, mask) and rs.ids.shape == (len(Qp), K),
              f"[db] {name}: malformed result")
        _same_rs(rs, plain.search_many(Qp, k=K, efs=EFS, semimask=mask),
                 f"[db] {name}: execute vs unregistered search_many")
        true_ids = _true_ids(idx, Qp, mask)
        rec = idx.recall(rs.ids, true_ids)
        ce = correlation_ratio(idx.graph.vectors, Qp[:CE_QUERIES], mask, k=K,
                               metric=idx.config.metric)
        t = rs.timings
        lines.append(
            f"[db] {name} ({mode} queries): sigma {rs.sigma:.5f}, ce "
            f"{ce:.3f}, QPS {len(Qp) / wall:.1f} ({wall:.3f}s for B="
            f"{len(Qp)}), recall@{K} {rec:.4f}; ms: prefilter "
            f"{t.prefilter_ms:.3f}, pack {t.pack_ms:.3f}, search "
            f"{t.search_ms:.3f}, rerank {t.rerank_ms:.3f}, project "
            f"{t.project_ms:.3f}, total {t.total_ms:.3f}")
        print(lines[-1], flush=True)
        out[name] = {"mask": mask, "true_ids": true_ids, "rs": rs,
                     "queries": Qp, "sel": sel}

    base = out[f"uncorrelated {DB_SIGMAS[1]}"]
    knn = KnnSearch(child=base["sel"], k=K, efs=EFS, index="gist")
    # re-executing a plan adds a hit and no entry, and changes no bit
    info = db.programs.info()
    cc.mark("db_steady")
    t0 = time.perf_counter()
    rs, made = counted(db.execute, knn, query=Q)
    again_s = time.perf_counter() - t0
    cc.mark("steady")
    _add(launched["gist"], made)
    after = db.programs.info()
    check(after["hits"] == info["hits"] + 1
          and after["programs"] == info["programs"],
          f"[db] re-execute made an entry ({info} -> {after})")
    _same_rs(rs, base["rs"], "[db] re-execute vs the first execute")
    # B = 17, 19, 23 share one bucket: one entry, and padding (and the
    # schedule a padded batch launches on) changes no lane
    entries = len(db.programs)
    for j, b in enumerate(BUCKET_BATCHES):
        cc.mark("steady" if j == 0 else "db_steady")   # the first warms it
        rs, made = counted(db.execute, knn, query=Q[:b])
        _add(launched["gist"], made)
        _same_rs(rs, base["rs"], f"[db] B={b} vs B={N_QUERIES}",
                 b_lanes=slice(0, b))
    cc.mark("steady")
    check(cc.count("program", "db_steady") == 0,
          f"[db] the steady traffic made program entries: {cc.kinds}")
    check(len(db.programs) == entries + 1,
          f"[db] B={BUCKET_BATCHES} made {len(db.programs) - entries} "
          f"entries, not 1")
    # the vmap engine (one single-query search a lane) and a single query
    rs, made = counted(db.execute, knn, query=Q[:VMAP_LANES], engine="vmap")
    _add(launched["gist"], made)
    _same_rs(rs, base["rs"], "[db] engine='vmap' vs the batched lanes",
             b_lanes=slice(0, VMAP_LANES))
    rs, made = counted(db.execute, knn, query=Q[0])
    _add(launched["gist"], made)
    _same_rs(rs, base["rs"], "[db] a single query vs lane 0", b_lanes=0)
    # a mixed-plan batch: lane i searches plan i % 4's selection
    mixed = (f"uncorrelated {DB_SIGMAS[1]}",
             f"person_chunk {DB_PERSON_SIGMAS[0]} person",
             f"person_chunk {DB_PERSON_SIGMAS[1]} nonperson",
             f"two_hop {DB_TWO_HOP_SIGMA}")
    lane_plan = [out[mixed[i % 4]] for i in range(N_QUERIES)]
    Qm = np.stack([p["queries"][i] for i, p in enumerate(lane_plan)])
    t0 = time.perf_counter()
    rs_m, made = counted(db.execute, KnnSearch(k=K, efs=EFS, index="gist",
                                               table="Chunk"),
                         query=Qm, masks=[p["mask"] for p in lane_plan])
    mixed_s = time.perf_counter() - t0
    _add(launched["gist"], made)
    for j, name in enumerate(mixed):
        lanes = slice(j, None, 4)
        _same_rs(rs_m, out[name]["rs"], f"[db] masks= lanes of {name}",
                 lanes, lanes)
    # the int8 entry: the beam on the codes, then the host's exact re-rank
    qknn = KnnSearch(child=base["sel"], k=K, efs=EFS, index="gist_int8")
    rs_q, made = counted(db.execute, qknn, query=Q)
    _add(launched["gist_int8"], made)
    unreg_q = dataclasses.replace(qidx, program_cache=None)
    _same_rs(rs_q, unreg_q.search_quantized_many(Q, k=K, efs=EFS,
                                                 semimask=base["mask"]),
             "[db] int8 execute vs search_quantized_many")
    rs_q1, made = counted(db.execute, qknn, query=Q[0])
    _add(launched["gist_int8"], made)
    _same_rs(rs_q1, rs_q, "[db] an int8 single query vs lane 0", b_lanes=0)
    rec_q = idx.recall(rs_q.ids, base["true_ids"])
    f32, int8 = launched["gist"], launched["gist_int8"]
    check(f32["gather_distance_batch"] > 0 and f32["gather_distance"] > 0
          and f32["quantized_gather_distance_batch"] == 0
          and f32["quantized_gather_distance"] == 0,
          f"[db] the f32 entry's launches: {f32}")
    check(int8["quantized_gather_distance_batch"] > 0
          and int8["quantized_gather_distance"] > 0
          and int8["gather_distance_batch"] == 0
          and int8["gather_distance"] == 0,
          f"[db] the int8 entry's launches: {int8}")
    t = rs_q.timings
    print(f"[db] checks: every prefilter mask == the generator's oracle; "
          f"execute == unregistered search_many, bit for bit, on all "
          f"{len(plans)} plans; re-executing uncorrelated {DB_SIGMAS[1]} "
          f"adds a hit and no entry ({again_s:.3f}s, QPS "
          f"{N_QUERIES / again_s:.1f}); B="
          f"{BUCKET_BATCHES} one entry, equal to the B={N_QUERIES} lanes; "
          f"engine='vmap' on {VMAP_LANES} lanes and a single query == the "
          f"batched lanes; a masks= batch of {N_QUERIES} lanes from "
          f"{len(mixed)} plans == each plan's own execute lane for lane "
          f"({mixed_s:.3f}s, pack {rs_m.timings.pack_ms:.1f} ms); int8 entry "
          f"== search_quantized_many (uncorrelated {DB_SIGMAS[1]}: recall@{K}"
          f" {rec_q:.4f}, search {t.search_ms:.1f} ms, rerank "
          f"{t.rerank_ms:.1f} ms) and its single query == lane 0; cache "
          f"{db.programs.info()}", flush=True)
    print(f"[db] launches by entry: f32 {f32}; int8 {int8}; phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    print(f"[guards] [db] program entries: "
          f"{cc.count('program', 'db_steady')} in the steady traffic (the "
          f"re-execute and B={BUCKET_BATCHES[1:]} after B="
          f"{BUCKET_BATCHES[0]} warmed the bucket); cache "
          f"{db.programs.info()}", flush=True)
    launched["plans"] = out
    launched["db"] = db
    return launched


def phase_postfilter(idx, cpu_idx, Q: np.ndarray, plans: dict) -> dict:
    """The Section 5.7 baseline for ``POSTFILTER_QUERIES`` queries at each
    sigma of ``POSTFILTER_SIGMAS``, on the card and on the CPU copy: ids
    and ``PostfilterStats`` equal. Returns its launches."""
    launched, parts = {}, []
    for sigma in POSTFILTER_SIGMAS:
        plan = plans[f"uncorrelated {sigma}"]
        for i in range(POSTFILTER_QUERIES):
            sync()
            t0 = time.perf_counter()
            (d, ids, st), made = counted(idx.search_postfilter, Q[i], k=K,
                                         semimask=plan["mask"])
            sync()
            wall = time.perf_counter() - t0
            _add(launched, made)
            t0 = time.perf_counter()
            d_c, ids_c, st_c = cpu_idx.search_postfilter(
                Q[i], k=K, semimask=plan["mask"])
            cpu_wall = time.perf_counter() - t0
            check(np.array_equal(ids, ids_c) and st == st_c
                  and np.allclose(d, d_c, rtol=1e-5, atol=0.0),
                  f"[postfilter] sigma={sigma} query {i}: card {st} != CPU "
                  f"copy {st_c}")
            check(plan["mask"][ids[ids >= 0]].all(),
                  f"[postfilter] sigma={sigma} query {i}: a survivor not "
                  f"in S")
            rec = idx.recall(ids, plan["true_ids"][i])
            parts.append(f"sigma={sigma} q{i}: restarts {st.restarts}, "
                         f"final_efs {st.final_efs}, verifications "
                         f"{st.verifications}, t_dc {st.t_dc}, wall {wall:.3f}s"
                         f" (CPU copy {cpu_wall:.3f}s), recall@{K} {rec:.4f}")
    check(launched["gather_distance"] > 0
          and all(launched[k] == 0 for k in GATHER_KERNELS
                  if k != "gather_distance"),
          f"[postfilter] launches: {launched}")
    print("[postfilter] == its CPU copy (ids, PostfilterStats): "
          + "; ".join(parts) + f"; one-lane gather_distance launches "
          f"{launched['gather_distance']}", flush=True)
    return launched


def _serve_requests(plans: dict, n_req: int, plan_names, index: str):
    """(query row, plan, k) of ``n_req`` requests: request j takes plan
    ``j % (2 * len(plan_names))`` (each name at both SERVE_SHAPES) and its
    plan's query row ``j // 2``."""
    out = []
    for j in range(n_req):
        p = j % (2 * len(plan_names))
        name = plan_names[p // 2]
        k, efs = SERVE_SHAPES[p % 2]
        sel = None if name is None else plans[name]["sel"]
        rows = plans[name or "uncorrelated 0.1"]["queries"]
        out.append((rows[(j // 2) % len(rows)],
                    KnnSearch(child=sel, k=k, efs=efs, index=index,
                              table=None if sel is not None else "Chunk"),
                    k))
    return out


def _drain(eng: SearchEngine, reqs: list, hooks: list | None = None):
    """Submit ``reqs`` to ``eng``, drain it; (responses by rid, wall s)."""
    if hooks is not None:
        eng.step_hook = lambda info: hooks.append(dict(info))
    rids = [eng.submit(q, plan=plan, k=k) for q, plan, k in reqs]
    sync()
    t0 = time.perf_counter()
    out = eng.drain()
    wall = time.perf_counter() - t0
    by = {r.rid: r for r in out}
    check(len(out) == len(reqs) and sorted(by) == rids,
          f"[serve] {eng.scheduler}: rids not answered exactly once")
    return by, wall


def _same_responses(a: dict, b: dict, what: str) -> None:
    """Per rid: ids and dists bit for bit, sigma equal, both ``ok``."""
    for rid, r in a.items():
        o = b[rid]
        check(np.array_equal(r.ids, o.ids) and np.array_equal(r.dists, o.dists)
              and r.sigma == o.sigma and r.status == o.status == "ok",
              f"[serve] {what}: rid {rid} differs")


def _chunk_split(ch: dict) -> str:
    return (f"chunks {ch['n_chunks']}: host gap {ch['host_gap_ms']:.1f} ms, "
            f"dispatch {ch['dispatch_ms']:.1f} ms, host overlap "
            f"{ch['host_overlap_ms']:.1f} ms, device wait "
            f"{ch['device_wait_ms']:.1f} ms")


def _serve_line(name: str, eng: SearchEngine, wall: float, n: int) -> str:
    lat = eng.latency_summary()
    ch = lat.get("chunks", {})
    chunks = f"; {_chunk_split(ch)}" if ch else ""
    return (f"{name}: {n} requests in {wall:.3f}s, QPS {n / wall:.1f}; "
            f"latency ms p50 {lat['p50_ms']:.1f}, p95 {lat['p95_ms']:.1f}, "
            f"p99 {lat['p99_ms']:.1f}{chunks}")


def _refills(hooks: list) -> tuple[int, int]:
    """(refills after the first admission, those made while other lanes
    were live) from the step hook's progress dicts."""
    total = live = 0
    for prev, h in zip(hooks, hooks[1:]):
        if h["pending"] < prev["pending"]:
            total += 1
            live += prev["live"] > 0
    return total, live


def phase_serve(db, plans: dict, cc: CompileCounter) -> dict:
    """The serving tier over the [db] phase's database: the f32 entry
    through the continuous and the grouped scheduler and the live service,
    the int8 entry through both schedulers. Returns the launches each
    entry's serving made. All of it runs under the in-flight guard
    (``guard_donation``), the service also under the lock-order monitor;
    the stepping-API traffic (both continuous drains and the service) runs
    in ``cc``'s phase ``serve_steady`` and must make no program entry, and
    the grouped drains' entries (their warm-up) must equal the cache's
    misses. The stepping path holds no ``ProgramCache``, so
    ``serve_steady`` reads 0 by construction until a kind that hooks that
    path (a CUDA-graph capture) exists; the grouped drains' check is the
    one here that can fail."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launched, lines = {"gist": {}, "gist_int8": {}}, []
    reqs = _serve_requests(plans, SERVE_REQUESTS, SERVE_PLANS, "gist")
    with guard_donation() as g_don:
        # f32, continuous: ragged beams, refills while other lanes are live
        eng = SearchEngine(db=db, max_batch=SERVE_MAX_BATCH,
                           step_iters=SERVE_STEP_ITERS)
        hooks: list = []
        cc.mark("serve_steady")
        (cont, wall), made = counted(_drain, eng, reqs, hooks)
        cc.mark("steady")
        _add(launched["gist"], made)
        refills, refills_live = _refills(hooks)
        check(refills_live > 0,
              "[serve] no refill while other lanes were live")
        lines.append(_serve_line("f32 continuous", eng, wall, len(reqs))
                     + f"; refills {refills} ({refills_live} while other "
                     f"lanes were live)")
        # f32, grouped: one execute a plan, equal per rid bit for bit
        geng = SearchEngine(db=db, max_batch=SERVE_MAX_BATCH,
                            scheduler="grouped")
        made_before = (cc.count("program"), db.programs.stats.misses)
        (grp, wall), made = counted(_drain, geng, reqs)
        _add(launched["gist"], made)
        _same_responses(cont, grp, "continuous vs grouped (f32)")
        lines.append(_serve_line("f32 grouped", geng, wall, len(reqs)))

        # the live service, built and run under the lock-order monitor:
        # two client threads, SERVICE_EXPIRED requests past their deadline
        # submitted before the loop starts (so the first tick expires them
        # before any admission), the rest while it runs
        cc.mark("serve_steady")
        with instrument_locks() as locks:
            svc = db.serve(index="gist", k_cap=K, efs_cap=EFS,
                           max_batch=SERVICE_MAX_BATCH,
                           step_iters=SERVE_STEP_ITERS,
                           queue_size=2 * SERVICE_REQUESTS)
            futs = {}
            per_client = SERVICE_REQUESTS // SERVICE_CLIENTS
            expired_each = SERVICE_EXPIRED // SERVICE_CLIENTS
            ready = threading.Barrier(SERVICE_CLIENTS + 1)

            def client(c: int) -> None:
                own = range(c * per_client, (c + 1) * per_client)
                for j in own[:expired_each]:
                    q, plan, k = reqs[j]
                    futs[j] = svc.submit(q, plan=plan, k=k, deadline_s=-1.0)
                ready.wait(SERVICE_WAIT_S)
                for j in own[expired_each:]:
                    q, plan, k = reqs[j]
                    futs[j] = svc.submit(q, plan=plan, k=k)

            before = launch_counts()
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVICE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            ready.wait(SERVICE_WAIT_S)
            svc.start()
            for t in threads:
                t.join(SERVICE_WAIT_S)
            check(not any(t.is_alive() for t in threads),
                  "[serve] a client hung")
            got = {j: f.result(timeout=SERVICE_WAIT_S)
                   for j, f in futs.items()}
            wall = time.perf_counter() - t0
            check(svc.shutdown(drain=True, timeout=SERVICE_WAIT_S),
                  "[serve] the service did not shut down")
        cc.mark("steady")
        after = launch_counts()
        check(all(after[k] == before[k] for k in after if k not in
                  GATHER_KERNELS), "[serve] the service launched an "
              "all-pairs or segment-sum kernel")
        _add(launched["gist"],
             {k: after[k] - before[k] for k in GATHER_KERNELS})
        expired = [j for c in range(SERVICE_CLIENTS)
                   for j in range(c * per_client,
                                  c * per_client + expired_each)]
        check(len(got) == SERVICE_REQUESTS
              and len({r.rid for r in got.values()}) == SERVICE_REQUESTS
              and svc.n_done == SERVICE_REQUESTS,
              "[serve] the service did not answer every rid exactly once")
        for j, r in got.items():
            if j in expired:
                check(r.status == "timeout"
                      and (np.asarray(r.ids) == -1).all(),
                      f"[serve] service request {j}: {r.status}, not a "
                      f"timeout")
            else:
                want = cont[j]
                check(r.status == "ok" and np.array_equal(r.ids, want.ids)
                      and np.array_equal(r.dists, want.dists),
                      f"[serve] service request {j} != the continuous "
                      f"engine's")
        g = svc.gauges()
        ch = g["chunks"]
        lines.append(
            f"service (loop thread, {SERVICE_CLIENTS} client threads, "
            f"{SERVICE_MAX_BATCH} lanes): {SERVICE_REQUESTS} requests in "
            f"{wall:.3f}s, {SERVICE_REQUESTS - SERVICE_EXPIRED} ok == the "
            f"continuous engine's bit for bit, {g['timeouts']} timeouts (all "
            f"ids -1); latency ms p50 {g['p50_ms']:.1f}, p99 "
            f"{g['p99_ms']:.1f}; {_chunk_split(ch)}")

        # int8: continuous == grouped (the serving-side exact re-rank)
        qreqs = _serve_requests(plans, SERVE_INT8_REQUESTS, SERVE_PLANS[:2],
                                "gist_int8")
        qeng = SearchEngine(db=db, max_batch=SERVE_MAX_BATCH,
                            step_iters=SERVE_STEP_ITERS)
        cc.mark("serve_steady")
        (qcont, wall), made = counted(_drain, qeng, qreqs)
        cc.mark("steady")
        _add(launched["gist_int8"], made)
        lines.append(_serve_line("int8 continuous", qeng, wall, len(qreqs)))
        qgeng = SearchEngine(db=db, max_batch=SERVE_MAX_BATCH,
                             scheduler="grouped")
        (qgrp, wall), made = counted(_drain, qgeng, qreqs)
        _add(launched["gist_int8"], made)
        _same_responses(qcont, qgrp, "continuous vs grouped (int8)")
        lines.append(_serve_line("int8 grouped", qgeng, wall, len(qreqs)))

    grouped_programs = cc.count("program") - made_before[0]
    grouped_misses = db.programs.stats.misses - made_before[1]
    cycles = locks.cycles()
    check(cc.count("program", "serve_steady") == 0,
          f"[serve] the stepping traffic made program entries: {cc.kinds}")
    check(grouped_programs == grouped_misses,
          f"[serve] {grouped_programs} program events against "
          f"{grouped_misses} cache misses in the grouped drains")
    check(g_don.windows > 0 and not g_don.violations,
          f"[serve] in-flight guard: {g_don.report()}")
    check(not cycles, f"[serve] lock-order cycles: {locks.report()}")
    f32, int8 = launched["gist"], launched["gist_int8"]
    check(f32["gather_distance_batch"] > 0
          and f32["quantized_gather_distance_batch"] == 0
          and int8["quantized_gather_distance_batch"] > 0
          and int8["gather_distance_batch"] == 0
          and all(e[k] == 0 for e in (f32, int8) for k in
                  ("gather_distance", "quantized_gather_distance")),
          f"[serve] launches: f32 {f32}; int8 {int8}")
    for line in lines:
        print(f"[serve] {line}", flush=True)
    print(f"[serve] checks: every rid answered exactly once in all five "
          f"runs; continuous == grouped per rid, bit for bit, f32 "
          f"({SERVE_REQUESTS} requests, {2 * len(SERVE_PLANS)} plans) and "
          f"int8 ({SERVE_INT8_REQUESTS}, 4 plans); launches: f32 {f32}; int8 "
          f"{int8}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; phase "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)
    print(f"[guards] [serve] (all five runs under the in-flight guard, the "
          f"QPS above with it on): in-flight windows {g_don.windows}, "
          f"violations {len(g_don.violations)}; program entries: "
          f"{cc.count('program', 'serve_steady')} in the stepping traffic "
          f"(both continuous drains and the service; 0 by construction, "
          f"that path holds no program cache), {grouped_programs} "
          f"in the grouped drains (== their {grouped_misses} cache misses);"
          f" the service's locks: {locks.report()}", flush=True)
    return launched


class _Clock:
    """A clock the main thread sets: the heartbeat monitor of ``[shard]``
    reads it, so a shard goes stale exactly when the phase says."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _same_oracle(res, oracle, what: str) -> None:
    """A sharded SearchResult == ``per_shard_reference``'s numpy (dists,
    ids, stats), bit for bit."""
    d, ids, stats = oracle
    check(np.array_equal(res.ids.cpu().numpy(), ids)
          and np.array_equal(res.dists.cpu().numpy(), d)
          and all(np.array_equal(getattr(res.stats, f).cpu().numpy(),
                                 getattr(stats, f))
                  for f in res.stats._fields),
          f"[shard] {what}: != per_shard_reference on the card")


def _recall(res_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """recall@k over rows, -1 padding ignored (``NavixIndex.recall``)."""
    hits = denom = 0
    for r, t in zip(res_ids, true_ids):
        tset = set(t[t >= 0].tolist())
        denom += len(tset)
        hits += len(tset & set(r[r >= 0].tolist()))
    return hits / max(denom, 1)


def phase_shard(X: np.ndarray, Q: np.ndarray,
                smi: str) -> tuple[dict, tuple]:
    """The sharded path on one card: a ShardedNavix of SHARD_COUNT shards,
    every grid cell ``cuda:0``, over X (the first SHARD_ROWS rows); its
    one-shot search per lane, shared, under a quorum and on a data = 2
    grid, each held bit for bit against the on-card oracle or the data = 1
    answer; ``NavixDB.execute`` with ``alive``; the continuous scheduler
    against the one-shot search of each request's group; a live service
    whose last shard goes stale mid-drain. Returns the launches of the
    path's calls (the oracles' are not counted) and what ``[ckpt]`` needs:
    the index, the lanes' masks and their per-lane pass."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    launched, lines = {}, []
    n = len(X)
    cfg = PAPER_INDEX._replace(batch_size=BUILD_MORSEL)

    # 1. the grid and the build: one graph a shard, each on cuda:0
    mesh = make_mesh((1, SHARD_COUNT))
    t0 = time.perf_counter()
    sn, made = counted(ShardedNavix.build, X, cfg, mesh)
    sync()
    build_s = time.perf_counter() - t0
    _add(launched, made)
    nl = sn.n_local
    check(sn.n_shards == SHARD_COUNT and sn.n_total == n
          and nl * SHARD_COUNT - n == -n % SHARD_COUNT
          and all(g.device == sn.device and g.n == nl for g in sn.graphs)
          and sn.device.type == "cuda", f"[shard] the grid: {mesh}")
    lines.append(f"{mesh}: build of {n:,} x {X.shape[1]} rows in "
                 f"{SHARD_COUNT} shards of {nl:,} ({SHARD_COUNT * nl - n} "
                 f"padded) {build_s:.1f}s, index "
                 f"{sum(g.nbytes() for g in sn.graphs) / 2**30:.3f} GiB, "
                 f"kernel 1 launches {made['gather_distance_batch']}")

    # 2. per-lane masks cycling SHARD_SIGMAS
    rng = np.random.default_rng(4)
    base = {s: rng.random(n) < s for s in SHARD_SIGMAS}
    lanes = np.stack([base[SHARD_SIGMAS[j % len(SHARD_SIGMAS)]]
                      for j in range(len(Q))])
    params = sn._params(K, EFS, "adaptive_local")

    def timed_search(index, q=Q, **kw):
        sync()
        t0 = time.perf_counter()
        res, made = counted(index.search_many, q, k=K, efs=EFS, **kw)
        sync()
        _add(launched, made)
        return res, time.perf_counter() - t0, made

    res, dt, made = timed_search(sn, semimask=lanes)
    check(tuple(res.ids.shape) == (len(Q), K), "[shard] malformed result")
    # the oracle's per-shard searches, merged here and again under the
    # alive mask of step 4
    searches = shard_searches(sn, Q, lanes, params)
    _same_oracle(res, reference_merge(sn, searches, K), "per-lane masks")
    lines.append(f"per-lane masks (sigma cycle {SHARD_SIGMAS}), B={len(Q)}, "
                 f"k={K}, efs={EFS}: QPS {len(Q) / dt:.1f} ({dt:.3f}s), "
                 f"kernel 1 launches {made['gather_distance_batch']}, == "
                 "per_shard_reference bit for bit (ids, dists, 5 stats)")

    # 3. one shared mask, and its recall against filtered brute force
    shared = base[SHARD_SHARED_SIGMA]
    res_s, dt, _ = timed_search(sn, semimask=shared)
    _same_oracle(res_s, per_shard_reference(
        sn, Q, np.broadcast_to(shared, (len(Q), n)), params), "shared mask")
    Xt = torch.from_numpy(X).to(sn.device)
    Qt = torch.from_numpy(Q).to(sn.device)
    mask_t = torch.from_numpy(shared).to(sn.device)
    true_ids = torch.cat([brute_force_topk(Qt[i:i + 256], Xt, K, "l2",
                                           mask=mask_t)[1]
                          for i in range(0, len(Q), 256)])
    del Xt
    rec = _recall(res_s.ids.cpu().numpy(), true_ids.cpu().numpy())
    lines.append(f"shared mask sigma={SHARD_SHARED_SIGMA}: QPS "
                 f"{len(Q) / dt:.1f} ({dt:.3f}s), recall@{K} {rec:.4f}, == "
                 "per_shard_reference bit for bit")

    # 4. a dead shard under a quorum of 3; a quorum of 4 is not met
    alive = np.array(SHARD_ALIVE)
    dead = int(np.flatnonzero(~alive)[0])
    res_q, dt, _ = timed_search(sn, semimask=lanes, alive=alive,
                                quorum=SHARD_QUORUM)
    _same_oracle(res_q, reference_merge(sn, searches, K, alive),
                 "alive mask")
    ids_q = res_q.ids.cpu().numpy()
    check(not ((ids_q >= dead * nl) & (ids_q < (dead + 1) * nl)).any(),
          "[shard] a dead shard's id surfaced")
    try:
        sn.search_many(Q[:4], k=K, efs=EFS, alive=alive,
                       quorum=SHARD_COUNT)
        check(False, "[shard] a quorum of 4 with a dead shard did not raise")
    except RuntimeError as e:
        check("quorum not met" in str(e), f"[shard] quorum error: {e}")

    # 5. the data axis: the same shard graphs on a (2, 4) grid, over the
    # first SHARD_GRID_LANES lanes (a lane's answer does not depend on the
    # batch it is in, so they equal the (1, 4) grid's first lanes)
    sn2 = ShardedNavix(mesh=make_mesh((2, SHARD_COUNT)), graphs=sn.graphs,
                       n_local=nl, n_total=n, config=cfg)
    g = SHARD_GRID_LANES
    res2, dt2, _ = timed_search(sn2, q=Q[:g], semimask=lanes[:g])
    _same_rs(res, res2, "[shard] the (2, 4) grid vs the (1, 4) grid",
             a_lanes=slice(0, g), b_lanes=slice(0, g))
    lines.append(f"alive {SHARD_ALIVE}, quorum {SHARD_QUORUM}: QPS "
                 f"{len(Q) / dt:.1f}, == per_shard_reference restricted to "
                 f"the alive shards, no id of shard {dead}; quorum "
                 f"{SHARD_COUNT} raises; (2, {SHARD_COUNT}) grid (2 lane "
                 f"blocks of {g // 2}): QPS {g / dt2:.1f}, == the (1, 4) "
                 f"grid's first {g} lanes bit for bit")

    # 6. NavixDB: the sharded entry through execute(alive=...)
    store = GraphStore()
    bucket = rng.integers(0, SHARD_BUCKETS, n)
    store.add_node_table("Chunk", n, {"cID": np.arange(n), "bucket": bucket})
    db = NavixDB(store)
    db.register_index("shards", sn)
    sels = {name: (Filter(NodeScan("Chunk"), "bucket", op, value=v),
                   bucket == v if op == "==" else bucket < v)
            for name, (op, v) in SHARD_SELECTIONS.items()}
    sel, mask = sels["bucket == 1"]
    sync()
    t0 = time.perf_counter()
    rs, made = counted(db.execute, KnnSearch(child=sel, k=K, efs=EFS,
                                             index="shards"),
                       query=Q, alive=alive)
    dt = time.perf_counter() - t0
    _add(launched, made)
    check(np.array_equal(rs.mask, mask), "[shard] execute's prefilter mask")
    want = sn.search_many(Q, semimask=mask, k=K, efs=EFS, alive=alive)
    _same_rs(rs, want, "[shard] execute(alive=...) vs search_many")
    info = db.programs.info()
    check(info["misses"] == 1 and info["hits"] == 1,
          f"[shard] program cache {info}")
    lines.append(f"NavixDB.execute(alive={SHARD_ALIVE}) of bucket == 1 "
                 f"(sigma {rs.sigma:.4f}): QPS {len(Q) / dt:.1f}, search "
                 f"{rs.timings.search_ms:.1f} of {rs.timings.total_ms:.1f} ms,"
                 f" == search_many bit for bit; cache {info}")

    # 7. serving: the continuous scheduler over mixed plans and beams
    reqs = []
    for j in range(SHARD_SERVE_REQUESTS):
        p = j % (2 * len(SHARD_SELECTIONS))
        name = list(SHARD_SELECTIONS)[p // 2]
        k, efs = SERVE_SHAPES[p % 2]
        reqs.append((Q[j % len(Q)], KnnSearch(child=sels[name][0], k=k,
                                              efs=efs, index="shards"), k))
    eng = SearchEngine(db=db, max_batch=SERVE_MAX_BATCH,
                       step_iters=SERVE_STEP_ITERS)
    (cont, wall), made = counted(_drain, eng, reqs)
    _add(launched, made)
    for p in range(2 * len(SHARD_SELECTIONS)):
        name = list(SHARD_SELECTIONS)[p // 2]
        k, efs = SERVE_SHAPES[p % 2]
        group = list(range(p, len(reqs), 2 * len(SHARD_SELECTIONS)))
        one = sn.search_many(np.stack([reqs[j][0] for j in group]),
                             semimask=sels[name][1], k=k, efs=efs)
        ids, d = one.ids.cpu().numpy(), one.dists.cpu().numpy()
        for row, j in enumerate(group):
            r = cont[j]
            check(r.status == "ok" and not r.degraded
                  and np.array_equal(r.ids, ids[row])
                  and np.array_equal(r.dists, d[row]),
                  f"[shard] serving request {j} != the one-shot search of "
                  f"its group")
    lines.append(_serve_line(f"continuous (max_batch {SERVE_MAX_BATCH}, "
                             f"chunks of {SERVE_STEP_ITERS})", eng, wall,
                             len(reqs))
                 + f"; each rid == the one-shot search of its group "
                 f"({2 * len(SHARD_SELECTIONS)} groups) bit for bit")

    # 8. a live service whose last shard's heartbeats stop mid-drain,
    # built and run under the lock-order monitor
    with instrument_locks() as locks:
        clk = _Clock()
        hb = HeartbeatMonitor(SHARD_COUNT, stale_after=1.0, clock=clk)
        svc = db.serve(index="shards", k_cap=K, efs_cap=EFS,
                       max_batch=SHARD_SERVICE_LANES,
                       step_iters=SERVE_STEP_ITERS, heartbeats=hb,
                       queue_size=2 * SHARD_SERVICE_REQUESTS)
        futs = [svc.submit(q, plan=plan, k=k)
                for q, plan, k in reqs[:SHARD_SERVICE_REQUESTS]]
        before = launch_counts()
        t0 = time.perf_counter()
        svc.start()
        deadline = time.perf_counter() + SERVICE_WAIT_S
        while (sum(f.done() for f in futs) < SHARD_SERVICE_LANES // 2
               and time.perf_counter() < deadline):
            time.sleep(0.005)
        n_before = sum(f.done() for f in futs)
        hb.suppress(SHARD_COUNT - 1)
        clk.t = 10.0                    # the last shard's beat is now stale
        hb.beat_all()
        got = [f.result(timeout=SERVICE_WAIT_S) for f in futs]
        wall = time.perf_counter() - t0
        check(svc.shutdown(drain=True, timeout=SERVICE_WAIT_S),
              "[shard] the service did not shut down")
    after = launch_counts()
    check(all(after[k] == before[k] for k in after
              if k not in GATHER_KERNELS),
          "[shard] the service launched an all-pairs or segment-sum kernel")
    _add(launched, {k: after[k] - before[k] for k in GATHER_KERNELS})
    check(len({r.rid for r in got}) == SHARD_SERVICE_REQUESTS
          and svc.n_done == SHARD_SERVICE_REQUESTS,
          "[shard] the service did not answer every rid exactly once")
    lo = (SHARD_COUNT - 1) * nl
    degraded = 0
    for j, r in enumerate(got):
        ids = np.asarray(r.ids)
        check(r.status == "ok", f"[shard] service request {j}: {r.status}")
        if r.degraded:
            degraded += 1
            check(not (ids >= lo).any(),
                  f"[shard] degraded request {j} holds a dead shard's id")
        else:
            check(np.array_equal(ids, cont[j].ids)
                  and np.array_equal(r.dists, cont[j].dists),
                  f"[shard] service request {j} != the continuous engine's")
    check(degraded >= SHARD_SERVICE_REQUESTS - n_before - SHARD_SERVICE_LANES
          and degraded > 0,
          f"[shard] {degraded} degraded responses after the flip at "
          f"{n_before} done")
    g = svc.gauges()
    lines.append(f"service ({SHARD_SERVICE_LANES} lanes, heartbeats, shard "
                 f"{SHARD_COUNT - 1} stale after {n_before} answers): "
                 f"{SHARD_SERVICE_REQUESTS} requests in {wall:.3f}s, "
                 f"{degraded} degraded with no id of the stale shard, the "
                 f"other {SHARD_SERVICE_REQUESTS - degraded} == the "
                 f"continuous engine's bit for bit; latency ms p50 "
                 f"{g['p50_ms']:.1f}, p99 {g['p99_ms']:.1f}")

    check(not locks.cycles(),
          f"[shard] lock-order cycles: {locks.report()}")
    check(launched["gather_distance_batch"] > 0
          and all(launched[k] == 0 for k in
                  ("quantized_gather_distance_batch", "gather_distance",
                   "quantized_gather_distance")),
          f"[shard] launches: {launched}")
    for line in lines:
        print(f"[shard] {line}", flush=True)
    print(f"[shard] launches of the path (the oracles' apart): {launched}; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
          f" GiB; {smi}; phase {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    print(f"[guards] [shard] the stale-heartbeat service's locks: "
          f"{locks.report()}", flush=True)
    return launched, (sn, lanes, res)


def phase_ckpt(sn: ShardedNavix, lanes: np.ndarray, before,
               Q: np.ndarray) -> None:
    """[shard]'s ShardedNavix through the checkpoint store: its shard
    graphs saved as a list (the grid, ``n_local``, ``n_total`` and the
    config in ``extra``) to a temporary directory in this checkout, found
    again with ``latest_complete``, loaded onto the card with its
    checksums verified, and rebuilt; one per-lane pass over the phase's
    lanes then equals ``before``, the pass before the save, bit for bit
    (ids, dists, every stat). The directory is removed."""
    t_phase = time.perf_counter()
    extra = {"grid": [sn.lane_shards, sn.n_shards], "n_local": sn.n_local,
             "n_total": sn.n_total, "config": sn.config._asdict()}
    with tempfile.TemporaryDirectory(prefix="ckpt_", dir=ROOT) as tmp:
        sync()
        t0 = time.perf_counter()
        saved = store.save(tmp, 0, sn.graphs, extra=extra)
        save_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in saved.glob("*.npy"))
        found = store.latest_complete(tmp)
        check(found == saved, f"[ckpt] latest_complete found {found}")
        t0 = time.perf_counter()
        graphs = store.load(found, [g.to("meta") for g in sn.graphs],
                            device=sn.device, verify=True)
        sync()
        load_s = time.perf_counter() - t0
        meta = store.load_manifest(found)
    ex = meta["extra"]
    back = ShardedNavix(mesh=make_mesh(tuple(ex["grid"]), device=sn.device),
                        graphs=graphs, n_local=ex["n_local"],
                        n_total=ex["n_total"],
                        config=NavixConfig(**ex["config"]))
    check(back.n_shards == sn.n_shards and back.config == sn.config
          and all(torch.equal(a, b) for ga, gb in zip(graphs, sn.graphs)
                  for a, b in zip(ga, gb))
          and all(g.device == sn.device for g in graphs),
          "[ckpt] the loaded graphs differ from the saved ones")
    sync()
    t0 = time.perf_counter()
    res, launched = counted(back.search_many, Q, semimask=lanes, k=K,
                            efs=EFS)
    sync()
    pass_s = time.perf_counter() - t0
    _same_rs(res, before, "[ckpt] the reloaded index's per-lane pass vs "
             "the pass before the save")
    check(launched["gather_distance_batch"] > 0
          and all(launched[k] == 0 for k in
                  ("quantized_gather_distance_batch", "gather_distance",
                   "quantized_gather_distance")),
          f"[ckpt] the reloaded pass's launches: {launched}")
    print(f"[ckpt] {sn.n_shards} shard graphs ({len(meta['leaves'])} leaves,"
          f" {nbytes:,} B of .npy): save {save_s:.3f}s "
          f"({nbytes / save_s / 1e6:.1f} MB/s), latest_complete == the saved"
          f" step, load onto {sn.device} with checksums {load_s:.3f}s "
          f"({nbytes / load_s / 1e6:.1f} MB/s); the rebuilt ShardedNavix's "
          f"per-lane pass (B={len(Q)}, k={K}, efs={EFS}, {pass_s:.3f}s) == "
          f"the pass before the save bit for bit (ids, dists, 5 stats), "
          f"gather_distance_batch {launched['gather_distance_batch']} "
          f"launches, the other three 0; directory removed; phase "
          f"{time.perf_counter() - t_phase:.1f}s",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False     # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    smi = phase_device()
    # the host's data (the 1M mixture, [gnn]'s graph) is made on worker
    # threads while the kernels build and the kernel phases run (numpy
    # releases the interpreter lock in its bulk draws, sorts and copies,
    # and those phases wait on nvcc or time on the card), and is waited
    # for before [recsys], the first phase timed on the host's clock. One
    # compile counter spans the run: nvcc runs only in the builds; later
    # phases mark their steady windows
    with ThreadPoolExecutor(2) as host, CompileCounter() as cc:
        gist_data = host.submit(_timed_call, make_data, N)
        gnn_data = host.submit(_timed_call, gnn_graph)
        part_data = host.submit(_timed_call, gnn_part_graph)
        timed("nvcc", phase_build_kernels)
        cc.mark("steady")
        timed("floor", phase_launch_floor)
        kernels = timed("kernel", phase_kernel)
        torch.cuda.empty_cache()
        kernels += timed("kernel_int8", phase_kernel_int8)
        torch.cuda.empty_cache()
        kernels += timed("kernel_matrix", phase_kernel_matrix)
        kernels += timed("kernel_quantized", phase_kernel_quantized)
        kernels.append(timed("kernel_segment", phase_kernel_segment))
        kernels = {k["name"]: k for k in kernels}
        (X, labels, centers, Q), made_s = timed("data", gist_data.result)
        print(f"[data] gaussian_mixture({N:,}, {DIM}, {N_CLUSTERS}, seed=0) "
              f"and {N_QUERIES} queries on the host: {made_s:.1f}s on a "
              f"worker thread, {seconds['data']:.1f}s waited for", flush=True)
        graph = timed("gnn_graph", gnn_data.result)
        # the recsys retrieval path, its counts read just after its requests
        launches, ranked = timed("recsys", phase_recsys)
        kernels["distance_matrix"]["launches"] = launches
        torch.cuda.empty_cache()
        # the recsys ranking path: no kernel of the port, all counts stay 0
        timed("rank", phase_rank, smi, ranked)
        del ranked
        torch.cuda.empty_cache()
        # the LM serving path: no kernel of the port, the counts unmoved
        timed("lm", phase_lm, smi)
        # LM training at full width: no kernel of the port either
        trained = timed("train_lm", phase_train_lm, smi)
        # the MoE family served and trained at full width: none either
        moe_trained = timed("moe", phase_moe, smi)
        # the GNN training path, its counts read just after its steps
        gnn_launches = timed("gnn", phase_gnn, smi, graph)
        kernels["csr_segment_sum"]["launches"] += gnn_launches
        del graph
        torch.cuda.empty_cache()
        # the partitioned GNN path, its counts read in the phase around its
        # training steps
        part_launches = timed("gnn_part", phase_gnn_part, smi,
                              timed("gnn_part_graph", part_data.result))
        kernels["csr_segment_sum"]["launches"] += part_launches
        torch.cuda.empty_cache()

        masks = make_masks(len(X), SELECTIVITIES)
        masks[1.0] = None
        sweep = {s: masks[s] for s in SELECTIVITIES}
        X_shard = X[:SHARD_ROWS].copy()                # [shard]'s rows

        # the dry runs of [train_lm]'s, [moe]'s and three more cells, in
        # subprocesses while the host builds the index
        dry = DryRun()
        atexit.register(dry.stop)
        reset_counts()                                 # f32 path: build
        idx = timed("build", phase_build, X)           # + search
        del X
        build_launches = gather_distance.LAUNCHES
        build_spread = gather_distance.PATH_LAUNCHES["spread"]
        f32 = timed("search", phase_search, idx, Q, sweep)
        counts = launch_counts()
        check(counts["gather_distance_batch"] > build_launches,
              "the search phase launched no gather_distance kernel")
        check(gather_distance.PATH_LAUNCHES["spread"] == build_spread,
              "the f32 sweep launched the spread schedule")
        check(counts["quantized_gather_distance_batch"] == 0,
              "the f32 path launched the int8 kernel")
        kernels["gather_distance_batch"]["launches"] = \
            counts["gather_distance_batch"]
        timed("profile", phase_profile, idx, Q, masks[0.1])

        reset_counts()                                 # int8: quantize
        qidx = timed("quantize", phase_quantize, idx)  # + int8 sweep
        int8 = timed("search_int8", phase_search_int8, qidx, Q, sweep, f32)
        counts = launch_counts()
        check(counts["gather_distance_batch"] == 0
              and counts["gather_distance"] == 0,
              "the int8 path launched an f32 gather kernel")
        int8_paths = dict(quantized_gather_distance.PATH_LAUNCHES)
        check(int8_paths["spread"] == 0,
              "the int8 sweep launched the spread schedule")
        kernels["quantized_gather_distance_batch"]["launches"] = \
            counts["quantized_gather_distance_batch"]

        reset_counts()                                 # single-query oracle
        cpu_idx = timed("parity", phase_parity, idx, qidx, Q, masks, f32,
                        int8)
        counts = launch_counts()
        for name in ("gather_distance", "quantized_gather_distance"):
            kernels[name]["launches"] = counts[name]

        reset_counts()                                 # the database path
        db = timed("db", phase_db, idx, qidx, labels, centers, Q, cc)
        db_read = launch_counts()
        reset_counts()                                 # the postfilter path
        pf = timed("postfilter", phase_postfilter, idx, cpu_idx, Q,
                   db["plans"])
        pf_read = launch_counts()
        reset_counts()                                 # the serving path
        serve = timed("serve", phase_serve, db["db"], db["plans"], cc)
        serve_read = launch_counts()
        reset_counts()                                 # the sharded path
        shard, ckpt_state = timed("shard", phase_shard, X_shard, Q, smi)
        shard_read = launch_counts()
        timed("ckpt", phase_ckpt, *ckpt_state, Q)
        del ckpt_state
        timed("dryrun", dry.collect, trained, moe_trained, smi)
        timed("hillclimb", dry.collect_hillclimb, smi)
        dry.stop()
    late_nvcc = {p: k["nvcc"] for p, k in cc.kinds.items()
                 if p != "warmup" and k.get("nvcc")}
    check(not late_nvcc, f"nvcc ran after the kernel builds: {late_nvcc}")
    print(f"[guards] compile events by phase: {cc.kinds}; nvcc "
          f"{cc.count('nvcc', 'warmup')} in the builds and 0 after; program "
          f"entries {cc.count('program', 'db_steady')} in [db]'s and "
          f"{cc.count('program', 'serve_steady')} in [serve]'s steady "
          f"traffic", flush=True)
    # the executes' launches (the phase also launched to compare)
    db_path = {n: db["gist"][n] + db["gist_int8"][n] for n in GATHER_KERNELS}
    serve_path = {n: serve["gist"][n] + serve["gist_int8"][n]
                  for n in GATHER_KERNELS}
    check(all(db_read[n] >= db_path[n] for n in GATHER_KERNELS)
          and all(pf_read[n] == pf[n] for n in GATHER_KERNELS)
          and all(serve_read[n] == serve_path[n] for n in GATHER_KERNELS)
          and all(shard_read[n] >= shard[n] for n in GATHER_KERNELS),
          f"the counters disagree: db {db_read} vs {db_path}, postfilter "
          f"{pf_read} vs {pf}, serve {serve_read} vs {serve_path}, shard "
          f"{shard_read} vs {shard}")
    print(f"[launches] distance_matrix: "
          f"{kernels['distance_matrix']['launches']} on its streaming path in "
          f"the recsys requests, "
          f"{kernels['distance_matrix_wgmma']['launches']} on its tensor-core "
          f"path through its ops entry; quantized_distance_matrix "
          f"{kernels['quantized_distance_matrix']['launches']} on its "
          f"streaming path and "
          f"{kernels['quantized_distance_matrix_wgmma']['launches']} on its "
          f"tensor-core path, through their ops entries (their whole path); "
          f"csr_segment_sum {kernels['csr_segment_sum']['launches']}: "
          f"{kernels['csr_segment_sum']['launches'] - gnn_launches - part_launches}"
          f" through its ops entry, {gnn_launches} in [gnn]'s training steps "
          f"and {part_launches} in [gnn_part]'s", flush=True)
    print(f"[launches] gather_distance_batch: {build_launches} in the build "
          f"({build_spread} of them spread), "
          f"{kernels['gather_distance_batch']['launches'] - build_launches} "
          f"in the f32 sweep (spread 0); quantized_gather_distance_batch: "
          f"{kernels['quantized_gather_distance_batch']['launches']} in the "
          f"int8 sweep (tiled {int8_paths['tiled']}, spread 0); one-lane "
          f"gather_distance {counts['gather_distance']} and "
          f"quantized_gather_distance {counts['quantized_gather_distance']} "
          f"in the single-query searches of the parity phase "
          f"({len(PARITY_SIGMAS) * PARITY_LANES} an arm and one profiled), "
          f"all spread", flush=True)
    print(f"[launches] the db path (NavixDB.execute, the f32 and the int8 "
          f"entry) and the postfilter path: gather_distance_batch "
          f"{db['gist']['gather_distance_batch']}, gather_distance "
          f"{db['gist']['gather_distance']} + {pf['gather_distance']} "
          f"(postfilter), quantized_gather_distance_batch "
          f"{db['gist_int8']['quantized_gather_distance_batch']}, "
          f"quantized_gather_distance "
          f"{db['gist_int8']['quantized_gather_distance']}; the serving path "
          f"(SearchEngine continuous and grouped, SearchService; f32 and "
          f"int8): gather_distance_batch "
          f"{serve['gist']['gather_distance_batch']}, "
          f"quantized_gather_distance_batch "
          f"{serve['gist_int8']['quantized_gather_distance_batch']}, one-lane "
          f"0 and 0; the sharded path (build, searches, execute, serving; "
          f"the oracles apart): gather_distance_batch "
          f"{shard['gather_distance_batch']}, the others 0; the JSON line's "
          f"launches add them to the paths above", flush=True)
    for name in GATHER_KERNELS:
        kernels[name]["launches"] += (db_path[name] + pf[name]
                                      + serve_path[name] + shard[name])
    for name, entry in kernels.items():
        check(entry.get("launches", 0) > 0,
              f"{name}: launched no time on its path")
    print(f"[done] {time.perf_counter() - t_start:.1f}s; phases (s): "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()),
          flush=True)
    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
