#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FINGER on one NVIDIA GPU.

    python3 chip_smoke.py [--seed S] [--batch B]

Run from the root of a checkout; it imports `repro_torch` from
``src/`` and never JAX or the JAX package. Thirteen phases, each printing
a line of its own; any failure exits non-zero:

1. build   — the hand-written kernels from ``src/repro_torch/csrc/``,
             one ``nvcc`` per source, started together.
2. kernels — each kernel against its plain PyTorch version on the card:
             ``stream_tick`` at the serving size and at a ragged size
             (n_pad not a multiple of 128, odd k, 3 join slots) over
             the edge-case batch of `kernels/stream_tick/parity.py`,
             both ``exact_smax`` values, out of place and in place;
             ``stream_tick_fused_stacked`` at S = 3 × B = 2048 (its
             time is taken on phase 8's inputs); ``delta_stats``
             from the gated delta (and ungated) against
             `delta_stats_gated_ref` in float64 (the kernel sums in
             float64) at k = 1, 7, 128 (keys in registers), 129, 1000
             and 8192 (in shared memory) and 9000 (above the limit: the
             sorted-form route), all-masked, on each case kind of
             `kernels/delta_stats/parity.py` (a hub on every lane,
             repeated ids, ids outside [0, n) with joins and leaves),
             and with leading batch axes (1024 streams; 2 × 37 at
             k = 1000), each launched twice and bit-equal;
             ``sparse_tick`` on the two-tick
             cases of `kernels/sparse_tick/parity.py` (an emptying then
             a reviving tick, allocating and freeing lanes, sentinel and
             out-of-range slots, all-masked rows) at the sparse serving
             size and at a ragged size (n_slots, m_pad not multiples of
             32), both ``exact_smax`` values, out of place and in place,
             and ``sparse_tick_fused_stacked`` at S = 2 × B = 2048 (timed
             on phase 8's inputs); ``vnge_q`` at
             n = 40, 1000 (ragged) and 8192, with and without a node
             mask; ``entropy_probe``'s row stats and graph stats (the
             closed (BH, 4) statistics) at (BH, S) = (192, 128),
             (48, 1000) (ragged) and (192, 1024) on causal
             -1e30-masked logits, each launched twice and bit-equal;
             ``bsr_matvec`` on the cases
             of `kernels/bsr_spmv/parity.py` (ragged n = 300 at b = 128,
             b = 64, max_bpr = 1, a stripe of padding only, strongly
             uneven stripe counts from max_bpr down to 0, n = 32768),
             each launched twice and bit-equal; the stress cases of both
             tick parity modules (``kind="stress"``: a hub looped on
             every lane so that its segment spans all 2k endpoints, a
             star across the lanes, joins and leaves on touched nodes,
             all-masked rows without node slots beside live ones, an
             empty snap and a revive; k = 37, 128, 200 and 1024), both
             ``exact_smax`` values, each with a second launch and an
             in-place launch bit-equal to the first; each kernel on the
             same inputs as its plain version. Phase 2 first runs the parity
             discovery (`kernels/parity.py`) and fails by name if a
             kernel package is missing its ``parity.py`` or is not
             checked here.
3. serve   — the main path: `FingerService.open(ServiceConfig(
             method="fused_tick", placement="local", ingestion="sync",
             exact_smax=True, batch_size=32768, n_pad=1024, k_pad=128,
             j_pad=8), graphs)` over `EdgeList` graphs from ``--seed``
             (per-stream n in 256–1024, about 4n edges), then 20
             ingest → poll ticks of stacked deltas mixing re-weights,
             deletions, additions, joins and leaves, with a (B, m) host
             mirror of edge weights that keeps every w_old exact and a
             burst planted in 4 streams on the last tick. Checks: the
             planted streams are the top 4; 64 sampled scores match the
             batch `jsdist_tilde` of the mirrored G and G' within 5e-3
             (the bound `tests/test_jsdist.py` holds Algorithm 2 to);
             ``stream_tick`` launched once per tick. Then the serving
             lifecycle: `save` the state, `FingerService.restore` it
             twice (``ingestion="sync"`` and ``"double_buffered"``, each
             bit-equal with the saved state) and run the same
             ``LOOP_T`` = 10 ticks through both with no synchronisation
             inside the loop (bit-equal; the median `poll` latency by
             CUDA events, the median host time of `ingest`, the loop's
             wall time and stream-ticks/s of each); two consecutive
             double-buffered ticks under ``torch.profiler`` (the
             side-stream copies, their overlap with the host's ingest
             and poll and with the kernels, the device's busy and idle
             share); `warm_next_layouts([2048])` on the double-buffered
             service, `repad(2048)` with a tick queued on both services
             (warm and cold), a tick, `compact()` reclaiming the grown
             tail, and a tick of generation-0-stamped deltas with the
             burst planted again (the grace remap). Checks: both
             services bit-equal at every step; the warm plan installed;
             the planted streams top 4 and 64 sampled scores within 5e-3
             of batch `jsdist_tilde`; ``stream_tick`` launched once per
             tick plus once for the warm; a last save and restore of the
             migrated state bit-equal. Prints every save, restore,
             warm, swap and compaction time.
4. single  — `jsdist_incremental(method="fused_tick")` on one stream,
             delta by delta as `jsdist_stream` loops, for 20 deltas
             against `jsdist_stream(method="dense")`; ``delta_stats``
             launched twice a delta; prints the median time a delta
             (CUDA events around each call).
5. sparse  — the sparse path: `FingerService.open(ServiceConfig(
             method="sparse_tick", placement="local",
             ingestion="double_buffered",
             exact_smax=True, batch_size=1024, n_pad=2**20,
             n_slots=1024, m_pad=8192, k_pad=128, j_pad=8), graphs)`
             over virtual-space `EdgeList`s made one at a time (256–1024
             active nodes a stream at ids spread over [0, 2²⁰), about 4n
             edges), then 20 ticks of per-stream virtual deltas (the
             phase-3 mix: re-weights, new edges, deletions to 0, joins of
             fresh ids, leaves of isolated nodes; the burst in 4 streams
             on the last tick), with a ``grow_capacity`` while a tick is
             queued (tick 12) and a virtual ``repad`` to 2²¹ (tick 14).
             Checks: ``sparse_tick`` launched once per tick; the planted
             streams are the top 4; 64 sampled scores match the batch
             `jsdist_tilde` of their relabelled mirrored graphs within
             5e-3 after the growth, after the repad and at the end; the
             sampled streams' edge stores equal the mirror's weights at
             their `SlotMap` slots and 0 elsewhere. It ends with a
             `save` and a `restore`: the `SlotMap` JSON equal, the state
             bit-equal, and one more tick bit-equal on both services.
             B is cut from 4096 to 1024 (its host `SlotMap` work scales
             with B) to pay for phase 8.
6. train   — the training path: `repro_torch.launch.train.run` on
             granite-moe-3b-a800m at full width with ``n_layers=8`` (the
             only cut: 32 layers of f32 AdamW state are 53 GB), batch 8 ×
             seq 1024, 10 steps, ``probe_every=2``, lr 3e-3. Prints the
             parameter count, each step's loss and gradient norm, the
             median step time (CUDA events around the step function) and
             tokens/s, the peak of `torch.cuda.max_memory_allocated`, the
             probes' values, the launch counts, the step's split
             (forward alone and the clip + AdamW update alone, timed with
             CUDA events after the run; the rest is the backward), and
             the loss of step 0's batch at init and after training (the
             same tokens; printed, not gated: ROADMAP Queue 3). Checks:
             finite losses and gradient norms; the optimizer's step is
             10; every parameter leaf moved off its init and both
             moments of every leaf off 0; finite probe values with
             ``routing_jsdist`` ≥ 0; ``entropy_probe`` launched once a
             kernel per probe step, ``vnge_q`` three times per routing
             update and no other kernel; a checkpoint of the trained
             embedding, the first expert stack (``w_gate`` of the first
             ``TRAIN_CKPT_LAYERS`` = 2 layers: cut from all 8, whose
             one-thread zlib write took 175–210 s, to pay for phase 8),
             the key/value projections, router and norm weights with
             their moments and step is saved (seconds printed; phase 9
             restores it); a second run from the same seed repeats
             every loss bit for bit.
7. offline — the offline spectral path: a planted partition of n = 2¹⁸
             nodes in 256 contiguous communities (mean degree 16 inside,
             0.05 across) drawn as an edge list from ``--seed``; G' moves
             a contiguous 1 % of the nodes onto one hub community; Ḡ is
             the two halved lists coalesced. For each graph
             `edges_to_bsr` on the card (b = 128), λ_max by
             `power_iteration_lmax_bsr` (the ``bsr_matvec`` kernel), Q,
             `vnge_hat(g, lambda_max=λ)` and `vnge_tilde`; then JSdist
             (Algorithm 1). Checks: each λ within rtol 1e-4 and each Ĥ
             within 1e-4 of the matrix-free `power_iteration_lmax` from
             the same start vector; finite values; H̃ ≤ Ĥ; launches =
             iterations + 2 per graph. Prints the shapes, the BSR build
             seconds, iterations, the median matvec against its bytes
             bound and the power iteration's seconds. Then at n = 4096
             (dense ER, G' through `apply_delta_dense`) `exact_vnge`,
             `vnge_hat`, `jsdist_exact` and `jsdist_fast` on the card and
             on the CPU (entropies within 1e-5, distances as divergences
             within 1e-5), and the paper's Table 3 at
             `benchmarks/table3_dos.py`'s setting (N = 250, X = 10 %, 10
             instances, ``power_iters=50``): the top-2 detection rate,
             card scores within 1e-4 of the CPU's (as divergences where
             JSdiv < 1e-3).
8. fleet   — the multi-tenant fleet: `FingerFleet.open(FleetConfig(pools=
             (small: n_pad 256, 4 shards × 2048 streams; large: n_pad
             1024, 2 × 2048, both ``fused_tick``; virtual: n_pad 2²⁰, 2
             × 512, ``sparse_tick`` with n_slots 1024, m_pad 8192), k_pad
             128, j_pad 8, exact s_max, compact_occupancy 0.5))` on the
             card. It admits 6144, 3072 and 768 tenants (`EdgeList`s from
             ``--seed``: 128–256, 257–1024 nodes, and 256–1024 active ids
             spread over [0, 2²⁰), about 4n edges), each checked to land
             in its best-fit pool; the large pool is filled for a moment
             so that one virtual tenant whose ids lie below 1024 spills
             into the sparse bucket. Then 10 ticks of the phase-3 mix a
             tenant (bursts planted in 4 tenants of the three pools on
             the last), and events each followed by a checked tick: 8
             small tenants join 8 fresh ids each and are promoted live by
             `ensure_capacity`; the spill tenant is promoted into
             ``large``; the tenants of one small shard with a node active
             at or above 127 are evicted and `rebalance()` under a staged
             tick compacts it into a group of its own; `save`, then
             `restore` with ``stacked_ticks=True`` and with ``False``
             (each bit-equal with the saved state) and 3 ticks through
             both; then `kill_shard` of another small shard, a WAL-only
             tick and `recover()` from its checkpoint. Checks: best-fit
             placement; the planted tenants are the top 4; 64 sampled
             tenants (promoted and recovered ones among them) within
             5e-3 of batch `jsdist_tilde` of their mirrored graphs after
             every event; in steady state two ``stream_tick_stacked``
             launches and one ``sparse_tick_stacked`` a tick and no
             single-shard launch (one more after the compaction), one
             launch a live shard shard by shard; the two restores
             bit-equal, scores and every shard's state, at each tick.
             Prints admission seconds per pool, per tick the host
             ingest, poll (host and CUDA events) and scores times and
             the loop's stream-ticks/s stacked and shard by shard, and
             every event's pause.
9. sharded — the sharded placements, on logical shards of the one card
             (``SHARDS`` = 4 on ``cuda:0``; multipod ``PODS`` = 2 × 2).
             Phase 3's first checkpoint (B = 32768, n_pad 1024, k_pad 128,
             j_pad 8, ``fused_tick``, exact s_max) restored three ways,
             local, ``placement="sharded"`` over a 4-shard `DeviceGrid`
             and ``"multipod"`` over 2 × 2, all double-buffered, fed the
             ticks phase 3 fed after that checkpoint: its loop's
             ``PH9_TICKS`` = 10, then `repad(2048)` and its traced pair
             and its repad's tick (``PH9_REPAD_TICKS`` = 3). Checks after every tick:
             scores bit-equal to local; the global top-4 equal in values
             and ids; each pod's top-4 equal to the local top-4 over the
             pod's streams; ``stream_tick`` launched once a tick local and
             4 times a tick sharded and multipod (one a shard); the
             states bit-equal at the end; the sharded service's `save`
             restored as a local service, bit-equal. Prints each
             placement's restore seconds, median `poll` (CUDA events),
             median host ms of ingest to the poll's end (one tick at a
             time) and stream-ticks/s, each shard's ``stream_tick`` time
             in place (CUDA events, a copy of a tick's shard state
             restored before every call), the sharded tick whole, and
             the top-k merge's host and CUDA-event ms. Then phase 5's
             checkpoint (B = 1024) restored ``sharded`` over
             ``SP_SHARDS`` = 2 with ``method="sparse_tick"``, caught up
             with the tick phase 5 ran after its save, and
             ``PH9_SPARSE_TICKS`` = 3 more ticks beside phase 5's
             restored local service: bit-equal (scores, state, every 64th
             `SlotMap`'s JSON), ``sparse_tick`` launched twice a tick on
             the sharded service. Then distributed FINGER on phase 7's G
             (n = 2¹⁸, its coalesced edge list): at world size 1 under
             NCCL in this process, and over ``DIST_RANKS`` = 2 gloo ranks
             on ``cuda:0`` in processes of their own (this script with
             ``--dist-rank``; NCCL refuses two ranks on one card), each
             rank's `shard_edge_list`: q within 1e-5, s_total within
             1e-6 relative and s_max within 1e-4 of the serial
             `finger_state`, λ within 1e-4 relative of phase 7's
             `power_iteration_lmax` from the same start vector, every
             rank equal; prints the seconds per iteration and the share
             of a second run spent in ``all_reduce``. Last, 2 more steps
             of phase 6's training with ``compress_grads=True`` (phase
             6's sound-step check: finite losses and norms, every leaf
             moved, both moments nonzero, the step count; and nonzero
             finite residuals), and `elastic_restore` of phase 6's
             checkpoint onto the card from a CPU template, bit-identical
             with a copy phase 6 took at its save.
10. paper  — the twins of the paper scripts and the examples on the
             card at the reference's settings, each through the entry
             point a user calls, its output printed indented:
             ``benchmarks_torch`` fig1 (N = 600, 3 trials), fig2, fig4
             and table2 (table3 is left out: phase 7 runs its
             criterion), fig1 and table2 again on CPU tensors;
             ``examples_torch`` quickstart, anomaly_detection,
             serve_streams with ``--method fused_tick`` and then
             ``sparse_tick`` (256 streams × 128 nodes, ``SERVE_TICKS`` =
             20 ticks), ``--fleet --ticks 6``, and
             train_with_entropy_probe ``--steps 10`` (the reduced
             granite-moe-3b-a800m; probe steps 0 and 5). Checks: every
             twin prints the reference's row names in order with finite
             numbers; fig1's AE and table2's PCC and SRCC on the card
             within ``PAPER_TOL`` = 2e-4 of the CPU's (the CPU tests'
             tolerance); ``stream_tick`` launched once a tick under
             ``fused_tick`` and ``sparse_tick`` once a tick under
             ``sparse_tick``, no other kernel; the fleet demo ends in
             ``PARITY OK``; ``vnge_q`` and both ``entropy_probe``
             kernels launched by the training example's probe steps.
             Prints fig1's CTRR range, fig2's trends and each fig4 and
             table2 method's seconds a graph pair.
11. models — the model stack through the entry points a user calls, at
             full width: qwen1.5-0.5b (the serve launcher's default
             arch) served by `launch.serve.serve_batch` with the
             reference's bf16 cache at the launcher's defaults (4
             prompts × 16 + 32 new tokens) and at 64 × 128 + 128,
             printing tokens/s and the median ms of a decode step
             (CUDA events, 20 steps); mamba2-130m (batch 8 × 1024),
             whisper-small (4 × 448 tokens + 1500 encoder frames) and
             internvl2-1b (4 × 768 tokens after its 256 frontend
             embeddings) each 3 steps of `launch.train.run` (probes on
             steps 0 and 2) and served at the launcher's defaults;
             jamba-1.5-large-398b the same, reduced (`cfg.reduced()`:
             one full-width MoE layer's experts hold 38.7 GB in f32).
             Checks for each family: decode over an f32 cache equals
             the prefill on 16 tokens within 2e-3 (whisper: against
             `decode_train` on an encoder output of zeros, the zero
             cross-KV's counterpart); a sound step (finite losses and
             gradient norms, every leaf off its init, both moments of
             every leaf off 0); served tokens of the expected shape in
             [0, vocab); ``row_stats`` and ``graph_stats`` launched once
             a probe step by internvl2-1b and jamba, ``vnge_q`` three
             times by jamba's second routing graph, and no kernel by
             serving or by mamba2 and whisper training. Prints each
             family's parameters, losses, step ms, peak memory and
             launches.
12. analysis — the port's analysis gate in this process, after
             `torch.cuda.empty_cache()` (so that the allocator check bears
             load): `repro_torch.analysis.__main__.main(["--json"])`, that
             is the lint over the port, the tick audit (one tick of every
             placement — local, sharded over 4 logical shards, multipod
             over 2 × 2 — for ``fused_tick`` and ``sparse_tick`` at the
             reference's small shapes and at phases 3 and 5's, and the
             migration transforms), ``smem`` (every kernel instantiation's
             launch: registers, spills, shared memory, blocks an SM, the
             guards against the kernels' own checks, each package's parity
             case) and the sentinel chains (dense, sparse, fleet, and the
             dense chain at phase 3's shape, n_pad 1024 → 2048 → 1024).
             Checks: the report's ``ok`` and exit code 0 — no unsuppressed
             lint finding, every target audited clean with one launch a
             shard, no smem violation, every chain at 0 first-use events.
             Prints one line a check with its seconds, the audit's
             targets, the smem table and the chains' phases; the whole
             report goes to ``build/analysis_report.json``.
13. sharding — the model-sharding rules (`single_pod_rules(16)`) on
             `launch.mesh.make_host_mesh()`, a 1×1 ("data", "model")
             mesh over a world-1 NCCL group: granite-moe-3b-a800m at
             full width, cut to phase 6's 8 layers (heads 24 → 32,
             experts 40 → 48, vocabulary 49,155 → 49,280, its 8 KV
             heads unsharded), its parameters DTensors placed by
             `param_shardings`; one train step at batch 4 × 512 with
             FINGER telemetry (the routing graph before and after the
             step: ``vnge_q`` three times; the attention probe over the
             padded heads: ``row_stats`` and ``graph_stats`` once; each
             probe gathers its DTensor once) and the prefill. Gates: the
             same padded model on plain tensors (loss, every parameter
             after the step, the probes, the logits) within 1e-5, saying
             whether bit-equal; the unpadded model on the trained
             weights cut to the real heads and experts (each layer
             weight scaled to 1/sqrt(its fan-in), as the CPU parity
             tests draw them: at the init's 1/sqrt(L) the activations
             grow by orders of magnitude a layer and turn last-bit
             rounding into 1e-3 logit gaps, printed beside) against the
             padded DTensor model on them zero-padded, both routing
             every token to all 40 real experts with a capacity that
             holds every token (the top-8 choice is discrete: the two
             models' matmuls round apart in the last bit and flip
             near-tied choices, so the top-8 gap is printed, not gated;
             the padded capacity divides by 48 experts, the unpadded by
             40): logits within 1e-4 (× the largest logit), the cross
             entropy within 1e-5 relative, the aux loss printed beside
             its ratio 48/40 (the reference's aux multiplies by the
             padded count); 4 decode steps of that model over an f32
             cache laid out by the cache's logical axes against the
             prefill within 1e-4. Then mamba2-130m
             (SSM heads 24 → 32) and whisper-small (heads 12 → 16)
             whole: DTensor against plain within 1e-5, and whisper's
             padded-vs-unpadded equality (mamba2's is printed: its gated
             RMSNorm averages over the padded inner width, in the
             reference too). Then the memory model's cross-check:
             `launch.dryrun.dryrun_cell` of granite's cell (f32
             parameters) on a 1×1 fake mesh in a process of its own;
             its parameter, moment and step bytes must equal exactly
             what the card's allocator was asked for them
             (``requested_bytes`` of `torch.cuda.memory_stats`, from
             fresh segments after `empty_cache`), printed beside
             `torch.cuda.memory_allocated`, which counts whole blocks
             (the step's 4 B take 512, and a cached block is not split
             for a remainder under 1 MB); its peak is printed beside
             the state plus the step's `torch.cuda.max_memory_allocated`
             above it.
             Last, the dry run of all 80 cells (10 architectures × 4
             shapes × 16×16 and 2×16×16), in a process of its own
             (`python -m repro_torch.launch.dryrun --both-meshes --jobs
             8` at nice 10, to ``build/dryrun.jsonl``): every cell OK
             or SKIP, the SKIP set the reference's ``skip_reason`` set;
             one line a cell. It starts when phase 13 does, so that no
             earlier phase's host-bound timings share the host with its
             workers; phase 13's own checks run beside it, and their
             seconds are taken under that load.

Each phase prints its seconds. Every wrapper's launch count is set to 0
just before phases 3 (and again before its lifecycle part), 4, 5, 6,
7, 8, each part of 9, each kernel-reaching example of 10, each
serve and train path of 11, phase 12 and phase 13's DTensor step, and
read just after each path
(phase 12's parity cases are comparisons: `smem` puts the counts back
after them); a kernel's
``launches`` in the kernels line is the sum over those paths. Kernel
times are CUDA-event means of the launch each path makes, at its shapes and inputs: ``stream_tick`` in
place on a copy of a main-path tick's state restored before every call,
``sparse_tick`` in place (and out of place) on a copy of a sparse-path
tick's state and slot-space delta, ``delta_stats`` as the whole
`delta_stats_fused` call of phase 4's first update from its gated
delta, ``stream_tick_stacked`` and ``sparse_tick_stacked`` in place on a
copy of a phase-8 tick's stacked state and delta of the large (S = 2 ×
B = 2048, n_pad = 1024) and the virtual pool's group (S = 2 × B = 512,
n_slots = 1024, m_pad = 8192), restored before every call (beside each,
the group's stack of its shards' states and deltas by CUDA events and
its unstack into views by host time), ``vnge_q`` as the whole
`vnge_q_stats` call on the trained
model's routing graph and the probe
kernels on its probe logits (each also at phase 2's largest shape,
with the whole `attention_graph_stats` call at both shapes and, as the
row stats' ``library_ms``, ``torch.logsumexp(x, -1)``: the same read
and reduction with one output),
``bsr_matvec`` on phase 7's G with, as ``library_ms``, cuSPARSE's BSR
matvec through ``torch.sparse_bsr_tensor(...) @ x`` on the same matrix
without its padding slots (timed only; the port never calls it).
Bounds come from the bytes each launch must move at the H100's 3.35 TB/s
(the arithmetic bound is far below), counting only the state elements
this run's delta changes, and the edge-store slots its gated lanes
write, as written. The ``stream_tick`` fixed cost is also timed with
every edge lane masked and with the first 32 lanes only; beside the
``delta_stats``, ``vnge_q``, ``row_stats`` and ``graph_stats`` rows
(``empty_launch_ms``), one launch of an empty kernel through the same
library's ctypes path, the floor of a one-launch op. The line before
the last is the ``kernels`` JSON object; the last line is the device
JSON object. Scores and state are compared at the tolerances stated in
the parity modules (atol 1e-5, rtol 1e-5; the score as a divergence;
``vnge_q`` rtol 3e-5 and ``entropy_probe`` rtol 5e-4, atol 1e-5).

The kernels' designs are in their sources' header notes. The tick body
(`csrc/tick_kernel.cuh`, shared by ``stream_tick`` and ``sparse_tick``)
runs one stream a warp, eight a block, with warp shuffles and
``__syncwarp`` only: the keys sorted in registers up to k = 128 (in the
warp's shared memory above), the row merged against the sorted segment
heads; the ``stream_tick`` row's printout gives its resident streams per
SM from CUDA's occupancy calculator. ``bsr_matvec`` reads each stripe's
real blocks only (the layout's per-stripe ``counts``) and launches the
stripes longest first; its printout states the bytes it reads, which
must be the real blocks' bytes.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
N_PAD, K_PAD, J_PAD = 1024, 128, 8
TICKS = 20
LOOP_T = 10  # phase 3's ticks under both ingestions after the restore
PRIME_STRIDE = 8209  # a prime above every candidate count 8·n_e ≤ 8160
# the sparse path: B streams in a 2^20-id virtual space, sized by slots
N_VIRTUAL, SP_BATCH, SP_SLOTS, SP_M_PAD = 1 << 20, 4096, 1024, 8192
# phase 5's B, cut from SP_BATCH (phase 2's sparse cases keep it): its
# host SlotMap work scales with B and pays for phase 8's time
SP_PATH_BATCH = 1024
GROW_T, REPAD_T = 12, 14  # ticks of the capacity growth and the repad
# the train path: granite-moe-3b-a800m at full width, cut to 8 layers
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = \
    "granite-moe-3b-a800m", 8, 8, 1024
TRAIN_STEPS, PROBE_EVERY, TRAIN_LR = 10, 2, 3e-3
TRAIN_CKPT_LAYERS = 2  # layers of the expert stack in the checkpoint
VNGE_NS = (40, 1000, 8192)
B_STATS = 1024  # streams of phase 2's batched delta_stats case
PROBE_SHAPES = ((192, 128), (48, 1000), (192, 1024))
# the offline path: FINGER-Ĥ and Algorithm 1 on a 2^18-node planted
# partition (256 contiguous communities, mean in-community degree 16,
# cross-community 0.05) in b = 128 BSR; the burst rewires 1 % of the
# nodes to a hub community
OFF_N, OFF_COMM, OFF_DEG_IN, OFF_DEG_OUT, OFF_B = 1 << 18, 256, 16.0, 0.05, 128
OFF_BURST, OFF_BURST_DEG = 0.01, 16
DENSE_N, DENSE_DEG = 4096, 16.0  # exact H and jsdist_exact, dense ER
# Table 3 at the reference benchmark's setting (benchmarks/table3_dos.py)
DOS_N, DOS_X, DOS_INSTANCES, DOS_ITERS = 250, 0.10, 10, 50
# the fleet path: pools (name, n_pad, shards, streams per shard, method)
# in ascending n_pad, the sparse bucket last with its virtual bound (its
# slot capacities are SP_SLOTS and SP_M_PAD); about 75 % of each admitted
FLEET_POOLS = (("small", 256, 4, 2048, "fused_tick"),
               ("large", N_PAD, 2, 2048, "fused_tick"),
               ("virtual", N_VIRTUAL, 2, 512, "sparse_tick"))
FLEET_TENANTS = (6144, 3072, 768)
FLEET_TICKS, FLEET_RESTORED_TICKS = 10, 3
FLEET_GROWN = 8  # small tenants grown past 256 nodes, promoted live
# phase 9: logical shards on the one card (the sharded and multipod
# placements of phase 3's state, sharded sparse serving), ticks, and the
# gloo ranks of distributed FINGER
SHARDS, PODS, SP_SHARDS, DIST_RANKS = 4, (2, 2), 2, 2
# phase 9 feeds its placements the ticks phase 3 fed after its first
# checkpoint: the loop's LOOP_T, then the traced pair and the repad's
PH9_TICKS, PH9_REPAD_TICKS, PH9_SPARSE_TICKS = LOOP_T, 3, 3
# phase 10: the paper-script and example twins at the reference's
# settings; fig1 and table2 also on the CPU (their AE and PCC/SRCC must
# agree with the card's within the CPU tests' tolerance, PAPER_TOL)
PAPER_TOL = 2e-4
SERVE_TICKS, FLEET_DEMO_TICKS, PROBE_TRAIN_STEPS = 20, 6, 10
# phase 11: the model stack. The serve launcher's defaults (batch, prompt,
# new tokens), qwen1.5-0.5b's large serve, and the trained families
# (arch, batch, tokens); internvl2's 768 tokens follow its 256 frontend
# embeddings, 1024 positions in all (the reference's input_specs: the
# chunked attention needs the chunks to divide the sequence); jamba runs
# reduced (see phase_models)
SERVE_ARCH, SERVE_DEFAULTS, SERVE_BIG = "qwen1.5-0.5b", (4, 16, 32), \
    (64, 128, 128)
MODEL_TRAIN = (("mamba2-130m", 8, 1024), ("whisper-small", 4, 448),
               ("internvl2-1b", 4, 768), ("jamba-1.5-large-398b", 4, 256))
MODEL_STEPS, MODEL_PROBE_EVERY, MODEL_LR = 3, 2, 1e-3
GATE_TOKENS, GATE_TOL = 16, 2e-3  # the reference's decode == prefill
# phase 13: the model-sharding rules at TP 16 on a 1×1 NCCL mesh (the
# card is one rank): granite at phase 6's cut, batch × seq, decode
# steps; then mamba2 and whisper whole (arch, batch, seq); the dry run
# runs DRY_JOBS cells at a time from the start of phase 13
SHARD_TP, SHARD_BATCH, SHARD_SEQ, SHARD_DECODE = 16, 4, 512, 4
SHARD_MODELS = (("mamba2-130m", 2, 256), ("whisper-small", 2, 64))
DRY_JOBS, DRY_TIMEOUT = 8, 450
CHECKED = ("bsr_spmv", "delta_stats", "entropy_probe", "sparse_tick",
           "stream_tick", "vnge_q")
SP_FIELDS = ("q", "s_total", "s_max", "strengths", "node_mask",
             "edge_weights")


def cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean milliseconds of ``fn`` on the card over ``reps`` calls.

    With ``setup``, it runs untimed before every call, and each call is
    timed between its own pair of events.
    """
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if setup is None:
        fn()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    total = 0.0
    for rep in range(reps + 1):
        setup()
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end) if rep else 0.0  # first: warm-up
    return total / reps


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.analysis.sanitize import (launch_counts,
                                               set_launch_counts)

    set_launch_counts(dict.fromkeys(launch_counts(), 0))


def read_counts(out) -> dict:
    """Every wrapper's launch count since `zero_counts`, by kernel row
    name; also added to ``out["launches"]``, the kernels line's counts
    summed over the paths."""
    from repro_torch.analysis.sanitize import launch_counts

    got = launch_counts()
    total = out.setdefault("launches", {})
    for name, n in got.items():
        total[name] = total.get(name, 0) + n
    return got


class Fleet:
    """B host mirrors of edge-weight graphs and their tick deltas.

    Stream b has node ids [0, n_u): the first n_u − 8 start active, ids
    [n_u − 8, n_u − 4) join later (with edges), and ids [n_u − 4, n_u)
    join and leave isolated. Its candidate edges are the pairs
    (i, (i + d) mod n_e), i < n_e = n_u − 4, for 8 distinct offsets
    d < n_e/2 — all distinct, so slot c = d_index·n_e + i names one edge,
    and ``w[b, c]`` mirrors its weight exactly.
    """

    def __init__(self, b: int, seed: int, n_lo: int = 256,
                 n_hi: int = N_PAD):
        import numpy as np

        self.np = np
        self.rng = np.random.default_rng(seed)
        rng = self.rng
        self.b = b
        self.n_u = rng.integers(n_lo, n_hi + 1, b)
        self.n_e = self.n_u - 4
        half = self.n_e // 2 - 1
        bucket = half // 8
        self.offsets = (1 + np.arange(8)[None, :] * bucket[:, None]
                        + rng.integers(0, 1 << 30, (b, 8))
                        % bucket[:, None])
        self.c_count = 8 * self.n_e
        c_max = 8 * n_hi
        self.w = np.zeros((b, c_max), np.float32)
        for s in range(0, b, 4096):
            rows = slice(s, min(s + 4096, b))
            c = np.broadcast_to(np.arange(c_max), (rows.stop - s, c_max))
            lo, hi = self.endpoints(c % self.c_count[rows, None], rows)
            live = (c < self.c_count[rows, None]) \
                & (hi < (self.n_u[rows] - 8)[:, None]) \
                & (rng.random(c.shape) < 0.5)
            self.w[rows] = np.where(live, rng.uniform(0.5, 1.5, c.shape),
                                    0.0)
        self.active = np.arange(N_PAD)[None, :] < (self.n_u - 8)[:, None]
        self.a_joined = np.zeros(b, np.int64)

    def endpoints(self, c, rows=slice(None)):
        """Candidate slots (rows of streams) → (lo, hi) node ids."""
        np = self.np
        n_e = self.n_e[rows, None]
        i = c % n_e
        d = np.take_along_axis(self.offsets[rows], c // n_e, axis=1)
        j = (i + d) % n_e
        return np.minimum(i, j), np.maximum(i, j)

    def graphs(self):
        """The initial graphs as `EdgeList`s over each stream's n_u."""
        from repro_torch.graphs.types import EdgeList

        np = self.np
        out = []
        for b in range(self.b):
            nz = np.flatnonzero(self.w[b])
            lo, hi = self.endpoints(nz[None, :], slice(b, b + 1))
            n = int(self.n_u[b])
            out.append(EdgeList.from_arrays(
                lo[0], hi[0], self.w[b, nz], n_nodes=n,
                node_mask=self.active[b, :n].astype(np.float32)))
        return out

    def graph_at(self, b: int, w_row, active_row, device):
        """One stream's graph from a mirror row, in the n_pad layout."""
        from repro_torch.graphs.types import EdgeList

        np = self.np
        nz = np.flatnonzero(w_row)
        lo, hi = self.endpoints(nz[None, :], slice(b, b + 1))
        g = EdgeList.from_arrays(lo[0], hi[0], w_row[nz], n_nodes=N_PAD,
                                 node_mask=active_row.astype(np.float32))
        return g.to(device)

    def hub_shift(self, r: int):
        """The planted burst of stream r: the edges of its two strongest
        nodes are deleted and its weakest live node gets 1.5× the old
        maximum strength — the strongest node moves, which moves H̃'s
        s_max term the most. Returns (slots, dw, lane mask)."""
        np = self.np
        n_e = int(self.n_e[r])
        c_all = np.arange(8 * n_e)
        lo, hi = self.endpoints(c_all[None, :], slice(r, r + 1))
        lo, hi, w = lo[0], hi[0], self.w[r, :8 * n_e]
        s = np.zeros(N_PAD)
        np.add.at(s, lo, w)
        np.add.at(s, hi, w)
        act = self.active[r]
        tops = np.argsort(-s)[:2]
        live = np.flatnonzero(act[:n_e])
        weak = int(live[np.argmin(s[live])])
        hit = np.isin(lo, tops) | np.isin(hi, tops)
        gone = np.flatnonzero(hit & (w > 0))
        grow = np.flatnonzero(((lo == weak) | (hi == weak)) & ~hit
                              & act[lo] & act[hi])
        slots = np.zeros(K_PAD, np.int64)
        dw = np.zeros(K_PAD, np.float32)
        k = len(gone) + len(grow)
        slots[:k] = np.r_[gone, grow]
        dw[:k] = np.r_[-w[gone], 1.5 * s[tops[0]] / len(grow) - w[grow]]
        return slots, dw, np.arange(K_PAD) < k

    def tick_arrays(self, burst_rows=(), quiet_rows=(), gated_only=False):
        """One tick's (B, K_PAD) lanes and (B, J_PAD) node slots in local
        ids, as numpy arrays (lo, hi, dw, w_old, lane mask, node ids,
        node flags); the mirror follows the tick. ``quiet_rows`` send an
        empty delta; with ``gated_only`` a lane is sent only where both
        endpoints are active after the tick's joins (the others change
        nothing, and a producer would not send them)."""
        np, rng, b = self.np, self.rng, self.b
        ar = np.arange(b)
        quiet = np.isin(ar, list(quiet_rows))
        nid = np.zeros((b, J_PAD), np.int32)
        nflag = np.zeros((b, J_PAD), np.float32)
        join_a = (rng.random(b) < 0.1) & (self.a_joined < 4) & ~quiet
        va = self.n_u - 8 + self.a_joined
        nid[join_a, 0] = va[join_a]
        nflag[join_a, 0] = 1.0
        self.active[ar[join_a], va[join_a]] = True
        self.a_joined += join_a
        toggle = (rng.random(b) < 0.2) & ~quiet
        vb = self.n_u - 4 + rng.integers(0, 4, b)
        was = self.active[ar, vb]
        nid[toggle, 1] = vb[toggle]
        nflag[toggle, 1] = np.where(was[toggle], -1.0, 1.0)

        lane = np.arange(K_PAD)[None, :]
        c = (rng.integers(0, 1 << 30, b)[:, None] % self.c_count[:, None]
             + lane * PRIME_STRIDE) % self.c_count[:, None]
        lo, hi = self.endpoints(c)
        w_cur = np.take_along_axis(self.w, c, axis=1)
        u = rng.random((b, K_PAD))
        new = rng.uniform(0.5, 1.5, (b, K_PAD)).astype(np.float32)
        # present edges: 20% deleted, the rest re-weighted by ±20%;
        # absent ones: 20% added
        dw = np.where(w_cur > 0,
                      np.where(u < 0.2, -w_cur, w_cur * 0.4 * (new - 1.0)),
                      np.where(u < 0.2, new, 0.0)).astype(np.float32)
        emask = (lane < rng.integers(K_PAD // 2, K_PAD + 1, b)[:, None]) \
            & ~quiet[:, None]
        for r in burst_rows:
            c[r], dw[r], emask[r] = self.hub_shift(r)
            lo[r], hi[r] = self.endpoints(c[r:r + 1], slice(r, r + 1))
            w_cur[r] = self.w[r, c[r]]
        lo, hi = np.where(emask, lo, 0), np.where(emask, hi, 0)
        dw = np.where(emask, dw, 0.0).astype(np.float32)
        w_old = np.where(emask, w_cur, 0.0).astype(np.float32)
        gate = emask & self.active[ar[:, None], lo] \
            & self.active[ar[:, None], hi]
        if gated_only:
            emask = gate
            lo, hi = np.where(emask, lo, 0), np.where(emask, hi, 0)
            dw = np.where(emask, dw, 0.0).astype(np.float32)
            w_old = np.where(emask, w_old, 0.0).astype(np.float32)
        rows, lanes = np.nonzero(gate)
        self.w[rows, c[rows, lanes]] = (w_cur + dw)[rows, lanes]
        self.active[ar[toggle], vb[toggle]] = ~was[toggle]
        return lo, hi, dw, w_old, emask, nid, nflag

    def tick(self, burst_rows=()):
        """One tick's stacked (B, K_PAD) delta; the mirror follows it."""
        from repro_torch.graphs.types import GraphDelta

        lo, hi, dw, w_old, emask, nid, nflag = self.tick_arrays(burst_rows)
        t = host_tensor
        return GraphDelta(
            senders=t(lo, "int32"), receivers=t(hi, "int32"),
            dw=t(dw, "float32"), w_old=t(w_old, "float32"),
            mask=t(emask, "float32"), n_nodes=N_PAD,
            node_ids=t(nid, "int32"), node_flag=t(nflag, "float32"))


def host_tensor(x, dtype: str):
    """A contiguous CPU tensor of ``dtype`` from a numpy array."""
    import numpy as np
    import torch

    return torch.from_numpy(np.ascontiguousarray(x).astype(dtype))


class SparseFleet(Fleet):
    """The dense `Fleet`'s streams spread over a 2²⁰-id virtual space.

    Local id i of stream b is the virtual id ``vid[b, i]``: N_PAD
    distinct ids drawn at random from [0, N_VIRTUAL) for each stream,
    in random order. The mirror, the candidate edges and the tick lanes
    stay in local ids, a relabelling of the virtual graph;
    `virtual_deltas` maps each tick to the per-stream virtual deltas a
    producer sends. Lanes that would add an edge of weight 0 are masked,
    as a producer would not send them.
    """

    def __init__(self, b: int, seed: int):
        super().__init__(b, seed)
        self.vid = self.np.stack([
            self.rng.choice(N_VIRTUAL, N_PAD, replace=False)
            for _ in range(b)]).astype(self.np.int64)

    def graphs(self, seconds):
        """The initial graphs, one at a time, as virtual-space `EdgeList`s
        (n_nodes = N_VIRTUAL with an (N_VIRTUAL,) node mask); the time
        spent making them is added to ``seconds[0]``."""
        import torch

        from repro_torch.graphs.types import EdgeList

        np = self.np
        for b in range(self.b):
            t0 = time.perf_counter()
            nz = np.flatnonzero(self.w[b])
            lo, hi = self.endpoints(nz[None, :], slice(b, b + 1))
            v = self.vid[b]
            mask = np.zeros(N_VIRTUAL, np.float32)
            mask[v[np.flatnonzero(self.active[b])]] = 1.0
            g = EdgeList.from_arrays(v[lo[0]], v[hi[0]], self.w[b, nz],
                                     n_nodes=N_VIRTUAL,
                                     node_mask=torch.from_numpy(mask))
            seconds[0] += time.perf_counter() - t0
            yield g

    def virtual_deltas(self, n_virtual: int, burst_rows=()):
        """One tick as B per-stream virtual `GraphDelta`s addressed in
        an n_virtual space; the mirror follows the tick."""
        from repro_torch.graphs.types import GraphDelta

        np = self.np
        lo, hi, dw, w_old, emask, nid, nflag = self.tick_arrays(burst_rows)
        emask = emask & ~((dw == 0) & (w_old == 0))
        take = np.take_along_axis
        snd = np.where(emask, take(self.vid, lo, axis=1), 0)
        rcv = np.where(emask, take(self.vid, hi, axis=1), 0)
        nid = np.where(nflag != 0, take(self.vid, nid, axis=1), 0)
        t = host_tensor
        f = dict(senders=t(snd, "int32"), receivers=t(rcv, "int32"),
                 dw=t(np.where(emask, dw, 0.0), "float32"),
                 w_old=t(np.where(emask, w_old, 0.0), "float32"),
                 mask=t(emask, "float32"), node_ids=t(nid, "int32"),
                 node_flag=t(nflag, "float32"))
        return [GraphDelta(n_nodes=n_virtual,
                           **{k: v[b] for k, v in f.items()})
                for b in range(self.b)]

    def store_matches(self, b: int, slot_map, store) -> bool:
        """Whether stream b's (m_pad,) edge store holds exactly the
        mirror's live edge weights at their `SlotMap` slots and 0 in
        every other slot, and the map holds no other edge."""
        np = self.np
        n_e = int(self.n_e[b])
        c = np.arange(8 * n_e)
        lo, hi = self.endpoints(c[None, :], slice(b, b + 1))
        v = self.vid[b]
        a, z = v[lo[0]], v[hi[0]]
        live = self.w[b, c] > 0
        keys = zip(np.minimum(a, z)[live].tolist(),
                   np.maximum(a, z)[live].tolist())
        slots = [slot_map.edge_slot.get(key, -1) for key in keys]
        if len(slot_map.edge_slot) != len(slots) or -1 in slots:
            return False
        want = np.zeros_like(store)
        want[slots] = self.w[b, c[live]]
        return bool(np.array_equal(store, want))


def phase_kernels(args, torch, out, dev):
    """Phase 2: each kernel against its plain version on the card."""
    from repro_torch.core.sparse import stack_sparse_states
    from repro_torch.kernels.parity import discover_parity_modules
    from repro_torch.engine.stream import stack_deltas, stack_states
    from repro_torch.kernels.sparse_tick import ops as sp_ops
    from repro_torch.kernels.sparse_tick import parity as sp_parity
    from repro_torch.kernels.stream_tick import ops as st_ops
    from repro_torch.kernels.stream_tick import parity as st_parity
    from repro_torch.kernels.stream_tick.ref import stream_tick_ref

    found = sorted(discover_parity_modules())
    if found != sorted(CHECKED):
        raise AssertionError(
            f"kernel packages {found} but phase 2 checks {sorted(CHECKED)}: "
            f"not held against a plain version: "
            f"{sorted(set(found) - set(CHECKED))}")
    errs = {"stream_tick": 0.0, "stream_tick_stacked": 0.0,
            "delta_stats": 0.0, "sparse_tick": 0.0,
            "sparse_tick_stacked": 0.0}
    for shape in ((args.batch, N_PAD, K_PAD, J_PAD), (1000, 333, 37, 3)):
        states, deltas = st_parity.make_case(*shape, seed=args.seed,
                                             device=dev)
        for exact in (False, True):
            want = stream_tick_ref(states, deltas, exact_smax=exact)
            for inplace in (False, True):
                work = states.map_tensors(torch.clone) if inplace else states
                got = st_ops.stream_tick_fused(work, deltas, exact_smax=exact,
                                               inplace=inplace)
                err = st_parity.compare(got, want, f"stream_tick {shape}")
                errs["stream_tick"] = max(errs["stream_tick"], err)
                print(f"  stream_tick B,n,k,j={shape} exact_smax={exact} "
                      f"inplace={inplace}: max_abs_err={err:.3e}")
                del work, got
        del states, deltas, want
    for label, shape in st_parity.STRESS.items():
        states, deltas = st_parity.make_case(*shape, seed=args.seed,
                                             device=dev, kind="stress")
        for exact in (False, True):
            got = st_ops.stream_tick_fused(states, deltas, exact_smax=exact)
            err = st_parity.compare(got, stream_tick_ref(
                states, deltas, exact_smax=exact), f"stream_tick {label}")
            errs["stream_tick"] = max(errs["stream_tick"], err)
            again = st_ops.stream_tick_fused(states, deltas,
                                             exact_smax=exact)
            inplace = st_ops.stream_tick_fused(
                states.map_tensors(torch.clone), deltas, exact_smax=exact,
                inplace=True)
            check_bits(torch, f"stream_tick {label}", got, again, inplace)
            print(f"  stream_tick stress {label} B,n,k,j={shape} "
                  f"exact_smax={exact}: max_abs_err={err:.3e}; a second "
                  "launch and in place bit-equal")
        del states, deltas, got, again, inplace
    cases = [st_parity.make_case(2048, N_PAD, K_PAD, J_PAD,
                                 seed=args.seed + s, device=dev)
             for s in range(3)]
    states = stack_states([c[0] for c in cases])
    deltas = stack_deltas([c[1] for c in cases])
    got = st_ops.stream_tick_fused_stacked(states, deltas, exact_smax=True)
    want = stream_tick_ref(states, deltas, exact_smax=True)
    err = st_parity.compare(got, want, "stream_tick_stacked")
    errs["stream_tick_stacked"] = err
    print(f"  stream_tick_fused_stacked S=3 B=2048: max_abs_err={err:.3e}")
    del cases, states, deltas, got, want
    phase_kernels_delta_stats(args, torch, errs, dev)

    def sparse(inplace, stacked=False):
        fn = sp_ops.sparse_tick_fused_stacked if stacked \
            else sp_ops.sparse_tick_fused
        return lambda s, d, e: fn(s, d, exact_smax=e, inplace=inplace)

    # two ticks per case: row 0 empties on the first and revives on the
    # second, each tick compared before the next
    for shape in ((SP_BATCH, SP_SLOTS, SP_M_PAD, K_PAD, J_PAD),
                  (1000, 333, 777, 37, 3)):
        states, d1, d2 = sp_parity.make_case(*shape, seed=args.seed,
                                             device=dev)
        for exact in (False, True):
            for inplace in (False, True):
                case = (states.map_tensors(torch.clone), d1, d2)
                err = sp_parity.check(sparse(inplace), case, exact,
                                      f"sparse_tick {shape}")
                errs["sparse_tick"] = max(errs["sparse_tick"], err)
                print(f"  sparse_tick B,n_slots,m_pad,k,j={shape} "
                      f"exact_smax={exact} inplace={inplace}, 2 ticks: "
                      f"max_abs_err={err:.3e}")
                del case
        del states, d1, d2
    for label, shape in sp_parity.STRESS.items():
        states, d1, d2 = sp_parity.make_case(*shape, seed=args.seed,
                                             device=dev, kind="stress")
        for exact in (False, True):
            err = sp_parity.check(sparse(False), (states, d1, d2), exact,
                                  f"sparse_tick {label}")
            errs["sparse_tick"] = max(errs["sparse_tick"], err)
            got = sp_ops.sparse_tick_fused(states, d1, exact_smax=exact)
            again = sp_ops.sparse_tick_fused(states, d1, exact_smax=exact)
            inplace = sp_ops.sparse_tick_fused(
                states.map_tensors(torch.clone), d1, exact_smax=exact,
                inplace=True)
            check_bits(torch, f"sparse_tick {label}", got, again, inplace)
            print(f"  sparse_tick stress {label} B,n_slots,m_pad,k,j="
                  f"{shape} exact_smax={exact}, 2 ticks: max_abs_err="
                  f"{err:.3e}; a second launch and in place bit-equal")
        del states, d1, d2, got, again, inplace
    cases = [sp_parity.make_case(SP_BATCH // 2, SP_SLOTS, SP_M_PAD, K_PAD,
                                 J_PAD, seed=args.seed + s, device=dev)
             for s in range(2)]
    states = stack_sparse_states([c[0] for c in cases])
    d1, d2 = (stack_deltas([c[i] for c in cases]) for i in (1, 2))
    for inplace in (False, True):
        case = (states.map_tensors(torch.clone), d1, d2)
        err = sp_parity.check(sparse(inplace, stacked=True), case, True,
                              "sparse_tick_stacked")
        errs["sparse_tick_stacked"] = max(errs["sparse_tick_stacked"], err)
        print(f"  sparse_tick_fused_stacked S=2 B={SP_BATCH // 2} "
              f"inplace={inplace}, 2 ticks: max_abs_err={err:.3e}")
    del cases, states, d1, d2
    out["errs"] = errs
    phase_kernels_train(args, errs, dev)
    phase_kernels_bsr(args, torch, errs, dev)


def phase_kernels_delta_stats(args, torch, errs, dev):
    """Phase 2, ``delta_stats``: the one launch from the gated delta
    against its plain version in float64 (`parity.plain`) at k in
    registers (≤ 128), in shared memory (to the 8192 limit) and above
    it (the sorted-form route), each case kind gated and not, with
    leading batch axes, and a second launch bit-equal."""
    from repro_torch.core.incremental import gate_delta_for_update
    from repro_torch.kernels.delta_stats import ops as ds_ops
    from repro_torch.kernels.delta_stats import parity as ds_parity

    def check(label, strengths, delta):
        got = ds_ops.delta_stats_cuda(strengths, delta)
        err = ds_parity.compare(got, ds_parity.plain(strengths, delta),
                                f"delta_stats {label}")
        if not torch.equal(got, ds_ops.delta_stats_cuda(strengths, delta)):
            raise AssertionError(f"delta_stats {label}: a second launch "
                                 "gave other bits")
        errs["delta_stats"] = max(errs["delta_stats"], err)
        return err

    for k, masked, kind in ((1, False, "mixed"), (7, False, "mixed"),
                            (K_PAD, False, "mixed"), (K_PAD, True, "mixed"),
                            (K_PAD, False, "hub"), (K_PAD, False, "repeat"),
                            (K_PAD, False, "gating"), (K_PAD + 1, False,
                                                       "hub"),
                            (1000, False, "mixed"), (1000, False, "gating"),
                            (ds_ops.max_fused_k(), False, "hub"),
                            (ds_ops.max_fused_k() + 808, False, "mixed")):
        state, delta = ds_parity.make_case(N_PAD * 4, k, seed=k, device=dev,
                                           all_masked=masked, kind=kind)
        gated, _ = gate_delta_for_update(state.node_mask, delta)
        e1 = check(f"{kind} k={k}", state.strengths, gated)
        e2 = check(f"{kind} k={k} ungated", state.strengths, delta)
        route = "sorted form" if k > ds_ops.max_fused_k() else "one launch"
        print(f"  delta_stats {kind} k={k} all_masked={masked} ({route}): "
              f"max_abs_err={e1:.3e} gated, {e2:.3e} ungated; a second "
              "launch bit-equal")
    for lead, k in (((B_STATS,), K_PAD), ((2, 37), 1000)):
        strengths, delta = ds_parity.stack_case(N_PAD, k, lead,
                                                seed=args.seed, device=dev)
        err = check(f"lead={lead} k={k}", strengths, delta)
        print(f"  delta_stats leading axes {lead} k={k}: "
              f"max_abs_err={err:.3e}")


def check_bits(torch, label, got, *others) -> None:
    """Raise unless each of ``others`` (dist, state) equals ``got`` bit
    for bit."""
    want = [got[0], *got[1].tensors().values()]
    for other in others:
        if not all(torch.equal(a, b) for a, b in zip(
                want, [other[0], *other[1].tensors().values()])):
            raise AssertionError(f"{label}: launches on the same inputs "
                                 "gave other bits")


def phase_kernels_train(args, errs, dev):
    """Phase 2, the train path's kernels: ``vnge_q`` and the two
    ``entropy_probe`` kernels against their plain versions."""
    import torch

    from repro_torch.kernels.entropy_probe import ops as ep_ops
    from repro_torch.kernels.entropy_probe import parity as ep_parity
    from repro_torch.kernels.entropy_probe import ref as ep_ref
    from repro_torch.kernels.vnge_q import ops as vq_ops
    from repro_torch.kernels.vnge_q import parity as vq_parity
    from repro_torch.kernels.vnge_q.ref import vnge_q_stats_ref

    errs.update(vnge_q=0.0, row_stats=0.0, graph_stats=0.0)
    for n in VNGE_NS:
        for masked in (False, True):
            w, mask = vq_parity.make_case(n, seed=args.seed + n,
                                          device=dev, masked=masked)
            got = vq_ops.vnge_q_stats(w, node_mask=mask)
            want = vnge_q_stats_ref(vq_ops._apply_node_mask(w, mask))
            err = vq_parity.compare(got, want, f"vnge_q n={n}")
            errs["vnge_q"] = max(errs["vnge_q"], err)
            print(f"  vnge_q n={n} node_mask={masked}: max_abs_err={err:.3e}")
    for bh, s in PROBE_SHAPES:
        x = ep_parity.make_case(bh, s, seed=args.seed + s, device=dev)
        rows = ep_ops.row_stats_cuda(x)
        again = ep_ops.row_stats_cuda(x)
        e1 = ep_parity.compare(rows, ep_ref.row_stats_ref(x),
                               f"row_stats {(bh, s)}")
        graph = ep_ops.graph_stats_cuda(x, *rows)
        graph_again = ep_ops.graph_stats_cuda(x, *rows)
        e2 = ep_parity.compare([graph], [ep_ref.graph_stats_ref(x, *rows)],
                               f"graph_stats {(bh, s)}")
        e3 = ep_parity.compare([ep_ops.attention_graph_stats(x)],
                               [ep_ref.attention_graph_stats_ref(x)],
                               f"attention_graph_stats {(bh, s)}")
        if not (all(map(torch.equal, rows, again))
                and torch.equal(graph, graph_again)):
            raise AssertionError(f"entropy_probe {(bh, s)}: launches on "
                                 "the same inputs gave other bits")
        errs["row_stats"] = max(errs["row_stats"], e1)
        errs["graph_stats"] = max(errs["graph_stats"], e2)
        print(f"  entropy_probe BH,S={(bh, s)} causal: row_stats "
              f"max_abs_err={e1:.3e}, graph_stats (closed) {e2:.3e}, each "
              f"launched twice bit-equal; the whole op vs the oracle "
              f"{e3:.3e}")
        del x, rows, again


def phase_kernels_bsr(args, torch, errs, dev):
    """Phase 2, the offline path's kernel: ``bsr_matvec`` against its
    plain version on `kernels/bsr_spmv/parity.py`'s cases, and a second
    launch that repeats the first bit for bit."""
    from repro_torch.kernels.bsr_spmv import ops as bs_ops
    from repro_torch.kernels.bsr_spmv import parity as bs_parity
    from repro_torch.kernels.bsr_spmv.ref import bsr_matvec_ref

    errs["bsr_matvec"] = 0.0
    for label, (n, b, kind) in bs_parity.CASES.items():
        m, x = bs_parity.make_case(n, b, seed=args.seed + n, device=dev,
                                   kind=kind)
        got = bs_ops.bsr_matvec_cuda(m.values, m.col_ids, m.counts, x)
        err = bs_parity.compare(got, bsr_matvec_ref(m, x), label)
        again = bs_ops.bsr_matvec_cuda(m.values, m.col_ids, m.counts, x)
        if not torch.equal(got, again):
            raise AssertionError(f"bsr_matvec {label}: a second launch "
                                 "gave other bits")
        errs["bsr_matvec"] = max(errs["bsr_matvec"], err)
        print(f"  bsr_matvec {label} (n_rb, max_bpr)="
              f"{tuple(m.col_ids.shape)}, stripe counts "
              f"{int(m.counts.min())}..{int(m.counts.max())}: "
              f"max_abs_err={err:.3e}, a second launch bit-equal")
        del m, x, got, again


def sampled_worst(fleet, sampled, before, scores, dev) -> float:
    """Largest |score − batch jsdist_tilde| over the sampled streams,
    on the mirror's graphs before and after the tick."""
    from repro_torch.core.jsdist import jsdist_tilde

    worst = 0.0
    for r, b in enumerate(sampled):
        g0 = fleet.graph_at(b, before[0][r], before[1][r], dev)
        g1 = fleet.graph_at(b, fleet.w[b], fleet.active[b], dev)
        # one sampled stream's check, outside the timed ticks
        worst = max(worst, abs(float(jsdist_tilde(g0, g1))  # lint: disable=per-item-host-sync
                               - float(scores[b])))
    return worst


def phase_serve(args, torch, out, dev):
    """Phase 3: the main path through FingerService."""
    import numpy as np

    from repro_torch.serving import FingerService, ServiceConfig, TopKSpec

    if args.batch != 32768:
        print(f"  cut: batch_size {args.batch} instead of 32768")
    t0 = time.perf_counter()
    fleet = Fleet(args.batch, args.seed)
    graphs = fleet.graphs()
    t1 = time.perf_counter()
    cfg = ServiceConfig(batch_size=args.batch, n_pad=N_PAD, k_pad=K_PAD,
                        j_pad=J_PAD, method="fused_tick", exact_smax=True,
                        placement="local", ingestion="sync",
                        topk=TopKSpec(k=4))
    svc = FingerService.open(cfg, graphs, device=dev)
    torch.cuda.synchronize()
    sample = graphs[:256]
    edges = sum(int(g.mask.sum()) for g in sample) / len(sample)
    print(f"  opened B={args.batch} n_pad={N_PAD} k_pad={K_PAD} "
          f"j_pad={J_PAD}: graphs {t1 - t0:.1f} s, open "
          f"{time.perf_counter() - t1:.1f} s, mean edges/stream "
          f"{edges:.0f}, mean n {fleet.n_u.mean():.0f}")
    del graphs
    rng = np.random.default_rng(args.seed + 1)
    planted = sorted(rng.choice(args.batch, 4, replace=False).tolist())
    sampled = sorted(set(rng.choice(args.batch, 60, replace=False).tolist())
                     | set(planted))
    tick_ms, wall_ms = [], []
    snap = None
    zero_counts()
    for t in range(TICKS):
        last = t == TICKS - 1
        if last:
            before = (fleet.w[sampled].copy(), fleet.active[sampled].copy())
        deltas = fleet.tick(burst_rows=planted if last else ())
        if t == TICKS // 2:
            snap = (svc.states().map_tensors(torch.clone),
                    deltas.to(dev))
        h0 = time.perf_counter()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        svc.ingest(deltas)
        ev0.record()
        svc.poll()
        ev1.record()
        ev1.synchronize()
        wall_ms.append((time.perf_counter() - h0) * 1e3)
        tick_ms.append(ev0.elapsed_time(ev1))
    launches = read_counts(out)["stream_tick"]
    scores = svc.scores()
    if not np.isfinite(scores).all() or scores.shape != (args.batch,):
        raise AssertionError("main path: non-finite or misshapen scores")
    if launches != TICKS:
        raise AssertionError(f"stream_tick launched {launches} times in "
                             f"{TICKS} ticks")
    vals, ids = svc.top_anomalies(4)
    if sorted(ids.tolist()) != planted:
        raise AssertionError(f"top-4 {ids.tolist()} != planted {planted}")
    worst = sampled_worst(fleet, sampled, before, scores, dev)
    if worst > 5e-3:
        raise AssertionError(f"incremental vs batch jsdist_tilde differs "
                             f"by {worst:.3e} > 5e-3")
    med = float(np.median(tick_ms))
    print(f"  {TICKS} ticks: median tick {med:.3f} ms (CUDA events "
          f"around poll, host-to-device copy included), median host "
          f"ingest+poll {np.median(wall_ms):.3f} ms, "
          f"{args.batch / med * 1e3:.4g} stream-ticks/s; stream_tick "
          f"launches {launches}")
    print(f"  top-4 {ids.tolist()} == planted {planted}, scores "
          f"{np.round(vals, 4).tolist()}; {len(sampled)} sampled scores "
          f"vs batch jsdist_tilde: max |diff| {worst:.3e} (bound 5e-3)")
    out["snap"] = snap
    phase_serve_lifecycle(args, torch, out, dev, svc, fleet, planted,
                          sampled)


def state_bits(torch, svc, scores: bool = False) -> dict:
    """The service's state, gathered from its shards (and its latest
    scores), on the host."""
    torch.cuda.synchronize()
    bits = {k: v.numpy() for k, v in
            svc.plan.gather(svc.states()).tensors().items()}
    if scores:
        bits["scores"] = svc.scores()
    return bits


def check_same(label, got, *others) -> None:
    """Raise unless every dict of arrays in ``others`` equals ``got``
    bit for bit."""
    import numpy as np

    for other in others:
        for k, v in got.items():
            if not np.array_equal(v, other[k], equal_nan=True):
                raise AssertionError(f"{label}: {k} differs")


def ingest_poll_loop(torch, svc, ticks):
    """ingest → poll over ``ticks`` with no synchronisation inside the
    loop: the host time of each ingest, CUDA events around each poll,
    the loop's wall time to a final synchronize, and that time from
    the start of tick ``max_queue + 1`` on (the double-buffered ring's
    pinned slots are all allocated by then)."""
    ingest_ms, marks, starts = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for d in ticks:
        h = time.perf_counter()
        starts.append(h)
        svc.ingest(d)
        ingest_ms.append((time.perf_counter() - h) * 1e3)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        svc.poll()
        ev1.record()
        marks.append((ev0, ev1))
    torch.cuda.synchronize()
    end = time.perf_counter()
    steady_s = end - starts[svc.config.max_queue + 1]
    return (ingest_ms, [a.elapsed_time(b) for a, b in marks], end - t0,
            steady_s)


def phase_serve_lifecycle(args, torch, out, dev, svc, fleet, planted,
                          sampled):
    """Phase 3, after its checked ticks: the serving lifecycle on the
    32768-stream state. Save it; restore it twice, under sync and
    double-buffered ingestion, and run the same LOOP_T ticks through
    both (bit-equal; the ingest + poll loop's numbers); two traced
    double-buffered ticks; then on the double-buffered service warm the
    2 n_pad layout, repad to it with a tick queued, tick, compact the
    grown tail away and tick with a generation-0-stamped delta (the
    grace remap; the sync service, which repads cold, follows every
    step and stays bit-equal); the sampled scores against batch
    jsdist_tilde and the planted top-4 at the end; a last save and
    restore, bit-equal with the live state."""
    import shutil

    import numpy as np

    from repro_torch.serving import FingerService

    root = Path(__file__).resolve().parent / "build" / "serve_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    live = state_bits(torch, svc)
    t0 = time.perf_counter()
    svc.save(str(root / "a"))
    save_s = time.perf_counter() - t0
    cfg = svc.config
    svc.close()
    svcs, restore_s = {}, {}
    for mode in ("sync", "double_buffered"):
        t0 = time.perf_counter()
        svcs[mode] = FingerService.restore(cfg.with_(ingestion=mode),
                                           directory=str(root / "a"),
                                           device=dev)
        torch.cuda.synchronize()
        restore_s[mode] = time.perf_counter() - t0
        check_same(f"{mode} restore", live,
                   state_bits(torch, svcs[mode]))
    sy, db = svcs["sync"], svcs["double_buffered"]
    nbytes = sum(v.nbytes for k, v in live.items() if k != "scores")
    print(f"  checkpoint of the {args.batch}-stream state "
          f"({nbytes / 1e6:.1f} MB): save {save_s:.2f} s, restore "
          f"{restore_s['sync']:.2f} s (sync) and "
          f"{restore_s['double_buffered']:.2f} s (double_buffered), "
          "both bit-equal with the saved state")
    zero_counts()
    ticks = [fleet.tick() for _ in range(LOOP_T)]
    loop = {mode: ingest_poll_loop(torch, s, ticks)
            for mode, s in svcs.items()}
    tick_bytes = sum(t.numel() * t.element_size()
                     for t in ticks[0].tensors().values())
    check_same("sync vs double_buffered after the loop",
               state_bits(torch, sy, True), state_bits(torch, db, True))
    steady = LOOP_T - cfg.max_queue - 1
    for mode, (ingest_ms, poll_ms, loop_s, steady_s) in loop.items():
        print(f"  {LOOP_T} ticks, ingestion={mode}: median poll "
              f"{np.median(poll_ms):.3f} ms (CUDA events), median ingest "
              f"{np.median(ingest_ms):.3f} ms (host), loop "
              f"{loop_s * 1e3:.1f} ms, {args.batch * LOOP_T / loop_s:.4g} "
              f"stream-ticks/s over the loop; its last {steady} ticks "
              f"{steady_s * 1e3:.1f} ms, "
              f"{args.batch * steady / steady_s:.4g} stream-ticks/s "
              f"({tick_bytes / 1e6:.1f} MB a tick; ingest ms a tick: "
              + " ".join(f"{x:.1f}" for x in ingest_ms) + ")")
    print(f"  scores and states bit-equal under both ingestions; loop "
          f"speed-up double_buffered/sync "
          f"{loop['sync'][2] / loop['double_buffered'][2]:.3f}x, over the "
          f"last {steady} ticks "
          f"{loop['sync'][3] / loop['double_buffered'][3]:.3f}x")
    pair = [fleet.tick(), fleet.tick()]
    for d in pair:
        sy.ingest(d)
        sy.poll()
    traced_ticks(torch, db, pair)
    check_same("after the traced ticks", state_bits(torch, sy, True),
               state_bits(torch, db, True))

    t0 = time.perf_counter()
    warmed = db.warm_next_layouts([2 * N_PAD])
    warm_ms = (time.perf_counter() - t0) * 1e3
    warm_plans = {id(p) for p, _ in db.plan_cache._plans.values()}
    if warmed != [2 * N_PAD] or not warm_plans:
        raise AssertionError(f"warm_next_layouts warmed {warmed}")
    d1 = fleet.tick()
    swap = {}
    for mode, s in svcs.items():
        s.ingest(d1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.repad(2 * N_PAD)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s.poll()
        torch.cuda.synchronize()
        swap[mode] = ((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3)
    # phase 9 restores checkpoint "a" and feeds it the ticks that
    # followed it here: the loop's, the traced pair and the repad's
    out["serve_a"] = (root / "a", ticks + pair + [d1], cfg)
    del ticks, pair, d1
    if id(db.plan) not in warm_plans or id(sy.plan) in warm_plans:
        raise AssertionError("repad did not install the warmed plan on "
                             "the double-buffered service only")
    d2 = dataclasses.replace(fleet.tick(), n_nodes=2 * N_PAD)
    for s in svcs.values():
        s.ingest(d2)
        s.poll()
    del d2
    compact_ms, reports = {}, {}
    for mode, s in svcs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports[mode] = s.compact()
        torch.cuda.synchronize()
        compact_ms[mode] = (time.perf_counter() - t0) * 1e3
    rep = reports["double_buffered"]
    if rep.reclaimed < N_PAD or db.layout.generation != 2 \
            or not np.array_equal(rep.index_map,
                                  reports["sync"].index_map):
        raise AssertionError(f"compact reclaimed {rep.reclaimed} slots to "
                             f"generation {db.layout.generation}")
    before = (fleet.w[sampled].copy(), fleet.active[sampled].copy())
    d3 = dataclasses.replace(fleet.tick(burst_rows=planted),
                             layout_generation=0)
    for s in svcs.values():
        s.ingest(d3)
        s.poll()
    del d3
    launches = read_counts(out)["stream_tick"]
    want = 2 * (LOOP_T + 2 + 3) + 1
    if launches != want:
        raise AssertionError(f"stream_tick launched {launches} times in the "
                             f"lifecycle's {want - 1} ticks and one warm")
    live = state_bits(torch, db, True)
    check_same("sync vs double_buffered after the migrations",
               live, state_bits(torch, sy, True))
    scores = live["scores"]
    vals, ids = db.top_anomalies(4)
    worst = sampled_worst(fleet, sampled, before, scores, dev)
    if sorted(ids.tolist()) != planted or worst > 5e-3 \
            or not np.isfinite(scores).all():
        raise AssertionError(f"after the migrations: top-4 {ids.tolist()} "
                             f"(planted {planted}), sampled scores differ "
                             f"from batch jsdist_tilde by {worst:.3e}")
    t0 = time.perf_counter()
    db.save(str(root / "b"))
    save2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = FingerService.restore(db.config, directory=str(root / "b"),
                                 device=dev)
    torch.cuda.synchronize()
    restore2_s = time.perf_counter() - t0
    got = state_bits(torch, back)
    live.pop("scores")
    check_same("the last restore", live, got)
    if back.layout != db.layout or back.step != db.step:
        raise AssertionError(f"restored layout {back.layout} step "
                             f"{back.step} != {db.layout} {db.step}")
    print(f"  migrations: warm_next_layouts([{2 * N_PAD}]) {warm_ms:.1f} ms; "
          f"repad {N_PAD}->{2 * N_PAD} with a tick queued, then its poll: "
          f"cold (sync service) {swap['sync'][0]:.1f} ms + poll = "
          f"{swap['sync'][1]:.1f} ms, warm (double_buffered) "
          f"{swap['double_buffered'][0]:.1f} ms + poll = "
          f"{swap['double_buffered'][1]:.1f} ms; compact() reclaimed "
          f"{rep.reclaimed} slots to n_pad={rep.new_n_pad} in "
          f"{compact_ms['double_buffered']:.1f} ms "
          f"({compact_ms['sync']:.1f} ms on the sync service); a "
          "generation-0-stamped tick remapped at ingest")
    print(f"  after the chain: top-4 {ids.tolist()} == planted {planted}, "
          f"{len(sampled)} sampled scores vs batch jsdist_tilde max |diff| "
          f"{worst:.3e} (bound 5e-3); both services bit-equal; "
          f"stream_tick launches {launches} ({want - 1} ticks + 1 warm)")
    print(f"  last checkpoint at generation {db.layout.generation}: save "
          f"{save2_s:.2f} s, restore {restore2_s:.2f} s, bit-equal with "
          "the live state")
    for s in (sy, db, back):
        s.close()
    shutil.rmtree(root / "b", ignore_errors=True)


def traced_ticks(torch, svc, deltas):
    """Consecutive double-buffered ingest → poll ticks under
    `torch.profiler`: the side-stream copies' time, how much of it
    overlaps the host's work (the span of the ingest and poll calls) and
    the kernels, and the device's busy and idle share over the span to
    the final synchronize."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function("chip_smoke_ticks"):
            with record_function("chip_smoke_host"):
                for d in deltas:
                    svc.ingest(d)
                    svc.poll()
            torch.cuda.synchronize()
    path = Path(__file__).resolve().parent / "build" / "tick_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]

    def span_of(name):
        hit = [e for e in events if e.get("name") == name
               and e.get("ph") == "X"]
        return (float(hit[0]["ts"]),
                float(hit[0]["ts"]) + float(hit[0]["dur"])) if hit else None

    span, host = span_of("chip_smoke_ticks"), span_of("chip_smoke_host")
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["cat"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    if not span or not host or not dev:
        print("  traced ticks: the trace holds no device events; idle "
              "share not measured")
        return
    t0, t1 = span

    def union(intervals):
        out = []
        for a, b in sorted(intervals):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def overlap(xs, ys):
        """Microseconds of the intervals xs that lie inside union(ys)."""
        ys = union(ys)
        return sum(max(0.0, min(b, d) - max(a, c))
                   for a, b in xs for c, d in ys)

    within = [(max(a, t0), min(b, t1)) for a, b, _, _ in dev]
    busy = overlap([(t0, t1)], within)
    kernels = [(a, b) for a, b, cat, _ in dev if cat == "kernel"]
    copies = [(a, b) for a, b, cat, _ in dev if cat == "gpu_memcpy"]
    copy_us = sum(b - a for a, b in copies)
    by_cat = {}
    for a, b, cat, name in dev:
        key = "stream_tick kernel" if "stream_tick" in name else cat
        by_cat[key] = by_cat.get(key, 0.0) + (b - a) / 1e3
    parts = ", ".join(f"{k} {v:.3f} ms" for k, v in sorted(by_cat.items()))
    share = overlap(copies, [host]) / copy_us if copy_us else 0.0
    print(f"  traced {len(deltas)} double-buffered ticks (profiler on): "
          f"span {(t1 - t0) / 1e3:.3f} ms, host ingest+poll "
          f"{(host[1] - host[0]) / 1e3:.3f} ms; device busy "
          f"{busy / 1e3:.3f} ms ({parts}); idle share "
          f"{1 - busy / (t1 - t0):.4f} with copies counted as busy, "
          f"{1 - overlap([(t0, t1)], kernels) / (t1 - t0):.4f} counting "
          "kernels only")
    print(f"  side-stream copies {len(copies)}, {copy_us / 1e3:.3f} ms: "
          f"{overlap(copies, [host]) / 1e3:.3f} ms ({share:.1%}) inside "
          f"the host's ingest+poll span, "
          f"{overlap(copies, kernels) / 1e3:.3f} ms overlapping kernels")


def phase_single(args, torch, out, dev):
    """Phase 4: the single-stream path through the delta_stats kernel,
    `jsdist_incremental` delta by delta (the loop of `jsdist_stream`),
    each call timed with CUDA events."""
    import numpy as np

    from repro_torch.core.jsdist import jsdist_incremental, jsdist_stream
    from repro_torch.core.state import finger_state
    from repro_torch.engine.stream import stack_deltas

    fleet = Fleet(1, args.seed + 2, n_lo=N_PAD, n_hi=N_PAD)
    g = fleet.graph_at(0, fleet.w[0], fleet.active[0], dev)
    state = finger_state(g)
    deltas = stack_deltas([fleet.tick().map_tensors(lambda x: x[0])
                           for _ in range(20)]).to(dev)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(20)]
    torch.cuda.synchronize()
    zero_counts()
    got_state, dists = state, []
    for t, (e0, e1) in enumerate(events):
        e0.record()
        dist, got_state = jsdist_incremental(
            got_state, deltas.map_tensors(lambda x: x[t]), exact_smax=True,
            method="fused_tick")
        e1.record()
        dists.append(dist)
    torch.cuda.synchronize()
    launches = read_counts(out)["delta_stats"]
    got = torch.stack(dists)
    per_delta = sorted(e0.elapsed_time(e1) for e0, e1 in events)
    want, want_state = jsdist_stream(state, deltas, exact_smax=True,
                                     method="dense")
    div_err = float((got.double() ** 2 - want.double() ** 2).abs().max())
    np.testing.assert_allclose((got.double() ** 2).cpu().numpy(),
                               (want.double() ** 2).cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    for f in ("q", "s_total", "s_max", "strengths"):
        # one pull a state field: the fields are separate tensors
        np.testing.assert_allclose(getattr(got_state, f).cpu().numpy(),  # lint: disable=per-item-host-sync
                                   getattr(want_state, f).cpu().numpy(),  # lint: disable=per-item-host-sync
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    if launches != 40:
        raise AssertionError(f"delta_stats launched {launches} times for "
                             "20 deltas (2 updates each)")
    median = (per_delta[9] + per_delta[10]) / 2
    print(f"  20 deltas, n_pad={N_PAD}, k_pad={K_PAD}: divergence max "
          f"|diff| vs dense {div_err:.3e}; delta_stats launches {launches}; "
          f"jsdist_incremental(method=\"fused_tick\") median "
          f"{median:.4f} ms a delta (min {per_delta[0]:.4f}, max "
          f"{per_delta[-1]:.4f}; CUDA events)")
    out["single_ms"] = median
    out["single"] = (state, deltas.map_tensors(lambda x: x[0]))


def phase_sparse(args, torch, out, dev):
    """Phase 5: the sparse path through FingerService (sparse_tick)."""
    import numpy as np

    from repro_torch.core.jsdist import jsdist_tilde
    from repro_torch.serving import FingerService, ServiceConfig, TopKSpec

    t0 = time.perf_counter()
    print(f"  cut: batch_size {SP_PATH_BATCH} instead of {SP_BATCH}")
    fleet = SparseFleet(SP_PATH_BATCH, args.seed + 3)
    t1 = time.perf_counter()
    cfg = ServiceConfig(method="sparse_tick", placement="local",
                        ingestion="double_buffered", exact_smax=True,
                        batch_size=SP_PATH_BATCH, n_pad=N_VIRTUAL,
                        n_slots=SP_SLOTS, m_pad=SP_M_PAD, k_pad=K_PAD,
                        j_pad=J_PAD, topk=TopKSpec(k=4))
    graph_s = [0.0]
    svc = FingerService.open(cfg, fleet.graphs(graph_s), device=dev)
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t1
    n_active = float(svc.states().node_mask.sum(-1).mean())
    edges = np.mean([len(m.edge_slot) for m in svc.slot_maps])
    print(f"  opened B={SP_PATH_BATCH} n_pad={N_VIRTUAL} n_slots={SP_SLOTS} "
          f"m_pad={SP_M_PAD} k_pad={K_PAD} j_pad={J_PAD}: mirrors "
          f"{t1 - t0:.1f} s; open {t_open:.1f} s = graphs "
          f"{graph_s[0]:.1f} s + build {t_open - graph_s[0]:.1f} s; mean "
          f"active nodes {n_active:.0f}, mean edges {edges:.0f}")
    rng = np.random.default_rng(args.seed + 4)
    planted = sorted(rng.choice(SP_PATH_BATCH, 4, replace=False).tolist())
    sampled = sorted(set(rng.choice(SP_PATH_BATCH, 60,
                                    replace=False).tolist())
                     | set(planted))

    def worst_score_diff(before):
        """Largest |score − batch jsdist_tilde| over the sampled streams,
        on relabelled graphs in the local N_PAD layout."""
        scores = svc.scores()
        worst = 0.0
        for r, b in enumerate(sampled):
            g0 = fleet.graph_at(b, before[0][r], before[1][r], dev)
            g1 = fleet.graph_at(b, fleet.w[b], fleet.active[b], dev)
            # one sampled stream's check, outside the timed ticks
            worst = max(worst, abs(float(jsdist_tilde(g0, g1))  # lint: disable=per-item-host-sync
                                   - float(scores[b])))
        if not np.isfinite(scores).all() or worst > 5e-3:
            raise AssertionError(f"sparse path: sampled scores differ "
                                 f"from batch jsdist_tilde by {worst:.3e}")
        return worst

    captured, marks = {}, []

    def capture(plan_tick):
        def tick(states, deltas):
            captured["snap"] = (states.map_tensors(torch.clone), deltas)
            return plan_tick(states, deltas)
        return tick

    def mark(plan_tick):
        """Record when the plan's tick starts: after the ingestor's
        hand-over of the delta (the current stream's wait on its
        side-stream copy), before the kernel's launch."""
        def tick(states, deltas):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((ev, time.perf_counter()))
            return plan_tick(states, deltas)
        return tick

    n_virtual, worst = N_VIRTUAL, {}
    tick_ms, ingest_ms, poll_ms, split = [], [], [], []
    gc_s, where, gc_t0 = {"poll": 0.0, "ingest": 0.0, "": 0.0}, [""], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_s[where[0]] += time.perf_counter() - gc_t0[0]

    gc.callbacks.append(on_gc)
    zero_counts()
    for t in range(TICKS):
        last = t == TICKS - 1
        before = (fleet.w[sampled].copy(), fleet.active[sampled].copy())
        if t == REPAD_T:
            svc.repad(2 * N_VIRTUAL)
            n_virtual = 2 * N_VIRTUAL
        deltas = fleet.virtual_deltas(n_virtual, planted if last else ())
        h0 = time.perf_counter()
        where[0] = "ingest"
        svc.ingest(deltas)
        where[0] = ""
        ingest_ms.append((time.perf_counter() - h0) * 1e3)
        if t == GROW_T:  # grow with this tick queued
            svc.grow_capacity(n_slots=SP_SLOTS + 64, m_pad=SP_M_PAD + 512)
        svc.plan.tick = mark(svc.plan.tick)
        if t == TICKS // 2:
            svc.plan.tick = capture(svc.plan.tick)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        p0 = time.perf_counter()
        where[0] = "poll"
        ev0.record()
        svc.poll()
        ev1.record()
        ev1.synchronize()
        where[0] = ""
        tick_ms.append(ev0.elapsed_time(ev1))
        del svc.plan.tick
        ev_m, host_m = marks[-1]
        split.append((ev0.elapsed_time(ev_m), ev_m.elapsed_time(ev1),
                      (host_m - p0) * 1e3))
        poll_ms.append((time.perf_counter() - p0) * 1e3)
        if t in (GROW_T, REPAD_T, TICKS - 1):
            worst[t] = worst_score_diff(before)
    launches = read_counts(out)["sparse_tick"]
    gc.callbacks.remove(on_gc)
    if launches != TICKS:
        raise AssertionError(f"sparse_tick launched {launches} times in "
                             f"{TICKS} ticks")
    vals, ids = svc.top_anomalies(4)
    if sorted(ids.tolist()) != planted:
        raise AssertionError(f"sparse top-4 {ids.tolist()} != planted "
                             f"{planted}")
    store = svc.states().edge_weights[sampled].cpu().numpy()
    bad = [b for r, b in enumerate(sampled)
           if not fleet.store_matches(b, svc.slot_maps[b], store[r])]
    if bad:
        raise AssertionError(f"sparse edge stores differ from the mirror "
                             f"in streams {bad[:8]}")
    med = float(np.median(tick_ms))
    print(f"  {TICKS} ticks (grow_capacity to n_slots={svc.capacity.n_slots}"
          f" m_pad={svc.capacity.m_pad} queued at tick {GROW_T}, repad to "
          f"n_pad={svc.config.n_pad} at tick {REPAD_T}; double-buffered): "
          f"median tick {med:.3f} ms (CUDA events around poll), median "
          f"host ingest (SlotMap translation, stacking, the pinned copy "
          f"and the side-stream copy's start) {np.median(ingest_ms):.1f} ms, "
          f"{SP_PATH_BATCH / med * 1e3:.4g} stream-ticks/s; sparse_tick "
          f"launches {launches}")
    print(f"  tick latency min {min(tick_ms):.3f} / max {max(tick_ms):.3f} "
          f"ms; median host time of poll {np.median(poll_ms):.3f} ms; "
          f"ingest min {min(ingest_ms):.1f} / max {max(ingest_ms):.1f} ms")
    med_split = np.median(np.array(split), axis=0)
    print(f"  poll split at the plan's tick (medians): ingestor hand-over "
          f"{med_split[0]:.3f} ms (host {med_split[2]:.3f} ms), launch and "
          f"kernel {med_split[1]:.3f} ms; every tick's latency: "
          + " ".join(f"{x:.2f}" for x in tick_ms))
    print(f"  top-4 {ids.tolist()} == planted {planted}, scores "
          f"{np.round(vals, 4).tolist()}; {len(sampled)} sampled scores vs "
          f"batch jsdist_tilde of the relabelled graphs: max |diff| "
          + ", ".join(f"{v:.3e} at tick {t}" for t, v in worst.items())
          + f" (bound 5e-3); {len(sampled)} sampled edge stores equal "
          "the mirror at their SlotMap slots")
    out["sparse_snap"] = captured["snap"]
    # For scale: the blocking pageable copy of the stacked delta that
    # the sync ingestor would pay in the poll, timed alone on a host
    # copy of the delta of tick TICKS // 2; the kernel is timed after
    # this phase.
    host = captured["snap"][1].map_tensors(lambda x: x.cpu())
    copy_ms = cuda_ms(lambda: host.map_tensors(lambda x: x.to(dev)), 10)
    nbytes = sum(x.numel() * x.element_size()
                 for x in host.tensors().values())
    print(f"  a pageable host-to-device copy of the {nbytes / 1e6:.1f} MB "
          f"stacked slot-space delta (the sync ingestor's) {copy_ms:.3f} "
          f"ms; Python garbage collection paused "
          f"{gc_s['poll'] * 1e3:.1f} ms inside the 20 polls and "
          f"{gc_s['ingest'] * 1e3:.1f} ms inside the 20 ingests (which took "
          f"{sum(ingest_ms):.1f} ms)")
    sparse_save_restore(torch, dev, svc, fleet, n_virtual, out)
    svc.close()


def sparse_save_restore(torch, dev, svc, fleet, n_virtual, out):
    """Phase 5's end: save the sparse service and restore it (the
    `SlotMap` JSON equal, the state bit-equal), then one more tick on
    both services, bit-equal (launched outside the path's count). The
    restored service, the checkpoint, the mirror and that tick's deltas
    stay for phase 9."""
    import shutil

    from repro_torch.serving import FingerService

    root = Path(__file__).resolve().parent / "build" / "sparse_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    svc.save(str(root))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = FingerService.restore(svc.config, directory=str(root),
                                 device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    # to_json is a function of these fields; comparing them costs far
    # less than 4096 to_json calls a side (about 7 ms each)
    fields = ("layout", "n_virtual", "stream", "node_slot", "edge_slot",
              "_free_nodes", "_free_edges", "_node_edges")
    bad = [i for i, (a, b) in enumerate(zip(svc.slot_maps, back.slot_maps))
           if any(getattr(a, f) != getattr(b, f) for f in fields)]
    bad += [i for i in range(0, len(back.slot_maps), 64)
            if back.slot_maps[i].to_json() != svc.slot_maps[i].to_json()]
    if bad or len(back.slot_maps) != len(svc.slot_maps):
        raise AssertionError(f"restored SlotMaps differ in streams {bad[:8]}")
    check_same("sparse restore", state_bits(torch, svc),
               state_bits(torch, back))
    deltas = fleet.virtual_deltas(n_virtual)
    for s in (svc, back):
        s.ingest(deltas)
        s.poll()
    check_same("the tick after the sparse restore",
               state_bits(torch, svc, True), state_bits(torch, back, True))
    print(f"  checkpoint of the sparse service ({len(back.slot_maps)} "
          f"SlotMaps in the manifest): save {save_s:.2f} s, restore "
          f"{restore_s:.2f} s; every SlotMap equal field by field (the JSON "
          "of every 64th compared), state bit-equal, and one more tick "
          "bit-equal on both services")
    out["sparse_live"] = (back, root, fleet, deltas, n_virtual)


def sparse_bytes(before, after, deltas) -> tuple:
    """Bytes a sparse tick must move in place and out of place: read the
    scalars, the strength and mask rows and the delta with its slots;
    write dist and the scalars, and in place only the strength and mask
    elements that change and the store slots the gated lanes write (a
    snapped row's nonzero store elements), out of place the whole rows
    and store."""
    import torch

    from repro_torch.graphs.types import (in_range, node_mask_after_joins,
                                          take_nodes)

    *lead, n = before.strengths.shape
    rows, m = int(torch.Size(lead).numel()), before.m_pad
    k, j = deltas.dw.shape[-1], deltas.node_ids.shape[-1]
    changed = int((after.strengths != before.strengths).sum()) \
        + int((after.node_mask != before.node_mask).sum())
    joined = node_mask_after_joins(before.node_mask, deltas)
    gate = deltas.mask * take_nodes(joined, deltas.senders) \
        * take_nodes(joined, deltas.receivers)
    snapped = (after.s_total <= 0)[..., None]
    store = int(((gate > 0) & in_range(deltas.edge_slots, m)
                 & ~snapped).sum()) \
        + int(((before.edge_weights != 0) & snapped).sum())
    read = rows * (4 * 3 + 8 * n + 24 * k + 8 * j)
    return (read + rows * 16 + 4 * (changed + store),
            read + rows * (16 + 8 * n + 4 * m))


def sparse_rows(torch, out):
    """The sparse_tick row of the kernels line: the in-place launch the
    sparse path makes, on a copy of a sparse-path tick's inputs."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.sparse_tick import ops as sp_ops
    from repro_torch.kernels.sparse_tick import parity as sp_parity
    from repro_torch.kernels.sparse_tick.ref import sparse_tick_ref

    errs, rows = out["errs"], []
    for name, (snap, deltas), fn in (
            ("sparse_tick", out.pop("sparse_snap"),
             sp_ops.sparse_tick_fused),):
        work = snap.map_tensors(torch.clone)

        def restore(work=work, snap=snap):
            for f in SP_FIELDS:
                getattr(work, f).copy_(getattr(snap, f))

        want = sparse_tick_ref(snap, deltas, exact_smax=True)
        got = fn(work, deltas, exact_smax=True, inplace=True)
        errs[name] = max(errs[name], sp_parity.compare(got, want, name))
        b_in, b_out = sparse_bytes(snap, work, deltas)
        del got, want
        ms = cuda_ms(lambda: fn(work, deltas, exact_smax=True, inplace=True),
                     50, setup=restore)
        ms_out = cuda_ms(lambda: fn(snap, deltas, exact_smax=True), 50)
        ms_again = cuda_ms(lambda: fn(work, deltas, exact_smax=True,
                                      inplace=True), 50)
        plain = cuda_ms(lambda: sparse_tick_ref(snap, deltas,
                                                exact_smax=True), 5)
        shape = tuple(snap.strengths.shape[:-1]) + (
            snap.n_slots, snap.m_pad, deltas.dw.shape[-1],
            deltas.node_ids.shape[-1])
        res = dispatch.residency("sparse_tick", *shape[-2:])
        print(f"  {name}: resident streams per SM {res['streams_per_sm']} "
              f"({res['registers']} registers a thread)")
        print(f"  {name} rows,n_slots,m_pad,k,j={shape}: in place "
              f"{ms:.4f} ms (bound {b_in / HBM_BYTES_PER_S * 1e3:.6f} ms, "
              f"{b_in} B), out of place {ms_out:.4f} ms (bound "
              f"{b_out / HBM_BYTES_PER_S * 1e3:.6f} ms, {b_out} B); in place "
              f"back to back, the state not restored between calls, "
              f"{ms_again:.4f} ms")
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/sparse_tick.cu",
            "replaces": "src/repro/kernels/sparse_tick/kernel.py:195",
            "launches": out["launches"][name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": b_in / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None})
        print_row(rows[-1])
        del work
    return rows


def kernel_rows(torch, out):
    """Times, bounds and errors of each kernel at the main path's
    shapes and inputs."""
    import dataclasses

    from repro_torch.core.incremental import gate_delta_for_update
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.delta_stats import ops as ds_ops
    from repro_torch.kernels.delta_stats import parity as ds_parity
    from repro_torch.kernels.delta_stats.ref import delta_stats_gated_ref
    from repro_torch.kernels.stream_tick import ops as st_ops
    from repro_torch.kernels.stream_tick import parity as st_parity
    from repro_torch.kernels.stream_tick.ref import stream_tick_ref

    # The main path's launch: in place (engine/stream.py), exact s_max,
    # on a copy of the state of tick TICKS // 2, restored before each call.
    snap, deltas = out["snap"]
    work = snap.map_tensors(torch.clone)

    def restore():
        for f in ("q", "s_total", "s_max", "strengths", "node_mask"):
            getattr(work, f).copy_(getattr(snap, f))

    def tick(d):
        return lambda: st_ops.stream_tick_fused(work, d, exact_smax=True,
                                                inplace=True)

    errs = out["errs"]
    want = stream_tick_ref(snap, deltas, exact_smax=True)
    got = tick(deltas)()
    err = st_parity.compare(got, want, "main-path tick")
    errs["stream_tick"] = max(errs["stream_tick"], err)
    changed = int((work.strengths != snap.strengths).sum()) \
        + int((work.node_mask != snap.node_mask).sum())
    del got, want
    ms = cuda_ms(tick(deltas), 20, setup=restore)
    plain = cuda_ms(lambda: stream_tick_ref(snap, deltas, exact_smax=True),
                    5)
    b, n = snap.strengths.shape
    k, j = deltas.dw.shape[-1], deltas.node_ids.shape[-1]
    # read: 3 scalars, the strength and mask rows, the delta; written:
    # dist, 3 scalars, and the state elements the delta changes
    bytes_tick = b * (4 * 3 + 8 * n + 20 * k + 8 * j) + b * 4 * 4 \
        + 4 * changed
    masked = dataclasses.replace(deltas, mask=torch.zeros_like(deltas.mask))
    first32 = dataclasses.replace(deltas, **{
        f: getattr(deltas, f)[:, :32].contiguous()
        for f in ("senders", "receivers", "dw", "w_old", "mask")})
    ms_masked = cuda_ms(tick(masked), 10, setup=restore)
    ms_k32 = cuda_ms(tick(first32), 10, setup=restore)
    res = dispatch.residency("stream_tick", k, j)
    print(f"  stream_tick in place, B={b} n_pad={n} k_pad={k} j_pad={j}: "
          f"{changed} state elements changed; every lane masked "
          f"{ms_masked:.4f} ms; first 32 lanes only {ms_k32:.4f} ms; "
          f"resident streams per SM {res['streams_per_sm']} "
          f"({res['blocks_per_sm']} blocks of {res['streams_per_block']} "
          f"streams, one warp a stream; {res['registers']} registers a "
          f"thread, {st_ops.stream_tick_smem_bytes(k, j)} B of shared "
          f"memory a block)")
    del work, masked, first32
    rows = [{
        "name": "stream_tick", "route": "cuda",
        "source": "src/repro_torch/csrc/stream_tick.cu",
        "replaces": "src/repro/kernels/stream_tick/kernel.py:193",
        "launches": out["launches"]["stream_tick"],
        "max_abs_err": errs["stream_tick"], "ms": ms, "plain_ms": plain,
        "bound_ms": bytes_tick / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None}]

    # the whole delta_stats_fused call the path makes, from the gated
    # delta of the first update (one launch, nothing else on the card)
    state, delta = out["single"]
    delta, _ = gate_delta_for_update(state.node_mask, delta)
    want = ds_parity.plain(state.strengths, delta)
    err = ds_parity.compare(ds_ops.delta_stats_cuda(state.strengths, delta),
                            want, "main-path stats")
    errs["delta_stats"] = max(errs["delta_stats"], err)
    ms = cuda_ms(lambda: ds_ops.delta_stats_fused(state, delta,
                                                  pre_gated=True), 200)
    plain = cuda_ms(lambda: delta_stats_gated_ref(state.strengths, delta),
                    50)
    empty = cuda_ms(lambda: dispatch.empty_launch(
        "delta_stats", state.strengths.device), 200)
    # read: the k lanes (ids, Δw, w_old, mask) and the strength of each
    # touched node; written: the (4,) stats
    k = delta.dw.shape[-1]
    bytes_stats = 20 * k + 4 * int(want[3]) + 16
    print(f"  delta_stats_fused from the gated delta, n_pad={N_PAD} "
          f"k_pad={k}, |dV|={int(want[3])}: {ms:.4f} ms a call; one empty "
          f"launch through the same ctypes path {empty:.4f} ms")
    rows.append({
        "name": "delta_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/delta_stats.cu",
        "replaces": "src/repro/kernels/delta_stats/kernel.py:77",
        "launches": out["launches"]["delta_stats"],
        "max_abs_err": errs["delta_stats"], "ms": ms, "plain_ms": plain,
        "bound_ms": bytes_stats / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "empty_launch_ms": empty, "path_ms_a_delta": out.pop("single_ms")})

    for r in rows:
        print_row(r)
    return rows


def phase_train(args, torch, out, dev):
    """Phase 6: the training path with FINGER telemetry."""
    import tempfile

    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.launch.train import run
    from repro_torch.models.api import build_loss_fn, model_param_defs
    from repro_torch.models.params import (flatten_names, init_params,
                                           map_tree)
    from repro_torch.optim.adamw import AdamWConfig, AdamWState, apply_update
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.telemetry import (attention_probe_logits,
                                             routing_graph)

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)

    def train(log):
        return run(cfg, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
                   seq=TRAIN_SEQ, probe_every=PROBE_EVERY, seed=args.seed,
                   lr=TRAIN_LR, log=log, device=dev)

    logs = []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    params, opt_state, history = train(logs.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(out)
    peak = torch.cuda.max_memory_allocated()
    launches = {k: counts[k] for k in ("vnge_q", "row_stats", "graph_stats")}
    losses = [h["loss"] for h in history]
    grad_norms = [h["grad_norm"] for h in history]
    step_ms = [h["step_ms"] for h in history]
    probes = [h for h in history if h["step"] % PROBE_EVERY == 0]
    ent = [h["attn_entropy_mean"] for h in probes]
    jsd = [h["routing_jsdist"] for h in probes[1:]]
    print(f"  {logs[0]}; depth cut: n_layers={TRAIN_LAYERS} of "
          f"{get_config(TRAIN_ARCH).n_layers}; batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, {TRAIN_STEPS} steps in {wall:.1f} s")
    print("  losses " + " ".join(f"{x:.4f}" for x in losses))
    print("  grad norms " + " ".join(f"{x:.4g}" for x in grad_norms))
    med = float(np.median(step_ms))
    print(f"  step time (CUDA events around the step function): median "
          f"{med:.1f} ms, first {step_ms[0]:.1f} ms, every step "
          + " ".join(f"{x:.1f}" for x in step_ms)
          + f"; {TRAIN_BATCH * TRAIN_SEQ / med * 1e3:.1f} tokens/s; peak "
          f"torch.cuda.max_memory_allocated {peak / 1e9:.2f} GB")
    print(f"  attn_entropy_mean {ent}; routing_jsdist {jsd}; launches "
          f"{counts}")
    if not np.isfinite(losses + grad_norms).all():
        raise AssertionError(f"train path: losses {losses} or grad norms "
                             f"{grad_norms} are not finite")
    if int(opt_state.step) != TRAIN_STEPS:
        raise AssertionError(f"train path: optimizer step "
                             f"{int(opt_state.step)} != {TRAIN_STEPS}")
    if len(jsd) != len(probes) - 1 or not np.isfinite(ent + jsd).all() \
            or min(jsd) < 0:
        raise AssertionError(f"train path: probes {ent} {jsd}")
    want = {"vnge_q": 3 * (len(probes) - 1), "row_stats": len(probes),
            "graph_stats": len(probes)}
    if launches != want or any(n for k, n in counts.items()
                               if k not in want):
        raise AssertionError(f"train path launches {counts}; want {want} "
                             "and no other kernel")

    # every leaf moved: each parameter off its init (drawn again from the
    # seed) and both moments off 0. The loss of step 0's batch before and
    # after training (the same tokens, so no batch-to-batch wander) is
    # printed, not gated: under the init's fan-in quirk the clipped steps
    # do not lower it at this width (ROADMAP Queue 3)
    init = init_params(model_param_defs(cfg),
                       torch.Generator(device=dev).manual_seed(args.seed),
                       device=dev)
    flat_i = flatten_names(init)
    stale = [k for k, p in flatten_names(params).items()
             if torch.equal(p, flat_i[k])]
    for name, tree in (("mu", opt_state.mu), ("nu", opt_state.nu)):
        stale += [f"{name}/{k}" for k, m in flatten_names(tree).items()
                  if not bool(m.any())]
    if stale:
        raise AssertionError(f"train path: {TRAIN_STEPS} steps left "
                             f"{len(stale)} leaves as initialized: "
                             f"{stale[:8]}")
    loss_fn = build_loss_fn(cfg)
    batch0 = synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, args.seed, 0, dev)
    with torch.no_grad():
        l_init = float(loss_fn(init, batch0))
        l_trained = float(loss_fn(params, batch0))
        fwd_ms = cuda_ms(lambda: loss_fn(params, batch0), 3)
    del init, flat_i
    print(f"  {len(flatten_names(params))} parameter leaves and both "
          f"moments of each moved; step 0's batch: loss {l_init:.6f} at "
          f"init, {l_trained:.6f} after {TRAIN_STEPS} steps "
          f"({l_trained - l_init:+.6f})")

    # the probes' inputs at the last probe step, for the kernel rows
    batch = synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, args.seed,
                            (TRAIN_STEPS - 1) // PROBE_EVERY * PROBE_EVERY,
                            dev)
    out["train"] = (routing_graph(params, batch, cfg).weights.contiguous(),
                    attention_probe_logits(params, batch["tokens"], cfg,
                                           probe_len=min(TRAIN_SEQ, 128)))

    # a checkpoint of the trained embedding and first expert stack
    # (w_gate of the first TRAIN_CKPT_LAYERS layers), the key/value
    # projections, router and norm weights, with their moments and the
    # step; phase 9 restores it onto the card with elastic_restore from a
    # CPU template and holds it to a copy taken here
    def part(tree):
        b = tree["blocks"]["L0"]
        return {"embed": tree["embed"], "final_norm": tree["final_norm"],
                "blocks": {"L0": {
                    "ln1": b["ln1"], "ln2": b["ln2"],
                    "attn": {k: b["attn"][k] for k in ("wk", "wv")},
                    "moe": {"router": b["moe"]["router"],
                            "w_gate": b["moe"]["w_gate"][
                                :TRAIN_CKPT_LAYERS]}}}}

    tree = {"params": part(params), "opt": AdamWState(
        step=opt_state.step, mu=part(opt_state.mu), nu=part(opt_state.nu))}
    root = Path(__file__).resolve().parent / "build"
    root.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=root, prefix="train_ckpt_")
    c0 = time.perf_counter()
    path = save_checkpoint(tmp, TRAIN_STEPS, tree,
                           metadata={"arch": cfg.name})
    c1 = time.perf_counter()
    on_disk = sum(f.stat().st_size for f in Path(path).iterdir())
    a = flatten_names(tree)
    nbytes = sum(x.numel() * x.element_size() for x in a.values())
    print(f"  checkpoint of {len(a)} arrays ({nbytes / 1e9:.3f} GB, step "
          f"{int(opt_state.step)}) saved in {c1 - c0:.1f} s, "
          f"{on_disk / 1e9:.3f} GB on disk (phase 9 restores it)")
    saved = map_tree(torch.clone, tree)
    del tree, a

    # determinism: a second run from the same seed repeats every loss
    again = [h["loss"] for h in train(lambda *a: None)[2]]
    if again != losses:
        raise AssertionError(f"train path: a second run gave losses "
                             f"{again} != {losses}")

    # the step's split: forward alone (above) and the clip + AdamW update
    # alone (in place, on stand-in gradients); the rest is the backward
    # with its per-period recompute
    opt_cfg = AdamWConfig(lr_peak=TRAIN_LR, total_steps=TRAIN_STEPS)
    grads = map_tree(torch.ones_like, params)
    upd_ms = cuda_ms(lambda: apply_update(params, grads, opt_state,
                                          opt_cfg), 3)
    print(f"  a second run repeated all {TRAIN_STEPS} losses bit for bit; "
          f"step split: forward {fwd_ms:.1f} ms, clip + AdamW update "
          f"{upd_ms:.1f} ms, backward with recompute (the rest of the "
          f"median step) {med - fwd_ms - upd_ms:.1f} ms")
    # phase 9 continues training from here with gradient compression
    out["train_state"] = (cfg, params, opt_state, path, saved)
    del params, opt_state, grads
    gc.collect()
    torch.cuda.empty_cache()


def train_rows(torch, out, dev):
    """The train path's kernels on its own inputs (the trained model's
    routing graph and probe logits) and at phase 2's largest shapes."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.entropy_probe import ops as ep_ops
    from repro_torch.kernels.entropy_probe import parity as ep_parity
    from repro_torch.kernels.entropy_probe import ref as ep_ref
    from repro_torch.kernels.vnge_q import ops as vq_ops
    from repro_torch.kernels.vnge_q import parity as vq_parity
    from repro_torch.kernels.vnge_q.ref import vnge_q_stats_ref

    w, logits = out.pop("train")
    errs = out["errs"]
    errs["vnge_q"] = max(errs["vnge_q"], vq_parity.compare(
        vq_ops.vnge_q_stats_cuda(w), vnge_q_stats_ref(w), "path vnge_q"))
    rows_in = ep_ops.row_stats_cuda(logits)
    errs["row_stats"] = max(errs["row_stats"], ep_parity.compare(
        rows_in, ep_ref.row_stats_ref(logits), "path row_stats"))
    errs["graph_stats"] = max(errs["graph_stats"], ep_parity.compare(
        [ep_ops.graph_stats_cuda(logits, *rows_in)],
        [ep_ref.graph_stats_ref(logits, *rows_in)], "path graph_stats"))

    def vnge_times(w):
        n = w.shape[0]
        return {"ms": cuda_ms(lambda: vq_ops.vnge_q_stats(w), 200),
                "plain_ms": cuda_ms(lambda: vnge_q_stats_ref(w), 50),
                "bound_ms": (4 * n * n + 16) / HBM_BYTES_PER_S * 1e3,
                "library_ms": None}

    def probe_times(x):
        """Each probe kernel's wrapper alone, its plain version, its
        bytes bound and (row stats) `torch.logsumexp`, the same read and
        reduction with one output; and the whole `attention_graph_stats`
        call."""
        bh, s, _ = x.shape
        rm, dn = ep_ops.row_stats_cuda(x)
        big = 4 * bh * s * s
        whole = cuda_ms(lambda: ep_ops.attention_graph_stats(x), 100)
        return ({"ms": cuda_ms(lambda: ep_ops.row_stats_cuda(x), 100),
                 "plain_ms": cuda_ms(lambda: ep_ref.row_stats_ref(x), 20),
                 "bound_ms": (big + 8 * bh * s) / HBM_BYTES_PER_S * 1e3,
                 "library_ms": cuda_ms(lambda: torch.logsumexp(x, -1), 100),
                 "whole_call_ms": whole},
                {"ms": cuda_ms(lambda: ep_ops.graph_stats_cuda(x, rm, dn),
                               100),
                 "plain_ms": cuda_ms(lambda: ep_ref.graph_stats_ref(x, rm,
                                                                    dn), 20),
                 "bound_ms": (big + 8 * bh * s + 16 * bh)
                 / HBM_BYTES_PER_S * 1e3,
                 "library_ms": None, "whole_call_ms": whole})

    big_n = VNGE_NS[-1]
    big_bh, big_s = PROBE_SHAPES[-1]
    timed = {"vnge_q": (vnge_times(w), vnge_times(vq_parity.make_case(
        big_n, seed=1, device=dev)[0]), (w.shape[0],), (big_n,))}
    path_t = probe_times(logits)
    big_t = probe_times(ep_parity.make_case(big_bh, big_s, seed=1,
                                            device=dev))
    for i, name in enumerate(("row_stats", "graph_stats")):
        timed[name] = (path_t[i], big_t[i], tuple(logits.shape[:2]),
                       (big_bh, big_s))
    where = {"vnge_q": ("src/repro_torch/csrc/vnge_q.cu",
                        "src/repro/kernels/vnge_q/kernel.py:56"),
             "row_stats": ("src/repro_torch/csrc/entropy_probe.cu",
                           "src/repro/kernels/entropy_probe/kernel.py:35"),
             "graph_stats": ("src/repro_torch/csrc/entropy_probe.cu",
                             "src/repro/kernels/entropy_probe/kernel.py:42")}
    empty = {lib: cuda_ms(lambda lib=lib: dispatch.empty_launch(lib, dev),
                          200)
             for lib in ("vnge_q", "entropy_probe")}
    print(f"  one empty launch through vnge_q's ctypes path: "
          f"{empty['vnge_q']:.4f} ms; through entropy_probe's: "
          f"{empty['entropy_probe']:.4f} ms")
    print(f"  attention_graph_stats, whole call: "
          f"{path_t[0]['whole_call_ms']:.4f} ms at the path's shape "
          f"{tuple(logits.shape[:2])}, {big_t[0]['whole_call_ms']:.4f} ms "
          f"at {(big_bh, big_s)}")
    rows = []
    for name, (path, big, shape, big_shape) in timed.items():
        lib = "" if path["library_ms"] is None else (
            f"; library {path['library_ms']:.4f} / "
            f"{big['library_ms']:.4f} ms")
        print(f"  {name} at the path's shape {shape}: {path['ms']:.4f} ms "
              f"(plain {path['plain_ms']:.4f} ms, bound "
              f"{path['bound_ms']:.6f} ms); at {big_shape}: "
              f"{big['ms']:.4f} ms (plain {big['plain_ms']:.4f} ms, bound "
              f"{big['bound_ms']:.6f} ms){lib}")
        rows.append({
            "name": name, "route": "cuda", "source": where[name][0],
            "replaces": where[name][1],
            "launches": out["launches"][name], "max_abs_err": errs[name],
            **path, "bound_by": "bytes", "shape": list(shape),
            "large": {"shape": list(big_shape), **big},
            "empty_launch_ms": empty["vnge_q" if name == "vnge_q"
                                     else "entropy_probe"]})
        print_row(rows[-1])
    return rows


def offline_edges(seed: int):
    """The offline phase's three graphs as numpy edge lists (lo, hi, w):
    G, a planted partition of OFF_N nodes drawn as an edge list; G', G
    with a planted burst (a contiguous block of OFF_BURST·n nodes loses
    its edges and each of its nodes links to OFF_BURST_DEG random nodes
    of one hub community's 1024 ids, away from the block); and Ḡ's two
    halved lists, concatenated (duplicates are summed when the graph is
    built)."""
    import numpy as np

    from repro_torch.graphs.generators import random_geometric_community_edges

    size = OFF_N / OFF_COMM
    lo, hi = random_geometric_community_edges(
        OFF_N, OFF_COMM, OFF_DEG_IN / (size - 1),
        OFF_DEG_OUT / (OFF_N - size), seed=seed)
    w = np.ones(lo.shape, np.float32)
    rng = np.random.default_rng(seed + 1)
    k = int(OFF_BURST * OFF_N)
    r0 = int(rng.integers(0, OFF_N // 2 - k))
    hub0 = int(rng.integers(OFF_N // 2, OFF_N - 1024))
    kept = ~(((lo >= r0) & (lo < r0 + k)) | ((hi >= r0) & (hi < r0 + k)))
    src = np.repeat(np.arange(r0, r0 + k), OFF_BURST_DEG)
    dst = hub0 + rng.integers(0, 1024, src.size)
    key = np.unique(src.astype(np.int64) * OFF_N + dst)
    lo2 = np.r_[lo[kept], (key // OFF_N).astype(np.int32)]
    hi2 = np.r_[hi[kept], (key % OFF_N).astype(np.int32)]
    w2 = np.ones(lo2.shape, np.float32)
    bar = (np.r_[lo, lo2], np.r_[hi, hi2], np.r_[0.5 * w, 0.5 * w2])
    return {"G": (lo, hi, w), "G2": (lo2, hi2, w2), "Gbar": bar}


def device_edge_list(edges, n: int, dev):
    """A coalesced `EdgeList` on the card from numpy (lo, hi, w)."""
    import torch

    from repro_torch.graphs.types import EdgeList, coalesce_edges

    lo, hi, w = coalesce_edges(*(torch.from_numpy(a).to(dev) for a in edges),
                               n)
    return EdgeList(senders=lo, receivers=hi, weights=w,
                    mask=torch.ones_like(w), n_nodes=n)


def median_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` on the card, each call between its
    own pair of CUDA events."""
    import numpy as np
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bsr_bytes(m) -> tuple:
    """Bytes one matvec must move, (this matrix's data, as stored): the
    real blocks (those with a nonzero entry) or every stored block,
    padding slots included, each read once, with col_ids, x read once
    and y written once. The first is the bound: the work of a sparse
    product depends on its data, and the padding adds nothing to y."""
    real = int(m.values.ne(0).flatten(2).any(-1).sum())
    rest = m.col_ids.numel() * 4 + 2 * 4 * m.n
    b2 = m.block * m.block * 4
    return real * b2 + rest, m.values.numel() * 4 + rest


def phase_offline(args, torch, out, dev):
    """Phase 7: the offline spectral path (FINGER-Ĥ, Algorithm 1, exact
    VNGE) through the ``bsr_matvec`` kernel."""
    import numpy as np

    from repro_torch.core import quadratic_q, vnge_hat, vnge_tilde
    from repro_torch.core.jsdist import js_from_entropies
    from repro_torch.graphs.spectral import power_iteration_lmax
    from repro_torch.kernels.bsr_spmv import ops as bs_ops
    from repro_torch.kernels.bsr_spmv.ref import bsr_density, edges_to_bsr

    t0 = time.perf_counter()
    edges = offline_edges(args.seed)
    print(f"  graphs drawn on the host in {time.perf_counter() - t0:.1f} s: "
          f"n={OFF_N}, {OFF_COMM} communities, edges G {edges['G'][0].size}, "
          f"G' {edges['G2'][0].size}")
    res, mats = {}, {}
    zero_counts()
    for name, e in edges.items():
        torch.cuda.synchronize()
        b0 = time.perf_counter()
        m = edges_to_bsr(*e, OFF_N, b=OFF_B, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - b0
        g = device_edge_list(e, OFF_N, dev)
        info = {}
        p0 = time.perf_counter()
        lam = bs_ops.power_iteration_lmax_bsr(m, info=info)
        lam_f = float(lam)
        pi_s = time.perf_counter() - p0
        # one value a graph, printed and checked
        q = float(quadratic_q(g))  # lint: disable=per-item-host-sync
        h_hat = float(vnge_hat(g, lambda_max=lam))  # lint: disable=per-item-host-sync
        h_tilde = float(vnge_tilde(g))  # lint: disable=per-item-host-sync
        res[name] = dict(lam=lam_f, q=q, h_hat=h_hat, h_tilde=h_tilde,
                         iters=info["iterations"], build_s=build_s,
                         pi_s=pi_s, edges=int(g.weights.numel()))
        mats[name] = (m, g)
    launches = read_counts(out)["bsr_matvec"]
    jsd = float(js_from_entropies(torch.tensor(res["Gbar"]["h_hat"]),
                                  torch.tensor(res["G"]["h_hat"]),
                                  torch.tensor(res["G2"]["h_hat"])))
    want = sum(r["iters"] + 2 for r in res.values())
    if launches != want:
        raise AssertionError(f"bsr_matvec launched {launches} times; the "
                             f"three power iterations need {want}")
    for name, (m, g) in mats.items():
        r = res[name]
        lam_mf = power_iteration_lmax(g)
        # one value a graph, checked
        h_mf = float(vnge_hat(g, lambda_max=lam_mf))  # lint: disable=per-item-host-sync
        lam_mf = float(lam_mf)
        if name == "G":  # phase 9 shards this edge list
            out["dist_G"] = (g, lam_mf)
        x = torch.randn(m.n, generator=torch.Generator().manual_seed(1)) \
            .to(dev)
        order = bs_ops.stripe_order(m.counts, m.col_ids.shape[1])
        mv_ms = median_ms(lambda: bs_ops.bsr_matvec_cuda(
            m.values, m.col_ids, m.counts, x, order), 20)
        real, stored = bsr_bytes(m)
        vals = [r["lam"], r["q"], r["h_hat"], r["h_tilde"], lam_mf, h_mf]
        print(f"  {name}: edges {r['edges']}, max_bpr {m.col_ids.shape[1]}, "
              f"bsr_density {bsr_density(m):.6f}, values "
              f"{m.values.numel() * 4 / 1e9:.3f} GB, BSR build "
              f"{r['build_s']:.3f} s; power iteration {r['iters']} "
              f"iterations in {r['pi_s']:.3f} s, median matvec "
              f"{mv_ms:.4f} ms (bound {real / HBM_BYTES_PER_S * 1e3:.4f} ms "
              f"for the {real} B of real blocks, "
              f"{stored / HBM_BYTES_PER_S * 1e3:.4f} ms for the {stored} B "
              f"stored), matvec share "
              f"{(r['iters'] + 2) * mv_ms / 1e3 / r['pi_s']:.4f} (the rest: "
              f"host syncs, launch gaps, vector ops)")
        print(f"    lambda_max {r['lam']:.9g} (matrix-free {lam_mf:.9g}), "
              f"Q {r['q']:.9g}, H_hat {r['h_hat']:.7f} (matrix-free "
              f"{h_mf:.7f}), H_tilde {r['h_tilde']:.7f}")
        if not np.isfinite(vals).all():
            raise AssertionError(f"offline {name}: non-finite {vals}")
        if abs(r["lam"] - lam_mf) > 1e-4 * abs(lam_mf) \
                or abs(r["h_hat"] - h_mf) > 1e-4:
            raise AssertionError(
                f"offline {name}: kernel route lambda {r['lam']} H_hat "
                f"{r['h_hat']} vs matrix-free {lam_mf} {h_mf}")
        if not r["h_tilde"] <= r["h_hat"]:
            raise AssertionError(f"offline {name}: H_tilde {r['h_tilde']} "
                                 f"> H_hat {r['h_hat']}")
        del x
    if not np.isfinite(jsd):
        raise AssertionError(f"offline JSdist {jsd}")
    print(f"  JSdist(G, G') by Algorithm 1 = {jsd:.7f}; bsr_matvec "
          f"launches {launches} (iterations + 2 per graph); every lambda "
          f"and H_hat within rtol 1e-4 / atol 1e-4 of the matrix-free "
          f"route, H_tilde <= H_hat for each graph")
    out["offline"] = mats.pop("G")[0]
    del mats
    phase_offline_dense(args, torch, dev)
    phase_offline_dos(args, torch, dev)


def phase_offline_dense(args, torch, dev):
    """Phase 7, dense part: exact H and jsdist_exact beside Ĥ and
    jsdist_fast at n = DENSE_N, on the card and on the CPU."""
    import numpy as np

    from repro_torch.core import (exact_vnge, jsdist_exact, jsdist_fast,
                                  vnge_hat)
    from repro_torch.graphs.generators import erdos_renyi
    from repro_torch.graphs.types import GraphDelta, apply_delta_dense

    g = erdos_renyi(DENSE_N, DENSE_DEG / (DENSE_N - 1), seed=args.seed)
    rng = np.random.default_rng(args.seed + 2)
    target = int(rng.integers(0, DENSE_N))
    bots = rng.choice(np.setdiff1d(np.arange(DENSE_N), [target]),
                      DENSE_N // 100, replace=False)
    w_old = g.weights[bots, target].numpy()
    delta = GraphDelta.from_arrays(bots, np.full(bots.size, target),
                                   1.0 - w_old, w_old, n_nodes=DENSE_N)
    got = {}
    for where, dv in (("card", dev), ("cpu", torch.device("cpu"))):
        a = g.to(dv)
        b = apply_delta_dense(a, delta.to(dv))
        row = {}
        for label, fn in (("exact_vnge", lambda: exact_vnge(a)),
                          ("vnge_hat", lambda: vnge_hat(a)),
                          ("jsdist_exact", lambda: jsdist_exact(a, b)),
                          ("jsdist_fast", lambda: jsdist_fast(a, b))):
            t0 = time.perf_counter()
            # one value a function, its pull timed with it
            v = float(fn())  # lint: disable=per-item-host-sync
            row[label] = (v, time.perf_counter() - t0)
        got[where] = row
    card, cpu = got["card"], got["cpu"]
    print(f"  dense n={DENSE_N} (ER, mean degree {DENSE_DEG:g}; G' adds "
          f"{DENSE_N // 100} edges to one target through apply_delta_dense): "
          + "; ".join(f"{k} card {card[k][0]:.7f} in {card[k][1]:.3f} s, "
                      f"CPU {cpu[k][0]:.7f} in {cpu[k][1]:.3f} s"
                      for k in card))
    for k in ("exact_vnge", "vnge_hat"):
        if abs(card[k][0] - cpu[k][0]) > 1e-5:
            raise AssertionError(f"dense {k}: card {card[k][0]} vs CPU "
                                 f"{cpu[k][0]}")
    for k in ("jsdist_exact", "jsdist_fast"):  # compared as divergences
        if abs(card[k][0] ** 2 - cpu[k][0] ** 2) > 1e-5:
            raise AssertionError(f"dense {k}: card {card[k][0]} vs CPU "
                                 f"{cpu[k][0]}")
    if not card["exact_vnge"][0] >= card["vnge_hat"][0] - 1e-3:
        raise AssertionError(f"dense: H_hat {card['vnge_hat'][0]} above "
                             f"H {card['exact_vnge'][0]}")


def phase_offline_dos(args, torch, dev):
    """Phase 7, Table 3: the top-2 detection rate of a planted DoS by
    jsdist_fast at the reference benchmark's setting, card against CPU."""
    import numpy as np

    from repro_torch.core import jsdist_fast
    from repro_torch.graphs.streams import dos_attack_sequence

    hits = {"card": 0, "cpu": 0}
    secs = {"card": 0.0, "cpu": 0.0}
    worst = worst_dist = 0.0
    for inst in range(DOS_INSTANCES):
        seq, attack_at = dos_attack_sequence(n=DOS_N, attack_frac=DOS_X,
                                             seed=inst)
        scores = {}
        for where, dv in (("card", dev), ("cpu", torch.device("cpu"))):
            gs = [g.to(dv) for g in seq.graphs]
            t0 = time.perf_counter()
            scores[where] = np.array([
                # one score a graph pair, as the reference's Table 3 takes them
                float(jsdist_fast(gs[t], gs[t + 1], power_iters=DOS_ITERS))  # lint: disable=per-item-host-sync
                for t in range(len(gs) - 1)])
            secs[where] += time.perf_counter() - t0
            hits[where] += int(attack_at in np.argsort(scores[where])[-2:])
        # scores compared as distances, and as divergences where JSdiv <
        # 1e-3: the square root amplifies rounding near 0
        a, b = scores["card"], scores["cpu"]
        small = np.minimum(a, b) ** 2 < 1e-3
        diff = np.where(small, np.abs(a * a - b * b), np.abs(a - b))
        # host numpy arrays: no device value
        worst = max(worst, float(diff.max()))  # lint: disable=per-item-host-sync
        worst_dist = max(worst_dist, float(np.abs(a - b).max()))  # lint: disable=per-item-host-sync
        if not np.isfinite(scores["card"]).all():
            raise AssertionError(f"DoS instance {inst}: scores "
                                 f"{scores['card']}")
    print(f"  Table 3 (N={DOS_N}, X={DOS_X:.0%}, {DOS_INSTANCES} instances, "
          f"jsdist_fast power_iters={DOS_ITERS}): top-2 detection rate card "
          f"{hits['card'] / DOS_INSTANCES:.0%}, CPU "
          f"{hits['cpu'] / DOS_INSTANCES:.0%}; scores card vs CPU max |diff| "
          f"{worst:.3e} (bound 1e-4; as JSdiv where JSdiv < 1e-3; as "
          f"distances alone {worst_dist:.3e}); {secs['card']:.2f} s on the "
          f"card, {secs['cpu']:.2f} s on the CPU")
    if worst > 1e-4:
        raise AssertionError(f"DoS scores: card vs CPU differ by {worst}")


def offline_rows(torch, out, dev):
    """The bsr_matvec row of the kernels line: the launch the offline
    path makes, on G's BSR matrix."""
    import warnings

    from repro_torch.kernels.bsr_spmv import ops as bs_ops
    from repro_torch.kernels.bsr_spmv import parity as bs_parity
    from repro_torch.kernels.bsr_spmv.ref import bsr_matvec_ref

    m = out.pop("offline")
    errs = out["errs"]
    x = torch.randn(m.n, generator=torch.Generator().manual_seed(2)).to(dev)
    order = bs_ops.stripe_order(m.counts, m.col_ids.shape[1])

    def kernel():
        return bs_ops.bsr_matvec_cuda(m.values, m.col_ids, m.counts, x, order)

    y = kernel()
    errs["bsr_matvec"] = max(errs["bsr_matvec"], bs_parity.compare(
        y, bsr_matvec_ref(m, x), "path bsr_matvec"))
    ms = cuda_ms(kernel, 20)
    plain = cuda_ms(lambda: bsr_matvec_ref(m, x), 3)
    real_bytes, stored_bytes = bsr_bytes(m)
    # the library call: cuSPARSE's BSR matvec through
    # torch.sparse_bsr_tensor on the same matrix, padding slots dropped
    # (a padding slot repeats column 0 in its stripe)
    real = m.values.ne(0).flatten(2).any(-1)
    crow = torch.zeros(real.shape[0] + 1, dtype=torch.int64, device=dev)
    crow[1:] = real.sum(1).cumsum(0)
    col = m.col_ids[real].long()
    vals = m.values[real]
    lib_bytes = vals.numel() * 4 + col.numel() * 8 + crow.numel() * 8 \
        + 2 * 4 * m.n
    library = None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a = torch.sparse_bsr_tensor(crow, col, vals, (m.n, m.n))
            lib_err = float((a @ x - y).abs().max())
            library = cuda_ms(lambda: a @ x, 20)
        print(f"  library: torch.sparse_bsr_tensor(...) @ x on the "
              f"{vals.shape[0]} real blocks ({lib_bytes} B to move): "
              f"{library:.4f} ms, max |diff| vs the kernel {lib_err:.3e}")
    except Exception as e:  # the yardstick only; the port never calls it
        print(f"  library: torch.sparse_bsr_tensor(...) @ x refused: "
              f"{type(e).__name__}: {e}")
    # what the kernel reads: each stripe's counts real slots (values and
    # col ids), the counts and the order, x once; it writes y
    n_rb, max_bpr, b = m.values.shape[:3]
    blocks = int(m.counts.sum())
    if blocks != int(real.sum()):
        raise AssertionError(f"bsr_matvec: the counts name {blocks} real "
                             f"blocks, the values hold {int(real.sum())}")
    read_values = blocks * b * b * 4
    read_bytes = read_values + blocks * 4 + 2 * n_rb * 4 + 2 * 4 * m.n
    print(f"  bsr_matvec on G: (n_rb, max_bpr, b)={(n_rb, max_bpr, b)}: the "
          f"kernel reads the {blocks} real blocks only, {read_values} B of "
          f"values (the real blocks' bytes: {int(real.sum()) * b * b * 4} "
          f"B) and {read_bytes} B in all, "
          f"{read_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms at 3.35 TB/s, "
          f"{read_bytes / (ms * 1e-3) / 1e12:.3f} TB/s achieved; "
          f"{stored_bytes} B are stored with the padding; the bound counts "
          f"{real_bytes} B (every col id)")
    row = {"name": "bsr_matvec", "route": "cuda",
           "source": "src/repro_torch/csrc/bsr_spmv.cu",
           "replaces": "src/repro/kernels/bsr_spmv/kernel.py:37",
           "launches": out["launches"]["bsr_matvec"],
           "max_abs_err": errs["bsr_matvec"], "ms": ms, "plain_ms": plain,
           "bound_ms": real_bytes / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": library}
    print_row(row)
    return [row]


class FleetTenants:
    """Phase 8's tenants and their host mirrors, one mirror a pool.

    ``small`` and ``large`` are dense `Fleet` mirrors in the tenants'
    own node spaces (tenant b of ``small`` has node ids [0, n_u[b])),
    ``virtual`` a `SparseFleet` whose tenants address their 256–1024
    active ids in a 2²⁰-id space; its tenant 0, the spill tenant, holds
    ids in [0, N_PAD) and admits while ``large`` is full, so that it
    lands in ``virtual`` and can be promoted into ``large`` later.
    Tenant names are ``s<b>``, ``l<b>`` and ``v<b>``. Dense ticks send
    only the lanes whose endpoints are active (`Fleet.tick_arrays`'s
    ``gated_only``), so no delta addresses a slot a compaction dropped.
    """

    SPILL = 0

    def __init__(self, seed: int):
        import numpy as np

        self.np = np
        n_s, n_l, n_v = FLEET_TENANTS
        self.mirrors = {
            "small": Fleet(n_s, seed, n_lo=128, n_hi=FLEET_POOLS[0][1]),
            "large": Fleet(n_l, seed + 1, n_lo=FLEET_POOLS[0][1] + 1,
                           n_hi=FLEET_POOLS[1][1]),
            "virtual": SparseFleet(n_v, seed + 2)}
        self.prefix = {"small": "s", "large": "l", "virtual": "v"}
        v = self.mirrors["virtual"]
        v.vid[self.SPILL] = v.rng.permutation(N_PAD)
        self.n_nodes = {k: m.n_u.copy() for k, m in self.mirrors.items()
                        if k != "virtual"}

    def name(self, key: str, b: int) -> str:
        return f"{self.prefix[key]}{b}"

    def row(self, name: str):
        key = {"s": "small", "l": "large", "v": "virtual"}[name[0]]
        return key, int(name[1:])

    def graph(self, key: str, b: int):
        """Tenant b's initial graph: an `EdgeList` in its own node space
        (virtual tenants: the 2²⁰-id space; the spill tenant: N_PAD)."""
        import torch

        from repro_torch.graphs.types import EdgeList

        np, m = self.np, self.mirrors[key]
        nz = np.flatnonzero(m.w[b])
        lo, hi = m.endpoints(nz[None, :], slice(b, b + 1))
        if key != "virtual":
            n = int(m.n_u[b])
            return EdgeList.from_arrays(
                lo[0], hi[0], m.w[b, nz], n_nodes=n,
                node_mask=m.active[b, :n].astype(np.float32))
        n = N_PAD if b == self.SPILL else N_VIRTUAL
        mask = np.zeros(n, np.float32)
        v = m.vid[b]
        mask[v[np.flatnonzero(m.active[b])]] = 1.0
        return EdgeList.from_arrays(v[lo[0]], v[hi[0]], m.w[b, nz],
                                    n_nodes=n,
                                    node_mask=torch.from_numpy(mask))

    def tick(self, live, burst=None, quiet=(), grow=()):
        """One fleet tick's tenant-space deltas for the ``live`` names;
        every mirror follows its tick. ``burst`` maps a pool to its
        planted rows; ``quiet`` rows (of ``small``) send an empty delta;
        ``grow`` rows of ``small`` send 8 joins of fresh ids past their
        node space and nothing else."""
        import dataclasses

        from repro_torch.graphs.types import GraphDelta

        np = self.np
        burst = burst or {}
        out = {}
        for key, m in self.mirrors.items():
            rows = burst.get(key, ())
            if key == "virtual":
                vds = m.virtual_deltas(N_VIRTUAL, rows)
                for b, d in enumerate(vds):
                    name = self.name(key, b)
                    if name in live:
                        out[name] = d if b != self.SPILL else \
                            dataclasses.replace(d, n_nodes=N_PAD)
                continue
            lo, hi, dw, w_old, emask, nid, nflag = m.tick_arrays(
                rows, quiet_rows=[*quiet, *grow] if key == "small" else (),
                gated_only=True)
            if key == "small":
                for b in grow:
                    n = int(self.n_nodes[key][b])
                    nid[b] = np.arange(n, n + J_PAD)
                    nflag[b] = 1.0
                    m.active[b, n:n + J_PAD] = True
                    self.n_nodes[key][b] = n + J_PAD
            t = host_tensor
            f = dict(senders=t(lo, "int32"), receivers=t(hi, "int32"),
                     dw=t(dw, "float32"), w_old=t(w_old, "float32"),
                     mask=t(emask, "float32"), node_ids=t(nid, "int32"),
                     node_flag=t(nflag, "float32"))
            n_nodes = self.n_nodes[key]
            for b in range(m.b):
                name = self.name(key, b)
                if name in live:
                    out[name] = GraphDelta(
                        n_nodes=int(n_nodes[b]),
                        **{k: v[b] for k, v in f.items()})
        return out

    def snapshot(self, names):
        """The sampled tenants' mirror rows before a tick."""
        out = {}
        for name in names:
            key, b = self.row(name)
            m = self.mirrors[key]
            out[name] = (m.w[b].copy(), m.active[b].copy())
        return out

    def worst(self, names, before, scores, dev) -> float:
        """Largest |score − batch jsdist_tilde| over ``names``, on the
        mirrors' graphs before and after the tick (relabelled into the
        local N_PAD layout)."""
        from repro_torch.core.jsdist import jsdist_tilde

        worst = 0.0
        for name in names:
            key, b = self.row(name)
            m = self.mirrors[key]
            g0 = m.graph_at(b, *before[name], dev)
            g1 = m.graph_at(b, m.w[b], m.active[b], dev)
            # one sampled tenant's check, outside the timed ticks
            worst = max(worst, abs(float(jsdist_tilde(g0, g1))  # lint: disable=per-item-host-sync
                                   - float(scores[name])))
        return worst


def fleet_config(directory: str, stacked: bool = True):
    """Phase 8's `FleetConfig`: FLEET_POOLS, each at k_pad = 128, j_pad =
    8 with exact s_max, compaction below half occupancy."""
    from repro_torch.fleet import FleetConfig, PoolSpec

    pools = []
    for name, n_pad, shards, b, method in FLEET_POOLS:
        extra = dict(n_slots=SP_SLOTS, m_pad=SP_M_PAD) \
            if method == "sparse_tick" else {}
        pools.append(PoolSpec(name=name, n_pad=n_pad, shards=shards,
                              streams_per_shard=b, k_pad=K_PAD, j_pad=J_PAD,
                              method=method, exact_smax=True, **extra))
    return FleetConfig(pools=tuple(pools), directory=directory,
                       compact_occupancy=0.5, stacked_ticks=stacked)


def fleet_bits(torch, fleet) -> dict:
    """Every live shard's state and every tenant's score, on the host."""
    torch.cuda.synchronize()
    bits = {(p, s, k): v.cpu().numpy()
            for p, s in fleet.live_shard_ids()
            for k, v in fleet.shard_service(p, s).states().tensors().items()}
    bits["scores"] = fleet.scores()
    return bits


def check_fleet_bits(label, got, *others) -> None:
    """Raise unless every `fleet_bits` in ``others`` equals ``got`` bit
    for bit (scores compared as floats, which are the bits)."""
    import numpy as np

    for other in others:
        if other.keys() != got.keys() or other["scores"] != got["scores"]:
            raise AssertionError(f"{label}: scores or shards differ")
        for k, v in got.items():
            if k != "scores" and not np.array_equal(v, other[k]):
                raise AssertionError(f"{label}: {k} differs")


class FleetTicker:
    """Drives one `FingerFleet` tick by tick, timing each part and
    counting launches by entry point."""

    def __init__(self, torch, fleet, tenants, dev):
        self.torch, self.fleet, self.tenants, self.dev = \
            torch, fleet, tenants, dev
        self.log = []

    def run(self, deltas=None, staged=None, **tick_kw):
        """ingest (the given deltas or the tenants' next tick) → ``staged``
        (called with a tick staged) → poll → scores. Returns the deltas
        ingested and the scores."""
        import time as _time

        from repro_torch.kernels.sparse_tick import ops as sp_ops
        from repro_torch.kernels.stream_tick import ops as st_ops

        torch, fleet = self.torch, self.fleet
        if deltas is None:
            deltas = self.tenants.tick(set(fleet.directory.names()),
                                       **tick_kw)
        before = dict(st_ops.LAUNCHES) | dict(sp_ops.LAUNCHES)
        torch.cuda.synchronize()
        h0 = _time.perf_counter()
        fleet.ingest(deltas)
        h1 = _time.perf_counter()
        if staged is not None:
            staged()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        h2 = _time.perf_counter()
        ev0.record()
        fleet.poll()
        ev1.record()
        h3 = _time.perf_counter()
        scores = fleet.scores()
        h4 = _time.perf_counter()
        ev1.synchronize()
        after = dict(st_ops.LAUNCHES) | dict(sp_ops.LAUNCHES)
        self.log.append({
            "ingest_ms": (h1 - h0) * 1e3, "poll_host_ms": (h3 - h2) * 1e3,
            "poll_cuda_ms": ev0.elapsed_time(ev1),
            "scores_ms": (h4 - h3) * 1e3,
            "wall_ms": (h1 - h0 + h4 - h2) * 1e3,
            "launches": {k: after[k] - before[k] for k in after},
            "poll_launches": fleet.last_poll_launches})
        return deltas, scores

    def expect(self, label, stacked: int, sparse_stacked: int = 1,
               single: int = 0, sparse_single: int = 0) -> None:
        got = self.log[-1]["launches"]
        want = {"stream_tick_stacked": stacked,
                "sparse_tick_stacked": sparse_stacked,
                "stream_tick": single, "sparse_tick": sparse_single}
        if got != want:
            raise AssertionError(f"{label}: launches {got} != {want}")
        if self.log[-1]["poll_launches"] != sum(want.values()):
            raise AssertionError(
                f"{label}: last_poll_launches "
                f"{self.log[-1]['poll_launches']} != {sum(want.values())}")



class FleetPhase:
    """Phase 8, step by step: admission, the steady ticks, the events
    (growth, a sparse→dense promotion, a staged compaction, save and
    two restores, a shard's death and recovery), each followed by a
    tick whose sampled scores are checked."""

    def __init__(self, args, torch, dev):
        import shutil

        import numpy as np

        self.np, self.torch, self.dev = np, torch, dev
        self.root = Path(__file__).resolve().parent / "build" / "fleet"
        shutil.rmtree(self.root, ignore_errors=True)
        t0 = time.perf_counter()
        self.tenants = FleetTenants(args.seed + 5)
        self.mirrors_s = time.perf_counter() - t0
        self.rng = np.random.default_rng(args.seed + 6)
        self.worst = {}

    # -- helpers ---------------------------------------------------------
    def checked(self, ticker, label, skip=(), **kw):
        """One tick through ``ticker`` whose sampled scores must be
        within 5e-3 of batch jsdist_tilde of the mirrors' graphs."""
        np, fleet = self.np, ticker.fleet
        names = [n for n in self.sampled if n in fleet.directory
                 and n not in skip]
        before = self.tenants.snapshot(names)
        deltas, scores = ticker.run(**kw)
        if not all(np.isfinite(v) for v in scores.values()):
            raise AssertionError(f"{label}: non-finite scores")
        self.worst[label] = self.tenants.worst(names, before, scores,
                                               self.dev)
        if self.worst[label] > 5e-3:
            raise AssertionError(
                f"{label}: sampled scores differ from batch jsdist_tilde "
                f"by {self.worst[label]:.3e} > 5e-3")
        return deltas, scores

    def timed(self, fn):
        """``fn()`` and its seconds to a synchronize."""
        t0 = time.perf_counter()
        res = fn()
        self.torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # -- admission -------------------------------------------------------
    def admit_all(self) -> None:
        """Open the fleet and admit every tenant, each checked to land in
        its best-fit pool by an independent count of the pools."""
        from repro_torch.fleet import FingerFleet
        from repro_torch.graphs.types import EdgeList

        tenants, torch = self.tenants, self.torch
        fleet, open_s = self.timed(lambda: FingerFleet.open(
            fleet_config(str(self.root / "a")), device=self.dev))
        caps = [p.capacity for p in fleet.config.pools]
        counts = [0] * len(caps)

        def admit(name, graph):
            n = int(graph.n_nodes)
            want = next(i for i, p in enumerate(fleet.config.pools)
                        if n <= p.n_pad and counts[i] < caps[i])
            entry = fleet.admit(name, graph)
            if entry.pool != want:
                raise AssertionError(f"tenant {name} of {n} nodes placed "
                                     f"in pool {entry.pool}, best fit {want}")
            counts[want] += 1

        graph_s = [0.0]

        def admit_pool(key):
            """Seconds in `admit` (the graphs are made one at a time,
            timed apart)."""
            spent = 0.0
            for b in range(tenants.mirrors[key].b):
                t0 = time.perf_counter()
                graph = tenants.graph(key, b)
                t1 = time.perf_counter()
                admit(tenants.name(key, b), graph)
                spent += time.perf_counter() - t1
                graph_s[0] += t1 - t0
            torch.cuda.synchronize()
            return spent

        admit_s = {key: admit_pool(key) for key in ("small", "large")}
        # fill the large pool, so that the spill tenant overflows into
        # the sparse bucket; the fillers leave before the first tick
        fillers = [f"f{i}" for i in range(caps[1] - counts[1])]
        filler = EdgeList.from_arrays([0], [1], [1.0],
                                      n_nodes=FLEET_POOLS[0][1] + 1)
        t0 = time.perf_counter()
        for name in fillers:
            admit(name, filler)
        fill_s = time.perf_counter() - t0
        admit_s["virtual"] = admit_pool("virtual")
        t0 = time.perf_counter()
        for name in fillers:
            fleet.evict(name)
        fill_s += time.perf_counter() - t0
        self.spill = tenants.name("virtual", tenants.SPILL)
        print(f"  opened pools {[(p.name, p.n_pad, p.shards, p.streams_per_shard, p.method) for p in fleet.config.pools]}, "
              f"k_pad={K_PAD} j_pad={J_PAD} exact_smax: mirrors "
              f"{self.mirrors_s:.1f} s, open {open_s:.1f} s, the tenants' "
              f"graphs {graph_s[0]:.1f} s")
        for (key, s), n in zip(admit_s.items(), FLEET_TENANTS):
            print(f"  admitted {n} {key} tenants in {s:.2f} s, "
                  f"{s / n * 1e3:.3f} ms a tenant, each in its best-fit "
                  "pool")
        print(f"  {len(fillers)} fillers of the large pool admitted and "
              f"evicted in {fill_s:.2f} s; the spill tenant {self.spill} "
              f"({N_PAD} ids) placed in pool "
              f"{fleet.directory.get(self.spill).pool} while large was full")
        self.fleet = fleet
        self.ticker = FleetTicker(torch, fleet, tenants, self.dev)

    def choose(self) -> None:
        """The planted, grown, sampled tenants and the shards of the
        events."""
        np, rng, tenants = self.np, self.rng, self.tenants
        fleet = self.fleet
        b = {k: m.b for k, m in tenants.mirrors.items()}
        self.planted_rows = {
            "small": sorted(int(x) for x in rng.choice(b["small"], 2,
                                                       replace=False)),
            "large": [int(rng.integers(b["large"]))],
            "virtual": [int(rng.integers(1, b["virtual"]))]}
        self.planted = sorted(tenants.name(k, r) for k, rows in
                              self.planted_rows.items() for r in rows)
        n_u = tenants.mirrors["small"].n_u
        big = [x for x in np.flatnonzero(n_u > FLEET_POOLS[0][1] - J_PAD)
               if x not in self.planted_rows["small"]]
        self.grow_rows = sorted(int(x) for x in rng.choice(
            big, FLEET_GROWN, replace=False))
        self.kill_shard, self.compact_shard = 2, 3
        dead = [e.name for e in fleet.directory.tenants_on(0, 2)]
        sampled = set(self.planted) | {self.spill} \
            | {tenants.name("small", x) for x in self.grow_rows[:2]} \
            | set(rng.choice(dead, 8, replace=False).tolist())
        for key, count in (("small", 16), ("large", 20), ("virtual", 14)):
            sampled |= {tenants.name(key, int(x)) for x in
                        rng.choice(b[key], count, replace=False)}
        self.sampled = sorted(sampled)

    # -- the steady ticks --------------------------------------------------
    def steady(self, out) -> None:
        """FLEET_TICKS ticks of the phase-3 mix, bursts planted on the
        last; the stacked inputs of tick FLEET_TICKS // 2 are kept for
        the kernels line."""
        from repro_torch.fleet import pooltick

        torch, ticker = self.torch, self.ticker
        captured = {}
        stack_states, stack_deltas = pooltick.stack_states, \
            pooltick.stack_deltas

        def capture_states(seq):
            st = stack_states(seq)
            captured.setdefault(("states", tuple(st.strengths.shape)),
                                st.map_tensors(torch.clone))
            return st

        def capture_deltas(seq, device):
            d = stack_deltas(seq, device)
            captured.setdefault(("deltas", tuple(d.dw.shape)), d)
            return d

        for t in range(FLEET_TICKS):
            if t == FLEET_TICKS // 2:
                pooltick.stack_states = capture_states
                pooltick.stack_deltas = capture_deltas
            try:
                if t == FLEET_TICKS - 1:
                    self.checked(ticker, "steady", burst=self.planted_rows)
                else:
                    ticker.run()
            finally:
                pooltick.stack_states = stack_states
                pooltick.stack_deltas = stack_deltas
            ticker.expect(f"steady tick {t}", stacked=2)
        top = [n for n, _ in self.fleet.top_anomalies(4)]
        if sorted(top) != self.planted:
            raise AssertionError(f"fleet top-4 {top} != planted "
                                 f"{self.planted}")
        out["fleet_snaps"] = captured
        report_ticks("steady, stacked", ticker.log[1:], self.fleet)
        print(f"  top-4 {top} == planted {self.planted}; "
              f"{len(self.sampled)} sampled scores vs batch jsdist_tilde: "
              f"max |diff| {self.worst['steady']:.3e} (bound 5e-3)")

    # -- the events --------------------------------------------------------
    def growth_and_spill(self) -> None:
        """8 small tenants join 8 fresh ids each and outgrow 256:
        `ensure_capacity` promotes them live during `ingest`; then the
        spill tenant moves sparse → dense into ``large``."""
        np, torch, fleet, tenants = self.np, self.torch, self.fleet, \
            self.tenants
        pauses = []
        promote = fleet.rebalancer.promote

        def timed_promote(*a, **kw):
            report, s = self.timed(lambda: promote(*a, **kw))
            pauses.append(s)
            return report

        fleet.rebalancer.promote = timed_promote
        try:
            self.checked(self.ticker, "growth", grow=self.grow_rows)
        finally:
            del fleet.rebalancer.promote
        moved = [fleet.directory.get(tenants.name("small", b)).pool
                 for b in self.grow_rows]
        if moved != [1] * FLEET_GROWN or len(pauses) != FLEET_GROWN:
            raise AssertionError(f"grown tenants in pools {moved} after "
                                 f"{len(pauses)} promotions")
        self.ticker.expect("growth tick", stacked=2)
        _, spill_s = self.timed(
            lambda: fleet.promote(self.spill, to_pool="large"))
        self.checked(self.ticker, "spill promotion")
        if fleet.directory.get(self.spill).pool != 1:
            raise AssertionError("the spill tenant did not move to large")
        self.ticker.expect("spill tick", stacked=2)
        print(f"  growth tick: {FLEET_GROWN} small tenants promoted live by "
              f"ensure_capacity, pauses median "
              f"{np.median(pauses) * 1e3:.2f} ms (max "
              f"{max(pauses) * 1e3:.2f}); promote({self.spill!r}, 'large') "
              f"sparse→dense {spill_s * 1e3:.2f} ms; sampled max |diff| "
              f"{self.worst['growth']:.3e}, "
              f"{self.worst['spill promotion']:.3e}")

    def compaction(self) -> None:
        """Evict the tenants of one small shard whose mirror has a node
        active at or above half its layout, then `rebalance()` under a
        staged tick: the shard compacts and ticks in a group of its own
        (its staying tenants send an empty delta that tick)."""
        np, fleet, tenants = self.np, self.fleet, self.tenants
        small = tenants.mirrors["small"]
        half = FLEET_POOLS[0][1] // 2
        keep, evict = [], []
        for e in fleet.directory.tenants_on(0, self.compact_shard):
            b = tenants.row(e.name)[1]
            top = int(np.flatnonzero(small.active[b]).max())
            (keep if top < half - 1 else evict).append(e.name)
        if not keep:
            raise AssertionError("no tenant stays on the compacted shard")
        _, evict_s = self.timed(lambda: [fleet.evict(n) for n in evict])
        self.sampled = [n for n in self.sampled if n not in evict] \
            + keep[:2]
        actions = []

        def rebalance():
            res, s = self.timed(fleet.rebalance)
            actions.extend(res)
            actions.append(s)

        self.checked(self.ticker, "compaction", staged=rebalance,
                     quiet=[tenants.row(n)[1] for n in keep])
        compact_s = actions.pop()
        if [(a["pool"], a["shard"]) for a in actions] != \
                [(0, self.compact_shard)] or actions[0]["new_n_pad"] >= half:
            raise AssertionError(f"rebalance: {actions}")
        self.ticker.expect("compaction tick", stacked=3)
        self.checked(self.ticker, "after compaction")
        self.ticker.expect("tick after the compaction", stacked=3)
        print(f"  evicted {len(evict)} tenants of shard small/"
              f"{self.compact_shard} in {evict_s * 1e3:.1f} ms ({len(keep)} "
              f"stay); rebalance() under a staged tick compacted it "
              f"{actions[0]['old_n_pad']} → {actions[0]['new_n_pad']} in "
              f"{compact_s * 1e3:.2f} ms; then "
              f"{self.ticker.log[-1]['poll_launches']} launches a tick; "
              f"sampled max |diff| {self.worst['compaction']:.3e}, "
              f"{self.worst['after compaction']:.3e}")

    def save_restore(self) -> None:
        """Save the fleet; restore it twice (stacked, and shard by shard
        from a copy of the directory), each bit-equal with the saved
        state; FLEET_RESTORED_TICKS ticks through both, bit-equal."""
        import shutil

        from repro_torch.fleet import FingerFleet

        torch, tenants = self.torch, self.tenants
        _, save_s = self.timed(self.fleet.save)
        saved = fleet_bits(torch, self.fleet)
        self.fleet.close()
        shutil.copytree(self.root / "a", self.root / "b")
        fleets, restore_s = {}, {}
        for key, stacked in (("a", True), ("b", False)):
            fleets[key], restore_s[key] = self.timed(
                lambda: FingerFleet.restore(
                    fleet_config(str(self.root / key), stacked),
                    device=self.dev))
            check_fleet_bits(f"restore {key}", saved,
                             fleet_bits(torch, fleets[key]))
        tickers = {k: FleetTicker(torch, f, tenants, self.dev)
                   for k, f in fleets.items()}
        live = set(fleets["a"].directory.names())
        for t in range(FLEET_RESTORED_TICKS):
            deltas, _ = self.checked(tickers["a"], f"restored {t}")
            tickers["a"].expect(f"restored tick {t}", stacked=3)
            tickers["b"].run(deltas=deltas)
            tickers["b"].expect(f"restored tick {t}, shard by shard",
                                stacked=0, sparse_stacked=0,
                                single=FLEET_POOLS[0][2] + FLEET_POOLS[1][2],
                                sparse_single=FLEET_POOLS[2][2])
            check_fleet_bits(f"restored tick {t}",
                             fleet_bits(torch, fleets["a"]),
                             fleet_bits(torch, fleets["b"]))
        if live != set(fleets["b"].directory.names()):
            raise AssertionError("the two restores hold different tenants")
        print(f"  save {save_s:.2f} s ({len(live)} tenants, "
              f"{sum(p.shards for p in fleets['a'].config.pools)} shard "
              f"checkpoints and fleet.json); restore stacked "
              f"{restore_s['a']:.2f} s, shard by shard {restore_s['b']:.2f} "
              "s, both bit-equal with the saved state")
        report_ticks("restored, stacked", tickers["a"].log, fleets["a"])
        report_ticks("restored, shard by shard", tickers["b"].log,
                     fleets["b"])
        print(f"  {FLEET_RESTORED_TICKS} ticks through both restores "
              "bit-equal (scores and every shard's state); sampled max "
              "|diff| " + ", ".join(f"{self.worst[f'restored {t}']:.3e}"
                                    for t in range(FLEET_RESTORED_TICKS)))
        fleets["b"].close()
        self.fleet = fleets["a"]
        self.ticker = tickers["a"]

    def kill_recover(self) -> None:
        """Kill one small shard of the restored fleet, one WAL-only tick,
        then recovery from the shard's checkpoint and the WAL since the
        save."""
        fleet, shard = self.fleet, self.kill_shard
        dead = {e.name for e in fleet.directory.tenants_on(0, shard)}
        _, kill_s = self.timed(lambda: fleet.kill_shard("small", shard))
        self.checked(self.ticker, "WAL-only", skip=dead)
        self.ticker.expect("WAL-only tick", stacked=3)
        reports, recover_s = self.timed(fleet.recover)
        if {r["tenant"] for r in reports} != dead:
            raise AssertionError("recover() did not rebuild every tenant "
                                 "of the dead shard")
        self.checked(self.ticker, "recovered")
        self.ticker.expect("tick after recovery", stacked=3)
        print(f"  kill_shard('small', {shard}) {kill_s * 1e3:.1f} ms; a "
              f"WAL-only tick; recover() rebuilt {len(reports)} tenants from "
              f"the shard's checkpoint and their WAL in {recover_s:.2f} s "
              f"({recover_s / len(reports) * 1e3:.2f} ms a tenant); sampled "
              f"max |diff| {self.worst['WAL-only']:.3e}, "
              f"{self.worst['recovered']:.3e}")


def report_ticks(label, log, fleet) -> None:
    """The medians of a run of fleet ticks."""
    import numpy as np

    streams = sum(p.capacity for p in fleet.config.pools)
    med = {k: float(np.median([r[k] for r in log]))
           for k in ("ingest_ms", "poll_host_ms", "poll_cuda_ms",
                     "scores_ms", "wall_ms")}
    print(f"  {label}, {len(log)} ticks (medians): host ingest "
          f"{med['ingest_ms']:.1f} ms, poll {med['poll_host_ms']:.3f} ms host "
          f"/ {med['poll_cuda_ms']:.3f} ms CUDA events, scores "
          f"{med['scores_ms']:.1f} ms; the loop (ingest + poll + scores) "
          f"{med['wall_ms']:.1f} ms a tick, {streams / med['wall_ms'] * 1e3:.4g} "
          f"stream-ticks/s ({len(fleet.directory)} tenants in {streams} "
          f"slots), {log[-1]['poll_launches']} launches a poll")


def phase_fleet(args, torch, out, dev):
    """Phase 8: the multi-tenant fleet through the pool-stacked ticks."""
    import shutil

    ph = FleetPhase(args, torch, dev)
    zero_counts()
    ph.admit_all()
    ph.choose()
    ph.steady(out)
    ph.growth_and_spill()
    ph.compaction()
    ph.save_restore()
    ph.kill_recover()
    ph.fleet.close()
    shutil.rmtree(ph.root, ignore_errors=True)
    got = read_counts(out)
    print(f"  launches on the fleet path: {got}")
    if not (got["stream_tick_stacked"] and got["sparse_tick_stacked"]):
        raise AssertionError("a stacked kernel was never launched on the "
                             "fleet path")


def fleet_rows(torch, out):
    """The stacked rows of the kernels line, each timed in place on a
    copy of a fleet tick's stacked state and delta (the large and the
    virtual pool's groups), and each group's stack and unstack timed
    apart from the kernel."""
    from repro_torch.fleet import pooltick
    from repro_torch.kernels.sparse_tick import ops as sp_ops
    from repro_torch.kernels.sparse_tick import parity as sp_parity
    from repro_torch.kernels.sparse_tick.ref import sparse_tick_ref
    from repro_torch.kernels.stream_tick import ops as st_ops
    from repro_torch.kernels.stream_tick import parity as st_parity
    from repro_torch.kernels.stream_tick.ref import stream_tick_ref

    snaps = out.pop("fleet_snaps")
    errs, rows = out["errs"], []
    shapes = {"stream_tick_stacked": (FLEET_POOLS[1][2], FLEET_POOLS[1][3],
                                      FLEET_POOLS[1][1]),
              "sparse_tick_stacked": (FLEET_POOLS[2][2], FLEET_POOLS[2][3],
                                      SP_SLOTS)}
    for name, (s, b, n) in shapes.items():
        sparse = name == "sparse_tick_stacked"
        snap = snaps[("states", (s, b, n))]
        deltas = snaps[("deltas", (s, b, K_PAD))]
        fn = sp_ops.sparse_tick_fused_stacked if sparse \
            else st_ops.stream_tick_fused_stacked
        ref = sparse_tick_ref if sparse else stream_tick_ref
        parity = sp_parity if sparse else st_parity
        work = snap.map_tensors(torch.clone)

        def restore(work=work, snap=snap):
            for f, x in work.tensors().items():
                x.copy_(getattr(snap, f))

        want = ref(snap, deltas, exact_smax=True)
        got = fn(work, deltas, exact_smax=True, inplace=True)
        errs[name] = max(errs[name], parity.compare(got, want, name))
        if sparse:
            bound_bytes = sparse_bytes(snap, work, deltas)[0]
        else:
            k, j = deltas.dw.shape[-1], deltas.node_ids.shape[-1]
            changed = int((work.strengths != snap.strengths).sum()) \
                + int((work.node_mask != snap.node_mask).sum())
            # read: 3 scalars, the strength and mask rows, the delta;
            # written: dist, 3 scalars and the elements that change
            bound_bytes = s * b * (4 * 3 + 8 * n + 20 * k + 8 * j) \
                + s * b * 16 + 4 * changed
        del got, want
        ms = cuda_ms(lambda: fn(work, deltas, exact_smax=True,
                                inplace=True), 50, setup=restore)
        plain = cuda_ms(lambda: ref(snap, deltas, exact_smax=True), 5)
        # the group's stack and unstack apart from the kernel: S shard
        # states and queued deltas of their own, as the pool tick gets
        states_seq = [snap.map_tensors(lambda x, i=i: x[i].clone())
                      for i in range(s)]
        deltas_seq = [deltas.map_tensors(lambda x, i=i: x[i].clone())
                      for i in range(s)]
        dev = snap.q.device
        stack_ms = cuda_ms(lambda: (pooltick.stack_states(states_seq),
                                    pooltick.stack_deltas(deltas_seq, dev)),
                           20)
        dists = torch.zeros((s, b), device=dev)
        t0 = time.perf_counter()
        for _ in range(100):
            pooltick.unstack(dists, work, s)
        unstack_ms = (time.perf_counter() - t0) * 10
        print(f"  {name} S,B,n,k={(s, b, n, K_PAD)}: in place {ms:.4f} ms "
              f"(bound {bound_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms, "
              f"{bound_bytes} B); the group's stack of its {s} shards' "
              f"states and deltas {stack_ms:.4f} ms (CUDA events), its "
              f"unstack into views {unstack_ms:.4f} ms of host time")
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/"
                      + ("sparse_tick.cu" if sparse else "stream_tick.cu"),
            "replaces": ("src/repro/kernels/sparse_tick/kernel.py:251"
                         if sparse else
                         "src/repro/kernels/stream_tick/kernel.py:242"),
            "launches": out["launches"][name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "stack_ms": stack_ms, "unstack_host_ms": unstack_ms})
        print_row(rows[-1])
        del work, states_seq, deltas_seq
    return rows


def phase_sharded(args, torch, out, dev):
    """Phase 9: the sharded and multipod placements against the local
    one, sharded sparse serving, distributed FINGER and gradient
    compression with an elastic restore."""
    took = []

    def part(name, fn, *fn_args):
        t0 = time.perf_counter()
        fn(*fn_args)
        took.append(f"{name} {time.perf_counter() - t0:.1f} s")

    part("placements", sharded_serve, args, torch, out, dev)
    # the gloo ranks start up (imports, CUDA, the graph, the process
    # group) while the sparse part runs, and wait for a go from part 3
    root, procs = start_gloo_ranks(out)
    try:
        part("sparse", sharded_sparse, torch, out, dev)
        part("distributed FINGER", dist_finger_phase, torch, out, dev,
             root, procs)
    finally:
        for proc in procs:
            if proc.poll() is None:  # a part failed before the go
                proc.kill()
                proc.wait()
    part("compression", compressed_steps, args, torch, out, dev)
    print("  phase 9 by part: " + ", ".join(took))


def placement_checks(torch, svcs, k, label) -> None:
    """Scores bit-equal to the local service's; the global top-k equal
    in values and ids; each pod's top-k equal to the local top-k over
    that pod's streams."""
    import numpy as np

    local = svcs["local"]
    want = local.scores()
    vals, ids = local.top_anomalies(k)
    for name, svc in svcs.items():
        if not np.array_equal(svc.scores(), want, equal_nan=True):
            raise AssertionError(f"{label}: {name} scores differ")
        v, i = svc.top_anomalies(k)
        if not (np.array_equal(v, vals) and np.array_equal(i, ids)):
            raise AssertionError(f"{label}: {name} top-{k} {i} != {ids}")
    pv, pids = svcs["multipod"].top_anomalies(k, per_pod=True)
    per = len(want) // PODS[0]
    for pod in range(PODS[0]):
        lo = pod * per
        v, i = local.plan.topk(torch.from_numpy(want[lo:lo + per]).to(
            local.device), k)
        if not (np.array_equal(pv[pod], v.cpu().numpy())
                and np.array_equal(pids[pod], i.cpu().numpy() + lo)):
            raise AssertionError(f"{label}: pod {pod} top-{k} "
                                 f"{pids[pod]} != {i.tolist()} + {lo}")


def sharded_serve(args, torch, out, dev):
    """Phase 9, part 1: phase 3's checkpoint restored local, sharded
    over SHARDS logical shards and multipod over PODS, all on the one
    card, fed the same ticks of phase 3's mix double-buffered; a repad
    and more ticks; the sharded service's save restored local."""
    import shutil

    import numpy as np

    from repro_torch.distributed import Sharded, make_grid
    from repro_torch.kernels.stream_tick import ops as st_ops
    from repro_torch.serving import FingerService

    root, ticks_after, cfg = out.pop("serve_a")
    grids = {"local": None,
             "sharded": make_grid((SHARDS,), ("data",), dev),
             "multipod": make_grid(PODS, ("pod", "data"), dev)}
    svcs, restore_s = {}, {}
    for name, grid in grids.items():
        t0 = time.perf_counter()
        svcs[name] = FingerService.restore(
            cfg.with_(placement=name, ingestion="double_buffered"),
            directory=str(root), device=None if grid else dev, grid=grid)
        torch.cuda.synchronize()
        restore_s[name] = time.perf_counter() - t0
    want = state_bits(torch, svcs["local"])
    for name in ("sharded", "multipod"):
        check_same(f"{name} restore", want, state_bits(torch, svcs[name]))
    b, k = cfg.batch_size, cfg.topk.k
    host_ms = {n: [] for n in svcs}
    poll_ms = {n: [] for n in svcs}
    launches = dict.fromkeys(svcs, 0)
    snap, reports = None, {}
    zero_counts()
    for t in range(PH9_TICKS + PH9_REPAD_TICKS):
        if t == PH9_TICKS:
            for svc in svcs.values():
                svc.repad(2 * N_PAD)
        d = ticks_after[t]
        if t >= PH9_TICKS:
            d = dataclasses.replace(d, n_nodes=2 * N_PAD)
        for name, svc in svcs.items():
            if name == "sharded" and t == PH9_TICKS // 2:
                # the shards' states before this tick and their deltas,
                # for the per-shard kernel times below
                snap = (svc.states().map(
                    lambda st: st.map_tensors(torch.clone)),
                    svc.plan.put_deltas(d))
            n0 = st_ops.LAUNCHES["stream_tick"]
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            svc.ingest(d)
            ev0.record()
            reports[name] = svc.poll()
            ev1.record()
            ev1.synchronize()
            if t < PH9_TICKS:
                host_ms[name].append((time.perf_counter() - h0) * 1e3)
                poll_ms[name].append(ev0.elapsed_time(ev1))
            launches[name] += st_ops.LAUNCHES["stream_tick"] - n0
        placement_checks(torch, svcs, k, f"phase 9 tick {t}")
    got = read_counts(out)["stream_tick"]
    ticks = PH9_TICKS + PH9_REPAD_TICKS
    want_launches = {"local": ticks, "sharded": SHARDS * ticks,
                     "multipod": PODS[0] * PODS[1] * ticks}
    if launches != want_launches or got != sum(want_launches.values()):
        raise AssertionError(f"stream_tick launches {launches} (total "
                             f"{got}) != {want_launches}")
    live = state_bits(torch, svcs["sharded"])
    check_same("states after the repad ticks", live,
               state_bits(torch, svcs["local"]),
               state_bits(torch, svcs["multipod"]))
    for name, svc in svcs.items():
        print(f"  {name}: restore {restore_s[name]:.2f} s; {PH9_TICKS} "
              f"double-buffered ticks, one at a time: median poll "
              f"{np.median(poll_ms[name]):.3f} ms (CUDA events), median "
              f"host ingest -> poll end {np.median(host_ms[name]):.3f} ms, "
              f"{sum(host_ms[name]):.1f} ms for the {PH9_TICKS}: "
              f"{b * PH9_TICKS / (sum(host_ms[name]) / 1e3):.4g} "
              f"stream-ticks/s; stream_tick launches "
              f"{launches[name] / ticks:.0f} a tick")
    print(f"  after every tick of {ticks} (the last {PH9_REPAD_TICKS} "
          f"after repad({2 * N_PAD})): scores bit-equal, top-{k} equal "
          "in values and ids, each pod's top-k equal to the local top-k "
          "of its streams; states bit-equal at the end")

    # each shard's kernel, in place on a copy of its state, restored
    # before every call; the sharded tick whole; the top-k merge
    states, deltas = snap
    work = states.map(lambda st: st.map_tensors(torch.clone))
    shard_ms = []
    for i in range(SHARDS):
        w, s0 = work.parts[i], states.parts[i]

        def restore(w=w, s0=s0):
            for f, x in w.tensors().items():
                x.copy_(getattr(s0, f))

        shard_ms.append(cuda_ms(lambda w=w, d=deltas.parts[i]:
                                st_ops.stream_tick_fused(
                                    w, d, exact_smax=True, inplace=True),
                                20, setup=restore))

    def restore_all():
        for w, s0 in zip(work.parts, states.parts):
            for f, x in w.tensors().items():
                x.copy_(getattr(s0, f))

    plan = svcs["sharded"].plan
    whole_ms = cuda_ms(lambda: plan.tick(work, deltas), 20,
                       setup=restore_all)
    merge = {}
    for name in ("sharded", "multipod"):
        scores = reports[name].scores
        if not isinstance(scores, Sharded):
            raise AssertionError(f"{name}: unsharded scores")
        p = svcs[name].plan
        t0 = time.perf_counter()
        for _ in range(50):
            p.topk(scores, k)
        merge[name] = ((time.perf_counter() - t0) / 50 * 1e3,
                       cuda_ms(lambda p=p, s=scores: p.topk(s, k), 50))
    del work, states, deltas, snap
    print(f"  stream_tick per shard ({b // SHARDS} streams, in place, "
          f"before repad): " + ", ".join(f"{x:.4f}" for x in shard_ms)
          + f" ms; the sharded tick's {SHARDS} launches {whole_ms:.4f} ms "
          f"(CUDA events); top-{k} merge of {SHARDS}x{k} candidates: "
          + ", ".join(f"{n} {h:.3f} ms host / {c:.4f} ms CUDA events"
                      for n, (h, c) in merge.items()))

    sh = svcs["sharded"]
    t0 = time.perf_counter()
    sh.save(str(root.parent / "sharded"))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = FingerService.restore(sh.config.with_(placement="local"),
                                 directory=str(root.parent / "sharded"),
                                 device=dev)
    torch.cuda.synchronize()
    back_s = time.perf_counter() - t0
    check_same("the sharded save restored local", live,
               state_bits(torch, back))
    if back.step != sh.step or back.layout != sh.layout:
        raise AssertionError(f"restored step {back.step} layout "
                             f"{back.layout} != {sh.step} {sh.layout}")
    print(f"  the sharded service's save ({sum(v.nbytes for v in live.values()) / 1e6:.1f} MB "
          f"at n_pad {2 * N_PAD}) {save_s:.2f} s, restored as a local "
          f"service in {back_s:.2f} s, bit-equal")
    for svc in (*svcs.values(), back):
        svc.close()
    shutil.rmtree(root.parent, ignore_errors=True)


def sharded_sparse(torch, out, dev):
    """Phase 9, part 2: phase 5's checkpoint restored sharded over
    SP_SHARDS logical shards beside phase 5's restored local service;
    the tick phase 5 ran after its save, then PH9_SPARSE_TICKS more,
    bit-equal."""
    import shutil

    from repro_torch.distributed import make_grid
    from repro_torch.kernels.sparse_tick import ops as sp_ops
    from repro_torch.serving import FingerService

    local, root, fleet, caught_up, n_virtual = out.pop("sparse_live")
    grid = make_grid((SP_SHARDS,), ("data",), dev)
    t0 = time.perf_counter()
    sh = FingerService.restore(local.config.with_(placement="sharded"),
                               directory=str(root), grid=grid)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    zero_counts()
    sh.ingest(caught_up)
    sh.poll()
    check_same("the sharded sparse restore, caught up",
               state_bits(torch, local, True), state_bits(torch, sh, True))
    n_sh = []
    for t in range(PH9_SPARSE_TICKS):
        deltas = fleet.virtual_deltas(n_virtual)
        for svc in (local, sh):
            n0 = sp_ops.LAUNCHES["sparse_tick"]
            svc.ingest(deltas)
            svc.poll()
            if svc is sh:
                n_sh.append(sp_ops.LAUNCHES["sparse_tick"] - n0)
        check_same(f"sparse sharded tick {t}", state_bits(torch, local, True),
                   state_bits(torch, sh, True))
        if [m.to_json() for m in sh.slot_maps[::64]] != \
                [m.to_json() for m in local.slot_maps[::64]]:
            raise AssertionError(f"sparse sharded tick {t}: SlotMaps differ")
    got = read_counts(out)["sparse_tick"]
    if n_sh != [SP_SHARDS] * PH9_SPARSE_TICKS \
            or got != SP_SHARDS * (1 + PH9_SPARSE_TICKS) + PH9_SPARSE_TICKS:
        raise AssertionError(f"sparse_tick launches {n_sh} a tick on the "
                             f"sharded service, {got} in all")
    print(f"  sparse B={local.config.batch_size} sharded over {SP_SHARDS}: "
          f"restore {restore_s:.2f} s; the tick after phase 5's save and "
          f"{PH9_SPARSE_TICKS} more bit-equal with phase 5's local service "
          f"(scores, state, every 64th SlotMap's JSON); sparse_tick "
          f"launches {n_sh} a tick")
    for svc in (local, sh):
        svc.close()
    shutil.rmtree(root, ignore_errors=True)


def dist_finger(torch, g, rank: int, world: int, x0) -> dict:
    """Distributed FINGER on this rank's shard of ``g``: the state and
    λ_max, the seconds per iteration of a clean run, and the share of a
    second run spent in `all_reduce` (each timed between
    synchronizations, so that run is slower)."""
    import torch.distributed as dist

    from repro_torch.distributed import (distributed_finger_state,
                                         distributed_power_iteration,
                                         shard_edge_list)

    shard = shard_edge_list(g, rank, world)
    st = distributed_finger_state(shard)
    info = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam = float(distributed_power_iteration(shard, x0=x0, info=info))
    clean_s = time.perf_counter() - t0
    spent, all_reduce = [0.0], dist.all_reduce

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        all_reduce(*a, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t

    dist.all_reduce = timed
    try:
        t0 = time.perf_counter()
        lam2 = float(distributed_power_iteration(shard, x0=x0))
        timed_s = time.perf_counter() - t0
    finally:
        dist.all_reduce = all_reduce
    return {"q": float(st.q), "s_total": float(st.s_total),
            "s_max": float(st.s_max), "lam": lam, "lam_again": lam2,
            "iterations": info["iterations"],
            "s_per_iteration": clean_s / max(info["iterations"], 1),
            "all_reduce_share": spent[0] / timed_s,
            "shard_edges": int(shard.weights.numel())}


def dist_rank_main(args) -> int:
    """One gloo rank of phase 9's distributed FINGER, started by phase 9
    (``--dist-rank``): the graph and start vector from its directory,
    this rank's results into it."""
    import numpy as np
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.graphs.types import EdgeList

    root = Path(args.dist_dir)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{args.dist_port}",
        rank=args.dist_rank, world_size=args.dist_world)
    try:
        dev = torch.device("cuda", 0)
        data = np.load(root / "graph.npz")
        w = torch.from_numpy(data["w"]).to(dev)
        g = EdgeList(senders=torch.from_numpy(data["lo"]).to(dev),
                     receivers=torch.from_numpy(data["hi"]).to(dev),
                     weights=w, mask=torch.ones_like(w),
                     n_nodes=int(data["n"]))
        deadline = time.perf_counter() + 600
        while not (root / "go").exists():  # phase 9 runs its parts
            if time.perf_counter() > deadline:
                raise TimeoutError("no go from phase 9 in 600 s")
            time.sleep(0.05)
        res = dist_finger(torch, g, args.dist_rank, args.dist_world,
                          torch.from_numpy(data["x0"]))
    finally:
        dist.destroy_process_group()
    (root / f"rank{args.dist_rank}.json").write_text(json.dumps(res))
    return 0


def start_gloo_ranks(out):
    """Phase 9's DIST_RANKS gloo ranks of distributed FINGER on
    ``cuda:0``, each this script with ``--dist-rank``: phase 7's G and
    the start vector go to their directory, and they start up and wait
    there for a go file. Returns (directory, processes)."""
    import shutil
    import socket

    import numpy as np

    from repro_torch.graphs.spectral import start_vector

    g, _ = out["dist_G"]
    root = Path(__file__).resolve().parent / "build" / "dist_finger"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    np.savez(root / "graph.npz", lo=g.senders.cpu().numpy(),
             hi=g.receivers.cpu().numpy(), w=g.weights.cpu().numpy(),
             n=g.n_nodes, x0=start_vector(g.n_nodes, 0).numpy())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dist-rank",
         str(r), "--dist-world", str(DIST_RANKS), "--dist-port", str(port),
         "--dist-dir", str(root)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(DIST_RANKS)]
    return root, procs


def dist_finger_phase(torch, out, dev, root, procs):
    """Phase 9, part 3: distributed FINGER on phase 7's G at world size
    1 under NCCL in this process, then over the gloo ranks of
    `start_gloo_ranks` on the one card, against the serial
    `finger_state` and phase 7's `power_iteration_lmax` (the same start
    vector)."""
    import shutil

    import numpy as np
    import torch.distributed as dist

    from repro_torch.core.state import finger_state
    from repro_torch.graphs.spectral import start_vector

    g, lam_serial = out.pop("dist_G")
    serial = finger_state(g)
    want = {"q": float(serial.q), "s_total": float(serial.s_total),
            "s_max": float(serial.s_max), "lam": lam_serial}
    results = {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        results["nccl x1"] = [dist_finger(torch, g, 0, 1,
                                          start_vector(g.n_nodes, 0))]
    finally:
        dist.destroy_process_group()

    t0 = time.perf_counter()
    (root / "go").touch()
    logs = [p.communicate(timeout=300)[0] for p in procs]
    ranks_s = time.perf_counter() - t0
    if any(p.returncode for p in procs):
        raise AssertionError(
            f"gloo ranks exited {[p.returncode for p in procs]}:\n"
            + "\n".join(log[-3000:] for log in logs))
    results[f"gloo x{DIST_RANKS}"] = [
        json.loads((root / f"rank{r}.json").read_text())
        for r in range(DIST_RANKS)]
    shutil.rmtree(root, ignore_errors=True)
    for label, ranks in results.items():
        r = ranks[0]
        if any(o[f] != r[f] for o in ranks[1:] for f in want):
            raise AssertionError(f"{label}: the ranks disagree {ranks}")
        bad = [f for f, ok in (
            ("q", abs(r["q"] - want["q"]) < 1e-5),
            ("s_total", abs(r["s_total"] - want["s_total"])
             < 1e-6 * abs(want["s_total"])),
            ("s_max", abs(r["s_max"] - want["s_max"]) < 1e-4),
            ("lam", abs(r["lam"] - want["lam"]) < 1e-4 * abs(want["lam"])))
            if not ok]
        if bad or not np.isfinite([r[f] for f in want]).all():
            raise AssertionError(f"{label}: {bad} off the serial {want}: "
                                 f"{r}")
        print(f"  distributed FINGER, {label}, n={g.n_nodes}, "
              f"{int(g.weights.numel())} edges ({r['shard_edges']} a "
              f"shard): q {r['q']:.9f} (serial {want['q']:.9f}), "
              f"s_total {r['s_total']:.6f}, s_max {r['s_max']:.6f}, "
              f"lambda_max {r['lam']:.9g} (phase 7 {want['lam']:.9g}) in "
              f"{r['iterations']} iterations, {r['s_per_iteration'] * 1e3:.3f} "
              f"ms an iteration; all_reduce share "
              f"{r['all_reduce_share']:.3f} (a run with each all_reduce "
              f"between synchronizations)")
    print(f"  the {DIST_RANKS} gloo ranks (started during the sparse part) "
          f"took {ranks_s:.1f} s from the go to their exit; every rank "
          "equal; q within 1e-5, s_total 1e-6 relative, s_max 1e-4, "
          "lambda 1e-4 relative of the serial path")


def compressed_steps(args, torch, out, dev):
    """Phase 9, part 4: two more steps of phase 6's training with
    ``compress_grads=True``, held to phase 6's sound-step check; then
    `elastic_restore` of phase 6's checkpoint onto the card from a CPU
    template, bit-equal with the copy phase 6 took at its save."""
    import shutil

    import numpy as np

    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.distributed import init_residuals
    from repro_torch.models.params import flatten_names, map_tree
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.fault_tolerance import elastic_restore
    from repro_torch.train.step import build_train_step

    cfg, params, opt_state, path, saved = out.pop("train_state")
    opt_cfg = AdamWConfig(lr_peak=TRAIN_LR,
                          warmup_steps=min(20, TRAIN_STEPS // 5 + 1),
                          total_steps=TRAIN_STEPS)
    step_fn = build_train_step(cfg, opt_cfg, compress_grads=True)
    residuals = init_residuals(params)
    before = {k: v.clone() for k, v in flatten_names(params).items()}
    step0 = int(opt_state.step)
    losses, norms, step_ms = [], [], []
    zero_counts()
    for step in range(step0, step0 + 2):
        batch = synthetic_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, args.seed,
                                step, dev)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        params, opt_state, residuals, metrics = step_fn(
            params, opt_state, residuals, batch)
        ev1.record()
        ev1.synchronize()
        step_ms.append(ev0.elapsed_time(ev1))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    counts = read_counts(out)
    stale = [k for k, p in flatten_names(params).items()
             if torch.equal(p, before[k])]
    for name, tree in (("mu", opt_state.mu), ("nu", opt_state.nu)):
        stale += [f"{name}/{k}" for k, m in flatten_names(tree).items()
                  if not bool(m.any())]
    res = flatten_names(residuals)
    res_norm = float(torch.sqrt(sum((r * r).sum() for r in res.values())))
    if not np.isfinite(losses + norms + [res_norm]).all() or stale \
            or int(opt_state.step) != step0 + 2 or res_norm == 0 \
            or any(counts.values()):
        raise AssertionError(f"compressed steps: losses {losses}, grad "
                             f"norms {norms}, residual norm {res_norm}, "
                             f"step {int(opt_state.step)}, unmoved "
                             f"{stale[:8]}, launches {counts}")
    print(f"  2 steps with compress_grads=True from phase 6's state: "
          f"losses {losses}, grad norms {norms}, step ms "
          + " ".join(f"{x:.1f}" for x in step_ms)
          + f" (CUDA events); every leaf moved, both moments nonzero, "
          f"optimizer step {int(opt_state.step)}; residuals' norm "
          f"{res_norm:.4g}; no kernel launched")
    del before, residuals, params, opt_state

    template = map_tree(lambda x: torch.empty_like(x, device="cpu"),
                        saved)
    t0 = time.perf_counter()
    back, manifest = elastic_restore(path, template, dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    a, b = flatten_names(saved), flatten_names(back)
    if list(a) != list(b) or manifest["step"] != TRAIN_STEPS or not all(
            b[k].device == a[k].device and torch.equal(a[k], b[k])
            for k in a):
        raise AssertionError("elastic_restore: phase 6's checkpoint did "
                             "not restore bit-identical on the card")
    print(f"  elastic_restore of phase 6's checkpoint ({len(a)} arrays, "
          f"step {manifest['step']}) onto {dev} from a CPU template: "
          f"{restore_s:.1f} s, bit-identical")
    shutil.rmtree(Path(path).parent, ignore_errors=True)
    del saved, back, a, b
    gc.collect()
    torch.cuda.empty_cache()


def paper_row_names() -> dict:
    """The reference scripts' row names, by twin (`benchmarks/*.py`)."""
    return {
        "fig1": [f"fig1/{m}/d{d}/{h}" for m in ("ER", "BA", "WS")
                 for d in (6, 20, 50) for h in ("Hhat", "Htilde", "Hexact")],
        "fig2": [f"fig2/{m}/{n}" for m in ("ER", "BA", "WS")
                 for n in ("n200", "n400", "n800", "trend")],
        "fig4": [f"fig4/{m}" for m in ("FINGER-JS(Fast)", "DeltaCon",
                                       "lambda(Lap)", "VEO")],
        "table2": [f"table2/{m}" for m in (
            "FINGER-JS(Fast)", "DeltaCon", "RMD", "lambda(Adj)",
            "lambda(Lap)", "GED", "VNGE-NL", "VNGE-GL", "VEO", "cosine(deg)",
            "Bhattacharyya(deg)", "Hellinger(deg)", "FINGER-JS(Inc)")],
    }


def captured(fn, *fn_args, **fn_kw):
    """(fn's result, its standard output); the output is also printed,
    indented, for a reader."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*fn_args, **fn_kw)
    text = buf.getvalue()
    for line in text.strip("\n").splitlines():
        print(f"    | {line}")
    return result, text


def derived_fields(rows) -> dict:
    """{row name: {key: value}} of CSV rows (name, seconds, derived);
    a numeric value parsed, ``%`` dropped."""
    out = {}
    for name, _, derived in rows:
        fields = {}
        for part in derived.split(";"):
            key, eq, value = part.partition("=")
            if not eq:
                continue
            try:
                # a number parsed from printed text
                fields[key] = float(value.rstrip("%"))  # lint: disable=per-item-host-sync
            except ValueError:
                fields[key] = value
        out[name] = fields
    return out


def check_paper_rows(label, rows, want) -> None:
    """The twin printed the reference's row names in order, every time
    and every numeric field finite."""
    import numpy as np

    names = [r[0] for r in rows]
    if names != want:
        raise AssertionError(f"{label}: rows {names} != the reference's "
                             f"{want}")
    for name, seconds, _ in rows:
        if not np.isfinite(seconds):
            raise AssertionError(f"{label}: {name} took {seconds} s")
    for name, fields in derived_fields(rows).items():
        bad = {k: v for k, v in fields.items()
               if isinstance(v, float) and not np.isfinite(v)}
        if bad:
            raise AssertionError(f"{label}: {name} has {bad}")


def check_card_vs_cpu(label, card, cpu, keys) -> float:
    """The card's ``keys`` fields within PAPER_TOL of the CPU's; returns
    the largest difference."""
    a, b = derived_fields(card), derived_fields(cpu)
    worst = 0.0
    for name, fields in a.items():
        for key in keys:
            if key in fields:
                worst = max(worst, abs(fields[key] - b[name][key]))
    print(f"  {label}: {'/'.join(keys)} card vs CPU max |diff| "
          f"{worst:.1e} (bound {PAPER_TOL:g})")
    if worst > PAPER_TOL:
        raise AssertionError(f"{label}: card vs CPU differ by {worst}")
    return worst


def per_pair(rows, prefix: str) -> str:
    """Seconds a graph pair of each method row, for the printout."""
    return ", ".join(f"{name[len(prefix):]} {sec * 1e3:.2f} ms"
                     for name, sec, _ in rows)


def phase_paper(args, torch, out, dev):
    """Phase 10: the paper-script twins (``benchmarks_torch/``) and the
    example twins (``examples_torch/``) on the card at the reference's
    settings."""
    import tempfile

    import numpy as np

    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from benchmarks_torch import (fig1_degree, fig2_size, fig4_bifurcation,
                                  table2_wiki)
    from examples_torch import (anomaly_detection, quickstart,
                                serve_streams, train_with_entropy_probe)

    cpu = torch.device("cpu")
    want = paper_row_names()
    took = []

    def part(name, fn, *fn_args, **fn_kw):
        t0 = time.perf_counter()
        result = captured(fn, *fn_args, **fn_kw)
        took.append(f"{name} {time.perf_counter() - t0:.1f} s")
        return result

    rows, _ = part("fig1", fig1_degree.run, device=dev)
    check_paper_rows("fig1", rows, want["fig1"])
    cpu_rows, _ = part("fig1 CPU", fig1_degree.run, device=cpu)
    check_card_vs_cpu("fig1", rows, cpu_rows, ("AE",))
    f = derived_fields(rows)
    ctrr = {h: [f[n]["CTRR"] for n in f if n.endswith(h)]
            for h in ("Hhat", "Htilde")}
    print(f"  fig1 CTRR on the card, N={fig1_degree.N}: Hhat "
          f"{min(ctrr['Hhat']):.1f}..{max(ctrr['Hhat']):.1f} %, Htilde "
          f"{min(ctrr['Htilde']):.1f}..{max(ctrr['Htilde']):.1f} %")

    rows, _ = part("fig2", fig2_size.run, device=dev)
    check_paper_rows("fig2", rows, want["fig2"])
    trends = {n: d for n, _, d in rows if n.endswith("trend")}
    print(f"  fig2 trends: {trends}")

    rows, _ = part("fig4", fig4_bifurcation.run, device=dev)
    check_paper_rows("fig4", rows, want["fig4"])
    print(f"  fig4 seconds a graph pair: {per_pair(rows, 'fig4/')}")

    rows, _ = part("table2", table2_wiki.run, device=dev)
    check_paper_rows("table2", rows, want["table2"])
    cpu_rows, _ = part("table2 CPU", table2_wiki.run, device=cpu)
    check_card_vs_cpu("table2", rows, cpu_rows, ("PCC", "SRCC"))
    print(f"  table2 seconds a graph pair: {per_pair(rows, 'table2/')}")

    scores, text = part("quickstart", quickstart.main, dev)
    if not (len(scores) == 10 and np.isfinite(scores).all()
            and text.count("JSdist =") == 10 and "<-- burst" in text):
        raise AssertionError(f"quickstart: scores {scores}")
    detected, text = part("anomaly_detection", anomaly_detection.main, dev)
    if text.count("detected transition") != 5:
        raise AssertionError("anomaly_detection: lines missing")
    print(f"  anomaly_detection detected transitions: {detected}")

    for method, kernel in (("fused_tick", "stream_tick"),
                           ("sparse_tick", "sparse_tick")):
        zero_counts()
        res, text = part(f"serve_streams {method}", serve_streams.main,
                         ["--method", method, "--ticks", str(SERVE_TICKS)])
        counts = read_counts(out)
        launched = {k: v for k, v in counts.items() if v}
        word = "DETECTED" if res["hit"] else "MISSED"
        print(f"  serve_streams --method {method}: {word}, launches "
              f"{launched}")
        if launched != {kernel: SERVE_TICKS}:
            raise AssertionError(f"serve_streams {method}: launches "
                                 f"{launched}, want {kernel} once a tick")
        if not (np.isfinite(res["scores"]).all()
                and text.strip().splitlines()[-1] in ("DETECTED",
                                                      "MISSED")):
            raise AssertionError(f"serve_streams {method}: {text[-300:]}")
    res, text = part("serve_streams --fleet", serve_streams.main,
                     ["--fleet", "--ticks", str(FLEET_DEMO_TICKS)])
    if not (res["ok"] and text.strip().splitlines()[-1] == "PARITY OK"):
        raise AssertionError(f"serve_streams --fleet: {text[-300:]}")

    (root / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root / "build",
                                     prefix="probe_ckpt_") as ckpt:
        zero_counts()
        history, text = part(
            "train_with_entropy_probe", train_with_entropy_probe.main,
            ["--steps", str(PROBE_TRAIN_STEPS), "--ckpt-dir", ckpt])
        counts = read_counts(out)
    launched = {k: v for k, v in counts.items() if v}
    print(f"  train_with_entropy_probe: launches {launched}")
    probe_steps = [h["step"] for h in history if "attn_entropy_mean" in h]
    if (len(history) != PROBE_TRAIN_STEPS
            or not np.isfinite([h["loss"] for h in history]).all()
            or probe_steps != [0, 5] or "routing-graph JS" not in text
            or not (counts["vnge_q"] and counts["row_stats"]
                    and counts["graph_stats"])):
        raise AssertionError(f"train_with_entropy_probe: {launched}, "
                             f"probe steps {probe_steps}")
    print("  phase 10 by part: " + ", ".join(took))


def model_config(name: str):
    """A phase-11 family's config and the cut it takes, if any."""
    from repro_torch.configs.base import get_config

    cfg = get_config(name)
    if name.startswith("jamba"):
        # one MoE layer's 16 experts hold 16 x 3 x 8192 x 24576 = 9.66 G
        # parameters, 38.7 GB in f32: the full width waits for the
        # model-sharding rules across cards
        return cfg.reduced(), (
            "reduced (cfg.reduced(): 8 layers, d_model 128, 4 experts): at "
            "full width one MoE layer's experts hold 9.66 G parameters, "
            "38.7 GB in f32, so the 72 layers need several cards")
    return cfg, None


def decode_gate(torch, cfg, params, dev, seed: int) -> float:
    """Decode over an f32 cache against the prefill on GATE_TOKENS tokens
    (whisper: `decode_train` on an encoder output of zeros, the zero
    cross-KV's counterpart); the largest difference, gated at GATE_TOL."""
    from repro_torch.models import whisper
    from repro_torch.models.api import (build_decode_fn, build_forward_fn,
                                        init_cache_arrays)

    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    toks = torch.randint(0, cfg.vocab_size, (2, GATE_TOKENS),
                         generator=gen, device=dev)
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            enc = torch.zeros((2, cfg.encoder_seq, cfg.d_model), device=dev)
            full = whisper.decode_train(params, toks, enc, cfg)
        else:
            full = build_forward_fn(cfg)(params, {"tokens": toks})
        cache = init_cache_arrays(cfg, 2, GATE_TOKENS, dev, torch.float32)
        dec = build_decode_fn(cfg)
        steps = []
        for i in range(GATE_TOKENS):
            logits, cache = dec(params, toks[:, i:i + 1], cache, i)
            steps.append(logits[:, 0])
    v = cfg.vocab_size
    got, want = torch.stack(steps, 1)[..., :v], full[..., :v]
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=GATE_TOL, atol=GATE_TOL):
        raise AssertionError(f"{cfg.name}: decode over an f32 cache "
                             f"differs from the prefill by {err}")
    return err


def served(torch, cfg, params, dev, shape, out, seed: int):
    """`serve_batch` at (batch, prompt, new) with the reference's bf16
    cache: (tokens, seconds); the tokens gated in range, no kernel
    launched."""
    from repro_torch.launch.serve import serve_batch

    b, prompt, new = shape
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (b, prompt), generator=gen,
                            device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    seqs = serve_batch(cfg, params, prompts, new, cache_len=prompt + new,
                       device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = {k: n for k, n in read_counts(out).items() if n}
    if tuple(seqs.shape) != (b, prompt + new) or seqs.dtype != torch.int32 \
            or int(seqs.min()) < 0 or int(seqs.max()) >= cfg.vocab_size \
            or not torch.equal(seqs[:, :prompt], prompts.to(torch.int32)):
        raise AssertionError(f"{cfg.name}: served tokens {seqs.shape} "
                             f"{seqs.dtype} outside [0, {cfg.vocab_size})")
    if launched:
        raise AssertionError(f"{cfg.name}: serving launched {launched}")
    return seqs, dt


def decode_step_ms(torch, cfg, params, dev, shape) -> list:
    """CUDA-event ms of 20 serve steps at (batch, cache length) after 3
    warm-up steps; the cost does not depend on the position (every slot
    is read and masked)."""
    from repro_torch.models.api import init_cache_arrays
    from repro_torch.train.step import build_serve_step

    b, prompt, new = shape
    cache = init_cache_arrays(cfg, b, prompt + new, dev)
    serve = build_serve_step(cfg)
    tok = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    times = []
    for t in range(23):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tok, _, cache = serve(params, tok, cache, t)
        end.record()
        end.synchronize()
        if t >= 3:
            times.append(start.elapsed_time(end))
    return times


def trained(torch, cfg, dev, batch: int, seq: int, out, seed: int):
    """3 steps of `launch.train.run` with probes on steps 0 and 2: the
    sound-step gate (finite losses and gradient norms, every leaf off its
    init, both moments of every leaf off 0) → (params, history, launch
    counts)."""
    import numpy as np

    from repro_torch.launch.train import run
    from repro_torch.models.api import model_param_defs
    from repro_torch.models.params import flatten_names, init_params

    zero_counts()
    params, opt_state, history = run(
        cfg, steps=MODEL_STEPS, batch_size=batch, seq=seq,
        probe_every=MODEL_PROBE_EVERY, seed=seed, lr=MODEL_LR,
        log=lambda *a: None, device=dev)
    torch.cuda.synchronize()
    counts = {k: n for k, n in read_counts(out).items() if n}
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    if not np.isfinite(losses + norms).all() \
            or int(opt_state.step) != MODEL_STEPS:
        raise AssertionError(f"{cfg.name}: losses {losses}, grad norms "
                             f"{norms}, step {int(opt_state.step)}")
    init = flatten_names(init_params(
        model_param_defs(cfg),
        torch.Generator(device=dev).manual_seed(seed), device=dev))
    stale = [k for k, p in flatten_names(params).items()
             if torch.equal(p, init[k])]
    for name, tree in (("mu", opt_state.mu), ("nu", opt_state.nu)):
        stale += [f"{name}/{k}" for k, m in flatten_names(tree).items()
                  if not bool(m.any())]
    if stale:
        raise AssertionError(f"{cfg.name}: {MODEL_STEPS} steps left "
                             f"{len(stale)} leaves as initialized: "
                             f"{stale[:8]}")
    del init, opt_state
    return params, history, counts


def phase_models(args, torch, out, dev):
    """Phase 11: the model stack on the card: decode and the serve
    launcher, the SSM mixer, the encoder-decoder and the vision stub."""
    import numpy as np

    from repro_torch.models.api import model_param_defs
    from repro_torch.models.params import count_params, init_params

    def header(cfg, cut):
        n = count_params(model_param_defs(cfg))
        print(f"  {cfg.name}: {n / 1e6:.1f} M parameters, "
              f"{cfg.n_layers} layers, d_model {cfg.d_model}"
              + (f"; {cut}" if cut else " (full width)"))

    def peak(name):
        print(f"  {name} peak torch.cuda.max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the serve launcher's default arch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, _ = model_config(SERVE_ARCH)
    header(cfg, None)
    params = init_params(model_param_defs(cfg),
                         torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    err = decode_gate(torch, cfg, params, dev, args.seed)
    print(f"  {cfg.name} decode (f32 cache) vs prefill, {GATE_TOKENS} "
          f"tokens: max |diff| {err:.3e} (gate {GATE_TOL})")
    for shape in (SERVE_DEFAULTS, SERVE_BIG):
        b, prompt, new = shape
        seqs, dt = served(torch, cfg, params, dev, shape, out, args.seed)
        ms = decode_step_ms(torch, cfg, params, dev, shape)
        print(f"  {cfg.name} serve_batch batch {b}, prompt {prompt}, "
              f"{new} new (bf16 cache of {prompt + new}): {dt:.3f} s, "
              f"{b * (prompt + new) / dt:.1f} tokens/s fed and decoded, "
              f"{b * new / dt:.1f} new tokens/s")
        print(f"  {cfg.name} decode step at batch {b}, cache "
              f"{prompt + new} (CUDA events, 20 steps): median "
              # a host numpy median
              f"{float(np.median(ms)):.3f} ms, min {min(ms):.3f} ms")  # lint: disable=per-item-host-sync
    print(f"  {cfg.name} first new tokens: "
          f"{seqs[0, SERVE_BIG[1]:SERVE_BIG[1] + 16].tolist()}")
    peak(cfg.name)
    del params

    for name, batch, seq in MODEL_TRAIN:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg, cut = model_config(name)
        header(cfg, cut)
        params, history, counts = trained(torch, cfg, dev, batch, seq, out,
                                          args.seed)
        want = {}
        if name.startswith(("internvl2", "jamba")):
            probes = len(range(0, MODEL_STEPS, MODEL_PROBE_EVERY))
            want = {"row_stats": probes, "graph_stats": probes}
            if cfg.n_experts:  # the routing tracker from the 2nd graph
                want["vnge_q"] = 3 * (probes - 1)
        if counts != want:
            raise AssertionError(f"{name}: training launched {counts}, "
                                 f"want {want}")
        front = cfg.n_frontend_tokens if cfg.frontend == "vision_stub" \
            else 0
        step_ms = [h["step_ms"] for h in history]
        print(f"  {name} train: batch {batch} x {seq} tokens"
              + (f" + {front} frontend embeddings" if front else "")
              + (f" + {cfg.encoder_seq} encoder frames"
                 if cfg.is_encoder_decoder else "")
              + f", {MODEL_STEPS} steps, losses "
              + " ".join(f"{h['loss']:.4f}" for h in history)
              + ", grad norms "
              + " ".join(f"{h['grad_norm']:.4g}" for h in history))
        print(f"  {name} step ms (CUDA events): "
              + " ".join(f"{x:.1f}" for x in step_ms)
              # a host numpy median
              + f"; median {float(np.median(step_ms)):.1f}; launches "  # lint: disable=per-item-host-sync
              f"{counts}")
        probed = [(h["step"], k, round(h[k], 6)) for h in history
                  for k in ("attn_entropy_mean", "routing_jsdist")
                  if k in h]
        if probed:
            print(f"  {name} probes (step, name, value): {probed}")
        err = decode_gate(torch, cfg, params, dev, args.seed)
        print(f"  {name} decode (f32 cache) vs prefill, {GATE_TOKENS} "
              f"tokens: max |diff| {err:.3e} (gate {GATE_TOL})")
        seqs, dt = served(torch, cfg, params, dev, SERVE_DEFAULTS, out,
                          args.seed)
        b, prompt, new = SERVE_DEFAULTS
        print(f"  {name} serve_batch at the launcher's defaults: "
              f"{dt:.3f} s, {b * (prompt + new) / dt:.1f} tokens/s; "
              # eight tokens printed once a family, after the timed serve
              f"first new tokens {seqs[0, prompt:prompt + 8].tolist()}")  # lint: disable=per-item-host-sync
        peak(name)
        del params


def phase_analysis(args, torch, out, dev):
    """Phase 12: `repro_torch.analysis`'s gate in this process."""
    import contextlib
    import io

    from repro_torch.analysis.__main__ import main as analysis_main

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    zero_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = analysis_main(["--json"])
    got = read_counts(out)
    report = json.loads(buf.getvalue())
    path = Path(__file__).resolve().parent / "build" / "analysis_report.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1))
    checks = report["checks"]
    lint = checks["lint"]
    bad = [v for v in lint["violations"] if not v["suppressed"]]
    print(f"  lint: {'OK' if lint['ok'] else 'FAIL'} in "
          f"{lint['seconds']:.2f} s, {len(bad)} unsuppressed, "
          f"{len(lint['violations']) - len(bad)} suppressed finding(s)")
    for v in bad:
        print(f"    {v['path']}:{v['line']}: [{v['rule']}] {v['message']}")
    audit = checks["audit"]
    print(f"  audit: {'OK' if audit['ok'] else 'FAIL'} in "
          f"{audit['seconds']:.2f} s, {len(audit['targets'])} targets")
    for t in audit["targets"]:
        print(f"    [{'OK ' if t['ok'] else 'FAIL'}] {t['target']}: "
              f"{t['shards']} shard(s), launches {t['launches'] or '{}'}")
        for v in t["violations"]:
            print(f"      {v['rule']}: {v['message']}")
    sm = checks["smem"]
    print(f"  smem: {'OK' if sm['ok'] else 'FAIL'} in {sm['seconds']:.2f} s"
          f" on {sm.get('device')}, {len(sm.get('configs', []))} launches;"
          f" parity launches {sm.get('parity_launches')}")
    print(f"    {'package':13} {'instantiation':28} {'shape':30} "
          f"{'regs':>4} {'spill':>5} {'smem B':>7} {'blk/SM':>6}")
    for c in sm.get("configs", []):
        print(f"    {c['package']:13} {c['kernel']:28} {c['shape']:30} "
              f"{c['registers']:>4} {c['local_bytes']:>5} {c['smem']:>7} "
              f"{c['blocks_per_sm']:>6}")
    for g in sm.get("guards", []):
        print(f"    guard {g['guard']} at {g['shape']}: admits "
              f"{g['guard_admits']}, the kernel accepts "
              f"{g['kernel_accepts']}")
    for v in sm.get("violations", []) + ([sm] if "error" in sm else []):
        print(f"    {v.get('rule', 'error')}: "
              f"{v.get('message', v.get('error'))}")
    sen = checks["sentinel"]
    print(f"  sentinel: {'OK' if sen['ok'] else 'FAIL'} in "
          f"{sen['seconds']:.2f} s")
    for name, res in sen["chains"].items():
        print(f"    {name}: " + (f"first-use events by phase "
                                 f"{res['phases']}" if res["ok"]
                                 else res["error"]))
    print(f"  launches in phase 12 (audit and sentinel): "
          f"{ {k: v for k, v in got.items() if v} }")
    if rc != 0 or not report["ok"]:
        failed = [name for name, c in checks.items() if not c["ok"]]
        raise AssertionError(f"analysis gate failed: {failed}")
    if got.get("stream_tick", 0) == 0 or got.get("sparse_tick", 0) == 0:
        raise AssertionError(f"phase 12 launched no tick kernel: {got}")


# --------------------------------------------------------------------------
# Phase 13: the model-sharding rules on a DeviceMesh and the dry run
# --------------------------------------------------------------------------

def start_dryrun():
    """The meta-device dry run of every (arch × shape × mesh) cell in a
    process of its own (its fake process groups cannot share this
    process's default group), started with phase 13 at a low CPU
    priority, DRY_JOBS cells at a time → (process, its JSONL path)."""
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    path = build / "dryrun.jsonl"
    path.unlink(missing_ok=True)
    # CPU only: it holds nothing on the card (fits_hbm is then against
    # the H100's 80 GB)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    log = open(build / "dryrun.log", "w")
    proc = subprocess.Popen(
        ["nice", "-n", "10", sys.executable, "-m", "repro_torch.launch.dryrun",
         "--arch", "all", "--shape", "all", "--both-meshes", "--out",
         str(path), "--jobs", str(DRY_JOBS)], env=env, stdout=log,
        stderr=subprocess.STDOUT, start_new_session=True)
    return proc, path


def zero_padded(torch, unpadded, shapes):
    """Each leaf of ``unpadded`` zero-padded at the end of every axis to
    the shape ``shapes`` names for it (a dict of flat names)."""
    from repro_torch.models.params import flatten_names, unflatten_names

    out = {}
    for k, a in flatten_names(unpadded).items():
        pad = []
        for n, m in reversed(list(zip(shapes[k], a.shape))):
            pad += [0, n - m]
        out[k] = torch.nn.functional.pad(a, pad)
    return unflatten_names(out)


def laid_out(mesh, rules, tree, axes):
    """A tree of tensors as DTensors laid out by its logical axes."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import named_sharding

    if isinstance(tree, dict):
        return {k: laid_out(mesh, rules, tree[k], axes[k]) for k in tree}
    if isinstance(tree, tuple):
        return type(tree)(*(laid_out(mesh, rules, a, b)
                            for a, b in zip(tree, axes)))
    return distribute_tensor(tree, mesh, list(
        named_sharding(mesh, rules, axes).placements))


def diff(torch, a, b) -> float:
    """Largest |a − b| of two tensors (DTensors gathered first)."""
    from torch.distributed.tensor import DTensor

    a = a.full_tensor() if isinstance(a, DTensor) else a
    b = b.full_tensor() if isinstance(b, DTensor) else b
    return float((a.float() - b.float()).abs().max())


def gate(label, err, tol, scale=1.0) -> str:
    """Raise if ``err`` exceeds ``tol`` (× ``scale``); say whether the
    two were bit-equal."""
    if not err <= tol * max(scale, 1.0):
        raise AssertionError(f"{label}: differs by {err:.3e} (gate "
                             f"{tol} x max(1, {scale:.3g}))")
    return "bit-equal" if err == 0 else f"within {err:.3e}"


def sharded_run(torch, cfg, rules, mesh, params, batch, dev, probes):
    """One `build_train_step` step on ``params`` (plain or DTensors),
    with the probes around it when ``probes``: the routing graph before
    and after (the tracker's JS distance launches ``vnge_q``) and the
    attention probe after → (params, loss, {probe: value}, prefill
    logits of the batch)."""
    from repro_torch.models.api import build_forward_fn
    from repro_torch.optim.adamw import AdamWConfig, init_state
    from repro_torch.train.step import build_train_step
    from repro_torch.train.telemetry import (RoutingGraphTracker,
                                             attention_entropy_probe,
                                             routing_graph)

    step = build_train_step(cfg, AdamWConfig(lr_peak=TRAIN_LR,
                                             warmup_steps=0), rules=rules)
    res = {}
    tracker = RoutingGraphTracker()
    if probes:
        tracker.update(routing_graph(params, batch, cfg, rules=rules), 0)
    opt = init_state(params)
    res["step_peak"] = 0  # read on the card only
    if dev.type == "cuda":  # the step's own peak above what it holds
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    params, opt, metrics = step(params, opt, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        res["step_peak"] = torch.cuda.max_memory_allocated() - held
    del opt
    if probes:
        res["entropy"] = attention_entropy_probe(
            params, batch["tokens"], cfg, rules=rules)
        res["jsdist"] = tracker.update(routing_graph(
            params, batch, cfg, rules=rules), 1)
    with torch.no_grad():
        logits = build_forward_fn(cfg, rules=rules)(params, batch)
    return params, metrics["loss"], res, logits


def decode_vs_prefill(torch, cfg, rules, mesh, params, toks, dev) -> float:
    """SHARD_DECODE decode steps over an f32 cache laid out by the
    cache's logical axes against the prefill of the same tokens."""
    from repro_torch.models.api import (build_decode_fn, build_forward_fn,
                                        cache_axes, init_cache_arrays)

    b = toks.shape[0]
    with torch.no_grad():
        full = build_forward_fn(cfg, rules=rules)(
            params, {"tokens": toks[:, :SHARD_DECODE]})
        cache = init_cache_arrays(cfg, b, SHARD_DECODE, dev, torch.float32,
                                  rules)
        cache = laid_out(mesh, rules, cache, cache_axes(cfg, rules))
        dec = build_decode_fn(cfg, rules)
        steps = []
        for i in range(SHARD_DECODE):
            logits, cache = dec(params, toks[:, i:i + 1], cache, i)
            steps.append(logits[:, 0])
    v = cfg.vocab_size
    return diff(torch, torch.stack(steps, 1)[..., :v], full[..., :v])


def fan_in(name: str, shape) -> int:
    """The contracted width of a stacked (L, ...) layer weight."""
    if name.endswith("/wo"):
        return shape[1] * shape[2]
    if "/moe/w_" in name:
        return shape[2]
    return shape[1]


def padded_vs_unpadded(torch, cfg, rules, mesh, trained, batch, dev,
                       rescale=True):
    """The padded model (DTensors) on zero-padded weights against the
    unpadded one (plain tensors) on the trained model's weights cut to
    the real heads and experts → (logit diff, cross-entropy diff, aux
    padded, aux unpadded, logit scale, the padded DTensor parameters).
    ``rescale``: every stacked
    layer weight scaled from the init's 1/sqrt(L) to 1/sqrt(its
    fan-in), as the CPU parity tests redraw them (the init's scale
    makes a model whose activations grow by orders of magnitude a
    layer, which turns the last-bit rounding of a 32-head against a
    24-head product into logit gaps of 1e-3)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import transformer
    from repro_torch.models.api import build_forward_fn, model_param_defs
    from repro_torch.models.params import (distribute_params, flatten_names,
                                           param_shardings, unflatten_names)

    full = {k: (v.full_tensor() if isinstance(v, DTensor) else v)
            for k, v in flatten_names(trained).items()}
    unp_defs = flatten_names(model_param_defs(cfg))
    pad_defs = model_param_defs(cfg, rules)
    unp = {k: full[k][tuple(slice(0, n) for n in d.shape)].clone()
           for k, d in unp_defs.items()}
    if rescale:
        for k, a in unp.items():
            if a.ndim > 2 and k.startswith(("blocks/", "enc/", "dec/")):
                a.mul_((a.shape[0] / fan_in(k, a.shape)) ** 0.5)
    unp = unflatten_names(unp)
    padded = distribute_params(zero_padded(
        torch, unp, {k: d.shape for k, d in flatten_names(
            pad_defs).items()}), param_shardings(pad_defs, mesh, rules))
    v = cfg.vocab_size
    with torch.no_grad():
        if cfg.is_encoder_decoder:
            lu = build_forward_fn(cfg)(unp, batch["plain"])
            lp = build_forward_fn(cfg, rules=rules)(padded, batch["dt"])
            aux_u = aux_p = 0.0
        else:
            lu, aux_u = transformer.forward(unp, batch["plain"]["tokens"],
                                            cfg)
            from repro_torch.models.api import spmd

            with spmd(padded):
                lp, aux_p = transformer.forward(padded, batch["dt"]["tokens"],
                                                cfg, rules=rules)
        lp = lp.full_tensor() if isinstance(lp, DTensor) else lp
        aux_p = aux_p.full_tensor() if isinstance(aux_p, DTensor) else aux_p
        labels = batch["plain"]["labels"]
        from repro_torch.models.layers import cross_entropy_loss

        ce_u = cross_entropy_loss(lu, labels)
        ce_p = cross_entropy_loss(lp, labels)
    return (diff(torch, lp[..., :v], lu[..., :v]),
            abs(float(ce_p) - float(ce_u)) / abs(float(ce_u)),
            float(aux_p), float(aux_u), float(lu[..., :v].abs().max()),
            padded)


def phase_sharding(args, torch, out, dev):
    """Phase 13: the dry run of every cell started in a process of its
    own, then beside it the model-sharding rules on a 1×1 NCCL mesh and
    the memory model's cross-check; then the dry run's cells."""
    proc, path = start_dryrun()
    try:
        rules_and_cross_check(args, torch, out, dev)
        t0 = time.perf_counter()
        rc = proc.wait(timeout=DRY_TIMEOUT)
        waited = time.perf_counter() - t0
    finally:
        if proc.poll() is None:  # a failed check leaves it running
            os.killpg(proc.pid, signal.SIGKILL)  # it and its workers
            proc.wait()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    dryrun_rows(rows, rc, waited)


def rules_and_cross_check(args, torch, out, dev):
    """Phase 13's checks on the card: the rules on a 1×1 NCCL mesh, then
    the memory model's cross-check."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import (named_sharding,
                                                  single_pod_rules)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.api import model_param_defs
    from repro_torch.models.attention import attn_dims
    from repro_torch.models.moe import effective_experts
    from repro_torch.models.params import (count_params, distribute_params,
                                           flatten_names, init_params,
                                           map_tree, param_shardings)
    from repro_torch.optim.adamw import init_state
    from repro_torch.train.telemetry import GATHERS

    t_phase = time.perf_counter()
    mesh = make_host_mesh()
    rules = single_pod_rules(SHARD_TP)
    print(f"  mesh {mesh} on backend {dist.get_backend()}; rules "
          f"{rules}")
    try:
        cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                  n_layers=TRAIN_LAYERS)
        dims, v_pad = attn_dims(cfg, rules), model_param_defs(
            cfg, rules)["embed"].shape[0]
        e_pad = effective_experts(cfg, rules)
        got = (cfg.n_heads, dims.n_q, cfg.n_experts, e_pad, cfg.vocab_size,
               v_pad, dims.kv_sharded)
        print(f"  {cfg.name} (n_layers={TRAIN_LAYERS} of "
              f"{get_config(TRAIN_ARCH).n_layers}, phase 6's cut; batch "
              f"{SHARD_BATCH} x seq {SHARD_SEQ}): heads {got[0]} -> "
              f"{got[1]}, experts {got[2]} -> {got[3]}, vocab {got[4]} -> "
              f"{got[5]}, {cfg.n_kv_heads} KV heads sharded: {got[6]}; "
              f"{count_params(model_param_defs(cfg)) / 1e6:.1f} M -> "
              f"{count_params(model_param_defs(cfg, rules)) / 1e6:.1f} M "
              "parameters")
        if got != (24, 32, 40, 48, 49155, 49280, False):
            raise AssertionError(f"granite padding {got}")
        defs = model_param_defs(cfg, rules)
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        plain = init_params(defs, gen, device=dev)
        toks = torch.randint(0, cfg.vocab_size, (SHARD_BATCH, SHARD_SEQ),
                             generator=gen, device=dev, dtype=torch.int32)
        batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
        bpl = list(named_sharding(mesh, rules, ("batch", None)).placements)
        dbatch = {k: distribute_tensor(x, mesh, bpl)
                  for k, x in batch.items()}
        # the state the dry run's argument bytes are held to, measured
        # from fresh segments: `memory_allocated` counts whole allocator
        # blocks (a cached block is not split for a remainder under 1 MB),
        # the allocator's `requested_bytes` what the tensors asked for
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        def allocated():
            torch.cuda.synchronize()
            return (torch.cuda.memory_allocated(),
                    torch.cuda.memory_stats()["requested_bytes.all.current"])

        a0 = allocated()
        dparams = distribute_params(map_tree(lambda a: a.clone(), plain),
                                    param_shardings(defs, mesh, rules))
        a1 = allocated()
        opt = init_state(dparams)
        a2 = allocated()
        held = {"params": (a1[0] - a0[0], a1[1] - a0[1]),
                "opt": (a2[0] - a1[0], a2[1] - a1[1])}
        del opt
        # the main path: the DTensor model's step with its probes
        zero_counts()
        gathers = dict(GATHERS)
        t0 = time.perf_counter()
        dparams, dloss, dprobe, dlogits = sharded_run(
            torch, cfg, rules, mesh, dparams, dbatch, dev, probes=True)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        counts = read_counts(out)
        gathered = {k: GATHERS[k] - gathers[k] for k in GATHERS}
        launched = {k: n for k, n in counts.items() if n}
        want = {"row_stats": 1, "graph_stats": 1, "vnge_q": 3}
        print(f"  DTensor step + probes: {step_s:.2f} s, loss "
              f"{float(dloss.full_tensor()):.6f}, probe entropy mean "
              f"{float(dprobe['entropy'].mean()):.6f} over "
              f"{dprobe['entropy'].numel()} heads (B x padded heads), "
              f"routing JS {dprobe['jsdist']:.6g}; launches {launched}, "
              f"gathers {gathered}; the step's peak above what it holds "
              f"{dprobe['step_peak'] / 2**30:.3f} GiB")
        if launched != want or gathered != {"attention_probe": 2,
                                            "routing_graph": 2}:
            raise AssertionError(f"phase 13 launches {launched}, gathers "
                                 f"{gathered}; want {want}")
        # gate 1: the same padded model on plain tensors
        zero_counts()
        pparams, ploss, pprobe, plogits = sharded_run(
            torch, cfg, rules, mesh, map_tree(lambda a: a.clone(), plain),
            batch, dev, probes=True)
        errs = {
            "loss": diff(torch, dloss, ploss),
            "params": max(diff(torch, a, pparams_f) for a, pparams_f in zip(
                flatten_names(dparams).values(),
                flatten_names(pparams).values())),
            "entropy": diff(torch, dprobe["entropy"], pprobe["entropy"]),
            "jsdist": abs(dprobe["jsdist"] - pprobe["jsdist"]),
            "logits": diff(torch, dlogits, plogits)}
        worst = max(errs.values())
        print(f"  DTensor vs plain tensors (same padded model): "
              f"{gate('granite DTensor vs plain', worst, 1e-5)}; "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
        del pparams, plogits, dlogits, plain
        # gate 2: the unpadded model on zero-padded weights. The top-8
        # routing is a discrete choice: matmuls of 32 and 24 heads, 48
        # and 40 experts round apart in the last bit and flip near-tied
        # choices, so the gated pair routes every token to every real
        # expert with a capacity that drops none (the padded capacity
        # divides by 48, the unpadded by 40); the top-8 model's gap is
        # printed beside it
        pb = {"plain": batch, "dt": dbatch}
        # a capacity of every token: cf·T·k/E_pad = T
        top8 = padded_vs_unpadded(
            torch, dataclasses.replace(cfg, capacity_factor=e_pad
                                       / cfg.top_k),
            rules, mesh, dparams, pb, dev)
        smooth = dataclasses.replace(cfg, top_k=cfg.n_experts,
                                     capacity_factor=e_pad / cfg.n_experts)
        d_log, d_ce, aux_p, aux_u, scale, smooth_params = \
            padded_vs_unpadded(torch, smooth, rules, mesh, dparams, pb, dev)
        raw = padded_vs_unpadded(torch, smooth, rules, mesh, dparams, pb,
                                 dev, rescale=False)
        ratio = aux_p / aux_u
        print(f"  padded vs unpadded on zero-padded weights (layer "
              f"weights at 1/sqrt(fan-in)), every token to every real "
              f"expert, no drops: logits "
              f"{gate('granite padded logits', d_log, 1e-4, scale)} "
              f"(max |logit| {scale:.3g}), cross entropy "
              f"{gate('granite padded CE', d_ce, 1e-5)} relative; aux "
              f"{aux_p:.6f} vs {aux_u:.6f}, ratio {ratio:.6f} (E_pad/E = "
              f"{e_pad / cfg.n_experts:.6f} if every token's top "
              f"{cfg.n_experts} are the real experts); at top-8 "
              f"(printed): logits {top8[0]:.3e}, cross entropy "
              f"{top8[1]:.3e} relative; at the init's 1/sqrt(L) scale "
              f"(printed): logits {raw[0]:.3e} of {raw[4]:.3g}, cross "
              f"entropy {raw[1]:.3e} relative")
        del raw, top8
        err = decode_vs_prefill(torch, smooth, rules, mesh, smooth_params,
                                dbatch["tokens"], dev)
        del smooth_params
        print(f"  decode over an f32 cache vs prefill, {SHARD_DECODE} "
              f"tokens (the padded DTensor model routing to every real "
              f"expert, weights at 1/sqrt(fan-in)): "
              f"{gate('granite decode', err, 1e-4)}")
        del dparams, dbatch, batch
        gc.collect()
        torch.cuda.empty_cache()

        for name, b, s in SHARD_MODELS:
            sharded_family(torch, name, b, s, mesh, rules, dev, args)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(f"  (rules on the 1x1 mesh took "
          f"{time.perf_counter() - t_phase:.1f} s)")

    # the memory model's cross-check: phase 13's cell on a 1×1 fake mesh
    t0 = time.perf_counter()
    cell = dry_cross_check(args)
    dry_bytes = cell["mem_param_bytes"] + cell["mem_opt_bytes"] \
        + cell["mem_step_bytes"]
    card = held["params"][0] + held["opt"][0]
    asked = held["params"][1] + held["opt"][1]
    step_peak = dprobe["step_peak"]
    print(f"  dry run of this cell on a 1x1 fake mesh "
          f"({time.perf_counter() - t0:.1f} s): parameters "
          f"{cell['mem_param_bytes']} B + moments {cell['mem_opt_bytes']} "
          f"B + step {cell['mem_step_bytes']} B = {dry_bytes} B; the "
          f"card's allocator: requested {held['params'][1]} B + "
          f"{held['opt'][1]} B = {asked} B, torch.cuda.memory_allocated "
          f"{held['params'][0]} B + {held['opt'][0]} B (whole blocks: the "
          f"step's 4 B take 512); dry-run peak {cell['mem_peak_gb']:.3f} "
          f"GiB (temporaries {cell['mem_temp_gb']:.3f} GiB) vs the card's "
          f"state {card / 2**30:.3f} GiB + the step's peak above it "
          f"{step_peak / 2**30:.3f} GiB = "
          f"{(card + step_peak) / 2**30:.3f} GiB "
          "(torch.cuda.max_memory_allocated)")
    if dry_bytes != asked:
        raise AssertionError(f"dry-run argument bytes {dry_bytes}: the "
                             f"card's allocator requested {asked} B and "
                             f"allocated {card} B")


def sharded_family(torch, name, b, s, mesh, rules, dev, args):
    """mamba2-130m and whisper-small whole under the rules: DTensor vs
    plain (one step and the prefill), padded vs unpadded on zero-padded
    weights (gated for whisper; printed for mamba2, whose gated RMSNorm
    spans the padded width)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import named_sharding
    from repro_torch.models.api import model_param_defs
    from repro_torch.models.attention import attn_dims
    from repro_torch.models.mamba2 import ssm_dims
    from repro_torch.models.params import (distribute_params, flatten_names,
                                           init_params, map_tree,
                                           param_shardings)

    cfg = get_config(name)
    defs = model_param_defs(cfg, rules)
    if cfg.is_encoder_decoder:
        pads = f"heads {cfg.n_heads} -> {attn_dims(cfg, rules).n_q}"
    else:
        pads = f"SSM heads {ssm_dims(cfg)[0]} -> {ssm_dims(cfg, rules)[0]}"
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    plain = init_params(defs, gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device=dev, dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    if cfg.is_encoder_decoder:
        batch["frames"] = 0.02 * torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), generator=gen, device=dev)
        axes["frames"] = ("batch", None, None)
    dbatch = {k: distribute_tensor(x, mesh, list(named_sharding(
        mesh, rules, axes[k]).placements)) for k, x in batch.items()}
    dparams = distribute_params(map_tree(lambda a: a.clone(), plain),
                                param_shardings(defs, mesh, rules))
    zero_counts()
    t0 = time.perf_counter()
    dparams, dloss, _, dlogits = sharded_run(torch, cfg, rules, mesh,
                                             dparams, dbatch, dev, False)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launched = {k: n for k, n in read_launches().items() if n}
    pparams, ploss, _, plogits = sharded_run(torch, cfg, rules, mesh, plain,
                                             batch, dev, False)
    errs = {"loss": diff(torch, dloss, ploss),
            "params": max(diff(torch, a, c) for a, c in zip(
                flatten_names(dparams).values(),
                flatten_names(pparams).values())),
            "logits": diff(torch, dlogits, plogits)}
    print(f"  {name} (whole, {pads}; batch {b} x {s}): DTensor step "
          f"{took:.2f} s, loss {float(ploss):.6f}, launches "
          f"{launched or '{}'}; DTensor vs plain "
          f"{gate(name + ' DTensor vs plain', max(errs.values()), 1e-5)}")
    if launched:
        raise AssertionError(f"{name}: the step launched {launched}")
    d_log, d_ce, _, _, scale, _ = padded_vs_unpadded(
        torch, cfg, rules, mesh, dparams, {"plain": batch, "dt": dbatch},
        dev)
    if cfg.is_encoder_decoder:
        print(f"  {name} padded vs unpadded on zero-padded weights: logits "
              f"{gate(name + ' padded logits', d_log, 1e-4, scale)}, "
              f"cross entropy {gate(name + ' padded CE', d_ce, 1e-5)} "
              "relative")
    else:
        print(f"  {name} padded vs unpadded on zero-padded weights: not "
              f"equal by construction (the gated RMSNorm averages over "
              f"the padded inner width): max |logit diff| {d_log:.3e}, "
              f"cross entropy {d_ce:.3e} relative")


def read_launches() -> dict:
    """The wrappers' launch counts since `zero_counts`, not added to the
    kernels line (a path none of whose kernels may launch)."""
    from repro_torch.analysis.sanitize import launch_counts

    return launch_counts()


def dry_cross_check(args) -> dict:
    """`dryrun_cell` of phase 13's granite cell (f32 parameters, as the
    card holds them) on a 1×1 fake mesh, in a process of its own."""
    code = (
        "import dataclasses, json, torch\n"
        "from repro_torch.configs.base import ShapeConfig, get_config\n"
        "from repro_torch.launch.dryrun import dryrun_cell\n"
        f"cfg = dataclasses.replace(get_config({TRAIN_ARCH!r}), "
        f"n_layers={TRAIN_LAYERS})\n"
        f"r = dryrun_cell({TRAIN_ARCH!r}, 'phase13', cfg=cfg, "
        f"shape=ShapeConfig('phase13', {SHARD_SEQ}, {SHARD_BATCH}, "
        f"'train'), mesh_shape=(1, 1), tp={SHARD_TP}, "
        "param_dtype=torch.float32, verbose=False)\n"
        "print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise AssertionError(f"dry-run cross-check failed:\n"
                             f"{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def dryrun_rows(rows, rc, waited) -> None:
    """Print the dry run's cells and hold them to the gate: every cell
    OK or SKIP, the SKIP set the reference's ``skip_reason`` set."""
    from repro_torch.configs.archs import ARCH_IDS
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch.dryrun import skip_reason

    print(f"  dry run (its own process, {DRY_JOBS} cells at a time, "
          f"started with phase 13; waited {waited:.1f} s here): "
          f"{len(rows)} cells, exit code {rc}; per device: FLOPs, bytes, "
          "collective bytes, peak GiB, bottleneck, fits 80 GB "
          "(estimates against datasheet peaks)")
    for r in rows:
        if r["status"] == "OK":
            print(f"    {r['arch']:26} {r['shape']:12} {r['mesh']:8} OK  "
                  f"{r['device_flops']:.4g} {r['device_bytes']:.4g} "
                  f"{r['collective_total']:.4g} {r['mem_peak_gb']:.3f} "
                  f"{r['bottleneck']} {r['fits_hbm']} ({r['count_s']} s)")
        else:
            print(f"    {r['arch']:26} {r['shape']:12} {r['mesh']:8} "
                  f"{r['status']} {r.get('reason', r.get('error'))}")
    want = {(a, s, m) for a in ARCH_IDS for s, shape in SHAPES.items()
            for m in ("16x16", "2x16x16")
            if skip_reason(get_config(a), shape)}
    skips = {(r["arch"], r["shape"], r["mesh"]) for r in rows
             if r["status"] == "SKIP"}
    fails = [r for r in rows if r["status"] not in ("OK", "SKIP")]
    if rc or fails or len(rows) != 2 * len(ARCH_IDS) * len(SHAPES) \
            or skips != want:
        raise AssertionError(f"dry run: exit {rc}, {len(fails)} FAIL, "
                             f"{len(rows)} cells, skips {sorted(skips)}")


def print_row(r: dict) -> None:
    """One kernel's row of the kernels line, for a reader."""
    floor = f", one empty launch {r['empty_launch_ms']:.4f} ms" \
        if "empty_launch_ms" in r else ""
    print(f"  {r['name']}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} "
          f"ms, bound {r['bound_ms']:.6f} ms by {r['bound_by']}{floor}), "
          f"launches {r['launches']}, max_abs_err {r['max_abs_err']:.3e}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=32768)
    # one gloo rank of phase 9, started by phase 9 itself
    for flag in ("--dist-rank", "--dist-world", "--dist-port"):
        ap.add_argument(flag, type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dist-dir", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.dist_rank is not None:
        return dist_rank_main(args)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; the port's "
              "kernels need a CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch sources under {src}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import dispatch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    dev = torch.device("cuda")
    out = {}
    phase, t_phase = "build", time.perf_counter()

    def start(name: str, title: str) -> None:
        """Close the running phase's clock and open the next."""
        nonlocal phase, t_phase
        now = time.perf_counter()
        print(f"  ({phase} took {now - t_phase:.1f} s)")
        phase, t_phase = name, now
        if title:
            print(title)

    try:
        dispatch.library()
        print(f"phase 1 build: {dispatch.build_seconds():.1f} s into "
              f"{dispatch.build_dir()}")
        start("kernels", "phase 2 kernels vs plain versions:")
        phase_kernels(args, torch, out, dev)
        start("serve", "phase 3 main path (FingerService, fused_tick; "
                       "then its checkpoint, both ingestions and the "
                       "migrations):")
        phase_serve(args, torch, out, dev)
        start("single", "phase 4 single-stream path (jsdist_incremental, "
                        "fused_tick):")
        phase_single(args, torch, out, dev)
        start("timing", "kernel times at the main path's shapes and "
                        "inputs:")
        rows = kernel_rows(torch, out)
        start("sparse", "phase 5 sparse path (FingerService, sparse_tick, "
                        "double-buffered):")
        phase_sparse(args, torch, out, dev)
        start("sparse timing", "sparse_tick times at the sparse path's "
                               "shapes and inputs:")
        rows += sparse_rows(torch, out)
        start("train", "phase 6 train path (launch.train.run, FINGER "
                       "telemetry):")
        phase_train(args, torch, out, dev)
        start("train timing", "vnge_q and entropy_probe times at the train "
                              "path's inputs:")
        rows += train_rows(torch, out, dev)
        start("offline", "phase 7 offline path (FINGER-H_hat, Algorithm 1, "
                         "exact VNGE; bsr_matvec):")
        phase_offline(args, torch, out, dev)
        start("offline timing", "bsr_matvec times at the offline path's "
                                "inputs:")
        rows += offline_rows(torch, out, dev)
        start("fleet", "phase 8 fleet path (FingerFleet: two fused_tick "
                       "pools and a sparse_tick pool, pool-stacked ticks):")
        phase_fleet(args, torch, out, dev)
        start("fleet timing", "stacked tick times at the fleet path's "
                              "shapes and inputs:")
        rows += fleet_rows(torch, out)
        start("sharded", "phase 9 sharded and multipod placements, "
                         "distributed FINGER, gradient compression:")
        phase_sharded(args, torch, out, dev)
        start("paper", "phase 10 the paper's figures and tables and the "
                       "examples (benchmarks_torch/, examples_torch/):")
        phase_paper(args, torch, out, dev)
        start("models", "phase 11 the model stack (decode and the serve "
                        "launcher, mamba2, whisper, internvl2, jamba):")
        phase_models(args, torch, out, dev)
        start("analysis", "phase 12 the analysis gate (lint, tick audit, "
                          "smem, sentinel):")
        phase_analysis(args, torch, out, dev)
        start("sharding", "phase 13 the model-sharding rules on a 1x1 "
                          "NCCL mesh and the meta-device dry run:")
        phase_sharding(args, torch, out, dev)
        for r in rows:  # rows built before a later path count it too
            r["launches"] = out["launches"][r["name"]]
        start("done", "")
    except Exception:  # report the phase, then fail the run
        traceback.print_exc()
        print(f"chip_smoke: phase {phase} FAILED")
        return 1
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
