#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port of UpLIF on one GPU.

    python3 chip_smoke.py

Imports only the port (``src/repro_torch``) and runs:

  1. card     — requires CUDA; prints the card's name and power limit;
  2. build    — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
                (nvcc, sm_90a, one process per source) and prints the build
                seconds;
  3. main path, single index — bulk-loads 4M wikits keys into ``UpLIF`` with
                the default config ("auto" resolves to the fused kernels),
                serves the four read/write mixes of ``WORKLOADS`` in 4096-op
                waves and a delete phase; every read must be found with value
                key + 1, deleted keys must miss, and K1 and K2's launch counts
                must grow in every phase;
  4. range path, single index — on the same index after its deletes, 20
                ``range_query_batch`` calls of 1024 ranges (span 1e-4 of the
                domain, ``max_out`` 512, as ``benchmarks/bench_range.py``)
                and 20 ``adjusted_predict`` batches of 4096 queries: every
                row sorted, inside its range, value key + 1, no deleted key,
                whole where the sorted oracle has at most 256 live keys; the
                rank within the BMAT's tombstones of the oracle's rank; then
                ``torch.profiler`` over 20 write-heavy waves gives the
                device's busy and idle share;
  5. main path, router + tuner — bulk-loads the same 4M keys into
                ``ShardedUpLIF(n_shards=4)``, attaches the synchronous
                ``SelfTuner`` and serves the four mixes (``observe_inserts``
                and ``after_wave`` every wave, as ``examples/serve_index.py``
                does); every read is checked, K1 and K2 must launch in every
                phase and K3 (the forecaster's E-step) in every phase with
                writes; then one each of retrain-shard (with the forecaster's
                GMM), split-shard and merge-shards through the scheduler's
                dispatch and a BMAT switch, each followed by a checked read
                wave; the live contents must equal the loaded plus inserted
                keys;
  6. range path, router — the range phase of 4 on the router (a sixteenth
                of the ranges straddle each shard boundary; each batch's
                latency goes to ``tuner.observe_range``), where
                ``adjusted_predict`` on 4096-query batches over 4 x 2^22
                slots must equal the oracle's searchsorted-left rank;
  7. mixed waves — 100 ``MixedWave``s through ``apply_wave`` (1024 inserts,
                256 deletes, 2048 lookups, 64 ranges, pow2 pad widths): every
                wave must read its own writes; the live contents must then
                equal the loaded plus inserted less deleted keys; a profile
                of 20 write-heavy waves with the tuner;
  7a. fanout  — an index with BMAT fanout 128 (above K2's one-ballot node of
                64 keys) through the five write waves of an op tape on the
                card and on the CPU: lookups, adjusted ranks, overflow counts,
                contents and arrays identical, K1 and K2 launched;
  7b. forecaster — a forecaster with 16 mixture components observes one
                write-heavy wave's insert keys on the card (one K3 launch)
                and on the CPU: the same mixture and responsibilities;
  8. kernels  — each kernel against its plain torch version on the card: K1
                and K2 on the main path's final state and on an fb index
                (radix shift 36), with hits, misses and above-domain keys, K1
                also in its float64-interpolation mode; K2 also at fanouts
                128 and 256 on the main path's BMAT; K3 on unit-domain
                samples (N in 1..8193, K in 1..64) and on the forecaster's
                own inputs;
  9. kernel-level API — on the wikits index (shift 15) and the fb index
                (shift 36): ``ops.spline_lookup`` (K5) on a 4096-query mix,
                ``ops.route_and_search`` (K4) over the index's slot array with
                those predictions, ``ops.bmat_rank`` over the slot keys (above
                the reference's tiled-route size, so K4 over every pass in one
                launch, with a duplicated batch that needs four): two K4
                launches in all; K5 and K4 against their plain versions (zero
                error; K4 on the route, on all the rank's passes at once and
                on each pass alone), ``j`` and the ranks against
                ``torch.searchsorted``;
 10. large index — all 8M wikits keys, a capacity above the float32
                position bound: lookups and an insert wave go through K1's
                float64 mode, which must equal the spline path;
 11. whole path — short op tapes through the port on the card and on the
                CPU, for the single index (with range rows and adjusted ranks
                after every op) and for the router with scripted maintenance
                (split, merge, shard retrain with a fixed GMM, BMAT switch,
                presize, a mixed locate assignment, ranges, adjusted ranks
                and three mixed waves): results, overflow counts, boundaries
                and the slot and BMAT arrays must be identical;
 12. timing   — K1 and K2 on a main-path batch (one mixed wave's 2048 reads
                and 2048 insert keys; K1 also with the L2 flushed by a read
                before each launch, ``cold_ms``, and printed beside its
                shape: knots, rs_iters, widest bucket, W, L and the slot
                array's offset from a 128-byte line), K3 on one write-heavy
                router wave's 2048 insert keys (N and K printed), K2 at
                fanouts 128 and 256 (``variants``), K5 on a 4096-query mix
                on each side of shift 32 (printed beside its shape: knots,
                n_iters, the widest knot range, the share of queries on each
                of its paths and the bisect rounds they take), K4 in
                ``route_and_search`` at that batch and in the tiled rank's
                one launch, warmed up: each kernel's device time
                per launch (``ms``, from the profiler's device events; for K4
                and its library call with the L2 flushed by a read before each
                launch, the warm time beside as ``warm_ms``), the
                time per call of the entry the index calls (the ``ops``
                adapter for K1, K3, K4 and K5, the wrapper for K2), between
                CUDA events (``call_ms``, host dispatch included), its plain
                version's and a one-call PyTorch yardstick's device time
                (none exists for K3 and K5), and the bound, printed as one
                JSON line; the BMAT's cap, nf and fanout beside K2's time, the
                device time of one trivial launch (the launch floor), and the
                tiled rank route against K2 on the same 10.5M-key buffer.
 13. gateway  — the 4M loaded keys in ``ShardedUpLIF(n_shards=4)`` (values
                2k+1) with ``SelfTuner.overlapped(max_concurrent_builds=2,
                commit_replay_cap=4096)`` under ``RequestGateway(max_batch
                1024, max_delay_s 0.002)``: ``warmup()``, then 64 closed-loop
                client threads for 20 s, as ``examples/serve_gateway.py``
                drives it: 70% lookups, 14% upserts rewriting one of the
                client's own loaded keys (every 7th of the rest, split among
                the clients) with a value it has not held, 14% inserts of
                fresh keys from the unloaded half (each owned by one
                client), 2% deletes of a reserved set (every 97th loaded
                key, split among the clients, touched by no other op); a
                client also looks up the keys it wrote. Every lookup must
                find the last acknowledged value (2k+1 where none was
                written) and every delete's hit say whether the key was
                live; after ``close()`` and the tuner's drain the contents
                must equal the loaded plus acknowledged fresh less
                acknowledged deleted keys, each at its last acknowledged
                value; K1, K2 and K3 must launch; every
                flush must land on a primed pad width; the kernel library
                must not be built or loaded after warmup; no build may fail.
                Prints requests/s, p50/p99/p99.9 latency, waves, mean batch,
                flush triggers, pad widths, rejections and the tuner's
                builds submitted, committed, abandoned, conflicted, drained;
 14. async maintenance — ``tests/test_async_maintenance.py``'s paced-commit
                stress at full size on a fresh 4-shard router of the same
                keys: 4 reader threads look up a 512-key probe and the last
                acknowledged insert batch while the main thread inserts 8
                waves of 4096 new keys and the executor's two workers build
                on disjoint intervals (a shard-0 retrain with a fixed GMM
                beside a shard-2 split, then a merge of the split's
                halves), committed under ``replay_cap=1024`` so commits
                drain across waves. No torn read, every acknowledged insert
                readable, at least one drain, and the contents, boundaries
                and every stacked array identical to a twin router that ran
                the same tape with the builds inline. Prints build seconds
                per action, commit seconds, drains, and insert-wave p50/p99
                with a build in flight, while draining, and with neither;
 15. agent, baselines, pipeline — on the single index, the agent's
                A_RETRAIN above a 4096-key BMAT (a full retrain), again at a
                small BMAT (the overflow of a burst of 512 adjacent fresh
                keys; the subset retrain must absorb keys) and A_SWITCH,
                each followed by a checked read wave, the burst, subset
                retrain and switch also on a CPU twin whose arrays must
                equal the card's; then ``WorkloadRunner.run(agent=)`` for
                3 s with an agent that retrains in every state, which must
                apply at least one retrain; each baseline over 1M loaded keys answers a 4096-lookup
                batch and an insert wave on the card as on the CPU (results,
                overflow counts, arrays), K1 and K2 launching for all but
                ``BTreeLike``; ``PackedCorpus`` of 65536 documents gives the
                same batches, doc tokens and retirement on the card as on
                the CPU;
 16. LM serving — ``ServeEngine`` over ``deepseek-7b`` at full width and
                depth (30 layers, d_model 4096, 6.9 B float32 parameters from
                ``init_params(cfg, 0)``, bfloat16 compute) with the default
                ``SelfTuner.overlapped(2, 4096)`` and ``max_len`` 256:
                ``examples/serve_lm.py``'s two waves (a 48-token prompt cold
                and then a hit; three requests of it plus 16 fresh tokens,
                8 new tokens each), whose hits and misses must be the
                reference's and whose tokens must equal a fresh engine's
                cold run of each request; a timed wave of 4 distinct 64-token
                prompts each sent twice, 32 new tokens each (hits must give
                the misses' tokens; K1 and K2 must launch): decode ms per
                token p50/p99, prefill ms per token, wave seconds, tokens/s,
                ``match``/``admit`` ms; one decode step's device busy time
                under the profiler against its bound (the weights a step
                reads), and the host's microseconds per small torch op at
                the phase's start and around that profiler session; decode
                against forward over 12 tokens within the
                reference's 0.15 and argmax agreement 0.9; the card against
                the CPU at depth 2 in float32 over 16 tokens, logits within
                1e-3 and the same greedy tokens; then the engine is closed
                and the model freed. Prints parameter bytes, init seconds
                and peak device memory.
 17. MoE and MLA — (a) phase 16's serving (``run_lm_serve_path``) over
                ``deepseek-v2-236b`` at full width (d_model 5120, 128 heads,
                MLA kv_lora 512 / q_lora 1536, 160 routed experts of d_ff
                1536 + 2 shared, top-6, ``dense_chunked``, vocab 102400,
                bfloat16 stored) and depth 4 of 60 (16.94 B parameters):
                the same waves and checks, K1, K2 and K3 launched, decode
                against forward at the capacity factor where no expert
                drops a token (27: the reference's 16 is too low for 160
                experts over top-6, and its reading is reported beside),
                the card against the CPU at depth 1 in float32; the step's
                bound counts every expert (the dense dispatch reads them
                all) and, for the record, the routed ones alone;
                (b) ``qwen3-moe-30b-a3b`` at full width and depth 8 of 48:
                ``forward_lm`` of a (2, 256) batch with ragged dispatch
                (K6, 3 launches a layer) against dense, both at capacity
                factor 16, where the dense dispatch drops nothing (the
                reference test's 8 drops at this width; its reading is
                reported beside), in float32 (logits within 1e-3, the same
                argmax everywhere) and bfloat16 (max |diff| reported);
                (c) K6 against its plain version at those forwards'
                shapes (qwen3-moe's up- and down-projections, deepseek-v2's),
                with empty groups and rows past the sum, and off the
                16-byte vector path, in float32 and bfloat16, then timed
                beside ``F.grouped_mm`` (the yardstick only).
                ``run_moe_path(torch)`` runs the phase alone.
 18. recurrent and encoder-decoder — (a) phase 16's serving
                (``run_lm_serve_path``) over ``recurrentgemma-2b`` at full
                width and depth (26 layers, d_model 2560, d_rnn 2560, a
                2048-token window, 3.55 B parameters: RG-LRU blocks beside
                a ring of local attention), whose hits resume from the
                per-block snapshots that the prefill keeps (a recurrent
                state cannot be cut back): the same waves and checks, K1,
                K2 and K3 launched, the snapshots' bytes per stored prompt,
                decode against forward also in float32 within 1e-3 (its
                bfloat16 reading reported: the RG-LRU's decode runs its
                state and out-projection in float32, its forward in
                bfloat16, as the reference's do, and at full width the
                two round 0.35 apart), the card against the CPU at depth
                13 (one pattern group)
                in float32 over 48 tokens into ``max_len`` 32, so the ring
                wraps on both sides; (b) the same over ``rwkv6-1.6b`` (24
                layers, d_model 2048, 1.58 B parameters; a snapshot is 12.8
                MB, mostly the float32 wkv state), decode against forward
                required in both dtypes, the card against the CPU at depth
                2, and the forward's time (its RWKV loop runs sequentially
                over time); (c) ``whisper-small`` at full
                width and depth (12 + 12 layers): ``forward_lm`` over 1500
                frames and 32 decoder tokens against 32 decode steps with
                ``enc_kv`` filled by the encoder, within the reference's
                0.15 (argmax agreement 0.9), decode ms per token, and the
                card against the CPU in float32 within 1e-3.
                ``run_recurrent_path(torch)`` and ``run_encdec_path(torch)``
                run the phase alone.

 19. training — (a) K6's backward (autograd's: K6 over the output's
                gradient and rhs transposed for lhs, K6w for rhs) against
                the plain versions' gradients computed on the CPU at phase
                17c's shapes, with empty groups and with rows past the sum,
                in float32 and bfloat16 (K6's tolerances); two K6w calls
                bit-equal; K6w's and the whole backward's device and call
                ms beside ``F.grouped_mm``'s ragged-K form (the yardstick
                only); (b) ``deepseek-7b`` at full width and depth 4 (1.65 B
                parameters, bf16 compute, ``remat="block"``) trains 8
                steps of ``make_train_step(nm=1)`` through ``loop.run``
                with an async checkpoint (about 20 GB, into a temp dir that
                is removed) on ``PackedCorpus`` batches of 4 x 1024: step
                ms p50, tokens/s, model FLOP/s against 989 TFLOP/s, one
                step's device busy share under the profiler, the
                optimizer's ms, peak memory, free disk and checkpoint
                seconds; an nm=2 step within 5e-2 of the nm=1 step; the
                loss falls on a repeated batch; (c) ``qwen3-moe-30b-a3b``
                at full width and depth 2 with ragged dispatch through the
                train launcher's ``train(...)``: 3 steps of (2, 512) corpus
                batches, each launching K6 and K6w (3 a layer, on their
                TMA paths), step ms and peaks, K1 and K2 (the corpus's
                index) launched, one async checkpoint (about 22 GB, into a
                temp dir) restored on the card bit for bit; then at the
                trained parameters: every expert that took a token of a
                (2, 512) batch has a nonzero gradient and every other one
                exactly zero; float32 gradients against ``dense_chunked``
                where nothing drops (the same routes, each leaf within 1e-4
                of its largest gradient); (d) at smoke width in float32, 3
                train steps of ``deepseek-7b`` and of ``qwen3-moe-30b-a3b``
                (ragged) on the
                card and on the CPU, params within 1e-4; the smoke
                ``deepseek-7b``'s fail-at-12-and-resume on the card with and
                without ``torch.use_deterministic_algorithms`` (the script
                sets ``CUBLAS_WORKSPACE_CONFIG`` for it), both bit-equal.
                ``run_train_path(torch)`` runs the phase alone.
 20. launchers — (a) ``python -m repro_torch.launch.serve --arch
                deepseek-7b`` in a process of its own (the smoke config,
                as the reference's command line), which must exit 0 with a
                hit; ``serve(get_config("deepseek-7b"), requests=6,
                prompt_len=32, new_tokens=16)`` in this process at full
                width and depth: the hits (every request after the first
                shares its half prompt) must give each request's cold
                tokens on a fresh engine, K1 and K2 must launch; tokens/s
                and peak memory; (b) ``python -m repro_torch.launch.train
                --arch qwen3-moe-30b-a3b --steps 4 --batch 2 --seq 64`` in
                a process of its own, which must exit 0 with a finite
                loss; ``train(...)`` of ``qwen3-moe-30b-a3b`` at full
                width in this process is phase 19c's; one full-width
                ``rwkv6-1.6b`` step through ``train(...)`` on 1 x 1024
                tokens: its step ms, its peak, and the peak of one loss and
                backward at the trained parameters beside the optimizer's
                state, above the parameters, m, v and gradients (the
                blocks are rematerialized: one block's time loop at a
                time keeps its states); (c) ``compressed_psum`` over a
                one-rank NCCL group (a file store in a temp dir), bit-equal
                to ``compress_roundtrip`` on the card and on the CPU; (d)
                ``dryrun.run_cell`` of ``deepseek-7b train_4k`` and
                ``qwen1-5-110b decode_32k`` on one pod (16 x 16) on the meta
                device, each record's per-device argument bytes against the
                card's memory, and ``roofline.table`` over them.
                ``run_launch_path(torch)`` runs the phase alone.
 21. BMAT types — the paper's Fig. 4 (``benchmarks/bench_bmat_types.py``)
                on the card: the standalone ``BMAT``, both tree types at
                fanout 16 and n = 1,000 / 10,000 / 100,000 / 1,000,000 with
                the bench's keys and queries (seed 0), merged in 65,536-key
                chunks; 4,096 ranks timed (the median of 7 calls after two
                warm-ups, the card synchronized around each); the state on
                the card; ranks equal to searchsorted-left, also after
                ``switch_type``; every merged key found with its value;
                then a delete of 10% (and of absent keys), ``compact``,
                ``extract(lo, hi)`` and ``remove_range`` against a numpy
                oracle. Prints queries/s, modeled and device bytes,
                height and the rbmat/b+mat ratios for each n.
                ``run_bmat_types(torch)`` runs the phase alone.
 22. gateway passthrough — ``benchmarks/bench_gateway.py``'s two modes,
                ``GatewayConfig(passthrough=True, max_pending=2048)`` and
                ``GatewayConfig(max_batch=1024, max_delay_s=0.002)``, each
                over a fresh 4-shard router of its 100,000 keys (values
                2k+1, seed 0) with an ``on_complete`` hook: 64 closed-loop
                clients for 5 s, 70% lookups and 30% inserts of fresh
                keys. Every answer right; every request's op batch of one
                in passthrough (a wave holds at most one lookup and one
                insert); the hook called once for each completed request,
                each already done; K1 and K2 launched; the loaded and
                acknowledged keys read back. Prints requests/s, waves,
                mean batch and the hook's p50/p99 latency for both.
                ``run_gateway_passthrough(torch)`` runs the phase alone.
 23. window insert — K7 at the read_heavy cell's shape: a slot view of
                16M keys' capacity (2.67 slots a key, 37.5% occupied, W 64)
                on the card, 410 fresh keys in a batch of 4096 and of 512;
                three rounds of the kernel pair and of its plain version
                on copies of the view leave the same bytes; then the pair's
                device ms per call and per launch, the wrapper's call ms,
                the plain version's device and call ms, each call on a
                fresh batch. ``run_window_insert(torch)`` runs the phase
                alone.
 24. spline corridor — K8 at the cells' bulk load: 16M wikits keys at the
                positions ``UpLIF``'s bulk load gives them (alpha 1.0,
                d_max 32, W 64, max_error 24); the kernel pair's knots
                against the host loop (``_greedy_spline_knots``) and the
                plain version on the card, each bit for bit; then the pair's
                device ms per call and per launch, the wrapper's call ms,
                ``build_radix_spline``'s seconds on the card (copies in and
                the host's radix table included), the plain version's and
                the host loop's seconds, and the divisions the scans made.
                ``run_spline_corridor(torch)`` runs the phase alone.

Phases 13-15 come after the timing because phase 15 retrains the index
that phase 12 times.

Each path's launch counts are reset just before it and read just after;
the kernels line gives them per path (``launches_by_path``) and summed.

The last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before it, as does a machine without CUDA.

Bound (``bound_ms``): the larger of bytes over the H100's 3.35 TB/s and
operations over the 67 TFLOP/s float32 rate (the non-tensor-core rate, also
used for K4's int64 compares, which the table of peaks does not list). For
K1, K2 and K5, bytes count each element the batch needs once: the queries
and outputs, plus the distinct table, knot, position, slot, fence and node
elements that the plain version reads on this batch (recorded while it
runs), at their stored widths. For K3, bytes are the samples, the
parameters and the [N, K] output once, and the operations are 11 per sample
and component. For K4, bytes are the queries, the outputs, the segment
arrays and every key of each tile a query routes to (the function counts
over the whole tile), and the operations are 2048 compares per query the
launch searches. For K6, bytes are lhs, the non-empty groups' rhs and out,
and the operations 2 M K N over the bf16 tensor-core peak (989 TFLOP/s)
or, in float32, which K6 computes without TF32, over 67 TFLOP/s. For K6w,
bytes are the lhs and dout rows that lie in some group and the G K N
output, and the operations 2 x rows x K x N over the same peaks. For K8,
bytes are the keys and positions in and the knots out, and the operations
the float64 divisions the scans make (three a point inside an anchor's
corridor, one at the point that leaves it), each ``K8_DIV_INSTR`` FP64
instructions (its SASS) over the H100's 16.75e12 FP64 instructions a
second (33.5 TFLOP/s, an FMA counted twice); the divisions bound it.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
L2_FLUSH_BYTES = 128 << 20  # read or written between cold launches
F32_OPS_PER_S = 67e12
PROFILE_TRIES = 3           # profiler sessions before CUDA events are used
BATCH = 4096
N_KEYS = 8_000_000          # wikits keys generated; half are bulk-loaded
WAVES = 200                 # 4096-op waves per read/write mix
DELETE_WAVES = 16
ROUTER_WAVES = 100          # 4096-op waves per mix through the router
N_SHARDS = 4
FB_KEYS = 4_000_000
K1_SOURCE = "src/repro_torch/kernels/csrc/fused_locate.cu"
K2_SOURCE = "src/repro_torch/kernels/csrc/bmat_rank.cu"
K3_SOURCE = "src/repro_torch/kernels/csrc/gmm_estep.cu"
K4_SOURCE = "src/repro_torch/kernels/csrc/tile_search.cu"
K5_SOURCE = "src/repro_torch/kernels/csrc/spline_lookup.cu"
K1_REPLACES = "src/repro/kernels/spline_lookup.py:208"
K2_REPLACES = "src/repro/kernels/bmat_rank.py:70"
K3_REPLACES = "src/repro/kernels/gmm_estep.py:28"
K4_REPLACES = "src/repro/kernels/tile_search.py:33"
K5_REPLACES = "src/repro/kernels/spline_lookup.py:74"
K7_SOURCE = "src/repro_torch/kernels/csrc/window_insert.cu"
# not a pallas_call: the JAX package's jnp insert round (grid-segment
# accept and _inplace_window_insert)
K7_REPLACES = "src/repro/core/fops.py:240"
K7_KEYS = 16_000_000        # the read_heavy cell's loaded keys
K7_SLOTS_PER_KEY = 2.67     # a wikits bulk load's slots a key at W 64
K7_OCCUPANCY = 0.375        # its occupied share of the slots
K7_WINDOW = 64
K7_MOVEMENT_K = 6
K7_PENDING = 410            # a read_heavy wave's inserts (10% of 4096)
K7_WIDTHS = (4096, 512)     # the wave's width; the insert's padded width
K7_ITERS = 100
K7_PLAIN_ITERS = 10
K7_SEED = 23
K8_SOURCE = "src/repro_torch/kernels/csrc/spline_corridor.cu"
# not a pallas_call: the host loop of the spline build
K8_REPLACES = "src/repro/core/radix_spline.py:24"
K8_KEYS = 16_000_000        # the cells' loaded keys
K8_SEED = 24
K8_ITERS = 10
F64_INSTR_PER_S = 16.75e12  # the H100's FP64 rate, 33.5 TFLOP/s, in DFMAs
K8_DIV_INSTR = 8            # its SASS: 7 DFMA and 1 DMUL after MUFU.RCP64H
RANGE_BATCHES = 20          # range_query_batch calls per range phase
RANGE_BATCH = 1024          # ranges per call (benchmarks/bench_range.py)
RANGE_MAX_OUT = 512
RANGE_SPAN = 1e-4           # of the key domain
RANGE_WHOLE = 256           # ranges with at most this many live keys: whole
RANK_BATCHES = 20           # adjusted_predict calls of BATCH queries
MIXED_WAVES = 100
WAVE_SPAN = 1e-5            # range span inside a mixed wave
K3_OPS = 11          # float32 operations per sample and component
K3_TOL = 1e-5        # the tolerance of tests/test_kernels.py
K3_MAX_K = 64        # K3 is compared for K 1 .. K3_MAX_K
WIDE_FANOUTS = (128, 256)   # K2 above its one-ballot node round of 64 keys
FORECAST_K = 16      # components of the forecaster phase (16-lane groups)
GATEWAY_CLIENTS = 64        # closed-loop client threads (serve_gateway.py)
GATEWAY_SECONDS = 20.0
GATEWAY_MAX_BATCH = 1024
GATEWAY_RESERVE_EVERY = 97  # every 97th loaded key is reserved for deletes
GATEWAY_REWRITE_EVERY = 7   # every 7th of the rest is one client's to rewrite
ASYNC_WAVES = 8             # 4096-key insert waves of the async phase
ASYNC_REPLAY_CAP = 1024
AGENT_RUN_S = 3.0
AGENT_BURST = 512           # adjacent fresh keys in one insert wave
BASELINE_EVERY = 4          # baselines over every 4th loaded key (1M keys)
PIPELINE_DOCS = 65536
LM_ARCH = "deepseek-7b"     # served at full width and depth (phase 16)
LM_MAX_LEN = 256            # examples/serve_lm.py's engine
LM_NEW = 8                  # serve_lm.py's new tokens per request
LM_TIMED_PROMPTS = 4        # distinct prompts of the timed wave, each twice
LM_TIMED_LEN = 64
LM_TIMED_NEW = 32
LM_FWD = 12                 # tokens of decode against forward
LM_FWD_TOL = 0.15           # tests/test_models_smoke.py's rtol = atol
LM_FWD_AGREE = 0.9          # and its argmax agreement
LM_CPU_LAYERS = 2           # card against CPU at this depth, float32
LM_CPU_TOKENS = 16
LM_CPU_TOL = 1e-3           # see run_lm_serve_path's card-vs-CPU note
LM_LEFT_BYTES = 256 << 20   # allowed on the card after phase 16's tear-down
BF16_OPS_PER_S = 989e12     # the H100's dense bf16 tensor-core peak
MOE_SERVE_ARCH = "deepseek-v2-236b"  # served at full width (phase 17a)
MOE_SERVE_LAYERS = 4        # of 60: 16.94 B parameters, 33.9 GB bfloat16
MOE_CPU_LAYERS = 1          # card against CPU at this depth, float32
MOE_FWD_CF = 16.0           # the reference's decode-against-forward factor
MOE_RAGGED_ARCH = "qwen3-moe-30b-a3b"  # ragged against dense (phase 17b)
MOE_RAGGED_LAYERS = 8       # of 48: 5.61 B parameters, 22.4 GB float32
MOE_RAGGED_BATCH = (2, 256)
MOE_RAGGED_CF = 8.0         # test_moe_ragged_matches_dense's factor
MOE_RAGGED_TOL = 1e-3
# K6 at the main path's shapes (M, K, N, G): qwen3-moe's expert up- and
# down-projections at 2 x 256 tokens x top-8, deepseek-v2's at 512 x top-6
K6_SHAPES = {"qwen3_we1": (4096, 2048, 768, 128),
             "qwen3_we2": (4096, 768, 2048, 128),
             "deepseek_v2_we1": (3072, 5120, 1536, 160)}
K6_HEADLINE = "qwen3_we1 bfloat16"  # phase 17b's bfloat16 up-projection
K6_F32_TOL = 1e-4
BF16_ULP = 2.0 ** -7        # one bf16 ulp is at most 2^-7 of the value
K6_SOURCE = "src/repro_torch/kernels/csrc/ragged_dot.cu"
K6_REPLACES = "src/repro/models/moe.py:81"
MOE_TRAIN_ARCH = "qwen3-moe-30b-a3b"  # the MoE trainer (phase 19c)
MOE_TRAIN_LAYERS = 2        # of 48: 1.87 B parameters, 30 GB of state
MOE_TRAIN_BATCH = (2, 512)
MOE_TRAIN_TOP_K = 8         # qwen3-moe's top-k: K6 and K6w's M is B S top-k
# phase 19: K6 and its backward at the shapes phase 19c's trainer launches
# (qwen3-moe's up- and down-projections at 2 x 512 tokens x top-8; the
# backward's K6 runs each at the other's shape), at phase 17c's shapes,
# with one group of K6W_LONG_ROWS rows (K6w's ring wraps), with empty
# groups and with rows past the sum; the trainers at full width
_M_TRAIN = MOE_TRAIN_BATCH[0] * MOE_TRAIN_BATCH[1] * MOE_TRAIN_TOP_K
K6W_CASES = {"qwen3_train_we1": ((_M_TRAIN, 2048, 768, 128), "routed"),
             "qwen3_train_we2": ((_M_TRAIN, 768, 2048, 128), "routed"),
             **{name: (shape, "routed") for name, shape in K6_SHAPES.items()},
             "long_group": ((4096, 512, 384, 8), "long"),
             "empty": ((1000, 256, 192, 40), "empty"),
             "past_sum": ((1000, 256, 192, 40), "past")}
K6W_PAST_ROWS = 300
K6W_LONG_ROWS = 3000
K6W_HEADLINE = "qwen3_train_we1 bfloat16"  # phase 19c's bf16 up-projection
K6W_SOURCE = "src/repro_torch/kernels/csrc/ragged_dot_wgrad.cu"
# the backward of jax.lax.ragged_dot (moe.py:81) under jax.value_and_grad
K6W_REPLACES = "src/repro/models/moe.py:81"
TRAIN_ARCH = "deepseek-7b"  # the dense trainer (phase 19b)
TRAIN_LAYERS = 4            # of 30: 1.65 B parameters, 26.4 GB of float32
                            # params, grads, m and v
TRAIN_BATCH = (4, 1024)     # PackedCorpus batches, as launch/train.py
TRAIN_STEPS = 8             # through loop.run, one async checkpoint
TRAIN_OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=100)
TRAIN_NM_TOL = 5e-2         # test_microbatched_step_matches_fused's bound
TRAIN_REPEAT = 3            # steps on one batch, whose loss must fall
MOE_TRAIN_STEPS = 3
MOE_SHORT_TOKENS = 16       # 128 picks over 128 experts: some take none
# ragged (K6, K6w: fmaf chains) against dense_chunked (cuBLAS) gradients in
# float32, each leaf within this share of its largest gradient: the same
# products summed in other orders, a few float32 ulps of the terms where
# they cancel
MOE_GRAD_TOL = 1e-4
TRAIN_CPU_ARCHS = ("deepseek-7b", "qwen3-moe-30b-a3b")  # smoke, 19d
TRAIN_CPU_STEPS = 3
TRAIN_CPU_TOL = 1e-4
# Adam moves a weight by up to lr x g / (|g| + eps) a step; where g is at
# the float32 noise floor of its leaf (about 1e-9 at smoke size, under
# eps = 1e-8) the card and the CPU may take steps apart by about 0.1 lr,
# which lr 1e-4 keeps ten times under TRAIN_CPU_TOL
TRAIN_CPU_OCFG = dict(lr=1e-4, warmup_steps=0, total_steps=100)
# Adam's step barely depends on the gradient's size, so the parameters alone
# would not see a gradient of the right sign and wrong magnitude: the losses
# are held within this relative bound, and the first step's gradients leaf
# by leaf within MOE_GRAD_TOL of each leaf's largest gradient
TRAIN_CPU_LOSS_TOL = 1e-5
RESUME_STEPS, RESUME_FAIL, RESUME_EVERY = 20, 12, 5  # the reference's test
# phase 18: (arch, card-against-CPU depth, whether its bfloat16 decode is
# held to its bfloat16 forward) at full width and depth; the depth keeps
# whole pattern groups (recurrentgemma's 13-block pattern). The RG-LRU's
# decode keeps its state and out-projection in float32 where its forward
# runs them in bfloat16 (the reference's promotions): at full width the
# two differ by 0.35, each 0.38-0.42 from the float32 result, so its
# bfloat16 reading is reported and its float32 one required
REC_SERVE = (("recurrentgemma-2b", 13, False), ("rwkv6-1-6b", 2, True))
REC_CPU_MAX_LEN = 32        # 48 tokens into it: recurrentgemma's ring wraps
REC_CPU_TOKENS = 48
ED_ARCH = "whisper-small"   # forward and decode at full width (phase 18c)
ED_TOKENS = 32
# phase 20: the launchers, compressed_psum and the dry run
LAUNCH_SERVE_ARCH = "deepseek-7b"  # served at full width and depth (20a)
LAUNCH_SERVE = dict(requests=6, prompt_len=32, new_tokens=16)
LAUNCH_CLI_TRAIN = ("--steps", "4", "--batch", "2", "--seq", "64")
LAUNCH_RWKV_ARCH = "rwkv6-1-6b"  # one full-width training step (20b)
LAUNCH_RWKV = dict(steps=1, batch=1, seq=1024)
LAUNCH_PSUM_SHAPE = (4096, 1027)  # compressed_psum's input (20c)
LAUNCH_DRYRUN_CELLS = (("deepseek-7b", "train_4k"),
                       ("qwen1-5-110b", "decode_32k"))  # on one pod (20d)
LAUNCH_CLI_TIMEOUT_S = 300
# phase 21: the paper's Fig. 4 at benchmarks/bench_bmat_types.py's sizes
BMAT_SIZES = (1_000, 10_000, 100_000, 1_000_000)
BMAT_QUERIES = 4096
BMAT_CHUNK = 65536          # keys per merge
BMAT_FANOUT = 16
BMAT_ITERS = 7              # timed rank calls, after two warm-up calls
BMAT_SEED = 0
BMAT_DELETE_FRAC = 0.1
# phase 22: benchmarks/bench_gateway.py's index and its two modes
PASS_KEYS = 100_000
PASS_SEED = 0
PASS_SECONDS = 5.0
PASS_MODES = {"passthrough": dict(passthrough=True, max_pending=2048),
              "batched": dict(max_batch=1024, max_delay_s=0.002)}


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        f"nvidia-smi failed: {out.stderr.strip()}"
    )


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def run_main_path(torch, index, runner, waves: int, delete_waves: int):
    """The four mixes and a delete phase; returns per-phase reports and the
    launch counts of the whole run (counts reset just before it)."""
    from repro_torch.data import WORKLOADS
    from repro_torch.kernels import ops

    inserted = []
    for _ in range(2):  # warm-up waves, checked but not timed or counted
        reads, ins = runner.next_batch(0.5)
        f, v = index.lookup(reads)
        require(f.all() and np.array_equal(v, reads + 1), "warm-up reads")
        index.insert(ins, ins + 1)
        inserted.append(ins)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    phases = []
    for mix, rate in WORKLOADS.items():
        before = ops.launch_counts()
        lat, n_ops, n_reads = [], 0, 0
        for _ in range(waves):
            reads, ins = runner.next_batch(rate)
            inserted.append(ins)
            t0 = time.perf_counter()
            if len(reads):
                found, vals = index.lookup(reads)
            if len(ins):
                index.insert(ins, ins + 1)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
            n_ops += len(reads) + len(ins)
            if len(reads):
                n_reads += len(reads)
                require(found.all(), f"{mix}: {int((~found).sum())} reads missed")
                require(np.array_equal(vals, reads + 1), f"{mix}: wrong values")
        phases.append(_phase_report(
            torch, mix, lat, n_ops, before, ops.launch_counts(), n_reads,
            UPLIF_KERNELS, bmat_size=index.bmat.size, capacity=index.capacity,
        ))

    # delete phase: known keys (bulk-loaded and never deleted before)
    victims = runner.init_keys[:: max(1, len(runner.init_keys) // (delete_waves * BATCH))]
    victims = victims[: delete_waves * BATCH]
    before = ops.launch_counts()
    lat = []
    for w in range(delete_waves):
        chunk = victims[w * BATCH:(w + 1) * BATCH]
        t0 = time.perf_counter()
        hit = index.delete(chunk)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        require(hit.all(), f"delete: {int((~hit).sum())} known keys not hit")
    phases.append(_phase_report(
        torch, "delete", lat, len(victims), before, ops.launch_counts(), 0,
        UPLIF_KERNELS, bmat_size=index.bmat.size, capacity=index.capacity,
    ))
    found, _ = index.lookup(victims[:BATCH])
    require(not found.any(), "deleted keys are still found")
    counts = ops.launch_counts()
    live = np.setdiff1d(np.union1d(runner.init_keys, np.concatenate(inserted)),
                        victims)
    return phases, counts, live


def profile_waves(torch, index, runner, rate: float, waves: int,
                  tuner=None, label="uplif"):
    """Device busy and idle share over a few mixed waves (each followed by
    the tuner's calls when one is given), from the profiler's device events
    (kernels and copies on the one stream)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(waves):
            w0 = time.perf_counter()
            reads, ins = runner.next_batch(rate)
            index.lookup(reads)
            index.insert(ins, ins + 1)
            if tuner is not None:
                tuner.observe_inserts(ins)
                tuner.after_wave(len(reads) + len(ins),
                                 time.perf_counter() - w0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("profile: device time not measured (no device events)")
        return None
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    rep = {
        "path": label, "waves": waves, "write_rate": rate,
        "wall_ms_per_wave": wall_ms / waves,
        "device_busy_ms_per_wave": busy_ms / waves,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_ops_per_wave": len(dev) / waves,
        "kernel_device_ms_per_wave": {
            name: sum(v for k, v in by_name.items() if name in k) / 1e3 / waves
            for name in ("fused_locate_kernel", "bmat_rank_kernel",
                         "gmm_estep_kernel")
        },
        "top_device_ms_per_wave": {k[:60]: v / 1e3 / waves for k, v in top},
    }
    print("profile " + json.dumps(rep), flush=True)
    return rep


def _phase_report(torch, name, lat, n_ops, before, after, reads, kernels,
                  **extra):
    """One phase's numbers; every kernel in ``kernels`` must have launched
    during the phase."""
    grew = {k: after[k] - before[k] for k in after}
    require(all(grew[k] > 0 for k in kernels),
            f"{name}: a kernel of {kernels} was not launched: {grew}")
    lat_ms = np.asarray(lat) * 1e3
    rep = {
        "phase": name,
        "waves": len(lat),
        "ops": n_ops,
        "reads_checked": reads,
        "mops_per_s": n_ops / float(np.sum(lat)) / 1e6,
        "wave_ms_p50": float(np.percentile(lat_ms, 50)),
        "wave_ms_p99": float(np.percentile(lat_ms, 99)),
        "launches_per_wave": {k: v / len(lat) for k, v in grew.items()},
        **extra,
        "device_mem_mib": torch.cuda.memory_allocated() / 2**20,
    }
    print("phase " + json.dumps(rep), flush=True)
    return rep


UPLIF_KERNELS = ("fused_locate", "bmat_rank")


# ---------------------------------------------------------------------------
# main path: the router with the self-tuning loop
# ---------------------------------------------------------------------------


def _router_wave(torch, router, tuner, runner, rate, label):
    """One served wave, as ``examples/serve_index.py`` serves it: lookup and
    insert (timed; the wave ends in a sync), then the tuner's calls (timed
    apart). Every read is checked."""
    reads, ins = runner.next_batch(rate)
    t0 = time.perf_counter()
    if len(reads):
        found, vals = router.lookup(reads)
    if len(ins):
        router.insert(ins, ins + 1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if len(reads):
        require(found.all(), f"{label}: {int((~found).sum())} reads missed")
        require(np.array_equal(vals, reads + 1), f"{label}: wrong values")
    t1 = time.perf_counter()
    if tuner is not None:
        tuner.observe_inserts(ins)
        tuner.after_wave(len(reads) + len(ins), dt)
    return ins, dt, time.perf_counter() - t1, len(reads)


def run_router_path(torch, keys, waves: int):
    """The router + sync tuner through the four mixes; returns the router,
    the tuner, the runner, the inserted key batches, the per-phase reports
    and the launch counts of the run (counts reset just before it)."""
    from repro_torch.core import ShardedUpLIF
    from repro_torch.data import WORKLOADS, WorkloadRunner
    from repro_torch.kernels import ops
    from repro_torch.tuning import SelfTuner

    runner = WorkloadRunner(keys, init_frac=0.5, batch=BATCH, seed=0)
    t0 = time.perf_counter()
    router = ShardedUpLIF(runner.init_keys, runner.init_keys + 1,
                          n_shards=N_SHARDS)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cap = int(router.state.slots.keys.shape[1])
    require(router.shard_locate() == ("fused",) * N_SHARDS,
            "router: auto did not resolve to fused")
    require(ops.locate_fusable(cap, router.state.model.spline_keys.shape[1]),
            "router: per-shard capacity above the float32 position bound")
    tuner = SelfTuner().attach(router)
    require(tuner.forecaster.cfg.use_kernel, "forecaster is not on K3")
    print(f"router bulk load: {len(runner.init_keys)} keys in {load_s:.1f} s, "
          f"{router.n_shards} shards of {cap} slots, knots "
          f"{router.state.model.spline_keys.shape[1]}, rs_iters "
          f"{router.rs_iters}, device memory "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB", flush=True)

    inserted = []
    for _ in range(2):  # warm-up waves, checked but not timed or counted
        inserted.append(_router_wave(torch, router, tuner, runner, 0.5,
                                     "router warm-up")[0])
    ops.reset_launch_counts()
    phases = []
    for mix, rate in WORKLOADS.items():
        before = ops.launch_counts()
        lat, tun, n_ops, n_reads = [], [], 0, 0
        for _ in range(waves):
            ins, dt, tt, nr = _router_wave(torch, router, tuner, runner, rate,
                                           f"router {mix}")
            inserted.append(ins)
            lat.append(dt)
            tun.append(tt)
            n_ops += nr + len(ins)
            n_reads += nr
        st = tuner.stats()
        tun_ms = np.asarray(tun) * 1e3
        phases.append(_phase_report(
            torch, f"router {mix}", lat, n_ops, before, ops.launch_counts(),
            n_reads, UPLIF_KERNELS + (("gmm_estep",) if rate > 0 else ()),
            mops_per_s_with_tuner=n_ops / float(np.sum(lat) + np.sum(tun))
            / 1e6,
            tuner_ms_p50=float(np.percentile(tun_ms, 50)),
            tuner_ms_p99=float(np.percentile(tun_ms, 99)),
            tuner_ms_total=float(tun_ms.sum()),
            bmat_size=router.measures()["bmat_size"],
            capacity=router.capacity,
            tuner={k: st[k] for k in ("plans", "commits", "conflicts",
                                       "abandoned", "actions", "n_shards",
                                       "epoch", "time_in_maintenance_s")},
        ))
    return router, tuner, runner, inserted, phases, ops.launch_counts()


def router_maintenance(torch, router, tuner, runner, inserted):
    """One each of retrain-shard (with the forecaster's GMM), split-shard
    and merge-shards through the scheduler's build + commit, and a BMAT
    switch (the scheduler's direct action); a checked read wave after
    each."""
    from repro_torch.tuning import (
        A_MERGE_SHARDS, A_RETRAIN_SHARD, A_SPLIT_SHARD,
    )

    sched = tuner.scheduler
    require(tuner.forecaster.ready, "the forecaster has no forecast yet")
    hot = int(np.argmax(router.state.bmat.size.cpu().numpy()))

    def dispatch(action, shard):
        plan = sched._make_plan(action, shard, False)
        if action == A_RETRAIN_SHARD:
            require(plan.gmm is tuner.forecaster.gmm,
                    "the retrain plan does not carry the forecaster's GMM")
        return sched._dispatch(router, plan)

    def switch_bmat():
        router.switch_bmat_type()
        return True

    steps = [
        ("retrain_shard", lambda: dispatch(A_RETRAIN_SHARD, hot)),
        ("split_shard", lambda: dispatch(A_SPLIT_SHARD, 0)),
        ("merge_shards", lambda: dispatch(A_MERGE_SHARDS, 0)),
        ("switch_bmat", switch_bmat),
    ]
    report = []
    for name, step in steps:
        bsize = int(router.state.bmat.size.sum())
        t0 = time.perf_counter()
        ok = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        require(ok, f"maintenance {name} did not commit")
        inserted.append(_router_wave(torch, router, None, runner, 0.0,
                                     f"read wave after {name}")[0])
        report.append({"action": name, "seconds": dt,
                       "bmat_size_before": bsize,
                       "bmat_size_after": int(router.state.bmat.size.sum()),
                       "n_shards": router.n_shards, "epoch": router.epoch})
    print("maintenance " + json.dumps(report), flush=True)
    return report


def _router_contents(router):
    """The router's live (keys, vals), sorted, from every shard's shell."""
    parts = [router._unstack_shell(s).extract_live()
             for s in range(router.n_shards)]
    return (np.concatenate([k for k, _ in parts]),
            np.concatenate([v for _, v in parts]))


def check_router_contents(router, runner, inserted, deleted=None):
    """The router's live contents equal the loaded plus inserted keys (less
    ``deleted``), each with value key + 1. Returns them, sorted."""
    want = np.unique(np.concatenate([runner.init_keys] + inserted))
    if deleted is not None:
        want = np.setdiff1d(want, deleted)
    keys, vals = _router_contents(router)
    require(np.array_equal(keys, want),
            f"router contents: {len(keys)} live keys, expected {len(want)}")
    require(np.array_equal(vals, keys + 1), "router contents: wrong values")
    require(router.size == len(want), "router size differs from its contents")
    print(f"router contents: {len(keys)} live keys == loaded + inserted"
          + (" - deleted" if deleted is not None else ""), flush=True)
    return want


# ---------------------------------------------------------------------------
# kernel inputs, comparisons and timing
# ---------------------------------------------------------------------------


def kernel_inputs(torch, index, queries):
    """K1 and K2 inputs as the main path gives them, for one query batch
    (a single index, so no shard ids)."""
    st = index.fstatic()
    m, b = index.rs_model, index.bmat.state
    q = torch.as_tensor(queries, device=index.device)
    k1 = dict(
        args=(m.table, m.spline_keys, m.spline_pos, m.shift.reshape(1),
              index.slots.keys, q),
        kw=dict(n_table=m.table.shape[0], n_knots=m.spline_keys.shape[0],
                cap=index.capacity, window=st.window, rs_iters=st.rs_iters),
    )
    k2 = dict(
        args=(b.keys, b.fences, q),
        kw=dict(cap=b.keys.shape[0], nf=b.fences.shape[0], fanout=st.fanout),
    )
    return k1, k2


def query_mix(rng, keys, n=BATCH):
    """Hits, misses inside the domain, keys above it, and KEY_MAX."""
    from repro_torch.core.types import KEY_MAX

    lo, hi = int(keys[0]), int(keys[-1])
    return np.concatenate([
        rng.choice(keys, n // 2),
        rng.integers(lo, hi, n // 4),
        hi + 1 + rng.integers(0, 1 << 40, n // 4 - 2),
        [KEY_MAX, KEY_MAX],
    ]).astype(np.int64)


def router_kernel_inputs(torch, router, queries):
    """K1 and K2 inputs as the router's stacked ops give them: arrays flat
    over the shard axis, a shard id per query."""
    st = router._static()
    m, b = router.state.model, router.state.bmat
    S, cap = router.state.slots.keys.shape
    q = torch.as_tensor(queries, device=router.device)
    sid = torch.searchsorted(router._tbounds, q, right=True)
    k1 = dict(
        args=(m.table.reshape(-1), m.spline_keys.reshape(-1),
              m.spline_pos.reshape(-1), m.shift,
              router.state.slots.keys.reshape(-1), q, sid),
        kw=dict(n_table=m.table.shape[1], n_knots=m.spline_keys.shape[1],
                cap=cap, window=st.window, rs_iters=st.rs_iters),
    )
    k2 = dict(
        args=(b.keys.reshape(-1), b.fences.reshape(-1), q, sid),
        kw=dict(cap=b.keys.shape[1], nf=b.fences.shape[1], fanout=st.fanout),
    )
    return k1, k2


def k1_shape(k1) -> dict:
    """What sets K1's chain of reads on a single index: the knots, the
    knot bisect's steps and the widest radix bucket (in knots), the window
    W and span L, and the slot array's offset from a 128-byte line."""
    table, slots = k1["args"][0], k1["args"][4]
    kw = k1["kw"]
    t = table.long()
    return dict(n_knots=kw["n_knots"], rs_iters=kw["rs_iters"],
                widest_bucket=int((t[1:] - t[:-1]).max()),
                window=kw["window"], L=min(3 * kw["window"], kw["cap"]),
                slot_offset_mod_128=slots.data_ptr() % 128)


def compare_kernels(torch, k1, k2, label):
    """K1 and K2 against their plain versions on the card (K1 in both of
    its interpolation modes); returns (K1 max abs err, K2 max abs err)."""
    from repro_torch.kernels.bmat_rank import bmat_rank, bmat_rank_plain
    from repro_torch.kernels.spline_lookup import (
        fused_locate, fused_locate_plain,
    )

    err1 = 0
    for interp64 in (False, True):
        kw = dict(k1["kw"], interp64=interp64)
        j, start = fused_locate(*k1["args"], **kw)
        j0, start0 = fused_locate_plain(*k1["args"], **kw)
        torch.cuda.synchronize()
        mode = "float64" if interp64 else "float32"
        print(f"kernels[{label}]: K1 {mode} j differ {int((j != j0).sum())}, "
              f"start rows differ {int((start != start0).sum())} "
              f"(expected 0)", flush=True)
        require(torch.equal(j, j0),
                f"{label}: K1 ({mode}) j differs from its plain version")
        require(torch.equal(start, start0),
                f"{label}: K1 ({mode}) start differs from its plain version")
        err1 = max(err1, int((j - j0).abs().max()),
                   int((start - start0).abs().max()))
    r = bmat_rank(*k2["args"], **k2["kw"])
    r0 = bmat_rank_plain(*k2["args"], **k2["kw"])
    torch.cuda.synchronize()
    print(f"kernels[{label}]: K2 ranks differ {int((r != r0).sum())}",
          flush=True)
    require(torch.equal(r, r0), f"{label}: K2 differs from its plain version")
    return err1, int((r - r0).abs().max())


def compare_index_kernels(torch, index, queries, label):
    k1, k2 = kernel_inputs(torch, index, queries)
    print(f"kernels[{label}]: bmat_size {index.bmat.size}, capacity "
          f"{index.capacity}, shift {int(index.rs_model.shift)}", flush=True)
    return compare_kernels(torch, k1, k2, label)


def read_footprint(torch, plain, args, kw, arrays) -> int:
    """Bytes of the distinct elements of ``arrays`` (name -> tensor passed
    in ``args``) that one call of the plain version reads, recorded from
    its indexing while it runs."""
    from torch.overrides import TorchFunctionMode

    seen = {name: [] for name in arrays}

    class Reads(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is torch.Tensor.__getitem__ and isinstance(
                    args[1], torch.Tensor):
                for name, a in arrays.items():
                    if args[0] is a:
                        seen[name].append(args[1].reshape(-1))
            return func(*args, **(kwargs or {}))

    with Reads():
        plain(*args, **kw)
    return sum(
        int(torch.unique(torch.cat(idx)).numel()) * arrays[name].element_size()
        for name, idx in seen.items() if idx
    )


def _per_call_ms(events, iters: int, skip=()) -> float:
    """Device ms per call from the profiler's device events of ``iters``
    calls, leaving out the events whose name holds a string of ``skip``:
    per kernel name, the mean duration times its launches per call (its
    event count over ``iters``, rounded). The profiler on the H100 machine
    drops a share of the events in some sessions (up to 12% seen); this
    sum does not count a dropped launch as a launch that took no time."""
    by_name = {}
    for e in events:
        if not any(m in e.name for m in skip):
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return sum(float(np.mean(v)) * max(1, round(len(v) / iters))
               for v in by_name.values()) / 1e3


def _device_events(torch, body):
    """The profiler's device events of one ``body()``. The profiler on the
    H100 machine records no device event at all in some sessions, so a
    session that saw none is run again, up to ``PROFILE_TRIES`` times in
    all; None if every one saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if dev:
            return dev
    return None


def device_ms(torch, fn, iters: int) -> float:
    """Device time per call: the profiler's device events (the kernels and
    copies the call ran) over ``iters`` calls, per call (``_per_call_ms``).
    Host dispatch between launches is not counted. Where the profiler sees
    no device event, the time between CUDA events (``call_ms``) instead,
    which also counts the dispatch it cannot hide; a line says so."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(iters):
            fn()

    dev = _device_events(torch, body)
    if dev is None:
        print("device_ms: the profiler saw no device event; timed between "
              "CUDA events", flush=True)
        return call_ms(torch, fn, iters)
    return _per_call_ms(dev, iters)


def cold_ms(torch, fn, iters: int, flush: str = "read") -> float:
    """Device time per call as ``device_ms`` counts it, with the L2 flushed
    before every call by an op over ``L2_FLUSH_BYTES`` (over twice the
    H100's 50 MB L2): a ``"read"`` (a sum, which leaves clean lines of its
    own in the L2) or a ``"write"`` (a fill, which leaves dirty lines that
    the timed call writes back as it evicts them). The flush's device events
    are known by name and left out. Where the profiler sees no device
    event, the mean time between CUDA events recorded around each call
    after its flush instead; a line says so."""
    buf = torch.zeros(L2_FLUSH_BYTES // 8, dtype=torch.int64, device="cuda")
    step, marks = {
        "read": (lambda i: buf.sum(), ("sum_functor", "Memset")),
        "write": (lambda i: buf.fill_(i), ("FillFunctor<long>",)),
    }[flush]
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def body():
        for i in range(iters):
            step(i)
            fn()

    dev = _device_events(torch, body)
    if dev is None:
        print("cold_ms: the profiler saw no device event; timed between "
              "CUDA events", flush=True)
        pairs = []
        for i in range(iters):
            step(i)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            pairs.append((t0, t1))
        torch.cuda.synchronize()
        return float(np.mean([t0.elapsed_time(t1) for t0, t1 in pairs]))
    n_flush = sum(marks[0] in e.name for e in dev)
    n_call = sum(not any(m in e.name for m in marks) for e in dev)
    require(n_flush >= iters // 2 and n_call >= iters // 2,
            f"cold timing: the profiler saw {n_flush} flushes and {n_call} "
            f"device events of the call for {iters} calls")
    return _per_call_ms(dev, iters, marks)


def call_ms(torch, fn, iters: int) -> float:
    """Time per call between CUDA events around ``iters`` back-to-back
    calls: the kernel plus whatever host dispatch it cannot hide."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(n_bytes: float, n_f32_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_f32_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_timing(torch, index, queries):
    from repro_torch.kernels import ops
    from repro_torch.kernels.bmat_rank import bmat_rank, bmat_rank_plain
    from repro_torch.kernels.spline_lookup import (
        fused_locate, fused_locate_plain,
    )

    k1, k2 = kernel_inputs(torch, index, queries)
    q = k1["args"][5]
    n = q.shape[0]
    m, b = index.rs_model, index.bmat.state
    slot_keys = index.slots.keys
    # queries in, (j, start) out, the shift, and the distinct probes
    k1_bytes = n * (8 + 16) + m.shift.element_size() + read_footprint(
        torch, fused_locate_plain, k1["args"], k1["kw"],
        dict(table=m.table, spline_keys=m.spline_keys,
             spline_pos=m.spline_pos, slot_keys=slot_keys),
    )
    k1_ops = n * 12  # conversions, subs, mul, div, clamps, fma, round
    # queries in, rank out, and the distinct fence and node probes
    k2_bytes = n * (8 + 8) + read_footprint(
        torch, bmat_rank_plain, k2["args"], k2["kw"],
        dict(keys=b.keys, fences=b.fences),
    )
    calls = {
        "fused_locate": (
            lambda: fused_locate(*k1["args"], **k1["kw"]),
            lambda: ops.fused_locate(*k1["args"], **k1["kw"]),
            lambda: fused_locate_plain(*k1["args"], **k1["kw"]),
            lambda: torch.searchsorted(slot_keys, q, right=True),
            k1_bytes, bound_ms(k1_bytes, k1_ops),
        ),
        "bmat_rank": (
            lambda: bmat_rank(*k2["args"], **k2["kw"]),
            lambda: bmat_rank(*k2["args"], **k2["kw"]),
            lambda: bmat_rank_plain(*k2["args"], **k2["kw"]),
            lambda: torch.searchsorted(b.keys, q),
            k2_bytes, bound_ms(k2_bytes, 0),
        ),
    }
    timing = {
        name: dict(
            ms=device_ms(torch, kern, 200),
            call_ms=call_ms(torch, adapter, 200),
            plain_ms=device_ms(torch, plain, 10),
            library_ms=device_ms(torch, lib, 200),
            bytes=n_bytes,
            bound=bound,
        )
        for name, (kern, adapter, plain, lib, n_bytes, bound) in calls.items()
    }
    # K1 with the L2 flushed by a read before each launch: a main-path wave
    # finds its 4096 spans cold, where 200 warm launches keep them in L2
    kern, _, _, lib = calls["fused_locate"][:4]
    timing["fused_locate"].update(cold_ms=cold_ms(torch, kern, 200),
                                  library_cold_ms=cold_ms(torch, lib, 200))
    k1t = timing["fused_locate"]
    print(f"K1 timing: {json.dumps(k1_shape(k1))}, {n} queries: "
          f"{k1t['ms']:.5f} ms warm, {k1t['cold_ms']:.5f} ms after a read "
          f"flush per launch (torch.searchsorted {k1t['library_ms']:.5f} / "
          f"{k1t['library_cold_ms']:.5f} ms)", flush=True)
    # the device time of one trivial launch: how much of a small kernel's
    # time is the launch and not its work
    x = torch.zeros(BATCH, dtype=torch.int64, device=q.device)
    floor = device_ms(torch, lambda: x.add_(1), 200)
    print(f"K2 timing: BMAT cap {k2['kw']['cap']}, nf {k2['kw']['nf']}, "
          f"fanout {k2['kw']['fanout']}, {n} queries: "
          f"{timing['bmat_rank']['ms']:.5f} ms per launch (torch.searchsorted "
          f"{timing['bmat_rank']['library_ms']:.5f} ms); one trivial launch "
          f"(add_ on {BATCH} int64) {floor:.5f} ms", flush=True)
    return timing


def k3_args(torch, fc, keys):
    """K3's float32 inputs as the forecaster gives them for ``keys``."""
    xs, w, ms, ss = fc.kernel_inputs(np.asarray(keys, dtype=np.float64))
    return xs, w.float(), ms.float(), ss.float()


def compare_k3(torch, fc, batch):
    """K3 against its plain version on the card: unit-domain samples for N
    in 1..8193 and K in 1..K3_MAX_K (lane groups of 1 to 32, then a warp
    per sample), and the forecaster's own inputs for one main-path insert
    batch. Returns the max abs error."""
    from repro_torch.kernels.gmm_estep import gmm_estep
    from repro_torch.kernels.ref import gmm_estep_plain

    rng = np.random.default_rng(3)
    cases = []
    for n in (1, 31, 100, 2048, 5000, 8193):
        for k in range(1, K3_MAX_K + 1):
            arrays = (rng.uniform(0, 1, n), rng.dirichlet(np.ones(k)),
                      np.sort(rng.uniform(0, 1, k)), rng.uniform(0.01, 0.3, k))
            cases.append((f"N={n} K={k}", [
                torch.as_tensor(a.astype(np.float32), device="cuda")
                for a in arrays]))
    cases.append(("forecaster", list(k3_args(torch, fc, batch))))
    err = 0.0
    for label, args in cases:
        got = gmm_estep(*args)
        want = gmm_estep_plain(*args)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        rows = float((got.sum(1) - 1).abs().max())
        require(e <= K3_TOL and rows <= K3_TOL,
                f"K3 ({label}): max abs error {e}, row-sum error {rows}")
        err = max(err, e)
    print(f"kernels[gmm]: K3 max abs error {err:.3g} over {len(cases)} cases "
          f"(tolerance {K3_TOL})", flush=True)
    return err


def k3_timing(torch, fc, ins):
    """K3 on one write-heavy wave's insert keys, as the forecaster calls
    it."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.gmm_estep import gmm_estep
    from repro_torch.kernels.ref import gmm_estep_plain

    args = k3_args(torch, fc, ins)
    raw = fc.kernel_inputs(np.asarray(ins, dtype=np.float64))
    n, k = args[0].shape[0], args[1].shape[0]
    n_bytes = 4 * (n + n * k + 3 * k)  # samples, out, parameters
    x = np.asarray(ins, dtype=np.float64)
    t0 = time.perf_counter()
    for _ in range(50):
        fc._responsibilities(x)
    estep_ms = (time.perf_counter() - t0) * 1e3 / 50
    return dict(
        ms=device_ms(torch, lambda: gmm_estep(*args), 200),
        call_ms=call_ms(torch, lambda: ops.gmm_estep(*raw), 200),
        plain_ms=device_ms(torch, lambda: gmm_estep_plain(*args), 50),
        library_ms=None,
        bytes=n_bytes,
        bound=bound_ms(n_bytes, n * k * K3_OPS),
        n=n, k=k,
        forecaster_estep_ms=estep_ms,
    )


def wide_fanout_k2(torch, index, queries):
    """K2 at each of WIDE_FANOUTS on the main path's BMAT (its keys, fences
    made at that fanout) against its plain version, and its device time
    per launch beside ``torch.searchsorted``. Returns (max abs error,
    variants for the kernels line)."""
    from repro_torch.core.bmat import _make_fences
    from repro_torch.kernels.bmat_rank import bmat_rank, bmat_rank_plain

    keys = index.bmat.state.keys
    q = torch.as_tensor(queries, device=keys.device)
    err, variants = 0, {}
    for fanout in WIDE_FANOUTS:
        fences = _make_fences(keys, fanout)
        args = (keys, fences, q)
        kw = dict(cap=keys.shape[0], nf=fences.shape[0], fanout=fanout)
        r = bmat_rank(*args, **kw)
        r0 = bmat_rank_plain(*args, **kw)
        torch.cuda.synchronize()
        require(torch.equal(r, r0),
                f"K2 at fanout {fanout} differs from its plain version")
        err = max(err, int((r - r0).abs().max()))
        n_bytes = q.shape[0] * 16 + read_footprint(
            torch, bmat_rank_plain, args, kw, dict(keys=keys, fences=fences))
        variants[f"fanout_{fanout}"] = dict(
            ms=device_ms(torch, lambda: bmat_rank(*args, **kw), 200),
            plain_ms=device_ms(torch, lambda: bmat_rank_plain(*args, **kw),
                               10),
            library_ms=device_ms(torch, lambda: torch.searchsorted(keys, q),
                                 200),
            bound_ms=bound_ms(n_bytes, 0)[0], cap=kw["cap"], nf=kw["nf"])
    print(f"kernels[wide fanout]: K2 equals its plain version at fanouts "
          f"{WIDE_FANOUTS} on the main path's BMAT ({index.bmat.size} keys "
          f"in {keys.shape[0]}); " + json.dumps(variants), flush=True)
    return err, variants


def fanout_path(torch):
    """An index with ``bmat_fanout`` WIDE_FANOUTS[0] and the fused locate
    through the op tape's write waves on the card, counted from zero, and
    on the CPU: lookups and adjusted ranks after every op, overflow counts,
    live contents and the slot and BMAT arrays must be identical, and K1
    and K2 must have launched on the card. Returns the launch counts."""
    from repro_torch.core import UpLIF, UpLIFConfig
    from repro_torch.kernels import ops

    fanout = WIDE_FANOUTS[0]
    base, ops_tape, probes = tape(seed=10)
    cfg = UpLIFConfig(bmat_fanout=fanout, locate="fused")
    results, counts = {}, None
    for dev in ("cuda", "cpu"):
        idx = UpLIF(base, base + 1, cfg, device=dev)
        if dev == "cuda":
            torch.cuda.synchronize()
            ops.reset_launch_counts()
        out = []
        for op in ops_tape:
            if op[0] == "insert":
                out.append(np.asarray(idx.insert(op[1], op[2])))
            else:
                out.append(idx.delete(op[1]))
            out.extend(idx.lookup(probes))
            out.append(idx.adjusted_predict(probes))
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        out.extend(idx.extract_live())
        arrays = [a.cpu().numpy() for a in (*idx.slots, idx.bmat.state.keys,
                                            idx.bmat.state.vals)]
        results[dev] = (out, arrays, idx.bmat.size, idx.fstatic().fanout)
    require(all(counts[k] > 0 for k in UPLIF_KERNELS),
            f"fanout {fanout}: a kernel was not launched: {counts}")
    cuda, cpu = results["cuda"], results["cpu"]
    require(cuda[3] == fanout and cuda[2] > 2 * fanout,
            f"fanout {fanout}: static fanout {cuda[3]}, BMAT size {cuda[2]}")
    _same_outputs(cuda[0], cpu[0], f"fanout {fanout}: card and CPU differ")
    _same_outputs(cuda[1], cpu[1],
                  f"fanout {fanout}: card and CPU slot or BMAT arrays differ")
    print(f"fanout path: bmat_fanout {fanout}, {len(ops_tape)} write waves, "
          f"BMAT {cuda[2]} keys; card == CPU (results, ranks, overflow "
          f"counts, contents, arrays); launches {counts}", flush=True)
    return counts


def forecaster_path(torch, lo, hi, batch):
    """A forecaster with FORECAST_K components on the card (K3 by default
    there) observes one write-heavy wave's insert keys, counted from zero;
    the same forecaster on the CPU (K3's plain version) must give the same
    mixture (rtol 1e-4 on the components that hold samples) and
    responsibilities within K3_TOL on the next batch. Returns the launch
    counts."""
    from repro_torch.kernels import ops
    from repro_torch.tuning.forecast import ForecastConfig, UpdateForecaster

    cfg = ForecastConfig(n_components=FORECAST_K)
    fc = UpdateForecaster(lo, hi, cfg, device="cuda")
    ref = UpdateForecaster(lo, hi, ForecastConfig(
        n_components=FORECAST_K, use_kernel=True), device="cpu")
    require(fc.cfg.use_kernel, "the forecaster on CUDA does not use K3")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    fc.observe(batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require(counts["gmm_estep"] == 1, f"forecaster: K3 launches {counts}")
    ref.observe(batch)
    live = ref._s0 >= 1e-6
    require(np.array_equal(fc._s0 >= 1e-6, live) and all(
        np.allclose(a.numpy()[live], b.numpy()[live], rtol=1e-4, atol=0)
        for a, b in zip(fc.gmm, ref.gmm)),
        "forecaster: the mixture on the card differs from the CPU's")
    x = np.asarray(batch, dtype=np.float64)[::-1].copy()
    err = float(np.abs(fc._responsibilities(x)
                       - ref._responsibilities(x)).max())
    require(err <= K3_TOL, f"forecaster: responsibilities differ by {err}")
    print(f"forecaster path: K = {FORECAST_K}, {len(batch)} insert keys "
          f"observed on the card; mixture == CPU's on {int(live.sum())} "
          f"live components, responsibilities within {err:.3g}; launches "
          f"{counts}", flush=True)
    return counts


# ---------------------------------------------------------------------------
# the range path: range scans, the adjusted rank, mixed waves
# ---------------------------------------------------------------------------


def check_ranges(lo, hi, ks, vs, live, label, max_out=RANGE_MAX_OUT):
    """Every row is strictly increasing, inside [lo, hi], with value
    key + 1, and holds only live keys (so no deleted one); a range whose
    live count in the sorted oracle ``live`` is at most RANGE_WHOLE comes
    back whole. Returns the number of ranges checked whole and the number
    that came back as the first min(live count, ``max_out``) live keys of
    their range (counted, not required: a row may stop short where the
    scan's slot window ends)."""
    a = np.searchsorted(live, lo, "left")
    b = np.searchsorted(live, hi, "right")
    n_whole = n_prefix = 0
    for i, (k, v) in enumerate(zip(ks, vs)):
        require(np.all(k[1:] > k[:-1]), f"{label}: range {i} not sorted")
        require(len(k) == 0 or (k[0] >= lo[i] and k[-1] <= hi[i]),
                f"{label}: range {i} outside [lo, hi]")
        require(np.array_equal(v, k + 1), f"{label}: range {i} values")
        if b[i] - a[i] <= RANGE_WHOLE:
            require(np.array_equal(k, live[a[i]:b[i]]),
                    f"{label}: range {i} is not whole")
            n_whole += 1
        n_prefix += int(len(k) == min(b[i] - a[i], max_out)
                        and np.array_equal(k, live[a[i]:a[i] + len(k)]))
    got = np.concatenate(ks)
    idx = np.clip(np.searchsorted(live, got), 0, len(live) - 1)
    require(np.array_equal(live[idx], got),
            f"{label}: a range returned a key that is not live")
    return n_whole, n_prefix


def _lat_report(lat, n_items, unit):
    lat_ms = np.asarray(lat) * 1e3
    return {"batches": len(lat), f"{unit}_per_s": n_items / float(np.sum(lat)),
            "ms_p50": float(np.percentile(lat_ms, 50)),
            "ms_p99": float(np.percentile(lat_ms, 99))}


def run_range_path(torch, index, live, label, boundaries=(), tuner=None,
                   tombstones=0):
    """RANGE_BATCHES calls of RANGE_BATCH ranges (span RANGE_SPAN of the
    domain, ``max_out`` RANGE_MAX_OUT; a sixteenth of them straddle each
    of ``boundaries``) through ``range_query_batch``, then RANK_BATCHES
    batches of BATCH queries through ``adjusted_predict``. The launch
    counts are reset just before and read just after. The rank must lie
    within ``tombstones`` (deleted BMAT entries, which the bias r(k) still
    counts) above the oracle's searchsorted-left rank; with none it must
    equal it. Returns (report, launch counts)."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(4)
    k_lo, k_hi = int(live[0]), int(live[-1])
    span = int((k_hi - k_lo) * RANGE_SPAN)

    def batch():
        lo = rng.integers(k_lo, k_hi, RANGE_BATCH)
        for i, cut in enumerate(boundaries):
            m = RANGE_BATCH // 16
            lo[i * m:(i + 1) * m] = cut - rng.integers(0, span, m)
        return lo, lo + span

    lo, hi = batch()  # warm-up call, checked but not timed or counted
    check_ranges(lo, hi, *index.range_query_batch(lo, hi, RANGE_MAX_OUT),
                 live, f"{label} warm-up")
    index.adjusted_predict(live[:BATCH])
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    lat, n_whole, n_prefix, n_keys = [], 0, 0, 0
    for _ in range(RANGE_BATCHES):
        lo, hi = batch()
        t0 = time.perf_counter()
        ks, vs = index.range_query_batch(lo, hi, RANGE_MAX_OUT)
        dt = time.perf_counter() - t0  # rows come back as numpy: synced
        lat.append(dt)
        if tuner is not None:
            tuner.observe_range(len(lo), dt)
        whole, prefix = check_ranges(lo, hi, ks, vs, live, f"{label} ranges")
        n_whole += whole
        n_prefix += prefix
        n_keys += sum(len(k) for k in ks)
    range_counts = ops.launch_counts()
    rank_lat = []
    for _ in range(RANK_BATCHES):
        q = np.concatenate([rng.choice(live, BATCH * 3 // 4),
                            rng.integers(k_lo, k_hi, BATCH // 4)])
        t0 = time.perf_counter()
        r = index.adjusted_predict(q)
        rank_lat.append(time.perf_counter() - t0)
        exact = np.searchsorted(live, q, "left")
        require(np.all(r >= exact) and np.all(r <= exact + tombstones),
                f"{label}: adjusted_predict off the oracle by "
                f"{int(np.abs(r - exact).max())} (tombstones {tombstones})")
    counts = ops.launch_counts()
    rank_counts = {k: counts[k] - range_counts[k] for k in counts}
    require(range_counts["fused_locate"] > 0 and range_counts["bmat_rank"] > 0,
            f"{label}: the range scans did not launch K1 and K2: "
            f"{range_counts}")
    require(rank_counts["bmat_rank"] > 0,
            f"{label}: adjusted_predict did not launch K2: {rank_counts}")
    rep = {
        "phase": label,
        "ranges": {**_lat_report(lat, RANGE_BATCHES * RANGE_BATCH, "ranges"),
                   "ranges_whole": n_whole, "ranges_prefix": n_prefix,
                   "keys_returned": n_keys,
                   "launches": range_counts},
        "adjusted_predict": {**_lat_report(rank_lat, RANK_BATCHES * BATCH,
                                           "queries"),
                             "exact": tombstones == 0,
                             "launches": rank_counts},
        "device_mem_mib": torch.cuda.memory_allocated() / 2**20,
    }
    print("phase " + json.dumps(rep), flush=True)
    return rep, counts


def run_mixed_waves(torch, router, runner, live, pool, n_waves):
    """``n_waves`` MixedWaves through ``apply_wave``, each with 1024 fresh
    inserts, 256 deletes (192 of the earlier inserts ``pool``, 64 of its
    own), 2048
    lookups (its own inserts and deletes and 768 known keys) and 64 ranges
    over its inserts, padded to ``padded_width(n, 256, 2048)``. Every wave
    must read its own writes. Returns (report, launch counts, the keys
    inserted and deleted)."""
    from repro_torch.core.shapes import padded_width
    from repro_torch.core.sharded import MixedWave
    from repro_torch.kernels import ops

    rng = np.random.default_rng(6)
    span = int((int(live[-1]) - int(live[0])) * WAVE_SPAN)
    earlier = rng.permutation(pool)[:192 * n_waves]
    deleted, added = [], []
    lat = []
    ops.reset_launch_counts()
    for w in range(n_waves):
        reads, ins = runner.next_batch(0.25)  # 3072 reads, 1024 inserts
        dels = np.concatenate([earlier[w * 192:(w + 1) * 192], ins[:64]])
        look = np.concatenate([ins, dels, reads[:768]])
        lo = np.sort(rng.choice(ins, 64))
        wave = MixedWave(
            insert_keys=ins, insert_vals=ins + 1, delete_keys=dels,
            lookup_keys=look, range_lo=lo, range_hi=lo + span,
            pad_insert=padded_width(len(ins), 256, 2048),
            pad_delete=padded_width(len(dels), 256, 2048),
            pad_lookup=padded_width(len(look), 256, 2048),
        )
        t0 = time.perf_counter()
        res = router.apply_wave(wave)
        lat.append(time.perf_counter() - t0)  # results are numpy: synced
        deleted.append(dels)
        added.append(ins)
        gone = np.concatenate(deleted)
        want = ~np.isin(look, gone)
        require(np.array_equal(res.lookup_found, want),
                f"wave {w}: read-your-writes: {int((res.lookup_found != want).sum())} "
                "lookups disagree")
        require(np.array_equal(res.lookup_vals[want], look[want] + 1),
                f"wave {w}: wrong values")
        require(res.delete_hit.all(), f"wave {w}: a delete missed")
        for a, b, k, v in zip(lo, lo + span, res.range_keys, res.range_vals):
            mine = ins[64:][(ins[64:] >= a) & (ins[64:] <= b)]
            require(np.array_equal(v, k + 1) and np.all(k[1:] > k[:-1]),
                    f"wave {w}: a range row is wrong")
            require(not np.isin(k, gone).any(),
                    f"wave {w}: a range returned a deleted key")
            if len(k) < wave.range_max_out:
                require(np.isin(mine, k).all(),
                        f"wave {w}: a range misses the wave's own insert")
    counts = ops.launch_counts()
    require(counts["fused_locate"] > 0 and counts["bmat_rank"] > 0,
            f"mixed waves: K1 and K2 were not launched: {counts}")
    rep = {"phase": "router mixed waves", "waves": n_waves,
           "ops_per_wave": wave.n_ops,
           "waves_per_s": n_waves / float(np.sum(lat)),
           "mops_per_s": n_waves * wave.n_ops / float(np.sum(lat)) / 1e6,
           "wave_ms_p50": float(np.percentile(np.asarray(lat) * 1e3, 50)),
           "wave_ms_p99": float(np.percentile(np.asarray(lat) * 1e3, 99)),
           "launches_per_wave": {k: v / n_waves for k, v in counts.items()},
           "device_mem_mib": torch.cuda.memory_allocated() / 2**20}
    print("phase " + json.dumps(rep), flush=True)
    return rep, counts, added, np.concatenate(deleted)


# ---------------------------------------------------------------------------
# the kernel-level predict / search / rank API (K5, K4)
# ---------------------------------------------------------------------------


def _fences(torch, keys, fanout=16):
    from repro_torch.core.types import KEY_MAX

    return torch.cat([keys[::fanout], keys.new_full((1,), KEY_MAX)])


def api_batches(torch, index, live, seed):
    """The kernel-level API's inputs on one index: a BATCH-query mix, and
    for the rank the same mix plus duplicated runs that overflow one
    tile's query block (four passes)."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    q = query_mix(rng, live)
    dup = np.concatenate([np.full(3 * ops.Q_BLK + 5, live[77]),
                          np.full(ops.Q_BLK + 1, live[-5])])
    dev = index.device
    return (torch.as_tensor(q, device=dev),
            torch.as_tensor(np.concatenate([q, dup]), device=dev))


def run_kernel_api(torch, index, live, label, seed):
    """``ops.spline_lookup`` (K5) on a BATCH-query mix, ``ops.
    route_and_search`` (K4) over the index's own slot array with those
    predictions, and ``ops.bmat_rank`` over the slot keys (above the
    reference's tiled-route size, so K4 in passes), counted from zero. Then,
    uncounted: K5 and K4 against their plain versions (zero error), ``j``
    against ``torch.searchsorted`` wherever the prediction lands in the
    right tile, the ranks against ``torch.searchsorted``. Returns (K4 max
    abs error, K5 max abs error, launch counts, the number of rank
    passes)."""
    from repro_torch.core.types import KEY_MAX
    from repro_torch.kernels import ops
    from repro_torch.kernels.spline_lookup import spline_lookup_plain
    from repro_torch.kernels.tile_search import tile_search, tile_search_plain

    m, st = index.rs_model, index.rs_static
    sk = index.slots.keys
    fences = _fences(torch, sk)
    q, qq = api_batches(torch, index, live, seed)
    require(sk.shape[0] > ops.TILED_RANK_ABOVE,
            f"{label}: slot array below the tiled-rank size")
    ops.reset_launch_counts()
    p = ops.spline_lookup(m.table, m.spline_keys, m.spline_pos, m.shift, q,
                          st.n_search_iters)
    j, ok = ops.route_and_search(sk, q, p)
    r = ops.bmat_rank(sk, fences, qq, 16)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require(counts["spline_lookup"] == 1 and counts["tile_search"] == 2,
            f"{label}: K5 / K4 launches {counts} (K4: the route and one "
            f"launch for every pass of the tiled rank)")

    shift = int(m.shift)
    p0 = spline_lookup_plain(m.table, m.spline_keys, m.spline_pos, q,
                             shift=shift, n_iters=st.n_search_iters)
    k5_err = float((p - p0).abs().max())
    require(torch.equal(p.view(torch.int32), p0.view(torch.int32)),
            f"{label}: K5 differs from its plain version")
    # K4 on the route's pass, then on the tiled rank: all passes in one
    # launch, and every pass on its own
    route_in = ops._route_tiles(sk, q, p)[3]
    rank_in = ops._rank_tiles(sk, qq)[2]
    n_pass = n_passes(torch, rank_in[2])
    k4_err = 0
    for k4_in, lo, hi in ((route_in, 0, 1), (rank_in, 0, n_pass),
                          *((rank_in, pas, pas + 1) for pas in range(n_pass))):
        got = tile_search(sk, *k4_in, pass_idx=lo, pass_hi=hi)
        want = tile_search_plain(sk, *k4_in, pass_idx=lo, pass_hi=hi)
        k4_err = max(k4_err, int((got - want).abs().max()))
    require(k4_err == 0, f"{label}: K4 differs from its plain version")
    right = torch.searchsorted(sk, q, right=True) - 1
    tile = torch.clamp(p.to(torch.int64) // ops.TILE, 0,
                       (sk.shape[0] - 1) // ops.TILE)
    inside = (ok & (right >= tile * ops.TILE - 1)
              & (right < (tile + 1) * ops.TILE) & (q != KEY_MAX))
    require(torch.equal(j[inside], right[inside]),
            f"{label}: route_and_search differs from searchsorted")
    require(torch.equal(r.to(torch.int64), torch.searchsorted(sk, qq)),
            f"{label}: the tiled rank is not exact")
    print(f"kernel API[{label}]: shift {shift}, {q.shape[0]} queries, "
          f"{int(ok.sum())} ok, {int(inside.sum())} in the right tile and "
          f"equal to searchsorted; rank of {qq.shape[0]} queries exact in "
          f"{n_pass} passes; K5 bits and K4 equal their plain versions; "
          f"launches {counts}", flush=True)
    return k4_err, k5_err, counts, n_pass


def n_passes(torch, seg_start) -> int:
    """Passes of ``Q_BLK`` queries that the largest segment needs (a host
    read; the tiled rank itself launches once without it)."""
    from repro_torch.kernels import ops

    size = int((seg_start[1:] - seg_start[:-1]).max())
    return max(1, -(-size // ops.Q_BLK))


def k5_shape(torch, m, q, n_iters) -> dict:
    """What sets K5's chain of reads on one index: the knots, the knot
    bisect's steps, the widest knot range of a radix bucket, and the share
    of the queries ``q`` on each of the kernel's paths (one round; the
    bisect over a converging range wider than one round; the bisect
    anywhere else) with a count of queries per number of bisect rounds."""
    from repro_torch.kernels.spline_lookup import spline_lookup_paths

    t = m.table.long()
    n_knots = m.spline_keys.shape[0]
    lo = torch.clamp(t[:-1], min=1) - 1
    hi = torch.clamp(t[1:], 0, n_knots - 2)
    path, rounds = spline_lookup_paths(m.table, m.spline_keys, q,
                                       shift=int(m.shift), n_iters=n_iters)
    n = q.shape[0]
    share = torch.bincount(path, minlength=3).tolist()
    return dict(
        n_knots=n_knots, n_iters=n_iters,
        widest_range=int((hi - lo + 1).max()),
        one_round=share[0] / n, wide_bisect=share[1] / n,
        other_bisect=share[2] / n,
        queries_by_rounds=torch.bincount(rounds).tolist())


def api_timing(torch, wikits, fb, wikits_live, fb_live):
    """K5 at a BATCH-query mix on both sides of shift 32, K4 in
    ``route_and_search`` at that batch (the kernel's own launch, into a
    buffer allocated once) and in the tiled rank's one launch, and the
    tiled rank route against K2 on the same slot-key buffer. K4 and its
    library call are timed cold (``cold_ms``, the L2 flushed by a read
    before each launch): the route's real caller finds its slot array
    (84 MB) out of the 50 MB L2. The times after a write flush and warm are
    printed beside."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.bmat_rank import bmat_rank
    from repro_torch.kernels.spline_lookup import (
        spline_lookup, spline_lookup_plain,
    )
    from repro_torch.kernels.tile_search import tile_search, tile_search_plain

    k5 = {}
    for label, index, live, seed in (("wikits", wikits, wikits_live, 21),
                                     ("fb", fb, fb_live, 22)):
        m, st = index.rs_model, index.rs_static
        q, _ = api_batches(torch, index, live, seed)
        kw = dict(shift=int(m.shift), n_iters=st.n_search_iters)
        args = (m.table, m.spline_keys, m.spline_pos, q)
        n = q.shape[0]
        n_bytes = n * (8 + 4) + read_footprint(
            torch, spline_lookup_plain, args, kw,
            dict(table=m.table, spline_keys=m.spline_keys,
                 spline_pos=m.spline_pos))
        shape = k5_shape(torch, m, q, st.n_search_iters)
        print(f"K5 shape[{label}]: {json.dumps(shape)}", flush=True)
        k5[label] = dict(
            shift=kw["shift"], shape=shape,
            ms=device_ms(torch, lambda: spline_lookup(*args, **kw), 200),
            call_ms=call_ms(torch, lambda: ops.spline_lookup(
                m.table, m.spline_keys, m.spline_pos, m.shift, q,
                st.n_search_iters), 200),
            plain_ms=device_ms(torch, lambda: spline_lookup_plain(
                *args, **kw), 10),
            library_ms=None, bytes=n_bytes,
            bound=bound_ms(n_bytes, n * 12),
        )

    m, st = wikits.rs_model, wikits.rs_static
    sk = wikits.slots.keys
    cap = sk.shape[0]
    q, qq = api_batches(torch, wikits, wikits_live, 21)
    p = ops.spline_lookup(m.table, m.spline_keys, m.spline_pos, m.shift, q,
                          st.n_search_iters)

    def k4_bytes(qs, seg_tile, seg_start, n_in_pass):
        tiles = torch.unique(seg_tile[seg_start[:-1] < qs.shape[0]])
        keys = int(torch.clamp(cap - tiles * ops.TILE, max=ops.TILE).sum())
        return (qs.shape[0] * 8 + n_in_pass * 4 + keys * 8
                + (2 * seg_tile.shape[0] + 1) * 8)

    route = ops._route_tiles(sk, q, p)[3]
    n_ok = int(torch.clamp(route[2][1:] - route[2][:-1], max=ops.Q_BLK).sum())
    route_bytes = k4_bytes(*route, n_ok)
    fences = _fences(torch, sk)
    rank_in = ops._rank_tiles(sk, q)[2]
    rank_hi = -(-q.shape[0] // ops.Q_BLK)  # as ``_bmat_rank_tiled`` asks
    rank_bytes = k4_bytes(*rank_in, q.shape[0])
    out = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    x = torch.zeros(BATCH, dtype=torch.int64, device=q.device)
    calls = {
        "launch_floor": lambda: x.add_(1),
        "route": lambda: tile_search(sk, *route, pass_idx=0, out=out),
        "rank": lambda: tile_search(sk, *rank_in, pass_idx=0, pass_hi=rank_hi,
                                    out=out),
        "library": lambda: torch.searchsorted(sk, q, right=True) - 1,
    }
    cold = {k: cold_ms(torch, fn, 200) for k, fn in calls.items()}
    cold_w = {k: cold_ms(torch, fn, 200, "write") for k, fn in calls.items()}
    warm = {k: device_ms(torch, fn, 200) for k, fn in calls.items()}
    print("K4 timing (ms per launch; L2 flushed by a read before each / by a "
          "write / warm): " + json.dumps(
              {k: [cold[k], cold_w[k], warm[k]] for k in calls}), flush=True)
    k4 = dict(
        ms=cold["route"], warm_ms=warm["route"],
        call_ms=call_ms(torch, lambda: ops.route_and_search(sk, q, p), 200),
        plain_ms=device_ms(torch, lambda: tile_search_plain(
            sk, *route, pass_idx=0), 5),
        library_ms=cold["library"], library_warm_ms=warm["library"],
        bytes=route_bytes,
        bound=bound_ms(route_bytes, n_ok * ops.TILE),
        rank_pass=dict(
            ms=cold["rank"], warm_ms=warm["rank"],
            bytes=rank_bytes,
            bound=bound_ms(rank_bytes, q.shape[0] * ops.TILE),
        ),
    )
    routes = {
        "buffer_keys": cap, "queries": q.shape[0],
        "tiled_call_ms": call_ms(torch, lambda: ops.bmat_rank(
            sk, fences, q, 16), 50),
        "tiled_device_ms": device_ms(torch, lambda: ops.bmat_rank(
            sk, fences, q, 16), 50),
        "k2_ms": device_ms(torch, lambda: bmat_rank(
            sk, fences, q, cap=cap, nf=fences.shape[0], fanout=16), 200),
        "k2_call_ms": call_ms(torch, lambda: bmat_rank(
            sk, fences, q, cap=cap, nf=fences.shape[0], fanout=16), 200),
    }
    print("rank routes " + json.dumps(routes), flush=True)
    return k4, k5, routes


# ---------------------------------------------------------------------------
# an index above the float32 position bound
# ---------------------------------------------------------------------------


def large_index(torch, keys):
    """All generated keys in one index, whose capacity exceeds the float32
    position bound: lookups and an insert wave must go through K1 in its
    float64 mode, and K1 must equal the spline path there."""
    from repro_torch.core import UpLIF, fops
    from repro_torch.core.state import LOCATE_SPLINE
    from repro_torch.kernels import ops

    rng = np.random.default_rng(2)
    t0 = time.perf_counter()
    big = UpLIF(keys, keys + 1)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    m = big.rs_model
    require(big.capacity > ops.MAX_F32_POSITIONS and not ops.locate_fusable(
        big.capacity, m.spline_keys.shape[0]),
        "large index: capacity is within the float32 position bound")
    require(big.locate_strategy() == "fused", "large index: not fused")
    reads = rng.choice(keys, BATCH)
    fresh = np.setdiff1d(rng.integers(int(keys[0]), int(keys[-1]), 2 * BATCH),
                         keys)[:BATCH]
    ops.reset_launch_counts()
    found, vals = big.lookup(reads)
    require(found.all() and np.array_equal(vals, reads + 1),
            "large index: reads")
    big.insert(fresh, fresh + 1)
    found, vals = big.lookup(fresh)
    require(found.all() and np.array_equal(vals, fresh + 1),
            "large index: inserted keys")
    counts = ops.launch_counts()
    require(all(counts[k] > 0 for k in UPLIF_KERNELS),
            f"large index: a kernel was not launched: {counts}")
    st = big.fstatic()
    q = torch.as_tensor(query_mix(rng, keys), device=big.device)
    jf, cf = fops._locate(st, big.slots.keys, m, q)
    js, cs = fops._locate(st._replace(locate=LOCATE_SPLINE), big.slots.keys,
                          m, q)
    require(torch.equal(jf, js) and torch.equal(cf, cs),
            "large index: K1 (float64) differs from the spline path")
    print(f"large index: {len(keys)} keys loaded in {load_s:.1f} s, capacity "
          f"{big.capacity}, shift {int(m.shift)}; reads and inserts found; "
          f"launches {counts}; K1 float64 == spline path on "
          f"{q.shape[0]} queries", flush=True)
    err = compare_index_kernels(torch, big, query_mix(rng, keys), "wikits-8M")
    del big
    return err


# ---------------------------------------------------------------------------
# whole path: the card against the CPU
# ---------------------------------------------------------------------------


def tape(seed: int = 5, n: int = 40_000):
    from repro_torch.data import make_dataset

    r = np.random.default_rng(seed)
    keys = make_dataset("wikits", 2 * n, seed)
    base = np.sort(r.choice(keys, n, replace=False))
    fresh = np.setdiff1d(keys, base)
    hot = r.integers(int(base[500]), int(base[560]), 3000).astype(np.int64)
    dups = np.concatenate([hot[:400], hot[:400], base[100:500]])
    ops_tape = [
        ("insert", fresh[:20_000], fresh[:20_000] + 11),
        ("insert", hot, hot + 13),
        ("delete", np.concatenate([base[300:2300], fresh[:800], hot[:300]])),
        ("insert", dups, dups + 17),
        ("insert", fresh[20_000:], fresh[20_000:] + 19),
    ]
    probes = np.concatenate([base[::7], fresh[::5], hot[::3],
                             r.integers(0, int(keys[-1]) * 2, 3000)])
    return base, ops_tape, probes


def tape_ranges(base, n=200, seed=7):
    """Ranges over a tape's keys: spans from one to a few thousand keys,
    one past the domain, one over everything."""
    from repro_torch.core.types import KEY_MAX

    r = np.random.default_rng(seed)
    lo = np.sort(r.choice(base, n))
    hi = lo + r.integers(1, (int(base[-1]) - int(base[0])) // 200, n)
    return (np.concatenate([lo, [int(base[-1]) + 1, 0]]),
            np.concatenate([hi, [KEY_MAX, KEY_MAX]]))


def _rows(rows):
    """Range rows as two flat arrays (keys and vals) and the row lengths."""
    ks, vs = rows
    return [np.concatenate(ks), np.concatenate(vs),
            np.asarray([len(k) for k in ks])]


def _same_outputs(a, b, what):
    require(len(a) == len(b), f"{what}: {len(a)} outputs against {len(b)}")
    for x, y in zip(a, b):
        require(np.array_equal(x, y), what)


def card_vs_cpu(torch):
    from repro_torch.core import UpLIF, UpLIFConfig

    base, ops_tape, probes = tape()
    lo, hi = tape_ranges(base)
    cfg = UpLIFConfig(locate="fused")
    results = {}
    for dev in ("cuda", "cpu"):
        idx = UpLIF(base, base + 1, cfg, device=dev)
        out = []
        for op in ops_tape:
            if op[0] == "insert":
                out.append(np.asarray(idx.insert(op[1], op[2])))
            else:
                out.append(idx.delete(op[1]))
            out.extend(idx.lookup(probes))
            out.extend(_rows(idx.range_query_batch(lo, hi, max_out=256)))
            out.append(idx.adjusted_predict(probes))
        out.extend(idx.extract_live())
        arrays = [a.cpu().numpy() for a in (*idx.slots, idx.bmat.state.keys,
                                            idx.bmat.state.vals)]
        results[dev] = (out, arrays)
    _same_outputs(results["cuda"][0], results["cpu"][0],
                  "card and CPU differ on the op tape")
    _same_outputs(results["cuda"][1], results["cpu"][1],
                  "card and CPU slot or BMAT arrays differ")
    print(f"whole path: card == CPU on {len(ops_tape)} ops (results, overflow "
          f"counts, range rows, adjusted ranks, live contents, slot and BMAT "
          f"arrays)", flush=True)


def _wave_outputs(res):
    """A MixedWaveResult as a list of arrays."""
    return [np.asarray(res.n_overflow), res.lookup_found, res.lookup_vals,
            res.delete_hit, *_rows((res.range_keys, res.range_vals))]


def router_card_vs_cpu(torch):
    """The router on the card and on the CPU through one op tape with
    scripted maintenance and a fixed GMM: every result, overflow count,
    boundary and stacked array must be identical."""
    from repro_torch.core import ShardedUpLIF, UpLIFConfig
    from repro_torch.core.shapes import padded_width
    from repro_torch.core.sharded import MixedWave
    from repro_torch.core.types import GMMState

    base, ops_tape, probes = tape(seed=6)
    r_lo, r_hi = tape_ranges(base, seed=8)
    r_ = np.random.default_rng(9)
    fresh = np.setdiff1d(r_.integers(0, int(base[-1]), 3000), base)
    fresh = np.setdiff1d(fresh, np.concatenate([op[1] for op in ops_tape]))

    def wave(k):
        ins = fresh[k * 600:(k + 1) * 600]
        dels = np.concatenate([ins[:50], base[k * 90:k * 90 + 90]])
        look = np.concatenate([ins, dels, probes[:500]])
        return lambda r: _wave_outputs(r.apply_wave(MixedWave(
            insert_keys=ins, insert_vals=ins + 3, delete_keys=dels,
            lookup_keys=look, range_lo=r_lo[::10], range_hi=r_hi[::10],
            pad_insert=padded_width(len(ins)), pad_delete=padded_width(
                len(dels)), pad_lookup=padded_width(len(look)),
            range_max_out=64)))
    lo, hi = float(base[0]), float(base[-1])
    gmm = GMMState(
        weights=torch.tensor([0.2, 0.3, 0.5], dtype=torch.float64),
        means=torch.tensor([lo + 0.2 * (hi - lo), lo + 0.5 * (hi - lo),
                            lo + 0.8 * (hi - lo)], dtype=torch.float64),
        stds=torch.tensor([0.05, 0.1, 0.2], dtype=torch.float64) * (hi - lo),
    )

    def mixed(r):
        r.set_shard_locate(1, "binsearch")
        r.set_shard_locate(2, "spline")
        return r._static().locate

    steps = [
        lambda r: r.insert(*ops_tape[0][1:]),
        mixed,
        lambda r: r.insert(*ops_tape[1][1:]),
        lambda r: r.split_shard(0),
        lambda r: r.delete(ops_tape[2][1]),
        lambda r: r.retrain_shard(1, gmm),
        lambda r: r.insert(*ops_tape[3][1:]),
        lambda r: r.merge_shards(0),
        lambda r: r.switch_bmat_type(),
        lambda r: r.presize_bmat(2 * int(r.state.bmat.keys.shape[1])),
        lambda r: r.insert(*ops_tape[4][1:]),
        lambda r: _rows(r.range_query_batch(r_lo, r_hi, max_out=256)),
        lambda r: [r.adjusted_predict(probes)],
        wave(0),
        wave(1),
        wave(2),
    ]
    results = {}
    for dev in ("cuda", "cpu"):
        r = ShardedUpLIF(base, base + 1, UpLIFConfig(locate="fused"),
                         n_shards=3, device=dev)
        out = []
        for step in steps:
            res = step(r)
            if isinstance(res, list):
                out.extend(res)
            else:
                out.append(np.asarray(res, dtype=object))
            out.append(r.boundaries.copy())
            out.extend(r.lookup(probes))
        st = r.state
        arrays = [a.cpu().numpy() for part in (st.slots, st.bmat, st.counters)
                  for a in part]
        results[dev] = (out, arrays, r._static().locate, r.n_shards)
    cuda, cpu = results["cuda"], results["cpu"]
    require(cuda[2] == cpu[2] and isinstance(cuda[2], tuple),
            f"router card vs CPU: locate {cuda[2]} / {cpu[2]}")
    _same_outputs(cuda[0], cpu[0], "router: card and CPU differ on the tape")
    _same_outputs(cuda[1], cpu[1], "router: card and CPU arrays differ")
    print(f"router whole path: card == CPU on {len(steps)} steps (results, "
          f"overflow counts, range rows, adjusted ranks, mixed waves, "
          f"boundaries, slot, BMAT and counter arrays; {cuda[3]} shards, "
          f"locate {cuda[2]})", flush=True)


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the request gateway over the overlapped tuner
# ---------------------------------------------------------------------------


def _pcts_ms(lat) -> dict:
    lat_ms = np.asarray(lat) * 1e3
    if not len(lat_ms):
        return {"p50_ms": None, "p99_ms": None, "p999_ms": None}
    return {"p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "p999_ms": float(np.percentile(lat_ms, 99.9)),
            "max_ms": float(lat_ms.max())}


def _gateway_client(gw, tid, plain, own, reserved, fresh, stop, out):
    """One closed-loop client (``examples/serve_gateway.py``): 70% lookups
    (of loaded keys no one writes, and now and then of a key this client
    wrote), 14% upserts rewriting one of its ``own`` loaded keys with a
    value the key has not held (2k + 2 + 2n for its n-th rewrite), 14%
    inserts of its own fresh keys, 2% deletes of its own reserved keys.
    Every answer is checked: a lookup finds the last value acknowledged for
    the key (2k+1 where no rewrite was), a delete's hit says whether the
    key was still live."""
    from repro_torch.serve import RetryAfter

    rng = np.random.default_rng(1000 + tid)
    lat, svc, errors, acked, deleted = [], [], [], [], set()
    written = {}  # key -> last acknowledged value, for this client's writes
    n_fresh = n_rewrites = n_rejected = 0
    while not stop.is_set():
        p = rng.random()
        val = None
        if p < 0.70:
            if written and rng.random() < 0.25:
                k = list(written)[int(rng.integers(len(written)))]
            else:
                k = int(plain[rng.integers(len(plain))])
            kind = "lookup"
        elif p < 0.84 or n_fresh >= len(fresh):
            kind, k = "rewrite", int(own[rng.integers(len(own))])
            val = 2 * k + 2 + 2 * n_rewrites
            n_rewrites += 1
        elif p < 0.98:
            kind, k = "fresh", int(fresh[n_fresh])
            val = 2 * k + 1
            n_fresh += 1
        else:
            kind, k = "delete", int(reserved[rng.integers(len(reserved))])
        try:
            if kind == "lookup":
                fut = gw.submit_lookup(k)
            elif kind == "delete":
                fut = gw.submit_delete(k)
            else:
                fut = gw.submit_insert(k, val)
        except RetryAfter as e:
            n_rejected += 1
            if kind == "fresh":
                n_fresh -= 1
            time.sleep(e.retry_after_s)
            continue
        try:
            res = fut.result(30.0)
        except Exception as e:  # noqa: BLE001 — reported as a failure
            errors.append(f"{kind} {k}: {e!r}")
            break
        lat.append(fut.total_latency_s)
        svc.append(fut.service_latency_s)
        if kind == "lookup" and res != (True, written.get(k, 2 * k + 1)):
            errors.append(f"lookup {k}: {res}, expected "
                          f"{written.get(k, 2 * k + 1)}")
        elif kind == "delete" and res != (k not in deleted):
            errors.append(f"delete {k}: hit {res}, deleted before "
                          f"{k in deleted}")
        elif kind in ("rewrite", "fresh") and res is not True:
            errors.append(f"{kind} {k}: {res}")
        if kind in ("rewrite", "fresh"):
            written[k] = val
        if kind == "fresh":
            acked.append(k)
        elif kind == "delete":
            deleted.add(k)
        if len(errors) >= 8:
            break
        time.sleep(rng.exponential(0.0005))
    out[tid] = {"lat": lat, "svc": svc, "errors": errors, "acked": acked,
                "written": written, "deleted": sorted(deleted),
                "rejected": n_rejected}


def run_gateway_path(torch, loaded, unloaded):
    """``RequestGateway`` over a 4-shard router of the loaded keys (values
    2k+1) with ``SelfTuner.overlapped(max_concurrent_builds=2,
    commit_replay_cap=4096)``: warmup, then 64 closed-loop client threads
    for ``GATEWAY_SECONDS``. Returns the report and the launch counts of
    the served run (reset just before the clients start, read after the
    close and the tuner's drain)."""
    from repro_torch.core import ShardedUpLIF
    from repro_torch.kernels import build, ops
    from repro_torch.serve import GatewayConfig, RequestGateway
    from repro_torch.tuning import SelfTuner

    t0 = time.perf_counter()
    router = ShardedUpLIF(loaded, 2 * loaded + 1, n_shards=N_SHARDS)
    tuner = SelfTuner.overlapped(max_concurrent_builds=2,
                                 commit_replay_cap=4096).attach(router)
    require(tuner.forecaster.cfg.use_kernel, "gateway: forecaster not on K3")
    cfg = GatewayConfig(max_batch=GATEWAY_MAX_BATCH, max_delay_s=0.002)
    gw = RequestGateway(router, tuner=tuner, config=cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        primed = gw.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        info0 = build.library.cache_info()

        # every 97th loaded key is reserved for deletes, every 7th of the
        # rest for rewrites (each owned by one client), the rest is read
        # by everyone and never written
        is_res = np.zeros(len(loaded), dtype=bool)
        is_res[::GATEWAY_RESERVE_EVERY] = True
        rest, reserved = loaded[~is_res], loaded[is_res]
        is_own = np.zeros(len(rest), dtype=bool)
        is_own[::GATEWAY_REWRITE_EVERY] = True
        plain, owned = rest[~is_own], rest[is_own]
        stop = threading.Event()
        out = {}
        threads = [
            threading.Thread(
                target=_gateway_client, daemon=True,
                args=(gw, i, plain, owned[i::GATEWAY_CLIENTS],
                      reserved[i::GATEWAY_CLIENTS],
                      unloaded[i::GATEWAY_CLIENTS], stop, out))
            for i in range(GATEWAY_CLIENTS)
        ]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(GATEWAY_SECONDS)
        stop.set()
        for t in threads:
            t.join(60.0)
        served_s = time.perf_counter() - t0
        require(not any(t.is_alive() for t in threads),
                "gateway: a client did not finish")
        gst = gw.stats()
        gw.close()
        t1 = time.perf_counter()
        tuner.drain(timeout=120.0)
        torch.cuda.synchronize()
        drain_s = time.perf_counter() - t1
        counts = ops.launch_counts()
        info1 = build.library.cache_info()
    finally:
        gw.close()
    tst = tuner.stats()
    tuner.close()

    errors = [e for r in out.values() for e in r["errors"]]
    require(len(out) == GATEWAY_CLIENTS, "gateway: a client reported nothing")
    require(not errors, f"gateway: wrong answers: {errors[:4]}")
    require(gw.last_error is None, f"gateway: a wave failed: {gw.last_error}")
    for name in ("fused_locate", "bmat_rank", "gmm_estep"):
        require(counts[name] > 0,
                f"gateway: {name} was not launched: {counts}")
    require(info1.misses == info0.misses,
            f"gateway: the kernel library was built or loaded after warmup "
            f"({info0} -> {info1})")
    require(tst["last_build_error"] is None,
            f"gateway: a build failed: {tst['last_build_error']}")
    require(not router.draining and not router._logs,
            "gateway: a build is still open after the drain")
    acked = np.concatenate([np.asarray(r["acked"], dtype=np.int64)
                            for r in out.values()])
    dead = np.concatenate([np.asarray(r["deleted"], dtype=np.int64)
                           for r in out.values()])
    want = np.union1d(np.setdiff1d(loaded, dead), acked)
    keys, vals = _router_contents(router)
    require(np.array_equal(keys, want),
            f"gateway contents: {len(keys)} live keys, expected {len(want)}")
    want_vals = 2 * keys + 1
    wk = np.array([k for r in out.values() for k in r["written"]],
                  dtype=np.int64)
    wv = np.array([v for r in out.values() for v in r["written"].values()],
                  dtype=np.int64)
    want_vals[np.searchsorted(keys, wk)] = wv
    require(np.array_equal(vals, want_vals),
            "gateway contents: a value is not the last acknowledged one")
    require(router.size == len(want), "gateway: size differs from contents")
    for op, hist in gst["pad_widths"].items():
        for w in hist:
            require(w in primed[op], f"gateway: {op} flushed at an unprimed "
                                     f"width {w} (primed {primed[op]})")

    lat = [x for r in out.values() for x in r["lat"]]
    rep = {
        "path": "gateway", "clients": GATEWAY_CLIENTS,
        "keys": len(loaded), "shards": N_SHARDS,
        "max_batch": GATEWAY_MAX_BATCH, "max_delay_s": 0.002,
        "load_s": load_s, "warmup_s": warm_s, "primed": primed,
        "served_s": served_s, "requests": len(lat),
        "requests_per_s": len(lat) / served_s,
        **_pcts_ms(lat),
        # dispatch -> done: the wave that served the request
        "service": _pcts_ms([x for r in out.values() for x in r["svc"]]),
        "waves": gst["waves"], "mean_batch": gst["ops"] / max(gst["waves"], 1),
        "flush_triggers": gst["flush_triggers"],
        "pad_widths": gst["pad_widths"],
        "rejected": sum(r["rejected"] for r in out.values()),
        "gateway_rejected": gst["rejected"],
        "fresh_acked": len(acked), "deleted": len(dead),
        "rewritten": len(wk) - len(acked),
        "drain_s": drain_s,
        "tuner": {
            "submitted": tst["plans"], "committed": tst["commits"],
            "abandoned": tst["abandoned"], "conflicted": tst["conflicts"],
            "drained": tst["drained"], "replayed_ops": tst["replayed_ops"],
            "actions": tst["actions"], "shed_waves": tst["shed_waves"],
            "time_in_maintenance_s": tst["time_in_maintenance_s"],
            "n_shards": tst["n_shards"],
        },
        "launches": counts,
        "contents": f"{len(keys)} live keys == loaded + acked fresh - "
                    "acked deletes, each at its last acknowledged value",
    }
    print("gateway " + json.dumps(rep), flush=True)
    return rep, counts


# ---------------------------------------------------------------------------
# asynchronous maintenance at full size
# ---------------------------------------------------------------------------


def _async_reader(router, probe, acked, stop, failures, n_reads):
    while not stop.is_set():
        try:
            f, v = router.lookup(probe)
            if not (f.all() and np.array_equal(v, 2 * probe + 1)):
                failures.append("probe mismatch (torn read)")
                return
            if acked:
                ak = acked[-1]
                f, v = router.lookup(ak)
                if not (f.all() and np.array_equal(v, 2 * ak + 1)):
                    failures.append("acked insert vanished")
                    return
            n_reads[0] += 1
        except Exception as e:  # noqa: BLE001 — any tear is a failure
            failures.append(repr(e))
            return


def run_async_path(torch, loaded, unloaded):
    """``tests/test_async_maintenance.py``'s paced-commit stress at full
    size: readers look up a probe and the last acknowledged insert batch
    while the main thread inserts ``ASYNC_WAVES`` waves of 4096 new keys
    and builds on disjoint intervals run on the executor's two workers —
    a shard-0 retrain with a fixed GMM beside a shard-2 split, then a
    merge of the split's halves — committing under ``ASYNC_REPLAY_CAP``
    and draining across waves. A twin router runs the same tape with the
    builds inline; contents and every stacked array must be identical."""
    from repro_torch.core import ShardedUpLIF
    from repro_torch.core.types import GMMState
    from repro_torch.kernels import ops
    from repro_torch.tuning import (
        A_MERGE_SHARDS, A_RETRAIN_SHARD, A_SPLIT_SHARD, MaintenanceExecutor,
        MaintenancePlan, build,
    )

    lo, hi = float(loaded[0]), float(loaded[-1])
    gmm = GMMState(
        weights=torch.tensor([0.7, 0.3], dtype=torch.float64),
        means=torch.tensor([lo + 0.1 * (hi - lo), lo + 0.6 * (hi - lo)],
                           dtype=torch.float64),
        stds=torch.tensor([0.05 * (hi - lo), 0.2 * (hi - lo)],
                          dtype=torch.float64),
    )
    # two rounds of builds; merge of the split's halves in the second
    rounds = [[(A_RETRAIN_SHARD, 0, gmm), (A_SPLIT_SHARD, 2, None)],
              [(A_MERGE_SHARDS, 2, None)]]
    tape = [unloaded[w * BATCH:(w + 1) * BATCH] for w in range(ASYNC_WAVES)]
    per_round = ASYNC_WAVES // len(rounds)

    def plan(pid, action, shard, g):
        return MaintenancePlan(plan_id=pid, epoch=-1, wave=0, action=action,
                               shard=shard, gmm=g, cost_estimate=0.0)

    def drive(router, executor, on_wave=None):
        """The tape; ``executor`` None runs the builds inline (the twin).
        Returns the per-build and per-wave records."""
        acked = []
        rec = {"builds": [], "commits": [], "waves": [], "parked": 0,
               "drains": 0}
        pid = 0
        for r, plans in enumerate(rounds):
            pending = []
            for action, shard, g in plans:
                pid += 1
                shards = (shard, shard + 1) if action == A_MERGE_SHARDS \
                    else (shard,)
                p, snap = plan(pid, action, shard, g), router.snapshot(shards)
                if executor is None:
                    pending.append((p, build(p, snap)))
                else:
                    executor.submit(p, snap)
            for w in range(per_round):
                new = tape[r * per_round + w]
                in_flight = (executor is not None and executor.inflight > 0)
                draining = router.draining
                t0 = time.perf_counter()
                router.insert(new, 2 * new + 1)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                acked.append(new)
                if on_wave is not None:
                    on_wave(new)
                rec["waves"].append({"s": dt, "build_in_flight": in_flight,
                                     "draining": draining})
                if w == 1:
                    if executor is not None:
                        res = executor.wait(timeout=300.0)
                        require(len(res) == len(plans) and all(
                            x.error is None and x.delta is not None
                            for x in res),
                            f"async: a build failed: {res}")
                        rec["builds"] += [(x.plan.action, x.build_seconds)
                                          for x in res]
                        pending = sorted(((x.plan, x.delta) for x in res),
                                         key=lambda pd: pd[0].plan_id)
                    for p, delta in pending:
                        c0 = time.perf_counter()
                        require(router.commit(delta,
                                              replay_cap=ASYNC_REPLAY_CAP),
                                "async: a commit was refused")
                        torch.cuda.synchronize()
                        rec["commits"].append(time.perf_counter() - c0)
                        rec["parked"] += delta.build_id in \
                            router.draining_builds()
                elif w > 1:
                    rec["drains"] += router.advance_drains(ASYNC_REPLAY_CAP)
            while router.draining:
                done = router.advance_drains(None)
                require(done > 0, "async: a drain was aborted")
                rec["drains"] += done
        return acked, rec

    router = ShardedUpLIF(loaded, 2 * loaded + 1, n_shards=N_SHARDS)
    twin = ShardedUpLIF(loaded, 2 * loaded + 1, n_shards=N_SHARDS)
    probe = loaded[:: len(loaded) // 512][:512]
    stop = threading.Event()
    failures, acked_view, n_reads = [], [], [0]
    readers = [threading.Thread(target=_async_reader, daemon=True,
                                args=(router, probe, acked_view, stop,
                                      failures, n_reads))
               for _ in range(4)]
    executor = MaintenanceExecutor(n_workers=2)
    ops.reset_launch_counts()
    for t in readers:
        t.start()
    try:
        acked, rec = drive(router, executor, on_wave=acked_view.append)
    finally:
        stop.set()
        for t in readers:
            t.join(60.0)
        executor.close()
    counts = ops.launch_counts()
    require(not any(t.is_alive() for t in readers), "async: a reader hung")
    require(not failures, f"async: {failures[:3]}")
    require(n_reads[0] > 0, "async: the readers read nothing")
    require(rec["parked"] >= 1 and rec["drains"] >= 1,
            f"async: no commit drained across waves ({rec['parked']} parked)")
    require(router.n_commits == 3 and router.n_discards == 0,
            f"async: {router.n_commits} commits, {router.n_discards} discards")
    _, twin_rec = drive(twin, None)
    new = np.concatenate(acked)
    f, v = router.lookup(new)
    require(f.all() and np.array_equal(v, 2 * new + 1),
            "async: an acknowledged insert is not readable")
    require(np.array_equal(router.boundaries, twin.boundaries),
            "async: boundaries differ from the sync twin's")
    for part, tpart in zip(router.state, twin.state):
        for x, y in zip(part, tpart):
            require(x.dtype == y.dtype and torch.equal(x, y),
                    "async: a stacked array differs from the sync twin's")
    keys, vals = _router_contents(router)
    require(np.array_equal(keys, np.union1d(loaded, new))
            and np.array_equal(vals, 2 * keys + 1),
            "async: contents differ from loaded + inserted")

    def ms(sel):
        xs = [w["s"] * 1e3 for w in rec["waves"] if sel(w)]
        return ({"waves": len(xs), "p50": float(np.percentile(xs, 50)),
                 "p99": float(np.percentile(xs, 99))} if xs else None)

    names = {A_RETRAIN_SHARD: "retrain_shard", A_SPLIT_SHARD: "split_shard",
             A_MERGE_SHARDS: "merge_shards"}
    rep = {
        "path": "async_maintenance", "keys": len(loaded),
        "insert_waves": len(rec["waves"]), "wave_keys": BATCH,
        "replay_cap": ASYNC_REPLAY_CAP,
        "build_s": [(names[a], s) for a, s in rec["builds"]],
        "commit_s": rec["commits"], "parked_commits": rec["parked"],
        "drains": rec["drains"], "replayed_ops": router.n_replayed_ops,
        "insert_wave_ms_build_in_flight": ms(lambda w: w["build_in_flight"]),
        "insert_wave_ms_draining": ms(
            lambda w: w["draining"] and not w["build_in_flight"]),
        "insert_wave_ms_none": ms(
            lambda w: not w["build_in_flight"] and not w["draining"]),
        "reader_rounds": n_reads[0], "n_shards": router.n_shards,
        "twin_commit_s": twin_rec["commits"],
        "launches": counts,
        "twin": "contents, boundaries and every stacked array identical",
    }
    print("async " + json.dumps(rep), flush=True)
    return rep, counts


# ---------------------------------------------------------------------------
# the RL agent, the baselines and the data pipeline
# ---------------------------------------------------------------------------


def _checked_reads(index, live, rng, label):
    q = rng.choice(live, BATCH)
    f, v = index.lookup(q)
    require(f.all() and np.array_equal(v, q + 1), f"{label}: reads wrong")


def _burst(live, pool, n=AGENT_BURST):
    """``n`` keys of ``pool`` that are not live and lie next to each other in
    key order, from the middle of the pool: one insert wave of them puts
    more keys in each slot window than its rounds accept, so the overflow
    reaches the BMAT while the windows still have gaps."""
    fresh = np.setdiff1d(pool, live)
    mid = len(fresh) // 2
    return fresh[mid:mid + n]


def _cpu_twin(torch, index):
    """A CPU copy of ``index`` (arrays, model, BMAT kind) that pins the fused
    locate the card's index resolves to."""
    import dataclasses

    from repro_torch.core.convert import uplif_from_numpy

    def leaves(t):
        return [x.cpu().numpy() for x in t]

    st = index.fstate
    twin = uplif_from_numpy(
        leaves(st.slots), leaves(st.model), leaves(st.bmat),
        leaves(st.counters), rs_static=tuple(index.rs_static),
        gmm=leaves(index.gmm), alpha=index.alpha,
        config=dataclasses.replace(index.cfg, locate=index.locate_strategy(),
                                   bmat_type=index.bmat.tree_type,
                                   bmat_fanout=index.bmat.fanout),
        device="cpu")
    twin.n_retrains = index.n_retrains
    return twin


def run_agent_path(torch, index, runner, live):
    """``QLearningAgent.apply_action`` on the single index: A_RETRAIN at a
    BMAT above 4096 keys (a full retrain), again at a small BMAT (a subset
    retrain of the overflow of a burst of adjacent keys), then A_SWITCH,
    each followed by a checked read wave; the subset retrain must absorb
    keys. The burst, the subset retrain and the switch also run on a CPU
    twin of the index, and the arrays must agree. Then
    ``WorkloadRunner.run(agent=)`` for ``AGENT_RUN_S`` seconds with an agent
    whose Q-table prefers A_RETRAIN in every state, so the runner applies
    the agent's choices on the card."""
    from repro_torch.core.rl_agent import (
        A_RETRAIN, A_SWITCH, QLearningAgent, encode_state,
    )
    from repro_torch.kernels import ops

    rng = np.random.default_rng(21)
    agent = QLearningAgent()
    live = [live]
    ops.reset_launch_counts()
    for _ in range(64):  # the full retrain needs a BMAT above 4096 keys
        if index.bmat.size > 4096:
            break
        _, ins = runner.next_batch(1.0)
        index.insert(ins, ins + 1)
        live.append(ins)
    require(index.bmat.size > 4096, "agent: the BMAT stays at 4096 keys")
    steps = []
    t0 = time.perf_counter()
    before = (index.bmat.size, index.n_retrains)
    agent.apply_action(index, A_RETRAIN)
    torch.cuda.synchronize()
    steps.append({"action": "retrain (full)", "s": time.perf_counter() - t0,
                  "bmat_before": before[0], "bmat_after": index.bmat.size})
    require(index.bmat.size == 0 and index.n_retrains == before[1] + 1,
            "agent: A_RETRAIN above 4096 keys was not a full retrain")
    all_live = np.unique(np.concatenate(live))
    _checked_reads(index, all_live, rng, "after the full retrain")
    require(index.bmat.size == 0, "agent: the full retrain left a BMAT")
    burst = _burst(all_live, runner.insert_keys)
    twin = _cpu_twin(torch, index)
    for idx in (index, twin):  # a small BMAT whose windows have room
        idx.insert(burst, burst + 1)
    all_live = np.union1d(all_live, burst)
    require(0 < index.bmat.size <= 4096,
            f"agent: no small BMAT to absorb ({index.bmat.size} keys)")
    _checked_reads(index, all_live, rng, "after the burst")
    bk = index.bmat.extract()[0]
    t0 = time.perf_counter()
    before = (len(bk), index.n_retrains)
    agent.apply_action(index, A_RETRAIN)
    torch.cuda.synchronize()
    absorbed = before[0] - len(index.bmat.extract()[0])
    steps.append({"action": "retrain (subset)", "s": time.perf_counter() - t0,
                  "bmat_before": before[0], "bmat_after": index.bmat.size,
                  "burst": len(burst), "absorbed": absorbed})
    require(index.n_retrains == before[1] + 1 and absorbed > 0,
            f"agent: A_RETRAIN at a small BMAT of {before[0]} keys absorbed "
            f"{absorbed}")
    require(twin.retrain_subset() == absorbed,
            "agent: the CPU twin absorbed another count")
    _checked_reads(index, all_live, rng, "after the subset retrain")
    kind = index.bmat.tree_type
    t0 = time.perf_counter()
    agent.apply_action(index, A_SWITCH)
    steps.append({"action": "switch", "s": time.perf_counter() - t0,
                  "bmat_type": index.bmat.tree_type})
    agent.apply_action(twin, A_SWITCH)
    require(index.bmat.tree_type != kind, "agent: A_SWITCH did not switch")
    require(twin.bmat.tree_type == index.bmat.tree_type
            and all(torch.equal(x, y) for x, y in
                    zip(_index_arrays(index), _index_arrays(twin))),
            "agent: card and CPU twin arrays differ after the subset retrain")
    del twin
    _checked_reads(index, all_live, rng, "after the switch")
    state = encode_state(index.measures())
    greedy = QLearningAgent()
    for s in np.ndindex(6, 5, 5, 5, 2):
        greedy._q_row(s)[A_RETRAIN] = 1.0
    r0 = index.n_retrains
    res = runner.run(index, 0.5, seconds=AGENT_RUN_S, agent=greedy)
    _checked_reads(index, all_live, rng, "after run(agent=)")
    require(index.n_retrains > r0, "agent: run(agent=) applied no action")
    counts = ops.launch_counts()
    for name in UPLIF_KERNELS:
        require(counts[name] > 0, f"agent: {name} was not launched")
    rep = {"path": "agent", "steps": steps, "state": list(state),
           "run_ops": res.ops, "run_mops_per_s": res.mops,
           "run_retrains": index.n_retrains - r0, "launches": counts,
           "twin": "subset retrain and switch: card == CPU arrays"}
    print("agent " + json.dumps(rep), flush=True)
    return rep, counts


def _index_arrays(idx):
    b = idx.bmat.state
    return [x.cpu() for x in (*idx.slots, b.keys, b.vals, b.fences, b.size)]


def run_baselines(torch, keys, fresh):
    """Each baseline over ``keys`` on the card and on the CPU: a 4096-lookup
    batch (loaded keys and misses) and a 4096-key insert wave, then the
    batch again; results, overflow counts and arrays identical. K1 and K2
    launch for all but ``BTreeLike`` (the model-free bisect)."""
    from repro_torch import baselines
    from repro_torch.kernels import ops

    rng = np.random.default_rng(31)
    q = np.concatenate([rng.choice(keys, BATCH - 256), fresh[-256:]])
    ins = fresh[:BATCH]
    total = {k: 0 for k in ops.launch_counts()}
    rep = []
    for name in baselines.__all__:
        cls = getattr(baselines, name)
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            idx = cls(keys, keys + 1, device=dev)
            load_s = time.perf_counter() - t0
            if dev == "cuda":
                ops.reset_launch_counts()
            f0, v0 = idx.lookup(q)
            n_over = idx.insert(ins, ins + 1)
            f1, v1 = idx.lookup(q)
            f2, v2 = idx.lookup(ins)
            if dev == "cuda":
                counts = ops.launch_counts()
            out[dev] = (f0, v0, n_over, f1, v1, f2, v2, _index_arrays(idx),
                        load_s, idx.locate_strategy())
            del idx
        c, p = out["cuda"], out["cpu"]
        for i in (0, 1, 3, 4, 5, 6):
            require(np.array_equal(c[i], p[i]),
                    f"{name}: card and CPU answers differ")
        require(c[2] == p[2], f"{name}: overflow counts differ")
        require(all(torch.equal(x, y) for x, y in zip(c[7], p[7])),
                f"{name}: card and CPU arrays differ")
        require(c[0][:-256].all() and not c[0][-256:].any()
                and np.array_equal(c[1][:-256], q[:-256] + 1),
                f"{name}: wrong lookups")
        require(c[5].all() and np.array_equal(c[6], ins + 1),
                f"{name}: inserted keys not found")
        fused = name != "BTreeLike"
        for k in UPLIF_KERNELS:
            require((counts[k] > 0) == fused,
                    f"{name}: {k} launched {counts[k]} times")
        total = {k: total[k] + counts[k] for k in total}
        rep.append({"baseline": name, "locate": c[9], "load_s": c[8],
                    "overflow": int(c[2]), "launches": counts})
    print("baselines " + json.dumps(rep) + "; card == CPU", flush=True)
    return rep, total


def run_pipeline(torch):
    """``PackedCorpus`` of ``PIPELINE_DOCS`` documents with its doc-id index
    on the card and on the CPU: batches, doc tokens after a shard streams
    in, and retirement identical."""
    from repro_torch.data.pipeline import PackedCorpus, PipelineConfig
    from repro_torch.kernels import ops

    cfg = PipelineConfig(n_docs=PIPELINE_DOCS)
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        corpus = PackedCorpus(cfg, device=dev)
        build_s = time.perf_counter() - t0
        if dev == "cuda":
            ops.reset_launch_counts()
        batches = [corpus.batch(step)["tokens"] for step in range(4)]
        ids = corpus.add_shard(9, 4096)
        toks = corpus.doc_tokens(ids[:64], 256)
        corpus.retire_docs(ids[:2048])
        gone, _ = corpus.index.lookup(ids[:2048])
        after = corpus.batch(4)["tokens"]
        if dev == "cuda":
            counts = ops.launch_counts()
        out[dev] = (batches, toks, gone, after, build_s,
                    _index_arrays(corpus.index))
        del corpus
    c, p = out["cuda"], out["cpu"]
    require(all(np.array_equal(a, b) for a, b in zip(c[0], p[0])),
            "pipeline: batches differ")
    require(np.array_equal(c[1], p[1]) and np.array_equal(c[3], p[3]),
            "pipeline: doc tokens differ")
    require(not c[2].any() and not p[2].any(),
            "pipeline: retired docs still found")
    require(all(torch.equal(x, y) for x, y in zip(c[5], p[5])),
            "pipeline: card and CPU index arrays differ")
    for k in UPLIF_KERNELS:
        require(counts[k] > 0, f"pipeline: {k} was not launched")
    rep = {"path": "pipeline", "docs": PIPELINE_DOCS,
           "build_s": c[4], "launches": counts}
    print("pipeline " + json.dumps(rep) + "; card == CPU", flush=True)
    return rep, counts


# ---------------------------------------------------------------------------
# LM serving (phase 16)
# ---------------------------------------------------------------------------


def _lm_tokens(torch, prompt, device):
    return torch.as_tensor(np.asarray(prompt, np.int64), device=device)[None]


def _instrument(torch, eng):
    """Record, on the engine's stream, a CUDA event after every decode step
    with the cache length it started from, and time ``match`` and ``admit``
    on the host clock (both return host values, so they end synchronized).
    Returns the three records."""
    steps, match_s, admit_s = [], [], []
    decode, match, admit = (eng._decode, eng.prefix_index.match,
                            eng.prefix_index.admit)

    def timed_decode(tok, cache):
        out = decode(tok, cache)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        steps.append((cache.length, ev))
        return out

    def timed(fn, into):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            into.append(time.perf_counter() - t0)
            return out
        return call

    eng._decode = timed_decode
    eng.prefix_index.match = timed(match, match_s)
    eng.prefix_index.admit = timed(admit, admit_s)
    return steps, match_s, admit_s


def _split_steps(steps, prompts):
    """Per request (in serving order), its decode steps as (ms since the
    previous step's event, kind): kind "prefill" while the cache holds
    fewer tokens than the prompt, else "decode". A request begins where the
    cache length drops; its first step's time runs from the previous
    request's last step, so it also holds the ``match`` and the cache
    set-up (None for the first request), and its first "decode" step's
    time holds the ``admit`` and the first token's read-back."""
    reqs, prev = [], None
    for length, ev in steps:
        if prev is None or length <= prev[0]:
            reqs.append([])
        ms = None if prev is None else prev[1].elapsed_time(ev)
        reqs[-1].append((ms, length))
        prev = (length, ev)
    require(len(reqs) == len(prompts),
            f"lm: {len(reqs)} requests seen in the decode steps, "
            f"{len(prompts)} sent")
    return [[(ms, "prefill" if length < len(p) else "decode")
             for ms, length in r] for r, p in zip(reqs, prompts)]


def _cold_tokens(cfg, weights, prompt, n_new, device):
    """``prompt``'s tokens on a fresh engine without a tuner."""
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(cfg, weights, max_len=LM_MAX_LEN, tuner=None,
                      device=device)
    [r] = eng.generate([Request(0, prompt, n_new)])
    eng.close()
    return r.out


def _close_logits(a, b, tol):
    """Largest excess of |a - b| over ``tol * (1 + |b|)`` (allclose with
    rtol = atol = tol passes where it is <= 0), and the largest |a - b|."""
    diff = (a - b).abs()
    return (float((diff - tol * (1 + b.abs())).max()), float(diff.max()))


def host_us_per_op(torch, device, n=2000) -> float:
    """Host microseconds per small torch op: ``n`` in-place adds on one
    element, dispatched back to back and synchronized once at the end (the
    device does each in about 2 us, so the host's dispatch sets the time)."""
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _no_drops(cfg):
    """``cfg`` with an MoE capacity factor at which no expert drops a token
    (decode against forward: drops differ between the two), else as is.
    The reference's check sets 16, which guarantees it only where
    ``n_experts / top_k`` <= 16: an expert holds ``cf * t * k / E`` slots
    and may be picked by all t tokens. deepseek-v2's 160 / 6 needs 26.7
    (at 16 its forward of 12 tokens has 7 slots an expert and drops
    tokens that the one-token steps keep), so the factor is the larger of
    16 and E / k."""
    import dataclasses

    if cfg.moe is None:
        return cfg
    factor = max(MOE_FWD_CF, math.ceil(cfg.moe.n_experts / cfg.moe.top_k))
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(factor)))


def _nbytes(tree) -> int:
    return sum(_nbytes(v) if isinstance(v, dict) else
               v.numel() * v.element_size() for v in tree.values())


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _cache_tensors(cache):
    return [x for field in cache if field for k, x in field.items()
            if k != "len"]


def _state_bytes(cache, pos: int) -> int:
    """Bytes of decode state one step at position ``pos`` needs: the K/V
    (or MLA latent) of the positions written so far (of a ring, at most
    its slots), and every recurrent state read and written back."""
    n = 0
    for name, t_dim in (("kv", -3), ("mla", -2)):
        for k, x in (getattr(cache, name) or {}).items():
            if k != "len":
                t = x.shape[t_dim]
                n += x.numel() * x.element_size() * min(pos, t) // t
    for field in (cache.rec, cache.rwkv):
        n += 2 * sum(x.numel() * x.element_size()
                     for k, x in (field or {}).items() if k != "len")
    return n


def _slot_report(slots) -> dict:
    """What the prefix index stores: for a recurrent model the per-block
    snapshots (shared between slots where a hit took them over), else one
    cache per stored prompt."""
    lists = [v if isinstance(v, list) else [v] for v in slots.values()]
    seen = {}
    for caches in lists:
        for c in caches:
            for x in _cache_tensors(c):
                seen[x.data_ptr()] = x.numel() * x.element_size()
    per_prompt = [sum(x.numel() * x.element_size() for c in caches
                      for x in _cache_tensors(c)) for caches in lists]
    out = {"slots": len(lists), "stored_bytes": sum(seen.values()),
           "bytes_per_prompt_max": max(per_prompt, default=0)}
    if any(isinstance(v, list) for v in slots.values()):
        snaps = [c for caches in lists for c in caches]
        out.update(snapshots=len({id(c) for c in snaps}),
                   snapshot_bytes=sum(x.numel() * x.element_size()
                                      for x in _cache_tensors(snaps[0])))
    return out


class _Routes:
    """Record the top-k experts of every call of the MoE router
    (``repro_torch.models.moe._router``) while it is entered: a probe of
    ``decode_vs_forward`` only."""

    def __init__(self):
        self.seen = []

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.orig = moe, moe._router

        def router(*args):
            top_p, top_i = self.orig(*args)
            self.seen.append(top_i)
            return top_p, top_i

        moe._router = router
        return self

    def __exit__(self, *exc):
        self.moe._router = self.orig


def _forward_drops(routes, cfg, t: int) -> int:
    """(token, k) past an expert's capacity in ``moe_dense`` over t
    tokens, from each layer's recorded top-k (``_Routes``)."""
    m = cfg.moe
    cap = max(int(m.capacity_factor * t * m.top_k / m.n_experts), 1)
    return sum(int((np.bincount(r.reshape(-1).cpu().numpy(),
                                minlength=m.n_experts) - cap).clip(0).sum())
               for r in routes)


def decode_vs_forward(torch, weights, cfg, toks, device, tol=LM_FWD_TOL,
                      logits=None):
    """``tests/test_models_smoke.py``'s check: ``LM_FWD`` decode steps
    against ``forward_lm`` of the same tokens, logits within ``tol``
    (``LM_FWD_TOL``, its own) and argmax agreement of at least
    ``LM_FWD_AGREE``; the decode and forward logits are appended to the
    list ``logits`` where one is given. For an MoE config
    (``cfg`` from ``_no_drops``) also the routes: how many (token, layer)
    pick another expert set in the forward than in the steps, and how many
    (token, k) the forward drops past an expert's capacity."""
    from repro_torch.models import decode_step, forward_lm, init_cache

    tokens = _lm_tokens(torch, toks[0], device)
    with _Routes() as dec:
        cache = init_cache(cfg, 1, LM_MAX_LEN, device=device)
        stepped = []
        for i in range(LM_FWD):
            lg, cache = decode_step(weights, cfg, tokens[:, i:i + 1], cache)
            stepped.append(lg[:, 0].float())
        stepped = torch.stack(stepped, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Routes() as fwd:
        full = forward_lm(weights, cfg, {"tokens": tokens}).float()
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t0) * 1e3
    excess, spread = _close_logits(stepped, full, tol)
    agree = float((full.argmax(-1) == stepped.argmax(-1)).float().mean())
    out = {"tokens": LM_FWD, "max_abs_diff": spread, "tol": tol,
           "argmax_agree": agree, "agree_min": LM_FWD_AGREE,
           "forward_ms": forward_ms,
           "ok": excess <= 0 and agree >= LM_FWD_AGREE}
    if logits is not None:
        logits.append((stepped, full))
    if cfg.moe is None:
        return out
    n = cfg.n_layers
    per_layer = [torch.cat(dec.seen[layer::n], dim=1) for layer in range(n)]
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(per_layer, fwd.seen))
    out.update(capacity_factor=cfg.moe.capacity_factor,
               forward_drops=_forward_drops(fwd.seen, cfg, LM_FWD),
               routes_differing=flips, routes=LM_FWD * n)
    return out


def run_lm_serve_path(torch, cfg, device="cuda", cpu_layers=LM_CPU_LAYERS,
                      tag="lm", cpu_max_len=LM_CPU_TOKENS,
                      cpu_tokens=LM_CPU_TOKENS, f32_forward=False,
                      bf16_forward=True):
    """Phase 16 (and 17a, 18a-b): ``ServeEngine`` over ``cfg`` on
    ``device`` with the default overlapped tuner (see the module
    docstring). Returns the report and the kernels' launches on the
    serving waves.

    Decode against forward runs on the engine's weights (bfloat16),
    required within the reference's 0.15 where ``bf16_forward`` (else
    reported only), and with ``f32_forward`` also in float32 at full
    depth, required within ``LM_CPU_TOL``: the cache's check without
    bfloat16's rounding (the stored float32 weights, no copy).

    Card against CPU: float32 on both sides (TF32 off), the same weights
    (cast to float32 once, by ``compute_params``) and tokens, at depth
    ``cpu_layers``. The two sides sum the same float32 products in other
    orders (cuBLAS's blocked and split sums against the CPU's), which moves
    a dot product of length K by about sqrt(K) ulps of its terms: about
    1e-5 on logits of unit scale at K = 11008. ``LM_CPU_TOL`` (1e-3,
    relative and absolute) is two orders above that and two below the gaps
    between the top logits that greedy decoding reads."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import (
        compute_params,
        decode_step,
        init_cache,
        init_params,
    )
    from repro_torch.models.init import block_pattern
    from repro_torch.serve import Request, ServeEngine

    rep = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "n_params": cfg.n_params(),
           "host_us_per_op": {"start": host_us_per_op(torch, device)}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=device)
    torch.cuda.synchronize()
    rep["init_s"] = time.perf_counter() - t0
    rep["init_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    rep["param_bytes"] = _nbytes(params)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, params, max_len=LM_MAX_LEN, device=device)
    torch.cuda.synchronize()
    rep["engine_s"] = time.perf_counter() - t0
    rep["weight_bytes"] = _nbytes(eng.params)
    print(f"{tag}: {cfg.name} {cfg.n_layers} layers, {rep['n_params']} "
          f"parameters, {rep['param_bytes']} bytes stored, "
          f"{rep['weight_bytes']} as the engine reads them; init "
          f"{rep['init_s']:.2f} s, engine {rep['engine_s']:.2f} s; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()}",
          flush=True)
    tuner = eng.prefix_index.tuner
    require(tuner is not None and tuner.cfg.scheduler.async_build,
            f"{tag}: the engine's default tuner is not the overlapped one")
    require(set(eng.prefix_index.index.shard_locate()) == {"fused"},
            f"{tag}: the prefix index does not locate with the fused kernels")
    steps, match_s, admit_s = _instrument(torch, eng)

    # serve_lm.py's waves, then the timed wave; counts reset just before
    rng = np.random.default_rng(0)
    base_prompt = rng.integers(0, cfg.vocab, 48).astype(np.int32)
    waves = [[base_prompt, base_prompt],
             [np.concatenate([base_prompt, rng.integers(
                 0, cfg.vocab, 16).astype(np.int32)]) for _ in range(3)]]
    trng = np.random.default_rng(16)
    distinct = [trng.integers(0, cfg.vocab, LM_TIMED_LEN).astype(np.int32)
                for _ in range(LM_TIMED_PROMPTS)]
    timed = distinct + distinct
    ops.reset_launch_counts()
    outs, counts_after = [], []
    for wave in waves:
        done = eng.generate([Request(i, p, LM_NEW)
                             for i, p in enumerate(wave)])
        outs.append([r.out for r in done])
        counts_after.append((eng.prefix_index.hits, eng.prefix_index.misses))
    del steps[:]
    match_s.clear()
    admit_s.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.generate([Request(i, p, LM_TIMED_NEW)
                         for i, p in enumerate(timed)])
    wave_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    torch.cuda.synchronize()
    timed_out = [r.out for r in done]
    rep["stored"] = _slot_report(eng.prefix_index.slots)
    print(f"{tag}: K launches on the serving waves {launches}; stored "
          f"{json.dumps(rep['stored'])}", flush=True)
    require(counts_after == [(1, 1), (4, 1)],
            f"{tag}: hits and misses after the waves {counts_after}, "
            f"expected [(1, 1), (4, 1)]")
    require(launches["fused_locate"] > 0 and launches["bmat_rank"] > 0
            and launches["gmm_estep"] > 0,
            f"{tag}: K1, K2 or K3 did not launch on the serving path "
            f"{launches}")
    require((eng.prefix_index.hits, eng.prefix_index.misses)
            == (4 + LM_TIMED_PROMPTS, 1 + LM_TIMED_PROMPTS),
            f"{tag}: the timed wave's second sends did not all hit")
    for i in range(LM_TIMED_PROMPTS):
        require(timed_out[i + LM_TIMED_PROMPTS] == timed_out[i],
                f"{tag}: timed prompt {i}: the hit's tokens differ from the "
                f"miss's")

    per_req = _split_steps(steps, timed)
    dec = [ms for r in per_req for ms, k in
           [x for x in r if x[1] == "decode"][1:]]
    miss_pre = [ms for r in per_req[:LM_TIMED_PROMPTS] for ms, k in r[1:]
                if k == "prefill"]
    # from the previous request's last step to this one's last prompt step
    to_prompt_end = [sum(ms for ms, k in r if k == "prefill")
                     for r in per_req[1:]]
    n_gen = LM_TIMED_NEW * len(timed)
    rep["timed_wave"] = {
        "requests": len(timed), "prompt_tokens": LM_TIMED_LEN,
        "new_tokens": LM_TIMED_NEW, "wave_s": wave_s,
        "generated_tokens_per_s": n_gen / wave_s,
        "decode_steps": len(steps),
        "decode_ms": {"p50": float(np.percentile(dec, 50)),
                      "p99": float(np.percentile(dec, 99)),
                      "mean": float(np.mean(dec)), "n": len(dec)},
        "miss_prefill_ms_per_token": float(np.mean(miss_pre)),
        "miss_prompt_ms": to_prompt_end[:LM_TIMED_PROMPTS - 1],
        "hit_prompt_ms": to_prompt_end[LM_TIMED_PROMPTS - 1:],
        "hit_prefill_steps": [sum(k == "prefill" for _, k in r)
                              for r in per_req[LM_TIMED_PROMPTS:]],
        "match_ms": {"p50": float(np.median(match_s)) * 1e3,
                     "max": float(np.max(match_s)) * 1e3},
        "admit_ms": {"p50": float(np.median(admit_s)) * 1e3,
                     "max": float(np.max(admit_s)) * 1e3},
    }

    # the device's busy time per decode step, against its wall time
    cache = init_cache(cfg, 1, LM_MAX_LEN, device=device)
    tok = _lm_tokens(torch, [7], device)
    for _ in range(3):
        decode_step(eng.params, cfg, tok, cache)
    state = {"cache": cache}

    def one_step():
        _, state["cache"] = decode_step(eng.params, cfg, tok, state["cache"])

    rep["host_us_per_op"]["before_profiler"] = host_us_per_op(torch, device)
    dev = _device_events(torch, lambda: [one_step() for _ in range(8)])
    rep["host_us_per_op"]["after_profiler"] = host_us_per_op(torch, device)
    wall = call_ms(torch, one_step, 8)
    rep["step_device_busy_ms"] = _per_call_ms(dev, 8) if dev else None
    rep["step_device_events"] = len(dev) / 8 if dev else None
    rep["step_back_to_back_ms"] = wall
    rep["threads"] = threading.active_count()
    # a step reads every weight but the embedding table (one row of it)
    # and the decode state at the timed wave's mean position
    emb = eng.params["embed"]
    el = emb.element_size()
    cache_bytes = _state_bytes(cache, LM_TIMED_LEN + LM_TIMED_NEW // 2)
    step_bytes = (rep["weight_bytes"] - emb.numel() * el
                  + cfg.d_model * el + cache_bytes)
    rep["bound_bytes"] = step_bytes
    rep["bound_ms"] = step_bytes / HBM_BYTES_PER_S * 1e3
    if cfg.moe is not None:
        # the dense dispatch reads every expert; the routed ones alone
        experts = _nbytes({k: v for k, v in
                           eng.params["layers"]["blk0_attn"].items()
                           if k in ("we1", "we2", "we3")})
        routed = step_bytes - experts * (1 - cfg.moe.top_k
                                         / cfg.moe.n_experts)
        rep["expert_bytes"] = experts
        rep["bound_routed_bytes"] = routed
        rep["bound_routed_ms"] = routed / HBM_BYTES_PER_S * 1e3
    del cache, state

    # every request of serve_lm.py's waves against a fresh engine's cold run
    for wave, out in zip(waves, outs):
        for p, o in zip(wave, out):
            require(o == _cold_tokens(cfg, eng.params, p, LM_NEW, device),
                    f"{tag}: a request's tokens differ from its cold run")

    # decode against forward (tests/test_models_smoke.py's check, with the
    # capacity factor it sets for MoE: no drops on either side)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, LM_FWD))
    logits = []
    dvf = decode_vs_forward(torch, eng.params, _no_drops(cfg), toks, device,
                            logits=logits)
    rep["decode_vs_forward"] = dvf
    require(dvf["ok"] or not bf16_forward,
            f"{tag}: decode and forward disagree ({json.dumps(dvf)})")
    if f32_forward:
        c32 = dataclasses.replace(cfg, compute_dtype="float32")
        d32 = decode_vs_forward(torch, compute_params(params, c32, device),
                                c32, toks, device, tol=LM_CPU_TOL,
                                logits=logits)
        # how far each bfloat16 mode lies from its float32 result
        d32["bf16_max_abs_diff"] = {
            mode: _close_logits(b16, b32, LM_FWD_TOL)[1] for mode, b16, b32
            in zip(("decode", "forward"), logits[0], logits[1])}
        rep["decode_vs_forward_f32"] = d32
        require(d32["ok"], f"{tag}: float32 decode and forward disagree "
                           f"({json.dumps(d32)})")
    del logits
    if cfg.moe is not None and dvf["capacity_factor"] != MOE_FWD_CF:
        # the reference's own factor, for the record: here it drops
        cf16 = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_FWD_CF))
        rep["decode_vs_forward_cf16"] = decode_vs_forward(
            torch, eng.params, cf16, toks, device)
    eng.close()
    # the timing wrappers hold the engine in a reference cycle
    del eng, tuner, emb, steps
    gc.collect()

    # the card against the CPU at depth cpu_layers (whole pattern groups),
    # float32, cpu_tokens tokens into a cache of cpu_max_len
    groups, rest = divmod(cpu_layers, len(block_pattern(cfg)))
    require(rest == 0, f"{tag}: depth {cpu_layers} cuts a pattern group")
    cfg2 = dataclasses.replace(cfg, n_layers=cpu_layers,
                               compute_dtype="float32")
    p2 = {k: v for k, v in params.items() if k != "layers"}
    p2["layers"] = _map_tree(lambda v: v[:groups], params["layers"])
    host = _map_tree(lambda v: v.cpu(), p2)
    p2 = compute_params(p2, cfg2, device)
    host = compute_params(host, cfg2, "cpu")
    require(not torch.backends.cuda.matmul.allow_tf32,
            f"{tag}: TF32 matmuls are on; float32 on the card must be "
            f"float32")
    caches = [init_cache(cfg2, 1, cpu_max_len, device=d)
              for d in (device, "cpu")]
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, 4)
    tok_dev = [_lm_tokens(torch, prompt[:1], d) for d in (device, "cpu")]
    worst, spread, gen = -1.0, 0.0, []
    t0 = time.perf_counter()
    for i in range(cpu_tokens):
        lg_c, caches[0] = decode_step(p2, cfg2, tok_dev[0], caches[0])
        lg_h, caches[1] = decode_step(host, cfg2, tok_dev[1], caches[1])
        e, s = _close_logits(lg_c.cpu(), lg_h, LM_CPU_TOL)
        worst, spread = max(worst, e), max(spread, s)
        pick_c, pick_h = int(lg_c.argmax()), int(lg_h.argmax())
        require(pick_c == pick_h, f"{tag}: card and CPU greedy tokens "
                                  f"differ at step {i}: {pick_c} != {pick_h}")
        nxt = [int(prompt[i + 1])] if i + 1 < len(prompt) else [pick_c]
        gen.append(pick_c)
        tok_dev = [_lm_tokens(torch, nxt, d) for d in (device, "cpu")]
    rep["card_vs_cpu"] = {"n_layers": cpu_layers, "steps": cpu_tokens,
                          "max_len": cpu_max_len,
                          "max_abs_diff": spread, "tol": LM_CPU_TOL,
                          "greedy": gen, "s": time.perf_counter() - t0}
    require(worst <= 0, f"{tag}: card and CPU logits differ by {spread} at "
                        f"depth {cpu_layers}")
    rep["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    del p2, host, caches, params, lg_c, lg_h
    gc.collect()
    torch.cuda.empty_cache()
    rep["left_bytes"] = torch.cuda.memory_allocated() - base
    require(rep["left_bytes"] < LM_LEFT_BYTES,
            f"{tag}: {rep['left_bytes']} bytes still allocated after "
            f"tear-down")
    rep["hits_misses"] = counts_after
    rep["card"] = card_line()
    print(f"{tag} serve " + json.dumps(rep), flush=True)
    return rep, launches


# ---------------------------------------------------------------------------
# MoE and MLA serving, ragged dispatch and K6 (phase 17)
# ---------------------------------------------------------------------------


def run_moe_ragged(torch, device="cuda"):
    """Phase 17b: ``forward_lm`` of ``MOE_RAGGED_ARCH`` at full width and
    depth ``MOE_RAGGED_LAYERS`` on a (2, 256) batch with ragged dispatch
    (K6) and with dense dispatch, in float32 and in bfloat16 compute, both
    at a capacity factor where the dense dispatch drops nothing, so the
    two are one function: the larger of ``MOE_RAGGED_CF``
    (``test_moe_ragged_matches_dense``'s 8) and E / k (16 for 128 experts
    over top-8; at 8 an expert holds 256 slots, and 512 tokens may pick
    it: that reading, with its drops, is reported beside). Float32: logits
    within ``MOE_RAGGED_TOL`` and the same argmax at every position;
    bfloat16: max |diff| and argmax agreement reported. Every K6 launch of
    the ragged forwards must take the TMA path. Each forward's ms between
    CUDA events, and the ragged one's device ms with K6's part of it.
    Returns the report and the launches of the forwards."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import compute_params, forward_lm, init_params

    full = get_config(MOE_RAGGED_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_RAGGED_LAYERS)
    cf = float(max(MOE_RAGGED_CF, math.ceil(cfg.moe.n_experts
                                            / cfg.moe.top_k)))
    t = MOE_RAGGED_BATCH[0] * MOE_RAGGED_BATCH[1]
    rep = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "n_params": cfg.n_params(), "batch": list(MOE_RAGGED_BATCH),
           "capacity_factor": cf}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, 0, device=device)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, MOE_RAGGED_BATCH)
    batch = {"tokens": torch.as_tensor(toks, device=device)}
    ops.reset_launch_counts()
    runs = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        moe = dataclasses.replace(c.moe, capacity_factor=cf)
        c_r = dataclasses.replace(c, moe=dataclasses.replace(
            moe, dispatch="ragged"))
        c_d = dataclasses.replace(c, moe=moe)
        w = compute_params(params, c, device)
        before = ops.launch_counts()["ragged_dot"]
        paths = _k6_paths()
        lr = forward_lm(w, c_r, batch).float()
        k6 = ops.launch_counts()["ragged_dot"] - before
        k6_paths = _k6_paths(paths)
        require(k6_paths["simple"] == 0,
                f"moe ragged: K6 left the TMA path at {dtype}: {k6_paths}")
        with _Routes() as routes:
            ld = forward_lm(w, c_d, batch).float()
        torch.cuda.synchronize()
        require(k6 == 3 * cfg.n_layers,
                f"moe ragged: K6 launched {k6} times in a {dtype} forward, "
                f"expected {3 * cfg.n_layers}")
        require(bool(torch.isfinite(lr).all() and torch.isfinite(ld).all()),
                f"moe ragged: non-finite logits at {dtype}")
        excess, spread = _close_logits(lr, ld, MOE_RAGGED_TOL)
        agree = float((lr.argmax(-1) == ld.argmax(-1)).float().mean())
        drops = _forward_drops(routes.seen, c_d, t)
        rep[dtype] = {"max_abs_diff": spread, "argmax_agree": agree,
                      "k6_launches": k6, "k6_paths": k6_paths,
                      "dense_drops": drops}
        require(drops == 0, f"moe ragged: the dense dispatch dropped "
                            f"{drops} (token, k) at capacity factor {cf}")
        if dtype == "float32":
            rep[dtype]["tol"] = MOE_RAGGED_TOL
            require(excess <= 0 and agree == 1.0,
                    f"moe ragged: ragged and dense float32 logits differ "
                    f"(max |diff| {spread}, argmax agreement {agree})")
        if dtype == "float32" and cf != MOE_RAGGED_CF:
            # the test's own factor, for the record: here it drops
            c_8 = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=MOE_RAGGED_CF))
            with _Routes() as routes:
                l8 = forward_lm(w, c_8, batch).float()
            _, spread8 = _close_logits(lr, l8, MOE_RAGGED_TOL)
            rep[dtype][f"cf{MOE_RAGGED_CF:g}"] = {
                "max_abs_diff": spread8,
                "argmax_agree": float((lr.argmax(-1) == l8.argmax(-1))
                                      .float().mean()),
                "dense_drops": _forward_drops(routes.seen, c_8, t)}
            del l8
        runs[dtype] = (w, c_r, c_d)
        del lr, ld
    launches = ops.launch_counts()
    # each forward's time between CUDA events, and its device time with
    # K6's part of it, after the counts are read
    for dtype, (w, c_r, c_d) in runs.items():
        rep[dtype]["forward_ms"] = {
            name: call_ms(torch, lambda: forward_lm(w, cc, batch), 3)
            for name, cc in (("ragged", c_r), ("dense", c_d))}
        rep[dtype]["forward_device_ms"], rep[dtype]["k6_device_ms"] = (
            _forward_device_ms(torch, lambda: forward_lm(w, c_r, batch)))
    del runs, w
    torch.cuda.synchronize()
    rep["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    rep["left_bytes"] = torch.cuda.memory_allocated() - base
    require(rep["left_bytes"] < LM_LEFT_BYTES,
            f"moe ragged: {rep['left_bytes']} bytes still allocated")
    print("moe ragged " + json.dumps(rep), flush=True)
    return rep, launches


def _forward_device_ms(torch, fn, iters: int = 3):
    """Device ms per call of ``fn`` (a forward) from the profiler's device
    events, and the part of it in K6's kernels; (None, None) where the
    profiler saw no device event."""
    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(iters):
            fn()

    dev = _device_events(torch, body)
    if dev is None:
        return None, None
    total = _per_call_ms(dev, iters)
    return total, total - _per_call_ms(dev, iters, skip=("ragged_dot",))


def _k6_paths(since=None) -> dict:
    """K6's launches by path (``ragged_dot.launches_by_path``), or those
    made after the counts ``since``."""
    from repro_torch.kernels.ragged_dot import ragged_dot

    now = dict(ragged_dot.launches_by_path)
    return now if since is None else {p: c - since[p] for p, c in now.items()}


def k6_inputs(torch, m, k, n, g, dtype, seed, empty=False, device="cuda"):
    """K6 inputs of one shape: lhs [M, K] and rhs [G, K, N] normals (rhs
    fan-in scaled) and group sizes from a uniform routing of the M rows
    (``empty``: every third group empty and 100 rows past the sum)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if empty:
        w = torch.rand(g, generator=gen, device=device)
        w[::3] = 0
        sizes = (w / w.sum() * (m - 100)).floor().to(torch.int32)
    else:
        e = torch.randint(0, g, (m,), generator=gen, device=device)
        sizes = torch.zeros(g, dtype=torch.int32, device=device).scatter_add_(
            0, e, torch.ones_like(e, dtype=torch.int32))
    lhs = torch.randn(m, k, generator=gen, device=device).to(dtype)
    rhs = (torch.randn(g, k, n, generator=gen, device=device)
           / k ** 0.5).to(dtype)
    return lhs, rhs, sizes


def _grouped_mm(torch, lhs, rhs, sizes):
    """``torch.nn.functional.grouped_mm`` on K6's inputs (the yardstick
    only), or the reason it does not run here."""
    import torch.nn.functional as F

    fn = getattr(F, "grouped_mm", None)
    if fn is None:
        return None, "torch.nn.functional.grouped_mm is missing"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    # the grouped kernel may want the rhs's last two dims column-major
    rhs_t = rhs.transpose(-2, -1).contiguous().transpose(-2, -1)
    err = None
    for b in (rhs, rhs_t):
        try:
            fn(lhs, b, offs=offs)
            torch.cuda.synchronize()
            return (lambda: fn(lhs, b, offs=offs)), None
        except Exception as e:  # noqa: BLE001 — the yardstick only
            err = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return None, err


def k6_bound(torch, lhs, rhs, sizes):
    """The larger of the bytes K6 must move (lhs, the non-empty groups'
    rhs and out, once each, over 3.35 TB/s) and 2 M K N operations over
    the peak for the input type (989 TFLOP/s bf16 tensor cores; 67 TFLOP/s
    float32, which the kernel computes without TF32)."""
    m, k = lhs.shape
    g, _, n = rhs.shape
    el = lhs.element_size()
    nonempty = int((sizes > 0).sum())
    n_bytes = (m * k + nonempty * k * n + m * n) * el
    rate = BF16_OPS_PER_S if lhs.dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / rate * 1e3
    return n_bytes, ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))


def _held(torch, got, want, dtype, label):
    """Holds K6's or K6w's output ``got`` to the plain version's ``want``:
    float32 within ``K6_F32_TOL`` relative and absolute (the sums differ in
    order only: the kernel's against cuBLAS's), bfloat16 within one bf16
    ulp of the plain value plus that bound (each rounds its own float32
    sum once). Returns (max abs error, for bfloat16 [count of outputs
    beyond one ulp, largest excess] else None)."""
    w = want.float()
    diff = (got.float() - w).abs()
    tol = K6_F32_TOL * (1 + w.abs())
    over_ulp = None
    if dtype == torch.bfloat16:
        past = diff - BF16_ULP * w.abs()
        if past.numel():
            over_ulp = [int((past > 0).sum()), float(past.max())]
        diff_past = past
    else:
        diff_past = diff
    bad = diff_past > tol
    e = float(diff.max()) if diff.numel() else 0.0
    require(not bool(bad.any()),
            f"{label}: {int(bad.sum())} outputs off the plain version (max "
            f"abs error {e})")
    return e, over_ulp


def compare_k6(torch, device="cuda"):
    """Phase 17c: K6 against ``ragged_dot_plain`` on the card at the main
    path's shapes (``K6_SHAPES``), a case with empty groups and rows past
    the sum, and a shape off the 16-byte vector path, in float32 and
    bfloat16; then each case's device ms, call ms, plain ms,
    ``F.grouped_mm``'s device ms where it runs, and the bound, with the
    kernel each case took (``path``: every ``K6_SHAPES`` entry and the
    empty case must take TMA, the odd shape the simple kernel) and its
    launches by path over the case's checks and timings. Float32 is
    held within ``K6_F32_TOL`` (relative and absolute: its fmaf chain
    against cuBLAS's blocked sums of up to 5120 products), bfloat16 within
    one bf16 ulp of the plain value plus that float32 bound (each rounds
    its own float32 sum once; the tensor cores sum in another order, so
    near zero, where an ulp is small, the sums' difference can pass it; the
    count of outputs beyond one ulp is reported). Returns (max abs error,
    the headline timing with the other cases as variants)."""
    from repro_torch.kernels.ragged_dot import ragged_dot
    from repro_torch.kernels.ref import ragged_dot_plain

    want_path = {name: "tma" for name in K6_SHAPES}
    want_path.update(empty="tma", odd="simple")
    cases = {name: (shape, False) for name, shape in K6_SHAPES.items()}
    cases.update(empty=((1000, 256, 192, 40), True),
                 odd=((333, 100, 70, 7), False))
    err, timings = 0.0, {}
    for name, ((m, k, n, g), empty) in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            label = f"{name} {str(dtype)[6:]}"
            lhs, rhs, sizes = k6_inputs(torch, m, k, n, g, dtype, 17,
                                        empty=empty, device=device)
            paths = _k6_paths()
            got = ragged_dot(lhs, rhs, sizes)
            took = [p for p, c in _k6_paths(paths).items() if c]
            require(took == [want_path[name]],
                    f"K6 ({label}): took the {took} path, expected "
                    f"{want_path[name]}")
            want = ragged_dot_plain(lhs, rhs, sizes)
            torch.cuda.synchronize()
            total = int(sizes.sum())
            require(not bool(got[total:].any()),
                    f"K6 ({label}): rows past the sum are not zero")
            e, over_ulp = _held(torch, got, want, dtype, f"K6 ({label})")
            err = max(err, e)
            if name == "odd":
                print(f"K6 {label}: path {took[0]}, max abs error {e}",
                      flush=True)
                continue
            lib, why = _grouped_mm(torch, lhs, rhs, sizes)
            n_bytes, bound = k6_bound(torch, lhs, rhs, sizes)
            timings[label] = dict(
                ms=device_ms(torch, lambda: ragged_dot(lhs, rhs, sizes), 20),
                call_ms=call_ms(torch, lambda: ragged_dot(lhs, rhs, sizes),
                                20),
                plain_ms=device_ms(
                    torch, lambda: ragged_dot_plain(lhs, rhs, sizes), 3),
                library_ms=device_ms(torch, lib, 20) if lib else None,
                bytes=n_bytes, bound=bound, max_abs_err=e,
                path=took[0], launches_by_path=_k6_paths(paths),
                beyond_one_bf16_ulp=over_ulp,  # [count, largest excess]
                shape=dict(m=m, k=k, n=n, g=g, rows=total,
                           nonempty=int((sizes > 0).sum())),
            )
            if why:
                timings[label]["library_error"] = why
            print(f"K6 {label}: {json.dumps(timings[label])}", flush=True)
            del lhs, rhs, sizes, got, want
    print(f"kernels[ragged_dot]: K6 max abs error {err:.3g} over "
          f"{2 * len(cases)} cases", flush=True)
    head = dict(timings[K6_HEADLINE])
    head["variants"] = {k: v for k, v in timings.items()
                        if k != K6_HEADLINE}
    return err, head


def run_moe_path(torch, device="cuda"):
    """Phase 17: 17a serves ``MOE_SERVE_ARCH`` at full width and depth
    ``MOE_SERVE_LAYERS`` through ``ServeEngine`` (``run_lm_serve_path``);
    17b runs the ragged dispatch against the dense one
    (``run_moe_ragged``); 17c holds K6 to its plain version and times it
    (``compare_k6``). Returns (reports, launches by path, K6's error and
    timing)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MOE_SERVE_ARCH),
                              n_layers=MOE_SERVE_LAYERS)
    base = torch.cuda.memory_allocated()
    serve_rep, serve_launches = run_lm_serve_path(
        torch, cfg, device, cpu_layers=MOE_CPU_LAYERS, tag="moe")
    ragged_rep, ragged_launches = run_moe_ragged(torch, device)
    require(ragged_launches["ragged_dot"] > 0,
            "moe: K6 did not launch on the ragged path")
    err, timing = compare_k6(torch, device)
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    require(left < LM_LEFT_BYTES,
            f"moe: {left} bytes still allocated after phase 17")
    return ({"serve": serve_rep, "ragged": ragged_rep},
            {"moe_serve": serve_launches, "moe_ragged": ragged_launches},
            err, timing)


# ---------------------------------------------------------------------------
# recurrent and encoder-decoder families (phase 18)
# ---------------------------------------------------------------------------


def run_recurrent_path(torch, device="cuda"):
    """Phase 18a-b: ``run_lm_serve_path`` over each of ``REC_SERVE`` at
    full width and depth, decode against forward also in float32, the
    card against the CPU at its depth there, ``REC_CPU_TOKENS`` tokens
    into ``REC_CPU_MAX_LEN``. Returns the reports and the launches by
    path."""
    from repro_torch.configs import get_config

    reps, launches = {}, {}
    for arch, cpu_layers, bf16_forward in REC_SERVE:
        tag = arch.split("-")[0]
        rep, launches[f"{tag}_serve"] = run_lm_serve_path(
            torch, get_config(arch), device, cpu_layers=cpu_layers, tag=tag,
            cpu_max_len=REC_CPU_MAX_LEN, cpu_tokens=REC_CPU_TOKENS,
            f32_forward=True, bf16_forward=bf16_forward)
        require(rep["stored"].get("snapshots", 0) > 0,
                f"{tag}: the prefix index stored no snapshots")
        reps[arch] = rep
    return reps, launches


def run_encdec_path(torch, device="cuda"):
    """Phase 18c: ``ED_ARCH`` at full width and depth. ``forward_lm`` over
    ``ENC_FRAMES`` frames and ``ED_TOKENS`` decoder tokens against as many
    decode steps with ``enc_kv`` from the encoder (cross-attention masks no
    slot, so the two agree only over the full 1500 frames), within the
    reference's ``LM_FWD_TOL`` and ``LM_FWD_AGREE``; decode ms per token
    between CUDA events; then the card against the CPU in float32 (the
    forward and every step, within ``LM_CPU_TOL``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import (
        compute_params,
        decode_step,
        forward_lm,
        init_cache,
        init_params,
    )
    from repro_torch.models.transformer import ENC_FRAMES, _encoder_kv

    cfg = get_config(ED_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, 0, device=device)
    rng = np.random.default_rng(3)
    frames = rng.normal(0, 1, (1, ENC_FRAMES, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, ED_TOKENS)

    def run(weights, c, dev, timed=False):
        """Forward logits, decode logits and the per-step ms on ``dev``."""
        batch = {"enc_frames": torch.as_tensor(frames, device=dev),
                 "dec_tokens": _lm_tokens(torch, toks, dev)}
        ms = {}
        t0 = time.perf_counter()
        full = forward_lm(weights, c, batch).float()
        if timed:
            torch.cuda.synchronize()
            ms["forward"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
        cache = init_cache(c, 1, ED_TOKENS, device=dev)._replace(
            enc_kv=_encoder_kv(weights, c, batch["enc_frames"]))
        if timed:
            torch.cuda.synchronize()
            ms["encoder_kv"] = (time.perf_counter() - t0) * 1e3
        steps, events = [], []
        for i in range(ED_TOKENS):
            lg, cache = decode_step(weights, c, batch["dec_tokens"][:, i:i + 1],
                                    cache)
            steps.append(lg[:, 0].float())
            if timed:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
        if timed:
            torch.cuda.synchronize()
            ms["decode"] = [a.elapsed_time(b) for a, b in
                            zip(events, events[1:])]
        return full, torch.stack(steps, 1), ms

    full, stepped, ms = run(compute_params(params, cfg, device), cfg, device,
                            timed=True)
    excess, spread = _close_logits(stepped, full, LM_FWD_TOL)
    agree = float((full.argmax(-1) == stepped.argmax(-1)).float().mean())
    rep = {"arch": cfg.name, "n_params": cfg.n_params(),
           "frames": ENC_FRAMES, "tokens": ED_TOKENS,
           "forward_ms": ms["forward"], "encoder_kv_ms": ms["encoder_kv"],
           "decode_ms": {"p50": float(np.percentile(ms["decode"], 50)),
                         "p99": float(np.percentile(ms["decode"], 99))},
           "decode_vs_forward": {"max_abs_diff": spread, "tol": LM_FWD_TOL,
                                 "argmax_agree": agree}}
    require(excess <= 0 and agree >= LM_FWD_AGREE,
            f"encdec: decode and forward disagree ({json.dumps(rep)})")

    # the card against the CPU, float32 at full depth
    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    card = run(compute_params(params, c32, device), c32, device)
    host = run(compute_params(_map_tree(lambda v: v.cpu(), params), c32,
                              "cpu"), c32, "cpu")
    worst, spread = -1.0, 0.0
    for a, b in zip(card[:2], host[:2]):
        e, d = _close_logits(a.cpu(), b, LM_CPU_TOL)
        worst, spread = max(worst, e), max(spread, d)
    rep["card_vs_cpu"] = {"max_abs_diff": spread, "tol": LM_CPU_TOL}
    require(worst <= 0, f"encdec: card and CPU logits differ by {spread}")
    rep["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    del params, card, full, stepped
    gc.collect()
    torch.cuda.empty_cache()
    rep["left_bytes"] = torch.cuda.memory_allocated() - base
    require(rep["left_bytes"] < LM_LEFT_BYTES,
            f"encdec: {rep['left_bytes']} bytes still allocated")
    rep["card"] = card_line()
    print("encdec " + json.dumps(rep), flush=True)
    return rep


# ---------------------------------------------------------------------------
# training (phase 19)
# ---------------------------------------------------------------------------


def k6w_inputs(torch, m, k, n, g, dtype, seed, kind, device="cuda"):
    """K6's backward inputs of one shape: ``k6_inputs``' lhs, rhs and group
    sizes, and the output's gradient dout [M, N] (normals). ``kind``:
    ``"routed"`` every row in some group, ``"empty"`` every third group
    empty and 100 rows past the sum, ``"past"`` every group routed and
    ``K6W_PAST_ROWS`` rows past the sum, ``"long"`` group 1 holding
    ``K6W_LONG_ROWS`` rows more than a uniform routing of the rest."""
    lhs, rhs, sizes = k6_inputs(torch, m, k, n, g, dtype, seed,
                                empty=kind == "empty", device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    if kind in ("past", "long"):
        cut = K6W_PAST_ROWS if kind == "past" else K6W_LONG_ROWS
        e = torch.randint(0, g, (m - cut,), generator=gen, device=device)
        sizes = torch.bincount(e, minlength=g).to(torch.int32)
        if kind == "long":
            sizes[1] += cut
    dout = torch.randn(m, n, generator=gen, device=device).to(dtype)
    return lhs, rhs, sizes, dout


def k6w_bound(torch, lhs, dout, sizes, g):
    """The larger of the bytes K6w must move (the lhs and dout rows that
    lie in some group, read once, and the G K N output, written once, over
    3.35 TB/s) and 2 x rows x K x N operations over the peak for the input
    type (989 TFLOP/s bf16 tensor cores; 67 TFLOP/s float32)."""
    m, k = lhs.shape
    n = dout.shape[1]
    rows = min(int(sizes.clamp(min=0).sum()), m)
    n_bytes = (rows * (k + n) + g * k * n) * lhs.element_size()
    rate = BF16_OPS_PER_S if lhs.dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * rows * k * n / rate * 1e3
    return n_bytes, ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))


def _grouped_mm_wgrad(torch, lhs, dout, sizes):
    """``F.grouped_mm``'s 2-D x 2-D ragged-K form on K6w's inputs
    (lhs^T [K, M] and dout [M, N] grouped along M; the yardstick only), or
    the reason it does not run here."""
    import torch.nn.functional as F

    fn = getattr(F, "grouped_mm", None)
    if fn is None:
        return None, "torch.nn.functional.grouped_mm is missing"
    offs = torch.cumsum(sizes, 0, dtype=torch.int32)
    err = None
    for a, b in ((lhs.T, dout), (lhs.T.contiguous(), dout),
                 (lhs.T.contiguous(), dout.T.contiguous().T)):
        try:
            fn(a, b, offs=offs)
            torch.cuda.synchronize()
            return (lambda: fn(a, b, offs=offs)), None
        except Exception as e:  # noqa: BLE001 — the yardstick only
            err = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return None, err


def _k6_backward(torch, lhs, rhs, sizes, dout):
    """K6's whole backward as autograd runs it (K6 for lhs, reading rhs
    transposed in place on the TMA path or over a transposed copy on the
    simple one; K6w for rhs), repeatable: returns (the forward's output,
    fn() -> (dlhs, drhs))."""
    from repro_torch.kernels.ragged_dot import ragged_dot

    a = lhs.detach().requires_grad_(True)
    b = rhs.detach().requires_grad_(True)
    out = ragged_dot(a, b, sizes)
    return out.detach(), lambda: torch.autograd.grad(out, (a, b), dout,
                                                     retain_graph=True)




def _backward_split(torch, back, iters: int):
    """The backward's device ms per call split by kernel from the
    profiler's events of ``iters`` calls: K6w (``ragged_dot_wgrad``), the
    data gradient's K6 (the other ``ragged_dot`` kernels) and everything
    else (the transposed copy, where the simple path makes one), with the
    names of the latter; None where the profiler saw no device event."""
    for _ in range(2):
        back()
    torch.cuda.synchronize()

    def body():
        for _ in range(iters):
            back()

    dev = _device_events(torch, body)
    if dev is None:
        return None
    k6w = [e for e in dev if "ragged_dot_wgrad" in e.name]
    k6 = [e for e in dev if "ragged_dot" in e.name and e not in k6w]
    rest = [e for e in dev if "ragged_dot" not in e.name]
    return {"k6w_ms": _per_call_ms(k6w, iters),
            "dgrad_k6_ms": _per_call_ms(k6, iters),
            "copy_ms": _per_call_ms(rest, iters),
            "copy_kernels": sorted({e.name[:80] for e in rest})}


def compare_k6w(torch, device="cuda"):
    """Phase 19a: K6's forward and backward on the card against the plain
    versions computed on the CPU, at the shapes phase 19c's trainer
    launches, at phase 17c's shapes (``K6_SHAPES``) and in a case with
    one group whose rows wrap K6w's ring, a case with empty groups and one
    with rows past the sum (``K6W_CASES``), in float32 and bfloat16, each
    held by ``_held``. Autograd's backward must launch K6 once (lhs; in
    its dgrad mode, reading rhs in place, on the TMA path) and K6w once
    (rhs; on the path ``wgrad_path`` names); on TMA shapes it must make no
    transposed copy of rhs (no device kernel beside K6's and K6w's, and a
    peak below the two gradients and half of rhs); a second K6w call must
    give the same bits; in float32 K6w must equal its simple kernel and
    the dgrad mode K6 over a transposed copy bit for bit; rows past the
    sum get a zero lhs gradient and empty groups a zero rhs gradient. Then
    each case's K6w device ms and call ms beside the simple kernel's (the
    first design, timed here), the whole backward's device ms split into K6w, the dgrad K6 and any copy, its
    peak memory, the plain version's device ms on the card,
    ``F.grouped_mm``'s ragged-K form where it runs (the yardstick only)
    and the bound. Returns (max abs error, the headline timing with the
    other cases as variants)."""
    from repro_torch.kernels.ragged_dot import (
        _k6,
        _k6w,
        path,
        ragged_dot,
        ragged_dot_wgrad,
        wgrad_path,
    )
    from repro_torch.kernels.ref import (
        ragged_dot_plain,
        ragged_dot_wgrad_plain,
    )

    err, timings = 0.0, {}
    for name, ((m, k, n, g), kind) in K6W_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            label = f"K6w {name} {str(dtype)[6:]}"
            lhs, rhs, sizes, dout = k6w_inputs(torch, m, k, n, g, dtype, 19,
                                               kind, device)
            out, back = _k6_backward(torch, lhs, rhs, sizes, dout)
            which, dgrad = wgrad_path(lhs, dout), path(dout, rhs)
            k6, k6w = ragged_dot.launches, ragged_dot_wgrad.launches
            k6p = dict(ragged_dot.launches_by_path)
            k6wp = dict(ragged_dot_wgrad.launches_by_path)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            dl, dr = back()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - mem0
            again = ragged_dot_wgrad(lhs, dout, sizes, g)
            torch.cuda.synchronize()
            require(ragged_dot.launches - k6 == 1
                    and ragged_dot_wgrad.launches - k6w == 2,
                    f"{label}: backward launched K6 "
                    f"{ragged_dot.launches - k6} and K6w "
                    f"{ragged_dot_wgrad.launches - k6w - 1} times")
            dgrad_key = "tma_dgrad" if dgrad == "tma" else "simple"
            require(ragged_dot.launches_by_path[dgrad_key]
                    - k6p[dgrad_key] == 1
                    and ragged_dot_wgrad.launches_by_path[which]
                    - k6wp[which] == 2,
                    f"{label}: the backward left K6's {dgrad_key} or "
                    f"K6w's {which} path")
            grads = (dl.numel() + dr.numel()) * dl.element_size()
            if dgrad == "tma":
                require(peak < grads + rhs.numel() * rhs.element_size() // 2,
                        f"{label}: the backward's peak {peak} bytes holds "
                        f"a copy of rhs beside its gradients' {grads}")
            require(torch.equal(dr, again), f"{label}: two K6w calls differ")
            bits = {}
            if which == "tma":
                bits["drhs_vs_simple"] = torch.equal(
                    dr, _k6w(lhs, dout, sizes, g, "simple"))
            if dgrad == "tma":
                bits["dlhs_vs_copy"] = torch.equal(
                    dl, _k6(dout, rhs.transpose(1, 2).contiguous(), sizes))
            if dtype == torch.float32:
                require(all(bits.values()),
                        f"{label}: float32 differs from the simple kernel "
                        f"or from K6 over the copy: {bits}")
            rows = min(int(sizes.clamp(min=0).sum()), m)
            require(not bool(dl[rows:].any()),
                    f"{label}: rows past the sum have a gradient")
            require(not bool(dr[sizes == 0].any()),
                    f"{label}: an empty group has a gradient")
            # the forward (K6), the lhs gradient (K6 over dout and rhs
            # transposed) and the rhs gradient (K6w), each against the
            # plain version on the CPU
            host = [t.cpu() for t in (lhs, rhs, sizes, dout)]
            e_f, _ = _held(torch, out, ragged_dot_plain(
                host[0], host[1], host[2]).to(device), dtype,
                f"{label} forward")
            e_l, ulp_l = _held(torch, dl, ragged_dot_plain(
                host[3], host[1].transpose(1, 2), host[2]).to(device), dtype,
                f"{label} dlhs")
            e_r, ulp_r = _held(torch, dr, ragged_dot_wgrad_plain(
                host[0], host[3], host[2], g).to(device), dtype,
                f"{label} drhs")
            del host, out, dl, dr, again
            err = max(err, e_f, e_l, e_r)
            lib, why = _grouped_mm_wgrad(torch, lhs, dout, sizes)
            n_bytes, bound = k6w_bound(torch, lhs, dout, sizes, g)
            wgrad = lambda: ragged_dot_wgrad(lhs, dout, sizes, g)  # noqa: E731
            split = _backward_split(torch, back, 5)
            if split and dgrad == "tma":
                require(not split["copy_kernels"],
                        f"{label}: the backward ran {split['copy_kernels']} "
                        f"beside K6 and K6w")
            timings[label[4:]] = dict(
                ms=device_ms(torch, wgrad, 10),
                call_ms=call_ms(torch, wgrad, 10),
                path=which, dgrad_path=dgrad,
                simple_ms=device_ms(torch, lambda: _k6w(
                    lhs, dout, sizes, g, "simple"), 3),
                backward_ms=device_ms(torch, back, 5),
                backward_call_ms=call_ms(torch, back, 5),
                backward_split=split, backward_peak_bytes=peak,
                gradient_bytes=grads, bit_equal=bits,
                plain_ms=device_ms(torch, lambda: ragged_dot_wgrad_plain(
                    lhs, dout, sizes, g), 2),
                library_ms=device_ms(torch, lib, 10) if lib else None,
                bytes=n_bytes, bound=bound, max_abs_err=max(e_l, e_r),
                max_abs_err_forward=e_f, max_abs_err_dlhs=e_l,
                max_abs_err_drhs=e_r,
                # [count, largest excess] beyond one bf16 ulp
                beyond_one_bf16_ulp={"dlhs": ulp_l, "drhs": ulp_r},
                shape=dict(m=m, k=k, n=n, g=g, rows=rows,
                           nonempty=int((sizes > 0).sum())),
            )
            if why:
                timings[label[4:]]["library_error"] = why
            print(f"{label}: {json.dumps(timings[label[4:]])}", flush=True)
            del lhs, rhs, sizes, dout, back
            gc.collect()
            torch.cuda.empty_cache()
    print(f"kernels[ragged_dot_wgrad]: K6's backward max abs error "
          f"{err:.3g} over {2 * len(K6W_CASES)} cases", flush=True)
    head = dict(timings[K6W_HEADLINE])
    head["variants"] = {k: v for k, v in timings.items() if k != K6W_HEADLINE}
    return err, head


def _profile_step(torch, fn):
    """(wall ms, device busy ms, device ops) of one call of ``fn`` under the
    profiler (its device events summed: kernels and copies on the step's
    stream); (wall, None, None) where the profiler saw no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("train: the profiler saw no device event", flush=True)
        return wall, None, None
    return wall, sum(e.time_range.elapsed_us() for e in dev) / 1e3, len(dev)


def _leaf_diff(torch, a, b) -> float:
    """Max abs difference over the leaves of two parameter trees."""
    from repro_torch.models.init import flatten_tree

    return max(float((x.float() - y.float().to(x.device)).abs().max())
               for (_, x), (_, y) in zip(flatten_tree(a), flatten_tree(b)))


def run_dense_trainer(torch, device="cuda"):
    """Phase 19b: ``TRAIN_ARCH`` at full width and ``TRAIN_LAYERS`` layers
    (bf16 compute, ``remat="block"``) trains ``TRAIN_STEPS`` steps of
    ``make_train_step(nm=1)`` through ``loop.run`` with an async
    checkpoint at the end (into a temp dir, removed after), on
    ``PackedCorpus`` batches of ``TRAIN_BATCH`` as
    ``src/repro/launch/train.py`` feeds them. Then: an nm=2 step against
    the nm=1 step from the same state (loss and params within the
    reference's ``TRAIN_NM_TOL``), one step under the profiler (the
    device's busy share), the optimizer's ms alone, and
    ``TRAIN_REPEAT`` steps on one batch, whose loss must fall. Reports
    step ms p50 (the first step apart), tokens/s, model FLOP/s against the
    bf16 peak, free disk and checkpoint seconds and bytes, peak memory
    (in all and by part: the loop, the nm check, the profiled step, the
    optimizer alone, the repeated batch).
    Returns the report and the launches (the corpus's index lookups)."""
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import PackedCorpus, PipelineConfig
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.models.init import flatten_tree, unflatten_tree
    from repro_torch.train import (
        AdamWConfig,
        LoopConfig,
        adamw_update,
        init_opt_state,
        make_train_step,
        run,
    )

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    require(cfg.remat == "block" and cfg.compute_dtype == "bfloat16",
            f"train: {cfg.name} trains with remat {cfg.remat} in "
            f"{cfg.compute_dtype}")
    b, s = TRAIN_BATCH
    rep = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "n_params": cfg.n_params(), "batch": [b, s],
           "compute_dtype": cfg.compute_dtype, "remat": cfg.remat}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=device)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    rep["init_s"] = time.perf_counter() - t0
    corpus = PackedCorpus(PipelineConfig(vocab=cfg.vocab, seq_len=s,
                                         global_batch=b, n_docs=2048),
                          device=device)

    def next_batch(step):
        toks = corpus.batch(step)["tokens"].astype(np.int64)
        return {"tokens": torch.as_tensor(toks, device=device)}

    peaks = {}

    def part_peak(part):
        """Record the peak since the last mark as ``part``'s."""
        torch.cuda.synchronize()
        peaks[part] = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()

    ocfg = AdamWConfig(**TRAIN_OCFG)
    step_fn = make_train_step(cfg, ocfg, nm=1)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        rep["disk_free_bytes"] = shutil.disk_usage(ckpt_dir).free
        t0 = time.perf_counter()
        # the loop holds the only reference to the initial state, so each
        # step frees the state before it (as launch/train.py donates it)
        state = [params, opt]
        del params, opt
        res = run(step_fn, state.pop(0), state.pop(0), next_batch, LoopConfig(
            total_steps=TRAIN_STEPS, ckpt_every=TRAIN_STEPS,
            ckpt_dir=ckpt_dir, async_ckpt=True, log_every=TRAIN_STEPS))
        loop_s = time.perf_counter() - t0
        rep["ckpt_bytes"] = sum(f.stat().st_size
                                for f in Path(ckpt_dir).rglob("*.npy"))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps_ms = [t * 1e3 for t in res["step_s"]]
    rep["losses"] = res["losses"]
    rep["step_ms"] = {"first": steps_ms[0],
                      "p50": float(np.median(steps_ms[1:])),
                      "max": float(np.max(steps_ms[1:]))}
    # the snapshot to the host and the final join of the writer
    rep["ckpt_s"] = loop_s - sum(res["step_s"])
    rep["tokens_per_s"] = b * s / rep["step_ms"]["p50"] * 1e3
    require(all(math.isfinite(x) for x in res["losses"]),
            f"train: non-finite loss {res['losses']}")
    params, opt = res["params"], res["opt_state"]
    del res
    part_peak("loop")

    # nm=2 against nm=1 from the same state, on one batch
    b1 = next_batch(TRAIN_STEPS)
    p1, _, l1, _ = step_fn(params, opt, b1)
    p1 = _map_tree(lambda v: v.cpu(), p1)  # off the card for the nm=2 step
    p2, _, l2, _ = make_train_step(cfg, ocfg, nm=2)(params, opt, b1)
    rep["nm2_vs_nm1"] = {"loss_diff": abs(float(l1) - float(l2)),
                         "param_max_abs_diff": _leaf_diff(torch, p2, p1),
                         "tol": TRAIN_NM_TOL}
    del p1, p2
    part_peak("nm_check")
    require(rep["nm2_vs_nm1"]["loss_diff"] < TRAIN_NM_TOL
            and rep["nm2_vs_nm1"]["param_max_abs_diff"] < TRAIN_NM_TOL,
            f"train: the nm=2 step differs from nm=1: {rep['nm2_vs_nm1']}")

    # one step under the profiler, and the optimizer alone
    wall, busy, n_ops = _profile_step(torch, lambda: step_fn(params, opt, b1))
    rep["profiled_step"] = {"wall_ms": wall, "device_busy_ms": busy,
                            "device_ops": n_ops,
                            "busy_share": busy / wall if busy else None}
    part_peak("profiled_step")
    grads = unflatten_tree([(p, torch.randn_like(v) * 1e-3)
                            for p, v in flatten_tree(params)])
    rep["optimizer_ms"] = call_ms(
        torch, lambda: adamw_update(params, grads, opt, ocfg), 2)
    del grads
    part_peak("optimizer")
    n_emb = cfg.vocab * cfg.d_model
    flops = (6 * (cfg.n_params() - n_emb) * b * s
             + 6 * cfg.n_layers * b * s * s * cfg.n_heads * cfg.head_dim)
    rep["model_flops_per_step"] = flops
    rep["model_tflops_per_s"] = flops / rep["step_ms"]["p50"] / 1e9
    rep["mfu_bf16"] = rep["model_tflops_per_s"] * 1e12 / BF16_OPS_PER_S

    # the loss falls on a repeated batch
    losses = []
    for _ in range(TRAIN_REPEAT):
        params, opt, loss, _ = step_fn(params, opt, b1)
        losses.append(float(loss))
    rep["repeated_batch_losses"] = losses
    require(losses[-1] < losses[0],
            f"train: the loss did not fall on a repeated batch: {losses}")
    launches = ops.launch_counts()
    part_peak("repeated_batch")
    rep["peak_bytes_by_part"] = peaks
    rep["peak_bytes"] = max(peaks.values())
    del params, opt, corpus, b1
    gc.collect()
    torch.cuda.empty_cache()
    rep["left_bytes"] = torch.cuda.memory_allocated() - base
    require(rep["left_bytes"] < LM_LEFT_BYTES,
            f"train: {rep['left_bytes']} bytes still allocated")
    rep["card"] = card_line()
    print("train dense " + json.dumps(rep), flush=True)
    return rep, launches


def _expert_grads_check(cfg, grads, routes, shape):
    """Every expert that took a token in a layer (from the forward's
    recorded routes, the first ``n_layers`` router calls, over a batch of
    ``shape``) has a nonzero gradient in each of we1, we2, we3, and every
    other expert exactly zero. A sequence's last token predicts nothing
    (the loss drops its logits) and, the attention being causal, reaches
    no other position, so its picks count as none. Returns the experts
    that took a token, per layer."""
    e, layers = cfg.moe.n_experts, cfg.n_layers
    b, s = shape
    took = np.stack([np.bincount(r.reshape(b, s, -1)[:, :-1].reshape(-1)
                                 .cpu().numpy(), minlength=e)
                     for r in routes[:layers]])
    for w in ("we1", "we2", "we3"):
        g = grads[f"layers/blk0_attn/{w}"]
        per = g.float().abs().amax(dim=(2, 3)).cpu().numpy()  # [L, E]
        require(bool((per[took == 0] == 0).all()),
                f"train moe: an expert without tokens has a {w} gradient")
        require(bool((per[took > 0] > 0).all()),
                f"train moe: an expert with tokens has no {w} gradient")
    return (took > 0).sum(1).tolist()


def _worst_of_leaf_max(paths, got, want):
    """The largest |got - want| over a leaf as a share of the leaf's
    largest |want| (of its largest |got| where want is all zero), and the
    leaf where it is."""
    worst, where = 0.0, None
    for p, a, b in zip(paths, got, want):
        scale = float(b.abs().max())
        rel = (float((a - b).abs().max()) / scale if scale
               else float(a.abs().max()))
        if rel > worst:
            worst, where = rel, "/".join(p)
    return worst, where


def _peak_since(torch, base: int) -> int:
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _train_in_tmp(torch, cfg, restore=True, **kw):
    """``launch.train.train(cfg, **kw)`` into a temp checkpoint dir: (its
    result, whether the checkpoint restored on the card equals the final
    state bit for bit (None where ``restore`` is off), the run's peak
    bytes above the start, the launches, the checkpoint's bytes). The dir
    is removed after."""
    import shutil
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models.init import flatten_tree
    from repro_torch.train import checkpoint as ckpt

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    d = tempfile.mkdtemp(prefix="chip_smoke_launch_")
    try:
        ops.reset_launch_counts()
        res = train(cfg, ckpt_dir=d, **kw)
        launches = ops.launch_counts()
        peak = _peak_since(torch, base)
        step = ckpt.latest_step(d)
        ckpt_bytes = sum(f.stat().st_size for f in Path(d).rglob("*.npy"))
        same = None
        if restore:
            state = (res["params"], res["opt_state"])
            restored, _ = ckpt.restore(d, state)
            same = step == kw["steps"] and all(
                torch.equal(a, b) for (_, a), (_, b)
                in zip(flatten_tree(state), flatten_tree(restored)))
            del restored
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return res, same, peak, launches, ckpt_bytes


def run_moe_trainer(torch, device="cuda"):
    """Phase 19c: ``MOE_TRAIN_ARCH`` at full width and
    ``MOE_TRAIN_LAYERS`` layers with ragged dispatch (K6 forward and data
    gradient, K6w weight gradient) through the train launcher's
    ``train(...)`` (phase 20b's in-process run): ``MOE_TRAIN_STEPS`` steps
    on ``MOE_TRAIN_BATCH`` corpus batches (bf16) with one async checkpoint,
    each step launching K6 and K6w (3 K6w a layer, each on its TMA path,
    and as many data gradients in K6's dgrad mode, with no transposed copy
    of rhs), with each step's ms and peak memory; finite losses, K1 and K2
    (the corpus's index) launched, and the checkpoint restored on the card
    bit for bit. Then, at the trained parameters, a gradient at bf16
    compute on a ``MOE_TRAIN_BATCH`` batch of random tokens (where every
    expert takes tokens) and on its first ``MOE_SHORT_TOKENS`` tokens
    (where some take none): every expert that took a token has a nonzero
    gradient and every other expert exactly zero; one at float32 compute
    against ``dense_chunked`` at a capacity factor where nothing drops
    (``_no_drops``): the same routes, and every leaf within
    ``MOE_GRAD_TOL`` of its largest gradient. Returns the report and the
    launches of the ``train(...)`` run."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.ragged_dot import ragged_dot_wgrad
    from repro_torch.train import grads_of

    full = get_config(MOE_TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    require(cfg.moe.top_k == MOE_TRAIN_TOP_K,
            f"train moe: {cfg.name}'s top-k is {cfg.moe.top_k}, phase 19a "
            f"checks K6 and K6w at top-{MOE_TRAIN_TOP_K}")
    cfg_r = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="ragged"))
    layers = cfg.n_layers
    rep = {"arch": cfg.name, "n_layers": layers, "n_params": cfg.n_params(),
           "dispatch": "ragged", "batch": list(MOE_TRAIN_BATCH),
           "steps": MOE_TRAIN_STEPS, "compute_dtype": cfg.compute_dtype,
           "remat": cfg.remat, "step_reports": []}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()

    def wrap_step(step_fn):
        def step(params, opt, batch):
            before, paths_before = ops.launch_counts(), _k6_paths()
            w_before = dict(ragged_dot_wgrad.launches_by_path)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            out = step_fn(params, opt, batch)
            loss = float(out[2])
            ms = (time.perf_counter() - t0) * 1e3
            now = ops.launch_counts()
            k6 = now["ragged_dot"] - before["ragged_dot"]
            k6w = now["ragged_dot_wgrad"] - before["ragged_dot_wgrad"]
            k6_paths = _k6_paths(paths_before)
            k6w_paths = {p: c - w_before[p] for p, c
                         in ragged_dot_wgrad.launches_by_path.items()}
            rep["step_reports"].append({
                "ms": ms, "loss": loss, "k6": k6, "k6w": k6w,
                "k6_paths": k6_paths, "k6w_paths": k6w_paths,
                "peak_bytes": torch.cuda.max_memory_allocated() - mem0})
            require(math.isfinite(loss) and k6 > 0 and k6w == 3 * layers,
                    f"train moe: a step launched K6 {k6} and K6w {k6w} "
                    f"times (loss {loss})")
            require(k6w_paths["tma"] == k6w and k6_paths["simple"] == 0
                    and k6_paths["tma_dgrad"] == k6w,
                    f"train moe: a step left the TMA paths or copied rhs: "
                    f"K6 {k6_paths}, K6w {k6w_paths}")
            return out
        return step

    res, same, peak, launches, ckpt_bytes = _train_in_tmp(
        torch, cfg_r, steps=MOE_TRAIN_STEPS, batch=MOE_TRAIN_BATCH[0],
        seq=MOE_TRAIN_BATCH[1], device=device, wrap_step=wrap_step)
    steps_ms = [st["ms"] for st in rep["step_reports"]]
    rep.update(losses=res["losses"], step_ms_p50=float(np.median(steps_ms)),
               peak_bytes=peak, ckpt_bytes=ckpt_bytes,
               restore_bit_equal=same,
               launches={k: launches[k] for k in (
                   "fused_locate", "bmat_rank", "ragged_dot",
                   "ragged_dot_wgrad")})
    rep["k6w_paths"] = {p: sum(st["k6w_paths"][p]
                               for st in rep["step_reports"])
                        for p in ragged_dot_wgrad.launches_by_path}
    params = res["params"]
    del res
    gc.collect()
    require(len(steps_ms) == MOE_TRAIN_STEPS
            and all(math.isfinite(x) for x in rep["losses"]),
            f"train moe: {len(steps_ms)} steps, losses {rep['losses']}")
    require(same, "train moe: the checkpoint did not restore bit for bit")
    require(all(c > 0 for c in rep["launches"].values()),
            f"train moe: a kernel did not launch: {rep['launches']}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    toks = np.random.default_rng(5).integers(0, cfg.vocab, MOE_TRAIN_BATCH)
    batch = {"tokens": torch.as_tensor(toks, device=device)}

    def named(paths, grads):
        return {"/".join(p): g for p, g in zip(paths, grads)}

    # a batch where every expert takes tokens, and a short one, where some
    # take none
    short = {"tokens": batch["tokens"][:1, :MOE_SHORT_TOKENS]}
    rep["experts_with_tokens"] = {}
    for name, b in (("batch", batch), ("short", short)):
        with _Routes() as routes:
            _, paths, grads = grads_of(params, cfg_r, b)
        rep["experts_with_tokens"][name] = _expert_grads_check(
            cfg, named(paths, grads), routes.seen, tuple(b["tokens"].shape))
        del grads
    require(min(rep["experts_with_tokens"]["short"]) < cfg.moe.n_experts,
            "train moe: every expert took a token of the short batch")

    c32 = dataclasses.replace(cfg, compute_dtype="float32")
    cfg_r32 = dataclasses.replace(c32, moe=dataclasses.replace(
        c32.moe, dispatch="ragged"))
    cfg_d32 = _no_drops(dataclasses.replace(c32, moe=dataclasses.replace(
        c32.moe, dispatch="dense_chunked")))
    with _Routes() as rr:
        l_r, _, g_r = grads_of(params, cfg_r32, batch)
    with _Routes() as rd:
        l_d, _, g_d = grads_of(params, cfg_d32, batch)
    t = MOE_TRAIN_BATCH[0] * MOE_TRAIN_BATCH[1]
    same_routes = all(torch.equal(a, b) for a, b in zip(rr.seen, rd.seen))
    worst, where = _worst_of_leaf_max(paths, g_r, g_d)
    rep["ragged_vs_dense_f32"] = {
        "capacity_factor": cfg_d32.moe.capacity_factor,
        "dense_drops": _forward_drops(rd.seen[:layers], cfg_d32, t),
        "same_routes": same_routes, "loss_diff": abs(float(l_r - l_d)),
        "max_grad_diff_of_leaf_max": worst, "at": where,
        "tol": MOE_GRAD_TOL}
    del g_r, g_d
    require(rep["ragged_vs_dense_f32"]["dense_drops"] == 0 and same_routes
            and worst <= MOE_GRAD_TOL,
            f"train moe: ragged and dense float32 gradients differ: "
            f"{rep['ragged_vs_dense_f32']}")
    rep["grad_checks_peak_bytes"] = _peak_since(torch, base)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    rep["left_bytes"] = torch.cuda.memory_allocated() - base
    require(rep["left_bytes"] < LM_LEFT_BYTES,
            f"train moe: {rep['left_bytes']} bytes still allocated")
    rep["card"] = card_line()
    print("train moe " + json.dumps(rep), flush=True)
    return rep, launches


def _smoke_batch(torch, cfg, step, device):
    """Phase 19d's batch of ``step``: numpy tokens keyed by the step."""
    toks = np.random.default_rng(2000 + step).integers(0, cfg.vocab, (4, 32))
    return {"tokens": torch.as_tensor(toks, device=device)}


def _smoke_steps(torch, cfg, params, device, n_steps):
    """The first batch's gradients, then ``n_steps`` train steps of
    ``cfg`` (``TRAIN_CPU_OCFG``), from ``params`` copied to ``device``.
    Returns (paths, the gradients on the host, the final params, the
    losses)."""
    from repro_torch.train import (
        AdamWConfig,
        grads_of,
        init_opt_state,
        make_train_step,
    )

    p = _map_tree(lambda v: v.to(device), params)
    _, paths, grads = grads_of(p, cfg, _smoke_batch(torch, cfg, 0, device))
    grads = [g.cpu() for g in grads]
    o = init_opt_state(p)
    step_fn = make_train_step(cfg, AdamWConfig(**TRAIN_CPU_OCFG), nm=1)
    losses = []
    for step in range(n_steps):
        p, o, loss, _ = step_fn(p, o, _smoke_batch(torch, cfg, step, device))
        losses.append(float(loss))
    return paths, grads, p, losses


def _resume_equal(torch, device, deterministic: bool) -> bool:
    """The reference's ``test_resume_after_failure_matches_uninterrupted``
    on ``device``: the smoke ``deepseek-7b`` for ``RESUME_STEPS`` steps
    uninterrupted, and failing at ``RESUME_FAIL`` then resumed from its
    checkpoint; whether the final params and optimizer state are equal bit
    for bit. ``deterministic``: under ``torch.use_deterministic_algorithms``
    (which the script's ``CUBLAS_WORKSPACE_CONFIG`` allows)."""
    import tempfile

    from repro_torch.configs import smoke_config
    from repro_torch.models import init_params
    from repro_torch.train import (
        AdamWConfig,
        LoopConfig,
        SimulatedFailure,
        init_opt_state,
        make_train_step,
        run,
    )
    from repro_torch.models.init import flatten_tree

    cfg = smoke_config("deepseek-7b")
    step_fn = make_train_step(cfg, AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=100), nm=1)

    def fresh():
        p = init_params(cfg, 0, device=device)
        return p, init_opt_state(p)

    def next_batch(step):
        toks = np.random.default_rng(1000 + step).integers(0, cfg.vocab,
                                                           (4, 32))
        return {"tokens": torch.as_tensor(toks, device=device)}

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as d:
            lc = dict(total_steps=RESUME_STEPS, ckpt_every=RESUME_EVERY,
                      log_every=1000)
            a = run(step_fn, *fresh(), next_batch,
                    LoopConfig(ckpt_dir=f"{d}/a", **lc))
            try:
                run(step_fn, *fresh(), next_batch, LoopConfig(
                    ckpt_dir=f"{d}/b", fail_at_step=RESUME_FAIL, **lc))
                require(False, "train resume: the injected failure did not "
                               "happen")
            except SimulatedFailure:
                pass
            b = run(step_fn, *fresh(), next_batch,
                    LoopConfig(ckpt_dir=f"{d}/b", **lc))
    finally:
        torch.use_deterministic_algorithms(was)
    pa = flatten_tree((a["params"], a["opt_state"]))
    pb = flatten_tree((b["params"], b["opt_state"]))
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(pa, pb))


def train_card_vs_cpu(torch, device="cuda"):
    """Phase 19d: at smoke width in float32, ``TRAIN_CPU_STEPS`` train
    steps of each of ``TRAIN_CPU_ARCHS`` (the MoE one with ragged dispatch:
    K6 and K6w) on the card and on the CPU from the same weights: every
    loss within ``TRAIN_CPU_LOSS_TOL`` relative, the first batch's
    gradients leaf by leaf within ``MOE_GRAD_TOL`` of each leaf's largest,
    every parameter within ``TRAIN_CPU_TOL``. Then the smoke ``deepseek-7b``'s
    fail-and-resume on the card, with and without
    ``torch.use_deterministic_algorithms``: both must be bit-equal.
    Returns the report and the launches."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    ops.reset_launch_counts()
    rep = {"tol": TRAIN_CPU_TOL, "loss_tol": TRAIN_CPU_LOSS_TOL,
           "grad_tol": MOE_GRAD_TOL, "steps": TRAIN_CPU_STEPS,
           "ocfg": TRAIN_CPU_OCFG}
    for arch in TRAIN_CPU_ARCHS:
        cfg = dataclasses.replace(smoke_config(arch), compute_dtype="float32")
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, dispatch="ragged"))
        params = init_params(cfg, 0, device="cpu")
        before = ops.launch_counts()
        paths, card_g, card, card_losses = _smoke_steps(
            torch, cfg, params, device, TRAIN_CPU_STEPS)
        now = ops.launch_counts()
        _, host_g, host, host_losses = _smoke_steps(
            torch, cfg, params, "cpu", TRAIN_CPU_STEPS)
        diff = _leaf_diff(torch, card, host)
        loss_rel = max(abs(a - b) / abs(b)
                       for a, b in zip(card_losses, host_losses))
        worst, where = _worst_of_leaf_max(paths, card_g, host_g)
        rep[arch] = {"param_max_abs_diff": diff,
                     "losses": {"card": card_losses, "cpu": host_losses},
                     "loss_max_rel_diff": loss_rel,
                     "grad_max_diff_of_leaf_max": worst, "grad_at": where,
                     "k6": now["ragged_dot"] - before["ragged_dot"],
                     "k6w": now["ragged_dot_wgrad"]
                     - before["ragged_dot_wgrad"]}
        require(diff <= TRAIN_CPU_TOL,
                f"train: card and CPU params differ by {diff} ({arch})")
        require(loss_rel <= TRAIN_CPU_LOSS_TOL,
                f"train: card and CPU losses differ by {loss_rel} relative "
                f"({arch})")
        require(worst <= MOE_GRAD_TOL,
                f"train: card and CPU gradients differ by {worst} of the "
                f"leaf's largest at {where} ({arch})")
        if cfg.moe is not None:
            require(rep[arch]["k6"] > 0 and rep[arch]["k6w"] > 0,
                    f"train: {arch} did not launch K6 and K6w on the card")
    rep["resume_bit_equal"] = {
        "default": _resume_equal(torch, device, False),
        "deterministic_algorithms": _resume_equal(torch, device, True)}
    require(all(rep["resume_bit_equal"].values()),
            f"train: the resumed run is not bit-equal on the card "
            f"({rep['resume_bit_equal']})")
    launches = ops.launch_counts()
    print("train card_vs_cpu " + json.dumps(rep), flush=True)
    return rep, launches


def run_train_path(torch, device="cuda"):
    """Phase 19: 19a holds K6's backward to its plain versions and times
    K6w (``compare_k6w``; its launches are not counted); 19b trains the
    dense model at full width (``run_dense_trainer``); 19c the MoE model
    through the train launcher's ``train(...)``, K6 and K6w
    (``run_moe_trainer``, the ``launch_train`` path); 19d the card against
    the CPU
    and the bit-equal resume (``train_card_vs_cpu``). Returns (reports,
    launches by path, K6w's error and timing)."""
    err, timing = compare_k6w(torch, device)
    dense_rep, dense_launches = run_dense_trainer(torch, device)
    moe_rep, moe_launches = run_moe_trainer(torch, device)
    timing["kernel_paths"] = {"launch_train": moe_rep["k6w_paths"]}
    cpu_rep, cpu_launches = train_card_vs_cpu(torch, device)
    require(moe_launches["ragged_dot_wgrad"] > 0,
            "train: K6w did not launch on the MoE trainer's path")
    return ({"dense": dense_rep, "moe": moe_rep, "card_vs_cpu": cpu_rep},
            {"train_dense": dense_launches, "launch_train": moe_launches,
             "train_card_vs_cpu": cpu_launches}, err, timing)


# ---------------------------------------------------------------------------
# the launchers, compressed_psum and the dry run (phase 20)
# ---------------------------------------------------------------------------


def _launcher(module: str, *args: str) -> str:
    """``python -m <module> <args>`` from the checkout in a process of its
    own (the kernels come from this run's build); its standard output, or
    a failure with its exit code and the end of its output."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=LAUNCH_CLI_TIMEOUT_S)
    require(out.returncode == 0,
            f"launch: {module} exited {out.returncode}: "
            f"{out.stdout[-1500:]} {out.stderr[-1500:]}")
    print(f"launch: {module} {' '.join(args)} ok in "
          f"{time.perf_counter() - t0:.1f} s: "
          f"{' | '.join(out.stdout.strip().splitlines()[-2:])}", flush=True)
    return out.stdout


def launch_serve(torch):
    """Phase 20a: the serve launcher's command line in a process of its own
    (the smoke config, as the reference's), which must exit 0 with a hit;
    then ``serve(get_config(LAUNCH_SERVE_ARCH), **LAUNCH_SERVE)`` at full
    width and depth in this process: every request that hits must give
    its cold tokens on a fresh engine of the same weights, the index must hit
    (every request after the first shares the first's half prompt) and K1
    and K2 must launch. Returns the report and the launches."""
    import re

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    out = _launcher("repro_torch.launch.serve", "--arch", LAUNCH_SERVE_ARCH)
    hits = re.search(r"hits=(\d+) misses=(\d+)", out)
    require(hits is not None and int(hits.group(1)) >= 1,
            f"launch serve: the command line reported no hit: {out[-500:]}")
    rep = {"cli": {"hits": int(hits.group(1)), "misses": int(hits.group(2))}}

    cfg = get_config(LAUNCH_SERVE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, 0)
    ops.reset_launch_counts()
    res = serve(cfg, params=params, **LAUNCH_SERVE)
    launches = ops.launch_counts()
    rep.update(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               seconds=res["seconds"], tokens=res["tokens"],
               tokens_per_s=res["tokens_per_s"], hits=res["hits"],
               misses=res["misses"], peak_bytes=_peak_since(torch, base),
               k1=launches["fused_locate"], k2=launches["bmat_rank"])
    max_len = LAUNCH_SERVE["prompt_len"] + LAUNCH_SERVE["new_tokens"] + 8
    cold_same = []
    for r in res["done"][1:]:  # the first is a miss: cold already
        eng = ServeEngine(cfg, params, max_len=max_len, tuner=None)
        [c] = eng.generate([Request(r.rid, r.prompt, len(r.out))])
        eng.close()
        cold_same.append(c.out == r.out)
    rep["warm_equals_cold"] = cold_same
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    require(all(cold_same), f"launch serve: a request's tokens differ from "
                            f"its cold run: {cold_same}")
    require(rep["hits"] == LAUNCH_SERVE["requests"] - 1,
            f"launch serve: {rep['hits']} hits, {rep['misses']} misses")
    require(rep["k1"] > 0 and rep["k2"] > 0,
            f"launch serve: K1 {rep['k1']} and K2 {rep['k2']} launches")
    return rep, launches


def launch_train(torch):
    """Phase 20b: the train launcher's command line in a process of its
    own (the smoke ``MOE_TRAIN_ARCH``, as the reference's), which must
    exit 0 with a finite loss; ``train(...)`` at full width in this
    process is phase 19c's (``run_moe_trainer``); then one full-width
    ``LAUNCH_RWKV_ARCH`` step through ``train(...)`` (``LAUNCH_RWKV``),
    its step time and peak memory, and the peak of one loss and backward
    (``grads_of``) on the corpus's first batch at the trained parameters,
    with the optimizer's state still allocated (the blocks are
    rematerialized: only one block's time loop keeps its states for the
    backward at a time). Returns the report and the RWKV run's
    launches."""
    import re
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.train import grads_of

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as d:
        out = _launcher("repro_torch.launch.train", "--arch",
                        MOE_TRAIN_ARCH, *LAUNCH_CLI_TRAIN, "--ckpt-dir", d)
    loss = re.search(r"final loss (\S+)", out)
    require(loss is not None and math.isfinite(float(loss.group(1))),
            f"launch train: no finite loss from the command line: "
            f"{out[-500:]}")
    rep = {"cli": {"final_loss": float(loss.group(1))}}

    rcfg = get_config(LAUNCH_RWKV_ARCH)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    res, _, peak, launches, _ = _train_in_tmp(torch, rcfg, restore=False,
                                              **LAUNCH_RWKV)
    batch = {"tokens": torch.as_tensor(res["corpus"].batch(0)["tokens"],
                                       device="cuda")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss_b, _, grads = grads_of(res["params"], rcfg, batch)
    grads_peak = _peak_since(torch, base)
    n = rcfg.n_params()
    rep["rwkv"] = {"arch": rcfg.name, "n_layers": rcfg.n_layers,
                   "n_params": n, "remat": rcfg.remat, **LAUNCH_RWKV,
                   "loss": res["losses"][-1], "loss_backward": float(loss_b),
                   "step_ms": res["step_s"][-1] * 1e3, "peak_bytes": peak,
                   # params, m and v in float32, and the gradients
                   "state_bytes": 3 * 4 * n, "grads_bytes": 4 * n,
                   "loss_backward_peak_bytes": grads_peak}
    rep["rwkv"]["loss_backward_above_state_and_grads_bytes"] = (
        grads_peak - 4 * 4 * n)
    del res, grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    require(math.isfinite(rep["rwkv"]["loss"])
            and math.isfinite(rep["rwkv"]["loss_backward"]),
            f"launch train: the RWKV step failed: {rep['rwkv']}")
    return rep, launches


def launch_psum(torch):
    """Phase 20c: ``compressed_psum`` over a one-rank NCCL group (its store
    a file in a temp dir): bit-equal to ``compress_roundtrip`` on the card
    and to the CPU's ``compress_roundtrip``."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.parallel.compression import (
        compress_roundtrip,
        compressed_psum,
    )

    x = torch.from_numpy(np.random.default_rng(20).normal(
        0, 3, LAUNCH_PSUM_SHAPE).astype(np.float32))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as d:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(d, "store"), 1),
            rank=0, world_size=1, device_id=torch.device("cuda", 0))
        try:
            got = compressed_psum(x.cuda())
            torch.cuda.synchronize()
            rep = {"backend": dist.get_backend(), "shape": list(x.shape),
                   "equals_roundtrip_card": torch.equal(
                       got, compress_roundtrip(x.cuda())),
                   "equals_roundtrip_cpu": torch.equal(
                       got.cpu(), compress_roundtrip(x))}
        finally:
            dist.destroy_process_group()
    require(rep["equals_roundtrip_card"] and rep["equals_roundtrip_cpu"],
            f"launch psum: not bit-equal: {rep}")
    return rep


def launch_dryrun(torch):
    """Phase 20d: ``LAUNCH_DRYRUN_CELLS`` through ``dryrun.run_cell`` on
    the meta device, on one pod (16 x 16), then ``roofline.table`` over
    them; each record's per-device argument bytes beside the card's."""
    import tempfile

    from repro_torch.launch import roofline
    from repro_torch.launch.dryrun import run_cell

    card_bytes = torch.cuda.get_device_properties(0).total_memory
    recs, rep = [], {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
        for arch, shape in LAUNCH_DRYRUN_CELLS:
            t0 = time.perf_counter()
            rec = run_cell(arch, shape, False, "tp_fsdp", "dense", d,
                           "chip_smoke")
            require(rec["status"] == "ok" and rec["flops_per_device"] > 0,
                    f"launch dryrun: {arch} {shape}: "
                    f"{rec.get('error', rec['status'])}")
            args = rec["memory"]["argument_size_in_bytes"]
            rep[f"{arch} {shape}"] = {
                "seconds": time.perf_counter() - t0,
                "flops_per_device": rec["flops_per_device"],
                "argument_gib_per_device": args / 2 ** 30,
                "card_gib": card_bytes / 2 ** 30,
                "fits_card": args < card_bytes}
            recs.append(rec)
    print(roofline.table(recs), flush=True)
    return rep


def run_launch_path(torch):
    """Phase 20: the serve and train launchers (20a, 20b), compressed_psum
    over NCCL (20c) and the dry run with its roofline (20d). Returns the
    report and the launches by path (``launch_serve``,
    ``launch_train_rwkv``; phase 19c's ``train(...)`` run is
    ``launch_train``)."""
    t0 = time.perf_counter()
    serve_rep, serve_launches = launch_serve(torch)
    t1 = time.perf_counter()
    train_rep, train_launches = launch_train(torch)
    t2 = time.perf_counter()
    rep = {"serve": serve_rep, "train": train_rep,
           "psum": launch_psum(torch), "dryrun": launch_dryrun(torch)}
    rep["seconds"] = {"serve": t1 - t0, "train": t2 - t1,
                      "psum_dryrun": time.perf_counter() - t2,
                      "all": time.perf_counter() - t0}
    rep["card"] = card_line()
    print("launch " + json.dumps(rep), flush=True)
    return rep, {"launch_serve": serve_launches,
                 "launch_train_rwkv": train_launches}


# ---------------------------------------------------------------------------
# the standalone BMAT: the paper's Fig. 4 (phase 21)
# ---------------------------------------------------------------------------


def _rank_seconds(torch, b, queries) -> float:
    """Median seconds of ``b.rank(queries)`` over ``BMAT_ITERS`` calls
    after two warm-up calls (``benchmarks/common.time_batches``), the card
    synchronized around each."""
    for _ in range(2):
        b.rank(queries)
    ts = []
    for _ in range(BMAT_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.rank(queries)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _check_bmat_ops(b, keys, vals, queries, label):
    """A delete of ``BMAT_DELETE_FRAC`` of the keys (and of absent keys),
    ``compact``, then ``extract(lo, hi)`` and ``remove_range``, each held
    to a numpy oracle; the ranks stay searchsorted-left throughout."""
    n = len(keys)
    crng = np.random.default_rng(BMAT_SEED + n)
    dead = crng.random(n) < BMAT_DELETE_FRAC
    absent = np.setdiff1d(crng.integers(0, 1 << 52, 256), keys)
    hit = b.delete(np.concatenate([keys[dead], absent]))
    require(hit[: dead.sum()].all() and not hit[dead.sum():].any(),
            f"{label}: delete hit mask")
    require(b.size == n and b.live_size == n - dead.sum(),
            f"{label}: tombstones {b.size} / {b.live_size}")
    require(np.array_equal(b.rank(queries),
                           np.searchsorted(keys, queries, "left")),
            f"{label}: ranks over tombstones")
    b.compact()
    live, live_v = keys[~dead], vals[~dead]
    require(b.size == b.live_size == len(live), f"{label}: compact size")
    f, v = b.lookup(live)
    require(f.all() and np.array_equal(v, live_v), f"{label}: live lookups")
    require(not b.lookup(keys[dead])[0].any(), f"{label}: a deleted key found")
    lo, hi = int(keys[n // 4]), int(keys[n // 2])
    inside = (live >= lo) & (live <= hi)
    ek, ev = b.extract(lo, hi)
    require(np.array_equal(ek, live[inside]) and np.array_equal(ev, live_v[inside]),
            f"{label}: extract(lo, hi)")
    b.remove_range(lo, hi)
    ek, ev = b.extract()
    require(np.array_equal(ek, live[~inside])
            and np.array_equal(ev, live_v[~inside]), f"{label}: remove_range")
    require(np.array_equal(b.rank(queries),
                           np.searchsorted(live[~inside], queries, "left")),
            f"{label}: ranks after remove_range")


def run_bmat_types(torch, device="cuda"):
    """Phase 21: ``benchmarks/bench_bmat_types.run`` on the card. For each
    n of ``BMAT_SIZES`` and both tree types (fanout 16), the bench's keys
    and queries from ``BMAT_SEED``, merged in ``BMAT_CHUNK``-key chunks;
    4096 ranks timed; the state on the card; ranks equal to searchsorted
    before and after ``switch_type``; every merged key found with its
    value; then ``_check_bmat_ops``. Returns the report and the launch
    counts of the phase (the standalone BMAT reaches no kernel, as the
    reference's reaches no Pallas kernel)."""
    from repro_torch.core.bmat import BMAT, BPMAT, RBMAT
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(BMAT_SEED)
    rows = []
    for n in BMAT_SIZES:
        # the bench's draws, in its order
        keys = np.unique(rng.integers(0, 1 << 52, int(n * 1.1)))[:n]
        vals = keys + 1
        stats = {}
        for tname, tt in (("rbmat", RBMAT), ("b+mat", BPMAT)):
            label = f"bmat {tname} n={n}"
            b = BMAT(tt, fanout=BMAT_FANOUT, device=device)
            t0 = time.perf_counter()
            for i in range(0, n, BMAT_CHUNK):
                b.merge(keys[i: i + BMAT_CHUNK], vals[i: i + BMAT_CHUNK])
            torch.cuda.synchronize()
            merge_s = time.perf_counter() - t0
            queries = rng.integers(0, 1 << 52, BMAT_QUERIES).astype(np.int64)
            dt = _rank_seconds(torch, b, queries)
            require(all(t.device.type == torch.device(device).type
                        for t in b.state), f"{label}: state left the card")
            want = np.searchsorted(keys, queries, "left")
            require(np.array_equal(b.rank(queries), want),
                    f"{label}: rank is not searchsorted-left")
            b.switch_type()
            require(np.array_equal(b.rank(queries), want),
                    f"{label}: switch_type changed the ranks")
            b.switch_type()
            f, v = b.lookup(keys)
            require(f.all() and np.array_equal(v, vals),
                    f"{label}: a merged key was not found with its value")
            stats[tname] = {
                "qps": BMAT_QUERIES / dt, "rank_ms": dt * 1e3,
                "mem": b.memory_bytes(modeled=True),
                "device_bytes": b.memory_bytes(), "height": b.height,
                "capacity": b.capacity, "merge_s": merge_s}
            _check_bmat_ops(b, keys, vals, queries, label)
            del b
        rows.append({
            "n": n, **{f"{t}_{k}": v for t, st in stats.items()
                       for k, v in st.items()},
            "rbmat/b+mat perf": stats["rbmat"]["qps"] / stats["b+mat"]["qps"],
            "rbmat/b+mat mem": stats["rbmat"]["mem"] / stats["b+mat"]["mem"]})
    counts = ops.launch_counts()
    rep = {"path": "bmat_types", "fanout": BMAT_FANOUT,
           "queries": BMAT_QUERIES, "rows": rows, "launches": counts,
           "seconds": time.perf_counter() - t_phase, "card": card_line()}
    print("bmat_types " + json.dumps(rep), flush=True)
    return rep, counts


# ---------------------------------------------------------------------------
# the gateway's batch-size-1 baseline and its completion hook (phase 22)
# ---------------------------------------------------------------------------


def _passthrough_client(gw, tid, loaded, fresh, stop, out):
    """One closed-loop client (phase 13's think time): 70% lookups (of the
    loaded keys, and now and then of a key this client inserted), 30%
    inserts of its own fresh keys. Every answer is checked; the futures of
    completed requests are kept for the hook's check."""
    from repro_torch.serve import RetryAfter

    rng = np.random.default_rng(2000 + tid)
    futs, errors, acked = [], [], []
    n_fresh = n_rejected = 0
    while not stop.is_set():
        if rng.random() < 0.70 or n_fresh >= len(fresh):
            if acked and rng.random() < 0.25:
                k = acked[int(rng.integers(len(acked)))]
            else:
                k = int(loaded[rng.integers(len(loaded))])
            kind, want = "lookup", (True, 2 * k + 1)
        else:
            k, kind, want = int(fresh[n_fresh]), "insert", True
            n_fresh += 1
        try:
            fut = (gw.submit_lookup(k) if kind == "lookup"
                   else gw.submit_insert(k, 2 * k + 1))
        except RetryAfter as e:
            n_rejected += 1
            if kind == "insert":
                n_fresh -= 1
            time.sleep(e.retry_after_s)
            continue
        try:
            res = fut.result(30.0)
        except Exception as e:  # noqa: BLE001 — reported as a failure
            errors.append(f"{kind} {k}: {e!r}")
            break
        if res != want:
            errors.append(f"{kind} {k}: {res}, expected {want}")
        futs.append(fut)
        if kind == "insert":
            acked.append(k)
        if len(errors) >= 8:
            break
        time.sleep(rng.exponential(0.0005))
    out[tid] = {"futs": futs, "errors": errors, "acked": acked,
                "rejected": n_rejected}


def _passthrough_keys():
    """``benchmarks/bench_gateway._build_index``'s keys: ``PASS_KEYS`` of
    2^44 from ``PASS_SEED``, sorted."""
    rng = np.random.default_rng(PASS_SEED)
    return np.sort(rng.choice(1 << 44, PASS_KEYS, replace=False)
                   .astype(np.int64))


def _passthrough_index(device):
    """``benchmarks/bench_gateway._build_index``: values 2k+1, 4 shards,
    the BMAT presized."""
    from repro_torch.core import ShardedUpLIF, UpLIFConfig

    keys = _passthrough_keys()
    return ShardedUpLIF(keys, keys * 2 + 1,
                        UpLIFConfig(batch_bucket=256, bmat_capacity=1 << 15),
                        n_shards=N_SHARDS, device=device), keys


def _serve_mode(torch, mode, cfg_kw, fresh, device):
    """One of ``PASS_MODES`` over a fresh index: warmup, then
    ``GATEWAY_CLIENTS`` clients for ``PASS_SECONDS`` with the completion
    hook attached; every check of phase 22. Returns the mode's report and
    its launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.serve import GatewayConfig, RequestGateway

    hooked = []  # (future, done when hooked, its latency then)

    def hook(fut):
        hooked.append((fut, fut.done(), time.perf_counter() - fut.t_submit))

    index, loaded = _passthrough_index(device)
    gw = RequestGateway(index, config=GatewayConfig(on_complete=hook,
                                                    **cfg_kw))
    out = {}
    try:
        gw.warmup()
        torch.cuda.synchronize()
        stop = threading.Event()
        threads = [threading.Thread(
            target=_passthrough_client, daemon=True,
            args=(gw, i, loaded, fresh[i::GATEWAY_CLIENTS], stop, out))
            for i in range(GATEWAY_CLIENTS)]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        time.sleep(PASS_SECONDS)
        stop.set()
        for t in threads:
            t.join(60.0)
        served_s = time.perf_counter() - t0
        require(not any(t.is_alive() for t in threads),
                f"{mode}: a client did not finish")
        gw.close()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        gw.close()
    gst = gw.stats()
    errors = [e for r in out.values() for e in r["errors"]]
    require(len(out) == GATEWAY_CLIENTS, f"{mode}: a client reported nothing")
    require(not errors, f"{mode}: wrong answers: {errors[:4]}")
    require(gw.last_error is None, f"{mode}: a wave failed: {gw.last_error}")
    futs = [f for r in out.values() for f in r["futs"]]
    done = len(futs)
    require(gst["ops"] == done, f"{mode}: {gst['ops']} ops served, "
                                f"{done} completed")
    # the hook: once per completed request, each already done; a rejected
    # request has no future, so the hook can name none
    require(len(hooked) == done
            and {id(h[0]) for h in hooked} == {id(f) for f in futs},
            f"{mode}: {len(hooked)} hook calls for {done} completed requests")
    require(all(h[1] for h in hooked), f"{mode}: hooked before done")
    batches = sum(sum(w.values()) for w in gst["pad_widths"].values())
    if cfg_kw.get("passthrough"):
        # batch size 1: each op kind's batch in a wave is one request (a
        # wave holds at most one lookup and one insert)
        require(gw.cfg.max_batch == 1 and batches == done
                and gst["waves"] <= done <= 2 * gst["waves"],
                f"{mode}: {gst['waves']} waves, {batches} op batches for "
                f"{done} requests")
    for name in ("fused_locate", "bmat_rank"):
        require(counts[name] > 0, f"{mode}: {name} was not launched: {counts}")
    acked = np.concatenate([np.asarray(r["acked"], dtype=np.int64)
                            for r in out.values()])
    probe = np.concatenate([loaded, acked])
    f, v = index.lookup(probe)
    require(f.all() and np.array_equal(v, 2 * probe + 1),
            f"{mode}: a loaded or acknowledged key reads wrong")
    require(index.size == len(probe), f"{mode}: size {index.size}")
    lat = [h[2] for h in hooked]
    rep = {"mode": mode, **cfg_kw,
           "max_batch": gw.cfg.max_batch, "max_delay_s": gw.cfg.max_delay_s,
           "served_s": served_s, "requests": done,
           "requests_per_s": done / served_s, "waves": gst["waves"],
           "op_batches": batches, "mean_batch": done / max(gst["waves"], 1),
           "hook_calls": len(hooked), "hook": _pcts_ms(lat),
           "rejected": sum(r["rejected"] for r in out.values()),
           "gateway_rejected": gst["rejected"], "fresh_acked": len(acked),
           "flush_triggers": gst["flush_triggers"], "launches": counts}
    del index
    return rep, counts


def run_gateway_passthrough(torch, device="cuda"):
    """Phase 22: ``GatewayConfig(passthrough=True, max_pending=2048)``
    beside the batched ``GatewayConfig(max_batch=1024, max_delay_s=0.002)``
    (``benchmarks/bench_gateway.py``'s two modes), each over a fresh
    ``PASS_KEYS``-key router from the same seed with an ``on_complete``
    hook, driven by the same closed-loop clients. Returns the report and
    the launches by path (``gateway_passthrough``, ``gateway_batched``)."""
    rng = np.random.default_rng(PASS_SEED + 1)
    fresh = np.setdiff1d(rng.integers(0, 1 << 44, 800_000),
                         _passthrough_keys())
    fresh = rng.permutation(fresh)
    rep, paths = {}, {}
    for mode, cfg_kw in PASS_MODES.items():
        rep[mode], paths[f"gateway_{mode}"] = _serve_mode(
            torch, mode, cfg_kw, fresh, device)
    rep["card"] = card_line()
    print("gateway_passthrough " + json.dumps(rep), flush=True)
    return rep, paths


# ---------------------------------------------------------------------------
# K7, the window insert, at the read-heavy cell's shape (phase 23)
# ---------------------------------------------------------------------------


def _k7_view(torch, cap: int, seed: int):
    """A slot view of ``cap`` slots with its scratch W-row on the card,
    occupied as a wikits bulk load leaves one (``K7_OCCUPANCY``), the keys
    increasing by gaps of 2 to 2^20 over the occupied slots, every empty
    slot filled forward (KEY_MAX in the tail). Returns (keys, vals, occ,
    the occupied keys)."""
    from repro_torch.core.types import KEY_MAX

    g = torch.Generator(device="cuda").manual_seed(seed)
    occ = torch.rand(cap, generator=g, device="cuda") < K7_OCCUPANCY
    gaps = torch.randint(2, 1 << 20, (cap,), generator=g, device="cuda")
    live = torch.cumsum(torch.where(occ, gaps, 0), 0)
    del gaps
    m = torch.where(occ, live, KEY_MAX)
    keys = torch.flip(torch.cummin(torch.flip(m, [0]), 0).values, [0])
    del m
    vals = torch.where(occ, keys + 1, 0)
    bufs = tuple(torch.cat([a, a[-K7_WINDOW:]]) for a in (keys, vals, occ))
    return (*bufs, live[occ])


def _k7_batches(torch, keys, live, width: int, count: int, seed: int):
    """``count`` insert batches of ``width`` padded keys, the first
    ``K7_PENDING`` fresh (one below a random occupied key), the rest
    KEY_MAX: (keys, vals, j, icap, pending) of each, j from an exact search
    of the view as it stands."""
    from repro_torch.core.types import KEY_MAX

    g = torch.Generator(device="cuda").manual_seed(seed)
    cap = keys.shape[0] - K7_WINDOW
    out = []
    for _ in range(count):
        q = torch.full((width,), KEY_MAX, dtype=torch.int64, device="cuda")
        pick = torch.randint(0, live.shape[0], (K7_PENDING,), generator=g,
                             device="cuda")
        q[:K7_PENDING] = live[pick] - 1
        j = torch.searchsorted(keys[:cap], q, right=True) - 1
        j = torch.clamp(j, max=cap - 1)
        icap = torch.full_like(q, cap - 1)
        out.append((q, q * 2 + 2, j, icap, q != KEY_MAX))
    return out


def run_window_insert(torch):
    """Phase 23: K7 at the read_heavy cell's shape — ``K7_KEYS`` loaded keys
    (a capacity of ``K7_SLOTS_PER_KEY`` slots a key, W 64), ``K7_PENDING``
    fresh keys in a batch of 4096 (the wave) and of 512 (the insert's own
    padded width). Three rounds of the kernel pair and of the plain version
    on copies of one view must leave the same bytes; then device ms per
    call of the pair (and of each launch), the wrapper's call ms between
    CUDA events (the claim array's fill and the dispatch included), the
    plain version's device ms and its call ms, each call on a fresh batch.
    Returns the timing of the 4096-wide batch (the other width under
    ``variants``) and the phase's launches."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.window_insert import (
        window_insert,
        window_insert_plain,
    )

    W = K7_WINDOW
    cap = -(-int(K7_KEYS * K7_SLOTS_PER_KEY) // W) * W
    sk, sv, so, live = _k7_view(torch, cap, K7_SEED)
    kw = dict(cap=cap, total=cap, window=W, movement_k=K7_MOVEMENT_K)

    def counters():
        return (torch.zeros((), dtype=torch.int64, device="cuda"),
                torch.full((), np.iinfo(np.int64).max, dtype=torch.int64,
                           device="cuda"))

    # byte for byte: three rounds each way on copies of the view
    b = _k7_batches(torch, sk, live, K7_WIDTHS[0], 1, K7_SEED + 1)[0]
    res = []
    for fn in (window_insert, window_insert_plain):
        bufs = tuple(a.clone() for a in (sk, sv, so))
        n_placed, min_span = counters()
        pending, oks = b[4].clone(), []
        for _ in range(3):
            ok, span = fn(*bufs, *b[:4], pending, **kw, n_placed=n_placed,
                          min_span=min_span)
            oks += [ok, span]
            pending = pending & ~ok
        res.append([*bufs, *oks, n_placed, min_span])
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(*res))
    require(same, "K7: the kernel pair and its plain version differ")
    placed = int(res[0][-2])
    require(placed > 0, "K7: no key was placed")
    del res

    rows = torch.unique(torch.clamp(torch.minimum(b[2] + 1, b[3]), 0,
                                    cap - 1)[:K7_PENDING] // W).numel()
    ops.reset_launch_counts()
    timing = {}
    for width in K7_WIDTHS:
        # a fresh batch for every call the timing makes, profiler retries
        # included
        n_calls = (2 * (3 + PROFILE_TRIES * K7_ITERS) + 3 + K7_ITERS
                   + 3 + K7_PLAIN_ITERS)
        batches = iter(_k7_batches(torch, sk, live, width, n_calls,
                                   K7_SEED + width))
        n_placed, min_span = counters()

        def kern(fn=window_insert):
            fn(sk, sv, so, *next(batches), **kw, n_placed=n_placed,
               min_span=min_span)

        def plain():
            kern(window_insert_plain)

        # the launches' own device time: the claim array's fill left out
        for _ in range(3):
            kern()
        torch.cuda.synchronize()

        def body():
            for _ in range(K7_ITERS):
                kern()

        dev = _device_events(torch, body)
        if dev is None:
            print("K7 timing: the profiler saw no device event; timed "
                  "between CUDA events", flush=True)
            per_launch = {}
            ms = call_ms(torch, kern, K7_ITERS)
        else:
            per_launch = {
                name: _per_call_ms([e for e in dev if name in e.name],
                                   K7_ITERS)
                for name in ("window_insert_claim", "window_insert_apply")}
            ms = sum(per_launch.values())
        # the batch in (keys, vals, j, icap, pending) and out (ok, span)
        # once, and each accepted row read and written (17 bytes a slot)
        n_bytes = width * (4 * 8 + 1 + 1 + 8) + rows * W * 17 * 2
        timing[width] = dict(
            ms=ms, per_launch_ms=per_launch,
            call_ms=call_ms(torch, kern, K7_ITERS),
            plain_ms=device_ms(torch, plain, K7_PLAIN_ITERS),
            plain_call_ms=call_ms(torch, plain, K7_PLAIN_ITERS),
            library_ms=None, bytes=n_bytes, bound=bound_ms(n_bytes, 0),
            shape=dict(cap=cap, window=W, width=width, pending=K7_PENDING,
                       rows=rows),
        )
        del batches
    launches = ops.launch_counts()
    head = dict(timing[K7_WIDTHS[0]],
                variants={f"width_{w}": timing[w] for w in K7_WIDTHS[1:]})
    print("K7 timing " + json.dumps(dict(head, placed=placed,
                                          card=card_line())), flush=True)
    del sk, sv, so, live
    torch.cuda.empty_cache()
    return head, launches


def _k8_inputs(n: int, seed: int):
    """``n`` sorted wikits keys and the slot positions ``UpLIF``'s bulk
    load gives them with the default (the cells') index."""
    from repro_torch.core import UpLIFConfig
    from repro_torch.core.gmm import init_gmm_uniform
    from repro_torch.core.nullifier import nullify
    from repro_torch.data import make_dataset

    keys = np.unique(make_dataset("wikits", n, seed))
    cfg = UpLIFConfig()
    gmm = init_gmm_uniform(float(keys[0]), float(keys[-1]),
                           cfg.gmm_components)
    res = nullify(keys, keys, gmm, alpha_target=cfg.alpha_target,
                  d_max=cfg.d_max, tail_slack=max(64, cfg.window),
                  align=cfg.window, device="cpu")
    return keys, res.positions, cfg.max_error


def run_spline_corridor(torch, n_keys: int = K8_KEYS, device="cuda"):
    """Phase 24: K8 at the cells' bulk load — ``n_keys`` wikits keys at the
    bulk load's positions. The kernel pair's knots must equal the host
    loop's and the plain version's on the card; then the pair's device ms
    per call (and of each launch), the wrapper's call ms between CUDA
    events (its allocations, the count's read and the int64 copy
    included), ``build_radix_spline``'s seconds on the card (the copies in
    and the host's radix table included), the plain version's and the host
    loop's seconds once, and the divisions the scans made. Returns the
    timing and the phase's launches."""
    from repro_torch.core.radix_spline import (
        _DEF_WINDOW,
        _greedy_spline_knots,
        build_radix_spline,
    )
    from repro_torch.kernels import ops
    from repro_torch.kernels.spline_corridor import (
        next_knots_plain,
        spline_corridor,
        walk_chain,
    )

    keys, positions, max_error = _k8_inputs(n_keys, K8_SEED)
    n = len(keys)
    k = torch.as_tensor(keys, device=device)
    p = torch.as_tensor(positions, device=device)
    ops.reset_launch_counts()
    got = spline_corridor(k, p, max_error, _DEF_WINDOW).cpu().numpy()
    t0 = time.perf_counter()
    nxt = next_knots_plain(k, p, max_error, _DEF_WINDOW)
    plain = walk_chain(nxt, n).cpu().numpy()
    plain_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = _greedy_spline_knots(keys, positions, max_error)
    host_ms = (time.perf_counter() - t0) * 1e3
    require(np.array_equal(got, host),
            "K8: the kernel pair's knots differ from the host loop's")
    require(np.array_equal(plain, host),
            "K8: the plain version's knots differ from the host loop's")
    # each anchor's scan: three divisions a point inside its corridor, one
    # at the point that leaves it (none where the window or the keys end)
    i = torch.arange(n - 1, device=device)
    inside = (nxt - i).sum().item()
    left = (nxt - i < torch.clamp(n - 1 - i, max=_DEF_WINDOW - 1)).sum()
    divisions = 3 * inside + left.item()
    del nxt, i

    def kern():
        spline_corridor(k, p, max_error, _DEF_WINDOW)

    kern()
    torch.cuda.synchronize()

    def body():
        for _ in range(K8_ITERS):
            kern()

    dev = _device_events(torch, body)
    if dev is None:
        print("K8 timing: the profiler saw no device event; timed between "
              "CUDA events", flush=True)
        per_launch = {}
        ms = call_ms(torch, kern, K8_ITERS)
    else:
        per_launch = {
            name: _per_call_ms([e for e in dev if name in e.name], K8_ITERS)
            for name in ("spline_corridor_next", "spline_corridor_chain")}
        ms = sum(per_launch.values())
    builds = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        build_radix_spline(keys, positions, max_error=max_error,
                           device=device)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0) * 1e3)
    n_bytes = 16 * n + 4 * len(host)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_div = divisions * K8_DIV_INSTR / F64_INSTR_PER_S * 1e3
    timing = dict(
        ms=ms, per_launch_ms=per_launch, call_ms=call_ms(torch, kern,
                                                         K8_ITERS),
        plain_ms=plain_ms, host_ms=host_ms, build_ms=builds,
        library_ms=None, bytes=n_bytes,
        bound=(t_div, "fp64 division") if t_div >= t_bytes
        else (t_bytes, "bytes"),
        shape=dict(keys=n, knots=len(host), max_error=max_error,
                   window=_DEF_WINDOW, divisions=divisions,
                   points_a_corridor=inside / (n - 1)),
    )
    launches = ops.launch_counts()
    print("K8 timing " + json.dumps(dict(timing, card=card_line())),
          flush=True)
    del k, p
    torch.cuda.empty_cache()
    return timing, launches


def main() -> int:
    # phase 19d's deterministic resume needs cuBLAS's fixed workspace
    # (the H100's default size), set before the first cuBLAS handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import UpLIF
    from repro_torch.data import WorkloadRunner, make_dataset
    from repro_torch.kernels import build, ops

    t_start = time.perf_counter()
    clock = [t_start]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase seconds: {name} {now - clock[0]:.1f}", flush=True)
        clock[0] = now

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    _, log, secs = build.build()
    build.library()
    print(f"build: {secs:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "error" in line.lower():
            print(f"  ptxas: {line.strip()}", flush=True)

    keys = make_dataset("wikits", N_KEYS)
    runner = WorkloadRunner(keys, init_frac=0.5, batch=BATCH, seed=0)
    t0 = time.perf_counter()
    index = UpLIF(runner.init_keys, runner.init_keys + 1)
    torch.cuda.synchronize()
    print(f"bulk load: {len(runner.init_keys)} keys in "
          f"{time.perf_counter() - t0:.1f} s, capacity {index.capacity}, "
          f"shift {int(index.rs_model.shift)}, knots {index.rs_static.n_spline}, "
          f"rs_iters {index.rs_static.n_search_iters}, "
          f"locate {index.locate_strategy()}", flush=True)
    require(index.locate_strategy() == "fused", "auto did not resolve to fused")
    m = index.rs_model
    require(ops.locate_fusable(index.capacity, m.spline_keys.shape[0]),
            "the main path's index is above the float32 position bound")

    phases, launches, live = run_main_path(torch, index, runner, WAVES,
                                           DELETE_WAVES)
    print(f"main path (single index) launches: {launches}", flush=True)
    tomb = index.bmat.size - int(index._counters.n_bmat_live)
    _, range_launches = run_range_path(torch, index, live, "uplif range",
                                       tombstones=tomb)
    profile_waves(torch, index, runner, rate=0.5, waves=20)
    phase_done("3-4 single index and its ranges")

    router, tuner, r_runner, inserted, r_phases, r_launches = run_router_path(
        torch, keys, ROUTER_WAVES)
    print(f"main path (router + tuner) launches: {r_launches}", flush=True)
    print(f"tuner: {json.dumps(tuner.stats())}", flush=True)
    router_maintenance(torch, router, tuner, r_runner, inserted)
    r_live = check_router_contents(router, r_runner, inserted)
    _, rr_launches = run_range_path(torch, router, r_live, "router range",
                                    boundaries=router.boundaries, tuner=tuner)
    _, w_launches, w_added, w_deleted = run_mixed_waves(
        torch, router, r_runner, r_live, np.unique(np.concatenate(inserted)),
        MIXED_WAVES)
    check_router_contents(router, r_runner, inserted + w_added, w_deleted)
    k3_batch = r_runner.next_batch(0.5)[1]  # one write-heavy wave's inserts
    profile_waves(torch, router, r_runner, rate=0.5, waves=20, tuner=tuner,
                  label="router")
    fanout_launches = fanout_path(torch)
    fc_launches = forecaster_path(torch, float(keys[0]), float(keys[-1]),
                                  k3_batch)
    phase_done("5-7b router, ranges, waves, fanout, forecaster")

    rng = np.random.default_rng(1)
    errs = [
        compare_index_kernels(torch, index, query_mix(rng, runner.init_keys),
                              "wikits"),
        compare_kernels(torch, *router_kernel_inputs(
            torch, router, query_mix(rng, r_runner.init_keys)),
            f"router, {router.n_shards} shards"),
    ]
    k3_err = compare_k3(torch, tuner.forecaster, k3_batch)
    fb_keys = make_dataset("fb", FB_KEYS)
    fb_runner = WorkloadRunner(fb_keys, init_frac=0.5, batch=BATCH, seed=0)
    fb = UpLIF(fb_runner.init_keys, fb_runner.init_keys + 1)
    require(int(fb.rs_model.shift) == 36, "fb index does not use shift 36")
    fb_live = [fb_runner.init_keys]
    for _ in range(8):  # fill the fb BMAT so K2 has something to rank
        _, ins = fb_runner.next_batch(1.0)
        fb.insert(ins, ins + 1)
        fb_live.append(ins)
    fb_live = np.unique(np.concatenate(fb_live))
    errs.append(compare_index_kernels(
        torch, fb, query_mix(rng, fb_runner.init_keys), "fb"))

    require(int(index.rs_model.shift) < 32, "wikits index shift is not < 32")
    api = [run_kernel_api(torch, index, live, "wikits", 11),
           run_kernel_api(torch, fb, fb_live, "fb", 12)]
    api_launches = {k: sum(a[2][k] for a in api) for k in api[0][2]}
    k4_timing, k5_timing, _ = api_timing(torch, index, fb, live, fb_live)
    del fb
    errs.append(large_index(torch, keys))

    card_vs_cpu(torch)
    router_card_vs_cpu(torch)
    phase_done("8-11 kernels, kernel API, large index, card against CPU")

    # a main-path batch: one mixed wave's reads and insert keys
    batch = np.concatenate(runner.next_batch(0.5))
    errs.append(compare_index_kernels(torch, index, batch,
                                      "wikits main-path batch"))
    wide_err, wide_k2 = wide_fanout_k2(torch, index, batch)
    errs.append((0, wide_err))
    timing = kernel_timing(torch, index, batch)
    timing["bmat_rank"]["variants"] = wide_k2
    timing["gmm_estep"] = k3_timing(torch, tuner.forecaster, k3_batch)
    timing["tile_search"] = dict(
        k4_timing, variants={"tiled_rank_one_pass": k4_timing.pop("rank_pass")})
    timing["spline_lookup"] = dict(
        k5_timing["wikits"], variants={"fb_shift_36": k5_timing["fb"]})
    phase_done("12 timing")

    # the front end, async maintenance, agent, baselines and pipeline; after
    # the timing, whose single index the agent retrains
    loaded, unloaded = runner.init_keys, runner.insert_keys
    _, g_launches = run_gateway_path(torch, loaded, unloaded)
    _, a_launches = run_async_path(torch, loaded, unloaded)
    _, ag_launches = run_agent_path(torch, index, runner, live)
    _, b_launches = run_baselines(torch, loaded[::BASELINE_EVERY], unloaded)
    _, p_launches = run_pipeline(torch)
    phase_done("13-15 gateway, async, agent, baselines, pipeline")
    _, lm_launches = run_lm_serve_path(torch, get_config(LM_ARCH))
    phase_done("16 LM serving")
    _, moe_launches, k6_err, k6_timing = run_moe_path(torch)
    phase_done("17 MoE")
    _, rec_launches = run_recurrent_path(torch)
    run_encdec_path(torch)
    phase_done("18 recurrent, encoder-decoder")
    _, train_launches, k6w_err, k6w_timing = run_train_path(torch)
    phase_done("19 training")
    _, launch_launches = run_launch_path(torch)
    phase_done("20 launchers")
    _, bmat_launches = run_bmat_types(torch)
    phase_done("21 BMAT types")
    _, pass_launches = run_gateway_passthrough(torch)
    phase_done("22 gateway passthrough")
    timing["window_insert"], k7_launches = run_window_insert(torch)
    phase_done("23 window insert")
    timing["spline_corridor"], k8_launches = run_spline_corridor(torch)
    phase_done("24 spline corridor")
    timing["ragged_dot"] = k6_timing
    timing["ragged_dot_wgrad"] = k6w_timing
    print(f"K3 timing: N={timing['gmm_estep']['n']} K="
          f"{timing['gmm_estep']['k']}, the forecaster's whole E-step "
          f"{timing['gmm_estep']['forecaster_estep_ms']:.4f} ms", flush=True)
    meta = {
        "fused_locate": (K1_SOURCE, K1_REPLACES, max(e[0] for e in errs)),
        "bmat_rank": (K2_SOURCE, K2_REPLACES, max(e[1] for e in errs)),
        "gmm_estep": (K3_SOURCE, K3_REPLACES, k3_err),
        "tile_search": (K4_SOURCE, K4_REPLACES, max(a[0] for a in api)),
        "spline_lookup": (K5_SOURCE, K5_REPLACES, max(a[1] for a in api)),
        "ragged_dot": (K6_SOURCE, K6_REPLACES, k6_err),
        "ragged_dot_wgrad": (K6W_SOURCE, K6W_REPLACES, k6w_err),
        # byte for byte, or run_window_insert raises
        "window_insert": (K7_SOURCE, K7_REPLACES, 0),
        # knot for knot, or run_spline_corridor raises
        "spline_corridor": (K8_SOURCE, K8_REPLACES, 0),
    }
    paths = {"uplif": launches, "router": r_launches,
             "uplif_range": range_launches, "router_range": rr_launches,
             "router_waves": w_launches, "kernel_api": api_launches,
             "uplif_fanout128": fanout_launches,
             "forecaster_k16": fc_launches, "gateway": g_launches,
             "async_maintenance": a_launches, "agent": ag_launches,
             "baselines": b_launches, "pipeline": p_launches,
             "lm_serve": lm_launches, **moe_launches, **rec_launches,
             **train_launches, **launch_launches,
             "bmat_types": bmat_launches, **pass_launches,
             "window_insert": k7_launches, "spline_corridor": k8_launches}
    kernels = []
    for name, t in timing.items():
        source, replaces, err = meta[name]
        by_path = {path: c[name] for path, c in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": err, "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_bytes": t["bytes"],
            "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
            "library_ms": t["library_ms"],
            **{k: t[k] for k in ("warm_ms", "library_warm_ms", "cold_ms",
                                 "library_cold_ms", "library_error", "shape",
                                 "path", "kernel_paths", "variants",
                                 "per_launch_ms", "plain_call_ms",
                                 "host_ms", "build_ms")
               if k in t},
        })
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
