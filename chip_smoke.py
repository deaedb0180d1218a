#!/usr/bin/env python3
"""Smoke run of the PyTorch port of the R2E-VID router on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR] [--only PHASE,...]

Phases, one JSON line each; any failure exits non-zero:

1. ``device``    the card (``torch.cuda``) and its name and power limit
                 (``nvidia-smi``); no CUDA means exit 1 with no result.
2. ``build``     nvcc builds ``src/repro_torch/kernels/csrc/*.cu`` into
                 ``build/repro_torch_kernels/`` (or loads the built library).
3. ``kernels``   every kernel against its plain PyTorch version on the card,
                 at the paths' shapes (M = 4096) and at a ragged M = 4093:
                 gate_cell within 1e-5; gate_cell_bwd (the cell's VJP, the
                 finetune's gradient) at B = 4096 and 37, d = 35, with
                 nonzero dh_new, dτ and dg_mean, every gradient within 1e-5
                 of max(1, its largest |entry|) and two launches bit-equal;
                 ccg_solve, c6_tail, lpt_queue (on
                 all-edge routes, the main path's, and also on all-cloud
                 and mixed routes and with a server down; timed on the
                 main path's routes and on mixed ones, and at M = 65,536,
                 past one block's shared memory, where the walk reads its
                 tasks in chunks, exact on both routes),
                 ccg_encode (also with a real availability mask) and
                 ccg_master (also on slabs with ties, empty scenario rows
                 and all-infeasible rows) exact, ccg_master timed at the
                 first step of a warm solve and summed over the steps of
                 one (``ms_per_warm_solve``, its bound from all their
                 masks); decode_attention and
                 flash_attention at the dispatch path's shapes for both tier
                 models (slab of 16 × 144 entries at ragged lengths 1..144;
                 prefills of B ∈ {1, 2, 4, 8} × 16..80 tokens) and at ragged,
                 windowed and non-causal shapes, and at RecurrentGemma's
                 (MQA with G = 16, D = 256, a slab of 16 × 80 entries,
                 window 2048), at the MoE and front-end models' (Moonshot
                 G = 1, D = 128; Mixtral G = 6, window 4096, a slab of
                 16 × 80; Qwen2-VL G = 6; MusicGen D = 64), and at the serve
                 launcher's SMOKE tiers (head dims 16 and 8), flash_attention
                 also at runtime positions (Qwen2-VL's image-grid layout and
                 shuffled ones, with and without a window; positions
                 0..S-1 bit-equal to the index launch), within
                 2e-2 + 2e-2·|plain| in bf16 and
                 2e-5 + 2e-5·|plain| in float32; mamba_scan and rglru_scan
                 at the recurrent pools' decode step (16 rows) and longest
                 prefill (8 × 80) and at ragged shapes, x in bf16 and
                 float32, h0 given, None and aliasing h_out, within
                 1e-5 + 1e-5·|plain|; flash_attention_bwd (the backward
                 kernel of training) at Qwen1.5-0.5B's training shape (B 8,
                 S 512, H = KV 16, D 64), Qwen3-8B's GQA, D = 256 with a
                 window, Qwen2-VL's positions and a non-causal case, bf16
                 and float32, dq, dk and dv within 2e-2 (bf16) and 1e-5
                 (float32) of max(1, each gradient's largest |entry|) of
                 attention_vjp_ref, two launches bit-equal, the given LSE
                 and the wrapper's own bit-equal, the forward's training
                 launch's output bit-equal to the serving launch's, each
                 case's design (tensor cores or CUDA cores) named; timed
                 beside autograd through SDPA and beside its first design
                 (bf16 on the CUDA cores, built from the same source beside
                 the library), the forward kernel's time plus the
                 backward's beside SDPA's; mamba_scan_bwd and
                 rglru_scan_bwd (the scans' backward kernels of training)
                 at Falcon-Mamba-7B's and RecurrentGemma-9B's training
                 shapes (8 × 512, bf16 x, no h0, as the models call them)
                 and at ragged shapes with h0 and a final-state cotangent
                 in both dtypes (RG-LRU with lanes where its clamp holds),
                 every gradient within 1e-5 of its largest |entry| of the
                 plain VJP (bf16 ones also within one bf16 rounding), two
                 launches bit-equal, the selective scan's training launch
                 bit-equal to its serving launch and the backward's
                 recomputed final state to its h; kernel, plain and library times (CUDA
                 events or the profiler, median after warm-up; SDPA's
                 device time beside its event time) and each kernel's
                 bound: the larger of its bytes and its compute, where
                 exponentials and square roots may be split between the
                 special-function units and polynomials on the CUDA cores,
                 and for lpt_queue, ccg_solve and c6_repair the serial
                 chain of the walk, of the CCG steps' dependent reductions
                 or of the repair's rounds; c6_repair (the whole C6 repair
                 in one launch) at the main path's round-0 inputs and in a
                 case that demotes in >= 2 rounds, held to its plain
                 version (r, p equal outside the boundary exemption, the
                 draw history within 1e-6), and above its one-block cap
                 on the demoting case tiled to M = 20,000 (the cluster's
                 last block partial), 53,248 and 262,144, where one launch
                 of the cluster kernel runs every round (held to the plain
                 version the same way; on the demoting case and the main
                 path's round tiled, 100 more launches bit-equal to the
                 first and 5 runs of the plain repair on the card
                 bit-equal, each side's count of runs that differ
                 recorded; the plain repair's prefix_sum at 262,144 the
                 same bits on 100 calls, and torch.cumsum's differing
                 calls recorded), and to 262,145, past the cluster's cap, where
                 it takes the per-round path: one c6_tail launch a round,
                 counted, equal to the plain version; the cluster kernel
                 and the per-round path timed in turns at 53,248 and
                 262,144 on that case and on the main path's round tiled
                 (no feasible demotion: one round runs) — the c6_tail
                 row's ``earlier_ms`` and ``cluster_repair``.
4. ``main_path`` ``make_policy("r2evid") → ServeSession.run`` on M = 4096
                 streams for R = 16 rounds of a seeded ``sample_stream``, with
                 random seeded gate weights, launch counters zeroed just
                 before and read just after (gate_cell, ccg_solve,
                 c6_repair and lpt_queue once a round, no c6_tail): the
                 session captures its round as a CUDA graph (the first
                 round is the warm-up) and replays it; the same round
                 function run uncaptured (``capture=False``) must give the
                 same bits, and one of its rounds runs under
                 ``set_sync_debug_mode("error")``;
                 then the same run on the plain
                 versions (``force="ref"``) on the card, whose decisions must
                 agree on >= 99.9% of lane-rounds; then rounds/s and
                 segments/s, captured and eager in turns on reused
                 sessions (median of three), each with a profiled run
                 (device busy time, activities, and the profiler's count
                 of each ported kernel, which must equal the wrappers'
                 count of that same run; a trace that lost its last
                 rounds is taken again, at most three times, every
                 attempt kept), the profiler's window held open 20 ms on
                 each side of the run.
5. ``trace``     one profiled run of the captured main path: device busy
                 time and idle share per round, device activities and
                 host<->device copies per round, the costliest device
                 activities.
6. ``solve_ccg`` the unrolled CCG solver at M = 4096 on round 0 of the
                 stream, cold and warm-started from Stage 1: on the kernels
                 (launch counters zeroed just before and read just after:
                 ccg_encode 1, ccg_master 8 per solve), on the plain
                 versions with the running-η master, and as the fused
                 ``solve_ccg_fused`` on the ccg_solve kernel; the three must
                 agree on route/r/p/v/iters/infeasible on every lane.  The
                 warm solve is also profiled: device busy time, device
                 activities and each kernel's device time a solve.
7. ``policies``  the paper's method comparison: a2_cloud_only, jcab, rdap,
                 sniper, r2evid in τ-proxy mode and its no-Stage-1 and
                 no-Stage-2 ablations through ``ServeSession.run`` on the
                 main path's stream (M = 4096, R = 16, no motion features):
                 launch counts, the captured run bit-equal to the
                 uncaptured one, an uncaptured round under the sync debug
                 mode, rounds/s and a
                 profiled run, captured and eager in turns as in
                 ``main_path``, and ``Simulator.aggregate``'s paper
                 scalars; the τ-proxy run also on the plain versions, with
                 bit-equal decisions.
8. ``decide``    the decide-only paths at M = 4096 on the main path's
                 stream and gate weights: ``route_step`` over 8 segments,
                 ``route_scan`` (the same steps in one call), the windowed
                 ``route`` (T = 8),
                 ``ServeSession.route_many`` / ``route`` / ``step``
                 without ``u`` (captured) and ``Simulator.realize`` /
                 ``realize_batch``: launches counted, decisions against
                 the plain versions (the simulator against a CPU simulator
                 of the same seed), captured against uncaptured bit for bit,
                 segments or calls a second in turns.
9. ``finetune``  online gate finetuning: gate-mode R2E-VID with
                 ``FinetuneConfig()`` through ``ServeSession.run`` at the
                 main path's cell (M = 4096, R = 16, its stream and
                 weights): launches counted (gate_cell_bwd once a round,
                 in the graph), captured against uncaptured bit for bit
                 (the tuned parameters too), the rounds before the first
                 update bit-equal to the plain ``run``, the plain versions
                 on the card (decisions >= 99.9% of lane-rounds, tuned
                 parameters within 1e-6), an uncaptured round under the
                 sync debug mode, rounds/s captured and eager with their
                 profiled runs (the profiler's counts against the
                 wrappers'), and in turns beside the plain main path; then
                 ``offline_warmup`` (50 steps, B = 16, T = 12) on segment
                 features of synthetic video, labels the segments' motion
                 level > 0.5, on the kernels (gate_cell and gate_cell_bwd
                 once a step of T) and plain: losses within 1e-5 relative,
                 the loss falling; last, ``python -m
                 repro_torch.launch.serve --rounds 2 --streams 8``
                 (in-process) on the SMOKE pools (head dims 16 and 8,
                 bf16), its launches counted from zero (flash_attention and
                 decode_attention once a call) and every attention call it
                 made held against the plain version on a copy of that
                 call's inputs, within the ``kernels`` phase's tolerances.
10. ``scenarios`` the robustness path (``serving/scenarios.py``): the golden
                 point (``run_suite``'s 5 policies × ``none`` and the 9
                 scenarios of ``SUITE``, 64 streams, 30 rounds, seed 11) on
                 the kernels and on the plain versions, every scalar of
                 ``SCENARIO_GOLDENS.json`` within 2e-3 + 2e-3·|golden| on
                 both, the churn cells' occupancy, queue and drops equal,
                 decisions agreeing on >= 99.9% of lane-rounds; then
                 gate-mode and τ-proxy R2E-VID at M = 4096, R = 30 through
                 each of the 10 scenarios on the kernels, eagerly (each
                 kernel call recorded) and captured (launch counters
                 zeroed just before each run and read just after:
                 gate_cell (gate mode), ccg_solve, c6_repair and lpt_queue
                 once a round, no c6_tail; the two runs equal bit for bit;
                 an uncaptured round under the sync debug mode), rounds/s
                 and a
                 profiled run, captured and eager in turns (device busy
                 time, idle share, activities and copies a round), the rounds
                 whose C6 repair demoted, churn occupancy, queue and drops,
                 cloud share and SLA violations; edge_outage, straggler_tail and flash_churn at
                 R = 12 also on the plain versions (decisions >= 99.9%,
                 churn bookkeeping equal); last, ``ccg_solve`` with the edge
                 tier out and ``c6_repair`` with the churned pool's alive
                 mask, on inputs those runs gave them, held to their plain
                 versions and timed (a second time in their kernel rows).
11. ``sharded`` stream-sharded serving on ``torch.distributed`` at the main
                 path's cell (M = 4096, R = 16, ``bw_scale`` 0.5 on every
                 round, pools 16 edge / 8 cloud): one rank on NCCL in this
                 process, ``run_sharded`` gathered and hierarchical,
                 captured, for gate-mode R2E-VID, rdap, jcab, a2_cloud_only
                 and sniper, each bit-equal to the dense ``run`` (launches
                 counted from zero per run; rounds/s of the two modes and
                 the dense run in turns; collectives and elements a round;
                 R2E-VID's runs profiled); then 4 ranks on the one card over
                 gloo (spawned, uncaptured, each collective staged through
                 the host): the five policies in both modes (gathered:
                 decisions exact, metrics within 1e-5 relative of dense;
                 hierarchical: decisions, τ, accuracy and energy equal to
                 dense, no in-round collective above 4 elements, and
                 R2E-VID's delay and cost within 1e-5 of the same 4-rank run
                 on the plain versions on the CPU, on the rounds whose
                 decisions agree), the ``churn`` trace in both modes (alive,
                 queue, admitted, dropped exact), ``repair_local`` on
                 max-fidelity solutions at M = 4096 (the global draw within
                 the budget, each shard within its target, no task more
                 than one level from the dense repair) and on a skewed
                 case at M = 65,536 (two shards under their fair share keep
                 their draw, the two over it demote to the targets the
                 split grants them), ``run_elastic`` with failures
                 {6: [3], 11: [2]} (4 → 3 → 2 ranks) equal to dense, and
                 the hierarchical run at M = 65,536, R = 4 (16,384 streams
                 a rank, a budget of 2.5 Mbps a stream, C6 held every
                 round; its exchanges beside the gathered mode's at
                 M = 53,248 and at 65,536, each with C6 held every round;
                 the gathered run at 65,536, whose realization walks past
                 one block's LPT tasks and whose repair is one cluster
                 launch a round, equal in its decisions to the dense
                 ``ServeSession.run`` of the same cell); each rank's peak
                 memory.  With two cards or more, also one rank
                 a card on NCCL.  Also ``lpt_queue`` at the whole and the
                 per-shard pools (16 + 8, 8 + 4, 4 + 2) against its plain
                 version, bit for bit.
12. ``dispatch`` the tier pools at full width and depth (Qwen1.5-0.5B edge,
                 Qwen3-8B cloud, bf16, random weights from seeded
                 generators): (a) ``ServeSession.dispatch`` of a gate-mode
                 round over the first 256 streams of the main path's stream,
                 (b) a fixed request set on both tiers at every prompt length
                 16..80; after an untimed warm-up of (b) on both paths, each
                 on the kernels (launch counters zeroed just
                 before and read just after: flash_attention = layers ×
                 prefills, decode_attention = layers × decode steps) and on
                 the plain versions (``force="ref"``, the same weights).
                 Per tier: requests, tokens/s, p50/p99 latency, decoded ids
                 equal wherever the plain path's top-2 logit margin exceeds
                 0.125, the max |Δ| of first-token logits.  Then
                 ``apply_feedback`` and one more routed round on the
                 fed-back observation; last, a decode step and a prefill
                 per tier, timed on both paths in turns (5 calls a window)
                 and profiled, one call each (device busy time, idle share,
                 top device and host costs); ``part_seconds``, where the
                 phase's time went.
13. ``dispatch_recurrent``  the same phase on the sub-quadratic tier pools,
                 after the dense pools are freed: Falcon-Mamba-7B (64 Mamba
                 layers) as the edge tier and RecurrentGemma-9B (26 RG-LRU
                 and 12 local-attention layers) as the cloud tier, full
                 width and depth in bf16; launches: mamba_scan = layers ×
                 (prefills + decode steps), rglru_scan likewise,
                 flash_attention and decode_attention = attention layers ×
                 prefills and × decode steps (each kernel's row splits its
                 launches by the call: ``launches_by_call``).  Its routed
                 round takes the first 64 streams, not 256, and its timed
                 windows 2 calls, not 5: the plain selective scan is a
                 Python loop over the steps of every layer (~1 s for an
                 8 × 80 prefill, ~50 s profiled), and every id flip is
                 replayed on it.
14. ``dispatch_moe`` the same phase with the MoE cloud tier, after the
                 earlier pools are freed: Qwen1.5-0.5B edge, Moonshot-v1-
                 16B-A3B cloud at full width and depth (48 layers, 64
                 experts, top-6, bf16: 56.1 GB of weights, its stacked
                 expert leaves drawn a layer at a time), 64 routed streams,
                 timed windows of 2 calls, its peak device memory; then,
                 Moonshot freed, Mixtral-8x22B at full width and 4 of its 56
                 layers (5.0 GB a layer): one 8 × 80 prefill into the slab
                 and 8 slab decode steps, greedy on the kernels and plain
                 (logits, ids by the margin rule, flash_attention = 4 and
                 decode_attention = 32 launches), its pool calls profiled.
15. ``front_end`` the embedding-input models at full width and depth in
                 bf16: Qwen2-VL-2B (28 layers, M-RoPE) and MusicGen-medium
                 (48 layers), each a prefill of seeded (8, 80, d)
                 embeddings, then 8 decode steps of seeded (8, 1, d) ones;
                 Qwen2-VL's prefill at its own position layout (16 text
                 tokens, a 2 × 4 × 4 patch grid, 32 text tokens: the
                 kernel masks by those positions) and its decode steps at
                 explicit (8, 3, 1) positions, MusicGen's at the default
                 ones; kernels against plain (logits, ids by the margin
                 rule, launches = layers × calls, each flash_attention call
                 held against its plain version with its positions).
16. ``train``    training Qwen1.5-0.5B at full width and depth (24 layers,
                 bf16 compute over float32 masters and AdamW state, remat)
                 through ``Trainer`` on ``TokenPipeline`` batches of 8 × 512:
                 step 1's loss and gradient norm on the kernels against the
                 plain versions on the card (within 1e-2 and 5e-2
                 relative); 10 steps of ``Trainer.run`` with the launch
                 counters zeroed just before and read just after
                 (flash_attention exactly 48 a step: the forward and its
                 recomputation under remat; flash_attention_bwd exactly
                 24), finite losses, each step's wall time, tokens/s, the
                 model-FLOP share of 989 TFLOP/s, the peak device memory,
                 one profiled step (device busy time and idle share, the
                 costliest device activities); a run failing at step 7
                 (``FailureInjector``) after its checkpoint at step 5
                 (under ``build/train_ckpt``, removed after), resumed by a
                 fresh trainer to step 10 within 1e-2 relative of the
                 uninterrupted run's losses; last, decode_attention given
                 an input that needs a gradient must raise.
17. ``train_recurrent`` training the recurrent families at full width on a
                 cut of their layers: Falcon-Mamba-7B at 8 of 64 layers
                 (1.38 B parameters) and RecurrentGemma-9B at 3 of 38, one
                 (rglru, rglru, attn) pattern (1.71 B), bf16 over float32
                 masters, remat, 8 × 512 batches through ``Trainer``: step
                 1's loss and gradient norm on the kernels against the
                 plain scans and VJPs (within 1e-2 and 5e-2 relative); 6
                 steps of ``Trainer.run`` with the launch counters zeroed
                 just before and read just after (a recurrent layer's scan
                 exactly twice a step, its backward kernel once; the
                 attention layer's flash_attention twice and
                 flash_attention_bwd once), finite losses, step ms,
                 tokens/s, peak memory, one profiled step with each
                 kernel's device time.
18. ``train_ranks`` training across ranks: Qwen1.5-0.5B at full size (bf16
                 over float32 masters, remat, 8 × 512 global batches) on
                 a ("data", "model") mesh.  (a) An NCCL world of 1 at
                 mesh (1, 1), in this process, against the one-device
                 ``Trainer`` in turns for 4 steps: losses, every master and
                 moment bit-equal; each step's ms.  (b) Two gloo ranks
                 sharing the card (``run_ranks``) at mesh (2, 1), 4 steps
                 of 4 rows a rank: step 1's loss within 1e-3 relative of
                 (a)'s one-device step, the gaps of steps 2-4; per rank the
                 step ms, tokens/s, peak memory, seconds in collectives and
                 bytes through the host a step, the collectives by kind;
                 each rank writes its blocks at step 2 (under
                 ``build/train_ranks_ckpt``, removed after).  (c) A world
                 of 1 restores that checkpoint: every block of (b)'s step
                 2 bit-equal (digests), then steps 3-4 within 1e-4 of
                 (b)'s losses.  (d) In (b)'s world, ``compressed_allreduce``
                 of a (151936, 1024) leaf bit-equal to the sum of both
                 ranks' codes in rank order, and a 2-stage GPipe pipeline
                 at width 1024, 8 microbatches, within 1e-5 of the
                 sequential loop.  The launch counters are zeroed before
                 each counted run and read after: 48 flash_attention and
                 24 flash_attention_bwd launches a step on every trainer.
                 (e) Two gloo ranks sharing the card at mesh (1, 2),
                 tensor-parallel over "model": Qwen1.5-0.5B as in (b), 4
                 steps of all 8 rows: exactly 48 flash_attention and 24
                 flash_attention_bwd launches a step a rank, every
                 attention call of the path on 8 of the 16 heads, the
                 losses of all 4 steps within 1e-3 relative of (a)'s
                 one-device steps (steps 2-4 hold the split backward);
                 per rank the step ms, peak memory,
                 seconds in collectives and bytes through the host a step,
                 the collectives by kind, the modes the layers ran and the
                 most layers with a gathered copy alive at once (at most
                 one).  (f) The same for Falcon-Mamba-7B at full width, 2
                 of 64 layers, 2 steps: mamba_scan (training launch) 4 and
                 mamba_scan_bwd 2 launches a step a rank, every scan on
                 4096 of the 8192 channels, both steps' losses within 1e-3
                 of the one-device steps on the same cut (run here first).
                 In (e) and (f) the residual between layers is each rank's
                 half of the sequence (the train rules map act_seq_sp onto
                 "model"; every layer records mode ``residual seq`` and
                 remat saves 256 of the 512 rows at its edge).  (e') (e)
                 again for 2 steps with act_seq_sp mapped to None (every
                 layer ``residual whole``): its losses and every block of
                 the masters and moments after step 2 bit-equal (digests)
                 to (e)'s.  In (b), (e), (e') and (f), per rank: the most
                 view-shaped gradient bytes the reducer held at once
                 (``params.VIEW_GRADS``, each layer's reduced inside the
                 backward; at most the largest unit's views), beside all
                 the views' bytes, which a reduce after the whole backward
                 held, and the bytes that remat saved at the layers' edges
                 a step (``model.EDGE_SAVES``).
19. ``serve_ranks`` the prefill and serve steps under the serve rules
                 (``make_prefill_step`` / ``make_serve_step`` with
                 ``rules_for(cfg, mesh, kind)``) on two gloo ranks sharing
                 the card at mesh (1, 2): Qwen3-8B at full width in bf16,
                 8 of its 36 layers, weights from a seed; a prefill of 8
                 prompts of 3000 tokens into a cache of 3016 entries, split
                 by sequence into two ranges of 1508, each row's length
                 then set to 3000, 3000, 2400, 1800, 1508, 1500, 1493 and
                 1000, then 16 decode steps: rows at 3000 and 2400 hold
                 live entries in both ranges, 1508 writes the second range
                 from step 1 (a one-entry range), 1500 crosses into it at
                 step 9 and 1493 at step 16, 1000 never.  The same cut
                 runs first on one device through the kernels, here, with
                 greedy ids, and again in float32 (the same bf16 weights)
                 fed those ids; the ranks take those ids.  Launch counters
                 zeroed before the ranks' run and read after: per rank
                 flash_attention 8 (on 16 of the 32 heads) and
                 decode_attention_partial 8 × 16, each over 1508 entries,
                 and no serving decode_attention launch.  The bound comes
                 from the float32 witness: each step's largest |logit gap|
                 to the one-device run at most √2 times the one-device
                 run's to float32, and its rms gap to float32 at most √2
                 times the one-device run's (bf16 rounding alone puts the
                 one-device run past 2e-2 at small logits); the greedy ids
                 equal wherever the one-device top-2 margin exceeds 0.125,
                 the same bits on both ranks.  Per rank: prefill s, decode
                 ms a step, seconds in collectives, bytes through the host,
                 peak GB.  The kernels phase holds decode_attention_partial
                 (the partial launch: float32 output and each range's
                 log-sum-exp) against its plain version at this shape and
                 at SMOKE ones, empty and one-entry ranges among them (bf16
                 out within 2^-8 of the softmax-weighted mean of |v|, lse
                 within 1e-3), checks that the plain version one entry
                 short fails that bound, and times it with every row's
                 range full beside the library's efficient attention with
                 the log-sum-exp.

The last three lines are the kernels' JSON line, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``.  ``--out DIR`` also
writes the nvcc/ptxas build log and every phase's record there.
``--only`` runs the named phases alone (``device`` and ``build`` always
run; ``gate_cell_bwd``, ``flash_attention_bwd``, ``mamba_scan_bwd`` and
``rglru_scan_bwd`` are those kernel rows alone, to time two checkouts' kernels in turns): a partial run, not the
smoke.
"""
from __future__ import annotations

import argparse
import atexit
import collections
import dataclasses
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
M, M_RAGGED, ROUNDS = 4096, 4093, 16
TRACE_PAD_S = 0.02        # host sleep on each side of a profiled run
# H100 SXM peaks (NVIDIA's data sheet) and the clocks they imply
HBM_BYTES_PER_S = 3.35e12        # device memory
FP32_FLOP_PER_S = 67e12          # float32 outside the tensor cores: 132 SMs ×
                                 # 128 lanes × 2 (multiply-add) × 1.98 GHz
BF16_FLOP_PER_S = 989e12         # dense bf16 on the tensor cores: 132 SMs ×
                                 # 4096 operations a clock × 1.83 GHz
SFU_OP_PER_S = 132 * 16 * 1.98e9  # exp, sqrt, reciprocal on the special
                                  # function units: 16 a clock per SM
SFU_POLY_FLOPS = 8               # float32 operations of one of them on the
                                 # CUDA cores instead: exp2 as a polynomial
                                 # after range reduction (FlashAttention-4),
                                 # sqrt as a bit-level estimate and Newton steps
SM_CLOCK_HZ = 1.98e9             # the boost clock the peaks above assume
CHAIN_CLOCKS = 4                 # latency of one dependent float32 operation
SLOTS, SLAB = 16, 80 + 64        # the dispatch slab: slots × cache entries
PROMPTS = (16, 32, 48, 64, 80)   # prompt lengths 16·(1 + r)
LOGIT_MARGIN = 0.125             # bf16 greedy-id comparison margin
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # atol = rtol
SCAN_TOL = 1e-5                  # atol = rtol, the scans (float32 outputs)
PORTED_MODEL_KERNELS = ("flash_attention_kernel", "decode_attention_kernel",
                        "mamba_scan_kernel", "rglru_scan_kernel",
                        # the backward kernels of training (the scans'
                        # second pass is fixed_sum.cuh's sum_leading_kernel)
                        "fa_bwd_dq_kernel", "fa_bwd_dkv_kernel",
                        "mamba_scan_bwd_kernel", "rglru_scan_bwd_kernel",
                        "sum_leading_kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms_turns(torch, fns: dict, reps: int, warmup: int = 2) -> dict:
    """Median CUDA-event time of one call of each of ``fns`` (stream time,
    wrapper included), the calls taken in turns (a, b, a, b, ...) so that a
    drift of the host's speed reaches them alike."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(t) for name, t in times.items()}


def event_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of one call (stream time, wrapper included)."""
    return event_ms_turns(torch, {"fn": fn}, reps, warmup)["fn"]


def device_ms(torch, fn, symbol=None, reps: int = 20):
    """Mean device time of the kernel named ``symbol`` per launch or, with
    no symbol, of every device activity of ``fn`` per call (a library call
    that runs several kernels), from the profiler's CUPTI trace; None when
    the trace shows no device time.  A call's time is the sum, over the
    activities, of each one's mean per event times its events per call
    (its count over ``reps``, rounded): a trace that drops events (it now
    and then does) then leaves the mean as it is and does not shrink it.
    Without a symbol, a trace whose counts are not whole multiples of
    ``reps`` is taken again, up to three times in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    found = None
    for _ in range(3):   # a trace now and then comes back without them
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total, count, whole = 0.0, 0, True
        for evt in prof.key_averages():
            if symbol is None and evt.device_type == DeviceType.CUDA \
                    or symbol is not None and symbol in evt.key:
                t = getattr(evt, "self_device_time_total", 0.0)
                if symbol is None and evt.count:
                    whole &= evt.count % reps == 0
                    t *= max(1, round(evt.count / reps)) / evt.count
                total += t
                count += evt.count
        if count and total > 0:
            found = total / 1e3 / (count if symbol is not None else 1)
            if whole:
                return found
    return found


def compute_ms(flops: float, flop_per_s: float = FP32_FLOP_PER_S,
               sfu_ops: float = 0.0):
    """The least compute time (ms) of ``flops`` operations at ``flop_per_s``
    and ``sfu_ops`` exponentials and square roots (given only beside float32
    operations), and which pipe sets it.  "operations" when the CUDA cores
    take longer than the SFUs would for all of ``sfu_ops``; else "sfu": the
    best split of them between the SFUs and polynomials on the CUDA cores,
    where both pipes finish at once."""
    t_ops = flops / flop_per_s * 1e3
    if sfu_ops / SFU_OP_PER_S * 1e3 <= t_ops:
        return t_ops, "operations"
    # x moved to the cores: (sfu_ops - x) / sfu rate = (flops + c·x) / fp32 rate
    return ((flops + SFU_POLY_FLOPS * sfu_ops)
            / (FP32_FLOP_PER_S + SFU_POLY_FLOPS * SFU_OP_PER_S) * 1e3, "sfu")


def bound(nbytes: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S,
          sfu_ops: float = 0.0, chain_ms: float = 0.0):
    """The least time (ms) the card could take: the largest of the bytes
    over the memory rate, ``compute_ms`` and ``chain_ms`` (a serial chain of
    dependent operations, see ``lpt_chain_ms`` and ``ccg_chain_ms``); and
    which term it is ("bytes", "operations", "sfu" or "chain")."""
    terms = [(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"),
             compute_ms(flops, flop_per_s, sfu_ops), (chain_ms, "chain")]
    return max(terms, key=lambda term: term[0])


def lpt_chain_ms(route, n_edge: int, n_cloud: int) -> float:
    """The least time (ms) of LPT packing's serial walk over one round.  A
    task depends on every earlier task of its own tier and on none of the
    other tier's, so the two tiers' chains can run side by side and the
    longer one sets the time.  A step is one add on a single server; on
    more servers, kept sorted by (load, index), the add, the compare of the
    sum with the second-least load and the select of the next least load:
    1 or 3 dependent operations of ``CHAIN_CLOCKS`` clocks each at
    ``SM_CLOCK_HZ``, counted over this round's routes (0 edge, else
    cloud)."""
    n_cloud_tasks = float((route != 0).sum())
    n_edge_tasks = float(route.numel()) - n_cloud_tasks
    ops = max(n_tasks * (1 if n == 1 else 3) for n_tasks, n in
              ((n_edge_tasks, n_edge), (n_cloud_tasks, n_cloud)))
    return ops * CHAIN_CLOCKS / SM_CLOCK_HZ * 1e3


def ccg_chain_ms(iters: int, n_opts: int, n_poles: int,
                 n_versions: int) -> float:
    """The least time (ms) of the CCG solve's serial chain.  Tasks run side
    by side, so the run's largest iteration count ``iters`` sets it.  A
    step is the master's argmin over the options (⌈log₂F⌉ compare-select
    levels), then the worst pole over the poles (⌈log₂P⌉), then the bound
    update (1); before the steps the encode's reduction over the options
    (⌈log₂F⌉), after them the epilogue's worst pole and v* over the
    versions (⌈log₂P⌉ + ⌈log₂K⌉); ``CHAIN_CLOCKS`` clocks a level at
    ``SM_CLOCK_HZ``."""
    def levels(n):
        return math.ceil(math.log2(n)) if n > 1 else 0

    f, p, k = levels(n_opts), levels(n_poles), levels(n_versions)
    ops = iters * (f + p + 1) + f + p + k
    return ops * CHAIN_CLOCKS / SM_CLOCK_HZ * 1e3


REPAIR_THREADS = 1024             # c6_repair's one block
CLUSTER_M = 53248                 # the gathered sharded run's M: a cluster
CLUSTER_PARTIAL_M = 20000         # a cluster whose last block is partial
REPEAT_LAUNCHES = 100             # cluster launches held to the first
REPEAT_PLAIN = 5                  # plain repairs on the card held to the first


def c6_repair_chain_ms(m: int, rounds_run: int, sorted_counts,
                       blocks: int = 1) -> float:
    """The least time (ms) of the C6 repair's serial chain, ``m`` tasks a
    block.  The rounds depend on each other.  A round run is one pass of
    ⌈m/1024⌉ dependent adds per thread, then the block sum's two 5-level
    butterflies (and on a cluster of ``blocks`` the B − 1 adds of the
    blocks' sums); a round that demotes (``sorted_counts``: the keys a
    block sorts, n each) adds the bitonic network over the next power of
    two (s(s + 1)/2 compare-exchange levels for 2^s keys), the chunk sums
    of ⌈n/1024⌉ adds, the scan's two 5-level Kogge–Stone passes and the
    running sum down the chunk again (and on a cluster, per key the B − 1
    adds of the other blocks' prefixes, whose ranks take at least one
    read); ``CHAIN_CLOCKS`` clocks a level at ``SM_CLOCK_HZ``."""
    ops = rounds_run * (math.ceil(m / REPAIR_THREADS) + 10 + blocks - 1)
    for n in sorted_counts:
        s = math.ceil(math.log2(n)) if n > 1 else 0
        per = math.ceil(n / REPAIR_THREADS)
        ops += s * (s + 1) // 2 + 2 * per + 10 + per * (blocks - 1)
    return ops * CHAIN_CLOCKS / SM_CLOCK_HZ * 1e3


def c6_repair_work(torch, args, budget, rounds: int, n_fps: int):
    """What one repair on ``args`` needs, from the plain version's rounds:
    (bytes, operations, rounds run, the keys each demoting round sorts).
    Bytes: the lane inputs (r, p, v, route as int64, z and the threshold)
    read once, r and p written as int64, the history, the coordinate
    vectors, each task's current panel entry and each demoted entry.
    Operations: per round run and task the tail (24, as c6_tail's), the
    draw's add and the key (2); per demoting round the sort's
    compare-exchanges (2 each) and per key the scan's add, the compare and
    the demotion."""
    from repro_torch.kernels.c6_tail.ref import c6_repair_ref, c6_tail_ref

    panel, r0, p0, v, route, z, thr, rn, pn = args
    m = r0.shape[0]
    sorted_counts, rounds_run = [], 0
    for k in range(rounds):
        r, p, _ = c6_repair_ref(*args, budget, n_fps=n_fps, rounds=k)
        bw, gain, _ = c6_tail_ref(panel, r, p, v, route, z, thr, rn, pn,
                                  n_fps)
        rounds_run += 1
        n_pos = int((gain > 0).sum())
        if not float(bw.sum()) > float(budget) or n_pos == 0:
            break
        sorted_counts.append(n_pos)
    nbytes = (m * (4 * 8 + 2 * 4) + m * 2 * 8 + 4 * rounds
              + 4 * (rn.numel() + pn.numel()) + 4 * (m + sum(sorted_counts)))
    flops = rounds_run * m * (24 + 3)
    for n in sorted_counts:
        s = math.ceil(math.log2(n)) if n > 1 else 0
        flops += 2 * (2 ** s // 2) * (s * (s + 1) // 2) + 3 * n
    return float(nbytes), float(flops), rounds_run, sorted_counts


def master_work(scen_masks, fs_ok):
    """(bytes, operations) of ccg_master launches on the (M, P) scenario
    masks ``scen_masks`` (one a launch) and the (M, F) feasibility
    ``fs_ok``: per launch the recourse of each task's generated poles at
    its feasible options only, the whole mask and feasibility, c1, and y*
    and o_down written; per feasible option the η max over the poles,
    c1 + η and the argmin compare, per option the select."""
    m, f = fs_ok.shape
    n_feas = fs_ok.sum(1).double()
    nbytes = flops = 0.0
    for scen in scen_masks:
        n_poles = scen.sum(1).double()
        nbytes += float(4 * (n_poles * n_feas).sum() + 4 * scen.numel()
                        + m * f + 4 * f + 8 * m)
        flops += float((n_feas * (n_poles + 2)).sum() + m * f)
    return nbytes, flops


def warm_solve_master_inputs(prob, z, aq, warm_y):
    """The (rec_all, scen_mask, fs_ok, c1) of every ccg_master call of one
    solve_ccg (slab master), recorded on the plain versions: the master
    sees the same bits on the kernels."""
    from repro_torch.core import robust

    calls, master = [], robust.ccg_master

    def record(rec_all, scen_mask, fs_ok, c1, force="auto"):
        calls.append((rec_all, scen_mask.clone(), fs_ok, c1))
        return master(rec_all, scen_mask, fs_ok, c1, force=force)

    robust.ccg_master = record
    try:
        robust.solve_ccg(prob, z, aq, warm_y=warm_y, force="ref",
                         slab_master=True)
    finally:
        robust.ccg_master = master
    return calls


def on_host(torch, fn, *args, **kw):
    """``fn`` on CPU copies of its tensor arguments, its results moved back
    to the card: the plain C6 repair that the kernel is compared with, run
    where its float32 prefix sums are sequential.  (A comparison on the
    card once found two whole runs apart and no round of them apart when
    rerun: the plain repair's ``torch.cumsum`` on the card gave other bits
    on other calls.  Its ``prefix_sum`` now repeats; ``repair_repeats``
    holds both sides to their first runs.)"""
    dev = next(a.device for a in (*args, *kw.values()) if torch.is_tensor(a))
    cpu = lambda a: a.cpu() if torch.is_tensor(a) else a
    out = fn(*map(cpu, args), **{k: cpu(v) for k, v in kw.items()})
    return tuple(o.to(dev) for o in out)


def repair_repeats(torch, run_kernel, run_plain, first) -> dict:
    """The C6 repair launched ``REPEAT_LAUNCHES`` more times on the inputs
    of its launch ``first``, each launch's r, p and draw history held
    bit-equal to that one's, and the plain repair run ``REPEAT_PLAIN``
    times on the card, held to its first run: which side, if either, gives
    other bits on another call."""
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    differ = [i + 1 for i in range(REPEAT_LAUNCHES)
              if not same(run_kernel(), first)]
    runs = [run_plain() for _ in range(REPEAT_PLAIN)]
    plain_differ = [i for i, run in enumerate(runs[1:], 1)
                    if not same(run, runs[0])]
    return {"launches_compared": REPEAT_LAUNCHES,
            "launches_differing": len(differ),
            "first_differing_launch": differ[0] if differ else None,
            "plain_on_card_runs": REPEAT_PLAIN,
            "plain_on_card_runs_differing": len(plain_differ),
            "first_differing_plain_run": (plain_differ[0] if plain_differ
                                          else None),
            "plain_on_card_runs_bitequal": not plain_differ}


def max_abs(torch, got, want) -> float:
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def kernel_phase(torch, stream, dev):
    """Each kernel vs its plain version at M and M_RAGGED, plus timings."""
    from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
    from repro_torch.core.gating import GateConfig, init_gate_params
    from repro_torch.core.lattice import BIG
    from repro_torch.core.robust import RobustProblem
    from repro_torch.core.router import stage1_configure
    from repro_torch.kernels.c6_tail.ops import c6_tail
    from repro_torch.kernels.ccg_encode.ops import ccg_encode
    from repro_torch.kernels.ccg_master.ops import ccg_master
    from repro_torch.kernels.ccg_solve.ops import ccg_solve
    from repro_torch.kernels.lpt_queue.ops import lpt_queue
    from repro_torch.kernels.temporal_gate.ops import gate_cell
    from repro_torch.kernels.temporal_gate.ref import pack_weights

    sys_ = SystemConfig()
    prob = RobustProblem.build(sys_, dev)
    lat = prob.lat
    gen = torch.Generator().manual_seed(7)
    gp = init_gate_params(GateConfig(d_feature=35), gen, dev)
    gp = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(dev)
          if k.startswith("b_") else v for k, v in gp.items()}
    f_k, F, K = 5, lat.n_flat, sys_.num_versions
    P = prob.poles.shape[0]
    rn, pn = res_norm(sys_, dev), fps_norm(sys_, dev)

    def rand(shape, lo=0.0, hi=1.0):
        return (torch.rand(shape, generator=gen) * (hi - lo) + lo).to(dev)

    def ints(m, hi):
        return torch.randint(0, hi, (m,), generator=gen,
                             dtype=torch.int32).to(dev)

    enc_kw = dict(margin=sys_.acc_margin_robust, num_versions=K)

    def enc_args(z, aq):
        return (z, aq, lat.rn_flat, lat.pn_flat, lat.tier_flat,
                prob.b2_scaled, prob.rec_table)

    def master_first_step(z, aq):
        """The master's inputs at the first step of a solve warm-started
        from Stage 1: the round's slab, its feasibility, and each task's
        warm pole as its one generated scenario."""
        m = z.shape[0]
        code, rec_all, _ = ccg_encode(*enc_args(z, aq), force="ref",
                                      **enc_kw)
        none = torch.full((m,), -1, dtype=torch.int64, device=dev)
        route, r = stage1_configure(lat, z, z, aq, none, torch.zeros_like(z))
        wy = lat.flatten_index(route, r, sys_.n_fps - 1)
        fs_ok = code > 0
        rec_wy = rec_all.gather(2, wy[:, None, None].expand(-1, P, 1))[..., 0]
        use = fs_ok.gather(1, wy[:, None])[:, 0]
        pole = rec_wy.argmax(1)[:, None]
        scen = ((torch.arange(P, device=dev)[None] == pole)
                & use[:, None]).to(torch.float32)
        return rec_all, scen, fs_ok, lat.c1_flat

    def master_ties(m):
        """A slab on a coarse grid (ties everywhere), with empty scenario
        rows, full ones, all-infeasible rows and BIG recourse entries."""
        rec = (torch.randint(0, 6, (m, P, F), generator=gen) * 0.125)
        rec[torch.rand((m, P, F), generator=gen) < 0.05] = BIG
        scen = (torch.rand((m, P), generator=gen) < 0.3).float()
        scen[::5] = 0.0
        scen[1::7] = 1.0
        fs_ok = torch.rand((m, F), generator=gen) < 0.7
        fs_ok[2::6] = False
        c1 = torch.randint(0, 4, (F,), generator=gen) * 0.25
        return rec.to(dev), scen.to(dev), fs_ok.to(dev), c1.float().to(dev)

    def extra_checks(m):
        z, aq = stream.z[0, :m].contiguous(), stream.aq[0, :m].contiguous()
        cloud_down = (lat.tier_flat < 0.5).to(torch.float32)
        checks = {"ccg_encode": [(ccg_encode, enc_args(z, aq),
                                  dict(enc_kw, y_ok=cloud_down))],
                  "ccg_master": [(ccg_master, master_ties(m), {})]}
        # LPT: mixed routes, all-cloud ones (the a2_cloud_only policy's),
        # and mixed ones with an edge server down
        t_lpt, route = rand((m,), 0.001, 0.5), ints(m, 2)
        edge_down = torch.ones(5, device=dev)
        edge_down[1] = 0.0
        checks["lpt_queue"] = [
            (lpt_queue, (t_lpt, route, 4, 1), {}),
            (lpt_queue, (t_lpt, torch.ones_like(route), 4, 1), {}),
            (lpt_queue, (t_lpt, route, 4, 1), dict(avail=edge_down))]
        return checks

    def cases(m):
        z, aq = stream.z[0, :m].contiguous(), stream.aq[0, :m].contiguous()
        route = ints(m, 2)
        panel = torch.movedim(lat.bw, -1, 0)[route.long()].reshape(m, -1)
        return {
            "gate_cell": (gate_cell, (stream.dx[0, :m].contiguous(),
                                      rand((m, 32), -1, 1), rand((m,), 0, 2),
                                      gp), {}),
            "ccg_solve": (ccg_solve, (
                z, aq, lat.rn_flat, lat.pn_flat, lat.tier_flat, lat.b2_flat,
                prob.u_all, lat.c1_flat,
                torch.randint(-1, F, (m,), generator=gen,
                              dtype=torch.int32).to(dev)),
                dict(margin=sys_.acc_margin_robust, num_versions=K)),
            "c6_tail": (c6_tail, (panel, ints(m, 5), ints(m, 5), ints(m, 5),
                                  route, z, aq + sys_.acc_margin_robust, rn,
                                  pn), dict(n_fps=f_k)),
            # the main path's routes: every task on the edge (ROADMAP C)
            "lpt_queue": (lpt_queue, (rand((m,), 0.001, 0.5),
                                      torch.zeros_like(route), 4, 1), {}),
            "ccg_encode": (ccg_encode, enc_args(z, aq), enc_kw),
            "ccg_master": (ccg_master, master_first_step(z, aq), {}),
        }

    tol = {"gate_cell": 1e-5, "ccg_solve": 0.0, "c6_tail": 0.0,
           "lpt_queue": 0.0, "ccg_encode": 0.0, "ccg_master": 0.0}
    source = {"gate_cell": "temporal_gate.cu", "ccg_solve": "ccg_solve.cu",
              "c6_tail": "c6_tail.cu", "lpt_queue": "lpt_queue.cu",
              "ccg_encode": "ccg_encode.cu", "ccg_master": "ccg_master.cu"}
    replaces = {
        "gate_cell": "src/repro/kernels/temporal_gate/kernel.py:50",
        "ccg_solve": "src/repro/kernels/ccg_solve/kernel.py:168",
        "c6_tail": "src/repro/kernels/c6_tail/kernel.py:69",
        "lpt_queue": "src/repro/serving/simulator.py:70 (not a TPU kernel: "
                     "realization helper)",
        "ccg_encode": "src/repro/kernels/ccg_encode/kernel.py:74",
        "ccg_master": "src/repro/kernels/ccg_master/kernel.py:53",
    }
    symbol = {name: f"{name}_kernel" for name in source}
    plain_reps = {"lpt_queue": 3}
    rows = {}
    main_cases = cases(M)
    ragged_cases = cases(M_RAGGED)
    extra = {m: extra_checks(m) for m in (M, M_RAGGED)}
    for name, (fn, args, kw) in main_cases.items():
        err = 0.0
        checks = [main_cases[name], ragged_cases[name],
                  *extra[M].get(name, []), *extra[M_RAGGED].get(name, [])]
        for fn_, args_, kw_ in checks:
            got = fn_(*args_, force="kernel", **kw_)
            want = fn_(*args_, force="ref", **kw_)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = max(err, max_abs(torch, got, want))
        if not err <= tol[name]:
            raise AssertionError(f"{name}: kernel vs plain max |diff| {err} "
                                 f"> {tol[name]}")
        call = lambda: fn(*args, force="kernel", **kw)
        plain = lambda: fn(*args, force="ref", **kw)
        ms_events = event_ms(torch, call, reps=50)
        ms_dev = device_ms(torch, call, symbol[name])
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source[name]}",
            "replaces": replaces[name], "max_abs_err": err,
            "tolerance": tol[name], "cases_compared": len(checks),
            "ms": ms_dev if ms_dev is not None else ms_events,
            "ms_from": "profiler" if ms_dev is not None else "cuda_events",
            "call_ms": ms_events,
            "plain_ms": event_ms(torch, plain,
                                 reps=plain_reps.get(name, 20), warmup=1),
            "library_ms": None, "library_call": None,
        }

    # bounds from this run's inputs (M = 4096): bytes each input read once
    # and each output written once; operations of an implementation that
    # builds every task-independent table once, all counted at the float32
    # peak outside the tensor cores (compares and integer ops included)
    d, m_h = 35, 32
    w_floats = d * 3 * m_h + 2 * m_h * m_h + m_h * m_h + 4 * m_h + 2
    gate_bytes = 4 * (M * (d + m_h + 1) + M * (m_h + 2) + w_floats)
    gate_flops = M * (2 * (3 * d * m_h + 3 * m_h * m_h + m_h) + 30 * m_h)
    _, args, kw = main_cases["ccg_solve"]
    solved = ccg_solve(*args, force="kernel", **kw)
    steps = float(solved[4].sum())
    max_iters = int(solved[4].max())
    n_infeasible = float(solved[5].sum())
    ccg_chain = ccg_chain_ms(max_iters, F, P, K)
    # ccg_solve.  Tables, once: a_max·sat per (option, version), the pole-
    # scaled costs (P, K, F) and the recourse of every version subset
    # (P, F, 2^K), one min each.  Per task: the threshold and the two z
    # products (3); per option the two z terms (2F); per (option, version)
    # two subtractions, the clamp, the test and the bit (6FK); the worst pole
    # of the warm start and of the epilogue (2P) and v* (K).  Per step: the
    # master's c1 + eta and argmin, the eta max (3F, recourse by lookup), the
    # worst pole (P) and the bound update (5).  The flat accuracy argmax
    # (FK) only on tasks where nothing is feasible.
    ccg_bytes = 4 * (M * 9 + F * 5 + K * F + P * K)
    ccg_flops = (11 * F * K + P * K * F + P * F * 2 ** K
                 + M * (3 + 2 * F + 6 * F * K + 2 * P + K)
                 + steps * (3 * F + P + 5) + n_infeasible * F * K)
    # c6_tail.  Per task: the two clamped indices and the two z products
    # (4); per demotion the (1 − p) and (1 − r) terms, two subtractions, the
    # clamp and the test (7 each; a_max·sat is a (version, tier, resolution)
    # table built once); the guards and their ands (4); the gain and its
    # select (2).  Bytes: six lane inputs, three outputs, the current panel
    # entry, and the demoted entry only where a demotion is feasible.
    _, args, kw = main_cases["c6_tail"]
    n_demote = float((c6_tail(*args, force="kernel", **kw)[1] > -BIG / 2)
                     .sum())
    n_res = sys_.n_res
    c6_bytes = M * (6 * 4 + 3 * 4 + 4) + 4 * n_demote + 4 * (n_res + f_k)
    c6_flops = 11 * K * 2 * n_res + M * (4 + 2 * 7 + 4 + 2)
    # lpt_queue: t, route and the sorted order in, start out; per task the
    # argmin over its tier's servers and one add; and the serial chain.  On
    # the main path's routes, and beside them on mixed ones (both tiers'
    # walks side by side)
    _, (_, r_lpt, n_edge, n_cloud), _ = main_cases["lpt_queue"]
    on_edge = float((r_lpt == 0).sum())
    lpt_bytes = M * (4 + 4 + 8 + 4)
    lpt_flops = on_edge * n_edge + (M - on_edge) * n_cloud
    lpt_chain = lpt_chain_ms(r_lpt, n_edge, n_cloud)
    # ccg_encode: writes the (M, P, F) slab, the (M, F) bitmask and the (M,)
    # argmax; reads z, aq, four (F,) vectors and the (K, P, F) costs.  With
    # a_max·sat per (option, version) and the (P, F, 2^K) subset lookup
    # built once, per task the two z products and their sum per option (3F)
    # and per (option, version) the subtraction, clamp (2), test, bit and
    # argmax compare (6FK); the recourse is a lookup.
    enc_bytes = 4 * (M * P * F + M * F + M + 2 * M + 4 * F + K * P * F)
    enc_flops = (11 * F * K + P * F * 2 ** K + M * (3 * F + 6 * F * K))
    # ccg_master on the first warm step's inputs (master_work)
    _, scen_m, ok_m, _ = main_cases["ccg_master"][1]
    n_poles = scen_m.sum(1).double()
    master_bytes, master_flops = master_work([scen_m], ok_m)
    work = {"gate_cell": (gate_bytes, gate_flops),
            "ccg_solve": (ccg_bytes, ccg_flops),
            "c6_tail": (c6_bytes, c6_flops),
            "lpt_queue": (lpt_bytes, lpt_flops),
            "ccg_encode": (enc_bytes, enc_flops),
            "ccg_master": (master_bytes, master_flops)}
    chains = {"lpt_queue": lpt_chain, "ccg_solve": ccg_chain}
    for name, (nbytes, flops) in work.items():
        rows[name]["bytes"], rows[name]["flops"] = nbytes, flops
        rows[name]["bound_ms"], rows[name]["bound_by"] = bound(
            nbytes, flops, chain_ms=chains.get(name, 0.0))
    rows["lpt_queue"]["bytes_ms"] = lpt_bytes / HBM_BYTES_PER_S * 1e3
    rows["lpt_queue"]["chain_ms"] = lpt_chain
    rows["lpt_queue"]["routes"] = "all edge (the main path's)"
    lpt_fn, mixed_args, mixed_kw = extra[M]["lpt_queue"][0]
    mixed = lambda: lpt_fn(*mixed_args, force="kernel", **mixed_kw)
    rows["lpt_queue"]["mixed_ms"] = device_ms(torch, mixed, symbol["lpt_queue"])
    rows["lpt_queue"]["mixed_chain_ms"] = lpt_chain_ms(mixed_args[1], n_edge,
                                                       n_cloud)
    rows["lpt_queue"]["past_one_block"] = lpt_past_one_block(torch, dev, gen)
    rows["ccg_solve"]["ccg_steps_in_run"] = steps
    rows["ccg_solve"]["max_iters_in_run"] = max_iters
    rows["ccg_solve"]["chain_ms"] = ccg_chain
    rows["ccg_solve"]["operations_ms"] = compute_ms(ccg_flops)[0]
    rows["ccg_solve"]["infeasible_tasks"] = n_infeasible
    rows["c6_tail"]["feasible_demotions"] = n_demote
    rows["ccg_master"]["inputs"] = (
        "first master step of the Stage-1 warm-started solve of round 0")
    rows["ccg_master"]["mean_poles_per_task"] = float(n_poles.mean())
    rows["ccg_master"]["dense_slab_bytes"] = 4 * M * P * F
    # and over the launches of one warm solve of the same round, each on
    # its own step's masks (later steps carry more poles)
    z0, aq0 = stream.z[0].contiguous(), stream.aq[0].contiguous()
    none = torch.full((M,), -1, dtype=torch.int64, device=dev)
    route, r = stage1_configure(lat, z0, z0, aq0, none,
                                torch.zeros_like(z0))
    master_steps = warm_solve_master_inputs(
        prob, z0, aq0, lat.flatten_index(route, r, sys_.n_fps - 1))
    per_step = [device_ms(torch, lambda a=a: ccg_master(*a, force="kernel"),
                          symbol["ccg_master"]) for a in master_steps]
    solve_bytes, solve_flops = master_work([a[1] for a in master_steps],
                                           master_steps[0][2])
    rows["ccg_master"].update({
        "warm_solve_launches": len(master_steps),
        "ms_per_warm_solve": (sum(per_step) if None not in per_step
                              else None),
        "ms_by_step": per_step,
        "mean_poles_per_task_by_step": [float(a[1].sum(1).mean())
                                        for a in master_steps],
        "bytes_per_warm_solve": solve_bytes,
        "flops_per_warm_solve": solve_flops})
    (rows["ccg_master"]["bound_ms_per_warm_solve"],
     rows["ccg_master"]["bound_by_per_warm_solve"]) = bound(solve_bytes,
                                                            solve_flops)

    # the nearest library yardstick of gate_cell: its packed dx·W_x GEMM
    dx = main_cases["gate_cell"][1][0]
    w_x, _ = pack_weights(gp)
    rows["gate_cell"]["library_ms"] = event_ms(torch, lambda: dx @ w_x, 50)
    rows["gate_cell"]["library_device_ms"] = device_ms(torch,
                                                       lambda: dx @ w_x)
    rows["gate_cell"]["library_call"] = (
        "torch.matmul(dx, W_x), the packed (35, 96) GEMM only: no single "
        "PyTorch call computes the gate cell")
    return rows


LPT_BIG_M = 65536                # a round past one block's 54,656 tasks


def lpt_past_one_block(torch, dev, gen) -> dict:
    """``lpt_queue`` at LPT_BIG_M tasks, on the main path's all-edge routes
    and on mixed ones: the chunked walk against the plain version, exact,
    and its device time beside its bound (the chain; bytes as the row's)."""
    from repro_torch.kernels.lpt_queue.ops import lpt_queue

    t = (torch.rand(LPT_BIG_M, generator=gen) * 0.499 + 0.001).to(dev)
    out = {"tasks": LPT_BIG_M}
    for routes in ("all_edge", "mixed"):
        route = (torch.zeros(LPT_BIG_M, dtype=torch.int32) if
                 routes == "all_edge" else torch.randint(
                     0, 2, (LPT_BIG_M,), generator=gen,
                     dtype=torch.int32)).to(dev)
        got = lpt_queue(t, route, 4, 1, force="kernel")
        if not torch.equal(got, lpt_queue(t, route, 4, 1, force="ref")):
            raise AssertionError(f"lpt_queue at {LPT_BIG_M} tasks "
                                 f"({routes}) differs from plain")
        chain = lpt_chain_ms(route, 4, 1)
        nbytes = LPT_BIG_M * (4 + 4 + 8 + 4)
        t_bound, by = bound(nbytes, 0.0, chain_ms=chain)
        out[routes] = {
            "ms": device_ms(torch, lambda: lpt_queue(t, route, 4, 1),
                            "lpt_queue_chunked_kernel", reps=5),
            "bound_ms": t_bound, "bound_by": by, "chain_ms": chain,
            "exact_vs_plain": True}
    return out


def c6_repair_cases(torch, stream, dev):
    """c6_repair's operands (bw_panel, r, p, v, route, z, acc_thr, rn, pn)
    and budget at M and M_RAGGED: {(m, "main_path"): the gate-mode
    policy's round-0 decisions before the repair and the round's budget,
    (m, "demoting"): those routes and versions at the highest resolution
    and frame rate (feasible wherever the decisions were) and half their
    draw as a 0-d budget tensor on the card}."""
    from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
    from repro_torch.core.gating import GateConfig
    from repro_torch.serving.policy import capacity_budget, make_policy

    sys_ = SystemConfig()
    pol = make_policy("r2evid", sys_, device=dev,
                      gate_cfg=GateConfig(d_feature=35),
                      generator=torch.Generator().manual_seed(0))
    obs = stream.round(0)
    _, sol = pol.decide_stream(pol.init(M), obs)
    budget = capacity_budget(sys_, bw_scale=obs.bw_scale)
    budget = sys_.total_bw_mbps if budget is None else budget

    def operands(m, r, p):
        panel = torch.movedim(pol.lat.bw, -1, 0)[sol["route"][:m]].reshape(
            m, -1)
        return (panel, r[:m], p[:m], sol["v"][:m], sol["route"][:m],
                obs.z[:m].contiguous(),
                obs.aq[:m] + sys_.acc_margin_robust, res_norm(sys_, dev),
                fps_norm(sys_, dev))

    cases = {}
    for m in (M, M_RAGGED):
        cases[m, "main_path"] = (operands(m, sol["r"], sol["p"]), budget)
        top = operands(m, torch.full_like(sol["r"], sys_.n_res - 1),
                       torch.full_like(sol["p"], sys_.n_fps - 1))
        cases[m, "demoting"] = (top, torch.tensor(float(np.float32(
            0.5 * float(top[0][:, -1].sum()))), device=dev))
    return cases


def c6_repair_tiled(cases, what: str, m: int):
    """``c6_repair_cases``' case ``what`` at M tiled to ``m`` tasks, and
    its budget: the demoting case at half the tiled draw (every task at the
    highest resolution and frame rate), the main path's round at its budget
    scaled with M (no feasible demotion: the repair stops after round 0)."""
    args, budget = cases[M, what]
    reps = -(-m // M)
    big = (args[0].repeat(reps, 1)[:m].contiguous(),
           *(t.repeat(reps)[:m].contiguous() for t in args[1:7]), *args[7:])
    if what == "demoting":
        return big, float(np.float32(0.5 * float(big[0][:, -1].sum())))
    return big, float(np.float32(float(budget) * m / M))


def c6_repair_row(torch, stream, dev, counts_reset, counts_read):
    """c6_repair against its plain version on the card on
    ``c6_repair_cases``, timed at the main path's inputs and at the
    demoting case, beside the per-round path (the c6_tail kernel a round
    and the selection in torch) on the same inputs.  Above the one-block
    cap the wrapper takes that per-round path: its launches are counted
    from zero (a c6_tail a round, no c6_repair) and its result must equal
    the plain version's.  Returns (row, those launches)."""
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.router import RouterConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels.c6_tail.ops import (
        CLUSTER_BLOCKS,
        CLUSTER_CAP,
        REPAIR_CAP,
        c6_repair,
        c6_tail,
        repair_path,
    )
    from repro_torch.kernels.c6_tail.ref import (
        c6_tail_ref,
        compare_repairs,
        prefix_sum,
        repair_rounds,
    )

    nz, rounds = SystemConfig().n_fps, RouterConfig().repair_rounds
    cases = c6_repair_cases(torch, stream, dev)

    def kernel(args, budget, k=rounds):
        return c6_repair(*args, budget, n_fps=nz, rounds=k, force="kernel")

    def plain(args, budget, k=rounds):
        return c6_repair(*args, budget, n_fps=nz, rounds=k, force="ref")

    def host(args, budget, k=rounds):      # the plain repair compared with
        return on_host(torch, c6_repair, *args, budget, n_fps=nz, rounds=k,
                       force="ref")

    def per_round(args, budget):
        tail = lambda *a, n_fps: c6_tail(*a, n_fps=n_fps, force="kernel")
        return repair_rounds(tail, *args, budget, nz, rounds)

    err, hist_rel = 0.0, 0.0
    for (m, what), (args, budget) in cases.items():
        out = compare_repairs(lambda k: kernel(args, budget, k),
                              lambda k: host(args, budget, k), rounds, args,
                              budget, nz)
        if not out["within"]:
            raise AssertionError(f"c6_repair ({what}, M={m}) vs plain: {out}")
        got, want = kernel(args, budget), host(args, budget)
        err = max(err, max_abs(torch, got[:2], want[:2]))
        hist_rel = max(hist_rel, out["hist_max_rel"])

    timing = {}
    for what in ("main_path", "demoting"):
        args, budget = cases[M, what]
        nbytes, flops, rounds_run, sorted_counts = c6_repair_work(
            torch, args, budget, rounds, nz)
        chain = c6_repair_chain_ms(M, rounds_run, sorted_counts)
        t_bound, by = bound(nbytes, flops, chain_ms=chain)
        _, gain, _ = c6_tail_ref(*args, nz)
        timing[what] = {
            "ms": device_ms(torch, lambda: kernel(args, budget),
                            "c6_repair_kernel"),
            "ms_from": "profiler",
            # the per-round path: every device activity of one repair
            "earlier_ms": device_ms(torch, lambda: per_round(args, budget)),
            "call_ms": event_ms(torch, lambda: kernel(args, budget), 50),
            "plain_ms": event_ms(torch, lambda: plain(args, budget), 10,
                                 warmup=1),
            "bytes": nbytes, "flops": flops, "chain_ms": chain,
            "bound_ms": t_bound, "bound_by": by, "rounds_run": rounds_run,
            "rounds_demoting": len(sorted_counts),
            "sorted_keys_per_round": sorted_counts,
            "feasible_demotions": int((gain > 0).sum()),
            "budget": float(budget)}
    if timing["demoting"]["rounds_demoting"] < 2:
        raise AssertionError(f"c6_repair demoting case: "
                             f"{timing['demoting']['rounds_demoting']} "
                             f"demoting rounds, want >= 2")

    # above the one-block cap: the cases tiled to the cluster's sizes (one
    # whose last block is partial), one cluster launch each, and past the
    # cluster's cap (the per-round path: a c6_tail a round)
    above, cluster = collections.Counter(), {}
    sizes = (CLUSTER_PARTIAL_M, CLUSTER_M, CLUSTER_CAP, CLUSTER_CAP + 1)
    for m in sizes:
        big_args, big_budget = c6_repair_tiled(cases, "demoting", m)
        counts_reset()
        got = [t.clone() for t in kernel(big_args, big_budget)]
        torch.cuda.synchronize()
        launched = counts_read()
        above.update(launched)
        path = repair_path(m)
        want = ({"c6_repair": 1} if path == "cluster"
                else {"c6_tail": rounds})
        if launched != want:
            raise AssertionError(f"c6_repair at M={m} launched {launched}, "
                                 f"want {want}")
        if path == "per_round":
            if not all(torch.equal(g, w) for g, w in
                       zip(got[:2], plain(big_args, big_budget)[:2])):
                raise AssertionError(f"c6_repair at M={m} (per round) "
                                     f"differs from plain")
            continue
        # the first launch at this M, then the repeats of both tiles: a
        # recurrence of a whole comparison that no round repeats names the
        # side that moved
        repeats = {}
        for what in ("demoting", "main_path"):
            a_, b_ = c6_repair_tiled(cases, what, m)
            first = got if what == "demoting" else [
                t.clone() for t in kernel(a_, b_)]
            repeats[what] = repair_repeats(
                torch, lambda: kernel(a_, b_), lambda: plain(a_, b_), first)
        out = compare_repairs(lambda k: kernel(big_args, big_budget, k),
                              lambda k: host(big_args, big_budget, k),
                              rounds, big_args, big_budget, nz)
        if not out["within"] or any(
                r["launches_differing"] or r["plain_on_card_runs_differing"]
                for r in repeats.values()):
            raise AssertionError(f"c6_repair at M={m} (cluster): {out}, "
                                 f"repeats (the side that moved): {repeats}")
        rec = {"tasks": m, "max_abs_err": max_abs(torch, got[:2], host(
            big_args, big_budget)[:2]), "hist_max_rel_err":
            out["hist_max_rel"], "repeats": repeats}
        for what in ("demoting", "main_path"):
            a_, b_ = c6_repair_tiled(cases, what, m)
            nbytes, flops, rounds_run, sorted_counts = c6_repair_work(
                torch, a_, b_, rounds, nz)
            blocks = max(CLUSTER_BLOCKS, -(-m // REPAIR_CAP))
            chain = c6_repair_chain_ms(-(-m // blocks), rounds_run,
                                       [-(-n // blocks) for n in
                                        sorted_counts], blocks)
            t_bound, by = bound(nbytes, flops, chain_ms=chain)
            turns = {"cluster": lambda: kernel(a_, b_),
                     "per_round": lambda: per_round(a_, b_)}
            events = event_ms_turns(torch, turns, reps=10)
            rec[what] = {
                "ms": device_ms(torch, turns["cluster"],
                                "c6_repair_cluster_kernel", reps=10),
                # every device activity of a repair on the per-round path
                "earlier_ms": device_ms(torch, turns["per_round"], reps=10),
                "call_ms": events["cluster"],
                "earlier_call_ms": events["per_round"],
                "bytes": nbytes, "flops": flops, "chain_ms": chain,
                "bound_ms": t_bound, "bound_by": by, "blocks": blocks,
                "rounds_run": rounds_run,
                "rounds_demoting": len(sorted_counts),
                "sorted_keys_per_round": sorted_counts, "budget": b_}
        if rec["demoting"]["rounds_demoting"] < 2:
            raise AssertionError(f"c6_repair at M={m}: the tiled demoting "
                                 f"case demotes in < 2 rounds")
        cluster[m] = rec

    # the plain repair's prefix sums at the cluster's cap: prefix_sum (the
    # same bits every call) against torch.cumsum of the 1-D CUDA tensor,
    # which it replaced (recorded, not held: torch does not promise it)
    big_args, big_budget = c6_repair_tiled(cases, "demoting", CLUSTER_CAP)
    _, gain, _ = c6_tail_ref(*big_args, nz)
    g = gain[torch.argsort(-gain, stable=True)]
    g = g[g > 0]
    prefix = {}
    for name, fn in (("prefix_sum", prefix_sum),
                     ("torch_cumsum", lambda t: torch.cumsum(t, 0))):
        first = fn(g)
        prefix[name] = sum(not torch.equal(fn(g), first)
                           for _ in range(REPEAT_LAUNCHES))
    if prefix["prefix_sum"]:
        raise AssertionError(f"c6_repair: the plain repair's prefix_sum gave "
                             f"other bits on {prefix['prefix_sum']} of "
                             f"{REPEAT_LAUNCHES} calls")
    prefix_ms = event_ms_turns(torch, {
        "prefix_sum": lambda: prefix_sum(g),
        "torch_cumsum": lambda: torch.cumsum(g, 0)}, reps=20)

    row = {
        "name": "c6_repair", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/c6_tail.cu",
        "replaces": "src/repro/kernels/c6_tail/kernel.py:69 with the "
                    "selection around it, src/repro/core/router.py:119-205",
        "max_abs_err": err, "hist_max_rel_err": hist_rel,
        "tolerance": "r, p equal outside the boundary exemption "
                     "(c6_tail/ref.py repair_boundary); bw_history within "
                     "1e-6 relative",
        "cases_compared": len(cases) + len(sizes),
        **{k: v for k, v in timing["main_path"].items()
           if k not in ("rounds_demoting", "feasible_demotions")},
        "inputs": "the main path's round 0: the gate-mode policy's decisions "
                  "before the repair, the round's budget",
        "main_path_inputs": {k: timing["main_path"][k] for k in
                             ("rounds_demoting", "feasible_demotions")},
        "demoting_case": timing["demoting"],
        "feasible_demotions": timing["demoting"]["feasible_demotions"],
        "rounds_demoting": timing["demoting"]["rounds_demoting"],
        "library_ms": None,
        "library_call": "none: no PyTorch call computes the repair",
        "tasks_cap_one_block": REPAIR_CAP,
        "tasks_cap_cluster": CLUSTER_CAP,
        "max_active_clusters": {
            blocks: _build.library().c6_repair_max_clusters(blocks)
            for blocks in (8, CLUSTER_CAP // REPAIR_CAP)},
        "above_cap": {"tasks": list(sizes), "launches": dict(above),
                      "within_plain": True},
        "plain_prefix_calls_differing": {
            "tasks": CLUSTER_CAP, "keys": g.numel(),
            "calls": REPEAT_LAUNCHES, **prefix,
            "call_ms": prefix_ms},
    }
    return row, dict(above), cluster


def attention_rows(torch, dev):
    """decode_attention and flash_attention against their plain versions
    at the dispatch path's shapes and at ragged ones, for the full-width
    tiers (the MoE and front-end models' too) and the serve launcher's
    SMOKE tiers, flash_attention also at runtime positions (Qwen2-VL's
    image-grid layout, shuffled, with and without a window; positions
    0..S-1 must give the index launch's bits), then timed at the cloud
    tier's shapes (every other tier's beside them, and the positions mode
    at Qwen2-VL's)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.decode_attention.ops import decode_attention, \
        split_rule
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.layers import mrope_positions

    gen = torch.Generator(dev).manual_seed(11)
    tiers = {"edge": get_config("qwen1.5-0.5b"),
             "cloud": get_config("qwen3-8b"),
             "recurrentgemma": get_config("recurrentgemma-9b"),
             "moonshot": get_config("moonshot-v1-16b-a3b"),
             "mixtral": get_config("mixtral-8x22b"),
             "qwen2_vl": get_config("qwen2-vl-2b"),
             "musicgen": get_config("musicgen-medium")}
    # checked, not timed: the serve launcher's SMOKE pools (head dims 16, 8)
    checked = {**tiers, "edge_smoke": get_smoke_config("qwen1.5-0.5b"),
               "cloud_smoke": get_smoke_config("qwen3-8b")}
    # cache entries of a tier's slab: prompts up to 80 + the decode
    # headroom, or min(window, 80) for RecurrentGemma's local attention
    slab_len = {t: min(c.attn_window, PROMPTS[-1]) if c.attn_window else SLAB
                for t, c in checked.items()}

    def normal(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def decode_case(cfg, dtype, b=SLOTS, s=SLAB):
        """A (B, S, KV, D) slab read through a permuted view, ragged
        lengths 1..S."""
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        k_slab, v_slab = (normal((b, s, kv, d), dtype) for _ in range(2))
        length = torch.randint(1, s + 1, (b,), generator=gen, device=dev,
                               dtype=torch.int32)
        length[0], length[-1] = 1, s
        return (normal((b, h, d), dtype), k_slab.permute(0, 2, 1, 3),
                v_slab.permute(0, 2, 1, 3), length), {}

    def flash_case(cfg, dtype, b, sq, sk=None, **kw):
        """(B, S, heads, D) projections read through permuted views."""
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        sk = sq if sk is None else sk
        return (normal((b, sq, h, d), dtype).transpose(1, 2),
                normal((b, sk, kv, d), dtype).transpose(1, 2),
                normal((b, sk, kv, d), dtype).transpose(1, 2)), kw

    bf16, f32 = torch.bfloat16, torch.float32
    cases = {"decode_attention": [], "flash_attention": []}
    for tier, cfg in checked.items():
        win = {"window": cfg.attn_window} if cfg.attn_window else {}
        for dt in (bf16, f32):
            cases["decode_attention"].append(
                (str(dt)[6:], decode_case(cfg, dt, s=slab_len[tier])))
        for b, s in zip((1, 2, 4, 8, 8), PROMPTS):
            cases["flash_attention"].append(
                ("bfloat16", flash_case(cfg, bf16, b, s, **win)))
        for dt in (bf16, f32):
            cases["flash_attention"] += [
                (str(dt)[6:], flash_case(cfg, dt, 8, 80)),
                (str(dt)[6:], flash_case(cfg, dt, 2, 37)),
                (str(dt)[6:], flash_case(cfg, dt, 2, 65)),
                (str(dt)[6:], flash_case(cfg, dt, 2, 100, window=16)),
                (str(dt)[6:], flash_case(cfg, dt, 1, 5, 70, causal=False))]

    def shuffled(b, s):
        return torch.stack([torch.randperm(s, generator=gen, device=dev)
                            for _ in range(b)]).to(torch.int32)

    # runtime positions: Qwen2-VL's temporal stream (16 text tokens, a
    # 2 × 4 × 4 patch grid, 32 text tokens), and shuffled ones
    vl = mrope_positions(16, (2, 4, 4), 32, 8, dev)[:, 0]
    n_positioned = len(cases["flash_attention"])
    for cfg in (tiers["qwen2_vl"], tiers["mixtral"], tiers["musicgen"],
                get_smoke_config("qwen2-vl-2b")):
        for dt in (bf16, f32):
            cases["flash_attention"] += [
                (str(dt)[6:], flash_case(cfg, dt, 8, 80, positions=vl)),
                (str(dt)[6:], flash_case(cfg, dt, 8, 80, positions=vl,
                                         window=16)),
                (str(dt)[6:], flash_case(cfg, dt, 2, 70,
                                         positions=shuffled(2, 70),
                                         window=24))]
    n_positioned = len(cases["flash_attention"]) - n_positioned
    fns = {"decode_attention": decode_attention,
           "flash_attention": flash_attention}
    rows = {}
    for name, fn in fns.items():
        errs = {"bfloat16": 0.0, "float32": 0.0}
        for dtype, (args, kw) in cases[name]:
            got = fn(*args, force="kernel", **kw).double()
            want = fn(*args, force="ref", **kw).double()
            torch.cuda.synchronize()
            tol = ATTN_TOL[dtype]
            diff = (got - want).abs()
            if not bool((diff <= tol + tol * want.abs()).all()):
                raise AssertionError(
                    f"{name} ({dtype}): kernel vs plain max |diff| "
                    f"{float(diff.max())} over {tol} + {tol}·|plain|")
            errs[dtype] = max(errs[dtype], float(diff.max()))
            if "positions" in kw:
                errs["positions"] = max(errs.get("positions", 0.0),
                                        float(diff.max()))
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{name}/kernel.py:"
                        + ("64" if name == "decode_attention" else "92"),
            "max_abs_err": errs["bfloat16"],
            "max_abs_err_float32": errs["float32"],
            "tolerance": "2e-2 + 2e-2·|plain| (bf16); 2e-5 + 2e-5·|plain| "
                         "(float32)",
            "cases_compared": len(cases[name]),
            "head_dims_compared": sorted({c.head_dim
                                          for c in checked.values()})}
    rows["flash_attention"]["positions_cases_compared"] = n_positioned
    rows["flash_attention"]["positions_max_abs_err"] = errs["positions"]
    # positions 0..S-1 visit every key tile; the ones the index launch
    # skips are fully masked, so the two launches give the same bits
    same = []
    for tier in ("cloud", "recurrentgemma", "mixtral", "qwen2_vl"):
        cfg = tiers[tier]
        win = {"window": cfg.attn_window} if cfg.attn_window else {}
        for b, s in ((8, 80), (2, 100)):
            args, _ = flash_case(cfg, bf16, b, s)
            ar = torch.arange(s, device=dev, dtype=torch.int32).expand(b, s)
            same.append(torch.equal(
                flash_attention(*args, force="kernel", **win),
                flash_attention(*args, force="kernel", positions=ar, **win)))
    if not all(same):
        raise AssertionError(f"flash_attention: positions 0..S-1 differ "
                             f"from the index launch ({same})")
    rows["flash_attention"]["arange_positions_bit_equal_cases"] = len(same)

    def timed(name, fn, args, kw, library, nbytes, flops):
        """Kernel and library each by CUDA events around the call, taken
        in turns (``ms`` falls back to them), and by the profiler's device
        time: ``call_ms`` compares with ``library_ms``, ``ms`` with
        ``library_device_ms`` (every kernel of the library call)."""
        call = lambda: fn(*args, force="kernel", **kw)
        events = event_ms_turns(torch, {"call": call, "library": library},
                                reps=100)
        ms_dev = device_ms(torch, call, f"{name}_kernel")
        t_bound, by = bound(nbytes, flops, BF16_FLOP_PER_S)
        return {"ms": ms_dev if ms_dev is not None else events["call"],
                "ms_from": "profiler" if ms_dev is not None else "cuda_events",
                "call_ms": events["call"],
                "plain_ms": event_ms(torch, lambda: fn(*args, force="ref",
                                                       **kw), reps=20),
                "library_ms": events["library"],
                "library_device_ms": device_ms(torch, library),
                "bytes": nbytes, "flops": flops, "bound_ms": t_bound,
                "bound_by": by}

    shapes = {}
    for tier, cfg in tiers.items():
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        sl = slab_len[tier]
        # decode: the slab at ragged lengths; bytes: q, the K/V entries up
        # to each row's length, out, lengths; 4·H·D operations per entry
        (q, kc, vc, length), _ = decode_case(cfg, bf16, s=sl)
        n_kv = float(length.double().sum())
        mask = (torch.arange(sl, device=dev)[None, :]
                < length[:, None])[:, None, None, :]
        lib = lambda q=q, kc=kc, vc=vc, mask=mask: \
            F.scaled_dot_product_attention(q[:, :, None], kc, vc,
                                           attn_mask=mask, enable_gqa=True)
        dec = timed("decode_attention", decode_attention, (q, kc, vc, length),
                    {}, lib, 2 * (2 * SLOTS * h * d + 2 * n_kv * kv * d)
                    + 4 * SLOTS, 4 * n_kv * h * d)
        dec["shape"] = (f"B={SLOTS} S={sl} H={h} KV={kv} D={d} bf16, "
                        f"mean length {n_kv / SLOTS:.1f}")
        dec["splits"] = split_rule(
            SLOTS * kv, sl, torch.cuda.get_device_properties(
                dev).multi_processor_count)
        # flash: the longest prefill bucket; bytes: q, k, v, out once;
        # 4·D operations per (head, causal query-key pair; the window of
        # 2048 masks none of them at 80 tokens)
        win = {"window": cfg.attn_window} if cfg.attn_window else {}
        (fq, fk, fv), _ = flash_case(cfg, bf16, 8, 80)
        lib = lambda fq=fq, fk=fk, fv=fv: F.scaled_dot_product_attention(
            fq, fk, fv, is_causal=True, enable_gqa=True)
        pairs = 80 * 81 / 2
        fl = timed("flash_attention", flash_attention, (fq, fk, fv), win,
                   lib, 2 * 8 * 80 * d * (2 * h + 2 * kv),
                   4 * 8 * h * d * pairs)
        fl["shape"] = (f"B=8 Sq=Sk=80 H={h} KV={kv} D={d} causal"
                       + (f" window {cfg.attn_window}" if win else "")
                       + " bf16")
        shapes[tier] = {"decode_attention": dec, "flash_attention": fl}
    for name, row in rows.items():
        row.update(shapes["cloud"][name])
        row["library_call"] = (
            "torch.nn.functional.scaled_dot_product_attention(enable_gqa="
            "True" + (", attn_mask=lengths)" if name == "decode_attention"
                      else ", is_causal=True)"))
        for tier in tiers:
            if tier != "cloud":
                row[tier] = shapes[tier][name]
    # the positions mode at Qwen2-VL's prefill (every key tile visited);
    # operations: 4·D a (head, visible query-key pair) of this input
    cfg = tiers["qwen2_vl"]
    h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    (fq, fk, fv), _ = flash_case(cfg, bf16, 8, 80)
    seen = vl[:, :, None] >= vl[:, None, :]                 # (B, Sq, Sk)
    pos_row = timed("flash_attention", flash_attention, (fq, fk, fv),
                    {"positions": vl},
                    lambda: F.scaled_dot_product_attention(
                        fq, fk, fv, attn_mask=seen[:, None],
                        enable_gqa=True),
                    2 * 8 * 80 * d * (2 * h + 2 * kv) + 4 * 8 * 80,
                    4 * h * d * float(seen.sum()))
    pos_row["shape"] = (f"B=8 Sq=Sk=80 H={h} KV={kv} D={d} bf16, Qwen2-VL "
                        "positions (text 16, patches 2 × 4 × 4, text 32)")
    pos_row["index_launch_ms"] = shapes["qwen2_vl"]["flash_attention"]["ms"]
    pos_row["library_call"] = ("torch.nn.functional.scaled_dot_product_"
                               "attention(enable_gqa=True, attn_mask="
                               "pos_q >= pos_k)")
    rows["flash_attention"]["positions"] = pos_row
    return rows


def partial_row(torch, dev):
    """decode_attention_partial (the partial launch: one range of each
    row's cache, float32 output and the range's log-sum-exp) against its
    plain version at ``serve_ranks``' shape (Qwen3-8B, 8 rows, a range of
    SERVE_RANGE entries, bf16 and float32; ragged lengths and every row
    full) and at the SMOKE head dims (16 and 8), lengths 0 (an empty range)
    and 1 among each case's.  bf16: out within 2^-8 of the softmax-weighted
    mean of |v| (the kernel rounds each probability to bf16 before P·V, at
    most 2^-9 of it) + 1e-6, the finite lse within 1e-3; float32: both
    within ``ATTN_TOL``; -inf lse where the plain one is.  Each case's
    plain version one entry short (every length less one) must fail the
    same check.  Then timed with every row's range full, beside the
    library's efficient attention with a length bias and the log-sum-exp
    (K/V expanded to every query head outside the timed call)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.decode_attention.ops import \
        decode_attention_partial, split_rule
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_partial_ref

    gen = torch.Generator(dev).manual_seed(12)
    b = SERVE["batch"]

    def case(cfg, dtype, s, lengths):
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((b, s, kv, d), generator=gen, device=dev).to(
            dtype).permute(0, 2, 1, 3) for _ in range(2))
        return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)

    def within(args, got, want):
        """-> (every value within the bound, per row; out and finite lse
        max |diff|)."""
        (got_o, got_l), (want_o, want_l) = got, want
        diff = (got_o.double() - want_o.double()).abs()
        empty = torch.isinf(want_l)
        l_diff = torch.where(empty, 0.0, got_l.double() - want_l.double()
                             ).abs()
        if args[0].dtype == torch.bfloat16:
            q, k, v, length = args
            w, _ = decode_attention_partial_ref(q, k, v.abs(), length)
            ok = diff <= 2.0 ** -8 * w.double() + 1e-6
            ok_l = l_diff <= 1e-3
        else:
            tol = ATTN_TOL["float32"]
            ok = diff <= tol + tol * want_o.double().abs()
            ok_l = l_diff <= tol + tol * torch.where(
                empty, 0.0, want_l.double()).abs()
        ok_l &= torch.isinf(got_l) == empty
        ok_l &= torch.where(empty, got_l == -torch.inf, True)
        rows = ok.flatten(1).all(1) & ok_l.all(1) & ~torch.isnan(
            got_o).flatten(1).any(1)
        return rows, float(diff.max()), float(l_diff.max())

    serve_cfg = get_config(SERVE["arch"])
    ragged = [0, 1, 7, 100, 1000, 1500, SERVE_RANGE - 1, SERVE_RANGE]
    cases = [(f"serve {str(dt)[6:]} ragged",
              case(serve_cfg, dt, SERVE_RANGE, ragged))
             for dt in (torch.bfloat16, torch.float32)]
    cases.append(("serve bfloat16 full", case(
        serve_cfg, torch.bfloat16, SERVE_RANGE, [SERVE_RANGE] * b)))
    for arch in ("qwen3-8b", "qwen1.5-0.5b"):
        for dt in (torch.bfloat16, torch.float32):
            cases.append((f"{arch} smoke {str(dt)[6:]}", case(
                get_smoke_config(arch), dt, 37,
                [0, 1, 2, 16, 17, 36, 37, 5])))
    errs = {"bfloat16": 0.0, "float32": 0.0}
    lse_err, short_rejected = 0.0, {}
    for name, args in cases:
        got = decode_attention_partial(*args, force="kernel")
        want = decode_attention_partial(*args, force="ref")
        torch.cuda.synchronize()
        rows, o_err, l_err = within(args, got, want)
        if not bool(rows.all()):
            raise AssertionError(
                f"decode_attention_partial ({name}): kernel vs plain out max "
                f"|diff| {o_err}, lse {l_err}; rows off: "
                f"{(~rows).nonzero().flatten().tolist()}")
        dt = str(args[0].dtype)[6:]
        errs[dt] = max(errs[dt], o_err)
        lse_err = max(lse_err, l_err)
        # the negative control: the plain version one entry short
        q, k, v, length = args
        short = decode_attention_partial(
            q, k, v, torch.clamp_min(length - 1, 0).to(torch.int32),
            force="ref")
        rows, _, _ = within(args, got, short)
        short_rejected[name] = int((~rows).sum())
        if bool(rows.all()):
            raise AssertionError(
                f"decode_attention_partial ({name}): the check passes the "
                f"plain version one entry short")
    # timed with every row's range full (the "serve bfloat16 full" case);
    # bytes: q, the K/V entries, out and lse (float32), lengths; 4·H·D
    # operations an entry
    h, kv, d = serve_cfg.num_heads, serve_cfg.num_kv_heads, \
        serve_cfg.head_dim
    q, k, v, length = cases[2][1]
    call = lambda: decode_attention_partial(q, k, v, length, force="kernel")
    n_kv = float(length.double().sum())
    nbytes = 2 * b * h * d + 2 * 2 * n_kv * kv * d + 4 * b * h * (d + 1) \
        + 4 * b
    t_bound, by = bound(nbytes, 4 * n_kv * h * d, BF16_FLOP_PER_S)
    ms = device_ms(torch, call, "decode_attention_kernel")
    # the library: memory-efficient attention with a length bias (its last
    # dim's stride a multiple of 16) returns out (bf16) and the natural-log
    # lse; an empty range is outside its domain (NaN)
    kx, vx = (t.repeat_interleave(h // kv, dim=1) for t in (k, v))
    pad = -(-SERVE_RANGE // 16) * 16
    bias = torch.zeros((b, h, 1, pad), dtype=q.dtype, device=dev)[
        ..., :SERVE_RANGE]
    bias.masked_fill_(torch.arange(SERVE_RANGE, device=dev)
                      >= length[:, None, None, None], -torch.inf)
    library = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        q[:, :, None], kx, vx, bias, True)
    lib_o, lib_l = library()[:2]
    want_o, want_l = decode_attention_partial(q, k, v, length, force="ref")
    sdpa = lambda: F.scaled_dot_product_attention(q[:, :, None], k, v,
                                                   enable_gqa=True)
    return {
        "name": "decode_attention_partial", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:64",
        "max_abs_err": errs["bfloat16"],
        "max_abs_err_float32": errs["float32"], "lse_max_abs_err": lse_err,
        "tolerance": "bf16: out 2^-8·(softmax-weighted |v|) + 1e-6, lse "
                     "1e-3; float32: 2e-5 + 2e-5·|plain| (out and lse); "
                     "-inf lse equal",
        "cases_compared": [name for name, _ in cases],
        "one_entry_short_rows_rejected": short_rejected,
        "ms": ms if ms is not None else event_ms(torch, call, reps=100),
        "ms_from": "profiler" if ms is not None else "cuda_events",
        "call_ms": event_ms(torch, call, reps=100),
        "plain_ms": event_ms(torch, lambda: decode_attention_partial(
            q, k, v, length, force="ref"), reps=20),
        "library_ms": event_ms(torch, library, reps=100),
        "library_device_ms": device_ms(torch, library),
        "library_call": "torch.ops.aten._scaled_dot_product_efficient_"
                        "attention(q, k, v expanded to 32 heads, length "
                        "bias, compute_log_sumexp=True)",
        "library_max_abs_err": float((lib_o[:, :, 0].double()
                                      - want_o.double()).abs().max()),
        "library_lse_max_abs_err": float((lib_l[:, :, 0].double()
                                          - want_l.double()).abs().max()),
        "sdpa_output_only_ms": event_ms(torch, sdpa, reps=100),
        "bytes": nbytes, "flops": 4 * n_kv * h * d,
        "bound_ms": t_bound, "bound_by": by,
        "shape": f"B={b} S={SERVE_RANGE} H={h} KV={kv} D={d} bf16, every "
                 f"row's range full",
        "splits": split_rule(b * kv, SERVE_RANGE,
                             torch.cuda.get_device_properties(
                                 dev).multi_processor_count)}


def scan_rows(torch, dev, names=("mamba_scan", "rglru_scan")):
    """mamba_scan and rglru_scan (or those of ``names``) against their
    plain versions at the recurrent tier pools' shapes (a decode step of 16
    slots and the longest prefill, 8 × 80) and at ragged ones (S = 1 and
    37, channels not a multiple of a block's; for rglru_scan also S = 4,
    the direct kernel's longest, and S = 129 at W = 203, the staged
    kernel's generic staging), x in bf16 and in float32, h0 given and
    None, and with h_out aliasing h0 (the decode step's in-place update);
    then timed at the decode step, the prefill beside it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan.ops import selective_scan
    from repro_torch.kernels.rglru.ops import rglru_scan

    gen = torch.Generator(dev).manual_seed(12)
    fm, rg = get_config("falcon-mamba-7b"), get_config("recurrentgemma-9b")
    r = fm.dt_rank

    def normal(shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    def mamba_case(b, s, di, n, dtype, with_h0):
        """x and the x_proj output in ``dtype`` (B and C its column
        slices), dt float32, as the model makes them."""
        proj = normal((b, s, r + 2 * n), dtype)
        return (normal((b, s, di), dtype),
                torch.nn.functional.softplus(normal((b, s, di), scale=0.5)),
                proj[..., r:r + n], proj[..., r + n:],
                -torch.exp(normal((di, n), scale=0.2)), normal((di,)),
                normal((b, di, n)) if with_h0 else None)

    def rglru_case(b, s, w, dtype, with_h0):
        return (normal((b, s, w), dtype), torch.sigmoid(normal((b, s, w))),
                torch.sigmoid(normal((b, s, w))),
                -8.0 * torch.nn.functional.softplus(normal((w,))),
                normal((b, w)) if with_h0 else None)

    di, n, w = fm.d_inner, fm.ssm.d_state, rg.lru_width
    kernels = {
        "mamba_scan": (selective_scan, mamba_case,
                       {"decode": (SLOTS, 1, di, n),
                        "prefill": (8, 80, di, n)},
                       [(3, 37, 200, n), (2, 1, 130, 4)], 64),
        "rglru_scan": (rglru_scan, rglru_case,
                       {"decode": (SLOTS, 1, w), "prefill": (8, 80, w)},
                       [(3, 37, 200), (2, 1, 130), (2, 4, 200),
                        (2, 129, 203)], 26),
    }
    bf16, f32 = torch.bfloat16, torch.float32
    rows = {}
    for name in names:
        fn, make, path, ragged, layers = kernels[name]
        errs, n_cases, bit_equal = {"bfloat16": 0.0, "float32": 0.0}, 0, True
        for shape in (*path.values(), *ragged):
            for dt in (bf16, f32):
                for with_h0 in (False, True):
                    args = make(*shape, dt, with_h0)
                    runs = [fn(*args, force="kernel")]
                    if with_h0:   # h_out aliasing h0, as the decode step
                        state = args[-1].clone()
                        runs.append(fn(*args[:-1], state, h_out=state,
                                       force="kernel"))
                    want = fn(*args, force="ref")
                    torch.cuda.synchronize()
                    for got in runs:
                        for g, wt in zip(got, want):
                            diff = (g.double() - wt.double()).abs()
                            if not bool((diff <= SCAN_TOL + SCAN_TOL
                                         * wt.double().abs()).all()):
                                raise AssertionError(
                                    f"{name} {shape} ({dt}): kernel vs plain"
                                    f" max |diff| {float(diff.max())} over "
                                    f"{SCAN_TOL} + {SCAN_TOL}·|plain|")
                            key = str(dt)[6:]
                            errs[key] = max(errs[key], float(diff.max()))
                            bit_equal &= bool(torch.equal(g, wt))
                    n_cases += len(runs)
        timing = {}
        for what, shape in path.items():
            # the model's call: bf16 x; the decode step carries its state
            args = make(*shape, bf16, what == "decode")
            call = lambda args=args: fn(*args, force="kernel")
            ms_events = event_ms(torch, call, reps=50)
            ms_dev = device_ms(torch, call, f"{name}_kernel")
            nbytes, flops, sfu = scan_work(name, args)
            t_bound, by = bound(nbytes, flops, sfu_ops=sfu)
            timing[what] = {
                "ms": ms_dev if ms_dev is not None else ms_events,
                "ms_from": "profiler" if ms_dev is not None else "cuda_events",
                "call_ms": ms_events,
                "plain_ms": event_ms(torch, lambda args=args: fn(
                    *args, force="ref"), reps=10, warmup=1),
                "bytes": nbytes, "flops": flops, "sfu_ops": sfu,
                "bound_ms": t_bound, "bound_by": by,
                # the kernel takes every exp on the SFUs: its floor there
                "sfu_only_ms": sfu / SFU_OP_PER_S * 1e3,
                "shape": "x (B, S, C) = " + str(tuple(shape[:3])) + " bf16"
                         + (f", N={shape[3]}" if len(shape) > 3 else "")
                         + (", h0 given" if what == "decode" else ", h0 None")}
        rows[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": ("src/repro/kernels/mamba_scan/kernel.py:55"
                         if name == "mamba_scan"
                         else "src/repro/kernels/rglru/kernel.py:45"),
            "max_abs_err": errs["bfloat16"],
            "max_abs_err_float32": errs["float32"],
            "tolerance": f"{SCAN_TOL} + {SCAN_TOL}·|plain| (y and h, float32 "
                         "outputs)",
            "cases_compared": n_cases, "bit_equal_to_plain": bit_equal,
            **timing["decode"], "prefill": timing["prefill"],
            "library_ms": None,
            "library_call": "none: no PyTorch call computes the scan",
            "layers_per_call": layers}
    return rows


def scan_work(name, args):
    """Bytes each input read once and each output written once (y and
    h_final float32), float32 operations, and special-function operations
    (exp, sqrt) of one scan call."""
    if name == "mamba_scan":
        x, dt, bm, cm, a, d, h0 = args
        b, s, di = x.shape
        n = a.shape[1]
        nbytes = (x.numel() * x.element_size() + 4 * dt.numel()
                  + 2 * b * s * n * bm.element_size() + 4 * (a.numel() + di)
                  + 4 * b * di * n * (2 if h0 is not None else 1)
                  + 4 * b * s * di)
        # per state value: dt·A, dt·B, ·x, dA·h, +, h·C, + and one exp;
        # per channel: D·x, +
        return (float(nbytes), float(b * s * di * (7 * n + 2)),
                float(b * s * di * n))
    x, rg, ig, la, h0 = args
    b, s, w = x.shape
    nbytes = (x.numel() * x.element_size() + 8 * rg.numel() + 4 * w
              + 4 * b * w * (2 if h0 is not None else 1) + 4 * b * s * w)
    # la·r, a·a, 1 −, max, i·x, a·h, ·, + and one exp and one sqrt
    return float(nbytes), float(8 * b * s * w), float(2 * b * s * w)


SCAN_BWD_TOL = 1e-5   # of each gradient's largest |entry| (the backward
                      # kernels sum over channels, steps and rows in another
                      # order than torch; the selective scan's dA is
                      # 2^(dt·A·log2 e) on the SFU); a bf16 gradient also
                      # within one bf16 rounding (2^-7) of each entry


def scan_bwd_rows(torch, dev, names=("mamba_scan_bwd", "rglru_scan_bwd")):
    """mamba_scan_bwd and rglru_scan_bwd (or those of ``names``) against
    their plain VJPs on the card: at the training shapes of Falcon-Mamba-7B
    (b 8, S 512, Di 8192, N 16; x and B, C, column slices of the x_proj
    output, in bf16) and RecurrentGemma-9B (B 8, S 512, W 4096, x in bf16)
    with no h0 and no final-state cotangent, as the models call them, and
    at ragged shapes in float32 and bf16 with both; RG-LRU with lanes where
    the clamp of sqrt(max(1 − a², 1e-12)) holds (r = 0).  Every gradient
    within SCAN_BWD_TOL of its largest |entry|; two launches bit-equal;
    the selective scan's training launch bit-equal to its serving launch
    and the backward's recomputed final state to its h; RG-LRU's
    elementwise gradients (all but dla) compared bit for bit (reported).
    Timed at the training shapes: the profiler's device time of a call
    (every kernel of it: the main kernel and its fixed-order sums), CUDA
    events around the wrapper, the plain VJP beside them."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba_scan.ops import (
        selective_scan,
        selective_scan_bwd,
    )
    from repro_torch.kernels.rglru.ops import rglru_scan, rglru_scan_bwd

    gen = torch.Generator(dev).manual_seed(13)
    fm, rg = get_config("falcon-mamba-7b"), get_config("recurrentgemma-9b")
    r = fm.dt_rank
    softplus = torch.nn.functional.softplus

    def normal(shape, dtype=torch.float32, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(
            dtype)

    def mamba_case(b, s, di, n, dtype, states):
        proj = normal((b, s, r + 2 * n), dtype)
        args = (normal((b, s, di), dtype), softplus(normal((b, s, di),
                                                           scale=0.5)),
                proj[..., r:r + n], proj[..., r + n:],
                -torch.exp(normal((di, n), scale=0.2)), normal((di,)),
                normal((b, di, n)) if states else None)
        return args, normal((b, s, di)), (normal((b, di, n)) if states
                                          else None)

    def rglru_case(b, s, w, dtype, states):
        rr = torch.sigmoid(normal((b, s, w)))
        rr[..., ::7] = 0.0          # a = 1: the clamp holds
        args = (normal((b, s, w), dtype), rr, torch.sigmoid(normal((b, s, w))),
                -8.0 * softplus(normal((w,))),
                normal((b, w)) if states else None)
        return args, normal((b, s, w)), normal((b, w)) if states else None

    def mamba_calls(args, dy, dh):
        """(kernel call, plain call, the checks of the forward launches)."""
        y, h, tiles = selective_scan(*args, force="kernel",
                                     return_tiles=True)
        serve_y, serve_h = selective_scan(*args, force="kernel")
        h_last = torch.full_like(h, float("nan"))
        selective_scan_bwd(*args, dy, dh, h_tiles=tiles, h_last=h_last,
                           force="kernel")
        torch.cuda.synchronize()
        if not (torch.equal(y, serve_y) and torch.equal(h, serve_h)
                and torch.equal(h_last, h)):
            raise AssertionError("mamba_scan: the training launch's y/h or "
                                 "the backward's recomputed state differ")
        return (lambda: selective_scan_bwd(*args, dy, dh, h_tiles=tiles,
                                           force="kernel"),
                lambda: selective_scan_bwd(*args, dy, dh, h_tiles=tiles,
                                           force="ref"))

    def rglru_calls(args, dy, dh):
        y, _ = rglru_scan(*args, force="kernel")
        return (lambda: rglru_scan_bwd(*args, y, dy, dh, force="kernel"),
                lambda: rglru_scan_bwd(*args, y, dy, dh, force="ref"))

    bf16, f32 = torch.bfloat16, torch.float32
    kernels = {
        "mamba_scan_bwd": (mamba_case, mamba_calls,
                           (8, 512, fm.d_inner, fm.ssm.d_state),
                           [(3, 37, 200, 16), (2, 65, 203, 5)],
                           ("dx", "ddt", "dB", "dC", "dA", "dD", "dh0"),
                           "src/repro/kernels/mamba_scan/kernel.py:55",
                           "src/repro/models/ssm.py:57"),
        "rglru_scan_bwd": (rglru_case, rglru_calls, (8, 512, rg.lru_width),
                           [(3, 37, 200), (2, 129, 203)],
                           ("dx", "dr", "di", "dla", "dh0"),
                           "src/repro/kernels/rglru/kernel.py:45",
                           "src/repro/models/rglru.py:49"),
    }
    rows = {}
    for name in names:
        make, calls, train, ragged, grads, tpu, jnp_scan = kernels[name]
        errs = {"float32": 0.0, "bfloat16": 0.0}
        by_grad = {g: 0.0 for g in grads}
        elementwise_bits, n_cases = True, 0
        cases = [(train, bf16, False)] + [(shape, dt, True) for shape in ragged
                                          for dt in (f32, bf16)]
        for shape, dt, states in cases:
            args, dy, dh = make(*shape, dt, states)
            kernel, plain = calls(args, dy, dh)
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            for g_name, g, a, w in zip(grads, got, again, want):
                if not torch.equal(g, a):
                    raise AssertionError(f"{name} {shape}: two launches "
                                         f"differ in {g_name}")
                scale = max(float(w.double().abs().max()), 1e-30)
                diff = (g.double() - w.double()).abs()
                tol = SCAN_BWD_TOL * scale + (
                    2.0 ** -7 * w.double().abs() if g.dtype == bf16 else 0)
                if not bool((diff <= tol).all()):
                    raise AssertionError(
                        f"{name} {shape} ({dt}): {g_name} kernel vs plain "
                        f"max |diff| {float(diff.max())} (largest entry "
                        f"{scale})")
                rel = float(diff.max()) / scale
                key = str(g.dtype)[6:]
                errs[key] = max(errs[key], rel)
                by_grad[g_name] = max(by_grad[g_name], rel)
                if name == "rglru_scan_bwd" and g_name != "dla":
                    elementwise_bits &= bool(torch.equal(g, w))
            n_cases += 1
        args, dy, dh = make(*train, bf16, False)
        kernel, plain = calls(args, dy, dh)
        ms = device_ms(torch, kernel)
        nbytes, flops, sfu = scan_bwd_work(name, args, dy)
        t_bound, by = bound(nbytes, flops, sfu_ops=sfu)
        row = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": f"none: port-only, the backward of {tpu}, whose VJP "
                        f"the reference takes of its jnp scan ({jnp_scan}) "
                        "by autodiff",
            "max_abs_err": errs["float32"],
            "max_err_relative_to": "each gradient's largest |entry|",
            "max_err_bf16_gradients": errs["bfloat16"],
            "max_err_by_gradient": by_grad,
            "tolerance": f"{SCAN_BWD_TOL} of each gradient's largest "
                         "|entry|; bf16 gradients also 2^-7·|plain|",
            "cases_compared": n_cases, "two_launches_bitequal": True,
            "ms": ms, "ms_from": "profiler (every kernel of a call)",
            "ms_by_kernel": {k: device_ms(torch, kernel, k) for k in (
                f"{name}_kernel", "sum_leading_kernel")},
            "call_ms": event_ms(torch, kernel, reps=20),
            "plain_ms": event_ms(torch, plain, reps=2, warmup=1),
            "bytes": nbytes, "flops": flops, "sfu_ops": sfu,
            "bound_ms": t_bound, "bound_by": by,
            "shape": f"x (B, S, C) = {tuple(train[:3])} bf16"
                     + (f", N={train[3]}" if len(train) > 3 else "")
                     + ", no h0, no final-state cotangent",
            "library_ms": None,
            "library_call": "none: no PyTorch call computes the scan's VJP"}
        if name == "rglru_scan_bwd":
            row["elementwise_bit_equal_to_plain"] = elementwise_bits
        else:
            serve = lambda: selective_scan(*args[:6], force="kernel")
            train_launch = lambda: selective_scan(*args[:6], force="kernel",
                                                  return_tiles=True)
            # the forward's training launch (it also stores the states)
            row["forward_ms"] = {
                "serving": device_ms(torch, serve, "mamba_scan_kernel"),
                "training": device_ms(torch, train_launch,
                                      "mamba_scan_kernel")}
        rows[name] = row
    return rows


def scan_bwd_work(name, args, dy):
    """Bytes each input read once and each output written once, float32
    operations and special-function operations of one backward call at
    the models' call (no h0, no final-state cotangent; dh0 written)."""
    if name == "mamba_scan_bwd":
        x, dt, bm, cm, a, d, _ = args
        b, s, di = x.shape
        n = a.shape[1]
        xb, cb = x.element_size(), bm.element_size()
        tiles = -(-s // 32)
        # x, dt, dy, the stored states, B, C, A, D in; dx, ddt, dB, dC, dA,
        # dD, dh0 out
        nbytes = (b * s * di * (xb + 4 + 4) + 4 * b * tiles * di * n
                  + 2 * b * s * n * cb + 4 * (di * n + di)
                  + b * s * di * (xb + 4) + 2 * b * s * n * cb
                  + 4 * (di * n + di) + 4 * b * di * n)
        # per state value: the state again (dt·A, dt·B, ·x, dA·h, +), then
        # dy·C, + (g); dy·h (dC); g·h, ·dA (z); g·x, ·dt (dB); z·A, gx·B,
        # +, + (ddt); g·B, + (dx); z·dt, + (dA); dA·g (the carry); and an
        # add each into dB and dC over the channels: 22; per channel:
        # dt·Σ, D·dy, + (dx) and dy·x, + (dD): 5; one exponential
        return (float(nbytes), float(b * s * di * (22 * n + 5)),
                float(b * s * di * n))
    x = args[0]
    b, s, w = x.shape
    xb = x.element_size()
    # x, r, i, y, dy, la in; dx, dr, di, dla, dh0 out
    nbytes = (b * s * w * (xb + 16) + 4 * w + b * s * w * (xb + 8)
              + 4 * w + 4 * b * w)
    # la·r; dy + carry, a·g (the chain); a·a, 1 −, max; g·s, ·i, ·x;
    # −a; i·x, g·u, ·dsa, g·h, +; da·a, ·la, ·r, + (dla): 19; exp, sqrt
    # and the division
    return float(nbytes), float(19 * b * s * w), float(3 * b * s * w)


def main_path_phase(torch, dev, stream, counts_reset, counts_read):
    """The serving round on the kernels, then on the plain versions."""
    from repro_torch.core.cost_model import SystemConfig, fps_norm, res_norm
    from repro_torch.core.gating import GateConfig
    from repro_torch.kernels.c6_tail.ops import c6_tail
    from repro_torch.serving.policy import make_policy
    from repro_torch.serving.session import ServeSession

    sys_ = SystemConfig()
    gcfg = GateConfig(d_feature=35)

    def session(force, capture=None):
        pol = make_policy("r2evid", sys_, device=dev, gate_cfg=gcfg,
                          generator=torch.Generator().manual_seed(0),
                          force=force)
        return ServeSession(pol, n_streams=M, device=dev, capture=capture)

    # the default session: the first round warms up, the round is captured
    # as a CUDA graph and replayed for the other rounds
    sess = session("auto")
    counts_reset()
    t0 = time.perf_counter()
    mets = sess.run(stream)
    torch.cuda.synchronize()
    first_run_s = time.perf_counter() - t0
    launches = counts_read()
    expect = {"gate_cell": ROUNDS, "ccg_solve": ROUNDS, "lpt_queue": ROUNDS,
              "c6_repair": ROUNDS}
    for name, n in expect.items():
        if launches.get(name) != n:
            raise AssertionError(f"main path launched {name} "
                                 f"{launches.get(name)} times, want {n}")
    if launches.get("c6_tail"):
        raise AssertionError(f"main path launched c6_tail "
                             f"{launches['c6_tail']} times, want 0")

    # outputs: shapes, finiteness, ranges
    for k in ("delay", "energy", "cost", "accuracy", "tau"):
        if tuple(mets[k].shape) != (ROUNDS, M) or \
                not bool(torch.isfinite(mets[k]).all()):
            raise AssertionError(f"metric {k} has bad shape or non-finite")
    ranges = {"route": 2, "r": sys_.n_res, "p": sys_.n_fps,
              "v": sys_.num_versions}
    for k, hi in ranges.items():
        if not bool(((mets[k] >= 0) & (mets[k] < hi)).all()):
            raise AssertionError(f"decision {k} out of range")
    if not bool(((mets["accuracy"] >= 0) & (mets["accuracy"] <= 1)).all()):
        raise AssertionError("accuracy outside [0, 1]")

    # C6: the budget holds on every round unless no feasible demotion is left
    lat = sess.policy.lat
    held, stuck = 0, 0
    for t in range(ROUNDS):
        sol = {k: mets[k][t] for k in ("route", "r", "p", "v")}
        draw = float(lat.solution_bandwidth(sol).sum())
        if draw <= sys_.total_bw_mbps + 1e-3:
            held += 1
            continue
        panel = torch.movedim(lat.bw, -1, 0)[sol["route"]].reshape(M, -1)
        _, gain, _ = c6_tail(
            panel, *(sol[k].to(torch.int32) for k in ("r", "p", "v", "route")),
            stream.z[t], stream.aq[t] + sys_.acc_margin_robust,
            res_norm(sys_, dev), fps_norm(sys_, dev), n_fps=sys_.n_fps,
            force="ref")
        if bool((gain > 0).any()):
            raise AssertionError(f"round {t}: draw {draw} over the budget "
                                 f"with feasible demotions left")
        stuck += 1

    # the eager loop: the same kernels in the same order, the same bits
    eager = session("auto", capture=False)
    lane_rounds = assert_bit_equal(torch, mets, eager.run(stream),
                                   "main path")
    sync_debug = no_sync_round(torch, eager, stream)

    # the same run on the plain versions, on the card
    ref = session("ref", capture=False)
    counts_reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_mets = ref.run(stream)
    torch.cuda.synchronize()
    plain_run_s = time.perf_counter() - t0
    if counts_read():
        raise AssertionError("force='ref' run launched a kernel")
    same = torch.ones((ROUNDS, M), dtype=torch.bool, device=dev)
    for k in ranges:
        same &= mets[k] == ref_mets[k]
    agree = float(same.double().mean())
    if agree < 0.999:
        raise AssertionError(f"kernel vs plain decisions agree on {agree}")
    max_rel = {}
    rounds_equal = same.all(dim=1)
    for k in ("delay", "energy", "cost", "accuracy"):
        a, b = mets[k][rounds_equal], ref_mets[k][rounds_equal]
        max_rel[k] = float(((a - b).abs() / b.abs().clamp_min(1e-12)).max()) \
            if a.numel() else None
    tau_err = float((mets["tau"] - ref_mets["tau"]).abs().max())

    # throughput: captured and eager runs in turns, median of three, each
    # session reused (reset between runs); then one profiled run of each
    turns = captured_vs_eager(torch, sess, eager, stream, ROUNDS,
                              counts_reset, counts_read)
    secs = turns["captured"]["run_s"]
    trace = trace_round(torch, sess, stream, secs)
    return launches, trace, {
        "phase": "main_path", "streams": M, "rounds": ROUNDS,
        "launches": launches, "c6_budget_held_rounds": held,
        "c6_no_feasible_demotion_rounds": stuck,
        "captured_vs_eager_lane_rounds_bitequal": lane_rounds,
        "eager_round_ran_under_sync_debug": sync_debug,
        "first_run_s": first_run_s, "captured_vs_eager": turns,
        "decision_agreement_vs_plain": agree,
        "rounds_bitequal_vs_plain": int(rounds_equal.sum()),
        "metric_max_rel_vs_plain": max_rel, "tau_max_abs_vs_plain": tau_err,
        "run_s": secs, "plain_run_s_one_sample": plain_run_s,
        "rounds_per_s": ROUNDS / secs,
        "eager_rounds_per_s": turns["eager"]["rounds_per_s"],
        "segments_per_s": ROUNDS * M / secs,
        "mean_accuracy": float(mets["accuracy"].mean()),
        "mean_delay_s": float(mets["delay"].mean()),
        "cloud_frac": float(mets["route"].double().mean()),
    }


def solve_phase(torch, dev, stream, counts_reset, counts_read):
    """The unrolled CCG solver on its kernels, on the plain versions with
    the running-η master, and as the fused solve: equal decisions."""
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.robust import (
        RobustProblem,
        solve_ccg,
        solve_ccg_fused,
    )
    from repro_torch.core.router import stage1_configure

    sys_ = SystemConfig()
    prob = RobustProblem.build(sys_, dev)
    lat = prob.lat
    n_steps = min(8, prob.poles.shape[0] + 1)
    z, aq = stream.z[0].contiguous(), stream.aq[0].contiguous()
    none = torch.full((M,), -1, dtype=torch.int64, device=dev)
    route, r = stage1_configure(lat, z, z, aq, none, torch.zeros_like(z))
    warm_y = lat.flatten_index(route, r, sys_.n_fps - 1)
    decisions = ("route", "r", "p", "v", "iters", "infeasible")
    per_solve = {"ccg_encode": 1, "ccg_master": n_steps}
    totals = collections.Counter()
    rec = {"phase": "solve_ccg", "streams": M, "round": 0,
           "master_steps": n_steps}
    for start, wy in (("cold", None), ("warm", warm_y)):
        def kernels():
            return solve_ccg(prob, z, aq, warm_y=wy)

        def plain():
            return solve_ccg(prob, z, aq, warm_y=wy, force="ref",
                             slab_master=False)

        def fused():
            return solve_ccg_fused(prob, z, aq, warm_y=wy)

        counts_reset()
        sol = kernels()
        torch.cuda.synchronize()
        launches = counts_read()
        if launches != per_solve:
            raise AssertionError(f"solve_ccg ({start}) launched {launches}, "
                                 f"want {per_solve}")
        totals.update(launches)
        counts_reset()
        sol_plain = plain()
        torch.cuda.synchronize()
        if counts_read():
            raise AssertionError("the plain solve launched a kernel")
        counts_reset()
        sol_fused = fused()
        torch.cuda.synchronize()
        if counts_read() != {"ccg_solve": 1}:
            raise AssertionError("solve_ccg_fused did not launch ccg_solve")
        row = {"launches": launches}
        for other, o in (("plain_running_eta", sol_plain),
                         ("fused", sol_fused)):
            lanes = torch.ones((M,), dtype=torch.bool, device=dev)
            for k in decisions:
                lanes &= sol[k] == o[k].to(sol[k].dtype)
            n_eq = int(lanes.sum())
            if n_eq != M:
                raise AssertionError(f"solve_ccg ({start}) vs {other}: "
                                     f"{M - n_eq} lanes differ")
            row[f"lanes_equal_vs_{other}"] = n_eq
            for k in ("o_up", "o_down"):
                row[f"{k}_max_abs_vs_{other}"] = float(
                    (sol[k] - o[k]).abs().max())
        row.update({
            "iters_mean": float(sol["iters"].double().mean()),
            "iters_max": int(sol["iters"].max()),
            "infeasible_tasks": int(sol["infeasible"].sum()),
            "cloud_frac": float(sol["route"].double().mean()),
            "ms_kernels": event_ms(torch, kernels, reps=20),
            "ms_plain_running_eta": event_ms(torch, plain, reps=5, warmup=1),
            "ms_fused": event_ms(torch, fused, reps=20),
        })
        rec[start] = row
    warm = lambda: solve_ccg(prob, z, aq, warm_y=warm_y)
    rec["device_ms_per_launch_in_warm_solve"] = {
        name: device_ms(torch, warm, f"{name}_kernel", reps=10)
        for name in per_solve}
    # the warm solve's device busy time beside its wall time (ms_kernels)
    rec["warm"].update(trace_calls(torch, warm, per_solve, reps=10))
    return totals, rec


def trace_calls(torch, fn, kernels, reps: int) -> dict:
    """One profiled window of ``reps`` calls of ``fn``: per call the device
    busy time (the sum of the device activities), their count, and the
    device time of each of ``kernels`` (summed over its launches in a
    call, with its launches a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    acts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    out = {"device_busy_ms": sum(e.self_device_time_total for e in acts)
           / 1e3 / reps,
           "device_activities": sum(e.count for e in acts) / reps}
    for name in kernels:
        mine = [e for e in acts if f"{name}_kernel" in e.key]
        out[f"{name}_ms"] = sum(e.self_device_time_total for e in mine) \
            / 1e3 / reps
        out[f"{name}_launches"] = sum(e.count for e in mine) / reps
    return out


def run_turns(torch, sessions: dict, stream, reps: int = 3) -> dict:
    """Median seconds of one ``run`` of each session, the sessions taken in
    turns (a, b, b, a, a, b, ...) so that a drift of the host's speed
    reaches them alike; each is reset before its run (a captured session
    keeps its graph) and has run once before."""
    times = {label: [] for label in sessions}
    order = list(sessions)
    for i in range(reps):
        for label in order if i % 2 == 0 else order[::-1]:
            sess = sessions[label]
            sess.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.run(stream)
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    return {label: statistics.median(t) for label, t in times.items()}


def no_sync_round(torch, sess, stream) -> bool:
    """One uncaptured round under ``torch.cuda.set_sync_debug_mode
    ("error")``: a synchronising call (a read back to the host) raises.
    Returns True once the round ran.  The mode does not see every copy
    from the host (a small copy from pageable memory passed it); the
    capture of the same round, which refuses any, is that check."""
    sess.reset()
    sess.run(stream, n_rounds=1)          # tables cached before the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sess.run(stream, n_rounds=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return True


def assert_bit_equal(torch, got: dict, want: dict, what: str) -> int:
    """A captured run against the eager run: every output equal bit for
    bit; returns the lane-rounds compared."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} vs "
                             f"{sorted(want)}")
    for k in want:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: captured and eager runs differ "
                                 f"in {k}")
    return got["route"].numel()


def capture_seconds(sess) -> float:
    """Host seconds the session spent capturing its round graphs."""
    return sum(g.capture_s or 0.0 for g in sess.graphs.values())


def captured_vs_eager(torch, graphed, eager, stream, rounds: int,
                      counts_reset, counts_read) -> dict:
    """Rounds/s of a captured and an uncaptured session in turns, and each
    one's profiled run (device busy time, activities and kernels a round).
    The profiled run is also counted by the wrappers (a replay adds the
    counts its capture recorded): the profiler's count of each ported
    kernel in that run must equal the wrappers' count of it.  A trace that
    lost the records of a run's last rounds (the profiler's fault: 1 of
    120 traces without the window's margin on an H100, in
    ``tools/trace_window.py``) is taken again, at most three times; every
    attempt's counts
    and the gap between its last device activity and the run's end are
    kept in the record."""
    secs = run_turns(torch, {"captured": graphed, "eager": eager}, stream)
    out = {"capture_s": capture_seconds(graphed)}
    for label, sess in (("captured", graphed), ("eager", eager)):
        attempts = []
        while len(attempts) < 3:
            counts_reset()
            prof = trace_round(torch, sess, stream, secs[label],
                               rounds=rounds, host=False)
            wrappers = counts_read()
            attempts.append({
                "profiler": prof["kernel_launches"], "wrappers": wrappers,
                "last_device_before_run_end_us":
                    prof["last_device_before_run_end_us"]})
            if prof["kernel_launches"] == wrappers:
                break
        else:
            raise AssertionError(f"{label} run: the profiler's and the "
                                 f"wrappers' counts differ in three "
                                 f"traces: {attempts}")
        out[label] = {"run_s": secs[label],
                      "rounds_per_s": rounds / secs[label],
                      "trace_attempts": attempts,
                      **{k: prof[k] for k in (
                          "device_busy_ms_per_round",
                          "device_activities_per_round",
                          "device_idle_share", "untraced_ms_per_round",
                          "dtoh_copies_per_round", "htod_copies_per_round",
                          "kernel_launches_per_round")}}
    out["speedup"] = secs["eager"] / secs["captured"]
    return out


POLICY_VARIANTS = {
    "a2_cloud_only": ("a2_cloud_only", {}),
    "jcab": ("jcab", {}),
    "rdap": ("rdap", {}),
    "sniper": ("sniper", {}),
    "r2evid_tau_proxy": ("r2evid", {}),
    "r2evid_no_stage1": ("r2evid", {"use_stage1": False}),
    "r2evid_no_stage2": ("r2evid", {"use_stage2": False}),
}


def policies_phase(torch, dev, stream, counts_reset, counts_read):
    """Every registered policy through ``ServeSession.run``, scored with
    the simulator's noise model as the paper's tables are."""
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.serving.policy import make_policy
    from repro_torch.serving.session import ServeSession
    from repro_torch.serving.simulator import SimConfig, Simulator

    sys_ = SystemConfig()
    obs = dataclasses.replace(stream, dx=None)    # no policy here reads dx
    ranges = {"route": 2, "r": sys_.n_res, "p": sys_.n_fps,
              "v": sys_.num_versions}
    rows = {}
    for label, (name, kw) in POLICY_VARIANTS.items():
        def session(force, capture=None):
            pol = make_policy(name, sys_, device=dev, force=force, **kw)
            return ServeSession(pol, n_streams=M, device=dev,
                                capture=capture)

        graphed = session("auto")
        counts_reset()
        mets = graphed.run(obs)
        torch.cuda.synchronize()
        launches = counts_read()
        want = {"lpt_queue": ROUNDS}
        if label == "r2evid_tau_proxy":
            want["ccg_solve"] = ROUNDS
            want["c6_repair"] = ROUNDS
        if launches != want:
            raise AssertionError(f"{label} launched {launches}, want {want}")
        for k in ("delay", "energy", "cost", "accuracy"):
            if tuple(mets[k].shape) != (ROUNDS, M) or \
                    not bool(torch.isfinite(mets[k]).all()):
                raise AssertionError(f"{label}: metric {k} bad shape or "
                                     f"non-finite")
        for k, hi in ranges.items():
            if tuple(mets[k].shape) != (ROUNDS, M) or \
                    not bool(((mets[k] >= 0) & (mets[k] < hi)).all()):
                raise AssertionError(f"{label}: decision {k} out of range")
        scalars = Simulator(sys_, SimConfig(n_tasks=M, seed=0),
                            device=dev).aggregate(mets, stream.aq)
        row = {"policy": name, "kw": kw, "launches": launches, **scalars}
        eager = session("auto", capture=False)
        row["captured_vs_eager_lane_rounds_bitequal"] = assert_bit_equal(
            torch, mets, eager.run(obs), label)
        row["eager_round_ran_under_sync_debug"] = no_sync_round(
            torch, eager, obs)
        if label == "r2evid_tau_proxy":
            counts_reset()
            ref = session("ref", capture=False).run(obs)
            torch.cuda.synchronize()
            if counts_read():
                raise AssertionError("force='ref' run launched a kernel")
            same = torch.ones((ROUNDS, M), dtype=torch.bool, device=dev)
            for k in ranges:
                same &= mets[k] == ref[k]
            n_same = int(same.sum())
            if n_same != ROUNDS * M:
                raise AssertionError(f"{label}: kernel vs plain decisions "
                                     f"differ on {ROUNDS * M - n_same} "
                                     f"lane-rounds")
            row["lane_rounds_bitequal_vs_plain"] = n_same
            row["metric_max_rel_vs_plain"] = {
                k: float(((mets[k] - ref[k]).abs()
                          / ref[k].abs().clamp_min(1e-12)).max())
                for k in ("delay", "energy", "cost", "accuracy")}

        turns = captured_vs_eager(torch, graphed, eager, obs, ROUNDS,
                                  counts_reset, counts_read)
        secs = turns["captured"]["run_s"]
        row.update({"run_s": secs, "rounds_per_s": ROUNDS / secs,
                    "eager_rounds_per_s": turns["eager"]["rounds_per_s"],
                    "segments_per_s": ROUNDS * M / secs,
                    "captured_vs_eager": turns})
        rows[label] = row
    return {"phase": "policies", "streams": M, "rounds": ROUNDS,
            "variants": rows}


DECIDE_S, DECIDE_T = 8, 8          # segments of the scans, window length


def decide_phase(torch, dev, stream, counts_reset, counts_read):
    """The decide-only paths at M = 4096 on the main path's stream and
    gate weights: ``route_step`` over S segments, ``route_scan`` (the
    same steps in one call) and the windowed ``route`` (T = 8), the
    session's
    ``route_many``, ``route`` and ``step`` without ``u`` (graphs), and
    ``Simulator.realize`` / ``realize_batch``.  Each on the kernels
    (launches counted from zero) and on the plain versions (decisions
    agreeing on >= 99.9% of lanes; the simulator against a CPU simulator
    of the same seed), and timed: captured and eager in turns where the
    path captures.  Returns (the launches of the counted runs, the
    record)."""
    from repro_torch.core import router
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.gating import GateConfig
    from repro_torch.serving.policy import Observation, make_policy
    from repro_torch.serving.session import ServeSession
    from repro_torch.serving.simulator import SimConfig, Simulator

    sys_, gcfg, S = SystemConfig(), GateConfig(d_feature=35), DECIDE_S
    pols = {f: make_policy("r2evid", sys_, device=dev, gate_cfg=gcfg,
                           generator=torch.Generator().manual_seed(0),
                           force=f) for f in ("auto", "ref")}
    prob, params = pols["auto"].prob, pols["auto"].gate_params
    dx, z, aq = stream.dx[:S], stream.z[:S], stream.aq[:S]
    window = stream.dx[:DECIDE_T].movedim(0, 1).contiguous()   # (M, T, d)
    gate_path = ("gate_cell", "ccg_solve", "c6_repair")
    totals = collections.Counter()
    paths = {}

    def agreement(got, want):
        same = torch.ones_like(got["route"], dtype=torch.bool)
        for k in DECISIONS:
            same &= got[k] == want[k]
        return float(same.double().mean())

    def counted(fn, want):
        counts_reset()
        out = fn()
        torch.cuda.synchronize()
        got = counts_read()
        if got != want:
            raise AssertionError(f"decide path launched {got}, want {want}")
        totals.update(got)
        return out

    def timed(fns: dict, units: int, reps: int = 3):
        """Median seconds of each of ``fns`` in turns -> units/s."""
        for fn in fns.values():
            fn()
        times = {k: [] for k in fns}
        for i in range(reps):
            for k in list(fns) if i % 2 == 0 else list(fns)[::-1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[k]()
                torch.cuda.synchronize()
                times[k].append(time.perf_counter() - t0)
        return {f"{k}_per_s": units / statistics.median(t)
                for k, t in times.items()}

    def keep(name, got, plain, launches, rate, **extra):
        agree = agreement(got, plain)
        if agree < 0.999:
            raise AssertionError(f"decide {name}: kernels vs plain "
                                 f"decisions agree on {agree}")
        paths[name] = {"launches": launches,
                       "decision_agreement_vs_plain": agree,
                       "tau_max_abs_vs_plain": float(
                           (got["tau"] - plain["tau"]).abs().max()), **rate,
                       **extra}

    def fresh_state():
        return router.init_router_state(gcfg, M, dev)

    # route_step, S segments threading the state (eager: a function call)
    def steps(force):
        st, sols = fresh_state(), []
        for i in range(S):
            st, sol = router.route_step(prob, gcfg, params, st, dx[i], z[i],
                                        aq[i], force=force)
            sols.append(sol)
        return {k: torch.stack([x[k] for x in sols]) for k in sols[0]}

    want = {k: S for k in gate_path}
    got = counted(lambda: steps("auto"), want)
    keep("route_step", got, steps("ref"), want,
         timed({"segments": lambda: steps("auto")}, S))

    # route_scan: the same S steps in one call (a session's route_many
    # is the scan that replays a graph)
    def scan(force):
        return router.route_scan(prob, gcfg, params, fresh_state(), dx, z,
                                 aq, force=force)[1]

    got = counted(lambda: scan("auto"), want)
    keep("route_scan", got, scan("ref"), want,
         timed({"segments": lambda: scan("auto")}, S))

    # the windowed route over T segments of features
    def windowed(force):
        return router.route(prob, gcfg, params, window, z[-1], aq[-1],
                            force=force)

    want_w = {"gate_cell": DECIDE_T, "ccg_solve": 1, "c6_repair": 1}
    got = counted(lambda: windowed("auto"), want_w)
    keep("route", got, windowed("ref"), want_w,
         timed({"calls": lambda: windowed("auto")}, 1))

    # the session's decide-only surface: captured and eager sessions
    sess = {c: ServeSession(pols["auto"], M, device=dev, capture=c)
            for c in (None, False)}
    plain = ServeSession(pols["ref"], M, device=dev, capture=False)
    got = counted(lambda: sess[None].route_many(dx, z, aq), want)
    lane = assert_bit_equal(torch, got, sess[False].route_many(dx, z, aq),
                            "route_many")
    ref = plain.route_many(dx, z, aq)

    def many(c):
        sess[c].reset()
        sess[c].route_many(dx, z, aq)

    keep("session.route_many", got, ref, want,
         timed({"captured_segments": lambda: many(None),
                "eager_segments": lambda: many(False)}, S),
         captured_vs_eager_lanes_bitequal=lane,
         capture_s=capture_seconds(sess[None]))
    nxt = Observation(z=stream.z[S], aq=stream.aq[S], dx=stream.dx[S])
    one = {k: 1 for k in gate_path}
    for name, call in (("session.route", "route"),
                       ("session.step_without_u", "step")):
        for c in (None, False):
            sess[c].reset()
            sess[c].route_many(dx, z, aq)
        plain.reset()
        plain.route_many(dx, z, aq)
        got = counted(lambda: getattr(sess[None], call)(nxt), one)
        eager = getattr(sess[False], call)(nxt)
        lane = assert_bit_equal(torch, {k: v[None] for k, v in got.items()},
                                {k: v[None] for k, v in eager.items()},
                                name)
        keep(name, {k: v[None] for k, v in got.items()},
             {k: v[None] for k, v in
              getattr(plain, call)(nxt).items()}, one,
             timed({"captured_calls":
                    lambda: getattr(sess[None], call)(nxt),
                    "eager_calls": lambda: getattr(sess[False], call)(nxt)},
                   1), captured_vs_eager_lanes_bitequal=lane)

    # the host simulator: realize and realize_batch on the card against a
    # CPU simulator of the same seed (the plain LPT walk, the same noise)
    cfgs = [{k: ref[k][i].cpu().numpy() for k in DECISIONS}
            for i in range(S)]
    for name, fn, want_l in (
            ("Simulator.realize",
             lambda sim, rnds: sim.realize(rnds[0], cfgs[0]),
             {"lpt_queue": 1}),
            ("Simulator.realize_batch",
             lambda sim, rnds: sim.realize_batch(rnds, cfgs),
             {"lpt_queue": 1})):
        # two simulators of one seed draw the same rounds and noise
        sims = [Simulator(sys_, SimConfig(n_tasks=M, seed=5), device=where)
                for where in (dev, "cpu")]
        rnds = [[sim.sample_round() for _ in range(S)] for sim in sims]
        got = counted(lambda: fn(sims[0], rnds[0]), want_l)
        want_np = fn(sims[1], rnds[1])
        agree = float(np.mean((got["route"] == want_np["route"])
                              & (got["success"] == want_np["success"])))
        if agree < 0.999:
            raise AssertionError(f"{name}: card vs CPU agree on {agree}")
        paths[name] = {
            "launches": want_l, "route_success_agreement_vs_cpu": agree,
            "metric_max_rel_vs_cpu": {
                k: float(np.max(np.abs(got[k] - want_np[k])
                                / np.maximum(np.abs(want_np[k]), 1e-12)))
                for k in ("delay", "energy", "cost", "accuracy")},
            **timed({"calls": lambda: fn(sims[0], rnds[0])}, 1)}
    return totals, {"phase": "decide", "streams": M, "segments": S,
                    "window": DECIDE_T, "paths": paths}


GRAD_TOL = 1e-5            # gate_cell_bwd: |kernel - plain| / max(1, max |plain|)
FT_PARAM_TOL = 1e-6        # tuned gate parameters, kernels vs plain (absolute)
WARMUP_STEPS, WARMUP_B, WARMUP_T = 50, 16, 12
WARMUP_LOSS_TOL = 1e-5     # warm-up losses, kernels vs plain (relative)


def gate_bwd_flops(b: int, d: int, m: int = 32) -> int:
    """Operations of the cell's VJP over ``b`` streams: the forward again
    (the packed products, the h·U_h product, τ's dot product and ~30 a
    unit of gates and elementwise terms), the backward through the hidden
    units (d(r·h) and dh: three m × m products, ~25 a unit), and the weight
    gradients (a multiply and an add a stream for each entry of the three
    d × m and three m × m matrices, w_o and alpha's m products; an add for
    each bias entry)."""
    fwd = 2 * (3 * d * m + 3 * m * m + m) + 30 * m
    bwd = 3 * 2 * m * m + 25 * m
    wgrad = 2 * (3 * d * m + 3 * m * m + m + m) + 3 * m + 1
    return b * (fwd + bwd + wgrad)


def gate_bwd_row(torch, stream, dev):
    """gate_cell_bwd against its plain VJP on the card at the finetune
    round's shape (M = 4096, d = 35) and at a ragged B = 37, with nonzero
    dh_new, dτ and dg_mean: every gradient within GRAD_TOL of max(1, its
    largest |entry|), and two launches bit-equal; timed by the profiler (both of
    its kernels: the per-tile pass and the ordered sum over tiles)."""
    from repro_torch.core.gating import GateConfig, init_gate_params
    from repro_torch.kernels.temporal_gate.ops import gate_cell_vjp
    from repro_torch.kernels.temporal_gate.ref import PARAM_NAMES

    gen = torch.Generator().manual_seed(11)
    gp = init_gate_params(GateConfig(d_feature=35), gen, dev)
    gp = {k: v + 0.1 * torch.randn(v.shape, generator=gen).to(dev)
          if k.startswith("b_") else v for k, v in gp.items()}

    def case(b):
        rand = lambda *shape: torch.randn(shape, generator=gen).to(dev)
        return ((stream.dx[0, :b].contiguous(),
                 (torch.rand((b, 32), generator=gen) * 2 - 1).to(dev),
                 (torch.rand((b,), generator=gen) * 2).to(dev), gp),
                dict(dh_new=rand(b, 32), dtau=rand(b), dg_mean=rand(b)))

    worst, cases = 0.0, {M: case(M), 37: case(37)}
    for b, (args, kw) in cases.items():
        got, dh = gate_cell_vjp(*args, **kw, force="kernel")
        again, dh2 = gate_cell_vjp(*args, **kw, force="kernel")
        want, dh_want = gate_cell_vjp(*args, **kw, force="ref")
        torch.cuda.synchronize()
        got, again, want = (dict(x, dh=y) for x, y in
                            ((got, dh), (again, dh2), (want, dh_want)))
        for k in want:
            if not torch.equal(got[k], again[k]):
                raise AssertionError(f"gate_cell_bwd: two launches differ "
                                     f"in {k} at B = {b}")
            rel = float((got[k] - want[k]).abs().max()
                        / want[k].abs().max().clamp_min(1.0))
            worst = max(worst, rel)
    if not worst <= GRAD_TOL:
        raise AssertionError(f"gate_cell_bwd: kernel vs plain {worst} of the "
                             f"largest entry > {GRAD_TOL}")
    args, kw = cases[M]
    call = lambda: gate_cell_vjp(*args, **kw, force="kernel")
    plain = lambda: gate_cell_vjp(*args, **kw, force="ref")
    ms = device_ms(torch, call)
    n_grad = sum(p.numel() for p in gp.values())
    d, m = 35, 32
    nbytes = 4 * (M * (d + m + 1 + m + 1 + 1) + n_grad + M * m + n_grad)
    flops = gate_bwd_flops(M, d, m)
    t_bound, by = bound(nbytes, flops, sfu_ops=M * (3 * m + 1))
    return {
        "name": "gate_cell_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/temporal_gate_bwd.cu",
        "replaces": "none: port-only, the backward of "
                    "src/repro/kernels/temporal_gate/kernel.py:50, whose "
                    "VJP the reference takes of its jnp cell "
                    "(src/repro/serving/session.py:255-258)",
        "max_abs_err": worst, "max_err_relative_to": "max(1, each "
        "gradient's largest |entry|)", "tolerance": GRAD_TOL,
        "cases_compared": len(cases), "two_launches_bitequal": True,
        "ms": ms, "ms_from": "profiler (both kernels of a call)",
        "ms_by_kernel": {k: device_ms(torch, call, k) for k in (
            "gate_cell_bwd_kernel", "gate_cell_bwd_reduce_kernel")},
        "call_ms": event_ms(torch, call, reps=50),
        "plain_ms": event_ms(torch, plain, reps=20, warmup=1),
        "bytes": nbytes, "flops": flops, "bound_ms": t_bound,
        "bound_by": by, "inputs": f"B = {M}, d = 35, dh_new, dtau and "
        f"dg_mean nonzero ({PARAM_NAMES[0]} … {PARAM_NAMES[-1]} and dh out)",
        "library_ms": None,
        "library_call": "none: no PyTorch call computes the cell's VJP",
    }


def warmup_batches(torch, dev, seed: int = 3):
    """The warm-up's data from the gate's own front end: 32 synthetic video
    streams of 24 segments (``generate_stream``), their segment features
    (``segment_features``, on the card), and per step B windows of T
    segments at seeded streams and offsets, labelled by the segments'
    motion level (the content difficulty) above 0.5."""
    from repro_torch.core.features import segment_features
    from repro_torch.data.video import VideoConfig, generate_stream

    vcfg = VideoConfig()
    streams = [generate_stream(vcfg, 24, rng=np.random.default_rng(i))
               for i in range(32)]
    frames = torch.as_tensor(np.stack([f for f, _ in streams]), device=dev)
    feats = segment_features(frames, vcfg.frames_per_segment)  # (32, 24, d)
    motion = torch.as_tensor(np.stack([mp for _, mp in streams]),
                             dtype=torch.float32, device=dev)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(WARMUP_STEPS):
        pick = torch.as_tensor(rng.integers(0, 32, WARMUP_B), device=dev)
        start = torch.as_tensor(rng.integers(0, 24 - WARMUP_T + 1, WARMUP_B),
                                device=dev)
        idx = start[:, None] + torch.arange(WARMUP_T, device=dev)
        out.append((feats[pick[:, None], idx],
                    (motion[pick[:, None], idx] > 0.5).to(torch.float32)))
    return out


def launcher_check(torch, dev, counts_reset, counts_read):
    """One short call of the serve launcher on ``dev``, its launches
    counted from zero; each attention call it makes (copies of its inputs
    and its output) is then held against the plain version on the same
    inputs. Returns (its launches, the record)."""
    import contextlib
    import io

    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import serve

    argv = ["--rounds", "2", "--streams", "8", "--device", dev.type]
    buf = io.StringIO()
    counts_reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), \
            Recorder(flash_ops, "flash_attention", copy=True) as flash_calls, \
            Recorder(decode_ops, "decode_attention", copy=True) as dec_calls:
        code = serve.main(argv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    launcher_s = time.perf_counter() - t0
    launches = counts_read()
    lines = buf.getvalue().splitlines()
    rounds_printed = [ln for ln in lines if ln.startswith("round ")]
    if code != 0 or len(rounds_printed) != 2 or \
            sum(ln.startswith("pool[") for ln in lines) != 2:
        raise AssertionError(f"serve launcher: exit {code}, output {lines}")
    attn = {}
    for mod, name, calls in ((flash_ops, "flash_attention", flash_calls),
                             (decode_ops, "decode_attention", dec_calls)):
        if not calls or launches.get(name) != len(calls):
            raise AssertionError(f"serve launcher: {len(calls)} {name} calls,"
                                 f" {launches.get(name)} launches")
        err, shapes = 0.0, set()
        for args, kw, out in calls:
            want = getattr(mod, name)(*args, **{**kw, "force": "ref"})
            dtype = str(out.dtype)[6:]
            tol = ATTN_TOL[dtype]
            diff = (out.double() - want.double()).abs()
            if not bool((diff <= tol + tol * want.double().abs()).all()):
                raise AssertionError(
                    f"serve launcher's {name} {tuple(args[0].shape)} "
                    f"{dtype}: kernel vs plain max |diff| "
                    f"{float(diff.max())} over {tol} + {tol}·|plain|")
            err = max(err, float(diff.max()))
            shapes.add(f"{tuple(args[0].shape)} {dtype}")
        attn[name] = {"calls": len(calls), "max_abs_err": err,
                      "tolerance": "2e-2 + 2e-2·|plain| (bf16); 2e-5 + "
                                   "2e-5·|plain| (float32)",
                      "q_shapes": sorted(shapes)}
    return launches, {"argv": " ".join(argv), "s": launcher_s,
                      "launches": launches, "attention_vs_plain": attn,
                      "output": lines}


def finetune_phase(torch, dev, stream, counts_reset, counts_read):
    """Online gate finetuning (``ServeSession(finetune=FinetuneConfig())``)
    at the main path's cell, captured and uncaptured and on the plain
    versions; the curriculum's warm-up on video and motion-feature data on
    the kernels and on the plain versions; one call of the serve launcher.
    Returns (the launches of the counted runs, the launcher's launches,
    the record)."""
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.curriculum import CurriculumConfig, offline_warmup
    from repro_torch.core.gating import GateConfig
    from repro_torch.serving.policy import make_policy
    from repro_torch.serving.session import FinetuneConfig, ServeSession

    sys_, gcfg, ft = SystemConfig(), GateConfig(d_feature=35), FinetuneConfig()

    def session(force="auto", capture=None, tune=True):
        pol = make_policy("r2evid", sys_, device=dev, gate_cfg=gcfg,
                          generator=torch.Generator().manual_seed(0),
                          force=force)
        return ServeSession(pol, n_streams=M, device=dev, capture=capture,
                            finetune=ft if tune else None)

    graphed = session()
    counts_reset()
    mets = graphed.run(stream)
    torch.cuda.synchronize()
    launches = counts_read()
    want = {"gate_cell": ROUNDS, "gate_cell_bwd": ROUNDS, "ccg_solve": ROUNDS,
            "c6_repair": ROUNDS, "lpt_queue": ROUNDS}
    if launches != want:
        raise AssertionError(f"finetune run launched {launches}, want {want}")
    (graph,) = graphed.graphs.values()
    if graph.graph is None or graph.launches.get("gate_cell_bwd") != 1:
        raise AssertionError("finetune round not captured with its backward")
    # the session's parameters (one flat tensor) against its offline anchor
    drift = float((graphed._params - graphed._anchor).abs().max())
    if not drift > 0:
        raise AssertionError("finetune left the gate parameters unchanged")

    # the same round uncaptured: every output and the tuned parameters
    eager = session(capture=False)
    lane_rounds = assert_bit_equal(torch, mets, eager.run(stream), "finetune")
    for k, v in graphed.gate_params.items():
        if not torch.equal(v, eager.gate_params[k]):
            raise AssertionError(f"finetune: captured and uncaptured tuned "
                                 f"{k} differ")
    # the rounds before the first update are the plain run's
    plain_run = session(tune=False)
    before = plain_run.run(stream)
    n_before = ft.resync_period
    assert_bit_equal(torch, {k: v[:n_before] for k, v in mets.items()},
                     {k: v[:n_before] for k, v in before.items()},
                     "finetune rounds before the first update")
    # the plain versions on the card
    ref = session(force="ref", capture=False)
    counts_reset()
    ref_mets = ref.run(stream)
    torch.cuda.synchronize()
    if counts_read():
        raise AssertionError("force='ref' finetune run launched a kernel")
    same = torch.ones((ROUNDS, M), dtype=torch.bool, device=dev)
    for k in DECISIONS:
        same &= mets[k] == ref_mets[k]
    agree = float(same.double().mean())
    if agree < 0.999:
        raise AssertionError(f"finetune kernels vs plain decisions agree on "
                             f"{agree}")
    param_err = max(float((v - ref.gate_params[k]).abs().max())
                    for k, v in graphed.gate_params.items())
    if not param_err <= FT_PARAM_TOL:
        raise AssertionError(f"finetune kernels vs plain tuned parameters "
                             f"differ by {param_err} > {FT_PARAM_TOL}")
    sync_debug = no_sync_round(torch, eager, stream)

    # rounds/s: captured and uncaptured finetune with their profiled runs
    # (the profiler's count of each kernel against the wrappers'), then the
    # captured finetune and the plain main path in turns
    turns = captured_vs_eager(torch, graphed, eager, stream, ROUNDS,
                              counts_reset, counts_read)
    beside = run_turns(torch, {"finetune": graphed, "main_path": plain_run},
                       stream)

    # the curriculum's warm-up, kernels and plain, on the same batches
    t0 = time.perf_counter()
    batches = warmup_batches(torch, dev)
    data_s = time.perf_counter() - t0
    ccfg = CurriculumConfig(warmup_steps=WARMUP_STEPS, lr=5e-2)
    losses, warm_s = {}, {}
    for force in ("auto", "ref"):
        counts_reset()
        t0 = time.perf_counter()
        _, losses[force] = offline_warmup(
            gcfg, iter(batches), ccfg, torch.Generator().manual_seed(0), dev,
            force=force)
        torch.cuda.synchronize()
        warm_s[force] = time.perf_counter() - t0
        if force == "auto":
            warm_launches = counts_read()
        elif counts_read():
            raise AssertionError("force='ref' warm-up launched a kernel")
    steps = WARMUP_STEPS * WARMUP_T
    if warm_launches != {"gate_cell": steps, "gate_cell_bwd": steps}:
        raise AssertionError(f"warm-up launched {warm_launches}")
    got, want = np.asarray(losses["auto"]), np.asarray(losses["ref"])
    loss_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if not loss_rel <= WARMUP_LOSS_TOL:
        raise AssertionError(f"warm-up losses kernels vs plain: {loss_rel}")
    if not got[-10:].mean() < got[:10].mean():
        raise AssertionError("warm-up did not lower the loss")

    launcher_launches, launcher = launcher_check(torch, dev, counts_reset,
                                                 counts_read)

    totals = collections.Counter(launches)
    totals.update(warm_launches)
    return totals, launcher_launches, {
        "phase": "finetune", "streams": M, "rounds": ROUNDS,
        "config": dataclasses.asdict(ft), "launches": launches,
        "captured_vs_eager_lane_rounds_bitequal": lane_rounds,
        "tuned_params_captured_vs_eager_bitequal": True,
        "rounds_before_first_update_bitequal_to_plain_run": n_before,
        "param_max_drift": drift,
        "decision_agreement_vs_plain": agree,
        "tuned_param_max_abs_vs_plain": param_err,
        "tau_max_abs_vs_plain": float((mets["tau"] - ref_mets["tau"])
                                      .abs().max()),
        "eager_round_ran_under_sync_debug": sync_debug,
        "captured_vs_eager": turns,
        "rounds_per_s": ROUNDS / turns["captured"]["run_s"],
        "eager_rounds_per_s": turns["eager"]["rounds_per_s"],
        "in_turns_run_s": beside,
        "in_turns_rounds_per_s": {k: ROUNDS / s for k, s in beside.items()},
        "warmup": {"steps": WARMUP_STEPS, "batch": WARMUP_B,
                   "segments": WARMUP_T, "lr": ccfg.lr,
                   "data_s": data_s, "run_s": warm_s,
                   "launches": warm_launches,
                   "loss_first_last": [float(got[0]), float(got[-1])],
                   "loss_mean_first10_last10": [float(got[:10].mean()),
                                                float(got[-10:].mean())],
                   "loss_max_rel_vs_plain": loss_rel},
        "launcher": launcher,
    }


SCEN_ROUNDS, SCEN_PLAIN_ROUNDS = 30, 12
# the plain path's scenarios: the outage mask (y_ok, avail), the hedge and
# the alive mask (task_mask), in turn
SCEN_PLAIN = ("edge_outage", "straggler_tail", "flash_churn")
GOLDEN_TOL = 2e-3                  # rtol = atol, the reference's golden test
DECISIONS = ("route", "r", "p", "v")


class Recorder:
    """Wraps ``module.name`` while active: every call's (args, kwargs,
    result) is kept (the tensors stay on the card; nothing is read). With
    ``copy``, the tensors are copies taken at the call, for inputs that the
    caller writes in place afterwards (a KV slab)."""

    def __init__(self, module, name, copy=False):
        self.module, self.name, self.copy = module, name, copy
        self.real = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def snap(x):
            return x.clone() if self.copy and hasattr(x, "clone") else x

        def record(*args, **kw):
            args = tuple(snap(a) for a in args)
            out = self.real(*args, **kw)
            self.calls.append((args, kw, snap(out)))
            return out
        setattr(self.module, self.name, record)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def golden_point(torch, dev):
    """``run_scenario`` over every golden cell (the 5 policies × ``none`` and
    the 9 of ``SUITE``) on the kernels and on the plain versions: every
    scalar the golden row holds within 2e-3 + 2e-3·|golden| on both paths,
    the churn cells' extra scalars equal between the paths, and the
    decisions' agreement over lane-rounds."""
    from repro_torch.serving import scenarios as sc
    from repro_torch.serving.policy import POLICIES

    gold = json.loads((ROOT / "SCENARIO_GOLDENS.json").read_text())
    cfg = gold["config"]
    kw = dict(streams=cfg["streams"], rounds=cfg["rounds"], seed=cfg["seed"],
              scenario_seed=cfg["scenario_seed"], device=dev,
              return_mets=True)
    worst, n_scalars, same, total = 0.0, 0, 0, 0
    churn_extra = {}
    for name in ("none",) + sc.SUITE:
        for pol in sorted(POLICIES):
            key = f"{pol}@{name}"
            got, g_mets = sc.run_scenario(pol, name, **kw)
            ref, r_mets = sc.run_scenario(pol, name, force="ref", **kw)
            for metric, val in gold["rows"][key].items():
                for side in (got, ref):
                    ratio = abs(side[metric] - val) / (
                        GOLDEN_TOL + GOLDEN_TOL * abs(val))
                    if not ratio <= 1.0:
                        raise AssertionError(
                            f"{key} {metric}: {side[metric]} vs golden "
                            f"{val}")
                    worst = max(worst, ratio)
                    n_scalars += 1
            if "mean_alive" in got:
                extra = {k: (got[k], ref[k]) for k in
                         ("mean_alive", "max_queue_depth", "dropped")}
                if any(a != b for a, b in extra.values()):
                    raise AssertionError(f"{key}: churn scalars differ "
                                         f"between the paths: {extra}")
                churn_extra[key] = {k: a for k, (a, _) in extra.items()}
            eq = torch.ones_like(g_mets["route"], dtype=torch.bool)
            for k in DECISIONS:
                eq &= g_mets[k] == r_mets[k]
            same += int(eq.sum())
            total += eq.numel()
    agree = same / total
    if agree < 0.999:
        raise AssertionError(f"golden point: kernels vs plain decisions "
                             f"agree on {agree}")
    return {"cells": len(gold["rows"]), "scalars_compared": n_scalars,
            "worst_err_over_tolerance": worst,
            "tolerance": "2e-3 + 2e-3·|golden|, kernels and plain",
            "decision_agreement_vs_plain": agree,
            "lane_rounds_compared": total, "churn_scalars": churn_extra}


def scenarios_phase(torch, dev, counts_reset, counts_read, rows):
    """The robustness path on the card: the golden point (``golden_point``),
    then gate-mode and τ-proxy R2E-VID at M = 4096 through every scenario
    on the kernels (launches counted from zero per run, rounds/s, C6
    demotions, churn occupancy) and three scenarios at R = 12 also on the
    plain versions.  Adds to ``rows`` the time of ``ccg_solve`` with the
    edge tier out and of ``c6_repair`` with the churned pool's alive mask,
    each checked against its plain version on those inputs.  Returns (the
    kernel launches of the counted runs, the phase's record)."""
    from repro_torch.core import robust, router
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.serving import simulator
    from repro_torch.core.gating import GateConfig
    from repro_torch.kernels.c6_tail.ops import c6_repair
    from repro_torch.kernels.c6_tail.ref import compare_repairs
    from repro_torch.serving import scenarios as sc
    from repro_torch.serving.policy import make_policy
    from repro_torch.serving.session import ServeSession
    from repro_torch.serving.simulator import SimConfig, Simulator

    t0 = time.perf_counter()
    rec = {"phase": "scenarios", "golden_point": golden_point(torch, dev)}
    rec["golden_point"]["seconds"] = time.perf_counter() - t0
    sys_ = SystemConfig()
    simc = SimConfig(n_tasks=M, seed=0)
    stream = Simulator(sys_, simc, device=dev).sample_stream(
        n_rounds=SCEN_ROUNDS, feature_seed=1)

    def session(mode, force, trace, capture=None):
        kw = ({} if mode == "tau_proxy" else
              dict(gate_cfg=GateConfig(d_feature=35),
                   generator=torch.Generator().manual_seed(0)))
        pol = make_policy("r2evid", sys_, device=dev, force=force, **kw)
        return ServeSession(pol, M, sim=simc, device=dev, hedge=trace.hedge,
                            admission=trace.admission, capture=capture)

    def degraded(mode, trace, rounds):
        obs = stream if rounds == SCEN_ROUNDS else dataclasses.replace(
            stream, **{f.name: getattr(stream, f.name)[:rounds]
                       for f in dataclasses.fields(stream)
                       if getattr(stream, f.name) is not None})
        if mode == "tau_proxy":
            obs = dataclasses.replace(obs, dx=None)
        return sc.apply_scenario(obs, trace)

    totals = collections.Counter()
    runs, captured = {}, {}
    for mode in ("gate", "tau_proxy"):
        for name in ("none",) + sc.SUITE:
            trace = sc.compile_scenario(name, sys_, simc, SCEN_ROUNDS, seed=0)
            obs = degraded(mode, trace, SCEN_ROUNDS)
            # the eager loop, each wrapper call recorded (a replay makes
            # none), then the captured run: equal bits, counted launches
            eager = session(mode, "auto", trace, capture=False)
            with Recorder(router, "c6_repair") as repairs, \
                    Recorder(robust, "ccg_solve") as solves, \
                    Recorder(simulator, "lpt_queue") as packs:
                counts_reset()
                mets = eager.run(obs)
                torch.cuda.synchronize()
                eager_launches = counts_read()
            sess = session(mode, "auto", trace)
            counts_reset()
            graphed_mets = sess.run(obs)
            torch.cuda.synchronize()
            launches = counts_read()
            want = {"ccg_solve": SCEN_ROUNDS, "c6_repair": SCEN_ROUNDS,
                    "lpt_queue": SCEN_ROUNDS}
            if mode == "gate":
                want["gate_cell"] = SCEN_ROUNDS
            if launches != want or eager_launches != want:
                raise AssertionError(f"scenarios {mode}/{name} launched "
                                     f"{launches} captured and "
                                     f"{eager_launches} eager, want {want}")
            bitequal = assert_bit_equal(torch, graphed_mets, mets,
                                        f"scenarios {mode}/{name}")
            totals.update(launches)
            for k in ("delay", "energy", "cost", "accuracy"):
                if tuple(mets[k].shape) != (SCEN_ROUNDS, M) or \
                        not bool(torch.isfinite(mets[k]).all()):
                    raise AssertionError(f"scenarios {mode}/{name}: metric "
                                         f"{k} bad shape or non-finite")
            if trace.tier_ok is not None:
                down = torch.as_tensor(trace.tier_ok[:, 0] == 0, device=dev)
                if bool((mets["route"][down] == 0).any()):
                    raise AssertionError(f"{mode}/{name}: a segment on the "
                                         f"downed edge tier")
            hists = torch.stack([out[2] for _, _, out in repairs])
            demoting = (hists[:, 1:] < hists[:, :-1]).any(dim=1)
            if mode == "gate" and name == "edge_outage":
                captured["ccg_solve"] = next(
                    (a, k) for a, k, _ in solves
                    if k["y_ok"] is not None and bool((k["y_ok"] <= 0).any()))
                # LPT in the round with the fewest edge servers up, > 0
                up = [float(k["avail"][:4].sum()) for _, k, _ in packs]
                i = min((u, j) for j, u in enumerate(up) if u > 0)[1]
                captured["lpt_avail"] = packs[i][:2]
            if mode == "gate" and name == "flash_churn":
                first = int(torch.argmax(demoting.int())) \
                    if bool(demoting.any()) else 0
                captured["c6_repair"] = repairs[first][:2] + (
                    bool(demoting[first]),)
                captured["lpt_dead_lanes"] = packs[0][:2]
            scalars = sc.scenario_metrics(mets, obs, trace)
            sync_debug = no_sync_round(torch, eager, obs)
            turns = captured_vs_eager(torch, sess, eager, obs, SCEN_ROUNDS,
                                      counts_reset, counts_read)
            secs = turns["captured"]["run_s"]
            row = {"launches_per_round": {k: v / SCEN_ROUNDS
                                          for k, v in launches.items()},
                   "rounds_per_s": SCEN_ROUNDS / secs, "run_s": secs,
                   "eager_rounds_per_s": turns["eager"]["rounds_per_s"],
                   "captured_vs_eager": turns,
                   "captured_vs_eager_lane_rounds_bitequal": bitequal,
                   "eager_round_ran_under_sync_debug": sync_debug,
                   "c6_demoting_rounds": int(demoting.sum()),
                   "cloud_frac": scalars["cloud_frac"],
                   "sla_violation_rate": scalars["sla_violation_rate"],
                   "cost": scalars["cost"], "accuracy": scalars["accuracy"]}
            for k in ("mean_alive", "max_queue_depth", "dropped"):
                if k in scalars:
                    row[k] = scalars[k]
            runs[f"{mode}/{name}"] = row
    rec["full_width"] = {"streams": M, "rounds": SCEN_ROUNDS, "runs": runs}

    # the plain versions on the three scenarios of the masks, R = 12
    plain = {}
    for name in SCEN_PLAIN:
        trace = sc.compile_scenario(name, sys_, simc, SCEN_PLAIN_ROUNDS,
                                    seed=0)
        obs = degraded("gate", trace, SCEN_PLAIN_ROUNDS)
        got = session("gate", "auto", trace).run(obs)
        counts_reset()
        want = session("gate", "ref", trace, capture=False).run(obs)
        torch.cuda.synchronize()
        if counts_read():
            raise AssertionError("force='ref' run launched a kernel")
        eq = torch.ones_like(got["route"], dtype=torch.bool)
        for k in DECISIONS:
            eq &= got[k] == want[k]
        agree = float(eq.double().mean())
        if agree < 0.999:
            raise AssertionError(f"scenarios {name}: kernels vs plain "
                                 f"decisions agree on {agree}")
        plain[name] = {"decision_agreement_vs_plain": agree,
                       "metric_max_abs_vs_plain": {
                           k: float((got[k] - want[k]).abs().max())
                           for k in ("delay", "energy", "cost", "accuracy")}}
        for k in ("alive", "queue_depth", "admitted", "dropped"):
            if k in got and not torch.equal(got[k], want[k]):
                raise AssertionError(f"scenarios {name}: {k} differs "
                                     f"between the paths")
    rec["plain_path"] = {"streams": M, "rounds": SCEN_PLAIN_ROUNDS,
                         "runs": plain}

    # the two masked kernels, on inputs the runs gave them
    args, kw = captured["ccg_solve"]
    got = robust.ccg_solve(*args, **dict(kw, force="kernel"))
    want = robust.ccg_solve(*args, **dict(kw, force="ref"))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("ccg_solve with the edge tier out differs "
                             "from plain")
    rows["ccg_solve"]["edge_out"] = {
        "ms": device_ms(torch, lambda: robust.ccg_solve(
            *args, **dict(kw, force="kernel")), "ccg_solve_kernel"),
        "plain_ms": event_ms(torch, lambda: robust.ccg_solve(
            *args, **dict(kw, force="ref")), 10, warmup=1),
        "inputs": "edge_outage, gate mode: the first round with the edge "
                  "tier out", "max_abs_err": 0.0}
    lpt_rows = {}
    for what, label in (("lpt_avail", "edge_outage, gate mode: the round "
                         "with the fewest edge servers up (not 0)"),
                        ("lpt_dead_lanes", "flash_churn, gate mode: round "
                         "0, the dead slots at t_comp 0")):
        args, kw = captured[what]
        got = simulator.lpt_queue(*args, **dict(kw, force="kernel"))
        want = simulator.lpt_queue(*args, **dict(kw, force="ref"))
        if not torch.equal(got, want):
            raise AssertionError(f"lpt_queue ({what}) differs from plain")
        lpt_rows[what] = {
            "ms": device_ms(torch, lambda: simulator.lpt_queue(
                *args, **dict(kw, force="kernel")), "lpt_queue_kernel"),
            "inputs": label, "max_abs_err": 0.0,
            "tasks_on_zero_time": int((args[0] == 0).sum()),
            "servers_up": None if kw.get("avail") is None
            else float(kw["avail"].sum())}
    rows["lpt_queue"].update(lpt_rows)
    args, kw, demotes = captured["c6_repair"]
    mask = kw["task_mask"]
    budget, rest = args[9], {k: v for k, v in kw.items()
                             if k not in ("force", "rounds")}
    out = compare_repairs(
        lambda k: c6_repair(*args, **dict(rest, rounds=k, force="kernel")),
        lambda k: on_host(torch, c6_repair, *args,
                          **dict(rest, rounds=k, force="ref")),
        kw["rounds"], args[:9], budget, kw["n_fps"], task_mask=mask)
    if not out["within"]:
        raise AssertionError(f"c6_repair with the alive mask vs plain: "
                             f"{out}")
    call = lambda: c6_repair(*args, **dict(kw, force="kernel"))
    rows["c6_repair"]["alive_mask"] = {
        "ms": device_ms(torch, call, "c6_repair_kernel"),
        "plain_ms": event_ms(torch, lambda: c6_repair(
            *args, **dict(kw, force="ref")), 10, warmup=1),
        "inputs": "flash_churn, gate mode: the first round whose repair "
                  "demotes" if demotes else
                  "flash_churn, gate mode: round 0 (no round demoted)",
        "alive": int(mask.sum()), "demotes": demotes,
        "rounds_demoting": out.get("rounds_demoting"),
        "hist_max_rel_err": out["hist_max_rel"]}
    if not demotes:
        # that round's pool and mask at the highest fidelity against half
        # the alive lanes' draw: a repair that demotes under the mask
        top = (args[0], torch.full_like(args[1], sys_.n_res - 1),
               torch.full_like(args[2], sys_.n_fps - 1), *args[3:9])
        half = torch.where(mask, top[0][:, -1], 0.0).sum() * 0.5
        out = compare_repairs(
            lambda k: c6_repair(*top, half, **dict(rest, rounds=k,
                                                  force="kernel")),
            lambda k: on_host(torch, c6_repair, *top, half,
                              **dict(rest, rounds=k, force="ref")),
            kw["rounds"], top, half, kw["n_fps"], task_mask=mask)
        if not out["within"] or not out.get("rounds_demoting", 1):
            raise AssertionError(f"c6_repair, masked demoting case: {out}")
        rows["c6_repair"]["alive_mask_demoting"] = {
            "ms": device_ms(torch, lambda: c6_repair(
                *top, half, **dict(kw, force="kernel")), "c6_repair_kernel"),
            "inputs": "that round's pool and alive mask at the highest "
                      "fidelity, half the alive lanes' draw as budget",
            "rounds_demoting": out.get("rounds_demoting"),
            "first_differing_round": out["first_differing_round"],
            "hist_max_rel_err": out["hist_max_rel"]}
    return totals, rec


def _plain_margin(torch, pool, tokens, ids, t):
    """The plain pool's top-2 logit margin at decoded position ``t`` of one
    request (its prompt, then its first ``t`` ids, decoded alone)."""
    from repro_torch.models.model import decode_step, prefill

    logits, cache = prefill(pool.ctx, pool.params,
                            {"tokens": torch.as_tensor(tokens[None]).long()
                             .to(pool.device)})
    for i in range(t):
        tok = torch.tensor([[int(ids[i])]], device=pool.device)
        logits, cache = decode_step(pool.ctx, pool.params, cache,
                                    {"tokens": tok})
    top2 = logits[0].topk(2).values
    return float(top2[0] - top2[1])


def _compare_ids(torch, got, want, reqs, ref_pools):
    """Per tier: streams whose decoded ids agree; a stream that differs
    must differ first where the plain path's margin is under LOGIT_MARGIN."""
    out = {}
    for req in reqs:
        rec = out.setdefault(req.tier, {"streams": 0, "ids_equal": 0,
                                        "flips_under_margin": 0,
                                        "flip_margins": []})
        rec["streams"] += 1
        g, w = got[req.stream], want[req.stream]
        if (g == w).all():
            rec["ids_equal"] += 1
            continue
        t = int((g != w).argmax())
        margin = _plain_margin(torch, ref_pools[req.tier], req.tokens, w, t)
        if margin > LOGIT_MARGIN:
            raise AssertionError(
                f"stream {req.stream} (tier {req.tier}): kernel and plain "
                f"ids differ at token {t} where the plain margin is "
                f"{margin} > {LOGIT_MARGIN}")
        rec["flips_under_margin"] += 1
        rec["flip_margins"].append(margin)
    return out


def trace_pools(torch, pools: dict, reps: int = 5) -> dict:
    """Where a tier's time goes, on each path ({"kernels": pool, "plain":
    pool}, the same weights): a decode step over a full slab (every slot at
    80 entries) and a prefill of 8 × 80 tokens.  Wall time per call (host
    clock to a synchronize, mean of ``reps``) is taken in the order
    kernels, plain, plain, kernels, so that a drift of the host's speed
    shows as a spread; then one profiled call per path: device busy time,
    idle share, the attention kernels' device time, device activities, the
    costliest device activities and host operations.  One call, because
    the profiler costs ~1.5 s a call of a few thousand device activities
    and ~50 s a plain Falcon-Mamba-7B prefill (the selective scan a Python
    loop over the steps of every layer) on an H100's host, against 0.05
    and ~1 s unprofiled: a Mamba pool's plain prefill keeps its wall times
    and leaves out its profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls = {}
    for path, pool in pools.items():
        slab = pool.make_slab(SLOTS, PROMPTS[-1])
        slab["length"].fill_(PROMPTS[-1])
        ids = torch.zeros(SLOTS, dtype=torch.long, device=pool.device)
        toks = torch.zeros((8, PROMPTS[-1]), dtype=torch.long,
                           device=pool.device)
        calls[path] = {
            "decode_step_16_slots":
                lambda pool=pool, slab=slab, ids=ids: pool.decode_slab(slab,
                                                                       ids),
            "prefill_8x80": lambda pool=pool, toks=toks: pool.prefill_batch(
                toks)}

    def wall_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    out = {}
    for what in ("decode_step_16_slots", "prefill_8x80"):
        for path in pools:
            calls[path][what]()                          # warm-up
        walls = {path: [] for path in pools}
        for path in ("kernels", "plain", "plain", "kernels"):
            walls[path].append(wall_ms(calls[path][what]))
        for path in pools:
            if what == "prefill_8x80" and path == "plain" \
                    and pools[path].cfg.ssm is not None:
                out[f"{path}_{what}"] = {
                    "wall_ms": walls[path],
                    "profile": "not taken (the profiler's ~50 s of a "
                               "Python-loop scan)"}
                continue
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                calls[path][what]()
                torch.cuda.synchronize()
            events = prof.key_averages()
            profiled_s = time.perf_counter() - t0
            dev_ev = [e for e in events if e.device_type == DeviceType.CUDA]
            host_ev = [e for e in events if e.device_type == DeviceType.CPU]
            busy = sum(e.self_device_time_total for e in dev_ev) / 1e3
            wall = statistics.mean(walls[path])
            out[f"{path}_{what}"] = {
                "wall_ms": walls[path], "profiled_window_s": profiled_s,
                "device_busy_ms": busy,
                "device_idle_share": 1.0 - busy / wall,
                "ported_kernels_ms": sum(
                    e.self_device_time_total for e in dev_ev
                    if any(k in e.key for k in PORTED_MODEL_KERNELS))
                / 1e3,
                "device_activities": sum(e.count for e in dev_ev),
                "top_device_time": [
                    {"name": e.key[:80],
                     "ms": e.self_device_time_total / 1e3}
                    for e in sorted(dev_ev, key=lambda e:
                                    -e.self_device_time_total)[:5]],
                "top_host_time": [
                    {"name": e.key[:60], "per_call": e.count,
                     "ms": e.self_cpu_time_total / 1e3}
                    for e in sorted(host_ev, key=lambda e:
                                    -e.self_cpu_time_total)[:5]]}
    return out


# the kernel each layer kind launches once per prefill and per decode step
LAYER_KERNELS = {"attn": ("flash_attention", "decode_attention"),
                 "ssm": ("mamba_scan", "mamba_scan"),
                 "rglru": ("rglru_scan", "rglru_scan")}


def expected_launches(cfgs: dict, calls: dict) -> dict:
    """Launches per (kernel, "prefill" or "decode") = layers of its kind ×
    calls of that kind, summed over the tiers; ``calls``: {tier:
    (prefills, decode steps)}."""
    want = collections.Counter()
    for t, (prefills, steps) in calls.items():
        for kind, n in collections.Counter(cfgs[t].layer_kinds()).items():
            on_prefill, on_step = LAYER_KERNELS[kind]
            want[on_prefill, "prefill"] += n * prefills
            want[on_step, "decode"] += n * steps
    return {k: v for k, v in want.items() if v}


def per_kernel(by_call: dict) -> dict:
    """{(kernel, kind): n} summed over the kinds: {kernel: n}."""
    out = collections.Counter()
    for (name, _), n in by_call.items():
        out[name] += n
    return dict(out)


def dispatch_phase(torch, dev, stream, counts_reset, counts_read, *,
                   phase="dispatch", archs=("qwen1.5-0.5b", "qwen3-8b"),
                   m=256, trace_reps=5):
    """The tier pools (``archs``: edge, cloud) on the kernels and on the
    plain versions: a routed round of the first ``m`` streams through
    ``ServeSession.dispatch`` and a fixed mixed request set, then the
    feedback loop and ``trace_pools`` with ``trace_reps`` calls a timed
    window."""
    from repro_torch.configs import get_config
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.gating import GateConfig
    from repro_torch.models.model import cache_specs, prefill
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.dispatch import DispatchExecutor, Request
    from repro_torch.serving.policy import make_policy
    from repro_torch.serving.pools import ModelPool, make_tier_pools
    from repro_torch.serving.session import ServeSession

    def slab_gb(cfg):
        specs = cache_specs(cfg, SLOTS, PROMPTS[-1])["segments"]
        return sum(math.prod(sp.shape) * torch.empty(
            (), dtype=getattr(torch, sp.dtype)).element_size()
            for sp in tree_leaves(specs)) / 1e9

    sys_ = SystemConfig()
    cfgs = {t: get_config(a) for t, a in enumerate(archs)}
    memory_before = free_device_memory(torch)
    t0 = time.perf_counter()
    pools = make_tier_pools(cfgs[0], cfgs[1], device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ref_pools = {t: ModelPool(p.cfg, name=p.name, device=dev, force="ref",
                              params=p.params) for t, p in pools.items()}
    layers = {t: dict(collections.Counter(c.layer_kinds()))
              for t, c in cfgs.items()}

    def first(obs_round):
        return dataclasses.replace(obs_round, **{
            k: getattr(obs_round, k)[:m].contiguous()
            for k in ("z", "aq", "dx")})

    pol = make_policy("r2evid", sys_, device=dev,
                      gate_cfg=GateConfig(d_feature=35),
                      generator=torch.Generator().manual_seed(0))
    sess = ServeSession(pol, n_streams=m, device=dev, pools=pools)
    ref_sess = ServeSession(pol, n_streams=m, device=dev, pools=ref_pools)
    routed = sess.step(first(stream.round(0)))

    vocab = {t: c.vocab_size for t, c in cfgs.items()}
    mixed = [Request(stream=i, tier=t, decode_tokens=8,
                     tokens=((i * 131 + np.arange(n)) % vocab[t]).astype(
                         np.int32))
             for i, (t, n) in enumerate((t, n) for t in (0, 1)
                                        for n in PROMPTS for _ in range(3))]

    def run(kernels: bool, which: str):
        """One request set on one path -> (ids, stats, launches, calls)."""
        ps = pools if kernels else ref_pools
        before = {t: (p.stats.prefills, p.stats.decode_steps)
                  for t, p in ps.items()}
        counts_reset()
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        if which == "routed":
            s = sess if kernels else ref_sess
            stats = s.dispatch(routed)
            ex = s.executor
        else:
            ex = DispatchExecutor(ps, max_prefill_len=PROMPTS[-1])
            stats = ex.serve([dataclasses.replace(r) for r in mixed])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launches = counts_read()
        calls = {t: (p.stats.prefills - before[t][0],
                     p.stats.decode_steps - before[t][1])
                 for t, p in ps.items()}
        ids = {c.stream: c.ids for t in ex.execs
               for c in ex.execs[t].completions}
        return ids, stats, launches, calls, wall

    # where the phase's seconds go, by part (host clock)
    parts, t_part = {}, time.perf_counter()

    def part_done(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    # warm-up, uncounted: every prefill and decode shape of the mixed set on
    # both tiers and both paths (cuBLAS and module loading)
    for ps in (pools, ref_pools):
        DispatchExecutor(ps, max_prefill_len=PROMPTS[-1]).serve(
            [dataclasses.replace(r) for r in mixed])
    torch.cuda.synchronize()
    part_done("warm_up")

    rec = {"phase": phase, "edge": cfgs[0].name, "cloud": cfgs[1].name,
           "layers": layers, "depth_cut": None, "dtype": "bfloat16",
           "routed_streams": m,
           "weights_init_s": init_s,
           "weights_gb": {p.name: weights_gb(p.params)
                          for p in pools.values()},
           "device_memory_gb_before": memory_before,
           "slab": {p.name: {"slots": SLOTS, "max_prompt": PROMPTS[-1],
                             "gb": slab_gb(p.cfg)} for p in pools.values()}}
    totals = collections.Counter()
    for which in ("routed", "mixed"):
        reqs = ([Request(stream=i, tier=int(t), tokens=(
            (i * 131 + np.arange(16 * (1 + int(r)))) % vocab[int(t)]).astype(
                np.int32)) for i, (t, r) in enumerate(
            zip(routed["route"].tolist(), routed["r"].tolist()))]
            if which == "routed" else mixed)
        ids_k, stats_k, launches, calls, wall_k = run(True, which)
        by_call = expected_launches(cfgs, calls)
        want = per_kernel(by_call)
        if launches != want:
            raise AssertionError(f"{phase} ({which}) launched {launches}, "
                                 f"want {want} (layers × calls {calls})")
        totals.update(by_call)
        ids_p, stats_p, plain_launches, _, wall_p = run(False, which)
        if plain_launches:
            raise AssertionError("force='ref' pools launched a kernel")
        if set(ids_k) != {r.stream for r in reqs} or set(ids_p) != set(ids_k):
            raise AssertionError(f"{phase} ({which}): streams missing")
        part_done(f"{which}_serve")
        tier_of = {r.stream: r.tier for r in reqs}
        for ids in (ids_k, ids_p):
            if any(v.shape != (8,) or not (
                    (v >= 0) & (v < vocab[tier_of[s_]])).all()
                   for s_, v in ids.items()):
                raise AssertionError(f"{phase} ({which}): bad ids")
        rec[which] = {
            "requests": len(reqs), "launches": launches,
            "prefills_and_decode_steps": calls,
            "wall_s_kernels": wall_k, "wall_s_plain": wall_p,
            "kernels": stats_k, "plain": stats_p,
            "ids_vs_plain": _compare_ids(torch, ids_k, ids_p, reqs,
                                         ref_pools)}
        part_done(f"{which}_flips_replayed")

    # first-token logits on both paths, one prefill per tier and length,
    # beside the largest |logit| (bf16 rounds it to 2^-8 of its magnitude)
    dlog, top = {}, {}
    for t in (0, 1):
        worst = top[t] = 0.0
        for n in PROMPTS:
            toks = torch.as_tensor(np.stack([r.tokens for r in mixed
                                             if r.tier == t
                                             and len(r.tokens) == n]),
                                   device=dev).long()
            lk, _ = prefill(pools[t].ctx, pools[t].params, {"tokens": toks})
            lp, _ = prefill(ref_pools[t].ctx, pools[t].params,
                            {"tokens": toks})
            if not bool(torch.isfinite(lk).all()):
                raise AssertionError("non-finite first-token logits")
            worst = max(worst, float((lk - lp).abs().max()))
            top[t] = max(top[t], float(lp.abs().max()))
        dlog[t] = worst
    rec["first_token_logits_max_abs_diff"] = dlog
    rec["first_token_logits_max_abs"] = top
    part_done("first_token_logits")

    # the router <-> serving loop: the measured feedback into the next round
    fb = sess.feedback()
    adjusted = sess.apply_feedback(first(stream.round(1)))
    nxt = sess.step(adjusted)
    for k in ("delay", "energy", "cost", "accuracy"):
        if not bool(torch.isfinite(nxt[k]).all()):
            raise AssertionError(f"fed-back round: non-finite {k}")
    rec["feedback"] = {
        "bw_mult": [float(x) for x in fb["bw_mult"][:2]],
        "bw_scale": float(adjusted.bw_scale),
        "cloud_frac_round0": float(routed["route"].double().mean()),
        "cloud_frac_fed_back_round": float(nxt["route"].double().mean()),
        "mean_r_round0": float(routed["r"].double().mean()),
        "mean_r_fed_back_round": float(nxt["r"].double().mean())}
    rec["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    part_done("feedback")
    rec["trace"] = {pools[t].name: trace_pools(
        torch, {"kernels": pools[t], "plain": ref_pools[t]}, trace_reps)
        for t in pools}
    part_done("trace")
    rec["part_seconds"] = parts
    return totals, rec


def free_device_memory(torch) -> float:
    """Collect the earlier phases' garbage (pools, slabs, sessions) and
    return the caching allocator's blocks; the GB still allocated."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 1e9


def weights_gb(params) -> float:
    from repro_torch.models.params import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9


def greedy_flips(torch, got, want, what: str) -> dict:
    """Kernel against plain logits of the same calls (a list of (B, V)
    float32, one per call, rows in lockstep): the greedy ids of each row
    agree until its first difference, which must fall where the plain
    path's top-2 margin is at most LOGIT_MARGIN (later calls of that row
    took other inputs, or are compared no further)."""
    live = torch.ones(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    flips, margins, max_diff = 0, [], 0.0
    for t, (g, w) in enumerate(zip(got, want)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: non-finite logits at call {t}")
        max_diff = max(max_diff, float((g - w)[live].abs().max())
                       if bool(live.any()) else 0.0)
        top2 = w.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        differ = live & (g.argmax(-1) != w.argmax(-1))
        if bool((differ & (margin > LOGIT_MARGIN)).any()):
            raise AssertionError(
                f"{what}: kernel and plain ids differ at call {t} where the "
                f"plain margin is {float(margin[differ].max())} > "
                f"{LOGIT_MARGIN}")
        flips += int(differ.sum())
        margins += [float(x) for x in margin[differ]]
        live &= ~differ
    return {"calls": len(got), "rows": int(got[0].shape[0]),
            "ids_flips_under_margin": flips, "flip_margins": margins,
            "logits_max_abs_diff": max_diff}


def mixtral_cut_phase(torch, dev, counts_reset, counts_read, layers=4,
                      steps=8, trace_reps=2):
    """Mixtral-8x22B at full width and ``layers`` of its 56 layers (5.0 GB
    a layer in bf16: one card cannot hold 56), kernels against plain on
    the same weights: one 8 × 80 prefill into a 16-slot slab (rows 0..7),
    then ``steps`` decode steps over the slab, greedy on each path; launches
    = layers × calls; then the pool calls traced."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serving.pools import ModelPool

    cfg = dataclasses.replace(get_config("mixtral-8x22b"), num_layers=layers)
    before = free_device_memory(torch)
    t0 = time.perf_counter()
    pool = ModelPool(cfg, torch.Generator(dev).manual_seed(2), name="cloud",
                     device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pools = {"kernels": pool,
             "plain": ModelPool(cfg, name="cloud", device=dev, force="ref",
                                params=pool.params)}
    toks = torch.as_tensor((np.arange(8)[:, None] * 131 + np.arange(80))
                           % cfg.vocab_size, device=dev).long()
    logits, walls, launches = {}, {}, {}
    for path, p in pools.items():
        slab = p.make_slab(SLOTS, PROMPTS[-1])
        counts_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first, cache = prefill(p.ctx, p.params, {"tokens": toks})
        p.insert_slab(slab, cache, list(range(8)))
        last = torch.zeros(SLOTS, dtype=torch.long, device=dev)
        seq = [first]
        for _ in range(steps):
            last[:8] = seq[-1][:8].argmax(-1)
            step_logits, slab = decode_step(p.ctx, p.params, slab,
                                            {"tokens": last[:, None]})
            seq.append(step_logits)
        torch.cuda.synchronize()
        walls[path] = time.perf_counter() - t0
        launches[path] = counts_read()
        logits[path] = [x[:8] for x in seq]
    want = {"flash_attention": layers, "decode_attention": layers * steps}
    if launches["kernels"] != want or launches["plain"]:
        raise AssertionError(f"mixtral cut launched {launches}, want "
                             f"{want} on the kernels and none plain")
    rec = {"arch": cfg.name, "layers": layers, "depth_cut": f"{layers} of 56",
           "dtype": "bfloat16", "weights_gb": weights_gb(pool.params),
           "weights_init_s": init_s, "device_memory_gb_before": before,
           "slab": {"slots": SLOTS, "entries": min(cfg.attn_window,
                                                    PROMPTS[-1])},
           "launches": launches["kernels"], "wall_s": walls,
           "prefill_then_steps": greedy_flips(
               torch, logits["kernels"], logits["plain"], "mixtral cut"),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    rec["trace"] = trace_pools(torch, pools, trace_reps)
    return want, rec


def front_end_phase(torch, dev, counts_reset, counts_read, b=8, s=80,
                    steps=8):
    """The embedding-input models at full width and depth in bf16:
    Qwen2-VL-2B (M-RoPE; a prefill at Qwen2-VL's positions, 16 text
    tokens, a 2 × 4 × 4 patch grid and 32 text tokens, then decode steps at
    explicit (B, 3, 1) text positions) and MusicGen-medium (default
    positions), each a prefill of seeded (B, S, d) embeddings then
    ``steps`` decode steps of seeded (B, 1, d) ones, on the kernels and
    plain: launches = layers × calls, logits and greedy ids by the margin
    rule, every flash_attention call of the kernels' prefill held against
    the plain version on a copy of its inputs (with its positions, for
    Qwen2-VL)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models.layers import Ctx, mrope_positions
    from repro_torch.models.model import decode_step, model_specs, prefill
    from repro_torch.models.params import init_params

    totals = collections.Counter()
    rec = {"phase": "front_end"}
    for arch in ("qwen2-vl-2b", "musicgen-medium"):
        cfg = get_config(arch)
        before = free_device_memory(torch)
        t0 = time.perf_counter()
        params = init_params(model_specs(cfg),
                             torch.Generator(dev).manual_seed(3), dev,
                             torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(dev).manual_seed(4)

        def emb(n):
            return torch.randn((b, n, cfg.d_model), generator=gen,
                               device=dev).to(torch.bfloat16)

        batches = [{"embeddings": emb(s)}] + [{"embeddings": emb(1)}
                                              for _ in range(steps)]
        if cfg.mrope:
            pos = mrope_positions(16, (2, 4, 4), s - 48, b, dev)
            batches[0]["positions"] = pos
            for i, batch in enumerate(batches[1:]):
                batch["positions"] = torch.full(
                    (b, 3, 1), int(pos.max()) + 1 + i, dtype=torch.int32,
                    device=dev)
        logits, walls, launches = {}, {}, {}
        for path, force in (("kernels", "auto"), ("plain", "ref")):
            ctx = Ctx(cfg=cfg, force=force)
            counts_reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with Recorder(flash_ops, "flash_attention",
                          copy=True) as flash_calls:
                out, cache = prefill(ctx, params, batches[0])
            seq = [out]
            for batch in batches[1:]:
                out, cache = decode_step(ctx, params, cache, batch)
                seq.append(out)
            torch.cuda.synchronize()
            walls[path] = time.perf_counter() - t0
            launches[path] = counts_read()
            logits[path] = seq
            if path == "kernels":
                kernel_calls = flash_calls
        layers = cfg.num_layers
        want = {"flash_attention": layers, "decode_attention": layers * steps}
        if launches["kernels"] != want or launches["plain"]:
            raise AssertionError(f"{arch} launched {launches}, want {want} "
                                 "on the kernels and none plain")
        if any(x.shape != (b, cfg.vocab_size) for x in logits["kernels"]):
            raise AssertionError(f"{arch}: logits of the wrong shape")
        flash_err = 0.0
        for args, kw, got in kernel_calls:
            if (kw.get("positions") is not None) != cfg.mrope:
                raise AssertionError(f"{arch}: flash_attention positions "
                                     f"{kw.get('positions')}")
            ref = flash_ops.flash_attention(*args, **{**kw, "force": "ref"})
            diff = (got.double() - ref.double()).abs()
            tol = ATTN_TOL["bfloat16"]
            if not bool((diff <= tol + tol * ref.double().abs()).all()):
                raise AssertionError(f"{arch}: flash_attention kernel vs "
                                     f"plain max |diff| {float(diff.max())}")
            flash_err = max(flash_err, float(diff.max()))
        totals.update(want)
        rec[arch] = {
            "layers": layers, "depth_cut": None, "dtype": "bfloat16",
            "batch": b, "prompt": s, "decode_steps": steps,
            "positions": ("Qwen2-VL layout: text 16, patches 2 × 4 × 4 at "
                          "(s0 + frame, s0 + row, s0 + col), text 32; "
                          "decode (B, 3, 1) after the largest")
            if cfg.mrope else "default (arange; length on decode)",
            "weights_gb": weights_gb(params), "weights_init_s": init_s,
            "device_memory_gb_before": before, "launches": launches["kernels"],
            "wall_s": walls,
            "prefill_then_steps": greedy_flips(torch, logits["kernels"],
                                               logits["plain"], arch),
            "flash_calls_vs_plain": {"calls": len(kernel_calls),
                                     "max_abs_err": flash_err},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params, cache, kernel_calls, flash_calls, logits
    return dict(totals), rec


SHARD_POLICIES = ("r2evid", "rdap", "jcab", "a2_cloud_only", "sniper")
SHARD_POOLS = {"n_edge": 16, "n_cloud": 8}   # divide by D = 1, 2, 4 and 8
SHARD_WORLD = 4                    # ranks on the one card, over gloo
SHARD_SCALE_M, SHARD_SCALE_R = 65536, 4    # 16,384 streams a rank
# the scale runs' C6 budget a stream, in Mbps.  The session's decisions sit
# on the accuracy floor (no feasible demotion is left in any round), so a
# budget below their draw cannot be met; the main cell's bw_scale 0.5 is
# 0.073 Mbps a stream.  The demotions at 16,384 a rank are the skewed
# repair case's (``inflated_case``).
SHARD_SCALE_BW = 2.5
# the gathered mode realizes and repairs every stream on every rank: its
# scale runs at the largest multiple of 4096 that one lpt_queue block holds
# (54,656 tasks) and at the hierarchical run's M, past it
SHARD_GATHER_M = 53248
ELASTIC_FAILURES = {6: [3], 11: [2]}       # 4 → 3 → 2 ranks
SHARD_TOL = 1e-5                   # relative, metrics against the reference


def sharded_cell(torch, dev, m: int, rounds: int, bw_scale: float = 0.5):
    """The sharded phase's stream: the main path's (seed 0, features of
    seed 1) with ``bw_scale`` on every round (0.5: C6 binds)."""
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.serving.simulator import SimConfig, Simulator

    stream = Simulator(SystemConfig(), SimConfig(n_tasks=m, seed=0),
                       device=dev).sample_stream(n_rounds=rounds,
                                                 feature_seed=1)
    return dataclasses.replace(
        stream, bw_scale=torch.full((rounds,), bw_scale, device=dev))


def shard_policy(torch, name, dev, force="auto", **kw):
    """A policy of the sharded phase: R2E-VID in gate mode with the main
    path's seeded weights; the others as registered."""
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.gating import GateConfig
    from repro_torch.serving.policy import make_policy

    if name == "r2evid":
        kw.update(gate_cfg=GateConfig(d_feature=35),
                  generator=torch.Generator().manual_seed(0))
    return make_policy(name, SystemConfig(), device=dev, force=force, **kw)


def shard_obs(stream, name):
    """Gate-mode R2E-VID reads the motion features; the others do not."""
    return stream if name == "r2evid" else dataclasses.replace(stream,
                                                               dx=None)


def max_rel(torch, got, want) -> float:
    """max |got − want| / max(|want|, 1e-12) over float tensors."""
    a, b = got.double(), want.double()
    return float(((a - b).abs() / b.abs().clamp_min(1e-12)).max())


def compare_to(torch, got: dict, want: dict, exact, close, what: str):
    """``exact`` keys equal, ``close`` keys within SHARD_TOL relative;
    returns the max relative difference of each close key."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} vs "
                             f"{sorted(want)}")
    for k in exact:
        if not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs")
    rel = {k: max_rel(torch, got[k], want[k]) for k in close}
    bad = {k: v for k, v in rel.items() if not v <= SHARD_TOL}
    if bad:
        raise AssertionError(f"{what}: {bad} above {SHARD_TOL} relative")
    return rel


def digest(arrays: dict) -> dict:
    """A short hash of each array: ranks other than 0 return these."""
    import hashlib

    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in arrays.items()}


def lpt_wide_check(torch, dev) -> dict:
    """``lpt_queue``'s wide instantiation (up to 16 servers a tier: the
    sharded phase's whole pools) and its per-shard pools against the plain
    version, on tie-heavy times and mixed routes at M = 4096, all servers
    up and one of each tier down: bit for bit; the kernel's ms at 16 + 8."""
    from repro_torch.kernels.lpt_queue.ops import lpt_queue

    rng = np.random.default_rng(24)
    out = {}
    for n_edge, n_cloud in ((16, 8), (8, 4), (4, 2)):
        t = torch.from_numpy((rng.integers(1, 5, (2, M)) * 0.125).astype(
            np.float32)).to(dev)
        route = torch.from_numpy(rng.integers(0, 2, (2, M)).astype(
            np.int32)).to(dev)
        down = torch.ones((2, n_edge + n_cloud), device=dev)
        down[1, 0] = down[1, n_edge] = 0.0
        for avail in (None, down):
            got = lpt_queue(t, route, n_edge, n_cloud, avail=avail,
                            force="kernel")
            want = lpt_queue(t, route, n_edge, n_cloud, avail=avail,
                             force="ref")
            if not torch.equal(got, want):
                raise AssertionError(f"lpt_queue at {n_edge} + {n_cloud} "
                                     f"servers differs from its plain version")
        out[f"{n_edge}+{n_cloud}"] = {
            "bitequal_vs_plain": True,
            "ms": event_ms(torch, lambda: lpt_queue(t, route, n_edge,
                                                    n_cloud), reps=20)}
    return out


def inflated_case(torch, m: int, dev, skewed: bool = False):
    """The reference's max-fidelity solutions with loose requirements
    (tests/test_hierarchical.py:86) at ``m`` tasks, real demotion slack:
    (solution, z, aq) on ``dev``.  ``skewed``: the second half of the
    streams at the middle (r, p) level instead, so that with 4 shards two
    draw under their fair share and grant their headroom to the two over
    it (the sub-budget split's every term is non-zero)."""
    from repro_torch.core.cost_model import SystemConfig

    sys_ = SystemConfig()
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.uniform(0.1, 0.6, m).astype(np.float32))
    aq = torch.from_numpy(rng.uniform(0.5, 0.6, m).astype(np.float32))
    full = lambda v: torch.full((m,), v, dtype=torch.int64, device=dev)
    sol = {"route": full(0), "r": full(sys_.n_res - 1),
           "p": full(sys_.n_fps - 1), "v": full(sys_.num_versions - 1)}
    if skewed:
        sol["r"][m // 2:] = sys_.n_res // 2
        sol["p"][m // 2:] = sys_.n_fps // 2
    return sol, z.to(dev), aq.to(dev)


def sharded_rank(device: str, force: str, parts: tuple, sizes: tuple) -> dict:
    """One rank of a world started by ``run_ranks`` (4 ranks on the one
    card over gloo, or on the CPU for the plain path): the ``parts`` of
    the sharded phase, each run's launches counted from zero just before
    it and read just after.  ``sizes``: (M, R) of the cell and of the scale
    run.  Rank 0 returns the outputs (numpy), the other ranks their
    digests."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.router import RouterConfig, shard_bandwidth_target
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.serving.scenarios import apply_scenario, compile_scenario
    from repro_torch.serving.session import ServeSession
    from repro_torch.serving.simulator import SimConfig
    from repro_torch.sharding.audit import round_footprint
    from repro_torch.sharding.collectives import COLLECTIVES

    dev = torch.device(device)
    m, rounds, scale_m, scale_r, gather_m = sizes
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = host_mesh()
    rank = dist.get_rank()
    sys_ = SystemConfig()
    res = {"rank": rank, "runs": {}, "launches": collections.Counter()}
    host = lambda out: {k: v.cpu().numpy() for k, v in out.items()}

    def keep(out):
        return host(out) if rank == 0 else digest(host(out))

    def counted(fn, rounds):
        """Run ``fn``: its outputs, launches and exchanges, and the seconds
        of a second, warm run (of the first on the CPU)."""
        reset_launch_counts()
        start = len(COLLECTIVES)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        secs = time.perf_counter() - t0
        launches = launch_counts()
        ex = round_footprint(COLLECTIVES[start:], rounds)
        res["launches"].update(launches)
        if dev.type == "cuda":
            t0 = time.perf_counter()
            fn()
            sync()
            secs = time.perf_counter() - t0
        return out, launches, ex, secs

    stream = sharded_cell(torch, dev, m, rounds)
    if "policies" in parts or "hier_r2evid" in parts:
        names = SHARD_POLICIES if "policies" in parts else ("r2evid",)
        modes = (False, True) if "policies" in parts else (True,)
        for name in names:
            obs = shard_obs(stream, name)
            pol = shard_policy(torch, name, dev, force)
            for hier in modes:
                sess = ServeSession(pol, m, device=dev, **SHARD_POOLS)

                def run():
                    sess.reset()
                    return sess.run_sharded(mesh, obs, hierarchical=hier)
                out, launches, ex, secs = counted(run, rounds)
                res["runs"][name, hier] = {
                    "out": keep(out), "launches": launches, "exchanges": ex,
                    "rounds_per_s": rounds / secs}
    if "churn" in parts:
        simc = SimConfig(n_tasks=m, seed=0)
        trace = compile_scenario("churn", sys_, simc, rounds, seed=1)
        obs = apply_scenario(stream, trace)
        pol = shard_policy(torch, "r2evid", dev, force)
        for hier in (False, True):
            sess = ServeSession(pol, m, device=dev, admission=trace.admission,
                                **SHARD_POOLS)

            def run():
                sess.reset()
                return sess.run_sharded(mesh, obs, hierarchical=hier)
            out, launches, ex, secs = counted(run, rounds)
            res["runs"]["churn", hier] = {
                "out": keep(out), "launches": launches, "exchanges": ex,
                "rounds_per_s": rounds / secs}
    if "repair" in parts:
        # the reference's case at the cell's M (half its draw), and the
        # skewed one at 16,384 streams a rank (three quarters of its draw)
        pol = shard_policy(torch, "r2evid", dev, force,
                           rcfg=RouterConfig(repair_rounds=64))
        lat = pol.lat
        res["repair"] = {}
        for key, mm, skewed, frac in (("cell", m, False, 0.5),
                                      ("scale", scale_m, True, 0.75)):
            sol, z, aq = inflated_case(torch, mm, dev, skewed)
            scale = (frac * lat.solution_bandwidth(sol).sum()
                     / sys_.total_bw_mbps)
            ml = mm // mesh.size()
            sl = slice(rank * ml, (rank + 1) * ml)
            local = {k: v[sl] for k, v in sol.items()}
            reset_launch_counts()
            fixed = pol.repair_local(local, z[sl], aq[sl], mesh=mesh,
                                     bw_scale=scale)
            sync()
            res["launches"].update(launch_counts())
            target = shard_bandwidth_target(
                lat.solution_bandwidth(local).sum(),
                torch.tensor(float(ml), device=dev),
                scale * sys_.total_bw_mbps, mesh)
            res["repair"][key] = {
                "r": fixed["r"].cpu().numpy(), "p": fixed["p"].cpu().numpy(),
                "target": float(target),
                "budget": float(scale * sys_.total_bw_mbps),
                "draw_before": float(lat.solution_bandwidth(local).sum()),
                "draw": float(lat.solution_bandwidth(fixed).sum()),
                "demotions": int((fixed["r"] != local["r"]).sum()
                                 + (fixed["p"] != local["p"]).sum())}
    if "elastic" in parts:
        pol = shard_policy(torch, "r2evid", dev, force)
        sess = ServeSession(pol, m, device=dev, **SHARD_POOLS)
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        out = sess.run_elastic(stream, ELASTIC_FAILURES)
        sync()
        launches = launch_counts()
        res["launches"].update(launches)
        res["elastic"] = {"out": keep(out),
                          "sizes": [m.size() for _, m in sess.mesh_history],
                          "seconds": time.perf_counter() - t0,
                          "launches": launches}
    if "scale" in parts:
        pol = shard_policy(torch, "r2evid", dev, force)
        for hier, mm in ((True, scale_m), (False, gather_m),
                         (False, scale_m)):
            bw_scale = SHARD_SCALE_BW * mm / sys_.total_bw_mbps
            big = sharded_cell(torch, dev, mm, scale_r, bw_scale)
            sess = ServeSession(pol, mm, device=dev, **SHARD_POOLS)

            def run():
                sess.reset()
                return sess.run_sharded(mesh, big, hierarchical=hier)
            out, launches, ex, secs = counted(run, scale_r)
            budget = bw_scale * sys_.total_bw_mbps
            draws = [float(pol.lat.solution_bandwidth(
                {k: out[k][t] for k in ("route", "r", "p", "v")}).sum())
                for t in range(scale_r)]
            if not all(d <= budget for d in draws):
                raise AssertionError(f"scale (hierarchical={hier}): C6 "
                                     f"draws {draws} over {budget}")
            run_rec = res["runs"]["scale", hier, mm] = {
                "streams": mm, "launches": launches, "exchanges": ex,
                "rounds_per_s": scale_r / secs, "budget": budget,
                "draw_per_stream": [d / mm for d in draws]}
            if not hier and mm == scale_m:       # held to the dense run
                run_rec["out"] = keep({k: out[k] for k in
                                       ("route", "r", "p", "v")})
    if dev.type == "cuda":
        res["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return res


def sharded_phase(torch, dev, counts_reset, counts_read):
    """Stream-sharded serving on the card (see the module doc).  Returns
    (the kernel launches of the counted runs, summed over the ranks, the
    phase's record)."""
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.core.router import enforce_bandwidth
    from repro_torch.launch.mesh import host_mesh, run_ranks, \
        single_rank_group
    from repro_torch.serving.scenarios import apply_scenario, compile_scenario
    from repro_torch.serving.session import ServeSession
    from repro_torch.serving.simulator import SimConfig
    from repro_torch.sharding.audit import round_footprint
    from repro_torch.sharding.collectives import COLLECTIVES

    stream = sharded_cell(torch, dev, M, ROUNDS)
    sizes = (M, ROUNDS, SHARD_SCALE_M, SHARD_SCALE_R, SHARD_GATHER_M)
    dec = ("route", "r", "p", "v")
    totals = collections.Counter()
    rec = {"phase": "sharded", "streams": M, "rounds": ROUNDS,
           "pools": SHARD_POOLS, "bw_scale": 0.5, "world1_nccl": {},
           "lpt_queue_pools": lpt_wide_check(torch, dev)}

    # world 1 on NCCL, in this process: captured, the dense run's bits
    dense = {}
    with single_rank_group("nccl"):
        mesh = host_mesh()
        for name in SHARD_POLICIES:
            obs = shard_obs(stream, name)
            pol = shard_policy(torch, name, dev)
            plain = ServeSession(pol, M, device=dev, **SHARD_POOLS)
            dense[name] = want = plain.run(obs)
            torch.cuda.synchronize()
            sessions = {"dense": plain}
            row = {}
            for hier in (False, True):
                mode = "hierarchical" if hier else "gathered"
                sess = sessions[mode] = ServeSession(
                    pol, M, device=dev, mesh=mesh, hierarchical=hier,
                    **SHARD_POOLS)
                counts_reset()
                start = len(COLLECTIVES)
                got = sess.run(obs)
                torch.cuda.synchronize()
                launches = counts_read()
                totals.update(launches)
                expect = {"lpt_queue": ROUNDS}
                if name == "r2evid":
                    expect.update(gate_cell=ROUNDS, ccg_solve=ROUNDS,
                                  c6_repair=ROUNDS)
                if launches != expect:
                    raise AssertionError(f"world 1 {name} {mode} launched "
                                         f"{launches}, want {expect}")
                (graph,) = sess.graphs.values()
                if graph.graph is None:
                    raise AssertionError(f"world 1 {name} {mode}: the NCCL "
                                         f"round was not captured")
                compare_to(torch, got, want, list(want), [],
                           f"world 1 {name} {mode} vs dense")
                row[mode] = {"launches": launches,
                             "lane_rounds_bitequal_vs_dense":
                                 got["route"].numel(),
                             "capture_s": graph.capture_s,
                             **round_footprint(COLLECTIVES[start:], ROUNDS)}
            secs = run_turns(torch, sessions, obs)
            for mode, s in secs.items():
                row.setdefault(mode, {})["rounds_per_s"] = ROUNDS / s
            if name == "r2evid":
                for mode in ("gathered", "hierarchical", "dense"):
                    prof = trace_round(torch, sessions[mode], obs, secs[mode],
                                       host=False)
                    row[mode]["trace"] = {k: prof[k] for k in (
                        "device_busy_ms_per_round",
                        "device_activities_per_round", "device_idle_share",
                        "kernel_launches_per_round")}
            rec["world1_nccl"][name] = row
        # the rounds' graphs hold the group's communicator: free them
        # before the group goes
        del sessions, sess, plain
        gc.collect()
    dense_cpu = {k: {n: v.cpu() for n, v in out.items()}
                 for k, out in dense.items()}

    # world 4 on the one card over gloo, uncaptured
    t0 = time.perf_counter()
    ranks = run_ranks(sharded_rank, SHARD_WORLD, backend="gloo", timeout=600,
                      threads=2, args=("cuda", "auto", (
                          "policies", "churn", "repair", "elastic", "scale"),
                          sizes))
    rec["world4_gloo_seconds"] = time.perf_counter() - t0
    # the same hierarchical run on the plain versions, on the CPU
    t0 = time.perf_counter()
    plain4 = run_ranks(sharded_rank, SHARD_WORLD, backend="gloo",
                       timeout=600, threads=2,
                       args=("cpu", "ref", ("hier_r2evid",), sizes))
    rec["world4_cpu_plain_seconds"] = time.perf_counter() - t0
    for res in ranks:
        totals.update(res["launches"])
        if res["rank"] == 0:
            continue
        for key, run in res["runs"].items():
            if "out" in run and run["out"] != digest(ranks[0]["runs"][key][
                    "out"]):
                raise AssertionError(f"world 4: rank {res['rank']} returned "
                                     f"other outputs of {key}")
    r0 = ranks[0]
    t = lambda arrays: {k: torch.from_numpy(v) for k, v in arrays.items()}
    w4 = {}
    for name in SHARD_POLICIES:
        want = dense_cpu[name]
        gathered = t(r0["runs"][name, False]["out"])
        hier = t(r0["runs"][name, True]["out"])
        same = [k for k in dec + ("tau", "accuracy", "energy") if k in want]
        row = {"gathered_max_rel_vs_dense": compare_to(
            torch, gathered, want, dec, ("delay", "energy", "cost",
                                         "accuracy"), f"world 4 {name}")}
        compare_to(torch, {k: hier[k] for k in same}, {k: want[k] for k in
                                                       same}, same, (),
                   f"world 4 {name} hierarchical")
        row["hierarchical_equal_to_dense"] = same
        for hier_mode in (False, True):
            run = r0["runs"][name, hier_mode]
            mode = "hierarchical" if hier_mode else "gathered"
            row[mode] = {k: run[k] for k in ("launches", "exchanges",
                                             "rounds_per_s")}
            if hier_mode and run["exchanges"]["max_elements"] > 4:
                raise AssertionError(f"world 4 {name}: a hierarchical round "
                                     f"exchanged {run['exchanges']}")
        w4[name] = row
    # hierarchical delay and cost: the plain path's 4-rank run
    card = t(r0["runs"]["r2evid", True]["out"])
    ref = t(plain4[0]["runs"]["r2evid", True]["out"])
    same = torch.ones_like(card["route"], dtype=torch.bool)
    for k in dec:
        same &= card[k] == ref[k]
    rounds_eq = same.all(dim=1)
    agree = float(same.double().mean())
    if agree < 0.999 or not bool(rounds_eq.any()):
        raise AssertionError(f"world 4 hierarchical: kernels vs plain "
                             f"decisions agree on {agree}")
    w4["r2evid"]["hierarchical_vs_plain_cpu"] = {
        "decision_agreement": agree, "rounds_compared": int(rounds_eq.sum()),
        **compare_to(torch, {k: card[k][rounds_eq] for k in ("delay", "cost")},
                     {k: ref[k][rounds_eq] for k in ("delay", "cost")}, (),
                     ("delay", "cost"), "world 4 hierarchical vs plain")}
    rec["world4_gloo"] = w4

    # churn: the slot pool's bookkeeping exact against the dense run
    trace = compile_scenario("churn", SystemConfig(),
                             SimConfig(n_tasks=M, seed=0), ROUNDS, seed=1)
    pol = shard_policy(torch, "r2evid", dev)
    churn_dense = ServeSession(pol, M, device=dev, admission=trace.admission,
                               **SHARD_POOLS).run(apply_scenario(stream,
                                                                 trace))
    churn_keys = ("alive", "queue_depth", "admitted", "dropped")
    rec["churn"] = {}
    for hier in (False, True):
        got = t(r0["runs"]["churn", hier]["out"])
        for k in churn_keys + (dec if not hier else ()):
            if not torch.equal(got[k], churn_dense[k].cpu()):
                raise AssertionError(f"churn (hierarchical={hier}): {k} "
                                     f"differs from dense")
        rec["churn"]["hierarchical" if hier else "gathered"] = {
            "admitted": int(got["admitted"].sum()),
            "dropped": int(got["dropped"].sum()),
            "rounds_per_s": r0["runs"]["churn", hier]["rounds_per_s"]}

    # repair_local where it must demote: the reference's case at the cell
    rep = [res["repair"]["cell"] for res in ranks]
    budget = rep[0]["budget"]
    lat = pol.lat
    sys_ = SystemConfig()
    sol, z, aq = inflated_case(torch, M, dev)
    dense_fix, _ = enforce_bandwidth(lat, sol, z, aq, total_budget=budget,
                                     rounds=64)
    hier_fix = dict(sol, r=torch.from_numpy(np.concatenate(
        [x["r"] for x in rep])).to(dev), p=torch.from_numpy(np.concatenate(
            [x["p"] for x in rep])).to(dev))
    depth = lambda s: (sys_.n_res - 1 - s["r"]) + (sys_.n_fps - 1 - s["p"])
    gap = int((depth(dense_fix) - depth(hier_fix)).abs().max())
    draw = float(lat.solution_bandwidth(hier_fix).sum())
    if draw > budget + 1e-3 or gap > 1 or not all(
            x["draw"] <= x["target"] + 1e-3 for x in rep) or \
            int(depth(hier_fix).sum()) == 0:
        raise AssertionError(f"repair_local: draw {draw} vs budget {budget}, "
                             f"gap {gap}, shards {rep}")
    rec["repair_local"] = {"budget": budget, "draw": draw,
                           "max_level_gap_vs_dense": gap,
                           "demotions": int(depth(hier_fix).sum()),
                           "shard_draw_vs_target": [
                               (x["draw"], x["target"]) for x in rep]}
    # and the skewed case at 16,384 streams a rank: the shards under their
    # fair share keep their draw and grant the rest to the two over it,
    # which demote to targets above the fair share
    rep = [res["repair"]["scale"] for res in ranks]
    budget = rep[0]["budget"]
    fair = budget / len(rep)
    over = [x["draw_before"] > fair for x in rep]
    total = sum(x["target"] for x in rep)
    bad = [r for r, x in enumerate(rep)
           if x["draw"] > x["target"] + 1e-3
           or (x["demotions"] > 0) != over[r]
           or (over[r] and not x["target"] > fair)
           or (not over[r] and x["target"] != x["draw_before"])]
    if bad or over != [True, True, False, False] or \
            abs(total - budget) > 1e-5 * budget or \
            sum(x["draw"] for x in rep) > budget:
        raise AssertionError(f"repair_local at {SHARD_SCALE_M}: shards {bad}"
                             f" of {rep}, targets sum to {total} of {budget}")
    rec["repair_local_scale"] = {
        "streams": SHARD_SCALE_M, "budget": budget, "fair_share": fair,
        "draw": sum(x["draw"] for x in rep),
        "shards": [{k: x[k] for k in ("draw_before", "target", "draw",
                                      "demotions")} for x in rep]}

    # run_elastic 4 → 3 → 2 against the dense run
    el = r0["elastic"]
    if el["sizes"] != [4, 3, 2]:
        raise AssertionError(f"run_elastic meshes {el['sizes']}")
    rec["elastic"] = {
        "failures": {str(k): v for k, v in ELASTIC_FAILURES.items()},
        "mesh_sizes": el["sizes"], "seconds": el["seconds"],
        "launches": el["launches"],
        "max_rel_vs_dense": compare_to(
            torch, t(el["out"]), dense_cpu["r2evid"], dec,
            ("delay", "energy", "cost", "accuracy", "tau"),
            "run_elastic vs dense")}
    for res in ranks[1:]:
        if res["elastic"]["out"] != digest(el["out"]):
            raise AssertionError(f"run_elastic: rank {res['rank']} returned "
                                 f"other outputs")

    # scale: 16,384 streams a rank; the gathered run at that M held to the
    # dense run of the same cell on this process's card
    scale = {label: r0["runs"][("scale",) + key] for label, key in (
        ("hierarchical", (True, SHARD_SCALE_M)),
        ("gathered", (False, SHARD_GATHER_M)),
        ("gathered_at_hierarchical_m", (False, SHARD_SCALE_M)))}
    if scale["hierarchical"]["exchanges"]["max_elements"] > 4:
        raise AssertionError(f"scale: hierarchical exchanges "
                             f"{scale['hierarchical']['exchanges']}")
    bw_scale = SHARD_SCALE_BW * SHARD_SCALE_M / SystemConfig().total_bw_mbps
    dense_big = ServeSession(shard_policy(torch, "r2evid", dev), SHARD_SCALE_M,
                             device=dev, **SHARD_POOLS).run(sharded_cell(
                                 torch, dev, SHARD_SCALE_M, SHARD_SCALE_R,
                                 bw_scale))
    compare_to(torch, t(scale["gathered_at_hierarchical_m"].pop("out")),
               {k: dense_big[k].cpu() for k in dec}, dec, (),
               f"gathered at {SHARD_SCALE_M} vs dense")
    del dense_big
    rec["scale"] = {"streams": SHARD_SCALE_M, "rounds": SHARD_SCALE_R,
                    "bw_mbps_per_stream": SHARD_SCALE_BW,
                    "c6_held_rounds": SHARD_SCALE_R,
                    "gathered_at_hierarchical_m_equal_to_dense": list(dec),
                    **{label: {k: run[k] for k in (
                        "streams", "rounds_per_s", "exchanges", "launches",
                        "budget", "draw_per_stream")}
                       for label, run in scale.items()}}
    rec["peak_memory_bytes_by_rank"] = [res.get("peak_memory_bytes")
                                        for res in ranks]
    n_cards = torch.cuda.device_count()
    rec["nccl_multi_card"] = "not run: one card" if n_cards < 2 else \
        nccl_multi_card(torch, n_cards, dense_cpu["r2evid"], totals, sizes)
    return totals, rec


def nccl_multi_card(torch, n_cards, dense, totals, sizes) -> dict:
    """One rank a card on NCCL, gate-mode R2E-VID in both modes, against
    the dense run."""
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(sharded_rank, n_cards, backend="nccl", timeout=600,
                      threads=2, args=("cuda", "auto", ("hier_r2evid",),
                                       sizes))
    for res in ranks:
        totals.update(res["launches"])
    out = {k: torch.from_numpy(v) for k, v in
           ranks[0]["runs"]["r2evid", True]["out"].items()}
    compare_to(torch, {k: out[k] for k in dense}, dense,
               ("route", "r", "p", "v", "tau"), ("accuracy", "energy"),
               "multi-card hierarchical")
    return {"world": n_cards, "seconds": time.perf_counter() - t0,
            "rounds_per_s": ranks[0]["runs"]["r2evid", True]["rounds_per_s"]}


def trace_round(torch, sess, stream, untraced_s: float,
                rounds: int = ROUNDS, host: bool = True) -> dict:
    """Where the time goes: one profiled run of ``rounds`` rounds of the
    main path (or of a scenario's run), the session reset first.

    Device busy time is the sum of the trace's device activities (kernels,
    copies, fills); the idle share compares it with the untraced run's wall
    time, since the profiler slows the host.  Copies from the device to the
    host would be syncs of the round loop: their count is reported.
    ``host=False`` traces the device alone (a cheaper trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sess.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        # idle host time on both sides of the run: a trace without it now
        # and then lost a run's last rounds (tools/trace_window.py)
        t_open = time.perf_counter()
        time.sleep(TRACE_PAD_S)
        t0 = time.perf_counter()
        sess.run(stream)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        time.sleep(TRACE_PAD_S)
    traced_s = t1 - t0
    ends = [e.time_range.end for e in prof.events()
            if e.device_type == DeviceType.CUDA]
    acts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in acts) / 1e3
    # each ported kernel's symbol and the wrapper that launches it
    ours = {"gate_cell_kernel": "gate_cell",
            "gate_cell_bwd_kernel": "gate_cell_bwd",
            "ccg_solve_kernel": "ccg_solve", "c6_tail_kernel": "c6_tail",
            "c6_repair_kernel": "c6_repair",
            "c6_repair_cluster_kernel": "c6_repair",
            "lpt_queue_kernel": "lpt_queue",
            "lpt_queue_chunked_kernel": "lpt_queue"}
    # gate_cell_bwd's second kernel (its ordered sum over tiles) counts in
    # the time, not in the launches (one a wrapper call, as the wrappers')
    ours_ms = sum(e.self_device_time_total for e in acts
                  if any(k in e.key for k in
                         (*ours, "gate_cell_bwd_reduce_kernel"))) / 1e3
    top = sorted(acts, key=lambda e: -e.self_device_time_total)[:8]
    launches = collections.Counter()
    for k, name in ours.items():
        n = sum(e.count for e in acts if k in e.key)
        if n:
            launches[name] += n
    launches = dict(launches)
    return {
        "phase": "trace", "rounds": rounds,
        "device_busy_ms_per_round": busy_ms / rounds,
        "untraced_ms_per_round": untraced_s * 1e3 / rounds,
        "traced_ms_per_round": traced_s * 1e3 / rounds,
        "device_idle_share": 1.0 - busy_ms / (untraced_s * 1e3),
        "device_activities_per_round": sum(e.count for e in acts) / rounds,
        "dtoh_copies_per_round": sum(e.count for e in acts
                                     if "DtoH" in e.key) / rounds,
        "htod_copies_per_round": sum(e.count for e in acts
                                     if "HtoD" in e.key) / rounds,
        "ported_kernels_share_of_busy": ours_ms / busy_ms if busy_ms else None,
        # the profiler's own count of the ported kernels: the witness of
        # the wrappers' counters (a replay makes no wrapper call)
        "kernel_launches": launches,
        # µs between the last device activity's end and the run's final
        # synchronize (the trace's clock from the window's opening): a
        # trace that lost its last rounds ends them early
        "last_device_before_run_end_us":
            (t1 - t_open) * 1e6 - max(ends) if ends else None,
        "kernel_launches_per_round": {k: n / rounds
                                      for k, n in launches.items()},
        "top_device_time": [
            {"name": e.key[:90], "ms_per_round":
             e.self_device_time_total / 1e3 / rounds,
             "per_round": e.count / rounds} for e in top],
    }


# flash_attention_bwd: |kernel - plain| / max(1, max |plain|) of each of dq,
# dk and dv (bf16: Δ = rowsum(dO∘O) reads the bf16-rounded output)
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-5}


def flash_bwd_work(b: int, h: int, kv: int, sq: int, sk: int, d: int,
                   pairs: float):
    """(bytes, operations) of the attention's bf16 backward: q, o, dO read and
    dq written (B·H·Sq·D each), k, v read and dk, dv written (B·KV·Sk·D
    each), once; five products over the visible (query, key) pairs of
    every head (S = Q·Kᵀ again, dP = dO·Vᵀ, dV = Pᵀ·dO, dQ = dS·K,
    dK = dSᵀ·Q), 2·D operations a pair each.  ``pairs``: visible pairs
    summed over the batch rows, per head."""
    nbytes = 2 * 4 * d * (b * h * sq + b * kv * sk)
    return float(nbytes), float(5 * 2 * d * h * pairs)


def variants_tool():
    """``tools/kernel_variants.py``, loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "kernel_variants", ROOT / "tools" / "kernel_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def start_first_design_build():
    """nvcc of flash_attention_bwd's first design (bf16 on the CUDA cores at
    every D: ``tools/kernel_variants.py``'s ``first_design`` edit of the
    committed source) into ``build/first_design/``, started beside the
    library's build -> (shared library path, the running nvcc)."""
    from repro_torch.kernels import _build

    tool = variants_tool()
    out = ROOT / "build" / "first_design"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "flash_attention_bwd_first_design.cu"
    cu.write_text(tool.variants("flash_attention_bwd", (
        _build.CSRC / "flash_attention_bwd.cu").read_text())["first_design"])
    so = cu.with_suffix(".so")
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", "-o", str(so), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(proc.kill)      # a failed run leaves no nvcc behind
    return so, proc


def first_design_library(first_design):
    """The kernel library with flash_attention_bwd's entry point taken from
    the first design's build (waited for here)."""
    import ctypes

    from repro_torch.kernels import _build

    so, proc = first_design
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the first design:\n{log}")
    entry = "flash_attention_bwd_launch"
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = _build._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return variants_tool().Library(_build.library(), entry, fn,
                                   "first_design")


def flash_bwd_row(torch, dev, first_design):
    """flash_attention_bwd against attention_vjp_ref on the card: the
    training shape of Qwen1.5-0.5B (B 8, S 512, H = KV 16, D 64), Qwen3-8B's
    GQA (H 32 / KV 8, D 128), RecurrentGemma's D = 256 with a window of 128
    at S = 512, Qwen2-VL's runtime positions and a non-causal case, each in
    bf16 and float32, every gradient within BWD_TOL of max(1, its largest
    |entry|), two launches bit-equal, the LSE of the forward's training
    launch (whose output must equal the serving launch's bit for bit)
    given and the wrapper's own bit-equal; timed at the training shape and
    at Qwen3-8B's with that LSE given (the profiler's device time of both
    kernels, CUDA events around the call, the plain version, autograd
    through SDPA as the yardstick, and the first design, built from the
    same source by ``start_first_design_build``, in turns)."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import (
        bwd_design,
        flash_attention,
        flash_attention_bwd,
    )
    from repro_torch.kernels.flash_attention.ref import attention_vjp_ref
    from repro_torch.models.layers import mrope_positions

    gen = torch.Generator(dev).manual_seed(12)

    def case(cfg, b, s, dtype, **kw):
        """(q, k, v, o, dO) as (B, S, heads, D) projections read through
        permuted views, o the forward kernel's training launch (checked
        against its serving launch), and its LSE."""
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        n = lambda heads: torch.randn((b, s, heads, d), generator=gen,
                                      device=dev).to(dtype).transpose(1, 2)
        q, k, v, do = n(h), n(kv), n(kv), n(h)
        o, lse = flash_attention(q, k, v, force="kernel", return_lse=True,
                                 **kw)
        if not torch.equal(o, flash_attention(q, k, v, force="kernel", **kw)):
            raise AssertionError("flash_attention: the training launch's "
                                 "output differs from the serving launch's")
        return (q, k, v, o, do), kw, lse

    tiers = {name: get_config(name) for name in (
        "qwen1.5-0.5b", "qwen3-8b", "recurrentgemma-9b", "qwen2-vl-2b")}
    vl = mrope_positions(16, (2, 4, 4), 32, 8, dev)[:, 0]       # S = 80
    shapes = {
        "qwen1.5-0.5b train": ("qwen1.5-0.5b", 8, 512, {}),
        "qwen3-8b gqa": ("qwen3-8b", 2, 512, {}),
        "recurrentgemma d256 window 128": ("recurrentgemma-9b", 2, 512,
                                           {"window": 128}),
        "qwen2-vl positions": ("qwen2-vl-2b", 8, 80, {"positions": vl}),
        "non-causal": ("qwen3-8b", 2, 80, {"causal": False}),
    }
    rel = {"bfloat16": 0.0, "float32": 0.0}
    abs_err = dict(rel)
    designs = {}
    for name, (tier, b, s, kw) in shapes.items():
        for dt in (torch.bfloat16, torch.float32):
            args, kw, lse = case(tiers[tier], b, s, dt, **kw)
            key = str(dt)[6:]
            designs[f"{name} {key}"] = bwd_design(dt, tiers[tier].head_dim)
            got = flash_attention_bwd(*args, force="kernel", lse=lse, **kw)
            again = flash_attention_bwd(*args, force="kernel", lse=lse, **kw)
            own = flash_attention_bwd(*args, force="kernel", **kw)
            q, k, v, _, do = args
            want = attention_vjp_ref(q, k, v, do, **kw)
            torch.cuda.synchronize()
            for g, a, c, w, what in zip(got, again, own, want, "qkv"):
                if not (torch.equal(g, a) and torch.equal(g, c)):
                    raise AssertionError(f"flash_attention_bwd ({name}, "
                                         f"{key}): two launches (the LSE "
                                         f"given or its own) differ in "
                                         f"d{what}")
                err = float((g.double() - w.double()).abs().max())
                r = err / max(1.0, float(w.abs().max()))
                if not r <= BWD_TOL[key]:
                    raise AssertionError(
                        f"flash_attention_bwd ({name}, {key}): d{what} "
                        f"kernel vs plain {r} of max(1, max |plain|) > "
                        f"{BWD_TOL[key]}")
                rel[key], abs_err[key] = max(rel[key], r), max(abs_err[key],
                                                               err)
    del got, again, own, want
    earlier = first_design_library(first_design)

    def timed(tier, b, s):
        cfg = tiers[tier]
        h, kv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        args, _, lse = case(cfg, b, s, torch.bfloat16)
        q, k, v, _, do = args
        call = lambda: flash_attention_bwd(*args, force="kernel", lse=lse)
        library_fn = _build.library

        def first():
            _build.library = lambda: earlier
            try:
                return call()
            finally:
                _build.library = library_fn

        def library():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                 enable_gqa=True)
            return torch.autograd.grad(out, leaves, do)

        events = event_ms_turns(torch, {"call": call, "library": library,
                                        "first_design": first}, reps=20)
        ms_dev = device_ms(torch, call)
        forward_ms = device_ms(torch, lambda: flash_attention(
            q, k, v, force="kernel", return_lse=True),
            "flash_attention_kernel")
        library_dev = device_ms(torch, library)
        nbytes, flops = flash_bwd_work(b, h, kv, s, s, d, b * s * (s + 1) / 2)
        t_bound, by = bound(nbytes, flops, BF16_FLOP_PER_S)
        return {"ms": ms_dev if ms_dev is not None else events["call"],
                "ms_from": "profiler (both kernels of a call)"
                if ms_dev is not None else "cuda_events",
                "ms_by_kernel": {k: device_ms(torch, call, k) for k in (
                    "fa_bwd_dq_kernel", "fa_bwd_dkv_kernel")},
                "design": bwd_design(q.dtype, d),
                "call_ms": events["call"],
                "earlier_ms": device_ms(torch, first),
                "earlier_call_ms": events["first_design"],
                "earlier_design": "cuda_cores (the first design: float32 "
                                  "multiply-adds, statistics recomputed)",
                "plain_ms": event_ms(torch, lambda: attention_vjp_ref(
                    q, k, v, do), reps=5, warmup=1),
                "library_ms": events["library"],
                "library_device_ms": library_dev,
                "forward_ms": forward_ms,
                "forward_plus_backward_ms": forward_ms + ms_dev
                if None not in (forward_ms, ms_dev) else None,
                "bytes": nbytes, "flops": flops, "bound_ms": t_bound,
                "bound_by": by,
                "shape": f"B={b} Sq=Sk={s} H={h} KV={kv} D={d} causal bf16"}

    row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "none: port-only, the backward of "
                    "src/repro/kernels/flash_attention/kernel.py:92, whose "
                    "gradient the reference takes of its jnp "
                    "chunked_attention (src/repro/models/attention.py:"
                    "285-291)",
        "max_abs_err": abs_err["bfloat16"],
        "max_abs_err_float32": abs_err["float32"],
        "max_err_of_largest": rel["bfloat16"],
        "max_err_of_largest_float32": rel["float32"],
        "tolerance": "|kernel - plain| <= 2e-2 (bf16) / 1e-5 (float32) of "
                     "max(1, each gradient's largest |entry|)",
        "cases_compared": 2 * len(shapes), "cases": list(shapes),
        "design_by_case": designs,
        "two_launches_bitequal": True,
        "training_launch_output_bitequal": True,
        **timed("qwen1.5-0.5b", 8, 512),
        "library_call": "torch.autograd.grad through torch.nn.functional."
                        "scaled_dot_product_attention(is_causal=True, "
                        "enable_gqa=True), its forward included",
    }
    row["qwen3-8b"] = timed("qwen3-8b", 2, 512)
    return row


TRAIN_TOL = {"loss": 1e-2, "grad_norm": 5e-2}   # kernels vs plain, relative
RESUME_TOL = 1e-2         # resumed losses vs the uninterrupted run, relative


def train_phase(torch, dev, counts_reset, counts_read, steps: int = 10):
    """Training Qwen1.5-0.5B at full width and depth (24 layers, bf16
    compute over float32 masters, remat) on ``TokenPipeline`` batches of
    8 × 512 through ``Trainer``: step 1's loss and gradient norm on the
    kernels and on the plain versions (the same parameters and batch);
    ``steps`` steps of ``Trainer.run``, launch counters zeroed just before
    and read just after (flash_attention twice a layer and step, the
    forward and its recomputation, flash_attention_bwd once), each step's
    wall time, the peak device memory; one profiled step; a run that
    fails at step 7 (``FailureInjector``) after its checkpoint at step 5,
    resumed by a fresh trainer from that checkpoint to step ``steps``, its
    losses against the uninterrupted run's; last, a wrapper without a
    backward (decode_attention) given an input that needs a gradient must
    raise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.models.layers import Ctx
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import count_params
    from repro_torch.runtime.cluster import FailureInjector
    from repro_torch.train.optimizer import AdamWConfig, global_norm
    from repro_torch.train.trainer import (
        NodeFailure,
        TrainConfig,
        Trainer,
        grads_of,
    )

    cfg = get_config("qwen1.5-0.5b")
    b, s = 8, 512
    root = ROOT / "build" / "train_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    free_device_memory(torch)
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps)

    def trainer(name, ckpt_every, injector=None):
        return Trainer(cfg, TrainConfig(
            steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(root / name),
            ckpt_keep=1, log_every=1, opt=opt), device=dev,
            failure_injector=injector)

    def data(skip=0):
        it = iter(TokenPipeline(cfg.vocab_size, s, b, seed=0))
        for _ in range(skip):
            next(it)
        return it

    def init(tr):
        return tr.init_state(torch.Generator(dev).manual_seed(0))

    # step 1: loss and gradient norm, kernels against plain on the card
    tr = trainer("a", ckpt_every=steps + 1)
    state = init(tr)
    batch = tr._device_batch(next(data()))
    first = {}
    for path, force in (("kernels", "auto"), ("plain", "ref")):
        loss, _, grads = grads_of(Ctx(cfg=cfg, mode="train", force=force),
                                  state[0], batch)
        first[path] = {"loss": float(loss),
                       "grad_norm": float(global_norm(grads))}
        del grads
    gaps = {k: abs(first["kernels"][k] - first["plain"][k])
            / abs(first["plain"][k]) for k in TRAIN_TOL}
    for k, tol in TRAIN_TOL.items():
        if not (math.isfinite(first["kernels"][k]) and gaps[k] <= tol):
            raise AssertionError(f"train: step 1 {k} kernels "
                                 f"{first['kernels'][k]} vs plain "
                                 f"{first['plain'][k]} (relative {gaps[k]} "
                                 f"> {tol})")

    # the uninterrupted run: each step's wall time is the time between the
    # trainer's batch requests (it reads each step's loss back to log it)
    stamps = []

    def stamped(it):
        for item in it:
            stamps.append(time.perf_counter())
            yield item

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_reset()
    state, hist = tr.run(stamped(data()), state=state)
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    launches = counts_read()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_attention": 2 * cfg.num_layers * steps,
            "flash_attention_bwd": cfg.num_layers * steps}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, want {want}")
    losses = [h["loss"] for h in hist]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"train: losses {losses}")
    step_ms = [(t1 - t0) * 1e3 for t0, t1 in zip(stamps, stamps[1:])]
    median_ms = statistics.median(step_ms[1:])

    # one profiled step (the run's state, the next batch)
    params, opt_state, err = state
    nxt = tr._device_batch(next(data(steps)))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        params, opt_state, err, _ = tr._step(params, opt_state, err, nxt)
        torch.cuda.synchronize()
    acts = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in acts) / 1e3
    group = lambda *keys: sum(e.self_device_time_total for e in acts
                              if any(k in e.key for k in keys)) / 1e3
    profiled = {
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / median_ms,
        "device_activities": sum(e.count for e in acts),
        # the symbols' prefixes name both designs' kernels (the tensor-core
        # fa_bwd_dq_kernel_mma / fa_bwd_dkv_kernel_mma at bf16 D 64)
        "flash_attention_bwd_ms": group("fa_bwd_dq_kernel",
                                        "fa_bwd_dkv_kernel"),
        "flash_attention_bwd_ms_by_kernel": {
            k: group(k) for k in ("fa_bwd_dq_kernel", "fa_bwd_dkv_kernel")},
        "flash_attention_ms": group("flash_attention_kernel"),
        "top_device_time": [
            {"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
             "count": e.count}
            for e in sorted(acts, key=lambda e: -e.self_device_time_total)[:8]],
    }
    del state, params, opt_state, err, nxt
    free_device_memory(torch)

    # a failure at step 7 after the checkpoint at step 5; a fresh trainer
    # resumes from it and runs to the end
    tb = trainer("b", ckpt_every=5,
                 injector=FailureInjector(schedule={7: "node lost"}))
    t0 = time.perf_counter()
    try:
        tb.run(data(), state=init(tb))
        raise AssertionError("train: the injected failure did not fire")
    except NodeFailure:
        pass
    failed_s = time.perf_counter() - t0
    if tb.step != 7 or tb.ckpt.latest_step() != 5:
        raise AssertionError(f"train: failed at {tb.step}, checkpoint "
                             f"{tb.ckpt.latest_step()}")
    ckpt_gb = sum(f.stat().st_size for f in (root / "b").rglob("*")
                  if f.is_file()) / 1e9
    free_device_memory(torch)
    tc = trainer("b", ckpt_every=steps + 1)
    t0 = time.perf_counter()
    resumed_state = tc.maybe_restore(init(tc))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if tc.step != 5:
        raise AssertionError(f"train: resumed at step {tc.step}, not 5")
    _, resumed = tc.run(data(5), n_steps=steps - 5, state=resumed_state)
    del resumed_state
    resumed_losses = [h["loss"] for h in resumed]
    resume_gap = max(abs(a - b_) / abs(b_) for a, b_ in
                     zip(resumed_losses, losses[5:]))
    if [h["step"] for h in resumed] != list(range(6, steps + 1)) \
            or not resume_gap <= RESUME_TOL:
        raise AssertionError(f"train: resumed losses {resumed_losses} vs "
                             f"{losses[5:]} (relative {resume_gap})")
    shutil.rmtree(root, ignore_errors=True)
    free_device_memory(torch)

    # a kernel without a backward under autograd raises
    raised = {}
    q = torch.zeros((2, 8, 64), device=dev, requires_grad=True)
    kv = torch.zeros((2, 2, 16, 64), device=dev)
    try:
        decode_attention(q, kv, kv, torch.full((2,), 4, device=dev))
        raise AssertionError("train: decode_attention took a grad input")
    except NotImplementedError as e:
        raised["decode_attention"] = str(e)

    n_params = count_params(model_specs(cfg))
    tokens = b * s
    pairs = b * s * (s + 1) / 2
    model_flops = (6 * (n_params - cfg.vocab_size * cfg.d_model) * tokens
                   + 12 * cfg.num_layers * cfg.num_heads * cfg.head_dim
                   * pairs)
    return launches, {
        "phase": "train", "arch": cfg.name, "batch": b, "seq": s,
        "compute_dtype": cfg.compute_dtype, "params": n_params,
        "steps": steps, "losses": losses, "step_ms": step_ms,
        "step_ms_median": median_ms, "tokens_per_s": tokens / median_ms * 1e3,
        "model_flops_per_step": model_flops,
        "model_flop_share": model_flops / (median_ms / 1e3)
        / BF16_FLOP_PER_S,
        "peak_memory_gb": peak_gb, "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "step1": first, "step1_relative_gaps": gaps,
        "step1_tolerance": TRAIN_TOL, "profiled_step": profiled,
        "resume": {"failed_at": 7, "checkpoint_step": 5,
                   "checkpoint_gb": ckpt_gb, "run_to_failure_s": failed_s,
                   "restore_s": restore_s, "losses": resumed_losses,
                   "max_relative_gap": resume_gap,
                   "tolerance": RESUME_TOL},
        "raised": raised,
    }


# the recurrent models trained at full width: (arch, layers kept)
RECURRENT_TRAIN = (("falcon-mamba-7b", 8), ("recurrentgemma-9b", 3))
SCAN_KERNELS = {"ssm": "mamba_scan", "rglru": "rglru_scan"}


def train_recurrent_phase(torch, dev, counts_reset, counts_read,
                          steps: int = 6):
    """Training the recurrent families at full width on a cut of their
    layers (``RECURRENT_TRAIN``: Falcon-Mamba-7B at 8 of its 64 Mamba
    layers, RecurrentGemma-9B at 3 of its 38, one whole (rglru, rglru,
    attn) pattern), bf16 compute over float32 masters and AdamW state,
    remat, through ``Trainer`` on ``TokenPipeline`` batches of 8 × 512:
    step 1's loss and gradient norm on the kernels (the scans' training
    launches and backward kernels, the attention's) against the plain
    versions (plain scans and plain VJPs) within TRAIN_TOL; ``steps``
    steps of ``Trainer.run`` with the launch counters zeroed just before
    and read just after (each recurrent layer's scan twice a step, the
    forward and its recomputation, its backward kernel once; each
    attention layer's flash_attention twice and flash_attention_bwd once),
    finite losses, each step's wall time, tokens/s, the peak device
    memory; one profiled step with each kernel's device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.models.layers import Ctx
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import count_params
    from repro_torch.train.optimizer import AdamWConfig, global_norm
    from repro_torch.train.trainer import TrainConfig, Trainer, grads_of

    b, s = 8, 512
    root = ROOT / "build" / "train_recurrent_ckpt"
    total = collections.Counter()
    models = {}
    for arch, layers in RECURRENT_TRAIN:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        free_device_memory(torch)
        tr = Trainer(cfg, TrainConfig(
            steps=steps, ckpt_every=steps + 1, ckpt_dir=str(root / arch),
            log_every=1, opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                         total_steps=steps)), device=dev)
        state = tr.init_state(torch.Generator(dev).manual_seed(0))
        data = lambda: iter(TokenPipeline(cfg.vocab_size, s, b, seed=0))
        batch = tr._device_batch(next(data()))
        first = {}
        for path, force in (("kernels", "auto"), ("plain", "ref")):
            t0 = time.perf_counter()
            loss, _, grads = grads_of(Ctx(cfg=cfg, mode="train", force=force),
                                      state[0], batch)
            first[path] = {"loss": float(loss),
                           "grad_norm": float(global_norm(grads)),
                           "seconds": time.perf_counter() - t0}
            del grads
        gaps = {k: abs(first["kernels"][k] - first["plain"][k])
                / abs(first["plain"][k]) for k in TRAIN_TOL}
        for k, tol in TRAIN_TOL.items():
            if not (math.isfinite(first["kernels"][k]) and gaps[k] <= tol):
                raise AssertionError(
                    f"train_recurrent: {arch} step 1 {k} kernels "
                    f"{first['kernels'][k]} vs plain {first['plain'][k]} "
                    f"(relative {gaps[k]} > {tol})")

        stamps = []

        def stamped(it):
            for item in it:
                stamps.append(time.perf_counter())
                yield item

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts_reset()
        state, hist = tr.run(stamped(data()), state=state)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        launches = counts_read()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        kinds = collections.Counter(cfg.layer_kinds())
        want = collections.Counter()
        for kind, scan in SCAN_KERNELS.items():
            if kinds[kind]:
                want[scan] = 2 * kinds[kind] * steps
                want[f"{scan}_bwd"] = kinds[kind] * steps
        if kinds["attn"]:
            want["flash_attention"] = 2 * kinds["attn"] * steps
            want["flash_attention_bwd"] = kinds["attn"] * steps
        if launches != dict(want):
            raise AssertionError(f"train_recurrent: {arch} launches "
                                 f"{launches}, want {dict(want)}")
        total.update(launches)
        losses = [h["loss"] for h in hist]
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"train_recurrent: {arch} losses {losses}")
        step_ms = [(t1 - t0) * 1e3 for t0, t1 in zip(stamps, stamps[1:])]
        median_ms = statistics.median(step_ms[1:])

        params, opt_state, err = state
        nxt = tr._device_batch(next(iter(TokenPipeline(
            cfg.vocab_size, s, b, seed=1))))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, opt_state, err, _ = tr._step(params, opt_state, err, nxt)
            torch.cuda.synchronize()
        acts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in acts) / 1e3
        group = lambda key: sum(e.self_device_time_total for e in acts
                                if key in e.key) / 1e3
        models[arch] = {
            "layers": layers, "layers_of_config": get_config(arch).num_layers,
            "layer_kinds": dict(kinds), "params": count_params(
                model_specs(cfg)), "batch": b, "seq": s,
            "compute_dtype": cfg.compute_dtype, "steps": steps,
            "losses": losses, "step_ms": step_ms, "step_ms_median": median_ms,
            "tokens_per_s": b * s / median_ms * 1e3,
            "peak_memory_gb": peak_gb, "launches": launches,
            "launches_per_step": {k: n / steps for k, n in launches.items()},
            "step1": first, "step1_relative_gaps": gaps,
            "step1_tolerance": TRAIN_TOL,
            "profiled_step": {
                "device_busy_ms": busy_ms,
                "device_idle_share": 1.0 - busy_ms / median_ms,
                "device_activities": sum(e.count for e in acts),
                "ported_kernels_ms": sum(group(k)
                                         for k in PORTED_MODEL_KERNELS),
                "kernel_ms": {k: group(k) for k in PORTED_MODEL_KERNELS
                              if group(k) > 0},
                "top_device_time": [
                    {"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                     "count": e.count}
                    for e in sorted(acts, key=lambda e:
                                    -e.self_device_time_total)[:8]]},
        }
        del state, params, opt_state, err, nxt, batch, tr
        shutil.rmtree(root, ignore_errors=True)
    free_device_memory(torch)
    return dict(total), {"phase": "train_recurrent", "models": models,
                         "launches": dict(total)}


# training across ranks: Qwen1.5-0.5B at full size, 8 × 512 global batches
RANKS_STEPS = 4
RANKS_TOL = 1e-3          # a bf16 loss on another mesh, relative
# (c)'s losses against (b)'s, relative: the CPU tests hold float32 runs to
# 1e-5, but in bf16 one rank's weight gradients over 8 rows round otherwise
# than two ranks' over 4 rows each, summed in float32 (2.0e-5 measured on
# an H100 at step 4); 5 times that reading
SURVIVOR_TOL = 1e-4
PIPE = {"stages": 2, "layers": 8, "width": 1024, "microbatches": 8,
        "rows": 64, "tol": 1e-5}


def ranks_setup():
    """The config, optimizer and batches of the ``train_ranks`` phase."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config("qwen1.5-0.5b")
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=RANKS_STEPS)
    it = iter(TokenPipeline(cfg.vocab_size, 512, 8, seed=0))
    return cfg, opt, [next(it) for _ in range(RANKS_STEPS)]


def state_leaves(state) -> dict:
    """{"params/..." / "mu/..." / "nu/...": tensor} of a trainer state."""
    from repro_torch.checkpoint.manager import _flatten

    params, opt_state, _ = state
    return {f"{name}{path}": t
            for name, tree in (("params", params), ("mu", opt_state.mu),
                               ("nu", opt_state.nu))
            for path, t in _flatten(tree)}


def tensor_digest(torch, t) -> str:
    import hashlib

    raw = t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    return hashlib.blake2b(raw.numpy(), digest_size=16).hexdigest()


def block_digests(torch, tr, state) -> dict:
    """{state leaf path: (start, shape, digest of the bytes)} of this
    rank's blocks of the parameters and moments."""
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.models.params import block_start

    starts = {path: block_start(pl, tr.mesh)
              for path, pl in _flatten(tr.placements)}
    return {key: (starts[key[key.index("/"):]], tuple(t.shape),
                  tensor_digest(torch, t))
            for key, t in state_leaves(state).items()}


def region_digest(torch, t, start, shape) -> str:
    """The digest of the region [start, start + shape) of a whole leaf."""
    return tensor_digest(torch, t[tuple(slice(a, a + n)
                                        for a, n in zip(start, shape))])


def view_grad_bytes(tr) -> int:
    """The bytes of every leaf's view gradient, in the dtype the loss
    reads the leaf in: what a reduce after the whole backward held at
    once."""
    from repro_torch.models.params import leaf_dtype, tree_leaves, view_shape

    dt = tr.ctx.compute_dtype
    return sum(math.prod(view_shape(pl, tr.mesh, lp.whole))
               * leaf_dtype(spec, dt).itemsize
               for spec, pl, lp in zip(tree_leaves(tr.specs),
                                       tree_leaves(tr.placements),
                                       tree_leaves(tr.plan)))


def grad_memory(tr, steps: int, peaks: list) -> dict:
    """What a rank's split trainer held: the most view-gradient bytes the
    reducer held at once (the largest of ``peaks``, each step's
    ``VIEW_GRADS`` reading (peak, largest unit)), all the views' bytes,
    and what remat saved at the layers' edges a step (``EDGE_SAVES``
    since it was reset before the steps)."""
    from repro_torch.models.model import EDGE_SAVES

    return {"view_grad_peak_bytes": max(p for p, _ in peaks),
            "view_grad_largest_unit_bytes": max(u for _, u in peaks),
            "view_grad_all_bytes": view_grad_bytes(tr),
            "remat_edge_bytes_per_step": EDGE_SAVES.bytes / steps,
            "remat_edge_shapes": sorted(set(EDGE_SAVES.shapes))}


def train_ranks_rank(device: str, ckpt_dir: str) -> dict:
    """One of two gloo ranks sharing the card (``run_ranks``): Qwen1.5-0.5B
    at mesh (2, 1), 4 steps of the phase's batches (4 of the 8 rows a
    rank), its blocks written at step 2 (and their digests); then
    ``compressed_allreduce`` on a Qwen-sized leaf against its arithmetic on
    the codes of both ranks, and a 2-stage pipeline against the sequential
    loop."""
    import collections

    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh, mesh_device_type
    from repro_torch.models.model import EDGE_SAVES
    from repro_torch.models.params import VIEW_GRADS
    from repro_torch.sharding.collectives import COLLECTIVES, TRAFFIC, \
        shard_index
    from repro_torch.sharding.pipeline import bubble_fraction, pipeline, \
        split_stages
    from repro_torch.train.compression import compress, compressed_allreduce
    from repro_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device(device)
    cfg, opt, batches = ranks_setup()
    mesh = make_host_mesh((2, 1))
    tr = Trainer(cfg, TrainConfig(steps=RANKS_STEPS,
                                  ckpt_every=RANKS_STEPS + 1,
                                  ckpt_dir=ckpt_dir, log_every=1, opt=opt),
                 mesh=mesh, device=dev)
    state = tr.init_state(torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    EDGE_SAVES.reset()
    start, traffic0 = len(COLLECTIVES), dict(TRAFFIC)
    losses, step_ms, digests, peaks = [], [], None, []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        state, hist = tr.run(iter([b]), n_steps=1, state=state)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(hist[-1]["loss"])
        peaks.append((VIEW_GRADS.peak, VIEW_GRADS.largest_unit))
        if tr.step == 2:        # each rank writes its blocks
            t0 = time.perf_counter()
            tr.save(state)
            save_s = time.perf_counter() - t0
            digests = block_digests(torch, tr, state)
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ops = collections.Counter(op for op, _, _ in COLLECTIVES[start:])
    memory = grad_memory(tr, len(batches), peaks)
    del state
    torch.cuda.empty_cache()

    # compressed_allreduce on a Qwen-sized leaf (the token table's shape)
    me = shard_index(mesh, "data")
    shape = (cfg.vocab_size, cfg.d_model)
    gs = [torch.randn(shape, generator=torch.Generator(dev).manual_seed(
        100 + i), device=dev) * (i + 1) for i in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compressed_allreduce(gs[me], mesh)
    torch.cuda.synchronize()
    car_ms = (time.perf_counter() - t0) * 1e3
    want = None
    for g in gs:
        q, s = compress(g)
        part = s * q.float()
        want = part if want is None else want + part
    car = {"shape": list(shape), "ms": car_ms,
           "bit_equal": bool(torch.equal(got, want)),
           "max_abs_err": float((got - want).abs().max())}
    del gs, got, want

    # a 2-stage pipeline on the two ranks
    p = PIPE
    smesh = DeviceMesh(mesh_device_type(), list(range(p["stages"])),
                       mesh_dim_names=("stage",))
    gen = torch.Generator(dev).manual_seed(5)
    w = torch.randn((p["layers"], p["width"], p["width"]), generator=gen,
                    device=dev) * p["width"] ** -0.5
    bias = torch.randn((p["layers"], p["width"]), generator=gen,
                       device=dev) * 0.1
    xs = torch.randn((p["microbatches"], p["rows"], p["width"]),
                     generator=gen, device=dev)

    def stage_fn(params, x):
        for wi, bi in zip(*params):
            x = torch.tanh(x @ wi + bi)
        return x

    ws, bs = split_stages([w, bias], p["stages"])
    s = shard_index(smesh, "stage")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipeline(stage_fn, smesh, axis="stage")((ws[s], bs[s]), xs)
    torch.cuda.synchronize()
    pipe_ms = (time.perf_counter() - t0) * 1e3
    seq = xs
    for i in range(p["layers"]):
        seq = torch.tanh(seq @ w[i] + bias[i])
    pipe = {**p, "ms": pipe_ms,
            "max_abs_err": float((out - seq).abs().max()),
            "bubble_fraction": bubble_fraction(p["microbatches"],
                                               p["stages"])}
    steps = len(batches)
    return {"rank": me, "losses": losses, "step_ms": step_ms,
            "checkpoint_s": save_s,
            "tokens_per_s": [4 * 512 / ms * 1e3 for ms in step_ms],
            "peak_gb": peak_gb, "launches": launches,
            "collective_s_per_step": (TRAFFIC["seconds"]
                                      - traffic0["seconds"]) / steps,
            "host_bytes_per_step": (TRAFFIC["host_bytes"]
                                    - traffic0["host_bytes"]) / steps,
            "collectives": dict(ops), **memory, "digests": digests,
            "compressed_allreduce": car, "pipeline": pipe}


# tensor-parallel training on two gloo ranks sharing the card at mesh (1, 2):
# (e) Qwen1.5-0.5B whole (the phase's model, batches and steps), (f)
# Falcon-Mamba-7B at full width, TP_MAMBA[1] of its 64 layers
TP_MESH = (1, 2)
TP_MAMBA = ("falcon-mamba-7b", 2, 2)       # arch, layers kept, steps


def tp_setup(arch, layers, steps):
    """The config (cut to ``layers``), optimizer and 8 × 512 batches of a
    tensor-parallel case."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.train.optimizer import AdamWConfig

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    opt = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=steps)
    it = iter(TokenPipeline(cfg.vocab_size, 512, 8, seed=0))
    return cfg, opt, [next(it) for _ in range(steps)]


TP_WHOLE_STEPS = 2       # (e'): (e)'s first steps, act_seq_sp mapped to None


def tp_cases():
    """{case: (arch, layers kept, steps, the train rules' overrides)}."""
    from repro_torch.configs import get_config

    qwen = get_config("qwen1.5-0.5b")
    return {"e": ("qwen1.5-0.5b", qwen.num_layers, RANKS_STEPS, {}),
            "e_prime": ("qwen1.5-0.5b", qwen.num_layers, TP_WHOLE_STEPS,
                        {"act_seq_sp": None}),
            "f": (*TP_MAMBA, {})}


def train_tp_rank(device: str, ckpt_dir: str) -> dict:
    """One of two gloo ranks sharing the card at mesh ``TP_MESH``: each
    case of :func:`tp_cases` trained from the seeded init, split over
    ``"model"``; its launches (counted from zero just before the run),
    the heads or channels every attention and scan call of the training
    path was given, the modes its layers ran, losses, step ms, peak
    memory, seconds in collectives and bytes through the host a step, the
    collectives by kind."""
    import collections

    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.mamba_scan import ops as scan_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import EDGE_SAVES
    from repro_torch.models.params import GATHERED, VIEW_GRADS
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding.collectives import COLLECTIVES, TRAFFIC
    from repro_torch.sharding.rules import make_rules
    from repro_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device(device)
    seen = collections.Counter()
    flash, scan = (flash_ops.flash_attention_autograd,
                   scan_ops.selective_scan_autograd)

    def flash_seen(q, *a, **kw):        # q: (B, heads, S, D)
        seen[f"flash_attention heads {q.shape[1]}"] += 1
        return flash(q, *a, **kw)

    def scan_seen(x, *a, **kw):         # x: (B, S, channels)
        seen[f"mamba_scan channels {x.shape[-1]}"] += 1
        return scan(x, *a, **kw)

    flash_ops.flash_attention_autograd = flash_seen
    scan_ops.selective_scan_autograd = scan_seen
    mesh = make_host_mesh(TP_MESH)
    out = {"rank": torch.distributed.get_rank()}
    for name, (arch, layers, steps, overrides) in tp_cases().items():
        cfg, opt, batches = tp_setup(arch, layers, steps)
        rules = make_rules(mesh, "train", {**cfg.sharding_overrides.get(
            "train", {}), **overrides})
        tr = Trainer(cfg, TrainConfig(steps=steps, ckpt_every=steps + 1,
                                      ckpt_dir=f"{ckpt_dir}/{name}",
                                      log_every=1, opt=opt),
                     mesh=mesh, rules=rules, device=dev)
        state = tr.init_state(torch.Generator(dev).manual_seed(0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seen.clear()
        tp.MODES.clear()
        GATHERED.reset()
        EDGE_SAVES.reset()
        start, traffic0 = len(COLLECTIVES), dict(TRAFFIC)
        reset_launch_counts()
        losses, step_ms, peaks, digests = [], [], [], None
        for b in batches:
            t0 = time.perf_counter()
            state, hist = tr.run(iter([b]), n_steps=1, state=state)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(hist[-1]["loss"])
            peaks.append((VIEW_GRADS.peak, VIEW_GRADS.largest_unit))
            if tr.step == TP_WHOLE_STEPS and name != "f":
                digests = block_digests(torch, tr, state)
        launches = launch_counts()
        out[name] = {
            "arch": arch, "layers": layers, "steps": steps,
            "losses": losses, "step_ms": step_ms,
            "tokens_per_s": [8 * 512 / ms * 1e3 for ms in step_ms],
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches, "seen": dict(seen),
            "modes": {f"{k} {m}": n for (k, m), n in tp.MODES.items()},
            "gathered_units_peak": GATHERED.peak,
            "collective_s_per_step": (TRAFFIC["seconds"]
                                      - traffic0["seconds"]) / steps,
            "host_bytes_per_step": (TRAFFIC["host_bytes"]
                                    - traffic0["host_bytes"]) / steps,
            "collectives": dict(collections.Counter(
                op for op, _, _ in COLLECTIVES[start:])),
            **grad_memory(tr, steps, peaks), "digests": digests}
        del state, tr
        torch.cuda.empty_cache()
    return out


def train_tp_parts(torch, dev, one_losses, root):
    """(e) and (f) of ``train_ranks``: the one-device steps of (f)'s cut
    in this process, then both cases on two gloo ranks sharing the card
    -> (the ranks' launches, the record).  Fails unless every rank
    launched exactly the path's kernels on its half of the heads or
    channels, the ranks' losses agree, and every step's loss is within
    RANKS_TOL of one device's (from step 2 on, the split backward's
    gradients have moved the weights)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.train.trainer import TrainConfig, Trainer

    t_start = time.perf_counter()
    arch, layers, steps = TP_MAMBA
    cfg, opt, batches = tp_setup(arch, layers, steps)
    one = Trainer(cfg, TrainConfig(steps=steps, ckpt_dir=str(root / "f1"),
                                   opt=opt), device=dev)
    state = one.init_state(torch.Generator(dev).manual_seed(0))
    f_losses = []
    for b in batches:
        *state, m = one._step(*state, one._device_batch(b))
        f_losses.append(float(m["loss"]))
    want_loss = {"e": one_losses, "e_prime": one_losses[:TP_WHOLE_STEPS],
                 "f": f_losses}
    del state, one, m
    free_device_memory(torch)

    t0 = time.perf_counter()
    ranks = run_ranks(train_tp_rank, 2, backend="gloo", timeout=600,
                      threads=None, args=(str(dev), str(root / "tp")))
    ranks_s = time.perf_counter() - t0
    total = collections.Counter()
    rec = {"mesh": list(TP_MESH), "ranks_s": ranks_s}
    for name, (arch, layers, steps, overrides) in tp_cases().items():
        cfg = tp_setup(arch, layers, 1)[0]
        kinds = collections.Counter(cfg.layer_kinds())
        t = TP_MESH[1]
        if kinds["attn"]:
            want = {"flash_attention": 2 * kinds["attn"] * steps,
                    "flash_attention_bwd": kinds["attn"] * steps}
            want_seen = {f"flash_attention heads {cfg.num_heads // t}":
                         2 * kinds["attn"] * steps}
        else:
            want = {"mamba_scan": 2 * kinds["ssm"] * steps,
                    "mamba_scan_bwd": kinds["ssm"] * steps}
            want_seen = {f"mamba_scan channels {cfg.d_inner // t}":
                         2 * kinds["ssm"] * steps}
        got = [r[name] for r in ranks]
        for r in got:
            if r["launches"] != want or r["seen"] != want_seen:
                raise AssertionError(
                    f"train_ranks ({name}): launches {r['launches']} on "
                    f"{r['seen']}, want {want} on {want_seen}")
            if r["losses"] != got[0]["losses"] or not all(
                    map(math.isfinite, r["losses"])):
                raise AssertionError(f"train_ranks ({name}): losses "
                                     f"{[x['losses'] for x in got]}")
            if r["gathered_units_peak"] > 1:
                raise AssertionError(f"train_ranks ({name}): gathered copies "
                                     f"of {r['gathered_units_peak']} units "
                                     f"alive at once")
            # every layer's residual: the rank's half of the sequence under
            # the train rules, whole with act_seq_sp mapped to None
            mode = "whole" if overrides else "seq"
            rows = 512 if overrides else 512 // t
            if set(k for k in r["modes"] if k.startswith("residual")) != {
                    f"residual {mode}"} or {sh[1] for sh in r[
                    "remat_edge_shapes"]} != {rows}:
                raise AssertionError(f"train_ranks ({name}): residual modes "
                                     f"{r['modes']}, edges "
                                     f"{r['remat_edge_shapes']}")
            if not 0 < r["view_grad_peak_bytes"] <= r[
                    "view_grad_largest_unit_bytes"]:
                raise AssertionError(f"train_ranks ({name}): view gradients "
                                     f"held {r['view_grad_peak_bytes']}, "
                                     f"largest unit "
                                     f"{r['view_grad_largest_unit_bytes']}")
            total.update(r["launches"])
        gaps = [abs(x - y) / abs(y) for x, y in zip(got[0]["losses"],
                                                   want_loss[name])]
        if len(gaps) != steps or not max(gaps) <= RANKS_TOL:
            raise AssertionError(f"train_ranks ({name}): losses "
                                 f"{got[0]['losses']} vs one device "
                                 f"{want_loss[name]} (relative {gaps} > "
                                 f"{RANKS_TOL})")
        rec[name] = {"arch": arch, "layers": layers,
                     "layers_of_config": get_config(arch).num_layers,
                     "steps": steps, "overrides": overrides,
                     "gaps_vs_one_device": gaps,
                     "one_device_losses": want_loss[name], "ranks": got}
    # (e'): act_seq_sp mapped to None gives (e)'s bits
    for e, e1 in zip(rec["e"]["ranks"], rec["e_prime"]["ranks"]):
        if e1["losses"] != e["losses"][:TP_WHOLE_STEPS] or \
                e1["digests"] != e["digests"]:
            raise AssertionError(
                f"train_ranks (e'): losses {e1['losses']} vs (e)'s "
                f"{e['losses'][:TP_WHOLE_STEPS]}; blocks equal "
                f"{e1['digests'] == e['digests']}")
    rec["e_prime"]["bit_equal_to_e"] = {
        "losses": TP_WHOLE_STEPS, "blocks": len(rec["e"]["ranks"][0][
            "digests"])}
    for name in ("e", "e_prime", "f"):
        for r in rec[name]["ranks"]:
            r.pop("digests")
    rec["seconds"] = time.perf_counter() - t_start
    return dict(total), rec


def train_ranks_phase(torch, dev, counts_reset, counts_read):
    """Training across ranks (see the module doc): (a) an NCCL world of 1
    at mesh (1, 1) against the one-device ``Trainer`` in turns, bit for
    bit; (b) two gloo ranks sharing the card at mesh (2, 1); (c) a world
    of 1 restoring (b)'s step-2 checkpoint and running steps 3-4; (d) in
    (b)'s world, ``compressed_allreduce`` and a 2-stage pipeline.  Returns
    (the launches of the mesh trainers, the phase's record)."""
    from repro_torch.launch.mesh import make_host_mesh, run_ranks, \
        single_rank_group
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg, opt, batches = ranks_setup()
    root = ROOT / "build" / "train_ranks_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    free_device_memory(torch)
    want = {"flash_attention": 2 * cfg.num_layers * RANKS_STEPS,
            "flash_attention_bwd": cfg.num_layers * RANKS_STEPS}
    total = collections.Counter()

    def tcfg(name):
        return TrainConfig(steps=RANKS_STEPS, ckpt_every=RANKS_STEPS + 1,
                           ckpt_dir=str(root / name), log_every=1, opt=opt)

    # (a) a world of one on NCCL against the one-device trainer, in turns
    with single_rank_group("nccl"):
        trs = {"one_device": Trainer(cfg, tcfg("one"), device=dev),
               "world1": Trainer(cfg, tcfg("w1"), mesh=make_host_mesh(
                   (1, 1)), device=dev)}
        states = {k: tr.init_state(torch.Generator(dev).manual_seed(0))
                  for k, tr in trs.items()}
        a = {k: {"losses": [], "step_ms": [],
                 "launches": collections.Counter()} for k in trs}
        for b in batches:
            for k, tr in trs.items():
                batch = tr._device_batch(b)
                torch.cuda.synchronize()
                counts_reset()
                t0 = time.perf_counter()
                *states[k], m = tr._step(*states[k], batch)
                a[k]["losses"].append(float(m["loss"]))
                torch.cuda.synchronize()
                a[k]["step_ms"].append((time.perf_counter() - t0) * 1e3)
                a[k]["launches"].update(counts_read())
        leaves = {k: state_leaves(s) for k, s in states.items()}
        unequal = sum(not torch.equal(t, leaves["one_device"][key])
                      for key, t in leaves["world1"].items())
        n_leaves = len(leaves["world1"])
        del trs, states, leaves
    free_device_memory(torch)
    for k in ("one_device", "world1"):
        if dict(a[k]["launches"]) != want:
            raise AssertionError(f"train_ranks (a) {k}: launches "
                                 f"{dict(a[k]['launches'])}, want {want}")
        a[k]["launches"] = dict(a[k]["launches"])
    total.update(a["world1"]["launches"])
    if a["world1"]["losses"] != a["one_device"]["losses"] or unequal:
        raise AssertionError(f"train_ranks (a): world 1 "
                             f"{a['world1']['losses']} vs one device "
                             f"{a['one_device']['losses']}, {unequal} "
                             f"leaves differ")
    a["bit_equal_leaves"] = n_leaves

    # (b) two gloo ranks sharing the card, their checks (d) in their world
    t0 = time.perf_counter()
    ranks = run_ranks(train_ranks_rank, 2, backend="gloo", timeout=600,
                      threads=None, args=(str(dev), str(root / "ranks")))
    ranks_s = time.perf_counter() - t0
    one = a["one_device"]["losses"]
    for r in ranks:
        if dict(r["launches"]) != want:
            raise AssertionError(f"train_ranks (b) rank {r['rank']}: "
                                 f"launches {r['launches']}, want {want}")
        total.update(r["launches"])
        if r["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"train_ranks (b): ranks' losses differ "
                                 f"{r['losses']} {ranks[0]['losses']}")
        car, pipe = r["compressed_allreduce"], r["pipeline"]
        if not car["bit_equal"]:
            raise AssertionError(f"train_ranks (d): compressed_allreduce "
                                 f"{car}")
        if not pipe["max_abs_err"] <= PIPE["tol"]:
            raise AssertionError(f"train_ranks (d): pipeline {pipe}")
    gaps = [abs(x - y) / abs(y) for x, y in zip(ranks[0]["losses"], one)]
    if not gaps[0] <= RANKS_TOL:
        raise AssertionError(f"train_ranks (b): step 1 loss "
                             f"{ranks[0]['losses'][0]} vs one device "
                             f"{one[0]} (relative {gaps[0]} > {RANKS_TOL})")

    # (c) a world of one restores (b)'s step-2 blocks and runs steps 3-4
    with single_rank_group("nccl"):
        tr = Trainer(cfg, TrainConfig(
            steps=RANKS_STEPS, ckpt_every=RANKS_STEPS + 1,
            ckpt_dir=str(root / "ranks"), log_every=1, opt=opt),
            mesh=make_host_mesh((1, 1)), device=dev)
        t0 = time.perf_counter()
        state = tr.maybe_restore(tr.init_state(
            torch.Generator(dev).manual_seed(1)))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if tr.step != 2:
            raise AssertionError(f"train_ranks (c): restored step {tr.step}")
        whole = state_leaves(state)
        compared = mismatched = 0
        for r in ranks:
            for key, (start, shape, want_digest) in r["digests"].items():
                compared += 1
                mismatched += region_digest(torch, whole[key], start,
                                            shape) != want_digest
        del whole
        if mismatched:
            raise AssertionError(f"train_ranks (c): {mismatched} of "
                                 f"{compared} restored blocks differ from "
                                 f"(b)'s step 2")
        counts_reset()
        _, hist = tr.run(iter(batches[2:]), n_steps=RANKS_STEPS - 2,
                         state=state)
        c_launches = counts_read()
        del state, tr
    want_c = {k: n * (RANKS_STEPS - 2) // RANKS_STEPS for k, n in want.items()}
    if c_launches != want_c:
        raise AssertionError(f"train_ranks (c): launches {c_launches}, "
                             f"want {want_c}")
    total.update(c_launches)
    c_losses = [h["loss"] for h in hist]
    c_gaps = [abs(x - y) / abs(y) for x, y in zip(c_losses,
                                                   ranks[0]["losses"][2:])]
    if not max(c_gaps) <= SURVIVOR_TOL:
        raise AssertionError(f"train_ranks (c): losses {c_losses} vs (b)'s "
                             f"{ranks[0]['losses'][2:]} (relative {c_gaps} "
                             f"> {SURVIVOR_TOL})")
    ckpt_gb = sum(f.stat().st_size for f in (root / "ranks").rglob("*")
                  if f.is_file()) / 1e9
    free_device_memory(torch)

    # (e), (f): split over "model" on two gloo ranks sharing the card
    tp_launches, tp_rec = train_tp_parts(torch, dev,
                                         a["one_device"]["losses"], root)
    total.update(tp_launches)
    shutil.rmtree(root, ignore_errors=True)
    free_device_memory(torch)
    for r in ranks:
        del r["digests"]
    return dict(total), {
        "phase": "train_ranks", "arch": cfg.name, "batch": 8, "seq": 512,
        "steps": RANKS_STEPS, "tolerance": RANKS_TOL,
        "a_world1_nccl": a,
        "b_gloo_ranks": {"mesh": [2, 1], "ranks": ranks, "seconds": ranks_s,
                         "gaps_vs_one_device": gaps},
        "c_survivor": {"mesh": [1, 1], "restored_step": 2,
                       "restore_s": restore_s, "checkpoint_gb": ckpt_gb,
                       "blocks_bit_equal": compared,
                       "losses": c_losses, "gaps_vs_b": c_gaps,
                       "tolerance": SURVIVOR_TOL,
                       "launches": c_launches},
        "e_f_tensor_parallel": tp_rec,
        "launches": dict(total)}


SERVE = {"arch": "qwen3-8b", "layers": 8, "batch": 8, "prompt": 3000,
         "steps": 16, "mesh": (1, 2), "seed": 0,
         # each row's length after the prefill (its prompt's first so many
         # tokens stay live)
         "lengths": (3000, 3000, 2400, 1800, 1508, 1500, 1493, 1000)}
# the cache holds the prompt and the steps: 3016 entries, two ranges of
# 1508.  Rows at 3000 and 2400 hold comparable mass in both ranges; 1508
# starts the second range at step 1 (a one-entry range), 1500 crosses into
# it at step 9 and 1493 at step 16 (empty ranges before); 1000 never
# reaches it
SERVE_CACHE = SERVE["prompt"] + SERVE["steps"]
SERVE_RANGE = SERVE_CACHE // SERVE["mesh"][1]


def serve_setup():
    """The ``serve_ranks`` cut: Qwen3-8B at full width, ``SERVE["layers"]``
    layers, a cache of SERVE_CACHE entries (prompt + steps); and the seeded
    prompts (CPU int32)."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(SERVE["arch"])
    cfg = dataclasses.replace(cfg, num_layers=SERVE["layers"],
                              decode_headroom=SERVE["steps"])
    gen = torch.Generator().manual_seed(SERVE["seed"])
    tokens = torch.randint(0, cfg.vocab_size,
                           (SERVE["batch"], SERVE["prompt"]), generator=gen,
                           dtype=torch.int32)
    return cfg, tokens


def serve_weights(torch, cfg, dev):
    """The whole serve weights of the cut, drawn from the seed on ``dev``
    in bf16 (the same draws in every process)."""
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params

    return init_params(model_specs(cfg, serve=True),
                       torch.Generator(dev).manual_seed(SERVE["seed"]), dev,
                       torch.bfloat16)


def serve_run(torch, prefill_step, serve_step, params, tokens, ids=None):
    """A prefill, each row's length set to ``SERVE["lengths"]``, then
    ``SERVE["steps"]`` decode steps, each fed ``ids[i]`` or (``ids`` None)
    the greedy id of the step before -> (the logits of every step on the
    CPU, the ids fed (numpy), prefill s, decode ms a step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache["length"] = torch.tensor(SERVE["lengths"], dtype=torch.int32,
                                   device=logits.device)
    out, fed, step_ms = [logits.cpu()], [], []
    for i in range(SERVE["steps"]):
        nxt = logits.argmax(-1) if ids is None else torch.from_numpy(
            ids[i]).to(logits.device)
        fed.append(nxt.cpu().numpy())
        t0 = time.perf_counter()
        logits, cache = serve_step(params, cache,
                                   {"tokens": nxt[:, None].to(torch.int32)})
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits.cpu())
    return out, fed, prefill_s, step_ms


def serve_ranks_rank(device: str, ids) -> dict:
    """One of two gloo ranks sharing the card at ``SERVE["mesh"]``: the
    cut's prefill and serve steps under ``rules_for``, fed the one-device
    run's ``ids``; its launches (counted from zero just before the run),
    the heads of every flash_attention call and the range of every
    decode_attention_partial call, the modes its layers ran, logits (rank
    0) and their digest, prefill s, decode ms a step, seconds in
    collectives, bytes through the host, peak GB."""
    import hashlib

    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import make_prefill_step, \
        make_serve_step, rules_for
    from repro_torch.models.model import serve_params
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding.collectives import COLLECTIVES, TRAFFIC

    dev = torch.device(device)
    seen = collections.Counter()
    flash, partial = flash_ops.flash_attention, \
        decode_ops.decode_attention_partial

    def flash_seen(q, *a, **kw):        # q: (B, heads, S, D)
        seen[f"flash_attention heads {q.shape[1]}"] += 1
        return flash(q, *a, **kw)

    def partial_seen(q, k_blk, *a, **kw):   # k_blk: (B, KV, entries, D)
        seen[f"decode_attention_partial entries {k_blk.shape[2]}"] += 1
        return partial(q, k_blk, *a, **kw)

    flash_ops.flash_attention = flash_seen
    decode_ops.decode_attention_partial = partial_seen
    mesh = make_host_mesh(SERVE["mesh"])
    cfg, tokens = serve_setup()
    prefill_rules = rules_for(cfg, mesh, "prefill")
    serve_rules = rules_for(cfg, mesh, "decode")
    params = serve_params(cfg, serve_weights(torch, cfg, dev), serve_rules)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tp.MODES.clear()
    start, traffic0 = len(COLLECTIVES), dict(TRAFFIC)
    with torch.no_grad():
        reset_launch_counts()
        logits, _, prefill_s, step_ms = serve_run(
            torch, make_prefill_step(cfg, prefill_rules),
            make_serve_step(cfg, serve_rules), params, tokens.to(dev), ids)
        launches = launch_counts()
    logits = [t.numpy() for t in logits]    # no tensor through the queue
    digest = hashlib.sha256()
    for t in logits:
        digest.update(t.tobytes())
    rank = torch.distributed.get_rank()
    return {"rank": rank, "launches": launches, "seen": dict(seen),
            "modes": {f"{k} {m}": n for (k, m), n in tp.MODES.items()},
            "logits": logits if rank == 0 else None,
            "logits_sha256": digest.hexdigest(),
            "prefill_s": prefill_s, "decode_step_ms": step_ms,
            "collective_s": TRAFFIC["seconds"] - traffic0["seconds"],
            "host_bytes": TRAFFIC["host_bytes"] - traffic0["host_bytes"],
            "collectives": dict(collections.Counter(
                op for op, _, _ in COLLECTIVES[start:])),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def serve_gaps(got, want):
    """Per step: the largest |got - want| and its root mean square over
    every row's logits."""
    out = []
    for g, w in zip(got, want):
        d = g.double() - w.double()
        out.append((float(d.abs().max()), float(d.square().mean().sqrt())))
    return out


def serve_ranks_phase(torch, dev):
    """The prefill and serve steps under the serve rules (see the module
    doc): the cut on one device here in bf16, and in float32 fed the same
    ids (the witness: the same bf16 weights, every activation in float32),
    then on two gloo ranks sharing the card -> (the ranks' launches, the
    record).  The record is printed before a failed check raises."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.params import tree_map

    t_start = time.perf_counter()
    free_device_memory(torch)
    cfg, tokens = serve_setup()
    params = serve_weights(torch, cfg, dev)
    with torch.no_grad():
        want, ids, one_prefill_s, one_step_ms = serve_run(
            torch, make_prefill_step(cfg, None), make_serve_step(cfg, None),
            params, tokens.to(dev))
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        params = tree_map(lambda t: t.float(), params)
        exact, _, _, _ = serve_run(
            torch, make_prefill_step(cfg32, None),
            make_serve_step(cfg32, None), params, tokens.to(dev), ids)
    del params
    free_device_memory(torch)

    t0 = time.perf_counter()
    ranks = run_ranks(serve_ranks_rank, 2, backend="gloo", timeout=600,
                      threads=None, args=(str(dev), ids))
    ranks_s = time.perf_counter() - t0
    t = SERVE["mesh"][1]
    attn = collections.Counter(cfg.layer_kinds())["attn"]
    want_launches = {"flash_attention": attn,
                     "decode_attention_partial": attn * SERVE["steps"]}
    want_seen = {f"flash_attention heads {cfg.num_heads // t}": attn,
                 f"decode_attention_partial entries {SERVE_RANGE}":
                     attn * SERVE["steps"]}
    failures = []
    total = collections.Counter()
    for r in ranks:
        if r["launches"] != want_launches or r["seen"] != want_seen:
            failures.append(
                f"rank {r['rank']}: launches {r['launches']} on "
                f"{r['seen']}, want {want_launches} on {want_seen}")
        if r["logits_sha256"] != ranks[0]["logits_sha256"]:
            failures.append("the ranks' logits differ")
        if r["modes"].get("attn_cache seq", 0) == 0:
            failures.append(f"rank {r['rank']}: the cache was not split by "
                            f"sequence: {r['modes']}")
        total.update(r["launches"])
    got = [torch.from_numpy(g) for g in ranks[0].pop("logits")]
    # the bound, from the float32 witness: bf16 rounding alone moves the
    # one-device run's logits by max|one - f32| a step (0.036-0.038 on an
    # H100 at 8 layers, over ATTN_TOL's 2e-2 at small logits); the split
    # rounds in another order, so it may differ from the one-device run by
    # as much again, independent errors of equal size adding to √2 times
    # one (in largest |diff| and in rms); a dropped or misweighted range
    # moves both by ~2x (a range left out, on an H100)
    split_gaps = serve_gaps(got, want)
    split_exact = serve_gaps(got, exact)
    one_exact = serve_gaps(want, exact)
    ratios = [s[1] / o[1] for s, o in zip(split_exact, one_exact)]
    tol = ATTN_TOL["bfloat16"]
    compared, flips, over_attn_tol = 0, 0, []
    for step, (g, w) in enumerate(zip(got, want)):
        limit = math.sqrt(2) * one_exact[step][0]
        if split_gaps[step][0] > limit:
            failures.append(f"step {step}: logits off the one-device run by "
                            f"{split_gaps[step][0]}, over √2 · its gap to "
                            f"float32 ({limit})")
        if ratios[step] > math.sqrt(2):
            failures.append(f"step {step}: the split's rms gap to float32 "
                            f"{ratios[step]} times the one-device run's")
        diff = (g.double() - w.double()).abs()
        over_attn_tol.append(int((diff > tol + tol * w.double().abs()
                                  ).sum()))
        top2 = w.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > LOGIT_MARGIN
        compared += int(clear.sum())
        flips += int((g.argmax(-1) != w.argmax(-1))[clear].sum())
    if flips:
        failures.append(f"{flips} of {compared} greedy ids with a margin "
                        f"over {LOGIT_MARGIN} differ")
    rec = {"phase": "serve_ranks", "arch": cfg.name,
           "layers": SERVE["layers"],
           "layers_of_config": get_config(SERVE["arch"]).num_layers,
           "dtype": "bfloat16", "mesh": list(SERVE["mesh"]),
           "batch": SERVE["batch"], "prompt": SERVE["prompt"],
           "lengths_after_prefill": list(SERVE["lengths"]),
           "cache_entries": SERVE_CACHE, "range_entries": SERVE_RANGE,
           "steps": SERVE["steps"],
           "tolerance": "each step: max |split - one device| ≤ √2 · max "
                        "|one device - float32|; rms |split - float32| ≤ √2 "
                        "· rms |one device - float32|",
           "logits_max_abs_err": [m for m, _ in split_gaps],
           "logits_rms_err": [q for _, q in split_gaps],
           "witness_float32": {
               "split_max_rms": split_exact, "one_device_bf16_max_rms":
                   one_exact, "rms_ratio": ratios},
           "logits_over_attn_tol": over_attn_tol,
           "greedy_ids_compared": compared, "greedy_ids_differ": flips,
           "one_device": {"prefill_s": one_prefill_s,
                          "decode_step_ms": one_step_ms},
           "ranks_s": ranks_s, "ranks": ranks, "failures": failures,
           "seconds_in_phase": time.perf_counter() - t_start}
    if failures:
        emit(rec)
        raise AssertionError(f"serve_ranks: {failures}")
    return dict(total), rec


PHASES = ("kernels", "gate_cell_bwd", "flash_attention_bwd", "main_path",
          "solve_ccg", "policies", "decide", "finetune", "scenarios", "sharded", "dispatch",
          "dispatch_recurrent", "dispatch_moe", "front_end", "train",
          "train_recurrent", "train_ranks", "serve_ranks", "mamba_scan_bwd",
          "rglru_scan_bwd")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the build log and phase records")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run, of " + ", ".join(
                        PHASES) + " (default: all; gate_cell_bwd, "
                        "flash_attention_bwd, mamba_scan_bwd and "
                        "rglru_scan_bwd are those kernel rows alone, "
                        "which kernels includes; scenarios "
                        "needs kernels); the kernels line then lists only "
                        "the rows made")
    args = ap.parse_args()
    only = set(PHASES if args.only is None else args.only.split(","))
    if only - set(PHASES) or ("scenarios" in only and "kernels" not in only):
        ap.error(f"--only {args.only}: phases are {', '.join(PHASES)}, and "
                 "scenarios needs kernels")

    t_smoke = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, launch_counts, reset_launch_counts
    from repro_torch.core.cost_model import SystemConfig
    from repro_torch.serving.simulator import SimConfig, Simulator

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    records = []
    last = [time.perf_counter()]

    def record(obj):
        """Emit a phase's record with the seconds since the previous one."""
        now = time.perf_counter()
        obj["seconds"] = now - last[0]
        last[0] = now
        records.append(obj)
        emit(obj)

    smi = nvidia_smi()
    record({"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda})

    # the backward kernel's first design builds beside the library, for its
    # row's earlier_ms
    first_design = (start_first_design_build()
                    if only & {"kernels", "flash_attention_bwd"} else None)
    _build.library()
    record({"phase": "build",
            "library": str(_build.library_path().relative_to(ROOT))})
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        shutil.copy(_build.build_dir() / "build.log", args.out / "build.log")

    stream = Simulator(SystemConfig(), SimConfig(n_tasks=M, seed=0),
                       device=dev).sample_stream(n_rounds=ROUNDS,
                                                 feature_seed=1)
    counted = (reset_launch_counts, launch_counts)
    # launches of each kernel on its paths, each counted from zero just
    # before its run and read just after: the main path's serving round for
    # the router's kernels (c6_repair among them), the finetune run and the
    # warm-up for gate_cell_bwd, the serve launcher for the attention
    # kernels on its SMOKE pools, the per-round repair above the one-block
    # cluster's cap for c6_tail, the cold and the warm solve for ccg_encode and
    # ccg_master, the kernel-path request sets of the two dispatch phases
    # for the attention kernels and the scans (the dispatch phases' counts,
    # checked against layers × calls, split by the call that launched
    # them: prefill or decode step)
    phases = {}
    rows = kernel_phase(torch, stream, dev) if "kernels" in only else {}
    if only & {"kernels", "gate_cell_bwd"}:
        rows["gate_cell_bwd"] = gate_bwd_row(torch, stream, dev)
    if "kernels" in only:
        (rows["c6_repair"], phases["c6_repair_above_cap"],
         cluster) = c6_repair_row(torch, stream, dev, *counted)
        # the redesign of c6_tail's only caller above the one-block cap:
        # one cluster launch a repair, beside the per-round path it replaced
        rows["c6_tail"]["earlier_ms"] = cluster[CLUSTER_M]["demoting"][
            "earlier_ms"]
        rows["c6_tail"]["cluster_repair"] = cluster
        rows.update(attention_rows(torch, dev))
        rows["decode_attention_partial"] = partial_row(torch, dev)
        rows.update(scan_rows(torch, dev))
    if only & {"kernels", "flash_attention_bwd"}:
        rows["flash_attention_bwd"] = flash_bwd_row(torch, dev, first_design)
    bwd_rows = [n for n in ("mamba_scan_bwd", "rglru_scan_bwd")
                if only & {"kernels", n}]
    if bwd_rows:
        rows.update(scan_bwd_rows(torch, dev, bwd_rows))
    if rows:
        record({"phase": "kernels", "compared": [
            {k: rows[n][k] for k in ("name", "max_abs_err", "tolerance")}
            for n in rows]})

    if "main_path" in only:
        phases["main_path"], trace, main_rec = main_path_phase(
            torch, dev, stream, *counted)
        record(main_rec)
        record(trace)
    if "solve_ccg" in only:
        phases["solve_ccg"], solve_rec = solve_phase(torch, dev, stream,
                                                     *counted)
        record(solve_rec)
    if "policies" in only:
        record(policies_phase(torch, dev, stream, *counted))
    if "decide" in only:
        phases["decide"], decide_rec = decide_phase(torch, dev, stream,
                                                    *counted)
        record(decide_rec)
    if "finetune" in only:
        phases["finetune"], phases["launcher"], ft_rec = finetune_phase(
            torch, dev, stream, *counted)
        record(ft_rec)
    if "scenarios" in only:
        phases["scenarios"], scen_rec = scenarios_phase(torch, dev, *counted,
                                                        rows)
        record(scen_rec)
    if "sharded" in only:
        phases["sharded"], shard_rec = sharded_phase(torch, dev, *counted)
        record(shard_rec)
    by_calls = []
    if "dispatch" in only:
        dispatch_by_call, dispatch_rec = dispatch_phase(torch, dev, stream,
                                                        *counted)
        record(dispatch_rec)
        phases["dispatch"] = per_kernel(dispatch_by_call)
        by_calls.append(dispatch_by_call)
    if "dispatch_recurrent" in only:
        recurrent_by_call, recurrent_rec = dispatch_phase(
            torch, dev, stream, *counted, phase="dispatch_recurrent",
            archs=("falcon-mamba-7b", "recurrentgemma-9b"), m=64,
            trace_reps=2)
        record(recurrent_rec)
        phases["dispatch_recurrent"] = per_kernel(recurrent_by_call)
        by_calls.append(recurrent_by_call)
    if "dispatch_moe" in only:
        moe_by_call, moe_rec = dispatch_phase(
            torch, dev, stream, *counted, phase="dispatch_moe",
            archs=("qwen1.5-0.5b", "moonshot-v1-16b-a3b"), m=64,
            trace_reps=2)
        # Moonshot's pools freed: Mixtral-8x22B at full width, 4 layers
        cut, moe_rec["mixtral_cut"] = mixtral_cut_phase(torch, dev, *counted)
        record(moe_rec)
        cut_by_call = {("flash_attention", "prefill"): cut["flash_attention"],
                       ("decode_attention", "decode"):
                           cut["decode_attention"]}
        phases["dispatch_moe"] = per_kernel(
            collections.Counter(moe_by_call) + collections.Counter(
                cut_by_call))
        by_calls += [moe_by_call, cut_by_call]
    if "front_end" in only:
        phases["front_end"], fe_rec = front_end_phase(torch, dev, *counted)
        record(fe_rec)
        by_calls.append({
            ("flash_attention", "prefill"): phases["front_end"][
                "flash_attention"],
            ("decode_attention", "decode"): phases["front_end"][
                "decode_attention"]})
    if "train" in only:
        phases["train"], train_rec = train_phase(torch, dev, *counted)
        record(train_rec)
    if "train_recurrent" in only:
        phases["train_recurrent"], rec = train_recurrent_phase(torch, dev,
                                                               *counted)
        record(rec)
    if "train_ranks" in only:
        phases["train_ranks"], rec = train_ranks_phase(torch, dev, *counted)
        record(rec)
    if "serve_ranks" in only:
        phases["serve_ranks"], rec = serve_ranks_phase(torch, dev)
        record(rec)
    for name, row in rows.items():
        by_phase = {ph: c[name] for ph, c in phases.items() if c.get(name)}
        row["launches"] = sum(by_phase.values())
        row["launches_by_phase"] = by_phase
        by_call = {kind: sum(c.get((name, kind), 0) for c in by_calls)
                   for kind in ("prefill", "decode")}
        if any(by_call.values()):
            row["launches_by_call"] = by_call
    kernels = {"kernels": list(rows.values())}
    record({"phase": "total", "total_seconds": time.perf_counter() - t_smoke})
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(
            json.dumps({"records": records, **kernels}, indent=1))
    emit(kernels)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
