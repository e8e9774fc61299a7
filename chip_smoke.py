"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--out REPORT.json]

Drives the port's paths on the card and holds every Hopper kernel of
those paths against its plain PyTorch version:

 1. device   - needs CUDA; prints the card's name and power limit;
 2. build    - builds the ten kernels (router step, popcount, the BT
               counter's two entry points, bt_count and bt_measure, which
               share one source, window sort, ordering unit, chain select,
               chain, and the popcount window order's two entry points,
               descending_perm and chain_inputs, which share one source)
               from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a,
               one nvcc per source, all started together;
 3. kernels  - each kernel == its plain version, exactly: popcount on 2^20
               words, the BT counter (counts, total, both in one launch)
               and its measure sums (total, S1, S2) at F = 1-3 x L = 1, 3,
               8, 16, 33, 130, at (4097, 16), (7778, 8), off 16- and
               8-byte alignment and at (2^20, 8), the measure sums also on
               the all-ones (2^17 + 1, 32) stream (S2 = 2^32), the router
               step
               over 512 cycles of a synthetic 6-lane batch on 4x4, 8x8 and
               16x16 meshes, one for each shared-memory layout, and of
               synthetic result-phase batches (the PEs inject, the MCs
               receive: 14 streams on 4x4, 60 on 8x8 with mc4 and mc8 lanes
               in one batch, 240 on 16x16, the sideband in global memory;
               padding streams of length 0 at router 0; each batch fills a
               local FIFO, where the full-FIFO pop finds its stream) (all
               13 state leaves after every 128-cycle chunk; the FIFO's
               phantom router row excluded), the window sort at (512, 512)
               and on rows that leave the last block part-filled at W = 128
               to 2,048
               with 0-2 payloads on tie-heavy and full-range int32 keys
               (INT32_MIN, INT32_MAX), and at (37, 128) with uint32 and
               float32 payloads through ``ops``, the ordering unit at
               (512, 512) and at W = 32 to 1,024 (in registers, one warp or
               two a row) and 2,048 and 16,384 (shared memory) on random
               and tie-heavy words, the chain select on 1-2 planes at W =
               1, 28, 152, 256, 400, 1024, 1025, 4096 and 16,000 on the chain's
               penalties and on keys that tie, wrap past INT32_MAX or hit
               INT32_MIN, and R = 0, the whole chain on 1-2 planes at W = 4, 31,
               152, 400, 4096 and 16,000 and at its two tiers' edges, W =
               32, 33, 64, 576 and 1,024 (the register tier, beams 1-2)
               and 1,025 (the wide tier), with beams 1-3 (one and two planes up to
               W = 64, the plane counts alternating above) on rows of
               random words, words with bit 31 set, z = 0, z = 1 and a
               full row, starts in the zero region too; the popcount
               window order's
               O1/O2 permutation (through ``ordering.descending_perm``)
               on tie-heavy float32 words with bit 31 set, int8 / uint8 /
               bf16 carriers, all-zero windows, zero tails, W = 1 to
               62,224 (the no-NoC path's whole-stream window, buffers in
               device scratch) and R = 0, both tiebreaks, and its chain
               preamble on 1-2 planes at W = 1 to 16,000 with z = 0 and z
               <= starts rows and a zero-padded tail, and R = 0;
 4. no-NoC   - the paper's Tab. I path: the trained LeNet's weight stream
               under O0 and O1 (stable, pattern), float32 and fixed8, BT
               and Eq. 3's sums measured through the BT counter's measure
               entry point: one bt_measure launch for each of the 6
               measured streams, none of bt_count or popcount; totals, per-
               flit figures and expected BT equal to the plain path's on
               the CPU; in one measure's profiler window one launch, no
               aten::sum and one host read;
 5. main     - ``run_sweep`` on the trained LeNet with one glyph image at
               full width (every packet of the inference, streamed) over
               4x4_mc2, 8x8_mc4, 8x8_mc8 x float32/fixed8 x stable/pattern x
               O0/O1/O2, drained through the router kernel;
 6. O3       - the same full-width sweep with O0/O3/O3a: each chain call
               exactly one launch of the chain kernel and one of the
               chain-preamble kernel, none of the chain-select kernel;
 7. idle     - the device's idle share over the O3 packetize of one mesh
               (8x8_mc4), over that mesh's O0/O1/O2 drain and over its
               O0/O1/O2 packetize, each from one torch.profiler window; no
               ``aten::argsort`` / ``aten::sort`` in that packetize's
               window, nor in one chain preamble's;
 8. DarkNet  - the trained DarkNet (forward held to the CPU's) on one
               glyph image (64x64x3): Fig. 13's cell (4x4_mc2, float32 and
               fixed8, pattern, O0/O1/O2, 40 packets a layer) through the
               kernels on the card and the plain versions on the CPU, equal
               rows, and Tab. II's net power saving at its fixed8 / O2
               reduction; then the full DarkNet cell
               (benchmarks/darknet_full.py): every packet (99,690) streamed
               at 16x16_mc16 x {edge, interleaved} x {roundrobin, nearest},
               fixed8, pattern, O0/O1/O2, with the result phase: every lane
               and result lane drained, each row's cycles, flits,
               result_cycles and result_flits equal to the reference's
               record, totals below 2^31, packetize, simulate, result
               packetize and result simulate seconds, microseconds a
               simulated cycle of the request drain (16 streams) and of the
               result drain (240), K1 and window-order launches, the
               card's result values (``layer_results``) within the float32
               summation bound of the CPU's (the count differing bitwise
               printed), and, from a second run of the cell in one
               profiler window (rows equal to the first's), each
               run_sweep stage's device idle share from its span;
 9. compression - MSR (``core.msr``) through both of
               benchmarks/compression.py's cells: the full DarkNet cell
               (every packet streamed at 16x16_mc16, O0/O1/O2/O3 x {none,
               msr}, fixed8, pattern; O3 on every window of 27 to 576
               values) and the LeNet cell (6x6_mc4, 40 packets a layer):
               each row's cycles, flits and overhead_bits equal to
               experiments/compression.json, msr flits <= none flits,
               every lane drained, totals below 2^31, the port's totals
               and escape bits printed beside the record's; the DarkNet
               cell's wire tensors reckoned first, its wall, packetize
               (O3's apart) and simulate seconds and microseconds a
               simulated cycle per compression, K1 and chain launches,
               and from a second, profiled run (rows equal) the chain
               kernel's device time and each packetize and drain span's
               idle share; then every distinct chain call of the O3 sweep
               (phase 6) and of this cell, by (P, R, W, beam), timed
               through the chain kernel on its own stack (ms a call and
               over the path's calls of that shape, the tier it takes),
               and the device time of conv2-under-O3a's call and of the
               cell's costliest from profiler windows;
10. faults   - benchmarks/faults.py's cell whole (trained LeNet, glyph
               seed 11, 6x6_mc4, 24 packets a layer, fixed8, O0/O1/O2
               packetized on the card): the null-model pin (``simulate``
               through the router kernel == ``simulate_faulty`` with
               nothing injected, on the plain step: total_bt, link_bt,
               drain cycle), rates 0 / 5e-4 / 2e-3 / 8e-3 x parity / crc8
               (seed 5, chunk 1,024) with O0/O1/O2 drained as three
               lockstep lanes of the faulty plain step (the 8 entries in
               spawned processes, one a host core), the dead link and
               the dead router; every entry's schedule columns (drain
               cycle, transmitted flits, protection bits, delivered,
               exhausted, retried packets, retries, rounds, flips, silent
               corruption, conservation) equal to BENCH_noc.json
               suites.faults, dead link 106 of 106 and dead router 102 + 4
               dropped; the O1 / 5e-4 / crc8 drain alone on the card (==
               its lane of the batch) and on the CPU, every FaultDrain
               field equal; each entry's adjusted reduction against O0
               beside the record's, the faulty step's ms a cycle at three
               lanes, at one, and at one with no flips or codes, the
               device's idle share over 128 faulty cycles at three lanes
               (one profiler window), and the phase's wall;
11. serving  - benchmarks/serving.py's DarkNet grid whole (trained DarkNet, one
               glyph image, 16x16_mc16, O0/O1/O2, fixed8, 8 packets a layer,
               the result phase; loads 1 / 4 / 16 x 8 inferences, compute
               latency 32, uniform arrivals, chunk 1,024; rates 0 / 1e-3 / 5e-3
               under crc8; deadline 20,000, admit_queue_depth 8) through
               ``run_serving(..., check_conservation=True)`` (its closed-loop
               drains in one process a host core, up to one a drain): first the
               gated step's ms a cycle at 16x16 over 256 cycles of the load-1
               request drain, clean and at 5e-3 crc8 (one lane each), the
               grid's projected drain time, and the device's idle share over
               128 profiled gated cycles; then all 9 points' schedule columns
               (throughput, p50 / p99 / mean latency, completed, truncated,
               both drain cycles, SLO attainment, goodput, shed, failed), the
               combo's saturation throughput and monotonicity verdicts, and the
               3 rows' cycles, flits and result columns equal to
               experiments/serving_darknet.json, BT totals printed beside the
               record's and below 2^31, and 90,112 gated cycles stepped; the
               load-16 rate-0 point again with ``record_bt=True`` (the canonical
               phase drains through the router kernel == the O0 row's total_bt,
               cycles, flits and result columns); one trained-LeNet point that
               sheds under faults (4x4_mc2, 8 packets a layer, 6 inferences at
               load 8, admit_queue_depth 2, 5e-3 crc8, chunk 256), every
               OnlineResult field equal on the card and the CPU;
12. shard    - sharded drains (``devices=``; a device may repeat): the full
               DarkNet cell on ["cuda:0", "cuda:0"], its 12 rows equal to
               the one-device run's and to the record, microseconds a
               simulated cycle of the two-shard request drain beside the
               one-device one; the pinned LeNet 4x4_mc2 batch (12 lanes, 8
               packets a layer) on ["cuda:0", "cpu"] (the router kernel on
               the card's shard, the plain step on the host's), with and
               without the conservation ledger, three lanes padded onto two
               shards, and six lanes of two lengths compacted from 6 to 2
               rows, each equal to the one-device drain in every field;
               ``run_sweep(devices="auto")`` drains on as many devices as
               the host shows;
13. dist     - the ``dist`` package: ``stream_bt_report`` on the trained
               LeNet's fc1 block (benchmarks/static_layout.py) equal to
               BENCH_noc.json suites.static_layout.trained and to the CPU's
               plain path; ``gradient_wire_report`` of the trained
               DarkNet's whole parameter tree (102,570 values; gradients by
               autograd on 8 glyph images, seed 5) at windows 256, 4,096
               and None equal to the CPU's plain path in every field; the
               ordered bucket and ``bucketed`` round trips; ms a call of
               both reports; DarkNet's parameters over a one-rank NCCL
               ``DeviceMesh`` ("data", "model") by ``spec_shardings`` and
               gathered back equal;
14. lm       - the LM stack's serving path: every arch's reduced config
               (nine LMs, internvl2 with stubbed patch embeddings, and
               whisper-medium's encoder, cross cache and decode steps) on
               the card against the CPU, prefill and three teacher-forced
               decode steps on the same seeded parameters and tokens, logits
               within 1-5 % of their largest value (``LM_TOLS``, an arch
               each); h2o-danube-3-4b at full width (3,961,839,360 seeded
               random parameters, counted against ``param_count``):
               ``Engine.generate`` (4 prompts x 128 tokens, 32 new, greedy,
               context 256) and ``serve_offered_load`` (4 requests of 8
               new tokens, poisson, unpaced), prefill ms, ms a decode step, tokens a second and
               peak memory beside their bounds, eight decode steps in one
               profiler window (the device's idle share, the kernels that
               take its time); the static popcount layout of the whole tree
               (``reorder_lm_params`` through the popcount kernel) and its
               stream report layer by layer through the BT counter (24 rows,
               every total below 2^31), the permutation, matrices and report
               of layers 0 and 23 (past 2^31 values into the stacked block)
               equal to the CPU's plain path, the reordered model's prefill
               and decode logits within 4 % of the original's (the share
               equal bit for bit printed);
15. train    - the LM stack's training half: every arch's reduced config
               (kimi-k2 with int8 moments, minicpm under WSD, whisper through
               the enc-dec loss, internvl2 with zero patch embeddings): the
               gradients at the same seeded parameters and two train steps
               with no warmup (captured into a CUDA graph on the card)
               against the CPU, each gradient leaf, loss, grad norm, lr, the
               updated tree and the moments (int8 decoded) within
               ``TRAIN_TOLS``, int8 codes differing within
               ``TRAIN_Q8_CODE_TOL``, a stale update and zeroed moments
               outside them; xlstm-125m at full width (70,629,120
               parameters, counted against ``param_count``) through
               ``launch.train.main`` (seq 128, batch 8, cosine at 3e-3, wire
               telemetry; 20 steps, checkpoints at 10 and 20), restarted from
               the step-10 checkpoint into a fresh state and equal to the
               uninterrupted run; seconds a step, tokens a second, the step's
               bound, peak memory, one more step replayed in a profiler
               window (idle share) and run eagerly (== the replay, bit for
               bit), its gradients' wire report (ms a call) == the CPU's
               plain report on the same gradients in every field,
               checkpoint seconds and bytes, every wire total below 2^31;
               benchmarks/ordered_collectives.py's cell (reduced xlstm, 12
               steps, the wire report at window 4,096) == the CPU's plain
               report in every field, O1 reducing;
16. dryrun   - the dry runs (ROADMAP A18, ``launch.dryrun``): every arch x
               SHAPES cell on the meta device for the 16x16, 2x16x16 and
               one-card meshes (one trace a cell; spawned processes, one an
               arch), every ``ok`` or a ``skip`` with ``supports()``'s
               reason, a line a cell (parameters, FLOPs, argument bytes,
               bytes a device on 16x16, peak, fit), and every hillclimb
               variant; then h2o-danube-3-4b decode_32k, recurrentgemma-9b
               long_500k, xlstm-125m decode_32k and every other decode cell
               the dry run says fits one card, for real on the card
               (``dryrun.run_on_card``: seeded random parameters, a zero
               cache, one donated decode step): allocated bytes within the
               allocator's rounding of the predicted argument bytes, FLOPs
               equal, the peak beside the predicted one with their ratio,
               finite logits; no kernel of K1-K6 runs;
17. entry points - ``sort_windows_desc`` and ``order_unit`` at (512, 512)
               and on LeNet conv2's operands, ``chain_select`` at (12,800,
               152) on two planes, ``ops.popcount`` on conv2's operands and
               the BT recorder's ``bt_stream`` and ``ops.bt_boundaries`` on
               the weight stream, each result == the plain version's;
18. launches - every kernel launched at least once by the path that runs it
               (counts reset just before each of phases 4-6, 8-15 and 17,
               read after); each CUDA ``descending_perm`` call of phases
               4-5 exactly one launch of the window-order kernel; the
               compression cell launched K1, the chain and its preamble,
               the faults cell and the serving grid K1 and the window
               order, the sharded drains K1, the dist reports the
               popcount, the window order and the BT counter, the LM's
               static layout the popcount and the BT counter, the train
               phase's gradient wire the window order and the BT counter;
19. parity   - the pinned-budget sweep (8 packets per layer, chunk 128):
               O0/O1/O2 through the router kernel and through the plain
               step, O0/O3/O3a (4 packets a layer) through every kernel on
               the card and through the plain versions on the CPU, and
               4x4_mc2 and 8x8_mc4 x {edge, corner, interleaved} x
               {roundrobin, nearest} with the result phase (O0/O1/O2 at
               float32, result values summed on the CPU for both) likewise,
               and the same grid at fixed8 with compression none and msr (4
               packets a layer): equal rows, both phases' escape-bit
               columns included;
20. tune     - ``noc.tune.autotune_drain`` on the card for the pinned
               LeNet drains at 4x4_mc2, 8x8_mc4 and 8x8_mc8: every
               candidate's rows equal (enforced by autotune_drain), the
               timings and winners printed and written beside the report
               (``drain_h100.json``, the card named in it);
21. ledger   - ``run_sweep(check_conservation=True)`` on the pinned 4x4_mc2
               grid with none/msr and the result phase: its drains run the
               plain step on the card (printed), its rows equal the router
               kernel's; a duplicated packet id refused; one drain's
               timestamp ledgers equal on the card and the CPU;
22. timing   - each kernel at its path's shapes beside its plain version,
               its bound on this card and, where one exists, the PyTorch
               call computing the same function: device time per launch
               over a run of launches between one event pair, and beside it
               the mean of single launches each in its own event pair;
               the router step also on a warm state (each paper mesh's
               full-width batch after 4,096 cycles), in microseconds per
               simulated cycle, and at the result drain's shape (a
               synthetic batch of the full DarkNet cell's four combos, 12
               lanes of 240 PE streams); the window order at conv2's
               (1600, 150)
               float32 operands (stable and pattern), the chain at conv2
               under O3a (2 x 1,600 x 152; the wide tier too, and the
               first design's bound printed beside the recounted one) and at
               the DarkNet compression cell's costliest chain call, the
               chain preamble at conv2 under O3a, the BT
               counter at the no-NoC shape (total alone) and at (2^20, 8)
               (counts and total, and the total alone), its measure sums
               at both (with the host's time per measure), the window sort
               at (512, 512) with 0-2 payloads and on full-range keys and
               at W = 128 to 2,048 (the host's time a call through its
               wrapper and as a bare ctypes launch beside it), and the
               ordering unit at (512, 512) and conv2's (1600, 256).

Prints one JSON line describing the kernels, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as its last line. Any failed
phase exits non-zero before that line. The detailed report (every row and
timing) goes to ``--out`` (default ``build/chip_smoke.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

MESHES = ("4x4_mc2", "8x8_mc4", "8x8_mc8")
AXES = dict(meshes=MESHES, transforms=("O0", "O1", "O2"),
            tiebreaks=("stable", "pattern"), precisions=("float32", "fixed8"),
            models=("lenet",))
AXES_O3 = dict(AXES, transforms=("O0", "O3", "O3a"))
PINNED = dict(max_packets_per_layer=8, chunk=128)
# The two costliest kernel-against-plain sweeps (O0/O3/O3a, and the
# placement x affinity x none/msr grid: their CPU plain sides took 63.6 and
# 39.2 s of one run) at 4 packets a layer, to pay for the dryrun phase.
PINNED_SHORT = dict(PINNED, max_packets_per_layer=4)
# The pinned LeNet budget over every placement and affinity with the
# result phase, on the 4x4 and 8x8 meshes.
PLACED = dict(meshes=("4x4_mc2", "8x8_mc4"),
              placements=("edge", "corner", "interleaved"),
              affinity=("roundrobin", "nearest"), transforms=("O0", "O1", "O2"),
              tiebreaks=("pattern",), precisions=("float32", "fixed8"),
              models=("lenet",), result_phase=True)
# DarkNet: Fig. 13's cell (benchmarks/fig13.py: 4x4_mc2, both precisions,
# pattern, O0/O1/O2, 40 packets a layer), and the full DarkNet cell
# (benchmarks/darknet_full.py's _grid(): every packet streamed at
# 16x16_mc16, edge and interleaved MCs, round-robin and nearest affinity,
# the result phase), whose cycles and flits depend only on packet lengths,
# the mesh, the placement and the affinity: experiments/darknet_full.json
# records them, (cycles, flits, result_cycles, result_flits) by combo.
FIG13 = dict(meshes=("4x4_mc2",), transforms=("O0", "O1", "O2"),
             tiebreaks=("pattern",), precisions=("float32", "fixed8"),
             models=("darknet",), max_packets_per_layer=40, chunk=2048)
DARKNET_FULL = dict(meshes=("16x16_mc16",), placements=("edge", "interleaved"),
                    affinity=("roundrobin", "nearest"),
                    transforms=("O0", "O1", "O2"), tiebreaks=("pattern",),
                    precisions=("fixed8",), models=("darknet",),
                    max_packets_per_layer=None, result_phase=True, chunk=4096)
DARKNET_FULL_RECORD = {
    ("edge", "roundrobin"): (181_474, 1_309_994, 1_003, 8_580),
    ("edge", "nearest"): (146_705, 1_309_994, 955, 8_580),
    ("interleaved", "roundrobin"): (81_924, 1_309_994, 3_095, 8_580),
    ("interleaved", "nearest"): (82_310, 1_309_994, 562, 8_580),
}
# MSR compression: benchmarks/compression.py's two cells, O0-O3 x {none,
# msr}, fixed8, pattern. Their cycles, flits and overhead_bits (the O2/O3
# recovery index) depend only on packet lengths and the mesh:
# experiments/compression.json records them, (cycles, flits) by
# compression and overhead_bits by transform.
COMP_AXES = dict(transforms=("O0", "O1", "O2", "O3"), tiebreaks=("pattern",),
                 precisions=("fixed8",), compression=("none", "msr"))
COMP_DARKNET = dict(COMP_AXES, meshes=("16x16_mc16",), models=("darknet",),
                    max_packets_per_layer=None, stream_chunk_packets=4096,
                    chunk=4096)
COMP_DARKNET_RECORD = {"none": (181_474, 1_309_994), "msr": (125_412, 911_674)}
COMP_DARKNET_OVERHEAD = {"O0": 0, "O1": 0, "O2": 75_036_096,
                         "O3": 75_036_096}
COMP_LENET = dict(COMP_AXES, meshes=("6x6_mc4",), models=("lenet",),
                  max_packets_per_layer=40, chunk=2048)
COMP_LENET_RECORD = {"none": (962, 3_800), "msr": (640, 2_520)}
COMP_LENET_OVERHEAD = {"O0": 0, "O1": 0, "O2": 236_480, "O3": 236_480}
COMP_RECORD_KEY = {"darknet": "darknet_full_16x16/16x16_mc16",
                   "lenet": "lenet_6x6/6x6_mc4"}
# The pinned placement grid with both compressions (MSR reads int8: fixed8
# only), and its 4x4 half for the packet-ledger drains.
PLACED_MSR = dict(PLACED, precisions=("fixed8",), compression=("none", "msr"))
# The kernel-against-plain placement sweep runs PLACED at float32 alone:
# its fixed8 rows are PLACED_MSR's compression="none" rows, held there.
PLACED_F32 = dict(PLACED, precisions=("float32",))
LEDGER = dict(PLACED_MSR, meshes=("4x4_mc2",))
TUNE_MESHES = ("4x4_mc2", "8x8_mc4", "8x8_mc8")
# Synthetic result-phase K1 batches: (placement, affinity) lanes of one
# mesh size, PE streams padded to the size's most PEs (8x8: mc4 and mc8
# lanes together, 60 streams).
RESULT_K1 = {
    "4x4": [("4x4_mc2", "edge", "roundrobin"), ("4x4_mc2", "corner", "nearest"),
            ("4x4_mc2", "interleaved", "nearest")],
    "8x8": [("8x8_mc4", "edge", "roundrobin"), ("8x8_mc4", "corner", "nearest"),
            ("8x8_mc8", "edge", "nearest"),
            ("8x8_mc8", "interleaved", "roundrobin")],
    "16x16": [("16x16_mc16", "edge", "roundrobin"),
              ("16x16_mc16", "edge", "nearest"),
              ("16x16_mc16", "interleaved", "nearest")],
}
# The full DarkNet cell's result-drain shape: its four (placement,
# affinity) combos, three lanes each, 240 PE streams.
RESULT_K1_CELL = [("16x16_mc16", pl, aff)
                  for pl in DARKNET_FULL["placements"]
                  for aff in DARKNET_FULL["affinity"]] * 3
# The chain's selection penalties (repro_torch.kernels.min_hamming).
PENALTIES = np.array([0, 1 << 28, 1 << 30, (1 << 30) + (1 << 28)], np.int32)
# Faults: benchmarks/faults.py's cell (trained LeNet, glyph seed 11,
# 6x6_mc4, 24 packets a layer, fixed8, O0/O1/O2; rates x protections, seed
# 5, chunk 1,024; a dead link and a dead router). BENCH_noc.json
# suites.faults records it; these columns depend on the schedule alone (the
# flip hash reads (seed, cycle, link) and the linear codes' syndromes the
# flip mask), so they are exact targets; total_bt and the adjusted
# reductions depend on the image (ROADMAP C2).
FAULT_RATES = (0.0, 5e-4, 2e-3, 8e-3)
FAULT_PROTECTS = ("parity", "crc8")
FAULT_TRANSFORMS = ("O0", "O1", "O2")
FAULT_MAXP = 24
FAULT_CHUNK = 1024
FAULT_SEED = 5
FAULT_SCHEDULE_COLUMNS = (
    "drain_cycle", "transmitted_flits", "protection_overhead_bits",
    "delivered", "retry_exhausted", "retried_packets", "total_retries",
    "transmission_rounds", "flip_events", "silent_corrupt",
    "conservation_ok")
FAULT_HARD = {"dead_link": (106, 0), "dead_router": (102, 4)}
# One lockstep lane drained alone on the card (== its lane of the batch)
# and on the CPU (every field equal): O1 at rate 5e-4 under crc8, two
# transmission rounds with retries in 2,048 stepped cycles, half the 2e-3
# lane's (tests/test_torch_faults.py holds single drains to the
# reference).
FAULT_SINGLE = ("O1", 5e-4, "crc8")
# Serving: benchmarks/serving.py's DarkNet grid (_darknet_grid(): trained
# DarkNet, one glyph image, 16x16_mc16, edge, round-robin, O0/O1/O2,
# pattern, fixed8, 8 packets a layer, the result phase; loads 1 / 4 / 16 x
# 8 inferences, compute latency 32, uniform arrivals, chunk 1,024; rates 0 /
# 1e-3 / 5e-3 under crc8, seed 0, 3 retries, ACK latency 32; deadline
# 20,000, admit_queue_depth 8), recorded in experiments/serving_darknet.json.
# Its timing never reads a payload value, so every point's columns below
# are exact targets; the BT columns depend on the image (ROADMAP C2).
SERVING_DARKNET = dict(
    meshes=("16x16_mc16",), transforms=("O0", "O1", "O2"),
    tiebreaks=("pattern",), precisions=("fixed8",), models=("darknet",),
    max_packets_per_layer=8, result_phase=True, offered_loads=(1.0, 4.0, 16.0),
    serving_inferences=8, compute_latency=32, arrival="uniform", chunk=1024,
    fault_rates=(0.0, 1e-3, 5e-3), fault_protect="crc8", deadline=20000,
    admit_queue_depth=8)
SERVING_POINT_COLUMNS = (
    "throughput", "p50_latency", "p99_latency", "mean_latency", "completed",
    "truncated", "request_drain_cycle", "result_drain_cycle",
    "slo_attainment", "goodput", "shed", "failed")
SERVING_COMBO_COLUMNS = ("saturation_tput", "latency_monotone",
                         "slo_monotone_in_fault")
SERVING_ROW_COLUMNS = ("cycles", "flits", "result_cycles", "result_flits",
                       "overhead_bits", "result_overhead_bits")
# Gated cycles the grid steps: whole 1,024-cycle chunks of both phases at
# each point and of the back-to-back probe, 61,440 of them faulty.
SERVING_STEPPED = 90_112
SERVING_FAULTY_CYCLES, SERVING_CLEAN_CYCLES = 61_440, 28_672
# The gated step's ms a cycle: SERVING_TIMED_CYCLES of the load-1 request
# drain, clean and faulty, after a 64-cycle warm-up each.
SERVING_TIMED_CYCLES = 256
# The grid point run again with record_bt=True (the canonical phase drains
# through the router kernel == the O0 row): load 16, rate 0.
SERVING_RECORD_BT_LOAD = 16.0
# One small point with the restart protocol and faults: trained LeNet at
# 4x4_mc2, 8 packets a layer, 6 inferences at load 8, admit_queue_depth 2,
# rate 5e-3 under crc8, chunk 256.
SERVING_LENET = dict(mesh="4x4_mc2", max_packets=8, inferences=6, load=8.0,
                     admit_queue_depth=2, rate=5e-3, chunk=256)
# Sharded drains: the full DarkNet cell over two shards of the one card (a
# device may repeat: lanes never talk to each other); the pinned LeNet
# 4x4_mc2 batch (8 packets a layer) over the card and the host; six lanes,
# four of 2 packets a layer, that compact.
SHARD_MAXP, SHARD_SHORT_MAXP = 8, 2
SHARD_CHUNK, SHARD_RAGGED_CHUNK = 128, 64
# dist: the trained DarkNet's gradients on GRAD_BATCH glyph images from
# seed GRAD_SEED through the gradient wire report at each window; gradient
# buckets of at most BUCKET_BYTES.
GRAD_SEED, GRAD_BATCH = 5, 8
GRAD_WINDOWS = (256, 4096, None)
BUCKET_BYTES = 64 << 10
# The LM stack (ROADMAP A17): every arch's reduced config on the card
# against the CPU, then h2o-danube-3-4b at full width - the repo's serving
# example (examples/serve_lm.py): dense GQA, a sliding-window ring KV cache,
# untied embeddings - with random weights from a seed: 4 prompts x 128
# tokens, 32 new greedy, context 256; 4 requests of 8 new tokens offered as
# a poisson process; 8 timed decode steps, then 8 more in one profiler
# window. Logits
# are held to a share of their largest value (bf16 matmuls summed in another
# order on each side): each reduced arch to LM_TOLS[arch], about three times
# its reading on an H100 (card against CPU), at least 0.01 and never above
# 0.05; the reordered full-width model to LM_REORDER_TOL of the original's.
LM_ARCH = "h2o-danube-3-4b"
LM_PARAMS = 3_961_839_360
LM_SERVE = dict(batch=4, prompt=128, new=32, context=256, requests=4,
                offered_new=8, load=4.0, decode_steps=8, trace_steps=8)
LM_TOLS = {"h2o-danube-3-4b": 0.025, "internvl2-1b": 0.01,
           "kimi-k2-1t-a32b": 0.015, "minicpm-2b": 0.025,
           "mixtral-8x7b": 0.015, "phi3-medium-14b": 0.025,
           "recurrentgemma-9b": 0.05, "starcoder2-15b": 0.02,
           "whisper-medium": 0.01, "xlstm-125m": 0.01}
LM_REORDER_TOL = 0.04
LM_DECODE_STEPS = 3
LM_PARAM_SEED, LM_INPUT_SEED = 0, 1
LM_TIMING_REPS = 3
# The LM stack's training half (ROADMAP A17 part 2). Every arch's reduced
# config takes TRAIN_REDUCED["steps"] make_train_step steps on the card and
# on the CPU from the same seeded parameters and TokenStream batches (seq
# 32, batch 4), under the arch's schedule over TRAIN_REDUCED["horizon"]
# steps with no warmup, so that each step moves the bf16 parameters by
# about the full lr. TRAIN_TOLS[arch] holds (relative L2 errors) each
# gradient leaf and loss / grad norm / lr, the updated tree, and the
# optimizer's moments (int8 Q8 moments decoded), each about three times
# its largest reading on an H100, gradients and the tree never above 0.05;
# the share of int8 codes that differ is held to TRAIN_Q8_CODE_TOL. A
# stale update (the initial parameters) and zeroed moments must each read
# above its limit. Then xlstm-125m at full width (the repo's training
# example, examples/train_lm.py: seq 128, batch 8, cosine at 3e-3, wire
# telemetry) through launch.train.main for TRAIN_FULL["steps"] steps with a
# checkpoint halfway (and one at the end, as the launcher writes),
# restarted from that checkpoint and held to the uninterrupted run within
# TRAIN_RESTART_TOL (relative L2 a leaf), and its last gradients' wire
# report on the card == the CPU's plain report in every field; then
# benchmarks/ordered_collectives.py's cell (reduced xlstm, 12 steps of seq
# 64 x batch 8 under cosine(3e-3, 12, warmup=2), the wire report of the
# grads on batch 12 at window 4096, 16 lanes) on the card == the CPU's plain
# report in every field.
TRAIN_REDUCED = dict(steps=2, seq=32, batch=4, lr=3e-3, horizon=20)
# (gradient leaves and metrics, updated tree, moments). Largest readings on
# an H100 (NVIDIA H100 80GB HBM3, 700.00 W): gradient leaves 2.4e-3 to
# 6.8e-3, updated trees 1.0e-3 to 2.2e-3, moments 2.2e-3 to 8.7e-3, int8
# codes differing 6.1e-2; recurrentgemma (C19) 2.0e-2, 6.7e-3 and 9.1e-2.
# A stale update reads 5.6e-2 to 1.1e-1, zeroed moments 1.0, zeroed codes
# 0.46.
TRAIN_TOLS = {"h2o-danube-3-4b": (0.01, 0.004, 0.01),
              "internvl2-1b": (0.015, 0.006, 0.025),
              "kimi-k2-1t-a32b": (0.01, 0.005, 0.02),
              "minicpm-2b": (0.01, 0.004, 0.015),
              "mixtral-8x7b": (0.01, 0.005, 0.01),
              "phi3-medium-14b": (0.01, 0.004, 0.01),
              "recurrentgemma-9b": (0.05, 0.02, 0.25),
              "starcoder2-15b": (0.01, 0.0035, 0.012),
              "whisper-medium": (0.02, 0.007, 0.018),
              "xlstm-125m": (0.01, 0.003, 0.02)}
TRAIN_Q8_CODE_TOL = 0.15
TRAIN_FULL = dict(arch="xlstm-125m", params=70_629_120, steps=20, seq=128,
                  batch=8, lr=3e-3, wire_reps=3)
TRAIN_RESTART_TOL = 1e-2
OC_CELL = dict(steps=12, seq=64, batch=8, lr=3e-3, warmup=2, window=4096,
               lanes=16)
# The dry runs (ROADMAP A18): every arch x SHAPES cell on the meta device
# for the 16x16, 2x16x16 and one-card meshes (one trace a cell), in
# spawned processes, one an arch, each also running the hillclimb variants
# of its arch; then DRYRUN_CARD_CELLS, and every other decode cell the dry
# run says fits one card, for real on the card: seeded random parameters
# (DRYRUN_SEED), a zero cache, one donated decode step, held to the dry
# run's argument bytes (within the allocator's rounding), FLOPs (exactly)
# and peak (printed with the ratio).
DRYRUN_CARD_CELLS = (("h2o-danube-3-4b", "decode_32k"),
                     ("recurrentgemma-9b", "long_500k"),
                     ("xlstm-125m", "decode_32k"))
DRYRUN_SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 rate,
# and the non-tensor 32-bit rate, used for 32-bit integer ALU work too.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def fail(msg: str, code: int = 1):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(code)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"[{self.name}] ok {time.perf_counter() - self.t0:.3f} s",
                  flush=True)
        return False


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def cuda_ms(fn, reps: int, make=None) -> float:
    """Device milliseconds per call of ``fn`` over one run of ``reps``
    calls between a single pair of CUDA events, after one warm-up call.
    ``make`` gives each call its own arguments, all made before the run
    (for a kernel that updates its input in place)."""
    import torch
    args = [make() if make else () for _ in range(reps + 1)]
    fn(*args.pop())
    torch.cuda.synchronize()
    a, b = _events()
    a.record()
    for x in args:
        fn(*x)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_spans(prof):
    """Sorted (start, end) microseconds of the device activity that a
    torch.profiler window recorded (not a span's annotation on the
    device's timeline)."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))


def busy_us(spans) -> float:
    """Length of the union of sorted (start, end) spans."""
    total, end = 0.0, -math.inf
    for a, b in spans:
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


def clip_spans(spans, lo: float, hi: float):
    """Sorted (start, end) spans cut to the window [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def device_ms(fn, reps: int, make=None):
    """Device busy milliseconds per call of ``fn`` (the union of the device
    activity spans over ``reps`` calls in one torch.profiler window, after
    one warm-up call): the kernel's own time, without the host's launch
    path. None if the profiler recorded no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    args = [make() if make else () for _ in range(reps + 1)]
    fn(*args.pop())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in args:
            fn(*x)
        torch.cuda.synchronize()
    spans = device_spans(prof)
    return busy_us(spans) / 1e3 / reps if spans else None


def launch_ms(fn, reps: int, make=None) -> float:
    """Mean of ``reps`` single calls of ``fn``, each between its own pair of
    CUDA events: for a kernel of a few microseconds, mostly the host's
    launch path."""
    import torch
    fn(*(make() if make else ()))
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        x = make() if make else ()
        a, b = _events()
        a.record()
        fn(*x)
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


def synthetic_traffic(cfg, batch: int, packets: int, seed: int):
    import torch
    from repro_torch.noc.traffic import TrafficAssembler
    rng = np.random.default_rng(seed)
    asm = TrafficAssembler([(packets, 5)], cfg, num_variants=batch,
                           device="cuda")
    w = rng.integers(0, 2**32, (batch, packets, 5, cfg.lanes),
                     dtype=np.uint64).astype(np.uint32)
    asm.add_chunk(0, 0, torch.from_numpy(w.view(np.int32)).cuda())
    return asm.finish()


def result_batch(lanes, packets: int, seed: int):
    """A synthetic result-phase batch on the card: for each (mesh,
    placement, affinity) lane, three layers of ``packets`` random 8-bit
    result values through ``build_result_traffic`` (O1 windows of 64), PE
    streams padded with router 0 to the lanes' most PEs. Returns (a config
    of the lanes' mesh size, traffic, per-lane injection nodes)."""
    import dataclasses
    import torch
    from repro_torch.core.wire import by_name
    from repro_torch.noc.topology import (affinity_mc_table, mc_placement,
                                          mesh_by_name)
    from repro_torch.noc.traffic import (LayerTraffic, build_result_traffic,
                                         stack_traffics)
    rng = np.random.default_rng(seed)
    pe_pad = max(mesh_by_name(m).num_routers - mesh_by_name(m).num_mcs
                 for m, _, _ in lanes)
    empty = torch.zeros((packets, 0))
    parts, nodes = [], []
    for mesh, placement, affinity in lanes:
        base = mesh_by_name(mesh)
        cfg = dataclasses.replace(base, mc_nodes=mc_placement(
            base.rows, base.cols, base.num_mcs, placement))
        values = [[torch.from_numpy(rng.integers(-128, 128, packets)
                                    .astype(np.int8)).cuda()]
                  for _ in range(3)]
        t = build_result_traffic(
            [LayerTraffic(empty, empty)] * 3, cfg, [(by_name("O1"), None)],
            mc_table=affinity_mc_table(cfg) if affinity == "nearest" else None,
            num_streams=pe_pad, values=values, device="cuda")
        parts.append(t.variant(0))
        nodes.append(cfg.pe_nodes + (0,) * (pe_pad - len(cfg.pe_nodes)))
    return (cfg, stack_traffics(parts),
            torch.as_tensor(np.asarray(nodes, np.int32), device="cuda"))


def router_vs_plain(cfg, wire, mc, label: str, chunks: int = 4):
    """The router kernel and the plain step side by side from a zero state
    over ``chunks`` 128-cycle chunks: all 13 state leaves equal after
    every chunk (the FIFO on real router rows). Returns the final state
    and the fullest local (PE-side injection) FIFO seen after any chunk."""
    import torch
    from repro_torch.kernels import ref, router_step
    from repro_torch.noc import sim
    key = (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)
    b, m = wire.length.shape
    a = sim.make_state(cfg, m, batch=b, device="cuda")
    p = sim.SimState(*(leaf.clone() for leaf in a))
    fullest = 0
    for chunk_i in range(chunks):
        a = router_step.router_step(a, wire, mc, 128, key, True)
        p = ref.router_step_ref(p, wire, mc, 128, key, True)
        torch.cuda.synchronize()
        for name, u, v in zip(a._fields, a, p):
            if name == "fifo":
                u, v = u[:, :cfg.num_routers], v[:, :cfg.num_routers]
            if not torch.equal(u, v):
                fail(f"router kernel != plain step on {label}: leaf {name} "
                     f"after chunk {chunk_i}")
        fullest = max(fullest, int(a.count[:, :cfg.num_routers, 4].max()))
    return a, fullest


def random_words(rng, shape):
    import torch
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).cuda()


def chain_edge_inputs(rng, planes: int, w: int):
    """(P, 8, W) partitioned chain planes, (8,) live counts and (8, 8) start
    positions on the card for the chain's edge cases, made as
    tests/test_torch_chain_greedy.py makes them: random words with live
    counts anywhere in [0, W] (rows 0-4, row 4 with bit 31 set in every
    word), z = 0 (row 5), z = 1 (row 6: the later candidates are visited
    or zero-region lanes) and a full row (row 7); the zero region's words
    are 0, and starts fall anywhere in the row, the zero region too."""
    import torch
    u = rng.integers(0, 2**32, (planes, 8, w), dtype=np.uint64).astype(
        np.uint32)
    u[:, 4] |= np.uint32(0x80000000)
    live = np.concatenate([rng.integers(0, w + 1, 5), [0, min(1, w), w]])
    u[:, np.arange(w)[None, :] >= live[:, None]] = 0
    start = rng.integers(0, w, (8, 8)).astype(np.int32)
    return (torch.from_numpy(u.view(np.int32)).cuda(),
            torch.from_numpy(live.astype(np.int32)).cuda(),
            torch.from_numpy(start).cuda())


# The window sort's shapes: the entry point's (512, 512), then rows that
# leave the last block part-filled (four warps a block: four rows of one
# warp, two of two) at W = 512, 128, 256, 1,024 (registers) and 2,048 (the
# shared network).
K4_SHAPES = ((512, 512), (513, 512), (2201, 128), (1031, 256), (259, 1024),
             (37, 2048))


def k4_cases():
    """The window sort's checked cases: ((R, W), key kind, payloads)."""
    return [(shape, kind, n) for shape in K4_SHAPES
            for kind in ("ties", "full") for n in (0, 1, 2)]


def k4_keys(rng, kind: str, r: int, w: int):
    """(R, W) int32 keys on the card: ``ties`` in [0, 33); ``full`` the
    whole int32 range, INT32_MIN twice and INT32_MAX in every row and a
    run of values in [-2, 2)."""
    import torch
    if kind == "ties":
        k = rng.integers(0, 33, (r, w))
    else:
        k = rng.integers(-2**31, 2**31, (r, w), dtype=np.int64)
        cols = rng.permutation(w)
        k[:, cols[:3]] = [-2**31, 2**31 - 1, -2**31]
        k[:, cols[3:9]] = rng.integers(-2, 2, (r, 6))
    return torch.from_numpy(k.astype(np.int32)).cuda()


def select_penalty(kind: str, rng, xs, k2: int):
    """(R, W) int32 chain-select penalties on the card: the chain's four
    classes; tie-heavy (-idx + {0, 1, 2}: keys dvec * k2 + small); keys
    that wrap past INT32_MAX; or the chain's classes with one key a row set
    to INT32_MIN."""
    import torch
    r, w = xs[0].shape
    idx = np.arange(w, dtype=np.int64)
    if kind == "chain":
        pen = rng.choice(PENALTIES, (r, w)).astype(np.int64)
    elif kind == "ties":
        pen = -idx[None, :] + rng.integers(0, 3, (r, w))
    elif kind == "wrap":
        pen = (2**31 - 1) - rng.integers(0, 40 * w + 1, (r, w))
    else:
        from repro_torch.kernels import ref
        pen = rng.choice(PENALTIES, (r, w)).astype(np.int64)
        d = sum(ref.popcount_ref(x) for x in xs).cpu().numpy()
        lane = rng.integers(0, w, r)
        rows = np.arange(r)
        pen[rows, lane] = -(2**31) - d[rows, lane].astype(np.int64) * k2 - lane
    pen = ((pen + 2**31) % 2**32 - 2**31).astype(np.int32)
    return torch.from_numpy(pen).cuda()


def same_bits(a, b) -> bool:
    """Equal shape, dtype and bit pattern (float payloads compared as
    their words)."""
    import torch
    from repro_torch.core.bits import words32
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(words32(a), words32(b)))


def max_err(pairs) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in pairs)


def check_sweep(rep, label: str, rows: int) -> None:
    if len(rep.rows) != rows:
        fail(f"{label}: expected {rows} rows, got {len(rep.rows)}")
    if not rep.stats["ejected_equals_injected"]:
        fail(f"{label}: a lane did not eject every injected flit")
    for r in rep.rows:
        vals = [r["total_bt"], r["cycles"], r["reduction_pct"],
                r["adjusted_reduction_pct"]]
        if not all(math.isfinite(v) for v in vals) or r["total_bt"] <= 0:
            fail(f"{label}: bad row {r}")
        if r["transform"] == "O0" and r["reduction_pct"] != 0:
            fail(f"{label}: O0 row is not its own baseline")


def check_compression_cell(rep, label: str, model: str, record: dict,
                           overhead: dict) -> dict:
    """Hold a compression cell's rows to experiments/compression.json:
    cycles and flits by compression, overhead_bits by transform, msr
    flits <= none flits, every lane drained, every total in (0, 2^31).
    Prints each row beside the record's totals (the port's image is not
    the reference's, so its totals are not targets). Returns the record."""
    with open(os.path.join(REPO, "experiments", "compression.json")) as f:
        rec = json.load(f)
    check_sweep(rep, label, 8)
    flits = {r["compression"]: r["flits"] for r in rep.rows}
    if not flits["msr"] <= flits["none"]:
        fail(f"{label}: msr sends {flits['msr']} flits, none {flits['none']}")
    for r in rep.rows:
        comp, tr = r["compression"], r["transform"]
        want = rec[f"{COMP_RECORD_KEY[model]}/{tr}/{comp}"]
        got = (r["cycles"], r["flits"], r["overhead_bits"])
        target = record[comp] + (overhead[tr],)
        print(f"  {comp:4s} {tr}: cycles {r['cycles']} flits {r['flits']} "
              f"overhead_bits {r['overhead_bits']} "
              f"({'==' if got == target else '!='} the record's {target}); "
              f"total_bt {r['total_bt']} (record {want['total_bt']}), "
              f"compression_overhead_bits {r['compression_overhead_bits']} "
              f"(record {want['compression_overhead_bits']}), adjusted "
              f"reduction {r['adjusted_reduction_pct']:.2f}%", flush=True)
        if got != target:
            fail(f"{label} {comp}/{tr}: (cycles, flits, overhead_bits) "
                 f"{got}, the reference recorded {target}")
        if not 0 < r["total_bt"] < 2**31:
            fail(f"{label} {comp}/{tr}: total_bt {r['total_bt']} outside "
                 "(0, 2^31) (ROADMAP C5)")
        if (comp == "msr") != (r["compression_overhead_bits"] > 0):
            fail(f"{label} {comp}/{tr}: compression_overhead_bits "
                 f"{r['compression_overhead_bits']}")
    return rec


def _faults_entry(task):
    """One rate x protection entry of the faults cell, its O0/O1/O2 lanes
    drained in lockstep (a process-pool task: the batch comes on the CPU
    and moves to ``device``). Returns (lanes, seconds)."""
    import torch
    from repro_torch.noc import faults
    cfg, batch, model, device = task
    t0 = time.perf_counter()
    lanes = faults.simulate_faulty_batch(cfg, batch, model,
                                         chunk=FAULT_CHUNK, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return lanes, time.perf_counter() - t0


def _one_torch_thread() -> None:
    import torch
    torch.set_num_threads(1)


def run_faults_cell(layers, card: str, device: str = "cuda") -> dict:
    """benchmarks/faults.py's cell whole on ``device``: the null-model pin
    (``simulate`` against ``simulate_faulty(FaultModel())``), the rate x
    protection matrix with O0/O1/O2 drained as lockstep lanes of one batch,
    the dead link and the dead router; every entry held to BENCH_noc.json's
    schedule columns and every ledger to its conservation identity.
    Returns the phase's report; any mismatch fails the script."""
    import torch
    from repro_torch.core.wire import by_name
    from repro_torch.noc import faults, sim
    from repro_torch.noc.sweep import recovery_overhead_bits
    from repro_torch.noc.topology import make_noc
    from repro_torch.noc.traffic import build_traffic_batch
    from repro_torch.quant import quantize_fixed8

    with open(os.path.join(REPO, "BENCH_noc.json")) as f:
        record = json.load(f)["suites"]["faults"]
    want = {(e["transform"], e["fault_rate"], e["protect"]): e
            for e in record["entries"]}

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    cfg = make_noc(6, 6, 4)
    batch = build_traffic_batch(
        layers, cfg, [(by_name(tr), lambda t: quantize_fixed8(t).values)
                      for tr in FAULT_TRANSFORMS],
        max_packets_per_layer=FAULT_MAXP, device=device)
    rec = {tr: recovery_overhead_bits(layers, by_name(tr),
                                      max_packets_per_layer=FAULT_MAXP)
           for tr in FAULT_TRANSFORMS}
    # Seconds and stepped cycles: three lockstep lanes with flips and
    # codes (the matrix), one lane with them (FAULT_SINGLE alone), and
    # one lane without (the null pin and the hard faults: the detour table
    # and the ledgers only).
    timed = {"three_lanes": [0.0, 0], "one_lane": [0.0, 0],
             "one_lane_no_flips": [0.0, 0]}

    def drain(fn, lanes_key):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        dt = time.perf_counter() - t0
        first = out[0] if isinstance(out, list) else out
        timed[lanes_key][0] += dt
        timed[lanes_key][1] += first.sim.cycles
        return out, dt

    # The null-model pin: the clean drain (the router kernel on the card)
    # against the faulty drain with nothing injected (the plain step).
    clean = sim.simulate(cfg, batch.variant(0), chunk=FAULT_CHUNK,
                         device=device)
    fd0, _ = drain(lambda: faults.simulate_faulty(
        cfg, batch.variant(0), faults.FaultModel(), chunk=FAULT_CHUNK,
        device=device), "one_lane_no_flips")
    pin = (clean.total_bt == fd0.sim.total_bt
           and clean.drain_cycle == fd0.sim.drain_cycle
           and np.array_equal(clean.link_bt, fd0.sim.link_bt))
    if not pin:
        fail(f"null FaultModel drain != simulate(): bt {clean.total_bt} vs "
             f"{fd0.sim.total_bt}, cycles {clean.drain_cycle} vs "
             f"{fd0.sim.drain_cycle}")
    print(f"  [{card}] null-model pin: simulate ({device} "
          f"{'router kernel' if device == 'cuda' else 'plain step'}) == "
          f"simulate_faulty(FaultModel()) (plain step): total_bt "
          f"{clean.total_bt}, link_bt equal, drain cycle "
          f"{clean.drain_cycle}", flush=True)

    # The matrix's entries are independent drains of the host-bound
    # faulty step: on the card they run in spawned processes, one a host
    # core up to one an entry, as run_serving drains its points (each
    # entry's seconds are then its own process's, beside the others).
    keys = [(protect, rate) for protect in FAULT_PROTECTS
            for rate in FAULT_RATES]
    tasks = [(cfg, type(batch)(*(x.to("cpu", copy=True) for x in batch[:6]),
                               num_packets=batch.num_packets),
              faults.FaultModel(rate=rate, protect=protect, seed=FAULT_SEED),
              device) for protect, rate in keys]
    procs = (min(len(tasks), len(os.sched_getaffinity(0)))
             if device == "cuda" else 1)
    t_matrix = time.perf_counter()
    if procs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                procs, mp_context=multiprocessing.get_context("spawn"),
                initializer=_one_torch_thread) as ex:
            done = list(ex.map(_faults_entry, tasks))
    else:
        done = [_faults_entry(t) for t in tasks]
    matrix_s = time.perf_counter() - t_matrix
    entries, drains = [], {}
    for (protect, rate), (lanes, dt) in zip(keys, done):
        timed["three_lanes"][0] += dt
        timed["three_lanes"][1] += lanes[0].sim.cycles
        base_adj = None
        for tr, fd in zip(FAULT_TRANSFORMS, lanes):
            led = fd.ledger
            if not led["conservation_ok"]:
                fail(f"conservation violated at rate={rate} "
                     f"protect={protect} transform={tr}: {led}")
            adj = (fd.sim.total_bt + rec[tr] // 2
                   + led["protection_overhead_bits"] // 2)
            base_adj = adj if tr == "O0" else base_adj
            got = {"drain_cycle": fd.sim.drain_cycle,
                   **{k: led[k] for k in FAULT_SCHEDULE_COLUMNS[1:]}}
            ref = want[(tr, rate, protect)]
            bad = {k: (got[k], ref[k]) for k in FAULT_SCHEDULE_COLUMNS
                   if got[k] != ref[k]}
            if bad:
                fail(f"faults {tr} rate {rate} {protect}: (port, "
                     f"record) differ in {bad}")
            entries.append({
                "transform": tr, "fault_rate": rate, "protect": protect,
                **got, "total_bt": fd.sim.total_bt, "adjusted_bt": adj,
                "adjusted_reduction_pct": (1 - adj / base_adj) * 100,
                "record_total_bt": ref["total_bt"],
                "record_adjusted_reduction_pct":
                    ref["adjusted_reduction_pct"],
                "drain_s": dt})
            drains[(tr, rate, protect)] = fd
        e = entries[-1]
        print(f"  [{card}] rate {rate:g} {protect}: drain cycle "
              f"{e['drain_cycle']}, {e['transmitted_flits']} flits, "
              f"{e['delivered']} delivered / {e['retry_exhausted']} "
              f"exhausted, {e['total_retries']} retries, "
              f"{e['flip_events']} flips, {e['silent_corrupt']} silent, "
              f"{e['transmission_rounds']} rounds (== record); adjusted "
              "reduction O1 / O2 "
              + " / ".join(f"{x['adjusted_reduction_pct']:.3f}"
                           for x in entries[-2:])
              + " % (record "
              + " / ".join(f"{x['record_adjusted_reduction_pct']}"
                           for x in entries[-2:])
              + f" %); {dt:.3f} s for 3 lanes", flush=True)

    hard = {}
    for name, model in (
            ("dead_link", faults.FaultModel(dead_links=((cfg.cols + 1, 0),),
                                            seed=FAULT_SEED)),
            ("dead_router", faults.FaultModel(dead_routers=(cfg.cols + 1,),
                                              seed=FAULT_SEED))):
        fd, dt = drain(lambda: faults.simulate_faulty(
            cfg, batch.variant(0), model, chunk=FAULT_CHUNK, device=device),
            "one_lane_no_flips")
        led = fd.ledger
        rec_h = record["hard_faults"][name]
        got_h = {k: led[k] for k in rec_h}
        if (got_h != rec_h or (led["delivered"], led["dropped"])
                != FAULT_HARD[name]):
            fail(f"{name}: ledger {got_h} != record {rec_h}")
        hard[name] = {**got_h, "total_bt": fd.sim.total_bt,
                      "drain_cycle": fd.sim.drain_cycle, "drain_s": dt}
        print(f"  [{card}] {name}: {led['delivered']} of "
              f"{led['injected_packets']} delivered, {led['dropped']} "
              f"dropped, ledger closes (== record); drain cycle "
              f"{fd.sim.drain_cycle}", flush=True)

    # One lockstep lane alone: the same drain as the batch's lane.
    tr1, rate1, prot1 = key = FAULT_SINGLE
    single, _ = drain(lambda: faults.simulate_faulty(
        cfg, batch.variant(FAULT_TRANSFORMS.index(tr1)),
        faults.FaultModel(rate=rate1, protect=prot1, seed=FAULT_SEED),
        chunk=FAULT_CHUNK, device=device), "one_lane")
    diff = [f.name for f in dataclasses.fields(single)
            if not same_fault_field(getattr(single, f.name),
                                    getattr(drains[key], f.name))]
    if diff:
        fail(f"the {tr1} / {rate1:g} / {prot1} drain alone differs from its "
             f"lane of the three-lane batch in {diff}")
    wall = time.perf_counter() - t_phase
    ms_cycle = {k: (v[0] / v[1] * 1e3 if v[1] else None)
                for k, v in timed.items()}
    print(f"  [{card}] {tr1} / {rate1:g} / {prot1} alone == its lane of the "
          f"batch; the matrix's {len(tasks)} entries in {procs} "
          f"process(es): {matrix_s:.3f} s; faulty step on {device}: "
          f"{ms_cycle['three_lanes']:.3f} ms a cycle at three lanes, each "
          f"entry in its process beside up to {procs - 1} others on shared "
          f"host cores ({timed['three_lanes'][1]} cycles), "
          f"{ms_cycle['one_lane']:.3f} at one ({timed['one_lane'][1]}), "
          f"{ms_cycle['one_lane_no_flips']:.3f} at one with no flips or "
          f"codes ({timed['one_lane_no_flips'][1]}); phase wall {wall:.3f} s",
          flush=True)
    return {"entries": entries, "hard_faults": hard,
            "zero_fault_identical": pin, "ms_per_cycle": ms_cycle,
            # three_lanes is timed with matrix_processes entries at once
            "matrix_s": matrix_s, "matrix_processes": procs,
            "cycles": {k: v[1] for k, v in timed.items()},
            "wall_s": wall, "single": single, "batch": batch, "cfg": cfg}


def o0_phase_traffic(layers, cfg, max_packets: int, device: str):
    """One inference's O0 fixed8 request and result traffic (unbatched),
    as ``run_serving`` builds it."""
    from repro_torch.core.wire import by_name
    from repro_torch.noc.traffic import (build_result_traffic,
                                         build_traffic_batch)
    from repro_torch.quant import quantize_fixed8
    o0 = [(by_name("O0"), lambda t: quantize_fixed8(t).values)]
    req = build_traffic_batch(layers, cfg, o0,
                              max_packets_per_layer=max_packets,
                              device=device).variant(0)
    res = build_result_traffic(layers, cfg, o0,
                               max_packets_per_layer=max_packets,
                               device=device).variant(0)
    return req, res


def same_online(a, b) -> list:
    """Names of the OnlineResult fields (and properties) that differ."""
    names = [f.name for f in dataclasses.fields(a)]
    names += ["completed", "throughput", "num_shed", "num_failed",
              "slo_attainment", "goodput"]
    return [n for n in names
            if not same_fault_field(getattr(a, n), getattr(b, n))]


def run_serving_phase(dlayers, llayers, card: str,
                      device: str = "cuda") -> dict:
    """benchmarks/serving.py's DarkNet grid whole on the card, after timing
    the gated step at 16x16; then the load-16 rate-0 point again with the
    canonical phase drains through the router kernel, and one LeNet point
    that sheds under faults on the card and on the CPU. Any mismatch with
    experiments/serving_darknet.json fails the script. ``device="cpu"``
    runs the same checks on the plain path (no profiler window, and the
    LeNet point compared with itself)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    from repro_torch.noc import SweepGrid, faults, online, run_serving
    from repro_torch.noc.topology import mesh_by_name
    from repro_torch.noc.traffic import concat_inferences

    with open(os.path.join(REPO, "experiments", "serving_darknet.json")) as f:
        record = json.load(f)
    rsrv = record["stats"]["serving"]
    t_phase = time.perf_counter()
    g = SERVING_DARKNET
    cfg = mesh_by_name(g["meshes"][0])
    req, res = o0_phase_traffic(dlayers, cfg, g["max_packets_per_layer"],
                                device)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    # Measure first: SERVING_TIMED_CYCLES gated cycles of the load-1
    # request drain, clean and at rate 5e-3 under crc8, one lane each (a
    # 64-cycle warm-up each).
    k = g["serving_inferences"]
    arr = online.ArrivalProcess(g["arrival"], 1.0).times(k)
    cat = concat_inferences(req, k)
    m = int(req.length.shape[0])
    rel = np.broadcast_to(arr[None, :], (m, k))
    inc = np.broadcast_to(req.length.cpu().numpy().astype(np.int64)[:, None],
                          (m, k))
    nodes = np.asarray(cfg.mc_nodes, np.int32)
    fmodel = faults.FaultModel(rate=5e-3, protect=g["fault_protect"],
                               seed=0, max_retries=3, ack_latency=32)

    def clean(cycles):
        return online._drain_gated(
            cfg, cat, nodes, rel, inc, count_headers=True, chunk=cycles,
            max_cycles=cycles, allow_truncation=True)

    def faulty(cycles):
        return faults.drain_with_retries(
            cfg, cat, fmodel, mc_nodes=nodes, release=rel, inc=inc,
            chunk=cycles, max_cycles=cycles, allow_truncation=True,
            device=device)

    ms_cycle = {}
    for name, fn in (("clean", clean), ("faulty", faulty)):
        fn(64)
        sync()
        t0 = time.perf_counter()
        fn(SERVING_TIMED_CYCLES)
        sync()
        ms_cycle[name] = ((time.perf_counter() - t0) / SERVING_TIMED_CYCLES
                          * 1e3)
    projected = (SERVING_FAULTY_CYCLES * ms_cycle["faulty"]
                 + SERVING_CLEAN_CYCLES * ms_cycle["clean"]) / 1e3
    print(f"  [{card}] gated step at 16x16, one lane: "
          f"{ms_cycle['clean']:.3f} ms a cycle clean, "
          f"{ms_cycle['faulty']:.3f} ms with flips and crc8 "
          f"({SERVING_TIMED_CYCLES:,} cycles each); projected grid drains {projected:.1f} s for "
          f"{SERVING_FAULTY_CYCLES} faulty + {SERVING_CLEAN_CYCLES} clean "
          "cycles", flush=True)

    # The device's idle share over 128 gated cycles (clean, one lane) in
    # one profiler window.
    share = busy = window_ms = None
    if device == "cuda":
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            clean(128)
            sync()
            window_ms = (time.perf_counter() - t0) * 1e3
        spans = device_spans(prof)
        busy = busy_us(spans) / 1e3
        share = (1 - busy / window_ms) if spans else None
        print(f"  [{card}] 128 gated cycles in a profiler window: device "
              f"idle share "
              f"{'not measured' if share is None else f'{share:.4f}'} "
              f"(busy {busy:.3f} ms of {window_ms:.3f} ms)", flush=True)

    # The grid whole, as the record was made.
    t0 = time.perf_counter()
    rep = run_serving(SweepGrid(**g, device=device), lambda _name: dlayers,
                      check_conservation=True)
    sync()
    grid_s = time.perf_counter() - t0
    srv = rep.stats["serving"]
    if len(srv["points"]) != len(rsrv["points"]):
        fail(f"serving grid made {len(srv['points'])} points, the record "
             f"{len(rsrv['points'])}")
    for p, q in zip(srv["points"], rsrv["points"]):
        bad = {c: (p[c], q[c]) for c in SERVING_POINT_COLUMNS + (
            "offered_load", "fault_rate") if p[c] != q[c]}
        if bad:
            fail(f"serving point load {q['offered_load']} rate "
                 f"{q['fault_rate']}: (port, record) differ in {bad}")
        print(f"  [{card}] load {p['offered_load']:g} rate "
              f"{p['fault_rate']:g}: p50 {p['p50_latency']} p99 "
              f"{p['p99_latency']} mean {p['mean_latency']} tput "
              f"{p['throughput']} goodput {p['goodput']} slo "
              f"{p['slo_attainment']} completed {p['completed']} truncated "
              f"{p['truncated']} shed {p['shed']} failed {p['failed']} "
              f"drains {p['request_drain_cycle']} / "
              f"{p['result_drain_cycle']} (== record)", flush=True)
    combo, rcombo = srv["combos"][0], rsrv["combos"][0]
    bad = {c: (combo.get(c), rcombo.get(c)) for c in SERVING_COMBO_COLUMNS
           if combo.get(c) != rcombo.get(c)}
    if bad:
        fail(f"serving combo: (port, record) differ in {bad}")
    if len(rep.rows) != len(record["rows"]):
        fail(f"serving grid made {len(rep.rows)} rows, the record "
             f"{len(record['rows'])}")
    for r, q in zip(rep.rows, record["rows"]):
        bad = {c: (r[c], q[c]) for c in SERVING_ROW_COLUMNS if r[c] != q[c]}
        if bad or r["transform"] != q["transform"]:
            fail(f"serving row {q['transform']}: (port, record) differ in "
                 f"{bad}")
        for c in ("total_bt", "result_bt"):
            if not 0 < r[c] < 2**31:
                fail(f"serving row {r['transform']}: {c} {r[c]} outside "
                     "(0, 2^31) (ROADMAP C5)")
        print(f"  [{card}] row {r['transform']}: cycles {r['cycles']} flits "
              f"{r['flits']} result {r['result_cycles']} / "
              f"{r['result_flits']} (== record); total_bt {r['total_bt']} "
              f"(record {q['total_bt']}) result_bt {r['result_bt']} (record "
              f"{q['result_bt']}); adjusted reduction "
              f"{r['adjusted_reduction_pct']:.3f} % (record "
              f"{q['adjusted_reduction_pct']:.3f} %)", flush=True)
    if srv["stepped_cycles"] != SERVING_STEPPED:
        fail(f"the serving grid stepped {srv['stepped_cycles']} gated "
             f"cycles, {SERVING_STEPPED} expected")
    print(f"  [{card}] combo: saturation {combo['saturation_tput']} "
          f"latency_monotone {combo['latency_monotone']} "
          f"slo_monotone_in_fault {combo['slo_monotone_in_fault']} (== "
          f"record); {srv['stepped_cycles']} gated cycles stepped; grid "
          f"{grid_s:.3f} s (serving {srv['serving_s']} s in "
          f"{srv['workers']} worker processes, {projected:.1f} s projected "
          f"for one; rows {rep.stats['wall_s']} s)", flush=True)

    # K1 on the path: the load-16 rate-0 point again with the canonical
    # phase drains, which carry no ledger and run the router kernel (the
    # grid's shortest rate-0 point: 4,096 gated cycles, load 1's 16,384).
    k1 = {kk.name: kk for kk in ops.KERNELS}["router_step"]
    k1_before = k1.launches
    load_k1 = SERVING_RECORD_BT_LOAD
    onl = online.simulate_online(
        cfg, req, res, arrivals=online.ArrivalProcess(g["arrival"], load_k1),
        num_inferences=k, compute_latency=g["compute_latency"],
        chunk=g["chunk"], record_bt=True, check_conservation=False,
        device=device)
    k1_launches = k1.launches - k1_before
    if device == "cuda" and k1_launches <= 0:
        fail("the canonical phase drains did not launch the router kernel")
    o0 = rep.row(transform="O0")
    got = (onl.request.total_bt, onl.request.drain_cycle,
           onl.request.injected, onl.result.total_bt,
           onl.result.drain_cycle, onl.result.injected)
    want = (o0["total_bt"], o0["cycles"], o0["flits"], o0["result_bt"],
            o0["result_cycles"], o0["result_flits"])
    if got != want:
        fail(f"the canonical phase drains {got} != the O0 row {want}")
    p0, = [p for p in srv["points"] if p["offered_load"] == load_k1
           and p["fault_rate"] == 0]
    if (onl.request_drain_cycle, onl.result_drain_cycle) != (
            p0["request_drain_cycle"], p0["result_drain_cycle"]):
        fail(f"the load-{load_k1:g} rate-0 point drained differently with "
             "record_bt")
    print(f"  [{card}] load {load_k1:g} / rate 0 with record_bt "
          f"({onl.stepped_cycles} "
          f"gated cycles): canonical request "
          f"(total_bt, cycles, flits) {got[:3]} and result {got[3:]} == the "
          f"O0 row ({k1_launches} router-kernel launches)", flush=True)

    # Shedding and faults: one LeNet point on the card and on the CPU.
    L = SERVING_LENET
    lcfg = mesh_by_name(L["mesh"])
    lreq, lres = o0_phase_traffic(llayers, lcfg, L["max_packets"], device)
    kw = dict(arrivals=online.ArrivalProcess("uniform", L["load"]),
              num_inferences=L["inferences"], compute_latency=32,
              chunk=L["chunk"], admit_queue_depth=L["admit_queue_depth"],
              deadline=20000, check_conservation=True, record_bt=False)
    t0 = time.perf_counter()
    on_card = online.simulate_online(
        lcfg, lreq, lres, faults=faults.FaultModel(rate=L["rate"],
                                                   protect="crc8"),
        device=device, **kw)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = online.simulate_online(
        lcfg, lreq, lres, faults=faults.FaultModel(rate=L["rate"],
                                                   protect="crc8"),
        device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    diff = same_online(on_card, on_cpu)
    if diff:
        fail(f"the LeNet serving point differs between card and CPU in "
             f"{diff}")
    if on_card.num_shed < 1:
        fail("the LeNet serving point shed nothing")
    print(f"  [{card}] LeNet {L['mesh']} x {L['inferences']} at load "
          f"{L['load']:g}, depth {L['admit_queue_depth']}, rate "
          f"{L['rate']:g} crc8: shed {on_card.num_shed}, failed "
          f"{on_card.num_failed}, completed {on_card.completed}, "
          f"{on_card.stepped_cycles} gated cycles (replays included); every "
          f"OnlineResult field equal on the card ({t_card:.3f} s) and the "
          f"CPU ({t_cpu:.3f} s)", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"  [{card}] serving phase wall {wall:.3f} s", flush=True)
    return {"points": srv["points"], "combos": srv["combos"],
            "rows": rep.rows, "stats": {kk: v for kk, v in rep.stats.items()
                                        if kk != "serving"},
            "serving_s": srv["serving_s"],
            "stepped_cycles": srv["stepped_cycles"], "grid_s": grid_s,
            "ms_per_cycle": ms_cycle, "projected_s": projected,
            "idle_share": share, "busy_ms": busy, "window_ms": window_ms,
            "canonical_k1_launches": k1_launches,
            "lenet_point": {"shed": on_card.num_shed,
                            "failed": on_card.num_failed,
                            "completed": on_card.completed,
                            "stepped_cycles": on_card.stepped_cycles,
                            "card_s": t_card, "cpu_s": t_cpu},
            "wall_s": wall}


def same_fault_field(a, b) -> bool:
    """Two values of one FaultDrain field equal: arrays element for
    element, a SimResult field for field, anything else by ``==``."""
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if dataclasses.is_dataclass(a):
        return all(same_fault_field(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    return a == b


def sweep_streams(cfg) -> int:
    """MC streams of ``cfg``'s drains in the sweep: padded to the most MCs
    of a paper mesh of the same size (8 for both 8x8 meshes)."""
    from repro_torch.noc.topology import mesh_by_name
    return max(mesh_by_name(n).num_mcs for n in MESHES
               if mesh_by_name(n).num_routers == cfg.num_routers)


def same_results(a, b) -> bool:
    """Two lists of SimResults equal field for field."""
    return len(a) == len(b) and all(same_fault_field(x, y)
                                    for x, y in zip(a, b))


def run_shard_phase(dlayers, layers, unsharded, card: str,
                    device: str = "cuda") -> dict:
    """The sharded drains (ROADMAP A15) on ``device``: the full DarkNet
    cell over two shards of one device (rows equal to ``unsharded``, the
    cell's one-device run, and to the record), the pinned LeNet 4x4_mc2
    batch over the device and the host with and without the conservation
    ledger, three lanes padded onto two shards and six lanes of two lengths
    compacted to two rows, each equal to the one-device drain, and
    ``run_sweep(devices="auto")``. Returns the phase's report, with the
    kernel launches of the sharded calls."""
    import torch
    from repro_torch.core.wire import by_name
    from repro_torch.kernels import ops
    from repro_torch.noc import SweepGrid, run_sweep, sim
    from repro_torch.noc.sweep import _concat_lanes, _take_lanes
    from repro_torch.noc.topology import mesh_by_name
    from repro_torch.noc.traffic import build_traffic_batch, pad_traffic_length
    from repro_torch.quant import quantize_fixed8

    d0 = "cuda:0" if device == "cuda" else device
    two, mixed = [d0, d0], [d0, "cpu"]

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cfg = mesh_by_name("4x4_mc2")
    variants = [(by_name(tr, tiebreak=tb), None if prec == "float32" else
                 (lambda t: quantize_fixed8(t).values))
                for prec in ("float32", "fixed8")
                for tb in ("stable", "pattern") for tr in ("O0", "O1", "O2")]
    batch = build_traffic_batch(layers, cfg, variants,
                                max_packets_per_layer=SHARD_MAXP,
                                device=device)
    three = batch._replace(**{f: getattr(batch, f)[:3]
                              for f in sim.Traffic._fields[:6]})
    # Six lanes of two lengths, one long lane a shard: the four short ones
    # retire first and the two survivors compact to two rows.
    long_ = build_traffic_batch(layers, cfg, variants[:2],
                                max_packets_per_layer=SHARD_MAXP,
                                device=device)
    short = build_traffic_batch(layers, cfg, variants[:4],
                                max_packets_per_layer=SHARD_SHORT_MAXP,
                                device=device)
    t_len = int(long_.words.shape[-2])
    ragged = _take_lanes(_concat_lanes([pad_traffic_length(long_, t_len),
                                        pad_traffic_length(short, t_len)]),
                         np.array([0, 2, 3, 1, 4, 5]))

    ops.reset_launch_counts()
    rep2, wall2 = timed(lambda: run_sweep(SweepGrid(**DARKNET_FULL,
                                                    device=device),
                                          lambda _name: dlayers,
                                          devices=two))
    mixed_runs = {checked: timed(lambda checked=checked: sim.simulate_batch(
        cfg, batch, chunk=SHARD_CHUNK, check_conservation=checked,
        devices=mixed)) for checked in (False, True)}
    padded, _ = timed(lambda: sim.simulate_batch(cfg, three,
                                                 chunk=SHARD_CHUNK,
                                                 devices=two))
    widths = []
    regroup = sim._regroup

    def spy(shards, rows, devs):
        widths.append(len(list(rows)))
        return regroup(shards, rows, devs)

    sim._regroup = spy
    try:
        compacted, _ = timed(lambda: sim.simulate_batch(
            cfg, ragged, chunk=SHARD_RAGGED_CHUNK, devices=two))
    finally:
        sim._regroup = regroup
    launches = {k.name: k.launches for k in ops.KERNELS}

    check_sweep(rep2, "two-shard DarkNet cell", 12)
    if rep2.stats["devices"] != 2:
        fail(f"two-shard DarkNet cell: stats['devices'] "
             f"{rep2.stats['devices']}, expected 2")
    if rep2.rows != unsharded.rows:
        fail("two-shard DarkNet cell rows differ from the one-device run's")
    for r in rep2.rows:
        got = (r["cycles"], r["flits"], r["result_cycles"],
               r["result_flits"])
        want = DARKNET_FULL_RECORD[(r["placement"], r["affinity"])]
        if got != want:
            fail(f"two-shard DarkNet {r['placement']}/{r['affinity']} "
                 f"{r['transform']}: {got}, the reference recorded {want}")
    drain = max(r["cycles"] for r in rep2.rows)
    us2 = rep2.stats["simulate_s"] * 1e6 / drain
    us1 = unsharded.stats["simulate_s"] * 1e6 / drain
    print(f"  [{card}] full DarkNet cell over {two}: 12 rows == the "
          f"one-device run's and the record's cycles, flits, result_cycles "
          f"and result_flits; request drain {us2:.3f} us a simulated cycle "
          f"(one device: {us1:.3f}), simulate {rep2.stats['simulate_s']} s, "
          f"result simulate {rep2.stats['result_simulate_s']} s, sweep wall "
          f"{wall2:.3f} s", flush=True)

    one = {checked: timed(lambda checked=checked: sim.simulate_batch(
        cfg, batch, chunk=SHARD_CHUNK, check_conservation=checked,
        device=device)) for checked in (False, True)}
    for checked in (False, True):
        if not same_results(mixed_runs[checked][0], one[checked][0]):
            fail(f"the {mixed} drain (check_conservation={checked}) != the "
                 "one-device drain")
    if not same_results(padded, sim.simulate_batch(cfg, three,
                                                   chunk=SHARD_CHUNK,
                                                   device=device)):
        fail(f"three lanes on {two} (padded to four) != the one-device "
             "drain")
    if widths != [6, 2]:
        fail(f"the ragged drain on {two} placed and compacted {widths} "
             "rows, expected [6, 2]")
    if not same_results(compacted, sim.simulate_batch(
            cfg, ragged, chunk=SHARD_RAGGED_CHUNK, device=device)):
        fail(f"the compacted drain on {two} != the one-device drain")
    print(f"  pinned LeNet 4x4_mc2 batch (12 lanes, {SHARD_MAXP} packets a "
          f"layer) over {mixed}: == the one-device drain, "
          f"{mixed_runs[False][1]:.3f} s (one device "
          f"{one[False][1]:.3f} s), with the ledger "
          f"{mixed_runs[True][1]:.3f} s (one device {one[True][1]:.3f} s); "
          f"3 lanes padded onto 2 shards ==; 6 ragged lanes compacted "
          f"6 -> 2 rows ==", flush=True)

    auto = run_sweep(SweepGrid(meshes=("4x4_mc2",), transforms=("O0", "O1"),
                               tiebreaks=("pattern",), precisions=("fixed8",),
                               models=("lenet",),
                               max_packets_per_layer=SHARD_MAXP,
                               chunk=SHARD_CHUNK, device=device),
                     lambda _name: layers)
    count = torch.cuda.device_count() if device == "cuda" else 1
    if auto.stats["devices"] != count:
        fail(f"run_sweep(devices='auto') drained on {auto.stats['devices']} "
             f"devices, the host shows {count}")
    print(f"  run_sweep(devices='auto'): {auto.stats['devices']} device(s), "
          f"as many as the host shows; launches of the sharded calls "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return {"darknet_rows": rep2.rows, "darknet_stats": rep2.stats,
            "darknet_wall_s": wall2, "us_per_cycle": us2,
            "us_per_cycle_one_device": us1,
            "mixed_s": {str(k): v[1] for k, v in mixed_runs.items()},
            "one_device_s": {str(k): v[1] for k, v in one.items()},
            "compaction_rows": widths, "auto_devices": auto.stats["devices"],
            "launches": launches}


def run_dist_phase(lparams, dnet, card: str, device: str = "cuda") -> dict:
    """The ``dist`` package (ROADMAP A16) on ``device``: the static layout
    of the trained LeNet's fc1 block held to BENCH_noc.json's
    ``suites.static_layout.trained``, the gradient wire report of the
    trained DarkNet's whole parameter tree (gradients by autograd on a
    seeded glyph batch) at each window, both equal to the CPU's plain path
    on the same tensors, the ordered bucket and bucketing round trips, and
    DarkNet's parameters distributed over a one-rank DTensor mesh and
    gathered back. Returns the phase's report, with the kernel launches of
    the two reports."""
    import torch
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import tree
    from repro_torch.data import glyph_batch
    from repro_torch.dist import (DEFAULT_RULES, bucketed,
                                  gradient_wire_report,
                                  order_gradient_bucket, reorder_lm_params,
                                  restore_gradient_bucket, spec_shardings,
                                  stream_bt_report, unbucket)
    from repro_torch.kernels import ops

    with open(os.path.join(REPO, "BENCH_noc.json")) as f:
        record = json.load(f)["suites"]["static_layout"]["trained"]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def host_ms(fn, reps: int = 5) -> float:
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        return (time.perf_counter() - t0) * 1e3 / reps

    def on_cpu(t):
        return tree.map_leaves(lambda x: x.cpu(), t)

    blocks = {"fc1": {"wu": lparams["f1w"], "wd": lparams["f2w"]}}
    gen = torch.Generator(device=device).manual_seed(GRAD_SEED)
    x, y = glyph_batch(gen, GRAD_BATCH, hw=64, channels=3, device=device)
    params = {n: p.detach() for n, p in dnet.named_parameters()}
    grads = dnet.grads(x, y)
    nvals = sum(t.numel() for t in tree.leaves(params))

    ops.reset_launch_counts()
    static = stream_bt_report(blocks, reorder_lm_params(blocks))
    reports = {w: gradient_wire_report(grads, params, window=w)
               for w in GRAD_WINDOWS}
    sync()
    launches = {k.name: k.launches for k in ops.KERNELS}

    got = {k: float(v) for k, v in static.items()}
    if got != record:
        fail(f"static layout of the trained LeNet's fc1 block {got} != "
             f"BENCH_noc.json suites.static_layout.trained {record}")
    cblocks = on_cpu(blocks)
    plain = stream_bt_report(cblocks, reorder_lm_params(cblocks))
    if {k: float(v) for k, v in plain.items()} != got:
        fail("static layout on the card != the CPU's plain path")
    print(f"  [{card}] static layout, trained LeNet fc1 (f1w 400x120 with "
          f"f2w 120x84): BT/flit {got['bt_per_flit_before']!r} -> "
          f"{got['bt_per_flit_after']!r}, reduction {got['reduction']!r} "
          "== BENCH_noc.json and == the CPU's plain path", flush=True)

    cgrads, cparams = on_cpu(grads), on_cpu(params)
    rows = {}
    for w, rep in reports.items():
        want = gradient_wire_report(cgrads, cparams, window=w)
        row = {k: (v if isinstance(v, int) else v.item())
               for k, v in rep.items()}
        if row != {k: (v if isinstance(v, int) else v.item())
                   for k, v in want.items()}:
            fail(f"gradient wire report at window {w}: card {row} != the "
                 f"CPU's plain path")
        rows[str(w)] = row
        print(f"  gradient wire, trained DarkNet ({nvals} values, "
              f"{GRAD_BATCH} glyph images), window {w}: BT "
              f"{row['bt_baseline']} / O1 {row['bt_o1']} / O2 "
              f"{row['bt_o2']}, reduction O1 {row['reduction_o1']:.6f} O2 "
              f"{row['reduction_o2']:.6f}, {row['o2_index_bits']} index "
              "bits; == the CPU's plain path", flush=True)

    flat_g = torch.cat([t.reshape(-1) for t in tree.leaves(grads)])
    flat_w = torch.cat([t.reshape(-1) for t in tree.leaves(params)])
    for w in (256, None):
        bucket = order_gradient_bucket(flat_g, flat_w, window=w)
        if not same_bits(restore_gradient_bucket(bucket, flat_g.numel()),
                         flat_g):
            fail(f"ordered gradient bucket (window {w}) did not round-trip")
    buckets = bucketed(grads, BUCKET_BYTES)
    back = unbucket(buckets, grads)
    if not all(same_bits(a, b) for a, b in zip(tree.leaves(back),
                                               tree.leaves(grads))):
        fail("bucketed / unbucket did not round-trip")

    static_ms = host_ms(lambda: stream_bt_report(blocks,
                                                 reorder_lm_params(blocks)))
    grad_ms = {str(w): host_ms(lambda w=w: gradient_wire_report(
        grads, params, window=w)) for w in GRAD_WINDOWS}
    print(f"  ordered bucket (windows 256, None) and {len(buckets)} buckets "
          f"of <= {BUCKET_BYTES} bytes round-trip bit for bit; a call on "
          f"the card: static layout report {static_ms:.3f} ms, gradient "
          f"wire report {grad_ms} ms; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)

    # DarkNet's parameters over a one-rank DTensor mesh ("data", "model"):
    # a HashStore needs no network.
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    tdist.init_process_group("nccl" if device == "cuda" else "gloo",
                             store=tdist.HashStore(), rank=0, world_size=1)
    try:
        mesh = DeviceMesh(device, torch.arange(1).reshape(1, 1),
                          mesh_dim_names=("data", "model"))
        placed = spec_shardings(type(dnet).specs(), DEFAULT_RULES, mesh)
        for name, p in params.items():
            if not torch.equal(distribute_tensor(p, mesh, placed[name])
                               .full_tensor(), p):
                fail(f"DTensor round trip of {name} under {placed[name]} "
                     "changed it")
    finally:
        tdist.destroy_process_group()
    print(f"  DTensor mesh ('data', 'model') of one rank: "
          f"{len(params)} parameters distributed and gathered back equal",
          flush=True)
    return {"static_layout": got, "gradient_wire": rows,
            "values": nvals, "static_ms": static_ms, "gradient_ms": grad_ms,
            "buckets": len(buckets),
            "placements": {k: [str(p) for p in v] for k, v in placed.items()},
            "launches": launches}


def _rel_err(got, want, vocab=None) -> float:
    """max |got - want| over max |want| (float32, over the true vocab)."""
    got, want = got.float().cpu(), want.float().cpu()
    if vocab is not None:
        got, want = got[..., :vocab], want[..., :vocab]
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def _reduced_logits(arch, params, device: str) -> list:
    """Every logits tensor of one reduced arch's serving steps on
    ``device``: prefill and LM_DECODE_STEPS teacher-forced decode steps
    (internvl2 with stubbed patch embeddings), or whisper's encoder, cross
    k / v cache and decode steps. Inputs are seeded, so every device gets
    the same ones."""
    import torch
    from repro_torch import tree
    model = arch.build_reduced()
    cfg = model.cfg
    p = tree.map_leaves(lambda x: x.to(device), params)
    rng = np.random.default_rng(LM_INPUT_SEED)
    b, s = 2, 12
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + LM_DECODE_STEPS))
                            .astype(np.int32)).to(device)
    out = []
    if arch.kind == "encdec":
        frames = torch.from_numpy(rng.standard_normal(
            (b, 10, cfg.d_model)).astype(np.float32)).to(device)
        cache = model.init_cache(b, 16, model.encode(p, frames), p)
        for i in range(LM_DECODE_STEPS):
            pos = torch.full((b,), i, dtype=torch.int32, device=device)
            lg, cache = model.decode_step(p, toks[:, i], cache, pos)
            out.append(lg)
        return out
    pe = None
    if cfg.vlm_prefix:
        pe = torch.from_numpy(rng.standard_normal(
            (b, cfg.vlm_prefix, cfg.d_model)).astype(np.float32)).to(device)
    lg, cache = model.prefill(p, toks[:, :s], 32, pe)
    out.append(lg)
    for i in range(LM_DECODE_STEPS):
        pos = torch.full((b,), s + cfg.vlm_prefix + i, dtype=torch.int32,
                         device=device)
        lg, cache = model.decode_step(p, toks[:, s + i], cache, pos)
        out.append(lg)
    return out


def run_lm_phase(card: str, device: str = "cuda") -> dict:
    """The LM stack's serving path (ROADMAP A17) on ``device``.

    1. Every arch's reduced config on the device against the CPU: the same
       seeded parameters and inputs, each step's logits within
       LM_TOLS[arch] of their largest value.
    2. LM_ARCH at full width: seeded random parameters made on the device,
       counted against ``param_count(specs)`` and LM_PARAMS;
       ``Engine.generate`` on a prompt batch, greedy;
       ``serve_offered_load`` (poisson, unpaced); prefill ms, ms a decode
       step, tokens a second and peak memory beside their bounds; on the
       card, a few decode steps in one profiler window (the device's idle
       share and the kernels that take most of its time).
    3. The static popcount layout of the whole tree (``reorder_lm_params``:
       the popcount kernel) and its stream report layer by layer (the BT
       counter; every total below 2^31); the first and the last layer's
       permutation, reordered matrices and report equal to the CPU's plain
       path (the last lies past 2^31 values into the stacked MLP block at
       full width); the reordered model's prefill and teacher-forced
       decode logits within LM_REORDER_TOL of the original's, with the
       share equal bit for bit.

    Returns the phase's report, with the kernel launches of step 3.
    """
    import torch
    from repro_torch import configs, tree
    from repro_torch.dist import (reorder_lm_params, reorder_mlp,
                                  stream_bt_report, stream_bt_total)
    from repro_torch.core.bt import per_flit
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_offered_load
    from repro_torch.models import param_bytes, param_count, init_params
    from repro_torch.serve import Engine, GenerationConfig
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def peak_gb() -> float:
        return torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0

    # 1. Reduced archs, device against the CPU.
    t_reduced = time.perf_counter()
    reduced = {}
    for name in sorted(configs.ARCHS):
        arch = configs.get(name)
        params = init_params(arch.build_reduced().specs(),
                             torch.Generator().manual_seed(LM_PARAM_SEED),
                             "cpu")
        got = _reduced_logits(arch, params, device)
        want = _reduced_logits(arch, params, "cpu")
        vocab = arch.reduced_config.vocab
        errs = [_rel_err(g, w, vocab) for g, w in zip(got, want)]
        if not all(math.isfinite(e) and e <= LM_TOLS[name] for e in errs):
            fail(f"reduced {name} on {device}: logits off the CPU's by "
                 f"{errs} of their largest value (tolerance "
                 f"{LM_TOLS[name]})")
        same = float(np.mean([bool(torch.equal(g.cpu()[..., :vocab].argmax(-1),
                                                w[..., :vocab].argmax(-1)))
                              for g, w in zip(got, want)]))
        reduced[name] = {"max_rel_err": max(errs), "tolerance": LM_TOLS[name],
                         "argmax_equal_share": same}
    print(f"  [{card}] reduced archs on {device} == the CPU (largest error "
          f"over the largest logit, tolerance; prefill + {LM_DECODE_STEPS} "
          "decode steps; whisper: encoder, cross cache, decode): " + ", ".join(
              f"{n} {r['max_rel_err']:.2e} ({r['tolerance']})"
              for n, r in reduced.items())
          + f"; {time.perf_counter() - t_reduced:.1f} s", flush=True)

    # 2. Full width: serve.
    model = configs.get(LM_ARCH).build()
    serve = LM_SERVE
    cfg = model.cfg
    specs = model.specs()
    n_params = param_count(specs)
    if n_params != LM_PARAMS:
        fail(f"{cfg.name}: param_count(specs) {n_params} != {LM_PARAMS}")
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(specs, torch.Generator(device).manual_seed(
        LM_PARAM_SEED), device)
    sync()
    init_s = time.perf_counter() - t0
    made = sum(x.numel() for x in tree.leaves(params))
    if made != n_params:
        fail(f"{cfg.name}: {made} parameters made, {n_params} specified")
    b, s, new, ctx = (serve["batch"], serve["prompt"], serve["new"],
                      serve["context"])
    tokgen = torch.Generator(device).manual_seed(LM_INPUT_SEED)
    prompts = torch.randint(0, cfg.vocab, (max(b, serve["requests"]), s),
                            generator=tokgen, device=device)
    engine = Engine(model, params, context=ctx)
    greedy = GenerationConfig(max_new_tokens=new)
    engine.generate(prompts[:b], GenerationConfig(max_new_tokens=2))  # warm
    sync()
    t0 = time.perf_counter()
    out = engine.generate(prompts[:b], greedy)
    sync()
    gen_s = time.perf_counter() - t0
    if tuple(out.shape) != (b, new) or int(out.max()) >= cfg.vocab \
            or int(out.min()) < 0:
        fail(f"{cfg.name}: generated {tuple(out.shape)} tokens in "
             f"[{int(out.min())}, {int(out.max())}], vocab {cfg.vocab}")

    def prefill():
        return model.prefill(params, prompts[:b], ctx)

    prefill()
    sync()
    t0 = time.perf_counter()
    for _ in range(LM_TIMING_REPS):
        logits, cache = prefill()
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3 / LM_TIMING_REPS
    if not bool(torch.isfinite(logits[:, :cfg.vocab]).all()):
        fail(f"{cfg.name}: prefill logits not finite")
    steps = serve["decode_steps"]
    t0 = time.perf_counter()
    for i in range(steps):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=device)
        logits, cache = model.decode_step(params, out[:, i], cache, pos)
    sync()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    if not bool(torch.isfinite(logits[:, :cfg.vocab]).all()):
        fail(f"{cfg.name}: decode logits not finite")
    # The next decode steps in one profiler window: the union of the
    # device's activity spans over the window's host time.
    trace = {"steps": serve["trace_steps"], "idle_share": None}
    if on_card:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps, steps + serve["trace_steps"]):
                pos = torch.full((b,), s + i, dtype=torch.int32,
                                 device=device)
                _, cache = model.decode_step(params, out[:, i], cache, pos)
            sync()
            window_ms = (time.perf_counter() - t0) * 1e3
        spans = device_spans(prof)
        busy = busy_us(spans) / 1e3
        trace.update(window_ms=window_ms, busy_ms=busy,
                     device_spans=len(spans))
        if spans:
            trace["idle_share"] = 1 - busy / window_ms
            trace["top_device_ms"] = sorted(
                ((e.self_device_time_total / 1e3, e.key, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA), reverse=True)[:8]
    t0 = time.perf_counter()
    outs, lat = serve_offered_load(
        engine, prompts[:serve["requests"]],
        GenerationConfig(max_new_tokens=serve["offered_new"]),
        load=serve["load"], arrival="poisson", seed=0, pace=False)
    offered_s = time.perf_counter() - t0
    if lat["count"] != serve["requests"] or any(
            tuple(o.shape) != (1, serve["offered_new"]) for o in outs):
        fail(f"{cfg.name}: offered-load run served {lat['count']} of "
             f"{serve['requests']} requests")
    serve_peak = peak_gb()

    # Bounds: a decode step reads every weight but the embedding table (B
    # rows of it) and the KV ring; a prefill does 2 flops a weight a token
    # in the blocks, the full masked (S, S) scores and values, and the last
    # position's logits.
    attn = cfg.n_layers * 4 * b * cfg.n_heads * s * s * cfg.hd
    block = sum(x.numel() for x in tree.leaves(params["blocks"])
                if x.dim() >= 3)
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    kv_bytes = sum(x.numel() * x.element_size() for x in tree.leaves(cache))
    weight_bytes = param_bytes(specs) - embed_bytes
    decode_bound = (weight_bytes + kv_bytes + b * cfg.d_model * 2) \
        / HBM_BYTES_PER_S * 1e3
    prefill_flops = 2 * block * b * s + attn + 2 * cfg.d_model * \
        cfg.padded_vocab * b
    prefill_bound = max(prefill_flops / BF16_FLOPS_PER_S,
                        weight_bytes / HBM_BYTES_PER_S) * 1e3
    tok_s = b * new / gen_s
    print(f"  [{card}] {cfg.name} full width ({n_params:,} parameters, "
          f"{param_bytes(specs) / 1e9:.2f} GB bf16, made in {init_s:.2f} s): "
          f"{b} prompts x {s} tokens, {new} new greedy, context {ctx}: "
          f"generate {gen_s:.3f} s = {tok_s:.1f} tokens/s; prefill "
          f"{prefill_ms:.3f} ms (bound {prefill_bound:.3f} ms by operations, "
          f"{prefill_flops:.3e} flop at {BF16_FLOPS_PER_S:.3g}/s bf16); "
          f"decode {decode_ms:.3f} ms a step over {steps} steps (bound "
          f"{decode_bound:.3f} ms by bytes, {(weight_bytes + kv_bytes) / 1e9:.3f}"
          f" GB at {HBM_BYTES_PER_S:.3g} B/s); peak memory {serve_peak:.2f} GB; "
          f"offered load {serve['load']}/s poisson, {serve['requests']} "
          f"requests of {serve['offered_new']} new tokens unpaced: p50 "
          f"{lat['p50']} ms, p99 {lat['p99']} ms, "
          f"{lat['throughput_rps']:.3f} requests/s ({offered_s:.1f} s)",
          flush=True)
    if trace["idle_share"] is None:
        print(f"  [{card}] decode trace: not measured (no device activity "
              "recorded)", flush=True)
    else:
        print(f"  [{card}] {trace['steps']} decode steps in a profiler "
              f"window: device idle share {trace['idle_share']:.4f} (busy "
              f"{trace['busy_ms']:.3f} ms of {trace['window_ms']:.3f} ms, "
              f"{trace['device_spans']} device spans)", flush=True)
        for ms_, name, n in trace["top_device_ms"]:
            print(f"    {ms_:.3f} ms  {n} x {name[:90]}", flush=True)

    # 3. The static layout.
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    new_params = reorder_lm_params(params)
    sync()
    reorder_s = time.perf_counter() - t0
    mlp, new_mlp = (params["blocks"]["b0_attn"]["mlp"],
                    new_params["blocks"]["b0_attn"]["mlp"])
    layers, lanes = [], 16
    for i in range(cfg.n_layers):
        totals = [stream_bt_total({"mlp": {k: v[i] for k, v in m.items()}},
                                  lanes) for m in (mlp, new_mlp)]
        flits = totals[0][1]
        if (flits - 1) * lanes * 16 >= 2**31 or not all(
                0 <= t < 2**31 for t, _ in totals):
            fail(f"layer {i}'s stream totals {totals} could pass 2^31")
        before, after = (np.float32(per_flit(t, flits)) for t, _ in totals)
        layers.append({"bt_before": totals[0][0], "bt_after": totals[1][0],
                       "flits": flits, "bt_per_flit_before": float(before),
                       "bt_per_flit_after": float(after),
                       "reduction": float(np.float32(1.0) - after / before)})
    sync()
    layout_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    layout_peak = peak_gb()

    checked = (0, cfg.n_layers - 1)
    for i in checked:
        one = {k: v[i] for k, v in mlp.items()}
        cpu_new, cpu_perm = reorder_mlp({k: v.cpu() for k, v in one.items()})
        _, perm = reorder_mlp(one)
        if not torch.equal(perm.cpu(), cpu_perm) or not all(
                same_bits(new_mlp[k][i].cpu(), cpu_new[k]) for k in cpu_new):
            fail(f"layer {i}'s static layout on {device} != the CPU's plain "
                 "path")
        crep = stream_bt_report({"mlp": {k: v.cpu() for k, v in one.items()}},
                                {"mlp": cpu_new}, lanes)
        want = {k: float(v) for k, v in crep.items()}
        got = {k: layers[i][k] for k in want}
        if got != want:
            fail(f"layer {i}'s stream report {got} != the CPU's plain path "
                 f"{want}")
    print(f"  [{card}] static layout of the whole tree: reorder_lm_params "
          f"{reorder_s:.3f} s, {cfg.n_layers} layer reports {layout_s:.3f} s "
          f"(launches {({k: v for k, v in launches.items() if v})}); peak "
          f"memory {layout_peak:.2f} GB; layers {checked}: permutation, "
          f"matrices and report == the CPU's plain path", flush=True)
    for i, row in enumerate(layers):
        print(f"    layer {i:2d}: BT/flit {row['bt_per_flit_before']!r} -> "
              f"{row['bt_per_flit_after']!r} (reduction "
              f"{row['reduction']:.6f}; totals {row['bt_before']} -> "
              f"{row['bt_after']} over {row['flits']} flits)", flush=True)

    lg0, c0 = model.prefill(params, prompts[:b], ctx)
    lg1, c1 = model.prefill(new_params, prompts[:b], ctx)
    errs, equal = [_rel_err(lg1, lg0, cfg.vocab)], [lg1 == lg0]
    for i in range(LM_DECODE_STEPS):
        pos = torch.full((b,), s + i, dtype=torch.int32, device=device)
        lg0, c0 = model.decode_step(params, out[:, i], c0, pos)
        lg1, c1 = model.decode_step(new_params, out[:, i], c1, pos)
        errs.append(_rel_err(lg1, lg0, cfg.vocab))
        equal.append(lg1 == lg0)
    share = float(torch.stack([e[..., :cfg.vocab].float().mean()
                               for e in equal]).mean())
    if not all(e <= LM_REORDER_TOL for e in errs):
        fail(f"reordered {cfg.name}'s logits off the original's by {errs} of "
             f"their largest value (tolerance {LM_REORDER_TOL})")
    print(f"  [{card}] reordered model: prefill and {LM_DECODE_STEPS} "
          f"teacher-forced decode steps within {max(errs):.3e} of the "
          f"largest logit (tolerance {LM_REORDER_TOL}); {share:.4f} of the "
          "logits equal bit for bit", flush=True)
    del params, new_params, cache, c0, c1
    if on_card:
        torch.cuda.empty_cache()
    return {"reduced": reduced, "arch": cfg.name, "params": n_params,
            "init_s": init_s, "generate_s": gen_s, "tokens_per_s": tok_s,
            "prefill_ms": prefill_ms, "prefill_bound_ms": prefill_bound,
            "prefill_flops": prefill_flops, "decode_ms": decode_ms,
            "decode_bound_ms": decode_bound,
            "decode_bytes": weight_bytes + kv_bytes,
            "decode_trace": trace,
            "serve_peak_gb": serve_peak, "offered_load": lat,
            "offered_s": offered_s,
            "reorder_s": reorder_s, "layout_s": layout_s,
            "layout_peak_gb": layout_peak, "layers": layers,
            "reordered_max_rel_err": max(errs),
            "reordered_bitwise_share": share, "launches": launches}


def _leaf_rel_errs(got, want) -> list:
    """Relative L2 error of each leaf (float64 sums on the host)."""
    from repro_torch import tree
    out = []
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        g = g.detach().double().cpu()
        w = w.detach().double().cpu()
        out.append(float((g - w).norm() / max(float(w.norm()), 1e-30)))
    return out


def _tree_rel_err(got, want) -> float:
    """Relative L2 error of a whole tree (float64 sums on the host)."""
    from repro_torch import tree
    num = den = 0.0
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        g = g.detach().double().cpu()
        w = w.detach().double().cpu()
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    return math.sqrt(num) / max(math.sqrt(den), 1e-30)


def _moments(opt_state, params) -> tuple:
    """(m, v, codes): lists of each leaf's moments as float32 on the host,
    int8 ``Q8`` moments decoded, and the list of their ``Q8`` codes (m's,
    then v's; empty for float32 moments)."""
    from repro_torch import tree
    from repro_torch.optim.adamw import Q8, _q8_decode

    def is_q8(x):
        return isinstance(x, Q8)
    out, codes = [], []
    for moment, signed in ((opt_state.m, True), (opt_state.v, False)):
        xs = []
        for p, x in zip(tree.leaves(params), tree.leaves(moment, is_q8)):
            if is_q8(x):
                codes.append(x.q.cpu())
                x = _q8_decode(x, p.shape, signed)
            xs.append(x.detach().float().cpu())
        out.append(xs)
    return out[0], out[1], codes


def _code_share(got, want) -> float:
    """The share of int8 moment codes that differ."""
    diff = sum(int((a != b).sum()) for a, b in zip(got, want))
    return diff / max(sum(a.numel() for a in want), 1)


def _reduced_optimizer(arch):
    """The reduced steps' AdamW: the arch's moment format under WSD for
    minicpm and cosine otherwise, over TRAIN_REDUCED["horizon"] steps with
    no warmup (each step then moves the bf16 parameters by about lr)."""
    from repro_torch.optim import AdamW, cosine, wsd
    c = TRAIN_REDUCED
    sched = (wsd if "minicpm" in arch.name else cosine)(
        c["lr"], c["horizon"], warmup=0)
    return AdamW(sched, state_dtype=arch.optimizer_state)


def _report_values(rep) -> dict:
    """A wire report's fields as host numbers."""
    return {k: (v if isinstance(v, int) else v.item())
            for k, v in rep.items()}


def _train_reduced(arch, device: str) -> dict:
    """Gradients at the seeded initial parameters and TRAIN_REDUCED["steps"]
    train steps of one reduced arch on ``device`` (on the card the step
    captured into a CUDA graph, as the launcher runs it), from parameters
    drawn on the CPU (the same on every device) and TokenStream
    batches."""
    import torch
    from repro_torch import tree
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import loss_fn_for
    from repro_torch.models import init_params
    from repro_torch.train import init_state, make_train_step, value_and_grad
    cfg_t = TRAIN_REDUCED
    model = arch.build_reduced()
    params = tree.map_leaves(lambda x: x.to(device), init_params(
        model.specs(), torch.Generator().manual_seed(LM_PARAM_SEED), "cpu"))
    loss_fn = loss_fn_for(arch, model)
    opt = _reduced_optimizer(arch)
    stream = TokenStream(vocab=model.cfg.vocab, seq_len=cfg_t["seq"],
                         global_batch=cfg_t["batch"], seed=LM_INPUT_SEED)
    _, grads = value_and_grad(loss_fn, params, stream.batch(0, device=device))
    step = make_train_step(loss_fn, opt)
    state = init_state(params, opt)
    metrics = []
    for i in range(cfg_t["steps"]):
        state, m = step(state, stream.batch(i, device=device))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"params": params, "grads": grads, "state": state,
            "init_opt": opt.init(params), "metrics": metrics}


def _reduced_readings(got, want) -> dict:
    """The reduced steps on a device against the CPU's (``_train_reduced``
    of each): the largest relative L2 error of a gradient leaf and of loss
    / grad norm / lr, that of the updated tree and of each moment
    (decoded), the share of int8 codes that differ, the share of elements
    whose update differs in sign, the steps counted, and the same readings
    for a stale update (the initial parameters) and zeroed moments (the
    optimizer's init) against the CPU's."""
    import torch
    from repro_torch import tree
    m_got, v_got, c_got = _moments(got["state"].opt, got["params"])
    m_want, v_want, c_want = _moments(want["state"].opt, want["params"])
    m_zero, v_zero, c_zero = _moments(want["init_opt"], want["params"])
    flips = total = 0
    for g1, w1, p0 in zip(tree.leaves(got["state"].params),
                          tree.leaves(want["state"].params),
                          tree.leaves(want["params"])):
        dg = torch.sign(g1.float().cpu() - p0.float())
        dw = torch.sign(w1.float() - p0.float())
        flips += int((dg != dw).sum())
        total += dg.numel()
    return {
        "grad_rel_l2": max(_leaf_rel_errs(got["grads"], want["grads"])),
        "loss_gnorm_lr_rel": max(
            abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
            for g, w in zip(got["metrics"], want["metrics"])
            for k in ("loss", "grad_norm", "lr")),
        "tree_rel_l2": _tree_rel_err(got["state"].params,
                                     want["state"].params),
        "m_rel_l2": _tree_rel_err(m_got, m_want),
        "v_rel_l2": _tree_rel_err(v_got, v_want),
        "code_differs_share": _code_share(c_got, c_want) if c_want else None,
        "steps": (int(got["state"].opt.step), int(want["state"].opt.step)),
        "sign_differs_share": flips / total,
        "stale_tree_rel_l2": _tree_rel_err(want["params"],
                                           want["state"].params),
        "zero_moments_rel_l2": min(_tree_rel_err(m_zero, m_want),
                                   _tree_rel_err(v_zero, v_want)),
        "zero_code_differs_share": (_code_share(c_zero, c_want)
                                    if c_want else None),
        "finite": all(math.isfinite(m["loss"])
                      and math.isfinite(m["grad_norm"])
                      for m in got["metrics"])}


def _dryrun_task(task):
    """A process-pool task of the dry-run table: one arch x shape's records
    on the three meshes (with ``table``), then the named hillclimb variants
    (one meta trace serves a cell's meshes and the variants that trace the
    same program). The card's bytes come from the parent: a worker does not
    open the card."""
    name, shape, table, picks, out_dir, card = task
    from repro_torch.launch import dryrun, hillclimb
    t0 = time.perf_counter()
    traces = {}
    recs = {m: dryrun.run_cell(name, shape, mesh=m, out_dir=out_dir,
                               traces=traces, card=card)
            for m in (dryrun.MESHES if table else ())}
    hc = dict(zip(picks, hillclimb.main(picks, out_dir=out_dir,
                                        traces=traces, card=card))) \
        if picks else {}
    return name, shape, recs, hc, time.perf_counter() - t0


def run_dryrun_phase(card: str) -> dict:
    """The dry runs (ROADMAP A18) on the meta device, then the cells that
    fit one card for real on the card (``dryrun.run_on_card``)."""
    import gc
    import shutil
    import tempfile
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context
    import torch
    from repro_torch import configs
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun, hillclimb

    card_bytes = dryrun.card_bytes()
    print(f"  [{card}] card bytes {card_bytes[0]:,} "
          f"({card_bytes[1]}); dryrun.CARD_BYTES_H100 "
          f"{dryrun.CARD_BYTES_H100:,}", flush=True)
    out_dir = tempfile.mkdtemp(prefix="dryrun_torch_")
    # the costliest cells first: train steps (xlstm's two traces, kimi-k2
    # with its hillclimb variant), then prefills, then the decode steps
    mode = {"train": 0, "prefill": 1, "decode": 2}
    cells = sorted(((n, sh) for n in configs.ARCHS for sh in SHAPES),
                   key=lambda c: (mode[SHAPES[c[1]].mode],
                                  c[0] not in ("xlstm-125m",
                                               "kimi-k2-1t-a32b"), c))
    # hillclimb variants grouped by the program they trace: those that
    # change only the specs go with their cell, those that change the model
    # (kv_chunk, moe_groups) make a task a program
    groups = {}
    for v, (a, sh, _, ov) in hillclimb.VARIANTS.items():
        key = (a, sh, ov.get("kv_chunk"), ov.get("moe_groups"))
        groups.setdefault(key, []).append(v)
    tasks = [(n, sh, True, groups.pop((n, sh, None, None), []), out_dir,
              card_bytes) for n, sh in cells]
    tasks[10:10] = [(k[0], k[1], False, vs, out_dir, card_bytes)
                    for k, vs in groups.items()]
    t0 = time.perf_counter()
    try:
        with ProcessPoolExecutor(max_workers=len(os.sched_getaffinity(0)),
                                 mp_context=get_context("spawn"),
                                 initializer=_one_torch_thread) as ex:
            done = list(ex.map(_dryrun_task, tasks))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    table_s = time.perf_counter() - t0
    recs, variants, cell_s = {}, {}, {}
    for name, shape, table, hc, dt in done:
        cell_s[f"{name}/{shape}" + ("" if table else "/hillclimb")] = dt
        variants.update(hc)
        for mesh, rec in table.items():
            recs[(name, shape, mesh)] = rec
    bad = []
    for (name, shape, mesh), rec in recs.items():
        ok, reason = configs.get(name).supports(shape)
        want = "ok" if ok else "skip"
        if rec["status"] != want or rec["reason"] != reason:
            bad.append(f"{name} x {shape} x {mesh}: {rec['status']} "
                       f"{rec.get('error', rec['reason'])[:300]}")
    bad += [f"hillclimb {v}: {r['status']} {r.get('error', '')[:300]}"
            for v, r in variants.items() if r["status"] != "ok"]
    if len(variants) != len(hillclimb.VARIANTS):
        bad.append(f"{len(variants)} of {len(hillclimb.VARIANTS)} hillclimb "
                   "variants ran")
    if bad:
        fail("dry run: " + "; ".join(bad))
    for name in sorted(configs.ARCHS):
        for shape in SHAPES:
            r = recs[(name, shape, "card1x1")]
            if r["status"] == "skip":
                print(f"  {name} x {shape}: skip ({r['reason']})",
                      flush=True)
                continue
            pod = recs[(name, shape, "pod16x16")]
            how = " (extrapolated)" if "extra" in r["count_method"] else ""
            print(f"  {name} x {shape}: {r['params']:,} params, "
                  f"{r['flops']:.4e} FLOPs, args "
                  f"{r['argument_bytes']['total'] / 1e9:.2f} GB (16x16 "
                  f"{pod['argument_bytes_per_device']['total'] / 1e9:.3f} "
                  f"GB a device), peak {r['peak_bytes'] / 1e9:.2f} GB "
                  f"({r['peak_is']}), fits one H100 {r['fits_one_h100']}; "
                  f"trace {r['trace_s']} s{how}",
                  flush=True)
    slow = max(cell_s, key=cell_s.get)
    print(f"  [{card}] {len(recs)} records, {len(variants)} hillclimb "
          f"variants in {table_s:.1f} s ({len(done)} tasks on "
          f"{len(os.sched_getaffinity(0))} processes; the slowest {slow}, "
          f"{cell_s[slow]:.1f} s)", flush=True)

    # The cells that fit, for real on the card.
    fits = [(n, s) for (n, s, m), r in sorted(recs.items())
            if m == "card1x1" and r["status"] == "ok"
            and SHAPES[s].mode == "decode" and r["fits_one_h100"] is True]
    for cell in DRYRUN_CARD_CELLS:
        if cell not in fits:
            fail(f"dry run: {cell[0]} x {cell[1]} does not fit one card "
                 f"(peak {recs[cell + ('card1x1',)].get('peak_bytes')})")
    cells = list(DRYRUN_CARD_CELLS) + [c for c in fits
                                       if c not in DRYRUN_CARD_CELLS]
    gc.collect()
    torch.cuda.empty_cache()
    real = {}
    t0 = time.perf_counter()
    for name, shape in cells:
        try:
            got = dryrun.run_on_card(name, shape,
                                     recs[(name, shape, "card1x1")],
                                     seed=DRYRUN_SEED)
        except AssertionError as e:
            fail(f"dry run on the card: {e}")
        real[f"{name}/{shape}"] = got
        print(f"  [{card}] {name} x {shape} on the card: allocated "
              f"{got['allocated_bytes']:,} B for {got['argument_bytes']:,} "
              f"predicted (+{got['allocated_bytes'] - got['argument_bytes']:,}"
              f", bound {got['alloc_bound_bytes']:,} over {got['tensors']} "
              f"tensors); FLOPs {got['flops']:,} == the dry run's; peak "
              f"{got['peak_bytes'] / 1e9:.3f} GB against "
              f"{got['peak_want'] / 1e9:.3f} predicted (ratio "
              f"{got['peak_ratio']:.4f}); logits finite; gc "
              f"{got['gc_s']:.2f} s, build {got['build_s']:.2f} s, step "
              f"{got['step_s']:.3f} s",
              flush=True)
    real_s = time.perf_counter() - t0
    return {"card_bytes": card_bytes[0], "table_s": table_s,
            "cell_s": cell_s, "real_s": real_s, "on_card": real,
            "records": {"/".join(k): {kk: v for kk, v in r.items()
                                      if kk != "trace"}
                        for k, r in recs.items()},
            "hillclimb": variants}


def run_train_phase(card: str, device: str = "cuda") -> dict:
    """The LM stack's training half (ROADMAP A17 part 2) on ``device``.

    1. Every arch's reduced config, the device against the CPU: gradients
       at the same seeded parameters and batch, and TRAIN_REDUCED["steps"]
       steps of ``make_train_step`` (kimi-k2 with its int8 moments, minicpm
       under WSD, whisper through the enc-dec loss, internvl2 with zero
       patch embeddings; no warmup, so every step moves the parameters):
       the step count equal; loss, grad norm and lr of each step and each
       gradient leaf, the updated tree, and the moments (decoded) within
       TRAIN_TOLS[arch] (relative L2; the lr's float32 cos rounds its own
       way on the card); kimi-k2's differing int8 codes within
       TRAIN_Q8_CODE_TOL; a stale update and zeroed moments must fail
       those limits. The share of elements whose update differs in sign is
       printed, not held (Adam's first steps move an element by about +-lr
       whatever its gradient's size, so a near-zero gradient that rounds to
       the other sign moves it the other way).
    2. TRAIN_FULL["arch"] at full width through ``launch.train.main`` with
       wire telemetry (on the card the step captured into one CUDA graph):
       TRAIN_FULL["steps"] steps with a checkpoint halfway and at the end,
       then a restart from the halfway checkpoint (the last removed) into a
       fresh state, trained to the end and held to the uninterrupted run;
       seconds a step, tokens a second, the step's bound, peak memory, one
       more step replayed in a profiler window (the device's idle share)
       and run eagerly (== the replay, bit for bit), the wire report of its
       gradients (ms a call) == the CPU's plain report on the same
       gradients in every field, checkpoint seconds and bytes, and each
       wire total below 2^31 (its worst case printed).
    3. benchmarks/ordered_collectives.py's cell (OC_CELL) on the device: the
       wire report of the trained reduced xlstm's gradients == the CPU's
       plain report on the same gradients, in every field; O1 must reduce.

    Returns the phase's report, with the kernel launches of the phase's
    device runs (the CPU's comparisons launch nothing).
    """
    import shutil
    import statistics
    import torch
    from repro_torch import configs, tree
    from repro_torch.data import TokenStream
    from repro_torch.dist import gradient_wire_report
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params, param_bytes, param_count
    from repro_torch.optim import AdamW, cosine
    from repro_torch.train import init_state, make_train_step, value_and_grad
    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    ops.reset_launch_counts()
    # 1. Reduced archs, device against the CPU.
    t_reduced = time.perf_counter()
    reduced = {}
    for name in sorted(configs.ARCHS):
        arch = configs.get(name)
        r = _reduced_readings(_train_reduced(arch, device),
                              _train_reduced(arch, "cpu"))
        tol_g, tol_t, tol_m = TRAIN_TOLS[name]
        held = [("gradient leaf", r["grad_rel_l2"], tol_g),
                ("loss / grad norm / lr", r["loss_gnorm_lr_rel"], tol_g),
                ("updated tree", r["tree_rel_l2"], tol_t),
                ("m", r["m_rel_l2"], tol_m), ("v", r["v_rel_l2"], tol_m)]
        if r["code_differs_share"] is not None:
            held.append(("int8 codes differing", r["code_differs_share"],
                         TRAIN_Q8_CODE_TOL))
        bad = [f"{what} {x:.3e} > {tol}" for what, x, tol in held
               if not x <= tol]
        if (not r["finite"] or bad
                or r["steps"] != (TRAIN_REDUCED["steps"],) * 2):
            fail(f"reduced {name} training on {device} != the CPU: {bad}; "
                 f"steps {r['steps']}; finite {r['finite']}")
        blind = [what for what, x, tol in (
            ("a stale update", r["stale_tree_rel_l2"], tol_t),
            ("zeroed moments", r["zero_moments_rel_l2"], tol_m),
            ("zeroed int8 codes", r["zero_code_differs_share"],
             TRAIN_Q8_CODE_TOL)) if x is not None and x <= tol]
        if blind:
            fail(f"reduced {name}: {blind} would pass the limits")
        reduced[name] = {**r, "tolerances": TRAIN_TOLS[name],
                         "optimizer_state": arch.optimizer_state}
    reduced_s = time.perf_counter() - t_reduced
    print(f"  [{card}] reduced archs, {TRAIN_REDUCED['steps']} train steps "
          f"on {device} == the CPU (relative L2 error of the largest "
          "gradient leaf / loss, grad norm or lr / the updated tree / m / v "
          "(tolerances); a stale update / zeroed moments; share of updates "
          "of the other sign; int8 codes differing): " + "; ".join(
              f"{n} {r['grad_rel_l2']:.2e} / {r['loss_gnorm_lr_rel']:.1e} / "
              f"{r['tree_rel_l2']:.2e} / {r['m_rel_l2']:.2e} / "
              f"{r['v_rel_l2']:.2e} {r['tolerances']}; "
              f"{r['stale_tree_rel_l2']:.2e} / "
              f"{r['zero_moments_rel_l2']:.2f}; "
              f"{r['sign_differs_share']:.2e}"
              + ("" if r["code_differs_share"] is None else
                 f"; {r['code_differs_share']:.2e} (zeroed "
                 f"{r['zero_code_differs_share']:.2f})")
              for n, r in reduced.items())
          + f"; {reduced_s:.1f} s", flush=True)

    # 2. Full width through the launcher, a restart from its checkpoint.
    full = TRAIN_FULL
    arch = configs.get(full["arch"])
    model = arch.build()
    specs = model.specs()
    n_params = param_count(specs)
    if n_params != full["params"]:
        fail(f"{full['arch']}: param_count {n_params} != {full['params']}")
    ckpt = os.path.join(REPO, "build", "train_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    half = full["steps"] // 2
    argv = ["--arch", full["arch"], "--steps", str(full["steps"]),
            "--seq", str(full["seq"]), "--batch", str(full["batch"]),
            "--lr", str(full["lr"]), "--ckpt", ckpt,
            "--ckpt-every", str(half), "--wire-telemetry"]
    if not on_card:
        argv += ["--device", device]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_a = launch_train.main(argv)
    sync()
    wall_a = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0
    names = sorted(os.listdir(ckpt))
    if names != [f"step_{half:09d}", f"step_{full['steps']:09d}"]:
        fail(f"checkpoints written {names}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, names[0], f))
                     for f in os.listdir(os.path.join(ckpt, names[0])))
    shutil.rmtree(os.path.join(ckpt, names[1]))
    t0 = time.perf_counter()
    run_b = launch_train.main(argv)
    sync()
    wall_b = time.perf_counter() - t0
    capture = run_b["step_fn"].capture_s
    if run_b["start"] != half:
        fail(f"the restart began at step {run_b['start']}, not {half}")
    final_a, final_b = run_a["state"], run_b["state"]
    restart_errs = _leaf_rel_errs(final_b.params, final_a.params) + \
        _leaf_rel_errs(final_b.opt, final_a.opt)
    exact = all(torch.equal(a, b) for a, b in zip(tree.leaves(final_a),
                                                  tree.leaves(final_b)))
    if not (exact or max(restart_errs) <= TRAIN_RESTART_TOL):
        fail(f"the restarted run's state is off the uninterrupted run's by "
             f"{max(restart_errs):.3e} (relative L2 a leaf, tolerance "
             f"{TRAIN_RESTART_TOL})")
    losses_a = [m["loss"] for m in run_a["metrics"]]
    losses_b = [m["loss"] for m in run_b["metrics"]]
    if not all(math.isfinite(x) for x in losses_a + losses_b):
        fail(f"{full['arch']}: losses not finite: {losses_a} {losses_b}")
    step_s = statistics.median(run_a["step_s"][1:] + run_b["step_s"][1:])
    tokens = full["seq"] * full["batch"]
    flops = 6 * n_params * tokens
    p_bytes = param_bytes(specs)
    moment_bytes = 4 * n_params
    step_bytes = 2 * p_bytes + 4 * moment_bytes + 2 * p_bytes
    bound_ms = max(flops / BF16_FLOPS_PER_S,
                   step_bytes / HBM_BYTES_PER_S) * 1e3
    # One more step: the launcher's captured step replayed in a profiler
    # window, and the same step run eagerly (its plain version) == the
    # replay, bit for bit.
    stream = TokenStream(vocab=model.cfg.vocab, seq_len=full["seq"],
                         global_batch=full["batch"], seed=0)
    batch = stream.batch(full["steps"], device=device)
    trace = {"idle_share": None}
    if on_card:
        from torch.profiler import ProfilerActivity, profile
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            graphed, _ = run_b["step_fn"](final_b, batch)
            sync()
            window_ms = (time.perf_counter() - t0) * 1e3
        spans = device_spans(prof)
        busy = busy_us(spans) / 1e3
        trace.update(window_ms=window_ms, busy_ms=busy,
                     device_spans=len(spans))
        if spans:
            trace["idle_share"] = 1 - busy / window_ms
        del prof
    # The eager step: the function the launcher's graph captured, on the
    # same state and batch.
    sync()
    t0 = time.perf_counter()
    eager, _, grads = run_b["step_fn"].core(final_b, batch)
    sync()
    eager_s = time.perf_counter() - t0
    if on_card and not all(torch.equal(a, b) for a, b in zip(
            tree.leaves(graphed), tree.leaves(eager))):
        fail("the launcher's captured train step != the same step run "
             "eagerly")
    wire_ms = []
    for _ in range(full["wire_reps"]):
        sync()
        t0 = time.perf_counter()
        step_wire = _report_values(gradient_wire_report(grads,
                                                        final_b.params))
        sync()
        wire_ms.append((time.perf_counter() - t0) * 1e3)
    # The same report from the plain path on the CPU, on the same
    # gradients and parameters: every field exactly.
    t0 = time.perf_counter()
    plain_wire = _report_values(gradient_wire_report(
        tree.map_leaves(lambda x: x.cpu(), grads),
        tree.map_leaves(lambda x: x.cpu(), final_b.params)))
    plain_wire_s = time.perf_counter() - t0
    if step_wire != plain_wire:
        fail(f"the full-width gradient wire report on {device} {step_wire} "
             f"!= the CPU's plain report {plain_wire}")
    wire = run_a["metrics"][-1]["wire"]
    flits = -(-n_params // 256) * 256 // 8
    worst = (flits - 1) * 16 * 16
    for rep in (wire, step_wire):
        for k in ("bt_baseline", "bt_o1", "bt_o2"):
            if not 0 <= rep[k] < 2**31:
                fail(f"the gradient wire's {k} total {rep[k]} is not below "
                     "2^31")
    print(f"  [{card}] {full['arch']} full width ({n_params:,} parameters, "
          f"{p_bytes / 1e9:.3f} GB), seq {full['seq']} x batch "
          f"{full['batch']}, cosine at {full['lr']}, wire telemetry, through "
          f"launch.train.main: {len(run_a['step_s'])} steps in {wall_a:.1f} "
          f"s with checkpoints at {half} and {full['steps']}, then the "
          f"restart from step {run_b['start']}: {len(run_b['step_s'])} steps "
          f"in {wall_b:.1f} s (the first step of each, with the capture: "
          f"{run_a['step_s'][0]:.1f} / {run_b['step_s'][0]:.1f} s"
          + (f", of which the eager warm-up {capture['warmup']:.1f} s and "
             f"the capture {capture['capture']:.1f} s" if capture else "")
          + "); final state "
          + ("equal to the uninterrupted run's exactly" if exact else
             f"within {max(restart_errs):.3e} of the uninterrupted run's "
             f"(relative L2 a leaf, tolerance {TRAIN_RESTART_TOL})")
          + f"; loss {losses_a[0]:.4f} -> {losses_a[-1]:.4f} (restart "
          f"{losses_b[-1]:.4f})", flush=True)
    print(f"  [{card}] {step_s * 1e3:.1f} ms a step (median after the "
          f"first) = {tokens / step_s:.0f} tokens/s; bound {bound_ms:.3f} ms "
          f"({flops:.3e} flop at {BF16_FLOPS_PER_S:.3g}/s bf16, "
          f"{step_bytes / 1e9:.3f} GB at {HBM_BYTES_PER_S:.3g} B/s); peak "
          f"memory {peak:.2f} GB; the captured step replayed in a profiler "
          "window: device idle "
          + ("share not measured" if trace["idle_share"] is None else
             f"share {trace['idle_share']:.4f} (busy {trace['busy_ms']:.1f} "
             f"ms of {trace['window_ms']:.1f} ms, {trace['device_spans']} "
             "device spans)")
          + f"; the same step eagerly {eager_s * 1e3:.1f} ms"
          + (", == the replay bit for bit" if on_card else "")
          + f"; wire report {statistics.median(wire_ms):.2f} ms a call, "
          f"== the CPU's plain report in every field (the plain report "
          f"{plain_wire_s:.1f} s); "
          f"checkpoint {ckpt_bytes / 1e9:.3f} GB in "
          + ", ".join(f"{x:.2f}" for x in run_a["ckpt_s"]) + " s", flush=True)
    print(f"  [{card}] gradient wire at step {full['steps'] - 1}: O1 "
          f"{wire['reduction_o1'] * 100:+.3f} % O2 "
          f"{wire['reduction_o2'] * 100:+.3f} %, totals O0 "
          f"{wire['bt_baseline']:,} O1 {wire['bt_o1']:,} O2 {wire['bt_o2']:,}"
          f" below 2^31 over {flits:,} flits (worst case {worst:,} "
          f"{'passes' if worst >= 2**31 else 'stays below'} 2^31, not 2^32: "
          "a non-negative int32 total is exact)", flush=True)
    ckpt_s, restart_from = run_a["ckpt_s"], run_b["start"]
    first_a, first_b = run_a["step_s"][0], run_b["step_s"][0]
    del final_a, run_a, run_b, grads, eager
    shutil.rmtree(ckpt, ignore_errors=True)

    # 3. benchmarks/ordered_collectives.py's cell on the port.
    oc = OC_CELL
    t0 = time.perf_counter()
    xarch = configs.get("xlstm-125m")
    xmodel = xarch.build_reduced()
    xparams = tree.map_leaves(lambda x: x.to(device), init_params(
        xmodel.specs(), torch.Generator().manual_seed(0), "cpu"))
    xstream = TokenStream(vocab=xmodel.cfg.vocab, seq_len=oc["seq"],
                          global_batch=oc["batch"])
    xopt = AdamW(cosine(oc["lr"], oc["steps"], warmup=oc["warmup"]))
    xloss = launch_train.loss_fn_for(xarch, xmodel)
    xstep = make_train_step(xloss, xopt)
    xst = init_state(xparams, xopt)
    for i in range(oc["steps"]):
        xst, _ = xstep(xst, xstream.batch(i, device=device))
    _, xgrads = value_and_grad(xloss, xst.params,
                               xstream.batch(oc["steps"], device=device))
    sync()
    t1 = time.perf_counter()
    xrep = gradient_wire_report(xgrads, xst.params, window=oc["window"],
                                lanes=oc["lanes"])
    sync()
    us = (time.perf_counter() - t1) * 1e6
    cpu_rep = gradient_wire_report(
        tree.map_leaves(lambda x: x.cpu(), xgrads),
        tree.map_leaves(lambda x: x.cpu(), xst.params),
        window=oc["window"], lanes=oc["lanes"])
    got, want = _report_values(xrep), _report_values(cpu_rep)
    if got != want:
        fail(f"the ordered-collectives cell's report on {device} {got} != "
             f"the CPU's plain report {want}")
    if got["reduction_o1"] <= 0:
        fail(f"O1 must reduce BT on real gradients, got "
             f"{got['reduction_o1']:.4f}")
    oc_s = time.perf_counter() - t0
    launches = {k.name: k.launches for k in ops.KERNELS}
    print(f"  [{card}] the port's ordered_collectives cell (reduced xlstm, "
          f"its own init): ordered_collectives/gradient_allreduce,{us:.0f},"
          f"O1_weightkeyed={got['reduction_o1'] * 100:.2f}% "
          f"O2_selfkeyed={got['reduction_o2'] * 100:.2f}% "
          f"baseline_bt={got['bt_baseline']:.3g}; report == the CPU's plain "
          f"report in every field; {oc_s:.1f} s; launches of the phase "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if on_card:
        torch.cuda.empty_cache()
    return {"reduced": reduced, "reduced_s": reduced_s,
            "full": {"arch": full["arch"], "params": n_params,
                     "steps": full["steps"], "restart_from": restart_from,
                     "restart_exact": exact,
                     "restart_max_rel_l2": max(restart_errs),
                     "wall_s": wall_a, "restart_wall_s": wall_b,
                     "first_step_s": [first_a, first_b],
                     "capture_s": capture,
                     "step_s": step_s, "tokens_per_s": tokens / step_s,
                     "bound_ms": bound_ms, "flops": flops,
                     "step_bytes": step_bytes, "peak_gb": peak,
                     "losses": losses_a, "restart_losses": losses_b,
                     "trace": trace, "eager_step_s": eager_s,
                     "wire": wire, "wire_ms": wire_ms,
                     "step_wire": step_wire, "plain_wire_s": plain_wire_s,
                     "wire_worst_case": worst, "flits": flits,
                     "ckpt_s": ckpt_s, "ckpt_bytes": ckpt_bytes},
            "ordered_collectives": {"report": got, "report_us": us,
                                    "wall_s": oc_s},
            "launches": launches}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(REPO, "build",
                                                      "chip_smoke.json"),
                        help="where to write the detailed JSON report")
    args = parser.parse_args()
    import torch

    with Phase("device"):
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this smoke test needs "
                 "a CUDA card", code=2)
        card = card_line()
        kind = torch.cuda.get_device_name(0)
        print(f"card: {card} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | {kind}", flush=True)

    import torch.nn.functional as F
    from repro_torch.core import bt as bt_mod, flits, ordering, wire
    from repro_torch.core.bits import words32
    from repro_torch.data import glyph_batch
    from repro_torch.kernels import (bitonic_sort, bt_count, chain_greedy,
                                     chain_select, min_hamming, ops,
                                     order_unit, popcount, popcount_order,
                                     ref, router_step)
    from repro_torch.models import DarkNetLike, LeNet, trained_model
    from repro_torch.noc import SweepGrid, power, run_sweep, sim
    from repro_torch.noc import sweep as sweep_mod
    from repro_torch.noc.topology import mesh_by_name
    from repro_torch.quant import quantize_fixed8

    with Phase("build"):
        times = ops.build_all()
        for k in ops.KERNELS:
            regs = [ln.strip() for ln in k.build_log.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"  {k.name}: built in {times[k.name]:.1f} s "
                  f"{' | '.join(regs)}", flush=True)

    report = {"card": card, "kind": kind}
    with Phase("kernels"):
        rng = np.random.default_rng(0)
        w = rng.integers(0, 2**32, 1 << 20, dtype=np.uint64).astype(np.uint32)
        w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
        x = torch.from_numpy(w.view(np.int32)).cuda()
        got, want = popcount.popcount_words(x), ref.popcount_ref(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail("popcount kernel != plain popcount")
        if int(got[2]) != 1 or int(got[1]) != 32:
            fail("popcount kernel miscounts bit-31 words")
        # The BT counter: counts and total in one launch, and each alone,
        # for F = 1-3 at every chunk width and both sides of the 32-word
        # segmented-scan limit, off 16- and 8-byte alignment, and at the
        # bandwidth shape (2^20, 8).
        bt_cases = [(f_, l_, 0) for f_ in (1, 2, 3)
                    for l_ in (1, 3, 8, 16, 33, 130)]
        bt_cases += [(4097, 16, 0), (7778, 8, 0), (4097, 8, 1),
                     (4097, 8, 2), (1 << 20, 8, 0)]
        for f_, l_, off in bt_cases:
            flat = random_words(rng, (off + f_ * l_,))
            words = flat[off:].view(f_, l_)
            counts, total = bt_count.bt_count(words)
            alone, tot_alone = (bt_count.bt_boundaries(words),
                                bt_count.bt_total(words))
            want = ref.bt_boundaries_ref(words)
            want_t = ref.bt_total_ref(words)
            torch.cuda.synchronize()
            if not (torch.equal(counts, want) and torch.equal(alone, want)
                    and torch.equal(total, want_t)
                    and torch.equal(tot_alone, want_t)):
                fail(f"BT-counter kernel != plain BT counter at ({f_}, "
                     f"{l_}), base offset {off} words")
            if not torch.equal(bt_count.bt_measure(words),
                               ref.bt_measure_ref(words)):
                fail(f"BT-measure kernel != plain sums at ({f_}, {l_}), "
                     f"base offset {off} words")
        # The measure sums where S2 = sum(x y) reaches 2^32 (all-ones words:
        # 1,024 a pair over 2^22 pairs), twice, as the workspace re-arms.
        ones = torch.full(((1 << 17) + 1, 32), -1, dtype=torch.int32,
                          device="cuda")
        want_m = ref.bt_measure_ref(ones)
        if int(want_m[2]) != 1 << 32:
            fail(f"plain measure sums of the all-ones stream: {want_m}")
        for _ in range(2):
            if not torch.equal(bt_count.bt_measure(ones), want_m):
                fail("BT-measure kernel != plain sums where S2 = 2^32")
        print(f"  BT counter == plain (counts, total, both) and measure sums "
              f"== plain on {len(bt_cases)} streams; measure sums == plain "
              f"at S2 = 2^32", flush=True)
        for mesh in ("4x4_mc2", "8x8_mc4", "16x16_mc16"):
            cfg = mesh_by_name(mesh)
            key = (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)
            t = synthetic_traffic(cfg, batch=6, packets=400, seed=1)
            mc = torch.as_tensor(np.broadcast_to(
                np.asarray(cfg.mc_nodes, np.int32), (6, cfg.num_mcs)).copy(),
                device="cuda")
            a, _ = router_vs_plain(cfg, sim.fuse_traffic(t), mc, mesh)
            lay = router_step.smem_layout(key, cfg.num_mcs)
            print(f"  router kernel == plain step on {mesh} over 512 cycles, "
                  f"6 lanes, {int(a.ejected.sum())} flits ejected (shared "
                  f"memory: {', '.join(lay.in_shared) or 'routing state'}; "
                  f"{lay.bytes} bytes, {lay.threads} threads)", flush=True)
        # Result-phase batches: the PEs inject (14, 60 and 240 streams,
        # padding streams of length 0 at router 0), the MCs receive; lanes
        # of one batch differ in their injection nodes and MC destinations.
        # Each batch must fill a local FIFO: a full local FIFO that pops is
        # where the kernel finds the injecting stream (local_stream).
        for size, packets in (("4x4", 3000), ("8x8", 12000),
                              ("16x16", 40000)):
            cfg, t, mc = result_batch(RESULT_K1[size], packets, seed=3)
            wr = sim.fuse_traffic(t)
            a, fullest = router_vs_plain(cfg, wr, mc, f"{size} result batch")
            if fullest < cfg.vc_depth:
                fail(f"the {size} result batch filled no local FIFO (fullest "
                     f"{fullest} of {cfg.vc_depth}): the full-FIFO pop went "
                     "unchecked")
            key = (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)
            m = int(wr.length.shape[1])
            lay = router_step.smem_layout(key, m)
            print(f"  router kernel == plain step on the {size} result batch "
                  f"over 512 cycles: {wr.length.shape[0]} lanes of {m} PE "
                  f"streams, {int(a.ejected.sum())} of "
                  f"{int(wr.length.sum())} flits ejected, fullest local FIFO "
                  f"{fullest} of {cfg.vc_depth} (shared "
                  f"memory: {', '.join(lay.in_shared) or 'routing state'}; "
                  f"{lay.bytes} bytes, {lay.threads} threads)", flush=True)
        # Window sort: every register width (one warp a row below 256, two
        # from 256) and the shared network at 2,048, with 0, 1 and 2
        # payloads, on tie-heavy keys (popcounts in [0, 33), as
        # benchmarks/ordering_throughput.py makes them) and on full-range
        # keys holding INT32_MIN and INT32_MAX, at row counts that do not
        # fill the last block; through ops.sort_windows_desc once with a
        # float32 payload whose words have bit 31 set.
        for (r_, w_), kind, n_pay in k4_cases():
            keys = k4_keys(rng, kind, r_, w_)
            pays = [random_words(rng, (r_, w_)) for _ in range(n_pay)]
            got = bitonic_sort.sort_windows(keys, *pays)
            want = ref.sort_windows_ref(keys, *pays)
            torch.cuda.synchronize()
            if not all(torch.equal(g, v) for g, v in zip(got, want)):
                fail(f"window-sort kernel != plain network at ({r_}, {w_}), "
                     f"{kind} keys, {n_pay} payloads")
        neg = -np.abs(rng.standard_normal((37, 128))).astype(np.float32) - 1
        keys = k4_keys(rng, "ties", 37, 128)
        pays = [random_words(rng, (37, 128)).view(torch.uint32),
                torch.from_numpy(neg).cuda()]
        got = ops.sort_windows_desc(keys, *pays)
        want = ops.sort_windows_desc(keys.cpu(), *(p.cpu() for p in pays))
        torch.cuda.synchronize()
        if not all(same_bits(g.cpu(), w) for g, w in zip(got, want)):
            fail("window sort through ops != plain network with uint32 and "
                 "float32 payloads")
        print(f"  window sort == plain on {len(k4_cases())} cases (W = 128 "
              "to 2,048, 0-2 payloads, both key ranges)", flush=True)
        # Ordering unit on uint32 words; then at every width of the
        # register path (one warp a row below W = 256, two from 256; 37
        # and 2,200 rows) and of the shared-memory path, on random words,
        # on tie-heavy words (popcounts 0, 4, 6, 32 only) and on rows of
        # one popcount.
        v = random_words(rng, (512, 512)).view(torch.uint32)
        got, want = ops.order_unit(v), ops.order_unit(v.cpu())
        torch.cuda.synchronize()
        if not all(same_bits(g.cpu(), w) for g, w in zip(got, want)):
            fail("ordering-unit kernel != plain version at (512, 512)")
        pool = torch.from_numpy(np.array(
            [0x0F, 0xF0, 0xF000, 0x3F, 0xFC0, 0, 0xFFFFFFFF, 0xF0000000],
            np.uint32).view(np.int32))
        one_pc = torch.from_numpy(np.array(
            [0x0F, 0xF0, 0xF00, 0xF000, 0xF0000, 0x80000007],
            np.uint32).view(np.int32))
        ou_cases = 0
        for w_ in (32, 64, 128, 256, 512, 1024, 2048, 16384):
            for r_ in ((2,) if w_ > 2048 else (8,) if w_ > 1024
                       else (37, 2200)):
                for kind in ("random", "ties", "one popcount"):
                    if kind == "random":
                        x = random_words(rng, (r_, w_))
                    else:
                        src = pool if kind == "ties" else one_pc
                        x = src[torch.from_numpy(rng.integers(
                            0, len(src), (r_, w_)))].cuda()
                    got = order_unit.order_unit_words(x)
                    want = ref.order_unit_ref(x)
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, v) for g, v in zip(got, want)):
                        fail(f"ordering-unit kernel != plain version at "
                             f"({r_}, {w_}), {kind} words")
                    ou_cases += 1
        print(f"  ordering unit == plain on {ou_cases} cases (W = 32 to "
              f"16,384)", flush=True)
        # Chain select: 1 and 2 planes over the chain's penalty set, and on
        # penalties whose keys tie (-idx + {0, 1, 2}), wrap past INT32_MAX,
        # or hit INT32_MIN (one lane a row); a warp a row up to W = 1,024,
        # the shared-memory network above; R = 0.
        for w_ in (1, 28, 152, 256, 400, 1024, 1025, 4096, 16000):
            r_ = 2 if w_ >= 16000 else 8 if w_ >= 4096 else 256
            for planes in (1, 2):
                for kind in ("chain", "ties", "wrap", "int32_min"):
                    xs = [random_words(rng, (r_, w_)) for _ in range(planes)]
                    pen = select_penalty(kind, rng, xs, w_)
                    got = ops.chain_select(xs, pen)
                    want = ref.chain_select_ref(xs, pen, w_)
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, v) for g, v in zip(got, want)):
                        fail(f"chain-select kernel != plain version at "
                             f"({r_}, {w_}) with {planes} planes, {kind} "
                             f"penalties")
        e = torch.zeros((0, 152), dtype=torch.int32, device="cuda")
        if any(t.shape != (0, 152) for t in ops.chain_select([e, e], e)):
            fail("chain-select kernel on R = 0")
        # The whole chain: partitioned planes (zeros at each window's
        # tail), live counts and start positions, at widths up to the
        # score encoding's bound; every width on one or two planes.
        for w_, planes, beam in ((4, 1, 2), (31, 2, 1), (152, 1, 2),
                                 (152, 2, 2), (400, 2, 2), (4096, 1, 2),
                                 (16000, 2, 2)):
            r_ = 2 if w_ >= 4096 else 64
            live = rng.integers(0, w_ + 1, r_)
            u = random_words(rng, (planes, r_, w_))
            u[:, torch.arange(w_, device="cuda")[None, :]
              >= torch.from_numpy(live).cuda()[:, None]] = 0
            z = torch.from_numpy(live.astype(np.int32)).cuda()
            st = torch.from_numpy(rng.integers(0, w_, (r_, 8))
                                  .astype(np.int32)).cuda()
            got = chain_greedy.chain_greedy(u, z, st, beam)
            want = ref.chain_greedy_ref(u, z, st, beam)
            torch.cuda.synchronize()
            if not all(torch.equal(g, v) for g, v in zip(got, want)):
                fail(f"chain kernel != plain version at ({r_}, 8, {w_}) "
                     f"with {planes} planes, beam {beam}")
        # The chain's two tiers at their edges: the register tier at W =
        # 32, 33, 64, 576 (DarkNet's widest window) and 1,024 with beams 1
        # and 2, the wide tier from 1,025 and at beam 3; beams 1-3, each call on chain_edge_inputs' rows
        # (z = 0 and z = 1 among them, starts in the zero region too). Up
        # to W = 64 on one and two planes; from 576, where the plain
        # version's W - 1 steps cost most, each beam once a width, the
        # plane counts alternating, so every pair still runs at a width of
        # 576 or more.
        for wi, w_ in enumerate((32, 33, 64, 576, 1024, 1025)):
            pairs = ([(p_, b_) for p_ in (1, 2) for b_ in (1, 2, 3)]
                     if w_ <= 64 else
                     [(1 + (b_ + wi) % 2, b_) for b_ in (1, 2, 3)])
            for planes, beam in pairs:
                u, z, st = chain_edge_inputs(rng, planes, w_)
                got = chain_greedy.chain_greedy(u, z, st, beam)
                want = ref.chain_greedy_ref(u, z, st, beam)
                torch.cuda.synchronize()
                if not all(torch.equal(g, v) for g, v in zip(got, want)):
                    fail(f"chain kernel ({chain_greedy.tier_of(w_, beam)} "
                         f"tier) != plain version at (8, 8, {w_}) with "
                         f"{planes} planes, beam {beam}")
        print("  window sort, ordering unit, chain select and chain (both "
              "tiers, W = 4 to 16,000, beams 1-3) == their plain versions",
              flush=True)
        # The popcount window order on the trap cases: tie-heavy windows
        # (a pool of 16 words, six with bit 31 set, one zero; int8 from 9
        # values), narrow carriers (nbits 8 and 16), all-zero windows, the
        # zero tail the padding adds, W = 1, the no-NoC whole-stream
        # window and R = 0; each CUDA permutation == the plain one of the
        # same values on the CPU.
        pool = rng.integers(0, 2**32, 16, dtype=np.uint64).astype(np.uint32)
        pool[:6] |= np.uint32(0x80000000)
        pool[6] = 0
        f32 = rng.choice(pool, 62224 * 2 + 77).view(np.float32)
        i8 = rng.choice(np.array([-128, -64, -1, 0, 1, 3, 7, 15, 127],
                                 np.int8), 4096 * 25 + 9)
        bf = rng.choice(pool.astype(np.uint16), 120 * 40 + 3).view(np.int16)
        perm_cases = [
            (torch.from_numpy(f32[:1600 * 150].copy()), 150),
            (torch.from_numpy(f32[:4096 * 25 + 11].copy()), 25),
            (torch.from_numpy(f32[:400 * 7 + 13].copy()), 400),
            (torch.from_numpy(f32[:100].copy()), 1),
            (torch.from_numpy(f32.copy()), 62224),
            (torch.from_numpy(i8.copy()), 25),
            (torch.from_numpy(i8[:150 * 30].view(np.uint8).copy()), 84),
            (torch.from_numpy(bf.copy()).view(torch.bfloat16), 120),
            (torch.zeros(150 * 10), 150),
        ]
        for vals, win in perm_cases:
            for tb in ("stable", "pattern"):
                got = ordering.descending_perm(vals.cuda(), win, tb)
                want = ordering.descending_perm(vals, win, tb)
                torch.cuda.synchronize()
                if not torch.equal(got.cpu(), want):
                    fail(f"window-order kernel != plain permutation: "
                         f"{vals.dtype} window {win}, {tb}")
        for shape in ((0, 25), (1, 0)):
            e = torch.zeros(shape, dtype=torch.int32, device="cuda")
            if ops.descending_perm_rows(e, "pattern", 32).shape != (0,):
                fail(f"window-order kernel on a {shape} input")
        # The chain preamble: windows with every live count (z = 0 and
        # z <= starts among them), bit-31 words, a position live in one
        # plane only, conv2's window zero-padded to 152, and R = 0.
        for planes, r_, w_, pad, st in ((1, 64, 1, 0, 8), (2, 64, 1, 0, 8),
                                        (1, 512, 32, 0, 8),
                                        (2, 1600, 152, 2, 8),
                                        (2, 64, 400, 0, 3),
                                        (1, 8, 4096, 0, 8),
                                        (2, 2, 16000, 0, 8),
                                        (2, 0, 152, 0, 8)):
            u = random_words(rng, (planes, r_, w_))
            live = torch.from_numpy(rng.integers(0, w_ + 1, (r_, w_))).cuda()
            keep = live < torch.from_numpy(rng.integers(0, w_ + 1, r_)
                                           ).cuda()[:, None]
            u *= keep.to(torch.int32)
            if planes == 2:
                u[1, :, 1::4] = 0
            if pad:
                u[:, :, -pad:] = 0
            got = ops.chain_inputs(u, st)
            want = ref.chain_inputs_ref(u, st)
            torch.cuda.synchronize()
            if not all(g.dtype == v.dtype and torch.equal(g, v)
                       for g, v in zip(got, want)):
                fail(f"chain-preamble kernel != plain version at "
                     f"({planes}, {r_}, {w_}), {st} starts")
        print(f"  window order == plain on {len(perm_cases)} streams x 2 "
              "tiebreaks and R = 0; chain preamble == plain on 8 shapes",
              flush=True)

    # Count the CUDA descending_perm calls of the no-NoC and main paths
    # (each must be one launch of the window-order kernel).
    perm_calls = {"no_noc": 0, "noc": 0}
    descending_perm = ordering.descending_perm
    path = "no_noc"

    def counted_descending_perm(values, window=None, tiebreak="stable"):
        if values.is_cuda and values.numel():
            perm_calls[path] += 1
        return descending_perm(values, window, tiebreak)

    ordering.descending_perm = counted_descending_perm
    ops.reset_launch_counts()
    with Phase("no-NoC (Tab. I)"):
        net, lparams, _ = trained_model("lenet", device="cuda")
        stream = net.weight_stream()
        tab1 = []
        for fmt in ("float32", "fixed8"):
            vals = stream if fmt == "float32" else quantize_fixed8(stream).values
            base = wire.measure(flits.pack(vals, 8))
            for tb in ("stable", "pattern"):
                opt = wire.measure(wire.by_name("O1", tiebreak=tb)
                                   .apply_single(vals, 8))
                red = (1 - opt["bt_per_flit"] / base["bt_per_flit"]) * 100
                tab1.append({"case": f"{fmt}-trained", "tiebreak": tb,
                             "baseline_bt_per_flit": base["bt_per_flit"],
                             "ordered_bt_per_flit": opt["bt_per_flit"],
                             "baseline_total_bt": base["total_bt"],
                             "ordered_total_bt": opt["total_bt"],
                             "baseline_expected_bt": base["expected_bt"],
                             "ordered_expected_bt": opt["expected_bt"],
                             "reduction_pct": red})
                print(f"  {fmt:8s} {tb:8s} BT/flit {base['bt_per_flit']:.3f}"
                      f" -> {opt['bt_per_flit']:.3f}  reduction {red:.2f}%",
                      flush=True)
        # The same BT totals, per-flit ratios and expected BT from the plain
        # path on the CPU, exactly (measure forms both figures on the host
        # from the same integers either way).
        cpu_stream = stream.cpu()
        for row in tab1:
            fmt = row["case"].split("-")[0]
            vals = (cpu_stream if fmt == "float32"
                    else quantize_fixed8(cpu_stream).values)
            for side, m in (("baseline", wire.measure(flits.pack(vals, 8))),
                            ("ordered", wire.measure(
                                wire.by_name("O1", tiebreak=row["tiebreak"])
                                .apply_single(vals, 8)))):
                for key in ("total_bt", "bt_per_flit", "expected_bt"):
                    if m[key] != row[f"{side}_{key}"]:
                        fail(f"no-NoC {side} {key} on the card "
                             f"({row[f'{side}_{key}']}) != the plain path's "
                             f"on the CPU ({m[key]}), {row['case']} "
                             f"{row['tiebreak']}")
        report["tab1"] = tab1
    nonoc_launches = {k.name: k.launches for k in ops.KERNELS}

    with Phase("no-NoC measure window"):
        # Six streams were measured on the card above, each one launch of
        # the BT counter's measure entry point, which takes the total and
        # Eq. 3's sums together: no bt_count and no popcount launch. One
        # measure in a profiler window: one launch, no aten::sum, and one
        # read to the host (aten::to, aten::item and
        # aten::_local_scalar_dense summed; one device-to-host copy).
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        want = {"bt_measure": 6, "bt_count": 0, "popcount": 0}
        got = {k: nonoc_launches[k] for k in want}
        if got != want:
            fail(f"6 streams measured on the card: launches {got}, "
                 f"expected {want}")
        s8 = flits.pack(stream, 8)
        wire.measure(s8)
        torch.cuda.synchronize()
        before = {k.name: k.launches for k in ops.KERNELS}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wire.measure(s8)
            torch.cuda.synchronize()
        m_launches = {k.name: k.launches - before[k.name]
                      for k in ops.KERNELS if k.launches != before[k.name]}
        events = prof.key_averages()
        m_ops = {e.key: e.count for e in events}
        m_sums = m_ops.get("aten::sum", 0)
        syncs = {k: m_ops.get(k, 0) for k in ("aten::item", "aten::to",
                                              "aten::_local_scalar_dense")}
        d2h = sum(e.count for e in events
                  if e.device_type == DeviceType.CUDA
                  and "DtoH" in e.key)
        if m_launches != {"bt_measure": 1}:
            fail(f"one measure launched {m_launches}, expected one "
                 "bt_measure launch and nothing else")
        if m_sums:
            fail(f"one measure holds {m_sums} aten::sum")
        if sum(syncs.values()) != 1:
            fail(f"one measure holds {syncs}: one host read expected")
        print(f"  launches over the 6 measured streams {got}; one measure: "
              f"{m_launches}, aten::sum {m_sums}, host reads {syncs}, "
              f"device-to-host copies {d2h}", flush=True)
        report["measure_window"] = {"nonoc_launches": got,
                                    "launches": m_launches,
                                    "aten_sum": m_sums, "host_reads": syncs,
                                    "device_to_host_copies": d2h}

    path = "noc"
    ops.reset_launch_counts()
    with Phase("main path (full-width sweep)"):
        gen = torch.Generator(device="cuda").manual_seed(7)
        img, label = glyph_batch(gen, 1, device="cuda")
        layers = net.layer_traffic(img[0])
        npk = sum(int(lt.inputs.shape[0]) for lt in layers)
        logits = net(img)
        cpu_logits = LeNet({k: v.cpu() for k, v in lparams.items()},
                           device="cpu")(img.cpu())
        if not torch.allclose(logits.cpu(), cpu_logits, rtol=1e-5, atol=1e-6):
            fail("LeNet forward on the card disagrees with the CPU")
        t0 = time.perf_counter()
        rep = run_sweep(SweepGrid(**AXES, max_packets_per_layer=None),
                        lambda _name: layers)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_sweep(rep, "main sweep", 36)
        for r in rep.rows:
            print(f"  {r['mesh']} {r['precision']:8s} {r['tiebreak']:8s} "
                  f"{r['transform']}: total_bt {r['total_bt']} drain_cycle "
                  f"{r['cycles']} flits {r['flits']} reduction "
                  f"{r['reduction_pct']:.2f}% adjusted "
                  f"{r['adjusted_reduction_pct']:.2f}%", flush=True)
        st = rep.stats
        print(f"  {npk} packets per inference; simulated "
              f"{st['stepped_cycles']} lane-cycles in {st['simulate_s']:.3f} s"
              f" = {st['cycles_per_sec']} cycles/s; packetize "
              f"{st['packetize_s']:.3f} s; wall {wall:.3f} s", flush=True)
        report["main"] = {"rows": rep.rows, "stats": st, "wall_s": wall,
                          "packets": npk, "label": int(label[0])}
    main_launches = {k.name: k.launches for k in ops.KERNELS}
    ordering.descending_perm = descending_perm

    # Count the chain calls of the O3 sweep (and, below, of the DarkNet
    # compression cell) by shape, keeping each shape's first stack: the
    # chain-calls phase times every shape, the timing phase the O3 sweep's
    # largest (by P * R * W^2, the chain's work).
    chain_shapes = {}     # (phase, P, R, W, beam, starts) -> [calls, stack]
    chain_windows = min_hamming._chain_windows

    def recorded_chain_windows(phase):
        def chain(u, beam, starts):
            entry = chain_shapes.setdefault((phase, *u.shape, beam, starts),
                                            [0, u])
            entry[0] += 1
            return chain_windows(u, beam, starts)
        return chain

    ops.reset_launch_counts()
    with Phase("O3 path (full-width O0/O3/O3a sweep)"):
        min_hamming._chain_windows = recorded_chain_windows("O3")
        try:
            t0 = time.perf_counter()
            rep3 = run_sweep(SweepGrid(**AXES_O3, max_packets_per_layer=None),
                             lambda _name: layers)
            torch.cuda.synchronize()
            wall3 = time.perf_counter() - t0
        finally:
            min_hamming._chain_windows = chain_windows
        check_sweep(rep3, "O3 sweep", 36)
        o0 = {(r["mesh"], r["precision"], r["tiebreak"]): r["total_bt"]
              for r in rep.rows if r["transform"] == "O0"}
        for r in rep3.rows:
            if (r["transform"] == "O0"
                    and r["total_bt"] != o0[(r["mesh"], r["precision"],
                                             r["tiebreak"])]):
                fail("O0 rows differ between the two full-width sweeps")
            print(f"  {r['mesh']} {r['precision']:8s} {r['tiebreak']:8s} "
                  f"{r['transform']:3s}: total_bt {r['total_bt']} "
                  f"drain_cycle {r['cycles']} reduction "
                  f"{r['reduction_pct']:.2f}% adjusted "
                  f"{r['adjusted_reduction_pct']:.2f}%", flush=True)
        st3 = rep3.stats
        print(f"  packetize {st3['packetize_s']:.3f} s (by transform "
              f"{st3['packetize_by_transform']}); simulate "
              f"{st3['simulate_s']:.3f} s ({st3['stepped_cycles']} "
              f"lane-cycles); wall {wall3:.3f} s", flush=True)
        o3_calls = sum(n for (ph, *_), (n, _) in chain_shapes.items()
                       if ph == "O3")
        report["o3"] = {"rows": rep3.rows, "stats": st3, "wall_s": wall3,
                        "chain_calls": o3_calls}
    o3_launches = {k.name: k.launches for k in ops.KERNELS}
    print(f"  {o3_calls} chain calls; chain kernel launches "
          f"{o3_launches['chain_greedy']}, chain-preamble launches "
          f"{o3_launches['chain_inputs']}, chain-select launches "
          f"{o3_launches['chain_select']}", flush=True)
    big_key = max((k for k in chain_shapes if k[0] == "O3"),
                  key=lambda k: k[1] * k[2] * k[3] ** 2)
    big_chain = (chain_shapes[big_key][1], *big_key[4:])

    with Phase("device idle share (O3 packetize, 8x8_mc4)"):
        # One mesh's O3 packetize as run_sweep runs it (its flit shapes come
        # from the probe, which run_sweep makes once for all meshes), in one
        # profiler window: the busy share is the union of the device's
        # activity spans over the window's host time.
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.noc.sweep import _QUANTIZERS
        from repro_torch.noc.traffic import (build_traffic_streamed,
                                             payload_shapes)
        cfg = mesh_by_name("8x8_mc4")
        variants3 = [(wire.by_name(tr, tiebreak=tb), _QUANTIZERS[prec])
                     for prec in AXES_O3["precisions"]
                     for tb in AXES_O3["tiebreaks"]
                     for tr in AXES_O3["transforms"]]
        shapes = payload_shapes(layers, cfg.lanes, variants3)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            build_traffic_streamed(layers, cfg, variants3, num_streams=8,
                                   shapes=shapes)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        spans = device_spans(prof)
        busy = busy_us(spans) / 1e3
        idle = {"window_ms": window_ms, "device_spans": len(spans),
                "busy_ms": busy,
                "idle_share": (1 - busy / window_ms) if spans else None,
                "packetize_s_unprofiled": next(
                    c["packetize_s"] for c in st3["shape_classes"]
                    if c["mesh"] == "8x8_mc4")}
        if spans:
            by_kernel = sorted(
                ((e.self_device_time_total / 1e3, e.key, e.count)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA), reverse=True)[:8]
            idle["top_device_ms"] = by_kernel
            print(f"  device idle share {idle['idle_share']:.4f} (busy "
                  f"{idle['busy_ms']:.3f} ms of a {window_ms:.3f} ms window, "
                  f"{len(spans)} device spans; the same packetize "
                  f"unprofiled in the sweep: "
                  f"{idle['packetize_s_unprofiled']} s)", flush=True)
            for ms_, name, n in by_kernel:
                print(f"    {ms_:.3f} ms  {n} x {name[:90]}", flush=True)
        else:
            print("  device idle share: not measured (the profiler recorded "
                  f"no device activity in a {window_ms:.3f} ms window)",
                  flush=True)
        report["idle"] = idle

    with Phase("device idle share (O0/O1/O2 drain, 8x8_mc4)"):
        # The mesh's drain as run_sweep runs it: its full-width 12-variant
        # O0/O1/O2 traffic (MC streams padded to the 8x8 group's 8), chunks
        # of 2,048 cycles, in one profiler window.
        cfg = mesh_by_name("8x8_mc4")
        variants = [(wire.by_name(tr, tiebreak=tb), _QUANTIZERS[prec])
                    for prec in AXES["precisions"]
                    for tb in AXES["tiebreaks"] for tr in AXES["transforms"]]
        m_pad = sweep_streams(cfg)
        t = build_traffic_streamed(layers, cfg, variants, num_streams=m_pad)
        mc_rows = np.broadcast_to(np.asarray(
            tuple(cfg.mc_nodes) + (0,) * (m_pad - cfg.num_mcs), np.int32),
            (len(variants), m_pad))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = sim.simulate_batch(cfg, t, mc_nodes=mc_rows, chunk=2048)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        if not all(r.ejected == r.injected for r in res):
            fail("the profiled 8x8_mc4 drain left flits in the network")
        spans = device_spans(prof)
        busy = busy_us(spans) / 1e3
        k1_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and "router_cycles" in e.key) / 1e3
        drain = {"window_ms": window_ms, "device_spans": len(spans),
                 "busy_ms": busy, "router_kernel_ms": k1_ms,
                 "idle_share": (1 - busy / window_ms) if spans else None,
                 "drain_cycles": max(r.drain_cycle for r in res),
                 "simulate_s_unprofiled": next(
                     c["simulate_s"] for c in rep.stats["shape_classes"]
                     if c["mesh"] == "8x8_mc4")}
        if spans:
            print(f"  device idle share {drain['idle_share']:.4f} (busy "
                  f"{busy:.3f} ms of a {window_ms:.3f} ms window, "
                  f"{k1_ms:.3f} ms of it in the router kernel, "
                  f"{len(spans)} device spans; the same drain unprofiled in "
                  f"the sweep: {drain['simulate_s_unprofiled']} s)",
                  flush=True)
        else:
            print("  device idle share: not measured (the profiler recorded "
                  f"no device activity in a {window_ms:.3f} ms window)",
                  flush=True)
        report["idle_drain"] = drain

    with Phase("sorts (O0/O1/O2 packetize 8x8_mc4, chain preamble)"):
        # The mesh's O0/O1/O2 packetize as run_sweep runs it, in one
        # profiler window: its idle share, and no sort left on the CUDA
        # path (each O1/O2 order is one window-order launch); then the
        # largest chain call's preamble, also without a sort.
        shapes = payload_shapes(layers, cfg.lanes, variants)
        torch.cuda.synchronize()
        before = popcount_order.DESCENDING_PERM.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            build_traffic_streamed(layers, cfg, variants, num_streams=m_pad,
                                   shapes=shapes)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        sorts = {e.key: e.count for e in prof.key_averages()
                 if e.key in ("aten::argsort", "aten::sort")}
        if sorts:
            fail(f"the O0/O1/O2 packetize still sorts on the card: {sorts}")
        if popcount_order.DESCENDING_PERM.launches == before:
            fail("the O0/O1/O2 packetize did not launch the window order")
        spans = device_spans(prof)
        busy = busy_us(spans) / 1e3
        pack = {"window_ms": window_ms, "device_spans": len(spans),
                "busy_ms": busy,
                "idle_share": (1 - busy / window_ms) if spans else None,
                "window_order_launches":
                    popcount_order.DESCENDING_PERM.launches - before,
                "packetize_s_unprofiled": next(
                    c["packetize_s"] for c in rep.stats["shape_classes"]
                    if c["mesh"] == "8x8_mc4")}
        u, beam, starts = big_chain
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.chain_inputs(u, starts)
            torch.cuda.synchronize()
        sorts = {e.key: e.count for e in prof.key_averages()
                 if e.key in ("aten::argsort", "aten::sort")}
        if sorts:
            fail(f"the chain preamble still sorts on the card: {sorts}")
        print(f"  no sort in the O0/O1/O2 packetize "
              f"({pack['window_order_launches']} window-order launches) nor "
              f"in the chain preamble; packetize idle share "
              f"{pack['idle_share']} (busy "
              f"{busy:.3f} ms of a {window_ms:.3f} ms window; unprofiled in "
              f"the sweep: {pack['packetize_s_unprofiled']} s)", flush=True)
        report["idle_packetize"] = pack

    with Phase("DarkNet model (trained, 64x64x3)"):
        # The trained DarkNet and one glyph image from a seeded generator on
        # the card; the forward held to the CPU's (TF32 is off).
        dnet, dparams, dshape = trained_model("darknet", device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(11)
        dimg, dlabel = glyph_batch(gen, 1, hw=dshape[0], channels=dshape[2],
                                   device="cuda")
        dlogits = dnet(dimg)
        cpu_dnet = DarkNetLike({k: v.cpu() for k, v in dparams.items()},
                               device="cpu")
        derr = float((dlogits.cpu() - cpu_dnet(dimg.cpu())).abs().max())
        if not derr <= 1e-4:
            fail(f"DarkNet forward on the card is {derr} off the CPU's")
        dlayers = dnet.layer_traffic(dimg[0])
        dcpu_layers = [type(lt)(lt.inputs.cpu(), lt.weights.cpu())
                       for lt in dlayers]
        dpk = sum(int(lt.inputs.shape[0]) for lt in dlayers)
        print(f"  {dpk} packets of {[int(lt.inputs.shape[1]) for lt in dlayers]}"
              f" values; logits within {derr:.2e} of the CPU's; label "
              f"{int(dlabel[0])}, argmax {int(dlogits.argmax())}", flush=True)
        report["darknet_model"] = {"packets": dpk, "forward_max_err": derr,
                                   "label": int(dlabel[0])}

    ops.reset_launch_counts()
    with Phase("DarkNet Fig. 13 cell (4x4_mc2, 40 packets a layer)"):
        # Through every kernel on the card, then through the plain versions
        # on the CPU (window order and router step alike): equal rows.
        t0 = time.perf_counter()
        kern13 = run_sweep(SweepGrid(**FIG13), lambda _name: dlayers)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fig13_launches = {k.name: k.launches for k in ops.KERNELS}
        plain13 = run_sweep(SweepGrid(**FIG13, device="cpu"),
                            lambda _name: dcpu_layers)
        t2 = time.perf_counter()
        check_sweep(kern13, "DarkNet Fig. 13 cell", 6)
        if kern13.rows != plain13.rows:
            fail("DarkNet Fig. 13 rows differ between the kernels on the card "
                 "and the plain versions on the CPU")
        for r in kern13.rows:
            print(f"  {r['precision']:8s} {r['transform']}: total_bt "
                  f"{r['total_bt']} cycles {r['cycles']} flits {r['flits']} "
                  f"reduction {r['reduction_pct']:.2f}% adjusted "
                  f"{r['adjusted_reduction_pct']:.2f}%", flush=True)
        print(f"  6 rows identical; card sweep {t1 - t0:.3f} s (K1 "
              f"{fig13_launches['router_step']}, K2 order "
              f"{fig13_launches['descending_perm']} launches), CPU plain "
              f"sweep {t2 - t1:.3f} s", flush=True)
        # Tab. II's net accounting (benchmarks/table2_power.py) with this
        # card's DarkNet fixed8 / O2 reduction: 64 toggling bits a link and
        # cycle, 112 links, four separated-ordering units.
        red = kern13.row(precision="fixed8", transform="O2")["reduction_pct"]
        tab2 = {"reduction": red / 100,
                "net": power.net_power_saving_mw(64, red / 100, 112, 4,
                                                 separated=True),
                "link_power_ours_mw": power.paper_example(),
                "link_power_banerjee_mw": power.paper_example(
                    power.HW.e_bit_banerjee_pj)}
        n = tab2["net"]
        print(f"  Tab. II: fixed8 O2 reduction {red:.2f}%: link "
              f"{n['baseline_link_mw']:.3f} -> {n['ordered_link_mw']:.3f} mW, "
              f"ordering units {n['ordering_units_mw']:.3f} mW, net saving "
              f"{n['net_saving_mw']:.3f} mW; paper example "
              f"{tab2['link_power_ours_mw']:.3f} mW (ours) / "
              f"{tab2['link_power_banerjee_mw']:.3f} mW (Banerjee)",
              flush=True)
        report["darknet_fig13"] = {"rows": kern13.rows, "cuda": kern13.stats,
                                   "plain_cpu": plain13.stats,
                                   "wall_s": t1 - t0,
                                   "launches": fig13_launches, "tab2": tab2}

    ops.reset_launch_counts()
    with Phase("DarkNet full cell (16x16_mc16, every packet, result phase)"):
        t0 = time.perf_counter()
        repd = run_sweep(SweepGrid(**DARKNET_FULL), lambda _name: dlayers)
        torch.cuda.synchronize()
        walld = time.perf_counter() - t0
        dfull_launches = {k.name: k.launches for k in ops.KERNELS}
        check_sweep(repd, "full DarkNet cell", 12)
        std = repd.stats
        for r in repd.rows:
            got = (r["cycles"], r["flits"], r["result_cycles"],
                   r["result_flits"])
            want = DARKNET_FULL_RECORD[(r["placement"], r["affinity"])]
            print(f"  {r['placement']:11s} {r['affinity']:10s} "
                  f"{r['transform']}: total_bt {r['total_bt']} cycles "
                  f"{r['cycles']} flits {r['flits']} reduction "
                  f"{r['reduction_pct']:.2f}% adjusted "
                  f"{r['adjusted_reduction_pct']:.2f}%; result_bt "
                  f"{r['result_bt']} result_cycles {r['result_cycles']} "
                  f"result_flits {r['result_flits']} "
                  f"({'==' if got == want else '!='} the reference's "
                  f"{want})", flush=True)
            # Cycles and flits depend only on packet lengths, the mesh, the
            # placement and the affinity, not on payload values.
            if got != want:
                fail(f"full DarkNet {r['placement']}/{r['affinity']} "
                     f"{r['transform']}: (cycles, flits, result_cycles, "
                     f"result_flits) {got}, the reference recorded {want}")
            for col in ("total_bt", "result_bt"):
                if not 0 < r[col] < 2**31:
                    fail(f"full DarkNet {r['placement']}/{r['affinity']} "
                         f"{r['transform']}: {col} {r[col]} outside (0, "
                         "2^31) (ROADMAP C5)")
        # The result values the cell sent: layer_results on the card (float32
        # sums in the card's order) held to the CPU's within the summation
        # bound 2 k u sum|x y| (u = 2^-24; ROADMAP C11), the values that
        # differ bitwise counted.
        from repro_torch.noc.traffic import layer_results
        rdiffer = rtotal = 0
        for lt in dlayers:
            got = layer_results(lt, device="cuda").cpu()
            x, y = lt.inputs.cpu(), lt.weights.cpu()
            want = layer_results(type(lt)(x, y), device="cpu")
            bound = (2 * x.shape[1] * 2.0**-24
                     * (x.double() * y.double()).abs().sum(dim=1))
            if not bool(((got.double() - want.double()).abs()
                         <= bound).all()):
                fail(f"layer_results on the card differ from the CPU's "
                     f"beyond 2 k u sum|x y| on a layer of k = {x.shape[1]}")
            rdiffer += int((got.view(torch.int32)
                            != want.view(torch.int32)).sum())
            rtotal += want.numel()
        print(f"  layer_results on the card within 2 k u sum|x y| of the "
              f"CPU's: {rdiffer} of {rtotal} values differ bitwise (C11)",
              flush=True)
        drain = max(r["cycles"] for r in repd.rows)
        rdrain = max(r["result_cycles"] for r in repd.rows)
        dfull = {"packetize_s": std["packetize_s"],
                 "simulate_s": std["simulate_s"],
                 "result_packetize_s": std["result_packetize_s"],
                 "result_simulate_s": std["result_simulate_s"],
                 "wall_s": walld,
                 "lane_cycles_per_s": std["cycles_per_sec"],
                 "us_per_cycle": std["simulate_s"] * 1e6 / drain,
                 "result_us_per_cycle": std["result_simulate_s"] * 1e6
                 / rdrain,
                 "drain_cycles": drain, "result_drain_cycles": rdrain,
                 "layer_results_differ_bitwise": [rdiffer, rtotal],
                 "k1_launches": dfull_launches["router_step"],
                 "k2_order_launches": dfull_launches["descending_perm"]}
        print(f"  {dpk} packets x 12 lanes: packetize "
              f"{dfull['packetize_s']} s, simulate {dfull['simulate_s']} s "
              f"({dfull['us_per_cycle']:.3f} us a simulated cycle over "
              f"{drain} cycles, 16 streams), result packetize "
              f"{dfull['result_packetize_s']} s, result simulate "
              f"{dfull['result_simulate_s']} s "
              f"({dfull['result_us_per_cycle']:.3f} us a simulated cycle "
              f"over {rdrain} cycles, 240 streams); sweep wall "
              f"{walld:.3f} s; {dfull['lane_cycles_per_s']} lane-cycles/s; "
              f"K1 {dfull['k1_launches']}, K2 order "
              f"{dfull['k2_order_launches']} launches", flush=True)
        report["darknet_full"] = {"rows": repd.rows, "stats": std,
                                  "launches": dfull_launches, **dfull}

    with Phase("device idle share (DarkNet packetize and drains, 16x16_mc16)"):
        # The cell's run_sweep call again, in one profiler window: each
        # stage's idle share from its run_sweep span (the device's busy
        # time inside the span), the rows equal to the timed run's.
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            repd_p = run_sweep(SweepGrid(**DARKNET_FULL),
                               lambda _name: dlayers)
        if repd_p.rows != repd.rows:
            fail("the profiled DarkNet cell's rows differ from the timed "
                 "run's")
        k1_spans = sorted((e.time_range.start, e.time_range.end)
                          for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and "router_cycles" in e.name)
        spans = device_spans(prof)
        for stage in ("packetize", "drain", "result_packetize",
                      "result_drain"):
            windows = [(e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.name == f"run_sweep/{stage}"
                       and e.device_type == DeviceType.CPU]
            if len(windows) != 1:
                fail(f"the profiled DarkNet cell has {len(windows)} "
                     f"run_sweep/{stage} spans, one expected")
            lo, hi = windows[0]
            window_ms = (hi - lo) / 1e3
            busy = busy_us(clip_spans(spans, lo, hi)) / 1e3
            k1_ms = busy_us(clip_spans(k1_spans, lo, hi)) / 1e3
            share = (1 - busy / window_ms) if spans else None
            report["darknet_full"][f"idle_{stage}"] = {
                "window_ms": window_ms, "busy_ms": busy, "k1_ms": k1_ms,
                "idle_share": share}
            print(f"  {stage}: {k1_ms:.3f} ms in K1; device idle share "
                  f"{'not measured' if share is None else f'{share:.4f}'} "
                  f"(busy {busy:.3f} ms of a {window_ms:.3f} ms span)",
                  flush=True)

    ops.reset_launch_counts()
    with Phase("compression cell (DarkNet, 16x16_mc16, O0-O3 x none/msr)"):
        # benchmarks/compression.py's darknet_full_16x16 grid whole: every
        # packet streamed, O3 on every DarkNet window (27 to 576 values).
        # The wire tensor of each drain reckoned first: 4 lanes x 16 MC
        # streams x T flits x 17 int32 words.
        from repro_torch.noc.sweep import _QUANTIZERS
        from repro_torch.noc.traffic import payload_shapes, stream_lengths
        # Every chain call of the phase counted by shape, the wire
        # reckoning's shape probes too (restored once the cell has run).
        min_hamming._chain_windows = recorded_chain_windows("compression")
        cvariants = [(wire.by_name(tr, tiebreak="pattern"),
                      _QUANTIZERS["fixed8"])
                     for tr in COMP_DARKNET["transforms"]]
        wire_gb = {}
        for comp in COMP_DARKNET["compression"]:
            shp = payload_shapes(dlayers, 16, cvariants, compression=comp)
            t_len = int(stream_lengths(shp, 16).max())
            wire_gb[comp] = 4 * 16 * t_len * 17 * 4 / 1e9
        print(f"  wire tensors (4 lanes x 16 streams x T x 17 int32): "
              + ", ".join(f"{c} {g:.3f} GB" for c, g in wire_gb.items()),
              flush=True)
        t0 = time.perf_counter()
        repc = run_sweep(SweepGrid(**COMP_DARKNET), lambda _name: dlayers)
        torch.cuda.synchronize()
        wallc = time.perf_counter() - t0
        min_hamming._chain_windows = chain_windows
        comp_launches = {k.name: k.launches for k in ops.KERNELS}
        check_compression_cell(repc, "DarkNet compression cell", "darknet",
                               COMP_DARKNET_RECORD, COMP_DARKNET_OVERHEAD)
        stc = repc.stats
        sim_by = {c["compression"]: c for c in stc["shape_classes"]}
        cyc_by = {comp: max(r["cycles"] for r in repc.rows
                            if r["compression"] == comp)
                  for comp in COMP_DARKNET["compression"]}
        dcomp = {"wall_s": wallc, "packetize_s": stc["packetize_s"],
                 "packetize_by_transform": stc["packetize_by_transform"],
                 "simulate_s": {c: e["simulate_s"] for c, e in sim_by.items()},
                 "packetize_s_by_compression": {
                     c: e["packetize_s"] for c, e in sim_by.items()},
                 "us_per_cycle": {c: sim_by[c]["simulate_s"] * 1e6
                                  / cyc_by[c] for c in cyc_by},
                 "wire_gb": wire_gb,
                 "k1_launches": comp_launches["router_step"],
                 "chain_launches": comp_launches["chain_greedy"],
                 "chain_inputs_launches": comp_launches["chain_inputs"],
                 "k2_order_launches": comp_launches["descending_perm"]}
        print(f"  [{card}] wall {wallc:.3f} s; packetize "
              f"{stc['packetize_s']} s (by transform "
              f"{stc['packetize_by_transform']}; O3 "
              f"{stc['packetize_by_transform'].get('O3')} s); simulate "
              + ", ".join(f"{c} {dcomp['simulate_s'][c]} s "
                          f"({dcomp['us_per_cycle'][c]:.3f} us a simulated "
                          f"cycle over {cyc_by[c]} cycles)" for c in cyc_by)
              + f"; K1 {dcomp['k1_launches']}, chain "
              f"{dcomp['chain_launches']}, chain preamble "
              f"{dcomp['chain_inputs_launches']}, K2 order "
              f"{dcomp['k2_order_launches']} launches", flush=True)
        report["compression_darknet"] = {"rows": repc.rows, "stats": stc,
                                         "launches": comp_launches, **dcomp}

    with Phase("device idle share and chain time (DarkNet compression cell)"):
        # The cell again in one profiler window, rows equal to the timed
        # run's: the chain kernel's device time, and each packetize and
        # drain span's idle share (one span a compression).
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            repc_p = run_sweep(SweepGrid(**COMP_DARKNET),
                               lambda _name: dlayers)
        if repc_p.rows != repc.rows:
            fail("the profiled compression cell's rows differ from the "
                 "timed run's")
        chain_ms = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and "chain_greedy" in e.key) / 1e3
        spans = device_spans(prof)
        idle_c = {}
        for stage in ("packetize", "drain"):
            windows = sorted((e.time_range.start, e.time_range.end)
                             for e in prof.events()
                             if e.name == f"run_sweep/{stage}"
                             and e.device_type == DeviceType.CPU)
            if len(windows) != 2:
                fail(f"the profiled compression cell has {len(windows)} "
                     f"run_sweep/{stage} spans, two expected")
            for comp, (lo, hi) in zip(COMP_DARKNET["compression"], windows):
                window_ms = (hi - lo) / 1e3
                busy = busy_us(clip_spans(spans, lo, hi)) / 1e3
                share = (1 - busy / window_ms) if spans else None
                idle_c[f"{stage}/{comp}"] = {
                    "window_ms": window_ms, "busy_ms": busy,
                    "idle_share": share}
                print(f"  [{card}] {stage} {comp}: device idle share "
                      f"{'not measured' if share is None else f'{share:.4f}'}"
                      f" (busy {busy:.3f} ms of a {window_ms:.3f} ms span)",
                      flush=True)
        print(f"  [{card}] chain kernel: {chain_ms:.3f} ms of device time "
              f"over {comp_launches['chain_greedy']} launches"
              if spans else "  chain kernel device time: not measured",
              flush=True)
        report["compression_darknet"]["chain_device_ms"] = (
            chain_ms if spans else None)
        report["compression_darknet"]["idle"] = idle_c

    with Phase("chain calls (the O3 sweep's and the DarkNet compression "
               "cell's, by shape)"):
        # Every distinct chain call of the two paths on its first call's own
        # stack: kernel ms a call (events over 3 launches) and over the
        # path's calls of that shape, and the tier the shape takes. Then
        # the device time of conv2-under-O3a's call and of the compression
        # cell's costliest from profiler windows here: from the faults
        # phase on the windows record no device activity (PERF.md §7).
        chain_rows = []
        for key in sorted(chain_shapes, key=lambda k: (k[0] != "O3", k[1:])):
            path, p_, r_, w_, beam, starts = key
            _, q, z, _, st = ops.chain_inputs(chain_shapes[key][1], starts)
            q, st = words32(q).contiguous(), st.to(torch.int32).contiguous()
            ms = cuda_ms(lambda: chain_greedy.chain_greedy(q, z, st, beam), 3)
            n = chain_shapes[key][0]
            chain_rows.append(dict(
                path=path, planes=p_, windows=r_, width=w_, beam=beam,
                starts=starts, calls=n, tier=chain_greedy.tier_of(w_, beam),
                ms=ms, total_ms=n * ms))
        print(f"  [{card}] {'path':11s} {'P':>2s} {'R':>6s} {'W':>5s} "
              f"{'beam':>4s} {'calls':>5s} {'tier':8s} {'ms a call':>10s} "
              f"{'ms in all':>10s}", flush=True)
        for c in chain_rows:
            print(f"  [{card}] {c['path']:11s} {c['planes']:2d} "
                  f"{c['windows']:6d} {c['width']:5d} {c['beam']:4d} "
                  f"{c['calls']:5d} {c['tier']:8s} {c['ms']:10.4f} "
                  f"{c['total_ms']:10.3f}", flush=True)
        for path in ("O3", "compression"):
            mine = [c for c in chain_rows if c["path"] == path]
            print(f"  [{card}] {path}: {sum(c['calls'] for c in mine)} chain "
                  f"calls, {sum(c['total_ms'] for c in mine):.3f} ms of "
                  "kernel", flush=True)
        dark = max((c for c in chain_rows if c["path"] == "compression"),
                   key=lambda c: c["ms"])
        dark_chain = (chain_shapes[("compression", dark["planes"],
                                    dark["windows"], dark["width"],
                                    dark["beam"], dark["starts"])][1],
                      dark["beam"], dark["starts"])
        # Device ms a launch: the chain kernel's own time in one profiler
        # window of 10 launches (key_averages, as the compression cell's
        # chain time is read), and the union of the window's device spans,
        # each over the launches the window recorded.
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        chain_dev_ms, chain_span_ms = {}, {}
        for label, (u, beam, starts) in (("chain_greedy", big_chain),
                                         ("chain_greedy/darknet",
                                          dark_chain)):
            _, q, z, _, st = ops.chain_inputs(u, starts)
            q, st = words32(q).contiguous(), st.to(torch.int32).contiguous()
            chain_greedy.chain_greedy(q, z, st, beam)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    chain_greedy.chain_greedy(q, z, st, beam)
                torch.cuda.synchronize()
            seen = [(e.self_device_time_total, e.count)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and "chain_greedy" in e.key]
            n_seen = sum(c for _, c in seen)
            spans = device_spans(prof)
            # A kernel's own time over the launches the window recorded (a
            # window late in a run has been seen to drop some).
            chain_dev_ms[label] = (sum(t for t, _ in seen) / 1e3 / n_seen
                                   if n_seen else None)
            chain_span_ms[label] = (busy_us(spans) / 1e3 / n_seen
                                    if n_seen else None)
            print(f"  [{card}] {label} at {tuple(q.shape)} x {starts} "
                  f"starts: device ms a launch "
                  + ("not measured" if not n_seen else
                     f"{chain_dev_ms[label]:.4f} over the {n_seen} of 10 "
                     f"launches recorded (the window's busy spans "
                     f"{chain_span_ms[label]:.4f} a launch recorded)"),
                  flush=True)
        report["chain_calls"] = {"rows": chain_rows, "device_ms": chain_dev_ms,
                                 "busy_span_ms": chain_span_ms}

    with Phase("compression cell (LeNet, 6x6_mc4, 40 packets a layer)"):
        gen = torch.Generator(device="cuda").manual_seed(11)
        img11, _ = glyph_batch(gen, 1, device="cuda")
        layers11 = net.layer_traffic(img11[0])
        t0 = time.perf_counter()
        repl = run_sweep(SweepGrid(**COMP_LENET), lambda _name: layers11)
        torch.cuda.synchronize()
        walll = time.perf_counter() - t0
        check_compression_cell(repl, "LeNet compression cell", "lenet",
                               COMP_LENET_RECORD, COMP_LENET_OVERHEAD)
        print(f"  [{card}] wall {walll:.3f} s", flush=True)
        report["compression_lenet"] = {"rows": repl.rows,
                                       "stats": repl.stats, "wall_s": walll}

    ops.reset_launch_counts()
    with Phase("faults (LeNet, 6x6_mc4, benchmarks/faults.py's cell)"):
        # The cell whole on the card: its packetize launches the window
        # order (O1/O2), its null-model pin the router kernel; the faulty
        # drains run the plain step (the kernel has no fault hooks).
        fcell = run_faults_cell(layers11, card)
        faults_launches = {k.name: k.launches for k in ops.KERNELS}
        # One drain again on the CPU, on the same traffic: FAULT_SINGLE
        # against the card's (equal to its lane of the batch).
        from repro_torch.noc import faults as faults_mod
        tr1, rate1, prot1 = FAULT_SINGLE
        one_f = fcell["batch"].variant(FAULT_TRANSFORMS.index(tr1))
        t0 = time.perf_counter()
        cpu_f = faults_mod.simulate_faulty(
            fcell["cfg"], type(one_f)(*(t.cpu() for t in one_f[:6]),
                                      num_packets=one_f.num_packets),
            faults_mod.FaultModel(rate=rate1, protect=prot1,
                                  seed=FAULT_SEED),
            chunk=FAULT_CHUNK, device="cpu")
        t_cpu = time.perf_counter() - t0
        card_f = fcell["single"]
        diff = [f.name for f in dataclasses.fields(card_f)
                if not same_fault_field(getattr(card_f, f.name),
                                        getattr(cpu_f, f.name))]
        if diff:
            fail(f"the card's {tr1} / {rate1:g} / {prot1} fault drain "
                 f"differs from the CPU's in {diff}")
        print(f"  [{card}] {tr1} / {rate1:g} / {prot1}: every FaultDrain "
              f"field equal on the card and the CPU ({t_cpu:.3f} s on the CPU, "
              f"{cpu_f.sim.cycles} cycles); K1 "
              f"{faults_launches['router_step']}, K2 order "
              f"{faults_launches['descending_perm']} launches", flush=True)
        # The device's idle share over 128 cycles of the faulty step at
        # three lanes (a drain cut at 128 cycles), from one profiler window.
        from torch.profiler import ProfilerActivity, profile
        fmodel = faults_mod.FaultModel(rate=2e-3, protect="crc8",
                                       seed=FAULT_SEED)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            faults_mod.simulate_faulty_batch(
                fcell["cfg"], fcell["batch"], fmodel, chunk=128,
                max_cycles=128, allow_truncation=True)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        spans = device_spans(prof)
        busy = busy_us(spans) / 1e3
        share = (1 - busy / window_ms) if spans else None
        print(f"  [{card}] faulty step, 3 lanes, 128 cycles in a profiler "
              f"window: device idle share "
              f"{'not measured' if share is None else f'{share:.4f}'} "
              f"(busy {busy:.3f} ms of {window_ms:.3f} ms)", flush=True)
        report["faults"] = {k: fcell[k] for k in (
            "entries", "hard_faults", "zero_fault_identical", "ms_per_cycle",
            "cycles", "wall_s", "matrix_s", "matrix_processes")}
        report["faults"].update(launches=faults_launches, cpu_drain_s=t_cpu,
                                idle_share=share, busy_ms=busy,
                                window_ms=window_ms)

    ops.reset_launch_counts()
    with Phase("serving (DarkNet, 16x16_mc16, benchmarks/serving.py's "
               "darknet grid)"):
        # The grid's O1/O2 packetize launches the window order, its
        # canonical phase drains the router kernel; the gated drains run
        # the plain step (the kernel carries no ledger).
        report["serving"] = run_serving_phase(dlayers, layers11, card)
        serving_launches = {k.name: k.launches for k in ops.KERNELS}
        report["serving"]["launches"] = serving_launches

    with Phase("shard (DarkNet cell on two shards of the card, LeNet on "
               "the card and the host)"):
        # The sharded calls' launches are counted inside (the one-device
        # drains they are held to come after the count).
        report["shard"] = run_shard_phase(dlayers, layers, repd, card)
        shard_launches = report["shard"]["launches"]

    with Phase("dist (static layout, gradient wire, buckets, DTensor)"):
        report["dist"] = run_dist_phase(lparams, dnet, card)
        dist_launches = report["dist"]["launches"]

    with Phase("lm (reduced archs, card against CPU; h2o-danube-3-4b at full "
               "width: serving, static layout)"):
        # The static layout's popcount and BT-counter launches are counted
        # inside (the serving steps before it launch no kernel).
        report["lm"] = run_lm_phase(card)
        lm_launches = report["lm"]["launches"]

    with Phase("train (reduced archs, card against CPU; xlstm-125m at full "
               "width through the launcher, with a restart; the "
               "ordered-collectives cell)"):
        # The phase counts its own launches (reset inside): the gradient
        # wire report's window order and BT counter.
        report["train"] = run_train_phase(card)
        train_launches = report["train"]["launches"]

    with Phase("dryrun (every arch x shape on meta for three meshes, the "
               "hillclimb variants; the cells that fit, on the card)"):
        # No kernel of K1-K6 runs here: the LM stack is plain PyTorch.
        report["dryrun"] = run_dryrun_phase(card)

    ops.reset_launch_counts()
    with Phase("entry points (ordering unit, chain select, popcount, BT)"):
        # The ordering-unit entry points as benchmarks/ordering_throughput.py
        # drives them (2^18 values in windows of 512), and on the trained
        # LeNet's conv2 operands (1600 x 150) zero-padded to W = 256.
        keys = torch.from_numpy(rng.integers(0, 33, (512, 512))
                                .astype(np.int32)).cuda()
        pay = random_words(rng, (512, 512)).view(torch.uint32)
        vals = random_words(rng, (512, 512)).view(torch.uint32)
        conv2 = [F.pad(t, (0, 256 - t.shape[1]))
                 for t in (layers[1].inputs, layers[1].weights)]
        calls = [("sort_windows_desc (512, 512)",
                  ops.sort_windows_desc(keys, pay),
                  lambda: ref.sort_windows_ref(keys, words32(pay)))]
        for name, x in [("order_unit (512, 512) uint32", vals),
                        ("order_unit conv2 inputs", conv2[0]),
                        ("order_unit conv2 weights", conv2[1])]:
            calls.append((name, ops.order_unit(x),
                          lambda x=x: ref.order_unit_ref(words32(x))))
        # One chain step's distance + select at conv2-under-O3a's shape:
        # 1600 windows x 8 starts of 152 lanes, two planes.
        xs6 = [random_words(rng, (12800, 152)) for _ in range(2)]
        pen6 = torch.from_numpy(rng.choice(PENALTIES, (12800, 152))).cuda()
        calls.append(("chain_select (12800, 152) two planes",
                      ops.chain_select(xs6, pen6),
                      lambda: ref.chain_select_ref(xs6, pen6, 152)))
        # The one-to-one popcount on conv2's operands, and the BT recorder's
        # total and per-boundary counts on the weight stream in 8-value
        # flits: entry points the no-NoC path no longer takes (measure
        # takes bt_measure).
        for name, x in [("popcount conv2 inputs", layers[1].inputs),
                        ("popcount conv2 weights", layers[1].weights)]:
            calls.append((name, (ops.popcount(x),),
                          lambda x=x: (ref.popcount_ref(x),)))
        s8 = flits.pack(stream, 8)
        calls.append(("bt_stream (7778, 8)", (bt_mod.bt_stream(s8),),
                      lambda: (ref.bt_total_ref(s8.words),)))
        calls.append(("bt_boundaries (7778, 8)",
                      (ops.bt_boundaries(s8.words),),
                      lambda: (ref.bt_boundaries_ref(s8.words),)))
        unit_launches = {k.name: k.launches for k in ops.KERNELS}
        for name, got, plain in calls:
            want = plain()
            if not all(torch.equal(words32(g), words32(v))
                       for g, v in zip(got, want)):
                fail(f"{name}: kernel != plain version")
        print(f"  {len(calls)} entry-point calls == their plain versions",
              flush=True)

    with Phase("launches"):
        paths = {"no_noc": nonoc_launches, "noc": main_launches,
                 "o3": o3_launches, "darknet_fig13": fig13_launches,
                 "darknet_full": dfull_launches,
                 "compression": comp_launches,
                 "faults": faults_launches,
                 "serving": serving_launches,
                 "shard": shard_launches, "dist": dist_launches,
                 "lm": lm_launches, "train": train_launches,
                 "ordering_unit": unit_launches}
        launches = {k.name: sum(p[k.name] for p in paths.values())
                    for k in ops.KERNELS}
        print("  " + " | ".join(f"{n} {p}" for n, p in paths.items()),
              flush=True)
        for name, n in launches.items():
            if n <= 0:
                fail(f"kernel {name} was not launched on the main path")
        if o3_launches["chain_greedy"] != report["o3"]["chain_calls"]:
            fail(f"the O3 sweep made {report['o3']['chain_calls']} chain "
                 f"calls but {o3_launches['chain_greedy']} chain-kernel "
                 "launches (one a call expected)")
        if o3_launches["chain_select"] != 0:
            fail("the O3 sweep launched the one-step chain-select kernel")
        if o3_launches["chain_inputs"] != report["o3"]["chain_calls"]:
            fail(f"the O3 sweep made {report['o3']['chain_calls']} chain "
                 f"calls but {o3_launches['chain_inputs']} chain-preamble "
                 "launches (one a call expected)")
        for name, launched in (("no_noc", nonoc_launches),
                               ("noc", main_launches)):
            if launched["descending_perm"] != perm_calls[name]:
                fail(f"the {name} path made {perm_calls[name]} CUDA "
                     f"descending_perm calls but "
                     f"{launched['descending_perm']} window-order launches "
                     "(one a call expected)")
        print(f"  descending_perm calls {perm_calls}: one window-order "
              "launch each", flush=True)
        for name, launched in (("darknet_fig13", fig13_launches),
                               ("darknet_full", dfull_launches),
                               ("compression", comp_launches),
                               ("faults", faults_launches),
                               ("serving", serving_launches)):
            for k in ("router_step", "descending_perm"):
                if launched[k] <= 0:
                    fail(f"the {name} path did not launch {k}")
        if shard_launches["router_step"] <= 0:
            fail("the sharded drains did not launch router_step")
        for k in ("popcount", "descending_perm", "bt_count"):
            if dist_launches[k] <= 0:
                fail(f"the dist reports did not launch {k}")
        for k in ("popcount", "bt_count"):
            if lm_launches[k] <= 0:
                fail(f"the LM's static layout did not launch {k}")
        for k in ("descending_perm", "bt_count"):
            if train_launches[k] <= 0:
                fail(f"the train phase's gradient wire did not launch {k}")
        for k in ("chain_greedy", "chain_inputs"):
            if comp_launches[k] <= 0:
                fail(f"the compression cell's O3 did not launch {k}")
        for name in ("bitonic_sort", "order_unit", "chain_select",
                     "popcount", "bt_count"):
            if unit_launches[name] <= 0:
                fail(f"the entry points did not launch {name}")
        report["launches"] = paths
        report["descending_perm_calls"] = perm_calls

    with Phase("kernel vs plain path (pinned budget)"):
        t0 = time.perf_counter()
        kern = run_sweep(SweepGrid(**AXES, **PINNED, backend="cuda"),
                         lambda _name: layers)
        t1 = time.perf_counter()
        plain = run_sweep(SweepGrid(**AXES, **PINNED, backend="plain"),
                          lambda _name: layers)
        t2 = time.perf_counter()
        if kern.rows != plain.rows:
            fail("pinned sweep rows differ between backend='cuda' and "
                 "backend='plain'")
        print(f"  36 rows identical; kernel sweep {t1 - t0:.3f} s "
              f"(simulate {kern.stats['simulate_s']} s), plain sweep "
              f"{t2 - t1:.3f} s (simulate {plain.stats['simulate_s']} s)",
              flush=True)
        report["pinned"] = {"rows": kern.rows, "cuda": kern.stats,
                            "plain": plain.stats}
        # O3/O3a: every kernel on the card against every plain version on
        # the CPU (the chain, the popcount and the router step).
        t0 = time.perf_counter()
        kern3 = run_sweep(SweepGrid(**AXES_O3, **PINNED_SHORT, backend="cuda"),
                          lambda _name: layers)
        t1 = time.perf_counter()
        plain3 = run_sweep(SweepGrid(**AXES_O3, **PINNED_SHORT, device="cpu"),
                           lambda _name: layers)
        t2 = time.perf_counter()
        check_sweep(kern3, "pinned O3 sweep", 36)
        if kern3.rows != plain3.rows:
            fail("pinned O0/O3/O3a rows differ between the kernels on the "
                 "card and the plain versions on the CPU")
        print(f"  36 O0/O3/O3a rows identical; card sweep {t1 - t0:.3f} s, "
              f"CPU plain sweep {t2 - t1:.3f} s", flush=True)
        report["pinned_o3"] = {"rows": kern3.rows, "cuda": kern3.stats,
                               "plain_cpu": plain3.stats}
        # Placements x affinities with the result phase: through the kernels
        # on the card and the plain versions on the CPU. Both sweeps get the
        # result values summed on the CPU: the float32 sums are not a kernel
        # and their order differs between devices (ROADMAP C11).
        result_values = sweep_mod.result_values

        def cpu_result_values(lts, variants, max_packets_per_layer=None,
                              device=None):
            cpu = [type(lt)(lt.inputs.cpu(), lt.weights.cpu()) for lt in lts]
            return [[v.to(device) for v in layer] for layer in result_values(
                cpu, variants, max_packets_per_layer, device="cpu")]

        sweep_mod.result_values = cpu_result_values
        try:
            t0 = time.perf_counter()
            kernp = run_sweep(SweepGrid(**PLACED_F32, **PINNED),
                              lambda _name: layers)
            t1 = time.perf_counter()
            plainp = run_sweep(SweepGrid(**PLACED_F32, **PINNED,
                                         device="cpu"),
                               lambda _name: layers)
            t2 = time.perf_counter()
            # The same grid at fixed8 with both compressions.
            kernm = run_sweep(SweepGrid(**PLACED_MSR, **PINNED_SHORT),
                              lambda _name: layers)
            t3 = time.perf_counter()
            plainm = run_sweep(SweepGrid(**PLACED_MSR, **PINNED_SHORT,
                                         device="cpu"),
                               lambda _name: layers)
            t4 = time.perf_counter()
        finally:
            sweep_mod.result_values = result_values
        check_sweep(kernm, "pinned placement sweep with MSR", 72)
        if kernm.rows != plainm.rows:
            fail("pinned placement x affinity x result-phase rows with "
                 "compression none/msr differ between the kernels on the "
                 "card and the plain versions on the CPU")
        if not all(r["result_compression_overhead_bits"] > 0
                   and r["compression_overhead_bits"] > 0
                   for r in kernm.rows if r["compression"] == "msr"):
            fail("a pinned msr row owes no escape bits")
        print(f"  [{card}] 72 placement x affinity x none/msr rows with the "
              f"result phase identical (overhead columns included); card "
              f"sweep {t3 - t2:.3f} s, CPU plain sweep {t4 - t3:.3f} s",
              flush=True)
        report["pinned_placed_msr"] = {"rows": kernm.rows,
                                       "cuda": kernm.stats,
                                       "plain_cpu": plainm.stats}
        check_sweep(kernp, "pinned placement sweep (float32)", 36)
        if kernp.rows != plainp.rows:
            fail("pinned placement x affinity x result-phase rows differ "
                 "between the kernels on the card and the plain versions on "
                 "the CPU")
        print(f"  36 float32 placement x affinity rows with the result "
              f"phase identical; card sweep {t1 - t0:.3f} s (result simulate "
              f"{kernp.stats['result_simulate_s']} s), CPU plain sweep "
              f"{t2 - t1:.3f} s", flush=True)
        report["pinned_placed"] = {"rows": kernp.rows, "cuda": kernp.stats,
                                   "plain_cpu": plainp.stats}

    with Phase("tune (drain autotune, pinned LeNet drains)"):
        # noc.tune on the card: every candidate (fine / pinned / coarse)
        # must give the first one's rows, which autotune_drain enforces;
        # the winners go beside the report as the table
        # experiments/tune/drain_h100.json is made from.
        from repro_torch.noc import tune
        tune_path = os.path.join(os.path.dirname(os.path.abspath(args.out)),
                                 "drain_h100.json")
        if os.path.exists(tune_path):
            os.remove(tune_path)
        tuned = {}
        for mesh in TUNE_MESHES:
            cfg_t = mesh_by_name(mesh)
            rec = tune.autotune_drain(cfg_t, tune.pinned_drain(cfg_t, 8),
                                      repeats=5, device="cuda")
            tune.save_tuned(rec, tune_path, note=card)
            tuned[mesh] = rec
            print(f"  [{card}] {mesh}: winner {rec['winner']} (chunk "
                  f"{rec['chunk']}, compact_ratio {rec['compact_ratio']}); "
                  "best of five runs, s: " + ", ".join(
                      f"{k} {v}" for k, v in rec["timings"].items()),
                  flush=True)
        report["tune"] = {"records": tuned, "path": tune_path}

    with Phase("ledger (conservation check and timestamps)"):
        # The packet ledger runs on the plain step (the router kernel
        # carries none): the checked sweep's rows equal the K1 sweep's.
        t0 = time.perf_counter()
        k1_rows = run_sweep(SweepGrid(**LEDGER, **PINNED),
                            lambda _name: layers)
        t1 = time.perf_counter()
        checked = run_sweep(SweepGrid(**LEDGER, **PINNED),
                            lambda _name: layers, check_conservation=True)
        t2 = time.perf_counter()
        if checked.rows != k1_rows.rows:
            fail("the conservation-checked sweep's rows differ from the "
                 "router kernel's")
        if (k1_rows.stats["step"], checked.stats["step"]) != ("cuda",
                                                              "plain"):
            fail(f"steps {k1_rows.stats['step']} / {checked.stats['step']}: "
                 "the unchecked sweep must run the router kernel and the "
                 "checked one the plain step")
        print(f"  [{card}] {len(checked.rows)} rows (4x4_mc2, none/msr, "
              f"result phase) with check_conservation == the router "
              f"kernel's; the unchecked drains ran the "
              f"{k1_rows.stats['step']} step ({t1 - t0:.3f} s), the checked "
              f"drains the {checked.stats['step']} step on the card "
              f"({t2 - t1:.3f} s)", flush=True)
        # The negative arm: one packet id duplicated must raise.
        from repro_torch.noc.traffic import build_traffic
        cfg_l = mesh_by_name("4x4_mc2")
        one = build_traffic(layers, cfg_l, wire.by_name("O1"),
                            max_packets_per_layer=8)
        bad = one._replace(pkt=torch.where(one.pkt == 3, 2, one.pkt))
        try:
            sim.simulate(cfg_l, bad, chunk=128, check_conservation=True)
        except RuntimeError as err:
            print(f"  duplicated packet id refused: {err}", flush=True)
        else:
            fail("a traffic with a duplicated packet id passed the "
                 "conservation check on the card")
        # Timestamps: one small drain on the card and on the CPU.
        tc = sim.simulate(cfg_l, one, chunk=128, timestamps=True)
        cpu_one = type(one)(*(t.cpu() for t in one[:6]),
                            num_packets=one.num_packets)
        tp = sim.simulate(cfg_l, cpu_one, chunk=128, timestamps=True,
                          device="cpu")
        if not (np.array_equal(tc.inj_time, tp.inj_time)
                and np.array_equal(tc.eject_time, tp.eject_time)
                and (tc.total_bt, tc.drain_cycle) == (tp.total_bt,
                                                      tp.drain_cycle)):
            fail("the timestamp ledgers on the card differ from the CPU's")
        print(f"  timestamps of {one.num_packets} packets equal on the card "
              f"and the CPU (plain step on both; drain cycle "
              f"{tc.drain_cycle}, last tail ejected at cycle "
              f"{int(tc.eject_time.max())})", flush=True)
        report["ledger"] = {"rows": checked.rows,
                            "steps": [k1_rows.stats["step"],
                                      checked.stats["step"]],
                            "kernel_s": t1 - t0, "checked_s": t2 - t1}

    kernels = []
    with Phase("timing"):
        def bound_of(nbytes, ops_n):
            tb_, to_ = nbytes / HBM_BYTES_PER_S, ops_n / ALU_OPS_PER_S
            return (max(tb_, to_) * 1e3,
                    "bytes" if tb_ >= to_ else "operations")

        # K2 at a main-path shape: conv2's (1600, 150) float32 operands
        # (the largest popcount call of the ordering).
        x = words32(layers[1].weights.contiguous()).contiguous()
        n = x.numel()
        got = popcount.popcount_words(x)
        err = int((got - ref.popcount_ref(x)).abs().max())
        ms = cuda_ms(lambda: popcount.popcount_words(x), 50)
        kl = launch_ms(lambda: popcount.popcount_words(x), 50)
        dk = device_ms(lambda: popcount.popcount_words(x), 50)
        pms = cuda_ms(lambda: ref.popcount_ref(x), 50)
        bound = max(8 * n / HBM_BYTES_PER_S, n / ALU_OPS_PER_S) * 1e3
        kernels.append(dict(
            name="popcount", route="cuda",
            source="src/repro_torch/kernels/csrc/popcount.cu",
            replaces="src/repro/kernels/popcount.py:34",
            launches=launches["popcount"], max_abs_err=err, ms=ms,
            launch_ms=kl, device_ms=dk,
            plain_ms=pms, bound_ms=bound, bound_by="bytes", library_ms=None,
            shape=list(x.shape)))
        # K3 at the no-NoC shape: the float32 weight stream in 8-lane flits,
        # its total alone (bt_stream's); then at the bandwidth shape (2^20,
        # 8), the counts and the total in one launch, and the total alone.
        # Bytes: the words read once, the counts written once; operations:
        # XOR, popcount, add a word.
        fw = words32(flits.pack(stream, 8).words).contiguous()
        s8 = flits.pack(stream, 8)
        wire.measure(s8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            wire.measure(s8)
        measure_ms = (time.perf_counter() - t0) * 1e3 / 50
        fb = random_words(rng, (1 << 20, 8))
        for label, xw, counts, total in (
                ("bt_count", fw, False, True),
                ("bt_count/bandwidth", fb, True, True),
                ("bt_count/bandwidth-total", fb, False, True)):
            f, lanes = xw.shape

            def k3(xw=xw, counts=counts, total=total):
                return bt_count.bt_count(xw, counts=counts, total=total)

            def p3(xw=xw, counts=counts):
                c = ref.bt_boundaries_ref(xw)
                return c, c.sum(dtype=torch.int32)

            got, want = k3(), p3()
            err = max_err([(g, v) for g, v in zip(got, want)
                           if g is not None])
            nbytes = 4 * f * lanes + (4 * (f - 1) if counts else 0) + 4
            bound, by = bound_of(nbytes, 3 * (f - 1) * lanes)
            kernels.append(dict(
                name=label, route="cuda",
                source="src/repro_torch/kernels/csrc/bt_count.cu",
                replaces="src/repro/kernels/bt_count.py:36",
                launches=launches["bt_count"], max_abs_err=err,
                ms=cuda_ms(k3, 50), launch_ms=launch_ms(k3, 50),
                device_ms=device_ms(k3, 50), plain_ms=cuda_ms(p3, 50),
                bound_ms=bound, bound_by=by, library_ms=None,
                library="none: no single call (XOR + popcount)",
                shape=[f, lanes, "counts+total" if counts else "total"]))
        # The measure sums (what one measure launches) at the same two
        # shapes, with the host's wall time per measure beside the no-NoC
        # one. Bytes: the words read once, three int64 written; operations
        # a pair: XOR and three popcounts, two adds, a multiply-add.
        for label, xw in (("bt_measure", fw), ("bt_measure/bandwidth", fb)):
            f, lanes = xw.shape

            def km(xw=xw):
                return bt_count.bt_measure(xw)

            def pm(xw=xw):
                return ref.bt_measure_ref(xw)

            bound, by = bound_of(4 * f * lanes + 24, 8 * (f - 1) * lanes)
            kernels.append(dict(
                name=label, route="cuda",
                source="src/repro_torch/kernels/csrc/bt_count.cu",
                replaces="src/repro/kernels/popcount.py:34",
                launches=launches["bt_measure"],
                max_abs_err=max_err([(km(), pm())]),
                ms=cuda_ms(km, 50), launch_ms=launch_ms(km, 50),
                device_ms=device_ms(km, 50), plain_ms=cuda_ms(pm, 50),
                bound_ms=bound, bound_by=by, library_ms=None,
                library="none: no single call (XOR + popcount + Eq. 3)",
                shape=[f, lanes]))
        kernels[-2]["measure_ms"] = measure_ms
        print(f"  wire.measure on the (7778, 8) weight stream: "
              f"{measure_ms:.4f} ms host wall a call", flush=True)
        def k1_entry(name, cfg, wr, mc, cyc):
            """K1 over one ``cyc``-cycle chunk of ``wr`` from a cold state:
            times, the plain step's, and the bound."""
            key = (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)
            b, m = wr.length.shape
            cold = sim.make_state(cfg, m, batch=b, device="cuda")

            def fresh():
                return (sim.SimState(*(leaf.clone() for leaf in cold)),)

            def k1(state):
                return router_step.router_step(state, wr, mc, cyc, key, True)

            kout = k1(*fresh())
            pout = ref.router_step_ref(cold, wr, mc, cyc, key, True)
            torch.cuda.synchronize()
            err = 0
            for leaf, u, v in zip(kout._fields, kout, pout):
                if leaf == "fifo":
                    u, v = u[:, :cfg.num_routers], v[:, :cfg.num_routers]
                err = max(err, int((u.long() - v.long()).abs().max()))
            nr, p, v, lf = cfg.num_routers, 5, cfg.num_vcs, cfg.lanes + 1
            state_bytes = sum(leaf.numel() * 4 for leaf in cold)
            injected = int(kout.inj_ptr.sum())
            nbytes = 2 * state_bytes + injected * lf * 4 + 2 * b * m * 4
            moved = int(kout.link_flits.sum())
            # Per lane-cycle: route + credit per (router, slot) ~12 ops, the
            # round-robin scan (router, out-port, slot) ~4 ops; per moved or
            # injected flit: XOR + popcount + add per lane, and the LF-word
            # copy.
            ops_n = (b * cyc * (nr * p * v * 12 + nr * p * p * v * 4)
                     + (moved + injected) * (cfg.lanes * 3 + lf))
            tb_, to_ = nbytes / HBM_BYTES_PER_S, ops_n / ALU_OPS_PER_S
            lay = router_step.smem_layout(key, m)
            return dict(
                name=name, route="cuda",
                source="src/repro_torch/kernels/csrc/router_step.cu",
                replaces="src/repro/kernels/router_step.py:269",
                launches=launches["router_step"], max_abs_err=err,
                ms=cuda_ms(k1, 20, make=fresh),
                launch_ms=launch_ms(k1, 20, make=fresh),
                device_ms=device_ms(k1, 20, make=fresh),
                plain_ms=cuda_ms(lambda: ref.router_step_ref(
                    cold, wr, mc, cyc, key, True), 2),
                bound_ms=max(tb_, to_) * 1e3,
                bound_by="bytes" if tb_ >= to_ else "operations",
                library_ms=None,
                library="none: no PyTorch call computes a router cycle",
                shape=[b, nr, m, int(wr.wire.shape[2]), cyc],
                shared=list(lay.in_shared))

        # K1 at the main-path shape: the full-width 8x8_mc4 batch (12
        # lanes, MC streams padded to 8), one 256-cycle chunk from a cold
        # state; then at the result drain's: a synthetic batch of the full
        # DarkNet cell's combos, 12 lanes of 240 PE streams at 16x16
        # (sideband, link_last and payload in global memory).
        cfg = mesh_by_name("8x8_mc4")
        variants = [(wire.by_name(tr, tiebreak=tb), _QUANTIZERS[prec])
                    for prec in AXES["precisions"]
                    for tb in AXES["tiebreaks"] for tr in AXES["transforms"]]
        wr = sim.fuse_traffic(build_traffic_streamed(layers, cfg, variants,
                                                     num_streams=8))
        b, m = wr.length.shape
        mc = torch.as_tensor(np.broadcast_to(np.asarray(
            tuple(cfg.mc_nodes) + (0,) * (m - cfg.num_mcs), np.int32),
            (b, m)).copy(), device="cuda")
        cyc = 256
        kernels.append(k1_entry("router_step", cfg, wr, mc, cyc))
        cfg_r, t_r, mc_r = result_batch(RESULT_K1_CELL, 40000, seed=5)
        k1_result = k1_entry("router_step/result 16x16 M=240", cfg_r,
                             sim.fuse_traffic(t_r), mc_r, cyc)
        del t_r
        # K1 on a warm state: each paper mesh's full-width 12-lane batch
        # after 4,096 cycles (FIFOs occupied, every stream injecting), then
        # 256-cycle chunks from clones of that state: microseconds per
        # simulated cycle (all lanes step together).
        warm = {}
        for mesh in MESHES:
            cfg_w = mesh_by_name(mesh)
            key_w = (cfg_w.rows, cfg_w.cols, cfg_w.num_vcs, cfg_w.vc_depth,
                     cfg_w.lanes)
            m_w = sweep_streams(cfg_w)
            wr_w = sim.fuse_traffic(build_traffic_streamed(
                layers, cfg_w, variants, num_streams=m_w))
            b_w = wr_w.length.shape[0]
            mc_w = torch.as_tensor(np.broadcast_to(np.asarray(
                tuple(cfg_w.mc_nodes) + (0,) * (m_w - cfg_w.num_mcs),
                np.int32), (b_w, m_w)).copy(), device="cuda")
            st_w = sim.make_state(cfg_w, m_w, batch=b_w, device="cuda")
            router_step.router_step(st_w, wr_w, mc_w, 4096, key_w, True)
            torch.cuda.synchronize()

            def k1w(state, wr_w=wr_w, mc_w=mc_w, key_w=key_w):
                return router_step.router_step(state, wr_w, mc_w, cyc, key_w,
                                               True)

            def fresh_w(st_w=st_w):
                return (sim.SimState(*(leaf.clone() for leaf in st_w)),)

            ms_w = cuda_ms(k1w, 20, make=fresh_w)
            dev_w = device_ms(k1w, 20, make=fresh_w)
            lay = router_step.smem_layout(key_w, m_w)
            warm[mesh] = dict(
                us_per_cycle=ms_w * 1e3 / cyc,
                device_us_per_cycle=(dev_w * 1e3 / cyc
                                     if dev_w is not None else None),
                lanes=b_w, streams=m_w,
                flits_in_network=int(st_w.count[:, :cfg_w.num_routers].sum()),
                ejected=int(st_w.ejected.sum()),
                shared=list(lay.in_shared), smem_bytes=lay.bytes,
                threads=lay.threads)
            print(f"  router_step warm on {mesh}: {warm[mesh]['us_per_cycle']:.4f}"
                  f" us a cycle (device {warm[mesh]['device_us_per_cycle']}"
                  f" us), {b_w} lanes, {warm[mesh]['flits_in_network']} flits"
                  f" in the network after 4,096 cycles", flush=True)
        kernels[-1]["warm"] = warm
        kernels.append(k1_result)
        def network_ces(r, w):
            """Compare-exchanges of the bitonic network over r rows of w."""
            s = w.bit_length() - 1
            return r * (w // 2) * s * (s + 1) // 2

        # K4 at the entry point's shape, (512, 512) tie-heavy keys with one
        # payload, then with none and two, on full-range keys, and at the
        # other widths (one payload). Per compare-exchange: one compare and
        # two selects per array (the key, and with payloads the index: the
        # payloads are gathered once); bytes: keys and payloads read once
        # and written once. Beside each, torch.sort + one gather a payload;
        # at the headline shape also the host's time a call (the wrapper)
        # and a bare ctypes launch with its outputs already made.
        k4_timed = [((512, 512), "ties", 1), ((512, 512), "ties", 0),
                    ((512, 512), "ties", 2), ((512, 512), "full", 1),
                    *(((r_, w_), "ties", 1) for r_, w_ in K4_SHAPES[2:])]
        for (r_, w_), kind, n_pay in k4_timed:
            keys = k4_keys(rng, kind, r_, w_)
            pays = [random_words(rng, (r_, w_)) for _ in range(n_pay)]

            def k4(keys=keys, pays=pays):
                return bitonic_sort.sort_windows(keys, *pays)

            def p4(keys=keys, pays=pays):
                return ref.sort_windows_ref(keys, *pays)

            def library_sort(keys=keys, pays=pays):
                sk, si = torch.sort(keys, dim=1, descending=True)
                return (sk, *(torch.gather(p, 1, si) for p in pays))

            arrays = 1 + n_pay
            bound, by = bound_of(8 * arrays * r_ * w_, network_ces(r_, w_)
                                 * (1 + 2 * min(arrays, 2)))
            entry = dict(
                name="bitonic_sort" + ("" if (r_, w_, kind, n_pay)
                                       == (512, 512, "ties", 1) else
                                       f"/{r_}x{w_} {kind} {n_pay}p"),
                route="cuda",
                source="src/repro_torch/kernels/csrc/bitonic_sort.cu",
                replaces="src/repro/kernels/bitonic_sort.py:80",
                launches=launches["bitonic_sort"],
                max_abs_err=max_err(zip(k4(), p4())), ms=cuda_ms(k4, 50),
                launch_ms=launch_ms(k4, 50), device_ms=device_ms(k4, 50),
                plain_ms=cuda_ms(p4, 5), bound_ms=bound, bound_by=by,
                library_ms=cuda_ms(library_sort, 50),
                library="torch.sort(descending=True) + one gather a payload",
                shape=[r_, w_, kind, n_pay])
            if not entry["name"].count("/"):
                outs = k4()
                ptrs = [keys.data_ptr(), *(p.data_ptr() for p in pays),
                        None, *(o.data_ptr() for o in outs), None]
                torch.cuda.synchronize()
                for label, call in (
                        ("wrapper_ms", k4),
                        ("ctypes_launch_ms",
                         lambda: bitonic_sort.KERNEL.launch(
                             *ptrs, r_, w_, n_pay,
                             torch.cuda.current_stream().cuda_stream))):
                    t0 = time.perf_counter()
                    for _ in range(200):
                        call()
                    entry[label] = (time.perf_counter() - t0) * 1e3 / 200
                    torch.cuda.synchronize()
            kernels.append(entry)
        # K5 at the entry points' shapes: (512, 512) words, and conv2's
        # operands zero-padded to (1600, 256); per compare-exchange one
        # compare and two selects per array (key, value, index), plus one
        # popcount a lane; 4 bytes in, 8 out.
        for label, vals in (("order_unit", random_words(rng, (512, 512))),
                            ("order_unit/conv2", words32(F.pad(
                                layers[1].inputs, (0, 106))).contiguous())):
            r_, w_ = vals.shape

            def k5(vals=vals):
                return order_unit.order_unit_words(vals)

            def p5(vals=vals):
                return ref.order_unit_ref(vals)

            bound, by = bound_of(12 * r_ * w_,
                                 network_ces(r_, w_) * 7 + r_ * w_)
            kernels.append(dict(
                name=label, route="cuda",
                source="src/repro_torch/kernels/csrc/order_unit.cu",
                replaces="src/repro/kernels/order_unit.py:51",
                launches=launches["order_unit"],
                max_abs_err=max_err(zip(k5(), p5())), ms=cuda_ms(k5, 50),
                launch_ms=launch_ms(k5, 50), device_ms=device_ms(k5, 50),
                plain_ms=cuda_ms(p5, 5), bound_ms=bound, bound_by=by,
                library_ms=None, library="none: torch has no popcount op",
                shape=[r_, w_]))
        # K6 at conv2-under-O3a's step shape (its entry-point phase call):
        # 1600 windows x 8 starts of 152 lanes, two planes. Per lane: two popcounts, an
        # add and the key (3 ops); per compare-exchange on the padded row:
        # a (key, index) compare (3 ops) and two selects per array; bytes:
        # two planes and the penalty in, dvec and order out.
        r_, w_ = 1600 * 8, 152
        xs = [random_words(rng, (r_, w_)) for _ in range(2)]
        pen = torch.from_numpy(rng.choice(PENALTIES, (r_, w_))).cuda()
        got = chain_select.chain_select(xs, pen, w_)
        want = ref.chain_select_ref(xs, pen, w_)
        err = max_err(zip(got, want))
        ms = cuda_ms(lambda: chain_select.chain_select(xs, pen, w_), 50)
        kl = launch_ms(lambda: chain_select.chain_select(xs, pen, w_), 50)
        dk = device_ms(lambda: chain_select.chain_select(xs, pen, w_), 50)
        pms = cuda_ms(lambda: ref.chain_select_ref(xs, pen, w_), 20)
        wp = 1 << (w_ - 1).bit_length()
        bound, by = bound_of(20 * r_ * w_,
                             network_ces(r_, wp) * 7 + 6 * r_ * w_)
        kernels.append(dict(
            name="chain_select", route="cuda",
            source="src/repro_torch/kernels/csrc/chain_select.cu",
            replaces="src/repro/kernels/min_hamming.py:288",
            launches=launches["chain_select"], max_abs_err=err, ms=ms,
            launch_ms=kl, device_ms=dk,
            plain_ms=pms, bound_ms=bound, bound_by=by, library_ms=None,
            library="none: torch has no popcount op", shape=[r_, w_, 2]))
        # The chain kernel on the O3 sweep's largest chain call (by P * R *
        # W^2: conv2 under O3a, 1600 windows x 8 starts of 152 lanes, two
        # planes) and on the DarkNet compression cell's costliest (by
        # kernel ms in the chain-calls phase), each on its call's own
        # partitioned planes, live counts and starts; at conv2 also the wide
        # tier (the first design) in this call. Operations, the recounted
        # bound (csrc/chain_greedy.cu's note), the least a step needs: beam
        # distance passes over the live lanes (P XORs, P popcounts and P - 1
        # adds a lane; a zero-region lane's distance is the candidate's own
        # popcount, 2P - 1 once), a compare a live lane for each lookahead
        # minimum, and W + (beam - 1) * ceil(log2 W) compares for the beam
        # selection; over ALU_OPS_PER_S, the float32 rate every kernel's
        # operations are held to. Bytes: planes, live counts and starts in;
        # orders and costs out. Device ms: the chain-calls phase's profiler
        # windows.
        for label, (u, beam, starts) in (("chain_greedy", big_chain),
                                         ("chain_greedy/darknet",
                                          dark_chain)):
            _, q, z, _, st = ops.chain_inputs(u, starts)
            q, st = words32(q).contiguous(), st.to(torch.int32).contiguous()
            err = max_err(zip(chain_greedy.chain_greedy(q, z, st, beam),
                              ref.chain_greedy_ref(q, z, st, beam)))

            def k7(q=q, z=z, st=st, beam=beam, tier=None):
                return chain_greedy.chain_greedy(q, z, st, beam, tier=tier)

            def p7(q=q, z=z, st=st, beam=beam):
                return ref.chain_greedy_ref(q, z, st, beam)

            p_, r_, w_ = q.shape
            s_ = st.shape[1]
            live = int(z.clamp(max=w_).sum())
            nbytes = 4 * (p_ * r_ * w_ + r_ + 2 * r_ * s_ + r_ * s_ * w_)
            select = w_ + (beam - 1) * max(w_ - 1, 0).bit_length()
            bound, by = bound_of(nbytes, (w_ - 1) * s_ * (
                beam * (3 * p_ * live + (2 * p_ - 1) * r_) + r_ * select))
            small = label == "chain_greedy"
            entry = dict(
                name=label, route="cuda",
                source="src/repro_torch/kernels/csrc/chain_greedy.cu",
                replaces="src/repro/kernels/min_hamming.py:135",
                launches=launches["chain_greedy"], max_abs_err=err,
                ms=cuda_ms(k7, 20 if small else 5),
                launch_ms=launch_ms(k7, 20 if small else 5),
                device_ms=chain_dev_ms[label],
                plain_ms=cuda_ms(p7, 2 if small else 1), bound_ms=bound,
                bound_by=by, library_ms=None,
                library="none: torch has no popcount op",
                shape=[p_, r_, s_, w_, beam], live=live,
                tier=chain_greedy.tier_of(w_, beam))
            if small:
                # The first design's count: the distance 2P + 3 and each beam
                # pass 2 a lane, each candidate's lookahead 2P + 3 a live
                # lane.
                old, _ = bound_of(nbytes, (w_ - 1) * s_ * (
                    r_ * w_ * (2 * p_ + 3 + 2 * beam)
                    + beam * live * (2 * p_ + 3)))
                entry["bound_ms_old_count"] = old
                entry["wide_tier_ms"] = cuda_ms(
                    lambda: k7(tier="wide"), 20)
                print(f"  chain at {entry['shape']}: bound recounted "
                      f"{bound:.4f} ms ({by}; the first design's count: "
                      f"{old:.4f} ms); register tier {entry['ms']:.4f} ms, "
                      f"wide tier {entry['wide_tier_ms']:.4f} ms", flush=True)
            kernels.append(entry)
        # The window order at conv2's (1600, 150) float32 operands, both
        # tiebreaks (one shared launch counter). Bytes: the words read once,
        # the int64 permutation written once; operations: ~16 a value and
        # pass (key, match, rank and offset, counted and placed).
        xw = words32(layers[1].weights.contiguous()).contiguous()
        r_, w_ = xw.shape
        for tb, passes in (("stable", 1), ("pattern", 5)):
            def kd_(tb=tb):
                return popcount_order.descending_perm(xw, tb, 32)

            def pd_(tb=tb):
                return ref.descending_perm_rows_ref(xw, tb, 32)

            err = max_err([(kd_(), pd_())])
            bound, by = bound_of(12 * r_ * w_, 16 * passes * r_ * w_)
            kernels.append(dict(
                name="descending_perm" + ("/pattern" if passes > 1 else ""),
                route="cuda",
                source="src/repro_torch/kernels/csrc/popcount_order.cu",
                replaces="src/repro/kernels/popcount.py:34",
                launches=launches["descending_perm"], max_abs_err=err,
                ms=cuda_ms(kd_, 50), launch_ms=launch_ms(kd_, 50),
                device_ms=device_ms(kd_, 50), plain_ms=cuda_ms(pd_, 50),
                bound_ms=bound, bound_by=by, library_ms=None,
                library="none: torch has no popcount op",
                shape=[r_, w_, tb]))
        # The chain preamble on the largest chain call's stack (conv2 under
        # O3a: 2 x 1,600 x 152). Bytes: the planes read once; part (int64),
        # q, z, cid and the int64 starts written once; operations ~(2P + 16)
        # a value.
        u, _, starts = big_chain
        p_, r_, w_ = u.shape

        def k8():
            return ops.chain_inputs(u, starts)

        err = max_err(zip(k8(), ref.chain_inputs_ref(u, starts)))
        bound, by = bound_of(4 * p_ * r_ * w_ + 8 * r_ * w_ + 4 * p_ * r_ * w_
                             + 8 * r_ + 8 * r_ * starts,
                             (2 * p_ + 16) * r_ * w_)
        kernels.append(dict(
            name="chain_inputs", route="cuda",
            source="src/repro_torch/kernels/csrc/popcount_order.cu",
            replaces="src/repro/kernels/popcount.py:34",
            launches=launches["chain_inputs"], max_abs_err=err,
            ms=cuda_ms(k8, 50), launch_ms=launch_ms(k8, 50),
            device_ms=device_ms(k8, 50),
            plain_ms=cuda_ms(lambda: ref.chain_inputs_ref(u, starts), 50),
            bound_ms=bound, bound_by=by, library_ms=None,
            library="none: torch has no popcount op",
            shape=[p_, r_, w_, starts]))
        for kd in kernels:
            if kd["max_abs_err"] != 0:
                fail(f"kernel {kd['name']} disagrees at the timing shapes")
            lib = (f"{kd['library_ms']:.4f} ms" if kd["library_ms"]
                   is not None else "none")
            dev = (f"{kd['device_ms']:.4f} ms" if kd["device_ms"]
                   is not None else "not measured")
            print(f"  {kd['name']}: {kd['ms']:.4f} ms a launch in a run "
                  f"(single launches {kd['launch_ms']:.4f} ms; device busy "
                  f"{dev} a launch; plain "
                  f"{kd['plain_ms']:.4f} ms, bound {kd['bound_ms']:.5f} ms by {kd['bound_by']}, "
                  f"library {lib}) shape {kd['shape']} launches "
                  f"{kd['launches']}", flush=True)
            if "wrapper_ms" in kd:
                print(f"    host time a call: {kd['wrapper_ms']:.4f} ms "
                      f"through the wrapper, {kd['ctypes_launch_ms']:.4f} ms "
                      "a bare ctypes launch", flush=True)
        report["kernels"] = kernels

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=str)

    print(json.dumps({"kernels": [{k: kd[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for kd in kernels]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
