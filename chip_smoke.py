#!/usr/bin/env python3
"""Quickest proof that fishnet_tpu_torch runs on one NVIDIA H100.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card, the toolchain versions;
  2. the kernel build (nvcc, sm_90a) from fishnet_tpu_torch/csrc/, one
     nvcc per source, all started together;
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes (B = 16, 64 and 1024 lanes, L1 = 64) on the
     shipped f32 net and on its int8 quantization; the TT probe and store
     (K5, K6) on seeded tables with forced slot collisions (up to 8192
     lanes into 2^6 or 2^21 slots, and every lane on one of four slots),
     plain and prefer_deep (mixed generations), deep_bounds off and on,
     with contiguous inputs and with the runner's strided and broadcast
     ones; the lane init (K7) over
     every lane and over a scattered quarter of them; the board rules,
     move generator and make-move (K8-K10) on seeded tactical, promotion,
     en-passant, check and chess960 castling positions and playouts from
     them, with and without killers and history, over every generated
     move; the segment kernel (K11) against run_segment_plain on seeded
     playout states at 16, 64 and 1024 lanes on both nets, without a
     table, with a 2^21 table, with jittered helpers and the prefer_deep
     store into a 2^12 table (colliding slots), and with deep_tt probes,
     and at 16 and 64 lanes the main path's rules with helpers into a
     2^6 table ("tiny": a step's leaf stores and the next step's probes
     and interior stores share slots; K11 must count reads through a
     store's pending rows), over segments of 1, 7, 33 and 200 steps and
     (16 lanes) one in which every lane finishes: states, tables,
     summaries and step counts byte for byte; the full evals (K12 on a
     seeded king-bucketed net at L1 256, f32 and int8; K13 on seeded Stockfish nets at L1 128 and 3072,
     written and read as .nnue files) at 16, 64 and 1024 lanes (K13 also
     on tests/test_torch_sf_eval.py's boards of every output bucket and
     king square, both sides to move, at L1 128, 200 and 130); K11 on
     the int8 king-bucketed net (without and with a 2^21 table) and on
     the L1 3072 Stockfish net (jittered helpers, 2^12 slots) against
     run_segment_plain, byte for byte; the trainer's kernels (K14 the
     layer stack's backward, K15 the feature transform's, K16 the Adam
     update) at batch 16 and 512 on seeded diverse positions: K14 within
     a stated tolerance and the same bytes when repeated, K15 byte for
     byte the plain version run on the CPU (and repeated), also on 512
     start positions, 2,048 samples (four bitmap windows), L1 32 and L1
     1040, K16 bit for bit; with times (queued CUDA events: the card spins
     while the host queues the calls; torch.profiler only as a logged
     check; K15's mark and row passes also on their own) and bounds from
     the bytes these inputs need;
  4. where a segment's time goes (torch.profiler over one K11 segment of
     PROFILE_STEPS steps: B = 16 and 1024 without the table, B = 64 with
     it): host ms/step, device busy ms/step, the device's idle share;
  5. the main path: one standard-chess analysis chunk through GpuEngine()
     with its defaults (continuous lane refill through the LaneScheduler,
     2^21-slot table, FISHNET_TPU_HELPERS helper lanes, MAX_PLY 32,
     depth 3), with each segment's occupancy;
  6. the same main path on the seeded L1 3072 Stockfish net, through
     GpuEngine(weights_path=<its .nnue file>) (K13 inside K11, no K1);
  7. the board768 chunk chunk-serially (refill off, table and helpers
     on, depth 2);
  8. the same chunk without the table or helpers (depth 2), chunk-
     serially and through the LaneScheduler, the two with equal
     responses;
  9. search_batch on the int8 net, card against CPU, field for field;
 10. an int8 search with the table and helper lanes, card against CPU,
     field for field and the tables byte for byte, on the board768 net
     and on the king-bucketed net (K12 inside K11);
 11. search_stream on the int8 net (more positions than lanes, staggered
     depths, a table), card against CPU: every field, the occupancy rows
     and the tables byte for byte;
 12. search_batch at B = 1024 lanes on the f32 net;
 13. the trainer's main path: train_material_net on the card, 200 Adam
     steps at batch 512 and lr 2e-3 over 4,096 diverse positions (the
     shipped widths, a seeded init), its first 20 steps (losses, params)
     held against the same steps on the CPU's plain path; it fails unless
     K1, K2 and K14-K16 each launched once a step and no plain version
     ran; then a profiled window of 50 steps (ms/step, device busy
     ms/step, the host's share).
Phases 4-12 reset the kernels' launch counters just before each search
and fail unless every kernel of its path launched during it (K7 and K11,
and K1 on a board768 net but never on the others), its net's eval body
ran inside K11, and none of the kernels whose bodies run inside K11
launched on its own (but K4, which hashes the engine's game history once
a chunk).
 14. the variants' main paths: one chunk each of threeCheck,
     kingOfTheHill, racingKings, horde, antichess, crazyhouse and atomic
     (10 positions of one seeded game) through GpuEngine() with its
     defaults (depth 3): wall, steps, segments, refills, nodes/s
     (crazyhouse: the drops among the best moves); it fails unless the
     search's kernels launched (K4 on the game history, K11 through the
     variant's own entry point; in atomic K1's body inside K11 and K3's
     never) and no plain version of the search ran;
 15. each variant's int8 chunk (1 position, depth 3, a 2^16 table, 2
     helper lanes, MAX_PLY 8) through GpuEngine on the card and on the
     CPU (the CPU sides at once, in worker processes): the responses
     equal; and the same way a 2-position standard chunk on the bf16 net
     (cast_params), by the f32 rule: equal depths and best moves, scores
     within 2 cp.
The kernel phase (3) also holds the variant instantiations of K4 and
K8-K10 against their plain versions at 16, 64 and 1024 lanes of seeded
variant positions (game ends, promotions, horde's first-rank pawns,
threeCheck counters, crazyhouse's pockets, promoted pieces and drops,
atomic's blasts, adjacent and exploded kings, and playouts), timed at 64
and 1024 lanes (crazyhouse's K9 also with every lane at a mid, heavy or
full pocket), and K11 against run_segment_plain in each variant (16 and
64 lanes, both nets, a table and jittered helpers, segments of 1, 7, 33
and 100 steps, atomic also at 16 lanes on the king-bucketed int8 net;
then the main path's 64-lane setup, and crazyhouse's on each pocket
case), with K11's time per step at 64 lanes; and the bf16 entry points
(FISHNET_TPU_DTYPE=bf16, cast_params: bf16 weights, f32 arithmetic) of
K1, K2, K3 and K12 at 16, 64 and 1024 lanes against their plain versions
and against the f32 kernels on the widened weights (byte for byte), and
of K11 (16 and 64 lanes, atomic at 64, the king-bucketed net at 16)
against run_segment_plain and the f32 K11 byte for byte, timed beside
the f32 kernels in turn. Right after K12's timing it also logs K12's
f32 warm time read by the profiler and by queued CUDA events on the
boards of both phases that time K12, at both phases' call counts.
 16. the bf16 main path: the board768 chunk of phase 5 through GpuEngine()
     under FISHNET_TPU_DTYPE=bf16 (its weights bf16 on the card), through
     the bf16 entry points of K1 and K11 only; then a bf16 search on the
     king-bucketed net (K12's bf16 body in K11). Both run right after
     phase 5, so the bf16 and the f32 main path both follow phase 4's
     warm-up.
 17. the lane mesh (parallel/mesh.py), right after phase 16: 4 shards of
     cuda:0, each with its own 16 lanes, 2^21-slot table and CUDA stream.
     The board768 main path through GpuEngine(mesh=make_mesh(["cuda:0"] *
     4)) at its defaults (steps a shard and the largest, segments,
     refills, nodes, wall, boundary host ms, transfers; K11 launched once
     a shard and segment, K7, K1); the chunk without tables or helpers on
     the mesh equal to one device's; the sharded segment's time with each
     shard's CUDA events (do the shards' launches overlap?) and one
     shard's K11 alone; K11 a shard against run_segment_plain on a seeded
     64-lane state, without and with tables (states, tables, step counts,
     the stacked summary byte for byte); K7 a shard (refill_lanes_sharded)
     against its plain version. Phase 15 adds an int8 2-position chunk on
     the 4-shard mesh, card against CPU shards, responses equal.
 18. right after phase 13, the king-bucketed trainer: phase 13 on a
     king-bucketed net (train_material_net(feature_set="halfkav2_hm"),
     L1 64; K17 for K1 and K18 for K15), its first 20 steps against the
     CPU's, its profiled window;
 19. then the dp×tp step (make_sharded_train_step) on make_2d_mesh(4, 2,
     ["cuda:0"] * 8) at batch 512, for a board768 and a king-bucketed
     net: 20 steps in which every position launches K1 or K17, K2, K14,
     K15 or K18 and K16 once a step and no plain version runs, the
     losses and every position's params against the same grid of 8 cpu
     devices, then ms a step, the host's share and launches a step.
The kernel phase (3) also holds K17 nnue_refresh_kb (byte for byte, also
on a tp shard's columns and on tests/test_torch_sf_eval.py's
KB_REFRESH_CASES: L1 64, a tp block, 33, 1040 and a misaligned view,
against the plain version on the card and on the CPU) and K18 nnue_ft_backward_kb (as K15, its wide
case at L1 256) to their plain versions at batch 32 and 512, times them
(K18's passes also on their own), and holds and times K16 over the
king-bucketed flat buffer. K11's plain yardsticks (phase 3's timed segments, the bf16 and
the mesh segment) time a PLAIN_TIMING_STEPS-step segment; the plain
segments that are checked against K11 run at their full lengths.
Then a `kernels` JSON line (launches from phase 5, the board768 main
path, for K13 from phase 6, for K12 from its parity search in phase
10, for K14-K16 from phase 13 and for K17 and K18 from phase 18; for the
bodies inside K11 their calls per step of that path; K1 and K2 also with
their launches in phase 13, K2, K14 and K16 in phase 18, and K1, K2 and
K14-K18 on phase 19's grids;
K4 and K8-K11 also per variant: max_abs_err, ms, plain_ms (K11: us per
step), launches and calls per step in phase 14; K1 also its launches and
its body's calls per step in atomic's phase 14 chunk; then a row per bf16
entry point with its launches on phase 16's bf16 main path, K12's on its
bf16 king-bucketed search; then a row each for K11 and K7 a shard on
phase 17's mesh main path), the card's name and
power limit, and the result line `{"ok": true, "device": {...}}`.

`python3 chip_smoke.py --main-path-ab TREE [REPS]` instead runs only the
one-card main path, REPS times a process, for an earlier tree of the
repository (TREE, unpacked with git archive; it needs only its
fishnet_tpu_torch package) and for this one, parent, this, this, parent,
each run's counts, times and responses digest one JSON line, then the
chunk on the seeded L1 3072 Stockfish net (its responses digest, steps
and nodes), then each process's digests of K2's, K6's, K9's and K13's
outputs on seeded inputs (K13 at L1 128 and 3072 and on the fixtures), of
the board768 and king-bucketed trainers' params after their 200 steps
and of the 4 x 2 grid's after 20 steps, and its K11 us-per-step table
(every variant and net at 16, 64 and 1024 lanes), and one line
`{"digests_equal": ...}` over all four processes (exit 1 where the
digests differ).

`python3 chip_smoke.py --k11-split TREE...` instead splits K11's step
into parts for each tree in turn (this one as `.`): a copy of the tree's
package under build/k11-split/ whose segment kernel thread 0 of each
warp times with clock64() (its grid barriers, its lanes' steps, the
whole step loop; the rest is the table's claims and commits and the live
flags), on the "engine" states of segment_case at 16, 64 and 1024 lanes,
one JSON line a tree (a tree that launches one thread-block cluster also
patched to launch the cooperative grid), then the card's name and power
limit. A measurement build: the package itself has no such counters.
`python3 chip_smoke.py --sf-split TREE...` splits K11's step on the
seeded L1 3072 Stockfish net the same way (segment_case's "engine"
states at 16, 64 and 1024 lanes), and where the tree spreads K13's units
over the warps also counts the owners' waits, the units the owners and
the other warps ran, the helping and the jobs posted, one JSON line a
tree. Both are measurement builds: the package has no such counters.
`python3 chip_smoke.py --ptxas TREE...` prints, a JSON line a tree,
ptxas's registers, stack frames and spills for every kernel of every
library (nvcc -Xptxas -v with the build's flags).
"""
from __future__ import annotations

import asyncio
import contextlib
import functools
import hashlib
import json
import os
import random
import subprocess
import sys
import time

# HBM rate and the f32 CUDA-core rate of one H100 SXM (NVIDIA data sheet);
# integer adds/XORs run on the same cores and are bounded by that rate too
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

TIME_BUDGET_S = 1200  # the whole script, the build included
DEPTH = 3  # engine analysis depth (PERF.md)
SERIAL_DEPTH = 2  # the same chunk through the chunk-serial path
NO_TT_DEPTH = 2  # the same chunk without the table or helpers
POSITIONS = 10  # positions in the engine's chunk
PARITY_DEPTH = 3
TT_PARITY_LOG2 = 16  # table of the card-against-CPU TT searches
STREAM_POSITIONS = 24  # positions of the card-against-CPU stream
STREAM_WIDTH = 16
SCALE_LANES = 1024  # bench.py's default lane count
SCALE_DEPTH = 3
REPS = 200  # launches per kernel timing
PROFILE_STEPS = 200  # steps of the profiled segment
SEGMENT_STEPS = (1, 7, 33, 200)  # K11's checked segments, in turn on one state
FINISH_STEPS = 20_000  # then, at 16 lanes, one segment in which every lane finishes
SEGMENT_CONFIGS = ("no table", "table", "helpers", "deep_tt")
TINY_LANES = (16, 64)  # the lanes K11 runs the "tiny" table setup at (segment_phase)
SEGMENT_REPS = 10  # K11 launches per timing
# steps of the short segment that times K11's plain yardstick (the "plain"
# figures of K11's timed rows; the plain segments that are checked against
# K11 run at their full lengths)
PLAIN_TIMING_STEPS = 10
# the full-eval nets: a king-bucketed net at the JAX
# package's init_params defaults, and seeded Stockfish nets, the main
# path's at Stockfish's big net's width
KB_WIDTHS = (256, 16, 32)  # L1, H1, H2
SF_L1 = 3072
SF_SMALL_L1 = 128
NET_REPS = 20  # launches per full-eval kernel timing
# bytes the card writes before each cold-L2 call (time_cold_ms): 21x the
# H100's 50 MB L2, and about 0.3 ms of writes, in which the host queues
# the timed call
L2_SCRUB_BYTES = 1 << 30
# cycles the card spins (about 0.1 s) while the host queues a timed run
# of calls (time_queued_ms)
QUEUE_SPIN_CYCLES = 200_000_000
NET_SEGMENT_STEPS = (1, 7, 33, 120)  # K11's checked segments on these nets

# the trainer: train_material_net at the shipped widths with
# tools/train_default_net.py's batch and learning rate, over diverse
# positions made from a seed
TRAIN_SAMPLES = 4096
TRAIN_STEPS = 200
TRAIN_BATCH = 512
TRAIN_LR = 2e-3
TRAIN_CHECK_STEPS = 20  # the card's first steps, held against the plain CPU run
TRAIN_PROFILE_STEPS = 50  # steps of the profiled training window
TRAIN_REPS = 100  # launches per K14-K16 timing
# stated tolerances: K14 and K15 within TRAIN_GRAD_RTOL of each output's
# largest magnitude (their sums run in another order than the plain
# versions'); the card's first steps against the CPU: each loss within
# TRAIN_LOSS_RTOL, the params within TRAIN_PARAM_ATOL, 5% of one Adam step
# at lr 2e-3 (the gradients' last bits, which Adam's normalisation can
# carry into an update where a gradient is near 0)
TRAIN_GRAD_RTOL = 1e-5
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_ATOL = 1e-4
# the kernels of a training step: the forward's K1 and K2, then K14-K16
TRAIN_KERNELS = ("nnue_refresh_768", "nnue_forward_from_acc", "nnue_stack_backward",
                 "nnue_ft_backward_768", "adam_update")
# on a king-bucketed net: K17 for K1, K18 for K15
TRAIN_KB_KERNELS = ("nnue_refresh_kb", "nnue_forward_from_acc", "nnue_stack_backward",
                    "nnue_ft_backward_kb", "adam_update")
TRAIN_PATH_KERNELS = {"board768": TRAIN_KERNELS, "halfkav2_hm": TRAIN_KB_KERNELS}
# the dp×tp step (models/train.py make_sharded_train_step): the reference
# caller's grid on 8 devices (make_2d_mesh(n // 2, 2), L1 32 * tp), here
# eight positions of cuda:0, its batch, the steps held against the same
# grid of cpu devices; and K17/K18's checks also at the caller's batch
# (8 x dp)
GRID = (4, 2)
GRID_STEPS = 20
GRID_CALLER_BATCH = 8 * GRID[0]
# K15's and K18's fixtures beside the trainer's seeded batches (label,
# batch, L1, boards: ft_case): every board the start position (each piece
# row holds all 1,024 pairs of the window, the longest chains), a batch of
# four windows, a tp position's 32 columns, and a wide L1 (FT_WIDE_L1: K18
# at the king-bucketed nets' 256, K15 past its old 1,024-column limit,
# with a ragged last slice)
FT_CASES = (("start positions", 512, 64, "start"), ("2048 samples", 2048, 64, "seeded"),
            ("L1 32", 512, 32, "seeded"), ("wide", 512, 0, "seeded"))
FT_WIDE_L1 = {"board768": 1040, "halfkav2_hm": 256}

START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
# a Sicilian and a Ruy Lopez with repetitions near the end (so the
# game-history repetition seeds are live)
GAMES = [
    ["e2e4", "c7c5", "g1f3", "d7d6", "d2d4", "c5d4", "f3d4", "g8f6", "b1c3",
     "a7a6", "c1e3", "e7e5", "d4b3", "c8e6", "f2f3", "f8e7", "d1d2", "e8g8",
     "g1h1", "f8e8", "h1g1", "e8f8"],
    ["e2e4", "e7e5", "g1f3", "b8c6", "f1b5", "a7a6", "b5a4", "g8f6", "e1g1",
     "f8e7", "f1e1", "b7b5", "a4b3", "d7d6", "c2c3", "e8g8", "h2h3"],
]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def nvcc_version() -> str:
    from fishnet_tpu_torch import kernels

    out = subprocess.run([kernels._nvcc(), "--version"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[-1]


# the kernels every search path launches: the lane init (K7) and the
# segment kernel (K11), with or without the table, and on a board768 net
# the root refresh (K1), which the full-eval nets do not run; and the eval
# body K11 runs on each net kind
SEARCH_KERNELS = ("lane_init", "search_segment")
EVAL_BODY = {"board768": "nnue_forward_from_acc", "king": "nnue_evaluate",
             "stockfish": "nnue_evaluate_sf"}


def check_launches(path: str, engine: bool = False, net: str = "board768",
                   variant: str = "standard") -> dict:
    """The kernels' launch counts since the last reset: every kernel of a
    search path must have launched (K1, for the roots, on a board768 net
    and never on the full-eval nets), its net's eval body must have run
    inside K11 (in atomic on a board768 net K1's body too, and K3's never),
    and no other kernel whose body runs inside K11 may have launched on
    its own — but on the engine's paths K4, which hashes the game history
    before each chunk."""
    from fishnet_tpu_torch import kernels

    launches = dict(kernels.LAUNCHES)
    calls = kernels.body_calls()
    need = SEARCH_KERNELS + (("nnue_refresh_768",) if net == "board768" else ())
    missing = [name for name in need if launches[name] <= 0]
    refresh_leaf = net == "board768" and variant == "atomic"
    for body in (EVAL_BODY[net],) + (("nnue_refresh_768",) if refresh_leaf else ()):
        if calls[body] <= 0:
            missing.append(f"{body} (inside K11)")
    if missing:
        raise AssertionError(f"{path}: kernels {missing} were not launched ({launches})")
    if net != "board768" and launches["nnue_refresh_768"]:
        raise AssertionError(f"{path}: K1 launched on a {net} net ({launches})")
    if refresh_leaf and calls["nnue_acc_update_768"]:
        raise AssertionError(f"{path}: K3's body ran in atomic ({calls})")
    alone = [name for name in kernels.K11_BODIES if launches[name] > 0 and name not in need
             and not (engine and name == "zobrist_hash")]
    if alone:
        raise AssertionError(f"{path}: kernels {alone} launched outside K11 ({launches})")
    log(f"launches {path}: {launches}; inside K11: {calls}")
    return launches


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def profile_ms(fn, reps: int) -> float:
    """The device ms of one fn() that torch.profiler records over reps
    calls (0 where it records none). A short profile under-reads (PERF.md
    §7), so no time in the kernels line comes from it; time_ms logs it
    beside the queued-event reading as a check."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(_device_us(e) for e in prof.key_averages() if e.device_type.name == "CUDA")
    return dev_us / reps / 1e3


# (queued ms, profiler ms) of every time_ms reading checked in this run
TIME_CHECKS: list = []
PROFILE_CHECK_MS = 200.0  # time_ms profiles fn when reps calls take less


def time_ms(fn, reps: int):
    """(warm ms, call ms) of one fn() on the card: the warm figure from
    queued CUDA events (time_queued_ms, the card spinning while the host
    queues the reps calls, so the events read the card's time), the call
    figure from CUDA events around reps back-to-back calls (the host's
    launch overhead included). Where reps calls take under
    PROFILE_CHECK_MS, torch.profiler reads the same calls too, and a
    reading more than 10% off the queued one is logged (TIME_CHECKS
    keeps every pair)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / reps
    queued = time_queued_ms(fn, reps, spin_ms=reps * call_ms)
    if reps * call_ms < PROFILE_CHECK_MS:
        prof = profile_ms(fn, reps)
        TIME_CHECKS.append((queued, prof))
        if abs(prof - queued) > 0.1 * queued:
            log(f"time check: queued events {queued:.5f} ms, profiler {prof:.5f} ms "
                f"({prof / queued:.3f}x) over {reps} calls (call {call_ms:.5f} ms)")
    return queued, call_ms


def time_cold_ms(fn, reps: int, scrub) -> float:
    """ms of one fn() on the card with a cold L2: before each call the
    card overwrites `scrub` (L2_SCRUB_BYTES, far more than the L2 holds),
    and CUDA events time the call alone. The scrub keeps the card behind
    the host, so the events see the card's time, not the host's."""
    import torch

    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        scrub.fill_(len(marks) + 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / reps


def playout_positions(n: int, seed: int):
    """n positions from seeded random playouts → (Positions, the legal
    move played from each)."""
    from fishnet_tpu_torch.chess import Position

    rng = random.Random(seed)
    positions, moves = [], []
    pos = Position.initial()
    while len(positions) < n:
        legal = pos.legal_moves()
        if not legal or pos.halfmove >= 90:
            pos = Position.initial()
            continue
        positions.append(pos)
        moves.append(rng.choice(legal))
        pos = pos.push(moves[-1])
    return positions, moves


def playout_boards(n: int, seed: int):
    """n positions from seeded random playouts → (Board, legal moves)."""
    from fishnet_tpu_torch.ops.board import from_position, stack_boards

    positions, moves = playout_positions(n, seed)
    return stack_boards([from_position(p) for p in positions]), moves


def encode(m) -> int:
    promo = {None: 0, 1: 1, 2: 2, 3: 3, 4: 4, 5: 5}[m.promotion]  # 5: a king (antichess)
    return m.from_sq | (m.to_sq << 6) | (promo << 12)


def kernel_phase(params_f32, reps: int) -> dict:
    """Each kernel against its plain version at B = 16, 64 (the engine's
    dispatch width) and 1024 on both nets; returns per-kernel stats for the kernels line (times at
    B = 1024 on the f32 net)."""
    import torch
    import torch.nn.functional as F

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import tt
    from fishnet_tpu_torch.ops.board import move_piece_changes

    dev = torch.device("cuda")
    stats = {k: {"max_abs_err": 0.0} for k in (
        "nnue_refresh_768", "nnue_forward_from_acc", "nnue_acc_update_768", "zobrist_hash")}
    params_i8 = nnue.quantize_int8(params_f32)
    for B in (16, 64, 1024):
        cpu_boards, moves = playout_boards(B, seed=B)
        b = cpu_boards.to(dev)
        mv = torch.tensor([encode(m) for m in moves], dtype=torch.int32, device=dev)
        codes, sqs, signs = move_piece_changes(b, mv)
        bucket = nnue.output_bucket(b.board)
        pieces = int((b.board > 0).sum())
        for net, p in (("f32", params_f32), ("int8", params_i8)):
            tol = 0.0 if net == "int8" else None
            acc_k = nnue.accumulators_768(p, b.board)
            acc_p = nnue.accumulators_768_plain(p, b.board)
            checks = {"nnue_refresh_768": (acc_k, acc_p, 0.0)}
            ev_k = nnue.forward_from_acc(p, acc_p, b.stm, bucket)
            ev_p = nnue.forward_from_acc_plain(p, acc_p, b.stm, bucket)
            checks["nnue_forward_from_acc"] = (
                ev_k, ev_p, nnue.F32_EVAL_TOL if tol is None else tol)
            up_k = nnue.apply_acc_updates_768(p, acc_p, codes, sqs, signs)
            up_p = nnue.apply_acc_updates_768_plain(p, acc_p, codes, sqs, signs)
            checks["nnue_acc_update_768"] = (up_k, up_p, 0.0)
            h_k = tt.hash_board(b.board, b.stm, b.ep, b.castling)
            h_p = tt.hash_board_plain(b.board, b.stm, b.ep, b.castling, *tt.tables(dev))
            checks["zobrist_hash"] = (h_k, h_p, 0.0)
            torch.cuda.synchronize()
            for name, (got, want, limit) in checks.items():
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"{name} B={B} {net}: {got.shape}/{got.dtype} "
                                         f"vs plain {want.shape}/{want.dtype}")
                err = float((got.double() - want.double()).abs().max())
                log(f"check {name} B={B} net={net}: max_abs_err={err} (tolerance {limit})")
                if not err <= limit:
                    raise AssertionError(f"{name} B={B} {net}: error {err} > {limit}")
                stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            if B != 1024 or net != "f32":
                continue

            # times at the main path's largest batch, f32 net
            l1 = p.l1
            row_bytes = l1 * p.ft_w.element_size()
            acc_bytes = B * 2 * l1 * 4
            # the head weights of the buckets this batch uses
            head = int(bucket.unique().numel()) * sum(
                t[0].numel() * t.element_size() for t in p[2:])
            feats = nnue.feature_index_768(b.board, torch.arange(64, device=dev, dtype=torch.int32), 0)
            feats = torch.stack([feats, nnue.feature_index_768(
                b.board, torch.arange(64, device=dev, dtype=torch.int32), 1)], 1)  # (B, 2, 64)
            flat = feats.flatten()
            keep = flat >= 0
            bag_idx = flat[keep].long()
            bag_off = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                                 keep.view(B * 2, 64).sum(1).cumsum(0)[:-1]])
            upd_idx = torch.stack([nnue.feature_index_768(codes, sqs, q) for q in (0, 1)], 1)
            live = (upd_idx >= 0).flatten()
            u_idx = upd_idx.flatten()[live].long()
            u_w = signs[:, None, :].expand(B, 2, 4).flatten()[live].float()
            u_off = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                               (upd_idx >= 0).view(B * 2, 4).sum(1).cumsum(0)[:-1]])
            n_upd = int(live.sum())
            stm, ep, cast = b.stm.contiguous(), b.ep.contiguous(), b.castling.contiguous()
            z1, z2 = tt.tables(dev)
            table = {
                "nnue_refresh_768": (
                    lambda: nnue.accumulators_768(p, b.board),
                    lambda: nnue.accumulators_768_plain(p, b.board),
                    lambda: F.embedding_bag(bag_idx, p.ft_w, bag_off, mode="sum") + p.ft_b,
                    B * 256 + int(bag_idx.unique().numel()) * row_bytes + l1 * 4 + acc_bytes,
                    2 * pieces * l1 + 2 * B * l1,
                ),
                "nnue_forward_from_acc": (
                    lambda: nnue.forward_from_acc(p, acc_p, b.stm, bucket),
                    lambda: nnue.forward_from_acc_plain(p, acc_p, b.stm, bucket),
                    None,
                    acc_bytes + B * 8 + head + B * 4,
                    B * 2 * (128 * 16 + 16 * 32 + 32),
                ),
                "nnue_acc_update_768": (
                    lambda: nnue.apply_acc_updates_768(p, acc_p, codes, sqs, signs),
                    lambda: nnue.apply_acc_updates_768_plain(p, acc_p, codes, sqs, signs),
                    lambda: acc_p + F.embedding_bag(
                        u_idx, p.ft_w, u_off, mode="sum", per_sample_weights=u_w
                    ).view(B, 2, l1),
                    2 * acc_bytes + B * 48 + int(u_idx.unique().numel()) * row_bytes,
                    n_upd * l1 + B * 2 * l1,
                ),
                "zobrist_hash": (
                    lambda: tt.hash_board(b.board, stm, ep, cast),
                    lambda: tt.hash_board_plain(b.board, stm, ep, cast, z1, z2),
                    None,
                    # of each table, the piece-square, ep, castling and stm keys
                    B * (256 + 4 + 4 + 16) + 2 * (tt._STM_OFF + 2) * 4 + B * 8,
                    2 * B * (int(pieces / B) + 6),
                ),
            }
            for name, (kern, plain, lib, nbytes, nops) in table.items():
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = nops / F32_OPS_PER_S * 1e3
                (ms, call_ms), (plain_ms, plain_call) = time_ms(kern, reps), time_ms(plain, reps)
                lib_ms, lib_call = (None, None) if lib is None else time_ms(lib, reps)
                stats[name].update(
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                )
                log(f"time {name} B={B} f32 (device ms / call ms): kernel {ms:.5f} / "
                    f"{call_ms:.5f}, plain {plain_ms:.5f} / {plain_call:.5f}, library "
                    f"{lib_ms} / {lib_call}, bound {stats[name]['bound_ms']:.6f} "
                    f"({stats[name]['bound_by']})")
    return stats


K2_EDGE_LANES = (1, 16, 64, 1024)


def k2_edge_phase(params_f32, reps: int) -> dict:
    """K2 (one warp a lane) on k2_case's accumulators at the clip edges,
    every output bucket, at K2_EDGE_LANES lanes on the f32, int8 and bf16
    nets: against its plain version (f32 and bf16 within F32_EVAL_TOL,
    int8 exactly), the bf16 entry also against the f32 kernel on the
    widened weights (bit difference 0). Times at 64 and 1024 lanes on
    each net, with the bound from the bytes each call must move (the pair,
    stm and bucket in, the head weights of the buckets it uses, the evals
    out). → {"max_abs_err", "edge_ms": {net: {lanes: ms}}, "edge_bound_ms"}."""
    import torch

    from fishnet_tpu_torch.models import nnue

    dev = torch.device("cuda")
    p16 = nnue.cast_params(params_f32)
    nets = {"f32": params_f32, "int8": nnue.quantize_int8(params_f32), "bf16": p16}
    wide = nnue.widened(p16)
    out = {"max_abs_err": 0.0, "edge_ms": {}, "edge_bound_ms": {}}
    for B in K2_EDGE_LANES:
        for net, p in nets.items():
            acc, stm, bucket = k2_inputs(B, B, "int8" if net == "int8" else "f32", dev)
            got = nnue.forward_from_acc(p, acc, stm, bucket)
            want = nnue.forward_from_acc_plain(p, acc, stm, bucket)
            tol = 0.0 if net == "int8" else nnue.F32_EVAL_TOL
            bits = _bit_diff(got, nnue.forward_from_acc(wide, acc, stm, bucket)) \
                if net == "bf16" else 0
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            log(f"check nnue_forward_from_acc B={B} {net} at the clip edges, buckets "
                f"{sorted(set(bucket.tolist()))}: max_abs_err={err} (tolerance {tol})"
                + (f"; bit difference {bits} against the f32 kernel on the widened weights"
                   if net == "bf16" else ""))
            if not err <= tol or bits != 0 or got.shape != want.shape:
                raise AssertionError(f"K2 B={B} {net} at the clip edges: error {err} > {tol} "
                                     f"or bits {bits}")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            if B not in (64, 1024):
                continue
            head = int(bucket.unique().numel()) * sum(
                t[0].numel() * t.element_size() for t in p[2:])
            nbytes = acc.numel() * acc.element_size() + B * 8 + head + B * 4
            ms = time_ms(lambda: nnue.forward_from_acc(p, acc, stm, bucket), reps)[0]
            out["edge_ms"].setdefault(net, {})[B] = ms
            out["edge_bound_ms"].setdefault(net, {})[B] = nbytes / HBM_BYTES_PER_S * 1e3
            log(f"time nnue_forward_from_acc B={B} {net} (device ms): kernel {ms:.5f}, bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} (bytes, {nbytes} bytes)")
    return out


def sf_case(l1: int, seed: int) -> dict:
    """A seeded quantized HalfKAv2_hm net of width l1 in the `.nnue`
    writer's layout (models/nnue_import.py write_nnue), scaled so that
    accumulators spread over the clipped range and evals stay within a few
    thousand centipawns: ft_b ~U[-20, 140), ft_w ~N(0, 12), psqt ~N(0,
    500), fc0_w ~N(0, 400/sqrt(l1)), fc1_w ~N(0, 20), fc2_w ~N(0, 30),
    biases ~N(0, 2000). → dict of numpy arrays."""
    import numpy as np

    from fishnet_tpu_torch.models import nnue_import as ni

    rng = np.random.default_rng(seed)

    def normal(std, shape, dtype, lim):
        return np.clip(np.round(rng.normal(0.0, std, shape)), -lim, lim).astype(dtype)

    nf = ni.NUM_FEATURES
    return {
        "ft_b": rng.integers(-20, 140, l1).astype(np.int16),
        "ft_w": normal(12.0, (nf, l1), np.int16, 127),
        "psqt": normal(500.0, (nf, 8), np.int32, 2**20),
        "fc0_b": normal(2000.0, (8, ni.FC0_OUT), np.int32, 2**20),
        "fc0_w": normal(max(1.0, 400.0 / l1 ** 0.5), (8, ni.FC0_OUT, l1), np.int8, 127),
        "fc1_b": normal(2000.0, (8, ni.FC1_OUT), np.int32, 2**20),
        "fc1_w": normal(20.0, (8, ni.FC1_OUT, ni.FC1_IN), np.int8, 127),
        "fc2_b": normal(2000.0, (8, 1), np.int32, 2**20),
        "fc2_w": normal(30.0, (8, 1, ni.FC1_OUT), np.int8, 127),
        "description": f"chip_smoke seeded net L1={l1} seed={seed}".encode(),
    }


def tt_case(B: int, size_log2: int, seed: int, n_slots: int = 0) -> dict:
    """A seeded table of 2**size_log2 slots (30% empty, in-range meta,
    generations 0-2) and B lanes of probe/store inputs; half the lanes'
    second keys match the row in their slot, most of those at its depth,
    so probes hit with every flag; some scores are in the mate range,
    which is never stored. n_slots: if set, every lane's key falls on one
    of that many slots (its high bits still differ). → dict of int32/bool
    numpy arrays."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = 1 << size_log2
    meta = (((rng.integers(-600, 600, n) + 32768) << 10) | (rng.integers(0, 10, n) << 2)
            | rng.integers(0, 3, n))
    table = np.stack([rng.integers(-2**31, 2**31, n, dtype=np.int64), meta,
                      rng.integers(-1, 4096, n), rng.integers(0, 3, n)], 1).astype(np.int32)
    table[rng.random(n) < 0.3] = 0
    h1 = rng.integers(-2**31, 2**31, B, dtype=np.int64).astype(np.int32)
    if n_slots:
        slots = rng.choice(n, n_slots, replace=False)
        h1 = ((h1 & ~np.int32(n - 1)) | slots[rng.integers(0, n_slots, B)]).astype(np.int32)
    h2 = rng.integers(-2**31, 2**31, B, dtype=np.int64).astype(np.int32)
    hit = rng.random(B) < 0.5
    rows = table[h1 & (n - 1)]
    h2 = np.where(hit, rows[:, 0] ^ rows[:, 1] ^ rows[:, 2], h2).astype(np.int32)
    depth_left = np.where(hit & (rng.random(B) < 0.7),
                          ((rows[:, 1] >> 2) & 0xFF) - rng.integers(0, 2, B),
                          rng.integers(-2, 10, B)).astype(np.int32)
    alpha = rng.integers(-700, 700, B).astype(np.int32)
    return dict(
        table=table, h1=h1, h2=h2, depth_left=depth_left, alpha=alpha,
        beta=(alpha + rng.integers(1, 400, B)).astype(np.int32),
        enter=rng.random(B) < 0.8,
        score=rng.integers(-31500, 31500, B).astype(np.int32),
        depth=rng.integers(0, 10, B).astype(np.int32),
        flag=rng.integers(0, 3, B).astype(np.int32),
        move=rng.integers(-1, 4096, B).astype(np.int32),
        mask=rng.random(B) < 0.8,
    )


def tt_inputs(B: int, size_log2: int, seed: int, dev, n_slots: int = 0) -> dict:
    """tt_case as tensors on dev."""
    import torch

    return {k: torch.from_numpy(v).to(dev)
            for k, v in tt_case(B, size_log2, seed, n_slots).items()}


TT_PROBE_ARGS = ("h1", "h2", "depth_left", "alpha", "beta", "enter")
TT_STORE_ARGS = ("h1", "h2", "score", "depth", "flag", "move", "mask")


def tt_runner_layout(c: dict) -> tuple:
    """The inputs as the TT runner passes them (ops/search.py _tt_step):
    the keys as the two columns of the (B, 2) hash output, the window,
    depth and entry values as columns of a wider lane table, and the leaf
    store's depth, flag and move as stride-0 broadcasts of scalars.
    → (probe args, interior store args, leaf store args)."""
    import torch

    B = c["h1"].shape[0]
    keys = torch.stack([c["h1"], c["h2"]], 1)
    lane = torch.stack([c[k] for k in ("depth_left", "alpha", "beta", "score", "depth",
                                       "flag", "move")] + [torch.zeros_like(c["h1"])], 1)
    dl, alpha, beta, score, depth, flag, move = lane.unbind(1)[:7]
    scalar = torch.zeros((), dtype=torch.int32, device=c["h1"].device)
    return ((keys[:, 0], keys[:, 1], dl, alpha, beta, c["enter"]),
            (keys[:, 0], keys[:, 1], score, depth, flag, move, c["mask"]),
            (keys[:, 0], keys[:, 1], score, scalar.expand(B), scalar.expand(B),
             (scalar - 1).expand(B), c["mask"]))


def probe_bytes(table, h1, h2, depth_left, alpha, beta, enter, deep_bounds: bool) -> int:
    """The bytes K5's function must move on these inputs: h1 and enter of
    every lane; the row of every distinct slot (score is an output of
    every lane); h2 of the entering lanes; depth_left of the valid
    entering lanes and, where the row is deep enough and a bound, the one
    of alpha and beta its flag compares; usable, score and order_move
    out (1 + 4 + 4 bytes a lane)."""
    from fishnet_tpu_torch.ops import tt

    B = h1.shape[0]
    rows = table[tt._slots(table, h1)]
    valid = enter & ((rows[:, 0] ^ rows[:, 1] ^ rows[:, 2]) == h2) & (rows[:, 1] != 0)
    _, depth, flag = tt.unpack_meta(rows[:, 1])
    dl = depth_left.clamp(min=0)
    deep = valid & ((depth >= dl) if deep_bounds else (depth == dl))
    n_bound = int((deep & (flag != tt.FLAG_EXACT)).sum())
    n_rows = int(tt._slots(table, h1).unique().numel())
    return (B * (4 + 1) + n_rows * 16 + int(enter.sum()) * 4 + int(valid.sum()) * 4
            + n_bound * 4 + B * 9)


def store_bytes(table, h1, h2, score, depth, flag, move, mask, prefer_deep: bool,
                gen) -> int:
    """The bytes K6's function must move on these inputs and this table:
    the mask of every lane; the score of the masked lanes; h1 of the
    storable ones (masked, not mate-range) and, with prefer_deep, their
    depth, their generation where it is per lane, and the old row of
    each distinct slot they hit; of the winning lanes (the highest lane
    of each slot still storing), h2, flag and move (and depth, and a
    per-lane generation, without prefer_deep) in and the row written."""
    import torch

    from fishnet_tpu_torch.ops import tt

    slot = tt._slots(table, h1)
    storable = mask & (score.abs() <= tt._MAX_STORE)
    n_masked, n_storable = int(mask.sum()), int(storable.sum())
    nbytes = mask.shape[0] + n_masked * 4 + n_storable * 4
    if prefer_deep:
        gen_t = torch.as_tensor(0 if gen is None else gen, dtype=torch.int32,
                                device=table.device).expand(slot.shape[0])
        old = table[slot]
        keep = ((old[:, 1] != 0) & (old[:, 3] == gen_t)
                & (tt.unpack_meta(old[:, 1])[1] > depth))
        nbytes += n_storable * 4 + int(slot[storable].unique().numel()) * 16
        if torch.is_tensor(gen):
            nbytes += n_storable * 4
        storable = storable & ~keep
    elif torch.is_tensor(gen):
        nbytes += int(slot[storable].unique().numel()) * 4
    n_win = int(slot[storable].unique().numel())
    return nbytes + n_win * ((3 if prefer_deep else 4) * 4 + 16)


# K5's and K6's checked cases: (lanes, log2 of the table's slots, the
# slots every lane's key falls on or 0 for spread keys)
TT_CASES = ((16, 3, 0), (16, 21, 0), (64, 21, 0), (1024, 6, 0), (1024, 21, 0), (1024, 6, 4),
            (1024, 21, 4), (8192, 6, 0), (8192, 21, 0), (8192, 6, 4), (8192, 21, 4))


def tt_kernel_phase(reps: int) -> dict:
    """K5 and K6 against their plain versions on the card (TT_CASES): at
    B = 16, 64 (the engine's dispatch width), 1024 and 8192 into small
    tables (forced collisions: 1024 lanes into 64 slots) and into the
    main path's 2^21-slot table, and with every lane on one of four slots,
    K5 with deep_bounds off and on, K6 plain and prefer_deep (one
    generation, and mixed per-lane ones against the table's mixed
    generations); each also with the runner's strided and broadcast
    inputs. Returns per-kernel stats (times at B = 1024 into 2^21 slots,
    the engine's prefer_deep store)."""
    import torch

    from fishnet_tpu_torch.ops import tt

    dev = torch.device("cuda")
    stats = {k: {"max_abs_err": 0.0} for k in ("tt_probe", "tt_store")}

    def check(name, label, got, want):
        err = max(float((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        if err != 0:
            raise AssertionError(f"{name} {label}: max_abs_err {err}")
        return err

    for B, size_log2, n_slots in TT_CASES:
        c = tt_inputs(B, size_log2, seed=B + size_log2 + n_slots, dev=dev, n_slots=n_slots)
        on = f" on {n_slots} slots" if n_slots else ""
        runner_probe, runner_store, runner_leaf = tt_runner_layout(c)
        for deep in (False, True):
            for layout, args in (("contiguous", [c[k] for k in TT_PROBE_ARGS]),
                                 ("runner", runner_probe)):
                got = tt.probe(c["table"], *args, deep_bounds=deep)
                want = tt.probe_plain(c["table"], *args, deep_bounds=deep)
                torch.cuda.synchronize()
                label = f"B={B} slots=2^{size_log2}{on} deep_bounds={deep} {layout}"
                err = check("tt_probe", label, got, want)
                log(f"check tt_probe {label}: max_abs_err={err} (tolerance 0; usable "
                    f"{int(want[0].sum())}/{B})")
        gen_lanes = torch.randint(0, 3, (B,), dtype=torch.int32, device=dev)
        for prefer, gen in ((False, None), (True, 1), (True, gen_lanes)):
            for layout, args in (("contiguous", [c[k] for k in TT_STORE_ARGS]),
                                 ("runner", runner_store), ("runner leaf", runner_leaf)):
                got, want = c["table"].clone(), c["table"].clone()
                tt.store(got, *args, prefer_deep=prefer, gen=gen)
                tt.store_plain(want, *args, prefer_deep=prefer, gen=gen)
                torch.cuda.synchronize()
                label = (f"B={B} slots=2^{size_log2}{on} prefer_deep={prefer} "
                         f"gen={'lanes' if torch.is_tensor(gen) else gen} {layout}")
                err = check("tt_store", label, [got], [want])
                changed = int((want != c["table"]).any(1).sum())
                log(f"check tt_store {label}: max_abs_err={err} (tolerance 0; rows "
                    f"written {changed})")
        if (B, size_log2, n_slots) != (1024, 21, 0):
            continue

        # times at the main path's table size and the widest batch
        table = c["table"]
        slot = tt._slots(table, c["h1"])
        probe_args = [c[k] for k in TT_PROBE_ARGS]
        store_args = [c[k] for k in TT_STORE_ARGS]
        meta = tt.pack_meta(c["score"], c["depth"], c["flag"])
        rows = torch.stack([c["h2"] ^ meta ^ c["move"], meta, c["move"],
                            torch.ones_like(meta)], 1)
        table_k = table.clone()
        table_p = table.clone()
        table_l = table.clone()
        # the repeated store reaches its fixed point after one call (the
        # rows it writes are the ones it keeps); count the bytes there
        tt.store(table_k, *store_args, prefer_deep=True, gen=1)
        timed = {
            "tt_probe": (
                lambda: tt.probe(table, *probe_args),
                lambda: tt.probe_plain(table, *probe_args),
                lambda: table.index_select(0, slot),
                probe_bytes(table, *probe_args, deep_bounds=False),
                B * 16,
            ),
            "tt_store": (
                lambda: tt.store(table_k, *store_args, prefer_deep=True, gen=1),
                lambda: tt.store_plain(table_p, *store_args, prefer_deep=True, gen=1),
                lambda: table_l.index_put_((slot,), rows),
                store_bytes(table_k, *store_args, prefer_deep=True, gen=1),
                B * 12,
            ),
        }
        for name, (kern, plain, lib, nbytes, nops) in timed.items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / F32_OPS_PER_S * 1e3
            (ms, call_ms), (plain_ms, plain_call) = time_ms(kern, reps), time_ms(plain, reps)
            lib_ms, lib_call = time_ms(lib, reps)
            stats[name].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
            )
            log(f"time {name} B={B} slots=2^{size_log2} (device ms / call ms): kernel "
                f"{ms:.5f} / {call_ms:.5f}, plain {plain_ms:.5f} / {plain_call:.5f}, "
                f"library {lib_ms:.5f} / {lib_call:.5f}, bound {stats[name]['bound_ms']:.6f} "
                f"({stats[name]['bound_by']}, {nbytes} bytes)")
    return stats


def lane_init_case(params, B: int, n: int, seed: int, dev, max_moves: int):
    """A (B)-lane state of seeded garbage on dev (so untouched lanes show),
    its move lists max_moves wide, and K7's inputs for n scattered lanes
    of it (all B when n == B): playout roots, K1's accumulators, seeded
    depths, budgets, windows, jitters (zero, large and negative), groups
    and history seeds. → (state, lane_idx, args)."""
    import numpy as np
    import torch

    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import search

    rng = np.random.default_rng(seed)
    P = 32
    adt = nnue.acc_dtype(params)
    shapes = [(B, P + 1, search.BT_W), (B, P + 1, search.NT_W), (B, search.LN_W),
              (B, search.MAX_HIST, 2), (B, search.MAX_HIST), (B, P, max_moves),
              (B, 4096), (B, P, P)]
    state = [torch.from_numpy(rng.integers(-2**31, 2**31, s, dtype=np.int64).astype(np.int32))
             for s in shapes]
    acc = torch.from_numpy(rng.standard_normal((B, P + 1, 2, params.l1)).astype(np.float32))
    state.append(acc if adt == torch.float32 else acc.to(torch.int32))
    state = search.SearchState(*[t.to(dev) for t in state])
    idx = np.arange(B) if n == B else np.sort(rng.permutation(B)[:n])
    roots, _ = playout_boards(n, seed=seed)

    def col(lo, hi):
        return torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(dev)

    jitter = col(-2**31, 2**31)
    jitter[::3] = 0
    hh = rng.integers(-2**31, 2**31, (n, search.MAX_HIST, 2), dtype=np.int64).astype(np.int32)
    hm = rng.integers(-32000, 100, (n, search.MAX_HIST)).astype(np.int32)
    args = search._lane_inputs(
        params, roots.to(dev), col(0, 12), col(0, 2**31 - 1), torch.from_numpy(hh).to(dev),
        torch.from_numpy(hm).to(dev), col(-32500, 0), col(0, 32501), jitter, col(0, B))
    return state, torch.from_numpy(idx).to(dev), args


def lane_init_bytes(state, lane_idx, args) -> int:
    """The bytes K7's function must move: each listed lane's whole slice
    of the nine tables written once; its index, root row, root
    accumulators, six scalars and history seeds read once."""
    n = lane_idx.shape[0]
    written = sum(t[0].numel() * t.element_size() for t in state) * n
    read = lane_idx.numel() * 8 + sum(t.numel() * t.element_size() for t in args)
    return written + read


def lane_init_phase(reps: int) -> dict:
    """K7 against its plain version on the card at B = 16, 64 (the
    engine's width) and 1024, over every lane (init_state's call) and
    over a scattered quarter (a refill splice), on both nets: every table
    equal bit for bit, the lanes not listed untouched. Times at B = 1024,
    every lane, f32 net; the library call is the nine index_copy_ of a
    prebuilt fresh state's rows. Then crazyhouse's width (MAX_MOVES_ZH
    move lists) at B = 64, checked the same way and timed, under
    "variants"."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import movegen as tm
    from fishnet_tpu_torch.ops import search

    dev = torch.device("cuda")
    params_f32 = nnue.load_params(device=dev)
    stats = {"max_abs_err": 0.0}
    zh = {"max_abs_err": 0.0}

    def check(row, params, net, B, n, width):
        state, idx, args = lane_init_case(params, B, n, seed=B + n, dev=dev, max_moves=width)
        want = search.SearchState(*[t.clone() for t in state])
        kernels.lane_init(state, idx, *args)
        search.lane_init_plain(want, idx, *args)
        torch.cuda.synchronize()
        err = 0.0
        for name, g, w in zip(search.SearchState._fields, state, want):
            if g.dtype == torch.float32:  # compared as bits
                g, w = g.view(torch.int32), w.view(torch.int32)
            err = max(err, float((g.long() - w.long()).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"lane_init B={B} n={n} {net} width {width}: {name} "
                                     f"differs")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        log(f"check lane_init B={B} lanes={n} net={net} move lists {width}: max_abs_err={err} "
            f"(tolerance 0, {lane_init_bytes(state, idx, args)} bytes)")

    for net, params in (("f32", params_f32), ("int8", nnue.quantize_int8(params_f32))):
        for B in (16, 64, 1024):
            for n in (B, B // 4):
                check(stats, params, net, B, n, tm.MAX_MOVES)
        for n in (64, 16):
            check(zh, params, net, 64, n, tm.MAX_MOVES_ZH)

    # crazyhouse's width at the engine's 64 lanes, every lane, f32 net
    B = 64
    state, idx, args = lane_init_case(params_f32, B, B, seed=1, dev=dev,
                                      max_moves=tm.MAX_MOVES_ZH)
    plain_state = search.SearchState(*[t.clone() for t in state])
    nbytes = lane_init_bytes(state, idx, args)
    (ms, call_ms), (plain_ms, _) = [time_ms(f, reps) for f in (
        lambda: kernels.lane_init(state, idx, *args),
        lambda: search.lane_init_plain(plain_state, idx, *args))]
    zh.update(ms=ms, plain_ms=plain_ms, library_ms=None,
              bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    log(f"time lane_init B={B} lanes={B} f32 move lists {tm.MAX_MOVES_ZH} (device ms / call "
        f"ms): kernel {ms:.5f} / {call_ms:.5f}, plain {plain_ms:.5f}, bound "
        f"{zh['bound_ms']:.6f} (bytes, {nbytes} bytes)")
    stats["variants"] = {"crazyhouse": zh}

    # times at the widest batch, every lane, f32 net
    B = 1024
    state, idx, args = lane_init_case(params_f32, B, B, seed=1, dev=dev, max_moves=tm.MAX_MOVES)
    plain_state = search.SearchState(*[t.clone() for t in state])
    lib_state = search.SearchState(*[t.clone() for t in state])
    fresh = search._fresh_state(*args, 32, tm.MAX_MOVES)
    nbytes = lane_init_bytes(state, idx, args)
    timed = (
        lambda: kernels.lane_init(state, idx, *args),
        lambda: search.lane_init_plain(plain_state, idx, *args),
        lambda: [t.index_copy_(0, idx, f) for t, f in zip(lib_state, fresh)],
    )
    (ms, call_ms), (plain_ms, plain_call), (lib_ms, lib_call) = [time_ms(f, reps) for f in timed]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    stats.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=t_bytes,
                 bound_by="bytes")
    log(f"time lane_init B={B} lanes={B} f32 (device ms / call ms): kernel {ms:.5f} / "
        f"{call_ms:.5f}, plain {plain_ms:.5f} / {plain_call:.5f}, library {lib_ms:.5f} / "
        f"{lib_call:.5f}, bound {t_bytes:.6f} (bytes, {nbytes} bytes)")
    # the engine's width, for PERF.md
    state, idx, args = lane_init_case(params_f32, 64, 64, seed=2, dev=dev, max_moves=tm.MAX_MOVES)
    ms64, call64 = time_ms(lambda: kernels.lane_init(state, idx, *args), reps)
    nb64 = lane_init_bytes(state, idx, args)
    log(f"time lane_init B=64 lanes=64 f32 (device ms / call ms): kernel {ms64:.5f} / "
        f"{call64:.5f}, bound {nb64 / HBM_BYTES_PER_S * 1e3:.6f} (bytes, {nb64} bytes)")
    return {"lane_init": stats}


# K8-K10's fixed positions (chess960?, FEN): tactical middlegames, both
# sides' promotions (pushes and captures), en passant, positions in check,
# standard castling both ways and chess960 starts (castling paths through
# the rook's square, partly attacked); rules_case adds playouts from them
RULES_FENS = [
    (False, "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1"),
    (False, "r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1"),
    (False, "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1"),
    (False, "r3k2r/8/8/8/8/8/8/R3K2R w KQkq - 0 1"),
    (False, "r3k2r/8/8/8/8/8/8/R3K2R b KQkq - 0 1"),
    (False, "r3k2r/8/8/8/8/8/5q2/R3K2R w KQkq - 0 1"),
    (False, "rnbqkbnr/ppp1p1pp/8/3pPp2/8/8/PPPP1PPP/RNBQKBNR w KQkq f6 0 3"),
    (False, "rnbqkbnr/pppp1ppp/8/8/3Pp3/5N2/PPP1PPPP/RNBQKB1R b KQkq d3 0 3"),
    (False, "1r2k3/P1P5/8/8/8/8/1p1p4/R3K1N1 w Q - 0 1"),
    (False, "1r2k3/P1P5/8/8/8/8/1p1p4/R1N4K b - - 0 1"),
    (False, "4k3/8/8/1b6/8/8/8/R3K2R w KQ - 0 1"),
    (False, "4k3/8/8/8/8/8/4q3/4K3 w - - 0 1"),
    (True, "bqnb1rkr/pp3ppp/3ppn2/2p5/5P2/P2P4/NPP1P1PP/BQ1BNRKR w HFhf - 2 9"),
    (True, "b1q1rrkb/pppppppp/3nn3/8/P7/1PPP4/4PPPP/BQNNRKRB w GE - 1 9"),
    (True, "1rk1r3/8/8/8/8/8/8/1RK1R3 w EBeb - 0 1"),
]


def rules_case(B: int, seed: int) -> dict:
    """B seeded positions for K8-K10: RULES_FENS, random playouts from
    them (a quarter of the lanes; chess960 rules where the start is one),
    then playout_positions, with seeded killers and history counters
    (positions_case)."""
    from fishnet_tpu_torch.chess import Chess960Position, Position

    rng = random.Random(seed)
    starts = [(Chess960Position if c960 else Position).from_fen(f) for c960, f in RULES_FENS]
    positions = starts[:B]
    pos = None
    while len(positions) < min(B, len(starts) + B // 4):
        legal = [] if pos is None else pos.legal_moves()
        if not legal or pos.halfmove >= 90 or rng.random() < 0.04:
            pos = rng.choice(starts)
            continue
        pos = pos.push(rng.choice(legal))
        positions.append(pos)
    positions += playout_positions(B - len(positions), seed)[0]
    return positions_case(positions, seed)


def positions_case(positions, seed: int) -> dict:
    """Host positions for K8-K10 with seeded killers (two pseudo-legal
    moves or -1) and history counters → dict of int32 numpy arrays: the
    Board fields (board (B, 64), stm, ep, halfmove (B,), castling (B, 4),
    extra (B, 12)), killers (B, 2), hist (B, 4096)."""
    import numpy as np

    from fishnet_tpu_torch.ops.board import Board, from_position

    B = len(positions)
    nrng = np.random.default_rng(seed)
    killers = np.full((B, 2), -1, np.int32)
    for lane, p in enumerate(positions):
        moves = [encode(m) for m in p.generate_pseudo_legal()]
        for k in range(2):
            if moves and nrng.random() < 0.75:
                killers[lane, k] = moves[nrng.integers(len(moves))]
    boards = [from_position(p) for p in positions]
    case = {f: np.concatenate([getattr(b, f).numpy() for b in boards]).astype(np.int32)
            for f in Board._fields}
    case["killers"] = killers
    case["hist"] = nrng.integers(-64, 1 << 13, (B, 4096)).astype(np.int32)
    return case


# K9's long and tied lists, for the branches of its sort (csrc/movegen.cuh):
# exactly 64 and 65 moves (the last list sorted in registers, the first
# merged in shared memory), the 218-move position, crazyhouse lists of 299
# and 435 moves, a castling right without its rook (its castle and the king
# step encode alike: equal packed values once both are killers), antichess
# with and without a capture, and every key class (captures and capture
# promotions, quiet queen promotions, castling, killers, history, quiet
# moves; drops in the crazyhouse lists) → (label, variant, FEN)
MOVEGEN_LONG = (
    ("64 moves", "standard", "4Q3/5P1B/7B/6P1/1Q6/n5K1/8/k6N w - - 13 87"),
    ("65 moves", "standard", "4Q3/1P5B/7B/6P1/1Q6/n5K1/8/k6N w - - 13 87"),
    ("218 moves", "standard", "R6R/3Q4/1Q4Q1/4Q3/2Q4Q/Q4Q2/pp1Q4/kBNN1KB1 w - - 0 1"),
    ("key classes", "standard", "r3k2r/1P6/8/8/3p4/4P3/8/R3K2R w KQkq - 0 1"),
    ("castling right without its rook", "standard", "4k3/8/8/8/8/8/8/5K2 w - - 0 1"),
    ("antichess, a capture", "antichess",
     "rnbqkbnr/ppp1pppp/8/3p4/4P3/8/PPPP1PPP/RNBQKBNR w - - 0 2"),
    ("antichess, no capture", "antichess",
     "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w - - 0 1"),
    ("crazyhouse, 299 moves", "crazyhouse", "7k/8/8/8/8/8/8/K7[QRBNPqrbnp] w - - 0 30"),
    ("crazyhouse, 435 moves", "crazyhouse",
     "R6R/3Q4/1Q4Q1/4Q3/2Q4Q/Q4Q2/pp1Q4/kBNN1KB1[QQQQRRBBNNPPPP] w - - 0 1"),
)


def movegen_long_case(variant: str) -> tuple:
    """MOVEGEN_LONG's fixtures of one device variant → (labels, a
    positions_case dict): history counters whose bonuses span 0-99 and
    its clamps, and as killers the moves a third and all the way down the
    unordered list (in crazyhouse the last is a drop); "key classes"
    takes its e1h1 castle and b7b8=Q as killers, and "castling right
    without its rook" gets the g1 right back with f1g1 (king step and
    castle alike) as a killer."""
    import numpy as np
    import torch

    from fishnet_tpu_torch.chess import from_fen
    from fishnet_tpu_torch.ops import movegen as tm
    from fishnet_tpu_torch.ops import tables as T
    from fishnet_tpu_torch.ops.board import Board

    rows = [(label, fen) for label, v, fen in MOVEGEN_LONG if v == variant]
    case = positions_case([from_fen(fen, variant) for _, fen in rows], seed=17)
    rng = np.random.default_rng(17)
    case["hist"] = rng.integers(-64, 3300, case["hist"].shape).astype(np.int32)
    for lane, (label, _) in enumerate(rows):
        if label == "castling right without its rook":
            case["castling"][lane, 0] = 6
    b = Board(*[torch.from_numpy(case[f]) for f in Board._fields])
    moves, count, _ = tm.generate_moves_plain(b, variant=variant)
    for lane, (label, _) in enumerate(rows):
        n = int(count[lane])
        case["killers"][lane] = [int(moves[lane, n // 3]), int(moves[lane, n - 1])]
        if label == "key classes":
            case["killers"][lane] = [4 | (7 << 6), 49 | (57 << 6) | (T.PROMO_Q << 12)]
        if label == "castling right without its rook":
            case["killers"][lane] = [5 | (6 << 6), -1]
    return [label for label, _ in rows], case


def movegen_long_inputs(variant: str, dev):
    """movegen_long_case on dev → (labels, Board, killers, hist)."""
    import torch

    from fishnet_tpu_torch.ops.board import Board

    labels, case = movegen_long_case(variant)
    c = {k: torch.from_numpy(v).to(dev) for k, v in case.items()}
    return labels, Board(*[c[f] for f in Board._fields]), c["killers"], c["hist"]


# K2's inputs at the clip edges: each accumulator column one of these
# values (f32, for the f32 and bf16 nets: around crelu's 0 and 1; int8:
# around [0, QA]) or a seeded value inside the range
K2_EDGES = {"f32": (-0.5, -1e-7, 0.0, 1e-7, 0.5, 1.0 - 6e-8, 1.0, 1.0 + 1.2e-7, 2.0),
            "int8": (-300, -1, 0, 1, 63, 64, 126, 127, 128, 4000)}


def k2_case(B: int, seed: int, kind: str) -> dict:
    """B lanes of K2's inputs (numpy): acc (B, 2, 64) (f32 for kind
    "f32", int32 for "int8"), half its columns K2_EDGES[kind] and half
    inside the clip range, stm (B,) seeded, bucket (B,) lane % 8, so every
    output bucket runs from 8 lanes on."""
    import numpy as np

    rng = np.random.default_rng(seed)
    edges = np.asarray(K2_EDGES[kind], np.float32 if kind == "f32" else np.int32)
    acc = edges[rng.integers(len(edges), size=(B, 2, 64))]
    inner = (rng.random((B, 2, 64)).astype(np.float32) if kind == "f32"
             else rng.integers(0, 128, (B, 2, 64)).astype(np.int32))
    acc = np.where(rng.random((B, 2, 64)) < 0.5, inner, acc)
    return {"acc": acc, "stm": rng.integers(0, 2, B).astype(np.int32),
            "bucket": (np.arange(B) % 8).astype(np.int32)}


def k2_inputs(B: int, seed: int, kind: str, dev) -> tuple:
    """k2_case on dev → (acc, stm, bucket)."""
    import torch

    c = k2_case(B, seed, kind)
    return tuple(torch.from_numpy(c[k]).to(dev) for k in ("acc", "stm", "bucket"))


def rules_inputs(B: int, seed: int, dev, variant: str = "standard", fens=None):
    """B seeded positions for K4 and K8-K10 on dev → (Board, killers,
    hist): rules_case's in standard chess, else variant_positions' (its
    FENs `fens` where given) with positions_case's killers and history
    counters."""
    import torch

    from fishnet_tpu_torch.ops.board import Board

    if variant == "standard":
        case = rules_case(B, seed)
    else:
        case = positions_case([p for p, _, _ in variant_positions(variant, B, seed, fens)], seed)
    c = {k: torch.from_numpy(v).to(dev) for k, v in case.items()}
    return Board(*[c[f] for f in Board._fields]), c["killers"], c["hist"]


def every_move(b, moves, count):
    """Each lane's board repeated once per generated move → (boards, moves)."""
    import torch

    lane = torch.arange(moves.shape[0], device=moves.device)[:, None].expand_as(moves)
    live = torch.arange(moves.shape[1], device=moves.device)[None] < count[:, None]
    idx = lane[live]
    return type(b)(*[t[idx] for t in b]), moves[live].contiguous()


def rules_kernel_phase(reps: int, variant: str = "standard") -> dict:
    """K4 and K8-K10 in one device variant against their plain versions on
    the card at B = 16, 64 (the engine's width) and 1024 on rules_inputs'
    positions: K9 with and without the killers and history, K10 over every
    generated move from packed rows (as the step calls it), K8 and K4 on
    the boards and on every child K10 makes, and K9 on the variant's
    MOVEGEN_LONG fixtures. Max error 0 everywhere. Times at B = 16, 64 and
    1024 (the plain versions' at 64 and 1024), one call each as the step
    makes it (K9 with killers and history, K10 one move a lane); the
    bounds count the bytes each lane must move."""
    import torch

    from fishnet_tpu_torch.ops import board as tb
    from fishnet_tpu_torch.ops import movegen as tm
    from fishnet_tpu_torch.ops import tt

    dev = torch.device("cuda")
    v = variant
    z1, z2 = tt.tables(dev)
    stats = {k: {"max_abs_err": 0.0}
             for k in ("zobrist_hash", "node_rules", "generate_moves", "make_move")}

    def check(name, label, got, want):
        err = max(float((g.long() - w.long()).abs().max()) if g.numel() else 0.0
                  for g, w in zip(got, want))
        same = all(g.shape == w.shape and g.dtype == w.dtype for g, w in zip(got, want))
        stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        if err != 0 or not same:
            raise AssertionError(f"{name} {v} {label}: max_abs_err {err}, shapes/dtypes "
                                 f"equal {same}")
        log(f"check {name} {v} {label}: max_abs_err={err} (tolerance 0)")

    def hash_plain(boards):
        return tt.hash_board_plain(boards.board, boards.stm, boards.ep, boards.castling, z1, z2,
                                   boards.extra, v)

    for B in (16, 64, 1024):
        b, killers, hist = rules_inputs(B, seed=B, dev=dev, variant=v)
        for label, kw in (("plain ordering", {}), ("killers+history",
                                                   {"killers": killers, "hist": hist})):
            got = tm.generate_moves(b, variant=v, **kw)
            want = tm.generate_moves_plain(b, variant=v, **kw)
            torch.cuda.synchronize()
            check("generate_moves", f"B={B} {label} (moves {int(want[1].sum())})", got, want)
        moves, count, _ = want
        pb, pm = every_move(b, moves, count)
        rows = tb.rows_from_board(pb)
        got = tb.make_move_rows(rows, pm, v)
        want = tb.make_move_rows_plain(rows, pm, v)
        child = tb.board_from_rows(want[0])
        torch.cuda.synchronize()
        check("make_move", f"B={B} every move ({pm.shape[0]} lanes) from rows", got, want)
        for label, boards in (("boards", b), ("children", child)):
            got, want = tb.node_rules(boards, variant=v), tb.node_rules_plain(boards, variant=v)
            torch.cuda.synchronize()
            ends = [int((want[2] == k).sum()) for k in (tb.TERM_LOSS, tb.TERM_WIN, tb.TERM_DRAW)]
            check("node_rules", f"B={B} {label} ({int(want[0].sum())} illegal, "
                  f"{int(want[1].sum())} in check, ends loss/win/draw {ends} of "
                  f"{boards.board.shape[0]})", got, want)
            got, want = tt.hash_boards(boards, v), hash_plain(boards)
            torch.cuda.synchronize()
            check("zobrist_hash", f"B={B} {label}", (got,), (want,))

        # one call as the step makes it: the lane's board rows, its killers
        # and history; K10 on one generated move a lane
        rows = tb.rows_from_board(b)
        rb = tb.board_from_rows(rows)
        pick = torch.div(count, 2, rounding_mode="floor").long()[:, None]
        move = moves.gather(1, pick)[:, 0].clamp(min=0).contiguous()
        checks = 8 if v == "threeCheck" else 0  # the two counters K4 and K8 read
        timed = {  # kernel, plain version, bytes: board, scalars, extras in; out
            "zobrist_hash": (
                # of each table, the piece-square, ep, castling and stm keys
                # (crazyhouse: its 12 words and the pocket and promoted keys
                # they pick)
                lambda: tt.hash_boards(rb, v), lambda: hash_plain(rb),
                B * (256 + 4 + 4 + 16 + checks) + 2 * (tt._STM_OFF + 2) * 4 + B * 8
                + zh_key_bytes(rb, v)),
            "node_rules": (
                lambda: tb.node_rules(rb, variant=v), lambda: tb.node_rules_plain(rb, variant=v),
                B * ((64 + 1) * 4 + checks) + B * (2 + 4)),
            "generate_moves": (
                lambda: tm.generate_moves(rb, killers, hist, variant=v),
                lambda: tm.generate_moves_plain(rb, killers, hist, variant=v),
                movegen_bytes(b, v)),
            "make_move": (
                # in: the parent's 83 words and the move; out: the child's
                # 83 words and the 12 change words (the row's zero tail is
                # not the function's output)
                lambda: tb.make_move_rows(rows, move, v),
                lambda: tb.make_move_rows_plain(rows, move, v),
                B * (64 + 7 + 12 + 1) * 4 + B * (64 + 7 + 12 + 12) * 4),
        }
        for name, (kern, plain, nbytes) in timed.items():
            ms, call_ms = time_ms(kern, reps)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            stats[name].setdefault("ms_by_lanes", {})[B] = ms
            if B == 16:  # the kernels only: 16 lanes read their launch
                log(f"time {name} {v} B={B} (device ms / call ms): kernel {ms:.5f} / "
                    f"{call_ms:.5f}, bound {bound:.6f} (bytes, {nbytes} bytes)")
                continue
            plain_ms, plain_call = time_ms(plain, reps)
            stats[name].update(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bound,
                               bound_by="bytes")
            log(f"time {name} {v} B={B} (device ms / call ms): kernel {ms:.5f} / "
                f"{call_ms:.5f}, plain {plain_ms:.5f} / {plain_call:.5f}, library none, bound "
                f"{bound:.6f} (bytes, {nbytes} bytes)")

    # K9 on the long and tied lists of MOVEGEN_LONG
    if any(fv == v for _, fv, _ in MOVEGEN_LONG):
        labels, b, killers, hist = movegen_long_inputs(v, dev)
        for label, kw in (("plain ordering", {}), ("killers+history",
                                                   {"killers": killers, "hist": hist})):
            got = tm.generate_moves(b, variant=v, **kw)
            want = tm.generate_moves_plain(b, variant=v, **kw)
            torch.cuda.synchronize()
            check("generate_moves", f"MOVEGEN_LONG {label} ({', '.join(labels)}: moves "
                  f"{want[1].tolist()})", got, want)

    # K9 with every lane at one root case's FEN (crazyhouse: its sort
    # grows with the pockets' drops), checked, then timed at 1024
    for label, fen in ROOT_CASES.get(v, {}).items():
        B = 1024
        b, killers, hist = rules_inputs(B, seed=7, dev=dev, variant=v, fens=[fen] * B)
        got = tm.generate_moves(b, killers, hist, variant=v)
        want = tm.generate_moves_plain(b, killers, hist, variant=v)
        torch.cuda.synchronize()
        count = want[1].float()
        check("generate_moves", f"B={B} {label} (moves a lane: mean {float(count.mean()):.1f}, "
              f"max {int(count.max())})", got, want)
        (ms, call_ms), (plain_ms, _) = (
            time_ms(lambda: tm.generate_moves(b, killers, hist, variant=v), reps),
            time_ms(lambda: tm.generate_moves_plain(b, killers, hist, variant=v), reps))
        nbytes = movegen_bytes(b, v)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        stats["generate_moves"].setdefault("roots", {})[label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
            moves_per_lane=float(count.mean()))
        log(f"time generate_moves {v} B={B} {label} (device ms / call ms): kernel {ms:.5f} / "
            f"{call_ms:.5f}, plain {plain_ms:.5f}, bound {bound:.6f} (bytes, {nbytes} bytes)")
    return stats


def movegen_bytes(b, variant: str) -> int:
    """K9's bytes on boards b, killers and history as the step passes
    them: per lane the board, side to move, ep square, castling rooks and
    two killers in (crazyhouse: its pocket words too), each history word
    a quiet move or a drop reads (each (lane, from|to) once), and the list
    of the variant's width and two counts out."""
    import torch

    from fishnet_tpu_torch.ops import movegen as tm

    B = b.board.shape[0]
    flat_moves, flat_valid, flat_keys = tm._candidate_space(b, variant=variant)
    lane = torch.arange(B, device=b.board.device)[:, None] * 4096
    quiet = flat_valid & ((flat_keys == tm.QUIET_KEY) | (flat_keys == tm.DROP_KEY))
    n_hist = int((lane + (flat_moves & 4095))[quiet].unique().numel())
    pockets = 10 if variant == "crazyhouse" else 0
    return (B * (64 + 6 + 2 + pockets) * 4 + n_hist * 4
            + B * (tm.max_moves_for(variant) + 2) * 4)


def zh_key_bytes(b, variant: str) -> int:
    """Crazyhouse's part of K4's bytes beside the other variants': the
    12 variant words a lane reads (the pockets and promoted bits) and,
    once each, the pocket and promoted keys of both tables they pick."""
    import torch

    from fishnet_tpu_torch.ops import board as tb
    from fishnet_tpu_torch.ops import tt

    if variant != "crazyhouse":
        return 0
    dev = b.board.device
    counts = b.extra[:, :2 * tb.POCKET_TYPES].clamp(0, tt.POCKET_MAX)
    pocket = (counts + torch.arange(2 * tb.POCKET_TYPES, device=dev) * (tt.POCKET_MAX + 1))
    sq = torch.arange(64, device=dev)
    words = b.extra[:, tb.EXTRA_PROMOTED + (sq >> 5)]
    promoted = (((words >> (sq & 31)) & 1) == 1).any(0)
    keys = int(pocket.unique().numel()) + int(promoted.sum())
    return b.board.shape[0] * tb.EXTRA_W * 4 + 2 * keys * 4


def segment_case(params, B: int, cfg: str, seed: int, dev, variant: str = "standard",
                 fens=None):
    """A seeded B-lane search state on dev for K11 and its table setup:
    playout roots at depths 1-3 with node budgets of 100-1500 (so lanes
    finish at different steps), MAX_PLY 32. cfg: "no table"; "table" (a
    2^21-slot table, the plain store); "helpers" (three of four lanes
    jittered helpers with group tags, the prefer_deep store with per-lane
    generations into 2^12 slots, so lanes collide); "deep_tt" (2^21
    slots, deep_bounds probes, the prefer_deep store of one generation);
    "engine" (the main path's: 2^21 slots, prefer_deep, per-lane
    generations); "tiny" (the main path's rules and helpers into 2^6
    slots, so one step's leaf stores and the next step's probes and
    interior stores share slots). variant: a device variant other than
    "standard" takes rules_inputs' positions (from `fens` where given) as
    roots and is passed on to the segment. → (state, table or None,
    run_segment's keywords)."""
    import numpy as np
    import torch

    from fishnet_tpu_torch.ops import search, tt

    rng = np.random.default_rng(seed)
    if variant == "standard":
        roots = playout_boards(B, seed=seed)[0].to(dev)
    else:
        roots = rules_inputs(B, seed, dev, variant, fens)[0]

    def col(values):
        return torch.from_numpy(np.asarray(values, np.int32)).to(dev)

    kw = {}
    if cfg in ("helpers", "tiny"):
        jitter = rng.integers(1, 2**31 - 1, B).astype(np.int32)
        jitter[::4] = 0
        kw = dict(order_jitter=col(jitter), group=col(np.arange(B) // 4))
    state = search.init_state(params, roots, col(1 + np.arange(B) % 3),
                              col(rng.integers(100, 1500, B)), 32, variant=variant, **kw)
    size = {"no table": None, "table": 21, "helpers": 12, "deep_tt": 21, "engine": 21,
            "tiny": 6}[cfg]
    table = None if size is None else tt.make_table(size, device=dev)
    gen = col(rng.integers(1, 4, B)) if cfg in ("helpers", "engine", "tiny") else 5
    run_kw = dict(table=table, deep_tt=cfg == "deep_tt",
                  prefer_deep=cfg in ("helpers", "deep_tt", "engine", "tiny"), tt_gen=gen,
                  variant=variant)
    return state, table, run_kw


def _clone(state, table):
    from fishnet_tpu_torch.ops import search

    return (search.SearchState(*[t.clone() for t in state]),
            None if table is None else table.clone())


def _state_diff(a, b, ta, tb) -> float:
    """The largest difference between two states' tables (floats compared
    as their bits) and two transposition tables; 0 when byte-equal."""
    import torch

    err = 0.0
    for x, y in list(zip(a, b)) + ([] if ta is None else [(ta, tb)]):
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.numel():
            err = max(err, float((x.long() - y.long()).abs().max()))
    return err


def plain_segment_ms(run) -> tuple:
    """(ms, steps) of the plain version's yardstick: run(steps), a fresh
    run_segment_plain (or several in turn) from the timed state, over
    PLAIN_TIMING_STEPS steps, on the host's clock between synchronisations.
    It times the plain version only; the phases' checks hold it to K11."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    n = run(PLAIN_TIMING_STEPS)
    torch.cuda.synchronize()
    return (time.monotonic() - t0) * 1e3, n


def segment_bytes(calls: dict, acc_bytes: int, variant: str = "standard") -> int:
    """The bytes a segment must move, from K11's counters of its body
    calls and live lane-steps: each live lane-step reads and writes the
    lane's 64-byte row; each entering lane (one eval) reads its board row
    (71 words, and of the 12 variant words those the variant's rules
    read: threeCheck's two check counters, all 12 in crazyhouse, its
    pockets and promoted bits), its and its parent's node rows and, unless
    it refreshes its pair from the board (atomic's leaf: K1's body), its
    accumulator pair, and writes its node row and two path-hash words;
    each lane that advances (one make-move) writes its board row (96
    words) and node row, and where it updates accumulators (K3's body)
    reads the parent's pair and writes the child's; each probe reads and
    each masked store writes one 16-byte table row. A segment that
    refreshes reads ft_w (the f32 net's: 768 rows of acc_bytes / 2) once,
    its rows staying in L2."""
    enters, advances = calls["nnue_forward_from_acc"], calls["make_move"]
    refreshes, updates = calls["nnue_refresh_768"], calls["nnue_acc_update_768"]
    row_words = 71 + {"threeCheck": 2, "crazyhouse": 12}.get(variant, 0)
    return (calls["live_lane_steps"] * 128
            + enters * (row_words * 4 + 2 * 64 + 64 + 8)
            + (enters - refreshes + 2 * updates) * acc_bytes
            + advances * (96 * 4 + 64)
            + (calls["tt_probe"] + calls["tt_store"]) * 16
            + (768 * acc_bytes // 2 if refreshes else 0))


def segment_phase(params_f32, reps: int) -> dict:
    """K11 against run_segment_plain on the card: seeded states at 16, 64
    and 1024 lanes, both nets, every SEGMENT_CONFIGS setup (and at
    TINY_LANES the "tiny" one, whose reads through a store's pending rows
    K11's counter must show), segments of SEGMENT_STEPS steps in turn and
    (16 lanes) one of FINISH_STEPS in which every lane finishes: every
    state table, the transposition table and the summary byte for byte
    and the step counts equal. Then K11's
    time per segment and per step (CUDA events) at 16, 64 and 1024 lanes
    on the main path's table setup ("engine"), the plain version's, and
    the bound from the bytes the timed segment moves."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import search

    dev = torch.device("cuda")
    nets = {"f32": params_f32, "int8": nnue.quantize_int8(params_f32)}
    stats = {"max_abs_err": 0.0}
    for B in (16, 64, 1024):
        for net, params in nets.items():
            for cfg in SEGMENT_CONFIGS + (("tiny",) if B in TINY_LANES else ()):
                state, table, kw = segment_case(params, B, cfg, seed=B + len(cfg), dev=dev)
                plain, plain_table = _clone(state, table)
                plain_kw = dict(kw, table=plain_table)
                segs = SEGMENT_STEPS + ((FINISH_STEPS,) if B == 16 else ())
                pending = kernels.body_calls()["pending_reads"]
                t0 = time.monotonic()
                for steps in segs:
                    n_k, sum_k = search.run_segment(params, state, steps, True, **kw)
                    n_p, sum_p = search.run_segment_plain(params, plain, steps, True, **plain_kw)
                    torch.cuda.synchronize()
                    err = _state_diff(state, plain, table, plain_table)
                    err = max(err, float((sum_k.long() - sum_p.long()).abs().max()))
                    done = int(sum_k[:B, search.SUM_DONE].sum())
                    label = f"B={B} {net} {cfg} segment {steps}"
                    log(f"check search_segment {label}: steps {n_k} (plain {n_p}), done "
                        f"{done}/{B}, max_abs_err={err} (tolerance 0, grid "
                        f"{kernels.LAST_GRID['blocks']} blocks)")
                    stats["max_abs_err"] = max(stats["max_abs_err"], err)
                    if err != 0 or n_k != n_p:
                        raise AssertionError(f"search_segment {label}: K11 differs from "
                                             f"run_segment_plain (steps {n_k} / {n_p})")
                    if steps == FINISH_STEPS and (done != B or n_k >= steps):
                        raise AssertionError(f"search_segment {label}: lanes did not finish")
                pending = kernels.body_calls()["pending_reads"] - pending
                log(f"search_segment B={B} {net} {cfg}: {pending} table reads went through "
                    f"a store's pending row; checks {time.monotonic() - t0:.1f} s")
                if cfg == "tiny" and pending <= 0:
                    raise AssertionError(f"search_segment B={B} {net} tiny: no read went "
                                         f"through a pending row")

    # times on the main path's table setup, f32 net, one segment of 200
    # steps from a fresh state (the state and table restored between runs)
    for B in (16, 1024, 64):
        state0, table0, kw = segment_case(params_f32, B, "engine", seed=B, dev=dev)
        state, table = _clone(state0, table0)
        kw = dict(kw, table=table)
        steps = SEGMENT_STEPS[-1]
        search.run_segment(params_f32, state, steps, True, **kw)  # warm up
        times = []
        for _ in range(reps):
            for t, t0 in zip(list(state) + [table], list(state0) + [table0]):
                t.copy_(t0)
            kernels.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            n, _ = search.run_segment(params_f32, state, steps, True, **kw)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        calls = kernels.body_calls()
        ms = sum(times) / len(times)
        plain, plain_table = _clone(state0, table0)
        plain_ms, n_p = plain_segment_ms(lambda k: search.run_segment_plain(
            params_f32, plain, k, True, **dict(kw, table=plain_table))[0])
        nbytes = segment_bytes(calls, 2 * 64 * 4)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"time search_segment B={B} engine table (CUDA events, {reps} launches): "
            f"{ms:.4f} ms per segment of {n} steps, {ms / n * 1e3:.2f} us/step; plain "
            f"{plain_ms:.1f} ms for a segment of {n_p} steps ({plain_ms / n_p:.3f} ms/step); "
            f"bound {bound:.6f} ms, {bound / n * 1e3:.4f} us/step (bytes, {nbytes} bytes; "
            f"counters {calls}); grid {kernels.LAST_GRID['blocks']} blocks")
        if n != steps:
            raise AssertionError(f"timed segment B={B} ran {n} of {steps} steps")
        stats.update(ms=ms, plain_ms=plain_ms, plain_steps=n_p, bound_ms=bound,
                     bound_by="bytes", library_ms=None, steps=n)
    return {"search_segment": stats}



def kb_case(l1: int, h1: int, h2: int, seed: int) -> dict:
    """A seeded king-bucketed (HalfKAv2_hm) net with the JAX package's
    init_params distributions: ft_w ~N(0, 0.02), ft_b 0.5, each layer's
    weights ~N(0, 1/fan_in), zero biases. → dict of f32 numpy arrays
    under the NnueParams field names."""
    import numpy as np

    from fishnet_tpu_torch.models import nnue

    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape, dtype=np.float32) * np.float32(scale))

    return {
        "ft_w": normal((nnue.NUM_FEATURES, l1), 0.02),
        "ft_b": np.full((l1,), 0.5, np.float32),
        "l1_w": normal((8, 2 * l1, h1), 1.0 / np.sqrt(2 * l1)),
        "l1_b": np.zeros((8, h1), np.float32),
        "l2_w": normal((8, h1, h2), 1.0 / np.sqrt(h1)),
        "l2_b": np.zeros((8, h2), np.float32),
        "out_w": normal((8, h2), 1.0 / np.sqrt(h2)),
        "out_b": np.zeros((8,), np.float32),
    }


def sf_fixtures():
    """tests/test_torch_sf_eval.py, the K13 and K17 fixtures' module
    (sf_eval_boards, sf_eval_net, SF_EVAL_WIDTHS, KB_REFRESH_CASES,
    kb_refresh_case); it imports no JAX at its top."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import test_torch_sf_eval

    return test_torch_sf_eval


def sf_file(l1: int, seed: int):
    """sf_case(l1, seed) written through write_nnue into the build
    directory (once per checkout) → its path."""
    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue_import as ni

    path = kernels.BUILD_ROOT / "chip_smoke" / f"sf-l1-{l1}-seed-{seed}.nnue"
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        ni.write_nnue(tmp, sf_case(l1, seed))
        os.replace(tmp, path)
    return path


def full_eval_nets(dev) -> dict:
    """The full-eval nets on dev: "kb f32" / "kb int8" (kb_case at
    KB_WIDTHS and its int8 quantization), "sf 128" / "sf 3072" (sf_case
    through a file and load_nnue)."""
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.models import nnue_import as ni

    kb = nnue.params_from_numpy(kb_case(*KB_WIDTHS, seed=5), dev)
    return {"kb f32": kb, "kb int8": nnue.quantize_int8(kb),
            f"sf {SF_SMALL_L1}": ni.load_nnue(sf_file(SF_SMALL_L1, 7), device=dev),
            f"sf {SF_L1}": ni.load_nnue(sf_file(SF_L1, 7), device=dev)}


def full_eval_features(boards):
    """(B, 2, 64) HalfKAv2_hm feature rows of each board's pieces from
    both perspectives, -1 on empty squares."""
    import torch

    from fishnet_tpu_torch.models import nnue

    return torch.stack([nnue.feature_indices(boards, p, nnue.king_square(boards, p))
                        for p in (0, 1)], 1)


def full_eval_cost(net, boards) -> tuple:
    """(bytes, operations) a full eval (K12 or K13) of these boards must
    move and do: the boards and side to move in and the scores out; of
    the feature transform each distinct row the batch's pieces select
    once, and ft_b; of the layer stack the weights of each bucket the
    batch uses once; a Stockfish net's PSQT word of each distinct (row,
    bucket) pair. Operations: an add a column of every board's rows (and
    of its PSQT words), then its layer stack's multiply-adds (two each;
    a Stockfish net's pairwise products one each)."""
    from fishnet_tpu_torch.models import nnue

    B, l1 = boards.shape[0], net.l1
    feats = full_eval_features(boards)
    live = feats >= 0
    n_rows = int(live.sum())
    buckets = nnue.output_bucket(boards)
    nbytes = (B * (64 * 4 + 4 + 4) + int(feats[live].unique().numel()) * l1 * net.ft_w.element_size()
              + l1 * net.ft_b.element_size())
    nops = n_rows * l1
    if nnue.net_kind(net) == nnue.KING:
        h1, h2 = net.l1_w.shape[-1], net.l2_w.shape[-1]
        head = sum(t[0].numel() * t.element_size() for t in net[2:])
        nops += B * 2 * (2 * l1 * h1 + h1 * h2 + h2)
    else:
        pairs = (feats.long() * 8 + buckets.long()[:, None, None])[live]
        nbytes += int(pairs.unique().numel()) * 4
        head = sum(getattr(net, f)[0].numel() * 4 for f in (
            "fc0_w", "fc0_b", "fc1_w", "fc1_b", "fc2_w", "fc2_b"))
        nops += n_rows + B * (l1 + 2 * (16 * l1 + 32 * 30 + 32))
    return nbytes + int(buckets.unique().numel()) * head, nops


def nets_kernel_phase(nets: dict, reps: int) -> dict:
    """K12 and K13 against their plain versions on the card at 16, 64 and
    1024 lanes of seeded playout boards: K12 on the king-bucketed net (L1
    256) f32 (within F32_EVAL_TOL) and int8 (exactly), K13 on the
    Stockfish nets at L1 128 and 3072 (within F32_EVAL_TOL). Times at 64
    and 1024 lanes (K12 f32, K13 L1 3072), beside the plain version, the
    library yardstick (embedding_bag sums of the feature rows, the refresh
    alone) and the bound from full_eval_cost. The bound reads each row
    from HBM, so the row keeps 1024 lanes' cold-L2 times (time_cold_ms),
    with the kernel's repeated-call device time beside them (ms_l2_warm:
    the batch's distinct rows, 34 MB at L1 3072, fit the L2)."""
    import torch
    import torch.nn.functional as F

    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.models import nnue_import as ni

    dev = torch.device("cuda")
    stats = {k: {"max_abs_err": 0.0} for k in ("nnue_evaluate", "nnue_evaluate_sf")}
    scrub = torch.empty(L2_SCRUB_BYTES, dtype=torch.uint8, device=dev)
    cases = (
        ("nnue_evaluate", "kb f32", nnue.evaluate, nnue.evaluate_plain, nnue.F32_EVAL_TOL),
        ("nnue_evaluate", "kb int8", nnue.evaluate, nnue.evaluate_plain, 0.0),
        ("nnue_evaluate_sf", f"sf {SF_SMALL_L1}", ni.evaluate_sf, ni.evaluate_sf_plain,
         nnue.F32_EVAL_TOL),
        ("nnue_evaluate_sf", f"sf {SF_L1}", ni.evaluate_sf, ni.evaluate_sf_plain,
         nnue.F32_EVAL_TOL),
    )
    fx = sf_fixtures()
    boards, stm = (torch.from_numpy(a).to(dev) for a in fx.sf_eval_boards())
    for l1 in fx.SF_EVAL_WIDTHS:  # every bucket and king square, both sides to move
        net = ni.stockfish_net_from_numpy(fx.sf_eval_net(l1), dev)
        got, want = ni.evaluate_sf(net, boards, stm), ni.evaluate_sf_plain(net, boards, stm)
        torch.cuda.synchronize()
        err = float((got.double() - want.double()).abs().max())
        log(f"check nnue_evaluate_sf fixtures L1={l1} ({len(stm)} boards, "
            f"{nnue.output_bucket(boards).unique().numel()} buckets): max_abs_err={err} "
            f"(tolerance {nnue.F32_EVAL_TOL}; evals {float(want.min()):.1f}.."
            f"{float(want.max()):.1f})")
        if not err <= nnue.F32_EVAL_TOL:
            raise AssertionError(f"nnue_evaluate_sf fixtures L1={l1}: error {err}")
        stats["nnue_evaluate_sf"]["max_abs_err"] = max(stats["nnue_evaluate_sf"]["max_abs_err"],
                                                       err)
    for B in (16, 64, 1024):
        b = playout_boards(B, seed=100 + B)[0].to(dev)
        for name, label, kern, plain, tol in cases:
            net = nets[label]
            got, want = kern(net, b.board, b.stm), plain(net, b.board, b.stm)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"{name} {label} B={B}: {got.shape}/{got.dtype} vs plain "
                                     f"{want.shape}/{want.dtype}")
            err = float((got.double() - want.double()).abs().max())
            log(f"check {name} B={B} net={label} L1={net.l1}: max_abs_err={err} (tolerance "
                f"{tol}; evals {float(want.min()):.1f}..{float(want.max()):.1f})")
            if not err <= tol:
                raise AssertionError(f"{name} {label} B={B}: error {err} > {tol}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
            if B == 16 or label not in ("kb f32", f"sf {SF_L1}"):
                continue
            feats = full_eval_features(b.board).view(B * 2, 64)
            keep = feats >= 0
            bag_idx = feats[keep].long()
            bag_off = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                                 keep.sum(1).cumsum(0)[:-1]])
            nbytes, nops = full_eval_cost(net, b.board)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / F32_OPS_PER_S * 1e3
            fns = (lambda: kern(net, b.board, b.stm), lambda: plain(net, b.board, b.stm),
                   lambda: F.embedding_bag(bag_idx, net.ft_w, bag_off, mode="sum") + net.ft_b)
            (ms, call_ms), (plain_ms, plain_call), (lib_ms, lib_call) = [
                time_ms(f, reps) for f in fns]
            cold, plain_cold, lib_cold = [time_cold_ms(f, reps, scrub) for f in fns]
            bound = max(t_bytes, t_ops)
            log(f"time {name} B={B} net={label} L1={net.l1} (device ms / call ms / cold-L2 "
                f"ms): kernel {ms:.5f} / {call_ms:.5f} / {cold:.5f}, plain {plain_ms:.5f} / "
                f"{plain_call:.5f} / {plain_cold:.5f}, library (refresh only) {lib_ms:.5f} / "
                f"{lib_call:.5f} / {lib_cold:.5f}, bound {bound:.6f} "
                f"({'bytes' if t_bytes >= t_ops else 'operations'}, {nbytes} bytes, {nops} ops)")
            if B == 1024:
                stats[name].update(ms=cold, ms_l2_warm=ms, plain_ms=plain_cold,
                                   library_ms=lib_cold, bound_ms=bound,
                                   bound_by="bytes" if t_bytes >= t_ops else "operations")
                # the L2 reckoning, counted from the inputs (not measured):
                # every row the boards' pieces select is read once a
                # perspective, the distinct ones from HBM (the bound)
                rows, distinct = int(keep.sum()), int(bag_idx.unique().numel())
                log(f"rows {name} B={B} net={label} (counted from the inputs): {rows} row "
                    f"reads, {rows * net.l1 * 4 / 1e6:.1f} MB, of them "
                    f"{distinct * net.l1 * 4 / 1e6:.1f} MB distinct (the bound's HBM reads; "
                    f"the rest can hit the L2)")
    return stats


def nets_segment_phase(nets: dict, reps: int) -> None:
    """K11 against run_segment_plain on the card on the full-eval nets:
    the int8 king-bucketed net without and with a 2^21 table, and the
    L1 3072 Stockfish net with jittered helpers and the prefer_deep store
    into 2^12 slots, at 16 and 64 lanes, segments of NET_SEGMENT_STEPS in
    turn: states, tables and summaries byte for byte (the plain step on
    the card runs K12's and K13's standalone kernels, K11 their bodies).
    Then K11's time per step on each net's engine setup at 64 lanes, with
    its body calls per step."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.ops import search

    dev = torch.device("cuda")
    runs = (("kb int8", ("no table", "table")), (f"sf {SF_L1}", ("helpers",)))
    for label, cfgs in runs:
        params = nets[label]
        for B in (16, 64):
            for cfg in cfgs:
                state, table, kw = segment_case(params, B, cfg, seed=B + len(cfg), dev=dev)
                plain, plain_table = _clone(state, table)
                plain_kw = dict(kw, table=plain_table)
                for steps in NET_SEGMENT_STEPS:
                    t0 = time.monotonic()
                    n_p, sum_p = search.run_segment_plain(params, plain, steps, True, **plain_kw)
                    torch.cuda.synchronize()
                    plain_s = time.monotonic() - t0
                    n_k, sum_k = search.run_segment(params, state, steps, True, **kw)
                    torch.cuda.synchronize()
                    err = _state_diff(state, plain, table, plain_table)
                    err = max(err, float((sum_k.long() - sum_p.long()).abs().max()))
                    done = int(sum_k[:B, search.SUM_DONE].sum())
                    tag = f"B={B} {label} {cfg} segment {steps}"
                    log(f"check search_segment {tag}: steps {n_k} (plain {n_p}, {plain_s:.2f} s), "
                        f"done {done}/{B}, max_abs_err={err} (tolerance 0)")
                    if err != 0 or n_k != n_p:
                        raise AssertionError(f"search_segment {tag}: K11 differs from "
                                             f"run_segment_plain (steps {n_k} / {n_p})")
        # K11's time on the engine's table setup, 64 lanes, one segment
        state0, table0, kw = segment_case(params, 64, "engine", seed=64, dev=dev)
        state, table = _clone(state0, table0)
        kw = dict(kw, table=table)
        steps = NET_SEGMENT_STEPS[-1]
        search.run_segment(params, state, steps, True, **kw)  # warm up
        times = []
        for _ in range(reps):
            for t, t0 in zip(list(state) + [table], list(state0) + [table0]):
                t.copy_(t0)
            kernels.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            n, _ = search.run_segment(params, state, steps, True, **kw)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        calls = kernels.body_calls()
        ms = sum(times) / len(times)
        log(f"time search_segment B=64 {label} engine table (CUDA events, {reps} launches): "
            f"{ms:.4f} ms per segment of {n} steps, {ms / n * 1e3:.2f} us/step; body calls per "
            f"step {({k: round(v / n, 3) for k, v in calls.items()})}")


def train_case(B: int, seed: int, dev) -> dict:
    """The inputs of K14-K16 at batch B: the shipped f32 net (packed),
    B diverse positions from the seed with their accumulators, buckets and
    the loss's gradient by each score; and for K16, flat Adam buffers
    (gradients ~N(0, 1e-2), mu ~N(0, 1e-3), nu ~U[0, 1e-5)) at step 7."""
    import numpy as np
    import torch

    from fishnet_tpu_torch.models import nnue, train

    boards, stms, targets = (torch.from_numpy(a).to(dev)
                             for a in train.diverse_position_dataset(B, seed=seed))
    params = train.pack_params(nnue.load_params(device=dev))
    acc = nnue.accumulators_768_plain(params, boards)
    bucket = nnue.output_bucket(boards)
    pred = nnue.forward_from_acc_plain(params, acc, stms, bucket)
    rng = np.random.default_rng(seed)
    n = train.flat_view(params).numel()

    def f32(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return {"params": params, "boards": boards, "stms": stms, "acc": acc, "bucket": bucket,
            "d_pred": (2 * (pred - targets) / 1e4 / B).contiguous(),
            "grad": f32(rng.normal(size=n) * 1e-2), "mu": f32(rng.normal(size=n) * 1e-3),
            "nu": f32(rng.random(n) * 1e-5), "count": 7}


def _rel_err(got, want) -> float:
    """max |got - want| over the largest |want| (0 where both are 0)."""
    scale = float(want.abs().max())
    err = float((got.double() - want.double()).abs().max())
    return err / scale if scale else err


def ft_case(B: int, l1: int, seed: int, kind: str = "seeded") -> tuple:
    """numpy inputs of K15 and K18 → boards (B, 64) int32: B start
    positions ("start") or diverse positions from the seed (a batch above
    512 repeats 512 of them, each repeat shuffled); d_acc (B, 2, l1) f32:
    normal values scaled by a log-normal factor a (sample, perspective), so
    that a sum's order shows in its bits."""
    import numpy as np

    from fishnet_tpu_torch.chess import Position
    from fishnet_tpu_torch.models import train

    rng = np.random.default_rng(seed)
    if kind == "start":
        boards = np.tile(train.board_array(Position.initial()), (B, 1))
    else:
        base = train.diverse_position_dataset(min(B, 512), seed=seed)[0]
        boards = np.concatenate([base[rng.permutation(len(base))]
                                 for _ in range(-(-B // len(base)))])[:B]
    d_acc = rng.normal(size=(B, 2, l1)) * np.exp(rng.normal(size=(B, 2, 1)))
    return boards.astype(np.int32), d_acc.astype(np.float32)


def ft_kernel(feature_set: str) -> tuple:
    """(kernel name, its wrapper, its plain version, feature rows) of K15
    or K18."""
    from fishnet_tpu_torch.models import nnue, train

    if feature_set == "board768":
        return ("nnue_ft_backward_768", train.ft_backward_768, train.ft_backward_768_plain,
                nnue.NUM_FEATURES_768)
    return ("nnue_ft_backward_kb", train.ft_backward_kb, train.ft_backward_kb_plain,
            nnue.NUM_FEATURES)


def ft_check(feature_set: str, label: str, boards, d_acc) -> float:
    """K15 or K18 on one fixture on the card: byte for byte the plain
    version run on the CPU (the order it states), the same bytes on a
    repeated launch, and within TRAIN_GRAD_RTOL of the plain version run
    on the card (a CUDA index_add_, whose float atomics add in no fixed
    order). → the largest difference from the CPU's plain version."""
    import torch

    name, wrapper, plain, rows = ft_kernel(feature_set)
    n = (rows + 1) * d_acc.shape[2]
    g1, g2 = (torch.empty(n, device=d_acc.device) for _ in range(2))
    wrapper(boards, d_acc, g1)
    wrapper(boards, d_acc, g2)
    on_card = torch.cat([t.reshape(-1) for t in plain(boards, d_acc)])
    on_cpu = torch.cat([t.reshape(-1) for t in plain(boards.cpu(), d_acc.cpu())])
    torch.cuda.synchronize()
    got = g1.cpu()
    equal = torch.equal(got.view(torch.int32), on_cpu.view(torch.int32))
    same = torch.equal(g1.view(torch.int32), g2.view(torch.int32))
    err = float((got.double() - on_cpu.double()).abs().max())
    rel = _rel_err(g1, on_card)
    touched = int(got[:rows * d_acc.shape[2]].view(rows, -1).ne(0).any(1).sum())
    log(f"check {name} {label} (B={boards.shape[0]}, L1 {d_acc.shape[2]}): the CPU's plain "
        f"version byte for byte: {equal} (max_abs_err {err}, tolerance 0); a repeated launch "
        f"the same bytes: {same}; the card's plain version (atomics) within {rel} relative "
        f"(tolerance {TRAIN_GRAD_RTOL}); {touched} of {rows} rows touched")
    if not (equal and same and rel <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"{name} {label}: CPU bytes equal {equal}, repeat equal {same}, "
                             f"relative error {rel}")
    return err


def ft_fixtures(feature_set: str) -> float:
    """ft_check on FT_CASES → the largest difference from the CPU."""
    import torch

    err = 0.0
    for i, (label, B, l1, kind) in enumerate(FT_CASES):
        l1 = l1 or FT_WIDE_L1[feature_set]
        boards, d_acc = (torch.from_numpy(a).cuda() for a in ft_case(B, l1, seed=50 + i,
                                                                      kind=kind))
        err = max(err, ft_check(feature_set, label, boards, d_acc))
    return err


def time_stages_ms(stages, reps: int) -> list:
    """ms of each call of a sequence run reps times (stages: functions
    called in turn): CUDA events recorded between the calls, all queued
    while the card spins (as time_queued_ms), so each reads the card's time
    for its call."""
    import torch

    for fn in stages:
        fn()
    torch.cuda.synchronize()
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
             for _ in range(reps)]
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    for ev in marks:
        ev[0].record()
        for fn, e in zip(stages, ev[1:]):
            fn()
            e.record()
    torch.cuda.synchronize()
    return [sum(ev[i].elapsed_time(ev[i + 1]) for ev in marks) / reps
            for i in range(len(stages))]


def ft_times(feature_set: str, boards, d_acc, reps: int) -> dict:
    """K15's or K18's passes timed on their own (time_stages_ms: the mark
    pass, the row pass, then the sum and ft_b passes) on the trainer's
    batch and on FT_CASES' start positions (every piece row a chain of
    1,024 adds), with the whole kernel's time on the start positions →
    {mark_ms, rows_ms, sums_ms, start_ms, start_mark_ms, start_rows_ms,
    start_sums_ms}. Launched alone, each pass pays the launch gap that the
    whole call overlaps, so the three add up to more than the call."""
    import torch

    from fishnet_tpu_torch import kernels

    name, _, _, rows = ft_kernel(feature_set)
    launch = getattr(kernels, name)
    l1 = d_acc.shape[2]
    out = {}
    sb, sd = (torch.from_numpy(a).cuda() for a in ft_case(TRAIN_BATCH, l1, seed=50,
                                                          kind="start"))
    for tag, b, d in (("", boards, d_acc), ("start_", sb, sd)):
        g = torch.empty((rows + 1) * l1, device=d.device)
        split = time_stages_ms([lambda: launch(d, b, g, stages=1),
                                lambda: launch(d, b, g, stages=2),
                                lambda: launch(d, b, g, stages=4)], reps)
        for stage, ms in zip(("mark", "rows", "sums"), split):
            out[f"{tag}{stage}_ms"] = ms
        if tag:
            out["start_ms"] = time_ms(lambda: launch(d, b, g), reps)[0]
    log(f"time {name} passes (B={boards.shape[0]}, L1 {l1}; CUDA events between the passes): "
        f"mark {out['mark_ms']:.5f} ms, rows {out['rows_ms']:.5f} ms, sums and ft_b "
        f"{out['sums_ms']:.5f} ms; start positions {out['start_ms']:.5f} ms (mark "
        f"{out['start_mark_ms']:.5f}, rows {out['start_rows_ms']:.5f}, sums and ft_b "
        f"{out['start_sums_ms']:.5f})")
    return out


def train_kernel_phase(reps: int) -> dict:
    """K14, K15 and K16 against their plain versions on the card at B = 16
    and TRAIN_BATCH: K14 within TRAIN_GRAD_RTOL and the same bytes on a
    repeated launch, K15 byte for byte the plain version run on the CPU
    (ft_check), also on FT_CASES, K16 bit for bit; then times at
    TRAIN_BATCH (kernel, plain, library; K15's passes on their own) and
    bounds from these inputs' bytes."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue, train

    dev = torch.device("cuda")
    stats = {k: {"max_abs_err": 0.0} for k in TRAIN_KERNELS[2:]}
    n_ft = (nnue.NUM_FEATURES_768 + 1) * kernels.SEGMENT_L1
    for B in (16, TRAIN_BATCH):
        c = train_case(B, seed=B + 1, dev=dev)
        p, acc, stms, bucket, d_pred, boards = (
            c[k] for k in ("params", "acc", "stms", "bucket", "d_pred", "boards"))
        g_k, g_k2 = (torch.empty(kernels.STACK_GRADS, device=dev) for _ in range(2))
        d_acc = train.stack_backward(p, acc, stms, bucket, d_pred, g_k)
        d_acc2 = train.stack_backward(p, acc, stms, bucket, d_pred, g_k2)
        d_acc_p, grads_p = train.stack_backward_plain(p, acc, stms, bucket, d_pred)
        g_p = torch.cat([g.reshape(-1) for g in grads_p])
        err = ft_check("board768", "seeded", boards, d_acc_p)
        stats["nnue_ft_backward_768"]["max_abs_err"] = max(
            stats["nnue_ft_backward_768"]["max_abs_err"], err)
        ft_k = torch.empty(n_ft, device=dev)
        opt = train.Adam(TRAIN_LR)
        bc = opt.bias_corrections(c["count"] + 1)
        bufs_k = [train.flat_view(p).clone(), c["grad"], c["mu"].clone(), c["nu"].clone()]
        bufs_p = [train.flat_view(p).clone(), c["grad"], c["mu"].clone(), c["nu"].clone()]
        kernels.adam_update(*bufs_k, opt.lr, opt.b1, opt.b2, opt.eps, *bc)
        train.adam_update_plain(*bufs_p, opt.lr, opt.b1, opt.b2, opt.eps, *bc)
        torch.cuda.synchronize()
        checks = {
            "nnue_stack_backward": (
                [(d_acc, d_acc_p), *zip(g_k.split([g.numel() for g in grads_p]),
                                        [g.reshape(-1) for g in grads_p])],
                [(d_acc, d_acc2), (g_k, g_k2)]),
        }
        for name, (pairs, repeats) in checks.items():
            rel = max(_rel_err(a, b) for a, b in pairs)
            err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
            same = all(torch.equal(a, b) for a, b in repeats)
            log(f"check {name} B={B}: max_abs_err={err} relative {rel} (tolerance "
                f"{TRAIN_GRAD_RTOL}); a repeated launch the same bytes: {same}")
            if not rel <= TRAIN_GRAD_RTOL or not same:
                raise AssertionError(f"{name} B={B}: relative error {rel}, repeat equal {same}")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        equal = all(torch.equal(a, b) for a, b in zip(bufs_k, bufs_p))
        log(f"check adam_update B={B}: params, mu, nu equal to the plain version's: {equal}")
        if not equal:
            raise AssertionError("adam_update differs from its plain version")
        if B != TRAIN_BATCH:
            continue
        stats["nnue_ft_backward_768"]["max_abs_err"] = max(
            stats["nnue_ft_backward_768"]["max_abs_err"], ft_fixtures("board768"))

        # times at the training batch
        l1 = p.l1
        pieces = int((boards > 0).sum())
        used = int(bucket.unique().numel())
        head = used * sum(t[0].numel() * 4 for t in p[2:])
        acc_bytes = B * 2 * l1 * 4
        sq = torch.arange(64, dtype=torch.int32, device=dev)
        idx = torch.stack([nnue.feature_index_768(boards, sq, q) for q in (0, 1)], 1)  # (B, 2, 64)
        live = idx >= 0
        rows = idx[live].long()
        src = d_acc_p[:, :, None, :].expand(B, 2, 64, l1)[live].contiguous()
        lib_ft = torch.zeros((nnue.NUM_FEATURES_768, l1), device=dev)
        n = bufs_k[0].numel()
        lib_p = torch.nn.Parameter(bufs_k[0].clone())
        lib_p.grad = c["grad"].clone()
        lib_opt = torch.optim.Adam([lib_p], lr=TRAIN_LR, fused=True)
        table = {
            "nnue_stack_backward": (
                lambda: train.stack_backward(p, acc, stms, bucket, d_pred, g_k),
                lambda: train.stack_backward_plain(p, acc, stms, bucket, d_pred),
                None,
                # acc, stm, bucket, d_pred and the used buckets' head in;
                # d_acc and the head gradients out
                acc_bytes + B * 12 + head + acc_bytes + kernels.STACK_GRADS * 4,
                # the forward's and the backward's multiply-adds, and the
                # weight gradients' over the batch
                B * 2 * 3 * (128 * 16 + 16 * 32 + 32),
            ),
            "nnue_ft_backward_768": (
                lambda: train.ft_backward_768(boards, d_acc_p, ft_k),
                lambda: train.ft_backward_768_plain(boards, d_acc_p),
                lambda: lib_ft.index_add_(0, rows, src),
                acc_bytes + B * 256 + n_ft * 4,
                2 * pieces * l1 + 2 * B * l1,
            ),
            "adam_update": (
                lambda: kernels.adam_update(*bufs_k, opt.lr, opt.b1, opt.b2, opt.eps, *bc),
                lambda: train.adam_update_plain(*bufs_p, opt.lr, opt.b1, opt.b2, opt.eps, *bc),
                lib_opt.step,
                7 * 4 * n,
                12 * n,
            ),
        }
        for name, (kern, plain, lib, nbytes, nops) in table.items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / F32_OPS_PER_S * 1e3
            (ms, call_ms), (plain_ms, plain_call) = time_ms(kern, reps), time_ms(plain, reps)
            lib_ms, lib_call = (None, None) if lib is None else time_ms(lib, reps)
            stats[name].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
            )
            log(f"time {name} B={B} (device ms / call ms): kernel {ms:.5f} / {call_ms:.5f}, "
                f"plain {plain_ms:.5f} / {plain_call:.5f}, library {lib_ms} / {lib_call}, "
                f"bound {stats[name]['bound_ms']:.6f} ({stats[name]['bound_by']}); "
                f"{pieces} pieces, {used} buckets")
        stats["nnue_ft_backward_768"].update(ft_times("board768", boards, d_acc_p, reps))
    return stats


def search_plain_twins() -> tuple:
    """The search path's plain versions (module, name): the plain segment
    and step, the board rules, move generator, make-move and hash."""
    from fishnet_tpu_torch.ops import board, movegen, search, tt

    return ((search, "run_segment_plain"), (search, "_step"), (board, "node_rules_plain"),
            (board, "make_move_rows_plain"), (movegen, "generate_moves_plain"),
            (tt, "hash_board_plain"))


@contextlib.contextmanager
def count_plain_calls(twins=None):
    """Counts the calls of plain versions while it is entered (each
    wrapped in its module, then restored) → {name: calls}. twins: (module,
    name) pairs; by default the training path's."""
    from fishnet_tpu_torch.models import nnue, train

    if twins is None:
        twins = ((nnue, "accumulators_768_plain"), (nnue, "accumulators"),
                 (nnue, "forward_from_acc_plain"), (train, "stack_backward_plain"),
                 (train, "ft_backward_768_plain"), (train, "ft_backward_kb_plain"),
                 (train, "adam_update_plain"))
    counts = {name: 0 for _, name in twins}
    saved = [(mod, name, getattr(mod, name)) for mod, name in twins]
    for mod, name, fn in saved:
        def counted(*args, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*args, **kw)

        setattr(mod, name, counted)
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


@functools.lru_cache(maxsize=1)
def train_dataset():
    """TRAIN_SAMPLES diverse positions (seed 0), generated on the host
    once a run."""
    from fishnet_tpu_torch.models import train

    t0 = time.monotonic()
    dataset = train.diverse_position_dataset(TRAIN_SAMPLES, seed=0)
    log(f"train: {TRAIN_SAMPLES} diverse positions generated on the host in "
        f"{time.monotonic() - t0:.2f} s")
    return dataset


def train_kwargs(feature_set: str) -> dict:
    """train_material_net's arguments on the main path: TRAIN_STEPS steps
    of TRAIN_BATCH at TRAIN_LR over train_dataset() from seed 0, L1 64."""
    return dict(l1=64, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seed=0, dataset=train_dataset(),
                lr=TRAIN_LR, feature_set=feature_set)


def train_phase(feature_set: str = "board768") -> dict:
    """The trainer's main path on a board768 or king-bucketed
    ("halfkav2_hm") net: train_material_net on the card (TRAIN_STEPS steps
    of TRAIN_BATCH at lr TRAIN_LR over train_dataset() from the seeded
    init, L1 64 and the shipped layer stack). Fails unless the path's
    kernels (TRAIN_PATH_KERNELS: K1 or K17, K2, K14, K15 or K18, K16) each
    launched once a step and no plain version ran; holds the first
    TRAIN_CHECK_STEPS steps (losses and params) against the same run on
    the CPU's plain path; then profiles TRAIN_PROFILE_STEPS more steps:
    ms/step, device busy ms/step and the device's idle share (the host's
    share of a step). Returns the launch counts."""
    import numpy as np
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import train

    tag = "train" if feature_set == "board768" else f"train {feature_set}"
    path_kernels = TRAIN_PATH_KERNELS[feature_set]
    dataset = train_dataset()
    kw = train_kwargs(feature_set)
    runs = {}
    for dev in ("cuda", "cpu"):
        record = []

        def on_step(i, params, state, loss, record=record):
            if i < TRAIN_CHECK_STEPS:
                record.append((loss.clone(), train.flat_view(params).clone()))

        steps = TRAIN_STEPS if dev == "cuda" else TRAIN_CHECK_STEPS
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.monotonic()
        with count_plain_calls() as plain:
            params, loss = train.train_material_net(**dict(kw, steps=steps), device=dev,
                                                    on_step=on_step)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        runs[dev] = record
        if dev == "cuda":
            launches = dict(kernels.LAUNCHES)
            card_params, card_loss, card_wall = params, loss, wall
            missing = [k for k in path_kernels if launches[k] != TRAIN_STEPS]
            ran = {k: v for k, v in plain.items() if v}
            if missing or ran:
                raise AssertionError(f"{tag}: kernels {missing} did not launch once a step, "
                                     f"plain versions ran {ran} ({launches})")
            log(f"launches {tag}: {launches}; plain versions: {plain}")
        log(f"{tag} on {dev}: {steps} steps in {wall:.3f} s ({wall / steps * 1e3:.3f} ms/step, "
            f"the first step included), final loss {loss:.4f}")
    worst_loss = worst_param = 0.0
    for i, ((l_k, p_k), (l_c, p_c)) in enumerate(zip(runs["cuda"], runs["cpu"])):
        l_k, l_c = float(l_k), float(l_c)
        worst_loss = max(worst_loss, abs(l_k - l_c) / abs(l_c))
        worst_param = max(worst_param, float((p_k.cpu() - p_c).abs().max()))
        if i in (0, TRAIN_CHECK_STEPS - 1):
            log(f"{tag} step {i}: loss card {l_k} cpu {l_c}")
    log(f"{tag}: the first {TRAIN_CHECK_STEPS} steps, card against CPU: losses within "
        f"{worst_loss:.3g} relative (tolerance {TRAIN_LOSS_RTOL}), params within "
        f"{worst_param:.3g} (tolerance {TRAIN_PARAM_ATOL})")
    if not (worst_loss <= TRAIN_LOSS_RTOL and worst_param <= TRAIN_PARAM_ATOL):
        raise AssertionError(f"{tag}: the card's steps differ from the CPU's")
    if not np.isfinite(card_loss) or card_loss >= float(runs["cuda"][0][0]):
        raise AssertionError(f"{tag}: loss {card_loss} did not fall from {runs['cuda'][0][0]}")

    # where a step's time goes: TRAIN_PROFILE_STEPS more steps from the
    # trained net, the batches drawn as train_material_net draws them
    opt = train.adam(TRAIN_LR)
    state = opt.init(card_params)
    step = train.make_train_step(opt)
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    batches = [[torch.from_numpy(a[idx]) for a in dataset]
               for idx in rng.integers(0, TRAIN_SAMPLES, size=(TRAIN_PROFILE_STEPS, TRAIN_BATCH))]
    for b in batches[:3]:  # warm-up
        step(card_params, state, *[t.to(dev) for t in b])
    torch.cuda.synchronize()

    def run(b):
        nonlocal state
        _, state, _ = step(card_params, state, *[t.to(dev) for t in b])

    ms, idle, busy, source, events = profile_steps(run, batches)
    n = TRAIN_PROFILE_STEPS
    log(f"{tag} profile: wall {ms:.4f} ms/step (profiled; unprofiled, the "
        f"{TRAIN_STEPS}-step run above: {card_wall / TRAIN_STEPS * 1e3:.4f}), device busy "
        f"{busy:.4f} ms/step ({source}), device idle share (the host's share of a step) "
        f"{idle:.3f}, device entries {sum(e.count for e in events) / n:.2f}/step, batch "
        f"{TRAIN_BATCH}")
    for e in sorted(events, key=lambda e: -_device_us(e))[:8]:
        log(f"{tag} profile: {_device_us(e) / n:9.2f} us/step x{e.count / n:<5.2f} {e.key[:90]}")
    return launches


def profile_steps(run, batches) -> tuple:
    """run(b) for every batch b under torch.profiler, the card synchronised
    at the end → (wall ms a step, the device's idle share, device busy ms a
    step, where the busy time came from, the profiler's CUDA entries). The
    busy time is the profiler's sum of device time, or the window's
    CUDA-event time where it records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        start.record()
        for b in batches:
            run(b)
        end.record()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(_device_us(e) for e in events)
    source = "torch.profiler"
    if dev_us <= 0:  # no device time recorded: the window's CUDA-event time
        dev_us, source = start.elapsed_time(end) * 1e3, "CUDA events"
    n = len(batches)
    return (wall / n * 1e3, max(0.0, 1 - dev_us / 1e3 / (wall * 1e3)), dev_us / n / 1e3, source,
            events)


def kb_train_case(B: int, seed: int, dev) -> dict:
    """The inputs of K17 and K18 at batch B: a seeded king-bucketed f32 net
    (kb_case at the shipped widths, L1 64, packed), B diverse positions
    from the seed, their accumulators (the plain version's) and K14's
    plain d_acc for the loss's gradient by each score."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue, train

    boards, stms, targets = (torch.from_numpy(a).to(dev)
                             for a in train.diverse_position_dataset(B, seed=seed))
    params = train.pack_params(nnue.params_from_numpy(
        kb_case(*kernels.SHIPPED_WIDTHS, seed=seed), dev))
    acc = nnue.accumulators(params, boards)
    bucket = nnue.output_bucket(boards)
    pred = nnue.forward_from_acc_plain(params, acc, stms, bucket)
    d_pred = (2 * (pred - targets) / 1e4 / B).contiguous()
    d_acc, _ = train.stack_backward_plain(params, acc, stms, bucket, d_pred)
    return {"params": params, "boards": boards, "d_acc": d_acc.contiguous()}


def train_kb_kernel_phase(reps: int) -> dict:
    """K17 and K18 against their plain versions on the card at batch
    GRID_CALLER_BATCH and TRAIN_BATCH on a seeded king-bucketed net at L1
    64: K17 byte for byte, also on a tp shard's half of the columns; K18
    byte for byte the plain version run on the CPU (ft_check), also on
    FT_CASES. Then times at TRAIN_BATCH (kernel, plain, library; K18's
    passes on their own) with bounds from these inputs' bytes, and K16 over
    the king-bucketed flat buffer (equal to its plain version, timed beside
    it)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue, train

    dev = torch.device("cuda")
    stats = {k: {"max_abs_err": 0.0} for k in ("nnue_refresh_kb", "nnue_ft_backward_kb")}
    fx = sf_fixtures()
    for case in fx.KB_REFRESH_CASES:  # the widths and views, byte for byte card and CPU
        boards, w, b, _, _ = fx.kb_refresh_case(case, dev)
        got = kernels.nnue_refresh_kb(boards, w, b)
        plain = nnue.NnueParams(w, b, *[torch.zeros(1, device=dev)] * 6)
        want = nnue.accumulators(plain, boards)
        cpu = nnue.accumulators(plain.to("cpu"), boards.cpu())
        torch.cuda.synchronize()
        equal = torch.equal(got, want) and torch.equal(got.cpu(), cpu)
        log(f"check nnue_refresh_kb {case[0]} (batch {case[1]}, L1 {case[2]}, "
            f"{'16-byte' if case[2] % 4 == 0 and case[3] != 'offset' else '4-byte'} loads): "
            f"byte for byte the plain version on the card and on the CPU: {equal}")
        if not equal:
            raise AssertionError(f"nnue_refresh_kb {case[0]}: differs from its plain version")
    for B in (GRID_CALLER_BATCH, TRAIN_BATCH):
        c = kb_train_case(B, seed=B + 7, dev=dev)
        p, boards, d_acc = c["params"], c["boards"], c["d_acc"]
        l1 = p.ft_w.shape[1]
        n_ft = (nnue.NUM_FEATURES + 1) * l1
        acc_k = nnue.accumulators_kb(p, boards)
        acc_p = nnue.accumulators(p, boards)
        half = p._replace(ft_w=p.ft_w[:, l1 // 2:].contiguous(), ft_b=p.ft_b[l1 // 2:].contiguous())
        acc_h = nnue.accumulators_kb(half, boards)
        ft_k = torch.empty(n_ft, device=dev)
        torch.cuda.synchronize()
        err = float((acc_k - acc_p).abs().max())
        equal = torch.equal(acc_k, acc_p) and torch.equal(acc_h, acc_p[:, :, l1 // 2:])
        log(f"check nnue_refresh_kb B={B}: max_abs_err={err}; byte for byte, also on a tp "
            f"shard's {l1 // 2} columns: {equal} (tolerance 0)")
        if not equal:
            raise AssertionError(f"nnue_refresh_kb B={B}: differs from its plain version")
        stats["nnue_refresh_kb"]["max_abs_err"] = max(stats["nnue_refresh_kb"]["max_abs_err"], err)
        err = ft_check("halfkav2_hm", "seeded", boards, d_acc)
        stats["nnue_ft_backward_kb"]["max_abs_err"] = max(
            stats["nnue_ft_backward_kb"]["max_abs_err"], err)
        if B != TRAIN_BATCH:
            continue
        stats["nnue_ft_backward_kb"]["max_abs_err"] = max(
            stats["nnue_ft_backward_kb"]["max_abs_err"], ft_fixtures("halfkav2_hm"))

        # times at the training batch
        feats = full_eval_features(boards)  # (B, 2, 64)
        live = feats >= 0
        idx = feats[live].long()
        pieces = int(live.sum())
        acc_bytes = B * 2 * l1 * 4
        bag_off = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             live.view(B * 2, 64).sum(1).cumsum(0)[:-1]])
        src = d_acc[:, :, None, :].expand(B, 2, 64, l1)[live].contiguous()
        lib_ft = torch.zeros((nnue.NUM_FEATURES, l1), device=dev)
        table = {
            "nnue_refresh_kb": (
                lambda: nnue.accumulators_kb(p, boards),
                lambda: nnue.accumulators(p, boards),
                lambda: F.embedding_bag(idx, p.ft_w, bag_off, mode="sum") + p.ft_b,
                # boards in, each distinct row the batch selects and ft_b once, acc out
                B * 256 + int(idx.unique().numel()) * l1 * 4 + l1 * 4 + acc_bytes,
                pieces * l1 + 2 * B * l1,
            ),
            "nnue_ft_backward_kb": (
                lambda: train.ft_backward_kb(boards, d_acc, ft_k),
                lambda: train.ft_backward_kb_plain(boards, d_acc),
                lambda: lib_ft.index_add_(0, idx, src),
                # d_acc and boards in, the whole gradient out
                acc_bytes + B * 256 + n_ft * 4,
                pieces * l1 + 2 * B * l1,
            ),
        }
        for name, (kern, plain, lib, nbytes, nops) in table.items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / F32_OPS_PER_S * 1e3
            (ms, call_ms), (plain_ms, plain_call) = time_ms(kern, reps), time_ms(plain, reps)
            lib_ms, lib_call = time_ms(lib, reps)
            stats[name].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")
            log(f"time {name} B={B} L1 {l1} (device ms / call ms): kernel {ms:.5f} / "
                f"{call_ms:.5f}, plain {plain_ms:.5f} / {plain_call:.5f}, library {lib_ms:.5f} / "
                f"{lib_call:.5f}, bound {stats[name]['bound_ms']:.6f} ({stats[name]['bound_by']}); "
                f"{pieces} rows summed")
        stats["nnue_ft_backward_kb"].update(ft_times("halfkav2_hm", boards, d_acc, reps))

        # K16 over the king-bucketed flat buffer
        n = train.flat_view(p).numel()
        rng = np.random.default_rng(B)

        def f32(a):
            return torch.from_numpy(a.astype(np.float32)).to(dev)

        grad, mu, nu = f32(rng.normal(size=n) * 1e-2), f32(rng.normal(size=n) * 1e-3), f32(
            rng.random(n) * 1e-5)
        opt = train.Adam(TRAIN_LR)
        bc = opt.bias_corrections(8)
        bufs_k = [train.flat_view(p).clone(), grad, mu.clone(), nu.clone()]
        bufs_p = [train.flat_view(p).clone(), grad, mu.clone(), nu.clone()]
        kernels.adam_update(*bufs_k, opt.lr, opt.b1, opt.b2, opt.eps, *bc)
        train.adam_update_plain(*bufs_p, opt.lr, opt.b1, opt.b2, opt.eps, *bc)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(bufs_k, bufs_p)):
            raise AssertionError("adam_update over the king-bucketed flat buffer differs from "
                                 "its plain version")
        lib_p = torch.nn.Parameter(bufs_k[0].clone())
        lib_p.grad = grad.clone()
        lib_opt = torch.optim.Adam([lib_p], lr=TRAIN_LR, fused=True)
        (ms, call_ms), (plain_ms, _), (lib_ms, _) = [time_ms(f, reps) for f in (
            lambda: kernels.adam_update(*bufs_k, opt.lr, opt.b1, opt.b2, opt.eps, *bc),
            lambda: train.adam_update_plain(*bufs_p, opt.lr, opt.b1, opt.b2, opt.eps, *bc),
            lib_opt.step)]
        bound = 7 * 4 * n / HBM_BYTES_PER_S * 1e3
        stats["adam_update_kb_flat"] = dict(n=n, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                                            bound_ms=bound, bound_by="bytes")
        log(f"check adam_update king-bucketed flat buffer ({n} floats): equal to its plain "
            f"version; time kernel {ms:.5f} / {call_ms:.5f} ms, plain {plain_ms:.5f}, library "
            f"{lib_ms:.5f}, bound {bound:.6f} (bytes)")
    return stats


def grid_batches() -> list:
    """3 x GRID_STEPS batches of TRAIN_BATCH drawn from train_dataset()
    (seed 5): grid_phase's checked, timed and profiled steps."""
    import numpy as np
    import torch

    dataset = train_dataset()
    rng = np.random.default_rng(5)
    return [[torch.from_numpy(a[idx]) for a in dataset] for idx in rng.integers(
        0, TRAIN_SAMPLES, size=(3 * GRID_STEPS, TRAIN_BATCH))]


def grid_run(feature_set: str, devs, batches) -> tuple:
    """make_sharded_train_step on make_2d_mesh(*GRID, devs) from the seeded
    init at L1 64, a step a batch → (every position's params, the Adam
    state, the step, the grid's first device, the losses)."""
    import torch

    from fishnet_tpu_torch.models import nnue, train
    from fishnet_tpu_torch.parallel import mesh as mesh_mod

    net = nnue.init_params(torch.Generator().manual_seed(0), l1=64, feature_set=feature_set,
                           device="cpu")
    grid = mesh_mod.make_2d_mesh(*GRID, devs)
    params = mesh_mod.shard_params_tp(net, grid)
    opt = train.adam(TRAIN_LR)
    state = opt.init(params)
    step = train.make_sharded_train_step(grid, opt)
    dev = grid[0][0]
    losses = []
    for b in batches:
        params, state, loss = step(params, state, *[t.to(dev) for t in b])
        losses.append(loss)
    return params, state, step, dev, losses


def grid_bound_ms(params, batch) -> float:
    """The least time a step of the GRID grid could take at TRAIN_BATCH:
    the sum over its positions of each of their kernels' byte bounds (the
    kernel phases' formulas) at the position's shapes: its refresh (K1 or
    K17) over its rows' boards and its column block, K2 and K14 on its
    gathered accumulators, K15 or K18 on its block of d_acc, K16 over its
    flat buffer. params: the grid's (grid_run), batch: one step's."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue, train
    from fishnet_tpu_torch.parallel import mesh as mesh_mod

    dp, tp = GRID
    boards = batch[0]
    parts = mesh_mod.shard_batch(mesh_mod.make_2d_mesh(dp, tp, ["cpu"] * (dp * tp)), boards)
    total = 0
    for i in range(dp):
        for j in range(tp):
            p, b = params[i][j], parts[i][j].cpu()
            rows, cols = p.ft_w.shape
            B, l1 = b.shape[0], cols * tp
            if rows == nnue.NUM_FEATURES_768:
                sq = torch.arange(64, dtype=torch.int32)
                idx = torch.stack([nnue.feature_index_768(b, sq, q) for q in (0, 1)], 1)
            else:
                idx = full_eval_features(b)
            used = int(nnue.output_bucket(b).unique().numel())
            head = used * sum(t[0].numel() * 4 for t in p[2:])
            acc_block, acc = B * 2 * cols * 4, B * 2 * l1 * 4
            total += (B * 256 + int(idx[idx >= 0].unique().numel()) * cols * 4 + cols * 4
                      + acc_block)  # K1 or K17
            total += acc + B * 8 + head + B * 4  # K2
            total += acc + B * 12 + head + acc + kernels.STACK_GRADS * 4  # K14
            total += acc_block + B * 256 + (rows + 1) * cols * 4  # K15 or K18
            total += 7 * 4 * train.flat_view(p).numel()  # K16
    return total / HBM_BYTES_PER_S * 1e3


def grid_phase() -> dict:
    """The dp×tp step (models/train.py make_sharded_train_step) on
    make_2d_mesh(*GRID, ["cuda:0"] * 8) at TRAIN_BATCH, from the seeded
    init at L1 64, for a board768 and a king-bucketed net: GRID_STEPS steps
    in which every position launches its refresh (K1 or K17), K2, K14, its
    feature-transform backward (K15 or K18) and K16 once a step and no
    plain version runs; the losses of every step and every position's
    params after them held against the same grid of `cpu` devices (the
    trainer's tolerances); then GRID_STEPS steps timed (host clock, the
    card synchronised at the end) and GRID_STEPS profiled (device busy,
    the host's share). → {feature set: its counts and times}."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import train

    dp, tp = GRID
    out = {}
    for fs, path_kernels in TRAIN_PATH_KERNELS.items():
        tag = f"grid {dp}x{tp} {fs}"
        batches = grid_batches()
        runs = {}
        for devs in (["cuda:0"] * (dp * tp), ["cpu"] * (dp * tp)):
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.monotonic()
            with count_plain_calls() as plain:
                params, state, step, dev, losses = grid_run(fs, devs, batches[:GRID_STEPS])
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            runs[dev.type] = (losses, params)
            log(f"{tag} on {dev}: {GRID_STEPS} steps in {wall:.3f} s (the first included), "
                f"final loss {float(losses[-1]):.4f}")
            if dev.type != "cuda":
                continue
            launches = dict(kernels.LAUNCHES)
            want = dp * tp * GRID_STEPS
            wrong = {k: launches[k] for k in path_kernels if launches[k] != want}
            ran = {k: v for k, v in plain.items() if v}
            log(f"launches {tag}: {launches}; plain versions: {plain}")
            if wrong or ran:
                raise AssertionError(f"{tag}: kernels {wrong} did not launch {want} times (once a "
                                     f"step a position), plain versions ran {ran}")
            card = (params, state, step, dev, launches)
        (l_k, p_k), (l_c, p_c) = runs["cuda"], runs["cpu"]
        worst_loss = max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(l_k, l_c))
        worst_param = max(float((train.flat_view(a).cpu() - train.flat_view(b)).abs().max())
                          for ra, rb in zip(p_k, p_c) for a, b in zip(ra, rb))
        log(f"{tag}: {GRID_STEPS} steps, card against CPU: losses within {worst_loss:.3g} "
            f"relative (tolerance {TRAIN_LOSS_RTOL}), every position's params within "
            f"{worst_param:.3g} (tolerance {TRAIN_PARAM_ATOL})")
        if not (worst_loss <= TRAIN_LOSS_RTOL and worst_param <= TRAIN_PARAM_ATOL):
            raise AssertionError(f"{tag}: the card's grid differs from the CPU's")
        params, state, step, dev, launches = card

        def run(b):
            nonlocal params, state
            params, state, _ = step(params, state, *[t.to(dev) for t in b])

        timed = batches[GRID_STEPS:2 * GRID_STEPS]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for b in timed:
            run(b)
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) * 1e3 / len(timed)
        prof_ms, idle, busy, source, events = profile_steps(run, batches[2 * GRID_STEPS:])
        per_step = sum(launches.values()) / GRID_STEPS
        bound = grid_bound_ms(p_c, batches[0])
        log(f"{tag} time: {ms:.4f} ms/step unprofiled (batch {TRAIN_BATCH}, {dp * tp} positions "
            f"of one card); profiled {prof_ms:.4f} ms/step, device busy {busy:.4f} ms/step "
            f"({source}), device idle share (the host's share of a step) {idle:.3f}; "
            f"{per_step:.1f} kernel launches a step, device entries "
            f"{sum(e.count for e in events) / GRID_STEPS:.2f}/step; bound {bound:.6f} ms a step "
            f"(bytes: its positions' kernels)")
        out[fs] = {"launches": launches, "ms_per_step": ms, "idle_share": idle,
                   "busy_ms_per_step": busy, "launches_per_step": per_step, "bound_ms": bound}
    return out


# ------------------------------------------------------------- variants

# the device variants besides standard chess (ops/tables.py
# VARIANT_ID), and per variant the FENs its seeded positions start
# from beside its starting position: a game end one move away (a third
# check, the hill, the goal rank with and without a rejoinder, the horde's
# last pawn, antichess's forced capture and its last piece, crazyhouse's
# mating drop), threeCheck counters, promotions (antichess's to a king),
# horde's first-rank pawns, and crazyhouse's pockets (mid, heavy, and full:
# ZH_POCKETS), promoted pieces (a promotion, the capture of a promoted
# queen, promoted bits in both words: h4 is bit 31) and a pocket pawn
# whose only empty squares are on the first and last ranks
VARIANTS = ("threeCheck", "kingOfTheHill", "racingKings", "horde", "antichess", "crazyhouse",
            "atomic")
# crazyhouse's pockets by size: a few pieces, both sides' every type (243
# moves, past standard chess's MAX_MOVES), and every type in an empty board's
# pockets (299 moves: 4 x 62 drops, 48 pawn drops, 3 king moves)
ZH_POCKETS = {
    "mid pockets": "r2qkb1r/ppp2ppp/2n1bn2/3pp3/4P3/2NP1N2/PPP2PPP/R1BQKB1R[BPp] w KQkq - 0 6",
    "heavy pockets": "r3k2r/ppp2ppp/8/8/8/8/PPP2PPP/R3K2R[QRBNPPqrbnpp] w KQkq - 0 12",
    "full pockets": "7k/8/8/8/8/8/8/K7[QRBNPqrbnp] w - - 0 30",
}
VARIANT_FENS = {
    "threeCheck": ["4k3/8/8/8/8/8/3Q4/4K3 w - - +2+0 0 1",
                   "rnbqkbnr/pppp1ppp/8/4p3/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - +2+1 0 3",
                   "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 1+2 0 1"],
    "kingOfTheHill": ["7k/8/8/8/8/3K4/8/8 w - - 0 1", "8/8/3k4/8/8/3K4/8/8 b - - 0 1"],
    "racingKings": ["8/6K1/8/8/8/8/8/k7 w - - 0 1", "6K1/k7/8/8/8/8/8/8 b - - 0 1"],
    "horde": ["4k3/8/8/8/8/8/q6P/8 b - - 0 1", "4k3/8/8/8/8/8/8/PP2PP1P w - - 0 1"],
    "antichess": ["rnbqkbnr/ppp1pppp/8/3p4/4P3/8/PPPP1PPP/RNBQKBNR w - - 0 2",
                  "8/8/8/8/2q5/3q4/2P5/8 w - - 0 1", "8/1P6/8/8/8/8/6p1/2k5 w - - 0 1"],
    "crazyhouse": [*ZH_POCKETS.values(),
                   "6k1/5ppp/8/8/8/8/5PPP/6K1[R] w - - 0 1",
                   "k6K/8/8/8/8/8/p7/1R6[] b - - 0 1", "k6K/8/8/8/8/8/8/q~R6[] w - - 0 2",
                   "3k3Q~/8/8/8/r6N~/8/8/4K3[Pb] b - - 0 20",
                   "4k3/pppppppp/pppppppp/pppppppp/PPPPPPPP/PPPPPPPP/PPPPPPPP/4K3[Pp] w - - 0 1"],
    "atomic": ["3nk3/8/8/8/8/8/8/3QK3 w - - 0 1",  # Qxd8 explodes the king and wins
               "4k3/8/8/8/8/8/1r6/nR2K3 w - - 0 1",  # Rxb2's blast reaches a1
               "k7/8/2n1b3/3p4/8/8/8/K2Q4 w - - 0 1",  # Qxd5 takes c6 and e6 with it
               "k7/8/8/2pp4/3P4/8/8/K7 w - - 0 1",  # pawns survive a blast
               "k7/8/8/8/8/8/1p6/K7 w - - 0 1",  # the king cannot take b2
               "8/8/8/8/8/1k6/1K6/4Q3 w - - 0 1",  # adjacent kings: no check
               "4k3/8/8/8/8/8/3p4/3QK3 w - - 0 1",  # in check; Qxd2 would blow up its king
               "r3k2r/6p1/8/8/8/8/1B6/R3K2R w KQkq - 0 1",  # Bxg7 blows up h8: KQq
               "k7/2n5/8/3pP3/8/8/8/K7 w - d6 0 2"],  # an en-passant blast
}
# per variant, root sets its K9 and K11 checks also take, each every lane
# at one FEN (crazyhouse: ZH_POCKETS)
ROOT_CASES = {"crazyhouse": ZH_POCKETS}
VARIANT_SEGMENT_STEPS = (1, 7, 33, 100)  # K11's checked segments per variant
VARIANT_SEGMENT_CONFIGS = ("table", "helpers")
VARIANT_REPS = 50  # launches per variant kernel timing
VARIANT_PARITY_POSITIONS = 1  # positions of each variant's card-against-CPU chunk
VARIANT_PARITY_MAX_PLY = 8
BF16_PARITY_POSITIONS = 2  # positions of the bf16 card-against-CPU chunk


def variant_positions(variant: str, n: int, seed: int, fens=None, ends: bool = True,
                      restart: float = 0.03) -> list:
    """n positions of a device variant → [(position, the FEN its playout
    started from, the UCI moves from there)]: the FENs (VARIANT_FENS
    unless given), then seeded random playouts from them and from the
    starting position. A playout restarts by chance (`restart` a ply), at
    90 halfmoves and at a game's end, which it keeps; with ends=False it
    never steps into one (the moves left are played, else it restarts)."""
    from fishnet_tpu_torch.chess import position_class

    cls = position_class(variant)
    rng = random.Random(seed)
    starts = [cls.from_fen(f) for f in (VARIANT_FENS[variant] if fens is None else fens)]
    starts = [p for p in starts + [cls.initial()] if ends or p.outcome() is None]
    out = [(p, p.to_fen(), []) for p in starts[:n]]
    pos = None
    while len(out) < n:
        if pos is None or pos.halfmove >= 90 or rng.random() < restart or pos.outcome() is not None:
            pos = rng.choice(starts)
            fen, moves = pos.to_fen(), []
            continue
        legal = pos.legal_moves()
        if not ends:
            legal = [m for m in legal if pos.push(m).outcome() is None]
            if not legal:
                pos = None
                continue
        move = rng.choice(legal)
        pos, moves = pos.push(move), moves + [move.uci()]
        out.append((pos, fen, moves))
    return out


def variant_segment_phase(params_f32, reps: int, kb_net) -> dict:
    """K11 against run_segment_plain in each device variant on the card,
    states, tables and summaries byte for byte and the step counts equal:
    at 16 and 64 lanes (the main path's width) of rules_inputs' roots,
    both nets, VARIANT_SEGMENT_CONFIGS' table setups, segments of
    VARIANT_SEGMENT_STEPS in turn (atomic, whose board768 leaf is its own,
    also at 16 lanes on the king-bucketed net kb_net, under K12's body);
    then at 64 lanes on the main path's
    table setup ("engine"), one segment of 200 steps, which is also timed
    (CUDA events, from the same state each launch) beside the plain
    version's wall and the bound from the bytes the timed segment moves;
    the same for each of the variant's ROOT_CASES (every root at one
    FEN). → {variant: {max_abs_err, ms, plain_ms,
    bound_ms, bound_by, library_ms, us_per_step, steps, and per root case
    under "roots" its ms, plain_ms, bound_ms, bound_by, us_per_step,
    steps}}."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import search

    dev = torch.device("cuda")
    nets = {"f32": params_f32, "int8": nnue.quantize_int8(params_f32)}
    out = {}

    def check(row, label, params, state, table, kw, steps):
        """One segment through K11 and through run_segment_plain on a
        clone of the state, compared → (steps, the plain version's ms)."""
        plain, plain_table = _clone(state, table)
        n_k, sum_k = search.run_segment(params, state, steps, True, **kw)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        n_p, sum_p = search.run_segment_plain(params, plain, steps, True,
                                              **dict(kw, table=plain_table))
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        err = _state_diff(state, plain, table, plain_table)
        err = max(err, float((sum_k.long() - sum_p.long()).abs().max()))
        B = state.lane.shape[0]
        done = int(sum_k[:B, search.SUM_DONE].sum())
        log(f"check search_segment {label} segment {steps}: steps {n_k} (plain {n_p}), done "
            f"{done}/{B}, max_abs_err={err} (tolerance 0, grid {kernels.LAST_GRID['blocks']} "
            f"blocks)")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if err != 0 or n_k != n_p:
            raise AssertionError(f"search_segment {label} segment {steps}: K11 differs from "
                                 f"run_segment_plain (steps {n_k} / {n_p})")
        return n_k, plain_ms

    def engine_segment(row, v, label, fens) -> dict:
        """The main path's 64-lane setup on rules_inputs' roots (every lane
        at the FEN of `fens`, a one-FEN list, where given): one segment of
        SEGMENT_STEPS[-1] steps checked, then timed from the same state each
        launch."""
        state0, table0, kw = segment_case(params_f32, 64, "engine", seed=64, dev=dev, variant=v,
                                          fens=None if fens is None else fens * 64)
        state, table = _clone(state0, table0)
        kw = dict(kw, table=table)
        steps = SEGMENT_STEPS[-1]
        _, plain_ms = check(row, f"{v} B=64 f32 {label}", params_f32, state, table, kw, steps)
        times = []
        for _ in range(reps):
            for t, t0 in zip(list(state) + [table], list(state0) + [table0]):
                t.copy_(t0)
            kernels.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            n, _ = search.run_segment(params_f32, state, steps, True, **kw)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        ms = sum(times) / len(times)
        calls = kernels.body_calls()
        nbytes = segment_bytes(calls, 2 * 64 * 4, v)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"time search_segment {v} B=64 {label} table (CUDA events, {reps} launches): "
            f"{ms:.4f} ms per segment of {n} steps, {ms / max(n, 1) * 1e3:.2f} us/step; plain "
            f"{plain_ms:.1f} ms ({plain_ms / max(n, 1):.3f} ms/step); bound {bound:.6f} ms "
            f"(bytes, {nbytes} bytes; counters {calls}); grid {kernels.LAST_GRID['blocks']} "
            f"blocks")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=None,
                    us_per_step=ms / max(n, 1) * 1e3, steps=n)

    for v in VARIANTS:
        t0 = time.monotonic()
        row = out[v] = {"max_abs_err": 0.0}
        for B in (16, 64):
            for net, params in nets.items():
                for cfg in VARIANT_SEGMENT_CONFIGS:
                    state, table, kw = segment_case(params, B, cfg, seed=B + len(cfg), dev=dev,
                                                    variant=v)
                    for steps in VARIANT_SEGMENT_STEPS:
                        check(row, f"{v} B={B} {net} {cfg}", params, state, table, kw, steps)
        if v == "atomic":
            state, table, kw = segment_case(kb_net, 16, "helpers", seed=16, dev=dev, variant=v)
            for steps in VARIANT_SEGMENT_STEPS:
                check(row, f"{v} B=16 kb int8 helpers", kb_net, state, table, kw, steps)

        # the main path's setup at its width, then each root case's:
        # checked, then timed
        row.update(engine_segment(row, v, "engine", None))
        for label, fen in ROOT_CASES.get(v, {}).items():
            row.setdefault("roots", {})[label] = engine_segment(row, v, label, [fen])
        log(f"search_segment {v}: checked and timed in {time.monotonic() - t0:.1f} s")
    return out


def variant_chunk(variant: str, n_positions: int, depth: int):
    """make_chunk for a device variant: n_positions of one seeded game
    (variant_positions from the starting position, never into a game end)
    after 4, 6, ... plies, each as the start and the moves played."""
    from fishnet_tpu_torch.ipc import AnalysisWork, Chunk, EngineFlavor, NodeLimit, WorkPosition

    work = AnalysisWork(id=f"chipsmoke-{variant}",
                        nodes=NodeLimit(sf16=50_000_000, classical=50_000_000),
                        timeout_s=600.0, depth=depth)
    game = variant_positions(variant, 2 * n_positions + 4, seed=len(variant), fens=(),
                             ends=False, restart=0.0)
    plies = [(fen, moves) for _, fen, moves in game if len(moves) >= 4 and len(moves) % 2 == 0]
    positions = [
        WorkPosition(work=work, position_index=i, url=None, skip=False, root_fen=fen,
                     moves=moves)
        for i, (fen, moves) in enumerate(plies[:n_positions])
    ]
    return Chunk(work=work, deadline=time.monotonic() + 900, variant=variant,
                 flavor=EngineFlavor.TPU, positions=positions)


def variant_engine_phase(params_f32, depth: int, n_positions: int) -> dict:
    """One chunk of each device variant through GpuEngine() with its
    defaults (refill, 2^21 table, K helpers, MAX_PLY 32): every position
    reaches `depth` with a legal best move under the variant's rules, the
    search's kernels launched (check_launches; also K4 on the game
    history, and K11 through the variant's own entry point) and no plain
    version of the search path ran. → {variant: the chunk's counts and
    wall}."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.chess import from_fen
    from fishnet_tpu_torch.engine.gpu import GpuEngine

    out = {}
    for v in VARIANTS:
        engine = GpuEngine(params=params_f32, max_depth=depth)
        assert engine.refill and engine.tt.shape[0] == 1 << 21 and engine.max_ply == 32
        chunk = variant_chunk(v, n_positions, depth)
        path = f"engine chunk, {v} (variant main path)"
        kernels.reset_launches()
        t0 = time.monotonic()
        with count_plain_calls(search_plain_twins()) as plain:
            responses = asyncio.run(engine.go_multiple(chunk))
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = check_launches(path, engine=True, variant=v)
        if any(plain.values()):
            raise AssertionError(f"{path}: plain versions ran on the card: {plain}")
        entry = kernels._variant_symbol("search_segment_f32", v)
        entries = dict(kernels.LAUNCHES_BY_ENTRY)
        if not (launches["zobrist_hash"] and entries.get(entry)):
            raise AssertionError(f"{path}: K4 or {entry} not launched ({entries})")
        calls = kernels.body_calls()
        drops = sum("@" in r.best_move for r in responses)
        for wp, res in zip(chunk.positions, responses):
            pos = from_fen(wp.root_fen, v)
            for uci in wp.moves:
                pos = pos.push(pos.parse_uci(uci))
            if res.depth != depth:
                raise AssertionError(f"{path}: position {wp.position_index} reached depth "
                                     f"{res.depth}")
            pos.parse_uci(res.best_move)  # raises if not legal under the variant
            score = res.scores.best()
            log(f"{path}: position {wp.position_index} ({len(wp.moves)} plies): best "
                f"{res.best_move} score {score.kind} {score.value} nodes {res.nodes}")
        tot = engine.occupancy_totals
        nodes = sum(r.nodes for r in responses)
        row = out[v] = {"positions": len(responses), "wall_s": wall, "steps": tot["steps"],
                        "segments": tot["segments"], "refills": tot["refills"], "nodes": nodes,
                        "nodes_per_s": nodes / wall, "launches": launches, "body_calls": calls,
                        "drops_in_best_moves": drops}
        log(f"{path}: {len(responses)} positions depth {depth}, nodes {nodes} steps "
            f"{tot['steps']} segments {tot['segments']} refills {tot['refills']} wall "
            f"{wall:.3f} s ms/step {wall / max(tot['steps'], 1) * 1e3:.3f} nodes/s "
            f"{nodes / wall:.0f} host_ms {tot['host_ms']:.3f} device_ms {tot['device_ms']:.3f} "
            f"launches by entry {entries} drops among best moves {drops}")
    return out


def _parity_wire(engine, chunk) -> tuple[list, float]:
    """A chunk through engine → (its responses on the wire without time
    and nps, the wall in seconds)."""
    from fishnet_tpu_torch import ipc

    t0 = time.monotonic()
    responses = asyncio.run(engine.go_multiple(chunk))
    wall = time.monotonic() - t0
    wire = []
    for r in responses:
        w = ipc.response_to_wire(r)
        w.pop("time_s")
        w.pop("nps")
        wire.append(w)
    return wire, wall


def _variant_parity_engine(params, depth: int, dev: str, shards: int = 0):
    """The parity engine on `dev`, its lanes sharded over `shards` shards of
    it when shards > 0 (a table a shard)."""
    from fishnet_tpu_torch.engine.gpu import GpuEngine
    from fishnet_tpu_torch.parallel.mesh import make_mesh

    return GpuEngine(params=params, max_depth=depth, tt_size_log2=TT_PARITY_LOG2,
                     helper_lanes=2, refill=True, device=dev,
                     mesh=make_mesh([dev] * shards) if shards else None)


def _variant_parity_cpu(variant: str, n_positions: int, depth: int,
                        params_blob: bytes, shards: int = 0) -> tuple[list, float]:
    """variant_parity_phase's CPU side in a worker process, one thread:
    the pickled net's chunk of `variant` through GpuEngine on the CPU (on
    `shards` CPU shards when > 0) → _parity_wire."""
    import pickle

    import torch

    os.environ["FISHNET_TPU_MAX_PLY"] = str(VARIANT_PARITY_MAX_PLY)
    torch.set_num_threads(1)
    engine = _variant_parity_engine(pickle.loads(params_blob), depth, "cpu", shards)
    return _parity_wire(engine, variant_chunk(variant, n_positions, depth))


def f32_rule(got: list, want: list, depth: int) -> int:
    """The f32 rule of two engines' answers to one chunk (responses on
    the wire): at every position the same depth, `depth`, and the same
    best move, and every score of its lines within 2 cp (mates equal).
    → the largest score difference in cp; AssertionError where they
    break the rule."""
    if len(got) != len(want):
        raise AssertionError(f"f32 rule: {len(got)} responses against {len(want)}")
    worst = 0
    for g, w in zip(got, want):
        gs, ws = sum(g["scores"], []), sum(w["scores"], [])
        if not (g["depth"] == w["depth"] == depth and g["best_move"] == w["best_move"]
                and g["best_move"] is not None and len(gs) == len(ws)):
            raise AssertionError(f"f32 rule: {g} against {w}")
        for gc, wc in zip(gs, ws):
            if (gc is None) != (wc is None):
                raise AssertionError(f"f32 rule: scores {g['scores']} against {w['scores']}")
            if gc is not None:
                (gk, gv), = gc.items()
                (wk, wv), = wc.items()
                if gk != wk or abs(gv - wv) > (0 if gk == "mate" else 2):
                    raise AssertionError(f"f32 rule: scores {g['scores']} against {w['scores']}")
                worst = max(worst, abs(gv - wv))
    return worst


def variant_parity_phase(params_f32, depth: int) -> None:
    """An int8 chunk of each device variant (VARIANT_PARITY_POSITIONS
    positions, `depth`) through GpuEngine on the card and on the CPU,
    with refill, a 2^TT_PARITY_LOG2 table and 2 helper lanes at MAX_PLY
    VARIANT_PARITY_MAX_PLY: the responses equal (but for time and nps).
    Then, the same way, a standard chunk of BF16_PARITY_POSITIONS on the
    bf16 net (cast_params): card and CPU by the f32 rule, since K2's sums
    differ from the plain version's in their last bits; and an int8
    standard chunk of MESH_PARITY_POSITIONS on a MESH_SHARDS-shard mesh
    (a table a shard), cuda:0's shards against CPU shards, responses
    equal. The CPU sides, nearly all of the phase's time, run at once in
    a pool of spawned worker processes (one a chunk, at most one a core)
    while the card's run here."""
    import multiprocessing
    import pickle
    from concurrent.futures import ProcessPoolExecutor

    from fishnet_tpu_torch.models import nnue

    params_i8 = nnue.quantize_int8(params_f32)
    cases = [(v, v, "int8", params_i8, VARIANT_PARITY_POSITIONS, 0) for v in VARIANTS] + [
        (f"standard, {MESH_SHARDS}-shard mesh", "standard", "int8", params_i8,
         MESH_PARITY_POSITIONS, MESH_SHARDS),
        ("standard, bf16 weights", "standard", "bf16", nnue.cast_params(params_f32),
         BF16_PARITY_POSITIONS, 0)]
    saved = os.environ.get("FISHNET_TPU_MAX_PLY")
    os.environ["FISHNET_TPU_MAX_PLY"] = str(VARIANT_PARITY_MAX_PLY)
    workers = max(1, min(len(cases), os.cpu_count() or 1))
    try:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            cpu = [pool.submit(_variant_parity_cpu, v, n, depth, pickle.dumps(net.to("cpu")),
                               shards) for _, v, _, net, n, shards in cases]
            for (label, v, kind, net, n, shards), future in zip(cases, cpu):
                chunk = variant_chunk(v, n, depth)
                engine = _variant_parity_engine(net.to("cuda"), depth, "cuda:0", shards)
                if shards and (engine.n_dev != shards or len(engine.tt) != shards):
                    raise AssertionError(f"variant parity {label}: {engine.n_dev} shards")
                card, card_wall = _parity_wire(engine, chunk)
                want, cpu_wall = future.result()
                if kind == "int8" and card != want:
                    raise AssertionError(f"variant parity {label}: card {card} != cpu {want}")
                agree = ("card == cpu responses (score, pv, depth, nodes, best move)"
                         if kind == "int8" else
                         f"card and cpu agree by the f32 rule (best moves "
                         f"{[g['best_move'] for g in card]}, largest score difference "
                         f"{f32_rule(card, want, depth)} cp, responses "
                         f"{'equal' if card == want else 'not equal'})")
                log(f"variant parity {label}: {kind} chunk of {len(chunk.positions)} depth "
                    f"{depth}: {agree}; card {card_wall:.3f} s, cpu {cpu_wall:.3f} s (one of "
                    f"{workers} worker processes, one thread each)")
    finally:
        if saved is None:
            os.environ.pop("FISHNET_TPU_MAX_PLY", None)
        else:
            os.environ["FISHNET_TPU_MAX_PLY"] = saved


# bf16 weights (FISHNET_TPU_DTYPE=bf16, cast_params): the entry points
# that read them, each beside the f32 kernel of the same name
BF16_ENTRIES = ("nnue_refresh_768_bf16", "nnue_forward_from_acc_bf16",
                "nnue_acc_update_768_bf16", "nnue_evaluate_bf16", "search_segment_bf16")


def _bit_diff(a, b) -> float:
    """The largest difference between two f32 tensors' bit patterns; 0
    when byte-equal."""
    import torch

    return float((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def bf16_kernel_phase(params_f32, kb_f32, reps: int) -> dict:
    """K1, K2, K3 (the shipped net) and K12 (the king-bucketed net at
    KB_WIDTHS) on bf16 weights (cast_params), through their _bf16 entry
    points, at 16, 64 and 1024 lanes of seeded playout boards: each
    against its plain version (K1 and K3 byte for byte, K2 and K12 within
    F32_EVAL_TOL) and against the f32 kernel on the same weights widened
    to f32 (byte for byte). Times at 1024 lanes (K12 with a cold L2, its
    repeated-call time as ms_l2_warm), the f32 kernel's on the widened
    weights beside them, the plain version's, and the bound from the bf16
    bytes. No one PyTorch call computes f32 sums of bf16 rows
    (embedding_bag on bf16 weights sums in bf16), so library_ms is None.
    → {entry: stats}."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops.board import move_piece_changes

    dev = torch.device("cuda")
    p16 = nnue.cast_params(params_f32)
    k16 = nnue.cast_params(kb_f32)
    wide = {"board768": nnue.widened(p16), "kb": nnue.widened(k16)}
    nets = {"board768": p16, "kb": k16}
    stats = {name: {"max_abs_err": 0.0} for name in BF16_ENTRIES[:4]}
    scrub = torch.empty(L2_SCRUB_BYTES, dtype=torch.uint8, device=dev)
    for B in (16, 64, 1024):
        cpu_boards, moves = playout_boards(B, seed=B + 3)
        b = cpu_boards.to(dev)
        mv = torch.tensor([encode(m) for m in moves], dtype=torch.int32, device=dev)
        codes, sqs, signs = move_piece_changes(b, mv)
        bucket = nnue.output_bucket(b.board)
        acc = nnue.accumulators_768_plain(p16, b.board)
        cases = {
            "nnue_refresh_768_bf16": (
                "board768", lambda p: nnue.accumulators_768(p, b.board),
                lambda: nnue.accumulators_768_plain(p16, b.board), 0.0),
            "nnue_acc_update_768_bf16": (
                "board768", lambda p: nnue.apply_acc_updates_768(p, acc, codes, sqs, signs),
                lambda: nnue.apply_acc_updates_768_plain(p16, acc, codes, sqs, signs), 0.0),
            "nnue_forward_from_acc_bf16": (
                "board768", lambda p: nnue.forward_from_acc(p, acc, b.stm, bucket),
                lambda: nnue.forward_from_acc_plain(p16, acc, b.stm, bucket), nnue.F32_EVAL_TOL),
            "nnue_evaluate_bf16": (
                "kb", lambda p: nnue.evaluate(p, b.board, b.stm),
                lambda: nnue.evaluate_plain(k16, b.board, b.stm), nnue.F32_EVAL_TOL),
        }
        for name, (net, kern, plain, tol) in cases.items():
            kernels.reset_launches()
            got = kern(nets[net])
            entries = {k: v for k, v in kernels.LAUNCHES_BY_ENTRY.items() if v}
            if entries != {name: 1}:
                raise AssertionError(f"{name} B={B}: launched {entries}")
            want, f32_kernel = plain(), kern(wide[net])
            torch.cuda.synchronize()
            if not got.dtype == want.dtype == f32_kernel.dtype == torch.float32 or \
                    got.shape != want.shape:
                raise AssertionError(f"{name} B={B}: {got.shape}/{got.dtype} vs plain "
                                     f"{want.shape}/{want.dtype}")
            err = float((got.double() - want.double()).abs().max())
            bits = _bit_diff(got, f32_kernel)
            log(f"check {name} B={B}: max_abs_err={err} against the plain version (tolerance "
                f"{tol}); bit difference {bits} against the f32 kernel on the widened weights "
                f"(tolerance 0)")
            if not err <= tol or bits != 0:
                raise AssertionError(f"{name} B={B}: error {err} > {tol} or bits {bits} != 0")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"], err)
        if B != 1024:
            continue

        # times at 1024 lanes, bounds from the bf16 bytes these inputs need
        l1 = p16.l1
        acc_bytes = B * 2 * l1 * 4
        sq = torch.arange(64, device=dev, dtype=torch.int32)
        feats = torch.stack([nnue.feature_index_768(b.board, sq, q) for q in (0, 1)], 1)
        upd = torch.stack([nnue.feature_index_768(codes, sqs, q) for q in (0, 1)], 1)
        pieces = int((b.board > 0).sum())
        head = int(bucket.unique().numel()) * sum(t[0].numel() * t.element_size() for t in p16[2:])
        costs = {
            "nnue_refresh_768_bf16": (
                B * 256 + int(feats[feats >= 0].unique().numel()) * l1 * 2 + l1 * 2 + acc_bytes,
                2 * pieces * l1 + 2 * B * l1),
            "nnue_acc_update_768_bf16": (
                2 * acc_bytes + B * 48 + int(upd[upd >= 0].unique().numel()) * l1 * 2,
                int((upd >= 0).sum()) * l1 + B * 2 * l1),
            "nnue_forward_from_acc_bf16": (acc_bytes + B * 8 + head + B * 4,
                                           B * 2 * (128 * 16 + 16 * 32 + 32)),
            "nnue_evaluate_bf16": full_eval_cost(k16, b.board),
        }
        for name, (net, kern, plain, _) in cases.items():
            nbytes, nops = costs[name]
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / F32_OPS_PER_S * 1e3
            # f32, bf16, bf16, f32 in turn on the same card
            bf16, f32 = nets[net], wide[net]
            (f32_ms, _), (ms, call_ms) = time_ms(lambda: kern(f32), reps), time_ms(
                lambda: kern(bf16), reps)
            ms2, f32_ms2 = time_ms(lambda: kern(bf16), reps)[0], time_ms(
                lambda: kern(f32), reps)[0]
            plain_ms, plain_call = time_ms(plain, reps)
            row = stats[name]
            row.update(ms=(ms + ms2) / 2, f32_kernel_ms=(f32_ms + f32_ms2) / 2,
                       plain_ms=plain_ms, library_ms=None, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            cold = ""
            if name == "nnue_evaluate_bf16":  # K12's row keeps its cold-L2 times
                cold_ms = time_cold_ms(lambda: kern(bf16), reps, scrub)
                f32_cold = time_cold_ms(lambda: kern(f32), reps, scrub)
                plain_cold = time_cold_ms(plain, reps, scrub)
                row.update(ms=cold_ms, ms_l2_warm=(ms + ms2) / 2, f32_kernel_ms=f32_cold,
                           f32_kernel_ms_l2_warm=(f32_ms + f32_ms2) / 2, plain_ms=plain_cold)
                cold = (f"; cold L2: bf16 {cold_ms:.5f}, f32 {f32_cold:.5f}, plain "
                        f"{plain_cold:.5f}")
            log(f"time {name} B={B} (device ms): bf16 kernel {ms:.5f}, {ms2:.5f} (call "
                f"{call_ms:.5f}); f32 kernel on the widened weights {f32_ms:.5f}, {f32_ms2:.5f}; "
                f"plain {plain_ms:.5f} (call {plain_call:.5f}){cold}; library none (no one call "
                f"sums bf16 rows in f32); bound {row['bound_ms']:.6f} ({row['bound_by']}, "
                f"{nbytes} bytes, {nops} ops)")
    return stats


# cycles of the card's spin per ms (measured once, time_queued_ms)
_SPIN_RATE: list = []


def time_queued_ms(fn, reps: int, spin_ms: float = 0.0) -> float:
    """ms of one fn() on the card, reps calls back to back with a warm L2:
    the card first spins (QUEUE_SPIN_CYCLES, or longer than spin_ms, the
    host's time to queue the calls, up to 5 s) while the host queues
    every call, so the CUDA events around them read the card's time
    alone, not the host's launch rate. A function that queues more
    launches than the card's queue holds still reads the host's rate."""
    import torch

    fn()
    torch.cuda.synchronize()
    if not _SPIN_RATE:  # the spin's cycles per ms on this card
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(QUEUE_SPIN_CYCLES)
        b.record()
        torch.cuda.synchronize()
        _SPIN_RATE.append(QUEUE_SPIN_CYCLES / max(a.elapsed_time(b), 1e-3))
    cycles = int(min(max(QUEUE_SPIN_CYCLES, 1.25 * spin_ms * _SPIN_RATE[0]),
                     5000 * _SPIN_RATE[0]))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k12_warm_readings(kb_f32) -> None:
    """K12's warm (repeated-call) time on the f32 king-bucketed net at
    1024 lanes, read two ways on the boards of both phases that time it
    (nets_kernel_phase's seed 1124, bf16_kernel_phase's seed 1027) at
    both phases' call counts (NET_REPS, REPS): time_ms's profiler reading
    and time_queued_ms'. Logged only: it says whether the boards, the
    call count or the reader sets the warm figure."""
    from functools import partial

    from fishnet_tpu_torch.models import nnue

    for seed in (1124, 1027):
        b = playout_boards(1024, seed=seed)[0].to("cuda")
        fn = partial(nnue.evaluate, kb_f32, b.board, b.stm)
        for reps in (NET_REPS, REPS):
            (queued, call), prof = time_ms(fn, reps), profile_ms(fn, reps)
            log(f"K12 warm reading, f32 king-bucketed net B=1024 boards of seed {seed}, {reps} "
                f"calls: profiler {prof:.5f} ms, queued events {queued:.5f} ms, call {call:.5f} ms")


def bf16_segment_phase(params_f32, kb_f32, reps: int) -> dict:
    """K11 on bf16 weights (search_segment_bf16*, search_segment_kb_bf16)
    against run_segment_plain and against the f32 K11 on the same weights
    widened to f32, on seeded states: the shipped net at 16 lanes ("table"
    setup, VARIANT_SEGMENT_STEPS) and at 64 lanes (the main path's
    "engine" setup, SEGMENT_STEPS), atomic at 64 lanes (the engine setup;
    K1's body is its leaf) and the king-bucketed net at 16 lanes ("table",
    NET_SEGMENT_STEPS): states, tables and summaries byte for byte, equal
    steps, one launch of the bf16 entry a segment. Then the 64-lane engine
    segment of 200 steps timed (CUDA events, from the same state each
    launch) in turn with the f32 K11 on the widened weights, beside the
    plain version's wall and the bound from the bytes it moves. → stats of
    search_segment_bf16."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import search

    dev = torch.device("cuda")
    nets = {"board768": nnue.cast_params(params_f32), "kb": nnue.cast_params(kb_f32)}
    stats = {"max_abs_err": 0.0}
    cases = (("board768", 16, "table", "standard", VARIANT_SEGMENT_STEPS),
             ("board768", 64, "engine", "standard", SEGMENT_STEPS),
             ("board768", 64, "engine", "atomic", SEGMENT_STEPS),
             ("kb", 16, "table", "standard", NET_SEGMENT_STEPS))
    for net, B, cfg, v, segs in cases:
        p16 = nets[net]
        wide = nnue.widened(p16)
        entry = kernels._variant_symbol(
            "search_segment_bf16" if net == "board768" else "search_segment_kb_bf16", v)
        state, table, kw = segment_case(p16, B, cfg, seed=B + len(cfg), dev=dev, variant=v)
        plain, plain_table = _clone(state, table)
        f32, f32_table = _clone(state, table)
        for steps in segs:
            kernels.reset_launches()
            n_k, sum_k = search.run_segment(p16, state, steps, True, **kw)
            entries = {k: c for k, c in kernels.LAUNCHES_BY_ENTRY.items() if c}
            n_f, sum_f = search.run_segment(wide, f32, steps, True, **dict(kw, table=f32_table))
            n_p, sum_p = search.run_segment_plain(p16, plain, steps, True,
                                                  **dict(kw, table=plain_table))
            torch.cuda.synchronize()
            err = _state_diff(state, plain, table, plain_table)
            err = max(err, float((sum_k.long() - sum_p.long()).abs().max()))
            err_f32 = _state_diff(state, f32, table, f32_table)
            err_f32 = max(err_f32, float((sum_k.long() - sum_f.long()).abs().max()))
            done = int(sum_k[:B, search.SUM_DONE].sum())
            label = f"{entry} B={B} {net} bf16 {cfg} segment {steps}"
            log(f"check search_segment {label}: steps {n_k} (plain {n_p}, f32 kernel {n_f}), "
                f"done {done}/{B}, max_abs_err={err} against run_segment_plain, {err_f32} "
                f"against the f32 K11 on the widened weights (tolerance 0), launches {entries}")
            stats["max_abs_err"] = max(stats["max_abs_err"], err, err_f32)
            if err != 0 or err_f32 != 0 or not n_k == n_p == n_f or entries != {entry: 1}:
                raise AssertionError(f"search_segment {label}: K11 differs (steps {n_k} / "
                                     f"{n_p} / {n_f}; launches {entries})")

    # the main path's 64-lane setup: bf16 and f32 K11 in turn, same state
    p16 = nets["board768"]
    wide = nnue.widened(p16)
    state0, table0, kw = segment_case(p16, 64, "engine", seed=64, dev=dev)
    state, table = _clone(state0, table0)
    kw = dict(kw, table=table)
    steps = SEGMENT_STEPS[-1]
    times = {"bf16": [], "f32": []}
    calls = None
    for order in [("f32", "bf16", "bf16", "f32")] * reps:
        for tag in order:
            for t, t0 in zip(list(state) + [table], list(state0) + [table0]):
                t.copy_(t0)
            kernels.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            n, _ = search.run_segment(p16 if tag == "bf16" else wide, state, steps, True, **kw)
            end.record()
            torch.cuda.synchronize()
            times[tag].append(start.elapsed_time(end))
            if tag == "bf16":
                calls = kernels.body_calls()
    ms = sum(times["bf16"]) / len(times["bf16"])
    f32_ms = sum(times["f32"]) / len(times["f32"])
    plain, plain_table = _clone(state0, table0)
    plain_ms, n_p = plain_segment_ms(lambda k: search.run_segment_plain(
        p16, plain, k, True, **dict(kw, table=plain_table))[0])
    nbytes = segment_bytes(calls, 2 * 64 * 4)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"time search_segment_bf16 B=64 engine table (CUDA events, {2 * reps} launches each, "
        f"f32/bf16 in turn): bf16 {ms:.4f} ms per segment of {n} steps, {ms / n * 1e3:.2f} "
        f"us/step; f32 on the widened weights {f32_ms:.4f} ms, {f32_ms / n * 1e3:.2f} us/step "
        f"(bf16/f32 {ms / f32_ms:.4f}); plain {plain_ms:.1f} ms for a segment of {n_p} steps "
        f"({plain_ms / n_p:.3f} ms/step); "
        f"bound {bound:.6f} ms, {bound / n * 1e3:.4f} us/step (bytes, {nbytes} bytes; counters "
        f"{calls})")
    if n != steps:
        raise AssertionError(f"timed bf16 segment ran {n} of {steps} steps")
    stats.update(ms=ms, f32_kernel_ms=f32_ms, plain_ms=plain_ms, plain_steps=n_p, bound_ms=bound,
                 bound_by="bytes", library_ms=None, steps=n, us_per_step=ms / n * 1e3,
                 f32_kernel_us_per_step=f32_ms / n * 1e3)
    return {"search_segment_bf16": stats}


def bf16_kb_search_phase(kb_f32, depth: int) -> tuple:
    """search_batch on the bf16 king-bucketed net on the card (16 lanes,
    MAX_PLY 8): every lane done, K7 and K11's search_segment_kb_bf16 entry
    launched, K12's body inside K11 and no kernel of a body on its own.
    → (launches, steps, K11's body calls)."""
    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops.search import search_batch

    k16 = nnue.cast_params(kb_f32)
    roots, _ = playout_boards(16, seed=23)
    kernels.reset_launches()
    t0 = time.monotonic()
    out = search_batch(k16, roots, depth, 200_000, max_ply=8, device="cuda")
    wall = time.monotonic() - t0
    launches = check_launches("search_batch, bf16 king-bucketed net", net="king")
    entries = dict(kernels.LAUNCHES_BY_ENTRY)
    if not entries.get("search_segment_kb_bf16") or not out["done"].all():
        raise AssertionError(f"bf16 king-bucketed search: {entries}, done {out['done']}")
    calls = kernels.body_calls()
    log(f"search_batch, bf16 king-bucketed net B=16 depth {depth}: steps {out['steps']}, nodes "
        f"{int(out['nodes'].sum())}, wall {wall:.3f} s, launches by entry {entries}")
    return launches, out["steps"], calls


def bf16_engine_phase(params_f32, depth: int, n_positions: int) -> tuple:
    """The board768 main path under FISHNET_TPU_DTYPE=bf16: GpuEngine()
    given the f32 net keeps every weight in bf16 on the card (no f32
    field), then engine_phase's chunk through its defaults; it fails
    unless K1 and K11 launched through their bf16 entry points and no f32
    entry of K1 or K11 did. → engine_phase's tuple and the launches by
    entry."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.engine.gpu import GpuEngine

    saved = os.environ.get("FISHNET_TPU_DTYPE")
    os.environ["FISHNET_TPU_DTYPE"] = "bf16"
    try:
        engine = GpuEngine(params=params_f32, tt_size_log2=0)
        dtypes = {str(t.dtype) for t in engine.params} | {t.device.type for t in engine.params}
        if dtypes != {"torch.bfloat16", "cuda"}:
            raise AssertionError(f"bf16 engine weights: {dtypes}")
        del engine
        out = engine_phase(params_f32, depth, n_positions, refill=True, label="bf16 weights")
        entries = dict(kernels.LAUNCHES_BY_ENTRY)
    finally:
        if saved is None:
            os.environ.pop("FISHNET_TPU_DTYPE", None)
        else:
            os.environ["FISHNET_TPU_DTYPE"] = saved
    torch.cuda.synchronize()
    bad = [k for k in ("nnue_refresh_768_f32", "search_segment_f32") if entries.get(k)]
    if bad or not (entries.get("nnue_refresh_768_bf16") and entries.get("search_segment_bf16")):
        raise AssertionError(f"bf16 main path: launches by entry {entries}")
    log(f"engine chunk, bf16 weights (main path): launches by entry {entries}")
    return out + (entries,)


def make_chunk(n_positions: int, depth: int):
    from fishnet_tpu_torch.ipc import AnalysisWork, Chunk, EngineFlavor, NodeLimit, WorkPosition

    work = AnalysisWork(id="chipsmoke", nodes=NodeLimit(sf16=50_000_000, classical=50_000_000),
                        timeout_s=600.0, depth=depth)
    plies = [(g, k) for k in range(4, 24, 2) for g in range(len(GAMES)) if k <= len(GAMES[g])]
    positions = [
        WorkPosition(work=work, position_index=i, url=None, skip=False,
                     root_fen=START, moves=GAMES[g][:k])
        for i, (g, k) in enumerate(plies[:n_positions])
    ]
    return Chunk(work=work, deadline=time.monotonic() + 900, variant="standard",
                 flavor=EngineFlavor.TPU, positions=positions)


def engine_phase(params_f32, depth: int, n_positions: int, refill: bool,
                 tt_on: bool = True, weights_path=None, label: str = "", mesh=None):
    """One chunk through GpuEngine: through the LaneScheduler (refill;
    each segment's occupancy logged) or chunk-serially (each dispatch
    logged), with the defaults' 2^21 table and helper lanes (tt_on) or
    with neither; on params_f32, or on the net GpuEngine(weights_path=)
    loads; on one device, or sharded over `mesh` (a table a shard, each
    shard's steps logged); `label` is added to the path's name in the
    log. → (launches, the wire responses without their times, steps,
    K11's body calls)."""
    import numpy as np
    import torch

    from fishnet_tpu_torch import ipc, kernels
    from fishnet_tpu_torch.chess import Position
    from fishnet_tpu_torch.engine.gpu import GpuEngine
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import search
    from fishnet_tpu_torch.parallel import mesh as mesh_mod

    steps, helpers = [], {}

    class CountingEngine(GpuEngine):
        def _search(self, roots, depth_arr, *a, order_jitter=None, required=None, **kw):
            t0 = time.monotonic()
            out = super()._search(roots, depth_arr, *a, order_jitter=order_jitter,
                                  required=required, **kw)
            steps.append(out["steps"])
            d = int(depth_arr[required].max() if required is not None else depth_arr.max())
            n_help = 0 if order_jitter is None else int((np.asarray(order_jitter) != 0).sum())
            helpers.setdefault(d, n_help)
            log(f"{path}: dispatch {len(steps)}: depth {d} lanes {len(depth_arr)} helpers "
                f"{n_help} steps {out['steps']} wall {time.monotonic() - t0:.3f} s")
            return out

    kw = {} if refill else {"refill": False}
    if not tt_on:
        kw.update(tt_size_log2=0, helper_lanes=1)
    if weights_path is None:
        kw["params"] = params_f32
    else:
        kw["weights_path"] = str(weights_path)
    if mesh is not None:
        kw["mesh"] = mesh
    engine = (GpuEngine if refill else CountingEngine)(max_depth=depth, **kw)
    net = nnue.net_kind(engine.params)
    path = ("engine chunk, " + ("refill" if refill else "chunk-serial")
            + ("" if tt_on else ", no table")
            + ("" if weights_path is None else f", {net} net {os.path.basename(weights_path)}")
            + (f", {label}" if label else "")
            + ("" if mesh is None else f", {len(mesh)}-shard mesh")
            + (" (main path)" if refill and tt_on else ""))
    tables = [] if engine.tt is None else engine.tt if mesh is not None else [engine.tt]
    slots = {t.shape[0] for t in tables}
    want = {1 << 21} if tt_on else set()
    if engine.refill != refill or slots != want or len(tables) != (
            (1 if mesh is None else len(mesh)) if tt_on else 0):
        raise AssertionError(f"engine: refill {engine.refill}, {len(tables)} tables of {slots} "
                             f"slots")
    slots = sum(t.shape[0] for t in tables)
    assert engine.max_ply == 32, engine.max_ply
    chunk = make_chunk(n_positions, depth)
    ran = []  # each segment call's step count (the largest shard's)
    shard_launches = []  # each sharded segment call's shards
    run_segment, run_sharded = search.run_segment, mesh_mod.run_segment_sharded

    def counted_segment(*args, **kwargs):
        out = run_segment(*args, **kwargs)
        ran.append(out[0])
        return out

    def counted_sharded(*args, **kwargs):
        out = run_sharded(*args, **kwargs)
        ran.append(max(out[0]))
        shard_launches.append(len(out[0]))
        return out

    search.run_segment = counted_segment
    mesh_mod.run_segment_sharded = counted_sharded
    kernels.reset_launches()
    t0 = time.monotonic()
    try:
        responses = asyncio.run(engine.go_multiple(chunk))
        torch.cuda.synchronize()
    finally:
        search.run_segment = run_segment
        mesh_mod.run_segment_sharded = run_sharded
    wall = time.monotonic() - t0
    launches = check_launches(path, engine=True, net=net)
    log(f"{path}: {len(ran)} segment calls, {sum(n > 0 for n in ran)} of them ran steps "
        f"({sum(ran)} steps)")
    if mesh is not None and sum(shard_launches) != launches["search_segment"]:
        raise AssertionError(f"{path}: {launches['search_segment']} K11 launches in "
                             f"{len(ran)} sharded segments of {shard_launches} shards")
    body_calls = kernels.body_calls()
    if len(responses) != len(chunk.positions):
        raise AssertionError(f"{len(responses)} responses for {len(chunk.positions)} positions")
    for wp, res in zip(chunk.positions, responses):
        pos = Position.initial()
        for uci in wp.moves:
            pos = pos.push(pos.parse_uci(uci))
        if res.depth != depth:
            raise AssertionError(f"position {wp.position_index} reached depth {res.depth}")
        pos.parse_uci(res.best_move)  # raises if not legal
        score = res.scores.best()
        log(f"{path}: position {wp.position_index} ({len(wp.moves)} plies): "
            f"best {res.best_move} score {score.kind} {score.value} nodes {res.nodes}")
    nodes = sum(r.nodes for r in responses)
    if refill:
        for row in engine.occupancy_log:
            log(f"{path}: occupancy {json.dumps(row)}")
        tot = engine.occupancy_totals
        n_steps, extra = tot["steps"], (
            f"segments {tot['segments']} refills {tot['refills']} lane steps live "
            f"{tot['live_lane_steps']} helper {tot['helper_lane_steps']} idle "
            f"{tot['idle_lane_steps']} of {tot['lane_steps']} host_ms {tot['host_ms']:.3f} "
            f"device_ms {tot['device_ms']:.3f} aspiration {engine.aspiration_stats}")
        if tot["positions_done"] != len(responses):
            raise AssertionError(f"scheduler finished {tot['positions_done']} positions")
        if mesh is not None:
            per_shard = [sum(r["shard_steps"][i] for r in engine.occupancy_log)
                         for i in range(len(mesh))]
            extra += (f" transfers {tot['transfers']} steps a shard {per_shard} (max "
                      f"{n_steps}: a boundary's step count is its largest shard's)")
    else:
        n_steps, extra = sum(steps), f"dispatches {len(steps)} helpers per depth {helpers}"
    log(f"{path}: {len(responses)} positions depth {depth} table {slots} slots, "
        f"K={engine.helper_lanes}, nodes {nodes} steps {n_steps} wall {wall:.3f} s "
        f"ms/step {wall / max(n_steps, 1) * 1e3:.3f} nodes/s {nodes / wall:.0f} {extra}")
    wire = []
    for r in responses:
        w = ipc.response_to_wire(r)
        w.pop("time_s")
        w.pop("nps")
        wire.append(w)
    return launches, wire, n_steps, body_calls


def no_table_phase(params_f32, depth: int, n_positions: int) -> None:
    """The chunk without the table or helpers, chunk-serially and through
    the LaneScheduler: without a table the two give the same responses."""
    serial = engine_phase(params_f32, depth, n_positions, refill=False, tt_on=False)[1]
    sched = engine_phase(params_f32, depth, n_positions, refill=True, tt_on=False)[1]
    if sched != serial:
        raise AssertionError(f"no table: scheduler {sched} != chunk-serial {serial}")
    log(f"no table: the scheduler's {len(sched)} responses equal the chunk-serial path's "
        f"(score, pv, depth, nodes, best move)")


def parity_phase(params_f32, depth: int) -> None:
    """The card's int8 search_batch against the CPU's, field for field."""
    import numpy as np

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops.search import search_batch

    params_i8 = nnue.quantize_int8(params_f32)
    roots, _ = playout_boards(16, seed=7)
    kernels.reset_launches()
    t0 = time.monotonic()
    card = search_batch(params_i8, roots, depth, 200_000, max_ply=8, device="cuda")
    t1 = time.monotonic()
    check_launches("parity, card")
    cpu = search_batch(params_i8.to("cpu"), roots, depth, 200_000, max_ply=8, device="cpu")
    t2 = time.monotonic()
    for k in ("score", "move", "nodes", "pv", "pv_len", "done"):
        if not np.array_equal(card[k], cpu[k]):
            raise AssertionError(f"card and CPU differ in {k}")
    if card["steps"] != cpu["steps"]:
        raise AssertionError(f"steps differ: card {card['steps']} cpu {cpu['steps']}")
    log(f"parity: int8 search_batch B=16 depth {depth}: card == cpu on score, move, "
        f"nodes, steps ({card['steps']}), pv, pv_len; card {t1 - t0:.3f} s, cpu {t2 - t1:.3f} s")


def tt_parity_phase(params_i8, depth: int) -> tuple:
    """An int8 search with the table and a helper-lane layout (jittered
    helpers one ply deeper, group tags, the required-lane stop, the
    depth-preferred generation store), card against CPU: every field and
    the final tables byte for byte. → the card run's (launches, steps,
    K11's body calls)."""
    import numpy as np

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import tt
    from fishnet_tpu_torch.ops.search import search_batch_resumable

    roots, _ = playout_boards(4, seed=17)
    B, n = 16, 4
    pick = [i % n for i in range(B)]
    roots = type(roots)(*[t[pick] for t in roots])
    jitter = np.asarray([0] * n + list(range(1, B - n + 1)), np.int32)
    kw = dict(order_jitter=jitter, group=np.asarray(pick, np.int32),
              required=np.arange(B) < n, prefer_deep_store=True, tt_gen=5, segment_steps=256)
    depth_arr = np.asarray([depth] * n + [depth + (i % 2) for i in range(B - n)], np.int32)
    outs, tables, walls = {}, {}, {}
    net = nnue.net_kind(params_i8)
    for dev in ("cuda", "cpu"):
        table = tt.make_table(TT_PARITY_LOG2, device=dev)
        kernels.reset_launches()
        t0 = time.monotonic()
        outs[dev] = search_batch_resumable(params_i8.to(dev), roots.to(dev), depth_arr, 200_000,
                                           max_ply=8, tt=table, device=dev, **kw)
        walls[dev] = time.monotonic() - t0
        tables[dev] = outs[dev].pop("tt").cpu().numpy()
        if dev == "cuda":
            launches = check_launches(f"TT parity, {net} int8 net, card", net=net)
            body_calls = kernels.body_calls()
    card, cpu = outs["cuda"], outs["cpu"]
    for k in ("score", "move", "nodes", "pv", "pv_len", "done"):
        if not np.array_equal(card[k], cpu[k]):
            raise AssertionError(f"TT search: card and CPU differ in {k}")
    if card["steps"] != cpu["steps"]:
        raise AssertionError(f"TT steps differ: card {card['steps']} cpu {cpu['steps']}")
    if not np.array_equal(tables["cuda"], tables["cpu"]):
        raise AssertionError("TT search: the card's table differs from the CPU's")
    filled = int((tables["cuda"][:, 1] != 0).sum())
    log(f"TT parity: {net} int8 net B={B} ({n} primaries, {B - n} helpers) depth {depth}, 2^"
        f"{TT_PARITY_LOG2} slots: card == cpu on score, move, nodes, steps "
        f"({card['steps']}), pv, pv_len and the table ({filled} rows filled); card "
        f"{walls['cuda']:.3f} s, cpu {walls['cpu']:.3f} s")
    return launches, card["steps"], body_calls


def stream_parity_phase(params_f32, n: int, width: int) -> None:
    """search_stream on the int8 net, n playout positions through `width`
    lanes with staggered depths and budgets into a 2^16 table with the
    helpers' store and per-admission generations, card against CPU:
    every per-position field, steps, refills, the occupancy rows and the
    final tables byte for byte."""
    import numpy as np

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import tt
    from fishnet_tpu_torch.ops.search import search_stream

    params_i8 = nnue.quantize_int8(params_f32)
    roots, _ = playout_boards(n, seed=23)
    # depths 1-3 in an irregular order, a quarter of the lanes on a
    # small budget: lanes finish at different boundaries
    depth = np.asarray([1 + i % 3 if i % 4 == 1 else 1 + i % 2 for i in range(n)], np.int32)
    budget = np.asarray([200_000 if i % 4 else 400 for i in range(n)], np.int32)
    outs, tables, walls = {}, {}, {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launches()
        t0 = time.monotonic()
        outs[dev] = search_stream(params_i8.to(dev), roots.to(dev), depth, budget, max_ply=8,
                                  width=width, segment_steps=64,
                                  tt=tt.make_table(TT_PARITY_LOG2, device=dev),
                                  prefer_deep_store=True, device=dev)
        walls[dev] = time.monotonic() - t0
        tables[dev] = outs[dev].pop("tt").cpu().numpy()
        if dev == "cuda":
            check_launches("stream parity, card")
    card, cpu = outs["cuda"], outs["cpu"]
    for k in ("score", "move", "nodes", "pv", "pv_len", "done"):
        if not np.array_equal(card[k], cpu[k]):
            raise AssertionError(f"stream: card and CPU differ in {k}")
    keys = ("segment", "steps", "live", "idle", "refilled", "queue")
    occ = [[{k: r[k] for k in keys} for r in o["occupancy"]] for o in (card, cpu)]
    if (card["steps"], card["refills"], occ[0]) != (cpu["steps"], cpu["refills"], occ[1]):
        raise AssertionError("stream: card and CPU differ in steps, refills or occupancy")
    if not np.array_equal(tables["cuda"], tables["cpu"]):
        raise AssertionError("stream: the card's table differs from the CPU's")
    if not card["done"].all() or card["refills"] != n - width:
        raise AssertionError(f"stream: done {card['done'].sum()}/{n}, refills {card['refills']}")
    log(f"stream parity: int8 search_stream {n} positions through {width} lanes, 2^"
        f"{TT_PARITY_LOG2} slots: card == cpu on score, move, nodes, steps ({card['steps']}), "
        f"pv, pv_len, refills ({card['refills']}), {len(occ[0])} occupancy rows and the table "
        f"({int((tables['cuda'][:, 1] != 0).sum())} rows filled); card {walls['cuda']:.3f} s, "
        f"cpu {walls['cpu']:.3f} s")


def scale_phase(params_f32, lanes: int, depth: int) -> None:
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.ops.search import search_batch

    roots, _ = playout_boards(lanes, seed=11)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.monotonic()
    out = search_batch(params_f32, roots, depth, 10_000_000, max_ply=32, device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    check_launches(f"scale B={lanes}")
    nodes = int(out["nodes"].sum())
    if not out["done"].all():
        raise AssertionError("scale search did not finish")
    log(f"scale: search_batch B={lanes} depth {depth} f32: nodes {nodes} steps "
        f"{out['steps']} wall {wall:.3f} s nodes/s {nodes / wall:.0f} "
        f"ms/step {wall / max(out['steps'], 1) * 1e3:.3f}")


def profile_phase(params_f32, lanes: int, steps: int, tt_on: bool = False) -> None:
    """Where a segment's time goes: one K11 segment of `steps` steps at
    `lanes` lanes (depth-6 searches from playout positions, MAX_PLY 32)
    under torch.profiler, after a warm-up segment: the host wall per step
    (the launch and the read of the step count included), the device's
    busy time per step, its idle share and the device entries per step.
    tt_on: under the TT runner, on a 2^21-slot table with the helpers'
    store."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.ops import tt
    from fishnet_tpu_torch.ops.search import init_state, run_segment

    dev = torch.device("cuda")
    roots = playout_boards(lanes, seed=13)[0].to(dev)
    kernels.reset_launches()
    state = init_state(params_f32, roots, torch.full((lanes,), 6, dtype=torch.int32, device=dev),
                       torch.full((lanes,), 10_000_000, dtype=torch.int32, device=dev), 32)
    kw = {}
    if tt_on:
        kw = dict(table=tt.make_table(21, device=dev), prefer_deep=True, tt_gen=1)
    name = f"profile B={lanes}{' with table' if tt_on else ''}"
    run_segment(params_f32, state, 20, True, **kw)  # warm up past the root
    torch.cuda.synchronize()
    t0 = time.monotonic()
    n, _ = run_segment(params_f32, state, steps, True, **kw)
    plain_wall = time.monotonic() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        start.record()
        n2, _ = run_segment(params_f32, state, steps, True, **kw)
        end.record()
        wall = time.monotonic() - t0
        torch.cuda.synchronize()
    check_launches(name)
    if n != steps or n2 != steps:
        raise AssertionError(f"{name}: segments ran {n} and {n2} of {steps} steps")

    # the kernels themselves (device-side entries), not the ops that launched
    # them; where the profiler records no device time, the CUDA events'
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(_device_us(e) for e in events)
    source = "torch.profiler"
    if dev_us <= 0:
        dev_us, source = start.elapsed_time(end) * 1e3, "CUDA events"
    launches = sum(e.count for e in events)
    log(f"{name}: wall {plain_wall / steps * 1e3:.4f} ms/step (profiled "
        f"{wall / steps * 1e3:.4f}), device busy {dev_us / steps / 1e3:.4f} ms/step ({source}), "
        f"device idle share {max(0.0, 1 - dev_us / 1e3 / (wall * 1e3)):.3f} (of the profiled "
        f"segment), device entries {launches / steps:.3f}/step, segment {steps} steps")
    for e in sorted(events, key=lambda e: -_device_us(e))[:6]:
        log(f"{name}: {_device_us(e) / steps:9.2f} us/step "
            f"x{e.count / steps:<6.3f} {e.key[:90]}")


# the mesh phase: MESH_SHARDS shards on cuda:0 (parallel/mesh.py), each
# with its own lanes, table and CUDA stream
MESH_SHARDS = 4
MESH_LANES = 64  # the main path's width: 16 lanes a shard
MESH_SEGMENT_CONFIGS = ("no table", "helpers")  # K11 a shard, without and with tables
MESH_REFILL_LANES = 24  # lanes the K7-per-shard check splices
MESH_PARITY_POSITIONS = 2  # positions of the int8 mesh chunk, card against CPU


def _mesh():
    from fishnet_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.make_mesh(["cuda:0"] * MESH_SHARDS)


def _shard_spans(start, events) -> list:
    """Each shard's (start, end) ms after `start` from run_segment_sharded's
    events."""
    return [(s, start.elapsed_time(a), start.elapsed_time(b)) for s, a, b in events]


def mesh_segment_checks(params_f32) -> float:
    """K11 a shard against run_segment_plain: a seeded MESH_LANES-lane state
    split into MESH_SHARDS shards of cuda:0, without tables and with a
    2^12-slot table a shard (helpers: jittered lanes, the prefer_deep store
    under per-lane generations, colliding slots), over segments of
    SEGMENT_STEPS steps in turn. Each shard's state and table after each
    segment, its step count and its rows of the stacked summary equal
    run_segment_plain run on a copy of that shard alone, byte for byte. →
    the largest difference (0)."""
    import numpy as np
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.ops import search
    from fishnet_tpu_torch.parallel import mesh as mesh_mod

    mesh = _mesh()
    local = MESH_LANES // MESH_SHARDS
    worst = 0.0
    for cfg in MESH_SEGMENT_CONFIGS:
        state, table, kw = segment_case(params_f32, MESH_LANES, cfg, seed=700 + len(cfg),
                                        dev=torch.device("cuda"))
        shards = mesh_mod.shard_batch(mesh, state)
        tables = None if table is None else mesh_mod.make_sharded_table(
            mesh, int(table.shape[0]).bit_length() - 1)
        gen = kw["tt_gen"]
        plain = [_clone(sh, None if tables is None else tables[i])
                 for i, sh in enumerate(shards)]
        for steps in SEGMENT_STEPS:
            n, stacked = mesh_mod.run_segment_sharded(
                mesh, params_f32, shards, tables, steps, True, kw["deep_tt"], kw["prefer_deep"],
                gen)
            grid = kernels.LAST_GRID["blocks"]
            rows, err = [], 0.0
            for i, (pst, ptab) in enumerate(plain):
                g = gen[i * local:(i + 1) * local] if torch.is_tensor(gen) else gen
                n_p, summ = search.run_segment_plain(params_f32, pst, steps, True, ptab,
                                                     kw["deep_tt"], kw["prefer_deep"], g)
                torch.cuda.synchronize()
                if n_p != n[i]:
                    raise AssertionError(f"mesh {cfg} segment {steps}: shard {i} ran {n[i]} "
                                         f"steps, plain {n_p}")
                err = max(err, _state_diff(shards[i], pst, None if tables is None
                                           else tables[i], ptab))
                rows.append(summ.cpu().numpy())
            err = max(err, float(np.abs(stacked.astype(np.int64)
                                        - np.stack(rows).astype(np.int64)).max()))
            done = int(stacked[:, :local, search.SUM_DONE].sum())
            log(f"check search_segment mesh {MESH_SHARDS} shards x {local} lanes f32 {cfg} "
                f"segment {steps}: steps a shard {n} (plain equal), done {done}/{MESH_LANES}, "
                f"max_abs_err={err} (tolerance 0; states, tables, stacked summary == the "
                f"plain summaries concatenated; grid {grid} blocks a shard)")
            if err != 0:
                raise AssertionError(f"mesh {cfg} segment {steps}: K11 a shard differs from "
                                     f"run_segment_plain")
            worst = max(worst, err)
    return worst


def mesh_segment_times(params_f32, reps: int) -> dict:
    """The card time of one sharded segment (PROFILE_STEPS steps, the main
    path's table setup: a 2^21-slot table a shard, prefer_deep, per-lane
    generations) over MESH_SHARDS shards of cuda:0, CUDA events around
    run_segment_sharded (the stacked summary's read included), with each
    shard's K11 timed by its own events on its stream: whether the shards'
    cooperative launches overlap, and how the span compares with their
    sum. Then one shard's K11 alone (its 16 lanes, the same state), the
    plain version's wall (every shard in turn) and the bound from the
    bytes the sharded segment moves. → the kernels line's row stats."""
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.ops import search
    from fishnet_tpu_torch.parallel import mesh as mesh_mod

    mesh = _mesh()
    local = MESH_LANES // MESH_SHARDS
    steps = PROFILE_STEPS
    state0, _, kw = segment_case(params_f32, MESH_LANES, "engine", seed=MESH_LANES,
                                 dev=torch.device("cuda"))
    state = search.SearchState(*[t.clone() for t in state0])
    shards = mesh_mod.shard_batch(mesh, state)
    tables = mesh_mod.make_sharded_table(mesh, 21)
    gen = kw["tt_gen"]

    def restore():
        for t, t0 in zip(state, state0):
            t.copy_(t0)
        for t in tables:
            t.zero_()

    def sharded(events=None):
        return mesh_mod.run_segment_sharded(mesh, params_f32, shards, tables, steps, True,
                                            False, True, gen, events=events)

    sharded()  # warm up
    times, spans, n = [], [], None
    for _ in range(reps):
        restore()
        kernels.reset_launches()
        events = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        n, _ = sharded(events)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        spans.append(_shard_spans(start, events))
    calls = kernels.body_calls()
    ms = sum(times) / len(times)
    # overlap: every shard's kernel running at one moment, in each rep
    overlapped = all(max(a for _, a, _ in sp) < min(b for _, _, b in sp) for sp in spans)
    busy = [sum(b - a for _, a, b in sp) for sp in spans]
    span = [max(b for _, _, b in sp) - min(a for _, a, _ in sp) for sp in spans]
    one = []
    for _ in range(reps):
        restore()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        n0, _ = search.run_segment(params_f32, shards[0], steps, True, tables[0], False, True,
                                   gen[:local])
        b.record()
        torch.cuda.synchronize()
        one.append(a.elapsed_time(b))
    one_ms = sum(one) / len(one)
    restore()
    plain = [_clone(sh, tables[i]) for i, sh in enumerate(shards)]
    plain_ms, n_p = plain_segment_ms(lambda k: max(
        search.run_segment_plain(params_f32, pst, k, True, ptab, False, True,
                                 gen[i * local:(i + 1) * local])[0]
        for i, (pst, ptab) in enumerate(plain)))
    nbytes = segment_bytes(calls, 2 * 64 * 4)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"time search_segment mesh {MESH_SHARDS} shards x {local} lanes on one card, engine "
        f"table setup (CUDA events, {reps} segments): {ms:.4f} ms per sharded segment, steps a "
        f"shard {n} ({ms / max(n) * 1e3:.2f} us per step of the largest); shard spans (ms "
        f"after the segment's start) {[[round(a, 4), round(b, 4)] for _, a, b in spans[-1]]}; "
        f"shards overlapped in every segment: {overlapped}; kernel time summed over shards / "
        f"span {sum(busy) / len(busy):.4f} / {sum(span) / len(span):.4f} ms; one shard alone "
        f"{one_ms:.4f} ms for {n0} steps ({one_ms / max(n0, 1) * 1e3:.2f} us/step at {local} "
        f"lanes); plain (shards in turn) {plain_ms:.1f} ms for segments of {n_p} steps "
        f"({plain_ms / n_p:.3f} ms a step of the four); bound {bound:.6f} ms (bytes, "
        f"{nbytes} bytes; counters {calls})")
    return {"ms": ms, "plain_ms": plain_ms, "plain_steps": n_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None, "steps_a_shard": n, "us_per_step": ms / max(n) * 1e3,
            "one_shard_us_per_step": one_ms / max(n0, 1) * 1e3, "shards_overlapped": overlapped,
            "kernel_ms_summed": sum(busy) / len(busy), "span_ms": sum(span) / len(span)}


def mesh_refill_checks(params_f32, reps: int) -> dict:
    """K7 a shard: refill_lanes_sharded on the card against
    refill_lanes_sharded_plain (K7's plain version a shard) on copies of
    a seeded-garbage MESH_LANES-lane state split into MESH_SHARDS shards
    of cuda:0, MESH_REFILL_LANES scattered lanes spliced with playout
    roots, depths, budgets, windows, jitters, groups and history seeds:
    every shard byte for byte. Then the shards' K7 launches timed (queued
    events) against their plain versions, and the bound from the bytes
    they move. → the kernels line's row stats."""
    import numpy as np
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.ops import search
    from fishnet_tpu_torch.ops.movegen import MAX_MOVES
    from fishnet_tpu_torch.parallel import mesh as mesh_mod

    mesh = _mesh()
    local = MESH_LANES // MESH_SHARDS
    dev = torch.device("cuda")
    state, _, _ = lane_init_case(params_f32, MESH_LANES, MESH_LANES, 41, dev, MAX_MOVES)
    rng = np.random.default_rng(43)
    n = MESH_REFILL_LANES
    lanes = rng.permutation(MESH_LANES)[:n]
    roots, _ = playout_boards(n, seed=47)
    splice = dict(
        hist_hash=rng.integers(-2**31, 2**31, (n, search.MAX_HIST, 2), dtype=np.int64).astype(
            np.int32),
        hist_halfmove=rng.integers(-32000, 100, (n, search.MAX_HIST)).astype(np.int32),
        root_alpha=rng.integers(-32500, 0, n).astype(np.int32),
        root_beta=rng.integers(0, 32501, n).astype(np.int32),
        order_jitter=np.where(np.arange(n) % 3, rng.integers(-2**31, 2**31, n), 0).astype(
            np.int32),
        group=rng.integers(0, MESH_LANES, n).astype(np.int32))
    depth = rng.integers(0, 12, n).astype(np.int32)
    budget = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    card = mesh_mod.shard_batch(mesh, search.SearchState(*[t.clone() for t in state]))
    plain = mesh_mod.shard_batch(mesh, search.SearchState(*[t.clone() for t in state]))
    kernels.reset_launches()
    mesh_mod.refill_lanes_sharded(mesh, params_f32, card, roots, lanes, depth, budget, **splice)
    torch.cuda.synchronize()
    k7 = kernels.LAUNCHES["lane_init"]
    mesh_mod.refill_lanes_sharded_plain(mesh, params_f32, plain, roots, lanes, depth, budget,
                                        **splice)
    torch.cuda.synchronize()
    err = max(_state_diff(a, b, None, None) for a, b in zip(card, plain))
    owners = sorted({int(x) // local for x in lanes})
    log(f"check lane_init mesh {MESH_SHARDS} shards x {local} lanes: {n} lanes spliced on "
        f"shards {owners} ({k7} K7 launches), max_abs_err={err} (tolerance 0; every shard "
        f"against refill_lanes_sharded_plain)")
    if err != 0 or k7 != len(owners):
        raise AssertionError(f"mesh K7: error {err}, {k7} launches for shards {owners}")
    # the shards' K7 launches alone, on their inputs (K1's rows from the card)
    jobs, nbytes = [], 0
    for s in owners:
        sel = np.nonzero(lanes // local == s)[0]
        idx, args = search._refill_inputs(
            params_f32, card[s], search.Board(*[t[torch.from_numpy(sel)] for t in roots]),
            lanes[sel] - s * local, depth[sel], budget[sel],
            **{k: v[sel] for k, v in splice.items()})
        jobs.append((card[s], idx, args))
        nbytes += lane_init_bytes(card[s], idx, args)
    (ms, call_ms), (plain_ms, _) = [
        time_ms(lambda f=f: [f(st, idx, *args) for st, idx, args in jobs], reps)
        for f in (kernels.lane_init, search.lane_init_plain)]
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"time lane_init mesh ({len(jobs)} shards' launches, {n} lanes): {ms:.5f} ms (call "
        f"{call_ms:.5f}), plain {plain_ms:.5f} ms, bound {bound:.6f} ms (bytes, {nbytes} bytes)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None}


def mesh_phase(params_f32, depth: int, n_positions: int) -> dict:
    """The lane mesh on one card: MESH_SHARDS shards of cuda:0, each with
    its own MESH_LANES / MESH_SHARDS lanes, table and CUDA stream. (1) the
    board768 main path through GpuEngine(mesh=...) at its defaults (refill,
    a 2^21-slot table a shard, K = 4 helpers, 64 lanes, f32): steps a
    shard and the largest, segments, refills, nodes, wall, ms/step,
    boundary host ms and transfers; it fails unless K1, K7 and K11 launched
    (K11 once a shard and segment). (2) The chunk without tables or
    helpers on the mesh and on one device: the same responses (lanes are
    independent). (3) K11 a shard against run_segment_plain, without and
    with tables; the sharded segment's time and whether the shards
    overlap. (4) K7 a shard against its plain version. → the launches of
    (1) and the two kernel rows' stats."""
    mesh = _mesh()
    launches, _, steps, _ = engine_phase(params_f32, depth, n_positions, refill=True, mesh=mesh)
    sharded = engine_phase(params_f32, depth, n_positions, refill=True, tt_on=False,
                           mesh=mesh)[1]
    single = engine_phase(params_f32, depth, n_positions, refill=True, tt_on=False)[1]
    if sharded != single:
        raise AssertionError(f"mesh, no table: {sharded} != one device {single}")
    log(f"mesh, no table: the {MESH_SHARDS}-shard chunk's {len(sharded)} responses equal the "
        f"one-device chunk's (score, pv, depth, nodes, best move)")
    seg = mesh_segment_times(params_f32, SEGMENT_REPS)
    seg["max_abs_err"] = mesh_segment_checks(params_f32)
    k7 = mesh_refill_checks(params_f32, REPS)
    return {"launches": launches, "steps": steps, "search_segment": seg, "lane_init": k7}


def digest(*tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def kernel_digests(dev) -> dict:
    """Digests of K2's, K6's, K9's and K13's outputs on fixed seeded
    inputs: K2 on k2_case's accumulators (f32, int8, bf16 nets), K9 with
    killers and history on rules_inputs (standard, crazyhouse) at 64 and
    1024 lanes, K9 on MOVEGEN_LONG's fixtures, K13 on the seeded Stockfish
    nets at L1 128 and 3072 (playouts at 64 and 1024 lanes) and on the
    fixtures of tests/test_torch_sf_eval.py, and the tables K6's
    prefer_deep store with mixed generations leaves on TT_CASES' inputs.
    Uses only entry points every tree of the port has."""
    import numpy as np
    import torch

    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.models import nnue_import as ni
    from fishnet_tpu_torch.ops import movegen as tm
    from fishnet_tpu_torch.ops import tt

    f32 = nnue.load_params(device=dev)
    nets = {"f32": f32, "int8": nnue.quantize_int8(f32), "bf16": nnue.cast_params(f32)}
    out = {}
    for B in (64, 1024):
        for net, p in nets.items():
            acc, stm, bucket = k2_inputs(B, B, "int8" if net == "int8" else "f32", dev)
            out[f"K2 {net} B={B}"] = digest(nnue.forward_from_acc(p, acc, stm, bucket))
        for v in ("standard", "crazyhouse"):
            b, killers, hist = rules_inputs(B, B, dev, v)
            out[f"K9 {v} B={B}"] = digest(*tm.generate_moves(b, killers, hist, variant=v))
    for v in sorted({fv for _, fv, _ in MOVEGEN_LONG}):
        _, b, killers, hist = movegen_long_inputs(v, dev)
        out[f"K9 long lists {v}"] = digest(*tm.generate_moves(b, killers, hist, variant=v))
    sf = {l1: ni.load_nnue(sf_file(l1, 7), device=dev) for l1 in (SF_SMALL_L1, SF_L1)}
    for B in (64, 1024):
        b = playout_boards(B, seed=100 + B)[0].to(dev)
        for l1, net in sf.items():
            out[f"K13 L1 {l1} B={B}"] = digest(ni.evaluate_sf(net, b.board, b.stm))
    fx = sf_fixtures()
    boards, stm = (torch.from_numpy(a).to(dev) for a in fx.sf_eval_boards())
    for l1 in fx.SF_EVAL_WIDTHS:
        net = ni.stockfish_net_from_numpy(fx.sf_eval_net(l1), dev)
        out[f"K13 fixtures L1 {l1}"] = digest(ni.evaluate_sf(net, boards, stm))
    for B, size_log2, n_slots in TT_CASES:
        c = tt_inputs(B, size_log2, B + size_log2 + n_slots, dev, n_slots)
        gen = torch.from_numpy(np.random.default_rng(B).integers(0, 3, B).astype(np.int32))
        table = tt.store(c["table"], *[c[k] for k in TT_STORE_ARGS], prefer_deep=True,
                         gen=gen.to(dev))
        out[f"K6 B={B} slots=2^{size_log2} on {n_slots or 'spread'}"] = digest(table)
    return out


def train_digests() -> dict:
    """Digests of the trainers' params on the card: train_material_net's
    after TRAIN_STEPS steps from the seeded init (train_phase's run) on a
    board768 and a king-bucketed net, and every position's after
    GRID_STEPS steps of the GRID grid of cuda:0 (grid_phase's checked
    run), both feature sets. Uses only entry points that every tree of the
    port with the training grid has."""
    from fishnet_tpu_torch.models import train

    out = {}
    for fs in TRAIN_PATH_KERNELS:
        params, _ = train.train_material_net(**train_kwargs(fs), device="cuda")
        out[f"train {fs}, {TRAIN_STEPS} steps"] = digest(train.flat_view(params))
        grid = grid_run(fs, ["cuda:0"] * (GRID[0] * GRID[1]), grid_batches()[:GRID_STEPS])[0]
        out[f"grid {GRID[0]}x{GRID[1]} {fs}, {GRID_STEPS} steps"] = digest(
            *[train.flat_view(p) for row in grid for p in row])
    return out


STEP_TABLE_LANES = (16, 64, 1024)


def k11_step_table(params_f32, reps: int, stockfish_only: bool = False) -> dict:
    """K11's us per step at STEP_TABLE_LANES lanes: a 200-step segment on
    segment_case's "engine" setup (the main path's table), after a warm-up
    segment, from the same state each time (CUDA events, the mean of `reps`
    launches), for standard chess and each variant on the f32 board768
    net, crazyhouse's ZH_POCKETS roots, the bf16 board768 net, the
    king-bucketed int8 net (KB_WIDTHS) and the Stockfish net at SF_L1
    (stockfish_only: that one, params_f32 then unused). Uses only entry
    points every tree of the port has. → {config: {lanes: us per step}}."""
    import torch

    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.models import nnue_import as ni
    from fishnet_tpu_torch.ops import search

    dev = torch.device("cuda")
    configs = []
    if not stockfish_only:
        kb = nnue.params_from_numpy(kb_case(*KB_WIDTHS, seed=5), dev)
        configs += [(v, params_f32, v, None) for v in ("standard",) + VARIANTS]
        configs += [(f"crazyhouse {k}", params_f32, "crazyhouse", fen)
                    for k, fen in ZH_POCKETS.items()]
        configs += [("bf16", nnue.cast_params(params_f32), "standard", None),
                    ("king-bucketed int8", nnue.quantize_int8(kb), "standard", None)]
    configs += [(f"Stockfish L1 {SF_L1}", ni.load_nnue(sf_file(SF_L1, 7), device=dev),
                 "standard", None)]
    table = {}
    for name, params, v, fen in configs:
        for B in STEP_TABLE_LANES:
            state0, table0, kw = segment_case(params, B, "engine", seed=B, dev=dev, variant=v,
                                              fens=None if fen is None else [fen] * B)
            state, tt_table = _clone(state0, table0)
            kw = dict(kw, table=tt_table)
            search.run_segment(params, state, 200, True, **kw)  # warm up
            total, steps = 0.0, 0
            for _ in range(reps):
                for t, t0 in zip(list(state) + [tt_table], list(state0) + [table0]):
                    t.copy_(t0)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                n, _ = search.run_segment(params, state, 200, True, **kw)
                end.record()
                torch.cuda.synchronize()
                total += start.elapsed_time(end)
                steps += n
            table.setdefault(name, {})[B] = total / steps * 1e3
    return table


def timed_chunk(engine) -> dict:
    """The POSITIONS-position chunk at DEPTH through engine.go_multiple:
    its wall seconds, responses, nodes, the digest of its responses (each
    position's depths, scores, PVs, nodes and best move) and the engine's
    occupancy totals."""
    import torch

    from fishnet_tpu_torch import ipc

    chunk = make_chunk(POSITIONS, DEPTH)
    t0 = time.monotonic()
    responses = asyncio.run(engine.go_multiple(chunk))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    wire = []
    for r in responses:
        w = ipc.response_to_wire(r)
        w.pop("time_s")
        w.pop("nps")
        wire.append(w)
    tot = engine.occupancy_totals
    return {"wall_s": wall, "responses": len(responses),
            "nodes": sum(r.nodes for r in responses),
            "digest": hashlib.sha256(json.dumps(wire, sort_keys=True).encode()).hexdigest()[:16],
            **{k: tot[k] for k in ("steps", "segments", "refills", "host_ms", "device_ms")}}


def main_path_run(root: str, reps: int) -> int:
    """The one-card board768 main path (GpuEngine at its defaults: refill,
    a 2^21 table, K = 4, f32; POSITIONS positions at DEPTH) `reps` times
    in one process with the fishnet_tpu_torch package of the tree `root`,
    each run's counts, times and the digest of its responses (each
    position's depths, scores, PVs, nodes and best move) one JSON line;
    then the same chunk once on the seeded Stockfish net at SF_L1 (its
    responses' digest, steps and nodes), one line of kernel_digests, one
    of train_digests and one of k11_step_table. Uses only what every tree of the port with the
    training grid has, so an earlier commit's tree runs it too."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.engine.gpu import GpuEngine
    from fishnet_tpu_torch.models import nnue

    if not kernels.__file__.startswith(root):
        raise AssertionError(f"imported {kernels.__file__}, not the tree {root}")
    os.environ["FISHNET_TPU_MAX_PLY"] = "32"
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    kernels.build()
    build_s = time.monotonic() - t0
    params = nnue.load_params(device="cuda")
    for rep in range(reps):
        run = timed_chunk(GpuEngine(params=params, max_depth=DEPTH))
        run["responses_digest"] = run.pop("digest")
        print(json.dumps({"tree": root, "rep": rep, "build_s": build_s, **run}), flush=True)
    # the Stockfish net's chunk (K13's units inside K11), once
    run = timed_chunk(GpuEngine(weights_path=str(sf_file(SF_L1, 7)), max_depth=DEPTH))
    run["sf_responses_digest"] = run.pop("digest")
    print(json.dumps({"tree": root, "net": f"Stockfish L1 {SF_L1}", **run}), flush=True)
    print(json.dumps({"tree": root, "kernel_digests": kernel_digests(torch.device("cuda"))}),
          flush=True)
    print(json.dumps({"tree": root, "train_digests": train_digests()}), flush=True)
    print(json.dumps({"tree": root, "k11_us_per_step": k11_step_table(params, 3)}), flush=True)
    return 0


def main_path_ab(parent: str, reps: int) -> int:
    """The one-card main path of an earlier tree (`parent`, unpacked with
    git archive) and of this one, in that order: parent, this, this,
    parent, each in a process of its own (main_path_run), so host and
    card drift show as the two parent runs' difference. Prints each run's
    lines, then one line saying whether every run's responses digest and
    the four processes' kernel and trainer digests are equal, then the
    card's name and power limit; exits 1 where they differ."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs, sf_runs, kernel_sets, train_sets = set(), set(), set(), set()
    for root in (parent, here, here, parent):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--main-path-run",
                              root, str(reps)], capture_output=True, text=True, timeout=900)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
        for line in out.stdout.splitlines():
            if not line.startswith("{"):  # a log line
                continue
            row = json.loads(line)
            if "responses_digest" in row:
                runs.add((row["responses_digest"], row["steps"], row["nodes"]))
            if "sf_responses_digest" in row:
                sf_runs.add((row["sf_responses_digest"], row["steps"], row["nodes"]))
            if "kernel_digests" in row:
                kernel_sets.add(json.dumps(row["kernel_digests"], sort_keys=True))
            if "train_digests" in row:
                train_sets.add(json.dumps(row["train_digests"], sort_keys=True))
    same = (len(runs) == 1 and len(sf_runs) == 1 and len(kernel_sets) == 1
            and len(train_sets) == 1)
    print(json.dumps({"digests_equal": same, "runs": sorted(runs), "sf_runs": sorted(sf_runs),
                      "kernel_digest_sets": len(kernel_sets),
                      "train_digest_sets": len(train_sets)}))
    print(card_line())
    return 0 if same else 1


SPLIT_LANES = (16, 64, 1024)
SPLIT_STEPS = 200
SPLIT_HEAD = """
// k11-split measurement build: thread 0 of each warp sums its cycles
__device__ unsigned long long k11_split[4];  // barriers, lane steps, step loop, warps
FISHNET_EXPORT int k11_split_read(void* out) {
    return (int)cudaMemcpyFromSymbol(out, k11_split, sizeof(k11_split));
}
FISHNET_EXPORT int k11_split_reset() {
    const unsigned long long zero[4] = {0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(k11_split, zero, sizeof(zero));
}
"""


def split_source(text: str, cooperative: bool = False) -> str:
    """A tree's csrc/search_segment.cu with k11_split's clock64() counters
    in its segment kernel: around each barrier in the kernel's body
    (`grid.sync();` or `barrier(grid, ...);`) and each step_lane call,
    and over the step loop (from `int n = 0;` to the summary's loop),
    added at the kernel's end into k11_split (SPLIT_HEAD); cooperative:
    a launcher that would launch one thread-block cluster launches the
    cooperative grid instead. Raises where the text has not the
    statements it patches."""
    import re

    def sub(pattern, repl, src, count=0):
        out, n = re.subn(pattern, repl, src, count=count)
        if not n:
            raise AssertionError(f"k11-split: no {pattern!r} in search_segment.cu")
        return out

    text = sub(r'(#include "search\.cuh"\n)', lambda m: m.group(1) + SPLIT_HEAD, text, 1)
    if cooperative:
        text = sub(r"a\.one_cluster = fits_one_cluster<Net, V>\(dev, grid\);",
                   "a.one_cluster = false;", text, 1)
    head, sep, body = text.partition("segment_kernel(const Segment<Net> a) {")
    body, tail_sep, tail = body.partition("constexpr int MAX_DEVICES")
    body = sub(r"(unsigned calls\[N_BODY\];\n)",
               r"\1    long long split_bar = 0, split_step = 0, split_t0 = 0;\n", body, 1)
    body = sub(r"\n(\s*)((?:grid\.sync\(\)|barrier\(grid, \w+\));)",
               r"\n\1{ const long long c0 = clock64(); \2 split_bar += clock64() - c0; }",
               body)
    body = sub(r"(live \|= step_lane<Net, V>\(a, lane, s, t, calls[^;]*\);)",
               r"{ const long long c0 = clock64(); \1 split_step += clock64() - c0; }", body)
    body = sub(r"(\n    int n = 0;\n)", r"\1    split_t0 = clock64();\n    split_bar = 0;\n",
               body, 1)
    body = sub(r"(\n    for \(int lane = first_warp; lane < a\.B; lane \+= n_warps\) \{\n"
               r"        if \(t < 4\) \{)",
               r"\n    const long long split_loop = clock64() - split_t0;\1", body, 1)
    body = sub(r"(\n    if \(t == 0\) \{\n        for \(int i = 0; i < N_BODY; \+\+i\) \{)",
               r"\n    if (t == 0) {\n        atomicAdd(k11_split, (unsigned long long)split_bar);"
               r"\n        atomicAdd(k11_split + 1, (unsigned long long)split_step);"
               r"\n        atomicAdd(k11_split + 2, (unsigned long long)split_loop);"
               r"\n        atomicAdd(k11_split + 3, 1ull);\n    }\1", body, 1)
    return head + sep + body + tail_sep + tail


def k11_split_run(root: str, launch: str) -> int:
    """One tree's split (k11_split): its package copied under
    build/k11-split/, split_source patched in (launch "cooperative": with
    the cooperative grid only), built, then per lane count
    a warm-up segment and 3 timed SPLIT_STEPS-step segments from
    segment_case's "engine" state (board768 f32), each with the counters
    reset before
    and read after it; one JSON line of cycles a step averaged over the
    warps, and the timed segments' us a step (CUDA events)."""
    import ctypes
    import glob
    import shutil

    import numpy as np

    root = os.path.abspath(root)
    here = os.path.dirname(os.path.abspath(__file__))
    tag = hashlib.sha256(f"{root} {launch}".encode()).hexdigest()[:8]
    dest = os.path.join(here, "build", "k11-split", tag)
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(os.path.join(root, "fishnet_tpu_torch"),
                    os.path.join(dest, "fishnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(dest, "fishnet_tpu_torch", "csrc", "search_segment.cu")
    with open(src) as f:
        text = split_source(f.read(), launch == "cooperative")
    with open(src, "w") as f:
        f.write(text)
    sys.path.insert(0, dest)
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import search

    if not kernels.__file__.startswith(dest):
        raise AssertionError(f"imported {kernels.__file__}, not the copy in {dest}")
    os.environ["FISHNET_TPU_MAX_PLY"] = "32"
    kernels.build()
    lib = ctypes.CDLL(glob.glob(os.path.join(dest, "build", "kernels-*",
                                             "libsearch_segment_standard.so"))[0])
    lib.k11_split_read.argtypes = [ctypes.c_void_p]
    lib.k11_split_read.restype = lib.k11_split_reset.restype = ctypes.c_int
    dev = torch.device("cuda")
    params = nnue.load_params(device=dev)
    split = {}
    for B in SPLIT_LANES:
        state0, table0, kw = segment_case(params, B, "engine", seed=B, dev=dev)
        state, table = _clone(state0, table0)
        kw = dict(kw, table=table)
        search.run_segment(params, state, SPLIT_STEPS, True, **kw)  # warm up
        sums, steps, ms = np.zeros(4), 0, 0.0
        for _ in range(3):
            for t, t0 in zip(list(state) + [table], list(state0) + [table0]):
                t.copy_(t0)
            torch.cuda.synchronize()
            if lib.k11_split_reset():
                raise RuntimeError("k11_split_reset failed")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            n, _ = search.run_segment(params, state, SPLIT_STEPS, True, **kw)
            end.record()
            torch.cuda.synchronize()
            ms += start.elapsed_time(end)
            out = (ctypes.c_ulonglong * 4)()
            if lib.k11_split_read(out):
                raise RuntimeError("k11_split_read failed")
            sums += np.asarray(list(out), np.float64)
            steps += n
        warps = sums[3] / 3
        per = sums[:3] / warps / steps  # cycles a step, averaged over the warps
        split[B] = {"barrier_waits": per[0], "lane_steps": per[1],
                    "table_and_flags": per[2] - per[0] - per[1], "step_loop": per[2],
                    "warps": warps, "steps": steps / 3, "grid": kernels.LAST_GRID["blocks"],
                    "us_per_step": ms / steps * 1e3}
    print(json.dumps({"tree": root, "launch": launch, "cycles_per_step": split}), flush=True)
    return 0


def k11_split(roots) -> int:
    """k11_split_run for each tree in turn, each in a process of its own
    (a tree that launches one thread-block cluster also as the cooperative
    grid), then the card's name and power limit."""
    for root in roots:
        with open(os.path.join(root, "fishnet_tpu_torch", "csrc", "search_segment.cu")) as f:
            clusters = "fits_one_cluster" in f.read()
        for launch in ("default",) + (("cooperative",) if clusters else ()):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--k11-split-run",
                                  root, launch], capture_output=True, text=True, timeout=900)
            sys.stdout.write(out.stdout)
            if out.returncode:
                sys.stderr.write(out.stderr[-4000:])
                return out.returncode
    print(card_line())
    return 0


# --sf-split: K11's Stockfish step in parts. The measurement build adds
# to --k11-split's counters (barrier waits, lane steps, the step loop) the
# Stockfish spread's (csrc/search.cuh sf_own, sf_help), summed by thread 0
# of each warp: the owners' waits, the units the owners and the helpers
# ran (cycles and counts), the helping (sf_help, its units and its spins),
# and the jobs posted.
SF_SPLIT_HEAD = """
// sf-split measurement build: owner waits, owners' units, helpers' units,
// helping, owners' unit count, helpers' unit count, jobs
__device__ unsigned long long sf_split[7];
"""
SF_SPLIT_READ = """
FISHNET_EXPORT int sf_split_read(void* out) {
    return (int)cudaMemcpyFromSymbol(out, sf_split, sizeof(sf_split));
}
FISHNET_EXPORT int sf_split_reset() {
    const unsigned long long zero[7] = {0, 0, 0, 0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(sf_split, zero, sizeof(zero));
}
"""


def _sf_timed(stmt: str, slot: int, count: int = -1) -> str:
    """stmt (a warp's statement) timed by clock64(), its cycles (thread 0)
    added to sf_split[slot] and, with count >= 0, one to sf_split[count]."""
    tail = f" atomicAdd(sf_split + {count}, 1ull);" if count >= 0 else ""
    return (f"{{ const long long sf_c0 = clock64(); {stmt} if (t == 0) {{ "
            f"atomicAdd(sf_split + {slot}, (unsigned long long)(clock64() - sf_c0));{tail} }} }}")


def sf_split_sources(segment: str, search: str) -> tuple:
    """A tree's search_segment.cu and search.cuh with the --sf-split
    counters: split_source's, and (where the tree spreads K13's units)
    around sf_own's waits and units, sf_help's units and sf_help itself,
    and a count of sf_post's jobs. A tree without the spread gets
    split_source's alone."""
    segment = split_source(segment)
    spread = "sf_help(a, n, s, t);" in segment
    if not spread:
        return segment, search, False
    segment = segment.replace('#include "search.cuh"\n', '#include "search.cuh"\n' + SF_SPLIT_READ,
                              1)
    segment = segment.replace("if constexpr (Net::KIND == STOCKFISH) sf_help(a, n, s, t);",
                              "if constexpr (Net::KIND == STOCKFISH) "
                              + _sf_timed("sf_help(a, n, s, t);", 3), 1)
    patches = (
        ("if (t == 0) sf_wait(job + SF_JOB_FT_DONE, units);", 0, -1),
        ("if (t == 0) sf_wait(job + SF_JOB_FC_DONE, nnue::SF_FC0_UNITS);", 0, -1),
        ("nnue::sf_ft_unit(f, stm, u, a.net, x, t);", 1, 4),
        ("nnue::sf_fc0_unit(bucket, i, a.net, x, chains, t);", 1, 4),
        ("nnue::sf_ft_unit(s.feat, stm, u, a.net, x, t);", 2, 5),
        ("nnue::sf_fc0_unit(__ldcg(job + SF_JOB_BUCKET), u, a.net, x,\n"
         "                                  x + nnue::sf_x_stride(a.net.l1), t);", 2, 5),
    )
    for text, slot, count in patches:
        if search.count(text) != 1:
            raise AssertionError(f"--sf-split: {text!r} found {search.count(text)} times")
        search = search.replace(text, _sf_timed(text, slot, count))
    post = "    if (t == 0) atomicExch(job + SF_JOB_READY, step + 1);\n"
    if search.count(post) != 1:
        raise AssertionError("--sf-split: no job post in search.cuh")
    search = search.replace(post, post + "    if (t == 0) atomicAdd(sf_split + 6, 1ull);\n")
    search = search.replace("namespace search {\n", SF_SPLIT_HEAD + "namespace search {\n", 1)
    return segment, search, True


def patched_package(root: str, where: str, patch) -> str:
    """The tree root's fishnet_tpu_torch copied to build/<where>/ with
    patch({csrc file name: text}) → {name: new text} written over its
    csrc files, the copy first on sys.path; → the copy's root. A build
    left in the copy from an earlier call stays (kernels.build keys its
    directory by the sources)."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    dest = os.path.join(here, "build", where)
    shutil.rmtree(os.path.join(dest, "fishnet_tpu_torch"), ignore_errors=True)
    shutil.copytree(os.path.join(root, "fishnet_tpu_torch"),
                    os.path.join(dest, "fishnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    csrc = os.path.join(dest, "fishnet_tpu_torch", "csrc")
    texts = {}
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name)) as f:
            texts[name] = f.read()
    for name, text in patch(texts).items():
        with open(os.path.join(csrc, name), "w") as f:
            f.write(text)
    sys.path.insert(0, dest)
    return dest


def sf_split_run(root: str) -> int:
    """One tree's --sf-split: its package copied under build/sf-split/,
    sf_split_sources patched in, built, then per lane count (SPLIT_LANES)
    a warm-up segment and 3 timed SPLIT_STEPS-step segments from
    segment_case's "engine" state on the seeded Stockfish net at SF_L1; one
    JSON line of cycles a step averaged over the warps (and the owners'
    waits and units per job), and the timed segments' us a step."""
    import ctypes
    import glob

    import numpy as np

    root = os.path.abspath(root)
    flags = {}

    def patch(texts):
        segment, search_h, flags["spread"] = sf_split_sources(texts["search_segment.cu"],
                                                              texts["search.cuh"])
        return {"search_segment.cu": segment, "search.cuh": search_h}

    dest = patched_package(root, os.path.join(
        "sf-split", hashlib.sha256(root.encode()).hexdigest()[:8]), patch)
    spread = flags["spread"]
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue_import as ni
    from fishnet_tpu_torch.ops import search

    if not kernels.__file__.startswith(dest):
        raise AssertionError(f"imported {kernels.__file__}, not the copy in {dest}")
    os.environ["FISHNET_TPU_MAX_PLY"] = "32"
    kernels.build()
    lib = ctypes.CDLL(glob.glob(os.path.join(dest, "build", "kernels-*",
                                             "libsearch_segment_standard.so"))[0])
    fns = [("k11_split", 4)] + ([("sf_split", 7)] if spread else [])
    for name, _ in fns:
        getattr(lib, f"{name}_read").argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    params = ni.load_nnue(sf_file(SF_L1, 7), device=dev)
    split = {}
    for B in SPLIT_LANES:
        state0, table0, kw = segment_case(params, B, "engine", seed=B, dev=dev)
        state, table = _clone(state0, table0)
        kw = dict(kw, table=table)
        search.run_segment(params, state, SPLIT_STEPS, True, **kw)  # warm up
        sums = {name: np.zeros(n) for name, n in fns}
        steps, ms = 0, 0.0
        for _ in range(3):
            for t, t0 in zip(list(state) + [table], list(state0) + [table0]):
                t.copy_(t0)
            torch.cuda.synchronize()
            for name, _ in fns:
                if getattr(lib, f"{name}_reset")():
                    raise RuntimeError(f"{name}_reset failed")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            n, _ = search.run_segment(params, state, SPLIT_STEPS, True, **kw)
            end.record()
            torch.cuda.synchronize()
            ms += start.elapsed_time(end)
            for name, size in fns:
                out = (ctypes.c_ulonglong * size)()
                if getattr(lib, f"{name}_read")(out):
                    raise RuntimeError(f"{name}_read failed")
                sums[name] += np.asarray(list(out), np.float64)
            steps += n
        k = sums["k11_split"]
        warps = k[3] / 3
        per = k[:3] / warps / steps  # cycles a step, averaged over the warps
        row = {"barrier_waits": per[0], "lane_steps": per[1], "step_loop": per[2],
               "warps": warps, "steps": steps / 3, "grid": kernels.LAST_GRID["blocks"],
               "us_per_step": ms / steps * 1e3}
        if spread:
            sf = sums["sf_split"]
            jobs = max(sf[6], 1.0)
            row.update(
                owner_waits=sf[0] / warps / steps, owner_units=sf[1] / warps / steps,
                helper_units=sf[2] / warps / steps, helping=sf[3] / warps / steps,
                jobs_per_step=sf[6] / steps, units_per_job_by_owner=sf[4] / jobs,
                units_per_job_by_helpers=sf[5] / jobs, owner_wait_per_job=sf[0] / jobs,
                unit_cycles=(sf[1] + sf[2]) / max(sf[4] + sf[5], 1.0))
        split[B] = row
    print(json.dumps({"tree": root, "net": f"Stockfish L1 {SF_L1}", "cycles_per_step": split}),
          flush=True)
    return 0


def sf_split(roots) -> int:
    """sf_split_run for each tree in turn, each in a process of its own,
    then the card's name and power limit."""
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--sf-split-run", root],
                             capture_output=True, text=True, timeout=900)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
    print(card_line())
    return 0


# --sf-variants: the Stockfish spread's two knobs on the main path. A
# variant is a measurement build of this tree with K11's grid on a
# Stockfish net ("own": the launch's lanes' blocks, one cluster at 16 and
# 64 lanes; "all": every resident block, cooperative) and the rows a
# feature-transform unit's loads put in flight (SF_ROW_GROUP) set.
SF_GRID_LINES = {
    "own": "const int grid = want < fit ? want : fit;",
    "all": "const int grid = Net::KIND == STOCKFISH || want > fit ? fit : want;",
}
SF_VARIANTS = (("own", 4), ("own", 8), ("all", 4), ("all", 8))


def sf_variant_sources(texts: dict, grid: str, row_group: int) -> dict:
    """search_segment.cu and nnue.cuh of texts with K11's Stockfish grid
    (SF_GRID_LINES) and SF_ROW_GROUP set."""
    import re

    segment = texts["search_segment.cu"]
    found = [k for k, line in SF_GRID_LINES.items() if line in segment]
    if len(found) != 1:
        raise AssertionError(f"--sf-variants: the grid line matched {found}")
    segment = segment.replace(SF_GRID_LINES[found[0]], SF_GRID_LINES[grid])
    nnue_h, n = re.subn(r"constexpr int SF_ROW_GROUP = \d+;",
                        f"constexpr int SF_ROW_GROUP = {row_group};", texts["nnue.cuh"])
    if n != 1:
        raise AssertionError(f"--sf-variants: SF_ROW_GROUP found {n} times")
    return {"search_segment.cu": segment, "nnue.cuh": nnue_h}


def sf_variant_run(grid: str, row_group: int, reps: int) -> int:
    """One --sf-variants build (this tree patched by sf_variant_sources
    under build/sf-variants/): the Stockfish net's chunk (the main path's
    second chunk, GpuEngine at SF_L1) `reps` times in one process (its
    wall, device ms, steps, nodes and responses' digest each), K11's us a
    Stockfish step (k11_step_table) and K13's warm ms at 1024 lanes; one
    JSON line."""
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    patched_package(here, f"sf-variants/{grid}-{row_group}",
                    lambda texts: sf_variant_sources(texts, grid, row_group))
    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.engine.gpu import GpuEngine
    from fishnet_tpu_torch.models import nnue_import as ni

    if "sf-variants" not in kernels.__file__:
        raise AssertionError(f"imported {kernels.__file__}, not a variant's copy")
    os.environ["FISHNET_TPU_MAX_PLY"] = "32"
    torch.backends.cuda.matmul.allow_tf32 = False
    build_s = kernels.build()
    chunks = [timed_chunk(GpuEngine(weights_path=str(sf_file(SF_L1, 7)), max_depth=DEPTH))
              for _ in range(reps)]
    chunk_grid = kernels.LAST_GRID["blocks"]  # the chunk's last launch
    dev = torch.device("cuda")
    net = ni.load_nnue(sf_file(SF_L1, 7), device=dev)
    b = playout_boards(1024, seed=1124)[0].to(dev)
    k13_ms = time_ms(lambda: kernels.nnue_evaluate_sf(b.board, b.stm, net), NET_REPS)[0]
    steps = k11_step_table(None, 3, stockfish_only=True)[f"Stockfish L1 {SF_L1}"]
    print(json.dumps({"grid": grid, "row_group": row_group, "build_s": build_s,
                      "chunks": chunks, "chunk_grid": chunk_grid, "k11_us_per_step": steps,
                      "k13_1024_warm_ms": k13_ms}), flush=True)
    return 0


def sf_variants(reps: int) -> int:
    """sf_variant_run for each of SF_VARIANTS, then again in the reverse
    order (host and card drift show as a variant's two processes'
    difference), each in a process of its own; then one line saying
    whether every chunk's responses and steps were the same, and the
    card's name and power limit. Exits 1 where they differ."""
    seen = set()
    for grid, row_group in SF_VARIANTS + SF_VARIANTS[::-1]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--sf-variant-run",
                              grid, str(row_group), str(reps)],
                             capture_output=True, text=True, timeout=900)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                seen |= {(c["digest"], c["steps"], c["nodes"]) for c in json.loads(line)["chunks"]}
    print(json.dumps({"chunks_equal": len(seen) == 1, "chunks": sorted(seen)}))
    print(card_line())
    return 0 if len(seen) == 1 else 1


# the measurement build of --ft-split: (text in csrc/ft_backward.cuh, text
# put after it) — each warp of K15's and K18's passes stamps the globaltimer
# at its start, at its end, and (rows and sums) where its wait returned,
# for the call the host selects
FT_SPLIT_HEAD = """namespace ftb {
__device__ unsigned long long wt[4][8192][4];
__device__ int wt_on;
__device__ __forceinline__ void stamp(int k, int j) {
    const int wid = (blockIdx.y * gridDim.x + blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
    if (wt_on && (threadIdx.x & 31) == 0 && wid < 8192) {
        unsigned long long t;
        asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
        wt[k][wid][j] = t;
    }
}
"""
FT_SPLIT_STAMPS = (  # (text, the same text with its stamp)
    ("    const int s0 = blockIdx.x * MARK_SAMPLES;\n",
     "    const int s0 = blockIdx.x * MARK_SAMPLES;\n    stamp(0, 0);\n"),
    ("spread16(m >> (lane & 16)) << p);\n        }\n    }\n}\n",
     "spread16(m >> (lane & 16)) << p);\n        }\n    }\n    stamp(0, 1);\n}\n"),
    ("    const int row0 = (blockIdx.x * WARPS + w) * ROWS_PER_WARP;\n",
     "    const int row0 = (blockIdx.x * WARPS + w) * ROWS_PER_WARP;\n    stamp(1, 0);\n"),
    ("    wait_for_previous();  // the mark pass's bits\n",
     "    wait_for_previous();  // the mark pass's bits\n    stamp(1, 2);\n"),
    ("            if (cb < l1) out[cb] = sb;\n        }\n    }\n}\n",
     "            if (cb < l1) out[cb] = sb;\n        }\n    }\n    stamp(1, 1);\n}\n"),
    ("    const int c0 = blockIdx.x * 32, c = c0 + lane;\n",
     "    const int c0 = blockIdx.x * 32, c = c0 + lane;\n    stamp(2, 0);\n"),
    ("    wait_for_previous();  // the row pass's list\n",
     "    wait_for_previous();  // the row pass's list\n    stamp(2, 2);\n"),
    ("        if (c < l1) *out = s;\n        __syncwarp();\n    }\n",
     "        if (c < l1) *out = s;\n        __syncwarp();\n    }\n    stamp(2, 1);\n"),
    ("    const int t = threadIdx.x, lane = t & 31, c = blockIdx.x * 32 + lane;\n",
     "    const int t = threadIdx.x, lane = t & 31, c = blockIdx.x * 32 + lane;\n"
     "    stamp(3, 0);\n"),
    ("    if (t >= 32) return;\n", "    if (t >= 32) return;\n    stamp(3, 2);\n"),
    ("    if (c < l1) *out = s;\n}\n", "    if (c < l1) *out = s;\n    stamp(3, 1);\n}\n"),
)
FT_SPLIT_TAIL = """
FISHNET_EXPORT int ft_split_on(int on, void* stream) {
    return (int)cudaMemcpyToSymbolAsync(ftb::wt_on, &on, sizeof(on), 0, cudaMemcpyHostToDevice,
                                        (cudaStream_t)stream);
}
FISHNET_EXPORT int ft_split_read(void* host) {
    return (int)cudaMemcpyFromSymbol(host, ftb::wt, sizeof(ftb::wt));
}
"""


def ft_split_source(text: str) -> str:
    """csrc/ft_backward.cuh with FT_SPLIT_STAMPS patched in (each text
    found once: a changed source fails here, not on the card)."""
    for old, new in (("namespace ftb {\n", FT_SPLIT_HEAD),) + FT_SPLIT_STAMPS:
        if text.count(old) != 1:
            raise AssertionError(f"--ft-split: {old!r} found {text.count(old)} times")
        text = text.replace(old, new)
    return text + FT_SPLIT_TAIL


def ft_split() -> int:
    """Where K15's and K18's time goes, pass by pass: a copy of the package
    under build/ft-split/ whose csrc/ft_backward.cuh stamps each warp's
    start, end and wait (ft_split_source), built; for each net, on the
    trainer's seeded batch and on 512 start positions (TRAIN_BATCH, L1 64),
    six calls queued behind a spin, the fifth stamped; one JSON line each:
    per pass (mark, rows, sums, ft_b) its warps, first start, last end,
    median and longest warp (us from the call's first stamp), and for the
    row and sum passes when the waits returned (ft_b: when its slice had
    landed). A measurement build: the package itself has no stamps."""
    import ctypes
    import glob
    import shutil

    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    dest = os.path.join(here, "build", "ft-split")
    shutil.rmtree(dest, ignore_errors=True)
    shutil.copytree(os.path.join(here, "fishnet_tpu_torch"),
                    os.path.join(dest, "fishnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(dest, "fishnet_tpu_torch", "csrc", "ft_backward.cuh")
    with open(src) as f:
        text = ft_split_source(f.read())
    with open(src, "w") as f:
        f.write(text)
    sys.path.insert(0, dest)
    import torch

    from fishnet_tpu_torch import kernels

    if not kernels.__file__.startswith(dest):
        raise AssertionError(f"imported {kernels.__file__}, not the copy in {dest}")
    kernels.build()
    dev = torch.device("cuda")
    buf = (ctypes.c_ulonglong * (4 * 8192 * 4))()
    for fs in TRAIN_PATH_KERNELS:
        name, wrapper, _, rows = ft_kernel(fs)
        lib = ctypes.CDLL(glob.glob(os.path.join(dest, "build", "kernels-*", f"lib{name}.so"))[0])
        lib.ft_split_on.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.ft_split_read.argtypes = [ctypes.c_void_p]
        for kind in ("seeded", "start"):
            boards, d_acc = (torch.from_numpy(a).to(dev)
                             for a in ft_case(TRAIN_BATCH, 64, seed=50, kind=kind))
            g = torch.empty((rows + 1) * 64, device=dev)
            for _ in range(3):
                wrapper(boards, d_acc, g)
            torch.cuda.synchronize()
            ctypes.memset(buf, 0, ctypes.sizeof(buf))
            stream = torch.cuda.current_stream().cuda_stream
            torch.cuda._sleep(QUEUE_SPIN_CYCLES)
            for i in range(6):
                if lib.ft_split_on(int(i == 4), stream):
                    raise RuntimeError("ft_split_on failed")
                wrapper(boards, d_acc, g)
            torch.cuda.synchronize()
            if lib.ft_split_read(ctypes.addressof(buf)):
                raise RuntimeError("ft_split_read failed")
            a = np.frombuffer(buf, dtype=np.uint64).reshape(4, 8192, 4).astype(np.float64)
            live = (a[:, :, 0] > 0) & (a[:, :, 1] > 0)  # ft_b: the adding warps
            t0 = a[0][live[0], 0].min()
            out = {"kernel": name, "boards": kind}
            for k, stage in enumerate(("mark", "rows", "sums", "ft_b")):
                x = (a[k][live[k]] - t0) / 1e3
                dur = x[:, 1] - x[:, 0]
                row = {"warps": int(len(x)), "first_start_us": float(x[:, 0].min()),
                       "last_end_us": float(x[:, 1].max()), "median_warp_us": float(np.median(dur)),
                       "longest_warp_us": float(dur.max())}
                if k:
                    waited = x[:, 2][a[k][live[k]][:, 2] > 0]
                    if len(waited):
                        row["waited_until_us"] = [float(waited.min()), float(waited.max())]
                out[stage] = row
            print(json.dumps(out), flush=True)
    print(card_line())
    return 0


def ptxas_run(root: str) -> int:
    """ptxas's registers, stack frame and spills for every kernel entry
    and out-of-line device function of the tree `root`'s libraries:
    each library's nvcc (the build's flags and headers, -Xptxas -v) into
    a scratch directory, all started together; one JSON line."""
    import re
    import tempfile

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    from fishnet_tpu_torch import kernels

    if not kernels.__file__.startswith(root):
        raise AssertionError(f"imported {kernels.__file__}, not the tree {root}")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fname, text in kernels._headers().items():
            os.makedirs(os.path.dirname(os.path.join(tmp, fname)), exist_ok=True)
            with open(os.path.join(tmp, fname), "w") as f:
                f.write(text)
        procs = {}
        for lib, source in kernels._LIBRARY_SOURCE.items():
            own = os.path.join(tmp, lib)
            procs[lib] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v",
                 *(["-I", own] if os.path.isdir(own) else []), "-I", tmp,
                 "-o", os.path.join(tmp, f"{lib}.so"), str(kernels.CSRC / f"{source}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for lib, proc in procs.items():
            log_text, _ = proc.communicate(timeout=900)
            if proc.returncode:
                raise RuntimeError(f"{lib}: nvcc exit {proc.returncode}\n{log_text}")
            rows, name = {}, None
            for line in log_text.splitlines():
                m = re.search(r"(?:Compiling entry function '|Function properties for )(\w+)",
                              line)
                if m:
                    name = m.group(1)
                    continue
                m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line)
                if m and name:
                    rows.setdefault(name, {}).update(
                        stack=int(m.group(1)), spill_stores=int(m.group(2)),
                        spill_loads=int(m.group(3)))
                m = re.search(r"Used (\d+) registers", line)
                if m and name:
                    rows.setdefault(name, {})["registers"] = int(m.group(1))
            names = subprocess.run(["c++filt"], input="\n".join(rows), capture_output=True,
                                   text=True).stdout.splitlines() or list(rows)
            names = [re.sub(r"\(anonymous namespace\)::|search::|nnue::", "", n) for n in names]
            out[lib] = {n[:n.rfind("(")] if "(" in n else n: row
                        for n, row in zip(names, rows.values())}
    print(json.dumps({"tree": root, "ptxas": out}), flush=True)
    return 0


def ptxas(roots) -> int:
    """ptxas_run for each tree in turn, each in a process of its own."""
    for root in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--ptxas-run", root],
                             capture_output=True, text=True, timeout=1200)
        sys.stdout.write(out.stdout)
        if out.returncode:
            sys.stderr.write(out.stderr[-4000:])
            return out.returncode
    return 0


def main() -> int:
    import torch

    started = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from fishnet_tpu_torch import kernels
        from fishnet_tpu_torch.models import nnue
    except ImportError as e:
        print(f"chip_smoke: run it from the repository root ({e})", file=sys.stderr)
        return 2
    os.environ["FISHNET_TPU_MAX_PLY"] = "32"  # the production stack
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc {nvcc_version()}; {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.monotonic()
    kernels.build()
    log(f"build: {time.monotonic() - t0:.1f} s")

    params = nnue.load_params(device="cuda")
    t0 = time.monotonic()
    nets = full_eval_nets(torch.device("cuda"))
    log(f"full-eval nets (seeded, L1 {SF_SMALL_L1} and {SF_L1} through .nnue files): "
        f"{time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()

    def part(name, run):
        """One part of the kernel phase, its seconds logged."""
        t = time.monotonic()
        out = run()
        log(f"kernel phase, {name}: {time.monotonic() - t:.1f} s")
        return out

    stats = part("K1-K4", lambda: kernel_phase(params, REPS))
    edge = part("K2 at the clip edges", lambda: k2_edge_phase(params, REPS))
    k2 = stats["nnue_forward_from_acc"]
    k2.update(max_abs_err=max(k2["max_abs_err"], edge.pop("max_abs_err")), **edge)
    stats.update(part("K5, K6", lambda: tt_kernel_phase(REPS)))
    stats.update(part("K7", lambda: lane_init_phase(REPS)))
    rules = {v: part(f"K4, K8-K10 {v}", lambda v=v: rules_kernel_phase(
        REPS if v == "standard" else VARIANT_REPS, v)) for v in ("standard",) + VARIANTS}
    # standard chess's K4 is timed in kernel_phase (with its library-free
    # ops bound); here it adds its checks on the rules positions
    k4 = rules["standard"].pop("zobrist_hash")
    stats["zobrist_hash"]["max_abs_err"] = max(stats["zobrist_hash"]["max_abs_err"],
                                               k4["max_abs_err"])
    stats.update(rules.pop("standard"))
    variant_rules = {name: {v: rules[v][name] for v in VARIANTS} for name in rules[VARIANTS[0]]}
    variant_rules["lane_init"] = stats["lane_init"].pop("variants")
    stats.update(part("K11", lambda: segment_phase(params, SEGMENT_REPS)))
    stats.update(part("K12, K13", lambda: nets_kernel_phase(nets, NET_REPS)))
    part("K12 warm readings", lambda: k12_warm_readings(nets["kb f32"]))
    part("K11 on the full-eval nets", lambda: nets_segment_phase(nets, SEGMENT_REPS))
    stats.update(part("K14-K16", lambda: train_kernel_phase(TRAIN_REPS)))
    stats.update(part("K17, K18", lambda: train_kb_kernel_phase(TRAIN_REPS)))
    variant_rules["search_segment"] = part("K11 in the variants", lambda: variant_segment_phase(
        params, SEGMENT_REPS, nets["kb int8"]))
    stats.update(part("K1-K3, K12 bf16", lambda: bf16_kernel_phase(params, nets["kb f32"], REPS)))
    stats.update(part("K11 bf16", lambda: bf16_segment_phase(params, nets["kb f32"],
                                                             SEGMENT_REPS)))
    log(f"kernel phase: {time.monotonic() - t0:.1f} s")
    off = [(q, p) for q, p in TIME_CHECKS if abs(p - q) > 0.1 * q]
    log(f"time checks: {len(TIME_CHECKS)} readings of the kernel phase also profiled, "
        f"{len(off)} more than 10% off the queued events (profiler / queued "
        f"{sorted(round(p / q, 3) for q, p in off)})")
    phases = [
        ("profile", lambda: [profile_phase(params, lanes, PROFILE_STEPS, tt_on)
                             for lanes, tt_on in ((16, False), (1024, False), (64, True))]),
        ("engine (main path)", lambda: engine_phase(params, DEPTH, POSITIONS, refill=True)),
        ("engine, bf16 weights (main path)", lambda: bf16_engine_phase(params, DEPTH,
                                                                      POSITIONS)),
        ("search, bf16 king-bucketed net", lambda: bf16_kb_search_phase(nets["kb f32"],
                                                                        PARITY_DEPTH)),
        ("mesh, 4 shards on one card (main path)", lambda: mesh_phase(params, DEPTH,
                                                                      POSITIONS)),
        ("engine, Stockfish net (main path)", lambda: engine_phase(
            None, DEPTH, POSITIONS, refill=True, weights_path=sf_file(SF_L1, 7))),
        ("engine chunk-serial", lambda: engine_phase(params, SERIAL_DEPTH, POSITIONS,
                                                     refill=False)),
        ("engine no table", lambda: no_table_phase(params, NO_TT_DEPTH, POSITIONS)),
        ("parity", lambda: parity_phase(params, PARITY_DEPTH)),
        ("TT parity", lambda: tt_parity_phase(nnue.quantize_int8(params), PARITY_DEPTH)),
        ("TT parity, king-bucketed net", lambda: tt_parity_phase(
            nets["kb int8"], PARITY_DEPTH)),
        ("stream parity", lambda: stream_parity_phase(params, STREAM_POSITIONS, STREAM_WIDTH)),
        ("scale", lambda: scale_phase(params, SCALE_LANES, SCALE_DEPTH)),
        ("train (main path)", train_phase),
        ("train, king-bucketed net (main path)", lambda: train_phase("halfkav2_hm")),
        ("train, dp×tp grid (main path)", grid_phase),
        ("engine, variants (variant main paths)", lambda: variant_engine_phase(
            params, DEPTH, POSITIONS)),
        ("variant parity", lambda: variant_parity_phase(params, PARITY_DEPTH)),
    ]
    results = {}
    for name, run in phases:
        t0 = time.monotonic()
        results[name] = run()
        log(f"{name} phase: {time.monotonic() - t0:.1f} s")
    launches, _, main_steps, body_calls = results["engine (main path)"]
    sf_launches, _, sf_steps, sf_calls = results["engine, Stockfish net (main path)"]
    kb_launches, kb_steps, kb_calls = results["TT parity, king-bucketed net"]
    train_launches = results["train (main path)"]
    kb_train_launches = results["train, king-bucketed net (main path)"]
    grid_run = results["train, dp×tp grid (main path)"]
    variant_paths = results["engine, variants (variant main paths)"]
    mesh_run = results["mesh, 4 shards on one card (main path)"]

    sources = {
        "nnue_refresh_768": "fishnet_tpu/models/nnue.py:160",
        "nnue_forward_from_acc": "fishnet_tpu/models/nnue.py:299",
        "nnue_acc_update_768": "fishnet_tpu/models/nnue.py:169",
        "zobrist_hash": "fishnet_tpu/ops/tt.py:113",
        "tt_probe": "fishnet_tpu/ops/tt.py:188",
        "tt_store": "fishnet_tpu/ops/tt.py:240",
        "lane_init": "fishnet_tpu/ops/search.py:1061",
        "node_rules": "fishnet_tpu/ops/board.py:256",
        "generate_moves": "fishnet_tpu/ops/movegen.py:124",
        "make_move": "fishnet_tpu/ops/board.py:345",
        "search_segment": "fishnet_tpu/ops/search.py:875",
        "nnue_evaluate": "fishnet_tpu/models/nnue.py:324",
        "nnue_evaluate_sf": "fishnet_tpu/models/nnue_import.py:298",
        "nnue_stack_backward": "fishnet_tpu/models/train.py:47",
        "nnue_ft_backward_768": "fishnet_tpu/models/train.py:47",
        "adam_update": "fishnet_tpu/models/train.py:47",
        "nnue_refresh_kb": "fishnet_tpu/models/nnue.py:127",
        "nnue_ft_backward_kb": "fishnet_tpu/models/train.py:47",
    }
    rows = []
    for name in kernels.KERNELS:
        # launches and K11 body calls per step on the main path that runs
        # the kernel: the board768 chunk, or for K13 the Stockfish net's
        # (K12's body runs on the king-bucketed TT parity search)
        path, counts, calls, steps = {
            "nnue_evaluate_sf": ("engine, Stockfish L1 3072 net", sf_launches, sf_calls, sf_steps),
            "nnue_evaluate": ("TT parity, king-bucketed int8 net", kb_launches, kb_calls,
                              kb_steps),
            **{k: (f"train_material_net, {TRAIN_STEPS} steps at batch {TRAIN_BATCH}",
                   train_launches, None, TRAIN_STEPS) for k in TRAIN_KERNELS[2:]},
            **{k: (f"train_material_net, king-bucketed net, {TRAIN_STEPS} steps at batch "
                   f"{TRAIN_BATCH}", kb_train_launches, None, TRAIN_STEPS)
               for k in ("nnue_refresh_kb", "nnue_ft_backward_kb")},
        }.get(name, ("engine, board768 net", launches, body_calls, main_steps))
        row = {"name": name, "route": "cuda", "source": f"fishnet_tpu_torch/csrc/{name}.cu",
               "replaces": sources[name], "launches": counts[name], "path": path,
               **{k: stats[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")}}
        # K12, K13: ms is the cold-L2 time; K2 at the clip edges on each
        # net, K4 and K8-K10 at each width
        for k in ("ms_l2_warm", "plain_steps", "edge_ms", "edge_bound_ms", "ms_by_lanes",
                  "mark_ms", "rows_ms", "sums_ms", "start_ms", "start_mark_ms",
                  "start_rows_ms", "start_sums_ms"):
            if k in stats[name]:
                row[k] = stats[name][k]
        if name in kernels.K11_BODIES:  # its body's calls inside K11, per step of its path
            row["in_k11_calls_per_step"] = calls[name] / max(steps, 1)
        if name in TRAIN_KERNELS[:2]:  # K1 and K2 run on the training path too
            row["train_launches"] = train_launches[name]
        if name in TRAIN_KERNELS + TRAIN_KB_KERNELS:
            if name in TRAIN_KERNELS[1:] and name in TRAIN_KB_KERNELS:  # K2, K14, K16
                row["train_kb_launches"] = kb_train_launches[name]
            # launches on the dp×tp grid's main path, each feature set's run
            row["grid_launches"] = {fs: g["launches"][name] for fs, g in grid_run.items()}
        if name == "adam_update":  # K16 over the king-bucketed net's flat buffer
            row["kb_flat"] = stats["adam_update_kb_flat"]
        if name == "nnue_refresh_768":  # K1's body is atomic's board768 leaf inside K11
            vp = variant_paths["atomic"]
            row["variants"] = {"atomic": {
                "launches": vp["launches"][name],
                "in_k11_calls_per_step": vp["body_calls"][name] / max(vp["steps"], 1)}}
        if name in variant_rules:  # K4, K8-K11 in each variant: check, time, its main path
            row["variants"] = {}
            for v, vstats in variant_rules[name].items():
                vp = variant_paths[v]
                row["variants"][v] = {**vstats, "launches": vp["launches"][name]}
                if name in kernels.K11_BODIES:
                    row["variants"][v]["in_k11_calls_per_step"] = (
                        vp["body_calls"][name] / max(vp["steps"], 1))
        rows.append(row)
    # the bf16 entry points: launches and body calls on the bf16 main path
    # (K12's on the bf16 king-bucketed search)
    bf16_launches, _, bf16_steps, bf16_calls, bf16_entries = results[
        "engine, bf16 weights (main path)"]
    kb16_launches, kb16_steps, kb16_calls = results["search, bf16 king-bucketed net"]
    for entry in BF16_ENTRIES:
        base = entry[:-len("_bf16")]
        if base == "nnue_evaluate":
            path, n, calls, steps = ("search_batch, bf16 king-bucketed net", kb16_launches[base],
                                     kb16_calls, kb16_steps)
        else:
            path, n, calls, steps = ("engine, board768 net, bf16 weights",
                                     bf16_entries.get(entry, 0), bf16_calls, bf16_steps)
        row = {"name": entry, "route": "cuda", "source": f"fishnet_tpu_torch/csrc/{base}.cu",
               "replaces": sources[base], "weights": "bf16 (fishnet_tpu/models/nnue.py:202)",
               "launches": n, "path": path,
               **{k: stats[entry][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "f32_kernel_ms")}}
        for k in ("ms_l2_warm", "us_per_step", "f32_kernel_us_per_step", "plain_steps"):
            if k in stats[entry]:
                row[k] = stats[entry][k]
        if base in kernels.K11_BODIES:
            row["in_k11_calls_per_step"] = calls[base] / max(steps, 1)
        rows.append(row)
    # K11 and K7 a shard on the mesh main path (parallel/mesh.py's two
    # shard_map'd programs)
    for name, replaces in (("search_segment", "fishnet_tpu/parallel/mesh.py:79"),
                           ("lane_init", "fishnet_tpu/parallel/mesh.py:174")):
        st = mesh_run[name]
        row = {"name": f"{name} per shard, {MESH_SHARDS}-shard mesh", "route": "cuda",
               "source": f"fishnet_tpu_torch/csrc/{name}.cu", "replaces": replaces,
               "launches": mesh_run["launches"][name],
               "path": f"engine, board768 net, {MESH_SHARDS}-shard mesh on one card",
               **{k: st[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}
        for k in ("us_per_step", "one_shard_us_per_step", "shards_overlapped",
                  "kernel_ms_summed", "span_ms", "plain_steps"):
            if k in st:
                row[k] = st[k]
        rows.append(row)
    log(f"chip_smoke: {time.monotonic() - started:.1f} s of its {TIME_BUDGET_S} s budget")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--main-path-run"]:
        sys.exit(main_path_run(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--main-path-ab"]:
        sys.exit(main_path_ab(sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else 3))
    if sys.argv[1:2] == ["--k11-split-run"]:
        sys.exit(k11_split_run(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--k11-split"]:
        sys.exit(k11_split(sys.argv[2:]))
    if sys.argv[1:2] == ["--sf-split-run"]:
        sys.exit(sf_split_run(sys.argv[2]))
    if sys.argv[1:2] == ["--sf-split"]:
        sys.exit(sf_split(sys.argv[2:]))
    if sys.argv[1:2] == ["--sf-variant-run"]:
        sys.exit(sf_variant_run(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    if sys.argv[1:2] == ["--sf-variants"]:
        sys.exit(sf_variants(int(sys.argv[2]) if len(sys.argv) > 2 else 2))
    if sys.argv[1:2] == ["--ft-split"]:
        sys.exit(ft_split())
    if sys.argv[1:2] == ["--ptxas-run"]:
        sys.exit(ptxas_run(sys.argv[2]))
    if sys.argv[1:2] == ["--ptxas"]:
        sys.exit(ptxas(sys.argv[2:]))
    sys.exit(main())
