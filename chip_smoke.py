#!/usr/bin/env python3
"""Quickest proof that fishnet_tpu_torch runs on one NVIDIA H100.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card, the toolchain versions;
  2. the kernel build (nvcc, sm_90a) from fishnet_tpu_torch/csrc/;
  3. every kernel against its plain PyTorch version on the card, at the
     main path's shapes (B = 16 and 1024 lanes, L1 = 64) on the shipped
     f32 net and on its int8 quantization, with times (CUDA events);
  4. where a search step's time goes (torch.profiler, B = 16 and 1024);
  5. the main path: one standard-chess analysis chunk through GpuEngine
     at full width (MAX_PLY 32, depth 3);
  6. search_batch on the int8 net, card against CPU, field for field;
  7. search_batch at B = 1024 lanes on the f32 net.
Phases 4-7 each reset the kernels' launch counters just before they
search and fail unless every kernel launched during the search.
Then a `kernels` JSON line, the card's name and power limit, and the
result line `{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import asyncio
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

DEPTH = 3  # engine analysis depth (the host-bound step sets the time; PERF.md)
POSITIONS = 10  # positions in the engine's chunk
PARITY_DEPTH = 3
SCALE_LANES = 1024  # bench.py's default lane count
SCALE_DEPTH = 3
REPS = 200  # launches per kernel timing
PROFILE_STEPS = 20  # search steps under the profiler

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


def check_launches(path: str) -> dict:
    """The kernels' launch counts since the last reset; every kernel of
    the path must have launched at least once."""
    from fishnet_tpu_torch import kernels

    launches = dict(kernels.LAUNCHES)
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"{path}: kernels {missing} were not launched ({launches})")
    log(f"launches {path}: {launches}")
    return launches


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def time_ms(fn, reps: int):
    """(device ms, call ms) of one fn() on the card: the device time of
    the kernels it launches (torch.profiler, summed over reps calls) and
    the wall time per call with the host's launch overhead (CUDA events
    around reps back-to-back calls). Where the profiler records no device
    time, the device figure is the CUDA-event one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(_device_us(e) for e in prof.key_averages() if e.device_type.name == "CUDA")
    return (dev_us / reps / 1e3 if dev_us > 0 else call_ms), call_ms


def playout_boards(n: int, seed: int):
    """n positions from seeded random playouts → (Board, legal moves)."""
    from fishnet_tpu_torch.chess import Position
    from fishnet_tpu_torch.ops.board import from_position, stack_boards

    rng = random.Random(seed)
    boards, moves = [], []
    pos = Position.initial()
    while len(boards) < n:
        legal = pos.legal_moves()
        if not legal or pos.halfmove >= 90:
            pos = Position.initial()
            continue
        boards.append(from_position(pos))
        moves.append(rng.choice(legal))
        pos = pos.push(moves[-1])
    return stack_boards(boards), moves


def encode(m) -> int:
    promo = {None: 0, 1: 1, 2: 2, 3: 3, 4: 4}[m.promotion]
    return m.from_sq | (m.to_sq << 6) | (promo << 12)


def kernel_phase(params_f32, reps: int) -> dict:
    """Each kernel against its plain version at B = 16 and 1024 on both
    nets; returns per-kernel stats for the kernels line (times at
    B = 1024 on the f32 net)."""
    import torch
    import torch.nn.functional as F

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.models import nnue
    from fishnet_tpu_torch.ops import tt
    from fishnet_tpu_torch.ops.board import move_piece_changes

    dev = torch.device("cuda")
    stats = {k: {"max_abs_err": 0.0} for k in kernels.KERNELS}
    params_i8 = nnue.quantize_int8(params_f32)
    for B in (16, 1024):
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


def engine_phase(params_f32, depth: int, n_positions: int) -> dict:
    import torch

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.chess import Position
    from fishnet_tpu_torch.engine.gpu import GpuEngine

    steps = []

    class CountingEngine(GpuEngine):
        def _search(self, roots, depth_arr, *a, **kw):
            t0 = time.monotonic()
            out = super()._search(roots, depth_arr, *a, **kw)
            steps.append(out["steps"])
            log(f"engine dispatch {len(steps)}: depth {int(depth_arr.max())} lanes "
                f"{len(depth_arr)} steps {out['steps']} wall {time.monotonic() - t0:.3f} s")
            return out

    engine = CountingEngine(params=params_f32, tt_size_log2=0, helper_lanes=1,
                            refill=False, max_depth=depth)
    assert engine.max_ply == 32, engine.max_ply
    chunk = make_chunk(n_positions, depth)
    kernels.reset_launches()
    t0 = time.monotonic()
    responses = asyncio.run(engine.go_multiple(chunk))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = check_launches("engine chunk")
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
        log(f"engine position {wp.position_index} ({len(wp.moves)} plies): "
            f"best {res.best_move} score {score.kind} {score.value} nodes {res.nodes}")
    nodes = sum(r.nodes for r in responses)
    log(f"engine: {len(responses)} positions depth {depth} nodes {nodes} steps {sum(steps)} "
        f"dispatches {len(steps)} wall {wall:.3f} s nodes/s {nodes / wall:.0f}")
    return launches


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


def profile_phase(params_f32, lanes: int, steps: int) -> None:
    """Where a search step's time goes: steps of the lockstep search at
    `lanes` lanes under torch.profiler — host wall per step, device time
    per step, the device's idle share, launches per step and the largest
    device-time entries (the four hand kernels among them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from fishnet_tpu_torch import kernels
    from fishnet_tpu_torch.ops.search import _step, init_state

    dev = torch.device("cuda")
    roots = playout_boards(lanes, seed=13)[0].to(dev)
    kernels.reset_launches()
    state = init_state(params_f32, roots, torch.full((lanes,), 6, dtype=torch.int32, device=dev),
                       torch.full((lanes,), 10_000_000, dtype=torch.int32, device=dev), 32)
    for _ in range(20):  # warm up past the root
        _step(params_f32, state, True)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        _step(params_f32, state, True)
    torch.cuda.synchronize()
    plain_wall = time.monotonic() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            _step(params_f32, state, True)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    check_launches(f"profile B={lanes}")

    # the kernels themselves (device-side entries), not the ops that launched them
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(_device_us(e) for e in events)
    launches = sum(e.count for e in events)
    log(f"profile B={lanes}: wall {plain_wall / steps * 1e3:.3f} ms/step (profiled "
        f"{wall / steps * 1e3:.3f}), device busy {dev_us / steps / 1e3:.3f} ms/step, device "
        f"idle share {1 - dev_us / 1e6 / plain_wall:.3f}, device entries {launches / steps:.1f}/step")
    for e in sorted(events, key=lambda e: -_device_us(e))[:12]:
        log(f"profile B={lanes}: {_device_us(e) / steps:9.2f} us/step "
            f"x{e.count / steps:<6.1f} {e.key[:90]}")


def main() -> int:
    import torch

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
    stats = kernel_phase(params, REPS)
    log(f"kernel phase: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    for lanes in (16, 1024):
        profile_phase(params, lanes, PROFILE_STEPS)
    log(f"profile phase: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    launches = engine_phase(params, DEPTH, POSITIONS)
    log(f"engine phase: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    parity_phase(params, PARITY_DEPTH)
    log(f"parity phase: {time.monotonic() - t0:.1f} s")
    t0 = time.monotonic()
    scale_phase(params, SCALE_LANES, SCALE_DEPTH)
    log(f"scale phase: {time.monotonic() - t0:.1f} s")

    sources = {
        "nnue_refresh_768": "fishnet_tpu/models/nnue.py:160",
        "nnue_forward_from_acc": "fishnet_tpu/models/nnue.py:299",
        "nnue_acc_update_768": "fishnet_tpu/models/nnue.py:169",
        "zobrist_hash": "fishnet_tpu/ops/tt.py:113",
    }
    rows = [
        {"name": name, "route": "cuda", "source": f"fishnet_tpu_torch/csrc/{name}.cu",
         "replaces": sources[name], "launches": launches[name],
         **{k: stats[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}}
        for name in kernels.KERNELS
    ]
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
