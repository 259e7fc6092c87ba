"""The batch engine on the card: chunks in, PositionResponses out.

A port of the JAX package's engine/tpu.py `TpuEngine` on one device. All
lanes share one transposition table (2^21 slots by default) that
persists across dispatches and chunks; spare lanes run Lazy-SMP helpers
(FISHNET_TPU_HELPERS lanes per position, default 4) that search the same
roots with jittered move ordering, staggered windows and depth offsets
and feed the primaries only through the table. Iterative deepening and
aspiration windows run on the host, filling the per-depth score and PV
matrices the reference's UCI parser would have accumulated (reference:
src/stockfish.rs:222-465).

With continuous lane refill on (FISHNET_TPU_REFILL, default 1) every
single-pv analysis chunk goes through the LaneScheduler: one full-width
search per drive session, into whose DONE lanes each position's next
depth or re-search, queued positions and helpers are spliced at segment
boundaries (ops/search.py refill_lanes). With refill off, chunks run
chunk-serially (`_analyse_single`).

Variants: chunks of standard chess, chess960, threeCheck (and its alias
3check), kingOfTheHill, racingKings, horde, atomic, antichess and
crazyhouse run on the card (`DEVICE_VARIANTS`), each under its device variant's
kernels; the scheduler runs one device variant per drive session, its
state's move lists as wide as that variant's (crazyhouse's 544). A
crazyhouse drop prints as "P@e4", as the reference's UCI does.

The mesh: on a host with several cards, and no `device` given, the
engine shards its lanes over all of them (parallel/mesh.py make_mesh());
`mesh=` names the devices instead (a device may repeat: make_mesh(
["cuda:0"] * 4) runs four shards on one card). Dispatch widths round up
to a multiple of the shards, each shard has its own full-size table and
advances on its own (one K11 a shard and segment), the scheduler admits
each position to the shard with the most free lanes and logs per-shard
occupancy columns, and FISHNET_TPU_MESH_REFILL=0 sends a meshed engine's
chunks down the chunk-serial path.

Not ported yet, and refused rather than run another way: move jobs,
multipv.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .. import device as device_mod
from .. import settings
from ..chess.position import Position
from ..chess.variants import from_fen
from ..ipc import AnalysisWork, Chunk, Matrix, PositionResponse, Score, WorkPosition
from ..models import nnue, nnue_import
from ..ops import tt as tt_mod
from ..ops.board import from_position, stack_boards
from ..ops.movegen import DROP_FLAG
from ..ops import search as search_ops
from ..ops.search import HIST_HM_SENTINEL, INF, MATE, MAX_HIST, search_batch_resumable
from ..parallel import mesh as mesh_mod
from ..syncstats import SegmentController, SyncStats
from .base import BatchEngine, EngineError

# lane counts are padded to these widths (then to multiples of 256) so a
# handful of batch shapes serve every chunk
LANE_BUCKETS = (16, 64, 128, 256)
# aspiration window half-widths tried in order before the full window
# (the JAX package's measured default; FISHNET_TPU_ASPIRATION overrides)
ASPIRATION_DELTAS = (15, 120)

# chunk.variant → device variant (ops/search.py's static flag), the JAX
# package's map key for key; a chunk of any other variant is refused
# (NotImplementedError).
DEVICE_VARIANTS = {
    "standard": "standard",
    "chess960": "standard",
    "fromPosition": "standard",
    "threeCheck": "threeCheck",
    "3check": "threeCheck",
    "crazyhouse": "crazyhouse",
    "antichess": "antichess",
    "atomic": "atomic",
    "horde": "horde",
    "kingOfTheHill": "kingOfTheHill",
    "racingKings": "racingKings",
}


def device_variant(chunk_variant: str) -> str:
    """The device variant of a chunk's variant; NotImplementedError for a
    variant that has none."""
    try:
        return DEVICE_VARIANTS[chunk_variant]
    except KeyError:
        raise NotImplementedError(f"variant {chunk_variant!r} has no device search") from None


def _decode_uci(m: int) -> str:
    frm, to, promo = m & 63, (m >> 6) & 63, (m >> 12) & 7
    if m & DROP_FLAG:  # a crazyhouse drop: P@e4
        return "PNBRQ"[promo] + "@" + "abcdefgh"[to & 7] + str((to >> 3) + 1)
    s = (
        "abcdefgh"[frm & 7] + str((frm >> 3) + 1)
        + "abcdefgh"[to & 7] + str((to >> 3) + 1)
    )
    if promo:
        s += " nbrqk"[promo]
    return s


def _score_from_int(v: int) -> Score:
    if v >= MATE - 1000:
        return Score.mate((MATE - v + 1) // 2)
    if v <= -(MATE - 1000):
        return Score.mate(-((MATE + v + 1) // 2))
    return Score.cp(int(v))


def _pad_lanes(n: int) -> int:
    for b in LANE_BUCKETS:
        if n <= b:
            return b
    return ((n + 255) // 256) * 256


# GpuEngine's mesh argument when none is given (make_mesh() on a host
# with several cards)
_DEFAULT_MESH = object()


class GpuEngine(BatchEngine):
    """Batched analysis engine. params: an nnue.NnueParams (board768 or
    king-bucketed) or an imported nnue_import.StockfishNet; without it,
    weights_path (a `.nnue` file through nnue_import.load_nnue, any other
    path through nnue.load_params), else the shipped board768 net.
    FISHNET_TPU_DTYPE=int8 with FISHNET_TPU_EXPERIMENTAL_INT8 quantizes a
    board768 net (quantize_int8); "bf16" stores a board768 or
    king-bucketed net in bf16 (cast_params; a Stockfish net raises
    TypeError, as in TpuEngine). device:
    where it runs (default the card — it raises without one). tt_size_log2: the shared table's slots as a
    power of two (0: no table, and then no helpers); helper_lanes: lanes
    per position (None reads FISHNET_TPU_HELPERS, clamped to 1..16);
    max_lanes: the per-dispatch lane ceiling (None reads
    FISHNET_TPU_MAX_LANES); refill: continuous lane refill through the
    LaneScheduler (None reads FISHNET_TPU_REFILL). mesh: the devices
    the lanes shard over (parallel/mesh.py), None for one device; by
    default make_mesh() when no device is given and the host has several
    cards, else None. device is then where the host-side work runs
    (default the mesh's first device). mesh_refill: refill on a meshed
    engine too (None reads FISHNET_TPU_MESH_REFILL)."""

    name = "gpu"

    def __init__(
        self,
        params=None,
        weights_path: Optional[str] = None,
        max_depth: int = 12,
        tt_size_log2: int = 21,
        max_lanes: Optional[int] = None,
        helper_lanes: Optional[int] = None,
        refill: Optional[bool] = None,
        device=None,
        mesh=_DEFAULT_MESH,
        mesh_refill: Optional[bool] = None,
    ) -> None:
        if mesh is _DEFAULT_MESH:
            several = device is None and torch.cuda.is_available() and (
                torch.cuda.device_count() > 1)
            mesh = mesh_mod.make_mesh() if several else None
        # lanes shard over the mesh's devices, each shard with its own table
        self.mesh = None if mesh is None else mesh_mod.make_mesh(mesh)
        self.n_dev = 1 if self.mesh is None else len(self.mesh)
        self.device = device_mod.resolve(
            device if device is not None or self.mesh is None else self.mesh[0])
        # one table for every lane and every chunk (0 disables it; one a
        # shard under a mesh); chunks run one at a time under self._lock,
        # so no two searches share it
        if not tt_size_log2:
            self.tt = None
        elif self.mesh is not None:
            self.tt = mesh_mod.make_sharded_table(self.mesh, tt_size_log2)
        else:
            self.tt = tt_mod.make_table(tt_size_log2, self.device)
        # per-dispatch lane ceiling
        self.max_lanes = (max_lanes if max_lanes is not None
                          else settings.get_int("FISHNET_TPU_MAX_LANES"))
        # Lazy-SMP lanes per position (K): one primary whose result is
        # reported plus up to K-1 helpers; K=1 is the search without
        # helpers, and no table forces it (helpers talk only through it)
        if helper_lanes is None:
            helper_lanes = settings.get_int("FISHNET_TPU_HELPERS")
        self.helper_lanes = max(1, min(int(helper_lanes), 16))
        if self.tt is None:
            self.helper_lanes = 1
        # table generation, bumped per chunk: helper stores carry it so
        # depth-preferred replacement never protects an earlier chunk's rows
        self._tt_gen = 0
        if params is None:
            if weights_path and str(weights_path).endswith(".nnue"):
                params = nnue_import.load_nnue(weights_path, device=self.device)
            elif weights_path:
                params = nnue.load_params(weights_path, self.device)
            else:
                params = nnue.load_params(device=self.device)
        self.params = self._quantized(params).to(self.device)
        # the net on each shard's device, once a distinct device
        self.shard_params = None if self.mesh is None else mesh_mod.replicate(self.mesh,
                                                                             self.params)
        self.max_depth = max_depth
        self.max_ply = settings.get_int("FISHNET_TPU_MAX_PLY")
        self.aspiration = (
            settings.get_csv_int("FISHNET_TPU_ASPIRATION") or ASPIRATION_DELTAS
        )
        self._lock = threading.Lock()
        # single-pv analysis chunks through the LaneScheduler; every other
        # shape (and refill off) takes the chunk-serial path
        if refill is None:
            refill = settings.get_bool("FISHNET_TPU_REFILL")
        self.refill = bool(refill)
        # a meshed engine's chunks through the scheduler too (0: the
        # chunk-serial sharded path; no effect without a mesh)
        if mesh_refill is None:
            mesh_refill = settings.get_bool("FISHNET_TPU_MESH_REFILL")
        self.mesh_refill = bool(mesh_refill)
        self._scheduler = LaneScheduler(self)
        # per-segment occupancy of the scheduler's sessions (the
        # reference's keys)
        self.occupancy_log: List[dict] = []
        self.occupancy_totals = {
            "segments": 0, "steps": 0, "lane_steps": 0,
            "live_lane_steps": 0, "helper_lane_steps": 0,
            "idle_lane_steps": 0, "refills": 0, "positions_done": 0,
            "host_ms": 0.0, "device_ms": 0.0, "transfers": 0,
        }
        # per-delta aspiration accounting {delta: [windowed, fail_lo,
        # fail_hi, nodes]}
        self.aspiration_stats: dict = {}
        # exactly-once delivery hooks, called as (wp, response) and
        # (chunk, wp, response) when the scheduler finalizes a position
        self.on_response = None
        self.on_deliver = None

    def _warn(self, msg: str) -> None:
        print(f"W: {msg}", file=sys.stderr, flush=True)

    def _quantized(self, params):
        """The net under FISHNET_TPU_DTYPE, as TpuEngine reads it: "bf16"
        (or "bfloat16") stores every weight in bf16 (cast_params: the
        accumulators and the arithmetic stay f32; a Stockfish net raises
        TypeError); "int8" quantizes an f32 board768 net when
        FISHNET_TPU_EXPERIMENTAL_INT8 is set (and is ignored with a
        warning when it is not)."""
        dtype = (settings.raw("FISHNET_TPU_DTYPE") or "").lower()
        if dtype in ("bf16", "bfloat16"):
            return nnue.cast_params(params)
        if dtype != "int8":
            return params
        if not settings.get_bool("FISHNET_TPU_EXPERIMENTAL_INT8"):
            self._warn("FISHNET_TPU_DTYPE=int8 ignored, as the JAX engine ignores it (it "
                       "measured a net loss vs f32 there); set "
                       "FISHNET_TPU_EXPERIMENTAL_INT8=1 to run it anyway")
            return params
        self._warn("experimental int8 weights enabled")
        if nnue.is_board768(params) and not nnue.is_int8(params):
            params = nnue.quantize_int8(params)
        return params

    # ------------------------------------------------------------- chunks

    def _go_multiple_sync(self, chunk: Chunk) -> List[PositionResponse]:
        work = chunk.work
        if (self.refill and (self.mesh is None or self.mesh_refill)
                and isinstance(work, AnalysisWork) and work.effective_multipv() == 1):
            return self._scheduler.run_chunk(chunk)
        with self._lock:
            return self._go_multiple_locked(chunk)

    def _go_multiple_locked(self, chunk: Chunk) -> List[PositionResponse]:
        started = time.monotonic()
        self._tt_gen = (self._tt_gen + 1) & 0x3FFFFFFF
        work = chunk.work
        if not isinstance(work, AnalysisWork):
            raise NotImplementedError("move jobs are not ported yet")
        if work.effective_multipv() != 1:
            raise NotImplementedError("multipv analysis is not ported yet")
        variant = device_variant(chunk.variant)
        positions, games = [], []
        for wp in chunk.positions:
            pos = from_fen(wp.root_fen, chunk.variant)
            prefix = []
            for uci in wp.moves:
                prefix.append(pos)
                pos = pos.push(pos.parse_uci(uci))
            positions.append(pos)
            games.append(prefix)
        target_depth = min(work.depth or self.max_depth, self.max_depth, self.max_ply - 1)
        budget = work.nodes.get(chunk.flavor.eval_flavor())
        return self._analyse_single(chunk, positions, games, target_depth, budget, started,
                                    variant)

    def _search(self, roots, depth_arr, budget_arr, deadline=None, hist=None,
                window=None, order_jitter=None, group=None, required=None,
                helper_store=False, variant="standard") -> dict:
        """One search over the engine's table, under a device variant.
        helper_store: the depth-preferred, generation-aware store of
        helper dispatches."""
        out = search_batch_resumable(
            self.params if self.mesh is None else self.shard_params, roots, depth_arr,
            budget_arr, max_ply=self.max_ply,
            deadline=deadline, tt=self.tt, hist=hist, window=window,
            order_jitter=order_jitter, group=group, required=required,
            prefer_deep_store=helper_store, tt_gen=self._tt_gen if helper_store else 0,
            device=self.device, variant=variant, mesh=self.mesh,
        )
        self.tt = out.pop("tt")
        return out

    def _search_windowed(self, roots, depth_arr, budget_arr, deadline, hist,
                         prev_score, use_win, required=None, win_scale=None,
                         order_jitter=None, group=None, helper_store=False,
                         variant="standard") -> dict:
        """Aspiration-windowed dispatch: a narrow window around the
        previous depth's score; lanes that fail low or high re-search
        wider (the others ride along at depth 0 / budget 1). Returns the
        merged results with per-lane nodes summed over attempts.

        With helpers, `required` marks the primaries: only their fails
        trigger a re-search, and each dispatch stops once they finish.
        win_scale widens each lane's delta (helpers search wider windows).
        Helpers ride along on the first attempt only."""
        B = int(depth_arr.shape[0])
        primary = np.ones(B, bool) if required is None else np.asarray(required, bool)
        scale = np.ones(B, np.int64) if win_scale is None else np.asarray(win_scale, np.int64)
        merged = None
        nodes_acc = np.zeros(B, np.int64)
        live = np.ones(B, bool)
        prev_score = np.asarray(prev_score, np.int64)
        for delta in tuple(self.aspiration) + (None,):  # None = full window
            if delta is None or not use_win.any():
                alpha_w = np.full(B, -INF, np.int32)
                beta_w = np.full(B, INF, np.int32)
            else:
                alpha_w = np.where(use_win, np.maximum(prev_score - delta * scale, -INF),
                                   -INF).astype(np.int32)
                beta_w = np.where(use_win, np.minimum(prev_score + delta * scale, INF),
                                  INF).astype(np.int32)
            out = self._search(
                roots, np.where(live, depth_arr, 0).astype(np.int32),
                np.where(live, budget_arr, 1).astype(np.int32), deadline,
                hist=hist, window=(alpha_w, beta_w), order_jitter=order_jitter,
                group=group, required=required, helper_store=helper_store, variant=variant,
            )
            if merged is None:
                merged = {k: np.array(v) for k, v in out.items()}
            else:
                for k in ("score", "move", "pv", "pv_len", "done"):
                    merged[k][live] = out[k][live]
            nodes_acc[live] += out["nodes"][live]
            score = out["score"]
            fail_lo = live & primary & out["done"] & (score <= alpha_w) & (alpha_w > -INF)
            fail_hi = live & primary & out["done"] & (score >= beta_w) & (beta_w < INF)
            if delta is not None and use_win.any():
                st = self.aspiration_stats.setdefault(delta, [0, 0, 0, 0])
                st[0] += int((use_win & live & primary).sum())
                st[1] += int(fail_lo.sum())
                st[2] += int(fail_hi.sum())
                st[3] += int(out["nodes"][live].sum())
            live = fail_lo | fail_hi
            if not live.any():
                break
            if deadline is not None and time.monotonic() >= deadline:
                # a failed lane holds only a bound: not a score
                merged["done"][live] = False
                break
        merged["nodes"] = nodes_acc
        return merged

    @staticmethod
    def _plan_helpers(n_primary: int, B: int, k_max: int, hardness):
        """The dispatch's spare lanes as helpers, hardest positions first:
        → list of (primary_row, helper_index 1..k_max-1), at most k_max-1
        per primary and B - n_primary in all, round-robin in descending
        hardness (every hard position gets its first helper before any
        gets its second). hardness[j] <= 0 gives primary j none."""
        spare = B - n_primary
        out: list = []
        if k_max <= 1 or spare <= 0 or n_primary <= 0:
            return out
        hardness = [int(h) for h in hardness]
        order = sorted(range(n_primary), key=lambda r: (-hardness[r], r))
        grants = [0] * n_primary
        while len(out) < spare:
            progressed = False
            for r in order:
                if len(out) >= spare:
                    break
                if hardness[r] > 0 and grants[r] < k_max - 1:
                    grants[r] += 1
                    out.append((r, grants[r]))
                    progressed = True
            if not progressed:
                break
        return out

    def _pad(self, n: int) -> int:
        """The lane bucket of n lanes, rounded up to a multiple of the
        mesh's shards."""
        b = _pad_lanes(n)
        return -(-b // self.n_dev) * self.n_dev

    def _helper_width(self, n: int) -> int:
        """Dispatch width for n primaries: the lane bucket grown toward
        n*K so the planner has spare rows, never above max_lanes. K=1
        keeps the width without helpers."""
        B = self._pad(n)
        if self.helper_lanes > 1:
            grown = self._pad(min(n * self.helper_lanes, self.max_lanes))
            if grown <= max(self.max_lanes, B):
                B = max(B, grown)
        return B

    def _history_arrays(self, hist_lists, B, variant="standard"):
        """Per-lane reversible game tails → the search's history seeds,
        hashed under the device variant's keys.

        hist_lists: per lane, the game's positions before the root,
        oldest first. Only positions occurring at least twice in a lane's
        last MAX_HIST are planted (a single earlier occurrence is not a
        draw on re-visit); chain validity is re-checked in the search
        through halfmove distances."""
        hh = np.zeros((B, MAX_HIST, 2), np.int32)
        hm = np.full((B, MAX_HIST), HIST_HM_SENTINEL, np.int32)
        flat, slots = [], []
        for lane, hist in enumerate(hist_lists):
            tail = hist[-MAX_HIST:]
            for j, p in enumerate(tail):
                slots.append((lane, MAX_HIST - len(tail) + j))
                flat.append(from_position(p))
        if flat:
            stacked = stack_boards(flat).to(self.device)
            keys = tt_mod.hash_boards(stacked, variant).cpu().numpy()
            hms = stacked.halfmove.cpu().numpy()
            for n, (lane, k) in enumerate(slots):
                hh[lane, k] = keys[n]
                hm[lane, k] = hms[n]
            for lane in range(B):
                filled = hm[lane] != HIST_HM_SENTINEL
                pairs = [tuple(hh[lane, k]) for k in range(MAX_HIST)]
                for k in range(MAX_HIST):
                    if filled[k] and pairs.count(pairs[k]) < 2:
                        hm[lane, k] = HIST_HM_SENTINEL
                        hh[lane, k] = 0
        return hh, hm

    def _terminal_response(self, chunk, wp: WorkPosition, pos: Position,
                           elapsed: float) -> PositionResponse:
        winner, _ = pos.outcome()
        scores, pvs = Matrix(), Matrix()
        scores.set(1, 0, Score.mate(0) if winner is not None else Score.cp(0))
        pvs.set(1, 0, [])
        return PositionResponse(
            work=chunk.work, position_index=wp.position_index, url=wp.url,
            scores=scores, pvs=pvs, best_move=None, depth=0, nodes=0,
            time_s=elapsed,
        )

    def _analyse_single(self, chunk, positions, games, target_depth, budget,
                        started, variant="standard") -> List[PositionResponse]:
        terminal = {i for i, p in enumerate(positions) if p.outcome() is not None}
        lanes = [i for i in range(len(positions)) if i not in terminal]
        scores = [Matrix() for _ in positions]
        pvs = [Matrix() for _ in positions]
        depth_reached = [0] * len(positions)
        best_moves: List[Optional[str]] = [None] * len(positions)
        nodes_total = [0] * len(positions)

        if lanes:
            n = len(lanes)
            K = self.helper_lanes
            B = self._helper_width(n)
            boards = [from_position(positions[i]) for i in lanes]
            hist_hh, hist_hm = self._history_arrays([games[i] for i in lanes], B, variant)
            per_pos_budget = budget if budget is not None else 10_000_000
            remaining = np.full(n, per_pos_budget, dtype=np.int64)
            prev_score = np.zeros(n, np.int64)
            have_prev = np.zeros(n, bool)
            # the previous depth's primary nodes: the helper planner's order
            hardness = np.ones(n, np.int64)
            deadline = chunk.deadline - 0.25  # slack to package results
            for depth in range(1, target_depth + 1):
                # primaries in rows 0..n-1, helpers next, padding after.
                # Helper h of primary j searches j's root with jittered
                # ordering: odd h at the same depth (their exact-depth
                # entries serve this iteration), even h one ply deeper
                # (ordering now, cutoffs next iteration)
                helpers = (self._plan_helpers(n, B, K, np.where(remaining > 0, hardness, 0))
                           if K > 1 else [])
                roots = stack_boards(boards + [boards[j] for j, _ in helpers]
                                     + [boards[0]] * (B - n - len(helpers)))
                depth_arr = np.zeros(B, np.int32)
                depth_arr[:n] = depth
                budget_arr = np.ones(B, np.int32)
                budget_arr[:n] = np.clip(remaining, 0, 2**31 - 1)
                use_win = np.zeros(B, bool)
                use_win[:n] = have_prev & (np.abs(prev_score) < MATE - 1000) & (depth >= 2)
                prev_full = np.zeros(B, np.int64)
                prev_full[:n] = prev_score
                if K > 1:
                    hh, hm = hist_hh.copy(), hist_hm.copy()
                    jitter = np.zeros(B, np.int32)
                    grp = np.arange(B, dtype=np.int32)
                    scale = np.ones(B, np.int64)
                    req = np.zeros(B, bool)
                    req[:n] = True
                    for idx, (j, h) in enumerate(helpers):
                        r = n + idx
                        hh[r], hm[r] = hist_hh[j], hist_hm[j]
                        depth_arr[r] = min(depth + (1 - (h & 1)), target_depth)
                        budget_arr[r] = budget_arr[j]
                        jitter[r] = j * K + h  # != 0, unique per (j, h)
                        grp[r] = j
                        scale[r] = 1 << min(h, 4)  # staggered windows
                        use_win[r] = use_win[j]
                        prev_full[r] = prev_score[j]
                    extra = dict(required=req, win_scale=scale, order_jitter=jitter,
                                 group=grp, helper_store=True)
                    hist = (hh, hm)
                else:  # the search without helpers, argument for argument
                    extra = {}
                    hist = (hist_hh, hist_hm)
                out = self._search_windowed(
                    roots, depth_arr, budget_arr, deadline, hist, prev_full, use_win,
                    variant=variant, **extra,
                )
                exhausted_all = True
                for j, i in enumerate(lanes):
                    if remaining[j] <= 0 or not bool(out["done"][j]):
                        continue  # lane skipped, or stopped mid-depth on deadline
                    # helper nodes are charged to their primary: the
                    # position spent that work against its budget
                    lane_nodes = int(out["nodes"][j])
                    help_nodes = sum(int(out["nodes"][n + idx])
                                     for idx, (jj, _) in enumerate(helpers) if jj == j)
                    hardness[j] = max(lane_nodes, 1)
                    nodes_total[i] += lane_nodes + help_nodes
                    remaining[j] -= lane_nodes + help_nodes
                    sc = int(out["score"][j])
                    prev_score[j] = sc
                    have_prev[j] = True
                    scores[i].set(1, depth, _score_from_int(sc))
                    pvs[i].set(1, depth, [
                        _decode_uci(int(m))
                        for m in out["pv"][j][: int(out["pv_len"][j])] if m >= 0
                    ])
                    depth_reached[i] = depth
                    mv = int(out["move"][j])
                    best_moves[i] = _decode_uci(mv) if mv >= 0 else None
                    if remaining[j] > 0:
                        exhausted_all = False
                if exhausted_all or time.monotonic() >= deadline:
                    break

        # a position without even depth 1 fails the chunk, so the server
        # reassigns it (reference: src/queue.rs:226-233)
        if any(depth_reached[i] == 0 for i in lanes):
            raise EngineError("chunk deadline expired before depth 1 completed")

        elapsed = max(time.monotonic() - started, 1e-6)
        times = self._apportion_time(elapsed, nodes_total)
        responses = []
        for i, wp in enumerate(chunk.positions):
            if i in terminal:
                responses.append(self._terminal_response(chunk, wp, positions[i], times[i]))
                continue
            nps = int(nodes_total[i] / times[i]) if times[i] > 0 else None
            responses.append(PositionResponse(
                work=chunk.work, position_index=wp.position_index, url=wp.url,
                scores=scores[i], pvs=pvs[i], best_move=best_moves[i],
                depth=depth_reached[i], nodes=nodes_total[i], time_s=times[i],
                nps=nps,
            ))
        return responses

    @staticmethod
    def _apportion_time(elapsed: float, nodes: list) -> list:
        """Chunk wall-clock → per-position times in proportion to each
        position's nodes (all positions share one lockstep dispatch, so
        the implied nps is the chunk's uniform throughput)."""
        total = sum(nodes)
        n = max(len(nodes), 1)
        if total <= 0:
            return [elapsed / n] * n
        return [elapsed * nd / total for nd in nodes]


# ---------------------------------------------- continuous lane refill


class _RefillJob:
    """One analysed position flowing through the LaneScheduler: its own
    iterative-deepening and aspiration-window state, the per-lane form of
    what `_analyse_single` and `_search_windowed` track batch-wide (same
    window schedule, fail checks and budget charging)."""

    __slots__ = (
        "entry", "wp", "board", "variant", "target_depth", "remaining", "deadline", "hh",
        "hm", "depth", "delta_idx", "prev_score", "have_prev", "hardness", "scores",
        "pvs", "depth_reached", "best_move", "nodes_total", "nodes_depth", "lane",
        "helpers",
    )

    def __init__(self, entry, wp, board, variant, target_depth, budget, deadline, hh, hm):
        self.entry = entry
        self.wp = wp
        self.board = board
        self.variant = variant  # device variant: a drive session runs one
        self.target_depth = target_depth
        self.remaining = budget  # node budget left (host int)
        self.deadline = deadline
        self.hh = hh  # (MAX_HIST, 2) repetition-history hashes
        self.hm = hm  # (MAX_HIST,) their halfmove counters
        self.depth = 1  # depth being searched
        self.delta_idx = 0  # index into the aspiration deltas + (None,)
        self.prev_score = 0
        self.have_prev = False
        self.hardness = 1  # previous depth's node count (helper planner)
        self.scores = Matrix()
        self.pvs = Matrix()
        self.depth_reached = 0
        self.best_move: Optional[str] = None
        self.nodes_total = 0
        self.nodes_depth = 0  # nodes across the current depth's attempts
        self.lane = -1  # primary lane while admitted
        self.helpers: dict = {}  # helper lane -> helper number h


class _ChunkEntry:
    """Per-chunk completion tracking shared between the submitting thread
    and whichever thread is driving the device."""

    def __init__(self, chunk: Chunk, started: float):
        self.chunk = chunk
        self.started = started
        self.n_open = 0
        self.responses: dict = {}  # position_index -> PositionResponse
        self.error: Optional[str] = None
        self.event = threading.Event()


class LaneScheduler:
    """Occupancy-driven scheduling of the lockstep search (a port of the
    reference's single-device LaneScheduler).

    One pending-position queue is fed by every concurrently submitted
    single-pv analysis chunk; one full-width search runs per drive
    session, and at every segment boundary finished lanes are refilled
    (ops/search.py refill_lanes) with each position's next depth or
    re-search and with queued positions, earliest deadline first. Spare
    lanes run Lazy-SMP helpers (`_plan_helpers`), and each response is
    delivered the moment its position finishes.

    Concurrency: any number of threads call `run_chunk`. Each submits its
    positions, then either becomes the one thread that drives, taking the
    engine lock and running segments that serve every queued job, or
    waits for its responses. The engine lock is released between
    sessions. Every admission takes a fresh TT generation, passed per lane
    into the table's stores.

    The search state is updated in place (the reference donates it), so
    a lane's PV row is read before the next splice of that lane, and a
    lane whose admission is staged but not yet spliced reports DONE
    again at the next boundary and is skipped there."""

    def __init__(self, engine: "GpuEngine"):
        self.engine = engine
        self._q_lock = threading.Lock()
        self._pending: List[_RefillJob] = []
        self._driving = False
        self._jitter_seq = 0

    # ------------------------------------------------------- submission

    def run_chunk(self, chunk: Chunk) -> List[PositionResponse]:
        entry = self._submit(chunk)
        while not entry.event.is_set():
            with self._q_lock:
                drive = not self._driving
                if drive:
                    self._driving = True
            if drive:
                try:
                    self._drive(entry)
                finally:
                    with self._q_lock:
                        self._driving = False
            else:
                entry.event.wait(0.05)
        if entry.error:
            raise EngineError(entry.error)
        return [entry.responses[wp.position_index] for wp in chunk.positions]

    def _submit(self, chunk: Chunk) -> _ChunkEntry:
        eng = self.engine
        variant = device_variant(chunk.variant)
        entry = _ChunkEntry(chunk, time.monotonic())
        work = chunk.work
        target_depth = min(work.depth or eng.max_depth, eng.max_depth, eng.max_ply - 1)
        budget = work.nodes.get(chunk.flavor.eval_flavor())
        per_pos_budget = budget if budget is not None else 10_000_000
        deadline = chunk.deadline - 0.25  # slack to package results
        jobs = []
        for wp in chunk.positions:
            pos = from_fen(wp.root_fen, chunk.variant)
            game = []
            for uci in wp.moves:
                game.append(pos)
                pos = pos.push(pos.parse_uci(uci))
            if pos.outcome() is not None:
                self._deliver(entry, wp, eng._terminal_response(chunk, wp, pos, 0.001))
                continue
            hh, hm = eng._history_arrays([game], 1, variant)
            jobs.append(_RefillJob(entry, wp, from_position(pos), variant, target_depth,
                                   per_pos_budget, deadline, hh[0], hm[0]))
        entry.n_open = len(jobs)
        if not jobs:
            entry.event.set()
        with self._q_lock:
            self._pending.extend(jobs)
        return entry

    def _deliver(self, entry: _ChunkEntry, wp, response) -> None:
        """Exactly-once delivery point of one position's result: every
        response lands in entry.responses here and only here, so the
        hooks fire once per position."""
        entry.responses[wp.position_index] = response
        hook = self.engine.on_response
        if hook is not None:
            try:
                hook(wp, response)
            except Exception as e:
                self.engine._warn(f"on_response hook failed: {e}")
        deliver = self.engine.on_deliver
        if deliver is not None:
            try:
                deliver(entry.chunk, wp, response)
            except Exception as e:
                self.engine._warn(f"on_deliver hook failed: {e}")

    def _finalize(self, job: _RefillJob, now: float, error: Optional[str] = None) -> None:
        entry = job.entry
        if error is not None:
            entry.error = error
        else:
            dt = max(now - entry.started, 1e-6)
            nps = int(job.nodes_total / dt) if job.nodes_total else None
            self._deliver(entry, job.wp, PositionResponse(
                work=entry.chunk.work, position_index=job.wp.position_index,
                url=job.wp.url, scores=job.scores, pvs=job.pvs, best_move=job.best_move,
                depth=job.depth_reached, nodes=job.nodes_total, time_s=dt, nps=nps,
            ))
            self.engine.occupancy_totals["positions_done"] += 1
        entry.n_open -= 1
        if entry.n_open <= 0:
            entry.event.set()

    # ---------------------------------------------------------- driving

    def _drive(self, entry: _ChunkEntry) -> None:
        while not entry.event.is_set():
            with self._q_lock:
                if not self._pending:
                    return
            # the lock is released between sessions, so a chunk of the
            # serial path gets the device before the next session
            with self.engine._lock:
                self._drive_session(entry)

    def _drive_session(self, entry: _ChunkEntry) -> None:
        """One fixed-width drive session: admit, run segments, process
        boundaries, until no lane is running. The session runs the device
        variant of the earliest-deadline job (each variant is its own
        kernel instantiation); jobs of other variants stay queued for a
        later session."""
        eng = self.engine
        with self._q_lock:
            if not self._pending:
                return
            self._pending.sort(key=lambda j: j.deadline)
            variant = self._pending[0].variant
            n_hint = sum(1 for j in self._pending if j.variant == variant)
            filler = self._pending[0].board
        K = eng.helper_lanes
        B = eng._helper_width(min(max(n_hint, 1), eng.max_lanes))
        # under a mesh B is a multiple of the shards, each owning `local`
        # consecutive lanes; every shard is one this process fills
        mesh = eng.mesh
        n_shard = eng.n_dev
        local = B // n_shard
        seg = settings.get_segment()
        ctrl = None
        if seg is None:  # FISHNET_TPU_SEGMENT=auto
            ctrl = SegmentController(settings.get_int("FISHNET_TPU_SEGMENT_MIN"),
                                     settings.get_int("FISHNET_TPU_SEGMENT_MAX"))
            seg = ctrl.steps
        pipeline = settings.get_bool("FISHNET_TPU_PIPELINE")
        stats = SyncStats()
        prefer_deep = K > 1 and eng.tt is not None
        deltas = tuple(eng.aspiration) + (None,)  # None = full window
        dev = eng.device

        # host-side lane tables
        lane_job: List[Optional[_RefillJob]] = [None] * B  # primary owner
        lane_owner: List[Optional[_RefillJob]] = [None] * B  # helper owner
        lane_alpha = np.full(B, -INF, np.int64)
        lane_beta = np.full(B, INF, np.int64)
        gen = np.zeros(B, np.int32)
        active: List[_RefillJob] = []

        # idle base state: budget-0 lanes park in DONE within two steps
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        state = search_ops.init_state(eng.params, stack_boards([filler] * B).to(dev), zeros,
                                      zeros, eng.max_ply, variant=variant)
        shards = None if mesh is None else mesh_mod.shard_batch(mesh, state)
        states = shards or [state]  # the boundary reads' shards (one device: one)
        tt = eng.tt

        # admissions accumulated between boundaries, flushed as ONE
        # refill_lanes call before each segment
        adm: dict = {k: [] for k in (
            "lane", "board", "depth", "budget", "alpha", "beta", "jitter", "group", "hh",
            "hm",
        )}

        def window_for(job: _RefillJob, scale: int):
            """The per-lane form of _search_windowed's window: narrow
            around the previous depth's score, widening per failed
            attempt; full width at depth 1 and after a mate score."""
            use_win = job.have_prev and abs(job.prev_score) < MATE - 1000 and job.depth >= 2
            delta = deltas[min(job.delta_idx, len(deltas) - 1)]
            if not use_win or delta is None:
                return -INF, INF, None
            return (max(job.prev_score - delta * scale, -INF),
                    min(job.prev_score + delta * scale, INF), delta)

        def admit(lane, board, depth, budget, alpha, beta, jit, grp, hh, hm):
            adm["lane"].append(lane)
            adm["board"].append(board)
            adm["depth"].append(depth)
            adm["budget"].append(int(np.clip(budget, 1, 2**31 - 1)))
            adm["alpha"].append(alpha)
            adm["beta"].append(beta)
            adm["jitter"].append(jit)
            adm["group"].append(grp)
            adm["hh"].append(hh)
            adm["hm"].append(hm)
            lane_alpha[lane] = alpha
            lane_beta[lane] = beta
            # a fresh TT generation per admission: the depth-preferred
            # store never protects the lane's previous occupant's entries
            eng._tt_gen = (eng._tt_gen + 1) & 0x3FFFFFFF
            gen[lane] = eng._tt_gen

        def admit_primary(job: _RefillJob, lane: int):
            job.lane = lane
            lane_job[lane] = job
            a, b, _delta = window_for(job, 1)
            admit(lane, job.board, job.depth, job.remaining, a, b, 0, lane, job.hh, job.hm)

        def admit_helper(job: _RefillJob, lane: int, h: int):
            # _analyse_single's layout: odd h at the primary's depth, even
            # h one ply deeper; staggered window scale; a nonzero jitter;
            # group = the primary's lane
            job.helpers[lane] = h
            lane_owner[lane] = job
            self._jitter_seq = (self._jitter_seq & 0xFFFF) + 1
            a, b, _delta = window_for(job, 1 << min(h, 4))
            d = min(job.depth + (1 - (h & 1)), job.target_depth)
            admit(lane, job.board, d, job.remaining, a, b, self._jitter_seq, job.lane,
                  job.hh, job.hm)

        def release(job: _RefillJob, nodes_row):
            """Free the job's primary and helper lanes; mid-flight helper
            work is charged at the last boundary's node count."""
            if job.lane >= 0:
                lane_job[job.lane] = None
                job.lane = -1
            for hl in list(job.helpers):
                if nodes_row is not None:
                    hn = int(nodes_row[hl])
                    job.nodes_total += hn
                    job.remaining -= hn
                lane_owner[hl] = None
            job.helpers.clear()

        def verdict(job: _RefillJob, lane: int, score: int, nodes: int) -> bool:
            """The aspiration verdict of a parked primary: True when it
            failed its window and is re-admitted at the same depth with
            the next wider one (the per-delta accounting too)."""
            job.nodes_depth += nodes
            a_w = int(lane_alpha[lane])
            b_w = int(lane_beta[lane])
            fail_lo = score <= a_w and a_w > -INF
            fail_hi = score >= b_w and b_w < INF
            delta = deltas[min(job.delta_idx, len(deltas) - 1)]
            if a_w > -INF or b_w < INF:
                st = eng.aspiration_stats.setdefault(delta, [0, 0, 0, 0])
                st[0] += 1
                st[1] += int(fail_lo)
                st[2] += int(fail_hi)
                st[3] += nodes
            if (fail_lo or fail_hi) and delta is not None:
                job.delta_idx += 1
                a, b, _d = window_for(job, 1)
                admit(lane, job.board, job.depth, job.remaining, a, b, 0, lane, job.hh, job.hm)
                return True
            return False

        def depth_done(job: _RefillJob, score: int, move: int, nodes: int, now: float) -> bool:
            """Record a completed depth and charge its nodes; True when
            the job is final (target depth, budget or deadline)."""
            job.prev_score = score
            job.have_prev = True
            job.hardness = max(nodes, 1)
            job.nodes_total += job.nodes_depth
            job.remaining -= job.nodes_depth
            job.nodes_depth = 0
            job.delta_idx = 0
            job.scores.set(1, job.depth, _score_from_int(score))
            job.depth_reached = job.depth
            job.best_move = _decode_uci(move) if move >= 0 else None
            return job.depth >= job.target_depth or job.remaining <= 0 or now >= job.deadline

        def next_depth(job: _RefillJob, lane: int):
            job.depth += 1
            a, b, _d = window_for(job, 1)
            admit(lane, job.board, job.depth, job.remaining, a, b, 0, lane, job.hh, job.hm)

        def pv_list(row, length) -> list:
            return [_decode_uci(int(m)) for m in row[: int(length)] if m >= 0]

        def on_primary_done(job: _RefillJob, lane: int, res: dict, now: float):
            """A primary parked in DONE (synchronous loop, full results):
            re-search, next depth, or finalize."""
            score = int(res["score"][lane])
            nodes = int(res["nodes"][lane])
            if verdict(job, lane, score, nodes):
                return
            final = depth_done(job, score, int(res["move"][lane]), nodes, now)
            job.pvs.set(1, job.depth, pv_list(res["pv"][lane], res["pv_len"][lane]))
            if final:
                release(job, res["nodes"])
                active.remove(job)
                self._finalize(job, now)
                return
            next_depth(job, lane)

        # pipelined boundary state: PV reads deferred past boundaries as
        # (job, lane, depth, final); the PV row is the one per-lane result
        # not in the packed summary
        pv_pending: List[tuple] = []
        last_device_s = 0.0

        def q_len_locked() -> int:
            with self._q_lock:
                return len(self._pending)

        def on_primary_parked(job: _RefillJob, lane: int, score: int, move: int,
                              nodes: int, nodes_row, now: float):
            """The pipelined loop's on_primary_done, from the packed
            summary; the PV row waits for flush_pv, which reads it before
            the splice that resets the lane."""
            if verdict(job, lane, score, nodes):
                return
            final = depth_done(job, score, move, nodes, now)
            pv_pending.append((job, lane, job.depth, final))
            if final:
                release(job, nodes_row)
                active.remove(job)
                return  # _finalize waits in flush_pv for the PV row
            next_depth(job, lane)

        def flush_pv(now: float):
            """Read the deferred PV rows (two small gathers), then finalize
            the jobs that waited only on them. Runs before flush_adm: a
            splice resets the spliced lanes' PV tables."""
            if not pv_pending:
                return
            lanes = [e[1] for e in pv_pending]
            pv_rows = search_ops.fetch_rows(states, lanes, lambda x: x.pv[:, 0], stats, "pv")
            pv_lens = search_ops.fetch_rows(states, lanes,
                                            lambda x: x.nt[:, 0, search_ops.NT_PVLEN], stats,
                                            "pv_len")
            for i, (job, _lane, depth, final) in enumerate(pv_pending):
                job.pvs.set(1, depth, pv_list(pv_rows[i], pv_lens[i]))
                if final:
                    self._finalize(job, now)
            pv_pending.clear()

        def reap_jobs(now: float, nodes_row):
            # jobs past their chunk deadline
            for job in list(active):
                if now >= job.deadline:
                    release(job, nodes_row)
                    active.remove(job)
                    if pv_pending:
                        # the response below holds job.pvs by reference: a
                        # deferred read after it would change a sent response
                        pv_pending[:] = [e for e in pv_pending if e[0] is not job]
                    if job.depth_reached == 0:
                        # no usable result: fail the chunk so the server
                        # reassigns it (as the serial path does)
                        self._finalize(job, now, error="chunk deadline expired before "
                                                       "depth 1 completed")
                    else:
                        self._finalize(job, now)

        def admit_new(now: float):
            # pending positions, earliest deadline first; each admission
            # takes the lowest free lane of the shard with the most free
            # lanes (the lowest such shard on a tie), so positions spread
            # over the shards; on one device, the free lanes in ascending
            # order
            free_by_shard: List[List[int]] = [[] for _ in range(n_shard)]
            for i in range(B):
                if lane_job[i] is None and lane_owner[i] is None:
                    free_by_shard[i // local].append(i)
            n_free = sum(len(f) for f in free_by_shard)

            def take_lane() -> int:
                s = max(range(n_shard), key=lambda i: len(free_by_shard[i]))
                return free_by_shard[s].pop(0)

            if not entry.event.is_set():
                with self._q_lock:
                    self._pending.sort(key=lambda j: j.deadline)
                    take = [j for j in self._pending if j.variant == variant][:n_free]
                    for j in take:
                        self._pending.remove(j)
                for job in take:
                    if now >= job.deadline:
                        self._finalize(job, now, error="chunk deadline expired before "
                                                       "depth 1 completed")
                        continue
                    admit_primary(job, take_lane())
                    n_free -= 1
                    active.append(job)
            # leftover free lanes run Lazy-SMP helpers
            if K > 1 and tt is not None and n_free and active:
                n_act = len(active)
                cur = sum(len(j.helpers) for j in active)
                hardness = [j.hardness if j.remaining > 0 else 0 for j in active]
                plan = GpuEngine._plan_helpers(n_act, n_act + cur + n_free, K, hardness)
                want: dict = {}
                for r, _h in plan:
                    want[r] = want.get(r, 0) + 1
                for r, job in enumerate(active):
                    while n_free and len(job.helpers) < want.get(r, 0):
                        admit_helper(job, take_lane(), len(job.helpers) + 1)
                        n_free -= 1

        def shard_occup():
            """Busy (primary or helper) lanes a shard, or None without a
            mesh: the per-shard occupancy column."""
            if mesh is None:
                return None
            return [sum(1 for i in range(s * local, (s + 1) * local)
                        if lane_job[i] is not None or lane_owner[i] is not None)
                    for s in range(n_shard)]

        def flush_adm():
            # the staged admissions in ONE in-place splice (each shard's
            # lanes spliced on its own under a mesh) → (admissions, per-shard
            # admissions or None)
            n_adm = len(adm["lane"])
            if not n_adm:
                return 0, None
            adm_shard = None if mesh is None else np.bincount(
                np.asarray(adm["lane"], np.int64) // local, minlength=n_shard).astype(
                    int).tolist()
            splice_args = (
                stack_boards(adm["board"]), adm["lane"], np.asarray(adm["depth"], np.int32),
                np.asarray(adm["budget"], np.int32))
            splice_kw = dict(
                hist_hash=np.stack(adm["hh"]), hist_halfmove=np.stack(adm["hm"]),
                root_alpha=np.asarray(adm["alpha"], np.int32),
                root_beta=np.asarray(adm["beta"], np.int32),
                order_jitter=np.asarray(adm["jitter"], np.int32),
                group=np.asarray(adm["group"], np.int32), variant=variant)
            if mesh is None:
                search_ops.refill_lanes(eng.params, state, *splice_args, **splice_kw)
            else:
                mesh_mod.refill_lanes_sharded(mesh, eng.shard_params, shards, *splice_args,
                                              **splice_kw)
            for k in adm:
                adm[k].clear()
            return n_adm, adm_shard

        def dispatch(n_steps: int):
            """One segment over the state and table, in place, with each
            lane's generation → (steps, packed summary); under a mesh
            (steps of each shard, stacked host summary)."""
            if mesh is not None:
                return stats.device_call(mesh_mod.run_segment_sharded, mesh, eng.shard_params,
                                         shards, tt, n_steps, None, False, prefer_deep,
                                         gen.copy(), variant)
            return stats.device_call(search_ops.run_segment, eng.params, state, n_steps,
                                     None, tt, False, prefer_deep,
                                     torch.from_numpy(gen.copy()).to(dev), variant)

        def shard_cols(live, refilled, steps):
            return None if mesh is None else {
                "shard_live": live, "shard_refilled": refilled or [0] * n_shard,
                "shard_steps": steps}

        def charge_helpers(lane_done, nodes_row, staged=()):
            # helper lanes that parked on their own: charge and free
            for lane in range(B):
                job = lane_owner[lane]
                if job is not None and lane_done[lane] and lane not in staged:
                    hn = int(nodes_row[lane])
                    job.nodes_total += hn
                    job.remaining -= hn
                    del job.helpers[lane]
                    lane_owner[lane] = None

        res: Optional[dict] = None
        try:
            if not pipeline:
                # synchronous loop (FISHNET_TPU_PIPELINE=0): run the
                # segment, read the full result set, refill, repeat
                while True:
                    now = time.monotonic()
                    reap_jobs(now, res["nodes"] if res is not None else None)
                    admit_new(now)
                    n_adm, adm_shard = flush_adm()
                    if not active:
                        break  # nothing running; the next session continues
                    live_n = len(active)
                    helper_n = sum(len(j.helpers) for j in active)
                    shard_live = shard_occup()
                    disp_steps = seg
                    n, shard_steps = search_ops.boundary_steps(dispatch(seg), B, stats, mesh)
                    q_len = q_len_locked()
                    lane_done = search_ops.fetch_lanes(
                        [x.lane[:, search_ops.LN_MODE] == search_ops.MODE_DONE for x in states],
                        stats, "done")
                    parts = [search_ops.extract_results(x, 0) for x in states]
                    res = {k: search_ops.fetch_lanes([p[k] for p in parts], stats, k)
                           for k in parts[0] if k != "steps"}
                    now = time.monotonic()
                    charge_helpers(lane_done, res["nodes"])
                    for lane in range(B):
                        job = lane_job[lane]
                        if job is not None and lane_done[lane]:
                            on_primary_done(job, lane, res, now)
                    snap = stats.boundary()
                    self._record_occupancy(B, n, live_n, helper_n, n_adm, q_len,
                                           snap["host_ms"], snap["device_ms"],
                                           snap["transfers"],
                                           shard_cols(shard_live, adm_shard, shard_steps))
                    if ctrl is not None:
                        seg = ctrl.update(n >= disp_steps, snap["host_ms"], snap["device_ms"])
            else:
                # pipelined loop: each boundary is processed from its packed
                # summary, and when every decision is already settled the
                # next segment is dispatched first (in this package it runs
                # to its end at once, so nothing overlaps yet)
                now = time.monotonic()
                reap_jobs(now, None)
                admit_new(now)
                n_adm, adm_shard = flush_adm()
                pend = None
                if active:
                    pend_meta = (len(active), sum(len(j.helpers) for j in active), n_adm,
                                 q_len_locked(), shard_occup(), adm_shard)
                    pend_steps = seg
                    pend = dispatch(seg)
                while pend is not None:
                    nxt = None
                    now = time.monotonic()
                    margin = now + 2.0 * last_device_s
                    if (not adm["lane"] and not pv_pending and q_len_locked() == 0
                            and all(margin < j.deadline for j in active)):
                        # nothing staged, no PV owed, nothing queued, no
                        # deadline within ~2 segments: the synchronous loop
                        # would run the next segment unchanged
                        nxt_meta = (len(active), sum(len(j.helpers) for j in active), 0, 0,
                                    shard_occup(), None)
                        nxt_steps = seg
                        nxt = dispatch(seg)
                    summ, n, shard_steps = search_ops.boundary_summary(pend, B, stats, mesh)
                    lane_done = summ[:, search_ops.SUM_DONE].astype(bool)
                    nodes_row = summ[:, search_ops.SUM_NODES]
                    # lanes whose park was handled at an earlier boundary
                    # (admission staged, splice pending) report DONE again
                    staged = set(adm["lane"])
                    now = time.monotonic()
                    charge_helpers(lane_done, nodes_row, staged)
                    for lane in range(B):
                        job = lane_job[lane]
                        if job is None or not lane_done[lane] or lane in staged:
                            continue
                        on_primary_parked(job, lane, int(summ[lane, search_ops.SUM_SCORE]),
                                          int(summ[lane, search_ops.SUM_MOVE]),
                                          int(nodes_row[lane]), nodes_row, now)
                    reap_jobs(now, nodes_row)
                    admit_new(now)
                    if nxt is None:
                        # the PV rows are read before the splice below
                        flush_pv(now)
                    snap = stats.boundary()
                    last_device_s = snap["device_ms"] / 1000.0
                    self._record_occupancy(B, n, *pend_meta[:4], snap["host_ms"],
                                           snap["device_ms"], snap["transfers"],
                                           shard_cols(*pend_meta[4:], shard_steps))
                    if ctrl is not None:
                        seg = ctrl.update(n >= pend_steps, snap["host_ms"], snap["device_ms"])
                    if nxt is not None:
                        pend, pend_meta, pend_steps = nxt, nxt_meta, nxt_steps
                        continue
                    n_adm, adm_shard = flush_adm()
                    if not active:
                        break  # the next session handles the rest
                    pend_meta = (len(active), sum(len(j.helpers) for j in active), n_adm,
                                 q_len_locked(), shard_occup(), adm_shard)
                    pend_steps = seg
                    pend = dispatch(seg)
        except BaseException as e:
            # the drive loop died mid-session: fail every admitted job so no
            # submitting thread waits forever
            now = time.monotonic()
            for job in active:
                release(job, None)
                self._finalize(job, now, error=f"gpu engine failed: {e}")
            # jobs released at a park whose _finalize waited on a PV read
            for job, _lane, _depth, final in pv_pending:
                if final:
                    self._finalize(job, now)
            pv_pending.clear()
            raise

    def _record_occupancy(self, width, steps, live, helpers, refilled, queue, host_ms,
                          device_ms, transfers, shard=None):
        tot = self.engine.occupancy_totals
        idle = width - live - helpers
        tot["host_ms"] += host_ms
        tot["device_ms"] += device_ms
        tot["transfers"] += transfers
        if steps == 0 and refilled == 0:
            # a pipelined segment that ran zero steps (every lane finished
            # in the previous one): its sync costs count, but it is no
            # occupancy row
            return
        tot["segments"] += 1
        tot["steps"] += steps
        tot["lane_steps"] += steps * width
        tot["live_lane_steps"] += steps * live
        tot["helper_lane_steps"] += steps * helpers
        tot["idle_lane_steps"] += steps * idle
        tot["refills"] += refilled
        log = self.engine.occupancy_log
        row = {
            "segment": tot["segments"], "width": width, "steps": steps, "live": live,
            "helpers": helpers, "idle": idle, "refilled": refilled, "queue": queue,
            "transfers": transfers, "host_ms": host_ms, "device_ms": device_ms,
        }
        if shard is not None:
            # mesh sessions: busy lanes (primaries and helpers), admissions
            # and step counts a shard
            row.update(shard)
        log.append(row)
        if len(log) > 4096:
            del log[:-4096]
