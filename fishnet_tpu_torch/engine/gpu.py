"""The batch engine on the card: chunks in, PositionResponses out.

A port of the chunk-serial path of the JAX package's engine/tpu.py
(`TpuEngine` with refill off, one lane per position and no
transposition table). All positions of an analysis chunk become lanes of
one lockstep search; iterative deepening and aspiration windows run on
the host, filling the per-depth score and PV matrices the reference's
UCI parser would have accumulated (reference: src/stockfish.rs:222-465).

Not ported yet, and refused rather than run another way: move jobs,
multipv, Lazy-SMP helper lanes, continuous lane refill, the
transposition table, variants other than standard chess and chess960.
"""
from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np

from .. import device as device_mod
from .. import settings
from ..chess.position import VARIANTS, Position, from_fen
from ..ipc import AnalysisWork, Chunk, Matrix, PositionResponse, Score, WorkPosition
from ..models import nnue
from ..ops import tt as tt_mod
from ..ops.board import from_position, stack_boards
from ..ops.search import HIST_HM_SENTINEL, INF, MATE, MAX_HIST, search_batch_resumable
from .base import BatchEngine, EngineError

# lane counts are padded to these widths (then to multiples of 256) so a
# handful of batch shapes serve every chunk
LANE_BUCKETS = (16, 64, 128, 256)
# aspiration window half-widths tried in order before the full window
# (the JAX package's measured default; FISHNET_TPU_ASPIRATION overrides)
ASPIRATION_DELTAS = (15, 120)


def _decode_uci(m: int) -> str:
    frm, to, promo = m & 63, (m >> 6) & 63, (m >> 12) & 7
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


class GpuEngine(BatchEngine):
    """Batched analysis engine. params: an nnue.NnueParams (default: the
    shipped board768 net); device: where it runs (default the card — it
    raises without one)."""

    name = "gpu"

    def __init__(
        self,
        params: Optional[nnue.NnueParams] = None,
        weights_path: Optional[str] = None,
        max_depth: int = 12,
        tt_size_log2: int = 0,
        helper_lanes: int = 1,
        refill: bool = False,
        device=None,
    ) -> None:
        if tt_size_log2:
            raise NotImplementedError("the transposition table is not ported yet")
        if helper_lanes != 1:
            raise NotImplementedError("helper lanes are not ported yet")
        if refill:
            raise NotImplementedError("continuous lane refill is not ported yet")
        self.device = device_mod.resolve(device)
        if params is None:
            params = (nnue.load_params(weights_path, self.device) if weights_path
                      else nnue.load_params(device=self.device))
        self.params = params.to(self.device)
        self.max_depth = max_depth
        self.max_ply = settings.get_int("FISHNET_TPU_MAX_PLY")
        self.aspiration = (
            settings.get_csv_int("FISHNET_TPU_ASPIRATION") or ASPIRATION_DELTAS
        )
        self._lock = threading.Lock()

    # ------------------------------------------------------------- chunks

    def _go_multiple_sync(self, chunk: Chunk) -> List[PositionResponse]:
        with self._lock:
            return self._go_multiple_locked(chunk)

    def _go_multiple_locked(self, chunk: Chunk) -> List[PositionResponse]:
        started = time.monotonic()
        work = chunk.work
        if not isinstance(work, AnalysisWork):
            raise NotImplementedError("move jobs are not ported yet")
        if work.effective_multipv() != 1:
            raise NotImplementedError("multipv analysis is not ported yet")
        if chunk.variant not in VARIANTS:
            raise NotImplementedError(f"variant {chunk.variant!r} is not ported yet")
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
        return self._analyse_single(chunk, positions, games, target_depth, budget, started)

    def _search(self, roots, depth_arr, budget_arr, deadline=None, hist=None,
                window=None) -> dict:
        return search_batch_resumable(
            self.params, roots, depth_arr, budget_arr, max_ply=self.max_ply,
            deadline=deadline, hist=hist, window=window, device=self.device,
        )

    def _search_windowed(self, roots, depth_arr, budget_arr, deadline, hist,
                         prev_score, use_win) -> dict:
        """Aspiration-windowed dispatch: a narrow window around the
        previous depth's score; lanes that fail low or high re-search
        wider (the others ride along at depth 0 / budget 1). Returns the
        merged results with per-lane nodes summed over attempts."""
        B = int(depth_arr.shape[0])
        merged = None
        nodes_acc = np.zeros(B, np.int64)
        live = np.ones(B, bool)
        prev_score = np.asarray(prev_score, np.int64)
        for delta in tuple(self.aspiration) + (None,):  # None = full window
            if delta is None or not use_win.any():
                alpha_w = np.full(B, -INF, np.int32)
                beta_w = np.full(B, INF, np.int32)
            else:
                alpha_w = np.where(use_win, np.maximum(prev_score - delta, -INF), -INF).astype(np.int32)
                beta_w = np.where(use_win, np.minimum(prev_score + delta, INF), INF).astype(np.int32)
            out = self._search(
                roots, np.where(live, depth_arr, 0).astype(np.int32),
                np.where(live, budget_arr, 1).astype(np.int32), deadline,
                hist=hist, window=(alpha_w, beta_w),
            )
            if merged is None:
                merged = {k: np.array(v) for k, v in out.items()}
            else:
                for k in ("score", "move", "pv", "pv_len", "done"):
                    merged[k][live] = out[k][live]
            nodes_acc[live] += out["nodes"][live]
            score = out["score"]
            fail = live & out["done"] & (
                ((score <= alpha_w) & (alpha_w > -INF)) | ((score >= beta_w) & (beta_w < INF))
            )
            live = fail
            if not live.any():
                break
            if deadline is not None and time.monotonic() >= deadline:
                # a failed lane holds only a bound: not a score
                merged["done"][live] = False
                break
        merged["nodes"] = nodes_acc
        return merged

    def _history_arrays(self, hist_lists, B):
        """Per-lane reversible game tails → the search's history seeds.

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
            keys = tt_mod.hash_boards(stacked).cpu().numpy()
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
                        started) -> List[PositionResponse]:
        terminal = {i for i, p in enumerate(positions) if p.outcome() is not None}
        lanes = [i for i in range(len(positions)) if i not in terminal]
        scores = [Matrix() for _ in positions]
        pvs = [Matrix() for _ in positions]
        depth_reached = [0] * len(positions)
        best_moves: List[Optional[str]] = [None] * len(positions)
        nodes_total = [0] * len(positions)

        if lanes:
            n = len(lanes)
            B = _pad_lanes(n)
            boards = [from_position(positions[i]) for i in lanes]
            roots = stack_boards(boards + [boards[0]] * (B - n))
            hist = self._history_arrays([games[i] for i in lanes], B)
            per_pos_budget = budget if budget is not None else 10_000_000
            remaining = np.full(n, per_pos_budget, dtype=np.int64)
            prev_score = np.zeros(n, np.int64)
            have_prev = np.zeros(n, bool)
            deadline = chunk.deadline - 0.25  # slack to package results
            for depth in range(1, target_depth + 1):
                depth_arr = np.zeros(B, np.int32)
                depth_arr[:n] = depth
                budget_arr = np.ones(B, np.int32)
                budget_arr[:n] = np.clip(remaining, 0, 2**31 - 1)
                use_win = np.zeros(B, bool)
                use_win[:n] = have_prev & (np.abs(prev_score) < MATE - 1000) & (depth >= 2)
                prev_full = np.zeros(B, np.int64)
                prev_full[:n] = prev_score
                out = self._search_windowed(
                    roots, depth_arr, budget_arr, deadline, hist, prev_full, use_win,
                )
                exhausted_all = True
                for j, i in enumerate(lanes):
                    if remaining[j] <= 0 or not bool(out["done"][j]):
                        continue  # lane skipped, or stopped mid-depth on deadline
                    lane_nodes = int(out["nodes"][j])
                    nodes_total[i] += lane_nodes
                    remaining[j] -= lane_nodes
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
