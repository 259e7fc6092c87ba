"""Lockstep batched alpha-beta search, batched over lanes in PyTorch.

A port of the JAX package's ops/search.py (standard chess, chess960 and
the variants threeCheck, kingOfTheHill, racingKings, horde, atomic,
antichess and crazyhouse, with or without the shared transposition table, with
Lazy-SMP lane-group metadata). The variant is a static argument, as in
the reference: a node at a variant's game end (node_rules' term_kind)
is a leaf worth a mate score or a draw, antichess changes the mate rule
and turns the null move off, and crazyhouse's move lists are
MAX_MOVES_ZH wide. B independent lanes each keep an explicit DFS
stack and advance together, one ENTER/RETURN/TRYMOVE state-machine step
per call of `_step`:

- copy-make: child boards are written to a (B, MAX_PLY+1, ...) stack, so
  there is no unmake;
- pseudo-legal movegen + king-capture refutation: a move that leaves the
  king en prise is refuted at the child (ILLEGAL sentinel);
- ENTER classifies a node (illegal / leaf / expand with movegen), RETURN
  folds a finished child into its parent, TRYMOVE picks the next move or
  finishes the node; a leaf child costs one step;
- per-lane node budgets and depth limits; lanes park in DONE, where a
  step changes nothing the results read.

State is the reference's packed layout (same field constants): board
rows `bt`, per-node scalars `nt`, per-lane scalars `lane`, plus the move
lists, history counters, PV table and incremental NNUE accumulators. The
JAX reference builds a new state each step; this port writes the same
rows in place, in the same order, each under the same mask.

On the card a whole segment is one kernel, K11 (csrc/search_segment.cu,
csrc/search.cuh): `run_segment` launches it once, and it runs up to
segment_steps steps of every lane (a warp per lane), the TT runner
around each step, the exit test and the packed summary, with the lane
tables and the table in device memory. `init_state` runs the root
refresh (K1) and writes every lane with K7 (lane_init).

The net: on board768 the step carries each node's accumulators down the
stack (K3) and evaluates a leaf from them (K2). Any other net (a
king-bucketed NnueParams, an imported Stockfish net) pays a full eval at
every leaf (K12, K13), updates no accumulator, and starts from zero root
accumulators without K1, as the reference does; the state keeps the
reference's (B, P+1, 2, L1) `acc` table all the same. In atomic a
capture's blast removes up to ten pieces, more than the four change
slots the update takes, so there, as in the reference, a board768 leaf
is a full eval too (the refresh, K1's body, then K2's) and the step
carries no accumulator: `acc` keeps the roots' pairs init_state wrote.

`run_segment_plain` is K11's plain version: the batched PyTorch step
`_step` (and `_tt_step`, the reference's TT runner: a store of the
lanes parked in RETURN, a probe of the lanes about to ENTER, the step,
and a store of the leaves it marked) in the reference's while loop. The
CPU runs it; on the card only the comparison with K11 does, and there
its calls of the board rules (K8), move generator (K9), make-move (K10),
Zobrist hash (K4), leaf eval (K2, or K12/K13), accumulator update (K3)
and TT probe and store (K5, K6) launch those kernels.

Continuous lane refill: `refill_lanes` splices fresh roots into chosen
lanes of a running state in place (K1 on the new roots of a board768
net, then K7 writes those lanes; every other lane keeps its state bit for bit), and
`search_stream` streams N positions through a fixed width, refilling
DONE lanes at segment boundaries.

The lane mesh: `search_stream(mesh=...)` and
`search_batch_resumable(mesh=...)` shard the lanes over the devices of a
parallel/mesh.py mesh, each shard advancing and refilled on its own (one
K11 and one K7 a shard), with a table a shard.
"""
from __future__ import annotations

import time as _time
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .. import kernels, settings
from ..models import nnue
from ..syncstats import SegmentController, SyncStats
from . import tt as tt_mod
from .board import (
    BT_BOARD, BT_CAST, BT_EP, BT_EXTRA, BT_HM, BT_PH1, BT_PH2, BT_STM, BT_W, EXTRA_W,
    TERM_LOSS, TERM_NONE, TERM_WIN, Board, attack_parts, board_from_rows, make_move_rows,
    node_rules, rays_of, rows_from_board,
)
from .movegen import DROP_FLAG, generate_moves, max_moves_for

INF = 32500
MATE = 32000
ILLEGAL = 99999  # sentinel: the move leading to this node was illegal
DRAW = 0

MODE_ENTER = 0
MODE_RETURN = 1
MODE_TRYMOVE = 2
MODE_DONE = 3

# packed boundary summary (int32, (B+1, 4)): done flag, nodes, root
# score, root move per lane; row B carries the segment's step count
SUM_DONE, SUM_NODES, SUM_SCORE, SUM_MOVE = range(4)
SUM_W = 4

# game-history repetition seeding (see init_state)
MAX_HIST = 16
HIST_HM_SENTINEL = -32000

# nt fields (one int32 row per node)
(NT_COUNT, NT_MIDX, NT_SEARCHED, NT_ALPHA, NT_ALPHA0, NT_BETA, NT_BEST,
 NT_BMOVE, NT_NULL, NT_LASTRED, NT_PVLEN, NT_DL, NT_INCHECK, NT_K0,
 NT_K1) = range(15)
NT_W = 16
# bt fields (one int32 row per node's board): BT_BOARD..BT_W, board.py
# lane fields
(LN_PLY, LN_MODE, LN_RET, LN_RETD, LN_SMARK, LN_SVAL, LN_NODES, LN_DLIM,
 LN_BUDGET, LN_RSCORE, LN_RMOVE, LN_RALPHA, LN_RBETA, LN_RESEARCH) = range(14)
LN_JITTER = 14
LN_GROUP = 15
LN_W = 16

# nt fields ENTER writes on expansion / on every entry
_FM_EXPAND = np.zeros(NT_W, bool)
_FM_EXPAND[[NT_COUNT, NT_MIDX, NT_SEARCHED, NT_ALPHA, NT_ALPHA0, NT_BETA,
            NT_BEST, NT_BMOVE, NT_NULL, NT_LASTRED]] = True
_FM_ENTER = np.zeros(NT_W, bool)
_FM_ENTER[[NT_PVLEN, NT_INCHECK]] = True

NULL_R = 2  # base null-move depth reduction (+1 at depth_left >= NULL_DEEP_DEPTH)
NULL_MIN_DEPTH = 3  # null move from depth_left 3
NULL_DEEP_DEPTH = 7
MATE_BOUND = MATE - 1000  # static evals are clamped to +-MATE_BOUND; windows past it prune nothing
FIFTY_PLIES = 100  # the halfmove clock of a fifty-move draw
FUTILITY_DEPTH = 2  # futility pruning at depth_left <= 2, margins by depth_left
FUTILITY_MARGIN_1 = 150
FUTILITY_MARGIN_2 = 300
LMR_MIN_DEPTH = 3  # late-move reduction from depth_left 3 and the fourth move,
LMR_MIN_MOVE = 3  # by one ply, by two from the ninth move
LMR_DEEP_MOVE = 8
HIST_SIZE = 4096  # from|to history counters per lane
HIST_BONUS_MAX = 1024  # a fail-high's history bonus: min(depth^2 + 1, 1024)
HIST_MAX = 1 << 20
# the null child's board row from its parent's: the same board, castling
# rooks and variant words (threeCheck's counters), the other side to
# move, no ep square, halfmove 0, the path-hash words 0 (as
# rows_from_board writes them)
_NULL_MUL = np.zeros(BT_W, np.int32)
_NULL_MUL[BT_BOARD:BT_BOARD + 64] = 1
_NULL_MUL[BT_CAST:BT_CAST + 4] = 1
_NULL_MUL[BT_EXTRA:BT_EXTRA + EXTRA_W] = 1
_NULL_MUL[BT_STM] = -1
_NULL_ADD = np.zeros(BT_W, np.int32)
_NULL_ADD[BT_STM] = 1
_NULL_ADD[BT_EP] = -1

_I32 = torch.int32


class SearchState(NamedTuple):
    bt: torch.Tensor  # (B, P+1, BT_W) int32 board rows
    nt: torch.Tensor  # (B, P+1, NT_W) int32 per-node scalars
    lane: torch.Tensor  # (B, LN_W) int32 per-lane scalars
    hist_hash: torch.Tensor  # (B, MAX_HIST, 2) int32 pre-root game hashes
    hist_halfmove: torch.Tensor  # (B, MAX_HIST) int32
    moves: torch.Tensor  # (B, P, max_moves_for(variant)) int32
    hist: torch.Tensor  # (B, HIST_SIZE) int32 from|to history counters
    pv: torch.Tensor  # (B, P, P) int32
    acc: torch.Tensor  # (B, P+1, 2, L1) incremental NNUE accumulators


def _row(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (B, R, ...) → each lane's row idx[b], shape (B, ...)."""
    B = table.shape[0]
    flat = table.view(B, table.shape[1], -1)
    rows = flat.gather(1, idx.view(B, 1, 1).expand(B, 1, flat.shape[2]))
    return rows.view((B,) + table.shape[2:])


def _set_row(table: torch.Tensor, idx: torch.Tensor, row: torch.Tensor,
             mask: torch.Tensor) -> None:
    """table[b, idx[b]] = row[b] where mask[b], in place: one gather and
    one scatter (indexed assignment would sort its indices first)."""
    B = table.shape[0]
    flat = table.view(B, table.shape[1], -1)
    index = idx.view(B, 1, 1).expand(B, 1, flat.shape[2])
    new = torch.where(mask.view(B, 1, 1), row.reshape(B, 1, -1), flat.gather(1, index))
    flat.scatter_(1, index, new)


def _is_quiet(move: torch.Tensor, board: torch.Tensor) -> torch.Tensor:
    """Non-capture, non-promotion move (a crazyhouse drop is quiet; en
    passant reads as quiet, which only costs ordering); move >= 0."""
    to = ((move >> 6) & 63).long()
    return ((move & DROP_FLAG) != 0) | (
        (board.gather(1, to[:, None])[:, 0] == 0) & (((move >> 12) & 7) == 0))


def init_state(params: nnue.NnueParams, roots: Board, depth: torch.Tensor,
               node_budget: torch.Tensor, max_ply: int, hist_hash=None,
               hist_halfmove=None, root_alpha=None, root_beta=None,
               order_jitter=None, group=None, variant: str = "standard") -> SearchState:
    """roots: batched Board on the search's device; depth/node_budget
    (B,). hist_hash (B, MAX_HIST, 2) int32 / hist_halfmove (B, MAX_HIST):
    optional reversible game tail per lane (None: no pre-root
    repetitions possible). root_alpha/root_beta (B,): optional
    aspiration window at the root.

    order_jitter (B,): optional move-ordering seed of Lazy-SMP helper
    lanes. A lane with jitter j != 0 starts from pseudo-random history
    counters 0..255 hash-mixed from j, so it orders its quiet moves
    differently from the other lanes of its group; jitter 0 seeds zeros
    (the lane searches as without the argument). group (B,): an opaque
    lane-group tag, stored and not read by the search. variant: the
    device variant the state will be searched under (its move lists'
    width; NotImplementedError for a name that is not one).

    On the card the state is allocated uninitialised and K7 (lane_init)
    writes every lane after K1's root refresh; on the CPU the plain
    version builds it. The accumulators are the net's acc_dtype: int32 on
    the int8 net, f32 on the others, bf16 weights included (nothing of
    the state takes the weights' dtype)."""
    B = roots.board.shape[0]
    width = max_moves_for(variant)
    args = _lane_inputs(params, roots, depth, node_budget, hist_hash, hist_halfmove,
                        root_alpha, root_beta, order_jitter, group)
    dev = roots.board.device
    if dev.type == "cpu":
        return _fresh_state(*args, max_ply, width)
    state = _empty_state(B, max_ply, params.l1, nnue.acc_dtype(params), dev, width)
    kernels.lane_init(state, torch.arange(B, device=dev), *args)
    return state


def _lane_inputs(params, roots: Board, depth, node_budget, hist_hash=None,
                 hist_halfmove=None, root_alpha=None, root_beta=None,
                 order_jitter=None, group=None) -> tuple:
    """init_state's arguments for n lanes → K7's inputs on the roots'
    device: (rows (n, BT_W), root accumulators (n, 2, L1) from K1 on a
    board768 net and zeros on any other,
    depth, budget, alpha, beta, jitter, group (n,), hist_hash
    (n, MAX_HIST, 2), hist_halfmove (n, MAX_HIST)), every None expanded
    to init_state's default."""
    dev = roots.board.device
    n = roots.board.shape[0]

    def col(x, default):
        if x is None:
            return torch.full((n,), default, dtype=_I32, device=dev)
        return x.to(device=dev, dtype=_I32).contiguous()

    if hist_hash is None:
        hist_hash = torch.zeros((n, MAX_HIST, 2), dtype=_I32, device=dev)
    if hist_halfmove is None:
        hist_halfmove = torch.full((n, MAX_HIST), HIST_HM_SENTINEL, dtype=_I32, device=dev)
    if nnue.is_board768(params):
        root_acc = nnue.accumulators_768(params, roots.board.to(_I32).contiguous())
    else:  # a full-eval net: zero root accumulators, as the reference's
        root_acc = torch.zeros((n, 2, params.l1), dtype=nnue.acc_dtype(params), device=dev)
    return (
        rows_from_board(roots).contiguous(), root_acc,
        col(depth, 0), col(node_budget, 0), col(root_alpha, -INF), col(root_beta, INF),
        col(order_jitter, 0), col(group, 0),
        hist_hash.to(device=dev, dtype=_I32).contiguous(),
        hist_halfmove.to(device=dev, dtype=_I32).contiguous(),
    )


def _empty_state(B: int, max_ply: int, l1: int, acc_dtype, dev,
                 max_moves: int) -> SearchState:
    P = max_ply

    def empty(shape, dtype=_I32):
        return torch.empty(shape, dtype=dtype, device=dev)

    return SearchState(
        bt=empty((B, P + 1, BT_W)), nt=empty((B, P + 1, NT_W)), lane=empty((B, LN_W)),
        hist_hash=empty((B, MAX_HIST, 2)), hist_halfmove=empty((B, MAX_HIST)),
        moves=empty((B, P, max_moves)), hist=empty((B, HIST_SIZE)), pv=empty((B, P, P)),
        acc=empty((B, P + 1, 2, l1), acc_dtype),
    )


def _fresh_state(rows, root_acc, depth, budget, alpha, beta, jitter, group, hist_hash,
                 hist_halfmove, max_ply: int, max_moves: int) -> SearchState:
    """K7's plain version for n lanes: the state init_state gives them,
    from K7's inputs, with move lists max_moves wide."""
    dev = rows.device
    B, P = rows.shape[0], max_ply

    def full(shape, value):
        return torch.full(shape, value, dtype=_I32, device=dev)

    acc = torch.zeros((B, P + 1) + tuple(root_acc.shape[1:]), dtype=root_acc.dtype, device=dev)
    acc[:, 0] = root_acc

    bt = torch.zeros((B, P + 1, BT_W), dtype=_I32, device=dev)
    bt[:, :, BT_EP] = -1
    bt[:, :, BT_CAST:BT_CAST + 4] = -1
    bt[:, 0] = rows

    nt = torch.zeros((B, P + 1, NT_W), dtype=_I32, device=dev)
    nt[:, :, NT_ALPHA] = -INF
    nt[:, :, NT_ALPHA0] = -INF
    nt[:, :, NT_BETA] = INF
    nt[:, :, NT_BEST] = -INF
    nt[:, :, NT_BMOVE] = -1
    nt[:, :, NT_K0] = -1
    nt[:, :, NT_K1] = -1
    nt[:, 0, NT_DL] = depth

    lane = torch.zeros((B, LN_W), dtype=_I32, device=dev)
    lane[:, LN_DLIM] = depth
    lane[:, LN_BUDGET] = budget
    lane[:, LN_RSCORE] = -INF
    lane[:, LN_RMOVE] = -1
    lane[:, LN_RALPHA] = alpha
    lane[:, LN_RBETA] = beta
    lane[:, LN_JITTER] = jitter
    lane[:, LN_GROUP] = group
    return SearchState(
        bt=bt, nt=nt, lane=lane, hist_hash=hist_hash.clone(),
        hist_halfmove=hist_halfmove.clone(), moves=full((B, P, max_moves), -1),
        hist=_jitter_history(jitter), pv=full((B, P, P), -1), acc=acc,
    )


def _jitter_history(order_jitter: torch.Tensor) -> torch.Tensor:
    """(B, HIST_SIZE) int32 initial history counters: zeros for lanes with
    jitter 0, and for jitter j != 0 the reference's mix (j * 2654435761
    ^ idx * 2246822519, then ^ >> 15, then & 255) in uint32 arithmetic,
    done in int64 and masked so torch's signed int32 does not change the
    bits."""
    m32 = 0xFFFFFFFF
    j = order_jitter.to(torch.int64)[:, None] & m32
    # j * 2654435761 mod 2^32 from two 16-bit halves of the constant, so
    # no product leaves int64
    c = 2654435761
    jm = (j * (c & 0xFFFF) + (((j * (c >> 16)) & 0xFFFF) << 16)) & m32
    idx = torch.arange(HIST_SIZE, dtype=torch.int64, device=order_jitter.device)[None, :]
    mix = jm ^ ((idx * 2246822519) & m32)
    mix = mix ^ (mix >> 15)
    return torch.where(j != 0, mix & 255, 0).to(_I32)


def lane_init_plain(state: SearchState, lane_idx: torch.Tensor, *args) -> None:
    """K7's plain version: the n fresh lanes built whole (_fresh_state),
    then copied into the listed lanes of every table."""
    fresh = _fresh_state(*args, state.bt.shape[1] - 1, state.moves.shape[2])
    for t, f in zip(state, fresh):
        t.index_copy_(0, lane_idx, f)


def lane_init(state: SearchState, lane_idx: torch.Tensor, *args) -> None:
    """K7 wrapper: plain version on the CPU, kernel on the card. args are
    _lane_inputs' (rows, root accumulators, depth, budget, alpha, beta,
    jitter, group, hist_hash, hist_halfmove), one row per listed lane."""
    if state.lane.device.type == "cpu":
        lane_init_plain(state, lane_idx, *args)
    else:
        kernels.lane_init(state, lane_idx, *args)


def _refill_inputs(params, state: SearchState, new_roots: Board, lane_idx, depth,
                   node_budget, hist_hash=None, hist_halfmove=None, root_alpha=None,
                   root_beta=None, order_jitter=None, group=None) -> tuple:
    """refill_lanes' arguments → (lane index (n,) int64, K7's inputs) on
    the state's device; the lane indices must be distinct and in range."""
    dev = state.lane.device
    B = state.lane.shape[0]
    idx = np.asarray(lane_idx, np.int64).reshape(-1)
    if idx.size and (idx.min() < 0 or idx.max() >= B or np.unique(idx).size != idx.size):
        raise ValueError(f"lane indices must be distinct and in [0, {B}): {idx.tolist()}")
    if not idx.size:
        return None, None
    rows = [None if x is None else _to_dev(x, dev) for x in (
        depth, node_budget, hist_hash, hist_halfmove, root_alpha, root_beta, order_jitter,
        group)]
    return torch.from_numpy(idx).to(dev), _lane_inputs(params, new_roots.to(dev), *rows)


def refill_lanes(params: nnue.NnueParams, state: SearchState, new_roots: Board, lane_idx,
                 depth, node_budget, *, hist_hash=None, hist_halfmove=None,
                 root_alpha=None, root_beta=None, order_jitter=None,
                 group=None, variant: str = "standard") -> SearchState:
    """Splice fresh root positions into selected lanes of a running state,
    in place; returns `state`. variant: the state's device variant.

    new_roots: batched Board with n rows; lane_idx: host sequence of n
    distinct lane indices; depth/node_budget (n,) and the optional (n,)
    / (n, ...) per-lane arrays follow init_state (None: its defaults).
    The listed lanes take init_state's values (K1 on the n roots, then
    K7 writes those lanes); every other lane keeps its exact state, so
    live searches are unaffected. The caller refills only DONE lanes and
    gives them fresh TT generations before the next segment."""
    max_moves_for(variant)
    idx, args = _refill_inputs(params, state, new_roots, lane_idx, depth, node_budget,
                               hist_hash, hist_halfmove, root_alpha, root_beta,
                               order_jitter, group)
    if idx is not None:
        lane_init(state, idx, *args)
    return state


def _merge_lanes_plain(params: nnue.NnueParams, state: SearchState, new_roots: Board,
                       lane_idx, depth, node_budget, **kw) -> SearchState:
    """refill_lanes' plain version: init_state's plain build of the n
    roots, then one index_copy_ per field."""
    idx, args = _refill_inputs(params, state, new_roots, lane_idx, depth, node_budget, **kw)
    if idx is not None:
        lane_init_plain(state, idx, *args)
    return state


class _Consts(NamedTuple):
    ks: torch.Tensor  # (P+1,) ply index
    hist_dist: torch.Tensor  # (MAX_HIST,) virtual ply distance of each history slot
    fm_expand: torch.Tensor  # (NT_W,) bool
    fm_enter: torch.Tensor  # (NT_W,) bool
    ntp_cols: torch.Tensor  # RETURN's parent-row fields
    nt1_cols: torch.Tensor  # TRYMOVE's own-row fields
    null_mul: torch.Tensor  # (BT_W,) the null child's row is parent * null_mul
    null_add: torch.Tensor  # + null_add: side flipped, no ep, halfmove and extras 0
    zero: torch.Tensor  # () int32 scalars the leaf store broadcasts
    exact: torch.Tensor
    no_move: torch.Tensor


@lru_cache(maxsize=None)
def _consts(device: torch.device, P1: int, H: int) -> _Consts:
    def t(a, dtype=_I32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return _Consts(
        ks=t(np.arange(P1)),
        hist_dist=t(H - np.arange(H)),
        fm_expand=t(_FM_EXPAND, torch.bool), fm_enter=t(_FM_ENTER, torch.bool),
        ntp_cols=t([NT_BEST, NT_BMOVE, NT_ALPHA, NT_SEARCHED, NT_NULL, NT_PVLEN],
                   torch.int64),
        nt1_cols=t([NT_MIDX, NT_NULL, NT_LASTRED, NT_K0, NT_K1], torch.int64),
        null_mul=t(_NULL_MUL), null_add=t(_NULL_ADD),
        zero=t(0), exact=t(tt_mod.FLAG_EXACT), no_move=t(-1),
    )


@torch.inference_mode()
def _step(params: nnue.NnueParams, s: SearchState, pruning: bool, keys=None,
          tt_hit=None, tt_score=None, tt_move=None, variant: str = "standard") -> None:
    """One state-machine step for every lane, written into `s` in place
    (K11's step, csrc/search.cuh step_lane, in batched PyTorch).

    keys (B, 2) int32: the Zobrist keys of each lane's current ply row,
    when the caller has hashed it already (the TT runner); None hashes
    here. tt_hit (B,) bool / tt_score / tt_move (B,) int32: the TT probe
    of each lane's ENTER node (a usable cutoff, its score, the stored
    move for ordering, -1 for none); None runs without the table.
    variant: the device variant (ops/tables.py VARIANT_ID).

    All reads of the state happen before the writes they could see, and
    the writes land in the reference's order (nt: entered row, parent
    row, TRYMOVE row, child depth), each row under its own mask. On the
    card every tensor operation is a launch, so the step groups
    same-shaped column updates into single operations, and runs in
    inference mode (no autograd bookkeeping per operation)."""
    bt, nt, lane = s.bt, s.nt, s.lane
    B, P1 = bt.shape[0], bt.shape[1]
    P = s.moves.shape[1]
    c = _consts(lane.device, P1, s.hist_halfmove.shape[1])
    ply0 = lane[:, LN_PLY]
    mode0 = lane[:, LN_MODE]
    nodes = lane[:, LN_NODES]
    p0 = ply0.long()
    pp = (p0 - 1).clamp(min=0)  # parent row (<= P - 1, a valid moves row)
    ntr0 = _row(nt, p0)
    ntp0 = _row(nt, pp)
    btr0 = _row(bt, p0)
    btp0 = _row(bt, pp)
    moves_p_row = _row(s.moves, pp)

    # ---------------------------------------------------------- ENTER
    enter = mode0 == MODE_ENTER
    root = ply0 == 0
    b = board_from_rows(btr0)
    us = b.stm
    rays = attacks = None
    if b.board.device.type == "cpu":  # the plain versions share one ray view
        rays = rays_of(b.board)
        attacks = attack_parts(rays)
    illegal_raw, we_are_checked, term = node_rules(b, rays, attacks, variant)  # K8 on the card
    # on bools `a > b` is `a & ~b` in one launch
    parent_illegal = illegal_raw > root
    depth_left = ntr0[:, NT_DL]
    parent_null = (ntp0[:, NT_NULL] == 2) > root
    over_budget = nodes >= lane[:, LN_BUDGET]
    fifty = b.halfmove >= FIFTY_PLIES

    # twofold repetition along the search path and against the pre-root
    # game history, through unbroken reversible-move chains
    h = tt_mod.hash_board(b.board, us, b.ep, b.castling, b.extra, variant) if keys is None else keys
    hm = b.halfmove[:, None]
    same = (bt[:, :, BT_PH1:BT_PH2 + 1] == h[:, None]).all(2)
    repet_path = (same & ((hm - bt[:, :, BT_HM]) == (ply0[:, None] - c.ks))
                  & (c.ks < ply0[:, None])).any(1)
    same = (s.hist_hash == h[:, None]).all(2)
    repet_hist = (same & ((hm - s.hist_halfmove) == (ply0[:, None] + c.hist_dist))).any(1)
    repet = (repet_path | repet_hist) & enter
    entry_alpha = torch.where(root, lane[:, LN_RALPHA], -ntp0[:, NT_BETA])
    entry_beta = torch.where(
        root, lane[:, LN_RBETA],
        torch.where(parent_null, 1 - ntp0[:, NT_BETA], -ntp0[:, NT_ALPHA]),
    )
    in_qs = depth_left <= 0

    # leaf value: on board768 the layer stack from the incremental
    # accumulator (K2), but in atomic a refresh first (K1, K2); any other
    # net pays a full eval (K12, K13)
    if not nnue.is_board768(params):
        ev = nnue.evaluate(params, b.board, us)
    elif variant == "atomic":
        ev = nnue.evaluate(params, b.board.contiguous(), us.contiguous())
    else:
        ev = nnue.forward_from_acc(
            params, _row(s.acc, p0), us.contiguous(), nnue.output_bucket(b.board)
        )
    static_val = ev.to(_I32).clamp(-MATE_BOUND, MATE_BOUND)
    draw = fifty | repet
    # a variant's game end (never one in standard chess) ends the node at
    # once, over the draws: a loss or win in ply plies, or a draw; never
    # stored in the table
    vterm = term != TERM_NONE
    ends = draw | vterm
    leaf_val = torch.where(vterm, torch.where(
        term == TERM_LOSS, ply0 - MATE, torch.where(term == TERM_WIN, MATE - ply0, DRAW)),
        torch.where(draw, DRAW, static_val))

    gen_moves, gen_count, gen_noisy = generate_moves(  # K9 on the card
        b, killers=ntr0[:, NT_K0:NT_K1 + 1], hist=s.hist, rays=rays, attacks=attacks,
        variant=variant,
    )
    quiet_node = gen_noisy == 0
    window_ok_a = (entry_alpha > -MATE_BOUND) & (entry_alpha < MATE_BOUND)
    if pruning:  # futility at frontier nodes
        f_margin = torch.where(depth_left == 1, FUTILITY_MARGIN_1, FUTILITY_MARGIN_2)
        futile = (
            ((depth_left <= FUTILITY_DEPTH) > (in_qs | we_are_checked | root))
            & (static_val + f_margin <= entry_alpha) & window_ok_a
        )
        qs_like = in_qs | futile
    else:
        qs_like = in_qs
    is_leaf = (
        ends | over_budget | (ply0 >= P) | (qs_like & quiet_node)
        | (in_qs & (leaf_val >= entry_beta))  # stand-pat cut
    )
    # TT cutoff: a leaf return with the stored score; never at the root
    # (it must produce a move), never on a fifty-move or repetition draw
    # (the key excludes the halfmove clock and the path) or at a variant's
    # game end
    if tt_hit is not None:
        use_tt = tt_hit > (root | ends)
        to_return = parent_illegal | is_leaf | use_tt
        no_store = parent_illegal | ends | use_tt
    else:
        to_return = parent_illegal | is_leaf
        no_store = parent_illegal | ends
    expand = enter > to_return
    # quiet static leaves, for the runner's depth-0 EXACT store
    leaf_store = ((enter & is_leaf) > no_store) & quiet_node
    store_val = torch.where(leaf_store, leaf_val, 0)

    # the stored move to the front of the list (not in quiescence, where
    # the swap could pull a quiet move into the noisy prefix)
    if tt_move is not None:
        hit = gen_moves == tt_move[:, None]
        tm_at = hit.to(torch.uint8).argmax(1, keepdim=True)
        present = (hit.gather(1, tm_at)[:, 0] & (tt_move >= 0)) > qs_like
        m0 = gen_moves[:, :1]
        gen_moves = gen_moves.scatter(
            1, tm_at, torch.where(present[:, None], m0, gen_moves.gather(1, tm_at)))
        gen_moves[:, :1] = torch.where(present[:, None], tt_move[:, None], gen_moves[:, :1])

    if pruning and variant != "antichess":  # null-move eligibility (captures are forced there)
        us_base = (us * 6)[:, None]
        nonpawn = ((b.board >= us_base + 2) & (b.board <= us_base + 5)).any(1)
        null_v = (
            ((depth_left >= NULL_MIN_DEPTH) > (we_are_checked | parent_null | root))
            & (static_val >= entry_beta) & (entry_beta < MATE_BOUND)
            & (entry_beta > -MATE_BOUND) & nonpawn
        ).to(_I32)
    else:
        null_v = torch.zeros_like(ply0)

    zero = torch.zeros_like(ply0)
    nv = torch.stack([
        torch.where(qs_like, gen_noisy, gen_count),  # NT_COUNT
        zero,  # NT_MIDX
        zero,  # NT_SEARCHED
        torch.where(qs_like, torch.maximum(entry_alpha, leaf_val), entry_alpha),
        entry_alpha,  # NT_ALPHA0
        entry_beta,  # NT_BETA
        torch.where(qs_like, leaf_val, -INF),  # NT_BEST
        zero - 1,  # NT_BMOVE
        null_v,  # NT_NULL
        zero,  # NT_LASTRED
        zero,  # NT_PVLEN
        depth_left,
        we_are_checked.to(_I32),  # NT_INCHECK
        ntr0[:, NT_K0],
        ntr0[:, NT_K1],
        zero,
    ], 1)
    sel = (c.fm_expand & expand[:, None]) | (c.fm_enter & enter[:, None])
    ntE = torch.where(sel, nv, ntr0)
    _set_row(nt, p0, ntE, enter)
    btE = torch.cat([btr0[:, :BT_PH1], h, btr0[:, BT_PH2 + 1:]], 1)
    _set_row(bt, p0, btE, enter)
    _set_row(s.moves, p0.clamp(max=P - 1), gen_moves, expand)

    ret_now = enter & to_return
    if tt_hit is not None:  # a TT-sourced value is already stored: depth -1
        value = torch.where(use_tt, tt_score, leaf_val)
        value_depth = -use_tt.to(_I32)
    else:
        value, value_depth = leaf_val, 0
    ret = torch.where(ret_now, torch.where(parent_illegal, ILLEGAL, value), lane[:, LN_RET])
    ret_depth = torch.where(ret_now, value_depth, lane[:, LN_RETD])
    nodes = nodes + (enter > parent_illegal).to(_I32)
    mode = torch.where(ret_now, MODE_RETURN, torch.where(expand, MODE_TRYMOVE, mode0))

    # --------------------------------------------------------- RETURN
    ret_m = mode == MODE_RETURN
    fold = ret_m > root
    v = -ret
    tried = moves_p_row.gather(1, (ntp0[:, NT_MIDX:NT_MIDX + 1] - 1).clamp(min=0).long())[:, 0]
    is_null_ret = fold & (ntp0[:, NT_NULL] == 2)
    legal_fold = fold & (ret != ILLEGAL)
    null_cut = is_null_ret & legal_fold & (v >= ntp0[:, NT_BETA]) & (v < MATE_BOUND)
    real_fold = legal_fold > is_null_ret
    need_rs = real_fold & (ntp0[:, NT_LASTRED] > 0) & (v > ntp0[:, NT_ALPHA])
    counted = real_fold > need_rs
    better = counted & (v > ntp0[:, NT_BEST])
    best_p = torch.where(better | null_cut, v, ntp0[:, NT_BEST])
    # parent fields [BEST, BMOVE, ALPHA, SEARCHED, NULL, PVLEN] (pv_len of
    # the child is its post-ENTER value)
    old = ntp0[:, c.ntp_cols]
    upd = torch.stack([
        best_p, tried, torch.maximum(ntp0[:, NT_ALPHA], best_p),
        ntp0[:, NT_SEARCHED] + 1, zero,
        (ntE[:, NT_PVLEN] + 1).clamp(max=s.pv.shape[-1]),
    ], 1)
    cond = torch.stack([better | null_cut, better, fold, counted, is_null_ret, better], 1)
    ntP = ntp0.index_copy(1, c.ntp_cols, torch.where(cond, upd, old))
    _set_row(nt, pp, ntP, fold)

    # pv[parent] = tried + pv[ply]; a ply past the PV table's last row
    # reads the last row (the reference's clamped dynamic index)
    child_pv = _row(s.pv, p0.clamp(max=s.pv.shape[1] - 1))
    _set_row(s.pv, pp, torch.cat([tried[:, None], child_pv[:, :-1]], 1), better)
    research = torch.where(ret_m, need_rs, lane[:, LN_RESEARCH] != 0)
    root_ret = ret_m & root
    root_score = torch.where(root_ret, ret, lane[:, LN_RSCORE])
    root_move = torch.where(root_ret, ntp0[:, NT_BMOVE], lane[:, LN_RMOVE])
    ply1 = torch.where(fold, ply0 - 1, ply0)
    mode = torch.where(root_ret, MODE_DONE, torch.where(fold, MODE_TRYMOVE, mode))

    # -------------------------------------------------------- TRYMOVE
    try_m = mode == MODE_TRYMOVE
    ex = expand[:, None]
    nt1 = torch.where(ex, ntE, ntP)
    moves_row1 = torch.where(ex, gen_moves, moves_p_row)
    bt1 = torch.where(ex, btE, btp0)
    parent_board = bt1[:, BT_BOARD:BT_BOARD + 64]
    midx = nt1[:, NT_MIDX]
    exhausted = midx >= nt1[:, NT_COUNT]
    cutoff = nt1[:, NT_ALPHA] >= nt1[:, NT_BETA]
    re_push = try_m & research
    do_null = (try_m > (re_push | cutoff)) & (nt1[:, NT_NULL] == 1)
    finish = (try_m > (do_null | re_push)) & (exhausted | cutoff)
    advance = try_m > finish
    normal_adv = advance > (re_push | do_null)
    dl_node = nt1[:, NT_DL]

    # killer/history credit on fail-high by a quiet move
    cause = nt1[:, NT_BMOVE]
    k_upd = try_m & cutoff & (cause >= 0) & _is_quiet(cause.clamp(min=0), parent_board)
    k_new = k_upd & (cause != nt1[:, NT_K0])
    h_idx = (cause.clamp(min=0) & 4095).long()
    dl = dl_node.clamp(min=0)
    hist_old = s.hist.gather(1, h_idx[:, None])[:, 0]
    _set_row(s.hist, h_idx,
             (hist_old + (dl * dl + 1).clamp(max=HIST_BONUS_MAX)).clamp(max=HIST_MAX), k_upd)

    # finished node value: best, or mate/stalemate when no legal child
    node_in_qs = dl_node <= 0
    no_legal = ((nt1[:, NT_SEARCHED] == 0) > node_in_qs) & (nt1[:, NT_BEST] == -INF)
    if variant == "antichess":  # the side left without a move wins
        mate_val = MATE - ply1
    else:
        mate_val = torch.where(nt1[:, NT_INCHECK] != 0, ply1 - MATE, DRAW)
    fin_val = torch.where(no_legal & exhausted, mate_val, nt1[:, NT_BEST])

    m_ix = torch.where(re_push, midx - 1, midx).clamp(0, moves_row1.shape[1] - 1)
    move = moves_row1.gather(1, m_ix.long()[:, None])[:, 0].clamp(min=0)
    child, codes, sqs, signs = make_move_rows(bt1, move, variant)  # K10 on the card
    if pruning:
        # late-move reduction; the null child is the same position with
        # the opponent to move, no ep square and a reset halfmove clock
        lmr_ok = (
            (dl_node >= LMR_MIN_DEPTH) & (midx >= LMR_MIN_MOVE) & (nt1[:, NT_INCHECK] == 0)
            & _is_quiet(move, parent_board)
        )
        red = torch.where(lmr_ok > (re_push | do_null),
                          torch.where(midx >= LMR_DEEP_MOVE, 2, 1), 0)
        dn = do_null[:, None]
        child = torch.where(dn, bt1 * c.null_mul + c.null_add, child)
        null_r = NULL_R + (dl_node >= NULL_DEEP_DEPTH).to(_I32)
        child_dl = (dl_node - 1 - torch.where(do_null, null_r, red)).clamp(min=0)
        # a null move changes no pieces: zeroed slots are no-ops
        codes = torch.where(dn, 0, codes)
        signs = torch.where(dn, 0, signs)
    else:
        red = torch.zeros_like(dl_node)
        child_dl = (dl_node - 1).clamp(min=0)
    nply = (ply1 + 1).clamp(max=P1 - 1)
    p1, pn = ply1.long(), nply.long()

    # own-row fields [MIDX, NULL, LASTRED, K0, K1]
    upd = torch.stack([
        midx + 1, torch.full_like(midx, 2), red,
        cause, nt1[:, NT_K0],
    ], 1).to(_I32)
    cond = torch.stack([normal_adv, do_null, advance, k_new, k_new], 1)
    nt1w = nt1.index_copy(1, c.nt1_cols, torch.where(cond, upd, nt1[:, c.nt1_cols]))
    _set_row(nt, p1, nt1w, try_m)
    _set_row(nt.view(B, -1), pn * NT_W + NT_DL, child_dl.to(_I32), advance)
    research = research > try_m

    _set_row(bt, pn, child, advance)
    if nnue.is_board768(params) and variant != "atomic":  # the others keep no accumulators
        child_acc = nnue.apply_acc_updates_768(params, _row(s.acc, p1), codes, sqs, signs)
        _set_row(s.acc, pn, child_acc, advance)

    fin = try_m & finish
    ret = torch.where(fin, fin_val, ret)
    ret_depth = torch.where(fin, dl_node, ret_depth)
    mode = torch.where(fin, MODE_RETURN, torch.where(advance, MODE_ENTER, mode))
    ply_f = torch.where(advance, nply, ply1)

    lane.copy_(torch.stack([
        ply_f, mode, ret, ret_depth, leaf_store, store_val, nodes,
        lane[:, LN_DLIM], lane[:, LN_BUDGET], root_score, root_move,
        lane[:, LN_RALPHA], lane[:, LN_RBETA], research,
        lane[:, LN_JITTER], lane[:, LN_GROUP],
    ], 1))


@torch.inference_mode()
def _tt_step(params: nnue.NnueParams, s: SearchState, pruning: bool,
             table: torch.Tensor, deep_tt: bool, prefer_deep: bool, gen,
             variant: str = "standard") -> None:
    """One step under the reference's TT runner (its _run_segment body;
    K11's two table phases a step, csrc/search_segment.cu, in batched
    PyTorch):
    hash each lane's ply row once; store the lanes parked in RETURN with
    the node's finished value; probe the lanes about to ENTER with the
    window ENTER will give them; step; store the leaves the step marked
    as depth-0 EXACT under the pre-step keys. Stores from one lane are
    visible to every lane's probe in the same step."""
    lane = s.lane
    ply = lane[:, LN_PLY].long()
    keys = tt_mod.hash_boards(board_from_rows(_row(s.bt, ply)), variant)
    h1, h2 = keys[:, 0], keys[:, 1]
    mode, ret, ret_depth = lane[:, LN_MODE], lane[:, LN_RET], lane[:, LN_RETD]

    # lanes whose interior node just finished (a TT-sourced value has
    # depth -1; past the budget, subtrees are degraded and not stored)
    store_mask = ((mode == MODE_RETURN) & (ret != ILLEGAL) & (ret_depth >= 1)
                  & (lane[:, LN_NODES] < lane[:, LN_BUDGET]))
    ntrow = _row(s.nt, ply)
    flag = torch.where(ret >= ntrow[:, NT_BETA], tt_mod.FLAG_LOWER,
                       torch.where(ret <= ntrow[:, NT_ALPHA0], tt_mod.FLAG_UPPER,
                                   tt_mod.FLAG_EXACT)).to(_I32)
    tt_mod.store(table, h1, h2, ret, ret_depth.clamp(min=0), flag, ntrow[:, NT_BMOVE],
                 store_mask, prefer_deep=prefer_deep, gen=gen)

    # lanes about to enter a node, probed with the window ENTER gives the
    # node (the zero-width null window for a null child)
    enter = mode == MODE_ENTER
    root = ply == 0
    ntprow = _row(s.nt, (ply - 1).clamp(min=0))
    pnull = (ntprow[:, NT_NULL] == 2) > root
    alpha = torch.where(root, lane[:, LN_RALPHA], -ntprow[:, NT_BETA])
    beta = torch.where(root, lane[:, LN_RBETA],
                       torch.where(pnull, 1 - ntprow[:, NT_BETA], -ntprow[:, NT_ALPHA]))
    usable, score, order_mv = tt_mod.probe(table, h1, h2, ntrow[:, NT_DL], alpha, beta,
                                           enter, deep_bounds=deep_tt)
    _step(params, s, pruning, keys, usable, score, order_mv, variant)

    # the leaves the step evaluated: their position is the pre-step one
    c = _consts(lane.device, s.bt.shape[1], s.hist_halfmove.shape[1])
    B = h1.shape[0]
    tt_mod.store(table, h1, h2, lane[:, LN_SVAL], c.zero.expand(B), c.exact.expand(B),
                 c.no_move.expand(B), lane[:, LN_SMARK] != 0, prefer_deep=prefer_deep,
                 gen=gen)


def run_segment(params: nnue.NnueParams, state: SearchState,
                segment_steps: int, pruning: bool | None = None, table=None,
                deep_tt: bool = False, prefer_deep: bool = False, tt_gen=0,
                variant: str = "standard", out=None):
    """Advance all lanes <= segment_steps steps, stopping once every lane
    is DONE. → (steps, summary): steps counts the steps in which any lane
    was live (the reference's while-loop count); summary is the packed
    (B+1, 4) int32 boundary summary (done, nodes, root score, root move;
    row B carries the step count), written into `out` when it is given
    (a contiguous (B+1, 4) int32 tensor on the state's device: a shard's
    rows of parallel/mesh.py's stacked summary).

    table: the shared (n, 4) TT, updated in place, or None. deep_tt: the
    probe also cuts on deeper bounds (ops/tt.py probe deep_bounds).
    prefer_deep + tt_gen (an int or a (B,) int32 tensor): the
    depth-preferred, generation-aware store of helper-lane dispatches
    (ops/tt.py store). variant: the device variant (K11 has one
    instantiation per variant and net kind).

    On the card the segment is one launch of K11 (kernels.search_segment)
    and one host read of the step count; a CPU state runs the plain
    version, run_segment_plain. A segment that starts with every lane
    DONE runs no step, as the reference's loop does not."""
    if pruning is None:
        pruning = not settings.get_bool("FISHNET_TPU_NO_PRUNING")
    if state.lane.device.type == "cpu":
        return run_segment_plain(params, state, segment_steps, pruning, table, deep_tt,
                                 prefer_deep, tt_gen, variant, out)
    summary = kernels.search_segment(params, state, segment_steps, pruning, table, deep_tt,
                                     prefer_deep, tt_gen, variant, out=out)
    return int(summary[-1, SUM_DONE]), summary


def run_segment_plain(params: nnue.NnueParams, state: SearchState, segment_steps: int,
                      pruning: bool, table=None, deep_tt: bool = False,
                      prefer_deep: bool = False, tt_gen=0, variant: str = "standard",
                      out=None):
    """K11's plain version: the reference's while loop (a step while any
    lane is live, at most segment_steps) over `_step`, or `_tt_step` with
    a table, then the packed summary; the same arguments and results as
    run_segment. The host reads the live test after every step."""
    lane = state.lane
    n = 0
    while n < segment_steps and bool((lane[:, LN_MODE] != MODE_DONE).any()):
        if table is None:
            _step(params, state, pruning, variant=variant)
        else:
            _tt_step(params, state, pruning, table, deep_tt, prefer_deep, tt_gen, variant)
        n += 1
    summary = torch.cat([
        torch.stack([
            (lane[:, LN_MODE] == MODE_DONE).to(_I32), lane[:, LN_NODES],
            lane[:, LN_RSCORE], lane[:, LN_RMOVE],
        ], 1),
        torch.full((1, SUM_W), n, dtype=_I32, device=lane.device),
    ])
    if out is not None:
        out.copy_(summary)
        summary = out
    return n, summary


def extract_results(state: SearchState, steps: int) -> dict:
    return {
        "score": state.lane[:, LN_RSCORE],
        "move": state.lane[:, LN_RMOVE],
        "pv": state.pv[:, 0],
        "pv_len": state.nt[:, 0, NT_PVLEN],
        "nodes": state.lane[:, LN_NODES],
        "done": state.lane[:, LN_MODE] == MODE_DONE,
        "steps": steps,
    }


def _lanes(x, B: int, dev, dtype=_I32):
    """A scalar or (B,) array-like → (B,) tensor on dev."""
    t = torch.as_tensor(np.asarray(x), dtype=dtype) if not torch.is_tensor(x) else x
    return t.to(device=dev, dtype=dtype).expand(B).contiguous()


def search_batch_resumable(
    params: nnue.NnueParams,
    roots: Board,
    depth,
    node_budget,
    max_ply: int,
    segment_steps: int | None = None,
    max_steps: int = 4_000_000,
    deadline: float | None = None,
    tt=None,
    hist=None,
    window=None,
    deep_tt: bool = False,
    narrow: bool = True,
    order_jitter=None,
    group=None,
    required=None,
    prefer_deep_store: bool = False,
    tt_gen: int = 0,
    device=None,
    variant: str = "standard",
    mesh=None,
) -> dict:
    """Search B roots in lockstep, dispatched in bounded segments, under
    the device variant `variant`.

    Runs on `device` (default: the card; the params and roots are moved
    there), or with `mesh` (parallel/mesh.py) sharded over its devices: B
    must divide over them, params may be one net a shard (replicate), the
    state is built on `device` (default the mesh's first) and split, each
    shard advances on its own (one K11 a shard and segment) and a
    segment's step count is the largest shard's; tt is then None or one
    table a shard (make_sharded_table), and nothing narrows (shards keep
    their width). depth/node_budget: scalars or (B,). hist: optional
    (hist_hash (B, MAX_HIST, 2), hist_halfmove (B, MAX_HIST)) game tails;
    window: optional (root_alpha (B,), root_beta (B,)) aspiration window —
    a root whose value falls outside reports the bound.

    tt: optional shared table (ops/tt.py make_table) on `device`; the
    search updates it in place and returns it as out["tt"], so callers
    carry it across searches. deep_tt: probes also cut on deeper bounds.
    prefer_deep_store + tt_gen: the helper dispatches' store policy
    (ops/tt.py store).

    order_jitter/group (B,): Lazy-SMP lane-group metadata (init_state).
    required (B,) bool: the lanes the caller needs (helper groups'
    primaries). Once every required lane is DONE at a segment boundary,
    the search stops and abandons the rest mid-flight; None requires
    every lane.

    deadline: absolute time.monotonic() stamp checked between segments;
    lanes not DONE at the stop report done=False.

    narrow: at segment boundaries, retire DONE lanes and continue the
    live ones at a smaller power-of-two width (floor
    FISHNET_TPU_NARROW_FLOOR). Narrowing relocates lanes and never
    changes any lane's search; it keeps the live lanes' relative order,
    so colliding TT stores keep the same winners.

    Returns numpy arrays keyed score, move, pv (B, P), pv_len, nodes,
    done, the int step count "steps", and "tt" (the table, or None)."""
    dev = device_mod.resolve(device if device is not None or mesh is None else mesh[0])
    if segment_steps is None:
        segment_steps = settings.get_segment()
        if segment_steps is None:
            segment_steps = settings.get_int("FISHNET_TPU_SEGMENT_MAX")
    narrow_floor = settings.get_int("FISHNET_TPU_NARROW_FLOOR")
    pruning = not settings.get_bool("FISHNET_TPU_NO_PRUNING")
    # under a mesh params may be one net a shard (parallel/mesh.py
    # replicate), so a caller that keeps them pays no copy a dispatch
    nets = params if isinstance(params, list) else None
    params = (params[0] if nets else params).to(dev)
    roots = roots.to(dev)
    B = roots.board.shape[0]
    hist_hash, hist_halfmove = (None, None) if hist is None else (
        _to_dev(hist[0], dev), _to_dev(hist[1], dev))
    root_alpha, root_beta = (None, None) if window is None else (
        _lanes(window[0], B, dev), _lanes(window[1], B, dev))
    state = init_state(
        params, roots, _lanes(depth, B, dev), _lanes(node_budget, B, dev),
        max_ply, hist_hash=hist_hash, hist_halfmove=hist_halfmove,
        root_alpha=root_alpha, root_beta=root_beta,
        order_jitter=None if order_jitter is None else _lanes(order_jitter, B, dev),
        group=None if group is None else _lanes(group, B, dev), variant=variant,
    )
    shards = None
    if mesh is not None:
        from ..parallel import mesh as mesh_mod

        mesh = mesh_mod.make_mesh(mesh)
        shards = mesh_mod.shard_batch(mesh, state)
        nets = nets or mesh_mod.replicate(mesh, params)
        _check_tables(tt, mesh)
    elif tt is not None and tt.device != roots.board.device:
        raise ValueError(f"the table is on {tt.device}, the search on {roots.board.device}")
    req = None if required is None else np.asarray(required, bool).copy()

    # retired-lane results (original lane order); `orig` maps state rows
    # to original lanes, `valid` marks rows that still own their lane
    flushed: dict | None = None
    orig = np.arange(B)
    valid = np.ones(B, bool)

    def _flush(res: dict, mask: np.ndarray) -> None:
        nonlocal flushed
        res = {k: v.cpu().numpy() for k, v in res.items() if k != "steps"}
        if flushed is None:
            flushed = {k: np.zeros((B,) + v.shape[1:], v.dtype) for k, v in res.items()}
        for k, buf in flushed.items():
            buf[orig[mask]] = res[k][mask]

    total = 0
    while total < max_steps:
        if deadline is not None and _time.monotonic() >= deadline:
            break
        if mesh is None:
            n, summary = run_segment(params, state, segment_steps, pruning, tt, deep_tt,
                                     prefer_deep_store, tt_gen, variant)
        else:  # shards stop on their own: go on while any used the whole segment
            shard_steps, stacked = mesh_mod.run_segment_sharded(
                mesh, nets, shards, tt, segment_steps, pruning, deep_tt, prefer_deep_store,
                tt_gen, variant)
            n = max(shard_steps)
        total += n
        if n < segment_steps:
            break  # every lane parked in DONE
        cur = state.lane.shape[0]
        if mesh is None:
            done = summary[:cur, SUM_DONE].cpu().numpy() != 0
        else:
            done = stacked[:, :-1, SUM_DONE].reshape(-1) != 0
        if req is not None and not np.any(req & valid & ~done):
            break  # every required lane finished: abandon the helpers
        if deadline is not None and _time.monotonic() >= deadline:
            break
        if narrow and mesh is None and cur > narrow_floor:
            live = int((~done & valid).sum())
            new_b = narrow_floor
            while new_b < live:
                new_b *= 2
            if new_b < cur:
                _flush(extract_results(state, total), done & valid)
                keep = np.nonzero(~done & valid)[0]
                pad = np.nonzero(done)[0][: new_b - len(keep)]
                order = np.concatenate([keep, pad])
                idx = torch.as_tensor(order, device=dev)
                state = SearchState(*[t[idx].contiguous() for t in state])
                orig = orig[order]
                if req is not None:
                    req = req[order]
                valid = np.concatenate(
                    [np.ones(len(keep), bool), np.zeros(len(pad), bool)]
                )

    res = [extract_results(st, total) for st in (shards or [state])]
    out = {k: fetch_lanes([r[k] for r in res]) for k in res[0] if k != "steps"}
    if flushed is not None:
        for k, buf in flushed.items():
            buf[orig[valid]] = out[k][valid]
        out = flushed
    out["steps"] = total
    out["tt"] = tt
    return out


def search_stream(
    params: nnue.NnueParams,
    roots: Board,
    depth,
    node_budget,
    max_ply: int,
    width: int,
    segment_steps: int | None = None,
    max_steps: int = 50_000_000,
    deadline: float | None = None,
    tt=None,
    mesh=None,
    hist=None,
    prefer_deep_store: bool = False,
    tt_gen_start: int = 1,
    pipeline: bool | None = None,
    sync_stats=None,
    device=None,
    variant: str = "standard",
) -> dict:
    """Stream N root positions through a fixed `width`-lane search, under
    the device variant `variant`.

    The occupancy-driven counterpart of `search_batch_resumable`: instead
    of narrowing as lanes finish, the host refills DONE lanes with queued
    positions at every segment boundary (refill_lanes), keeping the width
    until the queue drains. Positions 0..width-1 start in lanes
    0..width-1 (surplus lanes start with budget 0 and park in DONE within
    two steps); each admission gets the next TT generation from
    tt_gen_start, carried per lane into the table's stores
    (prefer_deep_store: the helpers' depth-preferred store). hist:
    optional (hist_hash (N, MAX_HIST, 2), hist_halfmove (N, MAX_HIST)).

    pipeline (default FISHNET_TPU_PIPELINE): the boundary reads one packed
    summary and, when no refill is pending, dispatches the next segment
    before processing the boundary, as the reference does; False is the
    synchronous loop that reads the full result set. Both give the same
    results. In this package a segment runs to its end before its call
    returns, so the pipelined loop makes the reference's decisions
    without overlapping host and device. sync_stats: optional
    syncstats.SyncStats to count transfers into. segment_steps None reads
    FISHNET_TPU_SEGMENT; "auto" runs the SegmentController.

    mesh (parallel/mesh.py): the lanes shard over its devices (width must
    divide over them; the state is built on `device`, default the mesh's
    first, and split), each shard advances and is refilled on its own
    (run_segment_sharded, refill_lanes_sharded), a boundary's step count
    is the largest shard's, and its summary comes back stacked in one read
    a distinct device. tt is then None or one table a shard
    (make_sharded_table), and each occupancy row gains shard_live,
    shard_refilled and shard_steps lists (one entry a shard).

    Returns per-position (N,) numpy results keyed as extract_results,
    the int step count "steps", "tt", and:
      occupancy: per-segment dicts {segment, steps, live, idle, refilled,
                 queue, transfers, elements, host_ms, device_ms};
      refills:   the number of lanes spliced across the run.
    Positions not finished by deadline/max_steps report done=False."""
    dev = device_mod.resolve(device if device is not None or mesh is None else mesh[0])
    if pipeline is None:
        pipeline = settings.get_bool("FISHNET_TPU_PIPELINE")
    stats = sync_stats if sync_stats is not None else SyncStats()
    ctrl = None
    if segment_steps is None:
        segment_steps = settings.get_segment()
        if segment_steps is None:  # FISHNET_TPU_SEGMENT=auto
            ctrl = SegmentController(settings.get_int("FISHNET_TPU_SEGMENT_MIN"),
                                     settings.get_int("FISHNET_TPU_SEGMENT_MAX"))
            segment_steps = ctrl.steps
    pruning = not settings.get_bool("FISHNET_TPU_NO_PRUNING")
    params = params.to(dev)
    roots = roots.to(dev)
    ndev = local = 1
    if mesh is not None:
        from ..parallel import mesh as mesh_mod

        mesh = mesh_mod.make_mesh(mesh)
        ndev = len(mesh)
        if width % ndev:
            raise ValueError(f"stream width {width} must divide over {ndev} devices")
        local = width // ndev
        _check_tables(tt, mesh)
    elif tt is not None and tt.device != roots.board.device:
        raise ValueError(f"the table is on {tt.device}, the search on {roots.board.device}")
    N = int(roots.board.shape[0])
    P = max_ply
    depth = np.broadcast_to(np.asarray(depth, np.int32), (N,)).copy()
    node_budget = np.broadcast_to(np.asarray(node_budget, np.int32), (N,)).copy()
    hist_hash, hist_halfmove = hist if hist is not None else (None, None)
    if hist_hash is not None:
        hist_hash = np.asarray(hist_hash)
        hist_halfmove = np.asarray(hist_halfmove)

    def gather_roots(pos_idx) -> Board:
        ix = torch.as_tensor(np.asarray(pos_idx, np.int64), device=dev)
        return Board(*[t[ix] for t in roots])

    def hist_rows(pos_idx):
        if hist_hash is None:
            return None, None
        return hist_hash[pos_idx], hist_halfmove[pos_idx]

    # initial admission: positions 0..k-1 into lanes 0..k-1; surplus
    # lanes start with budget 0 so they park in DONE within two steps
    lane_pos = np.full(width, -1, np.int64)
    k = min(width, N)
    lane_pos[:k] = np.arange(k)
    queue = list(range(k, N))
    take0 = np.where(lane_pos >= 0, lane_pos, 0)
    assigned0 = lane_pos >= 0
    hh0, hm0 = hist_rows(take0)
    state = init_state(
        params, gather_roots(take0),
        _to_dev(np.where(assigned0, depth[take0], 0), dev),
        _to_dev(np.where(assigned0, node_budget[take0], 0), dev), max_ply,
        hist_hash=None if hh0 is None else _to_dev(hh0, dev),
        hist_halfmove=None if hm0 is None else _to_dev(hm0, dev), variant=variant,
    )
    shards = None
    if mesh is not None:
        shards = mesh_mod.shard_batch(mesh, state)
        nets = mesh_mod.replicate(mesh, params)
    gen = np.zeros(width, np.int32)
    next_gen = int(tt_gen_start)
    gen[assigned0] = np.arange(next_gen, next_gen + k, dtype=np.int32)
    next_gen += k

    out = {
        "score": np.zeros(N, np.int32),
        "move": np.full(N, -1, np.int32),
        "pv": np.full((N, P), -1, np.int32),
        "pv_len": np.zeros(N, np.int32),
        "nodes": np.zeros(N, np.int32),
    }
    done_out = np.zeros(N, bool)
    occupancy: list[dict] = []
    refills_total = 0
    total = 0
    seg_i = 0

    def dispatch(seg_n):
        """One segment over the state and the table, in place, with each
        lane's current generation → (steps, packed summary); under a mesh
        (steps of each shard, stacked host summary)."""
        if mesh is not None:
            return stats.device_call(mesh_mod.run_segment_sharded, mesh, nets, shards, tt,
                                     seg_n, pruning, False, prefer_deep_store, gen.copy(),
                                     variant)
        return stats.device_call(run_segment, params, state, seg_n, pruning, tt, False,
                                 prefer_deep_store, torch.from_numpy(gen.copy()).to(dev),
                                 variant)

    states = shards or [state]

    def shard_row(free, n_ref, shard_steps):
        """The per-shard occupancy columns (mesh runs only): live lanes,
        lanes spliced this boundary, step counts. lane_pos is read before
        the splice (do_refill changes it), so `free` carries the
        boundary's free lanes."""
        if mesh is None:
            return {}
        busy = lane_pos >= 0
        busy[free] = False
        sel = np.asarray(free[:n_ref], np.int64)
        return {
            "shard_live": [int(busy[s * local:(s + 1) * local].sum()) for s in range(ndev)],
            "shard_refilled": np.bincount(sel // local, minlength=ndev).astype(int).tolist(),
            "shard_steps": shard_steps,
        }

    def do_refill(free, n_ref):
        nonlocal next_gen, refills_total
        take_pos = np.asarray(queue[:n_ref], np.int64)
        del queue[:n_ref]
        sel = free[:n_ref]
        lane_pos[sel] = take_pos
        gen[sel] = (np.arange(next_gen, next_gen + n_ref) & 0x3FFFFFFF).astype(np.int32)
        next_gen += n_ref
        hh, hm = hist_rows(take_pos)
        refills_total += n_ref
        if mesh is not None:
            mesh_mod.refill_lanes_sharded(mesh, nets, shards, gather_roots(take_pos), sel,
                                          depth[take_pos], node_budget[take_pos], hist_hash=hh,
                                          hist_halfmove=hm, variant=variant)
            return
        refill_lanes(params, state, gather_roots(take_pos), sel, depth[take_pos],
                     node_budget[take_pos], hist_hash=hh, hist_halfmove=hm, variant=variant)

    def pull_pv(lanes, pos):
        """PV rows of finished lanes only: two small gathers."""
        out["pv"][pos] = fetch_rows(states, lanes, lambda st: st.pv[:, 0], stats, "pv")
        out["pv_len"][pos] = fetch_rows(states, lanes, lambda st: st.nt[:, 0, NT_PVLEN], stats,
                                        "pv_len")

    def record(n, live, n_ref, pend_steps, shard=None):
        nonlocal seg_i, segment_steps
        seg_i += 1
        snap = stats.boundary()
        occupancy.append({
            "segment": seg_i, "steps": int(n), "live": live, "refilled": int(n_ref),
            "idle": width - live - int(n_ref), "queue": len(queue), **snap, **(shard or {}),
        })
        if ctrl is not None:
            segment_steps = ctrl.update(int(n) >= pend_steps, snap["host_ms"],
                                        snap["device_ms"])

    if not pipeline:
        # synchronous loop: run the segment, read the full result set,
        # refill, repeat
        while total < max_steps:
            if deadline is not None and _time.monotonic() >= deadline:
                break
            n, shard_steps = boundary_steps(dispatch(segment_steps), width, stats, mesh)
            pend_steps = segment_steps
            total += n
            lane_done = fetch_lanes([st.lane[:, LN_MODE] == MODE_DONE for st in states], stats,
                                    "done")
            res = [extract_results(st, total) for st in states]
            fin = np.nonzero(lane_done & (lane_pos >= 0))[0]
            if fin.size:
                for key in out:
                    out[key][lane_pos[fin]] = fetch_lanes([r[key] for r in res], stats, key)[fin]
                done_out[lane_pos[fin]] = True
                lane_pos[fin] = -1
            live = int((lane_pos >= 0).sum())
            free = np.nonzero(lane_pos < 0)[0]
            n_ref = min(len(free), len(queue))
            if n_ref and (deadline is None or _time.monotonic() < deadline):
                do_refill(free, n_ref)
            else:
                n_ref = 0
            record(n, live, n_ref, pend_steps, shard_row(free, n_ref, shard_steps))
            if live == 0 and n_ref == 0 and not queue:
                break
    else:
        # pipelined loop: the boundary is processed from the segment's
        # packed summary; when no refill decision is pending the next
        # segment is dispatched first (here it runs to its end at once)
        pend = None
        pend_steps = segment_steps
        prev_live = k > 0
        pv_pending: list[tuple[int, int]] = []  # deferred (lane, pos)
        if total < max_steps and (deadline is None or _time.monotonic() < deadline):
            pend = dispatch(segment_steps)
        while pend is not None:
            nxt = None
            nxt_steps = segment_steps
            if (prev_live and not queue and total + pend_steps < max_steps
                    and (deadline is None or _time.monotonic() < deadline)):
                # the queue is empty, so the synchronous loop would run
                # this exact segment after the boundary anyway
                nxt = dispatch(nxt_steps)
            summ, n, shard_steps = boundary_summary(pend, width, stats, mesh)
            total += n
            lane_done = summ[:, SUM_DONE].astype(bool)
            fin = np.nonzero(lane_done & (lane_pos >= 0))[0]
            if fin.size:
                pos = lane_pos[fin]
                out["score"][pos] = summ[fin, SUM_SCORE]
                out["move"][pos] = summ[fin, SUM_MOVE]
                out["nodes"][pos] = summ[fin, SUM_NODES]
                done_out[pos] = True
                if nxt is None:
                    pull_pv(fin, pos)
                else:
                    # the next segment already ran; DONE lanes stay
                    # frozen and the empty queue never resplices them,
                    # so their PV rows are read at a later boundary
                    pv_pending.extend(zip(fin.tolist(), pos.tolist()))
                lane_pos[fin] = -1
            if pv_pending and nxt is None:
                lanes = np.asarray([ln for ln, _ in pv_pending], np.int64)
                pos = np.asarray([p for _, p in pv_pending], np.int64)
                pull_pv(lanes, pos)
                pv_pending.clear()
            live = int((lane_pos >= 0).sum())
            free = np.nonzero(lane_pos < 0)[0]
            n_ref = min(len(free), len(queue))
            if n_ref and nxt is None and (deadline is None or _time.monotonic() < deadline):
                do_refill(free, n_ref)
            else:
                n_ref = 0
            record(n, live, n_ref, pend_steps, shard_row(free, n_ref, shard_steps))
            if nxt is not None:
                pend = nxt
                pend_steps = nxt_steps
                prev_live = live > 0
                continue
            stop = ((live == 0 and n_ref == 0 and not queue) or total >= max_steps
                    or (deadline is not None and _time.monotonic() >= deadline))
            if stop:
                pend = None
            else:
                pend = dispatch(segment_steps)
                pend_steps = segment_steps
                prev_live = live > 0 or n_ref > 0

    return {
        **out, "done": done_out, "steps": total, "occupancy": occupancy,
        "refills": refills_total, "tt": tt,
    }


def boundary_steps(pend, width: int, stats: SyncStats, mesh=None):
    """A segment dispatch's result (run_segment's, or under a mesh
    run_segment_sharded's) → (its step count, per-shard steps or None),
    counting its one read (one a distinct device under a mesh, where the
    count is the largest shard's: shards park on their own). The
    synchronous loops' boundary."""
    n, summ = pend
    if mesh is None:
        return int(stats.fetch(summ[width, SUM_DONE], "steps")), None
    stats.count(np.asarray(n), len(set(mesh)))
    return max(n), n


def boundary_summary(pend, width: int, stats: SyncStats, mesh=None):
    """A segment dispatch's result → ((width, 4) host lane rows, step
    count, per-shard steps or None), counting its one summary read as
    boundary_steps does. The pipelined loops' boundary."""
    n, summ = pend
    if mesh is None:
        raw = stats.fetch(summ, "summary")
        return raw[:width], int(raw[width, SUM_DONE]), None
    stats.count(summ, len(set(mesh)))
    return summ[:, :-1].reshape(width, SUM_W), max(n), n


def fetch_lanes(parts, stats: SyncStats | None = None, label: str = "") -> np.ndarray:
    """One tensor a shard (its lanes, in shard order; one device is one
    shard) → their concatenation as a host array, in one read a distinct
    device, through stats when it is given."""
    groups: dict = {}
    for i, t in enumerate(parts):
        groups.setdefault(t.device, []).append(i)
    host = [None] * len(parts)
    for ids in groups.values():
        joined = parts[ids[0]] if len(ids) == 1 else torch.cat([parts[i] for i in ids])
        arr = stats.fetch(joined, label) if stats is not None else joined.cpu().numpy()
        off = 0
        for i in ids:
            host[i] = arr[off:off + parts[i].shape[0]]
            off += parts[i].shape[0]
    return host[0] if len(host) == 1 else np.concatenate(host)


def fetch_rows(states, lanes, pick, stats: SyncStats, label: str) -> np.ndarray:
    """The rows of pick(state) at `lanes` (global lane numbers over the
    states, one a shard in shard order), in their order, as a host array
    in one read a distinct device."""
    lanes = np.asarray(lanes, np.int64).reshape(-1)
    local = int(states[0].lane.shape[0])
    owner = lanes // local
    parts, order = [], []
    for s, st in enumerate(states):
        sel = np.nonzero(owner == s)[0]
        if sel.size:
            t = pick(st)
            parts.append(t.index_select(0, torch.as_tensor(lanes[sel] - s * local,
                                                           device=t.device)))
            order.append(sel)
    rows = fetch_lanes(parts, stats, label)
    if len(order) == 1:  # every lane on one shard, in order
        return rows
    out = np.empty_like(rows)
    out[np.concatenate(order)] = rows
    return out


def _check_tables(tt, mesh) -> None:
    """A sharded search's tables: None, or one a shard on its device."""
    if tt is None:
        return
    if len(tt) != len(mesh):
        raise ValueError(f"{len(tt)} tables for a mesh of {len(mesh)} devices")
    for t, d in zip(tt, mesh):
        if t.device != d:
            raise ValueError(f"a shard's table is on {t.device}, the shard on {d}")


def _to_dev(x, dev) -> torch.Tensor:
    """int32 (or uint32-bit-pattern) array-like → int32 tensor on dev."""
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=_I32)
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, np.int32)).to(dev)


def search_batch(params: nnue.NnueParams, roots: Board, depth, node_budget,
                 max_ply: int, max_steps: int = 2_000_000, hist=None,
                 device=None, variant: str = "standard") -> dict:
    """Fixed-depth alpha-beta + capture quiescence on B roots in lockstep
    (max_ply > depth: the stack past the nominal depth is quiescence
    headroom). Scores are centipawns from each root's side to move;
    ±(MATE-n) is mate in n plies. A wrapper over search_batch_resumable,
    one segment of min(max_steps, FISHNET_TPU_SEGMENT) steps at a time."""
    seg = settings.get_segment()
    if seg is None:
        seg = settings.get_int("FISHNET_TPU_SEGMENT_MAX")
    return search_batch_resumable(
        params, roots, depth, node_budget, max_ply=max_ply,
        segment_steps=min(max_steps, seg), max_steps=max_steps, hist=hist,
        device=device, variant=variant,
    )
