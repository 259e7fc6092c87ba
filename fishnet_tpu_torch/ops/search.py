"""Lockstep batched alpha-beta search, batched over lanes in PyTorch.

A port of the JAX package's ops/search.py (standard chess and chess960,
transposition table off). B independent lanes each keep an explicit DFS
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

Each step runs the Zobrist hash (K4), the leaf eval (K2) and the
accumulator update (K3) as CUDA kernels on the card; `init_state` runs
the root refresh (K1). The rest of the step is batched PyTorch code.
"""
from __future__ import annotations

import time as _time
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .. import settings
from ..models import nnue
from . import tt as tt_mod
from .board import Board, attack_parts, make_move_with_changes, node_rules, rays_of
from .movegen import MAX_MOVES, generate_moves

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
# bt fields (one int32 row per node's board)
BT_BOARD = 0
BT_STM = 64
BT_EP = 65
BT_CAST = 66
BT_HM = 70
BT_EXTRA = 71  # variant side-state: zeros for standard chess
BT_PH1 = 83  # path-hash words (uint32 bits as int32)
BT_PH2 = 84
BT_W = 96
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

NULL_R = 2  # base null-move depth reduction (+1 at depth_left >= 7)

# steps between the host's checks for "every lane DONE"; the step count
# itself is kept on the device, so this only bounds the wasted steps
CHECK_EVERY = 32

_I32 = torch.int32


class SearchState(NamedTuple):
    bt: torch.Tensor  # (B, P+1, BT_W) int32 board rows
    nt: torch.Tensor  # (B, P+1, NT_W) int32 per-node scalars
    lane: torch.Tensor  # (B, LN_W) int32 per-lane scalars
    hist_hash: torch.Tensor  # (B, MAX_HIST, 2) int32 pre-root game hashes
    hist_halfmove: torch.Tensor  # (B, MAX_HIST) int32
    moves: torch.Tensor  # (B, P, MAX_MOVES) int32
    hist: torch.Tensor  # (B, 4096) int32 from|to history counters
    pv: torch.Tensor  # (B, P, P) int32
    acc: torch.Tensor  # (B, P+1, 2, L1) incremental NNUE accumulators


def _board_from_rows(rows: torch.Tensor) -> Board:
    return Board(
        board=rows[:, BT_BOARD:BT_BOARD + 64], stm=rows[:, BT_STM],
        ep=rows[:, BT_EP], castling=rows[:, BT_CAST:BT_CAST + 4],
        halfmove=rows[:, BT_HM],
    )


def _rows_from_board(b: Board) -> torch.Tensor:
    """(B, BT_W) rows; extra and path-hash words zero."""
    B = b.board.shape[0]
    z = torch.zeros((B, BT_W - BT_EXTRA), dtype=_I32, device=b.board.device)
    return torch.cat([
        b.board.to(_I32), b.stm.to(_I32)[:, None], b.ep.to(_I32)[:, None],
        b.castling.to(_I32), b.halfmove.to(_I32)[:, None], z,
    ], 1)


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
    """Non-capture, non-promotion move (en passant reads as quiet, which
    only costs ordering); move >= 0."""
    to = ((move >> 6) & 63).long()
    return (board.gather(1, to[:, None])[:, 0] == 0) & (((move >> 12) & 7) == 0)


def init_state(params: nnue.NnueParams, roots: Board, depth: torch.Tensor,
               node_budget: torch.Tensor, max_ply: int, hist_hash=None,
               hist_halfmove=None, root_alpha=None,
               root_beta=None) -> SearchState:
    """roots: batched Board on the search's device; depth/node_budget
    (B,). hist_hash (B, MAX_HIST, 2) int32 / hist_halfmove (B, MAX_HIST):
    optional reversible game tail per lane (None: no pre-root
    repetitions possible). root_alpha/root_beta (B,): optional
    aspiration window at the root."""
    dev = roots.board.device
    B, P = roots.board.shape[0], max_ply

    def full(shape, value):
        return torch.full(shape, value, dtype=_I32, device=dev)

    acc = torch.zeros((B, P + 1, 2, params.l1), dtype=nnue.acc_dtype(params), device=dev)
    acc[:, 0] = nnue.accumulators_768(params, roots.board.to(_I32).contiguous())

    bt = torch.zeros((B, P + 1, BT_W), dtype=_I32, device=dev)
    bt[:, :, BT_EP] = -1
    bt[:, :, BT_CAST:BT_CAST + 4] = -1
    bt[:, 0] = _rows_from_board(roots)

    nt = torch.zeros((B, P + 1, NT_W), dtype=_I32, device=dev)
    nt[:, :, NT_ALPHA] = -INF
    nt[:, :, NT_ALPHA0] = -INF
    nt[:, :, NT_BETA] = INF
    nt[:, :, NT_BEST] = -INF
    nt[:, :, NT_BMOVE] = -1
    nt[:, :, NT_K0] = -1
    nt[:, :, NT_K1] = -1
    nt[:, 0, NT_DL] = depth.to(_I32)

    lane = torch.zeros((B, LN_W), dtype=_I32, device=dev)
    lane[:, LN_DLIM] = depth.to(_I32)
    lane[:, LN_BUDGET] = node_budget.to(_I32)
    lane[:, LN_RSCORE] = -INF
    lane[:, LN_RMOVE] = -1
    lane[:, LN_RALPHA] = -INF if root_alpha is None else root_alpha.to(_I32)
    lane[:, LN_RBETA] = INF if root_beta is None else root_beta.to(_I32)

    if hist_hash is None:
        hist_hash = torch.zeros((B, MAX_HIST, 2), dtype=_I32, device=dev)
    if hist_halfmove is None:
        hist_halfmove = full((B, MAX_HIST), HIST_HM_SENTINEL)
    return SearchState(
        bt=bt, nt=nt, lane=lane, hist_hash=hist_hash.to(_I32),
        hist_halfmove=hist_halfmove.to(_I32),
        moves=full((B, P, MAX_MOVES), -1),
        hist=torch.zeros((B, 4096), dtype=_I32, device=dev),
        pv=full((B, P, P), -1), acc=acc,
    )


class _Consts(NamedTuple):
    ks: torch.Tensor  # (P+1,) ply index
    hist_dist: torch.Tensor  # (MAX_HIST,) virtual ply distance of each history slot
    fm_expand: torch.Tensor  # (NT_W,) bool
    fm_enter: torch.Tensor  # (NT_W,) bool
    ntp_cols: torch.Tensor  # RETURN's parent-row fields
    nt1_cols: torch.Tensor  # TRYMOVE's own-row fields


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
    )


@torch.inference_mode()
def _step(params: nnue.NnueParams, s: SearchState, pruning: bool) -> None:
    """One state-machine step for every lane, written into `s` in place.

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
    b = _board_from_rows(btr0)
    us = b.stm
    rays = rays_of(b.board)
    attacks = attack_parts(rays)
    illegal_raw, we_are_checked = node_rules(b, rays, attacks)
    # on bools `a > b` is `a & ~b` in one launch
    parent_illegal = illegal_raw > root
    depth_left = ntr0[:, NT_DL]
    parent_null = (ntp0[:, NT_NULL] == 2) > root
    over_budget = nodes >= lane[:, LN_BUDGET]
    fifty = b.halfmove >= 100

    # twofold repetition along the search path and against the pre-root
    # game history, through unbroken reversible-move chains
    h = tt_mod.hash_board(b.board, us, b.ep, b.castling)
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

    # leaf value: the NNUE eval from the incremental accumulator
    ev = nnue.forward_from_acc(
        params, _row(s.acc, p0), us.contiguous(), nnue.output_bucket(b.board)
    )
    static_val = ev.to(_I32).clamp(-(MATE - 1000), MATE - 1000)
    draw = fifty | repet
    leaf_val = torch.where(draw, DRAW, static_val)

    gen_moves, gen_count, gen_noisy = generate_moves(
        b, killers=ntr0[:, NT_K0:NT_K1 + 1], hist=s.hist, rays=rays, attacks=attacks
    )
    quiet_node = gen_noisy == 0
    window_ok_a = (entry_alpha > -(MATE - 1000)) & (entry_alpha < MATE - 1000)
    if pruning:  # futility at frontier nodes
        f_margin = torch.where(depth_left == 1, 150, 300)
        futile = (
            ((depth_left <= 2) > (in_qs | we_are_checked | root))
            & (static_val + f_margin <= entry_alpha) & window_ok_a
        )
        qs_like = in_qs | futile
    else:
        qs_like = in_qs
    is_leaf = (
        draw | over_budget | (ply0 >= P) | (qs_like & quiet_node)
        | (in_qs & (leaf_val >= entry_beta))  # stand-pat cut
    )
    to_return = parent_illegal | is_leaf
    expand = enter > to_return
    leaf_store = ((enter & is_leaf) > (parent_illegal | draw)) & quiet_node
    store_val = torch.where(leaf_store, leaf_val, 0)

    if pruning:  # null-move eligibility
        us_base = (us * 6)[:, None]
        nonpawn = ((b.board >= us_base + 2) & (b.board <= us_base + 5)).any(1)
        null_v = (
            ((depth_left >= 3) > (we_are_checked | parent_null | root))
            & (static_val >= entry_beta) & (entry_beta < MATE - 1000)
            & (entry_beta > -(MATE - 1000)) & nonpawn
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
    ret = torch.where(ret_now, torch.where(parent_illegal, ILLEGAL, leaf_val), lane[:, LN_RET])
    ret_depth = torch.where(ret_now, 0, lane[:, LN_RETD])
    nodes = nodes + (enter > parent_illegal).to(_I32)
    mode = torch.where(ret_now, MODE_RETURN, torch.where(expand, MODE_TRYMOVE, mode0))

    # --------------------------------------------------------- RETURN
    ret_m = mode == MODE_RETURN
    fold = ret_m > root
    v = -ret
    tried = moves_p_row.gather(1, (ntp0[:, NT_MIDX:NT_MIDX + 1] - 1).clamp(min=0).long())[:, 0]
    is_null_ret = fold & (ntp0[:, NT_NULL] == 2)
    legal_fold = fold & (ret != ILLEGAL)
    null_cut = is_null_ret & legal_fold & (v >= ntp0[:, NT_BETA]) & (v < MATE - 1000)
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
    parent_b = _board_from_rows(bt1)
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
    k_upd = try_m & cutoff & (cause >= 0) & _is_quiet(cause.clamp(min=0), parent_b.board)
    k_new = k_upd & (cause != nt1[:, NT_K0])
    h_idx = (cause.clamp(min=0) & 4095).long()
    dl = dl_node.clamp(min=0)
    hist_old = s.hist.gather(1, h_idx[:, None])[:, 0]
    _set_row(s.hist, h_idx, (hist_old + (dl * dl + 1).clamp(max=1024)).clamp(max=1 << 20),
             k_upd)

    # finished node value: best, or mate/stalemate when no legal child
    node_in_qs = dl_node <= 0
    no_legal = ((nt1[:, NT_SEARCHED] == 0) > node_in_qs) & (nt1[:, NT_BEST] == -INF)
    mate_val = torch.where(nt1[:, NT_INCHECK] != 0, ply1 - MATE, DRAW)
    fin_val = torch.where(no_legal & exhausted, mate_val, nt1[:, NT_BEST])

    m_ix = torch.where(re_push, midx - 1, midx).clamp(0, moves_row1.shape[1] - 1)
    move = moves_row1.gather(1, m_ix.long()[:, None])[:, 0].clamp(min=0)
    child, codes, sqs, signs = make_move_with_changes(parent_b, move)
    if pruning:
        # late-move reduction; the null child is the same position with
        # the opponent to move, no ep square and a reset halfmove clock
        lmr_ok = (
            (dl_node >= 3) & (midx >= 3) & (nt1[:, NT_INCHECK] == 0)
            & _is_quiet(move, parent_b.board)
        )
        red = torch.where(lmr_ok > (re_push | do_null), torch.where(midx >= 8, 2, 1), 0)
        dn = do_null[:, None]
        child = Board(
            board=torch.where(dn, parent_b.board, child.board),
            stm=torch.where(do_null, 1 - parent_b.stm, child.stm),
            ep=torch.where(do_null, -1, child.ep),
            castling=torch.where(dn, parent_b.castling, child.castling),
            halfmove=torch.where(do_null, 0, child.halfmove),
        )
        null_r = NULL_R + (dl_node >= 7).to(_I32)
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

    _set_row(bt, pn, _rows_from_board(child), advance)
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


def run_segment(params: nnue.NnueParams, state: SearchState,
                segment_steps: int, pruning: bool | None = None):
    """Advance all lanes <= segment_steps steps, stopping once every lane
    is DONE. → (steps, summary): steps counts the steps in which any lane
    was live (the reference's while-loop count); summary is the packed
    (B+1, 4) int32 boundary summary (done, nodes, root score, root move;
    row B carries the step count).

    The host checks for DONE lanes every CHECK_EVERY steps, not every
    step: the count is kept on the device, and DONE lanes are inert under
    the extra steps, so the results are those of the exact loop."""
    if pruning is None:
        pruning = not settings.get_bool("FISHNET_TPU_NO_PRUNING")
    n_dev = torch.zeros((), dtype=torch.int64, device=state.lane.device)
    done_steps = 0
    while done_steps < segment_steps:
        k = min(CHECK_EVERY, segment_steps - done_steps)
        for _ in range(k):
            n_dev += (state.lane[:, LN_MODE] != MODE_DONE).any()
            _step(params, state, pruning)
        done_steps += k
        if int(n_dev) < done_steps:
            break
    n = int(n_dev)
    lane = state.lane
    summary = torch.cat([
        torch.stack([
            (lane[:, LN_MODE] == MODE_DONE).to(_I32), lane[:, LN_NODES],
            lane[:, LN_RSCORE], lane[:, LN_RMOVE],
        ], 1),
        torch.full((1, SUM_W), n, dtype=_I32, device=lane.device),
    ])
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
    hist=None,
    window=None,
    narrow: bool = True,
    device=None,
) -> dict:
    """Search B roots in lockstep, dispatched in bounded segments.

    Runs on `device` (default: the card; the params and roots are moved
    there). depth/node_budget: scalars or (B,). hist: optional
    (hist_hash (B, MAX_HIST, 2), hist_halfmove (B, MAX_HIST)) game tails;
    window: optional (root_alpha (B,), root_beta (B,)) aspiration window —
    a root whose value falls outside reports the bound.

    deadline: absolute time.monotonic() stamp checked between segments;
    lanes not DONE at the stop report done=False.

    narrow: at segment boundaries, retire DONE lanes and continue the
    live ones at a smaller power-of-two width (floor
    FISHNET_TPU_NARROW_FLOOR). Narrowing relocates lanes and never
    changes any lane's search.

    Returns numpy arrays keyed score, move, pv (B, P), pv_len, nodes,
    done, plus the int step count "steps"."""
    dev = device_mod.resolve(device)
    if segment_steps is None:
        segment_steps = settings.get_segment()
        if segment_steps is None:
            segment_steps = settings.get_int("FISHNET_TPU_SEGMENT_MAX")
    narrow_floor = settings.get_int("FISHNET_TPU_NARROW_FLOOR")
    pruning = not settings.get_bool("FISHNET_TPU_NO_PRUNING")
    params = params.to(dev)
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
    )

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
        n, summary = run_segment(params, state, segment_steps, pruning)
        total += n
        if n < segment_steps:
            break  # every lane parked in DONE
        if deadline is not None and _time.monotonic() >= deadline:
            break
        cur = state.lane.shape[0]
        if narrow and cur > narrow_floor:
            done = summary[:cur, SUM_DONE].cpu().numpy() != 0
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
                valid = np.concatenate(
                    [np.ones(len(keep), bool), np.zeros(len(pad), bool)]
                )

    out = {k: v.cpu().numpy() for k, v in extract_results(state, total).items()
           if k != "steps"}
    if flushed is not None:
        for k, buf in flushed.items():
            buf[orig[valid]] = out[k][valid]
        out = flushed
    out["steps"] = total
    return out


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
                 device=None) -> dict:
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
        device=device,
    )
