"""Batched pseudo-legal move generation over a fixed candidate space.

A copy of the JAX package's ops/movegen.py for standard chess and
chess960, with the lane dimension spelled out. The candidate space is
fixed — (64 sq x 8 dirs x 7 steps) slider slots, (64 x 8) knight and
(64 x 8) king slots, (64 x 4) pawn slots, (8 x 3 x 4) promotion slots
(promotions start from the 8 pre-promotion squares), 2 castling slots —
and one sort of packed (ordering_key << 16 | move) values both compacts
the valid candidates and orders them. Packed values are unique, so the
order of the moves is the reference's whatever the order of the slots:
this module lays the knight and king slots out square by square (one
gather serves both) where the reference keeps them in two sections.
Legality is left to the search's king-capture refutation, except
castling, whose path is checked for attacks here.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from . import tables as T
from .board import (
    OFF, Board, Rays, attack_parts, clear_before, king_square, pad_squares, rays_of,
)
from .board import tables as board_tables

MAX_MOVES = T.MAX_MOVES
INT32_MAX = 2**31 - 1

_SQ = np.arange(64)
_TO1 = np.stack([np.clip(_SQ + 8, 0, 63), np.clip(_SQ - 8, 0, 63)])  # (2, 64)
_TO2 = np.stack([np.clip(_SQ + 16, 0, 63), np.clip(_SQ - 16, 0, 63)])
_CAPS = np.asarray(T.PAWN_CAPTURES)  # (2, 64, 2), -1 padded
# promotion origins per color: white promotes from 48..55, black from 8..15
_PROMO_FROM = np.stack([np.arange(48, 56), np.arange(8, 16)])  # (2, 8)
_PROMOS = np.array([T.PROMO_N, T.PROMO_B, T.PROMO_R, T.PROMO_Q])
# knight and king targets side by side, and the piece type each column wants
_KK = np.concatenate([T.KNIGHT_TARGETS, T.KING_TARGETS], 1)  # (64, 16)
_KK_TYPE = np.array([1] * 8 + [5] * 8)


def _pair_tables():
    """Keys and take-ability of a mover (code a) onto a square holding
    code v, indexed a * 13 + v: MVV-LVA (smaller first) for a capture of
    an enemy piece, 1000 for a quiet move."""
    codes = np.arange(13)
    ptype = np.where(codes == 0, -1, (codes - 1) % 6)
    color = np.where(codes == 0, -1, codes > 6)
    a, v = np.meshgrid(codes, codes, indexing="ij")
    capture = (a > 0) & (v > 0) & (color[a] != color[v])
    key = np.where(capture, 100 + (5 - ptype[v]) * 8 + ptype[a], 1000)
    return key.reshape(-1), (capture | (v == 0)).reshape(-1)


_PAIR_KEY, _PAIR_TAKE = _pair_tables()


def max_moves_for(variant: str) -> int:
    if variant not in ("standard", "chess960", "fromPosition"):
        raise NotImplementedError(f"variant {variant!r} is not ported yet")
    return MAX_MOVES


def _static_moves(c: int) -> np.ndarray:
    """Move encodings of every non-castling slot for side to move c, in
    this module's slot order (sliders, knight|king, pawns, promos);
    squares past the edge are clipped as in the reference."""
    rsq = np.clip(T.RAYS, 0, None)
    pawn_tos = np.stack(
        [_TO1[c], _TO2[c], np.clip(_CAPS[c][:, 0], 0, 63), np.clip(_CAPS[c][:, 1], 0, 63)], 1
    )
    pf = _PROMO_FROM[c]
    promo_tos = pawn_tos[pf][:, [0, 2, 3]]  # push, capL, capR
    return np.concatenate([
        (_SQ[:, None, None] | (rsq << 6)).reshape(-1),
        (_SQ[:, None] | (np.clip(_KK, 0, None) << 6)).reshape(-1),
        (_SQ[:, None] | (pawn_tos << 6)).reshape(-1),
        (pf[:, None, None] | (promo_tos[:, :, None] << 6) | (_PROMOS << 12)).reshape(-1),
    ]).astype(np.int32)


@lru_cache(maxsize=None)
def _hist_idx_tables(variant: str = "standard"):
    """Per-color (n_candidates,) tables of `cand & 4095` (the from|to
    history index) for every candidate slot, in this module's slot
    order; the two castling slots hold 0 (castling keys are 900, which
    the history bonus never touches)."""
    max_moves_for(variant)
    return tuple(
        np.concatenate([_static_moves(c) & 4095, np.zeros(2, np.int32)]) for c in (0, 1)
    )


class _Tables(NamedTuple):
    moves: torch.Tensor  # (2, n_candidates - 2) int32 static encodings
    hist_idx: torch.Tensor  # (2, n_candidates) long
    rvalid: torch.Tensor  # (64, 8, 7) bool
    kk: torch.Tensor  # (64, 16) long, OFF padded
    kk_valid: torch.Tensor  # (64, 16) bool: the target is on the board
    kk_type: torch.Tensor  # (16,) int32
    pawn_tgt: torch.Tensor  # (2, 64, 4) long: push1, push2, capL, capR (caps OFF padded)
    start_rank: torch.Tensor  # (2, 64) bool
    not_pre_promo: torch.Tensor  # (2, 64) bool: not a pawn's last step before promotion
    promo_from: torch.Tensor  # (2, 8) long
    q_promo: torch.Tensor  # (4,) int32: 90 where the piece is a queen
    rays: torch.Tensor  # (64, 8, 7) long, OFF padded
    castle_key: torch.Tensor  # (1, 2) int32
    castle_side: torch.Tensor  # (1, 2) int32: 0 kingside, 1 queenside
    pair_key: torch.Tensor  # (13 * 13,) int32: ordering key of mover code x target code
    pair_take: torch.Tensor  # (13 * 13,) bool: the target square is empty or the mover's enemy's


@lru_cache(maxsize=None)
def _tables(device: torch.device) -> _Tables:
    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    caps = np.where(_CAPS >= 0, _CAPS, OFF)
    ranks = _SQ >> 3
    return _Tables(
        moves=t(np.stack([_static_moves(0), _static_moves(1)]), torch.int32),
        hist_idx=t(np.stack(_hist_idx_tables("standard"))),
        rvalid=t(T.RAYS >= 0, torch.bool), kk=t(pad_squares(_KK)), kk_valid=t(_KK >= 0, torch.bool),
        kk_type=t(_KK_TYPE, torch.int32),
        pawn_tgt=t(np.stack([np.stack([_TO1[c], _TO2[c], caps[c][:, 0], caps[c][:, 1]], 1)
                             for c in (0, 1)])),
        start_rank=t(np.stack([ranks == 1, ranks == 6]), torch.bool),
        not_pre_promo=t(np.stack([ranks != 6, ranks != 1]), torch.bool),
        promo_from=t(_PROMO_FROM), q_promo=t(90 * (_PROMOS == T.PROMO_Q), torch.int32),
        rays=t(pad_squares(T.RAYS)), castle_key=t([[900, 900]], torch.int32),
        castle_side=t([[0, 1]], torch.int32),
        pair_key=t(_PAIR_KEY, torch.int32), pair_take=t(_PAIR_TAKE, torch.bool),
    )


def _mvv_lva(victim_type: torch.Tensor, attacker_type) -> torch.Tensor:
    """Capture ordering key (smaller = searched first): victim desc,
    attacker asc; quiet moves key 1000."""
    return 100 + (5 - victim_type) * 8 + attacker_type


def _candidate_space(b: Board, r: Rays | None = None, attacks=None):
    """→ (flat_moves, flat_valid, flat_keys), each (B, n_candidates).
    r / attacks: rays_of(b.board) / board.attack_parts(r) when the caller
    already has them."""
    if r is None:
        r = rays_of(b.board)
    if attacks is None:
        attacks = attack_parts(r)
    c = _tables(b.board.device)
    bt = board_tables(b.board.device)
    B = b.board.shape[0]
    us = b.stm
    s = us.long()
    them = 1 - us
    board = r.padded[:, :64]
    types = bt.ptype[board]  # (B, 64)
    own = bt.pcolor[board] == us[:, None]

    # sliders: along each ray up to and including the first piece, unless own
    by_them = (bt.pcolor[r.piece] == them[:, None, None, None]) & r.slides  # for castling
    own_slides = own[:, :, None] & bt.slide_dir[board[:, :, None] * 8 + bt.dirs[:, 0]]
    pair = (board * 13)[:, :, None, None] + r.piece
    valid_sl = own_slides[..., None] & c.rvalid & r.clear & c.pair_take[pair]
    keys_sl = c.pair_key[pair]

    # knights and king
    tp = r.padded[:, c.kk]  # (B, 64, 16)
    pair = (board * 13)[:, :, None] + tp
    valid_kk = ((own[:, :, None] & (types[:, :, None] == c.kk_type)) & c.kk_valid
                & c.pair_take[pair])
    keys_kk = c.pair_key[pair]

    # pawns: push1, push2, capture left/right (en passant included)
    tg = c.pawn_tgt[s]  # (B, 64, 4)
    tb = r.padded.gather(1, tg.flatten(1)).view(B, 64, 4)
    our_pawn = board == (T.W_PAWN + 6 * us)[:, None]
    to1_ok = our_pawn & (tb[..., 0] == 0)
    to2_ok = to1_ok & c.start_rank[s] & (tb[..., 1] == 0)
    cap_ok = our_pawn[..., None] & (
        (bt.pcolor[tb[..., 2:]] == them[:, None, None]) | (tg[..., 2:] == b.ep[:, None, None])
    )
    not_pre = c.not_pre_promo[s]
    pawn_ok = torch.cat([(to1_ok & not_pre)[..., None], to2_ok[..., None],
                         cap_ok & not_pre[..., None]], 2)
    cap_key = torch.where(cap_ok, _mvv_lva(bt.ptype[tb[..., 2:]].clamp(min=0), 0), 1000)
    keys_pw = torch.cat([torch.full_like(cap_key, 1000), cap_key], 2)

    # promotions from the 8 pre-promotion squares: [push, capL, capR] x N B R Q
    pf = c.promo_from[s]  # (B, 8)
    promo_ok = torch.cat([to1_ok.gather(1, pf)[..., None],
                          cap_ok.gather(1, pf[..., None].expand(B, 8, 2))], 2)
    promo_key = keys_pw[..., 1:].gather(1, pf[..., None].expand(B, 8, 3))
    keys_pr = promo_key[..., None] - c.q_promo
    valid_pr = promo_ok[..., None].expand(B, 8, 3, 4)

    # castling (king takes rook): path empty, king path not attacked with
    # the king and that rook lifted off the board
    ok, mv = _castling(b, r, by_them, attacks)

    flat_moves = torch.cat([c.moves[s], mv], 1)
    flat_valid = torch.cat([valid_sl.flatten(1), valid_kk.flatten(1), pawn_ok.flatten(1),
                            valid_pr.flatten(1), ok], 1)
    flat_keys = torch.cat([keys_sl.flatten(1), keys_kk.flatten(1), keys_pw.flatten(1),
                           keys_pr.flatten(1), c.castle_key.expand(B, 2)], 1)
    return flat_moves, flat_valid, flat_keys.to(torch.int32)


def _castling(b: Board, r: Rays, by_them: torch.Tensor, attacks):
    c = _tables(b.board.device)
    bt = board_tables(b.board.device)
    us = b.stm
    board = b.board
    them = 1 - us
    ksq = king_square(board, us)
    rsq = b.castling.view(-1, 2, 2).gather(1, us.long()[:, None, None].expand(-1, 1, 2))[:, 0]
    has = (rsq >= 0) & (ksq >= 0)[:, None]  # (B, 2): kingside, queenside
    ksq = ksq.clamp(min=0)
    rsq = rsq.clamp(0, 63)
    rank_base = (56 * us)[:, None]
    k_dest = rank_base + 6 - 4 * c.castle_side
    r_dest = rank_base + 5 - 2 * c.castle_side
    kq = ksq[:, None]
    lo_k, hi_k = torch.minimum(kq, k_dest), torch.maximum(kq, k_dest)
    lo_r, hi_r = torch.minimum(rsq, r_dest), torch.maximum(rsq, r_dest)
    sq = bt.sq[None, None]  # (1, 1, 64)
    kpath = (sq >= lo_k[..., None]) & (sq <= hi_k[..., None])  # (B, 2, 64)
    span = kpath | ((sq >= lo_r[..., None]) & (sq <= hi_r[..., None]))
    span = span & (sq != kq[..., None]) & (sq != rsq[..., None])
    empty_ok = ~(span & (board > 0)[:, None]).any(2)

    # slider attacks by `them` with king and rook lifted; the other
    # attackers do not depend on the lift
    rays = c.rays[None, None]  # (1, 1, 64, 8, 7)
    occ = (r.occ[:, None] & (rays != kq[..., None, None, None])
           & (rays != rsq[..., None, None, None]))
    clear = clear_before(occ)
    slider = (occ & clear & by_them[:, None]).flatten(3).any(3)  # (B, 2, 64)
    _, _, other_w, other_b = attacks
    other = torch.where((them == 0)[:, None], other_w, other_b)
    safe = ~((slider | other[:, None]) & kpath).any(2)
    return has & empty_ok & safe, (ksq[:, None] | (rsq << 6)).to(torch.int32)


def generate_moves(b: Board, killers=None, hist=None, rays: Rays | None = None,
                   attacks=None):
    """→ (moves (B, MAX_MOVES) sorted by ordering key, -1 padded;
    count (B,); noisy (B,)).

    noisy counts the leading captures / queen promotions (they sort
    first). killers (B, 2) / hist (B, 4096): optional quiet-move ordering
    state; they reorder only the quiet tail (keys >= 900)."""
    flat_moves, flat_valid, flat_keys = _candidate_space(b, rays, attacks)
    if hist is not None:
        idx = _tables(b.board.device).hist_idx[b.stm.long()]
        hbonus = (hist.gather(1, idx) >> 5).clamp(0, 99)
        flat_keys = torch.where(flat_keys == 1000, 1010 - hbonus, flat_keys)
    if killers is not None:
        is_k = (flat_moves == killers[:, :1]) | (flat_moves == killers[:, 1:2])
        flat_keys = torch.where(is_k & (flat_keys >= 900), 901, flat_keys)
    packed = torch.where(flat_valid, (flat_keys << 16) | flat_moves, INT32_MAX)
    top = torch.sort(packed, dim=1, stable=True).values[:, :MAX_MOVES]
    moves = torch.where(top != INT32_MAX, top & 0xFFFF, -1)
    count = flat_valid.sum(1, dtype=torch.int32).clamp(max=MAX_MOVES)
    noisy = (flat_valid & (flat_keys < 900)).sum(1, dtype=torch.int32).clamp(max=MAX_MOVES)
    return moves, count, noisy
