"""Device board representation, rules and move making, batched over lanes.

A copy of the JAX package's ops/board.py for standard chess and chess960,
written with the lane dimension spelled out: every function takes (B, …)
tensors where the reference took one lane under `vmap`.

Board tensors (one row per lane):
  board:    (B, 64) int32 piece codes (tables.py: 0 empty, 1-6 white, 7-12 black)
  stm:      (B,) int32, 0 white / 1 black
  ep:       (B,) int32, en-passant target square or -1
  castling: (B, 4) int32 rook squares with castling rights, -1 if gone,
            order [white-kingside, white-queenside, black-kingside,
            black-queenside] (chess960-ready: actual rook squares)
  halfmove: (B,) int32

On the card every PyTorch call is a kernel launch, so the functions keep
their call count low: square tables index a board padded with one empty
off-board square (index 64, where the reference's tables hold -1), and
piece attributes are read from small lookup tables.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..chess.position import Position
from ..chess.types import scan
from . import tables as T

OFF = 64  # the padded board's empty off-board square


class Board(NamedTuple):
    board: torch.Tensor  # (B, 64) int32
    stm: torch.Tensor  # (B,) int32
    ep: torch.Tensor  # (B,) int32
    castling: torch.Tensor  # (B, 4) int32
    halfmove: torch.Tensor  # (B,) int32

    def to(self, device) -> "Board":
        return Board(*[t.to(device) for t in self])


def board_array(pos: Position) -> np.ndarray:
    """Host Position → (64,) numpy piece-code array."""
    board = np.zeros(64, dtype=np.int32)
    for color in (0, 1):
        for ptype in range(6):
            for sq in scan(pos.bbs[color][ptype]):
                board[sq] = 1 + ptype + 6 * color
    return board


def from_position(pos: Position) -> Board:
    """Host Position → one-lane Board of CPU tensors (batch dim 1)."""
    castling = np.full(4, -1, dtype=np.int32)
    for color in (0, 1):
        ksq = pos.king_sq(color)
        back = 0xFF if color == 0 else 0xFF << 56
        for rsq in scan(pos.castling & back):
            if ksq is None:
                continue
            side = 0 if rsq > ksq else 1
            castling[color * 2 + side] = rsq
    i32 = torch.int32
    return Board(
        board=torch.from_numpy(board_array(pos))[None],
        stm=torch.tensor([pos.turn], dtype=i32),
        ep=torch.tensor([pos.ep_square if pos.ep_square is not None else -1], dtype=i32),
        castling=torch.from_numpy(castling)[None],
        halfmove=torch.tensor([pos.halfmove], dtype=i32),
    )


def stack_boards(boards) -> Board:
    """Sequence of Boards → one Board with their lanes concatenated."""
    return Board(*[torch.cat([getattr(b, f) for b in boards]) for f in Board._fields])


def pad_squares(a) -> np.ndarray:
    """Square table with -1 for "no square" → the padded board's OFF."""
    a = np.asarray(a, np.int64)
    return np.where(a >= 0, a, OFF)


_CODES = np.arange(13)
_PTYPE = np.where(_CODES == 0, -1, (_CODES - 1) % 6)
_PCOLOR = np.where(_CODES == 0, -1, np.where(_CODES <= 6, 0, 1))


class _Tables(NamedTuple):
    ptype: torch.Tensor  # (13,) int32: piece type per code, -1 empty
    pcolor: torch.Tensor  # (13,) int32: color per code, -1 empty
    rays: torch.Tensor  # (64, 8, 7) long, OFF past the edge
    rvalid: torch.Tensor  # (64, 8, 7) bool
    slide_dir: torch.Tensor  # (13 * 8,) bool: code slides along dir [code * 8 + dir]
    dirs: torch.Tensor  # (8, 1) long
    knight: torch.Tensor  # (64, 8) long, OFF padded
    king: torch.Tensor  # (64, 8) long, OFF padded
    pawn_w: torch.Tensor  # (64, 2) long: where white pawns attack sq from
    pawn_b: torch.Tensor  # (64, 2) long: where black pawns attack sq from
    sq: torch.Tensor  # (64,) int32
    promo_piece: torch.Tensor  # (6,) int32
    step_bit: torch.Tensor  # (7,) int16: 1 << i for ray step i
    below: torch.Tensor  # (7,) int16: bits of the steps before step i
    slot_color: torch.Tensor  # (1, 4) int32: color of each castling slot
    signs: torch.Tensor  # (1, 4) int32: move_piece_changes slot signs


@lru_cache(maxsize=None)
def tables(device: torch.device) -> _Tables:
    """The geometry and piece tables as tensors on one device."""
    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return _Tables(
        ptype=t(_PTYPE, torch.int32), pcolor=t(_PCOLOR, torch.int32),
        rays=t(pad_squares(T.RAYS)), rvalid=t(T.RAYS >= 0, torch.bool),
        slide_dir=t(T.SLIDER_MASK.T.reshape(-1), torch.bool),
        dirs=t(np.arange(8)[:, None]),
        knight=t(pad_squares(T.KNIGHT_TARGETS)), king=t(pad_squares(T.KING_TARGETS)),
        # white pawns attacking sq sit where a black pawn on sq would attack
        pawn_w=t(pad_squares(T.PAWN_CAPTURES[1])), pawn_b=t(pad_squares(T.PAWN_CAPTURES[0])),
        sq=t(np.arange(64), torch.int32), promo_piece=t(T.PROMO_TO_PIECE, torch.int32),
        step_bit=t(1 << np.arange(7), torch.int16),
        below=t((1 << np.arange(7)) - 1, torch.int16),
        slot_color=t([[0, 0, 1, 1]], torch.int32), signs=t([[-1, -1, 1, 1]], torch.int32),
    )


class Rays(NamedTuple):
    """The ray view of a board, shared by the rules, the attack maps and
    the move generator of one step."""

    padded: torch.Tensor  # (B, 65) long board, square 64 empty
    piece: torch.Tensor  # (B, 64, 8, 7) long: piece on each ray square
    occ: torch.Tensor  # (B, 64, 8, 7) bool
    clear: torch.Tensor  # (B, 64, 8, 7) bool: no piece before this square
    slides: torch.Tensor  # (B, 64, 8, 7) bool: the ray piece slides along the ray


def clear_before(occ: torch.Tensor) -> torch.Tensor:
    """(..., 7) bool: no occupied square before each step of a ray. The
    ray's occupancy as a 7-bit mask, tested against the bits below each
    step — a prefix scan over 7 elements in elementwise operations."""
    c = tables(occ.device)
    bits = (occ * c.step_bit).sum(-1, dtype=torch.int16)
    return (bits[..., None] & c.below) == 0


def rays_of(board: torch.Tensor) -> Rays:
    c = tables(board.device)
    padded = torch.nn.functional.pad(board.long(), (0, 1))
    piece = padded[:, c.rays]
    occ = piece > 0
    slides = c.slide_dir[piece * 8 + c.dirs]
    return Rays(padded, piece, occ, clear_before(occ), slides)


def attack_parts(r: Rays):
    """→ (slider_w, slider_b, other_w, other_b): (B, 64) bool maps of the
    squares white's / black's sliders and other pieces attack."""
    c = tables(r.padded.device)
    hit = ((r.occ & r.clear & r.slides) * (1 + (r.piece > 6))).flatten(2)  # 1 w, 2 b
    k1 = r.piece[..., 0]  # adjacent square along each ray
    kt = r.padded[:, c.knight]
    other_w = ((k1 == T.W_KING).any(2) | (kt == T.W_KNIGHT).any(2)
               | (r.padded[:, c.pawn_w] == T.W_PAWN).any(2))
    other_b = ((k1 == T.B_KING).any(2) | (kt == T.B_KNIGHT).any(2)
               | (r.padded[:, c.pawn_b] == T.B_PAWN).any(2))
    return (hit == 1).any(2), (hit == 2).any(2), other_w, other_b


def attack_maps(r: Rays):
    """(B, 64) bool maps of the squares attacked by white and by black."""
    slider_w, slider_b, other_w, other_b = attack_parts(r)
    return slider_w | other_w, slider_b | other_b


def attack_map(board: torch.Tensor, by_color: torch.Tensor) -> torch.Tensor:
    """(B, 64) bool: every square attacked by `by_color` (B,)."""
    att_w, att_b = attack_maps(rays_of(board))
    return torch.where((by_color == 0)[:, None], att_w, att_b)


def is_attacked(board: torch.Tensor, sq: torch.Tensor, by_color: torch.Tensor) -> torch.Tensor:
    """(B,) bool: is each lane's square sq attacked by by_color?"""
    return attack_map(board, by_color).gather(1, sq.long()[:, None])[:, 0]


def king_square(board: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """(B,) square of `color`'s king, or -1 if absent."""
    mask = board == (T.W_KING + 6 * color)[:, None]
    return torch.where(mask.any(1), mask.to(torch.uint8).argmax(1).to(torch.int32), -1)


def in_check(b: Board) -> torch.Tensor:
    att_w, att_b = attack_maps(rays_of(b.board))
    att_them = torch.where((b.stm == 0)[:, None], att_b, att_w)
    return (att_them & (b.board == (T.W_KING + 6 * b.stm)[:, None])).any(1)


def node_rules(b: Board, r: Rays | None = None, attacks=None):
    """Per-node legality for standard chess and chess960 → (B,) bools
    (parent_illegal: the move that led here left the mover's king en
    prise or took it; checked: the side to move is in check).
    attacks: attack_parts(r) when the caller already has it."""
    if attacks is None:
        attacks = attack_parts(rays_of(b.board) if r is None else r)
    slider_w, slider_b, other_w, other_b = attacks
    white = (b.stm == 0)[:, None]
    att_us = torch.where(white, slider_w | other_w, slider_b | other_b)
    att_them = torch.where(white, slider_b | other_b, slider_w | other_w)
    our_king = b.board == (T.W_KING + 6 * b.stm)[:, None]
    their_king = b.board == (T.B_KING - 6 * b.stm)[:, None]
    self_check = ~their_king.any(1) | (att_us & their_king).any(1)
    checked = (att_them & our_king).any(1)
    return self_check, checked


class _MoveParts(NamedTuple):
    frm: torch.Tensor
    to: torch.Tensor
    piece: torch.Tensor  # code on frm
    target: torch.Tensor  # code on to
    placed: torch.Tensor  # code arriving (promotion applied)
    rook: torch.Tensor  # the mover's rook code
    is_pawn: torch.Tensor
    is_king: torch.Tensor
    is_castle: torch.Tensor
    is_ep: torch.Tensor
    capture: torch.Tensor  # takes an enemy piece on `to`
    ep_victim: torch.Tensor  # clipped to 0..63
    king_to: torch.Tensor  # where the mover lands (king's castling square)
    r_dest: torch.Tensor  # castling rook's square


def _move_parts(b: Board, move: torch.Tensor) -> _MoveParts:
    """Decode moves (from | to<<6 | promo<<12, move >= 0) against their
    boards; every tensor is (B,) int32 or bool."""
    c = tables(b.board.device)
    frm = move & 63
    to = (move >> 6) & 63
    promo = move >> 12  # standard-chess encodings carry no drop bit
    piece, target = b.board.gather(1, torch.stack([frm, to], 1).long()).unbind(1)
    us = b.stm
    us6 = 6 * us
    ptype = c.ptype[piece.long()]
    is_pawn = ptype == 0
    is_king = ptype == 5
    rook = T.W_ROOK + us6
    is_castle = is_king & (target == rook)  # king takes own rook
    capture = c.pcolor[target.long()] == 1 - us
    is_ep = is_pawn & (to == b.ep) & (target == 0) & ((to & 7) != (frm & 7))
    ep_victim = (to - 8 + 16 * us).clamp(0, 63)
    placed = torch.where(promo > 0, c.promo_piece[promo.clamp(max=5).long()] + us6, piece)
    rank_base = 56 * us
    kingside = (to > frm).to(torch.int32)
    r_dest = rank_base + 3 + 2 * kingside
    king_to = torch.where(is_castle, rank_base + 2 + 4 * kingside, to)
    return _MoveParts(frm, to, piece, target, placed, rook, is_pawn, is_king,
                      is_castle, is_ep, capture, ep_victim, king_to, r_dest)


def _apply(b: Board, m: _MoveParts) -> Board:
    # clear the origin and the capture-or-castling-rook square, then place
    # (normal: the placed piece on `to`; castle: king and rook, written
    # after the clears, as the reference's sequential writes)
    cleared = torch.where(m.is_castle, m.to, torch.where(m.is_ep, m.ep_victim, m.frm))
    board = b.board.scatter(1, torch.stack([m.frm, cleared], 1).long(), 0)
    place_sq = torch.stack([m.king_to, torch.where(m.is_castle, m.r_dest, m.to)], 1)
    place_val = torch.stack([torch.where(m.is_castle, m.piece, m.placed),
                             torch.where(m.is_castle, m.rook, m.placed)], 1)
    board = board.scatter(1, place_sq.long(), place_val)

    cast = b.castling
    own_slots = tables(cast.device).slot_color == b.stm[:, None]
    gone = ((m.is_king[:, None] & own_slots) | (cast == m.frm[:, None])
            | (cast == m.to[:, None]))
    dbl = m.is_pawn & ((m.to - m.frm).abs() == 16)
    return Board(
        board=board, stm=1 - b.stm,
        ep=torch.where(dbl, (m.frm + m.to) >> 1, -1),
        castling=torch.where(gone, -1, cast),
        halfmove=torch.where(m.is_pawn | m.capture | m.is_ep, 0, b.halfmove + 1),
    )


def _changes(b: Board, m: _MoveParts):
    victim = b.board.gather(1, m.ep_victim[:, None].long())[:, 0]
    c1 = torch.where(m.is_ep, victim, torch.where(m.is_castle | m.capture, m.target, 0))
    codes = torch.stack([m.piece, c1, m.placed, torch.where(m.is_castle, m.rook, 0)], 1)
    sqs = torch.stack([m.frm, torch.where(m.is_ep, m.ep_victim, m.to), m.king_to, m.r_dest], 1)
    signs = tables(b.board.device).signs.expand(b.board.shape[0], 4).contiguous()
    return codes, sqs, signs


def make_move(b: Board, move: torch.Tensor) -> Board:
    """Apply encoded moves (from | to<<6 | promo<<12), one per lane.

    Castling is encoded king-takes-own-rook; en passant and promotion are
    read off the board."""
    return _apply(b, _move_parts(b, move))


def move_piece_changes(b: Board, move: torch.Tensor):
    """The <= 4 piece placements/removals each lane's move causes, as
    fixed slots (codes, squares, signs — each (B, 4) int32; code 0 marks
    an unused slot): [mover out, capture out, mover in, rook in (castle)].
    Feeds the incremental accumulator update."""
    return _changes(b, _move_parts(b, move))


def make_move_with_changes(b: Board, move: torch.Tensor):
    """make_move and move_piece_changes of the same moves, sharing the
    decode → (child Board, codes, sqs, signs)."""
    m = _move_parts(b, move)
    return (_apply(b, m), *_changes(b, m))
