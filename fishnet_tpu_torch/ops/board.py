"""Device board representation, rules and move making, batched over lanes.

A copy of the JAX package's ops/board.py for standard chess, chess960
and the variants threeCheck, kingOfTheHill, racingKings, horde, atomic,
antichess and crazyhouse, written with the lane dimension spelled out:
every function takes (B, …) tensors where the reference took one lane
under `vmap`. The variant is a static argument (a name of VARIANT_ID),
as the reference's; any other name is refused (`variant_id`).

Board tensors (one row per lane):
  board:    (B, 64) int32 piece codes (tables.py: 0 empty, 1-6 white, 7-12 black)
  stm:      (B,) int32, 0 white / 1 black
  ep:       (B,) int32, en-passant target square or -1
  castling: (B, 4) int32 rook squares with castling rights, -1 if gone,
            order [white-kingside, white-queenside, black-kingside,
            black-queenside] (chess960-ready: actual rook squares)
  halfmove: (B,) int32
  extra:    (B, 12) int32 variant side-state (EXTRA_* below), zeros but
            for threeCheck's check counters and crazyhouse's pockets and
            promoted-piece bits

The search keeps boards as packed int32 rows (`BT_*` below); a Board of
views into such rows is what the step passes around.

On a CUDA tensor, `node_rules` launches K8 and `make_move_rows` launches
K10 (csrc/board.cuh, bound by kernels.py); `in_check` and the Board forms
of make-move (`make_move_with_changes`, `make_move`, `move_piece_changes`)
reach the kernels only through those two. On a CPU tensor they run the
plain versions below (`*_plain`). The plain versions keep their call
count low: square tables index a board padded with one empty off-board
square (index 64, where the reference's tables hold -1), and piece
attributes are read from small lookup tables.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..chess.position import Position
from ..chess.types import scan
from . import tables as T
from .tables import VARIANT_ID

OFF = 64  # the padded board's empty off-board square

# the search's packed board row (int32): the 64 codes, side to move, ep
# square, castling rooks, halfmove clock, the variant side-state (Board's
# extra) and the path-hash words the step writes
BT_BOARD = 0
BT_STM = 64
BT_EP = 65
BT_CAST = 66
BT_HM = 70
BT_EXTRA = 71  # variant side-state, EXTRA_W words
BT_PH1 = 83  # path-hash words (uint32 bits as int32)
BT_PH2 = 84
BT_W = 96

# the variant side-state's layout (the reference's): threeCheck's checks
# delivered by white and by black at EXTRA_CHECKS + color; crazyhouse's
# pocket counts at EXTRA_POCKET + color * 5 + piece type (P N B R Q) and
# its promoted-piece bitboard in two words at EXTRA_PROMOTED (square sq's
# bit is bit sq % 32 of word sq // 32, as int32 bit patterns)
EXTRA_W = 12
EXTRA_CHECKS = 0
EXTRA_POCKET = 0
EXTRA_PROMOTED = 10
POCKET_TYPES = 5  # droppable piece types, P N B R Q
THREE_CHECKS = 3  # checks that end a threeCheck game

# variant-terminal kinds of node_rules, from the side to move's view
TERM_NONE, TERM_LOSS, TERM_WIN, TERM_DRAW = 0, 1, 2, 3
HILL = (27, 28, 35, 36)  # kingOfTheHill's centre: d4 e4 d5 e5
GOAL_RANK_FROM = 56  # racingKings: a king on a square >= this is on the goal rank


def variant_id(variant: str) -> int:
    """The device id of a device variant; raises NotImplementedError for
    any other name."""
    if variant not in VARIANT_ID:
        raise NotImplementedError(f"{variant!r} is not a device variant")
    return VARIANT_ID[variant]

# castling destinations by [color * 2 + side] (side 0 kingside, 1
# queenside): the king lands on the g/c file, the rook on the f/d file
CASTLE_KING_TO = np.array([6, 2, 62, 58], np.int32)
CASTLE_ROOK_TO = np.array([5, 3, 61, 59], np.int32)
CASTLE_SLOT_COLOR = np.array([0, 0, 1, 1], np.int32)  # castling slot → color
CHANGE_SIGNS = np.array([-1, -1, 1, 1], np.int32)  # move_piece_changes slot signs


class Board(NamedTuple):
    board: torch.Tensor  # (B, 64) int32
    stm: torch.Tensor  # (B,) int32
    ep: torch.Tensor  # (B,) int32
    castling: torch.Tensor  # (B, 4) int32
    halfmove: torch.Tensor  # (B,) int32
    extra: torch.Tensor  # (B, EXTRA_W) int32

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
    """Host Position → one-lane Board of CPU tensors (batch dim 1). A
    variant without castling (antichess, racingKings) carries no rights,
    whatever its FEN says; threeCheck's counters and crazyhouse's pockets
    and promoted bits go into extra."""
    castling = np.full(4, -1, dtype=np.int32)
    for color in (0, 1) if pos.has_castling else ():
        ksq = pos.king_sq(color)
        back = 0xFF if color == 0 else 0xFF << 56
        for rsq in scan(pos.castling & back):
            if ksq is None:
                continue
            side = 0 if rsq > ksq else 1
            castling[color * 2 + side] = rsq
    extra = np.zeros(EXTRA_W, dtype=np.int32)
    if pos.variant == "threeCheck":
        extra[EXTRA_CHECKS:EXTRA_CHECKS + 2] = pos.checks_given
    elif pos.variant == "crazyhouse":
        extra[EXTRA_POCKET:EXTRA_POCKET + 2 * POCKET_TYPES] = np.ravel(pos.pockets)
        words = [(pos.promoted >> (32 * w)) & 0xFFFFFFFF for w in (0, 1)]
        extra[EXTRA_PROMOTED:EXTRA_PROMOTED + 2] = np.array(words, np.uint32).view(np.int32)
    i32 = torch.int32
    return Board(
        board=torch.from_numpy(board_array(pos))[None],
        stm=torch.tensor([pos.turn], dtype=i32),
        ep=torch.tensor([pos.ep_square if pos.ep_square is not None else -1], dtype=i32),
        castling=torch.from_numpy(castling)[None],
        halfmove=torch.tensor([pos.halfmove], dtype=i32),
        extra=torch.from_numpy(extra)[None],
    )


def board_from_rows(rows: torch.Tensor) -> Board:
    """(B, BT_W) packed rows → a Board of views into them."""
    return Board(
        board=rows[:, BT_BOARD:BT_BOARD + 64], stm=rows[:, BT_STM],
        ep=rows[:, BT_EP], castling=rows[:, BT_CAST:BT_CAST + 4],
        halfmove=rows[:, BT_HM], extra=rows[:, BT_EXTRA:BT_EXTRA + EXTRA_W],
    )


def rows_from_board(b: Board) -> torch.Tensor:
    """(B, BT_W) rows; path-hash words zero."""
    B = b.board.shape[0]
    z = torch.zeros((B, BT_W - BT_EXTRA - EXTRA_W), dtype=torch.int32, device=b.board.device)
    return torch.cat([
        b.board.to(torch.int32), b.stm.to(torch.int32)[:, None],
        b.ep.to(torch.int32)[:, None], b.castling.to(torch.int32),
        b.halfmove.to(torch.int32)[:, None], b.extra.to(torch.int32), z,
    ], 1)


def stack_boards(boards) -> Board:
    """Sequence of Boards → one Board with their lanes concatenated."""
    return Board(*[torch.cat([getattr(b, f) for b in boards]) for f in Board._fields])


def pad_squares(a) -> np.ndarray:
    """Square table with -1 for "no square" → the padded board's OFF."""
    a = np.asarray(a, np.int64)
    return np.where(a >= 0, a, OFF)


_CODES = np.arange(13)
PIECE_TYPE = np.where(_CODES == 0, -1, (_CODES - 1) % 6)  # per code, -1 empty
PIECE_COLOR = np.where(_CODES == 0, -1, np.where(_CODES <= 6, 0, 1))


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
    castle_king_to: torch.Tensor  # (4,) int32 [color * 2 + side]
    castle_rook_to: torch.Tensor  # (4,) int32 [color * 2 + side]


@lru_cache(maxsize=None)
def tables(device: torch.device) -> _Tables:
    """The geometry and piece tables as tensors on one device."""
    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return _Tables(
        ptype=t(PIECE_TYPE, torch.int32), pcolor=t(PIECE_COLOR, torch.int32),
        rays=t(pad_squares(T.RAYS)), rvalid=t(T.RAYS >= 0, torch.bool),
        slide_dir=t(T.SLIDER_MASK.T.reshape(-1), torch.bool),
        dirs=t(np.arange(8)[:, None]),
        knight=t(pad_squares(T.KNIGHT_TARGETS)), king=t(pad_squares(T.KING_TARGETS)),
        # white pawns attacking sq sit where a black pawn on sq would attack
        pawn_w=t(pad_squares(T.PAWN_CAPTURES[1])), pawn_b=t(pad_squares(T.PAWN_CAPTURES[0])),
        sq=t(np.arange(64), torch.int32), promo_piece=t(T.PROMO_TO_PIECE, torch.int32),
        step_bit=t(1 << np.arange(7), torch.int16),
        below=t((1 << np.arange(7)) - 1, torch.int16),
        slot_color=t(CASTLE_SLOT_COLOR[None], torch.int32),
        signs=t(CHANGE_SIGNS[None], torch.int32),
        castle_king_to=t(CASTLE_KING_TO, torch.int32),
        castle_rook_to=t(CASTLE_ROOK_TO, torch.int32),
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
    """(B,) bool: the side to move is in check (standard node_rules'
    `checked`)."""
    return node_rules(b)[1]


def node_rules_plain(b: Board, r: Rays | None = None, attacks=None,
                     variant: str = "standard"):
    """K8's plain version: per-node legality and the variant's game end
    → (parent_illegal (B,) bool: the move that led here broke the mover's
    duty — left its king en prise or lost it, or gave check in
    racingKings; checked (B,) bool: the side to move is in check;
    term_kind (B,) int32: TERM_* by the variant's rule at this node, from
    the side to move's view). In atomic the duty is the mover's king's
    survival and its safety unless the kings stand adjacent (a capture
    would explode both), and an exploded king of the side to move ends
    the game (a loss, even if the mover's king exploded too). attacks:
    attack_parts(r) when the caller already has it."""
    variant_id(variant)
    if attacks is None:
        attacks = attack_parts(rays_of(b.board) if r is None else r)
    slider_w, slider_b, other_w, other_b = attacks
    us = b.stm
    white = (us == 0)[:, None]
    att_us = torch.where(white, slider_w | other_w, slider_b | other_b)
    att_them = torch.where(white, slider_b | other_b, slider_w | other_w)
    our_king = b.board == (T.W_KING + 6 * us)[:, None]
    their_king = b.board == (T.B_KING - 6 * us)[:, None]
    self_check = ~their_king.any(1) | (att_us & their_king).any(1)
    checked = (att_them & our_king).any(1)
    term = torch.zeros_like(us, dtype=torch.int32)
    if variant == "antichess":
        # no check concept, kings are ordinary pieces; running out of
        # moves or pieces wins, at the move's exhaustion (search.py)
        return torch.zeros_like(checked), torch.zeros_like(checked), term
    if variant == "atomic":
        our_k, their_k = king_square(b.board, us), king_square(b.board, 1 - us)
        # the kings a king step apart: our king on one of the mover's
        # king's targets (padded with OFF, which no king stands on)
        near = tables(b.board.device).king[their_k.clamp(min=0).long()] == our_k[:, None]
        adj = (our_k >= 0) & (their_k >= 0) & near.any(1)
        lost = our_k < 0
        illegal = ~lost & ((their_k < 0) | ((att_us & their_king).any(1) & ~adj))
        return illegal, checked & ~adj, torch.where(lost, TERM_LOSS, term)
    if variant == "horde":
        # white is the kingless horde: no duty or check for white; the
        # horde loses once it has no piece left
        white_dead = ~(tables(b.board.device).pcolor[b.board.long()] == 0).any(1)
        term = torch.where((us == 0) & white_dead, TERM_LOSS, term)
        return self_check & (us == 0), checked & (us == 1), term
    if variant == "kingOfTheHill":
        their_k = king_square(b.board, 1 - us)
        hill = torch.zeros_like(checked)
        for sq in HILL:
            hill = hill | (their_k == sq)
        return self_check, checked, torch.where(hill, TERM_LOSS, term)  # the mover's king arrived
    if variant == "racingKings":
        our8 = king_square(b.board, us) >= GOAL_RANK_FROM
        their8 = king_square(b.board, 1 - us) >= GOAL_RANK_FROM
        # giving check is illegal; white moves first, so black gets one
        # rejoinder: white on the goal wins once white is to move again,
        # black on the goal wins at once, both kings there draw
        term = torch.where(
            our8 & their8, TERM_DRAW,
            torch.where(their8 & (us == 0), TERM_LOSS,
                        torch.where(our8 & (us == 0), TERM_WIN, term)))
        return self_check | checked, torch.zeros_like(checked), term
    if variant == "threeCheck":
        them_checks = torch.where(us == 0, b.extra[:, EXTRA_CHECKS + 1], b.extra[:, EXTRA_CHECKS])
        term = torch.where(them_checks >= THREE_CHECKS, TERM_LOSS, term)
    return self_check, checked, term


def node_rules(b: Board, r: Rays | None = None, attacks=None, variant: str = "standard"):
    """→ (parent_illegal, checked, term_kind), (B,) bools and int32: K8
    for CUDA tensors (the board fields may be views of packed rows), the
    plain version for CPU tensors, which may share the caller's ray view
    r and attack_parts(r)."""
    if b.board.device.type == "cpu":
        return node_rules_plain(b, r, attacks, variant)
    return kernels.node_rules(b.board, b.stm, b.extra, variant)


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
    promo: torch.Tensor  # the promotion code, or a drop's piece type
    drop: torch.Tensor | None  # a crazyhouse drop (None in the other variants)


def _move_parts(b: Board, move: torch.Tensor, variant: str = "standard") -> _MoveParts:
    """Decode moves (from | to<<6 | promo<<12, move >= 0; in crazyhouse
    also drops, DROP_FLAG | type<<12 | to<<6 | to) against their boards;
    every tensor is (B,) int32 or bool. A drop moves no piece of the
    board: it is no pawn or king move, no castling and no capture, and it
    places its piece type (0-4, P..Q) of the mover's color."""
    c = tables(b.board.device)
    frm = move & 63
    to = (move >> 6) & 63
    drop = None
    if variant == "crazyhouse":
        drop = ((move >> 15) & 1) == 1
        promo = (move >> 12) & 7
    else:  # the other variants' encodings carry no drop bit
        promo = move >> 12
    piece, target = b.board.gather(1, torch.stack([frm, to], 1).long()).unbind(1)
    us = b.stm
    us6 = 6 * us
    ptype = c.ptype[piece.long()]
    is_pawn = ptype == 0
    is_king = ptype == 5
    rook = T.W_ROOK + us6
    is_castle = is_king & (target == rook)  # king takes own rook
    if drop is not None:
        is_pawn, is_king, is_castle = is_pawn > drop, is_king > drop, is_castle > drop
    capture = c.pcolor[target.long()] == 1 - us
    is_ep = is_pawn & (to == b.ep) & (target == 0) & ((to & 7) != (frm & 7))
    ep_victim = (to - 8 + 16 * us).clamp(0, 63)
    placed = torch.where(promo > 0, c.promo_piece[promo.clamp(max=5).long()] + us6, piece)
    if drop is not None:
        placed = torch.where(drop, T.W_PAWN + promo.clamp(max=POCKET_TYPES - 1) + us6, placed)
    slot = (2 * us + (to <= frm)).long()  # [color * 2 + side], 0 kingside
    r_dest = c.castle_rook_to[slot]
    king_to = torch.where(is_castle, c.castle_king_to[slot], to)
    return _MoveParts(frm, to, piece, target, placed, rook, is_pawn, is_king,
                      is_castle, is_ep, capture, ep_victim, king_to, r_dest, promo, drop)


def _apply(b: Board, m: _MoveParts, variant: str = "standard") -> Board:
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
    touched = (cast == m.frm[:, None]) | (cast == m.to[:, None])
    if m.drop is not None:  # a drop touches no castling rook
        touched = touched > m.drop[:, None]
    gone = (m.is_king[:, None] & own_slots) | touched
    cast = torch.where(gone, -1, cast)
    if variant == "atomic":
        board, cast = _explode(board, cast, m)
    dbl = m.is_pawn & ((m.to - m.frm).abs() == 16)
    if variant == "horde":  # the horde's back-rank doubles set no ep square
        dbl = dbl & ~((b.stm == 0) & ((m.frm >> 3) == 0))
    extra = b.extra
    if variant == "threeCheck":
        # the mover's check, if the move gave one: +1 on its counter
        them = 1 - b.stm
        ek = king_square(board, them)
        gave = (ek >= 0) & is_attacked(board, ek.clamp(min=0), b.stm)
        extra = extra.scatter_add(1, (EXTRA_CHECKS + b.stm).long()[:, None],
                                  gave.to(torch.int32)[:, None])
    pawnish = m.is_pawn
    if variant == "crazyhouse":
        pawnish = pawnish | (m.drop & (m.promo == 0))  # a pawn drop resets the clock
        extra = _crazyhouse_extra(b, m)
    return Board(
        board=board, stm=1 - b.stm,
        ep=torch.where(dbl, (m.frm + m.to) >> 1, -1),
        castling=cast,
        halfmove=torch.where(pawnish | m.capture | m.is_ep, 0, b.halfmove + 1),
        extra=extra,
    )


def _explode(board: torch.Tensor, cast: torch.Tensor, m: _MoveParts):
    """Atomic's blast after a capture (en passant included) → (board,
    castling): the capturer and every non-pawn on the landing square or a
    king step from it are removed, and a castling slot loses its rook
    where the blast reached the rook's square, and every slot of a side
    whose king it took (the reference's make_move). The zone is read by
    comparison with the landing square's king targets, padded with OFF,
    which no square equals, so a pad never stands for a1."""
    c = tables(board.device)
    capture = (m.capture | m.is_ep)[:, None]
    zone = (c.sq[None, :, None] == c.king[m.to.long()][:, None]).any(2)
    zone = zone | (c.sq[None] == m.to[:, None])  # (B, 64)
    blown = zone & ((c.ptype[board.long()] != 0) | (c.sq[None] == m.to[:, None]))
    board = torch.where(capture & blown, 0, board)
    rook_hit = zone.gather(1, cast.clamp(0, 63).long()) & (cast >= 0)
    alive = torch.stack([(board == T.W_KING).any(1), (board == T.B_KING).any(1)], 1)
    slot_alive = alive.gather(1, c.slot_color.long().expand_as(cast))
    cast = torch.where(capture & (rook_hit | ~slot_alive), -1, cast)
    return board, cast


def _crazyhouse_extra(b: Board, m: _MoveParts) -> torch.Tensor:
    """The child's crazyhouse words (the reference's make_move): the
    mover's pocket gains the piece it captured (a promoted one as a pawn)
    and pays for a drop; the promoted bits leave the origin and the
    captured piece's square, and the destination takes one if the
    arriving piece is a fresh promotion or a promoted piece moving on."""
    c = tables(b.board.device)
    us = b.stm
    words = b.extra[:, EXTRA_PROMOTED:EXTRA_PROMOTED + 2].long()
    promoted = (words[:, 0] & 0xFFFFFFFF) | (words[:, 1] << 32)  # int64 bitboard

    def bit(sq):
        return ((promoted >> sq.long()) & 1) == 1

    cap_sq = torch.where(m.is_ep, m.ep_victim, m.to)
    victim = b.board.gather(1, cap_sq[:, None].long())[:, 0]
    real_capture = (m.capture | m.is_ep) > (m.is_castle | m.drop)
    cap_type = torch.where(bit(cap_sq) & real_capture, 0, c.ptype[victim.long()].clamp(min=0))
    pockets = b.extra[:, EXTRA_POCKET:EXTRA_POCKET + 2 * POCKET_TYPES]
    slot = EXTRA_POCKET + us * POCKET_TYPES
    pockets = pockets.scatter_add(
        1, torch.stack([slot + cap_type.clamp(max=POCKET_TYPES - 1),
                        slot + m.promo.clamp(0, POCKET_TYPES - 1)], 1).long(),
        torch.stack([real_capture.to(torch.int32), -m.drop.to(torch.int32)], 1))
    dest = ((m.promo > 0) | bit(m.frm)) > m.drop
    one = torch.ones_like(promoted)
    promoted = promoted & ~(one << m.frm.long())
    promoted = torch.where(real_capture, promoted & ~(one << cap_sq.long()), promoted)
    promoted = (promoted & ~(one << m.to.long())) | (dest.long() << m.to.long())
    lo = ((promoted << 32) >> 32).to(torch.int32)  # the low word's bits, sign-extended
    hi = (promoted >> 32).to(torch.int32)
    return torch.cat([pockets, lo[:, None], hi[:, None]], 1)


def _changes(b: Board, m: _MoveParts):
    victim = b.board.gather(1, m.ep_victim[:, None].long())[:, 0]
    c1 = torch.where(m.is_ep, victim, torch.where(m.is_castle | m.capture, m.target, 0))
    c0 = m.piece if m.drop is None else torch.where(m.drop, 0, m.piece)  # a drop leaves nothing
    codes = torch.stack([c0, c1, m.placed, torch.where(m.is_castle, m.rook, 0)], 1)
    sqs = torch.stack([m.frm, torch.where(m.is_ep, m.ep_victim, m.to), m.king_to, m.r_dest], 1)
    signs = tables(b.board.device).signs.expand(b.board.shape[0], 4).contiguous()
    return codes, sqs, signs


def make_move_with_changes_plain(b: Board, move: torch.Tensor, variant: str = "standard"):
    """K10's plain version: make_move and move_piece_changes of the same
    moves, sharing the decode → (child Board, codes, sqs, signs)."""
    variant_id(variant)
    m = _move_parts(b, move, variant)
    return (_apply(b, m, variant), *_changes(b, m))


def make_move_with_changes(b: Board, move: torch.Tensor, variant: str = "standard"):
    """Apply encoded moves (from | to<<6 | promo<<12, move >= 0; in
    crazyhouse also drops, DROP_FLAG | type<<12 | to<<6 | to), one per
    lane → (child Board, codes, sqs, signs).

    Castling is encoded king-takes-own-rook; en passant and promotion are
    read off the board. codes, sqs, signs (B, 4) int32 are the <= 4 piece
    placements/removals each move causes, as fixed slots (code 0 marks an
    unused slot): [mover out, capture out, mover in, rook in (castle)];
    they feed the incremental accumulator update (a crazyhouse drop fills
    one slot, the piece arriving; the other variants change the pieces as
    standard chess does: in atomic the slots leave out the blast, and the
    search never applies them there, as the reference's never does). The child's extra words are the
    parent's, with threeCheck's counter of the mover raised when the move
    gives check, and crazyhouse's pockets and promoted bits moved with
    the pieces (_crazyhouse_extra). K10 through make_move_rows for
    CUDA tensors (the child is then a Board of views into packed rows),
    the plain version for CPU tensors."""
    if b.board.device.type == "cpu":
        return make_move_with_changes_plain(b, move, variant)
    rows, codes, sqs, signs = make_move_rows(rows_from_board(b), move, variant)
    return board_from_rows(rows), codes, sqs, signs


def make_move_rows_plain(rows: torch.Tensor, move: torch.Tensor, variant: str = "standard"):
    """K10's plain version in the packed row layout: the plain child,
    packed."""
    child, *changes = make_move_with_changes_plain(board_from_rows(rows), move, variant)
    return (rows_from_board(child), *changes)


def make_move_rows(rows: torch.Tensor, move: torch.Tensor, variant: str = "standard"):
    """make_move_with_changes on packed board rows (B, BT_W) → (child
    rows (B, BT_W) with zero path-hash words, codes, sqs, signs). K10
    writes the child rows directly on the card."""
    if rows.device.type == "cpu":
        return make_move_rows_plain(rows, move, variant)
    return kernels.make_move(*board_from_rows(rows), move, variant)


def make_move(b: Board, move: torch.Tensor, variant: str = "standard") -> Board:
    """The child boards of make_move_with_changes."""
    return make_move_with_changes(b, move, variant)[0]


def move_piece_changes(b: Board, move: torch.Tensor, variant: str = "standard"):
    """The (codes, sqs, signs) slots of make_move_with_changes."""
    return make_move_with_changes(b, move, variant)[1:]
