"""Precomputed geometry tables shared by the device movegen and attack query.

Generated with numpy from the same geometry as the host library
(chess/attacks.py), so the two can be property-tested against each other.
All tables use -1 padding for "no square"; ops/ modules turn them into
device tensors once per device.
"""
from __future__ import annotations

import numpy as np

# squares are a1=0 .. h8=63, file = sq & 7, rank = sq >> 3

_KNIGHT_D = [(1, 2), (2, 1), (2, -1), (1, -2), (-1, -2), (-2, -1), (-2, 1), (-1, 2)]
_KING_D = [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1)]
# ray directions: E, N, NE, NW, W, S, SW, SE (0-3 "positive", 4-7 mirror)
RAY_DIRS = [(1, 0), (0, 1), (1, 1), (-1, 1), (-1, 0), (0, -1), (-1, -1), (1, -1)]
BISHOP_DIR_IDS = (2, 3, 6, 7)
ROOK_DIR_IDS = (0, 1, 4, 5)


def _steps(deltas) -> np.ndarray:
    out = np.full((64, len(deltas)), -1, dtype=np.int32)
    for sq in range(64):
        f, r = sq & 7, sq >> 3
        for i, (df, dr) in enumerate(deltas):
            nf, nr = f + df, r + dr
            if 0 <= nf < 8 and 0 <= nr < 8:
                out[sq, i] = nr * 8 + nf
    return out


KNIGHT_TARGETS = _steps(_KNIGHT_D)  # (64, 8)
KING_TARGETS = _steps(_KING_D)  # (64, 8)

# PAWN_CAPTURES[color, sq, i]: squares a pawn of `color` on sq attacks
PAWN_CAPTURES = np.stack(
    [_steps([(-1, 1), (1, 1)]), _steps([(-1, -1), (1, -1)])]
)  # (2, 64, 2)


def _rays() -> np.ndarray:
    out = np.full((64, 8, 7), -1, dtype=np.int32)
    for sq in range(64):
        f, r = sq & 7, sq >> 3
        for d, (df, dr) in enumerate(RAY_DIRS):
            nf, nr = f + df, r + dr
            i = 0
            while 0 <= nf < 8 and 0 <= nr < 8:
                out[sq, d, i] = nr * 8 + nf
                nf += df
                nr += dr
                i += 1
    return out


RAYS = _rays()  # (64, 8, 7): ray squares from sq (exclusive), -1 padded

# piece codes on the device board: 0 empty, 1-6 white PNBRQK, 7-12 black
EMPTY = 0
W_PAWN, W_KNIGHT, W_BISHOP, W_ROOK, W_QUEEN, W_KING = 1, 2, 3, 4, 5, 6
B_PAWN, B_KNIGHT, B_BISHOP, B_ROOK, B_QUEEN, B_KING = 7, 8, 9, 10, 11, 12

# SLIDER_MASK[dir, piece_code]: does piece_code slide along dir?
SLIDER_MASK = np.zeros((8, 13), dtype=bool)
for d in range(8):
    for code, is_rook_like, is_bishop_like in (
        (W_ROOK, True, False), (B_ROOK, True, False),
        (W_BISHOP, False, True), (B_BISHOP, False, True),
        (W_QUEEN, True, True), (B_QUEEN, True, True),
    ):
        if (d in ROOK_DIR_IDS and is_rook_like) or (d in BISHOP_DIR_IDS and is_bishop_like):
            SLIDER_MASK[d, code] = True

# move encoding: from | to<<6 | promo<<12 (promo 0 none, 1-4 = N B R Q,
# 5 = K — antichess promotes to king)
PROMO_NONE, PROMO_N, PROMO_B, PROMO_R, PROMO_Q, PROMO_K = 0, 1, 2, 3, 4, 5
PROMO_TO_PIECE = np.array([0, 2, 3, 4, 5, 6], dtype=np.int32)  # white codes; +6 black

MAX_MOVES = 224  # fixed per-ply move-list capacity (max legal known is 218)


def encode_move(from_sq: int, to_sq: int, promo: int = 0) -> int:
    return from_sq | (to_sq << 6) | (promo << 12)


def decode_move(m: int):
    return m & 63, (m >> 6) & 63, (m >> 12) & 7
