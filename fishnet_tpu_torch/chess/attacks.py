"""Precomputed attack tables (classical ray approach).

These tables are the host-side mirror of the device-side attack tensors in
ops/tables.py; both are generated from the same geometry so the batched
device movegen can be property-tested against this library.
"""
from __future__ import annotations

from .types import bb, lsb, msb, square, square_file, square_rank

# Direction deltas as (df, dr)
_KNIGHT_D = [(1, 2), (2, 1), (2, -1), (1, -2), (-1, -2), (-2, -1), (-2, 1), (-1, 2)]
_KING_D = [(1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1)]
_BISHOP_D = [(1, 1), (-1, 1), (-1, -1), (1, -1)]
_ROOK_D = [(1, 0), (0, 1), (-1, 0), (0, -1)]


def _step_table(deltas):
    table = [0] * 64
    for sq in range(64):
        f, r = square_file(sq), square_rank(sq)
        mask = 0
        for df, dr in deltas:
            nf, nr = f + df, r + dr
            if 0 <= nf < 8 and 0 <= nr < 8:
                mask |= bb(square(nf, nr))
        table[sq] = mask
    return table


KNIGHT_ATTACKS = _step_table(_KNIGHT_D)
KING_ATTACKS = _step_table(_KING_D)

# PAWN_ATTACKS[color][sq] = squares attacked by a pawn of `color` on sq
PAWN_ATTACKS = [
    _step_table([(-1, 1), (1, 1)]),   # white attacks up
    _step_table([(-1, -1), (1, -1)]),  # black attacks down
]


def _ray_table():
    """RAYS[dir][sq]: open-board ray from sq (exclusive) in direction dir.

    Directions 0-3 are "positive" (increasing square index): E, N, NE, NW... we
    order so that dirs 0..3 go toward higher square indices and 4..7 lower, so
    blocker cutting uses lsb for 0..3 and msb for 4..7.
    """
    dirs = [(1, 0), (0, 1), (1, 1), (-1, 1), (-1, 0), (0, -1), (-1, -1), (1, -1)]
    rays = [[0] * 64 for _ in range(8)]
    for d, (df, dr) in enumerate(dirs):
        for sq in range(64):
            f, r = square_file(sq), square_rank(sq)
            mask = 0
            nf, nr = f + df, r + dr
            while 0 <= nf < 8 and 0 <= nr < 8:
                mask |= bb(square(nf, nr))
                nf += df
                nr += dr
            rays[d][sq] = mask
    return rays


RAYS = _ray_table()
_POSITIVE_DIRS = (0, 1, 2, 3)  # E, N, NE, NW — ray squares all above sq
_NEGATIVE_DIRS = (4, 5, 6, 7)  # W, S, SW, SE — ray squares all below sq
_ROOK_DIRS = (0, 1, 4, 5)
_BISHOP_DIRS = (2, 3, 6, 7)

# BETWEEN[a][b]: squares strictly between a and b if aligned, else 0
BETWEEN = [[0] * 64 for _ in range(64)]
# LINE[a][b]: full line through a and b (incl. both) if aligned, else 0
LINE = [[0] * 64 for _ in range(64)]
for _a in range(64):
    for _d in range(8):
        ray = RAYS[_d][_a]
        for _b in range(64):
            if ray & bb(_b):
                opp = (_d + 4) % 8
                BETWEEN[_a][_b] = ray & RAYS[opp][_b]
                LINE[_a][_b] = (ray | bb(_a)) | (RAYS[opp][_a] & (RAYS[opp][_b] | bb(_b))) | (RAYS[_d][_b])
                LINE[_a][_b] |= bb(_b)


def _slider_attacks(sq: int, occ: int, dirs) -> int:
    att = 0
    for d in dirs:
        ray = RAYS[d][sq]
        blockers = ray & occ
        if blockers:
            first = lsb(blockers) if d in _POSITIVE_DIRS else msb(blockers)
            ray &= ~RAYS[d][first]
        att |= ray
    return att


def rook_attacks(sq: int, occ: int) -> int:
    return _slider_attacks(sq, occ, _ROOK_DIRS)


def bishop_attacks(sq: int, occ: int) -> int:
    return _slider_attacks(sq, occ, _BISHOP_DIRS)


def queen_attacks(sq: int, occ: int) -> int:
    return _slider_attacks(sq, occ, _ROOK_DIRS) | _slider_attacks(sq, occ, _BISHOP_DIRS)
