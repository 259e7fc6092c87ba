"""Core chess types: colors, pieces, squares, moves.

Host-side rules library filling the role shakmaty plays in the reference
client (reference: src/queue.rs:554-581 replays every UCI move to validate
server input). Square indexing is a1=0 .. h8=63 (little-endian rank-file).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

WHITE = 0
BLACK = 1
COLORS = (WHITE, BLACK)

PAWN = 0
KNIGHT = 1
BISHOP = 2
ROOK = 3
QUEEN = 4
KING = 5
PIECE_TYPES = (PAWN, KNIGHT, BISHOP, ROOK, QUEEN, KING)

PIECE_CHARS = "pnbrqk"

FILES = "abcdefgh"
RANKS = "12345678"

FULL_BB = (1 << 64) - 1


def square(file: int, rank: int) -> int:
    return rank * 8 + file


def square_file(sq: int) -> int:
    return sq & 7


def square_rank(sq: int) -> int:
    return sq >> 3


def square_name(sq: int) -> str:
    return FILES[sq & 7] + RANKS[sq >> 3]


def parse_square(name: str) -> int:
    if len(name) != 2 or name[0] not in FILES or name[1] not in RANKS:
        raise ValueError(f"invalid square: {name!r}")
    return square(FILES.index(name[0]), RANKS.index(name[1]))


def bb(sq: int) -> int:
    return 1 << sq


def lsb(b: int) -> int:
    """Index of least significant set bit."""
    return (b & -b).bit_length() - 1


def msb(b: int) -> int:
    return b.bit_length() - 1


def popcount(b: int) -> int:
    return bin(b).count("1")


def scan(b: int):
    """Iterate square indices of set bits, low to high."""
    while b:
        s = (b & -b).bit_length() - 1
        yield s
        b &= b - 1


def piece_char(color: int, ptype: int) -> str:
    c = PIECE_CHARS[ptype]
    return c.upper() if color == WHITE else c


def parse_piece_char(c: str) -> tuple[int, int]:
    """Return (color, piece_type) for a FEN piece letter."""
    lower = c.lower()
    if lower not in PIECE_CHARS:
        raise ValueError(f"invalid piece: {c!r}")
    return (WHITE if c.isupper() else BLACK, PIECE_CHARS.index(lower))


@dataclass(frozen=True)
class Move:
    """A chess move.

    Castling is always encoded internally as king-takes-own-rook
    (from=king square, to=rook square), matching UCI_Chess960 semantics —
    the reference always runs engines with UCI_Chess960=true
    (reference: src/stockfish.rs:200). `drop` is a piece type for
    crazyhouse drops (UCI "P@e4"). `promotion` is a piece type or None.
    """

    from_sq: int
    to_sq: int
    promotion: Optional[int] = None
    drop: Optional[int] = None

    def uci(self, chess960: bool = True) -> str:
        if self.drop is not None:
            return PIECE_CHARS[self.drop].upper() + "@" + square_name(self.to_sq)
        s = square_name(self.from_sq) + square_name(self.to_sq)
        if self.promotion is not None:
            s += PIECE_CHARS[self.promotion]
        return s

    @staticmethod
    def parse_uci(s: str) -> "Move":
        if "@" in s:
            pc, sq = s.split("@", 1)
            color, ptype = parse_piece_char(pc)
            return Move(0, parse_square(sq), drop=ptype)
        if len(s) not in (4, 5):
            raise ValueError(f"invalid uci move: {s!r}")
        frm = parse_square(s[0:2])
        to = parse_square(s[2:4])
        promo = None
        if len(s) == 5:
            if s[4] not in PIECE_CHARS:
                raise ValueError(f"invalid promotion: {s!r}")
            promo = PIECE_CHARS.index(s[4])
        return Move(frm, to, promotion=promo)

    def __str__(self) -> str:
        return self.uci()
