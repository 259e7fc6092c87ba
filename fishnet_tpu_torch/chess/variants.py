"""Lichess variant rules, host side: FEN parsing, move replay, legality
and game outcome for the variants this package analyses.

A copy of the JAX package's chess/variants.py for threeCheck,
kingOfTheHill, racingKings, horde, atomic, antichess and crazyhouse (the
reference client analyses them with Fairy-Stockfish: src/logger.rs:201-213
short names, src/queue.rs:562-568). The device search implements the same
rules (ops/board.py node_rules and make_move, ops/movegen.py); these
classes validate the chunk's input, replay its moves and decide terminal
roots. `VARIANTS` names every variant the reference runs on its device.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from .attacks import KING_ATTACKS
from .position import (
    RANK_1,
    RANK_2,
    RANK_7,
    RANK_8,
    Chess960Position,
    InvalidFenError,
    Position,
)
from .types import (
    BLACK,
    FULL_BB,
    KING,
    KNIGHT,
    BISHOP,
    PAWN,
    QUEEN,
    ROOK,
    WHITE,
    Move,
    bb,
    lsb,
    popcount,
    scan,
    square_rank,
)


class ThreeCheckPosition(Position):
    variant = "threeCheck"

    def __init__(self) -> None:
        super().__init__()
        self.checks_given = [0, 0]

    @classmethod
    def starting_fen(cls) -> str:
        return "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 3+3 0 1"

    def _parse_checks_field(self, field: str) -> None:
        # "3+3" = remaining checks; "+0+0" = checks already given
        if field.startswith("+"):
            parts = field[1:].split("+")
            if len(parts) != 2:
                raise InvalidFenError(f"bad check field {field!r}")
            self.checks_given = [int(parts[0]), int(parts[1])]
        else:
            parts = field.split("+")
            if len(parts) != 2:
                raise InvalidFenError(f"bad check field {field!r}")
            self.checks_given = [3 - int(parts[0]), 3 - int(parts[1])]

    def _fen_extra(self) -> Optional[str]:
        cg = self.checks_given or [0, 0]
        return f"{3 - cg[WHITE]}+{3 - cg[BLACK]}"

    def _post_turn_hook(self, prev_turn: int) -> None:
        if self.is_check():
            self.checks_given[prev_turn] += 1

    def _variant_outcome(self) -> Optional[Tuple[Optional[int], str]]:
        for color in (WHITE, BLACK):
            if self.checks_given[color] >= 3:
                return (color, "three checks")
        return None


class KingOfTheHillPosition(Position):
    variant = "kingOfTheHill"

    CENTER = bb(27) | bb(28) | bb(35) | bb(36)  # d4 e4 d5 e5

    def _variant_outcome(self) -> Optional[Tuple[Optional[int], str]]:
        for color in (WHITE, BLACK):
            if self.bbs[color][KING] & self.CENTER:
                return (color, "king in the center")
        return None


class RacingKingsPosition(Position):
    variant = "racingKings"
    has_castling = False

    @classmethod
    def starting_fen(cls) -> str:
        return "8/8/8/8/8/8/krbnNBRK/qrbnNBRQ w - - 0 1"

    def _validate(self) -> None:
        for color in (WHITE, BLACK):
            if popcount(self.bbs[color][KING]) != 1:
                raise InvalidFenError("each side needs exactly one king")
        if self.is_check():
            raise InvalidFenError("racingKings positions can never have a check")

    def legal_moves(self) -> List[Move]:
        moves = []
        for move in self.generate_pseudo_legal():
            if not self._move_is_safe(move):
                continue
            # giving check is illegal in racing kings
            child = self.push(move)
            if child.is_check():
                continue
            moves.append(move)
        return moves

    def is_insufficient_material(self) -> bool:
        return False  # the goal is the race, not mate

    def _variant_outcome(self) -> Optional[Tuple[Optional[int], str]]:
        white_in = bool(self.bbs[WHITE][KING] & RANK_8)
        black_in = bool(self.bbs[BLACK][KING] & RANK_8)
        if white_in and black_in:
            return (None, "both kings in the goal")
        if black_in:
            return (BLACK, "king in the goal")
        if white_in:
            # black gets one rejoinder move to equalize
            if self.turn == BLACK:
                bksq = self.king_sq(BLACK)
                if bksq is not None and any(
                    square_rank(m.to_sq) == 7 and m.from_sq == bksq
                    for m in self.legal_moves()
                ):
                    return None
            return (WHITE, "king in the goal")
        return None


class HordePosition(Position):
    variant = "horde"

    @classmethod
    def starting_fen(cls) -> str:
        return (
            "rnbqkbnr/pppppppp/8/1PP2PP1/PPPPPPPP/PPPPPPPP/PPPPPPPP/PPPPPPPP"
            " w kq - 0 1"
        )

    def _validate(self) -> None:
        if popcount(self.bbs[BLACK][KING]) != 1:
            raise InvalidFenError("black must have exactly one king")
        if self.bbs[WHITE][KING]:
            raise InvalidFenError("the horde has no king")
        if self.bbs[WHITE][PAWN] & RANK_8 or self.bbs[BLACK][PAWN] & RANK_1:
            raise InvalidFenError("pawn on promotion rank")
        if self.turn == WHITE:
            bksq = self.king_sq(BLACK)
            if bksq is not None and self.attackers(WHITE, bksq):
                raise InvalidFenError("side not to move is in check")

    def _double_push_sources(self, us: int) -> int:
        # horde: white pawns on rank 1 may also double-push
        if us == WHITE:
            return RANK_1 | RANK_2
        return RANK_7

    def _double_sets_ep(self, frm: int, us: int) -> bool:
        # a double push from the back rank cannot be captured en passant
        return not (us == WHITE and square_rank(frm) == 0)

    def _variant_outcome(self) -> Optional[Tuple[Optional[int], str]]:
        if not self.occ[WHITE]:
            return (BLACK, "horde destroyed")
        return None

    def is_insufficient_material(self) -> bool:
        return False


class AtomicPosition(Position):
    variant = "atomic"

    def _explosion_zone(self, sq: int) -> int:
        return KING_ATTACKS[sq] | bb(sq)

    def _kings_adjacent(self) -> bool:
        wk, bk = self.king_sq(WHITE), self.king_sq(BLACK)
        return wk is not None and bk is not None and bool(KING_ATTACKS[wk] & bb(bk))

    def checkers(self) -> int:
        if self._kings_adjacent():
            return 0  # adjacent kings can never be in check (capture explodes both)
        return super().checkers()

    def is_check(self) -> bool:
        return bool(self.checkers())

    def _post_move_hook(self, move: Move, us: int, ptype: int, captured) -> None:
        if captured is None:
            return
        # explosion centers on the landing square: the capturer and every
        # non-pawn piece within one king-step are removed (the directly
        # captured piece is already gone)
        self._remove_piece(move.to_sq)
        zone = self._explosion_zone(move.to_sq)
        for color in (WHITE, BLACK):
            for pt in (KNIGHT, BISHOP, ROOK, QUEEN, KING):
                for s in scan(self.bbs[color][pt] & zone):
                    self._remove_piece(s)
                    self.castling &= ~bb(s)

    def generate_pseudo_legal(self) -> Iterator[Move]:
        them_occ = self.occ[self.turn ^ 1]
        for move in super().generate_pseudo_legal():
            # kings never capture in atomic (the capture would explode them)
            pc = self.piece_at(move.from_sq)
            if pc is not None and pc[1] == KING and bb(move.to_sq) & them_occ:
                continue
            yield move

    def _move_is_safe(self, move: Move) -> bool:
        child = self.copy()
        child._apply(move)
        us = self.turn
        if child.king_sq(us ^ 1) is None:
            return True  # exploding the enemy king wins regardless
        if child.king_sq(us) is None:
            return False  # exploding our own king is illegal
        ksq = child.king_sq(us)
        if child._kings_adjacent():
            return True
        return not child.attackers(child.turn, ksq)

    def _variant_outcome(self) -> Optional[Tuple[Optional[int], str]]:
        for color in (WHITE, BLACK):
            if not self.bbs[color][KING]:
                return (color ^ 1, "king exploded")
        return None

    def _validate(self) -> None:
        for color in (WHITE, BLACK):
            if popcount(self.bbs[color][KING]) > 1:
                raise InvalidFenError("too many kings")
        if self.bbs[WHITE][PAWN] & (RANK_1 | RANK_8) or self.bbs[BLACK][PAWN] & (RANK_1 | RANK_8):
            raise InvalidFenError("pawn on back rank")
        them = self.turn ^ 1
        their_king = self.bbs[them][KING]
        if their_king and not self._kings_adjacent() and self.attackers(self.turn, lsb(their_king)):
            raise InvalidFenError("side not to move is in check")


class AntichessPosition(Position):
    variant = "antichess"
    has_castling = False

    def _promotion_pieces(self) -> Tuple[int, ...]:
        return (QUEEN, ROOK, BISHOP, KNIGHT, KING)

    def _validate(self) -> None:
        if self.bbs[WHITE][PAWN] & (RANK_1 | RANK_8) or self.bbs[BLACK][PAWN] & (RANK_1 | RANK_8):
            raise InvalidFenError("pawn on back rank")

    def legal_moves(self) -> List[Move]:
        moves = list(self.generate_pseudo_legal())
        them_occ = self.occ[self.turn ^ 1]
        captures = [
            m for m in moves
            if bb(m.to_sq) & them_occ
            or (self.piece_at(m.from_sq)[1] == PAWN
                and self.ep_square is not None and m.to_sq == self.ep_square)
        ]
        return captures if captures else moves

    def _move_is_safe(self, move: Move) -> bool:
        return True  # no check concept

    def _variant_outcome(self) -> Optional[Tuple[Optional[int], str]]:
        if not self.occ[self.turn]:
            return (self.turn, "all pieces lost")
        if not self.legal_moves():
            return (self.turn, "stalemate")  # stalemated side wins
        return None

    def outcome(self, legal_moves=None):
        if not self.occ[self.turn]:
            return (self.turn, "all pieces lost")
        if legal_moves is None:
            legal_moves = self.legal_moves()
        if not legal_moves:
            return (self.turn, "stalemate")  # stalemated side wins
        if self.halfmove >= 100:
            return (None, "50-move rule")
        return None


class CrazyhousePosition(Position):
    """Captured pieces go to the capturer's pocket (a promoted piece as a
    pawn) and are dropped back as moves of their own (Position's pockets,
    promoted bits and drop hooks)."""

    variant = "crazyhouse"

    def __init__(self) -> None:
        super().__init__()
        self.pockets = [[0] * 5, [0] * 5]

    @classmethod
    def starting_fen(cls) -> str:
        return "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR[] w KQkq - 0 1"

    @classmethod
    def from_fen(cls, fen: str) -> "CrazyhousePosition":
        pos = super().from_fen(fen)
        if pos.pockets is None:
            pos.pockets = [[0] * 5, [0] * 5]
        return pos

    def _on_capture(self, us: int, cap_pc, cap_sq: int, cap_was_promoted: bool) -> None:
        ptype = PAWN if cap_was_promoted else cap_pc[1]
        self.pockets[us][ptype] += 1

    def _drop_moves(self, us: int) -> Iterator[Move]:
        if self.pockets is None:
            return
        empty = ~self.occ_all & FULL_BB
        for ptype in range(5):
            if self.pockets[us][ptype] <= 0:
                continue
            targets = empty
            if ptype == PAWN:
                targets &= ~(RANK_1 | RANK_8)
            for to in scan(targets):
                yield Move(0, to, drop=ptype)

    def is_insufficient_material(self) -> bool:
        return False  # material comes back from the pocket


# chunk variants this package runs (the engine refuses the rest)
VARIANTS = {
    "standard": Position,
    "chess960": Chess960Position,
    "fromPosition": Position,
    "threeCheck": ThreeCheckPosition,
    "3check": ThreeCheckPosition,
    "kingOfTheHill": KingOfTheHillPosition,
    "racingKings": RacingKingsPosition,
    "horde": HordePosition,
    "atomic": AtomicPosition,
    "antichess": AntichessPosition,
    "crazyhouse": CrazyhousePosition,
}


def position_class(variant: str):
    try:
        return VARIANTS[variant]
    except KeyError:
        raise ValueError(f"unsupported variant: {variant!r}") from None


def from_fen(fen: str, variant: str = "standard") -> Position:
    return position_class(variant).from_fen(fen)
