"""Standard-chess position with X-FEN/Chess960 castling, copy-make semantics.

Fills shakmaty's role from the reference client (FEN parsing, UCI move
replay, legality — reference: src/queue.rs:554-581, Cargo.toml:42).
The lichess variants' rules (reference: src/logger.rs:201-213 lists
them) live in fishnet_tpu_torch.chess.variants as subclasses, through the
hooks below.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from .attacks import (
    BETWEEN,
    KING_ATTACKS,
    KNIGHT_ATTACKS,
    PAWN_ATTACKS,
    bishop_attacks,
    rook_attacks,
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
    parse_piece_char,
    parse_square,
    piece_char,
    popcount,
    scan,
    square,
    square_file,
    square_name,
    square_rank,
)

RANK_1 = 0x00000000000000FF
RANK_2 = 0x000000000000FF00
RANK_4 = 0x00000000FF000000
RANK_5 = 0x000000FF00000000
RANK_7 = 0x00FF000000000000
RANK_8 = 0xFF00000000000000
BACK_RANKS = (RANK_1, RANK_8)
PROMO_RANKS = (RANK_8, RANK_1)

PROMOTION_PIECES = (QUEEN, ROOK, BISHOP, KNIGHT)

STARTING_FEN = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"


class IllegalMoveError(ValueError):
    pass


class InvalidFenError(ValueError):
    pass


class Position:
    """Mutable-via-copy chess position. Use `push(move)` to get a successor."""

    variant = "standard"
    has_castling = True

    __slots__ = (
        "bbs",
        "occ",
        "occ_all",
        "turn",
        "castling",
        "ep_square",
        "halfmove",
        "fullmove",
        "pockets",
        "promoted",
        "checks_given",
    )

    def __init__(self) -> None:
        self.bbs = [[0] * 6, [0] * 6]
        self.occ = [0, 0]
        self.occ_all = 0
        self.turn = WHITE
        self.castling = 0  # bitboard of rook squares retaining castling rights
        self.ep_square: Optional[int] = None
        self.halfmove = 0
        self.fullmove = 1
        self.pockets = None  # crazyhouse: [[int]*5, [int]*5] counts P N B R Q
        self.promoted = 0  # crazyhouse: bitboard of promoted pieces
        self.checks_given = None  # threeCheck: [white_given, black_given]

    # ------------------------------------------------------------------ setup

    @classmethod
    def initial(cls) -> "Position":
        return cls.from_fen(cls.starting_fen())

    @classmethod
    def starting_fen(cls) -> str:
        return STARTING_FEN

    def copy(self) -> "Position":
        p = self.__class__.__new__(self.__class__)
        p.bbs = [list(self.bbs[0]), list(self.bbs[1])]
        p.occ = list(self.occ)
        p.occ_all = self.occ_all
        p.turn = self.turn
        p.castling = self.castling
        p.ep_square = self.ep_square
        p.halfmove = self.halfmove
        p.fullmove = self.fullmove
        p.pockets = None if self.pockets is None else [list(self.pockets[0]), list(self.pockets[1])]
        p.promoted = self.promoted
        p.checks_given = None if self.checks_given is None else list(self.checks_given)
        return p

    # ------------------------------------------------------------------- FEN

    @classmethod
    def from_fen(cls, fen: str) -> "Position":
        pos = cls()
        parts = fen.strip().split()
        if len(parts) < 1:
            raise InvalidFenError(f"empty FEN: {fen!r}")
        board = parts[0]

        # crazyhouse pocket may appear as "...[PNBq]" after the board field
        pocket_str = None
        if "[" in board:
            board, rest = board.split("[", 1)
            if not rest.endswith("]"):
                raise InvalidFenError(f"unterminated pocket: {fen!r}")
            pocket_str = rest[:-1]
        elif board.count("/") == 8:
            # shredder-style pocket as a 9th rank segment
            board, pocket_str = board.rsplit("/", 1)

        ranks = board.split("/")
        if len(ranks) != 8:
            raise InvalidFenError(f"expected 8 ranks: {fen!r}")
        prev_promoted = 0
        for r_idx, rank_str in enumerate(ranks):
            rank = 7 - r_idx
            file = 0
            last_sq = None
            for c in rank_str:
                if c.isdigit():
                    file += int(c)
                    last_sq = None
                elif c == "~":
                    if last_sq is None:
                        raise InvalidFenError(f"dangling ~ in FEN: {fen!r}")
                    prev_promoted |= bb(last_sq)
                else:
                    if file > 7:
                        raise InvalidFenError(f"rank overflow: {fen!r}")
                    color, ptype = parse_piece_char(c)
                    sq = square(file, rank)
                    pos.bbs[color][ptype] |= bb(sq)
                    last_sq = sq
                    file += 1
            if file != 8:
                raise InvalidFenError(f"bad rank length {rank_str!r}: {fen!r}")
        pos.promoted = prev_promoted
        pos._refresh_occ()

        if pos.pockets is not None or pocket_str is not None:
            pos.pockets = [[0] * 5, [0] * 5]
            if pocket_str and pocket_str != "-":
                for c in pocket_str:
                    color, ptype = parse_piece_char(c)
                    if ptype == KING:
                        raise InvalidFenError(f"king in pocket: {fen!r}")
                    pos.pockets[color][ptype] += 1

        pos.turn = WHITE
        if len(parts) > 1:
            if parts[1] not in ("w", "b"):
                raise InvalidFenError(f"bad side to move: {fen!r}")
            pos.turn = WHITE if parts[1] == "w" else BLACK

        pos.castling = 0
        if len(parts) > 2 and parts[2] != "-":
            pos.castling = pos._parse_castling(parts[2])

        pos.ep_square = None
        if len(parts) > 3 and parts[3] != "-":
            pos.ep_square = parse_square(parts[3])

        # optional threeCheck field before the counters, e.g. "3+3" or "+0+0"
        idx = 4
        if len(parts) > idx and ("+" in parts[idx]):
            pos._parse_checks_field(parts[idx])
            idx += 1
        if len(parts) > idx:
            try:
                pos.halfmove = int(parts[idx])
            except ValueError as e:
                raise InvalidFenError(f"bad halfmove clock: {fen!r}") from e
        idx += 1
        if len(parts) > idx:
            try:
                pos.fullmove = max(1, int(parts[idx]))
            except ValueError as e:
                raise InvalidFenError(f"bad fullmove number: {fen!r}") from e
        idx += 1
        if len(parts) > idx and "+" in parts[idx]:
            pos._parse_checks_field(parts[idx])

        pos._validate()
        return pos

    def _parse_checks_field(self, field: str) -> None:
        raise InvalidFenError(f"unexpected check-count field {field!r} for {self.variant}")

    def _parse_castling(self, field: str) -> int:
        rights = 0
        for c in field:
            if c in "KQkq":
                color = WHITE if c.isupper() else BLACK
                back = BACK_RANKS[color]
                king_bb = self.bbs[color][KING] & back
                if not king_bb:
                    continue
                ksq = lsb(king_bb)
                rooks = self.bbs[color][ROOK] & back
                if c.upper() == "K":
                    candidates = [s for s in scan(rooks) if s > ksq]
                    if candidates:
                        rights |= bb(max(candidates))
                else:
                    candidates = [s for s in scan(rooks) if s < ksq]
                    if candidates:
                        rights |= bb(min(candidates))
            elif c.upper() in "ABCDEFGH":
                color = WHITE if c.isupper() else BLACK
                file = "abcdefgh".index(c.lower())
                sq = square(file, 0 if color == WHITE else 7)
                rights |= bb(sq)
            else:
                raise InvalidFenError(f"bad castling field: {field!r}")
        return rights

    def castling_fen(self) -> str:
        out = ""
        for color, chars in ((WHITE, "KQ"), (BLACK, "kq")):
            back = BACK_RANKS[color]
            king_bb = self.bbs[color][KING] & back
            ksq = lsb(king_bb) if king_bb else None
            rooks = self.bbs[color][ROOK] & back
            rights = sorted(scan(self.castling & back), reverse=True)
            for rsq in rights:
                if ksq is not None and rsq > ksq:
                    outer = [s for s in scan(rooks) if s > ksq]
                    if outer and rsq == max(outer):
                        out += chars[0]
                        continue
                if ksq is not None and rsq < ksq:
                    outer = [s for s in scan(rooks) if s < ksq]
                    if outer and rsq == min(outer):
                        out += chars[1]
                        continue
                c = "abcdefgh"[square_file(rsq)]
                out += c.upper() if color == WHITE else c
        return out or "-"

    def to_fen(self) -> str:
        rows = []
        for rank in range(7, -1, -1):
            row = ""
            empty = 0
            for file in range(8):
                sq = square(file, rank)
                pc = self.piece_at(sq)
                if pc is None:
                    empty += 1
                else:
                    if empty:
                        row += str(empty)
                        empty = 0
                    row += piece_char(*pc)
                    if self.promoted & bb(sq):
                        row += "~"
            if empty:
                row += str(empty)
            rows.append(row)
        board = "/".join(rows)
        if self.pockets is not None:
            pocket = ""
            for color in (WHITE, BLACK):
                for ptype in (QUEEN, ROOK, BISHOP, KNIGHT, PAWN):
                    pocket += piece_char(color, ptype) * self.pockets[color][ptype]
            board += f"[{pocket}]"
        parts = [
            board,
            "w" if self.turn == WHITE else "b",
            self.castling_fen(),
            square_name(self.ep_square) if self.ep_square is not None else "-",
        ]
        extra = self._fen_extra()
        if extra:
            parts.append(extra)
        parts.append(str(self.halfmove))
        parts.append(str(self.fullmove))
        return " ".join(parts)

    def _fen_extra(self) -> Optional[str]:
        return None

    def _validate(self) -> None:
        for color in (WHITE, BLACK):
            kings = popcount(self.bbs[color][KING])
            if kings != 1:
                raise InvalidFenError(f"{'white' if color == WHITE else 'black'} must have exactly one king")
        if self.bbs[WHITE][PAWN] & (RANK_1 | RANK_8) or self.bbs[BLACK][PAWN] & (RANK_1 | RANK_8):
            raise InvalidFenError("pawn on back rank")
        # side not to move must not be in check (their king capturable)
        them = self.turn ^ 1
        their_king = self.bbs[them][KING]
        if their_king and self.attackers(self.turn, lsb(their_king)):
            raise InvalidFenError("side not to move is in check")

    # ------------------------------------------------------------- inspection

    def _refresh_occ(self) -> None:
        self.occ[WHITE] = 0
        self.occ[BLACK] = 0
        for ptype in range(6):
            self.occ[WHITE] |= self.bbs[WHITE][ptype]
            self.occ[BLACK] |= self.bbs[BLACK][ptype]
        self.occ_all = self.occ[WHITE] | self.occ[BLACK]

    def piece_at(self, sq: int) -> Optional[Tuple[int, int]]:
        # scans bbs directly (not occ) so it stays correct mid-_apply
        m = bb(sq)
        for color in (WHITE, BLACK):
            col_bbs = self.bbs[color]
            for ptype in range(6):
                if col_bbs[ptype] & m:
                    return (color, ptype)
        return None

    def king_sq(self, color: int) -> Optional[int]:
        k = self.bbs[color][KING]
        return lsb(k) if k else None

    def attackers(self, color: int, sq: int, occ: Optional[int] = None) -> int:
        """Bitboard of pieces of `color` attacking `sq` given occupancy."""
        if occ is None:
            occ = self.occ_all
        b = KNIGHT_ATTACKS[sq] & self.bbs[color][KNIGHT]
        b |= KING_ATTACKS[sq] & self.bbs[color][KING]
        b |= PAWN_ATTACKS[color ^ 1][sq] & self.bbs[color][PAWN]
        rq = self.bbs[color][ROOK] | self.bbs[color][QUEEN]
        if rq:
            b |= rook_attacks(sq, occ) & rq
        bq = self.bbs[color][BISHOP] | self.bbs[color][QUEEN]
        if bq:
            b |= bishop_attacks(sq, occ) & bq
        return b

    def checkers(self) -> int:
        ksq = self.king_sq(self.turn)
        if ksq is None:
            return 0
        return self.attackers(self.turn ^ 1, ksq)

    def is_check(self) -> bool:
        return bool(self.checkers())

    # -------------------------------------------------------- move generation

    def _pawn_moves(self, us: int) -> Iterator[Move]:
        them = us ^ 1
        pawns = self.bbs[us][PAWN]
        empty = ~self.occ_all & FULL_BB
        promo_rank = PROMO_RANKS[us]
        fwd = 8 if us == WHITE else -8
        double_src = self._double_push_sources(us)
        for frm in scan(pawns):
            to = frm + fwd
            if 0 <= to < 64 and empty & bb(to):
                if bb(to) & promo_rank:
                    for promo in self._promotion_pieces():
                        yield Move(frm, to, promotion=promo)
                else:
                    yield Move(frm, to)
                    if bb(frm) & double_src:
                        to2 = to + fwd
                        if 0 <= to2 < 64 and empty & bb(to2):
                            yield Move(frm, to2)
            caps = PAWN_ATTACKS[us][frm]
            targets = caps & self.occ[them]
            if self.ep_square is not None and caps & bb(self.ep_square):
                targets |= bb(self.ep_square)
            for to in scan(targets):
                if bb(to) & promo_rank:
                    for promo in self._promotion_pieces():
                        yield Move(frm, to, promotion=promo)
                else:
                    yield Move(frm, to)

    def _double_push_sources(self, us: int) -> int:
        return RANK_2 if us == WHITE else RANK_7

    def _double_sets_ep(self, frm: int, us: int) -> bool:
        return True  # horde: back-rank doubles can't be captured en passant

    def _promotion_pieces(self) -> Tuple[int, ...]:
        return PROMOTION_PIECES

    def _piece_moves(self, us: int) -> Iterator[Move]:
        own = self.occ[us]
        occ = self.occ_all
        for frm in scan(self.bbs[us][KNIGHT]):
            for to in scan(KNIGHT_ATTACKS[frm] & ~own):
                yield Move(frm, to)
        for frm in scan(self.bbs[us][BISHOP]):
            for to in scan(bishop_attacks(frm, occ) & ~own):
                yield Move(frm, to)
        for frm in scan(self.bbs[us][ROOK]):
            for to in scan(rook_attacks(frm, occ) & ~own):
                yield Move(frm, to)
        for frm in scan(self.bbs[us][QUEEN]):
            for to in scan((rook_attacks(frm, occ) | bishop_attacks(frm, occ)) & ~own):
                yield Move(frm, to)
        for frm in scan(self.bbs[us][KING]):
            for to in scan(KING_ATTACKS[frm] & ~own):
                yield Move(frm, to)

    def _castling_moves(self, us: int) -> Iterator[Move]:
        if not self.has_castling:
            return
        ksq = self.king_sq(us)
        if ksq is None:
            return
        back = BACK_RANKS[us]
        if not (bb(ksq) & back):
            return
        them = us ^ 1
        if self.attackers(them, ksq):
            return  # cannot castle out of check
        for rsq in scan(self.castling & back & self.bbs[us][ROOK]):
            kingside = rsq > ksq
            k_dest = square(6 if kingside else 2, square_rank(ksq))
            r_dest = square(5 if kingside else 3, square_rank(ksq))
            # squares that must be empty (other than the king and rook themselves)
            path = (
                BETWEEN[ksq][k_dest]
                | BETWEEN[rsq][r_dest]
                | bb(k_dest)
                | bb(r_dest)
            ) & ~bb(ksq) & ~bb(rsq)
            if path & self.occ_all:
                continue
            # king's path (excluding start) must not be attacked; occupancy
            # without the king and castling rook (they move away)
            occ = self.occ_all & ~bb(ksq) & ~bb(rsq)
            king_path = BETWEEN[ksq][k_dest] | bb(k_dest)
            if any(self.attackers(them, s, occ) for s in scan(king_path)):
                continue
            yield Move(ksq, rsq)

    def _drop_moves(self, us: int) -> Iterator[Move]:
        return iter(())

    def generate_pseudo_legal(self) -> Iterator[Move]:
        us = self.turn
        yield from self._pawn_moves(us)
        yield from self._piece_moves(us)
        yield from self._castling_moves(us)
        yield from self._drop_moves(us)

    def is_castling_move(self, move: Move) -> bool:
        if move.drop is not None:
            return False
        pc = self.piece_at(move.from_sq)
        return (
            pc is not None
            and pc[1] == KING
            and bool(self.occ[self.turn] & bb(move.to_sq))
        )

    def _move_is_safe(self, move: Move) -> bool:
        """After applying `move`, is the mover's king not capturable?"""
        child = self.copy()
        child._apply(move)
        ksq = child.king_sq(self.turn)
        if ksq is None:
            return True
        return not child.attackers(child.turn, ksq)

    def legal_moves(self) -> List[Move]:
        moves = []
        for move in self.generate_pseudo_legal():
            if self.is_castling_move(move):
                moves.append(move)  # castling generator already ensured safety
            elif self._move_is_safe(move):
                moves.append(move)
        return moves

    def is_legal(self, move: Move) -> bool:
        return move in self.legal_moves()

    # ------------------------------------------------------------ move making

    def push(self, move: Move) -> "Position":
        """Return the successor position (copy-make)."""
        child = self.copy()
        child._apply(move)
        return child

    def push_uci(self, uci: str) -> "Position":
        move = self.parse_uci(uci)
        return self.push(move)

    def parse_uci(self, uci: str) -> Move:
        """Parse a UCI move, accepting both standard (e1g1) and Chess960
        (king-takes-rook, e1h1) castling notation; validates legality."""
        move = Move.parse_uci(uci)
        move = self.normalize_move(move)
        legal = self.legal_moves()
        if move not in legal:
            raise IllegalMoveError(f"illegal move {uci!r} in {self.to_fen()!r}")
        return move

    def normalize_move(self, move: Move) -> Move:
        """Convert standard-notation castling (e1g1) to king-takes-rook."""
        if move.drop is not None:
            return move
        pc = self.piece_at(move.from_sq)
        if pc is None or pc[1] != KING or not self.has_castling:
            return move
        us = pc[0]
        if self.occ[us] & self.bbs[us][ROOK] & bb(move.to_sq):
            return move  # already king-takes-rook form
        df = square_file(move.to_sq) - square_file(move.from_sq)
        if abs(df) == 2 and square_rank(move.to_sq) == square_rank(move.from_sq):
            back = BACK_RANKS[us]
            rights = self.castling & back & self.bbs[us][ROOK]
            candidates = [
                s for s in scan(rights) if (s > move.from_sq) == (df > 0)
            ]
            if candidates:
                rsq = max(candidates) if df > 0 else min(candidates)
                return Move(move.from_sq, rsq)
        return move

    def _remove_piece(self, sq: int) -> Optional[Tuple[int, int]]:
        pc = self.piece_at(sq)
        if pc is None:
            return None
        self.bbs[pc[0]][pc[1]] &= ~bb(sq)
        self.promoted &= ~bb(sq)
        return pc

    def _set_piece(self, sq: int, color: int, ptype: int, promoted: bool = False) -> None:
        self._remove_piece(sq)
        self.bbs[color][ptype] |= bb(sq)
        if promoted:
            self.promoted |= bb(sq)

    def _apply(self, move: Move) -> None:
        us = self.turn
        them = us ^ 1
        self.halfmove += 1
        new_ep: Optional[int] = None
        captured: Optional[Tuple[int, int, int]] = None  # (color, ptype, sq)

        if move.drop is not None:
            assert self.pockets is not None, "drop in non-crazyhouse game"
            self.pockets[us][move.drop] -= 1
            self._set_piece(move.to_sq, us, move.drop)
            self.halfmove = 0 if move.drop == PAWN else self.halfmove
        elif self.is_castling_move(move):
            ksq, rsq = move.from_sq, move.to_sq
            kingside = rsq > ksq
            rank = square_rank(ksq)
            self._remove_piece(ksq)
            self._remove_piece(rsq)
            self._set_piece(square(6 if kingside else 2, rank), us, KING)
            self._set_piece(square(5 if kingside else 3, rank), us, ROOK)
            back = BACK_RANKS[us]
            self.castling &= ~back
        else:
            pc = self.piece_at(move.from_sq)
            if pc is None:
                raise IllegalMoveError(f"no piece on {square_name(move.from_sq)}")
            color, ptype = pc
            was_promoted = bool(self.promoted & bb(move.from_sq))
            self._remove_piece(move.from_sq)

            # captures (including en passant)
            cap_sq = move.to_sq
            if ptype == PAWN and self.ep_square is not None and move.to_sq == self.ep_square and not (
                self.occ_all & bb(move.to_sq)
            ):
                cap_sq = move.to_sq + (-8 if us == WHITE else 8)
            cap_pc = self.piece_at(cap_sq)
            if cap_pc is not None:
                cap_was_promoted = bool(self.promoted & bb(cap_sq))
                self._remove_piece(cap_sq)
                captured = (cap_pc[0], cap_pc[1], cap_sq)
                self.halfmove = 0
                self.castling &= ~bb(cap_sq)  # capturing a rook kills its right
                self._on_capture(us, cap_pc, cap_sq, cap_was_promoted)

            if ptype == PAWN:
                self.halfmove = 0
                if abs(move.to_sq - move.from_sq) == 16 and self._double_sets_ep(
                    move.from_sq, us
                ):
                    new_ep = (move.from_sq + move.to_sq) // 2
            if move.promotion is not None:
                self._set_piece(move.to_sq, us, move.promotion, promoted=self.pockets is not None)
            else:
                self._set_piece(move.to_sq, us, ptype, promoted=was_promoted)

            if ptype == KING:
                self.castling &= ~BACK_RANKS[us]
            self.castling &= ~bb(move.from_sq)  # moving a rook kills its right

            self._post_move_hook(move, us, ptype, captured)

        self._refresh_occ()
        self.ep_square = new_ep
        self.turn = them
        if us == BLACK:
            self.fullmove += 1
        self._post_turn_hook(us)

    def _on_capture(self, us: int, cap_pc: Tuple[int, int], cap_sq: int, cap_was_promoted: bool) -> None:
        pass

    def _post_move_hook(self, move: Move, us: int, ptype: int, captured) -> None:
        pass

    def _post_turn_hook(self, prev_turn: int) -> None:
        pass

    # --------------------------------------------------------------- outcomes

    def is_insufficient_material(self) -> bool:
        if self.bbs[WHITE][PAWN] | self.bbs[BLACK][PAWN]:
            return False
        if any(self.bbs[c][ROOK] | self.bbs[c][QUEEN] for c in (WHITE, BLACK)):
            return False
        minors = popcount(
            self.bbs[WHITE][KNIGHT] | self.bbs[WHITE][BISHOP]
            | self.bbs[BLACK][KNIGHT] | self.bbs[BLACK][BISHOP]
        )
        return minors <= 1

    def outcome(self, legal_moves: Optional[List[Move]] = None) -> Optional[Tuple[Optional[int], str]]:
        """Return (winner_color_or_None_for_draw, reason) if game is over.

        Pass precomputed `legal_moves` to avoid regenerating them (search
        engines call this once per node)."""
        special = self._variant_outcome()
        if special is not None:
            return special
        if legal_moves is None:
            legal_moves = self.legal_moves()
        if not legal_moves:
            if self.is_check():
                return (self.turn ^ 1, "checkmate")
            return (None, "stalemate")
        if self.is_insufficient_material():
            return (None, "insufficient material")
        if self.halfmove >= 100:
            return (None, "75-move rule" if self.halfmove >= 150 else "50-move rule")
        return None

    def _variant_outcome(self) -> Optional[Tuple[Optional[int], str]]:
        return None

    def __repr__(self) -> str:
        return f"<{self.__class__.__name__} {self.to_fen()!r}>"


class Chess960Position(Position):
    """Chess960: identical rules; castling is already rook-square based."""

    variant = "chess960"
