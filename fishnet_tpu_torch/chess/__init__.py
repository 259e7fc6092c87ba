"""Host-side chess rules (standard chess and chess960): FEN parsing, UCI
move replay, legality and game outcome."""
from .types import BLACK, WHITE, Move
from .position import (
    Chess960Position,
    IllegalMoveError,
    InvalidFenError,
    Position,
    STARTING_FEN,
    from_fen,
)

__all__ = [
    "BLACK", "WHITE", "Move", "Chess960Position", "IllegalMoveError",
    "InvalidFenError", "Position", "STARTING_FEN", "from_fen",
]
