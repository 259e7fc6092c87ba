"""Host-side chess rules (standard chess, chess960 and the lichess
variants in .variants): FEN parsing, UCI move replay, legality and game
outcome."""
from .types import BLACK, WHITE, Move
from .position import (
    Chess960Position,
    IllegalMoveError,
    InvalidFenError,
    Position,
    STARTING_FEN,
)
from .variants import VARIANTS, from_fen, position_class

__all__ = [
    "BLACK", "WHITE", "Move", "Chess960Position", "IllegalMoveError",
    "InvalidFenError", "Position", "STARTING_FEN", "VARIANTS", "from_fen",
    "position_class",
]
