"""Zobrist hashing of device boards (the hash half of the JAX package's
ops/tt.py; the table's probe and store are not ported yet).

Z1 and Z2 are regenerated from the reference's seeded numpy draw, so the
two packages hash every position to the same pair of 32-bit keys. Keys
are carried as int32 bit patterns (torch has few uint32 operators; XOR
is the same bits): view them as uint32 to compare with the reference.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import kernels
from .board import Board

# layout of each table: piece-square | ep | castling | stm | variant
# extras (unused by standard chess, kept so the draw matches)
_rng = np.random.default_rng(0xF15F_4E7)
_EP_OFF = 13 * 64
_CASTLE_OFF = _EP_OFF + 65
_STM_OFF = _CASTLE_OFF + 4 * 65
_POCKET_OFF = _STM_OFF + 2
_CHECKS_OFF = _POCKET_OFF + 10 * 17
_PROMOTED_OFF = _CHECKS_OFF + 2 * 4
_VARIANT_OFF = _PROMOTED_OFF + 64
Z_SHAPE = _VARIANT_OFF + 8
Z1 = _rng.integers(0, 2**32, Z_SHAPE, dtype=np.uint32)
Z2 = _rng.integers(0, 2**32, Z_SHAPE, dtype=np.uint32)


@lru_cache(maxsize=None)
def tables(device: torch.device):
    """(Z1, Z2) as int32 bit patterns on one device."""
    return tuple(
        torch.from_numpy(z.view(np.int32).copy()).to(device) for z in (Z1, Z2)
    )


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR-reduce the last dim (a power of two; XOR is order free)."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] ^ x[..., half:]
    return x[..., 0]


def hash_board_plain(board, stm, ep, castling, z1, z2) -> torch.Tensor:
    """(B, 64) board, (B,) stm/ep, (B, 4) castling → (B, 2) int32 keys.
    Empty squares read key slot 0..63 of the table, which no piece uses,
    and are masked; ep/castling values are -1..63."""
    z = torch.stack([z1, z2])  # (2, Z_SHAPE)
    sq = torch.arange(64, device=board.device)
    pieces = torch.where(board > 0, z[:, board.long() * 64 + sq], 0)  # (2, B, 64)
    slots = torch.cat([
        (_EP_OFF + 1 + ep)[:, None],
        _CASTLE_OFF + 1 + castling + torch.arange(0, 4 * 65, 65, device=board.device),
        (_STM_OFF + (stm != 0).to(stm.dtype))[:, None],
    ], 1).long()  # (B, 6)
    keys = z[:, slots]  # (2, B, 6)
    h = _xor_fold(pieces)
    for i in range(slots.shape[1]):
        h = h ^ keys[..., i]
    return h.T.contiguous()


def hash_board(board, stm, ep, castling) -> torch.Tensor:
    """K4 wrapper: plain version on the CPU, kernel on the card."""
    z1, z2 = tables(board.device)
    if board.device.type == "cpu":
        return hash_board_plain(board, stm, ep, castling, z1, z2)
    return kernels.zobrist_hash(board, stm, ep, castling, z1, z2)


def hash_boards(boards: Board) -> torch.Tensor:
    """hash_board over a batched Board → (B, 2) int32."""
    return hash_board(boards.board, boards.stm, boards.ep, boards.castling)
