"""The shared transposition table and the Zobrist hash of device boards
(a port of the JAX package's ops/tt.py).

Z1 and Z2 are regenerated from the reference's seeded numpy draw, so the
two packages hash every position to the same pair of 32-bit keys. Keys
are carried as int32 bit patterns (torch has few uint32 operators; XOR
is the same bits): view them as uint32 to compare with the reference.

The table is one (n, 4) int32 tensor, n a power of two, shared by every
lane of a search and kept by the engine across searches and chunks. Each
row is one slot:
    [0] check: h2 ^ meta ^ move (the validation word)
    [1] meta:  (score + 32768) << 10 | depth << 2 | flag
    [2] move:  the node's best move (-1 when none)
    [3] generation (0 for plain stores; see `store`)
A probe accepts a row only when its check word matches, so a stale or
foreign row reads as a miss. Mate-range scores are never stored.

`probe` and `store` run as the CUDA kernels K5 and K6 on the card and as
the plain versions below on the CPU. The reference stores with one row
scatter; under colliding slots XLA:CPU keeps the row of the highest
storable lane, whole. Both versions here implement that rule explicitly
(a storable lane writes only if no higher lane stores to its slot), so
the table is the reference's bit for bit, whatever the scatter order of
the device. Store updates the table in place.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import device as device_mod
from .. import kernels
from .board import (
    EXTRA_CHECKS, EXTRA_POCKET, EXTRA_PROMOTED, POCKET_TYPES, THREE_CHECKS, Board, variant_id,
)

# layout of each table: piece-square | ep | castling | stm | variant
# extras (crazyhouse's pocket counts, 17 keys a count word, and promoted
# bits, a key a square; threeCheck's check counters; one salt per
# variant)
_rng = np.random.default_rng(0xF15F_4E7)
_EP_OFF = 13 * 64
_CASTLE_OFF = _EP_OFF + 65
_STM_OFF = _CASTLE_OFF + 4 * 65
_POCKET_OFF = _STM_OFF + 2
_CHECKS_OFF = _POCKET_OFF + 10 * 17
_PROMOTED_OFF = _CHECKS_OFF + 2 * 4
_VARIANT_OFF = _PROMOTED_OFF + 64
POCKET_MAX = 16  # a pocket count's key is that of the count clipped to 0..POCKET_MAX
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


def hash_board_plain(board, stm, ep, castling, z1, z2, extra=None,
                     variant: str = "standard") -> torch.Tensor:
    """(B, 64) board, (B,) stm/ep, (B, 4) castling → (B, 2) int32 keys.
    Empty squares read key slot 0..63 of the table, which no piece uses,
    and are masked; ep/castling values are -1..63. Every variant but
    standard chess XORs in its salt (one table serves every chunk, and
    identical boards under different rules must not share an entry),
    threeCheck its check counters from extra (B, 12), each clipped to
    0..3, and crazyhouse its ten pocket counts, each clipped to
    0..POCKET_MAX, and a key for each square of its promoted-piece bits;
    standard hashes are the reference's standard ones."""
    vid = variant_id(variant)
    z = torch.stack([z1, z2])  # (2, Z_SHAPE)
    sq = torch.arange(64, device=board.device)
    pieces = torch.where(board > 0, z[:, board.long() * 64 + sq], 0)  # (2, B, 64)
    slots = torch.cat([
        (_EP_OFF + 1 + ep)[:, None],
        _CASTLE_OFF + 1 + castling + torch.arange(0, 4 * 65, 65, device=board.device),
        (_STM_OFF + (stm != 0).to(stm.dtype))[:, None],
    ], 1).long()  # (B, 6)
    if variant == "threeCheck":
        checks = extra[:, EXTRA_CHECKS:EXTRA_CHECKS + 2].clamp(0, THREE_CHECKS)
        slots = torch.cat([slots, (_CHECKS_OFF + checks + torch.tensor(
            [0, THREE_CHECKS + 1], device=board.device)).long()], 1)
    elif variant == "crazyhouse":
        counts = extra[:, EXTRA_POCKET:EXTRA_POCKET + 2 * POCKET_TYPES].clamp(0, POCKET_MAX)
        slots = torch.cat([slots, (_POCKET_OFF + counts + torch.arange(
            0, 2 * POCKET_TYPES * (POCKET_MAX + 1), POCKET_MAX + 1, device=board.device)).long()],
            1)
        words = extra[:, EXTRA_PROMOTED + (sq >> 5)]  # (B, 64): each square's word
        promoted = ((words >> (sq & 31)) & 1) == 1
        pieces = pieces ^ torch.where(promoted, z[:, None, _PROMOTED_OFF + sq], 0)
    keys = z[:, slots]  # (2, B, slots)
    h = _xor_fold(pieces)
    for i in range(slots.shape[1]):
        h = h ^ keys[..., i]
    if vid:
        h = h ^ z[:, _VARIANT_OFF + vid, None]
    return h.T.contiguous()


def hash_board(board, stm, ep, castling, extra=None, variant: str = "standard") -> torch.Tensor:
    """K4 wrapper: plain version on the CPU, kernel on the card. extra
    (B, 12) is read in threeCheck and crazyhouse only."""
    z1, z2 = tables(board.device)
    if board.device.type == "cpu":
        return hash_board_plain(board, stm, ep, castling, z1, z2, extra, variant)
    return kernels.zobrist_hash(board, stm, ep, castling, z1, z2, extra, variant)


def hash_boards(boards: Board, variant: str = "standard") -> torch.Tensor:
    """hash_board over a batched Board → (B, 2) int32."""
    return hash_board(boards.board, boards.stm, boards.ep, boards.castling, boards.extra,
                      variant)


# ------------------------------------------------------------------ table

FLAG_EXACT = 0
FLAG_LOWER = 1  # score is a lower bound (fail-high: score >= beta)
FLAG_UPPER = 2  # score is an upper bound (fail-low: score <= alpha0)

_SCORE_BIAS = 32768
_DEPTH_MASK = 0xFF
_MAX_STORE = 30000  # mate-range scores are never stored


def make_table(size_log2: int = 20, device=None) -> torch.Tensor:
    """2**size_log2 empty slots of 16 bytes, on `device` (default: the
    card; raises without one)."""
    return torch.zeros((1 << size_log2, 4), dtype=torch.int32,
                       device=device_mod.resolve(device))


def pack_meta(score, depth, flag):
    return ((score + _SCORE_BIAS) << 10) | (depth << 2) | flag


def unpack_meta(meta):
    return (meta >> 10) - _SCORE_BIAS, (meta >> 2) & _DEPTH_MASK, meta & 3


def _slots(table: torch.Tensor, h1: torch.Tensor) -> torch.Tensor:
    """h1's low bits (a uint32 mask on int32 bits) → slot indices."""
    return (h1 & (table.shape[0] - 1)).long()


def probe_plain(table, h1, h2, depth_left, alpha, beta, enter,
                deep_bounds: bool = False):
    """(B,) int32 inputs, enter (B,) bool → (usable (B,) bool, score,
    order_move). A row is valid when its check word matches h2 and it is
    not empty; usable when valid, of the exact depth (deep_bounds: at
    least that deep) and its bound cuts (alpha, beta), and only for
    entering lanes. order_move is the valid row's move for ordering
    (entering lanes; -1 otherwise). score is the row's unpacked score,
    read only where usable."""
    rows = table[_slots(table, h1)]
    meta, move = rows[:, 1], rows[:, 2]
    valid = ((rows[:, 0] ^ meta ^ move) == h2) & (meta != 0)
    score, depth, flag = unpack_meta(meta)
    dl = depth_left.clamp(min=0)
    deep_enough = depth >= dl if deep_bounds else depth == dl
    cuts = torch.where(flag == FLAG_EXACT, True,
                       torch.where(flag == FLAG_LOWER, score >= beta, score <= alpha))
    usable = valid & deep_enough & cuts & enter
    return usable, score, torch.where(valid & enter, move, -1)


def probe(table, h1, h2, depth_left, alpha, beta, enter, deep_bounds: bool = False):
    """K5 wrapper: plain version on the CPU, kernel on the card."""
    if table.device.type == "cpu":
        return probe_plain(table, h1, h2, depth_left, alpha, beta, enter, deep_bounds)
    return kernels.tt_probe(table, h1, h2, depth_left, alpha, beta, enter, deep_bounds)


def store_plain(table, h1, h2, score, depth, flag, move, mask,
                prefer_deep: bool = False, gen=None) -> torch.Tensor:
    """Store each masked lane's entry, in place; returns the table.
    Lanes whose |score| exceeds _MAX_STORE store nothing. prefer_deep:
    a slot whose pre-store row is non-empty, of generation `gen` and
    strictly deeper is kept. gen: None (0), an int or a (B,) tensor.
    Of the lanes that store to one slot, the highest lane's row wins."""
    B = h1.shape[0]
    slot = _slots(table, h1)
    gen_t = torch.as_tensor(0 if gen is None else gen, dtype=torch.int32,
                            device=table.device).expand(B)
    storable = mask & (score.abs() <= _MAX_STORE)
    if prefer_deep:
        old = table[slot]
        keep_old = (old[:, 1] != 0) & (old[:, 3] == gen_t) & (unpack_meta(old[:, 1])[1] > depth)
        storable = storable & ~keep_old
    # the last storable lane of each slot: a stable sort keeps lane order
    # within a slot, so the last of each run of equal slots is the highest
    key = torch.where(storable, slot, -1)
    srt, order = torch.sort(key, stable=True)
    last = torch.ones_like(storable)
    last[:-1] = srt[1:] != srt[:-1]
    win = torch.zeros_like(storable)
    win[order] = last & (srt >= 0)
    meta = pack_meta(score, depth, flag)
    rows = torch.stack([h2 ^ meta ^ move, meta, move, gen_t], 1)
    table[slot[win]] = rows[win]
    return table


def store(table, h1, h2, score, depth, flag, move, mask, prefer_deep: bool = False,
          gen=None) -> torch.Tensor:
    """K6 wrapper: plain version on the CPU, kernel on the card."""
    if table.device.type == "cpu":
        return store_plain(table, h1, h2, score, depth, flag, move, mask, prefer_deep, gen)
    return kernels.tt_store(table, h1, h2, score, depth, flag, move, mask, prefer_deep, gen)
