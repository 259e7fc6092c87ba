"""fishnet_tpu_torch's Zobrist hash against the JAX package's, on the CPU:
the tables are the same draw, and hash_board / hash_boards give the same
two 32-bit keys (compared through a uint32 view of the port's int32 bit
patterns)."""
import random

import jax
import numpy as np
import pytest
import torch

from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.chess.position import Chess960Position as JaxChess960
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import tt as jtt
from fishnet_tpu_torch import kernels
from fishnet_tpu_torch.chess import Chess960Position, Position
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FENS = [
    "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1",
    "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR b KQkq - 0 1",
    "rnbqkbnr/pppppppp/8/8/4P3/8/PPPP1PPP/RNBQKBNR w Qkq - 0 1",
    "rnbqkbnr/pp1ppppp/8/2p5/4P3/8/PPPP1PPP/RNBQKBNR w KQkq c6 0 2",
    "rnbqkbnr/pp1ppppp/8/2p5/4P3/8/PPPP1PPP/RNBQKBNR w KQkq - 0 2",
    "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1",
    "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 30 1",
]
C960 = "bqnb1rkr/pp3ppp/3ppn2/2p5/5P2/P2P4/NPP1P1PP/BQ1BNRKR w HFhf - 2 9"


def test_tables_are_the_reference_draw():
    assert tt.Z1.dtype == np.uint32 and tt.Z2.dtype == np.uint32
    assert np.array_equal(tt.Z1, np.asarray(jtt.Z1))
    assert np.array_equal(tt.Z2, np.asarray(jtt.Z2))
    z1, z2 = tt.tables(torch.device("cpu"))
    assert np.array_equal(z1.numpy().view(np.uint32), tt.Z1)
    assert z1.numel() == kernels.Z_KEYS and z2.dtype == torch.int32


def _playouts():
    rng = random.Random(11)
    out = [(False, f) for f in FENS]
    for is960, start in ((False, FENS[0]), (False, FENS[5]), (True, C960)):
        pos = (JaxChess960 if is960 else JaxPosition).from_fen(start)
        for _ in range(40):
            legal = pos.legal_moves()
            if not legal:
                break
            pos = pos.push(rng.choice(legal))
            out.append((is960, pos.to_fen()))
    return out


def test_hash_boards_bit_identical():
    fens = _playouts()
    jboards = jb.stack_boards([
        jb.from_position((JaxChess960 if c else JaxPosition).from_fen(f)) for c, f in fens
    ])
    tboards = tb.stack_boards([
        tb.from_position((Chess960Position if c else Position).from_fen(f)) for c, f in fens
    ])
    h1, h2 = jtt.hash_boards(jboards)
    got = tt.hash_boards(tboards)
    assert got.dtype == torch.int32 and got.shape == (len(fens), 2)
    assert np.array_equal(got[:, 0].numpy().view(np.uint32), np.asarray(h1))
    assert np.array_equal(got[:, 1].numpy().view(np.uint32), np.asarray(h2))
    # hash_board on strided row views gives the same keys
    rows = torch.cat([tboards.board, tboards.stm[:, None], tboards.ep[:, None],
                      tboards.castling], 1)
    again = tt.hash_board(rows[:, :64], rows[:, 64], rows[:, 65], rows[:, 66:70])
    assert torch.equal(again, got)


def test_single_board_matches_reference_one_lane():
    for fen in FENS:
        jb1 = jb.from_position(JaxPosition.from_fen(fen))
        h1, h2 = jax.jit(jtt.hash_board)(jb1.board, jb1.stm, jb1.ep, jb1.castling)
        got = tt.hash_boards(tb.from_position(Position.from_fen(fen)))[0].numpy().view(np.uint32)
        assert (int(got[0]), int(got[1])) == (int(h1), int(h2)), fen


def test_hash_distinguishes_stm_castling_ep_and_ignores_halfmove():
    keys = tt.hash_boards(tb.stack_boards(
        [tb.from_position(Position.from_fen(f)) for f in FENS]
    ))
    pairs = [tuple(k) for k in keys.tolist()]
    assert len(set(pairs[:5])) == 5
    assert pairs[5] == pairs[6]  # halfmove is not hashed


def test_kernel_wrapper_refuses_cpu_tensors():
    b = tb.from_position(Position.initial())
    z1, z2 = tt.tables(torch.device("cpu"))
    with pytest.raises(ValueError):
        kernels.zobrist_hash(b.board, b.stm, b.ep, b.castling, z1, z2)
