"""fishnet_tpu_torch's device board and move generator against the JAX
package's, on the CPU: node_rules, make_move, move_piece_changes and
generate_moves (moves, count, noisy; with and without killers/history)
must be identical on playout, tactical, castling and chess960 positions.
Positions are batched into one call per function: 64 lanes, padded."""
import random

import jax
import numpy as np
import pytest
import torch

from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.chess.position import Chess960Position as JaxChess960
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import movegen as jm
from fishnet_tpu_torch.chess import Chess960Position, Position
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import movegen as tm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 64  # lanes per batched call (one JAX compile per function)

TACTICAL = [
    "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1",
    "r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1",
    "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1",
    "r3k2r/8/8/8/8/8/8/R3K2R w KQkq - 0 1",
    "r3k2r/8/8/8/8/8/8/R3K2R b KQkq - 0 1",
]
CHESS960 = [
    "bqnb1rkr/pp3ppp/3ppn2/2p5/5P2/P2P4/NPP1P1PP/BQ1BNRKR w HFhf - 2 9",
    "b1q1rrkb/pppppppp/3nn3/8/P7/1PPP4/4PPPP/BQNNRKRB w GE - 1 9",
]


def _playout_fens(start_fens, plies, seed, cls=JaxPosition):
    rng = random.Random(seed)
    out = []
    for fen in start_fens:
        pos = cls.from_fen(fen)
        for _ in range(plies):
            legal = pos.legal_moves()
            if not legal:
                break
            out.append((fen, pos.to_fen()))
            pos = pos.push(rng.choice(legal))
    return out


@pytest.fixture(scope="module")
def fens():
    """(chess960?, fen) pairs: random playouts from the start, from the
    tactical FENs and from chess960 starts, sampled down to N."""
    std = [f for _, f in _playout_fens(
        [JaxPosition.initial().to_fen()] * 3 + TACTICAL, 24, seed=42)]
    c960 = [f for _, f in _playout_fens(CHESS960, 24, seed=3, cls=JaxChess960)]
    rng = random.Random(0)
    picked = [(False, f) for f in TACTICAL] + [(True, f) for f in CHESS960]
    picked += [(True, f) for f in rng.sample(c960, 16)]
    picked += [(False, f) for f in rng.sample(std, N - len(picked))]
    return picked


def _boards(fens):
    jax_boards, torch_boards = [], []
    for is960, fen in fens:
        jcls, tcls = (JaxChess960, Chess960Position) if is960 else (JaxPosition, Position)
        jax_boards.append(jb.from_position(jcls.from_fen(fen)))
        torch_boards.append(tb.from_position(tcls.from_fen(fen)))
    return jb.stack_boards(jax_boards), tb.stack_boards(torch_boards)


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


def test_from_position_matches(fens):
    jboards, tboards = _boards(fens)
    for f in tb.Board._fields:
        assert _eq(getattr(jboards, f), getattr(tboards, f)), f


def test_node_rules_and_in_check(fens):
    jboards, tboards = _boards(fens)
    illegal_j, checked_j, term_j = jax.jit(jax.vmap(jb.node_rules))(jboards)
    illegal_t, checked_t, term_t = tb.node_rules(tboards)
    assert _eq(illegal_j, illegal_t)
    assert _eq(checked_j, checked_t)
    assert _eq(term_j, term_t)
    assert _eq(checked_j, tb.in_check(tboards))
    sq = np.random.default_rng(2).integers(0, 64, N).astype(np.int32)
    for color in (0, 1):
        by = np.full(N, color, np.int32)
        want = jax.jit(jax.vmap(jb.is_attacked))(jboards.board, sq, by)
        assert _eq(want, tb.is_attacked(tboards.board, torch.from_numpy(sq),
                                        torch.from_numpy(by)))
    host = [(Chess960Position if is960 else Position).from_fen(f).is_check()
            for is960, f in fens]
    assert tb.in_check(tboards).tolist() == host


@pytest.mark.parametrize("ordering", ["plain", "killers_history"])
def test_generate_moves_matches(fens, ordering):
    jboards, tboards = _boards(fens)
    if ordering == "plain":
        jout = jax.jit(jax.vmap(jm.generate_moves))(jboards)
        tout = tm.generate_moves(tboards)
    else:
        rng = np.random.default_rng(1)
        # killers drawn from real move encodings so they hit quiet moves
        plain = tm.generate_moves(tboards)[0].numpy()
        killers = np.stack([plain[:, 5], plain[:, 9]], 1).astype(np.int32)
        killers[::4, 1] = -1
        hist = rng.integers(0, 1 << 12, (N, 4096)).astype(np.int32)
        jout = jax.jit(jax.vmap(
            lambda b, k, h: jm.generate_moves(b, killers=k, hist=h)
        ))(jboards, killers, hist)
        tout = tm.generate_moves(
            tboards, killers=torch.from_numpy(killers), hist=torch.from_numpy(hist)
        )
    for name, a, b in zip(("moves", "count", "noisy"), jout, tout):
        assert _eq(a, b), name


def test_generated_moves_are_the_host_pseudo_legal_set(fens):
    _, tboards = _boards(fens)
    moves, count, _ = tm.generate_moves(tboards)
    for lane, (is960, fen) in enumerate(fens):
        pos = (Chess960Position if is960 else Position).from_fen(fen)
        host = set()
        for m in pos.generate_pseudo_legal():
            promo = 0 if m.promotion is None else m.promotion
            host.add(m.from_sq | (m.to_sq << 6) | (promo << 12))
        got = set(moves[lane, : int(count[lane])].tolist())
        assert got == host, fen


def test_make_move_and_piece_changes_match(fens):
    """Every generated move of every lane, applied in both packages."""
    jboards, tboards = _boards(fens)
    moves, count, _ = tm.generate_moves(tboards)
    lane_idx, move = [], []
    for lane in range(N):
        for k in range(0, int(count[lane]), 3):  # every third move
            lane_idx.append(lane)
            move.append(int(moves[lane, k]))
    idx = np.asarray(lane_idx)
    mv = np.asarray(move, np.int32)
    jsel = jb.Board(*[np.asarray(a)[idx] for a in jboards])
    tsel = tb.Board(*[t[torch.from_numpy(idx)] for t in tboards])
    jchild = jax.jit(jax.vmap(jb.make_move))(jsel, mv)
    tchild = tb.make_move(tsel, torch.from_numpy(mv))
    for f in tb.Board._fields:
        assert _eq(getattr(jchild, f), getattr(tchild, f)), f
    jchanges = jax.jit(jax.vmap(jb.move_piece_changes))(jsel, mv)
    tchanges = tb.move_piece_changes(tsel, torch.from_numpy(mv))
    for name, a, b in zip(("codes", "sqs", "signs"), jchanges, tchanges):
        assert _eq(a, b), name
    child2, *changes2 = tb.make_move_with_changes(tsel, torch.from_numpy(mv))
    for a, b in zip(tchild, child2):
        assert torch.equal(a, b)
    for a, b in zip(tchanges, changes2):
        assert torch.equal(a, b)


def test_castling_moves_applied_like_the_host():
    pos = Position.from_fen("r3k2r/8/8/8/8/8/8/R3K2R w KQkq - 0 1")
    for uci in ("e1h1", "e1a1"):
        m = pos.parse_uci(uci)
        child = tb.make_move(
            tb.from_position(pos),
            torch.tensor([m.from_sq | (m.to_sq << 6)], dtype=torch.int32),
        )
        want = tb.from_position(pos.push(m))
        for f in ("board", "stm", "ep", "halfmove"):
            assert torch.equal(getattr(child, f), getattr(want, f)), (uci, f)
        assert sorted(child.castling[0].tolist()) == sorted(want.castling[0].tolist())


def test_hist_index_tables_match_candidates():
    """The static from|to table equals `cand & 4095` for every candidate
    slot but the two castling slots, for both sides to move, in standard
    chess and in crazyhouse (whose drop slots follow castling); atomic
    keeps standard chess's table and width, and a variant no layer knows
    has none."""
    from fishnet_tpu_torch.chess import from_fen

    for variant in ("standard", "crazyhouse"):
        tables = tm._hist_idx_tables(variant)
        drops = 5 * 64 if variant == "crazyhouse" else 0
        for color, fen in enumerate((
            "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1",
            "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR b KQkq - 0 1",
        )):
            flat_moves, _, _ = tm._candidate_space(tb.from_position(from_fen(fen, variant)),
                                                   variant=variant)
            cands = flat_moves[0].numpy() & 4095
            assert cands.shape == tables[color].shape
            castling = slice(cands.shape[0] - drops - 2, cands.shape[0] - drops)
            keep = np.ones(cands.shape[0], bool)
            keep[castling] = False
            assert np.array_equal(cands[keep], tables[color][keep])
    assert tm.max_moves_for("crazyhouse") == tm.MAX_MOVES_ZH
    assert tm._hist_idx_tables("atomic")[0].tolist() == tm._hist_idx_tables()[0].tolist()
    assert tm.max_moves_for("atomic") == tm.MAX_MOVES
    with pytest.raises(NotImplementedError):
        tm.max_moves_for("bughouse")
