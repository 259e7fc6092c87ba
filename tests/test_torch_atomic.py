"""fishnet_tpu_torch's atomic chess against the JAX package's, on the CPU:
the host rules (legal moves, each child's FEN, the outcome and the check
state) on chip_smoke's atomic FENs and over seeded playouts; the device
rules — node_rules (adjacent kings, an exploded king), generate_moves
(kings never capture), make_move over every generated move (the blast,
castling rights lost to it, the a1 square) with move_piece_changes, and
the Zobrist keys (standard chess's and the atomic salt) — exactly;
run_segment_plain against the reference's segment, state for state, the
accumulator table included; a king-exploding capture's spot score; a
finished game at the root and in a searched line; and an atomic chunk
through GpuEngine(device="cpu") against TpuEngine, bit for bit on the
int8 net and within an eval's rounding (1 cp) on the f32 net."""
import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.chess.variants import from_fen as jax_from_fen
from fishnet_tpu.client.ipc import Chunk, WorkPosition, chunk_to_wire
from fishnet_tpu.client.ipc import response_to_wire as jax_response_to_wire
from fishnet_tpu.client.wire import AnalysisWork, EngineFlavor, NodeLimit
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import movegen as jm
from fishnet_tpu.ops import search as js
from fishnet_tpu.ops import tt as jtt
from fishnet_tpu_torch import ipc
from fishnet_tpu_torch.chess import from_fen
from fishnet_tpu_torch.engine.gpu import GpuEngine
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import movegen as tm
from fishnet_tpu_torch.ops import search as ts
from fishnet_tpu_torch.ops import tt as ttt
from fishnet_tpu_torch.ops.search import MATE
from chip_smoke import variant_positions
from test_torch_variants import (  # noqa: F401 (module fixtures)
    F32_SCORE_TOL, _chunk, _eq, _playout, _spot_score, _wire, nets, shipped_int8,
)

AT = "atomic"
B, P = 16, 8
A1_BLAST = "4k3/8/8/8/8/8/1r6/nR2K3 w - - 0 1"
KQQ_BLAST = "r3k2r/6p1/8/8/8/8/1B6/R3K2R w KQkq - 0 1"
KING_BLAST = "3nk3/8/8/8/8/8/8/3QK3 w - - 0 1"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _positions(n, seed):
    """n atomic positions from chip_smoke's FENs and playouts, as FENs."""
    return [p.to_fen() for p, _, _ in variant_positions(AT, n, seed)]


def _boards(fens):
    jboards = jb.stack_boards([jb.from_position(jax_from_fen(f, AT)) for f in fens])
    tboards = tb.stack_boards([tb.from_position(from_fen(f, AT)) for f in fens])
    return jboards, tboards


def test_host_rules_match_reference():
    """Legal moves, every child's FEN, the outcome and the check state
    equal the reference's on chip_smoke's atomic FENs and over seeded
    playouts (explosions, exploded kings and adjacent kings among them)."""
    pairs = _playout(AT, 3, 40, seed=5)
    pairs += [(jax_from_fen(f, AT), from_fen(f, AT)) for f in _positions(32, seed=5)]
    blasts = ends = 0
    for jp, tp in pairs:
        assert tp.to_fen() == jp.to_fen()
        assert type(tp).from_fen(tp.to_fen()).to_fen() == tp.to_fen()
        assert tp.outcome() == jp.outcome()
        assert tp.is_check() == jp.is_check()
        legal = sorted(m.uci() for m in tp.legal_moves())
        assert legal == sorted(m.uci() for m in jp.legal_moves())
        for uci in legal:
            jc, tc = jp.push(jp.parse_uci(uci)), tp.push(tp.parse_uci(uci))
            assert tc.to_fen() == jc.to_fen()
            assert tc.outcome() == jc.outcome()
            blasts += bin(tc.occ_all).count("1") < bin(tp.occ_all).count("1") - 1
        ends += tp.outcome() is not None
    assert blasts > 100 and ends > 0


@pytest.mark.parametrize("fen,uci,want", [
    (KING_BLAST, "d1d8", "8/8/8/8/8/8/8/4K3 b - - 0 1"),  # the king goes with d8
    (A1_BLAST, "b1b2", "4k3/8/8/8/8/8/8/4K3 b - - 0 1"),  # the a1 knight too
    ("k7/8/2n1b3/3p4/8/8/8/K2Q4 w - - 0 1", "d1d5", "k7/8/8/8/8/8/8/K7 b - - 0 1"),
    ("k7/8/8/2pp4/3P4/8/8/K7 w - - 0 1", "d4c5", "k7/8/8/3p4/8/8/8/K7 b - - 0 1"),
    (KQQ_BLAST, "b2g7", "r3k3/8/8/8/8/8/8/R3K2R b KQq - 0 1"),
    ("k7/2n5/8/3pP3/8/8/8/K7 w - d6 0 2", "e5d6", "k7/8/8/8/8/8/8/K7 b - - 0 2"),
])
def test_explosions(fen, uci, want):
    """chip_smoke's atomic blasts, child by child, in both packages."""
    tp, jp = from_fen(fen, AT), jax_from_fen(fen, AT)
    assert tp.push(tp.parse_uci(uci)).to_fen() == jp.push(jp.parse_uci(uci)).to_fen() == want


def test_atomic_legality_cases():
    """A king never captures; adjacent kings give no check; a capture
    that would blow up one's own king is illegal, and the king that stays
    in check has only its escapes."""
    king = from_fen("k7/8/8/8/8/8/1p6/K7 w - - 0 1", AT)
    assert sorted(m.uci() for m in king.legal_moves()) == ["a1a2", "a1b1"]
    assert not from_fen("8/8/8/8/8/1k6/1K6/4Q3 w - - 0 1", AT).is_check()
    own = from_fen("4k3/8/8/8/8/8/3p4/3QK3 w - - 0 1", AT)
    assert own.is_check() and "d1d2" not in {m.uci() for m in own.legal_moves()}
    moves, count, _ = tm.generate_moves(tb.from_position(king), variant=AT)
    assert sorted(moves[0, :int(count[0])].tolist()) == sorted(
        m.from_sq | (m.to_sq << 6) for m in king.legal_moves())


def test_device_rules_match_reference():
    """node_rules (illegal parents, checks, exploded kings), generate_moves
    with and without killers and history, make_move and move_piece_changes
    over every generated move, and node_rules and the Zobrist keys of the
    boards and of every child equal the reference's exactly; the children
    include the a1 blast, the KQq rights and exploded kings; the keys are
    standard chess's with the atomic salt."""
    fens = _positions(48, seed=9)
    jboards, tboards = _boards(fens)
    for f in tb.Board._fields:
        assert _eq(getattr(jboards, f), getattr(tboards, f)), f
    for w, g in zip(jax.vmap(lambda b: jb.node_rules(b, AT))(jboards),
                    tb.node_rules(tboards, variant=AT)):
        assert _eq(w, g)
    jmoves = jax.vmap(lambda b: jm.generate_moves(b, AT))(jboards)
    for w, g in zip(jmoves, tm.generate_moves(tboards, variant=AT)):
        assert _eq(w, g)
    n = len(fens)
    rng = np.random.default_rng(3)
    moves = np.asarray(jmoves[0])
    killers = np.stack([moves[:, 1], moves[:, 3]], 1)
    hist = rng.integers(0, 1 << 12, (n, 4096)).astype(np.int32)
    want = jax.vmap(lambda b, k, h: jm.generate_moves(b, AT, killers=k, hist=h))(
        jboards, killers, hist)
    got = tm.generate_moves(tboards, torch.from_numpy(killers), torch.from_numpy(hist),
                            variant=AT)
    for w, g in zip(want, got):
        assert _eq(w, g)
    keys = ttt.hash_boards(tboards, AT).numpy().view(np.uint32)
    h1, h2 = jtt.hash_boards(jboards, AT)
    assert np.array_equal(np.asarray(h1), keys[:, 0]) and np.array_equal(np.asarray(h2), keys[:, 1])
    salt = np.stack([z[ttt._VARIANT_OFF + tb.VARIANT_ID[AT]] for z in (ttt.Z1, ttt.Z2)])
    plain = ttt.hash_boards(tboards, "standard").numpy().view(np.uint32)
    assert (keys ^ plain == salt).all()

    count = np.asarray(jmoves[1])
    lane = np.repeat(np.arange(n), count)
    mv = np.concatenate([moves[i, :count[i]] for i in range(n)])
    jsel = jb.Board(*[np.asarray(a)[lane] for a in jboards])
    tsel = tb.Board(*[t[torch.from_numpy(lane)] for t in tboards])
    jchild = jax.vmap(lambda b, m: jb.make_move(b, m, AT))(jsel, mv)
    child_rows, codes, sqs, signs = tb.make_move_rows(tb.rows_from_board(tsel),
                                                      torch.from_numpy(mv), AT)
    child = tb.board_from_rows(child_rows)
    for f in tb.Board._fields:
        assert _eq(getattr(jchild, f), getattr(child, f)), f
    jchanges = jax.vmap(lambda b, m: jb.move_piece_changes(b, m, AT))(jsel, mv)
    for w, g in zip(jchanges, (codes, sqs, signs)):
        assert _eq(w, g)
    for w, g in zip(jax.vmap(lambda b: jb.node_rules(b, AT))(jchild),
                    tb.node_rules(child, variant=AT)):
        assert _eq(w, g)
    keys = ttt.hash_boards(child, AT).numpy().view(np.uint32)
    h1, h2 = jtt.hash_boards(jchild, AT)
    assert np.array_equal(np.asarray(h1), keys[:, 0]) and np.array_equal(np.asarray(h2), keys[:, 1])

    # the blasts among the children: the a1 knight, KQq, a dead king
    a1 = fens.index(A1_BLAST)
    rb2 = (lane == a1) & (mv == (1 | (9 << 6)))
    assert rb2.sum() == 1 and child.board[torch.from_numpy(rb2)][0, 0] == 0
    kqq = fens.index(KQQ_BLAST)
    bg7 = (lane == kqq) & (mv == (9 | (54 << 6)))
    assert child.castling[torch.from_numpy(bg7)].tolist() == [[7, 0, -1, 56]]
    lost = tb.node_rules(child, variant=AT)[2] == tb.TERM_LOSS
    assert lost.sum() > 0


@pytest.mark.parametrize("case", ["table", "no table"])
def test_run_segment_plain_matches_reference(shipped_int8, case):
    """run_segment_plain over segments of 1, 7 and 33 steps equals one
    reference segment of the same total on atomic roots: every state
    field, the table, the step count and the summary. The accumulator
    table past the roots' row stays as init_state left it (a board768
    leaf refreshes its pair: no child update in atomic)."""
    jp, tp = shipped_int8
    fens = _positions(B, seed=17)
    jroots, troots = _boards(fens)
    depth = np.asarray([1 + i % 3 for i in range(B)], np.int32)
    budgets = np.asarray([100_000 + 37 * i for i in range(B)], np.int32)
    steps = (1, 7, 33)
    want = js._init_state_jit(jp, jroots, jnp.asarray(depth), jnp.asarray(budgets), P,
                              variant=AT)
    jtable = jtt.make_table(12) if case == "table" else None
    want, jtable, n_want, summ_want = js._run_segment_jit(
        jp, want, jtable, sum(steps), AT, False, False, jnp.asarray(3))
    got = ts.init_state(tp, troots, torch.from_numpy(depth), torch.from_numpy(budgets), P,
                        variant=AT)
    acc0 = got.acc.clone()
    table = ttt.make_table(12, device="cpu") if case == "table" else None
    n_got = 0
    for n in steps:
        k, summ = ts.run_segment_plain(tp, got, n, True, table, False, False, 3, variant=AT)
        n_got += k
    for field, w, g in zip(ts.SearchState._fields, want, got):
        w = np.asarray(w)
        assert np.array_equal(g.numpy(), w.view(np.int32) if w.dtype == np.uint32 else w), field
    if table is not None:
        assert np.array_equal(table.numpy(), np.asarray(jtable.data).view(np.int32))
    assert n_got == int(n_want)
    assert np.array_equal(summ[:B].numpy(), np.asarray(summ_want)[:B])
    assert torch.equal(got.acc, acc0) and not got.acc[:, 1:].any()
    assert int(got.lane[:, ts.LN_NODES].sum()) > 200


def test_exploding_the_king_wins(nets):
    """Qxd8 blows up the king beside d8: the spot search scores a win."""
    assert _spot_score(nets, KING_BLAST, AT) >= MATE - 10


def _atomic_chunk(fens_moves, depth=2):
    work = AnalysisWork(id="atomicck", nodes=NodeLimit(sf16=4_000_000, classical=8_000_000),
                        timeout_s=30.0, depth=depth)
    positions = [WorkPosition(work=work, position_index=i, url=None, skip=False, root_fen=f,
                              moves=m) for i, (f, m) in enumerate(fens_moves)]
    return Chunk(work=work, deadline=time.monotonic() + 600, variant=AT,
                 flavor=EngineFlavor.TPU, positions=positions)


def _both(jp, tp, chunk, refill=False):
    from fishnet_tpu.engine.tpu import TpuEngine

    wire = chunk_to_wire(chunk)
    depth = chunk.work.depth
    ref = TpuEngine(params=jp, max_depth=depth, tt_size_log2=0, helper_lanes=1, refill=False)
    want = _wire(asyncio.run(ref.go_multiple(chunk)), jax_response_to_wire)
    port = GpuEngine(params=tp, max_depth=depth, tt_size_log2=0, helper_lanes=1, device="cpu",
                     refill=refill)
    got = _wire(asyncio.run(port.go_multiple(ipc.chunk_from_wire(wire))), ipc.response_to_wire)
    return got, want


def test_game_ends_at_the_root_and_in_the_line(shipped_int8):
    """A root whose king exploded is a finished game, answered as
    TpuEngine answers it; a root whose best move explodes the enemy king
    reports mate in one, its PV that one capture; with refill on too."""
    jp, tp = shipped_int8
    chunk = _atomic_chunk([(KING_BLAST, ["d1d8"]), (KING_BLAST, []), (A1_BLAST, [])])
    for refill in (False, True):
        got, want = _both(jp, tp, chunk, refill)
        assert got == want
        assert got[0]["best_move"] is None and got[0]["depth"] == 0
        assert got[1]["best_move"] == "d1d8" and got[1]["pvs"][0][-1] == ["d1d8"]
        assert got[1]["scores"][0][-1] == {"mate": 1}


@pytest.mark.parametrize("net", ["int8", "f32"])
def test_atomic_chunk_matches_tpu_engine(nets, net):
    """An atomic chunk (one seeded game, captures and blasts in play)
    through GpuEngine(device="cpu") against TpuEngine, no table, no
    helpers, chunk-serial on both sides: the int8 responses are equal,
    the f32 scores within F32_SCORE_TOL (equal scores, equal best moves)."""
    jp, tp = nets[net]
    got, want = _both(jp, tp, _chunk(AT, (4, 9), seed=21))
    assert all(g["depth"] == 2 and g["best_move"] is not None for g in got)
    if net == "int8":
        assert got == want
        return
    for g, w in zip(got, want):
        for gc, wc in zip(sum(g["scores"], []), sum(w["scores"], [])):
            assert (gc is None) == (wc is None)
            if gc is not None:
                (gk, gv), = gc.items()
                (wk, wv), = wc.items()
                assert gk == wk and abs(gv - wv) <= (0 if gk == "mate" else F32_SCORE_TOL)
        if g["scores"] == w["scores"]:
            assert g["best_move"] == w["best_move"]
