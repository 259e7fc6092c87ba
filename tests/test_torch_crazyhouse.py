"""fishnet_tpu_torch's crazyhouse against the JAX package's, on the CPU:
the host rules (legal moves with drops, FEN round trips in both pocket
forms and with `~` promoted markers, the pocket after a promoted piece is
captured) over seeded playouts; the device rules — from_position's
pocket and promoted words, generate_moves (drops keyed after the board's
quiets, history on the drop slot, killers), make_move and
move_piece_changes over every generated move, node_rules and the Zobrist
keys — exactly; run_segment_plain against the reference's segment, state
for state; a mating drop; and a crazyhouse chunk through
GpuEngine(device="cpu") against TpuEngine, bit for bit on the int8 net
and within an eval's rounding (1 cp) on the f32 net.

The positions come from chip_smoke.variant_positions over its crazyhouse
FENs (mid, heavy and full pockets; a promotion and the capture of a
promoted queen; promoted bits in both words; a pocket pawn with no square
to drop on; a mating drop), as on the card."""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.chess.variants import from_fen as jax_from_fen
from fishnet_tpu.client.ipc import chunk_to_wire
from fishnet_tpu.client.ipc import response_to_wire as jax_response_to_wire
from fishnet_tpu.engine import tpu as jax_tpu
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import movegen as jm
from fishnet_tpu.ops import search as js
from fishnet_tpu.ops import tt as jtt
from fishnet_tpu_torch import ipc
from fishnet_tpu_torch.chess import from_fen
from fishnet_tpu_torch.engine import gpu
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

ZH = "crazyhouse"
B, P = 16, 8


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
    """n crazyhouse positions from chip_smoke's FENs and playouts, as FENs."""
    return [p.to_fen() for p, _, _ in variant_positions(ZH, n, seed)]


def _boards(fens):
    jboards = jb.stack_boards([jb.from_position(jax_from_fen(f, ZH)) for f in fens])
    tboards = tb.stack_boards([tb.from_position(from_fen(f, ZH)) for f in fens])
    return jboards, tboards


def test_host_rules_match_reference():
    """Legal moves (drops among them), the FEN with its pockets and `~`
    markers, the outcome and the check state equal the reference's over
    seeded playouts from the starting position and from chip_smoke's
    crazyhouse FENs."""
    pairs = _playout(ZH, 3, 60, seed=5)
    fens = _positions(48, seed=5)
    pairs += [(jax_from_fen(f, ZH), from_fen(f, ZH)) for f in fens]
    drops = 0
    for jp, tp in pairs:
        assert tp.to_fen() == jp.to_fen()
        legal = sorted(m.uci() for m in tp.legal_moves())
        assert legal == sorted(m.uci() for m in jp.legal_moves())
        drops += sum("@" in u for u in legal)
        assert tp.outcome() == jp.outcome()
        assert tp.is_check() == jp.is_check()
        assert tp.pockets == jp.pockets and tp.promoted == jp.promoted
    assert drops > 1000


@pytest.mark.parametrize("fen", [
    "r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N2/PPPP1PPP/RNBQKB1R[Pn] w KQkq - 2 3",
    "r1bqkbnr/pppp1ppp/2n5/4p3/4P3/5N2/PPPP1PPP/RNBQKB1R/Pn w KQkq - 2 3",  # ninth rank
    "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR[] w KQkq - 0 1",
    "3k3Q~/8/8/8/r6N~/8/8/4K3[Pb] b - - 0 20",
    "r1b1k2r/ppp2ppp/2n5/3q4/3P4/2P2N2/P4PPP/R2QKB1R/- w KQkq - 0 10",
])
def test_fen_round_trip_matches_reference(fen):
    """Both pocket forms ([...] and a ninth rank) and `~` parse as the
    reference parses them and print in its [...] form; the printed FEN
    reads back to itself."""
    jp, tp = jax_from_fen(fen, ZH), from_fen(fen, ZH)
    assert tp.to_fen() == jp.to_fen()
    assert (tp.pockets, tp.promoted) == (jp.pockets, jp.promoted)
    assert from_fen(tp.to_fen(), ZH).to_fen() == tp.to_fen()


def test_promoted_capture_fills_pocket_with_a_pawn():
    """A promotion marks its square; the promoted queen's capture gives
    the capturer a pawn, in both packages and on the device board."""
    fen = "k6K/8/8/8/8/8/p7/1R6[] b - - 0 1"
    jp, tp = jax_from_fen(fen, ZH), from_fen(fen, ZH)
    for uci in ("a2a1q", "b1a1"):
        jp, tp = jp.push(jp.parse_uci(uci)), tp.push(tp.parse_uci(uci))
        assert tp.to_fen() == jp.to_fen()
        for f in tb.Board._fields:
            assert _eq(getattr(jb.from_position(jp), f), getattr(tb.from_position(tp), f)[0]), f
    assert tp.pockets == [[1, 0, 0, 0, 0], [0] * 5] and tp.promoted == 0


def test_from_position_extra_words():
    """The pockets go into extra[0:10] and the promoted bitboard into
    extra[10:12] as signed int32 (h4, bit 31, reads negative), as the
    reference's."""
    fen = "3k3Q~/8/8/8/r6N~/8/8/4K3[PPb] b - - 0 20"
    b = tb.from_position(from_fen(fen, ZH))
    assert _eq(jb.from_position(jax_from_fen(fen, ZH)).extra, b.extra[0])
    assert b.extra[0, tb.EXTRA_POCKET:tb.EXTRA_POCKET + 10].tolist() == [2, 0, 0, 0, 0,
                                                                        0, 0, 1, 0, 0]
    assert b.extra[0, tb.EXTRA_PROMOTED].item() == -2**31  # h4
    assert b.extra[0, tb.EXTRA_PROMOTED + 1].item() == -2**31  # h8


def test_device_rules_match_reference():
    """generate_moves with and without killers and history (drops to the
    killer slot and drops with history counters among them), make_move
    and move_piece_changes over every generated move (pockets, promoted
    bits, one change slot a drop), node_rules and the Zobrist keys of the
    boards and of every child, exactly; the move lists are 544 wide, and
    one of them holds the full pocket's 299 moves."""
    fens = _positions(40, seed=9)
    jboards, tboards = _boards(fens)
    for f in tb.Board._fields:
        assert _eq(getattr(jboards, f), getattr(tboards, f)), f
    for w, g in zip(jax.vmap(lambda b: jb.node_rules(b, ZH))(jboards),
                    tb.node_rules(tboards, variant=ZH)):
        assert _eq(w, g)
    jmoves = jax.vmap(lambda b: jm.generate_moves(b, ZH))(jboards)
    got = tm.generate_moves(tboards, variant=ZH)
    for w, g in zip(jmoves, got):
        assert _eq(w, g)
    assert got[0].shape == (len(fens), tm.MAX_MOVES_ZH) == (len(fens), 544)
    assert int(got[1].max()) == 299
    n = len(fens)
    rng = np.random.default_rng(3)
    moves = np.asarray(jmoves[0])
    drop_at = np.argmax(moves >= tm.DROP_FLAG, axis=1)  # a drop of each lane, if any
    killers = np.stack([moves[:, 1], moves[np.arange(n), drop_at]], 1)
    hist = rng.integers(0, 1 << 12, (n, 4096)).astype(np.int32)
    want = jax.vmap(lambda b, k, h: jm.generate_moves(b, ZH, killers=k, hist=h))(
        jboards, killers, hist)
    got = tm.generate_moves(tboards, torch.from_numpy(killers), torch.from_numpy(hist),
                            variant=ZH)
    for w, g in zip(want, got):
        assert _eq(w, g)
    h1, h2 = jtt.hash_boards(jboards, ZH)
    keys = ttt.hash_boards(tboards, ZH).numpy().view(np.uint32)
    assert np.array_equal(np.asarray(h1), keys[:, 0]) and np.array_equal(np.asarray(h2), keys[:, 1])

    count = np.asarray(jmoves[1])
    lane = np.repeat(np.arange(n), count)
    mv = np.concatenate([moves[i, :count[i]] for i in range(n)])
    assert (mv >= tm.DROP_FLAG).sum() > 1000
    jsel = jb.Board(*[np.asarray(a)[lane] for a in jboards])
    tsel = tb.Board(*[t[torch.from_numpy(lane)] for t in tboards])
    jchild = jax.vmap(lambda b, m: jb.make_move(b, m, ZH))(jsel, mv)
    child_rows, codes, sqs, signs = tb.make_move_rows(tb.rows_from_board(tsel),
                                                      torch.from_numpy(mv), ZH)
    child = tb.board_from_rows(child_rows)
    for f in tb.Board._fields:
        assert _eq(getattr(jchild, f), getattr(child, f)), f
    jchanges = jax.vmap(lambda b, m: jb.move_piece_changes(b, m, ZH))(jsel, mv)
    for w, g in zip(jchanges, (codes, sqs, signs)):
        assert _eq(w, g)
    drop = torch.from_numpy(mv >= tm.DROP_FLAG)
    assert (codes[drop][:, [0, 1, 3]] == 0).all() and (codes[drop][:, 2] > 0).all()
    for w, g in zip(jax.vmap(lambda b: jb.node_rules(b, ZH))(jchild),
                    tb.node_rules(child, variant=ZH)):
        assert _eq(w, g)
    h1, h2 = jtt.hash_boards(jchild, ZH)
    keys = ttt.hash_boards(child, ZH).numpy().view(np.uint32)
    assert np.array_equal(np.asarray(h1), keys[:, 0]) and np.array_equal(np.asarray(h2), keys[:, 1])


def test_history_ordering_drop_slot():
    """tests/test_device_board.py's drop-slot pin on the port: a drop's
    history counter is to << 6 | to's, and the bumped drop orders first
    among the drops; the lists equal the reference's."""
    fen = "rnb1kbnr/ppp1pppp/8/3p4/3P4/8/PPPqPPPP/RNBQKBNR[Nn] w KQkq - 0 4"
    to_sq = 16  # N@a3
    drop_mv = tm.DROP_FLAG | (1 << 12) | (to_sq << 6) | to_sq
    hist = np.zeros((1, 4096), np.int32)
    hist[0, ((to_sq << 6) | to_sq) & 4095] = 1 << 16
    killers = np.full((1, 2), -1, np.int32)
    moves, count, _ = tm.generate_moves(tb.from_position(from_fen(fen, ZH)),
                                        torch.from_numpy(killers), torch.from_numpy(hist),
                                        variant=ZH)
    moves = moves[0, :int(count[0])].tolist()
    drops = [m for m in moves if m & tm.DROP_FLAG]
    assert drops[0] == drop_mv and len(drops) > 20
    want = jm.generate_moves(jb.from_position(jax_from_fen(fen, ZH)), ZH,
                             killers=jnp.asarray(killers[0]), hist=jnp.asarray(hist[0]))
    assert np.asarray(want[0])[:int(count[0])].tolist() == moves


@pytest.mark.parametrize("case", ["table", "no table"])
def test_run_segment_plain_matches_reference(shipped_int8, case):
    """run_segment_plain over segments of 1, 7 and 33 steps equals one
    reference segment of the same total on crazyhouse roots (pockets,
    promoted pieces, full pockets): every state field (the 544-wide move
    lists among them), the table, the step count and the summary."""
    jp, tp = shipped_int8
    fens = _positions(B, seed=17)
    jroots, troots = _boards(fens)
    depth = np.asarray([1 + i % 3 for i in range(B)], np.int32)
    budgets = np.asarray([100_000 + 37 * i for i in range(B)], np.int32)
    steps = (1, 7, 33)
    want = js._init_state_jit(jp, jroots, jnp.asarray(depth), jnp.asarray(budgets), P,
                              variant=ZH)
    jtable = jtt.make_table(12) if case == "table" else None
    want, jtable, n_want, summ_want = js._run_segment_jit(
        jp, want, jtable, sum(steps), ZH, False, False, jnp.asarray(3))
    got = ts.init_state(tp, troots, torch.from_numpy(depth), torch.from_numpy(budgets), P,
                        variant=ZH)
    assert got.moves.shape == (B, P, 544)
    table = ttt.make_table(12, device="cpu") if case == "table" else None
    n_got = 0
    for n in steps:
        k, summ = ts.run_segment_plain(tp, got, n, True, table, False, False, 3, variant=ZH)
        n_got += k
    for field, w, g in zip(ts.SearchState._fields, want, got):
        w = np.asarray(w)
        assert np.array_equal(g.numpy(), w.view(np.int32) if w.dtype == np.uint32 else w), field
    if table is not None:
        assert np.array_equal(table.numpy(), np.asarray(jtable.data).view(np.int32))
    assert n_got == int(n_want)
    assert np.array_equal(summ[:B].numpy(), np.asarray(summ_want)[:B])
    assert (got.moves >= tm.DROP_FLAG).any()


def test_mating_drop(nets):
    """R@a8-e8 mate: the spot search (depth 2, so that the mated side's
    node expands) scores a mate in one."""
    assert _spot_score(nets, "6k1/5ppp/8/8/8/8/5PPP/6K1[R] w - - 0 1", ZH, 2) == MATE - 1


def test_drop_uci_matches_reference():
    """A drop prints as the reference's UCI ("N@a3"); the other moves as
    before."""
    for m in (tm.DROP_FLAG | (1 << 12) | (16 << 6) | 16, tm.DROP_FLAG | (20 << 6) | 20,
              12 | (28 << 6), 52 | (60 << 6) | (4 << 12)):
        assert gpu._decode_uci(m) == jax_tpu._decode_uci(m)
    assert gpu._decode_uci(tm.DROP_FLAG | (1 << 12) | (16 << 6) | 16) == "N@a3"
    assert tm.max_moves_for(ZH) == jm.max_moves_for(ZH) == 544


@pytest.mark.parametrize("net", ["int8", "f32"])
def test_crazyhouse_chunk_matches_tpu_engine(nets, net):
    """A crazyhouse chunk (one seeded game, pockets and drops in play)
    through GpuEngine(device="cpu") against TpuEngine, no table, no
    helpers, chunk-serial on both sides: the int8 responses are equal,
    the f32 scores within F32_SCORE_TOL (equal scores, equal best moves)."""
    from fishnet_tpu.engine.tpu import TpuEngine

    jp, tp = nets[net]
    chunk = _chunk(ZH, (4, 6), seed=21)  # white's pocket pawn, then P@d4
    wire = chunk_to_wire(chunk)
    assert any("@" in m for m in chunk.positions[-1].moves)
    ref = TpuEngine(params=jp, max_depth=2, tt_size_log2=0, helper_lanes=1, refill=False)
    want = _wire(asyncio.run(ref.go_multiple(chunk)), jax_response_to_wire)
    port = GpuEngine(params=tp, max_depth=2, tt_size_log2=0, helper_lanes=1, device="cpu")
    got = _wire(asyncio.run(port.go_multiple(ipc.chunk_from_wire(wire))), ipc.response_to_wire)
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
