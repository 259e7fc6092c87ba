"""fishnet_tpu_torch's lichess variants (threeCheck, kingOfTheHill,
racingKings, horde, antichess) against the JAX package's, on the CPU:
the host rules (legal moves, FEN round trip, outcome) over seeded
playouts; the device rules — from_position's extra words, node_rules
(term kinds included), generate_moves, make_move over every generated
move and the Zobrist keys — exactly; search_batch on the int8 net field
for field and on the f32 net within an eval's rounding; the rule cases of
tests/test_device_variants.py; the null child keeping threeCheck's
counters; a variant chunk through GpuEngine(device="cpu") against
TpuEngine under int8, and a mixed-variant queue whose drive sessions each
run one variant. A variant name that no layer knows stays refused
(crazyhouse and atomic have their own files, tests/test_torch_crazyhouse.py
and tests/test_torch_atomic.py)."""
import asyncio
import random
import time

import jax
import numpy as np
import pytest
import torch

from fishnet_tpu.chess.variants import from_fen as jax_from_fen
from fishnet_tpu.chess.variants import position_class as jax_position_class
from fishnet_tpu.client.ipc import Chunk, WorkPosition, chunk_to_wire
from fishnet_tpu.client.ipc import response_to_wire as jax_response_to_wire
from fishnet_tpu.client.wire import AnalysisWork, EngineFlavor, NodeLimit
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import movegen as jm
from fishnet_tpu.ops import search as js
from fishnet_tpu.ops import tt as jtt
from fishnet_tpu.ops.search import search_batch_jit
from fishnet_tpu_torch import ipc
from fishnet_tpu_torch.chess import VARIANTS, from_fen, position_class
from fishnet_tpu_torch.engine import gpu
from fishnet_tpu_torch.engine.gpu import GpuEngine
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import movegen as tm
from fishnet_tpu_torch.ops import search as ts
from fishnet_tpu_torch.ops import tt as ttt
from fishnet_tpu_torch.ops.search import MATE, search_batch
from chip_smoke import variant_positions
from test_device_variants import _variant_fens
from test_torch_search import ITALIAN, QUEEN_UP, START


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


VARIANTS_PORTED = ["threeCheck", "kingOfTheHill", "racingKings", "horde", "antichess"]
FIELDS = ("score", "move", "nodes", "pv", "pv_len")
# the f32 searches agree within an eval's last-bit truncation (ROADMAP.md
# Queue 3 item 2); mate scores exactly
F32_SCORE_TOL = 1
NULL_STEPS = 330  # steps of the null-move comparison


@pytest.fixture(scope="module", params=VARIANTS_PORTED)
def variant(request):
    return request.param


@pytest.fixture(scope="module")
def nets():
    """tests/test_device_variants.py's net (init_params at l1 32, h1 8,
    h2 8, board768) and its int8 quantization, in both packages."""
    jp = jn.init_params(jax.random.PRNGKey(0), l1=32, h1=8, h2=8, feature_set="board768")
    out = {}
    for name, p in (("f32", jp), ("int8", jn.quantize_int8(jp))):
        tp = tn.params_from_numpy({f: np.asarray(getattr(p, f)) for f in jn.NnueParams._fields},
                                  "cpu")
        out[name] = (p, tp)
    return out


def _playout(variant, games, plies, seed):
    """Seeded random playouts of a variant from its starting position, in
    both packages: → [(jax Position, port Position)], every position
    before and including a game end."""
    rng = random.Random(seed)
    out = []
    for _ in range(games):
        jp = jax_position_class(variant).initial()
        tp = position_class(variant).initial()
        for _ in range(plies):
            out.append((jp, tp))
            legal = jp.legal_moves()
            if not legal or jp.outcome() is not None:
                break
            uci = rng.choice(legal).uci()
            jp, tp = jp.push(jp.parse_uci(uci)), tp.push(tp.parse_uci(uci))
    return out


def test_host_rules_match_reference(variant):
    """Legal moves, the FEN (check counters included), the outcome and
    the check state equal the reference's over seeded playouts."""
    pairs = _playout(variant, 4, 60, seed=5)
    assert len(pairs) > 60
    for jp, tp in pairs:
        assert tp.to_fen() == jp.to_fen()
        assert type(tp).from_fen(tp.to_fen()).to_fen() == tp.to_fen()
        assert sorted(m.uci() for m in tp.legal_moves()) == sorted(
            m.uci() for m in jp.legal_moves())
        assert tp.outcome() == jp.outcome()
        assert tp.is_check() == jp.is_check()
    assert from_fen(pairs[-1][1].to_fen(), variant).to_fen() == pairs[-1][1].to_fen()
    assert position_class("3check") is position_class("threeCheck")


def _rule_boards(variant):
    """Playout positions plus tests/test_device_variants.py's seeded FENs,
    batched in both packages."""
    fens = [tp.to_fen() for _, tp in _playout(variant, 3, 40, seed=9)]
    fens += _variant_fens(variant, 8)
    jboards = jb.stack_boards([jb.from_position(jax_from_fen(f, variant)) for f in fens])
    tboards = tb.stack_boards([tb.from_position(from_fen(f, variant)) for f in fens])
    return jboards, tboards


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


def test_device_rules_match_reference(variant):
    """from_position (castling rights dropped where the variant has none,
    threeCheck's counters in extra), node_rules with its term kinds,
    generate_moves with and without killers and history, make_move and
    move_piece_changes over every generated move (the child's extra words
    included), and the Zobrist keys of the boards and of every child."""
    jboards, tboards = _rule_boards(variant)
    for f in tb.Board._fields:
        assert _eq(getattr(jboards, f), getattr(tboards, f)), f
    want = jax.vmap(lambda b: jb.node_rules(b, variant))(jboards)
    for w, g in zip(want, tb.node_rules(tboards, variant=variant)):
        assert _eq(w, g)
    jmoves = jax.vmap(lambda b: jm.generate_moves(b, variant))(jboards)
    for w, g in zip(jmoves, tm.generate_moves(tboards, variant=variant)):
        assert _eq(w, g)
    B = tboards.board.shape[0]
    rng = np.random.default_rng(3)
    killers = np.stack([np.asarray(jmoves[0])[:, 1], np.asarray(jmoves[0])[:, 4]], 1)
    hist = rng.integers(0, 1 << 12, (B, 4096)).astype(np.int32)
    want = jax.vmap(lambda b, k, h: jm.generate_moves(b, variant, killers=k, hist=h))(
        jboards, killers, hist)
    got = tm.generate_moves(tboards, torch.from_numpy(killers), torch.from_numpy(hist),
                            variant=variant)
    for w, g in zip(want, got):
        assert _eq(w, g)
    h1, h2 = jtt.hash_boards(jboards, variant)
    keys = ttt.hash_boards(tboards, variant).numpy().view(np.uint32)
    assert np.array_equal(np.asarray(h1), keys[:, 0]) and np.array_equal(np.asarray(h2), keys[:, 1])

    count = np.asarray(jmoves[1])
    lane = np.repeat(np.arange(B), count)
    mv = np.concatenate([np.asarray(jmoves[0])[i, :count[i]] for i in range(B)])
    jsel = jb.Board(*[np.asarray(a)[lane] for a in jboards])
    tsel = tb.Board(*[t[torch.from_numpy(lane)] for t in tboards])
    jchild = jax.vmap(lambda b, m: jb.make_move(b, m, variant))(jsel, mv)
    child_rows, codes, sqs, signs = tb.make_move_rows(tb.rows_from_board(tsel),
                                                      torch.from_numpy(mv), variant)
    child = tb.board_from_rows(child_rows)
    for f in tb.Board._fields:
        assert _eq(getattr(jchild, f), getattr(child, f)), f
    jchanges = jax.vmap(lambda b, m: jb.move_piece_changes(b, m, variant))(jsel, mv)
    for w, g in zip(jchanges, (codes, sqs, signs)):
        assert _eq(w, g)
    for w, g in zip(jax.vmap(lambda b: jb.node_rules(b, variant))(jchild),
                    tb.node_rules(child, variant=variant)):
        assert _eq(w, g)
    h1, h2 = jtt.hash_boards(jchild, variant)
    keys = ttt.hash_boards(child, variant).numpy().view(np.uint32)
    assert np.array_equal(np.asarray(h1), keys[:, 0]) and np.array_equal(np.asarray(h2), keys[:, 1])
    # the standard keys differ from every variant's (one table serves all)
    std = ttt.hash_boards(tboards).numpy()
    assert not (std == ttt.hash_boards(tboards, variant).numpy()).all(1).any()


def _search_both(nets, net, variant, fens, depth):
    jp, tp = nets[net]
    jroots = jb.stack_boards([jb.from_position(jax_from_fen(f, variant)) for f in fens])
    troots = tb.stack_boards([tb.from_position(from_fen(f, variant)) for f in fens])
    want = search_batch_jit(jp, jroots, depth, 100_000, max_ply=4, variant=variant)
    got = search_batch(tp, troots, depth, 100_000, max_ply=4, device="cpu", variant=variant)
    return {k: np.asarray(v) for k, v in want.items() if k != "tt"}, got


@pytest.fixture(scope="module")
def searches(nets, variant):
    fens = _variant_fens(variant, 8)
    return {net: _search_both(nets, net, variant, fens, 1) for net in ("int8", "f32")}


def test_search_batch_int8_matches_reference(searches):
    want, got = searches["int8"]
    for k in FIELDS:
        assert np.array_equal(got[k], want[k]), k
    assert got["steps"] == int(want["steps"])


def test_search_batch_f32_agrees_with_reference(searches):
    want, got = searches["f32"]
    mate = np.abs(want["score"]) >= MATE - 1000
    assert np.array_equal(got["score"][mate], want["score"][mate])
    assert np.abs(got["score"] - want["score"]).max() <= F32_SCORE_TOL
    same = got["score"] == want["score"]
    assert np.array_equal(got["move"][same], want["move"][same])


def _spot_score(nets, fen, variant, depth=2, lanes=8):
    """tests/test_device_variants.py's spot search on the port: the root
    repeated over `lanes` lanes, max_ply 4, the f32 net."""
    root = tb.from_position(from_fen(fen, variant))
    roots = tb.stack_boards([root] * lanes)
    out = search_batch(nets["f32"][1], roots, depth, 100_000, max_ply=4, device="cpu",
                       variant=variant)
    return int(out["score"][0])


@pytest.mark.parametrize("case", [
    ("threeCheck", "4k3/8/8/8/8/8/3Q4/4K3 w - - +2+0 0 1", 2, "win"),  # the third check
    ("kingOfTheHill", "7k/8/8/8/8/3K4/8/8 w - - 0 1", 2, "win"),  # Kd4 reaches the hill
    ("racingKings", "8/6K1/8/8/8/8/8/k7 w - - 0 1", 2, "win"),  # goal, no rejoinder
    ("racingKings", "6K1/k7/8/8/8/8/8/8 b - - 0 1", 2, "draw"),  # Ka8 equalizes
    ("horde", "4k3/8/8/8/8/8/q6P/8 b - - 0 1", 2, "win"),  # the horde's last pawn
    ("antichess", "8/8/8/8/2q5/3q4/2P5/8 w - - 0 1", 3, "win"),  # forced out of pieces
])
def test_variant_rule_cases(nets, case):
    variant, fen, depth, result = case
    score = _spot_score(nets, fen, variant, depth)
    if result == "win":
        assert score >= MATE - 10, score
    else:
        assert score == 0, score


def test_antichess_capture_compulsion():
    pos = from_fen("rnbqkbnr/ppp1pppp/8/3p4/4P3/8/PPPP1PPP/RNBQKBNR w - - 0 2", "antichess")
    moves, count, noisy = tm.generate_moves(tb.from_position(pos), variant="antichess")
    got = set(moves[0, :int(count[0])].tolist())
    assert got == {m.from_sq | (m.to_sq << 6) for m in pos.legal_moves()}
    assert len(got) == 1 and int(noisy[0]) == 1  # exd5 is the only legal move


def test_null_child_keeps_three_check_counters(shipped_int8):
    """The null child of a threeCheck node keeps its parent's variant words
    (the reference's null child keeps `extra`): its row equals the
    reference's, and a searched state with null moves equals the
    reference's step for step."""
    fen = "4k3/8/8/8/8/8/8/R2QK3 w - - +2+1 0 1"
    parent = tb.from_position(from_fen(fen, "threeCheck"))
    assert parent.extra[0, :2].tolist() == [2, 1]
    row = tb.rows_from_board(parent)
    null = tb.board_from_rows(row * torch.from_numpy(ts._NULL_MUL) + torch.from_numpy(
        ts._NULL_ADD))
    jparent = jb.from_position(jax_from_fen(fen, "threeCheck"))
    want = jb.Board(board=jparent.board, stm=1 - jparent.stm, ep=np.int32(-1),
                    castling=jparent.castling, halfmove=np.int32(0), extra=jparent.extra)
    for f in tb.Board._fields:
        assert np.array_equal(np.asarray(getattr(want, f)).reshape(-1),
                              getattr(null, f).numpy().reshape(-1)), f

    # a search that passes (the first null move at step 299 of lane 3),
    # threeCheck counters 1 and 1 inserted into tests/test_torch_search.py's
    # FENs: every field of the state equals the reference's, step for step
    jp, tp = shipped_int8
    fens = []
    for f in (QUEEN_UP, ITALIAN, START, QUEEN_UP):
        parts = f.split()
        fens.append(" ".join(parts[:4] + ["+1+1"] + parts[4:]))
    jroots = jb.stack_boards([jb.from_position(jax_from_fen(f, "threeCheck")) for f in fens])
    troots = tb.stack_boards([tb.from_position(from_fen(f, "threeCheck")) for f in fens])
    depth = np.asarray([4, 4, 4, 5], np.int32)
    budget = np.full(4, 100_000, np.int32)
    want = js._init_state_jit(jp, jroots, jax.numpy.asarray(depth), jax.numpy.asarray(budget),
                              6, variant="threeCheck")
    got = ts.init_state(tp, troots, torch.from_numpy(depth), torch.from_numpy(budget), 6,
                        variant="threeCheck")
    nulls = 0
    for step in range(NULL_STEPS):
        want, _, _, _ = js._run_segment_jit(jp, want, None, 1, "threeCheck", False, False, 0)
        ts._step(tp, got, True, variant="threeCheck")
        for field, w, g in zip(ts.SearchState._fields, want, got):
            w = np.asarray(w)
            if w.dtype == np.uint32:
                w = w.view(np.int32)
            assert np.array_equal(g.numpy(), w), (step, field)
        nulls += int((got.nt[:, :, ts.NT_NULL] == 2).sum())
    assert nulls > 0, "no null move was searched"


def _chunk(variant, plies, depth=2, seed=3):
    """A chunk of positions after `plies` plies of one seeded game of a
    variant (chip_smoke.variant_positions from the starting position,
    never into a game end)."""
    cls = position_class(variant)
    *_, (_, _, game) = variant_positions(variant, max(plies) + 1, seed, fens=(), ends=False,
                                         restart=0.0)
    work = AnalysisWork(id=f"var{variant[:5]}", nodes=NodeLimit(sf16=4_000_000,
                                                                classical=8_000_000),
                        timeout_s=30.0, depth=depth)
    positions = [
        WorkPosition(work=work, position_index=i, url=None, skip=False,
                     root_fen=cls.starting_fen(), moves=game[:k])
        for i, k in enumerate(plies)
    ]
    return Chunk(work=work, deadline=time.monotonic() + 600, variant=variant,
                 flavor=EngineFlavor.TPU, positions=positions)


@pytest.fixture(scope="module")
def shipped_int8():
    from fishnet_tpu.assets import default_weights_path

    jp = jn.quantize_int8(jn.load_params(default_weights_path("board768")))
    tp = tn.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in jn.NnueParams._fields},
                              "cpu")
    return jp, tp


def _wire(responses, to_wire):
    out = []
    for r in responses:
        w = to_wire(r)
        w.pop("time_s")
        w.pop("nps")
        out.append(w)
    return out


def test_variant_chunk_matches_tpu_engine(shipped_int8, variant):
    """A variant chunk through GpuEngine(device="cpu") equals TpuEngine's
    responses on the int8-quantized shipped net (no table, no helpers,
    chunk-serial on both sides)."""
    from fishnet_tpu.engine.tpu import TpuEngine

    jp, tp = shipped_int8
    chunk = _chunk(variant, (2, 7))
    wire = chunk_to_wire(chunk)
    ref = TpuEngine(params=jp, max_depth=2, tt_size_log2=0, helper_lanes=1, refill=False)
    want = _wire(asyncio.run(ref.go_multiple(chunk)), jax_response_to_wire)
    port = GpuEngine(params=tp, max_depth=2, tt_size_log2=0, helper_lanes=1, device="cpu")
    got = _wire(asyncio.run(port.go_multiple(ipc.chunk_from_wire(wire))), ipc.response_to_wire)
    assert got == want
    assert all(g["depth"] == 2 and g["best_move"] is not None for g in got)


def test_mixed_variant_queue_runs_one_variant_per_session(shipped_int8, monkeypatch):
    """Two chunks of different variants queued at once: each drive
    session runs one device variant (its state's, every segment's and every
    splice's), the earlier deadline's first, and each chunk's responses
    equal those of the chunk run alone."""
    _, tp = shipped_int8
    chunks = [ipc.chunk_from_wire(chunk_to_wire(c)) for c in (
        _chunk("horde", (2, 5), seed=1), _chunk("3check", (3, 6), seed=2))]
    chunks[1].deadline = chunks[0].deadline + 60
    alone = []
    for c in chunks:
        eng = GpuEngine(params=tp, max_depth=2, tt_size_log2=0, helper_lanes=1, refill=True,
                        device="cpu")
        alone.append(_wire(asyncio.run(eng.go_multiple(c)), ipc.response_to_wire))

    sessions = []  # per drive session: the variants its calls used
    init_state, run_segment, refill_lanes = ts.init_state, ts.run_segment, ts.refill_lanes

    def traced_init(*a, variant="standard", **kw):
        sessions.append([variant])
        return init_state(*a, variant=variant, **kw)

    def traced_segment(*a):
        sessions[-1].append(a[-1])
        return run_segment(*a)

    def traced_refill(*a, variant="standard", **kw):
        sessions[-1].append(variant)
        return refill_lanes(*a, variant=variant, **kw)

    monkeypatch.setattr(ts, "init_state", traced_init)
    monkeypatch.setattr(ts, "run_segment", traced_segment)
    monkeypatch.setattr(ts, "refill_lanes", traced_refill)
    eng = GpuEngine(params=tp, max_depth=2, tt_size_log2=0, helper_lanes=1, refill=True,
                    device="cpu")
    entries = [eng._scheduler._submit(c) for c in chunks]
    eng._scheduler._drive(entries[1])
    assert all(e.event.is_set() for e in entries)
    assert [s[0] for s in sessions] == ["horde", "threeCheck"]
    assert all(len(set(s)) == 1 and len(s) > 2 for s in sessions), sessions
    for c, e, want in zip(chunks, entries, alone):
        got = _wire([e.responses[wp.position_index] for wp in c.positions],
                    ipc.response_to_wire)
        assert got == want


def test_unported_variants_stay_refused():
    """A variant name that no layer knows raises NotImplementedError at
    every layer, as the kernels' entry-point names do, and the host rules
    refuse it; the engine's map names exactly the variants the host rules
    run, crazyhouse and atomic among them, and equals the reference's key
    for key."""
    from fishnet_tpu.engine.tpu import DEVICE_VARIANTS as JAX_DEVICE_VARIANTS
    from fishnet_tpu_torch import kernels

    assert set(gpu.DEVICE_VARIANTS) == set(VARIANTS)
    assert gpu.DEVICE_VARIANTS == JAX_DEVICE_VARIANTS
    assert gpu.device_variant("crazyhouse") == "crazyhouse"
    assert gpu.device_variant("atomic") == "atomic"
    for refuse in (gpu.device_variant, tm.max_moves_for, tb.variant_id,
                   lambda v: kernels._variant_symbol("node_rules", v)):
        with pytest.raises(NotImplementedError):
            refuse("bughouse")
    with pytest.raises(ValueError):
        from_fen(position_class("standard").starting_fen(), "bughouse")
