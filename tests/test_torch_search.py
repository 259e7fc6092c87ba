"""fishnet_tpu_torch's lockstep search against the JAX package's, on the
CPU, on the fixtures of tests/test_search.py: mates, depth 1, LMR at
depth 3, null-move pruning at depth 4, node budgets, batch independence,
resumable equals one-shot, deadlines and lane narrowing.

On the int8-quantized net every field is bit-identical (score, move,
nodes, pv, pv_len, done and the step count). On the f32 net the leaf
evals differ in their last bits (see tests/test_torch_nnue.py), so mate
scores are held exactly and the rest is reported as agreement.

Positions with different depths and budgets share one 16-lane dispatch
(per-lane depth/budget arrays), so each comparison is one search."""
import time

import jax
import numpy as np
import pytest
import torch

from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops.search import search_batch as jax_search_batch
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.engine.gpu import _decode_uci
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops.search import MATE, search_batch, search_batch_resumable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


B = 16
FIELDS = ("score", "move", "nodes", "pv", "pv_len", "done")

MATE_IN_ONE = "6k1/5ppp/8/8/8/8/8/4R2K w - - 0 1"
MATED = "R5k1/5ppp/8/8/8/8/8/6K1 b - - 0 1"
STALEMATE = "7k/5Q2/6K1/8/8/8/8/8 b - - 0 1"
START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
ITALIAN = "r1bqkbnr/pppp1ppp/2n5/4p3/2B1P3/5N2/PPPP1PPP/RNBQK2R b KQkq - 3 3"
KIWIPETE = "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1"
EP_RICH = "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1"
QUEEN_UP = "6k1/5ppp/8/8/2Q5/8/5PPP/6K1 w - - 0 1"
PAWN_END = "4k3/8/8/8/8/8/4P3/4K3 w - - 0 1"
PROMO = "r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1"

# (fen, depth, node budget): mates and depth-1 roots, then depth-2
# searches (max_ply 4); budgets keep the CPU run to a few hundred steps
SHALLOW = [
    (MATE_IN_ONE, 2, 100_000), (MATED, 2, 100_000), (STALEMATE, 2, 100_000),
    (START, 1, 100_000), (ITALIAN, 1, 100_000), (EP_RICH, 2, 100_000),
    (PAWN_END, 2, 100_000), (QUEEN_UP, 2, 100_000), (START, 2, 100_000),
    (ITALIAN, 2, 300), (KIWIPETE, 2, 250),
]
# LMR (root moves from the 4th on) at depth 3 and null-move pruning at
# depth 4 (max_ply 5) under node budgets; the start position at depth 4
# with 300 nodes is the budget fixture
DEEP = [
    (ITALIAN, 3, 500), (KIWIPETE, 3, 400), (ITALIAN, 4, 500),
    (QUEEN_UP, 4, 500), (START, 4, 300), (EP_RICH, 4, 500),
]


def _roots(cases):
    cases = cases + [cases[0]] * (B - len(cases))
    jroots = jb.stack_boards([jb.from_position(JaxPosition.from_fen(f)) for f, _, _ in cases])
    troots = tb.stack_boards([tb.from_position(Position.from_fen(f)) for f, _, _ in cases])
    depth = np.asarray([d for _, d, _ in cases], np.int32)
    budget = np.asarray([n for _, _, n in cases], np.int32)
    return jroots, troots, depth, budget


@pytest.fixture(scope="module")
def nets():
    jp = jn.init_params(jax.random.PRNGKey(0), l1=32, h1=8, h2=8, feature_set="board768")
    jq = jn.quantize_int8(jp)

    def port(p):
        return tn.params_from_numpy({f: np.asarray(getattr(p, f)) for f in jn.NnueParams._fields},
                                    "cpu")

    return {"f32": (jp, port(jp)), "int8": (jq, port(jq))}


def _both(nets, net, cases, max_ply):
    jp, tp = nets[net]
    jroots, troots, depth, budget = _roots(cases)
    want = jax_search_batch(jp, jroots, depth, budget, max_ply=max_ply)
    want = {k: np.asarray(v) for k, v in want.items() if k != "tt"}
    got = search_batch(tp, troots, depth, budget, max_ply=max_ply, device="cpu")
    return want, got


@pytest.fixture(scope="module")
def shallow(nets):
    return {net: _both(nets, net, SHALLOW, 4) for net in ("f32", "int8")}


@pytest.fixture(scope="module")
def deep(nets):
    return _both(nets, "int8", DEEP, 5)


@pytest.mark.parametrize("net", ["f32", "int8"])
def test_mates_exact(shallow, net):
    want, got = shallow[net]
    assert got["score"][0] == want["score"][0] == MATE - 1
    assert got["move"][0] == want["move"][0] == (4 | (60 << 6))  # e1e8
    assert got["score"][1] == want["score"][1] == -MATE and got["move"][1] == -1
    assert got["score"][2] == want["score"][2] == 0 and got["move"][2] == -1
    assert got["done"].all()


def test_shallow_int8_bit_identical(shallow):
    want, got = shallow["int8"]
    for k in FIELDS:
        assert np.array_equal(got[k], want[k]), k
    assert got["steps"] == int(want["steps"])


def test_shallow_f32_agreement(shallow):
    """f32: the same searches within eval rounding — report how many
    lanes agree on move and score; depth-1 roots must agree on the move
    (a last-bit eval difference cannot reorder them here)."""
    want, got = shallow["f32"]
    n = len(SHALLOW)
    same_move = int((got["move"][:n] == want["move"][:n]).sum())
    same_score = int((got["score"][:n] == want["score"][:n]).sum())
    print(f"f32 agreement: move {same_move}/{n}, score {same_score}/{n}, "
          f"max |score diff| {int(np.abs(got['score'][:n] - want['score'][:n]).max())}")
    assert np.array_equal(got["move"][3:5], want["move"][3:5])
    assert np.abs(got["score"][:n] - want["score"][:n]).max() <= 2
    assert same_move >= n - 2


def test_lmr_nmp_and_budget_int8_bit_identical(deep):
    want, got = deep
    for k in FIELDS:
        assert np.array_equal(got[k], want[k]), k
    assert got["steps"] == int(want["steps"])
    assert got["nodes"][4] <= 300 + 250  # the budget degrades deep nodes


def test_pv_is_a_legal_line(shallow):
    _, got = shallow["int8"]
    for lane, (fen, _, _) in enumerate(SHALLOW):
        pos = Position.from_fen(fen)
        for m in got["pv"][lane][: int(got["pv_len"][lane])]:
            pos = pos.push(pos.parse_uci(_decode_uci(int(m))))


def test_batch_independence_and_resumable(nets, shallow):
    """The same lanes alone, and in many short segments, search exactly
    as they did inside the full batch of one segment."""
    _, tp = nets["int8"]
    _, full = shallow["int8"]
    cases = [SHALLOW[0], SHALLOW[7]]
    _, troots, depth, budget = _roots(cases)
    alone = search_batch(tp, troots, depth, budget, max_ply=4, device="cpu")
    for k in FIELDS:
        assert np.array_equal(alone[k][0], full[k][0]), k
        assert np.array_equal(alone[k][1], full[k][7]), k
    seg = search_batch_resumable(tp, troots, depth, budget, max_ply=4, segment_steps=37,
                                 device="cpu")
    for k in FIELDS:
        assert np.array_equal(seg[k], alone[k]), k
    assert seg["steps"] == alone["steps"]


def test_deadline_stops_after_one_segment(nets):
    _, tp = nets["int8"]
    _, troots, depth, budget = _roots([(KIWIPETE, 4, 500_000)])
    out = search_batch_resumable(tp, troots, depth, budget, max_ply=5, segment_steps=50,
                                 deadline=time.monotonic() - 1.0, device="cpu")
    assert out["steps"] <= 50
    assert not out["done"][0]


def test_narrowing_matches_unnarrowed(nets, monkeypatch):
    """Retiring finished lanes into narrower batches relocates lanes and
    never changes a search (32 lanes, narrowing floor 8, tiny segments
    force repeated narrows)."""
    monkeypatch.setenv("FISHNET_TPU_NARROW_FLOOR", "8")
    _, tp = nets["int8"]
    fens = [PAWN_END, PAWN_END, PAWN_END, QUEEN_UP, EP_RICH]
    troots = tb.stack_boards([tb.from_position(Position.from_fen(fens[i % len(fens)]))
                              for i in range(32)])
    depth = np.asarray([1 if i % len(fens) < 3 else 2 for i in range(32)], np.int32)
    outs = {}
    for narrow in (False, True):
        outs[narrow] = search_batch_resumable(tp, troots, depth, 20_000, max_ply=4,
                                              segment_steps=24, narrow=narrow, device="cpu")
    for k in FIELDS:
        assert np.array_equal(outs[False][k], outs[True][k]), k
    assert outs[False]["steps"] == outs[True]["steps"]
    assert outs[True]["done"].all()
