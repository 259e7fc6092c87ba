"""The search step's board rules, move generator and make-move in
fishnet_tpu_torch (K8-K10 on the card) on the CPU: each wrapper runs its
plain version for CPU tensors and launches nothing; the packed-row forms
the step calls equal the Board-based functions and the JAX package's
node_rules, generate_moves, make_move and move_piece_changes; the header
the kernels are built with holds the plain versions' tables; and the
port's `_step` equals the JAX step, state for state.

Every comparison is exact (integers; the step on the int8-quantized
shipped net). The positions are tests/test_torch_board.py's: playouts
from the start, tactical and chess960 positions, with killers and history
seeded as that file seeds them."""
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.assets import default_weights_path
from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.chess.position import Chess960Position as JaxChess960
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import movegen as jm
from fishnet_tpu.ops import search as js
from fishnet_tpu_torch import kernels
from fishnet_tpu_torch.chess import Chess960Position, Position
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import movegen as tm
from fishnet_tpu_torch.ops import search as ts
from fishnet_tpu_torch.ops import tables as T
from test_torch_board import CHESS960, TACTICAL, _playout_fens


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 64  # lanes per batched call, as in tests/test_torch_board.py


@pytest.fixture(scope="module")
def boards():
    """(JAX Board, the port's Board, packed rows (N, BT_W) with seeded
    garbage in the words past the variant words, killers, history) on
    test_torch_board.py's positions."""
    std = [f for _, f in _playout_fens(
        [JaxPosition.initial().to_fen()] * 3 + TACTICAL, 24, seed=42)]
    c960 = [f for _, f in _playout_fens(CHESS960, 24, seed=3, cls=JaxChess960)]
    rng = random.Random(0)
    fens = [(False, f) for f in TACTICAL] + [(True, f) for f in CHESS960]
    fens += [(True, f) for f in rng.sample(c960, 16)]
    fens += [(False, f) for f in rng.sample(std, N - len(fens))]
    jbs, tbs = [], []
    for is960, fen in fens:
        jcls, tcls = (JaxChess960, Chess960Position) if is960 else (JaxPosition, Position)
        jbs.append(jb.from_position(jcls.from_fen(fen)))
        tbs.append(tb.from_position(tcls.from_fen(fen)))
    jboards, tboards = jb.stack_boards(jbs), tb.stack_boards(tbs)
    rows = tb.rows_from_board(tboards)
    nrng = np.random.default_rng(1)
    rows[:, tb.BT_HM + 1:] = torch.from_numpy(
        nrng.integers(-2**31, 2**31, (N, tb.BT_W - tb.BT_HM - 1)).astype(np.int32))
    rows[:, tb.BT_EXTRA:tb.BT_EXTRA + tb.EXTRA_W] = tboards.extra  # the boards' variant words
    # killers drawn from real move encodings so they hit quiet moves
    plain = tm.generate_moves(tboards)[0].numpy()
    killers = np.stack([plain[:, 5], plain[:, 9]], 1).astype(np.int32)
    killers[::4, 1] = -1
    hist = nrng.integers(0, 1 << 12, (N, 4096)).astype(np.int32)
    return jboards, tboards, rows, killers, hist


def _eq(a, b):
    return np.array_equal(np.asarray(a), b.numpy())


def _moves_of(tboards):
    """Every generated move of every lane → (lane index, moves)."""
    moves, count, _ = tm.generate_moves(tboards)
    lane = np.repeat(np.arange(N), count.numpy())
    live = np.arange(moves.shape[1])[None] < count.numpy()[:, None]
    return lane, moves.numpy()[live].astype(np.int32)


@pytest.mark.parametrize("kernel", ["node_rules", "generate_moves", "make_move"])
def test_wrappers_run_the_plain_versions_on_the_cpu(boards, kernel):
    _, tboards, rows, killers, hist = boards
    rb = tb.board_from_rows(rows)
    k, h = torch.from_numpy(killers), torch.from_numpy(hist)
    lane, mv = _moves_of(tboards)
    sel = tb.Board(*[t[torch.from_numpy(lane)] for t in tboards])
    mv = torch.from_numpy(mv)
    kernels.reset_launches()
    if kernel == "node_rules":
        pairs = [(tb.node_rules(rb), tb.node_rules_plain(tboards)),
                 ((tb.in_check(rb),), (tb.node_rules_plain(tboards)[1],))]
    elif kernel == "generate_moves":
        pairs = [(tm.generate_moves(rb, k, h), tm.generate_moves_plain(tboards, k, h)),
                 (tm.generate_moves(rb), tm.generate_moves_plain(tboards))]
    else:
        want = tb.make_move_with_changes_plain(sel, mv)
        pairs = [
            (tb.make_move_with_changes(sel, mv)[1:], want[1:]),
            (tb.make_move(sel, mv), want[0]),
            (tb.move_piece_changes(sel, mv), want[1:]),
            (tb.make_move_rows(tb.rows_from_board(sel), mv),
             (tb.rows_from_board(want[0]), *want[1:])),
        ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert all(n == 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES


def test_node_rules_on_rows_matches_reference(boards):
    jboards, tboards, rows, _, _ = boards
    illegal_j, checked_j, term_j = jax.jit(jax.vmap(jb.node_rules))(jboards)
    for b in (tb.board_from_rows(rows), tboards):
        illegal, checked, term = tb.node_rules(b)
        assert _eq(illegal_j, illegal)
        assert _eq(checked_j, checked)
        assert _eq(term_j, term)


@pytest.mark.parametrize("ordering", ["plain", "killers_history"])
def test_generate_moves_on_rows_matches_reference(boards, ordering):
    jboards, tboards, rows, killers, hist = boards
    rb = tb.board_from_rows(rows)
    kw = {} if ordering == "plain" else {"killers": torch.from_numpy(killers),
                                         "hist": torch.from_numpy(hist)}
    if ordering == "plain":
        jout = jax.jit(jax.vmap(jm.generate_moves))(jboards)
    else:
        jout = jax.jit(jax.vmap(
            lambda b, k, h: jm.generate_moves(b, killers=k, hist=h)
        ))(jboards, killers, hist)
    tout = tm.generate_moves(rb, **kw)
    for name, a, b, c in zip(("moves", "count", "noisy"), jout, tout,
                             tm.generate_moves(tboards, **kw)):
        assert _eq(a, b), name
        assert torch.equal(b, c), name


def test_make_move_rows_matches_reference(boards):
    """Every generated move of every lane, from packed rows: the child row
    packs the JAX child (its variant words and zero words past them), and
    the changes are JAX's move_piece_changes; the Board-based function
    agrees."""
    jboards, tboards, rows, _, _ = boards
    lane, mv = _moves_of(tboards)
    jsel = jb.Board(*[np.asarray(a)[lane] for a in jboards])
    tsel = tb.Board(*[t[torch.from_numpy(lane)] for t in tboards])
    child_rows, codes, sqs, signs = tb.make_move_rows(rows[torch.from_numpy(lane)],
                                                      torch.from_numpy(mv))
    jchild = jax.jit(jax.vmap(jb.make_move))(jsel, mv)
    got = tb.board_from_rows(child_rows)
    for f in tb.Board._fields:
        assert _eq(getattr(jchild, f), getattr(got, f)), f
    assert not child_rows[:, tb.BT_EXTRA + tb.EXTRA_W:].any()
    jchanges = jax.jit(jax.vmap(jb.move_piece_changes))(jsel, mv)
    for name, a, b in zip(("codes", "sqs", "signs"), jchanges, (codes, sqs, signs)):
        assert _eq(a, b), name
    child, *changes = tb.make_move_with_changes(tsel, torch.from_numpy(mv))
    assert torch.equal(tb.rows_from_board(child), child_rows)
    for a, b in zip(changes, (codes, sqs, signs)):
        assert torch.equal(a, b)


def _header_arrays(text: str) -> dict:
    out = {}
    for name, body in re.findall(r"const \w+ (\w+)\[\d+\] = \{([^}]*)\};", text):
        out[name] = np.array([int(v) for v in body.split(",")])
    for name, value in re.findall(r"constexpr int (\w+) = (-?\d+);", text):
        out[name] = int(value)
    return out


def test_kernel_header_holds_the_plain_versions_tables():
    """rules_tables.cuh, which K8-K10 are built with, is written from the
    tables the plain versions read: every array and constant equals its
    source, and every name the board kernels' sources use from it is in
    it."""
    h = _header_arrays(kernels.rules_header())
    sources = {
        "RAYS": T.RAYS, "KNIGHT_TARGETS": T.KNIGHT_TARGETS, "KING_TARGETS": T.KING_TARGETS,
        "PAWN_CAPTURES": T.PAWN_CAPTURES, "SLIDER_MASK": T.SLIDER_MASK,
        "PROMO_TO_PIECE": T.PROMO_TO_PIECE, "PIECE_TYPE": tb.PIECE_TYPE,
        "PIECE_COLOR": tb.PIECE_COLOR, "CASTLE_KING_TO": tb.CASTLE_KING_TO,
        "CASTLE_ROOK_TO": tb.CASTLE_ROOK_TO, "CASTLE_SLOT_COLOR": tb.CASTLE_SLOT_COLOR,
        "CHANGE_SIGNS": tb.CHANGE_SIGNS, "PAWN_START": tm._START_RANK,
        "PAWN_PRE_PROMO": tm._PRE_PROMO, "PROMOS": tm._PROMOS, "PAIR_KEY": tm._PAIR_KEY,
        "PAIR_TAKE": tm._PAIR_TAKE, "PAWN_CAP_KEY": tm._PAWN_CAP_KEY,
        "PAWN_PUSH": np.stack([np.stack([tm._TO1[c], tm._TO2[c]]) for c in (0, 1)]),
        "DROP_OK": tm._DROP_OK,
    }
    for name, want in sources.items():
        assert np.array_equal(h[name], np.asarray(want).astype(np.int64).reshape(-1)), name
    consts = {"MAX_MOVES": T.MAX_MOVES, "W_KING": T.W_KING, "B_KING": T.B_KING,
              "QUIET_KEY": tm.QUIET_KEY, "CASTLE_KEY": tm.CASTLE_KEY,
              "KILLER_KEY": tm.KILLER_KEY, "HIST_BASE": tm.HIST_BASE,
              "QUEEN_PROMO_BONUS": tm.QUEEN_PROMO_BONUS, "BT_W": tb.BT_W,
              "BT_STM": tb.BT_STM, "BT_HM": tb.BT_HM, "MAX_MOVES_ZH": tm.MAX_MOVES_ZH,
              "DROP_FLAG": tm.DROP_FLAG, "DROP_KEY": tm.DROP_KEY,
              "DROP_HIST_BASE": tm.DROP_HIST_BASE, "EXTRA_POCKET": tb.EXTRA_POCKET,
              "EXTRA_PROMOTED": tb.EXTRA_PROMOTED, "POCKET_TYPES": tb.POCKET_TYPES}
    for name, want in consts.items():
        assert h[name] == want, name
    assert kernels.BT_W == tb.BT_W
    used = set()
    for src in ("board.cuh", "movegen.cuh"):
        code = re.sub(r"//[^\n]*", "", (kernels.CSRC / src).read_text())
        used |= set(re.findall(r"\b[A-Z][A-Z0-9_]{2,}\b", code))
    local = {"FULL_MASK", "WARP", "MOVE_LIST_CAP", "MOVE_LIST_CAP_ZH", "FISHNET_EXPORT"}
    assert used - local <= set(h), sorted(used - local - set(h))
    for name in ("node_rules", "generate_moves", "make_move"):
        assert name in kernels.KERNELS and name in kernels._SIGNATURES
        assert (kernels.CSRC / f"{name}.cu").exists()


@pytest.fixture(scope="module")
def step_roots():
    """16 lanes: tactical, promotion, en passant and chess960 castling
    positions and playouts, in both packages."""
    fens = [(False, f) for f in TACTICAL] + [(True, f) for f in CHESS960]
    fens += [(False, f) for _, f in _playout_fens([JaxPosition.initial().to_fen()], 9, 7)]
    jbs, tbs = [], []
    for is960, fen in fens[:16]:
        jcls, tcls = (JaxChess960, Chess960Position) if is960 else (JaxPosition, Position)
        jbs.append(jb.from_position(jcls.from_fen(fen)))
        tbs.append(tb.from_position(tcls.from_fen(fen)))
    return jb.stack_boards(jbs), tb.stack_boards(tbs)


def test_step_matches_reference(step_roots):
    """The port's `_step` (pruning on, no table) against the JAX package's
    step inside its segment runner, one step at a time: every field of
    the state equal after each of 96 steps, on the int8 net."""
    jroots, troots = step_roots
    jp = jn.quantize_int8(jn.load_params(default_weights_path("board768")))
    tp = tn.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in jn.NnueParams._fields},
                              "cpu")
    depth = np.asarray([1 + i % 3 for i in range(16)], np.int32)
    budget = np.full(16, 100_000, np.int32)
    want = js._init_state_jit(jp, jroots, jnp.asarray(depth), jnp.asarray(budget), 8)
    got = ts.init_state(tp, troots, torch.from_numpy(depth), torch.from_numpy(budget), 8)
    for step in range(96):
        want, _, _, _ = js._run_segment_jit(jp, want, None, 1, "standard", False, False, 0)
        ts._step(tp, got, True)
        for field, w, g in zip(ts.SearchState._fields, want, got):
            w = np.asarray(w)
            if w.dtype == np.uint32:
                w = w.view(np.int32)
            assert np.array_equal(g.numpy(), w), (step, field)
    assert not (got.lane[:, ts.LN_MODE] == ts.MODE_DONE).all()
