"""The search segment of fishnet_tpu_torch on the CPU: `run_segment_plain`
(the plain version of the segment kernel K11) against the JAX package's
`_run_segment`, state for state, with and without the transposition
table, over segments of 1, 7 and 33 steps and one in which every lane
finishes; `run_segment` on a CPU state runs the plain version and never
K11's launcher; the launcher refuses CPU tensors and malformed lane
tables before it launches; and the constants header K11 is built with
holds the plain versions' constants.

Every comparison is exact (the int8-quantized shipped net, MAX_PLY 8,
16 lanes as the JAX tests use). K11 itself runs only on the card
(tests/test_torch_card.py)."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.assets import default_weights_path
from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.chess.position import Chess960Position as JaxChess960
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import search as js
from fishnet_tpu.ops import tt as jtt
from fishnet_tpu_torch import kernels
from fishnet_tpu_torch.chess import Chess960Position, Position
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import search as ts
from fishnet_tpu_torch.ops import tt
from test_torch_board import CHESS960, TACTICAL, _playout_fens

B, P = 16, 8
SEGMENTS = (1, 7, 33)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nets():
    jp = jn.quantize_int8(jn.load_params(default_weights_path("board768")))
    tp = tn.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in jn.NnueParams._fields},
                              "cpu")
    return jp, tp


@pytest.fixture(scope="module")
def roots():
    """16 lanes: tactical, promotion, en-passant and chess960 castling
    positions and playouts, in both packages."""
    fens = [(False, f) for f in TACTICAL] + [(True, f) for f in CHESS960]
    fens += [(False, f) for _, f in _playout_fens([JaxPosition.initial().to_fen()], 9, 7)]
    jbs, tbs = [], []
    for is960, fen in fens[:B]:
        jcls, tcls = (JaxChess960, Chess960Position) if is960 else (JaxPosition, Position)
        jbs.append(jb.from_position(jcls.from_fen(fen)))
        tbs.append(tb.from_position(tcls.from_fen(fen)))
    return jb.stack_boards(jbs), tb.stack_boards(tbs)


def _i32(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


# a setup per case: table size (None: no table), deep_tt, prefer_deep,
# per-lane generations, jittered helpers, node budgets
CASES = {
    "no table": (None, False, False, False, False, 100_000),
    "table": (12, False, False, False, False, 100_000),
    "helpers, colliding prefer_deep store": (6, True, True, True, True, 100_000),
    "helpers, the main path's rules into 2^6 slots": (6, False, True, True, True, 100_000),
    "every lane finishes": (10, False, True, False, False, 300),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_segment_plain_matches_reference(nets, roots, case):
    """run_segment_plain over segments of 1, 7 and 33 steps (and, where
    every lane finishes, a last one of 2,000) equals one reference
    segment of the same total: every state field, the table, the step
    count and the summary's lane rows."""
    jp, tp = nets
    jroots, troots = roots
    size, deep, prefer, gen_lanes, helpers, budget = CASES[case]
    depth = np.asarray([1 + i % 3 for i in range(B)], np.int32)
    budgets = np.asarray([budget + 37 * i for i in range(B)], np.int32)
    kw = {}
    if helpers:
        kw = dict(order_jitter=np.asarray([0 if i % 4 == 0 else 1000 + 77 * i for i in range(B)],
                                          np.int32),
                  group=np.asarray([i // 4 for i in range(B)], np.int32))
    gen = np.asarray([1 + i % 3 for i in range(B)], np.int32) if gen_lanes else 3
    segments = SEGMENTS + ((2000,) if case == "every lane finishes" else ())

    want = js._init_state_jit(jp, jroots, jnp.asarray(depth), jnp.asarray(budgets), P,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    jtable = None if size is None else jtt.make_table(size)
    want, jtable, n_want, summ_want = js._run_segment_jit(
        jp, want, jtable, sum(segments), "standard", deep, prefer, jnp.asarray(gen))

    got = ts.init_state(tp, troots, torch.from_numpy(depth), torch.from_numpy(budgets), P,
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    table = None if size is None else tt.make_table(size, device="cpu")
    tgen = torch.from_numpy(gen) if gen_lanes else int(gen)
    n_got = 0
    for steps in segments:
        n, summ = ts.run_segment_plain(tp, got, steps, True, table, deep, prefer, tgen)
        assert int(summ[B, ts.SUM_DONE]) == n <= steps
        n_got += n
    for field, w, g in zip(ts.SearchState._fields, want, got):
        assert np.array_equal(g.numpy(), _i32(w)), field
    if table is not None:
        assert np.array_equal(table.numpy(), _i32(jtable.data))
        assert (table[:, 1] != 0).any()
    assert n_got == int(n_want)
    assert np.array_equal(summ[:B].numpy(), np.asarray(summ_want)[:B])
    done = got.lane[:, ts.LN_MODE] == ts.MODE_DONE
    if case == "every lane finishes":
        assert done.all() and n_got < sum(segments)
    else:
        assert done.any() and not done.all()


@pytest.mark.parametrize("with_table", [False, True])
def test_run_segment_on_a_cpu_state_runs_the_plain_version(nets, roots, monkeypatch,
                                                            with_table):
    """On a CPU state run_segment is run_segment_plain (the same state,
    table, count and summary) and never reaches K11's launcher."""
    _, tp = nets
    _, troots = roots

    def refuse(*args, **kwargs):
        raise AssertionError("K11's launcher called for a CPU state")

    monkeypatch.setattr(kernels, "search_segment", refuse)
    depth = torch.full((B,), 2, dtype=torch.int32)
    budget = torch.full((B,), 100_000, dtype=torch.int32)
    a = ts.init_state(tp, troots, depth, budget, P)
    b = ts.SearchState(*[t.clone() for t in a])
    ta = tt.make_table(10, device="cpu") if with_table else None
    tb_ = None if ta is None else ta.clone()
    kernels.reset_launches()
    n_a, s_a = ts.run_segment(tp, a, 25, True, ta, False, True, 2)
    n_b, s_b = ts.run_segment_plain(tp, b, 25, True, tb_, False, True, 2)
    assert n_a == n_b == 25 and torch.equal(s_a, s_b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    if with_table:
        assert torch.equal(ta, tb_)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


def _cpu_state(tp, roots, max_ply=P):
    depth = torch.full((B,), 2, dtype=torch.int32)
    return ts.init_state(tp, roots, depth, depth * 1000, max_ply)


REFUSALS = {
    # case: (how the state is broken, exception, message)
    "a CPU state": (lambda s: s, ValueError, "must be a CUDA tensor"),
    "a lane table of the wrong width": (
        lambda s: s._replace(lane=s.lane[:, :-1].contiguous()), ValueError, "lane must have shape"),
    "non-contiguous node rows": (
        lambda s: s._replace(nt=s.nt.transpose(0, 1).contiguous().transpose(0, 1)), ValueError,
        "nt must be contiguous"),
    "a move list of another width": (
        lambda s: s._replace(moves=s.moves[:, :, :100].contiguous()), ValueError,
        "224-move lists"),
    "accumulators of another type than the net's": (
        lambda s: s._replace(acc=s.acc.float()), TypeError, "acc must be torch.int32"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_segment_launcher_refuses_before_it_launches(nets, roots, case):
    """K11's launcher takes the nine lane tables on the card, contiguous,
    of one consistent layout, with the net's accumulator type; anything
    else raises before a launch (and a CPU state never reaches it from
    run_segment)."""
    _, tp = nets
    _, troots = roots
    broken, exc, message = REFUSALS[case]
    state = broken(_cpu_state(tp, troots))
    kernels.reset_launches()
    with pytest.raises(exc, match=message):
        kernels.search_segment(tp, state, 10, True)
    assert kernels.LAUNCHES["search_segment"] == 0


def test_segment_launcher_refuses_a_stack_deeper_than_it_stages(nets, roots):
    _, tp = nets
    _, troots = roots
    state = _cpu_state(tp, troots, max_ply=kernels.SEGMENT_MAX_PLY + 1)
    with pytest.raises(ValueError, match="MAX_PLY"):
        kernels.search_segment(tp, state, 10, True)
    assert kernels.LAUNCHES["search_segment"] == 0


def _header_consts(text: str) -> dict:
    out = {name: int(value) for name, value in
           re.findall(r"constexpr int (\w+) = (-?\d+);", text)}
    for name, body in re.findall(r"const \w+ (\w+)\[\d+\] = \{([^}]*)\};", text):
        out[name] = np.array([int(v) for v in body.split(",")])
    return out


# the constants K11 and K4-K6 are built with, by group, against the
# modules the plain versions read
CONST_GROUPS = {
    "node fields": lambda: {k: getattr(ts, k) for k in dir(ts) if k.startswith("NT_")},
    "lane fields": lambda: {k: getattr(ts, k) for k in dir(ts) if k.startswith("LN_")},
    "modes": lambda: {k: getattr(ts, k) for k in dir(ts) if k.startswith("MODE_")},
    "summary": lambda: {k: getattr(ts, k) for k in dir(ts) if k.startswith("SUM_")},
    "scores": lambda: {k: getattr(ts, k) for k in ("MATE", "INF", "ILLEGAL", "DRAW",
                                                   "MATE_BOUND", "FIFTY_PLIES")},
    "pruning": lambda: {k: getattr(ts, k) for k in (
        "NULL_R", "NULL_MIN_DEPTH", "NULL_DEEP_DEPTH", "FUTILITY_DEPTH", "FUTILITY_MARGIN_1",
        "FUTILITY_MARGIN_2", "LMR_MIN_DEPTH", "LMR_MIN_MOVE", "LMR_DEEP_MOVE", "MAX_HIST",
        "HIST_SIZE", "HIST_BONUS_MAX", "HIST_MAX")},
    "table": lambda: {"FLAG_EXACT": tt.FLAG_EXACT, "FLAG_LOWER": tt.FLAG_LOWER,
                      "FLAG_UPPER": tt.FLAG_UPPER, "SCORE_BIAS": tt._SCORE_BIAS,
                      "DEPTH_MASK": tt._DEPTH_MASK, "MAX_STORE": tt._MAX_STORE,
                      "EP_OFF": tt._EP_OFF, "CASTLE_OFF": tt._CASTLE_OFF, "STM_OFF": tt._STM_OFF},
    "variant keys": lambda: {"CHECKS_OFF": tt._CHECKS_OFF, "POCKET_OFF": tt._POCKET_OFF,
                             "PROMOTED_OFF": tt._PROMOTED_OFF, "VARIANT_OFF": tt._VARIANT_OFF,
                             "POCKET_MAX": tt.POCKET_MAX},
    "null child row": lambda: {"NULL_MUL": ts._NULL_MUL, "NULL_ADD": ts._NULL_ADD},
    "K11 layout": lambda: {"SEGMENT_MAX_PLY": kernels.SEGMENT_MAX_PLY,
                           "SEGMENT_SCRATCH": kernels.SEGMENT_SCRATCH,
                           "SEGMENT_L1": kernels.SEGMENT_L1, "SEGMENT_H1": kernels.SEGMENT_H1,
                           "SEGMENT_H2": kernels.SEGMENT_H2, "MAX_L1": kernels.MAX_L1},
}


@pytest.mark.parametrize("group", list(CONST_GROUPS))
def test_segment_header_holds_the_plain_versions_constants(group):
    """search_consts.cuh, written by kernels.search_header() from
    ops/search.py and ops/tt.py, parses back to the plain versions'
    values, group by group; the reference agrees on the shared ones."""
    h = _header_consts(kernels.search_header())
    want = CONST_GROUPS[group]()
    assert want
    for name, value in want.items():
        assert np.array_equal(h[name], np.asarray(value).astype(np.int64)), name
        ref = getattr(js, name, getattr(jtt, name, getattr(jtt, "_" + name, None)))
        if ref is not None and np.ndim(ref) == 0:
            assert int(ref) == int(np.asarray(value)), name


def test_segment_sources_take_every_constant_from_the_headers():
    """Every upper-case name the segment kernel's and the table bodies'
    sources use is defined in a generated header or in the sources
    themselves (no constant of the plain versions is typed in C++), and
    the board row's path-hash words come from rules_tables.cuh."""
    headers = _header_consts(kernels.search_header())
    headers.update(_header_consts(kernels.rules_header()))
    assert headers["BT_PH1"] == tb.BT_PH1 and headers["BT_PH2"] == tb.BT_PH2
    defined, used = set(), set()
    for src in ("search.cuh", "search_segment.cu", "tt.cuh", "nnue.cuh"):
        code = re.sub(r'//[^\n]*|"[^"\n]*"', "", (kernels.CSRC / src).read_text())
        defined |= set(re.findall(r"constexpr \w+ ([A-Z][A-Z0-9_]+)", code))
        defined |= set(re.findall(r"\b(B_[A-Z0-9_]+|N_BODY)\b", code))
        used |= set(re.findall(r"\b[A-Z][A-Z0-9_]{2,}\b", code))
    local = {"FISHNET_EXPORT", "SEGMENT_ENTRY", "NAME", "NET", "FULL_MASK", "WARP", "MAX_MOVES"}
    missing = used - local - defined - set(headers)
    assert not missing, sorted(missing)
    assert kernels.K11_BODIES == tuple(k for k in kernels.K11_COUNTERS if k in kernels.KERNELS)
    assert "search_segment" in kernels.KERNELS and (kernels.CSRC / "search_segment.cu").exists()
