"""The engine on the nets without incremental accumulators, against the
JAX package on the CPU: a king-bucketed (HalfKAv2_hm) NnueParams net and
an imported Stockfish `.nnue` net.

At small widths (L1 32, H1 8, H2 8; a Stockfish net of L1 64), 16 lanes
and MAX_PLY 8: `feature_indices` and `accumulators` (K12's refresh) are
the reference's exactly, on the f32 net as well as the int8 one; the
full eval (`evaluate`, K12's plain version) agrees within F32_EVAL_TOL on
f32 and exactly on int8; `run_segment_plain` on the int8 king-bucketed
net equals the JAX `_run_segment` state for state (zero accumulators
included), with and without a table and with colliding prefer-deep
helpers; GpuEngine(device="cpu") answers a chunk as TpuEngine does,
bit for bit on the int8 king-bucketed net given by params=, and within
the f32 rule (tests/test_torch_search.py) on a `.nnue` file given by
weights_path=; and GpuEngine reads FISHNET_TPU_DTYPE and
FISHNET_TPU_EXPERIMENTAL_INT8 as TpuEngine does, bf16 included."""
import asyncio
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.assets import default_weights_path
from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.client.ipc import Chunk, WorkPosition, chunk_to_wire
from fishnet_tpu.client.ipc import response_to_wire as jax_response_to_wire
from fishnet_tpu.client.wire import AnalysisWork, EngineFlavor, NodeLimit
from fishnet_tpu.engine.tpu import TpuEngine
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.models import nnue_import as ji
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import search as js
from fishnet_tpu.ops import tt as jtt
from fishnet_tpu_torch import ipc
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.engine.gpu import GpuEngine
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.models import nnue_import as ti
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import search as ts
from fishnet_tpu_torch.ops import tt
from test_torch_board import _playout_fens
from test_torch_nnue_import import FENS

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


def _port(p):
    return tn.params_from_numpy({f: np.asarray(getattr(p, f)) for f in jn.NnueParams._fields},
                                "cpu")


@pytest.fixture(scope="module")
def nets():
    """The reference's init_params king-bucketed net at the JAX tests'
    widths (tests/test_search.py), f32 and int8, in both packages."""
    jp = jn.init_params(jax.random.PRNGKey(3), l1=32, h1=8, h2=8)
    jq = jn.quantize_int8(jp)
    return {"f32": (jp, _port(jp)), "int8": (jq, _port(jq))}


@pytest.fixture(scope="module")
def boards():
    fens = FENS + [f for _, f in _playout_fens(FENS[:2], 30, 5)]
    return (jb.stack_boards([jb.from_position(JaxPosition.from_fen(f)) for f in fens]),
            tb.stack_boards([tb.from_position(Position.from_fen(f)) for f in fens]))


def test_net_kinds_and_refusals(nets):
    _, tp = nets["f32"]
    assert not tn.is_board768(tp) and tn.acc_dtype(tp) == torch.float32
    assert tn.is_board768(tn.load_params(device="cpu"))
    assert tn.is_int8(nets["int8"][1]) and tn.acc_dtype(nets["int8"][1]) == torch.int32
    arrays = {f: np.asarray(getattr(nets["f32"][0], f)) for f in jn.NnueParams._fields}
    arrays["ft_w"] = arrays["ft_w"][:1000]
    with pytest.raises(ValueError, match="features"):
        tn.params_from_numpy(arrays, "cpu")
    np.testing.assert_array_equal(tn.KING_BUCKET, jn.KING_BUCKET)
    assert tn.NUM_FEATURES == jn.NUM_FEATURES == 22528


@pytest.mark.parametrize("net", ["f32", "int8"])
def test_features_and_accumulators_are_exact(nets, boards, net):
    """feature_indices of both perspectives and the refreshed (B, 2, L1)
    accumulators equal the reference's, floats bit for bit."""
    jp, tp = nets[net]
    jboards, tboards = boards
    for p in (0, 1):
        ksq = jax.vmap(lambda b: jb.king_square(b, jnp.int32(p)))(jboards.board)
        want = jax.vmap(lambda b, k: jn.feature_indices(b, jnp.int32(p), jnp.maximum(k, 0)))(
            jboards.board, ksq)
        got = tn.feature_indices(tboards.board, p, tn.king_square(tboards.board, p))
        assert np.array_equal(got.numpy(), np.asarray(want))
    want = np.asarray(jax.jit(jax.vmap(jn.accumulators, in_axes=(None, 0)))(jp, jboards.board))
    got = tn.accumulators(tp, tboards.board).numpy()
    assert got.dtype == want.dtype and np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("net", ["f32", "int8"])
def test_evaluate_matches_reference(nets, boards, net):
    jp, tp = nets[net]
    jboards, tboards = boards
    want = np.asarray(jax.jit(jn.v_evaluate)(jp, jboards.board, jboards.stm))
    got = tn.evaluate(tp, tboards.board, tboards.stm).numpy()
    assert np.array_equal(tn.evaluate_plain(tp, tboards.board, tboards.stm).numpy(), got)
    if net == "int8":
        assert np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= tn.F32_EVAL_TOL


def _i32(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


# per case: table size (None: no table), prefer_deep with per-lane
# generations and jittered helpers, node budget
CASES = {
    "no table": (None, False, 100_000),
    "table": (12, False, 100_000),
    "colliding prefer-deep helpers": (6, True, 100_000),
}


@pytest.mark.parametrize("case", list(CASES))
def test_run_segment_plain_matches_reference(nets, boards, case):
    """run_segment_plain on the int8 king-bucketed net over segments of 1,
    7 and 33 steps equals one reference segment of the same total: every
    state field (the accumulators stay zero in both), the table, the step
    count and the summary's lane rows."""
    jp, tp = nets["int8"]
    jboards, tboards = boards
    jroots = type(jboards)(*[t[:B] for t in jboards])
    troots = type(tboards)(*[t[:B] for t in tboards])
    size, helpers, budget = CASES[case]
    depth = np.asarray([1 + i % 3 for i in range(B)], np.int32)
    budgets = np.asarray([budget + 37 * i for i in range(B)], np.int32)
    kw = {}
    if helpers:
        kw = dict(order_jitter=np.asarray([0 if i % 4 == 0 else 1000 + 77 * i for i in range(B)],
                                          np.int32),
                  group=np.asarray([i // 4 for i in range(B)], np.int32))
    gen = np.asarray([1 + i % 3 for i in range(B)], np.int32) if helpers else 3
    segments = (1, 7, 33)
    want = js._init_state_jit(jp, jroots, jnp.asarray(depth), jnp.asarray(budgets), P,
                              **{k: jnp.asarray(v) for k, v in kw.items()})
    jtable = None if size is None else jtt.make_table(size)
    want, jtable, n_want, summ_want = js._run_segment_jit(
        jp, want, jtable, sum(segments), "standard", False, helpers, jnp.asarray(gen))
    got = ts.init_state(tp, troots, torch.from_numpy(depth), torch.from_numpy(budgets), P,
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    table = None if size is None else tt.make_table(size, device="cpu")
    tgen = torch.from_numpy(gen) if helpers else int(gen)
    n_got = 0
    for steps in segments:
        n, summ = ts.run_segment_plain(tp, got, steps, True, table, False, helpers, tgen)
        n_got += n
    for field, w, g in zip(ts.SearchState._fields, want, got):
        assert np.array_equal(g.numpy(), _i32(w)), field
    assert not got.acc.any()
    if table is not None:
        assert np.array_equal(table.numpy(), _i32(jtable.data))
        assert (table[:, 1] != 0).any()
    assert n_got == int(n_want)
    assert np.array_equal(summ[:B].numpy(), np.asarray(summ_want)[:B])


START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
GAME = ["e2e4", "c7c5", "g1f3", "d7d6", "d2d4", "c5d4", "f3d4", "g8f6", "b1c3",
        "a7a6", "c1e3", "e7e5", "d4b3"]


def _chunk(plies, depth):
    work = AnalysisWork(id="torchnets", nodes=NodeLimit(sf16=400_000, classical=400_000),
                        timeout_s=60.0, depth=depth, multipv=None)
    positions = [
        WorkPosition(work=work, position_index=i, url=None, skip=False, root_fen=START,
                     moves=GAME[:k])
        for i, k in enumerate(plies)
    ]
    return Chunk(work=work, deadline=time.monotonic() + 600, variant="standard",
                 flavor=EngineFlavor.TPU, positions=positions)


def _engines(jax_kw, port_kw):
    """TpuEngine (chunk-serial, one device and one 2^12 table: the port's
    layout) and GpuEngine on the CPU, K = 2 helpers."""
    want = TpuEngine(max_depth=3, tt_size_log2=12, helper_lanes=2, refill=False, **jax_kw)
    want.mesh, want.n_dev = None, 1
    want.tt = jtt.make_table(12)
    got = GpuEngine(max_depth=3, tt_size_log2=12, helper_lanes=2, refill=False, device="cpu",
                    **port_kw)
    return want, got


def _answers(want_engine, got_engine, chunk):
    want = asyncio.run(want_engine.go_multiple(chunk))
    got = asyncio.run(got_engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(chunk))))
    out = []
    for w, g in zip(want, got):
        w, g = jax_response_to_wire(w), ipc.response_to_wire(g)
        for k in ("time_s", "nps"):
            w.pop(k)
            g.pop(k)
        out.append((w, g))
    assert len(out) == len(chunk.positions)
    return out


def test_engine_on_the_int8_king_bucketed_net_matches_tpu_engine(nets):
    """params= an int8 king-bucketed net: every response field but time
    and nps identical, and the tables equal."""
    jp, tp = nets["int8"]
    want_engine, got_engine = _engines({"params": jp}, {"params": tp})
    for w, g in _answers(want_engine, got_engine, _chunk((4, 9, 13), 2)):
        assert g == w and g["depth"] == 2
    assert np.array_equal(got_engine.tt.numpy(), np.asarray(want_engine.tt.data))


def test_engine_on_a_nnue_file_matches_tpu_engine(tmp_path):
    """weights_path= a `.nnue` file (a seeded Stockfish net, L1 64) in both
    engines: the same depth and best move at every position and scores
    within 2 cp (the f32 rule: the evals differ in their last bits)."""
    from chip_smoke import sf_case

    path = tmp_path / "net.nnue"
    ji.write_nnue(path, sf_case(64, seed=11))
    want_engine, got_engine = _engines({"weights_path": str(path)},
                                       {"weights_path": str(path)})
    assert isinstance(got_engine.params, ti.StockfishNet) and got_engine.params.l1 == 64
    assert isinstance(want_engine.params, ji.StockfishNet)
    for w, g in _answers(want_engine, got_engine, _chunk((4, 9, 13), 2)):
        assert g["depth"] == w["depth"] == 2
        assert g["best_move"] == w["best_move"]
        assert abs(g["scores"][0][-1]["cp"] - w["scores"][0][-1]["cp"]) <= 2


# FISHNET_TPU_DTYPE, FISHNET_TPU_EXPERIMENTAL_INT8 → the weights' dtype
# each engine searches with, on a board768 and a king-bucketed net
DTYPES = {
    "unset": ({}, "float32", "float32"),
    "int8 without the flag": ({"FISHNET_TPU_DTYPE": "int8"}, "float32", "float32"),
    "int8 with the flag": ({"FISHNET_TPU_DTYPE": "int8", "FISHNET_TPU_EXPERIMENTAL_INT8": "1"},
                           "int16", "float32"),
    "bf16": ({"FISHNET_TPU_DTYPE": "bf16"}, "bfloat16", "bfloat16"),
}


@pytest.mark.parametrize("case", list(DTYPES))
def test_dtype_settings_as_tpu_engine(nets, monkeypatch, capsys, case):
    """Each setting gives the weights TpuEngine gives (int8 quantizes a
    board768 net only, with the flag; without it both warn and keep f32;
    bf16 casts both nets with cast_params, every field's bits equal)."""
    env, board768_dtype, kb_dtype = DTYPES[case]
    for name in ("FISHNET_TPU_DTYPE", "FISHNET_TPU_EXPERIMENTAL_INT8"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    b768 = jn.load_params(default_weights_path("board768"))
    for jp, want_dtype in ((b768, board768_dtype), (nets["f32"][0], kb_dtype)):
        want = TpuEngine(params=jp, tt_size_log2=0, refill=False)
        capsys.readouterr()
        got = GpuEngine(params=_port(jp), tt_size_log2=0, device="cpu")
        warned = "FISHNET_TPU_DTYPE=int8 ignored" in capsys.readouterr().err
        assert warned == (case == "int8 without the flag")
        assert str(got.params.ft_w.dtype) == f"torch.{want_dtype}"
        assert np.asarray(want.params.ft_w).dtype == np.dtype(want_dtype)
        for f in jn.NnueParams._fields:
            g, w = getattr(got.params, f), np.asarray(getattr(want.params, f))
            if g.dtype == torch.bfloat16:  # numpy has no bf16: compare the 16-bit patterns
                g, w = g.view(torch.int16), w.view(np.int16)
            assert np.array_equal(g.numpy(), w)
