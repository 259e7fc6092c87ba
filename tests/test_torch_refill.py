"""Continuous lane refill in fishnet_tpu_torch against the JAX package, on
the CPU: `refill_lanes` on a state stepped mid-search, `search_stream`
with more positions than lanes (without and with the table, under both
FISHNET_TPU_PIPELINE values), the segment controller, and GpuEngine's
LaneScheduler without the table (against TpuEngine(refill=True) and
against the port's own chunk-serial path), from two threads at once,
and when a chunk's deadline passes or a segment fails.
tests/test_torch_scheduler.py compares the scheduler with the table and
K=4 helpers.

Every comparison is exact: the searches run the int8-quantized shipped
net, where the port's search is the reference's bit for bit. The inputs
are game positions and seeded numpy draws."""
import asyncio
import threading
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
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import search as js
from fishnet_tpu.ops import tt as jtt
from fishnet_tpu.utils import syncstats as jsync
from fishnet_tpu_torch import ipc, kernels, syncstats
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.engine.base import EngineError
from fishnet_tpu_torch.engine.gpu import GpuEngine
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import search as ts
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


START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
GAME = ["e2e4", "c7c5", "g1f3", "d7d6", "d2d4", "c5d4", "f3d4", "g8f6", "b1c3", "a7a6",
        "c1e3", "e7e5", "d4b3", "c8e6", "f2f3", "f8e7", "d1d2", "e8g8"]


@pytest.fixture(scope="module")
def nets():
    jp = jn.quantize_int8(jn.load_params(default_weights_path("board768")))
    tp = tn.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in jn.NnueParams._fields},
                              "cpu")
    return jp, tp


def _game_boards(n):
    """The positions after 0..n-1 plies of GAME, in both packages."""
    jpos, tpos = JaxPosition.from_fen(START), Position.from_fen(START)
    jbs, tbs = [], []
    for uci in GAME[:n]:
        jbs.append(jb.from_position(jpos))
        tbs.append(tb.from_position(tpos))
        jpos, tpos = jpos.push(jpos.parse_uci(uci)), tpos.push(tpos.parse_uci(uci))
    return jbs, tbs


def _assert_states_equal(want, got):
    for field, w, g in zip(ts.SearchState._fields, want, got):
        w = np.asarray(w)
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        assert np.array_equal(g.numpy(), w), field


# ------------------------------------------------------------ refill_lanes


def test_refill_lanes_matches_reference(nets):
    """A 16-lane state stepped 40 steps (live lanes mid-search, some
    parked), then five lanes spliced with depths, budgets, windows,
    jitters (zero, large and negative), groups and history seeds: every
    field equals the reference's refill_lanes, the lanes not listed are
    unchanged byte for byte, and the plain merge gives the same state."""
    jp, tp = nets
    jbs, tbs = _game_boards(18)
    B, P = 16, 8
    depth = np.asarray([1 + i % 3 for i in range(B)], np.int32)
    budget = np.full(B, 100_000, np.int32)
    want = js._init_state_jit(jp, jb.stack_boards(jbs[:B]), jnp.asarray(depth),
                              jnp.asarray(budget), P)
    want, _, _, _ = js._run_segment_jit(jp, want, None, 40, "standard", False, False, 0)
    got = ts.init_state(tp, tb.stack_boards(tbs[:B]), torch.from_numpy(depth),
                        torch.from_numpy(budget), P)
    ts.run_segment(tp, got, 40)
    _assert_states_equal(want, got)
    done = got.lane[:, ts.LN_MODE] == ts.MODE_DONE
    assert done.any() and not done.all()

    lanes = [3, 0, 9, 15, 7]
    rng = np.random.default_rng(5)
    kw = dict(
        hist_hash=rng.integers(0, 2**32, (5, ts.MAX_HIST, 2), dtype=np.uint64).astype(np.uint32),
        hist_halfmove=rng.integers(-5, 30, (5, ts.MAX_HIST)).astype(np.int32),
        root_alpha=np.asarray([-50, -ts.INF, 10, -100, 0], np.int32),
        root_beta=np.asarray([50, ts.INF, 40, 100, 20], np.int32),
        order_jitter=np.asarray([0, 5, 70000, -3, 1], np.int32),
        group=np.asarray([1, 2, 3, 4, 5], np.int32),
    )
    new_depth = np.asarray([2, 3, 1, 2, 4], np.int32)
    new_budget = np.asarray([500, 1, 0, 99_999, 12], np.int32)
    want = js.refill_lanes(jp, want, jb.stack_boards(jbs[13:18]), lanes, new_depth,
                           new_budget, **kw)
    before = ts.SearchState(*[t.clone() for t in got])
    plain = ts.SearchState(*[t.clone() for t in got])
    assert ts.refill_lanes(tp, got, tb.stack_boards(tbs[13:18]), lanes, new_depth,
                           new_budget, **kw) is got
    _assert_states_equal(want, got)
    keep = np.ones(B, bool)
    keep[lanes] = False
    for b, g in zip(before, got):
        assert torch.equal(b[keep], g[keep])
    ts._merge_lanes_plain(tp, plain, tb.stack_boards(tbs[13:18]), lanes, new_depth, new_budget,
                          **kw)
    for p, g in zip(plain, got):
        assert torch.equal(p, g)


def test_refill_lanes_checks_lanes_and_k7_widths(nets):
    """An empty splice changes nothing; repeated or out-of-range lanes
    are refused; K7's fixed widths are the state's."""
    _, tp = nets
    _, tbs = _game_boards(4)
    roots = tb.stack_boards(tbs)
    ones = torch.ones(4, dtype=torch.int32)
    state = ts.init_state(tp, roots, ones, ones, 4)
    before = [t.clone() for t in state]
    empty = tb.Board(*[t[:0] for t in roots])
    assert ts.refill_lanes(tp, state, empty, [], [], []) is state
    assert all(torch.equal(b, t) for b, t in zip(before, state))
    for lanes in ([1, 1], [4], [-1]):
        with pytest.raises(ValueError):
            ts.refill_lanes(tp, state, tb.stack_boards(tbs[:len(lanes)]), lanes,
                            [1] * len(lanes), [1] * len(lanes))
    assert (kernels.BT_W, kernels.NT_W, kernels.LN_W, kernels.MAX_HIST) == (
        ts.BT_W, ts.NT_W, ts.LN_W, ts.MAX_HIST)
    assert kernels.HIST_SIZE == state.hist.shape[1]
    with pytest.raises(ValueError):  # a CPU state never reaches the kernel
        kernels.lane_init(state, torch.zeros(1, dtype=torch.int64),
                          *ts._lane_inputs(tp, tb.stack_boards(tbs[:1]), ones[:1], ones[:1]))


# ------------------------------------------------------------ search_stream

# seven positions through four lanes, depths staggered so lanes finish at
# different boundaries and refills land beside live lanes; two lanes run
# on small budgets
STREAM_DEPTH = np.asarray([1, 2, 1, 2, 2, 1, 2], np.int32)
STREAM_BUDGET = np.asarray([100_000, 300, 100_000, 100_000, 150, 100_000, 100_000], np.int32)
STREAM_FIELDS = ("score", "move", "nodes", "pv", "pv_len", "done")
OCCUPANCY_KEYS = ("segment", "steps", "live", "idle", "refilled", "queue")


@pytest.mark.parametrize("pipeline", ["1", "0"])
@pytest.mark.parametrize("table", [False, True])
def test_search_stream_matches_reference(nets, monkeypatch, table, pipeline):
    """Per-position fields, steps, refills, each occupancy row and the
    final table equal the reference's; with the table, the stream runs
    the helpers' depth-preferred store under per-admission generations
    and game-history seeds."""
    monkeypatch.setenv("FISHNET_TPU_PIPELINE", pipeline)
    jp, tp = nets
    jbs, tbs = _game_boards(len(STREAM_DEPTH) + 2)
    jbs, tbs = jbs[2:], tbs[2:]
    n = len(STREAM_DEPTH)
    kw = dict(max_ply=6, width=4, segment_steps=40, prefer_deep_store=table, tt_gen_start=7)
    hist = None
    if table:
        rng = np.random.default_rng(9)
        hh = rng.integers(0, 2**32, (n, ts.MAX_HIST, 2), dtype=np.uint64).astype(np.uint32)
        hm = np.full((n, ts.MAX_HIST), ts.HIST_HM_SENTINEL, np.int32)
        hm[:, -2:] = rng.integers(0, 6, (n, 2))
        hist = (hh, hm)
    want = js.search_stream(jp, jb.stack_boards(jbs), STREAM_DEPTH, STREAM_BUDGET,
                            tt=jtt.make_table(16) if table else None, hist=hist, **kw)
    got = ts.search_stream(tp, tb.stack_boards(tbs), STREAM_DEPTH, STREAM_BUDGET,
                           tt=tt.make_table(16, device="cpu") if table else None, hist=hist,
                           device="cpu", **kw)
    for k in STREAM_FIELDS:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    assert got["done"].all()
    assert got["steps"] == int(want["steps"])
    assert got["refills"] == want["refills"] == n - 4
    assert len(got["occupancy"]) == len(want["occupancy"])
    for w, g in zip(want["occupancy"], got["occupancy"]):
        assert {k: g[k] for k in OCCUPANCY_KEYS} == {k: w[k] for k in OCCUPANCY_KEYS}
    # refills landed while other lanes were still searching
    assert any(r["refilled"] and r["live"] for r in got["occupancy"])
    if table:
        assert np.array_equal(got["tt"].numpy(), np.asarray(want["tt"].data))
        assert (got["tt"][:, 1] != 0).sum() > 50
    else:
        assert got["tt"] is None


def test_search_stream_auto_segments_and_refusals(nets, monkeypatch):
    """FISHNET_TPU_SEGMENT=auto runs the controller from SEGMENT_MIN;
    without a table, per-position results do not depend on segment
    lengths, so they equal a fixed-length stream's. A mesh whose shards
    do not divide the width is refused (tests/test_torch_mesh.py runs
    the mesh)."""
    _, tp = nets
    _, tbs = _game_boards(5)
    roots = tb.stack_boards(tbs[1:])
    fixed = ts.search_stream(tp, roots, 1, 100_000, max_ply=4, width=2, segment_steps=7,
                             device="cpu")
    monkeypatch.setenv("FISHNET_TPU_SEGMENT", "auto")
    monkeypatch.setenv("FISHNET_TPU_SEGMENT_MIN", "16")
    auto = ts.search_stream(tp, roots, 1, 100_000, max_ply=4, width=2, device="cpu")
    for k in STREAM_FIELDS:
        assert np.array_equal(auto[k], fixed[k]), k
    assert auto["occupancy"][0]["steps"] <= 16 and len(fixed["occupancy"]) > len(
        auto["occupancy"])
    with pytest.raises(ValueError):
        ts.search_stream(tp, roots, 1, 1, max_ply=4, width=2, mesh=("cpu",) * 3, device="cpu")


def test_segment_controller_matches_reference():
    """Both controllers fed one seeded sequence of boundaries (full and
    early segments, host shares across the band) give the same lengths;
    the bounds are checked alike."""
    rng = np.random.default_rng(3)
    feed = [(bool(rng.random() < 0.8), float(rng.choice([0.0, 1.0, 5.0, 50.0]) * rng.random()),
             float(rng.choice([0.0, 10.0, 100.0]) * rng.random())) for _ in range(300)]
    for lo, hi, start in ((1, 64, None), (2048, 65536, None), (16, 4096, 100), (8, 8, 3)):
        want = jsync.SegmentController(lo, hi, start)
        got = syncstats.SegmentController(lo, hi, start)
        assert got.steps == want.steps
        assert [got.update(*f) for f in feed] == [want.update(*f) for f in feed]
    for lo, hi in ((0, 5), (9, 8)):
        with pytest.raises(ValueError):
            syncstats.SegmentController(lo, hi)


def test_sync_stats_counts_fetches():
    stats = syncstats.SyncStats()
    a = stats.fetch(torch.arange(6).view(2, 3), "a")
    assert isinstance(a, np.ndarray) and a.shape == (2, 3)
    stats.fetch(np.zeros(4), "b")
    snap = stats.boundary()
    assert snap["transfers"] == 2 and snap["elements"] == 10
    assert set(snap) == {"transfers", "elements", "device_ms", "host_ms"}
    assert stats.boundary()["transfers"] == 0 and stats.transfers_total == 2


def test_sync_stats_counts_segment_calls_as_device_time():
    """A segment call's wall-clock is device time, so the controller sees
    the boundary's own host work as the host share."""
    stats = syncstats.SyncStats()
    assert stats.device_call(lambda ms: time.sleep(ms / 1000.0) or ms, 30) == 30
    snap = stats.boundary()
    assert snap["device_ms"] >= 30.0 and snap["transfers"] == 0
    assert stats.boundary()["device_ms"] == 0.0


def test_run_segment_on_finished_lanes_runs_no_step(nets, monkeypatch):
    """A segment over lanes that are all DONE (the pipelined loops'
    speculative segment after the last park) runs no step at all, as the
    reference's loop does not, and leaves the state as it was."""
    _, tp = nets
    _, tbs = _game_boards(3)
    ones = torch.ones(3, dtype=torch.int32)
    state = ts.init_state(tp, tb.stack_boards(tbs), ones, ones * 100_000, 4)
    n, _ = ts.run_segment(tp, state, 256)
    assert 0 < n < 256
    before = [t.clone() for t in state]
    calls = []
    step = ts._step
    monkeypatch.setattr(ts, "_step", lambda *a: calls.append(1) or step(*a))
    n, summ = ts.run_segment(tp, state, 64)
    assert n == 0 and not calls and int(summ[3, ts.SUM_DONE]) == 0
    assert summ[:3, ts.SUM_DONE].tolist() == [1, 1, 1]
    assert all(torch.equal(b, t) for b, t in zip(before, state))


# ------------------------------------------------------------- the engine


def _chunk(plies, depth, moves=GAME, budget=4_000_000, work_id="torchrefill"):
    work = AnalysisWork(id=work_id, nodes=NodeLimit(sf16=budget, classical=budget),
                        timeout_s=60.0, depth=depth, multipv=None)
    positions = [
        WorkPosition(work=work, position_index=i, url=None, skip=False, root_fen=START,
                     moves=moves[:k])
        for i, k in enumerate(plies)
    ]
    return Chunk(work=work, deadline=time.monotonic() + 600, variant="standard",
                 flavor=EngineFlavor.TPU, positions=positions)


def _wire(responses, jax_side=False):
    out = []
    for r in responses:
        w = jax_response_to_wire(r) if jax_side else ipc.response_to_wire(r)
        w.pop("time_s")
        w.pop("nps")
        out.append(w)
    return out


OCC_ENGINE = ("width", "steps", "live", "helpers", "refilled")


def test_scheduler_without_table_matches_tpu_engine_and_serial_path(nets):
    """K=1, no table: GpuEngine(refill=True) gives TpuEngine(refill=True)'s
    responses, occupancy rows and aspiration counts on one device, and
    the port's chunk-serial path gives the same responses."""
    jp, tp = nets
    chunk = _chunk((0, 4, 9), 2)
    want_engine = TpuEngine(params=jp, max_depth=2, tt_size_log2=0, helper_lanes=1,
                            refill=True)
    want_engine.mesh, want_engine.n_dev = None, 1
    want = asyncio.run(want_engine.go_multiple(chunk))
    engine = GpuEngine(params=tp, max_depth=2, tt_size_log2=0, helper_lanes=1, refill=True,
                       device="cpu")
    got = asyncio.run(engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(chunk))))
    assert _wire(got) == _wire(want, jax_side=True)
    assert all(g.depth == 2 and g.best_move for g in got)
    assert [{k: r[k] for k in OCC_ENGINE} for r in engine.occupancy_log] == [
        {k: r[k] for k in OCC_ENGINE} for r in want_engine.occupancy_log]
    assert engine.aspiration_stats == want_engine.aspiration_stats
    assert engine.aspiration_stats  # the windows ran
    totals = engine.occupancy_totals
    assert totals["positions_done"] == 3 and totals["refills"] >= 3
    assert totals["segments"] == len(engine.occupancy_log)
    assert totals["lane_steps"] == (totals["live_lane_steps"] + totals["helper_lane_steps"]
                                    + totals["idle_lane_steps"])
    serial = GpuEngine(params=tp, max_depth=2, tt_size_log2=0, helper_lanes=1, refill=False,
                       device="cpu")
    assert _wire(asyncio.run(serial.go_multiple(ipc.chunk_from_wire(chunk_to_wire(chunk))))) \
        == _wire(got)


def test_scheduler_two_threads_deliver_exactly_once(nets):
    """Two chunks submitted from two threads share one drive loop:
    each gets exactly one response per position, in order, and the
    on_response / on_deliver hooks fire once per position."""
    _, tp = nets
    engine = GpuEngine(params=tp, max_depth=2, tt_size_log2=0, helper_lanes=1, refill=True,
                       device="cpu")
    seen, delivered = [], []
    engine.on_response = lambda wp, res: seen.append((wp.work.id, wp.position_index))
    engine.on_deliver = lambda chunk, wp, res: delivered.append(chunk.work.id)
    chunks = [ipc.chunk_from_wire(chunk_to_wire(c)) for c in (
        _chunk((0, 3), 2),
        _chunk((1, 4), 2, moves=["d2d4", "g8f6", "c2c4", "e7e6"], work_id="other"))]
    results, errors = [None, None], []

    def go(i):
        try:
            results[i] = asyncio.run(engine.go_multiple(chunks[i]))
        except Exception as e:  # pragma: no cover - failure detail
            errors.append(e)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors
    for responses in results:
        assert [r.position_index for r in responses] == [0, 1]
        assert all(r.best_move and r.depth == 2 for r in responses)
    assert sorted(seen) == sorted((c.work.id, i) for c in chunks for i in range(2))
    assert sorted(delivered) == sorted([c.work.id for c in chunks for _ in range(2)])
    assert engine.occupancy_totals["positions_done"] == 4


def test_scheduler_failures_fail_the_chunk(nets, monkeypatch):
    """A chunk whose deadline has passed before depth 1 fails with
    EngineError (the server reassigns it, as on the serial path); a
    segment that raises fails every admitted job and reaches the caller
    as EngineError, and the next chunk runs."""
    _, tp = nets
    engine = GpuEngine(params=tp, max_depth=1, tt_size_log2=0, helper_lanes=1, refill=True,
                       device="cpu")
    late = _chunk((0, 4), 1)
    late.deadline = time.monotonic() + 0.1  # the scheduler keeps 0.25 s of slack
    with pytest.raises(EngineError, match="deadline"):
        asyncio.run(engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(late))))
    run_segment = ts.run_segment

    def broken(*a, **kw):
        raise RuntimeError("segment failed")

    monkeypatch.setattr(ts, "run_segment", broken)
    with pytest.raises(EngineError, match="segment failed"):
        asyncio.run(engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(_chunk((0, 4), 1)))))
    monkeypatch.setattr(ts, "run_segment", run_segment)
    got = asyncio.run(engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(_chunk((0, 4), 1)))))
    assert [r.depth for r in got] == [1, 1]
    assert not engine._scheduler._pending and not engine._scheduler._driving
