"""Lazy-SMP helper lanes in fishnet_tpu_torch against the JAX package, on
the CPU: the helper planner and dispatch width, the jittered history
seeds, and GpuEngine with the shared table and K=4 helpers against
TpuEngine(refill=False) over two consecutive chunks, so the table and
its generation carry across chunks. The engines run the int8-quantized
shipped net, where the port's search is the reference's bit for bit;
every comparison is exact."""
import asyncio
import time
from types import SimpleNamespace

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
from fishnet_tpu.engine import tpu as ref
from fishnet_tpu.engine.tpu import TpuEngine
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import tt as jtt
from fishnet_tpu.ops.search import init_state as jax_init_state
from fishnet_tpu_torch import ipc
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.engine.gpu import GpuEngine, _pad_lanes
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops.search import init_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_plan_helpers_cases_of_the_reference():
    """tests/test_helper_lanes.py's planner cases, then random ones
    against TpuEngine._plan_helpers."""
    plan = GpuEngine._plan_helpers
    assert plan(3, 8, 4, [10, 100, 1]) == [(1, 1), (0, 1), (2, 1), (1, 2), (0, 2)]
    assert plan(3, 8, 4, [10, 0, 1]) == [(0, 1), (2, 1), (0, 2), (2, 2), (0, 3)]
    assert plan(1, 8, 3, [5]) == [(0, 1), (0, 2)]
    assert plan(8, 8, 4, [1] * 8) == []
    assert plan(3, 8, 1, [1, 1, 1]) == []
    rng = np.random.default_rng(2)
    for _ in range(200):
        n = int(rng.integers(0, 12))
        B = int(rng.integers(n, 40))
        k = int(rng.integers(1, 6))
        hardness = rng.integers(-2, 50, n).tolist()
        assert plan(n, B, k, hardness) == TpuEngine._plan_helpers(n, B, k, hardness)


@pytest.mark.parametrize("K", [1, 2, 4, 16])
@pytest.mark.parametrize("max_lanes", [16, 64, 1024])
def test_helper_width_matches_reference(K, max_lanes):
    """The dispatch width on one device and, rounded up to a multiple of
    the shards, on a mesh of 3 and of 8 (the reference's _pad)."""
    for n_dev in (1, 3, 8):
        port = GpuEngine.__new__(GpuEngine)
        port.helper_lanes, port.max_lanes, port.n_dev = K, max_lanes, n_dev
        mesh = SimpleNamespace(n_dev=n_dev)
        want = SimpleNamespace(helper_lanes=K, max_lanes=max_lanes,
                               _pad=lambda n, mesh=mesh: TpuEngine._pad(mesh, n))
        for n in (1, 3, 10, 16, 17, 64, 100, 300, 1000):
            assert port._pad(n) == TpuEngine._pad(mesh, n)
            assert port._helper_width(n) == TpuEngine._helper_width(want, n)
            assert _pad_lanes(n) <= port._helper_width(n)
            assert port._helper_width(n) % n_dev == 0


def test_jittered_history_matches_reference():
    """The history counters init_state seeds from order_jitter, including
    jitters whose products overflow 32 bits and negative ones (read as
    uint32, like the reference); jitter 0 seeds zeros; group is stored."""
    jp = jn.init_params(jax.random.PRNGKey(0), l1=32, h1=8, h2=8, feature_set="board768")
    tp = tn.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in jn.NnueParams._fields},
                              "cpu")
    fen = "r1bqkbnr/pppp1ppp/2n5/4p3/2B1P3/5N2/PPPP1PPP/RNBQK2R b KQkq - 3 3"
    jitter = np.asarray([0, 1, 2, 7, 4097, 65535, 2**31 - 1, -1, -12345, 0], np.int32)
    group = np.arange(len(jitter), dtype=np.int32) // 3
    B = len(jitter)
    jroots = jb.stack_boards([jb.from_position(JaxPosition.from_fen(fen))] * B)
    troots = tb.stack_boards([tb.from_position(Position.from_fen(fen))] * B)
    ones = np.ones(B, np.int32)
    want = jax_init_state(jp, jroots, jnp.asarray(ones), jnp.asarray(ones), 4,
                          order_jitter=jnp.asarray(jitter), group=jnp.asarray(group))
    got = init_state(tp, troots, torch.from_numpy(ones), torch.from_numpy(ones), 4,
                     order_jitter=torch.from_numpy(jitter), group=torch.from_numpy(group))
    assert np.array_equal(got.hist.numpy(), np.asarray(want.hist))
    assert np.array_equal(got.lane.numpy(), np.asarray(want.lane))
    assert not got.hist[0].any() and got.hist[1].any() and int(got.hist.max()) <= 255


def test_engine_defaults_and_refusals(monkeypatch):
    tp = tn.load_params(device="cpu")
    monkeypatch.delenv("FISHNET_TPU_HELPERS", raising=False)
    monkeypatch.delenv("FISHNET_TPU_REFILL", raising=False)
    engine = GpuEngine(params=tp, device="cpu")
    assert engine.tt.shape == (1 << 21, 4) and engine.tt.dtype == torch.int32
    assert engine.tt.device.type == "cpu" and engine.helper_lanes == 4
    assert engine.max_lanes == 1024
    assert engine.refill is True  # the reference's default: the LaneScheduler
    monkeypatch.setenv("FISHNET_TPU_HELPERS", "40")
    assert GpuEngine(params=tp, tt_size_log2=4, device="cpu").helper_lanes == 16
    # helpers talk only through the table: none without it
    no_tt = GpuEngine(params=tp, tt_size_log2=0, helper_lanes=4, device="cpu")
    assert no_tt.tt is None and no_tt.helper_lanes == 1
    # refill=True constructs; on the refill path a variant that no layer
    # knows is refused before anything is queued
    engine = GpuEngine(params=tp, tt_size_log2=4, device="cpu", refill=True)
    assert engine.refill is True
    with pytest.raises(NotImplementedError):
        asyncio.run(engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(
            _chunk((0,), 1, variant="bughouse")))))
    assert not engine._scheduler._pending


START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
GAME = ["e2e4", "c7c5", "g1f3", "d7d6", "d2d4", "c5d4", "f3d4", "g8f6", "b1c3",
        "a7a6", "c1e3", "e7e5", "d4b3"]


def _chunk(plies, depth, variant="standard"):
    work = AnalysisWork(id="torchhelp", nodes=NodeLimit(sf16=400_000, classical=400_000),
                        timeout_s=60.0, depth=depth, multipv=None)
    positions = [
        WorkPosition(work=work, position_index=i, url=None, skip=False, root_fen=START,
                     moves=GAME[:k])
        for i, k in enumerate(plies)
    ]
    return Chunk(work=work, deadline=time.monotonic() + 600, variant=variant,
                 flavor=EngineFlavor.TPU, positions=positions)


def test_engine_with_helpers_matches_tpu_engine_over_two_chunks():
    """Two chunks through one engine each: the second searches against
    the table the first left, under the next generation. Every response
    field but time and nps is identical, helper lanes ride along in the
    port's dispatches, and the tables are equal after each chunk. Depth 2
    keeps the file near a minute: the even helpers search one ply deeper
    than their primaries at depth 1."""
    jp = jn.quantize_int8(jn.load_params(default_weights_path("board768")))
    tp = tn.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in jn.NnueParams._fields},
                              "cpu")
    want_engine = TpuEngine(params=jp, max_depth=3, tt_size_log2=12, helper_lanes=4,
                            refill=False)
    # one device, one table: the port's configuration
    want_engine.mesh, want_engine.n_dev = None, 1
    want_engine.tt = jtt.make_table(12)
    got_engine = GpuEngine(params=tp, max_depth=3, tt_size_log2=12, helper_lanes=4,
                           device="cpu")
    helper_rows = []
    search = got_engine._search

    def counting_search(roots, depth_arr, *a, order_jitter=None, **kw):
        helper_rows.append(0 if order_jitter is None else int((order_jitter != 0).sum()))
        return search(roots, depth_arr, *a, order_jitter=order_jitter, **kw)

    got_engine._search = counting_search
    for plies, depth in (((4, 9, 13), 2), ((0, 6, 11, 12), 2)):
        chunk = _chunk(plies, depth)
        want = asyncio.run(want_engine.go_multiple(chunk))
        got = asyncio.run(got_engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(chunk))))
        assert len(got) == len(want) == len(plies)
        for w, g in zip(want, got):
            w, g = jax_response_to_wire(w), ipc.response_to_wire(g)
            for k in ("time_s", "nps"):
                w.pop(k)
                g.pop(k)
            assert g == w
            assert g["depth"] == depth and g["best_move"] is not None
        assert got_engine._tt_gen == want_engine._tt_gen
        assert np.array_equal(got_engine.tt.numpy(), np.asarray(want_engine.tt.data))
    assert max(helper_rows) > 0  # helpers rode along
    assert got_engine._tt_gen == 2
