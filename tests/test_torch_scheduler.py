"""GpuEngine's LaneScheduler with the shared table and K=4 Lazy-SMP
helpers against TpuEngine(refill=True) on one device (mesh None, one
table), on the CPU, over two consecutive chunks and under both
FISHNET_TPU_PIPELINE values: responses (every field but time and nps),
occupancy rows, the table after each chunk, the table generation and the
aspiration counts are identical. The engines run the int8-quantized
shipped net, where the port's search is the reference's bit for bit.

FISHNET_TPU_SEGMENT is set to 64 steps so that boundaries fall while
helpers are still searching: each primary's next depth and each freed
helper lane is spliced beside live lanes (with the default 20,000 steps
almost every boundary is an all-DONE one), and the chunks take a few
hundred steps each. tests/test_torch_refill.py covers the scheduler
without the table."""
import asyncio
import time

import numpy as np
import pytest
import torch

from fishnet_tpu.assets import default_weights_path
from fishnet_tpu.client.ipc import Chunk, WorkPosition, chunk_to_wire
from fishnet_tpu.client.ipc import response_to_wire as jax_response_to_wire
from fishnet_tpu.client.wire import AnalysisWork, EngineFlavor, NodeLimit
from fishnet_tpu.engine.tpu import TpuEngine
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.ops import tt as jtt
from fishnet_tpu_torch import ipc
from fishnet_tpu_torch.engine.gpu import GpuEngine
from fishnet_tpu_torch.models import nnue as tn


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
        "c1e3", "e7e5", "d4b3"]
OCC = ("width", "steps", "live", "helpers", "refilled")


def _chunk(plies, depth):
    # a node budget small enough that the helpers' deeper searches charge
    # it visibly
    work = AnalysisWork(id="torchsched", nodes=NodeLimit(sf16=2_500, classical=2_500),
                        timeout_s=60.0, depth=depth, multipv=None)
    positions = [
        WorkPosition(work=work, position_index=i, url=None, skip=False, root_fen=START,
                     moves=GAME[:k])
        for i, k in enumerate(plies)
    ]
    return Chunk(work=work, deadline=time.monotonic() + 600, variant="standard",
                 flavor=EngineFlavor.TPU, positions=positions)


def _wire(responses, to_wire):
    out = []
    for r in responses:
        w = to_wire(r)
        w.pop("time_s")
        w.pop("nps")
        out.append(w)
    return out


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_scheduler_with_table_and_helpers_matches_tpu_engine(monkeypatch, pipeline):
    monkeypatch.setenv("FISHNET_TPU_PIPELINE", pipeline)
    monkeypatch.setenv("FISHNET_TPU_SEGMENT", "64")
    jp = jn.quantize_int8(jn.load_params(default_weights_path("board768")))
    tp = tn.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in jn.NnueParams._fields},
                              "cpu")
    want_engine = TpuEngine(params=jp, max_depth=3, tt_size_log2=12, helper_lanes=4,
                            refill=True)
    # one device, one table: the port's configuration
    want_engine.mesh, want_engine.n_dev = None, 1
    want_engine.tt = jtt.make_table(12)
    engine = GpuEngine(params=tp, max_depth=3, tt_size_log2=12, helper_lanes=4, refill=True,
                       device="cpu")
    for plies in ((0, 4, 9), (2, 6, 11)):
        chunk = _chunk(plies, 2)
        want = asyncio.run(want_engine.go_multiple(chunk))
        got = asyncio.run(engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(chunk))))
        assert _wire(got, ipc.response_to_wire) == _wire(want, jax_response_to_wire)
        assert all(g.depth == 2 and g.best_move for g in got)
        assert np.array_equal(engine.tt.numpy(), np.asarray(want_engine.tt.data))
        assert engine._tt_gen == want_engine._tt_gen
        assert [{k: r[k] for k in OCC} for r in engine.occupancy_log] == [
            {k: r[k] for k in OCC} for r in want_engine.occupancy_log]
    assert engine.aspiration_stats == want_engine.aspiration_stats
    log = engine.occupancy_log
    # helpers rode along, and lanes were spliced beside live ones
    assert max(r["helpers"] for r in log) > 0
    assert any(r["refilled"] and r["steps"] == 64 for r in log)
    assert engine.occupancy_totals["positions_done"] == 6
