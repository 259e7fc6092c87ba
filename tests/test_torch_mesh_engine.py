"""GpuEngine on a lane mesh against TpuEngine on the conftest's 8-device
CPU mesh, on the CPU: GpuEngine(mesh=make_mesh(["cpu"] * 8), device="cpu")
runs 8 shards, each with its own table, through the LaneScheduler
(refill) and the chunk-serial sharded path (FISHNET_TPU_MESH_REFILL=0
and refill off), and gives TpuEngine's responses, tables and occupancy
rows. Also the contracts of tests/test_mesh_engine.py and
tests/test_mesh_refill.py's engine half: 8 shards, a table a shard,
widths that divide over them, exactly-once delivery and the per-shard
occupancy columns (the first 4 primaries on 4 different shards).
tests/test_torch_mesh_scheduler.py has the pad edge cases and two
chunks at once.

The engines run the int8-quantized shipped net, where the port's search
is the reference's bit for bit, without helpers (K = 1) and with a
2^12-slot table a shard at depth 3."""
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
from fishnet_tpu_torch import ipc
from fishnet_tpu_torch.engine.gpu import GpuEngine
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.parallel.mesh import make_mesh


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
        "f1e2"]
OCC = ("width", "steps", "live", "helpers", "refilled", "shard_live", "shard_refilled",
       "shard_steps")


@pytest.fixture(scope="module")
def nets():
    jp = jn.quantize_int8(jn.load_params(default_weights_path("board768")))
    tp = tn.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in jn.NnueParams._fields},
                              "cpu")
    return jp, tp


def _chunk(depth, n_positions, moves=GAME, work_id="torchmesh"):
    work = AnalysisWork(id=work_id, nodes=NodeLimit(sf16=4_000_000, classical=8_000_000),
                        timeout_s=60.0, depth=depth, multipv=None)
    positions = [
        WorkPosition(work=work, position_index=i, url=None, skip=False, root_fen=START,
                     moves=moves[:i])
        for i in range(n_positions)
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


def _engines(nets, refill, depth, tt_size_log2):
    jp, tp = nets
    want = TpuEngine(params=jp, max_depth=depth, tt_size_log2=tt_size_log2, helper_lanes=1,
                     refill=refill)
    assert want.mesh is not None and want.n_dev == 8, "conftest should provide 8 devices"
    got = GpuEngine(params=tp, max_depth=depth, tt_size_log2=tt_size_log2, helper_lanes=1,
                    refill=refill, device="cpu", mesh=make_mesh(["cpu"] * 8))
    return want, got


def _run_both(want_engine, engine, chunk):
    want = asyncio.run(want_engine.go_multiple(chunk))
    got = asyncio.run(engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(chunk))))
    return _wire(want, jax_response_to_wire), _wire(got, ipc.response_to_wire)


@pytest.fixture(scope="module")
def table_pair(nets):
    """One 4-position depth-3 chunk through each path on both sides, a
    2^12-slot table a shard: the scheduler (refill) and the chunk-serial
    sharded path."""
    out = {}
    for mode, refill in (("refill", True), ("serial", False)):
        want_engine, engine = _engines(nets, refill, 3, 12)
        want, got = _run_both(want_engine, engine, _chunk(3, 4))
        out[mode] = (want, got, want_engine, engine)
    return out


@pytest.mark.parametrize("mode", ["refill", "serial"])
def test_engine_mesh_with_tables_matches_tpu_engine(table_pair, mode):
    """Responses (every field but time and nps), each shard's table, the
    table generation and, through the scheduler, every occupancy row with
    its per-shard columns equal TpuEngine's on its 8-device mesh."""
    want, got, want_engine, engine = table_pair[mode]
    assert got == want
    assert all(r["depth"] == 3 and r["best_move"] for r in got)
    tables = np.stack([t.numpy() for t in engine.tt])
    assert np.array_equal(tables, np.asarray(want_engine.tt.data))
    assert (tables[:, :, 1] != 0).sum(1).min() > 0  # every shard's table took stores
    assert engine._tt_gen == want_engine._tt_gen
    assert [{k: r[k] for k in OCC} for r in engine.occupancy_log] == [
        {k: r[k] for k in OCC} for r in want_engine.occupancy_log]
    assert engine.aspiration_stats == want_engine.aspiration_stats


def test_engine_uses_the_full_mesh(nets):
    """The mesh engine has 8 shards, a table a shard, and pads every
    width to a multiple of 8; GpuEngine(device=...) without a mesh keeps
    one device, and FISHNET_TPU_MESH_REFILL=0 (or mesh_refill=False)
    sends a meshed engine's chunks down the chunk-serial path."""
    _, tp = nets
    engine = GpuEngine(params=tp, max_depth=2, tt_size_log2=6, device="cpu",
                       mesh=make_mesh(["cpu"] * 8))
    assert engine.n_dev == 8 and len(engine.mesh) == 8
    assert len(engine.tt) == 8 and all(t.shape == (64, 4) for t in engine.tt)
    for n in (1, 3, 16, 65, 200):
        assert engine._pad(n) % 8 == 0 and engine._pad(n) >= n
        assert engine._helper_width(n) % 8 == 0
    single = GpuEngine(params=tp, max_depth=2, tt_size_log2=6, device="cpu")
    assert single.mesh is None and single.n_dev == 1 and single.tt.shape == (64, 4)
    assert [single._pad(n) for n in (1, 17, 65, 300)] == [16, 64, 128, 512]
    assert engine.mesh_refill is True
    assert GpuEngine(params=tp, tt_size_log2=0, device="cpu", mesh=make_mesh(["cpu"] * 2),
                     mesh_refill=False).mesh_refill is False


def test_engine_mesh_refill_off_takes_the_serial_path(nets, monkeypatch):
    """With FISHNET_TPU_MESH_REFILL=0 a refill engine on a mesh answers
    chunk-serially: no scheduler rows, the chunk-serial responses."""
    monkeypatch.setenv("FISHNET_TPU_MESH_REFILL", "0")
    _, tp = nets
    mesh = make_mesh(["cpu"] * 8)
    engine = GpuEngine(params=tp, max_depth=1, tt_size_log2=0, helper_lanes=1, refill=True,
                       device="cpu", mesh=mesh)
    serial = GpuEngine(params=tp, max_depth=1, tt_size_log2=0, helper_lanes=1, refill=False,
                       device="cpu", mesh=mesh)
    chunk = ipc.chunk_from_wire(chunk_to_wire(_chunk(1, 3)))
    got = asyncio.run(engine.go_multiple(chunk))
    assert engine.occupancy_log == [] and engine.occupancy_totals["positions_done"] == 0
    assert _wire(got, ipc.response_to_wire) == _wire(asyncio.run(serial.go_multiple(chunk)),
                                                     ipc.response_to_wire)


def test_engine_mesh_exactly_once_and_shard_columns(table_pair):
    """Every position answers exactly once through the sharded scheduler;
    each row carries one entry a shard in its per-shard columns, and the
    first 4 primaries land on 4 different shards (most free lanes
    first); the chunk-serial path logs no scheduler rows."""
    _, got, _, engine = table_pair["refill"]
    assert [r["position_index"] for r in got] == [0, 1, 2, 3]
    assert engine.occupancy_totals["positions_done"] == 4
    log = engine.occupancy_log
    assert log
    for row in log:
        for key in ("shard_live", "shard_refilled", "shard_steps"):
            assert len(row[key]) == 8, key
        assert sum(row["shard_refilled"]) == row["refilled"]
        assert max(row["shard_steps"]) == row["steps"]
    assert sum(1 for x in log[0]["shard_refilled"] if x > 0) == 4
    assert table_pair["serial"][3].occupancy_log == []
