"""GpuEngine on a lane mesh with helper lanes against TpuEngine on the
conftest's 8-device CPU mesh, on the CPU: with K > 1 the scheduler
admits helpers to the shards with the most free lanes, and a helper
feeds its primary only through its own shard's table, so where each
helper lands decides the results. 8 `cpu` shards, a 2^12-slot table a
shard, depth 2, the int8-quantized shipped net (where the port's search
is the reference's bit for bit); responses, each shard's table and every
occupancy row with its per-shard columns equal TpuEngine's, through the
scheduler (refill) and the chunk-serial sharded path."""
import asyncio

import numpy as np
import pytest
import torch

from fishnet_tpu.engine.tpu import TpuEngine
from fishnet_tpu_torch.engine.gpu import GpuEngine
from fishnet_tpu_torch.parallel.mesh import make_mesh

from test_torch_mesh_engine import OCC, _chunk, _run_both, nets  # noqa: F401 (fixture)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("refill,helpers", [(True, 4), (False, 2)], ids=["refill-K4",
                                                                        "serial-K2"])
def test_engine_mesh_with_helpers_matches_tpu_engine(nets, refill, helpers):
    """3 positions at depth 2 with K helper lanes a position: responses
    (every field but time and nps), each shard's table, the table
    generation, the aspiration counts and, through the scheduler, every
    occupancy row with its helper count and per-shard columns equal
    TpuEngine's on its 8-device mesh; the helpers spread over more
    shards than the primaries."""
    jp, tp = nets
    want_engine = TpuEngine(params=jp, max_depth=2, tt_size_log2=12, helper_lanes=helpers,
                            refill=refill)
    assert want_engine.mesh is not None and want_engine.n_dev == 8
    engine = GpuEngine(params=tp, max_depth=2, tt_size_log2=12, helper_lanes=helpers,
                       refill=refill, device="cpu", mesh=make_mesh(["cpu"] * 8))
    want, got = _run_both(want_engine, engine, _chunk(2, 3))
    assert got == want
    assert all(r["depth"] == 2 and r["best_move"] for r in got)
    tables = np.stack([t.numpy() for t in engine.tt])
    assert np.array_equal(tables, np.asarray(want_engine.tt.data))
    assert engine._tt_gen == want_engine._tt_gen
    assert engine.aspiration_stats == want_engine.aspiration_stats
    rows = [{k: r[k] for k in OCC} for r in engine.occupancy_log]
    assert rows == [{k: r[k] for k in OCC} for r in want_engine.occupancy_log]
    if refill:
        assert any(r["helpers"] > 0 for r in rows)
        assert max(sum(1 for x in r["shard_live"] if x) for r in rows) > 3
    else:
        assert rows == []
