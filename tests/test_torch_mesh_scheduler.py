"""GpuEngine's sharded scheduler on the CPU, 8 `cpu` shards against
TpuEngine on the conftest's 8-device mesh (tests/test_mesh_refill.py's
engine half): position counts that do not divide over the shards (3 and
10) ride through the engine's padding with exactly-once delivery and
TpuEngine's responses, and two chunks submitted at once answer exactly
once, in order. Without helpers, on the int8-quantized shipped net;
tests/test_torch_mesh_engine.py has the engines with tables."""
import asyncio
import threading

import pytest
import torch

from fishnet_tpu_torch import ipc
from fishnet_tpu_torch.engine.gpu import GpuEngine
from fishnet_tpu_torch.parallel.mesh import make_mesh

from test_torch_mesh_engine import (  # noqa: F401 (the module fixture nets)
    _chunk, _engines, _run_both, _wire, chunk_to_wire, nets,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n_positions", [3, 10])
def test_engine_mesh_pad_edge_cases(nets, n_positions):
    """Position counts that do not divide over 8 shards ride through _pad
    (3 -> 16 lanes, 10 -> 16): exactly-once delivery, TpuEngine's
    responses, and the chunk-serial sharded path's, without a table at
    depth 2."""
    chunk = _chunk(2, n_positions)
    want_engine, engine = _engines(nets, True, 2, 0)
    want, got = _run_both(want_engine, engine, chunk)
    assert [r["position_index"] for r in got] == list(range(n_positions))
    assert engine.occupancy_totals["positions_done"] == n_positions
    assert got == want
    assert {r["width"] for r in engine.occupancy_log} == {16}
    serial = GpuEngine(params=nets[1], max_depth=2, tt_size_log2=0, helper_lanes=1,
                       refill=False, device="cpu", mesh=make_mesh(["cpu"] * 8))
    assert _wire(asyncio.run(serial.go_multiple(ipc.chunk_from_wire(chunk_to_wire(chunk)))),
                 ipc.response_to_wire) == got


def test_engine_mesh_concurrent_chunks_exactly_once(nets):
    """Two chunks at different depths submitted from two threads share
    the drive sessions: lanes finish on different shards at different
    boundaries and both chunks answer exactly once, in order."""
    engine = GpuEngine(params=nets[1], max_depth=2, tt_size_log2=8, helper_lanes=1,
                       refill=True, device="cpu", mesh=make_mesh(["cpu"] * 8))
    chunks = [
        ipc.chunk_from_wire(chunk_to_wire(_chunk(1, 3, work_id="mesha"))),
        ipc.chunk_from_wire(chunk_to_wire(_chunk(2, 3, moves=["d2d4", "g8f6", "c2c4"],
                                                 work_id="meshb"))),
    ]
    results = [None, None]
    errors = []

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
    for depth, responses in zip((1, 2), results):
        assert responses is not None and len(responses) == 3
        assert [r.position_index for r in responses] == [0, 1, 2]
        assert all(r.best_move and r.depth == depth for r in responses)
    assert engine.occupancy_totals["positions_done"] == 6
