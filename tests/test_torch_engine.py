"""GpuEngine against the JAX package's TpuEngine on the CPU: one analysis
chunk, serialised by the JAX package's chunk_to_wire and loaded by the
port's chunk_from_wire, must give the same responses (response_to_wire
equal but for time and nps) on the int8-quantized shipped net, with the
table, helper lanes and refill off on both sides (tests/test_torch_helpers.py
compares them on, tests/test_torch_refill.py and
tests/test_torch_scheduler.py the refill path). Also: the
engine refuses what is not ported, raises without a card unless given a
device, and the port imports neither JAX nor the JAX package."""
import asyncio
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fishnet_tpu.assets import default_weights_path
from fishnet_tpu.client.ipc import Chunk, WorkPosition, chunk_to_wire
from fishnet_tpu.client.ipc import response_to_wire as jax_response_to_wire
from fishnet_tpu.client.wire import AnalysisWork, EngineFlavor, MoveWork, NodeLimit, SkillLevel
from fishnet_tpu.engine.tpu import TpuEngine
from fishnet_tpu.models import nnue as jn
from fishnet_tpu_torch import ipc
from fishnet_tpu_torch.engine.gpu import GpuEngine, _decode_uci, _pad_lanes, _score_from_int
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


REPO = Path(__file__).resolve().parents[1]
START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
# the last plies shuffle knights back and forth, so the game history
# holds repeated positions
GAME = ["e2e4", "c7c5", "g1f3", "b8c6", "f3g1", "c6b8", "g1f3", "b8c6", "f3g1"]


def _chunk(work, plies=(0, 4, 9), variant="standard", root_fen=START):
    positions = [
        WorkPosition(work=work, position_index=i, url=None, skip=False,
                     root_fen=root_fen, moves=GAME[:k])
        for i, k in enumerate(plies)
    ]
    return Chunk(work=work, deadline=time.monotonic() + 600, variant=variant,
                 flavor=EngineFlavor.TPU, positions=positions)


def _analysis(depth=3, multipv=None):
    return AnalysisWork(id="torchcmp", nodes=NodeLimit(sf16=4_000_000, classical=8_000_000),
                        timeout_s=30.0, depth=depth, multipv=multipv)


@pytest.fixture(scope="module")
def int8_params():
    jp = jn.quantize_int8(jn.load_params(default_weights_path("board768")))
    tp = tn.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in jn.NnueParams._fields},
                              "cpu")
    return jp, tp


def test_analysis_chunk_matches_tpu_engine(int8_params):
    jp, tp = int8_params
    chunk = _chunk(_analysis(depth=3))
    wire = chunk_to_wire(chunk)
    ref = TpuEngine(params=jp, max_depth=3, tt_size_log2=0, helper_lanes=1, refill=False)
    want = asyncio.run(ref.go_multiple(chunk))
    port = GpuEngine(params=tp, max_depth=3, tt_size_log2=0, helper_lanes=1, device="cpu")
    got = asyncio.run(port.go_multiple(ipc.chunk_from_wire(wire)))
    assert len(got) == len(want) == 3
    for w, g in zip(want, got):
        w, g = jax_response_to_wire(w), ipc.response_to_wire(g)
        for k in ("time_s", "nps"):
            w.pop(k)
            g.pop(k)
        assert g == w
        assert g["depth"] == 3 and g["best_move"] is not None


def test_terminal_position_response():
    tp = tn.load_params(device="cpu")
    mated = "R5k1/5ppp/8/8/8/8/8/6K1 b - - 0 1"
    work = _analysis(depth=2)
    chunk = Chunk(work=work, deadline=time.monotonic() + 60, variant="standard",
                  flavor=EngineFlavor.TPU, positions=[WorkPosition(
                      work=work, position_index=0, url=None, skip=False,
                      root_fen=mated, moves=[])])
    (res,) = asyncio.run(GpuEngine(params=tp, device="cpu").go_multiple(
        ipc.chunk_from_wire(chunk_to_wire(chunk))))
    assert res.best_move is None and res.depth == 0
    assert res.scores.best() == ipc.Score.mate(0)


def test_unported_paths_are_refused(monkeypatch):
    """refill=None follows FISHNET_TPU_REFILL (conftest pins 0) and an
    explicit argument wins; multipv (always the serial path) and a
    variant that no layer knows are refused with refill off and on, and
    the seven lichess variants are not: a depth-1 chunk of each runs."""
    from fishnet_tpu_torch.chess import position_class

    tp = tn.load_params(device="cpu")
    assert GpuEngine(params=tp, tt_size_log2=4, device="cpu").refill is False
    monkeypatch.setenv("FISHNET_TPU_REFILL", "1")
    assert GpuEngine(params=tp, tt_size_log2=4, device="cpu").refill is True
    assert GpuEngine(params=tp, tt_size_log2=4, device="cpu", refill=False).refill is False
    for refill in (False, True):
        engine = GpuEngine(params=tp, tt_size_log2=4, device="cpu", refill=refill)
        with pytest.raises(NotImplementedError):
            asyncio.run(engine.go_multiple(ipc.chunk_from_wire(
                chunk_to_wire(_chunk(_analysis(depth=1, multipv=3))))))
        with pytest.raises(NotImplementedError):
            asyncio.run(engine.go_multiple(ipc.chunk_from_wire(
                chunk_to_wire(_chunk(_analysis(depth=1), variant="bughouse")))))
        assert engine.occupancy_totals["positions_done"] == 0
        for variant in ("threeCheck", "kingOfTheHill", "racingKings", "horde", "antichess",
                        "crazyhouse", "atomic"):
            chunk = _chunk(_analysis(depth=1), plies=(0,), variant=variant,
                           root_fen=position_class(variant).starting_fen())
            (res,) = asyncio.run(engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(chunk))))
            assert res.depth == 1 and res.best_move is not None
    move_chunk = chunk_to_wire(_chunk(MoveWork(id="mv1", level=SkillLevel(3))))
    with pytest.raises(NotImplementedError):
        ipc.chunk_from_wire(move_chunk)


def test_no_card_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GpuEngine()


def test_host_helpers_match_reference():
    from fishnet_tpu.engine import tpu as ref

    for m in (0, 12 | (28 << 6), 52 | (60 << 6) | (4 << 12), 11 | (3 << 6) | (1 << 12)):
        assert _decode_uci(m) == ref._decode_uci(m)
    for v in (0, 37, -512, 31999, 31995, -31998, -31001, 31000):
        assert _score_from_int(v) == ipc.Score(**vars(ref._score_from_int(v)))
    for n in (1, 16, 17, 64, 200, 257, 1000):
        assert _pad_lanes(n) == ref._pad_lanes(n)
    nodes = [5, 0, 15]
    assert GpuEngine._apportion_time(2.0, nodes) == TpuEngine._apportion_time(2.0, nodes)


def test_port_imports_no_jax():
    prog = (
        "import importlib, pkgutil, sys\n"
        "import fishnet_tpu_torch\n"
        "for m in pkgutil.walk_packages(fishnet_tpu_torch.__path__, 'fishnet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'fishnet_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'fishnet_tpu_torch.syncstats' in sys.modules\n"
        "assert 'fishnet_tpu_torch.models.nnue_import' in sys.modules\n"
        "assert 'fishnet_tpu_torch.models.train' in sys.modules\n"
        "assert 'fishnet_tpu_torch.chess.variants' in sys.modules\n"
        "assert 'fishnet_tpu_torch.parallel.mesh' in sys.modules\n"
        "print(len([m for m in sys.modules if m.startswith('fishnet_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", prog], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 19
