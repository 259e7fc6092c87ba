"""The lane mesh of fishnet_tpu_torch (parallel/mesh.py, the mesh branches
of ops/search.py) against the JAX package's 8-device CPU mesh, on the
CPU: the port runs 8 `cpu` shards of one lane each, the JAX side the
conftest's 8 virtual devices, driven as tests/test_mesh_refill.py drives
them.

- run_segment_sharded and refill_lanes_sharded, without and with
  per-shard tables: states, step counts, stacked summaries and tables
  equal the reference's segment for segment, the stacked summary equals
  the concatenation of run_segment_plain run on each shard alone, and
  the plain splice gives the same state;
- search_stream(mesh=...), synchronous (no table) and pipelined (a table
  a shard, the helpers' store): every field, the occupancy rows with
  their per-shard columns and the tables equal the reference's; the
  mesh run without a table equals the port's single-device run; a
  no-finish boundary of the pipelined loop is one transfer.

The searches run the int8-quantized shipped net, where the port's search
is the reference's bit for bit. The workload is tests/test_mesh_refill.py's:
the 12 positions of a Najdorf, 8 lanes, MAX_PLY 6, staggered depths and
150-step segments (depths up to 2 here: the port's plain path on the CPU
pays a step per shard). tests/test_torch_mesh_engine.py holds GpuEngine's
mesh against TpuEngine's."""
from collections import Counter, namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.assets import default_weights_path
from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import search as js
from fishnet_tpu.parallel import mesh as jm
from fishnet_tpu_torch import kernels
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import search as ts
from fishnet_tpu_torch.parallel import mesh as tm
from fishnet_tpu_torch.syncstats import SyncStats


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
N_POS = 12
WIDTH = 8
MAX_PLY = 6
SEGMENT = 150
DEPTHS = np.asarray([1, 2, 1, 2, 2, 1, 2, 1, 2, 1, 2, 1], np.int32)
BUDGET = np.full(N_POS, 200_000, np.int32)
STREAM_FIELDS = ("score", "move", "nodes", "pv", "pv_len", "done")
OCC_KEYS = ("segment", "steps", "live", "idle", "refilled", "queue", "transfers", "elements",
            "shard_live", "shard_refilled", "shard_steps")


@pytest.fixture(scope="module")
def nets():
    jp = jn.quantize_int8(jn.load_params(default_weights_path("board768")))
    tp = tn.params_from_numpy({f: np.asarray(getattr(jp, f)) for f in jn.NnueParams._fields},
                              "cpu")
    return jp, tp


@pytest.fixture(scope="module")
def meshes():
    assert len(jax.devices()) == 8, "conftest should provide 8 virtual devices"
    return jm.make_mesh(), tm.make_mesh(["cpu"] * 8)


def _roots():
    """The 12 positions of GAME, in both packages."""
    jpos, tpos = JaxPosition.from_fen(START), Position.from_fen(START)
    jbs, tbs = [jb.from_position(jpos)], [tb.from_position(tpos)]
    for uci in GAME:
        jpos, tpos = jpos.push(jpos.parse_uci(uci)), tpos.push(tpos.parse_uci(uci))
        jbs.append(jb.from_position(jpos))
        tbs.append(tb.from_position(tpos))
    return jb.stack_boards(jbs), tb.stack_boards(tbs)


def _gather(shards):
    """Per-shard tensors, or per-shard SearchStates/Boards → one batch."""
    if torch.is_tensor(shards[0]):
        return torch.cat(list(shards))
    return type(shards[0])(*[torch.cat(list(f)) for f in zip(*shards)])


def _assert_state_equal(want, shards):
    got = _gather(shards)
    for field, w, g in zip(ts.SearchState._fields, want, got):
        w = np.asarray(w)
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        assert np.array_equal(g.numpy(), w), field


def _assert_tables_equal(want, tables):
    got = np.stack([t.numpy() for t in tables])
    assert np.array_equal(got, np.asarray(want.data))


def test_make_mesh_and_shard_batch(nets):
    """A mesh is a tuple of torch.devices (repeats allowed); on one device
    the shards are leading-dimension views of the batch, elsewhere
    copies; replicate moves a net once a distinct device; a batch that
    does not divide over the mesh is refused."""
    _, tp = nets
    mesh = tm.make_mesh(["cpu", "cpu", torch.device("cpu"), "cpu"])
    assert mesh == (torch.device("cpu"),) * 4 and len(set(mesh)) == 1
    x = torch.arange(8 * 3, dtype=torch.int32).view(8, 3)
    parts = tm.shard_batch(mesh, x)
    assert [p.shape for p in parts] == [(2, 3)] * 4
    assert all(p.data_ptr() == x[2 * i:].data_ptr() for i, p in enumerate(parts))
    assert torch.equal(_gather(parts), x)
    _, roots = _roots()
    boards = tm.shard_batch(mesh, tb.Board(*[t[:8] for t in roots]))
    assert isinstance(boards[0], tb.Board) and boards[3].board.shape == (2, 64)
    nets4 = tm.replicate(mesh, tp)
    assert all(n is nets4[0] for n in nets4)
    with pytest.raises(ValueError):
        tm.shard_batch(tm.make_mesh(["cpu"] * 3), x)
    with pytest.raises(ValueError):
        tm.make_mesh([])
    tables = tm.make_sharded_table(mesh, 6)
    assert len(tables) == 4 and all(t.shape == (64, 4) and not t.any() for t in tables)
    assert len({t.data_ptr() for t in tables}) == 4


def test_fetch_lanes_and_rows_over_shards():
    """The boundary reads: fetch_lanes concatenates one tensor a shard,
    fetch_rows picks global lanes in the order asked, each in one read a
    distinct device; one device is a list of one shard."""
    Lanes = namedtuple("Lanes", "lane")
    full = torch.arange(8 * 3, dtype=torch.int32).view(8, 3)
    shards = [Lanes(full[2 * s:2 * s + 2]) for s in range(4)]
    stats = SyncStats()
    assert np.array_equal(ts.fetch_lanes([st.lane for st in shards], stats, "x"), full.numpy())
    assert stats.transfers_total == 1
    lanes = [5, 0, 7, 2, 3]
    for states in (shards, [Lanes(full)]):
        got = ts.fetch_rows(states, lanes, lambda st: st.lane, stats, "x")
        assert np.array_equal(got, full.numpy()[lanes])
    assert stats.transfers_total == 3


def test_launch_runs_on_its_tensors_card(monkeypatch):
    """kernels._launch makes the card its tensors lie on current and
    launches on that card's current stream, whichever card the caller
    had current, so a shard on a mesh of several cards launches K11, or
    its splice's K1, K4 and K7, on its own card. torch.cuda's device
    guard and streams are stood in for here."""
    current = [0]

    class Guard:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.index

        def __exit__(self, *exc):
            current[0] = self.prev

    class Stream:
        def __init__(self, index):
            self.cuda_stream = 1000 + index

    seen = []
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream(current[0] if device is None
                                                   else torch.device(device).index))
    monkeypatch.setitem(kernels._fns, "entry", lambda *a: seen.append((current[0], a)) or 0)
    monkeypatch.setattr(kernels, "LAUNCHES", Counter())
    monkeypatch.setattr(kernels, "LAUNCHES_BY_ENTRY", {})
    kernels._launch("lane_init", "entry", torch.device("cuda", 2), 7, 8)
    assert seen == [(2, (7, 8, 1002))] and current == [0]
    assert kernels.LAUNCHES["lane_init"] == 1


@pytest.mark.parametrize("table", [False, True])
def test_segment_and_refill_sharded_match_reference(nets, meshes, table):
    """Three sharded segments of 40 steps over the first 8 positions (lanes
    park on different shards at different segments), a splice of every
    DONE lane with new positions, windows, jitters and groups, then two
    more segments: after each, the port's shards equal the reference's
    sharded state, the per-shard steps and the stacked summary equal its
    (ndev,) and (ndev, 2, 4) outputs and the tables its (8, N, 4) table.
    Each port segment also equals run_segment_plain run on a copy of
    each shard (and its table) alone, summary for summary, and the
    splice equals refill_lanes_sharded_plain's. With the table the
    segments run the helpers' store under per-lane generations."""
    jp, tp = nets
    jmesh, tmesh = meshes
    jroots, troots = _roots()
    depth = DEPTHS[:WIDTH].copy()
    budget = BUDGET[:WIDTH].copy()
    jstate = js._init_state_jit(jp, jax.tree.map(lambda a: a[:WIDTH], jroots),
                                jnp.asarray(depth), jnp.asarray(budget), MAX_PLY, "standard")
    jstate = jm.shard_batch(jmesh, jstate)
    state = ts.init_state(tp, tb.Board(*[t[:WIDTH] for t in troots]), torch.from_numpy(depth),
                          torch.from_numpy(budget), MAX_PLY)
    shards = tm.shard_batch(tmesh, state)
    jtab = jm.make_sharded_table(jmesh, 8) if table else None
    tables = tm.make_sharded_table(tmesh, 8) if table else None
    gen = np.arange(3, 3 + WIDTH, dtype=np.int32)
    kw = dict(prefer_deep=table, tt_gen=gen if table else 0)

    def segment(steps):
        nonlocal jstate, jtab
        jstate, jtab, jn_, jsumm = jm.run_segment_sharded(jmesh, jp, jstate, jtab, steps, **kw)
        copies = [ts.SearchState(*[t.clone() for t in s]) for s in shards]
        tcopies = None if tables is None else [t.clone() for t in tables]
        n, stacked = tm.run_segment_sharded(tmesh, tp, shards, tables, steps, **kw)
        assert n == np.asarray(jn_).tolist()
        assert np.array_equal(stacked, np.asarray(jsumm))
        _assert_state_equal(jstate, shards)
        if table:
            _assert_tables_equal(jtab, tables)
        # each shard's K11 plain version, alone on a copy
        for s in range(len(tmesh)):
            ns, summ = ts.run_segment_plain(
                tp, copies[s], steps, True, None if tcopies is None else tcopies[s],
                prefer_deep=table, tt_gen=torch.from_numpy(gen[s:s + 1]) if table else 0)
            assert ns == n[s] and np.array_equal(summ.numpy(), stacked[s])
            for a, b in zip(copies[s], shards[s]):
                assert torch.equal(a, b)
            if table:
                assert torch.equal(tcopies[s], tables[s])
        return n, stacked

    for _ in range(3):
        n, stacked = segment(40)
    assert max(n) == 40 and len(set(n)) > 1, n  # the shards stopped apart
    done = stacked[:, :-1, ts.SUM_DONE].reshape(-1) != 0
    assert done.any() and not done.all()

    lanes = np.nonzero(done)[0]
    k = len(lanes)
    take = np.arange(WIDTH, WIDTH + k) % N_POS
    rng = np.random.default_rng(11)
    splice = dict(
        root_alpha=np.full(k, -ts.INF, np.int32), root_beta=np.full(k, ts.INF, np.int32),
        order_jitter=rng.integers(-5, 9, k).astype(np.int32),
        group=np.arange(k, dtype=np.int32))
    splice["root_alpha"][0], splice["root_beta"][0] = -40, 40
    jstate = jm.refill_lanes_sharded(
        jmesh, jp, jstate, jax.tree.map(lambda a: a[jnp.asarray(take)], jroots), lanes,
        jnp.asarray(DEPTHS[take]), jnp.asarray(BUDGET[take]),
        **{key: jnp.asarray(v) for key, v in splice.items()})
    new_roots = tb.Board(*[t[torch.from_numpy(take)] for t in troots])
    plain = [ts.SearchState(*[t.clone() for t in s]) for s in shards]
    tm.refill_lanes_sharded(tmesh, tp, shards, new_roots, lanes, DEPTHS[take], BUDGET[take],
                            **splice)
    tm.refill_lanes_sharded_plain(tmesh, tp, plain, new_roots, lanes, DEPTHS[take],
                                  BUDGET[take], **splice)
    _assert_state_equal(jstate, shards)
    _assert_state_equal(jstate, plain)
    for _ in range(2):
        segment(40)
    with pytest.raises(ValueError):  # lane numbers are global: 8 lanes in all
        tm.refill_lanes_sharded(tmesh, tp, shards, tb.Board(*[t[:1] for t in troots]),
                                [WIDTH], DEPTHS[:1], BUDGET[:1])


@pytest.fixture(scope="module")
def streams(nets, meshes):
    """search_stream over the staggered workload in both packages: the
    synchronous mesh loop without a table, the pipelined one with a
    2^10-slot table a shard and the helpers' store, and the port's
    single-device run without a table."""
    jp, tp = nets
    jmesh, tmesh = meshes
    jroots, troots = _roots()
    kw = dict(max_ply=MAX_PLY, width=WIDTH, segment_steps=SEGMENT)
    out = {}
    for mode, pipeline, table in (("sync", False, False), ("piped", True, True)):
        out[mode] = (
            js.search_stream(jp, jroots, DEPTHS, BUDGET, mesh=jmesh, pipeline=pipeline,
                             tt=jm.make_sharded_table(jmesh, 10) if table else None,
                             prefer_deep_store=table, **kw),
            ts.search_stream(tp, troots, DEPTHS, BUDGET, mesh=tmesh, pipeline=pipeline,
                             tt=tm.make_sharded_table(tmesh, 10) if table else None,
                             prefer_deep_store=table, device="cpu", **kw))
    out["single"] = ts.search_stream(tp, troots, DEPTHS, BUDGET, pipeline=True, device="cpu",
                                     **kw)
    return out


@pytest.mark.parametrize("mode", ["sync", "piped"])
def test_stream_mesh_matches_reference(streams, mode):
    """Every per-position field, the steps, the refills, each occupancy
    row (transfers, elements and the per-shard columns included) and,
    pipelined, the per-shard tables equal the reference's mesh stream."""
    want, got = streams[mode]
    for k in STREAM_FIELDS:
        assert np.array_equal(got[k], np.asarray(want[k])), k
    assert got["done"].all()
    assert got["steps"] == int(want["steps"])
    assert got["refills"] == want["refills"] == N_POS - WIDTH
    assert len(got["occupancy"]) == len(want["occupancy"])
    for w, g in zip(want["occupancy"], got["occupancy"]):
        assert {k: g[k] for k in OCC_KEYS} == {k: w[k] for k in OCC_KEYS}
    if mode == "piped":
        _assert_tables_equal(want["tt"], got["tt"])
        assert sum(int((t[:, 1] != 0).sum()) for t in got["tt"]) > 50
    else:
        assert got["tt"] is None


def test_stream_mesh_matches_single_device(streams):
    """Without a table the lanes are independent: the 8-shard stream
    equals the single-device stream position for position."""
    got, single = streams["sync"][1], streams["single"]
    for k in STREAM_FIELDS:
        assert np.array_equal(got[k], single[k]), k
    assert "shard_live" not in single["occupancy"][0]


def test_stream_mesh_shard_columns_and_transfers(streams):
    """Each mesh row carries one entry a shard in its per-shard columns,
    consistent with the scalar ones; a no-finish boundary of the
    pipelined loop is one transfer (the stacked summary, one read for
    the one device), and the synchronous loop pays more at its own."""
    for mode in ("sync", "piped"):
        occ = streams[mode][1]["occupancy"]
        for row in occ:
            for key in ("shard_live", "shard_refilled", "shard_steps"):
                assert len(row[key]) == 8, (mode, key)
            assert sum(row["shard_live"]) == row["live"]
            assert sum(row["shard_refilled"]) == row["refilled"]
            assert max(row["shard_steps"]) == row["steps"]
    nofin = [o for o in streams["piped"][1]["occupancy"][:-1] if o["refilled"] == 0]
    assert nofin, "no quiet boundary: shorten the segment"
    assert all(o["transfers"] == 1 for o in nofin)
    sync_quiet = [o for o in streams["sync"][1]["occupancy"][:-1] if o["refilled"] == 0]
    assert min(o["transfers"] for o in sync_quiet) >= 2


def test_stream_mesh_refuses_a_width_that_does_not_divide(nets):
    _, tp = nets
    _, troots = _roots()
    with pytest.raises(ValueError):
        ts.search_stream(tp, troots, 1, 1, max_ply=4, width=8, device="cpu",
                         mesh=tm.make_mesh(["cpu"] * 3))
    with pytest.raises(ValueError):
        ts.search_stream(tp, troots, 1, 1, max_ply=4, width=8, device="cpu",
                         mesh=tm.make_mesh(["cpu"] * 4), tt=tm.make_sharded_table(
                             tm.make_mesh(["cpu"] * 2), 4))
