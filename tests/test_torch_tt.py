"""fishnet_tpu_torch's transposition table against the JAX package's, on
the CPU: meta packing, probe and store (plain versions, on seeded
tables, with forced slot collisions) and the TT-on lockstep search,
compared field for field and by the final table contents.

Every comparison is exact. The searches use the int8-quantized net (the
port's int8 search is the reference's bit for bit) at the JAX tests' 16
lanes; positions with different depths and budgets share one dispatch.
The f32 search is held to tests/test_torch_search.py's tolerance
(scores within 2 cp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import tt_case
from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import tt as jtt
from fishnet_tpu.ops.search import search_batch_resumable as jax_search
from fishnet_tpu_torch import kernels
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import tt
from fishnet_tpu_torch.ops.search import search_batch_resumable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u32(a):
    return jax.lax.bitcast_convert_type(jnp.asarray(np.asarray(a, np.int32)), jnp.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ table ops


def test_meta_roundtrip_matches_reference():
    rng = np.random.default_rng(3)
    score = rng.integers(-30000, 30001, 500).astype(np.int32)
    depth = rng.integers(0, 64, 500).astype(np.int32)
    flag = rng.integers(0, 3, 500).astype(np.int32)
    want = np.asarray(jtt.pack_meta(jnp.asarray(score), jnp.asarray(depth), jnp.asarray(flag)))
    got = tt.pack_meta(_t(score), _t(depth), _t(flag))
    assert np.array_equal(got.numpy(), want)
    for g, w in zip(tt.unpack_meta(got), jtt.unpack_meta(jnp.asarray(want))):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (tt.FLAG_EXACT, tt.FLAG_LOWER, tt.FLAG_UPPER) == (
        jtt.FLAG_EXACT, jtt.FLAG_LOWER, jtt.FLAG_UPPER)
    assert tt._MAX_STORE == jtt._MAX_STORE


@pytest.mark.parametrize("deep_bounds", [False, True])
@pytest.mark.parametrize("lanes,size_log2", [(16, 4), (1024, 6)])
def test_probe_matches_reference(lanes, size_log2, deep_bounds):
    """Half the lanes probe keys written into their slot (so hits of every
    flag, depth and window), half probe random keys (misses and torn
    rows); all four outputs equal the reference's, and the enter mask
    gates usable and the ordering move."""
    c = tt_case(lanes, size_log2, lanes + size_log2 + deep_bounds)
    data, h1, h2 = c["table"], c["h1"], c["h2"]
    depth_left, alpha, beta = c["depth_left"], c["alpha"], c["beta"]
    rows = data[h1 & ((1 << size_log2) - 1)]
    hit = ((rows[:, 0] ^ rows[:, 1] ^ rows[:, 2]) == h2) & (rows[:, 1] != 0)
    usable_w, score_w, move_w, order_w = jtt.probe(
        jtt.TTable(jnp.asarray(data)), _u32(h1), _u32(h2), jnp.asarray(depth_left),
        jnp.asarray(alpha), jnp.asarray(beta), deep_bounds=deep_bounds)
    usable_w, order_w = np.asarray(usable_w), np.asarray(order_w)
    assert usable_w.any() and (~usable_w & hit).any()
    args = [_t(x) for x in (data, h1, h2, depth_left, alpha, beta)]
    usable, score, order = tt.probe(*args, torch.ones(lanes, dtype=torch.bool),
                                    deep_bounds=deep_bounds)
    assert np.array_equal(usable.numpy(), usable_w)
    assert np.array_equal(score.numpy(), np.asarray(score_w))
    assert np.array_equal(order.numpy(), order_w)
    assert np.array_equal(torch.where(usable, order, -1).numpy(), np.asarray(move_w))
    enter = c["enter"]
    usable, _, order = tt.probe(*args, _t(enter), deep_bounds=deep_bounds)
    assert np.array_equal(usable.numpy(), usable_w & enter)
    assert np.array_equal(order.numpy(), np.where(enter, order_w, -1))


def _stores_agree(case, prefer_deep, gen):
    c = case
    want = jtt.store(
        jtt.TTable(jnp.asarray(c["table"])), _u32(c["h1"]), _u32(c["h2"]),
        *[jnp.asarray(c[k]) for k in ("score", "depth", "flag", "move", "mask")],
        prefer_deep=prefer_deep, gen=None if gen is None else jnp.asarray(gen))
    want = np.asarray(want.data)
    table = _t(c["table"])
    out = tt.store(table, *[_t(c[k]) for k in ("h1", "h2", "score", "depth", "flag", "move",
                                              "mask")],
                   prefer_deep=prefer_deep, gen=None if gen is None else _t(gen))
    assert out is table  # in place
    assert np.array_equal(table.numpy(), want)
    return want


@pytest.mark.parametrize("prefer_deep,gen", [
    (False, None), (False, 1), (True, None), (True, 1), (True, 2), (True, "lanes"),
])
@pytest.mark.parametrize("lanes,size_log2", [(16, 3), (1024, 6), (300, 12)])
def test_store_matches_reference(lanes, size_log2, prefer_deep, gen):
    """1024 lanes into 64 slots forces collisions (the highest storable
    lane wins); the old rows carry generations 0-2, so gen 1 and 2 meet
    both same- and other-generation rows under prefer_deep; "lanes" is a
    per-lane generation array."""
    case = tt_case(lanes, size_log2, lanes * 7 + size_log2)
    if gen == "lanes":
        gen = np.random.default_rng(lanes).integers(0, 3, lanes).astype(np.int32)
    want = _stores_agree(case, prefer_deep, gen)
    assert (want != case["table"]).any()


@pytest.mark.parametrize("prefer_deep,gen", [(False, None), (True, 1), (True, "lanes")])
@pytest.mark.parametrize("lanes,size_log2", [(1024, 6), (1024, 12), (8192, 6), (8192, 12)])
def test_store_on_four_slots_matches_reference(lanes, size_log2, prefer_deep, gen):
    """Every lane's key on one of four slots (chip_smoke's K6 cases): the
    highest storable lane of each slot wins, each storing lane's keep-old
    decision reads the pre-store row, with mixed per-lane generations
    ("lanes") against the table's mixed ones."""
    case = tt_case(lanes, size_log2, lanes + size_log2 + 4, n_slots=4)
    assert len(np.unique(case["h1"] & ((1 << size_log2) - 1))) == 4
    if gen == "lanes":
        gen = np.random.default_rng(lanes).integers(0, 3, lanes).astype(np.int32)
    want = _stores_agree(case, prefer_deep, gen)
    assert 0 < int((want != case["table"]).any(1).sum()) <= 4


def test_store_collisions_keep_the_highest_lane():
    """Every lane stores to one slot: the last storable lane's row lands
    whole; masked and mate-range lanes store nothing."""
    lanes = 64
    case = tt_case(lanes, 4, 5)
    case["h1"][:] = 7
    case["mask"][:] = True
    case["mask"][-1] = False
    case["score"][-2] = 31000
    want = _stores_agree(case, False, None)
    i = lanes - 3
    meta = tt.pack_meta(int(case["score"][i]), int(case["depth"][i]), int(case["flag"][i]))
    assert list(want[7]) == [int(case["h2"][i]) ^ meta ^ int(case["move"][i]), meta,
                             int(case["move"][i]), 0]


def test_make_table_and_wrappers_refuse_cpu_tensors():
    table = tt.make_table(5, device="cpu")
    assert table.shape == (32, 4) and table.dtype == torch.int32 and not table.any()
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.tt_probe(table, z, z, z, z, z, z.bool(), False)
    with pytest.raises(ValueError):
        kernels.tt_store(table, z, z, z, z, z, z, z.bool(), False)


# -------------------------------------------------------------- search

B = 16
ITALIAN = "r1bqkbnr/pppp1ppp/2n5/4p3/2B1P3/5N2/PPPP1PPP/RNBQK2R b KQkq - 3 3"
KIWIPETE = "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1"
EP_RICH = "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1"
ROOK_END = "6k1/5ppp/8/8/8/8/5PPP/3R2K1 w - - 0 1"
MATE_IN_ONE = "6k1/5ppp/8/8/8/8/8/4R2K w - - 0 1"
FIFTY = "8/8/2k5/8/8/3K4/8/4R3 w - - 99 80"
FENS = [ITALIAN, KIWIPETE, EP_RICH, ROOK_END, MATE_IN_ONE, FIFTY]
FIELDS = ("score", "move", "nodes", "pv", "pv_len", "done")
SEGMENT = 150  # several segments per search, so boundaries are exercised
MAX_PLY = 5


def _case(fens, depth):
    """16 lanes: the positions, then copies of them (the helper lanes of
    the group runs); depth per lane."""
    fens = [fens[i % len(fens)] for i in range(B)]
    jroots = jb.stack_boards([jb.from_position(JaxPosition.from_fen(f)) for f in fens])
    troots = tb.stack_boards([tb.from_position(Position.from_fen(f)) for f in fens])
    return jroots, troots, np.asarray(depth, np.int32)


DEPTH = [2, 3, 2, 3, 2, 2] + [2] * 10
BUDGET = 400
HELPERS = dict(
    # primaries 0..5, helpers in 6..15 (lane r searches position r % 6;
    # every other helper two plies deeper, so some are still searching
    # when the primaries finish)
    order_jitter=np.asarray([0] * 6 + list(range(1, 11)), np.int32),
    group=np.asarray([r % 6 for r in range(B)], np.int32),
    required=np.arange(B) < 6, prefer_deep_store=True, tt_gen=3,
)
HELPER_DEPTH = DEPTH[:6] + [4 if i % 2 else 2 for i in range(10)]
HELPER_BUDGET = np.asarray([BUDGET] * 6 + [20 * BUDGET] * 10, np.int32)


@pytest.fixture(scope="module")
def nets():
    jp = jn.init_params(jax.random.PRNGKey(0), l1=32, h1=8, h2=8, feature_set="board768")
    jq = jn.quantize_int8(jp)

    def port(p):
        return tn.params_from_numpy({f: np.asarray(getattr(p, f)) for f in jn.NnueParams._fields},
                                    "cpu")

    return {"f32": (jp, port(jp)), "int8": (jq, port(jq))}


def _search_both(nets, net, depth, tables, budget=BUDGET, **kw):
    """One search through both packages on (jax table, torch table) →
    (want, got) with numpy fields; the tables come back updated."""
    jp, tp = nets[net]
    jroots, troots, depth = _case(FENS, depth)
    jkw = dict(kw)
    for k in ("order_jitter", "group"):
        if k in jkw:
            jkw[k] = jnp.asarray(jkw[k])
    want = jax_search(jp, jroots, depth, budget, max_ply=MAX_PLY, segment_steps=SEGMENT,
                      tt=tables[0], **jkw)
    tables[0] = want.pop("tt")
    want = {k: np.asarray(v) for k, v in want.items()}
    # the reference donates the table it is given: keep a copy to compare
    want["table"] = np.asarray(tables[0].data).copy()
    got = search_batch_resumable(tp, troots, depth, budget, max_ply=MAX_PLY,
                                 segment_steps=SEGMENT, tt=tables[1], device="cpu", **kw)
    assert got.pop("tt") is tables[1]
    got["table"] = tables[1].numpy().copy()
    return want, got


def _assert_identical(want, got):
    for k in FIELDS:
        assert np.array_equal(got[k], want[k]), k
    assert got["steps"] == int(want["steps"])
    assert np.array_equal(got["table"], want["table"])


@pytest.fixture(scope="module")
def shared(nets):
    """A plain TT search and then a helper-group search on the same
    table (the engine's table persists across dispatches)."""
    tables = [jtt.make_table(12), tt.make_table(12, device="cpu")]
    first = _search_both(nets, "int8", DEPTH, tables)
    second = _search_both(nets, "int8", HELPER_DEPTH, tables, HELPER_BUDGET, **HELPERS)
    return first, second


def test_tt_search_int8_bit_identical(shared):
    (want, got), _ = shared
    _assert_identical(want, got)
    assert got["done"].all()
    assert (got["table"][:, 1] != 0).sum() > 100  # the search filled the table
    assert got["score"][4] == 32000 - 1  # the mate in one survives the table
    assert got["score"][5] == 0  # a fifty-move draw is never overridden


def test_tt_search_two_searches_share_one_table(shared):
    """The helper search starts from the table the first search left
    (the engine's table persists across dispatches)."""
    _, (want, got) = shared
    _assert_identical(want, got)


def test_tt_search_with_helper_lanes_bit_identical(nets, shared):
    """Jittered helper lanes, group tags, the required-lane stop (the
    depth-4 helpers are abandoned once the primaries finish) and the
    depth-preferred generation store, on a fresh table."""
    tables = [jtt.make_table(12), tt.make_table(12, device="cpu")]
    want, got = _search_both(nets, "int8", HELPER_DEPTH, tables, HELPER_BUDGET, **HELPERS)
    _assert_identical(want, got)
    print(f"helper search steps: fresh table {got['steps']}, shared table "
          f"{shared[1][1]['steps']}; plain search {shared[0][1]['steps']}")
    assert got["done"][:6].all() and not got["done"][6:].all()
    assert (got["table"][:, 3][got["table"][:, 1] != 0] == 3).all()


def test_tt_search_f32_within_tolerance(nets):
    """f32: leaf evals differ from XLA's in their last bits
    (tests/test_torch_nnue.py), so the TT search is held to
    tests/test_torch_search.py's tolerance on the primaries' scores
    and the mate exactly."""
    tables = [jtt.make_table(12), tt.make_table(12, device="cpu")]
    want, got = _search_both(nets, "f32", DEPTH, tables)
    n = len(FENS)
    diff = np.abs(got["score"][:n] - want["score"][:n])
    print(f"f32 TT search: max |score diff| {int(diff.max())}, same move "
          f"{int((got['move'][:n] == want['move'][:n]).sum())}/{n}")
    assert diff.max() <= 2
    assert got["score"][4] == want["score"][4] == 32000 - 1
    assert got["done"].all()
