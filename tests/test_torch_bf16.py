"""bf16 weights (FISHNET_TPU_DTYPE=bf16, cast_params) in the port against
the JAX package on the CPU, at the reference tests' shapes (16 lanes,
MAX_PLY 8), on the shipped board768 net and on a seeded king-bucketed
net (L1 32, H1 8, H2 8).

bf16 is a storage format in both packages: each weight is rounded to
bf16 once and every sum runs in f32. So `cast_params` gives the
reference's bits; the accumulators (K1's, K3's and K12's refresh) are
the reference's bit for bit; the layer stack (K2, K12) sums in another
order than XLA's promoted dot, so evals agree within F32_EVAL_TOL and a
search within the f32 rule of tests/test_torch_search.py. Inside the
port the rule is exact: every plain bf16 function, run_segment_plain
included, gives the plain f32 function's bytes on the widened weights.
GpuEngine(device="cpu") under FISHNET_TPU_DTYPE=bf16 answers a chunk as
TpuEngine does by the f32 rule (standard chess on both nets, and
atomic, whose board768 leaf is K1's refresh), and a Stockfish net under
bf16 raises in both engines."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fishnet_tpu.assets import default_weights_path
from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops.search import search_batch_jit
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import search as ts
from fishnet_tpu_torch.ops import tt
from fishnet_tpu_torch.ops.search import MATE, search_batch
from chip_smoke import f32_rule, variant_positions
from test_torch_board import _playout_fens
from test_torch_nnue_import import FENS
from test_torch_search import SHALLOW, _roots

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


def _bits(t):
    """A bf16 tensor's or array's 16-bit patterns as uint16."""
    if torch.is_tensor(t):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def _same(a, b):
    """Two tensors byte for byte (floats as their bits)."""
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.fixture(scope="module")
def nets():
    """{"board768": the shipped net, "kb": init_params' king-bucketed net
    at L1 32, H 8} → (jax f32, jax bf16, port f32, port bf16)."""
    out = {}
    for name, jp in (("board768", jn.load_params(default_weights_path("board768"))),
                     ("kb", jn.init_params(jax.random.PRNGKey(3), l1=32, h1=8, h2=8))):
        tp = _port(jp)
        out[name] = (jp, jn.cast_params(jp), tp, tn.cast_params(tp))
    return out


@pytest.fixture(scope="module")
def boards():
    fens = FENS + [f for _, f in _playout_fens(FENS[:2], 30, 5)]
    return (jb.stack_boards([jb.from_position(JaxPosition.from_fen(f)) for f in fens]),
            tb.stack_boards([tb.from_position(Position.from_fen(f)) for f in fens]))


@pytest.mark.parametrize("net", ["board768", "kb"])
def test_cast_params_gives_the_reference_bits(nets, net):
    """Every field bf16 with the reference's bits (16-bit views); f32
    accumulators, not the int8 net; the reference's bf16 arrays cross
    params_from_numpy and params_to_numpy unchanged."""
    _, jb16, _, tb16 = nets[net]
    for f in jn.NnueParams._fields:
        got, want = getattr(tb16, f), getattr(jb16, f)
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert np.array_equal(_bits(got), _bits(want)), f
    assert tn.acc_dtype(tb16) == torch.float32 and not tn.is_int8(tb16)
    assert tn.net_kind(tb16) == (tn.BOARD768 if net == "board768" else tn.KING)
    across = _port(jb16)
    back = tn.params_to_numpy(tb16)
    for f in jn.NnueParams._fields:
        assert _same(getattr(across, f).view(torch.int16), getattr(tb16, f).view(torch.int16))
        assert back[f].dtype == np.asarray(getattr(jb16, f)).dtype
        assert np.array_equal(_bits(back[f]), _bits(getattr(jb16, f))), f


def test_cast_params_refuses_a_stockfish_net(tmp_path):
    """As the reference's cast_params, which cannot iterate the net."""
    from chip_smoke import sf_case
    from fishnet_tpu.models import nnue_import as ji
    from fishnet_tpu_torch.models import nnue_import as ti

    path = tmp_path / "net.nnue"
    ji.write_nnue(path, sf_case(64, seed=2))
    with pytest.raises(TypeError):
        jn.cast_params(ji.load_nnue(str(path)))
    with pytest.raises(TypeError):
        tn.cast_params(ti.load_nnue(path, device="cpu"))


@pytest.mark.parametrize("net", ["board768", "kb"])
def test_accumulators_equal_the_reference(nets, boards, net):
    """The refreshed (B, 2, L1) accumulators of the bf16 net are f32 and
    the reference's bf16 accumulators bit for bit."""
    _, jb16, _, tb16 = nets[net]
    jboards, tboards = boards
    fn = jn.accumulators_768 if net == "board768" else jn.accumulators
    want = np.asarray(jax.jit(jax.vmap(fn, in_axes=(None, 0)))(jb16, jboards.board))
    got = (tn.accumulators_768 if net == "board768" else tn.accumulators)(tb16, tboards.board)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_acc_update_equals_the_reference(nets, boards):
    """K3's plain version on the bf16 board768 net: each lane's update by
    its first legal move equals the reference's apply_acc_updates_768."""
    _, jb16, _, tb16 = nets["board768"]
    _, tboards = boards
    fens = FENS + [f for _, f in _playout_fens(FENS[:2], 30, 5)]
    first = [Position.from_fen(f).legal_moves()[0] for f in fens]
    mv = torch.tensor([m.from_sq | (m.to_sq << 6) | ((m.promotion or 0) << 12) for m in first],
                      dtype=torch.int32)
    codes, sqs, signs = tb.move_piece_changes(tboards, mv)
    acc = tn.accumulators_768(tb16, tboards.board)
    got = tn.apply_acc_updates_768(tb16, acc, codes, sqs, signs)
    want = jax.jit(jax.vmap(jn.apply_acc_updates_768, in_axes=(None, 0, 0, 0, 0)))(
        jb16, jnp.asarray(acc.numpy()), jnp.asarray(codes.numpy()), jnp.asarray(sqs.numpy()),
        jnp.asarray(signs.numpy()))
    assert np.array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    assert not torch.equal(got, acc)


@pytest.mark.parametrize("net", ["board768", "kb"])
def test_evals_agree_with_the_reference(nets, boards, net):
    """forward_from_acc (board768) and evaluate (both nets) on the bf16
    net against the reference's bf16 evals, within F32_EVAL_TOL."""
    _, jb16, _, tb16 = nets[net]
    jboards, tboards = boards
    want = np.asarray(jax.jit(jn.v_evaluate)(jb16, jboards.board, jboards.stm))
    got = tn.evaluate(tb16, tboards.board, tboards.stm).numpy()
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= tn.F32_EVAL_TOL
    if net == "board768":
        acc = tn.accumulators_768(tb16, tboards.board)
        bucket = tn.output_bucket(tboards.board)
        ev = tn.forward_from_acc(tb16, acc, tboards.stm, bucket).numpy()
        assert np.array_equal(ev, got)


@pytest.mark.parametrize("net", ["board768", "kb"])
def test_plain_bf16_is_f32_on_the_widened_weights(nets, boards, net):
    """Every plain function on the bf16 net gives the plain f32
    function's bytes on the same weights widened to f32."""
    _, _, _, tb16 = nets[net]
    wide = tn.widened(tb16)
    assert all(t.dtype == torch.float32 for t in wide)
    _, tboards = boards
    board, stm = tboards.board, tboards.stm
    bucket = tn.output_bucket(board)
    assert _same(tn.evaluate(tb16, board, stm), tn.evaluate(wide, board, stm))
    if net == "kb":
        assert _same(tn.accumulators(tb16, board), tn.accumulators(wide, board))
        assert _same(tn.evaluate_plain(tb16, board, stm), tn.evaluate_plain(wide, board, stm))
        return
    acc = tn.accumulators_768_plain(tb16, board)
    assert _same(acc, tn.accumulators_768_plain(wide, board))
    assert _same(tn.forward_from_acc_plain(tb16, acc, stm, bucket),
                 tn.forward_from_acc_plain(wide, acc, stm, bucket))
    fens = FENS + [f for _, f in _playout_fens(FENS[:2], 30, 5)]
    last = [Position.from_fen(f).legal_moves()[-1] for f in fens]
    mv = torch.tensor([m.from_sq | (m.to_sq << 6) | ((m.promotion or 0) << 12) for m in last],
                      dtype=torch.int32)
    codes, sqs, signs = tb.move_piece_changes(tboards, mv)
    assert _same(tn.apply_acc_updates_768_plain(tb16, acc, codes, sqs, signs),
                 tn.apply_acc_updates_768_plain(wide, acc, codes, sqs, signs))


# per case: net, variant, the table's size (log2), helpers (jitter,
# groups, prefer_deep with per-lane generations)
SEGMENTS = {
    "board768 table": ("board768", "standard", 12, False),
    "board768 colliding helpers": ("board768", "standard", 6, True),
    "kb table": ("kb", "standard", 12, False),
    "board768 atomic helpers": ("board768", "atomic", 12, True),
}


@pytest.mark.parametrize("case", list(SEGMENTS))
def test_run_segment_plain_bf16_is_f32_on_the_widened_weights(nets, boards, case):
    """run_segment_plain on the bf16 net over segments of 1, 7 and 33
    steps equals it on the widened f32 net state for state, table and
    summary byte for byte, the step counts equal."""
    net, variant, size, helpers = SEGMENTS[case]
    _, _, _, tb16 = nets[net]
    wide = tn.widened(tb16)
    if variant == "standard":
        troots = type(boards[1])(*[t[:B] for t in boards[1]])
    else:
        troots = tb.stack_boards([tb.from_position(p)
                                  for p, _, _ in variant_positions(variant, B, 7)])
    depth = torch.tensor([1 + i % 3 for i in range(B)], dtype=torch.int32)
    budget = torch.tensor([100_000 + 37 * i for i in range(B)], dtype=torch.int32)
    kw = {}
    if helpers:
        kw = dict(order_jitter=torch.tensor([0 if i % 4 == 0 else 1000 + 77 * i
                                             for i in range(B)], dtype=torch.int32),
                  group=torch.tensor([i // 4 for i in range(B)], dtype=torch.int32))
    gen = torch.tensor([1 + i % 3 for i in range(B)], dtype=torch.int32) if helpers else 3
    runs = []
    for params in (tb16, wide):
        state = ts.init_state(params, troots, depth, budget, P, variant=variant, **kw)
        table = tt.make_table(size, device="cpu")
        out = []
        for steps in (1, 7, 33):
            out.append(ts.run_segment_plain(params, state, steps, True, table, False, helpers,
                                            gen, variant=variant))
        runs.append((state, table, out))
    (s16, t16, o16), (s32, t32, o32) = runs
    assert s16.acc.dtype == torch.float32
    for field, a, b in zip(ts.SearchState._fields, s16, s32):
        assert _same(a, b), field
    assert torch.equal(t16, t32) and (t16[:, 1] != 0).any()
    for (n16, sum16), (n32, sum32) in zip(o16, o32):
        assert n16 == n32 and torch.equal(sum16, sum32)


def test_search_batch_agrees_with_the_reference(nets):
    """search_batch on the bf16 shipped net against the reference's
    search_batch_jit(cast_params(...)) on tests/test_torch_search.py's
    fixtures, by its f32 rule: mates exact, the depth-1 roots' moves
    equal, scores within 2 cp, all but two moves equal."""
    _, jb16, _, tb16 = nets["board768"]
    jroots, troots, depth, budget = _roots(SHALLOW)
    want = search_batch_jit(jb16, jroots, depth, budget, max_ply=4)
    want = {k: np.asarray(v) for k, v in want.items() if k != "tt"}
    got = search_batch(tb16, troots, depth, budget, max_ply=4, device="cpu")
    n = len(SHALLOW)
    for k in ("score", "move"):
        assert np.array_equal(got[k][:3], want[k][:3]), k  # the mate and stalemate fixtures
    assert int(got["score"][0]) == MATE - 1 and got["done"].all()
    assert np.array_equal(got["move"][3:5], want["move"][3:5])
    assert np.abs(got["score"][:n] - want["score"][:n]).max() <= 2
    assert int((got["move"][:n] == want["move"][:n]).sum()) >= n - 2


@pytest.fixture
def bf16_env(monkeypatch):
    monkeypatch.setenv("FISHNET_TPU_DTYPE", "bf16")
    monkeypatch.delenv("FISHNET_TPU_EXPERIMENTAL_INT8", raising=False)


def engine_chunk_as_tpu_engine(jp, tp):
    """GpuEngine(device="cpu") and TpuEngine under FISHNET_TPU_DTYPE=bf16,
    each given the f32 net jp / tp (params=) and casting it, with a 2^12
    table and K = 2 helpers: the weights bf16 with equal bits, a standard
    chunk answered by the f32 rule."""
    from test_torch_nets import _answers, _chunk, _engines

    want_engine, got_engine = _engines({"params": jp}, {"params": tp})
    for f in jn.NnueParams._fields:
        assert np.array_equal(_bits(getattr(got_engine.params, f)),
                              _bits(getattr(want_engine.params, f))), f
    pairs = _answers(want_engine, got_engine, _chunk((4, 9, 13), 2))
    f32_rule([g for _, g in pairs], [w for w, _ in pairs], 2)


@pytest.mark.parametrize("net", ["board768", "kb"])
def test_engine_chunk_as_tpu_engine(nets, bf16_env, net):
    """engine_chunk_as_tpu_engine on the shipped board768 net and on the
    king-bucketed net (its full eval the leaf)."""
    jp, _, tp, _ = nets[net]
    engine_chunk_as_tpu_engine(jp, tp)


def test_atomic_chunk_as_tpu_engine(nets, bf16_env):
    """An atomic chunk (K1's refresh as the board768 leaf) through both
    engines under bf16, no table, no helpers, chunk-serial: the f32
    rule."""
    from test_torch_atomic import _both
    from test_torch_variants import _chunk as variant_chunk

    jp, _, tp, _ = nets["board768"]
    got, want = _both(jp, tp, variant_chunk("atomic", (4, 9), seed=21))
    f32_rule(got, want, 2)


def test_stockfish_net_under_bf16_raises_in_both_engines(bf16_env, tmp_path):
    """A `.nnue` Stockfish net under bf16 stays an error, as in the
    reference (its cast_params cannot iterate the net)."""
    from chip_smoke import sf_case
    from fishnet_tpu.engine.tpu import TpuEngine
    from fishnet_tpu.models import nnue_import as ji
    from fishnet_tpu_torch.engine.gpu import GpuEngine

    path = tmp_path / "net.nnue"
    ji.write_nnue(path, sf_case(64, seed=11))
    with pytest.raises(TypeError):
        TpuEngine(weights_path=str(path), tt_size_log2=0, refill=False)
    with pytest.raises(TypeError):
        GpuEngine(weights_path=str(path), tt_size_log2=0, device="cpu")
