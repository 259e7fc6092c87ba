"""fishnet_tpu_torch's Stockfish `.nnue` reader, writer and full eval
against the JAX package's models/nnue_import.py, on the CPU.

A synthetic quantized net (the JAX package's own test generator: L1 64,
seeded) goes through both writers (equal bytes) and both readers (equal
arrays, bit for bit: the same float64 division, then float32), raw and
LEB128-compressed; malformed files are refused by both; the full eval
(`evaluate_sf`, K13's plain version on the CPU) agrees with the JAX one
within F32_EVAL_TOL centipawns on seeded positions (the two sum the
layer stack in different orders; the JAX package's own test allows
rel=1e-4, abs=0.5 against its numpy mirror); and a search on the net
agrees with the JAX search as the f32 board768 searches do, finding the
reference test's mate exactly."""
import jax
import numpy as np
import pytest
import torch

from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.models import nnue_import as ji
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops.search import search_batch_jit
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.models import nnue_import as ti
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops.search import MATE, search_batch
from test_torch_board import _playout_fens

L1 = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def quantized():
    """The JAX package's synthetic net (tests/test_nnue_import.py), L1 64."""
    rng = np.random.default_rng(7)
    nf = ji.NUM_FEATURES
    return {
        "ft_b": rng.integers(-500, 500, L1).astype(np.int16),
        "ft_w": rng.integers(-127, 128, (nf, L1)).astype(np.int16),
        "psqt": rng.integers(-2000, 2000, (nf, 8)).astype(np.int32),
        "fc0_b": rng.integers(-8000, 8000, (8, ji.FC0_OUT)).astype(np.int32),
        "fc0_w": rng.integers(-127, 128, (8, ji.FC0_OUT, L1)).astype(np.int8),
        "fc1_b": rng.integers(-8000, 8000, (8, ji.FC1_OUT)).astype(np.int32),
        "fc1_w": rng.integers(-127, 128, (8, ji.FC1_OUT, ji.FC1_IN)).astype(np.int8),
        "fc2_b": rng.integers(-8000, 8000, (8, 1)).astype(np.int32),
        "fc2_w": rng.integers(-127, 128, (8, 1, ji.FC1_OUT)).astype(np.int8),
        "description": b"test net",
    }


@pytest.fixture(scope="module")
def files(quantized, tmp_path_factory):
    """The net written raw and LEB128-compressed by the JAX writer."""
    d = tmp_path_factory.mktemp("nnue")
    raw, comp = d / "raw.nnue", d / "comp.nnue"
    ji.write_nnue(raw, quantized)
    ji.write_nnue(comp, quantized, compress_ft=True)
    return raw, comp


@pytest.fixture(scope="module")
def nets(files):
    return ji.load_nnue(files[0]), ti.load_nnue(files[0], device="cpu")


def _same_net(want, got):
    for f in ti.ARRAY_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert w.dtype == g.dtype == np.float32 and w.shape == g.shape, f
        assert np.array_equal(w.view(np.int32), g.view(np.int32)), f
    assert (got.version, got.net_hash, got.description) == (
        want.version, want.net_hash, want.description)


@pytest.mark.parametrize("compressed", [False, True])
def test_load_nnue_equals_reference(files, compressed):
    """Raw (L1 inferred from the size) and LEB128 (L1 given) files read
    into the reference's arrays bit for bit."""
    path = files[compressed]
    l1 = L1 if compressed else None
    got = ti.load_nnue(path, l1=l1, device="cpu")
    assert got.l1 == L1 and got.device.type == "cpu"
    _same_net(ji.load_nnue(path, l1=l1), got)


@pytest.mark.parametrize("compressed", [False, True])
def test_write_nnue_writes_the_reference_bytes(quantized, files, tmp_path, compressed):
    path = tmp_path / "port.nnue"
    ti.write_nnue(path, quantized, compress_ft=compressed)
    assert path.read_bytes() == files[compressed].read_bytes()


def test_net_from_the_reference_arrays(nets):
    """stockfish_net_from_numpy carries a JAX net's arrays over exactly."""
    want, got = nets
    port = ti.stockfish_net_from_numpy(
        {f: np.asarray(getattr(want, f)) for f in ti.ARRAY_FIELDS}, "cpu",
        version=want.version, net_hash=want.net_hash, description=want.description)
    _same_net(want, port)
    _same_net(want, got)
    assert port.to("cpu").l1 == L1


def test_leb128_codec_matches_reference():
    vals = np.array([0, 1, -1, 63, 64, -64, -65, 127, -128, 32767, -32768, 2**31 - 1, -2**31])
    enc = ti._leb128_encode(vals)
    assert enc == ji._leb128_encode(vals)
    dec, used = ti._leb128_decode(memoryview(enc), len(vals))
    assert used == len(enc)
    np.testing.assert_array_equal(dec, vals)


REFUSALS = {
    # case: (which file, how it is broken, load_nnue's keywords, message)
    "truncated": (0, lambda d: d[:-100], {}, None),
    "a size of no known L1": (0, lambda d: d + b"\x00" * 8, {}, "cannot infer L1"),
    "trailing bytes": (0, lambda d: d + b"\x00" * 8, {"l1": L1}, "trailing"),
    "truncated LEB128 stream": (1, lambda d: d[: len(d) // 2], {"l1": L1}, None),
    "compressed without l1": (1, lambda d: d, {}, "pass l1="),
    "odd L1": (1, lambda d: d, {"l1": L1 - 1}, "even"),
    "implausible description": (0, lambda d: d[:8] + (5000).to_bytes(4, "little") + d[12:],
                                {}, "description"),
    "no header": (0, lambda d: d[:6], {}, None),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_malformed_files_are_refused(files, tmp_path, case):
    """Both readers refuse each malformed file with UnsupportedNnueFormat
    (the port also where the reference's header read runs off the end)."""
    which, broken, kw, message = REFUSALS[case]
    bad = tmp_path / "bad.nnue"
    bad.write_bytes(broken(files[which].read_bytes()))
    with pytest.raises(ti.UnsupportedNnueFormat, match=message):
        ti.load_nnue(bad, device="cpu", **kw)
    if case != "no header":  # the reference's struct read raises struct.error there
        with pytest.raises(ji.UnsupportedNnueFormat, match=message):
            ji.load_nnue(bad, **kw)


FENS = [
    "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1",
    "r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1",
    "8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 b - - 0 1",
    "6k1/5ppp/8/8/8/8/8/4R2K w - - 0 1",
    "4k3/8/8/8/8/8/4P3/4K3 w - - 0 1",
]


def test_evaluate_sf_matches_reference(nets):
    """The port's full eval against the JAX evaluate_sf over the FENs and
    seeded playouts (both sides to move, king moves through the mirrored
    buckets): within F32_EVAL_TOL."""
    jnet, tnet = nets
    fens = FENS + [f for _, f in _playout_fens(FENS[:2], 27, 11)]
    jboards = jb.stack_boards([jb.from_position(JaxPosition.from_fen(f)) for f in fens])
    tboards = tb.stack_boards([tb.from_position(Position.from_fen(f)) for f in fens])
    want = np.asarray(jax.jit(jax.vmap(ji.evaluate_sf, in_axes=(None, 0, 0)))(
        jnet.as_device(), jboards.board, jboards.stm))
    got = ti.evaluate_sf(tnet, tboards.board, tboards.stm).numpy()
    assert got.dtype == np.float32 and got.shape == (len(fens),)
    assert np.abs(got - want).max() <= tn.F32_EVAL_TOL, np.abs(got - want).max()
    assert np.abs(want).max() > 100  # the evals are not all near zero


# (fen, depth, node budget) of one 16-lane search on the net: the
# reference test's mate in one, mated, stalemate, depth-1 and depth-2 roots
SEARCH = [
    ("6k1/5ppp/8/8/8/8/8/4R2K w - - 0 1", 2, 10_000),
    ("R5k1/5ppp/8/8/8/8/8/6K1 b - - 0 1", 2, 10_000),
    ("7k/5Q2/6K1/8/8/8/8/8 b - - 0 1", 2, 10_000),
    (FENS[0], 1, 10_000), (FENS[1], 1, 10_000),
    (FENS[2], 2, 10_000), (FENS[4], 2, 10_000),
]


def test_search_on_the_net_agrees_with_reference(nets):
    """A 16-lane search on the f32 Stockfish net, as the f32 board768
    searches are held (tests/test_torch_search.py): mates exact, depth-1
    roots on the same move, scores within 2 cp, at most two moves apart."""
    jnet, tnet = nets
    cases = SEARCH + [SEARCH[0]] * (16 - len(SEARCH))
    jroots = jb.stack_boards([jb.from_position(JaxPosition.from_fen(f)) for f, _, _ in cases])
    troots = tb.stack_boards([tb.from_position(Position.from_fen(f)) for f, _, _ in cases])
    depth = np.asarray([d for _, d, _ in cases], np.int32)
    budget = np.asarray([n for _, _, n in cases], np.int32)
    want = {k: np.asarray(v) for k, v in search_batch_jit(
        jnet.as_device(), jroots, depth, budget, max_ply=4).items() if k != "tt"}
    got = search_batch(tnet, troots, depth, budget, max_ply=4, device="cpu")
    n = len(SEARCH)
    assert got["score"][0] == want["score"][0] == MATE - 1
    assert got["move"][0] == want["move"][0] == (4 | (60 << 6))  # e1e8
    assert got["score"][1] == want["score"][1] == -MATE and got["move"][1] == -1
    assert got["score"][2] == want["score"][2] == 0 and got["move"][2] == -1
    assert np.array_equal(got["move"][3:5], want["move"][3:5])
    assert np.abs(got["score"][:n] - want["score"][:n]).max() <= 2
    assert int((got["move"][:n] == want["move"][:n]).sum()) >= n - 2
    assert got["done"].all()
