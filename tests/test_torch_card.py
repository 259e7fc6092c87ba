"""fishnet_tpu_torch's CUDA kernels on the card: each against its plain
PyTorch version (the TT probe and store on seeded tables with forced
slot collisions), the wrappers' checks and launch counts, and the int8
searches on the card against the CPU, with the transposition table and
helper lanes too (tables compared byte for byte). Needs an NVIDIA card; skipped
elsewhere. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_card.py -q -p no:cacheprovider
"""
import random

import numpy as np
import pytest
import torch

from chip_smoke import TT_PROBE_ARGS, TT_STORE_ARGS, tt_inputs, tt_runner_layout
from fishnet_tpu_torch import kernels
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.models import nnue
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import tt
from fishnet_tpu_torch.ops.search import search_batch, search_batch_resumable

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def nets(card):
    f32 = nnue.load_params(device=card)
    return {"f32": f32, "int8": nnue.quantize_int8(f32)}


@pytest.fixture(scope="module")
def lanes(card):
    """48 playout positions and a legal move from each, on the card."""
    rng = random.Random(4)
    boards, moves = [], []
    pos = Position.initial()
    while len(boards) < 48:
        legal = pos.legal_moves()
        if not legal:
            pos = Position.initial()
            continue
        m = rng.choice(legal)
        boards.append(tb.from_position(pos))
        moves.append(m.from_sq | (m.to_sq << 6) | ((m.promotion or 0) << 12))
        pos = pos.push(m)
    b = tb.stack_boards(boards).to(card)
    return b, torch.tensor(moves, dtype=torch.int32, device=card)


@pytest.mark.parametrize("net", ["f32", "int8"])
def test_kernels_match_plain_versions(nets, lanes, net):
    p = nets[net]
    b, mv = lanes
    acc = nnue.accumulators_768_plain(p, b.board)
    assert torch.equal(nnue.accumulators_768(p, b.board), acc)
    codes, sqs, signs = tb.move_piece_changes(b, mv)
    assert torch.equal(nnue.apply_acc_updates_768(p, acc, codes, sqs, signs),
                       nnue.apply_acc_updates_768_plain(p, acc, codes, sqs, signs))
    bucket = nnue.output_bucket(b.board)
    got = nnue.forward_from_acc(p, acc, b.stm, bucket)
    want = nnue.forward_from_acc_plain(p, acc, b.stm, bucket)
    tol = 0.0 if net == "int8" else nnue.F32_EVAL_TOL
    assert float((got - want).abs().max()) <= tol
    z1, z2 = tt.tables(b.board.device)
    assert torch.equal(tt.hash_board(b.board, b.stm, b.ep, b.castling),
                       tt.hash_board_plain(b.board, b.stm, b.ep, b.castling, z1, z2))


def test_wrappers_check_inputs_and_count_launches(nets, lanes):
    p = nets["f32"]
    b, _ = lanes
    kernels.reset_launches()
    nnue.accumulators_768(p, b.board)
    assert kernels.LAUNCHES["nnue_refresh_768"] == 1
    with pytest.raises(TypeError):
        kernels.nnue_refresh_768(b.board.long(), p.ft_w, p.ft_b)
    with pytest.raises(ValueError):
        kernels.nnue_refresh_768(b.board.t().contiguous().t(), p.ft_w, p.ft_b)
    assert kernels.LAUNCHES["nnue_refresh_768"] == 1


def test_int8_search_card_equals_cpu(nets, lanes):
    b, _ = lanes
    roots = tb.Board(*[t[:16] for t in b])
    card = search_batch(nets["int8"], roots, 2, 100_000, max_ply=6)
    cpu = search_batch(nets["int8"].to("cpu"), roots.to("cpu"), 2, 100_000, max_ply=6,
                       device="cpu")
    for k in ("score", "move", "nodes", "pv", "pv_len", "done"):
        assert (card[k] == cpu[k]).all(), k
    assert card["steps"] == cpu["steps"]


@pytest.mark.parametrize("lanes,size_log2", [(16, 3), (64, 21), (1024, 6), (1024, 21),
                                             (3000, 10)])
def test_tt_kernels_match_plain_versions(card, lanes, size_log2):
    """K5 and K6 equal their plain versions bit for bit, on contiguous
    inputs and on the runner's strided and broadcast ones: 1024 lanes
    into 64 slots force collisions (the highest storable lane wins), 64
    lanes into 2^21 slots is the engine's dispatch, 3000 lanes span
    several threads per lane of K6."""
    c = tt_inputs(lanes, size_log2, lanes + size_log2, card)
    runner_probe, runner_store, runner_leaf = tt_runner_layout(c)
    for deep in (False, True):
        for args in ([c[k] for k in TT_PROBE_ARGS], runner_probe):
            got = tt.probe(c["table"], *args, deep_bounds=deep)
            want = tt.probe_plain(c["table"], *args, deep_bounds=deep)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    gen_lanes = torch.randint(0, 3, (lanes,), dtype=torch.int32, device=card)
    for prefer, gen in ((False, None), (False, 2), (True, None), (True, 1), (True, gen_lanes)):
        for args in ([c[k] for k in TT_STORE_ARGS], runner_store, runner_leaf):
            got, want = c["table"].clone(), c["table"].clone()
            tt.store(got, *args, prefer_deep=prefer, gen=gen)
            tt.store_plain(want, *args, prefer_deep=prefer, gen=gen)
            assert torch.equal(got, want)
            assert not torch.equal(want, c["table"])


def test_tt_wrappers_check_inputs_and_count_launches(card):
    c = tt_inputs(64, 8, 1, card)
    kernels.reset_launches()
    tt.probe(c["table"], *[c[k] for k in TT_PROBE_ARGS])
    got, want = c["table"].clone(), c["table"].clone()
    tt.store(got, *[c[k] for k in TT_STORE_ARGS])
    # strided and broadcast (stride 0) lane columns are taken as they are
    cols = torch.stack([c["h1"], c["h2"]], 1)
    zero = torch.zeros((), dtype=torch.int32, device=card).expand(64)
    strided = (cols[:, 0], cols[:, 1], c["score"], zero, zero, zero - 1, c["mask"])
    tt.store(got, *strided)
    assert kernels.LAUNCHES["tt_probe"] == 1 and kernels.LAUNCHES["tt_store"] == 2
    tt.store_plain(want, *[c[k] for k in TT_STORE_ARGS])
    tt.store_plain(want, *strided)
    assert torch.equal(got, want)
    with pytest.raises(TypeError):
        kernels.tt_probe(c["table"], c["h1"].long(), *[c[k] for k in TT_PROBE_ARGS[1:]],
                         False)
    with pytest.raises(ValueError):
        kernels.tt_probe(c["table"][:100], *[c[k] for k in TT_PROBE_ARGS], False)
    big = tt_inputs(kernels.TT_STORE_MAX_LANES + 1, 8, 2, card)
    with pytest.raises(ValueError):
        kernels.tt_store(big["table"], *[big[k] for k in TT_STORE_ARGS], False)
    assert kernels.LAUNCHES["tt_probe"] == 1 and kernels.LAUNCHES["tt_store"] == 2


def test_int8_tt_helper_search_card_equals_cpu(nets, lanes):
    """A search with the table and a helper-lane layout (jittered helpers
    one ply deeper, the required-lane stop, the depth-preferred
    generation store): the card equals the CPU field for field, and the
    two tables are equal."""
    b, _ = lanes
    B, n = 16, 4
    roots = tb.Board(*[t[[i % n for i in range(B)]] for t in b])
    kw = dict(order_jitter=np.asarray([0] * n + list(range(1, B - n + 1)), np.int32),
              group=np.asarray([i % n for i in range(B)], np.int32),
              required=np.arange(B) < n, prefer_deep_store=True, tt_gen=2, segment_steps=128)
    depth = np.asarray([2] * n + [2 + i % 2 for i in range(B - n)], np.int32)
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = search_batch_resumable(nets["int8"].to(dev), roots.to(dev), depth, 100_000,
                                           max_ply=6, tt=tt.make_table(14, device=dev),
                                           device=dev, **kw)
    card, cpu = outs["cuda"], outs["cpu"]
    for k in ("score", "move", "nodes", "pv", "pv_len", "done"):
        assert (card[k] == cpu[k]).all(), k
    assert card["steps"] == cpu["steps"]
    assert torch.equal(card["tt"].cpu(), cpu["tt"])
    assert (cpu["tt"][:, 1] != 0).any()
