"""fishnet_tpu_torch's CUDA kernels on the card: each against its plain
PyTorch version, the wrappers' checks and launch counts, and the int8
search on the card against the CPU. Needs an NVIDIA card; skipped
elsewhere. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_card.py -q -p no:cacheprovider
"""
import random

import pytest
import torch

from fishnet_tpu_torch import kernels
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.models import nnue
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import tt
from fishnet_tpu_torch.ops.search import search_batch

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
