"""fishnet_tpu_torch's NNUE functions against the JAX package's, on the
CPU: the plain versions of the kernels K1 (accumulators_768), K2
(forward_from_acc) and K3 (apply_acc_updates_768), and evaluate.

Tolerances: every accumulator (K1, K3) is bit-identical on f32 and on
the int8 net (the port adds the rows in XLA:CPU's order); the f32 eval
(K2, evaluate) agrees within nnue.F32_EVAL_TOL centipawns — its layer
stack sums in another order than XLA's dot — and the int8 eval exactly.
"""
import hashlib
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fishnet_tpu.assets import default_weights_path
from fishnet_tpu.chess import Position as JaxPosition
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.ops import board as jb
from fishnet_tpu_torch import kernels
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


B = 64


def _numpy(params):
    return {f: np.asarray(getattr(params, f)) for f in jn.NnueParams._fields}


@pytest.fixture(scope="module", params=["shipped-f32", "shipped-int8", "random-l1-32"])
def nets(request):
    """(JAX params, port params) of one net."""
    if request.param == "random-l1-32":
        jp = jn.init_params(jax.random.PRNGKey(3), l1=32, h1=8, h2=8, feature_set="board768")
    else:
        jp = jn.load_params(default_weights_path("board768"))
        if request.param == "shipped-int8":
            jp = jn.quantize_int8(jp)
    return jp, tn.params_from_numpy(_numpy(jp), "cpu")


@pytest.fixture(scope="module")
def positions():
    """B playout positions (JAX Boards) and one random legal move each,
    drawn from lines with castling, en passant and promotions."""
    rng = random.Random(2)
    starts = [
        JaxPosition.initial(),
        JaxPosition.from_fen("r3k2r/p1ppqpb1/bn2pnp1/3PN3/1p2P3/2N2Q1p/PPPBBPPP/R3K2R w KQkq - 0 1"),
        JaxPosition.from_fen("r3k2r/Pppp1ppp/1b3nbN/nP6/BBP1P3/q4N2/Pp1P2PP/R2Q1RK1 w kq - 0 1"),
        JaxPosition.from_fen("8/2p5/3p4/KP5r/1R3p1k/8/4P1P1/8 w - - 0 1"),
    ]
    boards, moves = [], []
    while len(boards) < B:
        pos = starts[len(boards) % len(starts)]
        for _ in range(rng.randrange(0, 30)):
            legal = pos.legal_moves()
            if not legal:
                break
            pos = pos.push(rng.choice(legal))
        legal = pos.legal_moves()
        if not legal:
            continue
        boards.append(jb.from_position(pos))
        # prefer castles, captures and promotions when there are any
        special = [m for m in legal if pos.is_castling_move(m) or m.promotion is not None
                   or pos.piece_at(m.to_sq) is not None]
        m = rng.choice(special or legal)
        moves.append(m.from_sq | (m.to_sq << 6) | ((m.promotion or 0) << 12))
    return jb.stack_boards(boards), np.asarray(moves, np.int32)


def test_shipped_copy_is_byte_identical():
    def sha(p):
        return hashlib.sha256(Path(p).read_bytes()).hexdigest()

    assert sha(tn.ASSET) == sha(default_weights_path("board768"))


def test_load_params_and_round_trip():
    jp = jn.load_params(default_weights_path("board768"))
    tp = tn.load_params(device="cpu")
    for f in jn.NnueParams._fields:
        assert np.array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f))), f
    for src in (jp, jn.quantize_int8(jp)):
        back = tn.params_from_numpy(_numpy(src), "cpu")
        for f in jn.NnueParams._fields:
            a = np.asarray(getattr(src, f))
            assert getattr(back, f).numpy().dtype == a.dtype, f
            assert np.array_equal(getattr(back, f).numpy(), a), f


def test_quantize_int8_matches_reference():
    jp = jn.load_params(default_weights_path("board768"))
    want = jn.quantize_int8(jp)
    got = tn.quantize_int8(tn.params_from_numpy(_numpy(jp), "cpu"))
    assert tn.is_int8(got) and got.ft_w.dtype == torch.int16
    for f in jn.NnueParams._fields:
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f


def _acc(nets, positions):
    jp, _ = nets
    boards, _ = positions
    return np.array(jax.jit(jax.vmap(jn.accumulators_768, in_axes=(None, 0)))(jp, boards.board))


def test_k1_refresh_bit_identical(nets, positions):
    _, tp = nets
    boards, _ = positions
    before = dict(kernels.LAUNCHES)
    got = tn.accumulators_768(tp, torch.from_numpy(np.array(boards.board)))
    assert kernels.LAUNCHES == before  # CPU tensors take the plain version
    assert got.dtype == tn.acc_dtype(tp)
    assert np.array_equal(got.numpy(), _acc(nets, positions))


def test_k2_forward_from_acc(nets, positions):
    jp, tp = nets
    boards, _ = positions
    acc = _acc(nets, positions)
    stm = np.array(boards.stm)
    bucket = np.array(jax.vmap(jn.output_bucket)(boards.board))
    assert np.array_equal(
        tn.output_bucket(torch.from_numpy(np.array(boards.board))).numpy(), bucket)
    want = np.asarray(jax.jit(jax.vmap(jn.forward_from_acc, in_axes=(None, 0, 0, 0)))(
        jp, acc, stm, bucket))
    got = tn.forward_from_acc(
        tp, torch.from_numpy(acc), torch.from_numpy(stm), torch.from_numpy(bucket)).numpy()
    assert got.dtype == np.float32
    if tn.is_int8(tp):
        assert np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= tn.F32_EVAL_TOL


def test_k3_acc_update_bit_identical(nets, positions):
    jp, tp = nets
    boards, moves = positions
    acc = _acc(nets, positions)
    codes, sqs, signs = (np.array(x) for x in jax.vmap(jb.move_piece_changes)(boards, moves))
    want = np.asarray(jax.jit(jax.vmap(jn.apply_acc_updates_768, in_axes=(None, 0, 0, 0, 0)))(
        jp, acc, codes, sqs, signs))
    got = tn.apply_acc_updates_768(
        tp, torch.from_numpy(acc), torch.from_numpy(codes), torch.from_numpy(sqs),
        torch.from_numpy(signs))
    assert np.array_equal(got.numpy(), want)
    # the update lands on the child's refreshed accumulators
    child = jax.vmap(jb.make_move)(boards, moves)
    refreshed = tn.accumulators_768(tp, torch.from_numpy(np.array(child.board)))
    if tn.is_int8(tp):
        assert torch.equal(got, refreshed)
    else:
        assert float((got - refreshed).abs().max()) < 1e-4


def test_null_and_cancelling_updates_are_exact_no_ops(nets):
    """Zeroed slots (a null move) and a +1/-1 pair on one feature (a
    chess960 castle onto its own square) leave the accumulator as is."""
    _, tp = nets
    rng = np.random.default_rng(5)
    acc = torch.from_numpy(rng.normal(0.3, 0.5, (4, 2, tp.l1)).astype(np.float32))
    if tn.is_int8(tp):
        acc = (acc * 127).round().to(torch.int32)
    codes = torch.tensor([[0, 0, 0, 0], [6, 0, 6, 0], [6, 4, 6, 4], [0, 0, 0, 0]], dtype=torch.int32)
    sqs = torch.tensor([[0, 0, 0, 0], [6, 0, 6, 5], [6, 5, 6, 5], [9, 9, 9, 9]], dtype=torch.int32)
    signs = torch.tensor([[-1, -1, 1, 1]] * 3 + [[0, 0, 0, 0]], dtype=torch.int32)
    assert torch.equal(tn.apply_acc_updates_768(tp, acc, codes, sqs, signs), acc)


def test_evaluate(nets, positions):
    jp, tp = nets
    boards, _ = positions
    want = np.asarray(jax.jit(jax.vmap(jn.evaluate, in_axes=(None, 0, 0)))(
        jp, boards.board, boards.stm))
    got = tn.evaluate(tp, torch.from_numpy(np.array(boards.board)),
                      torch.from_numpy(np.array(boards.stm))).numpy()
    if tn.is_int8(tp):
        assert np.array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= tn.F32_EVAL_TOL
        ref = [jn.evaluate_reference(jp, np.asarray(boards.board[i]), int(boards.stm[i]))
               for i in range(0, B, 8)]
        assert np.abs(got[::8] - np.asarray(ref)).max() < 0.5


def test_kernel_wrappers_refuse_cpu_tensors(nets, positions):
    _, tp = nets
    boards, _ = positions
    with pytest.raises(ValueError):
        kernels.nnue_refresh_768(torch.from_numpy(np.array(boards.board)), tp.ft_w, tp.ft_b)
