"""The HalfKAv2_hm feature transform's fixtures and their CPU checks: the
Stockfish net's full eval (K13's plain version) and the king-bucketed
accumulators (K17's plain version) against the JAX package, on the CPU.

The fixtures are shared with chip_smoke.py and tests/test_torch_card.py,
which hold the kernels to the plain versions on the card, so this module
imports no JAX at its top (the reference is imported inside the tests):

- sf_eval_boards: boards of every piece count from 2 to 32 (every output
  bucket) with each side's king on every square (every mirrored king
  bucket of both perspectives), both sides to move;
- SF_EVAL_WIDTHS: a Stockfish net of L1 128, one of L1 200 (L1/2 = 100
  columns: one unit slice of 128 partly used) and one of L1 130 (L1/2 =
  65: no 16-byte loads, a column a thread), seeded by sf_eval_net;
- KB_REFRESH_CASES: K17's widths: L1 64, a tp shard's 32-column block of
  an L1 64 net, odd 33, 1040, and an L1 64 view one float into its
  buffer (no 16-byte loads).

The full eval agrees with the JAX evaluate_sf within F32_EVAL_TOL (the
two sum the layer stack in different orders); the accumulators equal the
JAX accumulators bit for bit (sum_rows' order is XLA:CPU's), and a tp
shard's block equals the full net's columns."""
import numpy as np
import pytest
import torch

from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.models import nnue_import as ti

SF_EVAL_WIDTHS = (128, 200, 130)
SF_EVAL_SEED = 11

# (label, batch, L1, view): "net" the net's own contiguous ft_w and ft_b;
# "tp" column block 1 of 2 of an L1 2 x L1 net, in one flat buffer as
# parallel/mesh.py shard_params_tp lays a tp position out; "offset" ft_w
# and ft_b one float into their buffer
KB_REFRESH_CASES = (
    ("L1 64", 512, 64, "net"),
    ("a tp shard's 32 columns", 512, 32, "tp"),
    ("odd L1 33", 64, 33, "net"),
    ("L1 1040", 64, 1040, "net"),
    ("L1 64 one float into its buffer", 64, 64, "offset"),
)

_PIECES = np.array([1, 2, 3, 4, 5, 7, 8, 9, 10, 11], np.int32)  # every code but the kings


def sf_eval_boards(n: int = 128, seed: int = SF_EVAL_SEED):
    """n boards (numpy (n, 64) int32 codes, (n,) int32 side to move):
    board i has 2 + i % 31 pieces, the white king on square i % 64 and the
    black king on (29 i + 7) % 64 (never the same square; both run over
    all 64 squares every 64 boards), the other pieces of random kinds on
    random squares, side to move (i // 64) % 2."""
    rng = np.random.default_rng(seed)
    boards = np.zeros((n, 64), np.int32)
    for i in range(n):
        wk, bk = i % 64, (29 * i + 7) % 64
        boards[i, wk], boards[i, bk] = 6, 12
        free = np.setdiff1d(np.arange(64), [wk, bk])
        squares = rng.choice(free, size=i % 31, replace=False)
        boards[i, squares] = rng.choice(_PIECES, size=squares.size)
    stm = ((np.arange(n) // 64) % 2).astype(np.int32)
    return boards, stm


def sf_eval_net(l1: int, seed: int = SF_EVAL_SEED) -> dict:
    """A seeded Stockfish net of width l1 as float32 numpy arrays under
    the StockfishNet field names: quantized values (chip_smoke.sf_case's
    spreads) dequantized by models/nnue_import.py load_nnue's scales, so
    that accumulators spread over the clipped range."""
    rng = np.random.default_rng(seed + l1)
    nf, qa, qb = ti.NUM_FEATURES, ti.QA, ti.QB
    out_scale = ti.NNUE2SCORE * ti.OUTPUT_SCALE

    def normal(std, shape, lim):
        return np.clip(np.round(rng.normal(0.0, std, shape)), -lim, lim)

    q = {
        "ft_b": rng.integers(-20, 140, l1) / qa,
        "ft_w": normal(12.0, (nf, l1), 127) / qa,
        "psqt_w": normal(500.0, (nf, 8), 2**20) / out_scale,
        "fc0_b": normal(2000.0, (8, ti.FC0_OUT), 2**20) / (qa * qb),
        "fc0_w": normal(max(1.0, 400.0 / l1 ** 0.5), (8, ti.FC0_OUT, l1), 127) / qb,
        "fc1_b": normal(2000.0, (8, ti.FC1_OUT), 2**20) / (qa * qb),
        "fc1_w": normal(20.0, (8, ti.FC1_OUT, ti.FC1_IN), 127) / qb,
        "fc2_b": normal(2000.0, (8, 1), 2**20) / out_scale,
        "fc2_w": normal(30.0, (8, 1, ti.FC1_OUT), 127) / (out_scale / qa),
    }
    return {k: v.astype(np.float32) for k, v in q.items()}


def kb_refresh_case(case, device="cpu"):
    """One KB_REFRESH_CASES entry → (boards (B, 64) int32, ft_w, ft_b) on
    device, ft_w (NUM_FEATURES, L1) and ft_b (L1,) contiguous views laid
    out as the case says, and the full net's ft_w, ft_b and the columns
    the views hold (a slice)."""
    label, batch, l1, view = case
    rng = np.random.default_rng(batch + l1)
    full_l1 = 2 * l1 if view == "tp" else l1
    ft_w = (rng.standard_normal((tn.NUM_FEATURES, full_l1), dtype=np.float32)
            * np.float32(0.02))
    ft_b = (rng.standard_normal(full_l1, dtype=np.float32) * np.float32(0.5))
    cols = slice(l1, 2 * l1) if view == "tp" else slice(0, l1)
    w_np, b_np = np.ascontiguousarray(ft_w[:, cols]), np.ascontiguousarray(ft_b[cols])
    lead = 1 if view == "offset" else 0
    flat = torch.from_numpy(np.concatenate(
        [np.zeros(lead, np.float32), w_np.reshape(-1), b_np])).to(device)
    w = flat[lead:lead + w_np.size].view(w_np.shape)
    b = flat[lead + w_np.size:]
    boards = torch.from_numpy(sf_eval_boards(batch, seed=batch)[0]).to(device)
    full = (torch.from_numpy(ft_w).to(device), torch.from_numpy(ft_b).to(device))
    return boards, w, b, full, cols


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fixtures_cover_every_bucket_and_king_square():
    boards, stm = sf_eval_boards()
    b = torch.from_numpy(boards)
    assert set(tn.output_bucket(b).tolist()) == set(range(8))
    assert set((b > 0).sum(1).tolist()) == set(range(2, 33))
    for p in (0, 1):
        ksq = tn.king_square(b, p).numpy()
        assert set(ksq[stm == 0].tolist()) == set(ksq[stm == 1].tolist()) == set(range(64))
    assert set(stm.tolist()) == {0, 1}
    for case in KB_REFRESH_CASES:
        _, w, bias, _, _ = kb_refresh_case(case)
        assert w.is_contiguous() and bias.is_contiguous() and w.shape[1] == case[2]
        # K17's 16-byte loads: L1 a multiple of 4, both views 16-byte aligned
        vec = case[2] % 4 == 0 and w.data_ptr() % 16 == 0 and bias.data_ptr() % 16 == 0
        assert vec == (case[3] != "offset" and case[2] % 4 == 0), case[0]


@pytest.mark.parametrize("l1", SF_EVAL_WIDTHS)
def test_evaluate_sf_plain_matches_reference(l1):
    """K13's plain version against the JAX evaluate_sf on every bucket,
    king square and side to move, within F32_EVAL_TOL."""
    import jax

    from fishnet_tpu.models import nnue_import as ji

    arrays = sf_eval_net(l1)
    boards, stm = sf_eval_boards()
    want = np.asarray(jax.jit(jax.vmap(ji.evaluate_sf, in_axes=(None, 0, 0)))(
        ji.StockfishNet(**arrays).as_device(), boards, stm))
    net = ti.stockfish_net_from_numpy(arrays, "cpu")
    got = ti.evaluate_sf(net, torch.from_numpy(boards), torch.from_numpy(stm)).numpy()
    assert got.dtype == np.float32 and got.shape == (len(boards),)
    assert np.abs(got - want).max() <= tn.F32_EVAL_TOL, np.abs(got - want).max()
    assert np.abs(want).max() > 100 and np.unique(want).size > len(want) // 2


@pytest.mark.parametrize("case", KB_REFRESH_CASES, ids=[c[0] for c in KB_REFRESH_CASES])
def test_kb_accumulators_match_reference_bit_for_bit(case):
    """The port's king-bucketed accumulators (K17's plain version, through
    its wrapper) equal the JAX accumulators bit for bit on each width and
    view; a tp block equals the full net's columns."""
    import jax

    from fishnet_tpu.models import nnue as jn

    boards, w, b, (full_w, full_b), cols = kb_refresh_case(case)
    params = tn.NnueParams(w, b, *[torch.zeros(1)] * 6)
    got = tn.accumulators_kb(params, boards).numpy()
    stub = [np.zeros(1, np.float32)] * 6
    jp = jn.NnueParams(w.numpy(), b.numpy(), *stub)
    want = np.asarray(jax.jit(jax.vmap(jn.accumulators, in_axes=(None, 0)))(jp, boards.numpy()))
    assert got.shape == (case[1], 2, case[2]) and got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    whole = tn.accumulators(tn.NnueParams(full_w, full_b, *[torch.zeros(1)] * 6), boards)
    assert torch.equal(torch.from_numpy(got), whole[:, :, cols])
