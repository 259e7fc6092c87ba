"""The NNUE nets in PyTorch: parameters, accumulators, forward.

Two feature sets, as in the JAX package (fishnet_tpu/models/nnue.py):

- board768, its fast-path set: 12 piece kinds x 64 squares per
  perspective. Every update of its accumulators is incremental (<= 4
  changed features a move), which is what lets the lockstep search carry
  them down its stack.
- HalfKAv2_hm ("king-bucketed"): 32 horizontally mirrored king buckets x
  11 piece kinds x 64 squares = 22,528 features per perspective. A king
  move changes every feature, so the search evaluates such a net with a
  full refresh at every leaf (`evaluate`), and so does it an imported
  Stockfish net (models/nnue_import.py).

Both share the feature transform of width L1 (both perspectives), and 8
output buckets (chosen by piece count) of a 2*L1 → H1 → H2 → 1 stack.

The device functions the search calls are hand-written CUDA kernels
(csrc/, bound by kernels.py), each beside a plain PyTorch version of the
same function: `accumulators_768` (K1), `forward_from_acc` (K2),
`apply_acc_updates_768` (K3), and the king-bucketed net's full eval
(K12, `evaluate` → `evaluate_plain`). A wrapper runs the plain version for
CPU tensors and the kernel for CUDA tensors.

bf16 (`cast_params`, FISHNET_TPU_DTYPE=bf16) is a storage format, as in
the reference: every weight is rounded to bf16 once, and all arithmetic
stays f32 (the accumulators too). The plain versions widen the weights
they read (exactly) and run the f32 code; the kernels read bf16 and widen
each weight in registers, so on bf16 weights every function gives the f32
function's bits on the widened weights.

Float order: the plain versions add feature rows in the order the JAX
reference's XLA:CPU reductions do (measured bit-exact on the CPU), and
the kernels follow the same order, so K1/K3 and K12's accumulators agree
bit for bit on f32 as well as on the int8 net. The f32 layer stack (K2,
K12) sums in another order than XLA's dot: evals agree within
F32_EVAL_TOL centipawns. On the int8-quantized net (`quantize_int8`)
every add and every layer is exact integer arithmetic, so evals are
equal bit for bit.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping, NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .. import kernels

NUM_KING_BUCKETS = 32
NUM_PIECE_KINDS = 11  # our P N B R Q, their P N B R Q, kings (shared plane)
NUM_SQUARES = 64
NUM_FEATURES = NUM_KING_BUCKETS * NUM_PIECE_KINDS * NUM_SQUARES  # 22528
NUM_FEATURES_768 = 12 * 64
NUM_OUTPUT_BUCKETS = 8
OUTPUT_SCALE = 600.0  # network output [-1,1]-ish → centipawns

# int8 fixed-point ladder (Stockfish-style): activations in [0, QA],
# weights in 1/QW steps, >> QW_SHIFT between layers
QA = 127
QW = 64
QW_SHIFT = 6

# stated tolerance of an f32 eval against another summation order of the
# same net (centipawns): the layer stack's sums differ in their last bits
F32_EVAL_TOL = 1e-2

# king bucket of a (mirrored) king square: files a-d x 8 ranks, -1 on e-h
KING_BUCKET = np.full(64, -1, dtype=np.int32)
for _sq in range(64):
    if _sq & 7 < 4:
        KING_BUCKET[_sq] = (_sq >> 3) * 4 + (_sq & 7)

ASSET = Path(__file__).resolve().parent.parent / "assets" / "nnue-board768-64.npz"


class NnueParams(NamedTuple):
    ft_w: torch.Tensor  # (768 or NUM_FEATURES, L1) f32 or bf16, or int16 for the int8 net
    ft_b: torch.Tensor  # (L1,) f32 / bf16 / int32
    l1_w: torch.Tensor  # (8, 2*L1, H1) f32 / bf16 / int8
    l1_b: torch.Tensor  # (8, H1) f32 / bf16 / int32
    l2_w: torch.Tensor  # (8, H1, H2) f32 / bf16 / int8
    l2_b: torch.Tensor  # (8, H2) f32 / bf16 / int32
    out_w: torch.Tensor  # (8, H2) f32 / bf16 / int8
    out_b: torch.Tensor  # (8,) f32 / bf16 / int32

    @property
    def l1(self) -> int:
        return self.ft_w.shape[1]

    @property
    def device(self) -> torch.device:
        return self.ft_w.device

    def to(self, device) -> "NnueParams":
        return NnueParams(*[t.to(device) for t in self])


def _from_numpy(a) -> torch.Tensor:
    """A tensor of a numpy array's values; a bfloat16 array (ml_dtypes',
    as JAX hands them out: numpy has no bf16 of its own) crosses as its
    16-bit patterns, so this module needs no ml_dtypes."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(mapping: Mapping[str, np.ndarray], device=None) -> NnueParams:
    """NnueParams from numpy arrays under the JAX package's NnueParams
    field names (f32, bfloat16 and the int8 net's integer dtypes are
    kept): a board768 net (768 features) or a king-bucketed one
    (NUM_FEATURES)."""
    dev = device_mod.resolve(device)
    params = NnueParams(**{f: _from_numpy(mapping[f]).to(dev) for f in NnueParams._fields})
    if params.ft_w.shape[0] not in (NUM_FEATURES_768, NUM_FEATURES):
        raise ValueError(
            f"a net has {NUM_FEATURES_768} (board768) or {NUM_FEATURES} (HalfKAv2_hm) "
            f"features, got {params.ft_w.shape[0]}"
        )
    return params


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array; bf16 goes through its 16-bit
    patterns into numpy's "bfloat16" dtype, which exists once JAX's
    ml_dtypes has registered it (numpy alone raises TypeError)."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))


def params_to_numpy(params: NnueParams) -> dict:
    """{field: numpy array}: the reverse of params_from_numpy, so weights go
    across to the JAX package (its NnueParams(**mapping))."""
    return {f: _to_numpy(getattr(params, f)) for f in NnueParams._fields}


def init_params(generator: torch.Generator, l1: int = 256, h1: int = 16, h2: int = 32,
                dtype=torch.float32, feature_set: str = "halfkav2_hm",
                device=None) -> NnueParams:
    """A fresh net of the JAX package's init_params: the same shapes,
    distributions and defaults (ft_w ~N(0, 0.02), ft_b 0.5, each layer's
    weights ~N(0, 1/sqrt(fan-in)), zero biases). The numbers come from
    `generator`, drawn on its device, then moved to `device` — they differ
    from jax.random's, so a test that needs the same net in both packages
    builds it in one and carries it across (params_from_numpy)."""
    num_features = {"halfkav2_hm": NUM_FEATURES, "board768": NUM_FEATURES_768}[feature_set]
    dev = device_mod.resolve(device)

    def normal(*shape, scale):
        return torch.randn(shape, generator=generator, device=generator.device) * scale

    params = NnueParams(
        ft_w=normal(num_features, l1, scale=0.02),
        ft_b=torch.full((l1,), 0.5),
        l1_w=normal(NUM_OUTPUT_BUCKETS, 2 * l1, h1, scale=1.0 / np.sqrt(2 * l1)),
        l1_b=torch.zeros((NUM_OUTPUT_BUCKETS, h1)),
        l2_w=normal(NUM_OUTPUT_BUCKETS, h1, h2, scale=1.0 / np.sqrt(h1)),
        l2_b=torch.zeros((NUM_OUTPUT_BUCKETS, h2)),
        out_w=normal(NUM_OUTPUT_BUCKETS, h2, scale=1.0 / np.sqrt(h2)),
        out_b=torch.zeros((NUM_OUTPUT_BUCKETS,)),
    )
    return NnueParams(*[t.to(device=dev, dtype=dtype) for t in params])


def save_params(params: NnueParams, path) -> None:
    """Write a net in the JAX package's .npz layout (format
    fishnet-tpu-nnue-v1, its __meta__ included), which both packages'
    load_params read."""
    meta = {
        "format": "fishnet-tpu-nnue-v1",
        "feature_set": (
            "board768" if params.ft_w.shape[0] == NUM_FEATURES_768 else "HalfKAv2_hm"
        ),
        "l1": int(params.ft_w.shape[1]),
        "h1": int(params.l1_w.shape[2]),
        "h2": int(params.l2_w.shape[2]),
        "output_buckets": NUM_OUTPUT_BUCKETS,
        "output_scale": OUTPUT_SCALE,
    }
    np.savez_compressed(Path(path), __meta__=json.dumps(meta), **params_to_numpy(params))


def load_params(path=ASSET, device=None) -> NnueParams:
    """Read a net saved in the JAX package's .npz layout (format
    fishnet-tpu-nnue-v1); the default is the shipped board768 net."""
    with np.load(Path(path), allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta.get("format") != "fishnet-tpu-nnue-v1":
            raise ValueError(f"unknown nnue format: {meta.get('format')!r}")
        return params_from_numpy({f: z[f] for f in NnueParams._fields}, device)


def quantize_int8(params: NnueParams) -> NnueParams:
    """f32 weights → the int fixed-point net (same rounding as the JAX
    package): ft_w int16 and ft_b int32 at scale QA, hidden/output
    weights int8 at scale QW, biases int32 at scale QA*QW."""
    f = {k: v.detach().cpu().numpy().astype(np.float64)
         for k, v in params._asdict().items()}

    def w8(a):
        return np.clip(np.round(a * QW), -127, 127).astype(np.int8)

    return params_from_numpy({
        "ft_w": np.round(f["ft_w"] * QA).astype(np.int16),
        "ft_b": np.round(f["ft_b"] * QA).astype(np.int32),
        "l1_w": w8(f["l1_w"]),
        "l1_b": np.round(f["l1_b"] * QA * QW).astype(np.int32),
        "l2_w": w8(f["l2_w"]),
        "l2_b": np.round(f["l2_b"] * QA * QW).astype(np.int32),
        "out_w": w8(f["out_w"]),
        "out_b": np.round(f["out_b"] * QA * QW).astype(np.int32),
    }, params.device)


def cast_params(params: NnueParams) -> NnueParams:
    """Every field of a board768 or king-bucketed net stored as bf16
    (round to nearest even, as the reference's astype): a storage format
    — the accumulators stay f32 (acc_dtype) and every function computes
    in f32 on the widened weights. An imported Stockfish net raises
    TypeError, as the reference's cast_params does (it cannot iterate
    that net)."""
    if not isinstance(params, NnueParams):
        raise TypeError(f"cast_params takes an NnueParams net, got {type(params).__name__}")
    return NnueParams(*[t.to(torch.bfloat16) for t in params])


# the layer stack's fields: what forward_from_acc reads of a net
HEAD_FIELDS = ("l1_w", "l1_b", "l2_w", "l2_b", "out_w", "out_b")


def widened(params: NnueParams) -> NnueParams:
    """A bf16 net's weights widened to f32 (exactly); any other net as it
    is. Every function gives on a bf16 net the bits it gives on this."""
    if params.ft_w.dtype != torch.bfloat16:
        return params
    return NnueParams(*[t.float() for t in params])


def is_int8(params) -> bool:
    """An int8-quantized NnueParams (an imported Stockfish net is f32)."""
    return isinstance(params, NnueParams) and not params.ft_w.dtype.is_floating_point


# the net kinds (net_kind)
BOARD768 = "board768"
KING = "king"
STOCKFISH = "stockfish"


def net_kind(params) -> str:
    """BOARD768 or KING (an NnueParams of 768 or NUM_FEATURES rows), or
    STOCKFISH (an imported models/nnue_import.StockfishNet): what decides
    how a leaf is evaluated and which K11 instantiation runs."""
    if isinstance(params, NnueParams):
        return BOARD768 if params.ft_w.shape[0] == NUM_FEATURES_768 else KING
    from .nnue_import import StockfishNet

    if isinstance(params, StockfishNet):
        return STOCKFISH
    raise TypeError(f"not a net: {type(params).__name__}")


def is_board768(params) -> bool:
    """A board768 NnueParams: the net whose accumulators the search
    carries down its stack; every other net takes a full eval per leaf."""
    return net_kind(params) == BOARD768


def acc_dtype(params) -> torch.dtype:
    """Accumulator dtype: int32 for the int8 net (exact adds), else f32
    (bf16 weights too)."""
    return torch.int32 if is_int8(params) else torch.float32


def feature_index_768(code: torch.Tensor, sq: torch.Tensor,
                      perspective: int) -> torch.Tensor:
    """board768 feature row per piece; -1 where code == 0 (empty)."""
    pt = (code - 1) % 6
    kind = torch.where((code <= 6) == (perspective == 0), pt, 6 + pt)
    idx = kind * 64 + (sq ^ (56 if perspective == 1 else 0))
    return torch.where(code > 0, idx, -1)


def output_bucket(board: torch.Tensor) -> torch.Tensor:
    """(B, 64) → (B,) int32 layer-stack bucket from the piece count."""
    count = (board > 0).sum(1, dtype=torch.int32)
    return ((count - 1) // 4).clamp(0, NUM_OUTPUT_BUCKETS - 1)


def king_square(board: torch.Tensor, perspective: int) -> torch.Tensor:
    """(B,) square of `perspective`'s king (its first, as argmax), 0 where
    it has none (the reference's max(king_square, 0))."""
    mask = board == (6 + 6 * perspective)
    return torch.where(mask.any(1), mask.to(torch.uint8).argmax(1).to(torch.int32), 0)


def feature_indices(board: torch.Tensor, perspective: int,
                    ksq: torch.Tensor) -> torch.Tensor:
    """(B, 64) HalfKAv2_hm feature row per square for one perspective, -1
    where empty; ksq (B,) that perspective's king square. Black's view
    flips ranks, then files are mirrored so the king lands on files a-d."""
    flip = 56 if perspective == 1 else 0
    sq = torch.arange(64, dtype=torch.int32, device=board.device)
    o_ksq = ksq.to(torch.int32) ^ flip
    mirror = torch.where((o_ksq & 7) > 3, 7, 0).to(torch.int32)
    o_sq = (sq[None] ^ flip) ^ mirror[:, None]
    bucket = torch.as_tensor(KING_BUCKET, device=board.device)[(o_ksq ^ mirror).long()]
    pt = (board - 1) % 6
    own = (board <= 6) == (perspective == 0)
    kind = torch.where(pt == 5, 10, torch.where(own, pt, 5 + pt))
    idx = bucket[:, None] * (NUM_PIECE_KINDS * NUM_SQUARES) + kind * NUM_SQUARES + o_sq
    return torch.where(board > 0, idx, -1)


def sum_rows(table: torch.Tensor, idx: torch.Tensor, dtype) -> torch.Tensor:
    """table (F, W), idx (B, 64) rows or -1 → (B, W) in `dtype`: the rows
    summed in XLA:CPU's order for the reference's 64-row reductions
    (squares 0-31 and 32-63 each summed in order, the halves added)."""
    rows = table[idx.clamp(min=0).long()].to(dtype)  # (B, 64, W)
    rows = torch.where((idx >= 0)[..., None], rows, torch.zeros((), dtype=dtype, device=rows.device))
    half = []
    for h in (0, 1):
        s = torch.zeros_like(rows[:, 0])
        for i in range(h * 32, h * 32 + 32):
            s = s + rows[:, i]
        half.append(s)
    return half[0] + half[1]


# ------------------------------------------------- K1: accumulator refresh


def accumulators_768_plain(params: NnueParams, boards: torch.Tensor) -> torch.Tensor:
    """(B, 64) int32 boards → (B, 2, L1) accumulators: ft_b + the sum of
    the pieces' rows (sum_rows' order; bf16 rows widened as they are
    gathered)."""
    adt = acc_dtype(params)
    sq = torch.arange(64, dtype=torch.int32, device=boards.device)
    return torch.stack([
        params.ft_b.to(adt) + sum_rows(params.ft_w, feature_index_768(boards, sq, p), adt)
        for p in (0, 1)], 1)


def accumulators_768(params: NnueParams, boards: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: plain version on the CPU, kernel on the card."""
    if boards.device.type == "cpu":
        return accumulators_768_plain(params, boards)
    return kernels.nnue_refresh_768(boards, params.ft_w, params.ft_b)


def accumulators_kb(params: NnueParams, boards: torch.Tensor) -> torch.Tensor:
    """K17 wrapper, a king-bucketed f32 net's (B, 2, L1) accumulators of
    (B, 64) boards (ft_w and ft_b may be a column block of the net): the
    plain version (`accumulators`) on the CPU, the kernel on the card."""
    if boards.device.type == "cpu":
        return accumulators(params, boards)
    return kernels.nnue_refresh_kb(boards, params.ft_w, params.ft_b)


# --------------------------------------------- K3: incremental acc update

_NONE = 1 << 20


def apply_acc_updates_768_plain(params: NnueParams, acc: torch.Tensor,
                                codes: torch.Tensor, sqs: torch.Tensor,
                                signs: torch.Tensor) -> torch.Tensor:
    """acc (B, 2, L1) + the signed rows of <= 4 piece changes per lane
    (codes/sqs/signs (B, 4); code 0 is a no-op) → new (B, 2, L1).

    Repeated features merge into one weight, as in the reference's
    weight vector; rows are added by increasing feature index, grouped
    in blocks of 32 rows (each block summed in order, block sums added in
    order), and the delta is added to acc last — XLA:CPU's order for the
    reference's 768-long contraction."""
    adt = acc_dtype(params)
    idx = torch.stack([feature_index_768(codes, sqs, p) for p in (0, 1)], 1)  # (B, 2, 4)
    same = idx[..., :, None] == idx[..., None, :]  # [b, p, i, j]
    w = (same * signs[:, None, None, :]).sum(3, dtype=torch.int32)
    earlier = torch.tril(same, diagonal=-1).any(3)
    key = torch.where((idx >= 0) & ~earlier, idx, _NONE)
    key, order = torch.sort(key, dim=2, stable=True)
    w = w.gather(2, order)
    rows = params.ft_w[key.clamp(max=NUM_FEATURES_768 - 1).long()].to(adt)
    rows = rows * w[..., None].to(adt)  # (B, 2, 4, L1)
    total = torch.zeros_like(acc)
    block = torch.zeros_like(acc)
    cur = torch.full_like(key[..., 0], -1)
    for i in range(key.shape[2]):
        active = key[..., i] < _NONE
        blk = key[..., i] >> 5
        new = active & (blk != cur)
        total = torch.where(new[..., None], total + block, total)
        block = torch.where(new[..., None], 0, block)
        cur = torch.where(new, blk, cur)
        block = torch.where(active[..., None], block + rows[..., i, :], block)
    return acc + (total + block)


def apply_acc_updates_768(params: NnueParams, acc: torch.Tensor,
                          codes: torch.Tensor, sqs: torch.Tensor,
                          signs: torch.Tensor) -> torch.Tensor:
    """K3 wrapper: plain version on the CPU, kernel on the card."""
    if acc.device.type == "cpu":
        return apply_acc_updates_768_plain(params, acc, codes, sqs, signs)
    return kernels.nnue_acc_update_768(acc, codes, sqs, signs, params.ft_w)


# ------------------------------------------------------ K2: layer stack


def forward_from_acc_plain(params: NnueParams, acc: torch.Tensor,
                           stm: torch.Tensor, bucket: torch.Tensor) -> torch.Tensor:
    """acc (B, 2, L1), stm/bucket (B,) → centipawns (B,) f32 from the
    side to move's view (a bf16 net's head widened first; ft_w is not
    read here, so it stays as it is)."""
    if params.l1_w.dtype == torch.bfloat16:
        params = params._replace(**{f: getattr(params, f).float() for f in HEAD_FIELDS})
    ar = torch.arange(acc.shape[0], device=acc.device)
    s = stm.long()
    own, opp = acc[ar, s], acc[ar, 1 - s]
    b = bucket.long()
    if is_int8(params):
        def layer(x, w, bias):
            y = (x[:, :, None] * w[b].to(torch.int32)).sum(1, dtype=torch.int32)
            return y + bias[b]

        x = torch.cat([own, opp], 1).clamp(0, QA)
        h = (layer(x, params.l1_w, params.l1_b) >> QW_SHIFT).clamp(0, QA)
        h = (layer(h, params.l2_w, params.l2_b) >> QW_SHIFT).clamp(0, QA)
        out = (h * params.out_w[b].to(torch.int32)).sum(1, dtype=torch.int32)
        scale = torch.tensor(OUTPUT_SCALE / (QA * QW), dtype=torch.float32)
        return (out + params.out_b[b]).to(torch.float32) * scale.to(acc.device)
    x = torch.cat([own.clamp(0.0, 1.0), opp.clamp(0.0, 1.0)], 1)
    h = (torch.bmm(x[:, None], params.l1_w[b])[:, 0] + params.l1_b[b]).clamp(0.0, 1.0)
    h = (torch.bmm(h[:, None], params.l2_w[b])[:, 0] + params.l2_b[b]).clamp(0.0, 1.0)
    out = (h * params.out_w[b]).sum(1) + params.out_b[b]
    return out * OUTPUT_SCALE


def forward_from_acc(params: NnueParams, acc: torch.Tensor, stm: torch.Tensor,
                     bucket: torch.Tensor) -> torch.Tensor:
    """K2 wrapper: plain version on the CPU, kernel on the card."""
    if acc.device.type == "cpu":
        return forward_from_acc_plain(params, acc, stm, bucket)
    return kernels.nnue_forward_from_acc(acc, stm, bucket, params)


# ------------------------------------- K12: king-bucketed full evaluation


def accumulators(params: NnueParams, boards: torch.Tensor) -> torch.Tensor:
    """(B, 64) boards → (B, 2, L1) HalfKAv2_hm accumulators of a
    king-bucketed net, each perspective refreshed from scratch: ft_b + the
    sum of the pieces' rows (sum_rows' order; bf16 rows widened as they
    are gathered)."""
    adt = acc_dtype(params)
    return torch.stack([
        params.ft_b.to(adt) + sum_rows(
            params.ft_w, feature_indices(boards, p, king_square(boards, p)), adt)
        for p in (0, 1)], 1)


def evaluate_plain(params: NnueParams, boards: torch.Tensor, stm: torch.Tensor) -> torch.Tensor:
    """K12's plain version: a king-bucketed net's full eval of (B, 64)
    boards, stm (B,) → (B,) f32 centipawns from the side to move's view
    (both perspectives refreshed, then the layer stack)."""
    return forward_from_acc_plain(params, accumulators(params, boards), stm,
                                  output_bucket(boards))


def evaluate(params, boards: torch.Tensor, stm: torch.Tensor) -> torch.Tensor:
    """Full evaluation of (B, 64) boards → (B,) f32, dispatched on the net
    as the reference does: an imported Stockfish net → nnue_import
    .evaluate_sf (K13); board768 → the refresh (K1) and the layer stack
    (K2); a king-bucketed net → K12 (the plain version on the CPU, the
    kernel on the card)."""
    kind = net_kind(params)
    if kind == STOCKFISH:
        from . import nnue_import

        return nnue_import.evaluate_sf(params, boards, stm)
    if kind == BOARD768:
        acc = accumulators_768(params, boards)
        return forward_from_acc(params, acc, stm, output_bucket(boards))
    if boards.device.type == "cpu":
        return evaluate_plain(params, boards, stm)
    return kernels.nnue_evaluate(boards, stm, params)
