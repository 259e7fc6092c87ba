"""The board768 NNUE net in PyTorch: parameters, accumulators, forward.

board768 is the JAX package's fast-path feature set (fishnet_tpu/models/
nnue.py): 12 piece kinds x 64 squares per perspective, a feature
transform of width L1 shared by both perspectives, and 8 output buckets
(chosen by piece count) of a 2*L1 → H1 → H2 → 1 stack. Every update of
its accumulators is incremental (<= 4 changed features a move), which is
what lets the lockstep search carry them down its stack.

The three device functions the search calls each step or each dispatch
are hand-written CUDA kernels (csrc/, bound by kernels.py), each beside a
plain PyTorch version of the same function: `accumulators_768` (K1),
`forward_from_acc` (K2) and `apply_acc_updates_768` (K3). A wrapper runs
the plain version for CPU tensors and the kernel for CUDA tensors.

Float order: the plain versions add feature rows in the order the JAX
reference's XLA:CPU reductions do (measured bit-exact on the CPU), and
the kernels follow the same order, so K1/K3 agree bit for bit on f32 as
well as on the int8 net. The f32 layer stack (K2) sums in another order
than XLA's dot: evals agree within F32_EVAL_TOL centipawns. On the
int8-quantized net (`quantize_int8`) every add and every layer is exact
integer arithmetic, so evals are equal bit for bit.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping, NamedTuple

import numpy as np
import torch

from .. import device as device_mod
from .. import kernels

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

ASSET = Path(__file__).resolve().parent.parent / "assets" / "nnue-board768-64.npz"


class NnueParams(NamedTuple):
    ft_w: torch.Tensor  # (768, L1) f32, or int16 for the int8 net
    ft_b: torch.Tensor  # (L1,) f32 / int32
    l1_w: torch.Tensor  # (8, 2*L1, H1) f32 / int8
    l1_b: torch.Tensor  # (8, H1) f32 / int32
    l2_w: torch.Tensor  # (8, H1, H2) f32 / int8
    l2_b: torch.Tensor  # (8, H2) f32 / int32
    out_w: torch.Tensor  # (8, H2) f32 / int8
    out_b: torch.Tensor  # (8,) f32 / int32

    @property
    def l1(self) -> int:
        return self.ft_w.shape[1]

    @property
    def device(self) -> torch.device:
        return self.ft_w.device

    def to(self, device) -> "NnueParams":
        return NnueParams(*[t.to(device) for t in self])


def params_from_numpy(mapping: Mapping[str, np.ndarray], device=None) -> NnueParams:
    """NnueParams from numpy arrays under the JAX package's NnueParams
    field names (f32 and the int8 net's integer dtypes are kept)."""
    dev = device_mod.resolve(device)
    params = NnueParams(**{
        f: torch.from_numpy(np.array(mapping[f])).to(dev)
        for f in NnueParams._fields
    })
    if params.ft_w.shape[0] != NUM_FEATURES_768:
        raise ValueError(
            f"only board768 nets are supported, got {params.ft_w.shape[0]} features"
        )
    return params


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


def is_int8(params: NnueParams) -> bool:
    return not params.ft_w.dtype.is_floating_point


def acc_dtype(params: NnueParams) -> torch.dtype:
    """Accumulator dtype: int32 for the int8 net (exact adds), else f32."""
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


# ------------------------------------------------- K1: accumulator refresh


def accumulators_768_plain(params: NnueParams, boards: torch.Tensor) -> torch.Tensor:
    """(B, 64) int32 boards → (B, 2, L1) accumulators: ft_b + the sum of
    the pieces' rows, squares 0-31 and 32-63 each summed in order and the
    two halves added (XLA:CPU's order for the reference's reduction)."""
    adt = acc_dtype(params)
    sq = torch.arange(64, dtype=torch.int32, device=boards.device)
    out = []
    for persp in (0, 1):
        idx = feature_index_768(boards, sq, persp)
        rows = params.ft_w[idx.clamp(min=0).long()].to(adt)  # (B, 64, L1)
        rows = torch.where((idx >= 0)[..., None], rows, torch.zeros((), dtype=adt, device=rows.device))
        half = []
        for h in (0, 1):
            s = torch.zeros_like(rows[:, 0])
            for i in range(h * 32, h * 32 + 32):
                s = s + rows[:, i]
            half.append(s)
        out.append(params.ft_b + (half[0] + half[1]))
    return torch.stack(out, 1)


def accumulators_768(params: NnueParams, boards: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: plain version on the CPU, kernel on the card."""
    if boards.device.type == "cpu":
        return accumulators_768_plain(params, boards)
    return kernels.nnue_refresh_768(boards, params.ft_w, params.ft_b)


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
    side to move's view."""
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


def evaluate(params: NnueParams, boards: torch.Tensor, stm: torch.Tensor) -> torch.Tensor:
    """Full evaluation (refresh + forward) of (B, 64) boards → (B,) f32."""
    acc = accumulators_768(params, boards)
    return forward_from_acc(params, acc, stm, output_bucket(boards))
