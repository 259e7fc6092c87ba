"""NNUE training in PyTorch: supervised regression of a board768 or
king-bucketed (HalfKAv2_hm) net on (position, score) pairs, the JAX
package's fishnet_tpu/models/train.py.

The step is the reference's `jax.value_and_grad(loss_fn)` plus
`optax.adam(lr)`: the eval as a `torch.autograd.Function` (`NnueEval`),
the loss in plain torch on its output, and Adam with optax's arithmetic.
Its device work runs in hand-written CUDA kernels, each beside a plain
PyTorch version in this module or in models/nnue.py: the forward is K1
(board768) or K17 `nnue_refresh_kb` (king-bucketed) for the accumulators,
then K2 for the layer stack; the backward is K14 `nnue_stack_backward`
(the layer stack's gradients and the accumulators' upstream gradient),
then K15 `nnue_ft_backward_768` or K18 `nnue_ft_backward_kb` (the
feature transform's); the update is K16 `adam_update`. A wrapper runs the
plain version for CPU tensors and the kernel for CUDA tensors.

The parameters live as views into one flat f32 buffer (`pack_params`),
and so do Adam's moments and the gradients, so that one K16 launch
updates everything in place. `make_sharded_train_step` runs the
reference's dp×tp step on a grid of devices (parallel/mesh.py
make_2d_mesh), each position with a flat buffer of its own. The dataset
functions are the reference's over the port's own chess rules: the same
seed gives the same arrays, byte for byte.

Run as `python -m fishnet_tpu_torch.models.train` to regenerate the
shipped board768 net (the port's tools/train_default_net.py).
"""
from __future__ import annotations

import argparse
import random
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import device as device_mod
from .. import kernels
from ..chess import Position
from ..chess.types import BISHOP, KNIGHT, PAWN, QUEEN, ROOK, scan
from ..ops.board import board_array
from ..parallel import mesh as mesh_mod
from . import nnue

# ------------------------------------------------------------- flat layout

# ft_w's rows of the feature sets the trainer takes
FEATURE_ROWS = {"board768": nnue.NUM_FEATURES_768, "halfkav2_hm": nnue.NUM_FEATURES}


def widths(params: nnue.NnueParams) -> Tuple[int, int, int]:
    """(L1, H1, H2) of a net's layer stack; L1 from l1_w's 2 * L1 rows (a
    tp shard's ft_w holds a block of the columns)."""
    return params.l1_w.shape[1] // 2, params.l1_w.shape[2], params.l2_w.shape[2]


def feature_rows(params) -> int:
    """ft_w's rows of a net the trainer takes: a board768 or king-bucketed
    NnueParams (the reference trains no other)."""
    if not isinstance(params, nnue.NnueParams) or params.ft_w.shape[0] not in (
            FEATURE_ROWS.values()):
        raise NotImplementedError(
            f"training takes a board768 or king-bucketed NnueParams net, not a "
            f"{type(params).__name__} with ft_w {tuple(params.ft_w.shape)}")
    return params.ft_w.shape[0]


def unflatten(flat: torch.Tensor, l1: int, h1: int, h2: int, rows: int = nnue.NUM_FEATURES_768,
              cols: Optional[int] = None) -> nnue.NnueParams:
    """Views of a flat (n,) buffer as a net's eight fields, in field
    order: ft_w (rows, cols) and ft_b (cols,), cols L1 or a tp shard's
    block of it, then the layer stack of L1 → H1 → H2."""
    b = nnue.NUM_OUTPUT_BUCKETS
    cols = l1 if cols is None else cols
    shapes = [(rows, cols), (cols,), (b, 2 * l1, h1), (b, h1), (b, h1, h2),
              (b, h2), (b, h2), (b,)]
    views, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        views.append(flat[off:off + n].view(shape))
        off += n
    if off != flat.numel():
        raise ValueError(f"a flat buffer of these widths has {off} values, got {flat.numel()}")
    return nnue.NnueParams(*views)


def layout(params: nnue.NnueParams) -> dict:
    """unflatten's keywords for a buffer of params' layout."""
    return dict(rows=params.ft_w.shape[0], cols=params.ft_w.shape[1])


def flat_view(tensors: Sequence[torch.Tensor]) -> Optional[torch.Tensor]:
    """The flat buffer that `tensors` are consecutive contiguous views of,
    in order, or None when they are not."""
    first = tensors[0]
    base, off, n = first.untyped_storage().data_ptr(), first.storage_offset(), 0
    for t in tensors:
        if (not t.is_contiguous() or t.dtype != first.dtype
                or t.untyped_storage().data_ptr() != base or t.storage_offset() != off + n):
            return None
        n += t.numel()
    return first.as_strided((n,), (1,), off)


def pack_params(params: nnue.NnueParams) -> nnue.NnueParams:
    """params as views into one flat f32 buffer: `params` themselves when
    they already are, else a copy."""
    feature_rows(params)
    if flat_view(params) is not None and params.ft_w.dtype == torch.float32:
        return params
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in params])
    return unflatten(flat, *widths(params), **layout(params))


# --------------------------------------------- the layer stack's backward


def crelu_grad(z: torch.Tensor) -> torch.Tensor:
    """The reference's derivative of clip(z, 0, 1) (jnp.clip is max then
    min, and each splits a tie evenly): 1 inside (0, 1), 0.5 on either
    edge, 0 outside."""
    inside = (z > 0) & (z < 1)
    edge = (z == 0) | (z == 1)
    return torch.where(inside, 1.0, torch.where(edge, 0.5, 0.0)).to(z.dtype)


def stack_backward_plain(params: nnue.NnueParams, acc: torch.Tensor, stm: torch.Tensor,
                         bucket: torch.Tensor, d_pred: torch.Tensor):
    """K14's plain version. acc (B, 2, L1), stm/bucket (B,), d_pred (B,)
    the loss's gradient by each score → (d_acc (B, 2, L1), the gradients
    of l1_w, l1_b, l2_w, l2_b, out_w, out_b summed over the batch). The
    forward is recomputed from acc to find where each clip is on its edge."""
    l1 = acc.shape[2]
    ar = torch.arange(acc.shape[0], device=acc.device)
    s, b = stm.long(), bucket.long()
    pre = torch.cat([acc[ar, s], acc[ar, 1 - s]], 1)  # (B, 2*L1): own, opp
    x = pre.clamp(0.0, 1.0)
    z1 = torch.bmm(x[:, None], params.l1_w[b])[:, 0] + params.l1_b[b]
    h1 = z1.clamp(0.0, 1.0)
    z2 = torch.bmm(h1[:, None], params.l2_w[b])[:, 0] + params.l2_b[b]
    h2 = z2.clamp(0.0, 1.0)
    d_out = d_pred * nnue.OUTPUT_SCALE
    dz2 = params.out_w[b] * d_out[:, None] * crelu_grad(z2)
    dz1 = torch.bmm(params.l2_w[b], dz2[:, :, None])[:, :, 0] * crelu_grad(z1)
    dx = torch.bmm(params.l1_w[b], dz1[:, :, None])[:, :, 0] * crelu_grad(pre)
    d_acc = torch.empty_like(acc)
    d_acc[ar, s] = dx[:, :l1]
    d_acc[ar, 1 - s] = dx[:, l1:]
    onehot = torch.nn.functional.one_hot(b, nnue.NUM_OUTPUT_BUCKETS).to(acc.dtype)  # (B, 8)
    grads = (
        torch.einsum("bn,bk,bj->nkj", onehot, x, dz1),
        onehot.T @ dz1,
        torch.einsum("bn,bj,bk->njk", onehot, h1, dz2),
        onehot.T @ dz2,
        onehot.T @ (h2 * d_out[:, None]),
        onehot.T @ d_out,
    )
    return d_acc, grads


def stack_backward(params: nnue.NnueParams, acc: torch.Tensor, stm: torch.Tensor,
                   bucket: torch.Tensor, d_pred: torch.Tensor,
                   grad_head: torch.Tensor) -> torch.Tensor:
    """K14 wrapper: writes the six head gradients into grad_head (the flat
    buffer's tail, field after field) and returns d_acc (B, 2, L1); the
    plain version on the CPU, the kernel on the card."""
    if acc.device.type == "cpu":
        d_acc, grads = stack_backward_plain(params, acc, stm, bucket, d_pred)
        torch.cat([g.reshape(-1) for g in grads], out=grad_head)
        return d_acc
    return kernels.nnue_stack_backward(acc, stm, bucket, d_pred, params, grad_head)


# ------------------------------------------ the feature transform's backward


def _ft_backward_plain(idx: torch.Tensor, d_acc: torch.Tensor, rows: int):
    """idx (B, 2, 64) each piece's feature row or -1, d_acc (B, 2, L1) →
    (ft_w's gradient (rows, L1), ft_b's (L1,)): each row the sum of the
    d_acc rows of the (sample, perspective) pairs that hold it, and ft_b
    the sum of all, each in (sample, perspective, square) order from 0.0
    (a CPU index_add_ adds its sources in index order; a pair puts one
    square in a row). Every column is summed on its own, so a block of
    d_acc's columns gives those columns' bits of the whole."""
    B, _, l1 = d_acc.shape
    pairs = d_acc.reshape(B * 2, l1)
    src = pairs[:, None].expand(B * 2, 64, l1).reshape(-1, l1)
    g_w = torch.zeros((rows + 1, l1), dtype=d_acc.dtype, device=d_acc.device)
    g_w.index_add_(0, torch.where(idx >= 0, idx, rows).reshape(-1).long(), src)
    g_b = torch.zeros((1, l1), dtype=d_acc.dtype, device=d_acc.device)
    g_b.index_add_(0, torch.zeros(B * 2, dtype=torch.long, device=d_acc.device), pairs)
    return g_w[:rows], g_b[0]


def ft_backward_768_plain(boards: torch.Tensor, d_acc: torch.Tensor):
    """K15's plain version. boards (B, 64), d_acc (B, 2, L1) → (ft_w's
    gradient (768, L1), ft_b's (L1,)): each piece's board768 feature row
    collects its perspective's d_acc, and ft_b the sum over samples and
    both perspectives, in K15's order. Empty squares add nothing."""
    sq = torch.arange(64, dtype=torch.int32, device=boards.device)
    idx = torch.stack([nnue.feature_index_768(boards, sq, p) for p in (0, 1)], 1)
    return _ft_backward_plain(idx, d_acc, nnue.NUM_FEATURES_768)


def ft_backward_kb_plain(boards: torch.Tensor, d_acc: torch.Tensor):
    """K18's plain version. boards (B, 64), d_acc (B, 2, L1) → (ft_w's
    gradient (NUM_FEATURES, L1), ft_b's (L1,)) of a king-bucketed net:
    each piece's HalfKAv2_hm row (its perspective's king bucket, flip and
    mirror: nnue.feature_indices) collects that perspective's d_acc, in
    K18's order. Empty squares add nothing."""
    idx = torch.stack([nnue.feature_indices(boards, p, nnue.king_square(boards, p))
                       for p in (0, 1)], 1)
    return _ft_backward_plain(idx, d_acc, nnue.NUM_FEATURES)


def ft_backward_768(boards: torch.Tensor, d_acc: torch.Tensor, grad_ft: torch.Tensor) -> None:
    """K15 wrapper: writes ft_w's gradient and then ft_b's into grad_ft
    ((768 + 1) * L1 values, the flat buffer's head); the plain version on
    the CPU, the kernel on the card."""
    if d_acc.device.type == "cpu":
        g_w, g_b = ft_backward_768_plain(boards, d_acc)
        torch.cat([g_w.reshape(-1), g_b], out=grad_ft)
        return
    kernels.nnue_ft_backward_768(d_acc, boards, grad_ft)


def ft_backward_kb(boards: torch.Tensor, d_acc: torch.Tensor, grad_ft: torch.Tensor) -> None:
    """K18 wrapper: writes a king-bucketed net's ft_w gradient and then
    ft_b's into grad_ft ((NUM_FEATURES + 1) * L1 values, the flat
    buffer's head); the plain version on the CPU, the kernel on the card."""
    if d_acc.device.type == "cpu":
        g_w, g_b = ft_backward_kb_plain(boards, d_acc)
        torch.cat([g_w.reshape(-1), g_b], out=grad_ft)
        return
    kernels.nnue_ft_backward_kb(d_acc, boards, grad_ft)


# ------------------------------------------------------------ the eval


def refresh(params: nnue.NnueParams, boards: torch.Tensor) -> torch.Tensor:
    """The (B, 2, cols) accumulators of a net's ft_w columns: K1 on a
    board768 net, K17 on a king-bucketed one."""
    if feature_rows(params) == nnue.NUM_FEATURES_768:
        return nnue.accumulators_768(params, boards)
    return nnue.accumulators_kb(params, boards)


def ft_backward(rows: int, boards: torch.Tensor, d_acc: torch.Tensor,
                grad_ft: torch.Tensor) -> None:
    """The feature transform's backward of a net of `rows` feature rows:
    K15 on board768, K18 on king-bucketed."""
    (ft_backward_768 if rows == nnue.NUM_FEATURES_768 else ft_backward_kb)(boards, d_acc, grad_ft)


class NnueEval(torch.autograd.Function):
    """A board768 or king-bucketed f32 net's eval of (B, 64) boards and
    (B,) stms as a function of its eight weights. Forward: K1 or K17, then
    K2; it keeps the (B, 2, L1) accumulators. Backward: K14, then K15 or
    K18, into one flat gradient buffer whose views it returns. CPU tensors
    take the plain versions."""

    @staticmethod
    def forward(ctx, boards, stms, *weights):
        params = nnue.NnueParams(*weights)
        acc = refresh(params, boards)
        bucket = nnue.output_bucket(boards)
        ctx.save_for_backward(boards, stms, bucket, acc, *weights)
        return nnue.forward_from_acc(params, acc, stms, bucket)

    @staticmethod
    def backward(ctx, d_pred):
        boards, stms, bucket, acc, *weights = ctx.saved_tensors
        params = nnue.NnueParams(*weights)
        grad = torch.empty(sum(t.numel() for t in weights), dtype=torch.float32,
                           device=acc.device)
        n_ft = params.ft_w.numel() + params.ft_b.numel()
        d_acc = stack_backward(params, acc, stms, bucket, d_pred.contiguous(), grad[n_ft:])
        ft_backward(params.ft_w.shape[0], boards, d_acc, grad[:n_ft])
        return (None, None, *unflatten(grad, *widths(params), **layout(params)))


def batched_forward(params: nnue.NnueParams, boards: torch.Tensor,
                    stms: torch.Tensor) -> torch.Tensor:
    """(B, 64) int32 boards, (B,) int32 stms → (B,) centipawn scores,
    differentiable in the eight weights."""
    return NnueEval.apply(boards, stms, *params)


def loss_fn(params, boards, stms, targets):
    pred = batched_forward(params, boards, stms)
    # scale to pawns so the loss is O(1)
    return torch.mean(((pred - targets) / 100.0) ** 2)


def _loss_part(pred: torch.Tensor, targets: torch.Tensor, n: int):
    """A part of a batch of n scores → (its sum of loss_fn's squared
    errors, the mean's gradient by each of its scores). The gradient is
    autograd's of loss_fn's terms seeded with ones / n, the seed its
    mean's backward passes, so a grid of one row gives make_train_step's
    bits."""
    p = pred.detach().requires_grad_()
    with torch.enable_grad():
        sq = ((p - targets) / 100.0) ** 2
        (d_pred,) = torch.autograd.grad(sq, p, torch.ones_like(sq) / n)
    return sq.detach().sum(), d_pred


# ---------------------------------------------------------------- Adam


class AdamState(NamedTuple):
    """optax.adam's state: the step count (int32 in optax, kept on the
    host here) and the moments, each one flat f32 buffer in the params'
    field order (on a grid, make_sharded_train_step: a grid of them, one a
    position, and one count)."""
    count: int
    mu: torch.Tensor
    nu: torch.Tensor


def _f32(x: float) -> float:
    return float(np.float32(x))


def adam_update_plain(params: torch.Tensor, grad: torch.Tensor, mu: torch.Tensor,
                      nu: torch.Tensor, lr: float, b1: float, b2: float, eps: float,
                      bc1: float, bc2: float) -> None:
    """K16's plain version, in place on the flat buffers params, mu, nu:
    optax's scale_by_adam then scale(-lr) and apply_updates, in f32 with
    each operation rounded as optax's are. Every constant is an f32 value
    (1 - b1 and 1 - b2 rounded once, as optax's weak-typed scalars are);
    bc1, bc2 are the bias corrections 1 - b**count in f32. The square root
    is taken in f64 and rounded once to f32, the correctly rounded f32
    root (torch's vectorised f32 sqrt on a CPU is not, in the last bit),
    and the bias corrections divide as tensors on the buffers' device (a
    CUDA division by a Python scalar multiplies by its reciprocal)."""
    bc1, bc2 = (torch.tensor(bc, dtype=torch.float32, device=params.device) for bc in (bc1, bc2))
    m = grad * _f32(1 - b1) + mu * _f32(b1)
    v = (grad * grad) * _f32(1 - b2) + nu * _f32(b2)
    u = (m / bc1) / (torch.sqrt((v / bc2).double()).float() + _f32(eps))
    params.add_(u * _f32(-lr))
    mu.copy_(m)
    nu.copy_(v)


class Adam(NamedTuple):
    """optax.adam(lr): b1 0.9, b2 0.999, eps 1e-8, eps_root 0."""
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def bias_corrections(self, count: int) -> Tuple[float, float]:
        """1 - b1**count and 1 - b2**count in f32, as optax takes them."""
        return tuple(float(np.float32(1) - np.float32(b) ** np.float32(count))
                     for b in (self.b1, self.b2))

    def init(self, params) -> AdamState:
        """The zero state of a net, or of a grid's params
        (parallel/mesh.py shard_params_tp): one count, zero moments a
        position."""
        if not isinstance(params, nnue.NnueParams):
            zeros = tuple(tuple(torch.zeros_like(flat_view(p)) for p in row) for row in params)
            return AdamState(0, zeros, tuple(tuple(torch.zeros_like(m) for m in row)
                                             for row in zeros))
        flat = flat_view(pack_params(params))
        return AdamState(0, torch.zeros_like(flat), torch.zeros_like(flat))

    def apply(self, params: torch.Tensor, grad: torch.Tensor, state: AdamState) -> AdamState:
        """One update of the flat params buffer by the flat gradient, IN
        PLACE: params, state.mu and state.nu are overwritten, and the
        returned state holds the same moment buffers with the count
        incremented (K16 on the card, its plain version on the CPU)."""
        count = min(state.count + 1, 2**31 - 1)  # optax's safe_increment on int32
        bc1, bc2 = self.bias_corrections(count)
        args = (params, grad, state.mu, state.nu, self.lr, self.b1, self.b2, self.eps, bc1, bc2)
        if params.device.type == "cpu":
            adam_update_plain(*args)
        else:
            kernels.adam_update(*args)
        return AdamState(count, state.mu, state.nu)


def adam(lr: float) -> Adam:
    return Adam(lr)


def make_train_step(optimizer: Adam):
    """step(params, opt_state, boards, stms, targets) → (params, opt_state,
    loss), the reference's call shape. The update is IN PLACE: params that
    are views of one flat buffer (pack_params, and what the step returns)
    are overwritten, others are packed into a new buffer first; the moment
    buffers of opt_state are overwritten. loss is a 0-dim tensor on the
    params' device (no host sync)."""

    def train_step(params, opt_state: AdamState, boards, stms, targets):
        params = pack_params(params)
        leaves = [t.detach().requires_grad_() for t in params]
        with torch.enable_grad():
            loss = loss_fn(nnue.NnueParams(*leaves), boards, stms, targets)
            grads = torch.autograd.grad(loss, leaves)
        grad = flat_view(grads)
        if grad is None:
            raise RuntimeError("the eval's backward did not return views of one flat buffer")
        opt_state = optimizer.apply(flat_view(params), grad, opt_state)
        return params, opt_state, loss.detach()

    return train_step


def make_sharded_train_step(mesh: mesh_mod.Grid, optimizer: Adam):
    """The reference's dp×tp training step on a (dp, tp) grid of devices
    (parallel/mesh.py make_2d_mesh): step(params, opt_state, boards, stms,
    targets) → (params, opt_state, loss), params the grid's
    (mesh.shard_params_tp: position (i, j) holds column block j of ft_w
    and ft_b and the whole layer stack, views of a flat buffer of its own),
    opt_state `optimizer.init` of them (one count, a moment buffer a
    position), boards, stms and targets the whole batch on any device
    (split over dp by mesh.shard_batch), loss a 0-dim tensor on position
    (0, 0)'s device. params and the moments are updated IN PLACE.

    Position (i, j) does the work of the reference's device (i, j). The
    collectives XLA inserts from the shardings are copies and ordered adds
    here, no kernel:
    - K1 or K17 on dp row i's boards over its columns of ft_w;
    - the tp gather: row i's column blocks copied in tp order into a
      (B / dp, 2, L1) accumulator of its own;
    - K2, the loss's gradient (the mean over the whole batch of B scores,
      so each score's divides by B), K14, then K15 or K18 on its column
      block of d_acc, into a flat gradient of its buffer's layout;
    - the dp sum: its column's dp gradients (the layer stack's too) added
      in dp order 0..dp-1 into a buffer of its own;
    - K16 on its buffers, the grid's one Adam count.
    The loss is the rows' sums of squared errors added in dp order, over
    B. Each column is summed on its own by every kernel and plain version
    here, so a grid of one row gives make_train_step's bits whatever tp.
    K2 and K14 take only the shipped widths (kernels.SHIPPED_WIDTHS), so a
    net whose layer stack has others raises, on the CPU too (the
    reference's caller on an odd device count: tp 1, L1 32)."""
    grid = mesh_mod.check_grid(mesh)
    dp, tp = len(grid), len(grid[0])

    def train_step(params, opt_state: AdamState, boards, stms, targets):
        if widths(params[0][0]) != kernels.SHIPPED_WIDTHS:
            raise ValueError(f"the grid's layer stack runs K2 and K14, which take the shipped "
                             f"widths {kernels.SHIPPED_WIDTHS}; got {widths(params[0][0])}")
        B = boards.shape[0]
        b_parts, s_parts, t_parts = (mesh_mod.shard_batch(grid, x) for x in (boards, stms, targets))
        grads, sse = [], []
        for i, row in enumerate(grid):
            accs = [refresh(params[i][j], b_parts[i][j]) for j in range(tp)]
            grads.append([])
            for j, dev in enumerate(row):
                p, b, s = params[i][j], b_parts[i][j], s_parts[i][j]
                rows, cols = p.ft_w.shape
                acc = torch.cat([a.to(dev) for a in accs], 2)
                bucket = nnue.output_bucket(b)
                part, d_pred = _loss_part(nnue.forward_from_acc(p, acc, s, bucket),
                                          t_parts[i][j], B)
                grad = torch.empty_like(flat_view(p))
                n_ft = (rows + 1) * cols
                d_acc = stack_backward(p, acc, s, bucket, d_pred, grad[n_ft:])
                ft_backward(rows, b, d_acc[:, :, j * cols:(j + 1) * cols].contiguous(),
                            grad[:n_ft])
                grads[i].append(grad)
                if j == 0:
                    sse.append(part)
        count = opt_state.count
        for i, row in enumerate(grid):
            for j, dev in enumerate(row):
                total = grads[0][j].to(dev, copy=True)
                for k in range(1, dp):
                    total.add_(grads[k][j].to(dev))
                count = optimizer.apply(
                    flat_view(params[i][j]), total,
                    AdamState(opt_state.count, opt_state.mu[i][j], opt_state.nu[i][j])).count
        dev0 = grid[0][0]
        loss = sse[0].to(dev0, copy=True)
        for part in sse[1:]:
            loss.add_(part.to(dev0))
        return params, AdamState(count, opt_state.mu, opt_state.nu), loss / B

    return train_step


def train_material_net(
    l1: int = 64,
    steps: int = 200,
    batch: int = 256,
    seed: int = 0,
    dataset: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    lr: float = 1e-3,
    feature_set: str = "board768",
    device=None,
    generator: Optional[torch.Generator] = None,
    on_step: Optional[Callable] = None,
):
    """Train a board768 or king-bucketed ("halfkav2_hm") net against the
    dataset's targets (by default random_position_dataset(batch * 8,
    seed)) → (params, final loss). The net starts from
    init_params(generator) (default: a CPU generator seeded with `seed`,
    so the card and the CPU start from the same net), and the batches are
    the reference's: np.random.default_rng(seed).integers(0, n,
    size=batch) each step. on_step(i, params, opt_state, loss), if given,
    runs after each step (params are updated in place by the next one).
    Runs on the card unless device="cpu"."""
    dev = device_mod.resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    params = pack_params(nnue.init_params(generator, l1=l1, feature_set=feature_set,
                                          device=dev))
    optimizer = adam(lr)
    opt_state = optimizer.init(params)
    step = make_train_step(optimizer)
    if dataset is None:
        dataset = random_position_dataset(batch * 8, seed=seed)
    boards, stms, targets = dataset
    n = boards.shape[0]
    rng = np.random.default_rng(seed)
    loss = None
    for i in range(steps):
        idx = rng.integers(0, n, size=batch)
        params, opt_state, loss = step(
            params, opt_state,
            torch.from_numpy(boards[idx]).to(dev), torch.from_numpy(stms[idx]).to(dev),
            torch.from_numpy(targets[idx]).to(dev),
        )
        if on_step is not None:
            on_step(i, params, opt_state, loss)
    return params, float(loss)


# --------------------------------------------------- training data synthesis


def material_mobility_target(pos) -> float:
    """Cheap supervised target: material + mobility in centipawns, from the
    side to move's perspective."""
    vals = {PAWN: 100, KNIGHT: 300, BISHOP: 315, ROOK: 500, QUEEN: 900}
    us = pos.turn
    score = 0
    for ptype, val in vals.items():
        score += val * (
            bin(pos.bbs[us][ptype]).count("1")
            - bin(pos.bbs[us ^ 1][ptype]).count("1")
        )
    score += 2 * len(pos.legal_moves())
    return float(score)


def random_position_dataset(n: int, seed: int = 0, max_plies: int = 60):
    """Generate positions by random playouts with material targets."""
    rng = random.Random(seed)
    boards = np.zeros((n, 64), np.int32)
    stms = np.zeros((n,), np.int32)
    targets = np.zeros((n,), np.float32)
    pos = Position.initial()
    plies = 0
    for i in range(n):
        legal = pos.legal_moves()
        if not legal or plies > max_plies or pos.outcome() is not None:
            pos = Position.initial()
            plies = 0
            legal = pos.legal_moves()
        pos = pos.push(rng.choice(legal))
        plies += 1
        boards[i] = board_array(pos)
        stms[i] = int(pos.turn)
        targets[i] = material_mobility_target(pos)
    return boards, stms, targets


# The shipped board768 net is distilled from a classical handcrafted
# evaluation (material + piece-square + mobility). The dataset below mixes
# random playouts with synthetic random-material positions to pin the
# material axis, which playouts alone barely move.

_PST_PAWN = np.array([
    0, 0, 0, 0, 0, 0, 0, 0,
    5, 10, 10, -20, -20, 10, 10, 5,
    5, -5, -10, 0, 0, -10, -5, 5,
    0, 0, 0, 20, 20, 0, 0, 0,
    5, 5, 10, 25, 25, 10, 5, 5,
    10, 10, 20, 30, 30, 20, 10, 10,
    50, 50, 50, 50, 50, 50, 50, 50,
    0, 0, 0, 0, 0, 0, 0, 0,
], np.int32)
_PST_KNIGHT = np.array([
    -50, -40, -30, -30, -30, -30, -40, -50,
    -40, -20, 0, 5, 5, 0, -20, -40,
    -30, 5, 10, 15, 15, 10, 5, -30,
    -30, 0, 15, 20, 20, 15, 0, -30,
    -30, 5, 15, 20, 20, 15, 5, -30,
    -30, 0, 10, 15, 15, 10, 0, -30,
    -40, -20, 0, 0, 0, 0, -20, -40,
    -50, -40, -30, -30, -30, -30, -40, -50,
], np.int32)
_PST_BISHOP = np.array([
    -20, -10, -10, -10, -10, -10, -10, -20,
    -10, 5, 0, 0, 0, 0, 5, -10,
    -10, 10, 10, 10, 10, 10, 10, -10,
    -10, 0, 10, 10, 10, 10, 0, -10,
    -10, 5, 5, 10, 10, 5, 5, -10,
    -10, 0, 5, 10, 10, 5, 0, -10,
    -10, 0, 0, 0, 0, 0, 0, -10,
    -20, -10, -10, -10, -10, -10, -10, -20,
], np.int32)
_PST_ROOK = np.array([
    0, 0, 0, 5, 5, 0, 0, 0,
    -5, 0, 0, 0, 0, 0, 0, -5,
    -5, 0, 0, 0, 0, 0, 0, -5,
    -5, 0, 0, 0, 0, 0, 0, -5,
    -5, 0, 0, 0, 0, 0, 0, -5,
    -5, 0, 0, 0, 0, 0, 0, -5,
    5, 10, 10, 10, 10, 10, 10, 5,
    0, 0, 0, 0, 0, 0, 0, 0,
], np.int32)
_PST_QUEEN = np.array([
    -20, -10, -10, -5, -5, -10, -10, -20,
    -10, 0, 5, 0, 0, 0, 0, -10,
    -10, 5, 5, 5, 5, 5, 0, -10,
    0, 0, 5, 5, 5, 5, 0, -5,
    -5, 0, 5, 5, 5, 5, 0, -5,
    -10, 0, 5, 5, 5, 5, 0, -10,
    -10, 0, 0, 0, 0, 0, 0, -10,
    -20, -10, -10, -5, -5, -10, -10, -20,
], np.int32)
_PST_KING = np.array([
    20, 30, 10, 0, 0, 10, 30, 20,
    20, 20, 0, 0, 0, 0, 20, 20,
    -10, -20, -20, -20, -20, -20, -20, -10,
    -20, -30, -30, -40, -40, -30, -30, -20,
    -30, -40, -40, -50, -50, -40, -40, -30,
    -30, -40, -40, -50, -50, -40, -40, -30,
    -30, -40, -40, -50, -50, -40, -40, -30,
    -30, -40, -40, -50, -50, -40, -40, -30,
], np.int32)
_PSTS = [_PST_PAWN, _PST_KNIGHT, _PST_BISHOP, _PST_ROOK, _PST_QUEEN, _PST_KING]
_PIECE_VALUES = [100, 300, 315, 500, 900, 0]


def classical_eval_target(pos) -> float:
    """Material + piece-square + mobility in cp from the side to move."""
    score = 0
    for color in (0, 1):
        sign = 1 if color == pos.turn else -1
        for ptype in range(6):
            for sq in scan(pos.bbs[color][ptype]):
                o_sq = sq if color == 0 else sq ^ 56
                score += sign * (_PIECE_VALUES[ptype] + int(_PSTS[ptype][o_sq]))
    score += 2 * len(pos.legal_moves())
    return float(np.clip(score, -3000, 3000))


def _random_material_position(rng) -> Optional[Position]:
    """A synthetic legal-ish position with random (often lopsided)
    material — the axis random playouts never cover."""
    board = [""] * 64
    squares = list(range(64))
    rng.shuffle(squares)
    it = iter(squares)
    wk, bk = next(it), next(it)
    while max(abs((wk & 7) - (bk & 7)), abs((wk >> 3) - (bk >> 3))) <= 1:
        bk = next(it)
    board[wk], board[bk] = "K", "k"
    for color, syms in ((0, "PNBRQ"), (1, "pnbrq")):
        counts = [
            rng.randint(0, 8), rng.randint(0, 2), rng.randint(0, 2),
            rng.randint(0, 2), rng.randint(0, 1),
        ]
        for ptype, cnt in enumerate(counts):
            for _ in range(cnt):
                sq = next(it, None)
                if sq is None:
                    break
                if syms[ptype] in "Pp" and (sq < 8 or sq >= 56):
                    continue
                board[sq] = syms[ptype]
    rows = []
    for rank in range(7, -1, -1):
        row, empty = "", 0
        for f in range(8):
            c = board[rank * 8 + f]
            if c:
                row += (str(empty) if empty else "") + c
                empty = 0
            else:
                empty += 1
        rows.append(row + (str(empty) if empty else ""))
    fen = "/".join(rows) + (" w - - 0 1" if rng.random() < 0.5 else " b - - 0 1")
    try:
        return Position.from_fen(fen)
    except Exception:  # an illegal FEN (e.g. the side not to move in check)
        return None


def diverse_position_dataset(n: int, seed: int = 0):
    """50% random-playout positions (structure), 50% synthetic
    random-material positions (material axis); classical targets."""
    rng = random.Random(seed)
    boards = np.zeros((n, 64), np.int32)
    stms = np.zeros((n,), np.int32)
    targets = np.zeros((n,), np.float32)
    pos = Position.initial()
    plies = 0
    i = 0
    while i < n:
        if i % 2 == 0:
            legal = pos.legal_moves()
            if not legal or plies > 80 or pos.outcome() is not None:
                pos = Position.initial()
                plies = 0
                legal = pos.legal_moves()
            pos = pos.push(rng.choice(legal))
            plies += 1
            sample = pos
        else:
            sample = _random_material_position(rng)
            if sample is None or sample.outcome() is not None:
                continue
        boards[i] = board_array(sample)
        stms[i] = int(sample.turn)
        targets[i] = classical_eval_target(sample)
        i += 1
    return boards, stms, targets


# ------------------------------------------------------------ entry point


def main(argv=None) -> int:
    """Regenerate the shipped board768 net: distil the classical eval
    (classical_eval_target) over diverse_position_dataset into it. The
    defaults are tools/train_default_net.py's, which produced the shipped
    net. Runs on the card unless --device cpu."""
    ap = argparse.ArgumentParser(prog="python -m fishnet_tpu_torch.models.train")
    ap.add_argument("--steps", type=int, default=24_000)
    ap.add_argument("--samples", type=int, default=150_000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--l1", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="cpu for the plain path (default: the card)")
    args = ap.parse_args(argv)

    dev = device_mod.resolve(args.device)
    print(f"generating {args.samples} positions ...", flush=True)
    dataset = diverse_position_dataset(args.samples, seed=args.seed)
    print(f"training on {dev} ...", flush=True)

    def progress(i, params, opt_state, loss):
        if (i + 1) % 1000 == 0:
            print(f"step {i + 1}: loss {float(loss):.4f}", flush=True)

    params, loss = train_material_net(
        l1=args.l1, steps=args.steps, batch=args.batch, seed=args.seed,
        dataset=dataset, lr=args.lr, device=dev, on_step=progress,
    )
    out = args.out or nnue.ASSET
    nnue.save_params(params, out)
    print(f"saved {out} (final loss {loss:.4f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
