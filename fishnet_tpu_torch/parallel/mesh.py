"""Search lanes sharded over several devices: a port of the JAX package's
parallel/mesh.py on one process.

Search lanes are independent, so a batch of B lanes splits into n shards
of B / n consecutive lanes, one a mesh device; lane numbers stay global.
Each shard has its own full-size transposition table on its device
(`make_sharded_table`), advances on its own and stops when its own lanes
are all DONE: a sharded segment (`run_segment_sharded`) launches K11 once
a shard and returns the per-shard step counts and one stacked boundary
summary (n, B / n + 1, 4), and a sharded splice (`refill_lanes_sharded`)
runs `ops/search.py refill_lanes` (K1 on the new roots, K7) on the lanes
each shard owns. Nothing crosses shards.

A mesh is a plain tuple of `torch.device`s, one a shard; a device may
repeat. On a card several shards of one device are contiguous
leading-dimension views of one state, and each runs its K11 on a CUDA
stream of its own: every shard is launched before anything is read, and
the stacked summary comes back in one device-to-host copy a distinct
device. Every launch, K11 or a splice's K1, K4 and K7, runs with the card
of its tensors current (kernels.py `_launch`), so on several cards each
shard launches on its own. A CPU shard runs the plain version
(`run_segment_plain`, `refill_lanes`' plain K7).

The trainer's (dp, tp) grid (`make_2d_mesh`) is a tuple of dp rows of
tp devices each: `shard_params_tp` lays a net out as the reference's
PARAM_RULES_TP shard it (ft_w's and ft_b's columns split in contiguous
blocks over tp, the layer stack replicated), each position's fields views
of a flat buffer of its own, and `shard_batch` splits a batch over dp
(the reference's batch_spec) and gives each row's part to each of its
positions. models/train.py make_sharded_train_step runs the step on it.

Not ported: the reference's partition-spec registry
(parallel/partition.py) and its `aot`/`sanitize` wrapping serve only
XLA's sharded compilation and buffer donation, which have no counterpart
here (the grid's two layouts are written out in `shard_params_tp` and
`shard_batch`); `sharded_search`, a thin wrapper, is `ops/search.py
search_batch_resumable(mesh=...)` itself; the multi-host half
(parallel/distributed.py) waits for a machine with several hosts.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels, settings
from ..models import nnue
from ..ops import search
from ..ops import tt as tt_mod

Mesh = Tuple[torch.device, ...]
# the trainer's (dp, tp) grid: dp rows of tp devices
Grid = Tuple[Mesh, ...]

# each (device index, shard) its own CUDA stream, made once
_STREAMS: dict = {}


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of `devices` (names or torch.devices, repeats allowed); by
    default every visible card, cuda:0..n-1 (RuntimeError without one)."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError("no CUDA device is visible; pass the mesh's devices")
        devices = [f"cuda:{i}" for i in range(n)]
    mesh = []
    for d in devices:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        mesh.append(d)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return tuple(mesh)


def make_2d_mesh(dp: int, tp: int, devices: Optional[Sequence] = None) -> Grid:
    """A dp x tp grid of devices, the reference's make_2d_mesh (axes "dp"
    and "tp"): row i is devices[i * tp:(i + 1) * tp]. By default the first
    dp * tp visible cards (RuntimeError with fewer); a device repeats only
    where `devices` repeats it (["cuda:0"] * 8 puts eight positions on one
    card, ["cpu"] * 8 on the CPU)."""
    if dp < 1 or tp < 1:
        raise ValueError(f"a grid needs dp, tp >= 1, got {dp} x {tp}")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < dp * tp:
            raise RuntimeError(f"a {dp} x {tp} grid needs {dp * tp} cards, {n} visible; "
                               f"pass the grid's devices")
        devices = [f"cuda:{i}" for i in range(dp * tp)]
    flat = make_mesh(devices)
    if len(flat) != dp * tp:
        raise ValueError(f"a {dp} x {tp} grid takes {dp * tp} devices, got {len(flat)}")
    return tuple(flat[i * tp:(i + 1) * tp] for i in range(dp))


def _is_grid(mesh) -> bool:
    return len(mesh) > 0 and isinstance(mesh[0], tuple)


def check_grid(grid) -> Grid:
    """grid itself if it is a rectangular (dp, tp) grid of devices."""
    if not _is_grid(grid) or any(len(row) != len(grid[0]) or not row for row in grid):
        raise ValueError("expected a (dp, tp) grid of devices (make_2d_mesh)")
    return grid


def _local(mesh, B: int) -> int:
    if B % len(mesh):
        raise ValueError(f"lane count {B} must divide over {len(mesh)} devices")
    return B // len(mesh)


def shard_batch(mesh, tree) -> list:
    """A tensor, or a tuple of tensors with one leading lane dimension (a
    SearchState, a Board), → its n shards along that dimension, shard s
    on mesh[s]: views where the batch already lies contiguous on that
    device, copies elsewhere. On a (dp, tp) grid the batch splits over dp
    and every position of row i gets row i's part on its device (the
    reference's batch_spec): → [i][j]."""
    first = tree if torch.is_tensor(tree) else tree[0]
    local = _local(mesh, int(first.shape[0]))

    def part(s: int, dev: torch.device):
        def piece(x: torch.Tensor) -> torch.Tensor:
            return x[s * local:(s + 1) * local].to(dev).contiguous()

        return piece(tree) if torch.is_tensor(tree) else type(tree)(*[piece(x) for x in tree])

    if _is_grid(mesh):
        return [[part(i, dev) for dev in row] for i, row in enumerate(mesh)]
    return [part(s, dev) for s, dev in enumerate(mesh)]


def shard_params_tp(params, grid: Grid) -> tuple:
    """A net (NnueParams) in the reference's training layout on a (dp, tp)
    grid (PARAM_RULES_TP): the position (i, j) holds column block j of ft_w (P(None, "tp")) and of
    ft_b (P("tp")), contiguous blocks in tp order, and the whole layer
    stack (P()), all f32 views of one flat buffer of its own on its device
    → a grid of NnueParams."""
    tp = len(check_grid(grid)[0])
    l1 = params.ft_w.shape[1]
    if l1 % tp:
        raise ValueError(f"ft_w's {l1} columns do not split over tp = {tp}")
    w = l1 // tp
    out = []
    for row in grid:
        out.append([])
        for j, dev in enumerate(row):
            fields = [params.ft_w[:, j * w:(j + 1) * w], params.ft_b[j * w:(j + 1) * w],
                      *params[2:]]
            flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float32) for t in fields])
            views = flat.split([t.numel() for t in fields])
            out[-1].append(nnue.NnueParams(*[v.view(t.shape) for v, t in zip(views, fields)]))
    return tuple(tuple(row) for row in out)


def replicate(mesh: Mesh, tree) -> list:
    """A net (or a tensor) → one a shard, moved to each distinct device
    once (shards of one device share it)."""
    copies: dict = {}
    for dev in mesh:
        if dev not in copies:
            copies[dev] = tree.to(dev)
    return [copies[dev] for dev in mesh]


def make_sharded_table(mesh: Mesh, size_log2: int) -> List[torch.Tensor]:
    """One full-size (2^size_log2, 4) table a shard, on its device; each
    shard hashes into its own, so lanes share entries only within a
    shard."""
    return [tt_mod.make_table(size_log2, dev) for dev in mesh]


def _stream(dev: torch.device, shard: int):
    key = (dev.index, shard)
    s = _STREAMS.get(key)
    if s is None:
        s = _STREAMS[key] = torch.cuda.Stream(device=dev)
    return s


def _device_slots(mesh: Mesh) -> tuple:
    """→ (each distinct device's number of shards, each shard's (device,
    its row in that device's part of the stacked summary))."""
    count: dict = {}
    slots = []
    for dev in mesh:
        slots.append((dev, count.get(dev, 0)))
        count[dev] = count.get(dev, 0) + 1
    return count, slots


def _shard_gen(tt_gen, mesh: Mesh, local: int) -> list:
    """tt_gen (an int, or one generation a lane) → each shard's."""
    if isinstance(tt_gen, (int, np.integer)):
        return [int(tt_gen)] * len(mesh)
    gen = tt_gen if torch.is_tensor(tt_gen) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(tt_gen, np.int32)))
    gen = gen.to(torch.int32)
    if gen.ndim == 0:
        return [int(gen)] * len(mesh)
    return [gen[s * local:(s + 1) * local].to(dev).contiguous() for s, dev in enumerate(mesh)]


def run_segment_sharded(mesh: Mesh, params, shards: Sequence, tables, segment_steps: int,
                        pruning: Optional[bool] = None, deep_tt: bool = False,
                        prefer_deep: bool = False, tt_gen=0, variant: str = "standard",
                        events: Optional[list] = None):
    """Advance every shard <= segment_steps steps, each stopping once its
    own lanes are all DONE (ops/search.py run_segment on each) → (the
    steps of each shard (a list), the stacked summary (n, local + 1, 4)
    int32 as a host array: shard s's packed summary in row s).

    params: a net, or one a shard (replicate); shards: the per-shard
    SearchStates, updated in place; tables: None or one (N, 4) table a
    shard (make_sharded_table), updated in place; tt_gen: an int, or a
    generation a global lane. A CUDA shard launches K11 on its own stream
    into its rows of one preallocated summary buffer on its device; all
    are launched before anything is read, then each distinct device's
    buffer comes back in one copy. A CPU shard runs run_segment_plain.
    events: a list that receives each CUDA shard's (shard, start, end)
    CUDA events around its launch."""
    if pruning is None:
        pruning = not settings.get_bool("FISHNET_TPU_NO_PRUNING")
    nets = params if isinstance(params, list) else replicate(mesh, params)
    local = int(shards[0].lane.shape[0])
    gens = _shard_gen(tt_gen, mesh, local)
    count, slots = _device_slots(mesh)
    bufs = {dev: torch.empty((k, local + 1, search.SUM_W), dtype=torch.int32, device=dev)
            for dev, k in count.items()}
    cuda = [s for s, dev in enumerate(mesh) if dev.type == "cuda"]
    # every shard's stream waits for the work queued so far (splices, the
    # summary buffers) before any shard launches, so no shard waits for
    # another
    for s in cuda:
        _stream(mesh[s], s).wait_stream(torch.cuda.current_stream(mesh[s]))
    for s, (dev, row) in enumerate(slots):
        table = None if tables is None else tables[s]
        out = bufs[dev][row]
        if dev.type != "cuda":
            search.run_segment_plain(nets[s], shards[s], segment_steps, pruning, table,
                                     deep_tt, prefer_deep, gens[s], variant, out=out)
            continue
        with torch.cuda.device(dev), torch.cuda.stream(_stream(dev, s)):
            if events is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            kernels.search_segment(nets[s], shards[s], segment_steps, pruning, table, deep_tt,
                                   prefer_deep, gens[s], variant, out=out)
            if events is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                events.append((s, start, end))
    for s in cuda:
        torch.cuda.current_stream(mesh[s]).wait_stream(_stream(mesh[s], s))
    host = {dev: buf.cpu().numpy() for dev, buf in bufs.items()}
    stacked = np.stack([host[dev][row] for dev, row in slots])
    return stacked[:, local, search.SUM_DONE].astype(int).tolist(), stacked


def _take(x, sel: np.ndarray):
    if x is None:
        return None
    if torch.is_tensor(x):
        return x[torch.as_tensor(sel, device=x.device)]
    return np.asarray(x)[sel]


def _splice_sharded(splice, mesh: Mesh, params, shards: Sequence, new_roots, lane_idx,
                    depth, node_budget, variant: str, **kw) -> list:
    nets = params if isinstance(params, list) else replicate(mesh, params)
    local = int(shards[0].lane.shape[0])
    idx = np.asarray(lane_idx, np.int64).reshape(-1)
    B = local * len(mesh)
    if idx.size and (idx.min() < 0 or idx.max() >= B or np.unique(idx).size != idx.size):
        raise ValueError(f"lane indices must be distinct and in [0, {B}): {idx.tolist()}")
    owner = idx // local
    for s in range(len(mesh)):
        sel = np.nonzero(owner == s)[0]
        if not sel.size:
            continue
        roots = type(new_roots)(*[_take(t, sel) for t in new_roots])
        splice(nets[s], shards[s], roots, idx[sel] - s * local, _take(depth, sel),
               _take(node_budget, sel), variant=variant,
               **{k: _take(v, sel) for k, v in kw.items()})
    return shards


def refill_lanes_sharded(mesh: Mesh, params, shards: Sequence, new_roots, lane_idx, depth,
                         node_budget, *, variant: str = "standard", hist_hash=None,
                         hist_halfmove=None, root_alpha=None, root_beta=None,
                         order_jitter=None, group=None) -> list:
    """Splice fresh roots into lanes of a sharded state, in place; returns
    `shards`. The contract of ops/search.py refill_lanes with global lane
    numbers: lane l is local lane l % local of shard l // local, and each
    shard runs refill_lanes (K1 on its new roots, then K7 on a card) on
    its own lanes; every other lane keeps its state bit for bit."""
    return _splice_sharded(search.refill_lanes, mesh, params, shards, new_roots, lane_idx,
                           depth, node_budget, variant, hist_hash=hist_hash,
                           hist_halfmove=hist_halfmove, root_alpha=root_alpha,
                           root_beta=root_beta, order_jitter=order_jitter, group=group)


def refill_lanes_sharded_plain(mesh: Mesh, params, shards: Sequence, new_roots, lane_idx,
                               depth, node_budget, *, variant: str = "standard",
                               **kw) -> list:
    """refill_lanes_sharded's plain version: each shard's splice through
    K7's plain version (ops/search.py _merge_lanes_plain)."""
    def splice(net, state, roots, idx, d, budget, variant, **rest):
        search.max_moves_for(variant)
        return search._merge_lanes_plain(net, state, roots, idx, d, budget, **rest)

    return _splice_sharded(splice, mesh, params, shards, new_roots, lane_idx, depth,
                           node_budget, variant, **kw)
