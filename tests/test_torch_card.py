"""fishnet_tpu_torch's CUDA kernels on the card: each against its plain
PyTorch version (the TT probe and store on seeded tables with forced
slot collisions, the store up to 8192 lanes and on four slots, the lane
init over every lane and over scattered ones, the board rules, move
generator and make-move on chip_smoke's seeded positions (the move
generator also on its long and tied lists, the layer stack at the clip
edges from 1 to 1024 lanes), the segment kernel K11 against
run_segment_plain on chip_smoke's seeded search states, also where a
step's stores and the next step's reads share slots and go through
pending rows, exactly), the wrappers' checks and
launch counts, a plain step on the card that runs none of the plain
board code, a segment on the card that runs no PyTorch step, and the
int8 searches (all through K11) on the card against the CPU, with the
transposition table and helper lanes too, and a refill splice and a
refill stream (tables compared byte for byte); the full evals of the
king-bucketed and Stockfish nets (K12, K13) against their plain versions
(K13 also on tests/test_torch_sf_eval.py's boards of every bucket and king
square at three widths), their wrappers' refusals, and K11 on those nets
against run_segment_plain (on a Stockfish net also with 1, 2 and every
lane evaluating in a step, its units spread over the other warps); the trainer's kernels (K14-K16, and on a king-bucketed net
K17 and K18) against their plain versions (K17 also at every width and
view of tests/test_torch_sf_eval.py's KB_REFRESH_CASES) (K15 and K18 byte for byte the
plain versions run on the CPU, also on the worst-case batch, across
windows and at the tp and wide widths), their wrappers' refusals, and
training steps on the card that run no plain version, against the CPU's;
the dp×tp step on grids of cuda:0 (one row equal to the one-device step
bit for bit, a 2 x 2 grid against the same grid of CPU devices); the variant instantiations of
K4 and K8-K10 against their plain versions and K11 against
run_segment_plain in each variant (in crazyhouse also on roots from its
mid, heavy and full pockets; atomic also on the king-bucketed net); the
bf16 entry points of K1, K2, K3, K12 and K11 against their plain versions
and against the f32 kernels on the widened weights; K11 and K7 a shard
on a 4-shard mesh of one card against their plain versions, and the int8
mesh searches against the CPU's shards. Needs an NVIDIA card;
skipped elsewhere. Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_card.py -q -p no:cacheprovider
"""
import random

import numpy as np
import pytest
import torch

from chip_smoke import (
    FINISH_STEPS, FT_CASES, FT_WIDE_L1, TRAIN_GRAD_RTOL, TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL,
    TT_PROBE_ARGS, TT_STORE_ARGS, VARIANTS, ZH_POCKETS, _rel_err, every_move, ft_case, ft_check,
    k2_inputs, kb_case, kb_train_case, lane_init_case, movegen_long_inputs, playout_boards,
    rules_inputs, segment_case, sf_file, train_case, tt_inputs, tt_runner_layout,
)
from test_torch_sf_eval import (
    KB_REFRESH_CASES, SF_EVAL_WIDTHS, kb_refresh_case, sf_eval_boards, sf_eval_net,
)
from fishnet_tpu_torch import kernels
from fishnet_tpu_torch.chess import Position
from fishnet_tpu_torch.models import nnue
from fishnet_tpu_torch.models import nnue_import as ni
from fishnet_tpu_torch.models import train
from fishnet_tpu_torch.ops import board as tb
from fishnet_tpu_torch.ops import movegen as tm
from fishnet_tpu_torch.ops import tt
from fishnet_tpu_torch.ops import search
from fishnet_tpu_torch.ops.search import search_batch, search_batch_resumable, search_stream
from fishnet_tpu_torch.parallel.mesh import (
    make_2d_mesh, make_mesh, make_sharded_table, refill_lanes_sharded, refill_lanes_sharded_plain,
    run_segment_sharded, shard_batch, shard_params_tp,
)

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


@pytest.mark.parametrize("net", ["f32", "int8", "bf16"])
@pytest.mark.parametrize("batch", [1, 16, 64, 1024])
def test_forward_warp_at_the_clip_edges(card, nets, batch, net):
    """K2, one warp a lane, on chip_smoke.k2_case's accumulators at the
    clip edges, every output bucket from 8 lanes on: within F32_EVAL_TOL
    of its plain version on the f32 and bf16 nets, exact on the int8 net;
    the bf16 entry equal to the f32 kernel on the widened weights."""
    p = nnue.cast_params(nets["f32"]) if net == "bf16" else nets[net]
    acc, stm, bucket = k2_inputs(batch, batch, "int8" if net == "int8" else "f32", card)
    kernels.reset_launches()
    got = nnue.forward_from_acc(p, acc, stm, bucket)
    assert kernels.LAUNCHES["nnue_forward_from_acc"] == 1
    want = nnue.forward_from_acc_plain(p, acc, stm, bucket)
    tol = 0.0 if net == "int8" else nnue.F32_EVAL_TOL
    assert got.shape == want.shape and float((got - want).abs().max()) <= tol
    if net == "bf16":
        wide = nnue.forward_from_acc(nnue.widened(p), acc, stm, bucket)
        assert torch.equal(got.view(torch.int32), wide.view(torch.int32))


@pytest.mark.parametrize("variant", ["standard", "antichess", "crazyhouse"])
def test_move_generator_on_long_and_tied_lists(card, variant):
    """K9 on chip_smoke.MOVEGEN_LONG's fixtures (exactly 64 and 65 moves,
    the 218-move position, crazyhouse lists of 299 and 435, a castling
    right without its rook, antichess with and without a capture, every
    key class), with and without killers and history: equal to the plain
    version, exactly."""
    _, b, killers, hist = movegen_long_inputs(variant, card)
    for kw in ({}, {"killers": killers, "hist": hist}):
        got = tm.generate_moves(b, variant=variant, **kw)
        want = tm.generate_moves_plain(b, variant=variant, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


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
    kernels.reset_launches()
    card = search_batch(nets["int8"], roots, 2, 100_000, max_ply=6)
    assert kernels.LAUNCHES["search_segment"] >= 1
    # K1 refreshes the roots; every other body runs inside K11 only
    assert all(kernels.LAUNCHES[k] == 0 for k in kernels.K11_BODIES
               if k != "nnue_refresh_768"), kernels.LAUNCHES
    cpu = search_batch(nets["int8"].to("cpu"), roots.to("cpu"), 2, 100_000, max_ply=6,
                       device="cpu")
    for k in ("score", "move", "nodes", "pv", "pv_len", "done"):
        assert (card[k] == cpu[k]).all(), k
    assert card["steps"] == cpu["steps"]


@pytest.mark.parametrize("lanes,size_log2", [(16, 3), (64, 21), (1024, 6), (1024, 21),
                                             (3000, 10), (8192, 6), (8192, 21)])
def test_tt_kernels_match_plain_versions(card, lanes, size_log2):
    """K5 and K6 equal their plain versions bit for bit, on contiguous
    inputs and on the runner's strided and broadcast ones: 1024 lanes
    into 64 slots force collisions (the highest storable lane wins), 64
    lanes into 2^21 slots is the engine's dispatch, 3000 and 8192 lanes
    span many blocks of K6's claim and commit launches."""
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


@pytest.mark.parametrize("lanes", [1024, 8192])
@pytest.mark.parametrize("size_log2", [6, 21])
def test_tt_store_on_four_slots_matches_plain_version(card, lanes, size_log2):
    """K6 with every lane's key on one of four slots equals its plain
    version bit for bit, plain and prefer_deep (one generation, and mixed
    per-lane ones against the table's mixed generations), and leaves its
    stream's claim words free."""
    c = tt_inputs(lanes, size_log2, lanes + size_log2 + 4, card, n_slots=4)
    gen_lanes = torch.randint(0, 3, (lanes,), dtype=torch.int32, device=card)
    args = [c[k] for k in TT_STORE_ARGS]
    for prefer, gen in ((False, None), (True, 1), (True, gen_lanes)):
        got, want = c["table"].clone(), c["table"].clone()
        tt.store(got, *args, prefer_deep=prefer, gen=gen)
        tt.store_plain(want, *args, prefer_deep=prefer, gen=gen)
        assert torch.equal(got, want)
        assert 0 < int((want != c["table"]).any(1).sum()) <= 4
    assert bool((kernels._claim_words(card, 1 << size_log2) == -1).all())


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
    with pytest.raises(ValueError):  # a mask of another width
        kernels.tt_store(c["table"], *[c[k] for k in TT_STORE_ARGS[:-1]], c["mask"][:32],
                         False)
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


@pytest.mark.parametrize("net", ["f32", "int8"])
@pytest.mark.parametrize("batch,lanes", [(16, 16), (16, 4), (64, 64), (64, 16), (1024, 1024),
                                         (1024, 256)])
def test_lane_init_matches_plain_version(nets, net, batch, lanes):
    """K7 over every lane (init_state's call) and over a scattered
    quarter (a refill splice) of a state of seeded garbage: every table
    equals the plain version's bit for bit, so the lanes not listed are
    untouched."""
    state, idx, args = lane_init_case(nets[net], batch, lanes, batch + lanes, nets[net].device,
                                      tm.MAX_MOVES)
    want = search.SearchState(*[t.clone() for t in state])
    kernels.reset_launches()
    kernels.lane_init(state, idx, *args)
    search.lane_init_plain(want, idx, *args)
    assert kernels.LAUNCHES["lane_init"] == 1
    for g, w in zip(state, want):
        assert torch.equal(g, w)


def test_lane_init_wrapper_checks_inputs(nets):
    state, idx, args = lane_init_case(nets["int8"], 16, 4, 3, nets["int8"].device, tm.MAX_MOVES)
    kernels.reset_launches()
    with pytest.raises(TypeError):  # the int8 net's accumulators are int32
        kernels.lane_init(state, idx, args[0], args[1].float(), *args[2:])
    with pytest.raises(TypeError):
        kernels.lane_init(state, idx.int(), *args)
    with pytest.raises(ValueError):
        kernels.lane_init(state, idx[:2], *args)
    with pytest.raises(ValueError):
        kernels.lane_init(search.SearchState(*[t.cpu() for t in state]), idx.cpu(),
                          *[a.cpu() for a in args])
    assert kernels.LAUNCHES["lane_init"] == 0


def test_int8_refill_and_stream_card_equal_cpu(nets, lanes):
    """A 16-lane int8 state stepped mid-search then spliced (K1 + K7),
    and a stream of 24 positions through 16 lanes into a table: the card
    equals the CPU, states and tables byte for byte."""
    b, _ = lanes
    roots = tb.Board(*[t[:16] for t in b])
    new = tb.Board(*[t[16:21] for t in b])
    depth = np.asarray([1 + i % 3 for i in range(16)], np.int32)
    states = {}
    for dev in ("cuda", "cpu"):
        p = nets["int8"].to(dev)
        st = search.init_state(p, roots.to(dev), torch.from_numpy(depth).to(dev),
                               torch.full((16,), 100_000, dtype=torch.int32, device=dev), 6)
        search.run_segment(p, st, 40)
        search.refill_lanes(p, st, new.to(dev), [3, 0, 9, 15, 7], [2, 3, 1, 2, 1],
                            [500, 1, 0, 99_999, 12], order_jitter=np.asarray([0, 5, -3, 9, 1]),
                            root_alpha=np.asarray([-50, -32500, 10, -100, 0]),
                            root_beta=np.asarray([50, 32500, 40, 100, 20]))
        states[dev] = st
    for g, w in zip(states["cuda"], states["cpu"]):
        assert torch.equal(g.cpu(), w)
    roots = tb.Board(*[t[:24] for t in b])
    depth = np.asarray([1 + i % 3 for i in range(24)], np.int32)
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = search_stream(nets["int8"].to(dev), roots.to(dev), depth, 100_000,
                                  max_ply=6, width=16, segment_steps=48,
                                  tt=tt.make_table(14, device=dev), prefer_deep_store=True,
                                  device=dev)
    card, cpu = outs["cuda"], outs["cpu"]
    for k in ("score", "move", "nodes", "pv", "pv_len", "done"):
        assert (card[k] == cpu[k]).all(), k
    assert (card["steps"], card["refills"]) == (cpu["steps"], cpu["refills"])
    assert torch.equal(card["tt"].cpu(), cpu["tt"])


@pytest.mark.parametrize("variant", ("standard",) + VARIANTS)
@pytest.mark.parametrize("lanes", [16, 64, 1024])
def test_board_kernels_match_plain_versions(card, lanes, variant):
    """In each device variant: K9 with and without killers and history,
    K10 over every generated move from packed rows, K8 and K4 on the
    boards and on every child: equal to the plain versions, exactly, one
    launch each."""
    b, killers, hist = rules_inputs(lanes, lanes, card, variant)
    for kw in ({}, {"killers": killers, "hist": hist}):
        got = tm.generate_moves(b, variant=variant, **kw)
        want = tm.generate_moves_plain(b, variant=variant, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    pb, pm = every_move(b, *want[:2])
    rows = tb.rows_from_board(pb)
    want = tb.make_move_rows_plain(rows, pm, variant)
    for g, w in zip(tb.make_move_rows(rows, pm, variant), want):
        assert torch.equal(g, w)
    z1, z2 = tt.tables(card)
    for boards in (b, tb.board_from_rows(want[0])):
        kernels.reset_launches()
        got = tb.node_rules(boards, variant=variant)
        keys = tt.hash_boards(boards, variant)
        assert kernels.LAUNCHES["node_rules"] == kernels.LAUNCHES["zobrist_hash"] == 1
        for g, w in zip(got, tb.node_rules_plain(boards, variant=variant)):
            assert torch.equal(g, w)
        assert torch.equal(keys, tt.hash_board_plain(boards.board, boards.stm, boards.ep,
                                                     boards.castling, z1, z2, boards.extra,
                                                     variant))


def test_board_wrappers_check_inputs_and_count_launches(card):
    b, killers, hist = rules_inputs(16, 3, card)
    kernels.reset_launches()
    tb.node_rules(b)
    moves, count, _ = tm.generate_moves(b, killers, hist)
    tb.make_move_with_changes(b, moves[:, 0].clamp(min=0))
    assert [kernels.LAUNCHES[k] for k in ("node_rules", "generate_moves", "make_move")] == [1] * 3
    mv = moves[:, 0].clamp(min=0)
    with pytest.raises(TypeError):
        kernels.node_rules(b.board.long(), b.stm)
    with pytest.raises(ValueError):  # rows must be contiguous
        kernels.node_rules(b.board.t().contiguous().t(), b.stm)
    with pytest.raises(ValueError):
        kernels.generate_moves(b.board, b.stm, b.ep, b.castling, killers[:, :1], hist)
    with pytest.raises(ValueError):
        kernels.generate_moves(b.board, b.stm, b.ep, b.castling, killers, hist[:8])
    with pytest.raises(TypeError):
        kernels.make_move(*b, mv.long())
    with pytest.raises(ValueError):
        kernels.make_move(*b.to("cpu"), mv.cpu())
    assert [kernels.LAUNCHES[k] for k in ("node_rules", "generate_moves", "make_move")] == [1] * 3


def test_step_on_the_card_runs_no_plain_board_code(card, nets, lanes, monkeypatch):
    """On a CUDA state the step reaches K8-K10, never the plain versions'
    ray views, attack maps, candidate space or sort; the state it leaves
    equals the CPU step's."""
    b, _ = lanes
    roots = tb.Board(*[t[:16] for t in b])
    depth = torch.full((16,), 3, dtype=torch.int32)
    budget = torch.full((16,), 100_000, dtype=torch.int32)
    cpu = search.init_state(nets["int8"].to("cpu"), roots.to("cpu"), depth, budget, 6)
    for _ in range(30):
        search._step(nets["int8"].to("cpu"), cpu, True)

    def refuse(*args, **kwargs):
        raise AssertionError("plain board code on a CUDA state")

    for mod, name in ((search, "rays_of"), (search, "attack_parts"), (tb, "rays_of"),
                      (tb, "attack_parts"), (tm, "rays_of"), (tm, "attack_parts"),
                      (tm, "_candidate_space"), (torch, "sort")):
        monkeypatch.setattr(mod, name, refuse)
    st = search.init_state(nets["int8"], roots.to(card), depth.to(card), budget.to(card), 6)
    kernels.reset_launches()
    for _ in range(30):
        search._step(nets["int8"], st, True)
    assert [kernels.LAUNCHES[k] for k in ("node_rules", "generate_moves", "make_move")] == [30] * 3
    for g, w in zip(st, cpu):
        assert torch.equal(g.cpu(), w)


def _same_state(a, b, ta=None, tb_=None):
    for x, y in zip(a, b):
        if x.dtype == torch.float32:  # compared as bits
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)
    if ta is not None:
        assert torch.equal(ta, tb_)


@pytest.mark.parametrize("cfg", ["no table", "table", "helpers"])
@pytest.mark.parametrize("net", ["f32", "int8"])
@pytest.mark.parametrize("batch", [16, 64, 1024])
def test_segment_kernel_matches_plain_version(nets, batch, net, cfg):
    """K11 against run_segment_plain on chip_smoke's seeded states, over
    segments of 1, 33 and 100 steps: every state table (floats as bits),
    the table and the summary equal, the step counts equal, one launch a
    segment."""
    params = nets[net]
    state, table, kw = segment_case(params, batch, cfg, batch + 1, params.device)
    plain = search.SearchState(*[t.clone() for t in state])
    plain_table = None if table is None else table.clone()
    for steps in (1, 33, 100):
        kernels.reset_launches()
        n_k, sum_k = search.run_segment(params, state, steps, True, **kw)
        assert kernels.LAUNCHES["search_segment"] == 1
        n_p, sum_p = search.run_segment_plain(params, plain, steps, True,
                                              **dict(kw, table=plain_table))
        assert n_k == n_p == steps
        assert torch.equal(sum_k, sum_p)
        _same_state(state, plain, table, plain_table)


@pytest.mark.parametrize("net", ["f32", "int8"])
@pytest.mark.parametrize("batch", [16, 64])
def test_segment_kernel_on_colliding_store_phases(nets, batch, net):
    """K11 on chip_smoke's "tiny" setup (the main path's rules and
    helpers into 2^6 slots, so a step's leaf stores and the next step's
    probes and interior stores share slots) against run_segment_plain
    over segments of 1, 33 and 100 steps (16 lanes: then one in which
    every lane finishes), byte for byte; K11 counts reads through a
    store's pending rows, and leaves every claim word free."""
    params = nets[net]
    state, table, kw = segment_case(params, batch, "tiny", batch + 1, params.device)
    plain = search.SearchState(*[t.clone() for t in state])
    plain_table = table.clone()
    kernels.reset_launches()
    for steps in (1, 33, 100) + ((FINISH_STEPS,) if batch == 16 else ()):
        n_k, sum_k = search.run_segment(params, state, steps, True, **kw)
        n_p, sum_p = search.run_segment_plain(params, plain, steps, True,
                                              **dict(kw, table=plain_table))
        assert n_k == n_p and (n_k == steps or steps == FINISH_STEPS > n_k)
        assert torch.equal(sum_k, sum_p)
        _same_state(state, plain, table, plain_table)
    assert kernels.body_calls()["pending_reads"] > 0
    assert bool((kernels._claim_words(params.device, table.shape[0]) == -1).all())


def test_segment_on_the_card_runs_no_pytorch_step(card, nets, lanes, monkeypatch):
    """On a CUDA state run_segment is one K11 launch: it reaches none of
    the plain step, the TT runner or the step kernels' wrappers, and the
    state and table it leaves equal the CPU's plain segment's."""
    b, _ = lanes
    roots = tb.Board(*[t[:16] for t in b])
    depth = torch.full((16,), 3, dtype=torch.int32)
    budget = torch.full((16,), 100_000, dtype=torch.int32)
    cpu = search.init_state(nets["int8"].to("cpu"), roots.to("cpu"), depth, budget, 6)
    cpu_table = tt.make_table(12, device="cpu")
    search.run_segment_plain(nets["int8"].to("cpu"), cpu, 60, True, cpu_table, False, True, 3)

    def refuse(*args, **kwargs):
        raise AssertionError("PyTorch step code on a CUDA state")

    st = search.init_state(nets["int8"], roots.to(card), depth.to(card), budget.to(card), 6)
    table = tt.make_table(12, device=card)
    for mod, name in ((search, "_step"), (search, "_tt_step"), (search, "run_segment_plain"),
                      (nnue, "forward_from_acc"), (nnue, "apply_acc_updates_768"),
                      (tt, "hash_board"), (tt, "probe"), (tt, "store"), (tb, "node_rules"),
                      (tb, "make_move_rows"), (tm, "generate_moves")):
        monkeypatch.setattr(mod, name, refuse)
    kernels.reset_launches()
    n, summary = search.run_segment(nets["int8"], st, 60, True, table, False, True, 3)
    assert n == 60 and int(summary[16, search.SUM_DONE]) == 60
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"search_segment": 1}
    calls = kernels.body_calls()
    assert calls["generate_moves"] > 0 and calls["tt_store"] > 0
    _same_state([t.cpu() for t in st], cpu, table.cpu(), cpu_table)


def test_segment_wrapper_checks_inputs(card, nets):
    params = nets["int8"]
    state, table, kw = segment_case(params, 16, "helpers", 5, card)
    kernels.reset_launches()
    with pytest.raises(ValueError):  # the table on another device
        kernels.search_segment(params, state, 5, True, table.cpu())
    with pytest.raises(ValueError):  # per-lane generations of another width
        kernels.search_segment(params, state, 5, True, table, gen=kw["tt_gen"][:8])
    with pytest.raises(TypeError):  # the f32 net on int32 accumulators
        kernels.search_segment(nets["f32"], state, 5, True)
    with pytest.raises(ValueError):
        kernels.search_segment(params.to("cpu"), state, 5, True)
    assert kernels.LAUNCHES["search_segment"] == 0


@pytest.fixture(scope="module")
def full_nets(card):
    """The full-eval nets: a king-bucketed one at init_params' widths
    (f32 and int8) and seeded Stockfish nets at L1 128 and 3072."""
    kb = nnue.params_from_numpy(kb_case(256, 16, 32, seed=3), card)
    return {"kb f32": kb, "kb int8": nnue.quantize_int8(kb),
            "sf 128": ni.load_nnue(sf_file(128, 3), device=card),
            "sf 3072": ni.load_nnue(sf_file(3072, 3), device=card)}


@pytest.mark.parametrize("net", ["kb f32", "kb int8", "sf 128", "sf 3072"])
@pytest.mark.parametrize("batch", [16, 64, 1024])
def test_full_eval_kernels_match_plain_versions(full_nets, net, batch):
    """K12 (the king-bucketed net) and K13 (the Stockfish nets) against
    their plain versions: the int8 net exactly, f32 within F32_EVAL_TOL;
    one launch each, on strided board rows as the plain step passes them."""
    p = full_nets[net]
    b = playout_boards(batch, seed=batch + 9)[0].to(p.device)
    rows = torch.zeros((batch, 96), dtype=torch.int32, device=p.device)
    rows[:, :64] = b.board
    rows[:, 64] = b.stm
    boards, stm = rows[:, :64], rows[:, 64]
    kernels.reset_launches()
    got = nnue.evaluate(p, boards, stm)
    name = "nnue_evaluate_sf" if net.startswith("sf") else "nnue_evaluate"
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {name: 1}
    plain = ni.evaluate_sf_plain if net.startswith("sf") else nnue.evaluate_plain
    want = plain(p, b.board, b.stm)
    tol = 0.0 if net == "kb int8" else nnue.F32_EVAL_TOL
    assert got.dtype == want.dtype == torch.float32 and got.shape == (batch,)
    assert float((got.double() - want.double()).abs().max()) <= tol


def test_full_eval_wrappers_refuse_bad_inputs(card, full_nets):
    b = playout_boards(16, seed=2)[0].to(card)
    kb, sf = full_nets["kb f32"], full_nets["sf 128"]
    kernels.reset_launches()
    with pytest.raises(ValueError):  # odd L1
        kernels.nnue_evaluate_sf(b.board, b.stm, ni.StockfishNet(
            **{f: getattr(sf, f)[..., :127] if f in ("ft_w", "ft_b", "fc0_w") else getattr(sf, f)
               for f in ni.ARRAY_FIELDS}))
    wide = torch.zeros((1, 1), device=card).expand(nnue.NUM_FEATURES, 3074)
    with pytest.raises(ValueError):  # L1 past 3072
        kernels.nnue_evaluate_sf(b.board, b.stm, ni.StockfishNet(
            **{f: wide if f == "ft_w" else getattr(sf, f) for f in ni.ARRAY_FIELDS}))
    with pytest.raises(ValueError):
        kernels.nnue_evaluate(b.board, b.stm, kb._replace(ft_w=wide))
    with pytest.raises(ValueError):  # CPU tensors
        kernels.nnue_evaluate(b.board.cpu(), b.stm.cpu(), kb)
    with pytest.raises(ValueError):  # the net on the CPU
        kernels.nnue_evaluate_sf(b.board, b.stm, sf.to("cpu"))
    with pytest.raises(TypeError):  # wrong dtypes
        kernels.nnue_evaluate(b.board.long(), b.stm, kb)
    with pytest.raises(TypeError):
        kernels.nnue_evaluate_sf(b.board, b.stm, ni.StockfishNet(
            **{f: getattr(sf, f).double() for f in ni.ARRAY_FIELDS}))
    with pytest.raises(TypeError):  # ft_b of the f32 net on the int8 net
        kernels.nnue_evaluate(b.board, b.stm, full_nets["kb int8"]._replace(ft_b=kb.ft_b))
    with pytest.raises(ValueError):  # K2 is built for the shipped board768 widths only
        kernels.nnue_forward_from_acc(nnue.accumulators(kb, b.board), b.stm,
                                      nnue.output_bucket(b.board), kb)
    assert kernels.LAUNCHES["nnue_evaluate"] == kernels.LAUNCHES["nnue_evaluate_sf"] == 0
    assert kernels.LAUNCHES["nnue_forward_from_acc"] == 0


@pytest.mark.parametrize("net,cfg,variant", [
    ("kb int8", "no table", "standard"), ("kb int8", "table", "standard"),
    ("kb f32", "helpers", "standard"), ("sf 3072", "helpers", "standard"),
    ("sf 128", "table", "standard"), ("kb int8", "helpers", "atomic")])
def test_segment_kernel_on_full_eval_nets(full_nets, net, cfg, variant):
    """K11 on the king-bucketed and Stockfish nets against
    run_segment_plain (whose step launches K12's or K13's kernel): states,
    tables and summaries byte for byte; K11 launches none of its bodies'
    kernels on its own, runs the net's eval body and never K1, K2 or K3
    (in atomic too, whose rules branches run under K12's body)."""
    params = full_nets[net]
    state, table, kw = segment_case(params, 64, cfg, 17, params.device, variant=variant)
    plain = search.SearchState(*[t.clone() for t in state])
    plain_table = None if table is None else table.clone()
    body = "nnue_evaluate_sf" if net.startswith("sf") else "nnue_evaluate"
    for steps in (1, 40, 100):
        kernels.reset_launches()
        n_k, sum_k = search.run_segment(params, state, steps, True, **kw)
        assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {"search_segment": 1}
        calls = kernels.body_calls()
        assert calls[body] > 0
        assert calls["nnue_forward_from_acc"] == calls["nnue_acc_update_768"] == 0
        assert calls["nnue_refresh_768"] == 0
        n_p, sum_p = search.run_segment_plain(params, plain, steps, True,
                                              **dict(kw, table=plain_table))
        assert n_k == n_p
        assert torch.equal(sum_k, sum_p)
        _same_state(state, plain, table, plain_table)
    assert not state.acc.any()  # a full-eval net leaves the accumulators zero


@pytest.mark.parametrize("l1", SF_EVAL_WIDTHS)
def test_stockfish_eval_on_every_bucket_and_king_square(card, l1):
    """K13 on tests/test_torch_sf_eval.py's boards (every output bucket,
    every mirrored king square, both sides to move) at L1 128, 200 (a
    partly used unit slice) and 130 (4-byte loads): within F32_EVAL_TOL of
    its plain version, the same bytes on a repeated call and on strided
    board rows, one counted launch a call."""
    net = ni.stockfish_net_from_numpy(sf_eval_net(l1), card)
    boards, stm = (torch.from_numpy(a).to(card) for a in sf_eval_boards())
    rows = torch.zeros((len(stm), 96), dtype=torch.int32, device=card)
    rows[:, :64], rows[:, 64] = boards, stm
    kernels.reset_launches()
    got = kernels.nnue_evaluate_sf(boards, stm, net)
    again = kernels.nnue_evaluate_sf(rows[:, :64], rows[:, 64], net)
    assert kernels.LAUNCHES["nnue_evaluate_sf"] == 2
    assert torch.equal(got, again)
    want = ni.evaluate_sf_plain(net, boards, stm)
    assert float((got.double() - want.double()).abs().max()) <= nnue.F32_EVAL_TOL


@pytest.mark.parametrize("batch,live,net", [
    (64, 1, "sf 3072"), (64, 2, "sf 3072"), (64, 64, "sf 3072"), (16, 16, "sf 3072"),
    (1024, 1024, "sf 3072"), (64, 64, "sf 130"), (64, 2, "sf 128")])
def test_segment_kernel_spreads_stockfish_evals(full_nets, batch, live, net):
    """K11 on a Stockfish net with `live` lanes of `batch` stepping (the
    rest parked DONE), so 1, 2 or every lane evaluates in a step and the
    others' warps run its units: states, tables and summaries byte for byte
    run_segment_plain's (whose step launches K13's kernel, the same units);
    one eval body call an entered node: as many as K8's calls, no fewer
    than the nodes the lanes counted, no more than one a live lane a step.
    L1 130 takes 4-byte loads."""
    params = (ni.stockfish_net_from_numpy(sf_eval_net(130), full_nets["sf 128"].device)
              if net == "sf 130" else full_nets[net])
    state, table, kw = segment_case(params, batch, "engine", 23, params.device)
    state.lane[live:, search.LN_MODE] = search.MODE_DONE
    plain = search.SearchState(*[t.clone() for t in state])
    plain_table = table.clone()
    evals = 0
    for steps in (1, 30, 90):
        nodes0 = int(state.lane[:, search.LN_NODES].sum())
        kernels.reset_launches()
        n_k, sum_k = search.run_segment(params, state, steps, True, **kw)
        calls = kernels.body_calls()
        n_p, sum_p = search.run_segment_plain(params, plain, steps, True,
                                              **dict(kw, table=plain_table))
        assert n_k == n_p and torch.equal(sum_k, sum_p)
        _same_state(state, plain, table, plain_table)
        nodes = int(plain.lane[:, search.LN_NODES].sum()) - nodes0  # an entered legal node each
        assert nodes <= calls["nnue_evaluate_sf"] == calls["node_rules"] <= live * n_k
        evals += calls["nnue_evaluate_sf"]
    assert evals > 0
    assert (state.lane[live:, search.LN_MODE] == search.MODE_DONE).all()


@pytest.mark.parametrize("case", KB_REFRESH_CASES, ids=[c[0] for c in KB_REFRESH_CASES])
def test_king_bucketed_refresh_on_every_width_and_view(card, case):
    """K17 byte for byte its plain version on the card and on the CPU at
    L1 64, a tp shard's 32 columns, odd 33, 1040 and a view one float into
    its buffer (4-byte loads), on a repeated call too."""
    boards, w, b, (full_w, full_b), cols = kb_refresh_case(case, card)
    params = nnue.NnueParams(w, b, *[torch.zeros(1, device=card)] * 6)
    want = nnue.accumulators(params, boards)
    cpu = nnue.accumulators(params.to("cpu"), boards.cpu())
    kernels.reset_launches()
    for _ in range(2):
        got = kernels.nnue_refresh_kb(boards, w, b)
        assert torch.equal(got, want) and torch.equal(got.cpu(), cpu)
    assert torch.equal(nnue.accumulators_kb(params, boards), want)
    assert kernels.LAUNCHES["nnue_refresh_kb"] == 3
    whole = nnue.accumulators(nnue.NnueParams(full_w, full_b, *params[2:]), boards)
    assert torch.equal(want, whole[:, :, cols])


def test_int8_king_bucketed_search_card_equals_cpu(full_nets, lanes):
    b, _ = lanes
    roots = tb.Board(*[t[:16] for t in b])
    net = full_nets["kb int8"]
    kernels.reset_launches()
    card = search_batch(net, roots, 2, 100_000, max_ply=6)
    assert kernels.LAUNCHES["nnue_refresh_768"] == 0
    assert all(kernels.LAUNCHES[k] == 0 for k in kernels.K11_BODIES), kernels.LAUNCHES
    cpu = search_batch(net.to("cpu"), roots.to("cpu"), 2, 100_000, max_ply=6, device="cpu")
    for k in ("score", "move", "nodes", "pv", "pv_len", "done"):
        assert (card[k] == cpu[k]).all(), k
    assert card["steps"] == cpu["steps"]


@pytest.mark.parametrize("batch", [16, 512])
def test_training_kernels_match_plain_versions(card, batch):
    """K14 within TRAIN_GRAD_RTOL of its plain version and the same bytes
    on a repeated launch; K15 byte for byte the plain version run on the
    CPU, the same bytes repeated and within TRAIN_GRAD_RTOL of the plain
    version run on the card; K16 equal to its plain version."""
    c = train_case(batch, seed=batch + 3, dev=card)
    p, acc, stms, bucket, d_pred, boards = (
        c[k] for k in ("params", "acc", "stms", "bucket", "d_pred", "boards"))
    kernels.reset_launches()
    g1, g2 = (torch.empty(kernels.STACK_GRADS, device=card) for _ in range(2))
    d1 = train.stack_backward(p, acc, stms, bucket, d_pred, g1)
    d2 = train.stack_backward(p, acc, stms, bucket, d_pred, g2)
    assert torch.equal(d1, d2) and torch.equal(g1, g2)
    d_p, grads_p = train.stack_backward_plain(p, acc, stms, bucket, d_pred)
    assert _rel_err(d1, d_p) <= TRAIN_GRAD_RTOL
    for got, want in zip(g1.split([g.numel() for g in grads_p]), grads_p):
        assert _rel_err(got, want.reshape(-1)) <= TRAIN_GRAD_RTOL
    n_ft = (nnue.NUM_FEATURES_768 + 1) * p.l1
    f1, f2 = (torch.empty(n_ft, device=card) for _ in range(2))
    train.ft_backward_768(boards, d_p, f1)
    train.ft_backward_768(boards, d_p, f2)
    assert torch.equal(f1, f2)
    want = torch.cat([t.reshape(-1) for t in train.ft_backward_768_plain(boards, d_p)])
    assert _rel_err(f1, want) <= TRAIN_GRAD_RTOL
    cpu = torch.cat([t.reshape(-1) for t in train.ft_backward_768_plain(boards.cpu(), d_p.cpu())])
    assert torch.equal(f1.cpu().view(torch.int32), cpu.view(torch.int32))
    opt = train.Adam(2e-3)
    bc = opt.bias_corrections(c["count"] + 1)
    k = [train.flat_view(p).clone(), c["grad"], c["mu"].clone(), c["nu"].clone()]
    q = [train.flat_view(p).clone(), c["grad"], c["mu"].clone(), c["nu"].clone()]
    kernels.adam_update(*k, opt.lr, opt.b1, opt.b2, opt.eps, *bc)
    train.adam_update_plain(*q, opt.lr, opt.b1, opt.b2, opt.eps, *bc)
    assert all(torch.equal(a, b) for a, b in zip(k, q))
    assert {n: v for n, v in kernels.LAUNCHES.items() if v} == {
        "nnue_stack_backward": 2, "nnue_ft_backward_768": 2, "adam_update": 1}


def test_training_wrappers_refuse_bad_inputs(card):
    c = train_case(16, seed=5, dev=card)
    p, acc, stms, bucket, d_pred, boards = (
        c[k] for k in ("params", "acc", "stms", "bucket", "d_pred", "boards"))
    g = torch.empty(kernels.STACK_GRADS, device=card)
    kernels.reset_launches()
    with pytest.raises(ValueError):  # a grad buffer of the wrong length
        kernels.nnue_stack_backward(acc, stms, bucket, d_pred, p, g[:-1])
    with pytest.raises(ValueError):  # the int8 net
        kernels.nnue_stack_backward(acc, stms, bucket, d_pred, nnue.quantize_int8(p), g)
    with pytest.raises(TypeError):
        kernels.nnue_stack_backward(acc, stms.long(), bucket, d_pred, p, g)
    with pytest.raises(ValueError):  # CPU tensors
        kernels.nnue_ft_backward_768(acc.cpu(), boards.cpu(), g.cpu())
    with pytest.raises(ValueError):  # a non-contiguous d_acc
        kernels.nnue_ft_backward_768(acc.transpose(0, 1).contiguous().transpose(0, 1), boards,
                                     torch.empty((768 + 1) * 64, device=card))
    with pytest.raises(ValueError):  # an empty batch
        kernels.nnue_ft_backward_768(acc[:0], boards[:0], torch.empty((768 + 1) * 64, device=card))
    wide = torch.zeros((16, 2, kernels.MAX_L1 + 1), device=card)
    with pytest.raises(ValueError):  # more columns than MAX_L1
        kernels.nnue_ft_backward_768(wide, boards, torch.empty(769 * wide.shape[2], device=card))
    with pytest.raises(ValueError):  # no such pass
        kernels.nnue_ft_backward_768(acc, boards, torch.empty(769 * 64, device=card), stages=3)
    flat = train.flat_view(p)
    with pytest.raises(ValueError):  # buffers of different lengths
        kernels.adam_update(flat, c["grad"][:-1], c["mu"], c["nu"], 1e-3, 0.9, 0.999, 1e-8,
                            0.1, 0.001)
    with pytest.raises(TypeError):
        kernels.adam_update(flat, c["grad"].double(), c["mu"], c["nu"], 1e-3, 0.9, 0.999,
                            1e-8, 0.1, 0.001)
    assert not any(kernels.LAUNCHES.values())


def test_training_steps_on_the_card_run_no_plain_code(card, monkeypatch):
    """Three train steps at batch 64 on the card launch K1, K2 and K14-K16
    once a step and none of their plain versions, and agree with the same
    steps on the CPU (losses within TRAIN_LOSS_RTOL, params within
    TRAIN_PARAM_ATOL)."""
    dataset = train.diverse_position_dataset(256, seed=2)
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 256, size=64) for _ in range(3)]
    results = {}
    for dev in ("cpu", "cuda"):
        if dev == "cuda":
            for mod, name in ((nnue, "accumulators_768_plain"), (nnue, "forward_from_acc_plain"),
                              (train, "stack_backward_plain"), (train, "ft_backward_768_plain"),
                              (train, "adam_update_plain")):
                monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: pytest.fail(_n))
        params = train.pack_params(nnue.init_params(torch.Generator().manual_seed(2), l1=64,
                                                    feature_set="board768", device=dev))
        opt = train.adam(2e-3)
        state = opt.init(params)
        step = train.make_train_step(opt)
        kernels.reset_launches()
        losses = []
        for idx in batches:
            params, state, loss = step(params, state,
                                       *[torch.from_numpy(a[idx]).to(dev) for a in dataset])
            losses.append(float(loss))
        results[dev] = (losses, train.flat_view(params).cpu())
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    assert launches == {k: 3 for k in ("nnue_refresh_768", "nnue_forward_from_acc",
                                       "nnue_stack_backward", "nnue_ft_backward_768",
                                       "adam_update")}
    (cpu_losses, cpu_params), (card_losses, card_params) = results["cpu"], results["cuda"]
    for a, b in zip(card_losses, cpu_losses):
        assert abs(a - b) <= TRAIN_LOSS_RTOL * abs(b)
    assert float((card_params - cpu_params).abs().max()) <= TRAIN_PARAM_ATOL


@pytest.mark.parametrize("batch", [32, 512])
def test_king_bucketed_training_kernels_match_plain_versions(card, batch):
    """K17 equal to its plain version byte for byte, also on a tp shard's
    half of the columns; K18 byte for byte the plain version run on the
    CPU, the same bytes on a repeated launch and within TRAIN_GRAD_RTOL of
    the plain version run on the card."""
    c = kb_train_case(batch, seed=batch + 9, dev=card)
    p, boards, d_acc = c["params"], c["boards"], c["d_acc"]
    kernels.reset_launches()
    acc = nnue.accumulators_kb(p, boards)
    assert torch.equal(acc, nnue.accumulators(p, boards))
    half = p._replace(ft_w=p.ft_w[:, :32].contiguous(), ft_b=p.ft_b[:32].contiguous())
    assert torch.equal(nnue.accumulators_kb(half, boards), acc[:, :, :32])
    n_ft = (nnue.NUM_FEATURES + 1) * 64
    f1, f2 = (torch.empty(n_ft, device=card) for _ in range(2))
    train.ft_backward_kb(boards, d_acc, f1)
    train.ft_backward_kb(boards, d_acc, f2)
    assert torch.equal(f1, f2)
    want = torch.cat([t.reshape(-1) for t in train.ft_backward_kb_plain(boards, d_acc)])
    assert _rel_err(f1, want) <= TRAIN_GRAD_RTOL
    cpu = torch.cat([t.reshape(-1) for t in train.ft_backward_kb_plain(boards.cpu(), d_acc.cpu())])
    assert torch.equal(f1.cpu().view(torch.int32), cpu.view(torch.int32))
    assert {n: v for n, v in kernels.LAUNCHES.items() if v} == {
        "nnue_refresh_kb": 2, "nnue_ft_backward_kb": 2}


def test_king_bucketed_training_wrappers_refuse_bad_inputs(card):
    c = kb_train_case(16, seed=3, dev=card)
    p, boards, d_acc = c["params"], c["boards"], c["d_acc"]
    n_ft = (nnue.NUM_FEATURES + 1) * 64
    kernels.reset_launches()
    with pytest.raises(ValueError):  # CPU tensors
        kernels.nnue_refresh_kb(boards.cpu(), p.ft_w.cpu(), p.ft_b.cpu())
    with pytest.raises(ValueError):  # a board768 table
        kernels.nnue_refresh_kb(boards, p.ft_w[:768].contiguous(), p.ft_b)
    with pytest.raises(TypeError):
        kernels.nnue_refresh_kb(boards.long(), p.ft_w, p.ft_b)
    with pytest.raises(ValueError):  # a gradient buffer of the wrong length
        kernels.nnue_ft_backward_kb(d_acc, boards, torch.empty(n_ft - 1, device=card))
    with pytest.raises(ValueError):  # an empty batch
        kernels.nnue_ft_backward_kb(d_acc[:0], boards[:0], torch.empty(n_ft, device=card))
    with pytest.raises(ValueError):  # a non-contiguous d_acc
        kernels.nnue_ft_backward_kb(d_acc.transpose(0, 1).contiguous().transpose(0, 1), boards,
                                    torch.empty(n_ft, device=card))
    wide = torch.zeros((16, 2, kernels.MAX_L1 + 1), device=card)
    with pytest.raises(ValueError):  # more columns than MAX_L1
        kernels.nnue_ft_backward_kb(wide, boards,
                                    torch.empty((nnue.NUM_FEATURES + 1) * wide.shape[2],
                                                device=card))
    many = torch.zeros((kernels.FT_WINDOW // 2 + 1, 2, 64), device=card)
    with pytest.raises(ValueError):  # one pass alone on more than one window
        kernels.nnue_ft_backward_kb(many, torch.zeros((many.shape[0], 64), dtype=torch.int32,
                                                      device=card),
                                    torch.empty(n_ft, device=card), stages=2)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("feature_set", ["board768", "halfkav2_hm"])
@pytest.mark.parametrize("case", [("seeded 16", 16, 64, "seeded"), ("seeded 32", 32, 64, "seeded"),
                                  ("seeded 512", 512, 64, "seeded"), *FT_CASES],
                         ids=lambda c: c[0])
def test_ft_backward_kernels_equal_the_cpu_bytes(card, feature_set, case):
    """K15 and K18 on chip_smoke.ft_case's batches (seeded diverse
    positions at 16, 32 and 512 samples; FT_CASES: 512 start positions,
    2,048 samples across four windows, a tp position's 32 columns, and a
    wide L1: K18 256, K15 past 1,024): byte for byte the plain version run
    on the CPU (the order it states), the same bytes on a repeated launch,
    within TRAIN_GRAD_RTOL of the plain version run on the card (chip_smoke
    ft_check, which raises otherwise), one launch a call."""
    label, batch, l1, kind = case
    l1 = l1 or FT_WIDE_L1[feature_set]
    boards, d_acc = (torch.from_numpy(a).to(card)
                     for a in ft_case(batch, l1, seed=batch + l1, kind=kind))
    kernels.reset_launches()
    assert ft_check(feature_set, label, boards, d_acc) == 0.0
    name = "nnue_ft_backward_768" if feature_set == "board768" else "nnue_ft_backward_kb"
    assert {n: v for n, v in kernels.LAUNCHES.items() if v} == {name: 2}


def _grid_steps(net, grid, batches, dev):
    params = shard_params_tp(net, grid)
    opt = train.adam(2e-3)
    state = opt.init(params)
    step = train.make_sharded_train_step(grid, opt)
    losses = []
    for b in batches:
        params, state, loss = step(params, state, *[t.to(dev) for t in b])
        losses.append(loss)
    return params, losses


def _train_batches(n, batch, seed):
    dataset = train.diverse_position_dataset(256, seed=seed)
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy(a[idx]) for a in dataset]
            for idx in rng.integers(0, 256, size=(n, batch))]


@pytest.mark.parametrize("feature_set", ["board768", "halfkav2_hm"])
def test_grid_of_one_row_equals_one_device_on_the_card(card, feature_set):
    """Three steps of the grid (1, 2) on cuda:0 equal make_train_step on
    the card bit for bit (losses and params): tp alone changes no bit."""
    net = nnue.init_params(torch.Generator().manual_seed(4), l1=64, feature_set=feature_set,
                           device=card)
    batches = _train_batches(3, 64, seed=4)
    params, losses = _grid_steps(net, make_2d_mesh(1, 2, ["cuda:0"] * 2), batches, card)
    one = train.pack_params(nnue.NnueParams(*[t.clone() for t in net]))
    opt = train.adam(2e-3)
    state = opt.init(one)
    step = train.make_train_step(opt)
    for b, loss in zip(batches, losses):
        one, state, want = step(one, state, *[t.to(card) for t in b])
        assert torch.equal(loss, want)
    for j, p in enumerate(params[0]):
        assert torch.equal(p.ft_w, one.ft_w[:, j * 32:(j + 1) * 32])
        assert torch.equal(p.ft_b, one.ft_b[j * 32:(j + 1) * 32])
        assert all(torch.equal(a, b) for a, b in zip(p[2:], one[2:]))


@pytest.mark.parametrize("feature_set", ["board768", "halfkav2_hm"])
def test_grid_2x2_on_the_card_equals_the_cpu(card, feature_set, monkeypatch):
    """Three steps of the grid (2, 2) on cuda:0 launch each position's
    kernels once a step and no plain version, and agree with the same grid
    of CPU devices (losses within TRAIN_LOSS_RTOL, every position's params
    within TRAIN_PARAM_ATOL)."""
    net = nnue.init_params(torch.Generator().manual_seed(6), l1=64, feature_set=feature_set,
                           device="cpu")
    batches = _train_batches(3, 64, seed=6)
    cpu_params, cpu_losses = _grid_steps(net, make_2d_mesh(2, 2, ["cpu"] * 4), batches, "cpu")
    for mod, name in ((nnue, "accumulators_768_plain"), (nnue, "accumulators"),
                      (nnue, "forward_from_acc_plain"), (train, "stack_backward_plain"),
                      (train, "ft_backward_768_plain"), (train, "ft_backward_kb_plain"),
                      (train, "adam_update_plain")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: pytest.fail(_n))
    kernels.reset_launches()
    params, losses = _grid_steps(net, make_2d_mesh(2, 2, ["cuda:0"] * 4), batches, card)
    refresh, ft = (("nnue_refresh_768", "nnue_ft_backward_768") if feature_set == "board768"
                   else ("nnue_refresh_kb", "nnue_ft_backward_kb"))
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        k: 12 for k in (refresh, "nnue_forward_from_acc", "nnue_stack_backward", ft,
                        "adam_update")}
    for a, b in zip(losses, cpu_losses):
        assert abs(float(a) - float(b)) <= TRAIN_LOSS_RTOL * abs(float(b))
    for row, cpu_row in zip(params, cpu_params):
        for p, q in zip(row, cpu_row):
            assert float((train.flat_view(p).cpu() - train.flat_view(q)).abs().max()) \
                <= TRAIN_PARAM_ATOL


@pytest.mark.parametrize("variant,roots", [(v, None) for v in VARIANTS]
                         + [("crazyhouse", label) for label in ZH_POCKETS])
@pytest.mark.parametrize("net", ["f32", "int8"])
@pytest.mark.parametrize("cfg", ["helpers", "engine"])
@pytest.mark.parametrize("batch", [16, 64])
def test_variant_segment_kernel_matches_plain_version(nets, batch, cfg, variant, roots, net):
    """K11 in each variant against run_segment_plain on 16 and 64 lanes
    (the main path's width) of the variant's seeded roots (or every lane
    at one of crazyhouse's pocket FENs), with jittered helpers
    and the prefer_deep store into a small table, or on the main path's
    table setup, over segments of 1, 33 and 100 steps: every state table
    (atomic's accumulators past the roots' row untouched), the table and
    the summary equal, one launch a segment; in atomic K1's body refreshes
    each leaf and K3's never runs."""
    params = nets[net]
    state, table, kw = segment_case(params, batch, cfg, batch + 1, params.device,
                                    variant=variant,
                                    fens=None if roots is None else [ZH_POCKETS[roots]] * batch)
    plain = search.SearchState(*[t.clone() for t in state])
    plain_table = table.clone()
    acc0 = state.acc.clone()
    for steps in (1, 33, 100):
        kernels.reset_launches()
        n_k, sum_k = search.run_segment(params, state, steps, True, **kw)
        assert kernels.LAUNCHES["search_segment"] == 1
        if variant == "atomic":
            calls = kernels.body_calls()
            assert calls["nnue_refresh_768"] == calls["nnue_forward_from_acc"]
            assert calls["nnue_refresh_768"] > 0 or steps > 1
            assert calls["nnue_acc_update_768"] == 0
            assert torch.equal(state.acc, acc0)
        n_p, sum_p = search.run_segment_plain(params, plain, steps, True,
                                              **dict(kw, table=plain_table))
        assert n_k == n_p
        assert torch.equal(sum_k, sum_p)
        _same_state(state, plain, table, plain_table)


def test_variant_wrappers_refuse(card):
    b, killers, hist = rules_inputs(16, 3, card, "threeCheck")
    kernels.reset_launches()
    with pytest.raises(ValueError):  # threeCheck reads the counters
        kernels.node_rules(b.board, b.stm, None, "threeCheck")
    with pytest.raises(NotImplementedError):  # a variant no layer knows
        kernels.node_rules(b.board, b.stm, b.extra, "bughouse")
    with pytest.raises(NotImplementedError):
        kernels.generate_moves(b.board, b.stm, b.ep, b.castling, killers, hist, "bughouse",
                               b.extra)
    with pytest.raises(ValueError):  # crazyhouse reads the pockets
        kernels.generate_moves(b.board, b.stm, b.ep, b.castling, killers, hist, "crazyhouse")
    z1, z2 = tt.tables(card)
    with pytest.raises(ValueError):  # and hashes them
        kernels.zobrist_hash(b.board, b.stm, b.ep, b.castling, z1, z2, None, "crazyhouse")
    assert not any(kernels.LAUNCHES.values())



def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.fixture(scope="module")
def bf16_nets(card, full_nets):
    """bf16 nets (cast_params) and the same weights widened to f32: the
    shipped board768 net and the king-bucketed one at L1 256."""
    out = {}
    for name, p in (("board768", nnue.load_params(device=card)), ("kb", full_nets["kb f32"])):
        p16 = nnue.cast_params(p)
        out[name] = (p16, nnue.widened(p16))
    return out


@pytest.mark.parametrize("batch", [16, 64, 1024])
def test_bf16_board768_kernels(bf16_nets, batch):
    """K1, K3 and K2 on bf16 weights (their _bf16 entry points, one
    launch each): K1 and K3 equal their plain versions and the f32
    kernels on the widened weights byte for byte; K2 equals the f32
    kernel on the widened weights byte for byte and its plain version
    within F32_EVAL_TOL."""
    p16, wide = bf16_nets["board768"]
    b, moves = playout_boards(batch, seed=batch + 5)
    b = b.to(p16.device)
    mv = torch.tensor([m.from_sq | (m.to_sq << 6) | ((m.promotion or 0) << 12) for m in moves],
                      dtype=torch.int32, device=p16.device)
    codes, sqs, signs = tb.move_piece_changes(b, mv)
    bucket = nnue.output_bucket(b.board)
    kernels.reset_launches()
    acc = nnue.accumulators_768(p16, b.board)
    up = nnue.apply_acc_updates_768(p16, acc, codes, sqs, signs)
    ev = nnue.forward_from_acc(p16, acc, b.stm, bucket)
    assert {k: v for k, v in kernels.LAUNCHES_BY_ENTRY.items() if v} == {
        "nnue_refresh_768_bf16": 1, "nnue_acc_update_768_bf16": 1,
        "nnue_forward_from_acc_bf16": 1}
    assert acc.dtype == up.dtype == ev.dtype == torch.float32
    assert _bits_equal(acc, nnue.accumulators_768_plain(p16, b.board))
    assert _bits_equal(acc, nnue.accumulators_768(wide, b.board))
    assert _bits_equal(up, nnue.apply_acc_updates_768_plain(p16, acc, codes, sqs, signs))
    assert _bits_equal(up, nnue.apply_acc_updates_768(wide, acc, codes, sqs, signs))
    assert _bits_equal(ev, nnue.forward_from_acc(wide, acc, b.stm, bucket))
    want = nnue.forward_from_acc_plain(p16, acc, b.stm, bucket)
    assert float((ev.double() - want.double()).abs().max()) <= nnue.F32_EVAL_TOL


@pytest.mark.parametrize("batch", [16, 64, 1024])
def test_bf16_full_eval_kernel(bf16_nets, batch):
    """K12 on the bf16 king-bucketed net (nnue_evaluate_bf16): the f32
    kernel's bits on the widened weights, its plain version within
    F32_EVAL_TOL."""
    p16, wide = bf16_nets["kb"]
    b = playout_boards(batch, seed=batch + 9)[0].to(p16.device)
    kernels.reset_launches()
    got = nnue.evaluate(p16, b.board, b.stm)
    assert {k: v for k, v in kernels.LAUNCHES_BY_ENTRY.items() if v} == {"nnue_evaluate_bf16": 1}
    assert _bits_equal(got, nnue.evaluate(wide, b.board, b.stm))
    want = nnue.evaluate_plain(p16, b.board, b.stm)
    assert float((got.double() - want.double()).abs().max()) <= nnue.F32_EVAL_TOL


def test_bf16_wrappers_refuse_mixed_types(bf16_nets, lanes):
    p16, wide = bf16_nets["board768"]
    b, _ = lanes
    acc = nnue.accumulators_768(wide, b.board)
    state, _, _ = segment_case(nnue.quantize_int8(wide), 16, "no table", 5, b.board.device)
    kernels.reset_launches()
    with pytest.raises(TypeError):  # an f32 bias beside bf16 rows
        kernels.nnue_refresh_768(b.board, p16.ft_w, wide.ft_b)
    with pytest.raises(TypeError):  # bf16 accumulators: they stay f32
        kernels.nnue_acc_update_768(torch.zeros((48, 2, 64), dtype=torch.bfloat16,
                                                device=b.board.device),
                                    *[torch.zeros((48, 4), dtype=torch.int32,
                                                  device=b.board.device)] * 3, p16.ft_w)
    with pytest.raises(TypeError):  # f32 head weights on a bf16 net
        kernels.nnue_forward_from_acc(acc, b.stm, nnue.output_bucket(b.board),
                                      p16._replace(l1_w=wide.l1_w))
    with pytest.raises(TypeError):  # a bf16 net on int32 accumulators
        kernels.search_segment(p16, state, 5, True)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("net,batch,cfg,variant", [
    ("board768", 16, "table", "standard"), ("board768", 64, "engine", "standard"),
    ("board768", 64, "helpers", "atomic"), ("kb", 16, "table", "standard")])
def test_bf16_segment_kernel(bf16_nets, net, batch, cfg, variant):
    """K11 on bf16 weights (search_segment_bf16*, search_segment_kb_bf16*)
    against run_segment_plain and against the f32 K11 on the widened
    weights, over segments of 1, 33 and 100 steps: states, tables and
    summaries byte for byte, the step counts equal."""
    p16, wide = bf16_nets[net]
    state, table, kw = segment_case(p16, batch, cfg, batch + 3, p16.device, variant=variant)
    plain, plain_table = search.SearchState(*[t.clone() for t in state]), table.clone()
    f32, f32_table = search.SearchState(*[t.clone() for t in state]), table.clone()
    tag = "bf16" if net == "board768" else "kb_bf16"
    entry = kernels._variant_symbol(f"search_segment_{tag}", variant)
    for steps in (1, 33, 100):
        kernels.reset_launches()
        n_k, sum_k = search.run_segment(p16, state, steps, True, **kw)
        assert kernels.LAUNCHES_BY_ENTRY == {entry: 1}
        n_f, sum_f = search.run_segment(wide, f32, steps, True, **dict(kw, table=f32_table))
        n_p, sum_p = search.run_segment_plain(p16, plain, steps, True,
                                              **dict(kw, table=plain_table))
        assert n_k == n_p == n_f
        assert torch.equal(sum_k, sum_p) and torch.equal(sum_k, sum_f)
        _same_state(state, plain, table, plain_table)
        _same_state(state, f32, table, f32_table)


# --------------------------------------------------------------- the mesh


@pytest.mark.parametrize("cfg", ["no table", "helpers"])
@pytest.mark.parametrize("net", ["f32", "int8"])
def test_segment_kernel_per_shard_matches_plain_version(nets, net, cfg):
    """K11 a shard on a 4-shard mesh of one card (parallel/mesh.py): a
    seeded 64-lane state split into 4 shards of 16 lanes, each with its
    own table (helpers: 2^12 slots, colliding); over segments of 1, 33
    and 100 steps each shard's state, table, step count and rows of the
    stacked summary equal run_segment_plain on a copy of that shard
    alone, and each segment is one K11 launch a shard."""
    params = nets[net]
    mesh = make_mesh(["cuda:0"] * 4)
    state, table, kw = segment_case(params, 64, cfg, 65, params.device)
    shards = shard_batch(mesh, state)
    tables = None if table is None else make_sharded_table(mesh, 12)
    gen = kw["tt_gen"]
    plain = [(search.SearchState(*[t.clone() for t in sh]),
              None if tables is None else tables[i].clone()) for i, sh in enumerate(shards)]
    for steps in (1, 33, 100):
        kernels.reset_launches()
        n, stacked = run_segment_sharded(mesh, params, shards, tables, steps, True,
                                         kw["deep_tt"], kw["prefer_deep"], gen)
        assert kernels.LAUNCHES["search_segment"] == 4
        assert stacked.shape == (4, 17, 4)
        for i, (pst, ptab) in enumerate(plain):
            g = gen[16 * i:16 * (i + 1)] if torch.is_tensor(gen) else gen
            n_p, summ = search.run_segment_plain(params, pst, steps, True, ptab, kw["deep_tt"],
                                                 kw["prefer_deep"], g)
            assert n_p == n[i] and np.array_equal(summ.cpu().numpy(), stacked[i])
            _same_state(shards[i], pst, None if tables is None else tables[i], ptab)


def test_lane_init_per_shard_matches_plain_version(nets):
    """K7 a shard: refill_lanes_sharded on a seeded-garbage 64-lane state
    split into 4 shards equals refill_lanes_sharded_plain, every shard
    byte for byte, with one K7 launch a shard that owns spliced lanes."""
    params = nets["f32"]
    mesh = make_mesh(["cuda:0"] * 4)
    state, _, _ = lane_init_case(params, 64, 64, 41, params.device, tm.MAX_MOVES)
    card = shard_batch(mesh, search.SearchState(*[t.clone() for t in state]))
    plain = shard_batch(mesh, search.SearchState(*[t.clone() for t in state]))
    lanes = np.asarray([3, 17, 18, 40, 41, 42, 9], np.int64)  # shards 0, 1, 2 (none on 3)
    roots, _ = playout_boards(len(lanes), seed=5)
    kw = dict(order_jitter=np.asarray([0, 5, -3, 9, 1, 0, 2], np.int32),
              root_alpha=np.full(len(lanes), -40, np.int32),
              root_beta=np.full(len(lanes), 40, np.int32))
    depth = np.asarray([1, 2, 3, 1, 2, 3, 4], np.int32)
    budget = np.full(len(lanes), 1000, np.int32)
    kernels.reset_launches()
    refill_lanes_sharded(mesh, params, card, roots, lanes, depth, budget, **kw)
    assert kernels.LAUNCHES["lane_init"] == 3
    refill_lanes_sharded_plain(mesh, params, plain, roots, lanes, depth, budget, **kw)
    for a, b in zip(card, plain):
        _same_state(a, b)
    untouched = shard_batch(mesh, state)[3]
    _same_state(card[3], untouched)


def test_int8_mesh_searches_card_equal_cpu(nets, lanes):
    """search_stream and search_batch_resumable on a 4-shard mesh with a
    table a shard (the helpers' store), card (4 shards of cuda:0) against
    CPU (4 CPU shards): every field equal and every shard's table byte for
    byte; the card's mesh stream runs K11 once a shard and segment."""
    b, _ = lanes
    roots = tb.Board(*[t[:24] for t in b])
    depth = np.asarray([1 + i % 3 for i in range(24)], np.int32)
    outs = {}
    for dev in ("cuda:0", "cpu"):
        mesh = make_mesh([dev] * 4)
        kernels.reset_launches()
        stream = search_stream(nets["int8"].to(dev), roots.to(dev), depth, 100_000,
                               max_ply=6, width=16, segment_steps=48,
                               tt=make_sharded_table(mesh, 14), prefer_deep_store=True,
                               device=dev, mesh=mesh)
        if dev != "cpu":
            assert kernels.LAUNCHES["search_segment"] == 4 * len(stream["occupancy"])
        batch = search_batch_resumable(nets["int8"].to(dev), tb.Board(*[t[:16] for t in roots]),
                                       depth[:16], 100_000, max_ply=6, segment_steps=32,
                                       tt=make_sharded_table(mesh, 12), device=dev, mesh=mesh)
        outs[dev] = stream, batch
    for card, cpu in zip(outs["cuda:0"], outs["cpu"]):
        for k in ("score", "move", "nodes", "pv", "pv_len", "done"):
            assert (np.asarray(card[k]) == np.asarray(cpu[k])).all(), k
        assert card["steps"] == cpu["steps"]
        for t_card, t_cpu in zip(card["tt"], cpu["tt"]):
            assert torch.equal(t_card.cpu(), t_cpu)
    def rows(out):  # the occupancy rows but for their times
        return [{k: v for k, v in r.items() if k not in ("host_ms", "device_ms")}
                for r in out["occupancy"]]

    assert rows(outs["cuda:0"][0]) == rows(outs["cpu"][0])
