"""K9's plain version (ops/movegen.py generate_moves_plain) against the JAX
package's generate_moves, on the CPU, on the lists that the kernel's sort
branches on (csrc/movegen.cuh): chip_smoke.MOVEGEN_LONG's exactly 64 and
65 moves (the longest list sorted in registers, the shortest merged in
shared memory), the 218-move position, crazyhouse lists of 299 and 435
moves (drops beyond 128 entries, below the MAX_MOVES_ZH cut), a castling
right without its rook (the castle and the king step encode alike: equal
packed values once both are killers), antichess with and without a
capture, and a position with every key class (captures and capture
promotions, quiet queen promotions, castling, both killers, history, quiet
moves), each without and with the fixtures' killers and history. The
card holds the kernel to the plain version on the same fixtures
(tests/test_torch_card.py, chip_smoke.py). Every comparison is exact."""
from functools import lru_cache

import jax
import numpy as np
import pytest
import torch

from chip_smoke import MOVEGEN_LONG, movegen_long_case
from fishnet_tpu.ops import board as jb
from fishnet_tpu.ops import movegen as jm
from fishnet_tpu_torch.ops import movegen as tm
from fishnet_tpu_torch.ops.board import Board


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@lru_cache(maxsize=None)
def _lists(variant: str, ordered: bool):
    """(labels, the JAX package's (moves, count, noisy), the port's) on
    one variant's fixtures, numpy."""
    labels, case = movegen_long_case(variant)
    jboards = jb.Board(*[case[f] for f in jb.Board._fields])
    tboards = Board(*[torch.from_numpy(case[f]) for f in Board._fields])
    if ordered:
        want = jax.jit(jax.vmap(lambda b, k, h: jm.generate_moves(b, variant, killers=k, hist=h)))(
            jboards, case["killers"], case["hist"])
        got = tm.generate_moves_plain(tboards, torch.from_numpy(case["killers"]),
                                      torch.from_numpy(case["hist"]), variant=variant)
    else:
        want = jax.jit(jax.vmap(lambda b: jm.generate_moves(b, variant)))(jboards)
        got = tm.generate_moves_plain(tboards, variant=variant)
    return labels, [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("ordered", [False, True], ids=["plain ordering", "killers+history"])
@pytest.mark.parametrize("label,variant", [(label, v) for label, v, _ in MOVEGEN_LONG])
def test_long_and_tied_lists_match_reference(label, variant, ordered):
    labels, want, got = _lists(variant, ordered)
    lane = labels.index(label)
    for name, w, g in zip(("moves", "count", "noisy"), want, got):
        assert g.dtype == np.int32, name
        assert np.array_equal(w[lane], g[lane]), name
    moves, count = got[0][lane], int(got[1][lane])
    assert (moves[count:] == -1).all() and (moves[:count] >= 0).all()
    if label == "castling right without its rook" and ordered:  # the tie: f1g1 twice
        assert list(moves[:count]).count(5 | (6 << 6)) == 2
    if label.endswith("moves"):  # the fixture's length, all of it kept
        assert count == int(label.split()[-2])
