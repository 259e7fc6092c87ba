"""The port's dp×tp training step (models/train.py make_sharded_train_step
on a parallel/mesh.py make_2d_mesh grid of `cpu` devices) against the
JAX package's make_sharded_train_step on conftest's 8 CPU devices, and
against the port's own one-device step, for a board768 and a king-bucketed
net at the shipped widths (L1 64, the reference caller's 32 * tp at tp 2).

- tp alone changes no bit: the grids (1, 1) and (1, 2) equal
  make_train_step bit for bit (losses and every position's params), since
  every kernel and plain version of the step sums each column on its own
  and the tp gather and the column split are copies.
- The grids (4, 2) and (8, 1) against the reference's, 5 steps at batch 32
  and 128: losses within LOSS_RTOL, params within PARAM_ATOL (a tenth of
  one Adam step at lr 1e-3), as tests/test_torch_train.py holds the
  one-device step; dp changes only the order of the batch's sums.
- make_2d_mesh, shard_params_tp, shard_batch, and the refusals: no card
  and no devices, a tp that leaves the layer stack off the shipped widths
  (the reference caller's odd device count, tp 1 and L1 32), a tp that
  does not divide L1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fishnet_tpu.models import nnue as jn
from fishnet_tpu.models import train as jt
from fishnet_tpu.parallel import mesh as jmesh
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.models import train as tt
from fishnet_tpu_torch.parallel import mesh as tmesh

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4
FEATURE_SETS = ("board768", "halfkav2_hm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one torch thread a test worker (see
    tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    return tt.diverse_position_dataset(512, seed=6)


def _net(feature_set, l1=64):
    """The reference's init (the caller's: PRNGKey(0), L1 32 * tp) as numpy
    arrays."""
    p = jn.init_params(jax.random.PRNGKey(0), l1=l1, feature_set=feature_set)
    return {f: np.asarray(getattr(p, f)) for f in jn.NnueParams._fields}


def _batches(data, batch, steps, seed):
    rng = np.random.default_rng(seed)
    return [[a[idx] for a in data] for idx in rng.integers(0, data[0].shape[0],
                                                             size=(steps, batch))]


def _grid_run(net, dp, tp, batches):
    grid = tmesh.make_2d_mesh(dp, tp, ["cpu"] * (dp * tp))
    params = tmesh.shard_params_tp(tn.params_from_numpy(net, "cpu"), grid)
    opt = tt.adam(1e-3)
    state = opt.init(params)
    step = tt.make_sharded_train_step(grid, opt)
    losses = []
    for b in batches:
        out, state, loss = step(params, state, *[torch.from_numpy(a) for a in b])
        assert out is params  # updated in place
        losses.append(loss)
    assert state.count == len(batches)
    return params, losses


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("feature_set", FEATURE_SETS)
def test_tp_alone_changes_no_bit(data, feature_set, tp):
    net = _net(feature_set)
    batches = _batches(data, 32, 3, seed=tp)
    opt = tt.adam(1e-3)
    one = tt.pack_params(tn.params_from_numpy(net, "cpu"))
    state = opt.init(one)
    step = tt.make_train_step(opt)
    want = []
    for b in batches:
        one, state, loss = step(one, state, *[torch.from_numpy(a) for a in b])
        want.append(loss)
    params, losses = _grid_run(net, 1, tp, batches)
    assert all(torch.equal(a, b) for a, b in zip(losses, want))
    w = 64 // tp
    for j, p in enumerate(params[0]):
        assert torch.equal(p.ft_w, one.ft_w[:, j * w:(j + 1) * w])
        assert torch.equal(p.ft_b, one.ft_b[j * w:(j + 1) * w])
        assert all(torch.equal(a, b) for a, b in zip(p[2:], one[2:]))


def _reference_run(net, dp, tp, batches):
    mesh = jmesh.make_2d_mesh(dp, tp)
    params = jn.NnueParams(**{f: jnp.asarray(a) for f, a in net.items()})
    opt = optax.adam(1e-3)
    state = opt.init(params)
    step = jt.make_sharded_train_step(mesh, opt)
    losses = []
    with mesh:
        for b in batches:
            params, state, loss = step(params, state, *[jnp.asarray(a) for a in b])
            losses.append(float(loss))
    return {f: np.asarray(getattr(params, f)) for f in jn.NnueParams._fields}, losses


@pytest.mark.parametrize("batch", [32, 128])
@pytest.mark.parametrize("dp,tp", [(4, 2), (8, 1)])
@pytest.mark.parametrize("feature_set", FEATURE_SETS)
def test_grid_matches_reference(data, feature_set, dp, tp, batch):
    net = _net(feature_set)
    batches = _batches(data, batch, 5, seed=batch + dp)
    want, want_losses = _reference_run(net, dp, tp, batches)
    params, losses = _grid_run(net, dp, tp, batches)
    for got, ref in zip(losses, want_losses):
        assert got.shape == () and abs(float(got) - ref) <= LOSS_RTOL * abs(ref)
    w = 64 // tp
    for i in range(dp):
        for j in range(tp):
            p = params[i][j]
            for field in jn.NnueParams._fields:
                ref = want[field]
                if field == "ft_w":
                    ref = ref[:, j * w:(j + 1) * w]
                elif field == "ft_b":
                    ref = ref[j * w:(j + 1) * w]
                err = np.abs(getattr(p, field).numpy() - ref).max()
                assert err <= PARAM_ATOL, (i, j, field, err)
            # every position of a column holds the same bits
            assert all(torch.equal(a, b) for a, b in zip(p, params[0][j]))


def test_make_2d_mesh_lays_out_rows_and_refuses_without_devices():
    grid = tmesh.make_2d_mesh(2, 3, [f"cpu:{i}" for i in range(6)])
    assert [[d.index for d in row] for row in grid] == [[0, 1, 2], [3, 4, 5]]
    assert tmesh.make_2d_mesh(4, 2, ["cpu"] * 8) == ((torch.device("cpu"),) * 2,) * 4
    with pytest.raises(ValueError):
        tmesh.make_2d_mesh(2, 2, ["cpu"] * 3)
    with pytest.raises(ValueError):
        tmesh.check_grid((torch.device("cpu"),))
    if not torch.cuda.is_available():  # no card and no devices named: it raises
        with pytest.raises(RuntimeError, match="pass the grid's devices"):
            tmesh.make_2d_mesh(4, 2)


def test_shard_params_and_batch_follow_the_reference_layout(data):
    """shard_params_tp: ft_w's and ft_b's column blocks in tp order, the
    stack whole, all views of one flat buffer a position; shard_batch: dp
    row i's part on every position of row i."""
    net = tn.params_from_numpy(_net("halfkav2_hm"), "cpu")
    grid = tmesh.make_2d_mesh(2, 4, ["cpu"] * 8)
    params = tmesh.shard_params_tp(net, grid)
    for row in params:
        for j, p in enumerate(row):
            assert tt.flat_view(p) is not None
            assert torch.equal(p.ft_w, net.ft_w[:, j * 16:(j + 1) * 16])
            assert torch.equal(p.ft_b, net.ft_b[j * 16:(j + 1) * 16])
            assert all(torch.equal(a, b) for a, b in zip(p[2:], net[2:]))
    boards = torch.from_numpy(data[0][:16])
    parts = tmesh.shard_batch(grid, boards)
    assert len(parts) == 2 and all(len(row) == 4 for row in parts)
    for i, row in enumerate(parts):
        assert all(torch.equal(t, boards[i * 8:(i + 1) * 8]) for t in row)
    with pytest.raises(ValueError):
        tmesh.shard_batch(tmesh.make_2d_mesh(3, 1, ["cpu"] * 3), boards)
    with pytest.raises(ValueError):  # 64 columns do not split over tp 3
        tmesh.shard_params_tp(net, tmesh.make_2d_mesh(1, 3, ["cpu"] * 3))


def test_a_tp_off_the_shipped_widths_raises(data):
    """The reference caller's odd device count (tp 1, L1 32 * tp) leaves
    the layer stack at 64 → 16 inputs, which K2 and K14 do not take: the
    step raises on every device, with no plain fallback."""
    net = _net("board768", l1=32)
    grid = tmesh.make_2d_mesh(1, 1, ["cpu"])
    params = tmesh.shard_params_tp(tn.params_from_numpy(net, "cpu"), grid)
    opt = tt.adam(1e-3)
    step = tt.make_sharded_train_step(grid, opt)
    with pytest.raises(ValueError, match="shipped widths"):
        step(params, opt.init(params), *[torch.from_numpy(a[:8]) for a in data])
    with pytest.raises(ValueError):
        tt.make_sharded_train_step((torch.device("cpu"),) * 2, opt)
