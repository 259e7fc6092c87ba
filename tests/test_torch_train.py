"""fishnet_tpu_torch's trainer (models/train.py) against the JAX package's
fishnet_tpu/models/train.py on the CPU, with inputs from numpy seeds: the
datasets, the eval and loss, the eval's backward (the plain versions of
K14 and K15, with the reference's 0.5 derivative on a clip's edge), Adam
against optax.adam (the plain version of K16), the .npz round trip
between the packages, train_material_net and the entry point.

Tolerances, each with its reason:
- datasets and targets: equal, byte for byte (the same rules, the same
  random.Random draws);
- evals: within nnue.F32_EVAL_TOL centipawns (the layer stack sums in
  another order than XLA's dot); the loss within LOSS_RTOL relative;
- gradients: within GRAD_RTOL of the field's largest gradient (sums over
  the batch in another order than XLA's);
- five Adam steps: params within PARAM_ATOL (a thousandth of one step
  of lr 1e-3), mu and nu within GRAD_RTOL of the field's largest, the
  losses within LOSS_RTOL (the gradients' last bits carried through the
  steps).
"""
import asyncio
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fishnet_tpu.client.ipc import Chunk, WorkPosition, chunk_to_wire
from fishnet_tpu.client.wire import AnalysisWork, EngineFlavor, NodeLimit
from fishnet_tpu.models import nnue as jn
from fishnet_tpu.models import train as jt
from fishnet_tpu_torch import ipc
from fishnet_tpu_torch.engine.gpu import GpuEngine
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.models import nnue_import as tni
from fishnet_tpu_torch.models import train as tt

REPO = Path(__file__).resolve().parents[1]
START = "rnbqkbnr/pppppppp/8/8/8/8/PPPPPPPP/RNBQKBNR w KQkq - 0 1"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 1e-6
# the JAX tests' small net, and the shipped widths
WIDTHS = {"small": (32, 8, 8), "shipped": (64, 16, 32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path runs many small ops; under the suite's parallel
    workers torch's default thread pool per process oversubscribes the
    cores, so these tests run it on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy(params):
    return {f: np.asarray(getattr(params, f)) for f in jn.NnueParams._fields}


def _both(mapping):
    """(JAX params, port params) of one net given as numpy arrays."""
    return (jn.NnueParams(**{f: jnp.asarray(a) for f, a in mapping.items()}),
            tn.params_from_numpy(mapping, "cpu"))


def _jax_net(name):
    l1, h1, h2 = WIDTHS[name]
    jp = jn.init_params(jax.random.PRNGKey(3), l1=l1, h1=h1, h2=h2, feature_set="board768")
    return _both(_numpy(jp))


def _edge_net(ft_b_ones: bool):
    """A net whose accumulators and hidden pre-activations sit exactly on
    the clips' edges: zero ft_w rows, ft_b in {0, 1}, zero biases, and
    weights in quarter steps (every sum exact in any order). Hidden unit
    0 of each layer has zero weights (pre-activation 0) and, when ft_b has
    ones, unit 1 a single weight 1 on an input that is 1 (pre-activation
    1). With ft_b all zero every input clips to 0, so every hidden
    pre-activation equals its zero bias."""
    l1, h1, h2 = WIDTHS["small"]
    rng = np.random.default_rng(11)
    f32 = np.float32
    ft_b = (np.arange(l1) % 2).astype(f32) if ft_b_ones else np.zeros(l1, f32)
    l1_w = (rng.integers(-2, 3, size=(8, 2 * l1, h1)) * 0.25).astype(f32)
    l2_w = (rng.integers(-2, 3, size=(8, h1, h2)) * 0.25).astype(f32)
    l1_w[:, :, :2] = 0.0
    l2_w[:, :, :2] = 0.0
    if ft_b_ones:
        l1_w[:, 1, 1] = 1.0  # input 1 is crelu(ft_b[1]) = 1
        l2_w[:, 1, 1] = 1.0  # hidden unit 1 is 1
    return _both({
        "ft_w": np.zeros((768, l1), f32), "ft_b": ft_b,
        "l1_w": l1_w, "l1_b": np.zeros((8, h1), f32),
        "l2_w": l2_w, "l2_b": np.zeros((8, h2), f32),
        "out_w": rng.normal(size=(8, h2)).astype(f32), "out_b": np.zeros(8, f32),
    })


@pytest.fixture(scope="module")
def data():
    return tt.diverse_position_dataset(256, seed=1)


def _batch(data, idx, device="cpu"):
    return [torch.from_numpy(a[idx]).to(device) for a in data]


@pytest.mark.parametrize("name", ["random_position_dataset", "diverse_position_dataset"])
@pytest.mark.parametrize("seed", [0, 7])
def test_datasets_equal_reference(name, seed):
    want = getattr(jt, name)(64, seed=seed)
    got = getattr(tt, name)(64, seed=seed)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("net", ["small", "shipped"])
def test_forward_and_loss_agree(data, net):
    jp, tp = _jax_net(net)
    boards, stms, targets = (a[:64] for a in data)
    want = np.asarray(jt.batched_forward(jp, jnp.asarray(boards), jnp.asarray(stms)))
    got = tt.batched_forward(tp, torch.from_numpy(boards), torch.from_numpy(stms))
    assert np.abs(got.numpy() - want).max() <= tn.F32_EVAL_TOL
    jl = float(jt.loss_fn(jp, jnp.asarray(boards), jnp.asarray(stms), jnp.asarray(targets)))
    tl = float(tt.loss_fn(tp, *[torch.from_numpy(a) for a in (boards, stms, targets)]))
    assert abs(tl - jl) <= LOSS_RTOL * abs(jl)


def _grads(tp, boards, stms, targets):
    leaves = [t.clone().requires_grad_() for t in tp]
    loss = tt.loss_fn(tn.NnueParams(*leaves), torch.from_numpy(boards), torch.from_numpy(stms),
                      torch.from_numpy(targets))
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("net", ["small", "shipped", "edges", "edges all zero"])
def test_backward_matches_jax_grad(data, net):
    if net.startswith("edges"):
        jp, tp = _edge_net(ft_b_ones=net == "edges")
    else:
        jp, tp = _jax_net(net)
    boards, stms, targets = (a[:64] for a in data)
    want = jax.grad(jt.loss_fn)(jp, jnp.asarray(boards), jnp.asarray(stms), jnp.asarray(targets))
    got = _grads(tp, boards, stms, targets)
    assert tt.flat_view(got) is not None  # one flat gradient buffer
    for field, w, g in zip(jn.NnueParams._fields, want, got):
        w = np.asarray(w)
        assert g.shape == w.shape, field
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (field, err, np.abs(w).max())
    if net.startswith("edges"):
        # the premise: pre-activations on both edges (and the accumulators on 0
        # or 1), where torch's clamp would give 1 and the reference 0.5
        acc = tn.accumulators_768(tp, torch.from_numpy(boards))
        bucket = tn.output_bucket(torch.from_numpy(boards)).long()
        x = acc[:, 0].clamp(0, 1).repeat(1, 2)
        z1 = torch.bmm(x[:, None], tp.l1_w[bucket])[:, 0]
        z2 = torch.bmm(z1.clamp(0, 1)[:, None], tp.l2_w[bucket])[:, 0]
        edges = [bool((z == e).any()) for z in (z1, z2) for e in (0.0, 1.0)]
        assert edges == ([True] * 4 if net == "edges" else [True, False, True, False])
        assert bool(((acc == 0) | (acc == 1)).all())


def test_crelu_grad_is_the_references():
    z = [-1.0, 0.0, 0.5, 1.0, 2.0, -0.0]
    want = np.asarray(jax.grad(lambda x: jnp.clip(x, 0.0, 1.0).sum())(jnp.asarray(z)))
    assert tt.crelu_grad(torch.tensor(z)).tolist() == want.tolist()


@pytest.mark.parametrize("net", ["small", "shipped"])
def test_adam_steps_match_optax(data, net):
    jp, tp = _jax_net(net)
    lr = 1e-3
    jopt = optax.adam(lr)
    jstate = jopt.init(jp)
    jstep = jt.make_train_step(jopt)
    opt = tt.adam(lr)
    params = tt.pack_params(tp)
    state = opt.init(params)
    step = tt.make_train_step(opt)
    rng = np.random.default_rng(0)
    for _ in range(5):
        idx = rng.integers(0, data[0].shape[0], size=32)
        jp, jstate, jl = jstep(jp, jstate, *[jnp.asarray(a[idx]) for a in data])
        out, state, loss = step(params, state, *_batch(data, idx))
        assert out is params  # updated in place
        assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    adam_state = jstate[0]
    assert state.count == int(adam_state.count) == 5
    l1, h1, h2 = WIDTHS[net]
    mu, nu = tt.unflatten(state.mu, l1, h1, h2), tt.unflatten(state.nu, l1, h1, h2)
    for field in jn.NnueParams._fields:
        err = np.abs(getattr(params, field).numpy() - np.asarray(getattr(jp, field))).max()
        assert err <= PARAM_ATOL, (field, err)
        for mine, ref in ((mu, adam_state.mu), (nu, adam_state.nu)):
            r = np.asarray(getattr(ref, field))
            assert np.abs(getattr(mine, field).numpy() - r).max() <= GRAD_RTOL * np.abs(r).max()


def test_adam_plain_is_optax_update_on_one_step():
    """One update from a non-zero state, values and gradients of varied
    magnitude: the plain version of K16 against optax's update and
    apply_updates, with the bias corrections of step 9."""
    rng = np.random.default_rng(5)
    n = 4096
    p, g = rng.normal(size=n).astype(np.float32), (rng.normal(size=n) * 1e-3).astype(np.float32)
    mu = (rng.normal(size=n) * 1e-3).astype(np.float32)
    nu = (rng.random(n) * 1e-6).astype(np.float32)
    opt = optax.adam(2e-3)
    state = (optax.ScaleByAdamState(count=jnp.int32(8), mu=jnp.asarray(mu), nu=jnp.asarray(nu)),
             optax.EmptyState())
    updates, new = opt.update(jnp.asarray(g), state, jnp.asarray(p))
    want = np.asarray(optax.apply_updates(jnp.asarray(p), updates))
    tp, tmu, tnu = (torch.from_numpy(a.copy()) for a in (p, mu, nu))
    out = tt.Adam(2e-3).apply(tp, torch.from_numpy(g), tt.AdamState(8, tmu, tnu))
    assert out.count == 9 and out.mu is tmu
    assert np.abs(tp.numpy() - want).max() <= PARAM_ATOL
    assert np.array_equal(tmu.numpy(), np.asarray(new[0].mu))
    assert np.array_equal(tnu.numpy(), np.asarray(new[0].nu))


def test_init_params_matches_reference_layout():
    for feature_set in ("board768", "halfkav2_hm"):
        want = jn.init_params(jax.random.PRNGKey(0), feature_set=feature_set)
        got = tn.init_params(torch.Generator().manual_seed(0), feature_set=feature_set,
                             device="cpu")
        for field, w, g in zip(jn.NnueParams._fields, want, got):
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32, field
            if w.std() == 0:  # the constant fields: ft_b 0.5, zero biases
                assert np.array_equal(g.numpy(), w), field
            else:  # the normal draws: their scales within five standard errors
                assert abs(float(g.std()) / w.std() - 1) < 5 / np.sqrt(2 * w.size), field
    if not torch.cuda.is_available():  # no card and no device named: it raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tn.init_params(torch.Generator())


def test_params_round_trip_between_packages(tmp_path):
    jp, tp = _jax_net("small")
    tn.save_params(tp, tmp_path / "port.npz")
    back = jn.load_params(tmp_path / "port.npz")
    for field in jn.NnueParams._fields:
        assert np.array_equal(np.asarray(getattr(back, field)), np.asarray(getattr(jp, field)))
    jn.save_params(jp, tmp_path / "jax.npz")
    again = tn.load_params(tmp_path / "jax.npz", device="cpu")
    for field, a in tn.params_to_numpy(again).items():
        assert np.array_equal(a, np.asarray(getattr(jp, field)))
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert json.loads(str(a["__meta__"])) == json.loads(str(b["__meta__"]))


def test_train_material_net_lowers_loss_and_the_engines_read_it(tmp_path):
    dataset = tt.random_position_dataset(256, seed=3)
    losses = []
    params, final = tt.train_material_net(
        l1=32, steps=40, batch=32, seed=3, dataset=dataset, lr=2e-3, device="cpu",
        on_step=lambda i, p, s, loss: losses.append(float(loss)))
    assert len(losses) == 40 and final == losses[-1]
    start = tn.init_params(torch.Generator().manual_seed(3), l1=32, feature_set="board768",
                           device="cpu")
    batch = [torch.from_numpy(a) for a in dataset]
    assert float(tt.loss_fn(params, *batch)) < 0.8 * float(tt.loss_fn(start, *batch))
    path = tmp_path / "trained.npz"
    tn.save_params(params, path)
    assert np.array_equal(np.asarray(jn.load_params(path).ft_w), params.ft_w.numpy())
    engine = GpuEngine(weights_path=str(path), max_depth=2, tt_size_log2=0, helper_lanes=1,
                       device="cpu")
    work = AnalysisWork(id="trained", nodes=NodeLimit(sf16=4_000_000, classical=8_000_000),
                        timeout_s=30.0, depth=2, multipv=None)
    chunk = Chunk(work=work, deadline=1e18, variant="standard", flavor=EngineFlavor.TPU,
                  positions=[WorkPosition(work=work, position_index=0, url=None, skip=False,
                                          root_fen=START, moves=["e2e4"])])
    got = asyncio.run(engine.go_multiple(ipc.chunk_from_wire(chunk_to_wire(chunk))))
    assert len(got) == 1 and got[0].best_move is not None and got[0].depth == 2


def test_entry_point_runs_on_the_cpu(tmp_path):
    out = tmp_path / "net.npz"
    proc = subprocess.run(
        [sys.executable, "-m", "fishnet_tpu_torch.models.train", "--steps", "3", "--samples",
         "64", "--batch", "16", "--device", "cpu", "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "saved" in proc.stdout
    assert tn.load_params(out, device="cpu").ft_w.shape == (768, 64)


def test_stockfish_net_training_is_refused():
    """The trainer takes the reference's two NnueParams feature sets
    (board768, king-bucketed; tests/test_torch_train_kb.py trains the
    latter): an imported Stockfish net is refused, and an unknown feature
    set raises as the reference's init_params does."""
    l1 = 8
    shapes = {"ft_w": (tn.NUM_FEATURES, l1), "ft_b": (l1,), "psqt_w": (tn.NUM_FEATURES, 8),
              "fc0_w": (8, 16, l1), "fc0_b": (8, 16), "fc1_w": (8, 32, 30), "fc1_b": (8, 32),
              "fc2_w": (8, 1, 32), "fc2_b": (8, 1)}
    net = tni.StockfishNet(**{f: torch.zeros(s) for f, s in shapes.items()})
    with pytest.raises(NotImplementedError):
        tt.pack_params(net)
    dataset = tt.random_position_dataset(4, seed=0)
    with pytest.raises(NotImplementedError):
        tt.make_train_step(tt.adam(1e-3))(net, None, *[torch.from_numpy(a) for a in dataset])
    with pytest.raises(KeyError):
        tt.train_material_net(steps=1, batch=4, feature_set="halfka", device="cpu")
