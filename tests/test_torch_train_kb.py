"""fishnet_tpu_torch's trainer on a king-bucketed (HalfKAv2_hm) net against
the JAX package's fishnet_tpu/models/train.py on the CPU, with inputs from
numpy seeds: the eval and loss, the gradients (the plain versions of K17,
K14 and K18), five Adam steps of make_train_step against the reference's,
train_material_net(feature_set="halfkav2_hm") against the reference's,
and K18's plain version against jax.grad of the reference's accumulators
and against its stated summation order.

The net is the reference's init_params(..., feature_set="halfkav2_hm",
l1=64) carried across as numpy arrays: ft_w (22,528, 64) and the shipped
layer stack. Tolerances, each with its reason (tests/test_torch_train.py
states them for board768):
- evals within nnue.F32_EVAL_TOL centipawns and the loss within LOSS_RTOL
  (the layer stack sums in another order than XLA's dot);
- gradients within GRAD_RTOL of the field's largest (sums over the batch
  in another order than XLA's scatter-add);
- after the Adam steps, params within PARAM_ATOL, a tenth of one step at
  lr 1e-3 (a gradient's last bits can move an update where the gradient is
  near 0, and ft_w has many rows that one sample touches), the losses
  within LOSS_RTOL.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fishnet_tpu.models import nnue as jn
from fishnet_tpu.models import train as jt
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.models import train as tt

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 1e-4
L1 = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small ops: one torch thread a test worker (see
    tests/test_torch_train.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy(params):
    return {f: np.asarray(getattr(params, f)) for f in jn.NnueParams._fields}


@pytest.fixture(scope="module")
def kb_net():
    """The reference's king-bucketed init at L1 64 as numpy arrays."""
    return _numpy(jn.init_params(jax.random.PRNGKey(5), l1=L1, feature_set="halfkav2_hm"))


def _both(mapping):
    return (jn.NnueParams(**{f: jnp.asarray(a) for f, a in mapping.items()}),
            tn.params_from_numpy(mapping, "cpu"))


@pytest.fixture(scope="module")
def data():
    return tt.diverse_position_dataset(256, seed=4)


def _grads(tp, boards, stms, targets):
    leaves = [t.clone().requires_grad_() for t in tp]
    loss = tt.loss_fn(tn.NnueParams(*leaves), *[torch.from_numpy(a)
                                                 for a in (boards, stms, targets)])
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("batch", [32, 128])
def test_forward_loss_and_gradients_match_reference(kb_net, data, batch):
    jp, tp = _both(kb_net)
    boards, stms, targets = (a[:batch] for a in data)
    want = np.asarray(jt.batched_forward(jp, jnp.asarray(boards), jnp.asarray(stms)))
    got = tt.batched_forward(tp, torch.from_numpy(boards), torch.from_numpy(stms))
    assert np.abs(got.numpy() - want).max() <= tn.F32_EVAL_TOL
    jl, jg = jax.value_and_grad(jt.loss_fn)(jp, jnp.asarray(boards), jnp.asarray(stms),
                                            jnp.asarray(targets))
    loss, got = _grads(tp, boards, stms, targets)
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert tt.flat_view(got) is not None  # one flat gradient buffer
    for field, w, g in zip(jn.NnueParams._fields, jg, got):
        w = np.asarray(w)
        assert g.shape == w.shape, field
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (field, err, np.abs(w).max())


def test_adam_steps_match_reference(kb_net, data):
    jp, tp = _both(kb_net)
    jopt = optax.adam(1e-3)
    jstate = jopt.init(jp)
    jstep = jt.make_train_step(jopt)
    opt = tt.adam(1e-3)
    params = tt.pack_params(tp)
    state = opt.init(params)
    step = tt.make_train_step(opt)
    rng = np.random.default_rng(1)
    for _ in range(5):
        idx = rng.integers(0, data[0].shape[0], size=64)
        jp, jstate, jl = jstep(jp, jstate, *[jnp.asarray(a[idx]) for a in data])
        out, state, loss = step(params, state, *[torch.from_numpy(a[idx]) for a in data])
        assert out is params  # updated in place
        assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert state.count == int(jstate[0].count) == 5
    for field in jn.NnueParams._fields:
        err = np.abs(getattr(params, field).numpy() - np.asarray(getattr(jp, field))).max()
        assert err <= PARAM_ATOL, (field, err)


def test_train_material_net_matches_reference(kb_net, monkeypatch):
    """A few steps of train_material_net(feature_set="halfkav2_hm") from the
    same start as the reference's (the packages draw different random
    numbers, so both start from the reference's init: the port's
    init_params is replaced by it): the final loss and the params."""
    dataset = tt.random_position_dataset(128, seed=2)
    kw = dict(l1=L1, steps=4, batch=32, seed=5, dataset=dataset, lr=2e-3,
              feature_set="halfkav2_hm")
    jp, want = jt.train_material_net(**kw)
    monkeypatch.setattr(tn, "init_params", lambda *a, **k: tn.params_from_numpy(kb_net, "cpu"))
    params, got = tt.train_material_net(**kw, device="cpu")
    assert params.ft_w.shape == (tn.NUM_FEATURES, L1)
    assert abs(got - want) <= LOSS_RTOL * abs(want)
    for field in jn.NnueParams._fields:
        err = np.abs(getattr(params, field).numpy() - np.asarray(getattr(jp, field))).max()
        assert err <= PARAM_ATOL, (field, err)


def _d_acc(batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, 2, L1)) * np.exp(rng.normal(size=(batch, 2, 1)))).astype(
        np.float32)


@pytest.mark.parametrize("batch", [8, 64])
def test_ft_backward_kb_plain_matches_jax_grad(kb_net, data, batch):
    """K18's plain version against jax.grad of <the reference's
    accumulators, d_acc> by ft_w and ft_b."""
    jp, _ = _both(kb_net)
    boards = data[0][:batch]
    d_acc = _d_acc(batch, batch)

    def dot(ft_w, ft_b):
        acc = jax.vmap(jn.accumulators, in_axes=(None, 0))(jp._replace(ft_w=ft_w, ft_b=ft_b),
                                                          jnp.asarray(boards))
        return jnp.sum(acc * jnp.asarray(d_acc))

    want_w, want_b = jax.grad(dot, argnums=(0, 1))(jp.ft_w, jp.ft_b)
    got_w, got_b = tt.ft_backward_kb_plain(torch.from_numpy(boards), torch.from_numpy(d_acc))
    for got, want in ((got_w, want_w), (got_b, want_b)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= GRAD_RTOL * np.abs(want).max()
    assert int((got_w != 0).any(1).sum()) == int(np.any(np.asarray(want_w) != 0, 1).sum())


def test_ft_backward_kb_plain_sums_in_pair_order(data):
    """The order K18 keeps: every row, and ft_b, summed from 0.0 over its
    (sample, perspective) pairs in order, in f32, each column on its own
    (so a block of d_acc's columns gives those columns' bits)."""
    boards = data[0][:24]
    d_acc = _d_acc(24, 3)
    b = torch.from_numpy(boards)
    idx = torch.stack([tn.feature_indices(b, p, tn.king_square(b, p)) for p in (0, 1)], 1)
    want_w = np.zeros((tn.NUM_FEATURES, L1), np.float32)
    want_b = np.zeros(L1, np.float32)
    for s in range(24):
        for p in (0, 1):
            want_b += d_acc[s, p]
            for f in idx[s, p].tolist():
                if f >= 0:
                    want_w[f] += d_acc[s, p]
    got_w, got_b = tt.ft_backward_kb_plain(b, torch.from_numpy(d_acc))
    assert np.array_equal(got_w.numpy(), want_w) and np.array_equal(got_b.numpy(), want_b)
    half_w, half_b = tt.ft_backward_kb_plain(b, torch.from_numpy(d_acc[:, :, 32:].copy()))
    assert torch.equal(half_w, got_w[:, 32:]) and torch.equal(half_b, got_b[32:])


def test_accumulators_kb_on_the_cpu_is_the_plain_version(kb_net, data):
    """K17's wrapper runs `accumulators` for CPU tensors, and a block of
    ft_w's and ft_b's columns gives those columns of the accumulators bit
    for bit (the tp shard's refresh)."""
    _, tp = _both(kb_net)
    boards = torch.from_numpy(data[0][:32])
    acc = tn.accumulators_kb(tp, boards)
    assert torch.equal(acc, tn.accumulators(tp, boards))
    block = tp._replace(ft_w=tp.ft_w[:, 16:48].contiguous(), ft_b=tp.ft_b[16:48].contiguous())
    assert torch.equal(tn.accumulators_kb(block, boards), acc[:, :, 16:48])
    assert torch.equal(tt.refresh(tp, boards), acc)
