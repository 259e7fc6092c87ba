"""The plain versions of K15 and K18 (the trainer's feature-transform
backward, models/train.py ft_backward_768_plain and ft_backward_kb_plain)
on the kernels' hardest inputs, against the JAX package on the CPU:

- the worst-case batch (512 start positions: every piece row holds all
  1,024 (sample, perspective) pairs) and a batch of 2,048 samples (four of
  the kernels' 1,024-pair windows), both from chip_smoke.ft_case, against
  jax.grad of <the reference's accumulators, d_acc> by ft_w and ft_b,
  within GRAD_RTOL of each field's largest gradient (the reference sums in
  XLA's scatter-add order);
- the kernels' window scheme: each row's and ft_b's sum taken window by
  window, each window's adds carried into the next in f32, gives the plain
  version's bytes (the kernels start each window's sum from the gradient
  buffer's running value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ft_case
from fishnet_tpu.models import nnue as jn
from fishnet_tpu_torch.models import nnue as tn
from fishnet_tpu_torch.models import train as tt

GRAD_RTOL = 1e-5  # as tests/test_torch_train_kb.py: another summation order
L1 = 64
WINDOW = 1024  # fishnet_tpu_torch/kernels.py FT_WINDOW: pairs a window
CASES = [("start", 512), ("seeded", 2048)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(feature_set):
    """(the reference's net at L1, its accumulator function, the port's
    plain backward, the feature rows of a (B, 64) board tensor)."""
    net = jn.init_params(jax.random.PRNGKey(3), l1=L1, feature_set=feature_set)
    if feature_set == "board768":
        def rows(b):
            sq = torch.arange(64, dtype=torch.int32)
            return torch.stack([tn.feature_index_768(b, sq, p) for p in (0, 1)], 1)

        return net, jn.accumulators_768, tt.ft_backward_768_plain, rows

    def rows(b):
        return torch.stack([tn.feature_indices(b, p, tn.king_square(b, p)) for p in (0, 1)], 1)

    return net, jn.accumulators, tt.ft_backward_kb_plain, rows


@pytest.mark.parametrize("kind,batch", CASES)
@pytest.mark.parametrize("feature_set", ["board768", "halfkav2_hm"])
def test_plain_backward_matches_jax_grad(feature_set, kind, batch):
    net, accumulators, plain, _ = _setup(feature_set)
    boards, d_acc = ft_case(batch, L1, seed=batch + 1, kind=kind)

    def dot(ft_w, ft_b):
        acc = jax.vmap(accumulators, in_axes=(None, 0))(net._replace(ft_w=ft_w, ft_b=ft_b),
                                                       jnp.asarray(boards))
        return jnp.sum(acc * jnp.asarray(d_acc))

    want_w, want_b = jax.grad(dot, argnums=(0, 1))(net.ft_w, net.ft_b)
    got_w, got_b = plain(torch.from_numpy(boards), torch.from_numpy(d_acc))
    for got, want in ((got_w, want_w), (got_b, want_b)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= GRAD_RTOL * np.abs(want).max()
    touched = np.any(np.asarray(want_w) != 0, 1)
    assert np.array_equal((got_w != 0).any(1).numpy(), touched)
    if kind == "start":  # every piece row holds every pair
        assert int(touched.sum()) == 32


@pytest.mark.parametrize("feature_set", ["board768", "halfkav2_hm"])
def test_windows_carried_give_the_plain_bytes(feature_set):
    """Window after window of WINDOW pairs, each row's and ft_b's running
    sum carried in f32 from one window into the next: the bytes of the
    plain version, which sums all 2,048 samples' pairs at once."""
    _, _, plain, rows = _setup(feature_set)
    boards, d_acc = ft_case(2048, L1, seed=5)
    b = torch.from_numpy(boards)
    idx = rows(b).numpy().reshape(-1, 64)  # (pairs, 64), pair k = 2 sample + perspective
    pairs = d_acc.reshape(-1, L1)
    n_rows = tn.NUM_FEATURES_768 if feature_set == "board768" else tn.NUM_FEATURES
    g_w = np.zeros((n_rows, L1), np.float32)
    g_b = np.zeros(L1, np.float32)
    for lo in range(0, len(pairs), WINDOW):
        win = slice(lo, lo + WINDOW)
        live = idx[win] >= 0
        keys = np.repeat(np.arange(lo, min(lo + WINDOW, len(pairs))), 64)[live.reshape(-1)]
        np.add.at(g_w, idx[win][live], pairs[keys])  # in pair order, f32
        for k in range(win.start, min(win.stop, len(pairs))):
            g_b += pairs[k]
    got_w, got_b = plain(b, torch.from_numpy(d_acc))
    assert np.array_equal(got_w.numpy().view(np.int32), g_w.view(np.int32))
    assert np.array_equal(got_b.numpy().view(np.int32), g_b.view(np.int32))
