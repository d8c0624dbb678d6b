"""The port's time-chunked recurrent scan (``repro_torch.models.
recurrence``) against its own plain loop, bit for bit, and against the JAX
package's ``chunked_time_scan``: each step, from the reference's carried
state, within one rounding of the product of the reference's (XLA
contracts the step's multiply-add into one rounding, torch rounds the
product first: an ulp of the product plus an ulp of the result, the
reference's "1 ulp" where nothing cancels), and the whole scan,
where those differences carry, within rtol 1e-5; gradients through
checkpointed chunks against the plain loop's (rtol 1e-6, as
``tests/test_recurrence.py``).  Also the SSM step's softplus against
``jax.nn.softplus`` around torch's threshold."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.models.recurrence import \
    chunked_time_scan as ref_chunked  # noqa: E402
from repro_torch.models import xlstm  # noqa: E402
from repro_torch.models.recurrence import (TIME_CHUNK,  # noqa: E402
                                           chunked_time_scan, scan)


def _step(h, x):
    h = h * 0.9 + x
    return h, h * 2.0


def _jstep(h, x):
    h = h * 0.9 + x
    return h, h * 2.0


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


@pytest.mark.parametrize("S", [1, 7, 64, 130, 256])
def test_chunked_scan_matches_plain_and_reference(S):
    rng = np.random.default_rng(S)
    xs = rng.standard_normal((S, 3)).astype(np.float32)
    h0 = np.zeros((3,), np.float32)
    ref_h, ref_ys = lax.scan(_jstep, jnp.asarray(h0), jnp.asarray(xs))
    plain_h, plain_ys = scan(_step, torch.from_numpy(h0),
                             torch.from_numpy(xs))
    got_h, got_ys = chunked_time_scan(_step, torch.from_numpy(h0),
                                      torch.from_numpy(xs), chunk=64)
    assert torch.equal(got_h, plain_h) and torch.equal(got_ys, plain_ys)
    assert got_ys.shape == (S, 3)
    ref_ch, ref_cys = ref_chunked(_jstep, jnp.asarray(h0), jnp.asarray(xs),
                                  chunk=64)
    ref_cys = np.asarray(ref_cys)
    assert np.array_equal(ref_cys, np.asarray(ref_ys))
    # one step from the reference's state (h = y / 2, exact)
    prev = np.concatenate([h0[None], ref_cys[:-1] / 2])
    _, one = _step(torch.from_numpy(prev), torch.from_numpy(xs))
    bound = 2 * (np.spacing(np.abs(prev * np.float32(0.9)))
                 + np.spacing(np.abs(ref_cys / 2)))      # y = 2h, exact
    assert (np.abs(one.numpy() - ref_cys) <= bound).all()
    np.testing.assert_allclose(got_ys.numpy(), ref_cys, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_ch), rtol=1e-5,
                               atol=1e-5)


def test_chunked_scan_gradients_match():
    rng = np.random.default_rng(0)
    xs_np = rng.standard_normal((100, 4)).astype(np.float32)
    h0_np = rng.standard_normal(4).astype(np.float32)

    def grads(fn):
        h0 = torch.from_numpy(h0_np).requires_grad_(True)
        xs = torch.from_numpy(xs_np).requires_grad_(True)
        _, ys = fn(h0, xs)
        return torch.autograd.grad(torch.sum(ys ** 2), (h0, xs))

    g_plain = grads(lambda h, x: scan(_step, h, x))
    g_chunk = grads(lambda h, x: chunked_time_scan(_step, h, x, chunk=16))
    for a, b in zip(g_plain, g_chunk):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    ref = jax.grad(lambda h: jnp.sum(ref_chunked(
        _jstep, h, jnp.asarray(xs_np), chunk=16)[1] ** 2))(
            jnp.asarray(h0_np))
    np.testing.assert_allclose(g_chunk[0].numpy(), np.asarray(ref),
                               rtol=1e-5)


def test_namedtuple_state_and_tuple_outputs():
    """State as a NamedTuple, xs and ys as tuples: the mLSTM's step over
    130 steps (two chunks and a tail), chunked == plain bit for bit, with
    and without autograd."""
    from repro_torch import configs

    cfg = configs.get_config("xlstm-350m").reduced()
    B, H, hd, S = 2, cfg.n_heads, cfg.hd, 130
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((S, B, H, hd), generator=g) for _ in range(3))
    i_log = torch.randn((S, B, H), generator=g)
    f_log = torch.nn.functional.logsigmoid(torch.randn((S, B, H),
                                                       generator=g))
    xs = (q, k * hd ** -0.5, v, i_log, f_log)
    st0 = xlstm.mlstm_state_init(B, cfg, device="cpu")

    def two(st, x):
        st, y = xlstm._mlstm_step(st, *x)
        return st, (y, st.m)

    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            want_st, want = scan(two, st0, xs)
            got_st, got = chunked_time_scan(two, st0, xs,
                                            chunk=TIME_CHUNK)
        assert isinstance(got_st, xlstm.MLSTMState)
        assert isinstance(got, tuple) and got[0].shape == (S, B, H, hd)
        for a, b in zip(got_st + got, want_st + want):
            assert torch.equal(a, b)


def test_softplus_matches_reference_around_the_threshold():
    x = np.concatenate([np.linspace(-40, 40, 8001),
                        np.linspace(19.0, 21.0, 2001)]).astype(np.float32)
    got = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    assert _ulps(got, want) <= 2
    big = x > 17
    assert np.array_equal(got[big], want[big])
