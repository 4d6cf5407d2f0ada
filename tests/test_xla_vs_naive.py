"""The ``xla`` moment ops against the plain references: the reference's
patch-matmul algorithm (ops/naive.py) for the convolutions and the pool,
and a NumPy loop for the window-sum variance term ``winsum(x) * s_w``.
Forward values and gradients, at the shapes of the model's layer types:
3x3 encoder/decoder convs with and without the fused ReLU, the 2x2 decoder
conv, the 1x1 head and the single-channel input conv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supernet_tpu.ops import moments
from supernet_tpu.ops.moments import (
    vconv,
    vconv_input,
    vconv_relu,
    vmaxpool,
    vrelu,
)
from supernet_tpu.ops.naive import (
    vconv_input_naive,
    vconv_naive,
    vmaxpool_naive,
)

CASES = [
    # k, cin, cout, H, fuse_relu, has_sigma
    (3, 8, 16, 12, False, True),
    (3, 8, 16, 12, True, True),
    (2, 8, 8, 10, False, True),
    (1, 16, 4, 9, False, True),
    (3, 1, 8, 12, False, False),
]
IDS = ["k3", "k3_relu", "k2", "k1_head", "k3_input"]


def _setup(k, cin, cout, h, has_sigma, seed=0):
    rng = np.random.default_rng(seed)

    def t(*s):
        return jnp.asarray(rng.normal(0, 1, s).astype(np.float32))

    mu = t(2, h, h, cin)
    sigma = jnp.abs(t(2, h, h, cin)) if has_sigma else None
    w_mu = 0.3 * t(k, k, cin, cout)
    w_sigma = t(cout) - 5.0
    return mu, sigma, w_mu, w_sigma


def _pair(fuse, has_sigma):
    """(xla op, naive reference), both (mu, sigma, w_mu, w_sigma) -> pair."""
    if not has_sigma:
        return (lambda m, s, w, ws: vconv_input(m, w, ws),
                lambda m, s, w, ws: vconv_input_naive(m, w, ws))
    if fuse:
        return vconv_relu, lambda *a: vrelu(*vconv_naive(*a))
    return vconv, vconv_naive


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CASES, ids=IDS)
def test_forward_matches_naive(k, cin, cout, h, fuse, has_sigma):
    args = _setup(k, cin, cout, h, has_sigma)
    op, ref = _pair(fuse, has_sigma)
    for g, w in zip(op(*args), ref(*args)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,cin,cout,h,fuse,has_sigma", CASES, ids=IDS)
def test_grad_matches_naive(k, cin, cout, h, fuse, has_sigma):
    args = _setup(k, cin, cout, h, has_sigma)
    op, ref = _pair(fuse, has_sigma)

    def loss(f):
        def inner(*a):
            m, s = f(*a)
            return jnp.sum(m * m) + jnp.sum(jnp.sin(s))

        return inner

    argnums = (0, 1, 2, 3) if has_sigma else (0, 2, 3)
    g_op = jax.grad(loss(op), argnums)(*args)
    g_ref = jax.grad(loss(ref), argnums)(*args)
    for a, b in zip(g_op, g_ref):
        scale = float(jnp.max(jnp.abs(b))) + 1e-9
        np.testing.assert_allclose(np.asarray(a) / scale,
                                   np.asarray(b) / scale, atol=1e-5)


@pytest.mark.parametrize("shape,ties", [
    ((2, 8, 8, 32), True),
    ((1, 12, 16, 8), False),
    ((3, 5, 7, 130), True),  # odd H and W: SAME-padded partial windows
])
def test_vmaxpool_fwd_bwd_matches_naive(shape, ties):
    """Values, the sigma taken at the argmax (first occurrence on ties),
    and both moments' gradients equal the reference's argmax+gather."""
    rng = np.random.default_rng(0)
    if ties:
        mu = rng.integers(-3, 3, shape).astype(np.float32)
    else:
        mu = rng.normal(0, 1, shape).astype(np.float32)
    mu = jnp.asarray(mu)
    sigma = jnp.abs(jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)))
    got = jax.jit(vmaxpool)(mu, sigma)
    want = vmaxpool_naive(mu, sigma)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def loss(f):
        return lambda m, s: (jnp.sum(jnp.sin(f(m, s)[0]))
                             + jnp.sum(jnp.cos(f(m, s)[1])))

    g_got = jax.grad(loss(vmaxpool), (0, 1))(mu, sigma)
    g_want = jax.grad(loss(vmaxpool_naive), (0, 1))(mu, sigma)
    for a, b in zip(g_got, g_want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def _winsum_scale(x, s_w, k):
    """The vconv variance term under test: channel + k x k window sum of
    ``x``, scaled per output channel by ``s_w``."""
    return moments.scale_sw(moments._window_sum(x, k), s_w)


def _winsum_scale_np(x, s_w, k):
    b, h, w, _ = x.shape
    ho, wo = h - k + 1, w - k + 1
    out = np.zeros((b, ho, wo, len(s_w)))
    for i in range(ho):
        for j in range(wo):
            win = x[:, i:i + k, j:j + k, :].sum(axis=(1, 2, 3))
            out[:, i, j, :] = win[:, None] * s_w[None, :]
    return out


def _winsum_scale_grad_np(x, s_w, k, g_out):
    """d/dx and d/ds_w of sum(g_out * winsum_scale(x, s_w))."""
    b, h, w, c = x.shape
    ho, wo = h - k + 1, w - k + 1
    ws = _winsum_scale_np(x, np.ones(1), k)[..., 0]  # [b, ho, wo]
    d_sw = np.einsum("bijo,bij->o", g_out, ws)
    spread = g_out @ s_w  # [b, ho, wo]: cotangent of the window sum
    d_x = np.zeros((b, h, w))
    for i in range(ho):
        for j in range(wo):
            d_x[:, i:i + k, j:j + k] += spread[:, i, j][:, None, None]
    return np.repeat(d_x[..., None], c, axis=-1), d_sw


@pytest.mark.parametrize("k,h,c", [(3, 10, 8), (2, 9, 4), (3, 37, 16)])
def test_winsum_scale_forward_matches_numpy(k, h, c):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, h, h, 3)).astype(np.float32)
    s_w = rng.uniform(0.01, 0.2, (c,)).astype(np.float32)
    got = _winsum_scale(jnp.asarray(x), jnp.asarray(s_w), k)
    np.testing.assert_allclose(
        np.asarray(got), _winsum_scale_np(x.astype(np.float64), s_w, k),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,h,c", [(3, 10, 8), (2, 9, 4), (3, 37, 16)])
def test_winsum_scale_grad_matches_numpy(k, h, c):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, h, h, 3)).astype(np.float32)
    s_w = rng.uniform(0.01, 0.2, (c,)).astype(np.float32)
    # a non-uniform downstream cotangent so every element differs
    g_out = rng.normal(0, 1, (2, h - k + 1, h - k + 1, c))

    def loss(x_, sw_):
        return jnp.sum(_winsum_scale(x_, sw_, k) * jnp.asarray(g_out,
                                                              jnp.float32))

    g_x, g_sw = jax.grad(loss, (0, 1))(jnp.asarray(x), jnp.asarray(s_w))
    want_x, want_sw = _winsum_scale_grad_np(x.astype(np.float64), s_w, k,
                                            g_out)
    # f32 sums over up to ~2.5k window positions (d s_w) with cancelling
    # signs: the error bound scales with the largest magnitude
    for got, want in ((g_x, want_x), (g_sw, want_sw)):
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-5 * np.max(np.abs(want)))
