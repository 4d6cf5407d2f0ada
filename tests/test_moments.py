"""Unit tests for the moment-propagation primitives (SURVEY.md §4.1-4.2).

Three layers of evidence:
1. Fused conv-form ops == naive patch-matmul transliteration of the
   reference algorithm (exact algorithmic parity).
2. Fused ops == independent NumPy loop implementations of the cited formulas.
3. Monte-Carlo agreement: sampling weights from N(w_mu, softplus(w_sigma))
   reproduces the propagated mean/variance (the Taylor approximations'
   ground truth).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from supernet_tpu.ops import moments
from supernet_tpu.ops import (
    vconv,
    vconv_input,
    vcrop_concat,
    vmaxpool,
    vpad,
    vrelu,
    vsoftmax,
    vunpool,
)
from supernet_tpu.ops.naive import (
    extract_patches,
    vconv_input_naive,
    vconv_naive,
    vsoftmax_naive,
)

RNG = np.random.default_rng(0)


def _rand(*shape, positive=False):
    x = RNG.standard_normal(shape).astype(np.float32)
    return np.abs(x) * 0.1 if positive else x


# ---------------------------------------------------------------- patches


def test_extract_patches_matches_manual():
    x = _rand(2, 6, 7, 3)
    k = 3
    got = np.asarray(extract_patches(jnp.asarray(x), k))
    b, ho, wo = 2, 4, 5
    assert got.shape == (b, ho, wo, k * k * 3)
    for i in range(ho):
        for j in range(wo):
            want = x[:, i : i + k, j : j + k, :].reshape(b, -1)
            np.testing.assert_allclose(got[:, i, j, :], want, rtol=1e-6)


# ---------------------------------------------------------------- vconv


@pytest.mark.parametrize("k,stride", [(2, 1), (3, 1), (3, 2), (5, 2)])
def test_winsum_shift_matches_conv(k, stride):
    """The separable shift-add window sum (SUPERNET_WINSUM=shift, slice
    adds) equals the ones-kernel conv lowering in value AND in jit(grad) —
    the FGSM/PGD contract."""
    x = jnp.asarray(_rand(2, 13, 11, 5))
    prev = moments.get_winsum()
    try:
        moments.set_winsum("conv")
        ref = moments._window_sum(x, k, stride)
        g_ref = jax.jit(
            jax.grad(lambda a: jnp.sum(moments._window_sum(a, k, stride) ** 2))
        )(x)
        moments.set_winsum("shift")
        got = moments._window_sum(x, k, stride)
        g_got = jax.jit(
            jax.grad(lambda a: jnp.sum(moments._window_sum(a, k, stride) ** 2))
        )(x)
    finally:
        moments.set_winsum(prev)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_got, g_ref, rtol=1e-4, atol=1e-4)


def test_winsum_shift_matches_conv_3d():
    from supernet_tpu.ops import moments3d

    x = jnp.asarray(_rand(2, 9, 11, 13, 3))
    prev = moments.get_winsum()
    try:
        moments.set_winsum("conv")
        ref = moments3d._window_sum3d(x, 3, 1)
        moments.set_winsum("shift")
        got = moments3d._window_sum3d(x, 3, 1)
    finally:
        moments.set_winsum(prev)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_sw_scale_and_chansum_modes_agree():
    """The dot lowerings of the `winsum * s_w` scale (SUPERNET_SW_SCALE)
    and the channel sum (SUPERNET_CHANSUM) equal the broadcast-mul /
    lane-reduce defaults in value AND jit(grad) — in f32 they are
    bit-exact (a size-1 contraction and a ones mat-vec do the same
    arithmetic); kept A/B-able."""
    from supernet_tpu.ops import moments3d

    mu = jnp.asarray(_rand(2, 9, 9, 4))
    sg = jnp.asarray(_rand(2, 9, 9, 4, positive=True))
    w_mu = jnp.asarray(_rand(3, 3, 4, 6) * 0.1)
    w_sigma = jnp.asarray(RNG.uniform(-12, -2, 6).astype(np.float32))
    mu3 = jnp.asarray(_rand(1, 7, 7, 7, 3))
    sg3 = jnp.asarray(_rand(1, 7, 7, 7, 3, positive=True))
    w_mu3 = jnp.asarray(_rand(3, 3, 3, 3, 4) * 0.1)
    w_sigma3 = jnp.asarray(RNG.uniform(-12, -2, 4).astype(np.float32))

    def all_outputs():
        o = list(vconv(mu, sg, w_mu, w_sigma))
        o += list(moments3d.vconv3d(mu3, sg3, w_mu3, w_sigma3))
        g = jax.jit(
            jax.grad(
                lambda w: jnp.sum(vconv(mu, sg, w_mu, w)[1] ** 2)
            )
        )(w_sigma)
        o.append(g)
        return [np.asarray(t) for t in o]

    prev_sw, prev_cs = moments.get_sw_scale(), moments.get_chansum()
    try:
        moments.set_sw_scale("mul")
        moments.set_chansum("reduce")
        ref = all_outputs()
        moments.set_sw_scale("dot")
        moments.set_chansum("dot")
        got = all_outputs()
    finally:
        moments.set_sw_scale(prev_sw)
        moments.set_chansum(prev_cs)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fold", ["none", "sigma", "full"])
def test_conv_fold_modes_agree(fold):
    """The folded variance paths (winsum riding the sigma/mu conv as extra
    channels, moments.py _CONV_FOLD) are numerically equal to the split
    3-kernel form for both vconv and vconv_input."""
    x = jnp.asarray(_rand(2, 9, 9, 4))
    mu = jnp.asarray(_rand(2, 9, 9, 4))
    sg = jnp.asarray(_rand(2, 9, 9, 4, positive=True))
    w_mu = jnp.asarray(_rand(3, 3, 4, 6) * 0.1)
    w_sigma = jnp.asarray(RNG.uniform(-12, -2, 6).astype(np.float32))
    prev = moments.get_conv_fold()
    try:
        moments.set_conv_fold("none")
        ref_i = vconv_input(x, w_mu, w_sigma)
        ref_c = vconv(mu, sg, w_mu, w_sigma)
        moments.set_conv_fold(fold)
        got_i = vconv_input(x, w_mu, w_sigma)
        got_c = vconv(mu, sg, w_mu, w_sigma)
    finally:
        moments.set_conv_fold(prev)
    for a, b in zip(ref_i + ref_c, got_i + got_c):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k,cin,cout", [(3, 1, 8), (2, 4, 6), (1, 5, 3)])
def test_vconv_input_matches_naive(k, cin, cout):
    x = jnp.asarray(_rand(2, 9, 9, cin))
    w_mu = jnp.asarray(_rand(k, k, cin, cout) * 0.1)
    w_sigma = jnp.asarray(RNG.uniform(-12, -2, cout).astype(np.float32))
    mu_a, sg_a = vconv_input(x, w_mu, w_sigma)
    mu_b, sg_b = vconv_input_naive(x, w_mu, w_sigma)
    np.testing.assert_allclose(mu_a, mu_b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sg_a, sg_b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("k,cin,cout", [(3, 2, 8), (2, 8, 4), (1, 6, 3)])
def test_vconv_matches_naive(k, cin, cout):
    mu = jnp.asarray(_rand(2, 8, 8, cin))
    sigma = jnp.asarray(_rand(2, 8, 8, cin, positive=True))
    w_mu = jnp.asarray(_rand(k, k, cin, cout) * 0.1)
    w_sigma = jnp.asarray(RNG.uniform(-12, -2, cout).astype(np.float32))
    mu_a, sg_a = vconv(mu, sigma, w_mu, w_sigma)
    mu_b, sg_b = vconv_naive(mu, sigma, w_mu, w_sigma)
    np.testing.assert_allclose(mu_a, mu_b, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sg_a, sg_b, rtol=1e-5, atol=1e-7)


def test_vconv_input_numpy_loop():
    """Independent O(everything) NumPy loop of Hippocampus.py:125-136."""
    x = _rand(1, 5, 5, 2)
    k, cout = 3, 4
    w_mu = _rand(k, k, 2, cout) * 0.2
    w_sigma = RNG.uniform(-6, -2, cout).astype(np.float32)
    s_w = np.log1p(np.exp(w_sigma))
    mu, sg = vconv_input(jnp.asarray(x), jnp.asarray(w_mu), jnp.asarray(w_sigma))
    for i in range(3):
        for j in range(3):
            patch = x[0, i : i + k, j : j + k, :]
            for c in range(cout):
                m = np.sum(patch * w_mu[:, :, :, c])
                v = np.sum(patch**2) * s_w[c]
                assert abs(mu[0, i, j, c] - m) < 1e-4
                # f32 accumulation-order differences (reduce_window vs numpy
                # sum) plus softplus implementation differences give ~1e-4
                # relative error; tolerance scaled accordingly.
                assert abs(sg[0, i, j, c] - v) < 1e-5 + 5e-4 * abs(v)


def test_vconv_monte_carlo():
    """MC ground truth: sample w ~ N(w_mu, softplus(w_sigma)) and x ~
    N(mu, sigma); empirical moments of conv(x, w) must match vconv."""
    key = jax.random.PRNGKey(42)
    cin, cout, k = 2, 3, 3
    mu = jnp.asarray(_rand(1, 6, 6, cin))
    sigma = jnp.asarray(_rand(1, 6, 6, cin, positive=True) + 0.05)
    w_mu = jnp.asarray(_rand(k, k, cin, cout) * 0.3)
    w_sigma = jnp.asarray(RNG.uniform(-4, -2, cout).astype(np.float32))
    s_w = jax.nn.softplus(w_sigma)

    n = 200_000
    kx, kw = jax.random.split(key)
    xs = mu + jnp.sqrt(sigma) * jax.random.normal(kx, (n, 6, 6, cin))
    ws = w_mu + jnp.sqrt(s_w)[None, None, None, :] * jax.random.normal(
        kw, (n, k, k, cin, cout)
    )

    def one(x, w):
        return jax.lax.conv_general_dilated(
            x[None], w, (1, 1), "VALID",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )[0]

    ys = jax.vmap(one)(xs, ws)
    emp_mean = jnp.mean(ys, axis=0)
    emp_var = jnp.var(ys, axis=0)
    mu_out, sg_out = vconv(mu, sigma, w_mu, w_sigma)
    np.testing.assert_allclose(emp_mean, mu_out[0], atol=0.02)
    # Analytic variance for independent x, w:
    #   Var = sum[ mu^2 s_w + sigma w_mu^2 + sigma s_w ]  == vconv's sigma_out
    np.testing.assert_allclose(emp_var, sg_out[0], rtol=0.05, atol=0.02)


# ---------------------------------------------------------------- vrelu


def test_vrelu():
    mu = jnp.asarray([[-1.0, 0.0, 2.0]])
    sg = jnp.asarray([[0.5, 0.5, 0.5]])
    mu_o, sg_o = vrelu(mu, sg)
    np.testing.assert_allclose(mu_o, [[0.0, 0.0, 2.0]])
    # TF relu grad at exactly 0 is 0 -> variance killed there too.
    np.testing.assert_allclose(sg_o, [[0.0, 0.0, 0.5]])


def test_vrelu_monte_carlo_first_order():
    """For |mu| >> sqrt(sigma) the first-order Taylor variance is near-exact."""
    key = jax.random.PRNGKey(0)
    mu = jnp.asarray([[3.0, -3.0]])
    sigma = jnp.asarray([[0.04, 0.04]])
    xs = mu + jnp.sqrt(sigma) * jax.random.normal(key, (100_000, 2))
    emp_var = jnp.var(jax.nn.relu(xs), axis=0)
    _, sg_o = vrelu(mu, sigma)
    np.testing.assert_allclose(emp_var, sg_o[0], rtol=0.05, atol=1e-4)


# ---------------------------------------------------------------- vmaxpool


def test_vmaxpool_gathers_sigma_at_argmax():
    mu = np.zeros((1, 4, 4, 1), np.float32)
    sigma = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    # Put the max of each 2x2 window at a known position.
    mu[0, 1, 0, 0] = 5.0  # window (0,0): max at local (1,0) -> sigma 4
    mu[0, 0, 3, 0] = 7.0  # window (0,1): max at local (0,1) -> sigma 3
    mu[0, 3, 1, 0] = 2.0  # window (1,0): max at local (1,1) -> sigma 13
    # window (1,1): all-zero mu => tie -> first element (2,2) -> sigma 10
    mu_o, sg_o = vmaxpool(jnp.asarray(mu), jnp.asarray(sigma))
    np.testing.assert_allclose(
        np.asarray(mu_o)[0, :, :, 0], [[5.0, 7.0], [2.0, 0.0]]
    )
    np.testing.assert_allclose(
        np.asarray(sg_o)[0, :, :, 0], [[4.0, 3.0], [13.0, 10.0]]
    )


def test_vmaxpool_odd_size():
    mu = jnp.asarray(_rand(2, 5, 5, 3))
    sigma = jnp.asarray(_rand(2, 5, 5, 3, positive=True))
    mu_o, sg_o = vmaxpool(mu, sigma)
    assert mu_o.shape == (2, 3, 3, 3)
    # Bottom-right corner window contains just element (4,4).
    np.testing.assert_allclose(mu_o[:, 2, 2, :], mu[:, 4, 4, :])
    np.testing.assert_allclose(sg_o[:, 2, 2, :], sigma[:, 4, 4, :])
    # the naive oracle SAME-pads odd dims identically (it used to truncate)
    from supernet_tpu.ops.naive import vmaxpool_naive

    mu_n, sg_n = vmaxpool_naive(mu, sigma)
    np.testing.assert_array_equal(np.asarray(mu_o), np.asarray(mu_n))
    np.testing.assert_array_equal(np.asarray(sg_o), np.asarray(sg_n))


# ---------------------------------------------------------------- vunpool


def test_vunpool_pattern():
    """The documented pattern of Hippocampus.py:26-51: [[1,2],[3,4]] ->
    5x5 with values at odd (row, col)."""
    x = jnp.asarray([[1.0, 2.0], [3.0, 4.0]]).reshape(1, 2, 2, 1)
    mu_o, sg_o = vunpool(x, x * 10)
    want = np.zeros((5, 5), np.float32)
    want[1, 1], want[1, 3], want[3, 1], want[3, 3] = 1, 2, 3, 4
    np.testing.assert_allclose(np.asarray(mu_o)[0, :, :, 0], want)
    np.testing.assert_allclose(np.asarray(sg_o)[0, :, :, 0], want * 10)


# ---------------------------------------------------------------- vpad


def test_vpad_sigma_fill():
    mu = jnp.ones((1, 2, 2, 1))
    sg = jnp.ones((1, 2, 2, 1))
    mu_o, sg_o = vpad(mu, sg, (2, 2), sigma_fill=0.02)
    assert mu_o.shape == (1, 6, 6, 1)
    assert float(mu_o[0, 0, 0, 0]) == 0.0
    assert abs(float(sg_o[0, 0, 0, 0]) - 0.02) < 1e-7
    assert float(sg_o[0, 2, 2, 0]) == 1.0


def test_vpad_asymmetric():
    """mypad1 = [1, 0]: 1 px on top/left only (Brats.py:370, 9 -> 10)."""
    mu = jnp.ones((1, 9, 9, 1))
    mu_o, sg_o = vpad(mu, mu, (1, 0), sigma_fill=0.1)
    assert mu_o.shape == (1, 10, 10, 1)
    assert float(mu_o[0, 0, 5, 0]) == 0.0 and float(mu_o[0, 9, 5, 0]) == 1.0


# ---------------------------------------------------------------- concat


def test_vcrop_concat():
    mu_e = jnp.asarray(_rand(2, 8, 8, 3))
    sg_e = jnp.asarray(_rand(2, 8, 8, 3, positive=True))
    mu_d = jnp.asarray(_rand(2, 4, 4, 5))
    sg_d = jnp.asarray(_rand(2, 4, 4, 5, positive=True))
    mu_o, sg_o = vcrop_concat(mu_d, sg_d, mu_e, sg_e)
    assert mu_o.shape == (2, 4, 4, 8)
    np.testing.assert_allclose(mu_o[..., :5], mu_d)
    np.testing.assert_allclose(mu_o[..., 5:], mu_e[:, 2:6, 2:6, :])
    np.testing.assert_allclose(sg_o[..., 5:], sg_e[:, 2:6, 2:6, :])


# ---------------------------------------------------------------- vsoftmax


def test_vsoftmax_matches_naive_jacobian_form():
    mu = jnp.asarray(_rand(2, 4, 4, 5))
    sg = jnp.asarray(_rand(2, 4, 4, 5, positive=True))
    p_a, sg_a = vsoftmax(mu, sg)
    p_b, sg_b = vsoftmax_naive(mu, sg)
    assert p_a.shape == (2, 16, 5)
    np.testing.assert_allclose(p_a, p_b, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sg_a, sg_b, rtol=1e-5, atol=1e-7)


def test_vsoftmax_keeps_batch_dim_when_one():
    """Regression for the reference's B==1 squeeze hazard (SURVEY §2.7.7)."""
    mu = jnp.asarray(_rand(1, 3, 3, 3))
    sg = jnp.asarray(_rand(1, 3, 3, 3, positive=True))
    p, s = vsoftmax(mu, sg)
    assert p.shape == (1, 9, 3) and s.shape == (1, 9, 3)


def test_vunpool_conv2_matches_composition():
    """Fused unpool+2x2conv == vunpool followed by vconv (forward and grad)."""
    rng = np.random.default_rng(7)
    mu = jnp.asarray(rng.normal(0, 1, (2, 5, 5, 8)).astype(np.float32))
    sg = jnp.abs(jnp.asarray(rng.normal(0, 1, (2, 5, 5, 8)).astype(np.float32)))
    w = jnp.asarray(0.3 * rng.normal(0, 1, (2, 2, 8, 4)).astype(np.float32))
    ws = jnp.asarray(rng.normal(0, 1, (4,)).astype(np.float32) - 4.0)

    m_ref, s_ref = moments.vconv(*moments.vunpool(mu, sg), w, ws)
    m_fused, s_fused = moments.vunpool_conv2(mu, sg, w, ws)
    assert m_fused.shape == m_ref.shape == (2, 10, 10, 4)
    np.testing.assert_allclose(np.asarray(m_fused), np.asarray(m_ref), atol=1e-5)
    np.testing.assert_allclose(np.asarray(s_fused), np.asarray(s_ref), atol=1e-5)

    def loss_ref(mu, sg, w, ws):
        a, b = moments.vconv(*moments.vunpool(mu, sg), w, ws)
        return jnp.sum(a * a) + jnp.sum(jnp.sin(b))

    def loss_fused(mu, sg, w, ws):
        a, b = moments.vunpool_conv2(mu, sg, w, ws)
        return jnp.sum(a * a) + jnp.sum(jnp.sin(b))

    g_ref = jax.grad(loss_ref, (0, 1, 2, 3))(mu, sg, w, ws)
    g_fused = jax.grad(loss_fused, (0, 1, 2, 3))(mu, sg, w, ws)
    for a, b in zip(g_fused, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4)


def test_vmaxpool_tie_gradient_routes_to_first():
    """TF max_pool gradient parity: on ties the full gradient goes to the
    FIRST (row-major) max element, not split across ties (jnp.maximum alone
    would split 0.5/0.5 — ties are ubiquitous right after ReLU)."""
    mu = jnp.zeros((1, 2, 2, 1))  # all-tie window
    sg = jnp.ones((1, 2, 2, 1))

    g = jax.grad(lambda m: jnp.sum(vmaxpool(m, sg)[0]))(mu)
    np.testing.assert_array_equal(
        np.asarray(g)[0, :, :, 0], [[1.0, 0.0], [0.0, 0.0]]
    )
    # sigma is taken from the same first-max element
    s_out = vmaxpool(mu, jnp.asarray([[[[1.0], [2.0]], [[3.0], [4.0]]]]))[1]
    assert float(s_out[0, 0, 0, 0]) == 1.0


def test_vmaxpool_custom_bwd_matches_where_tree():
    """The custom-VJP backward (interleave form, no scatters — see
    moments._vmaxpool_bwd) must equal the gradients of a plain jnp
    where-tree formulation on random inputs, both moments, incl. the
    odd-spatial SAME-pad branch."""

    def pool_naive(mu, sigma):
        b, h, w, c = mu.shape
        hp, wp = -(-h // 2) * 2, -(-w // 2) * 2
        if (hp, wp) != (h, w):
            pad = ((0, 0), (0, hp - h), (0, wp - w), (0, 0))
            mu = jnp.pad(mu, pad, constant_values=-jnp.inf)
            sigma = jnp.pad(sigma, pad)
        m00, m01 = mu[:, 0::2, 0::2, :], mu[:, 0::2, 1::2, :]
        m10, m11 = mu[:, 1::2, 0::2, :], mu[:, 1::2, 1::2, :]
        mx = jax.lax.stop_gradient(
            jnp.maximum(jnp.maximum(m00, m01), jnp.maximum(m10, m11))
        )

        def sel(t00, t01, t10, t11):
            return jnp.where(
                m00 == mx, t00,
                jnp.where(m01 == mx, t01, jnp.where(m10 == mx, t10, t11)),
            )

        return sel(m00, m01, m10, m11), sel(
            sigma[:, 0::2, 0::2, :], sigma[:, 0::2, 1::2, :],
            sigma[:, 1::2, 0::2, :], sigma[:, 1::2, 1::2, :],
        )

    rng = np.random.default_rng(11)
    for shape in [(2, 6, 6, 3), (2, 5, 7, 3)]:
        # quantized values force plenty of exact ties (as after ReLU)
        mu = jnp.asarray(
            np.round(rng.normal(0, 1, shape) * 2) / 2
        ).astype(jnp.float32)
        sg = jnp.abs(jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)))

        for f in (vmaxpool, pool_naive):
            a, b = f(mu, sg)
        np.testing.assert_array_equal(
            np.asarray(vmaxpool(mu, sg)[0]), np.asarray(pool_naive(mu, sg)[0])
        )

        def loss(fn):
            return lambda m, s: (
                jnp.sum(jnp.sin(fn(m, s)[0])) + jnp.sum(jnp.cos(fn(m, s)[1]))
            )

        g_fast = jax.grad(loss(vmaxpool), (0, 1))(mu, sg)
        g_ref = jax.grad(loss(pool_naive), (0, 1))(mu, sg)
        for x, y in zip(g_fast, g_ref):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=1e-6)


def test_act_dtype_bfloat16_mode():
    """bf16 activation mode: forward agrees with f32 within bf16 tolerance,
    the head still emits f32, param grads come back f32, and k=1 conv takes
    the einsum path in both dtypes."""
    from supernet_tpu.configs import HIPPOCAMPUS
    from supernet_tpu.models import init_params
    from supernet_tpu.models.unet import forward

    cfg = HIPPOCAMPUS.model
    x = jnp.asarray(RNG.normal(0, 1, (2, 64, 64, 1)).astype(np.float32))
    params = init_params(jax.random.PRNGKey(3), cfg)
    p32, s32 = forward(params, x, cfg)
    try:
        moments.set_act_dtype("bfloat16")
        p16, s16 = forward(params, x, cfg)
        assert p16.dtype == jnp.float32 and s16.dtype == jnp.float32
        # probabilities: absolute tolerance; bf16 has ~3 decimal digits
        np.testing.assert_allclose(
            np.asarray(p16), np.asarray(p32), atol=0.03
        )
        # per-pixel predicted class almost always agrees
        agree = np.mean(
            np.argmax(np.asarray(p16), -1) == np.argmax(np.asarray(p32), -1)
        )
        assert agree > 0.99

        def loss(params):
            p, s = forward(params, x, cfg)
            return jnp.mean(jnp.square(p)) + jnp.mean(s)

        g = jax.grad(loss)(params)
        flat = jax.tree.leaves(g)
        assert all(a.dtype == jnp.float32 for a in flat)
        assert all(np.isfinite(np.asarray(a)).all() for a in flat)
    finally:
        moments.set_act_dtype("float32")


# ------------------------------------------------- full-model MC validation


def test_full_model_monte_carlo():
    """FULL-MODEL Monte-Carlo ground truth (the per-op MC tests above
    validate each layer; this validates the composition): sample weights
    from the posterior, run the deterministic twin (`forward_sampled`)
    4000 times, and compare empirical output moments with ONE propagated
    forward. Expected from the method's approximations (first-order
    Taylor through relu/softmax, diagonal covariance through convs):
    the MEAN matches tightly, the variance is median-calibrated
    (ratio ~ 1.005 measured) with positive but imperfect pixel-wise
    correlation (~0.76 measured) — the tails carry the diagonal
    approximation error."""
    import dataclasses

    from supernet_tpu.configs import HIPPOCAMPUS
    from supernet_tpu.models import (
        forward,
        forward_sampled,
        init_params,
        sample_weights,
    )

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=4
    )
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(0, 1, (1, 32, 32, 1)).astype(np.float32))
    params = init_params(jax.random.PRNGKey(0), cfg)
    # shift the raw sigmas up so weight variance dominates MC noise
    params = {
        k: {"w_mu": v["w_mu"], "w_sigma": v["w_sigma"] + 3.0}
        for k, v in params.items()
    }
    probs, sigma = forward(params, x, cfg)

    n = 4000
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    f = jax.jit(lambda k: forward_sampled(sample_weights(params, k), x, cfg))
    outs = jax.lax.map(f, keys)  # [n, 1, HW, C]
    emp_mean = np.asarray(jnp.mean(outs, 0))[0]
    emp_var = np.asarray(jnp.var(outs, 0))[0]
    p, s = np.asarray(probs)[0], np.asarray(sigma)[0]

    assert np.abs(emp_mean - p).max() < 0.03
    assert np.abs(emp_mean - p).mean() < 0.01
    corr = np.corrcoef(emp_var.ravel(), s.ravel())[0, 1]
    assert corr > 0.6
    m = emp_var.ravel() > 1e-8
    ratio = np.median(s.ravel()[m] / emp_var.ravel()[m])
    assert 0.7 < ratio < 1.4


def test_forward_sampled_geometry_matches_forward():
    """The deterministic twin reproduces BOTH documented size chains
    (64->54 and the BraTS 204->186 with the asymmetric bottleneck pad) —
    eval_shape only, no FLOPs."""
    from supernet_tpu.configs import BRATS, HIPPOCAMPUS
    from supernet_tpu.models import forward, forward_sampled, init_params

    for exp in (HIPPOCAMPUS, BRATS):
        cfg = exp.model
        params = jax.eval_shape(
            lambda key, c=cfg: init_params(key, c), jax.random.PRNGKey(0)
        )
        weights = {n: p["w_mu"] for n, p in params.items()}
        x = jax.ShapeDtypeStruct(
            (2, cfg.image_size, cfg.image_size, cfg.in_channels),
            jnp.float32,
        )
        det = jax.eval_shape(lambda w, xx, c=cfg: forward_sampled(w, xx, c),
                             weights, x)
        vdp = jax.eval_shape(lambda p, xx, c=cfg: forward(p, xx, c),
                             params, x)
        assert det.shape == vdp[0].shape == (
            2, cfg.out_size * cfg.out_size, cfg.n_classes
        )


def test_vconv_im2col_matches_conv_form():
    """SUPERNET_CONV2D=im2col (packed k^2*C_in contraction dot) == the
    conv lowering, forward AND gradients — the 2-D twin of the 3-D
    contraction-packing A/B knob."""
    from supernet_tpu.ops import moments as m

    rng = np.random.default_rng(3)
    cin, cout, hw = 3, 4, 10
    x = rng.normal(0, 1, (2, hw, hw, cin)).astype(np.float32)
    sigma = np.abs(rng.normal(0, 1, (2, hw, hw, cin))).astype(np.float32)
    w_sigma = rng.uniform(-5, -2, cout).astype(np.float32)
    for k in (2, 3):
        w_mu = (rng.normal(0, 1, (k, k, cin, cout)) * 0.3).astype(
            np.float32
        )
        args = (jnp.asarray(x), jnp.asarray(sigma),
                jnp.asarray(w_mu), jnp.asarray(w_sigma))

        def loss(mu, sg, wm, ws):
            a, b = m.vconv(mu, sg, wm, ws)
            return jnp.sum(a * 0.3) + jnp.sum(b * 0.7)

        try:
            m.set_conv2d_impl("im2col")
            mu_i, sg_i = m.vconv(*args)
            gi = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
            in_i = m.vconv_input(args[0], args[2], args[3])
        finally:
            m.set_conv2d_impl("conv")
        mu_c, sg_c = m.vconv(*args)
        gc = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
        in_c = m.vconv_input(args[0], args[2], args[3])
        np.testing.assert_allclose(mu_i, mu_c, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sg_i, sg_c, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(in_i[0], in_c[0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(in_i[1], in_c[1], rtol=1e-5, atol=1e-5)
        for a, b in zip(gi, gc):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="conv2d impl"):
        m.set_conv2d_impl("magic")
