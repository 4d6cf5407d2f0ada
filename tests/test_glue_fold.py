"""The decoder glue-fold (ops.moments.vglue_conv_relu) is numerically the
explicit pad -> concat -> conv -> relu choreography.

The fold rewrites the reference's decoder glue (`Hippocampus.py:397-415`)
and the BraTS bottleneck pre-pad (`Brats.py:370-372,407`) algebraically —
zero mu-pad as conv padding, the skip crop as negative conv padding, the
concat as a kernel channel split, the constant sigma_fill ring as analytic
terms — so equality against the explicit form is the correctness proof.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supernet_tpu.configs import BRATS, HIPPOCAMPUS
from supernet_tpu.models.unet import forward, init_params, kl_regularizer
from supernet_tpu.ops import vconv, vcrop_concat, vglue_conv_relu, vpad, vrelu
from supernet_tpu.ops.moments import set_glue_fold


@pytest.fixture(autouse=True)
def _reset_glue_fold():
    yield
    set_glue_fold("none")


def _explicit(mu, sigma, w_mu, w_sigma, pad, fill, enc=None):
    m, s = vpad(mu, sigma, pad, fill)
    if enc is not None:
        m, s = vcrop_concat(m, s, enc[0], enc[1])
    return vrelu(*vconv(m, s, w_mu, w_sigma))


def _rand_pair(key, shape):
    k1, k2 = jax.random.split(key)
    mu = jax.random.normal(k1, shape, jnp.float32)
    sigma = jax.random.uniform(k2, shape, jnp.float32, 1e-4, 0.3)
    return mu, sigma


@pytest.mark.parametrize(
    "pad,fill,with_enc",
    [((3, 3), 0.02, True), ((2, 2), 0.1, False), ((1, 0), 0.1, False)],
)
def test_op_equality(pad, fill, with_enc):
    key = jax.random.PRNGKey(0)
    kd, ke, kw, ks = jax.random.split(key, 4)
    c_d = 6
    mu, sigma = _rand_pair(kd, (2, 10, 10, c_d))
    enc = None
    c_in = c_d
    if with_enc:
        enc = _rand_pair(ke, (2, 21, 21, c_d))
        c_in = 2 * c_d
    w_mu = 0.1 * jax.random.normal(kw, (3, 3, c_in, 5), jnp.float32)
    w_sigma = jax.random.uniform(ks, (5,), jnp.float32, -6.0, -4.0)

    m_ref, s_ref = _explicit(mu, sigma, w_mu, w_sigma, pad, fill, enc)
    m_f, s_f = vglue_conv_relu(
        mu, sigma, w_mu, w_sigma, pad, fill,
        None if enc is None else enc[0],
        None if enc is None else enc[1],
    )
    assert m_f.shape == m_ref.shape and s_f.shape == s_ref.shape
    np.testing.assert_allclose(m_f, m_ref, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(s_f, s_ref, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("cfgname", ["hippocampus", "brats_small"])
def test_forward_and_grad_equality(cfgname):
    """Full-model fold-vs-none equality, forward AND parameter gradients
    (the fold rewrites read patterns; its transpose must match too)."""
    if cfgname == "hippocampus":
        cfg = dataclasses.replace(HIPPOCAMPUS.model, base_kernels=4)
        size, cin = 64, 1
    else:
        # depth-5 BraTS geometry (incl. the (1,0) bottleneck pre-pad) at a
        # test-budget width
        cfg = dataclasses.replace(BRATS.model, base_kernels=2)
        size, cin = 204, 4
    key = jax.random.PRNGKey(1)
    params = init_params(key, cfg)
    x = jax.random.normal(jax.random.PRNGKey(2), (2, size, size, cin))

    def loss(p, x):
        probs, sigma = forward(p, x, cfg)
        return jnp.mean(jnp.log(sigma + 1e-3)) + jnp.mean(
            jnp.square(probs)
        ) + 0.0 * kl_regularizer(p)

    set_glue_fold("none")
    (p_ref, s_ref) = forward(params, x, cfg)
    g_ref = jax.grad(loss)(params, x)
    set_glue_fold("fold")
    (p_f, s_f) = forward(params, x, cfg)
    g_f = jax.grad(loss)(params, x)

    np.testing.assert_allclose(p_f, p_ref, rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(s_f, s_ref, rtol=3e-5, atol=3e-6)
    for name in g_ref:
        for leaf in ("w_mu", "w_sigma"):
            np.testing.assert_allclose(
                g_f[name][leaf],
                g_ref[name][leaf],
                rtol=2e-4,
                atol=2e-5,
                err_msg=f"{name}/{leaf}",
            )


@pytest.mark.parametrize("family", ["2d", "3d"])
def test_flops_shape_tap_under_fold(family):
    """flops' per-layer shape recording relies on the forward tap firing
    for EVERY named conv layer; the fold path must tap them too (a missing
    `up{j}_conv2` tap in 3-D fold mode once broke MFU reporting)."""
    from supernet_tpu import flops as F

    cfg = HIPPOCAMPUS.model
    fn = F.train_step_flops if family == "2d" else F.train_step_flops3d
    set_glue_fold("fold")
    folded = fn(cfg, 4)
    set_glue_fold("none")
    assert folded == fn(cfg, 4)  # fold changes reads, not useful FLOPs


def test_forward3d_fold_equality():
    """3-D fold vs explicit choreography: full forward3d + grads."""
    from supernet_tpu.models import forward3d, init_params3d

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=2
    )
    params = init_params3d(jax.random.PRNGKey(4), cfg)
    x = jax.random.normal(jax.random.PRNGKey(5), (1, 32, 32, 32, 1))

    def loss(p, x):
        probs, sigma = forward3d(p, x, cfg)
        return jnp.mean(jnp.log(sigma + 1e-3)) + jnp.mean(jnp.square(probs))

    set_glue_fold("none")
    p_ref, s_ref = forward3d(params, x, cfg)
    g_ref = jax.grad(loss)(params, x)
    set_glue_fold("fold")
    p_f, s_f = forward3d(params, x, cfg)
    g_f = jax.grad(loss)(params, x)
    np.testing.assert_allclose(p_f, p_ref, rtol=3e-5, atol=3e-6)
    np.testing.assert_allclose(s_f, s_ref, rtol=3e-5, atol=3e-6)
    for name in g_ref:
        for leaf in ("w_mu", "w_sigma"):
            np.testing.assert_allclose(
                g_f[name][leaf], g_ref[name][leaf],
                rtol=2e-4, atol=2e-5, err_msg=f"{name}/{leaf}",
            )
