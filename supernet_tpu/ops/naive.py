"""Patch-matmul transliteration of the reference's VDP conv algorithm.

This module reproduces, in JAX, the *algorithm* the reference uses
(`/root/reference/Hippocampus.py:125-136,178-197`): extract k x k patches,
materialize ``[B, H'W', k^2 C]`` matrices, and compute the variance terms with
dense matmuls against a broadcast per-channel kernel variance.

It exists for two reasons only:

1. **Cross-check** — unit tests assert the fused conv-form primitives in
   ``supernet_tpu.ops.moments`` produce identical moments.
2. **Benchmark baseline** — ``bench.py`` measures the fused path against this
   algorithmic baseline on the same hardware (the reference publishes no
   numbers and its GPU/TF stack is not runnable here; see BASELINE.md).

Do not use in production paths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array


def extract_patches(x: Array, k: int, stride: int = 1) -> Array:
    """VALID k x k patch extraction, mirroring ``tf.image.extract_patches``.

    Returns [B, H', W', k*k*C] with the (row, col, channel) ordering TF uses:
    the channel axis is fastest, then patch column, then patch row.
    """
    b, h, w, c = x.shape
    ho = (h - k) // stride + 1
    wo = (w - k) // stride + 1
    # Gather the k x k taps as shifted slices — avoids conv machinery entirely
    # so the test baseline shares no code with the implementation under test.
    rows = []
    for di in range(k):
        cols = []
        for dj in range(k):
            sl = lax.slice(
                x,
                (0, di, dj, 0),
                (b, di + (ho - 1) * stride + 1, dj + (wo - 1) * stride + 1, c),
                (1, stride, stride, 1),
            )
            cols.append(sl)
        rows.append(jnp.stack(cols, axis=3))  # [B, H', W', k, C]
    patches = jnp.stack(rows, axis=3)  # [B, H', W', k, k, C]
    return patches.reshape(b, ho, wo, k * k * c)


def vconv_input_naive(
    x: Array, w_mu: Array, w_sigma: Array, stride: int = 1
) -> tuple[Array, Array]:
    """Reference algorithm for the first conv (`Hippocampus.py:125-136`)."""
    k, _, cin, cout = w_mu.shape
    mu_out = lax.conv_general_dilated(
        x, w_mu, (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest",
    )
    s_w = jax.nn.softplus(w_sigma)
    vect_sigma = jnp.broadcast_to(s_w, (k * k * cin, cout))
    xp = extract_patches(x, k, stride)
    b, ho, wo, _ = xp.shape
    x_matrix = xp.reshape(b, ho * wo, k * k * cin)
    sigma = jnp.matmul(jnp.square(x_matrix), vect_sigma, precision='highest')
    return mu_out, sigma.reshape(mu_out.shape)


def vconv_naive(
    mu: Array, sigma: Array, w_mu: Array, w_sigma: Array, stride: int = 1
) -> tuple[Array, Array]:
    """Reference algorithm for intermediate convs (`Hippocampus.py:178-197`).

    sigma_out = patches(mu^2) @ bcast(s_w)      (sigma1)
              + patches(sigma) @ w_mu^2         (sigma2)
              + patches(sigma) @ bcast(s_w)     (sigma3)
    """
    k, _, cin, cout = w_mu.shape
    mu_out = lax.conv_general_dilated(
        mu, w_mu, (stride, stride), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision="highest",
    )
    s_w = jax.nn.softplus(w_sigma)
    vect_sigma = jnp.broadcast_to(s_w, (k * k * cin, cout))
    b = mu.shape[0]
    ho, wo = mu_out.shape[1], mu_out.shape[2]
    x_matrix = extract_patches(mu, k, stride).reshape(b, ho * wo, k * k * cin)
    sigma_matrix = extract_patches(sigma, k, stride).reshape(
        b, ho * wo, k * k * cin
    )
    # TF reshapes w_mu [k,k,Cin,Cout] -> [k*k*Cin, Cout]; same row-major here.
    w_mean = w_mu.reshape(k * k * cin, cout)
    sigma1 = jnp.matmul(jnp.square(x_matrix), vect_sigma, precision='highest')
    sigma2 = jnp.matmul(sigma_matrix, jnp.square(w_mean), precision='highest')
    sigma3 = jnp.matmul(sigma_matrix, vect_sigma, precision='highest')
    sigma_out = (sigma1 + sigma2 + sigma3).reshape(mu_out.shape)
    return mu_out, sigma_out


def vmaxpool_naive(mu: Array, sigma: Array) -> tuple[Array, Array]:
    """Reference algorithm for the pool (`Hippocampus.py:54-64,226-234`):
    argmax over each 2x2 window + a gather of sigma at the argmax (the
    TF ``max_pool_with_argmax`` + flat ``tf.gather`` analog, against the
    strided-slice/where tree of moments.vmaxpool)."""
    b, h, w, c = mu.shape
    # SAME-pad odd spatial dims at the bottom/right like the production
    # vmaxpool (padded mu lanes are -inf so they never win)
    ho, wo = -(-h // 2), -(-w // 2)
    if (2 * ho, 2 * wo) != (h, w):
        pad = ((0, 0), (0, 2 * ho - h), (0, 2 * wo - w), (0, 0))
        fill = jnp.finfo(mu.dtype).min
        mu = jnp.pad(mu, pad, constant_values=fill)
        sigma = jnp.pad(sigma, pad)
    # [B, ho, 2, wo, 2, C] -> windows on one axis
    mw = mu.reshape(b, ho, 2, wo, 2, c)
    sw = sigma.reshape(b, ho, 2, wo, 2, c)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(b, ho, wo, 4, c)
    sw = sw.transpose(0, 1, 3, 2, 4, 5).reshape(b, ho, wo, 4, c)
    idx = jnp.argmax(mw, axis=3)  # first occurrence, like TF
    mu_out = jnp.take_along_axis(mw, idx[:, :, :, None, :], axis=3)[
        :, :, :, 0, :
    ]
    sigma_out = jnp.take_along_axis(sw, idx[:, :, :, None, :], axis=3)[
        :, :, :, 0, :
    ]
    return mu_out, sigma_out


def vsoftmax_naive(mu: Array, sigma: Array) -> tuple[Array, Array]:
    """Reference algorithm for the softmax head (`Hippocampus.py:273-292`):
    explicit per-pixel ``(J ∘ J) @ sigma`` matmul (without the B==1 squeeze
    hazard)."""
    b, h, w, c = mu.shape
    mu_flat = mu.reshape(b, h * w, c)
    sigma_flat = sigma.reshape(b, h * w, c)
    p = jax.nn.softmax(mu_flat, axis=-1)
    pp1 = p[..., :, None]
    pp2 = p[..., None, :]
    grad = jnp.zeros((b, h * w, c, c)) + jnp.eye(c) * p[..., None, :]
    grad = grad - pp1 * pp2
    sigma_out = jnp.matmul(jnp.square(grad), sigma_flat[..., None], precision='highest')[..., 0]
    return p, sigma_out
