"""On-device data augmentation (net-new; absent upstream).

The reference trains Hippocampus from a *pre-augmented* pickle
(`train_test_augmented2.pkl`, `Hippocampus.py:479-481`) — the augmentation
itself happened in an offline pipeline that is absent from the snapshot.
This module moves it on-device: pure jittable functions applied INSIDE the
jitted train step, so augmentation runs on the device (element-wise ops +
static-shape transposes) instead of a host preprocessing pass, and composes
with the .npy-shard streaming loader to finish the tf.data-free input
pipeline the blueprint's north star names (BASELINE.json).

Design constraints honored:

- **Static shapes / no data-dependent control flow**: per-image choices are
  scalar `jnp.where` selects under `vmap`, never `lax.cond` on traced data.
- **Crop-commutation**: the model's VALID geometry center-crops labels
  symmetrically (64->54 offset 5, 204->186 offset 9), and every spatial op
  here (H/V flip, k*90-degree rotation of square frames) commutes with a
  symmetric center crop — so augmenting the full-frame image and the
  already-cropped label with the SAME draws keeps them geometrically
  consistent.
- **Sharding-invariant randomness**: each image's draws are keyed by
  `fold_in(key, global_index)`; under a data-parallel `shard_map` the
  global index is reconstructed from `lax.axis_index`, so the jit-GSPMD
  path, the shard_map path, and the single-device path produce
  bit-identical augmented batches (tested in test_augment.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from supernet_tpu.configs import AugmentConfig

Array = jax.Array

__all__ = [
    "AugmentConfig",
    "augment_batch",
    "augment_train_batch",
    "augment_volumes",
]


def _spatial_one(k: Array, img: Array, cfg: AugmentConfig) -> Array:
    """Apply the spatial draws in key ``k`` to ONE [H, W, ...] frame."""
    bits = jax.random.randint(k, (3,), 0, 4)
    if cfg.rot90:
        if img.shape[0] != img.shape[1]:
            raise ValueError(
                f"rot90 augmentation needs square frames, got {img.shape}"
            )
        rk = bits[0]
        # np.rot90(m, 1) = rev0(T), rot180 = rev0(rev1(m)), rot270 = rev1(T)
        base = jnp.where(rk % 2 == 1, jnp.swapaxes(img, 0, 1), img)
        base = jnp.where((rk == 1) | (rk == 2), base[::-1], base)
        img = jnp.where((rk == 2) | (rk == 3), base[:, ::-1], base)
    if cfg.vflip:
        img = jnp.where(bits[1] < 2, img[::-1], img)
    if cfg.hflip:
        img = jnp.where(bits[2] < 2, img[:, ::-1], img)
    return img


def _intensity_one(k: Array, img: Array, cfg: AugmentConfig) -> Array:
    ks, kd, kn = jax.random.split(k, 3)
    if cfg.intensity_scale > 0.0:
        s = jax.random.uniform(
            ks, (), img.dtype,
            1.0 - cfg.intensity_scale, 1.0 + cfg.intensity_scale,
        )
        img = img * s
    if cfg.intensity_shift > 0.0:
        d = jax.random.uniform(
            kd, (), img.dtype,
            -cfg.intensity_shift, cfg.intensity_shift,
        )
        img = img + d
    if cfg.noise_std > 0.0:
        img = img + cfg.noise_std * jax.random.normal(
            kn, img.shape, img.dtype
        )
    return img


def _image_keys(
    key: Array, n: int, axis_name: Optional[str]
) -> Array:
    """Per-image keys from the GLOBAL image index — identical draws whether
    the batch is whole (single device / GSPMD jit) or a shard_map shard."""
    idx = jnp.arange(n)
    if axis_name is not None:
        idx = idx + jax.lax.axis_index(axis_name) * n
    return jax.vmap(jax.random.fold_in, (None, 0))(key, idx)


def augment_batch(
    key: Array,
    x: Array,
    y: Optional[Array],
    cfg: AugmentConfig,
    axis_name: Optional[str] = None,
) -> Tuple[Array, Optional[Array]]:
    """Augment a batch: ``x`` [B, H, W, C] float; ``y`` either int labels
    [B, h, w], one-hot [B, h, w, C'], or None. Spatial draws are shared
    between x and y per image; intensity/noise touch x only. Jittable,
    vmapped per image; safe inside ``shard_map`` when ``axis_name`` is the
    data axis."""
    keys = _image_keys(key, x.shape[0], axis_name)

    def one(k, xi):
        k_sp, k_int = jax.random.split(k)
        return _intensity_one(k_int, _spatial_one(k_sp, xi, cfg), cfg)

    x_out = jax.vmap(one)(keys, x)
    if y is None:
        return x_out, None

    def one_y(k, yi):
        k_sp, _ = jax.random.split(k)  # same spatial key as the image
        return _spatial_one(k_sp, yi, cfg)

    return x_out, jax.vmap(one_y)(keys, y)


def augment_train_batch(
    step: Array,
    x: Array,
    y: Array,
    out_size: int,
    cfg: AugmentConfig,
    seed: int,
    axis_name: Optional[str] = None,
) -> Tuple[Array, Array]:
    """Train-step entry: key derived from the step counter, label restored
    to whatever form it arrived in (int map [B, h, w] or flattened one-hot
    [B, h*w, C])."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    if y.ndim == 3 and y.shape[1:] == (out_size, out_size):
        y_sp = y  # int label maps
        flat = False
    else:  # [B, h*w, C] flattened one-hot
        y_sp = y.reshape(y.shape[0], out_size, out_size, -1)
        flat = True
    x_out, y_out = augment_batch(key, x, y_sp, cfg, axis_name)
    if flat:
        y_out = y_out.reshape(y.shape)
    return x_out, y_out


def _spatial_one_3d(k: Array, vol: Array, cfg: AugmentConfig) -> Array:
    """Spatial draws for ONE [D, H, W, ...] volume: independent p=0.5 flips
    on each of the three axes, plus (cfg.rot90) a random quarter turn in
    the axial H-W plane — the medically meaningful rotation (the D axis is
    the scan direction)."""
    bits = jax.random.randint(k, (4,), 0, 4)
    if cfg.rot90:
        if vol.shape[1] != vol.shape[2]:
            raise ValueError(
                f"axial rot90 needs square H/W, got {vol.shape}"
            )
        rk = bits[0]
        base = jnp.where(rk % 2 == 1, jnp.swapaxes(vol, 1, 2), vol)
        base = jnp.where((rk == 1) | (rk == 2), base[:, ::-1], base)
        vol = jnp.where((rk == 2) | (rk == 3), base[:, :, ::-1], base)
    # axis gating matches the config's field docs: dflip = scan direction,
    # vflip = H, hflip = W (bit assignment is fixed so the all-True
    # default draws the same augmentations as before dflip existed)
    if cfg.dflip:  # D (scan) axis
        vol = jnp.where(bits[1] < 2, vol[::-1], vol)
    if cfg.vflip:  # H axis
        vol = jnp.where(bits[2] < 2, vol[:, ::-1], vol)
    if cfg.hflip:  # W axis
        vol = jnp.where(bits[3] < 2, vol[:, :, ::-1], vol)
    return vol


def augment_volumes(
    key: Array,
    x: Array,
    y: Optional[Array],
    cfg: AugmentConfig,
    axis_name: Optional[str] = None,
) -> Tuple[Array, Optional[Array]]:
    """Volumetric analog of `augment_batch`: ``x`` [B, D, H, W, C] float,
    ``y`` int cubes [B, d, h, w] or None. Spatial draws shared per volume
    between image and label; intensity/noise on the image only. Every
    spatial op commutes with the symmetric center crop, so the full-size
    image and the pre-cropped label stay geometrically consistent."""
    keys = _image_keys(key, x.shape[0], axis_name)

    def one(k, xi):
        k_sp, k_int = jax.random.split(k)
        return _intensity_one(k_int, _spatial_one_3d(k_sp, xi, cfg), cfg)

    x_out = jax.vmap(one)(keys, x)
    if y is None:
        return x_out, None

    def one_y(k, yi):
        k_sp, _ = jax.random.split(k)
        return _spatial_one_3d(k_sp, yi, cfg)

    return x_out, jax.vmap(one_y)(keys, y)
