"""Adversarial attacks: FGSM gradient-sign and the PGD loop, jitted end-to-end.

Reference: ``create_adversarial_pattern`` (`Hippocampus.py:533-547`,
`Brats.py:582-596`) and the adversarial test branches
(`Hippocampus.py:894-1003`, `Brats.py:951-1037`):

- the attack loss is ``0.5 * nll_gaussian(y, probs, clip(sigma))`` with the
  attack-specific clip range ``[-1e4, 1e3]`` (`Hippocampus.py:539`);
- FGSM: ``sign(d loss / d x)`` with the model frozen;
- PGD: ``maxAdvStep`` iterations of ``adv_x += stepSize * sign``, each step
  projected into the epsilon-ball ``[x - eps, x + eps]`` AND the data range
  ``[x_min, x_max]`` (`Hippocampus.py:912-933`);
- targeted mode rewrites the label before the loss: every pixel of class
  ``adversary_targeted_class`` is relabeled ``adv_class``
  (`Hippocampus.py:914-916` — np.ma masked_where + fill, here a jnp.where);
- BraTS untargeted mode is a single FGSM step (`Brats.py:984-991`).

Design: the whole PGD loop is one ``lax.fori_loop`` inside a
single jit — the reference re-enters a ``tf.function`` per step from Python,
paying a host round-trip per iteration.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from supernet_tpu.configs import AttackConfig, ModelConfig
from supernet_tpu.losses import nll_gaussian
from supernet_tpu.models import forward

Array = jax.Array
Params = Dict[str, Dict[str, Array]]


def retarget_labels(
    y: Array, targeted_class: int, adv_class: int
) -> Array:
    """Replace ``targeted_class`` with ``adv_class`` in integer labels
    (`Hippocampus.py:914-916`)."""
    return jnp.where(y == targeted_class, jnp.asarray(adv_class, y.dtype), y)


def attack_loss(
    params: Params,
    x: Array,
    y: Array,
    cfg: ModelConfig,
    ac: AttackConfig,
    forward_fn=forward,
) -> Array:
    """``0.5 * nll_gaussian(y, probs, clip(sigma))`` (`Hippocampus.py:538-541`).

    ``y`` is one-hot flattened [B, N, C] (already retargeted if targeted).
    ``forward_fn`` selects the model family (default 2-D `models.forward`;
    pass `models.forward3d` to attack the volumetric family).
    """
    probs, sigma = forward_fn(params, x, cfg)
    sigma_c = jnp.clip(sigma, ac.sigma_clip_min, ac.sigma_clip_max)
    return 0.5 * nll_gaussian(y, probs, sigma_c)


def fgsm_sign(
    params: Params,
    x: Array,
    y: Array,
    cfg: ModelConfig,
    ac: AttackConfig,
    forward_fn=forward,
) -> Array:
    """``sign(d attack_loss / d x)`` — the FGSM perturbation direction."""
    grad = jax.grad(attack_loss, argnums=1)(params, x, y, cfg, ac, forward_fn)
    return jnp.sign(grad)


def _attack_jit(fn, mesh, axis_name: str, x_spec=None, y_spec=None):
    """jit an ``attack(params, x, y_flat, x_min, x_max)`` function; with a
    mesh, the batch (and label) are sharded over the devices and parameters
    replicated, so every forward+backward of the attack loop runs
    data-parallel (each device attacks its own shard — the perturbation is
    per-sample, so no collective is needed).

    ``x_spec``/``y_spec`` override the default batch-axis PartitionSpec —
    the 3-D family shards the volume's D axis instead (x_spec=
    P(None, axis) with the flattened label replicated, y_spec=P())."""
    if mesh is None:
        return jax.jit(fn)
    from jax.sharding import NamedSharding, PartitionSpec as P

    repl = NamedSharding(mesh, P())
    x_sh = NamedSharding(mesh, P(axis_name) if x_spec is None else x_spec)
    y_sh = (
        NamedSharding(mesh, P(axis_name))
        if y_spec is None
        else NamedSharding(mesh, y_spec)
    )
    return jax.jit(
        fn,
        in_shardings=(repl, x_sh, y_sh, repl, repl),
        out_shardings=x_sh,
    )


def make_pgd_attack(
    cfg: ModelConfig,
    ac: AttackConfig,
    mesh=None,
    axis_name: str = "data",
    forward_fn=forward,
    x_spec=None,
    y_spec=None,
):
    """Jitted PGD: returns ``attack(params, x, y_flat, x_min, x_max) -> adv_x``.

    ``y_flat`` is the (possibly retargeted) one-hot flattened label. The
    per-step projection matches `Hippocampus.py:930-932`:
    clip(adv, x - eps, x + eps) then clip(adv, x_min, x_max). Scalars
    ``x_min``/``x_max`` are the per-batch data range the reference computes
    host-side (`Hippocampus.py:906-907`). With ``mesh``, the whole loop is
    batch-sharded over the devices (net-new vs the single-device reference).
    """

    def attack(
        params: Params, x: Array, y_flat: Array, x_min: Array, x_max: Array
    ) -> Array:
        def body(_, adv_x):
            sign = fgsm_sign(params, adv_x, y_flat, cfg, ac, forward_fn)
            adv_x = adv_x + ac.step_size * sign
            adv_x = jnp.clip(adv_x, x - ac.epsilon, x + ac.epsilon)
            return jnp.clip(adv_x, x_min, x_max)

        return jax.lax.fori_loop(0, ac.max_adv_step, body, x)

    return _attack_jit(attack, mesh, axis_name, x_spec, y_spec)


def make_fgsm_attack(
    cfg: ModelConfig,
    ac: AttackConfig,
    mesh=None,
    axis_name: str = "data",
    forward_fn=forward,
    x_spec=None,
    y_spec=None,
):
    """Jitted single-step FGSM (`Brats.py:984-991`):
    ``adv_x = clip(x + eps * sign, x_min, x_max)``."""

    def attack(
        params: Params, x: Array, y_flat: Array, x_min: Array, x_max: Array
    ) -> Array:
        sign = fgsm_sign(params, x, y_flat, cfg, ac, forward_fn)
        return jnp.clip(x + ac.epsilon * sign, x_min, x_max)

    return _attack_jit(attack, mesh, axis_name, x_spec, y_spec)


def make_saliency_map(
    cfg: ModelConfig,
    forward_fn=forward,
    mesh=None,
    axis_name: str = "data",
    x_spec=None,
):
    """Gradient saliency (`Brats.py:598-609`): d(sum of predicted probability
    mass of the target classes)/dx. ``class_mask`` is a [C] 0/1 vector
    selecting the classes (all-tumor = classes > 0). Returns (raw_grad,
    relu_grad) like the reference's two variants. ``forward_fn`` selects
    the model family (pass `models.forward3d` for volumetric saliency —
    both families flatten to [B, pixels, C], so the mass term is shared).

    With ``mesh``, the input (and both gradient outputs) are sharded by
    ``x_spec`` — batch axis by default, ``P(None, "data")`` for the 3-D
    family's scan axis — parameters and class mask replicated, the
    forward+backward partitioned by GSPMD like the attack loop.
    """

    def saliency(
        params: Params, x: Array, class_mask: Array
    ) -> Tuple[Array, Array]:
        def mass(xx):
            probs, _ = forward_fn(params, xx, cfg)
            return jnp.sum(probs * class_mask[None, None, :])

        g = jax.grad(mass)(x)
        return g, jax.nn.relu(g)

    if mesh is None:
        return jax.jit(saliency)
    from jax.sharding import NamedSharding, PartitionSpec as P

    repl = NamedSharding(mesh, P())
    x_sh = NamedSharding(mesh, P(axis_name) if x_spec is None else x_spec)
    return jax.jit(
        saliency,
        in_shardings=(repl, x_sh, repl),
        out_shardings=(x_sh, x_sh),
    )
