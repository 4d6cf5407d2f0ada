"""Jitted train/eval steps and the epoch driver.

Replaces the reference's ``@tf.function train_on_batch`` + eager epoch loops
(`Hippocampus.py:518-531,578-740`) with:

- a pure ``train_step`` (value_and_grad -> per-tensor clipnorm -> Adam),
  jitted once and donating the carried state;
- data parallelism via ``jax.jit`` over a ``Mesh`` with batch-sharded inputs
  and replicated parameters (XLA inserts the gradient psum) — see
  ``supernet_tpu.parallel``;
- host-side metric accumulation identical to the reference's epoch records.

Keras parity details: Adam(lr, clipnorm=1.0) clips EACH gradient tensor to
norm <= 1.0 *before* Adam (tf.clip_by_norm semantics), and Keras Adam uses
epsilon=1e-7.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import optax

from supernet_tpu.configs import ModelConfig, TrainConfig
from supernet_tpu.losses import elbo_loss, nll_gaussian
from supernet_tpu.models import forward, kl_regularizer

Array = jax.Array
Params = Dict[str, Dict[str, Array]]


def clip_by_per_tensor_norm(max_norm: float) -> optax.GradientTransformation:
    """Keras ``clipnorm`` semantics: rescale each gradient leaf independently
    so its L2 norm is at most ``max_norm`` (tf.clip_by_norm per tensor)."""

    def init_fn(params):
        del params
        return optax.EmptyState()

    def update_fn(updates, state, params=None):
        del params

        def clip(g):
            n = jnp.sqrt(jnp.sum(jnp.square(g)))
            scale = jnp.where(n > max_norm, max_norm / jnp.maximum(n, 1e-30), 1.0)
            return g * scale

        return jax.tree_util.tree_map(clip, updates), state

    return optax.GradientTransformation(init_fn, update_fn)


def make_optimizer(tc: TrainConfig) -> optax.GradientTransformation:
    return optax.chain(
        clip_by_per_tensor_norm(tc.clipnorm),
        optax.adam(tc.lr, b1=0.9, b2=0.999, eps=tc.adam_eps),
    )


class TrainState(NamedTuple):
    params: Params
    opt_state: Any
    step: Array


def create_train_state(
    params: Params, tc: TrainConfig
) -> Tuple[TrainState, optax.GradientTransformation]:
    opt = make_optimizer(tc)
    return TrainState(params, opt.init(params), jnp.int32(0)), opt


class StepMetrics(NamedTuple):
    loss: Array  # total loss
    nll: Array  # likelihood term ("loss_final" in the reference)
    kl: Array  # regularization sum ("regularization_loss")
    accuracy: Array  # pixel accuracy


def loss_fn(
    params: Params,
    x: Array,
    y: Array,
    cfg: ModelConfig,
    tc: TrainConfig,
    constrain=None,
) -> Tuple[Array, Tuple[Array, Array, Array, Array]]:
    """Total loss + auxiliaries. ``y`` is one-hot flattened [B, N, C] or an
    integer label map [B, H, W] (one-hot encoded on device, inside jit — the
    host then ships 4-byte labels instead of C float rows per pixel).
    ``constrain`` is the per-block sharding hook forwarded to the model
    (parallel.spatial uses it to keep the H axis mesh-sharded)."""
    y = ensure_one_hot(y, cfg.n_classes)
    probs, sigma = forward(params, x, cfg, constrain=constrain)
    kl = kl_regularizer(params)
    loss = elbo_loss(
        y, probs, sigma, kl, tc.kl_factor,
        tc.sigma_clip_min, tc.sigma_clip_max,
    )
    # aux terms for logging (XLA CSE dedupes the shared subexpressions)
    nll = nll_gaussian(
        y, probs, jnp.clip(sigma, tc.sigma_clip_min, tc.sigma_clip_max)
    )
    return loss, (nll, kl, probs, sigma)


def make_adversarial_examples(
    params: Params,
    x: Array,
    y: Array,
    cfg: ModelConfig,
    tc: TrainConfig,
    axis_name: str | None = None,
) -> Array:
    """FGSM / PGD examples for adversarial TRAINING, generated inside the
    jitted train step against the current parameters (gradient-stopped, so
    the attack acts as a fixed data augmentation for the update). Projection
    follows the eval attack (`Hippocampus.py:930-932`): the L-inf
    epsilon-ball around x intersected with the batch's data range.

    ``axis_name``: when called per-shard inside ``shard_map``, the data-mesh
    axis to pmin/pmax the clip range over — otherwise each device would clip
    to its local shard's range, diverging from the single-device and
    GSPMD-jit paths (where ``x`` is the global batch and jnp.min/max already
    see the full range)."""
    from supernet_tpu.attacks import fgsm_sign

    from supernet_tpu.configs import AttackConfig

    ac = AttackConfig(
        epsilon=tc.adv_epsilon,
        step_size=tc.adv_step_size,
        max_adv_step=tc.adv_steps,
    )
    x_min, x_max = jnp.min(x), jnp.max(x)
    if axis_name is not None:
        x_min = jax.lax.pmin(x_min, axis_name)
        x_max = jax.lax.pmax(x_max, axis_name)
    if tc.adversarial_training == "fgsm":
        sign = fgsm_sign(params, x, y, cfg, ac)
        adv = jnp.clip(x + ac.epsilon * sign, x_min, x_max)
    elif tc.adversarial_training == "pgd":

        def body(_, adv_x):
            sign = fgsm_sign(params, adv_x, y, cfg, ac)
            adv_x = adv_x + ac.step_size * sign
            adv_x = jnp.clip(adv_x, x - ac.epsilon, x + ac.epsilon)
            return jnp.clip(adv_x, x_min, x_max)

        adv = jax.lax.fori_loop(0, ac.max_adv_step, body, x)
    else:
        raise ValueError(
            f"unknown adversarial_training mode {tc.adversarial_training!r}"
        )
    return jax.lax.stop_gradient(adv)


def value_and_grad_step(
    params: Params,
    x: Array,
    y: Array,
    cfg: ModelConfig,
    tc: TrainConfig,
    constrain=None,
    axis_name: str | None = None,
):
    """value_and_grad of the training objective. With
    ``tc.adversarial_training`` enabled the objective is the mixed loss
    ``adv_alpha * L(clean) + (1 - adv_alpha) * L(adv)`` (Goodfellow-style
    adversarial training; ``adv_alpha=0`` trains on adversarial examples
    only, the Madry protocol). ``y`` must already be one-hot flattened.
    Returned aux (nll/kl/probs/sigma) is the CLEAN branch's, so logged
    accuracy/curves stay comparable with standard training."""
    if tc.adversarial_training == "none":
        return jax.value_and_grad(loss_fn, has_aux=True)(
            params, x, y, cfg, tc, constrain
        )
    adv_x = make_adversarial_examples(params, x, y, cfg, tc, axis_name)

    def mixed(p):
        loss_c, aux = loss_fn(p, x, y, cfg, tc, constrain)
        loss_a, _ = loss_fn(p, adv_x, y, cfg, tc, constrain)
        return tc.adv_alpha * loss_c + (1.0 - tc.adv_alpha) * loss_a, aux

    return jax.value_and_grad(mixed, has_aux=True)(params)


def maybe_augment(
    step: Array,
    x: Array,
    y: Array,
    cfg: ModelConfig,
    tc: TrainConfig,
    axis_name: str | None = None,
    seed: Array | int | None = None,
) -> Tuple[Array, Array]:
    """On-device augmentation inside the jitted step (``tc.augment``);
    identity when disabled. Keyed by the step counter and the GLOBAL image
    index so every data-parallel path augments identically. ``seed``
    overrides ``tc.seed`` — the vmapped ensemble step passes each member's
    own (traced) seed so member k's draws match a sequential run seeded
    ``tc.seed + k``."""
    if tc.augment is None:
        return x, y
    from supernet_tpu.data.augment import augment_train_batch

    return augment_train_batch(
        step, x, y, cfg.out_size, tc.augment,
        tc.seed if seed is None else seed, axis_name,
    )


def _train_step(
    state: TrainState,
    x: Array,
    y: Array,
    opt: optax.GradientTransformation,
    cfg: ModelConfig,
    tc: TrainConfig,
    constrain=None,
    seed: Array | None = None,
) -> Tuple[TrainState, StepMetrics, Array]:
    x, y = maybe_augment(state.step, x, y, cfg, tc, seed=seed)
    y = ensure_one_hot(y, cfg.n_classes)
    (loss, (nll, kl, probs, _)), grads = value_and_grad_step(
        state.params, x, y, cfg, tc, constrain
    )
    updates, opt_state = opt.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    pred = jnp.argmax(probs, axis=-1).astype(jnp.int32)  # [B, H*W]
    acc = jnp.mean((pred == jnp.argmax(y, axis=-1)).astype(jnp.float32))
    return (
        TrainState(params, opt_state, state.step + 1),
        StepMetrics(loss, nll, kl, acc),
        pred,
    )


def make_train_step(cfg: ModelConfig, tc: TrainConfig, with_pred: bool = False):
    """Single-device jitted train step; donates the carried state.

    ``with_pred=True`` additionally returns the per-pixel argmax prediction
    [B, H*W] so the epoch driver can track the reference's per-structure
    train Dice/Hausdorff curves (`Hippocampus.py:640-668`) without a second
    forward pass."""
    opt = make_optimizer(tc)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state: TrainState, x: Array, y: Array):
        new_state, m, pred = _train_step(state, x, y, opt, cfg, tc)
        return (new_state, m, pred) if with_pred else (new_state, m)

    return step


def make_multi_train_step(
    cfg: ModelConfig, tc: TrainConfig, k_steps: int, with_pred: bool = False
):
    """K train steps per dispatch via ``lax.scan`` (epoch-on-device).

    Takes stacked batches ``x: [K, B, H, W, C]``, ``y: [K, B, H, W]`` and
    runs the whole chunk inside one XLA program — one dispatch per K
    steps instead of one per step. Returns per-step StepMetrics stacked
    along the leading axis (and, with ``with_pred``, predictions
    [K, B, H*W]).
    """
    opt = make_optimizer(tc)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def steps(state: TrainState, x: Array, y: Array):
        def body(s, xy):
            xb, yb = xy
            s, m, pred = _train_step(s, xb, yb, opt, cfg, tc)
            return s, ((m, pred) if with_pred else m)

        state, out = jax.lax.scan(body, state, (x, y), length=k_steps)
        return (state, *out) if with_pred else (state, out)

    return steps


def stack_trees(trees):
    """Stack K structurally identical pytrees along a new leading axis —
    the member axis of the vmapped ensemble paths (training here,
    `serving.EnsembleSession` for inference)."""
    return jax.tree_util.tree_map(
        lambda *xs: jnp.stack([jnp.asarray(a) for a in xs]), *trees
    )


def index_tree(tree, k: int):
    """Member ``k``'s slice of a stacked tree (host-side unstack for
    per-member checkpoints/eval)."""
    return jax.tree_util.tree_map(lambda a: a[k], tree)


def make_ensemble_train_step(
    cfg: ModelConfig,
    tc: TrainConfig,
    with_pred: bool = False,
    mesh=None,
    member_mode: str = "vmap",
):
    """One-compiled-program deep-ensemble training: the training twin of
    ``serving.EnsembleSession`` (which already vmaps the member axis at
    inference). Instead of K sequential full trainings — K compiles, K
    epoch loops (the round-3 ``--ensemble`` path) — the K member states are
    stacked along a leading axis and the whole update is ONE XLA program.

    Takes ``state`` with leaves ``[K, ...]``, ``x [K, B, H, W, C]``,
    ``y [K, B, h, w]`` int labels (each member sees ITS OWN shuffle order,
    fed by the driver), and ``seeds [K]`` int32 — member k's augmentation
    seed, matching a sequential run seeded ``tc.seed + k``.

    ``member_mode`` selects how the member axis is lowered single-device:

    - ``"vmap"``: members' convs batch together. vmap over the WEIGHTS
      turns each conv into a batch-grouped conv, which XLA may lower
      slower than K plain convs.
    - ``"scan"``: ``lax.scan`` over the member axis — the body is the
      single-model step verbatim (plain convs, full per-step rate), traced
      and compiled ONCE for all K members. Per-step cost matches the
      sequential path; the compile-amortization win is kept.
    - ``"unroll"``: Python loop over the K members inside ONE jit — the
      body is traced K times (compile grows ~K×) but there is no scan
      carry/loop overhead and XLA may interleave members' kernels to fill
      scheduling bubbles. bench.py's ensemble_train section times the
      three lowerings against each other.

    ``mesh``: optional member-axis sharding — each device trains a
    contiguous block of members (K must divide over the mesh; use
    ``parallel.make_mesh_for_batch(K)``). The step is a ``shard_map`` over
    the member axis: each device vmaps its own block, with no collectives
    on the update path. (Left to the SPMD partitioner, the vmapped convs —
    grouped convolutions over the member axis — came out wrong at full
    width when sharded on that axis.) The mesh path requires
    ``member_mode="vmap"`` (a scan would serialize the very axis the mesh
    parallelizes)."""
    opt = make_optimizer(tc)

    def one(state, x, y, seed):
        return _train_step(state, x, y, opt, cfg, tc, seed=seed)

    vstep = jax.vmap(one)

    if mesh is None:
        if member_mode == "scan":

            @functools.partial(jax.jit, donate_argnums=(0,))
            def step(state: TrainState, x: Array, y: Array, seeds: Array):
                def body(_, member):
                    s, xb, yb, sd = member
                    new_s, m, pred = one(s, xb, yb, sd)
                    return None, (new_s, m, pred)

                _, (new_state, m, pred) = jax.lax.scan(
                    body, None, (state, x, y, seeds)
                )
                return (new_state, m, pred) if with_pred else (new_state, m)

            return step
        if member_mode == "unroll":

            @functools.partial(jax.jit, donate_argnums=(0,))
            def step(state: TrainState, x: Array, y: Array, seeds: Array):
                outs = [
                    one(
                        jax.tree_util.tree_map(lambda a: a[k], state),
                        x[k], y[k], seeds[k],
                    )
                    for k in range(x.shape[0])
                ]
                stack = lambda *ls: jnp.stack(ls)  # noqa: E731
                new_state = jax.tree_util.tree_map(
                    stack, *[o[0] for o in outs])
                m = jax.tree_util.tree_map(stack, *[o[1] for o in outs])
                pred = jnp.stack([o[2] for o in outs])
                return (new_state, m, pred) if with_pred else (new_state, m)

            return step
        if member_mode != "vmap":
            raise ValueError(f"unknown member_mode {member_mode!r}")

        @functools.partial(jax.jit, donate_argnums=(0,))
        def step(state: TrainState, x: Array, y: Array, seeds: Array):
            new_state, m, pred = vstep(state, x, y, seeds)
            return (new_state, m, pred) if with_pred else (new_state, m)

        return step

    if member_mode != "vmap":
        raise ValueError(
            "mesh-sharded ensemble training requires member_mode='vmap'"
        )

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    members = P(mesh.axis_names[0])

    def local(state: TrainState, x: Array, y: Array, seeds: Array):
        new_state, m, pred = vstep(state, x, y, seeds)
        return (new_state, m, pred) if with_pred else (new_state, m)

    return jax.jit(
        shard_map(local, mesh=mesh, in_specs=(members,) * 4,
                  out_specs=members, check_vma=False),
        donate_argnums=(0,),
    )


def make_ensemble_eval_step(cfg: ModelConfig, tc: TrainConfig):
    """Per-member validation in one program: vmap the eval computation over
    the stacked member params; the batch is shared (validation data is not
    shuffled per member). Returns per-member (probs, sigma, pred, loss,
    acc) with a leading [K] axis."""

    @jax.jit
    def step(params: Params, x: Array, y: Array):
        y1 = ensure_one_hot(y, cfg.n_classes)

        def one(p):
            probs, sigma = forward(p, x, cfg)
            sigma_c = jnp.clip(sigma, tc.sigma_clip_min, tc.sigma_clip_max)
            nll = nll_gaussian(y1, probs, sigma_c)
            loss = nll + tc.kl_factor * 0.5 * kl_regularizer(p)
            pred = jnp.argmax(probs, axis=-1)
            acc = jnp.mean(
                (pred == jnp.argmax(y1, axis=-1)).astype(jnp.float32)
            )
            return probs, sigma, pred, loss, acc

        return jax.vmap(one)(params)

    return step


def make_accum_train_step(cfg: ModelConfig, tc: TrainConfig, n_micro: int):
    """Gradient accumulation: one optimizer update from ``n_micro``
    microbatches scanned on device (large effective batches without the
    activation memory). Takes ``x: [n_micro, B, ...]``, ``y: [n_micro, B,
    ...]``; the update uses the mean gradient (equivalent to one batch of
    ``n_micro * B``)."""
    opt = make_optimizer(tc)

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state: TrainState, x: Array, y: Array):
        def micro(carry, xy):
            xb, yb = xy
            yb = ensure_one_hot(yb, cfg.n_classes)
            (loss, (nll, kl, probs, _)), grads = value_and_grad_step(
                state.params, xb, yb, cfg, tc
            )
            acc = jnp.mean(
                (jnp.argmax(probs, -1) == jnp.argmax(yb, -1)).astype(
                    jnp.float32
                )
            )
            g_sum, m_sum = carry
            g_sum = jax.tree_util.tree_map(jnp.add, g_sum, grads)
            return (g_sum, m_sum + jnp.stack([loss, nll, kl, acc])), None

        zeros = jax.tree_util.tree_map(jnp.zeros_like, state.params)
        (g_sum, m_sum), _ = jax.lax.scan(
            micro, (zeros, jnp.zeros(4)), (x, y), length=n_micro
        )
        grads = jax.tree_util.tree_map(lambda g: g / n_micro, g_sum)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        m = m_sum / n_micro
        return (
            TrainState(params, opt_state, state.step + 1),
            StepMetrics(m[0], m[1], m[2], m[3]),
        )

    return step


def make_eval_step(cfg: ModelConfig, tc: TrainConfig):
    """Jitted eval: forward + validation loss + accuracy + predictions."""

    @jax.jit
    def step(params: Params, x: Array, y: Array):
        y = ensure_one_hot(y, cfg.n_classes)
        probs, sigma = forward(params, x, cfg)
        sigma_c = jnp.clip(sigma, tc.sigma_clip_min, tc.sigma_clip_max)
        nll = nll_gaussian(y, probs, sigma_c)
        kl = kl_regularizer(params)
        loss = nll + tc.kl_factor * 0.5 * kl
        pred = jnp.argmax(probs, axis=-1)
        acc = jnp.mean((pred == jnp.argmax(y, axis=-1)).astype(jnp.float32))
        return probs, sigma, pred, loss, acc

    return step


def one_hot_flatten(y: Array, n_classes: int) -> Array:
    """Labels [B, H, W] -> one-hot flattened [B, H*W, C]
    (`Hippocampus.py:612-615`)."""
    y1 = jax.nn.one_hot(y.astype(jnp.int32), n_classes, dtype=jnp.float32)
    return y1.reshape(y.shape[0], -1, n_classes)


def ensure_one_hot(y: Array, n_classes: int) -> Array:
    """Accept integer label maps [B, H, W] or one-hot flattened [B, N, C];
    return the one-hot form. Lets train/eval steps take 4-byte integer
    labels across the host->device boundary and encode on device."""
    if y.ndim == 3 and not jnp.issubdtype(y.dtype, jnp.floating):
        return one_hot_flatten(y, n_classes)
    return y
