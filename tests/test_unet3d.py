"""3-D model family (`ops/moments3d.py` + `models/unet3d.py`, net-new —
the reference slices its 3-D volumes to 2-D): MC ground truth for the 3-D
variational conv, pool/unpool semantics vs NumPy loops, the geometry chain
(the 2-D arithmetic per axis), and an end-to-end training smoke reusing the
2-D loss head."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supernet_tpu.configs import HIPPOCAMPUS
from supernet_tpu.models import forward3d, init_params3d, kl_regularizer3d
from supernet_tpu.ops import moments3d as m3

RNG = np.random.default_rng(0)


def _rand(*s, positive=False):
    a = RNG.normal(0, 1, s).astype(np.float32)
    return np.abs(a) if positive else a


def test_vconv3d_monte_carlo():
    """MC ground truth: w ~ N(w_mu, softplus(w_sigma)), x ~ N(mu, sigma);
    empirical moments of conv3d(x, w) must match vconv3d."""
    key = jax.random.PRNGKey(42)
    cin, cout, k, d = 2, 3, 2, 5
    mu = jnp.asarray(_rand(1, d, d, d, cin))
    sigma = jnp.asarray(_rand(1, d, d, d, cin, positive=True) + 0.05)
    w_mu = jnp.asarray(_rand(k, k, k, cin, cout) * 0.3)
    w_sigma = jnp.asarray(RNG.uniform(-4, -2, cout).astype(np.float32))
    s_w = jax.nn.softplus(w_sigma)

    n = 150_000
    kx, kw = jax.random.split(key)
    xs = mu + jnp.sqrt(sigma) * jax.random.normal(kx, (n, d, d, d, cin))
    ws = w_mu + jnp.sqrt(s_w) * jax.random.normal(kw, (n, k, k, k, cin, cout))

    def one(x, w):
        return jax.lax.conv_general_dilated(
            x[None], w, (1, 1, 1), "VALID",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        )[0]

    ys = jax.vmap(one)(xs, ws)
    mu_out, sg_out = m3.vconv3d(mu, sigma, w_mu, w_sigma)
    np.testing.assert_allclose(jnp.mean(ys, 0), mu_out[0], atol=0.02)
    np.testing.assert_allclose(jnp.var(ys, 0), sg_out[0], rtol=0.06, atol=0.02)


def test_vconv3d_input_closed_form():
    """sigma_out = (sum_patch x^2) * softplus(w_sigma) — NumPy loop."""
    x = _rand(1, 4, 4, 4, 2)
    k, cout = 2, 3
    w_mu = _rand(k, k, k, 2, cout) * 0.2
    w_sigma = RNG.uniform(-6, -2, cout).astype(np.float32)
    s_w = np.log1p(np.exp(w_sigma))
    mu, sg = m3.vconv3d_input(
        jnp.asarray(x), jnp.asarray(w_mu), jnp.asarray(w_sigma)
    )
    for i in range(3):
        for j in range(3):
            for l in range(3):
                patch = x[0, i : i + k, j : j + k, l : l + k, :]
                for c in range(cout):
                    m = np.sum(patch * w_mu[..., c])
                    v = np.sum(patch**2) * s_w[c]
                    assert abs(mu[0, i, j, l, c] - m) < 1e-4
                    assert abs(sg[0, i, j, l, c] - v) < 1e-5 + 5e-4 * abs(v)


def test_vconv3d_k1_einsum_matches_conv_form():
    """The 1x1x1 einsum fast path (no C_out-starved conv, GSPMD-partitionable under
    the ensemble member vmap) == the generic conv-form lowering."""
    cin, cout, d = 3, 4, 5
    x = _rand(2, d, d, d, cin)
    sigma = _rand(2, d, d, d, cin, positive=True)
    w_mu = _rand(1, 1, 1, cin, cout) * 0.3
    w_sigma = RNG.uniform(-5, -2, cout).astype(np.float32)
    s_w = np.log1p(np.exp(w_sigma))

    def conv(v, w):
        return np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(v), jnp.asarray(w), (1, 1, 1), "VALID",
            dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
            precision=jax.lax.Precision.HIGHEST,
        ))

    mu_i, sg_i = m3.vconv3d_input(
        jnp.asarray(x), jnp.asarray(w_mu), jnp.asarray(w_sigma)
    )
    np.testing.assert_allclose(mu_i, conv(x, w_mu), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        sg_i, np.sum(x**2, -1, keepdims=True) * s_w, rtol=1e-5, atol=1e-6
    )

    mu_o, sg_o = m3.vconv3d(
        jnp.asarray(x), jnp.asarray(sigma),
        jnp.asarray(w_mu), jnp.asarray(w_sigma),
    )
    ref_sg = (
        np.sum(x**2 + sigma, -1, keepdims=True) * s_w
        + conv(sigma, np.square(w_mu))
    )
    np.testing.assert_allclose(mu_o, conv(x, w_mu), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sg_o, ref_sg, rtol=1e-5, atol=1e-5)


def test_vmaxpool3d_semantics():
    """Max of the mean over 2^3 windows; sigma gathered at the SAME argmax
    with TF's first-flat-index tie-break; odd dims padded (SAME)."""
    mu = _rand(2, 5, 4, 6, 3)  # odd D exercises the pad path
    sigma = _rand(2, 5, 4, 6, 3, positive=True)
    mx, sg = m3.vmaxpool3d(jnp.asarray(mu), jnp.asarray(sigma))
    assert mx.shape == (2, 3, 2, 3, 3)
    neg = -np.inf
    mu_p = np.pad(mu, ((0, 0), (0, 1), (0, 0), (0, 0), (0, 0)),
                  constant_values=neg)
    sg_p = np.pad(sigma, ((0, 0), (0, 1), (0, 0), (0, 0), (0, 0)))
    for b in range(2):
        for i in range(3):
            for j in range(2):
                for l in range(3):
                    for c in range(3):
                        wm = mu_p[b, 2*i:2*i+2, 2*j:2*j+2, 2*l:2*l+2, c]
                        ws = sg_p[b, 2*i:2*i+2, 2*j:2*j+2, 2*l:2*l+2, c]
                        am = np.argmax(wm)  # first flat index on ties
                        assert mx[b, i, j, l, c] == pytest.approx(wm.max())
                        assert sg[b, i, j, l, c] == pytest.approx(
                            ws.flat[am]
                        )


def test_vmaxpool3d_tie_break_first():
    """Explicit tie: equal maxima -> the FIRST window position's sigma."""
    mu = np.zeros((1, 2, 2, 2, 1), np.float32)  # all equal: one window
    sigma = np.arange(8, dtype=np.float32).reshape(1, 2, 2, 2, 1)
    _, sg = m3.vmaxpool3d(jnp.asarray(mu), jnp.asarray(sigma))
    assert float(sg[0, 0, 0, 0, 0]) == 0.0  # tap (0,0,0)


def test_vmaxpool3d_custom_bwd_matches_where_tree():
    """The 3-D parity-form custom VJP (moments3d._vmaxpool3d_bwd) must
    equal the gradients of a plain strided-tap where-tree formulation on
    random inputs with plenty of exact ties, incl. the odd-dim pad."""

    def pool_naive(mu, sigma):
        b, d, h, w, c = mu.shape
        dp, hp, wp = -(-d // 2) * 2, -(-h // 2) * 2, -(-w // 2) * 2
        if (dp, hp, wp) != (d, h, w):
            pad = ((0, 0), (0, dp - d), (0, hp - h), (0, wp - w), (0, 0))
            mu = jnp.pad(mu, pad, constant_values=-jnp.inf)
            sigma = jnp.pad(sigma, pad)
        m_taps = [
            mu[:, di::2, hi::2, wi::2, :]
            for di in (0, 1) for hi in (0, 1) for wi in (0, 1)
        ]
        s_taps = [
            sigma[:, di::2, hi::2, wi::2, :]
            for di in (0, 1) for hi in (0, 1) for wi in (0, 1)
        ]
        mx = m_taps[0]
        for t in m_taps[1:]:
            mx = jnp.maximum(mx, t)
        mx = jax.lax.stop_gradient(mx)

        def sel(taps):
            out = taps[7]
            for k in range(6, -1, -1):
                out = jnp.where(m_taps[k] == mx, taps[k], out)
            return out

        return sel(m_taps), sel(s_taps)

    rng = np.random.default_rng(17)
    for shape in [(2, 4, 4, 6, 3), (1, 5, 4, 6, 2)]:
        mu = jnp.asarray(
            np.round(rng.normal(0, 1, shape) * 2) / 2
        ).astype(jnp.float32)
        sg = jnp.abs(jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)))
        np.testing.assert_array_equal(
            np.asarray(m3.vmaxpool3d(mu, sg)[0]),
            np.asarray(pool_naive(mu, sg)[0]),
        )
        np.testing.assert_array_equal(
            np.asarray(m3.vmaxpool3d(mu, sg)[1]),
            np.asarray(pool_naive(mu, sg)[1]),
        )

        def loss(fn):
            return lambda m, s: (
                jnp.sum(jnp.sin(fn(m, s)[0]))
                + jnp.sum(jnp.cos(fn(m, s)[1]))
            )

        g_fast = jax.grad(loss(m3.vmaxpool3d), (0, 1))(mu, sg)
        g_ref = jax.grad(loss(pool_naive), (0, 1))(mu, sg)
        for x, y in zip(g_fast, g_ref):
            np.testing.assert_allclose(
                np.asarray(x), np.asarray(y), atol=1e-6
            )


def test_vunpool3d_geometry_and_values():
    x = _rand(1, 3, 3, 3, 2)
    up, _ = m3.vunpool3d(jnp.asarray(x), jnp.asarray(x))
    assert up.shape == (1, 7, 7, 7, 2)
    u = np.array(up)  # writable copy
    # values land at odd indices; everything else is zero
    np.testing.assert_array_equal(u[0, 1::2, 1::2, 1::2, :], x[0])
    u[0, 1::2, 1::2, 1::2, :] = 0
    assert not u.any()


def test_vunpool3d_conv2_equals_composition():
    """The fused lhs-dilated form == materialized interleave then vconv3d
    (the 3-D port of the 2-D composition-equality check,
    test_moments.py) — on a non-cubic volume, both moments."""
    mu = jnp.asarray(_rand(2, 3, 4, 5, 6))
    sigma = jnp.asarray(_rand(2, 3, 4, 5, 6, positive=True))
    w_mu = jnp.asarray(_rand(2, 2, 2, 6, 4) * 0.3)
    w_sigma = jnp.asarray(RNG.uniform(-5, -2, 4).astype(np.float32))
    got_m, got_s = m3.vunpool3d_conv2(mu, sigma, w_mu, w_sigma)
    ref_m, ref_s = m3.vconv3d(*m3.vunpool3d(mu, sigma), w_mu, w_sigma)
    assert got_m.shape == ref_m.shape == (2, 6, 8, 10, 4)
    np.testing.assert_allclose(
        np.asarray(got_m), np.asarray(ref_m), rtol=1e-6, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(got_s), np.asarray(ref_s), rtol=1e-5, atol=1e-6
    )


def test_vsoftmax3d_probabilities_and_b1():
    mu = jnp.asarray(_rand(1, 2, 2, 2, 4))  # B == 1: no squeeze hazard
    sg = jnp.asarray(_rand(1, 2, 2, 2, 4, positive=True))
    p, s = m3.vsoftmax3d(mu, sg)
    assert p.shape == (1, 8, 4) and s.shape == (1, 8, 4)
    np.testing.assert_allclose(np.sum(np.asarray(p), -1), 1.0, rtol=1e-5)
    assert (np.asarray(s) >= -1e-7).all()


CFG3 = dataclasses.replace(
    HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=2, depth=3
)


def test_forward3d_geometry_chain():
    """The per-axis arithmetic of the 2-D chain holds in 3-D: 32 -> 22 at
    depth 3 (and full-size 64 -> 54 via eval_shape)."""
    params = init_params3d(jax.random.PRNGKey(0), CFG3)
    x = jnp.asarray(_rand(1, 32, 32, 32, 1))
    p, s = forward3d(params, x, CFG3)
    assert p.shape == s.shape == (1, 22**3, 3)
    np.testing.assert_allclose(np.sum(np.asarray(p), -1), 1.0, rtol=1e-5)
    assert (np.asarray(s) > -1e-7).all()

    cfg64 = dataclasses.replace(HIPPOCAMPUS.model, base_kernels=2)
    pp = jax.eval_shape(
        lambda pr, xx: forward3d(pr, xx, cfg64),
        jax.eval_shape(lambda k: init_params3d(k, cfg64),
                       jax.random.PRNGKey(0)),
        jax.ShapeDtypeStruct((1, 64, 64, 64, 1), jnp.float32),
    )
    assert pp[0].shape == (1, 54**3, 3)


def test_unet3d_training_smoke():
    """Jitted 3-D train step reusing the 2-D ELBO head: loss finite and
    decreasing over a few Adam steps on a learnable synthetic volume."""
    import optax

    from supernet_tpu.losses import elbo_loss
    from supernet_tpu.train import one_hot_flatten

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=16, out_size=10, base_kernels=2,
        depth=2,
    )
    rng = np.random.default_rng(1)
    # blob task: class = sphere in the center (16 -> 10 at depth 2)
    x = rng.normal(0, 0.3, (4, 16, 16, 16, 1)).astype(np.float32)
    zz = np.linalg.norm(np.indices((10, 10, 10)) - 4.5, axis=0)
    y_img = (zz < 3.5).astype(np.int32)[None].repeat(4, 0)
    x[:, 3:13, 3:13, 3:13, 0] += 2.0 * y_img
    x, y = jnp.asarray(x), one_hot_flatten(jnp.asarray(y_img), cfg.n_classes)

    params = init_params3d(jax.random.PRNGKey(0), cfg)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            probs, sigma = forward3d(p, x, cfg)
            return elbo_loss(
                y, probs, sigma, kl_regularizer3d(p), 1e-3, 1e-12, 1e3
            )

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(8):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_cli_train3d_synthetic(tmp_path, capsys):
    """`cli train3d --synthetic`: Trainer3D end-to-end — derived out_size,
    epoch checkpoints in the epoch_{N} scheme, history JSON, curves."""
    import json
    import os

    from supernet_tpu import cli

    out = str(tmp_path / "run3d")
    rc = cli.main(
        [
            "train3d", "--config", "hippocampus",
            "--synthetic", "6", "--batch-size", "2", "--epochs", "2",
            "--cube-size", "16", "--depth", "2", "--base-kernels", "2",
            "--out-dir", out,
        ]
    )
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(line["train_loss"]) and np.isfinite(line["val_dice"])
    assert os.path.isdir(os.path.join(out, "epoch_1"))
    assert os.path.exists(os.path.join(out, "history.pkl"))


def test_cli_train3d_from_nifti_dir(tmp_path, capsys):
    """MSD-layout NIfTI task dir -> cubes -> volumetric training: the raw
    3-D ingestion-to-training path."""
    import json
    import os

    from supernet_tpu import cli
    from supernet_tpu.data import write_nifti

    rng = np.random.default_rng(5)
    task = tmp_path / "Task99"
    (task / "imagesTr").mkdir(parents=True)
    (task / "labelsTr").mkdir()
    for i in range(4):
        img = rng.uniform(0, 800, (20, 18, 14)).astype(np.float32)
        lbl = np.zeros((20, 18, 14), np.int16)
        lbl[6:12, 5:11, 4:9] = 1 + (i % 2)
        write_nifti(str(task / "imagesTr" / f"v{i}.nii.gz"), img)
        write_nifti(str(task / "labelsTr" / f"v{i}.nii.gz"), lbl)
    out = str(tmp_path / "run3d_nifti")
    rc = cli.main(
        [
            "train3d", "--config", "hippocampus",
            "--data", str(task), "--batch-size", "2", "--epochs", "1",
            "--cube-size", "16", "--depth", "2", "--base-kernels", "2",
            "--val-frac", "0.5", "--out-dir", out,
        ]
    )
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(line["train_loss"])
    assert os.path.isdir(os.path.join(out, "epoch_0"))


def test_trainer3d_writes_uncertainty_slices(tmp_path):
    """Trainer3D's final validation report: center-slice PNGs + pkl (the
    3-D analog of the 2-D uncertainty artifact set)."""
    import os

    from supernet_tpu.data import synthetic_volumes
    from supernet_tpu.train3d import Trainer3D

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=16, out_size=10, base_kernels=2,
        depth=2,
    )
    exp = dataclasses.replace(
        HIPPOCAMPUS, model=cfg,
        train=dataclasses.replace(HIPPOCAMPUS.train, batch_size=2, epochs=1),
    )
    x, y = synthetic_volumes(cfg, 6, seed=0)
    out = str(tmp_path / "r")
    tr = Trainer3D(exp, x[:4], y[:4], x[4:], y[4:], out_dir=out)
    tr.run()
    assert os.path.exists(os.path.join(out, "uncertainty_info.pkl"))
    for n in ("0_Input_slice.png", "0_Label_slice.png",
              "0_Predicted_slice.png", "0_uncertainty_heatmap.png"):
        assert os.path.exists(os.path.join(out, "test_images", n)), n


def test_trainer3d_continue_training(tmp_path):
    """Trainer3D resumes from the latest epoch_{N} checkpoint: a second
    driver with continue_training=True starts at epoch 1 and extends the
    run instead of retraining from scratch."""
    import os

    from supernet_tpu.configs import HIPPOCAMPUS
    from supernet_tpu.data import synthetic_volumes
    from supernet_tpu.train3d import Trainer3D

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=16, out_size=10, base_kernels=2,
        depth=2,
    )
    tc = dataclasses.replace(HIPPOCAMPUS.train, batch_size=2, epochs=1)
    exp = HIPPOCAMPUS.replace(model=cfg, train=tc)
    x, y = synthetic_volumes(cfg, 4, seed=0)
    out = str(tmp_path / "run")

    Trainer3D(exp, x, y, out_dir=out).run(log=lambda *_: None)
    assert os.path.isdir(os.path.join(out, "epoch_0"))
    assert not os.path.isdir(os.path.join(out, "epoch_1"))

    exp2 = exp.replace(train=dataclasses.replace(tc, continue_training=True))
    tr2 = Trainer3D(exp2, x, y, out_dir=out)
    tr2.run(epochs=2, log=lambda *_: None)
    # resumed at epoch 1: exactly one new epoch trained + checkpointed
    assert os.path.isdir(os.path.join(out, "epoch_1"))
    assert len(tr2.history["train_loss"]) == 1


def test_forward_flops3d_model():
    """The volumetric FLOPs model (bench MFU denominator): linear in
    batch, correct first-layer geometry (16^3 -> 14^3 at k=3), and the
    total bounded below by the hand count of the first layer
    (2*k^3*cin*cout + 2*k^3 per output voxel)."""
    from supernet_tpu import flops as F
    from supernet_tpu.models import layer_names3d

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=16, out_size=10, base_kernels=2,
        depth=2,
    )
    f1 = F.forward_flops3d(cfg, 1)
    assert f1 > 0
    assert F.forward_flops3d(cfg, 4) == pytest.approx(4 * f1)

    shapes = dict(F._conv_shapes3d(cfg))
    assert shapes["conv_input"] == 14  # 16 - 3 + 1
    _, k, cin, cout = layer_names3d(cfg)[0]
    hand_first = 14**3 * (2 * k**3 * cin * cout + 2 * k**3)
    assert f1 >= hand_first


def test_act_bytes3d_model():
    """Volumetric HBM bytes model: linear in batch and act width; the
    fused unpool layer reads the pre-unpool cube (D_out/2)."""
    from supernet_tpu import flops as F

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=16, out_size=10, base_kernels=2,
        depth=2,
    )
    b1 = F.forward_act_bytes3d(cfg, 1, 2)
    assert b1 > 0
    assert F.forward_act_bytes3d(cfg, 3, 2) == pytest.approx(3 * b1)
    assert F.forward_act_bytes3d(cfg, 1, 4) == pytest.approx(2 * b1)
    assert F.train_step_min_bytes3d(cfg, 1, 2) > 3 * b1  # + param traffic


def test_derive_out_size3d_rejects_collapsed_geometry_legibly():
    """A cube side too small for the depth must raise a ValueError that
    names the smallest valid side — not an opaque concatenate error from
    deep inside tracing (cli train3d --cube-size 24 used to do that)."""
    from supernet_tpu.train3d import derive_out_size3d

    cfg = dataclasses.replace(HIPPOCAMPUS.model, image_size=24)  # depth 3
    with pytest.raises(ValueError, match="smallest valid side is 29"):
        derive_out_size3d(cfg)
    assert derive_out_size3d(
        dataclasses.replace(HIPPOCAMPUS.model, image_size=30)
    ) == 22


def test_trainer3d_rolls_back_on_nonfinite_loss(tmp_path):
    """Failure recovery for the volumetric trainer (parity with the 2-D
    Trainer): a diverged epoch restores the last good checkpoint and
    training continues — the run ends with more epochs checkpointed than
    the poisoned one."""
    from supernet_tpu import checkpoint as ckpt
    from supernet_tpu.train3d import Trainer3D

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=16, out_size=10, base_kernels=2,
        depth=2,
    )
    tc = dataclasses.replace(HIPPOCAMPUS.train, epochs=3, batch_size=2)
    exp = dataclasses.replace(
        HIPPOCAMPUS, model=cfg, train=tc, out_dir=str(tmp_path)
    )
    rng = np.random.default_rng(9)
    x = rng.normal(0, 1, (4, 16, 16, 16, 1)).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, (4, 16, 16, 16)).astype(np.int32)
    tr = Trainer3D(exp, x, y, out_dir=str(tmp_path / "run"))
    orig = tr.step_fn
    calls = {"n": 0}

    def flaky(state, xb, yb):
        state, m = orig(state, xb, yb)
        calls["n"] += 1
        if 3 <= calls["n"] <= 4:  # poison both steps of epoch 1
            m = m._replace(loss=jnp.float32(float("nan")))
        return state, m

    tr.step_fn = flaky
    logs = []
    tr.run(log=logs.append)
    assert any("rolling back to epoch 0" in str(m) for m in logs), logs
    assert ckpt.latest_epoch(str(tmp_path / "run")) == 2


def test_vconv3d_im2col_matches_conv_form():
    """SUPERNET_CONV3D=im2col (packed k^3*C_in contraction dot; the
    pure-XLA occupancy lever from VERDICT r4 #2) == the conv lowering,
    forward AND gradients, for k=3 and k=2/stride geometry."""
    cin, cout, d = 3, 4, 8
    x = _rand(2, d, d, d, cin)
    sigma = _rand(2, d, d, d, cin, positive=True)
    w_sigma = RNG.uniform(-5, -2, cout).astype(np.float32)

    for k in (2, 3):
        w_mu = _rand(k, k, k, cin, cout) * 0.3
        args = (jnp.asarray(x), jnp.asarray(sigma),
                jnp.asarray(w_mu), jnp.asarray(w_sigma))

        def loss(mu, sg, wm, ws):
            m, s = m3.vconv3d(mu, sg, wm, ws)
            return jnp.sum(m * 0.3) + jnp.sum(s * 0.7)

        try:
            m3.set_conv3d_impl("im2col")
            mu_i, sg_i = m3.vconv3d(*args)
            g_i = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
            mu_in_i, sg_in_i = m3.vconv3d_input(
                jnp.asarray(x), jnp.asarray(w_mu), jnp.asarray(w_sigma)
            )
        finally:
            m3.set_conv3d_impl("conv")
        mu_c, sg_c = m3.vconv3d(*args)
        g_c = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
        mu_in_c, sg_in_c = m3.vconv3d_input(
            jnp.asarray(x), jnp.asarray(w_mu), jnp.asarray(w_sigma)
        )
        np.testing.assert_allclose(mu_i, mu_c, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sg_i, sg_c, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(mu_in_i, mu_in_c, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(sg_in_i, sg_in_c, rtol=1e-5, atol=1e-5)
        for a, b in zip(g_i, g_c):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_set_conv3d_impl_rejects_unknown():
    with pytest.raises(ValueError, match="conv3d impl"):
        m3.set_conv3d_impl("magic")
