"""Serving subsystem (supernet_tpu/serving.py): StableHLO export,
AOT compile, padded-batch inference session (single-device and mesh),
and the CLI export bundle."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supernet_tpu.configs import HIPPOCAMPUS
from supernet_tpu.models import forward_images, init_params
from supernet_tpu import serving

CFG = dataclasses.replace(
    HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=4
)


@pytest.fixture(scope="module")
def params():
    return init_params(jax.random.PRNGKey(3), CFG)


def _x(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (n, 32, 32, 1)).astype(np.float32)


def test_export_stablehlo_text(params, tmp_path):
    path = str(tmp_path / "m.mlir")
    text = serving.export_stablehlo(params, CFG, batch_size=2, path=path)
    assert "module" in text and "stablehlo" in text
    assert os.path.exists(path) and os.path.getsize(path) > 1000
    # static input shape is baked in
    assert "2x32x32x1" in text


def test_aot_compile_runs(params):
    compiled, cost = serving.aot_compile(params, CFG, batch_size=2)
    probs, sigma = compiled(params, jax.numpy.asarray(_x(2)))
    assert probs.shape == (2, 22, 22, 3)
    assert sigma.shape == (2, 22, 22, 3)
    # XLA cost analysis reports the conv FLOPs
    assert cost.get("flops", 0) > 0


def test_session_matches_forward_exact_batch(params):
    sess = serving.InferenceSession(params, CFG, batch_size=4).warmup()
    x = _x(4)
    p, s = sess.predict(x)
    pr, sr = forward_images(params, jax.numpy.asarray(x), CFG)
    np.testing.assert_allclose(p, np.asarray(pr), atol=1e-6)
    np.testing.assert_allclose(s, np.asarray(sr), atol=1e-6)


def test_session_pads_and_chunks(params):
    # N=7 with batch 4: one full chunk + one padded chunk; padding rows
    # must never leak into the outputs
    sess = serving.InferenceSession(params, CFG, batch_size=4)
    x = _x(7, seed=1)
    p, s = sess.predict(x)
    assert p.shape == (7, 22, 22, 3)
    # compare per chunk against the batch-4 static shape's own reference
    pr4, _ = forward_images(params, jax.numpy.asarray(x[:4]), CFG)
    np.testing.assert_allclose(p[:4], np.asarray(pr4), atol=1e-6)
    pr_t, _ = forward_images(
        params, jax.numpy.asarray(np.concatenate([x[4:7], x[6:7]])), CFG
    )
    np.testing.assert_allclose(p[4:7], np.asarray(pr_t)[:3], atol=1e-6)


def test_session_mesh_matches_single_device(params):
    from supernet_tpu.parallel import make_mesh

    mesh = make_mesh(8)
    x = _x(8, seed=2)
    p1, s1 = serving.InferenceSession(params, CFG, batch_size=8).predict(x)
    p2, s2 = serving.InferenceSession(
        params, CFG, batch_size=8, mesh=mesh
    ).predict(x)
    np.testing.assert_allclose(p1, p2, atol=1e-6)
    np.testing.assert_allclose(s1, s2, atol=1e-6)


def test_export_bundle_and_cli(params, tmp_path):
    out = str(tmp_path / "bundle")
    meta = serving.export_bundle(
        params, CFG, out, batch_size=2, config_name="hippocampus"
    )
    for f in ("model.stablehlo.mlir", "params.npz", "export_meta.json"):
        assert os.path.exists(os.path.join(out, f))
    assert meta["outputs"] == ["probs", "sigma"]
    assert meta["param_count"] > 0
    with open(os.path.join(out, "export_meta.json")) as f:
        assert json.load(f)["batch_size"] == 2
    # npz roundtrip reproduces the exact parameters
    from supernet_tpu.checkpoint import load_params_npz

    loaded = load_params_npz(os.path.join(out, "params.npz"))
    for layer, ws in params.items():
        for k, v in ws.items():
            np.testing.assert_array_equal(
                np.asarray(v), np.asarray(loaded[layer][k])
            )


def test_export_bundle_ensemble(params, tmp_path):
    """A list of member trees exports the deep-ensemble mixture: stacked
    params.npz (leading K axis), ensemble_members in the metadata, and a
    StableHLO module whose parameter arguments carry the member axis."""
    p2 = init_params(jax.random.PRNGKey(61), CFG)
    out = str(tmp_path / "ens_bundle")
    meta = serving.export_bundle(
        [params, p2], CFG, out, batch_size=2, config_name="hippocampus"
    )
    assert meta["ensemble_members"] == 2
    # param_count is per member (the runtime contract: one member's layout)
    single = serving.export_bundle(
        params, CFG, str(tmp_path / "single"), batch_size=2
    )
    assert meta["param_count"] == single["param_count"]
    from supernet_tpu.checkpoint import load_params_npz

    loaded = load_params_npz(os.path.join(out, "params.npz"))
    assert loaded["conv_input"]["w_mu"].shape[0] == 2
    np.testing.assert_array_equal(
        np.asarray(loaded["conv_input"]["w_mu"][1]),
        np.asarray(p2["conv_input"]["w_mu"]),
    )
    hlo = open(os.path.join(out, "model.stablehlo.mlir")).read()
    k, cin = 3, CFG.in_channels
    assert f"tensor<2x{k}x{k}x{cin}x" in hlo  # stacked conv_input w_mu arg


def test_volumetric_inference_session(tmp_path):
    """InferenceSession(volumetric=True) serves the 3-D family with the
    same compile-once padded-batch scheme, matching forward3d."""
    import dataclasses

    from supernet_tpu.models import forward3d, init_params3d
    from supernet_tpu.serving import InferenceSession, export_stablehlo

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=16, out_size=10, base_kernels=2,
        depth=2,
    )
    params = init_params3d(jax.random.PRNGKey(0), cfg)
    sess = InferenceSession(params, cfg, batch_size=2, volumetric=True)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (3, 16, 16, 16, 1)).astype(np.float32)  # partial
    probs, sigma = sess.predict(x)
    assert probs.shape == sigma.shape == (3, 10, 10, 10, cfg.n_classes)
    ref_p, ref_s = forward3d(params, jnp.asarray(x), cfg)
    np.testing.assert_allclose(
        probs.reshape(3, -1, cfg.n_classes), np.asarray(ref_p),
        rtol=1e-5, atol=1e-6,
    )
    # empty request and StableHLO export surfaces work too
    p0, _ = sess.predict(np.zeros((0, 16, 16, 16, 1), np.float32))
    assert p0.shape == (0, 10, 10, 10, cfg.n_classes)
    text = export_stablehlo(params, cfg, batch_size=2, volumetric=True)
    assert "stablehlo" in text or "module" in text


def test_volumetric_scan_sharded_session_matches_single_device():
    """InferenceSession(shard='scan'): each volume's D axis sharded over
    the 8-device mesh (the whole-volume serving regime) — predictions
    equal the unsharded session, batch size free of the mesh divisibility
    constraint, and the compiled program really partitions (halo
    collective-permutes present)."""
    import dataclasses

    from supernet_tpu.models import init_params3d
    from supernet_tpu.parallel import make_mesh
    from supernet_tpu.serving import InferenceSession, _make_fn, _input_spec

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=16, out_size=10, base_kernels=2,
        depth=2,
    )
    params = init_params3d(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (3, 16, 16, 16, 1)).astype(np.float32)

    ref_p, ref_s = InferenceSession(
        params, cfg, batch_size=2, volumetric=True
    ).predict(x)
    mesh = make_mesh(8)
    # batch 3 would be rejected by batch-DP sharding on 8 devices; scan
    # mode has no such constraint
    sess = InferenceSession(
        params, cfg, batch_size=3, mesh=mesh, volumetric=True, shard="scan"
    )
    got_p, got_s = sess.predict(x)
    np.testing.assert_allclose(got_p, ref_p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_s, ref_s, rtol=1e-4, atol=1e-6)

    fn = _make_fn(cfg, mesh, volumetric=True, shard="scan")
    hlo = fn.lower(
        jax.device_get(params), _input_spec(cfg, 1, volumetric=True)
    ).compile().as_text()
    assert "collective-permute" in hlo or "all-to-all" in hlo


def test_scan_shard_requires_volumetric():
    from supernet_tpu.parallel import make_mesh
    from supernet_tpu.serving import _make_fn

    with pytest.raises(ValueError, match="volumetric"):
        _make_fn(CFG, make_mesh(8), volumetric=False, shard="scan")


def test_volumetric_export_bundle(tmp_path):
    """export_bundle(volumetric=True): cube-shaped meta, 3-D FLOPs count,
    loadable params (the cli export --volumetric path)."""
    import dataclasses
    import json as _json

    from supernet_tpu.checkpoint import load_params_npz
    from supernet_tpu.models import init_params3d
    from supernet_tpu.serving import export_bundle

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=16, out_size=10, base_kernels=2,
        depth=2,
    )
    params = init_params3d(jax.random.PRNGKey(0), cfg)
    meta = export_bundle(
        params, cfg, str(tmp_path), batch_size=2, config_name="hippocampus",
        volumetric=True,
    )
    assert meta["volumetric"] is True
    assert meta["input_shape"] == [2, 16, 16, 16, 1]
    assert meta["output_shape"] == [2, 10, 10, 10, cfg.n_classes]
    on_disk = _json.loads((tmp_path / "export_meta.json").read_text())
    assert on_disk["output_shape"] == meta["output_shape"]
    assert "stablehlo" in (tmp_path / "model.stablehlo.mlir").read_text() \
        or "module" in (tmp_path / "model.stablehlo.mlir").read_text()
    loaded = load_params_npz(str(tmp_path / "params.npz"))
    assert set(loaded) == set(params)


def test_session_applies_fitted_recalibration(params):
    """InferenceSession(variance_scale=s, temperature=t): sigma comes out
    exactly s * the raw sigma; probs are the temperature-softened,
    renormalized raw probs (the deployment path for calibration's fits)."""
    from supernet_tpu.serving import InferenceSession

    x = _x(2, seed=5)
    raw_p, raw_s = InferenceSession(params, CFG, batch_size=2).predict(x)
    s, t = 3.5, 2.0
    cal_p, cal_s = InferenceSession(
        params, CFG, batch_size=2, variance_scale=s, temperature=t
    ).predict(x)
    np.testing.assert_allclose(cal_s, raw_s * s, rtol=1e-5)
    want = np.power(np.maximum(raw_p, 1e-30), 1.0 / t)
    want = want / want.sum(-1, keepdims=True)
    np.testing.assert_allclose(cal_p, want, rtol=1e-4, atol=1e-6)
    # temperature > 1 softens: max confidence cannot increase
    assert cal_p.max() <= raw_p.max() + 1e-6
    with pytest.raises(ValueError, match="positive"):
        InferenceSession(params, CFG, batch_size=2, temperature=0.0)


def test_export_bundle_bakes_recalibration(params, tmp_path):
    """export_bundle(variance_scale, temperature): the fits land in the
    metadata AND in the exported computation — AOT-executing the lowered
    recalibrated module must equal recalibrating the raw outputs."""
    from supernet_tpu.serving import export_bundle, lower

    s, t = 2.0, 1.5
    meta = export_bundle(
        params, CFG, str(tmp_path), batch_size=2, config_name="hippocampus",
        variance_scale=s, temperature=t,
    )
    assert meta["variance_scale"] == s and meta["temperature"] == t
    x = jnp.asarray(_x(2, seed=6))
    raw_p, raw_s = lower(params, CFG, 2).compile()(params, x)
    cal_p, cal_s = lower(
        params, CFG, 2, variance_scale=s, temperature=t
    ).compile()(params, x)
    np.testing.assert_allclose(
        np.asarray(cal_s), np.asarray(raw_s) * s, rtol=1e-5
    )
    want = np.power(np.maximum(np.asarray(raw_p), 1e-30), 1.0 / t)
    want = want / want.sum(-1, keepdims=True)
    np.testing.assert_allclose(np.asarray(cal_p), want, rtol=1e-4, atol=1e-6)


def test_ensemble_identical_members_equal_single(params):
    """K identical members reduce exactly to one session: mixture mean ==
    member mean and mixture var == member var (the disagreement term
    vanishes)."""
    single = serving.InferenceSession(params, CFG, batch_size=2)
    ens = serving.EnsembleSession([params] * 3, CFG, batch_size=2)
    x = _x(2, seed=11)
    p1, s1 = single.predict(x)
    pk, sk = ens.predict(x)
    np.testing.assert_allclose(pk, p1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sk, s1, rtol=1e-4, atol=1e-6)


def test_ensemble_disagreement_raises_variance(params):
    """Distinct members: the served variance equals the mixture-moment
    formula mean(s + p^2) - mean(p)^2 on the member outputs, which is
    >= mean member variance pointwise (Jensen) and strictly greater
    wherever members disagree; probs stay on the simplex."""
    p2 = init_params(jax.random.PRNGKey(99), CFG)
    ens = serving.EnsembleSession([params, p2], CFG, batch_size=2)
    x = _x(2, seed=12)
    pk, sk = ens.predict(x)
    fwd = jax.jit(lambda pr, xx: forward_images(pr, xx, CFG))
    outs = [
        np.asarray(a, np.float64)
        for m in (params, p2)
        for a in fwd(m, jnp.asarray(x))
    ]
    p_mean = (outs[0] + outs[2]) / 2
    want_var = (outs[1] + outs[3]) / 2 + (outs[0] ** 2 + outs[2] ** 2) / 2
    want_var -= p_mean**2
    # atol covers f32 cancellation in mean(p^2) - mean(p)^2 at tiny sigmas
    np.testing.assert_allclose(sk, want_var, rtol=1e-3, atol=1e-7)
    # Jensen: the disagreement term is non-negative, positive somewhere
    gap = want_var - (outs[1] + outs[3]) / 2
    assert gap.min() >= 0.0 and gap.max() > 0.0
    np.testing.assert_allclose(pk.sum(-1), 1.0, atol=1e-4)
    np.testing.assert_allclose(pk, p_mean, atol=1e-5)


def test_ensemble_recalibration_post_mixture(params):
    """variance_scale applies to the MIXTURE variance (fit on ensemble
    outputs), not per member."""
    p2 = init_params(jax.random.PRNGKey(98), CFG)
    raw = serving.EnsembleSession([params, p2], CFG, batch_size=2)
    cal = serving.EnsembleSession(
        [params, p2], CFG, batch_size=2, variance_scale=3.0
    )
    x = _x(2, seed=13)
    _, s_raw = raw.predict(x)
    _, s_cal = cal.predict(x)
    np.testing.assert_allclose(s_cal, 3.0 * s_raw, rtol=1e-5)
    with pytest.raises(ValueError):
        serving.EnsembleSession([], CFG)


def test_ensemble_mesh_members_sharded(params):
    """Mesh-sharded ensemble: the MEMBER axis splits over the mesh's data
    axis (each device runs K/n members on the replicated batch; mixture
    means become an all-reduce) — outputs equal the meshless ensemble.
    A non-dividing K pads the member axis with ZERO-WEIGHT repeats of the
    last member, so the mixture is unchanged (no refusal)."""
    from supernet_tpu.parallel import make_mesh

    members = [init_params(jax.random.PRNGKey(s), CFG) for s in (3, 99)]
    x = _x(2, seed=21)
    base_p, base_s = serving.EnsembleSession(
        members, CFG, batch_size=2).predict(x)
    mesh = make_mesh(2)
    ens = serving.EnsembleSession(members, CFG, batch_size=2, mesh=mesh)
    # the stacked member axis is actually distributed over the mesh
    assert len(ens._params["conv_input"]["w_mu"].sharding.device_set) == 2
    pk, sk = ens.predict(x)
    np.testing.assert_allclose(pk, base_p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sk, base_s, rtol=1e-4, atol=5e-7)

    # K=2 on 8 devices: padded to 8 members, 6 with weight 0 — the
    # mixture (mean AND variance) must equal the meshless 2-member one
    ens8 = serving.EnsembleSession(
        members, CFG, batch_size=2, mesh=make_mesh(8)
    ).warmup()
    assert ens8.n_members == 2
    assert ens8._params["conv_input"]["w_mu"].shape[0] == 8
    p8, s8 = ens8.predict(x)
    np.testing.assert_allclose(p8, base_p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s8, base_s, rtol=1e-4, atol=5e-7)


def test_ensemble_mesh_matches_meshless_at_width():
    """The member-sharded session at a width where letting the SPMD
    partitioner split the vmapped (grouped) convs over the member axis
    gave wrong mixtures (probs off by 1e-2 at 16 base kernels, by 0.2 at
    32): the shard_map path equals the meshless session on a 4-device
    mesh, padding included (K=3)."""
    import dataclasses

    from supernet_tpu.parallel import make_mesh

    cfg = dataclasses.replace(CFG, image_size=32, out_size=22,
                              base_kernels=16)
    members = [init_params(jax.random.PRNGKey(10 + i), cfg) for i in range(3)]
    x = np.random.default_rng(0).normal(0, 1, (5, 32, 32, 1)).astype(
        np.float32)
    base_p, base_s = serving.EnsembleSession(
        members, cfg, batch_size=4).predict(x)
    ens = serving.EnsembleSession(members, cfg, batch_size=4,
                                  mesh=make_mesh(4))
    assert len(ens._params["conv_input"]["w_mu"].sharding.device_set) == 4
    pk, sk = ens.predict(x)
    np.testing.assert_allclose(pk, base_p, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sk, base_s, rtol=1e-4, atol=1e-6)
