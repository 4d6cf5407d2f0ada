"""Checkpoint round-trips (npz TrainState + Keras-H5 layout) and
data-pipeline tests."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from supernet_tpu import checkpoint as ckpt
from supernet_tpu.configs import HIPPOCAMPUS
from supernet_tpu.data import (
    BatchIterator,
    PickleDataset,
    StreamingPickleDataset,
    center_crop_np,
    synthetic_dataset,
)
from supernet_tpu.models import init_params
from supernet_tpu.train import create_train_state

CFG = dataclasses.replace(
    HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=4
)


def _params():
    return init_params(jax.random.PRNGKey(0), CFG)


def _assert_params_equal(a, b):
    for name in a:
        for w in ("w_mu", "w_sigma"):
            np.testing.assert_array_equal(
                np.asarray(a[name][w]), np.asarray(b[name][w])
            )


def test_keras_h5_roundtrip(tmp_path):
    params = _params()
    path = str(tmp_path / "vdp_UNET_model.weights.h5")
    ckpt.export_keras_h5(path, params, CFG)
    got = ckpt.import_keras_h5(path, CFG)
    _assert_params_equal(params, got)


def test_keras_h5_shape_mismatch_raises(tmp_path):
    params = _params()
    path = str(tmp_path / "w.h5")
    ckpt.export_keras_h5(path, params, CFG)
    bad_cfg = dataclasses.replace(CFG, base_kernels=8)
    with pytest.raises((ValueError, KeyError)):
        ckpt.import_keras_h5(path, bad_cfg)


def _write_keras2_fixture(path, cfg, rename=None):
    """Hand-build an H5 file in the exact Keras 2 ``save_weights`` layout,
    independently of export_keras_h5: root attrs ``layer_names`` /
    ``backend`` / ``keras_version``, one group per layer carrying a
    ``weight_names`` attr, datasets nested at
    ``{layer}/{layer}/{weight}:0``. Keras auto-names subclassed layers by
    class in creation order: ``my_conv_input``, ``my_conv_intermediate``,
    ``my_conv_intermediate_1``, ... (`Hippocampus.py:343-364`); the input
    conv's weights are ``w_mu1``/``w_sigma1``, the rest ``w_mu``/``w_sigma``
    (`Hippocampus.py:114-122,167-175`). Each layer's arrays are filled with
    its creation index so the import mapping is value-checkable."""
    import h5py

    from supernet_tpu.models import layer_names

    rename = rename or {}
    with h5py.File(path, "w") as f:
        f.attrs["backend"] = b"tensorflow"
        f.attrs["keras_version"] = b"2.15.0"
        layer_list = []
        for i, (name, k, cin, cout) in enumerate(layer_names(cfg)):
            if i == 0:
                klayer, suffix = "my_conv_input", "1"
            else:
                klayer = (
                    "my_conv_intermediate"
                    if i == 1
                    else f"my_conv_intermediate_{i - 1}"
                )
                suffix = ""
            klayer = rename.get(klayer, klayer)
            layer_list.append(klayer.encode())
            g = f.create_group(klayer)
            wnames = []
            for wkey, shape in (
                (f"w_mu{suffix}:0", (k, k, cin, cout)),
                (f"w_sigma{suffix}:0", (cout,)),
            ):
                g.create_dataset(
                    f"{klayer}/{wkey}",
                    data=np.full(shape, float(i), np.float32),
                )
                wnames.append(f"{klayer}/{wkey}".encode())
            g.attrs["weight_names"] = wnames
        f.attrs["layer_names"] = layer_list


def test_import_keras2_layout_fixture(tmp_path):
    """import_keras_h5 against a hand-built file in the documented Keras 2
    save_weights layout (NOT produced by export_keras_h5): every layer must
    map to the right slot — the fill value equals the creation index."""
    from supernet_tpu.models import layer_names

    path = str(tmp_path / "vdp_UNET_model.weights.h5")
    _write_keras2_fixture(path, CFG)
    got = ckpt.import_keras_h5(path, CFG)
    for i, (name, k, cin, cout) in enumerate(layer_names(CFG)):
        assert got[name]["w_mu"].shape == (k, k, cin, cout), name
        assert got[name]["w_sigma"].shape == (cout,), name
        np.testing.assert_array_equal(
            np.asarray(got[name]["w_mu"]),
            np.full((k, k, cin, cout), float(i), np.float32),
            err_msg=name,
        )
        np.testing.assert_array_equal(
            np.asarray(got[name]["w_sigma"]),
            np.full((cout,), float(i), np.float32),
            err_msg=name,
        )


def test_import_keras2_broken_naming_raises(tmp_path):
    """A file violating the creation-order naming scheme fails with a clean
    KeyError naming the missing layer, not a silent mis-mapping."""
    path = str(tmp_path / "broken.weights.h5")
    _write_keras2_fixture(
        path, CFG, rename={"my_conv_intermediate_3": "my_conv_intermediate_99"}
    )
    with pytest.raises(KeyError, match="my_conv_intermediate_3"):
        ckpt.import_keras_h5(path, CFG)


def test_npz_roundtrip(tmp_path):
    params = _params()
    path = str(tmp_path / "params.npz")
    ckpt.save_params_npz(path, params)
    _assert_params_equal(params, ckpt.load_params_npz(path))


def test_orbax_state_roundtrip(tmp_path):
    """The npz TrainState writer (it replaced Orbax under the same name):
    params, Adam moments and step come back exactly, with the template's
    dtypes, and a template of another structure is refused."""
    params = _params()
    state, _ = create_train_state(params, HIPPOCAMPUS.train)
    root = str(tmp_path / "ckpts")
    ckpt.save_state(root, 3, state)
    assert ckpt.latest_epoch(root) == 3
    restored = ckpt.restore_state(root, 3, state)
    _assert_params_equal(state.params, restored.params)
    assert int(restored.step) == int(state.step)
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(state)):
        assert a.dtype == b.dtype and a.shape == b.shape
    with pytest.raises(ValueError, match="saved leaves"):
        ckpt.restore_state(root, 3, state.params)


def test_latest_epoch_none(tmp_path):
    assert ckpt.latest_epoch(str(tmp_path / "nope")) is None


def test_resolve_checkpoint_named_epoch(tmp_path):
    """--checkpoint DIR/epoch_{N} restores that exact epoch — the
    reference's saved_model_epochs selector (`Hippocampus.py:550`) —
    while a root path restores the latest."""
    root = str(tmp_path / "ckpts")
    params = _params()
    state, _ = create_train_state(params, HIPPOCAMPUS.train)
    ckpt.save_state(root, 2, state)
    ckpt.save_state(root, 5, state)
    assert ckpt.resolve_checkpoint(root) == (root, 5)
    import os

    named = os.path.join(root, "epoch_2")
    assert ckpt.resolve_checkpoint(named) == (root, 2)
    assert ckpt.resolve_checkpoint(named + os.sep) == (root, 2)
    # a root with no checkpoints resolves to (root, None)
    empty = str(tmp_path / "empty")
    assert ckpt.resolve_checkpoint(empty) == (empty, None)


# -------------------------------------------------------------------- data


def test_center_crop_np():
    x = np.arange(36, dtype=np.float32).reshape(1, 6, 6, 1)
    got = center_crop_np(x, 4)
    np.testing.assert_array_equal(got, x[:, 1:5, 1:5, :])


def test_synthetic_dataset_shapes():
    x, y = synthetic_dataset(CFG, 6, seed=1)
    assert x.shape == (6, 32, 32, 1) and y.shape == (6, 32, 32)
    assert x.dtype == np.float32
    assert set(np.unique(y)).issubset(set(range(CFG.n_classes)))
    assert (y > 0).any(), "foreground blobs must exist"


def test_pickle_dataset_batching():
    x, y = synthetic_dataset(CFG, 10, seed=2)
    ds = PickleDataset(x, y, in_channels=1)
    batches = list(ds.batches(4, shuffle=True, seed=0))
    assert len(batches) == 2  # drop remainder
    assert batches[0][0].shape == (4, 32, 32, 1)
    assert batches[0][1].shape == (4, 32, 32)


def test_pickle_dataset_onehot_labels_collapsed():
    x = np.zeros((3, 8, 8), np.float32)
    y1h = np.eye(3, dtype=np.float32)[
        np.random.default_rng(0).integers(0, 3, (3, 8, 8))
    ]
    ds = PickleDataset(x, y1h, in_channels=1)
    assert ds.x.shape == (3, 8, 8, 1)
    assert ds.y.shape == (3, 8, 8)


def test_streaming_pickle_dataset(tmp_path):
    import pickle

    rng = np.random.default_rng(0)
    n_files, per = 3, 5
    total = 0
    for i in range(n_files):
        x = rng.normal(0, 1, (per, 4, 16, 16)).astype(np.float32)  # NCHW
        y = rng.integers(0, 5, (per, 16, 16)).astype(np.float32)
        with open(tmp_path / f"training_batch_{i}.pkl", "wb") as f:
            pickle.dump((x, y), f)
        total += per
    ds = StreamingPickleDataset(
        str(tmp_path / "training_batch_*.pkl"), in_channels=4, seed=0
    )
    seen = 0
    for xb, yb in ds.batches(4, drop_remainder=False):
        assert xb.shape[1:] == (16, 16, 4)  # NCHW -> NHWC transpose
        assert yb.shape[1:] == (16, 16)
        seen += len(xb)
    assert seen == total


def test_batch_iterator_prefetch():
    items = [(np.ones(2) * i, i) for i in range(5)]
    got = list(BatchIterator(iter(items), depth=2))
    assert len(got) == 5
    np.testing.assert_array_equal(got[3][0], np.ones(2) * 3)


def test_async_epoch_checkpointer_roundtrip(tmp_path):
    """AsyncEpochCheckpointer: background save, latest_epoch discovery,
    resume via restore_state, keep-policy pruning."""
    import jax

    from supernet_tpu import checkpoint as ckpt
    from supernet_tpu.configs import HIPPOCAMPUS
    from supernet_tpu.models import init_params
    from supernet_tpu.train import create_train_state
    import dataclasses

    cfg = dataclasses.replace(
        HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=4
    )
    params = init_params(jax.random.PRNGKey(0), cfg)
    state, _ = create_train_state(params, HIPPOCAMPUS.train)
    w = ckpt.AsyncEpochCheckpointer(str(tmp_path), keep=2)
    try:
        for e in range(3):
            w.save(e, jax.device_get(state))
        w.wait()
    finally:
        w.close()
    # keep=2 pruned epoch 0
    assert ckpt.latest_epoch(str(tmp_path)) == 2
    assert not (tmp_path / "epoch_0").exists()
    restored = ckpt.restore_state(str(tmp_path), 2, state)
    a = jax.tree_util.tree_leaves(restored.params)
    b = jax.tree_util.tree_leaves(state.params)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
