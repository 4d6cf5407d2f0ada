"""Checkpointing: npz files for native state + a Keras-H5 weight importer.

The reference checkpoints with Keras ``save_weights``/``load_weights`` into
``./{Dataset}/saved_models_SUPER_u-Net/epoch_{N}/vdp_UNET_model.weights.h5``
every epoch (`Hippocampus.py:474,549-555,665,743`; C37 in SURVEY.md §2.6),
resuming via ``continue_training``/``saved_model_epochs``.

Here:
- native path: the full ``TrainState`` pytree (params + optimizer state +
  step) as one ``epoch_{N}/state.npz``, same ``epoch_{N}`` directory
  scheme, ``latest_epoch``/resume helpers, a background-thread writer;
- ``import_keras_h5`` reads the reference's H5 layout into our params dict
  so pretrained-parity evals can run. Keras names subclassed layers by class
  in creation order (``my_conv_input``, ``my_conv_intermediate``,
  ``my_conv_intermediate_1``, ...), and creation order in
  ``Density_prop_with_pad_UNET.__init__`` equals our ``layer_names`` order
  (`Hippocampus.py:343-364`, `Brats.py:331-368`), with weights named
  ``w_mu1``/``w_sigma1`` on the input conv and ``w_mu``/``w_sigma``
  elsewhere (`Hippocampus.py:114-122,167-175`);
- ``export_keras_h5`` writes the same layout (round-trip tested, and lets
  users of the reference load our trained weights back into it).
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import shutil
from typing import Dict, List, Optional

import jax
import numpy as np

from supernet_tpu.configs import ModelConfig
from supernet_tpu.models import layer_names

Params = Dict[str, Dict[str, jax.Array]]


# ----------------------------------------------------------- train state

STATE_FILE = "state.npz"


def _epoch_dir(root: str, epoch: int) -> str:
    return os.path.join(os.path.abspath(root), f"epoch_{epoch}")


def _state_path(root: str, epoch: int) -> str:
    return os.path.join(_epoch_dir(root, epoch), STATE_FILE)


def _write_npz(path: str, state) -> None:
    """One ``leaf_{i}`` array per pytree leaf, in ``tree_flatten`` order,
    plus each leaf's key path for a readable mismatch error. Written to a
    temporary name and renamed, so a reader never sees a partial file."""
    leaves_kp, _ = jax.tree_util.tree_flatten_with_path(state)
    arrays = {f"leaf_{i}": np.asarray(v) for i, (_, v) in enumerate(leaves_kp)}
    arrays["paths"] = np.array(
        [jax.tree_util.keystr(kp) for kp, _ in leaves_kp], dtype=str
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def save_state(root: str, epoch: int, state) -> str:
    """Save a TrainState pytree (params + optimizer state + step) to
    ``root/epoch_{N}/state.npz``."""
    path = _state_path(root, epoch)
    _write_npz(path, state)
    return path


def restore_state(root: str, epoch: int, template):
    """Restore a TrainState saved by ``save_state`` or the async writer;
    ``template`` is an abstract or concrete pytree of matching structure
    whose leaf shapes and dtypes the restored arrays take."""
    path = _state_path(root, epoch)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    with np.load(path) as f:
        n = sum(1 for k in f.files if k.startswith("leaf_"))
        if n != len(leaves):
            raise ValueError(
                f"{path}: {n} saved leaves, template has {len(leaves)}"
            )
        paths = f["paths"]
        out = []
        for i, t in enumerate(leaves):
            a = f[f"leaf_{i}"]
            if a.shape != tuple(t.shape):
                raise ValueError(
                    f"{path}: leaf {paths[i]} has shape {a.shape}, "
                    f"template expects {tuple(t.shape)}"
                )
            out.append(jax.numpy.asarray(a, dtype=t.dtype))
    return jax.tree_util.tree_unflatten(treedef, out)


def resolve_checkpoint(src: str):
    """(root, epoch) from a checkpoint path: ``.../epoch_{N}`` names that
    exact epoch (the reference's ``saved_model_epochs`` selector,
    `Hippocampus.py:550`); anything else is a root whose LATEST epoch is
    picked. ``epoch`` is None when the root holds no checkpoints."""
    m = re.fullmatch(r"epoch_(\d+)", os.path.basename(os.path.normpath(src)))
    if m:
        root = os.path.dirname(os.path.normpath(src))
        return root, int(m.group(1))
    return src, latest_epoch(src)


def latest_epoch(root: str) -> Optional[int]:
    """Highest N with a complete ``epoch_{N}/state.npz`` under root, or
    None."""
    if not os.path.isdir(root):
        return None
    best = None
    for name in os.listdir(root):
        m = re.fullmatch(r"epoch_(\d+)", name)
        if m and os.path.isfile(os.path.join(root, name, STATE_FILE)):
            n = int(m.group(1))
            best = n if best is None or n > best else best
    return best


class AsyncEpochCheckpointer:
    """Non-blocking per-epoch checkpointing (SURVEY.md §5: the reference
    blocks training on a synchronous Keras ``save_weights`` every epoch,
    `Hippocampus.py:665`). ``save`` takes a host copy of the state
    (``jax.device_get``) and one background thread writes the epochs in
    order while the next epoch trains; ``wait()`` drains and re-raises a
    failed write.

    Same ``root/epoch_{N}/state.npz`` layout as ``save_state``, so
    ``latest_epoch`` / ``restore_state`` work across both writers. With
    ``keep`` set, only the newest ``keep`` epochs stay on disk.
    """

    def __init__(self, root: str, keep: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.keep = keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending: List[concurrent.futures.Future] = []
        self._saved: List[int] = []

    def _write(self, epoch: int, state, victim: Optional[int]) -> None:
        _write_npz(_state_path(self.root, epoch), state)
        if victim is not None:
            shutil.rmtree(_epoch_dir(self.root, victim), ignore_errors=True)

    def save(self, epoch: int, state) -> None:
        host = jax.device_get(state)
        self._saved.append(epoch)
        victim = None
        if self.keep is not None and len(self._saved) > self.keep:
            victim = self._saved.pop(0)
        self._pending.append(self._pool.submit(self._write, epoch, host, victim))

    def restore(self, epoch: int, template):
        self.wait()
        return restore_state(self.root, epoch, template)

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


# ---------------------------------------------------------------- keras h5


def _keras_layer_name(index: int) -> str:
    """Keras auto-name of the i-th conv layer in creation order."""
    if index == 0:
        return "my_conv_input"
    if index == 1:
        return "my_conv_intermediate"
    return f"my_conv_intermediate_{index - 1}"


def _h5_weight_map(f) -> Dict[str, np.ndarray]:
    """Flatten an H5 weights file to {layer_name/weight_name: array},
    handling both the attr-based Keras 2 layout and a bare group walk."""
    out: Dict[str, np.ndarray] = {}

    def visit(name, obj):
        import h5py

        if isinstance(obj, h5py.Dataset):
            out[name] = np.asarray(obj)

    f.visititems(visit)
    return out


def import_keras_h5(path: str, cfg: ModelConfig) -> Params:
    """Read a reference ``vdp_UNET_model.weights.h5`` into our params dict.

    Matching is by Keras creation-order layer name + weight suffix, with a
    shape check against ``layer_names(cfg)``.
    """
    import h5py

    names = layer_names(cfg)
    params: Params = {}
    with h5py.File(path, "r") as f:
        flat = _h5_weight_map(f)
        for i, (name, k, cin, cout) in enumerate(names):
            klayer = _keras_layer_name(i)
            suffix = "1" if i == 0 else ""
            mu_keys = [
                key
                for key in flat
                if klayer in key.split("/") and f"w_mu{suffix}" in key
            ]
            sg_keys = [
                key
                for key in flat
                if klayer in key.split("/") and f"w_sigma{suffix}" in key
            ]
            if len(mu_keys) != 1 or len(sg_keys) != 1:
                raise KeyError(
                    f"layer {name} ({klayer}): expected exactly one "
                    f"w_mu{suffix}/w_sigma{suffix}, found {mu_keys} / {sg_keys}"
                )
            w_mu = flat[mu_keys[0]].astype(np.float32)
            w_sigma = flat[sg_keys[0]].astype(np.float32)
            if w_mu.shape != (k, k, cin, cout) or w_sigma.shape != (cout,):
                raise ValueError(
                    f"layer {name}: shape mismatch, h5 has "
                    f"{w_mu.shape}/{w_sigma.shape}, model expects "
                    f"{(k, k, cin, cout)}/{(cout,)}"
                )
            params[name] = {
                "w_mu": jax.numpy.asarray(w_mu),
                "w_sigma": jax.numpy.asarray(w_sigma),
            }
    return params


def export_keras_h5(path: str, params: Params, cfg: ModelConfig) -> None:
    """Write our params in the reference's H5 layout (Keras-2 style groups
    ``{layer}/{layer}/{weight}:0`` plus the layer_names/weight_names attrs)."""
    import h5py

    names = layer_names(cfg)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        layer_list: List[bytes] = []
        for i, (name, _, _, _) in enumerate(names):
            klayer = _keras_layer_name(i)
            layer_list.append(klayer.encode())
            suffix = "1" if i == 0 else ""
            g = f.create_group(klayer)
            wnames = []
            for wkey, our in (
                (f"w_mu{suffix}:0", "w_mu"),
                (f"w_sigma{suffix}:0", "w_sigma"),
            ):
                full = f"{klayer}/{wkey}"
                g.create_dataset(
                    full.split("/", 1)[1],
                    data=np.asarray(params[name][our], np.float32),
                )
                wnames.append(full.encode())
            g.attrs["weight_names"] = wnames
        f.attrs["layer_names"] = layer_list


# -------------------------------------------------------------- npz (light)


def save_params_npz(path: str, params: Params) -> None:
    """Flat params-only dump (the serving bundle's weights and the
    ``--checkpoint x.npz`` input)."""
    flat = {
        f"{layer}/{w}": np.asarray(v)
        for layer, ws in params.items()
        for w, v in ws.items()
    }
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    np.savez(path, **flat)


def load_params_npz(path: str) -> Params:
    out: Params = {}
    with np.load(path) as f:
        for key in f.files:
            layer, w = key.rsplit("/", 1)
            out.setdefault(layer, {})[w] = jax.numpy.asarray(f[key])
    return out
