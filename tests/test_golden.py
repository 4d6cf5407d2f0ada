"""Golden-output regression pin: fixed params + fixed input -> fixed
(probs, sigma). Catches any unintended numerical drift in the moment stack
across refactors/rounds (the op-level tests allow per-op tolerances; this
pins the composed model end to end).

The golden file is generated once (f32, CPU, xla backend) and committed;
regenerate deliberately with:  python tests/test_golden.py --regen
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from supernet_tpu.configs import HIPPOCAMPUS
from supernet_tpu.models import forward, init_params

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "hippo_tiny.npz")

CFG = dataclasses.replace(
    HIPPOCAMPUS.model, image_size=32, out_size=22, base_kernels=4
)


def _compute():
    params = init_params(jax.random.PRNGKey(42), CFG)
    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.normal(0, 1, (2, 32, 32, 1)).astype(np.float32))
    probs, sigma = forward(params, x, CFG)
    return np.asarray(probs), np.asarray(sigma)


GOLDEN3D = os.path.join(os.path.dirname(__file__), "golden", "unet3d_tiny.npz")

CFG3 = dataclasses.replace(
    HIPPOCAMPUS.model, image_size=16, out_size=10, base_kernels=2, depth=2
)


def _compute3d():
    from supernet_tpu.models import forward3d, init_params3d

    params = init_params3d(jax.random.PRNGKey(42), CFG3)
    rng = np.random.default_rng(42)
    x = jnp.asarray(rng.normal(0, 1, (2, 16, 16, 16, 1)).astype(np.float32))
    probs, sigma = forward3d(params, x, CFG3)
    return np.asarray(probs), np.asarray(sigma)


def test_golden_forward():
    assert os.path.exists(GOLDEN), "golden file missing - run --regen"
    probs, sigma = _compute()
    with np.load(GOLDEN) as f:
        np.testing.assert_allclose(probs, f["probs"], atol=2e-5)
        np.testing.assert_allclose(sigma, f["sigma"], atol=2e-5)


def test_golden_forward3d():
    """Same end-to-end pin for the volumetric family (generated right after
    the fused lhs-dilated unpool landed, so any later drift in the 3-D
    moment stack is caught)."""
    assert os.path.exists(GOLDEN3D), "golden file missing - run --regen"
    probs, sigma = _compute3d()
    with np.load(GOLDEN3D) as f:
        np.testing.assert_allclose(probs, f["probs"], atol=2e-5)
        np.testing.assert_allclose(sigma, f["sigma"], atol=2e-5)


if __name__ == "__main__":
    import sys

    if "--regen" in sys.argv:
        # goldens are defined as f32/CPU/xla outputs; pin via the live
        # config (a process that imported jax already has read the env)
        jax.config.update("jax_platforms", "cpu")
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        probs, sigma = _compute()
        np.savez(GOLDEN, probs=probs, sigma=sigma)
        print("wrote", GOLDEN)
        probs, sigma = _compute3d()
        np.savez(GOLDEN3D, probs=probs, sigma=sigma)
        print("wrote", GOLDEN3D)
