"""SUPER-Net — a variational-density-propagation (VDP) segmentation
framework in JAX.

Re-implements the capabilities of
GiuseppinaC/SUPER-Net-Bayesian-Image-Segmentation-with-Uncertainty-Propagation
as an idiomatic JAX/XLA stack:

- ``ops``      — moment-propagation primitives (mean+variance through conv,
                 ReLU, max-pool, unpool, pad, crop/concat, softmax).
- ``models``   — the parameterized VDP U-Net covering the Hippocampus (depth 3)
                 and BraTS (depth 5) variants of the reference.
- ``losses``   — heteroscedastic Gaussian NLL (ELBO likelihood) + KL
                 regularization.
- ``train``    — jitted train/eval steps, epoch drivers, checkpointing;
                 ``train3d`` — the volumetric (3-D) training driver.
- ``evaluate`` / ``evaluate3d`` — the noise ``testing`` protocol,
                 adversarial branch, and calibration reports (2-D slices /
                 whole volumes).
- ``parallel`` — device-mesh data parallelism (shard_map + psum),
                 spatial (halo-exchange) partitioning incl. the volumetric
                 scan axis, multi-host bring-up.
- ``attacks``  — FGSM / PGD adversarial evaluation (both model families).
- ``perturb``  — Gaussian / speckle / salt&pepper test-time corruptions with
                 region masking.
- ``metrics``  — Dice, Hausdorff, sensitivity/precision/specificity, RVD,
                 over-/under-segmentation, c-score.
- ``reports``  — uncertainty maps, predictive-variance reports, artifacts.
- ``serving``  — compile-once InferenceSession, StableHLO export bundles.
- ``tiling``   — sliding-window whole-volume inference with per-voxel
                 moment blending (volumes larger than one model cube).
"""

__version__ = "0.1.0"
