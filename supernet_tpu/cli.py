"""Command-line interface: train / eval / attack / noise-sweep subcommands.

Replaces the reference's "edit the source" configuration mechanism
(`README.md:56-62`) and the module-level driver scripts
(`Hippocampus.py:1571-1601`, `Brats.py:1521-1551`). Usage:

    python -m supernet_tpu.cli train --config hippocampus --data X.pkl
    python -m supernet_tpu.cli eval  --config brats --checkpoint DIR
    python -m supernet_tpu.cli attack --config hippocampus --targeted
    python -m supernet_tpu.cli sweep --config lungs --checkpoint DIR

``--synthetic N`` substitutes a generated dataset when the real pickles are
unavailable (they are absent from the reference snapshot, `README.md:24-29`).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

_UNSET = object()  # sentinel: "use args.checkpoint" in _load_params


def _add_common(
    p: argparse.ArgumentParser,
    dp_help: str = "shard the batch over all visible devices",
) -> None:
    p.add_argument("--config", default="hippocampus",
                   choices=["hippocampus", "brats", "lungs"])
    p.add_argument("--data", default=None, help="dataset pickle/pattern")
    p.add_argument("--synthetic", type=int, default=0,
                   help="use N synthetic samples instead of real data")
    p.add_argument("--out-dir", default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint root (restores the latest "
                        "epoch_{N}), a specific .../epoch_{N} dir, "
                        ".npz params, or Keras .h5 weights")
    p.add_argument("--data-parallel", action="store_true", help=dp_help)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="supernet_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a VDP U-Net")
    _add_common(t)
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--lr", type=float, default=None)
    t.add_argument("--kl-factor", type=float, default=None)
    t.add_argument("--continue-training", action="store_true")
    t.add_argument("--val-data", default=None,
                   help="separate validation dataset (shard dir / pickle "
                        "glob); required for meaningful validation when "
                        "--data is a shard directory or glob")
    t.add_argument("--steps-per-dispatch", type=int, default=1,
                   help="K>1 runs K train steps per device dispatch "
                        "(lax.scan) - removes per-step host round-trips")
    t.add_argument("--adversarial-training", default=None,
                   choices=["none", "fgsm", "pgd"],
                   help="train on adv_alpha*L(clean)+(1-adv_alpha)*L(adv) "
                        "with FGSM/PGD examples generated in the jitted step")
    t.add_argument("--adv-epsilon", type=float, default=None,
                   help="L-inf radius for adversarial training")
    t.add_argument("--ensemble", type=int, default=1, metavar="K",
                   help="K>1 trains K independent members (init seeds "
                        "seed..seed+K-1, independent data shuffles) into "
                        "member_{k}/ subdirectories; serve them with a "
                        "comma-separated --checkpoint list")
    t.add_argument("--ensemble-mode", default="auto",
                   choices=["auto", "vmap", "scan", "unroll", "sequential"],
                   help="auto (default): all K members train as ONE "
                        "compiled program — unrolled over the member axis "
                        "single-device (one compile; on the H100 its step "
                        "costs the same as K sequential ones), vmap with "
                        "--data-parallel (members shard over the "
                        "devices); vmap/scan/unroll force that lowering; "
                        "sequential: K separate full trainings (the "
                        "round-3 behavior)")
    t.add_argument("--adv-alpha", type=float, default=None,
                   help="clean-loss weight (0 = train on adversarial only)")
    t.add_argument("--adv-steps", type=int, default=None,
                   help="PGD iteration count for --adversarial-training pgd")
    t.add_argument("--adv-step-size", type=float, default=None,
                   help="PGD per-step size for --adversarial-training pgd")
    def _add_augment(p: argparse.ArgumentParser) -> None:
        p.add_argument("--augment", action="store_true",
                       help="on-device augmentation inside the jitted step "
                            "(axis flips by default; see --augment-* knobs)")
        p.add_argument("--augment-rot90", action="store_true",
                       help="also rotate by a random multiple of 90 degrees "
                            "(volumes: in the axial H-W plane)")
        p.add_argument("--augment-intensity", type=float, default=0.0,
                       help="intensity jitter: scale U[1±v] and shift "
                            "U[±v/2]")
        p.add_argument("--augment-noise-std", type=float, default=0.0,
                       help="additive Gaussian pixel-noise std")

    _add_augment(t)

    def _add_3d_shape(p: argparse.ArgumentParser) -> None:
        p.add_argument("--cube-size", type=int, default=0,
                       help="input cube side (default: the config's "
                            "image_size, e.g. 64 -> 54^3 output)")
        p.add_argument("--base-kernels", type=int, default=0,
                       help="override the config's channel width")
        p.add_argument("--depth", type=int, default=0,
                       help="override the config's encoder depth")

    t3 = sub.add_parser(
        "train3d",
        help="train the volumetric VDP U-Net on cubes (NIfTI task dir or "
             "--synthetic); out_size is derived from the geometry",
    )
    _add_common(t3)
    _add_3d_shape(t3)
    _add_augment(t3)
    t3.add_argument("--epochs", type=int, default=None)
    t3.add_argument("--lr", type=float, default=None)
    t3.add_argument("--kl-factor", type=float, default=None)
    t3.add_argument("--continue-training", action="store_true")
    t3.add_argument("--val-frac", type=float, default=0.2,
                    help="trailing fraction of volumes held out")
    t3.add_argument("--spatial-shard", action="store_true",
                    help="shard each volume's scan (D) axis over the mesh "
                         "instead of the batch (whole-volume regime); "
                         "implies a mesh over all devices")
    t3.add_argument("--hybrid-shard", type=int, default=0, metavar="N_DATA",
                    help="hybrid sharding: a 2-D (N_DATA x "
                         "devices/N_DATA) mesh with the batch over the "
                         "data axis AND each volume's scan (D) axis over "
                         "the space axis, in the same step")
    t3.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="K>1 runs K train steps per device dispatch "
                         "(lax.scan) - removes per-step host round-trips")
    t3.add_argument("--ensemble", type=int, default=1, metavar="K",
                    help="K>1 trains K independent members (init seeds "
                         "seed..seed+K-1, independent data shuffles) into "
                         "member_{k}/ subdirectories; predict3d serves "
                         "them via a comma-separated --checkpoint list")
    t3.add_argument("--ensemble-mode", default="auto",
                    choices=["auto", "vmap", "scan", "unroll",
                             "sequential"],
                    help="auto (default): all K members train as ONE "
                         "compiled program — unrolled over the member "
                         "axis single-device, vmap with --data-parallel "
                         "(members shard over the devices); "
                         "vmap/scan/unroll force that lowering; "
                         "sequential: K separate full trainings")
    t3.add_argument("--init-from-2d", metavar="CKPT", default=None,
                    help="transfer init: inflate a trained 2-D checkpoint "
                         "(epoch_{N} dir / .npz / Keras .h5) of the SAME "
                         "config into the 3-D model (I3D-style: mean "
                         "kernel tiled over depth / k, weight variance / "
                         "k; see models.inflate_params3d)")

    _DP3D_HELP = (
        "spatial sharding for the 3-D family: the volume's scan (D) axis "
        "is split over all devices (NOT batch DP — whole-volume regime)"
    )

    e3 = sub.add_parser(
        "eval3d",
        help="volumetric clean/noise evaluation: the 2-D testing protocol "
             "on whole volumes (region-masked noise, SNR, per-structure "
             "metrics, center-slice artifacts)",
    )
    _add_common(e3, dp_help=_DP3D_HELP)
    _add_3d_shape(e3)
    e3.add_argument("--val-frac", type=float, default=0.2,
                    help="evaluate only the trailing fraction of the "
                         "volumes — the same trailing split train3d holds "
                         "out, so metrics are on unseen data; 0 = all "
                         "volumes (ignored with --synthetic, which draws "
                         "a fresh set)")
    e3.add_argument("--noise-kind", default="none",
                    choices=["none", "gaussian", "speckle",
                             "salt_and_pepper"])
    e3.add_argument("--noise-std", type=float, default=0.0)
    e3.add_argument("--noise-region", default="all",
                    help="A/P (hippocampus), O/B (brats/lungs), or all")
    e3.add_argument("--sweep", action="store_true",
                    help="clean + every configured noise level x region")
    e3.add_argument("--images-n", type=int, default=4)
    e3.add_argument("--mc-samples", type=int, default=0,
                    help="N>0: evaluate the Monte-Carlo weight-sampling "
                         "baseline (N forwards/batch) instead of the VDP "
                         "propagated moments")
    e3.add_argument("--artifact-max-samples", type=int, default=None,
                    help="cap the rows kept for the full-set "
                         "uncertainty_info.pkl artifact (metrics and the "
                         "variance report still cover ALL samples; "
                         "default: keep all)")

    a3 = sub.add_parser(
        "attack3d", help="FGSM/PGD adversarial evaluation on volumes"
    )
    _add_common(a3, dp_help=_DP3D_HELP)
    _add_3d_shape(a3)
    a3.add_argument("--val-frac", type=float, default=0.2,
                    help="attack only the trailing (held-out) fraction of "
                         "the volumes; 0 = all (ignored with --synthetic)")
    a3.add_argument("--epsilon", type=float, default=None)
    a3.add_argument("--targeted", action="store_true")
    a3.add_argument("--untargeted", action="store_true")
    a3.add_argument("--max-adv-step", type=int, default=None)
    a3.add_argument("--step-size", type=float, default=None)
    a3.add_argument("--images-n", type=int, default=4)
    a3.add_argument("--artifact-max-samples", type=int, default=None,
                    help="cap the rows kept for the full-set "
                         "uncertainty_info.pkl artifact (metrics and the "
                         "variance report still cover ALL samples; "
                         "default: keep all)")

    c3 = sub.add_parser(
        "calibrate3d",
        help="voxel-wise uncertainty-quality report for the 3-D family "
             "(sparsification/AUSE, ECE + reliability)",
    )
    _add_common(c3, dp_help=_DP3D_HELP)
    _add_3d_shape(c3)
    c3.add_argument("--bins", type=int, default=15)
    c3.add_argument("--val-frac", type=float, default=0.2,
                    help="calibrate only on the trailing (held-out) "
                         "fraction of the volumes; 0 = all (ignored with "
                         "--synthetic)")
    c3.add_argument("--mc-samples", type=int, default=0,
                    help="N>0: score the MC weight-sampling baseline's "
                         "uncertainty instead of the VDP propagation")

    e = sub.add_parser("eval", help="clean evaluation + uncertainty report")
    _add_common(e)
    e.add_argument("--images-n", type=int, default=10)
    e.add_argument("--mc-samples", type=int, default=0,
                   help="N>0: evaluate the Monte-Carlo weight-sampling "
                        "baseline (N forwards/batch) instead of the VDP "
                        "propagated moments")
    e.add_argument("--artifact-max-samples", type=int, default=None,
                    help="cap the rows kept for the full-set "
                         "uncertainty_info.pkl artifact (metrics and the "
                         "variance report still cover ALL samples; "
                         "default: keep all)")

    cal = sub.add_parser(
        "calibrate",
        help="uncertainty-quality report: sparsification/AUSE, ECE + "
             "reliability diagram, uncertainty-error correlation",
    )
    _add_common(cal)
    cal.add_argument("--bins", type=int, default=15,
                     help="confidence bins for ECE/reliability")
    cal.add_argument("--mc-samples", type=int, default=0,
                     help="N>0: score the MC weight-sampling baseline's "
                          "uncertainty instead of the VDP propagation")

    a = sub.add_parser("attack", help="FGSM/PGD adversarial evaluation")
    _add_common(a)
    a.add_argument("--epsilon", type=float, default=None)
    a.add_argument("--targeted", action="store_true")
    a.add_argument("--untargeted", action="store_true")
    a.add_argument("--max-adv-step", type=int, default=None)
    a.add_argument("--step-size", type=float, default=None)
    a.add_argument("--images-n", type=int, default=10)
    a.add_argument("--artifact-max-samples", type=int, default=None,
                    help="cap the rows kept for the full-set "
                         "uncertainty_info.pkl artifact (metrics and the "
                         "variance report still cover ALL samples; "
                         "default: keep all)")

    st = sub.add_parser(
        "study",
        help="training-to-convergence study: train at reference scale, "
             "then the FULL eval surface on the trained weights (clean "
             "eval, noise sweep, adversarial attack, calibration) - one "
             "command, one artifact tree, study.json summary",
    )
    _add_common(st)
    st.add_argument("--epochs", type=int, default=None)
    st.add_argument("--continue-training", action="store_true")
    st.add_argument("--skip-train", action="store_true",
                    help="reuse <out-dir>/train checkpoints; run only the "
                         "eval surface")
    st.add_argument("--images-n", type=int, default=10)
    st.add_argument("--artifact-max-samples", type=int, default=None)

    s = sub.add_parser("sweep", help="noise-robustness sweep (levels x regions)")
    _add_common(s)
    s.add_argument("--images-n", type=int, default=10)
    s.add_argument("--artifact-max-samples", type=int, default=None,
                   help="cap the rows kept for EACH run's full-set "
                        "uncertainty_info.pkl artifact (the sweep runs "
                        "clean + levels x regions passes; metrics still "
                        "cover ALL samples; default: keep all)")

    sl = sub.add_parser(
        "saliency", help="gradient saliency maps (Brats.py:598-609)"
    )
    _add_common(sl)
    sl.add_argument("--target-class", type=int, default=None,
                    help="class whose probability mass is differentiated; "
                         "default: all foreground classes")
    sl.add_argument("--images-n", type=int, default=4)

    sl3 = sub.add_parser(
        "saliency3d",
        help="gradient saliency on volumes (center-slice renders of the "
             "3-D input gradient)",
    )
    _add_common(sl3, dp_help=_DP3D_HELP)
    _add_3d_shape(sl3)
    sl3.add_argument("--val-frac", type=float, default=0.2,
                     help="render saliency only for the trailing (held-out) "
                          "fraction of the volumes; 0 = all (ignored with "
                          "--synthetic)")
    sl3.add_argument("--target-class", type=int, default=None,
                     help="class whose probability mass is differentiated; "
                          "default: all foreground classes")
    sl3.add_argument("--images-n", type=int, default=4)

    p3 = sub.add_parser(
        "predict3d",
        help="sliding-window whole-volume inference: one NIfTI/.npy volume "
             "of ANY spatial shape in, full-frame segmentation + "
             "uncertainty maps out (overlapping model cubes batched "
             "through one compiled program, per-voxel moment blending); "
             "a comma-separated --checkpoint list serves the deep "
             "ensemble (member disagreement enters the variance map)",
    )
    _add_common(p3)
    _add_3d_shape(p3)
    p3.add_argument("--volume", required=True,
                    help="input volume (.nii / .nii.gz / .npy, [D,H,W] or "
                         "[D,H,W,C]) OR a directory of such volumes (e.g. "
                         "an MSD imagesTs/); per-modality min-max "
                         "normalized like the training ingestion")
    p3.add_argument("--overlap", type=int, default=8,
                    help="tile overlap in OUTPUT voxels (0 = abutting)")
    p3.add_argument("--blend", default="gaussian",
                    choices=["gaussian", "uniform"],
                    help="per-voxel tile weighting")
    p3.add_argument("--pad-mode", default="reflect",
                    help="np.pad mode for the volume border (the VALID "
                         "margins + grid tail)")
    p3.add_argument("--save-probs", action="store_true",
                    help="also write the full probs/sigma arrays (.npy, "
                         "D*H*W*classes floats each)")
    p3.add_argument("--variance-scale", type=float, default=1.0,
                    help="fitted post-hoc variance scale (cli calibrate)")
    p3.add_argument("--temperature", type=float, default=1.0,
                    help="fitted probability temperature (cli calibrate)")

    c = sub.add_parser(
        "convert",
        help="convert reference pickles OR raw NIfTI volumes to .npy shards",
    )
    _add_common(c)
    c.add_argument("--shard-size", type=int, default=256)
    c.add_argument("--split", default="train", choices=["train", "test"])
    c.add_argument("--out", required=True, help="shard output directory")
    c.add_argument("--from-nifti", action="store_true",
                   help="--data is a Medical-Segmentation-Decathlon task "
                        "dir (imagesTr/labelsTr of .nii.gz volumes); "
                        "extract+normalize 2D slices per the paper protocol")
    c.add_argument("--keep-empty", action="store_true",
                   help="with --from-nifti: keep slices whose label has "
                        "no foreground")
    c.add_argument("--max-volumes", type=int, default=0,
                   help="with --from-nifti: cap the volumes read (smoke runs)")
    c.add_argument("--to-cubes", action="store_true",
                   help="with --from-nifti: write size^3 CUBE shards for "
                        "the 3-D family (train3d/eval3d read the shard "
                        "dir directly) instead of 2-D slices")
    c.add_argument("--cube-size", type=int, default=0,
                   help="with --to-cubes: cube side (default: the "
                        "config's image_size)")

    x = sub.add_parser(
        "export",
        help="serving bundle: StableHLO module + npz params + metadata",
    )
    _add_common(x)
    x.add_argument("--export-batch-size", type=int, default=8,
                   help="static batch size the module is compiled for "
                        "(serving pads/chunks requests to it)")
    x.add_argument("--volumetric", action="store_true",
                   help="export the 3-D family's forward (cube in/out); "
                        "--checkpoint must be a train3d checkpoint dir or .npz")
    _add_3d_shape(x)  # --cube-size / --base-kernels / --depth
    x.add_argument("--variance-scale", type=float, default=1.0,
                   help="bake a fitted post-hoc variance scale (cli "
                        "calibrate's fitted_variance_scale) into the "
                        "exported computation")
    x.add_argument("--temperature", type=float, default=1.0,
                   help="bake a fitted probability temperature (cli "
                        "calibrate's fitted_temperature) into the "
                        "exported computation")

    b = sub.add_parser("bench", help="throughput benchmark")
    pr = sub.add_parser(
        "profile",
        help="exact-join device profile of the train step (per-op class "
             "table joined against the executed executable's HLO; GPU only)")
    pr.add_argument("--config", default="hippocampus",
                    help="hippocampus | brats | lungs | unet3d "
                         "(unet3d = the volumetric family)")
    pr.add_argument("--batch", type=int, default=20)
    pr.add_argument("--iters", type=int, default=20,
                    help="traced dispatches (each runs the K-step scan)")
    pr.add_argument("--by-layer", action="store_true",
                    help="add per-layer conv attribution "
                         "(jax.named_scope layer scopes)")
    pr.add_argument("--out-dir", default=None,
                    help="trace + exact_join.json destination "
                         "(default runs/profile_<config>_<batch>)")
    return ap


def _get_exp(args):
    from supernet_tpu.configs import get_config

    exp = get_config(args.config)
    tkw, ekw = {}, {}
    if getattr(args, "epochs", None) is not None:
        tkw["epochs"] = args.epochs
    if getattr(args, "lr", None) is not None:
        tkw["lr"] = args.lr
    if getattr(args, "kl_factor", None) is not None:
        tkw["kl_factor"] = args.kl_factor
    if getattr(args, "batch_size", None) is not None:
        tkw["batch_size"] = args.batch_size
    if getattr(args, "continue_training", False):
        tkw["continue_training"] = True
    if getattr(args, "adversarial_training", None) is not None:
        tkw["adversarial_training"] = args.adversarial_training
    if getattr(args, "adv_epsilon", None) is not None:
        tkw["adv_epsilon"] = args.adv_epsilon
    if getattr(args, "adv_alpha", None) is not None:
        tkw["adv_alpha"] = args.adv_alpha
    if getattr(args, "adv_steps", None) is not None:
        tkw["adv_steps"] = args.adv_steps
    if getattr(args, "adv_step_size", None) is not None:
        tkw["adv_step_size"] = args.adv_step_size
    if getattr(args, "augment", False):
        from supernet_tpu.configs import AugmentConfig

        v = getattr(args, "augment_intensity", 0.0)
        tkw["augment"] = AugmentConfig(
            rot90=getattr(args, "augment_rot90", False),
            intensity_scale=v,
            intensity_shift=v / 2.0,
            noise_std=getattr(args, "augment_noise_std", 0.0),
        )
    if tkw:
        ekw["train"] = dataclasses.replace(exp.train, **tkw)
    akw = {}
    if getattr(args, "epsilon", None) is not None:
        akw["epsilon"] = args.epsilon
    if getattr(args, "targeted", False):
        akw["targeted"] = True
    if getattr(args, "untargeted", False):
        akw["targeted"] = False
    if getattr(args, "max_adv_step", None) is not None:
        akw["max_adv_step"] = args.max_adv_step
    if getattr(args, "step_size", None) is not None:
        akw["step_size"] = args.step_size
    if akw:
        ekw["attack"] = dataclasses.replace(exp.attack, **akw)
    if args.data:
        ekw["data_path"] = args.data
    if args.out_dir:
        ekw["out_dir"] = args.out_dir
    return exp.replace(**ekw) if ekw else exp


def _load_data(exp, args, split="test"):
    from supernet_tpu.data import (
        PickleDataset,
        load_hippocampus_pickle,
        synthetic_dataset,
    )

    if args.synthetic:
        x, y = synthetic_dataset(exp.model, args.synthetic,
                                 seed=0 if split == "train" else 1)
        return PickleDataset(x, y, exp.model.in_channels)
    import os

    if exp.data_path and os.path.isdir(exp.data_path):
        # .npy shard directory (cli convert output): native C++ streaming
        from supernet_tpu.data import ShardDataset

        return ShardDataset(exp.data_path, shuffle=(split == "train"))
    if exp.name == "brats" and "*" in (exp.data_path or ""):
        from supernet_tpu.data import StreamingPickleDataset

        return StreamingPickleDataset(exp.data_path, exp.model.in_channels)
    xtr, ytr, xte, yte = load_hippocampus_pickle(exp.data_path)
    if split == "train":
        return PickleDataset(xtr, ytr, exp.model.in_channels)
    return PickleDataset(xte, yte, exp.model.in_channels)


def _cfg3d(exp, args):
    """Apply the 3-D shape overrides and derive out_size from the
    volumetric geometry (shared by train3d / eval3d / attack3d /
    calibrate3d so an evaluated model always matches its training shape)."""
    from supernet_tpu.train3d import derive_out_size3d

    cfg = exp.model
    if args.cube_size:
        cfg = dataclasses.replace(cfg, image_size=args.cube_size)
    if args.base_kernels:
        cfg = dataclasses.replace(cfg, base_kernels=args.base_kernels)
    if args.depth:
        cfg = dataclasses.replace(cfg, depth=args.depth,
                                  bottleneck_pre_pad=None)
    cfg = dataclasses.replace(cfg, out_size=derive_out_size3d(cfg))
    return dataclasses.replace(exp, model=cfg)


def _load_volumes(exp, args, seed=0):
    """Cube dataset for the 3-D family: ``--synthetic N`` blobs, a cube
    .npy shard directory (``cli convert --to-cubes`` output), or a NIfTI
    task directory (imagesTr/labelsTr of .nii[.gz]) cut to
    ``cfg.image_size`` cubes via `data.nifti.volume_to_cube`."""
    import glob as _glob
    import os as _os

    import numpy as np

    cfg = exp.model
    if args.synthetic:
        from supernet_tpu.data import synthetic_volumes

        return synthetic_volumes(cfg, args.synthetic, seed=seed)
    src = args.data or exp.data_path
    if src and _glob.glob(_os.path.join(src, "x_*.npy")):
        # cube-shard directory (cli convert --to-cubes output)
        from supernet_tpu.data.shards import shard_pairs

        pairs = shard_pairs(src)
        xs = [np.load(xp) for xp, _ in pairs]
        ys = [np.load(yp) for _, yp in pairs]
        x, y = np.concatenate(xs), np.concatenate(ys)
        if x.shape[1] != cfg.image_size:
            raise SystemExit(
                f"cube shards in {src} are {x.shape[1]}^3 but the config "
                f"expects {cfg.image_size}^3; re-convert or pass "
                f"--cube-size {x.shape[1]}"
            )
        return x, y
    from supernet_tpu.data import read_nifti, volume_to_cube

    img_dir = (
        _os.path.join(src, "imagesTr")
        if _os.path.isdir(_os.path.join(src, "imagesTr"))
        else src
    )
    lbl_dir = _os.path.join(_os.path.dirname(img_dir), "labelsTr")
    xs, ys = [], []
    max_volumes = getattr(args, "max_volumes", 0)
    for p in sorted(_glob.glob(_os.path.join(img_dir, "*.nii*"))):
        if _os.path.basename(p).startswith("._"):
            continue
        if max_volumes and len(xs) >= max_volumes:
            break
        lp = _os.path.join(lbl_dir, _os.path.basename(p))
        if not _os.path.exists(lp):
            # never score/train against silently-zeroed labels
            raise SystemExit(
                f"no label for volume {p} (expected {lp}); the 3-D "
                "drivers need labelsTr to match imagesTr"
            )
        img, _ = read_nifti(p)
        lbl = read_nifti(lp)[0]
        cx, cy = volume_to_cube(img, lbl, cfg.image_size)
        xs.append(cx)
        ys.append(cy)
    if not xs:
        raise SystemExit(f"no .nii[.gz] volumes under {img_dir}")
    return np.stack(xs), np.stack(ys)


def _val_count(n: int, frac: float, batch: int) -> int:
    """train3d's trailing-holdout size: a nonzero fraction is rounded up to
    one full (static-shape) batch, capped so >= one training batch always
    remains. The 3-D eval commands use the SAME formula so their
    --val-frac tail is exactly the set train3d never trained on."""
    n_val = int(n * frac)
    if n_val > 0:
        n_val = max(n_val, batch)
    return min(n_val, max(n - batch, 0))


def _checkpoint_list(args):
    """Comma-separated ``--checkpoint`` = deep-ensemble member list."""
    return [s for s in (getattr(args, "checkpoint", None) or "").split(",")
            if s]


def _load_maybe_ensemble(load_one, exp, args, cmd_ok=True):
    """Load one checkpoint, or a LIST of members for a comma-separated
    --checkpoint (the eval runners mix them via
    `evaluate.ensemble_forward`). ``cmd_ok=False`` rejects the list for
    single-member commands (export/saliency/attack) with a legible
    error."""
    srcs = _checkpoint_list(args)
    if len(srcs) > 1:
        if not cmd_ok:
            raise SystemExit(
                f"{args.cmd} takes ONE checkpoint; a comma-separated "
                "ensemble list is served by eval/calibrate/sweep "
                "(2-D and 3-D) and predict3d"
            )
        return [load_one(exp, args, src=s) for s in srcs]
    return load_one(exp, args)


def _load_params3d(exp, args, src=_UNSET):
    """Volumetric params: random init, .npz, or the latest
    ``epoch_{N}`` checkpoint under --checkpoint (what train3d writes)."""
    import jax

    from supernet_tpu import checkpoint as ckpt
    from supernet_tpu.models import init_params3d
    from supernet_tpu.train import create_train_state

    if src is _UNSET:
        src = args.checkpoint
    if src is None:
        print("warning: no --checkpoint; using random init", file=sys.stderr)
        return init_params3d(jax.random.PRNGKey(0), exp.model)
    if src.endswith(".h5"):
        raise SystemExit(
            "Keras .h5 import is 2-D-only; the 3-D family restores from "
            "epoch_{N} checkpoint dirs or .npz params"
        )
    if src.endswith(".npz"):
        return ckpt.load_params_npz(src)
    root, epoch = ckpt.resolve_checkpoint(src)
    if epoch is None:
        raise FileNotFoundError(f"no epoch_{{N}} checkpoints under {src}")
    params = init_params3d(jax.random.PRNGKey(0), exp.model)
    state, _ = create_train_state(params, exp.train)
    return ckpt.restore_state(root, epoch, state).params


def _load_params(exp, args, src=_UNSET):
    """2-D params from ``args.checkpoint`` (or an explicit ``src``):
    random init, Keras .h5, .npz, or the latest epoch_{N} dir."""
    import jax

    from supernet_tpu import checkpoint as ckpt
    from supernet_tpu.models import init_params
    from supernet_tpu.train import create_train_state

    cfg = exp.model
    if src is _UNSET:
        src = args.checkpoint
    if src is None:
        print("warning: no --checkpoint; using random init", file=sys.stderr)
        return init_params(jax.random.PRNGKey(0), cfg)
    if src.endswith(".h5"):
        return ckpt.import_keras_h5(src, cfg)
    if src.endswith(".npz"):
        return ckpt.load_params_npz(src)
    root, epoch = ckpt.resolve_checkpoint(src)
    if epoch is None:
        raise FileNotFoundError(f"no epoch_{{N}} checkpoints under {src}")
    params = init_params(jax.random.PRNGKey(0), cfg)
    state, _ = create_train_state(params, exp.train)
    return ckpt.restore_state(root, epoch, state).params


def _run_study(exp, args) -> int:
    """The training-to-convergence study (VERDICT r4 #3), one command:
    reference-scale training (epochs/batch/lr from the config, e.g. 120
    epochs for Hippocampus, `Hippocampus.py:426`) followed by the complete
    eval surface on the trained weights — clean eval + uncertainty
    artifacts, the module-level noise sweep, the adversarial protocol, and
    the calibration report. Every stage is the REAL subcommand invoked
    through `main()` (so the study exercises exactly what users run), its
    JSON line captured into <out-dir>/study.json."""
    import contextlib
    import io
    import os
    import time

    out = args.out_dir or f"{exp.out_dir}/{exp.name}/study"
    train_dir = os.path.join(out, "train")
    common = ["--config", args.config]
    if args.synthetic:
        common += ["--synthetic", str(args.synthetic)]
    if args.data:
        common += ["--data", args.data]
    if args.batch_size:
        common += ["--batch-size", str(args.batch_size)]
    if args.data_parallel:
        common += ["--data-parallel"]

    summary = {"out_dir": out, "stages": {}}

    def run_stage(name, argv):
        print(f"[study] {name}: supernet_tpu {' '.join(argv)}",
              file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        text = buf.getvalue()
        sys.stdout.write(text)  # stage output stays visible
        if rc:
            raise SystemExit(f"study stage {name!r} failed (rc={rc})")
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        summary["stages"][name] = {
            "seconds": round(time.perf_counter() - t0, 2),
            "results": [json.loads(ln) for ln in lines],
        }

    if not args.skip_train:
        targs = ["train", *common, "--out-dir", train_dir]
        if args.epochs is not None:
            targs += ["--epochs", str(args.epochs)]
        if args.continue_training:
            targs += ["--continue-training"]
        run_stage("train", targs)
    ckpt = ["--checkpoint", train_dir]
    cap = ([] if args.artifact_max_samples is None
           else ["--artifact-max-samples", str(args.artifact_max_samples)])
    n = ["--images-n", str(args.images_n)]
    run_stage("eval", ["eval", *common, *ckpt, *n, *cap,
                       "--out-dir", os.path.join(out, "eval")])
    run_stage("sweep", ["sweep", *common, *ckpt, *n, *cap,
                        "--out-dir", os.path.join(out, "sweep")])
    run_stage("attack", ["attack", *common, *ckpt, *n, *cap,
                         "--out-dir", os.path.join(out, "attack")])
    run_stage("calibrate", ["calibrate", *common, *ckpt,
                            "--out-dir", os.path.join(out, "calibration")])

    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "study.json")
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    # headline line: final val dice / clean dice / ECE / AUSE / wall time
    head = {"study": path}
    ev = summary["stages"].get("eval", {}).get("results", [])
    if ev:
        for k in ("accuracy", "dice_anterior", "dice_posterior",
                  "dice_tumor", "dice_core", "dice_enhancing",
                  "mean_predictive_variance"):
            if k in ev[0]:
                head[k] = ev[0][k]
    cal = summary["stages"].get("calibrate", {}).get("results", [])
    if cal:
        for k in ("ece", "ause", "corr_pearson", "corr_spearman"):
            if k in cal[0]:
                head[k] = cal[0][k]
    head["total_seconds"] = round(
        sum(s["seconds"] for s in summary["stages"].values()), 2
    )
    print(json.dumps(head))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from supernet_tpu.utils import use_compile_cache

    use_compile_cache()
    # process-level kernel knobs (SUPERNET_PRECISION / SUPERNET_BACKEND /
    # SUPERNET_CONV_FOLD / SUPERNET_ACT_DTYPE)
    from supernet_tpu.ops import apply_env_overrides

    apply_env_overrides()

    if args.cmd == "bench":
        import bench

        return bench.main()

    if args.cmd == "profile":
        import os

        from supernet_tpu.hlo_profile import run as profile_run

        out_dir = args.out_dir or os.path.join(
            "runs", f"profile_{args.config}_{args.batch}")
        os.makedirs(out_dir, exist_ok=True)
        profile_run(args.config, args.batch, out_dir,
                    n_iters=args.iters, by_layer=args.by_layer)
        return 0

    exp = _get_exp(args)

    if args.cmd == "study":
        return _run_study(exp, args)

    if args.cmd == "convert":
        if args.to_cubes and not args.from_nifti:
            raise SystemExit(
                "--to-cubes reads raw NIfTI volumes; pass --from-nifti "
                "with a Medical-Segmentation-Decathlon task directory"
            )
        if args.to_cubes and (args.split != "train" or args.keep_empty):
            raise SystemExit(
                "--split/--keep-empty apply to 2-D slice extraction only; "
                "the cube path reads every imagesTr volume whole (cap the "
                "count with --max-volumes)"
            )
        if args.from_nifti and args.to_cubes:
            from supernet_tpu.data import write_shards

            if args.cube_size:
                exp = exp.replace(
                    model=dataclasses.replace(
                        exp.model, image_size=args.cube_size
                    )
                )
            x, y = _load_volumes(exp, args, seed=0)
            pairs = write_shards(args.out, x, y, shard_size=args.shard_size,
                                 volumetric=True)
            print(json.dumps({
                "shards": len(pairs), "out": args.out,
                "volumes": int(len(x)), "cube": int(x.shape[1]),
            }))
            return 0
        if args.from_nifti:
            from supernet_tpu.data import convert_nifti_dir

            pairs = convert_nifti_dir(
                exp.data_path,
                args.out,
                image_size=exp.model.image_size,
                split=args.split,
                shard_size=args.shard_size,
                keep_empty=args.keep_empty,
                max_volumes=args.max_volumes,
            )
        else:
            from supernet_tpu.data import convert_pickles

            pairs = convert_pickles(
                exp.data_path,
                args.out,
                in_channels=exp.model.in_channels,
                shard_size=args.shard_size,
                split=args.split,
            )
        print(json.dumps({"shards": len(pairs), "out": args.out}))
        return 0

    if args.cmd == "train3d":
        from supernet_tpu.train3d import Trainer3D

        # inherited common flags this driver does not implement: reject
        # loudly rather than silently training single-device / from init
        if args.checkpoint:
            raise SystemExit(
                "train3d resumes via --continue-training from --out-dir; "
                "--checkpoint is not used here"
            )

        mesh3d, shard3d = None, "batch"
        n_modes = sum(
            1 for f in (args.spatial_shard, args.data_parallel,
                        args.hybrid_shard) if f
        )
        if n_modes > 1:
            raise SystemExit(
                "--spatial-shard / --data-parallel / --hybrid-shard are "
                "different sharding regimes (scan axis / batch / both on "
                "a 2-D mesh); pass exactly one"
            )
        if n_modes and args.steps_per_dispatch > 1:
            # mirror Trainer3D's ValueError as a clean CLI error instead
            # of a traceback
            raise SystemExit(
                "--steps-per-dispatch > 1 is not supported together with "
                "a device mesh yet; drop one of the two options"
            )
        if args.hybrid_shard:
            import jax

            from supernet_tpu.parallel import (
                initialize_from_env,
                make_mesh2d,
            )

            initialize_from_env()
            if jax.process_count() > 1:
                raise SystemExit(
                    "--hybrid-shard is single-host for now; use "
                    "--data-parallel for multi-host 3-D training"
                )
            n_data = args.hybrid_shard
            if n_data < 1:
                raise SystemExit(
                    f"--hybrid-shard {n_data}: the data-axis size must be "
                    "a positive integer"
                )
            n_dev = jax.device_count()
            if n_dev % n_data != 0:
                raise SystemExit(
                    f"--hybrid-shard {n_data}: the data axis must divide "
                    f"the device count ({n_dev})"
                )
            if exp.train.batch_size % n_data != 0:
                raise SystemExit(
                    f"--hybrid-shard {n_data}: batch_size "
                    f"{exp.train.batch_size} must divide over the data axis"
                )
            mesh3d = make_mesh2d(n_data, n_dev // n_data)
            shard3d = "hybrid"
            print(
                f"hybrid mesh: {n_data} x {n_dev // n_data} "
                "(batch x scan-axis)",
                file=sys.stderr,
            )
        elif args.spatial_shard:
            import jax

            from supernet_tpu.parallel import initialize_from_env, make_mesh

            initialize_from_env()
            if jax.process_count() > 1:
                raise SystemExit(
                    "--spatial-shard is single-host (the scan-axis feed "
                    "materializes whole volumes per process); use "
                    "--data-parallel for multi-host 3-D training"
                )
            mesh3d, shard3d = make_mesh(jax.device_count()), "scan"
        elif args.data_parallel:
            import jax

            from supernet_tpu.parallel import (
                initialize_from_env,
                make_mesh_for_batch,
            )

            # multi-host bring-up (SUPERNET_COORDINATOR / JAX_COORDINATOR_*
            # env); no-op single-process — same contract as `cli train`
            initialize_from_env()

            if jax.process_count() > 1:
                # Trainer3D's local-rows feed hands every process an equal
                # contiguous block; a shrunken mesh could split unevenly
                # across processes, so multi-host requires the FULL mesh
                # and a globally divisible batch
                if exp.train.batch_size % jax.device_count() != 0:
                    raise SystemExit(
                        f"multi-host training needs a batch_size "
                        f"({exp.train.batch_size}) divisible by the global "
                        f"device count ({jax.device_count()}); adjust "
                        "--batch-size"
                    )
                from supernet_tpu.parallel import global_mesh

                mesh3d = global_mesh()
            else:
                # shrink to the largest divisor of the batch, as `cli train`
                mesh3d = make_mesh_for_batch(exp.train.batch_size)
                if len(mesh3d.devices.flat) < jax.device_count():
                    print(
                        f"note: batch {exp.train.batch_size} does not "
                        f"divide over {jax.device_count()} devices; using "
                        f"a {len(mesh3d.devices.flat)}-device mesh",
                        file=sys.stderr,
                    )

        exp = _cfg3d(exp, args)
        x, y = _load_volumes(exp, args, seed=0)
        # --val-frac 0 really means no validation (see _val_count)
        n_val = _val_count(len(x), args.val_frac, exp.train.batch_size)
        if n_val > 0:
            x_tr, y_tr = x[:-n_val], y[:-n_val]
            x_val, y_val = x[-n_val:], y[-n_val:]
        else:
            x_tr, y_tr, x_val, y_val = x, y, None, None
        init3d = None
        if args.init_from_2d:
            from supernet_tpu.models import inflate_params3d

            # the 2-D checkpoint must match THIS config's layer map
            # (inflate_params3d validates shapes layer by layer)
            p2 = _load_params(exp, args, src=args.init_from_2d)
            init3d = inflate_params3d(p2, exp.model)
            print(f"transfer init: inflated 2-D checkpoint "
                  f"{args.init_from_2d} into the 3-D model",
                  file=sys.stderr)
        if args.ensemble > 1:
            # K independent members: init seeds seed..seed+K-1 (the seed
            # also drives the epoch shuffle, so data order diverges too);
            # a shared --init-from-2d inflation still starts every member
            # from the same mean weights — diversity then comes from the
            # shuffle alone, so prefer random init for ensembles
            base = args.out_dir or f"{exp.out_dir}/{exp.name}_3d/ensemble"
            ensemble_mode3d = args.ensemble_mode
            if ensemble_mode3d == "auto":
                from supernet_tpu.ensemble import (
                    SEQUENTIAL_STEP3D_S,
                    choose_ensemble_mode,
                )

                total_steps = exp.train.epochs * (
                    len(x_tr) // exp.train.batch_size
                )
                ensemble_mode3d, why = choose_ensemble_mode(
                    args.ensemble, total_steps, mesh=mesh3d,
                    step_s=SEQUENTIAL_STEP3D_S,
                )
                print(f"ensemble auto mode -> {ensemble_mode3d} ({why})",
                      file=sys.stderr)
            one_program = ensemble_mode3d != "sequential"
            if one_program and shard3d != "batch":
                # spatial/hybrid sharding splits each volume across the
                # mesh; stacking a member axis on top is untested — run
                # the members sequentially instead
                print(f"note: --ensemble-mode {args.ensemble_mode} does "
                      f"not compose with --spatial-shard/--hybrid yet; "
                      "training members sequentially", file=sys.stderr)
                one_program = False
            if one_program and mesh3d is not None:
                import jax as _jax

                if _jax.process_count() > 1:
                    print("note: one-program ensemble training is "
                          "single-host; training members sequentially",
                          file=sys.stderr)
                    one_program = False
            if one_program:
                # ONE compiled program for all K members — the 3-D twin of
                # the 2-D EnsembleTrainer path above (unroll single-device,
                # vmap member-per-device on a mesh)
                from supernet_tpu.ensemble import EnsembleTrainer3D

                if args.steps_per_dispatch > 1:
                    print("note: --steps-per-dispatch is ignored in "
                          "one-program ensemble mode (the member axis "
                          "already batches the device work)",
                          file=sys.stderr)
                emesh = None
                if mesh3d is not None:
                    # fewer member rounds wins: shrunken divisor mesh vs
                    # full mesh + member padding (EnsembleTrainer3D.n_pad)
                    import jax as _jax

                    from supernet_tpu.parallel import (
                        make_mesh,
                        make_mesh_for_batch,
                    )

                    n_dev = _jax.device_count()
                    shrunk = make_mesh_for_batch(args.ensemble)
                    full_rounds = -(-args.ensemble // n_dev)
                    shrunk_rounds = (
                        args.ensemble // len(shrunk.devices.flat)
                    )
                    emesh = (make_mesh(n_dev)
                             if full_rounds < shrunk_rounds else shrunk)
                    print(f"ensemble members sharded over "
                          f"{len(emesh.devices.flat)} devices",
                          file=sys.stderr)
                tr = EnsembleTrainer3D(
                    exp, args.ensemble, x_tr, y_tr, x_val, y_val,
                    out_dir=base, mesh=emesh,
                    member_mode=ensemble_mode3d,
                    initial_params=init3d,
                )
                tr.run()
                finals = [{m: v[-1] for m, v in h.items() if v}
                          for h in tr.histories]
                print(json.dumps({
                    "members": args.ensemble,
                    "mode": ensemble_mode3d,
                    "dirs": tr.member_dirs,
                    "checkpoint_arg": ",".join(tr.member_dirs),
                    "final": finals,
                }))
                return 0
            dirs, finals = [], []
            for k in range(args.ensemble):
                exp_k = exp.replace(train=dataclasses.replace(
                    exp.train, seed=exp.train.seed + k))
                member_dir = f"{base}/member_{k}"
                print(f"ensemble member {k}/{args.ensemble} -> "
                      f"{member_dir}", file=sys.stderr)
                tr = Trainer3D(exp_k, x_tr, y_tr, x_val, y_val,
                               out_dir=member_dir, mesh=mesh3d,
                               shard=shard3d, initial_params=init3d,
                               steps_per_dispatch=args.steps_per_dispatch)
                tr.run()
                dirs.append(member_dir)
                finals.append(
                    {m: v[-1] for m, v in tr.history.items() if v})
            print(json.dumps({
                "members": args.ensemble,
                "dirs": dirs,
                "checkpoint_arg": ",".join(dirs),
                "final": finals,
            }))
            return 0
        tr = Trainer3D(exp, x_tr, y_tr, x_val, y_val, out_dir=args.out_dir,
                       mesh=mesh3d, shard=shard3d, initial_params=init3d,
                       steps_per_dispatch=args.steps_per_dispatch)
        tr.run()
        print(json.dumps({k: v[-1] for k, v in tr.history.items() if v}))
        return 0

    if args.cmd == "predict3d":
        import os as _os

        import numpy as np

        exp = _cfg3d(exp, args)
        cfg = exp.model
        if _os.path.isdir(args.volume):
            import glob as _glob

            paths = sorted(
                p for pat in ("*.nii", "*.nii.gz", "*.npy")
                for p in _glob.glob(_os.path.join(args.volume, pat))
                if not _os.path.basename(p).startswith(".")
            )
            if not paths:
                raise SystemExit(
                    f"no .nii/.nii.gz/.npy volumes under {args.volume}"
                )
        else:
            paths = [args.volume]

        def _load_volume(path):
            if path.endswith((".nii", ".nii.gz")):
                from supernet_tpu.data import read_nifti

                vol, _ = read_nifti(path)
                nifti = True
            elif path.endswith(".npy"):
                vol, nifti = np.load(path), False
            else:
                raise SystemExit(f"unsupported volume format: {path} "
                                 "(.nii / .nii.gz / .npy)")
            vol = np.asarray(vol, np.float32)
            if vol.ndim == 3:
                vol = vol[..., None]
            if vol.ndim != 4:
                raise SystemExit(
                    f"{path}: expected a 3-D volume, got shape {vol.shape}"
                )
            if vol.shape[-1] != cfg.in_channels:
                raise SystemExit(
                    f"{path}: volume has {vol.shape[-1]} modalities; "
                    f"config {exp.name} expects {cfg.in_channels}"
                )
            # per-modality min-max — the same normalization the training
            # ingestion applies (data.nifti.volume_to_cube)
            flat = vol.reshape(-1, vol.shape[-1])
            lo, hi = flat.min(axis=0), flat.max(axis=0)
            return (vol - lo) / np.maximum(hi - lo, 1e-8), nifti

        from supernet_tpu.serving import EnsembleSession, InferenceSession

        # one session = one compiled program reused across every volume;
        # comma-separated --checkpoint serves the deep ensemble (mixture
        # moments: member disagreement enters the variance map)
        srcs = [s for s in (args.checkpoint or "").split(",") if s]
        common = dict(
            batch_size=args.batch_size or 4,
            volumetric=True,
            variance_scale=args.variance_scale,
            temperature=args.temperature,
        )
        if len(srcs) > 1:
            members = [_load_params3d(exp, args, src=s) for s in srcs]
            mesh = None
            if args.data_parallel:
                import jax

                from supernet_tpu.parallel import make_mesh

                # member-parallel serving: largest device count that
                # divides K runs K/n members per device, mixture means
                # all-reduce across the devices
                n = jax.device_count()
                while n > 1 and len(members) % n != 0:
                    n -= 1
                mesh = make_mesh(n)
                print(f"ensemble members sharded over {n} devices",
                      file=sys.stderr)
            sess = EnsembleSession(members, cfg, mesh=mesh, **common)
        else:
            sess = InferenceSession(_load_params3d(exp, args), cfg, **common)
        out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}_3d/predict"
        _os.makedirs(out_dir, exist_ok=True)
        multi = len(paths) > 1
        for path in paths:
            vol, is_nifti = _load_volume(path)
            probs, sigma = sess.predict_volume(
                vol,
                overlap=args.overlap,
                weight=args.blend,
                pad_mode=args.pad_mode,
            )
            seg = np.argmax(probs, axis=-1).astype(np.int32)
            # predictive variance AT the predicted class — the uncertainty
            # map the 2-D reports render (reports.save_uncertainty_report)
            unc = np.take_along_axis(sigma, seg[..., None], axis=-1)[..., 0]

            stem = _os.path.basename(path)
            for suf in (".nii.gz", ".nii", ".npy"):
                if stem.endswith(suf):
                    stem = stem[: -len(suf)]
                    break
            pre = f"{stem}_" if multi else ""
            ext = ".nii.gz" if is_nifti else ".npy"
            seg_path = _os.path.join(out_dir, f"{pre}segmentation{ext}")
            unc_path = _os.path.join(out_dir, f"{pre}uncertainty{ext}")
            if is_nifti:
                from supernet_tpu.data import write_nifti

                write_nifti(seg_path, seg)
                write_nifti(unc_path, unc.astype(np.float32))
            else:
                np.save(seg_path, seg)
                np.save(unc_path, unc.astype(np.float32))
            extra = {}
            if args.save_probs:
                pp = _os.path.join(out_dir, f"{pre}probs.npy")
                sp = _os.path.join(out_dir, f"{pre}sigma.npy")
                np.save(pp, probs)
                np.save(sp, sigma)
                extra = {"probs": pp, "sigma": sp}
            counts = np.bincount(seg.ravel(), minlength=cfg.n_classes)
            print(json.dumps({
                "input": path,
                "volume": list(vol.shape),
                "cube": cfg.image_size,
                "out_cube": cfg.out_size,
                "overlap": args.overlap,
                "blend": args.blend,
                "class_voxels": [int(c) for c in counts],
                "mean_uncertainty": float(unc.mean()),
                "max_uncertainty": float(unc.max()),
                "segmentation": seg_path,
                "uncertainty": unc_path,
                **extra,
            }))
        return 0

    if args.cmd in ("eval3d", "attack3d", "calibrate3d", "saliency3d"):
        exp = _cfg3d(exp, args)
        # --data-parallel = SPATIAL sharding for the 3-D family: the
        # volume's D axis is split over all devices (whole-volume regime)
        mesh = None
        if args.data_parallel:
            if getattr(args, "mc_samples", 0):
                raise SystemExit(
                    "--mc-samples is a single-device mode; drop "
                    "--data-parallel"
                )
            import jax

            from supernet_tpu.parallel import make_mesh

            mesh = make_mesh(jax.device_count())
        x, y = _load_volumes(exp, args, seed=1)
        # score held-out volumes only: the trailing train3d --val-frac split
        # (synthetic draws a fresh set already — no leakage there)
        if not args.synthetic and getattr(args, "val_frac", 0) > 0:
            n_val = _val_count(len(x), args.val_frac, exp.train.batch_size)
            if n_val > 0:
                x, y = x[-n_val:], y[-n_val:]
                print(
                    f"note: scoring the trailing {n_val} held-out volumes "
                    f"(--val-frac {args.val_frac}); pass --val-frac 0 to "
                    "score everything incl. training volumes",
                    file=sys.stderr,
                )
        params = _load_maybe_ensemble(
            _load_params3d, exp, args,
            cmd_ok=args.cmd in ("eval3d", "calibrate3d"),
        )

        if args.cmd == "eval3d":
            from supernet_tpu.evaluate3d import (
                run_noise_sweep3d,
                run_testing3d,
            )

            if args.sweep:
                results = run_noise_sweep3d(exp, params, x, y,
                                            images_n=args.images_n,
                                            mesh=mesh,
                                            mc_samples=args.mc_samples,
                                            artifact_max_samples=(
                                                args.artifact_max_samples))
                for r in results:
                    print(json.dumps({k: v for k, v in r.items()
                                      if isinstance(v, (int, float, str))}))
                return 0
            from supernet_tpu.configs import NoiseConfig

            nc = NoiseConfig(kind=args.noise_kind, std=args.noise_std,
                             region=args.noise_region)
            res = run_testing3d(exp, params, x, y, nc,
                                out_dir=args.out_dir,
                                images_n=args.images_n, mesh=mesh,
                                mc_samples=args.mc_samples,
                                artifact_max_samples=(
                                    args.artifact_max_samples))
        elif args.cmd == "attack3d":
            from supernet_tpu.evaluate3d import run_adversarial3d

            res = run_adversarial3d(exp, params, x, y,
                                    out_dir=args.out_dir,
                                    images_n=args.images_n, mesh=mesh,
                                    artifact_max_samples=(
                                        args.artifact_max_samples))
        elif args.cmd == "saliency3d":
            import jax.numpy as jnp
            import numpy as np

            from supernet_tpu.attacks import make_saliency_map
            from supernet_tpu.models import forward3d
            from supernet_tpu.reports import save_saliency_maps

            cfg = exp.model
            sal_spec = None
            if mesh is not None:
                from jax.sharding import PartitionSpec as P

                from supernet_tpu.parallel import replicate

                # same regime as eval3d/attack3d: the volume's D (scan)
                # axis is split over the devices, params replicated
                params = replicate(mesh, params)
                sal_spec = P(None, "data")
            sal = make_saliency_map(
                cfg, forward_fn=forward3d, mesh=mesh, x_spec=sal_spec
            )
            if args.target_class is None:  # all foreground
                cmask = jnp.asarray(
                    [0.0] + [1.0] * (cfg.n_classes - 1), jnp.float32
                )
            else:
                cmask = (
                    jnp.zeros(cfg.n_classes).at[args.target_class].set(1.0)
                )
            out_dir = args.out_dir or (
                f"{exp.out_dir}/{exp.name}_3d/saliency"
            )
            count = 0
            b = exp.train.batch_size
            for i in range(0, len(x), b):
                x_np = x[i : i + b]
                xb = jnp.asarray(x_np)
                g, g_relu = sal(params, xb, cmask)
                g, g_relu = np.asarray(g), np.asarray(g_relu)
                mid = xb.shape[1] // 2
                for j in range(len(xb)):
                    if count >= args.images_n:
                        break
                    # center axial slice of the volumetric gradient
                    save_saliency_maps(
                        out_dir,
                        x_np[j, mid],
                        g[j, mid],
                        g_relu[j, mid],
                        index=count,
                    )
                    count += 1
                if count >= args.images_n:
                    break
            res = {"saliency_maps": count, "out_dir": out_dir}
        else:
            from supernet_tpu.evaluate3d import run_calibration3d

            out_dir = args.out_dir or (
                f"{exp.out_dir}/{exp.name}_3d/calibration"
            )
            res = run_calibration3d(exp, params, x, y, out_dir=out_dir,
                                    n_bins=args.bins, mesh=mesh,
                                    mc_samples=args.mc_samples)
        print(json.dumps({k: v for k, v in res.items()
                          if isinstance(v, (int, float, str))}))
        return 0

    if args.cmd == "train":
        from supernet_tpu.trainer import Trainer

        mesh = None
        if args.data_parallel:
            import jax

            from supernet_tpu.parallel import (
                initialize_from_env,
                make_mesh_for_batch,
            )

            # multi-host bring-up (SUPERNET_COORDINATOR / JAX_COORDINATOR_*
            # env); no-op single-process. After this, jax.devices() spans
            # every process and the mesh below covers the whole job.
            initialize_from_env()

            if jax.process_count() > 1:
                # the local-rows feed hands every process an equal
                # contiguous block; a shrunken mesh could split unevenly
                # across processes, so multi-host requires the FULL mesh
                # and a globally divisible batch
                if exp.train.batch_size % jax.device_count() != 0:
                    raise SystemExit(
                        f"multi-host training needs a batch_size "
                        f"({exp.train.batch_size}) divisible by the global "
                        f"device count ({jax.device_count()}); adjust "
                        "--batch-size"
                    )
                from supernet_tpu.parallel import global_mesh

                mesh = global_mesh()
            else:
                # the batch axis must divide over the mesh (NamedSharding);
                # shrink the mesh to the largest divisor of batch_size so
                # the default batch (20) works on any device count (8 -> 5)
                mesh = make_mesh_for_batch(exp.train.batch_size)
                if len(mesh.devices.flat) < jax.device_count():
                    print(
                        f"note: batch {exp.train.batch_size} does not "
                        f"divide over {jax.device_count()} devices; using "
                        f"a {len(mesh.devices.flat)}-device mesh (pass "
                        "--batch-size as a multiple of the device count "
                        "to use all devices)",
                        file=sys.stderr,
                    )
        train_ds = _load_data(exp, args, "train")
        if getattr(args, "val_data", None):
            val_ds = _load_data(exp.replace(data_path=args.val_data),
                                args, "test")
        else:
            import os as _os

            if not args.synthetic and exp.data_path and (
                _os.path.isdir(exp.data_path) or "*" in exp.data_path
            ):
                print("warning: validation will reuse the TRAINING data; "
                      "pass --val-data for a held-out split",
                      file=sys.stderr)
            val_ds = _load_data(exp, args, "test")
        if args.ensemble > 1:
            # K independent members: init seeds seed..seed+K-1 (the seed
            # also drives the epoch shuffle, so data order diverges too)
            base = args.out_dir or f"{exp.out_dir}/{exp.name}/ensemble"
            ensemble_mode = args.ensemble_mode
            if ensemble_mode == "auto":
                # wall-clock crossover: one-program saves (K-1) compiles
                # once but pays a measured per-step tax forever
                # (ensemble.choose_ensemble_mode; VERDICT r4 #5)
                from supernet_tpu.ensemble import choose_ensemble_mode

                try:
                    total_steps = exp.train.epochs * (
                        len(train_ds) // exp.train.batch_size
                    )
                except TypeError:  # unsized stream (e.g. pickle glob)
                    total_steps = None
                ensemble_mode, why = choose_ensemble_mode(
                    args.ensemble, total_steps, mesh=mesh
                )
                print(f"ensemble auto mode -> {ensemble_mode} ({why})",
                      file=sys.stderr)
            if ensemble_mode != "sequential":
                # ONE compiled program for all K members — the training
                # twin of serving.EnsembleSession (VERDICT r3 #4); the
                # member-axis lowering (unroll/scan/vmap) follows
                # EnsembleTrainer's default unless forced
                from supernet_tpu.ensemble import EnsembleTrainer

                if args.steps_per_dispatch > 1:
                    print("note: --steps-per-dispatch is ignored in "
                          "one-program ensemble mode (the member axis "
                          "already batches the device work)",
                          file=sys.stderr)
                emesh = None
                if mesh is not None:
                    # --data-parallel + vmap ensemble = member-per-device.
                    # Two ways to fit K on n devices: shrink the mesh to
                    # the largest divisor of K (zero waste, K/d member
                    # rounds) or keep the FULL mesh and pad the member
                    # axis (EnsembleTrainer.n_pad; ceil(K/n) rounds).
                    # Pick whichever runs fewer member rounds — K=6 on 8
                    # devices now trains in ONE round via padding instead
                    # of three on a shrunken 2-device mesh.
                    import jax

                    from supernet_tpu.parallel import (
                        make_mesh,
                        make_mesh_for_batch,
                    )

                    n_dev = jax.device_count()
                    shrunk = make_mesh_for_batch(args.ensemble)
                    full_rounds = -(-args.ensemble // n_dev)
                    shrunk_rounds = (
                        args.ensemble // len(shrunk.devices.flat)
                    )
                    emesh = (make_mesh(n_dev)
                             if full_rounds < shrunk_rounds else shrunk)
                    print(f"ensemble members sharded over "
                          f"{len(emesh.devices.flat)} devices",
                          file=sys.stderr)
                tr = EnsembleTrainer(
                    exp, args.ensemble, train_ds, val_ds, out_dir=base,
                    mesh=emesh,
                    member_mode=ensemble_mode,
                )
                tr.run()
                dirs = tr.member_dirs
                finals = [{m: v[-1] for m, v in h.items() if v}
                          for h in tr.histories]
            else:
                dirs, finals = [], []
                for k in range(args.ensemble):
                    exp_k = exp.replace(train=dataclasses.replace(
                        exp.train, seed=exp.train.seed + k))
                    member_dir = f"{base}/member_{k}"
                    print(f"ensemble member {k}/{args.ensemble} -> "
                          f"{member_dir}", file=sys.stderr)
                    tr = Trainer(exp_k, train_ds, val_ds,
                                 out_dir=member_dir, mesh=mesh,
                                 steps_per_dispatch=args.steps_per_dispatch)
                    tr.run()
                    dirs.append(member_dir)
                    finals.append(
                        {m: v[-1] for m, v in tr.history.items() if v})
            print(json.dumps({
                "members": args.ensemble,
                "mode": ensemble_mode,
                "dirs": dirs,
                "checkpoint_arg": ",".join(dirs),
                "final": finals,
            }))
            return 0
        tr = Trainer(exp, train_ds, val_ds, out_dir=args.out_dir, mesh=mesh,
                     steps_per_dispatch=args.steps_per_dispatch)
        tr.run()
        print(json.dumps({k: v[-1] for k, v in tr.history.items() if v}))
        return 0

    if args.cmd == "export" and args.volumetric:
        # 3-D bundle: derive the cube geometry, restore a 3-D checkpoint
        from supernet_tpu.serving import export_bundle

        exp = _cfg3d(exp, args)
        params = _load_maybe_ensemble(_load_params3d, exp, args,
                                      cmd_ok=False)
        out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}_3d/export"
        meta = export_bundle(
            params,
            exp.model,
            out_dir,
            batch_size=args.export_batch_size,
            config_name=exp.name,
            volumetric=True,
            variance_scale=args.variance_scale,
            temperature=args.temperature,
        )
        print(json.dumps(meta))
        return 0

    params = _load_maybe_ensemble(
        _load_params, exp, args,
        cmd_ok=args.cmd in ("eval", "calibrate", "sweep"),
    )

    if args.cmd == "export":
        from supernet_tpu.serving import export_bundle

        out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}/export"
        meta = export_bundle(
            params,
            exp.model,
            out_dir,
            batch_size=args.export_batch_size,
            config_name=exp.name,
            variance_scale=args.variance_scale,
            temperature=args.temperature,
        )
        print(json.dumps(meta))
        return 0

    ds = _load_data(exp, args, "test")

    mesh = None
    if getattr(args, "data_parallel", False):
        if getattr(args, "mc_samples", 0):
            raise SystemExit(
                "--mc-samples is a single-device mode; drop --data-parallel"
            )
        from supernet_tpu.parallel import make_mesh_for_batch

        mesh = make_mesh_for_batch(exp.train.batch_size)

    if args.cmd == "eval":
        from supernet_tpu.evaluate import run_testing

        res = run_testing(exp, params, ds, images_n=args.images_n,
                          out_dir=args.out_dir,
                          mesh=mesh,
                          mc_samples=args.mc_samples,
                          artifact_max_samples=args.artifact_max_samples)
        print(json.dumps({k: v for k, v in res.items()
                          if isinstance(v, (int, float, str))}))
        return 0

    if args.cmd == "calibrate":
        from supernet_tpu.calibration import run_calibration

        out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}/calibration"
        res = run_calibration(exp, params, ds, out_dir=out_dir,
                              n_bins=args.bins,
                              mesh=mesh,
                              mc_samples=args.mc_samples)
        print(json.dumps({k: v for k, v in res.items()
                          if isinstance(v, (int, float, str))}))
        return 0

    if args.cmd == "attack":
        from supernet_tpu.evaluate import run_adversarial

        res = run_adversarial(exp, params, ds, images_n=args.images_n,
                              out_dir=args.out_dir, mesh=mesh,
                              artifact_max_samples=args.artifact_max_samples)
        print(json.dumps({k: v for k, v in res.items()
                          if isinstance(v, (int, float, str))}))
        return 0

    if args.cmd == "saliency":
        import jax.numpy as jnp
        import numpy as np

        from supernet_tpu.attacks import make_saliency_map
        from supernet_tpu.reports import save_saliency_maps

        cfg = exp.model
        sal = make_saliency_map(cfg)
        if args.target_class is None:  # all foreground ("all tumor")
            cmask = jnp.asarray(
                [0.0] + [1.0] * (cfg.n_classes - 1), jnp.float32
            )
        else:
            cmask = jnp.zeros(cfg.n_classes).at[args.target_class].set(1.0)
        out_dir = args.out_dir or f"{exp.out_dir}/{exp.name}/saliency"
        count = 0
        for x, _ in ds.batches(exp.train.batch_size):
            g, g_relu = sal(params, jnp.asarray(x), cmask)
            g, g_relu = np.asarray(g), np.asarray(g_relu)
            for i in range(len(x)):
                if count >= args.images_n:
                    break
                save_saliency_maps(
                    out_dir, x[i], g[i], g_relu[i], index=count
                )
                count += 1
            if count >= args.images_n:
                break
        print(json.dumps({"saliency_maps": count, "out_dir": out_dir}))
        return 0

    if args.cmd == "sweep":
        from supernet_tpu.evaluate import run_noise_sweep

        results = run_noise_sweep(exp, params, ds, images_n=args.images_n,
                                  mesh=mesh,
                                  artifact_max_samples=(
                                      args.artifact_max_samples))
        for r in results:
            print(json.dumps({k: v for k, v in r.items()
                              if isinstance(v, (int, float, str))}))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
