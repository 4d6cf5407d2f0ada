"""Test configuration: force an 8-device virtual CPU platform.

Tests must not depend on accelerator hardware; the distributed tests run on
8 simulated host devices (`XLA_FLAGS=--xla_force_host_platform_device_count=8`),
the analog of a fake communication backend (SURVEY.md §4.5).
This must run before jax is imported anywhere.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

# Compilation dominates test runtime; the persistent compilation cache
# (one fixed directory, supernet_tpu.utils.use_compile_cache) makes re-runs
# near-instant.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from supernet_tpu.utils import use_compile_cache  # noqa: E402

use_compile_cache()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")

# ---------------------------------------------------------------------------
# Fast/slow tiers: the full suite takes about an hour on one CPU core,
# dominated by jit compiles of full-model train steps,
# mesh programs, 3-D forwards, and CLI train loops. Those tests are marked
# `slow` centrally here (one table, easy to retune) and excluded by the
# default `-m 'not slow'` in pyproject.toml; run everything with
# `pytest tests/ -m ""`. Every subsystem keeps at least one fast test:
# the op-level / host-side / guard tests stay in the default tier.
# ---------------------------------------------------------------------------

# Whole files where only the listed tests are cheap enough for the default
# tier (file -> fast keepers; everything else in the file is slow).
_SLOW_FILES_FAST_KEEPERS = {
    "test_e2e.py": {
        "test_train_smoke",                 # the one fast end-to-end train
        "test_cli_ensemble_checkpoint_guards",
        "test_study_parser_flags",
    },
    "test_eval3d.py": {
        "test_apply_noise_3d_crop_frame_semantics",
        "test_cli_convert_flag_validation",
        "test_saliency3d_parser_has_val_frac",
        "test_sweep3d_threads_artifact_cap_signature",
    },
}

# Individually slow tests inside otherwise-fast files.
_SLOW_TESTS = {
    "test_unet3d.py": {
        "test_unet3d_training_smoke",
        "test_cli_train3d_synthetic",
        "test_cli_train3d_from_nifti_dir",
        "test_trainer3d_writes_uncertainty_slices",
        "test_trainer3d_continue_training",
        "test_trainer3d_rolls_back_on_nonfinite_loss",
    },
    "test_golden.py": {"test_golden_forward3d"},
    "test_glue_fold.py": {
        "test_forward_and_grad_equality",
        "test_forward3d_fold_equality",
    },
    "test_parallel.py": {
        "test_sharded_step_matches_single_device",
        "test_dryrun_multichip_entrypoint",
        "test_entry_compiles",
        "test_run_testing_with_mesh",
        "test_run_testing_with_mesh_nondivisible_tail",
        "test_run_adversarial_with_mesh_matches_single_device",
        "test_trainer_dp_default_batch_on_non_dividing_devices",
        "test_sharded_adversarial_training_matches_single_device",
        "test_dp_train_step3d_matches_single_device",
        "test_trainer3d_mesh_epoch_runs",
    },
    "test_spatial.py": {
        "test_spatial_encoder_block_matches_unsharded",
        "test_spatial_forward_matches_unsharded",
        "test_spatial_train_step_matches_unsharded",
        "test_spatial_forward3d_matches_unsharded",
        "test_spatial_train_step3d_matches_unsharded",
    },
    "test_hybrid.py": {
        "test_hybrid_train_step_matches_unsharded",
        "test_hybrid_forward_matches_unsharded_and_is_sharded",
        "test_hybrid_train_step3d_matches_unsharded",
        "test_trainer3d_hybrid_shard_runs",
    },
    "test_multihost.py": {
        "test_train_step_on_process_local_arrays",
        "test_two_process_bringup_and_step",
    },
    "test_multistep.py": {
        "test_accum_matches_big_batch",
        "test_multi_step3d_matches_sequential",
        "test_trainer3d_steps_per_dispatch_trains_all_batches",
    },
    "test_adv_training.py": {
        "test_adv_alpha_one_matches_clean_gradient",
        "test_adversarial_training_e2e",
        "test_adversarial_training_sharded_step_runs",
    },
    "test_ensemble_train.py": {
        "test_vmap_matches_sequential",
        "test_vmap_matches_sequential_with_augment",
        "test_checkpoint_layout_and_resume",
        "test_member_sharded_mesh",
        "test_mesh_padding_trains_any_k",
    },
    "test_ensemble_train3d.py": {
        "test_scan_matches_sequential_trainer3d",
        "test_vmap_matches_scan",
        "test_validation_and_artifacts",
        "test_member_sharded_mesh",
        "test_mesh_padding_trains_any_k",
    },
    "test_serving.py": {
        "test_session_mesh_matches_single_device",
        "test_export_bundle_ensemble",
        "test_volumetric_inference_session",
        "test_volumetric_scan_sharded_session_matches_single_device",
        "test_volumetric_export_bundle",
        "test_ensemble_mesh_members_sharded",
    },
    "test_tiling.py": {
        "test_single_tile_equals_direct_forward",
        "test_session_predict_volume_multi_tile",
        "test_streaming_groups_equal_single_call",
        "test_cli_predict3d_npy",
        "test_cli_predict3d_directory",
        "test_cli_train3d_ensemble_then_predict3d",
    },
    "test_inflate.py": {
        "test_inflated_encoder_chain_mean_path_is_exact",
        "test_training_from_inflated_init_runs",
        "test_trainer3d_accepts_inflated_initial_params",
    },
}


def pytest_collection_modifyitems(config, items):
    import pytest

    for item in items:
        fname = item.fspath.basename
        # parametrized ids -> bare function name
        name = item.name.split("[", 1)[0]
        keepers = _SLOW_FILES_FAST_KEEPERS.get(fname)
        if keepers is not None and name not in keepers:
            item.add_marker(pytest.mark.slow)
        elif name in _SLOW_TESTS.get(fname, ()):
            item.add_marker(pytest.mark.slow)
