"""driving_dirty_tpu_torch's spatial_rm on dp=2 x tp=2 against the JAX
Trainer on `build_mesh(4, 2)` of the conftest's 8 virtual devices, on the
CPU, as tests/test_torch_port_mesh_jax.py holds roadmap_bce (its docstring
gives the runs and the tolerances: each step's train_loss and the
val_loss rtol 1e-4, the parameters after 2 Adam steps by relative L2 error
per leaf, 1e-3). The "small" spatial geometry (64 x 78 views, 152-px road
maps and rasters, AE hidden 16, latent 8, batch 4, seeded box scenes of
max_bb 100): every conv and transposed conv of the heads with 8k output
channels runs column-parallel over 'model' (its activations gathered over
the channels), the 1-channel last stage and the frozen encoder (its
unfreeze_epoch_no, 20) replicate. Both sides start from one JAX
single-device checkpoint, so it resumes sharded on four ranks. The JAX
task gets its eager targets with the batch (`_targets` reads them): under
jit the JAX rasterizer fills the map for a point box, which box_scenes
holds (ROADMAP.md §C); the port's B2 on each rank's rows equals the eager
map.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import pytest

from test_torch_port_mesh import spatial_specs
from test_torch_port_mesh_jax import hold, run_both


@pytest.fixture(scope="module")
def spatial_rm_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spatial_rm_jax"))
    return (root, *run_both("spatial_rm", root))


def test_spatial_rm_on_dp2_tp2_matches_the_jax_mesh(spatial_rm_runs):
    hold("spatial_rm", *spatial_rm_runs)


def test_spatial_rm_shards_are_the_jax_rules(spatial_rm_runs):
    _, _, _, ranks = spatial_rm_runs
    for r in ranks:
        assert sorted(r["shard_shapes"]) == sorted(spatial_specs(rm=True))
        assert r["shard_shapes"]["box_merge.up_conv_1.weight"] == [96, 32, 3, 3]
        assert r["shard_shapes"]["box_merge.rm_conv_1.weight"] == [16, 1, 8, 8]
