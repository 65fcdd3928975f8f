"""driving_dirty_tpu_torch's spatial_bb on dp=2 x tp=2 against the JAX
Trainer on `build_mesh(4, 2)`, on the CPU: the runs, geometry, targets and
tolerances of tests/test_torch_port_spatial_tp_jax.py (spatial_rm), on the
head without the road-map branch (four transposed-conv stages, the last
one whole).
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import pytest

from test_torch_port_mesh import spatial_specs
from test_torch_port_mesh_jax import hold, run_both


@pytest.fixture(scope="module")
def spatial_bb_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spatial_bb_jax"))
    return (root, *run_both("spatial_bb", root))


def test_spatial_bb_on_dp2_tp2_matches_the_jax_mesh(spatial_bb_runs):
    hold("spatial_bb", *spatial_bb_runs)


def test_spatial_bb_shards_are_the_jax_rules(spatial_bb_runs):
    _, _, _, ranks = spatial_bb_runs
    for r in ranks:
        assert sorted(r["shard_shapes"]) == sorted(spatial_specs(rm=False))
        assert r["shard_shapes"]["box_merge.up_conv_3.weight"] == [16, 4, 3, 3]
        assert r["shard_shapes"]["box_merge.ss_deconv.bias"] == [16]
