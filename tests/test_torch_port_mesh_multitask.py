"""driving_dirty_tpu_torch's multitask on dp=2 x tp=2 against the JAX
Trainer on `build_mesh(4, 2)` of the conftest's 8 virtual devices, on the
CPU, as tests/test_torch_port_mesh_jax.py holds roadmap_bce (its docstring
gives the runs and the tolerances). The "small" spatial geometry (64 x 78
views, AE hidden 16, latent 8, batch 4, seeded box scenes of max_bb 100):
rm_head runs column-parallel and the encoder's fc1.fc row-parallel, the
box head replicates; the encoder stays frozen (multitask's
unfreeze_epoch_no, 20), and B2's targets come from each rank's rows.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import pytest

from test_torch_port_mesh_jax import hold, run_both


@pytest.fixture(scope="module")
def multitask_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_multitask"))
    return (root, *run_both("multitask", root))


def test_multitask_on_dp2_tp2_matches_the_jax_mesh(multitask_runs):
    hold("multitask", *multitask_runs)


def test_multitask_shards_are_the_jax_rules(multitask_runs):
    _, _, _, ranks = multitask_runs
    assert ranks[0]["shard_shapes"] == {"encoder.fc1.fc.weight": [16, 29952], "rm_head.weight": [320000, 8],
                                        "rm_head.bias": [320000]}
