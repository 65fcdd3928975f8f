"""driving_dirty_tpu_torch/cli/hyperopt.py against the JAX package's
(driving_dirty_tpu/cli/hyperopt.py): each case of tests/test_hyperopt.py
on the port's parser, and the trials of both packages equal (the same
override dicts in the same order) for grid and seeded random search, and
for the parsed namespaces' `trials`. No tolerance: the values are the same
Python numbers, log-spaced ranges included.
"""
from test_torch_threads import torch_worker_threads  # noqa: F401  (torch threads of a test worker)

import argparse

import pytest

from driving_dirty_tpu.cli import hyperopt as J
from driving_dirty_tpu_torch.cli.hyperopt import (HyperOptArgumentParser, TTNamespace, enumerate_trials,
                                                  opt_list, tune)


def _parser(mod=None):
    """The test parser on the port's HyperOptArgumentParser, or on `mod`'s."""
    p = (mod.HyperOptArgumentParser if mod is not None else HyperOptArgumentParser)(strategy="grid_search")
    p.opt_list("--lr", type=float, default=1e-3, options=[1e-3, 1e-4], tunable=True)
    p.opt_list("--latent", type=int, default=128, options=[64, 128, 256], tunable=True)
    p.opt_list("--not_tuned", type=int, default=5, options=[5, 6], tunable=False)
    p.add_argument("--plain", type=str, default="x")
    return p


def test_grid_enumeration_order_and_truncation():
    p = _parser()
    grid = p.grid(None)
    assert len(grid) == 6  # 3 latent x 2 lr, sorted-dest cross product
    assert grid[0] == {"latent": 64, "lr": 1e-3}
    assert grid[1] == {"latent": 64, "lr": 1e-4}
    assert p.grid(2) == grid[:2]
    assert all(set(g) == {"latent", "lr"} for g in grid)  # non-tunable / plain args are no dimension
    assert grid == _parser(J).grid(None)


def test_parse_args_namespace_trials():
    p = _parser()
    hparams = p.parse_args(["--plain", "y"])
    assert isinstance(hparams, TTNamespace)
    assert hparams.plain == "y" and hparams.not_tuned == 5
    trials = hparams.trials(4)  # test-tube: hyperparams.trials(N)
    assert [(t.latent, t.lr) for t in trials] == [(64, 1e-3), (64, 1e-4), (128, 1e-3), (128, 1e-4)]
    assert all(t.plain == "y" for t in trials)
    assert p.parse_args(["--lr", "0.5"]).lr == 0.5  # an explicit value keeps the dimension
    ref = _parser(J).parse_args(["--plain", "y"]).trials(4)
    assert [vars(t) for t in trials] == [vars(t) for t in ref]


@pytest.mark.parametrize("limit", [1, 5, 12])
def test_random_search_is_seeded_and_the_jax_packages(limit):
    grids = []
    for cls in (HyperOptArgumentParser, J.HyperOptArgumentParser):
        p = cls(strategy="random_search")
        p.opt_list("--a", type=int, default=0, options=list(range(100)), tunable=True)
        p.opt_list("--b", type=float, default=0.0, options=[0.1, 0.2, 0.3], tunable=True)
        assert p.grid(limit) == p.grid(limit)  # deterministic across calls
        grids.append(p.grid(limit))
    assert len(grids[0]) == limit and all(set(t) == {"a", "b"} for t in grids[0])
    assert grids[0] == grids[1]


def test_opt_range_linear_and_log():
    p = HyperOptArgumentParser()
    p.opt_range("--lin", type=float, default=0.0, low=0.0, high=1.0, nb_samples=5, tunable=True)
    p.opt_range("--lg", type=float, default=1e-4, low=1e-4, high=1e-1, nb_samples=4, log_base=10, tunable=True)
    assert p.opt_dims["lin"] == [0.0, 0.25, 0.5, 0.75, 1.0]
    lg = p.opt_dims["lg"]
    assert lg[0] == pytest.approx(1e-4) and lg[-1] == pytest.approx(1e-1)
    assert lg[1] == pytest.approx(1e-3) and lg[2] == pytest.approx(1e-2)
    q = J.HyperOptArgumentParser()
    q.opt_range("--lin", type=float, default=0.0, low=0.0, high=1.0, nb_samples=5, tunable=True)
    q.opt_range("--lg", type=float, default=1e-4, low=1e-4, high=1e-1, nb_samples=4, log_base=10, tunable=True)
    assert p.opt_dims == q.opt_dims and p.grid(None) == q.grid(None)


def test_helpers_degrade_on_plain_parser():
    p = argparse.ArgumentParser()
    opt_list(p, "--lr", type=float, default=1e-3, options=[1, 2], tunable=True)
    tune(p, "lr", [1, 2])  # no-op, must not raise
    assert p.parse_args([]).lr == 1e-3
    assert not hasattr(p, "opt_dims")
    h = HyperOptArgumentParser()
    h.add_argument("--lr", type=float, default=1e-3)
    tune(h, "lr", [1, 2])  # on a HyperOptArgumentParser: a dimension of an existing flag
    assert h.grid(None) == [{"lr": 1}, {"lr": 2}]


def test_unknown_strategy_rejected():
    with pytest.raises(ValueError):
        HyperOptArgumentParser(strategy="bayesian")
    assert enumerate_trials({}, 3) == [{}] == J.enumerate_trials({}, 3)
