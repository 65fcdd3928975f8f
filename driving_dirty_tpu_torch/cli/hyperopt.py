"""test-tube's hyperparameter parser (driving_dirty_tpu/cli/hyperopt.py).

The reference declares its grid-search dimensions inline with the model
flags through test-tube's `HyperOptArgumentParser.opt_list(...,
options=[...], tunable=True)`. This module gives that surface, so the
tunable dimensions live with the models and a user's `opt_list` calls run
unchanged:

    parser = HyperOptArgumentParser(strategy="grid_search")
    parser.opt_list("--learning_rate", type=float, default=1e-3,
                    options=[1e-3, 1e-4, 1e-5], tunable=True)
    hparams = parser.parse_args()
    for trial in hparams.trials(12):   # test-tube's hparams.trials(N)
        run(trial)

A plain `argparse.ArgumentParser` works everywhere: the models declare
tunables through the module-level `opt_list` / `tune`, which are
`add_argument` / a no-op on a parser without those methods (the per-model
CLIs do not fan out). cli/submit.py collects the dimensions.

Trial enumeration (`grid(limit)`):
  * grid_search: the full cross product in sorted-dest order, cut to
    `limit` (trial i is the same combination on every host, which the
    fan-out runner and a resume rely on);
  * random_search: `limit` independent draws, one value per dimension,
    seeded with 20200505 (the reference's global seed).
"""
from __future__ import annotations

import argparse
import copy
import itertools
import random

_TRIAL_SEED = 20200505  # the reference seeds everything with this


class TTNamespace(argparse.Namespace):
    """argparse.Namespace + test-tube's `.trials(n)` enumeration."""

    # parser attaches the tunable dims after parse; underscore-prefixed so
    # vars(ns) consumers (hparams dicts) can strip it predictably
    _opt_dims: dict | None = None
    _strategy: str = "grid_search"

    def trials(self, num: int):
        """`num` trial namespaces, each a copy of self with one grid combo
        applied (test-tube: `hyperparams.trials(N)`)."""
        combos = enumerate_trials(self._opt_dims or {}, num, self._strategy)
        out = []
        for overrides in combos:
            t = copy.deepcopy(self)
            for k, v in overrides.items():
                setattr(t, k, v)
            out.append(t)
        return out


def enumerate_trials(dims: dict, limit: int, strategy: str = "grid_search"):
    """Override dicts for `limit` trials over `dims` ({dest: [values]})."""
    if not dims:
        return [{}]
    keys = sorted(dims)
    if strategy == "random_search":
        rng = random.Random(_TRIAL_SEED)
        n = 1 if limit is None else max(1, limit)
        return [{k: rng.choice(dims[k]) for k in keys} for _ in range(n)]
    combos = [dict(zip(keys, c)) for c in itertools.product(*(dims[k] for k in keys))]
    return combos[:limit] if limit is not None else combos


class HyperOptArgumentParser(argparse.ArgumentParser):
    """Drop-in for test-tube's parser: add_argument plus opt_list/opt_range."""

    def __init__(self, *args, strategy: str = "grid_search", **kwargs):
        if strategy not in ("grid_search", "random_search"):
            raise ValueError(f"unknown strategy {strategy!r}")
        super().__init__(*args, **kwargs)
        self.strategy = strategy
        self.opt_dims: dict[str, list] = {}

    def opt_list(self, *names, options=None, tunable=False, **kwargs):
        action = self.add_argument(*names, **kwargs)
        if tunable and options:
            self.opt_dims[action.dest] = list(options)
        return action

    def opt_range(self, *names, low, high, nb_samples=10, tunable=False,
                  log_base=None, **kwargs):
        """Evenly (or log-evenly) spaced options over [low, high]."""
        if log_base is not None:
            import math

            lo, hi = math.log(low, log_base), math.log(high, log_base)
            vals = [log_base ** (lo + i * (hi - lo) / max(1, nb_samples - 1))
                    for i in range(nb_samples)]
        else:
            vals = [low + i * (high - low) / max(1, nb_samples - 1)
                    for i in range(nb_samples)]
        typ = kwargs.get("type", float)
        return self.opt_list(*names, options=[typ(v) for v in vals],
                             tunable=tunable, **kwargs)

    def tune(self, dest: str, options):
        """Mark an ALREADY-REGISTERED argument as a tunable grid dimension
        (for subclasses adding tunability to a base class's argument)."""
        self.opt_dims[dest] = list(options)

    def grid(self, limit=None):
        """Trial override dicts for this parser's tunable dimensions."""
        return enumerate_trials(self.opt_dims, limit, self.strategy)

    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace=namespace or TTNamespace())
        if isinstance(ns, TTNamespace):
            ns._opt_dims = dict(self.opt_dims)
            ns._strategy = self.strategy
        return ns


# --- degradable helpers for model arg registrars ---------------------------
# Models declare tunables with these; on a plain ArgumentParser (the
# per-model CLIs, which never fan out) they reduce to add_argument / no-op.

def opt_list(parser, *names, options=None, tunable=False, **kwargs):
    if hasattr(parser, "opt_list"):
        return parser.opt_list(*names, options=options, tunable=tunable, **kwargs)
    return parser.add_argument(*names, **kwargs)


def tune(parser, dest, options):
    if hasattr(parser, "tune"):
        parser.tune(dest, options)
