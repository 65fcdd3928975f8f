"""test-tube's inline tunable flags (driving_dirty_tpu/cli/hyperopt.py:
126-134, `opt_list` and `tune`).

Models declare their grid-search dimensions with the flag itself, as the
reference's HyperOptArgumentParser.opt_list(..., options=[...],
tunable=True) does. On a parser with `opt_list` / `tune` methods (a
test-tube-style HyperOptArgumentParser) the dimension is recorded; on a
plain argparse parser, which every CLI of this package uses, `opt_list` is
`add_argument` and `tune` does nothing. Trial enumeration, the
HyperOptArgumentParser itself and the submit fan-out wait for ROADMAP A.12d.
"""
from __future__ import annotations


def opt_list(parser, *names, options=None, tunable=False, **kwargs):
    if hasattr(parser, "opt_list"):
        return parser.opt_list(*names, options=options, tunable=tunable, **kwargs)
    return parser.add_argument(*names, **kwargs)


def tune(parser, dest, options):
    if hasattr(parser, "tune"):
        parser.tune(dest, options)
