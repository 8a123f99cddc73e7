"""Text point-cloud loaders (ISPRS ground-truth samples and friends).

A copy of ``neilpy_tpu/io/text.py`` (host pandas), so the PyTorch package
needs no JAX."""

from __future__ import annotations

import pandas as pd

__all__ = ["read_xyz", "read_isprs"]


def read_isprs(fn):
    """Load an ISPRS labelled sample (``samp*.txt``): tab-separated
    ``x y z ground_label`` (reference usage: test_neilpy.py:62-79)."""
    return pd.read_csv(fn, header=None, names=["x", "y", "z", "g"],
                       delimiter="\t")


def read_xyz(fn, delimiter=None, names=("x", "y", "z")):
    """Generic whitespace/delimited xyz loader."""
    # one separator argument only: pandas rejects delimiter= and sep=
    # together, so an explicit delimiter used to raise unconditionally
    return pd.read_csv(fn, header=None, names=list(names),
                       sep=delimiter if delimiter is not None else r"\s+")
