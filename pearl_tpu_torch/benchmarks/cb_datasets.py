"""UCI-shaped classification datasets for the CB benchmark (a copy of
`pearl_tpu/benchmarks/cb_datasets.py`, which is pure numpy: the port keeps
its own so that it imports nothing of the JAX package).

Each dataset has two sources:

1. `load_uci_dataset(name, path)` parses the real UCI file with the
   reference's column conventions (cb_benchmark_config.py:49-88) when a
   local copy exists;
2. `synthetic_uci_dataset(name)` deterministically generates a dataset with
   the same shape (rows x features x classes) as the real one: a Gaussian
   mixture with per-class means, anisotropic feature scales and 5% label
   noise.

`get_dataset(name, data_dir=None)` prefers the real file and falls back to
the synthetic twin; nothing is downloaded. Features are standardized (zero
mean, unit variance) either way. Both packages give the same arrays, bit for
bit, but for a real yeast file, which only the port parses (`_PARSE_RULES`).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

# name -> (rows, feature_dim, num_classes) of the real UCI dataset
# (cb_benchmark_config.py:49-88; row counts from the UCI repository files the
# reference downloads: letter-recognition.data, pendigits.tra, sat.trn,
# yeast.data).
DATASET_SPECS = {
    "letter": (20_000, 16, 26),
    "pendigits": (7_494, 16, 10),
    "satimage": (4_435, 36, 6),
    "yeast": (1_484, 8, 10),
}

# Per-dataset parse rules mirroring cb_benchmark_config.py:49-88:
# (filename, delimiter, target_column, columns_to_drop, label_kind), the
# columns counted in the file. yeast.data has 10 columns (the sequence name,
# 8 features, the localization): its label is column 9, which the reference
# counts as 8 after dropping the name. The JAX package's rule says 8 of the
# file, a feature, and fails on the real file's string label.
_PARSE_RULES = {
    "letter": ("letter-recognition.data", ",", 0, (), "alpha"),
    "pendigits": ("pendigits.tra", ",", 16, (), "int"),
    "satimage": ("sat.trn", None, 36, (), "int"),
    "yeast": ("yeast.data", None, 9, (0,), "str"),
}

LABEL_NOISE = 0.05  # synthetic twin: fraction of randomly flipped labels


def synthetic_uci_dataset(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic UCI-shaped Gaussian-mixture classification data."""
    n, d, k = DATASET_SPECS[name]
    rng = np.random.RandomState(sum(ord(c) for c in name) * 7919 + d + k)
    means = rng.randn(k, d).astype(np.float32) * 1.6
    scales = rng.uniform(0.6, 1.4, (d,)).astype(np.float32)
    labels = rng.randint(0, k, n).astype(np.int32)
    X = means[labels] + rng.randn(n, d).astype(np.float32) * scales[None, :]
    flip = rng.rand(n) < LABEL_NOISE
    labels[flip] = rng.randint(0, k, int(flip.sum()))
    X = (X - X.mean(0)) / (X.std(0) + 1e-8)
    return X.astype(np.float32), labels


def load_uci_dataset(name: str, data_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse a real UCI file with the reference's column conventions."""
    fname, delim, target_col, drop, label_kind = _PARSE_RULES[name]
    path = os.path.join(data_dir, fname)
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rows.append(line.split(delim) if delim else line.split())
    labels_raw = [r[target_col] for r in rows]
    feat_cols = [
        i
        for i in range(len(rows[0]))
        if i != target_col and i not in drop
    ]
    X = np.array(
        [[float(r[i]) for i in feat_cols] for r in rows], dtype=np.float32
    )
    if label_kind == "int":
        y = np.array([int(v) for v in labels_raw], dtype=np.int32)
        y = y - y.min()
    else:
        classes = sorted(set(labels_raw))
        index = {c: i for i, c in enumerate(classes)}
        y = np.array([index[v] for v in labels_raw], dtype=np.int32)
    X = (X - X.mean(0)) / (X.std(0) + 1e-8)
    return X, y


def get_dataset(
    name: str, data_dir: Optional[str] = None
) -> Tuple[np.ndarray, np.ndarray, str]:
    """Returns (features, labels, source) with source in {"uci", "synthetic"}."""
    if name not in DATASET_SPECS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(DATASET_SPECS)}")
    if data_dir is not None:
        fname = _PARSE_RULES[name][0]
        if os.path.exists(os.path.join(data_dir, fname)):
            X, y = load_uci_dataset(name, data_dir)
            return X, y, "uci"
    X, y = synthetic_uci_dataset(name)
    return X, y, "synthetic"
