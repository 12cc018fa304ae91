"""Frozen-table construction vs the in-repo oracle polar_tables.hh.

The reference repo ships the generated tables (polar_tables.hh:1-2); our
construction (fec/freezer.py) must regenerate them bit-exactly — this is
the one wire-format component with a ground-truth oracle that needs no
reference binary (SURVEY.md §7 stage 2).
"""

import pathlib
import re

import numpy as np
import pytest

from modem.fec import freezer

ORACLE = pathlib.Path("/root/reference/polar_tables.hh")


def parse_oracle(path):
    text = path.read_text()
    out = {}
    for m in re.finditer(r"frozen_(\d+)_(\d+)\[(\d+)\] = \{([^}]*)\}", text):
        n, k = int(m.group(1)), int(m.group(2))
        words = np.array(
            [int(x, 16) for x in re.findall(r"0x[0-9a-fA-F]+", m.group(4))],
            dtype=np.uint64).astype(np.uint32)
        out[(n, k)] = words
    return out


@pytest.mark.skipif(not ORACLE.exists(), reason="oracle tables not mounted")
@pytest.mark.parametrize("n,k", [(64512, 43072), (64800, 43072)])
def test_tables_match_oracle(n, k):
    oracle = parse_oracle(ORACLE)[(n, k)]
    mask = freezer.frozen_mask(n, k, 16)
    assert (freezer.mask_to_words(mask) == oracle).all()


def test_mask_word_roundtrip():
    rng = np.random.default_rng(0)
    mask = rng.integers(0, 2, 1 << 12, dtype=np.uint8)
    words = freezer.mask_to_words(mask)
    assert (freezer.words_to_mask(words) == mask).all()


def test_frozen_count():
    mask = freezer.cached_frozen_mask(64800, 43072, 16)
    assert mask.sum() == (1 << 16) - 43808
    mask = freezer.cached_frozen_mask(64512, 43072, 16)
    assert mask.sum() == (1 << 16) - 44096
