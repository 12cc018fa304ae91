"""Mode breadth: encode->decode parity across the operating-mode table.

ALL 8 wire modes loopback through the batched pipeline — both polar
codes (64800/64512), both constellations (QPSK/8PSK), and every
cons_cols tiling (432/400/360/512/384/256; BASELINE config 3's sweep).
Mode 6 additionally gets the full interactive-decoder treatment in
test_loopback.py.
"""

import numpy as np
import pytest

from modem import bits as B
from modem.encoder import cached_encoder
from modem.numerology import MODES, make_config
from modem.pipeline import cached_pipeline


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_loopback_pipeline(mode):
    cfg = make_config(8000, mode, 2000)
    enc = cached_encoder(cfg)
    rng = np.random.default_rng(mode)
    payload = rng.integers(0, 256, cfg.mode.data_bytes,
                           dtype=np.uint8).tobytes()
    wave, _ = enc.encode(payload, B.base37_encode("N0CALL"))
    sil = np.zeros(cfg.rate // 4, dtype=np.complex64)
    rec = np.concatenate([sil, wave, sil])[None, :]

    pipe = cached_pipeline(8000, mode)
    res = pipe.decode_batch(rec)
    assert bool(np.asarray(res["ok"])[0])
    assert int(np.asarray(res["flips"])[0]) == 0
    assert pipe.payload_bytes(res, 0) == payload


def test_mode_table_consistency():
    """Derived numbers must match the documented table (SURVEY.md §2.2)."""
    from modem.numerology import MODES
    rows = {6: 50, 7: 54, 8: 81, 9: 90, 10: 42, 11: 56, 12: 84, 13: 126}
    for m, want in rows.items():
        assert MODES[m].cons_rows == want
        assert MODES[m].cons_bits % MODES[m].mod_bits == 0
        assert MODES[m].cons_cnt % MODES[m].cons_cols == 0
