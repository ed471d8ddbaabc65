"""Full coded chain: whitening + FEC + diagonal interleave + Gray + CRC
(the complete pipeline the reference only ships primitives for —
SURVEY.md §7 step 4) across CR 4/5..4/8, LDRO, implicit/explicit header,
including over-the-air round trips and error-correction behaviour."""

import numpy as np
import pytest
import jax

from lora_phy_tpu.models import coded, modem
from lora_phy_tpu.models.coded import CodedConfig
from lora_phy_tpu.ops.impair import apply_awgn
from lora_phy_tpu.utils.params import LoraParams


@pytest.mark.parametrize("cr", [1, 2, 3, 4])
@pytest.mark.parametrize("sf", [7, 9, 12])
def test_coded_roundtrip(sf, cr):
    cfg = CodedConfig(sf=sf, cr=cr)
    payload = (np.arange(19, dtype=np.uint8) * 13 + 7).astype(np.uint8)
    syms = coded.encode_payload(payload, cfg)
    out, crc_ok, fec_err = coded.decode_payload(syms, len(payload), cfg)
    np.testing.assert_array_equal(np.asarray(out), payload)
    assert bool(np.all(np.asarray(crc_ok)))
    assert int(np.asarray(fec_err)) == 0


@pytest.mark.parametrize("ldro", [False, True])
@pytest.mark.parametrize("crc", [False, True])
@pytest.mark.parametrize("whiten", [False, True])
def test_coded_modes(ldro, crc, whiten):
    cfg = CodedConfig(sf=8, cr=4, ldro=ldro, crc=crc, whiten=whiten)
    payload = np.frombuffer(b"Hello LoRa GPU!!", dtype=np.uint8)
    syms = coded.encode_payload(payload, cfg)
    assert syms.shape[-1] == coded.payload_symbol_count(len(payload), cfg)
    # symbols stay inside the chirp alphabet
    assert int(np.asarray(syms).max()) < (1 << cfg.sf)
    out, crc_ok, _ = coded.decode_payload(syms, len(payload), cfg)
    np.testing.assert_array_equal(np.asarray(out), payload)
    assert bool(np.all(np.asarray(crc_ok)))


@pytest.mark.parametrize("cr", [3, 4])
def test_single_symbol_error_corrected(cr):
    """A +-1-bin demod error costs one Gray bit -> one codeword bit, which
    CR 4/7 and 4/8 correct. This is the design point of the Gray placement."""
    cfg = CodedConfig(sf=7, cr=cr)
    payload = np.arange(14, dtype=np.uint8)
    syms = np.asarray(coded.encode_payload(payload, cfg)).copy()
    syms[3] = (syms[3] + 1) % (1 << cfg.sf)   # adjacent-bin error
    out, crc_ok, fec_err = coded.decode_payload(syms, len(payload), cfg)
    np.testing.assert_array_equal(np.asarray(out), payload)
    assert bool(np.all(np.asarray(crc_ok)))
    assert int(np.asarray(fec_err)) >= 1      # error detected and corrected


def test_parity_detects_but_not_corrects():
    cfg = CodedConfig(sf=7, cr=1)
    payload = np.arange(14, dtype=np.uint8)
    syms = np.asarray(coded.encode_payload(payload, cfg)).copy()
    syms[3] ^= 1
    out, crc_ok, fec_err = coded.decode_payload(syms, len(payload), cfg)
    assert int(np.asarray(fec_err)) >= 1
    assert not bool(np.all(np.asarray(crc_ok)))


def test_crc_catches_corruption():
    cfg = CodedConfig(sf=7, cr=4)
    payload = np.arange(10, dtype=np.uint8)
    syms = np.asarray(coded.encode_payload(payload, cfg)).copy()
    # each corrupted bit of one interleaved word lands in a different
    # codeword (1-bit each, all Hamming-corrected), so hit multiple
    # symbols hard enough to put >=2 errors into some codeword
    syms[:4] = [7, 99, 23, 85]
    out, crc_ok, _ = coded.decode_payload(syms, len(payload), cfg)
    assert not bool(np.all(np.asarray(crc_ok)))


def test_coded_over_the_air():
    """Coded chain through the physical modem (modulate/dechirp/demodulate)
    with AWGN — the full TX->RX stack."""
    cfg = CodedConfig(sf=8, cr=4)
    p = LoraParams(sf=8)
    payload = np.frombuffer(b"The quick brown fox!", dtype=np.uint8)
    syms = coded.encode_payload(payload, cfg)
    iq = modem.modulate(syms.astype(np.uint16), p)
    dech = modem.dechirp(iq, p)
    noisy = apply_awgn(jax.random.PRNGKey(7), dech, 15.0)
    res = modem.demodulate(noisy, p)
    out, crc_ok, _ = coded.decode_payload(np.asarray(res.symbols), len(payload), cfg)
    np.testing.assert_array_equal(np.asarray(out), payload)
    assert bool(np.all(np.asarray(crc_ok)))
    assert int(res.sync_word) == 0x12


def test_coded_batched():
    cfg = CodedConfig(sf=7, cr=2)
    payloads = np.stack([np.arange(7, dtype=np.uint8) + i for i in range(5)])
    syms = coded.encode_payload(payloads, cfg)
    out, crc_ok, _ = coded.decode_payload(syms, payloads.shape[-1], cfg)
    np.testing.assert_array_equal(np.asarray(out), payloads)
    assert bool(np.all(np.asarray(crc_ok)))


@pytest.mark.parametrize("sf", [7, 10, 12])
def test_explicit_header(sf):
    cfg = CodedConfig(sf=sf, cr=3, ldro=True, crc=True)
    hdr = coded.encode_header(42, cfg)
    assert hdr.shape[-1] == 8  # one PPM block at CR 4/8
    nbytes, cr, crc, ok = coded.decode_header(np.asarray(hdr), sf)
    assert ok
    assert (nbytes, cr, crc) == (42, 3, True)


def test_header_checksum_rejects_corruption():
    cfg = CodedConfig(sf=9, cr=1)
    hdr = np.asarray(coded.encode_header(17, cfg)).copy()
    hdr[0] ^= 0x1C  # multi-bit: beyond Hamming correction
    nbytes, _, _, ok = coded.decode_header(hdr, 9)
    assert (not ok) or nbytes == 17


def test_ldro_round_demap_tolerates_bin_drift():
    """LDRO's reason to exist: with bins at multiples of 4, a +/-1 bin
    drift (clock/CFO residue) must decode cleanly. The demap ROUNDS
    (matching gr-lora_sdr) — truncation would turn a -1 drift into a
    codeword bit error that CR 4/5-4/6 can only detect, not correct."""
    import numpy as np

    from lora_phy_tpu.models import coded

    cfg = coded.CodedConfig(sf=8, cr=1, ldro=True, crc=True)
    rng = np.random.RandomState(40)
    payload = rng.randint(0, 256, 6).astype(np.uint8)
    bins = np.asarray(coded.encode_payload(payload, cfg)).astype(np.int64)
    n = 1 << cfg.sf
    for drift in (-1, 1):
        got, crc_ok, fec = coded.decode_payload(
            ((bins + drift) % n).astype(np.uint16), payload.size, cfg)
        np.testing.assert_array_equal(np.asarray(got), payload)
        assert bool(np.all(np.asarray(crc_ok)))
        assert int(np.asarray(fec)) == 0
