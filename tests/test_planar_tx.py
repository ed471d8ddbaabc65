"""Planar (complex-free) TX path: the modulator emits (re, im) float32
planes bit-identical to the complex emitter, and the full TX -> dechirp ->
demod -> decode loop closes without touching complex64 anywhere — the
deployment contract of the planar (split re/im float32) path.

Reference TX chain under parity: src/phy/LoRaMod.cpp:8-43 (lora_modulate),
include/lora_phy/ChirpGenerator.hpp:23-50 (genChirp hot loop).
"""

import numpy as np
import pytest

from lora_phy_tpu.models import modem
from lora_phy_tpu.ops import planar
from lora_phy_tpu.ops.chirp import modulate_symbols, modulate_symbols_planar
from lora_phy_tpu.utils.params import Bandwidth, LoraParams


@pytest.mark.parametrize(
    "sf,osr,bw",
    [(7, 1, Bandwidth.BW_125), (7, 2, Bandwidth.BW_250),
     (9, 1, Bandwidth.BW_125), (10, 4, Bandwidth.BW_500),
     (12, 1, Bandwidth.BW_125)],
)
def test_planar_tx_bit_exact_vs_complex(sf, osr, bw):
    p = LoraParams(sf=sf, osr=osr, bw=bw)
    rng = np.random.RandomState(3)
    syms = rng.randint(0, p.n, (2, 11)).astype(np.uint16)
    iq = np.asarray(modulate_symbols(syms, sf, osr, p.scale, 0.75, 0x12))
    re, im = modulate_symbols_planar(syms, sf, osr, p.scale, 0.75, 0x12)
    np.testing.assert_array_equal(np.asarray(re), iq.real)
    np.testing.assert_array_equal(np.asarray(im), iq.imag)


def test_planar_tx_batched_shapes():
    p = LoraParams(sf=8)
    syms = np.zeros((3, 2, 5), np.uint16)
    re, im = planar.modulate_planar(syms, p)
    assert re.shape == im.shape == (3, 2, 7 * p.step)


@pytest.mark.parametrize("sf,osr", [(7, 1), (8, 2), (11, 1)])
def test_planar_loopback_complex_free(sf, osr):
    """encode -> modulate_planar -> dechirp_planar -> demodulate_planar ->
    decode, no complex dtype anywhere in the pipeline."""
    p = LoraParams(sf=sf, osr=osr)
    rng = np.random.RandomState(11)
    payload = rng.randint(0, 256, 16).astype(np.uint8)
    syms = modem.encode(payload)
    re, im = planar.modulate_planar(syms, p)
    assert np.asarray(re).dtype == np.float32
    dr, di = planar.dechirp_planar(re, im, p)
    res = planar.demodulate_planar(dr, di, p)
    out = np.asarray(modem.decode(np.asarray(res.symbols)))
    np.testing.assert_array_equal(out, payload)
    assert int(np.asarray(res.sync_word)) == p.sync_word


def test_planar_dechirp_matches_complex():
    p = LoraParams(sf=9, osr=2)
    rng = np.random.RandomState(5)
    payload = rng.randint(0, 256, 8).astype(np.uint8)
    iq = np.asarray(modem.modulate(modem.encode(payload), p))
    dech = np.asarray(modem.dechirp(iq, p))
    re, im = planar.split_complex(iq)
    dr, di = planar.dechirp_planar(re, im, p)
    # 1-ulp envelope: XLA's complex64 multiply may reassociate the product;
    # symbol-level parity stays bit-exact (test_planar_loopback_complex_free)
    np.testing.assert_allclose(np.asarray(dr), dech.real, atol=1.3e-7)
    np.testing.assert_allclose(np.asarray(di), dech.imag, atol=1.3e-7)


def test_estimate_offsets_planar_matches_complex():
    p = LoraParams(sf=7)
    rng = np.random.RandomState(7)
    payload = rng.randint(0, 256, 12).astype(np.uint8)
    dech = np.asarray(modem.dechirp(modem.modulate(modem.encode(payload), p), p))
    dech = dech + (0.01 * rng.randn(*dech.shape)
                   + 0.01j * rng.randn(*dech.shape)).astype(np.complex64)
    cfo_c, to_c = modem.estimate_offsets(dech, p)
    re, im = planar.split_complex(dech)
    cfo_p, to_p = planar.estimate_offsets_planar(re, im, p)
    np.testing.assert_allclose(float(cfo_p), float(cfo_c), atol=1e-6)
    np.testing.assert_allclose(float(to_p), float(to_c), atol=1e-5)


@pytest.mark.parametrize("cfo,to", [(0.02, 0.0), (-0.013, 37.0), (0.0, -20.0)])
def test_compensate_offsets_planar_matches_complex(cfo, to):
    p = LoraParams(sf=7)
    rng = np.random.RandomState(9)
    x = (rng.randn(2, 4 * p.step) + 1j * rng.randn(2, 4 * p.step)).astype(
        np.complex64
    )
    ref = np.asarray(modem.compensate_offsets(x, p, np.float32(cfo),
                                              np.float32(to)))
    re, im = planar.split_complex(x)
    yr, yi = planar.compensate_offsets_planar(re, im, p, np.float32(cfo),
                                              np.float32(to))
    np.testing.assert_allclose(np.asarray(yr), ref.real, atol=2e-6)
    np.testing.assert_allclose(np.asarray(yi), ref.imag, atol=2e-6)


def test_compensate_offsets_planar_overrange_is_noop_shift():
    """|offset| >= count: the reference skips the shift (derotation only)."""
    p = LoraParams(sf=7)
    rng = np.random.RandomState(13)
    x = (rng.randn(3 * p.step) + 1j * rng.randn(3 * p.step)).astype(np.complex64)
    count = x.shape[-1]
    ref = np.asarray(modem.compensate_offsets(x, p, np.float32(0.0),
                                              np.float32(count + 5)))
    re, im = planar.split_complex(x)
    yr, yi = planar.compensate_offsets_planar(re, im, p, np.float32(0.0),
                                              np.float32(count + 5))
    np.testing.assert_allclose(np.asarray(yr), ref.real, atol=2e-6)
    np.testing.assert_allclose(np.asarray(yi), ref.imag, atol=2e-6)


import jax.numpy as jnp


def test_table_emitter_matches_lattice_trig():
    """The pure-gather TX table (ops.chirp._mod_chirp_tables) reproduces
    the closed-form lattice trig emitter at float32 ULP level for every
    symbol value of the ALIASED range [0, 2N) — including the 8-bit
    Hamming84 symbols that exceed N at SF7 by design — at several
    (osr, scale, continuous) cells."""
    from lora_phy_tpu.ops import chirp

    for (n, osr, bw8, cont) in [(128, 1, 8, False), (128, 1, 8, True),
                                (128, 2, 8, False), (256, 2, 4, False)]:
        syms = np.arange(2 * n, dtype=np.int32).reshape(2, -1)
        tabs = chirp._mod_chirp_tables(n, osr, bw8, cont)
        assert tabs is not None
        ph = np.asarray(chirp._chirp_phase(jnp.asarray(syms), n, osr, bw8,
                                           cont))
        re, im = chirp._mod_chirps_planar(jnp.asarray(syms), n, osr, bw8,
                                          1.0, cont)
        np.testing.assert_allclose(np.asarray(re), np.cos(ph), atol=2e-6)
        np.testing.assert_allclose(np.asarray(im), np.sin(ph), atol=2e-6)


def test_phase_carry_off_restarts_every_symbol_at_phase_zero():
    """phase_carry=False (the gr-lora_sdr per-symbol-independent
    convention): every slot emits the SAME waveform for the same symbol
    value — no cross-symbol continuity term — and the first sample of a
    value-0 chirp is phase 0."""
    from lora_phy_tpu.ops import chirp

    n, osr, bw8 = 128, 1, 8
    syms = np.tile(np.array([5, 5, 5, 5], np.int32), (1, 1))
    re, im = chirp._mod_chirps_planar(jnp.asarray(syms), n, osr, bw8, 1.0,
                                      False, False)
    re, im = np.asarray(re)[0], np.asarray(im)[0]
    for s in range(1, 4):
        np.testing.assert_array_equal(re[s], re[0])
        np.testing.assert_array_equal(im[s], im[0])
    # carry ON: slots differ by the lattice constant (pi at scale 1)
    re2, im2 = chirp._mod_chirps_planar(jnp.asarray(syms), n, osr, bw8, 1.0,
                                        False, True)
    assert not np.array_equal(np.asarray(re2)[0, 1], np.asarray(re2)[0, 0])
