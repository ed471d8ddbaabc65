"""Planar (split re/im) deployment pipeline == complex reference path.

The deployment path runs planar float32 with its matmuls at
``Precision.HIGHEST``; these tests gate its equality with the complex
``jnp.fft`` modem across the profile matrix.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lora_phy_tpu.models import modem
from lora_phy_tpu.ops import planar
from lora_phy_tpu.utils.params import LoraParams, Window


def _case(p, payload_len=32, batch=None, seed=0):
    rng = np.random.RandomState(seed)
    shape = (batch, payload_len) if batch else (payload_len,)
    payloads = rng.randint(0, 256, shape).astype(np.uint8)
    syms = modem.encode(payloads)
    iq = modem.modulate(syms, p)
    dech = np.asarray(modem.dechirp(iq, p))
    return payloads, dech


@pytest.mark.parametrize("sf", [7, 9, 12])
def test_planar_matches_complex(sf):
    p = LoraParams(sf=sf)
    payloads, dech = _case(p)
    ref = modem.demodulate(dech, p)
    xr, xi = planar.split_complex(dech)
    res = planar.demodulate_planar(xr, xi, p)
    np.testing.assert_array_equal(np.asarray(res.symbols), np.asarray(ref.symbols))
    assert int(res.sync_word) == int(ref.sync_word)
    np.testing.assert_allclose(float(res.cfo), float(ref.cfo), atol=1e-5)
    np.testing.assert_allclose(
        float(res.time_offset), float(ref.time_offset), atol=0.5 + 2e-4 * p.step
    )


@pytest.mark.parametrize("osr", [2, 4])
def test_planar_oversampled(osr):
    p = LoraParams(sf=7, osr=osr)
    payloads, dech = _case(p, payload_len=16)
    ref = modem.demodulate(dech, p)
    xr, xi = planar.split_complex(dech)
    res = planar.demodulate_planar(xr, xi, p)
    np.testing.assert_array_equal(np.asarray(res.symbols), np.asarray(ref.symbols))
    assert int(res.sync_word) == int(ref.sync_word)


def test_planar_windowed():
    p = LoraParams(sf=8, window=Window.HANN)
    payloads, dech = _case(p, payload_len=16)
    ref = modem.demodulate(dech, p)
    xr, xi = planar.split_complex(dech)
    res = planar.demodulate_planar(xr, xi, p)
    np.testing.assert_array_equal(np.asarray(res.symbols), np.asarray(ref.symbols))


def test_planar_batched_decodes():
    p = LoraParams(sf=7)
    payloads, dech = _case(p, payload_len=24, batch=6)
    xr, xi = planar.split_complex(dech)
    res = planar.demodulate_planar(xr, xi, p)
    out = np.asarray(modem.decode(np.asarray(res.symbols)))
    np.testing.assert_array_equal(out, payloads)
    np.testing.assert_array_equal(np.asarray(res.sync_word), [0x12] * 6)


def test_planar_normalisation():
    p = LoraParams(sf=7)
    payloads, dech = _case(p, payload_len=8)
    xr, xi = planar.split_complex(dech * 4.0)
    res = planar.demodulate_planar(xr, xi, p)
    out = np.asarray(modem.decode(np.asarray(res.symbols)))
    np.testing.assert_array_equal(out, payloads)


@pytest.mark.parametrize("n", [64, 128, 512, 4096])
def test_dft_planar_matches_numpy(n):
    rng = np.random.RandomState(1)
    x = (rng.randn(5, n) + 1j * rng.randn(5, n)).astype(np.complex64)
    yr, yi = planar.dft_planar(
        np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag), n
    )
    ref = np.fft.fft(x)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    np.testing.assert_allclose(got, ref, atol=2e-2 * np.sqrt(n))


def test_planar_knobs_equivalent():
    """assume_normalized and bf16 precision keep symbol decisions exact on
    clean loopback (bf16 accuracy is opt-in; gated here at high SNR)."""
    p = LoraParams(sf=7)
    payloads, dech = _case(p, payload_len=16)
    xr, xi = planar.split_complex(dech)
    ref = planar.demodulate_planar(xr, xi, p)
    fast = planar.demodulate_planar(xr, xi, p, assume_normalized=True,
                                    precision="bf16")
    np.testing.assert_array_equal(np.asarray(fast.symbols), np.asarray(ref.symbols))
    assert int(fast.sync_word) == int(ref.sync_word)


def test_planar_noise_power_observable():
    """power/power_avg mirror the complex detector's SNR observables."""
    from lora_phy_tpu.ops.detect import detect as detect_c

    rng = np.random.RandomState(0)
    x = (rng.randn(4, 128) + 1j * rng.randn(4, 128)).astype(np.complex64)
    ref = detect_c(x)
    got = planar.detect_planar(
        np.ascontiguousarray(x.real), np.ascontiguousarray(x.imag), 128
    )
    np.testing.assert_allclose(np.asarray(got.power), np.asarray(ref.power),
                               atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.power_avg),
                               np.asarray(ref.power_avg), atol=1e-3)


@pytest.mark.parametrize("sf", [8, 9, 10, 11, 12])
def test_argmax_natural_tie_break_scrambled(sf):
    """Equal-power bins resolve to the LOWEST NATURAL index at n > 128
    (reference contract tests/equal_power_bin_test.cpp:31-55), even though
    the four-step argmax scans the scrambled [k2, k1] layout. Crafted flat
    positions j=1 (natural bin n2) and j=n1 (natural bin 1) tie: a
    scrambled-order first-max returns n2; the contract requires 1."""
    from lora_phy_tpu.ops.planar import _argmax_natural, _dft_mats

    n = 1 << sf
    _, _, _, n1, n2 = _dft_mats(n)
    flat = np.zeros((3, n), np.float32)
    flat[:, 1] = 5.0       # scrambled-first, natural bin n2
    flat[:, n1] = 5.0      # scrambled-later, natural bin 1
    flat[0, 0] = 7.0       # unique max at natural bin 0
    bins, peak = _argmax_natural(jnp.asarray(flat), n1, n2)
    bins = np.asarray(bins)
    assert bins[0] == 0 and np.all(np.asarray(peak) == [7.0, 5.0, 5.0])
    assert bins[1] == 1 and bins[2] == 1, bins

    # brute-force oracle on random data with injected ties
    rng = np.random.RandomState(sf)
    m = rng.rand(64, n).astype(np.float32)
    ties = rng.randint(0, n, (64, 2))
    m[np.arange(64), ties[:, 0]] = 2.0
    m[np.arange(64), ties[:, 1]] = 2.0
    j = np.arange(n)
    nat = (j % n1) * n2 + (j // n1)
    order = np.argsort(nat, kind="stable")
    want = nat[order[np.argmax(m[:, order], axis=-1)]]
    got, _ = _argmax_natural(jnp.asarray(m), n1, n2)
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("sf", [8, 10, 12])
def test_argmax_bins_planar_matches_natural(sf):
    """Full fused path: argmax_bins_planar == natural-order argmax of the
    reordered spectrum on random signals (unscramble correctness)."""
    n = 1 << sf
    rng = np.random.RandomState(1)
    xr = rng.randn(8, n).astype(np.float32)
    xi = rng.randn(8, n).astype(np.float32)
    mag2 = np.asarray(planar.dft_mag2_planar(xr, xi, n))
    want = np.argmax(mag2, axis=-1)
    got = np.asarray(planar.argmax_bins_planar(xr, xi, n))
    np.testing.assert_array_equal(got, want)
