"""FFT-based symbol detection, batched.

Replaces the reference's per-symbol scalar scan loop
(reference: include/lora_phy/LoRaDetector.hpp:39-74) with one batched FFT
over a ``[..., symbols, N]`` tensor and vectorized argmax/metrics. The FFT
is XLA's own ``jnp.fft.fft`` (cuFFT on the GPU), standing in for the
reference's statically planned KISS FFT (include/lora_phy/kissfft.hh); it
returns the unnormalised DFT, matching kissfft's convention. This complex
path is the plain reference the planar pipeline (ops/planar.py) is tested
against.

Semantics preserved exactly:
* argmax over |X|^2 with first-maximum (lowest-index) tie-break —
  ``jnp.argmax`` returns the first occurrence, matching the reference's
  strict ``>`` scan (LoRaDetector.hpp:52-57, gated by
  tests/equal_power_bin_test.cpp);
* fundamental / noise power in dB with the ``20*log10(N)`` scale
  (LoRaDetector.hpp:29, 60-64);
* fractional-bin interpolation ``0.5*(right-left)/(2*peak-right-left)``
  with circular neighbours and a divide-by-zero guard
  (LoRaDetector.hpp:66-71).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Detection(NamedTuple):
    """Per-symbol detector outputs (leading dims = batch/symbol axes)."""

    index: jnp.ndarray       # argmax bin, int32
    power: jnp.ndarray       # fundamental power, dB
    power_avg: jnp.ndarray   # residual (noise) power, dB
    findex: jnp.ndarray      # fractional-bin offset
    peak_bin: jnp.ndarray    # complex FFT value at the peak
    spectrum: jnp.ndarray    # full FFT output [..., N]


def detect(fft_in) -> Detection:
    """Run the detector over the last axis of ``fft_in`` ([..., N] complex64)."""
    n = fft_in.shape[-1]
    spectrum = jnp.fft.fft(fft_in)
    return detect_from_spectrum(spectrum, n)


def detect_from_spectrum(spectrum, n: int) -> Detection:
    mag2 = jnp.square(spectrum.real) + jnp.square(spectrum.imag)
    index = jnp.argmax(mag2, axis=-1).astype(jnp.int32)
    max_value = jnp.take_along_axis(mag2, index[..., None].astype(jnp.int32), axis=-1)[..., 0]
    # The reference accumulates |X|^2 in double (LoRaDetector.hpp:45-52);
    # float32 keeps the device dtype — power metrics differ only in far
    # decimals and symbol decisions are unaffected (gated by golden tests).
    total = jnp.sum(mag2, axis=-1)

    noise = jnp.sqrt(jnp.maximum(total - max_value, 0.0).astype(jnp.float32))
    fundamental = jnp.sqrt(max_value)
    power_scale = 20.0 * jnp.log10(jnp.float32(n))
    power_avg = 20.0 * jnp.log10(noise) - power_scale
    power = 20.0 * jnp.log10(fundamental) - power_scale

    left_ix = jnp.where(index > 0, index - 1, n - 1)
    right_ix = jnp.where(index < n - 1, index + 1, 0)
    left = jnp.abs(jnp.take_along_axis(spectrum, left_ix[..., None], axis=-1)[..., 0])
    right = jnp.abs(jnp.take_along_axis(spectrum, right_ix[..., None], axis=-1)[..., 0])
    denom = 2.0 * fundamental - right - left
    findex = jnp.where(denom == 0.0, 0.0, 0.5 * (right - left) / denom)

    peak_bin = jnp.take_along_axis(spectrum, index[..., None], axis=-1)[..., 0]
    return Detection(index, power.astype(jnp.float32), power_avg.astype(jnp.float32),
                     findex.astype(jnp.float32), peak_bin, spectrum)
