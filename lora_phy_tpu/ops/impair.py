"""RF impairment injectors as pure JAX transforms.

The reference's fault-injection surface for the radio channel
(SURVEY.md §5.3): CFO rotation and sample-shift injection
(reference: runners/lora_phy_vector_generate.cpp:88-124 ``apply_offsets``)
and AWGN (reference: tests/awgn_sweep.py:262-268,
tests/awgn_sweep_gtest.cpp:76-80). All parameterisable per channel/batch
via broadcasting leading dims.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def apply_cfo(samples, cfo_bins, n: int, osr: int = 1):
    """Rotate by a CFO of ``cfo_bins`` FFT bins, phase wrapping per symbol
    period exactly like the reference's injector
    (lora_phy_vector_generate.cpp:101-107: ``ph = 2*pi*cfo*(n % N)/N``).

    ``cfo_bins`` may carry leading batch dims.
    """
    step = n * osr
    count = samples.shape[-1]
    idx = (jnp.arange(count, dtype=jnp.float32) % step)
    ph = (2.0 * math.pi / step) * jnp.asarray(cfo_bins, jnp.float32)[..., None] * idx
    return samples * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))


def apply_cfo_continuous(samples, cfo_bins, n: int, osr: int = 1):
    """Physically-continuous CFO rotation (no per-symbol phase reset):
    ``exp(j*2*pi*cfo_bins*t/(N*osr))`` over the global sample index."""
    step = n * osr
    count = samples.shape[-1]
    idx = jnp.arange(count, dtype=jnp.float32)
    ph = (2.0 * math.pi / step) * jnp.asarray(cfo_bins, jnp.float32)[..., None] * idx
    return samples * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))


def apply_time_shift(samples, shift: int):
    """Integer sample shift with zero fill, matching the reference injector
    (lora_phy_vector_generate.cpp:109-119: positive shift drops leading
    samples and pads the tail with zeros; negative prepends zeros)."""
    count = samples.shape[-1]
    idx = jnp.arange(count, dtype=jnp.int32) + jnp.asarray(shift, jnp.int32)
    valid = (idx >= 0) & (idx < count)
    gathered = jnp.take(samples, jnp.clip(idx, 0, count - 1), axis=-1)
    return jnp.where(valid, gathered, 0.0)


def apply_awgn(key, samples, snr_db):
    """Complex AWGN at the given SNR, matching the reference model's noise
    convention ``sigma = 10**(-snr/20)``, per-component ``sigma/sqrt(2)``
    (reference: tests/awgn_sweep.py:246, 262-268). ``snr_db`` may carry
    leading batch dims (per-channel SNR)."""
    sigma = 10.0 ** (-jnp.asarray(snr_db, jnp.float32) / 20.0)
    kr, ki = jax.random.split(key)
    shape = samples.shape
    noise = jax.lax.complex(
        jax.random.normal(kr, shape, jnp.float32),
        jax.random.normal(ki, shape, jnp.float32),
    ) * (sigma[..., None] / jnp.float32(math.sqrt(2.0)))
    return samples + noise


def apply_sro(samples, ppm: float):
    """Sample-rate offset (clock drift): resample at ``1 + ppm*1e-6``
    times the nominal rate via linear interpolation —
    ``y[k] = x(k*(1+delta))``. Models TX/RX crystal mismatch, which the
    reference has no injector for (its channel model is CFO + integer
    shift + AWGN only). Positive ppm -> receiver clock fast -> the frame
    appears compressed. Output length equals input length (tail zero
    where the source position runs past the end)."""
    count = samples.shape[-1]
    k = jnp.arange(count, dtype=jnp.int32)
    # pos = k*(1+d); computed as k + drift with only the small drift term
    # in floating point, so float32 stays exact for any realistic stream
    # length (drift <= count*|ppm|*1e-6 << 2**24).
    drift = k.astype(jnp.float32) * jnp.float32(float(ppm) * 1e-6)
    dwhole = jnp.floor(drift)
    frac = (drift - dwhole).astype(samples.dtype)
    i0 = k + dwhole.astype(jnp.int32)
    # Endpoint: when frac == 0 the sample needs no right neighbour, so
    # i0 == count-1 is still valid — otherwise ppm=0 would zero the last
    # sample and identity resampling would not be identity (ADVICE r2).
    valid = (i0 >= 0) & ((i0 + 1 < count) | ((frac == 0) & (i0 < count)))
    a = jnp.take(samples, jnp.clip(i0, 0, count - 1), axis=-1)
    b = jnp.take(samples, jnp.clip(i0 + 1, 0, count - 1), axis=-1)
    return jnp.where(valid, a * (1 - frac) + b * frac, 0.0)


def compensate_sro(samples, ppm: float):
    """Inverse of :func:`apply_sro`: resample at the reciprocal rate
    ``1/(1 + ppm*1e-6)`` (the exact inverse delta ``-d/(1+d)``, not the
    first-order ``-d``), undoing an estimated clock drift up to the
    injector's own linear-interpolation error."""
    d = float(ppm) * 1e-6
    return apply_sro(samples, -d / (1.0 + d) * 1e6)


def apply_multipath(samples, taps):
    """Frequency-selective multipath channel: ``y[t] = sum_k h[k] x[t-k]``
    with complex taps at integer sample delays (tap 0 = line of sight).
    The reference's channel model is CFO + integer shift + AWGN only; a
    real deployment sees echoes. Causal, output length = input length
    (leading edge sees zeros). ``taps``: 1-D complex array, kept small
    (an urban LoRa delay spread of a few us is a few samples at 125-500
    kHz rates) — implemented as a sum of shifted scaled copies, which
    XLA fuses into one pass for the tap counts this models."""
    taps = jnp.asarray(taps)
    out = taps[0] * samples
    for k in range(1, int(taps.shape[0])):
        shifted = jnp.pad(
            samples, [(0, 0)] * (samples.ndim - 1) + [(k, 0)]
        )[..., : samples.shape[-1]]
        out = out + taps[k] * shifted
    return out


def apply_multipath_planar(xr, xi, taps_re, taps_im):
    """Planar float32 twin of :func:`apply_multipath` (same math on
    (re, im) planes, no complex dtype)."""
    taps_re = jnp.asarray(taps_re, jnp.float32)
    taps_im = jnp.asarray(taps_im, jnp.float32)
    yr = taps_re[0] * xr - taps_im[0] * xi
    yi = taps_re[0] * xi + taps_im[0] * xr
    for k in range(1, int(taps_re.shape[0])):
        pad = [(0, 0)] * (xr.ndim - 1) + [(k, 0)]
        sr = jnp.pad(xr, pad)[..., : xr.shape[-1]]
        si = jnp.pad(xi, pad)[..., : xi.shape[-1]]
        yr = yr + taps_re[k] * sr - taps_im[k] * si
        yi = yi + taps_re[k] * si + taps_im[k] * sr
    return yr, yi


def apply_frontend(samples, dc=0.0, gain_imbalance: float = 1.0,
                   phase_skew_deg: float = 0.0):
    """Analog front-end defects of a real SDR: complex DC offset (LO
    leakage) and IQ imbalance (quadrature gain/phase mismatch):

        I' = I + re(dc)
        Q' = g * (Q * cos(phi) + I * sin(phi)) + im(dc)

    An imbalance makes the receiver see ``a*x + b*conj(x)`` — the image
    of every chirp leaks in mirrored — and the DC spur sits at the
    carrier. The reference models neither."""
    phi = math.radians(phase_skew_deg)
    i = jnp.real(samples)
    q = jnp.imag(samples)
    q2 = gain_imbalance * (q * math.cos(phi) + i * math.sin(phi))
    dc = complex(dc)
    return jax.lax.complex(i + dc.real, q2 + dc.imag)


def estimate_frontend_planar(xr, xi):
    """Blind front-end estimation from signal statistics
    (Moseley/Slump-style): a proper (circular) complex baseband signal
    has ``E[I] = E[Q] = 0``, ``E[I²] = E[Q²]`` and ``E[IQ] = 0``; chirps
    satisfy this over whole sweeps. Returns
    ``(dc_i, dc_q, gain, sin_phi)`` with the
    :func:`apply_frontend` parameterisation (I' = I, Q' = g*(Q cos +
    I sin)): ``sin_phi = E[I'Q']/(E[I'²] g cos)`` solved via
    ``theta = E[I'Q']/E[I'²]``, ``g² = E[Q'²]/E[I'²] `` decomposed."""
    dc_i = jnp.mean(xr, axis=-1, keepdims=True)
    dc_q = jnp.mean(xi, axis=-1, keepdims=True)
    i = xr - dc_i
    q = xi - dc_q
    eii = jnp.mean(i * i, axis=-1)
    eiq = jnp.mean(i * q, axis=-1)
    eqq = jnp.mean(q * q, axis=-1)
    # Q' = g(Q cos + I sin): E[I'Q'] = g sin E[I²]; E[Q'²] =
    # g²(cos² E[Q²] + sin² E[I²]) with E[Q²]=E[I²] -> g² = E[Q'²]/E[I²]
    g = jnp.sqrt(jnp.maximum(eqq / jnp.maximum(eii, 1e-30), 1e-12))
    sin_phi = eiq / jnp.maximum(eii * g, 1e-30)
    # (near-)silent input carries no statistics: return identity instead
    # of a degenerate g ~ 0 that would blow up the compensator
    quiet = eii < 1e-9
    g = jnp.where(quiet, 1.0, g)
    sin_phi = jnp.where(quiet, 0.0, jnp.clip(sin_phi, -0.999, 0.999))
    return (jnp.where(quiet, 0.0, dc_i[..., 0]),
            jnp.where(quiet, 0.0, dc_q[..., 0]), g, sin_phi)


def compensate_frontend_planar(xr, xi, dc_i, dc_q, g, sin_phi):
    """Invert :func:`apply_frontend` from
    :func:`estimate_frontend_planar`'s parameters:
    ``I = I' - dc_i``, ``Q = ((Q' - dc_q)/g - I sin)/cos``."""
    cos_phi = jnp.sqrt(1.0 - sin_phi * sin_phi)
    i = xr - dc_i[..., None]
    q = ((xi - dc_q[..., None]) / g[..., None]
         - i * sin_phi[..., None]) / cos_phi[..., None]
    return i, q


def rayleigh_taps(key, delays, pdp_db):
    """Random Rayleigh multipath taps on integer sample ``delays`` with a
    power-delay profile ``pdp_db`` (dB, same length), normalized to unit
    total power: the standard wide-sense-stationary uncorrelated-scatter
    draw (each tap CN(0, p_k)). Returns a dense complex tap vector of
    length ``max(delays)+1`` for :func:`apply_multipath`."""
    delays = tuple(int(d) for d in delays)
    p = 10.0 ** (jnp.asarray(pdp_db, jnp.float32) / 10.0)
    p = p / jnp.sum(p)
    kr, ki = jax.random.split(key)
    shape = (len(delays),)
    g = jax.lax.complex(
        jax.random.normal(kr, shape, jnp.float32),
        jax.random.normal(ki, shape, jnp.float32),
    ) * jnp.sqrt(p / 2.0)
    taps = jnp.zeros(max(delays) + 1, jnp.complex64)
    return taps.at[jnp.asarray(delays)].add(g)
