"""High-level LoRa modem — pure functions over batched arrays.

Array-first re-design of the reference's workspace API
(reference: include/lora_phy/phy.hpp:102-156, src/phy/*.cpp). There is no
mutable workspace: every function is a pure map from arrays + static
``LoraParams`` to arrays, jit/vmap/pjit-friendly. The per-symbol FFT loop
becomes one batched FFT over a ``[..., symbols, N]`` reshape; tie-breaks,
rounding and dB conventions match the reference bit-for-bit at the symbol
level (SEMANTIC_COMPATIBILITY.md:6-14).

The two demodulation contracts of the reference are both provided:

* :func:`demodulate` — the *working* path: expects externally dechirped
  input, exactly like ``lora_demodulate`` (src/phy/LoRaDemod.cpp:49-195,
  verified contract per SURVEY.md §3.3).
* :func:`demodulate_integrated` — quirk-compatible port of the integrated
  ``demodulate()`` (src/phy/phy.cpp:178-239) that dechirps internally but
  estimates offsets on the raw sync chirps. The reference's defect (bogus
  CFO/TO on raw chirps, SURVEY.md §2.3 finding 2) is reproduced only when
  ``quirk_compat=True``; by default the offset estimate is run on the
  dechirped sync symbols, which makes the integrated path actually work.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import coding
from ..ops.chirp import base_downchirp, modulate_symbols
from ..ops.detect import detect
from ..utils.params import LoraParams, Window

_TWO_PI = 2.0 * math.pi


class DemodResult(NamedTuple):
    symbols: jnp.ndarray      # [..., S] demodulated data symbols (sync removed)
    sync_word: jnp.ndarray    # [...] recovered sync byte (uint8)
    cfo: jnp.ndarray          # [...] estimated carrier frequency offset
    time_offset: jnp.ndarray  # [...] estimated timing offset (samples)


class DecodeResult(NamedTuple):
    payload: jnp.ndarray      # [..., B] decoded bytes
    crc_ok: jnp.ndarray       # [...] bool, SX1272 CRC16 over payload[2:-2]


# ---------------------------------------------------------------------------
# Encode / decode (simple Hamming(8,4) chain of the reference)
# ---------------------------------------------------------------------------

def encode(payload):
    """Byte stream -> Hamming(8,4) codeword-symbols, two per byte
    (reference: src/phy/LoRaEncoder.cpp:6-18). [..., B] -> [..., 2B] uint16."""
    nibbles = coding.bytes_to_nibbles(payload)
    return coding.hamming84_encode(nibbles).astype(jnp.uint16)


def decode(symbols):
    """Symbol pairs -> bytes via Hamming(8,4) correction
    (reference: src/phy/LoRaDecoder.cpp:6-19). [..., 2B] -> [..., B] uint8."""
    n = symbols.shape[-1] - (symbols.shape[-1] % 2)
    nibbles, _, _ = coding.hamming84_decode(symbols[..., :n])
    return coding.nibbles_to_bytes(nibbles & 0x0F)


def decode_with_crc(symbols) -> DecodeResult:
    """Decode + SX1272 CRC16 verification over ``payload[2:-2]`` against the
    trailing little-endian CRC bytes (reference: src/phy/phy.cpp:241-256)."""
    payload = decode(symbols)
    nbytes = payload.shape[-1]
    if nbytes >= 4:
        data = payload[..., 2:-2]
        provided = payload[..., -2].astype(jnp.uint16) | (
            payload[..., -1].astype(jnp.uint16) << 8
        )
        calc = coding.crc16_sx1272(data)
        crc_ok = provided == calc
    else:
        crc_ok = jnp.zeros(payload.shape[:-1], dtype=bool)
    return DecodeResult(payload, crc_ok)


# ---------------------------------------------------------------------------
# Modulate
# ---------------------------------------------------------------------------

def modulate(symbols, params: LoraParams, amplitude: float = 1.0):
    """Symbols -> phase-continuous chirped IQ with the 2-symbol sync preamble
    (reference: src/phy/LoRaMod.cpp:8-43). [..., S] -> [..., (S+2)*step]."""
    return modulate_symbols(
        symbols, params.sf, params.osr, params.scale, amplitude,
        params.sync_word, params.continuous_chirp,
    )


def dechirp(iq, params: LoraParams):
    """External dechirp: multiply every symbol period by the base downchirp,
    the working-path contract (reference: tests/e2e_chain_test.cpp:80-93)."""
    down = base_downchirp(params.sf, params.scale, params.osr)
    nsym = iq.shape[-1] // params.step
    x = iq[..., : nsym * params.step].reshape(*iq.shape[:-1], nsym, params.step)
    return (x * down).reshape(*iq.shape[:-1], nsym * params.step)


# ---------------------------------------------------------------------------
# Window
# ---------------------------------------------------------------------------

def _window_table(params: LoraParams) -> np.ndarray | None:
    if params.window == Window.NONE:
        return None
    n = params.n
    i = np.arange(n, dtype=np.float32)
    # Hann per the reference (src/phy/LoRaDemod.cpp:17-22), float32
    return (0.5 - 0.5 * np.cos(2.0 * np.float32(math.pi) * i / np.float32(n - 1))).astype(
        np.float32
    )


# ---------------------------------------------------------------------------
# Shared estimation helpers
# ---------------------------------------------------------------------------

def _round_half_away(x):
    """std::round semantics (half away from zero) — jnp.round is half-even."""
    return jnp.where(x >= 0, jnp.floor(x + 0.5), jnp.ceil(x - 0.5))


def _wrap_pi(d):
    """The reference's while-loop phase wrap into [-pi, pi]
    (src/phy/LoRaDemod.cpp:116-118); inputs are within +-2pi."""
    d = jnp.where(d > math.pi, d - _TWO_PI, d)
    return jnp.where(d < -math.pi, d + _TWO_PI, d)


def _osr_phase_view(x, n: int, osr: int):
    """[..., S*step] -> [..., S, osr, N] where [..., s, t, i] = x[s*step + t + i*osr]."""
    s = x.shape[-1] // (n * osr)
    v = x[..., : s * n * osr].reshape(*x.shape[:-1], s, n, osr)
    return jnp.swapaxes(v, -1, -2)


def _estimate(x, n: int, osr: int, window, tie_break_idx: bool):
    """Per-frame CFO/TO estimation over the symbols contained in ``x``.

    Implements both estimator variants:
    * ``tie_break_idx=True``  — ``lora_demodulate``'s deterministic
      lowest-index tie-break (src/phy/LoRaDemod.cpp:101-105);
    * ``tie_break_idx=False`` — ``estimate_offsets``'s plain ``p > best``
      scan (src/phy/phy.cpp:113).

    Returns ``(cfo, time_offset)`` float32 with leading batch dims.
    """
    view = _osr_phase_view(x, n, osr)                     # [..., S, osr, N]
    if window is not None:
        view = view * jnp.asarray(window)
    det = detect(view)                                    # fields [..., S, osr]
    p, idx = det.power, det.index

    maxp = jnp.max(p, axis=-1, keepdims=True)
    cand = p == maxp
    if tie_break_idx:
        idx_masked = jnp.where(cand, idx, jnp.iinfo(jnp.int32).max)
        min_idx = jnp.min(idx_masked, axis=-1, keepdims=True)
        cand = cand & (idx_masked == min_idx)
    best_t = jnp.argmax(cand, axis=-1)                    # first winning osr phase

    def pick(field):
        return jnp.take_along_axis(field, best_t[..., None], axis=-1)[..., 0]

    best_idx = pick(idx)
    best_fi = pick(det.findex)
    best_bin = pick(det.peak_bin)

    nsym = view.shape[-3]
    sum_index = jnp.sum(best_idx.astype(jnp.float32) + best_fi, axis=-1)
    avg_index = sum_index / jnp.float32(nsym)
    cfo_coarse = avg_index / jnp.float32(n)

    phase = jnp.arctan2(jnp.imag(best_bin), jnp.real(best_bin)).astype(jnp.float32)
    if nsym > 1:
        diffs = _wrap_pi(phase[..., 1:] - phase[..., :-1])
        cfo_fine = (jnp.sum(diffs, axis=-1) / jnp.float32(nsym - 1)) / (
            jnp.float32(_TWO_PI) * jnp.float32(n)
        )
    else:
        cfo_fine = jnp.zeros_like(cfo_coarse)
    cfo = cfo_coarse + cfo_fine

    frac = avg_index - jnp.floor(avg_index + 0.5)
    avg_t = jnp.sum(best_t, axis=-1).astype(jnp.float32) / jnp.float32(nsym)
    time_offset = avg_t - frac * jnp.float32(n) * jnp.float32(osr)
    return cfo.astype(jnp.float32), time_offset.astype(jnp.float32)


def _shifted_rows(x, t_off, step: int):
    """Whole-row timing shift: ``y[..., j] = x[..., j + t_off]`` with zero
    fill, as a padded per-row ``dynamic_slice``.

    A vmapped per-row ``dynamic_slice`` lowers to a row gather; an
    element-wise ``take_along_axis`` would lower to a scalar gather. A
    log2(2*step) barrel shifter (static slice + ``where`` per bit of
    ``t_off``) is the other row-count-independent form; it is not used
    because callers wrap this in the zero-offset ``lax.cond`` fast path
    and a cond branch's temporaries are reserved whether or not the
    branch runs (the barrel holds 9 full-size where-stage buffers, the
    dynamic slice one padded temp). Which form is fastest on the GPU is
    not measured (ROADMAP A6).
    """
    count = x.shape[-1]
    pad_width = [(0, 0)] * (x.ndim - 1) + [(step, step)]
    padded = jnp.pad(x, pad_width)
    start = (jnp.asarray(t_off, jnp.int32) + step).reshape(-1)
    flat = padded.reshape(-1, padded.shape[-1])
    if flat.shape[0] == 1:
        y = jax.lax.dynamic_slice(flat[0], (start[0],), (count,))[None]
    else:
        y = jax.vmap(
            lambda row, st: jax.lax.dynamic_slice(row, (st,), (count,))
        )(flat, jnp.broadcast_to(start, (flat.shape[0],)))
    return y.reshape(x.shape)


def _shifted_symbol_gather(x, total_symbols: int, n: int, osr: int, t_off,
                           dec_phase: int = 0):
    """[..., S, N] decimated symbol windows with the reference's guarded
    per-symbol timing-offset shift (src/phy/LoRaDemod.cpp:141-149):
    a symbol uses the shifted window only when the shift stays in range,
    otherwise the unshifted one.

    ``t_off`` is an int32 with the batch's leading dims. When every frame
    in the batch has a zero offset (the common steady-state case) the
    whole-row shift copy is skipped via ``lax.cond``.

    ``dec_phase`` (static): which of the ``osr`` decimation phases to
    keep. The reference's one-sample-early TX fold puts the exact
    dechirped tone at phase ``osr-1`` (docs/SEMANTICS.md §TX fold;
    phase 0 splits it into half-power twin peaks at ``sym±1``) —
    receivers that INJECT a known time offset instead of estimating it
    (the reference's estimator absorbs the skew into ``t_off``) must
    select it explicitly. Default 0 = the reference-mirroring contract.
    """
    step = n * osr
    sample_count = total_symbols * step
    x = x[..., :sample_count]

    def symview(a):
        v = a.reshape(*a.shape[:-1], total_symbols, n, osr)
        return v[..., dec_phase]                           # decimate i*osr+p

    def no_shift(x):
        return symview(x)

    def with_shift(x):
        shifted = _shifted_rows(x, t_off, step)
        base = jnp.arange(total_symbols, dtype=jnp.int32) * step
        t = t_off[..., None].astype(jnp.int32)             # [..., 1]
        use_shift = ((t > 0) & (base + t + step <= sample_count)) | (
            (t < 0) & (-t <= base)
        )                                                  # [..., S]
        return jnp.where(use_shift[..., None], symview(shifted), symview(x))

    return jax.lax.cond(jnp.all(t_off == 0), no_shift, with_shift, x)


def _derotation_vector(rate, n: int):
    """Per-sample CFO derotation factor ``exp(j*rate*i)`` as a [..., N]
    vector, broadcast over the symbol axis by the caller.

    The reference's full phase is ``rate*(s*N + t_off/osr) + rate*i``
    (src/phy/LoRaDemod.cpp:151-152).  The ``s*N`` and ``t_off/osr`` terms
    are constant within a symbol, so they contribute only a unimodular
    per-symbol phase to the FFT output — |X|^2, argmax, fIndex and the
    power metrics are all invariant to them (the detector consumes only
    magnitudes).  Dropping them cuts the rotation operand from [..., S, N]
    to [..., N] and the transcendental count from S*N to N; symbol/byte
    parity is gated by the golden matrix.  Mirrors the planar twin
    (ops.planar._rotated_windows_planar)."""
    phi = rate[..., None] * jnp.arange(n, dtype=jnp.float32)       # [..., N]
    return jax.lax.complex(jnp.cos(phi), jnp.sin(phi))


def _sync_from_symbols(idx0, idx1, sf: int):
    """Recover the two-nibble sync byte (src/phy/LoRaDemod.cpp:177-192)."""
    shift = (sf - 4) if sf > 4 else 0
    hi = (idx0 >> shift) & 0x0F
    lo = (idx1 >> shift) & 0x0F
    return ((hi << 4) | lo).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Demodulate (working, dechirped-input path)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("params",))
def demodulate(samples, params: LoraParams, known_offsets=None) -> DemodResult:
    """Demodulate already-dechirped samples — the reference's working
    contract (``lora_demodulate``, src/phy/LoRaDemod.cpp:49-195).

    ``samples``: [..., S_total*step] complex64 (S_total >= 2; first two
    symbols are the sync word). Returns data symbols [..., S_total-2],
    the recovered sync byte, and CFO/TO estimates.

    ``known_offsets=(cfo, time_offset)`` bypasses the inline 2-symbol
    estimator with externally measured values (the streaming receiver's
    preamble-anchored estimate — see ops.planar.estimate_preamble_planar
    for why the sync-pair estimator is biased for large sync words).
    """
    n, osr, step = params.n, params.osr, params.step
    total_symbols = samples.shape[-1] // step
    if total_symbols < 2:
        raise ValueError("need at least the 2 sync symbols")
    x = samples[..., : total_symbols * step]

    # Amplitude normalisation into [-1, 1] (src/phy/LoRaDemod.cpp:59-77)
    max_amp = jnp.max(
        jnp.maximum(jnp.abs(jnp.real(x)), jnp.abs(jnp.imag(x))), axis=-1
    )
    scale = jnp.where(max_amp > 1.0, 1.0 / max_amp, 1.0).astype(jnp.float32)
    x = x * scale[..., None]

    window = _window_table(params)

    # Two-symbol CFO/TO estimation with deterministic tie-break
    if known_offsets is None:
        cfo, time_offset = _estimate(
            x[..., : 2 * step], n, osr, window, tie_break_idx=True)
    else:
        batch = x.shape[:-1]
        cfo = jnp.broadcast_to(jnp.asarray(known_offsets[0], jnp.float32), batch)
        time_offset = jnp.broadcast_to(
            jnp.asarray(known_offsets[1], jnp.float32), batch)

    t_off = _round_half_away(time_offset).astype(jnp.int32)
    rate = (-jnp.float32(_TWO_PI) * cfo / jnp.float32(n)).astype(jnp.float32)

    sym = _shifted_symbol_gather(x, total_symbols, n, osr, t_off)  # [..., S, N]

    rot = _derotation_vector(rate, n)
    if window is not None:
        rot = rot * jnp.asarray(window)       # fold window into the [N] vector
    fft_in = sym * rot[..., None, :]

    det = detect(fft_in)
    syms = det.index.astype(jnp.uint16)                            # [..., S]
    sync = _sync_from_symbols(
        syms[..., 0].astype(jnp.int32), syms[..., 1].astype(jnp.int32), params.sf
    )
    return DemodResult(syms[..., 2:], sync, cfo, time_offset)


# ---------------------------------------------------------------------------
# estimate / compensate (public API parity with phy.cpp)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("params",))
def estimate_offsets(samples, params: LoraParams):
    """CFO/TO estimation over whole symbols (reference: src/phy/phy.cpp:78-145;
    note this variant has no argmax-index tie-break across osr phases)."""
    window = _window_table(params)
    return _estimate(samples, params.n, params.osr, window,
                     tie_break_idx=False)


@partial(jax.jit, static_argnames=("params",))
def compensate_offsets(samples, params: LoraParams, cfo, time_offset):
    """Derotate by the estimated CFO and shift by the integer timing offset
    with zero fill (reference: src/phy/phy.cpp:147-176)."""
    n, osr = params.n, params.osr
    count = samples.shape[-1]
    rate = -jnp.float32(_TWO_PI) * jnp.asarray(cfo, jnp.float32) / (
        jnp.float32(n) * jnp.float32(osr)
    )
    ph = rate[..., None] * jnp.arange(count, dtype=jnp.float32)
    out = samples * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))

    offset = _round_half_away(jnp.asarray(time_offset, jnp.float32)).astype(jnp.int32)
    idx = jnp.arange(count, dtype=jnp.int32)
    src = jnp.broadcast_to(idx - offset[..., None], out.shape)
    valid = (src >= 0) & (src < count)
    # only shift when |offset| < count, as the reference guards
    do_shift = (jnp.abs(offset) < count)[..., None]
    gathered = jnp.take_along_axis(out, jnp.clip(src, 0, count - 1), axis=-1)
    shifted = jnp.where(valid, gathered, 0.0)
    return jnp.where(do_shift, shifted, out)


@partial(jax.jit, static_argnames=("params",))
def estimate_sro(samples, params: LoraParams):
    """Sample-rate-offset (clock-drift) estimate in ppm from DECHIRPED
    symbol windows — complex wrapper over
    :func:`ops.planar.estimate_sro_planar` (see there for the method).
    No reference counterpart; pairs with ``ops.impair.apply_sro`` /
    ``compensate_sro`` to close the crystal-mismatch loop."""
    from ..ops.planar import estimate_sro_planar

    return estimate_sro_planar(
        jnp.real(samples).astype(jnp.float32),
        jnp.imag(samples).astype(jnp.float32), params)


# ---------------------------------------------------------------------------
# Integrated demodulator (quirk-compat port of phy.cpp demodulate)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("params", "quirk_compat"))
def demodulate_integrated(
    iq, params: LoraParams, quirk_compat: bool = False
) -> DemodResult:
    """Integrated demodulation of raw chirped IQ
    (reference: src/phy/phy.cpp:178-239): per-symbol dechirp with the base
    downchirp, CFO derotation, FFT argmax, sync extraction.

    ``quirk_compat=True`` reproduces the reference defect of estimating
    CFO/TO on the *raw* (non-dechirped) sync chirps (phy.cpp:192-193),
    which corrupts the decisions (SURVEY.md §2.3 finding 2). The default
    estimates on dechirped sync symbols so the integrated path round-trips.
    """
    n, osr, step = params.n, params.osr, params.step
    total_symbols = iq.shape[-1] // step
    if total_symbols < 2:
        raise ValueError("need at least the 2 sync symbols")
    x = iq[..., : total_symbols * step]
    window = _window_table(params)

    down = base_downchirp(params.sf, params.scale)         # [N], osr=1 per phy.cpp:203

    est_input = x[..., : 2 * step]
    if not quirk_compat:
        # the estimator sees the PROPER oversampled downchirp: a sample-
        # repeated osr=1 chirp is misaligned by half a bin at osr > 1,
        # which lands the sync estimate on the wrong fractional bin and
        # fabricates a time_offset of frac*N*osr samples (measured: every
        # symbol wrong at sf8/osr2 with jnp.repeat(down, osr))
        down_os = base_downchirp(params.sf, params.scale, osr)
        est_input = est_input.reshape(*x.shape[:-1], 2, step) * down_os
        est_input = est_input.reshape(*x.shape[:-1], 2 * step)
    cfo, time_offset = _estimate(
        est_input, n, osr, window, tie_break_idx=False
    )

    t_off = _round_half_away(time_offset).astype(jnp.int32)
    rate = (-jnp.float32(_TWO_PI) * cfo / jnp.float32(n)).astype(jnp.float32)

    sym = _shifted_symbol_gather(x, total_symbols, n, osr, t_off)  # [..., S, N]
    sym = sym * down                                                # dechirp (phy.cpp:221)

    rot = _derotation_vector(rate, n)
    if window is not None:
        rot = rot * jnp.asarray(window)       # fold window into the [N] vector
    fft_in = sym * rot[..., None, :]

    det = detect(fft_in)
    syms = det.index.astype(jnp.uint16)
    sync = _sync_from_symbols(
        syms[..., 0].astype(jnp.int32), syms[..., 1].astype(jnp.int32), params.sf
    )
    return DemodResult(syms[..., 2:], sync, cfo, time_offset)
