"""Planar-complex (split re/im float32) demodulation pipeline — the
deployment path.

This module mirrors :mod:`..models.modem`'s working demodulation contract
exactly (same estimator, tie-breaks, rounding — see
src/phy/LoRaDemod.cpp:49-195) but computes everything on (re, im) float32
pairs, with the DFT as real matmuls (one combined [2N, 2N] product for
N <= 128, the four-step factorisation above). Every matmul runs at
``Precision.HIGHEST`` (:func:`_mm`): a float32 product on a GPU may
otherwise run in TF32, which keeps about three decimal digits and moves
near-tie decisions away from the complex reference.

Equality with the complex path (the plain ``jnp.fft`` reference) is gated
by tests/test_planar.py.
"""

from __future__ import annotations

import functools
import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.params import LoraParams
from ..models.modem import _round_half_away, _window_table

_TWO_PI = 2.0 * math.pi


class PlanarDemodResult(NamedTuple):
    symbols: jnp.ndarray
    sync_word: jnp.ndarray
    cfo: jnp.ndarray
    time_offset: jnp.ndarray


def _mm(a, b, dot_dtype=None):
    """f32-accumulating matmul: full float32 precision by default, or
    ``dot_dtype`` (bf16) operands at the backend's default precision."""
    if dot_dtype is not None:
        return jnp.matmul(a.astype(dot_dtype), b.astype(dot_dtype),
                          preferred_element_type=jnp.float32)
    return jnp.matmul(a, b, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)


def _split(n: int) -> tuple[int, int]:
    """Factor N = n1*n2 with both factors <= 128 and as square as possible."""
    n1 = 1 << ((n.bit_length() - 1) // 2)
    n2 = n // n1
    while n2 > 128:
        n1 *= 2
        n2 //= 2
    return n1, n2


@functools.lru_cache(maxsize=16)
def _dft_mats(n: int):
    """(W1 [n1,n1], W2 [n2,n2], twiddle [n1,n2], n1, n2) of the four-step
    DFT, N = n1*n2, as complex64 NumPy constants.

    NumPy (not jnp) on purpose: the cache must never capture arrays created
    under a jit trace (tracer leak); conversion happens at the use site.
    """
    n1, n2 = _split(n)
    k1 = np.arange(n1)
    k2 = np.arange(n2)
    w1 = np.exp(-2j * np.pi * np.outer(k1, k1) / n1).astype(np.complex64)
    w2 = np.exp(-2j * np.pi * np.outer(k2, k2) / n2).astype(np.complex64)
    tw = np.exp(-2j * np.pi * np.outer(k1, k2) / n).astype(np.complex64)
    return w1, w2, tw, n1, n2


@functools.lru_cache(maxsize=16)
def _small_dft_tables(n: int):
    k = np.arange(n)
    ang = 2 * np.pi * np.outer(k, k) / n
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


def dft_planar(xr, xi, n: int, dot_dtype=None):
    """Planar DFT over the last axis: four real matmuls (N <= 128) or the
    four-step factorisation (N up to 4096).

    ``dot_dtype=jnp.bfloat16`` runs the matmuls at bf16 input precision
    (f32 accumulate); detection decisions are robust to the mantissa
    loss at practical SNRs (opt-in)."""
    from functools import partial as _partial
    _mmd = _partial(_mm, dot_dtype=dot_dtype)
    if n <= 128:
        wr_np, wi_np = _small_dft_tables(n)
        wr, wi = jnp.asarray(wr_np), jnp.asarray(wi_np)
        yr = _mmd(xr, wr) - _mmd(xi, wi)
        yi = _mmd(xr, wi) + _mmd(xi, wr)
        return yr, yi
    # Four-step with both contractions side-chosen so the data NEVER
    # transposes between stages (each transpose of the trailing [64, 64]
    # blocks is a full pass over device memory; the naive form needs
    # three):
    #   x[i2, i1]  --W2 on the left-->  a[k2, i1]  --twiddle-->
    #   b[k2, i1]  --W1^T on the right--> c[k2, k1]
    # Only the final [k2, k1] -> [k1, k2] reorder remains (bin index
    # k = k1*n2 + k2).
    w1, w2, tw, n1, n2 = _dft_mats(n)
    w1r = jnp.asarray(w1.real.copy())
    w1i = jnp.asarray(w1.imag.copy())
    w2r = jnp.asarray(w2.real.copy())
    w2i = jnp.asarray(w2.imag.copy())
    twr = jnp.asarray(np.ascontiguousarray(tw.T.real))  # [k2, i1]
    twi = jnp.asarray(np.ascontiguousarray(tw.T.imag))
    lead = xr.shape[:-1]
    xr_m = xr.reshape(*lead, n2, n1)                    # [.., i2, i1]
    xi_m = xi.reshape(*lead, n2, n1)
    ar = _mmd(w2r, xr_m) - _mmd(w2i, xi_m)              # inner DFT: [.., k2, i1]
    ai = _mmd(w2r, xi_m) + _mmd(w2i, xr_m)
    br = ar * twr - ai * twi                            # twiddle
    bi = ar * twi + ai * twr
    cr = _mmd(br, w1r.T) - _mmd(bi, w1i.T)              # outer DFT: [.., k2, k1]
    ci = _mmd(br, w1i.T) + _mmd(bi, w1r.T)
    return (cr.swapaxes(-1, -2).reshape(*lead, n),
            ci.swapaxes(-1, -2).reshape(*lead, n))


@functools.lru_cache(maxsize=16)
def _combined_dft_mat(n: int):
    """[2n, 2n] float32 ``M`` with ``[xr | xi] @ M = [yr | yi]`` for the
    Wr=cos / Wi=-sin DFT: ``M = [[Wr, Wi], [-Wi, Wr]]``.

    ONE matmul instead of four-plus-two-adds: the combined form reads
    the (concatenated) operand once and writes both output planes once,
    where the split form reads each input plane twice. NumPy on purpose —
    the cache must never capture tracer-created arrays (see _dft_mats)."""
    k = np.arange(n)
    ang = 2 * np.pi * np.outer(k, k) / n
    wr = np.cos(ang).astype(np.float32)
    wi = (-np.sin(ang)).astype(np.float32)
    return np.block([[wr, wi], [-wi, wr]])


@functools.lru_cache(maxsize=16)
def _combined_fourstep_mats(n: int):
    """Combined-form constants for the four-step: ``M1R`` [2n1, 2n1]
    right-multiplies concatenated [br | bi] columns (stage 1 uses
    ``_combined_dft_mat(n2)``); twiddles stored in the [k2, i1] layout
    (transpose at use site for [i1, k2])."""
    w1, w2, tw, n1, n2 = _dft_mats(n)
    m1r = np.block([[w1.real.T, w1.imag.T],
                    [-w1.imag.T, w1.real.T]]).astype(np.float32)
    twr = np.ascontiguousarray(tw.T.real).astype(np.float32)
    twi = np.ascontiguousarray(tw.T.imag).astype(np.float32)
    return m1r, n1, n2, twr, twi


def _dft_mag2_scrambled(xr, xi, n: int, dot_dtype=None):
    """|DFT|² in the four-step's native [.., k2, k1] layout (bin
    ``k = k1*n2 + k2``), via two combined matmuls and NO output reorder —
    the reorder runs on whatever the caller actually consumes.

    Transposed-stack form: BOTH dots contract their minor axis — stage 1
    is ``xst[.., i1, 2n2] @ combined_dft(n2)`` (the [i2, i1] -> [i1, i2]
    transpose rides the producer's write pattern), the twiddle runs in
    natural [n1, n2] layout, and a transposing concat into [.., n2, 2n1]
    feeds stage 2. The earlier left-multiply form contracted the -2 axis
    of its stacked operand, which made layout assignment relayout both
    matmul operands (four bf16 block-transpose copies at SF12)."""
    m1r, n1, n2, twr_t, twi_t = _combined_fourstep_mats(n)
    lead = xr.shape[:-1]
    xst = jnp.concatenate(
        [xr.reshape(*lead, n2, n1).swapaxes(-1, -2),
         xi.reshape(*lead, n2, n1).swapaxes(-1, -2)], axis=-1
    )                                                   # [.., n1, 2n2]
    a = _mm(xst, jnp.asarray(_combined_dft_mat(n2)), dot_dtype)
    ar, ai = a[..., :n2], a[..., n2:]                   # [.., n1, n2]
    twr = jnp.asarray(twr_t.T.copy())                   # [n1, n2] natural
    twi = jnp.asarray(twi_t.T.copy())
    bs = jnp.concatenate(
        [(ar * twr - ai * twi).swapaxes(-1, -2),
         (ar * twi + ai * twr).swapaxes(-1, -2)], axis=-1
    )                                                   # [.., n2, 2n1]
    c = _mm(bs, jnp.asarray(m1r), dot_dtype)            # [cr | ci]
    return c[..., :n1] * c[..., :n1] + c[..., n1:] * c[..., n1:]


def dft_mag2_planar(xr, xi, n: int, dot_dtype=None):
    """|DFT|² over the last axis in natural bin order, combined-matmul
    form throughout. At n > 128 only the (half-sized) mag² is reordered
    from the four-step's [k2, k1] layout, not two spectrum planes."""
    if n <= 128:
        f = jnp.concatenate([xr, xi], axis=-1)
        y = _mm(f, jnp.asarray(_combined_dft_mat(n)), dot_dtype)
        return y[..., :n] * y[..., :n] + y[..., n:] * y[..., n:]
    m = _dft_mag2_scrambled(xr, xi, n, dot_dtype)
    lead = m.shape[:-2]
    return m.swapaxes(-1, -2).reshape(*lead, n)


class PlanarDetection(NamedTuple):
    index: jnp.ndarray
    power: jnp.ndarray       # fundamental power, dB (LoRaDetector.hpp:64)
    power_avg: jnp.ndarray   # residual/noise power, dB — the SNR observable
    findex: jnp.ndarray
    peak_re: jnp.ndarray
    peak_im: jnp.ndarray


def argmax_bins_planar(xr, xi, n: int, dot_dtype=None, with_peak=False):
    """DFT + |.|² + argmax only — the detection decision without the
    metric outputs (power dB, noise, fIndex, peak phase). The frame-sync
    scan consumes nothing but the bin index over [.., windows, N], so
    skipping the metric passes saves several full-spectrum elementwise
    rounds and per-window gathers on a memory-bound stage. Identical
    ``index`` semantics to :func:`detect_planar` (same argmax tie-break).

    ``with_peak=True`` additionally returns the peak |.|² (one extra
    fused reduction) for power-threshold gating.

    Combined-matmul form (one matmul per DFT stage); at n > 128 the
    argmax runs directly on the four-step's [k2, k1] layout with NO
    spectrum reorder pass: a single variadic reduce carries (mag², natural
    bin ``k = k1*n2 + k2``) and its comparator breaks equal-magnitude ties
    to the LOWEST NATURAL bin — bit-for-bit the reference's first-max scan
    order (tests/equal_power_bin_test.cpp:31-55) at every SF, same
    one-pass cost as ``jnp.argmax`` (which is the same variadic reduce
    with the scrambled position as the carried index)."""
    if n <= 128:
        mag2 = dft_mag2_planar(xr, xi, n, dot_dtype=dot_dtype)
        bins = jnp.argmax(mag2, axis=-1).astype(jnp.int32)
        if with_peak:
            return bins, jnp.max(mag2, axis=-1)
        return bins
    m = _dft_mag2_scrambled(xr, xi, n, dot_dtype=dot_dtype)
    lead = m.shape[:-2]
    n2, n1 = m.shape[-2], m.shape[-1]
    flat = m.reshape(*lead, n2 * n1)
    bins, peak = _argmax_natural(flat, n1, n2)
    if with_peak:
        return bins, peak
    return bins


def _argmax_natural(flat, n1: int, n2: int):
    """First-max argmax over a flattened scrambled [k2, k1] spectrum,
    returning (lowest NATURAL tied bin, peak value). The natural index is
    computed from a fused iota (never materialised) and rides the reduce
    as the carried index, so this costs exactly one pass like argmax."""
    axis = flat.ndim - 1
    pos = jax.lax.broadcasted_iota(jnp.int32, flat.shape, axis)
    nat = (pos % n1) * n2 + (pos // n1)

    def comb(acc, item):
        av, ai = acc
        bv, bi = item
        pick_b = (bv > av) | ((bv == av) & (bi < ai))
        return (jnp.where(pick_b, bv, av), jnp.where(pick_b, bi, ai))

    peak, bins = jax.lax.reduce(
        (flat, nat),
        (jnp.asarray(-jnp.inf, flat.dtype), jnp.asarray(n1 * n2, jnp.int32)),
        comb, (axis,))
    return bins, peak


def detect_planar(xr, xi, n: int, dot_dtype=None) -> PlanarDetection:
    """Planar twin of ops.detect.detect (same argmax/tie-break/fIndex
    semantics, LoRaDetector.hpp:39-74).

    Gather-free: every per-bin pick (peak, neighbours, peak phase) is a
    one-hot masked reduction over the spectrum instead of a
    ``take_along_axis``; the masks fuse into the |.|² pass."""
    sr, si = dft_planar(xr, xi, n, dot_dtype=dot_dtype)
    mag2 = sr * sr + si * si
    index = jnp.argmax(mag2, axis=-1).astype(jnp.int32)
    k = jnp.arange(n, dtype=jnp.int32)
    onehot = k == index[..., None]                      # [..., N]
    max_value = jnp.max(mag2, axis=-1)
    fundamental = jnp.sqrt(max_value)
    scale_db = 20.0 * jnp.log10(jnp.float32(n))
    power = 20.0 * jnp.log10(fundamental) - scale_db
    total = jnp.sum(mag2, axis=-1)
    noise = jnp.sqrt(jnp.maximum(total - max_value, 0.0))
    power_avg = 20.0 * jnp.log10(noise) - scale_db

    left_ix = jnp.where(index > 0, index - 1, n - 1)[..., None]
    right_ix = jnp.where(index < n - 1, index + 1, 0)[..., None]

    def mag_at(j):
        return jnp.sqrt(jnp.sum(jnp.where(k == j, mag2, 0.0), axis=-1))

    left, right = mag_at(left_ix), mag_at(right_ix)
    denom = 2.0 * fundamental - right - left
    findex = jnp.where(denom == 0.0, 0.0, 0.5 * (right - left) / denom)
    peak_re = jnp.sum(jnp.where(onehot, sr, 0.0), axis=-1)
    peak_im = jnp.sum(jnp.where(onehot, si, 0.0), axis=-1)
    return PlanarDetection(index, power.astype(jnp.float32),
                           power_avg.astype(jnp.float32),
                           findex.astype(jnp.float32), peak_re, peak_im)


def _estimate_planar(xr, xi, n: int, osr: int, window,
                     tie_break_idx: bool = True):
    """Planar twin of modem._estimate. ``tie_break_idx=True`` applies
    ``lora_demodulate``'s deterministic lowest-index tie-break
    (src/phy/LoRaDemod.cpp:85-135); ``False`` matches ``estimate_offsets``'s
    plain ``p > best`` scan (src/phy/phy.cpp:113)."""
    lead = xr.shape[:-1]
    s = xr.shape[-1] // (n * osr)

    def view(a):
        v = a[..., : s * n * osr].reshape(*lead, s, n, osr)
        return jnp.swapaxes(v, -1, -2)

    vr, vi = view(xr), view(xi)
    if window is not None:
        w = jnp.asarray(window)
        vr, vi = vr * w, vi * w
    det = detect_planar(vr, vi, n)
    p, idx = det.power, det.index

    maxp = jnp.max(p, axis=-1, keepdims=True)
    cand = p == maxp
    if tie_break_idx:
        idx_masked = jnp.where(cand, idx, jnp.iinfo(jnp.int32).max)
        min_idx = jnp.min(idx_masked, axis=-1, keepdims=True)
        cand = cand & (idx_masked == min_idx)
    best_t = jnp.argmax(cand, axis=-1)

    def pick(f):
        return jnp.take_along_axis(f, best_t[..., None], axis=-1)[..., 0]

    best_idx, best_fi = pick(idx), pick(det.findex)
    pr, pi = pick(det.peak_re), pick(det.peak_im)

    sum_index = jnp.sum(best_idx.astype(jnp.float32) + best_fi, axis=-1)
    avg_index = sum_index / jnp.float32(s)
    cfo_coarse = avg_index / jnp.float32(n)

    phase = jnp.arctan2(pi, pr).astype(jnp.float32)
    if s > 1:
        d = phase[..., 1:] - phase[..., :-1]
        d = jnp.where(d > math.pi, d - _TWO_PI, d)
        d = jnp.where(d < -math.pi, d + _TWO_PI, d)
        cfo_fine = (jnp.sum(d, axis=-1) / jnp.float32(s - 1)) / (
            jnp.float32(_TWO_PI) * jnp.float32(n)
        )
    else:
        cfo_fine = jnp.zeros_like(cfo_coarse)
    cfo = cfo_coarse + cfo_fine

    frac = avg_index - jnp.floor(avg_index + 0.5)
    avg_t = jnp.sum(best_t, axis=-1).astype(jnp.float32) / jnp.float32(s)
    time_offset = avg_t - frac * jnp.float32(n) * jnp.float32(osr)
    return cfo.astype(jnp.float32), time_offset.astype(jnp.float32)


@functools.lru_cache(maxsize=32)
def _preamble_phase_step(sf: int, osr: int, scale: float) -> float:
    """Deterministic inter-symbol phase delta of dechirped base upchirps.

    Phase-continuous modulation steps the carrier phase by a fixed
    lattice amount per symbol (measured: pi at osr=1/scale=1, pi/2 at
    osr=2, 0 at scale=2, ...), which rides the dechirped preamble tones
    and would alias the phase-slope CFO term by that fraction of a bin.
    Measured here once per config from the float64 host oracle (exact by
    construction, no closed form to get wrong). Pure NumPy so it stays a
    trace-time constant even when called while jitting."""
    from .chirp import gen_chirp_np

    n = 1 << sf
    step = n * osr
    up, _ = gen_chirp_np(n, osr, 2 * step, 0.0, down=False, ampl=1.0,
                         bw_scale=scale)
    down, _ = gen_chirp_np(n, osr, step, 0.0, down=True, ampl=1.0,
                           bw_scale=scale)
    dech = up.reshape(2, step) * down
    spec = np.fft.fft(dech.reshape(2, n, osr)[:, :, 0], axis=-1)
    pk = spec[np.arange(2), np.abs(spec).argmax(-1)]
    return float(np.angle(pk[1] * np.conj(pk[0])))


def estimate_preamble_planar(pr, pi, n: int, osr: int,
                             phase_step: float = 0.0, bin_offset=None):
    """Unbiased residual-CFO estimate from dechirped PREAMBLE windows.

    The reference-mirroring 2-symbol estimator reads the sync pair's bins
    as CFO displacement (src/phy/LoRaDemod.cpp:101-135 does the same), so
    its estimate is biased by ``mean(sync bins)/N`` — harmless for small
    sync words (0x12), catastrophic for large ones (0x8e: the upstream
    Pothos examples' sync, where the bias shifts every decision one bin).
    Preamble symbols all transmit bin 0, so their windows measure the
    channel alone: coarse = mean(signed argmax + fractional interp), fine =
    peak-phase slope across windows (resolves CFO mod 1 bin), combined by
    integer disambiguation. Returns CFO in bins, [...]-shaped.

    ``phase_step``: the modulator's deterministic inter-symbol phase
    delta (:func:`_preamble_phase_step`), subtracted from the slope so
    the fine term measures the channel alone.

    ``bin_offset`` ([...]-shaped int32): expected integer bin of the
    preamble tones, for callers whose spectra arrive rotated by a known
    shift (the block receiver's circular window extraction). The signed
    wrap re-centers on it — otherwise a rotated tone near the +-n/2
    boundary would split the coarse mean across wrap branches — and the
    estimate is returned RELATIVE to it (i.e. already un-rotated).
    """
    lead = pr.shape[:-1]
    s = pr.shape[-1] // (n * osr)
    vr = pr[..., : s * n * osr].reshape(*lead, s, n, osr)[..., 0]
    vi = pi[..., : s * n * osr].reshape(*lead, s, n, osr)[..., 0]
    det = detect_planar(vr, vi, n)
    if bin_offset is None:
        sb = jnp.where(det.index > n // 2, det.index - n, det.index)
    else:
        b0 = jnp.asarray(bin_offset, jnp.int32)[..., None]
        sb = jnp.mod(det.index - b0 + n // 2, n) - n // 2
    coarse = jnp.mean(sb.astype(jnp.float32) + det.findex, axis=-1)
    if s < 2:
        # one window has no phase slope: the coarse term alone (an
        # empty-axis mean would return NaN silently)
        return coarse.astype(jnp.float32)
    phase = jnp.arctan2(det.peak_im, det.peak_re).astype(jnp.float32)
    d = phase[..., 1:] - phase[..., :-1] - jnp.float32(phase_step)
    d = jnp.mod(d + math.pi, _TWO_PI) - math.pi
    fine = jnp.mean(d, axis=-1) / jnp.float32(_TWO_PI)   # = cfo mod 1 bin
    return (fine + jnp.round(coarse - fine)).astype(jnp.float32)


def estimate_preamble_robust_planar(pr, pi, n: int, osr: int,
                                    phase_step: float = 0.0,
                                    return_acc: bool = False):
    """Multipath-robust variant of :func:`estimate_preamble_planar`: one
    COMMON bin from the accumulated preamble spectrum instead of
    per-window argmaxes.

    Under a near-equal-power two-ray channel the per-window argmax
    alternates between the paths' bins, so the plain estimator's coarse
    term (mean of per-window argmaxes) lands between them and shifts
    every decision by its rounding. Here: sum the windows' |DFT|², take
    ONE argmax (locks to the strongest path), read the fractional term
    from the summed spectrum's neighbours, and measure the fine term as
    the phase slope of the per-window complex DFT value AT that common
    bin (a one-hot mask + reduction — no element gather). Returns CFO in
    bins, [...]-shaped; ``return_acc=True`` additionally returns the
    accumulated |DFT|² spectrum (the multipath signature — callers reuse
    it instead of re-DFT-ing the same windows)."""
    lead = pr.shape[:-1]
    s = pr.shape[-1] // (n * osr)
    vr = pr[..., : s * n * osr].reshape(*lead, s, n, osr)[..., 0]
    vi = pi[..., : s * n * osr].reshape(*lead, s, n, osr)[..., 0]
    fr, fi = dft_planar(vr, vi, n)                      # [..., S, n]
    mag2 = fr * fr + fi * fi
    acc = jnp.sum(mag2, axis=-2)                        # [..., n]
    b = jnp.argmax(acc, axis=-1)                        # [...]
    onehot = (jnp.arange(n) == b[..., None]).astype(fr.dtype)   # [..., n]

    def at(off):
        oh = jnp.roll(onehot, off, axis=-1)
        # detector convention interpolates MAGNITUDES (detect_planar
        # takes sqrt of |.|² first), not powers
        return jnp.sqrt(jnp.sum(acc * oh, axis=-1))

    peak, left, right = at(0), at(-1), at(1)
    frac = 0.5 * (right - left) / jnp.maximum(
        2.0 * peak - right - left, 1e-30)               # detector convention
    sb = jnp.where(b > n // 2, b - n, b).astype(jnp.float32)
    coarse = sb + frac

    if s < 2:
        cfo = coarse.astype(jnp.float32)
        return (cfo, acc) if return_acc else cfo
    pre = fr * onehot[..., None, :]
    pim = fi * onehot[..., None, :]
    re_b = jnp.sum(pre, axis=-1)                        # [..., S]
    im_b = jnp.sum(pim, axis=-1)
    phase = jnp.arctan2(im_b, re_b).astype(jnp.float32)
    d = phase[..., 1:] - phase[..., :-1] - jnp.float32(phase_step)
    d = jnp.mod(d + math.pi, _TWO_PI) - math.pi
    fine = jnp.mean(d, axis=-1) / jnp.float32(_TWO_PI)
    cfo = (fine + jnp.round(coarse - fine)).astype(jnp.float32)
    if return_acc:
        return cfo, acc
    return cfo


@partial(jax.jit, static_argnames=("params", "assume_normalized",
                                   "precision"))
def demodulate_planar(xr, xi, params: LoraParams,
                      assume_normalized: bool = False,
                      precision: str = "f32",
                      known_offsets=None) -> PlanarDemodResult:
    """Planar twin of models.modem.demodulate (the working dechirped-input
    contract). ``xr, xi``: [..., S_total*step] float32.

    ``assume_normalized=True`` skips the [-1,1] rescale scan
    for pipelines that guarantee canonical amplitudes (saves one full
    input pass). ``precision='bf16'`` runs the DFT matmuls at bf16 input
    precision (f32 accumulate); the default ``'f32'`` runs them at full
    float32 precision on every backend. ``known_offsets=(cfo, time_offset)``
    (broadcastable to the batch) bypasses the reference-mirroring
    2-symbol estimator — the streaming receiver supplies its unbiased
    preamble-anchored estimate here (:func:`estimate_preamble_planar`)."""
    n = params.n
    dot_dtype = jnp.bfloat16 if precision == "bf16" else None
    yr, yi, rate, t_off, scale, cfo, time_offset = _demod_stage_planar(
        xr, xi, params, assume_normalized, known_offsets
    )
    fr, fi = _rotated_windows_planar(yr, yi, rate, t_off, scale, params)
    # decision-only detection: combined-matmul DFT + |.|² + argmax (the
    # metric outputs would be DCE'd anyway; this also skips the
    # four-step's spectrum reorder at N > 128)
    syms = argmax_bins_planar(fr, fi, n, dot_dtype=dot_dtype)

    syms = syms.astype(jnp.uint16)
    shift = (params.sf - 4) if params.sf > 4 else 0
    hi = (syms[..., 0].astype(jnp.int32) >> shift) & 0x0F
    lo = (syms[..., 1].astype(jnp.int32) >> shift) & 0x0F
    sync = ((hi << 4) | lo).astype(jnp.uint8)
    return PlanarDemodResult(syms[..., 2:], sync, cfo, time_offset)


def _demod_stage_planar(xr, xi, params: LoraParams, assume_normalized,
                        known_offsets, dec_phase: int = 0):
    """Common front of the planar demod: normalisation scan, offset
    estimate (or injection), shifted symbol windows.

    Returns ``(yr, yi, rate, t_off, scale, cfo, time_offset)`` with
    ``yr/yi`` the [..., S, N] pre-rotation symbol windows."""
    n, osr, step = params.n, params.osr, params.step
    total_symbols = xr.shape[-1] // step
    if total_symbols < 2:
        raise ValueError("need at least the 2 sync symbols")   # phy.hpp:186
    xr = xr[..., : total_symbols * step]
    xi = xi[..., : total_symbols * step]

    # Amplitude normalisation into [-1, 1] (src/phy/LoRaDemod.cpp:59-77).
    # Only the max scan touches the full input; the rescale itself is
    # folded into the derotation factors below (the detection argmax is
    # scale-invariant, and uniform scaling preserves the estimator's
    # power ties bit-for-bit), saving two full passes over device memory
    # vs materialising a scaled copy.
    if not assume_normalized:
        max_amp = jnp.maximum(
            jnp.max(jnp.abs(xr), axis=-1), jnp.max(jnp.abs(xi), axis=-1)
        )
        scale = jnp.where(max_amp > 1.0, 1.0 / max_amp, 1.0).astype(jnp.float32)
    else:
        scale = None

    window = _window_table(params)
    if known_offsets is None:
        er = xr[..., : 2 * step]
        ei = xi[..., : 2 * step]
        if scale is not None:
            er = er * scale[..., None]
            ei = ei * scale[..., None]
        cfo, time_offset = _estimate_planar(er, ei, n, osr, window)
    else:
        batch = xr.shape[:-1]
        cfo = jnp.broadcast_to(
            jnp.asarray(known_offsets[0], jnp.float32), batch)
        time_offset = jnp.broadcast_to(
            jnp.asarray(known_offsets[1], jnp.float32), batch)

    t_off = _round_half_away(time_offset).astype(jnp.int32)
    rate = (-jnp.float32(_TWO_PI) * cfo / jnp.float32(n)).astype(jnp.float32)

    # shifted symbol windows (src/phy/LoRaDemod.cpp:141-149 semantics),
    # dynamic-slice based (modem._shifted_rows). Two separate calls, one
    # per plane: each cond's branch buffers are reserved whether or not
    # the branch runs, and sequential conds reuse the reservation while a
    # stacked [2, ...] call doubles it.
    from ..models.modem import _shifted_symbol_gather

    yr = _shifted_symbol_gather(xr, total_symbols, n, osr, t_off, dec_phase)
    yi = _shifted_symbol_gather(xi, total_symbols, n, osr, t_off, dec_phase)
    return yr, yi, rate, t_off, scale, cfo, time_offset


def _rotated_windows_planar(yr, yi, rate, t_off, scale, params: LoraParams):
    """Derotation (scale + window folded into the rotation factors):
    the pre-DFT [..., S, N] planes.

    The reference's rotation phase is ``rate*(s*N + t_off/osr) + rate*i``
    (src/phy/LoRaDemod.cpp:151-152); the ``s*N + t_off/osr`` part is
    constant within a symbol, so it contributes only a unimodular
    per-symbol phase to the DFT output and every magnitude-derived
    detector output (argmax, power, fIndex) is invariant to it.  Only the
    per-sample ``exp(j*rate*i)`` factor — an actual frequency shift —
    survives, so the rotation operand is a [..., N] vector (N cos/sin
    instead of S*N) carrying the normalisation scale and the window, and
    the big [..., S, N] pass is a 4-multiply/2-add broadcast.  ``t_off``
    is accepted for signature stability but no longer enters the phase."""
    del t_off  # phase contribution is per-symbol-constant: magnitude-invariant
    n = params.n
    window = _window_table(params)
    phi = rate[..., None] * jnp.arange(n, dtype=jnp.float32)   # [..., N]
    cr, si_ = jnp.cos(phi), jnp.sin(phi)
    if scale is not None:
        # normalisation rides the (fused, elementwise) rotation factors
        cr = cr * scale[..., None]
        si_ = si_ * scale[..., None]
    if window is not None:
        w = jnp.asarray(window)
        cr, si_ = cr * w, si_ * w
    cr = cr[..., None, :]
    si_ = si_[..., None, :]
    fr = yr * cr - yi * si_
    fi = yr * si_ + yi * cr
    return fr, fi


@partial(jax.jit, static_argnames=("params", "assume_normalized",
                                   "precision", "dec_phase"))
def demodulate_spectrum_planar(xr, xi, params: LoraParams,
                               assume_normalized: bool = False,
                               precision: str = "f32",
                               known_offsets=None, dec_phase: int = 0):
    """Same pipeline as :func:`demodulate_planar` but returns the full
    |DFT|² spectra of the DATA symbols (sync pair stripped) for
    soft-decision decoding: ``(mag2 [..., S-2, N], sync, cfo, to)``.

    ``dec_phase`` (static): decimation phase of the symbol windows —
    pass ``osr-1`` when receiving the reference's default TX fold with
    an injected ``known_offsets`` time offset of 0 (the fold's exact
    tone lives at that phase; see modem._shifted_symbol_gather)."""
    n = params.n
    dot_dtype = jnp.bfloat16 if precision == "bf16" else None
    yr, yi, rate, t_off, scale, cfo, time_offset = _demod_stage_planar(
        xr, xi, params, assume_normalized, known_offsets, dec_phase
    )
    fr, fi = _rotated_windows_planar(yr, yi, rate, t_off, scale, params)
    mag2 = dft_mag2_planar(fr, fi, n, dot_dtype=dot_dtype)
    syms = jnp.argmax(mag2[..., :2, :], axis=-1).astype(jnp.int32)
    shift = (params.sf - 4) if params.sf > 4 else 0
    hi = (syms[..., 0] >> shift) & 0x0F
    lo = (syms[..., 1] >> shift) & 0x0F
    sync = ((hi << 4) | lo).astype(jnp.uint8)
    return mag2[..., 2:, :], sync, cfo, time_offset


def split_complex(x):
    """complex64 [..., L] -> (re, im) float32 planes."""
    x = np.asarray(x)
    return (np.ascontiguousarray(x.real.astype(np.float32)),
            np.ascontiguousarray(x.imag.astype(np.float32)))


# ---------------------------------------------------------------------------
# Planar TX + dechirp
# ---------------------------------------------------------------------------

def modulate_planar(symbols, params: LoraParams, amplitude: float = 1.0):
    """Planar twin of models.modem.modulate: symbols -> phase-continuous
    chirped (re, im) float32 planes with the 2-symbol sync preamble
    (reference TX chain: src/phy/LoRaMod.cpp:8-43, hot loop
    ChirpGenerator.hpp:23-50). Runs entirely on-device, with no complex
    dtype. [..., S] -> ((re, im) [..., (S+2)*step])."""
    from .chirp import modulate_symbols_planar

    return modulate_symbols_planar(
        symbols, params.sf, params.osr, params.scale, amplitude,
        params.sync_word, params.continuous_chirp,
    )


@partial(jax.jit, static_argnames=("params",))
def dechirp_planar(xr, xi, params: LoraParams):
    """Planar external dechirp — multiply every symbol period by the base
    downchirp (the working-path contract, tests/e2e_chain_test.cpp:80-93),
    as a planar complex multiply against trace-time constant planes."""
    from .chirp import base_downchirp_planar

    dr, di = base_downchirp_planar(params.sf, params.scale, params.osr)
    dr, di = jnp.asarray(dr), jnp.asarray(di)
    step = params.step
    nsym = xr.shape[-1] // step
    lead = xr.shape[:-1]
    ar = xr[..., : nsym * step].reshape(*lead, nsym, step)
    ai = xi[..., : nsym * step].reshape(*lead, nsym, step)
    yr = ar * dr - ai * di
    yi = ar * di + ai * dr
    return (yr.reshape(*lead, nsym * step), yi.reshape(*lead, nsym * step))


# ---------------------------------------------------------------------------
# Planar estimate / compensate (public API parity with phy.cpp on the
# planar deployment path)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("params",))
def estimate_offsets_planar(xr, xi, params: LoraParams):
    """Planar twin of models.modem.estimate_offsets (src/phy/phy.cpp:78-145;
    no argmax-index tie-break across osr phases)."""
    window = _window_table(params)
    return _estimate_planar(xr, xi, params.n, params.osr, window,
                            tie_break_idx=False)


@partial(jax.jit, static_argnames=("params",))
def compensate_offsets_planar(xr, xi, params: LoraParams, cfo, time_offset):
    """Planar twin of models.modem.compensate_offsets
    (src/phy/phy.cpp:147-176): derotate by the estimated CFO, then shift by
    the rounded integer timing offset with zero fill. The shift is a padded
    per-row dynamic slice (contiguous) instead of an element gather —
    semantics identical."""
    n, osr = params.n, params.osr
    count = xr.shape[-1]
    rate = -jnp.float32(_TWO_PI) * jnp.asarray(cfo, jnp.float32) / (
        jnp.float32(n) * jnp.float32(osr)
    )
    ph = rate[..., None] * jnp.arange(count, dtype=jnp.float32)
    c, s = jnp.cos(ph), jnp.sin(ph)
    yr = xr * c - xi * s
    yi = xr * s + xi * c

    offset = _round_half_away(
        jnp.asarray(time_offset, jnp.float32)
    ).astype(jnp.int32)
    # out[j] = y[j - offset] (zero fill) == padded slice starting at
    # count - offset; the reference skips the shift when |offset| >= count
    do_shift = jnp.abs(offset) < count
    start = jnp.where(do_shift, count - offset, count)

    def shift_one(rowr, rowi, st):
        pr = jnp.pad(rowr, (count, count))
        pi = jnp.pad(rowi, (count, count))
        return (jax.lax.dynamic_slice(pr, (st,), (count,)),
                jax.lax.dynamic_slice(pi, (st,), (count,)))

    flat_r = yr.reshape(-1, count)
    flat_i = yi.reshape(-1, count)
    # dimension-aligned broadcast (like the complex twin): an offset
    # batch smaller than x's full leading shape must pair per-row, not
    # fail/mis-pair via a flat reshape
    flat_start = jnp.broadcast_to(start, yr.shape[:-1]).reshape(-1)
    sr, si = jax.vmap(shift_one)(flat_r, flat_i, flat_start)
    return sr.reshape(yr.shape), si.reshape(yi.shape)


@partial(jax.jit, static_argnames=("params",))
def estimate_sro_planar(xr, xi, params: LoraParams):
    """Sample-rate-offset (TX/RX clock mismatch) estimate from dechirped
    symbol windows [..., S*step] -> drift in ppm, [...]-shaped.

    No reference counterpart (its channel model stops at CFO + integer
    shift + AWGN; real crystals drift 10-20 ppm). Decode-directed and
    data-blind: under a relative clock offset ``d = ppm*1e-6`` the
    dechirped tone of symbol ``s`` sits at a fractional bin that drifts
    linearly, ``d * s * N * scale`` bins — independent of the symbol
    VALUE (which only moves the integer bin) and of any constant CFO
    (which cancels in first differences). The estimator measures each
    window's fractional bin with the sinc-ratio form
    ``delta = right/(peak+right)`` (exact for a Dirichlet tone, unlike
    magnitude-parabolic interpolation whose small-offset bias would
    scale the slope by ~3x), wraps first differences to [-1/2, 1/2) so
    integer-bin hops cancel, and averages.

    Windows are decimated at the phase where the tone is exact: 0 for
    ``continuous_chirp`` TX, ``osr-1`` under the reference fold (whose
    one-sample-early fold skews the waveform by one sample — see
    docs/SEMANTICS.md; at the wrong phase the tone is a two-component
    superposition and any interpolator breaks). Gather-free: all
    per-bin picks are one-hot masked reductions."""
    n, osr = params.n, params.osr
    phase = 0 if (params.continuous_chirp or osr == 1) else osr - 1
    lead = xr.shape[:-1]
    s = xr.shape[-1] // (n * osr)
    if s < 2:
        # no first differences to measure: report zero drift, not NaN
        # (an empty-axis mean would silently poison the tracking loop)
        return jnp.zeros(lead, jnp.float32)

    def view(a):
        return a[..., : s * n * osr].reshape(*lead, s, n, osr)[..., phase]

    sr, si = dft_planar(view(xr), view(xi), n)
    mag2 = sr * sr + si * si                                  # [..., S, N]
    index = jnp.argmax(mag2, axis=-1).astype(jnp.int32)
    k = jnp.arange(n, dtype=jnp.int32)
    peak = jnp.sqrt(jnp.max(mag2, axis=-1))
    left_ix = jnp.where(index > 0, index - 1, n - 1)[..., None]
    right_ix = jnp.where(index < n - 1, index + 1, 0)[..., None]

    def mag_at(j):
        return jnp.sqrt(jnp.sum(jnp.where(k == j, mag2, 0.0), axis=-1))

    left, right = mag_at(left_ix), mag_at(right_ix)
    den_r, den_l = peak + right, peak + left
    fi = jnp.where(
        right >= left,
        jnp.where(den_r > 0.0, right / jnp.where(den_r > 0.0, den_r, 1.0), 0.0),
        -left / jnp.where(den_l > 0.0, den_l, 1.0),
    )                                                          # [..., S]
    dd = fi[..., 1:] - fi[..., :-1]
    dd = jnp.mod(dd + 0.5, 1.0) - 0.5
    slope = jnp.mean(dd, axis=-1)                              # bins/symbol
    return (1e6 * slope / jnp.float32(n * params.scale)).astype(jnp.float32)
