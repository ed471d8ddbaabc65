"""Device-side batched frame synchronisation.

The reference has no frame sync at all (SURVEY.md §5.7: whole-buffer,
frame-aligned input assumed); models/stream.py adds the classic two-sided
dechirp detector. This module is its device-side core: the entire scan —
symbol-window dechirp (up and down), FFT bins, preamble run-length
detection, downchirp-section pairing, timing/CFO split and validity — runs
as ONE jit over ``[..., channels, windows]``, with no per-window host
round-trips. Run lengths come from a cumulative-max trick instead of the
serial scan:

    eq[w]   = bin[w] == bin[w-1]
    last_false[w] = cummax_w( where(eq, -1, w) )
    run[w]  = 1 + w - last_false[w]          # consecutive equal windows

Host code then reads the tiny per-window candidate arrays once and picks
frames — frame bookkeeping is the only thing left off-device.

Works on planar (re, im) float32 planes, like the rest of the deployment
path (ops/planar.py).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.chirp import base_downchirp_planar
from ..ops.planar import argmax_bins_planar
from ..utils.params import LoraParams

# NOTE: no module-level jnp constants — creating a device array at import
# time initializes the default backend before a program can configure JAX
# (the test suite's CPU pin, tests/test_runners.py).


class SyncScan(NamedTuple):
    """Per-window candidate fields, leading dims = input batch dims.

    A window ``w`` with ``valid[w]`` marks the END of a preamble run whose
    frame starts at sample ``start[w]`` with integer-CFO ``cfo_bins[w]``.
    """

    valid: jnp.ndarray      # [..., W] bool
    start: jnp.ndarray      # [..., W] int32 sample index of frame start
    cfo_bins: jnp.ndarray   # [..., W] int32
    tau: jnp.ndarray        # [..., W] int32 timing offset (samples)
    up_bins: jnp.ndarray    # [..., W] int32 raw up-dechirp argmax bins
    dn_bins: jnp.ndarray    # [..., W] int32 raw down-dechirp argmax bins


def _signed_bin(b, n: int):
    return jnp.where(b > n // 2, b - n, b).astype(jnp.int32)


def _round_half_even(x):
    # python round() semantics for the k/2 splits (k integer): jnp.round
    # is half-to-even, same as the host implementation used
    return jnp.round(x).astype(jnp.int32)


@partial(jax.jit, static_argnames=("params", "preamble_len", "min_power_db",
                                   "pre_acc"))
def frame_sync_scan_planar(xr, xi, params: LoraParams,
                           preamble_len: int = 8,
                           min_power_db: float | None = None,
                           pre_acc: int = 1) -> SyncScan:
    """Batched two-sided dechirp frame scan over ``[..., T]`` planes.

    ``min_power_db`` gates candidates on the up-dechirped peak power of
    the run's last preamble window (detector dB convention,
    LoRaDetector.hpp:64: 0 dB = full-scale chirp) — the Pothos demod
    block's ``thresh`` property (its examples use -30 dB). Without it,
    silence and stopband leakage on quiet channels sync "perfectly"
    (their all-equal argmax bins look like a preamble run).

    ``pre_acc > 1`` turns on the multipath-robust accumulated-spectrum
    detector: per-window |DFT|² spectra are sliding-summed over
    ``pre_acc`` windows before the argmax, so a near-equal-power two-ray
    channel — whose per-window argmax alternates between the two paths'
    bins and never forms an equal-bin run (measured 18-23/25 missed
    syncs; docs/SEMANTICS.md) — locks to the strongest path's bin. The
    SFD pair test becomes a paired-sum dn-vs-up dominance test, and a
    peak-concentration gate (peak >= 8x the accumulated spectrum's mean)
    replaces the lost per-window equality selectivity against loud
    noise. Costs full-spectrum materialisation (the default decision-
    only scan is what the bench gates), hence opt-in."""
    n, osr, step = params.n, params.osr, params.step
    nwin = xr.shape[-1] // step
    lead = xr.shape[:-1]

    ar = xr[..., : nwin * step].reshape(*lead, nwin, step)
    ai = xi[..., : nwin * step].reshape(*lead, nwin, step)

    dr, di = base_downchirp_planar(params.sf, params.scale, params.osr)
    dr, di = jnp.asarray(dr), jnp.asarray(di)

    # decimation phase: the reference generator's one-sample-early fold
    # applies at EVERY chirp-period boundary — preamble repetitions and
    # the SFD included, not just modulated symbols — so at osr>1 any
    # grid window straddling a boundary carries the fold's spurious
    # constant (pi at osr=2) between its two segments and splits its
    # tone at phase 0 (run detection then never sees an equal-bin run
    # for mid-window arrivals; measured 59/61 alternation). Phase osr-1
    # is where the folded lattice is exact (docs/SEMANTICS.md §TX fold).
    dph = 0 if (params.continuous_chirp or osr == 1) else osr - 1

    # up-dechirp (x * down) and down-dechirp (x * conj(down)), decimated;
    # both branches ride ONE stacked DFT+argmax call (measured 18.1 ->
    # 14.8 ms on the bench scan workload vs two calls). Peaks are always
    # computed: the downchirp-section detector needs the down-vs-up
    # dominance discriminant below.
    def windows(pr, pi):
        return (pr.reshape(*lead, nwin, n, osr)[..., dph],
                pi.reshape(*lead, nwin, n, osr)[..., dph])

    ur, ui = windows(ar * dr - ai * di, ar * di + ai * dr)
    vr, vi = windows(ar * dr + ai * di, ai * dr - ar * di)
    conc_ok = None
    if pre_acc == 1:
        out = argmax_bins_planar(
            jnp.stack([ur, vr]), jnp.stack([ui, vi]), n, with_peak=True
        )
        (ub, db), (up_peak, dn_peak) = (out[0][0], out[0][1]), (out[1][0],
                                                                out[1][1])
    else:
        if not 2 <= pre_acc <= 3:
            raise ValueError(
                "pre_acc must be 1 (off) or 2..3: the SFD pair search and "
                f"the 3-hypothesis start probe only cover the run-end smear "
                f"of accumulations up to 3 windows (got {pre_acc})")
        from ..ops.planar import dft_mag2_planar

        m = dft_mag2_planar(jnp.stack([ur, vr]), jnp.stack([ui, vi]), n)
        m_up, m_dn = m[0], m[1]                        # [..., W, n]

        def lagged(x, j):
            """x shifted j window-rows later (leading zeros), any nwin."""
            z = jnp.zeros(lead + (min(j, nwin), n), x.dtype)
            return jnp.concatenate([z, x], axis=-2)[..., :nwin, :]

        # causal sliding sum over pre_acc windows as pre_acc-1 shifted
        # adds (no cumsum: its difference form loses precision on long
        # blocks — the running sum grows while the window sum does not)
        s_up = m_up
        for j in range(1, pre_acc):
            s_up = s_up + lagged(m_up, j)
        ub = jnp.argmax(s_up, axis=-1).astype(jnp.int32)
        up_peak = jnp.max(s_up, axis=-1) / pre_acc     # per-window scale
        # loud noise also forms long runs under overlapping sums (S[w]
        # and S[w+1] share pre_acc-1 summands); require tone-like
        # concentration: accumulated peak >= 8x the accumulated mean
        conc_ok = up_peak * pre_acc >= 8.0 * jnp.mean(s_up, axis=-1)
        # SFD: paired dn sums; pair-argmax replaces the equality test
        # (the same alternation breaks db[c] == db[c+1])
        zrow = jnp.zeros(lead + (1, n), m_dn.dtype)
        dn2 = m_dn + jnp.concatenate([m_dn[..., 1:, :], zrow], axis=-2)
        up2 = m_up + jnp.concatenate([m_up[..., 1:, :], zrow], axis=-2)
        db = jnp.argmax(dn2, axis=-1).astype(jnp.int32)
        dn_peak = jnp.max(dn2, axis=-1) / 2.0
        up_peak_pair = jnp.max(up2, axis=-1) / 2.0

    # --- preamble run lengths (vectorized run-detect) ---------------------
    # A dechirped preamble tone can sit at a HALF-BIN, where the
    # per-window argmax flips between the two adjacent bins on float
    # rounding and an exact-equality run never forms — accept +-1-bin
    # neighbors. Two real sources: (a) osr>1 sub-osr arrival phases
    # (odd-sample arrivals at osr=2: -rsub/osr ends in .5); (b) at ANY
    # osr, per-symbol-independent TX a la gr-lora_sdr (zero phase carry
    # -> a pi jump at every chirp boundary) splits the tone of every
    # grid window that straddles a boundary — measured 10/10 sync
    # failures at +6 dB for mid-window arrivals under the osr=1
    # exact-equality contract, 0/10 tolerant. Noise selectivity cost is
    # negligible: a false +-1 run of length 5 is (3/n)^5 vs (1/n)^5,
    # ~6e-9 at n=128, and the concentration/power/sync-word gates
    # remain. The run-end bin then wanders +-1: downstream absorbs it
    # (integer CFO error rides the preamble-anchored fractional
    # estimator; timing error rides the sub-osr refinement).
    w_idx = jnp.arange(nwin, dtype=jnp.int32)
    d_ub = jnp.mod(ub[..., 1:] - ub[..., :-1], n)
    adj = (d_ub == 0) | (d_ub == 1) | (d_ub == n - 1)
    eq = jnp.concatenate([jnp.zeros(lead + (1,), bool), adj], axis=-1)
    last_false = jax.lax.cummax(
        jnp.where(eq, jnp.int32(-1), w_idx).astype(jnp.int32), axis=len(lead)
    )
    run = 1 + w_idx - last_false                      # [..., W]

    need = max(2, preamble_len - 2)
    eq_next = jnp.concatenate(
        [eq[..., 1:], jnp.zeros(lead + (1,), bool)], axis=-1
    )
    is_end = (run >= need) & ~eq_next                 # maximal-run ends

    # --- downchirp section: first c in [end+1, end+5] with db[c]==db[c+1]
    # AND down-dechirp dominance. A real SFD window concentrates its
    # energy in the down-dechirped spectrum; up-preamble or silence
    # windows do not, and their broad down spectra are argmax-tie-prone
    # (equal-neighbor false pairs shift with harmless rounding changes).
    # Requiring dn_peak > up_peak at the pair head kills those candidates
    # (silence: 0 > 0 is False) without touching genuine frames. --------
    if pre_acc == 1:
        dn_dom = dn_peak > up_peak
        # same half-bin flip tolerance as the preamble run above (the
        # SFD downchirps straddle boundaries with the same pi jump
        # under per-symbol-independent TX)
        d_db = jnp.mod(db[..., 1:] - db[..., :-1], n)
        db_adj = (d_db == 0) | (d_db == 1) | (d_db == n - 1)
        db_eq = jnp.concatenate(
            [db_adj & dn_dom[..., :-1],
             jnp.zeros(lead + (1,), bool)], axis=-1
        )                                             # db_eq[c] = db[c]==db[c+1]
    else:
        # paired-sum dominance stands in for the equality test (the pair
        # argmax is one decision, there is nothing to compare)
        db_eq = jnp.concatenate(
            [(dn_peak > up_peak_pair)[..., :-1],
             jnp.zeros(lead + (1,), bool)], axis=-1)

    def shift_left(a, o):
        pad = jnp.zeros(lead + (o,), a.dtype)
        return jnp.concatenate([a[..., o:], pad], axis=-1)

    # five static shifts (the host scan's range(end+1, end+6)) instead of
    # a dynamic gather; first-match selection is a where-chain (element
    # gathers via take_along_axis are pathologically slow on this chip —
    # CLAUDE.md / modem._shifted_rows). NOTE: with pre_acc the run end
    # lands ~pre_acc-1 windows later, so the SFD pair must still fall in
    # [end+1, end+5] — effective for pre_acc <= 3.
    has_dwin = jnp.zeros(lead + (nwin,), bool)
    bin_dn_raw = jnp.zeros_like(db)
    for o in range(5, 0, -1):                         # later offsets lose
        h = shift_left(db_eq, o) & (w_idx + o < nwin - 1)
        bin_dn_raw = jnp.where(h, shift_left(db, o), bin_dn_raw)
        has_dwin = has_dwin | h

    bin_up = _signed_bin(ub, n)
    bin_dn = _signed_bin(bin_dn_raw, n)
    # bin n/2 is sign-ambiguous (+n/2 == -n/2 mod n); the two-sided split
    # then aliases tau=+/-step/2 against cfo=-/+n/2. Resolve with the
    # physical prior of minimal |cfo| (real CFO << bw/2) by flipping the
    # ambiguous bin(s) when that reduces |bin_up + bin_dn|. Tie order of
    # the old 4-candidate argmin: (u,d), (u,d'), (u',d), (u',d') —
    # first minimum wins; the nested where-chain preserves it.
    half = n // 2
    bu_alt = jnp.where(ub == half, bin_up - n, bin_up)
    bd_alt = jnp.where(bin_dn_raw == half, bin_dn - n, bin_dn)
    s0 = jnp.abs(bin_up + bin_dn)
    s1 = jnp.abs(bin_up + bd_alt)
    s2 = jnp.abs(bu_alt + bin_dn)
    s3 = jnp.abs(bu_alt + bd_alt)
    m = jnp.minimum(jnp.minimum(s0, s1), jnp.minimum(s2, s3))
    pick1 = (s1 == m) & (s0 != m)
    pick2 = (s2 == m) & (s0 != m) & (s1 != m)
    pick3 = (s3 == m) & (s0 != m) & (s1 != m) & (s2 != m)
    bin_up = jnp.where(pick2 | pick3, bu_alt, bin_up)
    bin_dn = jnp.where(pick1 | pick3, bd_alt, bin_dn)

    # two-sided split: at chirp slope ``scale`` (BW250/500) a timing
    # offset of t samples shifts the dechirped tone by t*scale/osr bins,
    # so the tau arm divides by scale (the cfo arm is a physical
    # frequency offset — scale-free). Without the division the reported
    # start is off by (scale-1)*tau samples at BW250/500 (measured:
    # frame at 300 "found" at 344 at BW250); exact no-op at BW125.
    tau = _round_half_even(
        (bin_dn - bin_up) / (2.0 * params.scale)) * osr
    cfo_bins = _round_half_even((bin_dn + bin_up) / 2.0)
    # accumulated bins hold their value ~pre_acc-1 windows past the true
    # run end (the sliding sum still carries preamble energy there)
    start = (w_idx - preamble_len + 1 - (pre_acc - 1)) * step + tau
    # the run-end is fuzzy by one window (see the receivers' SFD-probe
    # disambiguation): keep a nominally-negative start alive if its
    # +step alias would be in range
    valid = is_end & has_dwin & (start + step >= 0)
    if conc_ok is not None:
        valid = valid & conc_ok
    if min_power_db is not None:
        power_db = (10.0 * jnp.log10(jnp.maximum(up_peak, 1e-30))
                    - 20.0 * math.log10(n))
        valid = valid & (power_db >= jnp.float32(min_power_db))
    return SyncScan(valid, start, cfo_bins, tau,
                    ub.astype(jnp.int32), db.astype(jnp.int32))


# ---------------------------------------------------------------------------
# Batched block receiver: scan + frame extraction + demod in ONE program
# ---------------------------------------------------------------------------

class BlockFrames(NamedTuple):
    """Up to ``max_frames`` demodulated frames per channel from one block."""

    found: jnp.ndarray      # [..., K] bool
    start: jnp.ndarray      # [..., K] int32 frame-start sample index
    cfo_bins: jnp.ndarray   # [..., K] int32 integer CFO
    symbols: jnp.ndarray    # [..., K, n_payload] uint16 payload symbols
    sync: jnp.ndarray       # [..., K] uint8 recovered sync word
    cfo: jnp.ndarray        # [..., K] float32 residual (fractional) CFO
    time_offset: jnp.ndarray  # [..., K] float32
    snr_db: jnp.ndarray     # [..., K] float32 mean payload peak/noise (dB)
    sro_ppm: jnp.ndarray    # [..., K] float32 clock-drift estimate (ppm)


def _kth_valid(valid, k_max: int):
    """Positions of the first ``k_max`` True entries along the last axis.

    Returns (pos [..., K] int32, found [..., K] bool) — the run-free
    analogue of the host 'find next frame' loop, via a rank cumsum.
    """
    rank = jnp.cumsum(valid.astype(jnp.int32), axis=-1)      # [..., W]
    ks = jnp.arange(1, k_max + 1, dtype=jnp.int32)           # [K]
    match = valid[..., None, :] & (rank[..., None, :] == ks[..., :, None])
    found = jnp.any(match, axis=-1)                          # [..., K]
    pos = jnp.argmax(match, axis=-1).astype(jnp.int32)       # [..., K]
    return pos, found


def _gather_window_rows(rows, widx0, nwin: int, step: int):
    """Gather ``nwin`` CONSECUTIVE step-rows per frame as ONE contiguous
    slab (``lax.gather`` with ``slice_sizes=(nwin, step)``) instead of
    ``nwin`` separate row slices: 48 x 512 B descriptors per frame
    become one ~24 KB DMA — 3.96 -> 2.70 ms for the both-plane gather at
    the bench shape (round 4, tools/probe_block_gather.py; the vmapped
    ``dynamic_slice`` spelling of the same slab is 25.6 ms, and element
    gathers are off the chart — CLAUDE.md).

    ``rows`` ``[*lead, R, step]`` pre-padded row view; ``widx0``
    ``[*lead, K]`` first row per frame; returns ``[*lead, K, nwin,
    step]``.  Callers pad >= 2 front rows and ``nwin + 2`` tail rows and
    the scan keeps ``start >= -step``, so the window never reaches
    either end and the start-clamp is semantically identical to the old
    per-row clip (bit-identical outputs, gated by the circular/barrel
    equality tests)."""
    nb = widx0.ndim - 1
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(nb + 1, nb + 2),
        collapsed_slice_dims=(),
        start_index_map=(nb,),
        operand_batching_dims=tuple(range(nb)),
        start_indices_batching_dims=tuple(range(nb)))
    st = jnp.clip(widx0, 0, rows.shape[-2] - nwin)
    return jax.lax.gather(rows, st[..., None], dn,
                          slice_sizes=(1,) * nb + (nwin, step),
                          mode=jax.lax.GatherScatterMode.CLIP)


def _circ_wrap_const(params: LoraParams):
    """``c[t+step]*conj(c[t])`` of the base upchirp lattice — the window
    wrap constant of the circular extraction (trace-time numpy).

    The integer-lattice chirp ``exp(j*pi*(t^2+t)/n)`` is ANTI-periodic
    over one window (``c[t+n] = -c[t]``: the phase advances by
    ``2*pi*t + pi*(n+1)``, and n is even) — so the circular select's
    wrap region, whose samples physically sit one window later in the
    stream, carries this constant relative to the grid-aligned dechirp
    reference. Returns ``(s0 complex, ok bool)``; ``ok`` is False when
    the lattice is not (anti)periodic (non-integer ``scale`` makes the
    ``2*pi*t*scale`` term survive), in which case the circular fast
    path must not be used."""
    from ..ops.chirp import gen_chirp_np

    step = params.step
    up2, _ = gen_chirp_np(params.n, params.osr, 2 * step, 0.0, down=False,
                          ampl=1.0, bw_scale=params.scale)
    s = up2[step:] * np.conj(up2[:step])
    s0 = complex(s[0])
    ok = bool(np.max(np.abs(s - s0)) < 1e-5)
    return s0, ok


def _receive_block_circular(xr, xi, params: LoraParams,
                            n_payload_symbols: int, max_frames: int,
                            preamble_len: int, start, cfo_bins, found,
                            tx_phase_step: float | None = None,
                            with_spectra: bool = False):
    """Shift-free window extraction + demod (osr=1, rectangular window).

    The barrel shifter costs log2(step) full passes over the per-frame
    window buffer (~9.6 of the 16.7 ms block receive at the bench shape,
    measured round 3); here it disappears entirely. Two exact identities
    replace the data movement (docs/SEMANTICS.md "circular extraction"):

    1. A true symbol window starting ``q`` samples into grid window ``m``
       equals the circular right-shift by ``q`` of the elementwise select
       ``w'[j] = j < q ? g[m+1][j] : g[m][j]`` — no lane movement.
    2. The base chirp is n-periodic (integer lattice, osr=1), so the
       dechirped w' is the aligned dechirped window circularly shifted by
       ``q`` AND frequency-shifted by ``-q`` bins (the chirp-phase ratio
       ``c[j-q]*conj(c[j])`` is a linear ramp): its |DFT| is the aligned
       spectrum rotated by exactly ``q`` integer bins. Detection corrects
       the argmax index arithmetically; nothing in the data moves.

    The integer-CFO time-domain derotation (cos/sin over the whole
    window buffer) folds into the same index correction: skipping a
    derotation by ``c`` bins rotates every spectrum by ``+c``, so
    decisions read ``(raw + q_section - c) mod n``. The fractional
    residual IS still compensated in time domain — but evaluated at the
    TRUE sample index ``(j - q) mod n`` (a per-frame [K, n] factor, not
    a per-sample [K, win_len] one), otherwise the wrap region would
    carry a ``2*pi*resid`` phase discontinuity and leak.

    Exactness notes: magnitudes (decisions, SNR, probe scores, SRO) are
    bit-level rotations of the aligned path's; complex DFT values carry
    an extra per-frame constant phase, so phase-difference estimators
    (preamble fine term) are invariant and float outputs agree to ulps.
    Argmax TIES resolve in rotated order (real peaks never tie; the
    equal-power contract gates the demodulate path, not this receiver).
    """
    from ..ops.planar import (_preamble_phase_step, argmax_bins_planar,
                              dft_mag2_planar, estimate_preamble_planar,
                              estimate_sro_planar)
    from .stream import frame_overhead_samples

    n, osr, step = params.n, params.osr, params.step
    assert osr == 1 and step == n
    lead = xr.shape[:-1]
    T = xr.shape[-1]
    pre_len = preamble_len * step
    overhead = frame_overhead_samples(params, preamble_len)
    ov_w, dq = overhead // step, overhead % step      # payload grid offset
    win_full = overhead + n_payload_symbols * step
    nwin_g = win_full // step + 4

    w0 = jnp.floor_divide(start, step)    # >= -1 (scan keeps start >= -step)
    q = jnp.mod(start, step)              # circular residual, [..., K]

    def gather_rows(plane):
        tail = (nwin_g + 2) * step + (-T) % step
        # front pad of 2 windows: the buffer starts one window BEFORE the
        # candidate so the probe can test the -step hypothesis
        pad = jnp.pad(plane,
                      [(0, 0)] * (plane.ndim - 1) + [(2 * step, tail)])
        rows = pad.reshape(*lead, -1, step)
        return _gather_window_rows(rows, w0 + 1, nwin_g,
                                   step)        # [..., K, nwin_g, step]

    g_r, g_i = gather_rows(xr), gather_rows(xi)

    jj = jnp.arange(step, dtype=jnp.int32)
    qq = q[..., None, None]
    # payload grid: the 2.25-downchirp SFD puts the payload dq = step/4
    # past the window grid; the carry bumps its base window by one
    q_p = q + dq
    cp = (q_p >= step).astype(jnp.int32)
    q_p = q_p - cp * step
    qqp = q_p[..., None, None]

    dr0, di0 = base_downchirp_planar(params.sf, params.scale, params.osr)
    dr0, di0 = jnp.asarray(dr0), jnp.asarray(di0)

    # wrap constant: samples selected from the NEXT grid window sit one
    # window later in the stream, where the anti-periodic lattice chirp
    # has flipped sign relative to the per-window dechirp reference —
    # pre-multiply them by conj(s0) so the dechirped w' is an exact
    # single ramp (without it the tone splits half-a-bin, measured)
    s0, _ = _circ_wrap_const(params)
    s0r, s0i = jnp.float32(s0.real), jnp.float32(s0.imag)

    def circ_select(wr_, wi_, nr_, ni_, m):
        """w'[j] = j<q ? conj(s0)*next[j] : cur[j] (planar, fused)."""
        return (jnp.where(m, nr_ * s0r + ni_ * s0i, wr_),
                jnp.where(m, ni_ * s0r - nr_ * s0i, wi_))

    # --- run-end disambiguation probes (same contract as the barrel
    # path: 2 windows x 3 hypotheses, peak magnitudes are rotation- and
    # CFO-invariant). Each probe window is a single circular select.
    def _probe(m, down: bool):
        sr, si_ = circ_select(g_r[..., m, :], g_i[..., m, :],
                              g_r[..., m + 1, :], g_i[..., m + 1, :],
                              jj < qq[..., 0])
        if down:      # x * conj(down): concentrates downchirps
            ur, ui = sr * dr0 + si_ * di0, si_ * dr0 - sr * di0
        else:         # x * down: concentrates upchirps
            ur, ui = sr * dr0 - si_ * di0, si_ * dr0 + sr * di0
        _, pk = argmax_bins_planar(ur, ui, n, with_peak=True)
        return pk

    def hyp_score(woff):
        return (_probe(woff + preamble_len + 1, down=False)
                + _probe(woff + preamble_len + 2, down=True))

    scores = jnp.stack([hyp_score(1), hyp_score(0), hyp_score(2)])
    hyp = jnp.argmax(scores, axis=0)                   # [..., K] in {0,1,2}
    start = start + jnp.where(hyp == 1, -step,
                              jnp.where(hyp == 2, step, 0))
    found = found & (start >= 0)      # unrescued negative-start alias
    payload_start = start + overhead
    found = found & (payload_start + n_payload_symbols * step <= T)
    woff = jnp.where(hyp == 1, 0, jnp.where(hyp == 2, 2, 1))

    def hyp_pick(gp, base, ln, sel, nsel):
        """gp windows [base+sel .. base+sel+ln) for dynamic sel."""
        out = gp[..., base + nsel - 1: base + nsel - 1 + ln, :]
        for b in range(nsel - 2, -1, -1):
            out = jnp.where(sel[..., None, None] == b,
                            gp[..., base + b: base + b + ln, :], out)
        return out

    def section(base, ln, qsel, sel, nsel):
        """[..., K, ln, step] true windows (rotated by qsel) at window
        ``base + sel``: hypothesis pick first (narrow), then the
        circular select against the +1-row halo."""
        pr_ = hyp_pick(g_r, base, ln + 1, sel, nsel)
        pi_ = hyp_pick(g_i, base, ln + 1, sel, nsel)
        return circ_select(pr_[..., :-1, :], pi_[..., :-1, :],
                           pr_[..., 1:, :], pi_[..., 1:, :], jj < qsel)

    ps_r, ps_i = section(0, preamble_len + 2, qq, woff, 3)      # pre+sync
    pd_r, pd_i = section(ov_w, n_payload_symbols, qqp, woff + cp, 4)

    def dech(a_r, a_i):     # up-dechirp: x * down
        return a_r * dr0 - a_i * di0, a_r * di0 + a_i * dr0

    ps_r, ps_i = dech(ps_r, ps_i)
    pd_r, pd_i = dech(pd_r, pd_i)

    # residual fractional CFO from the rotated preamble spectra: the
    # expected tone sits at (cfo_bins - q) mod n, and the estimator
    # re-centers its signed wrap there and reports relative to it
    _pps = (tx_phase_step if tx_phase_step is not None
            else _preamble_phase_step(params.sf, params.osr, params.scale))
    b0 = jnp.mod(cfo_bins - q, n)
    cfo_resid = estimate_preamble_planar(
        ps_r[..., :preamble_len, :].reshape(*lead, max_frames, pre_len),
        ps_i[..., :preamble_len, :].reshape(*lead, max_frames, pre_len),
        n, osr, phase_step=_pps, bin_offset=b0)

    # fractional derotation at the TRUE sample index (j - q) mod n —
    # [K, n] cos/sin per section instead of [K, win_len]
    rate = (-jnp.float32(2.0 * math.pi) * cfo_resid
            / jnp.float32(n)).astype(jnp.float32)

    def rot_factor(qs):
        idx_true = (jj - qs[..., None]
                    + jnp.where(jj < qs[..., None], n, 0)).astype(jnp.float32)
        ph = rate[..., None] * idx_true
        return jnp.cos(ph), jnp.sin(ph)                # [..., K, n]

    def rot(a_r, a_i, c_, s_):
        c_, s_ = c_[..., None, :], s_[..., None, :]
        return a_r * c_ - a_i * s_, a_r * s_ + a_i * c_

    ca, sa = rot_factor(q)
    cb, sb_ = rot_factor(q_p)
    sy_r, sy_i = rot(ps_r[..., preamble_len:, :],
                     ps_i[..., preamble_len:, :], ca, sa)
    pl_r, pl_i = rot(pd_r, pd_i, cb, sb_)
    fr = jnp.concatenate([sy_r, pl_r], axis=-2)
    fi = jnp.concatenate([sy_i, pl_i], axis=-2)
    mag2 = dft_mag2_planar(fr, fi, n)                  # [..., K, 2+S, n]

    # index correction: spectra are rotated by the circular residual and
    # by the (skipped) integer-CFO derotation — raw = s + c - q_section.
    # At chirp slope ``scale`` > 1 (BW250/500) the payload grid's
    # quarter-window offset dq rotates every payload tone by an EXTRA
    # dq*(scale-1) bins that the slope-1 index arithmetic misses
    # (measured: constant bin offset -32*(scale-1) mod n, q-independent;
    # the barrel path extracts true samples and has no such term) —
    # fold it into the payload correction. Exact no-op at BW125.
    raw = jnp.argmax(mag2, axis=-1).astype(jnp.int32)
    dq_rot = int(round((dq // osr) * (params.scale - 1.0)))
    corr_s = jnp.mod(q - cfo_bins, n)[..., None]
    corr_p = jnp.mod(q_p - cfo_bins + dq_rot, n)[..., None]
    s_idx = jnp.arange(2 + n_payload_symbols, dtype=jnp.int32)
    bins = jnp.mod(raw + jnp.where(s_idx < 2, corr_s, corr_p), n)
    shift = (params.sf - 4) if params.sf > 4 else 0
    hi = (bins[..., 0] >> shift) & 0x0F
    lo = (bins[..., 1] >> shift) & 0x0F
    sync_word = ((hi << 4) | lo).astype(jnp.uint8)
    syms = bins[..., 2:].astype(jnp.uint16)

    mag2_pay = mag2[..., 2:, :]
    peak = jnp.max(mag2_pay, axis=-1)                  # [..., K, S]
    noise = (jnp.sum(mag2_pay, axis=-1) - peak) / jnp.float32(n - 1)
    snr_db = 10.0 * jnp.log10(
        jnp.mean(peak, axis=-1) / jnp.maximum(jnp.mean(noise, axis=-1), 1e-30)
    )
    sro_ppm = estimate_sro_planar(
        pd_r.reshape(*lead, max_frames, n_payload_symbols * step),
        pd_i.reshape(*lead, max_frames, n_payload_symbols * step), params)
    blk = BlockFrames(found, start, cfo_bins, syms, sync_word,
                      cfo_resid, jnp.zeros_like(cfo_resid),
                      snr_db.astype(jnp.float32), sro_ppm)
    if not with_spectra:
        return blk
    # un-scramble the payload spectra to TRUE bin order for the soft
    # path: power of true bin v sits at rotated index (v - corr_p) mod n
    # (decisions above read the inverse map). Small opt-in gather —
    # [K, S, n] per channel, never on the bench-gated decision path.
    v = jnp.arange(n, dtype=jnp.int32)
    idx = jnp.mod(v - corr_p, n)[..., None, :]             # [..., K, 1, n]
    spectra = jnp.take_along_axis(
        mag2_pay, jnp.broadcast_to(idx, mag2_pay.shape), axis=-1)
    return blk, spectra


@partial(jax.jit, static_argnames=("params", "n_payload_symbols",
                                   "max_frames", "preamble_len",
                                   "min_power_db", "pre_acc",
                                   "tx_phase_step", "with_spectra"))
def receive_block_planar(xr, xi, params: LoraParams,
                         n_payload_symbols: int, max_frames: int = 4,
                         preamble_len: int = 8,
                         min_power_db: float | None = None,
                         pre_acc: int = 1,
                         tx_phase_step: float | None = None,
                         with_spectra: bool = False) -> BlockFrames:
    """Demodulate every frame in a continuous block, fully on-device.

    One jit over ``[..., channels, T]`` planes: the two-sided dechirp
    scan, selection of up to ``max_frames`` candidates per channel (rank
    cumsum instead of the host rescan loop), per-candidate window
    extraction (contiguous-row gather + barrel shift — see the inline
    note; per-frame dynamic slices cost ~5 us EACH on this chip and
    dominated the program), integer-CFO derotation with continuous phase
    across the sync/payload sections (same contract as the serial
    ``stream.frame_demodulate``), external dechirp, and the working demod
    path. Host code only reads the resulting ``BlockFrames``.

    ``tx_phase_step`` overrides the transmitter's deterministic
    inter-symbol preamble phase delta assumed by the fine-CFO estimator
    (default: our lattice modulator's, via ``_preamble_phase_step``).
    Pass ``0.0`` for gr-lora_sdr transmitters — same contract as
    ``stream.frame_demodulate``.

    ``with_spectra=True`` additionally returns the per-frame payload
    spectra ``[..., K, n_payload, n]`` in TRUE bin order, row-aligned
    with ``BlockFrames.symbols`` (``argmax(spectra) == symbols``): the
    soft-decision input (models/soft.py, gr_interop.decode_bins
    ``mag2=``). |DFT|² in the default modes; the noncoherent combining
    scores under ``pre_acc > 1`` (the statistic the decisions use).
    Opt-in — materialising mesh-wide spectra costs bandwidth the
    decision-only path deliberately avoids.
    """
    from ..ops.planar import demodulate_planar, dechirp_planar
    from .stream import frame_overhead_samples

    n, osr, step = params.n, params.osr, params.step
    lead = xr.shape[:-1]
    T = xr.shape[-1]

    scan = frame_sync_scan_planar(xr, xi, params, preamble_len,
                                  min_power_db=min_power_db,
                                  pre_acc=pre_acc)
    pos, found = _kth_valid(scan.valid, max_frames)           # [..., K]

    def pick(field):
        return jnp.take_along_axis(field, pos, axis=-1)

    start = pick(scan.start)                                  # [..., K]
    cfo_bins = pick(scan.cfo_bins)

    from .modem import _window_table

    if (osr == 1 and pre_acc == 1 and _window_table(params) is None
            and _circ_wrap_const(params)[1]):
        # shift-free circular extraction: the barrel shifter and the
        # integer-CFO derotation both fold into index arithmetic
        # (measured 16.7 -> see README block-rx row; docs/SEMANTICS.md)
        return _receive_block_circular(xr, xi, params, n_payload_symbols,
                                       max_frames, preamble_len,
                                       start, cfo_bins, found,
                                       tx_phase_step=tx_phase_step,
                                       with_spectra=with_spectra)

    # --- window extraction: row gather + barrel shift -------------------
    # Per-frame ``dynamic_slice`` costs ~5 us EACH on this chip
    # (serialized row DMA — modem._shifted_rows measured the same); at
    # channels x max_frames in the thousands that dominated the whole
    # program (82 ms block receive, ~70 in slicing+probes at 8x512
    # frames). Instead: (1) gather whole step-rows by index — a
    # contiguous-row gather lowers well (~4 ms same workload) — giving
    # each frame the stream from the window-grid point below ``start``;
    # (2) barrel-shift left by the sub-window residual (log2(step)
    # select stages, row-count independent — the unconditional-shift
    # caller _shifted_rows' notes anticipated); (3) every downstream
    # section and tau-probe window is then a STATIC slice.
    pre_len = preamble_len * step
    overhead = frame_overhead_samples(params, preamble_len)
    win_full = overhead + n_payload_symbols * step
    nwin_f = win_full // step + 4      # + shift row, +/- alt windows, margin
    w0 = jnp.floor_divide(start, step)   # >= -1 (scan keeps start >= -step)
    rsub = jnp.mod(start, step)

    def gather_shift(plane):
        tail = (nwin_f + 2) * step + (-T) % step
        # front pad of 2 windows: the gathered buffer starts one window
        # BEFORE the candidate so the probe can test the -step hypothesis
        pad = jnp.pad(plane,
                      [(0, 0)] * (plane.ndim - 1) + [(2 * step, tail)])
        rows = pad.reshape(*lead, -1, step)            # [..., W', step]
        g = _gather_window_rows(rows, w0 + 1, nwin_f,
                                step)                  # [..., K, nwin, step]
        x = g.reshape(*lead, max_frames, nwin_f * step)
        for b in range((step - 1).bit_length()):       # x[t] <- x[t + rsub]
            k = 1 << b
            on = ((rsub >> b) & 1).astype(bool)[..., None]
            sh = jnp.concatenate(
                [x[..., k:], jnp.zeros(x.shape[:-1] + (k,), x.dtype)], -1)
            x = jnp.where(on, sh, x)
        return x                                # x[t] = stream[start-step+t]

    gr_, gi_ = gather_shift(xr), gather_shift(xi)

    # --- run-end disambiguation (start - step / start / start + step) ---
    # The preamble run-end is fuzzy by a window whenever the frame's
    # arrival phase puts a window boundary near the middle of a symbol:
    # the mixed preamble|sync boundary window's argmax is a near-coin-
    # flip, and since `start` is derived from the run-END window, losing
    # the flip reports the frame a whole symbol early or late (tau stays
    # right — at an arrival phase of EXACTLY step/2 it additionally
    # sign-aliases, the worst case; accumulated scans smear the boundary
    # both ways). Resolve with a 2-window probe per hypothesis: at the
    # TRUE start, window 9 is the second sync UPCHIRP and window 10 the
    # first full SFD DOWNCHIRP, so up-dechirping one and down-dechirping
    # the other both concentrate (peak magnitude is CFO-invariant); a
    # start one symbol off loses one of the two (probing the SFD window
    # alone would tie: windows 10 AND 11 are both downchirps, and under
    # noise the tie is a coin flip). Probes are static slices of the
    # gathered buffer — cheap enough to run for EVERY frame. Ties prefer
    # the reported start (stack order below).
    dr0, di0 = base_downchirp_planar(params.sf, params.scale, params.osr)
    dr0, di0 = jnp.asarray(dr0), jnp.asarray(di0)

    # decimation phase: the reference's one-sample-early TX fold puts the
    # exact dechirped tone of every MODULATED symbol (sync word, payload;
    # the base-chirp preamble/SFD never fold) at phase osr-1 — phase 0
    # splits it into half-power twins at sym±1 and mis-decodes ~half the
    # alphabet (docs/SEMANTICS.md §TX fold). The serial demod path
    # self-heals via its estimated time offset; this receiver INJECTS
    # t_off=0 from the sample-accurate scan, so it must pick the phase.
    dec_phase = 0 if (params.continuous_chirp or osr == 1) else osr - 1

    def _probe(a, down: bool):
        sr = gr_[..., a:a + step]
        si_ = gi_[..., a:a + step]
        if down:      # x * conj(down): concentrates downchirps
            ur, ui = sr * dr0 + si_ * di0, si_ * dr0 - sr * di0
        else:         # x * down: concentrates upchirps
            ur, ui = sr * dr0 - si_ * di0, si_ * dr0 + sr * di0
        ur = ur.reshape(*lead, max_frames, n, osr)[..., dec_phase]
        ui = ui.reshape(*lead, max_frames, n, osr)[..., dec_phase]
        _, pk = argmax_bins_planar(ur, ui, n, with_peak=True)
        return pk

    def hyp_score(boff):
        return (_probe(boff + (preamble_len + 1) * step, down=False)
                + _probe(boff + (preamble_len + 2) * step, down=True))

    # buffer offsets {step, 0, 2*step} = time offsets {0, -step, +step};
    # argmax takes the FIRST max, so exact ties keep the reported start
    scores = jnp.stack([hyp_score(step), hyp_score(0), hyp_score(2 * step)])
    hyp = jnp.argmax(scores, axis=0)                   # [..., K] in {0,1,2}
    start = start + jnp.where(hyp == 1, -step,
                              jnp.where(hyp == 2, step, 0))
    found = found & (start >= 0)      # unrescued negative-start alias
    # -------------------------------------------------------------------

    # --- sub-osr timing refinement (osr>1) ------------------------------
    # The scan's tau rides integer argmax bins, so start is quantized to
    # the osr-sample lattice (a half-bin arrival rounds +-osr/2; the
    # tolerant run-end adds up to +-1 bin = +-osr). The residual ``e``
    # makes the fold's decimation lattice (dec_phase = osr-1) inexact
    # and splits modulated tones. Measure it exactly from the two-sided
    # fractional split — up-dechirped PURE preamble windows sit at
    # -e/osr bins off the integer CFO, the down-dechirped first full SFD
    # window at +e/osr (measured: e = (d_dn - d_up) * osr/2, exact on
    # the lattice) — then micro-shift the gathered buffer by e.
    if osr > 1 and pre_acc == 1:
        from ..ops.planar import detect_planar

        boff_e = (jnp.where(hyp == 1, 0, jnp.where(hyp == 2, 2, 1))
                  * step)[..., None]

        def _disp(a_off, down: bool):
            def pick_win(buf):
                early = buf[..., a_off:a_off + step]
                mid = buf[..., a_off + step:a_off + 2 * step]
                late = buf[..., a_off + 2 * step:a_off + 3 * step]
                return jnp.where(boff_e == 0, early,
                                 jnp.where(boff_e == 2 * step, late, mid))

            sr = pick_win(gr_)
            si_ = pick_win(gi_)
            if down:
                ur, ui = sr * dr0 + si_ * di0, si_ * dr0 - sr * di0
            else:
                ur, ui = sr * dr0 - si_ * di0, si_ * dr0 + sr * di0
            vr = ur.reshape(*lead, max_frames, n, osr)[..., dec_phase]
            vi = ui.reshape(*lead, max_frames, n, osr)[..., dec_phase]
            det = detect_planar(vr, vi, n)
            dd = jnp.mod(det.index - cfo_bins + n // 2, n) - n // 2
            return dd.astype(jnp.float32) + det.findex

        d_up = 0.5 * (_disp(3 * step, down=False)
                      + _disp(5 * step, down=False))
        d_dn = _disp((preamble_len + 2) * step, down=True)
        # bins-per-sample is scale/osr at chirp slope ``scale`` (same
        # scaling as the scan's tau arm above); no-op at BW125
        e = jnp.clip(jnp.round((d_dn - d_up) * (osr / (2.0 * params.scale))),
                     -osr, osr).astype(jnp.int32)
        start = start + e
        found = found & (start >= 0)
        s_amt = e + osr                                # in [0, 2*osr]

        def _micro_shift(x):
            xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(osr, osr)])
            for b in range((2 * osr).bit_length()):
                k = 1 << b
                on = ((s_amt >> b) & 1).astype(bool)[..., None]
                sh = jnp.concatenate(
                    [xp[..., k:],
                     jnp.zeros(xp.shape[:-1] + (k,), xp.dtype)], -1)
                xp = jnp.where(on, sh, xp)
            return xp[..., :x.shape[-1]]

        gr_, gi_ = _micro_shift(gr_), _micro_shift(gi_)
    # -------------------------------------------------------------------

    payload_start = start + overhead
    # a frame must fit inside the block
    fits = payload_start + n_payload_symbols * step <= T
    found = found & fits

    win_len = pre_len + (2 + n_payload_symbols) * step

    def window(buf):
        """[..., K, L] gathered stream -> [..., K, win_len]:
        preamble ++ sync (2) ++ payload, at the winning hypothesis."""
        boff = (jnp.where(hyp == 1, 0, jnp.where(hyp == 2, 2, 1))
                * step)[..., None]

        def sec(a, ln):
            early = buf[..., a:a + ln]
            mid = buf[..., a + step:a + step + ln]
            late = buf[..., a + 2 * step:a + 2 * step + ln]
            return jnp.where(boff == 0, early,
                             jnp.where(boff == 2 * step, late, mid))

        return jnp.concatenate(
            [sec(0, pre_len), sec(pre_len, 2 * step),
             sec(overhead, n_payload_symbols * step)], axis=-1)

    wr = window(gr_)
    wi = window(gi_)

    # integer-CFO derotation, continuous phase over the window (the
    # contract validated by the serial receiver, stream.frame_demodulate).
    # (A step-periodic [K, step] cos/sin table broadcast over the symbol
    # axis was measured SLOWER here — the [.., 1, step]-rank broadcast
    # triggers the layout rotation documented in CLAUDE.md: 34 vs 29 ms.)
    idx = jnp.arange(win_len, dtype=jnp.float32)
    ph = (-2.0 * math.pi / step) * cfo_bins.astype(jnp.float32)[..., None] * idx
    c, s = jnp.cos(ph), jnp.sin(ph)
    dr = wr * c - wi * s
    di = wr * s + wi * c

    yr, yi = dechirp_planar(dr, di, params)
    # residual fractional CFO anchored on the preamble section — unbiased
    # for any sync word (ops.planar.estimate_preamble_planar)
    from ..ops.planar import (_preamble_phase_step,
                              demodulate_spectrum_planar,
                              estimate_preamble_planar)

    _pps = (tx_phase_step if tx_phase_step is not None
            else _preamble_phase_step(params.sf, params.osr, params.scale))
    if pre_acc == 1:
        cfo_resid = estimate_preamble_planar(
            yr[..., :pre_len], yi[..., :pre_len], n, osr, phase_step=_pps)
        sig = None
    else:
        # multipath-robust mode: per-window argmaxes alternate between
        # path bins and bias the plain estimator's coarse mean by a bin
        # or two (every decision then shifts); the common-bin variant
        # locks to the strongest path. The accumulated spectrum doubles
        # as the combining signature below (one DFT pass, shared).
        from ..ops.planar import estimate_preamble_robust_planar

        cfo_resid, sig = estimate_preamble_robust_planar(
            yr[..., :pre_len], yi[..., :pre_len], n, osr, phase_step=_pps,
            return_acc=True)
    # the spectrum variant of the same demod pipeline: decisions are the
    # argmax of mag2 (identical to demodulate_planar), and the spectra
    # yield the per-frame SNR observable (peak vs residual power, the
    # detector's dB convention, LoRaDetector.hpp:60-64)
    if pre_acc == 1:
        mag2, sync_word, cfo, time_offset = demodulate_spectrum_planar(
            yr[..., pre_len:], yi[..., pre_len:], params,
            known_offsets=(cfo_resid, jnp.zeros_like(cfo_resid)),
            dec_phase=dec_phase,
        )
    else:
        # noncoherent path combining: correlate every symbol's |DFT|²
        # against the frame's own accumulated preamble signature
        # (circular cross-correlation via the DFT backend). Phase-free,
        # so it is immune to the echo's symbol-dependent dechirped phase
        # that makes coherent RAKE combining impossible here (CLAUDE.md
        # dead end), and fractional CFO shifts signature and payload
        # spectra identically, so it cancels — no derotation stage.
        # Combining gain vs single-peak argmax: up to
        # 10*log10(P_total/P_strongest) on a faded/echoed channel.
        from ..ops.planar import dft_mag2_planar, dft_planar

        s_tot = 2 + n_payload_symbols
        vw_r = yr[..., pre_len:].reshape(
            *lead, max_frames, s_tot, n, osr)[..., dec_phase]
        vw_i = yi[..., pre_len:].reshape(
            *lead, max_frames, s_tot, n, osr)[..., dec_phase]
        m2 = dft_mag2_planar(vw_r, vw_i, n)
        mr, mi = dft_planar(m2, jnp.zeros_like(m2), n)
        sr_, si_ = dft_planar(sig, jnp.zeros_like(sig), n)
        cr_ = mr * sr_[..., None, :] + mi * si_[..., None, :]
        ci_ = mi * sr_[..., None, :] - mr * si_[..., None, :]
        score, _ = dft_planar(cr_, -ci_, n)    # IDFT(M*conj(S)).real * n
        sb2 = jnp.argmax(score[..., :2, :], axis=-1).astype(jnp.int32)
        shift = (params.sf - 4) if params.sf > 4 else 0
        sync_word = ((((sb2[..., 0] >> shift) & 0xF) << 4)
                     | ((sb2[..., 1] >> shift) & 0xF)).astype(jnp.uint8)
        mag2 = score[..., 2:, :]
        cfo = cfo_resid
        time_offset = jnp.zeros_like(cfo_resid)
    syms = jnp.argmax(mag2, axis=-1).astype(jnp.uint16)
    # the SNR observable keeps the detector's |DFT|² dB convention in
    # BOTH modes (correlation scores carry a signature-dependent scale
    # and baseline, so they are not comparable across runs)
    snr_src = m2[..., 2:, :] if pre_acc > 1 else mag2
    peak = jnp.max(snr_src, axis=-1)                       # [..., K, S]
    noise = (jnp.sum(snr_src, axis=-1) - peak) / jnp.float32(n - 1)
    snr_db = 10.0 * jnp.log10(
        jnp.mean(peak, axis=-1) / jnp.maximum(jnp.mean(noise, axis=-1), 1e-30)
    )
    # per-frame clock-drift observable over the CONTIGUOUS payload
    # section only (the sliced window skips the 2.25 downchirps, so a
    # sync->payload first difference would cross a time gap)
    from ..ops.planar import estimate_sro_planar

    sro_ppm = estimate_sro_planar(yr[..., pre_len + 2 * step:],
                                  yi[..., pre_len + 2 * step:], params)
    blk = BlockFrames(found, start, cfo_bins, syms, sync_word,
                      cfo, time_offset, snr_db.astype(jnp.float32),
                      sro_ppm)
    if with_spectra:
        # already TRUE bin order on this path (decisions are its argmax)
        return blk, mag2
    return blk


@partial(jax.jit, static_argnames=("params", "stride"))
def cad_planar(xr, xi, params: LoraParams, stride: int = 4,
               threshold_db: float = -30.0):
    """Channel-activity detection: the SX126x CAD primitive (a 1-2 symbol
    listen that Semtech radios use for listen-before-talk), batched over
    ``[..., T]`` planes. Every ``stride``-th symbol window is up-dechirped
    and DFT'd; a window is *active* when its peak power clears
    ``threshold_db`` (the detector's dB convention, LoRaDetector.hpp:60-64:
    0 dB = full-scale chirp). Any LoRa chirp — preamble, sync or payload,
    any CFO — concentrates into one bin; noise and silence spread.

    ``stride`` makes it a cheap pre-gate: at stride 4 the DFT matmul
    touches a quarter of the stream, and a frame (preamble alone is 8
    windows) still lights several probed windows. Returns
    ``(active [...]-bool, peak_db [...]-float32 max probed window power)``.
    """
    n, osr, step = params.n, params.osr, params.step
    nwin = xr.shape[-1] // step
    lead = xr.shape[:-1]
    if nwin < 1:                   # sub-symbol input: nothing to listen to
        return (jnp.zeros(lead, bool),
                jnp.full(lead, -np.inf, jnp.float32))
    stride = min(stride, nwin)     # short buffers: probe what exists
    probe = nwin // stride

    ar = xr[..., : probe * stride * step].reshape(*lead, probe, stride, step)
    ai = xi[..., : probe * stride * step].reshape(*lead, probe, stride, step)
    ar, ai = ar[..., 0, :], ai[..., 0, :]           # every stride-th window

    dr, di = base_downchirp_planar(params.sf, params.scale, params.osr)
    dr, di = jnp.asarray(dr), jnp.asarray(di)
    ur = (ar * dr - ai * di).reshape(*lead, probe, n, osr)[..., 0]
    ui = (ar * di + ai * dr).reshape(*lead, probe, n, osr)[..., 0]
    _, peak = argmax_bins_planar(ur, ui, n, with_peak=True)
    peak_db = (10.0 * jnp.log10(jnp.maximum(peak, 1e-30))
               - 20.0 * math.log10(n))
    best = jnp.max(peak_db, axis=-1)
    return best >= jnp.float32(threshold_db), best


def block_rows(blk: BlockFrames) -> list[dict]:
    """Host-side rows of a 1-D (single-channel) BlockFrames, one dict per
    found frame — the shared extractor behind the SIC loop and the
    streaming CLI."""
    found = np.asarray(blk.found)
    rows = []
    for k in np.flatnonzero(found):
        k = int(k)
        rows.append({
            "k": k,
            "start": int(np.asarray(blk.start)[k]),
            "cfo_bins": int(np.asarray(blk.cfo_bins)[k]),
            "cfo": float(np.asarray(blk.cfo)[k]),
            "sync": int(np.asarray(blk.sync)[k]),
            "snr_db": float(np.asarray(blk.snr_db)[k]),
            "sro_ppm": float(np.asarray(blk.sro_ppm)[k]),
            "symbols": np.asarray(blk.symbols)[k],
        })
    return rows


def receive_blind_planar(xr, xi, base_params: LoraParams,
                         n_payload_symbols: int,
                         sfs=(7, 8, 9, 10, 11, 12), max_frames: int = 4,
                         preamble_len: int = 8,
                         min_power_db: float | None = -30.0,
                         pre_acc: int = 1):
    """Blind spreading-factor receive: run the device-side block receiver
    at every candidate SF over the SAME ``[..., T]`` planes and return
    ``{sf: BlockFrames}``.

    No blind-SF mode exists upstream (the reference assumes a known SF,
    phy.cpp:13-18 even re-derives it from the FFT plan size; gr-lora_sdr
    receivers are fixed-SF too). Discrimination comes from the scan
    itself: dechirping with the wrong SF's downchirp spreads a chirp's
    energy across the spectrum, so the equal-bin preamble run + SFD
    down-dominance test only fires at the true SF (gated further by
    ``min_power_db``). Each SF is one jit (cached per shape); SFs whose
    symbol period cannot hold a preamble inside ``T`` are omitted.

    ``n_payload_symbols`` is SF-independent in the simple chain
    (2 symbols/byte, LoRaEncoder.cpp:6-18).
    """
    import dataclasses

    out = {}
    t = xr.shape[-1]
    for sf in sfs:
        p = dataclasses.replace(base_params, sf=sf)
        if t // p.step < preamble_len + 4:       # preamble + SFD can't fit
            continue
        out[sf] = receive_block_planar(
            xr, xi, p, n_payload_symbols, max_frames, preamble_len,
            min_power_db, pre_acc=pre_acc,
        )
    return out


def blind_frames(results) -> list[dict]:
    """Flatten :func:`receive_blind_planar` output to a host-side list of
    found frames, sorted by (leading index..., start): each entry is a
    dict with ``sf``, ``index`` (leading-dim tuple, () for 1-D), ``k``
    (candidate slot), ``start``, ``sync``, ``cfo_bins``, ``snr_db`` and
    the ``symbols`` row (numpy)."""
    rows = []
    for sf, blk in results.items():
        found = np.asarray(blk.found)
        for flat in np.flatnonzero(found):
            idx = np.unravel_index(flat, found.shape)
            lead, k = idx[:-1], idx[-1]
            rows.append({
                "sf": sf,
                "index": tuple(int(i) for i in lead),
                "k": int(k),
                "start": int(np.asarray(blk.start)[idx]),
                "sync": int(np.asarray(blk.sync)[idx]),
                "cfo_bins": int(np.asarray(blk.cfo_bins)[idx]),
                "snr_db": float(np.asarray(blk.snr_db)[idx]),
                "sro_ppm": float(np.asarray(blk.sro_ppm)[idx]),
                "symbols": np.asarray(blk.symbols)[idx],
            })
    rows.sort(key=lambda r: (r["index"], r["start"], r["sf"]))
    return rows


@partial(jax.jit, static_argnames=("k", "params", "n_payload_symbols",
                                   "max_frames", "preamble_len",
                                   "taps_per_branch", "min_power_db",
                                   "pre_acc", "tx_phase_step",
                                   "with_spectra"))
def receive_wideband_planar(xr, xi, k: int, params: LoraParams,
                            n_payload_symbols: int, max_frames: int = 4,
                            preamble_len: int = 8,
                            taps_per_branch: int = 7,
                            min_power_db: float | None = -30.0,
                            pre_acc: int = 1,
                            tx_phase_step: float | None = None,
                            with_spectra: bool = False) -> BlockFrames:
    """One-call wideband receiver, fully on-device: polyphase-channelize a
    ``[..., T]`` wideband stream into ``k`` sub-channels and run the
    batched block receiver on every channel in the same program.
    Returns :class:`BlockFrames` with a leading channel axis
    ``[..., k, max_frames]``. Complex-free throughout (planar float32).
    ``min_power_db`` (default -30 dB, the Pothos demod examples' thresh)
    keeps quiet channels from syncing on silence or stopband leakage."""
    from ..ops.channelizer import channelize_planar

    cr, ci = channelize_planar(xr, xi, k, taps_per_branch)
    return receive_block_planar(cr, ci, params, n_payload_symbols,
                                max_frames, preamble_len,
                                min_power_db=min_power_db, pre_acc=pre_acc,
                                tx_phase_step=tx_phase_step,
                                with_spectra=with_spectra)
