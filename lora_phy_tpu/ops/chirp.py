"""Chirp synthesis — closed-form on an exact integer phase lattice.

The reference generates chirps with a sequential per-sample float32
phase/frequency accumulator (reference: include/lora_phy/ChirpGenerator.hpp:23-50)
and a phase-continuity carry across symbols (reference: src/phy/LoRaMod.cpp:8-43).
Sequential carries do not vectorize, so this module replaces them with a
closed form (SURVEY.md §5.7c) built on an exact integer lattice:

Let ``M = N*osr`` (steps per sweep) and ``fStep = 2*pi*bw_scale/(N*osr^2)``.
Every quantity in the reference recurrence is an integer multiple of
``fStep``:  ``fMin = -(M/2)*fStep*osr``... more precisely
``fMin/fStep = -M/2`` and the modulator's ``f0`` is ``sym*osr*fStep``
(src/phy/LoRaMod.cpp:36-37). The wrapped instantaneous frequency after
``k`` steps is ``fStep * (v_k - M/2)`` with ``v_k = ((sym*osr + k) mod M) + 1``,
and the phase is ``fStep * (S_k - (M/2)*(k+1))`` with ``S_k = cumsum(v)`` —
all int32. Since ``fStep * P = 2*pi`` exactly for ``P = N*osr^2/bw_scale``
(a power of two), phases reduce mod 2*pi *in integer arithmetic*, so the
synthesized chirp has zero accumulation drift — strictly more accurate
than the reference's float32 accumulator, with identical demodulated
symbols (parity is defined at symbol level per SEMANTIC_COMPATIBILITY.md).

The per-symbol phase carry is the constant ``delta = fStep*M/2`` for every
symbol, so the cross-symbol continuity chain collapses to
``s*(M/2) mod P`` — embarrassingly parallel over symbols. Outputs are
complex64 in [-1, 1] (SEMANTIC_COMPATIBILITY.md:6-14).
"""

from __future__ import annotations

import functools
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _lattice_period(n: int, osr: int, bw_scale: float) -> tuple[float, int]:
    """(fStep, P) with fStep * P == 2*pi exactly in the reals."""
    f_step = (2.0 * math.pi * bw_scale) / (n * osr * osr)
    p = n * osr * osr / bw_scale
    p_int = int(round(p))
    if abs(p - p_int) > 1e-9:
        raise ValueError(f"bw_scale {bw_scale} does not divide the lattice")
    return f_step, p_int


def gen_chirp(
    n: int,
    osr: int,
    nn: int,
    f0: float,
    down: bool,
    ampl: float = 1.0,
    phase0: float = 0.0,
    bw_scale: float = 1.0,
):
    """Host-side (NumPy, float64) equivalent of the reference ``genChirp``
    (ChirpGenerator.hpp:23-50) for arbitrary ``f0``. Used at trace time to
    build constants (base downchirps, fixtures).

    Returns ``(samples[nn] complex64, phase_accum_out float)`` where the
    phase accumulator output follows the reference's carry contract
    (ChirpGenerator.hpp:48).
    """
    samples, end = gen_chirp_np(n, osr, nn, f0, down, ampl, phase0, bw_scale)
    return jnp.asarray(samples), end


def gen_chirp_np(
    n: int,
    osr: int,
    nn: int,
    f0: float,
    down: bool,
    ampl: float = 1.0,
    phase0: float = 0.0,
    bw_scale: float = 1.0,
):
    """NumPy-only body of :func:`gen_chirp` (no device transfer — usable to
    build planar constants on complex-free backends)."""
    f_min = -math.pi * bw_scale / osr
    f_step = (2.0 * math.pi * bw_scale) / (n * osr * osr)
    m = n * osr
    k = np.arange(nn, dtype=np.float64)
    u = f0 / f_step + k + 1.0                     # in fStep units
    v = u - (np.ceil(u / m) - 1.0) * m            # wrapped into (0, M]
    f = f_min + v * f_step
    csum = np.cumsum(f)
    phase = phase0 + (-csum if down else csum)
    samples = (ampl * np.exp(1j * phase)).astype(np.complex64)
    end = float(phase[-1])
    end -= math.floor(end / (2 * math.pi)) * (2 * math.pi)
    return samples, end


def _chirp_phase(symbols, n: int, osr: int, bw_scale_x8: int,
                 continuous: bool = False, phase_carry: bool = True):
    """Shared integer-lattice phase for phase-continuous upchirps.

    ``symbols``: [..., S] int32 symbol values in [0, N). Returns the
    float32 phase array [..., S, N*osr] reproducing ``lora_modulate``'s
    continuity (LoRaMod.cpp:34-41) in closed form.

    The per-sample cumulative sum ``S_k = sum_{j<=k} (((w+j) mod M) + 1)``
    has the exact closed form (0 <= w < M, k < M, so at most one wrap per
    sample): ``S_k = (k+1)(w+1) + k(k+1)/2 - M*max(0, (k+1)-(M-w))`` —
    all int32, elementwise (no scan), bit-identical to the running sum.

    ``continuous=True`` moves the intra-symbol frequency fold ONE sample
    later. The reference's fold instant leaves the post-fold segment with
    a constant spurious phase of ``2*pi*bw_scale/osr`` (mod 2*pi; the
    lattice constant ``-M*(1+w-M) === -M`` mod P): invisible at osr=1
    (=== 0), but at osr=2 it is a pi jump that splits the dechirped tone
    into two equal half-power peaks at ``sym +/- 1`` — wrong-bin
    detections on a CLEAN channel for most symbol values. Shifting the
    fold to the natural unwrapped boundary makes the constant
    ``-M*(w-M) === 0`` (w is a multiple of osr), giving a mathematically
    exact single-bin tone after decimation for every symbol, and is
    BIT-IDENTICAL at osr=1 (real Semtech radios are phase-continuous;
    the defect is an artifact of the reference's software modulator).
    """
    bw_scale = bw_scale_x8 / 8.0
    f_step, p = _lattice_period(n, osr, bw_scale)
    m = n * osr
    half_m = m // 2
    # s_cum's int32 intermediates reach ~M^2; for M >= 46341 that wraps.
    # When P | 2^32 the wrap IS the modular reduction (exact); otherwise
    # the lattice silently corrupts — refuse instead (only reachable at
    # sf12 with non-power-of-two osr > 11, far beyond the profile matrix).
    if m >= 46341 and (1 << 32) % p != 0:
        raise ValueError(
            f"N*osr = {m} overflows the int32 phase lattice and its period "
            f"P = {p} does not divide 2^32; use a power-of-two osr")

    ks = jnp.arange(m, dtype=jnp.int32)
    w = (symbols.astype(jnp.int32) * osr)[..., None]       # [..., S, 1]
    k1 = ks + 1                                            # [M]
    off = 1 if continuous else 0
    wraps = jnp.maximum(0, k1[None, :] + w - m - off)      # [..., S, M]
    s_cum = k1 * (w + 1) + (ks * k1) // 2 - m * wraps      # <= M(M+1) < 2^31
    t_lattice = s_cum - half_m * k1                        # phase / fStep, int32

    # Cross-symbol carry: s-th symbol starts at phase fStep * (s*M/2 mod P)
    # (phase_carry=False: every symbol starts at phase 0 — the
    # gr-lora_sdr per-symbol-independent modulator convention)
    s_idx = jnp.arange(symbols.shape[-1], dtype=jnp.int32)
    carry = (s_idx * half_m) % p if phase_carry else jnp.zeros(
        symbols.shape[-1], jnp.int32)                      # [S]

    lattice = (carry[:, None] + t_lattice) % p             # [..., S, M] in [0, P)
    return lattice.astype(jnp.float32) * jnp.float32(f_step)


# Pure-gather TX: the modulated chirp for (symbol value w, slot index s)
# is cos/sin of fStep * ((carry_s + t_lattice[w, k]) mod P), and carry_s
# = s*(M/2) mod P cycles with period P/gcd(M/2, P) — tiny (2 at
# bw_scale 1, osr 1). So the WHOLE waveform space is a
# [period*N, M] cos + sin table pair, and modulation is one row gather
# per plane with zero device trig: ~5x the trig emitter on the chip
# (84.6 -> ~16 ms at the 554M-sample bench shape; transcendentals were
# the TX bottleneck, not bandwidth). Budget-gated per plane — large
# SF x osr x narrow-scale configs fall back to the closed-form trig
# path below.
_TX_TABLE_BUDGET_BYTES = 16 * 1024 * 1024


@functools.lru_cache(maxsize=8)
def _mod_chirp_tables(n: int, osr: int, bw_scale_x8: int, continuous: bool,
                      phase_carry: bool = True):
    """``(carry_period, cos_table, sin_table)`` with tables
    ``[period*N, M]`` float32 (row ``c*N + w`` = slot-class c, symbol w),
    or ``None`` when a table would exceed the per-plane budget.

    Built in float64 numpy from the SAME integer lattice as
    :func:`_chirp_phase` (int64 here, so no int32-overflow guard is
    needed); entries are cos/sin of the exactly-reduced lattice angle,
    so the table is, if anything, closer to the sequential float64
    oracle than the on-device float32 trig it replaces."""
    bw_scale = bw_scale_x8 / 8.0
    f_step, p = _lattice_period(n, osr, bw_scale)
    m = n * osr
    half_m = m // 2
    # phase_carry=False drops the cross-symbol continuity term entirely
    # (every symbol chirp starts at phase 0 — the gr-lora_sdr modulator
    # convention, which builds each symbol waveform independently):
    # carry period collapses to 1
    period = p // math.gcd(half_m, p) if phase_carry else 1
    # 2N value rows, not N: the simple chain's Hamming84 symbols are
    # 8-bit and alias mod N at SF7 BY DESIGN (values up to 255 at
    # N=128; CLAUDE.md) — and chirp(w) differs from chirp(w mod N) by
    # a constant lattice phase, so the aliased rows are tabulated from
    # the same closed form rather than folded (the float64-oracle gate
    # covers exactly these fixture symbols)
    n_rows = 2 * n
    if period * n_rows * m * 4 > _TX_TABLE_BUDGET_BYTES:
        return None
    ks = np.arange(m, dtype=np.int64)
    k1 = ks + 1
    w = (np.arange(n_rows, dtype=np.int64) * osr)[:, None]  # [2N, 1]
    off = 1 if continuous else 0
    wraps = np.maximum(0, k1[None, :] + w - m - off)
    s_cum = k1 * (w + 1) + (ks * k1) // 2 - m * wraps
    t_lat = s_cum - half_m * k1                            # [2N, M]
    carry = (np.arange(period, dtype=np.int64) * half_m) % p
    lat = (carry[:, None, None] + t_lat[None]) % p         # [period, 2N, M]
    ang = lat.astype(np.float64) * f_step
    return (period,
            np.cos(ang).astype(np.float32).reshape(period * n_rows, m),
            np.sin(ang).astype(np.float32).reshape(period * n_rows, m))


@partial(jax.jit, static_argnames=("n", "osr", "bw_scale_x8", "continuous",
                                   "phase_carry"))
def _mod_chirps(symbols, n: int, osr: int, bw_scale_x8: int, ampl,
                continuous: bool = False, phase_carry: bool = True):
    """Complex64 phase-continuous upchirps (see :func:`_chirp_phase`).

    Assembled from the planar twin's planes so the two emitters stay
    bit-identical by construction (table-gather or trig alike)."""
    re, im = _mod_chirps_planar(symbols, n, osr, bw_scale_x8, ampl,
                                continuous, phase_carry)
    return jax.lax.complex(re, im).astype(jnp.complex64)


@partial(jax.jit, static_argnames=("n", "osr", "bw_scale_x8", "continuous",
                                   "phase_carry"))
def _mod_chirps_planar(symbols, n: int, osr: int, bw_scale_x8: int, ampl,
                       continuous: bool = False, phase_carry: bool = True):
    """Planar (re, im float32) twin of :func:`_mod_chirps` — the TX path
    on split float32 planes (the deployment layout). Bit-identical planes
    to the complex emitter.

    Dispatches to the pure-gather table emitter when the
    :func:`_mod_chirp_tables` budget allows (the hot TX path: one row
    gather per plane, no device trig), else the closed-form lattice
    trig path. ``phase_carry=False`` emits every symbol chirp from
    phase 0 (the gr-lora_sdr per-symbol-independent convention)."""
    ampl = jnp.float32(ampl)
    # value contract is [0, 2N) (Hamming84 symbols alias mod N by design,
    # up to 2N-1); reduce mod 2N in BOTH emitters so the table-gather and
    # trig paths stay bit-identical for any out-of-contract input
    symbols = symbols.astype(jnp.int32) % (2 * n)
    tabs = _mod_chirp_tables(n, osr, bw_scale_x8, continuous, phase_carry)
    if tabs is None:
        phase = _chirp_phase(symbols, n, osr, bw_scale_x8, continuous,
                             phase_carry)
        return ampl * jnp.cos(phase), ampl * jnp.sin(phase)
    period, tc, ts = tabs
    s_idx = jnp.arange(symbols.shape[-1], dtype=jnp.int32) % period
    idx = symbols + 2 * n * s_idx
    re = jnp.take(jnp.asarray(tc), idx, axis=0, mode="clip")  # [..., S, M]
    im = jnp.take(jnp.asarray(ts), idx, axis=0, mode="clip")
    return ampl * re, ampl * im


def modulate_symbols(symbols, sf: int, osr: int, bw_scale: float,
                     ampl: float = 1.0, sync_word: int = 0x12,
                     continuous: bool = False, phase_carry: bool = True):
    """TX chain of ``lora_modulate`` (reference: src/phy/LoRaMod.cpp:8-43):
    2 sync-word upchirps followed by one upchirp per symbol, phase-continuous,
    amplitude clamped to [-1, 1].

    ``symbols``: [..., S] integer array. Returns [..., (S+2)*N*osr] complex64.
    ``phase_carry=False`` starts every symbol chirp at phase 0 (gr-lora_sdr
    builds each symbol waveform independently — models/gr_interop.py).
    """
    allsyms = _tx_symbol_plan(symbols, sf, sync_word)
    ampl = float(np.clip(ampl, -1.0, 1.0))
    bw8 = int(round(bw_scale * 8))
    chirps = _mod_chirps(allsyms, 1 << sf, osr, bw8, ampl, continuous,
                         phase_carry)
    return chirps.reshape(*chirps.shape[:-2], -1)


def _tx_symbol_plan(symbols, sf: int, sync_word: int):
    """Prepend the 2 sync-word upchirp symbols (LoRaMod.cpp:20-32)."""
    symbols = jnp.asarray(symbols)
    shift = (sf - 4) if sf > 4 else 0
    sw0 = ((sync_word >> 4) & 0xF) << shift
    sw1 = (sync_word & 0xF) << shift
    sync = jnp.broadcast_to(
        jnp.asarray([sw0, sw1], dtype=jnp.int32), symbols.shape[:-1] + (2,)
    )
    return jnp.concatenate([sync, symbols.astype(jnp.int32)], axis=-1)


def modulate_symbols_planar(symbols, sf: int, osr: int, bw_scale: float,
                            ampl: float = 1.0, sync_word: int = 0x12,
                            continuous: bool = False,
                            phase_carry: bool = True):
    """Planar twin of :func:`modulate_symbols` — the full ``lora_modulate``
    TX chain (src/phy/LoRaMod.cpp:8-43) emitting (re, im) float32 planes so
    the modulator runs with no complex dtype. Planes are bit-exact
    with ``split_complex(modulate_symbols(...))``.

    [..., S] -> ((re, im) each [..., (S+2)*N*osr] float32).
    """
    allsyms = _tx_symbol_plan(symbols, sf, sync_word)
    ampl = float(np.clip(ampl, -1.0, 1.0))
    bw8 = int(round(bw_scale * 8))
    re, im = _mod_chirps_planar(allsyms, 1 << sf, osr, bw8, ampl, continuous,
                                phase_carry)
    return (re.reshape(*re.shape[:-2], -1), im.reshape(*im.shape[:-2], -1))


def base_downchirp(sf: int, bw_scale: float = 1.0, osr: int = 1):
    """The canonical dechirp reference: ``genChirp(N, osr, N*osr, 0, down)``
    as used by the integrated demodulator (reference: src/phy/phy.cpp:203-204,
    always osr=1) and the e2e external-dechirp contract
    (tests/e2e_chain_test.cpp:85-87)."""
    n = 1 << sf
    samples, _ = gen_chirp(n, osr, n * osr, 0.0, down=True, ampl=1.0,
                           phase0=0.0, bw_scale=bw_scale)
    return samples


def base_downchirp_planar(sf: int, bw_scale: float = 1.0, osr: int = 1):
    """(re, im) float32 NumPy planes of :func:`base_downchirp` — trace-time
    constants for the planar dechirp (no complex device transfer)."""
    n = 1 << sf
    samples, _ = gen_chirp_np(n, osr, n * osr, 0.0, down=True, ampl=1.0,
                              phase0=0.0, bw_scale=bw_scale)
    return (np.ascontiguousarray(samples.real.astype(np.float32)),
            np.ascontiguousarray(samples.imag.astype(np.float32)))


def model_chirps(sf: int):
    """The pure-model up/down chirps of the AWGN executable spec
    (reference: tests/awgn_sweep.py:233-242):
    ``up = exp(j*cumsum(-pi + 2*pi*n/N))``, ``down = conj(up)``."""
    n = 1 << sf
    idx = np.arange(n, dtype=np.float64)
    phase = -math.pi + (2.0 * math.pi * idx) / n
    accum = np.cumsum(phase)
    up = np.exp(1j * accum).astype(np.complex64)
    return jnp.asarray(up), jnp.asarray(np.conj(up))


def model_chirps_planar(sf: int):
    """Planar (re, im float32 NumPy) variant of :func:`model_chirps` for
    accelerators without complex support."""
    n = 1 << sf
    idx = np.arange(n, dtype=np.float64)
    accum = np.cumsum(-math.pi + (2.0 * math.pi * idx) / n)
    return (np.cos(accum).astype(np.float32), np.sin(accum).astype(np.float32))
