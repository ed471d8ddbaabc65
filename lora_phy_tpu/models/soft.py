"""Soft-decision coded-chain decoding.

The reference decodes hard argmax bins only (syndrome decoding,
LoRaCodes.hpp:250-334; detect-only parity for CR 4/5-4/6) — no soft path
exists upstream. This module adds one: per-symbol max-log bit
LLRs come straight out of the demodulator's |DFT|² spectra
(ops.planar.demodulate_spectrum_planar) as masked max-reductions, ride
the *same* diagonal-deinterleave gather maps as the hard path
(ops.coding._deinterleave_map applied to float LLR lanes instead of
bits), and FEC decoding becomes a maximum-likelihood correlation against
the 16-entry codeword book — one [.., nbits] @ [nbits, 16] matmul.

Gains over hard decisions: the ML correlator *corrects* errors even for
the detect-only CR 4/5 and 4/6 parity codes (the hard path can only
flag them), and buys the classic soft-decoding SNR margin for CR 4/7-4/8
(gated statistically in tests/test_soft.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import coding
from .coded import CodedConfig, _fec_encode

_NEG = jnp.float32(-3.4e38)
_mm = functools.partial(jnp.matmul, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)


@functools.lru_cache(maxsize=64)
def _bit_masks(n: int, ppm: int, shift: int, offset: int = 0) -> np.ndarray:
    """[ppm, N] bool: bit ``j`` of the data word carried by bin ``b``.

    Word = binary_to_gray(round(((b - offset) mod N) / 2^shift)) — the RX
    mapping (models/coded.py decode_payload; rounding, matching the hard
    demaps: a -1 bin drift keeps its word); ``shift=2`` for LDRO/
    reduced-rate blocks where the two LSB bins carry no data,
    ``offset=1`` for gr-lora_sdr's full-rate -1 bin convention
    (models/gr_interop.py)."""
    b = ((np.arange(n, dtype=np.int32) - offset) % n).astype(np.uint16)
    if shift:
        b = ((b + (1 << (shift - 1))) >> shift) % (n >> shift)
    w = np.asarray(coding.binary_to_gray(jnp.asarray(b))).astype(np.uint32)
    j = np.arange(ppm, dtype=np.uint32)[:, None]
    return ((w[None, :] >> j) & 1).astype(bool)


@functools.lru_cache(maxsize=16)
def _codebook(cr: int) -> np.ndarray:
    """[nbits, 16] float32 antipodal (±1) codeword book for ML scoring,
    LSB-first bit order (matching coding.unpack_bits)."""
    nib = np.arange(16, dtype=np.uint8)
    cw = np.asarray(_fec_encode(jnp.asarray(nib), cr)).astype(np.uint32)
    nbits = 4 + {1: 1, 2: 2, 3: 3, 4: 4}[cr]
    j = np.arange(nbits, dtype=np.uint32)[:, None]
    bits = ((cw[None, :] >> j) & 1).astype(np.float32)
    return 2.0 * bits - 1.0                               # [nbits, 16]


def bin_llrs(mag2, ppm: int, shift: int, offset: int = 0):
    """[..., S, N] symbol spectra -> [..., S, ppm] max-log bit LLRs for
    an explicit bin->word mapping (see :func:`_bit_masks`).

    ``LLR_j = max_{bin: bit_j=1} |X| - max_{bin: bit_j=0} |X|`` — two
    masked max-reductions per bit over the spectrum magnitude (the
    matched-filter statistic).

    Inputs are clamped at zero before the sqrt: the block receiver's
    ``with_spectra`` output under ``pre_acc > 1`` is the noncoherent
    combining score (an IDFT correlation), whose near-zero bins can
    round slightly negative in f32 — without the clamp a single such
    bin poisons every masked max with NaN. Those scores are a
    |DFT|⁴-scale statistic, so soft decoding on them is argmax-
    consistent but its LLR magnitudes are distorted; the calibrated
    soft path remains the default (pre_acc=1) |DFT|² spectra."""
    mag2 = jnp.asarray(mag2)
    n = mag2.shape[-1]
    masks = jnp.asarray(_bit_masks(n, ppm, shift, offset))
    m = jnp.sqrt(jnp.maximum(mag2, 0.0))[..., None, :]    # [..., S, 1, N]
    one = jnp.max(jnp.where(masks, m, _NEG), axis=-1)     # [..., S, ppm]
    zero = jnp.max(jnp.where(~masks, m, _NEG), axis=-1)
    return (one - zero).astype(jnp.float32)


def symbol_llrs(mag2, cfg: CodedConfig):
    """[..., S, N] symbol spectra -> [..., S, ppm] max-log bit LLRs for
    this framework's coded chain (models/coded.py bin mapping)."""
    return bin_llrs(mag2, cfg.ppm, 2 if cfg.ldro else 0)


def ml_decode(cw_llrs, cr: int):
    """[..., ncw, nbits] codeword-bit LLRs -> ([..., ncw] nibbles,
    [..., ncw] correlation margins) via the 16-entry ML codebook."""
    cb = jnp.asarray(_codebook(cr))
    scores = _mm(jnp.asarray(cw_llrs), cb)
    nibbles = jnp.argmax(scores, axis=-1).astype(jnp.uint8)
    top2 = jnp.sort(scores, axis=-1)[..., -2:]
    return nibbles, (top2[..., 1] - top2[..., 0])


def deinterleave_llrs(llrs, ppm: int, rdd: int):
    """[..., S, ppm] symbol-bit LLRs -> [..., S//(4+rdd)*ppm, 4+rdd]
    codeword-bit LLRs — the hard deinterleaver's gather map applied to
    float lanes (reference: LoRaCodes.hpp:396-412)."""
    nbits = 4 + rdd
    s = llrs.shape[-2]
    nblk = s // nbits
    lead = llrs.shape[:-2]
    flat = llrs[..., : nblk * nbits, :].reshape(*lead, nblk, nbits * ppm)
    sel = jnp.take(flat, jnp.asarray(coding._deinterleave_map(ppm, rdd)),
                   axis=-1)
    return sel.reshape(*lead, nblk * ppm, nbits)


@functools.lru_cache(maxsize=16)
def _hamming84_bin_onehot(n: int, scale: int = 1) -> np.ndarray:
    """[n, 16] float32 one-hot columns at each valid Hamming(8,4)
    codeword's demodulated bin (``cw * scale mod n`` — bw_scale aliases
    bins at BW250/500, docs/SEMANTICS.md). Distinctness is guaranteed by
    the code's minimum distance (4): two codewords colliding mod 128
    would have to differ only in bit 7 — checked anyway."""
    from ..ops import coding as _coding
    import jax.numpy as _jnp

    cw = np.asarray(_coding.hamming84_encode(
        _jnp.arange(16, dtype=_jnp.uint8))).astype(np.int64)
    bins = (cw * scale) % n
    if len(set(int(b) for b in bins)) != 16:
        raise ValueError(f"codeword bins collide at n={n}, scale={scale}")
    oh = np.zeros((n, 16), np.float32)
    oh[bins, np.arange(16)] = 1.0
    return oh


def hamming84_ml_decode(mag2, scale: int = 1):
    """Maximum-likelihood soft detection for the SIMPLE Hamming(8,4)
    chain (reference: LoRaEncoder/LoRaDecoder.cpp): ``[..., 2B, N]``
    payload-symbol spectra -> ``[..., B]`` bytes.

    The hard path takes an unconstrained argmax over all N bins and then
    syndrome-corrects (modem.decode); here the argmax is CONSTRAINED to
    the 16 bins that carry valid codewords — one ``[.., N] @ [N, 16]``
    matmul (masked pick, no gathers) + argmax — so noise peaks at
    non-codeword bins are redirected to the best valid codeword instead
    of relying on single-bit syndrome correction. The classic soft-
    decision gain for the chain the reference actually ships (no soft
    path exists upstream); the coded chain's LLR path is
    :func:`decode_payload_soft`. Feed it ``receive_block_planar(...,
    with_spectra=True)`` spectra or ``demodulate_spectrum_planar`` mag2.
    ``scale``: ``int(params.scale)`` for BW250/500 bin aliasing."""
    mag2 = jnp.asarray(mag2)
    n = mag2.shape[-1]
    s = mag2.shape[-2] - (mag2.shape[-2] % 2)
    scores = _mm(mag2[..., :s, :],
                 jnp.asarray(_hamming84_bin_onehot(n, scale)))
    nibbles = jnp.argmax(scores, axis=-1).astype(jnp.uint8)
    return coding.nibbles_to_bytes(nibbles)


def decode_payload_soft(mag2, nbytes: int, cfg: CodedConfig):
    """[..., S, N] data-symbol spectra -> (payload, crc_ok, min_score).

    Soft twin of models.coded.decode_payload: LLRs -> deinterleave -> ML
    codeword correlation -> nibbles -> bytes -> dewhiten -> CRC.
    ``min_score`` is the weakest codeword correlation margin (a soft
    quality observable; larger is more confident)."""
    llrs = symbol_llrs(mag2, cfg)
    cw_llrs = deinterleave_llrs(llrs, cfg.ppm, cfg.rdd)   # [..., ncw, nbits]
    nibbles, margin = ml_decode(cw_llrs, cfg.cr)
    total = nbytes + (2 if cfg.crc else 0)
    nibbles = nibbles[..., : total * 2]
    framed = coding.nibbles_to_bytes(nibbles)
    if cfg.whiten:
        framed = coding.whiten_sx1272_lfsr(framed, 0, 4)
    payload = framed[..., :nbytes]
    if cfg.crc:
        provided = framed[..., -2].astype(jnp.uint16) | (
            framed[..., -1].astype(jnp.uint16) << 8
        )
        crc_ok = provided == coding.crc16_sx1272(payload)
    else:
        crc_ok = jnp.ones(payload.shape[:-1], dtype=bool)
    min_score = jnp.min(margin[..., : total * 2], axis=-1)
    return payload, crc_ok, min_score
