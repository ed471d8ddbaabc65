"""AWGN channel simulation — the executable spec of the reference's
``tests/awgn_sweep.py`` (SURVEY.md §3.5), re-designed as a batched JAX
program: all packets of an SNR point are simulated in one tensor pass
(packets x symbols x N) instead of the reference's per-symbol Python loop.

Model contract (reference: tests/awgn_sweep.py:233-273):
  chirp  = exp(j*cumsum(-pi + 2*pi*n/N)), down = conj(up)
  tx     = up * exp(j*2*pi*sym*n/N) + AWGN(sigma = 10**(-snr/20))
  rx_sym = argmax |FFT(rx * down)|
FEC: CR 4/5 parity54 (detect-only) or 4/8 Hamming84 (single-error
correction), LSB-first bit packing into sf-bit symbols
(awgn_sweep.py:159-215).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import coding
from ..ops.chirp import model_chirps
from ..ops.detect import detect
from ..ops.impair import apply_awgn


class SweepPoint(NamedTuple):
    snr_db: float
    ber: float
    per: float


def encode_payload_bits(payload, cr: str):
    """[..., B] bytes -> [..., bits] LSB-first codeword bit stream
    (reference: awgn_sweep.py:159-174)."""
    nibbles = coding.bytes_to_nibbles(payload)
    if cr == "4/5":
        cw, width = coding.parity54_encode(nibbles), 5
    elif cr == "4/6":
        cw, width = coding.parity64_encode(nibbles), 6
    elif cr == "4/7":
        cw, width = coding.hamming74_encode(nibbles), 7
    elif cr == "4/8":
        cw, width = coding.hamming84_encode(nibbles), 8
    else:
        raise ValueError(f"Unsupported coding rate: {cr}")
    bits = coding.unpack_bits(cw.astype(jnp.int32), width)
    return bits.reshape(*bits.shape[:-2], -1)


def decode_payload_bits(bits, cr: str, num_bytes: int):
    """Inverse of :func:`encode_payload_bits` (awgn_sweep.py:177-202)."""
    width = {"4/5": 5, "4/6": 6, "4/7": 7, "4/8": 8}[cr]
    cw_bits = bits[..., : num_bytes * 2 * width].reshape(
        *bits.shape[:-1], num_bytes * 2, width
    )
    cw = coding.pack_bits(cw_bits, dtype=jnp.uint8)
    if cr in ("4/5", "4/6"):
        nibbles = (cw & 0xF).astype(jnp.uint8)   # detect-only codes
    elif cr == "4/7":
        nibbles, _ = coding.hamming74_decode(cw)
    else:
        nibbles, _, _ = coding.hamming84_decode(cw)
    return coding.nibbles_to_bytes(nibbles)


def bits_to_symbols(bits, sf: int):
    """Pack LSB-first bits into sf-bit symbols, zero-padded tail
    (awgn_sweep.py:205-215)."""
    nbits = bits.shape[-1]
    nsym = -(-nbits // sf)
    pad = nsym * sf - nbits
    if pad:
        bits = jnp.concatenate(
            [bits, jnp.zeros(bits.shape[:-1] + (pad,), bits.dtype)], axis=-1
        )
    return coding.pack_bits(bits.reshape(*bits.shape[:-1], nsym, sf), dtype=jnp.uint16)


def symbols_to_bits(symbols, sf: int, bit_len: int):
    """Unpack symbols to LSB-first bits, truncated to ``bit_len``
    (awgn_sweep.py:218-225)."""
    bits = coding.unpack_bits(symbols.astype(jnp.int32), sf)
    return bits.reshape(*bits.shape[:-2], -1)[..., :bit_len]


@partial(jax.jit, static_argnames=("sf", "cr", "packets", "payload_len"))
def _simulate_point(key, snr_db, sf: int, cr: str, packets: int, payload_len: int):
    """One SNR point, all packets batched. Returns (bit_errors, packet_errors)."""
    n = 1 << sf
    up, down = model_chirps(sf)

    kp, kn = jax.random.split(key)
    payload = jax.random.randint(kp, (packets, payload_len), 0, 256, jnp.int32).astype(
        jnp.uint8
    )
    tx_bits = encode_payload_bits(payload, cr)
    symbols = bits_to_symbols(tx_bits, sf)                      # [P, S]
    nbits = tx_bits.shape[-1]

    idx = jnp.arange(n, dtype=jnp.float32)
    ph = (2.0 * math.pi / n) * symbols.astype(jnp.float32)[..., None] * idx
    tx = up * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))         # [P, S, N]
    rx = apply_awgn(kn, tx, jnp.asarray(snr_db, jnp.float32))

    det = detect(rx * down)
    rx_bits = symbols_to_bits(det.index, sf, nbits)
    rx_payload = decode_payload_bits(rx_bits, cr, payload_len)

    diff = jnp.bitwise_xor(payload, rx_payload)
    bit_errors = jnp.sum(coding.unpack_bits(diff.astype(jnp.int32), 8))
    packet_errors = jnp.sum(jnp.any(diff != 0, axis=-1))
    return bit_errors, packet_errors


def simulate(sf: int, cr: str, snr_db: float, packets: int, payload_len: int,
             seed: int = 0) -> SweepPoint:
    """BER/PER at one SNR point (reference: awgn_sweep.py:245-285)."""
    key = jax.random.PRNGKey(seed)
    bit_errors, packet_errors = _simulate_point(
        key, float(snr_db), sf, cr, packets, payload_len
    )
    total_bits = packets * payload_len * 8
    return SweepPoint(
        float(snr_db),
        float(bit_errors) / total_bits if total_bits else 0.0,
        float(packet_errors) / packets if packets else 0.0,
    )


def sweep(profiles, snr_start=0.0, snr_stop=12.0, snr_step=0.5,
          packets=100, payload_len=16, seed=0):
    """Full sweep over profiles; yields CSV-schema rows
    ``{sf, bw, cr, snr_db, ber, per}`` (reference: awgn_sweep.py:304-346)."""
    rows = []
    for p in profiles:
        snrs = np.arange(snr_start, snr_stop + 1e-9, snr_step)
        for i, snr in enumerate(snrs):
            pt = simulate(p.sf, p.cr, float(snr), packets, payload_len,
                          seed=seed + i)
            rows.append({
                "sf": p.sf, "bw": p.bw, "cr": p.cr,
                "snr_db": float(snr), "ber": pt.ber, "per": pt.per,
            })
    return rows


def write_csv(rows, path):
    import csv

    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["sf", "bw", "cr", "snr_db", "ber", "per"])
        w.writeheader()
        for r in rows:
            w.writerow(r)


# ---------------------------------------------------------------------------
# Planar Monte Carlo path (large batched sweeps, split re/im float32)
# ---------------------------------------------------------------------------

import functools


@functools.lru_cache(maxsize=8)
def _tone_tables(n: int):
    """[n, n] cos/sin float32 tables of ``exp(j*2*pi*s*i/n)`` — one row
    per symbol value; float64-built, so if anything CLOSER to the ideal
    tone than on-device float32 cos/sin of a float32 phase product."""
    k = np.arange(n, dtype=np.float64)
    ang = (2.0 * np.pi / n) * np.outer(k, k)
    return (np.cos(ang).astype(np.float32),
            np.sin(ang).astype(np.float32))

@partial(jax.jit, static_argnames=("sf", "cr", "packets", "payload_len"))
def _simulate_point_planar(key, snr_db, sf: int, cr: str, packets: int,
                           payload_len: int):
    """Planar twin of :func:`_simulate_point`: same model, split re/im
    float32 arithmetic and the matmul DFT, for large batched sweeps.

    Two reworks over the literal translation (same model, same
    decisions): (a) the per-sample tone synthesis
    ``exp(j*2*pi*sym*i/n)`` is a ROW GATHER from an [n, n] cos/sin
    table pair (symbols live in [0, n); a gather instead of per-sample
    transcendentals, as in the TX emitter, ops/chirp.py), and (b) detection is decision-only ``argmax_bins_planar`` (combined-
    matmul DFT + fused argmax) instead of the full ``detect_planar``
    metric set, whose power/fIndex/peak-phase outputs this Monte Carlo
    never reads but whose masked reductions cost several full-spectrum
    passes."""
    from ..ops.planar import argmax_bins_planar
    from ..ops.chirp import model_chirps_planar

    n = 1 << sf
    up_re_np, up_im_np = model_chirps_planar(sf)
    up_re = jnp.asarray(up_re_np)
    up_im = jnp.asarray(up_im_np)

    kp, kr, ki = jax.random.split(key, 3)
    payload = jax.random.randint(kp, (packets, payload_len), 0, 256,
                                 jnp.int32).astype(jnp.uint8)
    tx_bits = encode_payload_bits(payload, cr)
    symbols = bits_to_symbols(tx_bits, sf)                  # [P, S]
    nbits = tx_bits.shape[-1]

    tc_np, ts_np = _tone_tables(n)
    sym_i = symbols.astype(jnp.int32)
    c = jnp.take(jnp.asarray(tc_np), sym_i, axis=0)         # [P, S, N]
    s = jnp.take(jnp.asarray(ts_np), sym_i, axis=0)
    tx_re = up_re * c - up_im * s                           # [P, S, N]
    tx_im = up_re * s + up_im * c

    sigma = 10.0 ** (-jnp.asarray(snr_db, jnp.float32) / 20.0)
    k2 = sigma / jnp.float32(math.sqrt(2.0))
    rx_re = tx_re + k2 * jax.random.normal(kr, tx_re.shape, jnp.float32)
    rx_im = tx_im + k2 * jax.random.normal(ki, tx_im.shape, jnp.float32)

    # dechirp by conj(up): (a+jb)(ur-jui) planar
    dr = rx_re * up_re + rx_im * up_im
    di = rx_im * up_re - rx_re * up_im
    rx_bits = symbols_to_bits(argmax_bins_planar(dr, di, n), sf, nbits)
    rx_payload = decode_payload_bits(rx_bits, cr, payload_len)

    diff = jnp.bitwise_xor(payload, rx_payload)
    bit_errors = jnp.sum(coding.unpack_bits(diff.astype(jnp.int32), 8))
    packet_errors = jnp.sum(jnp.any(diff != 0, axis=-1))
    return bit_errors, packet_errors


def simulate_planar(sf: int, cr: str, snr_db: float, packets: int,
                    payload_len: int, seed: int = 0) -> SweepPoint:
    """BER/PER at one SNR point via the planar path."""
    key = jax.random.PRNGKey(seed)
    bit_errors, packet_errors = _simulate_point_planar(
        key, float(snr_db), sf, cr, packets, payload_len
    )
    total_bits = packets * payload_len * 8
    return SweepPoint(
        float(snr_db),
        float(bit_errors) / total_bits if total_bits else 0.0,
        float(packet_errors) / packets if packets else 0.0,
    )
