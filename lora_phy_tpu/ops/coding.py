"""Bit-exact LoRa coding primitives, vectorized for accelerators.

Re-designs of the reference's scalar bit-twiddling loops
(reference: include/lora_phy/LoRaCodes.hpp) as array programs:

* Gray map / demap                -> xor-fold lattice ops (LoRaCodes.hpp:201-222)
* Hamming(8,4)/(7,4) SX variants  -> 16/256-entry LUT gathers (LoRaCodes.hpp:229-334)
* Parity 5/4 and 6/4              -> LUT gathers (LoRaCodes.hpp:340-371)
* Whitening x3 variants           -> precomputed keystream XOR (LoRaCodes.hpp:111-189)
* SX1272 CRC16                    -> per-position GF(2) LUT + XOR-reduce (LoRaCodes.hpp:69-105)
* header checksum / checksum8     -> vector xor network / tiny scan (LoRaCodes.hpp:32-67)
* diagonal (de)interleavers       -> static gather permutations (LoRaCodes.hpp:376-432)

All LUTs are built once at import time with NumPy from the same boolean
equations as the reference, so the mapping is bit-exact by construction.
Every public function accepts NumPy or JAX arrays and is jit/vmap friendly
(static shapes, gathers, no data-dependent Python control flow).
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

__all__ = [
    "binary_to_gray",
    "gray_to_binary",
    "hamming84_encode",
    "hamming84_decode",
    "hamming74_encode",
    "hamming74_decode",
    "parity54_encode",
    "parity54_check",
    "parity64_encode",
    "parity64_check",
    "whiten_sx1232",
    "whiten_sx1272_seq",
    "whiten_sx1272_lfsr",
    "crc16_sx1272",
    "header_checksum",
    "checksum8",
    "diagonal_interleave",
    "diagonal_deinterleave",
    "diagonal_deinterleave_v2",
    "bytes_to_nibbles",
    "nibbles_to_bytes",
    "unpack_bits",
    "pack_bits",
]


# ---------------------------------------------------------------------------
# Bit helpers (LSB-first, per SEMANTIC_COMPATIBILITY.md:12)
# ---------------------------------------------------------------------------

def unpack_bits(x, nbits: int):
    """LSB-first bit unpack: [...,] ints -> [..., nbits] in {0,1}."""
    x = jnp.asarray(x)
    shifts = jnp.arange(nbits, dtype=x.dtype)
    return (x[..., None] >> shifts) & 1


def pack_bits(bits, dtype=jnp.uint16):
    """LSB-first bit pack: [..., nbits] -> [...] ints."""
    bits = jnp.asarray(bits).astype(jnp.uint32)
    nbits = bits.shape[-1]
    shifts = jnp.arange(nbits, dtype=jnp.uint32)
    return jnp.sum(bits << shifts, axis=-1).astype(dtype)


def bytes_to_nibbles(data):
    """Bytes -> interleaved (hi, lo) nibble stream, one byte -> two nibbles.

    Matches the encoder's nibble order (reference: src/phy/LoRaEncoder.cpp:12-15).
    """
    data = jnp.asarray(data, dtype=jnp.uint8)
    hi = (data >> 4) & 0x0F
    lo = data & 0x0F
    return jnp.stack([hi, lo], axis=-1).reshape(*data.shape[:-1], -1)


def nibbles_to_bytes(nibbles):
    """Inverse of :func:`bytes_to_nibbles` (reference: src/phy/LoRaDecoder.cpp:13-16)."""
    nibbles = jnp.asarray(nibbles, dtype=jnp.uint8)
    pairs = nibbles.reshape(*nibbles.shape[:-1], -1, 2)
    return ((pairs[..., 0] & 0x0F) << 4) | (pairs[..., 1] & 0x0F)


def _take(lut: np.ndarray, idx):
    """LUT gather that works for both NumPy and traced JAX indices."""
    return jnp.take(jnp.asarray(lut), jnp.asarray(idx).astype(jnp.int32), axis=0)


# ---------------------------------------------------------------------------
# Gray code (reference: LoRaCodes.hpp:201-222)
# ---------------------------------------------------------------------------

def binary_to_gray(num):
    """Reflected binary Gray code, 16-bit (reference: LoRaCodes.hpp:201-207)."""
    num = jnp.asarray(num, dtype=jnp.uint16)
    return num ^ (num >> 1)


def gray_to_binary(num):
    """Gray -> binary via 4-step xor fold (reference: LoRaCodes.hpp:212-222)."""
    num = jnp.asarray(num, dtype=jnp.uint16)
    num = num ^ (num >> 8)
    num = num ^ (num >> 4)
    num = num ^ (num >> 2)
    num = num ^ (num >> 1)
    return num


# ---------------------------------------------------------------------------
# Hamming / parity LUT construction (NumPy, import time)
# ---------------------------------------------------------------------------

def _bit(x, i):
    return (x >> i) & 1


def _build_hamming84_enc() -> np.ndarray:
    lut = np.zeros(16, dtype=np.uint8)
    for x in range(16):
        d0, d1, d2, d3 = _bit(x, 0), _bit(x, 1), _bit(x, 2), _bit(x, 3)
        b = x & 0xF
        b |= (d0 ^ d1 ^ d2) << 4
        b |= (d1 ^ d2 ^ d3) << 5
        b |= (d0 ^ d1 ^ d3) << 6
        b |= (d0 ^ d2 ^ d3) << 7
        lut[x] = b
    return lut


def _build_hamming84_dec() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """256-entry decode LUT -> (nibble, error, bad) per LoRaCodes.hpp:250-281."""
    nib = np.zeros(256, dtype=np.uint8)
    err = np.zeros(256, dtype=np.bool_)
    bad = np.zeros(256, dtype=np.bool_)
    for b in range(256):
        b0, b1, b2, b3 = _bit(b, 0), _bit(b, 1), _bit(b, 2), _bit(b, 3)
        b4, b5, b6, b7 = _bit(b, 4), _bit(b, 5), _bit(b, 6), _bit(b, 7)
        p0 = b0 ^ b1 ^ b2 ^ b4
        p1 = b1 ^ b2 ^ b3 ^ b5
        p2 = b0 ^ b1 ^ b3 ^ b6
        p3 = b0 ^ b2 ^ b3 ^ b7
        parity = (p0 << 0) | (p1 << 1) | (p2 << 2) | (p3 << 3)
        err[b] = parity != 0
        if parity == 0xD:
            nib[b] = (b ^ 1) & 0xF
        elif parity == 0x7:
            nib[b] = (b ^ 2) & 0xF
        elif parity == 0xB:
            nib[b] = (b ^ 4) & 0xF
        elif parity == 0xE:
            nib[b] = (b ^ 8) & 0xF
        elif parity in (0x0, 0x1, 0x2, 0x4, 0x8):
            nib[b] = b & 0xF
        else:
            bad[b] = True
            nib[b] = b & 0xF
    return nib, err, bad


def _build_hamming74_enc() -> np.ndarray:
    lut = np.zeros(16, dtype=np.uint8)
    for x in range(16):
        d0, d1, d2, d3 = _bit(x, 0), _bit(x, 1), _bit(x, 2), _bit(x, 3)
        b = x & 0xF
        b |= (d0 ^ d1 ^ d2) << 4
        b |= (d1 ^ d2 ^ d3) << 5
        b |= (d0 ^ d1 ^ d3) << 6
        lut[x] = b
    return lut


def _build_hamming74_dec() -> tuple[np.ndarray, np.ndarray]:
    """128-entry decode LUT -> (nibble, error) per LoRaCodes.hpp:306-334."""
    nib = np.zeros(128, dtype=np.uint8)
    err = np.zeros(128, dtype=np.bool_)
    for b in range(128):
        b0, b1, b2, b3 = _bit(b, 0), _bit(b, 1), _bit(b, 2), _bit(b, 3)
        b4, b5, b6 = _bit(b, 4), _bit(b, 5), _bit(b, 6)
        p0 = b0 ^ b1 ^ b2 ^ b4
        p1 = b1 ^ b2 ^ b3 ^ b5
        p2 = b0 ^ b1 ^ b3 ^ b6
        parity = (p0 << 0) | (p1 << 1) | (p2 << 2)
        err[b] = parity != 0
        if parity == 0x5:
            nib[b] = (b ^ 1) & 0xF
        elif parity == 0x7:
            nib[b] = (b ^ 2) & 0xF
        elif parity == 0x3:
            nib[b] = (b ^ 4) & 0xF
        elif parity == 0x6:
            nib[b] = (b ^ 8) & 0xF
        else:
            nib[b] = b & 0xF
    return nib, err


def _build_parity54() -> tuple[np.ndarray, np.ndarray]:
    """(encode LUT[16], check-error LUT[32]) per LoRaCodes.hpp:340-351."""
    enc = np.zeros(16, dtype=np.uint8)
    for b in range(16):
        x = b ^ (b >> 2)
        x = x ^ (x >> 1)
        enc[b] = (b & 0xF) | ((x << 4) & 0x10)
    chk_err = np.zeros(32, dtype=np.bool_)
    for b in range(32):
        x = b ^ (b >> 2)
        x = x ^ (x >> 1) ^ (b >> 4)
        chk_err[b] = bool(x & 1)
    return enc, chk_err


def _build_parity64() -> tuple[np.ndarray, np.ndarray]:
    """(encode LUT[16], check-error LUT[64]) per LoRaCodes.hpp:357-371."""
    enc = np.zeros(16, dtype=np.uint8)
    for b in range(16):
        x = b ^ (b >> 1) ^ (b >> 2)
        y = x ^ b ^ (b >> 3)
        enc[b] = ((x & 1) << 4) | ((y & 1) << 5) | (b & 0xF)
    chk_err = np.zeros(64, dtype=np.bool_)
    for b in range(64):
        x = b ^ (b >> 1) ^ (b >> 2)
        y = x ^ b ^ (b >> 3)
        x ^= b >> 4
        y ^= b >> 5
        chk_err[b] = bool((x | y) & 1)
    return enc, chk_err


_H84_ENC = _build_hamming84_enc()
_H84_DEC_NIB, _H84_DEC_ERR, _H84_DEC_BAD = _build_hamming84_dec()
_H74_ENC = _build_hamming74_enc()
_H74_DEC_NIB, _H74_DEC_ERR = _build_hamming74_dec()
_P54_ENC, _P54_CHK_ERR = _build_parity54()
_P64_ENC, _P64_CHK_ERR = _build_parity64()


def hamming84_encode(nibbles):
    """Hamming(8,4) SX-variant encode (reference: LoRaCodes.hpp:229-242)."""
    return _take(_H84_ENC, jnp.asarray(nibbles) & 0xF)


def hamming84_decode(codewords):
    """Hamming(8,4) decode with single-error correction.

    Returns ``(nibbles, error, bad)`` (reference: LoRaCodes.hpp:250-281).
    """
    cw = jnp.asarray(codewords).astype(jnp.int32) & 0xFF
    return _take(_H84_DEC_NIB, cw), _take(_H84_DEC_ERR, cw), _take(_H84_DEC_BAD, cw)


def hamming74_encode(nibbles):
    """Hamming(7,4) SX-variant encode (reference: LoRaCodes.hpp:287-299)."""
    return _take(_H74_ENC, jnp.asarray(nibbles) & 0xF)


def hamming74_decode(codewords):
    """Hamming(7,4) decode. Returns ``(nibbles, error)`` (LoRaCodes.hpp:306-334)."""
    cw = jnp.asarray(codewords).astype(jnp.int32) & 0x7F
    return _take(_H74_DEC_NIB, cw), _take(_H74_DEC_ERR, cw)


def parity54_encode(nibbles):
    """5/4 single-parity encode (reference: LoRaCodes.hpp:347-351)."""
    return _take(_P54_ENC, jnp.asarray(nibbles) & 0xF)


def parity54_check(codewords):
    """5/4 parity check. Returns ``(nibbles, error)`` (LoRaCodes.hpp:340-345)."""
    cw = jnp.asarray(codewords).astype(jnp.int32) & 0x1F
    return (jnp.asarray(cw) & 0xF).astype(jnp.uint8), _take(_P54_CHK_ERR, cw)


def parity64_encode(nibbles):
    """6/4 double-parity encode (reference: LoRaCodes.hpp:367-371)."""
    return _take(_P64_ENC, jnp.asarray(nibbles) & 0xF)


def parity64_check(codewords):
    """6/4 parity check. Returns ``(nibbles, error)`` (LoRaCodes.hpp:357-365)."""
    cw = jnp.asarray(codewords).astype(jnp.int32) & 0x3F
    return (jnp.asarray(cw) & 0xF).astype(jnp.uint8), _take(_P64_CHK_ERR, cw)


# ---------------------------------------------------------------------------
# Whitening keystreams (precomputed at import; reference: LoRaCodes.hpp:111-189)
# ---------------------------------------------------------------------------

_WHITEN_MAX = 4096  # longest supported whitening run, in bytes


def _build_sx1232_stream(n: int) -> np.ndarray:
    """Semtech AN1200.18 LFSR x^9+x^5+1 seed 0x1FF keystream
    (reference: LoRaCodes.hpp:111-137). Output byte j is the LSB byte of the
    LFSR state before the 8-bit shift for byte j."""
    out = np.zeros(n, dtype=np.uint8)
    msb, lsb = 0x01, 0xFF
    for j in range(n):
        out[j] = lsb
        for _ in range(8):
            msb_prev = msb
            msb = (lsb & 0x01) ^ ((lsb >> 5) & 0x01)
            lsb = ((lsb >> 1) & 0xFF) | ((msb_prev << 7) & 0x80)
    return out


def _build_sx1272_seq_bits() -> np.ndarray:
    """The 510-bit whitening sequence table (reference: LoRaCodes.hpp:150-154)."""
    whiten_seq = np.array(
        [
            0x0102291EA751AAFF, 0xD24B050A8D643A17, 0x5B279B671120B8F4,
            0x032B37B9F6FB55A2, 0x994E0F87E95E2D16, 0x7CBCFC7631984C26,
            0x281C8E4F0DAEF7F9, 0x1741886EB7733B15,
        ],
        dtype=np.uint64,
    )
    t = np.arange(512, dtype=np.uint64)
    bits = (whiten_seq[(t >> np.uint64(6)).astype(int)] >> (t & np.uint64(0x3F))) & np.uint64(1)
    return bits[:510].astype(np.uint8)


def _build_sx1272_lfsr_stream(rdd_is_one: bool, n: int) -> np.ndarray:
    """Interleaved dual 64-bit LFSR keystream, poly 0x1D
    (reference: LoRaCodes.hpp:176-189). Entry k is the byte consumed at
    global step k (before masking with ``0xff >> (4 - RDD)``)."""
    if rdd_is_one:
        r = [0x05121100F8ECFEEF, 0xF8ECFEEFEFEFEFEF]
    else:
        r = [0x6572D100E85C2EFF, 0xE85C2EFFFFFFFFFF]
    mask64 = (1 << 64) - 1
    out = np.zeros(n, dtype=np.uint8)
    for k in range(n):
        s = r[k & 1]
        out[k] = s & 0xFF
        r[k & 1] = ((s >> 8) | ((((s >> 32) ^ (s >> 24) ^ (s >> 16) ^ s) << 56) & mask64)) & mask64
    return out


_SX1232_STREAM = _build_sx1232_stream(_WHITEN_MAX)
_SX1272_SEQ_BITS = _build_sx1272_seq_bits()
_SX1272_OFS0 = np.array([6, 4, 2, 0, -112, -114, -302, -34], dtype=np.int64)
_SX1272_OFS1 = np.array([6, 4, 2, 0, -360], dtype=np.int64)
_SX1272_LFSR_STREAMS = {
    True: _build_sx1272_lfsr_stream(True, _WHITEN_MAX),
    False: _build_sx1272_lfsr_stream(False, _WHITEN_MAX),
}


def whiten_sx1232(data):
    """SX1232/AN1200.18 whitening: XOR with the documented LFSR keystream
    (reference: LoRaCodes.hpp:111-137). Involutive — apply twice to undo."""
    data = jnp.asarray(data, dtype=jnp.uint8)
    n = data.shape[-1]
    if n > _WHITEN_MAX:
        raise ValueError(f"whitening run too long ({n} > {_WHITEN_MAX})")
    return data ^ jnp.asarray(_SX1232_STREAM[:n])


@functools.lru_cache(maxsize=64)
def _sx1272_seq_keystream(n: int, bit_ofs: int, rdd: int) -> np.ndarray:
    ofs = _SX1272_OFS1 if rdd == 1 else _SX1272_OFS0
    nbits = 4 + rdd
    j = np.arange(n, dtype=np.int64)
    # x[j] bit i = whiten_seq[(ofs[i] + j + bitOfs) mod 510]
    t = (ofs[:nbits, None] + j[None, :] + bit_ofs + 510) % 510
    bits = _SX1272_SEQ_BITS[t]  # [nbits, n]
    return np.sum(bits.astype(np.uint16) << np.arange(nbits, dtype=np.uint16)[:, None], axis=0).astype(np.uint8)


def whiten_sx1272_seq(data, bit_ofs: int = 0, rdd: int = 4):
    """Sequence-table SX1272 whitening (reference: LoRaCodes.hpp:147-167)."""
    data = jnp.asarray(data, dtype=jnp.uint8)
    ks = _sx1272_seq_keystream(int(data.shape[-1]), int(bit_ofs), int(rdd))
    return data ^ jnp.asarray(ks)


@functools.lru_cache(maxsize=64)
def _sx1272_lfsr_keystream(n: int, bit_ofs: int, rdd: int) -> np.ndarray:
    stream = _SX1272_LFSR_STREAMS[rdd == 1]
    if bit_ofs + n > _WHITEN_MAX:
        stream = _build_sx1272_lfsr_stream(rdd == 1, bit_ofs + n)
    m = 0xFF >> (4 - rdd)
    return (stream[bit_ofs:bit_ofs + n] & m).astype(np.uint8)


def whiten_sx1272_lfsr(data, bit_ofs: int = 0, rdd: int = 4):
    """Dual-LFSR SX1272 whitening — the variant exercised by the reference's
    whitening test (reference: LoRaCodes.hpp:176-189, tests/whitening_test.cpp:38-43).
    Involutive."""
    data = jnp.asarray(data, dtype=jnp.uint8)
    ks = _sx1272_lfsr_keystream(int(data.shape[-1]), int(bit_ofs), int(rdd))
    return data ^ jnp.asarray(ks)


# ---------------------------------------------------------------------------
# SX1272 CRC16 (reference: LoRaCodes.hpp:69-105)
# ---------------------------------------------------------------------------

def _crc16sx_step_table() -> np.ndarray:
    """256-entry table: running the high byte through 8 shift-xor rounds of
    poly 0x1021 with no data input (reference crc16sx, LoRaCodes.hpp:69-79)."""
    tab = np.zeros(256, dtype=np.uint32)
    for b in range(256):
        crc = b << 8
        for _ in range(8):
            if crc & 0x8000:
                crc = ((crc << 1) ^ 0x1021) & 0xFFFF
            else:
                crc = (crc << 1) & 0xFFFF
        tab[b] = crc
    return tab


def _xsum8(t: int) -> int:
    t ^= t >> 4
    t ^= t >> 2
    t ^= t >> 1
    return t & 1


def _build_v_sequence(n: int) -> np.ndarray:
    """Data-independent 8-bit LFSR mask sequence ``v`` in sx1272DataChecksum
    (reference: LoRaCodes.hpp:94-103). V[k] = value of v after k updates."""
    out = np.zeros(n, dtype=np.uint8)
    v = 0xFF
    for k in range(n):
        out[k] = v
        v = (_xsum8(v & 0xB8) | (v << 1)) & 0xFF
    return out


_CRC_STEP = _crc16sx_step_table()
_CRC_V = _build_v_sequence(600)

# Per-distance contribution LUTs: a data byte XOR'd into ``res`` at distance d
# from the end contributes A[d][byte] to the final pre-mask CRC (the step map
# is linear over GF(2), so contributions superpose).
_CRC_MAX_LEN = 256


def _build_crc_dist_tables() -> np.ndarray:
    A = np.zeros((_CRC_MAX_LEN, 256), dtype=np.uint16)
    A[0] = np.arange(256, dtype=np.uint16)  # distance 0: res ^= byte, final
    for d in range(1, _CRC_MAX_LEN):
        prev = A[d - 1].astype(np.uint32)
        A[d] = (((prev & 0xFF) << 8) ^ _CRC_STEP[prev >> 8]).astype(np.uint16)
    return A


_CRC_DIST = _build_crc_dist_tables()


def crc16_sx1272(data):
    """SX1272 payload CRC16: modified CCITT with an 8-bit LFSR output mask
    (reference: LoRaCodes.hpp:92-105).

    Vectorized as an XOR-reduction of per-position GF(2) lookup tables —
    no sequential scan, batchable via leading dims. ``data`` is [..., L]
    with static L <= 255.
    """
    data = jnp.asarray(data, dtype=jnp.uint8)
    L = data.shape[-1]
    if L == 0:
        # Reference loop body never runs: res = 0 ^ V[0] ^ (V[1] << 8)
        return jnp.asarray(
            np.uint16(int(_CRC_V[0]) ^ (int(_CRC_V[1]) << 8)), dtype=jnp.uint16
        )
    if L >= _CRC_MAX_LEN:
        raise ValueError(f"payload too long for CRC table ({L} >= {_CRC_MAX_LEN})")
    # byte i (0-based) sits at distance L-1-i from the end. The LUT pick
    # tables[i, data[i]] is GF(2)-affine in the byte's BITS, so instead of
    # a [..., L, 256] element gather (the take_along pattern CLAUDE.md
    # flags as pathological on this backend) decompose it over the 8-bit
    # basis: contrib = c_i XOR_b bit_b * (T[i, 1<<b] XOR c_i) — selects +
    # a log-depth XOR tree, pure elementwise (8x input footprint, not
    # 256x). The per-position constants c_i fold into the final mask.
    dist = np.arange(L - 1, -1, -1)
    t = _CRC_DIST[dist]                                     # [L, 256] np
    c = t[:, 0]                                             # [L]
    basis = t[:, 1 << np.arange(8)] ^ c[:, None]            # [L, 8]
    const = np.bitwise_xor.reduce(c).astype(np.uint16) if L else np.uint16(0)
    bits = (data[..., None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
    contrib = jnp.where(bits.astype(bool), jnp.asarray(basis),
                        jnp.uint16(0))                      # [..., L, 8]
    crc = _xor_reduce(_xor_reduce(contrib))                 # bits, then bytes
    mask = np.uint16(int(_CRC_V[L]) ^ (int(_CRC_V[L + 1]) << 8) ^ int(const))
    return (crc ^ mask).astype(jnp.uint16)


def _xor_reduce(x, axis=-1):
    """XOR-reduce along ``axis`` via a log-depth halving tree."""
    n = x.shape[axis]
    while n > 1:
        half = n // 2
        lo = jnp.take(x, jnp.arange(half), axis=axis)
        hi = jnp.take(x, jnp.arange(half, 2 * half), axis=axis)
        rest = jnp.take(x, jnp.arange(2 * half, n), axis=axis)
        x = jnp.concatenate([lo ^ hi, rest], axis=axis)
        n = x.shape[axis]
    return jnp.squeeze(x, axis=axis)


def header_checksum(h):
    """5-bit explicit-header checksum over 2 header bytes
    (reference: LoRaCodes.hpp:43-67). ``h`` is [..., 2] uint8."""
    h = jnp.asarray(h, dtype=jnp.uint8)
    h0, h1 = h[..., 0].astype(jnp.int32), h[..., 1].astype(jnp.int32)
    a = [(h0 >> (4 + i)) & 1 for i in range(4)]
    b = [(h0 >> i) & 1 for i in range(4)]
    c = [(h1 >> i) & 1 for i in range(4)]
    res = (a[0] ^ a[1] ^ a[2] ^ a[3]) << 4
    res = res | ((a[3] ^ b[1] ^ b[2] ^ b[3] ^ c[0]) << 3)
    res = res | ((a[2] ^ b[0] ^ b[3] ^ c[1] ^ c[3]) << 2)
    res = res | ((a[1] ^ b[0] ^ b[2] ^ c[0] ^ c[1] ^ c[2]) << 1)
    res = res | (a[0] ^ b[1] ^ c[0] ^ c[1] ^ c[2] ^ c[3])
    return res.astype(jnp.uint8)


def checksum8(data):
    """Rotate-add 8-bit checksum (reference: LoRaCodes.hpp:32-41).

    The rotate-add recurrence carries through addition, so it is evaluated
    as a NumPy loop on host data (it is a tiny non-hot utility).
    """
    arr = np.asarray(data, dtype=np.uint8).reshape(-1)
    acc = 0
    for byte in arr:
        acc = ((acc >> 1) + ((acc & 0x1) << 7)) & 0xFF
        acc = (acc + int(byte)) & 0xFF
    return np.uint8(acc)


# ---------------------------------------------------------------------------
# Diagonal interleaver / deinterleaver (reference: LoRaCodes.hpp:376-432)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _interleave_map(ppm: int, rdd: int) -> np.ndarray:
    """Flat bit-gather map for the interleaver.

    Input bits are codeword-major: ``in[cw*nbits + bit]``. Output symbol bit
    ``(sym=bit, bitpos=cw)`` takes input bit ``bit`` of codeword
    ``(cw+bit) % ppm`` (LoRaCodes.hpp:383-390).
    Returns [nbits*ppm] int32 (symbol-major: ``out[sym*ppm + bitpos]``).
    """
    nbits = 4 + rdd
    bit = np.arange(nbits)[:, None]
    cw = np.arange(ppm)[None, :]
    return (((cw + bit) % ppm) * nbits + bit).reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _deinterleave_map(ppm: int, rdd: int) -> np.ndarray:
    """Inverse flat map: codeword bit ``(dst, bit)`` comes from symbol ``bit``
    at bit position ``(dst - bit) mod ppm`` (LoRaCodes.hpp:401-411).
    Input bits are symbol-major ``in[sym*ppm + bitpos]``; output is
    codeword-major ``out[dst*nbits + bit]``.
    """
    nbits = 4 + rdd
    dst = np.arange(ppm)[:, None]
    bit = np.arange(nbits)[None, :]
    return (bit * ppm + ((dst - bit) % ppm)).reshape(-1).astype(np.int32)


def diagonal_interleave(codewords, ppm: int, rdd: int):
    """Diagonal interleave: [..., blocks*PPM] codewords -> [..., blocks*(4+RDD)]
    symbols (reference: LoRaCodes.hpp:376-393). LSB-first bit order."""
    cws = jnp.asarray(codewords)
    nbits = 4 + rdd
    nblk = cws.shape[-1] // ppm
    cws = cws[..., : nblk * ppm].reshape(*cws.shape[:-1], nblk, ppm)
    bits = unpack_bits(cws.astype(jnp.int32), nbits)         # [..., blk, ppm, nbits]
    flat = bits.reshape(*bits.shape[:-2], ppm * nbits)
    sel = jnp.take(flat, jnp.asarray(_interleave_map(ppm, rdd)), axis=-1)
    syms = pack_bits(sel.reshape(*sel.shape[:-1], nbits, ppm), dtype=jnp.uint16)
    return syms.reshape(*syms.shape[:-2], nblk * nbits)


def diagonal_deinterleave(symbols, ppm: int, rdd: int):
    """Exact inverse of :func:`diagonal_interleave`
    (reference: LoRaCodes.hpp:396-412). [..., blocks*(4+RDD)] symbols ->
    [..., blocks*PPM] codewords."""
    syms = jnp.asarray(symbols)
    nbits = 4 + rdd
    nblk = syms.shape[-1] // nbits
    syms = syms[..., : nblk * nbits].reshape(*syms.shape[:-1], nblk, nbits)
    bits = unpack_bits(syms.astype(jnp.int32), ppm)          # [..., blk, nbits, ppm]
    flat = bits.reshape(*bits.shape[:-2], nbits * ppm)
    sel = jnp.take(flat, jnp.asarray(_deinterleave_map(ppm, rdd)), axis=-1)
    cws = pack_bits(sel.reshape(*sel.shape[:-1], ppm, nbits), dtype=jnp.uint8)
    return cws.reshape(*cws.shape[:-2], nblk * ppm)


@functools.lru_cache(maxsize=64)
def _deinterleave_v2_map(ppm: int, rdd: int, nblk: int) -> tuple[np.ndarray, np.ndarray]:
    """Flat global map for the reference's "optimised" deinterleaver
    (LoRaCodes.hpp:415-432): per block, for m in [0, PPM) it reads
    ``symbols[symOff + m]`` — when PPM > 4+RDD this *spills into the next
    block's symbols* (and past the array on the final block, which is
    undefined behaviour upstream; we zero those bits instead of cloning UB).

    Output codeword bit (blk, i=(m+k)%ppm, bitpos=m) = bit k of
    ``symbols[blk*nb + m]``. Returns (gather [nblk*ppm*ppm] into the flat
    symbol-bit array [nblk*nb*ppm], valid mask).
    """
    nb = 4 + rdd
    total_syms = nblk * nb
    blk = np.arange(nblk)[:, None, None]
    m = np.arange(ppm)[None, :, None]
    k = np.arange(ppm)[None, None, :]
    sym_index = blk * nb + m                                  # global symbol read
    src = sym_index * ppm + k                                 # flat symbol-bit index
    valid = np.broadcast_to(sym_index < total_syms, src.shape)
    # destination: (blk, cw=(m+k)%ppm, bitpos=m)
    dst = (blk * ppm + (m + k) % ppm) * ppm + m
    gather = np.full(nblk * ppm * ppm, 0, dtype=np.int32)
    mask = np.zeros(nblk * ppm * ppm, dtype=bool)
    gather[dst.reshape(-1)] = np.where(valid, src, 0).reshape(-1)
    mask[dst.reshape(-1)] = valid.reshape(-1)
    return gather, mask


def diagonal_deinterleave_v2(symbols, ppm: int, rdd: int):
    """The reference's "optimised" deinterleaver variant with rotated,
    block-spilling addressing (reference: LoRaCodes.hpp:415-432), kept for
    API parity. Bit-exact wherever the reference's reads are in bounds."""
    syms = jnp.asarray(symbols)
    nb = 4 + rdd
    nblk = syms.shape[-1] // nb
    syms = syms[..., : nblk * nb]
    bits = unpack_bits(syms.astype(jnp.int32), ppm)           # [..., nblk*nb, ppm]
    flat = bits.reshape(*bits.shape[:-2], nblk * nb * ppm)
    gather, mask = _deinterleave_v2_map(ppm, rdd, nblk)
    sel = jnp.take(flat, jnp.asarray(gather), axis=-1) * jnp.asarray(
        mask.astype(np.int32)
    )
    cws = pack_bits(sel.reshape(*sel.shape[:-1], nblk * ppm, ppm), dtype=jnp.uint8)
    return cws
