"""Polyphase filter-bank channelizer — the wideband front end.

The reference processes exactly one channel; the BASELINE north star is a
multi-channel receiver. This module splits one wideband IQ stream into K
critically-sampled sub-channels (spacing fs/K) with a polyphase FFT filter
bank, producing the ``[channels, T/K]`` tensor the batched/sharded
demodulators consume (parallel/stream.py).

Mapping: the polyphase FIR is one einsum over a strided window view
([frames, taps, K] x [taps, K]) and the K-point channel DFT is a dense
matmul — no sequential filtering state, so the whole bank is one fused jit
program. Every product runs at ``Precision.HIGHEST`` (:func:`_einsum`,
:func:`_mm`). The prototype filter is a windowed-sinc lowpass
designed at trace time in NumPy.

Channel k is centred at frequency ``k * fs / K`` (k interpreted mod K, so
negative offsets alias to high k). Each output channel is basebanded and
decimated by K.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST
_einsum = functools.partial(jnp.einsum, precision=_HIGHEST)
_mm = functools.partial(jnp.matmul, preferred_element_type=jnp.float32,
                        precision=_HIGHEST)


@functools.lru_cache(maxsize=16)
def _prototype(k: int, taps_per_branch: int) -> np.ndarray:
    """Windowed-sinc lowpass prototype, cutoff at half the channel spacing,
    shaped [taps_per_branch, K] (polyphase decomposition)."""
    ntaps = k * taps_per_branch
    t = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = np.sinc(t / k) * np.hamming(ntaps)
    h /= h.sum()
    return h.reshape(taps_per_branch, k).astype(np.float32)


def channelize(x, k: int, taps_per_branch: int = 7):
    """[..., T] wideband complex64 -> [..., K, T//K] channel streams.

    Group-delay aligned: with odd ``taps_per_branch`` the prototype's
    centre lands exactly on the output frame's own span, so output frame
    ``m`` of a channel corresponds to input samples around ``m * K`` —
    LoRa symbol timing survives channelization (gated by the
    multi-channel receive test). The stream is zero-padded symmetrically.
    """
    if taps_per_branch % 2 == 0:
        raise ValueError("taps_per_branch must be odd for aligned output")
    x = jnp.asarray(x)
    t = x.shape[-1] // k * k
    x = x[..., :t]
    frames = t // k
    h = jnp.asarray(_prototype(k, taps_per_branch))     # [taps, K]

    # symmetric pad: head gets half the filter span so the prototype's
    # centre aligns with each output frame
    pad_head = ((taps_per_branch - 1) // 2) * k
    pad_tail = (taps_per_branch - 1) * k - pad_head
    xp = jnp.concatenate(
        [jnp.zeros(x.shape[:-1] + (pad_head,), x.dtype), x,
         jnp.zeros(x.shape[:-1] + (pad_tail,), x.dtype)], axis=-1
    )
    # window view: frame m uses samples [m*K, m*K + taps*K), branch-major.
    # Build [..., frames, taps, K] via strided gather-free reshape: take
    # taps_per_branch shifted reshapes and stack (static slices only).
    views = [
        xp[..., i * k: i * k + t].reshape(*x.shape[:-1], frames, k)
        for i in range(taps_per_branch)
    ]
    w = jnp.stack(views, axis=-2)                       # [..., frames, taps, K]

    # polyphase FIR: branch-wise dot over taps (real h x complex x)
    fir = _einsum("...ftk,tk->...fk", w, h)

    # channel DFT across the K branches (IDFT convention so channel k sits
    # at +k*fs/K); dense matmul, K is small
    kk = np.arange(k)
    dft = np.exp(-2j * np.pi * np.outer(kk, kk) / k).astype(np.complex64)
    chans = _einsum("...fk,ck->...cf", fir, jnp.asarray(dft))
    return chans                                        # [..., K, frames]


def synthesize_channels(signals, k: int, taps_per_branch: int = 7):
    """True polyphase synthesis filter bank (TX side) — the transpose of
    :func:`channelize`: ``[..., C, F]`` channel streams (C <= K, channel c
    centred at ``c * fs / K``) -> ``[..., F*K]`` wideband stream at rate fs.

    IDFT across channels -> K branch streams -> interpolating polyphase
    FIR (the analysis prototype scaled by K for the zero-stuffing gain)
    -> commutator interleave. One fused einsum program, group-delay
    aligned with the analysis bank, so channelize(synthesize(x)) recovers
    each stream sample-aligned (gated by tests/test_channelizer.py), with
    upsampling images suppressed by the prototype's stopband instead of
    the zero-order hold's sinc roll-off.
    """
    if taps_per_branch % 2 == 0:
        raise ValueError("taps_per_branch must be odd for aligned output")
    signals = jnp.asarray(signals)
    nchan = signals.shape[-2]
    frames = signals.shape[-1]
    if nchan < k:
        pad = jnp.zeros(signals.shape[:-2] + (k - nchan, frames),
                        signals.dtype)
        signals = jnp.concatenate([signals, pad], axis=-2)

    # IDFT across channels: branch r of output frame m carries
    # sum_c X_c[m] * e^{+2pi j c r / K} (carrier phase at sample m*K + r)
    cc = np.arange(k)
    idft = np.exp(2j * np.pi * np.outer(cc, cc) / k).astype(np.complex64)
    u = _einsum("...cf,cr->...fr", signals, jnp.asarray(idft))

    # interpolating polyphase FIR along frames, branch-wise; symmetric pad
    # mirrors the analysis bank so group delays cancel
    h = jnp.asarray(_prototype(k, taps_per_branch)) * k   # [taps, K]
    half = (taps_per_branch - 1) // 2
    up = jnp.concatenate(
        [jnp.zeros(u.shape[:-2] + (half, k), u.dtype), u,
         jnp.zeros(u.shape[:-2] + (taps_per_branch - 1 - half, k), u.dtype)],
        axis=-2,
    )
    views = [up[..., i: i + frames, :] for i in range(taps_per_branch)]
    w = jnp.stack(views, axis=-2)                          # [..., F, taps, K]
    # analysis filters branch r with h[:, r] forward in time; synthesis
    # uses the time-reversed taps so the cascade is h*h (linear-phase)
    y = _einsum("...ftk,tk->...fk", w, h[::-1])

    return y.reshape(*y.shape[:-2], frames * k)            # commutate


@functools.lru_cache(maxsize=16)
def _combined_bank(k: int, taps_per_branch: int):
    """FIR prototype and channel DFT folded into one weight pair:
    ``out[c] = sum_{t,k} h[t,k] * e^{-2pi j ck/K} * window[t,k]`` becomes
    two [taps*K, K] real matrices (cos and sin parts)."""
    h = _prototype(k, taps_per_branch)                     # [taps, K]
    kk = np.arange(k)
    cosd = np.cos(2 * np.pi * np.outer(kk, kk) / k).astype(np.float32)
    sind = np.sin(2 * np.pi * np.outer(kk, kk) / k).astype(np.float32)
    wc = (h[:, :, None] * cosd.T[None, :, :]).reshape(taps_per_branch * k, k)
    ws = (h[:, :, None] * sind.T[None, :, :]).reshape(taps_per_branch * k, k)
    return wc, ws


@functools.lru_cache(maxsize=16)
def _combined_bank_planar(k: int, taps_per_branch: int) -> np.ndarray:
    """Both planes and both output parts in ONE rhs:
    ``[Xr | Xi] @ [[wc, -ws], [ws, wc]] = [out_r | out_i]`` —
    a single ``[F, 2*taps*K] @ [2*taps*K, 2K]`` matmul."""
    wc, ws = _combined_bank(k, taps_per_branch)
    return np.block([[wc, -ws], [ws, wc]]).astype(np.float32)


def _group_size(k: int, taps_per_branch: int) -> int:
    """Frames per matmul row for the grouped form.

    The output corner-turn ``[.., n_groups, 2K, G] -> [.., 2K, F]``
    moves rows of exactly G floats, so G is rounded UP to a multiple of
    128 whenever the block-Toeplitz bank stays under a 128 MB budget (it
    is dense zeros-padded: bank bytes ~ 16*K^2*G^2, so big-K banks fall
    back to the unaligned ``G*K ~ 1024`` target). FLOPs inflate
    ~(G+taps-1)/taps x over the useful MACs — ~19x at K=8/taps=7; the
    choice of G on the GPU is not measured yet
    (tools/probe_channelizer2.py sweeps it). ``G >= taps - 1`` keeps a row's window inside two
    consecutive ``G*K`` reshaped rows; the >= 1 clamp guards
    ``taps_per_branch=1`` with ``k > 1024`` (both terms hit 0 and the
    group count would divide-by-zero; ``--taps`` is user-settable via
    lora-rx-stream)."""
    g = max(1, taps_per_branch - 1, 1024 // k - taps_per_branch + 1)
    g128 = -(-g // 128) * 128
    bank_bytes = 16 * (g128 + taps_per_branch - 1) * k * g128 * k
    return g128 if bank_bytes <= (128 << 20) else g


@functools.lru_cache(maxsize=16)
def _grouped_bank_planar(k: int, taps_per_branch: int, g: int) -> np.ndarray:
    """Block-Toeplitz expansion of :func:`_combined_bank_planar` for G
    frames per matmul row: ``[2R, G*2K]`` with ``R = (G+taps-1)*K``.
    Output frame ``g`` of a group contracts window positions
    ``g..g+taps-1`` of the row, i.e. the small bank shifted down by
    ``g*K`` rows within each plane block."""
    small = _combined_bank_planar(k, taps_per_branch)     # [2*taps*K, 2K]
    tk = taps_per_branch * k
    r = (g + taps_per_branch - 1) * k
    big = np.zeros((2 * r, g * 2 * k), np.float32)
    for gi in range(g):
        for plane in range(2):
            big[plane * r + gi * k: plane * r + gi * k + tk,
                gi * 2 * k: (gi + 1) * 2 * k] = \
                small[plane * tk: (plane + 1) * tk]
    return big


@functools.lru_cache(maxsize=16)
def _grouped_bank_split(k: int, taps_per_branch: int, g: int):
    """Per-plane halves of :func:`_grouped_bank_planar` with the output
    columns PERMUTED channel-major — ``(plane*K + c, g)`` instead of
    ``(g, plane*K + c)`` — so the matmul result reshapes to
    ``[.., n_groups, 2K, G]`` and the channel corner-turn moves
    contiguous G-float rows instead of single floats
    (tools/probe_channelizer2.py)."""
    big = _grouped_bank_planar(k, taps_per_branch, g)
    r = (g + taps_per_branch - 1) * k
    perm = np.arange(g * 2 * k).reshape(g, 2 * k).T.reshape(-1)
    return (np.ascontiguousarray(big[:r][:, perm]),
            np.ascontiguousarray(big[r:][:, perm]))


def channelize_planar(xr, xi, k: int, taps_per_branch: int = 7):
    """Planar twin of :func:`channelize`:
    ``(re, im) [..., T]`` float32 -> ``(re, im) [..., K, T//K]``.

    FIR, channel DFT and both output parts are folded into one matmul
    PER PLANE over GROUPS of G output frames per row:
    ``[F/G, (G+taps-1)*K] @ [(G+taps-1)*K, G*2K]`` (block-Toeplitz rhs,
    output columns permuted channel-major, re-plane + im-plane products
    summed).  vs the per-frame im2col (``[F, 2*taps*K] @ [2*taps*K,
    2K]``) this cuts the im2col overlap blow-up from ``taps``x to
    ``(G+taps-1)/G``x and widens the contraction/output from 112x16 to
    ~1024x2048; the channel-major column permutation turns the final
    [F, 2K] -> [2K, F] corner-turn into a contiguous-G-row transpose
    (tools/probe_channelizer{,2}.py time the variants).  Same windows /
    prototype / alignment as the complex path (gated by
    tests/test_channelizer.py, atol 1e-5: the grouped matmul only
    reorders the f32 sums)."""
    if taps_per_branch % 2 == 0:
        raise ValueError("taps_per_branch must be odd for aligned output")
    xr = jnp.asarray(xr)
    xi = jnp.asarray(xi)
    t = xr.shape[-1] // k * k
    frames = t // k
    lead = xr.shape[:-1]
    pad_head = ((taps_per_branch - 1) // 2) * k

    g = _group_size(k, taps_per_branch)
    n_groups = -(-frames // g)
    f_pad = n_groups * g
    # padded plane: head alignment zeros + tail zeros covering both the
    # frame round-up to a multiple of G and the second shifted reshape
    total = (f_pad + g) * k

    def group_rows(plane):
        xp = jnp.zeros(lead + (total,), plane.dtype)
        xp = jax.lax.dynamic_update_slice_in_dim(
            xp, plane[..., :t], pad_head, axis=-1)
        x0 = xp[..., : n_groups * g * k].reshape(*lead, n_groups, g * k)
        x1 = xp[..., g * k: (n_groups + 1) * g * k].reshape(
            *lead, n_groups, g * k)
        return jnp.concatenate(
            [x0, x1[..., : (taps_per_branch - 1) * k]], axis=-1)

    top, bot = _grouped_bank_split(k, taps_per_branch, g)
    out = (_mm(group_rows(xr), jnp.asarray(top))
           + _mm(group_rows(xi), jnp.asarray(bot)))
    # channel-major columns: [.., n_groups, 2K, G] -> [.., 2K, n_groups, G]
    # moves contiguous G-float rows
    v = out.reshape(*lead, n_groups, 2 * k, g)
    v = jnp.swapaxes(v, -3, -2).reshape(*lead, 2 * k, f_pad)[..., :frames]
    return v[..., :k, :], v[..., k:, :]                   # [..., K, F] x2


def synthesize_channels_planar(sr, si, k: int, taps_per_branch: int = 7):
    """Planar twin of :func:`synthesize_channels`:
    ``(re, im) [..., C, F]`` -> ``(re, im) [..., F*K]``."""
    if taps_per_branch % 2 == 0:
        raise ValueError("taps_per_branch must be odd for aligned output")
    sr = jnp.asarray(sr)
    si = jnp.asarray(si)
    nchan = sr.shape[-2]
    frames = sr.shape[-1]
    if nchan < k:
        pad = jnp.zeros(sr.shape[:-2] + (k - nchan, frames), sr.dtype)
        sr = jnp.concatenate([sr, pad], axis=-2)
        si = jnp.concatenate([si, pad], axis=-2)

    cc = np.arange(k)
    er = jnp.asarray(np.cos(2 * np.pi * np.outer(cc, cc) / k).astype(np.float32))
    ei = jnp.asarray(np.sin(2 * np.pi * np.outer(cc, cc) / k).astype(np.float32))
    ur = _einsum("...cf,cr->...fr", sr, er) - _einsum(
        "...cf,cr->...fr", si, ei)
    ui = _einsum("...cf,cr->...fr", sr, ei) + _einsum(
        "...cf,cr->...fr", si, er)

    h = jnp.asarray(_prototype(k, taps_per_branch)) * k   # [taps, K]
    half = (taps_per_branch - 1) // 2

    def fir(u):
        up = jnp.concatenate(
            [jnp.zeros(u.shape[:-2] + (half, k), u.dtype), u,
             jnp.zeros(u.shape[:-2] + (taps_per_branch - 1 - half, k),
                       u.dtype)],
            axis=-2,
        )
        views = [up[..., i: i + frames, :] for i in range(taps_per_branch)]
        w = jnp.stack(views, axis=-2)                      # [..., F, taps, K]
        y = _einsum("...ftk,tk->...fk", w, h[::-1])
        return y.reshape(*y.shape[:-2], frames * k)

    return fir(ur), fir(ui)


def synthesize_tone_channels(signals, k: int):
    """Legacy test helper (TX side): zero-order-hold mix of each channel
    onto its carrier — images only suppressed by the ZOH sinc roll-off.
    Prefer :func:`synthesize_channels` (true polyphase synthesis bank)."""
    signals = jnp.asarray(signals)
    nchan = signals.shape[-2]
    length = signals.shape[-1]
    t = jnp.arange(length * k)
    wide = jnp.zeros(signals.shape[:-2] + (length * k,), jnp.complex64)
    for c in range(nchan):
        up = jnp.repeat(signals[..., c, :], k, axis=-1)   # zero-order hold
        carrier = jnp.exp(2j * jnp.pi * (c % k) * t / k).astype(jnp.complex64)
        wide = wide + up * carrier
    return wide / nchan
