"""Colliding-frame receive via successive interference cancellation (SIC).

Nothing upstream survives a collision: the reference demodulates one
frame-aligned buffer at a time (src/phy/LoRaDemod.cpp:31-57 assumes the
buffer IS the frame) and gr-lora_sdr's receiver locks to a single frame
per sync. In a dense deployment two transmitters regularly overlap; the
stronger one captures the demodulator and the weaker frame is lost —
often without even syncing, because the stronger payload's chirps destroy
the equal-bin structure of the weaker preamble.

This receiver exploits the framework's exact TX model to peel frames off
in power order:

1. scan + demodulate the block (:func:`..models.sync.receive_block_planar`
   — one device program),
2. re-synthesize the strongest frame's clean baseband with the lattice
   modulator (:func:`..models.stream.frame_modulate_planar` — bit-exact
   TX), rotated by its estimated total CFO,
3. fit the complex channel gain by least squares over the frame span and
   subtract (one more device program),
4. rescan the residual. Repeat.

Decision-directed reconstruction is exact when the symbol decisions are
right, so cancellation depth is limited only by the offset-estimate
residuals (CFO to ~1e-3 bin from the preamble slope, timing to the
integer sample grid). Everything is planar float32, and the joint gain
solve's Gram products run at ``Precision.HIGHEST``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.params import LoraParams
from .stream import frame_modulate_planar
from .sync import block_rows, receive_block_planar

_TWO_PI = 6.283185307179586
_mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


@partial(jax.jit, static_argnames=("params", "preamble_len"))
def cancel_frame_planar(xr, xi, symbols, start, cfo_total,
                        params: LoraParams, preamble_len: int = 8,
                        sync_word=None):
    """Subtract one decoded frame from continuous ``[T]`` planes.

    ``symbols``: the frame's hard decisions ``[S] uint16``; ``start``: its
    first preamble sample (int32, traced); ``cfo_total``: integer + residual
    CFO in FFT bins (float32, traced); ``sync_word``: the frame's
    RECOVERED sync word (uint8, traced — data-dependent, so it must not
    ride the static params or every distinct word retraces the whole
    cancel program; None falls back to ``params.sync_word``). Returns
    ``(xr', xi', (gain_re, gain_im), resid_db)`` where ``resid_db`` is
    the post-subtraction power over the frame span relative to the
    pre-subtraction power — the cancellation-depth observable.
    """
    t_len = xr.shape[-1]
    if sync_word is None:
        sync_word = jnp.uint8(params.sync_word)
    shift = (params.sf - 4) if params.sf > 4 else 0
    sw = jnp.asarray(sync_word, jnp.int32)
    sync_syms = jnp.stack([((sw >> 4) & 0xF) << shift,
                           (sw & 0xF) << shift])
    rr, ri = frame_modulate_planar(symbols.astype(jnp.int32), params,
                                   preamble_len, amplitude=1.0,
                                   sync_symbols=sync_syms)
    span = rr.shape[-1]

    # estimated CFO rotation: the block receiver derotates the RECEIVED
    # window by exp(-j*2*pi*cfo_bins/step * t) (sync.receive_block_planar)
    # and measures the residual in bins over the same decimation, so the
    # received frame carries exp(+j*2*pi*cfo_total/step * (t - start)).
    ph = (jnp.float32(_TWO_PI / params.step) * cfo_total) * jnp.arange(
        span, dtype=jnp.float32)
    c, s = jnp.cos(ph), jnp.sin(ph)
    er = rr * c - ri * s
    ei = rr * s + ri * c

    # slice the frame span out of padded planes (always in range), fit the
    # complex gain by least squares, subtract, write back
    start = jnp.clip(start, 0, t_len).astype(jnp.int32)
    pr = jnp.pad(xr, (0, span))
    pi_ = jnp.pad(xi, (0, span))
    seg_r = jax.lax.dynamic_slice(pr, (start,), (span,))
    seg_i = jax.lax.dynamic_slice(pi_, (start,), (span,))

    den = jnp.maximum(jnp.sum(er * er + ei * ei), 1e-30)
    g_re = jnp.sum(seg_r * er + seg_i * ei) / den
    g_im = jnp.sum(seg_i * er - seg_r * ei) / den
    sub_r = seg_r - (g_re * er - g_im * ei)
    sub_i = seg_i - (g_re * ei + g_im * er)

    before = jnp.sum(seg_r * seg_r + seg_i * seg_i)
    after = jnp.sum(sub_r * sub_r + sub_i * sub_i)
    resid_db = 10.0 * jnp.log10(jnp.maximum(after, 1e-30) /
                                jnp.maximum(before, 1e-30))

    out_r = jax.lax.dynamic_update_slice(pr, sub_r, (start,))[..., :t_len]
    out_i = jax.lax.dynamic_update_slice(pi_, sub_i, (start,))[..., :t_len]
    return out_r, out_i, (g_re, g_im), resid_db


def _embed_template_planar(symbols, start, cfo_total, sync_word, t_len,
                           params: LoraParams, preamble_len: int):
    """Resynthesize one frame (unit amplitude, CFO-rotated) embedded at
    ``start`` into zero [t_len] planes — the SIC basis vector."""
    shift = (params.sf - 4) if params.sf > 4 else 0
    sw = jnp.asarray(sync_word, jnp.int32)
    sync_syms = jnp.stack([((sw >> 4) & 0xF) << shift,
                           (sw & 0xF) << shift])
    rr, ri = frame_modulate_planar(symbols.astype(jnp.int32), params,
                                   preamble_len, amplitude=1.0,
                                   sync_symbols=sync_syms)
    span = rr.shape[-1]
    ph = (jnp.float32(_TWO_PI / params.step) * cfo_total) * jnp.arange(
        span, dtype=jnp.float32)
    c, s = jnp.cos(ph), jnp.sin(ph)
    er = rr * c - ri * s
    ei = rr * s + ri * c
    z = jnp.zeros((t_len + span,), jnp.float32)
    st = jnp.clip(start, 0, t_len).astype(jnp.int32)
    return (jax.lax.dynamic_update_slice(z, er, (st,))[:t_len],
            jax.lax.dynamic_update_slice(z, ei, (st,))[:t_len])


@partial(jax.jit, static_argnames=("step",))
def _cfo_slope_planar(yr, yi, er, ei, step: int):
    """Residual-CFO of ``y`` against unit template ``e`` (both [T]
    planes, template zero outside the frame): phase slope of the
    per-window inner products ``p_w = sum_win y*conj(e)``, in the
    cancel convention's bins (advance of 2*pi*cfo per step samples).
    Magnitude-weighted (windows where the template is zero contribute
    nothing), so partial/edge windows are harmless."""
    nwin = yr.shape[-1] // step
    cr = (yr * er + yi * ei)[..., : nwin * step].reshape(nwin, step)
    ci = (yi * er - yr * ei)[..., : nwin * step].reshape(nwin, step)
    pr, pi_ = jnp.sum(cr, -1), jnp.sum(ci, -1)        # [W] complex
    dr = pr[1:] * pr[:-1] + pi_[1:] * pi_[:-1]
    di = pi_[1:] * pr[:-1] - pr[1:] * pi_[:-1]
    return jnp.arctan2(jnp.sum(di), jnp.sum(dr)) / jnp.float32(_TWO_PI)


@jax.jit
def gram_planar(er_all, ei_all, yr, yi):
    """Normal-equation sums of the joint gain solve for templates
    ``E = er + j ei`` ([K, T] planes) against ``y = yr + j yi`` ([T]):
    ``(Re E^H E, Im E^H E, Re E^H y, Im E^H y)``."""
    ar = _mm(er_all, er_all.T) + _mm(ei_all, ei_all.T)   # Re(E^H E)
    ai = _mm(er_all, ei_all.T) - _mm(ei_all, er_all.T)   # Im(E^H E)
    br = _mm(er_all, yr) + _mm(ei_all, yi)               # Re(E^H y)
    bi = _mm(er_all, yi) - _mm(ei_all, yr)               # Im(E^H y)
    return ar, ai, br, bi


def refine_sic_planar(xr0, xi0, frames, params: LoraParams,
                      preamble_len: int = 8, n_iters: int = 3,
                      n_payload_symbols: int | None = None,
                      min_power_db: float | None = -30.0):
    """Joint re-fit of all peeled frames against the ORIGINAL block:
    per-frame CFO refinement + joint complex gains, iterated.

    The sequential peel estimates each frame while the others (or their
    residuals) are still in the stream. Two biases result (round-2
    known limitation): the per-frame LS GAIN is biased a few percent
    because time-shifted chirps are only near-orthogonal — and, far
    more damaging, the preamble CFO estimate is biased by a few 1e-3
    bins, which integrates to ~a radian of phase drift across the frame
    and caps cancellation at ~-10 dB (measured: a -12 dB weaker
    collision partner then mis-decodes even though the single-frame
    cancel floor is < -100 dB).

    Each iteration: (1) solve the K x K complex normal equations
    ``(E^H E) g = E^H y0`` (host numpy over device-reduced Gram sums),
    (2) re-estimate every frame's CFO from its interference-cancelled
    view ``y0 - sum_{j!=k} g_j e_j`` via the phase slope of per-window
    template correlations, (3) rebuild templates. When
    ``n_payload_symbols`` is given, a DECISION refresh follows: every
    frame is re-demodulated from its interference-cancelled view (the
    initial decisions were made with only the stronger frames peeled),
    and the loop reruns if any changed. Mutates each frame dict's
    ``gain``/``cfo`` (and decisions, on refresh) and adds
    ``cancel_resid_db_joint``; returns the jointly-cancelled
    ``(xr', xi')`` planes.
    """
    k = len(frames)
    yr = jnp.asarray(xr0, jnp.float32)
    yi = jnp.asarray(xi0, jnp.float32)
    if k == 0:
        return yr, yi
    t_len = int(yr.shape[-1])

    def templates():
        ers, eis = [], []
        for f in frames:
            er, ei = _embed_template_planar(
                jnp.asarray(f["symbols"]), jnp.int32(f["start"]),
                jnp.float32(f["cfo_bins"] + f["cfo"]),
                jnp.uint8(f["sync"]), t_len, params, preamble_len)
            ers.append(er)
            eis.append(ei)
        return jnp.stack(ers), jnp.stack(eis)         # [K, T]

    @jax.jit
    def _subtract(yr, yi, er_all, ei_all, g_re, g_im):
        sr = jnp.sum(g_re * er_all - g_im * ei_all, axis=0)
        si = jnp.sum(g_re * ei_all + g_im * er_all, axis=0)
        return yr - sr, yi - si

    def solve(er_all, ei_all):
        ar, ai, br, bi = (np.asarray(v) for v in
                          gram_planar(er_all, ei_all, yr, yi))
        a = ar + 1j * ai
        return np.linalg.solve(
            a + 1e-9 * np.trace(a).real / k * np.eye(k), br + 1j * bi)

    def _gains_cfo_rounds(er_all, ei_all):
        g = None
        for it in range(n_iters):
            g = solve(er_all, ei_all)
            g_re = jnp.asarray(g.real.astype(np.float32))[:, None]
            g_im = jnp.asarray(g.imag.astype(np.float32))[:, None]
            if it == n_iters - 1:
                break
            res_r, res_i = _subtract(yr, yi, er_all, ei_all, g_re, g_im)
            changed = False
            for idx, f in enumerate(frames):
                yk_r = (res_r + g_re[idx, 0] * er_all[idx]
                        - g_im[idx, 0] * ei_all[idx])
                yk_i = (res_i + g_re[idx, 0] * ei_all[idx]
                        + g_im[idx, 0] * er_all[idx])
                dcfo = float(np.asarray(_cfo_slope_planar(
                    yk_r, yk_i, er_all[idx], ei_all[idx], params.step)))
                if abs(dcfo) > 1e-6:
                    f["cfo"] = float(f["cfo"] + dcfo)
                    changed = True
            if not changed:
                break
            er_all, ei_all = templates()
        return g, er_all, ei_all

    er_all, ei_all = templates()
    g, er_all, ei_all = _gains_cfo_rounds(er_all, ei_all)

    # --- decision refresh: re-demodulate every frame from its
    # interference-cancelled view. The initial decisions were made with
    # only the STRONGER frames peeled (and with their residuals still
    # in); with the refined joint model the weaker frames' symbol errors
    # — the remaining floor of the cancellation — usually vanish.
    if n_payload_symbols is not None:
        g_re = jnp.asarray(g.real.astype(np.float32))[:, None]
        g_im = jnp.asarray(g.imag.astype(np.float32))[:, None]
        res_r, res_i = _subtract(yr, yi, er_all, ei_all, g_re, g_im)
        changed = False
        for idx, f in enumerate(frames):
            yk_r = (res_r + g_re[idx, 0] * er_all[idx]
                    - g_im[idx, 0] * ei_all[idx])
            yk_i = (res_i + g_re[idx, 0] * ei_all[idx]
                    + g_im[idx, 0] * er_all[idx])
            blk = receive_block_planar(yk_r, yk_i, params,
                                       n_payload_symbols, max_frames=2,
                                       preamble_len=preamble_len,
                                       min_power_db=min_power_db)
            rows = [r for r in block_rows(blk)
                    if abs(r["start"] - f["start"]) <= params.step]
            if not rows:
                continue
            row = min(rows, key=lambda r: abs(r["start"] - f["start"]))
            if (row["start"] != f["start"]
                    or not np.array_equal(row["symbols"], f["symbols"])):
                for key in ("start", "symbols", "sync", "cfo_bins", "cfo",
                            "snr_db"):
                    f[key] = row[key]
                changed = True
        if changed:
            er_all, ei_all = templates()
            g, er_all, ei_all = _gains_cfo_rounds(er_all, ei_all)

    g_re = jnp.asarray(g.real.astype(np.float32))[:, None]
    g_im = jnp.asarray(g.imag.astype(np.float32))[:, None]
    out_r, out_i = _subtract(yr, yi, er_all, ei_all, g_re, g_im)
    for idx, f in enumerate(frames):
        f["gain"] = (float(g[idx].real), float(g[idx].imag))
        st = max(0, min(int(f["start"]), t_len - 1))
        sl = slice(st, t_len)
        before = float(np.asarray(jnp.sum(yr[sl] ** 2 + yi[sl] ** 2)))
        after = float(np.asarray(jnp.sum(out_r[sl] ** 2 + out_i[sl] ** 2)))
        f["cancel_resid_db_joint"] = 10.0 * np.log10(
            max(after, 1e-30) / max(before, 1e-30))
    return out_r, out_i


def receive_sic_planar(xr, xi, params: LoraParams, n_payload_symbols: int,
                       max_frames: int = 4, preamble_len: int = 8,
                       min_power_db: float | None = -30.0,
                       max_iters: int = 4, pre_acc: int = 1,
                       refine: bool = True):
    """Iterative collision receiver over single-channel ``[T]`` planes.

    Each pass demodulates the block, records the strongest not-yet-peeled
    frame, cancels it, and rescans; it stops when a pass finds nothing new
    or after ``max_iters`` frames. Returns ``(frames, (xr', xi'))`` where
    ``frames`` is a list of dicts (``start``, ``symbols``, ``sync``,
    ``cfo_bins``, ``cfo``, ``snr_db``, ``sic_pass``, ``cancel_resid_db``)
    sorted by ``start``, and the planes are the final residual.

    Every recorded frame was demodulated from a stream with all stronger
    overlapping frames already removed — the weaker frame of a collision
    comes out clean even when the first pass could not sync on it at all.

    ``refine=True`` (default) runs the JOINT re-fit of all frames peeled
    so far (:func:`refine_sic_planar`) after every peel — the sequential
    per-frame LS estimates are mutually biased on overlapped frames
    (CFO by ~1e-3 bins, which integrates to a ~-10 dB cancellation
    floor: enough to bury a weaker partner and stop the NEXT pass from
    even syncing on it) — and finishes with a decision-refresh pass.
    Returns the jointly-cancelled residual.
    """
    xr = jnp.asarray(xr, jnp.float32)
    xi = jnp.asarray(xi, jnp.float32)
    xr0, xi0 = xr, xi
    decoded: list[dict] = []
    guard = params.step  # residual re-syncs within a symbol of a peel
    for it in range(max_iters):
        blk = receive_block_planar(xr, xi, params, n_payload_symbols,
                                   max_frames, preamble_len,
                                   min_power_db=min_power_db,
                                   pre_acc=pre_acc)
        rows = [r for r in block_rows(blk)
                if all(abs(r["start"] - d["start"]) > guard for d in decoded)]
        if not rows:
            break
        best = max(rows, key=lambda r: r["snr_db"])
        best["sic_pass"] = it
        decoded.append(best)
        if refine:
            # re-fit the whole peeled set against the ORIGINAL block so
            # the next scan sees the deep (joint) residual
            xr, xi = refine_sic_planar(xr0, xi0, decoded, params,
                                       preamble_len)
            best["cancel_resid_db"] = best["cancel_resid_db_joint"]
        else:
            xr, xi, (g_re, g_im), resid_db = cancel_frame_planar(
                xr, xi, jnp.asarray(best["symbols"]),
                jnp.int32(best["start"]),
                jnp.float32(best["cfo_bins"] + best["cfo"]),
                params, preamble_len,
                sync_word=jnp.uint8(best["sync"]),
            )
            best["cancel_resid_db"] = float(resid_db)
            best["gain"] = (float(g_re), float(g_im))
    decoded.sort(key=lambda r: r["start"])
    if refine and decoded:
        # final pass WITH decision refresh (frames decoded early saw the
        # dirtiest stream; re-demod each from its interference-cancelled
        # view and re-fit if anything changed)
        xr, xi = refine_sic_planar(xr0, xi0, decoded, params, preamble_len,
                                   n_payload_symbols=n_payload_symbols,
                                   min_power_db=min_power_db)
        decoded.sort(key=lambda r: r["start"])
    return decoded, (xr, xi)
