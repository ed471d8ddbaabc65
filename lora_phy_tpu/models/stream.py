"""Streaming receiver: frame synchronisation over a continuous IQ stream
with explicit, resumable carry state.

The reference demodulator requires the whole, frame-aligned sample buffer
in memory and has no preamble/frame detection at all (SURVEY.md §5.7: the
only carried state is the modulator's phase accumulator). This module adds
the standard-LoRa frame structure the reference only *documents*
(reference: scripts/create_golden_vectors.cpp:95-140 — preamble upchirps,
2 sync upchirps, 2.25 downchirps, payload) and a vectorized synchroniser:

* TX :func:`frame_modulate` — preamble + sync + 2.25 downchirps + payload;
* RX :func:`frame_sync` — the classic two-sided dechirp detector, fully
  vectorized: window the stream into symbol periods, argmax the
  up-dechirped FFT (preamble windows repeat the same bin: run-detect) and
  the down-dechirped FFT over the downchirp section; the two bins split
  into timing and integer-CFO:
      bin_up   ~ cfo - tau,   bin_down ~ cfo + tau
      tau = (bin_down - bin_up)/2,  cfo_int = (bin_down + bin_up)/2
* :class:`StreamDemodulator` — block-wise processing with a carried tail
  (pytree state), so continuous streams demodulate without seam artifacts
  and processing is resumable/shardable (SURVEY.md §5.4).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..ops.chirp import base_downchirp, gen_chirp, modulate_symbols
from ..utils.params import LoraParams
from . import modem, sync

QUARTER_DEN = 4  # 2.25 downchirps: 2 full + step/4 samples


def frame_overhead_samples(params: LoraParams, preamble_len: int = 8) -> int:
    """Samples before the payload symbols: preamble + 2 sync + 2.25 down."""
    step = params.step
    return (preamble_len + 2) * step + 2 * step + step // QUARTER_DEN


def frame_modulate(symbols, params: LoraParams, preamble_len: int = 8,
                   amplitude: float = 1.0, symbol_phase_carry: bool = True):
    """Build a full LoRa frame: ``preamble_len`` base upchirps, 2 sync-word
    upchirps, 2.25 base downchirps, then payload upchirps.

    [..., S] symbols -> [..., overhead + S*step] complex64.
    ``symbol_phase_carry=False`` starts every symbol chirp at phase 0
    (the gr-lora_sdr modulator builds each symbol independently; its
    preambles then carry NO per-symbol phase step, which is what the
    gr decode path's ``tx_phase_step=0.0`` estimator expects — with the
    lattice carry left on, the estimator sits at exactly half a bin and
    the decision becomes an ULP coin flip).
    """
    symbols = jnp.asarray(symbols)
    step = params.step
    # preamble upchirps + sync + payload ride the lattice modulator: the
    # preamble is just `preamble_len` zero-symbols before the sync pair.
    zeros = jnp.zeros(symbols.shape[:-1] + (preamble_len,), jnp.int32)
    # modulate_symbols emits [sync, sync, data...]; we need the preamble
    # *before* the sync, so modulate zeros+payload and reorder segments.
    body = modulate_symbols(symbols, params.sf, params.osr, params.scale,
                            amplitude, params.sync_word,
                            params.continuous_chirp,
                            symbol_phase_carry)           # [..., (S+2)*step]
    pre = modulate_symbols(zeros[..., 2:], params.sf, params.osr, params.scale,
                           amplitude, 0x00,
                           params.continuous_chirp,
                           symbol_phase_carry)            # preamble upchirps
    # one phase-continuous 2.25-symbol downchirp (no copy seams, so any
    # fully-covered RX window dechirps to a clean single tone)
    down_sec, _ = gen_chirp(
        params.n, params.osr, 2 * step + step // QUARTER_DEN, 0.0,
        down=True, ampl=amplitude, bw_scale=params.scale,
    )
    down_sec = jnp.broadcast_to(down_sec, symbols.shape[:-1] + down_sec.shape)
    return jnp.concatenate(
        [pre[..., : preamble_len * step], body[..., : 2 * step], down_sec,
         body[..., 2 * step:]], axis=-1,
    )


def frame_modulate_planar(symbols, params: LoraParams, preamble_len: int = 8,
                          amplitude: float = 1.0, sync_symbols=None):
    """Planar (re, im float32) twin of :func:`frame_modulate` — the full
    frame synthesizer with no complex dtype. Planes are bit-exact
    with ``split_complex(frame_modulate(...))`` (same lattice modulator,
    same float64 host oracle for the 2.25-symbol downchirp).

    ``sync_symbols``: optional TRACED ``[..., 2]`` sync-chirp symbol
    values overriding the static ``params.sync_word`` — a data-dependent
    sync word then does not retrace the jit (the SIC loop resynthesizes
    with each frame's RECOVERED word).

    [..., S] symbols -> ((re, im) each [..., overhead + S*step] float32).
    """
    from ..ops.chirp import (_mod_chirps_planar, gen_chirp_np,
                             modulate_symbols_planar)

    symbols = jnp.asarray(symbols)
    step = params.step
    zeros = jnp.zeros(symbols.shape[:-1] + (preamble_len,), jnp.int32)
    if sync_symbols is None:
        br, bi = modulate_symbols_planar(
            symbols, params.sf, params.osr, params.scale, amplitude,
            params.sync_word, params.continuous_chirp)
    else:
        allsyms = jnp.concatenate(
            [jnp.asarray(sync_symbols, jnp.int32),
             symbols.astype(jnp.int32)], axis=-1)
        ampl_c = float(np.clip(amplitude, -1.0, 1.0))
        re_c, im_c = _mod_chirps_planar(
            allsyms, params.n, params.osr, int(round(params.scale * 8)),
            ampl_c, params.continuous_chirp)
        br = re_c.reshape(*re_c.shape[:-2], -1)
        bi = im_c.reshape(*im_c.shape[:-2], -1)
    pr, pi = modulate_symbols_planar(
        zeros[..., 2:], params.sf, params.osr, params.scale, amplitude,
        0x00, params.continuous_chirp)
    down_c, _ = gen_chirp_np(
        params.n, params.osr, 2 * step + step // QUARTER_DEN, 0.0,
        down=True, ampl=amplitude, bw_scale=params.scale,
    )
    out = []
    for body, pre, down in ((br, pr, down_c.real), (bi, pi, down_c.imag)):
        d = jnp.broadcast_to(jnp.asarray(down.astype(np.float32)),
                             symbols.shape[:-1] + down.shape)
        out.append(jnp.concatenate(
            [pre[..., : preamble_len * step], body[..., : 2 * step], d,
             body[..., 2 * step:]], axis=-1,
        ))
    return tuple(out)


class FrameSyncResult(NamedTuple):
    found: bool
    start: int            # sample index of the frame's first preamble sample
    cfo_bins: int         # integer CFO estimate in FFT bins
    payload_start: int    # sample index where payload symbols begin


def frame_sync(stream, params: LoraParams, preamble_len: int = 8,
               min_power_db: float | None = None) -> FrameSyncResult:
    """Locate the first frame in a continuous stream (single channel).

    The entire scan — two-sided dechirp, batched FFT bins, preamble
    run-length detection, downchirp pairing, timing/CFO split — runs in ONE
    device call (models/sync.frame_sync_scan_planar); the host only reads
    the per-window candidate arrays and picks the first valid one.
    ``min_power_db`` gates candidates on preamble peak power (the Pothos
    demod block's ``thresh``; None = no gate).
    """
    stream = np.asarray(stream)
    step = params.step
    nwin = int(stream.shape[-1]) // step
    if nwin < preamble_len + 5:
        return FrameSyncResult(False, 0, 0, 0)
    scan = sync.frame_sync_scan_planar(
        np.ascontiguousarray(stream.real.astype(np.float32)),
        np.ascontiguousarray(stream.imag.astype(np.float32)),
        params, preamble_len, min_power_db=min_power_db,
    )
    valid_w = np.flatnonzero(np.asarray(scan.valid))
    if valid_w.size == 0:
        return FrameSyncResult(False, 0, 0, 0)
    down = None
    for w in valid_w:
        start = int(np.asarray(scan.start)[w])
        cfo_bins = int(np.asarray(scan.cfo_bins)[w])
        # Run-end fuzz (see sync.receive_block_planar): the true start is
        # `start` or `start + step`. Probe both with the asymmetric
        # 2-window score — up-dechirped window 9 (second sync upchirp) +
        # down-dechirped window 10 (first full SFD downchirp) — only the
        # correct hypothesis concentrates BOTH (the SFD window alone
        # would tie: windows 10 and 11 are both downchirps).
        if down is None:
            down = np.asarray(
                base_downchirp(params.sf, params.scale, params.osr))

        def _peak(pos, ref):
            seg = np.zeros(step, np.complex64)
            src = stream[max(pos, 0): max(pos + step, 0)]
            seg[: src.shape[-1]] = src
            spec = np.fft.fft((seg * ref).reshape(
                params.n, params.osr)[:, 0])
            return float(np.max(np.abs(spec)))

        def score(s0):
            return (_peak(s0 + (preamble_len + 1) * step, down)
                    + _peak(s0 + (preamble_len + 2) * step,
                            np.conj(down)))

        if score(start + step) > score(start):
            start += step
        if start < 0:
            continue                  # unrescued negative-start alias:
            #                           try the next candidate window
        payload_start = start + frame_overhead_samples(params, preamble_len)
        return FrameSyncResult(True, start, cfo_bins, payload_start)
    return FrameSyncResult(False, 0, 0, 0)


def first_candidate(scan) -> tuple[int, int] | None:
    """(start, cfo_bins) of the first valid candidate in a 1-D SyncScan."""
    valid = np.asarray(scan.valid)
    hits = np.flatnonzero(valid)
    if hits.size == 0:
        return None
    w = int(hits[0])
    return int(np.asarray(scan.start)[w]), int(np.asarray(scan.cfo_bins)[w])


def frame_demodulate(stream, params: LoraParams, n_payload_symbols: int,
                     preamble_len: int = 8,
                     min_power_db: float | None = None,
                     return_spectra: bool = False,
                     tx_phase_step: float | None = None,
                     sync_result: FrameSyncResult | None = None):
    """Sync + demodulate one frame from a continuous stream. Returns
    (symbols [n_payload_symbols], sync_result). The payload section is
    dechirped and routed through the working demod path with the sync
    symbols re-attached from the stream's sync section (so the standard
    2-symbol estimator sees the true sync chirps).

    ``return_spectra=True`` returns ``(out, res, mag2)`` where ``mag2``
    is the [n_payload_symbols, N] |DFT|² of the data symbols (same
    window/derotation as the decisions) — the soft-decision input
    (models.soft).

    ``tx_phase_step`` is the TRANSMITTER's deterministic inter-symbol
    phase delta on preamble upchirps, subtracted from the fine CFO
    phase-slope term. ``None`` = this framework's own lattice modulator
    (ops.planar._preamble_phase_step). Pass ``0.0`` for gr-lora_sdr
    transmitters (measured: their preamble carries no per-symbol phase
    step — the OTA capture decodes bit-exactly with 0 and one bin off
    with ours).

    ``sync_result``: a precomputed :func:`frame_sync` result — callers
    that already scanned (gr_interop.decode_frame, the flowgraph demod
    block) pass it so the whole-stream scan is not re-run here (it is
    the dominant cost per frame)."""
    res = sync_result if sync_result is not None else frame_sync(
        stream, params, preamble_len, min_power_db=min_power_db)
    if not res.found:
        return None, res
    step = params.step
    sync_start = res.start + preamble_len * step
    pre_sec = stream[..., res.start: sync_start]
    sync_sec = stream[..., sync_start: sync_start + 2 * step]
    payload_sec = stream[..., res.payload_start:
                         res.payload_start + n_payload_symbols * step]
    if payload_sec.shape[-1] < n_payload_symbols * step:
        return None, FrameSyncResult(False, res.start, res.cfo_bins, res.payload_start)
    window = jnp.concatenate([sync_sec, payload_sec], axis=-1)
    if res.cfo_bins != 0:
        # undo the integer-bin CFO found by the two-sided sync
        import math

        idx = jnp.arange(window.shape[-1], dtype=jnp.float32)
        ph = (-2.0 * math.pi * res.cfo_bins / step) * idx
        window = window * jnp.exp(1j * ph.astype(jnp.float32))
        idx_p = jnp.arange(pre_sec.shape[-1], dtype=jnp.float32)
        ph_p = (-2.0 * math.pi * res.cfo_bins / step) * idx_p
        pre_sec = pre_sec * jnp.exp(1j * ph_p.astype(jnp.float32))
    # residual (fractional) CFO anchored on the preamble — unbiased for
    # any sync word, unlike the inline sync-pair estimator (see
    # ops.planar.estimate_preamble_planar)
    from ..ops.planar import _preamble_phase_step, estimate_preamble_planar

    pre_dech = np.asarray(modem.dechirp(pre_sec, params))
    if tx_phase_step is None:
        tx_phase_step = _preamble_phase_step(params.sf, params.osr,
                                             params.scale)
    cfo_resid = estimate_preamble_planar(
        jnp.asarray(np.ascontiguousarray(pre_dech.real)),
        jnp.asarray(np.ascontiguousarray(pre_dech.imag)),
        params.n, params.osr, phase_step=tx_phase_step,
    )
    dech = modem.dechirp(window, params)
    out = modem.demodulate(
        dech, params, known_offsets=(cfo_resid, jnp.zeros_like(cfo_resid))
    )
    if not return_spectra:
        return out, res
    from ..ops.planar import demodulate_spectrum_planar

    d = np.asarray(dech)
    mag2, _, _, _ = demodulate_spectrum_planar(
        jnp.asarray(np.ascontiguousarray(d.real)),
        jnp.asarray(np.ascontiguousarray(d.imag)),
        params, known_offsets=(cfo_resid, jnp.zeros_like(cfo_resid)),
    )
    return out, res, mag2


class StreamState(NamedTuple):
    """Carried tail between blocks — the explicit resumable state pytree
    that replaces the reference's in-workspace implicit state."""

    tail: jnp.ndarray      # [tail_len] last samples of the previous block
    consumed: int          # absolute sample index of the start of `tail`


class StreamDemodulator:
    """Block-wise frame receiver over a continuous stream.

    Feed arbitrary consecutive blocks; frames fully contained in
    (tail + block) are demodulated and returned; the unconsumed tail
    carries forward. Block size must exceed one frame length.
    """

    def __init__(self, params: LoraParams, n_payload_symbols: int,
                 preamble_len: int = 8):
        self.params = params
        self.n_payload_symbols = n_payload_symbols
        self.preamble_len = preamble_len
        self.frame_len = (
            frame_overhead_samples(params, preamble_len)
            + n_payload_symbols * params.step
        )

    def init_state(self) -> StreamState:
        return StreamState(jnp.zeros((0,), jnp.complex64), 0)

    def process(self, state: StreamState, block):
        """Returns (new_state, list of (abs_start, DemodResult))."""
        buf = jnp.concatenate([state.tail, jnp.asarray(block)], axis=-1)
        base = state.consumed
        frames = []
        offset = 0
        while buf.shape[-1] - offset >= self.frame_len:
            segment = buf[offset:]
            out, res = frame_demodulate(
                segment, self.params, self.n_payload_symbols, self.preamble_len
            )
            if out is None:
                if not res.found and res.payload_start > 0:
                    # frame detected but its payload runs past the block
                    # end: carry everything from the frame start forward
                    offset += res.start
                break
            frames.append((base + offset + res.start, out))
            # continue scanning right after this frame's payload
            offset += res.payload_start + self.n_payload_symbols * self.params.step
        keep = min(buf.shape[-1] - offset, self.frame_len + self.params.step)
        new_tail = buf[buf.shape[-1] - keep:]
        new_state = StreamState(new_tail, base + buf.shape[-1] - keep)
        return new_state, frames


class PlanarStreamState(NamedTuple):
    """Planar (complex-free) stream carry for the batched block receiver."""

    tail_re: np.ndarray
    tail_im: np.ndarray
    consumed: int


class BatchStreamDemodulator:
    """Block-wise frame receiver where the scan, candidate selection,
    window extraction, CFO derotation, dechirp and demod of up to
    ``max_frames`` frames run as ONE device program per block
    (models/sync.receive_block_planar) on planar float32 planes — the
    deployment replacement for :class:`StreamDemodulator`'s serial
    per-frame host loop. The host keeps only the tail carry.

    Feed fixed-size blocks (a varying block size retraces the jit).
    """

    def __init__(self, params: LoraParams, n_payload_symbols: int,
                 preamble_len: int = 8, max_frames: int = 8):
        self.params = params
        self.n_payload_symbols = n_payload_symbols
        self.preamble_len = preamble_len
        self.max_frames = max_frames
        self.frame_len = (
            frame_overhead_samples(params, preamble_len)
            + n_payload_symbols * params.step
        )

    def init_state(self) -> PlanarStreamState:
        z = np.zeros(0, np.float32)
        return PlanarStreamState(z, z, 0)

    def process(self, state: PlanarStreamState, block_re, block_im):
        """Returns (new_state, list of (abs_start, symbols, sync, cfo_bins))."""
        buf_re = np.concatenate([state.tail_re, np.asarray(block_re)])
        buf_im = np.concatenate([state.tail_im, np.asarray(block_im)])
        base = state.consumed
        blk = sync.receive_block_planar(
            buf_re, buf_im, self.params, self.n_payload_symbols,
            self.max_frames, self.preamble_len,
        )
        found = np.asarray(blk.found)
        starts = np.asarray(blk.start)
        frames = []
        last_end = 0
        for k in np.flatnonzero(found):
            frames.append((
                base + int(starts[k]),
                np.asarray(blk.symbols)[k],
                int(np.asarray(blk.sync)[k]),
                int(np.asarray(blk.cfo_bins)[k]),
            ))
            last_end = int(starts[k]) + self.frame_len
        if found.all():
            # the block may hold more than max_frames: keep everything
            # after the last extracted frame for the next pass
            offset = last_end
        else:
            offset = max(last_end, buf_re.size - self.frame_len -
                         self.params.step)
        offset = max(0, min(offset, buf_re.size))
        new_state = PlanarStreamState(
            buf_re[offset:], buf_im[offset:], base + offset
        )
        return new_state, frames


# ---------------------------------------------------------------------------
# Checkpoint / resume (SURVEY.md §5.4: the reference has none; the stream
# carry state here is an explicit pytree, so block-wise processing is
# resumable and shardable)
# ---------------------------------------------------------------------------

def save_state(state: StreamState, path) -> None:
    """Persist a stream carry state (tail samples + absolute position).
    Writes to EXACTLY ``path`` (a bare np.savez(path) would append
    '.npz', breaking resume for any other extension)."""
    tail = np.asarray(state.tail)
    with open(path, "wb") as f:
        np.savez(f, tail_re=tail.real.astype(np.float32),
                 tail_im=tail.imag.astype(np.float32),
                 consumed=np.int64(state.consumed))


def load_state(path) -> StreamState:
    z = np.load(path)
    tail = (z["tail_re"] + 1j * z["tail_im"]).astype(np.complex64)
    return StreamState(jnp.asarray(tail), int(z["consumed"]))


# ---------------------------------------------------------------------------
# Header-driven (adaptive) framing: payload length learned from the
# explicit header, so streams may carry frames of arbitrary sizes
# ---------------------------------------------------------------------------

def frame_encode(payload, cfg, params: LoraParams, preamble_len: int = 8):
    """Full self-describing frame: explicit header (coded.encode_header)
    + coded payload, wrapped in preamble/sync/2.25-downchirp framing.
    ``cfg`` is a models.coded.CodedConfig."""
    from . import coded

    payload = np.asarray(payload, np.uint8)
    hdr = coded.encode_header(len(payload), cfg)
    body = coded.encode_payload(payload, cfg)
    symbols = jnp.concatenate(
        [jnp.asarray(hdr, jnp.uint16), jnp.asarray(body, jnp.uint16)], axis=-1
    )
    return frame_modulate(symbols, params, preamble_len=preamble_len)


def frame_decode_adaptive(samples, params: LoraParams, preamble_len: int = 8,
                          soft: bool = False, ldro: bool = False,
                          min_power_db: float | None = None):
    """Sync one frame and decode it using only the stream contents: the
    8-symbol explicit header supplies payload length, CR and CRC mode.

    Returns ``(payload bytes | None, info dict, consumed_samples)``.
    ``soft=True`` decodes the payload from the symbol spectra via ML
    codeword correlation (models.soft; ~1 dB PER gain) — the header stays
    hard-decided (it is CR 4/8 at PPM sf-2, already the most robust cell).
    """
    from . import coded
    from .coded import CodedConfig

    res = frame_sync(samples, params, preamble_len,
                     min_power_db=min_power_db)
    if not res.found:
        return None, {"found": False}, 0
    step = params.step
    avail = (np.asarray(samples).shape[-1] - res.payload_start) // step
    if avail < 8:
        return None, {"found": False}, 0
    # cap at the longest possible frame (255-byte payload + CRC at CR
    # 4/8, under the configured rate): demodulating every symbol to the
    # buffer end made short-frame streams quadratic
    worst = 8 + coded.payload_symbol_count(
        255, CodedConfig(sf=params.sf, cr=4, ldro=ldro))
    avail = min(int(avail), worst)

    dm = frame_demodulate(samples, params, int(avail), preamble_len,
                          return_spectra=soft, sync_result=res)
    out = dm[0]
    if out is None:
        return None, {"found": False}, 0
    bins = np.asarray(out.symbols)

    nbytes, cr, crc_en, hdr_ok = coded.decode_header(bins[:8], params.sf)
    info = {
        "found": True, "start": res.start, "cfo_bins": res.cfo_bins,
        "length": nbytes, "cr": cr, "crc": crc_en, "header_ok": hdr_ok,
    }
    if not hdr_ok or not (1 <= cr <= 4) or nbytes == 0:
        return None, info, res.start + step
    # LDRO is channel configuration (implied by SF/BW at both ends, not
    # signalled in the header — coded.encode_header) — the caller supplies it
    cfg = CodedConfig(sf=params.sf, cr=cr, crc=crc_en, ldro=ldro)
    nsym = coded.payload_symbol_count(nbytes, cfg)
    if bins.shape[-1] - 8 < nsym:
        return None, {**info, "truncated": True}, 0
    if soft:
        from . import soft as softmod

        mag2 = np.asarray(dm[2])
        payload, crc_ok, margin = softmod.decode_payload_soft(
            mag2[8:8 + nsym], nbytes, cfg)
        info["soft_margin"] = float(np.asarray(margin))
        fec_err = 0
    else:
        payload, crc_ok, fec_err = coded.decode_payload(
            bins[8:8 + nsym], nbytes, cfg)
    info["crc_ok"] = bool(np.all(np.asarray(crc_ok)))
    info["fec_errors"] = int(np.asarray(fec_err))
    consumed = (res.payload_start + (8 + nsym) * step)
    return np.asarray(payload).tobytes(), info, consumed


class AdaptiveStreamDemodulator:
    """Block-wise receiver for self-describing frames (explicit headers):
    no prior knowledge of payload sizes; carries a tail between blocks."""

    def __init__(self, params: LoraParams, preamble_len: int = 8,
                 max_frame_len: int | None = None, soft: bool = False,
                 ldro: bool = False, min_power_db: float | None = None):
        self.params = params
        self.preamble_len = preamble_len
        self.soft = soft
        self.ldro = ldro
        self.min_power_db = min_power_db
        # worst case: 255-byte payload + CRC at CR 4/8 (LDRO frames run
        # at PPM = sf-2 and are LONGER — sizing without it trimmed the
        # carried tail below a boundary-spanning LDRO frame's length)
        if max_frame_len is None:
            from .coded import CodedConfig

            from . import coded
            worst = coded.payload_symbol_count(
                255, CodedConfig(sf=params.sf, cr=4, ldro=ldro)
            )
            max_frame_len = (
                frame_overhead_samples(params, preamble_len)
                + (8 + worst) * params.step
            )
        self.max_frame_len = max_frame_len

    def init_state(self) -> StreamState:
        return StreamState(jnp.zeros((0,), jnp.complex64), 0)

    def process(self, state: StreamState, block):
        buf = jnp.concatenate([state.tail, jnp.asarray(block)], axis=-1)
        base = state.consumed
        frames = []
        offset = 0
        while buf.shape[-1] - offset >= 16 * self.params.step:
            payload, info, consumed = frame_decode_adaptive(
                buf[offset:], self.params, self.preamble_len,
                soft=self.soft, ldro=self.ldro,
                min_power_db=self.min_power_db,
            )
            if payload is not None:
                frames.append((base + offset + info["start"], payload, info))
                offset += consumed
            elif info.get("found") and consumed > 0:
                offset += consumed      # bad header: skip this sync point
            else:
                break                   # nothing (or truncated): wait for more
        keep = min(buf.shape[-1] - offset, self.max_frame_len + self.params.step)
        new_tail = buf[buf.shape[-1] - keep:]
        return StreamState(new_tail, base + buf.shape[-1] - keep), frames
