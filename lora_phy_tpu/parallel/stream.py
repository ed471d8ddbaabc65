"""Time-sharded continuous-stream demodulation with overlap-save halos.

Sharded replacement for the reference's whole-buffer-in-memory
demodulator (``base = s*step`` absolute indexing, reference:
src/phy/LoRaDemod.cpp:141-149; sequence-scaling analysis in SURVEY.md §5.7):

* the IQ stream is sharded into consecutive time blocks across the mesh's
  ``time`` axis (one shard per device group), frames/channels along
  ``channel``;
* the timing-offset shift reads up to one symbol across block boundaries,
  so each shard exchanges a one-symbol **overlap-save halo** with both
  neighbours via ``jax.lax.ppermute`` (SURVEY.md §5.7a);
* the 2-symbol CFO/TO estimate is computed where the frame head lives
  (time-shard 0) and broadcast to all shards with a ``psum`` — the
  collective replacement for the reference's shared workspace metrics;
* CFO derotation phase depends on the *global* symbol index
  (LoRaDemod.cpp:151-152), which each shard reconstructs from its mesh
  coordinate — the "shards must agree on absolute index" seam called out
  in SURVEY.md §5.7.

The complex and planar paths share ONE collective body
(:func:`_stream_demod_core`), parameterized over three plane operations
(normalisation absmax, offset estimate, derotate+detect) so the halo /
psum / global-index recipe cannot diverge between them.

:func:`receive_stream_block_planar` closes SURVEY.md §5.7b: the full
frame-SYNC scan + block receiver runs under ``shard_map`` with a
frame-length right halo, so frames at ARBITRARY stream positions —
including straddling shard seams — are found and demodulated on the mesh
(the single-device contract is ``models.sync.receive_block_planar``).

Results are bit-identical to the single-device paths for in-range timing
shifts (gated by tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..models.modem import _estimate, _round_half_away, _window_table, _sync_from_symbols
from ..models.sync import BlockFrames, receive_block_planar
from ..models.stream import frame_overhead_samples
from ..ops.detect import detect
from ..ops.planar import _estimate_planar, detect_planar
from ..utils.params import LoraParams
from .mesh import CHANNEL_AXIS, TIME_AXIS

_TWO_PI = 2.0 * jnp.pi


def _stream_demod_core(x, params: LoraParams, time_axis: str,
                       absmax, estimate, finish, comm: bool = True):
    """Shared per-shard body of the time-sharded streaming demod (runs
    under shard_map). ``x``: [..., L] — one complex stream, or stacked
    (re, im) float32 planes with the plane axis riding the batch dims
    (collectives, halo selects and the window machinery are
    plane-agnostic). The three closures carry everything that differs:

    * ``absmax(x) -> [...]-per-channel`` local max(|re|, |im|),
    * ``estimate(head) -> (cfo, to)`` on the first 2 symbol periods,
    * ``finish(sym, rate) -> symbol indices`` (derotate + window + DFT +
      argmax on the [..., S, N] windows).

    ``comm=False`` is a MEASUREMENT-ONLY knob (runners/bench_scaling.py's
    collective-vs-compute split): every cross-shard collective (pmax,
    2x ppermute halo, 2x psum broadcast) is replaced by its local stub so
    the identical per-shard compute runs with zero communication. Results
    are wrong at shard seams — never use it for decoding.
    """
    n, osr, step = params.n, params.osr, params.step
    halo = step
    L = x.shape[-1]
    s_per_block = L // step

    t_idx = jax.lax.axis_index(time_axis)
    t_size = jax.lax.axis_size(time_axis)

    # --- global per-channel amplitude normalisation (LoRaDemod.cpp:59-77) -
    max_amp = absmax(x)
    if comm:
        max_amp = jax.lax.pmax(max_amp, time_axis)
    scale = jnp.where(max_amp > 1.0, 1.0 / max_amp, 1.0).astype(jnp.float32)
    x = x * scale[..., None]

    # --- overlap-save halo exchange (ring; edge devices get zeros masked).
    # Planar planes ride each collective stacked, halving the ppermute
    # count; the complex path sends one array the same way.
    if comm:
        right_halo = jax.lax.ppermute(
            x[..., :halo], time_axis,             # my head -> left neighbour
            [(i, (i - 1) % t_size) for i in range(t_size)],
        )
        left_halo = jax.lax.ppermute(
            x[..., -halo:], time_axis,            # my tail -> right neighbour
            [(i, (i + 1) % t_size) for i in range(t_size)],
        )
        left_halo = jnp.where(t_idx == 0, 0.0, left_halo)
        right_halo = jnp.where(t_idx == t_size - 1, 0.0, right_halo)
    else:
        left_halo = jnp.zeros_like(x[..., :halo])
        right_halo = jnp.zeros_like(x[..., :halo])
    ext = jnp.concatenate([left_halo, x, right_halo], axis=-1)

    # --- frame-head CFO/TO estimate, broadcast from time-shard 0 ----------
    cfo_l, to_l = estimate(x[..., : 2 * step])
    if comm:
        sel = (t_idx == 0).astype(cfo_l.dtype)
        cfo = jax.lax.psum(cfo_l * sel, time_axis)
        time_offset = jax.lax.psum(to_l * sel, time_axis)
    else:
        cfo, time_offset = cfo_l, to_l

    t_off = _round_half_away(time_offset).astype(jnp.int32)
    rate = (-jnp.float32(_TWO_PI) * cfo / jnp.float32(n)).astype(jnp.float32)

    # --- shifted symbol windows from the extended (haloed) buffer ---------
    # contiguous per-row dynamic slices instead of element gathers (as in
    # modem._shifted_rows)
    total = t_size * L                      # global stream length

    def slice_rows(offset):
        """ext[..., offset : offset+L] with per-channel traced offset."""
        flat_ext = ext.reshape(-1, ext.shape[-1])
        off = jnp.broadcast_to(offset, ext.shape[:-1]).reshape(-1)
        rows = jax.vmap(
            lambda row, st: jax.lax.dynamic_slice(row, (st,), (L,))
        )(flat_ext, off)
        return rows.reshape(*ext.shape[:-1], L)

    def symview(a):
        v = a.reshape(*a.shape[:-1], s_per_block, n, osr)
        return v[..., 0]

    base_view = ext[..., halo: halo + L]
    shift_view = slice_rows(jnp.clip(t_off + halo, 0, 2 * halo))

    s_local = jnp.arange(s_per_block, dtype=jnp.int32)
    g_base = t_idx.astype(jnp.int32) * L + s_local * step   # global base
    t = t_off[..., None]
    use_shift = ((t > 0) & (g_base + t + step <= total)) | (
        (t < 0) & (-t <= g_base)
    )
    sym = jnp.where(use_shift[..., None], symview(shift_view), symview(base_view))

    # --- CFO derotation (inside ``finish``): only the per-sample ramp.
    # The reference's full phase is rate*(s_global*N + t_off/osr) + rate*i;
    # the global-symbol-index start term is constant WITHIN a symbol, so it
    # contributes only a unimodular per-symbol phase — invisible to the
    # magnitude-based detector (modem._derotation_vector documents and
    # drops it on the single-device path).
    # Global-index CORRECTNESS still holds: shards agree because the
    # surviving ramp exp(j*rate*i) is index-free within the window.
    idx = finish(sym, rate)
    return idx.astype(jnp.uint16), cfo, time_offset


def _stream_demod_local(x_local, params: LoraParams, time_axis: str):
    """Complex per-shard body: thin closures over the shared core."""
    n, osr = params.n, params.osr
    window = _window_table(params)

    def absmax(x):
        return jnp.max(
            jnp.maximum(jnp.abs(jnp.real(x)), jnp.abs(jnp.imag(x))), axis=-1
        )

    def estimate(head):
        return _estimate(head, n, osr, window, tie_break_idx=True)

    def finish(sym, rate):
        ph = rate[..., None] * jnp.arange(n, dtype=jnp.float32)   # [..., N]
        rot = jax.lax.complex(jnp.cos(ph), jnp.sin(ph))[..., None, :]
        fft_in = sym * rot
        if window is not None:
            fft_in = fft_in * jnp.asarray(window)
        return detect(fft_in).index

    return _stream_demod_core(x_local, params, time_axis,
                              absmax, estimate, finish)


def _stream_demod_local_planar(xr, xi, params: LoraParams, time_axis: str,
                               comm: bool = True):
    """Planar (re, im float32) per-shard body — the same core on split
    planes stacked along a leading axis — the deployment layout of the
    time-sharded receiver."""
    n, osr = params.n, params.osr
    window = _window_table(params)

    def absmax(planes):
        return jnp.max(jnp.maximum(jnp.abs(planes[0]), jnp.abs(planes[1])),
                       axis=-1)

    def estimate(head):
        return _estimate_planar(head[0], head[1], n, osr, window,
                                tie_break_idx=True)

    def finish(sym, rate):
        sr, si = sym[0], sym[1]
        ph = rate[..., None] * jnp.arange(n, dtype=jnp.float32)   # [..., N]
        c = jnp.cos(ph)[..., None, :]
        s = jnp.sin(ph)[..., None, :]
        fr = sr * c - si * s
        fi = sr * s + si * c
        if window is not None:
            w = jnp.asarray(window)
            fr, fi = fr * w, fi * w
        return detect_planar(fr, fi, n).index

    # planes stacked on a leading axis: the per-channel scale/cfo/t_off
    # [...]-shapes broadcast across it, and both planes ride each
    # collective in one ppermute
    planes = jnp.stack([xr, xi], axis=0)
    return _stream_demod_core(planes, params, time_axis,
                              absmax, estimate, finish, comm=comm)


@partial(jax.jit, static_argnames=("params", "mesh", "comm"))
def demodulate_stream_planar(xr, xi, params: LoraParams, mesh: Mesh,
                             comm: bool = True):
    """Planar twin of :func:`demodulate_stream`: a dechirped continuous
    stream as (re, im) float32 planes sharded over ``(channel, time)``.
    Bit-identical symbols to the complex path (tests/test_parallel.py).

    ``comm=False`` stubs every cross-shard collective for the scaling
    harness's collective-vs-compute split (measurement only — wrong at
    shard seams; see :func:`_stream_demod_core`)."""
    fn = shard_map(
        partial(_stream_demod_local_planar, params=params,
                time_axis=TIME_AXIS, comm=comm),
        mesh=mesh,
        in_specs=(P(CHANNEL_AXIS, TIME_AXIS), P(CHANNEL_AXIS, TIME_AXIS)),
        out_specs=(P(CHANNEL_AXIS, TIME_AXIS), P(CHANNEL_AXIS), P(CHANNEL_AXIS)),
        # comm=False outputs skip the psum broadcast, so cfo/time_offset
        # are formally time-varying — the replication check must be off
        # for the measurement stub (values at non-zero time shards are
        # discarded anyway)
        check_vma=comm,
    )
    syms, cfo, time_offset = fn(xr, xi)
    sync = _sync_from_symbols(
        syms[..., 0].astype(jnp.int32), syms[..., 1].astype(jnp.int32), params.sf
    )
    return syms, sync, cfo, time_offset


@partial(jax.jit, static_argnames=("params", "mesh"))
def demodulate_stream(samples, params: LoraParams, mesh: Mesh):
    """Demodulate a dechirped continuous stream sharded over
    ``(channel, time)``.

    ``samples``: [channels, T] complex64 (T divisible by
    ``time_axis_size * step``). The first two symbols of the stream are the
    sync word (reference contract). Returns
    ``(symbols [channels, T/step], sync [channels], cfo, time_offset)``
    with symbols sharded like the input.
    """
    fn = shard_map(
        partial(_stream_demod_local, params=params, time_axis=TIME_AXIS),
        mesh=mesh,
        in_specs=P(CHANNEL_AXIS, TIME_AXIS),
        out_specs=(P(CHANNEL_AXIS, TIME_AXIS), P(CHANNEL_AXIS), P(CHANNEL_AXIS)),
    )
    syms, cfo, time_offset = fn(samples)
    sync = _sync_from_symbols(
        syms[..., 0].astype(jnp.int32), syms[..., 1].astype(jnp.int32), params.sf
    )
    return syms, sync, cfo, time_offset


# ---------------------------------------------------------------------------
# Time-sharded frame-SYNC scan + block receive (SURVEY.md §5.7b)
# ---------------------------------------------------------------------------

def _receive_block_local(xr, xi, params: LoraParams, n_payload_symbols: int,
                         max_frames: int, preamble_len: int,
                         min_power_db, pre_acc: int, halo_steps: int,
                         time_axis: str, tx_phase_step=None,
                         with_spectra: bool = False):
    """Per-shard body: raw-stream frame scan + demod over the local block
    extended by a frame-length RIGHT halo.

    A LoRa frame is detected from its preamble (which begins at the frame
    start), so a frame starting inside my block — even at its very last
    sample — is fully visible in ``local ++ right-halo``; no left halo is
    needed. Ownership is by frame-START position: shard ``t`` claims
    frames with resolved start in ``[0, L)`` local samples. The same
    frame seen by the left neighbour (start >= its L) or the right
    neighbour (start < 0 after its probe resolution) fails the claim
    there, so every frame is reported exactly once.
    """
    step = params.step
    L = xr.shape[-1]
    halo = halo_steps * step

    t_idx = jax.lax.axis_index(time_axis)
    t_size = jax.lax.axis_size(time_axis)

    planes = jnp.stack([xr, xi], axis=0)
    right_halo = jax.lax.ppermute(
        planes[..., :halo], time_axis,
        [(i, (i - 1) % t_size) for i in range(t_size)],
    )
    right_halo = jnp.where(t_idx == t_size - 1, 0.0, right_halo)
    ext = jnp.concatenate([planes, right_halo], axis=-1)

    res = receive_block_planar(
        ext[0], ext[1], params, n_payload_symbols, max_frames,
        preamble_len, min_power_db=min_power_db, pre_acc=pre_acc,
        tx_phase_step=tx_phase_step, with_spectra=with_spectra,
    )
    blk, spectra = res if with_spectra else (res, None)
    # claim: start in [0, L) — receive_block_planar already enforces
    # start >= 0 (negative-start aliases the left neighbour owns)
    found = blk.found & (blk.start < L)
    g_start = blk.start + t_idx.astype(jnp.int32) * L
    # the per-shard fits check ran against L + halo, but the last shard's
    # halo is zero fill PAST the global stream end — re-check the fit
    # against the true global length or a frame truncated by end-of-stream
    # is reported found with argmax-over-zeros payload symbols (the
    # single-device receiver returns found=False for it)
    overhead = frame_overhead_samples(params, preamble_len)
    g_end = g_start + overhead + n_payload_symbols * step
    found = found & (g_end <= t_size * L)
    out = (found, g_start, blk.cfo_bins, blk.symbols, blk.sync,
           blk.cfo, blk.time_offset, blk.snr_db, blk.sro_ppm)
    return out + (spectra,) if with_spectra else out


def _halo_steps(params: LoraParams, n_payload_symbols: int,
                preamble_len: int) -> int:
    """Right-halo length (in symbol steps) the sharded scan needs: one
    full frame plus the block receiver's probe margin."""
    win_full = (frame_overhead_samples(params, preamble_len)
                + n_payload_symbols * params.step)
    return -(-win_full // params.step) + 4


@partial(jax.jit, static_argnames=("params", "n_payload_symbols", "mesh",
                                   "max_frames", "preamble_len",
                                   "min_power_db", "pre_acc",
                                   "tx_phase_step", "with_spectra"))
def receive_stream_block_planar(xr, xi, params: LoraParams,
                                n_payload_symbols: int, mesh: Mesh,
                                max_frames: int = 4,
                                preamble_len: int = 8,
                                min_power_db: float | None = None,
                                pre_acc: int = 1,
                                tx_phase_step: float | None = None,
                                with_spectra: bool = False) -> BlockFrames:
    """Mesh-sharded raw-stream receiver: the full frame-sync scan +
    candidate selection + SFD probe + demod of ``models.sync.
    receive_block_planar`` under ``shard_map`` over ``(channel, time)``.

    Frames may start at ARBITRARY sample positions — including straddling
    time-shard seams: each shard scans its block plus a frame-length
    overlap-save halo ppermuted from its right neighbour (the mesh
    replacement for the reference's absolute whole-buffer indexing,
    src/phy/LoRaDemod.cpp:141-152), and claims exactly the frames that
    START inside its block. Returns :class:`~..models.sync.BlockFrames`
    with ``start`` in GLOBAL stream samples and ``max_frames * n_time``
    candidate slots per channel (per-shard slots concatenated in
    time-shard order; ``max_frames`` is the per-shard cap).

    Equality with the single-device block receiver for frames placed
    across every seam is gated by tests/test_parallel.py.

    ``with_spectra=True`` returns ``(BlockFrames, spectra)`` with
    per-frame payload spectra ``[..., n_time * K, n_payload, n]`` in
    true bin order (the soft-decision input; see the single-device
    docstring), sharded like the other per-candidate outputs.
    ``tx_phase_step=0.0`` for gr-lora_sdr transmitters — both knobs are
    straight passthroughs to the per-shard block receiver, so soft
    decoding and pre_acc>1 multipath-robust receive compose with the
    mesh exactly as on one device.
    """
    step = params.step
    # the gathered candidate buffer reaches nwin_f = win//step + 4 windows
    # past the frame start (receive_block_planar's margin for the shift
    # row and the +/-step probe hypotheses)
    halo_steps = _halo_steps(params, n_payload_symbols, preamble_len)
    t_size = mesh.shape[TIME_AXIS]
    block = xr.shape[-1] // t_size
    if halo_steps * step > block:
        raise ValueError(
            f"time-shard block of {block} samples is shorter than one "
            f"frame + margin ({halo_steps * step}); use fewer time shards "
            "or longer blocks (the halo comes from the immediate "
            "neighbour only)")

    out_specs = (
        P(CHANNEL_AXIS, TIME_AXIS),          # found
        P(CHANNEL_AXIS, TIME_AXIS),          # start (global samples)
        P(CHANNEL_AXIS, TIME_AXIS),          # cfo_bins
        P(CHANNEL_AXIS, TIME_AXIS, None),    # symbols
        P(CHANNEL_AXIS, TIME_AXIS),          # sync
        P(CHANNEL_AXIS, TIME_AXIS),          # cfo
        P(CHANNEL_AXIS, TIME_AXIS),          # time_offset
        P(CHANNEL_AXIS, TIME_AXIS),          # snr_db
        P(CHANNEL_AXIS, TIME_AXIS),          # sro_ppm
    )
    if with_spectra:
        out_specs = out_specs + (P(CHANNEL_AXIS, TIME_AXIS, None, None),)
    fn = shard_map(
        partial(_receive_block_local, params=params,
                n_payload_symbols=n_payload_symbols, max_frames=max_frames,
                preamble_len=preamble_len, min_power_db=min_power_db,
                pre_acc=pre_acc, halo_steps=halo_steps,
                time_axis=TIME_AXIS, tx_phase_step=tx_phase_step,
                with_spectra=with_spectra),
        mesh=mesh,
        in_specs=(P(CHANNEL_AXIS, TIME_AXIS), P(CHANNEL_AXIS, TIME_AXIS)),
        out_specs=out_specs,
    )
    res = fn(xr, xi)
    if with_spectra:
        return BlockFrames(*res[:-1]), res[-1]
    return BlockFrames(*res)


def receive_blind_stream_planar(xr, xi, base_params: LoraParams,
                                n_payload_symbols: int, mesh: Mesh,
                                sfs=(7, 8, 9, 10, 11, 12),
                                max_frames: int = 4,
                                preamble_len: int = 8,
                                min_power_db: float | None = -30.0,
                                pre_acc: int = 1):
    """Mesh twin of :func:`~..models.sync.receive_blind_planar`: the
    blind spreading-factor fan-out with each per-SF scan running as the
    time/channel-sharded :func:`receive_stream_block_planar` program.
    Returns ``{sf: BlockFrames}`` with GLOBAL ``start`` positions
    (feed to ``models.sync.blind_frames`` unchanged).

    SF discrimination is the scan's own (wrong-SF dechirp spreads energy
    across the spectrum — see the single-device docstring); the mesh adds
    nothing to the math, only the frame-length right-halo exchange per
    SF. SFs whose preamble cannot fit the stream, or whose frame+margin
    halo exceeds one time-shard block, are omitted from the result AND
    reported via ``warnings.warn`` — so 'not scanned' is distinguishable
    from 'scanned, no frames' (the single-device twin scans every SF).
    """
    import dataclasses
    import warnings

    t_size = mesh.shape[TIME_AXIS]
    block = xr.shape[-1] // t_size
    out = {}
    for sf in sfs:
        p = dataclasses.replace(base_params, sf=sf)
        skip = None
        if xr.shape[-1] // p.step < preamble_len + 4:
            skip = "stream shorter than preamble+margin"
        elif _halo_steps(p, n_payload_symbols, preamble_len) * p.step > block:
            skip = "frame + margin halo exceeds one time-shard block"
        elif block % p.step:
            skip = "time-shard seam does not land on a symbol boundary"
        if skip is not None:
            warnings.warn(
                f"blind mesh scan skipped SF{sf}: {skip} (block={block}, "
                f"step={p.step}); use fewer time shards or a longer stream",
                stacklevel=2)
            continue
        out[sf] = receive_stream_block_planar(
            xr, xi, p, n_payload_symbols, mesh, max_frames, preamble_len,
            min_power_db, pre_acc=pre_acc,
        )
    return out


# ---------------------------------------------------------------------------
# Checkpoint/resume for the sharded streaming receiver (SURVEY.md §5.4
# applied to the flagship mesh layout; the host-side twin is
# models/stream.py StreamState/BatchStreamDemodulator)
# ---------------------------------------------------------------------------

from typing import NamedTuple


class MeshStreamState(NamedTuple):
    """Carry state of :class:`MeshStreamDemodulator` — an explicit,
    serialisable pytree, so a time/channel-sharded gateway can stop at
    any block boundary and resume bit-exactly (no frame lost at a
    restart, including frames straddling the checkpoint boundary).

    ``emitted_start`` holds the EXACT starts of recently emitted frames
    (per channel, -1 padded, bounded by how many frames fit one carried
    tail) rather than a monotone high-water mark: a frame the previous
    block's ``max_frames`` cap dropped sits at an EARLIER start than
    later frames that were emitted, and the tail re-scan must still be
    allowed to emit it (a high-water dedupe would discard it forever)."""

    tail_re: np.ndarray        # [channels, keep] carried stream tail
    tail_im: np.ndarray        # [channels, keep]
    consumed: int              # absolute sample index of the tail start
    emitted_start: np.ndarray  # [channels, R] int64 recent starts, -1 pad
    n_frames: int              # frames emitted so far (observability)


class MeshStreamDemodulator:
    """Block-wise continuous-stream frame receiver on a ``(channel,
    time)`` mesh: every fed block rides ONE
    :func:`receive_stream_block_planar` program (sharded scan + seam
    halos + demod), and the host carries only a fixed-length stream tail
    plus per-channel dedupe marks between blocks.

    The tail is one frame + probe margin long (rounded up to the mesh
    time-axis granularity), so a frame straddling any block boundary is
    re-seen whole in the next call; frames re-found inside the carried
    tail are deduped by their absolute start (per channel, monotone —
    frames are emitted in stream order). Fixed block size + fixed tail
    means ONE compiled program in steady state.

    ``max_frames`` is the per-TIME-SHARD candidate cap (the sharded
    receiver's contract); a channel carrying more than ``max_frames``
    frames inside one shard-block drops the excess — size the cap to
    the expected duty cycle, as with the single-device receiver.
    """

    def __init__(self, params: LoraParams, n_payload_symbols: int,
                 mesh: Mesh, max_frames: int = 4, preamble_len: int = 8,
                 min_power_db: float | None = -30.0, pre_acc: int = 1,
                 tx_phase_step: float | None = None,
                 with_spectra: bool = False):
        self.params = params
        self.n_payload_symbols = n_payload_symbols
        self.mesh = mesh
        self.max_frames = max_frames
        self.preamble_len = preamble_len
        self.min_power_db = min_power_db
        self.pre_acc = pre_acc
        self.tx_phase_step = tx_phase_step
        self.with_spectra = with_spectra   # frames carry a "spectra" row
        self.t_size = mesh.shape[TIME_AXIS]
        self.unit = self.t_size * params.step    # fed-block granularity
        halo = _halo_steps(params, n_payload_symbols,
                           preamble_len) * params.step
        self.halo = halo
        self.keep = -(-halo // self.unit) * self.unit
        frame_len = (frame_overhead_samples(params, preamble_len)
                     + n_payload_symbols * params.step)
        # dedupe window: only frames STARTING inside the carried tail can
        # be re-found next call; the preamble alone bounds their packing
        self.n_recent = self.keep // (preamble_len * params.step) + 2
        self.frame_len = frame_len

    def init_state(self, n_channels: int) -> MeshStreamState:
        z = np.zeros((n_channels, self.keep), np.float32)
        return MeshStreamState(
            z, z.copy(), -self.keep,
            np.full((n_channels, self.n_recent), -1, np.int64), 0)

    def process(self, state: MeshStreamState, block_re, block_im):
        """Feed one ``[channels, B]`` block (``B`` a fixed multiple of
        ``t_size * step``). Returns ``(new_state, frames)`` where
        ``frames`` is a list of dicts ``{channel, start, symbols, sync,
        cfo_bins, cfo, snr_db, sro_ppm}`` with ``start`` in ABSOLUTE
        stream samples, in (channel, start) order."""
        from .mesh import stream_sharding

        block_re = np.asarray(block_re, np.float32)
        block_im = np.asarray(block_im, np.float32)
        b = block_re.shape[-1]
        if b % self.unit:
            raise ValueError(
                f"block length {b} must be a multiple of time_shards * "
                f"step = {self.unit}")
        if (self.keep + b) // self.t_size < self.halo:
            raise ValueError(
                f"block of {b} samples gives per-shard blocks of "
                f"{(self.keep + b) // self.t_size} < frame+margin halo "
                f"{self.halo}; feed at least "
                f"{self.halo * self.t_size - self.keep} samples per block")
        buf_r = np.concatenate([state.tail_re, block_re], axis=-1)
        buf_i = np.concatenate([state.tail_im, block_im], axis=-1)
        sh = stream_sharding(self.mesh)
        res = receive_stream_block_planar(
            jax.device_put(buf_r, sh), jax.device_put(buf_i, sh),
            self.params, self.n_payload_symbols, self.mesh,
            self.max_frames, self.preamble_len, self.min_power_db,
            pre_acc=self.pre_acc, tx_phase_step=self.tx_phase_step,
            with_spectra=self.with_spectra)
        blk, spec = res if self.with_spectra else (res, None)
        if spec is not None:
            spec = np.asarray(spec)
        found = np.asarray(blk.found)
        starts = np.asarray(blk.start)
        frames = []
        n = state.n_frames
        new_consumed = state.consumed + buf_r.shape[-1] - self.keep
        new_recent = np.full_like(state.emitted_start, -1)
        for c in range(found.shape[0]):
            seen = set(int(s) for s in state.emitted_start[c] if s >= 0)
            order = sorted(np.flatnonzero(found[c]),
                           key=lambda k: int(starts[c, k]))
            for k in order:
                abs_start = state.consumed + int(starts[c, k])
                if abs_start in seen:
                    continue            # re-found inside the carried tail
                seen.add(abs_start)
                n += 1
                row = {
                    "channel": c, "start": abs_start,
                    "symbols": np.asarray(blk.symbols)[c, k],
                    "sync": int(np.asarray(blk.sync)[c, k]),
                    "cfo_bins": int(np.asarray(blk.cfo_bins)[c, k]),
                    "cfo": float(np.asarray(blk.cfo)[c, k]),
                    "snr_db": float(np.asarray(blk.snr_db)[c, k]),
                    "sro_ppm": float(np.asarray(blk.sro_ppm)[c, k]),
                }
                if spec is not None:
                    row["spectra"] = spec[c, k]
                frames.append(row)
            # carry forward only the starts a tail re-scan could re-find
            live = sorted(s for s in seen if s >= new_consumed)
            live = live[-self.n_recent:]
            new_recent[c, :len(live)] = live
        frames.sort(key=lambda r: (r["channel"], r["start"]))
        new_state = MeshStreamState(
            np.ascontiguousarray(buf_r[:, -self.keep:]),
            np.ascontiguousarray(buf_i[:, -self.keep:]),
            new_consumed, new_recent, n)
        return new_state, frames


def save_mesh_state(state: MeshStreamState, path) -> None:
    """Persist a sharded-stream carry state. Writes to EXACTLY ``path``
    (a bare np.savez(path) appends '.npz', breaking resume for any other
    extension — models/stream.py save_state learned this the hard way)."""
    with open(path, "wb") as f:
        np.savez(f, tail_re=state.tail_re, tail_im=state.tail_im,
                 consumed=np.int64(state.consumed),
                 emitted_start=state.emitted_start.astype(np.int64),
                 n_frames=np.int64(state.n_frames))


def load_mesh_state(path) -> MeshStreamState:
    z = np.load(path)
    return MeshStreamState(
        z["tail_re"].astype(np.float32), z["tail_im"].astype(np.float32),
        int(z["consumed"]), z["emitted_start"].astype(np.int64),
        int(z["n_frames"]))


def receive_adaptive_stream_planar(xr, xi, params: LoraParams, mesh: Mesh,
                                   max_frames: int = 4,
                                   preamble_len: int = 8,
                                   min_power_db: float | None = None,
                                   ldro: bool = False):
    """Mesh-sharded receive of SELF-DESCRIBING frames (explicit headers,
    the gateway contract of ``models.stream.AdaptiveStreamDemodulator``):
    two sharded scan/demod passes bracket a host-side header loop.

    Pass 1 runs the time/channel-sharded scan demodulating only the
    8-symbol explicit header at every sync point; the host decodes each
    header (length/CR/CRC, ``models.coded.decode_header``) — the one
    data-dependent step, exactly where the single-device receiver also
    leaves jit. Pass 2 re-runs the sharded receiver at the LONGEST
    decoded frame length and the host trims each frame to its own
    header's symbol count, so frames of different lengths ride one mesh
    program (static shapes; XLA sees two compiled scans total).

    Returns a list of dicts ``{channel, start, payload: bytes|None,
    info}`` sorted by (channel, start) — ``payload`` is None when the
    header was bad or the CRC failed (``info`` says which). Hard
    decisions only (the soft path needs per-frame spectra, which the
    block receiver deliberately does not materialise mesh-wide).

    Streaming semantics: a frame whose WORST-CASE extent (pass-2 length)
    overruns the stream tail is deferred — the caller's next block will
    re-see it, matching the single-device adaptive receiver's carry-tail
    behaviour.
    """
    from ..models import coded

    blk = receive_stream_block_planar(
        xr, xi, params, 8, mesh, max_frames, preamble_len, min_power_db)
    found = np.asarray(blk.found)
    starts = np.asarray(blk.start)
    hdr_syms = np.asarray(blk.symbols)

    # largest pass-2 payload-symbol count whose frame + probe margin
    # still fits one time-shard block: a header that decodes to a longer
    # length (a frame genuinely longer than the block, or a corrupted
    # length that slipped past the 5-bit checksum, ~1/32 false-accept)
    # must NOT drive receive_stream_block_planar into its halo
    # ValueError and take every other frame down with it
    step = params.step
    block = xr.shape[-1] // mesh.shape[TIME_AXIS]
    ov_w = -(-frame_overhead_samples(params, preamble_len) // step)
    n_cap = block // step - 4 - ov_w

    headers = {}                        # (channel, global_start) -> header
    nsyms = []
    for c, k in zip(*np.nonzero(found)):
        nbytes, cr, crc_en, hdr_ok = coded.decode_header(
            hdr_syms[c, k, :8], params.sf)
        info = {"found": True, "start": int(starts[c, k]),
                "cfo_bins": int(np.asarray(blk.cfo_bins)[c, k]),
                "length": int(nbytes), "cr": int(cr), "crc": bool(crc_en),
                "header_ok": bool(hdr_ok)}
        key = (int(c), int(starts[c, k]))
        if not hdr_ok or not (1 <= cr <= 4) or nbytes == 0:
            headers[key] = (None, info)
            continue
        cfg = coded.CodedConfig(sf=params.sf, cr=int(cr), crc=bool(crc_en),
                                ldro=ldro)
        nsym = coded.payload_symbol_count(int(nbytes), cfg)
        if 8 + nsym > n_cap:
            headers[key] = (None, {
                **info, "error": "frame exceeds time-shard block; "
                "use fewer time shards or longer blocks"})
            continue
        headers[key] = (cfg, info)
        nsyms.append(nsym)
    results = [{"channel": c, "start": s, "payload": None, "info": info}
               for (c, s), (cfg, info) in headers.items() if cfg is None]
    if nsyms:
        n_max = 8 + max(nsyms)
        blk2 = receive_stream_block_planar(
            xr, xi, params, n_max, mesh, max_frames, preamble_len,
            min_power_db)
        f2 = np.asarray(blk2.found)
        s2 = np.asarray(blk2.start)
        sym2 = np.asarray(blk2.symbols)
        for c, k in zip(*np.nonzero(f2)):
            key = (int(c), int(s2[c, k]))
            if key not in headers or headers[key][0] is None:
                continue
            cfg, info = headers[key]
            nsym = coded.payload_symbol_count(info["length"], cfg)
            payload, crc_ok, fec_err = coded.decode_payload(
                sym2[c, k, 8:8 + nsym], info["length"], cfg)
            info = {**info, "crc_ok": bool(np.all(np.asarray(crc_ok))),
                    "fec_errors": int(np.asarray(fec_err))}
            results.append({
                "channel": key[0], "start": key[1],
                "payload": np.asarray(payload).tobytes(), "info": info,
            })
    results.sort(key=lambda r: (r["channel"], r["start"]))
    return results
