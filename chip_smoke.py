#!/usr/bin/env python3
"""Smoke test of the gateway receive path on one GPU, at gateway sizes.

    python chip_smoke.py [--seed=0]        # phases a-d on one card
    python chip_smoke.py --four-cards      # phase e only, on four cards

Runs in ONE process and drives the system through the entry points a user
calls: the library's receive programs and the ``lora-tx-stream`` /
``lora-rx-stream`` CLIs, called in-process. All data comes from the repo's
own TX, seeded by ``--seed``. It refuses to run (non-zero exit, no result
line) when JAX's first device is not a GPU.

Phases (each prints PASS/FAIL, backend compile seconds, wall seconds and
the device's ``peak_bytes_in_use``; a failed phase ends the run non-zero):

a. golden parity: every ``tests/fixtures/golden/*.npz`` through the planar
   and the complex demodulator — symbols, sync word and decoded bytes
   exact, CFO/TO and the IQ envelope within the golden tests' tolerances;
b. batch demod at bench width: SF7 8 channels x 8192 frames and SF12 1024
   frames decode bit-exact and equal the complex64 ``jnp.fft`` reference
   on 64 frames; symbol mismatches against that reference under AWGN;
c. the block receiver (8 x 512 frames) and the wideband receiver (K=8,
   512 frames per channel) find and decode their frames;
d. the served CLI: a 60 s single-channel capture, a 30 s 8-channel 1 Msps
   wideband capture, and short ``--sic``, ``--sf=auto`` and
   ``--adaptive --soft`` runs; every frame list (start, sync, payload)
   equals the transmitted one, the wideband list apart from at most
   ``WIDEBAND_MAX_IMAGES`` counted adjacent-channel images;
e. (``--four-cards``) ``lora-rx-stream --mesh=4`` against the one-card run
   on the phase-d capture, and the 2x2 channel x time mesh dry run.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

from lora_phy_tpu.utils.compile_cache import enable_compile_cache

REPO = pathlib.Path(__file__).resolve().parent
GOLDEN_DIR = REPO / "tests" / "fixtures" / "golden"
_BACKEND_COMPILE = "/jax/core/compile/backend_compile_duration"
_compile_s = [0.0]


def _on_duration(event, duration, **_):
    if event == _BACKEND_COMPILE:
        _compile_s[0] += duration


@contextlib.contextmanager
def compile_clock():
    """Sum JAX's backend compile durations into the phase lines."""
    import jax

    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    try:
        yield
    finally:
        jax.monitoring.unregister_event_duration_listener(_on_duration)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return stats.get("peak_bytes_in_use") if stats else None


def run_phase(name, fn, *args, **kwargs):
    """Run one phase; print its line; re-raise its failure."""
    c0, t0 = _compile_s[0], time.perf_counter()
    status = "FAIL"
    try:
        out = fn(*args, **kwargs)
        status = "PASS"
        return out
    finally:
        print(f"phase {name}: {status} compile_s={_compile_s[0] - c0:.2f} "
              f"wall_s={time.perf_counter() - t0:.2f} "
              f"peak_bytes_in_use={_peak_bytes()}", flush=True)


# ---------------------------------------------------------------------------
# a. golden parity
# ---------------------------------------------------------------------------

def _golden_params(stem: str):
    from lora_phy_tpu.utils.params import Bandwidth, LoraParams, Window

    sf, bw, osr, win = stem.split("_")
    return LoraParams(sf=int(sf[2:]), bw=Bandwidth(int(bw[2:])),
                      osr=int(osr[3:]),
                      window=Window.HANN if win[3:] == "1" else Window.NONE)


def _flip_residual(mine, ref, p) -> float:
    """Phase residual modulo the reference's boundary-wrap ambiguity
    (tests/test_modem_golden.py::_flip_residual)."""
    rng_mod = (2 * math.pi * p.scale / p.osr) % (2 * math.pi)
    dphi = np.angle(mine * np.conj(ref))
    if rng_mod > 1e-9 and (2 * math.pi - rng_mod) > 1e-9:
        dphi = dphi - np.round(dphi / rng_mod) * rng_mod
        dphi = (dphi + math.pi) % (2 * math.pi) - math.pi
    return float(np.abs(dphi).max())


def phase_golden(paths=None):
    """Every golden fixture through the planar and the complex demod."""
    from lora_phy_tpu.models import modem
    from lora_phy_tpu.ops import planar
    from lora_phy_tpu.utils.params import Window

    paths = sorted(GOLDEN_DIR.glob("*.npz")) if paths is None else paths
    _check(paths, "no golden fixtures")
    worst = {"cfo": 0.0, "to_excess": -np.inf, "envelope": 0.0,
             "prefix": 0.0}
    for path in paths:
        g = np.load(path)
        p = _golden_params(path.stem)
        dech = np.asarray(modem.dechirp(np.asarray(g["iq"]), p))
        xr, xi = planar.split_complex(dech)
        to_tol = 0.51 + (5e-3 if p.window == Window.HANN else 4e-4) \
            * p.n * p.osr
        for label, res in (("complex", modem.demodulate(dech, p)),
                           ("planar", planar.demodulate_planar(xr, xi, p))):
            syms = np.asarray(res.symbols)
            _check(np.array_equal(syms, g["demod"]),
                   f"{path.stem} {label}: symbols differ from the golden")
            _check(int(res.sync_word) == int(g["sync"]),
                   f"{path.stem} {label}: sync word")
            _check(np.array_equal(np.asarray(modem.decode(syms)),
                                  g["decoded"]),
                   f"{path.stem} {label}: decoded bytes")
            d_cfo = abs(float(res.cfo) - float(g["cfo"]))
            d_to = abs(float(res.time_offset) - float(g["time_offset"]))
            _check(d_cfo <= 2e-4, f"{path.stem} {label}: cfo off {d_cfo}")
            _check(d_to <= to_tol, f"{path.stem} {label}: to off {d_to}")
            worst["cfo"] = max(worst["cfo"], d_cfo)
            worst["to_excess"] = max(worst["to_excess"], d_to - to_tol)
        iq = np.asarray(modem.modulate(g["symbols"], p))
        env = float(np.abs(np.abs(iq) - 1.0).max())
        tol = 2e-3 * p.n * p.scale / 64.0
        prefix = _flip_residual(iq[: 2 * p.step], g["iq"][: 2 * p.step], p)
        _check(env <= 1e-5, f"{path.stem}: IQ envelope off by {env}")
        _check(prefix < max(tol, 4e-3), f"{path.stem}: IQ prefix {prefix}")
        worst["envelope"] = max(worst["envelope"], env)
        worst["prefix"] = max(worst["prefix"], prefix)
    print(f"  golden: {len(paths)} fixtures x (planar, complex) exact; "
          f"max |cfo - golden| {worst['cfo']:.3e} bins (tol 2e-4); "
          f"max (|to - golden| - tol) {worst['to_excess']:.3e} samples; "
          f"max ||iq| - 1| {worst['envelope']:.3e} (tol 1e-5); "
          f"max IQ prefix residual {worst['prefix']:.3e} rad", flush=True)
    return worst


# ---------------------------------------------------------------------------
# b. batch demod at bench width
# ---------------------------------------------------------------------------

def _batch_case(sf, channels, frames, payload_len, seed, ref_frames, snrs):
    import jax
    import jax.numpy as jnp

    from lora_phy_tpu.models import modem
    from lora_phy_tpu.ops import planar
    from lora_phy_tpu.utils.params import LoraParams

    p = LoraParams(sf=sf)
    pool = min(64, channels * frames)
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 256, (pool, payload_len)).astype(np.uint8)
    reps = -(-(channels * frames) // pool)

    @jax.jit
    def tx(pl):
        full = jnp.tile(pl, (reps, 1))[: channels * frames].reshape(
            channels, frames, payload_len)
        r, i = planar.modulate_planar(modem.encode(full), p)
        return full, r, i

    expect, re_, im_ = tx(jnp.asarray(payloads))
    xr, xi = jax.jit(lambda r, i: planar.dechirp_planar(r, i, p))(re_, im_)

    @jax.jit
    def demod_decode(r, i):
        res = planar.demodulate_planar(r, i, p)
        return res.symbols, res.sync_word, modem.decode(res.symbols)

    syms, sync, decoded = demod_decode(xr, xi)
    n_bad = int(jnp.sum(jnp.any(decoded != expect, axis=-1)))
    _check(n_bad == 0, f"SF{sf}: {n_bad} of {channels * frames} frames "
                       "decode wrong")
    _check(bool(jnp.all(sync == p.sync_word)), f"SF{sf}: sync word")
    total = channels * frames * xr.shape[-1]
    print(f"  SF{sf}: {channels}x{frames} frames ({total / 1e6:.1f}M IQ "
          "samples) decode bit-exact", flush=True)

    # the plain complex64 reference (modem.demodulate, jnp.fft) on the
    # first ref_frames frames of channel 0: clean, then under AWGN
    k = min(ref_frames, frames)
    cr, ci = xr[0, :k], xi[0, :k]
    ref = modem.demodulate(jax.lax.complex(cr, ci), p)
    _check(np.array_equal(np.asarray(ref.symbols), np.asarray(syms[0, :k])),
           f"SF{sf}: planar symbols differ from the complex64 reference")
    print(f"  SF{sf}: planar == complex64 reference on {k} frames "
          f"({k * ref.symbols.shape[-1]} symbols)", flush=True)
    key = jax.random.PRNGKey(seed)
    mism = {}
    for snr in snrs:
        key, kr, ki = jax.random.split(key, 3)
        sigma = math.sqrt(10.0 ** (-snr / 10.0) / 2.0)
        nr = re_[0, :k] + sigma * jax.random.normal(kr, re_[0, :k].shape)
        ni = im_[0, :k] + sigma * jax.random.normal(ki, im_[0, :k].shape)
        dr, di = planar.dechirp_planar(nr, ni, p)
        got = planar.demodulate_planar(dr, di, p).symbols
        want = modem.demodulate(jax.lax.complex(dr, di), p).symbols
        mism[snr] = (int(jnp.sum(got != want)), int(got.size))
        print(f"  SF{sf} AWGN {snr:+d} dB: {mism[snr][0]} of {mism[snr][1]} "
              "symbols differ, planar (float32 matmuls at "
              "Precision.HIGHEST) vs complex64 jnp.fft", flush=True)
    return mism


def phase_batch(seed=0, sf7=(8, 8192), sf12_frames=1024, ref_frames=64,
                snrs=(0, -6, -9)):
    """SF7 at bench width and SF12, bit-exact decode + reference parity."""
    out = {7: _batch_case(7, sf7[0], sf7[1], 32, seed, ref_frames, snrs)}
    out[12] = _batch_case(12, 1, sf12_frames, 32, seed + 1, ref_frames,
                          snrs)
    return out


# ---------------------------------------------------------------------------
# c. block and wideband receivers at bench shapes
# ---------------------------------------------------------------------------

def phase_receivers(seed=0, channels=8, frames_per_channel=512, k=8):
    import jax
    import jax.numpy as jnp

    from lora_phy_tpu.models import modem
    from lora_phy_tpu.models import stream as streammod
    from lora_phy_tpu.models import sync as syncmod
    from lora_phy_tpu.ops.channelizer import synthesize_channels_planar
    from lora_phy_tpu.utils.params import LoraParams

    p = LoraParams(sf=7)
    pl_len, fpc = 16, frames_per_channel
    n_pay = 2 * pl_len
    gap = 4 * p.step
    rng = np.random.RandomState(seed + 2)

    def framed(pl, n):
        fr, fi = streammod.frame_modulate_planar(modem.encode(pl), p)
        z = jnp.zeros((n, gap), jnp.float32)
        return (jnp.tile(jnp.concatenate([fr, z], -1), (1, fpc)),
                jnp.tile(jnp.concatenate([fi, z], -1), (1, fpc)))

    def check(blk, pays, n, label):
        found = np.asarray(blk.found)
        _check(found.sum() >= n * (fpc - 1),
               f"{label}: {int(found.sum())} of {n * fpc} frames found")
        dec = np.asarray(modem.decode(blk.symbols))
        for c in range(n):
            rows = dec[c][found[c]]
            _check(np.all(rows == pays[c]), f"{label}: channel {c} decode")
        print(f"  {label}: {int(found.sum())} of {n * fpc} frames found, "
              "all payloads exact", flush=True)

    pay = rng.randint(0, 256, (channels, pl_len)).astype(np.uint8)
    br, bi = jax.jit(lambda pl: framed(pl, channels))(jnp.asarray(pay))
    blk = jax.jit(lambda r, i: syncmod.receive_block_planar(
        r, i, p, n_pay, max_frames=fpc, min_power_db=-30.0))(br, bi)
    check(blk, pay, channels,
          f"block receiver {channels}x{fpc} ({br.size / 1e6:.1f}M samples)")
    del br, bi, blk

    pay = rng.randint(0, 256, (k, pl_len)).astype(np.uint8)
    wr, wi = jax.jit(lambda pl: synthesize_channels_planar(
        *framed(pl, k), k, taps_per_branch=15))(jnp.asarray(pay))
    wb = jax.jit(lambda r, i: syncmod.receive_wideband_planar(
        r, i, k, p, n_pay, max_frames=fpc, taps_per_branch=15,
        min_power_db=-30.0))(wr, wi)
    check(wb, pay, k, f"wideband receiver K={k} ({wr.size / 1e6:.1f}M "
                      "wideband samples)")


# ---------------------------------------------------------------------------
# d. the served CLI
# ---------------------------------------------------------------------------

def _cf32(path):
    raw = np.fromfile(path, np.float32)
    return raw[0::2] + 1j * raw[1::2]


def _write_cf32(path, x):
    out = np.empty(2 * x.size, np.float32)
    out[0::2] = x.real
    out[1::2] = x.imag
    out.tofile(path)


def _tx(workdir, name, payload_hex, *flags):
    """One ``lora-tx-stream`` run (in-process) -> its cf32 samples."""
    from lora_phy_tpu.runners import tx_stream

    plist = workdir / f"{name}.txt"
    plist.write_text("".join(h + "\n" for h in payload_hex))
    out = workdir / f"{name}.iq"
    with contextlib.redirect_stderr(io.StringIO()):
        rc = tx_stream.main([f"--payloads={plist}", f"--out={out}", *flags])
    _check(rc == 0, f"lora-tx-stream {name} exited {rc}")
    return _cf32(out)


def _rx(path, *flags):
    """One ``lora-rx-stream --json`` run (in-process) -> frame records."""
    from lora_phy_tpu.runners import rx_stream

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = rx_stream.main([f"--in={path}", "--json", *flags])
    _check(rc == 0, f"lora-rx-stream {' '.join(flags)} exited {rc}")
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def _frame_len(p, payload_bytes):
    """Samples of one simple-chain frame (preamble, sync, 2.25 downchirps,
    two symbols per payload byte)."""
    from lora_phy_tpu.models import stream as streammod

    return (streammod.frame_overhead_samples(p)
            + 2 * payload_bytes * p.step)


def _starts(frame_len, gaps, lead=0):
    out, pos = [], lead
    for g in gaps:
        pos += g
        out.append(pos)
        pos += frame_len
    return out


def _payloads(rng, count, nbytes):
    return [rng.randint(0, 256, nbytes).astype(np.uint8).tobytes().hex()
            for _ in range(count)]


def _compare(label, got, want):
    if got != want:
        i = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
                 min(len(got), len(want)))
        raise AssertionError(
            f"{label}: frame list differs ({len(got)} received, "
            f"{len(want)} sent); first difference at #{i}: received "
            f"{got[i] if i < len(got) else None}, sent "
            f"{want[i] if i < len(want) else None}")


def single_channel_capture(workdir, seed, frames, gap):
    """The phase-d single-channel SF7/BW125 capture: ``frames`` 16-byte
    frames, each after ``gap`` samples of silence, plus a frame of
    trailing silence. Returns (path, transmitted [(start, sync,
    payload)], samples)."""
    from lora_phy_tpu.utils.params import LoraParams

    pays = _payloads(np.random.RandomState(seed + 3), frames, 16)
    x = _tx(workdir, "single", pays, "--sf=7", f"--gap={gap}")
    flen = _frame_len(LoraParams(sf=7), 16)
    x = np.concatenate([x, np.zeros(2 * flen, np.complex64)])
    path = workdir / "single.iq"
    _write_cf32(path, x)
    sent = [(s, 0x12, h) for s, h in zip(_starts(flen, [gap] * frames), pays)]
    return path, sent, x.size


def _records(recs, *extra):
    return [(r["start"], r["sync"], r["payload"], *(r[e] for e in extra))
            for r in recs]


def adjacent_channel_images(recs, sent, k, tol):
    """Received wideband frames that are not transmitted ones but images
    of a transmitted frame in a neighbouring channel: the channels of the
    critically sampled bank share their band edges, so a chirp sweeping
    through one edge also shows in the neighbour. Such a record starts
    within ``tol`` wideband samples of a frame sent on channel c +- 1 and
    is received weaker than that frame. Returns their (start, sync,
    payload, channel) records."""
    snr = {(r["start"], r["channel"]): r["snr_db"] for r in recs}
    sent_keys = set(sent)
    out = set()
    for r in recs:
        key = (r["start"], r["sync"], r["payload"], r["channel"])
        if key in sent_keys:
            continue
        for s0, _, _, c in sent:
            if ((c - r["channel"]) % k in (1, k - 1)
                    and abs(s0 - r["start"]) <= tol
                    and r["snr_db"] < snr.get((s0, c), -np.inf)):
                out.add(key)
    return out


# Images the wideband receiver is known to report in phase d's capture:
# 0 or 1 per 2400 frames for seeds 0-5 (seed 0 gives 1), each on the
# channel above its source, at the same start and about 10 dB weaker.
# More than this is a regression.
WIDEBAND_MAX_IMAGES = 1


def compare_wideband(label, recs, sent, k, tol, max_images):
    """Wideband frame list == ``sent``, apart from at most ``max_images``
    adjacent-channel images (:func:`adjacent_channel_images`). Returns
    how many images there were."""
    images = adjacent_channel_images(recs, sent, k, tol)
    _check(len(images) <= max_images,
           f"{label}: {len(images)} adjacent-channel image frames, at most "
           f"{max_images} allowed")
    got = sorted(r for r in _records(recs, "channel") if r not in images)
    _compare(label, got, sorted(sent))
    return len(images)


def phase_cli(workdir, seed=0, frames=600, gap=6836, wb_frames=300,
              wb_gap=6836, k=8, short_frames=4,
              max_images=WIDEBAND_MAX_IMAGES):
    """Captures from lora-tx-stream, decoded by lora-rx-stream."""
    from lora_phy_tpu.models import stream as streammod
    from lora_phy_tpu.models.coded import CodedConfig
    from lora_phy_tpu.ops.channelizer import synthesize_channels_planar
    from lora_phy_tpu.utils.params import LoraParams

    p = LoraParams(sf=7)
    fs = 125_000
    # single channel, SF7/BW125
    path, sent, n = single_channel_capture(workdir, seed, frames, gap)
    got = _records(_rx(path, "--sf=7", "--payload-len=16"))
    _compare("single channel", got, sent)
    print(f"  single channel: {len(got)} frames in {n / fs:.1f} s of air "
          f"time ({n / 1e6:.2f}M samples) == transmitted", flush=True)

    # --channels=K wideband at K x 125 kS/s
    flen = _frame_len(p, 16)
    rng = np.random.RandomState(seed + 4)
    chans, sent = [], []
    for c in range(k):
        g = wb_gap + 16 * c
        pays = _payloads(rng, wb_frames, 16)
        chans.append(_tx(workdir, f"wb{c}", pays, "--sf=7", f"--gap={g}"))
        sent += [(s * k, 0x12, h, c)
                 for s, h in zip(_starts(flen, [g] * wb_frames), pays)]
    length = max(x.size for x in chans) + 2 * flen
    cr = np.zeros((k, length), np.float32)
    ci = np.zeros((k, length), np.float32)
    for c, x in enumerate(chans):
        cr[c, : x.size], ci[c, : x.size] = x.real, x.imag
    wr, wi = synthesize_channels_planar(cr, ci, k, taps_per_branch=15)
    wide = np.asarray(wr) + 1j * np.asarray(wi)
    path = workdir / "wideband.iq"
    _write_cf32(path, wide)
    recs = _rx(path, "--sf=7", "--payload-len=16", f"--channels={k}",
               "--taps=15")
    n_img = compare_wideband(f"wideband K={k}", recs, sent, k, k * p.step,
                             max_images)
    print(f"  wideband --channels={k}: {len(sent)} frames in "
          f"{wide.size / (k * fs):.1f} s at {k * fs / 1e6:.2f} MS/s "
          f"({wide.size / 1e6:.1f}M samples) == transmitted; "
          f"{n_img} adjacent-channel image frame(s) besides "
          f"(at most {max_images})", flush=True)

    # --sic: every strong frame collides with a 12 dB weaker one 5
    # symbols later
    rng = np.random.RandomState(seed + 5)
    flen8 = _frame_len(p, 8)
    gap_s = 4 * flen8
    strong, weak = _payloads(rng, short_frames, 8), _payloads(rng,
                                                               short_frames, 8)
    xs = _tx(workdir, "strong", strong, "--sf=7", f"--gap={gap_s}")
    xw = _tx(workdir, "weak", weak, "--sf=7", f"--gap={gap_s}", "--ampl=0.25")
    off = 5 * p.step
    x = np.zeros(xs.size + off + 2 * flen8, np.complex64)
    x[: xs.size] += xs
    x[off: off + xw.size] += xw
    path = workdir / "sic.iq"
    _write_cf32(path, x)
    starts = _starts(flen8, [gap_s] * short_frames)
    sent = sorted([(s, 0x12, h) for s, h in zip(starts, strong)]
                  + [(s + off, 0x12, h) for s, h in zip(starts, weak)])
    got = sorted(_records(_rx(path, "--sf=7", "--payload-len=8", "--sic")))
    _compare("--sic", got, sent)
    print(f"  --sic: {len(got)} frames ({short_frames} colliding pairs) in "
          f"{x.size / fs:.1f} s == transmitted", flush=True)

    # --sf=auto: SF7, SF9 and SF12 frames one after another
    rng = np.random.RandomState(seed + 6)
    parts, sent, pos = [], [], 0
    for sf in (7, 9, 12):
        ps = LoraParams(sf=sf)
        pays = _payloads(rng, 2, 8)
        g = 3 * ps.step
        parts.append(_tx(workdir, f"sf{sf}", pays, f"--sf={sf}", f"--gap={g}"))
        sent += [(s, 0x12, h, sf) for s, h in
                 zip(_starts(_frame_len(ps, 8), [g, g], lead=pos), pays)]
        pos += parts[-1].size
    parts.append(np.zeros(4 * LoraParams(sf=12).step, np.complex64))
    x = np.concatenate(parts)
    path = workdir / "blind.iq"
    _write_cf32(path, x)
    got = sorted(_records(_rx(path, "--sf=auto", "--payload-len=8"), "sf"))
    _compare("--sf=auto", got, sorted(sent))
    print(f"  --sf=auto: {len(got)} frames at SF7/9/12 in {x.size / fs:.1f} s"
          " == transmitted", flush=True)

    # --adaptive --soft: explicit-header coded frames of varying length
    rng = np.random.RandomState(seed + 7)
    pays = [rng.randint(0, 256, n).astype(np.uint8).tobytes().hex()
            for n in (3, 17, 64, 9, 40, 1)[:max(2, short_frames)]]
    g = 1200
    x = _tx(workdir, "coded", pays, "--sf=7", "--coded", "--cr=2", "--crc",
            f"--gap={g}")
    x = np.concatenate([x, np.zeros(8 * p.step, np.complex64)])
    path = workdir / "coded.iq"
    _write_cf32(path, x)
    cfg = CodedConfig(sf=7, cr=2, crc=True)
    pos, sent = 0, []
    for h in pays:
        pos += g
        sent.append((pos, len(h) // 2, "ok", h))
        pos += np.asarray(streammod.frame_encode(
            np.frombuffer(bytes.fromhex(h), np.uint8), cfg, p)).size
    got = [(r["start"], r["len"], r["crc"], r["payload"])
           for r in _rx(path, "--sf=7", "--adaptive", "--soft")]
    _compare("--adaptive --soft", got, sent)
    print(f"  --adaptive --soft: {len(got)} coded frames, CRC ok, in "
          f"{x.size / fs:.2f} s == transmitted", flush=True)


# ---------------------------------------------------------------------------
# e. four cards
# ---------------------------------------------------------------------------

def phase_four_cards(workdir, seed=0, frames=600, gap=6836, n_devices=4):
    """``--mesh=4`` against the one-card CLI run, and the 2x2 mesh dry
    run."""
    import __graft_entry__ as entry

    path, sent, _ = single_channel_capture(workdir, seed, frames, gap)
    one = _records(_rx(path, "--sf=7", "--payload-len=16"))
    mesh = _records(_rx(path, "--sf=7", "--payload-len=16",
                        f"--mesh={n_devices}"))
    _compare("one card", one, sent)
    _compare(f"--mesh={n_devices}", mesh, one)
    print(f"  --mesh={n_devices}: {len(mesh)} frames == the one-card run "
          "== transmitted", flush=True)
    with contextlib.redirect_stdout(io.StringIO()) as log:
        entry.dryrun_multichip(n_devices)
    print("  " + log.getvalue().strip().splitlines()[-1], flush=True)


# ---------------------------------------------------------------------------

def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase (e)")
    args = ap.parse_args(argv)

    enable_compile_cache()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    if args.four_cards and len(devs) < 4:
        print(f"chip_smoke: --four-cards needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1
    print(f"nvidia-smi: {_nvidia_smi()}", flush=True)
    print(f"device_kind: {devs[0].device_kind} (jax {jax.__version__}, "
          f"{len(devs)} devices)", flush=True)

    with compile_clock(), \
            tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = pathlib.Path(tmp)
        if args.four_cards:
            run_phase("e four-cards", phase_four_cards, workdir, args.seed)
        else:
            run_phase("a golden", phase_golden)
            run_phase("b batch", phase_batch, args.seed)
            run_phase("c receivers", phase_receivers, args.seed)
            run_phase("d cli", phase_cli, workdir, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
