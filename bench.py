#!/usr/bin/env python3
"""Headline benchmark: batched multi-channel LoRa demodulation throughput,
with secondary TX (modulation), frame-sync-scan, SF12, block-receiver,
channelizer, wideband-receiver, AWGN Monte Carlo and single-frame latency
rows. Needs a GPU: it fails rather than measure on the CPU.

Workload (a superset of BASELINE.json configs[3]'s 8x1024): 8 channels x
8192 frames of 32-byte payloads at SF7 BW125 osr1 -> 66 symbols x 128
samples = 8448 IQ samples per frame, 554M IQ samples per step. The whole
pipeline runs on the device in planar float32: payload tiling + encode +
integer-lattice chirp TX + dechirp feed the demod step, so no host-side
signal generation is on any path.

Headline metric: the working demod path on dechirped input
(normalisation, 2-symbol CFO/TO estimate with deterministic tie-breaks,
shifted gather, derotation, DFT, argmax, sync extraction).

Baseline: the reference's single-core C++ loop demodulates ~2.01e7 IQ
samples/s (BASELINE.md, logs/performance_run2.csv SF7 row); its TX hot
loop (genChirp, ChirpGenerator.hpp:23-50) generates the same ~2.0e7.

Every time is a host clock around calls that end in
``jax.block_until_ready``: best of two batches of ``iters`` calls.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "tx_gsps": ..., "sync_scan_gsps": ..., "sf12_gsps": ...,
   "block_rx_gsps": ..., "channelizer_gsps": ..., "wideband_rx_gsps": ...,
   "awgn_mpps": ..., "latency_sf{7,12}_ms": ...,
   "platform": ..., "device_kind": ..., "device_count": ...,
   "card": <nvidia-smi name, power.limit>}
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

BASELINE_IQ_SAMPLES_PER_S = 2377.87 * 66 * 128  # ~2.009e7 (BASELINE.md)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _timeit(fn, iters, repeats=2):
    """Best-of-``repeats`` mean seconds per call over batches of
    ``iters`` calls of ``fn`` (which returns device arrays)."""
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def main() -> int:
    from lora_phy_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from lora_phy_tpu.models import modem
    from lora_phy_tpu.models import stream as streammod
    from lora_phy_tpu.models import sync as syncmod
    from lora_phy_tpu.models.awgn import _simulate_point_planar
    from lora_phy_tpu.ops import planar
    from lora_phy_tpu.ops.channelizer import (channelize_planar,
                                              synthesize_channels_planar)
    from lora_phy_tpu.utils.params import LoraParams

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py needs a GPU; JAX found {dev.platform}")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    log(f"device: {dev.device_kind} x{len(jax.devices())} ({card})")

    params = LoraParams(sf=7)
    payload_len = 32
    n_sym = payload_len * 2 + 2                      # 66 incl. sync
    frame_samples = n_sym * params.step              # 8448
    channels, frames = 8, 8192
    pool = 64
    reps = (channels * frames) // pool
    iters = 8

    rng = np.random.RandomState(0)
    payloads = rng.randint(0, 256, (pool, payload_len)).astype(np.uint8)
    pool_d = jax.device_put(payloads, dev)

    # --- TX: payload tiling + encode + planar lattice modulator, on-device
    @jax.jit
    def tx_step(pl):
        full = jnp.tile(pl, (reps, 1)).reshape(channels, frames, payload_len)
        syms = modem.encode(full)
        return planar.modulate_planar(syms, params)

    t0 = time.perf_counter()
    re, im = jax.block_until_ready(tx_step(pool_d))
    log(f"TX compile+first: {time.perf_counter() - t0:.2f}s")
    total_samples = channels * frames * frame_samples
    dt_tx = _timeit(lambda: tx_step(pool_d), 3 * iters)
    tx_sps = total_samples / dt_tx
    log(f"TX: {total_samples/1e6:.0f}M IQ samples in {dt_tx*1e3:.1f} ms "
        f"-> {tx_sps/1e9:.3f} Gsamples/s "
        f"({tx_sps/BASELINE_IQ_SAMPLES_PER_S:.0f}x reference genChirp loop)")

    # --- secondary: frame-sync scan stage (on the raw TX stream, before
    # dechirp so only one full batch is live at a time) ------------------
    T = (frames // 8) * frame_samples
    sr = re.reshape(channels, -1)[:, :T]
    si = im.reshape(channels, -1)[:, :T]
    dt_s = _timeit(lambda: syncmod.frame_sync_scan_planar(sr, si, params),
                   12 * iters)
    sync_gsps = channels * T / dt_s / 1e9
    log(f"sync scan: {sync_gsps:.3f} Gsamples/s ({dt_s*1e3:.1f} ms)")
    del sr, si

    # --- dechirped input for the demod step (the working-path contract) --
    xr, xi = jax.jit(lambda r, i: planar.dechirp_planar(r, i, params))(re, im)
    re.delete()
    im.delete()

    # --- headline: demod ------------------------------------------------
    @jax.jit
    def demod_step(r, i):
        res = planar.demodulate_planar(r, i, params)
        return res.symbols, res.sync_word

    t0 = time.perf_counter()
    out = demod_step(xr, xi)
    first_syms = np.asarray(out[0][0, :pool])
    log(f"demod compile+first: {time.perf_counter() - t0:.2f}s")
    decoded = np.asarray(modem.decode(first_syms))
    assert np.array_equal(decoded, payloads), "bench demod mismatch"
    assert np.all(np.asarray(out[1][:2]) == params.sync_word)

    dt = _timeit(lambda: demod_step(xr, xi), 3 * iters)
    sps = total_samples / dt
    log(f"demod: {total_samples/1e6:.1f}M IQ samples in {dt*1e3:.1f} ms "
        f"-> {sps/1e9:.3f} Gsamples/s "
        f"({sps/BASELINE_IQ_SAMPLES_PER_S:.0f}x baseline)")
    xr.delete()
    xi.delete()

    # --- secondary: block receiver end-to-end (the production rx_stream
    # path: scan + candidate selection + SFD tau-probe + window slicing +
    # preamble-anchored demod of every frame, ONE program) ----------------
    pl_len = 16
    n_pay = pl_len * 2
    fpc = 512                                        # frames per channel
    gap = 4 * params.step
    pay_blk = rng.randint(0, 256, (channels, pl_len)).astype(np.uint8)

    @jax.jit
    def framed_stream(pl):
        syms = modem.encode(pl)                      # [C, 2*pl_len]
        fr, fi = streammod.frame_modulate_planar(syms, params)
        z = jnp.zeros((channels, gap), jnp.float32)
        return (jnp.tile(jnp.concatenate([fr, z], -1), (1, fpc)),
                jnp.tile(jnp.concatenate([fi, z], -1), (1, fpc)))

    br, bi = framed_stream(jax.device_put(pay_blk, dev))

    @jax.jit
    def block_rx(r, i):
        return syncmod.receive_block_planar(
            r, i, params, n_pay, max_frames=fpc, min_power_db=-30.0)

    dt_b = _timeit(lambda: block_rx(br, bi), 12 * iters)
    blk = block_rx(br, bi)
    found = np.asarray(blk.found)
    assert found.sum() >= channels * (fpc - 1), int(found.sum())
    dec0 = np.asarray(modem.decode(np.asarray(blk.symbols)[0, 0]))
    assert np.array_equal(dec0, pay_blk[0]), "block rx decode mismatch"
    block_rx_gsps = br.size / dt_b / 1e9
    log(f"block receiver: {block_rx_gsps:.3f} Gsamples/s end-to-end "
        f"({int(found.sum())} frames, {dt_b*1e3:.1f} ms)")
    br.delete()
    bi.delete()

    # --- secondary: SF12 (N=4096, four-step DFT path) --------------------
    p12 = LoraParams(sf=12)
    pool12, reps12 = 4, 256
    pay12 = payloads[:pool12]

    @jax.jit
    def chain12(pl):
        full = jnp.tile(pl, (reps12, 1))
        syms = modem.encode(full)
        r, i = planar.modulate_planar(syms, p12)
        return planar.dechirp_planar(r, i, p12)

    r12, i12 = chain12(jax.device_put(pay12, dev))
    demod12 = jax.jit(
        lambda r, i: planar.demodulate_planar(r, i, p12).symbols)
    dt12 = _timeit(lambda: demod12(r12, i12), 12)
    n12 = r12.size
    base12 = 65.8583 * 66 * 4096      # reference SF12 row, BASELINE.md
    sf12_gsps = n12 / dt12 / 1e9
    log(f"secondary SF12: {sf12_gsps:.3f} Gsamples/s "
        f"({n12/dt12/base12:.0f}x reference SF12)")
    r12.delete()
    i12.delete()

    # --- secondary: planar polyphase channelizer (K=8) -------------------
    K = 8
    Tw = 1 << 25
    kr_, ki_ = jax.random.split(jax.random.PRNGKey(1))
    wr_, wi_ = jax.jit(lambda kr, ki: (
        jax.random.normal(kr, (Tw,), jnp.float32),
        jax.random.normal(ki, (Tw,), jnp.float32)))(kr_, ki_)
    chan_step = jax.jit(lambda r, i: channelize_planar(r, i, K))
    dt_c = _timeit(lambda: chan_step(wr_, wi_), 12 * iters)
    chan_gsps = Tw / dt_c / 1e9
    log(f"channelizer K={K}: {chan_gsps:.3f} Gsamples/s ({dt_c*1e3:.1f} ms)")
    wr_.delete()
    wi_.delete()

    # --- secondary: wideband receiver end-to-end (the flagship gateway
    # path: ONE jit = channelize K=8 + per-channel scan + block demod of
    # every frame; metric over WIDEBAND input samples) --------------------
    pay_wb = rng.randint(0, 256, (K, pl_len)).astype(np.uint8)

    # setup (untimed): per-channel framed streams -> polyphase
    # synthesis bank -> one wideband stream at rate K*fs
    @jax.jit
    def make_wideband(pl):
        syms = modem.encode(pl)                      # [K, 2*pl_len]
        fr, fi = streammod.frame_modulate_planar(syms, params)
        z = jnp.zeros((K, gap), jnp.float32)
        cr_ = jnp.tile(jnp.concatenate([fr, z], -1), (1, fpc))
        ci_ = jnp.tile(jnp.concatenate([fi, z], -1), (1, fpc))
        return synthesize_channels_planar(cr_, ci_, K, taps_per_branch=15)

    wbr, wbi = make_wideband(jax.device_put(pay_wb, dev))

    @jax.jit
    def wideband_rx(r, i):
        return syncmod.receive_wideband_planar(
            r, i, K, params, n_pay, max_frames=fpc,
            taps_per_branch=15, min_power_db=-30.0)

    dt_w = _timeit(lambda: wideband_rx(wbr, wbi), 8 * iters)
    wb = wideband_rx(wbr, wbi)
    foundw = np.asarray(wb.found)                    # [K, fpc]
    assert foundw.sum() >= K * (fpc - 1), int(foundw.sum())
    decw = np.asarray(modem.decode(np.asarray(wb.symbols)[:, 0]))
    assert np.array_equal(decw, pay_wb), "wideband rx decode mismatch"
    wideband_rx_gsps = wbr.shape[-1] / dt_w / 1e9
    log(f"wideband receiver K={K}: {wideband_rx_gsps:.3f} Gsamples/s "
        f"end-to-end ({int(foundw.sum())} frames, {dt_w*1e3:.1f} ms)")
    wbr.delete()
    wbi.delete()

    # --- secondary: AWGN Monte Carlo (planar model, 16-byte packets) ------
    pkts = 32768
    kk = jax.random.PRNGKey(2)
    snr = jnp.float32(6.0)
    dt_m = _timeit(lambda: _simulate_point_planar(kk, snr, 7, "4/8", pkts,
                                                  16), 3 * iters)
    awgn_mpps = pkts / dt_m / 1e6
    log(f"AWGN MC: {awgn_mpps:.3f} Mpackets/s ({dt_m*1e3:.1f} ms)")

    # --- secondary: single-frame end-to-end receive LATENCY --------------
    # The reference's pps metric at packets=1 is implicitly a latency
    # metric (tests/performance_test.cpp:106-133): "how long from last
    # sample in to payload out for ONE frame". Timed per call: scan + SFD
    # probe + demod (receive_block_planar, 1 frame) + device-to-host
    # symbol readout + decode; median of the calls.
    lat_ms = {}
    for sf in (7, 12):
        pL = LoraParams(sf=sf)
        pl1 = payloads[0][:8]
        n_pay1 = pl1.size * 2
        fr1, fi1 = streammod.frame_modulate_planar(
            jnp.asarray(modem.encode(pl1), jnp.int32), pL)
        fl1 = fr1.shape[-1]
        off1 = 2 * pL.step
        T1 = off1 + fl1 + 6 * pL.step
        b1r = jnp.zeros(T1, jnp.float32).at[off1: off1 + fl1].set(fr1)
        b1i = jnp.zeros(T1, jnp.float32).at[off1: off1 + fl1].set(fi1)

        rx1 = jax.jit(lambda r, i, _p=pL, _n=n_pay1:
                      syncmod.receive_block_planar(r, i, _p, _n,
                                                   max_frames=1))
        dec1 = np.asarray(modem.decode(np.asarray(rx1(b1r, b1i).symbols[0])))
        assert np.array_equal(dec1, pl1), f"latency SF{sf} decode"
        tots = []
        for _ in range(12):
            t0 = time.perf_counter()
            s_row = np.asarray(rx1(b1r, b1i).symbols[0])
            np.asarray(modem.decode(s_row))
            tots.append(time.perf_counter() - t0)
        lat_ms[sf] = round(float(np.median(tots)) * 1e3, 3)
        log(f"latency SF{sf}: {lat_ms[sf]:.3f} ms/frame end-to-end (median)")

    print(json.dumps({
        "metric": "demod_iq_throughput_sf7",
        "value": round(sps, 0),
        "unit": "IQ samples/s",
        "vs_baseline": round(sps / BASELINE_IQ_SAMPLES_PER_S, 2),
        "tx_gsps": round(tx_sps / 1e9, 3),
        "sync_scan_gsps": round(sync_gsps, 3),
        "sf12_gsps": round(sf12_gsps, 3),
        "block_rx_gsps": round(block_rx_gsps, 3),
        "channelizer_gsps": round(chan_gsps, 3),
        "wideband_rx_gsps": round(wideband_rx_gsps, 3),
        "awgn_mpps": round(awgn_mpps, 3),
        "latency_sf7_ms": lat_ms[7],
        "latency_sf12_ms": lat_ms[12],
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
