#!/usr/bin/env python3
"""Per-stage profile of the block receiver at the bench shape.

Reproduces bench.py's block-receiver workload (8 channels x 512 frames of
16-byte payloads, SF7, ~25.3M samples) and times CUMULATIVE prefixes of
the CIRCULAR fast path of ``receive_block_planar`` (the production
pipeline at osr=1 / rectangular window — models/sync.py
``_receive_block_circular``), each compiled as its own jit returning a
scalar checksum (so XLA cannot dead-code the stage under test).

Deltas between consecutive prefixes attribute wall time to: scan +
candidate select (front), row gather, SFD probes, section selects,
dechirp, preamble estimator, rotation + DFT + decisions, SRO.  NOTE:
prefixes that drop a downstream consumer also let XLA dead-code interior
work (e.g. the ``estimator`` prefix DCEs the payload section), so deltas
can be negative — read them as "cost of what this prefix newly keeps
alive", and trust ``full-receiver`` as the end-to-end number.

Usage: python tools/profile_block_rx.py [--frames=512]
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> None:
    import jax
    import jax.numpy as jnp

    from lora_phy_tpu.models import modem
    from lora_phy_tpu.models import stream as streammod
    from lora_phy_tpu.models import sync as syncmod
    from lora_phy_tpu.models.stream import frame_overhead_samples
    from lora_phy_tpu.models.sync import (_circ_wrap_const,
                                          _gather_window_rows, _kth_valid,
                                          frame_sync_scan_planar)
    from lora_phy_tpu.ops.chirp import base_downchirp_planar
    from lora_phy_tpu.ops.planar import (_preamble_phase_step,
                                         argmax_bins_planar,
                                         dft_mag2_planar,
                                         estimate_preamble_planar,
                                         estimate_sro_planar)
    from lora_phy_tpu.utils.params import LoraParams

    fpc = 512
    for a in sys.argv[1:]:
        if a.startswith("--frames="):
            fpc = int(a.split("=")[1])

    params = LoraParams(sf=7)
    platform = jax.default_backend()
    if platform == "cpu":
        fpc = min(fpc, 8)
    channels, pl_len = 8, 16
    n_pay = pl_len * 2
    n, osr, step = params.n, params.osr, params.step
    gap = 4 * params.step
    max_frames, preamble_len = fpc, 8
    pre_len = preamble_len * step
    overhead = frame_overhead_samples(params, preamble_len)
    ov_w, dq = overhead // step, overhead % step
    nwin_g = (overhead + n_pay * step) // step + 4
    rng = np.random.RandomState(0)
    pay_blk = rng.randint(0, 256, (channels, pl_len)).astype(np.uint8)
    dev = jax.devices()[0]

    @jax.jit
    def framed_stream(pl):
        syms = modem.encode(pl)
        fr, fi = streammod.frame_modulate_planar(syms, params)
        z = jnp.zeros((channels, gap), jnp.float32)
        return (jnp.tile(jnp.concatenate([fr, z], -1), (1, fpc)),
                jnp.tile(jnp.concatenate([fi, z], -1), (1, fpc)))

    br, bi = framed_stream(jax.device_put(pay_blk, dev))
    np.asarray(br[0, :2])
    T = br.shape[-1]
    lead = br.shape[:-1]
    total = br.shape[0] * br.shape[1]
    print(f"workload: {total/1e6:.1f}M samples, {channels}x{fpc} frames",
          file=sys.stderr)

    dr0_np, di0_np = base_downchirp_planar(params.sf, params.scale,
                                           params.osr)
    s0, s0_ok = _circ_wrap_const(params)
    assert s0_ok, "lattice not (anti)periodic: fast path would not dispatch"
    _pps = _preamble_phase_step(params.sf, params.osr, params.scale)

    # ---- stages, mirroring models/sync._receive_block_circular ----------
    def front(xr, xi):
        scan = frame_sync_scan_planar(xr, xi, params, preamble_len,
                                      min_power_db=-30.0)
        pos, found = _kth_valid(scan.valid, max_frames)

        def pick(field):
            return jnp.take_along_axis(field, pos, axis=-1)

        return pick(scan.start), pick(scan.cfo_bins), found

    def gathered(xr, xi):
        start, cfo_bins, found = front(xr, xi)
        w0 = jnp.floor_divide(start, step)
        q = jnp.mod(start, step)

        def gather_rows(plane):
            tail = (nwin_g + 2) * step + (-T) % step
            pad = jnp.pad(plane,
                          [(0, 0)] * (plane.ndim - 1) + [(2 * step, tail)])
            rows = pad.reshape(*lead, -1, step)
            return _gather_window_rows(rows, w0 + 1, nwin_g, step)

        return gather_rows(xr), gather_rows(xi), start, cfo_bins, found, q

    def build(xr, xi, upto):
        g_r, g_i, start, cfo_bins, found, q = gathered(xr, xi)
        if upto == "gather":
            return g_r, g_i
        jj = jnp.arange(step, dtype=jnp.int32)
        qq = q[..., None, None]
        q_p = q + dq
        cp = (q_p >= step).astype(jnp.int32)
        q_p = q_p - cp * step
        qqp = q_p[..., None, None]
        dr0, di0 = jnp.asarray(dr0_np), jnp.asarray(di0_np)
        s0r, s0i = jnp.float32(s0.real), jnp.float32(s0.imag)

        def circ_select(wr_, wi_, nr_, ni_, m):
            return (jnp.where(m, nr_ * s0r + ni_ * s0i, wr_),
                    jnp.where(m, ni_ * s0r - nr_ * s0i, wi_))

        def _probe(m, down):
            sr, si_ = circ_select(g_r[..., m, :], g_i[..., m, :],
                                  g_r[..., m + 1, :], g_i[..., m + 1, :],
                                  jj < qq[..., 0])
            if down:
                ur, ui = sr * dr0 + si_ * di0, si_ * dr0 - sr * di0
            else:
                ur, ui = sr * dr0 - si_ * di0, si_ * dr0 + sr * di0
            _, pk = argmax_bins_planar(ur, ui, n, with_peak=True)
            return pk

        def hyp_score(woff):
            return (_probe(woff + preamble_len + 1, False)
                    + _probe(woff + preamble_len + 2, True))

        scores = jnp.stack([hyp_score(1), hyp_score(0), hyp_score(2)])
        hyp = jnp.argmax(scores, axis=0)
        if upto == "probes":
            return hyp
        woff = jnp.where(hyp == 1, 0, jnp.where(hyp == 2, 2, 1))

        def hyp_pick(gp, base, ln, sel, nsel):
            out = gp[..., base + nsel - 1: base + nsel - 1 + ln, :]
            for b in range(nsel - 2, -1, -1):
                out = jnp.where(sel[..., None, None] == b,
                                gp[..., base + b: base + b + ln, :], out)
            return out

        def section(base, ln, qsel, sel, nsel):
            pr_ = hyp_pick(g_r, base, ln + 1, sel, nsel)
            pi_ = hyp_pick(g_i, base, ln + 1, sel, nsel)
            return circ_select(pr_[..., :-1, :], pi_[..., :-1, :],
                               pr_[..., 1:, :], pi_[..., 1:, :], jj < qsel)

        ps_r, ps_i = section(0, preamble_len + 2, qq, woff, 3)
        pd_r, pd_i = section(ov_w, n_pay, qqp, woff + cp, 4)
        if upto == "sections":
            return ps_r, ps_i, pd_r, pd_i

        def dech(a_r, a_i):
            return a_r * dr0 - a_i * di0, a_r * di0 + a_i * dr0

        ps_r, ps_i = dech(ps_r, ps_i)
        pd_r, pd_i = dech(pd_r, pd_i)
        if upto == "dechirp":
            return ps_r, ps_i, pd_r, pd_i

        b0 = jnp.mod(cfo_bins - q, n)
        cfo_resid = estimate_preamble_planar(
            ps_r[..., :preamble_len, :].reshape(*lead, max_frames, pre_len),
            ps_i[..., :preamble_len, :].reshape(*lead, max_frames, pre_len),
            n, osr, phase_step=_pps, bin_offset=b0)
        if upto == "estimator":
            return cfo_resid
        rate = -jnp.float32(2.0 * math.pi) * cfo_resid / jnp.float32(n)

        def rot_factor(qs):
            idx_true = (jj - qs[..., None] + jnp.where(
                jj < qs[..., None], n, 0)).astype(jnp.float32)
            ph = rate[..., None] * idx_true
            return jnp.cos(ph), jnp.sin(ph)

        def rot(a_r, a_i, c_, s_):
            c_, s_ = c_[..., None, :], s_[..., None, :]
            return a_r * c_ - a_i * s_, a_r * s_ + a_i * c_

        ca, sa = rot_factor(q)
        cb, sb_ = rot_factor(q_p)
        sy_r, sy_i = rot(ps_r[..., preamble_len:, :],
                         ps_i[..., preamble_len:, :], ca, sa)
        pl_r, pl_i = rot(pd_r, pd_i, cb, sb_)
        fr = jnp.concatenate([sy_r, pl_r], axis=-2)
        fi = jnp.concatenate([sy_i, pl_i], axis=-2)
        mag2 = dft_mag2_planar(fr, fi, n)
        raw = jnp.argmax(mag2, axis=-1).astype(jnp.int32)
        if upto == "demod":
            return raw
        sro = estimate_sro_planar(
            pd_r.reshape(*lead, max_frames, n_pay * step),
            pd_i.reshape(*lead, max_frames, n_pay * step), params)
        return raw, sro

    def cksum(*outs):
        acc = jnp.float32(0)
        for o in jax.tree_util.tree_leaves(outs):
            acc = acc + jnp.sum(o.astype(jnp.float32)[..., :1])
        return acc

    stages = ["front", "gather", "probes", "sections", "dechirp",
              "estimator", "demod", "all", "full-receiver"]
    iters = 24 if platform != "cpu" else 1
    prev = 0.0
    print(f"{'prefix':>14} {'ms':>9} {'delta ms':>9}")
    for name in stages:
        if name == "front":
            f = jax.jit(lambda r, i: cksum(front(r, i)))
        elif name == "full-receiver":
            f = jax.jit(lambda r, i: cksum(syncmod.receive_block_planar(
                r, i, params, n_pay, max_frames=max_frames,
                min_power_db=-30.0)))
        else:
            f = jax.jit(lambda r, i, u=name: cksum(build(r, i, u)))
        out = f(br, bi)
        np.asarray(out)               # compile + first run
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(br, bi)
        np.asarray(out)
        dt = (time.perf_counter() - t0) / iters * 1e3
        print(f"{name:>14} {dt:9.2f} {dt - prev:9.2f}", flush=True)
        prev = dt


if __name__ == "__main__":
    main()
