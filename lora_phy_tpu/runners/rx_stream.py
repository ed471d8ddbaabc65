"""Streaming RX: continuous IQ (file or stdin, cf32/ci16/ci8) -> frames.

The production receive loop the reference has no counterpart for: native
ingest (format conversion through runtime/lora_runtime.cpp), fixed-size
block + overlap carry buffering, and the fully device-side block receiver
(models/sync.receive_block_planar — scan, candidate selection, window
extraction, preamble-anchored demod of up to ``--max-frames`` frames per
block in ONE program). One line per decoded frame:

    frame @SAMPLE sync=0xNN cfo_bins=N payload=HEX

Buffering contract: each processed buffer = ``carry ++ block`` where the
carry is one worst-case frame plus a symbol, so every frame fully inside
the stream is fully inside at least one buffer; duplicates from the
overlap are suppressed by absolute start index. Constant buffer shape =
one jit compilation for the whole run. ``--checkpoint=PATH`` persists the
carry/position/dedupe state across invocations (resume mid-stream).
``--sf=auto`` runs blind spreading-factor detection: the same buffer is
scanned at SF7-12 (models/sync.receive_blind_planar) and each frame line
carries its detected ``sf=N``. ``--sic`` switches to the
collision receiver (models/sic.py): overlapping same-SF frames are
peeled in power order and each line carries its ``sic=PASS``; with
``--channels=K`` the peel runs per sub-channel after the polyphase
analysis bank.

``--invert-iq`` conjugates the input — receive LoRaWAN-downlink
(IQ-inverted) frames; an un-inverted receiver never locks on them.
``--cad`` inserts the SX126x-style channel-activity gate before each
buffer's receive program (models/sync.cad_planar): silent buffers cost
a quarter-stride dechirp+DFT probe instead of the full scan.
``--adaptive`` is gateway mode: self-describing frames (the explicit
header carries length/CR/CRC), arbitrary payload sizes in one stream,
per-frame CRC verification, ``--soft`` for ML soft decoding — pairs
with ``lora-tx-stream --coded``. On the plain/wideband/mesh block
paths ``--soft`` instead enables Hamming84 ML detection (constrained
argmax over the 16 valid codeword bins from the receiver's
``with_spectra`` spectra — ~3x fewer lost frames at the SF7 knee). ``--robust`` enables the multipath-
robust receive mode (accumulated-spectrum sync + noncoherent path
combining; decodes near-equal-power two-ray channels the default
receiver cannot, at ~1 dB AWGN sensitivity cost).

Flags: ``--in=FILE|-`` ``--sf=N|auto`` ``--cr`` ``--bw`` ``--osr`` ``--sync``
``--format=cf32|ci16|ci8`` ``--scale`` ``--payload-len=BYTES``
``--block=SAMPLES`` ``--max-frames=K`` ``--thresh=DB`` ``--taps=N``
``--preamble=N``
``--checkpoint=PATH`` ``--sic`` ``--invert-iq`` ``--cad`` ``--adaptive``
``--soft`` ``--json`` (one JSON object per frame on stdout) ``--robust``
``--frontend-correct`` (blind per-block DC/IQ-imbalance correction)
``--ldro`` (adaptive mode: low-data-rate payloads) ``--quiet``
``--mesh=T`` (time-shard the block receiver over T devices: every fed
block rides ONE sharded program with seam halos —
parallel/stream.MeshStreamDemodulator; checkpoint format is the mesh
carry, distinct from the single-device one)
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

from ..utils.compile_cache import enable_compile_cache
from ._cli import bandwidth_flag, params_from, parse_flags

_FORMATS = {"cf32": (np.float32, 8), "ci16": (np.int16, 4), "ci8": (np.int8, 2)}


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "in": (str, ""),
        "sf": (lambda v: v if v == "auto" else int(v), 7),
        "cr": (int, 1),
        "bw": (bandwidth_flag, None),
        "osr": (int, 1),
        "sync": (lambda v: int(v, 0), 0x12),
        "format": (str, "cf32"),
        "scale": (float, 1.0),
        "payload-len": (int, 16),
        "block": (int, 1 << 16),
        "max-frames": (int, 8),
        "thresh": (float, -30.0),
        "checkpoint": (str, ""),
        "quiet": (None, False),
        "channels": (int, 0),
        "taps": (int, 7),             # polyphase taps/branch (wideband)
        "preamble": (int, 8),
        "any-sync": (None, False),
        "sic": (None, False),
        "invert-iq": (None, False),
        "cad": (None, False),
        "adaptive": (None, False),
        "soft": (None, False),
        "json": (None, False),
        "robust": (None, False),      # multipath-robust receive (pre_acc=3)
        "frontend-correct": (None, False),
        "ldro": (None, False),        # adaptive mode: low-data-rate payload
        "mesh": (int, 0),             # time-shard the receive over N devices
    })
    if flags["format"] not in _FORMATS:
        print(f"Unknown --format={flags['format']}", file=sys.stderr)
        return 1
    if flags["sic"] and flags["sf"] == "auto":
        print("--sic requires a fixed --sf", file=sys.stderr)
        return 1
    if flags["cad"] and flags["channels"]:
        print("--cad requires a single channel (the gate dechirps at the "
              "input rate)", file=sys.stderr)
        return 1
    if flags["adaptive"] and (flags["channels"] or flags["sf"] == "auto"
                              or flags["sic"]):
        print("--adaptive requires a fixed --sf, a single channel and no "
              "--sic", file=sys.stderr)
        return 1
    if flags["soft"] and not flags["adaptive"] and flags["sic"]:
        print("--soft applies to --adaptive (LLR/ML coded decode) or to "
              "the plain/wideband/blind/mesh block paths (Hamming84 ML "
              "detection) — not --sic (the peel needs its own decisions)",
              file=sys.stderr)
        return 1
    if flags["robust"] and flags["adaptive"]:
        print("--robust applies to the block receive paths, not "
              "--adaptive (serial header-driven sync)", file=sys.stderr)
        return 1
    if flags["mesh"] and (flags["sic"] or flags["adaptive"] or flags["cad"]
                          or flags["channels"] or flags["sf"] == "auto"):
        print("--mesh time-shards the plain block receiver: fixed --sf, "
              "single channel, no --sic/--adaptive/--cad", file=sys.stderr)
        return 1
    import dataclasses

    blind = flags["sf"] == "auto"
    base_flags = dict(flags, sf=7) if blind else flags
    params = params_from({k: v for k, v in base_flags.items()
                          if v is not None})
    # --sf=auto: run the block receiver at every SF on the same buffer
    # (models/sync.receive_blind_planar rationale); buffer geometry sizes
    # to the WORST-CASE (largest-SF) frame so every candidate fits.
    sf_list = [7, 8, 9, 10, 11, 12] if blind else [params.sf]
    params_by_sf = [dataclasses.replace(params, sf=sf) for sf in sf_list]

    from .. import runtime
    from ..models import modem, stream, sync
    from ..models import sic as sic_model

    dtype, bytes_per_sample = _FORMATS[flags["format"]]
    n_payload_symbols = flags["payload-len"] * 2      # simple Hamming84 chain
    npre = flags["preamble"]
    frame_lens = {
        p.sf: (stream.frame_overhead_samples(p, npre)
               + n_payload_symbols * p.step) for p in params_by_sf
    }
    frame_len = max(frame_lens.values())
    kch = flags["channels"]                           # 0 = single channel
    rate = max(kch, 1)                                # wideband:channel ratio
    carry_len = rate * (frame_len + max(p.step for p in params_by_sf))
    block = max(flags["block"], rate * frame_len)     # a frame must fit
    block = -(-block // rate) * rate                  # multiple of K

    carry_re = np.zeros(carry_len, np.float32)
    carry_im = np.zeros(carry_len, np.float32)
    base = -carry_len                                  # abs index of carry[0]
    reported: set[tuple[int, int, int]] = set()        # (sf, chan, abs start)
    n_frames = 0
    n_skipped = 0                                      # CAD-gated buffers

    ckpt = pathlib.Path(flags["checkpoint"]) if flags["checkpoint"] else None
    if (ckpt and ckpt.exists() and not flags["adaptive"]
            and not flags["mesh"]):
        z = np.load(ckpt)
        carry_re, carry_im = z["re"], z["im"]
        base = int(z["base"])
        reported = set((int(f), int(c), int(s))
                       for f, c, s in z["reported"].reshape(-1, 3))
        n_frames = int(z["n_frames"])

    src = (sys.stdin.buffer if flags["in"] in ("", "-")
           else open(flags["in"], "rb"))

    if flags["adaptive"]:
        # gateway mode: self-describing frames (explicit header carries
        # length/CR/CRC), arbitrary payload sizes in one stream, CRC
        # verification per frame; --soft decodes payloads from the
        # symbol spectra (ML codeword correlation, ~1 dB PER gain)
        adapt = stream.AdaptiveStreamDemodulator(params, preamble_len=npre,
                                                 soft=flags["soft"],
                                                 ldro=flags["ldro"],
                                                 min_power_db=flags["thresh"])
        astate = adapt.init_state()
        if ckpt and ckpt.exists():
            # adaptive checkpoints carry the complex tail + frame count
            # (format distinct from the planar-carry one — same flag, but
            # a file written by one mode is not resumable by the other)
            z = np.load(ckpt)
            tail = (z["tail_re"] + 1j * z["tail_im"]).astype(np.complex64)
            astate = stream.StreamState(tail, int(z["consumed"]))
            n_frames = int(z["n_frames"])
        try:
            while True:
                raw = src.read(block * bytes_per_sample)
                if not raw:
                    break
                n = len(raw) // bytes_per_sample
                arr = np.frombuffer(raw[: n * bytes_per_sample], dtype)
                re, im = runtime.to_planar(arr, flags["scale"])
                if flags["invert-iq"]:
                    im = -im
                astate, got = adapt.process(
                    astate, (re + 1j * im).astype(np.complex64))
                for pos, payload, info in got:
                    n_frames += 1
                    crc = (("ok" if info.get("crc_ok") else "bad")
                           if info["crc"] else "off")
                    if flags["json"]:
                        rec = {"start": pos, "len": info["length"],
                               "cr": f"4/{4 + info['cr']}", "crc": crc,
                               "cfo_bins": info["cfo_bins"],
                               "payload": payload.hex()}
                        if "soft_margin" in info:
                            rec["soft_margin"] = round(
                                info["soft_margin"], 2)
                        print(json.dumps(rec), flush=True)
                        continue
                    soft_tag = (f" margin={info['soft_margin']:.1f}"
                                if "soft_margin" in info else "")
                    print(f"frame @{pos} len={info['length']} "
                          f"cr=4/{4 + info['cr']} crc={crc} "
                          f"cfo_bins={info['cfo_bins']}{soft_tag} "
                          f"payload={payload.hex()}", flush=True)
        finally:
            if src is not sys.stdin.buffer:
                src.close()
        if ckpt:
            tail = np.asarray(astate.tail)
            with open(ckpt, "wb") as f:   # exact path (savez appends .npz)
                np.savez(f, tail_re=tail.real.astype(np.float32),
                         tail_im=tail.imag.astype(np.float32),
                         consumed=np.int64(astate.consumed),
                         n_frames=np.int64(n_frames))
        if not flags["quiet"]:
            print(f"{n_frames} frames", file=sys.stderr)
        return 0

    def aliased_sync(p):
        # at BW250/500 the demodulated bin is s*bw_scale mod N
        # (docs/SEMANTICS.md "BW250/500 bin aliasing"), so the recovered
        # sync word aliases the same way; compare against THAT
        shift = (p.sf - 4) if p.sf > 4 else 0
        scale = int(round(p.scale))

        def nib(v):
            return ((((v & 0xF) << shift) * scale % p.n) >> shift) & 0xF

        return (nib(p.sync_word >> 4) << 4) | nib(p.sync_word)

    expected_sync = {p.sf: aliased_sync(p) for p in params_by_sf}

    def report(row, p, chan, buf_base):
        """``--soft`` (non-adaptive): when the row carries its payload
        spectra, bytes come from the constrained ML detector
        (models/soft.hamming84_ml_decode — ~3x fewer lost frames at the
        SF7 knee) instead of argmax+syndrome."""
        nonlocal n_frames
        if not flags["any-sync"] and row["sync"] != expected_sync[p.sf]:
            # the sync word is the network filter (the Pothos demod's
            # ``sync`` property): rejects transition-band chirp leakage
            # that picks up a bogus sync on quiet channels
            return
        # abs position in WIDEBAND samples (channel streams run at 1/K
        # rate; the analysis bank aligns channel frame m to input m*K)
        abs_start = buf_base + row["start"] * rate
        # overlap re-detections and bin-jitter run splits can move the
        # candidate a few samples: same-channel starts within half a
        # frame are the same frame. Under --sic overlapping frames are
        # the point — only a symbol of jitter is the same frame there.
        near = (p.step if flags["sic"] else frame_lens[p.sf] // 2) * rate
        if any(f == p.sf and c == chan and abs(s - abs_start) < near
               for f, c, s in reported):
            return
        reported.add((p.sf, chan, abs_start))
        n_frames += 1
        if flags["soft"] and row.get("spectra") is not None:
            from ..models import soft as softmod

            payload = np.asarray(softmod.hamming84_ml_decode(
                row["spectra"], scale=int(round(p.scale)))).tobytes()
        else:
            payload = np.asarray(modem.decode(row["symbols"])).tobytes()
        if flags["json"]:
            rec = {"start": abs_start, "sync": row["sync"],
                   "cfo_bins": row["cfo_bins"],
                   "snr_db": round(row["snr_db"], 2),
                   "sro_ppm": round(row["sro_ppm"], 2),
                   "payload": payload.hex()}
            if kch:
                rec["channel"] = chan
            if blind:
                rec["sf"] = p.sf
            if "sic_pass" in row:
                rec["sic_pass"] = row["sic_pass"]
            print(json.dumps(rec), flush=True)
            return
        ch = f"ch={chan} " if kch else ""
        sf_tag = f"sf={p.sf} " if blind else ""
        sic_tag = (f"sic={row['sic_pass']} " if "sic_pass" in row else "")
        print(f"frame {ch}{sf_tag}@{abs_start} "
              f"sync=0x{row['sync']:02x} "
              f"cfo_bins={row['cfo_bins']} "
              f"snr={row['snr_db']:.1f}dB "
              f"sro={row['sro_ppm']:+.1f}ppm "
              f"{sic_tag}payload={payload.hex()}", flush=True)


    if flags["mesh"]:
        # time-sharded streaming: every fed block rides ONE
        # parallel/stream.receive_stream_block_planar program over a
        # (1 x T) mesh (seam halos, global starts), with the fixed-length
        # tail carry + exact-start dedupe of MeshStreamDemodulator; the
        # CLI's near-window dedupe still guards bin-jitter re-finds.
        # --checkpoint uses save_mesh_state's format (distinct from the
        # single-device carry file — not cross-resumable).
        import jax

        from ..parallel import mesh as meshlib
        from ..parallel.stream import (MeshStreamDemodulator,
                                       load_mesh_state, save_mesh_state)

        t_shards = flags["mesh"]
        devs = jax.devices()
        if t_shards > len(devs):
            print(f"--mesh={t_shards} exceeds {len(devs)} devices",
                  file=sys.stderr)
            return 1
        m = meshlib.make_mesh(n_channel=1, n_time=t_shards,
                              devices=devs[:t_shards])
        rx = MeshStreamDemodulator(
            params, n_payload_symbols, m, max_frames=flags["max-frames"],
            preamble_len=npre, min_power_db=flags["thresh"],
            pre_acc=3 if flags["robust"] else 1,
            with_spectra=flags["soft"])
        # minimum fed block: per-shard (keep+B)/T must hold frame+margin
        min_b = max(rx.unit, rx.halo * t_shards - rx.keep)
        min_b = -(-min_b // rx.unit) * rx.unit
        mb = -(-max(block, min_b) // rx.unit) * rx.unit
        state = rx.init_state(1)
        if ckpt and ckpt.exists():
            state = load_mesh_state(ckpt)
            n_frames = int(state.n_frames)
        pend_re = np.zeros(0, np.float32)
        pend_im = np.zeros(0, np.float32)
        try:
            eof = False
            while not eof:
                raw = src.read(mb * bytes_per_sample)
                if raw:
                    n = len(raw) // bytes_per_sample
                    arr = np.frombuffer(raw[: n * bytes_per_sample], dtype)
                    re, im = runtime.to_planar(arr, flags["scale"])
                    if flags["invert-iq"]:
                        im = -im
                    pend_re = np.concatenate([pend_re, np.asarray(re)])
                    pend_im = np.concatenate([pend_im, np.asarray(im)])
                else:
                    eof = True
                    if pend_re.size == 0:
                        break
                    # zero-pad the final chunk up to a VALID fed block
                    # (>= min_b so the per-shard halo check holds; the
                    # pad region is silence and yields no frames)
                    tgt = max(min_b,
                              -(-pend_re.size // rx.unit) * rx.unit)
                    pad = tgt - pend_re.size
                    pend_re = np.concatenate(
                        [pend_re, np.zeros(pad, np.float32)])
                    pend_im = np.concatenate(
                        [pend_im, np.zeros(pad, np.float32)])
                while pend_re.size >= mb or (eof and pend_re.size):
                    cut = mb if pend_re.size >= mb else pend_re.size
                    state, frames = rx.process(
                        state, pend_re[None, :cut], pend_im[None, :cut])
                    pend_re = pend_re[cut:]
                    pend_im = pend_im[cut:]
                    for row in frames:
                        report(row, params, 0, 0)
        finally:
            if src is not sys.stdin.buffer:
                src.close()
        if ckpt:
            save_mesh_state(state._replace(n_frames=n_frames), ckpt)
        if not flags["quiet"]:
            print(f"{n_frames} frames ({t_shards} time shards)",
                  file=sys.stderr)
        return 0

    def process(buf_re, buf_im, buf_base):
        for p in params_by_sf:
            if kch:
                pad = (-buf_re.size) % rate
                if pad:
                    br = np.concatenate([buf_re, np.zeros(pad, np.float32)])
                    bi = np.concatenate([buf_im, np.zeros(pad, np.float32)])
                else:
                    br, bi = buf_re, buf_im
                if flags["sic"]:
                    # collision receive per sub-channel: channelize once,
                    # then peel each channel's overlapping frames
                    from ..ops.channelizer import channelize_planar

                    cr, ci = channelize_planar(br, bi, kch, flags["taps"])
                    cr, ci = np.asarray(cr), np.asarray(ci)
                    for chan in range(kch):
                        rows, _ = sic_model.receive_sic_planar(
                            cr[chan], ci[chan], p, n_payload_symbols,
                            max_frames=flags["max-frames"],
                            preamble_len=npre,
                            min_power_db=flags["thresh"],
                            max_iters=flags["max-frames"],
                            pre_acc=3 if flags["robust"] else 1,
                        )
                        for row in rows:
                            report(row, p, chan, buf_base)
                    continue
                res = sync.receive_wideband_planar(
                    br, bi, kch, p, n_payload_symbols,
                    max_frames=flags["max-frames"], preamble_len=npre,
                    taps_per_branch=flags["taps"],
                    min_power_db=flags["thresh"],
                    pre_acc=3 if flags["robust"] else 1,
                    with_spectra=flags["soft"],
                )
                blk, spec = res if flags["soft"] else (res, None)
                if spec is not None:
                    spec = np.asarray(spec)
                for chan in range(kch):
                    sub = sync.BlockFrames(*(f[chan] for f in blk))
                    for row in sync.block_rows(sub):
                        if spec is not None:
                            row["spectra"] = spec[chan, row["k"]]
                        report(row, p, chan, buf_base)
            elif flags["sic"]:
                # collision receive: peel frames in power order (exact-TX
                # resynthesis + LS gain fit + subtract, models/sic.py) so
                # overlapping same-SF frames all decode
                rows, _ = sic_model.receive_sic_planar(
                    buf_re, buf_im, p, n_payload_symbols,
                    max_frames=flags["max-frames"], preamble_len=npre,
                    min_power_db=flags["thresh"],
                    max_iters=flags["max-frames"],
                    pre_acc=3 if flags["robust"] else 1,
                )
                for row in rows:
                    report(row, p, 0, buf_base)
            else:
                res = sync.receive_block_planar(
                    buf_re, buf_im, p, n_payload_symbols,
                    max_frames=flags["max-frames"], preamble_len=npre,
                    min_power_db=flags["thresh"],
                    pre_acc=3 if flags["robust"] else 1,
                    with_spectra=flags["soft"],
                )
                blk, spec = res if flags["soft"] else (res, None)
                if spec is not None:
                    spec = np.asarray(spec)
                for row in sync.block_rows(blk):
                    if spec is not None:
                        row["spectra"] = spec[row["k"]]
                    report(row, p, 0, buf_base)

    try:
        while True:
            raw = src.read(block * bytes_per_sample)
            if not raw:
                break
            n = len(raw) // bytes_per_sample
            arr = np.frombuffer(raw[: n * bytes_per_sample], dtype)
            re, im = runtime.to_planar(arr, flags["scale"])
            if flags["invert-iq"]:
                im = -im     # LoRaWAN-downlink convention (conjugate input)
            if flags["frontend-correct"]:
                # blind per-block DC/IQ-imbalance correction (identity on
                # silent blocks — the estimator guards its statistics)
                from ..ops.impair import (compensate_frontend_planar,
                                          estimate_frontend_planar)

                cr, ci = compensate_frontend_planar(
                    re, im, *estimate_frontend_planar(re, im))
                re, im = np.asarray(cr), np.asarray(ci)
            # a short tail chunk is processed unpadded (one extra jit
            # trace at most, and the carry stays exactly the real stream
            # so --checkpoint resume is gap-free)
            buf_re = np.concatenate([carry_re, re])
            buf_im = np.concatenate([carry_im, im])
            if flags["cad"]:
                # listen-before-process: the SX126x-style activity gate
                # (models/sync.cad_planar) probes every 4th window at each
                # candidate SF — a quarter-cost dechirp+DFT that skips the
                # full receive program on silent buffers
                active = any(
                    bool(np.asarray(sync.cad_planar(
                        buf_re, buf_im, p, threshold_db=flags["thresh"])[0]))
                    for p in params_by_sf
                )
                if not active:
                    n_skipped += 1
                else:
                    process(buf_re, buf_im, base)
            else:
                process(buf_re, buf_im, base)
            keep = min(carry_len, buf_re.size)
            base += buf_re.size - keep                 # abs index of carry[0]
            carry_re = buf_re[-keep:].copy()
            carry_im = buf_im[-keep:].copy()
            # keep the dedupe set bounded: starts behind the carry can
            # never be reported again
            reported = {t for t in reported
                        if t[2] >= base - frame_len * rate}
    finally:
        if src is not sys.stdin.buffer:
            src.close()

    if ckpt:
        with open(ckpt, "wb") as f:       # exact path (savez appends .npz)
            np.savez(f, re=carry_re, im=carry_im, base=np.int64(base),
                     reported=np.asarray(sorted(reported),
                                         np.int64).reshape(-1, 3),
                     n_frames=np.int64(n_frames))
    if not flags["quiet"]:
        cad_note = (f" ({n_skipped} buffers CAD-skipped)"
                    if flags["cad"] else "")
        print(f"{n_frames} frames{cad_note}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
