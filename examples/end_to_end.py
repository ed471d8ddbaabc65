#!/usr/bin/env python3
"""End-to-end walkthrough of the framework's layers.

(The reference ships Pothos topology examples that need absent hardware;
these examples run anywhere, CPU included: JAX_PLATFORMS=cpu python
examples/end_to_end.py.)
"""

import numpy as np

from lora_phy_tpu.models import coded, modem, stream
from lora_phy_tpu.models.coded import CodedConfig
from lora_phy_tpu.ops.impair import apply_awgn, apply_cfo_continuous
from lora_phy_tpu.utils.params import LoraParams

import jax


def simple_chain():
    print("== simple Hamming84 chain (the reference's encode/decode) ==")
    p = LoraParams(sf=7)
    payload = np.frombuffer(b"hello gpu lora!!", dtype=np.uint8)
    symbols = modem.encode(payload)
    iq = modem.modulate(symbols, p)
    res = modem.demodulate(modem.dechirp(iq, p), p)
    out = np.asarray(modem.decode(np.asarray(res.symbols)))
    print(f"payload: {payload.tobytes()!r}")
    print(f"decoded: {out.tobytes()!r}  sync=0x{int(res.sync_word):02x}")


def coded_chain():
    print("\n== full coded chain over a noisy channel ==")
    cfg = CodedConfig(sf=8, cr=4)         # CR 4/8, whitening + CRC
    p = LoraParams(sf=8)
    payload = np.frombuffer(b"The quick brown fox!", dtype=np.uint8)
    syms = coded.encode_payload(payload, cfg)
    iq = modem.modulate(syms.astype(np.uint16), p)
    noisy = apply_awgn(jax.random.PRNGKey(0), modem.dechirp(iq, p), 10.0)
    res = modem.demodulate(noisy, p)
    out, crc_ok, fec_err = coded.decode_payload(
        np.asarray(res.symbols), len(payload), cfg
    )
    print(f"decoded: {np.asarray(out).tobytes()!r} "
          f"crc_ok={bool(np.all(np.asarray(crc_ok)))} "
          f"fec_corrections={int(np.asarray(fec_err))}")


def streaming():
    print("\n== frame sync over a continuous stream with CFO ==")
    p = LoraParams(sf=7)
    cfg = CodedConfig(sf=7, cr=2)
    payload = np.frombuffer(b"frame one", dtype=np.uint8)
    syms = coded.encode_payload(payload, cfg)
    frame = np.asarray(stream.frame_modulate(syms.astype(np.uint16), p))
    sig = np.concatenate([
        np.zeros(777, np.complex64), frame, np.zeros(1000, np.complex64)
    ])
    sig = np.asarray(apply_cfo_continuous(sig, 2.0, p.n, p.osr))
    out, sync = stream.frame_demodulate(sig, p, syms.shape[-1])
    print(f"frame found at sample {sync.start} (true 777), "
          f"cfo={sync.cfo_bins} bins (true 2)")
    dec, crc_ok, _ = coded.decode_payload(np.asarray(out.symbols), len(payload), cfg)
    print(f"decoded: {np.asarray(dec).tobytes()!r}")


def sharded():
    print("\n== multi-device sharded streaming demod ==")
    import jax
    from lora_phy_tpu.parallel import mesh as meshlib
    from lora_phy_tpu.parallel.stream import demodulate_stream

    devs = jax.devices()
    n = len(devs) - len(devs) % 2 if len(devs) > 1 else 1
    if n < 2:
        print("(single device; run tests on the 8-device CPU mesh instead)")
        return
    m = meshlib.make_mesh(n_channel=n // 2, n_time=2, devices=devs[:n])
    p = LoraParams(sf=7)
    payloads = np.tile(np.arange(31, dtype=np.uint8), (n // 2, 1))
    syms = modem.encode(payloads)
    dech = np.asarray(modem.dechirp(modem.modulate(syms, p), p))
    sharded_in = jax.device_put(dech, meshlib.stream_sharding(m))
    out_syms, sync, cfo, to = demodulate_stream(sharded_in, p, m)
    out = np.asarray(modem.decode(np.asarray(out_syms)[..., 2:]))
    print(f"mesh {m.shape}: decoded ok={np.array_equal(out, payloads)}")


def wideband():
    print("\n== wideband channelizer: two transmitters, one antenna ==")
    from lora_phy_tpu.ops.channelizer import channelize, synthesize_tone_channels

    p = LoraParams(sf=7)
    k = 4
    pay_a = np.frombuffer(b"chan one", dtype=np.uint8)
    pay_b = np.frombuffer(b"chan two", dtype=np.uint8)
    iq_a = np.asarray(modem.modulate(modem.encode(pay_a), p))
    iq_b = np.asarray(modem.modulate(modem.encode(pay_b), p))
    sigs = np.zeros((k, iq_a.size), np.complex64)
    sigs[1], sigs[3] = iq_a, iq_b
    wide = np.asarray(synthesize_tone_channels(sigs, k))
    chans = np.asarray(channelize(wide, k))
    for chan, expect in ((1, pay_a), (3, pay_b)):
        res = modem.demodulate(np.asarray(modem.dechirp(chans[chan] * k, p)), p)
        out = np.asarray(modem.decode(np.asarray(res.symbols)))
        print(f"channel {chan}: {out.tobytes()!r}")


def gr_capture():
    print("\n== gr-lora_sdr OTA capture blind decode ==")
    import pathlib
    from lora_phy_tpu.models import gr_interop
    from lora_phy_tpu.utils.iqio import read_iq

    cap_path = pathlib.Path("/root/reference/vectors_binary/"
                            "bw_125k_sf_7_cr_1_ldro_false_crc_true_implheader_false.unknown")
    if not cap_path.exists():
        print("(capture not available)")
        return
    frame = gr_interop.decode_frame(read_iq(cap_path), LoraParams(sf=7, osr=2))
    print(f"payload: {frame.payload!r} crc_ok={frame.crc_ok} "
          f"header_ok={frame.header_ok} cr=4/{frame.cr+4}")


if __name__ == "__main__":
    simple_chain()
    coded_chain()
    streaming()
    sharded()
    wideband()
    gr_capture()
