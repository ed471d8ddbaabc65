"""Streaming TX: payload list -> one continuous framed IQ stream.

The transmit counterpart of ``rx_stream`` (the reference's tx_runner
emits exactly one unframed burst; reference: runners/tx_runner.cpp:32-141).
Each input line is a hex payload; every payload becomes a full LoRa frame
(preamble + sync + 2.25 downchirps + data, models/stream.frame_modulate)
separated by ``--gap`` samples of silence, written as cf32/ci16/ci8
interleaved IQ through the native conversion runtime. The output of

    lora-tx-stream --payloads=list.txt --out=s.iq
    lora-rx-stream --in=s.iq --payload-len=N

round-trips frame-for-frame (gated in tests/test_rx_stream.py).

``--invert-iq`` conjugates the output (upchirps become downchirps) —
the LoRaWAN downlink convention, so a gateway-side receiver and an
end-device receiver never lock on each other's traffic. ``--coded``
emits self-describing frames (explicit header carrying length/CR/CRC +
the full coded chain, models/stream.frame_encode) that
``rx_stream --adaptive`` decodes with no prior payload-size knowledge;
``--cr`` selects 4/5..4/8, ``--crc`` appends the CRC16 trailer.

Flags: ``--payloads=FILE|-`` (hex lines; or ``--payload=HEX`` repeated
count times via ``--count``) ``--out=FILE|-`` ``--sf`` ``--cr`` ``--bw``
``--osr`` ``--sync`` ``--gap=SAMPLES`` ``--format=cf32|ci16|ci8``
``--ampl`` ``--invert-iq`` ``--coded`` ``--crc`` ``--ldro`` ``--preamble=N``
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils.compile_cache import enable_compile_cache
from ._cli import bandwidth_flag, params_from, parse_flags

_FORMATS = {"cf32", "ci16", "ci8"}


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "payloads": (str, ""),
        "payload": (str, ""),
        "count": (int, 1),
        "out": (str, "-"),
        "sf": (int, 7),
        "cr": (int, 1),
        "bw": (bandwidth_flag, None),
        "osr": (int, 1),
        "sync": (lambda v: int(v, 0), 0x12),
        "gap": (int, 1024),
        "format": (str, "cf32"),
        "ampl": (float, 1.0),
        "continuous-chirp": (None, False),
        "invert-iq": (None, False),
        "coded": (None, False),
        "crc": (None, False),
        "ldro": (None, False),
        "preamble": (int, 8),
    })
    if flags["format"] not in _FORMATS:
        print(f"Unknown --format={flags['format']}", file=sys.stderr)
        return 1
    if flags["payload"]:
        payload_hex = [flags["payload"]] * flags["count"]
    elif flags["payloads"]:
        src = (sys.stdin if flags["payloads"] == "-"
               else open(flags["payloads"]))
        payload_hex = [l.strip() for l in src if l.strip()]
        if src is not sys.stdin:
            src.close()
    else:
        print("Need --payload=HEX or --payloads=FILE", file=sys.stderr)
        return 1
    params = params_from({k: v for k, v in flags.items() if v is not None})

    from .. import runtime
    from ..models import modem, stream

    out = (sys.stdout.buffer if flags["out"] in ("", "-")
           else open(flags["out"], "wb"))
    gap = np.zeros(flags["gap"], np.complex64)
    n = 0
    try:
        for hx in payload_hex:
            try:
                payload = np.frombuffer(bytes.fromhex(hx), np.uint8)
            except ValueError:
                print(f"Bad hex payload: {hx!r}", file=sys.stderr)
                return 1
            if flags["coded"]:
                # self-describing frame: explicit header (length/CR/CRC)
                # + full coded chain — decodable by `rx_stream --adaptive`
                # with no prior payload-size knowledge
                from ..models.coded import CodedConfig

                if len(payload) > 255:     # 8-bit header length field
                    print(f"--coded payload too long ({len(payload)} > 255 "
                          "bytes)", file=sys.stderr)
                    return 1
                if not 1 <= flags["cr"] <= 4:    # 3-bit header CR field
                    print(f"--coded needs --cr in 1..4, got {flags['cr']}",
                          file=sys.stderr)
                    return 1
                cfg = CodedConfig(sf=params.sf, cr=flags["cr"],
                                  crc=flags["crc"], ldro=flags["ldro"])
                iq = np.asarray(stream.frame_encode(
                    payload, cfg, params, preamble_len=flags["preamble"]))
                if flags["ampl"] != 1.0:
                    iq = (iq * np.float32(flags["ampl"])).astype(np.complex64)
            else:
                syms = np.asarray(modem.encode(payload), np.int32)
                iq = np.asarray(stream.frame_modulate(
                    syms, params, flags["preamble"],
                    amplitude=flags["ampl"]))
            burst = np.concatenate([gap, iq])
            im = burst.imag.astype(np.float32)
            if flags["invert-iq"]:
                im = -im
            cf32 = runtime.from_planar(burst.real.astype(np.float32), im)
            if flags["format"] == "cf32":
                out.write(cf32.tobytes())
            elif flags["format"] == "ci16":
                out.write(np.clip(np.round(cf32 * 32767), -32768, 32767)
                          .astype(np.int16).tobytes())
            else:
                out.write(np.clip(np.round(cf32 * 127), -128, 127)
                          .astype(np.int8).tobytes())
            n += burst.size
    finally:
        if out is not sys.stdout.buffer:
            out.close()
    print(f"wrote {n} samples ({len(payload_hex)} frames)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
