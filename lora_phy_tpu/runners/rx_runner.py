"""RX runner: IQ file/stdin -> demodulate -> decode -> hex payload.

Flag-for-flag equivalent of the reference's ``rx_runner``
(reference: runners/rx_runner.cpp:23-137):
``[--in=FILE] [--sf=N] [--cr=N] [--bw=HZ] [--report-offsets]``.

By default uses the *working* receive path (external dechirp +
``demodulate``; SURVEY.md §3.3) — the reference's integrated path fails
round-trip on clean input (SURVEY.md §2.3 finding 2). Pass
``--integrated`` for the quirk-compatible integrated path, ``--raw`` if
the input is already dechirped.
"""

from __future__ import annotations

import sys

import numpy as np

from ..models import modem
from ..utils.iqio import read_iq
from ..utils.compile_cache import enable_compile_cache
from ._cli import bandwidth_flag, params_from, parse_flags


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "in": (str, ""),
        "sf": (int, 7),
        "cr": (int, 1),
        "bw": (bandwidth_flag, None),
        "osr": (int, 1),
        "report-offsets": (None, False),
        "integrated": (None, False),
        "raw": (None, False),
    })
    params = params_from({k: v for k, v in flags.items() if v is not None})

    samples = read_iq(flags["in"] or "-")
    step = params.step
    usable = (samples.size // step) * step
    if usable < 2 * step:
        print("Input too short", file=sys.stderr)
        return 1
    samples = samples[:usable]

    if flags["integrated"]:
        res = modem.demodulate_integrated(samples, params)
    else:
        x = samples if flags["raw"] else np.asarray(modem.dechirp(samples, params))
        res = modem.demodulate(x, params)

    decoded = modem.decode_with_crc(np.asarray(res.symbols))
    payload = np.asarray(decoded.payload)
    print(payload.tobytes().hex())
    if flags["report-offsets"]:
        print(
            f"crc_ok={int(bool(decoded.crc_ok))} cfo={float(res.cfo):.6f} "
            f"time_offset={float(res.time_offset):.6f} "
            f"sync=0x{int(res.sync_word):02x}",
            file=sys.stderr,
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
