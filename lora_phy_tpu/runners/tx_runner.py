"""TX runner: hex payload -> encode -> modulate -> float32 IQ file/stdout.

Flag-for-flag equivalent of the reference's ``tx_runner``
(reference: runners/tx_runner.cpp:32-141):
``--payload=HEX [--sf=N] [--cr=N] [--bw=HZ] [--out=FILE|--stdout]``.
"""

from __future__ import annotations

import sys

import numpy as np

from ..models import modem
from ..utils.iqio import write_iq
from ..utils.compile_cache import enable_compile_cache
from ._cli import bandwidth_flag, params_from, parse_flags


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "payload": (str, ""),
        "sf": (int, 7),
        "cr": (int, 1),
        "bw": (bandwidth_flag, None),
        "osr": (int, 1),
        "out": (str, ""),
        "stdout": (None, False),
        "continuous-chirp": (None, False),
    })
    hexstr = flags["payload"]
    if not hexstr or len(hexstr) % 2 != 0:
        print("Invalid or missing --payload hex", file=sys.stderr)
        return 1
    payload = np.frombuffer(bytes.fromhex(hexstr), dtype=np.uint8)
    params = params_from({k: v for k, v in flags.items() if v is not None})

    symbols = modem.encode(payload)
    iq = np.asarray(modem.modulate(symbols, params))

    if flags["stdout"] or not flags["out"]:
        write_iq("-", iq)
    else:
        write_iq(flags["out"], iq)
        print(f"wrote {iq.size} samples to {flags['out']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
