"""Shared CLI flag parsing for the runners.

The reference parses ``--key=value`` flags with ``rfind("--x=", 0)`` in
every runner (reference: runners/tx_runner.cpp:39-71); this is the single
shared equivalent, accepting the same flag spellings.
"""

from __future__ import annotations

import sys

from ..utils.params import Bandwidth, LoraParams, Window


def parse_flags(argv, spec: dict):
    """Parse ``--key=value`` / bare ``--flag`` args per ``spec``
    {name: (converter_or_None, default)}. Returns dict; exits on unknown."""
    out = {k: v[1] for k, v in spec.items()}
    for arg in argv:
        if arg in ("--help", "-h"):
            flags = " ".join(
                f"[--{k}{'' if conv is None else '=V'}]" for k, (conv, _) in spec.items()
            )
            print(f"Usage: {sys.argv[0]} {flags}", file=sys.stderr)
            raise SystemExit(0)
        if not arg.startswith("--"):
            print(f"Unknown argument: {arg}", file=sys.stderr)
            raise SystemExit(1)
        body = arg[2:]
        key, sep, val = body.partition("=")
        if key not in spec:
            print(f"Unknown argument: {arg}", file=sys.stderr)
            raise SystemExit(1)
        conv = spec[key][0]
        if conv is None:
            out[key] = True
            continue
        if not sep:
            print(f"Flag --{key} requires a value: --{key}=V", file=sys.stderr)
            raise SystemExit(1)
        try:
            out[key] = conv(val)
        except ValueError:
            print(f"Invalid value for --{key}: {val!r}", file=sys.stderr)
            raise SystemExit(1)
    return out


def bandwidth_flag(val: str) -> Bandwidth:
    hz = int(val)
    try:
        return Bandwidth(hz)
    except ValueError:
        print("Unsupported bandwidth", file=sys.stderr)
        raise SystemExit(1)


def window_flag(val: str) -> Window:
    return Window.HANN if val == "hann" else Window.NONE


def params_from(flags) -> LoraParams:
    return LoraParams(
        sf=flags.get("sf", 7),
        bw=flags.get("bw", Bandwidth.BW_125),
        cr=flags.get("cr", 1),
        osr=flags.get("osr", 1),
        window=flags.get("window", Window.NONE),
        sync_word=flags.get("sync", 0x12),
        continuous_chirp=bool(flags.get("continuous-chirp", False)),
    )

