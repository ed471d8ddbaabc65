"""Stage-selectable raw vector dump.

Equivalent of the reference's ``lora_phy_vector_dump``
(reference: runners/lora_phy_vector_dump.cpp:25-206): same flags plus
``--dump=STAGE,...`` selecting among payload, pre_interleave,
post_interleave, iq, demod, deinterleave, decoded; raw (non-base64) files.
"""

from __future__ import annotations

import pathlib
import sys

from ..utils.compile_cache import enable_compile_cache
from ._cli import bandwidth_flag, params_from, parse_flags, window_flag
from .vector_generate import generate

ALL_STAGES = (
    "payload", "pre_interleave", "post_interleave", "iq", "demod",
    "deinterleave", "decoded",
)

_STAGE_FILES = {
    "payload": "payload.bin",
    "pre_interleave": "pre_interleave.csv",
    "post_interleave": "post_interleave.csv",
    "iq": "iq_samples.csv",
    "demod": "demod_symbols.csv",
    "deinterleave": "deinterleave.csv",
    "decoded": "decoded.bin",
}


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "sf": (int, 7),
        "seed": (int, 1),
        "bytes": (int, 16),
        "osr": (int, 1),
        "bw": (bandwidth_flag, None),
        "out": (str, "vector_dump"),
        "window": (window_flag, None),
        "dump": (str, ",".join(ALL_STAGES)),
        "quirk-compat": (None, False),
    })
    stages = [s.strip() for s in flags["dump"].split(",") if s.strip()]
    unknown = set(stages) - set(ALL_STAGES)
    if unknown:
        print(f"Unknown stages: {sorted(unknown)}", file=sys.stderr)
        return 1

    params = params_from({k: v for k, v in flags.items() if v is not None})
    out = pathlib.Path(flags["out"])
    generate(out, params, seed=flags["seed"], byte_count=flags["bytes"],
             quirk_compat=flags["quirk-compat"], b64=False)
    keep = {_STAGE_FILES[s] for s in stages} | {"manifest.json"}
    for f in out.iterdir():
        if f.name not in keep:
            f.unlink()
    print(f"dumped stages {stages} to {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
