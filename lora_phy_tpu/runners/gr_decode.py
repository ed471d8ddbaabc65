"""gr-lora_sdr capture decoder CLI.

Decodes every gr-lora_sdr frame found in an IQ capture (the tool the
reference's capture-forensics scripts were trying to be):

  python -m lora_phy_tpu.runners.gr_decode --in=capture.iq --sf=7 --osr=2
"""

from __future__ import annotations

import sys

import numpy as np

from ..models import gr_interop
from ..utils.iqio import read_iq
from ..utils.params import LoraParams
from ..utils.compile_cache import enable_compile_cache
from ._cli import parse_flags


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "in": (str, ""),
        "sf": (int, 7),
        "osr": (int, 1),
        "preamble": (int, 8),
        "max-frames": (int, 64),
        "soft": (None, False),
        "ldro": (None, False),
        "implicit": (None, False),
        "length": (int, 0),
        "cr": (int, 0),
        "crc": (None, False),
    })
    if flags["implicit"] and not (flags["length"] and flags["cr"]):
        print("--implicit needs --length and --cr (the gr receiver is "
              "configured the same way)", file=sys.stderr)
        return 1
    samples = read_iq(flags["in"] or "-")
    params = LoraParams(sf=flags["sf"], osr=flags["osr"])

    found = 0
    offset = 0
    step = params.step
    overhead = (flags["preamble"] + 4) * step + step // 4
    while found < flags["max-frames"] and samples.size - offset > 16 * step:
        frame = gr_interop.decode_frame(
            samples[offset:], params, preamble_len=flags["preamble"],
            ldro=flags["ldro"], implicit=flags["implicit"],
            length=flags["length"] or None, cr=flags["cr"] or None,
            crc=flags["crc"] if flags["implicit"] else None,
            soft=flags["soft"])
        if frame is None:
            break
        if not frame.header_ok:
            # false sync (or damaged header): skip past this detection
            offset += frame.start + step
            continue
        found += 1
        print(
            f"frame @{offset + frame.start}: len={frame.length} "
            f"cr=4/{frame.cr + 4} crc={'ok' if frame.crc_ok else 'BAD'} "
            f"cfo={frame.cfo_bins} fec_err={frame.fec_errors}"
        )
        print(f"  payload: {frame.payload.hex()}  {frame.payload!r}")
        # continue scanning after this frame's payload: the exact gr
        # geometry (the header block already carries sf-7 payload
        # nibbles; LDRO changes the rest-block PPM) — an overestimate
        # could land the rescan inside a closely-following preamble
        from ..models.gr_interop import payload_block_plan

        in_first, ppm_rest, n_rest, _ = payload_block_plan(
            params.sf, frame.cr, frame.length, frame.has_crc,
            flags["ldro"], flags["implicit"])
        nsym = 8 + n_rest * (4 + max(1, frame.cr))
        offset += frame.start + overhead + nsym * step
    if not found:
        print("no frames found", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
