"""Golden-vector generator: full-stage dumps + base64 + SHA256 manifest.

Equivalent of the reference's ``generate_lora_phy_vectors``
(reference: runners/lora_phy_vector_generate.cpp:128-275): same flags
(``--sf --seed --bytes --osr --bw --out --window --cfo-bins --time-offset``),
same stage files (payload.bin, pre_interleave.csv, post_interleave.csv,
iq_samples.csv, demod_symbols.csv, deinterleave.csv, decoded.bin, plus
iq_samples_offset.csv when impairments are requested), base64-encoded with
a manifest.json of SHA256 hashes — without the reference's ``popen`` /
``system`` shell-outs.

One deliberate divergence (SURVEY.md §2.3 finding 3): the demod stage uses
the *working* dechirped path, so ``decoded.bin`` actually equals
``payload.bin`` — the reference's own goldens encode its broken integrated
path. Pass ``--quirk-compat`` to reproduce the reference's behaviour.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

from ..models import modem
from ..ops import coding
from ..ops.impair import apply_cfo, apply_time_shift
from ..utils.manifest import b64_encode_file, write_manifest
from ..utils.compile_cache import enable_compile_cache
from ._cli import bandwidth_flag, params_from, parse_flags, window_flag


def generate(out_dir, params, seed=1, byte_count=16, cfo_bins=0.0,
             time_offset=0.0, quirk_compat=False, b64=True):
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    rng = np.random.RandomState(seed)
    payload = rng.randint(0, 256, byte_count).astype(np.uint8)

    sf = params.sf
    nibble_count = byte_count * 2
    cw_count = -(-nibble_count // sf) * sf
    rdd = 4
    blocks = cw_count // sf
    symbol_count = blocks * (4 + rdd)

    # pre-interleave stage: Hamming84 codeword per nibble, zero padded
    nibbles = np.zeros(cw_count, dtype=np.uint8)
    nibbles[:nibble_count] = np.asarray(coding.bytes_to_nibbles(payload))
    pre_interleave = np.asarray(coding.hamming84_encode(nibbles))

    # encode/modulate (the reference's encode() is the same Hamming84 map)
    symbols = np.asarray(modem.encode(payload))
    iq = np.asarray(modem.modulate(symbols, params))

    # demodulate: working path by default, integrated-quirk on request
    if quirk_compat:
        res = modem.demodulate_integrated(iq, params, quirk_compat=True)
    else:
        res = modem.demodulate(np.asarray(modem.dechirp(iq, params)), params)
    demod = np.zeros(symbol_count, dtype=np.uint16)
    got = np.asarray(res.symbols)
    demod[: min(symbol_count, got.size)] = got[:symbol_count]

    # deinterleave stage artifact, kept for file-level parity with the
    # reference's pipeline (which deinterleaves symbols the TX never
    # interleaved — part of why its decoded.bin goldens are broken)
    deinter = np.asarray(coding.diagonal_deinterleave(demod, sf, rdd))
    if quirk_compat:
        dec_nib, _, _ = coding.hamming84_decode(deinter)
        decoded = np.asarray(
            coding.nibbles_to_bytes(np.asarray(dec_nib)[:nibble_count])
        )
    else:
        # working path: the demod symbols ARE the Hamming84 codewords
        decoded = np.asarray(modem.decode(demod[:nibble_count]))

    (out / "payload.bin").write_bytes(payload.tobytes())
    (out / "pre_interleave.csv").write_text(
        "".join(f"{v}\n" for v in pre_interleave)
    )
    (out / "post_interleave.csv").write_text("".join(f"{v}\n" for v in symbols))
    (out / "iq_samples.csv").write_text(
        "".join(f"{s.real:g},{s.imag:g}\n" for s in iq)
    )
    (out / "demod_symbols.csv").write_text("".join(f"{v}\n" for v in demod))
    (out / "deinterleave.csv").write_text("".join(f"{v}\n" for v in deinter))
    (out / "decoded.bin").write_bytes(decoded.tobytes())

    if cfo_bins != 0.0 or time_offset != 0.0:
        impaired = iq.astype(np.complex128)
        if cfo_bins:
            impaired = np.asarray(
                apply_cfo(impaired.astype(np.complex64), cfo_bins, 1 << sf, params.osr)
            )
        if time_offset:
            impaired = np.asarray(
                apply_time_shift(impaired.astype(np.complex64), int(round(time_offset)))
            )
        (out / "iq_samples_offset.csv").write_text(
            "".join(f"{s.real:g},{s.imag:g}\n" for s in impaired)
        )

    if b64:
        for f in sorted(out.iterdir()):
            if f.suffix in (".bin", ".csv"):
                b64_encode_file(f)
    write_manifest(out)
    return out


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "sf": (int, 7),
        "seed": (int, 1),
        "bytes": (int, 16),
        "osr": (int, 1),
        "bw": (bandwidth_flag, None),
        "out": (str, ""),
        "window": (window_flag, None),
        "cfo-bins": (float, 0.0),
        "time-offset": (float, 0.0),
        "quirk-compat": (None, False),
        "no-b64": (None, False),
    })
    if not flags["out"]:
        print("--out=SUBDIR required", file=sys.stderr)
        return 1
    params = params_from({k: v for k, v in flags.items() if v is not None})
    out = pathlib.Path("vectors/lora_phy") / flags["out"]
    generate(out, params, seed=flags["seed"], byte_count=flags["bytes"],
             cfo_bins=flags["cfo-bins"], time_offset=flags["time-offset"],
             quirk_compat=flags["quirk-compat"], b64=not flags["no-b64"])
    print(f"vectors written to {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
