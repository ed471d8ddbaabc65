"""lora-scope: spectrogram / dechirped-waterfall diagnostics for IQ files.

The SDR-debugging view the reference never had: what is actually in a
capture, where the receiver syncs, and why. Writes a two-panel PNG:

1. STFT waterfall of the raw stream (chirp sweeps are the diagonal
   stripes; interferers, DC spurs and images show up immediately);
2. the up-dechirped per-window spectrum (the synchroniser's view: a
   preamble is a horizontal line at its CFO bin), overlaid with every
   frame the device-side scan reports (start marker + sync/payload
   span).

Flags: ``--in=FILE`` ``--sf`` ``--bw`` ``--osr`` ``--sync``
``--format=cf32|ci16|ci8`` ``--scale`` ``--payload-len=BYTES``
``--thresh=DB`` ``--robust`` ``--out=PNG`` ``--max-samples=N``
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils.compile_cache import enable_compile_cache
from ._cli import bandwidth_flag, params_from, parse_flags

_FORMATS = {"cf32": (np.float32, 8), "ci16": (np.int16, 4), "ci8": (np.int8, 2)}


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "in": (str, ""),
        "sf": (int, 7),
        "bw": (bandwidth_flag, None),
        "osr": (int, 1),
        "sync": (lambda v: int(v, 0), 0x12),
        "format": (str, "cf32"),
        "scale": (float, 1.0),
        "payload-len": (int, 16),
        "thresh": (float, -30.0),
        "robust": (None, False),
        "out": (str, "scope.png"),
        "max-samples": (int, 1 << 21),
    })
    if flags["format"] not in _FORMATS:
        print(f"Unknown --format={flags['format']}", file=sys.stderr)
        return 1
    if not flags["in"]:
        print("Need --in=FILE", file=sys.stderr)
        return 1
    params = params_from({k: v for k, v in flags.items() if v is not None})

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .. import runtime
    from ..models import sync
    from ..ops.chirp import base_downchirp_planar

    dtype, bps = _FORMATS[flags["format"]]
    raw = np.fromfile(flags["in"], dtype)
    raw = raw[: 2 * flags["max-samples"]]
    re, im = runtime.to_planar(raw, flags["scale"])
    x = (np.asarray(re) + 1j * np.asarray(im)).astype(np.complex64)
    step, n = params.step, params.n
    nwin = x.size // step
    if nwin < 2:
        print("input shorter than two symbol windows", file=sys.stderr)
        return 1
    x = x[: nwin * step]

    # panel 1: raw STFT (window = one symbol period)
    w = x.reshape(nwin, step)
    stft = np.fft.fftshift(np.abs(np.fft.fft(w, axis=-1)), axes=-1)

    # panel 2: the synchroniser's view — up-dechirped, decimated spectra
    dr, di = base_downchirp_planar(params.sf, params.scale, params.osr)
    dech = w * (dr + 1j * di)
    dech = dech.reshape(nwin, n, params.osr)[:, :, 0]
    upspec = np.abs(np.fft.fft(dech, axis=-1))

    # device-side receive for annotations
    blk = sync.receive_block_planar(
        x.real.astype(np.float32), x.imag.astype(np.float32), params,
        flags["payload-len"] * 2, max_frames=16,
        min_power_db=flags["thresh"],
        pre_acc=3 if flags["robust"] else 1)
    rows = sync.block_rows(blk)

    db = lambda a: 20.0 * np.log10(np.maximum(a, 1e-6))  # noqa: E731
    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(16, 8), sharex=True)
    ax0.imshow(db(stft).T, aspect="auto", origin="lower",
               extent=(0, nwin, -step / 2, step / 2), cmap="viridis")
    ax0.set_ylabel("frequency bin (raw)")
    ax0.set_title(f"{flags['in']} — STFT waterfall "
                  f"(SF{params.sf}, {nwin} symbol windows)")
    ax1.imshow(db(upspec).T, aspect="auto", origin="lower",
               extent=(0, nwin, 0, n), cmap="magma")
    ax1.set_ylabel("up-dechirped bin")
    ax1.set_xlabel("symbol window")
    title = "up-dechirped (synchroniser view)"
    for r in rows:
        w0 = r["start"] / step
        ax1.axvline(w0, color="w", ls="--", lw=1.0)
        ax1.annotate(
            f"sync=0x{r['sync']:02x} cfo={r['cfo_bins']} "
            f"snr={r['snr_db']:.0f}dB",
            (w0, n * 0.92), color="w", fontsize=8)
    ax1.set_title(f"{title} — {len(rows)} frame(s) detected")
    fig.tight_layout()
    fig.savefig(flags["out"], dpi=100)
    print(f"wrote {flags['out']} ({len(rows)} frames annotated)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
