"""Regenerate logs/soft_vs_hard_waterfall_r*.csv: frame-loss counts for
hard argmax decisions vs soft max-log-LLR ML decoding through the SF7
waterfall knee, identical noise realisations for both paths (soft can
only remove errors).

    python tools/soft_waterfall_sweep.py [--frames=400] [--out=PATH]
           [--crs=1,4] [--snrs=-8,-9,-10,-11,-12,-13]

CSV: ``cr,snr_db,frames,hard_lost,soft_lost`` + 95% Wilson interval
columns for both loss rates. Frame-aligned coded
frames (no sync scan — that axis is characterised separately by
tools/sync_sensitivity_sweep.py); the hard path is the production
demodulate_planar argmax + coded.decode_payload, the soft path is
demodulate_spectrum_planar + soft.decode_payload_soft on the SAME
dechirped planes. The reference has no soft path to compare against
(LoRaCodes.hpp syndrome decoding is hard-only); the committed-curve
discipline mirrors its tests/awgn_sweep.py.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import numpy as np  # noqa: E402

from lora_phy_tpu.models import coded, soft  # noqa: E402
from lora_phy_tpu.models.coded import CodedConfig  # noqa: E402
from lora_phy_tpu.ops import planar  # noqa: E402
from lora_phy_tpu.ops.impair import apply_awgn  # noqa: E402
from lora_phy_tpu.utils.params import LoraParams  # noqa: E402


def losses(cr: int, snr_db: float, n_frames: int, sf=7, payload_len=12,
           seed=0):
    """(hard_lost, soft_lost) over n_frames identical noise realisations."""
    p = LoraParams(sf=sf)
    cfg = CodedConfig(sf=sf, cr=cr)
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 256, (n_frames, payload_len)).astype(np.uint8)
    bins = np.asarray(coded.encode_payload(payloads, cfg))
    re, im = planar.modulate_planar(bins.astype(np.int32), p)
    iq = np.asarray(re) + 1j * np.asarray(im)
    noisy = np.asarray(apply_awgn(jax.random.PRNGKey(seed), iq, snr_db))
    dr, di = planar.dechirp_planar(
        np.ascontiguousarray(noisy.real.astype(np.float32)),
        np.ascontiguousarray(noisy.imag.astype(np.float32)), p)

    mag2, _, _, _ = planar.demodulate_spectrum_planar(dr, di, p)
    mag2 = np.asarray(mag2)
    hard, _, _ = coded.decode_payload(
        np.argmax(mag2, axis=-1).astype(np.uint16), payload_len, cfg)
    sft, _, _ = soft.decode_payload_soft(mag2, payload_len, cfg)
    hard_lost = int(np.any(np.asarray(hard) != payloads, axis=-1).sum())
    soft_lost = int(np.any(np.asarray(sft) != payloads, axis=-1).sum())
    return hard_lost, soft_lost


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    frames = 400
    out = "logs/soft_vs_hard_waterfall_r4.csv"
    crs = [1, 4]
    snrs = [-8.0, -9.0, -10.0, -11.0, -12.0, -13.0]
    for a in args:
        if a.startswith("--frames="):
            frames = int(a.split("=", 1)[1])
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--crs="):
            crs = [int(x) for x in a.split("=", 1)[1].split(",")]
        elif a.startswith("--snrs="):
            snrs = [float(x) for x in a.split("=", 1)[1].split(",")]
        else:
            print(f"unknown flag {a}", file=sys.stderr)
            return 1

    from lora_phy_tpu.utils.stats import wilson

    rows = ["cr,snr_db,frames,hard_lost,soft_lost,"
            "hard_lo,hard_hi,soft_lo,soft_hi"]
    for cr in crs:
        for snr in snrs:
            h, s = losses(cr, snr, frames)
            h_lo, h_hi = wilson(h, frames)
            s_lo, s_hi = wilson(s, frames)
            rows.append(f"{cr},{snr},{frames},{h},{s},"
                        f"{h_lo:.4f},{h_hi:.4f},{s_lo:.4f},{s_hi:.4f}")
            print(rows[-1], file=sys.stderr, flush=True)
    pathlib.Path(out).write_text("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
