"""Educational plots: what LoRa CSS modulation looks like, end to end.

The framework counterpart of the reference's only plotting example
(reference: examples/modulation_explained_plots.py — a scalar-Python
phase-accumulator loop). Here every signal comes from the framework's own
primitives: the integer-lattice modulator (ops/chirp.py), the planar
dechirp (ops/planar.py) and the DFT-matmul spectra — so the figures
double as a visual smoke test of the real TX/RX path.

Headless by default (Agg backend); writes PNGs next to this script:

    python examples/modulation_explained.py [outdir]

Figure 1: raw modulated I/Q + instantaneous frequency (the chirp sweeps
          and wraps; the symbol value sets the starting frequency).
Figure 2: dechirped symbols (each chirp collapses to a constant tone) +
          |DFT|^2 spectra (the tone index IS the symbol).
Figure 3: a full frame (preamble / sync / 2.25 downchirps / payload) as
          a dechirped-bin timeline — what the frame synchroniser sees.
Figure 4: a same-SF collision before and after the SIC receiver peels
          the frames in power order (the residual is the cancellation
          floor).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

from lora_phy_tpu.models import modem, stream, sync  # noqa: E402
from lora_phy_tpu.ops import planar  # noqa: E402
from lora_phy_tpu.utils.params import LoraParams  # noqa: E402


def main(outdir: str | None = None) -> int:
    out = pathlib.Path(outdir or pathlib.Path(__file__).parent)
    out.mkdir(parents=True, exist_ok=True)
    sf = 8
    p = LoraParams(sf=sf)
    n = p.n
    syms = np.array([0, 0, 50, 100, 200], np.int32)

    # --- figure 1: raw chirps -------------------------------------------
    re, im = planar.modulate_planar(syms, p)
    re, im = np.asarray(re), np.asarray(im)
    body = (re + 1j * im)[2 * p.step:]          # drop the 2 sync symbols
    inst_freq = np.angle(body[1:] * np.conj(body[:-1]))

    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(16, 6))
    ax0.set_title(f"Raw modulated I and Q: SF={sf}, symbols={syms.tolist()}")
    ax0.plot(body.real, lw=0.6, label="I")
    ax0.plot(body.imag, lw=0.6, label="Q")
    ax0.set_xlim(0, body.size)
    ax0.grid(True)
    ax0.legend(loc="upper right")
    ax1.set_title("Instantaneous frequency (FM demod): each symbol offsets "
                  "the sweep start; the ramp wraps at the band edge")
    ax1.plot(inst_freq, lw=0.6)
    for k in range(len(syms)):
        ax1.axvline(k * p.step, color="k", lw=0.5, alpha=0.4)
    ax1.set_xlim(0, inst_freq.size)
    ax1.grid(True)
    fig.tight_layout()
    fig.savefig(out / "modulation_explained_1_chirps.png", dpi=100)
    plt.close(fig)

    # --- figure 2: dechirp + spectra ------------------------------------
    dr, di = planar.dechirp_planar(re[..., 2 * p.step:], im[..., 2 * p.step:], p)
    dech = np.asarray(dr) + 1j * np.asarray(di)
    mr = np.asarray(dr).reshape(len(syms), n)
    mi = np.asarray(di).reshape(len(syms), n)
    mag2 = np.asarray(planar.dft_mag2_planar(mr, mi, n))

    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(16, 6))
    ax0.set_title("Dechirped symbols: every chirp collapses to a constant "
                  "tone at its symbol frequency")
    freq = np.angle(dech[1:] * np.conj(dech[:-1]))
    ax0.plot(freq, lw=0.6)
    for k in range(len(syms)):
        ax0.axvline(k * p.step, color="k", lw=0.5, alpha=0.4)
    ax0.set_xlim(0, freq.size)
    ax0.grid(True)
    ax1.set_title("|DFT|$^2$ per symbol window (DFT-matmul): the peak "
                  "bin IS the symbol value")
    for k, s in enumerate(syms):
        ax1.plot(mag2[k] / mag2[k].max() + 1.1 * k, lw=0.7,
                 label=f"sym {int(s)}")
        ax1.annotate(str(int(s)), (int(s), 1.1 * k + 1.0), fontsize=8)
    ax1.set_xlim(0, n)
    ax1.grid(True)
    fig.tight_layout()
    fig.savefig(out / "modulation_explained_2_dechirp.png", dpi=100)
    plt.close(fig)

    # --- figure 3: a full frame through the synchroniser's eyes ---------
    payload = np.frombuffer(b"LoRa!", np.uint8)
    frame = np.asarray(stream.frame_modulate(
        np.asarray(modem.encode(payload), np.int32), p))
    sig = np.zeros(3 * p.step + frame.size + 3 * p.step, np.complex64)
    sig[3 * p.step: 3 * p.step + frame.size] = frame
    sre, sim = planar.split_complex(sig)
    scan = sync.frame_sync_scan_planar(sre, sim, p)
    up = np.asarray(scan.up_bins)
    dn = np.asarray(scan.dn_bins)
    w = np.arange(up.size)

    fig, ax = plt.subplots(figsize=(16, 4))
    ax.set_title("Frame timeline, dechirped argmax bin per window: the "
                 "constant run is the preamble, the jump pair the sync "
                 "word, the mirrored section the 2.25 downchirps, then "
                 "payload symbols")
    ax.step(w, up, where="mid", label="up-dechirp bin")
    ax.step(w, dn, where="mid", alpha=0.6, label="down-dechirp bin")
    hit = np.flatnonzero(np.asarray(scan.valid))
    if hit.size:
        ax.axvline(int(hit[0]), color="r", lw=1.0, ls="--",
                   label="sync candidate (run end)")
    ax.set_xlabel("symbol window")
    ax.set_ylabel("argmax bin")
    ax.grid(True)
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(out / "modulation_explained_3_frame.png", dpi=100)
    plt.close(fig)

    # --- figure 4: a same-SF collision, before and after SIC peeling ----
    from lora_phy_tpu.models import sic

    pay_a = np.frombuffer(b"STRONG", np.uint8)
    pay_b = np.frombuffer(b"weak..", np.uint8)
    fa = np.asarray(stream.frame_modulate(
        np.asarray(modem.encode(pay_a), np.int32), p))
    fb = 0.3 * np.asarray(stream.frame_modulate(
        np.asarray(modem.encode(pay_b), np.int32), p))
    off_a, off_b = 2 * p.step, 7 * p.step
    coll = np.zeros(off_b + fb.size + 5 * p.step, np.complex64)
    coll[off_a: off_a + fa.size] += fa.astype(np.complex64)
    coll[off_b: off_b + fb.size] += fb.astype(np.complex64)
    cr_, ci_ = planar.split_complex(coll)
    frames, (resr, resi) = sic.receive_sic_planar(cr_, ci_, p,
                                                  pay_a.size * 2)
    resid = np.abs(np.asarray(resr) + 1j * np.asarray(resi))

    fig, (ax0, ax1) = plt.subplots(2, 1, figsize=(16, 6), sharex=True)
    ax0.set_title("Same-SF collision (|x|): the -10 dB frame hides under "
                  "the strong one — a plain receiver never syncs on it")
    ax0.plot(np.abs(coll), lw=0.4)
    for off, lbl in ((off_a, "strong start"), (off_b, "weak start")):
        ax0.axvline(off, color="r" if off == off_a else "g", ls="--",
                    lw=1.0, label=lbl)
    ax0.legend(loc="upper right")
    ax0.grid(True)
    decoded = [bytes(np.asarray(modem.decode(f["symbols"]))).decode(
        errors="replace") for f in frames]
    ax1.set_title("Residual after SIC peeled "
                  f"{decoded!r} in power order: what remains is the "
                  "cancellation floor")
    ax1.plot(resid, lw=0.4)
    ax1.set_ylim(0, 1.4)
    ax1.grid(True)
    fig.tight_layout()
    fig.savefig(out / "modulation_explained_4_sic.png", dpi=100)
    plt.close(fig)

    print(f"wrote 4 figures to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1] if len(sys.argv) > 1 else None))
