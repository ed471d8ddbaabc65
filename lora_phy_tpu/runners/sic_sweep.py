"""SIC collision-recovery sweep: weak-frame recovery rate vs power gap.

Monte-Carlo characterisation of the collision receiver (models/sic.py):
two same-SF frames with overlapping payloads, the weak one ``gap`` dB
under the strong one, AWGN at ``--snr`` dB relative to the strong frame
(the reference model's noise convention, tests/awgn_sweep.py:246). Each
trial decodes the block twice — plain single-pass receive and the SIC
loop — and scores exact weak-payload recovery. The CSV mirrors the AWGN
sweep's committed-log pattern (logs/):

    gap_db,trials,weak_plain,weak_sic,strong_sic + 95% Wilson interval
    columns for the two weak-recovery rates

Upstream has no counterpart (a collision simply loses the weaker frame);
this sweep quantifies what peeling buys at each power gap.

Flags: ``--sf`` ``--snr=DB`` ``--gaps=3,6,9,12,15`` ``--trials=N``
``--payload-len=BYTES`` ``--seed`` ``--out=CSV|-``
"""

from __future__ import annotations

import sys

import numpy as np

from ..utils.compile_cache import enable_compile_cache
from ._cli import parse_flags


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "sf": (int, 7),
        "snr": (float, 20.0),
        "gaps": (lambda v: [float(g) for g in v.split(",")], None),
        "trials": (int, 40),
        "payload-len": (int, 6),
        "seed": (int, 0),
        "out": (str, "-"),
    })
    gaps = flags["gaps"] or [3.0, 6.0, 9.0, 12.0, 15.0]

    import jax

    from ..models import modem, sic, stream, sync
    from ..ops.impair import apply_awgn
    from ..utils.params import LoraParams

    p = LoraParams(sf=flags["sf"])
    pl_len = flags["payload-len"]
    n_pay = pl_len * 2
    rng = np.random.RandomState(flags["seed"])
    off_a = 2 * p.step
    off_b = off_a + 5 * p.step                  # payloads overlap

    from ..utils.stats import wilson

    rows = ["gap_db,trials,weak_plain,weak_sic,strong_sic,"
            "plain_lo,plain_hi,sic_lo,sic_hi"]
    for gap in gaps:
        amp_b = 10.0 ** (-gap / 20.0)
        weak_plain = weak_sic = strong_sic = 0
        for t in range(flags["trials"]):
            pay_a = rng.randint(0, 256, pl_len).astype(np.uint8)
            pay_b = rng.randint(0, 256, pl_len).astype(np.uint8)
            fa = np.asarray(stream.frame_modulate(
                np.asarray(modem.encode(pay_a), np.int32), p))
            fb = amp_b * np.asarray(stream.frame_modulate(
                np.asarray(modem.encode(pay_b), np.int32), p))
            s = np.zeros(off_b + fb.size + 4 * p.step, np.complex64)
            s[off_a: off_a + fa.size] += fa.astype(np.complex64)
            s[off_b: off_b + fb.size] += fb.astype(np.complex64)
            y = np.asarray(apply_awgn(
                jax.random.PRNGKey(flags["seed"] * 100003 + t),
                s, flags["snr"]))
            re = y.real.astype(np.float32)
            im = y.imag.astype(np.float32)

            def hits(frames_iter):
                got_w = got_s = False
                for start, syms in frames_iter:
                    if abs(start - off_b) <= 2:
                        got_w |= np.array_equal(
                            np.asarray(modem.decode(syms)), pay_b)
                    if abs(start - off_a) <= 2:
                        got_s |= np.array_equal(
                            np.asarray(modem.decode(syms)), pay_a)
                return got_w, got_s

            blk = sync.receive_block_planar(re, im, p, n_pay,
                                            min_power_db=-30.0)
            w0, _ = hits((r["start"], r["symbols"])
                         for r in sync.block_rows(blk))
            frames, _ = sic.receive_sic_planar(re, im, p, n_pay)
            w1, s1 = hits((f["start"], f["symbols"]) for f in frames)
            weak_plain += w0
            weak_sic += w1
            strong_sic += s1
        p_lo, p_hi = wilson(weak_plain, flags["trials"])
        s_lo, s_hi = wilson(weak_sic, flags["trials"])
        rows.append(f"{gap:g},{flags['trials']},{weak_plain},"
                    f"{weak_sic},{strong_sic},"
                    f"{p_lo:.4f},{p_hi:.4f},{s_lo:.4f},{s_hi:.4f}")
        print(rows[-1], file=sys.stderr, flush=True)

    text = "\n".join(rows) + "\n"
    if flags["out"] in ("", "-"):
        sys.stdout.write(text)
    else:
        with open(flags["out"], "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
