"""Regenerate logs/sync_sensitivity_r5.csv: streaming-receiver sync +
decode rate vs SNR (the full path: scan through block demod — the
reference's AWGN tests assume frame-aligned buffers and never exercise
sync).

    python tools/sync_sensitivity_sweep.py [--trials=500] [--out=PATH]
           [--robust] [--soft] [--chunk=128]

Trials ride the receiver's leading batch dim (one device call per chunk
of noisy copies), so 500+ trials/point is cheap — it is the same
program the bench times. Runs on JAX's default device. Every rate column carries a 95% Wilson
binomial interval (``*_lo``/``*_hi``).

Default CSV: ``sf,snr_db,trials,synced,decoded,ml,<CIs>`` — the simple
Hamming84 chain decoded BOTH ways per synced frame on identical noise:
hard argmax+syndrome (``decoded``) and constrained-argmax ML detection
from the receiver's spectra (``ml``, soft.hamming84_ml_decode).
``--soft`` sweeps CODED frames (CR4/8 + CRC) and decodes each synced
frame BOTH ways — hard syndrome and soft ML correlation from the
receiver's ``with_spectra`` spectra — so the committed curve shows the
soft path's knee: ``sf,snr_db,trials,synced,hard,soft,<CIs>``.
``--robust`` sweeps pre_acc=3 instead (expect ~1 dB worse AWGN-only
knees — the signature carries preamble noise; docs/SEMANTICS.md).
"""

import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from lora_phy_tpu.models import coded, modem, soft as softmod  # noqa: E402
from lora_phy_tpu.models import stream, sync  # noqa: E402
from lora_phy_tpu.utils.params import LoraParams  # noqa: E402
from lora_phy_tpu.utils.stats import wilson  # noqa: E402


def _noisy_chunk(key, base_r, base_i, snr_db: float, b: int):
    """[b, T] noisy copies of the base planes, noise generated on-device
    (reference noise convention: sigma = 10**(-snr/20), per-component
    sigma/sqrt(2) — ops/impair.apply_awgn)."""
    sig = 10.0 ** (-snr_db / 20.0) / math.sqrt(2.0)
    kr, ki = jax.random.split(key)
    t = base_r.shape[-1]
    nr = jax.random.normal(kr, (b, t), jnp.float32) * jnp.float32(sig)
    ni = jax.random.normal(ki, (b, t), jnp.float32) * jnp.float32(sig)
    return base_r[None] + nr, base_i[None] + ni


_noisy_chunk_j = jax.jit(_noisy_chunk, static_argnames=("snr_db", "b"))


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    trials = 500
    out = "logs/sync_sensitivity_r5.csv"
    pre_acc = 1
    soft = False
    chunk = 128
    for a in args:
        if a.startswith("--trials="):
            trials = int(a.split("=", 1)[1])
        elif a.startswith("--out="):
            out = a.split("=", 1)[1]
        elif a.startswith("--chunk="):
            chunk = int(a.split("=", 1)[1])
        elif a == "--robust":
            pre_acc = 3
        elif a == "--soft":
            soft = True
        else:
            print(f"unknown flag {a}", file=sys.stderr)
            return 1

    if soft:
        head = ("sf,snr_db,trials,synced,hard,soft,synced_lo,synced_hi,"
                "hard_lo,hard_hi,soft_lo,soft_hi")
    else:
        # the default (simple-chain) sweep decodes each synced frame BOTH
        # ways on identical noise: hard argmax+syndrome and Hamming84 ML
        # detection from the receiver's spectra (soft.hamming84_ml_decode)
        head = ("sf,snr_db,trials,synced,decoded,ml,synced_lo,synced_hi,"
                "decoded_lo,decoded_hi,ml_lo,ml_hi")
    rows = [head]
    cfg_by_sf = {}
    for sf in (7, 9, 12):
        p = LoraParams(sf=sf)
        rng = np.random.RandomState(sf)
        pl = rng.randint(0, 256, 8).astype(np.uint8)
        if soft:
            cfg = coded.CodedConfig(sf=sf, cr=4, crc=True)
            cfg_by_sf[sf] = cfg
            nsym = coded.payload_symbol_count(pl.size, cfg)
            n_pay = 8 + nsym
            iq = np.asarray(stream.frame_encode(pl, cfg, p))
        else:
            n_pay = 16
            iq = np.asarray(stream.frame_modulate(
                np.asarray(modem.encode(pl), np.int32), p))
        off = 3 * p.step
        t_len = off + iq.size + 4 * p.step
        base_r = jnp.zeros(t_len, jnp.float32).at[off: off + iq.size].set(
            jnp.asarray(iq.real))
        base_i = jnp.zeros(t_len, jnp.float32).at[off: off + iq.size].set(
            jnp.asarray(iq.imag))
        for snr in (-3, -6, -9, -12, -15, -18):
            synced = n_hard = n_soft = 0
            done = 0
            ci = 0
            while done < trials:
                b = min(chunk, trials - done)
                key = jax.random.PRNGKey(sf * 1000003 + (snr + 64) * 911
                                         + ci)
                xr, xi = _noisy_chunk_j(key, base_r, base_i, float(snr), b)
                res = sync.receive_block_planar(
                    xr, xi, p, n_pay, max_frames=2, min_power_db=-30.0,
                    pre_acc=pre_acc, with_spectra=True)
                blk, spec = res
                found = np.asarray(blk.found)
                starts = np.asarray(blk.start)
                syms = np.asarray(blk.symbols)
                spec = np.asarray(spec)
                for t in range(b):
                    ks = [int(k) for k in np.flatnonzero(found[t])
                          if abs(int(starts[t, k]) - off) <= p.step]
                    if not ks:
                        continue
                    synced += 1
                    k = ks[0]
                    if soft:
                        cfg = cfg_by_sf[sf]
                        nsym = n_pay - 8
                        h_pay, h_ok, _ = coded.decode_payload(
                            syms[t, k, 8: 8 + nsym], pl.size, cfg)
                        if (np.asarray(h_pay).tobytes() == pl.tobytes()
                                and bool(np.all(np.asarray(h_ok)))):
                            n_hard += 1
                        s_pay, s_ok, _ = softmod.decode_payload_soft(
                            spec[t, k, 8: 8 + nsym], pl.size, cfg)
                        if (np.asarray(s_pay).tobytes() == pl.tobytes()
                                and bool(np.asarray(s_ok))):
                            n_soft += 1
                    else:
                        dec = np.asarray(modem.decode(syms[t, k]))
                        if np.array_equal(dec, pl):
                            n_hard += 1
                        ml = np.asarray(softmod.hamming84_ml_decode(
                            spec[t, k]))
                        if np.array_equal(ml, pl):
                            n_soft += 1
                done += b
                ci += 1
            s_lo, s_hi = wilson(synced, trials)
            h_lo, h_hi = wilson(n_hard, trials)
            so_lo, so_hi = wilson(n_soft, trials)
            rows.append(
                f"{sf},{snr},{trials},{synced},{n_hard},{n_soft},"
                f"{s_lo:.4f},{s_hi:.4f},{h_lo:.4f},{h_hi:.4f},"
                f"{so_lo:.4f},{so_hi:.4f}")
            print(rows[-1], file=sys.stderr, flush=True)
    pathlib.Path(out).write_text("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
