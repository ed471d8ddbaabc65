"""Profile-matrix performance harness.

Equivalent of the reference's ``tests/performance_test.cpp``: a
1000-packet modulate -> dechirp -> demodulate loop per profile, writing
``logs/performance_<RUN_ID>.csv`` with the same schema (the rdtsc
cycles-per-symbol column becomes wall-clock ``us_per_symbol``).
``RUN_ID`` comes from the environment like the reference
(performance_test.cpp:67-69); gate regressions with
``runners/compare_perf.py``.
"""

from __future__ import annotations

import os
import pathlib
import sys
import time

import numpy as np

from ..models import modem
from ..ops import planar
from ..utils.params import LoraParams
from ..utils.compile_cache import enable_compile_cache
from ..utils.profiles import DEFAULT_PROFILES, load_profiles
from ._cli import parse_flags


def run_profile(params: LoraParams, packets: int, payload_len: int = 32):
    """Batched equivalent of the reference's packet loop: all packets ride
    one device batch; returns (pps, us_per_symbol)."""
    import jax

    # bound the on-device batch (~280M samples: raw TX + dechirped planes
    # + demod workspace at SF12)
    frame_samples = (payload_len * 2 + 2) * params.step
    cap = max(64, int(2.8e8 // frame_samples))
    if packets > cap:
        print(f"  [capping {packets} -> {cap} packets for N={params.n}]",
              file=sys.stderr)
        packets = cap
    rng = np.random.RandomState(0)
    payloads = rng.randint(0, 256, (packets, payload_len)).astype(np.uint8)
    # the whole chain is planar float32 and generates on-device
    dev = jax.devices()[0]

    @jax.jit
    def gen(pl):
        syms = modem.encode(pl)
        re, im = planar.modulate_planar(syms, params)
        return planar.dechirp_planar(re, im, params)

    xr_d, xi_d = gen(jax.device_put(payloads, dev))

    step = jax.jit(
        lambda r, i: planar.demodulate_planar(r, i, params).symbols
    )
    jax.block_until_ready(step(xr_d, xi_d))   # compile
    # sanity: demodulated bins must match the reference-faithful
    # expectation (bins scale by bw_scale at BW250/500 — docs/SEMANTICS.md)
    first = np.asarray(step(xr_d, xi_d)[:4])
    enc = np.asarray(modem.encode(payloads[:4]))
    scale = int(round(params.scale))
    expect = (enc.astype(np.int64) * scale) % params.n
    assert np.array_equal(first.astype(np.int64), expect), \
        "perf harness demod mismatch"
    if scale == 1:
        decoded = np.asarray(modem.decode(first))
        assert np.array_equal(decoded, payloads[:4])
    iters = 24
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step(xr_d, xi_d)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    dt = best

    n_sym = payload_len * 2 + 2
    pps = packets / dt
    us_per_symbol = dt * 1e6 / (packets * n_sym)
    return pps, us_per_symbol


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "profiles": (str, ""),
        "packets": (int, 1000),
        "payload-bytes": (int, 32),
        "out-dir": (str, "logs"),
    })
    profiles = (
        load_profiles(flags["profiles"]) if flags["profiles"] else DEFAULT_PROFILES
    )
    run_id = os.environ.get("RUN_ID", "run")
    out_dir = pathlib.Path(flags["out-dir"])
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"performance_{run_id}.csv"

    rows = ["run_id,profile,sf,N,pps,us_per_symbol"]
    for p in profiles:
        params = p.params()
        pps, usps = run_profile(params, flags["packets"], flags["payload-bytes"])
        rows.append(
            f"{run_id},{p.name},{p.sf},{1 << p.sf},{pps:.3f},{usps:.3f}"
        )
        print(rows[-1], file=sys.stderr)
    out.write_text("\n".join(rows) + "\n")
    print(f"wrote {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
