"""Roofline evidence harness.

Measures on the current default device: fixed dispatch overhead, the
effective device-memory bandwidth (two-size-differenced elementwise
stream, which cancels the overhead), and the demod step time vs its
floors at SF7 and SF12 against the device's published peaks
(utils/profiling.PEAKS, keyed by ``device_kind``; an unknown device is an
error). The reference has no such harness; its observability is rdtsc
cycle counting (tests/performance_test.cpp:103-133).

  python -m lora_phy_tpu.runners.roofline [--channels=8] [--frames=8192]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ..models import modem
from ..ops import planar
from ..utils.params import LoraParams
from ..utils.compile_cache import enable_compile_cache
from ..utils.profiling import demod_roofline, device_peaks
from ._cli import parse_flags


def _timeit(fn, iters):
    """Mean seconds per call of ``fn`` (which returns device arrays),
    completion-bounded by ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def measure_dispatch_overhead(dev) -> float:
    import jax

    tiny = jax.device_put(np.zeros(2, np.float32), dev)
    f = jax.jit(lambda a: a + 1.0)
    return _timeit(lambda: f(tiny), 16)


def measure_bandwidth(dev) -> float:
    """Effective device-memory r+w bandwidth, overhead-cancelled by
    differencing two large sizes (median of repeated paired
    measurements)."""
    import jax

    sizes = [2**27, 2**29]                       # 512 MiB / 2 GiB f32
    arrays = [jax.device_put(np.zeros(nsz, np.float32), dev)
              for nsz in sizes]
    f = jax.jit(lambda x: x * 1.0000001 + 0.5)

    def one_round():
        ts = [_timeit(lambda a=a: f(a), 8) for a in arrays]
        return ts[1] - ts[0]

    dt = float(np.median([one_round() for _ in range(3)]))
    for a in arrays:
        a.delete()
    return 2 * (sizes[1] - sizes[0]) * 4 / dt


def measure_demod(params: LoraParams, n_frames: int, channels: int,
                  payload_len: int = 32):
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    pool = min(64, n_frames * channels)
    rng = np.random.RandomState(0)
    payloads = rng.randint(0, 256, (pool, payload_len)).astype(np.uint8)
    reps = -(-(channels * n_frames) // pool)       # ceil: any frame count

    @jax.jit
    def gen(pl):
        full = jnp.tile(pl, (reps, 1))[: channels * n_frames].reshape(
            channels, n_frames, payload_len)
        syms = modem.encode(full)
        r, i = planar.modulate_planar(syms, params)
        return planar.dechirp_planar(r, i, params)

    xr, xi = gen(jax.device_put(payloads, dev))

    f = jax.jit(lambda r, i: planar.demodulate_planar(r, i, params).symbols)
    dt = _timeit(lambda: f(xr, xi), 6)
    total = channels * n_frames * (payload_len * 2 + 2) * params.step
    xr.delete()
    xi.delete()
    return dt, total


def main(argv=None) -> int:
    enable_compile_cache()
    import jax

    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "channels": (int, 8),
        "frames": (int, 8192),
    })
    dev = jax.devices()[0]
    peaks = device_peaks(dev.device_kind)
    print(f"device: {dev} ({dev.device_kind})", file=sys.stderr)

    overhead = measure_dispatch_overhead(dev)
    bw = measure_bandwidth(dev)
    print(f"dispatch overhead: {overhead*1e3:.1f} ms")
    print(f"effective memory bandwidth (r+w, overhead-cancelled): "
          f"{bw/1e9:.0f} GB/s "
          f"({bw / peaks['hbm_bytes_per_s']:.0%} of the published peak)")

    # SF12 frames are 32x larger; keep the batch inside device memory
    for sf, channels, frames in (
        (7, flags["channels"], flags["frames"]),
        (12, 1, max(64, flags["frames"] // 8)),
    ):
        p = LoraParams(sf=sf)
        dt, total = measure_demod(p, frames, channels)
        in_bytes = total * 8.0                      # planar f32 planes
        t_mem_intrinsic = in_bytes / bw
        implied_traffic = dt * bw
        r = demod_roofline(p, total // p.n, device_kind=dev.device_kind)
        print(
            f"SF{sf}: measured {dt*1e3:.1f} ms ({total/dt/1e9:.2f} Gsps) | "
            f"published-peak floor {max(r.t_compute_s, r.t_memory_s)*1e3:.1f}"
            f" ms ({r.bound}-bound, {r.attained(dt):.1%} of roofline) | "
            f"intrinsic-traffic floor {t_mem_intrinsic*1e3:.1f} ms | "
            f"implied real traffic {implied_traffic/2**30:.0f} GiB "
            f"(~{implied_traffic/in_bytes:.0f} passes)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
