"""Tracing / roofline accounting.

The reference's observability is rdtsc cycle counting around the packet
loop (reference: tests/performance_test.cpp:103-133). The equivalents
here (SURVEY.md §5.1):

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-readable trace directory;
* :func:`demod_roofline` — analytic FLOP/byte accounting for the
  dechirp-detection pipeline, reporting the compute- and bandwidth-bound
  time floors and the attained fraction for a measured runtime.
"""

from __future__ import annotations

import contextlib
import dataclasses

from .params import LoraParams


@contextlib.contextmanager
def trace(log_dir: str):
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes: float
    t_compute_s: float
    t_memory_s: float
    bound: str

    def attained(self, measured_s: float) -> float:
        """Fraction of the speed-of-light floor achieved."""
        return max(self.t_compute_s, self.t_memory_s) / measured_s


# Published peaks, keyed by ``jax.Device.device_kind``. Source: NVIDIA
# H100 Tensor Core GPU data sheet, SXM part, at the full 700 W power limit
# (a card set below it cannot hold its top clock under load, so state its
# power limit beside any share). The demod's dots run at
# ``Precision.HIGHEST`` (float32 outside the tensor cores), so
# ``f32_flops`` is their compute roof.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; an unknown device is an error,
    never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add them "
            "to utils/profiling.PEAKS with their source") from None


def demod_roofline(params: LoraParams, n_symbols: int,
                   device_kind: str) -> Roofline:
    """Speed-of-light floors for demodulating ``n_symbols`` symbol windows.

    Counts the fused pipeline's intrinsic work: planar DFT as real matmuls
    (8*N per output point after splitting into <=128-wide stages), the
    derotation transcendentals, and the unavoidable HBM traffic (planar
    input in, one int per symbol out).
    """
    n = params.n
    if n <= 128:
        mm_flops = 8.0 * n * n          # 4 matmuls, 2 flops/MAC
    else:
        from ..ops.planar import _split

        n1, n2 = _split(n)              # the REAL four-step factorisation
        mm_flops = 8.0 * n * (n1 + n2)
    flops = n_symbols * (mm_flops + 10.0 * n)     # + derot/mag/argmax
    bytes_ = n_symbols * (n * 8.0 + 4.0)          # planar in + bin out
    peaks = device_peaks(device_kind)
    t_c = flops / peaks["f32_flops"]
    t_m = bytes_ / peaks["hbm_bytes_per_s"]
    return Roofline(flops, bytes_, t_c, t_m,
                    "compute" if t_c > t_m else "memory")
