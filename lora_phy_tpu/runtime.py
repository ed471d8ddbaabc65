"""ctypes binding for the native C++ runtime (runtime/lora_runtime.cpp).

The native layer owns high-rate ingest work the device shouldn't: sample
format conversion (cf32/ci16/ci8 interleaved -> planar float32), a
zero-steady-state-allocation overlap-save ring, and direct file ingest —
producing planar batches ready for ``jax.device_put``. Builds the shared
library on first use if it is missing (g++, no external deps).
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_RUNTIME_DIR = pathlib.Path(__file__).resolve().parents[1] / "runtime"
_LIB_PATH = _RUNTIME_DIR / "liblora_runtime.so"

FORMAT_CF32 = 0
FORMAT_CI16 = 1
FORMAT_CI8 = 2


def _build() -> pathlib.Path:
    subprocess.run(["make", "-s", "-C", str(_RUNTIME_DIR)], check=True)
    return _LIB_PATH


def _load() -> ctypes.CDLL:
    src = _RUNTIME_DIR / "lora_runtime.cpp"
    if not _LIB_PATH.exists() or (
        src.exists() and src.stat().st_mtime > _LIB_PATH.stat().st_mtime
    ):
        _build()
    lib = ctypes.CDLL(str(_LIB_PATH))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.lora_rt_cf32_to_planar.argtypes = [f32p, ctypes.c_size_t, f32p, f32p]
    lib.lora_rt_ci16_to_planar.argtypes = [
        ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t, ctypes.c_float, f32p, f32p,
    ]
    lib.lora_rt_ci8_to_planar.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_size_t, ctypes.c_float, f32p, f32p,
    ]
    lib.lora_rt_planar_to_cf32.argtypes = [f32p, f32p, ctypes.c_size_t, f32p]
    lib.lora_rt_ring_create.restype = ctypes.c_void_p
    lib.lora_rt_ring_create.argtypes = [ctypes.c_size_t] * 3
    lib.lora_rt_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.lora_rt_ring_space.restype = ctypes.c_size_t
    lib.lora_rt_ring_space.argtypes = [ctypes.c_void_p]
    lib.lora_rt_ring_push.restype = ctypes.c_size_t
    lib.lora_rt_ring_push.argtypes = [ctypes.c_void_p, f32p, f32p, ctypes.c_size_t]
    lib.lora_rt_ring_ready.restype = ctypes.c_size_t
    lib.lora_rt_ring_ready.argtypes = [ctypes.c_void_p]
    lib.lora_rt_ring_pop_block.restype = ctypes.c_int
    lib.lora_rt_ring_pop_block.argtypes = [ctypes.c_void_p, f32p, f32p]
    lib.lora_rt_ring_position.restype = ctypes.c_uint64
    lib.lora_rt_ring_position.argtypes = [ctypes.c_void_p]
    lib.lora_rt_read_iq_file.restype = ctypes.c_long
    lib.lora_rt_read_iq_file.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.c_float, f32p, f32p,
    ]
    return lib


_lib = None


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load()
    return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def to_planar(interleaved: np.ndarray, scale: float = 1.0):
    """Interleaved IQ (float32 pairs / int16 / int8) -> (re, im) float32."""
    x = np.ascontiguousarray(interleaved)
    n = x.size // 2
    re = np.empty(n, np.float32)
    im = np.empty(n, np.float32)
    if x.dtype == np.float32:
        lib().lora_rt_cf32_to_planar(_fp(x), n, _fp(re), _fp(im))
    elif x.dtype == np.int16:
        lib().lora_rt_ci16_to_planar(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n,
            ctypes.c_float(scale), _fp(re), _fp(im),
        )
    elif x.dtype == np.int8:
        lib().lora_rt_ci8_to_planar(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), n,
            ctypes.c_float(scale), _fp(re), _fp(im),
        )
    else:
        raise TypeError(f"unsupported dtype {x.dtype}")
    return re, im


def from_planar(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    re = np.ascontiguousarray(re, np.float32)
    im = np.ascontiguousarray(im, np.float32)
    out = np.empty(re.size * 2, np.float32)
    lib().lora_rt_planar_to_cf32(_fp(re), _fp(im), re.size, _fp(out))
    return out


def read_iq_file(path, offset_samples=0, n_samples=-1, fmt=FORMAT_CF32,
                 scale: float = 1.0):
    """Read an IQ file straight into planar float32 arrays."""
    path = pathlib.Path(path)
    if n_samples < 0:
        unit = {FORMAT_CF32: 8, FORMAT_CI16: 4, FORMAT_CI8: 2}[fmt]
        n_samples = max(0, path.stat().st_size // unit - offset_samples)
    re = np.empty(n_samples, np.float32)
    im = np.empty(n_samples, np.float32)
    got = lib().lora_rt_read_iq_file(
        str(path).encode(), offset_samples, n_samples, fmt,
        ctypes.c_float(scale), _fp(re), _fp(im),
    )
    if got < 0:
        raise IOError(f"failed to read {path}")
    return re[:got], im[:got]


class OverlapSaveRing:
    """SPSC overlap-save ring over the native implementation: push planar
    samples, pop fixed blocks prefixed with a halo of the previous block —
    the host-side feeder for the time-sharded streaming demodulator."""

    def __init__(self, capacity: int, block: int, halo: int):
        self._handle = lib().lora_rt_ring_create(capacity, block, halo)
        if not self._handle:
            raise ValueError("invalid ring configuration")
        self.block = block
        self.halo = halo
        self._out_re = np.empty(halo + block, np.float32)
        self._out_im = np.empty(halo + block, np.float32)

    def push(self, re: np.ndarray, im: np.ndarray) -> int:
        re = np.ascontiguousarray(re, np.float32)
        im = np.ascontiguousarray(im, np.float32)
        if re.size != im.size:   # the native loop reads im[i] for i < count
            raise ValueError(f"plane length mismatch: {re.size} vs {im.size}")
        return lib().lora_rt_ring_push(self._handle, _fp(re), _fp(im), re.size)

    @property
    def ready(self) -> int:
        return lib().lora_rt_ring_ready(self._handle)

    @property
    def space(self) -> int:
        return lib().lora_rt_ring_space(self._handle)

    @property
    def position(self) -> int:
        return int(lib().lora_rt_ring_position(self._handle))

    def pop_block(self):
        """Returns (re, im) of length halo+block (copies), or None."""
        ok = lib().lora_rt_ring_pop_block(
            self._handle, _fp(self._out_re), _fp(self._out_im)
        )
        if not ok:
            return None
        return self._out_re.copy(), self._out_im.copy()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle and _lib is not None:
            _lib.lora_rt_ring_destroy(handle)
