"""lora_phy_tpu — a LoRa physical-layer modem framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
reference C++ library (yakir1991/LoRa-SDR-Lightweight-Standalone-Library-):
chirp modulation/demodulation, Gray coding, diagonal interleaving,
Hamming FEC, whitening, PHY CRC, sync-word handling, CFO/timing
estimation — expressed as pure functions over batched arrays, jit/pjit
everywhere, with a planar (split re/im float32) dechirp-DFT-argmax hot
path and mesh-sharded multi-channel / streaming demodulation. Its
deployment target is an NVIDIA GPU (``python chip_smoke.py``).

Layout:
  ops/       numeric primitives (coding, chirp, detection, impairments)
  models/    modem chains (simple modem, full coded chain, streaming receiver)
  parallel/  device-mesh sharding, halo exchange for time-sharded streams
  utils/     params, profiles, IQ file IO, vector manifests
  runners/   CLI programs mirroring the reference's runners
"""

__version__ = "0.1.0"

from .utils.params import (  # noqa: F401
    Bandwidth,
    Window,
    LoraParams,
    LoraMetrics,
    bw_scale,
)
