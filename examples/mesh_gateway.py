#!/usr/bin/env python3
"""A resumable multi-channel gateway on a device mesh.

The flagship deployment shape: a ``(channel, time)`` mesh receives a
continuous multi-channel IQ stream block by block — every block rides
ONE sharded program (scan + seam halos + demod), the host carries only a
fixed-length tail — and the whole receiver checkpoints to a file at any
block boundary and resumes bit-exactly (frames straddling the
checkpoint boundary included).

Runs on 8 virtual CPU devices (the script sets
XLA_FLAGS=--xla_force_host_platform_device_count=8 and pins the CPU);
drop the pin and the same code shards over the GPUs of one host.
"""

import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import jax

# virtual-mesh demo: pin the CPU (delete this line to run on GPUs)
jax.config.update("jax_platforms", "cpu")

import numpy as np

from lora_phy_tpu.models import modem, stream
from lora_phy_tpu.parallel import mesh as meshlib
from lora_phy_tpu.parallel.stream import (
    MeshStreamDemodulator,
    load_mesh_state,
    save_mesh_state,
)
from lora_phy_tpu.utils.params import LoraParams


def main():
    p = LoraParams(sf=7)
    n_channels = 2
    devs = jax.devices()[:4]
    m = meshlib.make_mesh(n_channel=n_channels, n_time=2, devices=devs)
    rx = MeshStreamDemodulator(p, n_payload_symbols=8, mesh=m, max_frames=2)

    # --- synthesize a 3-block stream with frames at arbitrary positions,
    # one straddling every block boundary --------------------------------
    B = 16384
    n_blocks = 3
    frame_len = stream.frame_overhead_samples(p) + 8 * p.step
    rng = np.random.RandomState(0)
    xr = np.zeros((n_channels, n_blocks * B), np.float32)
    xi = np.zeros((n_channels, n_blocks * B), np.float32)
    placed = {}
    for c in range(n_channels):
        starts = [4000 + 57 * c + b * B for b in range(n_blocks)]
        starts += [b * B - frame_len // 2 + 31 * c for b in range(1, n_blocks)]
        for s in starts:
            pl = rng.randint(0, 256, 4).astype(np.uint8)
            fr, fi = stream.frame_modulate_planar(
                np.asarray(modem.encode(pl), np.int32), p)
            xr[c, s: s + frame_len] = np.asarray(fr)
            xi[c, s: s + frame_len] = np.asarray(fi)
            placed[(c, s)] = pl

    # --- feed blocks; checkpoint+restart between blocks 1 and 2 ---------
    ckpt = os.path.join(tempfile.mkdtemp(), "gateway.ckpt")
    state = rx.init_state(n_channels)
    recovered = {}
    for b in range(n_blocks):
        if b == 2:
            save_mesh_state(state, ckpt)
            print(f"[block {b}] checkpointed to {ckpt}; simulating restart")
            rx = MeshStreamDemodulator(p, 8, m, max_frames=2)  # fresh process
            state = load_mesh_state(ckpt)
        state, frames = rx.process(
            state, xr[:, b * B: (b + 1) * B], xi[:, b * B: (b + 1) * B])
        for f in frames:
            payload = np.asarray(modem.decode(
                np.array(f["symbols"], np.uint16)))
            recovered[(f["channel"], f["start"])] = payload
            print(f"[block {b}] ch{f['channel']} @{f['start']}: "
                  f"{payload.tobytes().hex()} snr={f['snr_db']:.1f} dB")

    assert set(recovered) == set(placed), "frame set mismatch"
    for key, pl in placed.items():
        assert np.array_equal(recovered[key], pl), key
    print(f"all {len(placed)} frames recovered exactly once "
          f"({rx.t_size} time shards, {n_channels} channels, "
          "checkpoint/restart mid-stream)")


if __name__ == "__main__":
    main()
