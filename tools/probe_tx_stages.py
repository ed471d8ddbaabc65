#!/usr/bin/env python3
"""Split bench.py's tx_step into its stages on chip: payload tile,
modem.encode (coding-layer LUT gathers), and the planar modulator
(now the pure-gather table emitter) — each timed as its own jit with a
cumulative-prefix checksum so XLA cannot dead-code the stage under
test. Each stage is timed over 24 calls.

Usage: python tools/probe_tx_stages.py
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> None:
    import jax
    import jax.numpy as jnp

    from lora_phy_tpu.models import modem
    from lora_phy_tpu.ops import planar
    from lora_phy_tpu.utils.params import LoraParams

    params = LoraParams(sf=7)
    payload_len = 32
    channels, frames = 8, 8192
    pool = 64
    reps = (channels * frames) // pool
    dev = jax.devices()[0]
    rng = np.random.RandomState(0)
    payloads = rng.randint(0, 256, (pool, payload_len)).astype(np.uint8)
    pool_d = jax.device_put(payloads, dev)
    np.asarray(jnp.zeros(4) + 1.0)

    def cksum(*outs):
        acc = jnp.float32(0)
        for o in jax.tree_util.tree_leaves(outs):
            acc = acc + jnp.sum(o.astype(jnp.float32)[..., :1])
        return acc

    def build(pl, upto):
        full = jnp.tile(pl, (reps, 1)).reshape(channels, frames, payload_len)
        if upto == "tile":
            return full
        syms = modem.encode(full)
        if upto == "encode":
            return syms
        return planar.modulate_planar(syms, params)

    iters = 24
    prev = 0.0
    print(f"{'prefix':>10} {'ms':>9} {'delta ms':>9}")
    for name in ("tile", "encode", "modulate"):
        f = jax.jit(lambda p_, u=name: cksum(build(p_, u)))
        out = f(pool_d)
        np.asarray(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(pool_d)
        np.asarray(out)
        dt = (time.perf_counter() - t0) / iters * 1e3
        print(f"{name:>10} {dt:9.2f} {dt - prev:9.2f}", flush=True)
        prev = dt


if __name__ == "__main__":
    main()
