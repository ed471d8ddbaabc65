"""Pass-by-pass audit of the demod's device-memory traffic at the BENCH
shape: compile-only HLO dumps + memory analysis on the default device,
one process, everything saved under chiprun_out/probe_demod_hlo/.

    python tools/probe_demod_hlo.py [--timed]

Dumps, per variant (sf7 f32 / sf7 bf16 / sf12):
  <out>/<name>.hlo.txt      compiled entry HLO
  <out>/<name>.bufs.txt     entry ops with >= 256 MB outputs
  <out>/summary.json        memory_analysis + (with --timed) ms

The bench-shape batch is 8 x 8192 frames x 66 sym x 128 = 554M samples
(2.216 GB per plane). Compile-only by default (nothing is allocated).
"""

import json
import pathlib
import re
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

OUT = pathlib.Path("chiprun_out/probe_demod_hlo")
OUT.mkdir(parents=True, exist_ok=True)


def log(m):
    print(m, file=sys.stderr, flush=True)


_SHAPE_RE = re.compile(r"(f32|bf16|s32|u16|pred|u8)\[([0-9,]*)\]")


def _buf_report(hlo: str, floor_mb: float = 256.0):
    """Entry-computation ops whose OUTPUT shape is >= floor_mb, from the
    compiled HLO text (layout-annotated)."""
    rows = []
    in_entry = False
    for line in hlo.splitlines():
        if line.startswith("ENTRY"):
            in_entry = True
        elif in_entry and line.startswith("}"):
            in_entry = False
        if not in_entry:
            continue
        s = line.strip()
        m = _SHAPE_RE.search(s.split("=")[1]) if "=" in s else None
        if not m:
            continue
        dtype, dims = m.groups()
        if not dims:
            continue
        n = 1
        for d in dims.split(","):
            n *= int(d)
        bsz = {"f32": 4, "s32": 4, "bf16": 2, "u16": 2, "pred": 1,
               "u8": 1}[dtype]
        mb = n * bsz / 2**20
        if mb >= floor_mb:
            op = s.split("=")[1].strip().split("(")[0]
            name = s.split("=")[0].strip()
            rows.append((mb, name[:60], op[:80]))
    rows.sort(reverse=True)
    return rows


def main():
    log(f"platform {jax.default_backend()} devices {jax.devices()}")

    from lora_phy_tpu.ops import planar
    from lora_phy_tpu.utils.params import LoraParams

    timed = "--timed" in sys.argv[1:]
    summary = {}

    channels, frames = 8, 8192
    p7 = LoraParams(sf=7)
    n_sym = 66
    spec7 = jax.ShapeDtypeStruct((channels, frames, n_sym * p7.step),
                                 jnp.float32)

    def demod_f32(r, i):
        res = planar.demodulate_planar(r, i, p7)
        return res.symbols, res.sync_word

    def demod_bf16(r, i):
        res = planar.demodulate_planar(r, i, p7, precision="bf16")
        return res.symbols, res.sync_word

    p12 = LoraParams(sf=12)
    spec12 = jax.ShapeDtypeStruct((1024, 66 * p12.step), jnp.float32)

    def demod12(r, i):
        return planar.demodulate_planar(r, i, p12).symbols

    variants = [
        ("demod_sf7_f32", demod_f32, (spec7, spec7)),
        ("demod_sf7_bf16", demod_bf16, (spec7, spec7)),
        ("demod_sf12_f32", demod12, (spec12, spec12)),
    ]

    for name, fn, specs in variants:
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*specs).compile()
        dt = time.perf_counter() - t0
        hlo = compiled.as_text()
        (OUT / f"{name}.hlo.txt").write_text(hlo)
        bufs = _buf_report(hlo)
        (OUT / f"{name}.bufs.txt").write_text(
            "\n".join(f"{mb:9.1f} MB  {nm}  {op}" for mb, nm, op in bufs)
            + "\n")
        ma = compiled.memory_analysis()
        entry = {
            "compile_s": round(dt, 1),
            "arg_bytes": getattr(ma, "argument_size_in_bytes", None),
            "out_bytes": getattr(ma, "output_size_in_bytes", None),
            "temp_bytes": getattr(ma, "temp_size_in_bytes", None),
            "n_big_bufs": len(bufs),
            "big_buf_mb_total": round(sum(b[0] for b in bufs), 1),
        }
        summary[name] = entry
        log(f"{name}: compile {dt:.1f}s, temp "
            f"{(entry['temp_bytes'] or 0)/2**30:.2f} GiB, "
            f"{len(bufs)} ops >= 256 MB "
            f"({entry['big_buf_mb_total']:.0f} MB total)")

    if timed:
        # one timed reference point for the f32 path (matches bench)
        pool = 64
        rng = np.random.RandomState(0)
        payloads = rng.randint(0, 256, (pool, 32)).astype(np.uint8)
        from lora_phy_tpu.models import modem

        reps = channels * frames // pool

        @jax.jit
        def make(pl):
            full = jnp.tile(pl, (reps, 1)).reshape(channels, frames, 32)
            syms = modem.encode(full)
            r, i = planar.modulate_planar(syms, p7)
            return planar.dechirp_planar(r, i, p7)

        xr, xi = make(jax.device_put(payloads, jax.devices()[0]))
        f = jax.jit(demod_f32)
        jax.block_until_ready(f(xr, xi))
        iters = 24
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(xr, xi)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        sps = channels * frames * 66 * 128 / dt
        summary["timed_f32_ms"] = round(dt * 1e3, 2)
        summary["timed_f32_gsps"] = round(sps / 1e9, 3)
        log(f"timed f32: {dt*1e3:.1f} ms ({sps/1e9:.2f} Gsps)")

    (OUT / "summary.json").write_text(json.dumps(summary, indent=1) + "\n")
    log("done")


if __name__ == "__main__":
    main()
