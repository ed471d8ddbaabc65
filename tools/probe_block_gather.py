"""On-chip probe: the block receiver's window gather moves 48 CONSECUTIVE
step-rows per frame — 48 separate 512 B row slices per frame if spelled
as take_along_axis.  Because the rows are consecutive, the same data is
one contiguous ``nwin_g*step``-sample slab per frame; this probe times
the alternatives at the bench shape:

  g1  per-row take_along_axis            (the committed path)
  g2  one-slab gather (lax.gather, slice_sizes=(1, nwin_g*step))
  g3  one-slab via vmapped dynamic_slice (lowers to gather too; sanity)
  g4  two-row-pitch take_along (2*step rows, half the descriptors)
  e2e receive_block_planar current vs slab-patched (if g2 wins)

    python tools/probe_block_gather.py [--frames=512] [--iters=24]
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    import jax
    import jax.numpy as jnp

    from lora_phy_tpu.models import modem
    from lora_phy_tpu.models import stream as streammod
    from lora_phy_tpu.utils.params import LoraParams

    fpc, iters = 512, 24
    for a in sys.argv[1:]:
        if a.startswith("--frames="):
            fpc = int(a.split("=")[1])
        elif a.startswith("--iters="):
            iters = int(a.split("=")[1])

    params = LoraParams(sf=7)
    if jax.default_backend() == "cpu":
        fpc, iters = min(fpc, 8), 1
    channels, pl_len = 8, 16
    n_pay = pl_len * 2
    step = params.step
    gap = 4 * step
    overhead = streammod.frame_overhead_samples(params, 8)
    nwin_g = (overhead + n_pay * step) // step + 4
    rng = np.random.RandomState(0)
    pay_blk = rng.randint(0, 256, (channels, pl_len)).astype(np.uint8)
    dev = jax.devices()[0]

    @jax.jit
    def framed_stream(pl):
        syms = modem.encode(pl)
        fr, fi = streammod.frame_modulate_planar(syms, params)
        z = jnp.zeros((channels, gap), jnp.float32)
        return (jnp.tile(jnp.concatenate([fr, z], -1), (1, fpc)),
                jnp.tile(jnp.concatenate([fi, z], -1), (1, fpc)))

    br, bi = framed_stream(jax.device_put(pay_blk, dev))
    np.asarray(br[0, :2])
    T = br.shape[-1]
    lead = br.shape[:-1]
    print(f"workload: {br.size/1e6:.1f}M samples/plane, nwin_g={nwin_g}",
          file=sys.stderr)

    # frame starts as the scan would find them (lattice positions)
    frame_len = overhead + n_pay * step
    starts = np.arange(fpc, dtype=np.int32) * (frame_len + gap)
    w0 = jnp.asarray(np.tile(starts // step, (channels, 1)))  # [C, K]
    widx = w0[..., None] + 1 + jnp.arange(nwin_g, dtype=jnp.int32)

    def timeit(fn, sync, label):
        out = fn()
        sync(out)
        best = 1e9
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn()
            sync(out)
            best = min(best, (time.perf_counter() - t0) / iters)
        print(f"{label:44s} {best*1e3:8.2f} ms", file=sys.stderr)
        return out, best

    tail = (nwin_g + 2) * step + (-T) % step

    # g1: committed per-row take_along
    def g1(xr, xi):
        def rows_of(plane):
            pad = jnp.pad(plane,
                          [(0, 0)] * (plane.ndim - 1) + [(2 * step, tail)])
            rows = pad.reshape(*lead, -1, step)
            idx = jnp.clip(widx, 0, rows.shape[-2] - 1)
            return jnp.take_along_axis(rows[..., None, :, :], idx[..., None],
                                       axis=-2)
        return rows_of(xr), rows_of(xi)

    j1 = jax.jit(g1)
    o1, _ = timeit(lambda: j1(br, bi), lambda o: np.asarray(o[0][0, 0, 0, :2]),
                   "g1 per-row take_along (current)")

    # g2: one contiguous slab per frame via explicit lax.gather
    n_rows_pad = (T + 2 * step + tail) // step

    def g2(xr, xi):
        def slab_of(plane):
            pad = jnp.pad(plane,
                          [(0, 0)] * (plane.ndim - 1) + [(2 * step, tail)])
            rows = pad.reshape(*lead, -1, step)       # [C, R, step]
            st = jnp.clip(widx[..., 0], 0, n_rows_pad - nwin_g)
            out = jax.lax.gather(
                rows, st[..., None],
                jax.lax.GatherDimensionNumbers(
                    offset_dims=(2, 3),
                    collapsed_slice_dims=(),
                    start_index_map=(1,),
                    operand_batching_dims=(0,),
                    start_indices_batching_dims=(0,)),
                slice_sizes=(1, nwin_g, step),
                mode=jax.lax.GatherScatterMode.CLIP)
            return out[..., 0, :, :] if out.ndim == 5 else out
        return slab_of(xr), slab_of(xi)

    j2 = jax.jit(g2)
    o2, _ = timeit(lambda: j2(br, bi), lambda o: np.asarray(o[0][0, 0, 0, :2]),
                   "g2 slab lax.gather (1 x nwin_g*step)")
    np.testing.assert_array_equal(np.asarray(o2[0]).reshape(o2[0].shape[:2]
                                  + (nwin_g, step))[:, :4],
                                  np.asarray(o1[0])[:, :4])

    # g3: vmapped dynamic_slice over frames (flat sample offsets)
    def g3(xr, xi):
        def slab_of(plane):
            pad = jnp.pad(plane,
                          [(0, 0)] * (plane.ndim - 1) + [(2 * step, tail)])
            # row widx maps to pad offset widx*step (the 2-window front
            # pad is part of the row grid, not an extra offset)
            st = jnp.clip((w0 + 1) * step, 0,
                          pad.shape[-1] - nwin_g * step)

            def per_chan(p1, s1):
                return jax.vmap(lambda s: jax.lax.dynamic_slice_in_dim(
                    p1, s, nwin_g * step))(s1)
            return jax.vmap(per_chan)(pad, st)
        return slab_of(xr), slab_of(xi)

    j3 = jax.jit(g3)
    o3, _ = timeit(lambda: j3(br, bi), lambda o: np.asarray(o[0][0, 0, :2]),
                   "g3 vmapped dynamic_slice slab")
    np.testing.assert_array_equal(
        np.asarray(o3[0])[:, :4].reshape(channels, 4, nwin_g, step),
        np.asarray(o1[0])[:, :4])

    # g4: 2*step-pitch rows (w0 parity handled by +woff where); needs
    # even alignment — here only time the raw movement with floor(w0/2)
    widx2 = (w0[..., None] + 1) // 2 + jnp.arange(nwin_g // 2 + 1,
                                                  dtype=jnp.int32)

    def g4(xr, xi):
        def rows_of(plane):
            pad = jnp.pad(plane,
                          [(0, 0)] * (plane.ndim - 1) + [(2 * step, tail)])
            rows = pad.reshape(*lead, -1, 2 * step)
            idx = jnp.clip(widx2, 0, rows.shape[-2] - 1)
            return jnp.take_along_axis(rows[..., None, :, :], idx[..., None],
                                       axis=-2)
        return rows_of(xr), rows_of(xi)

    j4 = jax.jit(g4)
    timeit(lambda: j4(br, bi), lambda o: np.asarray(o[0][0, 0, 0, :2]),
           "g4 2*step-pitch take_along (movement only)")

    # g5: NO-PAD flat-axis slab gather (VERDICT r4 #2): gather
    # nwin_g*step contiguous SAMPLES per frame straight from the unpadded
    # stream (no row-grid reshape, so no step-multiple pad either);
    # clamped starts shift edge frames by whole windows, which the
    # receiver would absorb in its existing dynamic window selects —
    # here we time the pure movement saved by dropping the pad copy.
    def g5(xr, xi):
        st_s = jnp.clip((w0 - 1) * step, 0, T - nwin_g * step)

        def slab_of(plane):
            out = jax.lax.gather(
                plane, st_s[..., None],
                jax.lax.GatherDimensionNumbers(
                    offset_dims=(2,),
                    collapsed_slice_dims=(),
                    start_index_map=(1,),
                    operand_batching_dims=(0,),
                    start_indices_batching_dims=(0,)),
                slice_sizes=(1, nwin_g * step),
                mode=jax.lax.GatherScatterMode.CLIP)
            return out.reshape(*lead, fpc, nwin_g, step)
        return slab_of(xr), slab_of(xi)

    j5 = jax.jit(g5)
    o5, _ = timeit(lambda: j5(br, bi), lambda o: np.asarray(o[0][0, 0, 0, :2]),
                   "g5 no-pad flat slab gather")
    # interior frames (no clamp) must match g1 exactly
    np.testing.assert_array_equal(np.asarray(o5[0])[:, 2:6],
                                  np.asarray(o1[0])[:, 2:6])

    # g6: row-grid no-pad slab gather — needs T % step == 0 (true at the
    # bench workload), rows view is a free bitcast, starts clamped.
    # Movement-only A/B against g2: the delta is exactly what the
    # 2-window front pad + tail pad copy costs. (Correct edge semantics
    # would additionally need zero rows + per-frame realignment — the
    # probe quantifies whether that machinery could ever pay.)
    assert T % step == 0, "bench workload must be step-aligned for g6"
    n_rows = T // step

    def g6(xr, xi):
        st = jnp.clip(w0 - 1, 0, n_rows - nwin_g)

        def slab_of(plane):
            rows = plane.reshape(*lead, n_rows, step)
            out = jax.lax.gather(
                rows, st[..., None],
                jax.lax.GatherDimensionNumbers(
                    offset_dims=(2, 3),
                    collapsed_slice_dims=(),
                    start_index_map=(1,),
                    operand_batching_dims=(0,),
                    start_indices_batching_dims=(0,)),
                slice_sizes=(1, nwin_g, step),
                mode=jax.lax.GatherScatterMode.CLIP)
            return out[..., 0, :, :] if out.ndim == 5 else out
        return slab_of(xr), slab_of(xi)

    j6 = jax.jit(g6)
    o6, _ = timeit(lambda: j6(br, bi), lambda o: np.asarray(o[0][0, 0, 0, :2]),
                   "g6 no-pad row slab gather (movement only)")
    np.testing.assert_array_equal(np.asarray(o6[0])[:, 2:6],
                                  np.asarray(o1[0])[:, 2:6])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
