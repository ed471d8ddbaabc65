"""Second channelizer probe: variants of the two data-movement stages
around the matmul (the output corner-turn and the lhs build).

Variants:
  T1 naive swapaxes [F, 8] -> [8, F]                (the current path)
  T2 blocked transpose reshape(F/B, B, 2k).transpose(2,0,1)
  T3 column-permuted bank: out [n_groups, 2k, g] -> transpose(1,0,2)
     (rows of g floats move contiguously; no per-element shuffle)
  T3big same with a larger G (wider contiguous rows)
  L1 current lhs build (two shifted reshapes + 2-level concat)
  L2 two-matmul form: xr_win @ top + xi_win @ bottom (no plane concat)
  E2E candidate: L2 windows + permuted bank + T3 transpose, end to end

    python tools/probe_channelizer2.py [--tw=25] [--iters=12]
"""

import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    twlog, iters = 25, 12
    for a in args:
        if a.startswith("--tw="):
            twlog = int(a.split("=", 1)[1])
        elif a.startswith("--iters="):
            iters = int(a.split("=", 1)[1])

    import jax
    import jax.numpy as jnp

    from lora_phy_tpu.ops import channelizer as ch

    k, taps = 8, 7
    tw = 1 << twlog
    g = ch._group_size(k, taps)
    frames = tw // k
    print(f"platform={jax.default_backend()} Tw={tw} K={k} taps={taps} G={g}",
          file=sys.stderr)

    kr, ki = jax.random.split(jax.random.PRNGKey(0))
    wr = jax.jit(lambda s: jax.random.normal(s, (tw,), jnp.float32))(kr)
    wi = jax.jit(lambda s: jax.random.normal(s, (tw,), jnp.float32))(ki)
    np.asarray(wr[:2])

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
        print(f"{label:44s} {best*1e3:8.2f} ms ({tw/best/1e9:.2f} Gsps)",
              file=sys.stderr)
        return out, best

    # reference output for parity
    cur = jax.jit(lambda r, i: ch.channelize_planar(r, i, k, taps))
    ref = cur(wr, wi)
    np.asarray(ref[0][0, :2])

    # --- transpose variants on a synthetic [frames, 2k] array -------------
    key2 = jax.random.PRNGKey(1)
    fb = (frames // 4096) * 4096
    x = jax.jit(lambda s: jax.random.normal(s, (fb, 2 * k), jnp.float32))(key2)
    np.asarray(x[0, :2])

    t1 = jax.jit(lambda a: (a[:, :k].swapaxes(-1, -2),
                            a[:, k:].swapaxes(-1, -2)))
    timeit(lambda: t1(x), lambda o: np.asarray(o[0][0, :2]), "T1 swapaxes")

    B = 4096

    def blocked(a):
        v = a.reshape(fb // B, B, 2 * k).transpose(2, 0, 1).reshape(2 * k, fb)
        return v[:k], v[k:]

    t2 = jax.jit(blocked)
    o2, _ = timeit(lambda: t2(x), lambda o: np.asarray(o[0][0, :2]),
                   "T2 blocked transpose B=4096")
    a_ = np.asarray(x)
    want = (a_[:, :k].T, a_[:, k:].T)
    got = np.asarray(o2[0]), np.asarray(o2[1])
    # T2 layout: out[c, b*B+j] = x[b*B+j, c] — same as plain transpose
    np.testing.assert_array_equal(got[0], want[0])

    # --- lhs variants ------------------------------------------------------
    n_groups = -(-frames // g)
    f_pad = n_groups * g
    total = (f_pad + g) * k
    pad_head = ((taps - 1) // 2) * k
    r_ = (g + taps - 1) * k

    def windows(plane):
        xp = jnp.zeros((total,), plane.dtype)
        xp = jax.lax.dynamic_update_slice_in_dim(xp, plane[:tw], pad_head,
                                                 axis=-1)
        x0 = xp[: n_groups * g * k].reshape(n_groups, g * k)
        x1 = xp[g * k: (n_groups + 1) * g * k].reshape(n_groups, g * k)
        return jnp.concatenate([x0, x1[..., : (taps - 1) * k]], axis=-1)

    l1 = jax.jit(lambda r, i: jnp.concatenate([windows(r), windows(i)], -1))
    timeit(lambda: l1(wr, wi), lambda o: np.asarray(o[0, :2]),
           "L1 lhs concat (current)")
    l2 = jax.jit(lambda r, i: (windows(r), windows(i)))
    timeit(lambda: l2(wr, wi), lambda o: np.asarray(o[0][0, :2]),
           "L2 per-plane windows (no concat)")

    big = np.asarray(ch._grouped_bank_planar(k, taps, g))    # [2R, G*2K]
    # permute columns: (g, plane*k + c) -> (plane*k + c, g)
    perm = np.arange(g * 2 * k).reshape(g, 2 * k).T.reshape(-1)
    top = jnp.asarray(big[:r_][:, perm])
    bot = jnp.asarray(big[r_:][:, perm])

    def e2e(r, i):
        a, b = windows(r), windows(i)
        out = (jnp.matmul(a, top, preferred_element_type=jnp.float32)
               + jnp.matmul(b, bot, preferred_element_type=jnp.float32))
        v = out.reshape(n_groups, 2 * k, g).transpose(1, 0, 2)
        v = v.reshape(2 * k, f_pad)[:, :frames]
        return v[:k], v[k:]

    e = jax.jit(e2e)
    oe, _ = timeit(lambda: e(wr, wi), lambda o: np.asarray(o[0][0, :2]),
                   "E2E: L2 + permuted bank + T3")
    np.testing.assert_allclose(np.asarray(oe[0][:, :256]),
                               np.asarray(ref[0][:, :256]), atol=2e-4)
    np.testing.assert_allclose(np.asarray(oe[1][:, 1000:1256]),
                               np.asarray(ref[1][:, 1000:1256]), atol=2e-4)
    print("E2E parity OK", file=sys.stderr)

    # bigger G variant
    for gbig in (64, 128):
        ngb = -(-frames // gbig)
        fpb = ngb * gbig
        totb = (fpb + gbig) * k
        rb = (gbig + taps - 1) * k
        bigb = np.asarray(ch._grouped_bank_planar(k, taps, gbig))
        permb = np.arange(gbig * 2 * k).reshape(gbig, 2 * k).T.reshape(-1)
        topb = jnp.asarray(bigb[:rb][:, permb])
        botb = jnp.asarray(bigb[rb:][:, permb])

        def winb(plane):
            xp = jnp.zeros((totb,), plane.dtype)
            xp = jax.lax.dynamic_update_slice_in_dim(xp, plane[:tw],
                                                     pad_head, axis=-1)
            x0 = xp[: ngb * gbig * k].reshape(ngb, gbig * k)
            x1 = xp[gbig * k: (ngb + 1) * gbig * k].reshape(ngb, gbig * k)
            return jnp.concatenate([x0, x1[..., : (taps - 1) * k]], -1)

        def e2eb(r, i):
            out = (jnp.matmul(winb(r), topb,
                              preferred_element_type=jnp.float32)
                   + jnp.matmul(winb(i), botb,
                                preferred_element_type=jnp.float32))
            v = out.reshape(ngb, 2 * k, gbig).transpose(1, 0, 2)
            v = v.reshape(2 * k, fpb)[:, :frames]
            return v[:k], v[k:]

        eb = jax.jit(e2eb)
        ob, _ = timeit(lambda: eb(wr, wi),
                       lambda o: np.asarray(o[0][0, :2]),
                       f"E2E G={gbig}")
        np.testing.assert_allclose(np.asarray(ob[0][:, :256]),
                                   np.asarray(ref[0][:, :256]), atol=2e-4)
    print("bigG parity OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
