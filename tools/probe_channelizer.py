"""On-chip stage probe for channelize_planar at the bench shape: how the
time splits between the matmul and the data movement around it.

Times, separately: (a) the current grouped-matmul path end-to-end,
(b) lhs construction alone (pad + shifted reshapes + concat),
(c) the matmul alone from a prebuilt lhs, (d) the output
slice+split+transpose alone, (e) a conv_general_dilated formulation
(stride G*K, window (G+taps-1)*K, features G*2K — XLA handles the
window overlap internally, no im2col materialisation), and (f) the conv
WITHOUT the final transpose (isolates the corner-turn).

    python tools/probe_channelizer.py [--tw=25] [--iters=12]
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
        print(f"{label:36s} {best*1e3:8.2f} ms  "
              f"({tw/best/1e9:.2f} Gsps)", file=sys.stderr)
        return out, best

    # (a) current path
    cur = jax.jit(lambda r, i: ch.channelize_planar(r, i, k, taps))
    timeit(lambda: cur(wr, wi), lambda o: np.asarray(o[0][0, :2]),
           "a) grouped matmul (current)")

    # (b) lhs construction alone — replicate the internals
    frames = tw // k
    n_groups = -(-frames // g)
    f_pad = n_groups * g
    total = (f_pad + g) * k
    pad_head = ((taps - 1) // 2) * k

    def group_rows(plane):
        xp = jnp.zeros((total,), plane.dtype)
        xp = jax.lax.dynamic_update_slice_in_dim(xp, plane[:tw], pad_head,
                                                 axis=-1)
        x0 = xp[: n_groups * g * k].reshape(n_groups, g * k)
        x1 = xp[g * k: (n_groups + 1) * g * k].reshape(n_groups, g * k)
        return jnp.concatenate([x0, x1[..., : (taps - 1) * k]], axis=-1)

    lhs_fn = jax.jit(lambda r, i: jnp.concatenate(
        [group_rows(r), group_rows(i)], axis=-1))
    lhs, _ = timeit(lambda: lhs_fn(wr, wi),
                    lambda o: np.asarray(o[0, :2]), "b) lhs build alone")

    # (c) matmul alone
    rhs = jnp.asarray(ch._grouped_bank_planar(k, taps, g))
    mm = jax.jit(lambda l: jnp.matmul(l, rhs,
                                      preferred_element_type=jnp.float32))
    out_mm, _ = timeit(lambda: mm(lhs), lambda o: np.asarray(o[0, :2]),
                       "c) matmul alone")

    # (d) slice+split+transpose alone
    fin = jax.jit(lambda o: (
        o.reshape(f_pad, 2 * k)[:frames, :k].swapaxes(-1, -2),
        o.reshape(f_pad, 2 * k)[:frames, k:].swapaxes(-1, -2)))
    timeit(lambda: fin(out_mm), lambda o: np.asarray(o[0][0, :2]),
           "d) output split+transpose alone")

    # (e) conv formulation
    r_ = (g + taps - 1) * k
    big = np.asarray(ch._grouped_bank_planar(k, taps, g))   # [2R, G*2K]
    filt = np.stack([big[:r_], big[r_:]], axis=1)           # [R, 2, G*2K]
    filt = jnp.asarray(filt)

    def conv_path(r, i, transpose=True):
        xp = jnp.zeros((total, 2), r.dtype)
        xp = jax.lax.dynamic_update_slice(
            xp, jnp.stack([r[:tw], i[:tw]], axis=-1), (pad_head, 0))
        out = jax.lax.conv_general_dilated(
            xp[None], filt, window_strides=(g * k,), padding="VALID",
            dimension_numbers=("NWC", "WIO", "NWC"),
            preferred_element_type=jnp.float32)              # [1, n_groups, G*2K]
        out = out[0].reshape(f_pad, 2 * k)[:frames]
        if transpose:
            return out[:, :k].swapaxes(-1, -2), out[:, k:].swapaxes(-1, -2)
        return out

    conv_t = jax.jit(lambda r, i: conv_path(r, i, True))
    o_e, _ = timeit(lambda: conv_t(wr, wi), lambda o: np.asarray(o[0][0, :2]),
                    "e) conv (stride GK) + transpose")
    conv_nt = jax.jit(lambda r, i: conv_path(r, i, False))
    timeit(lambda: conv_nt(wr, wi), lambda o: np.asarray(o[0, :2]),
           "f) conv, no transpose")

    # parity: conv output == current path (same f32 sums reassociated)
    a = cur(wr, wi)
    np.testing.assert_allclose(np.asarray(o_e[0][:, :256]),
                               np.asarray(a[0][:, :256]), atol=2e-4)
    np.testing.assert_allclose(np.asarray(o_e[1][:, :256]),
                               np.asarray(a[1][:, :256]), atol=2e-4)
    print("conv/current parity OK", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
