"""Multi-device sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4: multi-host logic tested via
``--xla_force_host_platform_device_count``).

Gates:
* channel-sharded batched demod == single-device demod, bit-exact;
* time-sharded streaming demod with ppermute halos == single-device
  demod, bit-exact, including under injected timing shifts that force
  cross-shard halo reads;
* jit cache stays stable in steady state (the reference's zero-alloc
  property translated to the XLA world — SURVEY.md §5.2).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from lora_phy_tpu.models import modem
from lora_phy_tpu.ops import planar
from lora_phy_tpu.parallel import mesh as meshlib
from lora_phy_tpu.parallel.stream import demodulate_stream, demodulate_stream_planar
from lora_phy_tpu.ops.impair import apply_time_shift
from lora_phy_tpu.utils.params import LoraParams


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


def _make_stream(p, n_channels, payload_len=32, seed=0):
    rng = np.random.RandomState(seed)
    payloads = rng.randint(0, 256, (n_channels, payload_len)).astype(np.uint8)
    syms = modem.encode(payloads)
    iq = modem.modulate(syms, p)
    return payloads, np.asarray(modem.dechirp(iq, p))


def test_channel_sharded_equals_single(devices):
    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=8, n_time=1, devices=devices)
    payloads, dech = _make_stream(p, 8)
    ref = modem.demodulate(dech, p)

    sharded = jax.device_put(dech, meshlib.channel_sharding(m))
    res = modem.demodulate(sharded, p)
    np.testing.assert_array_equal(np.asarray(res.symbols), np.asarray(ref.symbols))
    np.testing.assert_array_equal(np.asarray(res.sync_word), np.asarray(ref.sync_word))


@pytest.mark.parametrize("layout", [(1, 8), (2, 4), (4, 2)])
def test_time_sharded_stream_equals_single(devices, layout):
    n_ch, n_t = layout
    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=n_ch, n_time=n_t, devices=devices)
    payloads, dech = _make_stream(p, n_ch, payload_len=31)  # 64 symbols total
    ref = modem.demodulate(dech, p)

    sharded = jax.device_put(dech, meshlib.stream_sharding(m))
    syms, sync, cfo, to = demodulate_stream(sharded, p, m)
    np.testing.assert_array_equal(
        np.asarray(syms)[..., 2:], np.asarray(ref.symbols)
    )
    np.testing.assert_array_equal(np.asarray(sync), np.asarray(ref.sync_word))
    np.testing.assert_allclose(np.asarray(cfo), np.asarray(ref.cfo), atol=1e-6)


def test_time_sharded_with_timing_shift(devices):
    """A +3-sample injected shift makes every shard's gather cross its right
    block boundary — exercises the ppermute halo path for real."""
    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=2, n_time=4, devices=devices)
    payloads, dech = _make_stream(p, 2, payload_len=31)
    shifted = np.asarray(apply_time_shift(dech, 3))
    ref = modem.demodulate(shifted, p)

    sharded = jax.device_put(shifted, meshlib.stream_sharding(m))
    syms, sync, cfo, to = demodulate_stream(sharded, p, m)
    np.testing.assert_array_equal(
        np.asarray(syms)[..., 2:], np.asarray(ref.symbols)
    )
    np.testing.assert_allclose(np.asarray(to), np.asarray(ref.time_offset), atol=1e-5)


@pytest.mark.parametrize("layout", [(1, 8), (2, 4)])
def test_planar_time_sharded_stream_equals_single(devices, layout):
    """The complex-free (deployment) streaming receiver: same halo/psum
    recipe on (re, im) planes, bit-exact vs the single-device demod."""
    n_ch, n_t = layout
    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=n_ch, n_time=n_t, devices=devices)
    payloads, dech = _make_stream(p, n_ch, payload_len=31)
    ref = modem.demodulate(dech, p)

    re, im = planar.split_complex(dech)
    sh = meshlib.stream_sharding(m)
    syms, sync, cfo, to = demodulate_stream_planar(
        jax.device_put(re, sh), jax.device_put(im, sh), p, m
    )
    np.testing.assert_array_equal(
        np.asarray(syms)[..., 2:], np.asarray(ref.symbols)
    )
    np.testing.assert_array_equal(np.asarray(sync), np.asarray(ref.sync_word))
    np.testing.assert_allclose(np.asarray(cfo), np.asarray(ref.cfo), atol=1e-6)


def test_planar_time_sharded_with_timing_shift(devices):
    """Timing shift forces the planar halo exchange across shard seams."""
    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=2, n_time=4, devices=devices)
    payloads, dech = _make_stream(p, 2, payload_len=31)
    shifted = np.asarray(apply_time_shift(dech, 3))
    ref = modem.demodulate(shifted, p)

    re, im = planar.split_complex(shifted)
    sh = meshlib.stream_sharding(m)
    syms, sync, cfo, to = demodulate_stream_planar(
        jax.device_put(re, sh), jax.device_put(im, sh), p, m
    )
    np.testing.assert_array_equal(
        np.asarray(syms)[..., 2:], np.asarray(ref.symbols)
    )
    np.testing.assert_allclose(np.asarray(to), np.asarray(ref.time_offset),
                               atol=1e-5)


def test_planar_full_chain_on_mesh(devices):
    """TX -> dechirp -> time-sharded planar demod, all complex-free: the
    end-to-end program a multi-GPU mesh runs."""
    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=2, n_time=4, devices=devices)
    rng = np.random.RandomState(2)
    payloads = rng.randint(0, 256, (2, 31)).astype(np.uint8)
    syms_tx = modem.encode(payloads)
    re, im = planar.modulate_planar(syms_tx, p)
    dr, di = planar.dechirp_planar(re, im, p)
    sh = meshlib.stream_sharding(m)
    syms, sync, _, _ = demodulate_stream_planar(
        jax.device_put(np.asarray(dr), sh), jax.device_put(np.asarray(di), sh), p, m
    )
    out = np.asarray(modem.decode(np.asarray(syms)[..., 2:]))
    np.testing.assert_array_equal(out, payloads)
    assert np.all(np.asarray(sync) == p.sync_word)


@pytest.mark.parametrize("layout", [(2, 4), (1, 8)])
def test_time_sharded_frame_scan_across_seams(devices, layout):
    """SURVEY §5.7b: the frame-SYNC scan + block receive on the mesh.
    Frames at arbitrary stream positions — one STRADDLING every time-shard
    seam — are found and demodulated identically to the single-device
    ``receive_block_planar``."""
    from lora_phy_tpu.models import stream as streammod, sync as syncmod
    from lora_phy_tpu.parallel.stream import receive_stream_block_planar

    n_ch, n_t = layout
    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=n_ch, n_time=n_t, devices=devices)
    n_payload = 8                                   # symbols (4 bytes)
    frame_len = streammod.frame_overhead_samples(p) + n_payload * p.step
    block = 4096 if n_t == 4 else 4352              # per-shard samples
    total = n_t * block
    rng = np.random.RandomState(11)

    chans, placed = [], []
    for c in range(n_ch):
        s = np.zeros(total, np.complex64)
        rows = {}
        # one frame straddling every interior seam (starts mid-frame
        # before the boundary), plus one at an arbitrary interior position
        # in shard 0; the 17*c / 50*c jitters keep channels distinct
        # without ever overlapping the neighbouring frames
        starts = [seam * block - frame_len // 2 + 17 * c
                  for seam in range(1, n_t)]
        starts.append(100 + 50 * c)
        for off in starts:
            pl = rng.randint(0, 256, n_payload // 2).astype(np.uint8)
            iq = np.asarray(streammod.frame_modulate(modem.encode(pl), p))
            assert off + iq.size <= total
            s[off: off + iq.size] = iq
            rows[off] = pl
        chans.append(s)
        placed.append(rows)
    streams = np.stack(chans)
    re, im = planar.split_complex(streams)

    ref = syncmod.receive_block_planar(re, im, p, n_payload,
                                       max_frames=n_t + 1)
    sh = meshlib.stream_sharding(m)
    blk = receive_stream_block_planar(
        jax.device_put(re, sh), jax.device_put(im, sh), p, n_payload, m,
        max_frames=2,
    )

    for c in range(n_ch):
        def rows_of(b):
            f = np.asarray(b.found)[c]
            return {
                int(np.asarray(b.start)[c, k]): (
                    int(np.asarray(b.sync)[c, k]),
                    tuple(np.asarray(b.symbols)[c, k].tolist()),
                )
                for k in np.flatnonzero(f)
            }

        got, want = rows_of(blk), rows_of(ref)
        assert set(got) == set(placed[c]), (set(got), set(placed[c]))
        assert got == want
        for off, pl in placed[c].items():
            dec = np.asarray(modem.decode(np.array(got[off][1], np.uint16)))
            np.testing.assert_array_equal(dec, pl)


def test_time_sharded_frame_scan_rejects_end_truncated_frame(devices):
    """A frame cut off by the END of the global stream must not be
    reported found on the mesh.  The last time shard's right halo is zero
    fill past the global end, so its local fits check (against L + halo)
    passes for such a frame; the shard body re-checks the fit against the
    true global length — otherwise the mesh path reports found=True with
    argmax-over-zeros payload symbols where the single-device
    ``receive_block_planar`` returns found=False."""
    from lora_phy_tpu.models import stream as streammod, sync as syncmod
    from lora_phy_tpu.parallel.stream import receive_stream_block_planar

    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=1, n_time=2, devices=devices[:2])
    n_payload = 8
    frame_len = streammod.frame_overhead_samples(p) + n_payload * p.step
    block = 4096
    total = 2 * block
    # frame starts in the last shard with only ~70% of it inside the stream
    off = total - frame_len + frame_len // 3
    pl = np.arange(n_payload // 2, dtype=np.uint8)
    iq = np.asarray(streammod.frame_modulate(modem.encode(pl), p))
    s = np.zeros((1, total), np.complex64)
    s[0, off:] = iq[: total - off]
    re, im = planar.split_complex(s)

    ref = syncmod.receive_block_planar(re, im, p, n_payload, max_frames=2)
    assert not np.asarray(ref.found).any()

    sh = meshlib.stream_sharding(m)
    blk = receive_stream_block_planar(
        jax.device_put(re, sh), jax.device_put(im, sh), p, n_payload, m,
        max_frames=2,
    )
    assert not np.asarray(blk.found).any()


def test_time_sharded_frame_scan_rejects_short_blocks(devices):
    from lora_phy_tpu.parallel.stream import receive_stream_block_planar

    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=1, n_time=8, devices=devices)
    re = np.zeros((1, 8 * 512), np.float32)
    with pytest.raises(ValueError, match="shorter than one"):
        receive_stream_block_planar(re, re, p, 8, m)


def test_blind_sf_receive_on_mesh(devices):
    """Blind-SF fan-out on the mesh: frames of DIFFERENT spreading
    factors — one straddling a time-shard seam — are found at exactly
    their true SF, with rows identical to the single-device
    ``receive_blind_planar``."""
    from lora_phy_tpu.models import stream as streammod, sync as syncmod
    from lora_phy_tpu.parallel.stream import receive_blind_stream_planar

    p7, p9 = LoraParams(sf=7), LoraParams(sf=9)
    m = meshlib.make_mesh(n_channel=2, n_time=2, devices=devices[:4])
    n_pay = 8
    block = 16384                       # divisible by every step 128..512
    total = 2 * block
    rng = np.random.RandomState(3)
    s = np.zeros((2, total), np.complex64)

    pl7 = rng.randint(0, 256, n_pay // 2).astype(np.uint8)
    iq7 = np.asarray(streammod.frame_modulate(modem.encode(pl7), p7))
    s[0, 700: 700 + iq7.size] = iq7
    pl9 = rng.randint(0, 256, n_pay // 2).astype(np.uint8)
    iq9 = np.asarray(streammod.frame_modulate(modem.encode(pl9), p9))
    off9 = block - iq9.size // 2        # straddles the seam
    s[1, off9: off9 + iq9.size] = iq9
    re, im = planar.split_complex(s)

    sh = meshlib.stream_sharding(m)
    res = receive_blind_stream_planar(
        jax.device_put(re, sh), jax.device_put(im, sh), p7, n_pay, m,
        sfs=(7, 8, 9), max_frames=2)
    rows = syncmod.blind_frames(res)
    assert [(r["sf"], r["index"], r["start"]) for r in rows] == [
        (7, (0,), 700), (9, (1,), off9)]
    np.testing.assert_array_equal(
        np.asarray(modem.decode(rows[0]["symbols"])), pl7)
    np.testing.assert_array_equal(
        np.asarray(modem.decode(rows[1]["symbols"])), pl9)

    ref_rows = syncmod.blind_frames(syncmod.receive_blind_planar(
        re, im, p7, n_pay, sfs=(7, 8, 9), max_frames=2))
    assert [(r["sf"], r["index"], r["start"], r["sync"]) for r in rows] == \
        [(r["sf"], r["index"], r["start"], r["sync"]) for r in ref_rows]


def test_soft_decode_on_mesh_spectra(devices):
    """Soft-decision decode on the mesh (VERDICT r4 #3a): the sharded
    block receiver returns per-frame payload spectra in true bin order
    (``with_spectra=True``), seam-straddling coded frames soft-decode
    from them (ML codeword correlation, models/soft.py), and the mesh
    spectra equal the single-device receiver's bit-exactly."""
    from lora_phy_tpu.models import coded, stream as streammod
    from lora_phy_tpu.models import soft as softmod, sync as syncmod
    from lora_phy_tpu.parallel.stream import receive_stream_block_planar

    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=4, n_time=2, devices=devices)
    cfg = coded.CodedConfig(sf=7, cr=4, crc=True)
    pls = [b"soft mesh %d" % c for c in range(4)]
    nsym = coded.payload_symbol_count(len(pls[0]), cfg)
    n_pay = 8 + nsym
    frame_len = streammod.frame_overhead_samples(p) + n_pay * p.step
    block = 8192
    total = 2 * block
    rng = np.random.RandomState(7)
    xr = np.zeros((4, total), np.float32)
    xi = np.zeros((4, total), np.float32)
    offs = []
    for c in range(4):
        iq = np.asarray(streammod.frame_encode(
            np.frombuffer(pls[c], np.uint8), cfg, p))
        off = block - frame_len // 2 + 31 * c        # straddle the seam
        xr[c, off: off + iq.size] = iq.real
        xi[c, off: off + iq.size] = iq.imag
        offs.append(off)
    xr += rng.randn(4, total).astype(np.float32) * 0.18
    xi += rng.randn(4, total).astype(np.float32) * 0.18

    sh = meshlib.stream_sharding(m)
    blk, spec = receive_stream_block_planar(
        jax.device_put(xr, sh), jax.device_put(xi, sh), p, n_pay, m,
        max_frames=2, min_power_db=-30.0, with_spectra=True)
    found = np.asarray(blk.found)
    starts = np.asarray(blk.start)
    spec = np.asarray(spec)
    symbols = np.asarray(blk.symbols)
    for c in range(4):
        ks = np.flatnonzero(found[c])
        assert ks.size == 1
        k = int(ks[0])
        assert starts[c, k] == offs[c]
        # spectra are decision-consistent (true bin order)
        np.testing.assert_array_equal(
            np.argmax(spec[c, k], axis=-1), symbols[c, k])
        nb, cr, crc_en, hok = coded.decode_header(symbols[c, k, :8], p.sf)
        assert hok and nb == len(pls[c]) and cr == 4
        pay, crc_ok, _ = softmod.decode_payload_soft(
            spec[c, k, 8: 8 + nsym], nb, cfg)
        assert bool(np.asarray(crc_ok))
        assert np.asarray(pay).tobytes() == pls[c]

    # mesh spectra == single-device spectra, bit-exact, frame-matched
    ref, ref_spec = syncmod.receive_block_planar(
        xr, xi, p, n_pay, max_frames=4, min_power_db=-30.0,
        with_spectra=True)
    rfound = np.asarray(ref.found)
    rstart = np.asarray(ref.start)
    ref_spec = np.asarray(ref_spec)
    for c in range(4):
        k = int(np.flatnonzero(found[c])[0])
        rk = [int(j) for j in np.flatnonzero(rfound[c])
              if rstart[c, j] == starts[c, k]]
        assert rk, "single-device receiver missed the mesh frame"
        np.testing.assert_array_equal(spec[c, k], ref_spec[c, rk[0]])


def test_mesh_stream_checkpoint_resume(devices, tmp_path):
    """Sharded checkpoint/resume (VERDICT r4 #4): the time/channel-
    sharded streaming receiver processes consecutive blocks with a
    carried tail; stopping after block K (save_mesh_state) and resuming
    in a FRESH demodulator (load_mesh_state) yields the identical frame
    list — bit-exact symbols and observables — including a frame that
    straddles the checkpoint boundary itself."""
    from lora_phy_tpu.models import stream as streammod
    from lora_phy_tpu.parallel.stream import (
        MeshStreamDemodulator, load_mesh_state, save_mesh_state)

    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=2, n_time=4, devices=devices)
    n_pay = 8
    frame_len = streammod.frame_overhead_samples(p) + n_pay * p.step
    rx = MeshStreamDemodulator(p, n_pay, m, max_frames=2)
    B = 16384                           # fed block size (multiple of unit)
    n_blocks = 3
    total = n_blocks * B
    rng = np.random.RandomState(21)
    xr = np.zeros((2, total), np.float32)
    xi = np.zeros((2, total), np.float32)
    placed = {0: {}, 1: {}}
    for c in range(2):
        # one frame per fed block interior + one straddling EVERY fed-
        # block boundary (incl. the checkpoint boundary at block 1|2)
        starts = [4000 + 37 * c + b * B for b in range(n_blocks)]
        starts += [b * B - frame_len // 2 + 23 * c
                   for b in range(1, n_blocks)]
        for off in starts:
            pl = rng.randint(0, 256, n_pay // 2).astype(np.uint8)
            fr, fi = streammod.frame_modulate_planar(
                np.asarray(modem.encode(pl), np.int32), p)
            xr[c, off: off + frame_len] = np.asarray(fr)
            xi[c, off: off + frame_len] = np.asarray(fi)
            placed[c][off] = pl

    def run(save_after=None):
        state = rx.init_state(2)
        out = []
        for b in range(n_blocks):
            if save_after is not None and b == save_after:
                path = tmp_path / "mesh.ckpt"
                save_mesh_state(state, path)
                rx2 = MeshStreamDemodulator(p, n_pay, m, max_frames=2)
                state = load_mesh_state(path)
                new_state, frames = rx2.process(
                    state, xr[:, b * B:(b + 1) * B], xi[:, b * B:(b + 1) * B])
            else:
                new_state, frames = rx.process(
                    state, xr[:, b * B:(b + 1) * B], xi[:, b * B:(b + 1) * B])
            state = new_state
            out.extend(frames)
        return out, state

    cont, st_c = run()
    resumed, st_r = run(save_after=1)

    # every placed frame recovered exactly once, payloads decode
    got = {(r["channel"], r["start"]) for r in cont}
    want = {(c, off) for c in placed for off in placed[c]}
    assert got == want, (got, want)
    for r in cont:
        dec = np.asarray(modem.decode(np.array(r["symbols"], np.uint16)))
        np.testing.assert_array_equal(dec, placed[r["channel"]][r["start"]])

    # resume == continuous, bit-exact
    assert len(resumed) == len(cont)
    for a, b in zip(cont, resumed):
        assert a["channel"] == b["channel"] and a["start"] == b["start"]
        np.testing.assert_array_equal(a["symbols"], b["symbols"])
        for key in ("sync", "cfo_bins", "cfo", "snr_db", "sro_ppm"):
            assert a[key] == b[key], key
    assert st_c.consumed == st_r.consumed
    assert st_c.n_frames == st_r.n_frames == len(cont)
    np.testing.assert_array_equal(st_c.emitted_start, st_r.emitted_start)
    np.testing.assert_array_equal(st_c.tail_re, st_r.tail_re)


def test_robust_receive_on_mesh(devices):
    """Multipath-robust receive (pre_acc=3) on the mesh (VERDICT r4 #3b):
    a two-ray 0.95@3 channel with seam-straddling frames decodes through
    the sharded accumulated-spectrum scan + noncoherent combining path,
    identically to the single-device robust receiver."""
    from lora_phy_tpu.models import stream as streammod, sync as syncmod
    from lora_phy_tpu.ops import impair
    from lora_phy_tpu.parallel.stream import receive_stream_block_planar

    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=4, n_time=2, devices=devices)
    block = 8192
    total = 2 * block
    rng = np.random.RandomState(5)
    pls = (np.arange(6, dtype=np.uint8)[None, :]
           + np.arange(4, dtype=np.uint8)[:, None])
    syms = modem.encode(pls)
    n_pay = syms.shape[-1]
    fr, fi = streammod.frame_modulate_planar(np.asarray(syms, np.int32), p)
    fl = fr.shape[-1]
    yr = np.zeros((4, total), np.float32)
    yi = np.zeros((4, total), np.float32)
    offs = []
    for c in range(4):
        off = block - fl // 2 + 17 * c               # straddle the seam
        yr[c, off: off + fl] = np.asarray(fr[c])
        yi[c, off: off + fl] = np.asarray(fi[c])
        offs.append(off)
    taps_re = np.zeros(4, np.float32)
    taps_re[0], taps_re[3] = 1.0, 0.95               # two-ray 0.95@3
    yr, yi = impair.apply_multipath_planar(yr, yi, taps_re,
                                           np.zeros(4, np.float32))
    yr = np.asarray(yr) + rng.randn(4, total).astype(np.float32) * 0.05
    yi = np.asarray(yi) + rng.randn(4, total).astype(np.float32) * 0.05

    sh = meshlib.stream_sharding(m)
    blk = receive_stream_block_planar(
        jax.device_put(yr, sh), jax.device_put(yi, sh), p, n_pay, m,
        max_frames=2, min_power_db=-30.0, pre_acc=3)
    found = np.asarray(blk.found)
    starts = np.asarray(blk.start)
    ref = syncmod.receive_block_planar(
        yr, yi, p, n_pay, max_frames=4, min_power_db=-30.0, pre_acc=3)
    rfound = np.asarray(ref.found)
    rstart = np.asarray(ref.start)
    for c in range(4):
        ks = [int(k) for k in np.flatnonzero(found[c])
              if abs(int(starts[c, k]) - offs[c]) <= p.step]
        assert ks, (c, starts[c][np.flatnonzero(found[c])], offs[c])
        dec = np.asarray(modem.decode(np.asarray(blk.symbols)[c, ks[0]]))
        np.testing.assert_array_equal(dec, pls[c])
        # mesh == single-device robust receiver, frame-matched
        rk = [int(j) for j in np.flatnonzero(rfound[c])
              if rstart[c, j] == starts[c, ks[0]]]
        assert rk, "single-device robust receiver missed the mesh frame"
        np.testing.assert_array_equal(
            np.asarray(blk.symbols)[c, ks[0]],
            np.asarray(ref.symbols)[c, rk[0]])


def test_adaptive_receive_on_mesh(devices):
    """Header-driven adaptive receive on the mesh: self-describing frames
    of DIFFERENT payload lengths (one straddling the time-shard seam) are
    scanned sharded, header-decoded on the host, and payload-decoded in a
    single second sharded pass at the longest decoded length."""
    from lora_phy_tpu.models import stream as streammod
    from lora_phy_tpu.models.coded import CodedConfig
    from lora_phy_tpu.parallel.stream import receive_adaptive_stream_planar

    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=2, n_time=2, devices=devices[:4])
    block = 16384
    total = 2 * block
    payloads = [[b"short", b"a much longer frame payload!!"],
                [b"mesh adaptive", b"x"]]
    offs = [[300, block - 700], [900, block + 2000]]
    s = np.zeros((2, total), np.complex64)
    expect = []
    for c in range(2):
        for b, off in zip(payloads[c], offs[c]):
            cfg = CodedConfig(sf=7, cr=2)
            iq = np.asarray(streammod.frame_encode(
                np.frombuffer(b, np.uint8), cfg, p))
            assert off + iq.size <= total
            assert not s[c, off: off + iq.size].any(), "frames overlap"
            s[c, off: off + iq.size] = iq
            expect.append((c, off, b))
    re, im = planar.split_complex(s)

    sh = meshlib.stream_sharding(m)
    res = receive_adaptive_stream_planar(
        jax.device_put(re, sh), jax.device_put(im, sh), p, m, max_frames=2)
    got = [(r["channel"], r["start"], r["payload"]) for r in res]
    assert got == sorted(expect)
    for r in res:
        assert r["info"]["header_ok"] and r["info"]["crc_ok"]


def test_ota_capture_wideband_on_mesh(devices, reference_dir):
    """The real gr-lora_sdr over-the-air capture through the FLAGSHIP
    gateway path on the mesh: each mesh channel carries the 267k-sample
    capture on a DIFFERENT sub-channel of a K=4 wideband stream
    (polyphase synthesis), ``receive_wideband_planar`` channelizes +
    scans + demodulates channel-sharded, and the gr coding pipeline
    (``gr_interop.decode_bins``) recovers every "hello world: N" payload
    CRC-verified — interop + channelizer + sharding tied to real RF
    data in one test."""
    from lora_phy_tpu.models import gr_interop, sync as syncmod
    from lora_phy_tpu.ops.channelizer import synthesize_channels_planar
    from lora_phy_tpu.utils.iqio import read_iq

    path = (reference_dir / "vectors_binary" /
            "bw_125k_sf_7_cr_1_ldro_false_crc_true_implheader_false.unknown")
    if not path.exists():
        pytest.skip("capture missing")
    cap = read_iq(path)
    # gr TX is a true continuous oversampled chirp — dechirp with the
    # unfolded lattice (the folded default's half-sample shift pushes
    # half the capture's bins across the rounding boundary) and tell the
    # fine-CFO estimator gr preambles carry no inter-symbol phase step
    p = LoraParams(sf=7, osr=2, continuous_chirp=True)
    _, _, n_rest, _ = gr_interop.payload_block_plan(7, 1, 14, True,
                                                    False, False)
    nsym = 8 + n_rest * (4 + 1)

    n_ch, kch = 2, 4
    m = meshlib.make_mesh(n_channel=n_ch, n_time=1, devices=devices[:n_ch])
    sub = [1, 2]                        # capture's sub-channel per row
    wb_r = np.zeros((n_ch, kch, cap.size), np.float32)
    wb_i = np.zeros((n_ch, kch, cap.size), np.float32)
    for c in range(n_ch):
        wb_r[c, sub[c]] = cap.real
        wb_i[c, sub[c]] = cap.imag
    wr, wi = synthesize_channels_planar(wb_r, wb_i, kch, taps_per_branch=15)

    csh = meshlib.channel_sharding(m)
    blk = syncmod.receive_wideband_planar(
        jax.device_put(np.asarray(wr), csh), jax.device_put(np.asarray(wi), csh),
        kch, p, nsym, max_frames=16, taps_per_branch=15,
        tx_phase_step=0.0)
    found = np.asarray(blk.found)                      # [n_ch, kch, 16]
    for c in range(n_ch):
        quiet = [q for q in range(kch) if q != sub[c]]
        assert found[c, quiet].sum() == 0, "silent sub-channel synced"
        ks = np.flatnonzero(found[c, sub[c]])
        assert ks.size >= 12, ks.size
        for i, k in enumerate(ks):
            fr = gr_interop.decode_bins(
                np.asarray(blk.symbols)[c, sub[c], k], 7)
            assert fr is not None and fr.header_ok and fr.crc_ok
            assert fr.payload == b"hello world: %d" % i


def test_amplitude_normalisation_collective(devices):
    """Global per-channel pmax normalisation matches single-device."""
    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=2, n_time=4, devices=devices)
    payloads, dech = _make_stream(p, 2, payload_len=31)
    dech = dech * 2.5   # force the >1.0 rescale path
    ref = modem.demodulate(dech, p)
    sharded = jax.device_put(dech, meshlib.stream_sharding(m))
    syms, sync, _, _ = demodulate_stream(sharded, p, m)
    np.testing.assert_array_equal(np.asarray(syms)[..., 2:], np.asarray(ref.symbols))


def test_no_retrace_steady_state(devices):
    """Steady-state jit cache stability — the JAX translation of the
    reference's zero-allocation contract (tests/no_alloc_test.cpp):
    repeated calls with same shapes must not retrace/recompile."""
    p = LoraParams(sf=7)
    payloads, dech = _make_stream(p, 4)
    modem.demodulate(dech, p)   # warm
    misses0 = modem.demodulate._cache_size()
    for i in range(3):
        modem.demodulate(dech * (1.0 + i * 0.1), p)
    assert modem.demodulate._cache_size() == misses0


def test_scaling_harness_smoke(devices, capsys):
    """bench_scaling produces a well-formed report (virtual CPU mesh —
    efficiency numbers here reflect shared host cores, not hardware)."""
    import json
    from lora_phy_tpu.runners import bench_scaling

    assert bench_scaling.main(["--devices=1,2", "--frames=4",
                               "--iters=2"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["mode"] == "weak" and doc["host_cores"] >= 1
    rows = doc["rows"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["samples_per_s"] > 0 for r in rows)
    assert all("collective_ms" in r and "t_nocomm_ms" in r for r in rows)
    assert rows[0]["efficiency"] == 1.0


def test_profiling_roofline():
    from lora_phy_tpu.utils.profiling import demod_roofline
    from lora_phy_tpu.utils.params import LoraParams

    kind = "NVIDIA H100 80GB HBM3"
    r7 = demod_roofline(LoraParams(sf=7), 1000, kind)
    assert r7.flops > 0 and r7.bytes > 0
    assert r7.bound in ("compute", "memory")
    assert 0 < r7.attained(max(r7.t_compute_s, r7.t_memory_s) * 2) <= 0.5
    r12 = demod_roofline(LoraParams(sf=12), 1000, kind)
    assert r12.flops < 1000 * 8 * 4096 * 4096  # four-step, not dense N^2
    with pytest.raises(ValueError, match="no published peaks"):
        demod_roofline(LoraParams(sf=7), 1000, "cpu")


def test_adaptive_mesh_defers_frame_longer_than_block(devices):
    """A header whose decoded length cannot fit one time-shard block
    (a genuinely long frame, or a corrupted length that slipped past the
    5-bit header checksum) must NOT crash pass 2's sharded receive: the
    oversized frame is reported with an ``error`` info row and every
    other frame still decodes (regression: receive_stream_block_planar's
    halo ValueError used to take the whole call down)."""
    from lora_phy_tpu.models import stream as streammod
    from lora_phy_tpu.models.coded import CodedConfig
    from lora_phy_tpu.parallel.stream import receive_adaptive_stream_planar

    p = LoraParams(sf=7)
    m = meshlib.make_mesh(n_channel=2, n_time=2, devices=devices[:4])
    block = 16384                       # 128 steps -> pass-2 cap ~111 sym
    total = 2 * block
    cfg = CodedConfig(sf=7, cr=2)
    s = np.zeros((2, total), np.complex64)

    ok_payload = b"fits fine"
    iq_ok = np.asarray(streammod.frame_encode(
        np.frombuffer(ok_payload, np.uint8), cfg, p))
    s[0, 400: 400 + iq_ok.size] = iq_ok

    big_payload = bytes(range(120))     # ~2x the per-block symbol budget
    iq_big = np.asarray(streammod.frame_encode(
        np.frombuffer(big_payload, np.uint8), cfg, p))
    assert iq_big.size > block, "test premise: frame longer than a block"
    s[1, 200: 200 + iq_big.size] = iq_big

    re, im = planar.split_complex(s)
    sh = meshlib.stream_sharding(m)
    res = receive_adaptive_stream_planar(
        jax.device_put(re, sh), jax.device_put(im, sh), p, m, max_frames=2)

    by_channel = {r["channel"]: r for r in res}
    assert by_channel[0]["payload"] == ok_payload
    assert by_channel[0]["info"]["crc_ok"]
    assert by_channel[1]["payload"] is None
    assert "time-shard block" in by_channel[1]["info"]["error"]
