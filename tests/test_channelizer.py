"""Polyphase channelizer: tone separation and a full multi-channel LoRa
receive — wideband stream -> K channels -> per-channel demod/decode."""

import numpy as np
import pytest

from lora_phy_tpu.models import modem
from lora_phy_tpu.ops.channelizer import (channelize, synthesize_channels,
                                          synthesize_tone_channels)
from lora_phy_tpu.utils.params import LoraParams


def test_tone_separation():
    """A tone on channel c lands in output channel c with the others
    quiet."""
    k = 8
    frames = 512
    t = np.arange(frames * k)
    for c in (0, 2, 5):
        wide = np.exp(2j * np.pi * c * t / k).astype(np.complex64)
        chans = np.asarray(channelize(wide, k))
        power = np.mean(np.abs(chans) ** 2, axis=-1)
        # steady-state region (skip filter warmup)
        assert power[c] > 50 * (power.sum() - power[c] + 1e-9), power


def test_dc_tone_feedthrough_gain():
    k = 8
    wide = np.ones(4096, np.complex64)
    chans = np.asarray(channelize(wide, k))
    # unit DC input -> unit DC on channel 0 (filter normalised)
    assert abs(np.mean(chans[0, 16:]) - 1.0) < 0.05


@pytest.mark.parametrize("synth", ["polyphase", "zoh"])
def test_multichannel_lora_receive(synth):
    """Two LoRa transmissions on different channels of one wideband
    stream: synthesis bank (or the legacy ZOH mixer) -> channelize ->
    dechirp -> demodulate -> decode both payloads."""
    p = LoraParams(sf=7)
    k = 4
    pay_a = np.arange(12, dtype=np.uint8)
    pay_b = (np.arange(12, dtype=np.uint8) * 5 + 1).astype(np.uint8)

    iq_a = np.asarray(modem.modulate(modem.encode(pay_a), p))
    iq_b = np.asarray(modem.modulate(modem.encode(pay_b), p))
    sigs = np.zeros((k, iq_a.size), np.complex64)
    sigs[1] = iq_a
    sigs[3] = iq_b
    if synth == "polyphase":
        wide = np.asarray(synthesize_channels(sigs, k))
        gain = 1.0
    else:
        wide = np.asarray(synthesize_tone_channels(sigs, k))
        gain = k                                 # undo the 1/nchan scale

    chans = np.asarray(channelize(wide, k))      # [K, T]
    for chan, payload in ((1, pay_a), (3, pay_b)):
        x = chans[chan] * gain
        dech = modem.dechirp(x, p)
        res = modem.demodulate(np.asarray(dech), p)
        out = np.asarray(modem.decode(np.asarray(res.symbols)))
        np.testing.assert_array_equal(out, payload)
        assert int(res.sync_word) == 0x12


def test_synthesis_bank_matches_explicit_upsample():
    """The polyphase synthesis equals explicit zero-stuff + prototype FIR
    + carrier mix (offset by the symmetric-pad group delay)."""
    from lora_phy_tpu.ops.channelizer import _prototype

    k, F, tpb = 4, 256, 7
    rng = np.random.RandomState(0)
    x = (rng.randn(F) + 1j * rng.randn(F)).astype(np.complex64)
    sigs = np.zeros((k, F), np.complex64)
    sigs[2] = x
    got = np.asarray(synthesize_channels(sigs, k, tpb))

    h = _prototype(k, tpb).reshape(-1) * k
    zs = np.zeros(F * k, np.complex64)
    zs[::k] = x
    filt = np.convolve(zs, h, mode="full")
    t = np.arange(filt.size)
    ref = (filt * np.exp(2j * np.pi * 2 * t / k)).astype(np.complex64)
    half = ((tpb - 1) // 2) * k
    np.testing.assert_allclose(got, ref[half: half + got.size], atol=1e-5)


def test_synthesis_bank_image_rejection():
    """Upsampling images sit >45 dB below the carrier through the
    prototype's stopband; the ZOH mixer only manages its sinc roll-off
    (~9 dB). Exact-bin tone so DFT leakage doesn't pollute the measure."""
    k, F = 4, 4096
    f0 = 820 / F
    m = np.arange(F)
    tone = np.exp(2j * np.pi * f0 * m).astype(np.complex64)
    sigs = np.zeros((k, F), np.complex64)
    sigs[2] = tone

    def rejection(wide):
        spec = np.abs(np.fft.fft(wide)) ** 2
        main = 2 * F + 820
        images = [(main + j * F) % (F * k) for j in (1, 2, 3)]
        return 10 * np.log10(spec[main] / sum(spec[i] for i in images))

    assert rejection(np.asarray(synthesize_channels(sigs, k))) > 45.0
    assert rejection(np.asarray(synthesize_tone_channels(sigs, k)) * k) < 15.0


def test_channelizer_batched():
    """Leading batch dims flow through the filter bank."""
    k = 8
    rng = np.random.RandomState(0)
    wide = (rng.randn(3, 2048) + 1j * rng.randn(3, 2048)).astype(np.complex64)
    chans = np.asarray(channelize(wide, k))
    assert chans.shape == (3, k, 2048 // k)
    single = np.asarray(channelize(wide[1], k))
    np.testing.assert_allclose(chans[1], single, atol=1e-5)


def test_planar_channelizer_matches_complex():
    """channelize_planar / synthesize_channels_planar are bit-close twins
    of the complex bank — the planar wideband front end."""
    from lora_phy_tpu.ops.channelizer import (channelize_planar,
                                              synthesize_channels_planar)

    rng = np.random.RandomState(7)
    k, T = 8, 4096
    x = (rng.randn(T) + 1j * rng.randn(T)).astype(np.complex64)
    ref = np.asarray(channelize(x, k))
    pr, pi = channelize_planar(
        x.real.astype(np.float32), x.imag.astype(np.float32), k)
    got = np.asarray(pr) + 1j * np.asarray(pi)
    assert np.allclose(got, ref, atol=1e-5)

    ch = (rng.randn(3, 64) + 1j * rng.randn(3, 64)).astype(np.complex64)
    ref_w = np.asarray(synthesize_channels(ch, k))
    wr, wi = synthesize_channels_planar(
        ch.real.astype(np.float32), ch.imag.astype(np.float32), k)
    got_w = np.asarray(wr) + 1j * np.asarray(wi)
    assert np.allclose(got_w, ref_w, atol=1e-5)


def test_planar_channelizer_degenerate_group_size():
    """taps_per_branch=1 with k > 1024 drives both _group_size terms to 0
    (the G*K target is 1024 since the channel-major split-bank form); the
    clamp must keep the grouped matmul well-formed (user-settable via
    lora-rx-stream --taps)."""
    from lora_phy_tpu.ops.channelizer import _group_size, channelize_planar

    assert _group_size(2048, 1) == 1                  # the clamp is live
    rng = np.random.RandomState(3)
    k, T = 2048, 8192
    x = (rng.randn(T) + 1j * rng.randn(T)).astype(np.complex64)
    ref = np.asarray(channelize(x, k, taps_per_branch=1))
    pr, pi = channelize_planar(x.real.astype(np.float32),
                               x.imag.astype(np.float32), k,
                               taps_per_branch=1)
    got = np.asarray(pr) + 1j * np.asarray(pi)
    assert got.shape == ref.shape == (k, T // k)
    assert np.allclose(got, ref, atol=1e-5)


def test_planar_wideband_lora_receive():
    """Full complex-free wideband chain: framed LoRa TX on two channels ->
    planar synthesis bank -> planar analysis bank -> planar block
    receiver; both payloads recover bit-exactly."""
    from lora_phy_tpu.models import stream, sync
    from lora_phy_tpu.ops.channelizer import (channelize_planar,
                                              synthesize_channels_planar)

    k = 4
    p = LoraParams(sf=7)
    payloads = np.stack([np.arange(16, dtype=np.uint8),
                         np.arange(16, dtype=np.uint8)[::-1]])
    syms = np.asarray(modem.encode(payloads), np.int32)
    frames = np.stack([
        np.asarray(stream.frame_modulate(syms[c], p)) for c in range(2)
    ])
    gap = np.zeros((2, 600), np.complex64)
    streams = np.concatenate([gap, frames, gap], axis=-1)
    F = streams.shape[-1]
    sr = np.zeros((k, F), np.float32)
    si = np.zeros((k, F), np.float32)
    sr[1], si[1] = streams[0].real, streams[0].imag   # channel 1
    sr[3], si[3] = streams[1].real, streams[1].imag   # channel 3
    wr, wi = synthesize_channels_planar(sr, si, k, taps_per_branch=15)
    cr, ci = channelize_planar(np.asarray(wr), np.asarray(wi), k,
                               taps_per_branch=15)
    cr, ci = np.asarray(cr), np.asarray(ci)
    n_sym = syms.shape[-1]
    for chan, pay in ((1, payloads[0]), (3, payloads[1])):
        blk = sync.receive_block_planar(cr[chan], ci[chan], p, n_sym,
                                        max_frames=1)
        kidx = np.flatnonzero(np.asarray(blk.found))
        assert kidx.size == 1
        dec = np.asarray(modem.decode(np.asarray(blk.symbols)[kidx[0]]))
        assert np.array_equal(dec, pay)


def test_receive_wideband_planar_one_call():
    """The one-jit wideband receiver finds and decodes frames on the
    occupied channels and reports none on the quiet ones."""
    from lora_phy_tpu.models import stream, sync
    from lora_phy_tpu.ops.channelizer import synthesize_channels_planar

    k = 4
    p = LoraParams(sf=7)
    payloads = np.stack([np.arange(16, dtype=np.uint8),
                         (np.arange(16, dtype=np.uint8) * 3 + 2).astype(np.uint8)])
    syms = np.asarray(modem.encode(payloads), np.int32)
    frames = np.stack([
        np.asarray(stream.frame_modulate(syms[c], p)) for c in range(2)
    ])
    gap = np.zeros((2, 600), np.complex64)
    streams = np.concatenate([gap, frames, gap], axis=-1)
    F = streams.shape[-1]
    sr = np.zeros((k, F), np.float32)
    si = np.zeros((k, F), np.float32)
    sr[1], si[1] = streams[0].real, streams[0].imag
    sr[2], si[2] = streams[1].real, streams[1].imag
    wr, wi = synthesize_channels_planar(sr, si, k, taps_per_branch=15)

    blk = sync.receive_wideband_planar(
        np.asarray(wr), np.asarray(wi), k, p, syms.shape[-1],
        max_frames=2, taps_per_branch=15,
    )
    found = np.asarray(blk.found)                  # [k, 2]
    assert found[1].sum() == 1 and found[2].sum() == 1
    assert found[0].sum() == 0 and found[3].sum() == 0
    for chan, pay in ((1, payloads[0]), (2, payloads[1])):
        i = np.flatnonzero(found[chan])[0]
        dec = np.asarray(modem.decode(np.asarray(blk.symbols)[chan, i]))
        assert np.array_equal(dec, pay)
