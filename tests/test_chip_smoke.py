"""chip_smoke.py: every phase at a tiny size on the CPU, the four-card
phase on four virtual devices, its refusal without a GPU and its last
line. The full-size run is ``python chip_smoke.py`` on the card."""

import json

import jax
import pytest

import chip_smoke


@pytest.fixture
def compile_clock():
    """Count backend compile seconds the way main() does."""
    with chip_smoke.compile_clock():
        yield


def test_phase_golden_tiny(compile_clock, capsys):
    paths = sorted(chip_smoke.GOLDEN_DIR.glob("*.npz"))
    picked = [p for p in paths if "win1" in p.stem or "osr4" in p.stem][:2]
    worst = chip_smoke.run_phase("a golden", chip_smoke.phase_golden,
                                 picked)
    assert worst["cfo"] <= 2e-4 and worst["to_excess"] <= 0
    out = capsys.readouterr().out
    assert "phase a golden: PASS" in out and "compile_s=" in out


def test_phase_golden_rejects_a_wrong_fixture(tmp_path):
    import numpy as np

    src = sorted(chip_smoke.GOLDEN_DIR.glob("sf7_bw125000_osr1_win0.npz"))[0]
    g = dict(np.load(src))
    g["demod"] = g["demod"].copy()
    g["demod"][0] ^= 1
    bad = tmp_path / src.name
    np.savez(bad, **g)
    with pytest.raises(AssertionError, match="symbols differ"):
        chip_smoke.phase_golden([bad])


def test_phase_batch_tiny(capsys):
    mism = chip_smoke.phase_batch(seed=3, sf7=(2, 8), sf12_frames=2,
                                  ref_frames=4, snrs=(0, -9))
    assert set(mism) == {7, 12} and set(mism[7]) == {0, -9}
    assert all(total > 0 for m in mism.values() for _, total in m.values())
    assert "Precision.HIGHEST" in capsys.readouterr().out


def test_phase_receivers_tiny(capsys):
    chip_smoke.phase_receivers(seed=1, channels=2, frames_per_channel=4, k=4)
    out = capsys.readouterr().out
    assert "block receiver 2x4" in out and "wideband receiver K=4" in out


def test_phase_cli_tiny(tmp_path, capsys):
    chip_smoke.phase_cli(tmp_path, seed=2, frames=5, gap=2000, wb_frames=3,
                         wb_gap=2000, k=4, short_frames=2)
    out = capsys.readouterr().out
    for what in ("single channel", "wideband --channels=4", "--sic",
                 "--sf=auto", "--adaptive --soft"):
        assert f"  {what}:" in out


def test_adjacent_channel_images():
    """Only a weaker record in a neighbouring channel at a sent frame's
    start counts as an image; anything else stays a mismatch."""
    sent = [(8000, 18, "aa", 6), (20000, 18, "bb", 2)]
    rec = lambda s, c, snr, pay="zz": {"start": s, "sync": 18,  # noqa: E731
                                       "payload": pay, "channel": c,
                                       "snr_db": snr}
    recs = [rec(8000, 6, 36.0, "aa"), rec(20000, 2, 35.0, "bb"),
            rec(8000, 7, 27.8),            # image of the ch 6 frame
            rec(8000 + 2048, 5, 20.0),     # too far from it
            rec(20000, 4, 20.0),           # not a neighbour of ch 2
            rec(20000, 1, 40.0)]           # stronger than the ch 2 frame
    images = chip_smoke.adjacent_channel_images(recs, sent, 8, 1024)
    assert images == {(8000, 18, "zz", 7)}


@pytest.mark.parametrize("n_images,max_images", [(0, 1), (1, 1), (2, 1),
                                                 (1, 0)])
def test_compare_wideband_bounds_images(n_images, max_images):
    """The wideband list passes with its images counted, up to the bound;
    one image more fails the phase."""
    sent = [(8000, 18, "aa", 6), (20000, 18, "bb", 2)]
    recs = [{"start": s, "sync": y, "payload": h, "channel": c,
             "snr_db": 36.0} for s, y, h, c in sent]
    images = [{"start": 8000, "sync": 18, "payload": "zz", "channel": 7,
               "snr_db": 27.8},
              {"start": 20000, "sync": 18, "payload": "yy", "channel": 1,
               "snr_db": 25.0}][:n_images]
    args = ("wb", recs + images, sent, 8, 1024, max_images)
    if n_images <= max_images:
        assert chip_smoke.compare_wideband(*args) == n_images
    else:
        with pytest.raises(AssertionError, match="adjacent-channel image"):
            chip_smoke.compare_wideband(*args)


def test_phase_four_cards_on_virtual_devices(tmp_path, capsys):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    chip_smoke.phase_four_cards(tmp_path, seed=4, frames=4, gap=2000)
    out = capsys.readouterr().out
    assert "--mesh=4: 4 frames == the one-card run" in out
    assert "dryrun_multichip OK: mesh=2x2" in out


def test_main_refuses_without_gpu(capsys):
    assert chip_smoke.main([]) != 0
    assert chip_smoke.main(["--four-cards"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "needs a GPU" in err


class _FakeGpu:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"

    def memory_stats(self):
        return {"peak_bytes_in_use": 123}


@pytest.mark.parametrize("four", [False, True])
def test_last_line_format(monkeypatch, capsys, four):
    """With the phases stubbed, main() prints the card lines first and
    exactly the result object last; --four-cards runs phase e only."""
    ran = []
    for name in ("phase_golden", "phase_batch", "phase_receivers",
                 "phase_cli", "phase_four_cards"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: ran.append(_n))
    monkeypatch.setattr(chip_smoke, "_nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    n = 4 if four else 1
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeGpu()] * n)
    assert chip_smoke.main(["--four-cards"] if four else []) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "nvidia-smi: NVIDIA H100 80GB HBM3, 700.00 W"
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": n}}
    assert ran == (["phase_four_cards"] if four else
                   ["phase_golden", "phase_batch", "phase_receivers",
                    "phase_cli"])
    assert sum(l.startswith("phase ") and ": PASS" in l
               for l in lines) == len(ran)


@pytest.mark.gpu
def test_golden_parity_on_gpu(gpu_device):
    """On the card: every golden fixture, planar and complex, exact."""
    with jax.default_device(gpu_device):
        chip_smoke.phase_golden()
