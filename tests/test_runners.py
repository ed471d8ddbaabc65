"""CLI runner parity: tx/rx round trip via IQ files (the reference's
runner contract, tx_runner.cpp/rx_runner.cpp), vector generation with
base64+SHA256 manifests, comparator and perf-gate tools."""

import json
import pathlib

import numpy as np
import pytest

from lora_phy_tpu.runners import (
    compare_perf,
    compare_vectors,
    rx_runner,
    tx_runner,
    vector_dump,
    vector_generate,
)
from lora_phy_tpu.utils.iqio import read_iq, write_iq
from lora_phy_tpu.utils.params import LoraParams


def test_tx_rx_roundtrip(tmp_path, capsys):
    iq_path = tmp_path / "out.iq"
    assert tx_runner.main([
        "--payload=deadbeefcafe", "--sf=7", f"--out={iq_path}",
    ]) == 0
    samples = read_iq(iq_path)
    # (6 bytes * 2 + 2 sync) * 128 samples
    assert samples.size == 14 * 128

    assert rx_runner.main([f"--in={iq_path}", "--sf=7", "--report-offsets"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out == "deadbeefcafe"


def test_rx_integrated_quirk(tmp_path, capsys):
    """The integrated path on raw IQ reproduces the reference's broken
    decode (tx_runner | rx_runner gives 50f27003 for deadbeef —
    SURVEY.md §2.3 finding 2 [VERIFIED])."""
    iq_path = tmp_path / "x.iq"
    tx_runner.main(["--payload=deadbeef", f"--out={iq_path}"])
    assert rx_runner.main([f"--in={iq_path}", "--integrated"]) == 0
    decoded = capsys.readouterr().out.strip().splitlines()[-1]
    # our default integrated path estimates on dechirped sync, so it works
    assert decoded == "deadbeef"


def test_vector_generate_manifest(tmp_path):
    p = LoraParams(sf=7)
    out = vector_generate.generate(tmp_path / "v1", p, seed=1, byte_count=8)
    names = sorted(f.name for f in out.iterdir())
    assert "manifest.json" in names
    assert "payload.bin.b64" in names and "decoded.bin.b64" in names
    manifest = json.loads((out / "manifest.json").read_text())
    assert set(manifest["files"]) == set(n for n in names if n != "manifest.json")

    # the working-path divergence: decoded == payload (unlike the reference)
    import base64

    payload = base64.b64decode((out / "payload.bin.b64").read_bytes())
    decoded = base64.b64decode((out / "decoded.bin.b64").read_bytes())
    assert payload == decoded


def test_vector_quirk_compat_differs(tmp_path):
    """quirk-compat reproduces the reference's broken integrated goldens:
    decoded.bin != payload.bin (SURVEY.md §2.3 finding 3)."""
    import base64

    p = LoraParams(sf=7)
    out = vector_generate.generate(tmp_path / "vq", p, seed=1, byte_count=16,
                                   quirk_compat=True)
    payload = base64.b64decode((out / "payload.bin.b64").read_bytes())
    decoded = base64.b64decode((out / "decoded.bin.b64").read_bytes())
    assert payload != decoded


def test_vector_determinism_and_compare(tmp_path):
    p = LoraParams(sf=7)
    a = vector_generate.generate(tmp_path / "a", p, seed=3, byte_count=8)
    b = vector_generate.generate(tmp_path / "b", p, seed=3, byte_count=8)
    assert compare_vectors.main([str(a), str(b)]) == 0
    c = vector_generate.generate(tmp_path / "c", p, seed=4, byte_count=8)
    assert compare_vectors.main([str(a), str(c)]) == 1


def test_vector_impairments(tmp_path):
    p = LoraParams(sf=7)
    out = vector_generate.generate(tmp_path / "imp", p, seed=1, byte_count=8,
                                   cfo_bins=0.25, time_offset=2.0, b64=False)
    assert (out / "iq_samples_offset.csv").exists()


def test_vector_dump_stage_selection(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert vector_dump.main([
        "--sf=7", "--bytes=4", "--out=dump", "--dump=payload,decoded",
    ]) == 0
    names = sorted(f.name for f in pathlib.Path("dump").iterdir())
    assert names == ["decoded.bin", "manifest.json", "payload.bin"]


def test_compare_perf_gate(tmp_path):
    base = tmp_path / "base.csv"
    new_ok = tmp_path / "ok.csv"
    new_bad = tmp_path / "bad.csv"
    hdr = "run_id,profile,sf,N,pps,us_per_symbol\n"
    base.write_text(hdr + "r1,sf7,7,128,1000,5.0\n")
    new_ok.write_text(hdr + "r2,sf7,7,128,1200,4.0\n")
    new_bad.write_text(hdr + "r2,sf7,7,128,800,7.0\n")
    assert compare_perf.main([str(base), str(new_ok)]) == 0
    assert compare_perf.main([str(base), str(new_bad)]) == 1


def test_iqio_stdin_stdout_format(tmp_path):
    x = (np.arange(8) + 1j * np.arange(8)).astype(np.complex64)
    path = tmp_path / "t.iq"
    write_iq(path, x)
    raw = np.fromfile(path, dtype=np.float32)
    assert raw.size == 16
    np.testing.assert_array_equal(raw[0::2], x.real)
    np.testing.assert_array_equal(raw[1::2], x.imag)
    back = read_iq(path)
    np.testing.assert_array_equal(back, x)


def test_comprehensive_vector_generate(tmp_path):
    from lora_phy_tpu.runners import comprehensive_vector_generate
    from lora_phy_tpu.utils.vectors import load_binary_vectors
    from lora_phy_tpu.ops import coding
    import numpy as np

    out = tmp_path / "cv"
    assert comprehensive_vector_generate.main([f"--out={out}"]) == 0
    ham = load_binary_vectors(out / "hamming_tests.bin")
    assert len(ham) == 16 * 9  # 16 nibbles x (clean + 8 single-bit flips)
    for rec in ham:
        nib, err, bad = coding.hamming84_decode(np.frombuffer(rec.extra, np.uint8))
        assert int(np.asarray(nib)[0]) == rec.payload[0]
        assert (rec.test_type == "single_error") == bool(np.asarray(err)[0])
    mod = load_binary_vectors(out / "modulation_tests.bin")
    assert len(mod) == 30
    for rec in mod[:5]:
        syms = np.frombuffer(rec.extra, "<u2")
        from lora_phy_tpu.models import modem
        decoded = np.asarray(modem.decode(syms))
        assert decoded.tobytes() == rec.payload


def test_perf_harness_smoke(tmp_path, monkeypatch):
    """perf_test produces a compare_perf-compatible CSV (tiny CPU run)."""
    import os
    from lora_phy_tpu.runners import perf_test

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("RUN_ID", "smoke")
    assert perf_test.main(["--packets=8", "--payload-bytes=8"]) == 0
    csv_path = tmp_path / "logs" / "performance_smoke.csv"
    lines = csv_path.read_text().strip().splitlines()
    assert lines[0] == "run_id,profile,sf,N,pps,us_per_symbol"
    assert len(lines) == 4  # 3 default profiles
    for row in lines[1:]:
        pps = float(row.split(",")[4])
        assert pps > 0


def test_tx_rx_nondefault_params(tmp_path, capsys):
    """Runner flag coverage beyond defaults: SF9, BW250, osr2."""
    iq_path = tmp_path / "o.iq"
    assert tx_runner.main([
        "--payload=0011aabb", "--sf=9", "--bw=250000", "--osr=2",
        f"--out={iq_path}",
    ]) == 0
    samples = read_iq(iq_path)
    assert samples.size == (4 * 2 + 2) * 512 * 2
    assert rx_runner.main([
        f"--in={iq_path}", "--sf=9", "--bw=250000", "--osr=2",
    ]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    # BW250 at osr2: bins scale by bw_scale (reference-faithful aliasing,
    # docs/SEMANTICS.md) — the simple chain decodes the SCALED bins like
    # the reference binary does, so the printed hex is the aliased decode,
    # not the payload; the runner must still produce 4 bytes cleanly
    assert len(out) == 8


def test_imports_do_not_initialize_backend(tmp_path):
    """Importing the package (models, runners) must not create device
    arrays or pick a backend: the library sets nothing at import time, so
    a program (the test suite's CPU pin, a CLI's compile-cache setup) can
    still configure JAX after importing it."""
    import pathlib
    import subprocess
    import sys

    code = (
        "import lora_phy_tpu.models.gr_interop, lora_phy_tpu.models.sync, "
        "lora_phy_tpu.models.stream, lora_phy_tpu.runners.gr_decode, "
        "lora_phy_tpu.runners.tx_runner, lora_phy_tpu.ops.planar\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"  # raises if initialized
        "print(jax.default_backend())\n"
    )
    repo = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("cpu")


def test_topology_runner_cli(capfd):
    """lora-topology runs a reference .pth end-to-end and reports decodes."""
    from lora_phy_tpu.runners import topology_runner

    rc = topology_runner.main([
        "--file=/root/reference/examples/lora_simulation.pth",
        "--ticks=2", "--sf=7", "--mtu=20",
    ])
    out, _ = capfd.readouterr()
    assert rc == 0
    assert "lora test message 0" in out
    assert "dropped=0" in out

    assert topology_runner.main([]) == 1


def test_tx_continuous_chirp_flag(tmp_path):
    """--continuous-chirp selects the exact-fold TX convention
    (docs/SEMANTICS.md): bit-identical file at osr=1, different at
    osr=2 (where the reference fold leaves a pi jump per wrap)."""
    a, b, c = (tmp_path / n for n in ("a.iq", "b.iq", "c.iq"))
    assert tx_runner.main(["--payload=deadbeef", f"--out={a}"]) == 0
    assert tx_runner.main(
        ["--payload=deadbeef", "--continuous-chirp", f"--out={b}"]) == 0
    assert a.read_bytes() == b.read_bytes()
    assert tx_runner.main(
        ["--payload=deadbeef", "--osr=2", "--continuous-chirp",
         f"--out={c}"]) == 0
    ref = read_iq(a)
    cont = read_iq(c)
    assert cont.size == 2 * ref.size and not np.array_equal(cont[::2], ref)


def test_scope_runner(tmp_path, capfd):
    """lora-scope writes a two-panel waterfall PNG and annotates the
    frames the device-side scan finds."""
    import numpy as np

    from lora_phy_tpu.models import modem, stream
    from lora_phy_tpu.runners import scope
    from lora_phy_tpu.utils.params import LoraParams

    p = LoraParams(sf=7)
    pay = np.arange(8, dtype=np.uint8)
    fr = np.asarray(stream.frame_modulate(
        np.asarray(modem.encode(pay), np.int32), p))
    sig = np.zeros(3 * p.step + fr.size + 4 * p.step, np.complex64)
    sig[3 * p.step: 3 * p.step + fr.size] = fr
    iqf = tmp_path / "cap.iq"
    inter = np.empty(sig.size * 2, np.float32)
    inter[0::2], inter[1::2] = sig.real, sig.imag
    iqf.write_bytes(inter.tobytes())

    out = tmp_path / "scope.png"
    rc = scope.main([f"--in={iqf}", "--sf=7", "--payload-len=8",
                     f"--out={out}"])
    _, err = capfd.readouterr()
    assert rc == 0 and out.exists() and out.stat().st_size > 10000
    assert "(1 frames annotated)" in err
    assert scope.main(["--sf=7"]) == 1        # missing --in


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the helper returns it and sets no
    other directory (JAX reads the variable itself)."""
    import jax

    from lora_phy_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch):
    """Variable unset: the cache goes to the fixed <checkout>/.jax_cache."""
    import pathlib

    import jax

    from lora_phy_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = pathlib.Path(__file__).resolve().parents[1]
    try:
        got = compile_cache.enable_compile_cache()
        assert got == str(repo / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert compile_cache.enable_compile_cache() == got   # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_rx_stream_leaves_platform_untouched(tmp_path, capfd):
    """The CLIs run on JAX's default device: lora-rx-stream changes no
    platform setting."""
    import jax
    import numpy as np

    from lora_phy_tpu.runners import rx_stream

    before = jax.config.jax_platforms
    path = tmp_path / "silence.iq"
    np.zeros(2 * 8192, np.float32).tofile(path)
    assert rx_stream.main([f"--in={path}", "--sf=7", "--quiet"]) == 0
    assert jax.config.jax_platforms == before
    assert capfd.readouterr().out == ""
