"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Mirrors the reference's "test RF without radios" strategy (SURVEY.md §4):
loopback + frozen fixtures on CPU, with multi-chip sharding logic validated
via ``--xla_force_host_platform_device_count`` instead of real hardware.
The suite pins the CPU here; the GPU path is exercised by
``python chip_smoke.py`` on the card, and tests that need the card carry
the ``gpu`` marker and skip without one (the ``gpu_device`` fixture).

The persistent compilation cache is switched off for the suite: the CLIs
point it at ``<checkout>/.jax_cache`` when they start, and test runs must
not fill it.
"""

import os
import pathlib
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402

REFERENCE_DIR = pathlib.Path("/root/reference")

# ``pytest -m quick``: the fast core gate subset (~1 min measured vs ~30 min for
# the full suite) — coding truth tables, golden modem cells, planar-twin
# parity, one seam gate, one SIC gate, one e2e profile round-trip.
# Curated here (one place) instead of scattering marker decorators.
_QUICK_MODULES = {"test_coding.py", "test_modem_golden.py"}
_QUICK_EXCLUDE = {"test_crc16_all_lengths"}          # alone costs ~4 min
_QUICK_TESTS = {
    ("test_parallel.py", "test_time_sharded_frame_scan_across_seams"),
    ("test_sic.py", "test_collision_recovers_weak_frame"),
    ("test_planar.py", "test_planar_matches_complex"),
    ("test_e2e.py", "test_reference_profiles"),
    ("test_sync.py", "test_circular_extraction_matches_barrel_path"),
    ("test_sync.py", "test_receive_block_multiframe_multichannel"),
    ("test_channelizer.py", "test_receive_wideband_planar_one_call"),
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        fname = pathlib.Path(item.fspath).name
        base = item.name.split("[", 1)[0]
        if base in _QUICK_EXCLUDE:
            continue
        if fname in _QUICK_MODULES or (fname, base) in _QUICK_TESTS:
            item.add_marker(pytest.mark.quick)


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU, or a skip: decided here, at run time, never while
    the test modules are imported or collected."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run on the card: python chip_smoke.py)")


@pytest.fixture(scope="session")
def reference_dir():
    if not REFERENCE_DIR.exists():
        pytest.skip("reference checkout not available")
    return REFERENCE_DIR
