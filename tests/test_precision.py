"""Every matmul on the receive path states its precision, and the complex
path's FFT is XLA's own.

A float32 product on a GPU may run in TF32 (about three decimal digits)
unless the dot asks for more; the planar pipeline's equality with the
complex reference and the golden fixtures rests on ``Precision.HIGHEST``.
The audit walks the traced program (sub-jaxprs included) and checks every
``dot_general``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lora_phy_tpu.models import sic, sync
from lora_phy_tpu.ops import planar
from lora_phy_tpu.ops.channelizer import channelize_planar
from lora_phy_tpu.ops.detect import detect
from lora_phy_tpu.utils.params import LoraParams

_HIGHEST = jax.lax.Precision.HIGHEST


def _dots(closed):
    """Every dot_general equation of a (closed) jaxpr, nested jaxprs
    included."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn)
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                        walk(sub.jaxpr)

    walk(closed.jaxpr)
    return out


def _spec(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


_P7, _P12 = LoraParams(sf=7), LoraParams(sf=12)
_PROGRAMS = {
    "demodulate_planar_sf7": (
        lambda r, i: planar.demodulate_planar(r, i, _P7).symbols,
        (_spec(2, 20 * 128), _spec(2, 20 * 128))),
    "demodulate_planar_sf12": (
        lambda r, i: planar.demodulate_planar(r, i, _P12).symbols,
        (_spec(1, 6 * 4096), _spec(1, 6 * 4096))),
    "receive_block_planar": (
        lambda r, i: sync.receive_block_planar(r, i, _P7, 16, max_frames=2),
        (_spec(2, 16384), _spec(2, 16384))),
    "channelize_planar": (
        lambda r, i: channelize_planar(r, i, 8),
        (_spec(8192), _spec(8192))),
    "sic_gram": (
        sic.gram_planar,
        (_spec(3, 4096), _spec(3, 4096), _spec(4096), _spec(4096))),
}


@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_every_dot_is_highest(name):
    fn, specs = _PROGRAMS[name]
    precisions = [e.params["precision"]
                  for e in _dots(jax.make_jaxpr(fn)(*specs))]
    assert precisions, f"{name}: no dot_general traced"
    bad = [p for p in precisions if p != (_HIGHEST, _HIGHEST)]
    assert not bad, f"{name}: {len(bad)} of {len(precisions)} dots at {bad[0]}"


def test_bf16_precision_option_keeps_bf16_operands():
    """The explicit ``precision='bf16'`` argument is a different contract:
    its DFT dots take bf16 operands."""
    fn = lambda r, i: planar.demodulate_planar(r, i, _P7,  # noqa: E731
                                               precision="bf16").symbols
    closed = jax.make_jaxpr(fn)(_spec(2, 20 * 128), _spec(2, 20 * 128))
    dtypes = [e.invars[0].aval.dtype for e in _dots(closed)]
    assert jnp.bfloat16 in dtypes


@pytest.mark.parametrize("n", [16, 128, 4096])
def test_fft_auto_is_jnp_fft(n):
    """The complex detector's spectrum is XLA's own FFT, bit for bit."""
    rng = np.random.RandomState(n)
    x = (rng.randn(3, n) + 1j * rng.randn(3, n)).astype(np.complex64)
    np.testing.assert_array_equal(np.asarray(detect(x).spectrum),
                                  np.asarray(jnp.fft.fft(x)))
