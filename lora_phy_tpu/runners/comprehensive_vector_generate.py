"""Comprehensive binary vector generator.

Equivalent of the reference's ``generate_comprehensive_vectors``
(reference: runners/comprehensive_vector_generate.cpp:46-105): writes
``hamming_tests.bin`` (Hamming84 records for all 16 nibbles) and
``modulation_tests.bin`` (SF x payload matrix) in the corpus record
format — readable by utils/vectors.py and the reference's own loaders.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

from ..models import modem
from ..ops import coding
from ..utils.params import LoraParams
from ..utils.vectors import VectorRecord, write_binary_vectors
from ..utils.compile_cache import enable_compile_cache
from ._cli import parse_flags

PAYLOADS = [b"Hello", b"Test123", b"AAAAAAAAAA", b"\x00\x01\x02\x03",
            b"LoRa GPU"]


def main(argv=None) -> int:
    enable_compile_cache()
    flags = parse_flags(sys.argv[1:] if argv is None else argv, {
        "out": (str, "vectors_binary_out"),
    })
    out = pathlib.Path(flags["out"])
    out.mkdir(parents=True, exist_ok=True)

    # Hamming84 records: encoded codeword for every nibble in `extra`
    hamming = []
    for nib in range(16):
        cw = int(np.asarray(coding.hamming84_encode(np.uint8(nib))))
        hamming.append(VectorRecord("no_error", bytes([nib]), 0, "4/8",
                                    bytes([cw])))
        for bit in range(8):
            hamming.append(VectorRecord("single_error", bytes([nib]), 0,
                                        "4/8", bytes([cw ^ (1 << bit)])))
    write_binary_vectors(out / "hamming_tests.bin", hamming)

    # modulation records: per SF x payload, demod symbols in `extra`
    modulation = []
    for sf in (7, 8, 9, 10, 11, 12):
        p = LoraParams(sf=sf)
        for payload in PAYLOADS:
            data = np.frombuffer(payload, dtype=np.uint8)
            syms = modem.encode(data)
            iq = modem.modulate(syms, p)
            res = modem.demodulate(modem.dechirp(iq, p), p)
            extra = np.asarray(res.symbols).astype("<u2").tobytes()
            modulation.append(VectorRecord("modulation", payload, sf, "4/8",
                                           extra))
    write_binary_vectors(out / "modulation_tests.bin", modulation)
    print(f"wrote {out}/hamming_tests.bin ({len(hamming)} records), "
          f"{out}/modulation_tests.bin ({len(modulation)} records)",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
