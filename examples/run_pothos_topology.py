#!/usr/bin/env python3
"""Execute the reference's Pothos example topologies on the functional
flowgraph runtime (models/flowgraph.py).

The reference ships GUI dataflow graphs (reference: examples/*.pth) that
require the absent Pothos framework; here the same JSON files load and run
end-to-end — test_gen -> encoder -> modulator -> noise/rotate channel ->
demodulator -> decoder -> chat sink — on this framework's block library.

    python examples/run_pothos_topology.py [path.pth]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lora_phy_tpu.models import flowgraph as fg  # noqa: E402

DEFAULT = "/root/reference/examples/lora_simulation.pth"


def main() -> None:
    path = sys.argv[1] if len(sys.argv) > 1 else DEFAULT
    # SF7 keeps the demo quick; drop the override to run the file's SF10
    topo = fg.load_topology(path, overrides={"SF": 7})
    print(f"loaded {path}: {len(topo.blocks)} blocks, "
          f"{len(topo.wires)} wires, {len(topo.signal_wires)} signal wires")
    log = topo.run(4)

    for name, block in topo.blocks.items():
        if "ChatBox" in name:
            for cap in block.captured:
                if "in" in cap:
                    print(f"  {name} <- {bytes(cap['in'])!r}")
    for name in log:
        if "Decoder" in name:
            outs = [o for o in log[name] if o]
            if outs:
                print(f"  {name}: dropped={outs[-1].get('dropped', 0)}")
        if "Demod" in name:
            snrs = [o["snr"] for o in log[name] if "snr" in o]
            if snrs:
                print(f"  {name}: snr={snrs[-1]:.1f} dB")


if __name__ == "__main__":
    main()
