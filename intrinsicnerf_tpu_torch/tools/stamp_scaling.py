"""Stamp the weak-scaling rows this host can run into one JSON.

Twin of ``tools_stamp_scaling.py``:

- **the card's rows** (``tools/bench_scaling.py`` on every card of the
  host, powers of 2: world 1 on a one-card machine), the base of the
  weak-scaling table;
- **the two-process CPU rig** (``bench_scaling --device cpu --ranks 1 2``),
  the data-parallel step across two gloo processes end to end.  Its
  efficiency is not a measurement of scaling: both processes share this
  host's cores (the caveat travels in the JSON).

    python -m intrinsicnerf_tpu_torch.tools.stamp_scaling --out SCALING_torch.json
    python -m intrinsicnerf_tpu_torch.tools.stamp_scaling --skip-card   # the rig row alone
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

from intrinsicnerf_tpu_torch.tools import bench_scaling
from intrinsicnerf_tpu_torch.tools.synthetic_replica import REPO

CAVEAT = ("2 gloo processes of the tiny CPU config on one host's cores: shows the "
          "data-parallel step across processes end to end; its efficiency measures the "
          "processes' contention for the cores, not scaling")


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="SCALING_torch.json", help="relative to the repo root")
    ap.add_argument("--skip-card", action="store_true", help="the CPU rig row alone")
    args = ap.parse_args(argv)
    result = {
        "metric": "weak scaling (fixed 512 pairs per rank; efficiency = ms per step at the "
                  "smallest world over ms per step)",
        "north_star": ">=85% efficiency to 2 hosts (BASELINE.json); the card rows beyond "
                      "world 1 need a host with that many cards: bench_scaling --ranks 1 2 4",
    }
    if not args.skip_card:
        result["card"] = bench_scaling.main([])
    rig = bench_scaling.main(["--device", "cpu", "--ranks", "1", "2", "--iters", "10"])
    rig["caveat"] = CAVEAT
    result["cpu_2process_rig"] = rig
    path = os.path.join(REPO, args.out)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(result, f, indent=2)
        f.write("\n")
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
