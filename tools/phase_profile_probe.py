"""Which phase of chip_smoke.py leaves torch.profiler without device events.

    python3 tools/phase_profile_probe.py [--out REPORT.json]

Runs ``chip_smoke.main()`` whole and, after every phase but ``device``
and ``build``, prints the device busy milliseconds that
``chip_smoke.device_ms`` reads for an in-place add on 2^20 int32 words
(five calls in one profiler window), or None when that window recorded
no device activity, and writes the list beside ``--out`` (chip_smoke's
report) as ``<out>.phases.json``, also when a phase fails. The add
launches no kernel of the port, so the script's launch checks are
unchanged. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "src"))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=os.path.join(
        REPO, "build", "phase_profile_probe.json"))
    args = parser.parse_args()
    import torch

    phase_exit = cs.Phase.__exit__
    words, readings = [], []

    def checked_exit(self, *exc):
        out = phase_exit(self, *exc)
        if exc[0] is None and self.name not in ("device", "build"):
            if not words:
                words.append(torch.randint(0, 2**31 - 1, (1 << 20,),
                                           dtype=torch.int32, device="cuda"))
            x = words[0]
            readings.append([self.name, cs.device_ms(lambda: x.add_(1), 5)])
            print(f"    after [{self.name}]: device busy ms "
                  f"{readings[-1][1]}", flush=True)
        return out

    cs.Phase.__exit__ = checked_exit
    sys.argv = ["chip_smoke.py", "--out", args.out]
    try:
        cs.main()
    finally:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out + ".phases.json", "w") as f:
            json.dump(readings, f, indent=1)


if __name__ == "__main__":
    main()
