"""Host cost of the no-NoC BT recorder on the card: one ``wire.measure``.

    python3 tools/measure_probe.py [--src SRC_DIR] [--reps N] [--out REPORT.json]

Needs one CUDA card and nvcc. Takes ``repro_torch`` from ``--src`` (default
this checkout's ``src``), so one call can hold two trees side by side (the
parent's and a change's, each run in turns). On the trained LeNet's
float32 weight stream in 8-value flits (Table I's baseline stream) it
reports:

* ``measure_ms`` - host wall time per ``wire.measure`` call (each call
  reads its results back, so each ends with the card idle), the median of
  five runs of ``--reps`` calls after a warm-up;
* ``bt_stream_ms`` - the same for ``core.bt.bt_stream`` and a read of its
  total;
* ``bt_count_launches`` - BT-counter launches in one measure;
* ``ops`` - how often each of ``aten::sum``, ``aten::item``, ``aten::to``
  and ``aten::_local_scalar_dense`` runs in one measure's torch.profiler
  window, and the device kernels it launched.

Prints one JSON object; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "experiments", "weights", "lenet", "step_000000400")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", default=os.path.join(REPO, "src"),
                        help="directory holding the repro_torch to measure")
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", flush=True)
        sys.exit(2)
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import bt, flits, wire
    from repro_torch.kernels import bt_count, ops
    from repro_torch.models import LeNet, load_checkpoint

    ops.build_all()
    net = LeNet(load_checkpoint(CKPT, device="cuda").params, device="cuda")
    stream = flits.pack(net.weight_stream(), 8)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()

    def wall_ms(fn) -> float:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / args.reps)
        return statistics.median(runs)

    report = {"card": card, "src": os.path.abspath(args.src),
              "shape": list(stream.words.shape),
              "measure": wire.measure(stream),
              "measure_ms": wall_ms(lambda: wire.measure(stream)),
              "bt_stream_ms": wall_ms(lambda: int(bt.bt_stream(stream)))}
    before = bt_count.KERNEL.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wire.measure(stream)
        torch.cuda.synchronize()
    report["bt_count_launches"] = bt_count.KERNEL.launches - before
    from torch.autograd import DeviceType
    events = prof.key_averages()
    report["ops"] = {e.key: e.count for e in events if e.key in (
        "aten::sum", "aten::item", "aten::to", "aten::_local_scalar_dense")}
    report["device_kernels"] = sorted(
        (e.key[:60], e.count) for e in events
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
    print(json.dumps(report), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
