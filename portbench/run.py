"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with a CUDA card. The last
line of standard output is the result object; the last lines of standard
error are the numbers compared for ``correct``, each beside its limit.
Earlier lines give each sweep's wall, forward, packetize and drain
seconds, and the card's name, power limit and clocks; every sweep's rows
go to ``build/portbench/<cell>.<seed>.json``. ``--trace 1`` profiles the
window and reports the per-layer metrics instead of the end-to-end ones.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Every build and kernel cache inside the checkout, at fixed paths.
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    sys.path.insert(0, BENCH)
    from harness import bench, cells

    cell = cells.find_cell(cells.load_spec(ROOT), ROOT, args.workload)
    import torch
    need = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = bench.run_cell(cell, ROOT, args.seed, args.seconds,
                         bool(args.trace), "cuda", T0,
                         out_dir=os.path.join(build, "portbench"))
    for i, s in enumerate(out["sweeps"]):
        print("sweep", i, json.dumps(s), flush=True)
    print("setup_s", out["setup_s"], "checked_sweep", out["checked_sweep"],
          "check_s", out["check_s"])
    print("card", json.dumps(out["card"]))
    print("memory_peak_bytes", out["result"]["device"]["memory_peak_bytes"])
    found = bench.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
