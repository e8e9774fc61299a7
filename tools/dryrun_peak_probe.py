"""How the dry run extrapolates an xLSTM cell's peak (ROADMAP C27).

    PYTHONPATH=src python3 tools/dryrun_peak_probe.py [--arch xlstm-125m] \
        [--shape prefill_32k] [--short 4 8] [--lengths 16 128 1000]

Runs on the CPU on meta tensors (nothing is allocated). For each length
it prints the peak bytes three ways: the line through the two short
lengths' peaks, the dry run's extrapolation (``launch.dryrun._trace``:
each op's bytes alive, with every scan's middle steps left out,
extrapolated op by op, the largest taken) and a direct trace at that
length, with the FLOPs of the last two. A direct trace steps through time
in Python: about 0.17 s a step for xlstm-125m's prefill on one core.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs import get
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_one_card_mesh


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--shape", default="prefill_32k")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--short", type=int, nargs=2, default=[4, 8])
    ap.add_argument("--lengths", type=int, nargs="+", default=[16, 128])
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    arch = get(args.arch)
    if args.reduced:
        arch = dataclasses.replace(arch, config=arch.reduced_config)
    one = make_one_card_mesh()
    s1, s2 = args.short
    p1, p2 = (dryrun.count_call(*dryrun._build(arch, args.shape, one, n)[:2])
              ["peak_bytes"] for n in (s1, s2))
    rows = []
    for n in args.lengths:
        ex = dryrun._trace(arch, args.shape, seq_len=n, short=(s1, s2))
        t0 = time.perf_counter()
        direct = dryrun.count_call(*dryrun._build(arch, args.shape, one,
                                                  n)[:2])
        rows.append({"length": n,
                     "line_peak": p1 + (p2 - p1) * (n - s1) // (s2 - s1),
                     "extrapolated_peak": ex["peak_bytes"],
                     "peak_is": ex["peak_is"],
                     "direct_peak": direct["peak_bytes"],
                     "extrapolated_flops": ex["flops"],
                     "direct_flops": direct["flops"],
                     "direct_s": round(time.perf_counter() - t0, 1)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
