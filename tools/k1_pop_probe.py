"""How the router kernel finds the stream of a full local FIFO that pops:
a probe that times two versions of K1 (``csrc/router_step.cu``) at the
result drain's 240 PE streams and at the request drain's 16 MC streams.

    python3 tools/k1_pop_probe.py dump BATCHES.pt
    PYTHONPATH=TREE/src python3 tools/k1_pop_probe.py time BATCHES.pt \\
        --label NAME [--out REPORT.jsonl]

Needs one CUDA card and nvcc. ``dump`` builds, with the package of this
checkout, the two batches that ``time`` reads:

* result: the full DarkNet cell's result-drain shape, 16x16 with 240 PE
  streams, 12 lanes - its four (placement, affinity) combos, three lanes
  each - of three 40,000-value result layers
  (random 8-bit values in O1 windows of 64), as ``chip_smoke.py``'s result
  batches are made;
* request: 16x16_mc16, 12 lanes of 16 MC streams, 4,000 random packets of
  five flits.

``time`` runs the router kernel of whichever ``repro_torch`` is first on
the path (so one call can hold two source trees against each other), from
a cold state in 256-cycle launches: the result batch until every lane has
drained, the request batch for 4,096 cycles. Each run is timed between one
pair of CUDA events; five runs, after one warm-up. It prints one JSON
object: microseconds a simulated cycle per run, the launches, and a digest
of the final state (equal across trees, or the kernels differ).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

CHUNK = 256
RUNS = 5
COMBOS = [(pl, aff) for pl in ("edge", "interleaved")
          for aff in ("roundrobin", "nearest")]


def dump(path: str) -> None:
    from repro_torch.core.wire import by_name
    from repro_torch.noc import sim
    from repro_torch.noc.topology import (affinity_mc_table, mc_placement,
                                          mesh_by_name)
    from repro_torch.noc.traffic import (LayerTraffic, TrafficAssembler,
                                         build_result_traffic, stack_traffics)
    rng = np.random.default_rng(5)
    base = mesh_by_name("16x16_mc16")
    pe_pad = base.num_routers - base.num_mcs
    empty = torch.zeros((40000, 0))
    parts, nodes = [], []
    for pl, aff in COMBOS * 3:
        cfg = dataclasses.replace(base, mc_nodes=mc_placement(
            base.rows, base.cols, base.num_mcs, pl))
        values = [[torch.from_numpy(rng.integers(-128, 128, 40000)
                                    .astype(np.int8)).cuda()]
                  for _ in range(3)]
        t = build_result_traffic(
            [LayerTraffic(empty, empty)] * 3, cfg, [(by_name("O1"), None)],
            mc_table=affinity_mc_table(cfg) if aff == "nearest" else None,
            num_streams=pe_pad, values=values, device="cuda")
        parts.append(t.variant(0))
        nodes.append(cfg.pe_nodes)
    res = sim.fuse_traffic(stack_traffics(parts))
    asm = TrafficAssembler([(4000, 5)], base, num_variants=12, device="cuda")
    w = rng.integers(0, 2**32, (12, 4000, 5, base.lanes),
                     dtype=np.uint64).astype(np.uint32)
    asm.add_chunk(0, 0, torch.from_numpy(w.view(np.int32)).cuda())
    req = sim.fuse_traffic(asm.finish())
    mc = np.broadcast_to(np.asarray(base.mc_nodes, np.int32), (12, 16))
    torch.save({
        "key": (base.rows, base.cols, base.num_vcs, base.vc_depth,
                base.lanes),
        "result": (res.wire.cpu(), res.length.cpu(),
                   torch.from_numpy(np.asarray(nodes, np.int32))),
        "request": (req.wire.cpu(), req.length.cpu(),
                    torch.from_numpy(mc.copy())),
    }, path)
    print(json.dumps({"dumped": path, "result_wire": list(res.wire.shape),
                      "request_wire": list(req.wire.shape)}))


def _time(key, wire, mc, launches=None):
    """(launches, microseconds a cycle per run, final-state digest)."""
    from repro_torch.kernels import router_step
    from repro_torch.noc import sim
    from repro_torch.noc.topology import mesh_by_name
    cfg = mesh_by_name("16x16_mc16")
    b, m = wire.length.shape
    total = wire.length.sum(dim=1)

    def cold():
        return sim.make_state(cfg, m, batch=b, device="cuda")

    if launches is None:
        st, launches = cold(), 0
        while not bool((st.ejected == total).all()):
            router_step.router_step(st, wire, mc, CHUNK, key, True)
            launches += 1
            if launches > 64:
                raise RuntimeError("the result batch did not drain")
    states = [cold() for _ in range(RUNS + 1)]
    us = []
    for i, st in enumerate(states):
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            router_step.router_step(st, wire, mc, CHUNK, key, True)
        z.record()
        z.synchronize()
        if i:
            us.append(a.elapsed_time(z) * 1e3 / (launches * CHUNK))
    digest = [int(leaf.long().sum()) for leaf in states[-1]]
    return launches, us, digest


def time_batches(path: str, label: str, out) -> None:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    data = torch.load(path)
    import repro_torch
    from repro_torch.noc import sim
    key = tuple(data["key"])
    report = {"label": label, "card": card, "package": repro_torch.__file__}
    for name, fixed in (("result", None), ("request", 4096 // CHUNK)):
        w, ln, mc = (x.cuda() for x in data[name])
        n, us, digest = _time(key, sim.Wire(w, ln), mc, fixed)
        report[name] = {"streams": int(ln.shape[1]),
                        "lanes": int(ln.shape[0]), "launches": n,
                        "cycles": n * CHUNK,
                        "us_per_cycle": us,
                        "median_us_per_cycle": float(np.median(us)),
                        "digest": digest}
    line = json.dumps(report)
    print(line)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("dump", "time"))
    ap.add_argument("path")
    ap.add_argument("--label", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1_pop_probe needs a CUDA card")
    if args.mode == "dump":
        dump(args.path)
    else:
        time_batches(args.path, args.label, args.out)


if __name__ == "__main__":
    main()
