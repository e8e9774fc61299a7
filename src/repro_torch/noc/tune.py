"""Autotuned drain scheduling: time candidate chunk / compaction settings
on a short pinned drain and keep the winner per shape class.

The port of ``repro.noc.tune``. ``simulate_batch`` has two scheduling
knobs - the chunk length (on the card, the cycles of one router-kernel
launch) and the lane-compaction trigger ``compact_ratio`` - that trade
launches and host round trips against cycles stepped on retired lanes.
The candidates are the reference's named hypotheses, each run on the same
pinned drain. Every candidate must give the first candidate's
``(total_bt, drain_cycle)`` on every lane, or :func:`autotune_drain`
raises: the knobs may move wall time only.

Winners persist as JSON keyed by :func:`shape_class`;
``SweepGrid(tune_path=...)`` makes ``run_sweep`` apply them per mesh. The
default table, :data:`DEFAULT_PATH`, holds the port's own measurements
(``experiments/tune/drain_h100.json``); the reference's table is neither
read nor written. Run::

    PYTHONPATH=src python -m repro_torch.noc.tune [mesh ...] [--device cpu]
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Optional, Sequence

import torch

from .._device import DeviceLike, resolve_device
from .topology import NocConfig, mesh_by_name

__all__ = ["DrainSchedule", "CANDIDATES", "DEFAULT_PATH", "shape_class",
           "autotune_drain", "load_tuned", "save_tuned", "schedule_for",
           "main"]

DEFAULT_PATH = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
    "experiments", "tune", "drain_h100.json"))


@dataclasses.dataclass(frozen=True)
class DrainSchedule:
    """One named scheduling candidate: wall-time knobs only."""
    name: str
    chunk: int
    compact_ratio: float


# fine:   shorter chunks read the drain bookkeeping sooner, so lanes that
#         drained early stop stepping; wins when drain cycles are spread.
# pinned: the sweep's hand-pinned constants (the control).
# coarse: longer chunks amortize launches and host reads and skip most
#         compactions; wins when the lanes drain close together.
CANDIDATES: Dict[str, DrainSchedule] = {
    "fine": DrainSchedule("fine", chunk=512, compact_ratio=0.5),
    "pinned": DrainSchedule("pinned", chunk=2048, compact_ratio=0.5),
    "coarse": DrainSchedule("coarse", chunk=8192, compact_ratio=0.25),
}


def shape_class(cfg: NocConfig) -> str:
    """Key of the tuned table: one batched drain per mesh geometry."""
    return f"{cfg.rows}x{cfg.cols}_mc{cfg.num_mcs}"


def autotune_drain(cfg: NocConfig, traffic, *,
                   candidates: Optional[Dict[str, DrainSchedule]] = None,
                   backend: str = "auto", max_cycles: int = 2_000_000,
                   repeats: int = 2, device: DeviceLike = None) -> dict:
    """Time every candidate schedule on one batched drain of ``traffic``
    (a leading variants axis; a short pinned drain is enough). Each
    candidate runs once to warm up - its rows pinned to the first
    candidate's - then ``repeats`` times; the best wall time counts, the
    device synchronised before each clock read.

    Returns ``{"shape_class", "timings": {name: seconds}, "winner",
    "chunk", "compact_ratio"}``, the record :func:`save_tuned` keeps.
    """
    from .sim import simulate_batch

    dev = resolve_device(device)
    cands = dict(candidates if candidates is not None else CANDIDATES)
    if not cands:
        raise ValueError("need at least one candidate schedule")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    timings: Dict[str, float] = {}
    pin = None
    for name, sched in cands.items():
        def run(sched=sched):
            return simulate_batch(cfg, traffic, chunk=sched.chunk,
                                  compact_ratio=sched.compact_ratio,
                                  backend=backend, max_cycles=max_cycles,
                                  device=dev)

        got = [(r.total_bt, r.drain_cycle) for r in run()]
        if pin is None:
            pin = got
        elif got != pin:
            raise RuntimeError(
                f"candidate {name!r} changed simulated results: {got} "
                f"vs {pin} - drain scheduling must be bit-identical")
        best = float("inf")
        for _ in range(max(1, repeats)):
            sync()
            t0 = time.perf_counter()
            run()
            sync()
            best = min(best, time.perf_counter() - t0)
        timings[name] = best
    winner = min(timings, key=timings.get)
    return {"shape_class": shape_class(cfg),
            "timings": {k: round(v, 4) for k, v in timings.items()},
            "winner": winner,
            "chunk": cands[winner].chunk,
            "compact_ratio": cands[winner].compact_ratio}


def load_tuned(path: str = DEFAULT_PATH) -> Dict[str, dict]:
    """Tuned table (shape class -> record); empty when there is no file.
    Keys starting with ``_`` (notes such as the card) are not classes."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {k: v for k, v in json.load(f).items()
                if not k.startswith("_")}


def save_tuned(record: dict, path: str = DEFAULT_PATH,
               note: Optional[str] = None) -> Dict[str, dict]:
    """Merge one :func:`autotune_drain` record into the table on disk;
    ``note`` (for instance the card and its power limit) is kept under
    ``_measured_on``."""
    table = {}
    if os.path.exists(path):
        with open(path) as f:
            table = json.load(f)
    table[record["shape_class"]] = {
        k: record[k] for k in ("winner", "chunk", "compact_ratio", "timings")}
    if note is not None:
        table["_measured_on"] = note
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    return {k: v for k, v in table.items() if not k.startswith("_")}


def schedule_for(cfg: NocConfig,
                 table: Dict[str, dict]) -> Optional[DrainSchedule]:
    """The kept winner for ``cfg``'s shape class, or None."""
    rec = table.get(shape_class(cfg))
    if rec is None:
        return None
    return DrainSchedule(rec["winner"], int(rec["chunk"]),
                         float(rec["compact_ratio"]))


def pinned_drain(cfg: NocConfig, max_packets: int,
                 device: DeviceLike = None):
    """The short drain the candidates are timed on: the trained LeNet on
    one glyph image (generator seed 7 on ``device``), O0/O1/O2 float32
    variants with the ``pattern`` tiebreak, ``max_packets`` packets a
    layer."""
    from ..core.wire import by_name
    from ..data import glyph_batch
    from ..models import trained_model
    from .traffic import build_traffic_batch

    dev = resolve_device(device)
    net = trained_model("lenet", device=dev).model
    gen = torch.Generator(device=dev).manual_seed(7)
    img, _ = glyph_batch(gen, 1, device=dev)
    variants = [(by_name(n, tiebreak="pattern"), None)
                for n in ("O0", "O1", "O2")]
    return build_traffic_batch(net.layer_traffic(img[0]), cfg, variants,
                               max_packets_per_layer=max_packets, device=dev)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("meshes", nargs="*", default=["4x4_mc2", "8x8_mc4"],
                    help="PAPER_NOCS names / RxC_mcN specs to tune")
    ap.add_argument("--out", default=DEFAULT_PATH)
    ap.add_argument("--max-packets", type=int, default=8,
                    help="per-layer packet budget of the pinned drain")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--note", default=None,
                    help="kept beside the winners, e.g. the card's name and "
                         "power limit")
    args = ap.parse_args(argv)

    for name in args.meshes:
        cfg = mesh_by_name(name)
        rec = autotune_drain(cfg, pinned_drain(cfg, args.max_packets,
                                               args.device),
                             backend=args.backend, device=args.device)
        save_tuned(rec, args.out, note=args.note)
        times = " ".join(f"{k}={v}s" for k, v in rec["timings"].items())
        print(f"[ok] {rec['shape_class']}: winner={rec['winner']} "
              f"(chunk={rec['chunk']} ratio={rec['compact_ratio']}) {times}",
              flush=True)


if __name__ == "__main__":
    main()
