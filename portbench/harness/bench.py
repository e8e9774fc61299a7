"""One run of one cell: set-up, the measured window of back-to-back
sweeps, the traced reading, the check against the plain reference, and
the result line.

The window drives the program's ``run_sweep`` on the cell's grid; each
sweep infers on the next image of the seed's stream, its forward pass and
``layer_traffic`` timed by the benchmark's own ``portbench/forward`` span
inside the sweep. A sweep that starts inside the window is finished and
counted.
"""
from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace
from typing import Dict, List, Optional

from . import cells, images, trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Seconds of a traced run's window that the profiler records.
TRACE_SECONDS = 10.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _card() -> Dict[str, str]:
    """The card's name, power limit and clocks from ``nvidia-smi``."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
        line = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"nvidia_smi": "unavailable"}
    return dict(zip(q.split(","), (x.strip() for x in line.split(","))))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: cells.Cell, root: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: Optional[float] = None,
             out_dir: Optional[str] = None) -> dict:
    """Run ``cell`` and return ``{"result": <the result line's object>,
    "checks": [(name, value, limit), ...], "sweeps": [...]}``."""
    t0 = time.perf_counter() if t0 is None else t0
    sys.path.insert(0, os.path.join(root, "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import trained_model
    from repro_torch.noc.sweep import SweepGrid, run_sweep

    dev = torch.device(device)
    config, mix = cell.config, cell.traffic
    gridspec = dict(mix["grid"], models=[config["model"]])
    grid = SweepGrid(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in gridspec.items()}, device=device)
    tm = trained_model(config["model"], device)
    hw, _, ch = config["input_shape"]
    pool = int(mix["images"]["pool"])
    imgs = images.glyph_images(seed, pool + 1, hw, ch, dev)
    check_at = random.Random(seed).randrange(int(mix["check"]["sweeps"]))
    kept: Dict[str, list] = {}
    cur: Dict[str, float] = {}

    def layers_for(i: int, keep: bool):
        def fn(_model):
            with record_function("portbench/forward"):
                _sync(dev)
                a = time.perf_counter()
                layers = tm.model.layer_traffic(imgs[i])
                _sync(dev)
                cur["forward_s"] = time.perf_counter() - a
            if keep:
                kept["layers"] = layers
            return layers
        return fn

    # Set-up: one warm-up sweep of the cell's own grid on image 0, which
    # the window does not use (it builds the kernels on a first run).
    try:
        run_sweep(grid, layers_for(0, False), devices=None)
    except Exception:  # a failed sweep fails the run
        traceback.print_exc()
        return _failed(cell, dev, 0, 0)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0

    sweeps: List[dict] = []
    failed_sweep = []

    def sweep() -> bool:
        """One timed sweep; False (its traceback printed) if it raised."""
        k = len(sweeps)
        img = 1 + k % pool
        with record_function("portbench/sweep"):
            _sync(dev)
            a = time.perf_counter()
            try:
                rep = run_sweep(grid, layers_for(img, k == check_at),
                                devices=None)
            except Exception:  # a failed sweep fails the run
                traceback.print_exc()
                failed_sweep.append(k)
                return False
            _sync(dev)
            wall = time.perf_counter() - a
        sweeps.append(dict(wall_s=wall, forward_s=cur["forward_s"],
                           stats=rep.stats, rows=rep.rows, image=img,
                           traced=prof is not None))
        return True

    # The traced run profiles the window's first TRACE_SECONDS (whole
    # sweeps) and runs the rest untraced: the trace's readers read the
    # first part, the stage timings the second.
    prof = None
    if trace:
        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else []))
        with prof:
            with record_function("portbench/window"):
                tw = time.perf_counter()
                while (sweep() and time.perf_counter() - tw
                       < min(seconds, TRACE_SECONDS)):
                    pass
    else:
        tw = time.perf_counter()
        sweep()
    traced, prof = prof, None
    while not failed_sweep and time.perf_counter() - tw < seconds and sweep():
        pass
    error = bool(failed_sweep)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    if error or not sweeps:
        return _failed(cell, dev, peak, len(sweeps) + error)
    if check_at >= len(sweeps):
        check_at = len(sweeps) - 1
        kept["layers"] = layers_for(sweeps[-1]["image"], True)(None)
    prog_layers = [(lt.inputs, lt.weights) for lt in kept.pop("layers")]
    # Stage timings read the untraced sweeps (all of them in an untraced
    # run); the trace's readers the traced ones.
    untraced = [s for s in sweeps if not s["traced"]] or sweeps
    ctx = SimpleNamespace(
        sweeps=untraced, traced=[s for s in sweeps if s["traced"]],
        cell=cell, grid=gridspec, peak_bytes=peak, trace=None,
        peaks=cells.load_peaks(),
        layer_shapes=[tuple(i.shape) for i, _ in prog_layers],
        layers_of=lambda s: [(lt.inputs, lt.weights) for lt in
                             tm.model.layer_traffic(imgs[s["image"]])])
    result: dict = {"correct": False, "attempted": len(sweeps), "failed": 0}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": int(peak)}
    metrics = {}
    ctx.setup_s = setup_s
    if trace:
        ctx.trace = tr.reduce(traced)
        del traced
        device_info["busy_s"] = tr.busy_s(ctx.trace)
        device_info["window_s"] = ctx.trace.window_s
        result["breakdown"] = {
            "device_ops": tr.top_device_ops(ctx.trace),
            "idle_gaps": tr.idle_by_host_span(ctx.trace)}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cells.load_module("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # The check, once the window is closed and its state freed.
    ctx.trace = None
    del tm
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tc = time.perf_counter()
    checks, failed = check(cell, root, gridspec, prog_layers, imgs, sweeps,
                           check_at, dev)
    check_s = time.perf_counter() - tc
    result["correct"] = all(v <= lim for _, v, lim in checks)
    result["failed"] = failed
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    summary = [dict(wall_s=s["wall_s"], forward_s=s["forward_s"],
                    image=s["image"],
                    **{k: s["stats"].get(k) for k in (
                        "packetize_s", "simulate_s", "result_packetize_s",
                        "result_simulate_s", "stepped_cycles",
                        "result_cycles", "step")}) for s in sweeps]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{cell.name}.{seed}.json"),
                  "w") as f:
            json.dump({"sweeps": [dict(x, rows=s["rows"]) for x, s in
                                  zip(summary, sweeps)],
                       "checked_sweep": check_at, "setup_s": setup_s}, f)
    return {"result": result, "checks": checks, "sweeps": summary,
            "setup_s": setup_s, "checked_sweep": check_at, "check_s": check_s,
            "card": _card() if dev.type == "cuda" else {}}


def _failed(cell, dev, peak: int, attempted: int) -> dict:
    """The result of a window in which a sweep raised."""
    import torch
    result = {"correct": False, "attempted": attempted, "failed": 1,
              "metrics": {},
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": int(cell.workload["chips"]),
                         "memory_peak_bytes": int(peak)},
              "checks": {"sweep_errors": {"value": 1, "limit": 0}}}
    return {"result": result, "checks": [("sweep_errors", 1, 0)],
            "sweeps": [], "setup_s": None, "checked_sweep": None,
            "check_s": 0.0, "card": {}}


def check(cell, root, gridspec, prog_layers, imgs, sweeps, check_at, dev):
    """The numbers compared, each with its limit: the forward's operand
    rows against the float64 reference, the checked sweep's rows against
    the reference's rows from those operands, and every sweep's
    image-independent columns (cycles, flits, overhead bits, hops)
    against the same rows."""
    from reference.forward import forward_error, forward_traffic, \
        load_weights
    from reference.rows import SHAPE_COLUMNS, mismatches, reference_rows
    limits = cell.traffic["check"]["limits"]
    weights = load_weights(root, cell.config["weights"])
    ref_layers = forward_traffic(cell.config, weights,
                                 imgs[sweeps[check_at]["image"]], "float64")
    fwd = forward_error(prog_layers, ref_layers)
    del ref_layers
    want = reference_rows(gridspec, prog_layers)
    bad = mismatches(sweeps[check_at]["rows"], want)
    shape_bad = [mismatches(s["rows"], want, SHAPE_COLUMNS) for s in sweeps]
    for line in (bad + sum(shape_bad, []))[:20]:
        print(f"mismatch: {line}", file=sys.stderr)
    failed = sum(1 for i, sb in enumerate(shape_bad)
                 if sb or (i == check_at and bad))
    return ([("forward_rel_err", fwd, limits["forward_rel_err"]),
             ("row_mismatches", len(bad), limits["row_mismatches"]),
             ("shape_mismatches", sum(len(b) for b in shape_bad),
              limits["shape_mismatches"])], failed)
