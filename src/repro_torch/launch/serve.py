"""Batched serving launcher: prefill a prompt batch, decode with KV caches
(the port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        --reduced --batch 4 --prompt-len 32 --max-new 16 [--device cpu]

With ``--offered-load`` the launcher switches from one batched call to an
arrival-driven serving loop: requests arrive per the
:class:`repro_torch.noc.online.ArrivalProcess` the NoC closed-loop
simulator uses (one "cycle" = one millisecond, so the load unit is requests
per second), each is generated on arrival, and the run reports p50 / p99 /
mean request latency and the measured throughput:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        --reduced --offered-load 4 --num-requests 16 --arrival poisson

Parameters are random (``init_params`` from ``--seed``), as the
reference's are; the run is on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get
from ..models.spec import init_params
from ..noc.online import ArrivalProcess, latency_percentiles
from ..serve import Engine, GenerationConfig


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_offered_load(engine: Engine, prompts: torch.Tensor,
                       gen: GenerationConfig, *, load: float,
                       arrival: str = "uniform", seed: int = 0,
                       pace: bool = True):
    """Arrival-driven serving loop: request ``k`` (row ``k`` of ``prompts``)
    arrives at its :class:`ArrivalProcess` time (milliseconds; ``load`` is
    requests a second) and is generated on arrival (temperature sampling
    from a generator seeded ``seed + k``). Returns ``(outputs, stats)``:
    the p50 / p99 latency summary (:func:`latency_percentiles`, in ms) and
    the measured throughput in requests a second.

    ``pace=False`` skips the wall-clock sleeps and replays the arrival
    schedule analytically (start = max(arrival, previous finish)).
    """
    n = int(prompts.shape[0])
    arrivals = ArrivalProcess(arrival, load, seed).times(n)
    outputs = []
    latencies = []
    t0 = time.perf_counter()
    clock = 0.0                      # analytic clock (ms) when not pacing
    for k in range(n):
        arr_ms = float(arrivals[k])
        if pace:
            lag = arr_ms / 1000.0 - (time.perf_counter() - t0)
            if lag > 0:
                time.sleep(lag)
        tic = time.perf_counter()
        gen_k = torch.Generator(prompts.device).manual_seed(seed + k)
        out = engine.generate(prompts[k:k + 1], gen, generator=gen_k)
        _sync(out.device)
        outputs.append(out)
        service_ms = (time.perf_counter() - tic) * 1000.0
        if pace:
            end_ms = (time.perf_counter() - t0) * 1000.0
        else:
            clock = max(clock, arr_ms) + service_ms
            end_ms = clock
        latencies.append(int(round(end_ms - arr_ms)))
    stats = latency_percentiles(np.asarray(latencies, np.int64))
    span_ms = max(1e-9, (time.perf_counter() - t0) * 1000.0)
    stats["throughput_rps"] = n * 1000.0 / span_ms
    stats["offered_load"] = load
    stats["arrival"] = arrival
    return outputs, stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sync-every", type=int, default=8,
                    help="decode steps between host done-checks")
    ap.add_argument("--offered-load", type=float, default=None,
                    help="requests/second; enables the arrival-driven loop")
    ap.add_argument("--num-requests", type=int, default=8,
                    help="requests in the arrival-driven loop")
    ap.add_argument("--arrival", default="uniform",
                    choices=("uniform", "poisson", "backtoback"))
    ap.add_argument("--arrival-seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda, which "
                    "must be present)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get(args.arch)
    model = arch.build_reduced() if args.reduced else arch.build()
    cfg = model.cfg
    if arch.kind == "encdec":
        raise SystemExit("use the transcription example for enc-dec archs")

    params = init_params(model.specs(),
                         torch.Generator(device).manual_seed(args.seed),
                         device)
    if getattr(cfg, "vlm_prefix", 0):
        raise SystemExit("use the VLM example for vision archs")

    engine = Engine(model, params, context=args.context)
    gen = GenerationConfig(max_new_tokens=args.max_new,
                           temperature=args.temperature,
                           sync_every=args.sync_every)
    tokens = torch.Generator(device).manual_seed(args.seed + 1)

    if args.offered_load is not None:
        prompts = torch.randint(0, cfg.vocab, (args.num_requests,
                                               args.prompt_len),
                                generator=tokens, device=device)
        # warm up so the first arrival is not charged for it
        engine.generate(prompts[:1], gen)
        _sync(device)
        outs, stats = serve_offered_load(
            engine, prompts, gen, load=args.offered_load,
            arrival=args.arrival, seed=args.arrival_seed)
        print(f"served {len(outs)} requests at offered load "
              f"{args.offered_load}/s ({args.arrival}): "
              f"p50={stats['p50']}ms p99={stats['p99']}ms "
              f"mean={stats['mean']:.1f}ms "
              f"tput={stats['throughput_rps']:.2f} req/s on {device}")
        return outs, stats

    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=tokens, device=device)
    t0 = time.time()
    out = engine.generate(prompts, gen)
    _sync(device)
    dt = time.time() - t0
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({out.numel() / dt:.1f} tok/s incl. warm-up) on {device}")
    print(out[:, :12])
    return out


if __name__ == "__main__":
    main()
