"""End-to-end training launcher (the port of ``repro.launch.train``).

Selects any --arch (full or reduced config), builds the train step,
restores the newest intact checkpoint if present (fault-tolerant restart),
and trains on the deterministic token pipeline with gradient-wire BT
telemetry from the paper's technique:

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --steps 200 --seq 128 --batch 8 --ckpt build/ckpt --ckpt-every 50 \
        --wire-telemetry
    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        --reduced --steps 50 --device cpu

The run is on the card unless ``--device cpu``; on the card the step is
captured into one CUDA graph at its first call and replayed (the eager
step is host-bound: about 190,000 kernel launches a full-width xLSTM
step). The reference's ``--mesh``
(pod and multipod meshes) waits for the dry runs (ROADMAP A18) and more
than one card. Parameters are random (``init_params`` from a generator
seeded with ``--seed`` on the run's device).
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..configs import get
from ..data import TokenStream
from ..models.spec import init_params
from ..optim import AdamW, cosine, wsd
from ..train import checkpoint, init_state, make_train_step

__all__ = ["loss_fn_for", "optimizer_for", "main"]


def loss_fn_for(arch, model):
    """``loss_fn(params, (tokens, targets, mask))`` for ``arch``: enc-dec
    archs take one-hot frames of the tokens (bf16), VLM archs zero patch
    embeddings, as the reference's launcher stubs them."""
    cfg = model.cfg
    if arch.kind == "encdec":
        def loss_fn(p, batch):
            toks, tgt, mask = batch
            frames = F.one_hot(toks.long() % cfg.d_model,
                               cfg.d_model).to(torch.bfloat16)
            return model.loss(p, frames, toks, tgt, mask)
    elif getattr(cfg, "vlm_prefix", 0):
        def loss_fn(p, batch):
            toks, tgt, mask = batch
            pe = torch.zeros((toks.shape[0], cfg.vlm_prefix, cfg.d_model),
                             dtype=torch.bfloat16, device=toks.device)
            return model.loss(p, toks, tgt, mask, pe)
    else:
        def loss_fn(p, batch):
            toks, tgt, mask = batch
            return model.loss(p, toks, tgt, mask)
    return loss_fn


def optimizer_for(arch, lr: float, steps: int, schedule=None) -> AdamW:
    """AdamW with the arch's moment format, under WSD for minicpm (the WSD
    arch) and cosine otherwise unless ``schedule`` names one."""
    name = schedule or ("wsd" if "minicpm" in arch.name else "cosine")
    sched = (wsd if name == "wsd" else cosine)(lr, steps)
    return AdamW(sched, state_dtype=arch.optimizer_state)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the launcher; returns the final state, the step it started from,
    each step's seconds and host-side metrics, each checkpoint's seconds,
    and the step function."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config of the same family")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=["wsd", "cosine"], default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda, which "
                    "must be present)")
    ap.add_argument("--wire-telemetry", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get(args.arch)
    model = arch.build_reduced() if args.reduced else arch.build()
    cfg = model.cfg
    opt = optimizer_for(arch, args.lr, args.steps, args.schedule)
    params = init_params(model.specs(),
                         torch.Generator(device).manual_seed(args.seed),
                         device)
    state = init_state(params, opt)

    start = 0
    if args.ckpt:
        got = checkpoint.restore(args.ckpt, state)
        if got is not None:
            start, state = got
            print(f"restored checkpoint at step {start}")

    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=args.seed)
    step_fn = make_train_step(loss_fn_for(arch, model), opt,
                              microbatches=args.microbatches,
                              wire_telemetry=args.wire_telemetry)
    run = {"start": start, "step_s": [], "metrics": [], "ckpt_s": []}

    def save(step):
        t = time.perf_counter()
        checkpoint.save(args.ckpt, step, state)
        run["ckpt_s"].append(time.perf_counter() - t)

    t0 = time.time()
    for i in range(start, args.steps):
        tic = time.perf_counter()
        state, metrics = step_fn(state, stream.batch(i, device=device))
        host = {"loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                "lr": float(metrics["lr"])}
        if args.wire_telemetry:
            host["wire"] = {k: (v if isinstance(v, int) else v.item())
                            for k, v in metrics["wire"].items()}
        _sync(device)
        run["step_s"].append(time.perf_counter() - tic)
        run["metrics"].append(host)
        if i % 10 == 0 or i == args.steps - 1:
            msg = (f"step {i:5d} loss {host['loss']:.4f} "
                   f"gnorm {host['grad_norm']:.3f} "
                   f"lr {host['lr']:.2e} "
                   f"{(time.time() - t0) / max(i - start + 1, 1):.2f}s/step")
            if args.wire_telemetry:
                w = host["wire"]
                msg += (f" | wire-BT O1 {w['reduction_o1'] * 100:+.1f}%"
                        f" O2 {w['reduction_o2'] * 100:+.1f}%")
            print(msg, flush=True)
        if args.ckpt and (i + 1) % args.ckpt_every == 0:
            save(i + 1)
    if args.ckpt:
        save(args.steps)
    print("done")
    run["state"] = state
    run["step_fn"] = step_fn
    return run


if __name__ == "__main__":
    main()
