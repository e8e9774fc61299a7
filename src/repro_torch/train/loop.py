"""Train-step factory: loss -> grads -> clip -> AdamW, with optional
microbatch gradient accumulation and gradient-wire BT telemetry (the port
of ``repro.train.loop``).

``make_train_step`` returns ``step(state, batch) -> (state, metrics)``:
captured into one CUDA graph on CUDA tensors, eager elsewhere. Gradients
come from ``torch.autograd.grad`` on the parameter tree's leaves, so any
tree of tensors (dicts, lists, tuples, NamedTuples, in ``tree.leaves``
order) trains. Without microbatches a
leaf's gradient keeps the leaf's dtype; with them the microbatch grads are
summed in float32 and divided, and stay float32 into the clip and the
update, as the reference leaves them (ROADMAP C24). With
``wire_telemetry`` the metrics carry the clipped gradients' wire report
(``dist.ordered_collectives.gradient_wire_report``), which on CUDA tensors
runs the popcount window-order kernel and the BT counter.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

from ..dist.ordered_collectives import gradient_wire_report
from ..optim import AdamW, clip_by_global_norm
from ..tree import leaves, map_leaves, unflatten

__all__ = ["TrainState", "TrainStep", "make_train_step", "init_state",
           "value_and_grad"]

_F32 = torch.float32


class TrainState(NamedTuple):
    params: object
    opt: object


def init_state(params, optimizer: AdamW) -> TrainState:
    return TrainState(params, optimizer.init(params))


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): ``loss_fn(params, batch)`` detached, and its gradient
    with respect to every leaf of ``params`` in the tree's structure (a
    leaf the loss does not reach gets zeros)."""
    xs = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, xs), batch)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
    return loss.detach(), unflatten(params, gs)


def make_train_step(loss_fn: Callable, optimizer: AdamW, *,
                    max_grad_norm: float = 1.0,
                    microbatches: int = 1,
                    wire_telemetry: bool = False) -> "TrainStep":
    """loss_fn(params, batch) -> scalar. Returns step(state, batch) ->
    (state, metrics), a ``TrainStep``. ``microbatches`` > 1 splits the batch
    on axis 0 and accumulates grads in float32 (activation-memory lever).

    On CUDA tensors the step - forward, backward, clip and update - is
    captured into one CUDA graph at the first call and replayed after: the
    same kernels on the same inputs, so the same bits, without the host's
    per-operation launches (an eager step of the full-width xLSTM launches
    about 190,000 kernels). Every later call must then pass a state and
    batch of the first call's structure, shapes, dtypes and devices. On
    any other device the step runs eagerly. ``step.core(state, batch)`` is
    the eager step on any device: (new state, metrics without the wire
    report, clipped grads). The wire report runs eagerly after either.
    """

    def accumulate(params, batch):
        acc = map_leaves(lambda p: torch.zeros(p.shape, dtype=_F32,
                                               device=p.device), params)
        loss_sum = None
        for i in range(microbatches):
            mb = map_leaves(lambda x: x[i * (x.shape[0] // microbatches):
                                        (i + 1) * (x.shape[0]
                                                   // microbatches)], batch)
            loss, g = value_and_grad(loss_fn, params, mb)
            acc = unflatten(acc, [a + b.to(_F32) for a, b in
                                  zip(leaves(acc), leaves(g))])
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum / microbatches, map_leaves(
            lambda a: a / microbatches, acc)

    def core(state: TrainState, batch):
        """(new state, metrics without the wire report, clipped grads)."""
        if microbatches > 1:
            loss, grads = accumulate(state.params, batch)
        else:
            loss, grads = value_and_grad(loss_fn, state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        new_params, new_opt = optimizer.update(grads, state.opt,
                                               state.params)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": optimizer.lr_fn(state.opt.step + 1)}
        return TrainState(new_params, new_opt), metrics, grads

    return TrainStep(core, wire_telemetry)


class TrainStep:
    """A train step: eager off the card, captured into one CUDA graph at
    its first call on CUDA tensors (``graph``; ``capture_s`` the seconds
    of the eager warm-up and of the capture).

    The capture reads its inputs from static copies of the first call's
    state and batch; each call copies its state and batch into them,
    replays, and returns copies of the graph's outputs (a later replay
    overwrites the graph's own memory)."""

    def __init__(self, core: Callable, wire_telemetry: bool):
        self.core = core
        self.wire_telemetry = wire_telemetry
        self.graph = None
        self.capture_s = None

    def _capture(self, state, batch) -> None:
        self.inputs = map_leaves(torch.clone, (state, batch))
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):       # warm-up: workspaces, handles
            self.core(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = self.core(*self.inputs)
        torch.cuda.synchronize()
        # seconds of the eager warm-up and of the capture (instantiation
        # included)
        self.capture_s = {"warmup": t1 - t0,
                          "capture": time.perf_counter() - t1}

    def _replay(self, state, batch):
        given = leaves((state, batch))
        static = leaves(self.inputs)
        if len(given) != len(static) or any(
                a.shape != b.shape or a.dtype != b.dtype
                or a.device != b.device for a, b in zip(given, static)):
            raise ValueError("a captured train step takes the state and "
                             "batch structure, shapes, dtypes and devices "
                             "of its first call")
        for dst, src in zip(static, given):
            if dst is not src:
                dst.copy_(src)
        self.graph.replay()
        return map_leaves(torch.clone, self.outputs)

    def __call__(self, state: TrainState, batch):
        xs = leaves((state, batch))
        if self.graph is None and not (xs and all(x.is_cuda for x in xs)):
            new_state, metrics, grads = self.core(state, batch)
            params = state.params
        else:
            if self.graph is None:
                self._capture(state, batch)
            new_state, metrics, grads = self._replay(state, batch)
            params = self.inputs[0].params
        if self.wire_telemetry:
            metrics["wire"] = gradient_wire_report(grads, params)
        return new_state, metrics
