"""Bit-transition metrics and the paper's expected-BT model (Sec. III).

* **Measured BT** - exact transition counts on a concrete flit stream (the
  paper's Fig. 8 recorder). On a CUDA stream ``bt_stream`` goes through the
  Hopper BT-counter kernel.
* **Expected BT** - the i.i.d.-bit model of Eqs. (1)-(3);
  ``pairing_objective`` is the F = sum(x_i * y_i) of Eq. (4). Over a
  stream, Eq. (3) is S1 - 2 S2 / b with S1 = sum(x + y) and S2 = sum(x y)
  over the pairs of words that share a lane on consecutive flits: on a CUDA
  stream ``stream_sums`` takes both with the BT total in one launch of the
  BT-counter kernel and one read, and ``expected_bt`` forms the figure on
  the host, for the card and the CPU alike.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .bits import bits_of, transitions
from .flits import FlitStream

__all__ = [
    "bt_between",
    "bt_stream",
    "bt_per_flit",
    "per_flit",
    "bt_per_position",
    "ones_prob_per_position",
    "expected_bt_pair",
    "expected_bt",
    "expected_bt_stream",
    "stream_sums",
    "pairing_objective",
    "reduction_rate",
]


def bt_between(flit_a: torch.Tensor, flit_b: torch.Tensor) -> torch.Tensor:
    """Total bit transitions when ``flit_b`` follows ``flit_a`` on the link."""
    return transitions(flit_a, flit_b).sum(dtype=torch.int32)


def bt_stream(stream: FlitStream) -> torch.Tensor:
    """Total BTs over a stream of consecutive flits (int32 scalar; one
    BT-counter launch on the card)."""
    from repro_torch.kernels import ops
    return ops.bt_total(stream.words)


def bt_per_flit(stream: FlitStream) -> torch.Tensor:
    """Average BTs per flit boundary - the paper's Tab. I metric (float32
    scalar on the stream's device; the division is :func:`per_flit`'s, on
    the host, as ``wire.measure`` forms it)."""
    return torch.tensor(
        per_flit(int(bt_stream(stream)), stream.words.shape[0]),
        dtype=torch.float32, device=stream.words.device)


def per_flit(total: int, num_flits: int) -> float:
    """``total`` BTs (an int32 read to the host) of a ``num_flits``-flit
    stream per flit boundary, divided in float32."""
    return float(np.float32(total) / np.float32(max(num_flits - 1, 1)))


def bt_per_position(stream: FlitStream) -> torch.Tensor:
    """Probability of a transition at each bit position within a value
    (paper Figs. 10-11, bottom)."""
    bits = bits_of(stream.words)              # (nf, lanes, nbits)
    tog = bits[:-1] ^ bits[1:]
    return tog.to(torch.float32).mean(dim=(0, 1))


def ones_prob_per_position(stream: FlitStream) -> torch.Tensor:
    """Probability of a '1' at each bit position (paper Figs. 10-11 top)."""
    return bits_of(stream.words).to(torch.float32).mean(dim=(0, 1))


def expected_bt_pair(x: torch.Tensor, y: torch.Tensor,
                     value_bits: int) -> torch.Tensor:
    """Eq. (2) for ``value_bits`` = b: E = x + y - 2xy/b."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    return x + y - 2.0 * x * y / value_bits


def stream_sums(stream: FlitStream) -> Tuple[int, int, int]:
    """``(total BT, S1, S2)`` of a stream, read to the host at once: the BT
    total as ``bt_stream`` gives it, S1 = sum(x + y) and S2 = sum(x y) over
    the word pairs sharing a lane on consecutive flits (one launch and one
    read on the card)."""
    from repro_torch.kernels import ops
    total, s1, s2 = ops.bt_measure(stream.words).tolist()
    return total, s1, s2


def expected_bt(s1: int, s2: int, value_bits: int) -> float:
    """Eq. (3) summed over a stream from its sums (``stream_sums``):
    S1 - 2 S2 / b, exact in float64 at any stream size the port makes
    (below 2^53), rounded once to float32."""
    return float(np.float32(s1 - 2.0 * s2 / value_bits))


def expected_bt_stream(stream: FlitStream) -> torch.Tensor:
    """Eq. (3) summed over every consecutive flit pair of the stream
    (float32 scalar on the stream's device)."""
    _, s1, s2 = stream_sums(stream)
    return torch.tensor(expected_bt(s1, s2, stream.value_bits),
                        dtype=torch.float32, device=stream.words.device)


def pairing_objective(x_counts: torch.Tensor,
                      y_counts: torch.Tensor) -> torch.Tensor:
    """F = sum_i x_i * y_i (Eq. 4)."""
    return (x_counts.to(torch.float32) * y_counts.to(torch.float32)).sum()


def reduction_rate(baseline, optimized):
    """BT reduction rate = 1 - optimized/baseline."""
    return 1.0 - optimized / baseline
