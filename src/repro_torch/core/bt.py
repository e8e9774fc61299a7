"""Bit-transition metrics and the paper's expected-BT model (Sec. III).

* **Measured BT** - exact transition counts on a concrete flit stream (the
  paper's Fig. 8 recorder). On a CUDA stream ``bt_stream`` goes through the
  Hopper BT-counter kernel.
* **Expected BT** - the i.i.d.-bit model of Eqs. (1)-(3);
  ``pairing_objective`` is the F = sum(x_i * y_i) of Eq. (4).
"""
from __future__ import annotations

import torch

from .bits import bits_of, popcount, transitions
from .flits import FlitStream

__all__ = [
    "bt_between",
    "bt_stream",
    "bt_per_flit",
    "per_flit",
    "bt_per_position",
    "ones_prob_per_position",
    "expected_bt_pair",
    "expected_bt_stream",
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
    """Average BTs per flit boundary - the paper's Tab. I metric."""
    return per_flit(bt_stream(stream), stream.words.shape[0])


def per_flit(total: torch.Tensor, num_flits: int) -> torch.Tensor:
    """``total`` BTs of a ``num_flits``-flit stream per flit boundary."""
    return total / max(num_flits - 1, 1)


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


def expected_bt_stream(stream: FlitStream) -> torch.Tensor:
    """Eq. (3) summed over every consecutive flit pair of the stream."""
    c = popcount(stream.words)                # (nf, lanes)
    return expected_bt_pair(c[:-1], c[1:], stream.value_bits).sum()


def pairing_objective(x_counts: torch.Tensor,
                      y_counts: torch.Tensor) -> torch.Tensor:
    """F = sum_i x_i * y_i (Eq. 4)."""
    return (x_counts.to(torch.float32) * y_counts.to(torch.float32)).sum()


def reduction_rate(baseline, optimized):
    """BT reduction rate = 1 - optimized/baseline."""
    return 1.0 - optimized / baseline
