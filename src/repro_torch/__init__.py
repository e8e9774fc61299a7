"""PyTorch/CUDA port of the BT-ordering NoC system (reference: ``repro``).

First slice: the paper's main path - LeNet inference -> per-layer operand
traffic -> O0/O1/O2 ordering -> paired-flit packetization -> cycle-level
X-Y mesh drain with the Fig. 8 BT recorder -> ``run_sweep`` rows - plus the
no-NoC (Tab. I) recorder - and the O3/O3a chains. The hot loop (router
step), the orderings (popcount window order, O3 chain) and the no-NoC
recorder (BT counter) run as hand-written Hopper kernels on CUDA tensors
(``repro_torch.kernels``); CPU tensors take their plain PyTorch versions.

Entry points run on CUDA unless the caller passes ``device="cpu"``. This
package imports neither ``jax`` nor ``repro``.
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
