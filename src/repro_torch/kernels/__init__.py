"""The port's Hopper kernels and their plain PyTorch versions.

Three of the reference's six Pallas kernels are ported: ``router_step``,
``popcount`` and ``bt_count`` (each a ``csrc/*.cu`` source and a wrapper
module of the same name). ``ops`` dispatches a CUDA tensor to the kernel
and a CPU tensor to its plain version in ``ref``; ROADMAP.md queue B lists
the kernels still to port.
"""
