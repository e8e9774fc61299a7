"""Work of the forward pass: a multiply and an add per operand pair of
every neuron (the conv and linear layers' (n, k) operand rows), divided by
the float32 rate outside the tensor cores (the forward runs with TF32
off)."""

PEAK = "fp32_flops_per_s"
KERNEL = None


def flops(layer_shapes) -> int:
    return sum(2 * n * k for n, k in layer_shapes)


def least_seconds(ctx, sweep) -> float:
    return flops(ctx.layer_shapes) / ctx.peaks[PEAK]
