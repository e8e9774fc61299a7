from .fixed_point import FixedPointParams, dequantize_fixed8, quantize_fixed8

__all__ = ["FixedPointParams", "quantize_fixed8", "dequantize_fixed8"]
