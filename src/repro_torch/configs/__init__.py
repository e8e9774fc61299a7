"""Architecture registry: the ten assigned archs (the port of
``repro.configs``).

``get(name)`` -> ArchDef; ``ARCHS`` lists every selectable --arch id.
"""
from .common import (SHAPES, ArchDef, ShapeCell, cache_pspecs,
                     cache_shardings)

from .minicpm_2b import ARCH as minicpm_2b
from .phi3_medium_14b import ARCH as phi3_medium_14b
from .starcoder2_15b import ARCH as starcoder2_15b
from .h2o_danube_3_4b import ARCH as h2o_danube_3_4b
from .internvl2_1b import ARCH as internvl2_1b
from .whisper_medium import ARCH as whisper_medium
from .kimi_k2_1t_a32b import ARCH as kimi_k2_1t_a32b
from .mixtral_8x7b import ARCH as mixtral_8x7b
from .recurrentgemma_9b import ARCH as recurrentgemma_9b
from .xlstm_125m import ARCH as xlstm_125m

ARCHS = {a.name: a for a in [
    minicpm_2b, phi3_medium_14b, starcoder2_15b, h2o_danube_3_4b,
    internvl2_1b, whisper_medium, kimi_k2_1t_a32b, mixtral_8x7b,
    recurrentgemma_9b, xlstm_125m,
]}


def get(name: str) -> ArchDef:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ArchDef", "SHAPES", "ShapeCell", "ARCHS", "get", "cache_pspecs",
           "cache_shardings"]
