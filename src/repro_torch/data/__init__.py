from .pipeline import GLYPHS, glyph_batch

__all__ = ["glyph_batch", "GLYPHS"]
