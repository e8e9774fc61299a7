from .pipeline import GLYPHS, TokenStream, glyph_batch, zipf_tokens

__all__ = ["TokenStream", "zipf_tokens", "glyph_batch", "GLYPHS"]
