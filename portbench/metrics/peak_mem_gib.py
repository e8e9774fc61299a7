"""The most device memory the allocator held in the window
(``max_memory_allocated`` after a reset at its start), in GiB."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
