"""peak_mem_gib.train: ``torch.cuda.max_memory_allocated`` over the window
(the peak statistics are reset when set-up ends), in GiB."""


def read(ctx):
    peak = ctx.device.get("memory_peak_bytes")
    if not peak:
        return None
    return peak / 2 ** 30
