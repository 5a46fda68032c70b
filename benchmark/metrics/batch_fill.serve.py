"""batch_fill.serve: the ``DynamicBatcher``'s valid rows over dispatched
rows (``ServerStats.batch_fill / batch_rows``) over the window."""


def read(ctx):
    rows = ctx.counters.get("batch_rows")
    if not rows:
        return None
    return 100.0 * ctx.counters["batch_fill"] / rows
