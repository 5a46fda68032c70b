"""step_host_ms.train: the host milliseconds of one call to the ``step``
that ``make_train_step`` returns (it does not synchronise, so this is the
time to enqueue a step), the mean over the calls in the window's untraced
rest."""


def read(ctx):
    spans = ctx.spans("step")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
