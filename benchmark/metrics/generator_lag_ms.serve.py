"""generator_lag_ms.serve: the 95th percentile of how late the open-loop
sender submitted a request after its scheduled time."""

from benchmark.harness import quantile


def read(ctx):
    lag = ctx.counters.get("send_lag_s")
    if not lag:
        return None
    return 1e3 * quantile(lag, 0.95)
