"""Mean host milliseconds a dispatch call holds the caller (the harness's
span around it: staging copy and enqueue; for ``process_chunks`` also the
wait for and formatting of the chunk before's results)."""


def read(ctx):
    spans = ctx.spans.get("dispatch")
    return 1e3 * sum(spans) / len(spans) if spans else None
