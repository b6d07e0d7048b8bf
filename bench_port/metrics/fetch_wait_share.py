"""``fetch_wait_share``: the sweep's host time waiting on the fetch of the
counts, from its ``on_window``, over the window, %."""

def read(ctx):
    return ctx.layer.get("fetch_wait_share")
