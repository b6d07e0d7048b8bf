"""``dispatch_ms_per_batch``: the sweep's host time dispatching, from its
``on_window(dispatch_s, fetch_s, batches)``, over the batches fetched in
the window, in ms."""

def read(ctx):
    return ctx.layer.get("dispatch_ms_per_batch")
