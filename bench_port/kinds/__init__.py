"""The kinds of traffic: one module a kind, named by a traffic file's
``kind``.  Each defines ``Run(config, traffic, seed, device, root)`` with
``setup()``, ``measure(window, seconds)``, ``end_to_end()``,
``release()``, ``check(**override)`` and ``layer`` (what the per-layer
readers read)."""
