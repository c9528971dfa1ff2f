"""Traffic generators, one module a generator, named by a traffic file's
``generator`` key.  ``make(traffic, config, rng, root)`` returns a
``cellbench.pool.Pool``."""
