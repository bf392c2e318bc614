"""Load generators, one module per kind of traffic; a traffic file names
its driver. Each module has `setup(ctx)`, `window(state, ctx, trace)`,
`check(state, ctx)` and `close(state)` (see `portbench/run.py`)."""
