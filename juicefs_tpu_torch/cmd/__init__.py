"""Commands of the port. Only the `gc --dedup` scan leg (`gc.dedup_scan`)
is ported so far; the CLI wrapper waits for the meta engines."""
