"""Per-layer metric readers, one module per metric of `BENCHMARK.json`'s
`per_layer`, each with `read(ctx) -> float | None`. `ctx` holds the traced
stretch's digest (`trace.digest`), the untraced stretch's rate and the
counts of the cell (`run.reader_context`). A reader that finds nothing to
read returns None and the metric is left out of the line."""
