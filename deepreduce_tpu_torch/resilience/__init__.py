"""The port's resilience subsystem: `faults` (participation masks from a
`FaultPlan` and i.i.d. dropout), `chaos` (payload perturbation at the wire
boundary, detected by the checksum word of `comm.PayloadLayout`), `stream`
(their counter-based draws) and `retry` (host-side backoff for the
checkpoint's I/O). `python -m deepreduce_tpu_torch.resilience check|sweep`
drives the compressed exchange under those faults."""
