"""Host-side resilience of the port: `retry.retry_io` (transient I/O)."""
