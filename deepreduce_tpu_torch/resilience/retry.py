"""Host-side retry with deterministic exponential backoff.

A copy of `deepreduce_tpu/resilience/retry.py`, which imports nothing but
the standard library: the port keeps its own copy rather than importing
the JAX package. It wraps the checkpoint's reads and writes
(`checkpoint.py`) against transient I/O failures.

Backoff is deterministic (no jitter): delays are `base_delay * multiplier
** attempt` capped at `max_delay`, so tests can assert the exact sleep
sequence. Single-process single-writer I/O has no thundering-herd problem
for jitter to solve.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Tuple, Type, TypeVar

T = TypeVar("T")

# the transient-I/O family: OSError covers IOError/FileNotFoundError-on-NFS
# races/disk-full; callers widen retry_on explicitly if needed
DEFAULT_RETRY_ON: Tuple[Type[BaseException], ...] = (OSError,)


def retry_call(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base_delay: float = 0.05,
    multiplier: float = 2.0,
    max_delay: float = 2.0,
    retry_on: Tuple[Type[BaseException], ...] = DEFAULT_RETRY_ON,
    sleep: Callable[[float], None] = time.sleep,
    on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
) -> T:
    """Call ``fn()``; on a `retry_on` exception, back off and try again.

    Re-raises the last exception after `attempts` total tries. Exceptions
    outside `retry_on` propagate immediately (a corrupt checkpoint is not
    transient). `on_retry(attempt, exc, delay)` fires before each sleep —
    the hook tests attach to.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    delay = base_delay
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except retry_on as exc:
            if attempt == attempts:
                raise
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            sleep(delay)
            delay = min(delay * multiplier, max_delay)
    raise AssertionError("unreachable")  # pragma: no cover


def retry_io(fn: Callable[[], T], **kwargs) -> T:
    """`retry_call` with the default transient-I/O policy — the form the
    checkpoint's call sites use."""
    return retry_call(fn, **kwargs)
