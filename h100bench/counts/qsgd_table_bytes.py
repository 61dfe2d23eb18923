"""Bytes of one QSGD segment table (frozen from the port's smoke script's
`_table_bytes`): each live value read once (4 B), each row written once
(bucket_size level bytes and a 4-byte norm per bucket), with the bucket
count recomputed here."""

from __future__ import annotations

from typing import Iterable


def num_buckets(k: int, bucket_size: int) -> int:
    return (k + bucket_size - 1) // bucket_size


def table_bytes(segment_lengths: Iterable[int], bucket_size: int) -> int:
    lengths = list(segment_lengths)
    buckets = sum(num_buckets(k, bucket_size) for k in lengths)
    return 4 * sum(lengths) + buckets * bucket_size + 4 * buckets
