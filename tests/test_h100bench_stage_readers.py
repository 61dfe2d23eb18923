"""The benchmark's readers of the port's exchange stages
(`h100bench/metrics/sparsify_host_ms.py`, `index_codec_host_ms.py`,
`index_codec_idle_share.py`) on synthetic digests of `h100bench.trace`'s
form: known spans and idle gaps give known milliseconds and shares, and a
digest without the stage spans (a program that has none) or without device
operations (a run off the card) gives None."""

import importlib

import pytest

MS = 1_000_000  # ns


def _digest(stages: bool) -> dict:
    """Two steps in a 100 ms window: the exchange's spans, with or without
    the stage spans inside, and the idle gaps named by the innermost span."""
    spans = {"train/exchange": [(0, 40 * MS), (50 * MS, 90 * MS)],
             "exchange/encode": [(1 * MS, 20 * MS), (51 * MS, 70 * MS)],
             "exchange/decode": [(21 * MS, 39 * MS), (71 * MS, 89 * MS)]}
    gaps = [("train/exchange", 1 * MS), ("exchange/encode", 2 * MS), ("exchange/decode", 3 * MS)]
    if stages:
        spans.update({
            "exchange/encode/sparsify": [(1 * MS, 4 * MS), (51 * MS, 55 * MS)],
            "exchange/encode/index": [(4 * MS, 19 * MS), (55 * MS, 69 * MS)],
            "exchange/decode/index": [(22 * MS, 37 * MS), (72 * MS, 88 * MS)],
            "exchange/decode/sum": [(37 * MS, 39 * MS), (88 * MS, 89 * MS)],
        })
        gaps += [("exchange/encode/index", 11 * MS), ("exchange/decode/index", 14 * MS),
                 ("exchange/encode/sparsify", 2 * MS), ("exchange/decode/sum", 1 * MS)]
    return {"device": [], "spans": spans, "window_ns": 100 * MS, "busy_ns": 60 * MS, "gaps": gaps, "steps": 2}


def _read(metric: str, digest: dict):
    return importlib.import_module(f"h100bench.metrics.{metric}").read({"digest": digest})


@pytest.mark.parametrize("metric, want", [
    ("sparsify_host_ms", (3 + 4) / 2),
    ("index_codec_host_ms", (15 + 14 + 15 + 16) / 2),
    ("index_codec_idle_share", 100.0 * (11 + 14) / 100),
])
def test_a_digest_with_the_stages_reads_its_spans_and_gaps(metric, want):
    assert _read(metric, _digest(True)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", ["sparsify_host_ms", "index_codec_host_ms", "index_codec_idle_share"])
def test_a_digest_without_the_stages_reads_none(metric):
    assert _read(metric, _digest(False)) is None


@pytest.mark.parametrize("metric", ["sparsify_host_ms", "index_codec_host_ms", "index_codec_idle_share"])
def test_a_digest_without_device_operations_reads_none(metric):
    d = _digest(True)
    d["busy_ns"] = 0
    assert _read(metric, d) is None


def test_the_idle_share_reads_zero_when_the_card_never_waited_in_the_index_codec():
    d = _digest(True)
    d["gaps"] = [g for g in d["gaps"] if not g[0].endswith("/index")]
    assert _read("index_codec_idle_share", d) == 0.0
