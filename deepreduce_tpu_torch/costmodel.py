"""Static wire accounting of the sparse_rs routes, ported from
`deepreduce_tpu/costmodel.py` (`rs_wire_bytes`, `rs_payload_bytes`) for
the ported modes. Only what `GradientExchanger.payload_bytes` needs: the
cost model's timing fits and `select_rs_mode` (rs_mode='auto') are not
ported."""

from __future__ import annotations

from typing import Dict

from deepreduce_tpu_torch import sparse_rs


def rs_wire_bytes(
    mode: str,
    d: int,
    W: int,
    ratio: float,
    *,
    headroom: float = 2.0,
    out_headroom: float = 1.0,
    block: int = 256,
    bins: int = 4096,
    cap_headroom: float = 2.0,
    masked: bool = False,
) -> Dict[str, float]:
    """Per-collective injection bytes of one worker for one route, keyed
    by the collective's name in the JAX package's trace. `masked` prices
    the participation-mask variants: the quantized route adds one int8
    all_gather of the summed shard (the other layouts are unchanged)."""
    B = sparse_rs.send_budget(d, ratio, W, headroom)
    K2 = sparse_rs.out_budget(d, ratio, W, out_headroom)
    if mode == "sparse":
        return {"all_to_all": W * B * 8.0, "all_gather": K2 * 8.0}
    if mode == "adaptive":
        L = sparse_rs.adaptive_lanes(d, ratio, W, out_headroom, block)
        return {"all_to_all": W * B * 8.0, "all_gather": (L + 1) * 4.0}
    if mode == "quantized":
        n = sparse_rs.padded_shard(d, W, block) * W
        extra = (n // W) * 1.0 if masked else 0.0
        return {"pmax": (n // block) * 4.0, "psum_scatter": n * 1.0, "all_gather": K2 * 8.0 + extra}
    if mode == "oktopk":
        Bo = sparse_rs.oktopk_send_budget(d, ratio, W, cap_headroom)
        return {"psum": bins * 4.0, "all_to_all": W * Bo * 8.0, "all_gather": K2 * 8.0}
    raise ValueError(f"rs_mode={mode!r} is not ported (ported: {list(sparse_rs.RS_MODES)})")


def rs_payload_bytes(mode: str, d: int, W: int, ratio: float, **kw) -> float:
    """Total per-worker injection bytes of one route."""
    return float(sum(rs_wire_bytes(mode, d, W, ratio, **kw).values()))
