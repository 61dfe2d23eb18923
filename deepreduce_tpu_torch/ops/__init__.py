"""Hand-written CUDA kernels of the port, each beside its plain version."""

from typing import Dict

from deepreduce_tpu_torch.ops.qsgd_encode import (
    EncodeSegment,
    bucket_norms_ordered,
    bucket_sq_sums_ordered,
    qsgd_encode_floor,
    qsgd_encode_rows,
    qsgd_encode_rows_plain,
    scale_from_norms,
)
from deepreduce_tpu_torch.ops.qsgd_kernel import (
    philox_uniforms_plain,
    quantize_levels,
    quantize_levels_plain,
)

# kernel name -> its wrapper (each wrapper counts its own launches)
KERNELS = {"qsgd_quantize": quantize_levels, "qsgd_encode_rows": qsgd_encode_rows}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = [
    "EncodeSegment",
    "KERNELS",
    "bucket_norms_ordered",
    "bucket_sq_sums_ordered",
    "launch_counts",
    "philox_uniforms_plain",
    "qsgd_encode_floor",
    "qsgd_encode_rows",
    "qsgd_encode_rows_plain",
    "quantize_levels",
    "quantize_levels_plain",
    "reset_launch_counts",
    "scale_from_norms",
]
