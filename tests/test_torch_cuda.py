"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips on a machine without CUDA (such as a
CPU-only test runner) and runs on the GPU with
`python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest` (the
repository's conftest imports jax, which the GPU machine need not have)."""

import pytest
import torch

from deepreduce_tpu_torch.ops import philox_uniforms_plain, quantize_levels, quantize_levels_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [1, 5, 1536, 114_688, 1_000_003])
def test_qsgd_kernel_bitwise_equals_plain(cuda, n):
    gen = torch.Generator().manual_seed(n)
    v = torch.randn(n, generator=gen)
    v[torch.rand(n, generator=gen) < 0.3] = 0.0
    s = torch.rand(n, generator=gen) * 200
    seed, offset = (7 << 32) | n, (3 << 32) | 1
    before = quantize_levels.launches
    got = quantize_levels(v.to(cuda), s.to(cuda), seed, offset, device=cuda)
    torch.cuda.synchronize()
    assert quantize_levels.launches == before + 1
    ref = quantize_levels_plain(v, s, philox_uniforms_plain(n, seed, offset))
    assert torch.equal(got.cpu(), ref)


def test_qsgd_kernel_rejects_cpu_tensors_and_bad_dtypes(cuda):
    v = torch.zeros(8)
    with pytest.raises(ValueError):
        quantize_levels(v, v, 0, 0, device=cuda)
    with pytest.raises(ValueError):
        quantize_levels(v.to(cuda).half(), v.to(cuda).half(), 0, 0, device=cuda)
