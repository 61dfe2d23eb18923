"""Port parity: the QSGD quantizer's plain version and codec against the
JAX package on the CPU. Inputs are numpy arrays from a seed; the JAX
package's uniforms are injected where the comparison is bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepreduce_tpu.codecs import qsgd as jqsgd
from deepreduce_tpu.ops.qsgd_kernel import quantize_levels_xla
from deepreduce_tpu.sparse import SparseGrad as JSparseGrad
from deepreduce_tpu_torch.codecs import qsgd as tqsgd
from deepreduce_tpu_torch.ops import (
    philox_uniforms_plain,
    quantize_levels,
    quantize_levels_plain,
)
from deepreduce_tpu_torch.ops.qsgd_kernel import philox4x32_10
from deepreduce_tpu_torch.sparse import SparseGrad


def _t(a):
    return torch.from_numpy(np.array(a))


def _values(n, seed, zeros=0.3):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n).astype(np.float32)
    v[rng.random(n) < zeros] = 0.0
    return v


@pytest.mark.parametrize("seed,n", [(0, 1536), (1, 5000), (2, 513)])
def test_plain_quantizer_equals_xla_given_jax_uniforms(seed, n):
    v = _values(n, seed)
    bs = 512
    b = (n + bs - 1) // bs
    padded = np.zeros(b * bs, np.float32)
    padded[:n] = v
    # one bucket holding a single nonzero: |v|*scale lands at q up to an ulp,
    # the saturating-convert corner
    padded[:bs] = 0.0
    padded[7] = -3.25
    scale, _ = jqsgd.bucket_scale(jnp.asarray(padded), 127, bs)
    key = jax.random.PRNGKey(seed + 11)
    u = jax.random.uniform(key, padded.shape)
    ref = np.asarray(quantize_levels_xla(jnp.asarray(padded), scale, key))
    got = quantize_levels_plain(_t(padded), _t(scale), _t(u))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_philox_known_answers():
    # Random123's published Philox-4x32-10 known-answer vectors
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        (
            (0xFFFFFFFF,) * 4,
            (0xFFFFFFFF, 0xFFFFFFFF),
            (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD),
        ),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ]
    for ctr, key, want in cases:
        out = philox4x32_10(torch.tensor([ctr], dtype=torch.int64), key[0] | (key[1] << 32))
        assert tuple(out[0].tolist()) == want


def test_philox_uniforms_deterministic_and_in_range():
    seed, offset = (0x1234 << 32) | 99, (7 << 32) | 3
    a = philox_uniforms_plain(10_003, seed, offset)
    np.testing.assert_array_equal(a.numpy(), philox_uniforms_plain(10_003, seed, offset).numpy())
    # counter-based: a shorter draw is a prefix of a longer one
    np.testing.assert_array_equal(a[:4001].numpy(), philox_uniforms_plain(4001, seed, offset).numpy())
    assert not torch.equal(a, philox_uniforms_plain(10_003, seed, offset + 1))
    assert not torch.equal(a, philox_uniforms_plain(10_003, seed + 1, offset))
    assert a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    # 24-bit grid: u * 2**24 is an integer
    np.testing.assert_array_equal((a.double() * 2**24).numpy() % 1, 0)
    assert abs(float(a.double().mean()) - 0.5) < 5 * (1 / 12) ** 0.5 / 10_003**0.5


def test_quantizer_unbiased_and_bounded():
    q, bs, draws = 127, 512, 400
    v = torch.from_numpy(_values(bs, 5))
    norm = float(torch.linalg.vector_norm(v.double()))
    scale = torch.full((bs,), q / norm, dtype=torch.float32)
    acc = torch.zeros(bs, dtype=torch.float64)
    for s in range(draws):
        lv = quantize_levels(v, scale, seed=1234, offset=s, device="cpu")
        assert int(lv.abs().max()) <= q
        acc += lv.double() * norm / q
    mean = acc / draws
    # per-draw error of one element is within one level (norm/q) and the
    # rounding is Bernoulli: sd <= (norm/q)/2, so 6 sd of the mean bounds it
    bound = 6 * (norm / q) / 2 / draws**0.5
    assert float((mean - v.double()).abs().max()) < bound


def test_quantize_levels_wrapper_checks_inputs():
    v = torch.zeros(8)
    with pytest.raises(ValueError):
        quantize_levels(v.double(), v.double(), 0, 0, device="cpu")
    with pytest.raises(ValueError):
        quantize_levels(v, torch.zeros(7), 0, 0, device="cpu")
    with pytest.raises(ValueError):
        quantize_levels(v, v, -1, 0, device="cpu")


@pytest.mark.parametrize("k", [700, 1536, 3001])
def test_qsgd_encode_decode_matches_jax(k):
    vals = _values(k, k, zeros=0.1)
    jmeta = jqsgd.QSGDMeta(k=k)
    tmeta = tqsgd.QSGDMeta(k=k)
    assert tmeta.payload_len == jmeta.payload_len and tmeta.level_bits == jmeta.level_bits
    key = jax.random.PRNGKey(k)
    jsp = JSparseGrad(
        values=jnp.asarray(vals), indices=jnp.arange(k, dtype=jnp.int32),
        nnz=jnp.asarray(k, jnp.int32), shape=(k,),
    )
    jpay = jqsgd.encode(jsp, jmeta, key)
    u = np.asarray(jax.random.uniform(key, (jmeta.num_buckets * jmeta.bucket_size,)))
    tsp = SparseGrad(
        values=torch.from_numpy(vals), indices=torch.arange(k, dtype=torch.int32),
        nnz=torch.tensor(k, dtype=torch.int32), shape=(k,),
    )
    tpay = tqsgd.encode(tsp, tmeta, 0, 0, uniforms=_t(u))
    b, bs = jmeta.num_buckets, jmeta.bucket_size
    jrows = np.asarray(jpay.data).reshape(b, bs + 4)
    trows = tpay.data.numpy().reshape(b, bs + 4)
    jnorm = jrows[:, bs:].copy().view(np.float32).reshape(b)
    tnorm = trows[:, bs:].copy().view(np.float32).reshape(b)
    np.testing.assert_allclose(tnorm, jnorm, rtol=1e-6)
    # levels: bitwise in every bucket whose float32 norm came out identical;
    # elsewhere a one-ulp scale difference may move a level by at most one
    same = tnorm == jnorm
    np.testing.assert_array_equal(trows[same, :bs], jrows[same, :bs])
    assert np.abs(trows[:, :bs].astype(int) - jrows[:, :bs].astype(int)).max() <= 1
    # decode of the JAX bytes is bitwise the JAX decode
    tdec = tqsgd.decode(
        tqsgd.QSGDPayload(data=_t(jpay.data), indices=tsp.indices, nnz=tsp.nnz),
        tmeta, (k,),
    )
    jdec = jqsgd.decode(jpay, jmeta, (k,))
    np.testing.assert_array_equal(tdec.values.numpy(), np.asarray(jdec.values))
    assert float(tqsgd.wire_bits(tpay, tmeta)) == float(jqsgd.wire_bits(jpay, jmeta))
