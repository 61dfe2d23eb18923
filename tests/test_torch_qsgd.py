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
    EncodeSegment,
    bucket_norms_ordered,
    bucket_sq_sums_ordered,
    philox_uniforms_plain,
    qsgd_encode_rows,
    qsgd_encode_rows_plain,
    quantize_levels,
    quantize_levels_plain,
    scale_from_norms,
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


def _per_leaf_rows(vals, bs, q, seed, offset, uniforms=None):
    """The per-leaf QSGD encode as the port's first slice composed it: zero
    padding, a float64 `sum` norm, `q / norm` through torch's reciprocal,
    the quantizer over a broadcast scale vector, then `cat` of the levels
    and the norm bytes into rows."""
    k = vals.shape[0]
    b = (k + bs - 1) // bs
    padded = torch.zeros(b * bs)
    padded[:k] = vals
    buckets = padded.reshape(b, bs)
    norms = buckets.double().square().sum(dim=1).sqrt().float()
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    scale = (q / safe)[:, None].expand(buckets.shape).reshape(-1)
    u = philox_uniforms_plain(b * bs, seed, offset) if uniforms is None else uniforms
    levels = quantize_levels_plain(padded, scale.contiguous(), u)
    return torch.cat([levels.reshape(b, bs), norms.view(torch.int8).reshape(b, 4)], dim=1).reshape(-1)


@pytest.mark.parametrize("bs", [512, 100])
@pytest.mark.parametrize("k", [1, 511, 512, 513, 700, 3001])
def test_encode_rows_plain_equals_per_leaf_composition(k, bs):
    vals = torch.from_numpy(_values(k, 40 + k, zeros=0.2) * np.float32(0.01 * k))
    seed, offset = (0xBEEF << 32) | k, (2 << 32) | bs
    want = _per_leaf_rows(vals, bs, 127, seed, offset)
    # rows written at an unaligned offset of a larger buffer; the bytes
    # around them stay untouched
    out = torch.full((want.shape[0] + 7,), 0x5A, dtype=torch.uint8)
    qsgd_encode_rows([EncodeSegment(vals, 3, seed, offset)], out, quantum_num=127, bucket_size=bs, device="cpu")
    np.testing.assert_array_equal(out[3:-4].view(torch.int8).numpy(), want.numpy())
    assert out[:3].eq(0x5A).all() and out[-4:].eq(0x5A).all()
    assert int(out[3:-4].view(torch.int8).reshape(-1, bs + 4)[:, :bs].int().abs().max()) <= 127


@pytest.mark.parametrize("bs", [512, 100])
def test_encode_rows_grouped_table_equals_each_leaf(bs):
    """One call over a mixed table (sizes around the bucket edges, one
    segment with injected uniforms, gaps between the rows) writes what each
    leaf's own composition writes."""
    rng = np.random.default_rng(bs)
    ks = [1536, 1, 513, 8192, 777, 2 * bs, 5]
    segs, wants, off = [], [], 0
    for i, k in enumerate(ks):
        vals = torch.from_numpy(_values(k, 100 + i))
        b = (k + bs - 1) // bs
        u = torch.from_numpy(rng.random(b * bs).astype(np.float32)) if i == 3 else None
        seed, offset = 1000 + i, (i << 32) | 9
        segs.append(EncodeSegment(vals, off, seed, offset, uniforms=u))
        wants.append((off, _per_leaf_rows(vals, bs, 127, seed, offset, uniforms=u)))
        off += b * (bs + 4) + 4 * (i % 2)
    out = torch.zeros(off, dtype=torch.int8)
    qsgd_encode_rows(segs, out, quantum_num=127, bucket_size=bs, device="cpu")
    for lo, want in wants:
        np.testing.assert_array_equal(out[lo : lo + want.shape[0]].numpy(), want.numpy())
    plain = torch.zeros_like(out)
    qsgd_encode_rows_plain(segs, 127, bs, plain)
    assert torch.equal(plain, out)


@pytest.mark.parametrize(
    "bs,seed", [(512, 0), (512, 1), (100, 2), (1000, 3), (128, 4), (1024, 5), (2048, 6), (100, 7), (1000, 8)]
)
def test_bucket_norms_ordered_match_jax(bs, seed):
    rng = np.random.default_rng(seed)
    b = 9
    x = (rng.normal(size=b * bs) * rng.uniform(1e-3, 1e3, size=b * bs)).astype(np.float32)
    x[rng.random(b * bs) < 0.3] = 0.0
    x[:bs] = 0.0  # a zero bucket
    got = bucket_norms_ordered(_t(x), bs)
    assert got.dtype == torch.float32 and got.shape == (b,)
    want = np.asarray(jnp.linalg.norm(jnp.asarray(x).reshape(b, bs), axis=1))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # the float64 sum rounded once is the correctly rounded norm here
    exact = np.sqrt((x.astype(np.float64).reshape(b, bs) ** 2).sum(axis=1)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), exact)


def _pair_tree(values):
    """Adjacent pairs folded, x[2i] + x[2i+1], until one value is left."""
    while len(values) > 1:
        values = [values[2 * i] + values[2 * i + 1] for i in range(len(values) // 2)]
    return values[0]


def _kernel_tree(squares):
    """The sum of `squares` (Python floats) in the kernel's order, one IEEE
    double add at a time: zero-padded to 128 * J (J a power of two), element
    128 j + 4 l + i; each (j, l)'s four in pairs, then the J of each l, then
    the 32 l, in adjacent pairs."""
    n = max(128, 1 << (len(squares) - 1).bit_length())
    x = list(squares) + [0.0] * (n - len(squares))
    lanes = []
    for lane in range(32):
        chunks = []
        for j in range(n // 128):
            e = 128 * j + 4 * lane
            chunks.append((x[e] + x[e + 1]) + (x[e + 2] + x[e + 3]))
        lanes.append(_pair_tree(chunks))
    return _pair_tree(lanes)


def _lane_order_sum(squares):
    """The same sum in the kernel's earlier order: lane l of a warp adds the
    elements e with (e // 4) % 32 == l in increasing e, then the 32 lanes
    fold at 16, 8, 4, 2, 1."""
    acc = [0.0] * 32
    for e, x in enumerate(squares):
        acc[(e // 4) % 32] += x
    width = 32
    while width > 1:
        width //= 2
        acc = [acc[i] + acc[i + width] for i in range(width)]
    return acc[0]


@pytest.mark.parametrize("bs", [512, 100, 1000, 2048, 3])
def test_bucket_sum_follows_the_kernel_tree(bs):
    """On buckets whose float64 sum depends on the order (magnitudes 1e-30
    to 1e30 in one bucket), the sum before rounding is the kernel's
    log-depth tree's bit for bit, and the earlier lane order gives another
    sum."""
    rng = np.random.default_rng(bs)
    b = 8
    x = (rng.choice([-1.0, 1.0], size=b * bs) * 10.0 ** rng.uniform(-30, 30, size=b * bs)).astype(np.float32)
    got = bucket_sq_sums_ordered(_t(x), bs)
    assert got.dtype == torch.float64 and got.shape == (b,)
    squares = [[float(v) * float(v) for v in row] for row in x.reshape(b, bs)]
    want = [_kernel_tree(row) for row in squares]
    assert got.tolist() == want
    if bs > 4:
        assert any(w != _lane_order_sum(row) for w, row in zip(want, squares))
    np.testing.assert_array_equal(bucket_norms_ordered(_t(x), bs).numpy(), np.sqrt(np.array(want)).astype(np.float32))


def test_scale_from_norms_is_jax_divide():
    # given the same float32 norms, the scale equals JAX's `q / norm` bit for
    # bit (one IEEE divide), zero-norm guard included
    rng = np.random.default_rng(8)
    norms = (rng.uniform(0.01, 100.0, size=4096)).astype(np.float32)
    norms[::97] = 0.0
    safe = jnp.where(jnp.asarray(norms) > 0, jnp.asarray(norms), 1.0)
    np.testing.assert_array_equal(scale_from_norms(_t(norms), 127).numpy(), np.asarray(127 / safe))


@pytest.mark.parametrize(
    "case",
    ["out_dtype", "out_range", "values_dtype", "values_strided", "uniforms_shape", "bucket_size", "quantum_num", "seed"],
)
def test_encode_rows_wrapper_checks_inputs(case):
    v = torch.zeros(700)
    seg = EncodeSegment(v, 0, 1, 2)
    out = torch.zeros(2 * 516, dtype=torch.uint8)
    kw = dict(quantum_num=127, bucket_size=512, device="cpu")
    if case == "out_dtype":
        out = out.float()
    elif case == "out_range":
        seg = EncodeSegment(v, 1, 1, 2)
    elif case == "values_dtype":
        seg = EncodeSegment(v.double(), 0, 1, 2)
    elif case == "values_strided":
        seg = EncodeSegment(torch.zeros(1400)[::2], 0, 1, 2)
    elif case == "uniforms_shape":
        seg = EncodeSegment(v, 0, 1, 2, uniforms=torch.zeros(700))
    elif case == "bucket_size":
        kw["bucket_size"] = 0
    elif case == "quantum_num":
        kw["quantum_num"] = 128
    else:
        seg = EncodeSegment(v, 0, -1, 2)
    with pytest.raises(ValueError):
        qsgd_encode_rows([seg], out, **kw)
