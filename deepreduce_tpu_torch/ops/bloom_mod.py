"""The mod-blocked bloom index codec with a prefix policy: the CUDA
kernels' wrappers (`csrc/bloom_mod.cu`).

Three entry points, each one launch a leaf:

- `insert(indices, nnz, meta)`: the filter words (int32 bit patterns) of the
  live indices, each setting `lane_mask(j)` in word `j mod W`;
- `select_gather(words, flat, meta)`: the encoder's FP-aware tail, the
  values at the first `budget` universe positives in ascending order (zeros
  past the live count) and that count;
- `place(words, vals, nsel, meta)`: the decoder's rank inversion straight to
  the dense tensor: `vals[r]` at the positive of rank
  r < min(nsel, budget, len(vals)), 0 elsewhere.

They replace no Pallas kernel (the JAX package leaves these stages to XLA).
`codecs/bloom.py` calls them for the mod-blocked filter under a prefix
policy when its tensors are on the card, and runs its own torch code, which
they equal bit for bit, everywhere else. Each launch is counted in the
entry point's `launches`. Under `torch.func.vmap` (FedSim's batched
cohort) an entry point launches once per row of the batch. There is no
fallback: a failed build or launch raises, and so does an input the
kernels do not take.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from deepreduce_tpu_torch.device import check_on
from deepreduce_tpu_torch.ops.qsgd_kernel import count_launches

PREFIX_POLICIES = ("leftmost", "p0")
_COUNT_DTYPES = (torch.int32, torch.int64)


def _kernel_lib() -> ctypes.CDLL:
    from deepreduce_tpu_torch.ops.build import library

    lib = library("bloom_mod")
    if lib.bloom_mod_insert.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bloom_mod_insert.argtypes = [p, i, ll, p, i, p, i, i, p]
        lib.bloom_mod_select.argtypes = [p, i, i, ll, ll, p, i, p, p, p, p]
        lib.bloom_mod_place.argtypes = [p, i, i, ll, ll, p, ll, i, p, i, p, p, p]
        for fn in (lib.bloom_mod_insert, lib.bloom_mod_select, lib.bloom_mod_place):
            fn.restype = ctypes.c_int
        lib.bloom_mod_scratch_bytes.argtypes = [ll]
        lib.bloom_mod_scratch_bytes.restype = ll
        lib.bloom_mod_error_string.argtypes = [i]
        lib.bloom_mod_error_string.restype = ctypes.c_char_p
    return lib


def _check_meta(meta) -> None:
    if meta.blocked != "mod" or meta.policy not in PREFIX_POLICIES:
        raise ValueError(
            f"the bloom_mod kernels take the mod-blocked filter with a prefix policy {PREFIX_POLICIES}, "
            f"got blocked={meta.blocked!r} policy={meta.policy!r}"
        )


def _check_vector(t: torch.Tensor, dev: torch.device, what: str, dtypes=None, n=None) -> None:
    check_on(t, dev, what)
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-d tensor, got shape {tuple(t.shape)}")
    if dtypes is not None and t.dtype not in dtypes:
        raise ValueError(f"{what} must have dtype in {dtypes}, got {t.dtype}")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{what} must have {n} elements, got {t.shape[0]}")


def _check_count(t: torch.Tensor, dev: torch.device, what: str) -> None:
    check_on(t, dev, what)
    if t.dtype not in _COUNT_DTYPES or t.numel() != 1:
        raise ValueError(f"{what} must be one int32 or int64 element, got {t.dtype} {tuple(t.shape)}")


def _check_values(t: torch.Tensor, dev: torch.device, what: str, n=None) -> None:
    _check_vector(t, dev, what, n=n)
    if not t.dtype.is_floating_point or t.element_size() not in (2, 4, 8):
        raise ValueError(f"{what} must be a 2-, 4- or 8-byte floating dtype, got {t.dtype}")


def _check_cuda(t: torch.Tensor, what: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"the bloom_mod kernels run on the card, got {what} on {t.device}")
    return t.device


def _raise_on(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {lib.bloom_mod_error_string(code).decode()} (cudaError {code})")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


class _PerRow(torch.autograd.Function):
    """An entry point under `torch.func.vmap`: a batched tensor has no
    storage to hand a kernel, so the vmap rule calls the entry point once
    per row of the batch and stacks the rows' outputs."""

    @staticmethod
    def forward(entry, meta, *tensors):
        return entry(*tensors, meta)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, entry, meta, *tensors):
        dims = in_dims[2:]
        rows = [entry(*(t if d is None else t.select(d, b).contiguous() for t, d in zip(tensors, dims)), meta)
                for b in range(info.batch_size)]
        if isinstance(rows[0], tuple):
            outs = tuple(torch.stack(parts) for parts in zip(*rows))
            return outs, (0,) * len(outs)
        return torch.stack(rows), 0


def _batched(*tensors: torch.Tensor) -> bool:
    return any(torch._C._functorch.is_functorch_wrapped_tensor(t) for t in tensors)


def insert(indices: torch.Tensor, nnz: torch.Tensor, meta) -> torch.Tensor:
    """int32[W] filter words of `indices[s]` for s < nnz (indices int32 or
    int64, nnz one int32 or int64 element, both on one card)."""
    if _batched(indices, nnz):
        return _PerRow.apply(insert, meta, indices, nnz)
    dev = _check_cuda(indices, "indices")
    _check_meta(meta)
    _check_vector(indices, dev, "indices", _COUNT_DTYPES)
    _check_count(nnz, dev, "nnz")
    words = torch.empty(meta.n_words, dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    with torch.cuda.device(dev):
        code = lib.bloom_mod_insert(indices.data_ptr(), indices.element_size(), indices.shape[0], nnz.data_ptr(),
                                    nnz.element_size(), words.data_ptr(), meta.n_words, meta.num_hash, _stream(dev))
    _raise_on(lib, code, "bloom_mod insert")
    count_launches(insert, 1)
    return words


insert.launches = 0


def select_gather(words: torch.Tensor, flat: torch.Tensor, meta) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values[budget] in `flat`'s dtype, nsel int32[]): `flat` (1-d, d
    elements) at the first `budget` positives of the filter `words`
    (int32[W]) in ascending order, zeros past them."""
    if _batched(words, flat):
        return _PerRow.apply(select_gather, meta, words, flat)
    dev = _check_cuda(words, "words")
    _check_meta(meta)
    _check_vector(words, dev, "words", (torch.int32,), meta.n_words)
    _check_values(flat, dev, "flat", meta.d)
    values = torch.empty(meta.budget, dtype=flat.dtype, device=dev)
    nsel = torch.empty((), dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    scratch = torch.empty(lib.bloom_mod_scratch_bytes(meta.d), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = lib.bloom_mod_select(words.data_ptr(), meta.n_words, meta.num_hash, meta.d, meta.budget,
                                    flat.data_ptr(), flat.element_size(), values.data_ptr(), nsel.data_ptr(),
                                    scratch.data_ptr(), _stream(dev))
    _raise_on(lib, code, "bloom_mod select")
    count_launches(select_gather, 1)
    return values, nsel


select_gather.launches = 0


def place(words: torch.Tensor, vals: torch.Tensor, nsel: torch.Tensor, meta) -> torch.Tensor:
    """The flat dense tensor (d elements, `vals`' dtype): `vals[r]` at the
    positive of rank r < min(nsel, budget, len(vals)) of the filter `words`,
    0 elsewhere."""
    if _batched(words, vals, nsel):
        return _PerRow.apply(place, meta, words, vals, nsel)
    dev = _check_cuda(words, "words")
    _check_meta(meta)
    _check_vector(words, dev, "words", (torch.int32,), meta.n_words)
    _check_values(vals, dev, "vals")
    _check_count(nsel, dev, "nsel")
    dense = torch.empty(meta.d, dtype=vals.dtype, device=dev)
    lib = _kernel_lib()
    scratch = torch.empty(lib.bloom_mod_scratch_bytes(meta.d), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        code = lib.bloom_mod_place(words.data_ptr(), meta.n_words, meta.num_hash, meta.d, meta.budget,
                                   vals.data_ptr(), vals.shape[0], vals.element_size(), nsel.data_ptr(),
                                   nsel.element_size(), dense.data_ptr(), scratch.data_ptr(), _stream(dev))
    _raise_on(lib, code, "bloom_mod place")
    count_launches(place, 1)
    return dense


place.launches = 0
