"""Path-keyed codec bank: one `TensorCodec` per (direction, leaf path),
ported from `deepreduce_tpu/fedsim/codec_tree.py`.

A tree is a dict of tensors under the port's "/"-joined flax names
("SeparableBlock_3/Conv_0/kernel"). Its leaves are taken in the order JAX
flattens the nested flax dict (sorted keys, level by level, so
`SeparableBlock_10` comes before `SeparableBlock_2`), and each leaf's codec
is named after JAX's path string, `f"{direction}/{keystr(path)}"`
("c2s/['SeparableBlock_0']['Conv_0']['kernel']"): the name keys the leaf's
Philox stream (`sparse.per_tensor_stream`) and the `layer_pattern` gate, so
the port sees the same names as the JAX package.

The batched cohort (`fedsim.round`, `impl="vmap"`) compresses a block of
clients at once: `encode_batched` runs each leaf's index stage under
`torch.func.vmap` over a leading client dimension, then writes the QSGD
rows of every QSGD leaf of every client of the block with one
`qsgd_encode_rows` call (the wrapper packs the segments into launches of up
to `ops.qsgd_encode.MAX_SEGMENTS`), each segment on its leaf's stream at
(step, the client's cohort position). A payload travels as its leaves, each
with the leading client dimension; `decode_batched` and `wire_batched`
vmap the per-leaf decode and wire accounting over them.

`encode_tree` runs every leaf's index stage, then writes the QSGD wire rows
of every QSGD leaf with one launch of the grouped kernel
(`ops.qsgd_encode_rows`), each segment on its own leaf's stream at
(step, worker), through `wrappers.encode_group`, the data-parallel
exchange's grouped encode too: a direction's whole tree is one launch, and
the rows are bitwise those of one launch per leaf. The JAX package folds a leaf's PRNG
key from its flat position; the port's streams are keyed by name, and the
CPU parity hook `uniforms` (path -> f32) injects JAX's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch.func import vmap

from deepreduce_tpu_torch import sparse
from deepreduce_tpu_torch.codecs import qsgd
from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, resolve_device
from deepreduce_tpu_torch.metrics import WireStats, combine
from deepreduce_tpu_torch.ops import EncodeSegment, qsgd_encode_rows
from deepreduce_tpu_torch.sparse import SparseGrad
from deepreduce_tpu_torch.wrappers import EncodeUnit, TensorCodec, encode_group

Tree = Dict[str, torch.Tensor]
_ROWS_ALIGN = 16  # each leaf's rows start 16-byte aligned in the shared buffer


def keystr(name: str) -> str:
    """`jax.tree_util.keystr` of the nested-dict path that the "/"-joined
    `name` spells: "a/b" -> "['a']['b']"."""
    return "".join(f"[{part!r}]" for part in name.split("/"))


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    """Host-side skeleton of one flattened tree: its names, JAX's path
    strings and the shapes, in JAX's flatten order."""

    names: Tuple[str, ...]
    paths: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]

    def unflatten(self, leaves: List[torch.Tensor]) -> Tree:
        return dict(zip(self.names, leaves))


class TreeCodec:
    """A directory of per-leaf `TensorCodec`s for one transfer direction."""

    def __init__(self, direction: str, cfg: DeepReduceConfig, *, device: DeviceLike = "cuda"):
        self.direction = direction
        self.cfg = cfg
        self.device = resolve_device(device)
        self._codecs: Dict[str, TensorCodec] = {}

    def codec(self, path: str, shape) -> TensorCodec:
        shape = tuple(int(s) for s in shape)
        codec = self._codecs.get(path)
        if codec is None:
            codec = TensorCodec(shape, self.cfg, name=f"{self.direction}/{path}", device=self.device)
            self._codecs[path] = codec
        elif codec.shape != shape:
            raise ValueError(
                f"leaf path {path!r} previously had shape {codec.shape}, now "
                f"{shape} — the codec cache is keyed by treedef path, which "
                "must map to one static shape"
            )
        return codec

    def spec(self, tree: Mapping[str, Any], *, batched: bool = False) -> TreeSpec:
        """The tree's skeleton; `batched`: its tensors lead with a client
        dimension, which the shapes leave out."""
        names = tuple(sorted(tree, key=lambda n: n.split("/")))
        lo = 1 if batched else 0
        return TreeSpec(
            names=names,
            paths=tuple(keystr(n) for n in names),
            shapes=tuple(tuple(tree[n].shape[lo:]) for n in names),
        )

    def payload_specs(self, spec: TreeSpec) -> List[Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of every payload leaf of the tree, leaf by leaf in
        flatten order: the byte layout of one client's wire image."""
        return [s for path, shape in zip(spec.paths, spec.shapes) for s in self.codec(path, shape).payload_specs()]

    def split_leaves(self, leaves: List[torch.Tensor], spec: TreeSpec) -> List[List[torch.Tensor]]:
        """Inverse of `flat_leaves`: each leaf codec's share of `leaves`."""
        out, i = [], 0
        for path, shape in zip(spec.paths, spec.shapes):
            n = len(self.codec(path, shape).payload_specs())
            out.append(list(leaves[i : i + n]))
            i += n
        return out

    def payloads_from_leaves(self, leaves: List[torch.Tensor], spec: TreeSpec) -> List[Any]:
        return [
            self.codec(path, shape).payload_from_leaves(part)
            for path, shape, part in zip(spec.paths, spec.shapes, self.split_leaves(leaves, spec))
        ]

    # ------------------------------------------------------------------ #

    def group(
        self, tree: Tree, residual: Optional[Tree]
    ) -> Tuple[TreeSpec, List[torch.Tensor], List[EncodeUnit], int]:
        """The tree's encode units in flatten order: the `TreeSpec`, the
        pre-compression leaves `leaf + residual` (what the sender subtracts
        the decode from for its new residual), the `wrappers.encode_group`
        units (path, codec, leaf + residual, rows offset; each QSGD leaf's
        rows start 16-byte aligned) and the rows buffer's size in bytes."""
        spec = self.spec(tree)
        comps: List[torch.Tensor] = []
        units: List[EncodeUnit] = []
        nbytes = 0
        for name, path in zip(spec.names, spec.paths):
            codec = self.codec(path, tree[name].shape)
            comp = tree[name] if residual is None else tree[name] + residual[name]
            comps.append(comp)
            units.append((path, codec, comp, nbytes))
            if codec.rows_leaf is not None:
                nbytes += -(-codec.val_codec.meta.payload_len // _ROWS_ALIGN) * _ROWS_ALIGN
        return spec, comps, units, nbytes

    def encode_tree(
        self,
        tree: Tree,
        residual: Optional[Tree],
        *,
        step: int,
        worker: int,
        uniforms: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Tuple[List[Any], List[torch.Tensor], TreeSpec]:
        """Compress `tree + residual` leaf by leaf: every leaf's index stage,
        then one grouped QSGD launch for all QSGD leaves. Returns the payload
        list (flatten order), the pre-compression leaves and the `TreeSpec`.
        `uniforms` (path -> f32, CPU only) replaces the QSGD draws of the
        named leaves."""
        spec, comps, units, nbytes = self.group(tree, residual)
        rows = torch.empty(nbytes, dtype=torch.int8, device=self.device)
        payloads, _ = encode_group(units, rows, step=step, worker=worker, uniforms=uniforms)
        return [payloads[path] for path in spec.paths], comps, spec

    def decode_tree(self, payloads: List[Any], spec: TreeSpec, *, step: int) -> Tree:
        return spec.unflatten([
            self.codec(path, shape).decode(p, step=step).reshape(shape)
            for path, shape, p in zip(spec.paths, spec.shapes, payloads)
        ])

    def wire_tree(self, payloads: List[Any], spec: TreeSpec) -> WireStats:
        return combine(
            {
                path: self.codec(path, shape).wire_stats(p)
                for path, shape, p in zip(spec.paths, spec.shapes, payloads)
            }
        )

    # ------------------------------------------------------------------ #

    def compress_tree(
        self,
        tree: Tree,
        residual: Optional[Tree],
        *,
        step: int,
        worker: int,
        uniforms: Optional[Mapping[str, torch.Tensor]] = None,
    ) -> Tuple[Tree, Optional[Tree], WireStats]:
        """Fused encode+decode (the in-place simulation path `FedAvg` uses):
        returns (receiver's reconstruction, updated residual, wire bits)."""
        payloads, comps, spec = self.encode_tree(tree, residual, step=step, worker=worker, uniforms=uniforms)
        decoded = self.decode_tree(payloads, spec, step=step)
        # sender-side error feedback: the residual is against what it encoded
        new_residual = None if residual is None else {n: c - decoded[n] for n, c in zip(spec.names, comps)}
        return decoded, new_residual, self.wire_tree(payloads, spec)

    # -- the batched cohort ------------------------------------------------ #

    def encode_batched(
        self,
        tree: Tree,
        residual: Optional[Tree],
        *,
        step: int,
        workers: List[int],
        uniforms: Optional[List[Mapping[str, torch.Tensor]]] = None,
    ) -> Tuple[List[List[torch.Tensor]], List[torch.Tensor], TreeSpec, List[EncodeSegment]]:
        """Compress B clients' `tree + residual` (tensors [B, ...]): each
        leaf's index stage vmapped over the clients, then the QSGD rows of
        every client's QSGD leaves in one `qsgd_encode_rows` call, client c's
        segments on its leaves' streams at (step, workers[c]). Returns each
        leaf's payload leaves (each [B, ...]), the pre-compression leaves
        [B, ...], the `TreeSpec` and the call's segment table.
        `uniforms[c]` (path -> f32, CPU only) replaces client c's QSGD
        draws."""
        spec = self.spec(tree, batched=True)
        B = len(workers)
        comps: List[torch.Tensor] = []
        parts: List[Optional[List[torch.Tensor]]] = []
        index_parts: Dict[int, List[torch.Tensor]] = {}
        offsets: Dict[int, int] = {}
        nbytes = 0
        geometry = None
        for i, (name, path, shape) in enumerate(zip(spec.names, spec.paths, spec.shapes)):
            codec = self.codec(path, shape)
            if codec.cfg.compressor == "randomk" and not codec.pattern_excluded:
                raise ValueError(
                    "the batched cohort runs one index stage for all its clients, and random-k draws its "
                    "priorities per client: use impl='scan' with compressor='randomk'"
                )
            comp = tree[name] if residual is None else tree[name] + residual[name]
            comps.append(comp)
            if codec.rows_leaf is None:
                parts.append(list(vmap(lambda x, c=codec: tuple(_full_payload(c, x, step).leaves()))(comp)))
                continue
            meta = codec.val_codec.meta
            if geometry not in (None, (meta.quantum_num, meta.bucket_size)):
                raise ValueError("one grouped QSGD launch takes one quantum_num and one bucket_size")
            geometry = (meta.quantum_num, meta.bucket_size)
            index_parts[i] = list(vmap(lambda x, c=codec: tuple(c.encode_index(x, step=step).leaves()))(comp))
            offsets[i] = nbytes
            nbytes += -(-meta.payload_len // _ROWS_ALIGN) * _ROWS_ALIGN
            parts.append(None)
        segments: List[EncodeSegment] = []
        if index_parts:
            rows = torch.empty(B * nbytes, dtype=torch.int8, device=self.device)
            for c, worker in enumerate(workers):
                for i, ileaves in index_parts.items():
                    path, shape = spec.paths[i], spec.shapes[i]
                    codec = self.codec(path, shape)
                    seed, offset = sparse.per_tensor_stream(codec.cfg.seed, codec.name, step, worker)
                    u = None if uniforms is None else uniforms[c].get(path)
                    values = _index_payload(codec, ileaves).values[c]
                    segments.append(EncodeSegment(values=values, out_offset=c * nbytes + offsets[i], seed=seed,
                                                  offset=offset, uniforms=u))
            qsgd_encode_rows(segments, rows, quantum_num=geometry[0], bucket_size=geometry[1], device=rows.device)
            rows2d = rows.view(B, nbytes)
            for i, ileaves in index_parts.items():
                codec = self.codec(spec.paths[i], spec.shapes[i])
                data = rows2d[:, offsets[i] : offsets[i] + codec.val_codec.meta.payload_len]
                parts[i] = list(vmap(
                    lambda *a, c=codec: tuple(c.rows_payload(_index_payload(c, a[:-1]), a[-1]).leaves())
                )(*ileaves, data))
        return parts, comps, spec, segments

    def decode_batched(self, parts: List[List[torch.Tensor]], spec: TreeSpec, *, step: int) -> Tree:
        """Each client's reconstruction from batched payload leaves."""
        out = []
        for path, shape, leaves in zip(spec.paths, spec.shapes, parts):
            codec = self.codec(path, shape)
            if codec.rows_leaf is None:
                out.append(vmap(lambda *l, c=codec: c.decode(c.payload_from_leaves(list(l)), step=step).reshape(
                    c.shape))(*leaves))
                continue
            # the QSGD rows decoded for every client here, outside vmap (the
            # norms' dtype view has no batching rule)
            vals = qsgd.decode_values(leaves[codec.rows_leaf], codec.val_codec.meta)
            out.append(vmap(lambda v, *l, c=codec: c.decode(c.payload_from_leaves(list(l)), step=step, values=v)
                            .reshape(c.shape))(vals, *leaves))
        return spec.unflatten(out)

    def wire_batched(self, parts: List[List[torch.Tensor]], spec: TreeSpec) -> WireStats:
        """Each client's wire bits ([B] float32 fields) from batched payload
        leaves, summed over the leaves as `wire_tree` sums them."""
        fields = ("index_bits", "value_bits", "dense_bits", "saturated")
        stats = {}
        for path, shape, leaves in zip(spec.paths, spec.shapes, parts):
            codec = self.codec(path, shape)
            vals = vmap(lambda *l, c=codec: tuple(
                getattr(c.wire_stats(c.payload_from_leaves(list(l))), f) for f in fields))(*leaves)
            stats[path] = WireStats(*vals)
        return combine(stats)


def _full_payload(codec: TensorCodec, x: torch.Tensor, step: int) -> Any:
    """A leaf's whole payload without QSGD rows: the index stage, then a
    value codec other than QSGD where there is one."""
    payload = codec.encode_index(x, step=step)
    if codec.compressed and codec.val_codec is not None:
        payload = codec.encode_values(payload)
    return payload


def _index_payload(codec: TensorCodec, leaves) -> Any:
    """The index stage's payload of a QSGD leaf from its leaves: the index
    codec's payload in 'both' mode, the sparsifier's output in 'value'
    mode."""
    if codec.idx_codec is None:
        return SparseGrad(values=leaves[0], indices=leaves[1], nnz=leaves[2], shape=codec.shape)
    return codec.idx_codec.payload_from_leaves(list(leaves))
