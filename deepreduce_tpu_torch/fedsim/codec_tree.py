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

from deepreduce_tpu_torch.config import DeepReduceConfig
from deepreduce_tpu_torch.device import DeviceLike, resolve_device
from deepreduce_tpu_torch.metrics import WireStats, combine
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

    def spec(self, tree: Mapping[str, Any]) -> TreeSpec:
        names = tuple(sorted(tree, key=lambda n: n.split("/")))
        return TreeSpec(
            names=names,
            paths=tuple(keystr(n) for n in names),
            shapes=tuple(tuple(tree[n].shape) for n in names),
        )

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
