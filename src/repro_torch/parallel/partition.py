"""Logical-axis -> partition spec rules, the sharding strategy layer (port
of ``repro/parallel/partition.py``).

Weights carry logical axis names in their ParamDesc (``models/init.py``);
a strategy maps names to mesh axes with divisibility checks and first-use
deduplication (a mesh axis appears at most once per spec).

Strategies:
  tp_fsdp   — default: TP on ffn/heads/vocab/experts over `model`, FSDP
              storage sharding over `data` on the embed dim, DP over
              (`pod`, `data`) on batch.
  fsdp_only — no tensor parallelism (all `model`-dim rules -> None).
  dp_fsdp   — no tensor parallelism; the `model` axis joins the batch axes
              and the FSDP storage sharding.
  seq_shard — tp_fsdp + sequence-sharded activations (long-context cells).

The specs are pure data, computed exactly as the reference computes them
(its quirks kept: the vocab rule tests the mesh's `model` size even under
``dp_fsdp``; a non-dividing dimension falls back to replication). They
give every leaf's per-device shard shape on any mesh
(``NamedSharding.shard_shape``), which is what the dry run counts. The
port runs on one card, so a sharding places a tensor only where its mesh
has one device (``NamedSharding.place``); over a larger mesh it raises
``ValueError``, never replicating in silence. For the same reason
``make_constrain`` is the identity on a one-device mesh and raises on a
larger one (the port's models take no activation constraints).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.init import (
    ParamDesc,
    flatten_tree,
    param_descriptors,
    rebuild_tree,
    unflatten_tree,
)


class P:
    """A partition spec: one entry per leading dimension, each a mesh axis
    name, a tuple of names or None. A one-name tuple is kept as the name,
    as ``jax.sharding.PartitionSpec`` keeps it, so two specs (and a spec
    and a tuple) compare entry for entry. A spec is a leaf of the trees
    that hold it (not a tuple node)."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, tuple):
            other = P(*other)
        if not isinstance(other, P):
            return NotImplemented
        return self._entries == other._entries

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"P{self._entries!r}"


def _parts(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def num_devices(self) -> int:
        return math.prod(self.mesh.shape.values())

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The per-device shape of a global ``shape`` (ValueError where a
        sharded dimension does not divide)."""
        shape = tuple(int(d) for d in shape)
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"shape {shape} has dimensions")
        out = []
        for i, dim in enumerate(shape):
            parts = _parts(self.spec[i]) if i < len(self.spec) else ()
            size = math.prod(self.mesh.shape[a] for a in parts)
            if dim % size:
                raise ValueError(f"dimension {i} of {shape} does not split "
                                 f"over {parts} ({size} devices)")
            out.append(dim // size)
        return tuple(out)

    def place(self, t: torch.Tensor, device=None) -> torch.Tensor:
        """``t`` on ``device`` (its own by default), where the mesh has one
        device; ValueError over a larger mesh."""
        if self.num_devices != 1:
            raise ValueError(
                f"a sharding over {self.num_devices} devices ({self.mesh.shape},"
                f" spec {self.spec}): the port runs on one card; place "
                f"tensors with a mesh of one device (make_mesh_for_devices(1))")
        return t if device is None else t.to(device)


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


@dataclasses.dataclass
class ShardingStrategy:
    cfg: ModelConfig
    mesh: Any
    strategy: str = "tp_fsdp"
    # per-cell activation batch size (drop batch sharding when indivisible)
    batch_size: Optional[int] = None
    seq_shard: bool = False  # shard sequence dim of activations (tp_seq)

    def __post_init__(self):
        m = self.mesh
        self._model = m.shape.get("model", 1)
        self._batch_axes = batch_axes(m)
        if self.strategy == "dp_fsdp":
            # no tensor parallelism: the model axis joins data parallelism
            self._batch_axes = self._batch_axes + ("model",)
            self._model = 1
        self._data = math.prod(m.shape[a] for a in self._batch_axes)
        self._tp = self.strategy not in ("fsdp_only", "dp_fsdp")
        md = "model" if self._tp else None
        fsdp_axes = (
            ("data", "model") if self.strategy == "dp_fsdp" else "data"
        )
        cfgv = self.cfg
        self.rules: Dict[Optional[str], Any] = {
            # the mesh's model size even under dp_fsdp, as the reference
            "vocab": md if cfgv.vocab % m.shape.get("model", 1) == 0 else None,
            "embed": fsdp_axes,
            "embed_out": None,
            "heads": md,
            "kv": md,
            "ffn": md,
            "ffn_e": None,
            "experts": md,
            "lora": None,
            "rnn": md,
            "rnn2": None,
            "rwkv_heads": None,
            "layers": None,
            None: None,
        }
        # divisibility guards for flat projection dims
        if (cfgv.n_heads_eff * cfgv.head_dim) % self._model != 0:
            self.rules["heads"] = None
        if (cfgv.n_kv_heads * cfgv.head_dim) % self._model != 0:
            self.rules["kv"] = None
        if cfgv.d_ff % self._model != 0:
            self.rules["ffn"] = None
        if cfgv.moe and cfgv.moe.n_experts % self._model != 0:
            self.rules["experts"] = None
        if cfgv.rglru and (cfgv.rglru.d_rnn or cfgv.d_model) % self._model != 0:
            self.rules["rnn"] = None

    # -- parameter specs -----------------------------------------------------
    def _spec_for_axes(self, axes: Tuple[str, ...],
                       shape: Tuple[int, ...]) -> P:
        used = set()
        out = []
        for ax, dim in zip(axes, shape):
            mesh_ax = self.rules.get(ax, None)
            parts = _parts(mesh_ax)
            if any(p in used for p in parts):  # the first use wins
                mesh_ax, parts = None, ()
            size = math.prod(self.mesh.shape[p] for p in parts)
            if parts and dim % size != 0:
                mesh_ax, parts = None, ()
            used.update(parts)
            out.append(mesh_ax)
        return P(*out)

    def param_specs(self):
        """A spec per parameter, in the parameter tree's structure."""
        desc = flatten_tree(param_descriptors(self.cfg),
                            is_leaf=lambda x: isinstance(x, ParamDesc))
        return unflatten_tree([(path, self._spec_for_axes(pd.axes, pd.shape))
                               for path, pd in desc])

    def param_shardings(self):
        return unflatten_tree([
            (path, NamedSharding(self.mesh, s))
            for path, s in flatten_tree(self.param_specs())])

    # -- activation constraints ----------------------------------------------
    def _bax(self):
        b = self.batch_size
        ax = self._batch_axes
        if b is None or not ax or b % self._data != 0:
            return None
        return ax

    def act_spec(self, kind: str, ndim: int) -> Optional[P]:
        bax = self._bax()
        md = self._model
        cfgv = self.cfg
        seq = "model" if (self.seq_shard and self._tp) else None
        if kind == "act":
            return P(bax, seq, None)
        if kind == "partial_out":
            # matmul partial sums S-sharded: a reduce-scatter, not an
            # all-reduce (Megatron sequence parallelism)
            return P(bax, seq, None) if seq is not None else None
        if kind == "logits":
            tp = self.rules["vocab"]
            return P(bax, seq if tp is None else None, tp)
        if kind == "heads4d":
            tp = "model" if (self._tp and cfgv.n_heads_eff % md == 0) else None
            return P(bax, None, tp, None)
        if kind == "kv4d":
            tp = "model" if (self._tp and cfgv.n_kv_heads % md == 0) else None
            return P(bax, None, tp, None)
        return None

    def make_constrain(self):
        """``constrain(tensor, kind)``: the identity, on a one-device mesh
        (where every constraint is met); ValueError on a larger one."""
        n = math.prod(self.mesh.shape.values())
        if n != 1:
            raise ValueError(
                f"activation constraints over {n} devices: the port runs on "
                f"one card and its models take no constraints")
        return lambda t, kind: t

    # -- batch / cache specs ---------------------------------------------------
    def batch_specs(self, batch_tree):
        bax = self._bax()
        pairs = flatten_tree(batch_tree)
        return rebuild_tree(batch_tree, [
            NamedSharding(self.mesh, P(bax, *(None,) * (len(t.shape) - 1)))
            for _, t in pairs])

    def cache_specs(self, cache_tree, decode_batch: int):
        """Decode caches: batch over data axes; the long time dim over
        `model` (KV/MLA); recurrent state width over `model`. Leaves are
        named by their path as the reference names them (``kv/k``,
        ``mla/ckv``, ``rec/h``, ``rwkv/s``, ``enc_kv/k``, ...); a host
        integer (a cache's ``len``) is a scalar."""
        mesh = self.mesh
        bax = batch_axes(mesh)
        bshard = bax if decode_batch % self._data == 0 else None
        md = self._model
        tp = self.strategy != "fsdp_only"

        def one(path, leaf):
            name = "/".join(str(p) for p in path)
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
            nd = len(shape)
            if nd == 0:
                return NamedSharding(mesh, P())
            spec = [None] * nd
            # as in the reference, "enc_kv/k" also matches "kv/k" first
            if "kv/k" in name or "kv/v" in name:
                # (..., B, T, Hkv, dh)
                spec[-4] = bshard
                if shape[-2] % md == 0 and tp:
                    spec[-2] = "model"  # heads
                elif shape[-3] % md == 0 and tp:
                    spec[-3] = "model"  # sequence
            elif "mla/ckv" in name or "mla/krope" in name:
                spec[-3] = bshard
                if shape[-2] % md == 0 and tp:
                    spec[-2] = "model"  # sequence dim of the latent cache
            elif "rec/h" in name:
                spec[-2] = bshard
                if shape[-1] % md == 0 and tp:
                    spec[-1] = "model"
            elif "rec/conv" in name:
                spec[-3] = bshard
                if shape[-1] % md == 0 and tp:
                    spec[-1] = "model"
            elif "rwkv/s" in name:
                spec[-4] = bshard
                if shape[-3] % md == 0 and tp:
                    spec[-3] = "model"
            elif "rwkv/att" in name or "rwkv/ffn" in name:
                spec[-2] = bshard
            elif "enc_kv" in name:
                spec[-4] = bshard
                if shape[-2] % md == 0 and tp:
                    spec[-2] = "model"
            return NamedSharding(mesh, P(*spec))

        return rebuild_tree(cache_tree, [one(path, leaf) for path, leaf
                                         in flatten_tree(cache_tree)])


def place_tree(tree, shardings, device=None):
    """Every leaf of ``tree`` placed by its sharding in ``shardings`` (the
    same structure; ``NamedSharding.place``)."""
    leaves = flatten_tree(tree)
    shard = flatten_tree(shardings)
    if len(leaves) != len(shard):
        raise ValueError(f"{len(leaves)} leaves against {len(shard)} "
                         f"shardings")
    return rebuild_tree(tree, [s.place(t, device) for (_, t), (_, s)
                               in zip(leaves, shard)])
