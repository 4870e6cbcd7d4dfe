"""Carry filter state and config between the JAX package and the port.

* :func:`state_from_numpy` / :func:`state_to_numpy` use the dict format of
  the JAX package's snapshots (``{"table": uint32[num_words], "count":
  int32[]}``), so ``jax_handle.snapshot().arrays`` loads straight into the
  port and back. ``state_to_numpy`` takes any state (every field, uint32
  bits for :data:`UINT32_FIELDS`) and is the snapshot hook of every
  tensor backend; their restore hook copies through :func:`owned_tensor`.
  Either direction copies once, and the result owns its memory.
* :func:`tcf_state_from_numpy`, :func:`gqf_state_from_numpy` and
  :func:`bcht_state_from_numpy` carry the baselines' states in the JAX
  package's names and dtypes: TCF ``table`` and ``stash`` uint32, GQF
  ``table`` uint32, BCHT ``key_lo`` and ``key_hi`` uint32[nb, b] and
  ``used`` bool; ``count`` int32 in each. ``config_from_reference(cfg,
  TCFConfig | GQFConfig | BCHTConfig)`` carries their configs.
* :func:`config_from_reference` rebuilds the port's ``CuckooConfig`` from
  a JAX ``CuckooConfig``'s field values (duck-typed: this module imports
  nothing of the JAX package) and checks that the two reprs — the
  snapshot fingerprint — are equal.
* :func:`bloom_state_from_numpy` and :func:`bloom_config_from_reference`
  are their counterparts for the blocked Bloom filter.
* :func:`py_cuckoo_from_numpy` / :func:`py_cuckoo_to_numpy` carry the
  ``cpu-cuckoo`` oracle's state in the JAX adapter's snapshot format
  (``{"buckets": uint32[num_buckets, bucket_size], "count": int64[]}``);
  ``config_from_reference(cfg, PyCuckooConfig)`` carries its config.
* :func:`sharded_state_from_numpy` carries a ``ShardedCuckooState``
  (``{"table": uint32[P, num_words], "count": int32[P]}``, the JAX
  sharded adapter's snapshot format; :func:`state_to_numpy` takes it back)
  and :func:`sharded_config_from_reference` a JAX ``ShardedCuckooConfig``.
* :func:`op_batch_from_reference` carries a JAX ``OpBatch``.
* :func:`model_params_from_reference` turns the JAX ``Model.init``
  parameter tree (as numpy arrays) into the port's ``Model`` state dict.
* :func:`train_state_from_reference` carries a JAX training state,
  ``(params, AdamWState)`` as numpy arrays with float32 or ``QTensor``
  moments, into the port's state dict and ``AdamWState``.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .amq.protocol import OpBatch
from .core.cuckoo_filter import CuckooConfig, CuckooState
from .core.sharded_filter import ShardedCuckooConfig, ShardedCuckooState
from .filters.bcht import BCHTState
from .filters.blocked_bloom import BloomConfig, BloomState
from .filters.cpu_reference import PyCuckooConfig, PyCuckooFilter
from .filters.quotient import GQFState
from .filters.two_choice import TCFState
from .train.optimizer import AdamWState, _quantize

# State fields that carry uint32 bits (held as int32 in the port).
UINT32_FIELDS = ("table", "stash", "key_lo", "key_hi")


def owned_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """A tensor on ``device`` with ``arr``'s bits (uint32 as int32) that owns
    its memory: one host-to-device copy on the GPU, a clone on the CPU.
    The kernels update tables in place, so a restored table must never
    share the snapshot's buffer."""
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))  # 0-d stays 0-d
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    with warnings.catch_warnings():
        # A read-only source is only read: the copy below owns the bits.
        warnings.filterwarnings("ignore", message=".*not writ")
        src = torch.from_numpy(arr)
    return src.to(device, copy=True)


def _table_and_count(arrays: dict, device):
    table = np.asarray(arrays["table"])
    count = np.asarray(arrays["count"], np.int32)
    if table.ndim != 1 or count.shape != ():
        raise ValueError(
            f"expected table uint32[num_words] and count int32[], got "
            f"{list(table.shape)} and {list(count.shape)}")
    return (owned_tensor(table.astype(np.uint32, copy=False), device),
            torch.tensor(int(count), dtype=torch.int32, device=device))


def state_from_numpy(arrays: dict, device) -> CuckooState:
    """``{"table": uint32[num_words], "count": int32[]}`` -> CuckooState."""
    return CuckooState(*_table_and_count(arrays, device))


def bloom_state_from_numpy(arrays: dict, device) -> BloomState:
    """``{"table": uint32[num_words], "count": int32[]}`` -> BloomState."""
    return BloomState(*_table_and_count(arrays, device))


def _fields_from_numpy(cls, arrays: dict, device, dtypes: dict):
    """A ``cls`` state from its snapshot arrays: each checked against
    ``dtypes`` (name -> numpy dtype) and copied once onto ``device``."""
    values = []
    for f in cls._fields:
        a = np.asarray(arrays[f])
        if a.dtype != dtypes[f] or (f == "count") != (a.ndim == 0):
            raise ValueError(f"{f}: expected {np.dtype(dtypes[f])}, got "
                             f"{a.dtype}{list(a.shape)}")
        values.append(owned_tensor(a, device))
    return cls(*values)


def tcf_state_from_numpy(arrays: dict, device) -> TCFState:
    """``{"table": uint32[num_words], "stash": uint32[stash_size], "count":
    int32[]}`` -> TCFState."""
    return _fields_from_numpy(TCFState, arrays, device, {
        "table": np.uint32, "stash": np.uint32, "count": np.int32})


def gqf_state_from_numpy(arrays: dict, device) -> GQFState:
    """``{"table": uint32[num_slots], "count": int32[]}`` -> GQFState."""
    return _fields_from_numpy(GQFState, arrays, device, {
        "table": np.uint32, "count": np.int32})


def bcht_state_from_numpy(arrays: dict, device) -> BCHTState:
    """``{"key_lo", "key_hi": uint32[nb, b], "used": bool[nb, b], "count":
    int32[]}`` -> BCHTState."""
    return _fields_from_numpy(BCHTState, arrays, device, {
        "key_lo": np.uint32, "key_hi": np.uint32, "used": np.bool_,
        "count": np.int32})


def state_to_numpy(state) -> dict:
    """Any port state -> ``{field: array}`` in the JAX package's names and
    dtypes (the fields of :data:`UINT32_FIELDS` as uint32; a CuckooState or
    BloomState gives ``{"table": uint32[num_words], "count": int32[]}``),
    arrays that own their memory (one device-to-host copy a field on the
    GPU, a copy on the CPU)."""
    out = {}
    for f in state._fields:
        t = getattr(state, f).detach()
        a = (t.cpu() if t.device.type != "cpu" else t.clone()).numpy()
        out[f] = a.view(np.uint32) if f in UINT32_FIELDS else a
    return out


def config_from_reference(cfg, cls=CuckooConfig):
    """The port's ``cls`` config with the same field values as ``cfg``."""
    port = cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cls)})
    if repr(port) != repr(cfg):
        raise ValueError(f"config fingerprints differ:\n  reference: {cfg!r}"
                         f"\n  port:      {port!r}")
    return port


def bloom_config_from_reference(cfg) -> BloomConfig:
    """The port's BloomConfig with the same field values as ``cfg``."""
    return config_from_reference(cfg, BloomConfig)


def sharded_state_from_numpy(arrays: dict, device) -> ShardedCuckooState:
    """``{"table": uint32[P, num_words], "count": int32[P]}`` ->
    ShardedCuckooState (the table as its int32 bit view)."""
    table = np.asarray(arrays["table"])
    count = np.asarray(arrays["count"])
    if (table.dtype != np.uint32 or count.dtype != np.int32
            or table.ndim != 2 or count.shape != table.shape[:1]):
        raise ValueError(
            f"expected table uint32[P, num_words] and count int32[P], got "
            f"{table.dtype}{list(table.shape)} and "
            f"{count.dtype}{list(count.shape)}")
    return ShardedCuckooState(owned_tensor(table, device),
                              owned_tensor(count, device))


def sharded_config_from_reference(cfg) -> ShardedCuckooConfig:
    """The port's ShardedCuckooConfig with the same field values as a JAX
    ``ShardedCuckooConfig`` (its per-partition config through
    :func:`config_from_reference`); the reprs must be equal."""
    port = ShardedCuckooConfig(
        config_from_reference(cfg.shard), cfg.num_shards, cfg.axis_name,
        cfg.capacity_factor, cfg.num_partitions)
    if repr(port) != repr(cfg):
        raise ValueError(f"config fingerprints differ:\n  reference: {cfg!r}"
                         f"\n  port:      {port!r}")
    return port


def py_cuckoo_from_numpy(arrays: dict, config: PyCuckooConfig) -> PyCuckooFilter:
    """``{"buckets": uint32[num_buckets, bucket_size], "count"}`` -> the
    oracle's filter (its eviction generator starts afresh, as on a JAX
    restore: membership is carried, not future victim choices)."""
    want = (config.num_buckets, config.bucket_size)
    buckets = np.asarray(arrays["buckets"], np.uint32)
    if buckets.shape != want:
        raise ValueError(f"buckets: expected {list(want)}, got "
                         f"{list(buckets.shape)}")
    filt = config.init()
    filt.buckets = [[int(t) for t in row] for row in buckets]
    filt.count = int(arrays["count"])
    return filt


def py_cuckoo_to_numpy(filt: PyCuckooFilter) -> dict:
    """The oracle's filter -> ``{"buckets": uint32[nb, b], "count": int64[]}``."""
    return {"buckets": np.asarray(filt.buckets, np.uint32),
            "count": np.asarray(filt.count, np.int64)}


def op_batch_from_reference(batch, device) -> OpBatch:
    """A JAX ``OpBatch`` (keys uint32[n, 2], ops int32[n], valid bool[n])
    -> the port's, on ``device``."""
    keys = np.array(batch.keys, np.uint32)                # writable copies
    return OpBatch(torch.from_numpy(keys.view(np.int32)).to(device),
                   torch.from_numpy(np.array(batch.ops, np.int32)).to(device),
                   torch.from_numpy(np.array(batch.valid, bool)).to(device))


def _tensor(arr) -> torch.Tensor:
    """A numpy array -> a CPU tensor of the same dtype; bfloat16 arrays
    (ml_dtypes, recognised by name) are carried bit for bit."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _flatten(tree, prefix: str, out: dict) -> None:
    for name, sub in tree.items():
        if isinstance(sub, dict):
            _flatten(sub, f"{prefix}{name}.", out)
        else:
            out[f"{prefix}{name}"] = sub


def model_params_from_reference(cfg, params, *, mtp: bool = False) -> dict:
    """The JAX ``Model.init(key)`` tree (leaves as numpy arrays) -> the
    port's ``Model`` state dict (CPU tensors, same values and dtypes):
    load it with ``model.load_state_dict``.

    The JAX package stacks each segment's layers over its ``reps`` on a
    leading axis (``params["stack"][segment][j]`` is period position
    ``j``); the port keeps one module per layer, so layer ``i`` of the
    port is repetition ``r`` of position ``j`` of its segment. Nested
    parameter names carry over unchanged (``mixer.wq.w``, ``ffn.up.w``,
    ``ln1.scale``; MoE's ``ffn.router`` (float32), ``ffn.wgate`` /
    ``ffn.wup`` / ``ffn.wdown`` ``[E, ...]`` and ``ffn.shared.*``; MLA's
    ``mixer.wdq.w``, ``mixer.q_norm.scale``, ... ``mixer.wo.w``; the
    SSM's ``mixer.in_proj.w``, ``mixer.conv_w``, ``mixer.A_log``, ...
    ``mixer.norm.scale``; the RG-LRU's ``mixer.wa.b``, ``mixer.lambda``,
    ...), whatever the segments (RecurrentGemma: a 3-layer period x 12,
    then one ``rglru+mlp`` layer x 2). A ``frames`` model (HuBERT) has no
    ``embed``. DeepSeek-V3's ``params["mtp"]`` (the multi-token-prediction
    block) is carried into ``mtp.norm.*`` / ``mtp.block.*`` with ``mtp``
    (a model that trains: ``Model.init_mtp``); without it the block is
    skipped, as the port's serving model has none."""
    out = {}
    for top in ("embed", "final_norm", "head") + (("mtp",) if mtp else ()):
        if top in params:
            _flatten(params[top], f"{top}.", out)
    if mtp and "mtp" not in params:
        raise ValueError("mtp=True but the reference params hold no 'mtp'")
    layer = 0
    for (period, reps), seg in zip(cfg.segments(), params["stack"]):
        for r in range(reps):
            for j in range(len(period)):
                flat = {}
                _flatten(seg[j], "", flat)
                for name, arr in flat.items():
                    out[f"layers.{layer}.{name}"] = np.asarray(arr)[r]
                layer += 1
    if layer != cfg.num_layers:
        raise ValueError(f"params hold {layer} layers, config {cfg.num_layers}")
    return {name: _tensor(arr) for name, arr in out.items()}


def _dequantized(tree, found: list):
    """The moment tree with each ``QTensor`` (duck-typed: ``q``, ``scale``,
    ``shape``) dequantized to a float32 numpy array; each one met is
    appended to ``found``."""
    if hasattr(tree, "q") and hasattr(tree, "scale") and hasattr(tree, "shape"):
        found.append(tree.shape)
        blocks = np.asarray(tree.q, np.float32) * np.asarray(
            tree.scale, np.float32)[:, None]
        n = int(np.prod(tree.shape)) if tree.shape else 1
        return blocks.reshape(-1)[:n].reshape(tree.shape)
    if isinstance(tree, dict):
        return {k: _dequantized(v, found) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_dequantized(v, found) for v in tree)
    return np.asarray(tree)


def train_state_from_reference(cfg, params, opt_state, *,
                               mtp: bool = False) -> tuple:
    """A JAX training state -> ``(state dict, AdamWState)`` of the port
    (CPU tensors): ``params`` as :func:`model_params_from_reference`
    carries them, and ``opt_state`` (``step``, ``m``, ``v`` trees of the
    params' structure) with each moment under its parameter's name.
    Float32 moments carry bit for bit. ``QTensor`` moments (int8 blocks
    of 256 over the flattened leaf) are dequantized, split into the
    port's per-layer leaves and quantized again per leaf: a stacked JAX
    leaf's blocks span layers, so the carried int8 moments equal JAX's
    only where a segment has one repetition, and are otherwise a
    re-rounding of them."""

    def moments(tree):
        found = []
        named = model_params_from_reference(cfg, _dequantized(tree, found),
                                            mtp=mtp)
        if found:
            return {n: _quantize(t.to(torch.float32)) for n, t in named.items()}
        return {n: t.to(torch.float32) for n, t in named.items()}

    step = torch.tensor(int(np.asarray(opt_state.step)), dtype=torch.int32)
    return (model_params_from_reference(cfg, params, mtp=mtp),
            AdamWState(step, moments(opt_state.m), moments(opt_state.v)))
