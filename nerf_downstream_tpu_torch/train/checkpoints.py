"""Checkpoints in the reference's file format (counterpart of
``nerf_downstream_tpu/train/checkpoints.py``).

The reference writes ``flax.serialization.msgpack_serialize`` of

    {"state_dict": {"params": ..., "batch_stats": ...},
     "optimizer_states": ..., "global_step": int, "meta": {...}}

with every array as msgpack extension type 1 (a packed ``(shape, dtype
name, bytes)`` triple) and numpy scalars as type 3. Neither ``flax`` nor
``msgpack`` is a dependency of the port, so this module carries its own
reader and writer for the subset that flax emits: nil, bool, ints,
floats, str, bin, array, map and those two extension types. Arrays are
read as ``numpy.frombuffer`` of the named dtype; anything else raises,
including flax's chunked form of arrays over 2^30 bytes.

Trees are nested dicts of numpy arrays in the reference's layout
(``convert.state_dict_to_flax`` / ``convert.load_flax_variables`` carry
them to and from a model). A training state (``save_training_state``,
``restore_into``) also carries ``global_step`` and the optimizer state in
the layout of the reference's optax chain of each of its nine
optimizers (``optimizer_state_to_optax``, ``optimizer_state_from_optax``),
so a checkpoint written by either package resumes in the other
(PowerNorm's statistics ``running_phi``, ``iters`` and ``ema_gz`` with
them); the 2D models' states (``train/modules2d.py``: weights, BatchNorm
statistics, the SGD momentum trace and the schedule's count) take the
same path through ``convert.py``'s 2D layout, and the fused ensemble's
through its own. A port checkpoint may also hold ``pruning_masks``:
{"path/to/kernel": bool array}, folded into the weights on load by
``utils.prune.fold_pruning_masks``.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from nerf_downstream_tpu_torch import convert
from nerf_downstream_tpu_torch.train import optim

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_ARRAY_BYTES = 1 << 30  # flax chunks larger arrays


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}
        if b in sized:
            return self.take(self.unpack(sized[b]))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: "B", 0xC8: "H",
                                         0xC9: "I"}[b]))
        if b in (0xD9, 0xDA, 0xDB):
            n = self.unpack({0xD9: "B", 0xDA: "H", 0xDB: "I"}[b])
            return self.take(n).decode("utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack("H" if b == 0xDC else "I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED in out:
            raise ValueError("msgpack: chunked arrays (over 2^30 bytes) are "
                             "not supported")
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack: unsupported extension type {code}")
        inner = _Reader(payload)
        shape, name, buf = inner.value()
        if isinstance(name, bytes):
            name = name.decode()
        try:
            dtype = np.dtype(name)
        except TypeError as e:
            raise ValueError(f"msgpack: unsupported array dtype {name!r}") \
                from e
        if dtype.hasobject:
            raise ValueError(f"msgpack: unsupported array dtype {name!r}")
        arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
        return arr[()] if code == _EXT_NPSCALAR else arr


def unpackb(data: bytes):
    """Decode one msgpack value (the subset flax emits)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError("msgpack: trailing bytes")
    return out


def _head(out: list, n: int, fix_base: int | None, fix_max: int,
          codes: tuple) -> None:
    """Append a length header: fix form below ``fix_max``, else the
    smallest of the 8/16/32-bit forms ``codes`` lists (None: absent)."""
    if fix_base is not None and n < fix_max:
        out.append(bytes([fix_base | n]))
        return
    for code, fmt, limit in zip(codes, "BHI", (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(bytes([code]) + struct.pack(">" + fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, np.asarray(obj), out)
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(bytes([obj]))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif obj >= 0:
            for code, fmt, limit in ((0xCC, "B", 1 << 8), (0xCD, "H", 1 << 16),
                                     (0xCE, "I", 1 << 32),
                                     (0xCF, "Q", 1 << 64)):
                if obj < limit:
                    out.append(bytes([code]) + struct.pack(">" + fmt, obj))
                    return
            raise ValueError(f"msgpack: int {obj} too large")
        else:
            for code, fmt, limit in ((0xD0, "b", 1 << 7), (0xD1, "h", 1 << 15),
                                     (0xD2, "i", 1 << 31),
                                     (0xD3, "q", 1 << 63)):
                if obj >= -limit:
                    out.append(bytes([code]) + struct.pack(">" + fmt, obj))
                    return
            raise ValueError(f"msgpack: int {obj} too small")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in sorted(obj.items()):  # flax's tree_map sorts keys
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, obj, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def _pack_ext(code: int, arr: np.ndarray, out: list) -> None:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"msgpack: unsupported array dtype {arr.dtype}")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError("msgpack: arrays over 2^30 bytes would need flax's "
                         "chunked form, which is not supported")
    inner: list = []
    _pack([list(arr.shape), arr.dtype.name, arr.tobytes("C")], inner)
    payload = b"".join(inner)
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(bytes([fixext[n]]))
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack(">b", code))
    out.append(payload)


def packb(obj) -> bytes:
    """Encode ``obj`` (dicts, lists, tuples, Python scalars, str, bytes,
    numpy arrays and scalars) byte for byte as flax's
    ``msgpack_serialize`` does (dict keys sorted)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def save_checkpoint(path: str, params: dict, batch_stats: dict, *,
                    opt_state: dict | None = None, global_step: int = 0,
                    meta: dict | None = None,
                    pruning_masks: dict | None = None) -> None:
    """Write the reference's checkpoint layout. ``params`` and
    ``batch_stats`` are trees of numpy arrays (``convert.state_dict_to_flax``
    of a model's ``state_dict`` gives both)."""
    obj = {
        "state_dict": {"params": params, "batch_stats": batch_stats},
        "optimizer_states": opt_state or {},
        "global_step": int(global_step),
        "meta": meta or {},
    }
    if pruning_masks:
        obj["pruning_masks"] = pruning_masks
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(packb(obj))


def load_checkpoint_raw(path: str) -> dict:
    with open(path, "rb") as f:
        return unpackb(f.read())


def load_checkpoint(path: str) -> dict:
    """{"params", "batch_stats", "opt_state", "global_step",
    "pruning_masks"} of a checkpoint file, as trees of numpy arrays."""
    obj = load_checkpoint_raw(path)
    sd = obj.get("state_dict", {})
    return {
        "params": sd.get("params", {}),
        "batch_stats": sd.get("batch_stats", {}),
        "opt_state": obj.get("optimizer_states", {}),
        "global_step": obj.get("global_step", 0),
        "pruning_masks": obj.get("pruning_masks", {}),
    }


# -- training states ---------------------------------------------------------


# Each optimizer's optax chain, element by element, as the reference
# builds it (``nerf_downstream_tpu/train/optim.py``): "state" is the
# transform's own (its ``leaves`` in the params tree's layout, and
# ``count`` where it counts updates), "trace" a momentum trace ({} without
# momentum), "sched" the lr schedule's update count ({} with a constant
# lr) and "empty" a transform without state (optax.adadelta's own
# add_decayed_weights, AdamW's decoupled decay, Rprop's sign flip). A
# coupled weight decay wraps the chain as {"0": {}, "1": chain}.
_CHAINS = {
    torch.optim.SGD: ("trace", "sched"),
    optim.Adam: ("state", "sched"),
    optim.AdamW: ("state", "empty", "sched"),
    optim.Adamax: ("state", "sched"),
    optim.Adagrad: ("state", "sched"),
    optim.Adadelta: ("empty", "state", "sched"),
    optim.RMSprop: ("state", "sched", "trace"),
    optim.Rprop: ("state", "empty"),
}


def _chain(optimizer) -> tuple[str, ...]:
    kind = type(optimizer)
    if kind not in _CHAINS:
        raise ValueError(f"{kind.__name__} has no optax layout (the "
                         f"optimizers of train/optim.py have)")
    return _CHAINS[kind]


def _momentum(optimizer) -> float:
    return float(optimizer.param_groups[0].get("momentum", 0.0) or 0.0)


def _leaf_state(optimizer, p, name: str) -> torch.Tensor:
    """One parameter's state tensor ``name`` (optax's leaf name; SGD's
    trace is torch's ``momentum_buffer``, zeros before the first step, as
    optax initialises it)."""
    if isinstance(optimizer, torch.optim.SGD):
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        return torch.zeros_like(p) if buf is None else buf
    return optimizer.state_of(p)[name]


def optimizer_state_to_optax(model, optimizer, step: int,
                             scheduled: bool) -> dict:
    """The reference's optax state of ``optimizer`` (an optimizer of
    ``train/optim.py``): its per-parameter state in the params tree's
    layout, its update count, the momentum trace where it has momentum,
    and the schedule's count (``step``) when the lr is ``scheduled``."""
    layout = convert.flax_layout(model)
    named = list(model.named_parameters())

    def tree(name):
        return convert.state_dict_to_flax(
            {n: _leaf_state(optimizer, p, name) for n, p in named},
            layout)["params"]

    entries = {}
    for i, kind in enumerate(_chain(optimizer)):
        entry = {}
        if kind == "state":
            entry = {name: tree(name) for name in optimizer.leaves}
            if optimizer.counted:
                count = optimizer.state_of(named[0][1])["count"]
                entry["count"] = np.asarray(count, np.int32)
        elif kind == "trace" and _momentum(optimizer):
            entry = {"trace": tree("trace")}
        elif kind == "sched" and scheduled:
            entry = {"count": np.asarray(step, np.int32)}
        entries[str(i)] = entry
    group = optimizer.param_groups[0]
    if group["weight_decay"] and not getattr(optimizer, "decoupled", False):
        return {"0": {}, "1": entries}
    return entries


def optimizer_state_from_optax(raw: dict, model, optimizer) -> None:
    """Load the reference's optax state ``raw`` into ``optimizer``: each
    leaf tree becomes that state tensor of every parameter (SGD's trace
    its ``momentum_buffer``), with the update count. The schedule's count
    is the training state's step (``global_step``)."""
    group = optimizer.param_groups[0]
    if group["weight_decay"] and not getattr(optimizer, "decoupled", False):
        raw = raw.get("1", {})
    trees, count = {}, None
    for i, kind in enumerate(_chain(optimizer)):
        entry = raw.get(str(i), {}) if isinstance(raw, dict) else {}
        if kind == "state":
            missing = [n for n in optimizer.leaves if n not in entry]
            if missing:
                raise ValueError(f"checkpoint optimizer state has no "
                                 f"{missing} for {type(optimizer).__name__}")
            trees.update({n: entry[n] for n in optimizer.leaves})
            if optimizer.counted:
                count = int(np.asarray(entry["count"]))
        elif kind == "trace" and _momentum(optimizer):
            if not entry.get("trace"):
                raise ValueError("checkpoint optimizer state has no momentum "
                                 f"trace for a {type(optimizer).__name__} "
                                 "with momentum")
            trees["trace"] = entry["trace"]
    named = list(model.named_parameters())
    for name, tree in trees.items():
        bufs = convert.flax_to_state_dict(model, tree)
        for n, p in named:
            t = bufs[n].to(device=p.device, dtype=p.dtype).clone()
            if isinstance(optimizer, torch.optim.SGD):
                optimizer.state[p]["momentum_buffer"] = t
            else:
                optimizer.state_of(p)[name] = t
    if count is not None:
        for _, p in named:
            optimizer.state_of(p)["count"] = count


def convert_self_supervised(raw_params: dict, raw_stats: dict,
                            target_params: dict,
                            target_stats: dict) -> tuple[dict, dict]:
    """The reference's transfer of a self-supervised checkpoint's trees
    onto a target's (``params``, ``batch_stats``, flax layout): every leaf
    under a key that contains "final" or "predictor", every leaf the
    checkpoint lacks and every leaf whose shape differs keeps the
    target's; every other leaf is the checkpoint's."""

    def merge(raw, target):
        if not isinstance(target, dict):
            if raw is None:
                return target
            raw_arr = np.asarray(raw)
            return raw_arr if raw_arr.shape == np.shape(target) else target
        out = {}
        for k, v in target.items():
            if "final" in k or "predictor" in k:
                out[k] = v
                continue
            out[k] = merge(raw.get(k) if isinstance(raw, dict) else None, v)
        return out

    return merge(raw_params, target_params), merge(raw_stats, target_stats)


def save_training_state(path: str, state, meta: dict | None = None) -> None:
    """Write ``state`` (``train.state.TrainState``) in the reference's
    layout: params and batch_stats, the optax optimizer state and
    ``global_step``."""
    tree = convert.state_dict_to_flax(state.model.state_dict(),
                                      convert.flax_layout(state.model))
    save_checkpoint(
        path, tree.get("params", {}), tree.get("batch_stats", {}),
        opt_state=optimizer_state_to_optax(
            state.model, state.optimizer, state.step,
            state.schedule is not None),
        global_step=state.step, meta=meta)


def restore_into(state, raw: dict, *, weights: bool = True,
                 optimizer: bool = False):
    """Bind a loaded checkpoint (``load_checkpoint``) onto ``state`` in
    place: the weights (params and batch_stats) and, with ``optimizer``,
    the optimizer state. The step is the caller's to restore (the
    reference's Trainer sets it from ``global_step``)."""
    if weights:
        full = bool(raw.get("batch_stats"))
        sd = convert.flax_to_state_dict(
            state.model,
            {"params": raw["params"], "batch_stats": raw["batch_stats"]}
            if full else raw["params"])
        dev = next(state.model.parameters()).device
        state.model.load_state_dict({k: v.to(dev) for k, v in sd.items()},
                                    strict=full)
    if optimizer and raw.get("opt_state"):
        optimizer_state_from_optax(raw["opt_state"], state.model,
                                   state.optimizer)
    return state
