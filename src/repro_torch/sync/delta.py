"""Wire format of the train-to-serve sync protocol (port of
``repro/sync/delta.py``, byte for byte the same records).

One record is one generation's change, encoded as::

    MAGIC(4) | header_len(u32) | payload_len(u32) | header JSON | payload | crc32(u32)

A record whose header or payload reaches 4 GiB, beyond the reference's
u32 lengths (a full-width qwen3-1.7b snapshot: its float32 params alone are
6.9 GB), is written with the magic ``RSY2`` and u64 lengths, the layout
otherwise the same; every smaller record keeps ``RSY1`` and is the
reference's byte for byte.

The header is compact sorted-key JSON describing every array of the payload
(section, owner, field, dtype, shape, byte offset); the payload is the raw
little-endian bytes of the arrays in header order; the CRC32 covers header
and payload. ``decode`` checks magic, lengths and checksum before it reads
any array, and raises ``DeltaCorruptError`` on a torn or corrupt record,
which a subscriber counts and drops.

Records:

- ``Delta``: per-stack ``StackDelta`` records (mode ``"topology"`` ships the
  whole exported leaf, mode ``"values"`` only the value fields of a stack
  whose mask did not move) and the dense (non-stack) params.
- ``Snapshot``: the flattened params and masks, a topology record per stack
  and the plan meta (path, values_dtype, tp) a subscriber bootstraps from.

Arrays are host (CPU) tensors. bfloat16 and the float8 types travel as
their raw bytes and are viewed as ``torch.bfloat16`` / ``torch.float8_*``,
so no ``ml_dtypes`` is needed. The reference's format statics carry its
tensor-parallel shard count ``tp``: the port writes ``"tp": 1`` where the
reference does, and refuses a record with ``tp > 1``
(``UnsupportedStreamError``) rather than reading a sharded layout as a
replicated one.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import warnings
import zlib

import torch

from repro_torch.sparse import formats as F

_MAGIC = b"RSY1"        # the reference's records: u32 header and payload lengths
_MAGIC64 = b"RSY2"      # a record of 4 GiB or more: u64 lengths
_LEN = struct.Struct("<II")
_LEN64 = struct.Struct("<QQ")
_CRC = struct.Struct("<I")
_U32_MAX = 2**32 - 1

# the formats whose reference statics include the shard count ``tp``
_TP_FORMATS = frozenset({"structured", "condensed", "condensed_over_active"})


class DeltaCorruptError(ValueError):
    """A record failed magic, length, checksum or structure validation."""


class UnsupportedStreamError(ValueError):
    """A well-formed record of a layout the port does not serve yet."""


def _refuse_tp(tp) -> None:
    if int(tp) != 1:
        raise UnsupportedStreamError(
            f"sync stream with tp={tp}: tensor-parallel layouts are not ported yet "
            "(ROADMAP queue 1, item 9); the port never reads one as tp=1")


# dtypes that may appear on the wire, by the reference's (numpy) names
_WIRE_DTYPES: dict[str, torch.dtype] = {
    name: getattr(torch, name)
    for name in ("float32", "float64", "float16", "int8", "int16", "int32", "int64",
                 "uint8", "uint16", "uint32", "uint64", "bool", "bfloat16",
                 "float8_e4m3fn", "float8_e5m2")
    if isinstance(getattr(torch, name, None), torch.dtype)
}
_WIRE_NAMES = {dt: name for name, dt in _WIRE_DTYPES.items()}

# value-stream fields per format: what a ``mode="values"`` record ships
VALUE_FIELDS: dict[str, tuple[str, ...]] = {
    "condensed": ("values", "scales"),
    "condensed_over_active": ("values", "scales"),
    "structured": ("values", "scales"),
    "masked": (),
}


@dataclasses.dataclass
class StackDelta:
    """One sparse stack's update at one generation: the whole leaf
    (``mode="topology"``: ``static`` the format's statics, ``arrays`` every
    non-None array field) or its value fields (``mode="values"``, merged
    into the subscriber's stored record). ``mask_version`` is the trainer's
    per-stack counter the handshake checks."""

    name: str
    mask_version: int
    mode: str                      # "topology" | "values"
    format: str                    # formats.FORMATS key
    static: dict
    arrays: dict                   # field -> CPU tensor


@dataclasses.dataclass
class Delta:
    generation: int
    stacks: list[StackDelta]
    dense: dict                    # "/"-joined path -> CPU tensor (params)

    kind = "delta"


@dataclasses.dataclass
class Snapshot:
    generation: int
    meta: dict                     # {"path", "values_dtype", "tp", ["arch"]}
    mask_versions: dict            # stack name -> int
    stacks: list[StackDelta]       # all mode="topology"
    params: dict                   # "/"-joined path -> CPU tensor
    masks: dict                    # "/"-joined path -> CPU tensor

    kind = "snapshot"


# ---------------------------------------------------------------------------
# trees <-> flat dicts ("/"-joined paths, as stack names are)
# ---------------------------------------------------------------------------

def flatten_tree(tree, prefix: tuple = ()) -> dict:
    """Nested str-keyed dicts -> {"a/b/c": leaf}."""
    flat: dict = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat.update(flatten_tree(tree[k], prefix + (str(k),)))
    else:
        flat["/".join(prefix)] = tree
    return flat


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


# ---------------------------------------------------------------------------
# leaf <-> record
# ---------------------------------------------------------------------------

def to_host(t) -> torch.Tensor:
    """A contiguous CPU tensor of a wire-safe dtype."""
    t = torch.as_tensor(t).detach().to("cpu").contiguous()
    if t.dtype not in _WIRE_NAMES:
        raise DeltaCorruptError(f"dtype {t.dtype} not wire-safe")
    return t


def leaf_to_wire(name: str, mask_version: int, leaf, *, mode: str = "topology") -> StackDelta:
    """A formats leaf -> a host-side StackDelta record."""
    fields = leaf._array_fields if mode == "topology" else VALUE_FIELDS[leaf.format_name]
    arrays = {f: to_host(getattr(leaf, f)) for f in fields
              if getattr(leaf, f, None) is not None}
    static = {f: getattr(leaf, f) for f in leaf._static_fields}
    if leaf.format_name in _TP_FORMATS:
        static["tp"] = 1
    return StackDelta(name=name, mask_version=int(mask_version), mode=mode,
                      format=leaf.format_name, static=static, arrays=arrays)


def leaf_static(rec: StackDelta) -> dict:
    """A record's statics as the port's format constructor takes them (the
    reference's ``tp``, always 1 here, left out)."""
    return {f: rec.static[f] for f in F.FORMATS[rec.format]._static_fields
            if f in rec.static}


def wire_to_leaf(rec: StackDelta, *, device=None):
    """The formats leaf of a topology record (arrays copied to ``device``
    when given, else the record's CPU tensors)."""
    if rec.mode != "topology":
        raise DeltaCorruptError(f"stack {rec.name!r}: cannot build a leaf from a "
                                f"mode={rec.mode!r} record")
    cls = F.FORMATS.get(rec.format)
    if cls is None:
        raise DeltaCorruptError(f"unknown format {rec.format!r}")
    kw = leaf_static(rec)
    for f in cls._array_fields:
        arr = rec.arrays.get(f)
        kw[f] = arr.to(device, copy=True) if arr is not None and device is not None else arr
    return cls(**kw)


# ---------------------------------------------------------------------------
# encode / decode
# ---------------------------------------------------------------------------

def _raw(t: torch.Tensor):
    """The bytes of a contiguous CPU tensor, without a copy."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _iter_record_arrays(obj):
    for sd in obj.stacks:
        for field in sorted(sd.arrays):
            yield "stack", sd.name, field, sd.arrays[field]
    if obj.kind == "delta":
        for path in sorted(obj.dense):
            yield "dense", path, "", obj.dense[path]
    else:
        for path in sorted(obj.params):
            yield "params", path, "", obj.params[path]
        for path in sorted(obj.masks):
            yield "masks", path, "", obj.masks[path]


def encode(obj) -> bytes:
    """Delta | Snapshot -> checksummed wire bytes (the payload is copied
    once, into the record)."""
    descs, chunks, offset = [], [], 0
    for section, owner, field, arr in _iter_record_arrays(obj):
        t = to_host(arr)
        buf = _raw(t)
        descs.append({"section": section, "owner": owner, "field": field,
                      "dtype": _WIRE_NAMES[t.dtype], "shape": list(t.shape),
                      "offset": offset, "nbytes": int(buf.nbytes)})
        chunks.append(buf)
        offset += int(buf.nbytes)
    header = {
        "kind": obj.kind,
        "generation": int(obj.generation),
        "arrays": descs,
        "stacks": [{"name": sd.name, "mask_version": int(sd.mask_version), "mode": sd.mode,
                    "format": sd.format, "static": dict(sd.static)}
                   for sd in obj.stacks],
    }
    if obj.kind == "snapshot":
        header["meta"] = obj.meta
        header["mask_versions"] = {k: int(v) for k, v in obj.mask_versions.items()}
    hdr = json.dumps(header, sort_keys=True, separators=(",", ":")).encode("utf-8")
    crc = zlib.crc32(hdr)
    for c in chunks:
        crc = zlib.crc32(c, crc)
    if max(len(hdr), offset) <= _U32_MAX:
        magic, lens = _MAGIC, _LEN.pack(len(hdr), offset)
    else:
        magic, lens = _MAGIC64, _LEN64.pack(len(hdr), offset)
    return b"".join([magic, lens, hdr, *chunks, _CRC.pack(crc)])


def decode(blob):
    """Wire bytes -> Delta | Snapshot. Raises ``DeltaCorruptError``, or
    ``UnsupportedStreamError`` for a tensor-parallel (tp > 1) record."""
    if not isinstance(blob, (bytes, bytearray, memoryview)):
        raise DeltaCorruptError("not a bytes object")
    mv = memoryview(blob).cast("B")
    lens = {_MAGIC: _LEN, _MAGIC64: _LEN64}.get(bytes(mv[:4]))
    if len(mv) < len(_MAGIC) + _LEN.size + _CRC.size:
        raise DeltaCorruptError("record truncated")
    if lens is None:
        raise DeltaCorruptError("bad magic")
    if len(mv) < len(_MAGIC) + lens.size + _CRC.size:
        raise DeltaCorruptError("record truncated")
    hdr_len, pay_len = lens.unpack_from(mv, 4)
    body_start = 4 + lens.size
    body_end = body_start + hdr_len + pay_len
    if body_end + _CRC.size != len(mv):
        raise DeltaCorruptError("length mismatch")
    (crc,) = _CRC.unpack_from(mv, body_end)
    if zlib.crc32(mv[body_start:body_end]) != crc:
        raise DeltaCorruptError("checksum mismatch")
    try:
        header = json.loads(bytes(mv[body_start:body_start + hdr_len]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise DeltaCorruptError(f"bad header: {e}") from None
    try:
        return _rebuild(header, mv[body_start + hdr_len:body_end])
    except (DeltaCorruptError, UnsupportedStreamError):
        raise
    except (KeyError, TypeError, ValueError, RuntimeError) as e:
        raise DeltaCorruptError(f"malformed record: {e}") from None


def _array(payload, d: dict) -> torch.Tensor:
    dt = _WIRE_DTYPES.get(d["dtype"])
    if dt is None:
        raise DeltaCorruptError(f"unknown wire dtype {d['dtype']!r}")
    start, nbytes = int(d["offset"]), int(d["nbytes"])
    shape = [int(n) for n in d["shape"]]
    buf = payload[start:start + nbytes]
    if len(buf) != nbytes or start < 0:
        raise DeltaCorruptError("payload truncated")
    if nbytes == 0:
        return torch.empty(shape, dtype=dt)
    with warnings.catch_warnings():  # a read-only buffer: cloned before use
        warnings.simplefilter("ignore", UserWarning)
        raw = torch.frombuffer(buf, dtype=torch.uint8).clone()
    return raw.view(dt).reshape(shape)


def _rebuild(header: dict, payload):
    arrays: dict[tuple, torch.Tensor] = {}
    for d in header["arrays"]:
        arrays[(d["section"], d["owner"], d["field"])] = _array(payload, d)
    stacks = []
    for sd in header["stacks"]:
        stack_arrays = {field: arr for (sec, owner, field), arr in arrays.items()
                        if sec == "stack" and owner == sd["name"]}
        stacks.append(StackDelta(name=sd["name"], mask_version=int(sd["mask_version"]),
                                 mode=sd["mode"], format=sd["format"],
                                 static=_restore_static(sd["format"], sd["static"]),
                                 arrays=stack_arrays))
    gen = int(header["generation"])
    if header["kind"] == "delta":
        dense = {owner: arr for (sec, owner, _), arr in arrays.items() if sec == "dense"}
        return Delta(generation=gen, stacks=stacks, dense=dense)
    if header["kind"] == "snapshot":
        _refuse_tp(header["meta"].get("tp", 1))
        params = {owner: arr for (sec, owner, _), arr in arrays.items() if sec == "params"}
        masks = {owner: arr for (sec, owner, _), arr in arrays.items() if sec == "masks"}
        return Snapshot(generation=gen, meta=header["meta"],
                        mask_versions={k: int(v) for k, v in header["mask_versions"].items()},
                        stacks=stacks, params=params, masks=masks)
    raise DeltaCorruptError(f"unknown record kind {header['kind']!r}")


def _restore_static(format_name: str, static: dict) -> dict:
    """A record's statics, keys checked against the format's declared
    statics (so a doctored header cannot pass other constructor arguments)
    and the reference's ``tp`` checked to be 1. The record keeps ``tp``, so
    it encodes back to the same bytes; ``leaf_static`` leaves it out."""
    cls = F.FORMATS.get(format_name)
    if cls is None:
        raise DeltaCorruptError(f"unknown format {format_name!r}")
    allowed = set(cls._static_fields) | ({"tp"} if format_name in _TP_FORMATS else set())
    extra = set(static) - allowed
    if extra:
        raise DeltaCorruptError(f"static fields {sorted(extra)} not declared by {format_name}")
    _refuse_tp(static.get("tp", 1))
    return dict(static)
