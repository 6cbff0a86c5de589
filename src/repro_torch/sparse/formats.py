"""Serving formats for sparse weight stacks (port of ``repro/sparse/formats.py``).

One trained constant fan-in topology executes under several storage and
compute representations (paper Sec. 4.4, Fig. 4); each is a frozen
dataclass with the ``SparseFormat`` protocol:

* ``MaskedDense``         — dense weight + bool mask, dense matmul.
* ``StructuredFanIn``     — ablated output neurons dropped, surviving
                            columns kept dense and run through the
                            column-gathered kernel (K5/K6). Exact only for
                            ablation-only masks.
* ``Condensed``           — the constant fan-in gather layout (Alg. 1, K1).
* ``CondensedOverActive`` — ablated neurons dropped first, survivors
                            condensed (K4). Exact for any mask.

Protocol: ``apply(x, w)`` runs one layer (``w`` is the live dense weight,
read by the masked and structured formats); ``layer(i)`` slices layer ``i``
out of a stack; ``to(device)``; ``spec()`` gives the static ``FormatSpec``
that ``estimate_cost`` / ``estimate_weight_bytes`` price (the plan's cost
model, the same formulas as the reference so that plans agree);
``abstract`` gives a leaf of meta tensors at a static fan-in, which the dry
run builds without allocating (``launch/dryrun.py``).

Quantized values (``quantize_spec="int8"|"fp8"``): the value-storing
formats keep 1-byte codes and a per-neuron float32 ``scales`` (symmetric,
absmax / qmax); ``Condensed`` and ``CondensedOverActive`` hand the codes and
scales to the dequant-fused kernel (K2), ``StructuredFanIn`` keeps the
quantized gathered panel and dequantizes it before K5. ``"bf16"`` is a plain
storage cast. ``restore_finalize`` reconciles a checkpoint's values with the
template's declared storage. Tensor-parallel blocks come with a later
slice.

Refresh (``donate_refresh``, ``refresh_values``, ``adopt_arrays``): the
reference donates a leaf's old buffers to a jitted re-export so that XLA
writes the new arrays into them. The port's form of donation is a
``copy_`` into the leaf's existing tensors: when the new arrays have the
old shapes and dtypes, the refreshed leaf keeps every tensor (same
``data_ptr``), so a CUDA graph captured over the old leaf reads the new
numbers on its next replay. The condensed layouts re-export one layer of
the stack at a time straight into those tensors, so a refresh holds one
layer's temporaries, never a second copy of the stack. A changed shape (the
fan-in ``k`` or condensed_over_active's ``max_active`` moved) returns a
fresh export, and ``donate=False`` always returns fresh tensors, leaving
the old leaf intact. Padding slots and rows come out +0 as in a fresh
export: values are selected, never multiplied by a mask.
"""
from __future__ import annotations

import dataclasses
import math
import typing

import torch

from repro_torch.core import topology
from repro_torch.core.srigl import apply_mask_for_forward
from repro_torch.kernels import ops
from repro_torch.kernels.structured_matmul import padded_active_count


class ExportStats(typing.NamedTuple):
    """Realized per-stack statistics that size an export."""

    k: int                  # max realized fan-in over the stack's columns
    max_active: int         # max surviving-neuron count over the stack's layers
    active_fraction: float  # mean fraction of neurons with any non-zero
    min_fan_in: int         # min fan-in over active columns (d_in iff ablation-only)


def stats_row(mask: torch.Tensor) -> torch.Tensor:
    """The four ExportStats of one stacked mask (*lead, d_in, d_out), on its
    device. The fan-ins are counted one layer at a time: a sum to int32
    casts its input first, so a whole-stack sum would hold a 4-byte copy of
    the mask."""
    layers = mask.reshape(-1, *mask.shape[-2:])
    nnz = torch.stack([m.sum(dim=-2, dtype=torch.int32) for m in layers]).reshape(
        *mask.shape[:-2], mask.shape[-1])                      # (*lead, d_out)
    act = nnz > 0
    return torch.stack([
        nnz.max().float(),
        act.sum(dim=-1, dtype=torch.int32).max().float(),
        act.float().mean(),
        torch.where(act, nnz, mask.shape[-2]).min().float(),
    ])


def stats_from_row(row) -> ExportStats:
    return ExportStats(k=int(row[0]), max_active=int(row[1]),
                       active_fraction=float(row[2]), min_fan_in=int(row[3]))


def realized_stats(mask: torch.Tensor) -> ExportStats:
    """ExportStats of one stacked mask, with one host sync."""
    return stats_from_row(stats_row(mask).tolist())


@dataclasses.dataclass(frozen=True)
class FormatSpec:
    """Static geometry a format is priced from (no tensors)."""

    d_in: int
    d_out: int
    n_replicas: int
    itemsize: int           # bytes of one stored value or weight
    k: int                  # constant fan-in
    max_active: float       # exported row count (condensed-over-active, structured)
    active_fraction: float  # mean active-neuron fraction
    values_dtype: str | None = None  # stored values' canonical name; None = itemsize's


# ---------------------------------------------------------------------------
# quantized values: canonical dtype names and per-neuron symmetric scales
# ---------------------------------------------------------------------------

# the names --values-dtype takes; fp8 is OCP E4M3 (finite max 448)
VALUES_DTYPES: dict[str, torch.dtype] = {
    "f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
}
QUANTIZED_DTYPES = ("int8", "fp8")
# a row's absmax maps onto the code's top value
_QMAX = {"int8": 127.0, "fp8": 448.0}


def resolve_quantize_spec(spec) -> str | None:
    """A quantize spec (canonical name, torch dtype or None) as a canonical
    name; ``"f32"`` and None mean no quantization (float values, no scales)."""
    if spec is None or spec == "f32":
        return None
    if isinstance(spec, str):
        name = spec
    else:
        by_dtype = {v: k for k, v in VALUES_DTYPES.items()}
        name = by_dtype.get(spec, str(spec))
    if name in ("f32", "float32"):
        return None
    if name not in VALUES_DTYPES:
        raise ValueError(f"unknown values dtype {spec!r}; expected one of "
                         f"{sorted(VALUES_DTYPES)}")
    return name


def values_itemsize(spec: FormatSpec) -> int:
    """Bytes of one stored value under ``spec`` (the streamed width)."""
    if spec.values_dtype is None:
        return spec.itemsize
    return VALUES_DTYPES[spec.values_dtype].itemsize


def quantize_values(values: torch.Tensor, name: str, *, axis: int = -1):
    """Per-neuron symmetric quantization of float values.

    ``axis`` is the within-neuron axis the scale reduces (fan-in ``k`` for
    the condensed layouts, ``d_in`` for the structured panel). Returns
    ``(q, scales)``: ``scales = absmax / qmax`` in float32 (1 for an all-zero
    row, whose codes are then exact zeros) and ``q`` the rounded
    ``values / scales`` (int8: half to even, clipped to +-127; fp8: the cast's
    round to nearest even). The same steps as the reference, so the codes
    are its codes bit for bit.
    """
    name = resolve_quantize_spec(name)
    if name not in QUANTIZED_DTYPES:
        raise ValueError(f"quantize_values needs one of {QUANTIZED_DTYPES}, got {name!r}")
    v = values.float()
    amax = v.abs().amax(dim=axis, keepdim=True)
    scales = torch.where(amax > 0, amax / _QMAX[name], torch.ones_like(amax))
    scaled = v / scales
    if name == "int8":
        q = torch.clamp(torch.round(scaled), -127.0, 127.0).to(torch.int8)
    else:
        q = scaled.to(VALUES_DTYPES[name])
    return q, scales.squeeze(axis)


def dequantize_values(q: torch.Tensor, scales: torch.Tensor, *, axis: int = -1,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_values``: each code times its neuron's scale."""
    return (q.float() * scales.float().unsqueeze(axis)).to(dtype)


def is_quantized_storage(arr_or_dtype) -> bool:
    """Is this tensor (or dtype) stored in a quantized values dtype?"""
    dt = getattr(arr_or_dtype, "dtype", arr_or_dtype)
    return any(VALUES_DTYPES[n] == dt for n in QUANTIZED_DTYPES)


def _finalize_quantized_restore(fmt, *, axis: int = -1):
    """Reconcile restored values/scales with the declared ``values_dtype``:
    float values in a quantized template are quantized, codes with scales
    in a float template are dequantized (to float32) and the scales
    dropped. ``axis`` is the class's per-neuron reduction axis."""
    vals = fmt.values
    if vals is None:
        return fmt
    if fmt.values_dtype in QUANTIZED_DTYPES:
        if vals.is_floating_point() and not is_quantized_storage(vals):
            q, s = quantize_values(vals, fmt.values_dtype, axis=axis)
            return dataclasses.replace(fmt, values=q, scales=s)
        return fmt
    if is_quantized_storage(vals) and fmt.scales is not None:
        return dataclasses.replace(fmt, values=dequantize_values(vals, fmt.scales, axis=axis),
                                   scales=None)
    return fmt


def spec_for_stack(stack, stats: ExportStats, itemsize: int,
                   values_dtype: str | None = None) -> FormatSpec:
    """``stack``: a registry ``SparseStack`` or anything with d_in/d_out."""
    return FormatSpec(d_in=stack.d_in, d_out=stack.d_out,
                      n_replicas=getattr(stack, "n_replicas", 1), itemsize=itemsize,
                      k=max(stats.k, 1), max_active=max(stats.max_active, 1),
                      active_fraction=min(max(stats.active_fraction, 0.0), 1.0),
                      values_dtype=resolve_quantize_spec(values_dtype))


def shape_tuning_key(d_in: int, n_out: int, k: int, batch: int, *,
                     backend: str | None = None, itemsize: int = 4,
                     kind: str = "condensed", scatter_width: int | None = None,
                     values_dtype: str | None = None,
                     compute_dtype: torch.dtype | None = None) -> str:
    """The launch-configuration cache key of one kernel shape:
    ``{backend}/{width}/d{d_in}/n{n_out}/k{k}/b{bucket}[/{kind}-o{scatter_width}]``,
    ``width`` ``w{bits}`` or ``w{int8,fp8}-x{compute}``.

    The one definition that the formats' ``tuning_key``, ``sparse.autotune``
    (which writes entries under it) and ``kernels.ops`` (which reads them)
    share. ``backend`` is ``autotune.device_key``'s name of the device (the
    card's name, or ``cpu``; None: the card, raising without one), so an entry
    timed on the CPU never serves the card. The batch is bucketed
    (``plan.batch_bucket``): an entry serves every batch of its bucket.
    ``kind`` keeps the kernels' key spaces apart: ``"condensed"`` (K1/K2),
    ``"coa"`` (K4/K2-coa; ``n_out``/``k`` the surviving rows' arrays) and
    ``"structured"`` (K5; ``n_out`` the padded active columns, ``k`` 0),
    the last two with the dense output width ``scatter_width``.

    A float key is the reference's letter for letter: its width is the bit
    width of the values, which are stored at the compute dtype. A quantized
    ``values_dtype`` keys as ``wint8``/``wfp8`` followed by the compute
    dtype (``compute_dtype``, required), e.g. ``wint8-xbf16``: the
    reference's key leaves the compute dtype out, so there an entry tuned
    in bf16 is read by an f32 run of the same shape, whose launches differ
    (a bf16 ``block_b`` above 8 has no f32 launch).
    """
    from repro_torch.sparse import autotune as AT  # lazy: the plan imports this module
    from repro_torch.sparse.plan import batch_bucket
    backend = backend or AT.device_key()
    vd = resolve_quantize_spec(values_dtype)
    if vd in QUANTIZED_DTYPES:
        if compute_dtype is None:
            raise ValueError(f"a {vd} key names the compute dtype its launch runs at "
                             "(compute_dtype=)")
        width = f"w{vd}-x{dtype_name(compute_dtype)}"
    else:
        width = f"w{itemsize * 8}"
    key = f"{backend}/{width}/d{d_in}/n{n_out}/k{k}/b{batch_bucket(batch)}"
    if kind != "condensed":
        key += f"/{kind}-o{scatter_width}"
    return key


def _meta(shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` with no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


def dtype_name(dtype: torch.dtype) -> str:
    """The short name of a torch dtype: ``VALUES_DTYPES``' where it has one
    (``f32``, ``bf16``), else torch's (``float16``)."""
    for name, dt in VALUES_DTYPES.items():
        if dt == dtype:
            return name
    return str(dtype).removeprefix("torch.")


def _leaf_backend(backend: str | None, t: torch.Tensor) -> str:
    from repro_torch.sparse import autotune as AT
    return backend or AT.device_key(t.device)


def active_index_from_bools(neuron_active: torch.Tensor, a_pad: int) -> torch.Tensor:
    """Surviving-column ids for the structured kernel: (*lead, a_pad) int32,
    the active columns in increasing order, then the sentinel ``d_out``."""
    d_out = neuron_active.shape[-1]
    n = min(a_pad, d_out)
    order = torch.argsort((~neuron_active).to(torch.uint8), dim=-1, stable=True)[..., :n]
    ids = torch.where(torch.gather(neuron_active, -1, order), order, d_out)
    pad = ids.new_full((*ids.shape[:-1], a_pad - n), d_out)
    return torch.cat([ids, pad], dim=-1).to(torch.int32).contiguous()


def active_index_from_mask(mask: torch.Tensor, a_pad: int) -> torch.Tensor:
    """``active_index_from_bools`` of the mask's column-activity bools."""
    return active_index_from_bools(mask.any(dim=-2), a_pad)


def _gather_active_panel(weight: torch.Tensor, mask: torch.Tensor,
                         active_index: torch.Tensor) -> torch.Tensor:
    """(*lead, d_in, a_pad) surviving-column panel of ``weight * mask``
    (masked-out entries +0, as in ``topology.dense_to_condensed``).
    Sentinel slots are zero, so they quantize to exact zeros and never enter
    a real column's scale."""
    d_out = weight.shape[-1]
    cols = active_index.clamp(max=d_out - 1).long()[..., None, :]
    masked = torch.where(mask, weight, torch.zeros_like(weight))
    g = torch.gather(masked, -1, cols.expand(*weight.shape[:-1], cols.shape[-1]))
    return torch.where((active_index < d_out)[..., None, :], g, torch.zeros_like(g))


def _condense_active_stack(weight: torch.Tensor, mask: torch.Tensor, k: int, a: int):
    """Condensed-over-active arrays of one stack (*lead, d_in, d_out).

    Active output columns first (a stable sort, so in increasing order), the
    first ``a`` of them condensed to fan-in ``k``. Rows past a layer's
    realized active count are padding: values 0 and ``out_index == d_out``.
    A neuron is active iff its mask column has any non-zero.
    """
    d_out = weight.shape[-1]
    col_active = mask.any(dim=-2)                                     # (*lead, d_out)
    order = torch.argsort((~col_active).to(torch.uint8), dim=-1, stable=True)[..., :a]
    sel = torch.gather(col_active, -1, order)                         # (*lead, a)
    cols = order[..., None, :].expand(*weight.shape[:-1], a)
    w_sel = torch.gather(weight, -1, cols)
    m_sel = torch.gather(mask, -1, cols) & sel[..., None, :]
    values, indices = topology.dense_to_condensed(w_sel * m_sel, m_sel, k)
    out_index = torch.where(sel, order, d_out).to(torch.int32).contiguous()
    return values, indices, out_index


# ---------------------------------------------------------------------------
# refresh in place: the port's form of the reference's donated programs
# ---------------------------------------------------------------------------


def adopt_array(new, old: torch.Tensor | None = None, *, donate: bool = True,
                device=None) -> torch.Tensor:
    """``new`` (a host or device tensor) as the leaf's tensor: written into
    ``old`` with ``copy_`` when ``donate`` and shape and dtype match (the
    old storage kept, a host source copied on the current stream, so before
    any later replay), else a fresh copy on ``device`` (``old``'s by
    default), never an alias of ``new``."""
    src = torch.as_tensor(new)
    if (donate and old is not None and tuple(old.shape) == tuple(src.shape)
            and old.dtype == src.dtype):
        return old.copy_(src)
    if device is None:
        device = old.device if old is not None else src.device
    return src.to(device, copy=True)


def _flat_lead(t: torch.Tensor, n_tail: int) -> torch.Tensor:
    """``t`` with its leading (stack) dims merged into one axis in front of
    its last ``n_tail``: a view of its storage (exports are contiguous)."""
    return t.reshape(-1, *t.shape[t.ndim - n_tail:])


def _same_layout(old: dict, shapes: dict) -> bool:
    """Do the leaf's tensors have the shapes the refresh will write?"""
    return (set(old) == set(shapes)
            and all(tuple(old[f].shape) == tuple(shp) for f, shp in shapes.items()))


def _write_layers(targets: dict, make, n_lead: int, *inputs) -> dict:
    """Fill ``targets`` (field -> tensor with ``n_lead`` stack dims) one
    stack layer at a time: ``make(*layer_inputs) -> {field: tensor}`` is
    one layer's export, cast into the target by ``copy_``. Returns
    ``targets``."""
    flat_in = [_flat_lead(t, t.ndim - n_lead) for t in inputs]
    flat_out = {f: _flat_lead(t, t.ndim - n_lead) for f, t in targets.items()}
    for i in range(flat_in[0].shape[0]):
        for f, t in make(*(x[i] for x in flat_in)).items():
            flat_out[f][i].copy_(t)
    return targets


def _targets(leaf, fields: tuple, donate: bool) -> dict:
    """The tensors a refresh writes: the leaf's own (``donate``) or fresh
    ones of the same shapes and dtypes."""
    return {f: getattr(leaf, f) if donate else torch.empty_like(getattr(leaf, f))
            for f in fields}


def _regather(w: torch.Tensor, mask: torch.Tensor, indices: torch.Tensor,
              out_index: torch.Tensor | None = None) -> torch.Tensor:
    """``w * mask`` gathered at the stored condensed indices (any stack
    dims): the values a fresh export of an unchanged topology gives. The
    mask is applied by a select, so padding slots (which point at
    mask-False rows) come out +0; with ``out_index``, padding rows
    (``out_index == d_out``) are +0 too."""
    d_out = w.shape[-1]
    wm = torch.where(mask, w, torch.zeros_like(w)).transpose(-1, -2)      # (.., d_out, d_in)
    if out_index is not None:
        rows = out_index.clamp(max=d_out - 1).long()[..., None]
        wm = torch.gather(wm, -2, rows.expand(*rows.shape[:-1], wm.shape[-1]))
    vals = torch.gather(wm, -1, indices.long())
    if out_index is not None:
        vals = torch.where((out_index < d_out)[..., None], vals, torch.zeros_like(vals))
    return vals


def _revalue(leaf, w, mask, donate: bool, *stored) -> "SparseFormat":
    """A condensed-family leaf's values regathered at its ``stored`` index
    arrays (indices, and out_index for condensed_over_active), quantized
    again when the leaf stores codes, written one layer at a time into its
    values (and scales), kept (``donate``) or fresh."""
    quant = leaf.values_dtype in QUANTIZED_DTYPES and leaf.scales is not None

    def make(wl, ml, *st):
        vals = _regather(wl, ml, *st)
        if not quant:
            return {"values": vals}
        q, sc = quantize_values(vals, leaf.values_dtype)
        return {"values": q, "scales": sc}

    fields = ("values", "scales") if quant else ("values",)
    targets = _write_layers(_targets(leaf, fields, donate), make, w.ndim - 2, w, mask, *stored)
    return dataclasses.replace(leaf, **targets)


class SparseFormat:
    """Base of the serving formats (see the module docstring).

    Subclasses are frozen dataclasses naming their tensor fields in
    ``_array_fields``; ``unstack``, ``layer``, ``to``, ``bridge.flatten``
    and the checkpoint walk those. An optional field may be None (``scales`` of a
    float export); ``arrays`` leaves it out.
    """

    format_name: typing.ClassVar[str]
    _array_fields: typing.ClassVar[tuple[str, ...]]
    # the non-tensor fields a leaf is rebuilt from (the sync wire's "static")
    _static_fields: typing.ClassVar[tuple[str, ...]] = ()

    def apply(self, x: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
        raise NotImplementedError

    def arrays(self) -> dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in self._array_fields
                if getattr(self, f) is not None}

    def unstack(self) -> list:
        """The layers of a stacked instance, each tensor split once on axis 0
        by ``unbind`` (whose backward stacks the layers' gradients in one op)."""
        parts = {f: t.unbind(0) for f, t in self.arrays().items()}
        n = len(next(iter(parts.values())))
        return [dataclasses.replace(self, **{f: p[i] for f, p in parts.items()})
                for i in range(n)]

    def layer(self, i: int):
        """Layer ``i`` of a stacked instance."""
        return self.unstack()[i]

    def to(self, device):
        return dataclasses.replace(self, **{f: t.to(device) for f, t in self.arrays().items()})

    def spec(self) -> FormatSpec:
        raise NotImplementedError

    @classmethod
    def abstract(cls, lead: tuple[int, ...], d_in: int, d_out: int, k: int,
                 dtype: torch.dtype) -> "SparseFormat":
        """A leaf whose tensors lie on the meta device, at the field shapes
        and dtypes an export at fan-in ``k`` and param dtype ``dtype`` has
        (no storage: the dry run's, ``launch/dryrun.py``)."""
        raise NotImplementedError

    def cost(self, batch: int, profile) -> float:
        """Estimated seconds per serving step for this exported instance."""
        return self.estimate_cost(self.spec(), batch, profile)

    @classmethod
    def estimate_cost(cls, spec: FormatSpec, batch: int, profile) -> float:
        raise NotImplementedError

    @classmethod
    def estimate_weight_bytes(cls, spec: FormatSpec) -> int:
        """Per-step weight-side bytes this format reads."""
        raise NotImplementedError

    @classmethod
    def estimate_values_bytes(cls, spec: FormatSpec) -> int:
        """The value stream alone (values and scales, without the index
        arrays): the bytes quantization shrinks."""
        return cls.estimate_weight_bytes(spec)

    def tuning_key(self, batch: int, *, backend: str | None = None,
                   dtype: torch.dtype | None = None) -> str | None:
        """The launch-configuration cache key of this leaf's kernel launch
        at ``batch`` (``shape_tuning_key``; ``backend`` None: the leaf's
        device), or None where the format runs no tuned kernel. ``dtype``
        is the compute dtype the leaf is applied at, which a quantized
        leaf's key names (and a float leaf's values already are)."""
        return None

    @classmethod
    def spec_tuning_key(cls, spec: FormatSpec, batch: int, *,
                        backend: str | None = None,
                        dtype: torch.dtype | None = None) -> str | None:
        """``tuning_key`` from a ``FormatSpec`` alone (no tensors)."""
        return None

    def donate_refresh(self, w, mask, stats: ExportStats | None = None, *,
                       donate: bool = True) -> "SparseFormat":
        """Full re-export from (w, mask). With ``donate`` and unchanged
        shapes the new arrays are written into this leaf's tensors, which
        the caller must then not read as the old leaf."""
        return type(self).export_from_dense(w, mask, stats)

    def refresh_values(self, w, mask, *, donate: bool = True) -> "SparseFormat":
        """Values-only refresh under an unchanged topology (nothing to do
        for formats that read the live weight)."""
        return self

    def adopt_arrays(self, new: dict, *, donate: bool = True) -> "SparseFormat":
        """This leaf with the array fields named in ``new`` replaced by the
        given (host or device) tensors, each written into the old tensor
        where shape and dtype match (``adopt_array``): the sync
        subscriber's apply, whose arrays were exported elsewhere."""
        unknown = set(new) - set(self._array_fields)
        if unknown:
            raise ValueError(f"{type(self).__name__} has no array fields {sorted(unknown)}")
        device = next(iter(self.arrays().values())).device
        return dataclasses.replace(
            self, **{f: adopt_array(v, getattr(self, f), donate=donate, device=device)
                     for f, v in new.items()})

    def rebuild_missing(self, missing: frozenset) -> "SparseFormat":
        """Fix up array fields a checkpoint did not carry (``missing``
        names them); by default the template's arrays stay."""
        return self

    def restore_finalize(self) -> "SparseFormat":
        """Reconcile restored arrays with the declared storage dtype (a
        checkpoint keeps each format array at the archive's dtype where
        quantized and float storage differ); nothing to do by default."""
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class MaskedDense(SparseFormat):
    """Dense weight + bool mask, dense matmul. ``weight_itemsize`` records the
    dense weight's bytes per element so the instance prices itself."""

    mask: torch.Tensor                   # (*lead, d_in, d_out) bool
    weight_itemsize: int = 4

    format_name: typing.ClassVar[str] = "masked"
    _array_fields: typing.ClassVar[tuple[str, ...]] = ("mask",)
    _static_fields: typing.ClassVar[tuple[str, ...]] = ("weight_itemsize",)

    def apply(self, x, w=None):
        return torch.matmul(x, apply_mask_for_forward(w, self.mask).to(x.dtype))

    @classmethod
    def export_from_dense(cls, w, mask, stats=None):
        return cls(mask=mask, weight_itemsize=w.element_size())

    @classmethod
    def abstract(cls, lead, d_in, d_out, k, dtype):
        return cls(mask=_meta((*lead, d_in, d_out), torch.bool),
                   weight_itemsize=dtype.itemsize)

    def spec(self):
        d_in, d_out = self.mask.shape[-2:]
        return FormatSpec(d_in=d_in, d_out=d_out, n_replicas=math.prod(self.mask.shape[:-2]),
                          itemsize=self.weight_itemsize, k=d_in, max_active=d_out,
                          active_fraction=1.0)

    @classmethod
    def estimate_cost(cls, spec, batch, profile):
        b = max(int(batch), 1)
        flops = 2.0 * b * spec.n_replicas * spec.d_in * spec.d_out
        return max(cls.estimate_weight_bytes(spec) / profile.hbm_bytes_per_s,
                   flops / profile.mxu_flops_per_s)

    @classmethod
    def estimate_weight_bytes(cls, spec):
        # the dense weight and the bool mask the masked path also reads
        return spec.n_replicas * spec.d_in * spec.d_out * (spec.itemsize + 1)


@dataclasses.dataclass(frozen=True, eq=False)
class StructuredFanIn(SparseFormat):
    """Fig. 4 "structured": ablated neurons dropped, active columns dense.

    Runs the column-gathered kernel over ``active_index`` (the surviving
    column ids padded with the sentinel ``d_out`` to ``padded_active_count``),
    so the weight bytes and flops scale with the active fraction. Exact only
    for ablation-only masks, where it equals ``ops.structured_dense``.

    A quantized export stores the gathered (*lead, d_in, a_pad) panel as
    codes with per-column float32 ``scales`` (reduced over ``d_in``) and
    serves it instead of the live weight: ``apply`` dequantizes the panel in
    plain torch and runs K5 on it, as the reference does in plain jnp.
    ``values`` without ``scales`` (a quantized checkpoint restored into a
    float template) is the dequantized float panel. One layer of an MoE
    expert stack keeps the expert axis, ``active_index`` (E, a_pad), and
    ``apply`` takes x (E, ..., d_in) and the (E, d_in, d_out) weights
    through the expert-grouped launch (K5-moe, K6-moe).
    """

    neuron_active: torch.Tensor          # (*lead, d_out) bool
    active_index: torch.Tensor           # (*lead, a_pad) int32, padding = d_out
    d_in: int = 0
    weight_itemsize: int = 4
    values: torch.Tensor | None = None   # (*lead, d_in, a_pad) quantized panel
    scales: torch.Tensor | None = None   # (*lead, a_pad) float32, per column
    values_dtype: str | None = None      # canonical name when quantized

    format_name: typing.ClassVar[str] = "structured"
    _array_fields: typing.ClassVar[tuple[str, ...]] = ("neuron_active", "active_index",
                                                       "values", "scales")
    _static_fields: typing.ClassVar[tuple[str, ...]] = ("d_in", "weight_itemsize",
                                                        "values_dtype")

    def apply(self, x, w=None):
        # an MoE layer's experts, active_index (E, a_pad) against x (E, M, d):
        # one expert-grouped launch (K5-moe, or K6-moe at decode shapes)
        grouped = self.active_index.ndim == 2
        if self.values is not None:
            panel = (self.values if self.scales is None else
                     dequantize_values(self.values, self.scales, axis=-2, dtype=x.dtype))
            run = (ops.structured_gathered_linear_grouped if grouped
                   else ops.structured_gathered_linear_nd)
            return run(x, panel, self.active_index, self.neuron_active.shape[-1],
                       values_dtype=self.values_dtype)
        if grouped:
            return ops.structured_linear_grouped(x, w, self.active_index)
        return ops.structured_linear_nd(x, w, self.active_index)

    @classmethod
    def export_from_dense(cls, w, mask, stats=None, *, quantize_spec=None):
        fmt = cls.from_mask(mask, stats, weight_itemsize=w.element_size())
        qdt = resolve_quantize_spec(quantize_spec)
        if qdt not in QUANTIZED_DTYPES:
            return fmt  # a storage cast has nothing to store: the live weight is read
        q, s = quantize_values(_gather_active_panel(w, mask, fmt.active_index), qdt, axis=-2)
        return dataclasses.replace(fmt, values=q, scales=s, values_dtype=qdt)

    @classmethod
    def abstract(cls, lead, d_in, d_out, k, dtype):
        # a_pad is the padded d_out, the bound before any ablation is
        # realized; a concrete export shrinks it to the active count
        a_pad = padded_active_count(d_out, d_out)
        return cls(neuron_active=_meta((*lead, d_out), torch.bool),
                   active_index=_meta((*lead, a_pad), torch.int32), d_in=d_in,
                   weight_itemsize=dtype.itemsize)

    @classmethod
    def from_mask(cls, mask, stats=None, *, weight_itemsize: int = 4):
        """A neuron is active iff its mask column has any non-zero;
        ``active_index`` is sized at the realized active count (``stats``,
        else one host sync)."""
        stats = stats if stats is not None else realized_stats(mask)
        d_out = int(mask.shape[-1])
        a_pad = padded_active_count(max(stats.max_active, 1), d_out)
        return cls(neuron_active=mask.any(dim=-2),
                   active_index=active_index_from_mask(mask, a_pad),
                   d_in=int(mask.shape[-2]), weight_itemsize=weight_itemsize)

    def spec(self):
        d_out = self.neuron_active.shape[-1]
        a_pad = self.active_index.shape[-1]
        return FormatSpec(d_in=self.d_in, d_out=d_out,
                          n_replicas=math.prod(self.neuron_active.shape[:-1]),
                          itemsize=self.weight_itemsize, k=self.d_in, max_active=a_pad,
                          active_fraction=min(a_pad / max(d_out, 1), 1.0),
                          values_dtype=self.values_dtype)

    @classmethod
    def estimate_cost(cls, spec, batch, profile):
        # priced as the reference prices it, at the padded column count and
        # with its one-hot scatter epilogue's flops (a_pad * d_out per row),
        # so that the port's plans decide as the reference's do
        b = max(int(batch), 1)
        a_pad = padded_active_count(spec.max_active, spec.d_out)
        flops = 2.0 * b * spec.n_replicas * a_pad * (spec.d_in + spec.d_out)
        return max(cls.estimate_weight_bytes(spec) / profile.hbm_bytes_per_s,
                   flops / profile.mxu_flops_per_s)

    @classmethod
    def estimate_weight_bytes(cls, spec):
        # the gathered (d_in, a_pad) panel at its stored width (plus the
        # per-column scales when quantized) and the int32 active_index
        a_pad = padded_active_count(spec.max_active, spec.d_out)
        return cls.estimate_values_bytes(spec) + spec.n_replicas * a_pad * 4

    @classmethod
    def estimate_values_bytes(cls, spec):
        a_pad = padded_active_count(spec.max_active, spec.d_out)
        vb = spec.n_replicas * spec.d_in * a_pad * values_itemsize(spec)
        if spec.values_dtype in QUANTIZED_DTYPES:
            vb += spec.n_replicas * a_pad * 4
        return vb

    def tuning_key(self, batch, *, backend=None, dtype=None):
        return shape_tuning_key(
            self.d_in, self.active_index.shape[-1], 0, batch,
            backend=_leaf_backend(backend, self.active_index), itemsize=self.weight_itemsize,
            kind="structured", scatter_width=self.neuron_active.shape[-1],
            values_dtype=self.values_dtype, compute_dtype=dtype)

    @classmethod
    def spec_tuning_key(cls, spec, batch, *, backend=None, dtype=None):
        a_pad = padded_active_count(spec.max_active, spec.d_out)
        return shape_tuning_key(spec.d_in, a_pad, 0, batch, backend=backend,
                                itemsize=spec.itemsize, kind="structured",
                                scatter_width=spec.d_out, values_dtype=spec.values_dtype,
                                compute_dtype=dtype)

    def donate_refresh(self, w, mask, stats=None, *, donate=True):
        """A fresh export, written into this leaf's tensors when the active
        count (``a_pad``) kept every shape."""
        fresh = type(self).export_from_dense(w, mask, stats, quantize_spec=self.values_dtype)
        new = fresh.arrays()
        if donate and _same_layout(self.arrays(), {f: t.shape for f, t in new.items()}):
            return dataclasses.replace(
                fresh, **{f: getattr(self, f).copy_(t) for f, t in new.items()})
        return fresh

    def refresh_values(self, w, mask, *, donate=True):
        """Nothing for a float leaf (it reads the live weight). A quantized
        leaf's panel is regathered at the stored ``active_index`` and
        requantized, one layer at a time, into its codes and scales."""
        if self.values is None or self.scales is None:
            return self
        qdt = self.values_dtype

        def make(wl, ml, ai):
            q, sc = quantize_values(_gather_active_panel(wl, ml, ai), qdt, axis=-2)
            return {"values": q, "scales": sc}

        targets = _write_layers(_targets(self, ("values", "scales"), donate), make,
                                w.ndim - 2, w, mask, self.active_index)
        return dataclasses.replace(self, **targets)

    def rebuild_missing(self, missing):
        # an archive without the quantized panel cannot rebuild it (no live
        # weight here): serve the live weight, as the reference does
        if "values" in missing and self.values_dtype in QUANTIZED_DTYPES:
            return dataclasses.replace(self, values=None, scales=None)
        return self

    def restore_finalize(self):
        return _finalize_quantized_restore(self, axis=-2)


def _store_values(values: torch.Tensor, qdt: str | None, dtype: torch.dtype | None):
    """(values, scales) as a value-storing format keeps them: codes and
    per-row scales when ``qdt`` quantizes, else the values cast to the
    storage dtype ``qdt`` names, else to ``dtype`` (None keeps them)."""
    if qdt in QUANTIZED_DTYPES:
        return quantize_values(values, qdt)
    if qdt is not None:
        dtype = VALUES_DTYPES[qdt]
    return (values if dtype is None else values.to(dtype)).contiguous(), None


def _values_itemsize(fmt) -> int:
    """What a quantized instance's spec prices: the scales' width, as the
    reference's ``spec`` does; else the stored values' width."""
    if fmt.values_dtype in QUANTIZED_DTYPES and fmt.scales is not None:
        return fmt.scales.element_size()
    return fmt.values.element_size()


@dataclasses.dataclass(frozen=True, eq=False)
class Condensed(SparseFormat):
    """Fig. 4 "condensed": values and int32 indices at constant fan-in k.

    ``values`` and ``indices`` are (*lead, d_out, k); ``d_in`` is the dense
    fan-in the indices address. A quantized export stores ``values`` as
    int8/fp8 codes with a per-neuron float32 ``scales`` (*lead, d_out); the
    kernel (K2) applies the scale once per output, after the k-sum. One
    layer of an MoE expert stack keeps the expert axis, values (E, d_out,
    k), and ``apply`` takes x (E, ..., d_in) through the expert-grouped
    launch (K1-moe / K2-moe).
    """

    values: torch.Tensor
    indices: torch.Tensor
    d_in: int = 0
    scales: torch.Tensor | None = None
    values_dtype: str | None = None      # canonical name when quantized

    format_name: typing.ClassVar[str] = "condensed"
    _array_fields: typing.ClassVar[tuple[str, ...]] = ("values", "indices", "scales")
    _static_fields: typing.ClassVar[tuple[str, ...]] = ("d_in", "values_dtype")

    def apply(self, x: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
        if self.values.ndim == 3:
            # an MoE layer's experts, values (E, n, k) against x (E, M, d):
            # one expert-grouped launch (K1-moe, K2-moe with the scales)
            return ops.condensed_linear_grouped(
                x, self.values if self.scales is not None else self.values.to(x.dtype),
                self.indices, scales=self.scales)
        if self.scales is not None:  # codes and scales go to K2 untouched
            return ops.condensed_linear_nd(x, self.values, self.indices, scales=self.scales)
        # the values' cast to the activation dtype is a no-op when the export
        # already stored them at the compute dtype (export_condensed does)
        return ops.condensed_linear_nd(x, self.values.to(x.dtype), self.indices)

    @classmethod
    def abstract(cls, lead, d_in, d_out, k, dtype):
        shape = (*lead, d_out, k)
        return cls(values=_meta(shape, dtype), indices=_meta(shape, torch.int32), d_in=d_in)

    @classmethod
    def export_from_dense(cls, w: torch.Tensor, mask: torch.Tensor,
                          stats: ExportStats | None = None, *,
                          dtype: torch.dtype | None = None,
                          quantize_spec=None) -> "Condensed":
        """Condense ``w * mask`` at the stack's realized fan-in.

        ``quantize_spec`` ("int8"/"fp8") quantizes the values from ``w``'s
        float32 rows; "bf16" stores them at bf16. Otherwise ``dtype`` stores
        the values at that dtype (the serving copy's compute dtype); None
        keeps the weight's dtype, as the reference does. A stack is
        condensed one slab of its first leading axis at a time (a layer, or
        an MoE layer's (E, d_in, d_out) experts), so the sort's temporaries
        stay at one slab's size (a whole-stack sort of a full-width MLP
        stack takes more memory than its weights), and the slabs stacked.
        """
        stats = stats if stats is not None else realized_stats(mask)
        k = max(stats.k, 1)
        qdt = resolve_quantize_spec(quantize_spec)
        stack = w.ndim > 2
        slabs = []
        for wl, ml in (zip(w, mask) if stack else [(w, mask)]):
            values, indices = topology.dense_to_condensed(wl * ml, ml, k)
            slabs.append((*_store_values(values, qdt, dtype), indices))

        def stacked(i):
            if slabs[0][i] is None:
                return None
            return torch.stack([slab[i] for slab in slabs]) if stack else slabs[0][i]
        values, scales, indices = map(stacked, range(3))
        return cls(values=values, indices=indices, d_in=int(w.shape[-2]), scales=scales,
                   values_dtype=qdt if scales is not None else None)

    def donate_refresh(self, w, mask, stats=None, *, donate=True):
        """Re-condense ``w * mask`` at the realized fan-in. With an
        unchanged ``k`` each layer is condensed straight into this leaf's
        tensors (``donate``) or into fresh ones of the same shapes; a moved
        ``k`` gives a fresh export at the leaf's storage dtype."""
        stats = stats if stats is not None else realized_stats(mask)
        k = max(stats.k, 1)
        lead, d_out = tuple(w.shape[:-2]), int(w.shape[-1])
        shapes = {"values": (*lead, d_out, k), "indices": (*lead, d_out, k)}
        if self.scales is not None:
            shapes["scales"] = (*lead, d_out)
        if not _same_layout(self.arrays(), shapes):
            return type(self).export_from_dense(
                w, mask, stats, dtype=None if self.scales is not None else self.values.dtype,
                quantize_spec=self.values_dtype)
        qdt = self.values_dtype if self.scales is not None else None

        def make(wl, ml):
            values, indices = topology.dense_to_condensed(wl * ml, ml, k)
            values, scales = _store_values(values, qdt, None)
            return {"values": values, "indices": indices,
                    **({"scales": scales} if scales is not None else {})}

        targets = _write_layers(_targets(self, tuple(shapes), donate), make, len(lead), w, mask)
        return dataclasses.replace(self, **targets)

    def refresh_values(self, w, mask, *, donate=True):
        """Regather ``w * mask`` at the stored indices (topology unchanged,
        no re-sort), one layer at a time into the values (and, quantized,
        fresh codes and scales), kept (``donate``) or fresh. Indices are
        reused as they are; padding slots regather +0."""
        return _revalue(self, w, mask, donate, self.indices)

    def spec(self):
        d_out, k = self.values.shape[-2:]
        return FormatSpec(d_in=self.d_in, d_out=d_out,
                          n_replicas=math.prod(self.values.shape[:-2]),
                          itemsize=_values_itemsize(self), k=k, max_active=d_out,
                          active_fraction=1.0, values_dtype=self.values_dtype)

    @classmethod
    def estimate_cost(cls, spec, batch, profile):
        b = max(int(batch), 1)
        gather_flops = 2.0 * b * spec.n_replicas * spec.d_out * spec.k
        return max(cls.estimate_weight_bytes(spec) / profile.hbm_bytes_per_s,
                   gather_flops / profile.gather_rate(b))

    @classmethod
    def estimate_weight_bytes(cls, spec):
        # values at their stored width (plus the scales when quantized) and
        # the int32 indices
        return cls.estimate_values_bytes(spec) + spec.n_replicas * spec.d_out * spec.k * 4

    @classmethod
    def estimate_values_bytes(cls, spec):
        vb = spec.n_replicas * spec.d_out * spec.k * values_itemsize(spec)
        if spec.values_dtype in QUANTIZED_DTYPES:
            vb += spec.n_replicas * spec.d_out * 4  # one float32 scale per neuron
        return vb

    def tuning_key(self, batch, *, backend=None, dtype=None):
        d_out, k = self.values.shape[-2:]
        return shape_tuning_key(self.d_in, d_out, k, batch,
                                backend=_leaf_backend(backend, self.values),
                                itemsize=self.values.element_size(),
                                values_dtype=self.values_dtype, compute_dtype=dtype)

    @classmethod
    def spec_tuning_key(cls, spec, batch, *, backend=None, dtype=None):
        return shape_tuning_key(spec.d_in, spec.d_out, spec.k, batch, backend=backend,
                                itemsize=spec.itemsize, values_dtype=spec.values_dtype,
                                compute_dtype=dtype)

    def restore_finalize(self):
        return _finalize_quantized_restore(self)


@dataclasses.dataclass(frozen=True, eq=False)
class CondensedOverActive(SparseFormat):
    """Fig. 4's combined point: drop ablated neurons, condense survivors.

    ``values``/``indices`` (*lead, a, k) cover the ``a <= d_out`` surviving
    rows; ``out_index`` (*lead, a) int32 is each row's dense output column,
    ``d_out`` marking a padding row. Exact for any mask. Quantized as
    ``Condensed`` is, with one scale per surviving row (*lead, a). One layer
    of an MoE expert stack keeps the expert axis, values (E, a, k), and
    ``apply`` takes x (E, ..., d_in) through the expert-grouped launch
    (K4-moe, K2-coa-moe with the scales).
    """

    values: torch.Tensor
    indices: torch.Tensor
    out_index: torch.Tensor
    d_in: int = 0
    d_out: int = 0
    scales: torch.Tensor | None = None
    values_dtype: str | None = None      # canonical name when quantized

    format_name: typing.ClassVar[str] = "condensed_over_active"
    _array_fields: typing.ClassVar[tuple[str, ...]] = ("values", "indices", "out_index",
                                                       "scales")
    _static_fields: typing.ClassVar[tuple[str, ...]] = ("d_in", "d_out", "values_dtype")

    def apply(self, x, w=None):
        # an MoE layer's experts, values (E, a, k) against x (E, M, d): one
        # expert-grouped launch (K4-moe, K2-coa-moe with the scales)
        run = (ops.condensed_over_active_linear_grouped if self.values.ndim == 3
               else ops.condensed_over_active_linear_nd)
        if self.scales is not None:  # codes and scales go to K2-coa untouched
            return run(x, self.values, self.indices, self.out_index, self.d_out,
                       scales=self.scales)
        return run(x, self.values.to(x.dtype), self.indices, self.out_index, self.d_out)

    @classmethod
    def abstract(cls, lead, d_in, d_out, k, dtype):
        # a = d_out, the bound before any ablation is realized; a concrete
        # export shrinks it to the largest active count
        shape = (*lead, d_out, k)
        return cls(values=_meta(shape, dtype), indices=_meta(shape, torch.int32),
                   out_index=_meta((*lead, d_out), torch.int32), d_in=d_in, d_out=d_out)

    @classmethod
    def export_from_dense(cls, w, mask, stats=None, *, dtype=None, quantize_spec=None):
        """``dtype`` and ``quantize_spec`` store the values as ``Condensed`` does."""
        stats = stats if stats is not None else realized_stats(mask)
        values, indices, out_index = _condense_active_stack(
            w, mask, max(stats.k, 1), max(stats.max_active, 1))
        qdt = resolve_quantize_spec(quantize_spec)
        values, scales = _store_values(values, qdt, dtype)
        return cls(values=values, indices=indices, out_index=out_index,
                   d_in=int(w.shape[-2]), d_out=int(w.shape[-1]), scales=scales,
                   values_dtype=qdt if scales is not None else None)

    def donate_refresh(self, w, mask, stats=None, *, donate=True):
        """Re-export as ``Condensed.donate_refresh`` does; the shapes also
        hold ``max_active`` rows, so a moved active count (or ``k``) gives a
        fresh export."""
        stats = stats if stats is not None else realized_stats(mask)
        k, a = max(stats.k, 1), max(stats.max_active, 1)
        lead = tuple(w.shape[:-2])
        shapes = {"values": (*lead, a, k), "indices": (*lead, a, k), "out_index": (*lead, a)}
        if self.scales is not None:
            shapes["scales"] = (*lead, a)
        if not _same_layout(self.arrays(), shapes):
            return type(self).export_from_dense(
                w, mask, stats, dtype=None if self.scales is not None else self.values.dtype,
                quantize_spec=self.values_dtype)
        qdt = self.values_dtype if self.scales is not None else None

        def make(wl, ml):
            values, indices, out_index = _condense_active_stack(wl, ml, k, a)
            values, scales = _store_values(values, qdt, None)
            return {"values": values, "indices": indices, "out_index": out_index,
                    **({"scales": scales} if scales is not None else {})}

        targets = _write_layers(_targets(self, tuple(shapes), donate), make, len(lead), w, mask)
        return dataclasses.replace(self, **targets)

    def refresh_values(self, w, mask, *, donate=True):
        """Regather at the stored indices and ``out_index``, as
        ``Condensed.refresh_values`` does. Padding rows come out +0, as a
        fresh export gives them (the reference regathers a clipped column
        there, which its scatter then drops)."""
        return _revalue(self, w, mask, donate, self.indices, self.out_index)

    def spec(self):
        a, k = self.values.shape[-2:]
        return FormatSpec(d_in=self.d_in, d_out=self.d_out,
                          n_replicas=math.prod(self.values.shape[:-2]),
                          itemsize=_values_itemsize(self), k=k, max_active=a,
                          active_fraction=a / max(self.d_out, 1),
                          values_dtype=self.values_dtype)

    @classmethod
    def estimate_cost(cls, spec, batch, profile):
        # priced at the exported row fraction (max_active rows per replica,
        # padding included): the kernel runs over all of them
        b = max(int(batch), 1)
        row_frac = min(max(spec.max_active / max(spec.d_out, 1), 0.0), 1.0)
        gather_flops = 2.0 * b * spec.n_replicas * spec.d_out * spec.k
        return max(cls.estimate_weight_bytes(spec) / profile.hbm_bytes_per_s,
                   row_frac * gather_flops / profile.gather_rate(b))

    @classmethod
    def estimate_weight_bytes(cls, spec):
        # max_active rows of k values at their stored width (plus a scale
        # per row when quantized), k int32 indices and an out_index each
        return (cls.estimate_values_bytes(spec)
                + spec.n_replicas * spec.max_active * (spec.k * 4 + 4))

    @classmethod
    def estimate_values_bytes(cls, spec):
        vb = spec.n_replicas * spec.max_active * spec.k * values_itemsize(spec)
        if spec.values_dtype in QUANTIZED_DTYPES:
            vb += spec.n_replicas * spec.max_active * 4
        return vb

    def tuning_key(self, batch, *, backend=None, dtype=None):
        a, k = self.values.shape[-2:]
        return shape_tuning_key(self.d_in, a, k, batch,
                                backend=_leaf_backend(backend, self.values),
                                itemsize=self.values.element_size(), kind="coa",
                                scatter_width=self.d_out, values_dtype=self.values_dtype,
                                compute_dtype=dtype)

    @classmethod
    def spec_tuning_key(cls, spec, batch, *, backend=None, dtype=None):
        # the kernel runs over the exported (max_active, k) arrays and stores
        # into the d_out-wide output: both are in its key
        return shape_tuning_key(spec.d_in, spec.max_active, spec.k, batch, backend=backend,
                                itemsize=spec.itemsize, kind="coa", scatter_width=spec.d_out,
                                values_dtype=spec.values_dtype, compute_dtype=dtype)

    def restore_finalize(self):
        return _finalize_quantized_restore(self)


CONDENSED_FAMILY = (Condensed, CondensedOverActive)

FORMATS: dict[str, type[SparseFormat]] = {
    cls.format_name: cls
    for cls in (MaskedDense, Condensed, StructuredFanIn, CondensedOverActive)
}
