"""Mamba2 / SSD (state-space duality) mixer: chunked prefill and training,
single-token decode (port of ``repro/models/ssm.py``).

The SSD "chunked" algorithm (Dao & Gu 2024, arXiv:2405.21060): within a
chunk an attention-like quadratic term, across chunks a recurrent state
carried by a loop over the chunks (the reference's ``lax.scan``), all in
float32. The input projection is split into z / x / BC / dt matmuls as in
the reference; z, x and the output projection are the block's sparse
linears and go through ``layers.linear``, so a serving leaf of the
condensed family runs the condensed gather kernel (K1, K2 on codes).

Decode keeps (conv_x state, conv_bc state, h) per layer:

  h <- exp(dt * A) h + dt * B x^T ;  y = C . h + D x

Everything here is plain PyTorch, as it is plain JAX in the reference: no
Pallas kernel is reached.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from repro_torch.models import layers as L


class SSMParams(NamedTuple):
    in_z: torch.Tensor        # (d_model, d_inner)
    in_x: torch.Tensor        # (d_model, d_inner)
    in_bc: torch.Tensor       # (d_model, 2 * ssm_state)
    in_dt: torch.Tensor       # (d_model, H)
    conv_x: torch.Tensor      # (conv_width, d_inner), depthwise
    conv_bc: torch.Tensor     # (conv_width, 2 * ssm_state)
    conv_b: torch.Tensor      # (d_inner,)
    conv_bc_b: torch.Tensor   # (2 * ssm_state,)
    a_log: torch.Tensor       # (H,) float32
    d_skip: torch.Tensor      # (H,) float32
    dt_bias: torch.Tensor     # (H,) float32
    norm_scale: torch.Tensor  # (d_inner,)
    out_proj: torch.Tensor    # (d_inner, d_model)


def init_ssm_params(generator: torch.Generator, cfg, dtype=torch.float32,
                    k_fan_in: dict | None = None, *,
                    lead: tuple[int, ...] = ()) -> SSMParams:
    """One mixer's params on ``generator``'s device, or a stack of them with
    leading dims ``lead``. Sparse linears get std 1/sqrt(their fan-in from
    ``k_fan_in``, else the dense fan-in); ``a_log``, ``d_skip`` and
    ``dt_bias`` are float32 at any ``dtype``, as in the reference.

    The reference looks ``out_proj``'s fan-in up under ``"ssm_out"``, a key
    ``registry.k_fan_map`` never writes (it keys the stack ``"out_proj"``),
    so ``out_proj`` is drawn at the dense fan-in; the port keeps that."""
    h, di, n2 = cfg.ssm_n_heads, cfg.d_inner, 2 * cfg.ssm_state
    kf = k_fan_in or {}
    dev = L.init_device(generator)

    def sp(a: int, b: int, name: str) -> torch.Tensor:
        return L.sparse_init(generator, a, b, kf.get(name, a), dtype, lead=lead)

    def conv(c: int) -> torch.Tensor:
        w = L.normal(generator, (*lead, cfg.ssm_conv_width, c))
        return (w * 0.1).to(dtype)

    def per_head(v: torch.Tensor) -> torch.Tensor:
        return v.to(dev).expand(*lead, h).clone()

    return SSMParams(
        in_z=sp(cfg.d_model, di, "in_z"),
        in_x=sp(cfg.d_model, di, "in_x"),
        in_bc=L.dense_init(generator, cfg.d_model, n2, dtype, lead=lead),
        in_dt=L.dense_init(generator, cfg.d_model, h, dtype, lead=lead),
        conv_x=conv(di),
        conv_bc=conv(n2),
        conv_b=torch.zeros((*lead, di), dtype=dtype, device=dev),
        conv_bc_b=torch.zeros((*lead, n2), dtype=dtype, device=dev),
        a_log=per_head(torch.log(torch.arange(1, h + 1, dtype=torch.float32))),
        d_skip=per_head(torch.ones((h,), dtype=torch.float32)),
        dt_bias=per_head(torch.log(torch.expm1(torch.full((h,), 0.01, dtype=torch.float32)))),
        norm_scale=torch.zeros((*lead, di), dtype=dtype, device=dev),
        out_proj=sp(di, cfg.d_model, "ssm_out"),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv over time. x (B, T, C), w (width, C).

    Returns (silu(conv(x) + b), new_state), the state being the trailing
    width - 1 inputs (the decode continuation); ``state`` (B, width - 1, C)
    stands in for the zeros before the first input."""
    w = w.to(x.dtype)
    width, t = w.shape[0], x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, T + width - 1, C)
    y = sum(xp[:, i: i + t] * w[i] for i in range(width))
    y = Fn.silu(y + b.to(x.dtype))
    new_state = xp[:, t:] if width > 1 else pad
    return y, new_state


def ssd_chunked(x, dt, a, b, c, *, chunk: int = 256, h0: torch.Tensor | None = None):
    """Chunked SSD scan.

    x (B, T, H, P) inputs per head; dt (B, T, H) positive step sizes
    (softplus applied); a (H,) negative decay rates (A = -exp(a_log)); b, c
    (B, T, N) input and output projections (one group, shared by the
    heads); h0 (B, H, P, N) the state to continue from. T is padded up to a
    multiple of the chunk (zeros, which leave the state as it is). Returns
    y (B, T, H, P) at x's dtype and the last state h (B, H, P, N) float32.
    """
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, t)
    nc = -(-t // chunk)
    pad = nc * chunk - t
    if pad:
        x = Fn.pad(x, (0, 0, 0, 0, 0, pad))
        dt = Fn.pad(dt, (0, 0, 0, pad))
        b = Fn.pad(b, (0, 0, 0, pad))
        c = Fn.pad(c, (0, 0, 0, pad))

    f32 = torch.float32
    xc = x.reshape(bsz, nc, chunk, h, p).transpose(0, 1).float()
    dtc = dt.reshape(bsz, nc, chunk, h).transpose(0, 1).float()
    bc = b.reshape(bsz, nc, chunk, n).transpose(0, 1).float()
    cc = c.reshape(bsz, nc, chunk, n).transpose(0, 1).float()
    cum = torch.cumsum(dtc * a.float()[None, None, None, :], dim=2)     # (nc, B, Q, H)

    h_prev = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device) if h0 is None
              else h0.float())
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]
    ys = []
    for x_k, dt_k, b_k, c_k, cum_k in zip(xc, dtc, bc, cc, cum):
        # intra-chunk: y_i = sum_{j<=i} (c_i.b_j) exp(cum_i - cum_j) dt_j x_j
        seg = cum_k[:, :, None, :] - cum_k[:, None, :, :]                # (B, Q, Q, H)
        l_mat = torch.where(causal, torch.exp(seg), 0.0)
        cb = torch.einsum("bin,bjn->bij", c_k, b_k)
        w_ij = cb[..., None] * l_mat * dt_k[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", w_ij, x_k)
        # inter-chunk: y_i += exp(cum_i) c_i . h_prev
        y_inter = torch.einsum("bin,bhpn,bih->bihp", c_k, h_prev, torch.exp(cum_k))
        # state: h = exp(cum_last) h_prev + sum_j exp(cum_last - cum_j) dt_j b_j x_j^T
        total = cum_k[:, -1, :]
        decay_j = torch.exp(total[:, None, :] - cum_k) * dt_k
        h_prev = torch.exp(total)[:, :, None, None] * h_prev + torch.einsum(
            "bjh,bjn,bjhp->bhpn", decay_j, b_k, x_k)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys).transpose(0, 1).reshape(bsz, nc * chunk, h, p)[:, :t]
    return y.to(x.dtype), h_prev


def ssd_decode_step(x, dt, a, b, c, h_prev):
    """Single-token SSD update. x (B, 1, H, P); dt (B, 1, H); b, c (B, 1, N);
    h_prev (B, H, P, N) float32. Returns (y (B, 1, H, P) at x's dtype, h)."""
    dt0 = dt[:, 0].float()
    da = torch.exp(dt0 * a.float()[None, :])                          # (B, H)
    upd = torch.einsum("bh,bn,bhp->bhpn", dt0, b[:, 0].float(), x[:, 0].float())
    h_new = da[:, :, None, None] * h_prev + upd
    y = torch.einsum("bn,bhpn->bhp", c[:, 0].float(), h_new)
    return y[:, None].to(x.dtype), h_new


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``jax.nn.softplus`` computes it (logaddexp with 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssm_block(cfg, params: SSMParams, x_in: torch.Tensor, masks: dict | None = None,
              state: tuple | None = None, chunk: int = 256, decode: bool = False):
    """The Mamba2 mixer. x_in (B, T, d_model), normed by the caller.

    state: (conv_x state (B, w - 1, d_inner), conv_bc state (B, w - 1, 2N),
    h (B, H, P, N) float32), or None for zeros. Returns (y (B, T, d_model),
    new_state); the caller writes the new state where it keeps it."""
    m = masks or {}
    z = L.linear(x_in, params.in_z, m.get("in_z"))
    x = L.linear(x_in, params.in_x, m.get("in_x"))
    bc = L.linear(x_in, params.in_bc)
    dt = L.linear(x_in, params.in_dt)

    sx, sbc, h0 = state if state is not None else (None, None, None)
    x, new_sx = _causal_conv(x, params.conv_x, params.conv_b, sx)
    bc, new_sbc = _causal_conv(bc, params.conv_bc, params.conv_bc_b, sbc)
    n = cfg.ssm_state
    b, c = bc[..., :n], bc[..., n:]

    xh = x.reshape(*x.shape[:-1], cfg.ssm_n_heads, cfg.ssm_head_dim)
    dtv = softplus(dt.float() + params.dt_bias)
    a = -torch.exp(params.a_log)

    if decode:
        y, h_last = ssd_decode_step(xh, dtv, a, b, c, h0)
    else:
        y, h_last = ssd_chunked(xh, dtv, a, b, c, chunk=chunk, h0=h0)
    y = y + params.d_skip.float()[None, None, :, None] * xh.float()
    y = y.reshape(*x.shape[:-1], cfg.d_inner).to(x.dtype)

    y = L.rms_norm(y * Fn.silu(z), params.norm_scale)
    out = L.linear(y, params.out_proj, m.get("out_proj"))
    return out, (new_sx, new_sbc, h_last)
