"""Sparse-aware optimizers (port of ``repro/optim/optimizers.py``).

Each optimizer is (init_fn, update_fn):

  state = init(params)
  new_params, new_state = update(params, grads, state, lr, masks=None)

When a ``masks`` tree is given (paths mirroring params; missing paths are
dense), the gradient applied to the weight is masked while the incoming
``grads`` stay dense (the trainer reuses them for the grow criterion), and
the moments are masked too, so pruned slots carry no stale momentum: a
regrown weight restarts from zero weight and zero momentum.

Every float operation is the reference's float32 operation in its order.
``sgd_momentum`` and ``adamw`` update the params and moments IN PLACE (the
reference's jitted step donates its state) and return them in new trees:
at 1.7 B parameters a second copy of params and moments would not fit
beside the gradients. ``adafactor`` is functional.
"""
from __future__ import annotations

import torch


def _tree_get(masks: dict | None, path: tuple):
    if masks is None:
        return None
    node = masks
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def _map_with_path(fn, params, *rest):
    """Map over the leaves of nested dicts, passing each leaf's path."""
    def rec(path, p, *r):
        if isinstance(p, dict):
            return {k: rec(path + (k,), p[k], *[x[k] for x in r]) for k in p}
        return fn(path, p, *r)
    return rec((), params, *rest)


def _pick(tree, i: int):
    return {k: _pick(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _masked(g: torch.Tensor, mask) -> torch.Tensor:
    return g * mask.to(g.dtype) if mask is not None else g


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python constant as a float32 scalar tensor on ``like``'s device: the
    reference converts its weakly typed constants to float32 first."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _set_param(p: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        p.copy_(new.to(p.dtype))
    return p


# ---------------------------------------------------------------------------
# SGD + momentum (the paper's CNN recipe)
# ---------------------------------------------------------------------------

def sgd_momentum(momentum: float = 0.9, weight_decay: float = 0.0):
    def init(params):
        return {"mu": _map_with_path(lambda _, p: torch.zeros_like(p), params)}

    @torch.no_grad()
    def update(params, grads, state, lr, masks=None, step=None):
        def upd(path, p, g, mu):
            m = _tree_get(masks, path)
            g = _masked(g.float(), m)
            if weight_decay:
                g = g + _f32(weight_decay, g) * _masked(p.float(), m)
            mu.mul_(_f32(momentum, mu)).add_(g)
            if m is not None:
                mu.mul_(m.to(mu.dtype))
            return _set_param(p, p.float() - _f32(lr, p) * mu), mu

        out = _map_with_path(upd, params, grads, state["mu"])
        return _pick(out, 0), {"mu": _pick(out, 1)}

    return init, update


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.01):
    def init(params):
        def zeros(_, p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"mu": _map_with_path(zeros, params), "nu": _map_with_path(zeros, params),
                "count": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(params, grads, state, lr, masks=None, step=None):
        c = state["count"] + 1
        cf = c.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32), cf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32), cf)

        def upd(path, p, g, mu, nu):
            m = _tree_get(masks, path)
            g = _masked(g.float(), m)
            mu.mul_(_f32(b1, mu)).add_(_f32(1 - b1, g) * g)
            nu.mul_(_f32(b2, nu)).add_(_f32(1 - b2, g) * g * g)
            if m is not None:
                mf = m.to(torch.float32)
                mu.mul_(mf)
                nu.mul_(mf)
            dev = p.device
            u = (mu / bc1.to(dev)) / (torch.sqrt(nu / bc2.to(dev)) + _f32(eps, p))
            if weight_decay:
                u = u + _f32(weight_decay, p) * _masked(p.float(), m)
            return _set_param(p, p.float() - _f32(lr, p) * u), mu, nu

        out = _map_with_path(upd, params, grads, state["mu"], state["nu"])
        return _pick(out, 0), {"mu": _pick(out, 1), "nu": _pick(out, 2), "count": c}

    return init, update


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; for the 100B-1T configs)
# ---------------------------------------------------------------------------

def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0):
    """Momentum-less Adafactor (Shazeer & Stern 2018) with a factored second
    moment for tensors of rank >= 2 (over the last two axes). Functional:
    returns new tensors."""

    def _factored(p):
        return p.ndim >= 2

    def init(params):
        def st(_, p):
            z = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"v": _map_with_path(st, params), "count": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(params, grads, state, lr, masks=None, step=None):
        c = state["count"] + 1
        rho = 1.0 - c.float() ** torch.tensor(-decay, dtype=torch.float32)

        def upd(path, p, g, v):
            m = _tree_get(masks, path)
            r = rho.to(p.device)
            g = _masked(g.float(), m)
            g2 = g * g + _f32(eps, g)
            if _factored(p):
                vr = r * v["vr"] + (1 - r) * g2.mean(dim=-1)
                vc = r * v["vc"] + (1 - r) * g2.mean(dim=-2)
                denom = torch.sqrt(
                    vr[..., None] * vc[..., None, :]
                    / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None], min=eps))
                u = g / torch.clamp(denom, min=eps)
                new_v = {"vr": vr, "vc": vc}
            else:
                vv = r * v["v"] + (1 - r) * g2
                u = g / torch.sqrt(torch.clamp(vv, min=eps))
                new_v = {"v": vv}
            rms = torch.sqrt((u * u).mean() + _f32(1e-30, u))     # update clipping (RMS)
            u = u / torch.clamp(rms / _f32(clip_threshold, u), min=1.0)
            if weight_decay:
                u = u + _f32(weight_decay, u) * _masked(p.float(), m)
            if m is not None:
                u = _masked(u, m)
            return (p.float() - _f32(lr, p) * u).to(p.dtype), new_v

        def rec(path, p, g, v):
            if isinstance(p, dict):
                outs = {k: rec(path + (k,), p[k], g[k], v[k]) for k in p}
                return ({k: o[0] for k, o in outs.items()}, {k: o[1] for k, o in outs.items()})
            return upd(path, p, g, v)

        new_params, new_v = rec((), params, grads, state["v"])
        return new_params, {"v": new_v, "count": c}

    return init, update


def make_optimizer(name: str, **kw):
    if name == "sgdm":
        return sgd_momentum(**kw)
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(name)
