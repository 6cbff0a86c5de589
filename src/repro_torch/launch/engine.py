"""Serving execution primitives (port of the non-paged core of
``repro/launch/engine.py``).

``generate`` and ``serve_once`` run one greedy prefill + decode pass over a
params tree and a serving tree (bool masks or ``formats`` leaves), under
``torch.inference_mode()``. The reference's donated cache becomes one
preallocated cache written in place. ``ServingModel`` is the thin
``nn.Module`` that owns the parameters under their reference paths, the
serving copy at the compute dtype and the serving tree, which may come from
a ``sparse.plan.Plan`` (planned at the request's batch bucket, as the
reference's engine keys its plans).

The paged continuous-batching scheduler (``ServingEngine``), speculation and
live sync come with later slices.
"""
from __future__ import annotations

import time

import torch
from torch import nn

from repro_torch import bridge
from repro_torch.models import model as M
from repro_torch.sparse import plan as PLAN


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _prefill(cfg, params, masks, batch, cache):
    return M.prefill_step(cfg, params, masks, batch, cache)


def _decode_loop(cfg, params, masks, cache, first_tok: torch.Tensor, gen_len: int):
    """Greedy decode of ``gen_len`` tokens: exactly ``gen_len`` decode steps.

    first_tok: (B, 1) int32 — argmax of the prefill logits. Returns
    ((B, gen_len) generated tokens with first_tok first, cache).
    """
    cur = first_tok
    toks = []
    for _ in range(gen_len):
        toks.append(cur[:, 0])
        logits, cache = M.decode_step(cfg, params, masks, {"tokens": cur}, cache)
        # first index of the maximum, as jnp.argmax
        cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    if not toks:
        return first_tok[:, :0], cache
    return torch.stack(toks, dim=1), cache


@torch.inference_mode()
def _timed_serve(cfg, params, masks, prompts: torch.Tensor, gen_len: int):
    """One timed prefill+decode pass.
    Returns (tokens (B, T+gen_len), prefill_s, decode_s, decode_tok_per_s)."""
    b, t = prompts.shape
    cache = M.init_cache(cfg, b, max_len=t + gen_len, device=prompts.device)

    t0 = time.perf_counter()
    logits, cache = _prefill(cfg, params, masks, {"tokens": prompts}, cache)
    _sync(logits)
    t_prefill = time.perf_counter() - t0

    first = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    t0 = time.perf_counter()
    toks, _ = _decode_loop(cfg, params, masks, cache, first, gen_len)
    _sync(toks)
    t_decode = time.perf_counter() - t0

    tok_s = b * gen_len / max(t_decode, 1e-9)
    return torch.cat([prompts, toks], dim=1), t_prefill, t_decode, tok_s


def serve_once(cfg, params, masks, prompts: torch.Tensor, gen_len: int,
               path_name: str, quiet: bool = False):
    """One timed prefill+decode pass. Returns (tokens, decode_tok_per_s)."""
    out, t_prefill, t_decode, tok_s = _timed_serve(cfg, params, masks, prompts, gen_len)
    if not quiet:
        b, t = prompts.shape
        print(f"[serve:{path_name}] prefill {b}x{t} in {t_prefill:.3f}s | "
              f"decode {b}x{gen_len} in {t_decode:.3f}s ({tok_s:.1f} tok/s)")
    return out, tok_s


def generate(cfg, params, masks, prompts: torch.Tensor, gen_len: int) -> torch.Tensor:
    """prompts: (B, T) int32. Greedy decode. Returns (B, T+gen_len)."""
    out, _ = serve_once(cfg, params, masks, prompts, gen_len, "generate", quiet=True)
    return out


class ServingModel(nn.Module):
    """Parameters under the reference's "/"-joined paths, plus one serving tree.

    ``serving`` is the masks slot of the model: the bool masks (masked
    path), an export's tree of ``formats`` leaves, or a ``sparse.plan.Plan``,
    whose serving tree is used (``self.plan`` keeps the plan, and
    ``self.values_dtype`` its values' storage: None for float values). The
    serving copy of the params (``models.model.serving_params``) is made
    once here, so no call casts weights.
    """

    def __init__(self, cfg, params: dict, serving: dict | PLAN.Plan):
        super().__init__()
        self.cfg = cfg
        self.weights = nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False)
             for k, v in bridge.flatten(params).items()})
        self.plan = serving if isinstance(serving, PLAN.Plan) else None
        self.serving = self.plan.serving_tree if self.plan else serving
        self.values_dtype = self.plan.values_dtype if self.plan else None
        self.compute = M.serving_params(cfg, params)

    def serve_once(self, prompts: torch.Tensor, gen_len: int, path_name: str,
                   quiet: bool = False):
        return serve_once(self.cfg, self.compute, self.serving, prompts, gen_len,
                          path_name, quiet=quiet)

    def generate(self, prompts: torch.Tensor, gen_len: int) -> torch.Tensor:
        return generate(self.cfg, self.compute, self.serving, prompts, gen_len)
