"""Decoder LM, dense, VLM, MoE, SSM, hybrid and audio families, and the
encoder-only ViT (port of ``repro/models/model.py``).

Parameters are a nested dict with the reference's paths and stacked layout:
``params["blocks"][name]`` holds all ``n_layers`` layers on axis 0, or, for
gemma3's local/global pattern (``cfg.local_global_ratio`` = r), the grouped
layout: ``g_local`` with lead (g, r), ``g_global`` with lead (g,) and
``g_rem`` with lead (rem,), where g = n_layers // (r + 1) and rem the layers
left over. Each group runs its r local layers at ``cfg.sliding_window``,
then its global layer at window 0; ``g_rem`` runs last, at the window. The
hybrid family (zamba2, r = ``cfg.hybrid_attn_every``) has g = n_layers // r
groups of r Mamba2 layers, ``m_groups`` with lead (g, r), each followed by
one *shared* attention + MLP block, ``shared_attn``, whose params have no
leading axis (one block applied g times; its KV cache has lead (g,), one
slab an application), then ``m_rem`` with lead (rem,). The
reference scans over the stacks with ``lax.scan``; here a Python loop
slices one layer at a time. Sparse linears receive their serving leaf (a
bool mask or a ``formats.SparseFormat``) from the ``masks`` tree, whose
paths mirror the params.

Ported so far: the dense family (GQA with optional qk-norm, RoPE, SwiGLU,
sliding windows and the grouped local/global layout, whose local layers
keep ring caches of the window's size) and the VLM family (M-RoPE over
three position streams, precomputed frontend embeddings added to the
token embeddings) and the MoE family (attention, then a top-k MoE of SwiGLU
experts, ``models/moe.py``; the blocks' expert stacks have leads (L, E),
the backbone sums the routers' load-balance losses and ``loss_fn`` adds
0.01 of it) and the SSM family (a Mamba2 / SSD mixer a layer,
``models/ssm.py``, its decode state (conv_x, conv_bc, h) kept per layer in
the cache and written in place) and the hybrid family (Mamba2 layers and
the shared block, above) and the audio family (musicgen: K codebooks whose
embeddings are summed, ``embed`` (K, Vp, d), and one head a codebook,
``lm_head`` (K, d, Vp); tokens (B, K, T), logits (B, K, Vp), the loss the
mean of the K codebooks' cross-entropies): ``init_params``,
``prefill_step``, ``decode_step`` and their pieces for serving, and
``backbone``, ``cross_entropy_chunked`` and ``loss_fn`` for training. The
ViT family (``causal=False``) is an encoder: no RoPE, attention without a
causal mask, the precomputed ``frontend_embeds`` (B, T, d) as its input,
``embed`` the (1, d) CLS stub the reference keeps unused, and a class head
``lm_head`` (d, n_classes) over the mean-pooled hidden states
(``class_logits``); it has no decode path, so ``prefill_step`` and
``decode_step`` refuse it, as the reference's do. ``remat="block"``
recomputes each block and each cross-entropy chunk in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` does.
``supports_paged``, ``init_paged_pool``, ``paged_prefill_step``,
``paged_decode_step`` and ``paged_verify_step`` (the speculative verify)
serve the continuous-batching engine from a shared page pool, for the
uniform full-attention ``blocks`` layout only, as in the reference, the
MoE family and its speculative verify included. A verify routes its B *
(gamma + 1) rows as the reference's does, as one group whose expert
capacity may drop (token, expert) assignments that the decode steps keep.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.sparse import formats as F

Params = dict
Masks = dict

# weights consumed at the compute dtype (by a matmul, or the SSM mixer's
# depthwise conv); ``serving_params`` stores them at that dtype once instead
# of casting them on every call
MATMUL_WEIGHTS = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo",
                            "w_gate", "w_up", "w_down",
                            "in_z", "in_x", "in_bc", "in_dt", "out_proj",
                            "conv_x", "conv_bc", "conv_b", "conv_bc_b"})
# the SSM decode state a layer keeps in the cache
SSM_STATE = ("conv_x", "conv_bc", "h")


def _dt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _pdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def check_supported(cfg) -> None:
    """Every family of the reference is ported; what is refused is a config
    no reference config has: a causal ViT, a non-causal decoder, or experts
    outside the MoE family."""
    if (cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio", "vit")
            or cfg.causal != (cfg.family != "vit") or cfg.is_moe != (cfg.family == "moe")):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with causal={cfg.causal} and "
            f"n_experts={cfg.n_experts} is not a configuration of the reference (only "
            f"the vit family is encoder-only, only the moe family has experts)")


def group_counts(cfg) -> tuple[int, int, int]:
    """(g, r, rem) of the grouped local/global layout: g groups of r local
    layers and one global layer, then rem local layers."""
    r = cfg.local_global_ratio
    g = cfg.n_layers // (r + 1)
    return g, r, cfg.n_layers - g * (r + 1)


def hybrid_counts(cfg) -> tuple[int, int, int]:
    """(g, r, rem) of the hybrid layout: g groups of r Mamba2 layers, each
    followed by the shared block, then rem Mamba2 layers."""
    r = cfg.hybrid_attn_every
    g = cfg.n_layers // r
    return g, r, cfg.n_layers - g * r


def block_stacks(cfg) -> list[tuple[str, tuple[int, ...]]]:
    """(params key, leading dims) of each block stack."""
    if cfg.family == "hybrid":
        g, r, rem = hybrid_counts(cfg)
        return ([("m_groups", (g, r))] + ([("m_rem", (rem,))] if rem else [])
                + [("shared_attn", ())])
    if not cfg.local_global_ratio:
        return [("blocks", (cfg.n_layers,))]
    g, r, rem = group_counts(cfg)
    return [("g_local", (g, r)), ("g_global", (g,))] + ([("g_rem", (rem,))] if rem else [])


def _block_entries(cfg) -> list[tuple[str, tuple[int, ...], tuple[int, ...], int]]:
    """Each block application's (stack key, params index, cache index,
    window) in execution order. The two indices differ only for the hybrid's
    shared block: its params have no leading axis (index ``()``), its i-th
    application keeps its own KV slab (cache index ``(i,)``). The shared
    block attends at window 0 (the reference's training scan passes
    ``cfg.sliding_window``, which no hybrid config sets)."""
    w = cfg.sliding_window
    if cfg.family == "hybrid":
        g, r, rem = hybrid_counts(cfg)
        out = []
        for i in range(g):
            out += [("m_groups", (i, j), (i, j), w) for j in range(r)]
            out.append(("shared_attn", (), (i,), 0))
        return out + [("m_rem", (i,), (i,), w) for i in range(rem)]
    if not cfg.local_global_ratio:
        return [("blocks", (i,), (i,), w) for i in range(cfg.n_layers)]
    g, r, rem = group_counts(cfg)
    out = []
    for i in range(g):
        out += [("g_local", (i, j), (i, j), w) for j in range(r)]
        out.append(("g_global", (i,), (i,), 0))
    return out + [("g_rem", (i,), (i,), w) for i in range(rem)]


def _block_order(cfg) -> list[tuple[str, tuple[int, ...], int]]:
    """Each block application's (stack key, params index, window) in
    execution order."""
    return [(key, idx, w) for key, idx, _, w in _block_entries(cfg)]


def _is_ssm_stack(cfg, key: str) -> bool:
    """Whether the blocks of stack ``key`` are Mamba2 (SSM) blocks."""
    return cfg.family == "ssm" or (cfg.family == "hybrid" and key != "shared_attn")


# ===========================================================================
# init
# ===========================================================================

def _init_attn_block(generator: torch.Generator, cfg, dtype, k_fan: dict,
                     with_mlp: bool = True, *, lead: tuple[int, ...] = ()) -> dict:
    """One block's params, or a stack of them with leading dims ``lead``."""
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    dev = L.init_device(generator)

    def maybe_sparse(a, b, name):
        fan = k_fan.get(name)
        if fan:
            return L.sparse_init(generator, a, b, fan, dtype, lead=lead)
        return L.dense_init(generator, a, b, dtype, lead=lead)

    def zeros(n):
        return torch.zeros((*lead, n), dtype=dtype, device=dev)

    p = {
        "ln1": zeros(d),
        "wq": maybe_sparse(d, qd, "wq"),
        "wk": maybe_sparse(d, kvd, "wk"),
        "wv": maybe_sparse(d, kvd, "wv"),
        "wo": maybe_sparse(qd, d, "wo"),
    }
    if cfg.qk_norm:
        p["q_norm"] = zeros(hd)
        p["k_norm"] = zeros(hd)
    if with_mlp:
        p["ln2"] = zeros(d)
        p["w_gate"] = maybe_sparse(d, cfg.d_ff, "w_gate")
        p["w_up"] = maybe_sparse(d, cfg.d_ff, "w_up")
        p["w_down"] = maybe_sparse(cfg.d_ff, d, "w_down")
    return p


def _init_moe_block(generator: torch.Generator, cfg, dtype, k_fan: dict, *,
                    lead: tuple[int, ...] = ()) -> dict:
    """An MoE block: attention without the MLP, ``ln2``, then the router and
    the experts' stacks (``moe.init_moe_params``)."""
    p = _init_attn_block(generator, cfg, dtype, k_fan, with_mlp=False, lead=lead)
    p["ln2"] = torch.zeros((*lead, cfg.d_model), dtype=dtype, device=L.init_device(generator))
    moe = MOE.init_moe_params(generator, cfg.d_model, cfg.d_ff, cfg.n_experts,
                              {k: v for k, v in k_fan.items() if v}, dtype, lead=lead)
    p.update(moe._asdict())
    return p


def _init_ssm_block(generator: torch.Generator, cfg, dtype, k_fan: dict, *,
                    lead: tuple[int, ...] = ()) -> dict:
    """An SSM block: the mixer's params (``ssm.init_ssm_params``) and its
    pre-norm scale ``ln``."""
    p = SSM.init_ssm_params(generator, cfg, dtype, k_fan, lead=lead)._asdict()
    p["ln"] = torch.zeros((*lead, cfg.d_model), dtype=dtype, device=L.init_device(generator))
    return p


_BLOCK_INIT = {"moe": _init_moe_block, "ssm": _init_ssm_block, "hybrid": _init_ssm_block}


def init_params(cfg, generator: torch.Generator, k_fan: dict | None = None) -> Params:
    """Initialize the parameter tree for ``cfg`` on ``generator``'s device.
    ``generator`` may be ``torch.device("meta")``: the same tree of meta
    tensors, allocating and drawing nothing (``layers.init_device``).

    ``k_fan`` maps sparse layer names to their constant fan-in k, so sparse
    layers get 1/sqrt(k)-scaled init (``registry.k_fan_map``).
    """
    check_supported(cfg)
    k_fan = k_fan or {}
    dtype = _pdt(cfg)
    d, vp = cfg.d_model, cfg.vocab_padded
    params: Params = {"final_norm": torch.zeros((d,), dtype=dtype, device=L.init_device(generator))}
    if cfg.family == "audio":  # one embedding table and one head a codebook
        params["embed"] = L.embed_init(generator, vp, d, dtype, lead=(cfg.n_codebooks,))
        params["lm_head"] = L.dense_init(generator, d, vp, dtype, lead=(cfg.n_codebooks,))
    elif cfg.family == "vit":  # the CLS stub (unused) and the class head
        params["embed"] = L.embed_init(generator, 1, d, dtype)
        params["lm_head"] = L.dense_init(generator, d, cfg.n_classes, dtype)
    else:
        params["embed"] = L.embed_init(generator, vp, d, dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(generator, d, vp, dtype)
    init = _BLOCK_INIT.get(cfg.family, _init_attn_block)
    for key, lead in block_stacks(cfg):
        # the hybrid's shared block is an attention + MLP block
        block_init = _init_attn_block if key == "shared_attn" else init
        params[key] = block_init(generator, cfg, dtype, k_fan, lead=lead)
    return params


def serving_params(cfg, params: Params) -> Params:
    """The serving copy: matmul weights cast to the compute dtype, once.

    Identical numbers to the reference's per-call ``w.astype(x.dtype)``
    (a cast commutes with masking and gathering); norm scales stay at the
    param dtype because ``rms_norm`` reads them in float32. Tensors already
    at the compute dtype are shared, not copied.
    """
    dt = _dt(cfg)

    def rec(tree):
        return {k: rec(v) if isinstance(v, dict)
                else (v.to(dt) if k in MATMUL_WEIGHTS else v)
                for k, v in tree.items()}
    return rec(params)


# ===========================================================================
# sublayer applies
# ===========================================================================

def _heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _unstack(tree: dict, n: int) -> list[dict]:
    """The ``n`` layers of a stacked params or serving tree, each tensor
    split once by ``unbind``. Its backward stacks the layers' gradients in
    one op, where indexing layer by layer would add a zero tensor the size
    of the whole stack into the gradient once per layer."""
    cols = {k: v.unstack() if isinstance(v, F.SparseFormat) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def _layer_trees(cfg, tree: dict) -> dict:
    """{(stack key, index): one layer's tree} of a params or serving tree
    (a stack the tree lacks gives empty trees). A (g, r) stack splits twice:
    into its g groups, each keeping the inner r dim, then into layers. A
    stack with no leading axis (the hybrid's shared block) is one layer,
    index ``()``, the tree itself: never split, so each application reads
    the same tensors and autograd sums their gradients."""
    out = {}
    for key, lead in block_stacks(cfg):
        if not lead:
            out[key, ()] = tree.get(key, {})
            continue
        for i, t in enumerate(_unstack(tree.get(key, {}), lead[0])):
            if len(lead) == 1:
                out[key, (i,)] = t
            else:
                out.update(((key, (i, j)), tj) for j, tj in enumerate(_unstack(t, lead[1])))
    return out


def attn_sublayer(cfg, p: dict, m: dict, x: torch.Tensor, *, positions, window: int,
                  q_offset: int = 0, cache: tuple | None = None, decode: bool = False,
                  paged: tuple | None = None):
    """Pre-norm attention sublayer (residual added by caller).

    cache: (k_cache, v_cache, cache_len) for decode / prefill-write; the
    write is in place. paged: (k_pool, v_pool, block_table, lengths), one
    layer's slice of a paged pool instead of a contiguous cache
    (``supports_paged`` configs only, window 0): prefill writes positions
    [0, T) through the table, decode one token per stream at its own
    length. Returns (out, (k_cache, v_cache) or None).
    """
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    q = _heads(L.linear(h, p["wq"], m.get("wq")), cfg.n_heads_padded, cfg.head_dim)
    k = _heads(L.linear(h, p["wk"], m.get("wk")), cfg.n_kv_heads_padded, cfg.head_dim)
    v = _heads(L.linear(h, p["wv"], m.get("wv")), cfg.n_kv_heads_padded, cfg.head_dim)

    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.mrope:
        q = L.apply_mrope(q, positions, cfg.rope_theta)
        k = L.apply_mrope(k, positions, cfg.rope_theta)
    elif cfg.causal:  # the encoder (ViT) takes no positions
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if paged is not None:
        k_pool, v_pool, block_table, lengths = paged
        if decode and k.shape[1] == 1:
            A.paged_cache_write(k_pool, v_pool, k, v, block_table, lengths[:, None])
            attn = A.paged_decode_attention(q, k_pool, v_pool, block_table, lengths + 1,
                                            head_to_kv=cfg.head_to_kv)
        elif decode:
            # speculative verify: all T slots are written before any
            # position attends them (the draft's K/V there is overwritten)
            t = k.shape[1]
            pos = lengths[:, None] + torch.arange(t, device=x.device, dtype=lengths.dtype)
            A.paged_cache_write(k_pool, v_pool, k, v, block_table, pos)
            attn = A.paged_verify_attention(q, k_pool, v_pool, block_table, lengths,
                                            head_to_kv=cfg.head_to_kv)
        else:
            # prefill: attention over the in-flight k/v (causal, so the pads
            # of a right-padded row sit after every real token and no real
            # token attends them); the pool write covers all T slots, the
            # pad slots holding garbage that ``lengths`` masks until decode
            # overwrites it
            attn = A.chunked_attention(
                q, k, v, head_to_kv=cfg.head_to_kv, causal=cfg.causal, window=window,
                q_offset=q_offset, q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
            t = k.shape[1]
            pos = torch.arange(t, device=x.device)[None].expand(k.shape[0], t)
            A.paged_cache_write(k_pool, v_pool, k, v, block_table, pos)
        new_cache = (k_pool, v_pool)
    elif decode:
        k_cache, v_cache, cache_len = cache
        k_cache, v_cache = A.cache_write(k_cache, v_cache, k, v, cache_len)
        attn = A.decode_attention(q, k_cache, v_cache, cache_len + 1,
                                  head_to_kv=cfg.head_to_kv, window=window)
        new_cache = (k_cache, v_cache)
    else:
        attn = A.chunked_attention(
            q, k, v, head_to_kv=cfg.head_to_kv, causal=cfg.causal, window=window,
            q_offset=q_offset, q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
        if cache is not None:  # prefill: fill the cache
            k_cache, v_cache, cache_len = cache
            new_cache = A.cache_write(k_cache, v_cache, k, v, cache_len)

    if cfg.n_heads_padded != cfg.n_heads:  # zero padded heads
        head_mask = torch.arange(cfg.n_heads_padded, device=x.device) < cfg.n_heads
        attn = attn * head_mask[None, None, :, None].to(attn.dtype)
    out = L.linear(attn.reshape(*x.shape[:-1], cfg.q_dim), p["wo"], m.get("wo"))
    return out, new_cache


def mlp_sublayer(cfg, p: dict, m: dict, x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    gate = L.linear(h, p["w_gate"], m.get("w_gate"))
    up = L.linear(h, p["w_up"], m.get("w_up"))
    return L.linear(L.swiglu(gate, up), p["w_down"], m.get("w_down"))


def moe_sublayer(cfg, p: dict, m: dict, x: torch.Tensor):
    """Pre-norm MoE sublayer: (y, aux_loss), residual added by the caller."""
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    moe_p = MOE.MoEParams(router=p["router"], w_gate=p["w_gate"], w_up=p["w_up"],
                          w_down=p["w_down"])
    return MOE.moe_block(cfg, moe_p, h, m, group_size=cfg.moe_group_size)


def attn_mlp_block(cfg, p, m, x, *, positions, window, q_offset=0, cache=None,
                   decode=False, paged=None):
    a, new_cache = attn_sublayer(cfg, p, m, x, positions=positions, window=window,
                                 q_offset=q_offset, cache=cache, decode=decode, paged=paged)
    x = x + a
    x = x + mlp_sublayer(cfg, p, m, x)
    return x, new_cache


def attn_moe_block(cfg, p, m, x, *, positions, window, q_offset=0, cache=None,
                   decode=False, paged=None):
    """The MoE family's block: (x, new_cache, aux_loss)."""
    a, new_cache = attn_sublayer(cfg, p, m, x, positions=positions, window=window,
                                 q_offset=q_offset, cache=cache, decode=decode, paged=paged)
    x = x + a
    y, aux = moe_sublayer(cfg, p, m, x)
    return x + y, new_cache, aux


def ssm_sublayer(cfg, p: dict, m: dict, x: torch.Tensor, *, state=None,
                 decode: bool = False):
    """Pre-norm SSM sublayer: (y, new_state), residual added by the caller."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    sp = SSM.SSMParams(**{f: p[f] for f in SSM.SSMParams._fields})
    return SSM.ssm_block(cfg, sp, h, m, state=state, chunk=cfg.ssd_chunk, decode=decode)


def ssm_res_block(cfg, p, m, x, *, state=None, decode=False):
    """The SSM family's block: (x + mixer(x), new_state)."""
    y, new_state = ssm_sublayer(cfg, p, m, x, state=state, decode=decode)
    return x + y, new_state


def _serve_block(cfg, p, m, x, **kw):
    """One block for serving, (x, new_cache): the MoE block's aux loss is
    dropped, as the reference's serving scans drop it."""
    if cfg.family == "moe":
        return attn_moe_block(cfg, p, m, x, **kw)[:2]
    return attn_mlp_block(cfg, p, m, x, **kw)


# ===========================================================================
# forward (training / scoring): final hidden states
# ===========================================================================

def _maybe_remat(cfg, fn):
    """``fn`` recomputed in the backward pass when ``cfg.remat == "block"``:
    only its inputs are kept, so its forward runs twice per step."""
    if cfg.remat != "block":
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


def _train_block(cfg, key, p, m, x, positions, window):
    """One block of stack ``key`` for training: (x, aux_loss), the aux None
    off the MoE family."""
    if _is_ssm_stack(cfg, key):
        return ssm_res_block(cfg, p, m, x)[0], None
    if cfg.family == "moe":
        x, _, aux = attn_moe_block(cfg, p, m, x, positions=positions, window=window)
        return x, aux
    return attn_mlp_block(cfg, p, m, x, positions=positions, window=window)[0], None


def backbone(cfg, params: Params, masks: Masks, x: torch.Tensor, *,
             positions) -> tuple[torch.Tensor, torch.Tensor]:
    """Run the block stack. x: (B, T, d). Returns (hidden, aux_loss).

    Sparse leaves of ``masks`` are bool masks (the straight-through masked
    matmul, whose weight gradient is dense) or serving formats (which
    differentiate through their values where those require grad).
    """
    check_supported(cfg)
    layers_p, layers_m = _layer_trees(cfg, params), _layer_trees(cfg, masks or {})
    block = _maybe_remat(cfg, _train_block)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for key, idx, window in _block_order(cfg):
        x, aux = block(cfg, key, layers_p[key, idx], layers_m[key, idx], x, positions, window)
        if aux is not None:  # the MoE family: the routers' load-balance losses
            aux_total = aux_total + aux
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, aux_total


# ===========================================================================
# embedding / head
# ===========================================================================

def embed_inputs(cfg, params: Params, batch: dict):
    """Token embedding, plus the precomputed ``frontend_embeds`` (B, T, d) a
    VLM batch may carry; audio tokens (B, K, T) embed as the sum of their K
    codebooks' embeddings, and a ViT batch's ``frontend_embeds`` are its
    input. Returns (x (B, T, d), positions): (B, T), or under M-RoPE the
    (3, B, T) ``mrope_positions``, by default three copies of
    ``arange(T)``."""
    if cfg.family == "audio":
        toks = batch["tokens"]
        x = params["embed"][0][toks[:, 0]]
        for k in range(1, cfg.n_codebooks):
            x = x + params["embed"][k][toks[:, k]]
        bsz, t = toks.shape[0], toks.shape[2]
    elif cfg.family == "vit":
        x = batch["frontend_embeds"]
        bsz, t = x.shape[0], x.shape[1]
    else:
        toks = batch["tokens"]
        x = params["embed"][toks]
        if "frontend_embeds" in batch:
            x = x + batch["frontend_embeds"].to(x.dtype)
        bsz, t = toks.shape
    x = x.to(_dt(cfg))
    dev = x.device
    if cfg.mrope:
        positions = batch.get("mrope_positions")
        if positions is None:
            p = torch.arange(t, device=dev)[None].expand(bsz, t)
            positions = torch.stack([p, p, p])
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(t, device=dev)[None].expand(bsz, t)
    return x, positions


def _ce_chunk(h_i, t_i, m_i, lm_head, n_valid: int):
    logits = torch.matmul(h_i, lm_head.to(h_i.dtype)).float()
    v_total = lm_head.shape[-1]
    if n_valid != v_total:  # padded vocab columns
        valid = torch.arange(v_total, device=logits.device) < n_valid
        logits = torch.where(valid, logits, torch.full((), -1e30, device=logits.device))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, t_i[..., None].long(), dim=-1)[..., 0]
    nll = (lse - gold) * m_i
    return nll.sum(), m_i.sum()


def cross_entropy_chunked(hidden: torch.Tensor, lm_head: torch.Tensor,
                          targets: torch.Tensor, chunk: int,
                          loss_mask: torch.Tensor | None = None,
                          valid_vocab: int = 0) -> torch.Tensor:
    """Mean token cross-entropy without materializing (B, T, V) logits.

    hidden: (B, T, d); lm_head: (d, V); targets: (B, T) int. T goes in
    chunks of ``chunk``; each chunk's (B, Tc, V) float32 logits are
    recomputed in the backward pass instead of kept.
    """
    b, t, _ = hidden.shape
    chunk = min(chunk, t)
    nc = -(-t // chunk)
    pad = nc * chunk - t
    lm = (loss_mask.float() if loss_mask is not None
          else torch.ones((b, t), dtype=torch.float32, device=hidden.device))
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        lm = torch.nn.functional.pad(lm, (0, pad))
    n_valid = valid_vocab if valid_vocab else lm_head.shape[-1]
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        n_i, c_i = checkpoint(_ce_chunk, hidden[:, sl], targets[:, sl], lm[:, sl], lm_head,
                              n_valid, use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + n_i, cnt + c_i
    return tot / torch.clamp(cnt, min=1.0)


def class_logits(cfg, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """The ViT's class logits (B, n_classes) float32: the final hidden
    states (B, T, d) mean-pooled over T, through the class head at their
    dtype."""
    pooled = hidden.mean(dim=1)
    return torch.matmul(pooled, params["lm_head"].to(pooled.dtype)).float()


def loss_fn(cfg, params: Params, masks: Masks, batch: dict):
    """Training loss: next-token cross-entropy of the (tied) head; for audio
    the mean over the codebooks of each head's cross-entropy on its own
    targets (B, K, T); for the ViT the cross-entropy of ``class_logits``
    on the batch's ``labels`` (B,).

    Returns (total, {"loss": ..., "aux_loss": ...}) with total = loss + 0.01
    * aux_loss; the aux loss (the MoE routers' load-balance losses summed
    over the blocks) is 0 off the MoE family, so there total == loss.
    """
    x, positions = embed_inputs(cfg, params, batch)
    hidden, aux = backbone(cfg, params, masks, x, positions=positions)
    if cfg.family == "vit":
        logits = class_logits(cfg, params, hidden)
        gold = torch.take_along_dim(logits, batch["labels"].long()[:, None], dim=-1)[:, 0]
        loss = torch.mean(torch.logsumexp(logits, dim=-1) - gold)
    elif cfg.family == "audio":
        loss = sum(cross_entropy_chunked(hidden, params["lm_head"][k], batch["targets"][:, k],
                                         cfg.ce_chunk, valid_vocab=cfg.vocab_size)
                   for k in range(cfg.n_codebooks)) / cfg.n_codebooks
    else:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        loss = cross_entropy_chunked(hidden, head, batch["targets"], cfg.ce_chunk,
                                     batch.get("loss_mask"), valid_vocab=cfg.vocab_size)
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux}


def _lm_logits(cfg, params: Params, last: torch.Tensor) -> torch.Tensor:
    """float32 logits of the (tied) head, (B, Vp), or for audio of each
    codebook's head, (B, K, Vp); padded vocab columns are -inf."""
    if cfg.family == "audio":
        logits = torch.stack([torch.matmul(last, params["lm_head"][k].to(last.dtype)).float()
                              for k in range(cfg.n_codebooks)], dim=1)
    else:
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        logits = torch.matmul(last, head.to(last.dtype)).float()
    if cfg.vocab_padded != cfg.vocab_size:
        valid = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab_size
        logits = torch.where(valid, logits, -torch.inf)
    return logits


# ===========================================================================
# serving: KV cache, prefill, single-token decode
# ===========================================================================

def _attn_cache(cfg, n: int, bsz: int, s: int, dtype, device):
    shape = (n, bsz, s, cfg.n_kv_heads_padded, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _ssm_cache(cfg, n: int, bsz: int, dtype, device):
    """n layers' SSM decode state: the conv inputs' last width - 1 steps at
    the compute dtype, h in float32."""
    w = cfg.ssm_conv_width - 1
    return {"conv_x": torch.zeros((n, bsz, w, cfg.d_inner), dtype=dtype, device=device),
            "conv_bc": torch.zeros((n, bsz, w, 2 * cfg.ssm_state), dtype=dtype, device=device),
            "h": torch.zeros((n, bsz, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=device)}


def init_cache(cfg, bsz: int, max_len: int, device) -> dict:
    """Decode state for ``bsz`` streams of up to ``max_len`` tokens.

    ``"len"`` (tokens already in the cache) is a 0-d int32 tensor on the
    device, as the reference's is: positions, the cache write and the
    decode mask are computed from it on the device, so no shape or slice
    of a decode step depends on a host int and a captured step replays at
    any length. ``prefill_step``/``decode_step`` advance it and write the
    k/v tensors in place.

    The grouped local/global layout keeps ring caches of min(window,
    max_len) slots for ``g_local`` (lead (g, r)) and ``g_rem``, and full
    caches for ``g_global``: a local layer's slot ``j`` holds the newest
    position t with t % window == j.

    The SSM family keeps no KV cache: ``blocks`` holds each layer's
    ``SSM_STATE`` (``_ssm_cache``), of a size independent of ``max_len``.
    The hybrid keeps the SSM state of ``m_groups`` with lead (g, r) and of
    ``m_rem`` with lead (rem,), and full KV caches for the shared block's g
    applications, ``shared_attn`` with lead (g,). The encoder (ViT) keeps
    only the length, as the reference's does: it has no decode path.
    """
    check_supported(cfg)
    dt = _dt(cfg)
    cache = {"len": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family == "vit":
        return cache
    if cfg.family == "ssm":
        cache["blocks"] = _ssm_cache(cfg, cfg.n_layers, bsz, dt, device)
        return cache
    if cfg.family == "hybrid":
        g, r, rem = hybrid_counts(cfg)
        cache["m_groups"] = {k: v.reshape(g, r, *v.shape[1:])
                             for k, v in _ssm_cache(cfg, g * r, bsz, dt, device).items()}
        if rem:
            cache["m_rem"] = _ssm_cache(cfg, rem, bsz, dt, device)
        cache["shared_attn"] = _attn_cache(cfg, g, bsz, max_len, dt, device)
        return cache
    if not cfg.local_global_ratio:
        s = min(cfg.sliding_window, max_len) if cfg.sliding_window else max_len
        cache["blocks"] = _attn_cache(cfg, cfg.n_layers, bsz, s, dt, device)
        return cache
    g, r, rem = group_counts(cfg)
    w = min(cfg.sliding_window, max_len)
    cache["g_local"] = {k: v.reshape(g, r, *v.shape[1:])
                        for k, v in _attn_cache(cfg, g * r, bsz, w, dt, device).items()}
    cache["g_global"] = _attn_cache(cfg, g, bsz, max_len, dt, device)
    if rem:
        cache["g_rem"] = _attn_cache(cfg, rem, bsz, w, dt, device)
    return cache


@torch.no_grad()
def reset_cache(cfg, cache: dict) -> None:
    """Make ``cache`` what ``init_cache`` gives, in place, for a new
    prefill: the length to 0 and the SSM state to zeros (a KV cache past
    the length is never read, so it is left as it is)."""
    cache["len"].zero_()
    for key, _ in block_stacks(cfg):
        if _is_ssm_stack(cfg, key):
            for f in SSM_STATE:
                cache[key][f].zero_()


def _run_blocks(cfg, params, masks, x, positions, cache, decode: bool):
    layers_p, layers_m = _layer_trees(cfg, params), _layer_trees(cfg, masks)
    for key, idx, cidx, window in _block_entries(cfg):
        c = cache[key]
        if _is_ssm_stack(cfg, key):
            # the layer's state read from the cache and the new one written
            # back in place (a captured decode step's static buffers)
            state = tuple(c[f][cidx] for f in SSM_STATE)
            x, new_state = ssm_res_block(cfg, layers_p[key, idx], layers_m[key, idx], x,
                                         state=state, decode=decode)
            for buf, v in zip(state, new_state):
                buf.copy_(v)
            continue
        x, _ = _serve_block(cfg, layers_p[key, idx], layers_m[key, idx], x,
                            positions=positions, window=window,
                            cache=(c["k"][cidx], c["v"][cidx], cache["len"]), decode=decode)
    return x


def _no_decode_path(cfg) -> None:
    if cfg.family == "vit":
        raise ValueError(f"{cfg.name}: the vit family is encoder-only, with no decode path "
                         "(its forward is backbone + class_logits)")


def prefill_step(cfg, params: Params, masks: Masks, batch: dict, cache: dict):
    """Process a full prompt, fill the cache in place, return last-token logits.

    batch["tokens"]: (B, T), audio (B, K, T). Returns (logits (B, V) float32,
    audio (B, K, V), cache). Refused for the encoder-only ViT.
    """
    _no_decode_path(cfg)
    masks = masks or {}
    x, positions = embed_inputs(cfg, params, batch)
    x = _run_blocks(cfg, params, masks, x, positions, cache, decode=False)
    cache["len"] += x.shape[1]
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(cfg, params, x[:, -1]), cache


def decode_step(cfg, params: Params, masks: Masks, batch: dict, cache: dict):
    """One-token decode. batch["tokens"]: (B, 1), audio (B, K, 1). Returns
    (logits (B, V), audio (B, K, V), cache); the cache, its length included,
    is advanced in place. Under M-RoPE all three position streams advance by
    the cache's length. Refused for the encoder-only ViT."""
    _no_decode_path(cfg)
    masks = masks or {}
    x, positions = embed_inputs(cfg, params, batch)
    positions = positions + cache["len"]
    x = _run_blocks(cfg, params, masks, x, positions, cache, decode=True)
    cache["len"] += 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(cfg, params, x[:, 0]), cache


# ===========================================================================
# paged serving (continuous batching): shared page pool + per-stream tables
# ===========================================================================

def supports_paged(cfg) -> bool:
    """Can this config decode against a paged KV pool? The uniform
    full-attention stacks can; windowed ring buffers, gemma's local/global
    groups, M-RoPE, audio codebooks and SSM state are served by the
    contiguous-cache path (the reference's predicate)."""
    return (cfg.family in ("dense", "vlm", "moe")
            and cfg.causal
            and not cfg.local_global_ratio
            and not cfg.sliding_window
            and not cfg.mrope)


def init_paged_pool(cfg, num_blocks: int, block_size: int, device) -> dict:
    """Layer-stacked page pool: {"pk"/"pv": (L, P, bs, Hkv, D)} of zeros.
    Page 0 is the reserved garbage page (``models/paged.py``): allocators
    never hand it out."""
    check_supported(cfg)
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: a paged pool serves the uniform full-attention "
                         "blocks layout only (no windows, local/global groups or M-RoPE)")
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads_padded, cfg.head_dim)
    return {"pk": torch.zeros(shape, dtype=_dt(cfg), device=device),
            "pv": torch.zeros(shape, dtype=_dt(cfg), device=device)}


def _paged_run_blocks(cfg, params, masks, x, pool, block_table, lengths, positions,
                      decode: bool):
    """The block stack over per-layer pool slices (views, written in place):
    the reference's ``_paged_attn_scan`` as a loop over the layers."""
    layers_p = _unstack(params["blocks"], cfg.n_layers)
    layers_m = _unstack(masks.get("blocks", {}), cfg.n_layers)
    for i in range(cfg.n_layers):
        x, _ = _serve_block(cfg, layers_p[i], layers_m[i], x, positions=positions,
                            window=0, decode=decode,
                            paged=(pool["pk"][i], pool["pv"][i], block_table, lengths))
    return x


def paged_prefill_step(cfg, params: Params, masks: Masks, batch: dict, pool: dict,
                       block_table: torch.Tensor, prompt_lens: torch.Tensor):
    """Prefill right-padded prompts into a paged KV pool (in place).

    batch["tokens"]: (B, T) right-padded to the prompt bucket; prompt_lens:
    (B,) real lengths (0 for idle rows, whose all-zero table rows point at
    the garbage page). Causal attention means real tokens never attend a
    pad, and each row's logits are read at its own last real token, so a
    row's results are those of an unpadded prefill. Returns (logits (B, V),
    pool).
    """
    masks = masks or {}
    x, positions = embed_inputs(cfg, params, batch)
    x = _paged_run_blocks(cfg, params, masks, x, pool, block_table, prompt_lens,
                          positions, decode=False)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    rows = torch.arange(x.shape[0], device=x.device)
    last = x[rows, torch.clamp(prompt_lens.long() - 1, min=0)]
    return _lm_logits(cfg, params, last), pool


def paged_decode_step(cfg, params: Params, masks: Masks, batch: dict, pool: dict,
                      block_table: torch.Tensor, lengths: torch.Tensor):
    """One-token decode against the paged pool, per-stream positions.

    batch["tokens"]: (B, 1); lengths: (B,) tokens already present per
    stream (the new token is written at slot ``lengths[b]`` and attends
    ``lengths[b] + 1`` slots: ``decode_step`` with the scalar length
    replaced by a vector). ``lengths`` is read, not advanced. Returns
    (logits, pool).
    """
    masks = masks or {}
    x, positions = embed_inputs(cfg, params, batch)
    positions = positions + lengths[:, None]
    x = _paged_run_blocks(cfg, params, masks, x, pool, block_table, lengths, positions,
                          decode=True)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(cfg, params, x[:, 0]), pool


def paged_verify_step(cfg, params: Params, masks: Masks, batch: dict, pool: dict,
                      block_table: torch.Tensor, lengths: torch.Tensor):
    """Multi-position decode against the paged pool (speculative verify).

    batch["tokens"]: (B, T): token ``i`` is written at slot ``lengths[b] + i``
    and attends ``lengths[b] + i + 1`` slots, the visibility of T sequential
    ``paged_decode_step`` calls, in one pass of the network over B * T rows.
    ``lengths`` is read, not advanced. Returns (logits (B, T, V), pool);
    ``argmax(logits[:, i])`` is the model's next token after consuming
    ``batch["tokens"][:, :i + 1]``.

    On the MoE family the B * T rows route as one group of min(group size,
    B * T) rows, idle bucket rows included, at that group's capacity
    (``moe.moe_block``), as the reference's verify does: where the T decode
    steps route groups of B rows that never drop, the verify may drop
    (token, expert) assignments, and its logits then part from theirs.
    """
    masks = masks or {}
    x, positions = embed_inputs(cfg, params, batch)
    positions = positions + lengths[:, None]
    x = _paged_run_blocks(cfg, params, masks, x, pool, block_table, lengths, positions,
                          decode=True)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _lm_logits(cfg, params, x), pool
