"""Model assembly for training and the two serving paths.

Port of the parts of ``repro/models/transformer.py`` that training, the
scan engine and continuous batching run: ``init_params`` (attention and
rwkv6 blocks), the training forward and loss, the embedding and LM head,
the contiguous-cache ``prefill`` / ``decode_step`` / ``decode_scan``, and
the paged decode and prefill steps.  Parameters keep the reference's tree:
every block leaf is stacked along a leading ``num_layers`` axis under
``params["blocks"]``.  Where the reference runs ``lax.scan`` over the
stacked blocks, the port loops over layers in Python on per-layer views
(``leaf[l]``, ``cache[l]``), which copy nothing.

Which path takes which config, one gate each:
:func:`scan_supported` (init, the scan engine), :func:`train_supported`
(training) and :func:`paged_decode_supported` (continuous batching);
:func:`cuda_supported` adds the card's kernel limits to each path, asked
where a run on the card starts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.population import tree_map
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rwkv6_scan as _wkv
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

Tree = Any


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def scan_supported(cfg: ModelConfig) -> Optional[str]:
    """None if the port can build this config and serve it through the
    scan engine (``prefill`` / ``decode_step``), else the reason: plain
    GQA attention blocks (sliding windows included) and rwkv6 blocks."""
    if cfg.block_kind not in ("attn", "rwkv6"):
        return f"block_kind={cfg.block_kind!r} is not ported yet"
    if cfg.moe:
        return "MoE layers are not ported to PyTorch yet"
    if cfg.mla:
        return "MLA attention is not ported to PyTorch yet"
    if cfg.is_encdec:
        return "encoder-decoder models are not ported to PyTorch yet"
    if cfg.frontend is not None:
        return f"frontend={cfg.frontend!r} inputs are not ported yet"
    return None


def train_supported(cfg: ModelConfig) -> Optional[str]:
    """None if the port can train this config, else the reason: what it
    can build (:func:`scan_supported`), attention and rwkv6 blocks alike
    (rwkv6's WKV recurrence is differentiated by ``ops.rwkv6_scan``'s
    backward)."""
    return scan_supported(cfg)


def cuda_supported(cfg: ModelConfig, path: str) -> Optional[str]:
    """None if the card's kernels take ``cfg`` on ``path`` (``"scan"``: the
    scan engine; ``"continuous"``: continuous batching; ``"train"``:
    training), else the reason, naming the kernel's limit.  Pure: the
    limits are the kernel modules' own constants, and nothing is built.
    The CPU path has no such limit (the plain versions take any head dim),
    so only a run on the card asks."""
    if path == "train":
        # attention trains through plain sdpa, as the reference does; rwkv6
        # through the WKV kernel forward and its backward kernel
        hd = cfg.rwkv_head_dim
        if cfg.block_kind == "rwkv6" and (
                hd not in _wkv.HEAD_DIMS or hd not in _wkv.BACKWARD_HEAD_DIMS):
            return (f"rwkv_head_dim={hd}: the WKV kernel takes head dims "
                    f"{_wkv.HEAD_DIMS}, its backward kernel "
                    f"{_wkv.BACKWARD_HEAD_DIMS}")
        return None
    if path == "scan":
        if cfg.block_kind == "rwkv6":
            if cfg.rwkv_head_dim not in _wkv.HEAD_DIMS:
                return (f"rwkv_head_dim={cfg.rwkv_head_dim}: the WKV kernel "
                        f"takes head dims {_wkv.HEAD_DIMS}")
        elif cfg.resolved_head_dim not in _fa.HEAD_DIMS:
            return (f"head_dim={cfg.resolved_head_dim}: the flash-attention "
                    f"kernel takes head dims {_fa.HEAD_DIMS}")
        return None
    if path == "continuous":
        group = cfg.num_heads // cfg.num_kv_heads
        if group > _pa.MAX_GROUP:
            return (f"{group} query heads a kv head: the paged-attention "
                    f"kernel takes at most {_pa.MAX_GROUP}")
        if cfg.resolved_head_dim > _pa.MAX_HEAD_DIM:
            return (f"head_dim={cfg.resolved_head_dim}: the paged-attention "
                    f"kernel takes at most {_pa.MAX_HEAD_DIM}")
        return None
    raise ValueError(f"unknown path {path!r}; expected 'scan', "
                     "'continuous' or 'train'")


def _require(reason: Optional[str], what: str, cfg: ModelConfig) -> None:
    if reason is not None:
        raise NotImplementedError(f"{what} {cfg.name}: {reason}")


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = "cuda") -> Tree:
    """Random parameters in the reference's layout, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed`` (the numbers differ
    from ``jax.random``; carry JAX weights across with
    ``train.interop.params_from_numpy`` to compare the two)."""
    _require(scan_supported(cfg), "init", cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = L.param_dtype(cfg)
    D, V, NL = cfg.d_model, cfg.vocab_size, cfg.num_layers
    ones = lambda *s: torch.ones(s, dtype=dtype, device=dev)  # noqa: E731
    params: Dict[str, Any] = {
        "embed": {"tok": L.dense_init(gen, (V, D), dtype, scale=0.02)},
        "final_norm": {"scale": ones(D)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L.dense_init(gen, (D, V), dtype)}
    if cfg.pos_kind == "learned":
        params["embed"]["pos"] = L.dense_init(
            gen, (cfg.max_position, D), dtype, scale=0.02)
    lead = (NL,)
    params["blocks"] = {
        "ln1": {"scale": ones(NL, D)},
        "ln2": {"scale": ones(NL, D)},
    }
    if cfg.block_kind == "rwkv6":
        params["blocks"]["rwkv"] = SSM.rwkv6_init(gen, cfg, lead=lead)
    else:
        params["blocks"]["attn"] = L.gqa_init(gen, cfg, lead=lead)
        params["blocks"]["mlp"] = L.swiglu_init(gen, D, cfg.d_ff, dtype,
                                                lead=lead)
    return params


def param_shapes(cfg: ModelConfig) -> Tree:
    """The parameter tree as ``meta`` tensors: shapes and dtypes only, for
    restoring a checkpoint without drawing random weights first."""
    _require(scan_supported(cfg), "init", cfg)
    dtype = L.param_dtype(cfg)
    hd = cfg.resolved_head_dim
    D, V, NL, F = cfg.d_model, cfg.vocab_size, cfg.num_layers, cfg.d_ff
    H, KV = cfg.num_heads, cfg.num_kv_heads
    m = lambda *s: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    params: Dict[str, Any] = {"embed": {"tok": m(V, D)},
                              "final_norm": {"scale": m(D)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": m(D, V)}
    if cfg.pos_kind == "learned":
        params["embed"]["pos"] = m(cfg.max_position, D)
    if cfg.block_kind == "rwkv6":
        params["blocks"] = {"ln1": {"scale": m(NL, D)},
                            "ln2": {"scale": m(NL, D)},
                            "rwkv": SSM.rwkv6_shapes(cfg, NL)}
        return params
    attn = {"wq": m(NL, D, H * hd), "wk": m(NL, D, KV * hd),
            "wv": m(NL, D, KV * hd), "wo": m(NL, H * hd, D)}
    if cfg.qkv_bias:
        attn.update(bq=m(NL, H * hd), bk=m(NL, KV * hd), bv=m(NL, KV * hd))
    if cfg.qk_norm:
        attn.update(q_norm={"scale": m(NL, hd)}, k_norm={"scale": m(NL, hd)})
    params["blocks"] = {
        "ln1": {"scale": m(NL, D)}, "ln2": {"scale": m(NL, D)},
        "attn": attn,
        "mlp": {"w1": m(NL, D, F), "w3": m(NL, D, F), "w2": m(NL, F, D)},
    }
    return params


# ---------------------------------------------------------------------------
# embeddings / logits
# ---------------------------------------------------------------------------


def _embed_tokens(params, cfg: ModelConfig, tokens, pos0: int = 0):
    x = params["embed"]["tok"][tokens]
    if cfg.pos_kind == "learned":
        T = tokens.shape[1]
        x = x + params["embed"]["pos"][pos0:pos0 + T][None]
    return x


def _logits(params, cfg: ModelConfig, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["tok"].T
    return x @ params["lm_head"]["w"]


# ---------------------------------------------------------------------------
# training forward / loss
# ---------------------------------------------------------------------------


def _block_train(p, cfg: ModelConfig, x, state_l=None):
    """One block over the full sequence; an rwkv6 block starts from
    ``state_l`` (a zero start) and its new state is dropped, as the
    reference's ``_run_blocks_train`` drops it."""
    if cfg.block_kind == "rwkv6":
        x, _ = SSM.rwkv6_block(p["rwkv"], cfg, x, state_l,
                               {"ln1": p["ln1"], "ln2": p["ln2"]})
        return x
    x = x + L.gqa_train(p["attn"], cfg, L.rmsnorm(p["ln1"], x, cfg.norm_eps))
    return x + L.swiglu(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps))


def _layer_views(blocks: Tree, num_layers: int) -> List[Tree]:
    """The per-layer trees of the stacked ``blocks``, each leaf unbound
    once: the gradient of an ``unbind`` is one stack of the layers'
    gradients, where indexing the stacked leaf once per layer would
    scatter each layer's gradient into a zero tensor of the whole leaf."""
    parts = tree_map(lambda t: t.unbind(0), blocks)
    return [tree_map(lambda u: u[l], parts, is_leaf=lambda u: isinstance(u, tuple))
            for l in range(num_layers)]


def _run_blocks_train(params, cfg: ModelConfig, x):
    """All blocks in order, a Python loop over per-layer views; rwkv6
    blocks each from a zero start, as from the reference's
    ``rwkv_state_init``: zero token-shift inputs, and the WKV state as
    None (zero, with no final state asked for, so the WKV kernels neither
    read nor write one).  With ``cfg.remat_blocks`` each block's
    activations are recomputed in the backward pass
    (``torch.utils.checkpoint``) instead of stored, so an rwkv6 layer runs
    its WKV forward twice.  Raises for what :func:`train_supported`
    refuses."""
    _require(train_supported(cfg), "training", cfg)
    state_l = None
    if cfg.block_kind == "rwkv6":
        zero = x.new_zeros((x.shape[0], cfg.d_model))
        state_l = {"S": None, "x_tm": zero, "x_cm": zero}
    for blk in _layer_views(params["blocks"], cfg.num_layers):
        if cfg.remat_blocks:
            x = checkpoint(_block_train, blk, cfg, x, state_l,
                           use_reentrant=False)
        else:
            x = _block_train(blk, cfg, x, state_l)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_logits(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor,
                                                               torch.Tensor]:
    """Full-sequence logits (B, S, V) and the auxiliary loss (0 for the
    dense attention and rwkv6 models the port trains)."""
    x = _embed_tokens(params, cfg, batch["tokens"].long())
    x, aux = _run_blocks_train(params, cfg, x)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor,
                                                        Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ the router aux loss, 0 here), computed
    in float32."""
    logits, aux = forward_logits(params, cfg, batch)
    targets = batch["tokens"][:, 1:].long()
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    loss = torch.mean(nll)
    return loss + cfg.router_aux_coef * aux, {"nll": loss, "aux": aux}


# ---------------------------------------------------------------------------
# serving with the contiguous cache (the scan engine)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device: DeviceLike = "cuda") -> Tree:
    """Decode state of every layer, on ``device`` (the card unless the
    caller asks for the CPU).  ``capacity`` is the logical context;
    sliding-window configs keep only ``min(window, capacity)`` ring slots.
    rwkv6 keeps ``{"state": {"S", "x_tm", "x_cm"}}``, attention
    ``{"kv": {"k", "v", "pos_ids"}}``, each leaf led by the layer axis."""
    _require(scan_supported(cfg), "scan-engine serving of", cfg)
    if cfg.block_kind == "rwkv6":
        return {"state": SSM.rwkv_state_init(cfg, batch, cfg.num_layers,
                                             device=device)}
    cap = capacity if cfg.window is None else min(cfg.window, capacity)
    return {"kv": L.gqa_cache_init(cfg, batch, cap, cfg.num_layers,
                                   device=device)}


def _cache_layer(cache: Tree, l: int) -> Tree:
    return tree_map(lambda x: x[l], cache)


def _store_layer(cache: Tree, l: int, new_l: Tree) -> None:
    """Write layer ``l``'s new state into the stacked cache (the ring
    stores already wrote through their views; rwkv6 returns new tensors)."""
    for key, value in new_l.items():
        if isinstance(value, dict):
            _store_layer(cache[key], l, value)
        elif value.data_ptr() != cache[key][l].data_ptr():
            cache[key][l].copy_(value)


def _block_serve(block_l, cfg: ModelConfig, x, cache_l, pos: Optional[int]):
    """One layer of prefill (``pos`` None: the whole prompt from position
    0; the reference's ``prefill`` scan body) or of one-token decode at
    ``pos`` (the reference's ``_block_decode``).  Returns
    ``(x, new_cache_l)``."""
    if cfg.block_kind == "rwkv6":
        x, state = SSM.rwkv6_block(
            block_l["rwkv"], cfg, x, cache_l["state"],
            {"ln1": block_l["ln1"], "ln2": block_l["ln2"]})
        return x, {"state": state}
    h = L.rmsnorm(block_l["ln1"], x, cfg.norm_eps)
    if pos is None:
        a, kv = L.gqa_prefill(block_l["attn"], cfg, h, cache_l["kv"])
    else:
        a, kv = L.gqa_decode(block_l["attn"], cfg, h, cache_l["kv"], pos)
    x = x + a
    x = x + L.swiglu(block_l["mlp"], L.rmsnorm(block_l["ln2"], x,
                                               cfg.norm_eps))
    return x, {"kv": kv}


def decode_step(params, cfg: ModelConfig, tokens, cache, pos: int):
    """ONE new token per row, ``tokens`` (B, 1), at absolute position
    ``pos`` (a Python int, shared by the batch) against ``cache``, which is
    written in place.  Returns ``(logits (B, 1, V), cache)``."""
    pos = int(pos)
    x = _embed_tokens(params, cfg, tokens.long(), pos0=pos)
    for l in range(cfg.num_layers):
        x, new_l = _block_serve(_block(params, l), cfg, x,
                                _cache_layer(cache, l), pos)
        _store_layer(cache, l, new_l)
    return _logits(params, cfg, x), cache


def decode_scan(params, cfg: ModelConfig, first, cache, start_pos: int,
                num_steps: int, next_fn, step_fn=None):
    """Multi-token decode: ``num_steps`` decode steps from absolute position
    ``start_pos``, the reference's ``lax.scan`` as a Python loop (eager, so
    every kernel launch is counted where it happens).

      first    : (B,) int — token ids fed to the first step
      next_fn  : (logits (B,1,V), step i) -> (B,) next token ids
      step_fn  : optional override of :func:`decode_step`, called as
                 ``step_fn(params, cache, tokens (B,1), pos)``; the
                 ensemble passes a member loop that averages logits

    Returns ``(tokens (B, num_steps), cache)``; ``tokens[:, i]`` is the id
    sampled after the step at position ``start_pos + i``."""
    if step_fn is None:
        def step_fn(p, c, t, pos):  # noqa: E306
            return decode_step(p, cfg, t, c, pos)
    nxt = first
    toks = []
    for i in range(num_steps):
        logits, cache = step_fn(params, cache, nxt[:, None], start_pos + i)
        nxt = next_fn(logits, i)
        toks.append(nxt)
    if not toks:
        return first.new_zeros((first.shape[0], 0)), cache
    return torch.stack(toks, dim=1), cache


def prefill(params, cfg: ModelConfig, batch, capacity: Optional[int] = None):
    """Process the whole prompt ``batch["tokens"]`` (B, T) from position 0.
    Returns ``(last-position logits (B, 1, V), the filled cache)``; the
    cache lands on the tokens' device."""
    tokens = batch["tokens"].long()
    B, T = tokens.shape
    cache = init_cache(cfg, B, capacity or T, device=tokens.device)
    x = _embed_tokens(params, cfg, tokens)
    for l in range(cfg.num_layers):
        x, new_l = _block_serve(_block(params, l), cfg, x,
                                _cache_layer(cache, l), None)
        _store_layer(cache, l, new_l)
    return _logits(params, cfg, x[:, -1:]), cache


# ---------------------------------------------------------------------------
# paged decode / prefill
# ---------------------------------------------------------------------------


def paged_decode_supported(cfg: ModelConfig) -> Optional[str]:
    """None if ``decode_step_paged`` can serve this config, else the reason.

    The reference's reasons, plus MoE, whose layers the port does not
    have yet."""
    if cfg.block_kind != "attn":
        return f"block_kind={cfg.block_kind!r} state is not paged"
    if cfg.mla:
        return "MLA latent cache has no paged layout yet"
    if cfg.is_encdec:
        return "encoder-decoder cross-attention cache is not paged"
    if cfg.frontend is not None:
        return f"frontend={cfg.frontend!r} prefixes are not paged"
    if cfg.window is not None:
        return "sliding-window ring eviction is not paged"
    if cfg.moe:
        return "MoE layers are not ported to PyTorch yet"
    return None


def paged_prefill_supported(cfg: ModelConfig) -> Optional[str]:
    """None if ``prefill_paged`` can serve this config, else the reason:
    everything :func:`paged_decode_supported` rejects, plus non-naive
    attention, whose prefill numerics differ from the paged attend."""
    reason = paged_decode_supported(cfg)
    if reason is not None:
        return reason
    if cfg.attn_impl != "naive":
        return (f"attn_impl={cfg.attn_impl!r} prefill numerics are not "
                "bitwise-compatible with the paged gather+sdpa attend")
    return None


def _layer_pool(pool, l: int):
    if isinstance(pool, dict):
        return {"q": pool["q"][l], "scale": pool["scale"][l]}
    return pool[l]


def _block(params, l: int):
    return tree_map(lambda x: x[l], params["blocks"])


def decode_step_paged(params, cfg: ModelConfig, tokens, positions, pools,
                      page_tables):
    """One decode token for a batch of serving slots over the paged pool.

      tokens      : (B,) int — one new token id per slot
      positions   : (B,) int32 — each token's absolute write position
      pools       : {"k","v"}: (L, P, page_size, KV, hd) tensors, or int8
                    ``{"q","scale"}`` dicts (``layers.paged_pools_init``);
                    written in place
      page_tables : (B, max_pages) int32 pool-page ids per slot

    Returns ``(logits (B,1,V), pools)``."""
    reason = paged_decode_supported(cfg)
    if reason is not None:
        raise NotImplementedError(f"paged decode: {reason}")
    pos = positions.to(torch.int32)
    x = params["embed"]["tok"][tokens.long()[:, None]]
    if cfg.pos_kind == "learned":
        x = x + params["embed"]["pos"][pos.long()][:, None]
    for l in range(cfg.num_layers):
        blk = _block(params, l)
        a_in = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        a, _, _ = L.gqa_decode_paged(
            blk["attn"], cfg, a_in, _layer_pool(pools["k"], l),
            _layer_pool(pools["v"], l), page_tables, pos)
        x = x + a
        x = x + L.swiglu(blk["mlp"], L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
    return _logits(params, cfg, x), pools


def prefill_paged(params, cfg: ModelConfig, tokens, pos0, pools, page_table):
    """Chunk/suffix prefill for ONE serving slot over the paged pool.

      tokens     : (T,) int — a contiguous slice of the prompt
      pos0       : int — absolute position of ``tokens[0]``
      pools      : as in :func:`decode_step_paged`; written in place
      page_table : (max_pages,) int32 — the slot's pages in prompt order

    Returns ``(logits (1,1,V) for the chunk's last position, pools)``."""
    reason = paged_prefill_supported(cfg)
    if reason is not None:
        raise NotImplementedError(f"paged prefill: {reason}")
    pos0 = int(pos0)
    T = tokens.shape[0]
    positions = pos0 + torch.arange(T, dtype=torch.int32, device=tokens.device)
    x = _embed_tokens(params, cfg, tokens.long()[None], pos0=pos0)
    for l in range(cfg.num_layers):
        blk = _block(params, l)
        a_in = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        a, _, _ = L.gqa_prefill_paged(
            blk["attn"], cfg, a_in, _layer_pool(pools["k"], l),
            _layer_pool(pools["v"], l), page_table, positions)
        x = x + a
        x = x + L.swiglu(blk["mlp"], L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
    return _logits(params, cfg, x[:, -1:]), pools
