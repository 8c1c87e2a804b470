"""Model assembly for training and the paged-KV serving path.

Port of the parts of ``repro/models/transformer.py`` that training and
continuous batching run: ``init_params`` (attention blocks), the training
forward and loss, the embedding and LM head, and the paged decode and
prefill steps.  Parameters keep the reference's tree: every block leaf is
stacked along a leading ``num_layers`` axis under ``params["blocks"]``.
Where the reference runs ``lax.scan`` over the stacked blocks, the port
loops over layers in Python on per-layer views (``leaf[l]``, ``pool[l]``),
which copy nothing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.population import tree_map
from repro_torch.models import layers as L

Tree = Any


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _check_ported(cfg: ModelConfig) -> None:
    reason = paged_decode_supported(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason}")


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = "cuda") -> Tree:
    """Random parameters in the reference's layout, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed`` (the numbers differ
    from ``jax.random``; carry JAX weights across with
    ``train.interop.params_from_numpy`` to compare the two)."""
    _check_ported(cfg)
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
        "attn": L.gqa_init(gen, cfg, lead=lead),
        "mlp": L.swiglu_init(gen, D, cfg.d_ff, dtype, lead=lead),
    }
    return params


def param_shapes(cfg: ModelConfig) -> Tree:
    """The parameter tree as ``meta`` tensors: shapes and dtypes only, for
    restoring a checkpoint without drawing random weights first."""
    _check_ported(cfg)
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


def _block_train(p, cfg: ModelConfig, x):
    """One attention block over the full sequence."""
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
    """All blocks in order, a Python loop over per-layer views; with
    ``cfg.remat_blocks`` each block's activations are recomputed in the
    backward pass (``torch.utils.checkpoint``) instead of stored."""
    for blk in _layer_views(params["blocks"], cfg.num_layers):
        if cfg.remat_blocks:
            x = checkpoint(_block_train, blk, cfg, x, use_reentrant=False)
        else:
            x = _block_train(blk, cfg, x)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward_logits(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor,
                                                               torch.Tensor]:
    """Full-sequence logits (B, S, V) and the auxiliary loss (0 for the
    dense attention models the port has)."""
    _check_ported(cfg)
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
