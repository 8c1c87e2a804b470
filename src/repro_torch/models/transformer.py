"""Model assembly for training and the two serving paths.

Port of the parts of ``repro/models/transformer.py`` that training, the
scan engine and continuous batching run: ``init_params`` (attention
blocks, GQA or MLA, with a dense or MoE MLP; rwkv6 blocks; hybrid blocks,
a sliding-window GQA attention beside a Mamba path; whisper's
encoder-decoder; the vision and audio frontends' projections), the
training forward and loss (with the MoE router's aux loss), the
embedding and LM head, the contiguous-cache ``prefill`` /
``decode_step`` / ``decode_scan``, and the paged decode and prefill
steps.  Parameters keep the reference's tree: every block leaf is stacked
along a leading ``num_layers`` axis under ``params["blocks"]`` (an
encoder's along ``encoder_layers`` under ``params["enc_blocks"]``).

Batches: ``{"tokens": (B, S)}``, plus ``"patches"`` (B, num_patches, D)
for the vision frontend (prepended to the text) and ``"frames"`` (B,
num_frames, D) for the audio frontend (the encoder's input): the
modality encoders are stubs, as in the reference.  Where the reference
runs ``lax.scan`` over the stacked blocks, the port loops over layers in
Python on per-layer views (``leaf[l]``, ``cache[l]``), which copy
nothing.

Which path takes which config, one gate each:
:func:`scan_supported` (init, the scan engine), :func:`train_supported`
(training), :func:`pipeline_supported` (the pipelined engine's stage
functions, :func:`pipeline_stage_fns`), :func:`staged_decode_supported`
(stage-split serving's :func:`prefill_embed` / :func:`prefill_blocks`,
:func:`decode_embed` / :func:`decode_blocks` and :func:`lm_logits`) and
:func:`paged_decode_supported` (continuous batching);
:func:`cuda_supported` adds the card's kernel limits to each path, asked
where a run on the card starts.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.population import tree_leaves, tree_map
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rwkv6_scan as _wkv
from repro_torch.kernels import selective_scan as _ssm
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Tree = Any


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def scan_supported(cfg: ModelConfig) -> Optional[str]:
    """None if the port can build this config and serve it through the
    scan engine (``prefill`` / ``decode_step``), else the reason: attention
    blocks, GQA (sliding windows included) or MLA, with a dense or MoE
    MLP; rwkv6 blocks; hybrid blocks (attention and a Mamba path on the
    same input, fused by a learned softmax gate); an encoder-decoder of
    GQA blocks with dense MLPs (whisper); a vision patch prefix."""
    if cfg.block_kind not in ("attn", "rwkv6", "hybrid"):
        return f"block_kind={cfg.block_kind!r} is not ported yet"
    if cfg.is_encdec and (cfg.block_kind != "attn" or cfg.mla or cfg.moe):
        return "an encoder-decoder's blocks are GQA attention with dense MLPs"
    if cfg.frontend == "vision" and cfg.block_kind == "rwkv6":
        return "an rwkv6 prefill does not take a patch prefix"
    return None


def train_supported(cfg: ModelConfig) -> Optional[str]:
    """None if the port can train this config, else the reason: what it
    can build (:func:`scan_supported`), attention, rwkv6 and hybrid blocks
    alike (rwkv6's WKV recurrence is differentiated by
    ``ops.rwkv6_scan``'s backward, the Mamba recurrence by
    ``ops.selective_scan``'s)."""
    return scan_supported(cfg)


def cuda_supported(cfg: ModelConfig, path: str,
                   seq_len: Optional[int] = None) -> Optional[str]:
    """None if the card's kernels take ``cfg`` on ``path`` (``"scan"``: the
    scan engine; ``"continuous"``: continuous batching; ``"train"``:
    training, at ``seq_len`` tokens a sequence when given), else the
    reason, naming the kernel's limit.  Pure: the
    limits are the kernel modules' own constants, and nothing is built.
    The CPU path has no such limit (the plain versions take any head dim),
    so only a run on the card asks."""
    ssm = (cfg.block_kind == "hybrid"
           and cfg.ssm_state not in _ssm.STATE_DIMS)
    ssm_reason = (f"ssm_state={cfg.ssm_state}: the selective-scan kernel "
                  f"takes state sizes {_ssm.STATE_DIMS}")
    if path == "train":
        # GQA and MLA attention (the encoder's and the cross-attention
        # too) train through plain attention, as the reference does;
        # rwkv6 through the WKV kernel forward and its backward kernel,
        # hybrid's Mamba path through the selective-scan kernels
        if ssm:
            return ssm_reason
        if (cfg.block_kind == "hybrid" and seq_len is not None
                and seq_len > _ssm.MAX_BACKWARD_T):
            return (f"seq_len={seq_len}: the selective-scan backward kernel "
                    f"takes at most {_ssm.MAX_BACKWARD_T} steps")
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
        elif attention_dims(cfg) not in _fa.HEAD_DIMS:
            return (f"(q/k, v) head dims {attention_dims(cfg)}: the "
                    f"flash-attention kernel takes {_fa.HEAD_DIMS}")
        elif ssm:
            return ssm_reason
        return None
    if path == "continuous":
        reason = paged_decode_supported(cfg)
        if reason is not None:
            return reason
        group = cfg.num_heads // cfg.num_kv_heads
        if group > _pa.MAX_GROUP:
            return (f"{group} query heads a kv head: the paged-attention "
                    f"kernel takes at most {_pa.MAX_GROUP}")
        if cfg.resolved_head_dim > _pa.MAX_HEAD_DIM:
            return (f"head_dim={cfg.resolved_head_dim}: the paged-attention "
                    f"kernel takes at most {_pa.MAX_HEAD_DIM}")
        if (paged_prefill_supported(cfg) is not None
                and attention_dims(cfg) not in _fa.HEAD_DIMS):
            # the whole-prompt admit prefills through the flash kernel
            return (f"(q/k, v) head dims {attention_dims(cfg)}: the "
                    f"whole-prompt admit's flash-attention kernel takes "
                    f"{_fa.HEAD_DIMS}")
        return None
    raise ValueError(f"unknown path {path!r}; expected 'scan', "
                     "'continuous' or 'train'")


def attention_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """The (q/k, v) head widths the prefill attention hands the flash
    kernel: MLA's ``(qk_nope_dim + qk_rope_dim, v_head_dim)``, else
    ``(head_dim, head_dim)``."""
    if cfg.mla:
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def _require(reason: Optional[str], what: str, cfg: ModelConfig) -> None:
    if reason is not None:
        raise NotImplementedError(f"{what} {cfg.name}: {reason}")


def _fill(dst: Tree, src: Tree) -> None:
    """Copy ``src``'s leaves into ``dst``'s (a leaf drawn in place is
    skipped)."""
    tree_map(lambda d, s: None if d.data_ptr() == s.data_ptr()
             else d.copy_(s), dst, src)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = "cuda", out: Optional[Tree] = None
                ) -> Tree:
    """Random parameters in the reference's layout, drawn on ``device``
    from a ``torch.Generator`` seeded with ``seed`` (the numbers differ
    from ``jax.random``; carry JAX weights across with
    ``train.interop.params_from_numpy`` to compare the two).

    ``out``, when given, is a tree of :func:`param_shapes`' shapes and
    dtypes on ``device`` (a member's views of a stacked population, for
    instance) that the draw fills in place, module by module; the numbers
    are the same either way.  MoE expert weights are drawn a layer at a
    time straight into their leaves."""
    _require(scan_supported(cfg), "init", cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if out is None:
        out = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype,
                                             device=dev), param_shapes(cfg))
    dtype = L.param_dtype(cfg)
    D, V, NL = cfg.d_model, cfg.vocab_size, cfg.num_layers
    out["embed"]["tok"].copy_(L.dense_init(gen, (V, D), dtype, scale=0.02))
    out["final_norm"]["scale"].fill_(1)
    if not cfg.tie_embeddings:
        out["lm_head"]["w"].copy_(L.dense_init(gen, (D, V), dtype))
    if cfg.pos_kind == "learned":
        out["embed"]["pos"].copy_(L.dense_init(
            gen, (cfg.max_position, D), dtype, scale=0.02))
    if cfg.frontend == "vision":
        out["embed"]["patch_proj"].copy_(L.dense_init(gen, (D, D), dtype))
    if cfg.frontend == "audio":
        out["embed"]["frame_proj"].copy_(L.dense_init(gen, (D, D), dtype))
        out["embed"]["enc_pos"].copy_(L.dense_init(
            gen, (cfg.num_frames, D), dtype, scale=0.02))
    lead = (NL,)
    blocks = out["blocks"]
    blocks["ln1"]["scale"].fill_(1)
    blocks["ln2"]["scale"].fill_(1)
    if cfg.is_encdec:
        enc, lead_e = out["enc_blocks"], (cfg.encoder_layers,)
        for norm in (enc["ln1"], enc["ln2"], out["enc_norm"], blocks["ln_x"]):
            norm["scale"].fill_(1)
        _fill(enc["attn"], L.gqa_init(gen, cfg, lead=lead_e))
        _fill(enc["mlp"], L.gelu_mlp_init(gen, D, cfg.d_ff, dtype,
                                          lead=lead_e))
        _fill(blocks["xattn"], L.xattn_init(gen, cfg, lead=lead))
    if cfg.block_kind == "rwkv6":
        _fill(blocks["rwkv"], SSM.rwkv6_init(gen, cfg, lead=lead))
        return out
    if cfg.block_kind == "hybrid":
        _fill(blocks["mamba"], SSM.mamba_init(gen, cfg, lead=lead))
        blocks["beta"].fill_(1)  # the learned attention / SSM fusion
    attn = (L.mla_init if cfg.mla else L.gqa_init)(gen, cfg, lead=lead)
    _fill(blocks["attn"], attn)
    del attn
    if cfg.moe:
        _fill(blocks["mlp"], MOE.moe_init(gen, cfg, lead=lead,
                                          experts=blocks["mlp"]["experts"]))
    else:
        _fill(blocks["mlp"], L.swiglu_init(gen, D, cfg.d_ff, dtype,
                                           lead=lead))
    return out


def param_shapes(cfg: ModelConfig) -> Tree:
    """The parameter tree as ``meta`` tensors: shapes and dtypes only, for
    restoring a checkpoint without drawing random weights first."""
    _require(scan_supported(cfg), "init", cfg)
    dtype = L.param_dtype(cfg)
    hd = cfg.resolved_head_dim
    D, V, NL, F = cfg.d_model, cfg.vocab_size, cfg.num_layers, cfg.d_ff
    H, KV = cfg.num_heads, cfg.num_kv_heads
    m = lambda *s: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731

    def gqa(n):
        attn = {"wq": m(n, D, H * hd), "wk": m(n, D, KV * hd),
                "wv": m(n, D, KV * hd), "wo": m(n, H * hd, D)}
        if cfg.qkv_bias:
            attn.update(bq=m(n, H * hd), bk=m(n, KV * hd), bv=m(n, KV * hd))
        if cfg.qk_norm:
            attn.update(q_norm={"scale": m(n, hd)},
                        k_norm={"scale": m(n, hd)})
        return attn

    params: Dict[str, Any] = {"embed": {"tok": m(V, D)},
                              "final_norm": {"scale": m(D)}}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": m(D, V)}
    if cfg.pos_kind == "learned":
        params["embed"]["pos"] = m(cfg.max_position, D)
    if cfg.frontend == "vision":
        params["embed"]["patch_proj"] = m(D, D)
    if cfg.frontend == "audio":
        params["embed"]["frame_proj"] = m(D, D)
        params["embed"]["enc_pos"] = m(cfg.num_frames, D)
    if cfg.block_kind == "rwkv6":
        params["blocks"] = {"ln1": {"scale": m(NL, D)},
                            "ln2": {"scale": m(NL, D)},
                            "rwkv": SSM.rwkv6_shapes(cfg, NL)}
        return params
    if cfg.mla:
        r, qd = cfg.kv_lora_rank, cfg.qk_nope_dim + cfg.qk_rope_dim
        attn = {"wq": m(NL, D, H * qd), "w_dkv": m(NL, D, r),
                "w_krope": m(NL, D, cfg.qk_rope_dim),
                "w_uk": m(NL, r, H * cfg.qk_nope_dim),
                "w_uv": m(NL, r, H * cfg.v_head_dim),
                "wo": m(NL, H * cfg.v_head_dim, D)}
    else:
        attn = gqa(NL)
    mlp = (MOE.moe_shapes(cfg, NL) if cfg.moe else
           {"w1": m(NL, D, F), "w3": m(NL, D, F), "w2": m(NL, F, D)})
    params["blocks"] = {"ln1": {"scale": m(NL, D)},
                        "ln2": {"scale": m(NL, D)},
                        "attn": attn, "mlp": mlp}
    if cfg.is_encdec:
        NE = cfg.encoder_layers
        params["blocks"]["xattn"] = {
            "wq": m(NL, D, H * hd), "wk": m(NL, D, KV * hd),
            "wv": m(NL, D, KV * hd), "wo": m(NL, H * hd, D)}
        params["blocks"]["ln_x"] = {"scale": m(NL, D)}
        params["enc_blocks"] = {
            "ln1": {"scale": m(NE, D)}, "ln2": {"scale": m(NE, D)},
            "attn": gqa(NE), "mlp": {"w1": m(NE, D, F), "b1": m(NE, F),
                                     "w2": m(NE, F, D), "b2": m(NE, D)}}
        params["enc_norm"] = {"scale": m(D)}
    if cfg.block_kind == "hybrid":
        params["blocks"]["mamba"] = SSM.mamba_shapes(cfg, NL)
        params["blocks"]["beta"] = torch.empty((NL, 2), dtype=torch.float32,
                                               device="meta")
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


def _embed_inputs(params, cfg: ModelConfig, batch):
    """The text's embeddings, behind the vision patches' projections when
    the config has that frontend: ``(x, the number of prefix positions)``."""
    x = _embed_tokens(params, cfg, batch["tokens"].long())
    if cfg.frontend != "vision":
        return x, 0
    patches = batch["patches"] @ params["embed"]["patch_proj"]
    return torch.cat([patches.to(x.dtype), x], dim=1), patches.shape[1]


def _encode(params, cfg: ModelConfig, frames, serve: bool = False):
    """Whisper's encoder over the stubbed frame embeddings ``frames`` (B,
    num_frames, D): the frame projection and learned positions, then
    pre-norm blocks of bidirectional GQA and the GELU MLP, and a final
    norm.  The attention runs ``gqa_train(bidirectional=True)`` in
    training and :func:`layers.gqa_encode` (the flash kernel on the card)
    when ``serve``.  The positions broadcast only over ``num_frames``
    frames; the reference pads none, nor does this."""
    if frames.shape[1] != cfg.num_frames:
        raise ValueError(f"{cfg.name}: {frames.shape[1]} frames, the encoder "
                         f"takes exactly num_frames={cfg.num_frames}")
    emb = params["embed"]
    x = frames @ emb["frame_proj"] + emb["enc_pos"][None]
    for blk in _layer_views(params["enc_blocks"], cfg.encoder_layers):
        h = L.rmsnorm(blk["ln1"], x, cfg.norm_eps)
        x = x + (L.gqa_encode(blk["attn"], cfg, h) if serve else
                 L.gqa_train(blk["attn"], cfg, h, bidirectional=True))
        x = x + L.gelu_mlp(blk["mlp"], L.rmsnorm(blk["ln2"], x, cfg.norm_eps))
    return L.rmsnorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# training forward / loss
# ---------------------------------------------------------------------------


def _mlp_apply(p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MLP: ``(y, router aux loss)``, the aux 0 for a dense
    SwiGLU."""
    if cfg.moe:
        return MOE.moe_apply(p, cfg, x)
    return L.swiglu(p, x), torch.zeros((), dtype=torch.float32,
                                       device=x.device)


def _fuse(p, a, m):
    """The hybrid block's learned gate: ``softmax(beta)`` in float32, cast
    to the attention output's dtype, weighing attention and Mamba."""
    beta = torch.softmax(p["beta"].float(), dim=-1).to(a.dtype)
    return beta[0] * a + beta[1] * m


def _block_train(p, cfg: ModelConfig, x, state_l=None, enc_out=None):
    """One block over the full sequence: ``(x, aux)``.  An rwkv6 block
    starts from ``state_l`` (a zero start) and its new state is dropped,
    as the reference's ``_run_blocks_train`` drops it; a hybrid block's
    Mamba path starts from zero and keeps no state; a decoder block of an
    encoder-decoder cross-attends to ``enc_out`` after its self-attention
    (the reference's ``_run_dec_blocks_train``)."""
    if cfg.block_kind == "rwkv6":
        x, _ = SSM.rwkv6_block(p["rwkv"], cfg, x, state_l,
                               {"ln1": p["ln1"], "ln2": p["ln2"]})
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    attend = L.mla_train if cfg.mla else L.gqa_train
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    a = attend(p["attn"], cfg, h)
    if cfg.block_kind == "hybrid":
        a = _fuse(p, a, SSM.mamba_train(p["mamba"], cfg, h))
    x = x + a
    if enc_out is not None:
        x = x + L.xattn(p["xattn"], cfg, L.rmsnorm(p["ln_x"], x, cfg.norm_eps),
                        enc_out)
    y, aux = _mlp_apply(p["mlp"], cfg, L.rmsnorm(p["ln2"], x, cfg.norm_eps))
    return x + y, aux


def _layer_views(blocks: Tree, num_layers: int) -> List[Tree]:
    """The per-layer trees of the stacked ``blocks``, each leaf unbound
    once: the gradient of an ``unbind`` is one stack of the layers'
    gradients, where indexing the stacked leaf once per layer would
    scatter each layer's gradient into a zero tensor of the whole leaf."""
    parts = tree_map(lambda t: t.unbind(0), blocks)
    return [tree_map(lambda u: u[l], parts, is_leaf=lambda u: isinstance(u, tuple))
            for l in range(num_layers)]


def _run_blocks_train(params, cfg: ModelConfig, x, enc_out=None):
    """All blocks in order, a Python loop over per-layer views; rwkv6
    blocks each from a zero start, as from the reference's
    ``rwkv_state_init``: zero token-shift inputs, and the WKV state as
    None (zero, with no final state asked for, so the WKV kernels neither
    read nor write one).  With ``cfg.remat_blocks`` each block's
    activations are recomputed in the backward pass
    (``torch.utils.checkpoint``) instead of stored, so an rwkv6 layer runs
    its WKV forward twice.  Returns ``(x, the router aux loss summed over
    the layers)``.  A hybrid layer's Mamba path also starts from zero,
    passing the selective-scan kernels no state.  A decoder block
    cross-attends to ``enc_out`` when given.  Raises for what
    :func:`train_supported` refuses."""
    _require(train_supported(cfg), "training", cfg)
    state_l = None
    if cfg.block_kind == "rwkv6":
        zero = x.new_zeros((x.shape[0], cfg.d_model))
        state_l = {"S": None, "x_tm": zero, "x_cm": zero}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in _layer_views(params["blocks"], cfg.num_layers):
        if cfg.remat_blocks:
            x, aux_l = checkpoint(_block_train, blk, cfg, x, state_l,
                                  enc_out, use_reentrant=False)
        else:
            x, aux_l = _block_train(blk, cfg, x, state_l, enc_out)
        aux = aux + aux_l
    return x, aux


def forward_logits(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor,
                                                               torch.Tensor]:
    """Full-sequence logits (B, S, V) over the text positions and the
    auxiliary loss (the MoE router's, summed over the layers; 0 without
    MoE).  An encoder-decoder encodes ``batch["frames"]`` first; a vision
    prefix is run through the blocks and sliced off before the head."""
    enc_out = (_encode(params, cfg, batch["frames"]) if cfg.is_encdec
               else None)
    x, n_prefix = _embed_inputs(params, cfg, batch)
    x, aux = _run_blocks_train(params, cfg, x, enc_out)
    return _logits(params, cfg, x[:, n_prefix:]), aux


def loss_fn(params, cfg: ModelConfig, batch) -> Tuple[torch.Tensor,
                                                        Dict[str, torch.Tensor]]:
    """Next-token cross entropy (+ ``router_aux_coef`` x the MoE router's
    aux loss), computed in float32."""
    logits, aux = forward_logits(params, cfg, batch)
    targets = batch["tokens"][:, 1:].long()
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(lp, -1, targets[..., None])[..., 0]
    loss = torch.mean(nll)
    return loss + cfg.router_aux_coef * aux, {"nll": loss, "aux": aux}


def pipeline_supported(cfg: ModelConfig) -> Optional[str]:
    """None if the pipelined training engine can stage-split this config,
    else the reason.  The stage boundary carries ONE activation tensor, so
    anything with extra cross-block state (SSM/hybrid recurrences, the
    encoder output of enc-dec, modality prefixes) or a cross-stage loss
    term (the MoE router aux, summed over *all* layers) is rejected loudly
    rather than trained wrong."""
    if cfg.block_kind != "attn":
        return f"block_kind={cfg.block_kind!r} carries state across blocks"
    if cfg.is_encdec:
        return "encoder-decoder needs the encoder output on every stage"
    if cfg.frontend is not None:
        return f"frontend={cfg.frontend!r} prefixes are not stage-split"
    if cfg.moe:
        return "MoE router aux loss is not accumulated across stages"
    return None


def pipeline_stage_fns(cfg: ModelConfig):
    """``(embed, blocks, head)`` for
    :func:`repro_torch.train.engine.train_population_pipelined` (its
    ``StageFns``).  ``blocks`` runs whatever layer slice of
    ``params["blocks"]`` it is handed (a stage's), so one function serves
    every stage; ``head`` is the LM head and the float32 next-token nll.
    ``head(blocks(embed(..)))`` equals :func:`loss_fn`'s nll for the
    supported (attention, non-MoE) families.  Raises for what
    :func:`pipeline_supported` refuses."""
    reason = pipeline_supported(cfg)
    if reason is not None:
        raise NotImplementedError(f"pipelined training: {reason}")

    def embed(params, batch):
        return _embed_tokens(params, cfg, batch["tokens"].long())

    def blocks(params, x):
        stage = params["blocks"]
        for blk in _layer_views(stage, tree_leaves(stage)[0].shape[0]):
            if cfg.remat_blocks:
                x, _ = checkpoint(_block_train, blk, cfg, x,
                                  use_reentrant=False)
            else:
                x, _ = _block_train(blk, cfg, x)
        return x

    def head(params, x, batch):
        logits = _logits(params, cfg, x)
        targets = batch["tokens"][:, 1:].long()
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        return torch.mean(-torch.gather(lp, -1, targets[..., None])[..., 0])

    return embed, blocks, head


# ---------------------------------------------------------------------------
# serving with the contiguous cache (the scan engine)
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               device: DeviceLike = "cuda") -> Tree:
    """Decode state of every layer, on ``device`` (the card unless the
    caller asks for the CPU).  ``capacity`` is the logical context;
    sliding-window configs keep only ``min(window, capacity)`` ring slots.
    rwkv6 keeps ``{"state": {"S", "x_tm", "x_cm"}}``, GQA attention
    ``{"kv": {"k", "v", "pos_ids"}}``, MLA its latent cache
    ``{"kv": {"ckv", "krope", "pos_ids"}}``, a hybrid model its windowed
    ring and its Mamba state ``{"kv": ..., "ssm": {"h", "conv"}}``, an
    encoder-decoder also the cross-attention's keys and values of the
    encoded frames, ``"xk"`` and ``"xv"`` (L, B, num_frames, KV, hd); each
    leaf led by the layer axis."""
    _require(scan_supported(cfg), "scan-engine serving of", cfg)
    if cfg.block_kind == "rwkv6":
        return {"state": SSM.rwkv_state_init(cfg, batch, cfg.num_layers,
                                             device=device)}
    cap = capacity if cfg.window is None else min(cfg.window, capacity)
    init = L.mla_cache_init if cfg.mla else L.gqa_cache_init
    cache = {"kv": init(cfg, batch, cap, cfg.num_layers, device=device)}
    if cfg.block_kind == "hybrid":
        cache["ssm"] = SSM.mamba_state_init(cfg, batch, cfg.num_layers,
                                            device=device)
    if cfg.is_encdec:
        shape = (cfg.num_layers, batch, cfg.num_frames, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        dev = resolve_device(device)
        for key in ("xk", "xv"):
            cache[key] = torch.zeros(shape, dtype=L.param_dtype(cfg),
                                     device=dev)
    return cache


def _cache_layer(cache: Tree, l: int) -> Tree:
    return tree_map(lambda x: x[l], cache)


def _store_layer(cache: Tree, l: int, new_l: Tree) -> None:
    """Write layer ``l``'s new state into the stacked cache (the ring
    stores already wrote through their views; rwkv6 and Mamba return new
    tensors)."""
    for key, value in new_l.items():
        if isinstance(value, dict):
            _store_layer(cache[key], l, value)
        elif value.data_ptr() != cache[key][l].data_ptr():
            cache[key][l].copy_(value)


def _block_serve(block_l, cfg: ModelConfig, x, cache_l, pos: Optional[int],
                 enc_out=None):
    """One layer of prefill (``pos`` None: the whole prompt from position
    0; the reference's ``prefill`` scan body) or of one-token decode at
    ``pos`` (the reference's ``_block_decode``).  An encoder-decoder's
    prefill takes the encoder output ``enc_out``, whose keys and values
    it writes into the layer's ``xk`` / ``xv`` views in place; its decode
    reads them.  Returns ``(x, new_cache_l)``."""
    if cfg.block_kind == "rwkv6":
        x, state = SSM.rwkv6_block(
            block_l["rwkv"], cfg, x, cache_l["state"],
            {"ln1": block_l["ln1"], "ln2": block_l["ln2"]})
        return x, {"state": state}
    x, new_l = _attn_serve(block_l, cfg, x, cache_l, pos)
    if cfg.is_encdec:
        xk, xv = cache_l["xk"], cache_l["xv"]
        if enc_out is not None:
            k, v = L.xattn_kv(block_l["xattn"], cfg, enc_out)
            xk.copy_(k)
            xv.copy_(v)
        h = L.rmsnorm(block_l["ln_x"], x, cfg.norm_eps)
        x = x + L.xattn_attend(block_l["xattn"], cfg, h, xk, xv)
    y, _ = _mlp_apply(block_l["mlp"], cfg, L.rmsnorm(block_l["ln2"], x,
                                                     cfg.norm_eps))
    return x + y, new_l


def _attn_serve(block_l, cfg: ModelConfig, x, cache_l, pos: Optional[int]):
    """The attention half of an attention block in :func:`_block_serve`
    (a hybrid block's attention and Mamba path on the same input, fused):
    ``(x + attention, this layer's new cache {"kv"} or {"kv", "ssm"})``."""
    h = L.rmsnorm(block_l["ln1"], x, cfg.norm_eps)
    if pos is None:
        prefill_fn = L.mla_prefill if cfg.mla else L.gqa_prefill
        a, kv = prefill_fn(block_l["attn"], cfg, h, cache_l["kv"])
    else:
        decode_fn = L.mla_decode if cfg.mla else L.gqa_decode
        a, kv = decode_fn(block_l["attn"], cfg, h, cache_l["kv"], pos)
    if cfg.block_kind != "hybrid":
        return x + a, {"kv": kv}
    mamba_fn = SSM.mamba_prefill if pos is None else SSM.mamba_decode
    m, ssm = mamba_fn(block_l["mamba"], cfg, h, cache_l["ssm"])
    return x + _fuse(block_l, a, m), {"kv": kv, "ssm": ssm}


def _serve_blocks(blocks, cfg: ModelConfig, x, cache, pos: Optional[int],
                  enc_out=None):
    """``cfg.num_layers`` layers of ``blocks`` in order (a whole model's
    or a stage's contiguous slice) through :func:`_block_serve`, each
    layer's new state written into ``cache``: prefill with ``pos`` None,
    one-token decode at ``pos`` otherwise.  Returns ``(x, cache)``."""
    for l in range(cfg.num_layers):
        x, new_l = _block_serve(tree_map(lambda t: t[l], blocks), cfg, x,
                                _cache_layer(cache, l), pos, enc_out)
        _store_layer(cache, l, new_l)
    return x, cache


def decode_step(params, cfg: ModelConfig, tokens, cache, pos: int):
    """ONE new token per row, ``tokens`` (B, 1), at absolute position
    ``pos`` (a Python int, shared by the batch) against ``cache``, which is
    written in place.  Returns ``(logits (B, 1, V), cache)``."""
    x = decode_embed(params, cfg, tokens, pos)
    x, cache = _serve_blocks(params["blocks"], cfg, x, cache, int(pos))
    return _logits(params, cfg, x), cache


# ---------------------------------------------------------------------------
# stage-split serving: the embedding, a stage's blocks, the head
# ---------------------------------------------------------------------------


def staged_decode_supported(cfg: ModelConfig) -> Optional[str]:
    """None if the stage-split serving path can serve this config, else
    the reason (the reference's reasons).  A stage holds a contiguous
    slice of ``params["blocks"]`` and of the layer-leading cache and
    hands ONE activation to the next, which only composes for the plain
    attention families (GQA or MLA, dense or MoE) whose whole decode
    state is the KV ring: recurrent state, the cross-attention cache and
    modality prefixes are refused rather than served wrong."""
    if cfg.block_kind != "attn":
        return f"block_kind={cfg.block_kind!r} state is not stage-split"
    if cfg.is_encdec:
        return "encoder-decoder cross-attention cache is not stage-split"
    if cfg.frontend is not None:
        return f"frontend={cfg.frontend!r} prefixes are not stage-split"
    return None


def decode_embed(params, cfg: ModelConfig, tokens, pos: int):
    """The embedding half of :func:`decode_step`: ``tokens`` (B, 1) at
    position ``pos`` -> (B, 1, D)."""
    return _embed_tokens(params, cfg, tokens.long(), pos0=int(pos))


def decode_blocks(blocks, cfg: ModelConfig, x, cache, pos: int):
    """One-token decode at ``pos`` through the ``cfg.num_layers`` layers
    of ``blocks`` and ``cache`` (a stage's slice, with a config patched to
    the stage's layer count): the per-layer function :func:`decode_step`
    runs, so the stages composed are the unstaged step bitwise.  Returns
    ``(x, cache)``; the cache is written in place."""
    return _serve_blocks(blocks, cfg, x, cache, int(pos))


def prefill_embed(params, cfg: ModelConfig, batch):
    """The prompt's embeddings (the families
    :func:`staged_decode_supported` takes have no prefix)."""
    return _embed_tokens(params, cfg, batch["tokens"].long())


def prefill_blocks(blocks, cfg: ModelConfig, x, cache):
    """Whole-prompt prefill through the ``cfg.num_layers`` layers of
    ``blocks`` into ``cache`` (a stage's slice), by :func:`prefill`'s own
    per-layer function.  Returns ``(x, cache)``."""
    return _serve_blocks(blocks, cfg, x, cache, None)


def lm_logits(params, cfg: ModelConfig, x):
    """The final norm and the LM head (the last stage's)."""
    return _logits(params, cfg, x)


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
    """Process the whole prompt ``batch["tokens"]`` (B, T) from position 0,
    behind the vision patches (their positions first) or after encoding
    the audio frames once, as the config says.  ``capacity`` defaults to
    T, as the reference's does.  Returns ``(last-position logits (B, 1,
    V), the filled cache)``; the cache lands on the tokens' device."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    cache = init_cache(cfg, B, capacity or T, device=tokens.device)
    enc_out = (_encode(params, cfg, batch["frames"], serve=True)
               if cfg.is_encdec else None)
    x, _ = _embed_inputs(params, cfg, batch)
    x, cache = _serve_blocks(params["blocks"], cfg, x, cache, None, enc_out)
    return _logits(params, cfg, x[:, -1:]), cache


# ---------------------------------------------------------------------------
# paged decode / prefill
# ---------------------------------------------------------------------------


def paged_decode_supported(cfg: ModelConfig) -> Optional[str]:
    """None if ``decode_step_paged`` can serve this config, else the reason
    (the reference's reasons): GQA decoder-only families, dense and MoE."""
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
        y, _ = _mlp_apply(blk["mlp"], cfg, L.rmsnorm(blk["ln2"], x,
                                                     cfg.norm_eps))
        x = x + y
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
        y, _ = _mlp_apply(blk["mlp"], cfg, L.rmsnorm(blk["ln2"], x,
                                                     cfg.norm_eps))
        x = x + y
    return _logits(params, cfg, x[:, -1:]), pools
