"""Step functions and stand-in arguments for every (architecture x input
shape) of the dry run (``repro.launch.steps``).

:func:`make_step_and_specs` returns ``(step_fn, args, donate_argnums)``:
the port's real step (its ``train_step`` or ``forward``) and arguments
that hold no memory, each a DTensor over fake local shards laid out by
the rule tables of ``launch/sharding.py``.  Call it inside the dry run's
``launch.op_cost.OpCounter`` (a ``FakeTensorMode``) and on a mesh of
``launch/mesh.py``; running the step there allocates nothing.

Modality carve-out (the reference's): [vlm]/[audio] front ends are stubs:
prefill/train inputs are precomputed patch/frame embeddings of the right
shape, the transformer backbone is real.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.config import (InputShape, ModelConfig, OptimizerConfig,
                                     ShardingConfig)
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.sharding import (NamedSharding, abstract_params,
                                         activation_sharding,
                                         attn_head_sharding, batch_sharding,
                                         cache_shardings, canonical_spec,
                                         moe_shardings, param_shardings,
                                         sharded_empty)
from repro_torch.models import cache as cache_lib
from repro_torch.models.transformer import build_cross_cache, encode, forward
from repro_torch.models.weights import count_params, param_shapes
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.train import train_step

VOCAB_PAD = 2048        # 16 model shards x 128 lanes
LONG_CONTEXT_WINDOW = 4096   # sliding-window variant for dense long_500k


def adapt_config(cfg: ModelConfig, shape: InputShape,
                 opts: frozenset = frozenset()) -> ModelConfig:
    """Shape-dependent config adaptation (the reference's DESIGN.md §4):
    dense/moe/vlm archs get a sliding-window attention variant for
    long_500k.  ``opts`` selects the reference's §Perf variants
    ("head_pad", "kv_pad")."""
    if (shape.name == "long_500k" and cfg.attention_window is None
            and cfg.family in ("dense", "moe", "vlm")):
        cfg = dataclasses.replace(cfg, attention_window=LONG_CONTEXT_WINDOW)
    if "head_pad" in opts and cfg.family != "ssm":
        h = cfg.num_heads
        if h % 16:
            cfg = dataclasses.replace(cfg, q_head_pad=-(-h // 16) * 16)
    if "kv_pad" in opts and cfg.family != "ssm":
        kv = cfg.num_kv_heads
        h = cfg.q_head_pad or cfg.num_heads
        if kv < 16 and 16 % kv == 0 and h % 16 == 0:
            cfg = dataclasses.replace(cfg, kv_head_pad=16)
    return cfg


def supported(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family == "audio":
        return False, ("enc-dec translation decoder: 524k-token decode is "
                       "out of distribution and the 500k encoder side is "
                       "excluded by the frontend-stub carve-out "
                       "(DESIGN.md §4)")
    return True, ""


def _enc_len(shape: InputShape, seq_len: Optional[int] = None) -> int:
    # audio: encoder frames = seq/4 (typical 4x conv downsampling)
    return max((seq_len or shape.seq_len) // 4, 8)


def _microbatches(mesh, rules: ShardingConfig, shape: InputShape,
                  opts: frozenset) -> int:
    """Gradient accumulation: about 2 sequences a device a microbatch,
    at most 8 (the §Perf knob ``mbN`` sets N)."""
    sizes = axis_sizes(mesh)
    n_batch_shards = 1
    for a in rules.batch:
        n_batch_shards *= sizes[a]
    per_device = shape.global_batch // n_batch_shards
    mb = max(1, min(8, per_device // 2))
    for o in opts:
        if o.startswith("mb"):
            mb = max(1, min(int(o[2:]), per_device))
    return mb


def make_step_and_specs(cfg: ModelConfig, shape: InputShape, mesh,
                        rules: ShardingConfig, *,
                        param_dtype=torch.bfloat16,
                        opt_cfg: Optional[OptimizerConfig] = None,
                        opts: frozenset = frozenset(), device="cpu",
                        batch: Optional[int] = None,
                        seq_len: Optional[int] = None
                        ) -> Tuple[Callable, tuple, tuple]:
    """Returns (step_fn, stand-in args, donate_argnums) of ``cfg`` at
    ``shape`` on ``mesh``.  ``batch`` / ``seq_len`` override the shape's
    (the one-card check runs the production steps at small sizes).
    Train: the params and fp32 AdamW moments, tokens, labels (and an
    audio model's encoder frames); the step is ``train_step`` with remat,
    the microbatches of :func:`_microbatches` and the sharding hooks.
    Prefill: a dense ring of ``seq_len + 16`` slots (the lookahead), the
    prompt (a vlm's patch embeddings; an audio model's frames, encoded
    and projected to the cross cache first).  Decode: a ring of
    ``seq_len`` slots and one token a row; ``--opt verify`` makes it the
    paper's verification step, T = SL_max + 1 = 11 tokens a row."""
    cfg = adapt_config(cfg, shape, opts)
    b = shape.global_batch if batch is None else batch
    s = shape.seq_len if seq_len is None else seq_len
    shapes = param_shapes(cfg, VOCAB_PAD)
    pshard = param_shardings(shapes, mesh, rules)
    params = abstract_params(shapes, param_dtype, pshard, device)
    bsh = batch_sharding(mesh, rules, 2)
    i32 = torch.int32

    if shape.kind == "train":
        opt_cfg = opt_cfg or OptimizerConfig()
        opt = AdamWState(
            step=torch.zeros((), dtype=i32, device=device),
            mu=abstract_params(shapes, torch.float32, pshard, device),
            nu=abstract_params(shapes, torch.float32, pshard, device))
        act_sh = activation_sharding(mesh, rules)
        attn_sh = attn_head_sharding(mesh, rules)
        tokens = sharded_empty((b, s), i32, bsh, device)
        labels = sharded_empty((b, s), i32, bsh, device)
        mb = _microbatches(mesh, rules, dataclasses.replace(
            shape, global_batch=b), opts)

        def mb_sharding(ndim):
            spec = [None, tuple(rules.batch) if rules.batch else None]
            spec += [None] * (ndim - 2)
            return NamedSharding(mesh, canonical_spec(*spec))

        # the [B, S, V] logits stay split over the vocabulary into the
        # loss, and their gradient comes back in that layout
        logits_sh = NamedSharding(mesh, canonical_spec(
            tuple(rules.batch) if rules.batch else None, None, rules.vocab))
        hooks = dict(cfg=cfg, opt_cfg=opt_cfg, remat=True,
                     act_sharding=act_sh, attn_sharding=attn_sh,
                     logits_sharding=logits_sh, microbatches=mb,
                     microbatch_sharding=mb_sharding)
        if cfg.family == "audio":
            enc = sharded_empty((b, _enc_len(shape, s), cfg.d_model),
                                param_dtype, batch_sharding(mesh, rules, 3),
                                device)

            def step(p, o, t, l, e):
                return train_step(p, o, t, l, encoder_embeds=e, **hooks)
            return step, (params, opt, tokens, labels, enc), (0, 1)

        def step(p, o, t, l):
            return train_step(p, o, t, l, **hooks)
        return step, (params, opt, tokens, labels), (0, 1)

    # prefill caches reserve lookahead slots (SL_max + bonus); keep the
    # ring length divisible by the mesh axes so cache_seq sharding applies
    max_len = s if shape.kind == "decode" else s + 16
    enc_len = _enc_len(shape, s) if cfg.family == "audio" else None
    cache_t = cache_lib.cache_struct(cfg, b, max_len, param_dtype,
                                     device=device, enc_len=enc_len)
    csh = cache_shardings(cache_t, mesh, rules)
    cache = {k: sharded_empty(v.shape, v.dtype, csh[k], device)
             for k, v in cache_t.items()}

    def last_logits(logits):
        # the sampler reads the last position's logits whole
        return _gather_vocab(logits[:, -1])

    if shape.kind == "prefill":
        emb_sh = batch_sharding(mesh, rules, 3)
        if cfg.family == "audio":
            # encoder frames + decoder prompt prefill
            enc = sharded_empty((b, enc_len, cfg.d_model), param_dtype, emb_sh,
                         device)
            toks = sharded_empty((b, s), i32, bsh, device)

            def step(p, c, e, t):
                enc_out = encode(p, cfg, e)
                c = dict(c)
                c["cross_k"], c["cross_v"] = build_cross_cache(p, cfg, enc_out)
                c["enc_valid"] = torch.ones(e.shape[:2], dtype=torch.bool,
                                            device=e.device)
                logits, c = forward(p, cfg, t, cache=c, mode="prefill")
                c["length"] = torch.full((t.shape[0],), t.shape[1],
                                         dtype=i32, device=t.device)
                return last_logits(logits), c
            return step, (params, cache, enc, toks), (1,)

        if cfg.family == "vlm":
            emb = sharded_empty((b, s, cfg.d_model), param_dtype, emb_sh, device)

            def step(p, c, e):
                logits, c = forward(p, cfg, None, embeds=e, cache=c,
                                    mode="prefill")
                c["length"] = torch.full((e.shape[0],), e.shape[1],
                                         dtype=i32, device=e.device)
                return last_logits(logits), c
            return step, (params, cache, emb), (1,)

        toks = sharded_empty((b, s), i32, bsh, device)
        moe_sh = moe_shardings(mesh, rules) if cfg.moe is not None else None

        def step(p, c, t):
            logits, c = forward(p, cfg, t, cache=c, mode="prefill",
                                moe_sharding=moe_sh)
            c["length"] = torch.full((t.shape[0],), t.shape[1], dtype=i32,
                                     device=t.device)
            return last_logits(logits), c
        return step, (params, cache, toks), (1,)

    # ---- decode: serve_step — ONE new token against a seq_len cache -----
    # (--opt verify runs the paper's ragged verification step instead:
    #  T = SL_max+1 = 11 tokens per sequence in one pass)
    t_len = 11 if "verify" in opts else 1
    toks = sharded_empty((b, t_len), i32, bsh, device)

    def step(p, c, t):
        logits, c = forward(p, cfg, t, cache=c, mode="decode")
        c["length"] = c["length"] + 1
        return last_logits(logits), c
    return step, (params, cache, toks), (1,)


def concrete_args(cfg: ModelConfig, shape: InputShape, *, batch: int,
                  seq_len: int, device, param_dtype=torch.bfloat16,
                  opts: frozenset = frozenset(), seed: int = 0) -> tuple:
    """Real arguments of :func:`make_step_and_specs`'s step at ``batch``
    x ``seq_len`` on ``device``, the same tensors its stand-ins stand for
    (no mesh): seeded parameters of ``param_dtype`` over the dry run's
    padded vocabulary (drawn on ``device``), fp32 zero AdamW moments,
    seeded tokens; a decode or verify ring is full (every slot valid,
    ``length`` at the last T positions), a prefill ring empty.  The
    one-card check runs the step on them (token-input steps: a vlm's or
    audio model's prefill and train steps take embeddings instead)."""
    from repro_torch.models.weights import init_params
    if cfg.family in ("vlm", "audio") and shape.kind != "decode":
        raise NotImplementedError(f"{cfg.family} {shape.kind} steps take "
                                  "front-end embeddings")
    from repro_torch.training.optimizer import init_adamw
    cfg = adapt_config(cfg, shape, opts)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(cfg, seed=seed, device=device, dtype=param_dtype,
                         rng_device=device, vocab_pad_multiple=VOCAB_PAD)

    def tokens(t):
        return torch.randint(0, cfg.vocab_size, (batch, t), generator=gen,
                             device=device, dtype=torch.int32)
    if shape.kind == "train":
        return (params, init_adamw(params), tokens(seq_len), tokens(seq_len))
    if shape.kind == "prefill":
        cache = cache_lib.cache_struct(cfg, batch, seq_len + 16, param_dtype,
                                       device=device)
        return params, cache, tokens(seq_len)
    t_len = 11 if "verify" in opts else 1
    cache = cache_lib.cache_struct(cfg, batch, seq_len, param_dtype,
                                   device=device)
    if "kv_pos" in cache:
        w = cache["kv_pos"].shape[1]
        cache["kv_pos"].copy_(torch.arange(w, device=device, dtype=torch.int32)
                              .expand(batch, w))
    cache["length"] = torch.full((batch,), seq_len - t_len,
                                 dtype=torch.int32, device=device)
    return params, cache, tokens(t_len)


def _gather_vocab(logits):
    """``logits [B, V]`` whole over the model axis (the vocab-sharded
    head's output gathered for the sampler); a plain tensor as it is."""
    if not hasattr(logits, "redistribute"):
        return logits
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(p if p == Shard(0) else Replicate() for p in logits.placements)
    return logits.redistribute(logits.device_mesh, pl)


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), plus attention's
    score and PV FLOPs (the reference's §Roofline count)."""
    cfg = adapt_config(cfg, shape)
    n_total = count_params(cfg, VOCAB_PAD)
    if cfg.moe is not None:
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        # expert params scale by k/e when active
        expert_params = (3 * cfg.d_model * cfg.moe.expert_d_ff
                         * e * cfg.num_layers)
        n_active = n_total - expert_params + expert_params * k / e
    else:
        n_active = n_total
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch * 1)
    # forward ~ 2N FLOPs/token; train (fwd + bwd) ~ 6N FLOPs/token
    per_token = 6.0 * n_active if shape.kind == "train" else 2.0 * n_active
    # attention score/PV FLOPs (not captured by 2N*D): 4 * h*hd * ctx per
    # token per attention layer; ctx = S/2 causal average (train/prefill)
    # or the full cache (decode); windowed attention caps ctx.
    if cfg.family != "ssm":
        h_hd = cfg.num_heads * cfg.resolved_head_dim
        n_attn_layers = cfg.num_layers
        if cfg.family == "hybrid":
            n_attn_layers = cfg.num_layers // (
                cfg.rglru.blocks_per_attention + 1)
        ctx = (shape.seq_len if shape.kind == "decode"
               else shape.seq_len / 2)
        if cfg.attention_window is not None:
            ctx = min(ctx, cfg.attention_window)
        elif cfg.family == "hybrid":
            ctx = min(ctx, cfg.rglru.local_attention_window)
        attn = 4.0 * h_hd * ctx * n_attn_layers
        if shape.kind == "train":
            attn *= 3
        per_token = per_token + attn
    return per_token * tokens
